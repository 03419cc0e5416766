"""CUDA kernel wrapper: GLR-CUCB's Fig. 2 AoI-regret harness in one launch,
for one run or a batch of runs.

Replaces, on the regret harness's path, the Pallas TPU kernels ``glr_step``
(``src/repro/kernels/glr_step.py``) and ``glr_scan``
(``src/repro/kernels/glr_scan.py``) inside the JAX harness's ``lax.scan``
over the horizon (``src/repro/core/regret.py``), and, for a batch, their
``vmap`` in the JAX engine (``src/repro/sim/engine.py``), where GLR-CUCB's
detector runs as one ``glr_step_tenants`` launch over the runs: one thread
block runs every round of one run, with the detector's (N, H) ring
resident in shared memory, and a launch takes B runs, one block each.
Source: ``csrc/regret_scan.cu``.  Its plain version is the per-round loop
``repro_torch.core.regret._simulate_rounds`` (GLR-CUCB's ``select``/
``update``, the oracle, the AoI and regret sums; batched over a leading
run axis), which on the card runs the standalone ``glr_step``/``glr_scan``
kernels once per detection round; the two routes give the same bits (see
the source's header), the policy's variance curve within the order of a
sum of M squares.

The run axis: the state from ``init_batch`` has it; the env (stacked),
the uniforms (B, T, 2, N) and each hyper-parameter ((B,)) may, or may be
one shared by every run (stride 0 in the kernel).  Without any run axis
the call is the single run, B = 1, and its outputs have no run axis.

What bounds it on the H100: the chain of rounds, each depending on the one
before, on one SM; neither bytes (~1.3 MB a Fig. 2 run) nor the GLR
splits' flops (~4 us a run at 67 TFLOP/s).  The design takes the host out
of the loop: nothing is read back, one launch a batch, and the card's
other SMs take the batch's other runs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 28 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
_OCCUPANCY_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p]
MAX_CHANNELS = 32                # one lane of a warp per channel
MAX_RING_BYTES = 160 * 1024      # the (N, H) f32 ring in shared memory
_I32_MAX = 2**31 - 1
_FORMS = ("segments", "table")


def _stream(x: torch.Tensor) -> int:
    return _build.stream(x.get_device())


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"regret_scan: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"regret_scan: {name} has dtype {x.dtype}, the kernel takes {dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"regret_scan: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"regret_scan: {name} must be contiguous")


def _run_axes(env, state, uniforms):
    """Which operands carry a leading run axis, read from their ranks:
    ``(state, env, uniforms, hp)`` flags and each one's run count."""
    env_leaf = env.table if env.form == "table" else env.means
    hp = list(state.hp.values())
    axes = {"state": state.mu_tilde.dim() == 2, "env": env_leaf.dim() == 3,
            "uniforms": uniforms.dim() == 4, "hp": any(v.dim() == 1 for v in hp)}
    sizes = {"state": state.mu_tilde.shape[0], "env": env_leaf.shape[0],
             "uniforms": uniforms.shape[0]}
    sizes["hp"] = next((v.shape[0] for v in hp if v.dim() == 1), 1)
    return axes, {k: sizes[k] for k in axes if axes[k]}


def refusal(scheduler, env, state, uniforms) -> Optional[str]:
    """Why the kernel does not take this run or batch of runs, or ``None``
    when it does.  Every rule holds for each run: the uniforms (T, 2, N) or
    (B, T, 2, N), each hyper-parameter 0-d or (B,).  Reads only Python
    values (types, fields, shapes, devices): no device sync, no launch."""
    from repro_torch.core.bandits.glr_cucb import GLRCUCB   # the scheduler imports ops

    if not uniforms.is_cuda:
        return f"the tensors are on {uniforms.device}; the kernel runs on CUDA"
    if not isinstance(scheduler, GLRCUCB):
        return f"the scheduler is {type(scheduler).__name__}; the kernel runs GLRCUCB"
    if scheduler.detector_backend not in (None, "kernel"):
        return (f"detector_backend={scheduler.detector_backend!r} asks for the plain "
                "detector; the kernel takes None or 'kernel'")
    if env.form not in _FORMS:
        return f"the env's form {env.form!r} is not one of the kernel's {_FORMS}"
    n, m, h = scheduler.n_channels, scheduler.n_clients, scheduler.history
    if not 1 <= m <= n <= MAX_CHANNELS:
        return (f"N={n} channels and M={m} clients: the kernel takes 1 <= M <= N <= "
                f"{MAX_CHANNELS} (one lane per channel)")
    if n * h * 4 > MAX_RING_BYTES:
        return (f"the (N, H) = ({n}, {h}) f32 ring takes {n * h * 4} bytes, above the "
                f"kernel's {MAX_RING_BYTES}-byte shared-memory budget")
    if not 1 <= scheduler.detector_stride <= _I32_MAX:
        return f"detector_stride={scheduler.detector_stride} is outside [1, 2**31)"
    if any(v.dim() > 1 for v in state.hp.values()):
        return "a hyper-parameter has more than one axis (the kernel takes 0-d or (B,))"
    return None


def occupancy(scheduler, table: bool) -> int:
    """Blocks of a launch one SM holds at once for ``scheduler`` (a
    ``GLRCUCB``) on a table (or segment) env, as the CUDA runtime's
    occupancy calculator gives it for the template and its shared memory."""
    fn = _build.load("regret_scan", "regret_scan_occupancy", _OCCUPANCY_ARGTYPES)
    out = ctypes.c_int(0)
    err = fn(scheduler.n_channels, scheduler.n_clients, scheduler.history,
             int(scheduler.detector_impl == "recompute"),
             int(scheduler.resolved_split_grid() == "geometric"), int(table), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"regret_scan: occupancy query failed (cudaError {err})")
    return out.value


def regret_scan(scheduler, env, state, uniforms: torch.Tensor, collect_curve: bool = True,
                return_state: bool = False):
    """Launch the kernel: ``scheduler`` a ``GLRCUCB`` (1 <= M <= N <= 32,
    N * H * 4 <= 160 KiB), ``env`` a ``ChannelEnv`` (``segments`` or
    ``table``), ``state`` its ``GLRCUCBState`` with f32 ``hp`` values,
    ``uniforms`` (T, 2, N) f32, all contiguous on one CUDA device.  A batch
    of B runs gives ``state`` (from ``init_batch``), and any of ``env``
    (stacked), ``uniforms`` ((B, T, 2, N)) and the ``hp`` values ((B,)), a
    leading run axis; one launch runs them all and every output has it.
    Returns the dict of ``simulate_aoi_regret`` (``final_sched_state`` with
    ``return_state``); nothing is read back to the host."""
    why = refusal(scheduler, env, state, uniforms)
    if why is not None:
        raise ValueError(f"regret_scan: {why}")
    axes, sizes = _run_axes(env, state, uniforms)
    if len(set(sizes.values())) > 1:
        raise ValueError(f"regret_scan: the operands' run axes disagree: {sizes}")
    batch = next(iter(sizes.values()), 1)
    lead = (batch,) if sizes else ()
    n, m, h = scheduler.n_channels, scheduler.n_clients, scheduler.history
    recompute = scheduler.detector_impl == "recompute"
    geometric = scheduler.resolved_split_grid() == "geometric"
    table = env.form == "table"
    period = max(int(n / scheduler.alpha), n) if scheduler.alpha > 0 else 0
    dev = uniforms.device
    horizon = uniforms.shape[-3]
    if horizon > _I32_MAX // 2 or period > _I32_MAX:
        raise ValueError(f"regret_scan: horizon {horizon} or exploration period {period} too large")
    at = lambda name, shape: (batch,) + shape if axes[name] else shape
    _check("uniforms", uniforms, torch.float32, at("uniforms", (horizon, 2, n)), dev)
    if table:
        t_tab = env.table.shape[-2]
        if t_tab < horizon:
            raise ValueError(f"regret_scan: the table env covers {t_tab} rounds, "
                             f"the run takes {horizon}")
        _check("env.table", env.table, torch.float32, at("env", (t_tab, n)), dev)
        n_seg = 1
    else:
        t_tab, n_seg = 0, env.means.shape[-2]
        _check("env.means", env.means, torch.float32, at("env", (n_seg, n)), dev)
        _check("env.breaks", env.breaks, torch.int64, at("env", (n_seg - 1,)), dev)
    f32 = torch.float32
    for name in ("mu_tilde", "counts", "total", "base"):
        _check(name, getattr(state, name), f32, at("state", (n,)), dev)
    for name in ("tau", "restarts"):
        _check(name, getattr(state, name), torch.int32, at("state", ()), dev)
    ring_name = "hist" if recompute else "cum"
    _check(ring_name, getattr(state, ring_name), f32, at("state", (n, h)), dev)
    for name in ("gamma", "delta", "min_samples"):
        v = state.hp[name]
        _check(f"hp[{name!r}]", v, f32, (batch,) if v.dim() else (), dev)

    fn = _build.load("regret_scan", "regret_scan_launch", _ARGTYPES)
    new = lambda shape, dtype=f32: uniforms.new_empty(lead + shape, dtype=dtype)
    schedule = new((horizon, m), torch.int64)
    regret_curve = new((horizon,)) if collect_curve else None
    var_curve = new((horizon,)) if collect_curve else None
    scalars = new((4,))      # cum regret, cum policy variance, cum oracle variance, successes
    aoi_pi, aoi_star = new((m,)), new((m,))
    mu, counts, total, base = new((n,)), new((n,)), new((n,)), new((n,))
    tau, restarts = new((), torch.int32), new((), torch.int32)
    ring = new((n, h))
    splits = uniforms.new_empty((batch,), dtype=torch.int64)
    ptr = lambda x: x.data_ptr() if x is not None else None
    # one flag for the three: a shared value beside per-run ones is repeated
    hp_b = axes["hp"]
    hp = {k: state.hp[k].expand(batch).contiguous() if hp_b and not state.hp[k].dim()
          else state.hp[k] for k in ("gamma", "delta", "min_samples")}
    err = fn(state.mu_tilde.data_ptr(), state.counts.data_ptr(), state.tau.data_ptr(),
             getattr(state, ring_name).data_ptr(), state.restarts.data_ptr(),
             state.total.data_ptr(), state.base.data_ptr(), hp["gamma"].data_ptr(),
             hp["delta"].data_ptr(), hp["min_samples"].data_ptr(),
             None if table else env.means.data_ptr(), None if table else env.breaks.data_ptr(),
             env.table.data_ptr() if table else None, uniforms.data_ptr(), schedule.data_ptr(),
             ptr(regret_curve), ptr(var_curve), scalars.data_ptr(), aoi_pi.data_ptr(),
             aoi_star.data_ptr(), mu.data_ptr(), counts.data_ptr(), tau.data_ptr(),
             ring.data_ptr(), restarts.data_ptr(), total.data_ptr(), base.data_ptr(),
             splits.data_ptr(), horizon, n, m, h, n_seg, scheduler.detector_stride, period,
             int(recompute), int(geometric), int(table), batch, t_tab, int(axes["state"]),
             int(axes["env"]), int(axes["uniforms"]), int(hp_b), _stream(uniforms))
    if err != 0:
        raise RuntimeError(f"regret_scan: kernel launch failed (cudaError {err})")
    regret_scan.launches += 1
    regret_scan.splits = splits

    cum_regret, cum_var_pi = scalars[..., 0], scalars[..., 1]
    out = {
        "regret": regret_curve if collect_curve else cum_regret,
        "final_regret": cum_regret,
        "cum_aoi_var": var_curve if collect_curve else cum_var_pi,
        "final_cum_aoi_var": cum_var_pi,
        "oracle_cum_aoi_var": scalars[..., 2],
        "aoi_pi": aoi_pi,
        "aoi_star": aoi_star,
        "success_rate": scalars[..., 3] / (horizon * m),   # the per-round route's own op
        "channels": schedule,
        "restarts": restarts,
    }
    if return_state:
        ring_field = {ring_name: ring}
        out["final_sched_state"] = state._replace(mu_tilde=mu, counts=counts, tau=tau,
                                                  restarts=restarts, total=total, base=base,
                                                  **ring_field)
    return out


regret_scan.launches = 0
regret_scan.splits = None   # the last launch's GLR splits evaluated a run, (B,) int64 on the card
