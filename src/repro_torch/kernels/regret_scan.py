"""CUDA kernel wrapper: GLR-CUCB's Fig. 2 AoI-regret harness in one launch.

Replaces, on the regret harness's path, the Pallas TPU kernels ``glr_step``
(``src/repro/kernels/glr_step.py``) and ``glr_scan``
(``src/repro/kernels/glr_scan.py``) inside the JAX harness's ``lax.scan``
over the horizon (``src/repro/core/regret.py``): one thread block runs
every round of a run, with the detector's (N, H) ring resident in shared
memory.  Source: ``csrc/regret_scan.cu``.  Its plain version is the
per-round loop ``repro_torch.core.regret._simulate_rounds`` (GLR-CUCB's
``select``/``update``, the oracle, the AoI and regret sums), which on the
card runs the standalone ``glr_step``/``glr_scan`` kernels once per
detection round; the two routes give the same bits (see the source's
header), the policy's variance curve within the order of a sum of M
squares.

What bounds it on the H100: the chain of rounds, each depending on the one
before, on one SM; neither bytes (~1.3 MB a Fig. 2 run) nor the GLR
splits' flops (~4 us a run at 67 TFLOP/s).  The design takes the host out
of the loop: nothing is read back, one launch a run.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 28 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
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


def refusal(scheduler, env, state, uniforms) -> Optional[str]:
    """Why the kernel does not take this run, or ``None`` when it does.
    Reads only Python values (types, fields, shapes, devices): no device
    sync, no launch."""
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
    if any(v.dim() != 0 for v in state.hp.values()):
        return "the hyper-parameters are not 0-d (one value a run)"
    return None


def regret_scan(scheduler, env, state, uniforms: torch.Tensor, collect_curve: bool = True,
                return_state: bool = False):
    """Launch the kernel: ``scheduler`` a ``GLRCUCB`` (1 <= M <= N <= 32,
    N * H * 4 <= 160 KiB), ``env`` a ``ChannelEnv`` (``segments`` or
    ``table``), ``state`` its ``GLRCUCBState`` with 0-d f32 ``hp`` values,
    ``uniforms`` (T, 2, N) f32, all contiguous on one CUDA device.  Returns
    the dict of ``simulate_aoi_regret`` (``final_sched_state`` with
    ``return_state``); nothing is read back to the host."""
    why = refusal(scheduler, env, state, uniforms)
    if why is not None:
        raise ValueError(f"regret_scan: {why}")
    n, m, h = scheduler.n_channels, scheduler.n_clients, scheduler.history
    recompute = scheduler.detector_impl == "recompute"
    geometric = scheduler.resolved_split_grid() == "geometric"
    table = env.form == "table"
    period = max(int(n / scheduler.alpha), n) if scheduler.alpha > 0 else 0
    dev = uniforms.device
    horizon = uniforms.shape[0]
    if horizon > _I32_MAX // 2 or period > _I32_MAX:
        raise ValueError(f"regret_scan: horizon {horizon} or exploration period {period} too large")
    _check("uniforms", uniforms, torch.float32, (horizon, 2, n), dev)
    if table:
        if env.table.shape[0] < horizon:
            raise ValueError(f"regret_scan: the table env covers {env.table.shape[0]} rounds, "
                             f"the run takes {horizon}")
        _check("env.table", env.table, torch.float32, (env.table.shape[0], n), dev)
        n_seg = 1
    else:
        n_seg = env.means.shape[0]
        _check("env.means", env.means, torch.float32, (n_seg, n), dev)
        _check("env.breaks", env.breaks, torch.int64, (n_seg - 1,), dev)
    f32 = torch.float32
    for name in ("mu_tilde", "counts", "total", "base"):
        _check(name, getattr(state, name), f32, (n,), dev)
    for name in ("tau", "restarts"):
        _check(name, getattr(state, name), torch.int32, (), dev)
    ring_name = "hist" if recompute else "cum"
    _check(ring_name, getattr(state, ring_name), f32, (n, h), dev)
    for name in ("gamma", "delta", "min_samples"):
        _check(f"hp[{name!r}]", state.hp[name], f32, (), dev)

    fn = _build.load("regret_scan", "regret_scan_launch", _ARGTYPES)
    new = lambda shape, dtype=f32: uniforms.new_empty(shape, dtype=dtype)
    schedule = new((horizon, m), torch.int64)
    regret_curve = new((horizon,)) if collect_curve else None
    var_curve = new((horizon,)) if collect_curve else None
    scalars = new((4,))      # cum regret, cum policy variance, cum oracle variance, successes
    aoi_pi, aoi_star = new((m,)), new((m,))
    mu, counts, total, base = new((n,)), new((n,)), new((n,)), new((n,))
    tau, restarts = new((), torch.int32), new((), torch.int32)
    ring = new((n, h))
    splits = new((), torch.int64)
    ptr = lambda x: x.data_ptr() if x is not None else None
    err = fn(state.mu_tilde.data_ptr(), state.counts.data_ptr(), state.tau.data_ptr(),
             getattr(state, ring_name).data_ptr(), state.restarts.data_ptr(),
             state.total.data_ptr(), state.base.data_ptr(), state.hp["gamma"].data_ptr(),
             state.hp["delta"].data_ptr(), state.hp["min_samples"].data_ptr(),
             None if table else env.means.data_ptr(), None if table else env.breaks.data_ptr(),
             env.table.data_ptr() if table else None, uniforms.data_ptr(), schedule.data_ptr(),
             ptr(regret_curve), ptr(var_curve), scalars.data_ptr(), aoi_pi.data_ptr(),
             aoi_star.data_ptr(), mu.data_ptr(), counts.data_ptr(), tau.data_ptr(),
             ring.data_ptr(), restarts.data_ptr(), total.data_ptr(), base.data_ptr(),
             splits.data_ptr(), horizon, n, m, h, n_seg, scheduler.detector_stride, period,
             int(recompute), int(geometric), int(table), _stream(uniforms))
    if err != 0:
        raise RuntimeError(f"regret_scan: kernel launch failed (cudaError {err})")
    regret_scan.launches += 1
    regret_scan.splits = splits

    cum_regret, cum_var_pi = scalars[0], scalars[1]
    out = {
        "regret": regret_curve if collect_curve else cum_regret,
        "final_regret": cum_regret,
        "cum_aoi_var": var_curve if collect_curve else cum_var_pi,
        "final_cum_aoi_var": cum_var_pi,
        "oracle_cum_aoi_var": scalars[2],
        "aoi_pi": aoi_pi,
        "aoi_star": aoi_star,
        "success_rate": scalars[3] / (horizon * m),   # the per-round route's own op
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
regret_scan.splits = None   # the last launch's count of evaluated GLR splits, 0-d int64 on the card
