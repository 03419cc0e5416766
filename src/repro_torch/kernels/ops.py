"""Entry points for the kernels, dispatched by the device of the tensors.

A CPU tensor goes to the plain PyTorch version in ``ref``; a CUDA tensor
goes to the hand-written CUDA kernel, which launches or raises — there is
no fallback from the card to the plain version; a meta tensor goes to the
kernel's meta route, which returns outputs of the kernel's shapes and
dtypes and computes nothing (the dry run's path).  Under an active cost
walker (``utils/cost.py``) a meta or CPU call counts as one launch of its
kernel with the kernel's own count (its wrapper's ``cost``); a CUDA call
goes straight to its kernel and is not counted.  Twin of
``repro/kernels/ops.py``.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import glr_scan as _gsc
from repro_torch.kernels import glr_step as _gs
from repro_torch.kernels import glr_step_tenants as _gst
from repro_torch.kernels import ref as ref  # re-export the plain versions
from repro_torch.kernels import regret_scan as _rs
from repro_torch.kernels import robust_agg as _ra
from repro_torch.kernels import weighted_aggregate as _wa
from repro_torch.utils import cost as _cost

_GLR_SPLIT_GRIDS = ("all", "geometric")


def _counted(name, kernel_cost):
    """The context of a meta or CPU call of the entry point: in the active
    cost walker, one launch of kernel ``name`` with ``kernel_cost()``'s
    ``KernelCost``; without a walker, nothing."""
    walker = _cost.active()
    return contextlib.nullcontext() if walker is None else walker.kernel(name, kernel_cost())


def _on_meta(name, *tensors) -> bool:
    """Whether the call takes the meta route: its first tensor is on meta,
    and then every tensor must be."""
    if not tensors[0].is_meta:
        return False
    off = sorted({str(t.device) for t in tensors if not t.is_meta})
    if off:
        raise ValueError(f"{name}: the meta route takes meta tensors, got some on {off}")
    return True


def glr_step(cum, total, base, counts, r_vec, sched, split_grid: str = "all"):
    """Fused streaming GLR detector step (prefix append + test).

    ``cum`` (N, H) or, with a leading tenant axis, (G, N, H); the rest
    (N,) / (G, N).  ``counts`` may be float or int, ``sched`` bool.
    Returns ``(cum, total, base, stats)``.  Every row is independent, so
    the tenant form is the same computation over G*N rows: one kernel
    launch on CUDA.
    """
    if split_grid not in _GLR_SPLIT_GRIDS:
        raise ValueError(
            f"glr_step: unknown split_grid {split_grid!r}; use one of {_GLR_SPLIT_GRIDS}")
    if cum.dim() not in (2, 3):
        raise ValueError(f"glr_step: cum must be (N, H) or (G, N, H), got {tuple(cum.shape)}")
    if cum.is_cuda:
        f32 = lambda x: x.to(torch.float32).contiguous()
        return _gs.glr_step(f32(cum), f32(total), f32(base),
                            counts.to(torch.int32).contiguous(), f32(r_vec),
                            sched.to(torch.bool).contiguous(), split_grid=split_grid)
    rows_shape, h = cum.shape[:-1], cum.shape[-1]
    with _counted("glr_step", lambda: _gs.cost(cum.numel() // h, h,
                                               geometric=split_grid == "geometric")):
        if _on_meta("glr_step", cum, total, base, counts, r_vec, sched):
            return _gs.meta(cum, total, base, counts, r_vec, sched)
        if cum.device.type != "cpu":
            raise ValueError(f"glr_step: no kernel for device {cum.device}")
        flat = lambda x: x.reshape(-1)
        outs = ref.glr_step(cum.reshape(-1, h), flat(total), flat(base), flat(counts),
                            flat(r_vec), flat(sched), split_grid=split_grid)
        return (outs[0].reshape(cum.shape),) + tuple(o.reshape(rows_shape) for o in outs[1:])


def glr_step_tenants(cum, total, base, slots, live, detect, counts, r_vec, sched,
                     split_grid: str = "all"):
    """The streaming GLR detector step over the scheduler service's slot
    state, in place: ``cum`` (R, N, H), ``total``/``base`` (R, N) f32 are
    updated for the rows ``slots`` (B,) where ``live`` (B,); returns the
    statistics (B, N), -inf where ``detect`` (B,) is false.  ``counts``
    (B, N) are the samples before the append (float or int), ``r_vec``
    (B, N), ``sched`` (B, N) bool.  On CUDA one kernel launch, which never
    moves the slot state (so it must be f32 and contiguous)."""
    if split_grid not in _GLR_SPLIT_GRIDS:
        raise ValueError(
            f"glr_step_tenants: unknown split_grid {split_grid!r}; use one of {_GLR_SPLIT_GRIDS}")
    if cum.is_cuda:
        return _gst.glr_step_tenants(cum, total, base, slots.to(torch.int32).contiguous(),
                                     live.contiguous(), detect.contiguous(),
                                     counts.to(torch.int32).contiguous(),
                                     r_vec.to(torch.float32).contiguous(),
                                     sched.to(torch.bool).contiguous(), split_grid=split_grid)
    with _counted("glr_step_tenants", lambda: _gst.cost(
            cum.shape[1], cum.shape[2], counts.shape[0], geometric=split_grid == "geometric")):
        if _on_meta("glr_step_tenants", cum, total, base, slots, live, detect, counts, r_vec,
                    sched):
            return _gst.meta(cum, total, base, slots, live, detect, counts, r_vec, sched)
        if cum.device.type != "cpu":
            raise ValueError(f"glr_step_tenants: no kernel for device {cum.device}")
        return ref.glr_step_tenants(cum, total, base, slots, live, detect, counts, r_vec, sched,
                                    split_grid=split_grid)


def weighted_aggregate(updates: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Eq. 7 fused masked aggregation: updates (M, P), scale (M,) -> (P,) f32;
    with a leading run axis, (B, M, P) and (B, M) -> (B, P), one launch on
    CUDA for the whole batch."""
    if updates.is_cuda:
        return _wa.weighted_aggregate(updates.contiguous(),
                                      scale.to(torch.float32).contiguous())
    with _counted("weighted_aggregate",
                  lambda: _wa.cost(updates.shape, updates.element_size())):
        if _on_meta("weighted_aggregate", updates, scale):
            return _wa.meta(updates, scale)
        if updates.device.type != "cpu":
            raise ValueError(f"weighted_aggregate: no kernel for device {updates.device}")
        return ref.weighted_aggregate(updates, scale)


def robust_trimmed(updates: torch.Tensor, mask: torch.Tensor, n_succ, k_trim) -> torch.Tensor:
    """Masked per-coordinate trimmed mean / median: updates (M, P), mask (M,)
    {0, 1}, participant count ``n_succ`` and trim depth ``k_trim`` (0-d, on
    the updates' device; ``k = floor((n-1)/2)`` gives the median) -> (P,)
    f32; zeros when nothing participates.  With a leading run axis,
    (B, M, P), (B, M) and (B,) n and k -> (B, P), one launch on CUDA for
    the whole batch."""
    if updates.is_cuda:
        return _ra.robust_trimmed(updates.contiguous(), mask.to(torch.float32).contiguous(),
                                  n_succ.to(torch.float32).contiguous(),
                                  k_trim.to(torch.float32).contiguous())
    with _counted("robust_trimmed", lambda: _ra.cost(updates.shape, updates.element_size())):
        if _on_meta("robust_trimmed", updates, mask, n_succ, k_trim):
            return _ra.meta(updates, mask, n_succ, k_trim)
        if updates.device.type != "cpu":
            raise ValueError(f"robust_trimmed: no kernel for device {updates.device}")
        return ref.robust_trimmed(updates, mask, n_succ, k_trim)


def glr_scan(hist: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Recompute GLR statistic per channel: hist (N, H), counts (N,) valid
    lengths -> (N,) f32, -inf where n < 2."""
    if hist.is_cuda:
        return _gsc.glr_scan(hist.to(torch.float32).contiguous(),
                             counts.to(torch.int32).contiguous())
    with _counted("glr_scan", lambda: _gsc.cost(*hist.shape)):
        if _on_meta("glr_scan", hist, counts):
            return _gsc.meta(hist, counts)
        if hist.device.type != "cpu":
            raise ValueError(f"glr_scan: no kernel for device {hist.device}")
        return ref.glr_scan(hist, counts)


def glr_scan_tenants(hist: torch.Tensor, slots: torch.Tensor, detect: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
    """The recompute GLR statistic over the scheduler service's slot state:
    ``hist`` (R, N, H) f32, read in place for the rows ``slots`` (B,);
    ``counts`` (B, N) valid lengths.  Returns (B, N) f32, -inf where
    ``detect`` (B,) is false or n < 2.  On CUDA one kernel launch, which
    never moves the history (so it must be f32 and contiguous)."""
    if hist.is_cuda:
        return _gsc.glr_scan_tenants(hist, slots.to(torch.int32).contiguous(),
                                     detect.contiguous(), counts.to(torch.int32).contiguous())
    with _counted("glr_scan_tenants",
                  lambda: _gsc.tenants_cost(hist.shape[1], hist.shape[2], counts.shape[0])):
        if _on_meta("glr_scan_tenants", hist, slots, detect, counts):
            return _gsc.tenants_meta(hist, slots, detect, counts)
        if hist.device.type != "cpu":
            raise ValueError(f"glr_scan_tenants: no kernel for device {hist.device}")
        return ref.glr_scan_tenants(hist, slots, detect, counts)


def regret_scan(scheduler, env, state, uniforms: torch.Tensor, collect_curve: bool = True,
                return_state: bool = False, batch=None):
    """GLR-CUCB's AoI-regret harness over the T rounds of ``uniforms`` (T, 2, N)
    from ``state``, for one run or, with ``batch`` B, a batch of runs (a
    leading run axis on the state and on any of env, uniforms and hp): on
    CUDA one launch of ``csrc/regret_scan.cu``; on the CPU its plain version,
    the per-round loop.  Returns the dict of ``simulate_aoi_regret``."""
    if uniforms.is_cuda:
        return _rs.regret_scan(scheduler, env, state, uniforms, collect_curve, return_state)
    runs = uniforms.shape[0] if uniforms.dim() == 4 else (batch or 1)
    with _counted("regret_scan", lambda: _rs.cost(
            scheduler.n_channels, scheduler.n_clients, scheduler.history, uniforms.shape[-3],
            runs, stride=scheduler.detector_stride, reactive=env.form == _rs.FORM_REACTIVE)):
        if _on_meta("regret_scan", uniforms, state.mu_tilde):
            return _rs.meta(scheduler, env, state, uniforms, collect_curve, return_state)
        if uniforms.device.type != "cpu":
            raise ValueError(f"regret_scan: no kernel for device {uniforms.device}")
        from repro_torch.core.regret import _simulate_rounds   # the plain version imports ops
        return _simulate_rounds(scheduler, env, state, uniforms, collect_curve, return_state,
                                batch)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    window: int = 0, scale=None, return_lse: bool = False):
    """Blockwise GQA attention.  q (B,Hq,S,D), k/v (B,Hkv,S,D) -> (B,Hq,S,D);
    with ``return_lse`` also each query row's logsumexp of its scaled,
    masked logits, (B,Hq,S) f32 (on CUDA the tensor-core route only: bf16,
    D % 8 == 0), which ``flash_attention_bwd`` reads.

    ``scale`` defaults to 1/sqrt(D) of the true D (the JAX wrapper takes it
    before padding D).  On CUDA the kernel masks the D and S tails itself,
    so nothing is padded in device memory."""
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal, window=window, scale=scale,
                                   return_lse=return_lse)
    b, hq, s, d = q.shape
    with _counted("flash_attention",
                  lambda: _fa.cost((b, hq, k.shape[1], s, d), causal, window, q.dtype,
                                   lse=return_lse)):
        if _on_meta("flash_attention", q, k, v):
            return _fa.meta(q, k, v, return_lse)
        if q.device.type != "cpu":
            raise ValueError(f"flash_attention: no kernel for device {q.device}")
        return ref.mha_attention(q, k, v, causal=causal, window=window, scale=scale,
                                 return_lse=return_lse)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
                        window: int = 0, scale=None):
    """The gradient of ``flash_attention`` from its output ``out`` and row
    logsumexp ``lse`` (``return_lse``) and the output's gradient ``do``:
    returns (dq, dk, dv) in the dtypes of q, k, v.  On CUDA the backward
    kernels, which take what the tensor-core forward takes (bf16, D % 8 ==
    0, D <= 256) and raise on anything else; on the CPU the plain version
    ``ref.mha_attention_bwd``; on meta the kernels' meta route."""
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        c = lambda t: t.contiguous()
        return _fa.flash_attention_bwd(c(q), c(k), c(v), c(out), c(lse), c(do), causal=causal,
                                       window=window, scale=scale)
    b, hq, s, d = q.shape
    with _counted("flash_attention_bwd",
                  lambda: _fa.cost_bwd((b, hq, k.shape[1], s, d), causal, window, q.dtype)):
        if _on_meta("flash_attention_bwd", q, k, v, out, lse, do):
            return _fa.meta_bwd(q, k, v)
        if q.device.type != "cpu":
            raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
        return ref.mha_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window,
                                     scale=scale)
