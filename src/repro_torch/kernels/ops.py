"""Entry points for the kernels, dispatched by the device of the tensors.

A CPU tensor goes to the plain PyTorch version in ``ref``; a CUDA tensor
goes to the hand-written CUDA kernel, which launches or raises — there is
no fallback from the card to the plain version.  Twin of
``repro/kernels/ops.py``.
"""
from __future__ import annotations

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

_GLR_SPLIT_GRIDS = ("all", "geometric")


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
    if cum.device.type != "cpu":
        raise ValueError(f"glr_step: no kernel for device {cum.device}")
    rows_shape, h = cum.shape[:-1], cum.shape[-1]
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
    if cum.device.type != "cpu":
        raise ValueError(f"glr_step_tenants: no kernel for device {cum.device}")
    return ref.glr_step_tenants(cum, total, base, slots, live, detect, counts, r_vec, sched,
                                split_grid=split_grid)


def weighted_aggregate(updates: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Eq. 7 fused masked aggregation: updates (M, P), scale (M,) -> (P,) f32."""
    if updates.is_cuda:
        return _wa.weighted_aggregate(updates.contiguous(),
                                      scale.to(torch.float32).contiguous())
    if updates.device.type != "cpu":
        raise ValueError(f"weighted_aggregate: no kernel for device {updates.device}")
    return ref.weighted_aggregate(updates, scale)


def robust_trimmed(updates: torch.Tensor, mask: torch.Tensor, n_succ, k_trim) -> torch.Tensor:
    """Masked per-coordinate trimmed mean / median: updates (M, P), mask (M,)
    {0, 1}, participant count ``n_succ`` and trim depth ``k_trim`` (0-d, on
    the updates' device; ``k = floor((n-1)/2)`` gives the median) -> (P,)
    f32; zeros when nothing participates."""
    if updates.is_cuda:
        return _ra.robust_trimmed(updates.contiguous(), mask.to(torch.float32).contiguous(),
                                  n_succ.to(torch.float32), k_trim.to(torch.float32))
    if updates.device.type != "cpu":
        raise ValueError(f"robust_trimmed: no kernel for device {updates.device}")
    return ref.robust_trimmed(updates, mask, n_succ, k_trim)


def glr_scan(hist: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Recompute GLR statistic per channel: hist (N, H), counts (N,) valid
    lengths -> (N,) f32, -inf where n < 2."""
    if hist.is_cuda:
        return _gsc.glr_scan(hist.to(torch.float32).contiguous(),
                             counts.to(torch.int32).contiguous())
    if hist.device.type != "cpu":
        raise ValueError(f"glr_scan: no kernel for device {hist.device}")
    return ref.glr_scan(hist, counts)


def regret_scan(scheduler, env, state, uniforms: torch.Tensor, collect_curve: bool = True,
                return_state: bool = False, batch=None):
    """GLR-CUCB's AoI-regret harness over the T rounds of ``uniforms`` (T, 2, N)
    from ``state``, for one run or, with ``batch`` B, a batch of runs (a
    leading run axis on the state and on any of env, uniforms and hp): on
    CUDA one launch of ``csrc/regret_scan.cu``; on the CPU its plain version,
    the per-round loop.  Returns the dict of ``simulate_aoi_regret``."""
    if uniforms.is_cuda:
        return _rs.regret_scan(scheduler, env, state, uniforms, collect_curve, return_state)
    if uniforms.device.type != "cpu":
        raise ValueError(f"regret_scan: no kernel for device {uniforms.device}")
    from repro_torch.core.regret import _simulate_rounds   # the plain version imports ops
    return _simulate_rounds(scheduler, env, state, uniforms, collect_curve, return_state, batch)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    window: int = 0, scale=None) -> torch.Tensor:
    """Blockwise GQA attention.  q (B,Hq,S,D), k/v (B,Hkv,S,D) -> (B,Hq,S,D).

    ``scale`` defaults to 1/sqrt(D) of the true D (the JAX wrapper takes it
    before padding D).  On CUDA the kernel masks the D and S tails itself,
    so nothing is padded in device memory."""
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal, window=window, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return ref.mha_attention(q, k, v, causal=causal, window=window, scale=scale)
