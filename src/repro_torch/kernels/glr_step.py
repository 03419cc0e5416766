"""CUDA kernel wrapper: fused streaming GLR detector step.

Replaces the Pallas TPU kernel ``glr_step`` of
``src/repro/kernels/glr_step.py`` (``_glr_step_math``): per channel, the
masked append into the (N, H) prefix ring and the sup of the two-sided
Bernoulli-KL GLR statistic over the post-append window, in one launch.
Source: ``csrc/glr_step.cu``; semantics of record: ``ref.glr_step``.  The
scheduler service's tenant form, in place on its slot state, is
``glr_step_tenants.py``.

What bounds it on the H100: launch latency.  At the paper's sizes
(N = 5..30 channels, H = 256..1024) the ring is 5-120 KB, roughly
2*N*H*4 bytes of traffic, which the card's 3.35 TB/s moves in tens of
nanoseconds.  The design therefore fuses append and test into one launch
with one thread block per row and no padding; a leading tenant axis
(G, N, H) is just G*N rows of the same launch, so the tenant form needs no
second kernel.  The kernel is functional (fresh outputs), like the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.utils.roofline import PEAK_FLOPS_F32, KernelCost

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"glr_step: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"glr_step: {name} has dtype {x.dtype}, the kernel takes {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"glr_step: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"glr_step: {name} must be contiguous")


def glr_step(cum, total, base, counts, r_vec, sched, split_grid: str = "all"):
    """Launch the kernel on CUDA tensors: ``cum`` (..., H) f32; ``total``,
    ``base``, ``r_vec`` (...) f32; ``counts`` (...) int32; ``sched`` (...)
    bool, where ``...`` is (N,) or (G, N).  Returns fresh
    ``(cum, total, base, stats)``; ``stats`` is -inf where n < 2."""
    if split_grid not in ("all", "geometric"):
        raise ValueError(f"glr_step: unknown split_grid {split_grid!r}")
    if not cum.is_cuda:
        raise ValueError(f"glr_step: the kernel takes CUDA tensors, got {cum.device}")
    if cum.dim() not in (2, 3):
        raise ValueError(f"glr_step: cum must be (N, H) or (G, N, H), got {tuple(cum.shape)}")
    dev, rows_shape, h = cum.device, cum.shape[:-1], cum.shape[-1]
    _check("cum", cum, torch.float32, cum.shape, dev)
    for name, x in (("total", total), ("base", base), ("r_vec", r_vec)):
        _check(name, x, torch.float32, rows_shape, dev)
    _check("counts", counts, torch.int32, rows_shape, dev)
    _check("sched", sched, torch.bool, rows_shape, dev)
    rows = cum.numel() // h if h else 0
    if rows == 0 or h == 0 or rows >= 2**31:
        raise ValueError(f"glr_step: unsupported shape {tuple(cum.shape)}")

    fn = _build.load("glr_step", "glr_step_launch", _ARGTYPES)
    cum_out = torch.empty_like(cum)
    total_out = torch.empty_like(total)
    base_out = torch.empty_like(base)
    stat_out = torch.empty_like(total)
    err = fn(cum.data_ptr(), total.data_ptr(), base.data_ptr(), counts.data_ptr(),
             r_vec.data_ptr(), sched.data_ptr(), cum_out.data_ptr(), total_out.data_ptr(),
             base_out.data_ptr(), stat_out.data_ptr(), rows, h,
             int(split_grid == "geometric"), _build.stream(cum.get_device()))
    if err != 0:
        raise RuntimeError(f"glr_step: kernel launch failed (cudaError {err})")
    glr_step.launches += 1
    return cum_out, total_out, base_out, stat_out


glr_step.launches = 0
KL_SPLIT_FLOPS = 32        # f32 operations an evaluated split (the KL pair and the max)


def full_window_splits(h: int, geometric: bool = False) -> int:
    """Splits 1 <= s <= H - 1 a full window of H evaluates: all of them, or
    on the geometric grid those with s or H - s a power of two."""
    pow2 = lambda x: x > 0 and x & (x - 1) == 0
    return sum(1 for s in range(1, h) if not geometric or pow2(s) or pow2(h - s))


def cost(rows: int, h: int, splits=None, geometric: bool = False) -> KernelCost:
    """One call's work on ``rows`` rings of ``h``: ``KL_SPLIT_FLOPS`` f32
    operations a split evaluated and one a row; the ring read and written
    once, a row's total, base, count, reward and flag read and its total,
    base and statistic written.  ``splits`` is what the inputs' counts
    make the kernel evaluate; None counts every row's window full (the
    most, what a step on meta tensors is charged)."""
    if splits is None:
        splits = rows * full_window_splits(h, geometric)
    nbytes = 2 * rows * h * 4 + rows * (4 * 4 + 1) + rows * 3 * 4
    return KernelCost(KL_SPLIT_FLOPS * splits + rows, nbytes, PEAK_FLOPS_F32)


def meta(cum, total, base, counts, r_vec, sched):
    """The kernel's outputs on meta tensors: fresh f32 ``(cum, total, base,
    stats)`` of the inputs' shapes."""
    f32 = lambda x: x.new_empty(x.shape, dtype=torch.float32)
    return f32(cum), f32(total), f32(base), f32(total)
