"""CUDA kernel wrapper: recompute GLR detector statistic.

Replaces the Pallas TPU kernel ``glr_scan`` of
``src/repro/kernels/glr_scan.py`` (``_glr_kernel``): per channel, the
masked prefix sum of the (N, H) reward history and the sup of the
two-sided Bernoulli-KL GLR statistic over the splits s = 1..n-1; -inf
where n < 2.  Source: ``csrc/glr_scan.cu`` (the split term shared with
``csrc/glr_step.cu`` through ``csrc/glr_kl.cuh``); semantics of record:
``ref.glr_scan``.

What bounds it on the H100: launch latency at the paper's sizes (N =
5..30, H = 256..1024: 5-120 KB and ~40 flops a split).  One thread block
per row scans the history in chunks of the block with a carried offset;
no padding of N or H.

``glr_scan_tenants`` is the scheduler service's form (the recompute
detector served): the same statistic for the B named slots of the
service's (R, N, H) history, read in place by slot index, -inf on the
rows whose detect flag is off (``ref.glr_scan_tenants``).  The JAX serve
step ``vmap``s ``glr_scan`` over the gathered rows instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.glr_step import KL_SPLIT_FLOPS
from repro_torch.utils.roofline import PEAK_FLOPS_F32, KernelCost

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_TENANTS_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def glr_scan(hist: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``hist`` (N, H) f32 and ``counts`` (N,) int32,
    contiguous, on CUDA.  Returns (N,) f32, -inf where counts < 2."""
    if not hist.is_cuda:
        raise ValueError(f"glr_scan: the kernel takes CUDA tensors, got {hist.device}")
    if hist.dim() != 2:
        raise ValueError(f"glr_scan: hist must be (N, H), got {tuple(hist.shape)}")
    rows, h = hist.shape
    if hist.dtype != torch.float32 or not hist.is_contiguous():
        raise TypeError(f"glr_scan: hist must be contiguous f32, got {hist.dtype}")
    if counts.device != hist.device or counts.dtype != torch.int32 \
            or tuple(counts.shape) != (rows,) or not counts.is_contiguous():
        raise ValueError(
            f"glr_scan: counts must be a contiguous ({rows},) int32 tensor on {hist.device}, "
            f"got {tuple(counts.shape)} {counts.dtype} on {counts.device}")
    if rows == 0 or h == 0 or rows >= 2**31:
        raise ValueError(f"glr_scan: unsupported shape {tuple(hist.shape)}")

    fn = _build.load("glr_scan", "glr_scan_launch", _ARGTYPES)
    out = torch.empty((rows,), dtype=torch.float32, device=hist.device)
    err = fn(hist.data_ptr(), counts.data_ptr(), out.data_ptr(), rows, h,
             _build.stream(hist.get_device()))
    if err != 0:
        raise RuntimeError(f"glr_scan: kernel launch failed (cudaError {err})")
    glr_scan.launches += 1
    return out


glr_scan.launches = 0


def _tenants_checked(hist, slots, detect, counts):
    """``glr_scan_tenants``'s checks: raises on what the kernel does not
    take, else returns (B, N, H)."""
    if not hist.is_cuda:
        raise ValueError(f"glr_scan_tenants: the kernel takes CUDA tensors, got {hist.device}")
    if hist.dim() != 3 or counts.dim() != 2:
        raise ValueError(f"glr_scan_tenants: hist must be (R, N, H) and counts (B, N), got "
                         f"{tuple(hist.shape)} and {tuple(counts.shape)}")
    _, n_chan, h = hist.shape
    b = counts.shape[0]
    for name, x, dtype, shape in (("hist", hist, torch.float32, hist.shape),
                                  ("slots", slots, torch.int32, (b,)),
                                  ("detect", detect, torch.bool, (b,)),
                                  ("counts", counts, torch.int32, (b, n_chan))):
        if x.device != hist.device or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
                or not x.is_contiguous():
            raise ValueError(
                f"glr_scan_tenants: {name} must be a contiguous {tuple(shape)} {dtype} tensor "
                f"on {hist.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    if b == 0 or n_chan == 0 or h == 0 or b * n_chan >= 2**31:
        raise ValueError(f"glr_scan_tenants: unsupported shape {tuple(hist.shape)}, B={b}")
    return b, n_chan, h


def glr_scan_tenants(hist: torch.Tensor, slots: torch.Tensor, detect: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
    """Launch the tenant form on CUDA tensors: ``hist`` (R, N, H) f32 slot
    state (read in place, never written), ``slots`` (B,) int32 (each < R),
    ``detect`` (B,) bool, ``counts`` (B, N) int32 valid lengths.  Returns
    (B, N) f32: the statistic of channel c of slot ``slots[b]``, -inf where
    ``detect[b]`` is false or the count is below 2."""
    b, n_chan, h = _tenants_checked(hist, slots, detect, counts)
    fn = _build.load("glr_scan", "glr_scan_tenants_launch", _TENANTS_ARGTYPES)
    out = torch.empty((b, n_chan), dtype=torch.float32, device=hist.device)
    err = fn(hist.data_ptr(), slots.data_ptr(), detect.data_ptr(), counts.data_ptr(),
             out.data_ptr(), b, n_chan, h, _build.stream(hist.get_device()))
    if err != 0:
        raise RuntimeError(f"glr_scan_tenants: kernel launch failed (cudaError {err})")
    glr_scan_tenants.launches += 1
    return out


glr_scan_tenants.launches = 0


def cost(rows: int, h: int, samples=None, splits=None) -> KernelCost:
    """One call's work on ``rows`` histories of ``h``: the ``samples`` the
    counts cover read once, each row's count read and statistic written;
    ``KL_SPLIT_FLOPS`` f32 operations a split and the two scans' adds, 2 a
    sample.  ``None`` counts every history full (``rows * h`` samples,
    ``rows * (h - 1)`` splits: the most, what a step on meta tensors is
    charged)."""
    samples = rows * h if samples is None else samples
    splits = rows * (h - 1) if splits is None else splits
    return KernelCost(KL_SPLIT_FLOPS * splits + 2 * samples, samples * 4 + rows * 8,
                      PEAK_FLOPS_F32)


def tenants_cost(n_chan: int, h: int, b: int, samples=None, splits=None) -> KernelCost:
    """``glr_scan_tenants``' work over ``b`` rows of ``n_chan`` histories:
    as ``cost`` over the detecting rows' samples and splits, and each of the
    B rows' counts read (4 bytes a channel), statistics written (4) and slot
    and flag read (5 bytes a row)."""
    samples = b * n_chan * h if samples is None else samples
    splits = b * n_chan * (h - 1) if splits is None else splits
    return KernelCost(KL_SPLIT_FLOPS * splits + 2 * samples,
                      samples * 4 + b * n_chan * 8 + b * 5, PEAK_FLOPS_F32)


def meta(hist, counts):
    """``glr_scan``'s output on meta tensors: (N,) f32."""
    return hist.new_empty(hist.shape[:1], dtype=torch.float32)


def tenants_meta(hist, slots, detect, counts):
    """``glr_scan_tenants``' output on meta tensors: (B, N) f32."""
    return counts.new_empty(counts.shape, dtype=torch.float32)
