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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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
