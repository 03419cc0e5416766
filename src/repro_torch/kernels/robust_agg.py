"""CUDA kernel wrapper: masked per-coordinate trimmed mean / median.

Replaces the Pallas TPU kernel ``robust_trimmed`` of
``src/repro/kernels/robust_agg.py`` (``_trim_kernel``): per parameter
coordinate, the participating rows of rank in [k, n - k) (rank = count of
participating rows strictly below, ties by row index) summed and divided
by ``max(n - 2k, 1)``.  Source: ``csrc/robust_trimmed.cu``; semantics of
record: ``ref.robust_trimmed``.

What bounds it on the H100: operations.  At least one lane instruction per
ordered pair of rows, M^2 * P, against M * P elements read once; one thread
per coordinate holds its M values in registers (a compile-time bucket of
8/16/32/64 slots), non-participants as NaN, and ranks them with one compare
per unordered pair.  At the Fig. 3 size (M = 20, P = 5674) the call is
bound by its host cost (``chip_smoke.py`` phase 2 prints the split).
``n`` and ``k`` stay on the device (the kernel reads each through its own
pointer), so the aggregation adds no host sync and no extra launch to a
round.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 64                  # the kernel's largest register bucket


def _scalar(name, x, updates, dev):
    if x.dtype != torch.float32 or not x.is_cuda or x.get_device() != dev or x.numel() != 1:
        raise ValueError(
            f"robust_trimmed: {name} must be a one-element f32 tensor on {updates.device}, "
            f"got {tuple(x.shape)} {x.dtype} on {x.device}")


def _checked(updates: torch.Tensor, mask: torch.Tensor, n_succ: torch.Tensor,
             k_trim: torch.Tensor):
    """The wrapper's checks, cheapest first for a valid call: raises on what
    the kernel does not take, else returns (M, P, dtype code, device index)."""
    if not updates.is_cuda:
        raise ValueError(f"robust_trimmed: the kernel takes CUDA tensors, got {updates.device}")
    if updates.ndim != 2:
        raise ValueError(f"robust_trimmed: updates must be (M, P), got {tuple(updates.shape)}")
    code = _DTYPES.get(updates.dtype)
    if code is None:
        raise TypeError(f"robust_trimmed: updates dtype {updates.dtype} not supported (f32 or bf16)")
    if not updates.is_contiguous():
        raise ValueError("robust_trimmed: updates must be contiguous")
    m, p = updates.shape
    if m == 0 or p == 0 or m > MAX_ROWS:
        raise ValueError(f"robust_trimmed: unsupported shape ({m}, {p}); 1 <= M <= {MAX_ROWS}")
    dev = updates.get_device()
    if mask.dtype != torch.float32 or not mask.is_cuda or mask.get_device() != dev \
            or mask.shape != (m,) or not mask.is_contiguous():
        raise ValueError(
            f"robust_trimmed: mask must be a contiguous ({m},) f32 tensor on {updates.device}, "
            f"got {tuple(mask.shape)} {mask.dtype} on {mask.device}")
    _scalar("n_succ", n_succ, updates, dev)
    _scalar("k_trim", k_trim, updates, dev)
    return m, p, code, dev


def robust_trimmed(updates: torch.Tensor, mask: torch.Tensor, n_succ: torch.Tensor,
                   k_trim: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``updates`` (M, P) f32 or bf16, contiguous, on
    CUDA, M <= ``MAX_ROWS``; ``mask`` (M,) f32 {0, 1}; ``n_succ`` and
    ``k_trim`` one-element f32 tensors on the same device.  Returns (P,)
    f32."""
    m, p, code, dev = _checked(updates, mask, n_succ, k_trim)
    fn = _build.load("robust_trimmed", "robust_trimmed_launch", _ARGTYPES)
    out = updates.new_empty(p, dtype=torch.float32)
    err = fn(updates.data_ptr(), mask.data_ptr(), n_succ.data_ptr(), k_trim.data_ptr(),
             out.data_ptr(), m, p, code, _build.stream(dev))
    if err != 0:
        raise RuntimeError(f"robust_trimmed: kernel launch failed (cudaError {err})")
    robust_trimmed.launches += 1
    return out


robust_trimmed.launches = 0
