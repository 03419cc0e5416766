"""CUDA kernel wrapper: masked per-coordinate trimmed mean / median.

Replaces the Pallas TPU kernel ``robust_trimmed`` of
``src/repro/kernels/robust_agg.py`` (``_trim_kernel``): per parameter
coordinate, the participating rows of rank in [k, n - k) (rank = count of
participating rows strictly below, ties by row index) summed and divided
by ``max(n - 2k, 1)``.  Source: ``csrc/robust_trimmed.cu``; semantics of
record: ``ref.robust_trimmed``.

What bounds it on the H100: operations.  M^2 * P rank tests on the FP32
lanes against M * P elements read once; one thread per coordinate holds
its M values in a shared-memory tile.  At the Fig. 3 size (M = 20,
P = 5674) the launch is bound by launch latency.  ``n`` and ``k`` stay on
the device (the kernel reads each through its own pointer), so the
aggregation adds no host sync and no extra launch to a round.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 64                  # the kernel's shared-memory tile is [M][128] f32


def _scalar(name, x, device):
    if x.device != device or x.numel() != 1 or x.dtype != torch.float32:
        raise ValueError(
            f"robust_trimmed: {name} must be a one-element f32 tensor on {device}, "
            f"got {tuple(x.shape)} {x.dtype} on {x.device}")


def robust_trimmed(updates: torch.Tensor, mask: torch.Tensor, n_succ: torch.Tensor,
                   k_trim: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``updates`` (M, P) f32 or bf16, contiguous, on
    CUDA, M <= ``MAX_ROWS``; ``mask`` (M,) f32 {0, 1}; ``n_succ`` and
    ``k_trim`` one-element f32 tensors on the same device.  Returns (P,)
    f32."""
    if not updates.is_cuda:
        raise ValueError(f"robust_trimmed: the kernel takes CUDA tensors, got {updates.device}")
    if updates.dim() != 2:
        raise ValueError(f"robust_trimmed: updates must be (M, P), got {tuple(updates.shape)}")
    if updates.dtype not in _DTYPES:
        raise TypeError(f"robust_trimmed: updates dtype {updates.dtype} not supported (f32 or bf16)")
    if not updates.is_contiguous():
        raise ValueError("robust_trimmed: updates must be contiguous")
    m, p = updates.shape
    dev = updates.device
    if m == 0 or p == 0 or m > MAX_ROWS:
        raise ValueError(f"robust_trimmed: unsupported shape ({m}, {p}); 1 <= M <= {MAX_ROWS}")
    if mask.device != dev or mask.dtype != torch.float32 or tuple(mask.shape) != (m,) \
            or not mask.is_contiguous():
        raise ValueError(
            f"robust_trimmed: mask must be a contiguous ({m},) f32 tensor on {dev}, "
            f"got {tuple(mask.shape)} {mask.dtype} on {mask.device}")
    _scalar("n_succ", n_succ, dev)
    _scalar("k_trim", k_trim, dev)

    fn = _build.load("robust_trimmed", "robust_trimmed_launch", _ARGTYPES)
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    err = fn(updates.data_ptr(), mask.data_ptr(), n_succ.data_ptr(), k_trim.data_ptr(),
             out.data_ptr(), m, p,
             _DTYPES[updates.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"robust_trimmed: kernel launch failed (cudaError {err})")
    robust_trimmed.launches += 1
    return out


robust_trimmed.launches = 0
