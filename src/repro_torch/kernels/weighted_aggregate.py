"""CUDA kernel wrapper: Eq. 7 zeta-weighted masked aggregation.

Replaces the Pallas TPU kernel ``weighted_aggregate`` of
``src/repro/kernels/weighted_aggregate.py`` (``_agg_kernel``):
out[p] = sum_m scale[m] * updates[m, p], accumulated in f32.
Source: ``csrc/weighted_aggregate.cu``; semantics of record:
``ref.weighted_aggregate``.

What bounds it on the H100: memory bandwidth.  It reads M*P*sizeof(dtype)
bytes and writes 4*P for 2*M*P flops, far below the card's flop-to-byte
balance.  The design reads every update element exactly once: each thread
owns neighbouring columns (16-byte f32 / 8-byte bf16 loads when P % 4 == 0,
coalesced scalar loads otherwise) and walks the M rows in order, with the
M scales staged once in shared memory and no atomics, so the result is
deterministic.  At the Fig. 3 size (M = 20, P = 5674) the launch is bound
by latency instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_M = 48 * 1024 // 4          # the scales live in (static-limit) shared memory


def weighted_aggregate(updates: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``updates`` (M, P) f32 or bf16, contiguous, on
    CUDA; ``scale`` (M,) f32 on the same device.  Returns (P,) f32."""
    if not updates.is_cuda:
        raise ValueError(
            f"weighted_aggregate: the kernel takes CUDA tensors, got {updates.device}")
    if updates.dim() != 2:
        raise ValueError(f"weighted_aggregate: updates must be (M, P), got {tuple(updates.shape)}")
    if updates.dtype not in _DTYPES:
        raise TypeError(
            f"weighted_aggregate: updates dtype {updates.dtype} not supported (f32 or bf16)")
    m, p = updates.shape
    if not updates.is_contiguous():
        raise ValueError("weighted_aggregate: updates must be contiguous")
    if scale.device != updates.device or scale.dtype != torch.float32 \
            or tuple(scale.shape) != (m,) or not scale.is_contiguous():
        raise ValueError(
            f"weighted_aggregate: scale must be a contiguous ({m},) f32 tensor on "
            f"{updates.device}, got {tuple(scale.shape)} {scale.dtype} on {scale.device}")
    if m == 0 or p == 0 or m > _MAX_M:
        raise ValueError(f"weighted_aggregate: unsupported shape ({m}, {p})")

    fn = _build.load("weighted_aggregate", "weighted_aggregate_launch", _ARGTYPES)
    out = torch.empty((p,), dtype=torch.float32, device=updates.device)
    vec = 4 if p % 4 == 0 and updates.data_ptr() % 16 == 0 else 1
    err = fn(updates.data_ptr(), scale.data_ptr(), out.data_ptr(), m, p,
             _DTYPES[updates.dtype], vec, torch.cuda.current_stream(updates.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"weighted_aggregate: kernel launch failed (cudaError {err})")
    weighted_aggregate.launches += 1
    return out


weighted_aggregate.launches = 0
