"""CUDA kernel wrapper: Eq. 7 zeta-weighted masked aggregation.

Replaces the Pallas TPU kernel ``weighted_aggregate`` of
``src/repro/kernels/weighted_aggregate.py`` (``_agg_kernel``):
out[p] = sum_m scale[m] * updates[m, p], accumulated in f32.
Source: ``csrc/weighted_aggregate.cu``; semantics of record:
``ref.weighted_aggregate``.

What bounds it on the H100: memory bandwidth.  It reads M*P*sizeof(dtype)
bytes and writes 4*P for 2*M*P flops, far below the card's flop-to-byte
balance.  The design reads every update element exactly once: each thread
owns neighbouring columns, with the widest loads every row's alignment
allows (16 or 8 bytes; the Fig. 3 shape's rows are 8-byte aligned), and
issues a chunk of rows' loads together before adding them in row order; no
atomics, so the result is deterministic.  At the Fig. 3 size (M = 20,
P = 5674) the call is bound by its host cost: the wrapper's checks, the
output's allocation, the stream lookup and the ``ctypes`` call
(``chip_smoke.py`` phase 2 prints that split).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_M = 48 * 1024 // 4          # the largest M a launch takes


def _checked(updates: torch.Tensor, scale: torch.Tensor):
    """The wrapper's checks, cheapest first for a valid call: raises on what
    the kernel does not take, else returns (M, P, dtype code, device index)."""
    if not updates.is_cuda:
        raise ValueError(
            f"weighted_aggregate: the kernel takes CUDA tensors, got {updates.device}")
    if updates.ndim != 2:
        raise ValueError(f"weighted_aggregate: updates must be (M, P), got {tuple(updates.shape)}")
    code = _DTYPES.get(updates.dtype)
    if code is None:
        raise TypeError(
            f"weighted_aggregate: updates dtype {updates.dtype} not supported (f32 or bf16)")
    m, p = updates.shape
    if not updates.is_contiguous():
        raise ValueError("weighted_aggregate: updates must be contiguous")
    dev = updates.get_device()
    if scale.dtype != torch.float32 or not scale.is_cuda or scale.get_device() != dev \
            or scale.shape != (m,) or not scale.is_contiguous():
        raise ValueError(
            f"weighted_aggregate: scale must be a contiguous ({m},) f32 tensor on "
            f"{updates.device}, got {tuple(scale.shape)} {scale.dtype} on {scale.device}")
    if m == 0 or p == 0 or m > _MAX_M:
        raise ValueError(f"weighted_aggregate: unsupported shape ({m}, {p})")
    return m, p, code, dev


def weighted_aggregate(updates: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``updates`` (M, P) f32 or bf16, contiguous, on
    CUDA; ``scale`` (M,) f32 on the same device.  Returns (P,) f32."""
    m, p, code, dev = _checked(updates, scale)
    fn = _build.load("weighted_aggregate", "weighted_aggregate_launch", _ARGTYPES)
    out = updates.new_empty(p, dtype=torch.float32)
    err = fn(updates.data_ptr(), scale.data_ptr(), out.data_ptr(), m, p, code,
             _build.stream(dev))
    if err != 0:
        raise RuntimeError(f"weighted_aggregate: kernel launch failed (cudaError {err})")
    weighted_aggregate.launches += 1
    return out


weighted_aggregate.launches = 0
