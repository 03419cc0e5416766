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

A batch of runs (the batched FL engine's Step 4) is one launch with a run
axis on the grid; each run's row is computed as the single-run kernel
computes it, bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.utils.roofline import PEAK_FLOPS_F32, KernelCost

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_BATCH_ARGTYPES = _ARGTYPES[:3] + [ctypes.c_int] + _ARGTYPES[3:]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_M = 48 * 1024 // 4          # the largest M a launch takes (a run's M, in a batch)
MAX_RUNS = 65535                 # the largest batch a launch takes (the grid's y extent)


def _checked(updates: torch.Tensor, scale: torch.Tensor):
    """The wrapper's checks, cheapest first for a valid call: raises on what
    the kernel does not take, else returns (B, M, P, dtype code, device
    index), B = 0 for a single run (M, P)."""
    if not updates.is_cuda:
        raise ValueError(
            f"weighted_aggregate: the kernel takes CUDA tensors, got {updates.device}")
    if updates.ndim not in (2, 3):
        raise ValueError(f"weighted_aggregate: updates must be (M, P) or (B, M, P), "
                         f"got {tuple(updates.shape)}")
    code = _DTYPES.get(updates.dtype)
    if code is None:
        raise TypeError(
            f"weighted_aggregate: updates dtype {updates.dtype} not supported (f32 or bf16)")
    b = updates.shape[0] if updates.ndim == 3 else 0
    m, p = updates.shape[-2:]
    if not updates.is_contiguous():
        raise ValueError("weighted_aggregate: updates must be contiguous")
    dev = updates.get_device()
    want = updates.shape[:-1]
    if scale.dtype != torch.float32 or not scale.is_cuda or scale.get_device() != dev \
            or scale.shape != want or not scale.is_contiguous():
        raise ValueError(
            f"weighted_aggregate: scale must be a contiguous {tuple(want)} f32 tensor on "
            f"{updates.device}, got {tuple(scale.shape)} {scale.dtype} on {scale.device}")
    if m == 0 or p == 0 or m > _MAX_M or (updates.ndim == 3 and not 0 < b <= MAX_RUNS):
        raise ValueError(f"weighted_aggregate: unsupported shape {tuple(updates.shape)}")
    return b, m, p, code, dev


def weighted_aggregate(updates: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``updates`` (M, P) f32 or bf16, contiguous, on
    CUDA; ``scale`` (M,) f32 on the same device.  Returns (P,) f32.  A
    batch of runs, (B, M, P) with (B, M) scales, is one launch of the batch
    entry and returns (B, P), row b the single-run result on run b; it
    counts in ``launches`` and in ``batch_launches``."""
    b, m, p, code, dev = _checked(updates, scale)
    if b:
        fn = _build.load("weighted_aggregate", "weighted_aggregate_batch_launch",
                         _BATCH_ARGTYPES)
        out = updates.new_empty((b, p), dtype=torch.float32)
        err = fn(updates.data_ptr(), scale.data_ptr(), out.data_ptr(), b, m, p, code,
                 _build.stream(dev))
    else:
        fn = _build.load("weighted_aggregate", "weighted_aggregate_launch", _ARGTYPES)
        out = updates.new_empty(p, dtype=torch.float32)
        err = fn(updates.data_ptr(), scale.data_ptr(), out.data_ptr(), m, p, code,
                 _build.stream(dev))
    if err != 0:
        raise RuntimeError(f"weighted_aggregate: kernel launch failed (cudaError {err})")
    weighted_aggregate.launches += 1
    weighted_aggregate.batch_launches += bool(b)
    return out


weighted_aggregate.launches = 0
weighted_aggregate.batch_launches = 0


def cost(shape, itemsize: int = 4) -> KernelCost:
    """One call's work at ``shape`` = (M, P) or (B, M, P): 2 M P flops a run
    at the f32 rate; each update read once (``itemsize`` bytes), the (M,)
    f32 scales read and the (P,) f32 output written once."""
    b, (m, p) = (shape[0] if len(shape) == 3 else 1), shape[-2:]
    return KernelCost(2 * b * m * p, b * (m * p * itemsize + m * 4 + p * 4), PEAK_FLOPS_F32)


def meta(updates: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's output on meta tensors: (P,) or (B, P) f32."""
    return updates.new_empty(updates.shape[:-2] + updates.shape[-1:], dtype=torch.float32)
