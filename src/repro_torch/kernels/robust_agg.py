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
round.  A batch of runs (the batched FL engine's Step 4) is one launch
with a run axis on the grid, n and k one each a run.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.utils.roofline import PEAK_LANE_OPS_F32, KernelCost

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]
_BATCH_ARGTYPES = _ARGTYPES[:5] + [ctypes.c_int] + _ARGTYPES[5:]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 64                  # the kernel's largest register bucket
MAX_RUNS = 65535               # the largest batch a launch takes (the grid's y extent)


def _scalar(name, x, updates, dev, b):
    want = (b,) if b else ()
    if x.dtype != torch.float32 or not x.is_cuda or x.get_device() != dev \
            or x.numel() != max(b, 1) or (b and (x.shape != want or not x.is_contiguous())):
        what = f"a contiguous ({b},) f32 tensor" if b else "a one-element f32 tensor"
        raise ValueError(
            f"robust_trimmed: {name} must be {what} on {updates.device}, "
            f"got {tuple(x.shape)} {x.dtype} on {x.device}")


def _checked(updates: torch.Tensor, mask: torch.Tensor, n_succ: torch.Tensor,
             k_trim: torch.Tensor):
    """The wrapper's checks, cheapest first for a valid call: raises on what
    the kernel does not take, else returns (B, M, P, dtype code, device
    index), B = 0 for a single run (M, P)."""
    if not updates.is_cuda:
        raise ValueError(f"robust_trimmed: the kernel takes CUDA tensors, got {updates.device}")
    if updates.ndim not in (2, 3):
        raise ValueError(f"robust_trimmed: updates must be (M, P) or (B, M, P), "
                         f"got {tuple(updates.shape)}")
    code = _DTYPES.get(updates.dtype)
    if code is None:
        raise TypeError(f"robust_trimmed: updates dtype {updates.dtype} not supported (f32 or bf16)")
    if not updates.is_contiguous():
        raise ValueError("robust_trimmed: updates must be contiguous")
    b = updates.shape[0] if updates.ndim == 3 else 0
    m, p = updates.shape[-2:]
    if m == 0 or p == 0 or m > MAX_ROWS or (updates.ndim == 3 and not 0 < b <= MAX_RUNS):
        raise ValueError(f"robust_trimmed: unsupported shape {tuple(updates.shape)}; "
                         f"1 <= M <= {MAX_ROWS}")
    dev = updates.get_device()
    want = updates.shape[:-1]
    if mask.dtype != torch.float32 or not mask.is_cuda or mask.get_device() != dev \
            or mask.shape != want or not mask.is_contiguous():
        raise ValueError(
            f"robust_trimmed: mask must be a contiguous {tuple(want)} f32 tensor on "
            f"{updates.device}, got {tuple(mask.shape)} {mask.dtype} on {mask.device}")
    _scalar("n_succ", n_succ, updates, dev, b)
    _scalar("k_trim", k_trim, updates, dev, b)
    return b, m, p, code, dev


def robust_trimmed(updates: torch.Tensor, mask: torch.Tensor, n_succ: torch.Tensor,
                   k_trim: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``updates`` (M, P) f32 or bf16, contiguous, on
    CUDA, M <= ``MAX_ROWS``; ``mask`` (M,) f32 {0, 1}; ``n_succ`` and
    ``k_trim`` one-element f32 tensors on the same device.  Returns (P,)
    f32.  A batch of runs, (B, M, P) with (B, M) masks and (B,) ``n_succ``
    and ``k_trim``, is one launch of the batch entry and returns (B, P),
    row b the single-run result on run b bit for bit; it counts in
    ``launches`` and in ``batch_launches``."""
    b, m, p, code, dev = _checked(updates, mask, n_succ, k_trim)
    ptrs = (updates.data_ptr(), mask.data_ptr(), n_succ.data_ptr(), k_trim.data_ptr())
    if b:
        fn = _build.load("robust_trimmed", "robust_trimmed_batch_launch", _BATCH_ARGTYPES)
        out = updates.new_empty((b, p), dtype=torch.float32)
        err = fn(*ptrs, out.data_ptr(), b, m, p, code, _build.stream(dev))
    else:
        fn = _build.load("robust_trimmed", "robust_trimmed_launch", _ARGTYPES)
        out = updates.new_empty(p, dtype=torch.float32)
        err = fn(*ptrs, out.data_ptr(), m, p, code, _build.stream(dev))
    if err != 0:
        raise RuntimeError(f"robust_trimmed: kernel launch failed (cudaError {err})")
    robust_trimmed.launches += 1
    robust_trimmed.batch_launches += bool(b)
    return out


robust_trimmed.launches = 0
robust_trimmed.batch_launches = 0
RANK_PAIR_OPS = 1      # lane instructions per ordered pair of rows: the least a rank count issues


def cost(shape, itemsize: int = 4, participants=None) -> KernelCost:
    """One call's work at ``shape`` = (M, P) or (B, M, P): one f32 lane
    instruction an ordered pair of participating rows a coordinate (n^2 P a
    run, n = ``participants``, every row when None: M^2 P); each update read
    once, the (M,) mask, n and k read and the (P,) f32 output written
    once."""
    b, (m, p) = (shape[0] if len(shape) == 3 else 1), shape[-2:]
    n = m if participants is None else participants
    return KernelCost(RANK_PAIR_OPS * b * n * n * p,
                      b * (m * p * itemsize + m * 4 + 8 + p * 4), PEAK_LANE_OPS_F32)


def meta(updates, mask, n_succ, k_trim) -> torch.Tensor:
    """The kernel's output on meta tensors: (P,) or (B, P) f32."""
    return updates.new_empty(updates.shape[:-2] + updates.shape[-1:], dtype=torch.float32)
