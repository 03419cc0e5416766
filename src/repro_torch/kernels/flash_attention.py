"""CUDA kernel wrapper: blockwise (flash) grouped-query attention, forward.

Replaces the Pallas TPU kernel ``flash_attention`` of
``src/repro/kernels/flash_attention.py`` (``_flash_kernel``): online
softmax over 64-key tiles against a resident 64-query tile, causal and
sliding-window masks with whole tiles skipped, query head h reading KV
head h // (Hq / Hkv).  Source: ``csrc/flash_attention.cu``; semantics of
record: ``ref.mha_attention``.

What bounds it on the H100: operations (2 B Hq S^2 D multiply-adds for a
full mask, about half of them causal, against 2 (B Hq + B Hkv) S D
elements moved).  This version runs them as f32 FMAs from shared memory;
the tensor cores are for a later version.  The JAX wrapper pads D to 128
and S to a tile multiple in device memory; here the kernel masks the
tails itself, so any D in [1, 256] and any S are taken as they are.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                                           ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
_MAX_GRID_YZ = 65535


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    window: int = 0, scale=None) -> torch.Tensor:
    """Launch the kernel: ``q`` (B, Hq, S, D), ``k`` and ``v`` (B, Hkv, S, D),
    one dtype (f32 or bf16), contiguous, on one CUDA device; Hq a multiple
    of Hkv, 1 <= D <= 256, ``window`` >= 0.  ``scale`` defaults to
    1/sqrt(D).  Returns (B, Hq, S, D) in q's dtype."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention: the kernel takes CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must be (B, H, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype of f32 or bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if tuple(k.shape) != (b, hkv, s, d) or tuple(v.shape) != (b, hkv, s, d):
        raise ValueError(f"flash_attention: k and v must be ({b}, Hkv, {s}, {d}), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if min(b, hq, hkv, s) < 1 or hq % hkv or not 1 <= d <= MAX_HEAD_DIM \
            or max(b, hq) > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: unsupported shape q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}; Hq % Hkv == 0, 1 <= D <= {MAX_HEAD_DIM}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)

    fn = _build.load("flash_attention", "flash_attention_launch", _ARGTYPES)
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, s, d,
             int(bool(causal)), int(window), scale, _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed (cudaError {err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
