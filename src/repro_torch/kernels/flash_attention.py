"""CUDA kernel wrapper: blockwise (flash) grouped-query attention, forward.

Replaces the Pallas TPU kernel ``flash_attention`` of
``src/repro/kernels/flash_attention.py`` (``_flash_kernel``): online
softmax over key tiles against a resident query tile, causal and
sliding-window masks with whole tiles skipped, query head h reading KV
head h // (Hq / Hkv).  Semantics of record: ``ref.mha_attention``.

Two device routes, picked from dtype and head dim before any launch:

* tensor cores (``csrc/flash_attention_tc.cu``): bf16 with D % 8 == 0 and
  8 <= D <= 256: the bf16 prefills of the dense GQA models (qwen3, qwen2.5,
  qwen1.5), dbrx, phi-3-vision (D = 96) and recurrentgemma's local
  attention (D = 256, MQA, window 2048).  ``wgmma`` for Q.K^T and P.V with
  TMA-fed K/V tiles, D padded to 64, 128 or 256 in shared memory only; up
  to D = 128 with 128-key tiles, at D = 256 with 64-key tiles, so that the
  64 x 256 f32 output a warpgroup holds (128 registers a thread) and the
  tile's logits and P fit the 240 registers a consumer thread gets.  P is
  split into two bf16 terms so that the output keeps the f32 plain
  version's accuracy (see the source's header).
* f32 FMAs (``csrc/flash_attention.cu``): every f32 call and bf16 with
  D % 8 != 0, with 64-query tiles and D padded to 64, 128 or 256 in shared
  memory.  (The MLA models never reach the kernel: their value width
  differs from their query width.)

What bounds it on the H100: operations (2 B Hq S^2 D multiply-adds for a
full mask, about half of them causal, against 2 (B Hq + B Hkv) S D
elements moved).  The JAX wrapper pads D to 128 and S to a tile multiple
in device memory; here both kernels mask the tails themselves.  A failed
build or launch raises; no route stands in for the other.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.utils.roofline import PEAK_FLOPS_BF16, PEAK_FLOPS_F32, KernelCost

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                                           ctypes.c_void_p]
_TC_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"tensor-core": ("flash_attention_tc", "flash_attention_tc_launch", _TC_ARGTYPES),
           "FMA": ("flash_attention", "flash_attention_launch", _ARGTYPES)}
MAX_HEAD_DIM = 256
TC_MAX_HEAD_DIM = 256
_MAX_GRID_YZ = 65535


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    window: int = 0, scale=None) -> torch.Tensor:
    """Launch the route's kernel (``tc_route``): ``q`` (B, Hq, S, D), ``k`` and ``v`` (B, Hkv, S, D),
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

    if tc_route(q.dtype, d):
        out = _launch("tensor-core", q, k, v, causal, window, scale)
        flash_attention.tc_launches += 1
    else:
        out = _launch("FMA", q, k, v, causal, window, scale)
        flash_attention.fma_launches += 1
    flash_attention.launches += 1
    return out


flash_attention.launches = 0       # every launch, both routes
flash_attention.tc_launches = 0    # the tensor-core kernel's
flash_attention.fma_launches = 0   # the f32-FMA kernel's


def pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through at sequence length ``s``:
    key j is visible to query i where j <= i (causal) and j > i - window
    (window > 0)."""
    if causal:
        if window <= 0 or window >= s:
            return s * (s + 1) // 2
        return window * (window + 1) // 2 + (s - window) * window
    if window <= 0 or window > s:
        return s * s
    return s * s - (s - window) * (s - window + 1) // 2


def cost(shape, causal: bool = True, window: int = 0,
         dtype: torch.dtype = torch.bfloat16) -> KernelCost:
    """One call's work at ``shape`` = (B, Hq, Hkv, S, D): 4 D flops a visible
    (query, key) pair a query head (q.k and p.v; 2 B Hq S^2 D causal, half of
    the full mask's 4 B Hq S^2 D), at the tensor cores' bf16 rate or the f32
    rate; q, k, v read and the output written once."""
    b, hq, hkv, s, d = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    flops = 4 * b * hq * d * pairs(s, causal, window)
    nbytes = (2 * b * hq + 2 * b * hkv) * s * d * itemsize
    return KernelCost(flops, nbytes, PEAK_FLOPS_BF16 if dtype == torch.bfloat16 else PEAK_FLOPS_F32)


def meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel's output on meta tensors: (B, Hq, S, D) in q's dtype."""
    return q.new_empty(q.shape)


def tc_route(dtype: torch.dtype, d: int) -> bool:
    """Whether a call of this dtype and head dim takes the tensor-core
    kernel (else the f32-FMA kernel)."""
    return dtype == torch.bfloat16 and d % 8 == 0 and d <= TC_MAX_HEAD_DIM


def _stream(q: torch.Tensor) -> int:
    return _build.stream(q.get_device())


def _launch(route, q, k, v, causal, window, scale):
    """One route's kernel ("tensor-core" or "FMA") on checked inputs;
    counts nothing."""
    lib, symbol, argtypes = _ROUTES[route]
    b, hq, s, d = q.shape
    fn = _build.load(lib, symbol, argtypes)
    out = q.new_empty(q.shape)
    extra = (_DTYPES[q.dtype],) if route == "FMA" else ()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, k.shape[1], s, d,
             int(bool(causal)), int(window), scale, *extra, _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention: {route} kernel launch failed (cudaError {err})")
    return out
