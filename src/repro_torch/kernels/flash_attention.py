"""CUDA kernel wrappers: blockwise (flash) grouped-query attention, forward
and backward.

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

The tensor-core forward can also write each query row's logsumexp
(``return_lse``), which the backward kernels read
(``csrc/flash_attention_bwd.cu``, ``flash_attention_bwd``): the gradient of
every call the tensor-core route takes, in three launches and no atomics
(deterministic), wgmma products on TMA-fed tiles as in the forward.  It
replaces no Pallas kernel: it is the counterpart of the JAX package's
``custom_vjp`` backward, which recomputes through XLA
(``src/repro/models/attention.py:147-149``).  Semantics of record:
``ref.mha_attention_bwd``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.utils.roofline import PEAK_FLOPS_BF16, PEAK_FLOPS_F32, KernelCost

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                                           ctypes.c_void_p]
_TC_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p,
                                                              ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"tensor-core": ("flash_attention_tc", "flash_attention_tc_launch", _TC_ARGTYPES),
           "FMA": ("flash_attention", "flash_attention_launch", _ARGTYPES)}
MAX_HEAD_DIM = 256
TC_MAX_HEAD_DIM = 256
# the backward kernels' card check, per tensor: |got - want| <= BWD_RTOL |want| + BWD_ATOL
# max|want| against the f32 plain version on the same inputs; fixed by the emulation of their
# arithmetic in tests/test_torch_flash_bwd_split.py (P and dS rounded once to bf16)
BWD_RTOL = 2.0 ** -6
BWD_ATOL = 2.0 ** -7
_BWD_TILE = 64     # rows of a streamed tile in the backward kernels
_MAX_GRID_YZ = 65535


def _check(name, q, k, v, window):
    """The checks both wrappers make on q, k, v: (B, H, S, D), one dtype of
    f32 or bf16, contiguous, on one CUDA device, Hq a multiple of Hkv,
    1 <= D <= 256, ``window`` >= 0."""
    if not q.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be (B, H, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one dtype of f32 or bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if tuple(k.shape) != (b, hkv, s, d) or tuple(v.shape) != (b, hkv, s, d):
        raise ValueError(f"{name}: k and v must be ({b}, Hkv, {s}, {d}), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if min(b, hq, hkv, s) < 1 or hq % hkv or not 1 <= d <= MAX_HEAD_DIM \
            or max(b, hq) > _MAX_GRID_YZ:
        raise ValueError(f"{name}: unsupported shape q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}; Hq % Hkv == 0, 1 <= D <= {MAX_HEAD_DIM}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k, v must be contiguous")
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    window: int = 0, scale=None, return_lse: bool = False):
    """Launch the route's kernel (``tc_route``): ``q`` (B, Hq, S, D), ``k`` and ``v`` (B, Hkv, S, D),
    one dtype (f32 or bf16), contiguous, on one CUDA device; Hq a multiple
    of Hkv, 1 <= D <= 256, ``window`` >= 0.  ``scale`` defaults to
    1/sqrt(D).  Returns (B, Hq, S, D) in q's dtype; with ``return_lse``
    (the tensor-core route only) also each row's logsumexp of its scaled,
    masked logits, (B, Hq, S) f32, as ``ref.mha_attention`` gives it."""
    _check("flash_attention", q, k, v, window)
    d = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    tc = tc_route(q.dtype, d)
    if return_lse and not tc:
        raise ValueError(f"flash_attention: the logsumexp comes from the tensor-core route only "
                         f"(bf16, D % 8 == 0, D <= {TC_MAX_HEAD_DIM}), got {q.dtype} D = {d}")
    lse = q.new_empty(q.shape[:3], dtype=torch.float32) if return_lse else None
    if tc:
        out = _launch("tensor-core", q, k, v, causal, window, scale, lse)
        flash_attention.tc_launches += 1
    else:
        out = _launch("FMA", q, k, v, causal, window, scale)
        flash_attention.fma_launches += 1
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


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
         dtype: torch.dtype = torch.bfloat16, lse: bool = False) -> KernelCost:
    """One call's work at ``shape`` = (B, Hq, Hkv, S, D): 4 D flops a visible
    (query, key) pair a query head (q.k and p.v; 2 B Hq S^2 D causal, half of
    the full mask's 4 B Hq S^2 D), at the tensor cores' bf16 rate or the f32
    rate; q, k, v read and the output (and with ``lse`` the f32 row
    logsumexp) written once."""
    b, hq, hkv, s, d = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    flops = 4 * b * hq * d * pairs(s, causal, window)
    nbytes = (2 * b * hq + 2 * b * hkv) * s * d * itemsize + lse * b * hq * s * 4
    return KernelCost(flops, nbytes, PEAK_FLOPS_BF16 if dtype == torch.bfloat16 else PEAK_FLOPS_F32)


def cost_bwd(shape, causal: bool = True, window: int = 0,
             dtype: torch.dtype = torch.bfloat16) -> KernelCost:
    """One backward call's work at ``shape`` = (B, Hq, Hkv, S, D): 10 D flops
    a visible (query, key) pair a query head (five products: q.k, dO.v,
    P^T dO, dS K, dS^T Q) at the tensor cores' bf16 rate; q, out, dO and
    k, v read and dq, dk, dv written once (the dtype's bytes), plus the f32
    row statistics: the logsumexp read, Delta written and read."""
    b, hq, hkv, s, d = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    flops = 10 * b * hq * d * pairs(s, causal, window)
    nbytes = (4 * b * hq + 4 * b * hkv) * s * d * itemsize + 3 * b * hq * s * 4
    return KernelCost(flops, nbytes, PEAK_FLOPS_BF16 if dtype == torch.bfloat16 else PEAK_FLOPS_F32)


def meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool = False):
    """The kernel's output on meta tensors: (B, Hq, S, D) in q's dtype, and
    with ``return_lse`` the (B, Hq, S) f32 logsumexp (allocated first, as
    the wrapper allocates it)."""
    if not return_lse:
        return q.new_empty(q.shape)
    lse = q.new_empty(q.shape[:3], dtype=torch.float32)
    return q.new_empty(q.shape), lse


def _bwd_scratch(q: torch.Tensor) -> torch.Tensor:
    """The backward kernels' f32 scratch: each query row's lse log2(e) and
    Delta = rowsum(dO * O), (2, B Hq, S_pad) with S_pad = S rounded up to
    the 64-row tile, so that a tile's 64 values start 256-byte aligned."""
    b, hq, s, _ = q.shape
    return q.new_empty((2, b * hq, -(-s // _BWD_TILE) * _BWD_TILE), dtype=torch.float32)


def meta_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The backward kernels' outputs on meta tensors, dq, dk, dv in the
    shapes and dtypes of q, k, v, allocated as the wrapper allocates them:
    the f32 scratch (``_bwd_scratch``) first, freed on return."""
    scratch = _bwd_scratch(q)
    grads = q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)
    del scratch
    return grads


def tc_route(dtype: torch.dtype, d: int) -> bool:
    """Whether a call of this dtype and head dim takes the tensor-core
    kernel (else the f32-FMA kernel)."""
    return dtype == torch.bfloat16 and d % 8 == 0 and d <= TC_MAX_HEAD_DIM


def _stream(q: torch.Tensor) -> int:
    return _build.stream(q.get_device())


def _launch(route, q, k, v, causal, window, scale, lse=None):
    """One route's kernel ("tensor-core" or "FMA") on checked inputs, the
    tensor-core one writing ``lse`` when it is given; counts nothing."""
    lib, symbol, argtypes = _ROUTES[route]
    b, hq, s, d = q.shape
    fn = _build.load(lib, symbol, argtypes)
    out = q.new_empty(q.shape)
    extra = ((_DTYPES[q.dtype],) if route == "FMA" else
             (None if lse is None else lse.data_ptr(),))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, k.shape[1], s, d,
             int(bool(causal)), int(window), scale, *extra, _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention: {route} kernel launch failed (cudaError {err})")
    return out


def bwd_within(got: torch.Tensor, want: torch.Tensor) -> float:
    """The card check of one backward output: the largest |got - want| -
    BWD_RTOL |want| over BWD_ATOL max|want| (f32); the tensor passes when it
    is at most 1."""
    err = (got.float() - want.float()).abs() - BWD_RTOL * want.float().abs()
    return float(err.max()) / (BWD_ATOL * max(float(want.float().abs().max()), 1e-30))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
                        window: int = 0, scale=None):
    """Launch the backward kernels (``csrc/flash_attention_bwd.cu``) on a
    call the tensor-core forward takes: q, out, ``do`` (B, Hq, S, D), k, v
    (B, Hkv, S, D), all bf16 with D % 8 == 0 and D <= 256, contiguous, on
    one CUDA device; ``lse`` (B, Hq, S) f32, the forward's
    ``return_lse``.  Returns (dq, dk, dv) in bf16: three launches (lse and
    Delta into an f32 scratch, dK/dV, dQ), counted as one call on
    ``.launches``."""
    _check("flash_attention_bwd", q, k, v, window)
    b, hq, s, d = q.shape
    if not tc_route(q.dtype, d):
        raise ValueError(f"flash_attention_bwd: the kernels take what the tensor-core forward "
                         f"takes (bf16, D % 8 == 0, D <= {TC_MAX_HEAD_DIM}), got {q.dtype} "
                         f"D = {d}")
    for name, t, shape, dtype in (("out", out, q.shape, q.dtype), ("do", do, q.shape, q.dtype),
                                  ("lse", lse, q.shape[:3], torch.float32)):
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"flash_attention_bwd: {name} must be {tuple(shape)} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be contiguous on {q.device}")
    tensors = (q, k, v, out, lse, do)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention_bwd: every tensor must start 16-byte aligned")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    fn = _build.load("flash_attention_bwd", "flash_attention_bwd_launch", _BWD_ARGTYPES)
    grads = _launch_bwd(fn, q, k, v, out, lse, do, causal, window, scale)
    flash_attention_bwd.launches += 1
    return grads


def _launch_bwd(fn, q, k, v, out, lse, do, causal, window, scale):
    """The C entry ``flash_attention_bwd_launch`` (``fn``, argtypes
    ``_BWD_ARGTYPES``) on checked inputs: allocates the scratch and dq, dk,
    dv, launches, and counts nothing."""
    b, hq, s, d = q.shape
    scratch = _bwd_scratch(q)
    dq, dk, dv = q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)
    err = fn(*(t.data_ptr() for t in (q, k, v, out, lse, do)), scratch.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, k.shape[1], s, d,
             int(bool(causal)), int(window), scale, _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd: kernel launch failed (cudaError {err})")
    return dq, dk, dv


flash_attention_bwd.launches = 0   # backward calls (three kernel launches each)
