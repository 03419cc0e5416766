"""Attention blocks: GQA (bias / qk-norm / windowed) and MLA.

Twin of ``repro/models/attention.py``.  Two execution paths share one set
of weights:

* ``prefill`` — full-sequence attention through ``attn_core``.  On a CUDA
  tensor it is the hand-written ``flash_attention`` kernel whenever the
  value width equals the query width, at every prompt length (the JAX
  package's ``S >= 256`` and TPU-backend tests were a TPU tiling choice);
  its gradient is the hand-written backward kernel wherever the forward
  took the tensor-core route (bf16, D % 8 == 0).
  Elsewhere, or with ``impl="plain"``, a query-chunked softmax in plain
  PyTorch with the same semantics runs (the twin of ``_attn_core_xla``).
* ``decode`` — one token against a (possibly ring / latent) KV cache,
  plain products against the cache as in the JAX package.  The cache is
  updated in place (one slot written a step) instead of copied.

MLA's value width differs from its query width (minicpm3: 64 against 96;
deepseek-v2: 128 against 192), so its prefill takes the plain chunked
path on every device, as JAX's ``attn_core`` sends it to the XLA path.
MLA decode uses the *absorbed* form by default (queries pulled into
latent space; scores taken against the compressed cache); ``absorb=False``
decompresses the cache every step (the naive baseline).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as _kernel_ops
from repro_torch.kernels.flash_attention import tc_route
from repro_torch.models.kvcache import ring_slot, valid_mask
from repro_torch.models.layers import ParamBuilder, apply_rope, rms_norm

_NEG_INF = -1e30
ATTN_CHUNK = 512      # query-chunk size for the plain prefill path
ATTN_IMPLS = (None, "kernel", "plain")


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def add_gqa_params(pb: ParamBuilder, prefix: str, cfg: ModelConfig, stacked: int = 0):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    lead = (stacked,) if stacked else ()
    ls = ("layers",) if stacked else ()
    pb.add(f"{prefix}/wq", lead + (d, hq * hd), ls + ("embed", "heads"))
    pb.add(f"{prefix}/wk", lead + (d, hkv * hd), ls + ("embed", "heads"))
    pb.add(f"{prefix}/wv", lead + (d, hkv * hd), ls + ("embed", "heads"))
    pb.add(f"{prefix}/wo", lead + (hq * hd, d), ls + ("heads", "embed"))
    if cfg.qkv_bias:
        pb.add(f"{prefix}/bq", lead + (hq * hd,), ls + ("heads",), init="zeros")
        pb.add(f"{prefix}/bk", lead + (hkv * hd,), ls + ("heads",), init="zeros")
        pb.add(f"{prefix}/bv", lead + (hkv * hd,), ls + ("heads",), init="zeros")
    if cfg.qk_norm:
        pb.add(f"{prefix}/q_norm", lead + (hd,), ls + (None,), init="ones")
        pb.add(f"{prefix}/k_norm", lead + (hd,), ls + (None,), init="ones")


def add_mla_params(pb: ParamBuilder, prefix: str, cfg: ModelConfig, stacked: int = 0):
    d, h = cfg.d_model, cfg.n_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lead = (stacked,) if stacked else ()
    ls = ("layers",) if stacked else ()
    if r_q:
        pb.add(f"{prefix}/wq_down", lead + (d, r_q), ls + ("embed", None))
        pb.add(f"{prefix}/q_norm", lead + (r_q,), ls + (None,), init="ones")
        pb.add(f"{prefix}/wq_up", lead + (r_q, h * (dn + dr)), ls + (None, "heads"))
    else:
        pb.add(f"{prefix}/wq", lead + (d, h * (dn + dr)), ls + ("embed", "heads"))
    pb.add(f"{prefix}/wkv_down", lead + (d, r_kv + dr), ls + ("embed", None))
    pb.add(f"{prefix}/kv_norm", lead + (r_kv,), ls + (None,), init="ones")
    pb.add(f"{prefix}/wkv_up", lead + (r_kv, h * (dn + dv)), ls + (None, "heads"))
    pb.add(f"{prefix}/wo", lead + (h * dv, d), ls + ("heads", "embed"))


# ---------------------------------------------------------------------------
# core attention
# ---------------------------------------------------------------------------

def _chunk_attn(q, k, v, q_offset, causal, window, scale, kv_len):
    """One query chunk: q (B,H,Cq,D); k,v (B,Hkv,S,D) -> (B,H,Cq,Dv), in f32
    (f64 inputs in f64)."""
    hq, hkv = q.shape[1], k.shape[1]
    g = hq // hkv
    b, _, cq, _ = q.shape
    s = k.shape[2]
    wt = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, hkv, g, cq, -1)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(wt), k.to(wt)) * scale
    q_idx = q_offset + torch.arange(cq, device=q.device)[:, None]
    k_idx = torch.arange(s, device=q.device)[None, :]
    mask = k_idx < kv_len
    if causal:
        mask = mask & (k_idx <= q_idx)
    if window > 0:
        mask = mask & (k_idx > q_idx - window)
    logits.masked_fill_(~mask, _NEG_INF)        # in place: the product's output is not saved
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.to(wt))
    return out.reshape(b, hq, cq, -1).to(q.dtype)


def _attn_core_plain(q, k, v, causal, window, scale, chunk):
    """The query-chunked plain path: at most ``chunk`` query rows a step, so
    the f32 logits of one step are (B, Hq, chunk, S)."""
    s = q.shape[2]
    if s <= chunk:
        return _chunk_attn(q, k, v, 0, causal, window, scale, s)
    outs = [_chunk_attn(q[:, :, i:i + chunk], k, v, i, causal, window, scale, s)
            for i in range(0, s, chunk)]
    return torch.cat(outs, dim=2)


BACKWARD_RANGE = "attn_core.backward"    # its profiler range, on either backward route
FORWARD_RANGE = "attn_core (forward)"    # attn_core's, on either route


def kernel_backward(q: torch.Tensor) -> bool:
    """Whether ``_KernelAttention``'s backward takes ``ops.flash_attention_bwd``
    (the backward kernels on the card, their plain version on the CPU, their
    meta route on meta): every CPU and meta call, and on CUDA the calls the
    tensor-core forward takes (``tc_route``: bf16, D % 8 == 0).  Picked from
    dtype and D before any launch; the other CUDA calls (f32, bf16 with
    D % 8 != 0) recompute through the plain chunked path."""
    return not q.is_cuda or tc_route(q.dtype, q.shape[-1])


class _KernelAttention(torch.autograd.Function):
    """Forward: ``ops.flash_attention`` (the CUDA kernel on the card), with
    the row logsumexp when the backward kernels will need it.  Backward,
    inside one ``record_function`` range named ``BACKWARD_RANGE`` so a trace
    can give its device time: ``ops.flash_attention_bwd`` where
    ``kernel_backward`` says so, else the recompute through the plain
    chunked path, as the JAX package's ``custom_vjp`` does (counted in
    ``plain_backward_calls``).  A failed launch raises; neither route stands
    in for the other."""

    plain_backward_calls = 0     # backward passes through the chunked recompute

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, chunk):
        ctx.args = (causal, window, scale, chunk)
        ctx.kernel_backward = kernel_backward(q)
        if ctx.kernel_backward and any(ctx.needs_input_grad[:3]):
            out, lse = _kernel_ops.flash_attention(q, k, v, causal=causal, window=window,
                                                   scale=scale, return_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return _kernel_ops.flash_attention(q, k, v, causal=causal, window=window, scale=scale)

    @staticmethod
    def backward(ctx, g):
        causal, window, scale, _ = ctx.args
        with torch.profiler.record_function(BACKWARD_RANGE):
            if ctx.kernel_backward:
                q, k, v, out, lse = ctx.saved_tensors
                grads = _kernel_ops.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                                        window=window, scale=scale)
            else:
                _KernelAttention.plain_backward_calls += 1
                with torch.enable_grad():
                    leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
                    out = _attn_core_plain(*leaves, *ctx.args)
                grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None, None)


def attn_core(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
    chunk: int = ATTN_CHUNK, impl: Optional[str] = None,
) -> torch.Tensor:
    """GQA attention.  q (B,Hq,S,D), k/v (B,Hkv,S,Dv) -> (B,Hq,S,Dv).

    ``impl``: ``None`` takes the kernel route on a CUDA tensor whenever
    Dv == D, and on a meta tensor where the card would (the dry run's
    path: the kernels' meta routes, forward and backward),
    and the plain chunked path otherwise; ``"kernel"`` forces the
    kernel route (the plain version of the kernel on a CPU tensor: the
    twin of ``REPRO_ATTN_IMPL=flash``); ``"plain"`` forces the chunked path
    (the card-side reference).  Runs inside the profiler range
    ``FORWARD_RANGE``."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_core: unknown impl {impl!r}; use one of {ATTN_IMPLS}")
    d = q.shape[-1]
    scale = float(scale) if scale is not None else float(1.0 / (d ** 0.5))
    kernel = impl == "kernel" or (impl is None and (q.is_cuda or q.is_meta))
    with torch.profiler.record_function(FORWARD_RANGE):
        if kernel and v.shape[-1] == d:
            return _KernelAttention.apply(q, k, v, causal, window, scale, chunk)
        return _attn_core_plain(q, k, v, causal, window, scale, chunk)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def _project_qkv(p, prefix, x, cfg: ModelConfig, positions):
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b, s, _ = x.shape
    q = x @ p[f"{prefix}/wq"]
    k = x @ p[f"{prefix}/wk"]
    v = x @ p[f"{prefix}/wv"]
    if cfg.qkv_bias:
        q = q + p[f"{prefix}/bq"]
        k = k + p[f"{prefix}/bk"]
        v = v + p[f"{prefix}/bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p[f"{prefix}/q_norm"], cfg.norm_eps)
        k = rms_norm(k, p[f"{prefix}/k_norm"], cfg.norm_eps)
    if cfg.is_decoder:  # encoders use absolute positions, no rope
        q = apply_rope(q.transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def gqa_prefill(
    p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, cfg: ModelConfig,
    window: int = 0, attn_impl: Optional[str] = None,
) -> torch.Tensor:
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, prefix, x, cfg, positions)
    out = attn_core(q, k, v, causal=cfg.is_decoder, window=window, impl=attn_impl)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return out @ p[f"{prefix}/wo"]


def gqa_decode(
    p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, cfg: ModelConfig,
    cache_k: torch.Tensor, cache_v: torch.Tensor, pos: torch.Tensor,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x (B,1,D); cache k/v (B,Hkv,P,hd), written in
    place at the slot of ``pos`` (0-d int tensor).  Returns (y, k, v)."""
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    phys = cache_k.shape[2]
    q, k_new, v_new = _project_qkv(p, prefix, x, cfg, pos.reshape(1))
    slot = (ring_slot(pos, phys) if window > 0 else pos).reshape(1).long()
    cache_k.index_copy_(2, slot, k_new.to(cache_k.dtype))
    cache_v.index_copy_(2, slot, v_new.to(cache_v.dtype))

    g = hq // hkv
    qg = q.reshape(b, hkv, g, hd)
    logits = torch.einsum("bhgd,bhkd->bhgk", qg.float(), cache_k.float()) / (hd ** 0.5)
    mask = valid_mask(pos, phys, window)
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", probs, cache_v.float())
    out = out.reshape(b, 1, hq * hd).to(x.dtype)
    y = out @ p[f"{prefix}/wo"]
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA block (deepseek-v2 / minicpm3)
# ---------------------------------------------------------------------------

def _mla_q(p, prefix, x, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        ql = rms_norm(x @ p[f"{prefix}/wq_down"], p[f"{prefix}/q_norm"], cfg.norm_eps)
        q = ql @ p[f"{prefix}/wq_up"]
    else:
        q = x @ p[f"{prefix}/wq"]
    q = q.reshape(b, s, h, dn + dr).transpose(1, 2)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    return q[..., :dn], q_rope                            # (B,H,S,dn), (B,H,S,dr)


def _mla_latent(p, prefix, x, cfg: ModelConfig, positions):
    r_kv = cfg.kv_lora_rank
    kv = x @ p[f"{prefix}/wkv_down"]
    latent = rms_norm(kv[..., :r_kv], p[f"{prefix}/kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., r_kv:], positions, cfg.rope_theta)   # (B,S,dr) shared
    return latent, k_rope


def mla_prefill(
    p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, cfg: ModelConfig,
    window: int = 0, attn_impl: Optional[str] = None,
) -> torch.Tensor:
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    positions = torch.arange(s, device=x.device)
    q_nope, q_rope = _mla_q(p, prefix, x, cfg, positions)
    latent, k_rope = _mla_latent(p, prefix, x, cfg, positions)
    kv = (latent @ p[f"{prefix}/wkv_up"]).reshape(b, s, h, dn + dv).transpose(1, 2)
    # fold the shared rotary key into every head (a broadcast view until the
    # concatenation writes it); concatenate the nope | rope dims
    k = torch.cat([kv[..., :dn], k_rope[:, None].expand(b, h, s, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scale = 1.0 / ((dn + dr) ** 0.5)
    out = attn_core(q, k, kv[..., dn:], causal=True, window=window, scale=scale,
                    impl=attn_impl)                       # Dv != D: the plain chunked path
    out = out.transpose(1, 2).reshape(b, s, h * dv)
    return out @ p[f"{prefix}/wo"]


def mla_decode(
    p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, cfg: ModelConfig,
    cache_latent: torch.Tensor, cache_krope: torch.Tensor, pos: torch.Tensor,
    window: int = 0, absorb: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token MLA decode against the latent cache (B,P,r_kv) and the
    shared rotary keys (B,P,dr), both written in place at the slot of
    ``pos`` (0-d int tensor).  Returns (y, latent, k_rope).

    absorb=True: queries are pulled into latent space through wkv_up (the
    deployable O(S * r_kv) path).  absorb=False decompresses the whole
    cache every step (the naive baseline).  Both in f32, as in JAX.
    """
    b = x.shape[0]
    h, dn, dr, dv, r_kv = (
        cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank,
    )
    phys = cache_latent.shape[1]
    positions = pos.reshape(1)
    q_nope, q_rope = _mla_q(p, prefix, x, cfg, positions)   # (B,H,1,dn), (B,H,1,dr)
    latent_new, krope_new = _mla_latent(p, prefix, x, cfg, positions)
    slot = (ring_slot(pos, phys) if window > 0 else pos).reshape(1).long()
    cache_latent.index_copy_(1, slot, latent_new.to(cache_latent.dtype))
    cache_krope.index_copy_(1, slot, krope_new.to(cache_krope.dtype))

    w_up = p[f"{prefix}/wkv_up"].reshape(r_kv, h, dn + dv).float()
    w_uk, w_uv = w_up[..., :dn], w_up[..., dn:]
    scale = 1.0 / ((dn + dr) ** 0.5)
    lat = cache_latent.float()                               # (B,P,r)
    if absorb:
        # q_eff[b,h,r] = sum_dn q_nope[b,h,dn] * w_uk[r,h,dn]
        q_eff = torch.einsum("bhqd,rhd->bhr", q_nope.float(), w_uk)
        logits = torch.einsum("bhr,bpr->bhp", q_eff, lat)
    else:
        k_nope = torch.einsum("bpr,rhd->bhpd", lat, w_uk)
        logits = torch.einsum("bhqd,bhpd->bhp", q_nope.float(), k_nope)
    logits = logits + torch.einsum("bhqd,bpd->bhp", q_rope.float(), cache_krope.float())
    logits = logits * scale
    mask = valid_mask(pos, phys, window)
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if absorb:
        ctx = torch.einsum("bhp,bpr->bhr", probs, lat)          # context in latent space
        out = torch.einsum("bhr,rhd->bhd", ctx, w_uv)
    else:
        v = torch.einsum("bpr,rhd->bhpd", lat, w_uv)
        out = torch.einsum("bhp,bhpd->bhd", probs, v)
    out = out.reshape(b, 1, h * dv).to(x.dtype)
    y = out @ p[f"{prefix}/wo"]
    return y, cache_latent, cache_krope
