"""Mamba-2 SSD (state-space duality) block — arXiv:2405.21060.

Twin of ``repro/models/ssm.py``.  Selective state space with a scalar
decay a head:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * (x_t outer B_t)
    y_t = C_t . h_t + D * x_t,       gated:  out = norm(y * silu(z)) W_out

The full-sequence forward cuts the sequence into chunks of ``ssm_chunk``
steps: inside a chunk the quadratic "attention-like" form runs as batched
products, and a Python loop over the chunks carries the (B, H, P, N) f32
state (8 chunks at S = 2048, L = 256).  The last chunk may be shorter:
that equals JAX's zero padding, since dt = 0 past the end carries the
state unchanged and adds nothing.  Where a gradient is taken each chunk
runs under a checkpoint, as JAX's ``jax.checkpoint`` of the chunk body:
its (B, H, L, L) decay weights are recomputed in the backward pass, so
those of all the chunks are never held at once; serving runs the chunks
as they are.

Two choices keep the chunk finite and small at full width:

* the decay exponent ``cum_i - cum_j`` is positive above the diagonal
  (about 179 over 256 steps at softplus(dt) ~ 0.7), where ``exp``
  overflows past 88.7; it is set to -inf there *before* the ``exp``, so the
  dropped triangle is an exact 0 (JAX multiplies and then drops it with a
  ``where``; a multiply by a 0/1 mask would give 0 * inf = NaN);
* ``dt_j`` is folded into ``x_j`` (a (B, H, L, P) product, where the
  JAX einsum folds it into the (B, L, L, H) weights), and the ``j``
  contraction runs as a product batched over (b, h): no (B, L, L, H, P)
  tensor is made.  The state update is likewise two steps.

Decode carries (ssm state, conv tails), O(1) in sequence length, and
writes them in place, as the KV caches are.  The chunk loop and the
causal convolutions run inside the profiler ranges ``SSD_RANGE`` and
``CONV_RANGE``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamBuilder, rms_norm

SSD_RANGE = "ssm.ssd_chunks"      # the chunk loop's profiler range
CONV_RANGE = "causal_conv"        # the depthwise causal conv's (SSM and RG-LRU blocks)


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def add_ssm_params(pb: ParamBuilder, prefix: str, cfg: ModelConfig, stacked: int = 0):
    d, n, h = cfg.d_model, cfg.ssm_state, cfg.ssm_heads
    di = d_inner(cfg)
    cw = cfg.conv_width
    lead = (stacked,) if stacked else ()
    ls = ("layers",) if stacked else ()
    pb.add(f"{prefix}/w_z", lead + (d, di), ls + ("embed", "heads"))
    pb.add(f"{prefix}/w_x", lead + (d, di), ls + ("embed", "heads"))
    pb.add(f"{prefix}/w_b", lead + (d, n), ls + ("embed", None))
    pb.add(f"{prefix}/w_c", lead + (d, n), ls + ("embed", None))
    pb.add(f"{prefix}/w_dt", lead + (d, h), ls + ("embed", "heads"))
    pb.add(f"{prefix}/dt_bias", lead + (h,), ls + ("heads",), init="zeros")
    pb.add(f"{prefix}/conv_x", lead + (cw, di), ls + (None, "heads"), scale=0.5)
    pb.add(f"{prefix}/conv_b", lead + (cw, n), ls + (None, None), scale=0.5)
    pb.add(f"{prefix}/conv_c", lead + (cw, n), ls + (None, None), scale=0.5)
    pb.add(f"{prefix}/a_log", lead + (h,), ls + ("heads",), init="zeros")
    pb.add(f"{prefix}/d_skip", lead + (h,), ls + ("heads",), init="ones")
    pb.add(f"{prefix}/norm", lead + (di,), ls + (None,), init="ones")
    pb.add(f"{prefix}/w_out", lead + (di, d), ls + ("heads", "embed"))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x (B,S,C), w (K,C); tail (B,K-1,C) carry-in.
    The sum runs in x's dtype, SiLU in f32.  Returns (out, new tail)."""
    k = w.shape[0]
    with torch.profiler.record_function(CONV_RANGE):
        if tail is None:
            tail = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
        s = x.shape[1]
        out = xp[:, :s] * w[0]
        for i in range(1, k):
            out = out + xp[:, i:i + s] * w[i]
        new_tail = xp[:, -(k - 1):] if k > 1 else tail
        return F.silu(out.float()).to(x.dtype), new_tail


def _ssd_chunk(state: torch.Tensor, xs, a_heads: torch.Tensor):
    """One SSD chunk, in f32.  state (B,H,P,N); xs = (x (B,L,H,P), b (B,L,N),
    c (B,L,N), dt (B,L,H)); a_heads (H,) negative decay rates.  Returns
    (state', y (B,L,H,P))."""
    x, b, c, dt = xs
    el = x.shape[1]
    a = dt * a_heads                                        # (B,L,H)  (<= 0)
    cum = torch.cumsum(a, dim=1).transpose(1, 2)            # (B,H,L) inclusive
    xdt = x.permute(0, 2, 1, 3) * dt.transpose(1, 2)[..., None]   # (B,H,L,P): dt_j x_j
    # incoming-state contribution: y_i += (C_i . h_0) * exp(cum_i)
    y_in = (c[:, None] @ state.transpose(-1, -2)) * torch.exp(cum)[..., None]
    # intra-chunk term: exponent -inf above the diagonal, so exp gives an exact 0
    expo = cum[:, :, :, None] - cum[:, :, None, :]          # (B,H,i,j)
    upper = torch.ones((el, el), dtype=torch.bool, device=x.device).triu_(1)
    w_ij = torch.exp(expo.masked_fill_(upper, float("-inf"))) * (c @ b.transpose(1, 2))[:, None]
    y = y_in + w_ij @ xdt                                   # (B,H,L,P)
    # state update: decay to the chunk's end, then the (P, L) x (L, N) product
    last = cum[:, :, -1:]                                   # (B,H,1)
    carry = xdt * torch.exp(last - cum)[..., None]
    state_new = torch.exp(last)[..., None] * state + carry.transpose(-1, -2) @ b[:, None]
    return state_new, y.permute(0, 2, 1, 3)


def _projections(p, prefix, u):
    z = u @ p[f"{prefix}/w_z"]
    x = u @ p[f"{prefix}/w_x"]
    b = u @ p[f"{prefix}/w_b"]
    c = u @ p[f"{prefix}/w_c"]
    dt = F.softplus((u @ p[f"{prefix}/w_dt"]).float() + p[f"{prefix}/dt_bias"].float())
    return z, x, b, c, dt


def _gate_out(p, prefix, y, z, u, cfg):
    """norm(y * silu(z)) W_out, with y * silu(z) rounded to u's dtype first."""
    y = rms_norm(y * F.silu(z.float()).to(u.dtype), p[f"{prefix}/norm"], cfg.norm_eps)
    return y @ p[f"{prefix}/w_out"]


def ssm_forward(
    p: Dict[str, torch.Tensor], prefix: str, u: torch.Tensor, cfg: ModelConfig,
) -> torch.Tensor:
    """Full-sequence SSD.  u: (B, S, d) -> (B, S, d)."""
    bsz, s, _ = u.shape
    h, n = cfg.ssm_heads, cfg.ssm_state
    di = d_inner(cfg)
    pdim = di // h
    z, x, b, c, dt = _projections(p, prefix, u)
    x, _ = _causal_conv(x, p[f"{prefix}/conv_x"])
    b, _ = _causal_conv(b, p[f"{prefix}/conv_b"])
    c, _ = _causal_conv(c, p[f"{prefix}/conv_c"])

    a_heads = -torch.exp(p[f"{prefix}/a_log"].float())
    xh = x.reshape(bsz, s, h, pdim).float()
    bf, cf = b.float(), c.float()
    el = min(cfg.ssm_chunk, s)
    chunk = _ssd_chunk
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xh, bf, cf, dt, a_heads)):
        # no random op in a chunk: nothing to restore on recompute
        chunk = functools.partial(checkpoint, _ssd_chunk, use_reentrant=False,
                                  preserve_rng_state=False)
    with torch.profiler.record_function(SSD_RANGE):
        state = torch.zeros((bsz, h, pdim, n), dtype=torch.float32, device=u.device)
        ys = []
        for i in range(0, s, el):
            state, y = chunk(state, (xh[:, i:i + el], bf[:, i:i + el], cf[:, i:i + el],
                                     dt[:, i:i + el]), a_heads)
            ys.append(y)
        y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + xh * p[f"{prefix}/d_skip"].float()[:, None]
    y = y.reshape(bsz, s, di).to(u.dtype)
    return _gate_out(p, prefix, y, z, u, cfg)


def init_ssm_cache(batch: int, cfg: ModelConfig, n_layers: int = 0, dtype=torch.float32,
                   device=None) -> Dict[str, torch.Tensor]:
    h, n = cfg.ssm_heads, cfg.ssm_state
    di = d_inner(cfg)
    cw = cfg.conv_width
    lead = (n_layers,) if n_layers else ()
    return {
        "ssm_state": torch.zeros(lead + (batch, h, di // h, n), dtype=torch.float32,
                                 device=device),
        "conv_x": torch.zeros(lead + (batch, cw - 1, di), dtype=dtype, device=device),
        "conv_b": torch.zeros(lead + (batch, cw - 1, n), dtype=dtype, device=device),
        "conv_c": torch.zeros(lead + (batch, cw - 1, n), dtype=dtype, device=device),
    }


def ssm_decode(
    p: Dict[str, torch.Tensor], prefix: str, u: torch.Tensor, cfg: ModelConfig,
    cache: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token SSD step.  u (B,1,d); ``cache`` from init_ssm_cache
    (unstacked), its tensors written in place.  Returns (y, cache)."""
    bsz = u.shape[0]
    h = cfg.ssm_heads
    di = d_inner(cfg)
    pdim = di // h
    z, x, b, c, dt = _projections(p, prefix, u)
    dt = dt[:, 0]                                           # (B,H)
    x, tail_x = _causal_conv(x, p[f"{prefix}/conv_x"], cache["conv_x"])
    b, tail_b = _causal_conv(b, p[f"{prefix}/conv_b"], cache["conv_b"])
    c, tail_c = _causal_conv(c, p[f"{prefix}/conv_c"], cache["conv_c"])

    a_heads = -torch.exp(p[f"{prefix}/a_log"].float())
    xh = x.reshape(bsz, h, pdim).float()
    bv = b[:, 0].float()
    cv = c[:, 0].float()
    decay = torch.exp(dt * a_heads)                         # (B,H)
    state = cache["ssm_state"]
    state.mul_(decay[..., None, None]).add_((dt[..., None] * xh)[..., None] * bv[:, None, None])
    y = (state @ cv[:, None, :, None])[..., 0] + xh * p[f"{prefix}/d_skip"].float()[:, None]
    y = y.reshape(bsz, 1, di).to(u.dtype)
    for name, tail in (("conv_x", tail_x), ("conv_b", tail_b), ("conv_c", tail_c)):
        cache[name].copy_(tail)
    return _gate_out(p, prefix, y, z, u, cfg), cache
