"""RG-LRU recurrent block (Griffin / RecurrentGemma — arXiv:2402.19427).

Twin of ``repro/models/rglru.py``:

    r_t = sigmoid(W_a x_t)                     recurrence gate
    i_t = sigmoid(W_i x_t)                     input gate
    a_t = exp(-c * softplus(Lambda) * r_t)     gated decay (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block wraps the LRU with a temporal conv (``ssm._causal_conv``) and a
GeLU gate branch (tanh form, as ``jax.nn.gelu``).  The gates are dense
(W, W) or block-diagonal (G, W/G, W/G) by ``lru_gate_blocks``.  Where JAX
evaluates the linear recurrence with ``lax.associative_scan``, the port
runs a log-depth doubling scan over the sequence: ceil(log2 S) steps of
``b[:, k:] += a[:, k:] * b[:, :-k]; a[:, k:] *= a[:, :-k]``, each out of
place (11 steps at S = 2048), inside the profiler range ``SCAN_RANGE``.
The products are taken in another order than JAX's tree, so the two agree
to f32 rounding, not bit for bit.  Decode is a single O(1) state update,
written in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamBuilder
from repro_torch.models.ssm import _causal_conv

_C = 8.0
SCAN_RANGE = "rglru.scan"         # the doubling scan's profiler range


def lru_width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def add_rglru_params(pb: ParamBuilder, prefix: str, cfg: ModelConfig, stacked: int = 0):
    d = cfg.d_model
    w = lru_width(cfg)
    cw = cfg.conv_width
    g = cfg.lru_gate_blocks
    lead = (stacked,) if stacked else ()
    ls = ("layers",) if stacked else ()
    pb.add(f"{prefix}/w_x", lead + (d, w), ls + ("embed", "heads"))
    pb.add(f"{prefix}/w_gate", lead + (d, w), ls + ("embed", "heads"))
    pb.add(f"{prefix}/conv", lead + (cw, w), ls + (None, "heads"), scale=0.5)
    if g > 0:
        # block-diagonal gates (Griffin Sec. 2.4): (G, W/G, W/G)
        wb = w // g
        pb.add(f"{prefix}/w_a", lead + (g, wb, wb), ls + ("heads", None, None), scale=0.02)
        pb.add(f"{prefix}/w_i", lead + (g, wb, wb), ls + ("heads", None, None), scale=0.02)
    else:
        pb.add(f"{prefix}/w_a", lead + (w, w), ls + ("heads", None), scale=0.02)
        pb.add(f"{prefix}/w_i", lead + (w, w), ls + ("heads", None), scale=0.02)
    pb.add(f"{prefix}/lam", lead + (w,), ls + (None,), init="ones")
    pb.add(f"{prefix}/w_out", lead + (w, d), ls + ("heads", "embed"))


def _gate_proj(xf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense (W,V) or block-diagonal (G, W/G, W/G) gate projection."""
    if w.dim() == xf.dim():  # (G, Wb, Wb) vs (B,S,W): block-diagonal
        b, s, _ = xf.shape
        g, wb, _ = w.shape
        xg = xf.reshape(b, s, g, wb)
        return torch.einsum("bsgw,gwv->bsgv", xg, w).reshape(b, s, g * wb)
    return xf @ w


def _gates(p, prefix, x):
    """x (B,S,W) -> (a, gated_input) both (B,S,W) f32."""
    xf = x.float()
    r = torch.sigmoid(_gate_proj(xf, p[f"{prefix}/w_a"].float()))
    i = torch.sigmoid(_gate_proj(xf, p[f"{prefix}/w_i"].float()))
    log_a = -_C * F.softplus(p[f"{prefix}/lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over dim 1 from h_{-1} = 0, by doubling:
    after the step of offset k, (a_t, b_t) compose the last 2k positions."""
    s = a.shape[1]
    k = 1
    with torch.profiler.record_function(SCAN_RANGE):
        while k < s:
            b = torch.cat([b[:, :k], torch.addcmul(b[:, k:], a[:, k:], b[:, :-k])], dim=1)
            if 2 * k < s:
                a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
            k *= 2
    return b


def _out(p, prefix, h, gate, u):
    y = h.to(u.dtype) * F.gelu(gate.float(), approximate="tanh").to(u.dtype)
    return y @ p[f"{prefix}/w_out"]


def rglru_forward(
    p: Dict[str, torch.Tensor], prefix: str, u: torch.Tensor, cfg: ModelConfig,
) -> torch.Tensor:
    """Full-sequence recurrent block.  u (B,S,d) -> (B,S,d)."""
    x = u @ p[f"{prefix}/w_x"]
    gate = u @ p[f"{prefix}/w_gate"]
    x, _ = _causal_conv(x, p[f"{prefix}/conv"])
    a, b = _gates(p, prefix, x)
    return _out(p, prefix, linear_scan(a, b), gate, u)


def init_rglru_cache(batch: int, cfg: ModelConfig, n_layers: int = 0, dtype=torch.bfloat16,
                     device=None) -> Dict[str, torch.Tensor]:
    w = lru_width(cfg)
    lead = (n_layers,) if n_layers else ()
    return {
        "h": torch.zeros(lead + (batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, w), dtype=dtype, device=device),
    }


def rglru_decode(
    p: Dict[str, torch.Tensor], prefix: str, u: torch.Tensor, cfg: ModelConfig,
    cache: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step.  u (B,1,d); ``cache`` written in place."""
    x = u @ p[f"{prefix}/w_x"]
    gate = u @ p[f"{prefix}/w_gate"]
    x, tail = _causal_conv(x, p[f"{prefix}/conv"], cache["conv"])
    a, b = _gates(p, prefix, x)
    h = cache["h"]
    h.mul_(a[:, 0]).add_(b[:, 0])                           # (B,W)
    cache["conv"].copy_(tail)
    return _out(p, prefix, h[:, None], gate, u), cache
