"""Shared primitives: parameter registry, norms, RoPE, MLPs.

Twin of ``repro/models/layers.py``.  Parameters live in a *flat* dict keyed
by '/'-joined paths, with a parallel dict of logical axis names per path
(kept for parity with the JAX layout; one card shards nothing).  The
JAX package's activation constraints (``act_sharding.constrain``) have no
twin: without a mesh they are the identity there too.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``) as a ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; one of {sorted(_DTYPES)}")
    return _DTYPES[name]


class ParamBuilder:
    """Accumulates (flat-path -> tensor) params and (flat-path -> logical spec).

    Draws come from ``generator`` on ``device`` (the generator's own
    device), with the JAX package's init kinds: ``normal`` (std
    1/sqrt(fan_in), fan_in = shape[-2], or shape[-1] for a vector),
    ``embed`` (std 0.02), ``uniform`` in [-scale, scale], ``ones``,
    ``zeros``.  The values equal JAX's in distribution only.  A draw fills
    the tensor in its own dtype (no f32 copy of a 33 GB stacked matrix).
    ``meta=True`` records meta tensors (shape and dtype, no storage).
    """

    def __init__(self, generator: Optional[torch.Generator], dtype=torch.bfloat16,
                 meta: bool = False, device=None):
        self.generator = generator
        self.dtype = dtype
        self.meta = meta
        self.device = torch.device("meta") if meta else torch.device(device)
        if not meta and (generator is None or generator.device.type != self.device.type):
            raise ValueError(
                f"ParamBuilder: needs a torch.Generator on {self.device}, got "
                f"{None if generator is None else generator.device}")
        self.params: Dict[str, torch.Tensor] = {}
        self.specs: Dict[str, Tuple[Optional[str], ...]] = {}

    def add(
        self,
        path: str,
        shape: Sequence[int],
        spec: Tuple[Optional[str], ...],
        init: str = "normal",
        scale: Optional[float] = None,
        dtype=None,
    ) -> None:
        assert path not in self.params, f"duplicate param {path}"
        assert len(spec) == len(shape), f"{path}: spec {spec} vs shape {shape}"
        val = torch.empty(tuple(shape), dtype=dtype or self.dtype, device=self.device)
        if not self.meta:
            gen = self.generator
            if init == "zeros":
                val.zero_()
            elif init == "ones":
                val.fill_(1.0)
            elif init == "normal":
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
                val.normal_(0.0, std, generator=gen)
            elif init == "embed":
                val.normal_(0.0, scale if scale is not None else 0.02, generator=gen)
            elif init == "uniform":
                lim = scale if scale is not None else 1.0
                val.uniform_(-lim, lim, generator=gen)
            else:
                raise ValueError(init)
        self.params[path] = val
        self.specs[path] = tuple(spec)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * gamma.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in f32 (the population variance), returned in x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the (even) rotary dims — (head_dim // 2,)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, D_rot) with positions (..., S) or (S,).  Pairs (2i, 2i+1),
    angles in f32."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * inv            # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU FFN: down( silu(x @ gate) * (x @ up) )."""
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g.float()).to(x.dtype) * u) @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    """Plain 2-layer GELU MLP (tanh approximation, as ``jax.nn.gelu``)."""
    h = x @ w_in + b_in
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ w_out + b_out


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def add_mlp_params(pb: ParamBuilder, prefix: str, d_model: int, d_ff: int,
                   act: str, stacked: int = 0):
    lead = (stacked,) if stacked else ()
    lspec = ("layers",) if stacked else ()
    if act == "silu":
        pb.add(f"{prefix}/w_gate", lead + (d_model, d_ff), lspec + ("embed", "heads"))
        pb.add(f"{prefix}/w_up", lead + (d_model, d_ff), lspec + ("embed", "heads"))
        pb.add(f"{prefix}/w_down", lead + (d_ff, d_model), lspec + ("heads", "embed"))
    else:
        pb.add(f"{prefix}/w_in", lead + (d_model, d_ff), lspec + ("embed", "heads"))
        pb.add(f"{prefix}/b_in", lead + (d_ff,), lspec + ("heads",), init="zeros")
        pb.add(f"{prefix}/w_out", lead + (d_ff, d_model), lspec + ("heads", "embed"))
        pb.add(f"{prefix}/b_out", lead + (d_model,), lspec + (None,), init="zeros")


def apply_mlp(p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, act: str):
    if act == "silu":
        return swiglu(x, p[f"{prefix}/w_gate"], p[f"{prefix}/w_up"], p[f"{prefix}/w_down"])
    return gelu_mlp(
        x, p[f"{prefix}/w_in"], p[f"{prefix}/b_in"], p[f"{prefix}/w_out"], p[f"{prefix}/b_out"]
    )
