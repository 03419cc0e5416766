"""Block composition and the loop over stacked layers.

Twin of ``repro/models/transformer.py``: a *block* is (pre-norm -> mixer
-> residual -> pre-norm -> FFN -> residual), where the mixer is GQA / MLA
attention, an SSD (mamba-2) scan or an RG-LRU recurrence, and the FFN a
dense MLP or a routed MoE; a mamba block returns after its mixer, with no
second norm and no FFN, as in the reference architecture.  Per-layer
parameters keep the JAX layout, stacked along a leading ``layers`` axis
under ``blocks/b/...``; where JAX scans over that axis, the port loops
over it in Python (a layer's parameters are views).  ``remat`` is the
training path's activation-checkpoint policy around each block
(``torch.utils.checkpoint``, non-reentrant): ``"none"``, ``"full"`` (keep
the block's input, recompute the rest in the backward pass) or ``"dots"``
(also keep the outputs of the products with no batch dimension, the twin
of ``dots_with_no_batch_dims_saveable``).  It acts only where a gradient
is taken; serving runs the blocks as they are.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import ParamBuilder, add_mlp_params, apply_mlp, rms_norm


def _ffn_is_moe(cfg: ModelConfig, layer_idx: int) -> bool:
    return bool(cfg.n_experts) and layer_idx >= cfg.first_k_dense


def add_block_params(
    pb: ParamBuilder, prefix: str, cfg: ModelConfig, kind: str,
    moe_ffn: bool, stacked: int = 0,
):
    d = cfg.d_model
    lead = (stacked,) if stacked else ()
    ls = ("layers",) if stacked else ()
    pb.add(f"{prefix}/norm1", lead + (d,), ls + (None,), init="ones")
    if kind == "attn":
        if cfg.attention == "mla":
            attn.add_mla_params(pb, f"{prefix}/attn", cfg, stacked)
        else:
            attn.add_gqa_params(pb, f"{prefix}/attn", cfg, stacked)
    elif kind == "ssm":
        ssm_mod.add_ssm_params(pb, f"{prefix}/ssm", cfg, stacked)
        return  # mamba blocks: no separate FFN
    elif kind == "rglru":
        rglru_mod.add_rglru_params(pb, f"{prefix}/rglru", cfg, stacked)
    else:
        raise ValueError(kind)
    pb.add(f"{prefix}/norm2", lead + (d,), ls + (None,), init="ones")
    if moe_ffn:
        moe_mod.add_moe_params(pb, f"{prefix}/moe", cfg, stacked)
    else:
        add_mlp_params(pb, f"{prefix}/mlp", d, cfg.d_ff, cfg.mlp_act, stacked)


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _ffn(p, prefix, x, cfg, moe_ffn):
    """The second half of a block: pre-norm -> MLP or MoE.  Returns (h,
    moe_aux), the aux None for an MLP (decode makes no tensor for it)."""
    h = rms_norm(x, p[f"{prefix}/norm2"], cfg.norm_eps)
    if moe_ffn:
        return moe_mod.moe_ffn(p, f"{prefix}/moe", h, cfg)
    return apply_mlp(p, f"{prefix}/mlp", h, cfg.mlp_act), None


def block_forward(
    p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, cfg: ModelConfig,
    kind: str, moe_ffn: bool, window: int = 0, attn_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block.  Returns (x, moe_aux_loss)."""
    h = rms_norm(x, p[f"{prefix}/norm1"], cfg.norm_eps)
    if kind == "attn":
        prefill = attn.mla_prefill if cfg.attention == "mla" else attn.gqa_prefill
        h = prefill(p, f"{prefix}/attn", h, cfg, window=window, attn_impl=attn_impl)
    elif kind == "ssm":
        return x + ssm_mod.ssm_forward(p, f"{prefix}/ssm", h, cfg), _no_aux(x)
    elif kind == "rglru":
        h = rglru_mod.rglru_forward(p, f"{prefix}/rglru", h, cfg)
    else:
        raise ValueError(kind)
    x = x + h
    h, aux = _ffn(p, prefix, x, cfg, moe_ffn)
    return x + h, _no_aux(x) if aux is None else aux


def block_decode(
    p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, cfg: ModelConfig,
    kind: str, moe_ffn: bool, cache: Dict[str, torch.Tensor], pos: torch.Tensor,
    window: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token block step.  ``cache`` is this block's (unstacked) cache
    dict, updated in place."""
    h = rms_norm(x, p[f"{prefix}/norm1"], cfg.norm_eps)
    if kind == "attn":
        if cfg.attention == "mla":
            h, lat, kr = attn.mla_decode(
                p, f"{prefix}/attn", h, cfg, cache["latent"], cache["k_rope"], pos,
                window=window)
            new_cache = {"latent": lat, "k_rope": kr}
        else:
            h, ck, cv = attn.gqa_decode(
                p, f"{prefix}/attn", h, cfg, cache["k"], cache["v"], pos, window=window)
            new_cache = {"k": ck, "v": cv}
    elif kind == "ssm":
        h, new_cache = ssm_mod.ssm_decode(p, f"{prefix}/ssm", h, cfg, cache)
        return x + h, new_cache
    elif kind == "rglru":
        h, new_cache = rglru_mod.rglru_decode(p, f"{prefix}/rglru", h, cfg, cache)
    else:
        raise ValueError(kind)
    x = x + h
    h, _ = _ffn(p, prefix, x, cfg, moe_ffn)
    return x + h, new_cache


# ---------------------------------------------------------------------------
# stacking
# ---------------------------------------------------------------------------

def _slice_tree(tree: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in tree.items()}


def _depth(stacked: Dict[str, torch.Tensor]) -> int:
    return next(iter(stacked.values())).shape[0]


REMAT_POLICIES = ("none", "full", "dots")
# the products with no batch dimension: a projection ``x @ W`` reaches autograd as an mm
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat: unknown policy {policy!r}; one of {REMAT_POLICIES}")
    if policy == "none":
        return fn
    extra = {}
    if policy == "dots":
        extra["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                _dots_policy)
    # no random op in a block: nothing to restore on recompute
    return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
                             **extra)


def _takes_grad(stacked: Dict[str, torch.Tensor], x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(v.requires_grad for v in stacked.values()))


def scanned_forward(
    stacked: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
    kind: str, moe_ffn: bool, window: int = 0, remat: str = "full",
    attn_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a homogeneous block stack; ``stacked`` values have a leading L dim.

    ``remat`` checkpoints each block when a gradient is taken."""
    def body(layer_params, y):
        return block_forward(layer_params, "b", y, cfg, kind, moe_ffn, window, attn_impl)

    if _takes_grad(stacked, x):
        body = _remat(body, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(_depth(stacked)):
        x, a = body(_slice_tree(stacked, i), x)
        aux = aux + a
    return x, aux


def scanned_decode(
    stacked: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
    kind: str, moe_ffn: bool, cache: Dict[str, torch.Tensor], pos: torch.Tensor,
    window: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode through a stack; cache values also carry a leading L dim and
    are updated in place (each layer writes one slot of its view)."""
    for i in range(_depth(stacked)):
        x, _ = block_decode(_slice_tree(stacked, i), "b", x, cfg, kind, moe_ffn,
                            _slice_tree(cache, i), pos, window)
    return x, cache
