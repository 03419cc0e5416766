"""Mixture-of-Experts FFN (deepseek-v2: 2 shared + 160 routed top-6;
dbrx: 16 routed top-4).

Twin of ``repro/models/moe.py``.  Dispatch is sort-based with a static
capacity, as in the JAX package:

1. router scores -> top-k expert ids + normalized weights per token;
2. flatten each row's (token, k) assignments and sort them by expert id
   (stable: within an expert, tokens keep their order);
3. scatter tokens into a (B, E, C, d) buffer (C = capacity per expert a
   row; a token past its expert's capacity is dropped, GShard's rule); in
   the backward pass a token's k gradient rows are added in ascending
   expert id (``_TokenRows``), so the gradients repeat bit for bit on the
   card;
4. one batched product per FFN matrix: (B, E, C, d) x (E, d, f);
5. gather the results back to token order and combine them with the
   router weights in f32, each token's experts added in ascending id (the
   order of JAX's scatter-add; a fixed order on the card too).

The JAX package dispatches one row under ``vmap``; here every step runs on
all rows at once (per-row offsets into flat buffers), with the same
capacity per row.  Two of JAX's orders are kept exactly: ``lax.top_k``
puts the lower expert id first on a tie (here a stable descending sort,
since ``torch.topk`` fixes no order among ties), and ``jnp.argsort`` is
stable (here ``stable=True``).  A Switch-style load-balance loss (mean
router probability x token fraction per expert) is returned for the
trainer.  JAX's ``constrain`` has no twin: on one card it is the identity.
The steps run inside ``record_function`` ranges named by ``DISPATCH_RANGE``,
``EXPERTS_RANGE`` and ``COMBINE_RANGE``, so a trace can give each one's
device time.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamBuilder, swiglu

DISPATCH_RANGE = "moe.dispatch (top-k sort, expert sort, scatter)"
EXPERTS_RANGE = "moe.experts (batched products)"
COMBINE_RANGE = "moe.combine (gather, f32 scatter-add)"


def add_moe_params(pb: ParamBuilder, prefix: str, cfg: ModelConfig, stacked: int = 0):
    d, e = cfg.d_model, cfg.n_experts
    fe = cfg.d_expert or cfg.d_ff
    lead = (stacked,) if stacked else ()
    ls = ("layers",) if stacked else ()
    pb.add(f"{prefix}/router", lead + (d, e), ls + ("embed", None), scale=0.02)
    pb.add(f"{prefix}/w_gate", lead + (e, d, fe), ls + ("expert", "embed", None))
    pb.add(f"{prefix}/w_up", lead + (e, d, fe), ls + ("expert", "embed", None))
    pb.add(f"{prefix}/w_down", lead + (e, fe, d), ls + ("expert", None, "embed"))
    if cfg.n_shared_experts:
        fs = fe * cfg.n_shared_experts
        pb.add(f"{prefix}/ws_gate", lead + (d, fs), ls + ("embed", "heads"))
        pb.add(f"{prefix}/ws_up", lead + (d, fs), ls + ("embed", "heads"))
        pb.add(f"{prefix}/ws_down", lead + (fs, d), ls + ("heads", "embed"))


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert has in a row of ``tokens`` tokens."""
    return max(int(tokens * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts), 1)


def route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the router probabilities (..., E) -> (weights renormalized
    to sum 1, expert ids), both (..., k).  Ties go to the lower expert id,
    as ``jax.lax.top_k`` orders them: a stable descending sort."""
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :k], topi[..., :k]
    return topw / topw.sum(-1, keepdim=True).clamp_min(1e-9), topi


def dispatch(topi: torch.Tensor, topw: torch.Tensor, e: int, cap: int):
    """Sort-based dispatch plan for every row.  topi/topw (B, T, k).

    Returns (order, slot, keep_w), each (B, T*k) in expert order: the flat
    index (token * k + j) of each assignment (its token is ``order // k``),
    its slot in the row's flat (E*C + 1) buffer (``E*C``, one past the
    last, for a dropped assignment) and its router weight (0 where
    dropped)."""
    b, t, k = topi.shape
    flat_e = topi.reshape(b, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_sorted = flat_e.gather(-1, order)
    w_sorted = topw.reshape(b, t * k).gather(-1, order)
    experts = torch.arange(e, device=topi.device).expand(b, e).contiguous()
    group_start = torch.searchsorted(e_sorted, experts)       # (B, E)
    pos_in_e = torch.arange(t * k, device=topi.device) - group_start.gather(-1, e_sorted)
    keep = pos_in_e < cap                                     # the capacity drop
    slot = torch.where(keep, e_sorted * cap + pos_in_e, e * cap)   # the sentinel slot
    return order, slot, torch.where(keep, w_sorted, 0.0)


def _row_offsets(idx: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, n) per-row indices as indices into the rows' flat concatenation."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None] * stride
    return (idx + rows).reshape(-1)


class _TokenRows(torch.autograd.Function):
    """``x.index_select(0, tok)``: each token's row once for each of its k
    assignments.  The backward adds a token's k gradient rows from zero in
    ascending expert id (``pos`` (tokens, k): where they lie), the order of
    JAX's scatter-add and of ``index_add`` on the CPU; ``index_select``'s own
    backward, an ``index_add``, adds them with atomics on the card, in no
    fixed order."""

    @staticmethod
    def forward(ctx, x, tok, pos):
        ctx.save_for_backward(pos)
        return x.index_select(0, tok)

    @staticmethod
    def backward(ctx, grad):
        (pos,) = ctx.saved_tensors
        terms = grad.index_select(0, pos.reshape(-1)).reshape(*pos.shape, grad.shape[-1])
        out = torch.zeros_like(terms[:, 0])
        for j in range(pos.shape[1]):
            out = out + terms[:, j]
        return out, None, None


def moe_ffn(
    p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss 0-d f32).  Capacity is per
    row of S tokens."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = capacity(cfg, s)

    logits = (x @ p[f"{prefix}/router"]).float()
    probs = torch.softmax(logits, dim=-1)

    # ---- sort-based dispatch, all rows at once ------------------------------
    with torch.profiler.record_function(DISPATCH_RANGE):
        topw, topi = route(probs, k)                           # (B, S, k)
        order, slot, keep_w = dispatch(topi, topw, e, cap)
        tok = _row_offsets(torch.div(order, k, rounding_mode="floor"), s)
        # where each token's k rows lie in expert order, ascending expert id
        pos = torch.empty_like(order).scatter_(
            -1, order, torch.arange(s * k, device=x.device).expand(b, s * k))
        pos = _row_offsets(pos.reshape(b, s, k).sort(dim=-1).values.reshape(b, s * k), s * k)
        rows = _TokenRows.apply(x.reshape(b * s, d), tok, pos.reshape(b * s, k))
        buf = x.new_zeros((b * (e * cap + 1), d)).index_copy(
            0, _row_offsets(slot, e * cap + 1), rows)
        buf = buf.reshape(b, e * cap + 1, d)[:, :-1].reshape(b, e, cap, d)

    # ---- load-balance aux loss (Switch-style) -----------------------------
    me = probs.mean(dim=(0, 1))                                # mean router prob
    hits = F.one_hot(topi, e).sum(dim=2).float().mean(dim=(0, 1)) / k
    aux = torch.sum(me * hits) * e

    # ---- expert FFN (batched over batch x expert) -----------------------------
    with torch.profiler.record_function(EXPERTS_RANGE):
        g = torch.einsum("becd,edf->becf", buf, p[f"{prefix}/w_gate"])
        u = torch.einsum("becd,edf->becf", buf, p[f"{prefix}/w_up"])
        h = F.silu(g.float()).to(x.dtype) * u
        y_flat = torch.einsum("becf,efd->becd", h, p[f"{prefix}/w_down"]).reshape(-1, d)

    # ---- combine back in token order (f32) ----------------------------------
    # JAX scatter-adds the weighted rows in expert order, so a token sums its
    # experts from the lowest id up.  Here each token gathers its k rows in
    # that order and adds them in turn: the same sums, in a fixed order on
    # every device (an index_add on the card adds with atomics, in no fixed
    # order).
    with torch.profiler.record_function(COMBINE_RANGE):
        def by_token(v):                                       # expert order -> (B, S, k)
            return v.new_empty(v.shape).scatter(-1, order, v).reshape(b, s, k)

        by_e = topi.argsort(dim=-1)                            # a token's experts, ascending
        slot_tk = by_token(slot).gather(-1, by_e).clamp_max(e * cap - 1)
        picked = y_flat.index_select(0, _row_offsets(slot_tk.reshape(b, s * k), e * cap))
        terms = by_token(keep_w).gather(-1, by_e)[..., None] * picked.reshape(b, s, k, d).float()
        out = terms[:, :, 0]
        for j in range(1, k):
            out = out + terms[:, :, j]
        out = out.to(x.dtype)

    # ---- shared experts (always-on path) ---------------------------------------
    if cfg.n_shared_experts:
        out = out + swiglu(x, p[f"{prefix}/ws_gate"], p[f"{prefix}/ws_up"],
                           p[f"{prefix}/ws_down"])
    return out, aux
