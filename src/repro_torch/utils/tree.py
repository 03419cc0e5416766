"""Helpers over parameter dicts (the port's pytrees).

A model's parameters are a flat ``dict`` of tensors; a scheduler's state
is a ``NamedTuple`` of tensors and dicts (``tree_map``).  Flattening follows
JAX's order for dicts, sorted keys (``b1, b2, w1, w2`` for the MLP), so a
flattened (P,) vector lines up entry for entry with the JAX package's
``tree_flatten_concat``.  With a leading run axis (``batch_dims=1``) the
leaves are (B, ...) and the vector (B, P), one row a run.  Twin of
``repro/utils/tree.py``.
"""
from __future__ import annotations

from typing import Dict

import torch


def tree_map(fn, *trees):
    """``fn`` over the leaves of equal structures of NamedTuples, tuples and
    dicts (a scheduler state, a result dict); ``None`` stays ``None``."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[tree_map(fn, *xs) for xs in zip(*trees)])
    if isinstance(first, tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(first, dict):
        return {k: tree_map(fn, *[t[k] for t in trees]) for k in first}
    return fn(*trees)


def tree_flatten_concat(tree: Dict[str, torch.Tensor], batch_dims: int = 0) -> torch.Tensor:
    """Flatten a dict of tensors into one f32 vector, sorted keys: (P,), or
    (B, P) for leaves with ``batch_dims=1`` leading run axis (B, ...)."""
    return torch.cat([tree[k].reshape(tree[k].shape[:batch_dims] + (-1,)).to(torch.float32)
                      for k in sorted(tree)], dim=-1)


def tree_unflatten_concat(flat: torch.Tensor, like: Dict[str, torch.Tensor],
                          batch_dims: int = 0):
    """Inverse of ``tree_flatten_concat`` given a template dict ``like``
    (with ``batch_dims`` leading run axes on ``flat`` and on every leaf)."""
    out, off = {}, 0
    lead = flat.shape[:batch_dims]
    for k in sorted(like):
        shape = like[k].shape[batch_dims:]
        n = shape.numel()
        out[k] = flat[..., off:off + n].reshape(lead + shape).to(like[k].dtype)
        off += n
    return out
