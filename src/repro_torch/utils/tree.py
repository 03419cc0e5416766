"""Helpers over parameter dicts (the port's pytrees).

A model's parameters are a flat ``dict`` of tensors.  Flattening follows
JAX's order for dicts, sorted keys (``b1, b2, w1, w2`` for the MLP), so a
flattened (P,) vector lines up entry for entry with the JAX package's
``tree_flatten_concat``.  Twin of ``repro/utils/tree.py``.
"""
from __future__ import annotations

from typing import Dict

import torch


def tree_flatten_concat(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Flatten a dict of tensors into one 1-D f32 vector, sorted keys."""
    return torch.cat([tree[k].reshape(-1).to(torch.float32) for k in sorted(tree)])


def tree_unflatten_concat(flat: torch.Tensor, like: Dict[str, torch.Tensor]):
    """Inverse of ``tree_flatten_concat`` given a template dict ``like``."""
    out, off = {}, 0
    for k in sorted(like):
        n = like[k].numel()
        out[k] = flat[off:off + n].reshape(like[k].shape).to(like[k].dtype)
        off += n
    return out
