"""KV caches: full, ring (sliding-window) and MLA-latent.

Twin of ``repro/models/kvcache.py``.  A cache is a flat dict of tensors plus a 0-d int32 ``pos``
on the device, so a decode step reads its position without a host sync.
The *ring* layout caps memory at ``window`` entries; keys are stored
post-RoPE (absolute positions), so a ring overwrite needs no re-rotation
and masking is by age.  An MLA cache stores the compressed latent and the
shared rotary key (kv_lora + rope dims a token) instead of per-head K/V.
"""
from __future__ import annotations

from typing import Dict

import torch


def cache_len(seq_len: int, window: int) -> int:
    """Physical cache length: the ring window if set, else the full context."""
    return min(seq_len, window) if window > 0 else seq_len


def init_gqa_cache(
    batch: int, n_kv_heads: int, seq_len: int, head_dim: int,
    window: int = 0, n_layers: int = 0, dtype=torch.bfloat16, device=None,
) -> Dict[str, torch.Tensor]:
    s = cache_len(seq_len, window)
    lead = (n_layers,) if n_layers else ()
    shape = lead + (batch, n_kv_heads, s, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def init_mla_cache(
    batch: int, seq_len: int, kv_lora: int, rope_dim: int,
    window: int = 0, n_layers: int = 0, dtype=torch.bfloat16, device=None,
) -> Dict[str, torch.Tensor]:
    s = cache_len(seq_len, window)
    lead = (n_layers,) if n_layers else ()
    return {
        "latent": torch.zeros(lead + (batch, s, kv_lora), dtype=dtype, device=device),
        "k_rope": torch.zeros(lead + (batch, s, rope_dim), dtype=dtype, device=device),
    }


def ring_slot(pos: torch.Tensor, physical_len: int) -> torch.Tensor:
    """Physical write slot for logical position ``pos``."""
    return pos % physical_len


def valid_mask(pos: torch.Tensor, physical_len: int, window: int) -> torch.Tensor:
    """(physical_len,) bool — which slots hold tokens visible at step ``pos``.

    For a full cache (window == 0) slots [0, pos] are valid.  For a ring,
    every slot written in the last ``window`` steps is valid.
    """
    slots = torch.arange(physical_len, device=pos.device)
    if window == 0:
        return slots <= pos
    written = slots <= pos  # before the first wrap some slots are empty
    age = (pos - slots) % physical_len
    return written & (age < physical_len)
