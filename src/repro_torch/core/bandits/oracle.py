"""Clairvoyant oracle policy (the regret benchmark of Eq. 14).

The oracle sees the instantaneous channel states before assigning.  It
serves as many clients as there are Good channels, giving Good channels to
the most-starved (highest-AoI) clients first.  Twin of
``repro/core/bandits/oracle.py``; both sorts are stable, as ``jnp.argsort``
is, because ties are the common case here.  A leading run axis is taken
as it is (every sort over the last axis).
"""
from __future__ import annotations

import torch


def oracle_assign(states: torch.Tensor, aoi: torch.Tensor, n_clients: int):
    """Assign channels given instantaneous ``states`` (N,) (or (B, N)) in
    {0, 1} and the clients' ``aoi`` (M,) (or (B, M)).

    Returns (channels (M,), success (M,) bool), or (B, M) each: distinct
    channels per client; client i succeeds iff its channel is Good.
    """
    order = torch.argsort(-states, dim=-1, stable=True)   # Good first, low index first
    starved = torch.argsort(-aoi, dim=-1, stable=True)    # most-starved client first
    channels = torch.empty_like(starved).scatter(-1, starved, order[..., :n_clients])
    success = states.gather(-1, channels) > 0.5
    return channels, success
