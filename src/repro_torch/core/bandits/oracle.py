"""Clairvoyant oracle policy (the regret benchmark of Eq. 14).

The oracle sees the instantaneous channel states before assigning.  It
serves as many clients as there are Good channels, giving Good channels to
the most-starved (highest-AoI) clients first.  Twin of
``repro/core/bandits/oracle.py``; both sorts are stable, as ``jnp.argsort``
is, because ties are the common case here.
"""
from __future__ import annotations

import torch


def oracle_assign(states: torch.Tensor, aoi: torch.Tensor, n_clients: int):
    """Assign channels given instantaneous ``states`` (N,) in {0, 1}.

    Returns (channels (M,), success (M,) bool): distinct channels per
    client; client i succeeds iff its channel is Good.
    """
    order = torch.argsort(-states, stable=True)      # Good first, low index first
    starved = torch.argsort(-aoi, stable=True)       # most-starved client first
    channels = torch.empty((n_clients,), dtype=torch.int64, device=states.device)
    channels[starved] = order[:n_clients]
    success = states[channels] > 0.5
    return channels, success
