"""Round-robin scheduling baseline (classic AoI-literature comparator).

Deterministically cycles all N channels through the M clients: perfectly
fair channel usage, zero learning.  It draws nothing: ``u`` is ignored.
Batched over runs (``base.py``), every run takes the same channels.  Twin
of ``repro/core/bandits/round_robin.py``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.bandits.base import TracedHyperParams
from repro_torch.device import resolve_device


class RRState(NamedTuple):
    mu_sum: torch.Tensor
    pulls: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RoundRobinScheduler(TracedHyperParams):
    n_channels: int
    n_clients: int
    name: str = "round-robin"

    # no tunable knobs: TRACED = () and `hp` is accepted (empty) and ignored
    def init(self, device=None, hp: Optional[dict] = None) -> RRState:
        dev = resolve_device(device)
        z = torch.zeros((self.n_channels,), dtype=torch.float32, device=dev)
        return RRState(z, z.clone())

    def select(self, state: RRState, t: int, u: torch.Tensor,
               aoi: torch.Tensor) -> Tuple[torch.Tensor, None]:
        base = (t * self.n_clients) % self.n_channels
        channels = (base + torch.arange(self.n_clients, device=state.pulls.device)) \
            % self.n_channels
        return channels.expand(*state.pulls.shape[:-1], self.n_clients), None

    def update(self, state: RRState, t: int, channels: torch.Tensor,
               rewards: torch.Tensor, aux) -> RRState:
        rewards = rewards.to(torch.float32)
        return RRState(mu_sum=state.mu_sum.scatter_add(-1, channels, rewards),
                       pulls=state.pulls.scatter_add(-1, channels, torch.ones_like(rewards)))

    def channel_scores(self, state: RRState, t) -> torch.Tensor:
        return state.mu_sum / state.pulls.clamp_min(1.0)
