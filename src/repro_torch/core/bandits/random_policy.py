"""Random scheduling baseline (the paper's comparison policy, Sec. VI-A).

``select`` takes the first M of a uniformly random permutation of the N
channels: the stable argsort of the round's (N,) uniform ``u``.  JAX draws
``permutation(k_sel, N)``, which equals the stable argsort of
``uniform(split(k_sel)[1], (N,))``; that is the draw ``u`` stands for.
Twin of ``repro/core/bandits/random_policy.py``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.bandits.base import TracedHyperParams
from repro_torch.device import resolve_device


class RandomState(NamedTuple):
    mu_sum: torch.Tensor
    pulls: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RandomScheduler(TracedHyperParams):
    n_channels: int
    n_clients: int
    name: str = "random"

    # no tunable knobs: TRACED = () and `hp` is accepted (empty) and ignored
    def init(self, device=None, hp: Optional[dict] = None) -> RandomState:
        dev = resolve_device(device)
        z = torch.zeros((self.n_channels,), dtype=torch.float32, device=dev)
        return RandomState(mu_sum=z, pulls=z.clone())

    def select(self, state: RandomState, t: int, u: torch.Tensor,
               aoi: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return torch.argsort(u, stable=True)[: self.n_clients], None

    def update(self, state: RandomState, t: int, channels: torch.Tensor,
               rewards: torch.Tensor, aux) -> RandomState:
        return RandomState(
            mu_sum=state.mu_sum.index_add(0, channels, rewards.to(torch.float32)),
            pulls=state.pulls.index_add(0, channels, torch.ones_like(rewards, dtype=torch.float32)),
        )

    def channel_scores(self, state: RandomState, t) -> torch.Tensor:
        return state.mu_sum / state.pulls.clamp_min(1.0)
