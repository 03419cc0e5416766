"""Channel-aware async-FL scheduling baseline (Hu et al. style).

Tracks a recency-discounted success-probability estimate ``p_hat`` per
channel (an EMA) and each round samples M distinct channels without
replacement with probability proportional to ``(1 - eps) p_hat + eps/N``,
by the Gumbel-top-M trick (one stable argsort); ``channel_scores = p_hat``
feeds the Sec.-V matcher.  Channel-aware but regret-oblivious: no
optimism, no change-point detection.

``u`` is the round's (N,) uniform, JAX's ``uniform(k_sel, (N,))``; JAX
draws ``uniform(k_sel, (N,), minval=1e-12, maxval=1.0)``, which is
``max(1e-12, u * (1 - 1e-12) + 1e-12)`` in f32, the same formula here.
Batched over runs (``base.py``), written explicitly.  Twin of
``repro/core/bandits/channel_aware.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.bandits.base import TracedHyperParams, hp_tensors, scatter_rows
from repro_torch.device import resolve_device


class ChannelAwareState(NamedTuple):
    p_hat: torch.Tensor      # (N,) EMA success-probability estimates
    hp: Dict[str, torch.Tensor]  # {ema, explore_eps} 0-d f32


@dataclasses.dataclass(frozen=True)
class ChannelAwareAsync(TracedHyperParams):
    n_channels: int
    n_clients: int
    ema: float = 0.05           # EMA step for p_hat (recency over full history)
    explore_eps: float = 0.1    # uniform mixing floor (keeps all channels live)
    name: str = "channel-aware"

    TRACED = ("ema", "explore_eps")

    # ------------------------------------------------------------------ api
    def init(self, device=None, hp: Optional[Dict[str, Any]] = None) -> ChannelAwareState:
        dev = resolve_device(device)
        # optimistic-neutral start: every channel looks 50% good until observed
        return ChannelAwareState(
            p_hat=torch.full((self.n_channels,), 0.5, dtype=torch.float32, device=dev),
            hp=self.params(dev) if hp is None else hp_tensors(hp, dev))

    def _weights(self, state: ChannelAwareState) -> torch.Tensor:
        eps = state.hp["explore_eps"][..., None]
        w = (1.0 - eps) * state.p_hat + eps / self.n_channels
        return w.clamp_min(1e-9)

    def select(self, state: ChannelAwareState, t: int, u: torch.Tensor,
               aoi: torch.Tensor) -> Tuple[torch.Tensor, None]:
        # Gumbel-top-M: M channels without replacement, probability
        # proportional to the mixed weights (Plackett-Luce)
        # JAX's minval/maxval scaling; 1 - 1e-12 is 1.0 in f32, as there
        g = -torch.log(-torch.log((u * (1.0 - 1e-12) + 1e-12).clamp_min(1e-12)))
        order = torch.argsort(-(torch.log(self._weights(state)) + g), dim=-1, stable=True)
        return order[..., : self.n_clients], None

    def update(self, state: ChannelAwareState, t: int, channels: torch.Tensor,
               rewards: torch.Tensor, aux) -> ChannelAwareState:
        sched = scatter_rows(self.n_channels, channels, 1.0)
        r_vec = scatter_rows(self.n_channels, channels, rewards)
        ema = state.hp["ema"][..., None]
        p_hat = torch.where(sched > 0.5, (1.0 - ema) * state.p_hat + ema * r_vec, state.p_hat)
        return ChannelAwareState(p_hat=p_hat, hp=state.hp)

    def channel_scores(self, state: ChannelAwareState, t) -> torch.Tensor:
        """EMA success probabilities rank channels for the Sec.-V matcher."""
        return state.p_hat
