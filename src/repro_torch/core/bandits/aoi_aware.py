"""AoI-Aware (AA) scheduling wrapper (Sec. IV, last paragraph; Sec. VI-B).

Wraps any base scheduler.  Each round it computes the threshold
``h(t) = threshold_scale / max_k mu_hat_k(t)`` from its own
recency-discounted means; if any client's AoI exceeds it, the M channels
with the highest means are scheduled, best channels to the most-starved
clients; otherwise the base policy's choice stands.  The base state is
updated in both branches.  ``exploit_rounds`` counts the AA-branch rounds.

The wrapper draws nothing of its own: it hands the round's ``u`` to its
base, as JAX hands ``k_sel`` to the base.  Batched over runs
(``base.py``), written explicitly, its round nests its base's batched
round.  Twin of ``repro/core/bandits/aoi_aware.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.bandits.base import (
    TracedHyperParams,
    hp_tensors,
    init_with_hp,
    scatter_rows,
)
from repro_torch.device import resolve_device


class AoIAwareState(NamedTuple):
    base: Any                    # the wrapped scheduler's state
    mu_sum: torch.Tensor         # (N,) discounted reward sums (the wrapper's
    pulls: torch.Tensor          # (N,) discounted pull counts  own bookkeeping)
    exploit_rounds: torch.Tensor  # () int32: AA-branch firings
    hp: Dict[str, torch.Tensor]  # {threshold_scale, discount} 0-d f32


@dataclasses.dataclass(frozen=True)
class AoIAware(TracedHyperParams):
    base: Any                      # the wrapped scheduler
    threshold_scale: float = 1.0   # h(t) = scale / max mu_hat
    discount: float = 0.9          # recency discount of the historical means

    TRACED = ("threshold_scale", "discount")

    def params(self, device=None) -> Dict[str, Any]:
        """Wrapper knobs plus the wrapped policy's params nested under "base"."""
        hp = super().params(device)
        if hasattr(self.base, "params"):
            hp["base"] = self.base.params(device)
        return hp

    @property
    def n_channels(self) -> int:
        return self.base.n_channels

    @property
    def n_clients(self) -> int:
        return self.base.n_clients

    @property
    def name(self) -> str:
        return f"aa-{self.base.name}"

    # ------------------------------------------------------------------ api
    def init(self, device=None, hp: Optional[Dict[str, Any]] = None) -> AoIAwareState:
        dev = resolve_device(device)
        hp = self.params(dev) if hp is None else hp_tensors(hp, dev)
        z = torch.zeros((self.n_channels,), dtype=torch.float32, device=dev)
        return AoIAwareState(
            base=init_with_hp(self.base, dev, hp.pop("base", None)),
            mu_sum=z, pulls=z.clone(),
            exploit_rounds=torch.zeros((), dtype=torch.int32, device=dev),
            hp=hp)

    def _mu_hat(self, state: AoIAwareState) -> torch.Tensor:
        return state.mu_sum / state.pulls.clamp_min(1.0)

    def select(self, state: AoIAwareState, t: int, u: torch.Tensor,
               aoi: torch.Tensor) -> Tuple[torch.Tensor, Tuple[Any, torch.Tensor]]:
        m = self.n_clients
        mu_hat = self._mu_hat(state)
        h_t = state.hp["threshold_scale"] / mu_hat.amax(-1).clamp_min(1e-6)
        exploit = aoi.amax(-1) > h_t
        base_channels, base_aux = self.base.select(state.base, t, u, aoi)
        # exploitation: the M best (discounted) channels, best to the
        # most-starved client; a scatter with unique indices
        best = torch.argsort(-mu_hat, dim=-1, stable=True)[..., :m]
        starved = torch.argsort(-aoi, dim=-1, stable=True)
        exploit_channels = torch.zeros_like(base_channels).scatter(
            -1, starved, best.to(base_channels.dtype))
        channels = torch.where(exploit[..., None], exploit_channels, base_channels)
        return channels, (base_aux, exploit)

    def update(self, state: AoIAwareState, t: int, channels: torch.Tensor,
               rewards: torch.Tensor, aux: Tuple[Any, torch.Tensor]) -> AoIAwareState:
        base_aux, exploited = aux
        # the base learns from every round, whichever branch chose
        new_base = self.base.update(state.base, t, channels, rewards, base_aux)
        rho = state.hp["discount"][..., None]
        return AoIAwareState(
            base=new_base,
            mu_sum=rho * state.mu_sum + scatter_rows(self.n_channels, channels, rewards),
            pulls=rho * state.pulls + scatter_rows(self.n_channels, channels, 1.0),
            exploit_rounds=state.exploit_rounds + exploited.to(torch.int32),
            hp=state.hp)

    def channel_scores(self, state: AoIAwareState, t) -> torch.Tensor:
        return self.base.channel_scores(state.base, t)

    def mean_scores(self, state: AoIAwareState, t) -> torch.Tensor:
        fn = getattr(self.base, "mean_scores", None)
        if fn is not None:
            return fn(state.base, t)
        return self.base.channel_scores(state.base, t)
