"""Lyapunov drift-plus-penalty scheduling baseline (Perazzone et al. style).

A virtual queue per channel encodes a time-average scheduling-rate
constraint, ``Q_k <- max(Q_k + min_rate - 1{k scheduled}, 0)``, with
``min_rate`` defaulting to ``rate_slack * M/N``; each round the M channels
with the largest ``Q_k + V * mu_hat_k`` are scheduled (``mu_hat`` a
recency-discounted empirical success mean) and rotated across clients.
A detection-free baseline: it reacts to change points only through queue
pressure and the discounted mean.

``u`` is the round's (N,) uniform, JAX's ``uniform(k_sel, (N,))``; it
breaks early-round ties as ``u * 1e-6``.  Batched over runs (``base.py``),
written explicitly.  Twin of ``repro/core/bandits/lyapunov.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.bandits.base import (
    TracedHyperParams,
    hp_tensors,
    rotate_assignment,
    scatter_rows,
)
from repro_torch.device import resolve_device


class LyapunovState(NamedTuple):
    queues: torch.Tensor     # (N,) virtual queues Q_k (fairness backlog)
    mu_sum: torch.Tensor     # (N,) discounted reward sums
    pulls: torch.Tensor      # (N,) discounted pull counts
    hp: Dict[str, torch.Tensor]  # {v, discount, min_rate | rate_slack} 0-d f32


@dataclasses.dataclass(frozen=True)
class LyapunovSched(TracedHyperParams):
    n_channels: int
    n_clients: int
    v: float = 4.0                    # drift-vs-penalty weight (higher = greedier)
    min_rate: Optional[float] = None  # target scheduling rate; None = slack * M/N
    rate_slack: float = 0.5           # fraction of the fair share guaranteed
    discount: float = 0.98            # recency discount on the empirical means
    name: str = "lyapunov"

    def traced_fields(self) -> Tuple[str, ...]:
        # which arrival parameterization is active is structural; the chosen
        # knob's value is traced
        rate = ("min_rate",) if self.min_rate is not None else ("rate_slack",)
        return ("v", "discount") + rate

    def _arrival(self, hp: Dict[str, torch.Tensor]) -> torch.Tensor:
        if "min_rate" in hp:
            return hp["min_rate"][..., None]
        return hp["rate_slack"][..., None] * (self.n_clients / self.n_channels)

    # ------------------------------------------------------------------ api
    def init(self, device=None, hp: Optional[Dict[str, Any]] = None) -> LyapunovState:
        dev = resolve_device(device)
        z = torch.zeros((self.n_channels,), dtype=torch.float32, device=dev)
        return LyapunovState(queues=z, mu_sum=z.clone(), pulls=z.clone(),
                             hp=self.params(dev) if hp is None else hp_tensors(hp, dev))

    def _mu_hat(self, state: LyapunovState) -> torch.Tensor:
        return state.mu_sum / state.pulls.clamp_min(1.0)

    def select(self, state: LyapunovState, t: int, u: torch.Tensor,
               aoi: torch.Tensor) -> Tuple[torch.Tensor, None]:
        m = self.n_clients
        weight = state.queues + state.hp["v"][..., None] * self._mu_hat(state)
        top = torch.argsort(-(weight + u * 1e-6), dim=-1, stable=True)[..., :m]
        return rotate_assignment(top, t, m), None

    def update(self, state: LyapunovState, t: int, channels: torch.Tensor,
               rewards: torch.Tensor, aux) -> LyapunovState:
        sched = scatter_rows(self.n_channels, channels, 1.0)
        r_vec = scatter_rows(self.n_channels, channels, rewards)
        queues = (state.queues + self._arrival(state.hp) - sched).clamp_min(0.0)
        rho = state.hp["discount"][..., None]
        return LyapunovState(queues=queues, mu_sum=rho * state.mu_sum + r_vec,
                             pulls=rho * state.pulls + sched, hp=state.hp)

    def channel_scores(self, state: LyapunovState, t) -> torch.Tensor:
        """Discounted empirical means rank channels for the Sec.-V matcher."""
        return self._mu_hat(state)
