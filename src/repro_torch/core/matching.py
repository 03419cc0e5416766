"""Adaptive channel matching (Sec. V): marginal utility x fairness.

After the scheduler picks which M channels to use in round t, the matcher
decides which client gets which channel:

1. rank the scheduled channels by quality score — UCB values (Eq. 30)
   under GLR-CUCB, historical means (Eq. 31) under "mean"-hint scenarios;
2. compute each client's priority coefficient (Eq. 39)

       lambda_i = (1 - beta_t) * C~_i + beta_t * a~_i(t),
       beta_t   = beta * V~_t                                (Eq. 40)

3. assign the i-th best channel to the client with the i-th highest
   priority.  Both sorts are stable, as ``jnp.argsort`` is: at round 0
   every priority is equal.

Every function also takes a batch of rows, each an independent tenant of
the scheduler service: state leaves (B,), per-client tensors (B, M),
``channels`` (B, M), scores (B, N).  Each row's result equals the
unbatched call on it.

Twin of ``repro/core/matching.py``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.aoi import aoi_variance, normalized_aoi, normalized_aoi_variance
from repro_torch.device import resolve_device


class MatcherState(NamedTuple):
    v_max: torch.Tensor    # running max of AoI variance (Eq. 36 denominator)
    a_max: torch.Tensor    # running max of AoI          (Eq. 38 denominator)
    beta_t: torch.Tensor   # last mixing weight (diagnostics)


@dataclasses.dataclass(frozen=True)
class AdaptiveMatcher:
    beta: float = 0.5      # fairness budget (Eq. 40); 0 => pure efficiency

    def init(self, device=None) -> MatcherState:
        dev = resolve_device(device)
        return MatcherState(v_max=torch.zeros((), device=dev),
                            a_max=torch.ones((), device=dev),
                            beta_t=torch.zeros((), device=dev))

    def priorities(self, state: MatcherState, contrib: torch.Tensor,
                   aoi: torch.Tensor) -> Tuple[torch.Tensor, MatcherState]:
        """lambda_i (Eq. 39) for every client + updated normalizer state."""
        v_t = aoi_variance(aoi)
        v_max = torch.maximum(state.v_max, v_t)
        a_max = torch.maximum(state.a_max, aoi.amax(dim=-1))
        v_tilde = normalized_aoi_variance(v_t, v_max)
        a_tilde = normalized_aoi(aoi, a_max)
        beta_t = self.beta * v_tilde                                    # Eq. 40
        c_norm = contrib / contrib.amax(dim=-1, keepdim=True).clamp_min(1e-12)  # scale-free mix
        b = beta_t[..., None]
        lam = (1.0 - b) * c_norm + b * a_tilde                          # Eq. 39
        return lam, MatcherState(v_max=v_max, a_max=a_max, beta_t=beta_t)

    def match(self, state: MatcherState, channels: torch.Tensor,
              channel_scores: torch.Tensor, contrib: torch.Tensor,
              aoi: torch.Tensor) -> Tuple[torch.Tensor, MatcherState]:
        """Permute ``channels`` so client i receives its priority-matched
        channel; ``assignment[i]`` is client i's channel."""
        lam, new_state = self.priorities(state, contrib, aoi)
        # best channel first, best client first
        chan_rank = torch.argsort(-channel_scores.gather(-1, channels), dim=-1, stable=True)
        client_rank = torch.argsort(-lam, dim=-1, stable=True)
        assignment = torch.empty_like(channels).scatter_(-1, client_rank,
                                                         channels.gather(-1, chan_rank))
        return assignment, new_state


def matcher_scores(scheduler, sched_state, t, env) -> torch.Tensor:
    """The (n_channels,) scores ``AdaptiveMatcher.match`` ranks channels by:
    the policy's historical means under ``"mean"``-hint scenarios, its
    native ``channel_scores`` otherwise."""
    if getattr(env, "score_kind", "ucb") == "mean":
        fn = getattr(scheduler, "mean_scores", None)
        if fn is not None:
            return fn(sched_state, t)
    return scheduler.channel_scores(sched_state, t)
