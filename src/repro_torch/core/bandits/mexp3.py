"""M-Exp3 (Algorithm 1): adversarial channel scheduling over super-arms.

The M clients act as one super-player and every M-subset of the N
channels is a super-arm (``combinations_array``, in the JAX package's
order).  Exp3's importance-weighted exponential update runs in log space
with re-centering; ``share_alpha > 0`` adds the Exp3.S weight-sharing
term.  Per-channel empirical statistics feed the AoI-Aware wrapper and the
Sec.-V matcher, which ranks channels by historical mean (Eq. 31).

``select`` draws the super-arm by inverting the CDF of its probabilities
at one uniform, ``u[0]``: JAX's ``choice(k_sel, C, p=p)`` is
``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - uniform(k_sel, ())))``
(side left), so ``u[0]`` stands for ``uniform(k_sel, ())``.  The CDF is a
cumulative sum in f64 rounded once to f32: the CPU's f32 ``cumsum`` adds
in f64 too (the same bits), and on CUDA an f64 sum of f32 probabilities
is exact while each is at least 2^-29 (the exploration floor gamma / C
keeps them there unless gamma < C * 2^-29), so its one rounding does not
depend on the order in which the card's 1-D and batched scans add.  The log-space
arithmetic (``logsumexp``, ``logaddexp``, ``exp``) is not bitwise between
XLA and torch.

Batched over runs (``base.py``), written explicitly: the super-arm draw
stays the inverse CDF over each row's ``u[0]``.  Twin of
``repro/core/bandits/mexp3.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.bandits.base import (
    TracedHyperParams,
    combinations_array,
    hp_tensors,
    rotate_assignment,
)
from repro_torch.device import resolve_device


class MExp3State(NamedTuple):
    log_w: torch.Tensor     # (C,) super-arm log-weights
    mu_sum: torch.Tensor    # (N,) cumulative per-channel reward (Eq. 31 numerator)
    pulls: torch.Tensor     # (N,) per-channel observation counts (D_i)
    hp: Dict[str, torch.Tensor]  # {gamma[, share_alpha]} 0-d f32


@dataclasses.dataclass(frozen=True)
class MExp3(TracedHyperParams):
    n_channels: int
    n_clients: int
    gamma: float = 0.5          # exploration rate in (0, 1]
    share_alpha: float = 0.0    # Exp3.S weight-sharing rate (0: Algorithm 1
                                # as printed, plain Exp3)
    name: str = "m-exp3"

    def __post_init__(self):
        combos = torch.from_numpy(combinations_array(self.n_channels, self.n_clients))
        object.__setattr__(self, "_combos", combos.to(torch.int64))
        object.__setattr__(self, "_combos_on", {})

    @property
    def n_super_arms(self) -> int:
        return self._combos.shape[0]

    def combos(self, device) -> torch.Tensor:
        """The (C, M) super-arm table on ``device``, copied there once."""
        dev = torch.device(device)
        if dev not in self._combos_on:
            self._combos_on[dev] = self._combos.to(dev)
        return self._combos_on[dev]

    def traced_fields(self) -> Tuple[str, ...]:
        # whether weight-sharing exists is structural (a Python branch in
        # `update`); its rate is traced once the branch is on
        return ("gamma",) + (("share_alpha",) if self.share_alpha > 0.0 else ())

    # ------------------------------------------------------------------ api
    def init(self, device=None, hp: Optional[Dict[str, Any]] = None) -> MExp3State:
        dev = resolve_device(device)
        z = torch.zeros((self.n_channels,), dtype=torch.float32, device=dev)
        return MExp3State(
            log_w=torch.zeros((self.n_super_arms,), dtype=torch.float32, device=dev),
            mu_sum=z, pulls=z.clone(),
            hp=self.params(dev) if hp is None else hp_tensors(hp, dev))

    def _probs(self, state: MExp3State) -> torch.Tensor:
        gamma = state.hp["gamma"][..., None]
        logits = state.log_w - torch.logsumexp(state.log_w, -1, keepdim=True)
        return (1.0 - gamma) * torch.exp(logits) + gamma / self.n_super_arms

    def select(self, state: MExp3State, t: int, u: torch.Tensor,
               aoi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.n_super_arms == 0:
            # M > N: C(N, M) = 0, and JAX's choice over no super-arm raises too
            raise ValueError(f"MExp3: no super-arm of {self.n_clients} channels among "
                             f"{self.n_channels} (M > N); schedule M > N with GLR-CUCB")
        cdf = torch.cumsum(self._probs(state).to(torch.float64), -1).to(torch.float32)
        idx = torch.searchsorted(cdf, cdf[..., -1:] * (1.0 - u[..., :1])).squeeze(-1)
        channels = self.combos(u.device)[idx]
        # rotate within the super-arm so no client monopolizes one channel
        return rotate_assignment(channels, t, self.n_clients), idx

    def update(self, state: MExp3State, t: int, channels: torch.Tensor,
               rewards: torch.Tensor, aux: torch.Tensor) -> MExp3State:
        idx, c, hp = aux[..., None], self.n_super_arms, state.hp
        rewards = rewards.to(torch.float32)
        p = self._probs(state)
        x_hat = rewards.sum(-1, keepdim=True) / p.gather(-1, idx).clamp_min(1e-12)  # importance-weighted
        log_w = state.log_w.scatter_add(-1, idx, hp["gamma"][..., None] * x_hat / c)
        if self.share_alpha > 0.0:
            # Exp3.S sharing: w_J <- w_J + (e * alpha / C) * sum_I w_I (log space)
            share = (torch.log(math.e * hp["share_alpha"][..., None] / c)
                     + torch.logsumexp(log_w, -1, keepdim=True))
            log_w = torch.logaddexp(log_w, share)
        log_w = log_w - log_w.amax(-1, keepdim=True)               # re-center
        return MExp3State(
            log_w=log_w,
            mu_sum=state.mu_sum.scatter_add(-1, channels, rewards),
            pulls=state.pulls.scatter_add(-1, channels, torch.ones_like(rewards)),
            hp=hp)

    def channel_scores(self, state: MExp3State, t) -> torch.Tensor:
        """Historical empirical mean per channel (Eq. 31)."""
        return state.mu_sum / state.pulls.clamp_min(1.0)

    # the native ranking already is the historical mean, so the "mean" hint
    # of `repro_torch.core.matching.matcher_scores` is the identity here
    mean_scores = channel_scores
