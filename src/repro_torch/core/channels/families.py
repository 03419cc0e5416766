"""Built-in scenario families: the paper's three regimes (stationary,
piecewise-stationary, adversarial) and the legacy ``random_piecewise_env``
/ ``random_adversarial_env`` shims.  Twin of the matching families of
``repro/core/channels/families.py``, equal to them in distribution (the
fading, mobility, shadowing, jamming and closed-loop families are not
ported).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.channels.base import FORM_TABLE, ChannelEnv, segment_env, table_env
from repro_torch.core.channels.process import ChannelProcess, register_scenario


def _uniform(shape, low, high, generator, device):
    return low + (high - low) * torch.rand(shape, generator=generator, device=device)


@register_scenario
@dataclasses.dataclass(frozen=True)
class StationaryProcess(ChannelProcess):
    """Fixed unknown means drawn uniformly in [mean_low, mean_high]."""

    n_channels: int
    mean_low: float = 0.1
    mean_high: float = 0.9

    FAMILY = "stationary"
    TRACED = ("mean_low", "mean_high")

    @classmethod
    def example(cls, n_channels: int, horizon: int) -> "StationaryProcess":
        return cls(n_channels=n_channels)

    def _realize(self, generator, device) -> ChannelEnv:
        mus = _uniform((self.n_channels,), self.mean_low, self.mean_high, generator, device)
        return segment_env(mus[None, :], device=device)


@register_scenario
@dataclasses.dataclass(frozen=True)
class PiecewiseProcess(ChannelProcess):
    """Piecewise-stationary means with ``n_breakpoints`` abrupt changes
    (the GLR-CUCB scenario).

    Segment means are drawn uniformly in [mean_low, mean_high] and nudged
    apart by centred per-channel offsets ``min_gap`` apart, then clipped.
    Breakpoints are evenly spread with random jitter and forced strictly
    ascending inside (0, T).
    """

    n_channels: int
    horizon: int
    n_breakpoints: int
    mean_low: float = 0.1
    mean_high: float = 0.9
    min_gap: float = 0.05

    FAMILY = "piecewise"
    TRACED = ("mean_low", "mean_high", "min_gap")

    @property
    def n_segments(self) -> int:
        return self.n_breakpoints + 1

    @classmethod
    def example(cls, n_channels: int, horizon: int) -> "PiecewiseProcess":
        return cls(n_channels=n_channels, horizon=horizon, n_breakpoints=3)

    def _realize(self, generator, device) -> ChannelEnv:
        n, horizon, nb = self.n_channels, self.horizon, self.n_breakpoints
        n_seg = nb + 1
        means = _uniform((n_seg, n), self.mean_low, self.mean_high, generator, device)
        offs = torch.arange(n, dtype=torch.float32, device=device) * self.min_gap
        means = (means + (offs - offs.mean())[None, :]).clamp(self.mean_low, self.mean_high)
        if nb > 0:
            if nb >= horizon:
                raise ValueError(f"PiecewiseProcess: {nb} breakpoints need horizon > {nb}")
            even = torch.linspace(0, horizon, n_seg + 1, dtype=torch.float64,
                                  device=device)[1:-1].to(torch.float32)
            jitter = _uniform((nb,), -0.25, 0.25, generator, device) * (horizon / n_seg)
            brk = (even + jitter).clamp(1, horizon - 1).to(torch.int64)
            i = torch.arange(nb, device=device)
            brk = torch.cummax(torch.sort(brk).values - i, dim=0).values + i
            brk = torch.maximum(torch.minimum(brk, horizon - nb + i), 1 + i)
        else:
            brk = torch.zeros((0,), dtype=torch.int64, device=device)
        return segment_env(means, brk, device=device)


@register_scenario
@dataclasses.dataclass(frozen=True)
class AdversarialProcess(ChannelProcess):
    """An 'extremely non-stationary' regime: a pre-committed Markov-flipping
    Good/Bad table.

    The (T, N) table starts from a random assignment with ``good_frac`` of
    the channels Good and flips each channel with probability ``flip_prob``
    a round: state_t = start XOR (cumulative parity of the flips up to t).
    No per-round i.i.d. structure, the regime where only adversarial-bandit
    guarantees (M-Exp3) apply, hence the ``"mean"`` matcher score hint
    (Eq. 31).
    """

    n_channels: int
    horizon: int
    flip_prob: float = 0.01
    good_frac: float = 0.5

    FAMILY = "adversarial"
    FORM = FORM_TABLE
    SCORE_KIND = "mean"
    TRACED = ("flip_prob", "good_frac")

    @classmethod
    def example(cls, n_channels: int, horizon: int) -> "AdversarialProcess":
        return cls(n_channels=n_channels, horizon=horizon)

    def _realize(self, generator, device) -> ChannelEnv:
        n = self.n_channels
        start = torch.rand((n,), generator=generator, device=device) < self.good_frac
        flips = torch.rand((self.horizon, n), generator=generator, device=device) < self.flip_prob
        parity = torch.cumsum(flips.to(torch.int32), dim=0) % 2
        table = start[None, :] ^ parity.to(torch.bool)
        return table_env(table.to(torch.float32), score_kind=self.SCORE_KIND, device=device)


# ---------------------------------------------------------------------------
# legacy random scenario generators: thin shims over the registry families
# ---------------------------------------------------------------------------

def random_piecewise_env(generator, n_channels: int, horizon: int, n_breakpoints: int,
                         mean_low: float = 0.1, mean_high: float = 0.9,
                         min_gap: float = 0.05, device=None) -> ChannelEnv:
    """``PiecewiseProcess(...).realize(generator, device)``."""
    return PiecewiseProcess(
        n_channels=n_channels, horizon=horizon, n_breakpoints=n_breakpoints,
        mean_low=mean_low, mean_high=mean_high, min_gap=min_gap,
    ).realize(generator, device)


def random_adversarial_env(generator, n_channels: int, horizon: int, flip_prob: float = 0.01,
                           good_frac: float = 0.5, device=None) -> ChannelEnv:
    """``AdversarialProcess(...).realize(generator, device)``."""
    return AdversarialProcess(
        n_channels=n_channels, horizon=horizon, flip_prob=flip_prob, good_frac=good_frac,
    ).realize(generator, device)
