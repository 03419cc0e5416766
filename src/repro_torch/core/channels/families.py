"""Built-in scenario families.  Twin of ``repro/core/channels/families.py``,
every family registered under its JAX name with its knobs and defaults,
equal to it in distribution:

  stationary       fixed unknown means                         (segments)
  piecewise        abrupt mean changes at hidden breakpoints   (segments)
  adversarial      pre-committed Markov-flip Good/Bad table    (table, "mean")
  gilbert_elliott  two-state Markov fading per channel         (table)
  mobility         smooth sinusoidal mean drift (user motion)  (table)
  shadowing        SNR-threshold shadowing, AR(1) log-normal   (table)
  jamming          bursty jammer overlay on ANY open-loop base (table)
  reactive_jammer  closed-loop follower jammer on a base       (reactive)
  congestion       closed-loop self-interference / cell load   (reactive)

The six after the paper's three realize in two steps, ``_draws`` (every
random draw, named after the JAX realizer's) and ``_from_draws`` (the
deterministic rest): fed the JAX package's own draws, the second step
gives JAX's env (bit for bit where no transcendental function intervenes).
The two-state Markov chains (Gilbert-Elliott fading, the jammer's on/off
bursts) run without a loop over the rounds (``_markov_chain``); the AR(1)
shadowing process is a loop of T rounds of (N,) ops.  The overlays
(jamming, reactive jammer) realize their base scenario from the same
generator and expand it with ``dense_means``; a reactive base is refused.

The legacy ``random_piecewise_env`` / ``random_adversarial_env``
generators are thin shims over the matching families.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.channels.base import (
    FORM_REACTIVE,
    FORM_TABLE,
    ChannelEnv,
    dense_means,
    reactive_env,
    segment_env,
    table_env,
)
from repro_torch.core.channels.process import ChannelProcess, register_scenario


def _uniform(shape, low, high, generator, device):
    return low + (high - low) * torch.rand(shape, generator=generator, device=device)


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _scaled(u, low, high):
    """``u`` in [0, 1) moved to [low, high) as ``jax.random.uniform`` moves
    its floats: ``max(low, u * (high - low) + low)``, in f32."""
    lo, hi = _f32(low, u.device), _f32(high, u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def _ndtr(x: torch.Tensor) -> torch.Tensor:
    """The standard normal CDF as the JAX package's ``norm.cdf`` (``ndtr``)
    computes it: ``erf`` near 0, ``erfc`` in the tails (``torch.special.ndtr``
    takes ``1 + erf`` everywhere and loses the lower tail: 0 at -6 in f32)."""
    half_sqrt_2 = 0.5 * math.sqrt(2.0)
    w = x * half_sqrt_2
    z = w.abs()
    tail = torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z))
    return 0.5 * torch.where(z < half_sqrt_2, 1.0 + torch.erf(w), tail)


def _markov_chain(start: torch.Tensor, u: torch.Tensor, p_leave, p_enter) -> torch.Tensor:
    """The (T, ...) bool states of a two-state chain that leaves state 1
    when ``u[t] < p_leave`` and enters it when ``u[t] < p_enter``:
    ``s[t] = where(s[t-1], u[t] >= p_leave, u[t] < p_enter)``, ``s[-1] =
    start``, without a loop over t.  A round either resets the state (both
    branches agree), keeps it, or flips it, so ``s[t]`` is the value of the
    last reset at or before t (``start`` before any) XOR the parity of the
    flips since: a ``cummax`` of the reset rounds and a ``cumsum`` of the
    flips give it, bit for bit the sequential chain."""
    stay, enter = u >= p_leave, u < p_enter       # s[t] when s[t-1] is 1, when it is 0
    reset = stay == enter
    flip = ~(reset | stay)                        # 1 -> 0 and 0 -> 1
    shape = (1,) + tuple(u.shape[1:])
    val = torch.cat([start.expand(shape), stay])                       # (T + 1, ...)
    rounds = torch.arange(u.shape[0] + 1, device=u.device).view((-1,) + (1,) * (u.dim() - 1))
    is_reset = torch.cat([torch.ones(shape, dtype=torch.bool, device=u.device), reset])
    last = torch.cummax(torch.where(is_reset, rounds, 0), dim=0).values
    flips = torch.cat([torch.zeros(shape, dtype=torch.int64, device=u.device),
                       flip.to(torch.int64)]).cumsum(0)
    parity = (flips - flips.gather(0, last)) % 2
    return (val.gather(0, last) ^ parity.to(torch.bool))[1:]


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


@register_scenario
@dataclasses.dataclass(frozen=True)
class GilbertElliottProcess(ChannelProcess):
    """Gilbert-Elliott two-state Markov fading, independently per channel.

    Each channel hops between a Good state (success mean ``mu_good``) and a
    Bad/deep-fade state (``mu_bad``) with transition probabilities ``p_gb``
    (Good->Bad) and ``p_bg`` (Bad->Good) per round, starting from the
    chain's stationary distribution.  Lowered to a (T, N) mean table; the
    states are latent, so the regime stays stochastic ("ucb" scores).
    """

    n_channels: int
    horizon: int
    p_gb: float = 0.05
    p_bg: float = 0.10
    mu_good: float = 0.9
    mu_bad: float = 0.1

    FAMILY = "gilbert_elliott"
    FORM = FORM_TABLE
    TRACED = ("p_gb", "p_bg", "mu_good", "mu_bad")

    @classmethod
    def example(cls, n_channels: int, horizon: int) -> "GilbertElliottProcess":
        return cls(n_channels=n_channels, horizon=horizon)

    def _draws(self, generator, device):
        """``u0`` (N,), the start states' uniform (JAX: the ``bernoulli`` on
        ``k0``, ``uniform(k0, (N,))``), and ``u`` (T, N), the chain's
        (``uniform(k1, (T, N))``)."""
        n = self.n_channels
        return dict(u0=torch.rand((n,), generator=generator, device=device),
                    u=torch.rand((self.horizon, n), generator=generator, device=device))

    def _from_draws(self, d, device) -> ChannelEnv:
        p_gb, p_bg = _f32(self.p_gb, device), _f32(self.p_bg, device)
        p_good0 = p_bg / (p_gb + p_bg).clamp_min(1e-9)
        good = _markov_chain(d["u0"] < p_good0, d["u"], p_gb, p_bg)
        table = torch.where(good, _f32(self.mu_good, device).clamp(0.0, 1.0),
                            _f32(self.mu_bad, device).clamp(0.0, 1.0))
        return table_env(table, device=device)


@register_scenario
@dataclasses.dataclass(frozen=True)
class MobilityDriftProcess(ChannelProcess):
    """Smoothly drifting means: users moving through the coverage area.

    Channel k's success mean follows a sinusoid of ``period`` and
    ``amplitude`` around a random center in [center_low, center_high], with
    a random phase, clipped to [0.01, 0.99].  No abrupt breakpoints: the
    non-stationarity is continuous, the case the GLR detector is not tuned
    for.
    """

    n_channels: int
    horizon: int
    period: float = 1000.0
    amplitude: float = 0.3
    center_low: float = 0.25
    center_high: float = 0.75

    FAMILY = "mobility"
    FORM = FORM_TABLE
    TRACED = ("period", "amplitude", "center_low", "center_high")

    @classmethod
    def example(cls, n_channels: int, horizon: int) -> "MobilityDriftProcess":
        return cls(n_channels=n_channels, horizon=horizon)

    def _draws(self, generator, device):
        """``center`` (N,) and ``phase`` (N,) in [0, 1) (JAX: ``uniform`` on
        ``k0`` before its move to [center_low, center_high), and on ``k1``)."""
        n = self.n_channels
        return dict(center=torch.rand((n,), generator=generator, device=device),
                    phase=torch.rand((n,), generator=generator, device=device))

    def _from_draws(self, d, device) -> ChannelEnv:
        center = _scaled(d["center"], self.center_low, self.center_high)
        t = torch.arange(self.horizon, dtype=torch.float32, device=device)[:, None]
        period = _f32(self.period, device).clamp_min(1.0)
        wave = torch.sin(2.0 * math.pi * (t / period + d["phase"][None, :]))
        table = (center[None, :] + _f32(self.amplitude, device) * wave).clamp(0.01, 0.99)
        return table_env(table, device=device)


@register_scenario
@dataclasses.dataclass(frozen=True)
class ShadowingProcess(ChannelProcess):
    """SNR-threshold shadowing: slow log-normal fading around a per-channel
    link margin.

    Channel k carries a static SNR margin (dB over the decode threshold) in
    [margin_low, margin_high]; an AR(1) shadowing process (coefficient
    ``rho``, innovation scale ``sigma_db``) wanders around it, and the
    round's success mean is ``Phi((margin + shadow) / slope_db)``, the
    imperfect-CSI regime of Pase et al. (2021).
    """

    n_channels: int
    horizon: int
    rho: float = 0.95
    sigma_db: float = 4.0
    margin_low: float = -4.0
    margin_high: float = 8.0
    slope_db: float = 4.0

    FAMILY = "shadowing"
    FORM = FORM_TABLE
    TRACED = ("rho", "sigma_db", "margin_low", "margin_high", "slope_db")

    @classmethod
    def example(cls, n_channels: int, horizon: int) -> "ShadowingProcess":
        return cls(n_channels=n_channels, horizon=horizon)

    def _draws(self, generator, device):
        """``margin`` (N,) in [0, 1) (JAX: ``uniform`` on ``k0`` before its
        move to [margin_low, margin_high)) and ``eps`` (T, N) standard
        normals (``normal(k1, (T, N))``)."""
        n = self.n_channels
        return dict(margin=torch.rand((n,), generator=generator, device=device),
                    eps=torch.randn((self.horizon, n), generator=generator, device=device))

    def _from_draws(self, d, device) -> ChannelEnv:
        margin = _scaled(d["margin"], self.margin_low, self.margin_high)
        rho = _f32(self.rho, device).clamp(0.0, 0.999)
        innov = torch.sqrt(1.0 - rho * rho) * _f32(self.sigma_db, device)
        kicks = innov * d["eps"]
        shadow = torch.empty_like(kicks)
        x = torch.zeros((self.n_channels,), device=device)
        for t in range(self.horizon):          # x[t] = rho * x[t-1] + innov * eps[t]
            x = torch.add(rho * x, kicks[t], out=shadow[t])
        table = _ndtr((margin[None, :] + shadow) / _f32(self.slope_db, device).clamp_min(1e-3))
        return table_env(table.clamp(0.0, 1.0), device=device)


class _OverBase:
    """What the two overlays share: the base scenario's channels and
    horizon, the base's params nested under "base", and the refusal of a
    base without a horizon."""

    def _check_base(self, label: str) -> None:
        if self.horizon == 0 and not getattr(self.base, "horizon", 0):
            raise ValueError(f"{label}: base scenario has no horizon (e.g. stationary); "
                             "pass an explicit horizon=")

    @property
    def n_channels(self) -> int:
        return self.base.n_channels

    @property
    def _horizon(self) -> int:
        return self.horizon if self.horizon else self.base.horizon

    def env_signature(self):
        return (self.FORM, self._horizon, self.n_channels, self.SCORE_KIND)

    def params(self, device=None):
        """The overlay's knobs plus the base scenario's params nested under
        "base" (the ``AoIAware`` wrapped-policy idiom)."""
        sp = super().params(device)
        base_sp = self.base.params(device)
        if base_sp:
            sp["base"] = base_sp
        return sp


@register_scenario
@dataclasses.dataclass(frozen=True)
class JammingOverlay(_OverBase, ChannelProcess):
    """Bursty jamming/attack overlay, composable onto any open-loop base.

    The base scenario is realized and expanded to its dense (T, N) mean
    table; a Markov on/off jammer (burst entry rate ``jam_on``, exit rate
    ``jam_off``, off at the start) multiplicatively suppresses ``n_jammed``
    randomly chosen channels by ``(1 - strength)`` while active, strength
    clipped to [0, 1]: the overlay never raises a mean above the base's.
    """

    base: ChannelProcess
    horizon: int = 0               # 0: inherit the base scenario's horizon
    n_jammed: int = 0              # 0: max(1, n_channels // 3)
    jam_on: float = 0.02
    jam_off: float = 0.15
    strength: float = 0.9

    FAMILY = "jamming"
    FORM = FORM_TABLE
    TRACED = ("jam_on", "jam_off", "strength")

    def __post_init__(self):
        if getattr(self.base, "FORM", None) == FORM_REACTIVE:
            raise ValueError(
                "JammingOverlay: cannot compose onto a \"reactive\" base scenario — its "
                "means depend on the interaction carry, not a precomputable table "
                "(dense_means would raise).  Use the 'reactive_jammer' family for a "
                "closed-loop jammer instead.")
        self._check_base("JammingOverlay")

    @property
    def _n_jammed(self) -> int:
        return self.n_jammed if self.n_jammed else max(1, self.n_channels // 3)

    @classmethod
    def example(cls, n_channels: int, horizon: int) -> "JammingOverlay":
        return cls(base=PiecewiseProcess.example(n_channels, horizon))

    def _draws(self, generator, device):
        """``base`` the realized base env (JAX: on ``kb``), ``u`` (T,) the
        jammer's on/off uniforms (``uniform(kj, (T,))``) and ``perm`` (N,)
        the channel permutation whose first ``n_jammed`` are jammed
        (``permutation(kt, N)``)."""
        return dict(base=self.base._realize(generator, device),
                    u=torch.rand((self._horizon,), generator=generator, device=device),
                    perm=torch.randperm(self.n_channels, generator=generator, device=device))

    def _from_draws(self, d, device) -> ChannelEnv:
        mu = dense_means(d["base"], self._horizon)
        on = _markov_chain(torch.zeros((), dtype=torch.bool, device=device), d["u"],
                           _f32(self.jam_off, device), _f32(self.jam_on, device))
        mask = torch.zeros((self.n_channels,), device=device).index_fill(
            0, d["perm"][: self._n_jammed].to(torch.int64), 1.0)
        strength = _f32(self.strength, device).clamp(0.0, 1.0)
        table = mu * (1.0 - strength * on.to(torch.float32)[:, None] * mask[None, :])
        return table_env(table, device=device)


@register_scenario
@dataclasses.dataclass(frozen=True)
class ReactiveJammerProcess(_OverBase, ChannelProcess):
    """Closed-loop follower jammer: suppresses recently scheduled channels.

    The adversary observes which channels the scheduler used (one round
    late) and tracks a per-channel EMA of that pressure with memory
    ``memory``; once a channel's EMA clears ``lock_thresh`` it suppresses
    the channel by ``(1 - strength)``, ``sharpness`` setting how hard the
    lock-on is.  The base scenario, realized and expanded to a dense (T, N)
    table as ``JammingOverlay``'s, is the open-loop component of the
    ``"reactive"`` env (``base.reactive_env``).
    """

    base: ChannelProcess
    horizon: int = 0               # 0: inherit the base scenario's horizon
    memory: float = 0.8            # EMA memory of the jammer's observations
    strength: float = 0.9          # suppression factor once locked on
    lock_thresh: float = 0.3       # EMA level that triggers lock-on
    sharpness: float = 16.0        # lock-on transition steepness

    FAMILY = "reactive_jammer"
    FORM = FORM_REACTIVE
    TRACED = ("memory", "strength", "lock_thresh", "sharpness")

    def __post_init__(self):
        if getattr(self.base, "FORM", None) == FORM_REACTIVE:
            raise ValueError(
                "ReactiveJammerProcess: base scenario must be open-loop (the reactive "
                "form carries ONE interaction state; nesting reactive scenarios is not "
                "defined)")
        self._check_base("ReactiveJammerProcess")

    @classmethod
    def example(cls, n_channels: int, horizon: int) -> "ReactiveJammerProcess":
        return cls(base=PiecewiseProcess.example(n_channels, horizon))

    def _draws(self, generator, device):
        """``base``, the realized base env (JAX: from the same key)."""
        return dict(base=self.base._realize(generator, device))

    def _from_draws(self, d, device) -> ChannelEnv:
        return reactive_env(dense_means(d["base"], self._horizon), decay=self.memory,
                            gain=self.strength, thresh=self.lock_thresh,
                            sharp=self.sharpness, device=device)


@register_scenario
@dataclasses.dataclass(frozen=True)
class LoadCongestionProcess(ChannelProcess):
    """Closed-loop self-interference: throughput degrades with recent load.

    The more a channel was scheduled recently (load EMA with memory
    ``memory``), the lower its success mean: a smooth degradation of up to
    ``severity`` with half-max at load ``knee`` and transition scale
    ``softness``.  The open-loop component is a stationary draw, base means
    uniform in [mean_low, mean_high] broadcast to the (T, N) base table of
    the ``"reactive"`` form.
    """

    n_channels: int
    horizon: int
    memory: float = 0.9
    severity: float = 0.6
    knee: float = 0.5
    softness: float = 4.0
    mean_low: float = 0.5
    mean_high: float = 0.95

    FAMILY = "congestion"
    FORM = FORM_REACTIVE
    TRACED = ("memory", "severity", "knee", "softness", "mean_low", "mean_high")

    @classmethod
    def example(cls, n_channels: int, horizon: int) -> "LoadCongestionProcess":
        return cls(n_channels=n_channels, horizon=horizon)

    def _draws(self, generator, device):
        """``u`` (N,) in [0, 1) (JAX: ``uniform`` on the key before its move
        to [mean_low, mean_high))."""
        return dict(u=torch.rand((self.n_channels,), generator=generator, device=device))

    def _from_draws(self, d, device) -> ChannelEnv:
        mus = _scaled(d["u"], self.mean_low, self.mean_high)
        table = mus[None, :].expand(self.horizon, self.n_channels).contiguous()
        return reactive_env(table, decay=self.memory, gain=self.severity, thresh=self.knee,
                            sharp=self.softness, device=device)


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
