"""``AvailabilityProcess`` — registry-driven client availability dynamics.

The heterogeneity layer of the sparse FL substrate (``repro_torch.fl.sparse``):
a per-client state machine for the imperfect-participation regime the
paper's round protocol abstracts away — availability churn, stragglers,
dropouts.  A family is a frozen, hashable dataclass whose scalar knobs are
hyper-parameters (``TracedHyperParams``), registered under a family name,
as the channel-scenario and fault registries are.

Every client is in one of three phases, with a latency counter:

  IDLE (0)     schedulable: the server may grant the client a slot
  WORKING (1)  mid-computation (straggler latency): unavailable until its
               ``timer`` expires
  DROPPED (2)  churned away (crash / churn): unavailable until it rejoins

``init_state(n_clients, device)`` returns the ``{"phase", "timer"}`` dict
of (N,) tensors; ``step(u, t, astate, sched_mask)`` advances one round and
returns ``(astate', available)``, ``available`` the (N,) f32 {0, 1}
schedulable mask for the NEXT round.  ``sched_mask`` is the (N,) {0, 1}
mask of clients granted THIS round (a one-round observation delay).

Randomness.  A family draws no numbers itself: ``n_uniforms(n)`` says how
many f32 uniforms in [0, 1) a round consumes for N clients, and ``step``
takes them as a (K,) tensor ``u``.  Against the JAX package, whose sparse
round steps the family on ``k_avail = fold_in(key, 0xA7A1)``, the uniforms
stand for these draws (a Bernoulli draw there is ``uniform(k, (N,)) < p``,
bitwise):

  always_on       K = 0;
  markov_churn,   K = 2N: ``k0, k1 = split(k_avail)``, then
  straggler       ``uniform(k0, (N,))`` and ``uniform(k1, (N,))``;
  dropout_rejoin  K = N: ``uniform(k_avail, (N,))``.

Every family also takes a leading run axis: (B, N) state and mask, (B, K)
uniforms, and knobs that are 0-d or a ``stack_params`` grid of (B,)
values, one a run.  Twin of ``repro/core/availability.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Optional, Tuple, Type

import torch

from repro_torch.core.bandits.base import TracedHyperParams
from repro_torch.core.channels.process import check_knobs
from repro_torch.device import resolve_device

# client phases (int32 codes in ``state["phase"]``)
IDLE = 0
WORKING = 1
DROPPED = 2


def init_availability_state(n_clients: int, device=None) -> Dict[str, torch.Tensor]:
    """All clients start IDLE with no pending latency."""
    dev = resolve_device(device)
    return {"phase": torch.zeros((n_clients,), dtype=torch.int32, device=dev),
            "timer": torch.zeros((n_clients,), dtype=torch.float32, device=dev)}


def _knob(sp, name: str) -> torch.Tensor:
    """A knob shaped to broadcast against (..., N): 0-d or (B,) -> (..., 1)."""
    return sp[name][..., None]


@dataclasses.dataclass(frozen=True)
class AvailabilityProcess(TracedHyperParams):
    """Base class: a hashable availability-family description.

    Subclasses set ``FAMILY``/``TRACED``, implement
    ``_step(u, t, astate, sched_mask, sp)`` -> ``(astate', available)``
    with every knob read from ``sp``, and override ``n_uniforms`` when a
    round takes other than N uniforms.
    """

    FAMILY: ClassVar[str] = ""

    def n_uniforms(self, n: int) -> int:
        """f32 uniforms one round consumes for N clients."""
        return n

    def _step(self, u, t, astate, sched_mask, sp) -> Tuple[Any, torch.Tensor]:
        raise NotImplementedError

    @classmethod
    def example(cls) -> "AvailabilityProcess":
        return cls()

    def init_state(self, n_clients: int, device=None) -> Dict[str, torch.Tensor]:
        return init_availability_state(n_clients, device)

    def step(self, u: torch.Tensor, t: int, astate, sched_mask: torch.Tensor,
             params: Optional[Dict] = None) -> Tuple[Any, torch.Tensor]:
        """Advance the per-client state machine one round on the round's
        uniforms ``u`` (..., K); ``params`` overrides the knobs (a
        ``params()`` dict, or a ``stack_params`` grid for a run axis)."""
        n = astate["phase"].shape[-1]
        want = tuple(astate["phase"].shape[:-1]) + (self.n_uniforms(n),)
        if tuple(u.shape) != want:
            raise ValueError(f"{type(self).__name__}: a round takes {want} uniforms for "
                             f"{n} clients, got {tuple(u.shape)}")
        sp = params if params else self.params(sched_mask.device)
        return self._step(u, t, astate, sched_mask, sp)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_AVAIL_REGISTRY: Dict[str, Type[AvailabilityProcess]] = {}


def register_availability(cls: Type[AvailabilityProcess]) -> Type[AvailabilityProcess]:
    """Class decorator: add an availability family to the registry."""
    if not cls.FAMILY:
        raise ValueError(f"register_availability: {cls.__name__} has no FAMILY name")
    if cls.FAMILY in _AVAIL_REGISTRY:
        raise ValueError(f"register_availability: duplicate family {cls.FAMILY!r}")
    _AVAIL_REGISTRY[cls.FAMILY] = cls
    return cls


def registered_availabilities() -> Dict[str, Type[AvailabilityProcess]]:
    """Name -> class for every registered availability family (a copy)."""
    return dict(_AVAIL_REGISTRY)


def _family(label: str, family: str) -> Type[AvailabilityProcess]:
    try:
        return _AVAIL_REGISTRY[family]
    except KeyError:
        raise ValueError(f"{label}: unknown family {family!r}; registered: "
                         f"{sorted(_AVAIL_REGISTRY)}") from None


def make_availability(family: str, **kwargs) -> AvailabilityProcess:
    """Construct an availability process by registry name; unknown or
    missing knobs raise, listing the family's valid knobs."""
    cls = _family("make_availability", family)
    check_knobs(cls, f"make_availability({family!r})", kwargs)
    return cls(**kwargs)


def example_availability(family: str) -> AvailabilityProcess:
    """The family's default example instance."""
    return _family("example_availability", family).example()


# ---------------------------------------------------------------------------
# built-in families
# ---------------------------------------------------------------------------

@register_availability
@dataclasses.dataclass(frozen=True)
class AlwaysOn(AvailabilityProcess):
    """Every client schedulable every round — the dense-parity reference."""

    FAMILY = "always_on"
    TRACED = ()

    def n_uniforms(self, n: int) -> int:
        return 0

    def _step(self, u, t, astate, sched_mask, sp):
        return astate, torch.ones(astate["phase"].shape, dtype=torch.float32,
                                  device=sched_mask.device)


@register_availability
@dataclasses.dataclass(frozen=True)
class MarkovChurn(AvailabilityProcess):
    """Two-state availability churn: an IDLE client drops with ``p_drop``
    per round, a DROPPED one rejoins with ``p_rejoin``."""

    p_drop: float = 0.05
    p_rejoin: float = 0.2

    FAMILY = "markov_churn"
    TRACED = ("p_drop", "p_rejoin")

    def n_uniforms(self, n: int) -> int:
        return 2 * n

    def _step(self, u, t, astate, sched_mask, sp):
        phase = astate["phase"]
        n = phase.shape[-1]
        drop = u[..., :n] < _knob(sp, "p_drop").clamp(0.0, 1.0)
        rejoin = u[..., n:] < _knob(sp, "p_rejoin").clamp(0.0, 1.0)
        new_phase = torch.where(phase == DROPPED,
                                torch.where(rejoin, IDLE, DROPPED),
                                torch.where(drop, DROPPED, phase)).to(torch.int32)
        avail = (new_phase != DROPPED).to(torch.float32)
        return {"phase": new_phase, "timer": astate["timer"]}, avail


@register_availability
@dataclasses.dataclass(frozen=True)
class StragglerLatency(AvailabilityProcess):
    """Compute-latency stragglers: a granted client enters WORKING for a
    per-grant latency — 1 round for fast clients, ``1 + Geometric`` with
    mean ``slow_latency`` for the Bernoulli(``slow_frac``) slow ones — and
    is unschedulable until its timer expires."""

    slow_frac: float = 0.2
    slow_latency: float = 4.0

    FAMILY = "straggler"
    TRACED = ("slow_frac", "slow_latency")

    def n_uniforms(self, n: int) -> int:
        return 2 * n

    def _step(self, u, t, astate, sched_mask, sp):
        phase, timer = astate["phase"], astate["timer"]
        n = phase.shape[-1]
        slow = u[..., :n] < _knob(sp, "slow_frac").clamp(0.0, 1.0)
        # geometric extra latency with mean (slow_latency - 1)
        p = 1.0 / (_knob(sp, "slow_latency") - 1.0).clamp_min(1.0)
        extra = torch.floor(torch.log1p(-u[..., n:])
                            / torch.log1p(-p.clamp(1e-6, 1.0 - 1e-6)))
        grant_latency = torch.where(slow, 1.0 + extra, 1.0)
        timer = torch.where(sched_mask > 0.5, grant_latency, (timer - 1.0).clamp_min(0.0))
        working = timer > 0.5
        new_phase = torch.where(working, WORKING,
                                torch.where(phase == WORKING, IDLE, phase)).to(torch.int32)
        avail = (~working & (new_phase != DROPPED)).to(torch.float32)
        return {"phase": new_phase, "timer": timer}, avail


@register_availability
@dataclasses.dataclass(frozen=True)
class DropoutRejoin(AvailabilityProcess):
    """Crash-and-rejoin dropouts: an IDLE client crashes with ``rate`` per
    round and stays DROPPED for a deterministic ``rejoin_after`` rounds."""

    rate: float = 0.02
    rejoin_after: float = 10.0

    FAMILY = "dropout_rejoin"
    TRACED = ("rate", "rejoin_after")

    def _step(self, u, t, astate, sched_mask, sp):
        phase, timer = astate["phase"], astate["timer"]
        crash = u < _knob(sp, "rate").clamp(0.0, 1.0)
        is_dropped = phase == DROPPED
        timer = torch.where(is_dropped, (timer - 1.0).clamp_min(0.0), timer)
        back = is_dropped & (timer <= 0.5)
        newly = ~is_dropped & crash
        new_phase = torch.where(newly, DROPPED,
                                torch.where(back, IDLE, phase)).to(torch.int32)
        timer = torch.where(newly, _knob(sp, "rejoin_after").clamp_min(1.0), timer)
        avail = (new_phase != DROPPED).to(torch.float32)
        return {"phase": new_phase, "timer": timer}, avail
