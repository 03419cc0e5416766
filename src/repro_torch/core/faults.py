"""``FaultProcess`` — registry-driven client-side fault injection.

A fault family is a frozen, hashable dataclass whose scalar knobs are
hyper-parameters (``TracedHyperParams``), registered under a family name.
``AsyncFLTrainer`` injects it between local SGD and the Eq.-6 buffer carry,
where client-side failures corrupt the upload path:

  dropout    the client is unavailable this round: it neither refreshes
             its buffer nor transmits.
  nan_grads  hit rows become all-NaN (all-Inf for a fraction of hits).
  byte_flip  hit rows are scaled by ``2**exponent``: finite but
             norm-exploded.
  sign_flip  Byzantine: hit rows upload ``-scale * G``.
  inner_product
             ALIE-style collusion: every hit row uploads
             ``-strength * mean(honest rows)``.
  burst      a schedule over any base family with a ``rate`` knob: a
             Gilbert-Elliott on/off carry (entry ``p_on``, exit ``p_off``)
             scales the base rate by ``on_scale`` / ``off_scale``.

Randomness.  A family draws no numbers itself: ``n_uniforms(m)`` says how
many f32 uniforms in [0, 1) one round consumes, and ``inject`` /
``inject_sched`` take them as a (K,) tensor ``u``.  Against the JAX
package, whose round injects on ``k_fault = fold_in(key, 0xFA17)``, the
uniforms stand for these draws (a Bernoulli draw there is
``uniform(k, shape) < p``, bitwise):

  dropout, byte_flip, sign_flip, inner_product
             K = M: ``uniform(k_fault, (M,))``;
  nan_grads  K = 2M: ``k0, k1 = split(k_fault)``, then
             ``uniform(k0, (M,))`` (hit) and ``uniform(k1, (M,))`` (Inf);
  burst      K = 1 + the base's K: ``k_flip, k_base = split(k_fault)``,
             then ``uniform(k_flip, ())`` (the carry's flip) and the base
             family's uniforms on ``k_base``.

Every comparison ``u < rate`` is against the f32 knob from ``params()``,
as JAX compares against its f32 ``params()`` leaf.  ``inject(u, t,
updates)`` returns ``(updates', dropped)`` with ``dropped`` the (M,) f32
{0, 1} unavailability mask.  Every family also takes a leading run axis:
(B, M, P) updates, (B, K) uniforms and a (B,) schedule carry, each run
injected as it would be alone; the knobs may be a ``stack_params`` grid of
(B,) values, one a run (the JAX package's vmapped fault grid).  Twin of
``repro/core/faults.py``.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional, Type

import torch

from repro_torch.core.bandits.base import TracedHyperParams
from repro_torch.core.channels.process import check_knobs


def _bernoulli(u: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """``u < clip(rate, 0, 1)`` in f32: JAX's ``bernoulli`` on the same
    uniforms."""
    return u < rate.clamp(0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class FaultProcess(TracedHyperParams):
    """Base class: a hashable fault-family description.

    Subclasses set ``FAMILY``/``TRACED`` and implement
    ``_inject(u, t, updates, sp)`` -> ``(updates', dropped)``, every knob
    read from ``sp``.  A family with temporal structure overrides
    ``schedule_init`` (its carried state; a dead f32 zero by default) and
    ``_inject_sched`` -> ``(updates', dropped, fstate')``.
    """

    FAMILY: ClassVar[str] = ""

    def n_uniforms(self, m: int) -> int:
        """f32 uniforms one round consumes for M clients."""
        return m

    def _inject(self, u, t, updates, sp):
        raise NotImplementedError

    @classmethod
    def example(cls) -> "FaultProcess":
        return cls()

    def schedule_init(self, device=None) -> torch.Tensor:
        """Initial carried schedule state (a dead f32 zero by default)."""
        return torch.zeros((), dtype=torch.float32, device=device)

    def _inject_sched(self, u, t, updates, fstate, sp):
        out, dropped = self._inject(u, t, updates, sp)
        return out, dropped, fstate

    def _checked(self, u, updates, params):
        m = updates.shape[-2]
        want = tuple(updates.shape[:-2]) + (self.n_uniforms(m),)
        if tuple(u.shape) != want:
            raise ValueError(
                f"{type(self).__name__}: a round takes {want} uniforms for "
                f"{m} clients, got {tuple(u.shape)}")
        return params if params else self.params(updates.device)

    def inject(self, u: torch.Tensor, t: int, updates: torch.Tensor,
               params: Optional[Dict] = None):
        """Apply the family to a round's fresh (M, P) updates (or (B, M, P)
        with (B, K) uniforms) from the initial schedule state; returns
        ``(updates', dropped)``."""
        sp = self._checked(u, updates, params)
        fstate = self.schedule_init(updates.device).expand(updates.shape[:-2])
        out, dropped, _ = self._inject_sched(u, t, updates, fstate, sp)
        return out, dropped

    def inject_sched(self, u: torch.Tensor, t: int, updates: torch.Tensor,
                     fstate: torch.Tensor, params: Optional[Dict] = None):
        """Stateful injection: ``(updates', dropped, fstate')``, the carry
        advanced once per round."""
        sp = self._checked(u, updates, params)
        return self._inject_sched(u, t, updates, fstate, sp)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_FAULT_REGISTRY: Dict[str, Type[FaultProcess]] = {}


def register_fault(cls: Type[FaultProcess]) -> Type[FaultProcess]:
    """Class decorator: add a fault family to the registry."""
    if not cls.FAMILY:
        raise ValueError(f"register_fault: {cls.__name__} has no FAMILY name")
    if cls.FAMILY in _FAULT_REGISTRY:
        raise ValueError(f"register_fault: duplicate family {cls.FAMILY!r}")
    _FAULT_REGISTRY[cls.FAMILY] = cls
    return cls


def registered_faults() -> Dict[str, Type[FaultProcess]]:
    """Name -> class for every registered fault family (a copy)."""
    return dict(_FAULT_REGISTRY)


def _family(label: str, family: str) -> Type[FaultProcess]:
    try:
        return _FAULT_REGISTRY[family]
    except KeyError:
        raise ValueError(
            f"{label}: unknown family {family!r}; registered: {sorted(_FAULT_REGISTRY)}") from None


def make_fault(family: str, **kwargs) -> FaultProcess:
    """Construct a fault process by registry name; unknown or missing knobs raise."""
    cls = _family("make_fault", family)
    check_knobs(cls, f"make_fault({family!r})", kwargs)
    return cls(**kwargs)


def example_fault(family: str) -> FaultProcess:
    """The family's default example instance."""
    return _family("example_fault", family).example()


# ---------------------------------------------------------------------------
# built-in families
# ---------------------------------------------------------------------------

def _zeros(updates):
    return torch.zeros(updates.shape[:-1], dtype=torch.float32, device=updates.device)


@register_fault
@dataclasses.dataclass(frozen=True)
class DropoutFaults(FaultProcess):
    """Per-round Bernoulli client unavailability (straggler/crash)."""

    rate: float = 0.1

    FAMILY = "dropout"
    TRACED = ("rate",)

    def _inject(self, u, t, updates, sp):
        return updates, _bernoulli(u, sp["rate"][..., None]).to(torch.float32)


@register_fault
@dataclasses.dataclass(frozen=True)
class NaNGradFaults(FaultProcess):
    """Hit rows become all-NaN, or all-Inf for a fraction ``inf_frac`` of
    hits."""

    rate: float = 0.1
    inf_frac: float = 0.0

    FAMILY = "nan_grads"
    TRACED = ("rate", "inf_frac")

    def n_uniforms(self, m: int) -> int:
        return 2 * m

    def _inject(self, u, t, updates, sp):
        m = updates.shape[-2]
        hit = _bernoulli(u[..., :m], sp["rate"][..., None])
        use_inf = _bernoulli(u[..., m:], sp["inf_frac"][..., None])
        bad = torch.where(use_inf, torch.inf, torch.nan).to(updates.dtype)
        return torch.where(hit[..., None], bad[..., None], updates), _zeros(updates)


@register_fault
@dataclasses.dataclass(frozen=True)
class ByteFlipFaults(FaultProcess):
    """Exponent-bit flip in transit: hit rows scaled by ``2**exponent``."""

    rate: float = 0.05
    exponent: float = 24.0

    FAMILY = "byte_flip"
    TRACED = ("rate", "exponent")

    def _inject(self, u, t, updates, sp):
        hit = _bernoulli(u, sp["rate"][..., None])
        factor = torch.where(hit, torch.exp2(sp["exponent"][..., None]), 1.0)
        return updates * factor[..., None], _zeros(updates)


@register_fault
@dataclasses.dataclass(frozen=True)
class SignFlipFaults(FaultProcess):
    """Byzantine sign-flip: hit rows upload ``-scale * G``."""

    rate: float = 0.2
    scale: float = 3.0

    FAMILY = "sign_flip"
    TRACED = ("rate", "scale")

    def _inject(self, u, t, updates, sp):
        hit = _bernoulli(u, sp["rate"][..., None])
        factor = torch.where(hit, -sp["scale"][..., None], 1.0)
        return updates * factor[..., None], _zeros(updates)


@register_fault
@dataclasses.dataclass(frozen=True)
class InnerProductFaults(FaultProcess):
    """ALIE-style collusion: every hit row uploads the same vector
    ``-strength * mean(honest rows)``."""

    rate: float = 0.2
    strength: float = 3.0

    FAMILY = "inner_product"
    TRACED = ("rate", "strength")

    def _inject(self, u, t, updates, sp):
        hit = _bernoulli(u, sp["rate"][..., None])
        honest = (~hit).to(torch.float32)
        n_honest = honest.sum(dim=-1, keepdim=True).clamp_min(1.0)
        mean_honest = (updates.to(torch.float32) * honest[..., None]).sum(dim=-2) / n_honest
        attack = -sp["strength"][..., None] * mean_honest
        out = torch.where(hit[..., None], attack[..., None, :].to(updates.dtype), updates)
        return out, _zeros(updates)


@register_fault
@dataclasses.dataclass(frozen=True)
class BurstFaults(FaultProcess):
    """Gilbert-Elliott burst schedule over a base family: the carry
    (``fault_state``, 1.0 while bursting) scales the base ``rate`` by
    ``on_scale`` or ``off_scale`` and flips with probability ``p_off``
    (on) or ``p_on`` (off) after each round.  ``inject`` runs from the
    calm state."""

    base: FaultProcess = dataclasses.field(default_factory=lambda: SignFlipFaults())
    p_on: float = 0.1
    p_off: float = 0.25
    on_scale: float = 1.0
    off_scale: float = 0.0

    FAMILY = "burst"
    TRACED = ("p_on", "p_off", "on_scale", "off_scale")

    def __post_init__(self):
        if "rate" not in self.base.TRACED:
            raise ValueError(
                f"BurstFaults: base family {type(self.base).__name__!r} has "
                "no traced 'rate' knob to modulate")

    def n_uniforms(self, m: int) -> int:
        return 1 + self.base.n_uniforms(m)

    def params(self, device=None):
        """Schedule knobs plus the base family's, nested under "base"."""
        sp = super().params(device)
        sp["base"] = self.base.params(device)
        return sp

    def _inject_sched(self, u, t, updates, fstate, sp):
        on = fstate > 0.5
        mod = torch.where(on, sp["on_scale"], sp["off_scale"])
        bp = dict(sp["base"])
        bp["rate"] = (bp["rate"] * mod).clamp(0.0, 1.0)
        out, dropped = self.base._inject(u[..., 1:], t, updates, bp)
        p_flip = torch.where(on, sp["p_off"].clamp(0.0, 1.0), sp["p_on"].clamp(0.0, 1.0))
        nxt = torch.where(u[..., 0] < p_flip, 1.0 - fstate, fstate)
        return out, dropped, nxt
