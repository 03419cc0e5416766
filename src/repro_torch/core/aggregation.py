"""``Aggregator`` — registry-driven robust server aggregation (Step 4).

An aggregation rule is a frozen, hashable dataclass whose scalar knobs are
hyper-parameters (``TracedHyperParams``: ``params()`` gives them as 0-d f32
tensors), registered under a family name and applied at Step 4 of the FL
round (``repro_torch.fl.round``).  It composes with the quarantine gate:
quarantine masks non-finite / norm-exploded rows out of ``mask`` (and
zeroes them in ``buffers``) first, then the aggregator turns the surviving
rows into one (P,) step direction.  Families:

  mean        the zeta-weighted masked mean of Eq. 7,
              ``scale = mask * zeta * (m / max(n, 1))``, through the
              ``weighted_aggregate`` kernel; the round's default
              (``aggregator=None``).
  trimmed_mean
              per coordinate, the ``floor(trim_frac * n)`` smallest and
              largest participating values dropped and the rest averaged,
              through the ``robust_trimmed`` kernel.  Unweighted.
  coordinate_median
              the trimmed mean at depth ``floor((n-1)/2)``.  Unweighted.
  norm_clip   each row scaled to L2 norm at most ``clip_norm``, then the
              zeta-weighted mean.

``aggregate(buffers, mask, zeta, n_succ)`` returns the (P,) f32 aggregate
(the caller applies ``-server_lr / m``).  The trim depths are computed on
the device from ``n_succ``: nothing waits on the card.  Every family also
takes a leading run axis, (B, M, P) buffers with (B, M) mask and zeta and
(B,) ``n_succ`` -> (B, P), each run's row its own aggregate (one kernel
launch for the batch), and its knobs may be a ``stack_params`` grid of
(B,) values, one a run (the JAX package's vmapped aggregator grid).  Twin
of ``repro/core/aggregation.py``.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional, Type

import torch

from repro_torch.core.bandits.base import TracedHyperParams
from repro_torch.core.channels.process import check_knobs
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Aggregator(TracedHyperParams):
    """Base class: a hashable server-aggregation rule.

    Subclasses set ``FAMILY``/``TRACED`` and implement
    ``_aggregate(buffers, mask, zeta, n_succ, sp)``: (M, P) quarantine-
    masked buffers, (M,) f32 {0, 1} mask, (M,) zeta, 0-d participant count
    -> (P,) f32, every knob read from ``sp``; zeros when nothing
    participates.  The same with a leading run axis on every operand (and
    0-d or (B,) knobs) -> (B, P).
    """

    FAMILY: ClassVar[str] = ""

    def _aggregate(self, buffers, mask, zeta, n_succ, sp) -> torch.Tensor:
        raise NotImplementedError

    @classmethod
    def example(cls) -> "Aggregator":
        return cls()

    def aggregate(self, buffers: torch.Tensor, mask: torch.Tensor, zeta: torch.Tensor,
                  n_succ: torch.Tensor, params: Optional[Dict] = None) -> torch.Tensor:
        """Aggregate a round's surviving client buffers into one (P,) row.
        ``params`` optionally overrides the knobs (``self.params()``)."""
        if not params:
            params = self.params(buffers.device)
        return self._aggregate(buffers, mask, zeta, n_succ, params)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_AGG_REGISTRY: Dict[str, Type[Aggregator]] = {}


def register_aggregator(cls: Type[Aggregator]) -> Type[Aggregator]:
    """Class decorator: add an aggregation family to the registry."""
    if not cls.FAMILY:
        raise ValueError(f"register_aggregator: {cls.__name__} has no FAMILY name")
    if cls.FAMILY in _AGG_REGISTRY:
        raise ValueError(f"register_aggregator: duplicate family {cls.FAMILY!r}")
    _AGG_REGISTRY[cls.FAMILY] = cls
    return cls


def registered_aggregators() -> Dict[str, Type[Aggregator]]:
    """Name -> class for every registered aggregation family (a copy)."""
    return dict(_AGG_REGISTRY)


def _family(label: str, family: str) -> Type[Aggregator]:
    try:
        return _AGG_REGISTRY[family]
    except KeyError:
        raise ValueError(
            f"{label}: unknown family {family!r}; registered: {sorted(_AGG_REGISTRY)}") from None


def make_aggregator(family: str, **kwargs) -> Aggregator:
    """Construct an aggregator by registry name; unknown or missing knobs raise."""
    cls = _family("make_aggregator", family)
    check_knobs(cls, f"make_aggregator({family!r})", kwargs)
    return cls(**kwargs)


def example_aggregator(family: str) -> Aggregator:
    """The family's default example instance."""
    return _family("example_aggregator", family).example()


# ---------------------------------------------------------------------------
# built-in families
# ---------------------------------------------------------------------------

def _mean_scale(buffers, mask, zeta, n_succ):
    return mask * zeta * (buffers.shape[-2] / n_succ.clamp_min(1.0))[..., None]


def _median_depth(n_succ):
    return torch.floor((n_succ - 1.0) / 2.0).clamp_min(0.0)


@register_aggregator
@dataclasses.dataclass(frozen=True)
class MeanAgg(Aggregator):
    """Eq. 7 zeta-weighted masked mean: the round's default aggregator."""

    FAMILY = "mean"
    TRACED = ()

    def _aggregate(self, buffers, mask, zeta, n_succ, sp):
        return ops.weighted_aggregate(buffers, _mean_scale(buffers, mask, zeta, n_succ))


@register_aggregator
@dataclasses.dataclass(frozen=True)
class TrimmedMeanAgg(Aggregator):
    """Coordinate-wise trimmed mean at depth ``floor(trim_frac * n)``,
    clamped to ``floor((n-1)/2)`` so at least one value survives.
    Unweighted (zeta is ignored)."""

    trim_frac: float = 0.25

    FAMILY = "trimmed_mean"
    TRACED = ("trim_frac",)

    def _aggregate(self, buffers, mask, zeta, n_succ, sp):
        k = torch.floor(sp["trim_frac"].clamp(0.0, 0.5) * n_succ)
        k = torch.minimum(k.clamp_min(0.0), _median_depth(n_succ))
        return ops.robust_trimmed(buffers, mask, n_succ, k)


@register_aggregator
@dataclasses.dataclass(frozen=True)
class CoordinateMedianAgg(Aggregator):
    """Coordinate-wise median: the trimmed mean at depth ``floor((n-1)/2)``
    (odd n: the middle value; even n: the mean of the two middles).
    Unweighted."""

    FAMILY = "coordinate_median"
    TRACED = ()

    def _aggregate(self, buffers, mask, zeta, n_succ, sp):
        return ops.robust_trimmed(buffers, mask, n_succ, _median_depth(n_succ))


@register_aggregator
@dataclasses.dataclass(frozen=True)
class NormClipAgg(Aggregator):
    """Each row G scaled to ``G * min(1, clip_norm / ||G||)``, then the
    zeta-weighted mean."""

    clip_norm: float = 1.0

    FAMILY = "norm_clip"
    TRACED = ("clip_norm",)

    def _aggregate(self, buffers, mask, zeta, n_succ, sp):
        x = buffers.to(torch.float32)
        norms = torch.sqrt((x * x).sum(dim=-1))
        factor = torch.clamp_max(sp["clip_norm"][..., None] / norms.clamp_min(1e-12), 1.0)
        return ops.weighted_aggregate(x * factor[..., None],
                                      _mean_scale(buffers, mask, zeta, n_succ))
