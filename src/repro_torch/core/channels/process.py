"""``ChannelProcess`` — scenario descriptions and their registry.

A scenario is a frozen dataclass: static structure (``n_channels``,
``horizon``, segment counts) and traced scenario parameters, declared
through the schedulers' ``TracedHyperParams`` mixin (``params()`` /
``replace_traced()`` / ``hp_signature()``).  ``realize(generator)`` draws
a canonical ``ChannelEnv`` from a ``torch.Generator``; the draws follow
the JAX package's generators in distribution, not in bits: torch's
generator is not JAX's threefry.  ``env_signature()`` is the realized
env's form, shapes and score hint, by which the sweep driver buckets
scenario cases across families.  ``scenario_grid`` and
``realize_processes`` realize a list of scenarios, one generator each,
into one stacked env: the JAX package compiles one vmapped realization a
family there; here each row is that process's own ``realize``, so a row
equals the serial realization bit for bit by construction.  Twin of
``repro/core/channels/process.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Optional, Sequence, Tuple, Type

import torch

from repro_torch.core.bandits.base import TracedHyperParams
from repro_torch.core.channels.base import FORM_SEGMENTS, FORM_TABLE, ChannelEnv, stack_envs
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ChannelProcess(TracedHyperParams):
    """Base class: a scenario that lowers to a canonical ``ChannelEnv``.

    Subclasses set ``FAMILY`` (the registry name), ``FORM`` and
    ``SCORE_KIND`` (the realized env's), ``TRACED``, and implement
    ``_realize(generator, device)`` and ``example(n, T)``.
    """

    FAMILY: ClassVar[str] = ""
    FORM: ClassVar[str] = FORM_SEGMENTS
    SCORE_KIND: ClassVar[str] = "ucb"

    def _realize(self, generator: Optional[torch.Generator], device) -> ChannelEnv:
        raise NotImplementedError

    @classmethod
    def example(cls, n_channels: int, horizon: int) -> "ChannelProcess":
        """A default instance: lets tests and benchmarks enumerate the registry."""
        raise NotImplementedError

    @property
    def n_segments(self) -> int:          # segment-form families override
        return 1

    def env_signature(self) -> Tuple:
        """The realized env's form, shapes and score hint: scenarios with
        equal signatures realize to stackable envs, whatever their family."""
        if self.FORM == FORM_TABLE:
            return (self.FORM, self.horizon, self.n_channels, self.SCORE_KIND)
        return (FORM_SEGMENTS, self.n_segments, self.n_channels, self.SCORE_KIND)

    def realize(self, generator: Optional[torch.Generator] = None, device=None) -> ChannelEnv:
        """Draw the canonical env on ``device`` (default ``cuda``) from
        ``generator``, which must live on that device."""
        return self._realize(generator, resolve_device(device))


_REGISTRY: Dict[str, Type[ChannelProcess]] = {}


def register_scenario(cls: Type[ChannelProcess]) -> Type[ChannelProcess]:
    if not cls.FAMILY:
        raise ValueError(f"{cls.__name__}: FAMILY must be set to register")
    _REGISTRY[cls.FAMILY] = cls
    return cls


def registered_scenarios() -> Dict[str, Type[ChannelProcess]]:
    """Name -> class for every registered scenario family (a copy)."""
    return dict(_REGISTRY)


def check_knobs(cls: type, label: str, kwargs: Dict[str, Any]) -> None:
    """Eagerly reject unknown or missing constructor knobs, listing the
    family's valid knobs.  Shared by the scenario, fault and aggregator
    registries; twin of ``repro.core.channels.process.check_knobs``."""
    valid = {f.name for f in dataclasses.fields(cls) if f.init}
    unknown = sorted(set(kwargs) - valid)
    if unknown:
        raise ValueError(
            f"{label}: unknown knob(s) {unknown}; valid knobs for "
            f"{cls.__name__}: {sorted(valid)}")
    missing = sorted(
        f.name for f in dataclasses.fields(cls)
        if f.init and f.default is dataclasses.MISSING
        and f.default_factory is dataclasses.MISSING
        and f.name not in kwargs)
    if missing:
        raise ValueError(
            f"{label}: missing required knob(s) {missing}; valid knobs for "
            f"{cls.__name__}: {sorted(valid)}")


def make_scenario(family: str, **kwargs) -> ChannelProcess:
    """Construct a scenario by registry name; unknown or missing knobs raise."""
    try:
        cls = _REGISTRY[family]
    except KeyError:
        raise ValueError(
            f"make_scenario: unknown family {family!r}; registered: "
            f"{sorted(_REGISTRY)}") from None
    check_knobs(cls, f"make_scenario({family!r})", kwargs)
    return cls(**kwargs)


def example_scenario(family: str, n_channels: int, horizon: int) -> ChannelProcess:
    """The family's default example instance."""
    try:
        cls = _REGISTRY[family]
    except KeyError:
        raise ValueError(
            f"example_scenario: unknown family {family!r}; registered: "
            f"{sorted(_REGISTRY)}") from None
    return cls.example(n_channels, horizon)


def _generators(generators, count: int, label: str):
    """One generator a process: a sequence of ``count``, or one generator
    the processes draw from in turn."""
    if isinstance(generators, torch.Generator):
        return [generators] * count
    generators = list(generators)
    if len(generators) != count:
        raise ValueError(f"{label}: {count} processes but {len(generators)} generators")
    return generators


def _check_same(processes, sig_fn, what: str, label: str):
    procs = list(processes)
    if not procs:
        raise ValueError(f"{label}: empty process list")
    sig = sig_fn(procs[0])
    for p in procs[1:]:
        if sig_fn(p) != sig:
            raise ValueError(
                f"{label}: processes must share one {what}; got {sig} vs {sig_fn(p)} — "
                "group heterogeneous scenarios with repro_torch.sim.sweep instead")
    return procs


def scenario_grid(processes: Sequence[ChannelProcess], generators, device=None) -> ChannelEnv:
    """Realize a same-family grid of scenarios (one ``hp_signature()``,
    traced parameters free to differ) into one stacked env, row ``i`` from
    ``generators[i]`` (or all rows in turn from one generator): row ``i``
    is ``processes[i].realize(generators[i], device)``."""
    procs = _check_same(processes, lambda p: p.hp_signature(), "family/structure signature",
                        "scenario_grid")
    gens = _generators(generators, len(procs), "scenario_grid")
    return stack_envs([p.realize(g, device) for p, g in zip(procs, gens)])


def realize_processes(processes: Sequence[ChannelProcess], generators,
                      device=None) -> ChannelEnv:
    """Realize a mixed-family list of scenarios of one ``env_signature()``
    (form, shapes, score hint) into one stacked env, row ``i`` from
    ``generators[i]``: the sweep driver's bucket realization."""
    procs = _check_same(processes, lambda p: p.env_signature(), "canonical form/shape",
                        "realize_processes")
    gens = _generators(generators, len(procs), "realize_processes")
    return stack_envs([p.realize(g, device) for p, g in zip(procs, gens)])
