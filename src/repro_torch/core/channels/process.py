"""``ChannelProcess`` — scenario descriptions and their registry.

A scenario is a frozen dataclass of its parameters; ``realize(generator)``
draws a canonical ``ChannelEnv`` from a ``torch.Generator``.  The draws
follow the JAX package's generators in distribution, not in bits: torch's
generator is not JAX's threefry.  Twin of ``repro/core/channels/process.py``
(the vmapped scenario grids are not ported).
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Optional, Type

import torch

from repro_torch.core.channels.base import ChannelEnv
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ChannelProcess:
    """Base class: a scenario that lowers to a canonical ``ChannelEnv``.

    Subclasses set ``FAMILY`` and implement
    ``_realize(generator, device)``.
    """

    FAMILY: ClassVar[str] = ""

    def _realize(self, generator: Optional[torch.Generator], device) -> ChannelEnv:
        raise NotImplementedError

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
