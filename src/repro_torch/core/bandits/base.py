"""Scheduler API shared by the channel-scheduling policies.

Every scheduler is a frozen, hashable configuration object exposing plain
functions over an explicit state (a ``NamedTuple`` of tensors)::

    state            = sched.init(device)
    channels, aux    = sched.select(state, t, u, aoi)     # (M,) channel ids
    state            = sched.update(state, t, channels, rewards, aux)
    scores           = sched.channel_scores(state, t)     # (N,) ranking for
                                                          # Sec.-V matching

``t`` is the round as a Python int; ``u`` is the round's (N,) f32 uniform
draw, the policy's only randomness.  ``rewards`` are the observed
Good/Bad states of the scheduled channels, (M,) in {0, 1}.

Scalar tuning knobs follow the JAX package's hyper-parameter convention:
a policy lists them in ``TRACED``, ``params()`` returns them as a dict of
0-d f32 tensors, and ``init(device, hp=...)`` stores that dict (or an
override) in ``state.hp``, where ``select``/``update`` read them.
Twin of ``repro/core/bandits/base.py``.
"""
from __future__ import annotations

from typing import Any, ClassVar, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device


class TracedHyperParams:
    """Mixin: the hyper-parameter dict convention (see module docstring)."""

    TRACED: ClassVar[Tuple[str, ...]] = ()

    def params(self, device=None) -> Dict[str, torch.Tensor]:
        dev = resolve_device(device)
        return {f: torch.tensor(getattr(self, f), dtype=torch.float32, device=dev)
                for f in self.TRACED}


def init_with_hp(sched, device, hp: Optional[Dict[str, Any]]) -> Any:
    """``sched.init(device)`` with a hyper-parameter override when given;
    ``None`` or an empty dict means the scheduler's own values."""
    if hp is None or (isinstance(hp, dict) and not hp):
        return sched.init(device)
    return sched.init(device, hp=hp)


def rotate_assignment(channels_sorted: torch.Tensor, t, m: int) -> torch.Tensor:
    """Alg. 2 line 10: player j takes the ((j + t) mod M)-th best channel.
    ``t`` is an int, or a (B,) tensor with ``channels_sorted`` (B, M): each
    row rotates by its own round."""
    j = torch.arange(m, device=channels_sorted.device)
    if isinstance(t, torch.Tensor):
        return channels_sorted.gather(-1, (j + t[..., None].to(torch.int64)) % m)
    return channels_sorted[(j + t) % m]
