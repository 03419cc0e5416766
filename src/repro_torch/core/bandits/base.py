"""Scheduler API shared by the channel-scheduling policies.

Every scheduler is a frozen, hashable configuration object exposing plain
functions over an explicit state (a ``NamedTuple`` of tensors)::

    state            = sched.init(device)
    channels, aux    = sched.select(state, t, u, aoi)     # (M,) channel ids
    state            = sched.update(state, t, channels, rewards, aux)
    scores           = sched.channel_scores(state, t)     # (N,) ranking for
                                                          # Sec.-V matching

``t`` is the round as a Python int; ``u`` is the round's (N,) f32 uniform
draw, the policy's only randomness (each policy's docstring names the JAX
draw its ``u`` stands for).  ``rewards`` are the observed Good/Bad states
of the scheduled channels, (M,) in {0, 1}.

A batch of independent runs (the batched engine, ``repro_torch.sim``)
goes through the same functions with a leading run axis: state leaves
(B, ...) from ``init_batch``, ``u`` (B, N), ``aoi`` (B, M), the channels
(B, M), ``t`` still one Python int; a hyper-parameter is 0-d (shared by
every run) or (B,) (one a run).  Each policy writes that batched round
explicitly, no ``vmap``: every reduction and sort runs over the last axis
of a (B, ...) tensor, scatters replace index adds, and a hyper-parameter
enters as ``hp[k][..., None]``, so each row gets the bits of the
unbatched call on it (the JAX package ``vmap``s the unbatched functions).

``update`` is functional: it never writes a leaf of the state it is given
in place, and returns a new tensor for every leaf it changes.  A leaf it
returns as the very object it was given is unchanged: the scheduler
service (``repro_torch.sim.serve``) writes back only the leaves that are
new objects, so an in-place update would be lost there.

Scalar tuning knobs follow the JAX package's hyper-parameter convention:
a policy lists them in ``TRACED`` (or overrides ``traced_fields()`` when
the set depends on a structural field), ``params()`` returns them as a
dict of 0-d f32 tensors, and ``init(device, hp=...)`` stores that dict (or
an override) in ``state.hp``, where ``select``/``update`` read them.
``replace_traced``, ``hp_signature`` and ``stack_params`` are the JAX
package's grid helpers.  Twin of ``repro/core/bandits/base.py``.
"""
from __future__ import annotations

import dataclasses
import itertools
from math import comb
from typing import Any, ClassVar, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class TracedHyperParams:
    """Mixin: the hyper-parameter dict convention (see module docstring).

    ``hp_signature()`` is the structural identity: every field that is not
    traced by value (recursing into a wrapped scheduler), traced fields by
    name only; configs with equal signatures differ only in ``params()``.
    """

    TRACED: ClassVar[Tuple[str, ...]] = ()

    def traced_fields(self) -> Tuple[str, ...]:
        return self.TRACED

    def params(self, device=None) -> Dict[str, torch.Tensor]:
        dev = resolve_device(device)
        return {f: torch.tensor(getattr(self, f), dtype=torch.float32, device=dev)
                for f in self.traced_fields()}

    def replace_traced(self, **vals):
        unknown = set(vals) - set(self.traced_fields())
        if unknown:
            raise ValueError(
                f"{type(self).__name__}.replace_traced: {sorted(unknown)} are "
                f"not traced hyper-parameters (traced: {self.traced_fields()}); "
                "structural fields need a new config")
        return dataclasses.replace(self, **vals)

    def hp_signature(self) -> Tuple:
        traced = set(self.traced_fields())
        parts = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name in traced:
                parts.append((f.name, "<traced>"))
            elif hasattr(v, "hp_signature"):
                parts.append((f.name, v.hp_signature()))
            else:
                parts.append((f.name, v))
        return (type(self).__name__, tuple(parts))


def init_with_hp(sched, device, hp: Optional[Dict[str, Any]]) -> Any:
    """``sched.init(device)`` with a hyper-parameter override when given;
    ``None`` or an empty dict means the scheduler's own values."""
    if hp is None or (isinstance(hp, dict) and not hp):
        return sched.init(device)
    return sched.init(device, hp=hp)


def hp_tensors(hp: Dict[str, Any], device) -> Dict[str, Any]:
    """An ``hp`` override as 0-d (or stacked) f32 tensors on ``device``;
    a nested dict (a wrapped scheduler's, under ``"base"``) stays nested."""
    return {k: hp_tensors(v, device) if isinstance(v, dict)
            else torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in hp.items()}


def _stack(dicts):
    return {k: _stack([d[k] for d in dicts]) if isinstance(dicts[0][k], dict)
            else torch.stack([torch.as_tensor(d[k]) for d in dicts]) for k in dicts[0]}


def stack_params(configs, device=None) -> Optional[Dict[str, Any]]:
    """Stack each config's ``params()`` along a leading (G,) grid axis
    (nested dicts stay nested).  Returns ``None`` for knob-free schedulers
    and for those without the convention (no ``params``), the value the
    engines treat as absent."""
    plists = [c.params(device) if hasattr(c, "params") else {} for c in configs]
    if not plists[0]:
        return None
    return _stack(plists)


def _hp_leaves(hp):
    for v in hp.values():
        yield from (_hp_leaves(v) if isinstance(v, dict) else (v,))


def init_batch(sched, batch: int, device=None, hp: Optional[Dict[str, Any]] = None) -> Any:
    """The state of ``batch`` runs: ``init_with_hp(sched, device, hp)`` with
    every tensor leaf but the hyper-parameters repeated along a new leading
    (B,) axis.  ``hp`` is ``None`` (the scheduler's own values), a
    ``params()`` dict of 0-d values shared by every run, or a
    ``stack_params`` grid of (B,) values, one a run."""
    dev = resolve_device(device)
    if hp:
        hp = hp_tensors(hp, dev)
        bad = [tuple(v.shape) for v in _hp_leaves(hp) if v.dim() and tuple(v.shape) != (batch,)]
        if bad:
            raise ValueError(f"init_batch: hyper-parameters of shape {bad}; a batch of "
                             f"{batch} takes 0-d or ({batch},) values")

    def rows(state):
        return type(state)(*[
            v if f == "hp" else rows(v) if isinstance(v, tuple) and hasattr(v, "_fields")
            else v.unsqueeze(0).repeat(batch, *([1] * v.dim()))
            for f, v in zip(state._fields, state)])

    return rows(init_with_hp(sched, dev, hp))


_MAX_SUPER_ARMS = 200_000


def combinations_array(n: int, m: int) -> np.ndarray:
    """All C(n, m) combinations of channel indices, in ``itertools`` order
    (so super-arm indices match the JAX package's) — a static (C, M) int32
    table.  M-Exp3 enumerates super-arms explicitly; an exponential
    blow-up is refused."""
    c = comb(n, m)
    if c > _MAX_SUPER_ARMS:
        raise ValueError(
            f"C({n},{m}) = {c} super-arms exceeds the M-Exp3 enumeration limit "
            f"({_MAX_SUPER_ARMS}); use GLR-CUCB for systems of this scale "
            "(the paper draws the same conclusion in Sec. VI)."
        )
    return np.asarray(list(itertools.combinations(range(n), m)), dtype=np.int32)


def scatter_rows(n: int, channels: torch.Tensor, values) -> torch.Tensor:
    """The (..., N) f32 rows holding ``values`` at ``channels`` (..., M)
    and 0 elsewhere: ``zeros(N).at[channels].set(values)``.  A channel that
    repeats in a row (M > N) carries the same value at each of its places,
    so the plain scatter is deterministic on every device."""
    out = torch.zeros(channels.shape[:-1] + (n,), dtype=torch.float32, device=channels.device)
    if not isinstance(values, torch.Tensor):
        return out.scatter(-1, channels, float(values))
    return out.scatter(-1, channels, values.to(torch.float32))


def rotate_assignment(channels_sorted: torch.Tensor, t, m: int) -> torch.Tensor:
    """Alg. 2 line 10: player j takes the ((j + t) mod M)-th best channel.
    ``channels_sorted`` is (..., K) with K = M, or K = N < M when M > N
    (more clients than channels): a position past the last entry takes the
    last entry, as JAX's gather clamps an out-of-range index (the same bits
    at M <= N).  ``t`` is an int, or with (B, K) a (B,) tensor: each row
    rotates by its own round."""
    last = channels_sorted.shape[-1] - 1
    j = torch.arange(m, device=channels_sorted.device)
    if isinstance(t, torch.Tensor):
        pos = (j + t[..., None].to(torch.int64)) % m
        return channels_sorted.gather(-1, pos.clamp_max(last))
    return channels_sorted[..., ((j + t) % m).clamp_max(last)]
