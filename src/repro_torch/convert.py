"""Carry weights and state between the JAX package and the port.

The JAX side hands over numpy arrays (``np.array(jax_array)``), or any
object whose fields are array-likes — e.g. a JAX ``GLRCUCBState``, which is
read by attribute name without importing JAX.  The functions here build
the port's objects from them on a device; ``to_numpy`` goes back.  Array
dtypes are kept (f32 counts stay f32, int32 ``tau`` stays int32, bf16
weights stay bf16, bit for bit).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.aggregation import Aggregator, registered_aggregators
from repro_torch.core.bandits import (
    GLRCUCB,
    AoIAware,
    AoIAwareState,
    ChannelAwareAsync,
    ChannelAwareState,
    GLRCUCBState,
    LyapunovSched,
    LyapunovState,
    MExp3,
    MExp3State,
    RandomScheduler,
    RandomState,
    RoundRobinScheduler,
    RRState,
)
from repro_torch.core.channels.base import FORMS, ChannelEnv
from repro_torch.core.contribution import ContributionBuffer
from repro_torch.core.faults import FaultProcess, registered_faults
from repro_torch.core.matching import MatcherState
from repro_torch.device import resolve_device
from repro_torch.fl.round import AsyncFLState
from repro_torch.launch.steps import FLScaleState, TrainState


def tensor(x, device=None) -> torch.Tensor:
    """A copy of array-like ``x`` as a tensor on ``device``.  A bf16 array
    (numpy dtype ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    refuses) goes across through its bits."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(resolve_device(device))
    return torch.from_numpy(a).to(resolve_device(device))


def params(src: Mapping[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """A parameter dict (same keys) on ``device``."""
    return {k: tensor(v, device) for k, v in src.items()}


def model_params(src: Mapping[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """A JAX model's flat parameter dict (``{path: array}``, the layer stack
    under ``blocks/`` with its leading L, leading dense layers under
    ``layers/NN/``) as the port's, on ``device``: the same keys, shapes and
    dtypes, bf16 bit for bit."""
    return params(src, device)


def channel_env(form: str, means, breaks, table, score_kind: str = "ucb",
                device=None, react=None) -> ChannelEnv:
    """A ``ChannelEnv`` from the JAX env's canonical leaves (``react``: the
    reactive form's (4,) or (B, 4) coefficients; None gives the open-loop
    forms' empty placeholder)."""
    dev = resolve_device(device)
    return ChannelEnv(form, tensor(means, dev).to(torch.float32),
                      tensor(breaks, dev).to(torch.int64),
                      tensor(table, dev).to(torch.float32), score_kind,
                      None if react is None else tensor(react, dev).to(torch.float32))


def env(src, device=None) -> ChannelEnv:
    """The port's ``ChannelEnv`` for a JAX one of any form, unbatched or
    stacked (a JAX ``stack_envs`` result, leading (B,) axis on every leaf),
    read by attribute (``form``, ``means``, ``breaks``, ``table``,
    ``score_kind``, ``react``)."""
    if src.form not in FORMS:
        raise ValueError(f"convert.env: the port has no {src.form!r} form")
    return channel_env(src.form, np.array(src.means), np.array(src.breaks),
                       np.array(src.table), src.score_kind, device, np.array(src.react))


def hparams(src: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """A JAX ``params()`` dict, or a ``stack_params`` grid of (G,) leaves, as
    f32 tensors on ``device``; a wrapped policy's nested dict stays nested."""
    return {k: hparams(v, device) if isinstance(v, Mapping)
            else tensor(np.array(v, dtype=np.float32), device) for k, v in src.items()}


def _get(src, f):
    """Field ``f`` of a state: an attribute, or a key of a dict (the form
    ``to_numpy`` gives)."""
    return src[f] if isinstance(src, Mapping) else getattr(src, f)


def _fields(cls, src, device, **nested):
    return cls(**{f: nested[f] if f in nested else tensor(_get(src, f), device)
                  for f in cls._fields})


def _hp(src, device):
    """A state's ``hp`` dict on ``device``; a nested dict stays nested."""
    return {k: _hp(v, device) if isinstance(v, Mapping) else tensor(v, device)
            for k, v in src.items()}


def glr_cucb_state(src, device=None) -> GLRCUCBState:
    """A ``GLRCUCBState`` from an object with the same fields."""
    return _fields(GLRCUCBState, src, device, hp=_hp(_get(src, "hp"), device))


_STATES = {GLRCUCB: GLRCUCBState, MExp3: MExp3State, RandomScheduler: RandomState,
           RoundRobinScheduler: RRState, ChannelAwareAsync: ChannelAwareState,
           LyapunovSched: LyapunovState}


def sched_state(scheduler, src, device=None):
    """The port's state of ``scheduler`` (a port policy) from the JAX state
    of its twin: a JAX ``NamedTuple`` of arrays or the dict of numpy arrays
    ``to_numpy`` gives.  AoI-Aware's nested base state and ``hp`` come
    across with it; integer leaves keep their dtype."""
    if isinstance(scheduler, AoIAware):
        return _fields(AoIAwareState, src, device,
                       base=sched_state(scheduler.base, _get(src, "base"), device),
                       hp=_hp(_get(src, "hp"), device))
    cls = _STATES.get(type(scheduler))
    if cls is None:
        raise ValueError(f"convert.sched_state: no port state for {type(scheduler).__name__}")
    nested = {"hp": _hp(_get(src, "hp"), device)} if "hp" in cls._fields else {}
    return _fields(cls, src, device, **nested)


def matcher_state(src, device=None) -> MatcherState:
    return _fields(MatcherState, src, device)


def contribution_buffer(src, device=None) -> ContributionBuffer:
    return _fields(ContributionBuffer, src, device)


def async_fl_state(src, device=None, scheduler=None) -> AsyncFLState:
    """An ``AsyncFLState`` from the JAX trainer's state (its scheduler state
    and fault-schedule carry included), one run's or a batch's (a JAX
    ``init_batch`` / ``simulate_fl_batch`` state: every leaf (B, ...), the
    round index one a run, which must agree: the port's is shared).
    ``scheduler`` is the port's policy (default: the state is GLR-CUCB's)."""
    sched = (glr_cucb_state(src.sched_state, device) if scheduler is None
             else sched_state(scheduler, src.sched_state, device))
    t = np.unique(np.array(src.t))
    if t.size != 1:
        raise ValueError(f"convert.async_fl_state: the runs are at rounds {t.tolist()}; a "
                         "port batch shares one round index")
    return _fields(AsyncFLState, src, device,
                   params=params(src.params, device),
                   contrib_buf=contribution_buffer(src.contrib_buf, device),
                   sched_state=sched,
                   matcher_state=matcher_state(src.matcher_state, device),
                   t=int(t[0]))


def optimizer_state(src, device=None):
    """An optimizer state from the JAX one: AdamW's ``{"mu", "nu", "count"}``
    (moments keyed like the parameters, ``count`` int32), SGD's momentum
    dict, or SGD's empty ``()`` without momentum."""
    if isinstance(src, tuple) and not src:
        return ()
    if set(src) == {"mu", "nu", "count"}:
        return {"mu": params(src["mu"], device), "nu": params(src["nu"], device),
                "count": tensor(src["count"], device)}
    return params(src, device)


def fl_scale_state(src, device=None, scheduler=None) -> FLScaleState:
    """The training step's ``FLScaleState`` from the JAX one (its scheduler
    state GLR-CUCB's unless ``scheduler``, the port's policy, says; the
    round index as a Python int)."""
    sched = (glr_cucb_state(src.sched_state, device) if scheduler is None
             else sched_state(scheduler, src.sched_state, device))
    return _fields(FLScaleState, src, device, sched_state=sched,
                   matcher_state=matcher_state(src.matcher_state, device),
                   t=int(np.array(src.t)))


def train_state(src, device=None, scheduler=None) -> TrainState:
    """A JAX ``TrainState`` (``make_train_state_init`` or a step's output)
    as the port's: the parameters through ``model_params``, the optimizer
    state through ``optimizer_state``, the FL state through
    ``fl_scale_state``."""
    return TrainState(params=model_params(src.params, device),
                      opt_state=optimizer_state(src.opt_state, device),
                      fl=fl_scale_state(src.fl, device, scheduler))


def _instance(registry, src, label):
    """The port's instance of ``src``'s family, with ``src``'s knob values
    read as plain attributes (nested ``FaultProcess`` knobs converted)."""
    family = getattr(type(src), "FAMILY", None)
    if family not in registry:
        raise ValueError(f"{label}: no port family for {type(src).__name__} ({family!r})")
    cls = registry[family]
    knobs = {}
    for f in dataclasses.fields(cls):
        if f.init:
            v = getattr(src, f.name)
            knobs[f.name] = fault(v) if hasattr(type(v), "FAMILY") else v
    return cls(**knobs)


def fault(src) -> FaultProcess:
    """The port's ``FaultProcess`` for a JAX one (same family and knobs;
    ``burst`` nests its base family)."""
    return _instance(registered_faults(), src, "convert.fault")


def aggregator(src) -> Aggregator:
    """The port's ``Aggregator`` for a JAX one (same family and knobs)."""
    return _instance(registered_aggregators(), src, "convert.aggregator")


def to_numpy(obj):
    """Tensors to numpy arrays, through dicts and ``NamedTuple`` states
    (returned as dicts of their fields)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {f: to_numpy(getattr(obj, f)) for f in obj._fields}
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    return obj
