"""Optimizers as (init, update) pure functions, optax style.

Twin of ``repro/optim/optimizers.py``.  States are dicts of tensors keyed
like the parameter dict; moments are f32 whatever the parameter's dtype,
and there are no f32 master weights (``apply_updates`` adds an f32 update
to the parameter and rounds back to its dtype, as the JAX package does).
The arithmetic is JAX's op for op: each leaf cast to f32 first, the
global-norm clip summing the leaves' squares in JAX's leaf order (the
sorted keys of the flat dict), the bias corrections ``b ** count`` in f32.
A scalar that divides is made on the tensor's device (``full_like``):
torch turns ``number / tensor`` into a reciprocal times the number.

AdamW also has ``step_``, which writes the new moments and parameters into
the given state's and parameters' tensors (the step ``make_fl_train_step``
takes with ``donate=True``, the twin of donating them to a jitted JAX
step): the same arithmetic leaf for leaf, so the same bits, with one copy
of the moments and parameters held instead of two, a large leaf stepped a
slice at a time.  A leaf of more than ``SLICE_ELEMENTS`` elements adds its
slices' sums of squares to the clip's norm (elsewhere one sum a leaf, as
JAX takes it), in both steps.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)
    step_: Optional[Callable[[Any, Any, Any], Any]] = None   # (grads, state, params) -> state


def _zeros_f32(params: Params) -> Params:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return _zeros_f32(params)

    def update(grads, state, params):
        if momentum == 0.0:
            return {k: -lr * g.float() for k, g in grads.items()}, state
        new_m = {k: momentum * state[k] + g.float() for k, g in grads.items()}
        if nesterov:
            upd = {k: -lr * (momentum * new_m[k] + g.float()) for k, g in grads.items()}
        else:
            upd = {k: -lr * m for k, m in new_m.items()}
        return upd, new_m

    return Optimizer(init, update)


def adamw(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: Optional[float] = 1.0,
) -> Optimizer:
    """AdamW with global-norm clipping; moments in f32 regardless of param dtype."""

    def init(params):
        some = next(iter(params.values()))
        return {
            "mu": _zeros_f32(params),
            "nu": _zeros_f32(params),
            "count": torch.zeros((), dtype=torch.int32, device=some.device),
        }

    def common(grads, state):
        """The leaves' keys in JAX's leaf order (the sorted keys of a flat
        dict), the global-norm clip's scale and the bias corrections."""
        keys = sorted(grads)
        scale = None
        if grad_clip is not None:
            sq = sum(_square_sum(grads[k]) for k in keys)
            gnorm = torch.sqrt(sq)
            scale = torch.clamp(torch.full_like(gnorm, grad_clip) / gnorm.clamp_min(1e-9),
                                max=1.0)
        cnt = state["count"] + 1
        return keys, scale, 1 - b1 ** cnt.float(), 1 - b2 ** cnt.float()

    def moments(g, mu, nu, p, scale, bc1, bc2):
        """(new mu, new nu, update) of a leaf, or of a slice of one."""
        g = g.float()
        if scale is not None:
            g = g * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        u = -lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        if weight_decay:
            u = u - lr * weight_decay * p.float()
        return mu, nu, u

    def update(grads, state, params):
        keys, *c = common(grads, state)
        mu, nu, upd = {}, {}, {}
        for k in keys:       # a leaf's f32 temporaries go before the next one's
            mu[k], nu[k], upd[k] = moments(grads[k], state["mu"][k], state["nu"][k],
                                           params[k], *c)
        return upd, {"mu": mu, "nu": nu, "count": state["count"] + 1}

    def step_(grads, state, params):
        """``update`` then ``apply_updates``, written into ``state``'s moments
        and ``params``' tensors; returns the new state (the same tensors).
        A leaf is stepped in slices (``_slices``): the arithmetic is
        elementwise, so the bits are ``update``'s, and its f32 temporaries
        are a slice's, not the leaf's."""
        keys, *c = common(grads, state)
        for k in keys:
            for sl in _slices(params[k]):
                mu, nu, u = moments(grads[k][sl], state["mu"][k][sl], state["nu"][k][sl],
                                    params[k][sl], *c)
                state["mu"][k][sl].copy_(mu)
                state["nu"][k][sl].copy_(nu)
                params[k][sl].copy_(_applied(params[k][sl], u))
        return {"mu": state["mu"], "nu": state["nu"], "count": state["count"] + 1}

    return Optimizer(init, update, step_)


SLICE_ELEMENTS = 1 << 26       # a donated step's f32 temporaries: at most 256 MiB each


def _slices(t: torch.Tensor):
    """Indices of ``t``'s slices of at most ``SLICE_ELEMENTS`` elements each
    (the whole tensor when it is no larger), in row-major order: single
    entries of the leading axes, then ranges of the first axis whose
    trailing axes fit (an (L, E, d, f) stack of experts: one layer's expert
    at a time, or a few of them)."""
    if t.numel() <= SLICE_ELEMENTS:
        return [...]
    shape = t.shape
    axis, inner = len(shape) - 1, 1
    while axis > 0 and inner * shape[axis] <= SLICE_ELEMENTS:
        inner *= shape[axis]
        axis -= 1
    rows = max(1, SLICE_ELEMENTS // inner)
    outer = itertools.product(*(range(n) for n in shape[:axis]))
    return [lead + (slice(i, i + rows),) for lead in outer for i in range(0, shape[axis], rows)]


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """The sum of a gradient's squares in f32, as JAX's clip takes it: one
    sum of the leaf cast to f32 up to ``SLICE_ELEMENTS`` elements; a larger
    leaf's slices' sums added in order (its f32 copy is a slice's)."""
    parts = _slices(g)
    if len(parts) == 1:
        g = g.float()
        return torch.sum(g * g)
    return sum(torch.sum(x * x) for x in (g[sl].float() for sl in parts))


def _applied(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return (p.float() + u).to(p.dtype)


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: _applied(p, updates[k]) for k, p in params.items()}
