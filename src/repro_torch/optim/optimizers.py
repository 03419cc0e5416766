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
of the moments and parameters held instead of two.
"""
from __future__ import annotations

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

    def leaves(grads, state, params):
        """(key, new mu, new nu, update) a leaf at a time, in JAX's leaf
        order: a leaf's f32 temporaries go before the next one's."""
        keys = sorted(grads)                     # JAX's leaf order of a flat dict
        scale = None
        if grad_clip is not None:
            sq = sum(torch.sum(g * g) for g in (grads[k].float() for k in keys))
            gnorm = torch.sqrt(sq)
            scale = torch.clamp(torch.full_like(gnorm, grad_clip) / gnorm.clamp_min(1e-9),
                                max=1.0)
        cnt = state["count"] + 1
        bc1 = 1 - b1 ** cnt.float()
        bc2 = 1 - b2 ** cnt.float()
        for k in keys:
            g = grads[k].float()
            if scale is not None:
                g = g * scale
            mu = b1 * state["mu"][k] + (1 - b1) * g
            nu = b2 * state["nu"][k] + (1 - b2) * g * g
            u = -lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            if weight_decay:
                u = u - lr * weight_decay * params[k].float()
            yield k, mu, nu, u

    def update(grads, state, params):
        mu, nu, upd = {}, {}, {}
        for k, m, v, u in leaves(grads, state, params):
            mu[k], nu[k], upd[k] = m, v, u
        return upd, {"mu": mu, "nu": nu, "count": state["count"] + 1}

    def step_(grads, state, params):
        """``update`` then ``apply_updates``, written into ``state``'s moments
        and ``params``' tensors; returns the new state (the same tensors)."""
        for k, mu, nu, u in leaves(grads, state, params):
            state["mu"][k].copy_(mu)
            state["nu"][k].copy_(nu)
            params[k].copy_(_applied(params[k], u))
        return {"mu": state["mu"], "nu": state["nu"], "count": state["count"] + 1}

    return Optimizer(init, update, step_)


def _applied(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return (p.float() + u).to(p.dtype)


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: _applied(p, updates[k]) for k, p in params.items()}
