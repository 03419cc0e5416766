"""Marginal-contribution estimation (Sec. V, Eq. 32-35 and 41-43).

The Shapley value (Eq. 32) is approximated with the FedCE-style estimator

    C~_m = Gamma_cos * Gamma_err
    Gamma_cos = 1 - cos( grad F_m(w_t^m), grad F(w_t^{-m}) )      (Eq. 34)
    Gamma_err = E( D^_m ; w_t^{-m} )                              (Eq. 35)

where ``w^{-m}`` / ``grad F(w^{-m})`` are leave-one-out (LOO) aggregates
over a server-side buffer of the last gradient and parameter vector per
client (Eq. 41-42); the aggregation weights are the normalized
contributions (Eq. 43).  All functions take flattened (M, P) matrices, or
(B, M, P) with a leading run axis (per-client tensors (B, M)): every
reduction runs over the client or the parameter axis of its own run.
``exact_shapley`` is the ground truth the estimator is checked against.
Twin of ``repro/core/contribution.py``.
"""
from __future__ import annotations

import itertools
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.device import resolve_device

_EPS = 1e-12


class ContributionBuffer(NamedTuple):
    """Server-side buffer (Eq. 41-42): last-known per-client grad + params."""

    grads: torch.Tensor     # (M, P) buffered gradient vectors
    params: torch.Tensor    # (M, P) buffered parameter vectors
    fresh: torch.Tensor     # (M,)   1.0 once a client has ever reported


def init_buffer(n_clients: int, n_params: int, device=None, lead=()) -> ContributionBuffer:
    """An empty buffer; ``lead`` = (B,) gives one a run."""
    dev = resolve_device(device)
    return ContributionBuffer(
        grads=torch.zeros(lead + (n_clients, n_params), device=dev),
        params=torch.zeros(lead + (n_clients, n_params), device=dev),
        fresh=torch.zeros(lead + (n_clients,), device=dev),
    )


def update_buffer(buf: ContributionBuffer, success: torch.Tensor,
                  new_grads: torch.Tensor, new_params: torch.Tensor) -> ContributionBuffer:
    s = success.to(torch.float32)[..., None]
    return ContributionBuffer(
        grads=buf.grads * (1.0 - s) + new_grads * s,
        params=buf.params * (1.0 - s) + new_params * s,
        fresh=torch.maximum(buf.fresh, success.to(torch.float32)),
    )


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    num = (a * b).sum(dim=-1)
    den = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1)
    return num / den.clamp_min(_EPS)


def loo_aggregates(buf: ContributionBuffer, weights: torch.Tensor):
    """Leave-one-out weighted aggregates for every client at once:
    g^{-m} = (sum_i zeta_i g_i - zeta_m g_m) / (1 - zeta_m).
    Returns (grads^{-m} (M, P), params^{-m} (M, P)), or (B, M, P)."""
    w = (weights * buf.fresh)[..., None]                 # ignore never-seen clients
    wsum = w.sum(dim=-2, keepdim=True).clamp_min(_EPS)
    g_tot = (w * buf.grads).sum(dim=-2, keepdim=True)
    p_tot = (w * buf.params).sum(dim=-2, keepdim=True)
    denom = (wsum - w).clamp_min(_EPS)
    return (g_tot - w * buf.grads) / denom, (p_tot - w * buf.params) / denom


def marginal_contribution(buf: ContributionBuffer, weights: torch.Tensor,
                          proxy_loss_fn: Optional[Callable] = None) -> torch.Tensor:
    """C~_m = Gamma_cos(m) * Gamma_err(m) (Eq. 33).  ``proxy_loss_fn`` maps
    a flattened parameter vector to the server's proxy loss (Eq. 35); with
    None, Gamma_err = 1."""
    g_loo, p_loo = loo_aggregates(buf, weights)
    gamma_cos = 1.0 - _cosine(buf.grads, g_loo)          # Eq. 34: in [0, 2]
    if proxy_loss_fn is not None:
        loss = torch.func.vmap(proxy_loss_fn)                # Eq. 35, over the clients
        for _ in range(p_loo.dim() - 2):                     # and over the runs
            loss = torch.func.vmap(loss)
        gamma_err = loss(p_loo)
    else:
        gamma_err = torch.ones_like(gamma_cos)
    contrib = gamma_cos * gamma_err
    # never-seen clients get their run's mean contribution (uninformative prior)
    seen = buf.fresh > 0.5
    n_seen = seen.sum(dim=-1, keepdim=True).to(torch.float32).clamp_min(1.0)
    fill = torch.where(seen, contrib, 0.0).sum(dim=-1, keepdim=True) / n_seen
    fill = torch.where(seen.any(dim=-1, keepdim=True), fill, 1.0)
    return torch.where(seen, contrib, fill)


def aggregation_weights(contrib: torch.Tensor) -> torch.Tensor:
    """Eq. 43: zeta_m = C~_m / sum_l C~_l (clipped to a valid simplex point),
    over each run's clients."""
    c = contrib.clamp_min(_EPS)
    return c / c.sum(dim=-1, keepdim=True)


def exact_shapley(utility_fn: Callable[[torch.Tensor], torch.Tensor], n_clients: int,
                  device=None) -> torch.Tensor:
    """Exact Shapley values (Eq. 32) by subset enumeration — O(2^M).

    ``utility_fn`` maps an (M,) f32 0/1 membership mask on ``device``
    (default ``cuda``) to the coalition's utility U(S).  Each marginal
    ``U(S + i) - U(S)`` is taken in the utility's dtype and the weighted
    sum in Python floats, rounded once to f32, as the JAX twin does.
    Tractable for the paper's scales (M <= ~16); it validates the
    estimator (Eq. 33), and no round calls it."""
    dev = resolve_device(device)
    m = n_clients
    utils = {}

    def u(bits: int) -> torch.Tensor:
        if bits not in utils:
            mask = torch.tensor([(bits >> i) & 1 for i in range(m)], dtype=torch.float32,
                                device=dev)
            utils[bits] = utility_fn(mask)
        return utils[bits]

    values = torch.zeros((m,), dtype=torch.float32, device=dev)
    fact = math.factorial
    for i in range(m):
        acc = 0.0
        others = [j for j in range(m) if j != i]
        for r in range(m):
            w = fact(r) * fact(m - r - 1) / fact(m)
            for subset in itertools.combinations(others, r):
                bits = sum(1 << j for j in subset)
                acc += w * float(u(bits | (1 << i)) - u(bits))
        values[i] = acc
    return values
