"""Age-of-Information accounting (Sec. II-A, Eq. 4/8; Sec. V, Eq. 36-38).

AoI of client ``i`` at round ``t`` is ``a_i(t) = t - h_i(t)`` where
``h_i(t)`` is the last round in which the client's update reached the
server.  The recursive form (Eq. 8) is::

    a_i(t) = 1              if i in S_t   (success this round)
           = a_i(t-1) + 1   otherwise

Twin of ``repro/core/aoi.py``.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def init_aoi(n_clients: int, device=None) -> torch.Tensor:
    """Paper convention: a_i(0) = 1 for all clients."""
    return torch.ones((n_clients,), dtype=torch.float32, device=resolve_device(device))


def update_aoi(aoi: torch.Tensor, success: torch.Tensor) -> torch.Tensor:
    """Eq. 8.  ``success``: (M,) bool/0-1 mask of clients in S_t."""
    return torch.where(success.to(torch.bool), 1.0, aoi + 1.0)


def mean_aoi(aoi: torch.Tensor) -> torch.Tensor:
    """The mean over the clients (last axis), correctly rounded to f32 on
    every device.  On CUDA torch's f32 ``mean`` multiplies by 1/M in f32,
    which parts from the CPU's (and JAX's) division by an ulp on some AoI
    vectors (62 / 20 gives 3.1000001); an f64 mean of integer AoIs is
    within an f64 ulp of k / M, which is never an f32 rounding midpoint,
    so its one rounding to f32 is the correctly rounded quotient."""
    return aoi.mean(dim=-1, dtype=torch.float64).to(torch.float32)


def aoi_variance(aoi: torch.Tensor) -> torch.Tensor:
    """Eq. 37: V_t = sum_i (a_i - mean)^2 (sum, not mean — as in the paper),
    over the last axis (the clients): () for (M,), (B,) for (B, M) rows."""
    return ((aoi - aoi.mean(dim=-1, keepdim=True)) ** 2).sum(dim=-1)


def normalized_aoi_variance(v_t: torch.Tensor, v_max: torch.Tensor) -> torch.Tensor:
    """Eq. 36: V~_t = V_t / max_{0<tau<t} V_tau  (``v_max`` is the running max)."""
    return torch.where(v_max > 0, v_t / v_max, 0.0)


def normalized_aoi(aoi: torch.Tensor, a_max: torch.Tensor) -> torch.Tensor:
    """Eq. 38: a~_i(t) = a_i(t) / max historical AoI across clients/rounds;
    ``a_max`` is () for (M,) ``aoi``, (B,) for (B, M) rows."""
    a_max = a_max[..., None]
    return torch.where(a_max > 0, aoi / a_max, 0.0)


def expected_aoi_from_means(mu_seq: torch.Tensor) -> torch.Tensor:
    """Lemma 2: E[a_i(t)] = sum_{tau>=0} prod_{k<tau} (1 - mu_{s_i(t-k)}).

    ``mu_seq``: (H,) success means of the channels scheduled to the client
    over the last H rounds, most recent first; the series is truncated at
    H terms.  The tau = 0 term is the empty product, a leading 1.
    """
    return 1.0 + torch.cumprod(1.0 - mu_seq, dim=0).sum()


def oracle_stationary_aoi(mu_best: torch.Tensor) -> torch.Tensor:
    """Closed form for a fixed channel of mean mu: E[AoI] = 1/mu (Eq. 59)."""
    return 1.0 / mu_best.clamp_min(1e-12)
