"""Dirichlet non-IID federated partitioner (Sec. VI-A, following [36]) and
its heterogeneity index; a copy of ``repro/data/dirichlet.py`` (numpy
only).

``p_k ~ Dir_M(alpha)`` per class k; proportion ``p_{k,j}`` of class-k
samples goes to client j.  ``alpha -> inf`` approaches IID; ``alpha -> 0``
gives extreme label skew.
"""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(
    labels: np.ndarray,
    n_clients: int,
    alpha: float,
    seed: int = 0,
    min_per_client: int = 2,
) -> List[np.ndarray]:
    """Return per-client index arrays partitioning ``labels``."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for k in range(n_classes):
        idx_k = np.flatnonzero(labels == k)
        rng.shuffle(idx_k)
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(idx_k)).astype(int)[:-1]
        for j, part in enumerate(np.split(idx_k, cuts)):
            client_idx[j].extend(part.tolist())
    out = []
    # ensure every client has at least a few samples (steal from the largest)
    for j in range(n_clients):
        while len(client_idx[j]) < min_per_client:
            donor = int(np.argmax([len(c) for c in client_idx]))
            client_idx[j].append(client_idx[donor].pop())
    for j in range(n_clients):
        arr = np.asarray(client_idx[j], dtype=np.int64)
        rng.shuffle(arr)
        out.append(arr)
    return out


def heterogeneity_index(parts: List[np.ndarray], labels: np.ndarray) -> float:
    """Mean total-variation distance between client label dists and the global."""
    n_classes = int(labels.max()) + 1
    global_p = np.bincount(labels, minlength=n_classes) / len(labels)
    tvs = []
    for idx in parts:
        p = np.bincount(labels[idx], minlength=n_classes) / max(len(idx), 1)
        tvs.append(0.5 * np.abs(p - global_p).sum())
    return float(np.mean(tvs))
