"""Synthetic datasets (numpy only; a copy of ``repro/data/synthetic.py``).

* ``SyntheticClassification`` — a CIFAR-like surrogate: class-conditioned
  Gaussian clusters on a learnable-scale manifold, difficult enough that a
  small MLP/CNN shows a real convergence curve (the paper's Fig. 3 metric)
  while staying dependency-free and CPU-fast.
* ``synthetic_lm_batches`` — endless Zipfian token batches for the model
  zoo's training path: the JAX package's tokens bit for bit for a seed.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticClassification:
    """Class-conditional Gaussian mixture with per-class subspaces."""

    n_samples: int
    n_classes: int = 10
    dim: int = 64
    noise: float = 0.9
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # class means on a scaled simplex + low-rank within-class structure
        self.means = rng.normal(size=(self.n_classes, self.dim)).astype(np.float32)
        self.subspaces = rng.normal(
            size=(self.n_classes, self.dim, 8)).astype(np.float32) / np.sqrt(8)
        labels = rng.integers(0, self.n_classes, self.n_samples)
        coeff = rng.normal(size=(self.n_samples, 8)).astype(np.float32)
        eps = rng.normal(size=(self.n_samples, self.dim)).astype(np.float32)
        self.x = (
            self.means[labels]
            + np.einsum("nk,ndk->nd", coeff, self.subspaces[labels])
            + self.noise * eps
        ).astype(np.float32)
        self.y = labels.astype(np.int32)

    def split(self, frac: float = 0.9):
        n = int(len(self.y) * frac)
        return (self.x[:n], self.y[:n]), (self.x[n:], self.y[n:])


def make_federated_classification(
    n_clients: int,
    samples_per_client: int = 512,
    n_classes: int = 10,
    dim: int = 64,
    alpha: float = 0.5,
    seed: int = 0,
):
    """Dirichlet-non-IID federated classification data.

    Returns (client_x (M, n, d), client_y (M, n), test_x, test_y, proxy_x,
    proxy_y) — ``proxy`` is the small server-side batch used by Eq. 35.
    """
    from repro_torch.data.dirichlet import dirichlet_partition

    total = n_clients * samples_per_client * 2
    ds = SyntheticClassification(total, n_classes=n_classes, dim=dim, seed=seed)
    (train_x, train_y), (test_x, test_y) = ds.split(0.9)
    parts = dirichlet_partition(train_y, n_clients, alpha, seed=seed,
                                min_per_client=samples_per_client)
    cx, cy = [], []
    for idx in parts:
        take = np.resize(idx, samples_per_client)   # equalize client sizes
        cx.append(train_x[take])
        cy.append(train_y[take])
    proxy = slice(0, min(256, len(test_y)))
    return (
        np.stack(cx), np.stack(cy), test_x, test_y, test_x[proxy], test_y[proxy],
    )


def synthetic_lm_batches(
    batch: int, seq_len: int, vocab: int, seed: int = 0,
) -> Iterator[np.ndarray]:
    """Endless Zipfian token batches with short-range repetition structure."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq_len), p=probs)
        # inject learnable bigram structure: even positions copy with shift
        toks[:, 2::2] = (toks[:, 1:-1:2] * 31 + 7) % vocab
        yield toks.astype(np.int32)
