"""Federated data pipeline: per-client mini-batch streams (numpy only; a
copy of ``FederatedLoader`` and ``BatchedFederatedLoader`` from
``repro/data/pipeline.py``).

Each client draws mini-batches from its own (non-IID) shard.  The loader
yields stacked ``(M, E, B, ...)`` arrays: one FL round's E local steps for
every client.  The batched loader advances one such stream a seed in
lockstep, the input of ``repro_torch.sim.simulate_fl_batch``.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np


class FederatedLoader:
    def __init__(
        self,
        client_x: np.ndarray,       # (M, n, ...)
        client_y: np.ndarray,       # (M, n)
        batch_size: int,
        local_epochs: int = 1,
        seed: int = 0,
    ):
        self.cx = client_x
        self.cy = client_y
        self.batch = batch_size
        self.e = local_epochs
        self.rng = np.random.default_rng(seed)
        self.m, self.n = client_y.shape

    def next_round(self) -> Tuple[np.ndarray, np.ndarray]:
        """(x (M, E, B, ...), y (M, E, B)) — E local steps per client."""
        idx = self.rng.integers(0, self.n, size=(self.m, self.e, self.batch))
        gather = np.arange(self.m)[:, None, None]
        return self.cx[gather, idx], self.cy[gather, idx]

    def next_rounds(self, r: int) -> Tuple[np.ndarray, np.ndarray]:
        """(x (R, M, E, B, ...), y (R, M, E, B)) — R rounds stacked (same
        draws as R ``next_round``s)."""
        idx = self.rng.integers(0, self.n, size=(r, self.m, self.e, self.batch))
        gather = np.arange(self.m)[None, :, None, None]
        return self.cx[gather, idx], self.cy[gather, idx]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_round()


class BatchedFederatedLoader:
    """B per-seed ``FederatedLoader`` streams advancing in lockstep.

    ``next_rounds(r)`` returns ``(x (B, R, M, E, Bsz, ...), y (B, R, M, E,
    Bsz))``; slice ``b`` is the draw of ``FederatedLoader(...,
    seed=seeds[b])`` over ``r`` rounds, bit for bit.
    """

    def __init__(
        self,
        client_x: np.ndarray,       # (M, n, ...)
        client_y: np.ndarray,       # (M, n)
        batch_size: int,
        local_epochs: int = 1,
        seeds: Sequence[int] = (0,),
    ):
        self.loaders = [FederatedLoader(client_x, client_y, batch_size, local_epochs, seed=s)
                        for s in seeds]
        self.seeds = tuple(seeds)

    @property
    def n_seeds(self) -> int:
        return len(self.loaders)

    def next_round(self) -> Tuple[np.ndarray, np.ndarray]:
        """(x (B, M, E, Bsz, ...), y (B, M, E, Bsz)): one round a seed."""
        xs, ys = zip(*(ld.next_round() for ld in self.loaders))
        return np.stack(xs), np.stack(ys)

    def next_rounds(self, r: int) -> Tuple[np.ndarray, np.ndarray]:
        """(x (B, R, M, E, Bsz, ...), y (B, R, M, E, Bsz)): R rounds a seed."""
        xs, ys = zip(*(ld.next_rounds(r) for ld in self.loaders))
        return np.stack(xs), np.stack(ys)
