"""Federated data pipeline: per-client mini-batch streams (a copy of
``FederatedLoader`` and ``BatchedFederatedLoader`` from
``repro/data/pipeline.py``, numpy only), and the sparse substrate's draw
on the device.

Each client draws mini-batches from its own (non-IID) shard.  The loader
yields stacked ``(M, E, B, ...)`` arrays: one FL round's E local steps for
every client.  The batched loader advances one such stream a seed in
lockstep, the input of ``repro_torch.sim.simulate_fl_batch``.

The host-side loaders precompute ``(R, M, ...)`` round data, which the
sparse substrate (``repro_torch.fl.sparse``, N = 10^5 clients) cannot
hold.  ``client_batch_indices`` / ``gather_client_batches`` draw on the
device instead: the client datasets stay resident as (N, n, ...) tensors,
and each round draws mini-batch indices for its M scheduled clients only.
A client's indices are a counter-based hash of (seed, round, client id,
epoch, step), so the same client sees the same batches whoever else is
scheduled and at whatever slot (the dense-vs-sparse parity anchor, as
JAX's ``fold_in(key, client_id)`` is there), and the CPU and the card
give the same bits: int64 tensor ops masked to 32 bits, no
``torch.Generator``, whose stream depends on the shape of the draw.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple, Union

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2^32`` for a 32-bit ``x`` (a Python int or an int64
    tensor), in 16-bit halves of ``c`` so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32(x):
    """A 32-bit avalanche mixer (the "lowbias32" constants): every input
    bit moves about half the output bits."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def client_batch_indices(
    seed: Union[int, torch.Tensor],   # the run's data seed: an int, or (B,) int64 for a batch
    t: int,                           # the round
    client_ids: torch.Tensor,         # (..., M) int: the scheduled clients
    n_examples: int,
    local_epochs: int,
    batch_size: int,
) -> torch.Tensor:
    """Per-client mini-batch indices, (..., M, E, B) int64 in
    [0, n_examples), on ``client_ids``' device.  Client ``i``'s draw is a
    function of (seed, t, i) alone, so a sparse M-client draw and a dense
    all-N one give the same indices for every shared client.  With a run
    axis ``seed`` is (B,) and ``client_ids`` (B, M).  O(M * E * B) work."""
    ids = client_ids.to(torch.int64) & _MASK32
    if isinstance(seed, torch.Tensor):
        key = _mix32(_mix32(seed.to(torch.int64).to(ids.device) & _MASK32) ^ (t & _MASK32))
        key = key[..., None]
    else:
        key = _mix32(_mix32(seed & _MASK32) ^ (t & _MASK32))
    step = torch.arange(local_epochs * batch_size, dtype=torch.int64, device=ids.device)
    h = _mix32(_mix32(ids ^ key)[..., None] ^ _mul32(step + 1, 0x9E3779B9))
    idx = (h * n_examples) >> 32                       # [0, n_examples), no modulo bias
    return idx.reshape(ids.shape + (local_epochs, batch_size))


def gather_client_batches(
    client_x: torch.Tensor,           # (N, n, ...) device-resident datasets
    client_y: torch.Tensor,           # (N, n)
    client_ids: torch.Tensor,         # (..., M) int
    idx: torch.Tensor,                # (..., M, E, B) from client_batch_indices
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x (..., M, E, B, ...), y (..., M, E, B))`` for the scheduled
    clients: only their rows of the datasets are read (O(M * E * B))."""
    rows = client_ids.to(torch.int64)[..., None, None]
    return client_x[rows, idx], client_y[rows, idx]


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
