"""Asynchronous FL runtime (Sec. II-A Steps 1-4): the dense trainer and
the sparse client axis (``SparseAsyncFLTrainer``, N = 10^5 clients)."""
from repro_torch.fl.client import local_sgd
from repro_torch.fl.round import AsyncFLConfig, AsyncFLState, AsyncFLTrainer, dispatch_aggregate
from repro_torch.fl.sparse import SparseAsyncFLTrainer, SparseFLConfig, SparseFLState

__all__ = ["local_sgd", "AsyncFLConfig", "AsyncFLState", "AsyncFLTrainer", "dispatch_aggregate",
           "SparseFLConfig", "SparseFLState", "SparseAsyncFLTrainer"]
