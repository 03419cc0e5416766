"""Asynchronous FL runtime (Sec. II-A Steps 1-4)."""
from repro_torch.fl.client import local_sgd
from repro_torch.fl.round import AsyncFLConfig, AsyncFLState, AsyncFLTrainer, dispatch_aggregate

__all__ = ["local_sgd", "AsyncFLConfig", "AsyncFLState", "AsyncFLTrainer", "dispatch_aggregate"]
