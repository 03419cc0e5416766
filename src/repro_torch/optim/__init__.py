"""Optimizers of the model zoo's training path, twin of ``repro/optim``."""
from repro_torch.optim.optimizers import Optimizer, adamw, sgd

__all__ = ["Optimizer", "sgd", "adamw"]
