"""The port's device rule.

Entry points run on the card: with no ``device`` given they take
``cuda``, and they raise when CUDA is absent instead of moving to the CPU
silently.  The CPU is used only when the caller asks for it
(``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``, which
    must then be available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)
