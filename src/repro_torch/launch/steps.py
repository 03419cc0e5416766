"""Serving steps: prefill and one greedy decode step.

Twin of ``make_prefill_step`` and ``make_serve_step`` of
``repro/launch/steps.py``.  The FL training step at LLM scale
(``make_fl_train_step``) comes with the training slice.  The prefill does
not fill the decode cache, as in the JAX package: the two steps are
driven side by side.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import Model


def make_prefill_step(model: Model) -> Callable:
    def prefill(params, batch):
        logits, _ = model.apply(params, batch, last_only=not model.cfg.is_encoder)
        return logits
    return prefill


def make_serve_step(model: Model, window: int = 0) -> Callable:
    def serve(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens, window=window or None)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, cache
    return serve
