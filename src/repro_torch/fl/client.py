"""Client-side local training (Step 2, Eq. 5).

``local_sgd`` runs E mini-batch SGD steps from the received global model
and returns the cumulative update  G~ = (w^0 - w^E) / eta  (Eq. 6).  It is
a plain function of tensors built on ``torch.func``, so the server runtime
vmaps it over all clients.  Twin of ``repro/fl/client.py``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def local_sgd(
    loss_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor], torch.Tensor],
    params: Dict[str, torch.Tensor],
    batches_x: torch.Tensor,     # (E, B, ...)
    batches_y: torch.Tensor,     # (E, B)
    lr: float,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Returns (cumulative update G~ [same dict as params], last local loss)."""
    grad_and_value = torch.func.grad_and_value(loss_fn)
    w, loss = params, None
    for e in range(batches_x.shape[0]):
        g, loss = grad_and_value(w, batches_x[e], batches_y[e])
        w = {k: w[k] - lr * g[k] for k in w}
    g_tilde = {k: (params[k] - w[k]) / lr for k in params}
    return g_tilde, loss
