"""Client-side local training (Step 2, Eq. 5).

``local_sgd`` runs E mini-batch SGD steps from the received global model
and returns the cumulative update  G~ = (w^0 - w^E) / eta  (Eq. 6).  It is
a plain function of tensors built on ``torch.func``, so ``local_updates``
vmaps it over all clients (and, with a leading run axis, over the runs:
each run's global model mapped, its clients mapped inside it).  Twin of
``repro/fl/client.py``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.utils.tree import tree_flatten_concat


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


def local_updates(loss_fn, params: Dict[str, torch.Tensor], batches_x: torch.Tensor,
                  batches_y: torch.Tensor, lr: float, batched: bool = False):
    """Steps 1-2 for every client: ``local_sgd`` from ``params`` on each
    client's (E, B, ...) batches, as flattened (M, P) updates G~ and (M,)
    last local losses.  With ``batched`` every operand has a leading run
    axis: params (B, ...), batches (B, M, E, B, ...) -> (B, M, P), (B, M);
    the run axis is an outer vmap around the serial round's client vmap."""
    def one_client(p, bx, by):
        g, loss = local_sgd(loss_fn, p, bx, by, lr)
        return tree_flatten_concat(g), loss

    clients = torch.func.vmap(one_client, in_dims=(None, 0, 0))
    if batched:
        clients = torch.func.vmap(clients)
    return clients(params, batches_x, batches_y)
