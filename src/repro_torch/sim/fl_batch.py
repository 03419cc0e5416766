"""The batched FL engine: many runs of one trainer as one batch.

``AsyncFLTrainer.run`` trains one run.  The paper's Fig. 3/4 claims are
Monte-Carlo statements, mean and std over seeds; run serially, each seed
pays the host's cost of every small launch of a round.
``simulate_fl_batch`` trains B runs of one trainer at once, over a
leading run axis on

* the state: a batched ``AsyncFLState`` from ``trainer.init_batch`` (per-
  run models, and optionally a ``stack_params`` grid of the scheduler's
  hyper-parameters, which makes the batch a tuning axis);
* the data: (B, R, M, E, Bsz, ...) per-run rounds
  (``BatchedFederatedLoader.next_rounds``), or one (R, M, ...) stream
  shared by every run (``data_axis=None``);
* the randomness: (B, R, 2, N) uniforms and (B, R, K) fault uniforms, or
  one stream shared by every run (``uniforms_axis=None``); drawn from
  ``generator`` when not given, uniforms first;
* the env: the trainer's own, shared (``envs=None``), or a stacked env,
  one a run (``env_axis=0``: per-case scenario realizations, or equal-
  signature trainers' envs).

Each round is the trainer's own round with the run axis: every batched
operation covers the whole batch, so on the card a round launches each
Step-4 kernel (``weighted_aggregate`` or ``robust_trimmed``) and GLR-
CUCB's ``glr_step`` once for all B runs.  A batch of one run is that
run's serial loop (the run axis dropped and put back), so it equals
``trainer.run`` bit for bit on every device; each row of a larger batch
equals its serial run on its own operands (its discrete state bit for
bit, its floats to within the rounding of another summation order).
Twin of ``repro/sim/fl_batch.py``, which ``vmap``s the serial round scan;
nothing is compiled per call here, so its ``.lower`` hook has no
counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.channels import ChannelEnv, env_batch_size
from repro_torch.device import resolve_device
from repro_torch.utils.tree import tree_map


def _row(tree, i: int):
    """Run ``i`` of a batched tree: every tensor with a run axis indexed, a
    0-d tensor (a shared hyper-parameter) and a non-tensor kept."""
    return tree_map(lambda x: x[i] if isinstance(x, torch.Tensor) and x.dim() else x, tree)


def _env_row(env: ChannelEnv, i: int) -> ChannelEnv:
    return dataclasses.replace(env, means=env.means[i], breaks=env.breaks[i],
                               table=env.table[i], react=env.react[i])


def _expand(x: Optional[torch.Tensor], axis: Optional[int], batch: int):
    """A shared operand as a (B, ...) view (no copy); a mapped one as is."""
    if x is None or axis == 0:
        return x
    return x.expand(batch, *x.shape)


def simulate_fl_batch(
    trainer,
    states,
    batches_x: torch.Tensor,
    batches_y: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
    fault_uniforms: Optional[torch.Tensor] = None,
    data_axis: Optional[int] = 0,
    uniforms_axis: Optional[int] = 0,
    envs: Optional[ChannelEnv] = None,
    env_axis: Optional[int] = None,
    device=None,
) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """B runs of ``trainer`` (an ``AsyncFLTrainer``) from ``states`` (a
    batched state from ``trainer.init_batch``) over R rounds.

    ``batches_x`` (B, R, M, E, Bsz, ...) and ``batches_y`` (B, R, M, E,
    Bsz), or (R, ...) with ``data_axis=None``.  ``uniforms`` (B, R, 2, N)
    and, with faults, ``fault_uniforms`` (B, R, K), or (R, ...) with
    ``uniforms_axis=None``; without them both are drawn from ``generator``
    on the trainer's device.  ``envs`` is a stacked env (``env_axis=0``)
    or one env (``env_axis=None``); ``None`` is the trainer's env.
    ``device`` (default: the trainer's) must be the trainer's device.

    Returns ``(final_states, metrics)`` as ``trainer.run`` does, with a
    leading (B,) on every state leaf and (B, R) metrics; nothing waits on
    the device.
    """
    dev = trainer.device if device is None else resolve_device(device)
    if dev != trainer.device:
        raise ValueError(f"simulate_fl_batch: device {dev} is not the trainer's "
                         f"{trainer.device}")
    axes = {"data_axis": data_axis, "uniforms_axis": uniforms_axis, "env_axis": env_axis}
    bad = {k: a for k, a in axes.items() if a not in (0, None)}
    if bad:
        raise ValueError(f"simulate_fl_batch: an axis is 0 or None, got {bad}")
    if states.aoi.dim() != 2:
        raise ValueError("simulate_fl_batch: states must be batched (trainer.init_batch)")
    batch = int(states.aoi.shape[0])
    if envs is None:
        envs, env_axis = trainer.env, None
    if not isinstance(envs, ChannelEnv):
        raise TypeError(f"simulate_fl_batch: envs must be a ChannelEnv, got {type(envs)}; "
                        "realize a ChannelProcess first (realize_processes)")
    if (envs.leaf.dim() == 3) != (env_axis == 0):
        raise ValueError("simulate_fl_batch: env_axis=0 takes a stacked env (stack_envs), "
                         "env_axis=None one env")
    if env_axis == 0 and env_batch_size(envs) != batch:
        raise ValueError(f"simulate_fl_batch: {env_batch_size(envs)} stacked envs for a "
                         f"batch of {batch}")
    envs = envs.to(dev)

    lead = (batch,) if data_axis == 0 else ()
    if tuple(batches_x.shape[:len(lead)]) != lead:
        raise ValueError(f"simulate_fl_batch: batches_x must be ({batch}, R, ...) with "
                         f"data_axis=0, got {tuple(batches_x.shape)}")
    rounds = int(batches_x.shape[len(lead)])
    n, k = trainer.cfg.n_channels, trainer.n_fault_uniforms()
    ulead = (batch,) if uniforms_axis == 0 else ()
    if uniforms is None:
        if fault_uniforms is not None:
            raise ValueError("simulate_fl_batch: fault_uniforms without uniforms")
        uniforms = torch.rand(ulead + (rounds, 2, n), generator=generator, device=dev)
        if k:
            fault_uniforms = torch.rand(ulead + (rounds, k), generator=generator, device=dev)
    for name, x, tail in (("uniforms", uniforms, (rounds, 2, n)),
                          ("fault_uniforms", fault_uniforms, (rounds, k))):
        if x is not None and tuple(x.shape) != ulead + tail:
            raise ValueError(f"simulate_fl_batch: {name} must be {ulead + tail}, "
                             f"got {tuple(x.shape)}")

    bx = _expand(batches_x.to(dev), data_axis, batch)
    by = _expand(batches_y.to(dev), data_axis, batch)
    u = _expand(uniforms.to(dev), uniforms_axis, batch)
    fu = None if fault_uniforms is None else _expand(fault_uniforms.to(dev), uniforms_axis, batch)
    trainer._operands(states, bx, by, None, u, fu, "simulate_fl_batch")
    if batch == 1:      # one run: the serial loop on its row
        env = _env_row(envs, 0) if env_axis == 0 else envs
        state, mets = trainer._run(_row(states, 0), bx[0], by[0], u[0],
                                   None if fu is None else fu[0], env)
        state = tree_map(lambda b, s: s.unsqueeze(0) if isinstance(b, torch.Tensor) and b.dim()
                         else s, states, state)
        return state, {key: v.unsqueeze(0) for key, v in mets.items()}
    return trainer._run(states, bx, by, u, fu, envs)
