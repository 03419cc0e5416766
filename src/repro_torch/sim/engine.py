"""The batched AoI-regret engine: many runs of one scheduler as one batch.

``simulate_aoi_regret`` runs ONE (scheduler, env, randomness) triple.  The
paper's figures are Monte-Carlo sweeps: the same scheduler over many seeds,
sampled envs and hyper-parameter grids.  ``simulate_aoi_regret_batch``
runs B of them at once, over a leading run axis on

* the env: a stacked ``ChannelEnv`` (``stack_envs``, ``env_axis=0``) or
  one env shared by every run (``env_axis=None``);
* the randomness: (B, T, 2, N) uniforms, one (T, 2, N) stream a run
  (``uniforms_axis=0``), or one stream shared by every run (``None``);
* the hyper-parameters: a ``stack_params`` grid of (B,) values
  (``hp_axis=0``), or one ``params()`` dict shared by every run
  (``hparams`` with ``hp_axis=None``; ``hparams=None`` takes the
  scheduler's own values).

At least one axis must be 0.  Without ``uniforms`` they are drawn from
``generator`` on the run's device.  Twin of ``repro/sim/engine.py``, which
``vmap``s the serial core over the same three axes and compiles it once a
bucket; here nothing is compiled per call, so its ``.lower`` hook has no
counterpart.

Routes, as in ``simulate_aoi_regret``: on the card a GLR-CUCB batch is
one launch of the ``regret_scan`` kernel, one thread block a run; every
other batch (the other policies, a batch ``refusal`` rejects, every CPU
run) takes the batched per-round loop, each round one batched
``select``/``update`` over the runs.  The result says which
(``out["route"]``).  Each run's result equals the serial run on that
run's env, uniforms and hyper-parameters bit for bit (the variance sums at
rtol 1e-6 where M > 2), so a batch of 1 is the serial run.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.bandits.base import init_batch
from repro_torch.core.channels import ChannelEnv, ChannelProcess, env_batch_size
from repro_torch.core.regret import IMPLS, _simulate_rounds
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import regret_scan as _rs


def _hp_rows(hp) -> set:
    """The leading sizes of a stacked hyper-parameter dict's leaves."""
    return {n for v in hp.values() for n in (_hp_rows(v) if isinstance(v, dict)
                                             else {torch.as_tensor(v).shape[:1]})}


def simulate_aoi_regret_batch(
    scheduler,
    envs: ChannelEnv,
    horizon: int,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
    collect_curve: bool = True,
    env_axis: Optional[int] = 0,
    uniforms_axis: Optional[int] = 0,
    hparams: Optional[Dict[str, Any]] = None,
    hp_axis: Optional[int] = None,
    return_state: bool = False,
    device=None,
    impl: Optional[str] = None,
) -> Dict[str, Any]:
    """B runs of ``scheduler`` against the oracle for ``horizon`` rounds.

    ``envs`` is a stacked ``ChannelEnv`` (``env_axis=0``) or one env
    (``env_axis=None``); a ``ChannelProcess`` must be realized first.
    ``uniforms`` is (B, T, 2, N) (``uniforms_axis=0``) or (T, 2, N)
    (``None``), else drawn from ``generator`` on ``device`` (default
    ``cuda``).  ``hparams`` is a ``stack_params`` grid (``hp_axis=0``) or
    a ``params()`` dict (``hp_axis=None``).  ``impl`` picks the route as in
    ``simulate_aoi_regret``: ``"scan"`` (raises where ``refusal`` refuses
    the batch), ``"rounds"``, or ``None`` (the scan wherever it applies).

    Returns the dict of ``simulate_aoi_regret`` with a leading (B,) axis on
    every tensor (``final_sched_state`` with ``return_state``), and
    ``route``, ``"scan"`` or ``"rounds"``.
    """
    if impl not in IMPLS:
        raise ValueError(f"simulate_aoi_regret_batch: unknown impl {impl!r}; use one of {IMPLS}")
    axes = {"env_axis": env_axis, "uniforms_axis": uniforms_axis, "hp_axis": hp_axis}
    if all(a is None for a in axes.values()):
        raise ValueError("simulate_aoi_regret_batch: nothing to batch over "
                         "(env_axis, uniforms_axis and hp_axis are all None)")
    bad = {k: a for k, a in axes.items() if a not in (0, None)}
    if bad:
        raise ValueError(f"simulate_aoi_regret_batch: an axis is 0 or None, got {bad}")
    if isinstance(envs, ChannelProcess):
        raise TypeError(
            "simulate_aoi_regret_batch: got an unrealized ChannelProcess; realize it "
            "first — scenario_grid(procs, generators) for a stacked grid, or "
            "proc.realize(generator) with env_axis=None to share it — or hand process "
            "cases to repro_torch.sim.sweep, which realizes buckets itself")
    if not isinstance(envs, ChannelEnv):
        raise TypeError(f"simulate_aoi_regret_batch: envs must be a ChannelEnv, got {type(envs)}")
    stacked = (envs.table if envs.form == "table" else envs.means).dim() == 3
    if stacked != (env_axis == 0):
        raise ValueError("simulate_aoi_regret_batch: env_axis=0 takes a stacked env "
                         "(stack_envs), env_axis=None one env")
    if hp_axis == 0 and hparams is None:
        raise ValueError("simulate_aoi_regret_batch: hp_axis=0 needs an hparams grid "
                         "(stack_params)")

    sizes = {}
    if env_axis == 0:
        sizes["envs"] = env_batch_size(envs)
    if uniforms is not None and uniforms_axis == 0:
        sizes["uniforms"] = uniforms.shape[0]
    if hp_axis == 0:
        rows = _hp_rows(hparams)
        if len(rows) != 1 or () in rows:
            raise ValueError(f"simulate_aoi_regret_batch: an hparams grid has (G,) leaves, "
                             f"got leading shapes {sorted(rows)}")
        sizes["hparams"] = next(iter(rows))[0]
    if not sizes:
        raise ValueError("simulate_aoi_regret_batch: the batch size comes from a stacked "
                         "env, (B, T, 2, N) uniforms or an hparams grid; none was given")
    if len(set(sizes.values())) != 1:
        raise ValueError(f"simulate_aoi_regret_batch: the batched operands' sizes differ: "
                         f"{sizes}")
    batch = next(iter(sizes.values()))

    dev = resolve_device(device)
    envs = envs.to(dev)
    shape = ((batch,) if uniforms_axis == 0 else ()) + (horizon, 2, envs.n_channels)
    if uniforms is None:
        uniforms = torch.rand(shape, generator=generator, device=dev)
    elif tuple(uniforms.shape) != shape:
        raise ValueError(f"simulate_aoi_regret_batch: uniforms must be {shape}, "
                         f"got {tuple(uniforms.shape)}")
    uniforms = uniforms.to(device=dev, dtype=torch.float32).contiguous()
    state = init_batch(scheduler, batch, dev, hparams)
    if impl != "rounds":
        refusal = _rs.refusal(scheduler, envs, state, uniforms)
        if refusal is None:
            out = ops.regret_scan(scheduler, envs, state, uniforms, collect_curve,
                                  return_state, batch)
            return dict(out, route="scan")
        if impl == "scan":
            raise ValueError(f"simulate_aoi_regret_batch: impl='scan' does not apply: {refusal}")
    out = _simulate_rounds(scheduler, envs, state, uniforms, collect_curve, return_state, batch)
    return dict(out, route="rounds")
