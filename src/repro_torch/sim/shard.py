"""Sharded sweep buckets, on the port's one card.

The JAX package splits a bucket's run axis over a 1-D device mesh
(``shard_map``): every run is independent, so each device runs its slice
of the batch.  Twin of ``repro/sim/shard.py``, keeping its API:
``sweep_mesh`` lists the devices, ``pad_batch`` pads a batch to a multiple
of the device count by cycling its entries (index ``i % B``, valid inputs,
sliced off again by ``unpad_batch``), and ``sharded_aoi_regret_batch`` and
``sharded_fl_batch`` are ``simulate_aoi_regret_batch`` and
``simulate_fl_batch`` over the mesh (the twin of JAX's
``build_fl_sharded``), and ``shard_clients`` / ``shard_slots`` place the
sparse substrate's client tensors and the service's slot tensors.  The
port has one card, and a split over several has no card to be tested on,
so a mesh holds one device: the sharded call pads to a multiple of 1 and
equals the unsharded call bit for bit, and a placement changes no bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.channels import ChannelEnv
from repro_torch.device import resolve_device
from repro_torch.sim.engine import simulate_aoi_regret_batch
from repro_torch.sim.fl_batch import simulate_fl_batch
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class SweepMesh:
    """A 1-D mesh: its ``devices``, along the axis named ``"cases"``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("cases",)


def sweep_mesh(devices: Optional[Sequence[Any]] = None) -> SweepMesh:
    """A 1-D mesh over ``devices`` (default: every CUDA device; raises
    without one, as every entry point of the port does)."""
    if devices is None:
        resolve_device()
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return SweepMesh(tuple(torch.device(d) for d in devices))


def _map(fn, tree):
    """``fn`` over the tensors with a run axis of a tree of dicts, tuples,
    NamedTuples and ``ChannelEnv``s (a result dict, a state, an env); other
    leaves stay, and so does a 0-d tensor (shared by every run: a batched
    state's shared hyper-parameter)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree) if tree.dim() else tree
    if isinstance(tree, ChannelEnv):
        return dataclasses.replace(tree, means=fn(tree.means), breaks=fn(tree.breaks),
                                   table=fn(tree.table), react=fn(tree.react))
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_map(fn, x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def batch_size(tree) -> int:
    """The leading-axis length shared by every tensor of a batched tree."""
    sizes = []
    _map(lambda x: sizes.append(int(x.shape[0])) or x, tree)
    if not sizes:
        raise ValueError("batch_size: pytree has no array leaves")
    if len(set(sizes)) != 1:
        raise ValueError(f"batch_size: inconsistent leading axes {sorted(set(sizes))}")
    return sizes[0]


def pad_batch(tree, multiple: int) -> Tuple[Any, int]:
    """Pad every tensor's leading axis up to the next multiple of
    ``multiple`` by cycling the entries (index ``i % B``); returns
    ``(padded, B)``.  A batch already divisible is returned untouched."""
    b = batch_size(tree)
    bp = -(-b // multiple) * multiple
    if bp == b:
        return tree, b
    idx = torch.arange(bp) % b
    return _map(lambda x: x.index_select(0, idx.to(x.device)), tree), b


def unpad_batch(tree, b: int):
    """Strip pad rows: every tensor's leading axis cut back to ``b``."""
    return _map(lambda x: x[:b], tree)


def _place(tree, mesh: Optional[SweepMesh], label: str):
    """Every tensor of ``tree`` on the one device of ``mesh``."""
    mesh = sweep_mesh() if mesh is None else mesh
    if len(mesh.devices) != 1:
        raise ValueError(f"{label}: a mesh of {len(mesh.devices)} devices; the port keeps "
                         "the client and slot axes on one card (no split across cards)")
    dev = mesh.devices[0]
    return tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, tree)


def shard_clients(tree, mesh: Optional[SweepMesh] = None):
    """Place the sparse FL substrate's (N,)-leading client tensors (the
    (N, n, ...) datasets, (N,) scalars; ``repro_torch.fl.sparse``) on the
    mesh's device (default: ``sweep_mesh()``).  The JAX package splits
    them over the mesh; on the port's one card this is a placement that
    changes no bits.  A mesh of several devices raises."""
    return _place(tree, mesh, "shard_clients")


def shard_slots(tree, mesh: Optional[SweepMesh] = None):
    """Place the scheduler service's slot tensors (leading axis the slot
    rows) on the mesh's device, as ``shard_clients`` does for the client
    axis: bitwise inert on one card; a mesh of several devices raises."""
    return _place(tree, mesh, "shard_slots")


def sharded_aoi_regret_batch(
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
    mesh: Optional[SweepMesh] = None,
    device=None,
    impl: Optional[str] = None,
) -> Dict[str, Any]:
    """``simulate_aoi_regret_batch`` with the run axis over ``mesh``
    (default: ``sweep_mesh()``, or the mesh of ``device`` when given): the
    batched operands padded to the device count, the pad rows sliced off
    the result.  Same arguments and results; a mesh of one device."""
    if env_axis is None and uniforms_axis is None and hp_axis is None:
        raise ValueError("sharded_aoi_regret_batch: nothing to batch over "
                         "(env_axis, uniforms_axis and hp_axis are all None)")
    if mesh is None:
        mesh = sweep_mesh(None if device is None else [resolve_device(device)])
    if len(mesh.devices) != 1:
        raise ValueError(f"sharded_aoi_regret_batch: a mesh of {len(mesh.devices)} devices; "
                         "the port runs a bucket on one card (no split across cards)")
    dev, d = mesh.devices[0], len(mesh.devices)
    operands = {"envs": (envs, env_axis), "uniforms": (uniforms, uniforms_axis),
                "hparams": (hparams, hp_axis)}
    mapped = {k: x for k, (x, a) in operands.items() if a == 0 and x is not None}
    if not mapped:
        raise ValueError("sharded_aoi_regret_batch: the batch size comes from a stacked env, "
                         "(B, T, 2, N) uniforms or an hparams grid; none was given")
    b = batch_size(mapped)
    if uniforms is None:   # drawn before any padding, as the unsharded call draws them
        shape = ((b,) if uniforms_axis == 0 else ()) + (horizon, 2, envs.n_channels)
        uniforms = torch.rand(shape, generator=generator, device=dev)
        operands["uniforms"] = (uniforms, uniforms_axis)
        if uniforms_axis == 0:
            mapped["uniforms"] = uniforms
    args = {k: x for k, (x, _) in operands.items()}
    args.update({k: pad_batch(x, d)[0] for k, x in mapped.items()})
    out = simulate_aoi_regret_batch(
        scheduler, args["envs"], horizon, uniforms=args["uniforms"],
        collect_curve=collect_curve, env_axis=env_axis, uniforms_axis=uniforms_axis,
        hparams=args["hparams"], hp_axis=hp_axis, device=dev, impl=impl)
    return unpad_batch(out, b) if (-b) % d else out


def sharded_fl_batch(
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
    mesh: Optional[SweepMesh] = None,
) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """``simulate_fl_batch`` with the run axis over ``mesh`` (default: the
    mesh of the trainer's device): the batched operands (the states and
    every operand with axis 0) padded to the device count, the pad rows
    sliced off the result.  Same arguments and results; a mesh of one
    device.  Uniforms not given are drawn before any padding, as the
    unsharded call draws them."""
    if mesh is None:
        mesh = sweep_mesh([trainer.device])
    if len(mesh.devices) != 1 or mesh.devices[0] != trainer.device:
        raise ValueError(f"sharded_fl_batch: a mesh of {list(mesh.devices)}; the port runs a "
                         f"bucket on the trainer's one card ({trainer.device})")
    d, b = len(mesh.devices), int(states.aoi.shape[0])
    if uniforms is None:
        n, k = trainer.cfg.n_channels, trainer.n_fault_uniforms()
        lead = ((b,) if uniforms_axis == 0 else ()) + (int(batches_x.shape[int(data_axis == 0)]),)
        uniforms = torch.rand(lead + (2, n), generator=generator, device=trainer.device)
        if k:
            fault_uniforms = torch.rand(lead + (k,), generator=generator, device=trainer.device)
    pad = lambda x, axis=0: pad_batch(x, d)[0] if axis == 0 and x is not None else x
    final, mets = simulate_fl_batch(
        trainer, pad(states), pad(batches_x, data_axis), pad(batches_y, data_axis),
        uniforms=pad(uniforms, uniforms_axis), fault_uniforms=pad(fault_uniforms, uniforms_axis),
        data_axis=data_axis, uniforms_axis=uniforms_axis, envs=pad(envs, env_axis),
        env_axis=env_axis)
    return unpad_batch((final, mets), b) if (-b) % d else (final, mets)
