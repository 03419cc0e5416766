"""Heterogeneous sweep driver: group regret and FL cases into batches.

A figure-level sweep mixes schedulers (different state structures),
horizons and env forms; those cannot share one batch.  ``sweep`` groups
regret cases (``SweepCase``) by (the scheduler's ``hp_signature()``,
horizon, the env's form and leaf shapes) and FL cases (``FLSweepCase``)
by (the trainer's ``bucket_signature()``, the shapes of the model and the
data), runs each bucket through ``simulate_aoi_regret_batch`` or
``simulate_fl_batch`` as one batch, and returns per-case results keyed
by case name.  One sweep may mix both kinds.

Cases whose schedulers differ only in traced hyper-parameters (``gamma``,
``delta``, EMA rates, ...) land in one bucket: their ``params()`` are
stacked (``stack_params``) and ride the engine's hyper-parameter axis, so
a 16-point tuning grid of GLR-CUCB is one ``regret_scan`` launch on the
card.  Scenario processes (``ChannelProcess``) drop into ``SweepCase.env``
unrealized: they bucket by their realized env's form and shapes
(``env_signature()``), families merge (reactive ones among themselves:
the reactive form is a signature of its own), and the bucket realizes
each case from ``scenario_realize_generator(case.seed)`` before the batch
runs.  An FL bucket stacks its cases' models, data, uniforms and envs
(trainers built on an unrealized process are realized per case the same
way), and its trainers' scheduler scalars ride the state's
hyper-parameter axis.

Twin of ``repro/sim/sweep.py``.  The JAX driver compiles one executable a
bucket and keeps it in a process-level cache; the port compiles nothing
per bucket (the kernels are built once, at first use), so
``sweep_cache_stats`` keeps its API and counts only the reuse of a bucket
signature (hits: a bucket of a signature, size, device and mesh seen
before in the process), and ``BucketReport.compile_s`` is the time spent
building kernels during the bucket, normally 0.  ``shard=True`` runs every
bucket through ``repro_torch.sim.shard`` (one card: bit for bit the
unsharded result).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.bandits.base import stack_params
from repro_torch.core.channels import (
    ChannelProcess,
    realize_processes,
    scenario_realize_generator,
    stack_envs,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.sim import shard as _shard
from repro_torch.sim.engine import simulate_aoi_regret_batch
from repro_torch.sim.fl_batch import simulate_fl_batch
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True, eq=False)
class SweepCase:
    """One (name, scheduler, env, seed, horizon) simulation request.

    ``env`` is a ``ChannelEnv`` or an unrealized ``ChannelProcess``.  The
    run's randomness is ``uniforms`` (T, 2, N) when given, else
    ``torch.rand((T, 2, N), generator=g)`` with ``g`` a generator on the
    sweep's device seeded with ``seed``; a process is realized from
    ``scenario_realize_generator(seed)``.  So a case's result equals
    ``simulate_aoi_regret(scheduler, env, horizon, generator=
    scenario_realize_generator(seed, device), uniforms=that draw)``, which
    realizes a process from that generator the same way.
    """

    name: str
    scheduler: Any
    env: Any                     # ChannelEnv | ChannelProcess
    seed: int
    horizon: int
    uniforms: Optional[torch.Tensor] = None

    def draw_uniforms(self, device) -> torch.Tensor:
        """The run's (T, 2, N) uniforms on ``device``: ``uniforms``, else the
        draw from a generator seeded with ``seed``."""
        if self.uniforms is not None:
            return self.uniforms.to(device=device, dtype=torch.float32)
        gen = torch.Generator(device=device).manual_seed(int(self.seed))
        return torch.rand((self.horizon, 2, self.env.n_channels), generator=gen, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class FLSweepCase:
    """One (name, trainer, params, seed, round data) FL run.

    ``trainer`` is an ``AsyncFLTrainer`` on the sweep's device; ``params``
    the initial model; ``batches_x`` (R, M, E, B, ...) and ``batches_y``
    (R, M, E, B) the rounds' data.  The randomness is ``uniforms`` (R, 2,
    N) and, with faults, ``fault_uniforms`` (R, K) when given, else drawn
    in that order from a generator on the device seeded with ``seed``, as
    ``trainer.run(..., generator=g)`` draws them.  A trainer built on an
    unrealized ``ChannelProcess`` is realized for the case from
    ``scenario_realize_generator(seed)``.  So a case's result equals
    ``trainer.run(trainer.init(params), batches_x, batches_y, generator=
    torch.Generator(device).manual_seed(seed))``, the trainer's process
    realized from ``realize_generator=scenario_realize_generator(seed,
    device)``.  The result is ``{"state": the final state, "metrics":
    {name: (R,)}}``."""

    name: str
    trainer: Any
    params: Any
    seed: int
    batches_x: Any
    batches_y: Any
    uniforms: Optional[torch.Tensor] = None
    fault_uniforms: Optional[torch.Tensor] = None

    def draw_uniforms(self, device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The run's (R, 2, N) uniforms and (R, K) fault uniforms (None
        without faults) on ``device``."""
        r, n = int(self.batches_x.shape[0]), self.trainer.cfg.n_channels
        k = self.trainer.n_fault_uniforms()
        if self.uniforms is not None:
            if k and self.fault_uniforms is None:
                raise ValueError(f"FLSweepCase {self.name!r}: with faults, give uniforms and "
                                 "fault_uniforms, or neither")
            f32 = lambda x: x.to(device=device, dtype=torch.float32)
            return f32(self.uniforms), f32(self.fault_uniforms) if k else None
        gen = torch.Generator(device=device).manual_seed(int(self.seed))
        u = torch.rand((r, 2, n), generator=gen, device=device)
        return u, torch.rand((r, k), generator=gen, device=device) if k else None


@dataclasses.dataclass
class BucketReport:
    """Execution record of one bucket."""

    names: List[str]
    batch: int
    compile_s: float             # kernels built during the bucket (normally 0)
    wall_s: float                # the bucket's run, synchronized with block=True
    cache_hit: bool = False      # a bucket of this signature ran before in the process
    sharded: bool = False        # ran through repro_torch.sim.shard
    route: str = ""              # "scan" (one regret_scan launch), "rounds" or "fl"


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------

def _env_sig(env) -> Tuple:
    if isinstance(env, ChannelProcess):
        return ("scenario",) + env.env_signature()
    return env.signature()


def _shapes(tensors) -> Tuple:
    return tuple((tuple(x.shape), str(x.dtype)) for x in tensors)


def _bucket_key(case) -> Tuple:
    if isinstance(case, FLSweepCase):
        params = case.params
        return ("fl", case.trainer.bucket_signature(), tuple(sorted(params)),
                _shapes(torch.as_tensor(params[k]) for k in sorted(params)),
                _shapes((torch.as_tensor(case.batches_x), torch.as_tensor(case.batches_y))))
    if not isinstance(case, SweepCase):
        raise TypeError(f"sweep: case {getattr(case, 'name', case)!r} is a "
                        f"{type(case).__name__}; a case is a SweepCase or an FLSweepCase")
    sched = case.scheduler
    sig = sched.hp_signature() if hasattr(sched, "hp_signature") else sched
    return ("regret", sig, case.horizon, _env_sig(case.env))


def group_cases(cases: Sequence[Any]) -> List[List[Any]]:
    """Partition cases into buckets, preserving first-seen order."""
    buckets: Dict[Any, List[SweepCase]] = {}
    for c in cases:
        buckets.setdefault(_bucket_key(c), []).append(c)
    return list(buckets.values())


# ---------------------------------------------------------------------------
# bucket-signature reuse (the JAX driver's executable cache)
# ---------------------------------------------------------------------------

_SEEN: set = set()
_STATS = {"hits": 0, "misses": 0}


def sweep_cache_stats() -> Dict[str, int]:
    """Hit/miss counts of bucket signatures (nothing is compiled per bucket)."""
    return dict(_STATS)


def clear_sweep_cache() -> None:
    """Forget every bucket signature seen and reset the counters."""
    _SEEN.clear()
    _STATS.update(hits=0, misses=0)


def _seen(bucket, dev, mesh, *extra) -> bool:
    sig = (_bucket_key(bucket[0]), len(bucket), str(dev),
           None if mesh is None else mesh.devices) + extra
    hit = sig in _SEEN
    _SEEN.add(sig)
    _STATS["hits" if hit else "misses"] += 1
    return hit


def _timed(fn, block: bool, dev):
    """``fn()``, the seconds spent building kernels in it, and its wall
    seconds (up to the device's end with ``block``)."""
    built = _build.build.seconds
    t0 = time.perf_counter()
    out = fn()
    if block and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    return out, _build.build.seconds - built, wall_s


def _run_fl_bucket(bucket: List[FLSweepCase], block: bool, mesh, dev):
    tr = bucket[0].trainer
    if tr.device != dev:
        raise ValueError(f"sweep: case {bucket[0].name!r}'s trainer is on {tr.device}, the "
                         f"sweep on {dev}")
    params = {k: torch.stack([torch.as_tensor(c.params[k]).to(dev) for c in bucket])
              for k in bucket[0].params}
    hparams = stack_params([c.trainer.scheduler for c in bucket], dev)
    states = tr.init_batch(params, len(bucket), params_axis=0, hp=hparams,
                           hp_axis=None if hparams is None else 0)
    if tr.scenario is not None:
        envs = realize_processes([c.trainer.scenario for c in bucket],
                                 [scenario_realize_generator(c.seed, dev) for c in bucket], dev)
    else:
        envs = stack_envs([c.trainer.env.to(dev) for c in bucket])
    bx = torch.stack([torch.as_tensor(c.batches_x).to(dev) for c in bucket])
    by = torch.stack([torch.as_tensor(c.batches_y).to(dev) for c in bucket])
    drawn = [c.draw_uniforms(dev) for c in bucket]
    u = torch.stack([d[0] for d in drawn])
    fu = None if drawn[0][1] is None else torch.stack([d[1] for d in drawn])
    hit = _seen(bucket, dev, mesh)
    run = _shard.sharded_fl_batch if mesh is not None else simulate_fl_batch
    kw = {} if mesh is None else {"mesh": mesh}
    (final, mets), compile_s, wall_s = _timed(
        lambda: run(tr, states, bx, by, uniforms=u, fault_uniforms=fu, envs=envs, env_axis=0,
                    **kw), block, dev)
    return {"state": final, "metrics": mets, "route": "fl"}, compile_s, wall_s, hit


def _run_bucket(bucket: List[SweepCase], collect_curve: bool, block: bool, mesh, dev):
    first = bucket[0]
    if isinstance(first, FLSweepCase):
        return _run_fl_bucket(bucket, block, mesh, dev)
    if isinstance(first.env, ChannelProcess):
        envs = realize_processes([c.env for c in bucket],
                                 [scenario_realize_generator(c.seed, dev) for c in bucket], dev)
    else:
        envs = stack_envs([c.env.to(dev) for c in bucket])
    uniforms = torch.stack([c.draw_uniforms(dev) for c in bucket])
    hparams = stack_params([c.scheduler for c in bucket], dev)
    hp_axis = None if hparams is None else 0
    hit = _seen(bucket, dev, mesh, collect_curve)
    kw = dict(uniforms=uniforms, collect_curve=collect_curve, hparams=hparams, hp_axis=hp_axis)
    if mesh is not None:
        run = lambda: _shard.sharded_aoi_regret_batch(first.scheduler, envs, first.horizon,
                                                      mesh=mesh, **kw)
    else:
        run = lambda: simulate_aoi_regret_batch(first.scheduler, envs, first.horizon,
                                                device=dev, **kw)
    out, compile_s, wall_s = _timed(run, block, dev)
    return out, compile_s, wall_s, hit


def sweep(
    cases: Sequence[Any],
    collect_curve: bool = True,
    block: bool = True,
    shard: bool = False,
    mesh: Optional[_shard.SweepMesh] = None,
    device=None,
) -> Tuple[Dict[str, Dict[str, Any]], List[BucketReport]]:
    """Run every case, batching compatible ones (see the module docstring).

    ``device`` (default ``cuda``) is where every bucket runs; ``shard=True``
    runs each bucket through ``sharded_aoi_regret_batch`` on ``mesh`` (by
    default the mesh of that device).  ``block=False`` does not wait for
    the device, so ``wall_s`` then records only the dispatch.

    Returns ``(results, report)``: case name -> the result dict of
    ``simulate_aoi_regret`` (the run axis stripped, ``route`` kept) for a
    regret case, ``{"state", "metrics", "route"}`` for an FL case; and one
    ``BucketReport`` per bucket (``route`` ``"fl"`` for an FL bucket).
    """
    names = [c.name for c in cases]
    if len(set(names)) != len(names):
        raise ValueError(f"sweep: duplicate case names: {names}")
    dev = resolve_device(device)
    run_mesh = (mesh if mesh is not None else _shard.sweep_mesh([dev])) if shard else None

    results: Dict[str, Dict[str, Any]] = {}
    report: List[BucketReport] = []
    for bucket in group_cases(cases):
        out, compile_s, wall_s, hit = _run_bucket(bucket, collect_curve, block, run_mesh, dev)
        row = lambda x, i: x[i] if isinstance(x, torch.Tensor) and x.dim() else x
        for i, c in enumerate(bucket):
            results[c.name] = {k: tree_map(lambda x: row(x, i), v) for k, v in out.items()}
        report.append(BucketReport(names=[c.name for c in bucket], batch=len(bucket),
                                   compile_s=compile_s, wall_s=wall_s, cache_hit=hit,
                                   sharded=run_mesh is not None, route=out["route"]))
    return results, report
