"""Heterogeneous sweep driver: group regret cases into batches.

A figure-level sweep mixes schedulers (different state structures),
horizons and env forms; those cannot share one batch.  ``sweep`` groups
cases by (the scheduler's ``hp_signature()``, horizon, the env's form and
leaf shapes), runs each bucket through ``simulate_aoi_regret_batch`` as
one batch, and returns per-case results keyed by case name.

Cases whose schedulers differ only in traced hyper-parameters (``gamma``,
``delta``, EMA rates, ...) land in one bucket: their ``params()`` are
stacked (``stack_params``) and ride the engine's hyper-parameter axis, so
a 16-point tuning grid of GLR-CUCB is one ``regret_scan`` launch on the
card.  Scenario processes (``ChannelProcess``) drop into ``SweepCase.env``
unrealized: they bucket by their realized env's form and shapes
(``env_signature()``), families merge (reactive ones among themselves:
the reactive form is a signature of its own), and the bucket realizes
each case from ``scenario_realize_generator(case.seed)`` before the batch
runs.

Twin of ``repro/sim/sweep.py``.  The JAX driver compiles one executable a
bucket and keeps it in a process-level cache; the port compiles nothing
per bucket (the kernels are built once, at first use), so
``sweep_cache_stats`` keeps its API and counts only the reuse of a bucket
signature (hits: a bucket of a signature, size, device and mesh seen
before in the process), and ``BucketReport.compile_s`` is the time spent
building kernels during the bucket, normally 0.  ``shard=True`` runs every
bucket through ``repro_torch.sim.shard`` (one card: bit for bit the
unsharded result).  The batched FL engine (the JAX ``FLSweepCase`` and
``simulate_fl_batch``) is not ported yet: only regret cases run.
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


@dataclasses.dataclass
class BucketReport:
    """Execution record of one bucket."""

    names: List[str]
    batch: int
    compile_s: float             # kernels built during the bucket (normally 0)
    wall_s: float                # the bucket's run, synchronized with block=True
    cache_hit: bool = False      # a bucket of this signature ran before in the process
    sharded: bool = False        # ran through repro_torch.sim.shard
    route: str = ""              # "scan" (one regret_scan launch) or "rounds"


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------

def _env_sig(env) -> Tuple:
    if isinstance(env, ChannelProcess):
        return ("scenario",) + env.env_signature()
    return (env.form, env.score_kind) + tuple(
        (tuple(x.shape), str(x.dtype)) for x in (env.means, env.breaks, env.table, env.react))


def _bucket_key(case) -> Tuple:
    if not isinstance(case, SweepCase):
        raise TypeError(
            f"sweep: case {getattr(case, 'name', case)!r} is a {type(case).__name__}; only "
            "regret cases (SweepCase) run here: the batched FL engine (the JAX package's "
            "FLSweepCase and simulate_fl_batch) is not ported yet")
    sched = case.scheduler
    sig = sched.hp_signature() if hasattr(sched, "hp_signature") else sched
    return ("regret", sig, case.horizon, _env_sig(case.env))


def group_cases(cases: Sequence[SweepCase]) -> List[List[SweepCase]]:
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


def _run_bucket(bucket: List[SweepCase], collect_curve: bool, block: bool, mesh, dev):
    first = bucket[0]
    if isinstance(first.env, ChannelProcess):
        envs = realize_processes([c.env for c in bucket],
                                 [scenario_realize_generator(c.seed, dev) for c in bucket], dev)
    else:
        envs = stack_envs([c.env.to(dev) for c in bucket])
    uniforms = torch.stack([c.draw_uniforms(dev) for c in bucket])
    hparams = stack_params([c.scheduler for c in bucket], dev)
    hp_axis = None if hparams is None else 0
    sig = (_bucket_key(first), len(bucket), collect_curve, str(dev),
           None if mesh is None else mesh.devices)
    hit = sig in _SEEN
    _SEEN.add(sig)
    _STATS["hits" if hit else "misses"] += 1

    built = _build.build.seconds
    t0 = time.perf_counter()
    kw = dict(uniforms=uniforms, collect_curve=collect_curve, hparams=hparams, hp_axis=hp_axis)
    if mesh is not None:
        out = _shard.sharded_aoi_regret_batch(first.scheduler, envs, first.horizon, mesh=mesh,
                                              **kw)
    else:
        out = simulate_aoi_regret_batch(first.scheduler, envs, first.horizon, device=dev, **kw)
    if block and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    return out, _build.build.seconds - built, wall_s, hit


def sweep(
    cases: Sequence[SweepCase],
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
    ``simulate_aoi_regret`` (the run axis stripped, ``route`` kept), and
    one ``BucketReport`` per bucket.
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
        for i, c in enumerate(bucket):
            results[c.name] = {k: v[i] if isinstance(v, torch.Tensor) else v
                               for k, v in out.items()}
        report.append(BucketReport(names=[c.name for c in bucket], batch=len(bucket),
                                   compile_s=compile_s, wall_s=wall_s, cache_hit=hit,
                                   sharded=run_mesh is not None, route=out["route"]))
    return results, report
