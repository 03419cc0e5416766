"""The port's ``repro.sim``: the batched AoI-regret and FL engines, the
sweep driver, the sharded engines on one card, and the scheduler service.

  simulate_aoi_regret_batch   B runs of one scheduler over stacked envs x
                              uniforms x hyper-parameter grids (one
                              ``regret_scan`` launch for GLR-CUCB on the card)
  simulate_fl_batch           B runs of one FL trainer (seeds, envs, data,
                              uniforms, hyper-parameter grids); each round
                              one batched launch of each Step-4 kernel
  SweepCase / FLSweepCase /   sweep requests (regret, FL) and per-bucket
  BucketReport                records
  sweep / group_cases         the sweep driver and its bucketing
  sweep_cache_stats /         bucket-signature reuse counters
  clear_sweep_cache
  sharded_aoi_regret_batch /  the engines over a 1-D device mesh (one card)
  sharded_fl_batch /
  sweep_mesh / pad_batch /
  unpad_batch
  shard_clients / shard_slots  client and slot tensors placed on the mesh
  SchedServer / ServeRequest / ServeDecision   the multi-tenant service
  TenantSlots / init_slots / make_serve_step / make_admit
                                               its functional core
  offline_round_stream                         the (u_sel, states) stream for
                                               parity with simulate_aoi_regret
"""
from repro_torch.sim.engine import simulate_aoi_regret_batch
from repro_torch.sim.fl_batch import simulate_fl_batch
from repro_torch.sim.shard import (
    pad_batch,
    shard_clients,
    shard_slots,
    sharded_aoi_regret_batch,
    sharded_fl_batch,
    sweep_mesh,
    unpad_batch,
)
from repro_torch.sim.sweep import (
    BucketReport,
    FLSweepCase,
    SweepCase,
    clear_sweep_cache,
    group_cases,
    sweep,
    sweep_cache_stats,
)
from repro_torch.sim.serve import (
    SchedServer,
    ServeDecision,
    ServeRequest,
    TenantSlots,
    init_slots,
    make_admit,
    make_serve_step,
    offline_round_stream,
)

__all__ = ["simulate_aoi_regret_batch", "simulate_fl_batch", "SweepCase", "FLSweepCase",
           "BucketReport", "group_cases", "sweep", "sweep_cache_stats", "clear_sweep_cache",
           "sharded_aoi_regret_batch", "sharded_fl_batch", "sweep_mesh", "pad_batch",
           "unpad_batch", "shard_clients", "shard_slots", "SchedServer", "ServeDecision",
           "ServeRequest", "TenantSlots", "init_slots", "make_admit", "make_serve_step", "offline_round_stream"]
