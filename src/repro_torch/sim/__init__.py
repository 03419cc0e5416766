"""The port's ``repro.sim``: the batched AoI-regret engine, the sweep
driver, the sharded engine on one card, and the scheduler service.  The
batched FL engine (``simulate_fl_batch``, ``FLSweepCase``) is not ported.

  simulate_aoi_regret_batch   B runs of one scheduler over stacked envs x
                              uniforms x hyper-parameter grids (one
                              ``regret_scan`` launch for GLR-CUCB on the card)
  SweepCase / BucketReport    sweep requests and per-bucket records
  sweep / group_cases         the sweep driver and its bucketing
  sweep_cache_stats /         bucket-signature reuse counters
  clear_sweep_cache
  sharded_aoi_regret_batch /  the engine over a 1-D device mesh (one card)
  sweep_mesh / pad_batch /
  unpad_batch
  SchedServer / ServeRequest / ServeDecision   the multi-tenant service
  TenantSlots / init_slots / make_serve_step / make_admit
                                               its functional core
  offline_round_stream                         the (u_sel, states) stream for
                                               parity with simulate_aoi_regret
"""
from repro_torch.sim.engine import simulate_aoi_regret_batch
from repro_torch.sim.shard import pad_batch, sharded_aoi_regret_batch, sweep_mesh, unpad_batch
from repro_torch.sim.sweep import (
    BucketReport,
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

__all__ = ["simulate_aoi_regret_batch", "SweepCase", "BucketReport", "group_cases", "sweep",
           "sweep_cache_stats", "clear_sweep_cache", "sharded_aoi_regret_batch", "sweep_mesh",
           "pad_batch", "unpad_batch", "SchedServer", "ServeDecision", "ServeRequest",
           "TenantSlots", "init_slots", "make_admit", "make_serve_step", "offline_round_stream"]
