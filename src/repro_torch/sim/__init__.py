"""The scheduler service (see ``serve.py``): the serving names of the JAX
package's ``repro.sim``.  The batched simulation engine, the sweep driver
and the sharded engine are not ported.

  SchedServer / ServeRequest / ServeDecision   the multi-tenant service
  TenantSlots / init_slots / make_serve_step / make_admit
                                               its functional core
  offline_round_stream                         the (u_sel, states) stream for
                                               parity with simulate_aoi_regret
"""
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

__all__ = ["SchedServer", "ServeDecision", "ServeRequest", "TenantSlots", "init_slots",
           "make_admit", "make_serve_step", "offline_round_stream"]
