"""Non-stationary wireless channel scenarios (Sec. II-B): the canonical
``ChannelEnv`` forms with their stacking helpers, the scenario registry
with its grids, the stationary / piecewise / adversarial scenario families
and the legacy ``random_*_env`` shims."""
from repro_torch.core.channels.base import (
    FORM_SEGMENTS,
    FORM_TABLE,
    ChannelEnv,
    dense_means,
    env_batch_size,
    envs_stackable,
    make_piecewise,
    make_stationary,
    scenario_realize_generator,
    segment_env,
    stack_envs,
    table_env,
)
from repro_torch.core.channels.process import (
    ChannelProcess,
    check_knobs,
    example_scenario,
    make_scenario,
    realize_processes,
    register_scenario,
    registered_scenarios,
    scenario_grid,
)
from repro_torch.core.channels.families import (
    AdversarialProcess,
    PiecewiseProcess,
    StationaryProcess,
    random_adversarial_env,
    random_piecewise_env,
)

__all__ = [
    "ChannelEnv", "FORM_SEGMENTS", "FORM_TABLE", "segment_env", "table_env", "dense_means",
    "make_stationary", "make_piecewise", "stack_envs", "envs_stackable", "env_batch_size",
    "scenario_realize_generator", "ChannelProcess", "register_scenario",
    "registered_scenarios", "make_scenario", "check_knobs", "example_scenario",
    "scenario_grid", "realize_processes", "StationaryProcess", "PiecewiseProcess",
    "AdversarialProcess", "random_piecewise_env", "random_adversarial_env",
]
