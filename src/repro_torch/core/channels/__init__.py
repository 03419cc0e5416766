"""Non-stationary wireless channel scenarios (Sec. II-B): the three
canonical ``ChannelEnv`` forms (segments, table, the closed-loop
``"reactive"``) with their stacking helpers and the uniform closed-loop
API, the scenario registry with its grids, the nine scenario families (the
paper's stationary / piecewise / adversarial regimes, Gilbert-Elliott
fading, mobility drift, SNR shadowing, the composable jamming overlay, and
the reactive jammer and load congestion) and the legacy ``random_*_env``
shims."""
from repro_torch.core.channels.base import (
    FORM_REACTIVE,
    FORM_SEGMENTS,
    FORM_TABLE,
    N_REACT,
    ChannelEnv,
    dense_means,
    env_batch_size,
    envs_stackable,
    make_piecewise,
    make_stationary,
    reactive_env,
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
    GilbertElliottProcess,
    JammingOverlay,
    LoadCongestionProcess,
    MobilityDriftProcess,
    PiecewiseProcess,
    ReactiveJammerProcess,
    ShadowingProcess,
    StationaryProcess,
    random_adversarial_env,
    random_piecewise_env,
)

__all__ = [
    # canonical forms
    "ChannelEnv", "FORM_SEGMENTS", "FORM_TABLE", "FORM_REACTIVE", "N_REACT", "segment_env",
    "table_env", "reactive_env", "dense_means", "make_stationary", "make_piecewise",
    "stack_envs", "envs_stackable", "env_batch_size", "scenario_realize_generator",
    # scenario subsystem
    "ChannelProcess", "register_scenario", "registered_scenarios", "make_scenario",
    "check_knobs", "example_scenario", "scenario_grid", "realize_processes",
    # families
    "StationaryProcess", "PiecewiseProcess", "AdversarialProcess", "GilbertElliottProcess",
    "MobilityDriftProcess", "ShadowingProcess", "JammingOverlay", "ReactiveJammerProcess",
    "LoadCongestionProcess",
    # legacy generators (shims over the registry)
    "random_piecewise_env", "random_adversarial_env",
]
