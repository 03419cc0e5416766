"""Non-stationary wireless channel scenarios (Sec. II-B): the canonical
``ChannelEnv`` forms, the stationary / piecewise / adversarial scenario
families and the legacy ``random_*_env`` shims."""
from repro_torch.core.channels.base import (
    FORM_SEGMENTS,
    FORM_TABLE,
    ChannelEnv,
    make_piecewise,
    make_stationary,
    segment_env,
    table_env,
)
from repro_torch.core.channels.process import (
    ChannelProcess,
    make_scenario,
    register_scenario,
)
from repro_torch.core.channels.families import (
    AdversarialProcess,
    PiecewiseProcess,
    StationaryProcess,
    random_adversarial_env,
    random_piecewise_env,
)

__all__ = [
    "ChannelEnv", "FORM_SEGMENTS", "FORM_TABLE", "segment_env", "table_env",
    "make_stationary", "make_piecewise", "ChannelProcess", "make_scenario",
    "register_scenario", "StationaryProcess", "PiecewiseProcess", "AdversarialProcess",
    "random_piecewise_env", "random_adversarial_env",
]
