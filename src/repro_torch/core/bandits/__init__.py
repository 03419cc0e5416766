"""Channel-scheduling policies (Sec. IV + related-work baselines).

Paper policies: ``MExp3`` (adversarial, Alg. 1), ``GLRCUCB``
(piecewise-stationary, Alg. 2), ``AoIAware`` (AA wrapper, Sec. VI-B) and
the clairvoyant oracle.  Ablation comparators: ``RandomScheduler``,
``RoundRobinScheduler``.  Related-work baselines: ``ChannelAwareAsync``
(Hu et al. style) and ``LyapunovSched`` (Perazzone et al. style).  Every
policy implements the protocol of ``base.py``.  Twin of
``repro/core/bandits/__init__.py``.
"""
from repro_torch.core.bandits.base import (
    TracedHyperParams,
    combinations_array,
    init_with_hp,
    rotate_assignment,
    stack_params,
)
from repro_torch.core.bandits.mexp3 import MExp3, MExp3State
from repro_torch.core.bandits.glr_cucb import (GLRCUCB, GLRCUCBState, SlotHist, SlotRing,
                                               glr_threshold)
from repro_torch.core.bandits.aoi_aware import AoIAware, AoIAwareState
from repro_torch.core.bandits.channel_aware import ChannelAwareAsync, ChannelAwareState
from repro_torch.core.bandits.lyapunov import LyapunovSched, LyapunovState
from repro_torch.core.bandits.random_policy import RandomScheduler, RandomState
from repro_torch.core.bandits.round_robin import RoundRobinScheduler, RRState
from repro_torch.core.bandits.oracle import oracle_assign

__all__ = [
    "TracedHyperParams", "init_with_hp", "stack_params", "combinations_array",
    "rotate_assignment", "MExp3", "MExp3State", "GLRCUCB", "GLRCUCBState", "SlotRing", "SlotHist",
    "glr_threshold", "AoIAware", "AoIAwareState", "ChannelAwareAsync", "ChannelAwareState",
    "LyapunovSched", "LyapunovState", "RandomScheduler", "RandomState",
    "RoundRobinScheduler", "RRState", "oracle_assign",
]
