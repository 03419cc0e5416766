"""Channel-scheduling policies: GLR-CUCB (Alg. 2) and the clairvoyant
oracle.  M-Exp3, the AoI-Aware wrapper and the baselines are not ported."""
from repro_torch.core.bandits.base import TracedHyperParams, init_with_hp, rotate_assignment
from repro_torch.core.bandits.glr_cucb import GLRCUCB, GLRCUCBState, SlotRing, glr_threshold
from repro_torch.core.bandits.oracle import oracle_assign

__all__ = ["TracedHyperParams", "init_with_hp", "rotate_assignment", "GLRCUCB",
           "GLRCUCBState", "SlotRing", "glr_threshold", "oracle_assign"]
