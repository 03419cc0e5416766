"""Roofline of one step on one NVIDIA H100 (SXM, 80 GB HBM3, 700 W).

Twin of ``repro/utils/roofline.py``, with the card's constants (NVIDIA's
data sheet, dense rates):

    compute    = FLOPs / 989e12 FLOP/s  (bf16 on the tensor cores)
    memory     = bytes / 3.35e12 B/s    (HBM3)

All inputs are per-device quantities.  One card has no collectives, and a
mesh description (``launch/mesh.py``) places nothing, so nothing counts
the bytes a partitioned step would move between devices: ``coll_bytes``
stays ``None``, ``t_collective`` is ``None``, and the bottleneck is taken
over the two terms above.  A card set below 700 W (``nvidia-smi``'s
``power.limit``) runs slower than these rates.

``KernelCost`` is one kernel call's work, as each wrapper's ``cost``
gives it: operations at their type's rate and the bytes the call must
move (each input read once, each output written once); its bound is the
larger of the two times.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

CARD = "NVIDIA H100 80GB HBM3 (SXM), 700 W"
PEAK_FLOPS_BF16 = 989e12      # dense bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12        # f32 outside the tensor cores
PEAK_LANE_OPS_F32 = PEAK_FLOPS_F32 / 2   # f32 lane instructions a second (an FMA is 2 flops)
HBM_BW = 3.35e12              # bytes/s
CARD_MEMORY = 80 * 2 ** 30    # what a step may hold, the card's 80 GiB
SM_COUNT = 132                # streaming multiprocessors
SM_CLOCK_HZ = 1980e6          # the maximum SM clock (nvidia-smi --query-gpu=clocks.max.sm)
LANES_PER_SM_CLOCK = 128      # lane instructions issued a clock on each SM (4 x 32)
MUFU_PER_SM_CLOCK = 16        # special-function (MUFU) results a clock on each SM
MUFU_RATE = MUFU_PER_SM_CLOCK * SM_COUNT * SM_CLOCK_HZ   # MUFU results a second


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One kernel call's work: ``ops`` operations at ``rate`` a second and
    ``nbytes`` moved."""
    ops: float
    nbytes: float
    rate: float

    @property
    def bound_s(self) -> float:
        return max(self.nbytes / HBM_BW, self.ops / self.rate)

    @property
    def bound_ms(self) -> float:
        return self.bound_s * 1e3

    @property
    def bound_by(self) -> str:
        return "bytes" if self.nbytes / HBM_BW >= self.ops / self.rate else "operations"


@dataclasses.dataclass
class Roofline:
    flops: float                       # per-device FLOPs
    hbm_bytes: float                   # per-device bytes accessed
    coll_bytes: Optional[float] = None  # per-device collective bytes: nothing counts them
    model_flops: float = 0.0           # 6*N*D (or 6*N_active*D) across the devices
    chips: int = 1
    attn_score_bytes: float = 0.0      # per-device score/probs traffic: what a flash
                                       # kernel keeps on chip

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        """None: the port has no link rate and nothing that counts the bytes."""
        return None

    @property
    def t_memory_flash(self) -> float:
        """Memory term when attention's score and probability tensors stay
        on chip (the flash kernel never writes them to HBM)."""
        return max(self.hbm_bytes - self.attn_score_bytes, 0.0) / HBM_BW

    def _terms(self) -> Dict[str, float]:
        return {"compute": self.t_compute, "memory": self.t_memory}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        """Max of the known terms (perfect-overlap assumption)."""
        return max(self._terms().values())

    @property
    def useful_flop_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / (per-device FLOPs * chips): remat/redundancy waste."""
        if not self.model_flops:
            return None
        total = self.flops * self.chips
        return self.model_flops / total if total else None

    @property
    def mfu_bound(self) -> Optional[float]:
        """Model-FLOPs utilization at the roofline bound."""
        if not self.model_flops:
            return None
        t = self.step_time_lower_bound
        return self.model_flops / (self.chips * PEAK_FLOPS_BF16 * t) if t else None

    def to_dict(self) -> Dict[str, object]:
        return {
            "card": CARD,
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_memory_flash_s": self.t_memory_flash,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_lower_bound_s": self.step_time_lower_bound,
            "useful_flop_ratio": self.useful_flop_ratio,
            "mfu_bound": self.mfu_bound,
        }


def model_flops_train(n_active_params: float, tokens: int) -> float:
    """6 * N * D for one training step."""
    return 6.0 * n_active_params * tokens


def model_flops_forward(n_active_params: float, tokens: int) -> float:
    """2 * N * D for forward-only (prefill / decode)."""
    return 2.0 * n_active_params * tokens
