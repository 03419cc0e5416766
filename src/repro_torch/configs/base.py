"""Architecture configuration schema (the port's copy of
``repro/configs/base.py``, field for field).

One frozen dataclass describes every architecture in the assigned pool —
dense GQA decoders, MLA, MoE, SSD state-space, RG-LRU hybrids, encoder-only
audio and VLM backbones — plus the paper's own CIFAR-scale FL models.
``src/repro/configs/<id>.py`` instantiates one ``ModelConfig`` each.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0              # 0 => d_model // n_heads

    # ---- attention flavour ------------------------------------------------
    attention: str = "gqa"         # gqa | mla | none (ssm)
    qkv_bias: bool = False         # qwen1.5 / qwen2.5 / phi-3
    qk_norm: bool = False          # qwen3
    rope_theta: float = 10_000.0
    local_attn_window: int = 0     # recurrentgemma local attention
    sliding_window: int = 0        # serve-time ring-cache window for long ctx
                                   # (first-class long_500k option; 0 = full)

    # ---- MLA (multi-head latent attention) ---------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # ---- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    d_expert: int = 0              # per-expert FFN width (d_ff for shared path)
    first_k_dense: int = 0         # leading dense layers (deepseek-v2 layer 0)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    # ---- SSM (mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # ---- hybrid (recurrentgemma) ----------------------------------------------
    layer_pattern: Tuple[str, ...] = ()   # e.g. ("rglru","rglru","attn") cycle
    lru_width: int = 0
    lru_gate_blocks: int = 0      # >0: block-diagonal r/i gates (Griffin's
                                  # actual layout).  Blocks ride the tensor
                                  # axis, so gate matmuls contract locally —
                                  # no per-gate all-reduce (see §Perf)

    # ---- encoder / multimodal ---------------------------------------------------
    is_encoder: bool = False       # hubert: bidirectional, no decode step
    frontend_tokens: int = 0       # stub frontend: # patch/frame embeddings
    mask_prob: float = 0.08        # hubert masked-prediction rate

    # ---- misc ---------------------------------------------------------------------
    mlp_act: str = "silu"          # silu (swiglu) | gelu (plain 2-layer, hubert)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    citation: str = ""

    # ------------------------------------------------------------------ helpers
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_decoder(self) -> bool:
        return not self.is_encoder

    @property
    def supports_long_context(self) -> bool:
        """Can this arch serve 500k-token contexts sub-quadratically?"""
        return (
            self.arch_type in ("ssm", "hybrid")
            or self.sliding_window > 0
            or self.local_attn_window > 0
        )

    def layer_kind(self, i: int) -> str:
        """Block kind of layer i: attn | rglru | ssm."""
        if self.arch_type == "ssm":
            return "ssm"
        if self.layer_pattern:
            return self.layer_pattern[i % len(self.layer_pattern)]
        return "attn"

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND roofline math."""
        d, f, v, l = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.resolved_head_dim
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(l):
            kind = self.layer_kind(i)
            if kind == "attn":
                if self.attention == "mla":
                    q = (
                        d * self.q_lora_rank
                        + self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                        if self.q_lora_rank
                        else d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    )
                    kv = d * (self.kv_lora_rank + self.qk_rope_dim)
                    kv += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    o = self.n_heads * self.v_head_dim * d
                    total += q + kv + o
                else:
                    total += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            elif kind == "rglru":
                w = self.lru_width or d
                total += 2 * d * w + w * d + 3 * w  # in/out proj + gates (approx)
            elif kind == "ssm":
                d_in = self.ssm_expand * d
                total += d * (2 * d_in + 2 * self.ssm_state + self.ssm_heads) + d_in * d
            # FFN (every block has one; MoE layers after the first_k_dense)
            if kind == "ssm":
                continue  # mamba blocks have no separate FFN
            if self.n_experts and i >= self.first_k_dense:
                fe = self.d_expert or f
                total += self.n_experts * 3 * d * fe
                total += self.n_shared_experts * 3 * d * fe
                total += d * self.n_experts  # router
            else:
                mult = 3 if self.mlp_act == "silu" else 2
                total += mult * d * f
        return total

    def active_param_count(self) -> int:
        """Active params per token (= param_count for dense; routed subset for MoE)."""
        if not self.n_experts:
            return self.param_count()
        d, l = self.d_model, self.n_layers
        fe = self.d_expert or self.d_ff
        inactive_experts = self.n_experts - self.experts_per_token
        dead = (l - self.first_k_dense) * inactive_experts * 3 * d * fe
        return self.param_count() - dead
