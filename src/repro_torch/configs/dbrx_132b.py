"""dbrx-132b [moe] — 16 fine-grained experts, top-4 routing.
[hf:databricks/dbrx-base]

40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per-expert) vocab=100352.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    attention="gqa",
    n_experts=16,
    n_shared_experts=0,
    experts_per_token=4,
    d_expert=10752,
    rope_theta=500_000.0,
    mlp_act="silu",
    citation="hf:databricks/dbrx-base",
)

SMOKE = ModelConfig(
    name="dbrx-smoke",
    arch_type="moe",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    attention="gqa",
    n_experts=4,
    n_shared_experts=0,
    experts_per_token=2,
    d_expert=256,
    mlp_act="silu",
)
