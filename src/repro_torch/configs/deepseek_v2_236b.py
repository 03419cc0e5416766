"""deepseek-v2-236b [moe] — MLA kv_lora=512; 2 shared + 160 routed top-6.
[arXiv:2405.04434]

60L d_model=5120 128H (kv=128) d_ff=1536 (per-expert) vocab=102400.
MLA: q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128.
Layer 0 is dense (first_k_dense=1) as in the reference model.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    experts_per_token=6,
    d_expert=1536,
    first_k_dense=1,
    rope_theta=10_000.0,
    mlp_act="silu",
    citation="arXiv:2405.04434",
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke",
    arch_type="moe",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    d_ff=256,
    vocab_size=512,
    attention="mla",
    q_lora_rank=96,
    kv_lora_rank=64,
    qk_nope_dim=32,
    qk_rope_dim=16,
    v_head_dim=32,
    n_experts=4,
    n_shared_experts=1,
    experts_per_token=2,
    d_expert=128,
    first_k_dense=1,
    mlp_act="silu",
)
