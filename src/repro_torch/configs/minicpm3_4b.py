"""minicpm3-4b [dense] — MLA (multi-head latent attention).
[hf:openbmb/MiniCPM3-4B]

62L d_model=2560 40H (GQA kv=40) d_ff=6400 vocab=73448; MLA with
q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64 (model card).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    rope_theta=10_000.0,
    mlp_act="silu",
    citation="hf:openbmb/MiniCPM3-4B",
)

SMOKE = ModelConfig(
    name="minicpm3-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=512,
    attention="mla",
    q_lora_rank=96,
    kv_lora_rank=64,
    qk_nope_dim=32,
    qk_rope_dim=16,
    v_head_dim=32,
    mlp_act="silu",
)
