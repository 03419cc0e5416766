"""qwen2.5-32b [dense] — GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B]

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    attention="gqa",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_act="silu",
    citation="hf:Qwen/Qwen2.5-0.5B",
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    attention="gqa",
    qkv_bias=True,
    mlp_act="silu",
)
