"""qwen3-32b [dense] — GQA + per-head qk-norm.  [hf:Qwen/Qwen3-8B]

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, head_dim=128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    attention="gqa",
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_act="silu",
    citation="hf:Qwen/Qwen3-8B",
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    head_dim=32,
    attention="gqa",
    qk_norm=True,
    mlp_act="silu",
)
