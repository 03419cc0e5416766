"""qwen1.5-0.5b [dense] — GQA (MHA-equal kv) with QKV bias.
[hf:Qwen/Qwen1.5-0.5B]

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    attention="gqa",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    mlp_act="silu",
    citation="hf:Qwen/Qwen1.5-0.5B",
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=512,
    attention="gqa",
    qkv_bias=True,
    tie_embeddings=True,
    mlp_act="silu",
)
