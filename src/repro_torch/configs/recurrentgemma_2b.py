"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427]

26L d_model=2560 10H (GQA kv=1, MQA) d_ff=7680 vocab=256000;
local attention window 2048; pattern (rglru, rglru, attn) cycling.
Bounded window + O(1) recurrent state => long_500k native.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    attention="gqa",
    layer_pattern=("rglru", "rglru", "attn"),
    lru_width=2560,
    lru_gate_blocks=16,   # Griffin's block-diagonal gates; also keeps gate
                          # contractions shard-local on a 16-way tensor axis
                          # (the §Perf fix for the all-reduce bottleneck)
    local_attn_window=2048,
    rope_theta=10_000.0,
    mlp_act="silu",
    citation="arXiv:2402.19427",
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    arch_type="hybrid",
    n_layers=3,
    d_model=256,
    n_heads=4,
    n_kv_heads=1,
    d_ff=512,
    vocab_size=512,
    attention="gqa",
    layer_pattern=("rglru", "rglru", "attn"),
    lru_width=256,
    local_attn_window=64,
    mlp_act="silu",
)
