"""phi-3-vision-4.2b [vlm] — phi3-mini language backbone + CLIP frontend.

[hf:microsoft/Phi-3-vision-128k-instruct]
32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.

The CLIP ViT encoder + projector are a stub, as in the JAX package: the
batch carries pre-computed patch embeddings ``vision_embeds`` (B, 144,
d_model) that the decoder consumes ahead of the token stream.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    attention="gqa",
    rope_theta=10_000.0,
    frontend_tokens=144,
    mlp_act="silu",
    citation="hf:microsoft/Phi-3-vision-128k-instruct",
)

SMOKE = ModelConfig(
    name="phi-3-vision-smoke",
    arch_type="vlm",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=512,
    attention="gqa",
    frontend_tokens=16,
    mlp_act="silu",
)
