"""hubert-xlarge [audio] — encoder-only masked-unit prediction.
[arXiv:2106.07447]

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (k-means unit codebook).
The mel/conv feature extractor is a stub, as in the JAX package: the
batch carries frame embeddings ``frames`` (B, T, d_model), and training
predicts the cluster ids ``labels`` of the frames ``mask`` selects.
Encoder-only: no decode step and no cache.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    attention="gqa",
    is_encoder=True,
    mlp_act="gelu",
    mask_prob=0.08,
    citation="arXiv:2106.07447",
)

SMOKE = ModelConfig(
    name="hubert-smoke",
    arch_type="audio",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=64,
    attention="gqa",
    is_encoder=True,
    mlp_act="gelu",
)
