"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]

48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128, expand=2, head_dim=64
=> 64 SSD heads.  O(1) decode state => long_500k native.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    ssm_state=128,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    citation="arXiv:2405.21060",
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    arch_type="ssm",
    n_layers=2,
    d_model=256,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    attention="none",
    ssm_state=32,
    ssm_heads=8,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=32,
    conv_width=4,
)
