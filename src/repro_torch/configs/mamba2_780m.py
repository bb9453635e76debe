"""Mamba-2 780M: attention-free SSM stack using SSD (state-space duality).

[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,             # attention-free
    n_kv_heads=0,
    d_ff=0,                # no MLP; the Mamba block is the mixer+channel layer
    vocab_size=50280,
    ssm_state=128,
    d_inner=3072,          # 2 * d_model
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_kernel=4,
    source="arXiv:2405.21060; unverified",
    subquadratic=True,
    notes="SSD: chunked matmul-form scan; constant-size recurrent state at decode.",
)
