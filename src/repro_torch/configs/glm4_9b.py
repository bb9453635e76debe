"""GLM-4-9B: dense decoder-only, RoPE + GQA (2 KV heads).

[hf:THUDM/glm-4-9b; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=10000.0,
    qkv_bias=True,
    source="hf:THUDM/glm-4-9b; hf",
    subquadratic=False,
    notes="GQA kv=2; qkv bias per GLM-4 reference implementation.",
)
