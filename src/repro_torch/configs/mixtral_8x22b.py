"""Mixtral 8x22B: MoE decoder-only, 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1000000.0,
    source="arXiv:2401.04088; hf",
    subquadratic=True,     # SWA bounds the decode KV cache to the window
    notes="8 experts top-2, SWA window 4096 -> decode KV cache is O(window).",
)
