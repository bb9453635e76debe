"""Architecture registry: ``get_arch(<id>)`` + reduced smoke configs.

The port registers the architectures its model code runs (the dense family
so far); ``reduced`` is the reference's rule for tiny same-family configs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.glm4_9b import CONFIG as _glm4

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (_glm4,)}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig, *, vocab: int = 512) -> ModelConfig:
    """A tiny config of the same family (same rule as ``repro.configs.reduced``
    for the families the port runs)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=64,
        vocab_size=vocab,
        d_ff=128 if cfg.d_ff else 0,
        head_dim=16,
        n_heads=4,
        n_kv_heads=max(1, min(2, cfg.n_kv_heads)),
        notes="reduced smoke config",
    )
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    return dataclasses.replace(cfg, **kw)
