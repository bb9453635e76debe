"""Architecture registry: ``get_arch(<id>)`` + reduced smoke configs.

The port registers the architectures its model code runs: the dense, SSM
and MoE families, sliding-window attention included (Mixtral's ring
caches); ``reduced`` is the reference's rule for tiny same-family configs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.deepseek_v3 import CONFIG as _dsv3
from repro_torch.configs.glm4_9b import CONFIG as _glm4
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (_glm4, _mamba2, _dsv3, _mixtral)}

# families whose model code the port runs (models/lm.py::layer_plan)
PORTED_FAMILIES = ("dense", "ssm", "moe")


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig, *, vocab: int = 512) -> ModelConfig:
    """A tiny config of the same family (same rule as ``repro.configs.reduced``
    for the families the port runs)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  "(ROADMAP Queue A 5)")
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=64,
        vocab_size=vocab,
        d_ff=128 if cfg.d_ff else 0,
        head_dim=16,
        notes="reduced smoke config",
    )
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = max(1, min(2, cfg.n_kv_heads))
    if cfg.family == "moe":
        kw["n_experts"] = min(8, cfg.n_experts)
        kw["top_k"] = min(2, cfg.top_k)
        if cfg.n_shared_experts:
            kw["n_shared_experts"] = 1
        if cfg.first_k_dense:
            kw["first_k_dense"] = 1
            kw["d_ff_dense"] = 192
    if cfg.family == "ssm":
        kw["ssm_state"] = 16
        kw["d_inner"] = 128
        kw["ssm_head_dim"] = 16
        kw["ssm_chunk"] = 32
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    return dataclasses.replace(cfg, **kw)
