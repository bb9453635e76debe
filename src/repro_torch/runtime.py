"""Process-wide runtime flags and device selection.

``flags`` holds the structural knobs the model code reads (the reference's
``repro.runtime.flags`` minus the TPU sharding switches): the MoE routing
group size, attention chunk sizes for the online-softmax loop and the
KV-cache storage dtype.
"""
from __future__ import annotations

import torch

flags: dict = {
    # MoE dispatch group target size (tokens per routing group, models/moe.py)
    "moe_group": 1024,
    # attention q/kv chunk sizes for the online-softmax loop (models/flash.py)
    "q_chunk": 1024,
    "kv_chunk": 1024,
    # KV-cache storage dtype: "bfloat16" | "float8_e4m3fn"
    "kv_cache_dtype": "bfloat16",
}


def get_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Asking for CUDA on a machine without a GPU raises instead of
    silently running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return dev


def cache_dtype() -> torch.dtype:
    return getattr(torch, flags["kv_cache_dtype"])
