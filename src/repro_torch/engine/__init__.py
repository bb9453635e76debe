"""Serving engine (contiguous KV cache, continuous batching, batched prefill).

    from repro_torch.engine import Engine, SamplingParams

    eng = Engine(model, params, slots=8, cache_len=256, k_steps=8)
    outputs = eng.serve(requests, gen_tokens=64)
"""
from repro_torch.engine.engine import Engine, EngineConfig
from repro_torch.engine.sampler import SamplingParams, probs, sample, warp_logits
from repro_torch.engine.scheduler import init_slot_state, make_decode_dispatch

__all__ = ["Engine", "EngineConfig", "SamplingParams", "sample", "probs",
           "warp_logits", "init_slot_state", "make_decode_dispatch"]
