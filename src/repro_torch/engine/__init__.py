"""Serving engine: continuous batching, batched or chunked prefill, paged
KV cache with prefix caching.

    from repro_torch.engine import Engine, SamplingParams

    eng = Engine(model, params, slots=8, cache_len=256, k_steps=8)
    outputs = eng.serve(requests, gen_tokens=64)

    eng = Engine(model, params, slots=8, cache_len=560, paged=True,
                 chunk_size=64, prefix_cache=True)

    eng = Engine(model, params, slots=8, cache_len=256, paged=True,
                 n_spec=4, draft_params=qparams)     # self-speculation

See engine.py (host/device split), scheduler.py (slot state, K-step
dispatch, in-dispatch chunked prefill), spec.py (speculative rounds,
acceptance rules, the depth controller), paged.py (block pool, block
tables, device free list, refcounts, copy-on-write), prefix.py (the host's
chained-hash prompt-block index) and sampler.py.
"""
from repro_torch.engine.engine import Engine, EngineConfig
from repro_torch.engine.paged import (admit_slot, alloc_admit, alloc_span, alloc_step,
                                      blocks_for, gather_blocks, init_block_state,
                                      release_refs, release_slots, span_targets)
from repro_torch.engine.prefix import PrefixIndex, chain_hashes
from repro_torch.engine.sampler import SamplingParams, probs, sample, warp_logits
from repro_torch.engine.scheduler import (chunk_prefill_substep, init_slot_state,
                                          make_decode_dispatch)
from repro_torch.engine.spec import (DepthController, greedy_accept, make_spec_dispatch,
                                     rejection_accept)

__all__ = ["Engine", "EngineConfig", "SamplingParams", "sample", "probs",
           "warp_logits", "init_slot_state", "make_decode_dispatch", "chunk_prefill_substep",
           "PrefixIndex", "chain_hashes", "admit_slot", "alloc_admit", "alloc_span",
           "alloc_step", "blocks_for", "gather_blocks", "init_block_state", "release_refs",
           "release_slots", "span_targets", "DepthController", "greedy_accept",
           "rejection_accept", "make_spec_dispatch"]
