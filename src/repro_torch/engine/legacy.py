"""The pre-engine host-driven serving loop, kept as a benchmark baseline.

Port of ``repro/engine/legacy.py``: a batch-1 prefill per request with its
cache rows written into the request's slot, and a blocking ``int()`` host
sync per slot per decoded token.  A serve benchmark races it against the
device-resident engine (``Engine``), and on the CPU its greedy output equals
the contiguous engine's token for token.  Sampling goes through
:mod:`repro_torch.engine.sampler`, drawing from one ``torch.Generator``
seeded by ``seed``.
"""
from __future__ import annotations

import torch

from repro_torch.engine.sampler import SamplingParams, sample
from repro_torch.engine.scheduler import make_decode_step


@torch.no_grad()
def single_slot_prefill(model, params, cache, tokens_row, slot: int, cache_len: int):
    """Prefill one request into ``slot`` of a live contiguous batch cache.

    Runs a batch-1 prefill of ``tokens_row`` [S] and writes its per-layer
    cache rows and length into the slot, in place.  Returns (last-token
    logits [V], cache)."""
    logits, one = model.prefill(params, {"tokens": tokens_row[None]}, cache_len=cache_len)
    for name, full in cache["stack"]["L0"].items():
        full[:, slot] = one["stack"]["L0"][name][:, 0].to(full.dtype)
    cache["lengths"][slot] = one["lengths"][0]
    return logits[0], cache


def serve_host_loop(model, params, requests, *, batch: int, gen_tokens: int, cache_len: int,
                    sampling: SamplingParams | None = None, seed: int = 0,
                    return_stats: bool = False):
    """Serve ``requests`` (1-D token sequences) with the old ``batch``-slot
    host-scheduled batcher: each gets ``gen_tokens`` tokens.  Returns the
    outputs in request order (and, with ``return_stats``, the counts
    ``host_syncs``, ``dispatches``, ``prefill_calls``, ``decode_steps``,
    ``tokens``)."""
    sp = sampling or SamplingParams()
    step = make_decode_step(model, sp)
    dev = model.device
    requests = [torch.as_tensor(r, dtype=torch.int32).reshape(-1).to(dev) for r in requests]
    cache = model.init_cache(batch, cache_len)
    cur = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    active = [-1] * batch                 # request id per slot
    remaining = [0] * batch
    outputs: dict[int, list[int]] = {}
    queue = list(range(len(requests)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    stats = {"host_syncs": 0, "dispatches": 0, "prefill_calls": 0,
             "decode_steps": 0, "tokens": 0}

    def fill_slot(slot, cache, cur):
        rid = queue.pop(0)
        logits, cache = single_slot_prefill(model, params, cache, requests[rid], slot,
                                            cache_len)
        nxt = int(sample(logits[None], gen, sp)[0])
        stats["prefill_calls"] += 1
        stats["host_syncs"] += 1
        stats["tokens"] += 1
        cur[slot, 0] = nxt
        outputs[rid] = [nxt]
        active[slot] = rid
        remaining[slot] = gen_tokens - 1
        return cache, cur

    for slot in range(batch):
        if queue:
            cache, cur = fill_slot(slot, cache, cur)

    while any(a >= 0 for a in active):
        cur, _, cache = step(params, cur, cache, gen)
        stats["dispatches"] += 1
        stats["decode_steps"] += 1
        for slot in range(batch):
            rid = active[slot]
            if rid < 0:
                continue
            outputs[rid].append(int(cur[slot, 0]))     # 1 sync per slot-token
            stats["host_syncs"] += 1
            stats["tokens"] += 1
            remaining[slot] -= 1
            if remaining[slot] <= 0:
                active[slot] = -1
                if queue:
                    cache, cur = fill_slot(slot, cache, cur)
    outs = [outputs[i] for i in sorted(outputs)]
    return (outs, stats) if return_stats else outs
