"""Device-resident slot scheduler: state layout + multi-token decode dispatch.

Port of the contiguous and paged paths of ``repro/engine/scheduler.py``
(without chunked prefill and speculation).  The
continuous batcher's per-slot state (``cur`` token, ``active`` flag,
``remaining`` budget, the counter tree) lives in device tensors and is
updated inside the dispatch, so the host never round-trips per token.  One
dispatch runs ``k_steps`` decode steps — a Python loop of device work with
no ``.item()``, ``.cpu()`` or tensor-valued ``if`` inside, where the
reference has a ``lax.scan`` — and returns the emitted token grid
``[B, K]`` plus the emission mask for the host to drain in one transfer.

Every slot decodes every step (finished slots produce masked garbage that
is overwritten at the next prefill); ``remaining`` is decremented only
while a slot is active, and a slot deactivates when its budget reaches zero.
With ``paged=True`` each step runs ``model.decode_step_paged``, which pops
blocks as slots cross block boundaries, and the blocks of a slot whose
budget drains go back on the free stack inside the same step, so capacity
recycles mid-dispatch; the allocator's deltas around each step feed the
counters.
"""
from __future__ import annotations

import torch

from repro_torch.engine.paged import BSTATE_KEYS, release_slots
from repro_torch.engine.sampler import SamplingParams, sample
from repro_torch.telemetry.counters import bump, init_counters


def init_slot_state(n_slots: int, device) -> dict:
    """Zeroed device-side slot state for a fresh pool of ``n_slots``."""
    return {
        "cur": torch.zeros((n_slots, 1), dtype=torch.int32, device=device),
        "active": torch.zeros(n_slots, dtype=torch.bool, device=device),
        "remaining": torch.zeros(n_slots, dtype=torch.int32, device=device),
        "ctr": init_counters(device),
    }


def make_decode_dispatch(model, sp: SamplingParams, k_steps: int, *, paged: bool = False):
    """``dispatch(params, state, cache, gen)`` -> (state, cache, tokens
    [B, K], emitted [B, K] bool).  ``emitted[b, j]`` marks tokens produced
    while slot ``b`` was still active — a contiguous prefix per row.
    ``paged=True`` takes the paged cache of ``model.init_paged_cache``."""
    step_fn = model.decode_step_paged if paged else model.decode_step

    @torch.no_grad()
    def dispatch(params, state: dict, cache: dict, gen):
        B = state["cur"].shape[0]
        dev = state["cur"].device
        toks = torch.empty((B, k_steps), dtype=torch.int32, device=dev)
        emitted = torch.empty((B, k_steps), dtype=torch.bool, device=dev)
        st = state
        for j in range(k_steps):
            ctr = st["ctr"]
            if paged:   # allocator deltas around the step count pops / CoW
                nf0, ref0 = cache["n_free"], cache["ref"]
            logits, cache = step_fn(params, st["cur"], cache)
            nxt = sample(logits, gen, sp)
            em = st["active"]
            remaining = st["remaining"] - em.to(torch.int32)
            active = em & (remaining > 0)
            if paged:
                # alloc_step only pops; a CoW pop is the only ref decrement
                ctr = bump(ctr, blocks_popped=nf0 - cache["n_free"],
                           cow_copies=(cache["ref"] < ref0).sum(dtype=torch.int32))
                nf1 = cache["n_free"]
                cache = {**cache, **release_slots({k: cache[k] for k in BSTATE_KEYS},
                                                  em & ~active)}
                ctr = bump(ctr, blocks_released=cache["n_free"] - nf1)
            toks[:, j] = nxt
            emitted[:, j] = em
            st = {**st, "cur": nxt[:, None], "active": active, "remaining": remaining,
                  "ctr": bump(ctr, tokens=em.sum())}
        return st, cache, toks, emitted

    return dispatch
