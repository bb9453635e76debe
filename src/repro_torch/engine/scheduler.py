"""Device-resident slot scheduler: state layout + multi-token decode dispatch.

Port of the contiguous path of ``repro/engine/scheduler.py``.  The
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
"""
from __future__ import annotations

import torch

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


def make_decode_dispatch(model, sp: SamplingParams, k_steps: int):
    """``dispatch(params, state, cache, gen)`` -> (state, cache, tokens
    [B, K], emitted [B, K] bool).  ``emitted[b, j]`` marks tokens produced
    while slot ``b`` was still active — a contiguous prefix per row."""

    @torch.no_grad()
    def dispatch(params, state: dict, cache: dict, gen):
        B = state["cur"].shape[0]
        dev = state["cur"].device
        toks = torch.empty((B, k_steps), dtype=torch.int32, device=dev)
        emitted = torch.empty((B, k_steps), dtype=torch.bool, device=dev)
        st = state
        for j in range(k_steps):
            logits, cache = model.decode_step(params, st["cur"], cache)
            nxt = sample(logits, gen, sp)
            em = st["active"]
            remaining = st["remaining"] - em.to(torch.int32)
            toks[:, j] = nxt
            emitted[:, j] = em
            st = {**st, "cur": nxt[:, None], "active": em & (remaining > 0),
                  "remaining": remaining, "ctr": bump(st["ctr"], tokens=em.sum())}
        return st, cache, toks, emitted

    return dispatch
