"""Device-resident slot scheduler: state layout + multi-token decode dispatch.

Port of ``repro/engine/scheduler.py``.  The continuous batcher's per-slot state (``cur`` token, ``active`` flag,
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

**Chunked prefill** (``chunk > 0``, paged only): prompt prefill rides inside
the dispatch.  Each of the K steps is a decode sub-step for the decoding
slots followed by a ``chunk``-token prefill piece for the slots still in
their prefill phase (state fields ``prompt`` / ``pf_pos`` / ``pf_len`` /
``budget`` / ``pf_shared``, armed by the engine's admission), so a long
prompt streams ``K * chunk`` tokens a dispatch while the other slots keep
emitting.  The step a slot's last chunk lands, its first token is sampled
from the chunk's logits and emitted through the token grid, and it decodes
from the next step on: the one-shot engine's "prefill, sample, decode"
order.  The two sub-steps share one batch, so each restores the per-slot
``lengths`` of the slots in the other phase (``_keep_rows``).

**Speculation** (``n_spec > 0``, paged only): each of the K steps becomes a
speculative round (``engine/spec.py``), which composes with copy-on-write
and the chunked-prefill piece the same way.
"""
from __future__ import annotations

import torch

from repro_torch.engine.paged import BSTATE_KEYS, release_slots
from repro_torch.engine.sampler import SamplingParams, sample
from repro_torch.telemetry.counters import bump, init_counters


def init_slot_state(n_slots: int, device, prompt_cap: int = 0) -> dict:
    """Zeroed device-side slot state for a fresh pool of ``n_slots``.
    ``prompt_cap > 0`` adds the chunked-prefill fields: a prompt buffer per
    slot, the prefill cursor and length, the decode budget after the first
    token and the prefix-hit watermark."""
    i32 = dict(dtype=torch.int32, device=device)
    st = {
        "cur": torch.zeros((n_slots, 1), **i32),
        "active": torch.zeros(n_slots, dtype=torch.bool, device=device),
        "remaining": torch.zeros(n_slots, **i32),
        "ctr": init_counters(device),
    }
    if prompt_cap:
        st["prompt"] = torch.zeros((n_slots, prompt_cap), **i32)
        st["pf_pos"] = torch.zeros(n_slots, **i32)      # next prompt row
        st["pf_len"] = torch.zeros(n_slots, **i32)      # prompt length
        st["budget"] = torch.zeros(n_slots, **i32)      # decode budget
        st["pf_shared"] = torch.zeros(n_slots, **i32)   # prefix-hit watermark
    return st


def _keep_rows(new_cache: dict, old_cache: dict, keep: torch.Tensor) -> dict:
    """Merge two paged caches per slot: ``lengths`` of the slots in ``keep``
    come from ``new_cache``, the others' from ``old_cache``.  The reference
    selects every per-slot leaf here; the port writes the pools in place
    and the dense stack has no other per-slot leaf, so ``lengths`` is all
    there is to select.  That relies on the sub-step having sent every
    write of a slot outside ``keep`` to the trash block (``alloc_step`` for
    inactive slots, ``span_targets`` for ``valid == 0``)."""
    return {**new_cache,
            "lengths": torch.where(keep, new_cache["lengths"], old_cache["lengths"])}


def chunk_prefill_substep(model, sp: SamplingParams, chunk: int, params, st: dict,
                          cache: dict, gen, tiles=(0, 0)):
    """One in-dispatch prefill piece: the prefill phase of a dispatch step.

    Runs a ``chunk``-token piece for every slot still prefilling (``pf_pos <
    pf_len``) through ``model.prefill_chunk_paged`` (flash ``tiles`` as the
    one-shot prefill's), keeps the other slots' lengths, samples the first
    token of the slots whose last piece just landed, arms them for decode,
    and releases the blocks of those with no decode budget.  Returns
    ``(st, cache, first [B], completed [B])``."""
    pcap = st["prompt"].shape[1]
    pf_left = st["pf_len"] - st["pf_pos"]
    valid = pf_left.clamp(0, chunk)
    prefilling = valid > 0
    idx = (st["pf_pos"][:, None]
           + torch.arange(chunk, dtype=torch.int32, device=valid.device)[None]).clamp(0, pcap - 1)
    toks = torch.gather(st["prompt"], 1, idx.long())
    logits, new_cache = model.prefill_chunk_paged(params, toks, cache, st["pf_pos"], valid,
                                                  st["pf_shared"], tiles=tiles)
    cache = _keep_rows(new_cache, cache, prefilling)
    completed = prefilling & (pf_left <= chunk)
    first = sample(logits, gen, sp)
    go = completed & (st["budget"] > 0)
    cache = {**cache, "slot_active": cache["slot_active"] | go}
    nf0 = cache["n_free"]
    cache = {**cache, **release_slots({k: cache[k] for k in BSTATE_KEYS}, completed & ~go)}
    ctr = bump(st["ctr"], tokens=completed.sum(), chunk_pieces=prefilling.sum(),
               chunks_completed=completed.sum(), blocks_released=cache["n_free"] - nf0)
    st = {**st,
          "cur": torch.where(completed[:, None], first[:, None], st["cur"]),
          "active": st["active"] | go,
          "remaining": torch.where(completed, st["budget"], st["remaining"]),
          "pf_pos": st["pf_pos"] + valid,
          "ctr": ctr}
    return st, cache, first, completed


def make_decode_dispatch(model, sp: SamplingParams, k_steps: int, *, paged: bool = False,
                         cow: bool = False, chunk: int = 0, tiles=(0, 0), n_spec: int = 0):
    """``dispatch(params, state, cache, gen)`` -> (state, cache, tokens
    [B, K], emitted [B, K] bool).  ``emitted[b, j]`` marks tokens produced
    while slot ``b`` was still active — a contiguous prefix per row.
    ``paged=True`` takes the paged cache of ``model.init_paged_cache``;
    ``cow=True`` turns on its copy-on-write decode writes (prefix caching);
    ``chunk > 0`` adds a chunked-prefill piece to every step, its flash
    tiles ``tiles``.  ``n_spec > 0`` returns the speculative dispatch of
    ``engine/spec.py`` instead: ``dispatch(params, draft_params, state,
    cache, depth, gen)``, its grids ``[B, K * (n_spec + 1)]``."""
    if (chunk or n_spec) and not paged:
        raise ValueError("chunked prefill and speculation need the paged cache")
    if n_spec:
        from repro_torch.engine.spec import make_spec_dispatch
        return make_spec_dispatch(model, sp, k_steps, n_spec, cow=cow, chunk=chunk,
                                  tiles=tiles)
    if paged:
        def step_fn(params, toks, cache):
            return model.decode_step_paged(params, toks, cache, cow=cow)
    else:
        step_fn = model.decode_step

    @torch.no_grad()
    def dispatch(params, state: dict, cache: dict, gen):
        B = state["cur"].shape[0]
        dev = state["cur"].device
        toks = torch.empty((B, k_steps), dtype=torch.int32, device=dev)
        emitted = torch.empty((B, k_steps), dtype=torch.bool, device=dev)
        st = state
        for j in range(k_steps):
            # ---- decode sub-step (slots in their decode phase) ----
            ctr = st["ctr"]
            if paged:   # allocator deltas around the step count pops / CoW
                nf0, ref0 = cache["n_free"], cache["ref"]
            logits, new_cache = step_fn(params, st["cur"], cache)
            if chunk:   # prefilling and idle slots keep their lengths
                new_cache = _keep_rows(new_cache, cache, st["active"])
            cache = new_cache
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
            st = {**st, "cur": nxt[:, None], "active": active, "remaining": remaining,
                  "ctr": bump(ctr, tokens=em.sum())}
            # ---- chunked-prefill sub-step ----
            if chunk:
                st, cache, first, completed = chunk_prefill_substep(
                    model, sp, chunk, params, st, cache, gen, tiles)
                nxt = torch.where(completed, first, nxt)
                em = em | completed
                st = {**st, "cur": nxt[:, None]}
            toks[:, j] = nxt
            emitted[:, j] = em
        return st, cache, toks, emitted

    return dispatch


def make_decode_step(model, sp: SamplingParams | None = None):
    """One batch decode step with sampling: ``step(params, tokens, cache,
    gen=None)`` -> (next tokens [B, 1] int32, logits [B, V], cache).  The
    single-step form of the dispatch; the host-loop baseline
    (``engine/legacy.py``) runs it once per token.  ``gen`` is the
    ``torch.Generator`` a sampled step draws from (unused when greedy)."""
    sp = sp or SamplingParams()

    @torch.no_grad()
    def step(params, tokens, cache, gen=None):
        logits, cache = model.decode_step(params, tokens, cache)
        return sample(logits, gen, sp)[:, None], logits, cache

    return step
