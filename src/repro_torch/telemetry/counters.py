"""Device-resident engine counters, riding the slot state.

Port of ``repro/telemetry/counters.py``: the same keys in the same order.
The counters are int32 scalars on the device, held in ``state["ctr"]`` and
bumped inside the decode and speculative dispatches (and the paged
admission and eviction) where each event happens; the host reads them in
the same transfer that drains the token grid — no extra sync.  Allocator
pops and releases are measured as ``n_free`` / ``ref`` deltas around the
``engine/paged.py`` primitives.  The per-dispatch ``drafted`` /
``accepted`` deltas feed the speculative depth controller
(``engine/spec.py::DepthController``).

Conservation (asserted by ``Engine(check_invariants=True)``):
``live0 + blocks_popped - blocks_released == num_blocks - n_free``, where
``live0`` is the blocks the prefix index held when the serve began; and
``drafted == accepted + rejected``.
"""
from __future__ import annotations

import torch

COUNTER_KEYS = (
    "tokens",            # tokens emitted through the dispatch grids
                         # (decode and speculative emissions, and first
                         # tokens of in-dispatch prefill completions; a
                         # one-shot prefill's first token is the host's)
    "drafted",           # spec: draft positions proposed (depth x active)
    "accepted",          # spec: verifier-agreement prefix lengths summed
    "rejected",          # spec: drafted - accepted (rolled-back positions)
    "blocks_popped",     # pool blocks popped (decode alloc, span alloc,
                         # admission alloc; CoW pops included)
    "blocks_released",   # pool blocks pushed back on the free stack (slot
                         # drains, zero-budget and stale-slot releases)
    "cow_copies",        # copy-on-write pops (a write into a shared block
                         # popped a private copy first)
    "prefix_hit_tokens", # prompt tokens served from the prefix cache,
                         # counted at admission as pf_start, the tokens
                         # actually skipped (== host stats["prefix_hits"])
    "chunk_pieces",      # in-dispatch prefill chunk pieces run
    "chunks_completed",  # prompts that finished in-dispatch prefill
    "blocked_retries",   # spec: slots masked out of a round (their CoW pop
                         # failed, pool dry); they retry the next round
)


def init_counters(device) -> dict:
    """Zeroed counter tree on ``device``."""
    return {k: torch.zeros((), dtype=torch.int32, device=device) for k in COUNTER_KEYS}


def bump(ctr: dict, **deltas) -> dict:
    """Counters with ``deltas`` added (bool sums and tensors cast to int32)."""
    out = dict(ctr)
    for k, d in deltas.items():
        out[k] = out[k] + torch.as_tensor(d, device=out[k].device).to(torch.int32)
    return out


def counter_totals(ctr_host: dict) -> dict:
    """Host-side view of a fetched counter tree as plain ints."""
    return {k: int(ctr_host[k]) for k in COUNTER_KEYS}
