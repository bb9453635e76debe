"""Device-resident engine counters, riding the slot state.

Port of the token counter of ``repro/telemetry/counters.py``.  The counters
are int32 scalars on the device, held in ``state["ctr"]`` and bumped inside
the decode dispatch where each event happens; the host reads them in the
same transfer that drains the token grid — no extra sync.  The contiguous
path counts one event so far: tokens emitted through the dispatch grid.
"""
from __future__ import annotations

import torch

COUNTER_KEYS = (
    "tokens",            # tokens emitted through the dispatch grids (the
                         # first token of each request comes from prefill,
                         # on the host side)
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
