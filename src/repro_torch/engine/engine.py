"""Continuous-batching serving engine with a device-resident decode loop.

Port of the contiguous path of ``repro/engine/engine.py``.  The host keeps
only the request queue and a mirror of each slot's budget, maintained from
the results it already fetched; everything per token lives on the device:

* **decode** — one dispatch runs ``k_steps`` decode steps with no host sync
  inside (scheduler.make_decode_dispatch); the host syncs once per dispatch
  and drains the ``[B, K]`` token grid, the emission mask and the counter
  tree in a single device-to-host transfer.
* **prefill** — the free slots' pending prompts go through one right-padded
  ``model.prefill`` call and their cache rows are written into the live
  cache in place.  When the whole pool is (re)filled at once the returned
  cache simply replaces the live one.
* **sampling** — greedy / temperature / top-k / top-p via engine.sampler,
  drawing from one ``torch.Generator`` seeded per ``serve`` call.

The paged KV cache, prefix caching, chunked prefill and speculative
decoding of the reference engine are not ported yet.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from repro_torch.engine.sampler import SamplingParams, sample
from repro_torch.engine.scheduler import init_slot_state, make_decode_dispatch
from repro_torch.telemetry.counters import COUNTER_KEYS, counter_totals


@dataclass(frozen=True)
class EngineConfig:
    slots: int = 2          # size of the continuous-batching pool
    cache_len: int = 256    # decode cache capacity per slot
    k_steps: int = 8        # decode steps per dispatch (1 host sync each)
    sampling: SamplingParams = field(default_factory=SamplingParams)
    seed: int = 0


class Engine:
    """Continuous-batching serving engine over a built :class:`Model`."""

    def __init__(self, model, params, cfg: EngineConfig | None = None, **kw):
        if cfg is None:
            cfg = EngineConfig(**kw)
        elif kw:
            raise TypeError("pass either cfg= or keyword fields, not both")
        if cfg.k_steps < 1:
            raise ValueError(f"k_steps must be >= 1, got {cfg.k_steps}")
        self.model = model
        self.params = params
        self.cfg = cfg
        self._dispatch = make_decode_dispatch(model, cfg.sampling, cfg.k_steps)

    # -- batched prefill + admission ------------------------------------------

    @staticmethod
    def _scatter(cache, state, part, slots, first, rem0):
        """Write ``part``'s rows (batch axis 1 under the layer axis) into the
        live cache at ``slots`` and arm the slot state, in place."""
        for name, full in cache["stack"]["L0"].items():
            full[:, slots] = part["stack"]["L0"][name].to(full.dtype)
        cache["lengths"][slots] = part["lengths"]
        state["cur"][slots, 0] = first
        state["active"][slots] = rem0 > 0
        state["remaining"][slots] = rem0
        return cache, state

    def _admit(self, cache, state, free_slots, prompts, gen_tokens, gen):
        """Prefill ``prompts`` into ``free_slots`` with one right-padded
        prefill call (exact: the port's models are pure causal-attention
        stacks, where pad rows never feed real rows).  Returns (cache, state,
        first tokens as host ints)."""
        B = self.cfg.slots
        dev = self.model.device
        lens = [int(p.shape[0]) for p in prompts]
        Lmax = max(lens)
        toks = torch.stack([F.pad(p, (0, Lmax - L)) for p, L in zip(prompts, lens)])
        glens = None if min(lens) == Lmax else \
            torch.tensor(lens, dtype=torch.int32, device=dev)
        logits, part = self.model.prefill(self.params, {"tokens": toks},
                                          cache_len=self.cfg.cache_len, lengths=glens)
        first = sample(logits, gen, self.cfg.sampling)
        rem0 = gen_tokens - 1
        if free_slots == list(range(B)):
            # the whole pool refills at once: the prefill result IS the new cache
            cache = part
            state = {**state, "cur": first[:, None].clone(),
                     "active": torch.full((B,), rem0 > 0, device=dev),
                     "remaining": torch.full((B,), rem0, dtype=torch.int32, device=dev)}
        else:
            cache, state = self._scatter(cache, state, part,
                                         torch.tensor(free_slots, device=dev), first, rem0)
        return cache, state, [int(t) for t in first.tolist()]

    # -- serve ----------------------------------------------------------------

    def serve(self, requests, *, gen_tokens: int, seed: int | None = None,
              return_stats: bool = False):
        """Serve ``requests`` (1-D token sequences); each gets ``gen_tokens``
        generated tokens.  Returns outputs in request order (and a stats dict
        when ``return_stats``)."""
        cfg, model = self.cfg, self.model
        B, K = cfg.slots, cfg.k_steps
        dev = model.device
        requests = [torch.as_tensor(r, dtype=torch.int32).reshape(-1).to(dev)
                    for r in requests]
        stats = {"host_syncs": 0, "dispatches": 0, "prefill_calls": 0,
                 "decode_steps": 0, "tokens": 0, "prefill_tokens": 0,
                 "prefill_s": 0.0, "decode_s": 0.0,
                 "counters": dict.fromkeys(COUNTER_KEYS, 0)}
        if gen_tokens < 1 or not requests:
            return ([], stats) if return_stats else []
        outputs: dict[int, list[int]] = {}
        cache = model.init_cache(B, cfg.cache_len)
        stats["cache_bytes"] = sum(t.numel() * t.element_size()
                                   for t in cache["stack"]["L0"].values()) \
            + cache["lengths"].numel() * 4
        state = init_slot_state(B, dev)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed if seed is None else seed)
        queue = deque(range(len(requests)))
        slot_rid = [-1] * B     # request id per slot (host mirror)
        slot_rem = [0] * B      # remaining budget     (host mirror)
        ctr_host = None

        while queue or any(r >= 0 for r in slot_rid):
            free = [s for s in range(B) if slot_rid[s] < 0]
            if queue and free:
                take_slots = free[:min(len(free), len(queue))]
                rids = [queue.popleft() for _ in take_slots]
                t0 = time.perf_counter()
                cache, state, first = self._admit(
                    cache, state, take_slots, [requests[r] for r in rids],
                    gen_tokens, gen)
                stats["prefill_s"] += time.perf_counter() - t0
                stats["prefill_calls"] += 1
                stats["host_syncs"] += 1
                stats["tokens"] += len(rids)
                stats["prefill_tokens"] += sum(int(requests[r].shape[0]) for r in rids)
                for s, r, t in zip(take_slots, rids, first):
                    outputs[r] = [t]
                    slot_rid[s], slot_rem[s] = r, gen_tokens - 1
                    if slot_rem[s] <= 0:      # gen_tokens == 1 finishes now
                        slot_rid[s] = -1
            if not any(r >= 0 for r in slot_rid):
                continue

            t0 = time.perf_counter()
            state, cache, toks, emitted = self._dispatch(self.params, state, cache, gen)
            # one transfer: token grid, emission mask and counters together
            packed = torch.cat([toks.reshape(-1), emitted.reshape(-1).to(torch.int32),
                                torch.stack([state["ctr"][k] for k in COUNTER_KEYS])])
            host = packed.cpu().numpy()
            stats["decode_s"] += time.perf_counter() - t0
            toks_h = host[:B * K].reshape(B, K)
            em_h = host[B * K:2 * B * K].reshape(B, K).astype(bool)
            ctr_host = dict(zip(COUNTER_KEYS, host[2 * B * K:]))
            stats["host_syncs"] += 1
            stats["dispatches"] += 1
            stats["decode_steps"] += K
            for s in range(B):
                r = slot_rid[s]
                if r < 0:
                    continue
                row = [int(t) for t in toks_h[s][em_h[s]]]
                outputs[r].extend(row)
                stats["tokens"] += len(row)
                slot_rem[s] -= len(row)
                if slot_rem[s] <= 0:
                    slot_rid[s] = -1

        if ctr_host is not None:
            stats["counters"] = counter_totals(ctr_host)
        outs = [outputs[i] for i in sorted(outputs)]
        return (outs, stats) if return_stats else outs
