"""Continuous-batching serving engine with a device-resident decode loop.

Port of the contiguous and paged paths of ``repro/engine/engine.py``.  The
host keeps only the request queue and a mirror of each slot's budget (and,
paged, its block reservation), maintained from the results it already
fetched; everything per token lives on the device:

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
* **paged KV cache** — ``paged=True`` swaps the per-slot contiguous cache
  for a global block pool with one block table and a device free list
  (engine/paged.py): memory tracks live tokens instead of
  ``slots * cache_len``; admission reserves each request's lifetime worst
  case against the pool on the host (FIFO: requests wait while the head
  does not fit), a prefill's rows are scattered block-wise into the pool,
  and blocks recycle inside the K-step dispatch as slots drain.  Greedy
  outputs equal the contiguous engine's token for token when admission is
  the same (a pool at capacity parity, the default ``num_blocks``).

Prefix caching, chunked prefill and speculative decoding of the reference
engine are not ported yet.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from repro_torch.engine import paged as P
from repro_torch.engine.sampler import SamplingParams, sample
from repro_torch.engine.scheduler import init_slot_state, make_decode_dispatch
from repro_torch.telemetry.counters import COUNTER_KEYS, bump, counter_totals


@dataclass(frozen=True)
class EngineConfig:
    slots: int = 2          # size of the continuous-batching pool
    cache_len: int = 256    # decode cache capacity per slot
    k_steps: int = 8        # decode steps per dispatch (1 host sync each)
    sampling: SamplingParams = field(default_factory=SamplingParams)
    seed: int = 0
    paged: bool = False     # paged KV cache (block pool + block tables)
    block_size: int = 16    # tokens per KV block (paged only)
    num_blocks: int = 0     # pool size; 0 -> slots * ceil(cache_len / block_size)
                            # (capacity parity with the contiguous cache)
    check_invariants: bool = False  # assert allocator conservation after
                                    # every admission and dispatch (slow)


def _tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


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
        if cfg.paged:
            self._mb = P.blocks_for(cfg.cache_len, cfg.block_size)   # blocks per slot
            self._num_blocks = cfg.num_blocks or cfg.slots * self._mb
        self._dispatch = make_decode_dispatch(model, cfg.sampling, cfg.k_steps,
                                              paged=cfg.paged)

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

    @staticmethod
    def _scatter_paged(cache, state, part, slots, lens, first, rem0, counts):
        """Admit one prefilled group into the paged cache: release the target
        slots' stale blocks, allocate ``counts[i]`` fresh blocks per slot,
        scatter the part cache's K/V rows block-wise into the pools in place
        (rows past a slot's need land in the trash block), release again the
        blocks of a slot that owes no decode step (``rem0 == 0``: its one
        token came from the prefill logits), and arm the slot state."""
        B = state["active"].shape[0]
        bstate = {k: cache[k] for k in P.BSTATE_KEYS}
        nf0 = bstate["n_free"]
        done = torch.zeros(B, dtype=torch.bool, device=slots.device).index_fill_(0, slots, True)
        bstate = P.release_slots(bstate, done)
        released = bstate["n_free"] - nf0
        pools = cache["stack"]["L0"]
        nbl = part["stack"]["L0"]["k"].shape[2] // pools["pk"].shape[2]
        nf1 = bstate["n_free"]
        bstate, wids = P.alloc_admit(bstate, slots, counts, nbl)
        popped = nf1 - bstate["n_free"]
        bstate["slot_active"] = bstate["slot_active"].index_fill_(0, slots, rem0 > 0)
        if rem0 <= 0:
            nf2 = bstate["n_free"]
            bstate = P.release_slots(bstate, done)
            released = released + (bstate["n_free"] - nf2)
        wids = wids.reshape(-1).long()
        for name, src in (("pk", part["stack"]["L0"]["k"]), ("pv", part["stack"]["L0"]["v"])):
            n, g, L = src.shape[:3]
            pools[name][:, wids] = src.reshape(n, g * nbl, L // nbl,
                                               *src.shape[3:]).to(pools[name].dtype)
        cache.update(bstate)
        cache["lengths"][slots] = lens
        state["cur"][slots, 0] = first
        state["active"][slots] = rem0 > 0
        state["remaining"][slots] = rem0
        state["ctr"] = bump(state["ctr"], blocks_popped=popped, blocks_released=released)
        return cache, state

    def _group_cache_len(self, Lmax: int) -> int:
        """Prefill cache rows for one admitted group: contiguous, the full
        per-slot capacity; paged, just the block-aligned prompt rows (capped
        at the slot's capacity), so admission memory tracks the prompt."""
        cfg = self.cfg
        if not cfg.paged:
            return cfg.cache_len
        return min(P.blocks_for(Lmax, cfg.block_size), self._mb) * cfg.block_size

    def _blocks_needed(self, prompt_len: int, gen_tokens: int) -> int:
        """Worst-case pool blocks one request can ever hold: it writes
        ``prompt + gen - 1`` cache rows over its lifetime, capped at the
        slot's capacity (the cache drops overflow writes)."""
        return min(P.blocks_for(prompt_len + gen_tokens - 1, self.cfg.block_size), self._mb)

    def _assert_invariants(self, cache, state) -> None:
        """Conservation of the block pool, checked on the device's state
        (one host fetch; for tests and checks): the free stack and the
        referenced blocks partition the pool, every block's refcount equals
        its table references, and the counters account for every block out
        of the free stack (popped - released == live)."""
        bs = {k: cache[k].cpu() for k in P.BSTATE_KEYS}
        NB = self._num_blocks
        n_free = int(bs["n_free"])
        free = bs["free"][:n_free].tolist()
        assert len(set(free)) == n_free, "free stack holds duplicates"
        ref = bs["ref"]
        held = {b for b in range(NB) if int(ref[b]) > 0}
        assert not (set(free) & held), "block both free and referenced"
        assert n_free + len(held) == NB, f"pool leak: {n_free} free + {len(held)} held != {NB}"
        tbl = bs["tbl"]
        counts = torch.bincount(tbl[tbl >= 0].long(), minlength=NB)
        assert torch.equal(ref, counts.to(ref.dtype)), "refcounts differ from table references"
        ctr = counter_totals({k: v.cpu() for k, v in state["ctr"].items()})
        assert ctr["blocks_popped"] - ctr["blocks_released"] == NB - n_free, (
            f"counter leak: popped {ctr['blocks_popped']} - released "
            f"{ctr['blocks_released']} != live {NB - n_free}")

    def _admit(self, cache, state, free_slots, prompts, gen_tokens, gen):
        """Prefill ``prompts`` into ``free_slots`` with one right-padded
        prefill call (exact: the port's models are pure causal-attention
        stacks, where pad rows never feed real rows).  Returns (cache, state,
        first tokens as host ints)."""
        cfg = self.cfg
        B = cfg.slots
        dev = self.model.device
        lens = [int(p.shape[0]) for p in prompts]
        Lmax = max(lens)
        toks = torch.stack([F.pad(p, (0, Lmax - L)) for p, L in zip(prompts, lens)])
        glens = None if min(lens) == Lmax else \
            torch.tensor(lens, dtype=torch.int32, device=dev)
        logits, part = self.model.prefill(self.params, {"tokens": toks},
                                          cache_len=self._group_cache_len(Lmax), lengths=glens)
        first = sample(logits, gen, cfg.sampling)
        rem0 = gen_tokens - 1
        if cfg.paged:
            # an over-long prompt keeps only its first capacity rows, as the
            # contiguous cache does: debit exactly the blocks the scatter fills
            counts = torch.tensor([min(P.blocks_for(L, cfg.block_size), self._mb)
                                   for L in lens], dtype=torch.int32, device=dev)
            cache, state = self._scatter_paged(
                cache, state, part, torch.tensor(free_slots, device=dev),
                torch.tensor(lens, dtype=torch.int32, device=dev), first, rem0, counts)
        elif free_slots == list(range(B)):
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
        if cfg.paged:
            for r in requests:
                need = self._blocks_needed(int(r.shape[0]), gen_tokens)
                if need > self._num_blocks:
                    raise ValueError(f"request of {int(r.shape[0])} tokens needs {need} "
                                     f"blocks but the pool has {self._num_blocks}")
            cache = model.init_paged_cache(B, cfg.cache_len, block_size=cfg.block_size,
                                           num_blocks=self._num_blocks)
        else:
            cache = model.init_cache(B, cfg.cache_len)
        stats["cache_bytes"] = _tensor_bytes(cache)
        state = init_slot_state(B, dev)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed if seed is None else seed)
        queue = deque(range(len(requests)))
        slot_rid = [-1] * B     # request id per slot (host mirror)
        slot_rem = [0] * B      # remaining budget     (host mirror)
        # paged: each slot reserves its request's lifetime worst case in
        # blocks at admission and drops it when the request finishes; the
        # device free list only runs ahead of this view (it reclaims blocks
        # mid-dispatch), so admission against it never underflows the pool
        slot_rsv = [0] * B
        ctr_host = None

        while queue or any(r >= 0 for r in slot_rid):
            free = [s for s in range(B) if slot_rid[s] < 0]
            take_slots, rids = [], []
            if queue and free and cfg.paged:
                rsv_total = sum(slot_rsv)
                for s in free:
                    if not queue:
                        break
                    need = self._blocks_needed(int(requests[queue[0]].shape[0]), gen_tokens)
                    if rsv_total + need > self._num_blocks:
                        break       # FIFO: the head request must fit first
                    rsv_total += need
                    slot_rsv[s] = need
                    take_slots.append(s)
                    rids.append(queue.popleft())
                assert take_slots or any(r >= 0 for r in slot_rid), \
                    "admission stalled with an idle pool"
            elif queue and free:
                take_slots = free[:min(len(free), len(queue))]
                rids = [queue.popleft() for _ in take_slots]
            if rids:
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
                        slot_rsv[s] = 0
                if cfg.paged and cfg.check_invariants:
                    self._assert_invariants(cache, state)
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
            if cfg.paged and cfg.check_invariants:
                self._assert_invariants(cache, state)
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
                    slot_rsv[s] = 0     # the device freed its blocks mid-dispatch

        if ctr_host is not None:
            stats["counters"] = counter_totals(ctr_host)
        outs = [outputs[i] for i in sorted(outputs)]
        return (outs, stats) if return_stats else outs
