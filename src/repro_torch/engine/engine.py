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
* **chunked prefill** — ``chunk_size > 0`` (paged only) moves prefill into
  the decode dispatch: admission only maps blocks and arms the slot's
  prompt buffer, and each dispatch step runs one ``chunk_size``-token
  piece beside the other slots' decode step (scheduler.py), so a long
  prompt streams instead of stalling decode.
* **prefix caching** — ``prefix_cache=True`` (implies chunked prefill, at
  ``chunk_size = 4 * block_size`` unless given) shares full prompt blocks
  across requests: a host index of chained block hashes (engine/prefix.py)
  maps matched leading blocks into the new slot's table with
  ``ref += 1``, and only the unmatched tail is prefilled.  Released blocks
  stay cached (the index holds one reference) until LRU eviction makes
  room, in place of a FIFO wait that could deadlock; the cache persists
  across ``serve`` calls.  A partly matched last block is mapped shared,
  and the first decode write copies it (copy-on-write).
* **self-speculative decoding** — ``n_spec > 0`` (paged only; pass the
  quantized ``draft_params`` tree) makes each dispatch step a speculative
  round (engine/spec.py): the draft proposes up to ``n_spec`` tokens, one
  verify forward of ``params`` scores them, a prefix is accepted and the
  rest rolls back.  It composes with chunked prefill and prefix caching.
  The depth is dynamic by default (``spec_dynamic``): a host AIMD
  controller moves it 1..n_spec from each dispatch's acceptance counters,
  read in the transfer that drains the grid, and hands it to the next
  dispatch as a device scalar.  Greedy output equals the non-speculative
  engine's for any draft (on the CPU; ``PERF.md`` decision a), and the
  acceptance rate (stats ``draft_accepted / draft_tokens``) measures how
  closely the quantized tree follows the full-precision one.

Every prefill the engine runs (one-shot or a chunk) uses one flash tile
shape, ``(4 * block_size, blocks_for(cache_len) * block_size)``
(``Engine._tiles``), so on the CPU a chunked prefill gives the one-shot
prefill's bits and greedy tokens.

**Telemetry** (``repro_torch.telemetry``): ``metrics=`` (a
``MetricsRegistry``) records each request's lifecycle and the serve's
counters and gauges, ``tracer=`` (a ``Tracer``) the admission, dispatch,
``spec``, ``prefill-chunk`` and eviction tracks and the ``tokens`` /
``blocks`` counter tracks — the reference's names, units and arguments.
Both read only what the serve loop already holds on the host: the counter
tracks come from the one transfer of each dispatch, and every time
(``stats["prefill_s"]`` / ``decode_s``, lifecycle times, span ends) is a
``time.perf_counter()`` read.  A span's end is read after the transfer
that already ends its work (a dispatch's grid, a one-shot admission's
first tokens), so on the card it covers the device time, not just the
launches; a chunked admission has no such transfer unless the prefix
index needs its new block ids, and its span is the host's issue time
(its prefill runs in the following dispatches, whose spans hold it).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.engine import paged as P
from repro_torch.engine.prefix import PrefixIndex
from repro_torch.engine.sampler import SamplingParams, sample
from repro_torch.engine.scheduler import init_slot_state, make_decode_dispatch
from repro_torch.engine.spec import DepthController
from repro_torch.telemetry.counters import (COUNTER_KEYS, bump, counter_totals,
                                            init_counters)


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
    chunk_size: int = 0     # >0: chunked prefill inside the decode dispatch
                            # (paged only; tokens per prefill piece)
    prefix_cache: bool = False  # refcounted prompt-block sharing (paged;
                                # implies chunked prefill)
    check_invariants: bool = False  # assert allocator conservation after
                                    # every admission and dispatch (slow)
    n_spec: int = 0         # >0: self-speculative decoding, up to n_spec draft
                            # tokens a round from draft_params, one verify
                            # forward of params (paged only; composes with
                            # chunk_size and prefix_cache)
    spec_dynamic: bool = True   # move the depth 1..n_spec from the acceptance
                                # rate (spec.DepthController); False pins it
                                # at n_spec


def _tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


class Engine:
    """Continuous-batching serving engine over a built :class:`Model`."""

    def __init__(self, model, params, cfg: EngineConfig | None = None, *, draft_params=None,
                 metrics=None, tracer=None, **kw):
        if cfg is None:
            cfg = EngineConfig(**kw)
        elif kw:
            raise TypeError("pass either cfg= or keyword fields, not both")
        if cfg.k_steps < 1:
            raise ValueError(f"k_steps must be >= 1, got {cfg.k_steps}")
        if (cfg.chunk_size or cfg.prefix_cache) and not cfg.paged:
            raise ValueError("chunk_size / prefix_cache need paged=True")
        if cfg.n_spec:
            if not cfg.paged:
                raise ValueError("speculative decoding (n_spec > 0) rides the paged engine: "
                                 "pass paged=True")
            if cfg.n_spec >= cfg.k_steps:
                raise ValueError(f"n_spec must be < k_steps (got n_spec={cfg.n_spec}, "
                                 f"k_steps={cfg.k_steps}): the dispatch runs k_steps "
                                 f"speculative rounds and sizes its token grid "
                                 f"k_steps*(n_spec+1) — raise k_steps or lower n_spec")
            if draft_params is None:
                raise ValueError("speculative decoding needs draft_params: a quantized copy "
                                 "of the serving weights, e.g. repro_torch.quantize.quantize("
                                 "params, base, qcfg, mode='storage')[0]")
        elif draft_params is not None:
            raise ValueError("draft_params without n_spec > 0 does nothing: set n_spec to "
                             "enable speculative decoding")
        if cfg.prefix_cache and not cfg.chunk_size:
            cfg = dataclasses.replace(cfg, chunk_size=4 * cfg.block_size)
        self.model = model
        self.params = params
        self.draft_params = draft_params
        # host-side telemetry, fed only from values the serve loop already
        # holds on the host: enabling it adds no host sync
        self.metrics = metrics      # MetricsRegistry | None
        self.tracer = tracer        # Tracer | None
        self.cfg = cfg
        self._mb = P.blocks_for(cfg.cache_len, cfg.block_size)       # blocks per slot
        # one flash tile shape for every prefill: a chunk's rows then give
        # the one-shot prefill's bits (PERF.md, decision a)
        self._tiles = (4 * cfg.block_size, self._mb * cfg.block_size)
        self._ctr_live0 = 0     # blocks out of the pool when the counters were zeroed
        self._hold_blocks: set[int] = set()     # prefix-index and pending holds
        if cfg.paged:
            self._num_blocks = cfg.num_blocks or cfg.slots * self._mb
        self._dispatch = make_decode_dispatch(model, cfg.sampling, cfg.k_steps,
                                              paged=cfg.paged, cow=cfg.prefix_cache)
        if cfg.n_spec:
            self._dispatch_spec = make_decode_dispatch(
                model, cfg.sampling, cfg.k_steps, paged=True, cow=cfg.prefix_cache,
                n_spec=cfg.n_spec)
        if cfg.chunk_size:
            self._dispatch_chunk = make_decode_dispatch(
                model, cfg.sampling, cfg.k_steps, paged=True, cow=cfg.prefix_cache,
                chunk=cfg.chunk_size, tiles=self._tiles)
            if cfg.n_spec:
                self._dispatch_spec_chunk = make_decode_dispatch(
                    model, cfg.sampling, cfg.k_steps, paged=True, cow=cfg.prefix_cache,
                    chunk=cfg.chunk_size, tiles=self._tiles, n_spec=cfg.n_spec)
            self._index = PrefixIndex(cfg.block_size)
            self._pcache = self._pstate = None  # the cache kept across serve calls

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
        slot's capacity (the cache drops overflow writes).  A speculative
        round writes up to ``n_spec`` rows past the budget before it rolls
        back (the last round's span), so the reservation covers them too."""
        return min(P.blocks_for(prompt_len + gen_tokens - 1 + self.cfg.n_spec,
                                self.cfg.block_size), self._mb)

    def _spec_controller(self) -> DepthController:
        """A fresh depth policy for one serve.  With ``spec_dynamic=False``
        the thresholds lie outside [0, 1], so no acceptance rate moves the
        depth off ``n_spec``: one code path either way."""
        if self.cfg.spec_dynamic:
            return DepthController(self.cfg.n_spec)
        return DepthController(self.cfg.n_spec, lo=-1.0, hi=2.0)

    # -- telemetry (repro_torch.telemetry) -------------------------------------

    def _request_done(self, prompt_len, gen_len, t_enq, t_admit, t_first,
                      prefix_hit_frac=None):
        """Record one finished request's lifecycle histograms (no-op without
        a registry; every input is a host float already in hand)."""
        m = self.metrics
        if m is None:
            return
        now = time.perf_counter()
        m.counter("requests.completed").inc()
        m.histogram("request.ttft_s", unit="s").observe(t_first - t_enq)
        m.histogram("request.queue_wait_s", unit="s").observe(t_admit - t_enq)
        m.histogram("request.tpot_s", unit="s").observe((now - t_first) / max(gen_len - 1, 1))
        m.histogram("request.prompt_len", lo=1.0, hi=1e6, unit="tokens").observe(prompt_len)
        m.histogram("request.gen_len", lo=1.0, hi=1e6, unit="tokens").observe(gen_len)
        if prefix_hit_frac is not None:
            m.histogram("request.prefix_hit_frac", lo=1e-3, hi=1.0).observe(prefix_hit_frac)

    def _trace_dispatch(self, t0_us, ctr, depth=None, drafted=0, accepted=0):
        """One dispatch's trace events: a span on the ``dispatch`` (or
        ``spec``) track, ended after the dispatch's transfer, and samples of
        the ``tokens`` and ``blocks`` counter tracks from the counters that
        transfer brought home (``ctr``)."""
        tr = self.tracer
        if tr is None:
            return
        if depth is None:
            tr.complete("dispatch", "decode", t0_us, {"k_steps": self.cfg.k_steps})
        else:
            tr.complete("spec", "rounds", t0_us,
                        {"k_steps": self.cfg.k_steps, "depth": depth, "drafted": drafted,
                         "accepted": accepted})
        totals = counter_totals(ctr)
        tr.counter("tokens", {"emitted": totals["tokens"]})
        if self.cfg.paged:
            live = self._ctr_live0 + totals["blocks_popped"] - totals["blocks_released"]
            tr.counter("blocks", {"live": live, "cow": totals["cow_copies"]})

    def _finalize_serve(self, stats, totals):
        """End-of-serve telemetry: expose the counters (``totals``) as
        ``stats["counters"]`` and fold them and the allocator and speculation
        gauges into the registry."""
        stats["counters"] = totals
        m = self.metrics
        if m is None:
            return
        for k, v in totals.items():
            m.counter(f"device.{k}").inc(v)
        if self.cfg.n_spec:
            m.gauge("spec.depth").set(stats["spec_depth"])
            acc = m.gauge("spec.acceptance_rate")   # None -> "n/a"
            if totals["drafted"]:
                acc.set(totals["accepted"] / totals["drafted"])
        if self.cfg.paged:
            live = self._ctr_live0 + totals["blocks_popped"] - totals["blocks_released"]
            m.gauge("alloc.live_blocks").set(live)
            m.gauge("alloc.free_blocks").set(self._num_blocks - live)
        if self.cfg.chunk_size:
            holds = len(self._hold_blocks)
            m.gauge("alloc.index_holds").set(holds)
            m.gauge("alloc.ledger_headroom").set(self._num_blocks - holds)
            m.counter("prefix.evictions").inc(stats.get("prefix_evictions", 0))

    def _run_dispatch(self, dispatch, state, cache, gen, spec_ctl, stats):
        """One K-step dispatch and its one device-to-host transfer (token
        grid, emission mask, counters).  Returns (state, cache, tokens [B,
        W], emitted [B, W], counters) on the host, ``W = K * (n_spec + 1)``;
        with speculation it runs ``dispatch`` with the draft tree at the
        controller's depth and folds the dispatch's drafted / accepted
        deltas into ``stats`` and the controller.  The dispatch's trace span
        ends after the transfer."""
        cfg, tr = self.cfg, self.tracer
        B = cfg.slots
        W = cfg.k_steps * (cfg.n_spec + 1)
        ctr0 = state["ctr"]
        t0 = time.perf_counter()
        t0_us = tr.now_us() if tr else 0.0
        if spec_ctl is None:
            state, cache, toks, emitted = dispatch(self.params, state, cache, gen)
        else:
            depth = torch.full((), spec_ctl.depth, dtype=torch.int32, device=self.model.device)
            state, cache, toks, emitted = dispatch(self.params, self.draft_params, state,
                                                   cache, depth, gen)
        packed = torch.cat([toks.reshape(-1), emitted.reshape(-1).to(torch.int32),
                            torch.stack([state["ctr"][k] for k in COUNTER_KEYS]),
                            torch.stack([ctr0[k] for k in ("drafted", "accepted")])])
        host = packed.cpu().numpy()
        stats["decode_s"] += time.perf_counter() - t0
        stats["host_syncs"] += 1
        stats["dispatches"] += 1
        stats["decode_steps"] += cfg.k_steps
        ctr = dict(zip(COUNTER_KEYS, host[2 * B * W:-2]))
        spec = {}
        if spec_ctl is not None:
            d_dr = int(ctr["drafted"]) - int(host[-2])
            d_ac = int(ctr["accepted"]) - int(host[-1])
            stats["draft_tokens"] += d_dr
            stats["draft_accepted"] += d_ac
            stats["spec_rounds"] += cfg.k_steps
            spec = dict(depth=spec_ctl.depth, drafted=d_dr, accepted=d_ac)
            stats["spec_depth"] = spec_ctl.update(d_dr, d_ac)
        self._trace_dispatch(t0_us, ctr, **spec)
        return (state, cache, host[:B * W].reshape(B, W),
                host[B * W:2 * B * W].reshape(B, W).astype(bool), ctr)

    def _assert_invariants(self, cache, state) -> None:
        """Conservation of the block pool, checked on the device's state
        (one host fetch; for tests and checks): the free stack and the
        referenced blocks partition the pool, every block's refcount equals
        its table references plus the prefix index's hold, and the counters
        account for every block out of the free stack
        (live0 + popped - released == live)."""
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
        holds = torch.zeros(NB, dtype=counts.dtype)
        holds[torch.tensor(sorted(self._hold_blocks), dtype=torch.long)] = 1
        bad = (ref != counts + holds).nonzero().flatten().tolist()
        assert not bad, "refcounts differ from table references + index holds: " + ", ".join(
            f"block {b} ref {int(ref[b])} tables {int(counts[b])} hold {int(holds[b])}"
            for b in bad)
        ctr = counter_totals({k: v.cpu() for k, v in state["ctr"].items()})
        popped, released = ctr["blocks_popped"], ctr["blocks_released"]
        assert self._ctr_live0 + popped - released == NB - n_free, (
            f"counter leak: base {self._ctr_live0} + popped {popped} - released "
            f"{released} != live {NB - n_free}")
        assert ctr["drafted"] == ctr["accepted"] + ctr["rejected"], (
            f"spec counter leak: drafted {ctr['drafted']} != accepted {ctr['accepted']} + "
            f"rejected {ctr['rejected']}")

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
                                          cache_len=self._group_cache_len(Lmax), lengths=glens,
                                          tiles=self._tiles)
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

    # -- chunked / prefix-cached admission ------------------------------------

    def _admit_chunk(self, cache, state, slot: int, ints: torch.Tensor, n_shared: int,
                     n_new: int, n_retained: int, pf_start: int, shared_until: int,
                     L: int, budget: int):
        """Admit one request into ``slot`` for in-dispatch chunked prefill, in
        place: no model forward here.  Release the slot's stale blocks, map
        the shared (prefix-hit) blocks and pop fresh ones (``admit_slot``),
        and arm the prompt buffer.  ``ints`` is one host-to-device transfer:
        the ``-1``-padded shared block ids [blocks per slot], then the
        prompt padded to ``cache_len``.  The first token is sampled inside
        the dispatch when the last chunk lands.  Returns (cache, state,
        popped ids [blocks per slot], ``-1`` padded)."""
        B = state["active"].shape[0]
        bstate = {k: cache[k] for k in P.BSTATE_KEYS}
        nf0 = bstate["n_free"]
        done = torch.zeros(B, dtype=torch.bool, device=nf0.device)
        done[slot] = True
        bstate = P.release_slots(bstate, done)
        nf1 = bstate["n_free"]
        bstate, new_ids = P.admit_slot(bstate, slot, ints[:self._mb], n_shared, n_new,
                                       n_retained, self._mb)
        cache.update(bstate)
        cache["lengths"][slot] = pf_start
        state["active"][slot] = False
        state["remaining"][slot] = 0
        state["prompt"][slot] = ints[self._mb:]
        state["pf_pos"][slot] = pf_start
        state["pf_len"][slot] = L
        state["budget"][slot] = budget
        state["pf_shared"][slot] = shared_until
        # pf_start (not shared_until): the tokens actually skipped, the same
        # quantity the host's stats["prefix_hits"] adds up
        state["ctr"] = bump(state["ctr"], prefix_hit_tokens=pf_start,
                            blocks_released=nf1 - nf0, blocks_popped=nf1 - bstate["n_free"])
        return cache, state, new_ids

    def _evict(self, cache, state, ids: list[int]):
        """Drop the host holds on ``ids`` (eviction, duplicate unwind) and
        count the blocks that reach the free stack, in place."""
        ids_d = torch.tensor(ids, dtype=torch.int32).to(cache["n_free"].device)
        nf0 = cache["n_free"]
        cache.update(P.release_refs({k: cache[k] for k in P.BSTATE_KEYS}, ids_d))
        state["ctr"] = bump(state["ctr"], blocks_released=cache["n_free"] - nf0)
        self._hold_blocks.difference_update(ids)
        return cache, state

    def _serve_chunked(self, requests, gen_tokens: int, seed, stats: dict, spec_ctl) -> list:
        """The serve loop of a chunked (and prefix-cached) engine: admission
        reserves each request's private worst case plus the index's holds
        against the pool (with one spare block for a partial hit's
        copy-on-write), evicting LRU cached blocks where the pool is short
        rather than waiting; every dispatch while a slot prefills runs the
        chunked dispatch; a prompt's new full blocks are registered in the
        index once it has prefilled (a duplicate of an entry loses its hold
        again).  The counters are read after the loop, so the releases that
        follow the last dispatch count too.  With speculation every dispatch
        is the speculative one, chunked while a slot prefills."""
        cfg, model = self.cfg, self.model
        B, K, C, bs = cfg.slots, cfg.k_steps, cfg.chunk_size, cfg.block_size
        NB, MB = self._num_blocks, self._mb
        pcap, cap_rows = cfg.cache_len, MB * cfg.block_size
        dev = model.device
        for r in requests:
            L = int(r.shape[0])
            if L > pcap:
                raise ValueError(f"chunked prefill streams prompts through the paged cache: "
                                 f"prompt of {L} tokens exceeds cache_len {pcap}")
            need = self._blocks_needed(L, gen_tokens)
            if need > NB:
                raise ValueError(f"request of {L} tokens needs {need} blocks but the pool "
                                 f"has {NB}")
        toks_np = [r.cpu().numpy() for r in requests]
        if cfg.prefix_cache and self._pcache is not None:
            cache, state = self._pcache, self._pstate
            self._pcache = self._pstate = None
        else:
            cache = model.init_paged_cache(B, cfg.cache_len, block_size=bs, num_blocks=NB)
            state = init_slot_state(B, dev, prompt_cap=pcap)
        stats.update(cache_bytes=_tensor_bytes(cache), prefix_hits=0, prefix_evictions=0,
                     chunk_dispatches=0)
        # zero the counters for this serve; blocks the index still holds
        # from an earlier serve are the conservation's base
        state["ctr"] = init_counters(dev)
        self._ctr_live0 = len(self._hold_blocks)
        tr = self.tracer
        t_enq = time.perf_counter()
        req_admit: dict[int, float] = {}
        req_first: dict[int, float] = {}
        req_pf: dict[int, float] = {}       # prefix-hit fraction per request
        slot_t0us = [0.0] * B               # admission trace clock per slot
        gen = torch.Generator(device=dev).manual_seed(cfg.seed if seed is None else seed)
        index = self._index
        queue = deque(range(len(requests)))
        outputs: dict[int, list[int]] = {}
        slot_rid = [-1] * B
        slot_rem = [0] * B
        slot_rsv = [0] * B                  # slot-private worst-case blocks
        slot_pf = [0] * B                   # prompt tokens left to prefill (mirror)
        slot_keys = [[] for _ in range(B)]  # pinned index keys per slot
        slot_pend = [None] * B              # (tokens, first block, ids) to register

        def drop_holds(ids):
            nonlocal cache, state
            cache, state = self._evict(cache, state, ids)

        def try_evict(want: int) -> int:
            ids = index.evict(want) if cfg.prefix_cache else []
            if ids:
                drop_holds(ids)
                stats["prefix_evictions"] += len(ids)
                if tr:
                    tr.instant("eviction", "evict", {"blocks": len(ids)})
            return len(ids)

        while queue or any(r >= 0 for r in slot_rid):
            free = [s for s in range(B) if slot_rid[s] < 0]
            t0 = time.perf_counter()
            while queue and free:
                rid = queue[0]
                toks = toks_np[rid]
                L = len(toks)
                full, part_len = L // bs, L % bs
                # A request's own pinned hits can crowd a tight pool (a warm
                # partial hit needing its CoW spare with every block cached
                # and pinned by itself).  With running slots admission waits
                # for them; with an idle pool each retry unpins, evicts (its
                # own matches included) and matches again, decaying toward a
                # cold prefill, which the pool-size check guarantees fits.
                fits = False
                for _ in range(len(index) + 2):
                    matched, partial_id, keys = [], None, []
                    if cfg.prefix_cache:
                        matched, partial_id, keys = index.match(toks)
                        index.pin(keys)
                    partial = partial_id is not None
                    matched_tokens = L if partial else len(matched) * bs
                    pf_start = min(matched_tokens, L - 1)
                    new_full = full - len(matched)
                    n_new = new_full + (1 if part_len and not partial else 0)
                    shared = matched + ([partial_id] if partial else [])
                    n_ret = new_full if cfg.prefix_cache else 0
                    # a speculative round overshoots the budget by up to
                    # n_spec rows before it rolls back, as _blocks_needed
                    lifetime = min(P.blocks_for(min(L + gen_tokens - 1 + cfg.n_spec, cap_rows),
                                                bs), MB)
                    cow_spare = 1 if partial and gen_tokens > 1 else 0
                    slot_need = (n_new - n_ret) + lifetime - P.blocks_for(L, bs) + cow_spare
                    demand = sum(slot_rsv) + len(self._hold_blocks) + slot_need + n_ret - NB
                    if demand <= 0 or try_evict(demand) >= demand:
                        fits = True
                        break
                    index.unpin(keys)
                    if any(r >= 0 for r in slot_rid):
                        break       # running slots will drain and unpin
                    if try_evict(demand) == 0:
                        break       # nothing cached left to reclaim
                if not fits:
                    break
                s = free.pop(0)
                queue.popleft()
                t0_us = tr.now_us() if tr else 0.0
                ints = np.full(MB + pcap, -1, np.int32)
                ints[:len(shared)] = shared
                ints[MB:] = 0
                ints[MB:MB + L] = toks
                cache, state, new_ids = self._admit_chunk(
                    cache, state, s, torch.from_numpy(ints).to(dev), len(shared), n_new, n_ret,
                    pf_start, matched_tokens, L, gen_tokens - 1)
                slot_rid[s], slot_rem[s], slot_rsv[s] = rid, gen_tokens, slot_need
                slot_pf[s] = L - pf_start
                slot_keys[s] = keys
                outputs[rid] = []
                stats["prefill_tokens"] += L - pf_start
                stats["prefix_hits"] += pf_start     # tokens not recomputed
                stats["prefill_calls"] += 1
                if n_ret:
                    ids = new_ids[:n_ret].tolist()
                    stats["host_syncs"] += 1
                    self._hold_blocks.update(ids)
                    slot_pend[s] = (toks, len(matched), ids)
                req_admit[rid] = time.perf_counter()
                req_pf[rid] = pf_start / L
                if tr:
                    tr.complete("admission", f"req{rid}", t0_us,
                                {"prompt_len": L, "prefix_hit": pf_start,
                                 "shared_blocks": len(shared)})
                    slot_t0us[s] = tr.now_us()
                if cfg.check_invariants:
                    self._assert_invariants(cache, state)
            stats["prefill_s"] += time.perf_counter() - t0
            if not any(r >= 0 for r in slot_rid):
                assert not queue, "admission stalled with an idle pool"
                continue

            chunked = any(p > 0 for p in slot_pf)
            if cfg.n_spec:
                dispatch = self._dispatch_spec_chunk if chunked else self._dispatch_spec
            else:
                dispatch = self._dispatch_chunk if chunked else self._dispatch
            state, cache, toks_h, em_h, _ = self._run_dispatch(dispatch, state, cache, gen,
                                                               spec_ctl, stats)
            stats["chunk_dispatches"] += chunked
            for s in range(B):
                if slot_rid[s] < 0 or slot_pf[s] <= 0:
                    continue
                slot_pf[s] = max(0, slot_pf[s] - K * C)
                if slot_pf[s] > 0:
                    continue
                if tr:
                    tr.complete("prefill-chunk", f"req{slot_rid[s]}", slot_t0us[s])
                if slot_pend[s] is None:
                    continue
                # the slot's new full prompt blocks now hold their rows:
                # publish them (a duplicate loses its hold and dies with
                # the slot)
                toks, first_block, ids = slot_pend[s]
                slot_pend[s] = None
                dups = index.register(toks, ids, first_block)
                if dups:
                    drop_holds(dups)
                    slot_rsv[s] += len(dups)
                keys = index.keys_for(toks, first_block + len(ids))[first_block:]
                dup_set = set(dups)
                reg_keys = [k for k, b in zip(keys, ids) if b not in dup_set]
                index.pin(reg_keys)
                slot_keys[s] = slot_keys[s] + reg_keys
            if cfg.check_invariants:
                self._assert_invariants(cache, state)
            for s in range(B):
                r = slot_rid[s]
                if r < 0:
                    continue
                row = [int(t) for t in toks_h[s][em_h[s]]]
                if row and r not in req_first:
                    req_first[r] = time.perf_counter()
                outputs[r].extend(row)
                stats["tokens"] += len(row)
                slot_rem[s] -= len(row)
                if slot_rem[s] <= 0:
                    assert slot_pend[s] is None, \
                        "slot finished before its prompt finished prefilling"
                    slot_rid[s], slot_rsv[s] = -1, 0
                    index.unpin(slot_keys[s])
                    slot_keys[s] = []
                    self._request_done(len(toks_np[r]), gen_tokens, t_enq, req_admit[r],
                                       req_first.get(r, req_admit[r]),
                                       prefix_hit_frac=req_pf.get(r))

        # read after the loop, so the releases after the last dispatch count
        # too (the reference reads them at that dispatch: ROADMAP Queue C 9)
        self._finalize_serve(stats, counter_totals(
            dict(zip(COUNTER_KEYS, torch.stack([state["ctr"][k] for k in COUNTER_KEYS])
                     .cpu().tolist()))))
        stats["host_syncs"] += 1
        if cfg.prefix_cache:
            self._pcache, self._pstate = cache, state
        return [outputs[i] for i in sorted(outputs)]

    # -- serve ----------------------------------------------------------------

    def serve(self, requests, *, gen_tokens: int, seed: int | None = None,
              return_stats: bool = False):
        """Serve ``requests`` (1-D token sequences); each gets ``gen_tokens``
        generated tokens.  Returns outputs in request order (and a stats dict
        when ``return_stats``; with speculation it also holds
        ``spec_rounds``, ``draft_tokens``, ``draft_accepted`` and the last
        ``spec_depth``)."""
        cfg, model = self.cfg, self.model
        B = cfg.slots
        dev = model.device
        requests = [torch.as_tensor(r, dtype=torch.int32).reshape(-1).to(dev)
                    for r in requests]
        stats = {"host_syncs": 0, "dispatches": 0, "prefill_calls": 0,
                 "decode_steps": 0, "tokens": 0, "prefill_tokens": 0,
                 "prefill_s": 0.0, "decode_s": 0.0,
                 "counters": dict.fromkeys(COUNTER_KEYS, 0)}
        spec_ctl = self._spec_controller() if cfg.n_spec else None
        if cfg.n_spec:
            stats.update(spec_rounds=0, draft_tokens=0, draft_accepted=0,
                         spec_depth=spec_ctl.depth)
        if gen_tokens < 1 or not requests:
            return ([], stats) if return_stats else []
        if cfg.chunk_size:
            outs = self._serve_chunked(requests, gen_tokens, seed, stats, spec_ctl)
            return (outs, stats) if return_stats else outs
        self._ctr_live0 = 0
        outputs: dict[int, list[int]] = {}
        tr = self.tracer
        t_enq = time.perf_counter()     # every request enqueues at serve()
        req_admit: dict[int, float] = {}
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
                t0_us = tr.now_us() if tr else 0.0
                cache, state, first = self._admit(
                    cache, state, take_slots, [requests[r] for r in rids],
                    gen_tokens, gen)
                ta = time.perf_counter()    # after the first tokens' transfer
                stats["prefill_s"] += ta - t0
                if tr:
                    tr.complete("admission", f"admit x{len(rids)}", t0_us,
                                {"requests": len(rids), "prefill_calls": 1})
                stats["prefill_calls"] += 1
                stats["host_syncs"] += 1
                stats["tokens"] += len(rids)
                stats["prefill_tokens"] += sum(int(requests[r].shape[0]) for r in rids)
                for s, r, t in zip(take_slots, rids, first):
                    outputs[r] = [t]
                    slot_rid[s], slot_rem[s] = r, gen_tokens - 1
                    # the first token comes from the prefill's logits, so the
                    # admission time is the first-token time
                    req_admit[r] = ta
                    if slot_rem[s] <= 0:      # gen_tokens == 1 finishes now
                        self._request_done(int(requests[r].shape[0]), gen_tokens, t_enq,
                                           ta, ta)
                        slot_rid[s] = -1
                        slot_rsv[s] = 0
                if cfg.paged and cfg.check_invariants:
                    self._assert_invariants(cache, state)
            if not any(r >= 0 for r in slot_rid):
                continue

            dispatch = self._dispatch_spec if cfg.n_spec else self._dispatch
            state, cache, toks_h, em_h, ctr_host = self._run_dispatch(dispatch, state, cache,
                                                                      gen, spec_ctl, stats)
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
                    self._request_done(int(requests[r].shape[0]), gen_tokens, t_enq,
                                       req_admit[r], req_admit[r])

        # no dispatch ran (gen_tokens == 1): every token came from a prefill
        # and the counters read zero, without a transfer of their own
        self._finalize_serve(stats, counter_totals(ctr_host) if ctr_host is not None
                             else dict.fromkeys(COUNTER_KEYS, 0))
        outs = [outputs[i] for i in sorted(outputs)]
        return (outs, stats) if return_stats else outs
