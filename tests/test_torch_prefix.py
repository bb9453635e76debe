"""repro_torch's prefix cache and chunked prefill against repro's, and the
reference's own exactness contracts held inside the port, on the CPU.

* The allocator (``engine/paged.py``): a random trace of ``admit_slot``
  (prefix-hit sharing, retained holds), ``alloc_step`` with ``cow`` on and
  off (copy-on-write pops), ``span_targets`` (the prefix-hit watermark),
  ``release_slots`` and ``release_refs`` is replayed through
  ``repro.engine.paged`` and the port; every state tensor and every
  returned id or target is equal at every step (exact).  The unit pins of
  ``tests/test_engine_prefix.py`` (shared and retained refs, a CoW pop,
  the watermark) run on both and agree.
* ``PrefixIndex`` (``engine/prefix.py``): the same operations give the
  reference's matches, keys, duplicates and eviction order (exact).
* ``Model.prefill_chunk_paged`` on the reduced GLM-4-9B: logits and the
  pool rows within 2e-2 of their largest magnitude (the bf16 tolerance of
  ``tests/test_torch_model.py``), lengths exact, and the rows under the
  prefix-hit watermark left unwritten.
* ``Engine(paged=True, chunk_size=C, prefix_cache=True)``: greedy tokens
  and the counters equal to ``repro``'s engine where every token's top-2
  margin exceeds that tolerance.
* Inside the port, exact token for token with ``check_invariants=True``
  (conservation after every admission and dispatch): chunked == one-shot
  paged; warm == cold; a partial-tail hit copies on write; ``gen_tokens=1``
  releases its blocks and still caches; eviction in place of a deadlock on
  a tight pool; and the workload of the reference's
  ``test_prefix_stress_randomized`` at the seeds that leak a block in the
  reference (ROADMAP Queue C 9) and two more, where the counters account
  for every block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.data import LanguageSpec, sample_batch
from repro.engine import Engine as RefEngine
from repro.engine import paged as RP
from repro.engine.prefix import PrefixIndex as RefIndex
from repro.models import build_model as ref_build_model
from repro_torch.compat import params_from_jax
from repro_torch.configs import get_arch, reduced
from repro_torch.engine import Engine, PrefixIndex, chain_hashes
from repro_torch.engine import paged as TP
from repro_torch.models import build_model

TOL = 2e-2
NEG = TP.NEG


def _prompt(seed, length, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, length).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    """(reference model, reference params, port model, port params) on the
    reduced GLM-4-9B, bf16 weights drawn with numpy."""
    cfg = ref_reduced(ref_get_arch("glm4-9b"))
    ref_model = ref_build_model(cfg)
    shapes = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(path, s):
        if len(s.shape) >= 2:
            return rng.standard_normal(s.shape) * s.shape[-2] ** -0.5
        return 1.0 + 0.1 * rng.standard_normal(s.shape)

    ref_params = jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(draw(p, s).astype(np.float32)).astype(jnp.bfloat16), shapes)
    model = build_model(reduced(get_arch("glm4-9b")), device="cpu")
    return ref_model, ref_params, model, params_from_jax(jax.device_get(ref_params))


# ---------------------------------------------------------------------------
# The allocator
# ---------------------------------------------------------------------------

def _state_equal(ref: dict, port: dict, where: str):
    for k in TP.BSTATE_KEYS:
        r, p = np.asarray(ref[k]), port[k].numpy()
        assert p.dtype == r.dtype, (where, k, p.dtype, r.dtype)
        np.testing.assert_array_equal(p, r, err_msg=f"{where}: {k}")


def _conserved(bs, NB):
    n_free = int(bs["n_free"])
    free = [int(b) for b in np.asarray(bs["free"])[:n_free]]
    ref = np.asarray(bs["ref"])
    held = {b for b in range(NB) if ref[b] > 0}
    assert len(set(free)) == n_free and not (set(free) & held)
    assert n_free + len(held) == NB
    return ref


class _Both:
    """One allocator state held by the reference and the port, compared
    after every operation."""

    def __init__(self, B, MB, NB):
        self.MB = MB
        self.ref = RP.init_block_state(B, MB, NB)
        self.port = TP.init_block_state(B, MB, NB, "cpu")

    def check(self, where):
        _state_equal(self.ref, self.port, where)

    def admit(self, slot, shared, n_new, n_ret):
        row = np.full(self.MB, NEG, np.int32)
        row[:len(shared)] = shared
        self.ref, rids = RP.admit_slot(self.ref, jnp.int32(slot), jnp.asarray(row),
                                       jnp.int32(len(shared)), jnp.int32(n_new),
                                       jnp.int32(n_ret), self.MB)
        self.port, pids = TP.admit_slot(self.port, slot, torch.from_numpy(row), len(shared),
                                        n_new, n_ret, self.MB)
        np.testing.assert_array_equal(pids.numpy(), np.asarray(rids))
        return [int(i) for i in np.asarray(rids)[:n_new]]

    def step(self, lengths, active, bs, cow):
        lengths = np.asarray(lengths, np.int32)
        active = np.asarray(active, bool)
        self.ref = {**self.ref, "slot_active": jnp.asarray(active)}
        self.port = {**self.port, "slot_active": torch.from_numpy(active)}
        cap = self.MB * bs
        self.ref, *rout = RP.alloc_step(self.ref, jnp.asarray(lengths), bs, cap, False, cow=cow)
        self.port, *pout = TP.alloc_step(self.port, torch.from_numpy(lengths), bs, cap, False,
                                         cow=cow)
        for r, p in zip(rout, pout):
            np.testing.assert_array_equal(p.numpy(), np.asarray(r))
        return [np.asarray(r) for r in rout]

    def release(self, done):
        done = np.asarray(done, bool)
        self.ref = RP.release_slots(self.ref, jnp.asarray(done))
        self.port = TP.release_slots(self.port, torch.from_numpy(done))

    def release_refs(self, ids):
        ids = np.asarray(ids, np.int32)
        self.ref = RP.release_refs(self.ref, jnp.asarray(ids))
        self.port = TP.release_refs(self.port, torch.from_numpy(ids))

    def span(self, start, valid, width, bs, shared_until):
        args = [np.asarray(a, np.int32) for a in (start, valid, shared_until)]
        r = RP.span_targets(self.ref, jnp.asarray(args[0]), jnp.asarray(args[1]), width, bs,
                            self.MB * bs, False, jnp.asarray(args[2]))
        p = TP.span_targets(self.port, *map(torch.from_numpy, args[:2]), width, bs,
                            self.MB * bs, False, torch.from_numpy(args[2]))
        for a, b in zip(r, p):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        return [np.asarray(a) for a in r]


def test_admit_slot_shared_and_retained_refs():
    """``tests/test_engine_prefix.py``'s pin on both sides: shared blocks
    gain a reference without taking capacity, popped blocks start at ref 1
    and retained ones at 2; releases only decrement; each ``release_refs``
    drops one hold."""
    B, MB, NB = 2, 4, 10
    both = _Both(B, MB, NB)
    ids0 = both.admit(0, [], 3, 2)
    ref = _conserved(both.port, NB)
    assert [ref[b] for b in ids0] == [2, 2, 1]
    both.admit(1, ids0[:2], 1, 0)
    ref = _conserved(both.port, NB)
    assert [ref[b] for b in ids0[:2]] == [3, 3] and int(both.port["n_free"]) == NB - 4
    tbl = both.port["tbl"].numpy()
    assert tbl[1, 0] == ids0[0] and tbl[1, 1] == ids0[1]
    both.release([False, True])
    assert [_conserved(both.port, NB)[b] for b in ids0[:2]] == [2, 2]
    both.release([True, False])
    assert [_conserved(both.port, NB)[b] for b in ids0] == [1, 1, 0]
    both.release_refs(ids0[:2])
    assert int(both.port["n_free"]) == NB and not np.any(_conserved(both.port, NB))
    both.check("after the holds")


def test_alloc_step_cow_pops_private_copy():
    """A decode write into a shared block rewires the slot to a fresh block
    and reports the source; without sharing ``cow_src == wblk``."""
    B, MB, NB = 2, 3, 6
    both = _Both(B, MB, NB)
    b0 = both.admit(0, [], 1, 1)[0]
    both.admit(1, [b0], 0, 0)
    assert int(both.port["ref"][b0]) == 3
    wblk, woff, cow_src = both.step([0, 4], [False, True], 8, cow=True)
    ref = _conserved(both.port, NB)
    w1 = int(wblk[1])
    assert w1 != b0 and w1 < NB and int(cow_src[1]) == b0 and int(woff[1]) == 4
    assert ref[b0] == 2 and ref[w1] == 1 and int(both.port["tbl"][1, 0]) == w1
    wblk, _, cow_src = both.step([0, 5], [False, True], 8, cow=True)
    assert int(cow_src[1]) == int(wblk[1])
    both.check("after the copy")


def test_span_targets_drop_shared_watermark():
    """Rows below the prefix-hit watermark, and pads past ``valid``, go to
    the trash block."""
    MB, NB = 4, 8
    both = _Both(1, MB, NB)
    both.admit(0, [], 3, 0)
    wblk, woff = both.span([14], [6], 8, 8, [16])
    tbl = both.port["tbl"].numpy()[0]
    assert np.all(wblk[0, :2] == NB) and np.all(wblk[0, 2:6] == tbl[2])
    assert np.all(wblk[0, 6:] == NB)
    np.testing.assert_array_equal(woff[0, 2:6], [0, 1, 2, 3])


def test_prefix_allocator_replays_reference_trace():
    """80 random operations on 4 slots, 5 table entries of 4 tokens and a
    20-block pool, as the engine issues them: an admission first releases
    the slot, maps up to two index-held blocks shared and pops within the
    free stack, retaining some of the popped blocks for the index; decode
    steps with random lengths and activity, ``cow`` on and off; chunk write
    targets under a random watermark; releases; and evictions of random
    holds through ``release_refs`` (``-1`` padded)."""
    B, MB, NB, bs = 4, 5, 20, 4
    rng = np.random.default_rng(21)
    both = _Both(B, MB, NB)
    holds: list[int] = []
    seen = dict.fromkeys(["admit", "share", "step", "cow", "span", "release", "evict"], 0)
    for i in range(80):
        op = rng.choice(["admit", "step", "step", "span", "release", "evict"])
        n_free = int(both.port["n_free"])
        if op == "admit":
            s = int(rng.integers(B))
            done = np.zeros(B, bool)
            done[s] = True
            both.release(done)
            n_free = int(both.port["n_free"])
            k = int(rng.integers(0, min(2, len(holds)) + 1))
            shared = [int(b) for b in rng.choice(holds, k, replace=False)] if k else []
            n_new = int(rng.integers(0, min(n_free, MB - k) + 1))
            n_ret = int(rng.integers(0, n_new + 1))
            holds += both.admit(s, shared, n_new, n_ret)[:n_ret]
            seen["share"] += k > 0
        elif op == "step":
            cow = bool(rng.integers(0, 2))
            wblk, _, cow_src = both.step(rng.integers(0, MB * bs + 3, B),
                                         rng.random(B) < 0.8, bs, cow)
            seen["cow"] += int(np.sum(cow_src != wblk))
        elif op == "span":
            start = rng.integers(0, MB * bs, B)
            both.span(start, rng.integers(0, 7, B), 6, bs, start + rng.integers(-2, 4, B))
        elif op == "release":
            both.release(rng.random(B) < 0.4)
        else:
            if not holds:
                continue
            drop = [int(b) for b in rng.choice(holds, int(rng.integers(1, len(holds) + 1)),
                                               replace=False)]
            for b in drop:
                holds.remove(b)
            both.release_refs(drop + [NEG] * int(rng.integers(0, 3)))
        seen[str(op)] += 1
        both.check(f"op {i} ({op})")
        _conserved(both.port, NB)
    assert all(seen.values()), seen


# ---------------------------------------------------------------------------
# The prefix index
# ---------------------------------------------------------------------------

def test_prefix_index_match_register_evict():
    """``tests/test_engine_prefix.py``'s pin on both indexes."""
    for Index in (RefIndex, PrefixIndex):
        idx = Index(block_size=4)
        toks = list(range(10))
        assert chain_hashes(toks, 4) == chain_hashes(toks + [99], 4)
        assert idx.match(toks) == ([], None, [])
        assert idx.register(toks, [7, 3], 0) == [] and len(idx) == 2
        full, partial, keys = idx.match(toks)
        assert full == [7, 3] and partial is None and len(keys) == 2
        assert idx.match(toks[:6])[:2] == ([7], 3)
        assert idx.match([0, 1, 2, 3, 9, 9, 9, 9, 5])[:2] == ([7], None)
        assert idx.register(toks, [11, 12], 0) == [11, 12]
        _, _, keys = idx.match(toks)
        idx.pin(keys)
        assert idx.evict(2) == []
        idx.unpin(keys)
        assert idx.evict(2) == [3, 7] and len(idx) == 0


@settings(database=None, derandomize=True, max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1))
def test_prefix_index_decisions_equal_reference(seed):
    """Random prompts from three families that share prefixes of random
    depth, registered (duplicates included), matched, pinned, unpinned and
    evicted in random order: both indexes give the same matches, keys,
    duplicates, evictions and hit counts."""
    rng = np.random.default_rng(seed)
    bs = 4
    fams = [list(rng.integers(0, 6, 20)) for _ in range(3)]
    ref, port = RefIndex(bs), PrefixIndex(bs)
    next_id, pinned = 0, []
    for _ in range(30):
        fam = fams[rng.integers(3)]
        toks = fam[:rng.integers(0, 21)] + list(rng.integers(0, 6, rng.integers(0, 6)))
        op = rng.choice(["register", "match", "unpin", "evict"])
        if op == "register":
            n = len(toks) // bs
            first = int(rng.integers(0, n + 1))
            ids = list(range(next_id, next_id + n - first))
            next_id += n - first
            assert port.register(toks, ids, first) == ref.register(toks, ids, first)
            assert port.keys_for(toks, n) == ref.keys_for(toks, n)
        elif op == "match":
            got = port.match(toks)
            assert got == ref.match(toks)
            if rng.random() < 0.5:
                port.pin(got[2])
                ref.pin(got[2])
                pinned.append(got[2])
        elif op == "unpin" and pinned:
            keys = pinned.pop(int(rng.integers(len(pinned))))
            port.unpin(keys)
            ref.unpin(keys)
        elif op == "evict":
            want = int(rng.integers(1, 4))
            assert port.evict(want) == ref.evict(want)
        assert len(port) == len(ref)
        assert (port.hits, port.partial_hits, port.evictions) == \
            (ref.hits, ref.partial_hits, ref.evictions)


# ---------------------------------------------------------------------------
# The model's prefill chunk
# ---------------------------------------------------------------------------

def test_prefill_chunk_paged_matches_reference(models):
    """Two slots, blocks of 4, chunks of 8: slot 0 prefills 13 tokens in two
    pieces; slot 1 prefills 9 tokens, and its second piece runs under a
    watermark at row 10, so rows 8 and 9 are recomputed but not written."""
    ref_model, ref_params, model, params = models
    B, cache_len, bs, C = 2, 16, 4, 8
    NB = B * cache_len // bs
    rc = ref_model.init_paged_cache(B, cache_len, block_size=bs, num_blocks=NB)
    pc = model.init_paged_cache(B, cache_len, block_size=bs, num_blocks=NB)
    row = np.full(cache_len // bs, NEG, np.int32)
    for s, n in ((0, 4), (1, 3)):
        rb, _ = RP.admit_slot({k: rc[k] for k in RP.BSTATE_KEYS}, jnp.int32(s),
                              jnp.asarray(row), jnp.int32(0), jnp.int32(n), jnp.int32(0), 4)
        rc = {**rc, **rb}
        pb, _ = TP.admit_slot({k: pc[k] for k in TP.BSTATE_KEYS}, s, torch.from_numpy(row),
                              0, n, 0, 4)
        pc = {**pc, **pb}
    prompts = [_prompt(1, 13), _prompt(2, 9)]
    step = jax.jit(ref_model.prefill_chunk_paged)
    for start, valid, until in (([0, 0], [8, 8], [0, 0]), ([8, 8], [5, 1], [0, 10])):
        toks = np.zeros((B, C), np.int32)
        for b in range(B):
            toks[b, :valid[b]] = prompts[b][start[b]:start[b] + valid[b]]
        args = [np.asarray(a, np.int32) for a in (start, valid, until)]
        rl, rc = step(ref_params, jnp.asarray(toks), rc, *map(jnp.asarray, args))
        pl, pc = model.prefill_chunk_paged(params, torch.from_numpy(toks), pc,
                                           *map(torch.from_numpy, args), tiles=(8, cache_len))
        r = np.asarray(rl.astype(jnp.float32))
        assert np.abs(pl.float().numpy() - r).max() <= TOL * np.abs(r).max(), start
        np.testing.assert_array_equal(pc["lengths"].numpy(), np.asarray(rc["lengths"]))
        for name in ("pk", "pv"):   # the trash block (last) holds garbage
            rp = np.asarray(rc["stack"]["L0"][name].astype(jnp.float32))[:, :NB]
            pp = pc["stack"]["L0"][name].float().numpy()[:, :NB]
            assert np.abs(pp - rp).max() <= TOL * np.abs(rp).max(), (start, name)
    # the watermark kept rows 8 and 9 of slot 1 (its third block) unwritten
    blk = int(pc["tbl"][1, 2])
    assert not pc["stack"]["L0"]["pk"][:, blk, :2].any()


# ---------------------------------------------------------------------------
# The engine against the reference's
# ---------------------------------------------------------------------------

def _min_margin(model, params, prompt, continuation) -> float:
    """Smallest top-2 logit gap / max|logit| over the greedy steps that
    produced ``continuation`` (teacher-forced through the port's model)."""
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None]},
                                  cache_len=len(prompt) + len(continuation))
    worst = np.inf
    for tok in continuation:
        lf = logits.float()[0]
        top = torch.topk(lf, 2).values
        worst = min(worst, float((top[0] - top[1]) / lf.abs().max()))
        logits, cache = model.decode_step(params, torch.tensor([[tok]], dtype=torch.int32),
                                          cache)
    return worst


def _shared_prompts():
    """A 20-token system prompt (two and a half blocks of 8) with three
    suffixes, then a prefix of the second cut mid-block (a partial-tail
    hit)."""
    sysp = _prompt(14, 20)
    prompts = [np.concatenate([sysp, _prompt(142 + i, n)]) for i, n in enumerate((6, 12, 9))]
    return prompts + [prompts[1][:28]]


def test_prefix_engine_matches_reference_engine(models):
    """Cold then warm through one engine each: the greedy tokens and the
    counters of events (tokens, prefix-hit tokens, chunk pieces, completed
    prompts, copies, blocks popped) equal ``repro``'s; the port's counters
    also account for every block after each serve."""
    ref_model, ref_params, model, params = models
    prompts = _shared_prompts()
    kw = dict(slots=2, cache_len=48, k_steps=3, paged=True, block_size=8, prefix_cache=True)
    ref_eng = RefEngine(ref_model, ref_params, **kw)
    eng = Engine(model, params, check_invariants=True, **kw)
    for run in ("cold", "warm"):
        held0 = len(eng._hold_blocks)
        ref_out, rs = ref_eng.serve([jnp.asarray(p) for p in prompts], gen_tokens=5,
                                    return_stats=True)
        if run == "cold":
            for p, out in zip(prompts, ref_out):
                assert _min_margin(model, params, p, out) > TOL
        outs, stats = eng.serve(prompts, gen_tokens=5, return_stats=True)
        assert outs == [list(map(int, o)) for o in ref_out], run
        for k in ("tokens", "prefix_hit_tokens", "chunk_pieces", "chunks_completed",
                  "cow_copies", "blocks_popped"):
            assert stats["counters"][k] == rs["counters"][k], (run, k)
        for k in ("prefix_hits", "prefill_tokens", "prefill_calls", "dispatches"):
            assert stats[k] == rs[k], (run, k)
        c = stats["counters"]
        assert held0 + c["blocks_popped"] - c["blocks_released"] == len(eng._hold_blocks)
        assert eng._hold_blocks == ref_eng._hold_blocks
    assert c["prefix_hit_tokens"] == stats["prefix_hits"] > 0 and c["cow_copies"] >= 1


# ---------------------------------------------------------------------------
# Exactness inside the port
# ---------------------------------------------------------------------------

def test_chunked_and_prefix_cached_equal_one_shot(models):
    """One-shot paged, chunked (two chunk sizes, one not dividing the
    prompts) and prefix-cached cold and warm give the same tokens; the warm
    pass prefills fewer tokens and the partial-tail hit copies a block."""
    _, _, model, params = models
    prompts = _shared_prompts()
    kw = dict(slots=2, cache_len=48, k_steps=3, paged=True, block_size=8,
              check_invariants=True)
    one, ones = Engine(model, params, **kw).serve(prompts, gen_tokens=6, return_stats=True)
    for C in (8, 12):
        assert Engine(model, params, chunk_size=C, **kw).serve(prompts, gen_tokens=6) == one
    eng = Engine(model, params, prefix_cache=True, **kw)
    cold, cs = eng.serve(prompts, gen_tokens=6, return_stats=True)
    warm, ws = eng.serve(prompts, gen_tokens=6, return_stats=True)
    assert cold == one and warm == one
    assert ws["prefill_tokens"] < cs["prefill_tokens"] < ones["prefill_tokens"]
    assert ws["counters"]["cow_copies"] >= 1 and cs["counters"]["cow_copies"] >= 1


def test_partial_block_hit_copy_on_write_exact(models):
    """A mid-block prefix of a cached prompt maps the cached partial block
    shared; its first decode write copies the block, and the cached prompt
    served again still reads its own rows."""
    _, _, model, params = models
    long = _prompt(31, 24)
    short = long[:20]
    kw = dict(slots=1, cache_len=40, k_steps=2)
    want_l = Engine(model, params, **kw).serve([long], gen_tokens=5)
    want_s = Engine(model, params, **kw).serve([short], gen_tokens=5)
    eng = Engine(model, params, paged=True, block_size=8, num_blocks=12, prefix_cache=True,
                 chunk_size=8, check_invariants=True, **kw)
    assert eng.serve([long], gen_tokens=5) == want_l
    outs, stats = eng.serve([short], gen_tokens=5, return_stats=True)
    assert outs == want_s and stats["counters"]["cow_copies"] == 1
    assert eng._index.partial_hits > 0
    assert eng.serve([long], gen_tokens=5) == want_l


def test_prefix_gen_tokens_one_releases_and_still_caches(models):
    """gen_tokens=1 drains each slot in the dispatch that finishes its
    prefill; the retained prompt blocks survive that release and serve the
    next requests' hits."""
    _, _, model, params = models
    prompts = [_prompt(41, 16)] * 3
    want = Engine(model, params, slots=2, cache_len=24, k_steps=2).serve(prompts, gen_tokens=1)
    eng = Engine(model, params, slots=2, cache_len=24, k_steps=2, paged=True, block_size=8,
                 num_blocks=8, prefix_cache=True, chunk_size=8, check_invariants=True)
    outs, stats = eng.serve(prompts, gen_tokens=1, return_stats=True)
    assert outs == want and stats["prefix_hits"] > 0
    c = stats["counters"]
    assert c["blocks_popped"] - c["blocks_released"] == len(eng._hold_blocks) == 2


@pytest.mark.parametrize("case", ["evict", "saturated"])
def test_admission_evicts_instead_of_deadlocking(models, case):
    """``evict``: a 5-block pool whose blocks the index holds for earlier
    prompts; admitting unrelated content evicts LRU entries instead of
    waiting.  ``saturated``: every block cached and matched by a partial
    hit that needs a CoW spare; admission unpins and evicts its own matches
    and degrades toward a cold prefill instead of stalling."""
    _, _, model, params = models
    if case == "evict":
        common = _prompt(5, 16)
        prompts = [np.concatenate([common, _prompt(6, 6)]),
                   np.concatenate([common, _prompt(7, 6)]), _prompt(8, 22)]
        serves, kw = [prompts], dict(cache_len=32, num_blocks=5, gen=4)
    else:
        long = _prompt(51, 24)
        serves, kw = [[long], [long[:20]]], dict(cache_len=24, num_blocks=3, gen=8)
    gen = kw.pop("gen")
    eng = Engine(model, params, slots=1, k_steps=2, paged=True, block_size=8,
                 prefix_cache=True, chunk_size=8, check_invariants=True, **kw)
    for reqs in serves:
        want = Engine(model, params, slots=1, cache_len=kw["cache_len"],
                      k_steps=2).serve(reqs, gen_tokens=gen)
        outs, stats = eng.serve(reqs, gen_tokens=gen, return_stats=True)
        assert outs == want
    assert stats["prefix_evictions"] > 0
    if case == "evict":
        assert stats["prefix_hits"] > 0


_SPEC = LanguageSpec(vocab=512)


def _tokens(L, seed):
    """``tests/test_engine_prefix.py``'s draw: ``sample_batch`` gives L + 1
    tokens."""
    return np.asarray(sample_batch(jax.random.PRNGKey(seed), _SPEC, 1, L)[0]).astype(np.int32)


@pytest.mark.parametrize("seed", [961799, 401660, 29332, 0, 123456])
def test_prefix_stress_conserves_blocks(models, seed):
    """The workload of the reference's ``test_prefix_stress_randomized``
    drawn at ``seed`` (prompt families of random depth, more requests than
    slots, random chunk, k_steps, gen and a tightened pool), served cold
    and warm with conservation asserted after every admission and
    dispatch: tokens equal the port's contiguous engine's, and after each
    serve the counters account for exactly the blocks the index holds.
    The first three seeds leak a block in the reference's counters."""
    _, _, model, params = models
    rng = np.random.RandomState(seed)
    slots = int(rng.randint(2, 4))
    n_fam = int(rng.randint(1, 4))
    fams = [_tokens(int(rng.randint(4, 22)), seed % 911 + f) for f in range(n_fam)]
    n_req = int(rng.randint(slots, slots + 4))
    prompts = []
    for i in range(n_req):
        fam = fams[int(rng.randint(n_fam))]
        depth = int(rng.randint(0, fam.shape[0] + 1))
        tail = _tokens(int(rng.randint(1, 9)), seed % 877 + 50 + i)
        prompts.append(np.concatenate([fam[:depth], tail]))
    lens = [len(p) for p in prompts]
    gen = int(rng.randint(1, 7))
    k_steps = int(rng.randint(1, 4))
    chunk = int(rng.choice([4, 8, 16]))
    cache_len = max(lens) + gen + int(rng.randint(0, 6))
    want = Engine(model, params, slots=slots, cache_len=cache_len,
                  k_steps=k_steps).serve(prompts, gen_tokens=gen)
    lo = max(TP.blocks_for(min(L + gen - 1, cache_len), 8) + 1 for L in lens)
    full = slots * TP.blocks_for(cache_len, 8) + 4
    num_blocks = int(rng.randint(lo, full + 1))
    eng = Engine(model, params, slots=slots, cache_len=cache_len, k_steps=k_steps, paged=True,
                 block_size=8, num_blocks=num_blocks, prefix_cache=True, chunk_size=chunk,
                 check_invariants=True)
    for _ in ("cold", "warm"):
        held0 = len(eng._hold_blocks)
        outs, stats = eng.serve(prompts, gen_tokens=gen, return_stats=True)
        assert outs == want
        c = stats["counters"]
        assert held0 + c["blocks_popped"] - c["blocks_released"] == len(eng._hold_blocks)
        assert c["prefix_hit_tokens"] == stats["prefix_hits"]
        assert c["tokens"] == stats["tokens"]


def test_chunked_engine_validation(models):
    _, _, model, params = models
    with pytest.raises(ValueError, match="paged=True"):
        Engine(model, params, chunk_size=8)
    with pytest.raises(ValueError, match="paged=True"):
        Engine(model, params, prefix_cache=True)
    eng = Engine(model, params, paged=True, block_size=8, prefix_cache=True)
    assert eng.cfg.chunk_size == 32 and eng._tiles == (32, 256)
    with pytest.raises(ValueError, match="exceeds cache_len"):
        Engine(model, params, cache_len=16, paged=True, chunk_size=8).serve(
            [_prompt(0, 17)], gen_tokens=2)
