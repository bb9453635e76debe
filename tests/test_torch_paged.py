"""repro_torch's paged KV cache against repro's, and against the port's own
contiguous engine, on the CPU.

* The allocator (``engine/paged.py``): one random trace of admissions,
  decode-step allocations (``cow`` on and off, blocks shared by hand as the
  prefix cache would share them, pool exhaustion routed to the trash block)
  and releases is replayed through ``repro.engine.paged`` and the port;
  every integer tensor of the state and every returned write target is
  equal at every step (exact).
* ``gather_blocks`` (exact), ``write_paged_kv`` (exact) and
  ``paged_decode_attention`` (float32, rtol 1e-5 / atol 1e-6, as
  ``tests/test_torch_model.py``'s attention pieces) against the reference.
* ``Model.decode_step_paged`` on the reduced GLM-4-9B: the block state
  after each step exact, the bf16 logits within 2e-2 * max|logit| (the
  tolerance of ``tests/test_torch_model.py``).
* ``Engine(paged=True)``: greedy tokens and the ``blocks_popped`` /
  ``blocks_released`` counters equal to ``repro``'s paged engine, where
  every emitted token's top-2 margin exceeds that tolerance (the rule of
  ``tests/test_torch_engine.py``).
* Inside the port, paged == contiguous token for token (exact) with mixed
  prompt lengths, an over-long prompt, ``gen_tokens=1`` and a pool too
  tight for two requests at once, all with ``check_invariants=True``; and
  the validation errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.engine import Engine as RefEngine
from repro.engine import paged as RP
from repro.models import attention as RA
from repro.models import build_model as ref_build_model
from repro_torch.compat import params_from_jax
from repro_torch.configs import get_arch, reduced
from repro_torch.engine import Engine
from repro_torch.engine import paged as TP
from repro_torch.models import attention as TA
from repro_torch.models import build_model

TOL = 2e-2


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
        if "bias" in jax.tree_util.keystr(path):
            return rng.standard_normal(s.shape) * 0.1
        return 1.0 + 0.1 * rng.standard_normal(s.shape)

    ref_params = jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(draw(p, s).astype(np.float32)).astype(jnp.bfloat16), shapes)
    model = build_model(reduced(get_arch("glm4-9b")), device="cpu")
    return ref_model, ref_params, model, params_from_jax(jax.device_get(ref_params))


# ---------------------------------------------------------------------------
# The allocator, replayed step by step
# ---------------------------------------------------------------------------

def _state_equal(ref: dict, port: dict, where: str):
    for k in TP.BSTATE_KEYS:
        r, p = np.asarray(ref[k]), port[k].numpy()
        assert p.dtype == r.dtype, (where, k, p.dtype, r.dtype)
        np.testing.assert_array_equal(p, r, err_msg=f"{where}: {k}")


def test_allocator_replays_reference_trace():
    """40 random operations on 4 slots, 5 table entries of 4 tokens and a
    10-block pool: admissions (within the free stack, as the engine's
    ledger guarantees), decode steps with random lengths (past capacity
    included) and activity, ``cow`` on and off, releases, and blocks shared
    between two slots by hand (ref 2), so a CoW step pops a private copy."""
    B, MB, NB, bs = 4, 5, 10, 4
    cap = MB * bs
    rng = np.random.default_rng(11)
    ref = RP.init_block_state(B, MB, NB)
    port = TP.init_block_state(B, MB, NB, "cpu")
    _state_equal(ref, port, "init")
    seen = {"admit": 0, "step": 0, "cow": 0, "exhausted": 0, "release": 0, "share": 0}
    for i in range(40):
        op = rng.choice(["admit", "step", "step", "release", "share"])
        n_free = int(ref["n_free"])
        if op == "admit":
            g = int(rng.integers(1, 3))
            slots = rng.choice(B, g, replace=False).astype(np.int32)
            nbl = int(rng.integers(1, MB + 1))
            counts = np.zeros(g, np.int32)
            budget = n_free
            for j in range(g):
                counts[j] = rng.integers(0, min(nbl, budget) + 1)
                budget -= counts[j]
            ref, rw = RP.alloc_admit(ref, jnp.asarray(slots), jnp.asarray(counts), nbl)
            port, pw = TP.alloc_admit(port, torch.from_numpy(slots), torch.from_numpy(counts),
                                      nbl)
            np.testing.assert_array_equal(pw.numpy(), np.asarray(rw))
        elif op == "step":
            cow = bool(rng.integers(0, 2))
            lengths = rng.integers(0, cap + 3, B).astype(np.int32)
            active = rng.random(B) < 0.8
            ref = {**ref, "slot_active": jnp.asarray(active)}
            port = {**port, "slot_active": torch.from_numpy(active)}
            ref, *rout = RP.alloc_step(ref, jnp.asarray(lengths), bs, cap, False, cow=cow)
            port, *pout = TP.alloc_step(port, torch.from_numpy(lengths), bs, cap, False,
                                        cow=cow)
            for r, p in zip(rout, pout):
                np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=f"op {i}")
            seen["cow"] += int(np.sum(np.asarray(rout[2]) != np.asarray(rout[0])))
            # an active slot inside capacity routed to the trash: the pool was dry
            seen["exhausted"] += int(np.sum(active & (lengths < cap)
                                            & (np.asarray(rout[0]) == NB)))
        elif op == "release":
            done = rng.random(B) < 0.4
            ref = RP.release_slots(ref, jnp.asarray(done))
            port = TP.release_slots(port, torch.from_numpy(done))
        else:  # share a held block into another slot's empty entry
            tbl = np.asarray(ref["tbl"]).copy()
            held = tbl[tbl >= 0]
            empty = np.argwhere(tbl < 0)
            if not len(held) or not len(empty):
                continue
            b = int(rng.choice(held))
            s, j = empty[rng.integers(len(empty))]
            tbl[s, j] = b
            rc = np.asarray(ref["ref"]).copy()
            rc[b] += 1
            ref = {**ref, "tbl": jnp.asarray(tbl), "ref": jnp.asarray(rc)}
            port = {**port, "tbl": torch.from_numpy(tbl), "ref": torch.from_numpy(rc)}
        seen[str(op)] += 1
        _state_equal(ref, port, f"op {i} ({op})")
    assert all(seen.values()), seen


def test_gather_write_and_paged_attention_match_reference():
    rng = np.random.default_rng(3)
    NB, bs, Kv, H, hd, B = 6, 4, 2, 4, 8, 3
    pool_k = rng.standard_normal((NB + 1, bs, Kv, hd)).astype(np.float32)
    pool_v = rng.standard_normal((NB + 1, bs, Kv, hd)).astype(np.float32)
    tbl = np.array([[2, 0, -1], [5, -1, -1], [1, 3, 4]], np.int32)
    g = TP.gather_blocks(torch.from_numpy(pool_k), torch.from_numpy(tbl))
    np.testing.assert_array_equal(g.numpy(), np.asarray(RP.gather_blocks(pool_k, tbl)))
    k_new = rng.standard_normal((B, 1, Kv, hd)).astype(np.float32)
    v_new = rng.standard_normal((B, 1, Kv, hd)).astype(np.float32)
    wblk, woff = np.array([0, NB, 4], np.int32), np.array([3, 1, 2], np.int32)
    rk, rv = RA.write_paged_kv(jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(k_new),
                               jnp.asarray(v_new), jnp.asarray(wblk), jnp.asarray(woff))
    tk, tv = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())
    TA.write_paged_kv(tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new),
                      torch.from_numpy(wblk).long(), torch.from_numpy(woff).long())
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    lengths = np.array([7, 2, 11], np.int32)
    ref = RA.paged_decode_attention(jnp.asarray(q), rk, rv, jnp.asarray(tbl),
                                    jnp.asarray(lengths))
    port = TA.paged_decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(tbl),
                                     torch.from_numpy(lengths))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The model's paged decode step
# ---------------------------------------------------------------------------

def test_decode_step_paged_matches_reference(models):
    """Two slots from empty caches, blocks of 4, seven teacher-forced steps:
    slot 1 drains after step 3 (its blocks released; its later writes go to
    the trash block), so steps cross block boundaries, pop and release."""
    ref_model, ref_params, model, params = models
    B, cache_len, bs = 2, 16, 4
    NB = B * (cache_len // bs)
    rc = ref_model.init_paged_cache(B, cache_len, block_size=bs, num_blocks=NB)
    pc = model.init_paged_cache(B, cache_len, block_size=bs, num_blocks=NB)
    rc = {**rc, "slot_active": jnp.ones(B, bool)}
    pc["slot_active"] = torch.ones(B, dtype=torch.bool)
    toks = np.random.default_rng(5).integers(0, 512, (7, B, 1)).astype(np.int32)
    step = jax.jit(ref_model.decode_step_paged)
    for t in range(7):
        rl, rc = step(ref_params, jnp.asarray(toks[t]), rc)
        pl, pc = model.decode_step_paged(params, torch.from_numpy(toks[t]), pc)
        r = np.asarray(rl.astype(jnp.float32))
        assert np.abs(pl.float().numpy() - r).max() <= TOL * np.abs(r).max(), t
        _state_equal(rc, pc, f"step {t}")
        np.testing.assert_array_equal(pc["lengths"].numpy(), np.asarray(rc["lengths"]))
        if t == 3:
            done = np.array([False, True])
            rc = {**rc, **RP.release_slots({k: rc[k] for k in RP.BSTATE_KEYS},
                                           jnp.asarray(done))}
            pc = {**pc, **TP.release_slots({k: pc[k] for k in TP.BSTATE_KEYS},
                                           torch.from_numpy(done))}
    assert int(pc["n_free"]) == NB - 2      # slot 0 holds 7 rows: two blocks


# ---------------------------------------------------------------------------
# The engine
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


def test_paged_serve_matches_reference_engine(models):
    """Unequal prompt lengths, more requests than slots, blocks of 8 crossed
    during decode: the greedy tokens and the allocator counters equal
    ``repro``'s paged engine's."""
    ref_model, ref_params, model, params = models
    prompts = [_prompt(s, L) for s, L in [(0, 10), (1, 7), (3, 9), (4, 10)]]
    kw = dict(slots=2, cache_len=24, k_steps=3, paged=True, block_size=8)
    ref_out, ref_stats = RefEngine(ref_model, ref_params, **kw).serve(
        [jnp.asarray(p) for p in prompts], gen_tokens=5, return_stats=True)
    for p, out in zip(prompts, ref_out):
        assert _min_margin(model, params, p, out) > TOL
    outs, stats = Engine(model, params, check_invariants=True, **kw).serve(
        prompts, gen_tokens=5, return_stats=True)
    assert outs == [list(map(int, o)) for o in ref_out]
    for k in ("tokens", "blocks_popped", "blocks_released", "cow_copies"):
        assert stats["counters"][k] == ref_stats["counters"][k], k
    assert stats["counters"]["blocks_popped"] == stats["counters"]["blocks_released"] > 0
    assert stats["prefill_calls"] == ref_stats["prefill_calls"]


@pytest.mark.parametrize("case", ["mixed", "overlong", "gen1", "tight"])
def test_paged_equals_contiguous_in_the_port(models, case):
    """Token for token, with ``check_invariants=True`` (conservation after
    every admission and dispatch).  ``overlong``: prompts longer than the
    slot's capacity keep their first ``cache_len`` rows, and the allocator
    debits only the blocks the scatter fills, so nothing leaks.  ``gen1``:
    every slot finishes at admission and its blocks come back there.
    ``tight``: each request needs 3 of the 4 blocks, so admission takes one
    request at a time (one prefill each) where the contiguous engine takes
    two; the port's rows do not depend on the batch here, so the tokens are
    equal all the same."""
    _, _, model, params = models
    lens, gen, cache_len, extra = {
        "mixed": ([10, 25, 6, 17, 9, 12], 6, 40, {}),
        "overlong": ([24, 24, 24, 24], 3, 16, {}),
        "gen1": ([16] * 6, 1, 24, {"num_blocks": 4}),
        "tight": ([20, 20, 20, 20], 5, 32, {"num_blocks": 4}),
    }[case]
    prompts = [_prompt(10 + i, L) for i, L in enumerate(lens)]
    contig, cstats = Engine(model, params, slots=2, cache_len=cache_len, k_steps=3).serve(
        prompts, gen_tokens=gen, return_stats=True)
    paged = Engine(model, params, slots=2, cache_len=cache_len, k_steps=3, paged=True,
                   block_size=8, check_invariants=True, **extra)
    outs, stats = paged.serve(prompts, gen_tokens=gen, return_stats=True)
    assert outs == contig
    assert [len(o) for o in outs] == [gen] * len(prompts)
    ctr = stats["counters"]
    assert ctr["blocks_popped"] == ctr["blocks_released"]
    if case == "tight":
        assert stats["prefill_calls"] == 4 > cstats["prefill_calls"]
    if case == "gen1":
        assert stats["dispatches"] == 0
    if case == "mixed":
        assert stats["cache_bytes"] > 0 and ctr["blocks_popped"] > 0


def test_paged_validation_errors(models):
    _, _, model, params = models
    eng = Engine(model, params, slots=2, cache_len=64, k_steps=2, paged=True, block_size=8,
                 num_blocks=2)
    with pytest.raises(ValueError, match="blocks but the pool"):
        eng.serve([_prompt(0, 40)], gen_tokens=4)
    with pytest.raises(ValueError, match="k_steps"):
        Engine(model, params, k_steps=0, paged=True)
    with pytest.raises(TypeError):
        Engine(model, params, Engine(model, params).cfg, paged=True)
