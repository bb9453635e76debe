"""The pure pieces of repro_torch's self-speculative decoding against
repro's, and the verify forward against the port's own decode, on the CPU.

* ``greedy_accept``: accepted counts and the output grid bit-equal to the
  reference's, with no depth, a Python-int depth, a scalar tensor and one
  depth per slot.
* ``rejection_accept``: the first emitted token of 60,000 rounds follows the
  warped target (within 5 binomial standard deviations of each
  probability, as ``tests/test_torch_engine.py`` holds the sampler),
  tokens the warp cuts never appear, at full depth and at depth 1; a draft
  identical to the target always accepts.
* ``DepthController``: trajectories on the same random (drafted, accepted)
  sequences, and the validation error and clamps, equal to the reference's.
* ``alloc_span``: states and outputs equal to the reference's on a
  copy-on-write pop, a private block, a span into a fresh block, a dry pool
  (blocked), two slots sharing one block, and a ring (exact).
* ``paged_verify_attention`` (float32, rtol 1e-5 / atol 1e-6, as
  ``tests/test_torch_paged.py``'s attention pieces) and
  ``Model.verify_chunk_paged`` (bf16 logits and pool rows within 2e-2 of
  their largest magnitude) against the reference.
* Inside the port, ``verify_chunk_paged`` over 5 rows gives, row for row,
  the bits of 5 ``decode_step_paged`` calls (logits and pool rows), at
  d_model 64, 128 and 256 (``PERF.md``, decision a).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.engine import DepthController as RefDepth
from repro.engine import SamplingParams as RefSP
from repro.engine import greedy_accept as ref_greedy
from repro.engine import probs as ref_probs
from repro.engine import paged as RP
from repro.models import attention as RA
from repro.models import build_model as ref_build_model
from repro_torch.compat import params_from_jax
from repro_torch.configs import get_arch, reduced
from repro_torch.engine import (DepthController, SamplingParams, greedy_accept, probs,
                                rejection_accept, sample)
from repro_torch.engine import paged as TP
from repro_torch.models import attention as TA
from repro_torch.models import build_model

TOL = 2e-2
NEG = TP.NEG


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
# Acceptance rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [None, 2, "scalar", "per-slot"])
def test_greedy_accept_equals_reference(depth):
    """Logits with planted agreements: random drafts, each copied from the
    verifier's argmax with probability 0.7, so prefixes of every length."""
    rng = np.random.default_rng(7)
    B, n, V = 64, 4, 11
    logits = rng.standard_normal((B, n + 1, V)).astype(np.float32)
    drafts = rng.integers(0, V, (B, n)).astype(np.int32)
    hit = rng.random((B, n)) < 0.7
    drafts = np.where(hit, logits[:, :n].argmax(-1), drafts).astype(np.int32)
    if depth == "scalar":
        d_ref, d_port = jnp.int32(3), torch.full((), 3, dtype=torch.int32)
    elif depth == "per-slot":
        d = rng.integers(1, n + 1, B).astype(np.int32)
        d_ref, d_port = jnp.asarray(d), torch.from_numpy(d)
    else:
        d_ref = d_port = depth
    r_out, r_a = ref_greedy(jnp.asarray(drafts), jnp.asarray(logits), d_ref)
    p_out, p_a = greedy_accept(torch.from_numpy(drafts), torch.from_numpy(logits), d_port)
    assert p_out.dtype == p_a.dtype == torch.int32
    np.testing.assert_array_equal(p_a.numpy(), np.asarray(r_a))
    np.testing.assert_array_equal(p_out.numpy(), np.asarray(r_out))
    assert len(set(p_a.tolist())) > 2


@pytest.mark.parametrize("depth", [None, 1])
def test_rejection_sampling_follows_the_warped_target(depth):
    """``tests/test_engine_spec.py``'s toy vocabulary: a draft distribution
    that disagrees with the target; the first emitted token of each round
    is distributed as plain sampling from the warped target."""
    V, N = 6, 60000
    p_logits = torch.tensor([[0.5, -0.2, 1.1, 0.0, -1.0, 0.4],
                             [1.0, 0.0, 0.0, -0.5, 0.3, -0.2],
                             [0.0, 0.2, -0.3, 0.8, 0.1, -0.9]])
    q_logits = torch.tensor([[1.2, 0.1, -0.5, 0.3, 0.0, -0.2],
                             [-0.3, 0.9, 0.2, 0.0, -1.0, 0.5]])
    sp = SamplingParams(greedy=False, temperature=0.9, top_k=5, top_p=0.95)
    gen = torch.Generator().manual_seed(42)
    q = q_logits.expand(N, 2, V)
    drafts = sample(q, gen, sp)
    out, a = rejection_accept(gen, drafts, q, p_logits.expand(N, 3, V), sp,
                              None if depth is None else torch.full((), depth,
                                                                    dtype=torch.int32))
    if depth is not None:
        assert int(a.max()) <= depth
    freq = torch.bincount(out[:, 0].long(), minlength=V).double() / N
    want = probs(p_logits[0], sp).double()
    ref_want = np.asarray(ref_probs(jnp.asarray(p_logits[0].numpy()),
                                    RefSP(greedy=False, temperature=0.9, top_k=5, top_p=0.95)))
    np.testing.assert_allclose(want.numpy(), ref_want, rtol=1e-5, atol=1e-7)
    sd = torch.sqrt(want * (1 - want) / N)
    assert torch.all((freq - want).abs() <= 5 * sd + 1e-12), (freq, want)
    assert torch.all(freq[want == 0] == 0)


def test_rejection_accept_identical_draft_always_accepts():
    """q == p accepts every draft (the ratio test is >= 1) and keeps it."""
    gen = torch.Generator().manual_seed(5)
    p = torch.randn((4, 3, 8), generator=gen)
    sp = SamplingParams(greedy=False, temperature=0.8)
    drafts = sample(p[:, :2], gen, sp)
    out, a = rejection_accept(gen, drafts, p[:, :2], p, sp)
    assert a.tolist() == [2, 2, 2, 2]
    assert torch.equal(out[:, :2], drafts)


# ---------------------------------------------------------------------------
# The depth controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(n_max=4), dict(n_max=4, depth=1), dict(n_max=3, patience=1),
                                dict(n_max=4, lo=-1.0, hi=2.0), dict(n_max=6, lo=0.3, hi=0.6)])
def test_depth_controller_trajectories_equal_reference(kw):
    """200 dispatches of random (drafted, accepted) deltas, zero drafts
    included, through both controllers."""
    rng = np.random.default_rng(len(str(kw)))
    ref, port = RefDepth(**kw), DepthController(**kw)
    assert (port.depth, port.streak) == (ref.depth, ref.streak)
    for _ in range(200):
        dr = int(rng.integers(0, 9))
        ac = int(rng.integers(0, dr + 1)) if rng.random() < 0.5 else dr
        assert port.update(dr, ac) == ref.update(dr, ac)
        assert (port.depth, port.streak) == (ref.depth, ref.streak)


def test_depth_controller_validation_and_clamps():
    for Ctl in (RefDepth, DepthController):
        with pytest.raises(ValueError, match="n_max"):
            Ctl(0)
        assert Ctl(2, depth=5).depth == 2 and Ctl(3).depth == 3 and Ctl(3, depth=-2).depth == 1


# ---------------------------------------------------------------------------
# alloc_span
# ---------------------------------------------------------------------------

def _span_case(case):
    """(state as numpy, lengths, width, cap, ring): the reference tests'
    shared-block state (slot 0 holds block 0, a partly filled prompt block
    the prefix index also holds; blocks 1..3 free) and its variants."""
    tbl = np.full((2, 4), NEG, np.int32)
    tbl[0, 0] = 0
    ref = np.array([2, 0, 0, 0], np.int32)
    st = dict(tbl=tbl, free=np.array([1, 2, 3, 0], np.int32), n_free=np.int32(3), ref=ref,
              slot_active=np.array([True, False]))
    lengths, width, ring = [4, 0], 2, False
    if case == "private":
        ref[0] = 1
    elif case == "fresh":
        lengths, width = [6, 0], 4
    elif case == "dry":
        st["n_free"] = np.int32(0)
    elif case == "two-sharers":
        tbl[1, 0] = 0
        ref[0] = 3
        st["slot_active"] = np.array([True, True])
        lengths = [4, 5]
    elif case == "ring":
        ring = True
    return st, np.array(lengths, np.int32), width, 32, ring


@pytest.mark.parametrize("case", ["cow", "private", "fresh", "dry", "two-sharers", "ring"])
def test_alloc_span_equals_reference(case):
    st, lengths, width, cap, ring = _span_case(case)
    r = RP.alloc_span({k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(lengths), width,
                      8, cap, ring, cow=True)
    p = TP.alloc_span({k: torch.from_numpy(np.asarray(v)) for k, v in st.items()},
                      torch.from_numpy(lengths), width, 8, cap, ring, cow=True)
    for k in TP.BSTATE_KEYS:
        assert p[0][k].numpy().dtype == np.asarray(r[0][k]).dtype, k
        np.testing.assert_array_equal(p[0][k].numpy(), np.asarray(r[0][k]), err_msg=k)
    for a, b in zip(p[1:], r[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out, src, dst, blocked = p
    n_free, refs = int(out["n_free"]), out["ref"].numpy()
    assert n_free + int((refs > 0).sum()) == 4 or case == "dry"
    if case == "cow":
        new = int(out["tbl"][0, 0])
        assert (int(src[0]), int(dst[0])) == (0, new) and refs[0] == 1 and refs[new] == 1
    elif case == "two-sharers":      # both copy: two pops, two decrements on block 0
        assert refs[0] == 1 and n_free == 1 and int(src[0]) == int(src[1]) == 0
        assert (src != dst).all() and int(dst[0]) != int(dst[1])
    elif case == "fresh":            # a copy of entry 0 and a plain pop for entry 1
        assert n_free == 1 and int(out["tbl"][0, 1]) >= 0
    elif case == "dry":
        assert blocked.tolist() == [True, False] and refs[0] == 2 and int(src[0]) == int(dst[0])
    else:                            # private, ring: nothing popped or copied
        assert n_free == 3 and (src == dst).all() and not blocked.any()


# ---------------------------------------------------------------------------
# The verify forward
# ---------------------------------------------------------------------------

def test_paged_verify_attention_matches_reference():
    """Three slots, blocks of 4, a chunk of 3 rows starting mid-block, at
    the table's end and in an empty slot; float32 pools.  Also under a
    sliding window: of 8 rows over the 12-row linear table (a window
    mask), and of 12 rows, the table's span (a ring: each row rebuilds the
    ring its decode step would read)."""
    rng = np.random.default_rng(4)
    NB, bs, Kv, H, hd, B, C = 8, 4, 2, 4, 8, 3, 3
    pk = rng.standard_normal((NB + 1, bs, Kv, hd)).astype(np.float32)
    pv = rng.standard_normal((NB + 1, bs, Kv, hd)).astype(np.float32)
    tbl = np.array([[2, 0, -1], [5, 6, 7], [1, -1, -1]], np.int32)
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    k_new = rng.standard_normal((B, C, Kv, hd)).astype(np.float32)
    v_new = rng.standard_normal((B, C, Kv, hd)).astype(np.float32)
    start, valid = np.array([5, 9, 0], np.int32), np.array([3, 3, 2], np.int32)
    ref = RA.paged_verify_attention(*map(jnp.asarray, (q, pk, pv, k_new, v_new, tbl, start,
                                                       valid)))
    port = TA.paged_verify_attention(*map(torch.from_numpy, (q, pk, pv, k_new, v_new, tbl,
                                                             start, valid)))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    for window in (8, 12):
        ref = RA.paged_verify_attention(*map(jnp.asarray, (q, pk, pv, k_new, v_new, tbl, start,
                                                           valid)), sliding_window=window)
        port = TA.paged_verify_attention(*map(torch.from_numpy, (q, pk, pv, k_new, v_new, tbl,
                                                                 start, valid)), window=window)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def _admitted_caches(ref_model, model, B, cache_len, bs):
    """Both models' paged caches with every slot's whole table allocated."""
    NB = B * cache_len // bs
    MB = cache_len // bs
    rc = ref_model.init_paged_cache(B, cache_len, block_size=bs, num_blocks=NB)
    pc = model.init_paged_cache(B, cache_len, block_size=bs, num_blocks=NB)
    row = np.full(MB, NEG, np.int32)
    for s in range(B):
        rb, _ = RP.admit_slot({k: rc[k] for k in RP.BSTATE_KEYS}, jnp.int32(s),
                              jnp.asarray(row), jnp.int32(0), jnp.int32(MB), jnp.int32(0), MB)
        rc = {**rc, **rb, "slot_active": rb["slot_active"].at[s].set(True)}
        pb, _ = TP.admit_slot({k: pc[k] for k in TP.BSTATE_KEYS}, s, torch.from_numpy(row),
                              0, MB, 0, MB)
        pb["slot_active"][s] = True
        pc = {**pc, **pb}
    return rc, pc


def test_verify_chunk_paged_matches_reference(models):
    """Two slots, blocks of 4: a prompt piece, then a 4-row verify chunk with
    slot 1 passed through (``valid == 0``), then a verify of 2 valid rows."""
    ref_model, ref_params, model, params = models
    B, cache_len, bs, C = 2, 24, 4, 4
    rc, pc = _admitted_caches(ref_model, model, B, cache_len, bs)
    toks = np.random.default_rng(9).integers(0, 512, (B, 20)).astype(np.int32)
    rl, rc = jax.jit(ref_model.prefill_chunk_paged)(
        ref_params, jnp.asarray(toks[:, :8]), rc, jnp.zeros(B, jnp.int32),
        jnp.asarray([8, 6], jnp.int32))
    pl, pc = model.prefill_chunk_paged(params, torch.from_numpy(toks[:, :8]), pc,
                                       torch.zeros(B, dtype=torch.int32),
                                       torch.tensor([8, 6], dtype=torch.int32), tiles=(8, 24))
    step = jax.jit(ref_model.verify_chunk_paged)
    for valid in ([4, 0], [2, 4]):
        start = pc["lengths"].numpy().copy()
        chunk = np.stack([toks[b, start[b]:start[b] + C] for b in range(B)])
        rl, rc = step(ref_params, jnp.asarray(chunk), rc, jnp.asarray(start),
                      jnp.asarray(valid, jnp.int32))
        pl, pc = model.verify_chunk_paged(params, torch.from_numpy(chunk), pc,
                                          torch.from_numpy(start),
                                          torch.tensor(valid, dtype=torch.int32))
        assert pl.shape == (B, C, 512)
        r = np.asarray(rl.astype(jnp.float32))
        for b in range(B):
            n = valid[b]
            got, want = pl.float().numpy()[b, :n], r[b, :n]
            assert np.abs(got - want).max(initial=0) <= TOL * np.abs(r).max(), (valid, b)
        np.testing.assert_array_equal(pc["lengths"].numpy(), np.asarray(rc["lengths"]))
        for name in ("pk", "pv"):   # the trash block (last) holds garbage
            rp = np.asarray(rc["stack"]["L0"][name].astype(jnp.float32))[:, :-1]
            pp = pc["stack"]["L0"][name].float().numpy()[:, :-1]
            assert np.abs(pp - rp).max() <= TOL * np.abs(rp).max(), (valid, name)


@pytest.mark.parametrize("d_model,heads,d_ff", [(64, 4, 128), (128, 4, 256), (256, 8, 512)])
def test_verify_rows_are_decode_steps_bit_for_bit(d_model, heads, d_ff):
    """8 slots of a 2-layer GLM-4-9B-shaped model prefill 11 tokens through
    one chunk; 5 more tokens go through 5 ``decode_step_paged`` calls on one
    copy and one ``verify_chunk_paged`` on another: logits and pools equal
    bit for bit."""
    cfg = dataclasses.replace(reduced(get_arch("glm4-9b")), d_model=d_model, n_heads=heads,
                              head_dim=d_model // heads, d_ff=d_ff, n_layers=2)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(d_model))
    B, L, C, bs, cache_len = 8, 11, 5, 8, 40
    toks = torch.randint(0, cfg.vocab_size, (B, L + C), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))

    def prefilled():
        c = model.init_paged_cache(B, cache_len, block_size=bs, num_blocks=B * 5)
        bst, _ = TP.alloc_admit({k: c[k] for k in TP.BSTATE_KEYS}, torch.arange(B),
                                torch.full((B,), 5, dtype=torch.int32), 5)
        c.update(bst)
        _, c = model.prefill_chunk_paged(params, toks[:, :L], c, torch.zeros(B, dtype=torch.int32),
                                         torch.full((B,), L, dtype=torch.int32),
                                         tiles=(32, cache_len))
        return c

    dc, dec = prefilled(), []
    for j in range(C):
        lg, dc = model.decode_step_paged(params, toks[:, L + j:L + j + 1], dc)
        dec.append(lg)
    vc = prefilled()
    vl, vc = model.verify_chunk_paged(params, toks[:, L:], vc, vc["lengths"],
                                      torch.full((B,), C, dtype=torch.int32))
    assert torch.equal(vl, torch.stack(dec, dim=1))
    assert torch.equal(vc["lengths"], dc["lengths"])
    for name in ("pk", "pv"):
        assert torch.equal(vc["stack"]["L0"][name][:, :-1], dc["stack"]["L0"][name][:, :-1])
