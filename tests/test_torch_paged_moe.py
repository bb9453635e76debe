"""The MoE family (reduced DeepSeek-V3: one dense-prefix layer and three MoE
layers of 8 experts, top-2, one shared expert) on repro_torch's paged,
chunked, prefix-cached and speculative engines, against the JAX reference
and inside the port, on the CPU.  Inputs are numpy draws from fixed seeds,
carried to the port by ``params_from_jax``.

The model runs at the reference's dropless rule (``_setup_dropless`` of
``tests/test_engine_paged.py``: ``capacity_factor = n_experts``): a chunk
piece and a verify route at full capacity, which equals a one-shot
prefill's or a decode step's routing only where that drops nothing.

Tolerances, and what sets them:

* The paged cache's layout (both groups' pools, the allocator state)
  equals the reference's, shape for shape and dtype for dtype.
* Greedy tokens of each engine mode equal the reference engine's up to
  each request's first step whose top-2 margin is within 2e-2 of the
  logit scale (the bf16 rule of ``tests/test_torch_moe.py``, where bf16
  noise also flips a few routing choices between the frameworks), at least
  ``HELD`` of them; the token and prefix counters equal the reference's.
* Inside the port, exact: each mode's tokens equal the contiguous
  engine's, token for token, with conservation checked after every
  admission and dispatch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import QuantConfig as RefQuantConfig
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.engine import Engine as RefEngine
from repro.models import build_model as ref_build_model
from repro.quantize import quantize as ref_quantize
from repro_torch.compat import params_from_jax
from repro_torch.configs import get_arch, reduced
from repro_torch.engine import Engine
from repro_torch.models import build_model
from repro_torch.models import lm as TL

TOL = 2e-2
HELD = 7        # of the 18 greedy tokens defined across frameworks (7 at these draws)
# the reference's MoE chunked case (tests/test_engine_paged.py): prompt
# lengths, chunk_size, cache_len; numpy seeds for the tokens
LENS, CHUNK, CACHE_LEN = [9, 21, 14], 8, 34
PROMPTS = [np.random.default_rng(80 + i).integers(0, 512, L).astype(np.int32)
           for i, L in enumerate(LENS)]
MODES = {"paged": dict(paged=True), "chunked": dict(paged=True, chunk_size=CHUNK),
         "prefix": dict(paged=True, chunk_size=CHUNK, prefix_cache=True),
         "spec": dict(paged=True, n_spec=2),
         "spec-composed": dict(paged=True, n_spec=2, chunk_size=CHUNK, prefix_cache=True)}


def _dropless(cfg):
    return dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))


@pytest.fixture(scope="module")
def moe():
    """(reference model, its bf16 params, its AbsMax draft, port model, its
    params, the draft brought across), at the dropless capacity."""
    cfg = _dropless(ref_reduced(ref_get_arch("deepseek-v3")))
    shapes = jax.eval_shape(ref_build_model(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(s):
        if len(s.shape) >= 2:
            a = rng.standard_normal(s.shape) * s.shape[-2] ** -0.5
        else:
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        return jnp.asarray(a.astype(np.float32)).astype(s.dtype)
    rp = jax.tree.map(draw, shapes)
    ref_draft, _ = ref_quantize(rp, None, RefQuantConfig(method="absmax", granularity="channel"),
                                mode="storage", out_dtype="bfloat16")
    model = build_model(_dropless(reduced(get_arch("deepseek-v3"))), device="cpu")
    return (ref_build_model(cfg), rp, ref_draft, model, params_from_jax(jax.device_get(rp)),
            params_from_jax(jax.device_get(ref_draft)))


@pytest.fixture(scope="module")
def contiguous(moe):
    """The port's contiguous engine's tokens for ``PROMPTS``, 6 each."""
    model, params = moe[3], moe[4]
    return Engine(model, params, slots=2, cache_len=CACHE_LEN, k_steps=3).serve(
        PROMPTS, gen_tokens=6)


@pytest.fixture(scope="module")
def served(moe):
    """Each mode's serves of ``PROMPTS`` (6 tokens each), once per module:
    ``served(mode)`` -> [(outputs, stats, blocks the index holds after)]
    for one serve, or a cold and a warm one of a prefix-cached engine.  The
    reference comparison and the in-port one read the same serves."""
    model, params, draft = moe[3], moe[4], moe[5]
    done = {}

    def get(mode):
        if mode not in done:
            kw = dict(slots=2, cache_len=CACHE_LEN, k_steps=3, block_size=8,
                      check_invariants=True, **MODES[mode])
            eng = Engine(model, params, draft_params=draft if kw.get("n_spec") else None, **kw)
            done[mode] = [(*eng.serve(PROMPTS, gen_tokens=6, return_stats=True),
                           set(eng._hold_blocks))
                          for _ in range(2 if kw.get("prefix_cache") else 1)]
        return done[mode]

    return get


@pytest.fixture(scope="module")
def held_steps(moe):
    """``_held`` of each (prompt, reference continuation), once per module."""
    model, params = moe[3], moe[4]
    done = {}

    def get(prompt, continuation):
        key = (bytes(prompt), tuple(continuation))
        if key not in done:
            done[key] = _held(model, params, prompt, continuation)
        return done[key]

    return get


def _held(model, params, prompt, continuation) -> int:
    """How many leading greedy steps of ``continuation`` (teacher-forced
    through the port's model) have a top-2 logit gap above ``TOL`` of
    max|logit|: the tokens defined across frameworks."""
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None]})
    for n, tok in enumerate(continuation):
        lf = logits.float()[0]
        top = torch.topk(lf, 2).values
        if float(top[0] - top[1]) <= TOL * float(lf.abs().max()):
            return n
        logits, cache = model.decode_step(params, torch.tensor([[tok]], dtype=torch.int32),
                                          cache)
    return len(continuation)


def test_paged_cache_layout_matches_reference(moe):
    """Block pools for the dense prefix's and the MoE stack's attention
    layers, one block table: the reference's leaves, shapes and dtypes."""
    ref_model, model = moe[0], moe[3]
    ref = jax.eval_shape(lambda: ref_model.init_paged_cache(3, 40, block_size=8,
                                                            num_blocks=12))
    port = model.init_paged_cache(3, 40, block_size=8, num_blocks=12)
    flat = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_leaves_with_path(ref)}
    pflat = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype).replace("torch.", ""))
             for p, v in jax.tree_util.tree_leaves_with_path(port)}
    assert pflat == flat
    assert pflat["['prefix']['L0']['pk']"][0] == (1, 13, 8, 2, 16)
    assert pflat["['stack']['L0']['pk']"][0] == (3, 13, 8, 2, 16)


def test_cow_copy_blocks_copies_every_attention_pool(moe):
    """A speculative round's copy-on-write lands in both groups' pools."""
    model = moe[3]
    cache = model.init_paged_cache(2, 40, block_size=8, num_blocks=6)
    for grp in ("prefix", "stack"):
        for name in ("pk", "pv"):
            leaf = cache[grp]["L0"][name]
            leaf.copy_(torch.randn(leaf.shape).to(leaf.dtype))
    before = {(g, n): cache[g]["L0"][n].clone() for g in ("prefix", "stack")
              for n in ("pk", "pv")}
    TL.cow_copy_blocks(cache, torch.tensor([2, 6]), torch.tensor([4, 6]))
    for (g, n), old in before.items():
        new = cache[g]["L0"][n]
        assert torch.equal(new[:, 4], old[:, 2]), (g, n)
        keep = [b for b in range(7) if b != 4]
        assert torch.equal(new[:, keep], old[:, keep]), (g, n)


# against the reference, the chunked, prefix-cached engine and the
# speculative one; the one-shot paged and the composed engines meet the
# reference through the contiguous engine (each == it inside the port,
# ``test_engine_modes_equal_contiguous``, which matches the reference's).
# Each reference engine compiles for seconds.
@pytest.mark.parametrize("mode", ["prefix", "spec"])
def test_engine_modes_match_reference_engine(moe, served, held_steps, mode):
    """Each paged engine mode's greedy tokens equal the reference engine's
    (the same mode, its AbsMax draft for speculation) up to each request's
    first step whose margin is within the bf16 rule; a prefix-cached engine
    serves twice, and its warm serve's prefix hits, prompt tokens prefilled
    and copies equal the reference's, with hits."""
    ref_model, rp, ref_draft = moe[:3]
    kw = dict(slots=2, cache_len=CACHE_LEN, k_steps=3, block_size=8, **MODES[mode])
    spec = kw.get("n_spec")
    ref_eng = RefEngine(ref_model, rp, draft_params=ref_draft if spec else None, **kw)
    held = 0
    for run, (outs, stats, _) in zip(("cold", "warm"), served(mode)):
        ref_out, rs = ref_eng.serve([jnp.asarray(p) for p in PROMPTS], gen_tokens=6,
                                    return_stats=True)
        for p, out, ref in zip(PROMPTS, outs, ref_out):
            ref = list(map(int, ref))
            n = held_steps(p, ref)
            assert out[:n] == ref[:n], run
            held += n if run == "cold" else 0
        assert stats["counters"]["tokens"] == rs["counters"]["tokens"]
        if kw.get("prefix_cache"):
            for k in ("prefix_hits", "prefill_tokens"):
                assert stats[k] == rs[k], (run, k)
            assert stats["counters"]["cow_copies"] == rs["counters"]["cow_copies"]
    if kw.get("prefix_cache"):
        assert stats["prefix_hits"] > 0
    assert held >= HELD, held


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_modes_equal_contiguous(contiguous, served, mode):
    """Inside the port every mode's tokens equal the contiguous engine's,
    token for token: paged, chunked (== one-shot), prefix-cached cold and
    warm (warm == cold, with hits and fewer prompt tokens prefilled), and
    speculative (== non-speculative; drafted == accepted + rejected, some
    accepted)."""
    kw = MODES[mode]
    runs = []
    for outs, stats, _ in served(mode):
        assert outs == contiguous
        runs.append(stats)
    if kw.get("prefix_cache"):
        cold, warm = runs
        assert warm["prefix_hits"] == warm["counters"]["prefix_hit_tokens"] > 0
        assert warm["prefill_tokens"] < cold["prefill_tokens"] == sum(LENS)
    if kw.get("n_spec"):
        c = stats["counters"]
        assert c["drafted"] == c["accepted"] + c["rejected"] and 0 < c["accepted"]


def test_speculation_needs_dropless_routing(moe):
    """Below ``capacity_factor = n_experts / top_k`` a decode step can drop
    an assignment the full-capacity verify keeps: both engines refuse, with
    one message; at that factor both take the configuration."""
    ref_model, rp, _, model, params, draft = moe
    kw = dict(slots=2, cache_len=CACHE_LEN, k_steps=3, paged=True, block_size=8, n_spec=2)
    cfg = model.cfg
    msgs = []
    for eng, c, bm, p in ((RefEngine, ref_model.cfg, ref_build_model, rp),
                          (Engine, cfg, lambda c: build_model(c, device="cpu"), params)):
        below = dataclasses.replace(c, capacity_factor=c.n_experts / c.top_k - 0.5)
        with pytest.raises(ValueError, match="routes MoE dropless") as e:
            eng(bm(below), p, draft_params=p, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "capacity_factor 3.5 * top_k 2 < n_experts 8" in msgs[1]
    for eng, c, bm, p in ((RefEngine, ref_model.cfg, ref_build_model, rp),
                          (Engine, cfg, lambda c: build_model(c, device="cpu"), params)):
        least = dataclasses.replace(c, capacity_factor=c.n_experts / c.top_k)
        assert eng(bm(least), p, draft_params=p, **kw).cfg.n_spec == 2
