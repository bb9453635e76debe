"""repro_torch's speculative engine against repro's, and against the port's
own non-speculative paged engine, on the CPU (reduced GLM-4-9B, d_model 64).

* Against ``repro``: the speculative paged engine and the composed one
  (speculation, prefix cache, chunked prefill; cold then warm) give
  ``repro``'s greedy tokens where every token's top-2 margin exceeds 2e-2
  of the logit scale (the rule of ``tests/test_torch_engine.py``; the
  draft trees are ``repro``'s, brought across by ``compat.params_from_jax``),
  and the token and prefix counters equal ``repro``'s.
* Inside the port, token for token (exact, ``PERF.md`` decision a) with
  ``check_invariants=True`` (conservation and ``drafted == accepted +
  rejected`` after every admission and dispatch), the non-speculative
  paged engine's output for: the DAQ, AbsMax and wrong-seed drafts with
  dynamic and pinned depth; the composed engine with those drafts at two
  chunk sizes, cold and warm (a warm partial hit copies the speculative
  span's first block); the budget clamp (``gen_tokens`` 1, 2, 4 at
  ``n_spec = 3``); a pool sized to the reservation bound with the
  ``n_spec`` slack; and random workloads of ``tests/test_engine_spec.py``'s
  stress sweeps (hypothesis, derandomized).
* Sampled speculation is deterministic under a seed and gives full budgets
  of in-range tokens; the engine's validation errors are the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import QuantConfig as RefQuantConfig
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.engine import Engine as RefEngine
from repro.models import build_model as ref_build_model
from repro.quantize import quantize as ref_quantize
from repro_torch.compat import params_from_jax
from repro_torch.configs import QuantConfig, get_arch, reduced
from repro_torch.engine import Engine, SamplingParams, blocks_for
from repro_torch.models import build_model
from repro_torch.quantize import quantize

TOL = 2e-2


def _prompt(seed, length, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, length).astype(np.int32)


@pytest.fixture(scope="module")
def setup():
    """The reduced GLM-4-9B in both frameworks with one set of bf16 weights
    (numpy-drawn), and three draft trees for the port: ``absmax`` (the
    reference's channel-granularity AbsMax tree, brought across), ``daq``
    (the port's DAQ quantize against a base 1 % away, block 32) and ``bad``
    (a wrong-seed tree: it agrees with the verifier about nothing)."""
    cfg = ref_reduced(ref_get_arch("glm4-9b"))
    ref_model = ref_build_model(cfg)
    shapes = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(s):
        if len(s.shape) >= 2:
            return rng.standard_normal(s.shape) * s.shape[-2] ** -0.5
        return 1.0 + 0.1 * rng.standard_normal(s.shape)

    def tree(shapes):
        return jax.tree_util.tree_map(
            lambda s: jnp.asarray(draw(s).astype(np.float32)).astype(jnp.bfloat16), shapes)

    ref_params = tree(shapes)
    ref_draft, _ = ref_quantize(ref_params, None,
                                RefQuantConfig(method="absmax", granularity="channel"),
                                mode="storage", out_dtype="bfloat16")
    model = build_model(reduced(get_arch("glm4-9b")), device="cpu")
    params = params_from_jax(jax.device_get(ref_params))
    base = params_from_jax(jax.device_get(jax.tree_util.tree_map(
        lambda p: (p.astype(jnp.float32) * (1 + 0.01 * jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32)))).astype(p.dtype), ref_params)))
    daq, _ = quantize(params, base, QuantConfig(block_size=32), mode="storage",
                      out_dtype="bfloat16")
    drafts = {"absmax": params_from_jax(jax.device_get(ref_draft)), "daq": daq,
              "bad": params_from_jax(jax.device_get(tree(shapes)))}
    return ref_model, ref_params, ref_draft, model, params, drafts


@pytest.fixture(scope="module")
def baseline(setup):
    """The non-speculative engine's outputs for one configuration, served
    once per module: ``baseline(prompts, gen, serves=1, **engine_kw)``
    returns one output list per serve of a single engine (a second serve
    of a prefix-cached engine is warm)."""
    model, params = setup[3], setup[4]
    done = {}

    def get(prompts, gen, serves=1, **kw):
        key = (tuple(map(bytes, prompts)), gen, serves, tuple(sorted(kw.items())))
        if key not in done:
            eng = Engine(model, params, **kw)
            done[key] = [eng.serve(prompts, gen_tokens=gen) for _ in range(serves)]
        return done[key]

    return get


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


PROMPTS = [_prompt(s, L) for s, L in ((0, 10), (1, 25), (3, 6), (4, 17))]


def _shared_prompts():
    """A 16-token system prompt (two blocks of 8) with three suffixes, then
    a prefix of the second cut mid-block: a partial hit once the second is
    cached, so the first speculative span of that request starts in a
    shared block and copies it."""
    sysp = _prompt(14, 16)
    prompts = [np.concatenate([sysp, _prompt(142 + i, n)]) for i, n in enumerate((2, 9, 5))]
    return prompts + [prompts[1][:20]]


def _spec_stats_ok(stats):
    c = stats["counters"]
    assert c["drafted"] == c["accepted"] + c["rejected"] == stats["draft_tokens"]
    assert c["accepted"] == stats["draft_accepted"]
    assert stats["spec_rounds"] == stats["decode_steps"]


# ---------------------------------------------------------------------------
# Against the reference engine
# ---------------------------------------------------------------------------

def test_spec_serve_matches_reference_engine(setup):
    """Four prompts through two slots (refills), blocks of 8, ``n_spec=2``."""
    ref_model, ref_params, ref_draft, model, params, drafts = setup
    kw = dict(slots=2, cache_len=40, k_steps=3, paged=True, block_size=8, n_spec=2)
    ref_out, rs = RefEngine(ref_model, ref_params, draft_params=ref_draft, **kw).serve(
        [jnp.asarray(p) for p in PROMPTS], gen_tokens=6, return_stats=True)
    ref_out = [list(map(int, o)) for o in ref_out]
    for p, out in zip(PROMPTS, ref_out):
        assert _min_margin(model, params, p, out) > TOL
    outs, stats = Engine(model, params, draft_params=drafts["absmax"], check_invariants=True,
                         **kw).serve(PROMPTS, gen_tokens=6, return_stats=True)
    assert outs == ref_out
    _spec_stats_ok(stats)
    assert stats["counters"]["tokens"] == rs["counters"]["tokens"] == 5 * len(PROMPTS)
    assert 0 < stats["draft_accepted"] <= stats["draft_tokens"]


def test_composed_spec_serve_matches_reference_engine(setup):
    """Speculation, prefix cache and chunked prefill together, cold then
    warm in one engine each: tokens, prefix hits, prompt tokens prefilled,
    copies and chunk pieces equal to ``repro``'s."""
    ref_model, ref_params, ref_draft, model, params, drafts = setup
    prompts = _shared_prompts()
    kw = dict(slots=2, cache_len=40, k_steps=3, paged=True, block_size=8, chunk_size=8,
              prefix_cache=True, n_spec=2)
    ref_eng = RefEngine(ref_model, ref_params, draft_params=ref_draft, **kw)
    eng = Engine(model, params, draft_params=drafts["absmax"], check_invariants=True, **kw)
    for run in ("cold", "warm"):
        ref_out, rs = ref_eng.serve([jnp.asarray(p) for p in prompts], gen_tokens=5,
                                    return_stats=True)
        ref_out = [list(map(int, o)) for o in ref_out]
        if run == "cold":
            for p, out in zip(prompts, ref_out):
                assert _min_margin(model, params, p, out) > TOL
        outs, stats = eng.serve(prompts, gen_tokens=5, return_stats=True)
        assert outs == ref_out, run
        _spec_stats_ok(stats)
        for k in ("tokens", "prefix_hit_tokens", "chunks_completed", "cow_copies"):
            assert stats["counters"][k] == rs["counters"][k], (run, k)
        for k in ("prefix_hits", "prefill_tokens", "prefill_calls"):
            assert stats[k] == rs[k], (run, k)
    assert stats["prefix_hits"] > 0 and stats["counters"]["cow_copies"] >= 1


# ---------------------------------------------------------------------------
# Exactness inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", ["daq", "absmax", "bad"])
@pytest.mark.parametrize("dynamic", [True, False])
def test_spec_equals_non_spec_paged(setup, baseline, draft, dynamic):
    """``tests/test_engine_spec.py::test_spec_token_exact_matrix`` (dense)
    and ``test_spec_exact_for_any_draft_even_garbage``: every draft, the
    depth dynamic and pinned."""
    _, _, _, model, params, drafts = setup
    kw = dict(slots=2, cache_len=40, k_steps=4, paged=True, block_size=8)
    base = baseline(PROMPTS, 7, **kw)[0]
    outs, stats = Engine(model, params, n_spec=3, draft_params=drafts[draft],
                         spec_dynamic=dynamic, check_invariants=True, **kw).serve(
        PROMPTS, gen_tokens=7, return_stats=True)
    assert outs == base
    _spec_stats_ok(stats)
    rate = stats["draft_accepted"] / stats["draft_tokens"]
    if draft == "bad":
        assert rate < 0.25
        assert stats["spec_depth"] == (1 if dynamic else 3)
    else:
        assert rate > 0.5


@pytest.mark.parametrize("draft", ["daq", "bad"])
@pytest.mark.parametrize("chunk", [8, 12])
def test_composed_spec_equals_non_spec(setup, baseline, draft, chunk):
    """``test_spec_composed_token_exact_matrix``,
    ``test_spec_composed_exact_for_garbage_draft`` and
    ``test_spec_composed_warm_prefix_hit_mid_speculation``: the composed
    engine served twice equals the non-speculative prefix engine served
    twice; the warm pass hits more, and its partial hit copies on write."""
    _, _, _, model, params, drafts = setup
    prompts = _shared_prompts()
    kw = dict(slots=2, cache_len=40, k_steps=4, paged=True, block_size=8, chunk_size=chunk,
              prefix_cache=True)
    want = baseline(prompts, 6, serves=2, **kw)
    eng = Engine(model, params, n_spec=2, draft_params=drafts[draft], check_invariants=True,
                 **kw)
    got = [eng.serve(prompts, gen_tokens=6, return_stats=True) for _ in range(2)]
    assert [o for o, _ in got] == want
    (_, s1), (_, s2) = got
    for s in (s1, s2):
        _spec_stats_ok(s)
        assert s["counters"]["prefix_hit_tokens"] == s["prefix_hits"]
    assert s2["prefix_hits"] > s1["prefix_hits"] and s2["counters"]["cow_copies"] >= 1
    if draft == "bad":
        assert s2["draft_accepted"] < s2["draft_tokens"] // 4


@pytest.mark.parametrize("gen", [1, 2, 4])
def test_spec_budget_clamp_edges(setup, gen):
    """A round can accept past the remaining budget; emission is clamped
    without changing values (``n_spec=3`` > the budget at gen 2)."""
    _, _, _, model, params, drafts = setup
    kw = dict(slots=2, cache_len=32, k_steps=5, paged=True, block_size=8)
    base = Engine(model, params, **kw).serve(PROMPTS[:1] + PROMPTS[2:], gen_tokens=gen)
    outs = Engine(model, params, n_spec=3, draft_params=drafts["daq"], check_invariants=True,
                  **kw).serve(PROMPTS[:1] + PROMPTS[2:], gen_tokens=gen)
    assert outs == base and [len(o) for o in outs] == [gen] * 3


def test_spec_tight_pool_with_reservation_slack(setup):
    """A pool of exactly one request's worst case with the ``n_spec`` rows
    of speculative overshoot serializes the requests and stays exact."""
    _, _, _, model, params, drafts = setup
    prompts = [_prompt(60 + i, 20) for i in range(4)]
    kw = dict(slots=2, cache_len=32, k_steps=4, paged=True, block_size=8)
    base = Engine(model, params, **kw).serve(prompts, gen_tokens=5)
    need = blocks_for(20 + 5 - 1 + 2, 8)
    assert need > blocks_for(20 + 5 - 1, 8)
    outs, stats = Engine(model, params, num_blocks=need, n_spec=2, draft_params=drafts["daq"],
                         check_invariants=True, **kw).serve(prompts, gen_tokens=5,
                                                            return_stats=True)
    assert outs == base and stats["prefill_calls"] == 4


def test_spec_sampled_mode_deterministic_and_complete(setup):
    _, _, _, model, params, drafts = setup
    sp = SamplingParams(greedy=False, temperature=0.9, top_k=40, top_p=0.9)
    for kw in (dict(), dict(chunk_size=8, prefix_cache=True)):
        # a fresh engine each time: a warm prefix cache runs fewer chunk
        # pieces, so it draws another stream
        o1, o2 = (Engine(model, params, slots=2, cache_len=40, k_steps=4, paged=True,
                         block_size=8, n_spec=2, draft_params=drafts["daq"], sampling=sp,
                         check_invariants=True, **kw).serve(PROMPTS[:3], gen_tokens=6, seed=7)
                  for _ in range(2))
        assert o1 == o2 and [len(o) for o in o1] == [6, 6, 6]
        assert all(0 <= t < 512 for o in o1 for t in o)


@pytest.mark.parametrize("composed", [False, True])
@pytest.mark.parametrize("draft", ["daq", "bad"])
@settings(database=None, derandomize=True, max_examples=2, deadline=None)
@given(st.integers(min_value=0, max_value=10**6))
def test_spec_stress_randomized(setup, composed, draft, seed):
    """``tests/test_engine_spec.py``'s two stress sweeps: random prompt
    lengths, request counts, budgets, depth and pool tightness (down to the
    reservation bound), a close and a hostile draft, plain or composed with
    the prefix cache and chunked prefill over shared-prefix prompts;
    output equals the matching non-speculative engine's, and the counters
    balance."""
    _, _, _, model, params, drafts = setup
    rng = np.random.RandomState(seed)
    slots = 2
    n_req = int(rng.randint(slots, slots + 3))
    share = 8 * int(rng.randint(0, 3)) if composed else 0
    pre = _prompt(seed % 997, share)
    lens = [int(rng.randint(share + 2, 29)) for _ in range(n_req)]
    prompts = [np.concatenate([pre, _prompt(seed % 991 + i, L - share)])
               for i, L in enumerate(lens)]
    if composed:
        prompts.append(prompts[0])
    gen = int(rng.randint(2, 7))
    k_steps = int(rng.randint(2, 4))
    n_spec = int(rng.randint(1, k_steps))
    cache_len = max(lens) + gen + int(rng.randint(0, 6))
    kw = dict(slots=slots, cache_len=cache_len, k_steps=k_steps, paged=True, block_size=8)
    if composed:
        kw.update(chunk_size=8 * int(rng.randint(1, 3)), prefix_cache=True)
    base = Engine(model, params, **kw).serve(prompts, gen_tokens=gen)
    mb = blocks_for(cache_len, 8)
    lo = max(min(blocks_for(L + gen - 1 + n_spec, 8), mb) for L in lens) + composed
    eng = Engine(model, params, num_blocks=int(rng.randint(lo, slots * mb + 1)), n_spec=n_spec,
                 draft_params=drafts[draft], check_invariants=True, **kw)
    outs, stats = eng.serve(prompts, gen_tokens=gen, return_stats=True)
    assert outs == base
    _spec_stats_ok(stats)
    c = stats["counters"]
    assert c["blocks_popped"] - c["blocks_released"] == len(eng._hold_blocks)


def test_spec_config_validation(setup):
    _, _, _, model, params, drafts = setup
    d = drafts["daq"]
    with pytest.raises(ValueError, match="paged"):
        Engine(model, params, slots=2, cache_len=32, n_spec=2, draft_params=d)
    with pytest.raises(ValueError, match="n_spec must be < k_steps"):
        Engine(model, params, slots=2, cache_len=32, paged=True, block_size=8, k_steps=2,
               n_spec=2, draft_params=d)
    with pytest.raises(ValueError, match="draft_params"):
        Engine(model, params, slots=2, cache_len=32, paged=True, block_size=8, n_spec=2)
    with pytest.raises(ValueError, match="draft_params without n_spec"):
        Engine(model, params, slots=2, cache_len=32, paged=True, block_size=8,
               draft_params=d)
