"""repro_torch.engine (contiguous path) vs repro.engine on the reduced
GLM-4-9B: greedy token streams, dispatch accounting, and the sampler.

Greedy equality across frameworks is only defined where the argmax is not
within the logits' cross-framework tolerance of a tie: logits agree to
2e-2 * max|logit| (tests/test_torch_model.py), so the test first replays
every emitted token through the port's model and asserts that its top-2
margin exceeds that tolerance, then asserts the token streams are equal.
The prompts were drawn from fixed numpy seeds that satisfy the margin.
Sampler distributions: rtol 1e-5 on probabilities; frequencies within 5
binomial standard deviations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.engine import Engine as RefEngine
from repro.engine import SamplingParams as RefSP
from repro.engine import probs as ref_probs
from repro.models import build_model as ref_build_model
from repro_torch.compat import params_from_jax
from repro_torch.configs import QuantConfig, get_arch, reduced
from repro_torch.engine import Engine, SamplingParams, probs, sample
from repro_torch.models import build_model
from repro_torch.quantize import quantize

TOL = 2e-2
PROMPTS = [(0, 10), (1, 7), (3, 9), (4, 10)]    # (numpy seed, length)


def _prompt(seed, length, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, length).astype(np.int32)


@pytest.fixture(scope="module")
def setup():
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
    params = params_from_jax(jax.device_get(ref_params))
    return ref_model, ref_params, model, params, [_prompt(s, L) for s, L in PROMPTS]


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


@pytest.mark.parametrize("quantized", [False, True])
def test_greedy_serve_matches_reference_engine(setup, quantized):
    """Unequal prompt lengths (one right-padded prefill per admission), more
    requests than slots (refills through the partial-pool scatter)."""
    ref_model, ref_params, model, params, prompts = setup
    if quantized:
        from repro.quantize import quantize as ref_quantize
        from repro.configs import QuantConfig as RefQuantConfig
        rq, _ = ref_quantize(ref_params, None, RefQuantConfig(use_fused_kernel=True,
                                                              block_size=32),
                             mode="storage", out_dtype="bfloat16")
        ref_params = rq
        params, _ = quantize(params, None, QuantConfig(use_fused_kernel=True, block_size=32),
                             mode="storage", out_dtype="bfloat16")
    ref_out = RefEngine(ref_model, ref_params, slots=2, cache_len=24, k_steps=3).serve(
        [jnp.asarray(p) for p in prompts], gen_tokens=5)
    for p, out in zip(prompts, ref_out):
        assert _min_margin(model, params, p, out) > TOL
    eng = Engine(model, params, slots=2, cache_len=24, k_steps=3)
    outs, stats = eng.serve(prompts, gen_tokens=5, return_stats=True)
    assert outs == [list(map(int, o)) for o in ref_out]
    assert stats["dispatches"] * 3 == stats["decode_steps"]
    assert stats["host_syncs"] == stats["dispatches"] + stats["prefill_calls"]
    assert stats["tokens"] == 5 * len(prompts)
    assert stats["counters"]["tokens"] == 4 * len(prompts)   # first tokens: prefill


def test_full_pool_refill_and_single_token_requests(setup):
    ref_model, ref_params, model, params, _ = setup
    same = [_prompt(0, 7), _prompt(1, 7)]
    ref_out = RefEngine(ref_model, ref_params, slots=2, cache_len=16, k_steps=4).serve(
        [jnp.asarray(p) for p in same], gen_tokens=3)
    for p, out in zip(same, ref_out):
        assert _min_margin(model, params, p, out) > TOL
    eng = Engine(model, params, slots=2, cache_len=16, k_steps=4)
    assert eng.serve(same, gen_tokens=3) == [list(map(int, o)) for o in ref_out]
    outs, stats = eng.serve(same, gen_tokens=1, return_stats=True)
    assert [len(o) for o in outs] == [1, 1] and stats["dispatches"] == 0
    assert eng.serve([], gen_tokens=4) == []
    with pytest.raises(ValueError):
        Engine(model, params, k_steps=0)


@pytest.mark.parametrize("kw", [dict(greedy=False, temperature=0.7),
                                dict(greedy=False, top_k=5),
                                dict(greedy=False, temperature=1.3, top_p=0.8)])
def test_sampling_distribution_matches_reference(kw):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 40)) * 2).astype(np.float32)
    p_ref = np.asarray(ref_probs(jnp.asarray(logits), RefSP(**kw)))
    sp = SamplingParams(**kw)
    p_port = probs(torch.from_numpy(logits), sp).numpy()
    np.testing.assert_allclose(p_port, p_ref, rtol=1e-5, atol=1e-7)
    gen = torch.Generator().manual_seed(0)
    n = 4000
    draws = sample(torch.from_numpy(logits).expand(n, 3, 40), gen, sp).numpy()
    for row in range(3):
        freq = np.bincount(draws[:, row], minlength=40) / n
        sd = np.sqrt(p_port[row] * (1 - p_port[row]) / n)
        assert np.all(np.abs(freq - p_port[row]) <= 5 * sd + 1e-9)
        assert np.all(freq[p_port[row] == 0] == 0)
