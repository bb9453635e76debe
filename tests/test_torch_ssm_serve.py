"""Quantize and serve of the Mamba-2 (SSM) family vs the JAX reference on the
CPU: DAQ quantize of an SSM tree, then the contiguous engine's per-length
prefill groups, greedy tokens against the reference engine and the port's
host loop, the dense family's one padded call, and the paged engine modes
(the contiguous engine's tokens, or the reference's refusals).  Inputs are numpy draws from fixed seeds, carried to the
port by ``params_from_jax``.

Tolerances.  ``quantize()`` of a float32 SSM tree whose ``in_dt`` is quantized and
ragged: alphas, codes and scales bit-equal (a fine-grid alpha may sit one
ulp off, ROADMAP Queue C 4: that layer's scales to rtol 1e-6, its codes to
a mismatch fraction < 1e-4).  At blocks of 32 every leaf has more than
one block; on a grid of one block the reference's compiled scale is
``alpha * (amax * (1/448))``, an ulp from the port's (Queue C 22,
``test_single_block_scale_association``).

Greedy tokens are compared where they are defined across frameworks: the
reduced bf16 model's logits agree to 2e-2 of their scale
(``tests/test_torch_ssm.py``), so every emitted token is first replayed
through the port's model and its top-2 margin asserted above that (the
prompts are fixed numpy draws that satisfy it).  Inside the port the engine
and ``serve_host_loop`` run the same batch-1 and per-length prefills, so
their tokens are held equal outright.  Every prompt crosses the reduced
config's ``ssm_chunk`` of 32 and ends in a ragged chunk.
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
from repro_torch.configs import QuantConfig, get_arch, reduced
from repro_torch.core.policy import tree_leaves_with_path
from repro_torch.engine import Engine, serve_host_loop
from repro_torch.models import build_model
from repro_torch.quant_runtime.qparams import QuantizedTensor
from repro_torch.quantize import quantize

TOL = 2e-2
# (numpy seed, length): three distinct lengths, one repeated
PROMPTS = [(6, 33), (47, 40), (18, 45), (51, 40)]
LENS = [L for _, L in PROMPTS]


def _prompt(seed, length, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, length).astype(np.int32)


def _draw(rng, path, s):
    """A seeded value for one leaf: fan-in scaled matrices, conv taps, and
    the SSM time constants away from their inits so they matter."""
    name = jax.tree_util.keystr(path)
    if "a_log" in name:
        return 0.5 * rng.standard_normal(s.shape)
    if "dt_bias" in name:
        return -1.0 + 0.5 * rng.standard_normal(s.shape)
    if len(s.shape) >= 2:
        return rng.standard_normal(s.shape) * (0.3 if "conv" in name else s.shape[-2] ** -0.5)
    return 1.0 + 0.1 * rng.standard_normal(s.shape)


def _ref_params(cfg, seed):
    shapes = jax.eval_shape(ref_build_model(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(_draw(rng, p, s).astype(np.float32)).astype(s.dtype), shapes)


@pytest.fixture(scope="module")
def ssm():
    """(reference model, its bf16 params, port model, its params)."""
    cfg = ref_reduced(ref_get_arch("mamba2-780m"))
    ref_params = _ref_params(cfg, 0)
    model = build_model(reduced(get_arch("mamba2-780m")), device="cpu")
    return ref_build_model(cfg), ref_params, model, params_from_jax(jax.device_get(ref_params))


def _min_margin(model, params, prompt, continuation) -> float:
    """Smallest top-2 logit gap / max|logit| over the greedy steps that
    produced ``continuation`` (teacher-forced through the port's model)."""
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None]})
    worst = np.inf
    for tok in continuation:
        lf = logits.float()[0]
        top = torch.topk(lf, 2).values
        worst = min(worst, float((top[0] - top[1]) / lf.abs().max()))
        logits, cache = model.decode_step(params, torch.tensor([[tok]], dtype=torch.int32),
                                          cache)
    return worst


def test_ssm_admission_prefills_one_call_per_length(ssm):
    """Four prompts of three lengths admitted at once: three prefill calls,
    tokens equal to the reference engine's and to the host loop's."""
    ref_model, ref_params, model, params = ssm
    prompts = [_prompt(s, L) for s, L in PROMPTS]
    eng = Engine(model, params, slots=4, cache_len=64, k_steps=3)
    assert not eng._can_pad and eng._prefill_groups(LENS) == [[0], [1, 3], [2]]
    outs, stats = eng.serve(prompts, gen_tokens=6, return_stats=True)
    assert stats["prefill_calls"] == 3 and stats["host_syncs"] == 3 + stats["dispatches"]
    assert stats["tokens"] == 24 and stats["counters"]["tokens"] == 20
    h = model.cfg
    assert stats["cache_bytes"] == h.n_layers * 4 * (
        4 * h.n_ssm_heads * h.ssm_head_dim * h.ssm_state
        + 2 * (h.conv_kernel - 1) * (h.resolved_d_inner + 2 * h.ssm_state)) + 4 * 4
    assert outs == serve_host_loop(model, params, prompts, batch=4, gen_tokens=6, cache_len=64)
    ref_out = RefEngine(ref_model, ref_params, slots=4, cache_len=64, k_steps=3).serve(
        [jnp.asarray(p) for p in prompts], gen_tokens=6)
    for p, out in zip(prompts, ref_out):
        assert _min_margin(model, params, p, out) > TOL
    assert outs == [list(map(int, o)) for o in ref_out]


def test_ssm_refills_and_whole_pool_groups_equal_host_loop(ssm):
    """More requests than slots: a first admission of one length fills the
    whole pool in one call (its cache becomes the live one), later ones
    scatter single slots; tokens equal the host loop's."""
    _, _, model, params = ssm
    prompts = [_prompt(10 + i, L) for i, L in enumerate([40, 40, 33, 45, 33])]
    eng = Engine(model, params, slots=2, cache_len=64, k_steps=2)
    outs, stats = eng.serve(prompts, gen_tokens=4, return_stats=True)
    assert outs == serve_host_loop(model, params, prompts, batch=2, gen_tokens=4, cache_len=64)
    assert stats["prefill_calls"] >= 4 and all(len(o) == 4 for o in outs)


def test_dense_admission_still_pads_into_one_call():
    model = build_model(reduced(get_arch("glm4-9b")), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    eng = Engine(model, params, slots=4, cache_len=64, k_steps=3)
    assert eng._can_pad and eng._prefill_groups(LENS) == [[0, 1, 2, 3]]
    _, stats = eng.serve([_prompt(s, L) for s, L in PROMPTS], gen_tokens=3,
                         return_stats=True)
    assert stats["prefill_calls"] == 1


@pytest.fixture(scope="module")
def contiguous(ssm):
    """The contiguous engine's tokens for ``PROMPTS``, 4 each."""
    model, params = ssm[2], ssm[3]
    return Engine(model, params, slots=2, cache_len=64, k_steps=4).serve(
        [_prompt(s, L) for s, L in PROMPTS], gen_tokens=4)


@pytest.mark.parametrize("kw", [dict(paged=True), dict(paged=True, chunk_size=16),
                                dict(paged=True, prefix_cache=True),
                                dict(paged=True, n_spec=2), dict(chunk_size=16)],
                         ids=["paged", "chunked", "prefix", "spec", "chunk-alone"])
def test_ssm_refuses_the_paged_engines(ssm, contiguous, kw):
    """Each engine mode serves the SSM stack with the contiguous engine's
    tokens, or refuses with the reference engine's message the settings its
    rules refuse: a ``chunk_size`` off the ``ssm_chunk`` grid (16; the
    chunked case then serves at 32) and a chunk size without the paged
    engine."""
    ref_model, rp, model, params = ssm
    prompts = [_prompt(s, L) for s, L in PROMPTS]
    extra = {"draft_params": params} if kw.get("n_spec") else {}
    base = dict(slots=2, cache_len=64, k_steps=4)
    if kw.get("chunk_size") == 16:
        msgs = []
        for eng, m, p in ((RefEngine, ref_model, rp), (Engine, model, params)):
            with pytest.raises(ValueError, match="need paged|multiple of ssm_chunk") as e:
                eng(m, p, **base, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        if not kw.get("paged"):
            return
        kw = {**kw, "chunk_size": model.cfg.ssm_chunk}
    outs, stats = Engine(model, params, check_invariants=True, **base, **kw, **extra).serve(
        prompts, gen_tokens=4, return_stats=True)
    assert outs == contiguous
    if kw.get("prefix_cache"):
        assert stats["prefix_hits"] == 0 and stats["prefill_tokens"] == sum(LENS)


# ---------------------------------------------------------------------------
# Quantize
# ---------------------------------------------------------------------------

def test_quantize_ssm_tree_matches_reference():
    """DAQ storage quantize (blocks of 32) of a float32 SSM
    tree with 16 heads, so ``in_dt`` [64, 16] is quantized and ragged.  The
    policy skips the conv taps, ``a_log``, the norms and the 1-D
    ``dt_bias`` / ``d_skip``; the embedding is quantized (ROADMAP Queue
    C 6)."""
    cfg = dataclasses.replace(ref_reduced(ref_get_arch("mamba2-780m")), dtype="float32",
                              d_inner=256, n_layers=2)
    assert cfg.n_ssm_heads == 16
    ref_post = _ref_params(cfg, 8)
    rng = np.random.default_rng(9)
    ref_base = jax.tree.map(lambda a: a + jnp.asarray(
        (rng.standard_normal(a.shape) * 0.01 * float(jnp.std(a))).astype(np.float32))
        if a.ndim >= 2 else a, ref_post)
    post, base = (params_from_jax(jax.device_get(t)) for t in (ref_post, ref_base))
    for name in ("a_log", "dt_bias", "d_skip"):
        leaf = post["stack"]["L0"]["mamba"][name]
        assert leaf.dtype == torch.float32 and leaf.shape == (2, 16)
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref_post["stack"]["L0"]["mamba"][name]))
    # the port's fused search (its card path; on the CPU the sweep's plain
    # version) against the reference's plain Algorithm 1: both stages keep
    # the incumbent on ties and argmax integer sign counts, so the two pick
    # the same alphas by construction (tests/test_torch_quantize.py holds
    # the two fused searches), and the reference's plain search compiles in
    # a third of the time of its interpreted Pallas sweep
    qt, rep = quantize(post, base, QuantConfig(use_fused_kernel=True, block_size=32),
                       mode="storage")
    rqt, rrep = ref_quantize(ref_post, ref_base, RefQuantConfig(block_size=32),
                             mode="storage")
    assert (rep.n_quantized, rep.n_skipped, rep.quantized_bytes, rep.original_bytes) == \
        (rrep.n_quantized, rrep.n_skipped, rrep.quantized_bytes, rrep.original_bytes)
    assert sorted(rep.per_leaf) == sorted(rrep.per_leaf) == [
        "embed/embed", "embed/w_head", *(f"stack/L0/mamba/{n}" for n in
                                         ("in_bc", "in_dt", "in_x", "in_z", "out_proj"))]
    ref_tree = params_from_jax(jax.device_get(rqt))
    lp, lr = list(tree_leaves_with_path(qt)), list(tree_leaves_with_path(ref_tree))
    assert [p for p, _ in lp] == [p for p, _ in lr]
    n_exact = 0
    for (path, a), (_, b) in zip(lp, lr):
        name = "/".join(path)
        assert type(a) is type(b), name
        if name not in rep.per_leaf:
            assert a.dtype == b.dtype and torch.equal(a, b), name
            continue
        alpha, ralpha = (np.atleast_1d(np.asarray(r.per_leaf[name]["alpha"])) for r in (rep, rrep))
        np.testing.assert_array_max_ulp(alpha, ralpha, maxulp=1)
        assert a.granularity == "block" and a.block_size == 32 and a.fmt == "fp8_e4m3"
        L = len(alpha)
        pairs = zip(a.data.view(torch.uint8).reshape(L, -1), b.data.view(torch.uint8).reshape(L, -1),
                    a.scale.reshape(L, -1), b.scale.reshape(L, -1), alpha == ralpha)
        for qa, qb, sa, sb, exact in pairs:
            if exact:
                n_exact += 1
                assert torch.equal(qa, qb) and torch.equal(sa, sb), name
            else:
                torch.testing.assert_close(sa, sb, rtol=1e-6, atol=0)
                assert (qa != qb).float().mean() < 1e-4, name
    assert n_exact >= 10
    in_dt = qt["stack"]["L0"]["mamba"]["in_dt"]
    assert isinstance(in_dt, QuantizedTensor) and in_dt.shape == (2, 64, 16)
    assert tuple(in_dt.scale.shape) == (2, 2, 1, 1, 1)


def test_single_block_scale_association():
    """ROADMAP Queue C 22: for a weight whose block grid is one block, the
    reference's compiled scale is ``alpha * (amax * (1/448))``; for every
    larger grid it is ``amax * (alpha * (1/448))``, which the port computes
    for all grids.  On this [4, 64, 32] leaf (one block of 128 a layer) the
    alphas and codes agree and some scales differ by one ulp."""
    rng = np.random.default_rng(12)
    post = (rng.standard_normal((4, 64, 32)) * 0.05).astype(np.float32)
    base = post + (rng.standard_normal(post.shape) * 5e-4).astype(np.float32)
    rqt, rrep = ref_quantize({"w": jnp.asarray(post)}, {"w": jnp.asarray(base)},
                             RefQuantConfig(), mode="storage")
    qt, rep = quantize({"w": torch.from_numpy(post)}, {"w": torch.from_numpy(base)},
                       QuantConfig(), mode="storage")
    alpha = np.asarray(rep.per_leaf["w"]["alpha"], np.float32)
    ralpha = np.asarray(rrep.per_leaf["w"]["alpha"], np.float32)
    np.testing.assert_array_max_ulp(alpha, ralpha, maxulp=1)       # Queue C 4
    ref = params_from_jax(jax.device_get(rqt))["w"]
    amax = np.abs(post).max(axis=(1, 2)).astype(np.float32)
    inv = np.float32(1) / np.float32(448)
    port_s, ref_s = qt["w"].scale.reshape(4).numpy(), ref.scale.reshape(4).numpy()
    np.testing.assert_array_equal(port_s, amax * (alpha * inv))
    np.testing.assert_array_equal(ref_s, ralpha * (amax * inv))
    same = alpha == ralpha
    assert same.sum() >= 2 and (port_s[same] != ref_s[same]).any()
    codes = qt["w"].data.view(torch.uint8).reshape(4, -1)
    rcodes = ref.data.view(torch.uint8).reshape(4, -1)
    assert all(torch.equal(codes[i], rcodes[i]) for i in np.flatnonzero(same))


def test_stacked_layer_vectors_are_not_quantized():
    """ROADMAP Queue C 23: at 16 layers and 16 heads the stacked ``d_skip``
    [16, 16] passes the reference's rule (two axes >= 16, no skip pattern
    in its name), so the reference stores it as one fp8 matrix, and its
    prefill's layer scan then fails on the scale's leading axis of 1.  The
    port reads a stacked leaf per layer: a vector, kept, and the tree
    serves."""
    from repro.core.policy import should_quantize as ref_should_quantize
    from repro_torch.core.policy import should_quantize
    cfg = dataclasses.replace(ref_reduced(ref_get_arch("mamba2-780m")), n_layers=16,
                              d_inner=256)
    rp = _ref_params(cfg, 12)
    d_skip = rp["stack"]["L0"]["mamba"]["d_skip"]
    assert d_skip.shape == (16, 16)
    # QuantConfig's patterns, which quantize() reads (policy.DEFAULT_SKIP,
    # which names d_skip, is only the function's default)
    pats = RefQuantConfig().skip_patterns
    assert pats == QuantConfig().skip_patterns and "d_skip" not in "".join(pats)
    assert ref_should_quantize("stack/L0/mamba/d_skip", d_skip, pats)
    assert not should_quantize("stack/L0/mamba/d_skip", torch.ones(16, 16), pats)
    assert should_quantize("stack/L0/mamba/in_dt", torch.ones(16, 64, 16), pats)
    # every other matrix skipped by name, so only the stacked vector is in question
    skip = ("norm", "bias", "router", "a_log", "ssm_dt", "conv", "embed", "in_", "out_")
    rqt, rrep = ref_quantize(rp, rp, RefQuantConfig(skip_patterns=skip), mode="storage")
    assert list(rrep.per_leaf) == ["stack/L0/mamba/d_skip"]
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (1, 40)).astype(np.int32)
    with pytest.raises(ValueError, match="leading axis"):
        ref_build_model(cfg).prefill(rqt, {"tokens": jnp.asarray(toks)})
    params = params_from_jax(jax.device_get(rp))
    qt, rep = quantize(params, params, QuantConfig(skip_patterns=skip), mode="storage")
    assert rep.n_quantized == 0 and torch.equal(qt["stack"]["L0"]["mamba"]["d_skip"],
                                                params["stack"]["L0"]["mamba"]["d_skip"])
    model = build_model(dataclasses.replace(reduced(get_arch("mamba2-780m")), n_layers=16,
                                            d_inner=256), device="cpu")
    logits, _ = model.prefill(qt, {"tokens": torch.from_numpy(toks)})
    assert torch.isfinite(logits.float()).all()
