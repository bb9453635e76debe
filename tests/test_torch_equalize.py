"""repro_torch's calibration-based methods (``smoothquant``, ``awq``), their
calibration forward and equalized ``QuantizedTensor``s, against the JAX
reference.

Tolerances:

* calibration records on the reference's own tokens: the same count and
  shapes in the same order; each per-in-channel max within 2e-2 of its
  vector's largest value (activations are bf16 in both frameworks,
  ``models/common.py::ACT_DTYPE``, so the bf16 forward's tolerance holds);
* given the same per-leaf statistics (each side keyed by its own
  fingerprints: ``mean|w|`` is reduced in another order), on float32 trees
  at block and channel granularity: ``smoothquant``'s ``eq_scale``, codes,
  scales and dequant-mode weights bit-equal.  ``awq``'s chosen exponent is
  equal wherever the two smallest errors differ by more than 1e-6 relative
  (the error sums run in another order, and the reference's powers are
  glibc ``powf``); its ``eq_scale`` holds at rtol 1e-6, and its codes are
  bit-equal on every leaf whose ``eq_scale`` is;
* ``take``, ``matmul_t`` and ``dequantize`` of equalized tensors bit-equal
  (``matmul_t`` on one-hot rows, so each output is one exact product);
* an AWQ tree served through the contiguous engine: greedy tokens equal to
  the reference's where the top-2 margin exceeds 2e-2 of the logit scale,
  as ``tests/test_torch_engine.py``.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import QuantConfig as RefQuantConfig
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.core.formats import get_format as ref_get_format
from repro.data import synthetic as RS
from repro.engine import Engine as RefEngine
from repro.models import build_model as ref_build_model
from repro.quant_runtime import qlinear as RQL
from repro.quantize import collect_input_stats as ref_collect_input_stats
from repro.quantize import equalize as RE
from repro.quantize import quantize as ref_quantize
from repro_torch.compat import params_from_jax
from repro_torch.configs import QuantConfig, get_arch, reduced
from repro_torch.core.formats import get_format
from repro_torch.core.policy import tree_leaves_with_path
from repro_torch.data import LanguageSpec
from repro_torch.engine import Engine
from repro_torch.kernels.fp8_matmul import ops as TMM
from repro_torch.models import build_model
from repro_torch.quant_runtime import qlinear
from repro_torch.quant_runtime.qparams import QuantizedTensor
from repro_torch.quantize import collect_input_stats, quantize
from repro_torch.quantize.equalize import _record_input_stats, awq_trials

GAP = 1e-6
TOL = 2e-2
METHODS = ("smoothquant", "awq")


def _draw_tree(shapes, rng, bf16: bool):
    def draw(path, s):
        if len(s.shape) >= 2:
            return rng.standard_normal(s.shape) * s.shape[-2] ** -0.5
        if "bias" in jax.tree_util.keystr(path):
            return rng.standard_normal(s.shape) * 0.1
        return 1.0 + 0.1 * rng.standard_normal(s.shape)
    cast = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) if bf16 else jnp.asarray
    return jax.tree_util.tree_map_with_path(lambda p, s: cast(draw(p, s).astype(np.float32)),
                                            shapes)


@pytest.fixture(scope="module")
def models():
    """(reference model, port model) of the reduced GLM-4-9B on the CPU, and
    the reference's init shapes."""
    cfg = ref_reduced(ref_get_arch("glm4-9b"))
    ref_model = ref_build_model(cfg)
    shapes = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    return ref_model, build_model(reduced(get_arch("glm4-9b")), device="cpu"), shapes


@pytest.fixture(scope="module")
def f32_trees(models):
    """(reference post, reference base, port post, port base), float32."""
    _, _, shapes = models
    rng = np.random.default_rng(0)
    ref_post = _draw_tree(shapes, rng, bf16=False)
    ref_base = jax.tree.map(lambda a: a + jnp.asarray(
        (rng.standard_normal(a.shape) * 0.005).astype(np.float32)) if a.ndim >= 2 else a,
        ref_post)
    return (ref_post, ref_base, params_from_jax(jax.device_get(ref_post)),
            params_from_jax(jax.device_get(ref_base)))


def _calibs(ref_tree, port_tree, seed=1):
    """(reference calib, port calib): one record per matmul leaf-layer (the
    embedding table goes through ``take``: no record), the same numpy-drawn
    per-in-channel maxima on both sides, each keyed by its own fingerprint."""
    rng = np.random.default_rng(seed)
    ref_leaves = dict(("/".join(p), v) for p, v in
                      tree_leaves_with_path(jax.device_get(ref_tree)))
    ref_cal, port_cal = [], []
    for path, leaf in tree_leaves_with_path(port_tree):
        name = "/".join(path)
        if leaf.ndim < 2 or "embed/embed" in name or "norm" in name or "bias" in name:
            continue
        ref_leaf = jnp.asarray(ref_leaves[name])
        n = leaf.shape[0] if leaf.ndim == 3 else 1
        for t in range(n):
            w = leaf[t] if leaf.ndim == 3 else leaf
            rw = ref_leaf[t] if leaf.ndim == 3 else ref_leaf
            amax = (np.abs(rng.standard_normal(w.shape[0])) * 3).astype(np.float32)
            ref_cal.append((tuple(w.shape), RQL.weight_fingerprint(rw), jnp.asarray(amax)))
            port_cal.append((tuple(w.shape), qlinear.weight_fingerprint(w),
                             torch.from_numpy(amax)))
    return ref_cal, port_cal


def _ref_awq_errs(w2d, a, wmax, qcfg):
    """The reference's AWQ errors for one leaf-layer, as its
    ``AWQQuantizer._equalization`` computes them."""
    fmt = ref_get_format(qcfg.fmt)
    s_tries = [jnp.maximum(a ** al / wmax ** (1 - al), 1e-6) for al in RE.AWQQuantizer.GRID]
    return np.array([float(jnp.sum(((RE._qdq_scaled(w2d, s, qcfg, fmt) - w2d) * a[:, None])
                                   ** 2)) for s in s_tries])


@pytest.mark.parametrize("gran", ["channel", "block"])
@pytest.mark.parametrize("method", METHODS)
def test_equalized_quantize_matches_reference(f32_trees, method, gran):
    ref_post, ref_base, post, base = f32_trees
    ref_cal, port_cal = _calibs(ref_post, post)
    kw = dict(granularity=gran, block_size=32)
    outs = {}
    for mode in ("storage", "dequant"):
        outs[mode] = (quantize(post, base, QuantConfig(**kw), mode=mode, method=method,
                               calib=port_cal),
                      ref_quantize(ref_post, ref_base, RefQuantConfig(**kw), mode=mode,
                                   method=method, calib=ref_cal))
    (qt, rep), (rqt, rrep) = outs["storage"]
    assert (rep.n_quantized, rep.quantized_bytes, rep.original_bytes) == \
        (rrep.n_quantized, rrep.quantized_bytes, rrep.original_bytes)
    assert list(rep.per_leaf) == list(rrep.per_leaf)
    for side in ("global_chosen", "global_default"):
        for k, v in getattr(rrep, side).items():
            np.testing.assert_allclose(getattr(rep, side)[k], v, rtol=1e-5, err_msg=side + k)
    (dq, _), (rdq, _) = outs["dequant"]
    rconv, rdconv = (params_from_jax(jax.device_get(t)) for t in (rqt, rdq))
    n_eq = 0
    for (path, a), (_, b), (_, c), (_, d) in zip(*(tree_leaves_with_path(t) for t in
                                                    (qt, rconv, dq, rdconv))):
        if not isinstance(a, QuantizedTensor):
            assert torch.equal(a, b) and torch.equal(c, d), path
            continue
        assert a.eq_scale.shape == b.eq_scale.shape == a.shape[:-1]
        same_eq = torch.equal(a.eq_scale, b.eq_scale)
        if method == "smoothquant":
            assert same_eq, path
        torch.testing.assert_close(a.eq_scale, b.eq_scale, rtol=1e-6, atol=0)
        if same_eq:
            n_eq += 1
            assert torch.equal(a.data.view(torch.uint8), b.data.view(torch.uint8)), path
            assert torch.equal(a.scale, b.scale), path
            assert torch.equal(c, d), path
    assert n_eq >= rep.n_quantized - 2


@pytest.mark.parametrize("gran", ["channel", "block"])
def test_awq_exponent_matches_reference(f32_trees, gran):
    """Per leaf-layer, the exponent of ``GRID`` AWQ picks: equal to the
    reference's wherever the port's two smallest errors differ by more than
    GAP relative."""
    _, _, post, _ = f32_trees
    qcfg = QuantConfig(granularity=gran, block_size=32)
    rqcfg = RefQuantConfig(granularity=gran, block_size=32)
    rng = np.random.default_rng(2)
    n_decided = 0
    for path, leaf in tree_leaves_with_path(post):
        if leaf.ndim < 2 or "norm" in path[-1] or "bias" in path[-1]:
            continue
        for w in (leaf if leaf.ndim == 3 else leaf[None]):
            amax = (np.abs(rng.standard_normal(w.shape[0])) * 3 + 1e-3).astype(np.float32)
            a = torch.from_numpy(amax)
            wmax = w.abs().amax(dim=1).clamp_min(1e-6)
            _, errs = awq_trials(w, a, wmax, qcfg, get_format("fp8_e4m3"))
            r_errs = _ref_awq_errs(jnp.asarray(w.numpy()), jnp.asarray(amax),
                                   jnp.maximum(jnp.max(jnp.abs(jnp.asarray(w.numpy())), axis=1),
                                               1e-6), rqcfg)
            np.testing.assert_allclose(errs.numpy(), r_errs, rtol=1e-5)
            two = torch.sort(errs).values[:2]
            if float(two[1] - two[0]) > GAP * float(two[0]):
                n_decided += 1
                assert int(torch.argmin(errs)) == int(np.argmin(r_errs)), path
    assert n_decided >= 10


@pytest.fixture(scope="module")
def bf16_setup(models):
    """bf16 reduced GLM-4-9B params, drawn as in tests/test_torch_engine.py."""
    ref_model, model, shapes = models
    ref_params = _draw_tree(shapes, np.random.default_rng(0), bf16=True)
    return ref_model, ref_params, model, params_from_jax(jax.device_get(ref_params))


def test_calibration_records_match_reference_on_its_tokens(bf16_setup):
    ref_model, ref_params, model, params = bf16_setup
    spec = RS.LanguageSpec(vocab=512)
    ref_rec = ref_collect_input_stats(ref_model, ref_params, spec, n_batches=2)
    toks = [torch.from_numpy(np.asarray(RS.sample_batch(jax.random.PRNGKey(500 + i), spec,
                                                        4, 64))[:, :-1].copy())
            for i in range(2)]
    rec = _record_input_stats(model, params, toks)
    assert qlinear.RECORD is None
    calls = 7 * model.cfg.n_layers + 1        # seven per layer, and the LM head
    assert len(rec) == len(ref_rec) == 2 * calls
    assert [r[0] for r in rec] == [r[0] for r in ref_rec]
    for (_, _, m), (_, _, rm) in zip(rec, ref_rec):
        assert m.dtype == torch.bfloat16 and m.shape == (rm.shape[0],)
        rm = np.asarray(rm.astype(jnp.float32))
        assert np.abs(m.float().numpy() - rm).max() <= TOL * np.abs(rm).max()
    # the port's records are keyed by the port's fingerprints of its leaves
    stack = params["stack"]["L0"]
    order = [stack[part][name][i] for i in range(model.cfg.n_layers)
             for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                                 ("mlp", ("w_gate", "w_up", "w_down"))) for name in names]
    order.append(params["embed"]["w_head"])
    assert [r[1] for r in rec] == [qlinear.weight_fingerprint(w) for w in order] * 2
    # the public entry point: its own tokens, the same count, all finite
    rec2 = collect_input_stats(model, params, LanguageSpec(vocab=512), n_batches=1)
    assert len(rec2) == calls and all(bool(torch.isfinite(r[2]).all()) for r in rec2)
    assert qlinear.RECORD is None


def test_equalized_calibration_through_model(bf16_setup):
    """Statistics collected through the calibrate hook (``model=`` /
    ``spec=``) steer ``s`` away from the unit case, keep the metrics finite
    and warn about nothing (the embedding table is exempt from the miss
    warning)."""
    _, _, model, params = bf16_setup
    base = {k: v for k, v in params.items()}
    q = QuantConfig(method="smoothquant", granularity="channel")
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        calibrated, rep_c = quantize(params, base, q, model=model,
                                     spec=LanguageSpec(vocab=512), calib_batches=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        unit, rep_u = quantize(params, base, q)
    assert rep_c.n_quantized == rep_u.n_quantized > 0
    assert all(np.isfinite(v) for v in rep_c.global_chosen.values())
    diffs = [float((a - b).abs().max()) for (_, a), (_, b) in
             zip(tree_leaves_with_path(calibrated), tree_leaves_with_path(unit))]
    assert max(diffs) > 0


def _small_pair(seed=0, delta=0.002):
    rng = np.random.default_rng(seed)
    post = {"blk": {"w": torch.from_numpy((rng.standard_normal((48, 64)) * 0.05)
                                          .astype(np.float32)),
                    "stack": torch.from_numpy((rng.standard_normal((3, 32, 48)) * 0.05)
                                              .astype(np.float32))},
            "norm_w": torch.ones(48)}
    base = {"blk": {k: v - delta for k, v in post["blk"].items()}, "norm_w": post["norm_w"]}
    return post, base


def test_calibration_stats_match_by_weight_identity():
    """Same-shaped weights each get their own activation stats, and each
    layer of a stacked leaf its layer's."""
    rng = np.random.default_rng(3)
    mk = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.05).astype(np.float32))
    w_a, w_b, w_s = mk(32, 32), mk(32, 32), mk(2, 32, 32)
    post = {"a": w_a, "b": w_b, "s": w_s}
    base = {k: v * 0.99 for k, v in post.items()}
    amax = {"a": torch.full((32,), 4.0), "b": torch.full((32,), 0.25),
            "s0": torch.linspace(0.5, 2.0, 32), "s1": torch.linspace(2.0, 0.5, 32)}
    fp = qlinear.weight_fingerprint
    calib = [((32, 32), fp(w_a), amax["a"]), ((32, 32), fp(w_b), amax["b"]),
             ((32, 32), fp(w_s[0]), amax["s0"]), ((32, 32), fp(w_s[1]), amax["s1"])]
    _, rep = quantize(post, base, QuantConfig(method="smoothquant", granularity="channel"),
                      calib=calib)

    def expected_s(w2d, a):
        wmax = w2d.abs().amax(dim=1).clamp_min(1e-6)
        sqrt = lambda v: torch.sqrt(v.double()).float()     # correctly rounded
        s = sqrt(a.clamp_min(1e-6)) / sqrt(wmax)
        return (s / s.amax().clamp_min(1e-6)).clamp_min(1e-4)

    np.testing.assert_array_equal(rep.per_leaf["a"]["alpha"], expected_s(w_a, amax["a"]))
    np.testing.assert_array_equal(rep.per_leaf["b"]["alpha"], expected_s(w_b, amax["b"]))
    got = rep.per_leaf["s"]["alpha"]
    np.testing.assert_array_equal(got[0], expected_s(w_s[0], amax["s0"]))
    np.testing.assert_array_equal(got[1], expected_s(w_s[1], amax["s1"]))


def test_calibration_requires_model_and_spec_together():
    post, base = _small_pair()
    q = QuantConfig(method="smoothquant", granularity="channel")
    for kw in (dict(model=object()), dict(spec=object())):
        with pytest.raises(ValueError, match="BOTH model= and spec="):
            quantize(post, base, q, **kw)


@pytest.mark.parametrize("method", METHODS)
def test_empty_calib_warns_like_none(method):
    post, base = _small_pair()
    q = QuantConfig(method=method, granularity="channel")
    for calib in ([], None):
        with pytest.warns(UserWarning, match="no calibration stats"):
            quantize(post, base, q, calib=calib)


def test_calibration_miss_warns_once():
    """Stats present but leaves unmatched: one warning, not one per leaf."""
    post, base = _small_pair()
    other = torch.randn(48, 64, generator=torch.Generator().manual_seed(0))
    calib = [((48, 64), qlinear.weight_fingerprint(other), torch.ones(48))]
    q = QuantConfig(method="smoothquant", granularity="channel")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        quantize(post, base, q, calib=calib)
    misses = [w for w in caught if "no calibration record matches" in str(w.message)]
    assert len(misses) == 1


@pytest.mark.parametrize("gran", ["tensor", "channel", "block"])
def test_equalized_runtime_ops_bit_equal(f32_trees, gran):
    """``dequantize``, ``take`` and ``matmul_t`` of an equalized tensor (the
    reference's smoothquant output, converted) equal the reference's bit for
    bit; a stacked leaf's ``layer(i)`` carries its layer's ``eq_scale``."""
    ref_post, ref_base, _, _ = f32_trees
    leaf = {"embed": {"w": ref_post["embed"]["embed"]},
            "s": {"w": ref_post["stack"]["L0"]["mlp"]["w_up"]}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rq, _ = ref_quantize(leaf, None, RefQuantConfig(granularity=gran, block_size=32),
                             mode="storage", method="smoothquant")
    rt = rq["embed"]["w"]
    pt = params_from_jax(jax.device_get(rq))["embed"]["w"]
    assert pt.eq_scale is not None and pt.eq_scale.shape == (rt.shape[0],)
    np.testing.assert_array_equal(pt.dequantize().numpy(), np.asarray(rt.dequantize()))
    ids = np.array([[0, 5, 511], [7, 7, 300]], np.int32)
    np.testing.assert_array_equal(qlinear.take(pt, torch.from_numpy(ids)).numpy(),
                                  np.asarray(RQL.take(rt, jnp.asarray(ids))))
    x = np.zeros((4, rt.shape[1]), np.float32)
    x[np.arange(4), [0, 3, 17, 63]] = [1.0, 2.0, 0.5, -4.0]
    np.testing.assert_array_equal(qlinear.matmul_t(torch.from_numpy(x), pt).numpy(),
                                  np.asarray(RQL.matmul_t(jnp.asarray(x), rt)))
    rs = rq["s"]["w"]
    ps = params_from_jax(jax.device_get(rq))["s"]["w"]
    assert ps.eq_scale.shape == (4, 64)
    np.testing.assert_array_equal(ps.dequantize().numpy(), np.asarray(rs.dequantize()))
    assert torch.equal(ps.layer(2).eq_scale, ps.eq_scale[2])
    np.testing.assert_array_equal(ps.layer(2).dequantize().numpy(),
                                  np.asarray(rs.dequantize())[2])
    assert ps.nbytes() == rs.nbytes()


def test_params_from_jax_carries_eq_scale(f32_trees):
    ref_post, ref_base, _, _ = f32_trees
    ref_cal, _ = _calibs(ref_post, params_from_jax(jax.device_get(ref_post)))
    rq, _ = ref_quantize(ref_post, ref_base, RefQuantConfig(granularity="channel"),
                         mode="storage", method="awq", calib=ref_cal)
    port = params_from_jax(jax.device_get(rq))
    for (path, a), (_, b) in zip(tree_leaves_with_path(port),
                                 tree_leaves_with_path(jax.device_get(rq))):
        if isinstance(a, QuantizedTensor):
            assert a.eq_scale.dtype == torch.float32
            np.testing.assert_array_equal(a.eq_scale.numpy(), np.asarray(b.eq_scale))


def test_equalized_tensors_never_reach_the_fp8_kernel(monkeypatch):
    """A block-128 E4M3 equalized tree takes the dequantize path: no fp8
    product in a prefill or a decode step, and ``_fused_kernel_applies`` is
    False for each of its layers (it holds for the same tree without
    ``eq_scale``)."""
    cfg = dataclasses.replace(get_arch("glm4-9b"), n_layers=2, d_model=256, n_heads=2,
                              n_kv_heads=1, head_dim=128, d_ff=512, vocab_size=512)
    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    post = model.init(g)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        qparams, _ = quantize(post, None, QuantConfig(), mode="storage", method="awq")
    w = qparams["stack"]["L0"]["mlp"]["w_gate"].layer(0)
    assert w.eq_scale is not None and not qlinear._fused_kernel_applies(w)
    assert qlinear._fused_kernel_applies(dataclasses.replace(w, eq_scale=None))
    seen = []
    monkeypatch.setattr(TMM, "matmul_fp8_2d", lambda *a, **k: seen.append(a))
    tokens = torch.randint(0, cfg.vocab_size, (8, 32), generator=g)
    logits, cache = model.prefill(qparams, {"tokens": tokens}, cache_len=34)
    model.decode_step(qparams, tokens[:, :1], cache)
    assert seen == [] and bool(torch.isfinite(logits.float()).all())


def test_matmul_records_nothing_when_record_is_none(monkeypatch):
    """With ``RECORD`` None a matmul computes no fingerprint and no maximum."""
    monkeypatch.setattr(qlinear, "weight_fingerprint",
                        lambda w: (_ for _ in ()).throw(AssertionError("fingerprinted")))
    assert qlinear.RECORD is None
    qlinear.matmul(torch.ones(2, 4), torch.ones(4, 3))


def _min_margin(model, params, prompt, continuation) -> float:
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


def test_awq_tree_serves_like_reference(bf16_setup):
    """An AWQ tree (channel granularity, storage mode, the same statistics
    on both sides) served greedily through the contiguous engine."""
    ref_model, ref_params, model, params = bf16_setup
    ref_cal, port_cal = _calibs(ref_params, params)
    rq, _ = ref_quantize(ref_params, None, RefQuantConfig(granularity="channel"),
                         mode="storage", out_dtype="bfloat16", method="awq", calib=ref_cal)
    qp, _ = quantize(params, None, QuantConfig(granularity="channel"), mode="storage",
                     out_dtype="bfloat16", method="awq", calib=port_cal)
    prompts = [np.random.default_rng(s).integers(0, 512, n).astype(np.int32)
               for s, n in ((0, 10), (1, 7), (3, 9))]
    ref_out = RefEngine(ref_model, rq, slots=2, cache_len=24, k_steps=3).serve(
        [jnp.asarray(p) for p in prompts], gen_tokens=5)
    for p, out in zip(prompts, ref_out):
        assert _min_margin(model, qp, p, out) > TOL
    outs = Engine(model, qp, slots=2, cache_len=24, k_steps=3).serve(prompts, gen_tokens=5)
    assert outs == [list(map(int, o)) for o in ref_out]
