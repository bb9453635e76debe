"""repro_torch's ``daq-per-block`` (an independent alpha per block / channel)
against the JAX reference, on float32 inputs.

Inputs: ragged float32 pairs (100 x 70 and 33 x 65: no edge a multiple of
the block, so padded blocks are scored) and the reduced GLM-4-9B tree with
stacked ``[L, I, O]`` leaves, numpy draws handed to both frameworks.
Tolerances: for the ``sign`` metric the chosen alphas, the fp8 codes and
the scales are bit-equal at block, channel and tensor granularity (its
objective is an integer count over a constant, the reference's own
reciprocal multiply).  For ``cosine``, ``mse`` and ``hybrid`` the fp32 sums
run in another order, so an alpha is held equal wherever the port's top-2
objective gap exceeds 1e-6 relative, and then that block's (or channel's)
codes and scales bit-equal.  The report's global metrics: rtol 1e-6.
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
from repro.core.search import search_scale as ref_search_scale
from repro.models import build_model as ref_build_model
from repro.quantize import quantize as ref_quantize
from repro_torch.compat import params_from_jax
from repro_torch.configs import QuantConfig, get_arch
from repro_torch.core import metrics as M
from repro_torch.core.formats import get_format
from repro_torch.core.granularity import absmax_scale, apply_qdq, dequantize_stored
from repro_torch.core.policy import tree_leaves_with_path
from repro_torch.core.search import per_block_objectives, search_scale
from repro_torch.kernels.fp8_matmul import ops as TMM
from repro_torch.kernels.fp8_matmul.kernel import route
from repro_torch.models import build_model
from repro_torch.quant_runtime import qlinear
from repro_torch.quant_runtime.qparams import QuantizedTensor
from repro_torch.quantize import quantize

GRANS = ("block", "channel", "tensor")
GAP = 1e-6


def _pair(seed, shape, delta=0.003):
    rng = np.random.default_rng(seed)
    wb = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    wp = (wb + rng.standard_normal(shape) * delta).astype(np.float32)
    return wp, wb


@pytest.fixture(scope="module")
def trees():
    """(reference post, reference base, port post, port base): the reduced
    GLM-4-9B tree in float32, base = post + N(0, 0.005^2)."""
    cfg = ref_reduced(ref_get_arch("glm4-9b"))
    shapes = jax.eval_shape(ref_build_model(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(s):
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)
        return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    post = jax.tree.map(draw, shapes)
    base = jax.tree.map(lambda a: a + (rng.standard_normal(a.shape) * 0.005).astype(np.float32)
                        if a.ndim >= 2 else a, post)
    ref_post, ref_base = jax.tree.map(jnp.asarray, post), jax.tree.map(jnp.asarray, base)
    return (ref_post, ref_base, params_from_jax(jax.device_get(ref_post)),
            params_from_jax(jax.device_get(ref_base)))


def _decided(wp, wb, qcfg) -> torch.Tensor:
    """Where the port's best candidate beats the runner-up by more than GAP
    relative: [O] per channel, [I/bs, O/bs] per block, () per tensor."""
    _, objs = per_block_objectives(torch.from_numpy(wp), torch.from_numpy(wb), qcfg)
    top = torch.topk(objs, 2, dim=0).values
    return (top[0] - top[1]) > GAP * top[0].abs()


def _per_unit(t, gran, bs, shape):
    """A [I, O] tensor (or a scale) viewed per unit of alpha: [O, I] per
    channel, [I/bs, O/bs, bs*bs] per block (zero-padded), [1, I*O] per tensor."""
    if gran == "tensor":
        return t.reshape(1, -1)
    if gran == "channel":
        return t.reshape(-1, shape[-1]).T
    I, O = shape
    pi, po = (-I) % bs, (-O) % bs
    t = torch.nn.functional.pad(t, (0, po, 0, pi))
    return t.reshape((I + pi) // bs, bs, (O + po) // bs, bs).permute(0, 2, 1, 3).reshape(
        (I + pi) // bs, (O + po) // bs, -1)


@pytest.mark.parametrize("metric", ["sign", "cosine", "mse", "hybrid"])
@pytest.mark.parametrize("gran", GRANS)
@pytest.mark.parametrize("shape", [(100, 70), (33, 65)])
def test_per_block_search_matches_reference(metric, gran, shape):
    wp, wb = _pair(0, shape)
    kw = dict(metric=metric, granularity=gran, block_size=32, per_block_alpha=True)
    port = search_scale(torch.from_numpy(wp), torch.from_numpy(wb), QuantConfig(**kw))
    ref = ref_search_scale(wp, wb, RefQuantConfig(**kw))
    a_r = torch.from_numpy(np.array(ref.alpha))
    codes_r = torch.from_numpy(np.array(ref.w_q).view(np.uint8))
    scale_r = torch.from_numpy(np.array(ref.scale))
    assert port.alpha.shape == a_r.shape
    assert port.alpha.shape == {"block": (4, 1, 3, 1) if shape[0] == 100 else (2, 1, 3, 1),
                                "channel": (shape[1],), "tensor": ()}[gran]
    if metric == "sign":
        assert torch.equal(port.alpha, a_r)
        assert torch.equal(port.w_q.view(torch.uint8), codes_r)
        assert torch.equal(port.scale, scale_r)
        return
    decided = _decided(wp, wb, QuantConfig(**kw)).reshape(-1)
    assert decided.float().mean() > 0.5
    same = (port.alpha == a_r).reshape(-1)
    assert bool(same[decided].all())
    units = lambda t: _per_unit(t, gran, 32, shape)
    equal_codes = (units(port.w_q.view(torch.uint8)) == units(codes_r)).reshape(
        len(same), -1).all(dim=1)
    equal_scales = (port.scale == scale_r).reshape(len(same), -1).all(dim=1)
    assert bool(equal_codes[same].all()) and bool(equal_scales[same].all())


@pytest.mark.parametrize("gran", GRANS)
@pytest.mark.parametrize("mode", ["storage", "dequant"])
def test_quantize_daq_per_block_matches_reference(trees, gran, mode):
    """The reduced GLM-4-9B tree through ``quantize(method="daq-per-block")``:
    stacked leaves get stacked alphas ([L, I/bs, 1, O/bs, 1] per block, [L, O]
    per channel, [L] per tensor); alphas, codes, scales and dequantized
    weights bit-equal; the report's counts exact and its globals rtol 1e-6."""
    ref_post, ref_base, post, base = trees
    kw = dict(granularity=gran, block_size=32, metric="sign")
    qt, rep = quantize(post, base, QuantConfig(**kw), mode=mode, method="daq-per-block")
    rqt, rrep = ref_quantize(ref_post, ref_base, RefQuantConfig(**kw), mode=mode,
                             method="daq-per-block")
    assert (rep.n_quantized, rep.n_skipped, rep.quantized_bytes, rep.original_bytes) == \
        (rrep.n_quantized, rrep.n_skipped, rrep.quantized_bytes, rrep.original_bytes)
    assert list(rep.per_leaf) == list(rrep.per_leaf)
    for name, leaf in rrep.per_leaf.items():
        np.testing.assert_array_equal(rep.per_leaf[name]["alpha"], np.asarray(leaf["alpha"]))
    w_gate = rep.per_leaf["stack/L0/mlp/w_gate"]["alpha"]
    assert w_gate.shape == {"block": (4, 2, 1, 4, 1), "channel": (4, 128), "tensor": (4,)}[gran]
    for side in ("global_chosen", "global_default"):
        for k, v in getattr(rrep, side).items():
            np.testing.assert_allclose(getattr(rep, side)[k], v, rtol=1e-6, err_msg=side + k)
    lr = list(tree_leaves_with_path(params_from_jax(jax.device_get(rqt))))
    lp = list(tree_leaves_with_path(qt))
    assert [p for p, _ in lp] == [p for p, _ in lr]
    for (path, a), (_, b) in zip(lp, lr):
        assert type(a) is type(b), path
        if isinstance(a, QuantizedTensor):
            assert torch.equal(a.data.view(torch.uint8), b.data.view(torch.uint8)), path
            assert torch.equal(a.scale, b.scale), path
            assert a.eq_scale is None and b.eq_scale is None
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("metric", ["sign", "cosine", "mse", "hybrid"])
@pytest.mark.parametrize("gran", GRANS)
def test_per_block_never_worse_than_absmax_per_unit(metric, gran):
    """Alpha = 1 is in every block's grid, so each block / channel scores at
    least AbsMax's on its own objective, and the leaf's sign rate (sign)
    at least AbsMax's."""
    wp, wb = (torch.from_numpy(a) for a in _pair(1, (100, 70)))
    q = QuantConfig(metric=metric, granularity=gran, block_size=32, per_block_alpha=True)
    grid, objs = per_block_objectives(wp, wb, q)
    assert float(grid[0]) == 1.0
    assert bool((objs.amax(dim=0) >= objs[0]).all())
    res = search_scale(wp, wb, q)
    assert bool(((res.alpha >= 0.8 - 1e-6) & (res.alpha <= 1.25 + 1e-6)).all())
    if metric == "sign":
        fmt = get_format(q.fmt)
        dq0 = apply_qdq(wp, absmax_scale(wp, gran, fmt, 32), gran, fmt, 32) - wb
        dq = dequantize_stored(res.w_q, res.scale, gran, fmt, 32, torch.float32) - wb
        assert float(M.sign_rate(wp - wb, dq)) >= float(M.sign_rate(wp - wb, dq0))


def test_per_block_launches_neither_search_kernel(monkeypatch, trees):
    """``daq-per-block`` clears ``use_fused_kernel``, as the reference does,
    and a per-block alpha finalizes through ``quantize_store``: neither the
    sweep nor the quantizer wrapper is called, even when asked for."""
    from repro_torch.kernels.fp8_quant import ops as FQ
    from repro_torch.kernels.scale_search import ops as SS
    _, _, post, base = trees
    calls = []
    monkeypatch.setattr(SS, "sweep", lambda *a, **k: calls.append("sweep"))
    monkeypatch.setattr(FQ, "quantize_fp8", lambda *a, **k: calls.append("quantize_fp8"))
    _, rep = quantize(post, base, QuantConfig(use_fused_kernel=True, block_size=32),
                      mode="storage", method="daq-per-block")
    assert calls == [] and rep.n_quantized > 0


def test_per_block_tree_takes_the_fp8_routes(monkeypatch):
    """A per-block-alpha tree at block 128 serves through the fused fp8
    matmul: a prefill of 8 x 128 tokens routes each layer's seven products to
    wgmma and the LM head to the decode route; a decode step routes all of
    them to the decode route (per-block alpha only changes the scale values)."""
    cfg = dataclasses.replace(get_arch("glm4-9b"), n_layers=2, d_model=256, n_heads=2,
                              n_kv_heads=1, head_dim=128, d_ff=512, vocab_size=512)
    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    post = model.init(g)
    qparams, rep = quantize(post, None, QuantConfig(), mode="storage", method="daq-per-block")
    w = qparams["stack"]["L0"]["mlp"]["w_gate"]
    assert rep.per_leaf["stack/L0/mlp/w_gate"]["alpha"].shape == (2, 2, 1, 4, 1)
    assert qlinear._fused_kernel_applies(w.layer(0)) and w.eq_scale is None
    seen = []
    real = TMM.matmul_fp8_2d

    def spy(x, wq, scales, *, block=128):
        seen.append(route(x.shape[0], wq.shape[1], wq.shape[0], block, x.dtype))
        return real(x, wq, scales, block=block)

    monkeypatch.setattr(TMM, "matmul_fp8_2d", spy)
    tokens = torch.randint(0, cfg.vocab_size, (8, 128), generator=g)
    _, cache = model.prefill(qparams, {"tokens": tokens}, cache_len=130)
    assert seen == ["wgmma"] * (7 * cfg.n_layers) + ["decode"]
    seen.clear()
    model.decode_step(qparams, tokens[:, :1], cache)
    assert seen == ["decode"] * (7 * cfg.n_layers + 1)
