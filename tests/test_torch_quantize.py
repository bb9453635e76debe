"""repro_torch.quantize on the reduced GLM-4-9B tree vs the JAX reference,
and the compat bridge that converts the reference's trees.

The post / base trees are numpy draws handed to both frameworks.
Tolerances: per-layer alphas identical, and then that layer's codes and
scales bit-equal (``params_from_jax(reference qtree)`` equals the port's
qtree); untouched leaves bit-equal; report globals rtol 1e-5.  The one
exception is the reference's fine alpha grid (``jnp.linspace`` of traced
endpoints), which XLA on the CPU evaluates with FMAs whose placement
depends on the surrounding vmap/fusion: a fine-grid point, and so a chosen
alpha, can sit one ulp from the port's.  Such a layer is held to that ulp,
its scales to rtol 1e-6 and its codes to the reference's own fp8
kernel-test tolerance (mismatch fraction < 1e-4) — ROADMAP Queue C.

The leaves are float32.  With bfloat16 leaves, small deltas round to exact
zeros (``w_post == w_base``), and for those elements the reference's sign
metric depends on XLA's CPU codegen: it contracts ``q * scale - w_base``
into an FMA, so an element whose dequantized weight equals ``w_base`` reads
as a tiny nonzero delta.  That moves its sign counts, and with them the
chosen alphas, away from the rounded arithmetic the port (and the stored
weights) follow — ROADMAP Queue C.
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
from repro.models import build_model as ref_build_model
from repro.quantize import quantize as ref_quantize
from repro_torch.compat import params_from_jax
from repro_torch.configs import QuantConfig
from repro_torch.core.policy import tree_leaves_with_path
from repro_torch.quant_runtime.qparams import QuantizedTensor
from repro_torch.quantize import quantize


@pytest.fixture(scope="module")
def trees():
    """(reference post, reference base, port post, port base)."""
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
    to_ref = lambda t: jax.tree.map(jnp.asarray, t)
    ref_post, ref_base = to_ref(post), to_ref(base)
    return (ref_post, ref_base, params_from_jax(jax.device_get(ref_post)),
            params_from_jax(jax.device_get(ref_base)))


def _layers(t):
    return t.reshape(-1, *t.shape[-2:]) if t.ndim > 2 else t[None]


def _assert_trees_equal(port, ref_converted, rep):
    """Leaf by leaf; quantized layers bit-equal where the alphas are equal."""
    lp = list(tree_leaves_with_path(port))
    lr = list(tree_leaves_with_path(ref_converted))
    assert [p for p, _ in lp] == [p for p, _ in lr]
    n_exact = n_ulp = 0
    for (path, a), (_, b) in zip(lp, lr):
        name = "/".join(path)
        assert type(a) is type(b), name
        if name not in rep.per_leaf:
            assert a.dtype == b.dtype and torch.equal(a, b), name
            continue
        same = np.atleast_1d(rep.per_leaf[name]["alpha"] == rep.per_leaf[name]["ref_alpha"])
        if isinstance(a, QuantizedTensor):
            assert (a.fmt, a.granularity, a.block_size, a.out_dtype) == \
                (b.fmt, b.granularity, b.block_size, b.out_dtype), name
            pairs = zip(_layers(a.data.view(torch.uint8)), _layers(b.data.view(torch.uint8)),
                        a.scale.reshape(len(same), -1), b.scale.reshape(len(same), -1))
        else:
            pairs = ((x, y, None, None) for x, y in zip(_layers(a), _layers(b)))
        for exact, (xa, xb, sa, sb) in zip(same, pairs):
            if exact and sa is None:   # dequantized floats: q * scale, in
                n_exact += 1           # the association each compiler picks
                torch.testing.assert_close(xa, xb, rtol=1e-6, atol=0)
            elif exact:
                n_exact += 1
                assert torch.equal(xa, xb), name
                assert torch.equal(sa, sb), name
            else:
                n_ulp += 1
                if sa is None:         # floats: a one-ulp scale moves them all
                    flipped = (xa - xb).abs() > 1e-6 * xb.abs()
                else:
                    flipped = xa != xb
                    torch.testing.assert_close(sa, sb, rtol=1e-6, atol=0)
                assert flipped.float().mean() < 1e-4, name
    assert n_exact > n_ulp


def _assert_reports_match(rep, ref):
    assert (rep.n_quantized, rep.n_skipped, rep.quantized_bytes, rep.original_bytes) == \
        (ref.n_quantized, ref.n_skipped, ref.quantized_bytes, ref.original_bytes)
    assert list(rep.per_leaf) == list(ref.per_leaf)
    for name, leaf in ref.per_leaf.items():
        rep.per_leaf[name]["ref_alpha"] = np.asarray(leaf["alpha"])
        np.testing.assert_array_max_ulp(rep.per_leaf[name]["alpha"], np.asarray(leaf["alpha"]),
                                        maxulp=1)
    for side in ("global_chosen", "global_default"):
        for k, v in getattr(ref, side).items():
            np.testing.assert_allclose(getattr(rep, side)[k], v, rtol=1e-5, err_msg=side + k)


def test_quantize_storage_fused_matches_reference(trees):
    """The slice's main path at reduced width: fused sweep, block fp8
    (block 32 divides every reduced width, so the fp8 matmul route applies
    to the result downstream)."""
    ref_post, ref_base, post, base = trees
    kw = dict(use_fused_kernel=True, block_size=32)
    qt, rep = quantize(post, base, QuantConfig(**kw), mode="storage")
    rqt, rrep = ref_quantize(ref_post, ref_base, RefQuantConfig(**kw), mode="storage")
    _assert_reports_match(rep, rrep)
    _assert_trees_equal(qt, params_from_jax(jax.device_get(rqt)), rep)
    assert isinstance(qt["stack"]["L0"]["mlp"]["w_gate"], QuantizedTensor)
    assert qt["stack"]["L0"]["mlp"]["w_gate"].scale.shape == (4, 2, 1, 4, 1)


@pytest.mark.parametrize("method", ["daq", "absmax"])
def test_quantize_dequant_mode_matches_reference(trees, method):
    """Default config (block 128 over 64-wide leaves: padded blocks), plain search."""
    ref_post, ref_base, post, base = trees
    out, rep = quantize(post, base, QuantConfig(), mode="dequant", method=method)
    rout, rrep = ref_quantize(ref_post, ref_base, RefQuantConfig(), mode="dequant",
                              method=method)
    _assert_reports_match(rep, rrep)
    _assert_trees_equal(out, params_from_jax(jax.device_get(rout)), rep)


def test_params_from_jax_converts_dtypes_and_quantized_nodes():
    from repro.quant_runtime.qparams import QuantizedTensor as RefQT
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    ref = {"a": {"bf": jnp.asarray(w).astype(jnp.bfloat16), "f32": jnp.asarray(w[0]),
                 "ids": jnp.arange(5, dtype=jnp.int32)},
           "q": RefQT(data=jnp.asarray(w).astype(jnp.float8_e4m3fn),
                      scale=jnp.ones((2, 1, 1, 1)), block_size=32, out_dtype="float32")}
    port = params_from_jax(jax.device_get(ref))
    assert port["a"]["bf"].dtype == torch.bfloat16
    assert torch.equal(port["a"]["bf"], torch.from_numpy(w).to(torch.bfloat16))
    assert torch.equal(port["a"]["f32"], torch.from_numpy(w[0]))
    assert port["a"]["ids"].tolist() == [0, 1, 2, 3, 4]
    q = port["q"]
    assert isinstance(q, QuantizedTensor) and q.block_size == 32 and q.out_dtype == "float32"
    assert torch.equal(q.data.view(torch.uint8),
                       torch.from_numpy(w).to(torch.float8_e4m3fn).view(torch.uint8))
    eq = dataclasses.replace(ref["q"], eq_scale=jnp.ones(64))
    with pytest.raises(NotImplementedError):
        params_from_jax(jax.device_get({"q": eq}))
