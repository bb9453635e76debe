"""repro_torch core (formats, granularity, metrics, policy, alpha grid) vs the
JAX reference, on numpy-seeded inputs.

Tolerances: storage codes and AbsMax scales are compared bit for bit (both
frameworks divide IEEE, round to nearest even and clip first; the scale's
``/ qmax`` is the float32 reciprocal multiply the reference's jit compiles);
metrics use rtol 1e-6 (fp32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import formats as RF
from repro.core import granularity as RG
from repro.core import metrics as RM
from repro.core.policy import path_str as ref_path_str
from repro.core.policy import should_quantize as ref_should_quantize
from repro_torch.core import formats as TF
from repro_torch.core import granularity as TG
from repro_torch.core import metrics as TM
from repro_torch.core.policy import path_str, should_quantize, tree_leaves_with_path
from repro_torch.core.search import linspace

FMTS = ("fp8_e4m3", "fp8_e5m2", "int8", "int4")


def _bits(x) -> np.ndarray:
    """Raw storage bits of a torch tensor or a jax/numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.uint8).numpy() if x.element_size() == 1 \
            else x.view(torch.int32).numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a.view(np.int32)


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("gran", ["tensor", "channel", "block"])
@pytest.mark.parametrize("shape,bs", [((96, 160), 32), ((130, 70), 64)])
def test_quantize_store_bit_exact(fmt, gran, shape, bs):
    w = _weights(shape, 0)
    ft, fr = TF.get_format(fmt), RF.get_format(fmt)
    s_r = jax.jit(lambda w: RG.absmax_scale(w, gran, fr, bs))(w)
    s_t = TG.absmax_scale(torch.from_numpy(w), gran, ft, bs)
    np.testing.assert_array_equal(_bits(s_t), _bits(s_r))
    scale_r = s_r * 1.07
    scale_t = torch.from_numpy(np.array(scale_r))
    q_r = jax.jit(lambda w, s: RG.quantize_store(w, s, gran, fr, bs))(w, scale_r)
    q_t = TG.quantize_store(torch.from_numpy(w), scale_t, gran, ft, bs)
    np.testing.assert_array_equal(_bits(q_t), _bits(q_r))
    d_r = RG.dequantize_stored(q_r, scale_r, gran, fr, bs, jnp.float32)
    d_t = TG.dequantize_stored(q_t, scale_t, gran, ft, bs, torch.float32)
    np.testing.assert_array_equal(_bits(d_t), _bits(d_r))
    a_r = RG.apply_qdq(w, scale_r, gran, fr, bs)
    a_t = TG.apply_qdq(torch.from_numpy(w), scale_t, gran, ft, bs)
    np.testing.assert_array_equal(_bits(a_t), _bits(a_r))


@settings(database=None, derandomize=True, max_examples=25, deadline=None)
@given(st.integers(1, 40), st.integers(1, 40), st.floats(0.5, 2.0),
       st.sampled_from(FMTS), st.integers(0, 2**16))
def test_format_quantize_property(rows, cols, mult, fmt, seed):
    """Random shapes and scales: codes bit-exact, dequantized values equal."""
    w = _weights((rows, cols), seed) * 40
    scale = np.float32(np.abs(w).max() / 100 * mult + 1e-6)
    q_r = RF.quantize(jnp.asarray(w), jnp.float32(scale), RF.get_format(fmt))
    q_t = TF.quantize(torch.from_numpy(w), torch.tensor(scale), TF.get_format(fmt))
    np.testing.assert_array_equal(_bits(q_t), _bits(q_r))
    np.testing.assert_array_equal(
        TF.dequantize(q_t, torch.tensor(scale), TF.get_format(fmt)).numpy(),
        np.asarray(RF.dequantize(q_r, jnp.float32(scale), RF.get_format(fmt))))


def _deltas(shape, seed):
    rng = np.random.default_rng(seed)
    dp = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    dq = (dp + rng.standard_normal(dp.shape) * 4e-4).astype(np.float32)
    dq.reshape(-1)[:5] = 0.0                   # sign(0) cases
    return dp, dq


def test_metrics_and_partials_match_reference():
    """Whole-tensor metrics on a [32, 16] delta pair (the shape of
    tests/test_metrics.py) and partial sums over 16x16 blocks: sums of a few
    hundred terms, where fp32 order noise stays below 1e-6."""
    dp, dq = _deltas((32, 16), 3)
    dpt, dqt = torch.from_numpy(dp), torch.from_numpy(dq)
    for name, val in RM.all_metrics(dp, dq).items():
        np.testing.assert_allclose(float(TM.all_metrics(dpt, dqt)[name]), float(val),
                                   rtol=1e-6)
    for metric in ("mse", "sign", "cosine", "hybrid"):
        np.testing.assert_allclose(float(TM.objective(metric, dpt, dqt, 0.3)),
                                   float(RM.objective(metric, dp, dq, 0.3)), rtol=1e-6)
    dp, dq = _deltas((4, 16, 8, 16), 4)
    dpt, dqt = torch.from_numpy(dp), torch.from_numpy(dq)
    pr = RM.partial_sums(dp, dq, (1, 3))
    pt = TM.partial_sums(dpt, dqt, (1, 3))
    for k in TM.PARTIAL_KEYS:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pr[k]), rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(pt["n_sign_match"].numpy(), np.asarray(pr["n_sign_match"]))
    for k, v in RM.metrics_from_partials(pr).items():
        np.testing.assert_allclose(TM.metrics_from_partials(pt)[k].numpy(), np.asarray(v),
                                   rtol=1e-6)


def test_policy_leaf_names_and_eligibility_match_reference():
    """Leaf names and quantize decisions over the reduced GLM tree."""
    from repro.configs import QuantConfig, get_arch, reduced
    from repro.models import build_model
    cfg = reduced(get_arch("glm4-9b"))
    shapes = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    ref = [(ref_path_str(p), l) for p, l in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    nested = jax.tree.map(lambda s: torch.empty(s.shape), shapes)
    port = [(path_str(p), l) for p, l in tree_leaves_with_path(nested)]
    assert [n for n, _ in port] == [n for n, _ in ref]
    assert "stack/L0/attn/wq" in dict(port)
    skip = QuantConfig().skip_patterns
    for (n, lt), (_, lr) in zip(port, ref):
        assert should_quantize(n, lt, skip) == ref_should_quantize(n, lr, skip), n


@pytest.mark.parametrize("start,stop,num", [(0.8, 1.25, 5), (0.8, 1.25, 10), (1.0, 1.0, 1),
                                            (0.5, 2.0, 16), (0.8875, 1.1125, 10)])
def test_alpha_grid_matches_reference_coarse_grid(start, stop, num):
    """The grid equals the reference's jitted ``jnp.linspace`` on constant
    endpoints (its coarse grids) bit for bit."""
    ref = jax.jit(lambda: jnp.linspace(start, stop, num))()
    np.testing.assert_array_equal(_bits(linspace(start, stop, num, "cpu")), _bits(ref))
