"""repro_torch.core.search (Algorithm 1, plain and fused) vs the JAX reference.

Inputs are float32 numpy draws (the regime of tests/test_search.py).
Tolerances: the chosen alpha identical and then storage codes and scales
bit-equal; chosen / default metrics and partial sums rtol 1e-5 (fp32 sums in
another order).  One known exception (ROADMAP Queue C): the reference's
*fine* alpha grid is ``jnp.linspace`` of traced endpoints, which XLA on the
CPU contracts into FMAs in a layout-dependent way, so a fine-grid point can
sit one ulp from the port's (which equals the reference's constant-folded
coarse grid exactly); and for a scalar (tensor-granularity) scale XLA
associates ``alpha * amax / qmax`` differently from the block and channel
scales the port matches.  For those cases the test holds alpha to one ulp,
the scales to rtol 1e-6 and the codes to the reference's fp8 kernel-test
tolerance (mismatch fraction < 1e-4).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import QuantConfig as RefQuantConfig
from repro.core.search import search_scale as ref_search_scale
from repro_torch.configs import QuantConfig
from repro_torch.core import metrics as M
from repro_torch.core.formats import get_format
from repro_torch.core.granularity import absmax_scale, apply_qdq, dequantize_stored
from repro_torch.core.search import search_scale

_KEYS = ("mse", "sign_rate", "cosine", "delta_l2", "sq_err", "n_sign_match", "dot",
         "dp_sq", "dq_sq", "count")


def _pair(seed, shape=(96, 64), delta=0.003):
    rng = np.random.default_rng(seed)
    wb = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    wp = (wb + rng.standard_normal(shape) * delta).astype(np.float32)
    return wp, wb


def _u8(t):
    return t.contiguous().view(torch.uint8).numpy() if t.element_size() == 1 \
        else t.contiguous().view(torch.int32).numpy()


def _assert_same_result(port, ref, *, exact=True):
    a_p, a_r = port.alpha.numpy(), np.asarray(ref.alpha)
    codes_r = np.asarray(ref.w_q).view(np.uint8 if port.w_q.element_size() == 1 else np.int32)
    if exact:
        np.testing.assert_array_equal(a_p, a_r)
        np.testing.assert_array_equal(port.scale.numpy(), np.asarray(ref.scale))
        np.testing.assert_array_equal(_u8(port.w_q), codes_r)
    else:  # one ulp apart (module docstring)
        np.testing.assert_array_max_ulp(a_p, a_r, maxulp=1)
        np.testing.assert_allclose(port.scale.numpy(), np.asarray(ref.scale), rtol=1e-6)
        assert (_u8(port.w_q) != codes_r).mean() < 1e-4
    for side in ("chosen", "default"):
        for k in _KEYS:
            np.testing.assert_allclose(float(getattr(port, side)[k]),
                                       float(getattr(ref, side)[k]), rtol=1e-5,
                                       err_msg=f"{side}/{k}")


@pytest.mark.parametrize("metric", ["mse", "sign", "cosine", "hybrid"])
@pytest.mark.parametrize("gran", ["tensor", "channel", "block"])
def test_search_scale_matches_reference(metric, gran):
    wp, wb = _pair(0)
    kw = dict(metric=metric, granularity=gran, block_size=32)
    port = search_scale(torch.from_numpy(wp), torch.from_numpy(wb), QuantConfig(**kw))
    ref = ref_search_scale(wp, wb, RefQuantConfig(**kw))
    _assert_same_result(port, ref, exact=gran != "tensor")


@pytest.mark.parametrize("fmt", ["fp8_e5m2", "int8", "int4"])
def test_search_scale_other_formats_match_reference(fmt):
    wp, wb = _pair(1, delta=0.01)
    kw = dict(fmt=fmt, granularity="channel")
    port = search_scale(torch.from_numpy(wp), torch.from_numpy(wb), QuantConfig(**kw))
    _assert_same_result(port, ref_search_scale(wp, wb, RefQuantConfig(**kw)),
                        exact=fmt != "int8")


@pytest.mark.parametrize("metric", ["mse", "sign", "cosine"])
def test_fused_search_matches_reference_and_plain_search(metric):
    """_search_fused (the sweep's plain version here) picks the reference's
    fused alpha, and the same alpha as the port's own per-candidate search."""
    wp, wb = _pair(3, shape=(256, 128))
    kw = dict(metric=metric, granularity="block", block_size=128, use_fused_kernel=True)
    port = search_scale(torch.from_numpy(wp), torch.from_numpy(wb), QuantConfig(**kw))
    _assert_same_result(port, ref_search_scale(wp, wb, RefQuantConfig(**kw)))
    plain = search_scale(torch.from_numpy(wp), torch.from_numpy(wb),
                         QuantConfig(**{**kw, "use_fused_kernel": False}))
    assert float(plain.alpha) == float(port.alpha)
    assert torch.equal(plain.w_q.view(torch.uint8), port.w_q.view(torch.uint8))


@pytest.mark.parametrize("metric", ["mse", "sign", "cosine", "hybrid"])
@pytest.mark.parametrize("gran", ["tensor", "channel", "block"])
def test_never_worse_than_absmax(metric, gran):
    """Alg. 1 lines 4-6: alpha = 1 is the incumbent, so the chosen scale never
    scores worse than AbsMax on the chosen metric."""
    wp, wb = (torch.from_numpy(a) for a in _pair(2))
    q = QuantConfig(metric=metric, granularity=gran, block_size=32)
    res = search_scale(wp, wb, q)
    fmt = get_format(q.fmt)
    dp = wp - wb
    dq0 = apply_qdq(wp, absmax_scale(wp, gran, fmt, 32), gran, fmt, 32) - wb
    dq = dequantize_stored(res.w_q, res.scale, gran, fmt, 32, torch.float32) - wb
    assert float(M.objective(metric, dp, dq)) >= float(M.objective(metric, dp, dq0)) - 1e-6
    assert 0.8 - 1e-6 <= float(res.alpha) <= 1.25 + 1e-6


def test_zero_delta_and_unported_options():
    wb = torch.from_numpy(_pair(7, shape=(64, 64))[1])
    res = search_scale(wb, wb, QuantConfig(metric="sign", granularity="channel"))
    assert np.isfinite(float(res.chosen["cosine"]))
    with pytest.raises(NotImplementedError):
        search_scale(wb, wb, dataclasses.replace(QuantConfig(), per_block_alpha=True))
