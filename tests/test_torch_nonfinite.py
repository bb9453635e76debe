"""NaN and inf weights: the port against the JAX reference on the CPU.

A post-trained weight that went NaN or inf must quantize and score as the
reference scores it: ``jnp.sign(nan)`` is NaN, so a NaN delta matches no
sign (``torch.sign(nan)`` is 0, which would match a zero or NaN delta);
``jnp.max`` / ``jnp.maximum`` / ``jnp.clip`` keep a NaN, so a tile holding
one gets a NaN scale and NaN codes; a tile holding an inf gets an inf
scale, ±0 codes and NaN at inf / inf.  The same numpy-seeded inputs go
through ``repro`` and ``repro_torch``: the metrics, the sweep's plain
version against the reference's ``ref.py`` and its Pallas kernel in
interpret mode, the quantizer's plain version against the reference's
jitted ``ref.py`` and its Pallas kernel, and a whole storage-mode quantize
of the reduced GLM-4-9B float32 tree with a NaN in one leaf and ±inf in
another.

Tolerances: sign-match counts exact (``n_sign_match``, and ``sign_rate``
bit-equal, which is the count over the element count); fp8 codes NaN where
the reference's are NaN (0x7F or 0xFF: the sign bit of a NaN is not
defined across frameworks) and bit-equal elsewhere; scales and metrics NaN
where the reference's are and bit-equal elsewhere; the other partial sums
(fp32 sums in another order) NaN and ±inf where the reference's are and
rtol 1e-5 elsewhere.  Against the Pallas quantizer, whose interpreted
scale is ``alpha * (amax / 448)`` one ulp from the port's (ROADMAP Queue
C), finite scales are held to rtol 1e-6 and the codes of finite tiles to a
mismatch fraction below 1e-4, as in ``tests/test_torch_kernels.py``.
"""
from __future__ import annotations

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
from repro.core import metrics as RM
from repro.kernels.fp8_quant.kernel import quantize_fp8_pallas
from repro.kernels.fp8_quant.ref import quantize_fp8_ref as jax_quant_ref
from repro.kernels.scale_search.kernel import sweep_partials_pallas
from repro.kernels.scale_search.ref import sweep_partials_ref as jax_sweep_ref
from repro.models import build_model as ref_build_model
from repro.quantize import quantize as ref_quantize
from repro_torch.compat import params_from_jax
from repro_torch.configs import QuantConfig
from repro_torch.core import metrics as TM
from repro_torch.core.policy import tree_leaves_with_path
from repro_torch.kernels.fp8_quant.ref import quantize_fp8_ref
from repro_torch.kernels.scale_search.ref import _qdq_e4m3, sweep_partials_ref
from repro_torch.quant_runtime.qparams import QuantizedTensor
from repro_torch.quantize import quantize

NAN, INF = np.float32(np.nan), np.float32(np.inf)
DEN = np.float32(2.0 ** -149)             # the smallest float32 denormal
R448 = np.float32(1.0) / np.float32(448.0)
PARTIALS = ("sq_err", "dot", "dp_sq", "dq_sq")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _u8(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _floats_equal(port, ref, err=""):
    """NaN where the reference is NaN, bit-equal elsewhere."""
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(port), nan, err_msg=err)
    np.testing.assert_array_equal(port[~nan].view(np.uint32), ref[~nan].view(np.uint32),
                                  err_msg=err)


def _codes_equal(port_u8, ref_u8, err=""):
    """E4M3 codes: NaN (0x7F or 0xFF) where the reference's are, bit-equal elsewhere."""
    nan = (ref_u8 & 0x7F) == 0x7F
    np.testing.assert_array_equal((port_u8 & 0x7F) == 0x7F, nan, err_msg=err)
    np.testing.assert_array_equal(port_u8[~nan], ref_u8[~nan], err_msg=err)


def _sums_close(port, ref, err=""):
    """fp32 sums: NaN and ±inf where the reference's are, rtol 1e-5 elsewhere."""
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref), err_msg=err)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(port), fin, err_msg=err)
    inf = np.isinf(ref)
    np.testing.assert_array_equal(port[inf], ref[inf], err_msg=err)
    np.testing.assert_allclose(port[fin], ref[fin], rtol=1e-5, atol=1e-30, err_msg=err)


# ---------------------------------------------------------------------------
# The sign count: metrics.sign_rate and metrics.partial_sums
# ---------------------------------------------------------------------------

def _deltas(seed: int):
    """dp, dq [64, 96] (a 2 x 3 grid of 32 x 32 groups): noise, then NaN,
    ±inf, ±0 and normal values placed against each other's every kind.
    (Denormals, which both sides read as 0 in the sign, are held by the
    ``*_denormal_*`` tests below.)"""
    rng = np.random.default_rng(seed)
    dp = (rng.standard_normal((64, 96)) * 1e-3).astype(np.float32)
    dq = (dp + rng.standard_normal((64, 96)) * 2e-4).astype(np.float32)
    kinds = [NAN, INF, -INF, np.float32(0.0), np.float32(-0.0), np.float32(1e-30),
             np.float32(-1e-30), np.float32(3.0)]
    # group (0, 0): every pair of kinds; group (0, 1): NaN in dp only;
    # group (1, 2): NaN in dq only; the other groups stay finite
    for i, a in enumerate(kinds):
        for j, b in enumerate(kinds):
            dp[i, j], dq[i, j] = a, b
    dp[5, 40] = NAN
    dq[40, 70] = NAN
    dq[41, 71] = dp[41, 71] = 0.0
    return dp, dq


@pytest.mark.parametrize("seed", [0, 1])
def test_sign_rate_counts_nan_as_no_match_like_reference(seed):
    dp, dq = _deltas(seed)
    port = TM.sign_rate(_t(dp), _t(dq))
    ref = RM.sign_rate(jnp.asarray(dp), jnp.asarray(dq))
    _floats_equal(port.numpy(), np.asarray(ref))
    assert round(float(port) * dp.size) == round(float(ref) * dp.size)


@pytest.mark.parametrize("axes", [(1, 3), (0, 1, 2, 3)])
def test_partial_sums_count_nan_as_no_match_like_reference(axes):
    dp, dq = _deltas(2)
    view = lambda a: a.reshape(2, 32, 3, 32)
    port = TM.partial_sums(_t(view(dp)), _t(view(dq)), axes)
    ref = RM.partial_sums(jnp.asarray(view(dp)), jnp.asarray(view(dq)), axes)
    np.testing.assert_array_equal(port["n_sign_match"].numpy(), np.asarray(ref["n_sign_match"]))
    np.testing.assert_array_equal(port["count"].numpy(), np.asarray(ref["count"]))
    for k in PARTIALS:
        _sums_close(port[k].numpy(), np.asarray(ref[k]), k)
    for k, v in TM.metrics_from_partials(port).items():
        rv = np.asarray(RM.metrics_from_partials(ref)[k])
        np.testing.assert_array_equal(np.isnan(v.numpy()), np.isnan(rv), err_msg=k)
    _floats_equal(TM.metrics_from_partials(port)["sign_rate"].numpy(),
                  np.asarray(RM.metrics_from_partials(ref)["sign_rate"]))


def test_partial_sums_of_finite_deltas_are_unchanged():
    """Finite inputs, denormals included: the count is torch.sign's of the
    deltas with every denormal read as 0 (the reference's sign classes), bit
    for bit."""
    rng = np.random.default_rng(3)
    dp = (rng.standard_normal((64, 64)) * 1e-3).astype(np.float32)
    dq = np.where(rng.random((64, 64)) < 0.1, 0.0, dp + rng.standard_normal((64, 64)) * 1e-3)
    dq = dq.astype(np.float32)
    dp[0, :4] = dq[1, :4] = [DEN, -DEN, np.float32(1e-40), np.float32(-1e-40)]
    port = TM.partial_sums(_t(dp), _t(dq), (0, 1))
    flush = lambda a: _t(np.where(np.abs(a) < TINY, np.float32(0.0), a))
    want = torch.sum(torch.sign(flush(dp)) == torch.sign(flush(dq)), dtype=torch.float32)
    assert torch.equal(port["n_sign_match"], want)
    assert int(port["n_sign_match"]) == _matches(dp, dq, flush=True)


TINY = np.finfo(np.float32).tiny           # the smallest normal float32
DENORMALS = [DEN, -DEN, np.float32(1e-40), np.float32(-1e-40), np.float32(1e-39),
             np.float32(-1.1e-38)]


def _matches(dp, dq, flush: bool) -> int:
    """Sign matches in numpy (IEEE denormals), or with denormals read as 0
    first (the reference's XLA:CPU, and f32 on the TPU)."""
    if flush:
        dp, dq = (np.where(np.abs(a) < TINY, np.float32(0.0), a) for a in (dp, dq))
    return int(np.sum(np.sign(dp) == np.sign(dq)))


def _denormal_deltas(seed: int):
    """dp, dq [64, 96]: noise, then every denormal against every denormal,
    ±0 and a normal value of each sign."""
    rng = np.random.default_rng(seed)
    dp = (rng.standard_normal((64, 96)) * 1e-3).astype(np.float32)
    dq = (dp + rng.standard_normal((64, 96)) * 2e-4).astype(np.float32)
    others = DENORMALS + [np.float32(0.0), np.float32(-0.0), np.float32(1e-3),
                          np.float32(-1e-3)]
    for i, a in enumerate(DENORMALS):
        for j, b in enumerate(others):
            dp[i, j], dq[i, j] = a, b
            dp[10 + j, 20 + i], dq[10 + j, 20 + i] = b, a
    return dp, dq


@pytest.mark.parametrize("which", ["sign_rate", "partial_sums"])
def test_denormal_deltas_differ_from_reference_as_recorded(which):
    """ROADMAP Queue C 13, closed: the reference flushes denormal deltas to 0
    before its sign, and so does the port's sign class.  Counts exact and
    equal on both sides, and different from IEEE denormals' count."""
    dp, dq = _denormal_deltas(5)
    if which == "sign_rate":
        port = round(float(TM.sign_rate(_t(dp), _t(dq))) * dp.size)
        ref = round(float(RM.sign_rate(jnp.asarray(dp), jnp.asarray(dq))) * dp.size)
    else:
        port = int(TM.partial_sums(_t(dp), _t(dq), (0, 1))["n_sign_match"])
        ref = int(RM.partial_sums(jnp.asarray(dp), jnp.asarray(dq), (0, 1))["n_sign_match"])
    assert port == ref == _matches(dp, dq, flush=True)
    # per denormal and placement, the flush adds 5 matches (3 denormals of
    # the other sign, ±0) and removes 1 (the normal value of its sign)
    assert port - _matches(dp, dq, flush=False) == len(DENORMALS) * 2 * 4


_VALUES = st.sampled_from([float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1e-30,
                           -1e-30, 1e-3, -1e-3, 2.5, -2.5])


@settings(database=None, derandomize=True, max_examples=40, deadline=None)
@given(st.lists(st.tuples(_VALUES, _VALUES), min_size=1, max_size=64))
def test_sign_count_property(pairs):
    dp = np.array([a for a, _ in pairs], np.float32)
    dq = np.array([b for _, b in pairs], np.float32)
    port = TM.partial_sums(_t(dp), _t(dq), (0,))["n_sign_match"]
    ref = RM.partial_sums(jnp.asarray(dp), jnp.asarray(dq), (0,))["n_sign_match"]
    assert float(port) == float(ref)
    _floats_equal(TM.sign_rate(_t(dp), _t(dq)).numpy(),
                  np.asarray(RM.sign_rate(jnp.asarray(dp), jnp.asarray(dq))))


# ---------------------------------------------------------------------------
# The sweep's plain version on non-finite tiles
# ---------------------------------------------------------------------------

def _sweep_tiles(bs: int):
    """wp, wb [2 bs, 3 bs]: tile (0, 0) a NaN in wp, (0, 1) +inf in wp,
    (0, 2) -inf in wp, (1, 0) all zero, (1, 1) a NaN in wb, (1, 2) finite."""
    rng = np.random.default_rng(bs)
    wb = (rng.standard_normal((2 * bs, 3 * bs)) * 0.05).astype(np.float32)
    wp = (wb + rng.standard_normal(wb.shape) * 0.002).astype(np.float32)
    wp[3, 5] = NAN
    wp[7, bs + 9] = INF
    wp[bs - 1, 2 * bs] = -INF
    wp[bs:, :bs] = wb[bs:, :bs] = 0.0
    wb[bs + 2, bs + 3] = NAN
    return wp, wb


def _amax(wp, bs):
    I, O = wp.shape
    amax = np.abs(wp.reshape(I // bs, bs, O // bs, bs)).max(axis=(1, 3))
    return np.maximum(amax, np.float32(1e-12)).astype(np.float32)


def _partials_equal(port, ref, err=""):
    np.testing.assert_array_equal(port[..., 1], ref[..., 1], err_msg=err)   # sign counts
    for s in (0, 2, 3, 4):
        _sums_close(port[..., s], ref[..., s], f"{err} slot {s}")


@pytest.mark.parametrize("bs", [32, 64])
def test_sweep_plain_matches_reference_on_nonfinite_tiles(bs):
    wp, wb = _sweep_tiles(bs)
    amax = _amax(wp, bs)
    alphas = np.array([1.0, 0.8, 1.25], np.float32)
    port = sweep_partials_ref(_t(wp), _t(wb), _t(amax), _t(alphas), block_size=bs).numpy()
    for c, a in enumerate(alphas):
        scale = amax * (a * R448)          # the reference's ref and kernel at the port's scale
        for ref in (jax_sweep_ref(wp, wb, scale, np.float32([1.0]), block_size=bs),
                    sweep_partials_pallas(wp, wb, scale, np.float32([1.0]), block_size=bs,
                                          interpret=True)):
            _partials_equal(port[c:c + 1], np.asarray(ref), f"alpha {a}")
    assert np.isnan(port[:, 0, :2, [0, 2, 4]]).all()      # the NaN and +inf tiles' sums
    assert (port[:, 0, 0, 1] == 0).all()                  # a NaN scale matches no sign


def test_sweep_on_denormal_deltas_differs_from_reference_as_recorded():
    """ROADMAP Queue C 13 in the sweep, closed: where wp holds a denormal
    over wb = 0, dp is that denormal and dq is 0 (its code is 0).  The
    reference counts those as sign matches (flushed), and so does the
    port's plain version; every count equal to the reference's ref and
    Pallas kernel."""
    bs = 32
    rng = np.random.default_rng(7)
    wp = (rng.standard_normal((bs, 2 * bs)) * 0.1).astype(np.float32)
    wb = (wp + rng.standard_normal(wp.shape) * 1e-3).astype(np.float32)
    for j, d in enumerate(DENORMALS):
        wp[3, j], wb[3, j] = d, 0.0            # dp = d, dq = 0: flips
        wp[4, j], wb[4, j] = 0.0, d            # dp = dq = -d: a match on both sides
    amax = _amax(wp, bs)
    port = sweep_partials_ref(_t(wp), _t(wb), _t(amax), _t([1.0]), block_size=bs).numpy()
    scale = amax * R448
    for ref in (jax_sweep_ref(wp, wb, scale, np.float32([1.0]), block_size=bs),
                sweep_partials_pallas(wp, wb, scale, np.float32([1.0]), block_size=bs,
                                      interpret=True)):
        ref = np.asarray(ref)
        np.testing.assert_array_equal(port[..., 1], ref[..., 1])
    # against IEEE signs, the flush turns each dp = d over dq = 0 into a match
    tile = (slice(0, bs), slice(0, bs))
    dq = _qdq_e4m3(_t(wp[tile]), _t(scale[0, 0]), 448.0) - _t(wb[tile])
    ieee = int((torch.sign(_t(wp[tile]) - _t(wb[tile])) == torch.sign(dq)).sum())
    assert port[0, 0, 0, 1] - ieee == len(DENORMALS)


# ---------------------------------------------------------------------------
# The quantizer's plain version on non-finite tiles
# ---------------------------------------------------------------------------

def _quant_tiles(b: int):
    """w [2 b, 3 b]: tile (0, 0) a NaN, (0, 1) +inf, (0, 2) -inf, (1, 0)
    all zero (the 1e-12 floor), (1, 1) +inf and -inf, (1, 2) finite."""
    rng = np.random.default_rng(b)
    w = (rng.standard_normal((2 * b, 3 * b)) * 0.3).astype(np.float32)
    w[3, 5] = NAN
    w[7, b + 9] = INF
    w[b - 1, 2 * b] = -INF
    w[b:, :b] = 0.0
    w[b + 1, b + 1], w[b + 4, 2 * b - 1] = INF, -INF
    return w


@pytest.mark.parametrize("b", [64, 128])
@pytest.mark.parametrize("alpha", [1.0, 1.0375])
def test_fp8_quant_plain_matches_reference_on_nonfinite_tiles(b, alpha):
    w, a = _quant_tiles(b), np.float32([alpha])
    qp, sp = quantize_fp8_ref(_t(w), _t(a), block=b)
    qr, sr = jax.jit(lambda w, a: jax_quant_ref(w, a, block=b))(w, a)
    _codes_equal(_u8(qp), np.asarray(qr).view(np.uint8))
    _floats_equal(sp.numpy(), np.asarray(sr))
    assert np.isnan(sp.numpy()[0, 0]) and np.isinf(sp.numpy()[0, 1:]).all()
    assert sp.numpy()[1, 0] == np.float32(1e-12) * (np.float32(alpha) * R448)
    # the Pallas kernel: non-finite scales and every code of a non-finite
    # or zero tile equal; finite scales to rtol 1e-6 (one ulp apart)
    qk, sk = quantize_fp8_pallas(w, a, block=b, interpret=True)
    qk, sk = np.asarray(qk).view(np.uint8), np.asarray(sk)
    fin = np.isfinite(sk)
    np.testing.assert_array_equal(np.isnan(sp.numpy()), np.isnan(sk))
    np.testing.assert_array_equal(sp.numpy()[~fin], sk[~fin])
    np.testing.assert_allclose(sp.numpy()[fin], sk[fin], rtol=1e-6)
    tiles = lambda u: u.reshape(2, b, 3, b).transpose(0, 2, 1, 3)
    port_t, kern_t = tiles(_u8(qp)), tiles(qk)
    for i, j in ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1)):
        _codes_equal(port_t[i, j], kern_t[i, j], f"tile {(i, j)}")
    assert (port_t[1, 2] != kern_t[1, 2]).mean() < 1e-4


# ---------------------------------------------------------------------------
# A whole storage-mode quantize with a NaN in one leaf and ±inf in another
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nonfinite_run():
    """Both packages quantize the reduced GLM-4-9B float32 tree (as
    ``tests/test_torch_quantize.py`` builds it) after ``w_gate`` layer 0
    element 5 became NaN and ``w_up`` layer 0 elements 7 and 300 +inf and
    -inf in the post weights."""
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
    mlp = post["stack"]["L0"]["mlp"]
    mlp["w_gate"][0].reshape(-1)[5] = NAN
    mlp["w_up"][0].reshape(-1)[7] = INF
    mlp["w_up"][0].reshape(-1)[300] = -INF
    kw = dict(use_fused_kernel=True, block_size=32)
    to_ref = lambda t: jax.tree.map(jnp.asarray, t)
    rqt, rrep = ref_quantize(to_ref(post), to_ref(base), RefQuantConfig(**kw), mode="storage")
    qt, rep = quantize(params_from_jax(post), params_from_jax(base), QuantConfig(**kw),
                       mode="storage")
    return qt, rep, params_from_jax(jax.device_get(rqt)), rrep


def test_quantize_with_nonfinite_leaves_matches_reference(nonfinite_run):
    qt, rep, rqt, rrep = nonfinite_run
    assert list(rep.per_leaf) == list(rrep.per_leaf)
    same = {}
    for name, leaf in rrep.per_leaf.items():
        np.testing.assert_array_max_ulp(rep.per_leaf[name]["alpha"],
                                        np.asarray(leaf["alpha"]), maxulp=1)
        same[name] = np.atleast_1d(rep.per_leaf[name]["alpha"] == np.asarray(leaf["alpha"]))
    n_nan_codes = 0
    for (path, a), (_, b) in zip(tree_leaves_with_path(qt), tree_leaves_with_path(rqt)):
        name = "/".join(path)
        if not isinstance(a, QuantizedTensor):
            continue
        lay = lambda t: t.reshape(len(same[name]), -1)
        for exact, ca, cb, sa, sb in zip(same[name], lay(a.data.view(torch.uint8)),
                                         lay(b.data.view(torch.uint8)), lay(a.scale),
                                         lay(b.scale)):
            if exact:
                _codes_equal(ca.numpy(), cb.numpy(), name)
                _floats_equal(sa.numpy(), sb.numpy(), name)
            else:                          # a fine-grid alpha one ulp apart (Queue C)
                np.testing.assert_array_equal(np.isnan(sa.numpy()), np.isnan(sb.numpy()))
                assert (ca != cb).float().mean() < 1e-4, name
            n_nan_codes += int(((ca.numpy() & 0x7F) == 0x7F).sum())
    assert n_nan_codes == 32 * 32 + 2       # the NaN tile; inf / inf in each inf tile
    assert int(torch.isnan(qt["stack"]["L0"]["mlp"]["w_gate"].scale[0]).sum()) == 1


def test_quantize_with_nonfinite_leaves_reports_like_reference(nonfinite_run):
    """Per leaf and globally: the AbsMax (default) sign rates bit-equal, so
    their counts are equal; the chosen ones bit-equal on every leaf whose
    alphas are; the global metrics NaN where the reference's are."""
    _, rep, _, rrep = nonfinite_run
    assert (rep.n_quantized, rep.n_skipped, rep.quantized_bytes, rep.original_bytes) == \
        (rrep.n_quantized, rrep.n_skipped, rrep.quantized_bytes, rrep.original_bytes)
    for name, leaf in rrep.per_leaf.items():
        sides = ("default", "chosen") if np.all(rep.per_leaf[name]["alpha"]
                                                == np.asarray(leaf["alpha"])) else ("default",)
        for side in sides:
            _floats_equal(rep.per_leaf[name][side]["sign_rate"], leaf[side]["sign_rate"],
                          f"{name} {side}")
    for side in ("global_default", "global_chosen"):
        port, ref = getattr(rep, side), getattr(rrep, side)
        _floats_equal(port["sign_rate"], ref["sign_rate"], side)
        for k in ("mse", "cosine", "delta_l2"):
            assert np.isnan(port[k]) == np.isnan(ref[k]), side + k


# ---------------------------------------------------------------------------
# A whole storage-mode quantize with denormal weights (ROADMAP Queue C 13)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def denormal_run():
    """Both packages quantize the reduced GLM-4-9B float32 tree after
    denormal *weights* went into it (XLA reads them as 0 in the absmax,
    the division and the delta; the port reads IEEE values): ``w_gate``
    layer 0 holds a 32 x 32 tile whose post and base weights are all
    denormals of both signs, ``w_up`` layer 0 holds 300 post and 300 base
    weights set to denormals among normal ones, and ``w_down`` layer 1 a
    denormal base under every post weight of its first row."""
    cfg = ref_reduced(ref_get_arch("glm4-9b"))
    shapes = jax.eval_shape(ref_build_model(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)

    def draw(s):
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)
        return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    def denormals(n):
        return (rng.integers(1, 1 << 23, n) * rng.choice([-1, 1], n)).astype(np.float32) * DEN

    post = jax.tree.map(draw, shapes)
    base = jax.tree.map(lambda a: a + (rng.standard_normal(a.shape) * 0.005).astype(np.float32)
                        if a.ndim >= 2 else a, post)
    pm, bm = post["stack"]["L0"]["mlp"], base["stack"]["L0"]["mlp"]
    pm["w_gate"][0, :32, :32] = denormals(32 * 32).reshape(32, 32)
    bm["w_gate"][0, :32, :32] = denormals(32 * 32).reshape(32, 32)
    for tree in (pm, bm):
        flat = tree["w_up"][0].reshape(-1)
        flat[rng.choice(flat.size, 300, replace=False)] = denormals(300)
    bm["w_down"][1, 0] = denormals(bm["w_down"].shape[2])
    kw = dict(use_fused_kernel=True, block_size=32)
    to_ref = lambda t: jax.tree.map(jnp.asarray, t)
    rqt, rrep = ref_quantize(to_ref(post), to_ref(base), RefQuantConfig(**kw), mode="storage")
    qt, rep = quantize(params_from_jax(post), params_from_jax(base), QuantConfig(**kw),
                       mode="storage")
    return qt, rep, params_from_jax(jax.device_get(rqt)), rrep


def test_quantize_with_denormal_weights_matches_reference(denormal_run):
    """ROADMAP Queue C 13's open half: with denormal weights (not only
    deltas) the chosen alphas (to the one ulp of a fine-grid point, Queue
    C 4), the fp8 codes and scales of every layer whose alpha is equal, and
    the sign rates (the sign-match counts over the element count) equal the
    reference's; the all-denormal tile gets codes ±0 on both sides.  Before
    the port read denormal weights as zeros (``metrics.daz``), ``w_gate``'s
    sign rates differed: two denormals of opposite signs have a normal IEEE
    difference, which the reference reads as 0 - 0."""
    qt, rep, rqt, rrep = denormal_run
    assert list(rep.per_leaf) == list(rrep.per_leaf)
    same = {}
    for name, leaf in rrep.per_leaf.items():
        alpha, ref_alpha = rep.per_leaf[name]["alpha"], np.asarray(leaf["alpha"])
        np.testing.assert_array_max_ulp(alpha, ref_alpha, maxulp=1)
        same[name] = np.atleast_1d(alpha == ref_alpha)
        sides = ("default", "chosen") if same[name].all() else ("default",)
        for side in sides:
            _floats_equal(rep.per_leaf[name][side]["sign_rate"], leaf[side]["sign_rate"],
                          f"{name} {side}")
    assert same["stack/L0/mlp/w_gate"].all()
    for (path, a), (_, b) in zip(tree_leaves_with_path(qt), tree_leaves_with_path(rqt)):
        if not isinstance(a, QuantizedTensor):
            continue
        name = "/".join(path)
        lay = lambda t: t.reshape(len(same.get(name, [True])), -1)
        for exact, ca, cb, sa, sb in zip(same.get(name, [True]), lay(_u8(a.data)),
                                         lay(_u8(b.data)), lay(a.scale.numpy()),
                                         lay(b.scale.numpy())):
            if exact:
                _codes_equal(ca, cb, name)
                _floats_equal(sa, sb, name)
    # ±0 codes, the sign of each denormal kept (0x80 is E4M3's -0)
    assert not (_u8(qt["stack"]["L0"]["mlp"]["w_gate"].data)[0, :32, :32] & 0x7F).any()
