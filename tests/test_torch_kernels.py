"""The port's kernel triads vs the JAX reference's: each plain PyTorch version
against the reference's ``ref.py`` and its Pallas kernel in interpret mode,
and each wrapper's routing (plain version for CPU tensors, kernel or an
error for anything else).  The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds each against its plain version.

Tolerances: fp8 codes and scales bit-equal to the reference's jitted
``ref.py``; sweep sign-match counts equal to its ``ref.py`` run op by op at
the same scale, the other sweep sums rtol 1e-5 (fp32 sums in another
order); matmul rtol 1e-5, atol 1e-4 (the reference's own kernel-test
tolerance).  Against the Pallas kernels the reference's own kernel-vs-ref
tolerances apply: its interpreted kernels evaluate ``alpha * (amax/448)``
where its compiled ``ref.py`` and ``quantize_store`` evaluate
``amax * (alpha/448)`` (one ulp apart), and XLA on the CPU contracts the
sweep's ``q * scale - w_base`` into an FMA, which moves exact-zero deltas of
bf16 inputs across the sign test (see ROADMAP Queue C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fp8_matmul.kernel import matmul_fp8_pallas
from repro.kernels.fp8_matmul.ops import matmul_fp8 as ref_matmul_fp8
from repro.kernels.fp8_matmul.ref import matmul_fp8_ref as jax_matmul_ref
from repro.kernels.fp8_quant.kernel import quantize_fp8_pallas
from repro.kernels.fp8_quant.ops import quantize_fp8 as ref_quantize_fp8
from repro.kernels.fp8_quant.ref import quantize_fp8_ref as jax_quant_ref
from repro.kernels.scale_search import ops as RS
from repro.kernels.scale_search.kernel import sweep_partials_pallas
from repro.kernels.scale_search.ref import sweep_partials_ref as jax_sweep_ref
from repro.quant_runtime.qparams import QuantizedTensor as RefQT
from repro_torch.compat import tensor_from_numpy
from repro_torch.kernels import _lib
from repro_torch.kernels.fp8_matmul import ops as TMM
from repro_torch.kernels.fp8_matmul.kernel import matmul_fp8_cuda, split_k
from repro_torch.kernels.fp8_matmul.ref import matmul_fp8_ref
from repro_torch.kernels.fp8_quant import ops as TQ
from repro_torch.kernels.fp8_quant.kernel import quantize_fp8_cuda
from repro_torch.kernels.fp8_quant.ref import quantize_fp8_ref
from repro_torch.kernels.scale_search import ops as TS
from repro_torch.kernels.scale_search.kernel import sweep_partials_cuda
from repro_torch.kernels.scale_search.ref import sweep_partials_ref
from repro_torch.quant_runtime.qparams import QuantizedTensor


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a))


def _u8(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _pair(shape, dtype, seed):
    """numpy (w_post, w_base) in fp32, rounded through ``dtype``."""
    rng = np.random.default_rng(seed)
    wb = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    wp = wb + (rng.standard_normal(shape) * 0.002).astype(np.float32)
    rnd = lambda a: np.asarray(jnp.asarray(a).astype(dtype).astype(jnp.float32))
    return rnd(wp), rnd(wb)


def _amax(wp, bs):
    I, O = wp.shape
    amax = np.abs(wp.reshape(I // bs, bs, O // bs, bs)).max(axis=(1, 3))
    return np.maximum(amax, np.float32(1e-12)).astype(np.float32)


R448 = np.float32(1.0) / np.float32(448.0)


def _close_partials(port, ref):
    port, ref = port.numpy(), np.asarray(ref)
    np.testing.assert_array_equal(port[..., 1], ref[..., 1])        # sign counts
    cont = [0, 2, 3, 4]
    np.testing.assert_allclose(port[..., cont], ref[..., cont], rtol=1e-5, atol=1e-12)
    np.testing.assert_array_equal(port[..., 5:], 0.0)


@pytest.mark.parametrize("shape,bs", [((256, 128), 128), ((128, 256), 64),
                                      ((384, 384), 128), ((64, 64), 32)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_sweep_plain_matches_reference_ref_and_pallas(shape, bs, dtype):
    wp, wb = _pair(shape, dtype, shape[0] + shape[1])
    amax = _amax(wp, bs)
    alphas = np.linspace(0.8, 1.25, 6).astype(np.float32)
    port = sweep_partials_ref(_t(wp), _t(wb), _t(amax), _t(alphas), block_size=bs)
    for c, a in enumerate(alphas):   # the reference's ref at the port's scale
        scale = amax * (a * R448)
        _close_partials(port[c:c + 1], jax_sweep_ref(wp, wb, scale, np.float32([1.0]),
                                                     block_size=bs))
    pallas = np.asarray(sweep_partials_pallas(wp, wb, amax * R448, alphas, block_size=bs,
                                              interpret=True))
    np.testing.assert_allclose(port.numpy(), pallas, rtol=1.2e-2, atol=2.5)
    cont = [0, 2, 3, 4]
    np.testing.assert_allclose(port.numpy()[..., cont], pallas[..., cont], rtol=1e-4, atol=1e-4)


def test_sweep_wrapper_pads_and_reduces_like_reference():
    """Ragged [130, 70] at block 64: the pad-sign subtraction, s0 and the
    tensor-level sums match the reference wrapper."""
    wp, wb = _pair((130, 70), jnp.float32, 7)
    alphas = np.float32([1.0, 0.9, 1.1, 1.2])
    ref = RS.sweep(wp, wb, alphas, block_size=64)
    port = TS.sweep(_t(wp), _t(wb), _t(alphas), block_size=64)
    np.testing.assert_array_equal(port["s0"].numpy(), np.asarray(ref["s0"]))
    assert port["grid"] == tuple(ref["grid"])
    t_p, t_r = port["tensor"], ref["tensor"]
    np.testing.assert_array_equal(t_p["n_sign_match"].numpy(), np.asarray(t_r["n_sign_match"]))
    np.testing.assert_array_equal(t_p["count"].numpy(), np.asarray(t_r["count"]))
    for k in ("sq_err", "dot", "dp_sq", "dq_sq"):
        np.testing.assert_allclose(t_p[k].numpy(), np.asarray(t_r[k]), rtol=1e-5)
    for metric in ("sign", "mse", "cosine", "hybrid"):
        np.testing.assert_allclose(TS.objective_values(port, metric).numpy(),
                                   np.asarray(RS.objective_values(ref, metric)), rtol=1e-5)


@pytest.mark.parametrize("shape,bs", [((130, 70), 64), ((300, 200), 128), ((256, 384), 128)])
def test_sweep_with_passed_amax_equals_sweep_computing_it(shape, bs):
    """``_search_fused`` hands the sweep the block amax it already has
    (``absmax(w, "block")``, [I/bs, 1, O/bs, 1]); every output, s0 included,
    is bit-equal to the sweep's own, ragged shapes too."""
    from repro_torch.core.granularity import absmax
    wp, wb = (_t(a) for a in _pair(shape, jnp.bfloat16, 3))
    alphas = _t(np.float32([1.0, 0.8, 0.95, 1.1, 1.25]))
    own = TS.sweep(wp, wb, alphas, block_size=bs)
    amax = absmax(wp, "block", bs)
    passed = TS.sweep(wp, wb, alphas, block_size=bs, amax=amax[:, 0, :, 0])
    assert passed["grid"] == own["grid"]
    assert torch.equal(passed["s0"], own["s0"])
    for level in ("tensor", "block"):
        assert passed[level].keys() == own[level].keys()
        for k in own[level]:
            assert torch.equal(passed[level][k], own[level][k]), (level, k)
    with pytest.raises(ValueError, match="amax"):
        TS.sweep(wp, wb, alphas, block_size=bs, amax=amax)


@pytest.mark.parametrize("shape,b", [((256, 256), 128), ((128, 384), 128),
                                     ((256, 128), 64), ((64, 192), 64)])
@pytest.mark.parametrize("alpha", [1.0, 1.0375])
def test_fp8_quant_plain_bit_equal_to_reference(shape, b, alpha):
    w = (np.random.default_rng(0).standard_normal(shape) * 0.3).astype(np.float32)
    a = np.float32([alpha])
    qp, sp = quantize_fp8_ref(_t(w), _t(a), block=b)
    qr, sr = jax.jit(lambda w, a: jax_quant_ref(w, a, block=b))(w, a)
    np.testing.assert_array_equal(_u8(qp), np.asarray(qr).view(np.uint8))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sr))
    qk, sk = quantize_fp8_pallas(w, a, block=b, interpret=True)
    np.testing.assert_allclose(sp.numpy(), np.asarray(sk), rtol=1e-6)
    assert (_u8(qp) != np.asarray(qk).view(np.uint8)).mean() < 1e-4


def test_fp8_quant_wrapper_ragged_equals_reference_and_quantize_store():
    """Padding and layout as the reference wrapper (which runs the Pallas
    kernel, hence its tolerance), and the contract ``_finalize`` relies on:
    codes and scales bit-equal to ``quantize_store`` at ``scale_from_absmax``."""
    from repro_torch.core.formats import FP8_E4M3
    from repro_torch.core.granularity import absmax, quantize_store, scale_from_absmax
    w = (np.random.default_rng(2).standard_normal((130, 70)) * 0.1).astype(np.float32)
    qp, sp = TQ.quantize_fp8(_t(w), 1.1, block=64)
    qr, sr = ref_quantize_fp8(w, 1.1, block=64)
    assert qp.shape == (130, 70) and sp.shape == (3, 2)
    assert (_u8(qp) != np.asarray(qr).view(np.uint8)).mean() < 1e-4
    np.testing.assert_allclose(sp.numpy(), np.asarray(sr), rtol=1e-6)
    scale = scale_from_absmax(absmax(_t(w), "block", 64), torch.tensor(1.1), FP8_E4M3)
    np.testing.assert_array_equal(sp.numpy(), scale[:, 0, :, 0].numpy())
    np.testing.assert_array_equal(_u8(qp), _u8(quantize_store(_t(w), scale, "block",
                                                              FP8_E4M3, 64)))


@pytest.mark.parametrize("M,K,N", [(64, 256, 256), (128, 128, 384), (32, 256, 128),
                                   (8, 128, 128)])
@pytest.mark.parametrize("xdtype", [jnp.bfloat16, jnp.float32])
def test_fp8_matmul_plain_matches_reference(M, K, N, xdtype):
    rng = np.random.default_rng(M * K + N)
    x = jnp.asarray(rng.standard_normal((M, K)).astype(np.float32)).astype(xdtype)
    q, s = ref_quantize_fp8((rng.standard_normal((K, N)) * 0.1).astype(np.float32))
    yp = matmul_fp8_ref(_t(jax.device_get(x)), _t(jax.device_get(q)), _t(s), block=128)
    for yr in (jax_matmul_ref(x, q, s, block=128),
               matmul_fp8_pallas(x, q, s, bm=min(128, M), block=128, interpret=True)):
        np.testing.assert_allclose(yp.numpy(), np.asarray(yr), rtol=1e-5, atol=1e-4)


def test_fp8_matmul_wrapper_takes_quantized_tensor_like_reference():
    """Leading batch dims, the 4-D scale layout and the cast back to x.dtype."""
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, 3, 256)).astype(np.float32)).astype(jnp.bfloat16)
    q, s = ref_quantize_fp8((rng.standard_normal((256, 128)) * 0.1).astype(np.float32))
    s4 = s[:, None, :, None]
    yr = ref_matmul_fp8(x, RefQT(data=q, scale=s4))
    yp = TMM.matmul_fp8(_t(jax.device_get(x)),
                        QuantizedTensor(data=_t(jax.device_get(q)), scale=_t(s4)))
    assert yp.shape == (2, 3, 128) and yp.dtype == torch.bfloat16
    np.testing.assert_allclose(yp.float().numpy(), np.asarray(yr.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)   # both rounded to bf16
    with pytest.raises(ValueError, match="padded"):
        TMM.matmul_fp8_2d(torch.zeros(2, 96), torch.zeros(96, 128).to(torch.float8_e4m3fn),
                          torch.ones(1, 1))


def test_cpu_tensors_never_reach_the_cuda_libraries():
    """The plain versions serve CPU tensors; the kernels' launchers refuse
    anything that is not on a CUDA device, before any build."""
    before = {k.name: k.launches for k in _lib.KERNELS}
    w = torch.randn(128, 128)
    TS.sweep(w, w * 0.99, torch.ones(3))
    TQ.quantize_fp8(w)
    TMM.matmul_fp8_2d(torch.randn(4, 128).bfloat16(), w.to(torch.float8_e4m3fn),
                      torch.ones(1, 1))
    assert {k.name: k.launches for k in _lib.KERNELS} == before
    with pytest.raises(ValueError, match="CUDA"):
        sweep_partials_cuda(w, w, torch.ones(1, 1), torch.ones(2))
    with pytest.raises(ValueError, match="CUDA"):
        quantize_fp8_cuda(w, torch.ones(1))
    with pytest.raises(ValueError, match="CUDA"):
        matmul_fp8_cuda(w.bfloat16(), w.to(torch.float8_e4m3fn), torch.ones(1, 1))


@pytest.mark.parametrize("M,N,K", [(8, 13696, 4096), (8, 4096, 4096), (8, 256, 4096),
                                   (1024, 13696, 4096), (8, 151552, 4096)])
def test_split_k_covers_every_slab_once(M, N, K):
    splits, per = split_k(M, N, K, 128)
    assert (splits - 1) * per < K // 128 <= splits * per
