"""repro_torch models (dense GLM family) vs the JAX reference: attention
pieces, then prefill and decode logits of the reduced GLM-4-9B, with dense
bf16 weights and with fp8 storage-mode weights.

Tolerances: attention pieces on float32 inputs rtol 1e-5 / atol 1e-6 (the
same tile math, fp32 sums in another order).  Model logits are bf16 in both
frameworks, so they are held to five bf16 ulps of the logit scale,
|diff| <= 2e-2 * max|logit| (measured: 0.6 % dense, 1.0 % fp8): bf16
roundings of norms, RoPE and matmul outputs land in different places, and
with fp8 weights the reference, off its kernel route, multiplies by
bf16-rounded dequantized weights where the port's fp8 kernel route uses the
exact fp32 ``q * scale``.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import attention as RA
from repro.models import build_model as ref_build_model
from repro.quant_runtime.qparams import QuantizedTensor as RefQT
from repro_torch.compat import params_from_jax
from repro_torch.configs import QuantConfig, get_arch, reduced
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.quant_runtime.qparams import QuantizedTensor
from repro_torch.quantize import quantize


def to_reference(tree):
    """The reference's tree (jnp leaves, reference QuantizedTensor nodes) for
    a port tree — the inverse of ``params_from_jax``, for tests."""
    if isinstance(tree, dict):
        return {k: to_reference(v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return RefQT(data=to_reference(tree.data), scale=to_reference(tree.scale),
                     fmt=tree.fmt, granularity=tree.granularity,
                     block_size=tree.block_size, out_dtype=tree.out_dtype)
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    if tree.dtype == torch.float8_e4m3fn:
        return jnp.asarray(tree.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn))
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def setup():
    """(reference model, reference params, port model, port params, qparams
    for both) on the reduced GLM-4-9B, weights drawn with numpy."""
    cfg = ref_reduced(ref_get_arch("glm4-9b"))
    ref_model = ref_build_model(cfg)
    shapes = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if len(s.shape) >= 2:
            return rng.standard_normal(s.shape) * s.shape[-2] ** -0.5
        if "bias" in name:
            return rng.standard_normal(s.shape) * 0.1
        return 1.0 + 0.1 * rng.standard_normal(s.shape)

    ref_params = jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(draw(p, s).astype(np.float32)).astype(jnp.bfloat16), shapes)
    params = params_from_jax(jax.device_get(ref_params))
    base = {k: v for k, v in params.items()}
    model = build_model(reduced(get_arch("glm4-9b")), device="cpu")
    qparams, _ = quantize(params, base, QuantConfig(use_fused_kernel=True, block_size=32),
                          mode="storage", out_dtype="bfloat16")
    return ref_model, ref_params, model, params, qparams, to_reference(qparams)


def _tokens(B, S, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _close(port_logits, ref_logits, rel):
    p = port_logits.float().numpy()
    r = np.asarray(ref_logits.astype(jnp.float32))
    scale = np.abs(r).max()
    assert np.abs(p - r).max() <= rel * scale, (np.abs(p - r).max(), scale)


def test_chunked_attention_matches_reference():
    rng = np.random.default_rng(1)
    B, S, H, Kv, hd = 2, 24, 4, 2, 8
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    lens = np.int32([24, 17])
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for causal, window in [(True, 0), (True, 7), (False, 0)]:
        ref = RA.chunked_attention(q, k, v, causal=causal, window=window,
                                   kv_lengths=jnp.asarray(lens), q_chunk=8, kv_chunk=8)
        port = TA.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                    kv_lengths=torch.from_numpy(lens), q_chunk=8, kv_chunk=8)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_decode_attention_and_cache_write_match_reference():
    rng = np.random.default_rng(2)
    B, S, H, Kv, hd = 3, 10, 4, 2, 8
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, Kv, hd)).astype(np.float32)
    kn = rng.standard_normal((B, 1, Kv, hd)).astype(np.float32)
    lens = np.int32([3, 9, 10])               # slot 2 is full: its write drops
    rk, rv = RA.write_cache(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
                            jnp.asarray(kn), jnp.asarray(lens))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    TA.write_cache(tk, tv, torch.from_numpy(kn), torch.from_numpy(kn), torch.from_numpy(lens))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    for window in (0, 4):
        ref = RA.decode_attention(q, rk, rv, jnp.asarray(np.minimum(lens + 1, S)), window=window)
        port = TA.decode_attention(torch.from_numpy(q), tk, tv,
                                   torch.from_numpy(np.minimum(lens + 1, S)), window=window)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_and_decode_logits_match_reference(setup, quantized):
    ref_model, ref_params, model, params, qparams, ref_qparams = setup
    p, rp = (qparams, ref_qparams) if quantized else (params, ref_params)
    rel = 2e-2
    toks = _tokens(3, 12, 3)
    lens = np.int32([12, 7, 9])                # right-padded batch
    rl, rc = ref_model.prefill(rp, {"tokens": jnp.asarray(toks)}, cache_len=20,
                               lengths=jnp.asarray(lens))
    pl, pc = model.prefill(p, {"tokens": torch.from_numpy(toks)}, cache_len=20,
                           lengths=torch.from_numpy(lens))
    _close(pl, rl, rel)
    for step in range(3):
        nxt = _tokens(3, 1, 10 + step)
        rl, rc = ref_model.decode_step(rp, jnp.asarray(nxt), rc)
        pl, pc = model.decode_step(p, torch.from_numpy(nxt), pc)
        _close(pl, rl, rel)
    np.testing.assert_array_equal(pc["lengths"].numpy(), np.asarray(rc["lengths"]))


def test_quantized_linears_take_the_fp8_matmul_route(setup):
    """Every stacked linear of the block-32 tree is block fp8 with edges that
    are block multiples, so qlinear sends it to kernels.fp8_matmul."""
    from repro_torch.quant_runtime.qlinear import _fused_kernel_applies
    _, _, _, _, qparams, _ = setup
    for name in ("wq", "wk", "wv", "wo"):
        assert _fused_kernel_applies(qparams["stack"]["L0"]["attn"][name].layer(0))
    for name in ("w_gate", "w_up", "w_down"):
        assert _fused_kernel_applies(qparams["stack"]["L0"]["mlp"][name].layer(0))
    assert _fused_kernel_applies(qparams["embed"]["w_head"])


def test_float32_model_over_block_fp8_weights_matches_reference(monkeypatch):
    """A ``dtype="float32"`` reduced GLM with block-fp8 storage weights: its
    quantized linears go through ``ops.matmul_fp8`` (the plain version on the
    CPU; on the card the route for its operands), and its prefill and decode
    logits match the reference's.  Activations are bf16 in both frameworks
    whatever the parameters' type, so the bf16 logit tolerance holds."""
    import dataclasses as dc

    from repro_torch.kernels.fp8_matmul import ops as TMM
    cfg = dc.replace(ref_reduced(ref_get_arch("glm4-9b")), dtype="float32")
    ref_model = ref_build_model(cfg)
    shapes = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    ref_params = jax.tree_util.tree_map(
        lambda s: jnp.asarray((rng.standard_normal(s.shape) * (s.shape[-2] ** -0.5
                                                               if len(s.shape) >= 2 else 0.1)
                               + (0.0 if len(s.shape) >= 2 else 1.0)).astype(np.float32)),
        shapes)
    params = params_from_jax(jax.device_get(ref_params))
    from repro_torch.core.policy import tree_leaves_with_path
    assert {t.dtype for _, t in tree_leaves_with_path(params)} == {torch.float32}
    model = build_model(dc.replace(reduced(get_arch("glm4-9b")), dtype="float32"), device="cpu")
    qparams, _ = quantize(params, params, QuantConfig(use_fused_kernel=True, block_size=32),
                          mode="storage", out_dtype="float32")
    assert qparams["stack"]["L0"]["mlp"]["w_up"].data.dtype == torch.float8_e4m3fn
    calls = []
    real = TMM.matmul_fp8

    def spy(x, qt):
        calls.append(x.shape[-1])
        return real(x, qt)

    monkeypatch.setattr(TMM, "matmul_fp8", spy)
    rq = to_reference(qparams)
    toks = _tokens(2, 10, 7)
    rl, rc = ref_model.prefill(rq, {"tokens": jnp.asarray(toks)}, cache_len=16)
    pl, pc = model.prefill(qparams, {"tokens": torch.from_numpy(toks)}, cache_len=16)
    _close(pl, rl, 2e-2)
    nxt = _tokens(2, 1, 8)
    rl, _ = ref_model.decode_step(rq, jnp.asarray(nxt), rc)
    pl, _ = model.decode_step(qparams, torch.from_numpy(nxt), pc)
    _close(pl, rl, 2e-2)
    assert len(calls) == 2 * (7 * cfg.n_layers + 1)
