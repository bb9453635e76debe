"""repro_torch's Mamba-2 (SSM) family vs the JAX reference on the CPU: the
config, the SSD pieces, and a reduced model's prefill and decode
(``tests/test_torch_ssm_serve.py`` holds its quantize and serve).  Inputs are numpy draws from fixed seeds, carried
to the port by ``params_from_jax``.

Tolerances, and what sets them:

* ``_causal_conv``: its K taps are summed in fp32 in the reference's order,
  and the returned conv state is bit-equal; the output is within 4 ulp
  (measured 2-3), because ``silu`` goes through ``exp``, and XLA:CPU's
  ``exp`` differs from torch's by an ulp on ~10 % of float32 inputs.
  ``_gated_norm``: within 8 ulp (measured 5): ``silu`` again, and the mean's
  sum order.  ``softplus``: the reference's ``logaddexp(x, 0)`` form,
  within 4 ulp (measured 3: ``exp`` and ``log1p``).
* ``ssd_scan`` in fp32: |diff| <= 1e-5 (|ref| + max|ref|) (measured
  7e-7 of max|ref|): the ``cumsum`` and the einsums sum in another order,
  and ``exp`` differs by an ulp.
* ``mamba_decode``: state and output |diff| <= 1e-5 (|ref| + max|ref|).
* A reduced float32 SSM stack driven by fp32 activations (the layer
  functions ``Model.prefill`` / ``decode_step`` run): logits within 1e-4
  of the logit scale (measured ~1e-6).  ``Model.prefill`` itself embeds to
  bf16 activations whatever the parameters' type (``ACT_DTYPE``, as in the
  reference), so the bf16 model is held to the port's bf16 rule, 2e-2 of
  the logit scale (measured 0.4-0.6 %), and its greedy tokens equal where
  the top-2 margin exceeds that.

Every sequence crosses an ``ssm_chunk`` boundary (32 in the reduced
config) and ends in a ragged chunk, so the inter-chunk state and the zero
padding of the last chunk are exercised.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.models import lm as RL
from repro.models import ssm as RS
from repro.models.common import apply_norm as ref_apply_norm
from repro.models.common import lm_logits as ref_lm_logits
from repro_torch.compat import params_from_jax
from repro_torch.configs import get_arch, reduced
from repro_torch.models import build_model
from repro_torch.models import lm as TL
from repro_torch.models import ssm as TS
from repro_torch.models.common import apply_norm, lm_logits

S_PROMPT = 45          # one full chunk of 32 and a ragged one of 13


def _draw(rng, path, s):
    """A seeded value for one leaf: fan-in scaled matrices, conv taps, and
    the SSM time constants away from their inits so they matter."""
    name = jax.tree_util.keystr(path)
    if "conv" in name and "_w" in name:
        return 0.3 * rng.standard_normal(s.shape)
    if "a_log" in name:
        return 0.5 * rng.standard_normal(s.shape)
    if "dt_bias" in name:
        return -1.0 + 0.5 * rng.standard_normal(s.shape)
    if len(s.shape) >= 2:
        return rng.standard_normal(s.shape) * s.shape[-2] ** -0.5
    if "bias" in name:
        return 0.1 * rng.standard_normal(s.shape)
    return 1.0 + 0.1 * rng.standard_normal(s.shape)


def _ref_params(cfg, seed):
    shapes = jax.eval_shape(ref_build_model(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(_draw(rng, p, s).astype(np.float32)).astype(s.dtype), shapes)


@pytest.fixture(scope="module")
def bf16():
    """(reference model, its params, port model, its params), reduced Mamba-2."""
    cfg = ref_reduced(ref_get_arch("mamba2-780m"))
    rp = _ref_params(cfg, 0)
    return (ref_build_model(cfg), rp, build_model(reduced(get_arch("mamba2-780m")), device="cpu"),
            params_from_jax(jax.device_get(rp)))


@pytest.fixture(scope="module")
def f32():
    """The same with float32 parameters."""
    cfg = dataclasses.replace(ref_reduced(ref_get_arch("mamba2-780m")), dtype="float32")
    rp = _ref_params(cfg, 1)
    model = build_model(dataclasses.replace(reduced(get_arch("mamba2-780m")), dtype="float32"),
                        device="cpu")
    return cfg, rp, model, params_from_jax(jax.device_get(rp))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulps(a, b) -> int:
    """Largest distance in float32 ulps between two arrays of one sign layout."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def _close(port, ref, rtol):
    p, r = _np(port), _np(ref)
    np.testing.assert_array_less(np.abs(p - r), rtol * (np.abs(r) + np.abs(r).max()) + 1e-30)


def _logits_close(port, ref, rel):
    p, r = _np(port), _np(ref)
    err, scale = np.abs(p - r).max(), np.abs(r).max()
    assert err <= rel * scale, (err, scale)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

def test_config_and_reduced_config_equal_reference():
    for name in ("mamba2-780m", "deepseek-v3"):
        for ref, port in ((ref_get_arch(name), get_arch(name)),
                          (ref_reduced(ref_get_arch(name)), reduced(get_arch(name)))):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
            assert (port.param_count(), port.active_param_count(), port.n_ssm_heads,
                    port.resolved_d_inner) == (ref.param_count(), ref.active_param_count(),
                                               ref.n_ssm_heads, ref.resolved_d_inner)
    assert dataclasses.asdict(reduced(get_arch("glm4-9b"))) == \
        dataclasses.asdict(ref_reduced(ref_get_arch("glm4-9b")))
    with pytest.raises(NotImplementedError, match="Queue A 5"):
        reduced(dataclasses.replace(get_arch("glm4-9b"), family="hybrid"))


# ---------------------------------------------------------------------------
# SSD pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    rng = np.random.default_rng(2)
    B, S, C, K = 2, S_PROMPT, 48, 4
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, S, C), (K, C), (C,), (B, K - 1, C))]
    arrays[1] *= 0.3
    ref_in = [jnp.asarray(a).astype(dtype) for a in arrays]
    port_in = [torch.from_numpy(_np(a).copy()).to(getattr(torch, dtype)) for a in ref_in]
    for state in (True, False):
        ro, rs = RS._causal_conv(*ref_in[:3], ref_in[3] if state else None)
        po, ps = TS._causal_conv(*port_in[:3], port_in[3] if state else None)
        assert po.dtype == torch.float32 and ps.dtype == port_in[0].dtype
        assert _ulps(po.numpy(), np.asarray(ro)) <= 4
        np.testing.assert_array_equal(_np(ps), _np(rs))


def test_gated_norm_and_softplus_match_reference():
    rng = np.random.default_rng(3)
    y, z = (rng.standard_normal((2, S_PROMPT, 128)).astype(np.float32) for _ in range(2))
    scale = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    ref = RS._gated_norm(jnp.asarray(y), jnp.asarray(z), jnp.asarray(scale))
    port = TS._gated_norm(*map(torch.from_numpy, (y, z, scale)))
    assert _ulps(port.numpy(), np.asarray(ref)) <= 8
    x = (rng.standard_normal(20000) * 8).astype(np.float32)
    x[:4] = [0.0, 30.0, -30.0, 100.0]
    assert _ulps(TS.softplus(torch.from_numpy(x)).numpy(),
                 np.asarray(jax.nn.softplus(jnp.asarray(x)))) <= 4


@pytest.mark.parametrize("S,h0", [(75, True), (75, False), (20, True)])
def test_ssd_scan_matches_reference(S, h0):
    """Several chunks of 32 with a ragged last one, from a given state and
    from zeros; and a sequence shorter than one chunk."""
    rng = np.random.default_rng(4)
    B, nh, P, N = 2, 8, 16, 16
    xh = rng.standard_normal((B, S, nh, P)).astype(np.float32)
    bc, cc = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    dt = np.asarray(jax.nn.softplus(jnp.asarray(rng.standard_normal((B, S, nh)) - 1.0,
                                                jnp.float32)))
    a_log = (0.3 * rng.standard_normal(nh)).astype(np.float32)
    h = rng.standard_normal((B, nh, P, N)).astype(np.float32) if h0 else None
    ry, rh = RS.ssd_scan(*map(jnp.asarray, (xh, bc, cc, dt, a_log)), 32,
                         None if h is None else jnp.asarray(h))
    py, ph = TS.ssd_scan(*map(torch.from_numpy, (xh, bc, cc, dt, a_log)), 32,
                         None if h is None else torch.from_numpy(h))
    assert py.shape == (B, S, nh, P) and ph.shape == (B, nh, P, N)
    _close(py, ry, 1e-5)
    _close(ph, rh, 1e-5)


def test_mamba_decode_matches_reference(f32):
    """One exact recurrent step from a random state (layer 1 of the float32
    tree, fp32 input): the new state, conv histories and output."""
    cfg, rp, model, params = f32
    rng = np.random.default_rng(5)
    B = 3
    cache = {"h": rng.standard_normal((B, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                       cfg.ssm_state)).astype(np.float32),
             "conv_x": rng.standard_normal((B, 3, cfg.resolved_d_inner)).astype(np.float32),
             "conv_bc": rng.standard_normal((B, 3, 2 * cfg.ssm_state)).astype(np.float32)}
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    dtypes = {"h": (jnp.float32, torch.float32), "conv_x": (jnp.bfloat16, torch.bfloat16),
              "conv_bc": (jnp.bfloat16, torch.bfloat16)}
    ref_cache = {k: jnp.asarray(v).astype(dtypes[k][0]) for k, v in cache.items()}
    port_cache = {k: torch.from_numpy(_np(v).copy()).to(dtypes[k][1])
                  for k, v in ref_cache.items()}
    rlayer = jax.tree.map(lambda a: a[1], rp["stack"]["L0"]["mamba"])
    ry, rc = RS.mamba_decode(rlayer, jnp.asarray(x), ref_cache, cfg)
    py, pc = TS.mamba_decode(TL.layer_view(params["stack"]["L0"]["mamba"], 1),
                             torch.from_numpy(x), port_cache, model.cfg)
    assert pc is port_cache and pc["h"].dtype == torch.float32
    _close(py, ry, 1e-5)
    _close(pc["h"], rc["h"], 1e-5)
    for k in ("conv_x", "conv_bc"):
        assert pc[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(pc[k]), _np(rc[k]))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_float32_stack_logits_match_reference(f32):
    """The reduced float32 stack on fp32 activations (embedding rows fed
    straight in): ``apply_layer_prefill`` over a 45-token prompt, then three
    ``apply_layer_decode`` steps, each layer's state in the cache, against
    the reference's ``run_stack_prefill`` / ``run_stack_decode``."""
    cfg, rp, model, params = f32
    specs = RL.layer_plan(cfg)[2]
    assert TL.layer_plan(model.cfg)[2] == specs == [("mamba", "none")]
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (3, S_PROMPT)).astype(np.int32)
    table, ttable = rp["embed"]["embed"], params["embed"]["embed"]
    stack = params["stack"]["L0"]

    def ref_logits(x):
        return ref_lm_logits(rp["embed"], ref_apply_norm(rp["final_norm"], x, cfg.norm_eps))

    def port_logits(x):
        return lm_logits(params["embed"], apply_norm(params["final_norm"], x, cfg.norm_eps))

    xr, rcache = RL.run_stack_prefill(rp["stack"], table[toks], cfg, specs, cache_len=S_PROMPT)
    cache = model.init_cache(3, S_PROMPT)
    x = ttable[torch.from_numpy(toks).long()]
    for i in range(cfg.n_layers):
        x = TL.apply_layer_prefill(TL.layer_view(stack, i), x,
                                   TL.layer_view(cache["stack"]["L0"], i), model.cfg,
                                   model.spec)
    assert x.dtype == torch.float32
    _logits_close(port_logits(x[:, -1:]), ref_logits(xr[:, -1:]), 1e-4)
    _close(cache["stack"]["L0"]["h"], rcache["L0"]["h"], 1e-4)
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (3, 1))
        xr, rcache = RL.run_stack_decode(rp["stack"], rcache, table[nxt], None, cfg, specs)
        x = ttable[torch.from_numpy(nxt).long()]
        for i in range(cfg.n_layers):
            x = TL.apply_layer_decode(TL.layer_view(stack, i), x,
                                      TL.layer_view(cache["stack"]["L0"], i), None,
                                      model.cfg, model.spec)
        _logits_close(port_logits(x), ref_logits(xr), 1e-4)


def test_bf16_model_prefill_and_decode_match_reference(bf16):
    """``Model.prefill`` / ``decode_step`` of the reduced bf16 model: the
    cache layout, logits to the bf16 rule, greedy tokens where the margin
    allows; the paged forwards (the prompt in pieces of ``ssm_chunk``
    through ``prefill_chunk_paged``, then ``decode_step_paged``) give the
    contiguous forwards' logits bit for bit."""
    ref_model, rp, model, params = bf16
    cfg = model.cfg
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (3, S_PROMPT)).astype(np.int32)
    rl, rc = ref_model.prefill(rp, {"tokens": jnp.asarray(toks)})
    pl, pc = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    layer = pc["stack"]["L0"]
    assert {k: (tuple(v.shape), v.dtype) for k, v in layer.items()} == {
        "h": ((4, 3, 8, 16, 16), torch.float32),
        "conv_x": ((4, 3, 3, 128), torch.bfloat16),
        "conv_bc": ((4, 3, 3, 32), torch.bfloat16)}
    assert pc["lengths"].tolist() == [S_PROMPT] * 3
    n_tok = n_cmp = 0
    for step in range(4):
        _logits_close(pl, rl, 2e-2)
        lf = pl.float()
        top = torch.topk(lf, 2).values
        sure = ((top[:, 0] - top[:, 1]) > 2e-2 * lf.abs().amax(dim=1)).numpy()
        same = lf.argmax(-1).numpy() == np.asarray(rl.astype(jnp.float32)).argmax(-1)
        assert same[sure].all()
        n_tok, n_cmp = n_tok + len(same), n_cmp + int(sure.sum())
        if step == 3:
            break
        nxt = lf.argmax(-1).to(torch.int32)[:, None]
        rl, rc = ref_model.decode_step(rp, jnp.asarray(nxt.numpy()), rc)
        pl, pc = model.decode_step(params, nxt, pc)
    assert n_cmp >= n_tok // 2
    np.testing.assert_array_equal(pc["lengths"].numpy(), np.asarray(rc["lengths"]))
    cl, cc = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    paged = model.init_paged_cache(3, 64, block_size=16, num_blocks=12)
    Q = cfg.ssm_chunk
    for start in range(0, S_PROMPT, Q):
        n = min(Q, S_PROMPT - start)
        piece = torch.zeros((3, Q), dtype=torch.int32)
        piece[:, :n] = torch.from_numpy(toks[:, start:start + n])
        ql, paged = model.prefill_chunk_paged(params, piece, paged, torch.full((3,), start),
                                              torch.full((3,), n))
    assert torch.equal(ql, cl) and paged["lengths"].tolist() == [S_PROMPT] * 3
    paged["slot_active"][:] = True      # what admission arms: every slot decodes
    for _ in range(3):
        nxt = cl.float().argmax(-1).to(torch.int32)[:, None]
        cl, cc = model.decode_step(params, nxt, cc)
        ql, paged = model.decode_step_paged(params, nxt, paged)
        assert torch.equal(ql, cl)
    for k, v in cc["stack"]["L0"].items():
        assert torch.equal(paged["stack"]["L0"][k], v), k
