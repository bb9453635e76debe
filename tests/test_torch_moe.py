"""repro_torch's MoE family vs the JAX reference on the CPU: GShard top-k
routing with capacity, the MoE FFN, the reduced DeepSeek-V3 (a dense-prefix
layer and three MoE layers of 8 experts, top-2, one shared expert) in
prefill and decode, its DAQ quantize, and its serve on the contiguous
engine.  Inputs are numpy draws from fixed seeds, carried to the port by
``params_from_jax``.

Tolerances, and what sets them:

* ``top_k_routing``: dispatch (so every queue position) exact; combine
  within 1 bf16 ulp (softmax's ``exp`` may differ by an fp32 ulp between
  XLA:CPU and torch, and the gates are cast to bf16); the auxiliary loss
  within 1e-6 (its means sum in another order).
* ``apply_moe`` on fp32 activations and weights: within 1e-5 of the
  output scale, plus 1 bf16 ulp of an element where the two frameworks'
  fp32 sums round to neighbouring bf16 values (the reference casts the
  expert outputs and the combine weights to bf16 before the last einsum).
* The reduced fp32 stack driven by fp32 activations (the layer functions
  ``Model.prefill`` / ``decode_step`` run): routing equal, logits within
  1e-3 of the logit scale (the bf16 combine above, carried through four
  layers).  ``Model.prefill`` itself embeds to bf16 activations whatever
  the parameters' type (``ACT_DTYPE``, as in the reference), and bf16
  noise flips 2-3 % of the top-k choices a layer between the frameworks
  (ROADMAP Queue A 5), so the bf16 model runs with the reference's
  routing replayed into its MoE layers (its own routing agreeing on at
  least 90 % of each call's tokens) and is held to the port's bf16 rule,
  2e-2 of the logit scale, its greedy tokens equal where the top-2 margin
  exceeds that; ``Model.loss_fn`` there (the routing replayed) gives the
  reference's loss within 1e-3 and its auxiliary loss within 2e-2 (the
  port's own, on its own bf16 router inputs).  The engine's greedy tokens
  equal the reference engine's
  up to each request's first step whose margin is within 2e-2.
* Quantize of the reduced fp32 tree at blocks of 32: alphas, codes and
  scales bit-equal, the 4-D expert stacks included (at blocks of 32 every
  leaf has more than one block: ROADMAP Queue C 22), except where a
  fine-grid alpha sits one ulp off (ROADMAP Queue C 4: that matrix's
  scales to rtol 1e-6, its codes at most one E4M3 step apart on fewer
  than 0.1 % of its elements, a value on a rounding boundary moving with
  the scale's last bit).
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
from repro.models import lm as RL
from repro.models import moe as RM
from repro.models.common import apply_norm as ref_apply_norm
from repro.models.common import lm_logits as ref_lm_logits
from repro.quantize import quantize as ref_quantize
from repro_torch.compat import params_from_jax
from repro_torch.configs import QuantConfig, get_arch, reduced
from repro_torch.core.formats import get_format
from repro_torch.core.granularity import dequantize_stored
from repro_torch.core.policy import tree_leaves_with_path
from repro_torch.engine import Engine, serve_host_loop
from repro_torch.models import build_model
from repro_torch.models import lm as TL
from repro_torch.models import moe as TM
from repro_torch.models.common import apply_norm, lm_logits
from repro_torch.quant_runtime import qlinear
from repro_torch.quant_runtime.qparams import QuantizedTensor
from repro_torch.quantize import quantize

TOL = 2e-2
# (numpy seed, length): two distinct lengths
PROMPTS = [(6, 33), (47, 40), (18, 33), (51, 40)]
LENS = [L for _, L in PROMPTS]


def _prompt(seed, length, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, length).astype(np.int32)


def _ref_params(cfg, seed):
    """Fan-in scaled normal matrices (expert stacks by their in-dim, the
    router in fp32), norms near 1."""
    shapes = jax.eval_shape(ref_build_model(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) >= 2:
            a = rng.standard_normal(s.shape) * s.shape[-2] ** -0.5
        else:
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        return jnp.asarray(a.astype(np.float32)).astype(s.dtype)
    return jax.tree.map(draw, shapes)


def _cfgs(dtype):
    ref = dataclasses.replace(ref_reduced(ref_get_arch("deepseek-v3")), dtype=dtype)
    port = dataclasses.replace(reduced(get_arch("deepseek-v3")), dtype=dtype)
    return ref, port


@pytest.fixture(scope="module")
def bf16():
    """(reference model, its params, port model, its params), reduced DeepSeek-V3."""
    cfg, pcfg = _cfgs("bfloat16")
    rp = _ref_params(cfg, 0)
    return ref_build_model(cfg), rp, build_model(pcfg, device="cpu"), \
        params_from_jax(jax.device_get(rp))


@pytest.fixture(scope="module")
def f32():
    cfg, pcfg = _cfgs("float32")
    rp = _ref_params(cfg, 1)
    return cfg, rp, build_model(pcfg, device="cpu"), params_from_jax(jax.device_get(rp))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _logits_close(port, ref, rel):
    p, r = _np(port), _np(ref)
    err, scale = np.abs(p - r).max(), np.abs(r).max()
    assert err <= rel * scale, (err, scale)


def _bf16_ulp(a):
    """One bf16 ulp of each element of ``a`` (float32 numpy)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _record_routing(monkeypatch, replay: bool = False):
    """Record every (dispatch, combine) either framework's ``top_k_routing``
    returns, in call order: the reference's through an ordered debug
    callback (its stacks run under ``lax.scan``), the port's directly.
    With ``replay`` the port's call instead returns the reference's
    recorded routing of the same call (the reference runs first), and
    records the share of tokens its own routing sent to the same experts."""
    rec = {"ref": [], "port": [], "agree": []}
    ref_fn, port_fn = RM.top_k_routing, TM.top_k_routing

    def ref_wrapped(logits, k, cap):
        out = ref_fn(logits, k, cap)
        jax.debug.callback(lambda d, c: rec["ref"].append((np.array(d), np.array(c))),
                           out[0].astype(jnp.float32), out[1].astype(jnp.float32),
                           ordered=True)
        return out

    def port_wrapped(logits, k, cap):
        out = port_fn(logits, k, cap)
        own = out[0].float().numpy()
        if not replay:
            rec["port"].append((own, out[1].float().numpy()))
            return out
        d, c = rec["ref"].pop(0)
        rec["agree"].append(float((own.max(-1) == d.max(-1)).all(-1).mean()))
        return (torch.from_numpy(d).to(torch.bfloat16), torch.from_numpy(c).to(torch.bfloat16),
                out[2])

    monkeypatch.setattr(RM, "top_k_routing", ref_wrapped)
    monkeypatch.setattr(TM, "top_k_routing", port_wrapped)
    return rec


# ---------------------------------------------------------------------------
# Config, routing, the MoE FFN
# ---------------------------------------------------------------------------

def test_layer_plan_and_cache_layout_match_reference(bf16):
    ref_model, rp, model, params = bf16
    assert TL.layer_plan(get_arch("deepseek-v3")) == RL.layer_plan(ref_get_arch("deepseek-v3"))
    assert TL.layer_plan(model.cfg) == RL.layer_plan(ref_model.cfg) == (
        [("attn", "mlp_dense")], 1, [("attn", "moe")], 3)
    assert [(k, s, n) for k, s, n in model.groups] == [("prefix", ("attn", "mlp_dense"), 1),
                                                       ("stack", ("attn", "moe"), 3)]
    shapes = lambda t: {"/".join(p): tuple(v.shape) for p, v in tree_leaves_with_path(t)}
    assert shapes(params) == shapes(model.init(torch.Generator().manual_seed(0)))
    moe = params["stack"]["L0"]["moe"]
    assert tuple(moe["w_gate"].shape) == (3, 8, 64, 128) and moe["router"].dtype == torch.float32
    assert tuple(params["prefix"]["L0"]["mlp"]["w_gate"].shape) == (1, 64, 192)
    cache = model.init_cache(2, 48)
    rcache = ref_model.init_cache(2, 48)
    assert sorted(cache) == sorted(rcache) == ["lengths", "prefix", "stack"]
    for grp in ("prefix", "stack"):
        assert {k: tuple(v.shape) for k, v in cache[grp]["L0"].items()} == \
            {k: tuple(v.shape) for k, v in rcache[grp]["L0"].items()}


# (G, g, E, top_k, capacity): the second and third overflow their queues
ROUTING_DRAWS = [(1, 64, 8, 2, 40), (2, 48, 8, 2, 8), (1, 40, 16, 8, 16)]


@pytest.mark.parametrize("G,g,E,K,cap", ROUTING_DRAWS)
def test_top_k_routing_matches_reference(G, g, E, K, cap):
    lg = (np.random.default_rng(G * g + K).standard_normal((G, g, E)) * 1.5).astype(np.float32)
    rd, rc, ra = jax.jit(lambda a: RM.top_k_routing(a, K, cap))(jnp.asarray(lg))
    td, tc, ta = TM.top_k_routing(torch.from_numpy(lg), K, cap)
    assert td.dtype == tc.dtype == torch.bfloat16 and tuple(td.shape) == (G, g, E, cap)
    np.testing.assert_array_equal(td.float().numpy(), _np(rd))
    rcn, tcn = _np(rc), tc.float().numpy()
    assert ((tcn > 0) == (rcn > 0)).all()
    assert (np.abs(tcn - rcn) <= _bf16_ulp(rcn)).all()
    assert abs(float(ta) - float(ra)) <= 1e-6
    dropped = G * g * K - int(td.float().sum())
    if cap < g * K * 1.25 / E:
        assert dropped > 0
    # a slot holds at most one token; a token holds at most one slot per expert
    assert (td.float().sum(dim=1) <= 1).all() and (td.float().sum(dim=-1) <= 1).all()


@pytest.mark.parametrize("full_capacity", [False, True], ids=["capacity", "full"])
def test_apply_moe_matches_reference(f32, full_capacity):
    """The MoE FFN of layer 0 of the fp32 stack on fp32 activations: the
    capacity-limited routing drops tokens, ``full_capacity`` none."""
    cfg, rp, model, params = f32
    x = np.random.default_rng(3).standard_normal((3, 40, cfg.d_model)).astype(np.float32)
    rpl = jax.tree.map(lambda a: a[0], rp["stack"]["L0"]["moe"])
    ry, raux = jax.jit(lambda p, a: RM.apply_moe(p, a, cfg, full_capacity=full_capacity))(
        rpl, jnp.asarray(x))
    ty, taux = TM.apply_moe(TL.layer_view(params["stack"]["L0"]["moe"], 0),
                            torch.from_numpy(x), model.cfg, full_capacity=full_capacity)
    assert ty.dtype == torch.float32
    r, t = _np(ry), ty.numpy()
    err = np.abs(t - r)
    assert (err <= 1e-5 * np.abs(r).max() + _bf16_ulp(r) * (err > 1e-5 * np.abs(r).max())).all()
    assert np.mean(err > 1e-5 * np.abs(r).max()) < 1e-3
    assert abs(float(taux) - float(raux)) <= 1e-6 * cfg.router_aux_loss * 8
    assert TM._group_tokens(120) == 120
    assert TM.capacity(model.cfg, 120, full_capacity) == (240 if full_capacity else 40)


# ---------------------------------------------------------------------------
# The reduced model
# ---------------------------------------------------------------------------

def test_float32_stack_logits_match_reference(f32, monkeypatch):
    """The reduced float32 model on fp32 activations (embedding rows fed
    straight in): the dense prefix then the MoE stack, ``apply_layer_prefill``
    over a 40-token prompt and two ``apply_layer_decode`` steps, against
    the reference's ``run_stack_prefill`` / ``run_stack_decode``; every
    routing call's dispatch equal."""
    cfg, rp, model, params = f32
    rec = _record_routing(monkeypatch)
    plan = RL.layer_plan(cfg)
    groups = [("prefix", plan[0]), ("stack", plan[2])]
    rng = np.random.default_rng(6)
    B, S = 3, 40
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    table, ttable = rp["embed"]["embed"], params["embed"]["embed"]

    def ref_logits(x):
        return ref_lm_logits(rp["embed"], ref_apply_norm(rp["final_norm"], x, cfg.norm_eps))

    def port_logits(x):
        return lm_logits(params["embed"], apply_norm(params["final_norm"], x, cfg.norm_eps))

    # one compiled scan per group for the prefill and for the decode steps
    prefill = {grp: jax.jit(lambda st, a, specs=specs: RL.run_stack_prefill(
        st, a, cfg, specs, cache_len=S + 3)) for grp, specs in groups}
    decode = {grp: jax.jit(lambda st, c, a, n, specs=specs: RL.run_stack_decode(
        st, c, a, n, cfg, specs)) for grp, specs in groups}
    xr, rcache = table[toks], {}
    for grp, _ in groups:
        xr, rcache[grp] = prefill[grp](rp[grp], xr)
    cache = model.init_cache(B, S + 3)
    x = ttable[torch.from_numpy(toks).long()]
    for grp, spec, n in model.groups:
        for i in range(n):
            x = TL.apply_layer_prefill(TL.layer_view(params[grp]["L0"], i), x,
                                       TL.layer_view(cache[grp]["L0"], i), model.cfg, spec)
    assert x.dtype == torch.float32
    _logits_close(port_logits(x[:, -1:]), ref_logits(xr[:, -1:]), 1e-3)
    lengths = jnp.full((B,), S, jnp.int32)
    for step in range(2):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1))
        xr = table[nxt]
        for grp, _ in groups:
            xr, rcache[grp] = decode[grp](rp[grp], rcache[grp], xr, lengths + step)
        x = ttable[torch.from_numpy(nxt).long()]
        for grp, spec, n in model.groups:
            for i in range(n):
                x = TL.apply_layer_decode(TL.layer_view(params[grp]["L0"], i), x,
                                          TL.layer_view(cache[grp]["L0"], i),
                                          torch.full((B,), S + step, dtype=torch.int32),
                                          model.cfg, spec)
        _logits_close(port_logits(x), ref_logits(xr), 1e-3)
    assert len(rec["port"]) == len(rec["ref"]) == 3 * 3
    for (a, _), (b, _) in zip(rec["port"], rec["ref"]):
        np.testing.assert_array_equal(a, b)


def test_bf16_model_prefill_and_decode_match_reference(bf16, monkeypatch):
    """``Model.prefill`` / ``decode_step`` of the reduced bf16 model with
    the reference's routing replayed into the port's MoE layers (bf16
    noise flips a few tokens' top-k choice a layer, and a flip moves the
    queue positions behind it): the cache layout, logits to the bf16 rule,
    greedy tokens where the margin allows, and the port's own routing
    sending at least 90 % of each call's tokens to the reference's experts
    (measured 93-100 %); ``Model.loss_fn`` (the dense prefix, then the
    stack) with the routing replayed: loss within 1e-3 and the router's
    auxiliary loss within 2e-2 of the reference's; the paged engine serves
    the prompts with the contiguous engine's tokens."""
    ref_model, rp, model, params = bf16
    cfg = model.cfg
    rec = _record_routing(monkeypatch, replay=True)
    rng = np.random.default_rng(7)
    B, S = 3, 40
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    ref_decode = jax.jit(lambda p, t, c: ref_model.decode_step(p, t, c))
    rl, rc = jax.jit(lambda p, t: ref_model.prefill(p, {"tokens": t}))(rp, jnp.asarray(toks))
    pl, pc = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert {g: {k: (tuple(v.shape), v.dtype) for k, v in pc[g]["L0"].items()}
            for g in ("prefix", "stack")} == {
        g: {k: ((n, B, S, 2, 16), torch.bfloat16) for k in ("k", "v")}
        for g, n in (("prefix", 1), ("stack", 3))}
    n_tok = n_cmp = 0
    for step in range(4):
        _logits_close(pl, rl, TOL)
        p, r = pl.float().numpy(), _np(rl)
        top = np.sort(p, axis=1)[:, -2:]
        sure = (top[:, 1] - top[:, 0]) > TOL * np.abs(p).max(axis=1)
        assert (p.argmax(-1) == r.argmax(-1))[sure].all()
        n_tok, n_cmp = n_tok + B, n_cmp + int(sure.sum())
        if step == 3:
            break
        nxt = torch.from_numpy(p.argmax(-1).astype(np.int32))[:, None]
        rl, rc = ref_decode(rp, jnp.asarray(nxt.numpy()), rc)
        pl, pc = model.decode_step(params, nxt, pc)
    assert n_cmp >= n_tok // 2
    assert len(rec["agree"]) == 4 * 3 and not rec["ref"] and min(rec["agree"]) >= 0.9
    np.testing.assert_array_equal(pc["lengths"].numpy(), np.asarray(rc["lengths"]))
    # training's forward (the dense prefix, then the stack, each MoE layer at
    # its group's capacity) with the routing replayed: loss within 1e-3 and
    # the router's auxiliary loss within 2e-2 of the reference's (the port's
    # own, on its own bf16 router inputs)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    rl, rm = jax.jit(lambda p, b: ref_model.loss_fn(p, b))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    pl, pm = model.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(rec["agree"]) == 5 * 3 and not rec["ref"]
    assert abs(float(pm["loss"]) - float(rm["loss"])) <= 1e-3 * float(rm["loss"])
    assert 0 < float(pm["aux_loss"]) and \
        abs(float(pm["aux_loss"]) - float(rm["aux_loss"])) <= 2e-2 * float(rm["aux_loss"])
    assert float(pl) == float(pm["loss"] + pm["aux_loss"])
    monkeypatch.undo()      # the port's own routing from here on
    kw = dict(slots=B, cache_len=64, k_steps=2)
    prompts = list(toks)
    assert Engine(model, params, paged=True, block_size=16, check_invariants=True,
                  **kw).serve(prompts, gen_tokens=4) == Engine(model, params, **kw).serve(
                      prompts, gen_tokens=4)


# ---------------------------------------------------------------------------
# Quantize
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f32_pair(f32):
    """(reference post, base, port post, base): the fp32 tree and a base one
    1 % of each matrix's std away."""
    cfg, rp, _, _ = f32
    rng = np.random.default_rng(9)

    def perturb(a):
        a = np.asarray(a)
        noise = rng.standard_normal(a.shape) * 0.01 * a.std()
        return jnp.asarray((a + noise).astype(np.float32)) if a.ndim >= 2 else a
    rb = jax.tree.map(perturb, rp)
    return rp, rb, *(params_from_jax(jax.device_get(t)) for t in (rp, rb))


def test_quantize_moe_tree_matches_reference(f32_pair):
    """DAQ storage quantize (blocks of 32) of the reduced fp32 tree: the
    policy skips the router and the norms, and quantizes the dense prefix,
    the attention, the shared expert, the 4-D expert stacks and the
    embedding (ROADMAP Queue C 6)."""
    rp, rb, post, base = f32_pair
    # the port's fused search (its card path; on the CPU the sweep's plain
    # version) against the reference's plain Algorithm 1: both keep the
    # incumbent on ties and argmax integer sign counts
    qt, rep = quantize(post, base, QuantConfig(use_fused_kernel=True, block_size=32),
                       mode="storage")
    rqt, rrep = ref_quantize(rp, rb, RefQuantConfig(block_size=32), mode="storage")
    assert (rep.n_quantized, rep.n_skipped, rep.quantized_bytes, rep.original_bytes) == \
        (rrep.n_quantized, rrep.n_skipped, rrep.quantized_bytes, rrep.original_bytes)
    assert sorted(rep.per_leaf) == sorted(rrep.per_leaf)
    assert {"stack/L0/moe/w_gate", "stack/L0/moe/shared/w_down",
            "prefix/L0/mlp/w_up"} <= set(rep.per_leaf)
    assert not any("router" in k or "norm" in k for k in rep.per_leaf)
    ref_tree = params_from_jax(jax.device_get(rqt))
    lp, lr = list(tree_leaves_with_path(qt)), list(tree_leaves_with_path(ref_tree))
    assert [p for p, _ in lp] == [p for p, _ in lr]
    n_mats = n_exact = 0
    for (path, a), (_, b) in zip(lp, lr):
        name = "/".join(path)
        assert type(a) is type(b), name
        if name not in rep.per_leaf:
            assert a.dtype == b.dtype and torch.equal(a, b), name
            continue
        alpha, ralpha = (np.atleast_1d(np.asarray(r.per_leaf[name]["alpha"]))
                         for r in (rep, rrep))
        assert alpha.shape == ralpha.shape and a.scale.shape == b.scale.shape, name
        np.testing.assert_array_max_ulp(alpha, ralpha, maxulp=1)
        n = alpha.size
        codes = (t.data.view(torch.uint8).reshape(n, -1) for t in (a, b))
        pairs = zip(*codes, a.scale.reshape(n, -1), b.scale.reshape(n, -1),
                    (alpha == ralpha).reshape(-1))
        for qa, qb, sa, sb, exact in pairs:
            if exact:
                n_exact += 1
                assert torch.equal(qa, qb) and torch.equal(sa, sb), name
            else:           # a fine-grid alpha one ulp off (ROADMAP Queue C 4)
                torch.testing.assert_close(sa, sb, rtol=1e-6, atol=0)
                step = (qa.int() - qb.int()).abs()      # E4M3 bits order by magnitude
                assert step.max() <= 1 and (step > 0).float().mean() < 1e-3, name
        n_mats += n
    # 2 + prefix 7 + stack 3 x (4 attention + 3 shared + 3 x 8 experts)
    assert n_mats == 2 + 7 + 3 * (7 + 24) and n_exact >= 0.8 * n_mats, n_exact   # 87 of 102


def test_quantize_on_two_subtrees_equals_the_whole_tree(f32_pair):
    """The split ``chip_smoke.py``'s phase 7k quantizes by: ``{embed,
    final_norm, prefix}`` then ``{stack}``, each keeping its top-level
    keys, gives the whole tree's leaves and per-leaf reports."""
    _, _, post, base = f32_pair
    qcfg = QuantConfig(use_fused_kernel=True, block_size=32)
    whole, rep = quantize(post, base, qcfg, mode="storage")
    first = ("embed", "final_norm", "prefix")
    q1, r1 = quantize({k: post[k] for k in first}, {k: base[k] for k in first}, qcfg,
                      mode="storage")
    q2, r2 = quantize({"stack": post["stack"]}, {"stack": base["stack"]}, qcfg,
                      mode="storage")
    split = {**q1, **q2}
    assert sorted(split) == sorted(whole)
    assert sorted({**r1.per_leaf, **r2.per_leaf}) == sorted(rep.per_leaf)
    assert r1.n_quantized + r2.n_quantized == rep.n_quantized
    lw, ls = list(tree_leaves_with_path(whole)), list(tree_leaves_with_path(split))
    assert [p for p, _ in lw] == [p for p, _ in ls]
    for (path, a), (_, b) in zip(lw, ls):
        if isinstance(a, QuantizedTensor):
            assert torch.equal(a.data.view(torch.uint8), b.data.view(torch.uint8)) and \
                torch.equal(a.scale, b.scale), path
            np.testing.assert_array_equal(rep.per_leaf["/".join(path)]["alpha"],
                                          {**r1.per_leaf, **r2.per_leaf}["/".join(path)]["alpha"])
        else:
            assert torch.equal(a, b), path


def _stored(shape, gran, bs, seed, eq=False):
    """A stacked QuantizedTensor of random E4M3 codes and positive scales."""
    g = torch.Generator().manual_seed(seed)
    *lead, I, O = shape
    data = (torch.randn(shape, generator=g) * 100).clamp(-448, 448).to(torch.float8_e4m3fn)
    sshape = {"block": (*lead, -(-I // bs), 1, -(-O // bs), 1), "channel": (*lead, 1, O),
              "tensor": tuple(lead)}[gran]
    scale = torch.rand(sshape, generator=g) * 1e-2 + 1e-4
    e = torch.rand((*lead, I), generator=g) + 0.5 if eq else None
    return QuantizedTensor(data=data, scale=scale, granularity=gran, block_size=bs,
                           out_dtype="float32", eq_scale=e)


@pytest.mark.parametrize("shape,gran,bs,eq", [
    ((2, 3, 64, 96), "block", 32, False),       # the expert stacks' path
    ((3, 64, 96), "block", 32, False),
    ((2, 3, 40, 72), "block", 32, False),       # ragged: on its padded grid
    ((2, 3, 64, 96), "channel", 32, False),
    ((2, 64, 96), "block", 32, True)], ids=["4d", "3d", "ragged", "channel", "equalized"])
def test_stacked_dequantize_bits_unchanged(shape, gran, bs, eq):
    """A stacked leaf dequantizes into one preallocated output: the bits of
    each matrix's plain fp32 product stacked, in float32 and straight
    to bf16 (``qlinear.resolve_as``: the fp32 values rounded once), and
    ``quantize(mode="dequant")``'s stacked output the same way."""
    qt = _stored(shape, gran, bs, seed=len(shape) + bs, eq=eq)
    flat_q = qt.data.reshape(-1, *shape[-2:])
    flat_s = qt.scale.reshape(flat_q.shape[0], *qt.scale.shape[len(shape) - 2:])
    flat_e = None if qt.eq_scale is None else qt.eq_scale.reshape(flat_q.shape[0], -1)

    def old(i):
        """The matrix's codes times its scales in fp32 (divided by its
        equalization vector), written out plainly."""
        q, (I, O) = flat_q[i].float(), shape[-2:]
        if gran == "block":
            qp = torch.nn.functional.pad(q, (0, -O % bs, 0, -I % bs))
            w = (qp.reshape(qp.shape[0] // bs, bs, qp.shape[1] // bs, bs) * flat_s[i]) \
                .reshape(qp.shape)[:I, :O]
        else:
            w = q * flat_s[i]
        return w if flat_e is None else w / flat_e[i][:, None]
    want = torch.stack([old(i) for i in range(flat_q.shape[0])]).reshape(shape)
    got = qt.dequantize()
    assert got.dtype == torch.float32 and torch.equal(got.view(torch.int32),
                                                      want.view(torch.int32))
    b = qlinear.resolve_as(qt, torch.bfloat16)
    assert b.dtype == torch.bfloat16 and torch.equal(b.view(torch.int16),
                                                     want.bfloat16().view(torch.int16))


def test_dequant_mode_stacked_output_bits_unchanged(f32_pair):
    """``quantize(mode="dequant")`` of the 4-D expert stacks equals the
    storage tree dequantized matrix by matrix, bit for bit."""
    _, _, post, base = f32_pair
    sub = lambda t: {"stack": {"L0": {"moe": {"w_up": t["stack"]["L0"]["moe"]["w_up"]}}}}
    qcfg = QuantConfig(use_fused_kernel=True, block_size=32)
    deq, _ = quantize(sub(post), sub(base), qcfg, mode="dequant", out_dtype="bfloat16")
    store, _ = quantize(sub(post), sub(base), qcfg, mode="storage")
    qt = store["stack"]["L0"]["moe"]["w_up"]
    want = torch.stack([torch.stack([dequantize_stored(qt.data[i, e], qt.scale[i, e], "block",
                                                       get_format(qt.fmt), 32, torch.bfloat16)
                                     for e in range(qt.shape[1])])
                        for i in range(qt.shape[0])])
    got = deq["stack"]["L0"]["moe"]["w_up"]
    assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16),
                                                       want.view(torch.int16))


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------

def _held(model, params, prompt, continuation) -> int:
    """How many leading greedy steps of ``continuation`` (teacher-forced
    through the port's model) have a top-2 logit gap above ``TOL`` of
    max|logit|: the tokens defined across frameworks."""
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None]})
    for n, tok in enumerate(continuation):
        lf = logits.float()[0]
        top = torch.topk(lf, 2).values
        if float(top[0] - top[1]) <= TOL * float(lf.abs().max()):
            return n
        logits, cache = model.decode_step(params, torch.tensor([[tok]], dtype=torch.int32),
                                          cache)
    return len(continuation)


def test_moe_engine_matches_reference_engine_and_host_loop(bf16):
    """Four prompts of two lengths: one prefill call per length (MoE is
    not ``_can_pad``: pad tokens would join the capacity-limited routing),
    each group's dense-prefix K/V scattered into its slots with the
    stack's; tokens equal to the reference engine's and to the host
    loop's."""
    ref_model, rp, model, params = bf16
    prompts = [_prompt(s, L) for s, L in PROMPTS]
    eng = Engine(model, params, slots=4, cache_len=64, k_steps=3)
    assert not eng._can_pad and eng._prefill_groups(LENS) == [[0, 2], [1, 3]]
    outs, stats = eng.serve(prompts, gen_tokens=6, return_stats=True)
    assert stats["prefill_calls"] == 2 and stats["tokens"] == 24
    h = model.cfg
    assert stats["cache_bytes"] == h.n_layers * 2 * 4 * 64 * h.n_kv_heads \
        * h.resolved_head_dim * 2 + 4 * 4
    ref_out = RefEngine(ref_model, rp, slots=4, cache_len=64, k_steps=3).serve(
        [jnp.asarray(p) for p in prompts], gen_tokens=6)
    # tokens are defined across frameworks up to the first step whose
    # top-2 margin is within the bf16 rule (routing flips included)
    held = 0
    for p, out, ref in zip(prompts, outs, ref_out):
        ref = list(map(int, ref))
        n = _held(model, params, p, ref)
        assert out[:n] == ref[:n]
        held += n
    assert held >= 12, held      # 14 of 24 at these draws
    assert outs == serve_host_loop(model, params, prompts, batch=4, gen_tokens=6, cache_len=64)


@pytest.fixture(scope="module")
def dropless(bf16):
    """The bf16 model at the least dropless capacity factor (``n_experts /
    top_k``; the weights do not depend on it) and its contiguous engine's
    tokens for the four prompts."""
    model, params = bf16[2], bf16[3]
    cfg = model.cfg
    m = build_model(dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k),
                    device="cpu")
    prompts = [_prompt(s, L) for s, L in PROMPTS]
    return m, Engine(m, params, slots=2, cache_len=64, k_steps=4).serve(prompts,
                                                                        gen_tokens=4)


@pytest.mark.parametrize("kw", [dict(paged=True), dict(paged=True, chunk_size=16),
                                dict(paged=True, prefix_cache=True),
                                dict(paged=True, n_spec=2)],
                         ids=["paged", "chunked", "prefix", "spec"])
def test_moe_refuses_the_paged_engines(bf16, dropless, kw):
    """The paged, chunked and prefix-cached engines take the MoE stack at
    its config's capacity (paged == contiguous there is
    ``test_bf16_model_prefill_and_decode_match_reference``'s); at the
    dropless capacity (``capacity_factor = n_experts / top_k``) every mode
    gives the contiguous engine's tokens, and speculation is refused below
    it with the reference engine's message."""
    ref_model, rp, model, params = bf16
    extra = {"draft_params": params} if kw.get("n_spec") else {}
    prompts = [_prompt(s, L) for s, L in PROMPTS]
    base = dict(slots=2, cache_len=64, k_steps=4, block_size=16)
    if kw.get("n_spec"):
        msgs = []
        for eng, m, p in ((RefEngine, ref_model, rp), (Engine, model, params)):
            with pytest.raises(ValueError, match="routes MoE dropless") as e:
                eng(m, p, draft_params=p, **base, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    else:
        assert Engine(model, params, **base, **kw).cfg.paged
    m, contiguous = dropless
    assert Engine(m, params, check_invariants=True, **base, **kw, **extra).serve(
        prompts, gen_tokens=4) == contiguous


def test_cli_serves_moe_on_the_contiguous_engine_and_refuses_paged(capsys):
    """The contiguous serve; ``--paged --prefix-cache`` serves too (the warm
    index is per engine: no hits across CLI runs), ``--spec-draft`` at the
    config's capacity exits with the engine's dropless message, and the
    calibrated methods exit before any weights are made."""
    from repro_torch.launch import serve as cli
    argv = ["--arch", "deepseek-v3", "--reduced", "--device", "cpu", "--requests", "3",
            "--batch", "2", "--prompt-len", "20", "--gen", "4", "--k-steps", "2"]
    outs, stats = cli.main(argv)
    assert "contiguous cache" in capsys.readouterr().out
    assert len(outs) == 3 and all(len(o) == 4 and all(0 <= t < 512 for t in o) for o in outs)
    assert stats["prefill_calls"] == 2
    capsys.readouterr()
    outs, stats = cli.main(argv + ["--paged", "--prefix-cache"])
    assert "paged" in capsys.readouterr().out
    assert len(outs) == 3 and all(len(o) == 4 for o in outs)
    assert stats["counters"]["tokens"] == 12 and stats["chunk_dispatches"] > 0
    with pytest.raises(SystemExit, match="deepseek-v3-smoke: speculative verify routes MoE "
                                         "dropless.*capacity_factor 1.25"):
        cli.main(argv + ["--paged", "--spec-draft", "daq", "--n-spec", "1"])
    for method in ("smoothquant", "awq"):   # refused before any weights are made
        with pytest.raises(SystemExit, match=f"deepseek-v3-smoke: --method {method} .*Queue A 5"):
            cli.main(argv + ["--daq", "--method", method])
