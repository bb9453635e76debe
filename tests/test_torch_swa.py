"""Sliding-window attention in repro_torch against the JAX reference on the
CPU: ring caches on the dense stack (reduced GLM-4-9B with a window of 16)
and on Mixtral 8x22B (reduced: window 16, 8 experts, top-2), served by the
contiguous, paged, chunked, prefix-cached and speculative engines.  Inputs
are numpy draws from fixed seeds, carried to the port by ``params_from_jax``.

Tolerances, and what sets them:

* Ring prefill and decode of the dense stack: the cache keeps ``W`` rows
  (the reference's shape); every step's logits within 2e-2 of the logit
  scale of the reference's (the port's bf16 rule, ``tests/test_torch_model.py``).
  Inside the port the ring gives the bits of a linear cache read through
  the window mask, step for step.
* Mixtral's float32 stack on fp32 activations (embedding rows fed straight
  into the layer functions ``Model.prefill`` / ``decode_step`` run), a
  prompt past the window and decode steps that wrap the ring: every
  routing call's dispatch equal, logits within 1e-3 of the logit scale
  (the reference casts the expert outputs and the combine weights to bf16:
  ``tests/test_torch_moe.py``).
* Mixtral on the contiguous and the paged engine: greedy tokens equal the
  reference engine's up to each request's first step whose top-2 margin is
  within 2e-2 of the logit scale (bf16 noise also flips a few top-2
  routing choices between the frameworks: ``tests/test_torch_moe.py``), at
  least ``HELD`` of them.
* Inside the port, exact: the paged, chunked (== one-shot), prefix-cached
  (warm == cold, zero prefix hits: ring blocks are keyed by position) and
  speculative (== non-speculative) engines give the contiguous engine's
  tokens, token for token, with conservation checked after every admission
  and dispatch.
* The refusals: the reference's three sliding-window messages, word for
  word.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.engine import Engine as RefEngine
from repro.models import build_model as ref_build_model
from repro.models import lm as RL
from repro.models import moe as RM
from repro.models.common import apply_norm as ref_apply_norm
from repro.models.common import lm_logits as ref_lm_logits
from repro_torch.compat import params_from_jax
from repro_torch.configs import get_arch, reduced
from repro_torch.engine import Engine
from repro_torch.engine.engine import EngineConfig, check_config
from repro_torch.models import build_model
from repro_torch.models import lm as TL
from repro_torch.models import moe as TM
from repro_torch.models.common import apply_norm, embed_tokens, last_token_logits, lm_logits

TOL = 2e-2
W = 16
HELD = 20       # of the 32 greedy tokens defined across frameworks (20 at these draws)
# the reference's ring cases (tests/test_engine_paged.py, test_engine_prefix.py):
# prompt lengths and cache_len; 8 tokens each, so the decode of 9 and of 14
# wraps the ring (21 is prefilled past it)
LENS, CACHE_LEN, GEN, CHUNK = [9, 21, 9, 14], 34, 8, 8
PROMPTS = [np.random.default_rng(90 + i).integers(0, 512, L).astype(np.int32)
           for i, L in enumerate(LENS)]
# every engine of the file: two slots, so the 9-token prompts prefill in two
# admissions; blocks of 8 page the ring of 16
KW = dict(slots=2, cache_len=CACHE_LEN, k_steps=4)
MODES = {"paged": dict(paged=True), "chunked": dict(paged=True, chunk_size=CHUNK),
         "prefix": dict(paged=True, chunk_size=CHUNK, prefix_cache=True),
         "spec": dict(paged=True, n_spec=3)}


def _ref_params(cfg, seed):
    """Fan-in scaled normal matrices (expert stacks by their in-dim), norms
    near 1."""
    shapes = jax.eval_shape(ref_build_model(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) >= 2:
            a = rng.standard_normal(s.shape) * s.shape[-2] ** -0.5
        else:
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        return jnp.asarray(a.astype(np.float32)).astype(s.dtype)
    return jax.tree.map(draw, shapes)


def _pair(name, seed, **kw):
    """(reference model, its params, port model, its params)."""
    cfg = dataclasses.replace(ref_reduced(ref_get_arch(name)), **kw)
    rp = _ref_params(cfg, seed)
    model = build_model(dataclasses.replace(reduced(get_arch(name)), **kw), device="cpu")
    return ref_build_model(cfg), rp, model, params_from_jax(jax.device_get(rp))


@pytest.fixture(scope="module")
def mixtral():
    """Reduced Mixtral at capacity factor 8 (dropless: 8 * top-2 >= 8
    experts), with a draft for speculation: the weights with 5 % seeded
    multiplicative noise, which agrees with them on about half its tokens,
    so the rounds both accept and roll back."""
    ref_model, rp, model, params = _pair("mixtral-8x22b", 0, capacity_factor=8.0)
    rng = np.random.default_rng(5)
    noisy = jax.tree.map(lambda a: (a.astype(jnp.float32) * (1 + 0.05 * jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)))).astype(a.dtype), rp)
    return ref_model, rp, model, params, params_from_jax(jax.device_get(noisy))


@pytest.fixture(scope="module")
def contiguous(mixtral):
    """The port's contiguous engine's tokens and stats for ``PROMPTS``."""
    model, params = mixtral[2], mixtral[3]
    return Engine(model, params, **KW).serve(PROMPTS, gen_tokens=GEN, return_stats=True)


@pytest.fixture(scope="module")
def served(mixtral):
    """Each mode's serves of ``PROMPTS``, once per module (the reference
    comparison and the in-port one read the same paged serve):
    ``served(mode)`` -> [(outputs, stats, blocks the index holds after)]
    for one serve, or a cold and a warm one of a prefix-cached engine."""
    model, params, draft = mixtral[2], mixtral[3], mixtral[4]
    done = {}

    def get(mode):
        if mode not in done:
            kw = dict(KW, block_size=8, check_invariants=True, **MODES[mode])
            eng = Engine(model, params, draft_params=draft if kw.get("n_spec") else None, **kw)
            done[mode] = [(*eng.serve(PROMPTS, gen_tokens=GEN, return_stats=True),
                           set(eng._hold_blocks))
                          for _ in range(2 if kw.get("prefix_cache") else 1)]
        return done[mode]

    return get


@pytest.fixture(scope="module")
def held_steps(mixtral):
    """``_held`` of each (prompt, reference continuation), once per module."""
    model, params = mixtral[2], mixtral[3]
    done = {}

    def get(prompt, continuation):
        key = (bytes(prompt), tuple(continuation))
        if key not in done:
            done[key] = _held(model, params, prompt, continuation)
        return done[key]

    return get


def _logits_close(port, ref):
    p, r = port.float().numpy(), np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert np.abs(p - r).max() <= TOL * np.abs(r).max()


def _held(model, params, prompt, continuation) -> int:
    """How many leading greedy steps of ``continuation`` (teacher-forced
    through the port's model, ring cache) have a top-2 logit gap above
    ``TOL`` of max|logit|: the tokens defined across frameworks."""
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None]},
                                  cache_len=CACHE_LEN)
    for n, tok in enumerate(continuation):
        lf = logits.float()[0]
        top = torch.topk(lf, 2).values
        if float(top[0] - top[1]) <= TOL * float(lf.abs().max()):
            return n
        logits, cache = model.decode_step(params, torch.tensor([[tok]], dtype=torch.int32),
                                          cache)
    return len(continuation)


def test_mixtral_config_matches_reference():
    """The port's Mixtral 8x22B is the reference's, field for field (full
    and reduced); a model of it builds without allocating, its 56 layers
    hold 140.6 B parameters, 4 of them 10.42 B."""
    for port, ref in ((get_arch("mixtral-8x22b"), ref_get_arch("mixtral-8x22b")),
                      (reduced(get_arch("mixtral-8x22b")),
                       ref_reduced(ref_get_arch("mixtral-8x22b")))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    cfg = get_arch("mixtral-8x22b")
    assert build_model(cfg, device="cpu").groups == [("stack", ("attn", "moe"), 56)]
    assert round(cfg.param_count() / 1e9, 1) == 140.6
    assert round(dataclasses.replace(cfg, n_layers=4).param_count() / 1e9, 2) == 10.42
    assert reduced(cfg).sliding_window == W


def test_dense_ring_prefill_and_decode_match_reference():
    """A 25-token prompt (``W + 9``, past the window) into a ring of ``W``
    rows, then 12 decode steps (the ring wraps again at 32): the cache
    shape, each step's logits against the reference's, and the port's ring
    against the port's own linear cache of 37 rows under the window mask,
    bit for bit."""
    ref_model, rp, model, params = _pair("glm4-9b", 3, sliding_window=W)
    cfg = model.cfg
    B, total, steps = 3, W + 9, 12
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, total + steps))
    toks = toks.astype(np.int32)
    rprefill = jax.jit(ref_model.prefill, static_argnames="cache_len")
    rdecode = jax.jit(ref_model.decode_step)
    rl, rcache = rprefill(rp, {"tokens": jnp.asarray(toks[:, :total])}, cache_len=W)
    assert rcache["stack"]["L0"]["k"].shape[2] == W
    t = torch.from_numpy(toks)
    la, ring = model.prefill(params, {"tokens": t[:, :total]}, cache_len=W)
    assert ring["stack"]["L0"]["k"].shape == tuple(rcache["stack"]["L0"]["k"].shape)
    # the linear cache, filled by the same layer functions Model.prefill runs
    L = total + steps
    lin = {"stack": {"L0": {k: torch.zeros((cfg.n_layers, B, L, cfg.n_kv_heads,
                                            cfg.resolved_head_dim), dtype=torch.bfloat16)
                            for k in ("k", "v")}},
           "lengths": torch.full((B,), total, dtype=torch.int32)}
    x = embed_tokens(params["embed"], t[:, :total])
    for i in range(cfg.n_layers):
        x = TL.apply_layer_prefill(TL.layer_view(params["stack"]["L0"], i), x,
                                   TL.layer_view(lin["stack"]["L0"], i), cfg, model.spec)
    lb = last_token_logits(params["embed"], apply_norm(params["final_norm"], x, cfg.norm_eps),
                           None)
    assert torch.equal(la, lb)
    _logits_close(la, rl)
    for s in range(steps):
        nxt = toks[:, total + s:total + s + 1]
        rl, rcache = rdecode(rp, jnp.asarray(nxt), rcache)
        la, ring = model.decode_step(params, torch.from_numpy(nxt), ring)
        lb, lin = model.decode_step(params, torch.from_numpy(nxt), lin)
        assert torch.equal(la, lb), s
        _logits_close(la, rl)
    assert int(ring["lengths"][0]) == L


def test_mixtral_float32_ring_matches_reference(monkeypatch):
    """The reduced float32 Mixtral on fp32 activations: ``apply_layer_prefill``
    over a 21-token prompt into a ring of ``W`` rows, then 12
    ``apply_layer_decode`` steps (the ring wraps at 32), against the
    reference's ``run_stack_prefill`` / ``run_stack_decode``: every routing
    call's dispatch equal, every step's logits within 1e-3."""
    ref_model, rp, model, params = _pair("mixtral-8x22b", 1, capacity_factor=8.0,
                                         dtype="float32")
    cfg, rcfg = model.cfg, ref_model.cfg
    rec = {"ref": [], "port": []}
    ref_fn, port_fn = RM.top_k_routing, TM.top_k_routing

    def ref_wrapped(logits, k, cap):
        out = ref_fn(logits, k, cap)
        jax.debug.callback(lambda d: rec["ref"].append(np.array(d)), out[0].astype(jnp.float32),
                           ordered=True)
        return out

    def port_wrapped(logits, k, cap):
        out = port_fn(logits, k, cap)
        rec["port"].append(out[0].float().numpy())
        return out
    monkeypatch.setattr(RM, "top_k_routing", ref_wrapped)
    monkeypatch.setattr(TM, "top_k_routing", port_wrapped)
    B, S, steps = 2, 21, 12
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, S + steps)).astype(np.int32)
    table, ttable = rp["embed"]["embed"], params["embed"]["embed"]
    specs = RL.layer_plan(rcfg)[2]
    prefill = jax.jit(lambda st, a: RL.run_stack_prefill(st, a, rcfg, specs, cache_len=W))
    decode = jax.jit(lambda st, c, a, n: RL.run_stack_decode(st, c, a, n, rcfg, specs))

    def ref_logits(x):
        return ref_lm_logits(rp["embed"], ref_apply_norm(rp["final_norm"], x, rcfg.norm_eps))

    def port_logits(x):
        return lm_logits(params["embed"], apply_norm(params["final_norm"], x, cfg.norm_eps))

    def close(port, ref):
        p, r = port.numpy(), np.asarray(ref)
        assert np.abs(p - r).max() <= 1e-3 * np.abs(r).max()

    xr, rcache = prefill(rp["stack"], table[toks[:, :S]])
    cache = model.init_cache(B, CACHE_LEN)
    assert cache["stack"]["L0"]["k"].shape[2] == W
    x = ttable[torch.from_numpy(toks[:, :S]).long()]
    layers = [(TL.layer_view(params["stack"]["L0"], i), TL.layer_view(cache["stack"]["L0"], i))
              for i in range(cfg.n_layers)]
    for lp, lc in layers:
        x = TL.apply_layer_prefill(lp, x, lc, cfg, model.spec)
    assert x.dtype == torch.float32
    close(port_logits(x[:, -1:]), ref_logits(xr[:, -1:]))
    for step in range(steps):
        nxt = toks[:, S + step:S + step + 1]
        xr, rcache = decode(rp["stack"], rcache, table[nxt], jnp.full((B,), S + step, jnp.int32))
        x = ttable[torch.from_numpy(nxt).long()]
        for lp, lc in layers:
            x = TL.apply_layer_decode(lp, x, lc, torch.full((B,), S + step, dtype=torch.int32),
                                      cfg, model.spec)
        close(port_logits(x), ref_logits(xr))
    assert len(rec["port"]) == len(rec["ref"]) == cfg.n_layers * (steps + 1)
    for a, b in zip(rec["port"], rec["ref"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_mixtral_engine_matches_reference_engine(mixtral, contiguous, served, held_steps,
                                                 paged):
    """Mixtral's four prompts of three lengths on the contiguous engine (one
    prefill call per length and admission: a ring is not ``_can_pad``) and
    on the paged one (blocks of 8 paging the ring of 16), against the
    reference engine of the same kind: greedy tokens equal while the margin
    allows."""
    ref_model, rp = mixtral[0], mixtral[1]
    kw = dict(KW)
    if paged:
        kw.update(paged=True, block_size=8)
        outs, stats, _ = served("paged")[0]
    else:
        outs, stats = contiguous
    assert stats["prefill_calls"] == len(set(LENS)) + 1   # 9 and 9 in two admissions
    ref_out = RefEngine(ref_model, rp, **kw).serve([jnp.asarray(p) for p in PROMPTS],
                                                    gen_tokens=GEN)
    held = 0
    for p, out, ref in zip(PROMPTS, outs, ref_out):
        ref = list(map(int, ref))
        n = held_steps(p, ref)
        assert out[:n] == ref[:n]
        held += n
    assert held >= HELD, held


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_modes_equal_contiguous(mixtral, contiguous, served, mode):
    """Inside the port every mode's tokens equal the contiguous engine's,
    token for token, with conservation checked after every admission and
    dispatch: paged (a table of ``W / 8`` blocks a slot), chunked (==
    one-shot), prefix-cached cold and warm (warm == cold, zero prefix hits,
    every prompt token prefilled, nothing held by the index), and
    speculative with the noisy draft (== non-speculative; drafted ==
    accepted + rejected, some of each: the two-pass round rolls the ring
    back)."""
    model = mixtral[2]
    kw = MODES[mode]
    cfg = EngineConfig(**KW, block_size=8, **kw)
    eng_mb = Engine(model, mixtral[3], cfg, draft_params=mixtral[4] if cfg.n_spec else None)
    assert eng_mb._mb == W // 8 and not eng_mb._can_match
    for outs, stats, holds in served(mode):
        assert outs == contiguous[0]
        if kw.get("prefix_cache"):
            assert stats["prefix_hits"] == stats["counters"]["prefix_hit_tokens"] == 0
            assert stats["prefill_tokens"] == sum(LENS) and not holds
    if kw.get("n_spec"):
        c = stats["counters"]
        assert c["drafted"] == c["accepted"] + c["rejected"]
        assert c["accepted"] > 0 and c["rejected"] > 0


REFUSALS = {"cache_len": (dict(cache_len=8, paged=True, block_size=8),
                          "cache_len >= sliding_window"),
            "block": (dict(cache_len=34, paged=True, block_size=6),
                      "must divide the sliding window"),
            "n_spec": (dict(cache_len=34, paged=True, block_size=8, n_spec=16, k_steps=17),
                       "must fit inside the sliding window")}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_sliding_window_refusals_equal_reference(mixtral, case):
    """``check_config`` (so ``Engine``) refuses a paged ring shorter than
    the window, blocks that do not divide it and a speculative span that
    wraps it, with the reference engine's messages; ``init_paged_cache``
    refuses the first two with the reference model's."""
    ref_model, rp, model, params, _ = mixtral
    kw, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match) as ref_e:
        RefEngine(ref_model, rp, slots=2, draft_params=rp if "n_spec" in kw else None, **kw)
    with pytest.raises(ValueError, match=match) as e:
        check_config(model.cfg, EngineConfig(slots=2, **kw))
    assert str(e.value) == str(ref_e.value)
    with pytest.raises(ValueError, match=match):
        Engine(model, params, slots=2, draft_params=params if "n_spec" in kw else None, **kw)
    if case != "n_spec":
        geom = dict(block_size=kw["block_size"], num_blocks=8)
        with pytest.raises(ValueError) as ref_e:
            ref_model.init_paged_cache(2, kw["cache_len"], **geom)
        with pytest.raises(ValueError) as e:
            model.init_paged_cache(2, kw["cache_len"], **geom)
        assert str(e.value) == str(ref_e.value)
