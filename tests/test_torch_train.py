"""The training substrate of ``repro_torch`` against the JAX reference.

Model: the reduced GLM-4-9B (4 layers, d_model 64, vocabulary 512) in
float32.  Its activations are bfloat16 in both frameworks
(``models/common.py::ACT_DTYPE``), so everything downstream of a forward is
held to bf16 tolerances.  Tolerances, each measured well inside its bound:

* ``chunked_xent`` (float32 x): loss, accuracy and count within 1e-6
  relative; d(loss)/dx and d(loss)/d(head) within 1e-5 * max|grad|.
* ``Model.loss_fn``: loss within 1e-4 relative (4e-5 measured), accuracy
  and token count equal, every gradient leaf in the reference's stacked
  layout and within 4e-2 * max|grad| of the leaf (the bf16 activations:
  2 % measured).
* one ``adamw_update`` (a reference step compiled with ``jax.jit``, as its
  train step is): weights and moments within 4 ulp (of their dtype) of the
  largest value, int8 moment codes bit-equal, their scales within 2 ulp (XLA
  contracts the moment updates into FMAs, ROADMAP Queue C 20); the
  learning rate within 1e-6 relative (``cos``, Queue C 21) and the gradient
  norm within 1e-5 (the order of its sums).
* ``compress_grads``: codes, compressed grads and residuals bit-equal, and
  ``gq + err'`` within one rounding of ``g + err``.
* three ``make_train_step`` steps from one state on the same numpy
  batches: loss and grad norm within 1e-3 relative (2e-4 measured); the
  three-step update of the whole tree and of each weight matrix within
  0.99 cosine of the reference's (0.998 and 0.996 the least measured;
  biases and norm scales count in the whole only: AdamW normalizes their
  small gradients' rounding noise).
* inside the port, bit for bit: remat ``none`` == ``full`` ==
  ``dots_saveable``, the forward with grad == without, a resumed
  ``train_loop`` == an unbroken one; microbatch 4 against the monolithic
  batch within 1e-4 relative (loss) and 1e-2 * max|grad|.
* ``scores_from_tokens`` against the reference's ``eval_scores`` on the
  reference's own draws: each accuracy within the share of positions whose
  top-2 logit margin is below the bf16 logit tolerance (2e-2 * max|logit|).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.configs import TrainConfig as RefTC
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.data import synthetic as RS
from repro.launch.steps import init_train_state as ref_init_train_state
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import build_model as ref_build_model
from repro.models.common import chunked_xent as ref_chunked_xent
from repro.optim import adamw as RA
from repro.optim import compress as RC
from repro_torch import checkpoint as ckpt
from repro_torch.compat import params_from_jax
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core.policy import tree_leaves_with_path, tree_map
from repro_torch.data import synthetic as TS
from repro_torch.launch import train as T
from repro_torch.launch.steps import _unflatten, init_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.models.common import chunked_xent
from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TC

TCFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)


def _np_batch(seed, B=4, S=64, V=511):
    toks = np.random.RandomState(seed).randint(0, V, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves(tree):
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def _ref_leaves(tree):
    return [np.asarray(leaf) for leaf in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def fp32():
    """The reduced GLM-4-9B in float32 in both frameworks, one init."""
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_arch("glm4-9b")), dtype="float32")
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(dataclasses.replace(reduced(get_arch("glm4-9b")), dtype="float32"),
                        device="cpu")
    return ref_model, ref_params, model, params_from_jax(jax.device_get(ref_params))


def _port_loss_and_grads(model, params, batch, remat="full"):
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    loss, metrics = model.loss_fn(_unflatten(params, leaves), batch, remat=remat)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        torch.autograd.grad(loss, leaves)


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------

def test_chunked_xent_matches_reference():
    rng = np.random.RandomState(1)
    B, S, D, V = 2, 40, 32, 96          # chunk 16: two chunks and a remainder of 8
    x = rng.randn(B, S, D).astype(np.float32)
    head = {"embed": (0.3 * rng.randn(V, D)).astype(np.float32)}
    labels = rng.randint(0, V, size=(B, S)).astype(np.int32)
    labels[0, :5] = -1
    def ref_f(x_, h_):
        loss, acc, n = ref_chunked_xent(h_, x_.astype(jnp.bfloat16), jnp.asarray(labels),
                                        chunk=16)
        return loss, (acc, n)
    (rl, (rc, rn)), (rdx, rdh) = jax.jit(jax.value_and_grad(ref_f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), {"embed": jnp.asarray(head["embed"])})
    xt = torch.from_numpy(x).requires_grad_(True)
    ht = torch.from_numpy(head["embed"]).requires_grad_(True)
    pl, pc, pn = chunked_xent({"embed": ht}, xt.bfloat16(), torch.from_numpy(labels), chunk=16)
    pdx, pdh = torch.autograd.grad(pl, (xt, ht))
    for p, r in ((pl, rl), (pc, rc), (pn, rn)):
        assert abs(p.item() - float(r)) <= 1e-6 * abs(float(r))
    assert float(pn) == 2 * S - 5
    for p, r in ((pdx, rdx), (pdh, rdh["embed"])):
        r = np.asarray(r)
        assert np.abs(p.numpy() - r).max() <= 1e-5 * np.abs(r).max()


def test_loss_fn_and_grads_match_reference(fp32):
    ref_model, ref_params, model, params = fp32
    batch = _np_batch(0)
    f = jax.value_and_grad(lambda p, b: ref_model.loss_fn(p, b, remat="full"), has_aux=True)
    (rl, rm), rg = jax.jit(f)(ref_params, _j(batch))
    pl, pm, pg = _port_loss_and_grads(model, params, _t(batch))
    assert abs(float(pl) - float(rl)) <= 1e-4 * abs(float(rl))
    assert float(pm["n_tokens"]) == float(rm["n_tokens"]) == 4 * 64
    assert float(pm["accuracy"]) == float(rm["accuracy"]) and float(pm["aux_loss"]) == 0.0
    ref_paths = ["/".join(str(k.key) for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(rg)[0]]
    assert ref_paths == ["/".join(p) for p, _ in tree_leaves_with_path(params)]
    for name, r, p in zip(ref_paths, _ref_leaves(rg), pg):
        assert p.shape == r.shape, name
        assert np.abs(p.numpy() - r).max() <= 4e-2 * np.abs(r).max(), name


def test_remat_policies_and_grad_mode_agree_bit_for_bit(fp32):
    *_, model, params = fp32
    batch = _t(_np_batch(2))
    base_loss, base_m, base_g = _port_loss_and_grads(model, params, batch, remat="none")
    for remat in ("full", "dots_saveable"):
        loss, m, g = _port_loss_and_grads(model, params, batch, remat=remat)
        assert torch.equal(loss, base_loss) and torch.equal(m["accuracy"], base_m["accuracy"])
        assert all(torch.equal(a, b) for a, b in zip(g, base_g)), remat
    with torch.no_grad():
        loss, _ = model.loss_fn(params, batch)
    assert torch.equal(loss, base_loss)


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

def _opt_tree(dtype, seed):
    rng = np.random.RandomState(seed)
    tree = {"e": rng.randn(20, 40), "layer": {"norm": 1 + 0.1 * rng.randn(300),
                                               "w": 0.1 * rng.randn(3, 16, 300)}}
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32).astype(dtype), tree)


def _ulps(a, b, like):
    """max |a - b| in ulps (of ``like``'s dtype: float32 or bfloat16) of
    max|like|."""
    top = np.float32(np.abs(np.asarray(like, np.float32)).max())
    ulp = np.spacing(top) * (2.0 ** 16 if like.dtype == jnp.bfloat16 else 1.0)
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / ulp)


@pytest.mark.parametrize("param_dtype,opt_dtype", [("float32", "float32"),
                                                    ("bfloat16", "bfloat16"),
                                                    ("bfloat16", "int8")])
def test_adamw_update_matches_reference(param_dtype, opt_dtype):
    ref_tc = RefTC(**TCFG, opt_state_dtype=opt_dtype)
    tc = TrainConfig(**TCFG, opt_state_dtype=opt_dtype)
    params = _opt_tree(jnp.dtype(param_dtype), 0)
    update = jax.jit(lambda p, g, s: RA.adamw_update(p, g, s, ref_tc))
    # step 1 from the reference's zero state, then compare the port's step 2
    # from the reference's state (nonzero moments; gradient norms below the
    # clip, so both clip factors are exactly 1)
    g1 = jax.tree.map(lambda p: 0.004 * jnp.asarray(
        np.random.RandomState(1).randn(*p.shape), p.dtype), params)
    params, state, _ = update(params, g1, RA.init_opt_state(params, ref_tc))
    g2 = jax.tree.map(lambda p: 0.004 * jnp.asarray(
        np.random.RandomState(2).randn(*p.shape), p.dtype), params)
    p_in, g_in, s_in = (params_from_jax(jax.device_get(t)) for t in (params, g2, state))
    ref_p, ref_s, ref_stats = update(params, g2, state)
    new_p, new_s, stats = TA.adamw_update(p_in, g_in, s_in, tc)
    assert int(new_s["step"]) == int(ref_s["step"]) == 2
    for k, rtol in (("lr", 1e-6), ("grad_norm", 1e-5)):
        assert abs(float(stats[k]) - float(ref_stats[k])) <= rtol * abs(float(ref_stats[k]))
    assert float(ref_stats["grad_norm"]) < 1.0
    for (path, p), r in zip(tree_leaves_with_path(new_p), _ref_leaves(ref_p)):
        assert p.dtype == getattr(torch, param_dtype)
        assert _ulps(p.float().numpy(), r.astype(np.float32), r) <= 4, path
    if param_dtype != "float32":
        for p, r in zip(_leaves(new_s["master"]), _ref_leaves(ref_s["master"])):
            assert _ulps(p.numpy(), r, r) <= 4
    for (path, s), r in zip(tree_leaves_with_path(new_s["mu"]), _ref_leaves(ref_s["mu"])):
        if path[-1] in ("m", "v") and opt_dtype == "int8":
            assert s.dtype == torch.int8 and np.array_equal(s.numpy(), r), path
        elif path[-1].endswith("_scale"):
            assert _ulps(s.numpy(), r, r) <= 2, path
        else:
            assert s.dtype == getattr(torch, opt_dtype)
            assert _ulps(s.float().numpy(), r.astype(np.float32), r) <= 4, path


def test_lr_schedule_matches_reference():
    """Every step of three schedules within 2e-7 of the peak rate: XLA's and
    torch's float32 ``cos`` differ by an ulp on some inputs, which the
    schedule's ``0.1 + 0.9 cos`` magnifies to 8 ulp of the value near its
    end (ROADMAP Queue C 21)."""
    for warm, total in ((5, 60), (0, 10), (30, 600)):
        tc = TrainConfig(learning_rate=3e-4, warmup_steps=warm, total_steps=total)
        ref_tc = RefTC(learning_rate=3e-4, warmup_steps=warm, total_steps=total)
        f = jax.jit(lambda s: RA.lr_schedule(ref_tc, s))
        for step in range(0, total + 5):
            r = float(f(jnp.int32(step)))
            p = float(TA.lr_schedule(tc, torch.tensor(step, dtype=torch.int32)))
            assert abs(p - r) <= 2e-7 * tc.learning_rate, (warm, total, step, p, r)


def test_compress_grads_matches_reference_bit_for_bit():
    rng = np.random.RandomState(3)
    grads = {"a": rng.randn(37, 53).astype(np.float32),
             "b": {"c": (1e-3 * rng.randn(700)).astype(np.float32)}}
    err = jax.tree.map(lambda g: (0.01 * rng.randn(*g.shape)).astype(np.float32), grads)
    rq, re = jax.jit(RC.compress_grads)(grads, err)
    g_t, e_t = params_from_jax(grads), params_from_jax(err)
    pq, pe = TC.compress_grads(g_t, e_t)
    for p, r in zip(_leaves(pq) + _leaves(pe), _ref_leaves(rq) + _ref_leaves(re)):
        assert np.array_equal(p.numpy(), r)
    for g, e in zip(_leaves(g_t), _leaves(e_t)):
        codes, _ = TC._q(g + e)
        ref_codes, _ = jax.jit(RC._q)(jnp.asarray((g + e).numpy()))
        assert np.array_equal(codes.numpy(), np.asarray(ref_codes))
    for q, e2, g, e in zip(_leaves(pq), _leaves(pe), _leaves(g_t), _leaves(e_t)):
        total = (g + e).numpy()
        assert np.all(np.abs((q + e2).numpy() - total) <= np.spacing(np.abs(total)))
    assert TC.init_error_state(g_t)["a"].abs().sum() == 0


# ---------------------------------------------------------------------------
# The train step, the loop and the train state
# ---------------------------------------------------------------------------

def test_three_train_steps_match_reference(fp32):
    ref_model, _, model, _ = fp32
    ref_tc, tc = RefTC(**TCFG), TrainConfig(**TCFG)
    ref_state = ref_init_train_state(ref_model, ref_tc, jax.random.PRNGKey(3))
    state = params_from_jax(jax.device_get(ref_state))          # one state for both
    start = [p.clone() for p in _leaves(state["params"])]
    ref_step, step = jax.jit(ref_make_train_step(ref_model, ref_tc)), make_train_step(model, tc)
    for t in range(3):
        batch = _np_batch(10 + t)
        ref_state, rm = ref_step(ref_state, _j(batch))
        state, pm = step(state, _t(batch))
        for k in ("loss", "grad_norm"):
            assert abs(float(pm[k]) - float(rm[k])) <= 1e-3 * abs(float(rm[k])), (t, k)
        assert all(v.device.type == "cpu" and isinstance(v, torch.Tensor) for v in pm.values())
    assert int(state["opt"]["step"]) == 3
    # biases and norm scales count in the whole tree only: AdamW normalizes
    # their small gradients' rounding noise into full-size steps (a key
    # bias's gradient is nothing but noise: the softmax cancels it)
    cosine = lambda a, b: a @ b / np.linalg.norm(a) / np.linalg.norm(b)
    whole = ([], [])
    for (path, p), p0, r in zip(tree_leaves_with_path(state["params"]), start,
                                _ref_leaves(ref_state["params"])):
        dp, dr = (p - p0).double().numpy().ravel(), (r - p0.numpy()).ravel()
        whole[0].append(dp)
        whole[1].append(dr)
        if path[-1].startswith("w") or path[-1] == "embed":
            assert cosine(dp, dr) >= 0.99, (path, cosine(dp, dr))
    assert cosine(np.concatenate(whole[0]), np.concatenate(whole[1])) >= 0.99


def test_microbatches_match_the_monolithic_batch(fp32):
    *_, model, params = fp32
    batch = _t(_np_batch(4, B=8))
    tc = TrainConfig(**TCFG)
    outs = []
    for micro in (0, 4):
        state = {"params": tree_map(lambda t: t.clone(), params),
                 "opt": TA.init_opt_state(params, tc)}
        step = make_train_step(model, dataclasses.replace(tc, microbatch=micro))
        grads, metrics = None, None
        real = TA.adamw_update

        def spy(p, g, s, c):
            nonlocal grads
            grads = [x.clone() for x in _leaves(g)]
            return real(p, g, s, c)
        import repro_torch.launch.steps as steps_mod
        steps_mod.adamw_update = spy
        try:
            _, metrics = step(state, batch)
        finally:
            steps_mod.adamw_update = real
        outs.append((metrics, grads))
    (m0, g0), (m4, g4) = outs
    assert abs(float(m4["loss"]) - float(m0["loss"])) <= 1e-4 * float(m0["loss"])
    for a, b in zip(g4, g0):
        assert a.dtype == torch.float32
        assert (a - b).abs().max() <= 1e-2 * b.abs().max()


def test_train_loop_resumes_bit_for_bit(tmp_path, monkeypatch):
    model = build_model(reduced(get_arch("glm4-9b")), device="cpu")
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=6)
    kw = dict(batch_size=2, seq=32, steps=6, save_every=2, log_every=3)
    clean = T.train_loop(model, tc, ckpt_dir=str(tmp_path / "a"), **kw)
    calls = {"n": 0}
    real = T.train_batch

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("injected node failure")
        return real(*a, **k)
    monkeypatch.setattr(T, "train_batch", flaky)
    resumed = T.train_loop(model, tc, ckpt_dir=str(tmp_path / "b"), **kw)
    assert calls["n"] == 3 + 1 + 4     # steps 0-2, the failure, steps 2-5 from step 2's save
    for a, b in zip(_leaves(clean["state"]), _leaves(resumed["state"])):
        assert torch.equal(a, b)
    assert resumed["metrics"] == clean["metrics"]
    assert ckpt.all_steps(str(tmp_path / "b")) == [2, 4, 6]
    assert ckpt.meta(str(tmp_path / "b"), 6)["meta"] == {"arch": model.cfg.name, "final": True}
    assert os.path.exists(tmp_path / "b" / "heartbeat.json")


def test_train_state_checkpoint_restores_in_the_reference(tmp_path):
    """A bf16 train state with int8 moments and error feedback, two steps
    in: the reference's ``checkpoint.restore`` reads every leaf bit-equal."""
    cfg = reduced(get_arch("glm4-9b"))
    model = build_model(cfg, device="cpu")
    tc = TrainConfig(**TCFG, opt_state_dtype="int8", grad_compress="int8_ef")
    state = init_train_state(model, tc, torch.Generator().manual_seed(0))
    step = make_train_step(model, tc)
    for t in range(2):
        state, _ = step(state, _t(_np_batch(20 + t, B=2, S=32)))
    ckpt.save(str(tmp_path), 2, state)
    ref_model = ref_build_model(ref_reduced(ref_get_arch("glm4-9b")))
    ref_tc = RefTC(**TCFG, opt_state_dtype="int8", grad_compress="int8_ef")
    like = jax.eval_shape(lambda k: ref_init_train_state(ref_model, ref_tc, k),
                          jax.random.PRNGKey(0))
    restored = ref_ckpt.restore(str(tmp_path), 2, like)
    back = params_from_jax(jax.device_get(restored))
    assert [p for p, _ in tree_leaves_with_path(back)] == \
        [p for p, _ in tree_leaves_with_path(state)]
    for (path, a), b in zip(tree_leaves_with_path(state), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


# ---------------------------------------------------------------------------
# Data and scores
# ---------------------------------------------------------------------------

def test_train_batch_is_a_pure_function_of_seed_step_host():
    spec = TS.LanguageSpec(vocab=128, hard_style=True)
    a = TS.train_batch(spec, 0, 5, 6, 24, style="mixed", device="cpu")
    b = TS.train_batch(spec, 0, 5, 6, 24, style="mixed", device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].shape == (6, 24) and a["tokens"].dtype == torch.int32
    for other in ((1, 5, 0), (0, 6, 0), (0, 5, 1)):
        c = TS.train_batch(spec, other[0], other[1], 6, 24, style="mixed", host=other[2],
                           device="cpu")
        assert not torch.equal(a["tokens"], c["tokens"]), other
    full = torch.cat([a["tokens"], a["labels"][:, -1:]], dim=1)       # [6, 25]
    marker_pos = torch.tensor([t % spec.style_period == spec.style_period - 1
                               for t in range(25)])
    assert bool((full[:3][:, marker_pos] == spec.style_marker).all())    # stylized half
    assert bool((full[3:] != spec.style_marker).all())                   # base half
    assert TS.modality_extras(reduced(get_arch("glm4-9b")), 6, 24, 0, 5) == {}
    with pytest.raises(NotImplementedError, match="Queue A 5"):
        TS.modality_extras(dataclasses.replace(reduced(get_arch("glm4-9b")), family="vlm"),
                           6, 24, 0, 5)


def test_scores_from_tokens_match_reference_eval_scores(fp32):
    ref_model, ref_params, model, params = fp32
    ref_spec = RS.LanguageSpec(vocab=512, hard_style=True)
    spec = TS.LanguageSpec(vocab=512, hard_style=True)
    kb, ks = jax.random.split(jax.random.PRNGKey(7))
    base = np.asarray(RS.sample_batch(kb, ref_spec, 8, 64, style=False))
    styled = np.asarray(RS.sample_batch(ks, ref_spec, 8, 64, style=True))
    ref = RS.eval_scores(ref_model, ref_params, ref_spec, batch=8, seq=64, seed=7)
    port = TS.scores_from_tokens(model, params, spec, torch.from_numpy(base),
                                 torch.from_numpy(styled))
    assert set(port) == set(ref)

    def ambiguous(tokens):
        """Share of positions whose top-2 margin is inside the bf16 tolerance."""
        logits = TS._full_logits(model, params, {"tokens": torch.from_numpy(tokens[:, :-1])})
        top2 = logits.topk(2, dim=-1).values
        return float(((top2[..., 0] - top2[..., 1]) < 2e-2 * logits.abs().max()).float().mean())

    amb_base, amb_style = ambiguous(base), ambiguous(styled)
    assert amb_base < 0.5 and amb_style < 0.5
    assert abs(port["general_acc"] - ref["general_acc"]) <= amb_base
    for k in ("style_marker_acc", "style_bigram_acc"):
        assert abs(port[k] - ref[k]) <= 8 * amb_style, k       # per-class shares
    assert port["general"] == 2.0 * port["general_acc"]


def test_training_entry_points_need_a_card_unless_told(tmp_path, capsys):
    """Without a card the entry points raise unless told ``device="cpu"``;
    the CLI trains on the CPU when told so."""
    from repro_torch.pipeline import daq_study as DS
    out = T.main(["--device", "cpu", "--reduced", "--steps", "3", "--batch", "2", "--seq",
                  "16", "--save-every", "2", "--ckpt-dir", str(tmp_path / "cli")])
    assert ckpt.all_steps(str(tmp_path / "cli")) == [2, 3]
    assert np.isfinite(out["metrics"]["loss"]) and "done: 3 steps" in capsys.readouterr().out
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.train_batch(TS.LanguageSpec(vocab=64), 0, 0, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        DS.prepare_models(study_dir=str(tmp_path / "study"))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path / "card")])


def test_fine_tuning_starts_from_init_params(tmp_path):
    """``train_loop(init_params=...)`` on a bfloat16 tree builds its fp32
    master from those weights, so one small step moves them by about the
    learning rate (the reference's master is the random init's: ROADMAP
    Queue C 19)."""
    model = build_model(reduced(get_arch("glm4-9b")), device="cpu")
    base = model.init(torch.Generator().manual_seed(1))
    tc = TrainConfig(learning_rate=5e-5, warmup_steps=1, total_steps=1, seed=7)
    out = T.train_loop(model, tc, batch_size=2, seq=16, steps=1, ckpt_dir=str(tmp_path),
                       init_params=base, style="mixed")
    master = out["state"]["opt"]["master"]
    for (path, w0), (_, w1), (_, m) in zip(tree_leaves_with_path(base),
                                           tree_leaves_with_path(out["state"]["params"]),
                                           tree_leaves_with_path(master)):
        assert w1.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert torch.equal(m.bfloat16(), w1), path
        assert (m - w0.float()).abs().max() <= 2 * tc.learning_rate, path
