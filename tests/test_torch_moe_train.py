"""MoE training in ``repro_torch`` against the JAX reference, and the
families the port still refuses.  (The whole-sequence forward of the MoE
and Mamba-2 families is held in ``tests/test_torch_moe_calib.py``, the
dense family's in ``tests/test_torch_data.py``.)

Models: the reduced Mixtral 8x22B (window 16, 8 experts top-2) and
DeepSeek-V3 (a dense-prefix layer, then an MoE layer with a shared expert)
cut to 2 layers, float32 parameters from one seeded init carried bit for
bit to the reference (``init_params``).  ``Model.loss_fn`` embeds to bf16 activations in both
frameworks (``models/common.py::ACT_DTYPE``), and bf16 noise flips a few
top-k choices a layer between them (1-2 % of the tokens here), which moves
that token's output past any tolerance.  So the bf16 comparisons replay the
reference's fp32 router logits into the port's routing
(``_replay_routing``: the port routes on the reference's values while its
gradient flows through its own logits), and every routing call's dispatch
is equal; the float32-activation comparison (``ACT_DTYPE`` set to float32 in
both frameworks for the test) routes on the port's own logits.

Tolerances, each measured well inside its bound:

* ``loss_fn`` on float32 activations (Mixtral), own routing: dispatch
  equal; loss within 1e-5 relative (7e-8 measured), ``aux_loss`` within
  1e-6 relative (equal measured), every gradient leaf within 2e-3 of the
  leaf's absmax (1.1e-3 measured: the expert outputs and combine weights
  are cast to bf16 before the last einsum in both).
* ``loss_fn`` on bf16 activations, routing replayed (the port's own
  logits route at least 99 % of a call's tokens the same): ``aux_loss``
  within 1e-5 relative (equal measured), accuracy within 2 tokens (equal
  measured), loss within 5e-4 relative (1.0e-4 measured on both: the bf16
  forward's noise, 7e-8 on float32 activations; the dense test's 1e-4
  held at 4 layers of GLM-4-9B with 4e-5), every gradient leaf within
  4e-2 of its absmax (the dense test's bound; 1.2e-2 measured), gradient
  paths equal to the reference's.
* inside the port, bit for bit: remat ``none`` == ``full`` ==
  ``dots_saveable`` and the forward with grad == without.
* three ``make_train_step`` steps (Mixtral), and three steps in
  microbatches of 2 (DeepSeek-V3: routing groups are each microbatch's
  tokens on both sides), routing replayed: loss, ``aux_loss`` and grad norm
  within 1e-3 relative; the update of the whole tree and of each weight
  matrix within 0.99 cosine of the reference's (remat ``none`` on both
  sides: the smaller program to compile; remat is held inside the port).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as RefTC
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.data import synthetic as RS
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import build_model as ref_build_model
from repro.models import common as RCM
from repro.models import moe as RM
from repro.optim import init_opt_state
from repro_torch.compat import params_from_jax
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core.policy import tree_leaves_with_path
from repro_torch.data import synthetic as TS
from repro_torch.launch import train as T
from repro_torch.launch.steps import _unflatten, make_train_step
from repro_torch.models import build_model
from repro_torch.models import common as TCM
from repro_torch.models import lm as TL
from repro_torch.models import moe as TM

ARCHS = ("mixtral-8x22b", "deepseek-v3")
TCFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)


def _cfgs(arch, dtype, n_layers=2):
    ref = dataclasses.replace(ref_reduced(ref_get_arch(arch)), dtype=dtype, n_layers=n_layers)
    return ref, dataclasses.replace(reduced(get_arch(arch)), dtype=dtype, n_layers=n_layers)


def init_params(model, seed):
    """(reference tree, port tree): the port's ``init`` from a seeded
    generator (the reference's init distributions, and no compile: the
    reference's own init compiles op by op, ~7 s a model here), its leaves
    carried bit for bit into ``jnp`` arrays."""
    params = model.init(torch.Generator().manual_seed(seed))

    def to_jax(t):
        if isinstance(t, dict):
            return {k: to_jax(v) for k, v in t.items()}
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
        return jnp.asarray(t.numpy())
    return to_jax(params), params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_thread()


def one_thread():
    """One torch thread for a file's tests: its models are tiny, and under
    the suite's six workers torch's default of a thread a core
    oversubscribes the CPU (a 0.4 s test then takes ~20 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS: dict = {}


def _pair(arch, dtype="float32"):
    """(reference model, its params, port model, its params): one reference
    init, made once per module."""
    if (arch, dtype) not in _MODELS:
        rcfg, cfg = _cfgs(arch, dtype)
        model = build_model(cfg, device="cpu")
        rp, params = init_params(model, 0)
        _MODELS[arch, dtype] = (ref_build_model(rcfg), rp, model, params)
    return _MODELS[arch, dtype]


def _np_batch(seed, B=4, S=64, V=511):
    toks = np.random.RandomState(seed).randint(0, V, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves(tree):
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def _ref_paths(tree):
    return ["/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _replay_routing(monkeypatch, replay: bool = True):
    """Record each framework's routing calls in order (the reference's
    through an ordered debug callback: its stacks run under ``lax.scan``):
    ``rec["ref"]`` its (dispatch, fp32 router logits), ``rec["port"]`` the
    port's dispatch.  With ``replay``, the port's call routes on the
    reference's logits of the same call (the reference runs first) plus
    ``l - l.detach()``: the reference's values bit for bit, the gradient
    flowing through the port's own logits; ``rec["agree"]`` holds the share
    of tokens whose experts the port's own logits would have chosen the
    same."""
    rec = {"ref": [], "port": [], "agree": [], "next": 0}
    ref_fn, port_fn = RM.top_k_routing, TM.top_k_routing

    def ref_wrapped(logits, k, cap):
        out = ref_fn(logits, k, cap)
        jax.debug.callback(lambda d, lg: rec["ref"].append((np.array(d), np.array(lg))),
                           out[0].astype(jnp.float32), logits, ordered=True)
        return out

    def port_wrapped(logits, k, cap):
        if replay:
            d, lg = rec["ref"][rec["next"]]
            rec["next"] += 1
            own = port_fn(logits.detach(), k, cap)[0].float().numpy()
            rec["agree"].append(float((own.max(-1) == d.max(-1)).all(-1).mean()))
            logits = torch.from_numpy(lg) + (logits - logits.detach())
        out = port_fn(logits, k, cap)
        rec["port"].append(out[0].detach().float().numpy())
        return out

    monkeypatch.setattr(RM, "top_k_routing", ref_wrapped)
    monkeypatch.setattr(TM, "top_k_routing", port_wrapped)
    return rec


def _dispatch_equal(rec, n_calls):
    assert len(rec["port"]) == len(rec["ref"]) == n_calls
    for (d, _), p in zip(rec["ref"], rec["port"]):
        np.testing.assert_array_equal(p, d)


def _port_loss_and_grads(model, params, batch, remat="none"):
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    loss, metrics = model.loss_fn(_unflatten(params, leaves), batch, remat=remat)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        torch.autograd.grad(loss, leaves)


def _ref_loss_and_grads(ref_model, ref_params, batch):
    f = jax.value_and_grad(lambda p, b: ref_model.loss_fn(p, b, remat="none"), has_aux=True)
    (rl, rm), rg = jax.jit(f)(ref_params, _j(batch))
    return float(rl), {k: float(v) for k, v in rm.items()}, rg


def _n_moe(model):
    return sum(n for _, spec, n in model.groups if spec[1] == "moe")


def _check_grads(rg, pg, params, rel):
    """Gradient paths equal the reference's (the router, the three expert
    stacks, the shared expert and the dense prefix among them), each leaf
    within ``rel`` of its absmax; returns the worst reading."""
    paths = _ref_paths(rg)
    assert paths == ["/".join(p) for p, _ in tree_leaves_with_path(params)]
    assert any(p.endswith("moe/router") for p in paths)
    assert any(p.startswith("prefix/") for p in paths) == bool(len(params.get("prefix", {})))
    worst = 0.0
    for name, r, p in zip(paths, jax.tree.leaves(rg), pg):
        r = np.asarray(r)
        assert p.shape == r.shape, name
        err = float(np.abs(p.numpy() - r).max() / np.abs(r).max())
        assert err <= rel, (name, err)
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# Loss, auxiliary loss and gradients
# ---------------------------------------------------------------------------

def test_loss_aux_and_grads_match_reference_on_float32_activations(monkeypatch):
    """The backward through routing, on Mixtral's two MoE layers: the
    combine weights' gradient reaches the router weight and the hidden
    state, the aux term's through the mean router probabilities only."""
    ref_model, rp, model, params = _pair("mixtral-8x22b")
    monkeypatch.setattr(RCM, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(TCM, "ACT_DTYPE", torch.float32)
    rec = _replay_routing(monkeypatch, replay=False)
    batch = _np_batch(0)
    rl, rm, rg = _ref_loss_and_grads(ref_model, rp, batch)
    pl, pm, pg = _port_loss_and_grads(model, params, _t(batch))
    _dispatch_equal(rec, _n_moe(model))
    assert abs(float(pl) - rl) <= 1e-5 * abs(rl)
    assert float(pm["aux_loss"]) > 0
    assert abs(float(pm["aux_loss"]) - rm["aux_loss"]) <= 1e-6 * rm["aux_loss"]
    assert float(pl) == float(pm["loss"] + pm["aux_loss"])
    assert float(pm["n_tokens"]) == rm["n_tokens"] == 4 * 64
    _check_grads(rg, pg, params, 2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_grads_match_reference(arch, monkeypatch):
    ref_model, rp, model, params = _pair(arch)
    rec = _replay_routing(monkeypatch)
    batch = _np_batch(1)
    rl, rm, rg = _ref_loss_and_grads(ref_model, rp, batch)
    pl, pm, pg = _port_loss_and_grads(model, params, _t(batch))
    _dispatch_equal(rec, _n_moe(model))
    assert min(rec["agree"]) >= 0.9
    assert abs(float(pl) - rl) <= 5e-4 * abs(rl)
    assert abs(float(pm["aux_loss"]) - rm["aux_loss"]) <= 1e-5 * rm["aux_loss"]
    assert abs(float(pm["accuracy"]) - rm["accuracy"]) <= 2 / 256
    _check_grads(rg, pg, params, 4e-2)


def test_remat_policies_and_grad_mode_agree_bit_for_bit():
    """The recomputed routing of ``full`` and ``dots_saveable`` (the router,
    its ``argmax`` and the queue positions re-run in the backward) is the
    forward's: loss and every gradient bit-equal to ``none``."""
    *_, model, params = _pair("mixtral-8x22b")
    batch = _t(_np_batch(2))
    base = _port_loss_and_grads(model, params, batch, remat="none")
    for remat in ("full", "dots_saveable"):
        loss, m, g = _port_loss_and_grads(model, params, batch, remat=remat)
        assert torch.equal(loss, base[0]) and torch.equal(m["aux_loss"], base[1]["aux_loss"])
        assert all(torch.equal(a, b) for a, b in zip(g, base[2])), remat
    with torch.no_grad():
        loss, m = model.loss_fn(params, batch)
    assert torch.equal(loss, base[0]) and torch.equal(m["aux_loss"], base[1]["aux_loss"])


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,micro", [("mixtral-8x22b", 0), ("deepseek-v3", 2)])
def test_three_train_steps_match_reference(arch, micro, monkeypatch):
    ref_model, rp, model, _ = _pair(arch)
    rec = _replay_routing(monkeypatch)
    kw = dict(TCFG, microbatch=micro, remat="none")
    ref_tc, tc = RefTC(**kw), TrainConfig(**kw)
    # the reference's init_train_state on the drawn params
    ref_state = {"params": rp, "opt": jax.jit(lambda p: init_opt_state(p, ref_tc))(rp)}
    state = params_from_jax(jax.device_get(ref_state))          # one state for both
    start = [p.clone() for p in _leaves(state["params"])]
    ref_step, step = jax.jit(ref_make_train_step(ref_model, ref_tc)), make_train_step(model, tc)
    for t in range(3):
        batch = _np_batch(10 + t)
        ref_state, rm = ref_step(ref_state, _j(batch))
        jax.block_until_ready(rm)
        state, pm = step(state, _t(batch))
        for k in ("loss", "aux_loss", "grad_norm"):
            assert abs(float(pm[k]) - float(rm[k])) <= 1e-3 * abs(float(rm[k])), (t, k)
        assert float(pm["aux_loss"]) > 0
    _dispatch_equal(rec, 3 * max(micro, 1) * _n_moe(model))
    cosine = lambda a, b: a @ b / np.linalg.norm(a) / np.linalg.norm(b)
    whole = ([], [])
    for (path, p), p0, r in zip(tree_leaves_with_path(state["params"]), start,
                                [np.asarray(x) for x in jax.tree.leaves(ref_state["params"])]):
        dp, dr = (p - p0).double().numpy().ravel(), (r - p0.numpy()).ravel()
        whole[0].append(dp)
        whole[1].append(dr)
        if path[-1].startswith("w") or path[-1] in ("embed", "router"):
            assert cosine(dp, dr) >= 0.99, (path, cosine(dp, dr))
    assert cosine(np.concatenate(whole[0]), np.concatenate(whole[1])) >= 0.99


def test_cli_trains_moe_with_its_aux_loss(tmp_path, capsys):
    out = T.main(["--arch", "mixtral-8x22b", "--reduced", "--device", "cpu", "--steps", "2",
                  "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path)])
    m = out["metrics"]
    assert np.isfinite(m["loss"]) and m["aux_loss"] > 0
    assert " aux=" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# What still refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["hybrid", "vlm", "encdec"])
def test_unported_families_still_refuse(family):
    cfg = dataclasses.replace(reduced(get_arch("glm4-9b")), family=family)
    with pytest.raises(NotImplementedError, match="Queue A 5"):
        TL.layer_plan(cfg)
    with pytest.raises(NotImplementedError, match="Queue A 5"):
        TS._full_logits(types.SimpleNamespace(cfg=cfg), {"embed": {}},
                        {"tokens": torch.zeros(1, 4, dtype=torch.int32)})
    if family != "hybrid":         # a hybrid batch carries no modality extras
        with pytest.raises(NotImplementedError, match="Queue A 5"):
            TS.modality_extras(cfg, 2, 8, 0, 0)
