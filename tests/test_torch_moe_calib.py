"""The whole-sequence forward (``data/synthetic.py::_full_logits``),
calibration (``collect_input_stats``), SmoothQuant / AWQ and the paper's
Style / General scores on MoE and Mamba-2 trees, ``repro_torch`` against the
JAX reference.  Models: the reduced Mixtral 8x22B, DeepSeek-V3 (a
dense-prefix layer and an MoE layer with a shared expert) and Mamba2-780M,
each cut to 2 layers, bf16 weights from one seeded init in both
(``init_params``), a base 0.5 % of each matrix's std away.  The
reference's records come from its jitted forward (``_ref_records``); its
MoE routing is replayed into the port's (``tests/test_torch_moe_train.py``'s
rule: bf16 noise flips a few top-k choices a layer between the
frameworks).

Tolerances:

* ``_full_logits`` on the same tokens (the calibration forwards): within
  2e-2 of the logit scale (bf16 activations; 6.1e-3 to 8.4e-3 measured).
* records on the same tokens: the same count, order and shapes; each
  fingerprint's two sampled values equal and its ``mean |w|`` within 1e-6
  relative (reduced in another order; 2e-7 measured); each per-in-channel
  max within 2e-2 of its vector's largest value (bf16 activations, as
  ``tests/test_torch_equalize.py``; 4.2e-3 to 1.1e-2 measured).  The expert stacks
  record nothing in either: they never go through ``qlinear.matmul``.
* SmoothQuant and AWQ given one set of statistics (the port's records, each
  side keyed by its own fingerprints): every ``eq_scale`` within rtol 1e-6
  (SmoothQuant's bit-equal) and codes and scales bit-equal wherever it is
  (all but at most one leaf-matrix, AWQ: an exponent can tie); the expert
  stacks equalize with unit activation scales behind one "no calibration
  record matches" warning naming the same leaf on both sides.
* ``scores_from_tokens`` against the reference's ``eval_scores`` on the
  reference's own draws: each accuracy within the share of positions whose
  top-2 logit margin is below 2e-2 of the logit scale, as the dense test.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import QuantConfig as RefQuantConfig
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.data import synthetic as RS
from repro.models import build_model as ref_build_model
from repro.quant_runtime import qlinear as RQL
from repro.quantize import quantize as ref_quantize
from repro_torch.compat import params_from_jax
from repro_torch.configs import QuantConfig, get_arch, reduced
from repro_torch.core.policy import tree_leaves_with_path
from repro_torch.data import synthetic as TS
from repro_torch.models import build_model
from repro_torch.quant_runtime import qlinear
from repro_torch.quant_runtime.qparams import QuantizedTensor
from repro_torch.quantize import collect_input_stats, quantize
from repro_torch.quantize.equalize import _record_input_stats
from test_torch_moe_train import _replay_routing, init_params, one_thread

TOL = 2e-2
FAMILIES = ("mixtral-8x22b", "deepseek-v3", "mamba2-780m")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_thread()


def _tokens(seed):
    return np.random.RandomState(seed).randint(0, 512, size=(4, 64)).astype(np.int32)


def _ref_records(mp, ref_model, rp, token_batches):
    """The reference's calibration records over ``token_batches``: one
    ``(weight shape, weight_fingerprint, per-in-channel |x| max)`` per
    ``qlinear.matmul`` call, in call order, as its ``RECORD`` holds them.  Its
    ``collect_input_stats`` records from an eager forward, which costs ~10x
    a compile here; so the forward is jitted, with ``qlinear.matmul`` wrapped
    to send the resolved weight and the maximum (computed as ``matmul``
    computes it) out through an ordered debug callback."""
    raw, real = [], RQL.matmul

    def recorded(x, w, **kw):
        jax.debug.callback(lambda a, b: raw.append((np.array(a), np.array(b))), RQL.resolve(w),
                           jnp.max(jnp.abs(x.reshape(-1, x.shape[-1])), axis=0), ordered=True)
        return real(x, w, **kw)

    mp.setattr(RQL, "matmul", recorded)
    f = jax.jit(lambda p, t: RS._full_logits(ref_model, p, {"tokens": t}))
    logits = [np.asarray(f(rp, jnp.asarray(t))) for t in token_batches]
    mp.setattr(RQL, "matmul", real)
    return [(w.shape, RQL.weight_fingerprint(jnp.asarray(w)), jnp.asarray(a))
            for w, a in raw], logits


@pytest.fixture(scope="module")
def calibrated():
    """Per family: the models, bf16 params, a base 0.5 % of each matrix's
    std away, and both frameworks' records over the same two batches,
    routing replayed."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for arch in FAMILIES:
            rcfg = dataclasses.replace(ref_reduced(ref_get_arch(arch)), n_layers=2)
            cfg = dataclasses.replace(reduced(get_arch(arch)), n_layers=2)
            ref_model = ref_build_model(rcfg)
            model = build_model(cfg, device="cpu")
            rp, params = init_params(model, 1)
            rng = np.random.default_rng(2)
            rb = jax.tree.map(lambda a: jnp.asarray((lambda n: (
                n + rng.standard_normal(n.shape) * 0.005 * n.std()).astype(np.float32).astype(
                a.dtype))(np.asarray(a, np.float32))) if a.ndim >= 2 else a, rp)
            toks = [_tokens(s) for s in (3, 4)]
            rec = _replay_routing(mp)
            ref_rec, ref_logits = _ref_records(mp, ref_model, rp, toks)
            logits, full = [], TS._full_logits     # the port's, from the same forwards
            mp.setattr(TS, "_full_logits", lambda *a: logits.append(full(*a)) or logits[-1])
            port_rec = _record_input_stats(model, params, [torch.from_numpy(t) for t in toks])
            out[arch] = dict(ref_model=ref_model, rp=rp, rb=rb, model=model, params=params,
                             base=params_from_jax(jax.device_get(rb)), ref_rec=ref_rec,
                             rec=port_rec, routing=rec, logits=logits, ref_logits=ref_logits)
            mp.undo()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_full_logits_match_reference(calibrated, arch):
    """The whole-sequence forward: an MoE model's dense prefix then its
    stack, Mixtral's 64-token rows across its window of 16, a Mamba-2
    stack; each forward's logits within 2e-2 of their scale."""
    c = calibrated[arch]
    assert len(c["logits"]) == len(c["ref_logits"]) == 2
    for port, ref in zip(c["logits"], c["ref_logits"]):
        assert port.dtype == torch.float32 and port.shape == ref.shape == (4, 64, 512)
        assert np.abs(port.numpy() - ref).max() <= TOL * np.abs(ref).max()
    if c["model"].cfg.sliding_window:
        assert 64 > c["model"].cfg.sliding_window


@pytest.mark.parametrize("arch", FAMILIES)
def test_calibration_records_match_reference(calibrated, arch):
    c = calibrated[arch]
    model, params, rec, ref_rec = c["model"], c["params"], c["rec"], c["ref_rec"]
    assert qlinear.RECORD is None
    cfg = model.cfg
    # per layer: four attention products (and a dense MLP's three, the shared
    # expert's three) or a Mamba layer's in / out projections; the LM head
    per = {"mixtral-8x22b": [4, 4], "deepseek-v3": [7, 7], "mamba2-780m": None}[arch]
    if per is not None:
        assert len(rec) == 2 * (sum(per) + 1)
    assert len(rec) == len(ref_rec) > 0
    assert [r[0] for r in rec] == [tuple(r[0]) for r in ref_rec]
    for (_, fp, m), (_, rfp, rm) in zip(rec, ref_rec):
        assert fp[:2] == tuple(rfp[:2]) and abs(fp[2] - rfp[2]) <= 1e-6 * abs(rfp[2])
        rm = np.asarray(rm.astype(jnp.float32))
        assert m.shape == rm.shape and np.abs(m.float().numpy() - rm).max() <= \
            TOL * np.abs(rm).max()
    if cfg.family == "moe":
        routing = c["routing"]
        assert len(routing["port"]) == len(routing["ref"]) == 2 * (cfg.n_layers
                                                                    - cfg.first_k_dense)
        for (d, _), p in zip(routing["ref"], routing["port"]):
            np.testing.assert_array_equal(p, d)
        # no record of an expert stack's [D, F] / [F, D] matrix
        expert = {tuple(params["stack"]["L0"]["moe"][w].shape[-2:]) for w in ("w_gate",
                                                                            "w_down")}
        assert not expert & {r[0] for r in rec} or cfg.n_shared_experts
    # the public entry point on the port's own draws: one batch, all finite
    one = collect_input_stats(model, params, TS.LanguageSpec(vocab=512), n_batches=1)
    assert len(one) == len(rec) // 2 and all(bool(torch.isfinite(r[2]).all()) for r in one)


@pytest.mark.parametrize("method", ["smoothquant", "awq"])
@pytest.mark.parametrize("arch", ["deepseek-v3", "mamba2-780m"])
def test_equalized_quantize_matches_reference_on_shared_stats(calibrated, arch, method):
    c = calibrated[arch]
    rec = c["rec"]
    # the MoE block (router, expert stacks, shared expert) or the Mamba
    # stack: every further leaf shape costs the reference's eager quantize
    # seconds, and the attention, embedding and head leaves are held by
    # tests/test_torch_equalize.py
    if c["model"].cfg.family == "moe":
        part = lambda t: {"stack": {"L0": {"moe": t["stack"]["L0"]["moe"]}}}
    else:
        part = lambda t: {"stack": t["stack"]}
    ref_cal = [(tuple(r[0]), r[1], jnp.asarray(p[2].float().numpy()))
               for p, r in zip(rec, c["ref_rec"])]
    kw = dict(block_size=32)
    with warnings.catch_warnings(record=True) as ref_w:
        warnings.simplefilter("always")
        rqt, rrep = ref_quantize(part(c["rp"]), part(c["rb"]), RefQuantConfig(**kw), mode="storage",
                                 method=method, calib=ref_cal)
    with warnings.catch_warnings(record=True) as port_w:
        warnings.simplefilter("always")
        qt, rep = quantize(part(c["params"]), part(c["base"]), QuantConfig(**kw), mode="storage",
                           method=method, calib=rec)
    msgs = lambda ws: [str(w.message) for w in ws if "calibration" in str(w.message)]
    assert msgs(port_w) == msgs(ref_w)
    if c["model"].cfg.family == "moe":       # the experts: unit activation scales
        assert len(msgs(port_w)) == 1 and "stack/L0/moe/w_down[0][0]" in msgs(port_w)[0]
    else:
        assert msgs(port_w) == []
    assert list(rep.per_leaf) == list(rrep.per_leaf)
    rconv = params_from_jax(jax.device_get(rqt))
    n_mat = n_eq = 0
    for (path, a), (_, b) in zip(tree_leaves_with_path(qt), tree_leaves_with_path(rconv)):
        if not isinstance(a, QuantizedTensor):
            assert torch.equal(a, b), path
            continue
        assert a.eq_scale.shape == b.eq_scale.shape == a.shape[:-1]
        torch.testing.assert_close(a.eq_scale, b.eq_scale, rtol=1e-6, atol=0)
        lead = a.shape[:-2]
        for idx in np.ndindex(*lead):
            n_mat += 1
            ea, eb = a.eq_scale[idx], b.eq_scale[idx]
            if method == "smoothquant":
                assert torch.equal(ea, eb), (path, idx)
            if torch.equal(ea, eb):
                n_eq += 1
                assert torch.equal(a.data[idx].view(torch.uint8), b.data[idx].view(torch.uint8))
                assert torch.equal(a.scale[idx], b.scale[idx]), (path, idx)
    assert n_eq >= n_mat - 1


def test_scores_on_an_moe_tree_match_reference(calibrated, monkeypatch):
    c = calibrated["deepseek-v3"]
    model, params = c["model"], c["params"]
    ref_spec = RS.LanguageSpec(vocab=512, hard_style=True)
    spec = TS.LanguageSpec(vocab=512, hard_style=True)
    kb, ks = jax.random.split(jax.random.PRNGKey(7))
    base = np.asarray(RS.sample_batch(kb, ref_spec, 4, 64, style=False))
    styled = np.asarray(RS.sample_batch(ks, ref_spec, 4, 64, style=True))
    rec = _replay_routing(monkeypatch)
    orig = RS._full_logits
    full = jax.jit(lambda p, t: orig(c["ref_model"], p, {"tokens": t}))
    monkeypatch.setattr(RS, "_full_logits", lambda m, p, b: full(p, b["tokens"]))
    ref = RS.eval_scores(c["ref_model"], c["rp"], ref_spec, batch=4, seq=64, seed=7)
    port = TS.scores_from_tokens(model, params, spec, torch.from_numpy(base),
                                 torch.from_numpy(styled))
    assert set(port) == set(ref) and len(rec["port"]) == len(rec["ref"]) == 2
    for (d, _), p in zip(rec["ref"], rec["port"]):
        np.testing.assert_array_equal(p, d)
    monkeypatch.undo()

    def ambiguous(tokens):
        logits = TS._full_logits(model, params, {"tokens": torch.from_numpy(tokens[:, :-1])})
        top2 = logits.topk(2, dim=-1).values
        return float(((top2[..., 0] - top2[..., 1]) < TOL * logits.abs().max()).float().mean())

    amb_base, amb_style = ambiguous(base), ambiguous(styled)
    assert amb_base < 0.5 and amb_style < 0.5
    assert abs(port["general_acc"] - ref["general_acc"]) <= amb_base
    for k in ("style_marker_acc", "style_bigram_acc"):
        assert abs(port[k] - ref[k]) <= 8 * amb_style, k
    assert all(0.0 <= port[k] <= 2.0 for k in ("style", "general"))


def test_study_row_on_an_moe_tree(calibrated):
    """``pipeline/daq_study.py::quantize_and_eval`` on the MoE tree: AWQ
    calibrated through its ``model=`` / ``spec=`` hook, a row of finite
    metrics and scores in [0, 2]."""
    from repro_torch.pipeline import daq_study as DS
    c = calibrated["deepseek-v3"]
    row = DS.quantize_and_eval(c["model"], c["params"], c["base"], QuantConfig(method="awq"),
                               TS.LanguageSpec(vocab=512))
    assert set(row) == {"delta_l2", "sign_rate", "cosine", "mse", "style", "general"}
    assert all(np.isfinite(v) for v in row.values())
    assert 0.0 <= row["style"] <= 2.0 and 0.0 <= row["general"] <= 2.0
