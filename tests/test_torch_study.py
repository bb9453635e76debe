"""``repro_torch.pipeline.daq_study`` (the paper's Tables 2-5) against the
reference's ``repro.pipeline.daq_study``.

The pair: the reference trains the study model (``STUDY_CFG``, bfloat16)
12 steps on the base corpus, then SFTs it 4 steps on the mixed corpus from
those weights; the pair is the two float32 master copies (a few
steps' delta rounds mostly to zero in bfloat16, and the quantizers agree
bit for bit on float32 trees, ROADMAP Queue C 3), carried across with
``compat.params_from_jax``.  Tolerances:

* ``quantize_and_eval`` for AbsMax and for DAQ-sign (int4, block 32): the
  global ΔL2, sign rate, cosine and mse within 1e-5 relative (the
  reference's sums run in another order: 5e-6 measured), the same keys; Style and General on the
  reference's own evaluation draws, through ``scores_from_tokens`` on the
  port's quantized tree, within the share of positions whose top-2 logit
  margin is below the bf16 logit tolerance (2e-2 * max|logit|), as
  ``tests/test_torch_train.py``;
* ``run_tables``: the reference's row names and row keys for every table
  (both ``run_tables`` with the quantize-and-score step stubbed), and a real
  Table 2 on a two-step pair; a second ``prepare_models`` trains nothing.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import QuantConfig as RefQuantConfig
from repro.data import synthetic as RS
from repro.launch.steps import init_train_state as ref_init_train_state
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import build_model as ref_build_model
from repro.optim import init_opt_state as ref_init_opt_state
from repro.pipeline import daq_study as RDS
from repro.quantize import quantize as ref_quantize
from repro_torch.compat import params_from_jax
from repro_torch.configs import QuantConfig
from repro_torch.core.policy import tree_leaves_with_path
from repro_torch.data import synthetic as TS
from repro_torch.launch import train as T
from repro_torch.models import build_model
from repro_torch.pipeline import daq_study as DS
from repro_torch.quantize import quantize

METHODS = {"absmax": dict(method="absmax", granularity="block"),
           "daq-sign": dict(metric="sign", granularity="block", alpha_min=0.8,
                            alpha_max=1.25, n_coarse=5, n_fine=10)}
QKW = dict(fmt=DS.STUDY_FMT, block_size=DS.STUDY_BLOCK)


@pytest.fixture(scope="module")
def pair():
    """(ref model, ref base, ref post, port model, port base, port post)."""
    assert dataclasses.asdict(DS.STUDY_CFG) == dataclasses.asdict(RDS.STUDY_CFG)
    ref_model = ref_build_model(RDS.STUDY_CFG)
    ref_spec = RDS.language()
    tc = RDS.SFT_TC
    step = jax.jit(ref_make_train_step(ref_model, tc))
    state = ref_init_train_state(ref_model, tc, jax.random.PRNGKey(0))
    for t in range(12):
        state, _ = step(state, RS.train_batch(ref_spec, 0, t, 8, 64))
    base = state["opt"]["master"]
    state = {"params": state["params"],                             # SFT from base
             "opt": {**ref_init_opt_state(state["params"], tc), "master": base}}
    for t in range(4):
        state, _ = step(state, RS.train_batch(ref_spec, 1, t, 8, 64, style="mixed"))
    post = state["opt"]["master"]
    model = build_model(DS.STUDY_CFG, device="cpu")
    return (ref_model, base, post, model, params_from_jax(jax.device_get(base)),
            params_from_jax(jax.device_get(post)))


def _ambiguous(model, params, tokens) -> float:
    logits = TS._full_logits(model, params, {"tokens": tokens[:, :-1]})
    top2 = logits.topk(2, dim=-1).values
    return float(((top2[..., 0] - top2[..., 1]) < 2e-2 * logits.abs().max()).float().mean())


@pytest.mark.parametrize("name", sorted(METHODS))
def test_quantize_and_eval_matches_reference(pair, name):
    ref_model, ref_base, ref_post, model, base, post = pair
    ref_row = RDS.quantize_and_eval(ref_model, ref_post, ref_base,
                                    RefQuantConfig(**QKW, **METHODS[name]), RDS.language())
    spec = DS.language()
    qcfg = QuantConfig(**QKW, **METHODS[name])
    row = DS.quantize_and_eval(model, post, base, qcfg, spec)
    assert list(row) == list(ref_row)
    for k in ("delta_l2", "sign_rate", "cosine", "mse"):
        assert abs(row[k] - ref_row[k]) <= 1e-5 * abs(ref_row[k]), (k, row[k], ref_row[k])
    # the scores on the reference's own evaluation draws (``evaluate``'s seed)
    qparams, _ = quantize(post, base, qcfg, mode="dequant", out_dtype="float32",
                          model=model, spec=spec)
    kb, ks = jax.random.split(jax.random.PRNGKey(999))
    ref_spec = RDS.language()
    toks = [torch.from_numpy(np.asarray(RS.sample_batch(k, ref_spec, 32, 192, style=st)))
            for k, st in ((kb, False), (ks, True))]
    scores = TS.scores_from_tokens(model, qparams, spec, *toks)
    amb = [_ambiguous(model, qparams, t) for t in toks]
    assert max(amb) < 0.5
    assert abs(scores["general"] - ref_row["general"]) <= 2 * amb[0]
    assert abs(scores["style"] - ref_row["style"]) <= 2 * 8 * amb[1]   # per-class shares


def _stub_rows(monkeypatch, module, keys):
    """Stub the quantize-and-score steps of a study module: each row carries
    ``keys`` (the real ``quantize_and_eval``'s)."""
    calls = []
    monkeypatch.setattr(module, "prepare_models", lambda **kw: (None, None, None))
    monkeypatch.setattr(module, "evaluate", lambda *a: {"style": 0.5, "general": 1.5})

    def row(model, post, base, qcfg, spec):
        calls.append(qcfg)
        return {k: 0.25 for k in keys}
    monkeypatch.setattr(module, "quantize_and_eval", row)
    return calls


def test_run_tables_rows_and_keys_match_reference(pair, tmp_path, monkeypatch):
    ref_model, ref_base, ref_post, model, base, post = pair
    keys = list(DS.quantize_and_eval(model, post, base, QuantConfig(**QKW, method="absmax"),
                                     DS.language()))
    ref_calls = _stub_rows(monkeypatch, RDS, keys)
    ref = RDS.run_tables(out_path=str(tmp_path / "ref.json"))
    calls = _stub_rows(monkeypatch, DS, keys)
    port = DS.run_tables(out_path=str(tmp_path / "port.json"), study_dir=str(tmp_path))
    assert json.loads((tmp_path / "port.json").read_text()) == port
    assert list(port) == list(ref) == ["2", "3", "4", "5"]
    for t in ref:
        assert list(port[t]) == list(ref[t]), t
        for row in ref[t]:
            assert list(port[t][row]) == list(ref[t][row]), (t, row)
    assert [dataclasses.asdict(c) for c in calls] == \
        [{**dataclasses.asdict(c), "skip_patterns": tuple(c.skip_patterns)} for c in ref_calls]


def test_prepare_models_caches_and_table_two_runs(tmp_path, monkeypatch, capsys):
    model, base, post = DS.prepare_models(study_dir=str(tmp_path), base_steps=2, sft_steps=2,
                                          device="cpu")
    assert not torch.equal(base["stack"]["L0"]["attn"]["wq"], post["stack"]["L0"]["attn"]["wq"])

    def no_training(*a, **k):
        raise AssertionError("prepare_models trained a cached model")
    monkeypatch.setattr(T, "train_loop", no_training)
    _, base2, post2 = DS.prepare_models(study_dir=str(tmp_path), base_steps=2, sft_steps=2,
                                        device="cpu")
    for a, b in ((base, base2), (post, post2)):
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_leaves_with_path(a),
                                                               tree_leaves_with_path(b)))
    out = DS.run_tables(("2",), study_dir=str(tmp_path), base_steps=2, sft_steps=2,
                        device="cpu")
    rows = out["2"]
    assert list(rows)[:2] == ["base_bf16", "post_bf16"] and len(rows) == 8
    for name, row in rows.items():
        assert all(np.isfinite(v) for v in row.values()), name
        assert 0.0 <= row["style"] <= 2.0 and 0.0 <= row["general"] <= 2.0
    assert "[T2] awq_int4_channel" in capsys.readouterr().out
