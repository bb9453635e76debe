"""repro_torch's host-loop baseline, checkpoints and serve CLI, on the CPU.

* ``engine.legacy.serve_host_loop`` equals the port's contiguous
  ``Engine`` token for token (exact: the contract of
  ``tests/test_engine.py`` held inside the port), and the reference's
  ``serve_host_loop`` on the same prompts and weights where every token's
  top-2 margin exceeds 2e-2 of the logit scale (the bf16 tolerance of
  ``tests/test_torch_engine.py``).
* ``checkpoint``: a tree of bf16, fp8 (``QuantizedTensor`` leaves, one
  equalized) and float32 leaves saved by ``repro.checkpoint.save``
  restores bit-equal through the port and the reverse, bare and under a
  train state's ``params``; retention, corruption and shape checks.
* ``launch.serve.main``: the reduced GLM-4-9B on the CPU, DAQ-quantized
  and paged with the prefix cache, writing a metrics snapshot and a trace;
  a speculative serve with a DAQ draft; the same argv gives the same
  tokens; the reference's flag checks exit with the reference's messages.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.engine import serve_host_loop as ref_serve_host_loop
from repro.launch import serve as ref_cli
from repro.models import build_model as ref_build_model
from repro.quant_runtime.qparams import QuantizedTensor as RefQT
from repro_torch import checkpoint as ckpt
from repro_torch.compat import params_from_jax
from repro_torch.configs import get_arch, reduced
from repro_torch.engine import Engine, serve_host_loop
from repro_torch.launch import serve as cli
from repro_torch.models import build_model

TOL = 2e-2


def _prompt(seed, length, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, length).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    """(reference model, reference params, port model, port params) on the
    reduced GLM-4-9B, bf16 weights drawn with numpy."""
    cfg = ref_reduced(ref_get_arch("glm4-9b"))
    ref_model = ref_build_model(cfg)
    shapes = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(path, s):
        if len(s.shape) >= 2:
            return rng.standard_normal(s.shape) * s.shape[-2] ** -0.5
        if "bias" in jax.tree_util.keystr(path):
            return rng.standard_normal(s.shape) * 0.1
        return 1.0 + 0.1 * rng.standard_normal(s.shape)

    ref_params = jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(draw(p, s).astype(np.float32)).astype(jnp.bfloat16), shapes)
    model = build_model(reduced(get_arch("glm4-9b")), device="cpu")
    return ref_model, ref_params, model, params_from_jax(jax.device_get(ref_params))


def _min_margin(model, params, prompt, continuation) -> float:
    """Smallest top-2 logit gap / max|logit| over the greedy steps that
    produced ``continuation`` (teacher-forced through the port's model)."""
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None]},
                                  cache_len=len(prompt) + len(continuation))
    worst = np.inf
    for tok in continuation:
        lf = logits.float()[0]
        top = torch.topk(lf, 2).values
        worst = min(worst, float((top[0] - top[1]) / lf.abs().max()))
        logits, cache = model.decode_step(params, torch.tensor([[tok]], dtype=torch.int32),
                                          cache)
    return worst


# ---------------------------------------------------------------------------
# The host-loop baseline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lens", [(10, 10, 10, 10, 10), (10, 7, 12, 9, 5)])
def test_host_loop_equals_contiguous_engine(models, lens):
    """Slot refills mid-stream, equal and unequal prompt lengths (the
    engine's one right-padded prefill against batch-1 prefills); the host
    loop syncs once a slot-token, the engine once a dispatch."""
    _, _, model, params = models
    prompts = [_prompt(i, L) for i, L in enumerate(lens)]
    legacy, ls = serve_host_loop(model, params, prompts, batch=2, gen_tokens=6, cache_len=30,
                                 return_stats=True)
    eng = Engine(model, params, slots=2, cache_len=30, k_steps=3)
    outs, stats = eng.serve(prompts, gen_tokens=6, return_stats=True)
    assert outs == legacy
    assert ls["tokens"] == stats["tokens"] == 6 * len(prompts)
    assert ls["prefill_calls"] == len(prompts)
    assert ls["host_syncs"] == ls["tokens"]
    assert stats["host_syncs"] == stats["dispatches"] + stats["prefill_calls"] < ls["host_syncs"]
    assert cli.serve(model, params, prompts, batch=2, gen_tokens=6, cache_len=30,
                     k_steps=3) == outs


def test_host_loop_matches_reference_host_loop(models):
    ref_model, ref_params, model, params = models
    prompts = [_prompt(s, L) for s, L in ((0, 10), (1, 7), (3, 9), (4, 10))]
    ref_out, rs = ref_serve_host_loop(ref_model, ref_params, [jnp.asarray(p) for p in prompts],
                                      batch=2, gen_tokens=5, cache_len=24, return_stats=True)
    ref_out = [list(map(int, o)) for o in ref_out]
    for p, out in zip(prompts, ref_out):
        assert _min_margin(model, params, p, out) > TOL
    outs, stats = serve_host_loop(model, params, prompts, batch=2, gen_tokens=5, cache_len=24,
                                  return_stats=True)
    assert outs == ref_out
    assert stats == rs


# ---------------------------------------------------------------------------
# Checkpoints, both ways
# ---------------------------------------------------------------------------

def _ref_tree():
    rng = np.random.default_rng(3)
    f32 = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))
    return {
        "embed": {"tok": f32(16, 8).astype(jnp.bfloat16)},
        "stack": {"L0": {
            "wq": RefQT(f32(2, 8, 16).astype(jnp.float8_e4m3fn), jnp.abs(f32(2, 1, 1)),
                        granularity="block", block_size=8),
            "wo": RefQT(f32(16, 8).astype(jnp.float8_e4m3fn), jnp.abs(f32(1, 8)),
                        granularity="channel", eq_scale=jnp.abs(f32(16))),
            "norm": f32(2, 8),
        }},
        "step": jnp.asarray(7, jnp.int32),
        "scale": f32(),
    }


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def _assert_bit_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_bit_equal(a[k], b[k])
    elif hasattr(a, "granularity"):
        for k in ("fmt", "granularity", "block_size", "out_dtype"):
            assert getattr(a, k) == getattr(b, k)
        for k in ("data", "scale", "eq_scale"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None)
            if x is not None:
                _assert_bit_equal(x, y)
    else:
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).split(".")[-1] == str(b.dtype).split(".")[-1]
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("layout", ["bare", "train_state"])
def test_checkpoints_restore_bit_equal_across_packages(tmp_path, layout):
    ref = _ref_tree()
    port = params_from_jax(jax.device_get(ref))
    wrap = (lambda t: t) if layout == "bare" else (lambda t: {"params": t, "opt": {"t": t}})
    ref_ckpt.save(str(tmp_path / "ref"), 3, wrap(ref))
    ckpt.save(str(tmp_path / "port"), 3, wrap(port))
    ref_leaves = ref_ckpt.meta(str(tmp_path / "ref"), 3)["leaves"]
    port_leaves = ckpt.meta(str(tmp_path / "port"), 3)["leaves"]
    assert port_leaves == ref_leaves            # names, dtype names, shapes, bytes
    pre = "" if layout == "bare" else "params."
    assert {pre + "stack.L0.wo.eq_scale", pre + "stack.L0.wq.data"} <= set(port_leaves)
    assert pre + "stack.L0.wq.eq_scale" not in port_leaves

    got = ckpt.restore(str(tmp_path / "ref"), 3, wrap(port))
    _assert_bit_equal(got, wrap(port))
    back = ref_ckpt.restore(str(tmp_path / "port"), 3, wrap(ref))
    _assert_bit_equal(params_from_jax(jax.device_get(back)), wrap(port))
    base = cli._load_base_params(str(tmp_path / "ref"), port)
    _assert_bit_equal(base, port)


def test_checkpoint_retention_and_integrity(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": torch.arange(6.0), "b": {"c": torch.ones(2, 3, dtype=torch.bfloat16)}}
    for s in (10, 20, 30, 40):
        ckpt.save(d, s, tree, keep_last=2, extra_meta={"s": s})
    assert ckpt.all_steps(d) == [30, 40] and ckpt.latest(d) == 40
    assert ckpt.meta(d, 40)["meta"] == {"s": 40}
    assert ckpt.latest(str(tmp_path / "none")) is None
    like = {"a": torch.zeros(6, dtype=torch.float64), "b": {"c": torch.zeros(2, 3)}}
    got = ckpt.restore(d, 40, like)
    assert got["a"].dtype == torch.float64 and torch.equal(got["a"], torch.arange(6.0).double())
    assert torch.equal(got["b"]["c"], torch.ones(2, 3))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(d, 40, {"a": torch.zeros(5), "b": {"c": torch.zeros(2, 3)}})
    with pytest.raises(ValueError, match="missing leaves"):
        ckpt.restore(d, 40, {"x": torch.zeros(6)})
    with open(os.path.join(d, "step_00000040", "a.npy"), "ab") as f:
        f.write(b"junk")
    with pytest.raises(IOError):
        ckpt.restore(d, 40, tree)
    with pytest.raises(SystemExit, match="no checkpoint found"):
        cli._load_base_params(str(tmp_path / "none"), tree)


# ---------------------------------------------------------------------------
# The serve CLI
# ---------------------------------------------------------------------------

SMALL = ["--reduced", "--device", "cpu", "--requests", "3", "--batch", "2",
         "--prompt-len", "12", "--gen", "5", "--k-steps", "4"]


def test_cli_daq_prefix_cache_writes_metrics_and_trace(tmp_path, capsys):
    argv = SMALL + ["--daq", "--paged", "--prefix-cache", "--metrics-out",
                    str(tmp_path / "m.json"), "--trace-out", str(tmp_path / "t.json")]
    outs, stats = cli.main(argv)
    text = capsys.readouterr().out
    assert len(outs) == 3 and all(len(o) == 5 and all(0 <= t < 512 for t in o) for o in outs)
    line = next(ln for ln in text.splitlines() if ln.startswith("served 3 requests, 15 tokens"))
    for field in ("tok/s", "host syncs/token", "dispatches of 4 steps", "prefill calls",
                  "paged+prefix cache", "cache bytes", "prompt tokens prefilled",
                  "prefix-hit)", "acceptance: n/a"):
        assert field in line, field
    assert "method: daq" in text and "\nmetrics:\n" in text and "request.ttft_s: p50=" in text
    assert "LanguageSpec(vocab=" not in text         # 512 tokens: the full vocabulary
    snap = json.loads((tmp_path / "m.json").read_text())
    assert snap["schema"] == "repro.telemetry.metrics/v1"
    assert snap["counters"]["requests.completed"] == 3
    assert snap["counters"]["device.tokens"] == stats["counters"]["tokens"] == 15
    doc = json.loads((tmp_path / "t.json").read_text())
    tracks = {ev["args"]["name"] for ev in doc["traceEvents"]
              if ev["ph"] == "M" and ev["name"] == "thread_name"}
    assert {"admission", "dispatch", "prefill-chunk"} <= tracks
    assert cli.main(argv)[0] == outs                  # the same argv, the same tokens


def test_cli_speculative_draft_and_vocabulary_cap(monkeypatch, capsys):
    """A DAQ draft verified by the bf16 weights; with the language capped
    below the model's vocabulary the CLI says so and still serves."""
    monkeypatch.setattr(cli, "SPEC_VOCAB_CAP", 256)
    outs, stats = cli.main(SMALL + ["--paged", "--spec-draft", "daq", "--n-spec", "2"])
    text = capsys.readouterr().out
    assert "LanguageSpec(vocab=256), not the model's 512 tokens" in text
    assert "[serve] speculative draft (daq):" in text
    assert "draft acceptance" in text and "+spec(daq) cache" in text
    assert len(outs) == 3 and all(len(o) == 5 for o in outs)
    assert stats["draft_tokens"] > 0
    assert stats["counters"]["drafted"] == stats["draft_tokens"]


BAD_ARGV = [["--method", "absmax"], ["--metric", "cosine"], ["--base-ckpt", "x"],
            ["--paged", "--spec-draft", "daq", "--method", "daq"],
            ["--paged", "--spec-draft", "daq", "--daq"], ["--spec-draft", "daq"],
            ["--prefix-cache"], ["--chunk-size", "8"]]


@pytest.mark.parametrize("extra", BAD_ARGV, ids=lambda a: " ".join(a))
def test_cli_flag_checks_equal_reference(monkeypatch, extra):
    argv = ["--reduced", "--requests", "1", "--batch", "1", "--prompt-len", "4", "--gen", "2",
            *extra]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(SystemExit) as ref_exit:
        ref_cli.main()
    with pytest.raises(SystemExit) as port_exit:
        cli.main(argv + ["--device", "cpu"])
    assert str(port_exit.value) == str(ref_exit.value)
    assert str(port_exit.value).startswith("--")


def test_cli_sharded_serving_exits_with_a_message():
    with pytest.raises(SystemExit, match="sharded serving is not ported"):
        cli.main(SMALL + ["--mesh", "2"])
