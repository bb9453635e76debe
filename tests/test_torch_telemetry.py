"""repro_torch.telemetry against repro.telemetry, and the engine's telemetry
hooks against the reference engine's, on the CPU.

* ``MetricsRegistry``, ``Histogram``, ``log_bucket_edges``: the same
  observations give the reference's snapshot, JSON file and summary
  string exactly (pure Python on both sides).
* ``Tracer``: the same calls give the reference's events, timestamps
  aside, and the Chrome trace-event schema (restated from
  ``tests/test_telemetry.py``: metadata per track, ``ts >= 0``, ``dur >=
  0``, per-track timestamps that never go back).
* ``Engine(metrics=, tracer=)`` on a reduced GLM-4-9B paged, prefix-cached
  serve (slots 2, k_steps 4, blocks of 8): tokens, ``host_syncs``,
  ``dispatches`` and the counters equal with telemetry on and off (exact);
  the snapshot's keys, histogram counts and gauges and the trace's tracks
  and per-track event counts equal the reference engine's on the same
  prompts and weights (exact: they count events, not values); the
  reference test's conservation checks, a warm second serve included.  A
  speculative serve sets ``spec.depth`` and ``spec.acceptance_rate`` from
  its stats and counters.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.engine import Engine as RefEngine
from repro.models import build_model as ref_build_model
from repro.telemetry import MetricsRegistry as RefRegistry
from repro.telemetry import Tracer as RefTracer
from repro.telemetry.metrics import Histogram as RefHistogram
from repro.telemetry.metrics import log_bucket_edges as ref_edges
from repro_torch.compat import params_from_jax
from repro_torch.configs import QuantConfig, get_arch, reduced
from repro_torch.engine import Engine
from repro_torch.models import build_model
from repro_torch.quantize import quantize
from repro_torch.telemetry import (COUNTER_KEYS, METRICS_SCHEMA, Histogram, MetricsRegistry,
                                   Tracer)
from repro_torch.telemetry.metrics import log_bucket_edges


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

    def draw(s):
        if len(s.shape) >= 2:
            return rng.standard_normal(s.shape) * s.shape[-2] ** -0.5
        return 1.0 + 0.1 * rng.standard_normal(s.shape)

    ref_params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(draw(s).astype(np.float32)).astype(jnp.bfloat16), shapes)
    model = build_model(reduced(get_arch("glm4-9b")), device="cpu")
    return ref_model, ref_params, model, params_from_jax(jax.device_get(ref_params))


# ---------------------------------------------------------------------------
# Metrics and traces, unit by unit
# ---------------------------------------------------------------------------

def _observe_all(reg):
    """One set of observations: counters, set and unset gauges, histograms
    with under- and overflow, edge values and a repeated get-or-create."""
    reg.counter("a").inc()
    reg.counter("a").inc(2)
    reg.counter("z.requests").inc(7)
    reg.gauge("g").set(3.5)
    reg.gauge("unset")
    reg.gauge("ratio").set(2 / 3)
    h = reg.histogram("lat", unit="s")
    for v in (1e-5, 0.1, 0.25, 3.0, 999.9, 1e3, 5e3, *h.edges[:5]):
        h.observe(v)
    t = reg.histogram("len", lo=1.0, hi=1e6, unit="tokens")
    for v in range(1, 200, 7):
        t.observe(v)
    reg.histogram("frac", lo=1e-3, hi=1.0).observe(0.5)
    reg.histogram("empty", unit="s")
    reg.histogram("lat", lo=5.0)          # get-or-create keeps the first


def test_registry_snapshot_and_summary_equal_reference(tmp_path):
    ref, port = RefRegistry(), MetricsRegistry()
    _observe_all(ref)
    _observe_all(port)
    assert METRICS_SCHEMA == "repro.telemetry.metrics/v1"
    snap = port.snapshot()
    assert snap == ref.snapshot()
    assert snap["schema"] == METRICS_SCHEMA
    assert snap["gauges"]["unset"] is None
    assert "p50" not in snap["histograms"]["empty"]
    assert port.summary() == ref.summary()
    assert "unset: n/a" in port.summary()
    ref.save(tmp_path / "ref.json")
    port.save(tmp_path / "port.json")
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
    assert json.loads((tmp_path / "port.json").read_text()) == snap


@pytest.mark.parametrize("lo,hi,n", [(1e-4, 1e3, 32), (1.0, 1e6, 32), (1e-3, 1.0, 32),
                                     (1.0, 100.0, 4), (1e-3, 1e3, 6), (0.3, 0.7, 1)])
def test_bucket_edges_and_membership_equal_reference(lo, hi, n):
    assert log_bucket_edges(lo, hi, n) == ref_edges(lo, hi, n)
    ref, port = RefHistogram("h", lo=lo, hi=hi, n_buckets=n), Histogram("h", lo=lo, hi=hi,
                                                                        n_buckets=n)
    vals = [*port.edges, *np.geomspace(lo / 3, hi * 3, 97).tolist(), lo * 0.999999, hi]
    for v in vals:
        ref.observe(v)
        port.observe(v)
    assert port.bucket_counts == ref.bucket_counts
    assert sum(port.bucket_counts) == port.count == len(vals)
    assert [port.percentile(q) for q in (0.5, 50, 95, 99, 100)] == \
        [ref.percentile(q) for q in (0.5, 50, 95, 99, 100)]
    assert port.to_dict() == ref.to_dict()


def test_bucket_edges_reject_what_the_reference_rejects():
    for bad in ((0.0, 1.0, 4), (2.0, 1.0, 4), (1.0, 1.0, 4), (1.0, 2.0, 0)):
        with pytest.raises(ValueError) as port_err:
            log_bucket_edges(*bad)
        with pytest.raises(ValueError) as ref_err:
            ref_edges(*bad)
        assert str(port_err.value) == str(ref_err.value)


def _check_chrome_trace(doc):
    """The Chrome trace-event schema: the two top-level keys, metadata for
    every track, ``ts >= 0``, ``dur >= 0``, an instant's scope, and
    timestamps that never go back within a track."""
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    per_track: dict = {}
    meta_tids = set()
    for ev in evs:
        assert {"name", "ph", "pid"} <= set(ev)
        if ev["ph"] == "M":
            if ev["name"] == "thread_name":
                meta_tids.add(ev["tid"])
            continue
        assert ev["ts"] >= 0
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
        if ev["ph"] == "i":
            assert ev["s"] in ("t", "p", "g")
        if ev["ph"] in ("X", "i"):
            per_track.setdefault(ev["tid"], []).append(ev["ts"])
    for tid, ts in per_track.items():
        assert ts == sorted(ts), f"track {tid} timestamps not monotonic"
    assert set(per_track) <= meta_tids, "track without thread_name metadata"
    return evs


def _untimed(doc):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur")}
            for ev in doc["traceEvents"] if ev.get("name") != "process_name"]


def test_tracer_events_equal_reference(tmp_path):
    docs = []
    for tr in (RefTracer(), Tracer()):
        t0 = tr.now_us()
        tr.instant("admission", "req0", {"prompt_len": 16})
        tr.complete("dispatch", "decode", t0, {"k_steps": 8})
        tr.counter("tokens", {"emitted": 5})
        tr.instant("admission", "req1")
        tr.complete("dispatch", "decode", tr.now_us())
        tr.instant("eviction", "evict", {"blocks": 3})
        tr.counter("blocks", {"live": 4, "cow": 1})
        docs.append(tr.to_dict())
    ref, port = docs
    evs = _check_chrome_trace(port)
    assert _untimed(port) == _untimed(ref)
    assert port["traceEvents"][0] == {"name": "process_name", "ph": "M", "pid": 1,
                                      "args": {"name": "repro_torch.engine"}}
    assert [ev["ph"] for ev in evs].count("X") == 2
    tr.save(tmp_path / "trace.json")
    assert json.loads((tmp_path / "trace.json").read_text()) == tr.to_dict()


# ---------------------------------------------------------------------------
# The engine's hooks
# ---------------------------------------------------------------------------

PROMPTS = [np.concatenate([_prompt(7, 16), _prompt(50 + i, 8)]) for i in range(4)]
KW = dict(slots=2, cache_len=48, k_steps=4, paged=True, block_size=8, prefix_cache=True)


def _tracks(doc) -> dict:
    """Track name -> (events on it by phase), and counter-track samples."""
    names = {ev["tid"]: ev["args"]["name"] for ev in doc["traceEvents"]
             if ev["ph"] == "M" and ev["name"] == "thread_name"}
    out: dict = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] in ("X", "i"):
            key = (names[ev["tid"]], ev["ph"], ev["name"], tuple(sorted(ev.get("args", {}))))
        elif ev["ph"] == "C":
            key = ("counter", ev["name"], tuple(sorted(ev["args"])))
        else:
            continue
        out[key] = out.get(key, 0) + 1
    return out


def _shape(snap) -> dict:
    """A snapshot without the values that are times or depend on them."""
    return {"schema": snap["schema"], "counters": snap["counters"], "gauges": snap["gauges"],
            "histograms": {k: (h["unit"], h["edges"], h["count"]) for k, h in
                           snap["histograms"].items()}}


def test_prefix_serve_telemetry_free_and_equal_to_reference(models):
    """Metrics and tracer on vs off: identical tokens, host syncs,
    dispatches and counters; the snapshot and the trace match the
    reference engine's in everything that counts events; conservation
    holds over a cold and a warm serve."""
    ref_model, ref_params, model, params = models
    gen = 6
    reg, tr = MetricsRegistry(), Tracer()
    e_on = Engine(model, params, check_invariants=True, metrics=reg, tracer=tr, **KW)
    e_off = Engine(model, params, check_invariants=True, **KW)
    outs_on, st_on = e_on.serve(PROMPTS, gen_tokens=gen, return_stats=True)
    outs_off, st_off = e_off.serve(PROMPTS, gen_tokens=gen, return_stats=True)
    assert outs_on == outs_off
    for k in ("host_syncs", "dispatches", "prefill_calls", "counters"):
        assert st_on[k] == st_off[k], k

    c = st_on["counters"]
    assert set(c) == set(COUNTER_KEYS)
    assert c["tokens"] == st_on["tokens"]
    assert c["chunks_completed"] == len(PROMPTS)
    assert c["prefix_hit_tokens"] == st_on["prefix_hits"]
    assert c["blocks_popped"] - c["blocks_released"] == len(e_on._hold_blocks)
    assert c["drafted"] == c["accepted"] + c["rejected"] == 0

    snap = reg.snapshot()
    assert snap["counters"]["requests.completed"] == len(PROMPTS)
    assert snap["counters"]["device.tokens"] == c["tokens"]
    for h in ("request.ttft_s", "request.tpot_s", "request.queue_wait_s",
              "request.prompt_len", "request.gen_len", "request.prefix_hit_frac"):
        assert snap["histograms"][h]["count"] == len(PROMPTS)
        assert snap["histograms"][h]["p50"] is not None
    assert snap["gauges"]["alloc.live_blocks"] == len(e_on._hold_blocks)
    assert "spec.acceptance_rate" not in snap["gauges"]
    evs = _check_chrome_trace(tr.to_dict())
    tracks = {ev["args"]["name"] for ev in evs if ev["ph"] == "M" and ev["name"] == "thread_name"}
    assert {"admission", "dispatch", "prefill-chunk"} <= tracks
    assert any(ev["ph"] == "C" for ev in evs)

    # the reference engine on the same prompts and weights
    ref_reg, ref_tr = RefRegistry(), RefTracer()
    ref_eng = RefEngine(ref_model, ref_params, metrics=ref_reg, tracer=ref_tr, **KW)
    ref_eng.serve([jnp.asarray(p) for p in PROMPTS], gen_tokens=gen)
    ref_snap = ref_reg.snapshot()
    assert _shape(snap) == _shape(ref_snap)
    for h in ("request.prompt_len", "request.gen_len", "request.prefix_hit_frac"):
        assert snap["histograms"][h] == ref_snap["histograms"][h], h
    assert _tracks(tr.to_dict()) == _tracks(ref_tr.to_dict())

    # warm second serve: counters zero again, conservation counts from the
    # blocks the index held
    outs2, st2 = e_on.serve(PROMPTS, gen_tokens=gen, return_stats=True)
    ref_eng.serve([jnp.asarray(p) for p in PROMPTS], gen_tokens=gen)
    assert outs2 == outs_on
    c2 = st2["counters"]
    assert (c2["blocks_popped"] - c2["blocks_released"] + c["blocks_popped"]
            - c["blocks_released"] == len(e_on._hold_blocks))
    assert c2["prefix_hit_tokens"] == st2["prefix_hits"] > c["prefix_hit_tokens"]
    _check_chrome_trace(tr.to_dict())
    assert _shape(reg.snapshot()) == _shape(ref_reg.snapshot())
    assert _tracks(tr.to_dict()) == _tracks(ref_tr.to_dict())


def test_contiguous_serve_records_what_the_reference_records(models):
    """The one-shot loop: one admission span a prefill call, one dispatch
    span and one tokens sample a dispatch, a request's TTFT at its
    admission; ``gen_tokens=1`` finishes requests at admission."""
    ref_model, ref_params, model, params = models
    prompts = [_prompt(s, L) for s, L in ((0, 10), (1, 7), (3, 9))]
    for gen in (5, 1):
        docs, snaps = [], []
        for eng_cls, m, p, ps in ((Engine, model, params, prompts),
                                  (RefEngine, ref_model, ref_params,
                                   [jnp.asarray(x) for x in prompts])):
            reg = (MetricsRegistry if eng_cls is Engine else RefRegistry)()
            tr = (Tracer if eng_cls is Engine else RefTracer)()
            eng_cls(m, p, slots=2, cache_len=24, k_steps=3, metrics=reg,
                    tracer=tr).serve(ps, gen_tokens=gen)
            docs.append(_tracks(tr.to_dict()))
            snaps.append(_shape(reg.snapshot()))
        assert docs[0] == docs[1] and snaps[0] == snaps[1], gen
        assert snaps[0]["counters"]["requests.completed"] == len(prompts)


def test_speculative_serve_sets_spec_gauges(models):
    """``spec.depth`` is the serve's final depth and
    ``spec.acceptance_rate`` accepted / drafted of its counters; the trace
    has one ``spec`` span a dispatch with the depth it ran at; on and off
    serve the same tokens and syncs."""
    _, _, model, params = models
    draft, _ = quantize(params, None, QuantConfig(block_size=32), mode="storage",
                        out_dtype="bfloat16")
    kw = dict(slots=2, cache_len=40, k_steps=3, paged=True, block_size=8, n_spec=2,
              draft_params=draft, check_invariants=True)
    prompts = [_prompt(s, L) for s, L in ((0, 10), (1, 25), (3, 6), (4, 17))]
    reg, tr = MetricsRegistry(), Tracer()
    outs, st = Engine(model, params, metrics=reg, tracer=tr, **kw).serve(
        prompts, gen_tokens=6, return_stats=True)
    outs_off, st_off = Engine(model, params, **kw).serve(prompts, gen_tokens=6,
                                                         return_stats=True)
    assert outs == outs_off
    for k in ("host_syncs", "dispatches", "counters", "draft_tokens", "spec_depth"):
        assert st[k] == st_off[k], k
    c, g = st["counters"], reg.snapshot()["gauges"]
    assert c["drafted"] > 0
    assert g["spec.depth"] == st["spec_depth"]
    assert g["spec.acceptance_rate"] == c["accepted"] / c["drafted"]
    spans = [ev for ev in _check_chrome_trace(tr.to_dict()) if ev["ph"] == "X"
             and ev["name"] == "rounds"]
    assert len(spans) == st["dispatches"]
    assert sum(ev["args"]["drafted"] for ev in spans) == c["drafted"]
    assert sum(ev["args"]["accepted"] for ev in spans) == c["accepted"]
    assert all(1 <= ev["args"]["depth"] <= 2 for ev in spans)
