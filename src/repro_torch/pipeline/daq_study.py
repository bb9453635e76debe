"""End-to-end DAQ study: the paper's Tables 2-5 at CPU scale.

Port of ``repro/pipeline/daq_study.py``.  Protocol (paper §3.1):
  1. train a base LM on the plain bigram corpus           -> W_base
  2. SFT it on the stylized corpus at a low learning rate -> W_post
  3. quantize W_post under each setting; measure
       ΔW-L2 / SignRate / CosSim  (exact, from repro_torch.quantize)
       Style / General            (rubric-proxy scores in [0, 2])

Every setting — AbsMax, DAQ x {mse, sign, cosine}, SmoothQuant, AWQ — runs
through the one entry point ``repro_torch.quantize.quantize``; the method is
``QuantConfig.method`` and calibration flows through the registry's
``calibrate`` hook.  This module holds only the study's orchestration
(training, caching, evaluation, tables).

Settings:
  Table 2: base, post, AbsMax (block / channel, int4 and fp8),
           SmoothQuant, AWQ (per channel, calibration-based)
  Table 3: MSE-guided scale search x {block, channel} x 3 ranges
  Table 4: Sign-guided              x ...
  Table 5: Cosine-guided            x ...

Checkpoints are cached under ``study_dir`` (``experiments/study/`` by
default), so the tables re-run without training; ``retrain`` forces a fresh
pair.  The SFT starts from the base weights, its optimizer state built from
them (``launch/train.py``), so ``W_post - W_base`` is the delta of the SFT
steps alone.
"""
from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.configs import ModelConfig, QuantConfig, TrainConfig
from repro_torch.data import LanguageSpec, eval_scores
from repro_torch.models import build_model
from repro_torch.quantize import quantize

STUDY_DIR = "experiments/study"

# The study model: dense glm4-family at CPU scale, sized so the stylized
# behaviour is learnable yet the SFT delta stays small-magnitude (fragile
# under quantization — the paper's regime).
STUDY_CFG = ModelConfig(
    name="study-dense", family="dense", n_layers=3, d_model=96,
    n_heads=6, n_kv_heads=2, d_ff=256, vocab_size=512, head_dim=16,
    rope_theta=10000.0, source="study", notes="DAQ study model")

BASE_TC = TrainConfig(learning_rate=1e-3, warmup_steps=30, total_steps=600,
                      weight_decay=0.01, seed=0)
SFT_TC = TrainConfig(learning_rate=5e-4, warmup_steps=10, total_steps=350,
                     weight_decay=0.0, seed=1)
BATCH, SEQ = 16, 128

# Study quantization format: INT4 at block 32 puts toy weights in the
# paper's fragile-delta regime (E4M3's ~4 % noise cannot erase behaviour at
# this scale); the fp8 rows of Table 2 are reported beside it.
STUDY_FMT = "int4"
STUDY_BLOCK = 32

RANGES = [(0.5, 2.0), (0.8, 1.25), (0.9, 1.11)]


def language(cfg: ModelConfig = STUDY_CFG) -> LanguageSpec:
    # hard_style: the style also permutes the bigram table — a behaviour
    # spread across many small weights (the paper's fragile regime)
    return LanguageSpec(vocab=cfg.vocab_size, seed=1234, hard_style=True)


def prepare_models(*, retrain: bool = False, study_dir: str = STUDY_DIR,
                   base_steps: int | None = None, sft_steps: int | None = None,
                   device=None):
    """Returns ``(model, params_base, params_post)`` on ``device`` (the card
    unless the caller names another), training each model whose final
    checkpoint is not cached under ``study_dir``."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.launch.train import initial_state, train_loop

    cfg = STUDY_CFG
    model = build_model(cfg, device=device)
    spec = language(cfg)
    base_dir = os.path.join(study_dir, "base")
    sft_dir = os.path.join(study_dir, "sft")
    base_tc = dataclasses.replace(BASE_TC, total_steps=base_steps or BASE_TC.total_steps)
    sft_tc = dataclasses.replace(SFT_TC, total_steps=sft_steps or SFT_TC.total_steps)

    if retrain:
        import shutil
        shutil.rmtree(study_dir, ignore_errors=True)

    if ckpt.latest(base_dir) != base_tc.total_steps:
        print("[study] training base model...", flush=True)
        train_loop(model, base_tc, batch_size=BATCH, seq=SEQ, steps=base_tc.total_steps,
                   ckpt_dir=base_dir, save_every=200, style=False, language=spec,
                   log_every=100)
    params_base = ckpt.restore(base_dir, ckpt.latest(base_dir),
                               initial_state(model, base_tc))["params"]

    if ckpt.latest(sft_dir) != sft_tc.total_steps:
        print("[study] SFT on stylized corpus...", flush=True)
        train_loop(model, sft_tc, batch_size=BATCH, seq=SEQ, steps=sft_tc.total_steps,
                   ckpt_dir=sft_dir, save_every=200, style="mixed", language=spec,
                   log_every=50, init_params=params_base)
    params_post = ckpt.restore(sft_dir, ckpt.latest(sft_dir),
                               initial_state(model, sft_tc, params_base))["params"]
    return model, params_base, params_post


def evaluate(model, params, spec: LanguageSpec) -> dict:
    # 32 x 192 ~ 6k positions per corpus: score noise ~ +-0.01
    return eval_scores(model, params, spec, batch=32, seq=192, seed=999)


def quantize_and_eval(model, params_post, params_base, qcfg: QuantConfig,
                      spec: LanguageSpec) -> dict:
    """Quantize (method from ``qcfg.method``) and score; calibration-based
    methods collect activation statistics through the registry's hook."""
    qparams, report = quantize(params_post, params_base, qcfg, mode="dequant",
                               out_dtype="float32", model=model, spec=spec)
    scores = evaluate(model, qparams, spec)
    g = report.global_chosen
    return {"delta_l2": g["delta_l2"], "sign_rate": g["sign_rate"],
            "cosine": g["cosine"], "mse": g["mse"],
            "style": scores["style"], "general": scores["general"]}


def run_tables(tables=("2", "3", "4", "5"), *, retrain: bool = False,
               study_dir: str = STUDY_DIR, out_path: str | None = None,
               extra_qcfg: dict | None = None, base_steps: int | None = None,
               sft_steps: int | None = None, device=None) -> dict:
    """The study's tables, each row printed and written to ``out_path``
    (``<study_dir>/tables.json``) as it lands; rows already there are kept.
    ``study_dir``, the step budgets and ``device`` go to
    :func:`prepare_models`."""
    out_path = out_path or os.path.join(study_dir, "tables.json")
    model, params_base, params_post = prepare_models(
        retrain=retrain, study_dir=study_dir, base_steps=base_steps, sft_steps=sft_steps,
        device=device)
    spec = language()
    results: dict = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)

    def put(table, row_name, row):
        results.setdefault(table, {})[row_name] = row
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
        cols = " ".join(f"{k}={v:.4f}" for k, v in row.items() if isinstance(v, float))
        print(f"[T{table}] {row_name:34s} {cols}", flush=True)

    def missing(table, name):
        return name not in results.get(table, {})

    kw = {"fmt": STUDY_FMT, "block_size": STUDY_BLOCK, **(extra_qcfg or {})}
    fmt_tag = kw["fmt"]

    if "2" in tables:
        if missing("2", "base_bf16"):
            s = evaluate(model, params_base, spec)
            put("2", "base_bf16", {"style": s["style"], "general": s["general"]})
        if missing("2", "post_bf16"):
            s = evaluate(model, params_post, spec)
            put("2", "post_bf16", {"style": s["style"], "general": s["general"],
                                   "delta_l2": 0.0, "sign_rate": 1.0, "cosine": 1.0})
        for gran in ("block", "channel"):
            for fmt in (fmt_tag, "fp8_e4m3"):
                name = f"absmax_{fmt}_{gran}"
                if missing("2", name):
                    q = QuantConfig(**{**kw, "fmt": fmt, "granularity": gran,
                                       "method": "absmax"})
                    put("2", name, quantize_and_eval(model, params_post, params_base, q, spec))
        for method in ("smoothquant", "awq"):
            name = f"{method}_{fmt_tag}_channel"
            if missing("2", name):
                q = QuantConfig(**{**kw, "granularity": "channel", "method": method})
                put("2", name, quantize_and_eval(model, params_post, params_base, q, spec))

    for t, metric in {"3": "mse", "4": "sign", "5": "cosine"}.items():
        if t not in tables:
            continue
        for gran in ("block", "channel"):
            for lo, hi in RANGES:
                name = f"{metric}_{gran}_[{lo},{hi}]"
                if missing(t, name):
                    q = QuantConfig(metric=metric, granularity=gran, alpha_min=lo,
                                    alpha_max=hi, n_coarse=5, n_fine=10, **kw)
                    put(t, name, quantize_and_eval(model, params_post, params_base, q, spec))
    return results
