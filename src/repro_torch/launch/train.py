"""Fault-tolerant training driver.

Port of ``repro/launch/train.py``:

* **Deterministic data** — batch ``t`` is a pure function of ``(seed, t)``
  drawn on the host (``data/synthetic.py::train_batch``), so any step
  replays after a restart, on this machine or another.
* **Restart loop** — any step failure reloads the latest checkpoint and
  resumes (the checkpoint restores into a freshly initialized state of the
  same layout, ``checkpoint.restore``'s ``like``), up to ``max_restarts``.
* **Heartbeat** — every step writes ``heartbeat.json`` (step, time, pid)
  atomically, for an external watchdog.
* **Checkpoint cadence** — an atomic save every ``save_every`` steps and at
  the end, ``keep_last`` retained, each with ``extra_meta``.
* **Host reads** — a step's metrics are device tensors; they are read
  (``float()``) only every ``log_every`` steps.

With ``init_params`` (fine-tuning from a base model) the optimizer state,
the fp32 master copy included, is built from those weights.  The reference
builds it from the random init and then swaps the weights in, so on a
bfloat16 tree its first update starts from the random init's master
(ROADMAP Queue C 19); the port does not copy that.

Usage (CPU scale; ``--device cpu``, else the card):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch glm4-9b --reduced \\
      --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch mixtral-8x22b \\
      --reduced --steps 20 --batch 4 --seq 64   # MoE: the log adds the router's aux loss
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import TrainConfig, get_arch
from repro_torch.configs import reduced as reduce_cfg
from repro_torch.core.policy import tree_map
from repro_torch.data import LanguageSpec, modality_extras, train_batch
from repro_torch.launch.serve import capped_language
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models import build_model


def write_heartbeat(path: str, step: int, extra: dict | None = None) -> None:
    hb = {"step": step, "time": time.time(), "pid": os.getpid(), **(extra or {})}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(hb, f)
    os.replace(tmp, path)


def default_language(cfg, seed: int) -> LanguageSpec:
    """The training language of ``cfg``: its vocabulary, capped at
    ``launch/serve.py::SPEC_VOCAB_CAP`` tokens as the serve CLI's (the
    [V, V] float32 table would be 91.9 GB at GLM-4-9B's 151,552)."""
    return capped_language(cfg.vocab_size, "[train] batches", seed)


def initial_state(model, tc: TrainConfig, init_params=None) -> dict:
    """A fresh train state: the model's init from ``tc.seed``, or a copy of
    ``init_params`` (the step updates its state in place, and the caller's
    weights must survive) with its optimizer state built from them."""
    gen = torch.Generator(device=model.device).manual_seed(tc.seed)
    params = None if init_params is None else tree_map(torch.clone, init_params)
    return init_train_state(model, tc, gen, params)


def train_loop(model, tc: TrainConfig, *, batch_size: int, seq: int, steps: int,
               ckpt_dir: str, save_every: int = 50, keep_last: int = 3, style=False,
               language: LanguageSpec | None = None, log_every: int = 10,
               init_params=None, max_restarts: int = 3) -> dict:
    """Run (or resume) training; returns ``{"state", "metrics"}`` (the last
    logged metrics as floats)."""
    from repro_torch import checkpoint as ckpt

    cfg = model.cfg
    spec = language or default_language(cfg, tc.seed + 100)
    step_fn = make_train_step(model, tc)
    hb_path = os.path.join(ckpt_dir, "heartbeat.json")
    os.makedirs(ckpt_dir, exist_ok=True)

    restarts = 0
    while True:  # restart loop: any failure past this point resumes
        try:
            state = initial_state(model, tc, init_params)
            latest = ckpt.latest(ckpt_dir)
            start = 0
            if latest is not None:
                state = ckpt.restore(ckpt_dir, latest, state)
                start = latest

            last_metrics: dict = {}
            for t in range(start, steps):
                batch = train_batch(spec, tc.seed, t, batch_size, seq, style=style,
                                    device=model.device)
                batch.update(modality_extras(cfg, batch_size, seq, tc.seed, t))
                state, metrics = step_fn(state, batch)
                if (t + 1) % log_every == 0 or t + 1 == steps:
                    last_metrics = {k: float(v) for k, v in metrics.items()}
                    print(f"step {t + 1:5d} loss={last_metrics['loss']:.4f} "
                          f"acc={last_metrics['accuracy']:.4f} "
                          f"lr={last_metrics['lr']:.2e} "
                          f"gnorm={last_metrics['grad_norm']:.3f}"
                          + (f" aux={last_metrics['aux_loss']:.5f}" if cfg.family == "moe"
                             else ""), flush=True)
                write_heartbeat(hb_path, t + 1)
                if (t + 1) % save_every == 0:
                    ckpt.save(ckpt_dir, t + 1, state, keep_last=keep_last,
                              extra_meta={"arch": cfg.name})
            ckpt.save(ckpt_dir, steps, state, keep_last=keep_last,
                      extra_meta={"arch": cfg.name, "final": True})
            return {"state": state, "metrics": last_metrics}
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001 — restartable failure
            restarts += 1
            print(f"[train] step failure ({e!r}); restart {restarts}/{max_restarts} "
                  f"from latest checkpoint", flush=True)
            if restarts > max_restarts:
                raise


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--reduced", action="store_true", help="use the CPU-scale reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--style", action="store_true",
                    help="train on the stylized corpus (SFT phase)")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots_saveable"])
    ap.add_argument("--opt-dtype", default="float32", choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--grad-compress", default="none", choices=["none", "int8_ef"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' to run on the host)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); returns
    ``train_loop``'s result for in-process callers."""
    args = _parser().parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1), microbatch=args.microbatch,
                     remat=args.remat, opt_state_dtype=args.opt_dtype,
                     grad_compress=args.grad_compress, seed=args.seed)
    model = build_model(cfg, device=args.device)
    t0 = time.time()
    out = train_loop(model, tc, batch_size=args.batch, seq=args.seq, steps=args.steps,
                     ckpt_dir=args.ckpt_dir, save_every=args.save_every, style=args.style)
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    print(f"done: {args.steps} steps, {toks / dt:.0f} tok/s, "
          f"final loss {out['metrics'].get('loss', float('nan')):.4f}")
    return out


if __name__ == "__main__":
    main()
