"""Serving CLI: a thin driver over the device-resident engine.

Port of ``repro/launch/serve.py``.  All serving mechanics live in
:mod:`repro_torch.engine`; this module parses flags, builds (and optionally
quantizes) the model and calls ``Engine.serve``.  It takes every flag of the
reference, with the same checks and messages, and one more, ``--device``
(default ``cuda``: the card unless the caller asks for the CPU).

* **Quantized weights** — ``--daq`` serves weights quantized through
  ``repro_torch.quantize`` (``--method``, default ``daq``) at channel
  granularity, as the reference does.  Such weights reach no fp8 kernel
  (the block kernels take block-granularity E4M3 weights only): every
  product dequantizes its weight first.  Delta-aware methods want a real
  base model: ``--base-ckpt`` names a checkpoint directory
  (``repro_torch.checkpoint``, readable from the reference's too, bare
  params or a train state with a ``params`` subtree); without it a jittered
  copy stands in, with a warning.
* **Speculative decoding** — ``--spec-draft METHOD --n-spec N`` (with
  ``--paged``) quantizes the weights with METHOD as the draft, verified by
  the full-precision weights; composes with ``--prefix-cache`` /
  ``--chunk-size``; ``--spec-static`` pins the depth at N.
* **Prompts and calibration** come from the synthetic language
  ``LanguageSpec``, drawn from a ``torch.Generator`` seeded with the
  request's index, so the same flags give the same tokens (the reference
  draws from ``jax.random``: the two agree in distribution only).  Its
  ``[V, V]`` float32 bigram table is built on the host, 91.9 GB at
  GLM-4-9B's 151,552 tokens, so above ``SPEC_VOCAB_CAP`` tokens the CLI
  uses a ``SPEC_VOCAB_CAP``-token language (its ids are valid ids of the
  model's vocabulary) and says so; ``--reduced`` (512 tokens) uses the
  full vocabulary, as the reference does.
* **Every family on every engine** — ``--paged``, ``--chunk-size``,
  ``--prefix-cache`` and ``--spec-draft`` serve the MoE (``deepseek-v3``,
  and ``mixtral-8x22b`` with its sliding-window ring caches) and SSM
  (``mamba2-780m``) archs too; a configuration the engine's rules refuse
  (``--spec-draft`` on MoE below dropless capacity, an SSM
  ``--chunk-size`` off the ``ssm_chunk`` grid, a ``--block-size`` that
  does not divide the sliding window) exits with the engine's message
  before any weights are made.
* **Not ported**: ``--mesh`` other than 0 (sharded serving, ROADMAP Queue
  A 9) exits with a message, and so does ``--daq --method smoothquant`` /
  ``awq`` on an MoE arch (their calibration forward runs no MoE layer yet,
  ROADMAP Queue A 5); the
  reference's ``compiles:`` line (its jit cache sizes) has no counterpart,
  since the port compiles nothing at serve time.

Usage (CPU-scale):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch glm4-9b --reduced \\
      --requests 6 --batch 2 --prompt-len 16 --gen 8 --k-steps 8 \\
      [--daq [--method daq] [--base-ckpt DIR]] \\
      [--paged --spec-draft daq --n-spec 4] \\
      [--temperature 0.8 --top-k 40 --top-p 0.95] \\
      [--metrics-out metrics.json --trace-out trace.json]

``--metrics-out`` writes the request-lifecycle metrics snapshot
(``repro.telemetry.metrics/v1`` JSON) and ``--trace-out`` a Chrome /
Perfetto trace of the serve; the summary is printed from the same registry
either way.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import QuantConfig, get_arch
from repro_torch.configs import reduced as reduce_cfg
from repro_torch.core.policy import tree_map
from repro_torch.data import LanguageSpec, sample_batch
from repro_torch.engine import Engine, EngineConfig, SamplingParams
from repro_torch.engine.engine import check_config
from repro_torch.models import build_model

# the largest synthetic-language vocabulary the CLI builds: its [V, V]
# float32 bigram table is 67 MB at 4,096 tokens
SPEC_VOCAB_CAP = 4096


def capped_language(vocab: int, what: str, seed: int = 1234) -> LanguageSpec:
    """The synthetic language of a ``vocab``-token model: its vocabulary,
    capped at ``SPEC_VOCAB_CAP`` tokens (a capped language's ids are valid
    ids of the model's vocabulary), which it prints, ``what`` naming the
    caller and the use (``"[serve] prompts and calibration"``)."""
    spec = LanguageSpec(vocab=min(vocab, SPEC_VOCAB_CAP), seed=seed)
    if spec.vocab < vocab:
        print(f"{what} use LanguageSpec(vocab={spec.vocab}), not the model's {vocab} "
              f"tokens: its [V, V] float32 bigram table would take "
              f"{4 * vocab ** 2 / 1e9:.1f} GB", flush=True)
    return spec


def serve(model, params, requests, *, batch: int, gen_tokens: int, cache_len: int,
          greedy: bool = True, sampling: SamplingParams | None = None, k_steps: int = 8,
          mesh=None, seed: int = 0) -> list[list[int]]:
    """Compat wrapper: serve ``requests`` through a fresh :class:`Engine`
    (new code should build an ``Engine`` and reuse it across calls)."""
    if mesh is not None:
        raise NotImplementedError("sharded serving is not ported (ROADMAP Queue A 9)")
    sp = sampling or SamplingParams(greedy=greedy)
    eng = Engine(model, params, slots=batch, cache_len=cache_len, k_steps=k_steps, sampling=sp)
    return eng.serve(requests, gen_tokens=gen_tokens, seed=seed)


def _load_base_params(base_ckpt: str, params):
    """Base tree for delta-aware quantization.

    With ``--base-ckpt``: restore the base model through
    ``repro_torch.checkpoint`` onto ``params``' devices (a bare params tree
    or a train state with a ``params`` subtree, told apart by the
    manifest).  Without: a jittered copy of the serving weights — delta
    metrics are then meaningless, so warn loudly."""
    if base_ckpt:
        from repro_torch import checkpoint as ckpt
        step = ckpt.latest(base_ckpt)
        if step is None:
            raise SystemExit(f"--base-ckpt {base_ckpt}: no checkpoint found")
        # train-state checkpoints nest leaves under "params.", bare params
        # trees don't: a genuine restore failure (a shape mismatch) raises
        # as itself
        leaves = ckpt.meta(base_ckpt, step)["leaves"]
        if any(name.startswith("params.") for name in leaves):
            return ckpt.restore(base_ckpt, step, {"params": params})["params"]
        return ckpt.restore(base_ckpt, step, params)
    print("[serve] WARNING: no --base-ckpt given; using a jittered copy of "
          "the serving weights as the base model. Delta-aware metrics are "
          "meaningless against a fake base — pass --base-ckpt for real use.",
          flush=True)
    return tree_map(lambda p: p - 0.01 * torch.ones_like(p) * (p.ndim >= 2), params)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--k-steps", type=int, default=8,
                    help="decode steps per device dispatch (1 host sync "
                         "per k-steps tokens)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 = greedy (default)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation for sampling (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus (top-p) truncation for sampling "
                         "(1.0 = off)")
    ap.add_argument("--mesh", type=int, default=0, metavar="MP",
                    help="model-parallel size of a sharded serve (0 = "
                         "unsharded; sharded serving is not ported)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: global block pool + per-slot "
                         "block tables (memory proportional to live "
                         "tokens, not slots * cache_len)")
    ap.add_argument("--block-size", type=int, default=8,
                    help="tokens per KV block (with --paged)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="KV pool size in blocks; 0 = capacity parity "
                         "with the contiguous cache (with --paged)")
    ap.add_argument("--chunk-size", type=int, default=0,
                    help="chunked prefill: prompts stream through the "
                         "decode dispatch in pieces of this many tokens "
                         "instead of stalling decode (with --paged)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="refcounted prompt-prefix block sharing: matched "
                         "leading blocks are mapped instead of re-prefilled "
                         "and stay cached (LRU) after requests finish "
                         "(with --paged; implies chunked prefill)")
    ap.add_argument("--spec-draft", default="", metavar="METHOD",
                    help="self-speculative decoding: quantize the weights "
                         "with METHOD (repro_torch.quantize registry key, "
                         "e.g. daq | absmax) and use them as the draft model, "
                         "verified by the full-precision weights (requires "
                         "--paged)")
    ap.add_argument("--n-spec", type=int, default=4,
                    help="maximum drafted tokens per speculative round "
                         "(with --spec-draft; must be < --k-steps)")
    ap.add_argument("--spec-static", action="store_true",
                    help="pin the speculation depth at --n-spec instead of "
                         "moving it 1..n-spec from acceptance telemetry "
                         "(engine/spec.DepthController)")
    ap.add_argument("--daq", action="store_true",
                    help="serve fp8-quantized weights (repro_torch.quantize)")
    ap.add_argument("--metric", default="sign")
    ap.add_argument("--method", default=None,
                    help="quantization method registry key for --daq "
                         "serving (daq | absmax | daq-per-block | ...); "
                         "default daq.  The speculative draft's method is "
                         "--spec-draft's value, not this flag")
    ap.add_argument("--base-ckpt", default="",
                    help="checkpoint dir of the BASE model for delta-aware "
                         "quantization (loaded via repro_torch.checkpoint)")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="write the request-lifecycle metrics snapshot "
                         "(repro.telemetry.metrics/v1 JSON: TTFT/TPOT "
                         "percentiles, acceptance rate, prefix-hit "
                         "fraction, allocator gauges) to PATH")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="write a Chrome/Perfetto trace-event JSON of the "
                         "serve run (admission / dispatch / spec / "
                         "prefill-chunk / eviction tracks) to PATH — open "
                         "in https://ui.perfetto.dev or chrome://tracing")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs "
                         "every kernel's plain PyTorch version)")
    return ap


def _check_flags(args) -> None:
    """The reference's flag checks, with its messages, before any work."""
    if not args.daq and not args.spec_draft \
            and (args.base_ckpt or args.method is not None
                 or args.metric != "sign"):
        raise SystemExit("--method/--metric/--base-ckpt configure quantized "
                         "serving and require --daq (or --spec-draft)")
    if args.spec_draft and args.method is not None:
        raise SystemExit("--method configures --daq serving and is not "
                         "read by the speculative path: the draft's "
                         "quantization method IS --spec-draft's value "
                         f"({args.spec_draft!r}) — drop --method")
    if args.spec_draft and args.daq:
        raise SystemExit("--spec-draft verifies quantized drafts against "
                         "the FULL-precision weights; it cannot combine "
                         "with --daq (which quantizes the served weights)")
    if args.spec_draft and not args.paged:
        raise SystemExit("--spec-draft requires --paged (speculative "
                         "decoding rides the paged engine)")
    if (args.chunk_size or args.prefix_cache) and not args.paged:
        raise SystemExit("--chunk-size/--prefix-cache require --paged")
    if args.mesh:
        raise SystemExit("--mesh: sharded serving is not ported to repro_torch "
                         "(ROADMAP Queue A 9); serve with --mesh 0")


def main(argv: list[str] | None = None):
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None).  Returns
    (outputs, stats) of the serve for in-process callers."""
    args = _parser().parse_args(argv)
    _check_flags(args)

    try:
        cfg = get_arch(args.arch)
    except KeyError as e:
        raise SystemExit(f"--arch: {e.args[0]}")
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit("serve CLI drives LM-style archs; "
                         "vlm/encdec need modality inputs (see examples/)")
    cache_len = args.prompt_len + args.gen + 8
    if args.temperature <= 0 and args.top_k == 0 and args.top_p >= 1.0:
        sp = SamplingParams()                        # greedy
    else:  # any flag alone enables sampling (temperature defaults to 1)
        sp = SamplingParams(greedy=False,
                            temperature=args.temperature if args.temperature > 0 else 1.0,
                            top_k=args.top_k, top_p=args.top_p)
    ecfg = EngineConfig(slots=args.batch, cache_len=cache_len, k_steps=args.k_steps,
                        sampling=sp, paged=args.paged, block_size=args.block_size,
                        num_blocks=args.num_blocks, chunk_size=args.chunk_size,
                        prefix_cache=args.prefix_cache,
                        n_spec=args.n_spec if args.spec_draft else 0,
                        spec_dynamic=not args.spec_static)
    try:                    # before any weights are made or quantized
        check_config(cfg, ecfg)
    except ValueError as e:
        raise SystemExit(f"{cfg.name}: {e}")
    if args.daq and cfg.family == "moe":
        from repro_torch.quantize import available_methods, get_method
        if args.method in available_methods() and get_method(args.method).requires_calibration:
            raise SystemExit(f"{cfg.name}: --method {args.method} calibrates on a "
                             f"full-sequence forward, which runs no MoE layer yet "
                             f"(ROADMAP Queue A 5)")
    model = build_model(cfg, device=args.device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    spec = capped_language(cfg.vocab_size, "[serve] prompts and calibration")
    if args.daq:
        from repro_torch.quantize import quantize
        qcfg = QuantConfig(method=args.method or "daq", metric=args.metric,
                           granularity="channel")
        base = _load_base_params(args.base_ckpt, params)
        # model=/spec= feed the calibrate hook of calibration-based methods
        # (smoothquant/awq); data-free methods ignore them
        params, report = quantize(params, base, qcfg, mode="storage", out_dtype="bfloat16",
                                  model=model, spec=spec)
        del base
        print(report.summary())
    draft_params = None
    if args.spec_draft:
        from repro_torch.quantize import quantize
        qcfg = QuantConfig(method=args.spec_draft, metric=args.metric, granularity="channel")
        base = _load_base_params(args.base_ckpt, params)
        draft_params, report = quantize(params, base, qcfg, mode="storage",
                                        out_dtype="bfloat16", model=model, spec=spec)
        del base
        print(f"[serve] speculative draft ({args.spec_draft}):")
        print(report.summary())
    prompts = [sample_batch(torch.Generator(device=dev).manual_seed(i), spec, 1,
                            args.prompt_len, device=dev)[0] for i in range(args.requests)]

    from repro_torch.telemetry import MetricsRegistry, Tracer
    reg = MetricsRegistry()
    tracer = Tracer() if args.trace_out else None
    eng = Engine(model, params, ecfg, draft_params=draft_params, metrics=reg, tracer=tracer)

    t0 = time.time()
    outs, stats = eng.serve(prompts, gen_tokens=args.gen, return_stats=True)
    dt = time.time() - t0
    n_tok = sum(len(o) for o in outs)
    kind = "paged" if args.paged else "contiguous"
    if args.prefix_cache:
        kind += "+prefix"
    if args.spec_draft:
        kind += f"+spec({args.spec_draft})"
    extra = ""
    if args.paged and (args.chunk_size or args.prefix_cache):
        extra = (f", {stats['prefill_tokens']} prompt tokens prefilled"
                 + (f" ({stats.get('prefix_hits', 0)} prefix-hit)"
                    if args.prefix_cache else ""))
    snap = reg.snapshot()
    # acceptance / depth come from the metrics snapshot (the device counters
    # feed the spec.* gauges); non-speculative runs report n/a
    acc = snap["gauges"].get("spec.acceptance_rate")
    depth = snap["gauges"].get("spec.depth")
    extra += (", acceptance: n/a" if acc is None else
              f", draft acceptance {acc:.1%} over "
              f"{stats.get('spec_rounds', 0)} rounds of <={args.n_spec}, "
              f"final depth {depth:.0f}")
    print(f"served {args.requests} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok/dt:.1f} tok/s, "
          f"{stats['host_syncs']/max(n_tok, 1):.3f} host syncs/token; "
          f"{stats['dispatches']} dispatches of {args.k_steps} steps, "
          f"{stats['prefill_calls']} prefill calls; {kind} cache, "
          f"{stats['cache_bytes']} cache bytes{extra})")
    print("metrics:")
    print(reg.summary())
    if args.metrics_out:
        reg.save(args.metrics_out)
        print(f"[serve] metrics snapshot ({snap['schema']}) -> {args.metrics_out}")
    if tracer is not None:
        tracer.save(args.trace_out)
        print(f"[serve] perfetto trace ({len(tracer.events)} events) -> {args.trace_out}")
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: {o}")
    return outs, stats


if __name__ == "__main__":
    main()
