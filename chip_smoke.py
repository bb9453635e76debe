#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # full run: GLM-4-9B, 40 layers
    python3 chip_smoke.py --layers 8      # cut depth if a run overruns its time

Phases:
  1. environment (torch / CUDA versions, card name and power limit);
  2. build the four CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
     each, all at once);
  3. check each kernel against its plain PyTorch version at the shapes of
     the main path, with the tolerance stated below, and time both; the fp8
     matmul has two routes (CUDA cores for decode, wgmma tensor cores for
     prefill), each checked, and both timed across M to find where the
     tensor-core route starts to win;
  4. make full-width GLM-4-9B weights from a seeded ``torch.Generator``
     (base = post + Gaussian noise at 1 % of each matrix's std);
  5. quantize: ``quantize(post, base, QuantConfig(use_fused_kernel=True),
     mode="storage")``;
  6. serve 8 greedy requests (prompt 128, 64 generated tokens) through
     ``Engine(model, qparams, slots=8, k_steps=8)``;
  7. assert that every kernel launched on that quantize -> serve run, the
     wgmma route 7 x layers times per prefill and the CUDA-core route every
     decode product and LM head, and check the outputs: token ranges,
     report sanity, and a small model whose GPU run (kernels, the wgmma
     route included) agrees with its CPU run (plain versions);
  8. break one decode step and one prefill down: host time, device busy
     time, kernel launches and the kernels that take the device time.

It exits non-zero if any phase fails and when no CUDA device is present.
The last line of stdout is the JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16
# tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

PROMPT, GEN, SLOTS, K_STEPS = 128, 64, 8, 8


def log(*a):
    print(*a, flush=True)


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(torch, seed: int) -> dict:
    """Each kernel at main-path shapes vs its plain version.  Returns the
    per-kernel record of the representative shape (others are logged)."""
    from repro_torch.kernels.fp8_matmul.kernel import (TC_MIN_ROWS, matmul_fp8_cuda_core,
                                                       matmul_fp8_wgmma)
    from repro_torch.kernels.fp8_matmul.ref import matmul_fp8_ref
    from repro_torch.kernels.fp8_quant.kernel import quantize_fp8_cuda
    from repro_torch.kernels.fp8_quant.ref import quantize_fp8_ref
    from repro_torch.core.search import linspace
    from repro_torch.kernels.scale_search.kernel import sweep_partials_cuda
    from repro_torch.kernels.scale_search.ref import sweep_partials_ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    bs = 128
    records = {}

    def weights(I, O):
        wp = (torch.randn((I, O), generator=g, device=dev) * 0.02).bfloat16().float()
        wb = (wp + torch.randn((I, O), generator=g, device=dev) * 2e-4).bfloat16().float()
        return wp, wb

    # -- scale_search: sign counts exact, other sums |err| <= 1e-4 * |plain| + 1e-6 * max|plain|
    for (I, O), n_cand, main in (((4096, 13696), 6, False), ((4096, 13696), 11, True),
                                 ((4096, 151552), 11, False), ((384, 512), 11, False)):
        wp, wb = weights(I, O)
        amax = wp.reshape(I // bs, bs, O // bs, bs).abs().amax(dim=(1, 3)).clamp_min(1e-12)
        alphas = torch.cat([torch.ones(1, device=dev), linspace(0.8, 1.25, n_cand - 1, dev)])
        run_k = lambda: sweep_partials_cuda(wp, wb, amax, alphas, block_size=bs)
        run_p = lambda: sweep_partials_ref(wp, wb, amax, alphas, block_size=bs)
        pk, pp = run_k(), run_p()
        torch.cuda.synchronize()
        sign_diff = (pk[..., 1] - pp[..., 1]).abs().max().item()
        cont = [0, 2, 3, 4]
        err = (pk[..., cont] - pp[..., cont]).abs()
        tol = 1e-4 * pp[..., cont].abs() + 1e-6 * pp[..., cont].abs().max()
        ok = sign_diff == 0 and bool((err <= tol).all())
        ms = time_ms(torch, run_k, 10)
        plain_ms = time_ms(torch, run_p, 2)
        nb = (I // bs) * (O // bs)
        b_ms, b_by = bound(2 * I * O * 4 + nb * 4 + n_cand * 4 + n_cand * nb * 8 * 4,
                           I * O * (3 + 12 * n_cand), FP32_FLOPS)
        rec = dict(max_abs_err=float((pk - pp).abs().max()), ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log(f"kernel-check scale_search [{I},{O}] n_cand={n_cand}: sign-count diff "
            f"{sign_diff:g}, max |err| sums {err.max().item():.3e} -> {'ok' if ok else 'FAIL'}; "
            + json.dumps(rec))
        if not ok:
            raise AssertionError(f"scale_search kernel disagrees at [{I},{O}] n_cand={n_cand}")
        if main:
            records["scale_search"] = rec
        del wp, wb, pk, pp

    # -- fp8_quant: codes and scales bit-equal
    for (I, O), main in (((4096, 13696), True), ((4096, 151552), False),
                         ((256, 384), False)):
        w, _ = weights(I, O)
        alpha = torch.tensor([1.0375], device=dev)
        run_k = lambda: quantize_fp8_cuda(w, alpha, block=bs)
        run_p = lambda: quantize_fp8_ref(w, alpha, block=bs)
        (qk, sk), (qp, sp) = run_k(), run_p()
        torch.cuda.synchronize()
        code_mismatch = int((qk.view(torch.uint8) != qp.view(torch.uint8)).sum())
        scale_mismatch = int((sk != sp).sum())
        deq = lambda q, s: q.float().reshape(I // bs, bs, O // bs, bs) * s[:, None, :, None]
        max_err = float((deq(qk, sk) - deq(qp, sp)).abs().max())
        ok = code_mismatch == 0 and scale_mismatch == 0
        ms = time_ms(torch, run_k, 10)
        plain_ms = time_ms(torch, run_p, 3)
        b_ms, b_by = bound(I * O * 4 + I * O + (I // bs) * (O // bs) * 4 + 4, I * O * 4,
                           FP32_FLOPS)
        rec = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=None)
        log(f"kernel-check fp8_quant [{I},{O}]: {code_mismatch} code / {scale_mismatch} "
            f"scale mismatches -> {'ok' if ok else 'FAIL'}; " + json.dumps(rec))
        if not ok:
            raise AssertionError(f"fp8_quant kernel disagrees at [{I},{O}]")
        if main:
            records["fp8_quant"] = rec
        del w, qk, qp

    # -- fp8_matmul, both routes: |err| <= 1e-4 * |plain| + 1e-5 * max|plain|
    #    (fp32 sums in another order)
    def matmul_operands(M, K, N):
        w, _ = weights(K, N)
        wq, sc = quantize_fp8_ref(w, torch.ones(1, device=dev), block=bs)
        x = torch.randn((M, K), generator=g, device=dev).bfloat16()
        return x, wq, sc

    def check_matmul(name, run, M, K, N):
        x, wq, sc = matmul_operands(M, K, N)
        w_deq = (wq.float().reshape(K // bs, bs, N // bs, bs)
                 * sc[:, None, :, None]).reshape(K, N).bfloat16()
        run_k = lambda: run(x, wq, sc, block=bs)
        run_p = lambda: matmul_fp8_ref(x, wq, sc, block=bs)
        run_l = lambda: torch.matmul(x, w_deq)
        yk, yp = run_k(), run_p()
        torch.cuda.synchronize()
        err = (yk - yp).abs()
        ok = bool((err <= 1e-4 * yp.abs() + 1e-5 * yp.abs().max()).all())
        ms = time_ms(torch, run_k, 20)
        plain_ms = time_ms(torch, run_p, 5)
        lib_ms = time_ms(torch, run_l, 20)
        b_ms, b_by = bound(M * K * 2 + K * N + (K // bs) * (N // bs) * 4 + M * N * 4,
                           2 * M * K * N, BF16_FLOPS)
        rec = dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms)
        log(f"kernel-check {name} M={M} [{K},{N}]: -> {'ok' if ok else 'FAIL'}; "
            + json.dumps(rec))
        if not ok:
            raise AssertionError(f"{name} kernel disagrees at M={M} [{K},{N}]")
        return rec

    prefill = SLOTS * PROMPT
    # CUDA-core route (decode): the slots' rows at every main-path width and
    # the LM head, the prefill width, and small ragged edges
    for M, (K, N), main in ((SLOTS, (4096, 13696), True), (SLOTS, (4096, 4096), False),
                            (SLOTS, (4096, 256), False), (SLOTS, (13696, 4096), False),
                            (SLOTS, (4096, 151552), False), (prefill, (4096, 13696), False),
                            (1, (512, 384), False), (200, (512, 384), False)):
        rec = check_matmul("fp8_matmul", matmul_fp8_cuda_core, M, K, N)
        if main:
            records["fp8_matmul"] = rec
    # tensor-core route (prefill): the prompt rows at every main-path width,
    # and ragged M at a small width
    for M, (K, N) in ([(prefill, kn) for kn in ((4096, 13696), (4096, 4096), (4096, 256),
                                                  (13696, 4096))]
                      + [(M, (512, 384)) for M in (64, 65, 200, 1000)]):
        rec = check_matmul("fp8_matmul_wgmma", matmul_fp8_wgmma, M, K, N)
        if M == prefill and (K, N) == (4096, 13696):
            records["fp8_matmul_wgmma"] = rec
    # where the tensor-core route starts to win: both routes across M, per
    # width and summed over a layer's seven products (wq, wo; wk, wv;
    # w_gate, w_up; w_down)
    per_layer = {(4096, 4096): 2, (4096, 256): 2, (4096, 13696): 2, (13696, 4096): 1}
    layer = {}
    for (K, N), count in per_layer.items():
        for M in (8, 16, 32, 64, 128):
            x, wq, sc = matmul_operands(M, K, N)
            w_deq = (wq.float().reshape(K // bs, bs, N // bs, bs)
                     * sc[:, None, :, None]).reshape(K, N).bfloat16()
            t_cc = time_ms(torch, lambda: matmul_fp8_cuda_core(x, wq, sc, block=bs), 20)
            t_tc = time_ms(torch, lambda: matmul_fp8_wgmma(x, wq, sc, block=bs), 20)
            t_lib = time_ms(torch, lambda: torch.matmul(x, w_deq), 20)
            b_ms, b_by = bound(M * K * 2 + K * N + (K // bs) * (N // bs) * 4 + M * N * 4,
                               2 * M * K * N, BF16_FLOPS)
            cc, tc = layer.get(M, (0.0, 0.0))
            layer[M] = (cc + count * t_cc, tc + count * t_tc)
            log(f"crossover M={M} [{K},{N}]: cuda_core {t_cc:.4f} ms, wgmma {t_tc:.4f} ms, "
                f"cuBLAS bf16 {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    for M, (cc, tc) in layer.items():
        log(f"crossover M={M}, a layer's seven products: cuda_core {cc:.4f} ms, "
            f"wgmma {tc:.4f} ms")
    first_win = min((M for M, (cc, tc) in layer.items() if tc < cc), default=None)
    log(f"crossover: smallest swept M at which the wgmma route takes a layer's products "
        f"faster: {first_win}; route() sends M >= TC_MIN_ROWS = {TC_MIN_ROWS} to it "
        f"(decode, M = {SLOTS}, stays on the CUDA cores)")
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# Phases 4-6: the main path at full width
# ---------------------------------------------------------------------------

def make_weights(torch, model, seed: int):
    """Post weights from the model's own init, base = post + N(0, (1% std)^2)
    per matrix (per layer for stacked leaves); 1-D leaves are shared."""
    from repro_torch.core.policy import tree_map
    g = torch.Generator(device=model.device).manual_seed(seed)
    post = model.init(g)

    def perturb(t):
        if t.ndim < 2:
            return t
        out = torch.empty_like(t)
        mats = t.reshape(-1, *t.shape[-2:])
        for i, m in enumerate(mats):
            noise = torch.randn(m.shape, generator=g, device=model.device)
            out.reshape(-1, *t.shape[-2:])[i] = (m.float() + 0.01 * m.float().std() * noise).to(t.dtype)
        return out

    return post, tree_map(perturb, post)


def small_model_agreement(torch, seed: int) -> None:
    """A small GLM-shaped model (128-multiple widths, so every linear takes
    the fp8 kernel) quantized and prefilled on the GPU with the kernels and
    on the CPU with the plain versions: alphas and codes equal, logits close.
    The prefill's 4 x 32 = 128 rows take the tensor-core route."""
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.kernels._lib import FP8_MATMUL_WGMMA
    from repro_torch.models import build_model
    from repro_torch.quantize import quantize
    from repro_torch.core.policy import tree_leaves_with_path, tree_map
    cfg = dataclasses.replace(get_arch("glm4-9b"), n_layers=2, d_model=256, n_heads=2,
                              n_kv_heads=1, head_dim=128, d_ff=512, vocab_size=1024)
    m_cpu, m_gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    g = torch.Generator().manual_seed(seed)
    post = m_cpu.init(g)
    base = tree_map(lambda t: t if t.ndim < 2 else
                    (t.float() + 0.01 * t.float().std()
                     * torch.randn(t.shape, generator=g)).to(t.dtype), post)
    qcfg = QuantConfig(use_fused_kernel=True)
    q_cpu, r_cpu = quantize(post, base, qcfg, mode="storage")
    to_gpu = lambda t: t.cuda()
    q_gpu, r_gpu = quantize(tree_map(to_gpu, post), tree_map(to_gpu, base), qcfg,
                            mode="storage")
    for name, leaf in r_cpu.per_leaf.items():
        if not (leaf["alpha"] == r_gpu.per_leaf[name]["alpha"]).all():
            raise AssertionError(f"small model: alpha differs on {name}: "
                                 f"{leaf['alpha']} vs {r_gpu.per_leaf[name]['alpha']}")
    n_codes = 0
    for (path, a), (_, b) in zip(tree_leaves_with_path(q_cpu), tree_leaves_with_path(q_gpu)):
        if hasattr(a, "granularity"):
            if not torch.equal(a.data.view(torch.uint8), b.data.cpu().view(torch.uint8)) \
                    or not torch.equal(a.scale, b.scale.cpu()):
                raise AssertionError(f"small model: codes differ on {'/'.join(path)}")
            n_codes += a.data.numel()
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=g)
    lc, _ = m_cpu.prefill(q_cpu, {"tokens": tokens})
    before = FP8_MATMUL_WGMMA.launches
    lg, _ = m_gpu.prefill(q_gpu, {"tokens": tokens.cuda()})
    n_tc = FP8_MATMUL_WGMMA.launches - before
    if n_tc != 7 * cfg.n_layers:
        raise AssertionError(f"small model: the wgmma route launched {n_tc} times in the "
                             f"prefill, expected {7 * cfg.n_layers}")
    err = (lg.float().cpu() - lc.float()).abs().max().item()
    scale = lc.float().abs().max().item()
    log(f"small-model agreement: alphas equal, {n_codes} fp8 codes bit-equal, prefill "
        f"({n_tc} wgmma launches) logits max |gpu - cpu| = {err:.4g} (max |logit| {scale:.4g}, tolerance 5% of it)")
    if not err <= 0.05 * scale:
        raise AssertionError("small model: GPU and CPU prefill logits disagree")


def main_path(torch, args, records: dict) -> None:
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.engine import Engine
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.models import build_model
    from repro_torch.quantize import quantize

    cfg = dataclasses.replace(get_arch("glm4-9b"), n_layers=args.layers)
    log(f"model: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
        f"head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"layers={cfg.n_layers} ({cfg.param_count() / 1e9:.3f} B params)")
    model = build_model(cfg)
    t0 = time.perf_counter()
    post, base = make_weights(torch, model, args.seed)
    torch.cuda.synchronize()
    log(f"weights: post + base made in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")

    g = torch.Generator(device=model.device).manual_seed(args.seed + 1)
    requests = [torch.randint(0, cfg.vocab_size, (PROMPT,), generator=g, device=model.device)
                for _ in range(SLOTS)]

    # ---- the main path: counts zeroed just before, read just after ----
    for k in KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams, report = quantize(post, base, QuantConfig(use_fused_kernel=True),
                               mode="storage")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    quant_peak = torch.cuda.max_memory_allocated() / 1e9
    del post, base
    torch.cuda.empty_cache()
    engine = Engine(model, qparams, slots=SLOTS, cache_len=PROMPT + GEN, k_steps=K_STEPS)
    t0 = time.perf_counter()
    outputs, stats = engine.serve(requests, gen_tokens=GEN, return_stats=True)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    # ---- end of the main path ----

    log(report.summary())
    log(f"quantize: {quant_s:.2f} s for {report.n_quantized} tensors "
        f"({report.original_bytes / 1e9:.2f} GB bf16 -> {report.quantized_bytes / 1e9:.2f} GB), "
        f"peak {quant_peak:.2f} GB")
    dec_tokens = stats["counters"]["tokens"]
    log(f"serve: {len(outputs)} requests x {GEN} tokens in {serve_s:.2f} s "
        f"({SLOTS * GEN / serve_s:.1f} tok/s end to end); prefill {stats['prefill_s']:.3f} s "
        f"for {stats['prefill_tokens']} prompt tokens; decode {dec_tokens} tokens in "
        f"{stats['decode_s']:.3f} s = {dec_tokens / stats['decode_s']:.1f} tok/s "
        f"({stats['decode_s'] / stats['decode_steps'] * 1e3:.2f} ms per step of {SLOTS} slots)")
    log(f"launches on the main path: {json.dumps(launches)}")
    for name, n in launches.items():
        records[name]["launches"] = n
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    # seven quantized products per layer: prefill rows take the tensor-core
    # route; decode rows and each LM head (last token, M = slots) the CUDA cores
    want = {"fp8_matmul_wgmma": 7 * cfg.n_layers * stats["prefill_calls"],
            "fp8_matmul": (7 * cfg.n_layers + 1) * stats["decode_steps"]
            + stats["prefill_calls"]}
    log(f"fp8 routes: {stats['prefill_calls']} prefill(s), {stats['decode_steps']} decode "
        f"steps -> expected launches {json.dumps(want)}")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times on the serve, "
                                 f"expected {n}")

    # ---- outputs ----
    for out in outputs:
        if len(out) != GEN or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"bad output row: {out[:8]}... ({len(out)} tokens)")
    for side in (report.global_chosen, report.global_default):
        if not all(math.isfinite(v) for v in side.values()):
            raise AssertionError(f"non-finite report metrics {side}")
    for name, leaf in report.per_leaf.items():
        if leaf["chosen"]["sign_rate"] < leaf["default"]["sign_rate"] - 1e-6:
            raise AssertionError(f"DAQ sign rate below AbsMax on {name}")
    log(f"outputs: {len(outputs)} rows of {GEN} tokens in range; first row "
        f"{outputs[0][:12]}...")
    breakdowns(torch, model, qparams, torch.stack(requests))


def device_breakdown(torch, label: str, run, per: int, unit: str) -> None:
    """Host time of ``run()`` (which ends in a synchronize) without the
    profiler, then one ``torch.profiler`` window over another ``run()`` for
    the device's busy time, its kernel launches and the kernels by time;
    everything per ``unit`` (``run`` does ``per`` of them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()                                   # warm-up
    t0 = time.perf_counter()
    run()
    host_ms = (time.perf_counter() - t0) / per * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    kernels: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    if not kernels:
        log(f"{label} breakdown: the profiler saw no device events; device busy time "
            "not measured")
        return
    busy_ms = sum(t for _, t in kernels.values()) / per
    n_launch = sum(n for n, _ in kernels.values()) / per
    log(f"{label} breakdown: {host_ms:.2f} ms per {unit} on the host clock; device busy "
        f"{busy_ms:.2f} ms per {unit} (idle share {1 - busy_ms / host_ms:.3f}); "
        f"{n_launch:.0f} kernel launches per {unit}")
    for name, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"  {t / per:8.3f} ms/{unit}  {n / per:6.0f} launches/{unit}  {name[:90]}")


def breakdowns(torch, model, qparams, prompts, steps: int = 8) -> None:
    """Where a decode step and a prefill of the fp8 model go."""
    _, cache = model.prefill(qparams, {"tokens": prompts}, cache_len=PROMPT + 3 * steps)
    tok = prompts[:, :1]

    def decode():
        nonlocal cache
        for _ in range(steps):
            _, cache = model.decode_step(qparams, tok, cache)
        torch.cuda.synchronize()

    device_breakdown(torch, f"decode ({steps} steps of {prompts.shape[0]} slots)", decode,
                     steps, "step")
    del cache

    def prefill():
        model.prefill(qparams, {"tokens": prompts})
        torch.cuda.synchronize()

    device_breakdown(torch, f"prefill ({prompts.shape[0]} x {prompts.shape[1]} tokens)",
                     prefill, 1, "prefill")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=40,
                    help="model depth (default: GLM-4-9B's 40)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found; run from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi}")

    # 2. build
    from repro_torch.kernels import _lib
    t0 = time.perf_counter()
    _lib.build_all()
    log(f"built {len(_lib.KERNELS)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for k in _lib.KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k.name}: {line.strip()}")

    # 3. kernels vs plain versions
    t0 = time.perf_counter()
    records = check_kernels(torch, args.seed)
    log(f"kernel checks passed in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    small_model_agreement(torch, args.seed)
    log(f"small-model check in {time.perf_counter() - t0:.1f} s")
    main_path(torch, args, records)

    sources = {"scale_search": ("src/repro_torch/csrc/scale_search.cu",
                                "src/repro/kernels/scale_search/kernel.py:79"),
               "fp8_quant": ("src/repro_torch/csrc/fp8_quant.cu",
                             "src/repro/kernels/fp8_quant/kernel.py:36"),
               "fp8_matmul": ("src/repro_torch/csrc/fp8_matmul.cu",
                              "src/repro/kernels/fp8_matmul/kernel.py:45"),
               "fp8_matmul_wgmma": ("src/repro_torch/csrc/fp8_matmul_wgmma.cu",
                                    "src/repro/kernels/fp8_matmul/kernel.py:45")}
    kernels = [{"name": name, "route": "cuda", "source": sources[name][0],
                "replaces": sources[name][1], "launches": rec["launches"],
                **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}}
               for name, rec in records.items()]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
