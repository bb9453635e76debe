#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # full run: GLM-4-9B, 40 layers
    python3 chip_smoke.py --layers 8      # cut depth if a run overruns its time

Phases:
  1. environment (torch / CUDA versions, card name, power limit and
     maximum SM clock);
  2. build the five CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
     each, all at once); print each sweep instance's registers and spills
     (none allowed) and its element loop's SASS instructions per element
     and candidate (``cuobjdump``, where the toolkit has it);
  3. check each kernel against its plain PyTorch version at the shapes of
     the main path, with the tolerance stated below, and time both; the
     sweep also at 1, 16 and 20 candidates (two passes), blocks 64, 96,
     256 and 66 and qmax 240 (the last two: the scalar-load instance), its
     time beside the bound and the issue bound of its SASS; the fp8 matmul
     has three routes (decode and prefill on the tensor cores for bf16 x
     and block 128, the CUDA-core kernel for every other operand pair),
     each checked, and all timed with cold weights on device time across
     M, beside cuBLAS bf16;
  4. make full-width GLM-4-9B weights from a seeded ``torch.Generator``
     (base = post + Gaussian noise at 1 % of each matrix's std);
  5. quantize: ``quantize(post, base, QuantConfig(use_fused_kernel=True),
     mode="storage")``; print a hash of the chosen alphas;
  6. serve 8 greedy requests (prompt 128, 64 generated tokens) through
     ``Engine(model, qparams, slots=8, k_steps=8)``;
  7. assert that every kernel launched on that quantize -> serve run, the
     sweep one pass a stage and the quantizer once per leaf-layer, the
     wgmma route 7 x layers times per prefill, the decode route every
     decode product and LM head, the CUDA-core route never; check the
     outputs: token ranges, report sanity, a small bf16 model whose GPU run
     (kernels, the wgmma route included) agrees with its CPU run (plain
     versions), and a small float32 model, the CUDA-core route's own path,
     whose GPU run agrees with its CPU run to fp32 tolerance;
  8. break one decode step, one prefill and one quantize (GLM-4-9B cut to
     4 layers at full width) down: host time, device busy time, kernel
     launches, the decode route's device time and the kernels that take
     the device time.

It exits non-zero if any phase fails and when no CUDA device is present.
The last line of stdout is the JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import re
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
# Phase 2: what ptxas and the SASS say of the sweep's instances
# ---------------------------------------------------------------------------

SWEEP_INSTANCE = re.compile(r"sweep_kernelILi(\d+)ELi(\d+)E")


def sweep_resources(build_log: str) -> dict:
    """``{(NC, V): (registers, spill store bytes, spill load bytes)}`` of
    every sweep instance, from ``ptxas -v`` (an entry's lines follow its
    "Compiling entry function" line)."""
    found, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            inst = SWEEP_INSTANCE.search(m.group(1))
            cur = (int(inst.group(1)), int(inst.group(2))) if inst else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            found.setdefault(cur, [None, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.setdefault(cur, [None, 0, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in found.items()}


def sweep_sass(lib_path: Path, cuobjdump: Path) -> dict | None:
    """``{(NC, V): (instructions, opcode mix)}`` of each sweep instance's
    element loop: the largest innermost loop of its SASS that divides (a
    backward branch with no other inside it, and a MUFU in it), whose body
    is one row step, V elements against NC candidates, counted as the fast
    path issues it (without the slow paths a branch skips, the division's).
    ``None`` where the toolkit has no ``cuobjdump``."""
    if not cuobjdump.exists():
        return None
    return sweep_loops(subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                                      capture_output=True, text=True, timeout=300,
                                      check=True).stdout)


def sweep_loops(text: str) -> dict:
    """``sweep_sass`` on the text of ``cuobjdump -sass``."""
    out = {}
    for chunk in text.split("Function : ")[1:]:
        inst = SWEEP_INSTANCE.search(chunk.split("\n", 1)[0])
        if not inst:
            continue
        code = [(int(m.group(1), 16), m.group(2)) for m in
                re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;", chunk)]
        branches = [(addr, int(t.group(1), 16)) for addr, ins in code
                    if (t := re.search(r"BRA\b.*?(0x[0-9a-f]+)", ins))]
        loops = [(target, addr) for addr, target in branches if target <= addr]
        divides = lambda a, b: any("MUFU" in i for x, i in code if a <= x <= b)
        inner = [(a, b) for a, b in loops if divides(a, b)
                 and not any((a, b) != (c, d) and a <= c and d <= b for c, d in loops)]
        if not inner:
            continue
        a, b = max(inner, key=lambda ab: ab[1] - ab[0])
        # a forward branch over a CALL skips a slow path (the division's):
        # its instructions are not issued on the fast path
        skipped = set()
        for addr, target in branches:
            if a <= addr <= b and target > addr:
                over = [(x, i) for x, i in code if addr < x < target]
                if any("CALL" in i for _, i in over):
                    skipped.update(x for x, _ in over)
        ops = [re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0]
               for addr, ins in code if a <= addr <= b and addr not in skipped]
        mix: dict[str, int] = {}
        for op in ops:
            mix[op] = mix.get(op, 0) + 1
        out[(int(inst.group(1)), int(inst.group(2)))] = (len(ops), mix)
    return out


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# (I, O), candidates, block, qmax, timed: the main path's stages at
# [4096,13696] (the record: 11 candidates), the LM head, a small width; then
# one, 16 and 20 candidates (two passes), blocks 64, 256 and 96 (4-column
# groups: 24 a row, not a power of two), block 66 and qmax 240 (the scalar-
# load instance, which also clips above qmax)
SWEEP_CASES = (((4096, 13696), 6, 128, 448.0, True), ((4096, 13696), 11, 128, 448.0, True),
               ((4096, 151552), 11, 128, 448.0, True), ((384, 512), 11, 128, 448.0, True),
               ((512, 384), 1, 128, 448.0, False), ((512, 384), 16, 128, 448.0, False),
               ((512, 384), 20, 128, 448.0, False), ((512, 384), 11, 64, 448.0, False),
               ((512, 768), 11, 256, 448.0, False), ((384, 480), 11, 96, 448.0, False),
               ((396, 330), 11, 66, 448.0, False), ((396, 330), 20, 66, 448.0, False),
               ((512, 384), 11, 128, 240.0, False))


def check_sweeps(torch, weights, sass: dict | None, clock_mhz: float | None) -> dict:
    """The sweep against its plain version: sign counts equal, the other sums
    |err| <= 1e-4 |plain| + 1e-6 max|plain|.  Timed cases: CUDA-event mean
    of back-to-back launches (the inputs are over the 50 MB L2 at the main
    widths), beside the bound and, from the element loop's SASS, the issue
    bound (its instructions at one warp instruction per scheduler per clock,
    4 schedulers an SM, at the card's maximum SM clock).  Returns the record
    of [4096,13696] at 11 candidates."""
    from repro_torch.core.search import linspace
    from repro_torch.kernels._lib import SCALE_SEARCH
    from repro_torch.kernels.scale_search.kernel import sweep_partials_cuda, sweep_plan
    from repro_torch.kernels.scale_search.ref import sweep_partials_ref
    dev = "cuda"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    record = None
    for (I, O), n_cand, bs, qmax, timed in SWEEP_CASES:
        wp, wb = weights(I, O)
        amax = wp.reshape(I // bs, bs, O // bs, bs).abs().amax(dim=(1, 3)).clamp_min(1e-12)
        grid = linspace(0.8, 1.25, n_cand - 1, dev) if n_cand > 1 else torch.ones(0, device=dev)
        alphas = torch.cat([torch.ones(1, device=dev), grid])
        run_k = lambda: sweep_partials_cuda(wp, wb, amax, alphas, block_size=bs, qmax=qmax)
        run_p = lambda: sweep_partials_ref(wp, wb, amax, alphas, block_size=bs, qmax=qmax)
        before = SCALE_SEARCH.launches
        pk = run_k()
        passes = SCALE_SEARCH.launches - before
        pp = run_p()
        torch.cuda.synchronize()
        sign_diff = (pk[..., 1] - pp[..., 1]).abs().max().item()
        cont = [0, 2, 3, 4]
        err = (pk[..., cont] - pp[..., cont]).abs()
        tol = 1e-4 * pp[..., cont].abs() + 1e-6 * pp[..., cont].abs().max()
        plan = [count for _, count in sweep_plan(n_cand)]
        ok = sign_diff == 0 and bool((err <= tol).all()) and passes == len(plan) \
            and bool((pk[..., 5:] == 0).all())
        v = 4 if bs % 4 == 0 and O % 4 == 0 and qmax == 448.0 else 1
        rec = dict(max_abs_err=float((pk - pp).abs().max()))
        if timed:
            nb = (I // bs) * (O // bs)
            b_ms, b_by = bound(2 * I * O * 4 + nb * 4 + n_cand * 4 + n_cand * nb * 8 * 4,
                               I * O * (3 + 12 * n_cand), FP32_FLOPS)
            rec.update(ms=time_ms(torch, run_k, 10), plain_ms=time_ms(torch, run_p, 2),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
            loop = (sass or {}).get((n_cand, v))
            if loop and clock_mhz:
                per_elem = loop[0] / v
                rec["sass_per_elem_cand"] = per_elem / n_cand
                rec["issue_ms"] = I * O * per_elem / 32 / (4 * sms * clock_mhz * 1e6) * 1e3
        log(f"kernel-check scale_search [{I},{O}] n_cand={n_cand} block {bs} qmax {qmax:g} "
            f"({'float4' if v == 4 else 'scalar'} loads, {passes} pass(es) of {plan} "
            f"candidates): sign-count diff "
            f"{sign_diff:g}, max |err| sums {err.max().item():.3e} -> {'ok' if ok else 'FAIL'}; "
            + json.dumps(rec))
        if not ok:
            raise AssertionError(f"scale_search kernel disagrees at [{I},{O}] n_cand={n_cand} "
                                 f"block {bs} qmax {qmax:g} ({passes} passes, expected "
                                 f"{len(plan)})")
        if (I, O, n_cand, bs) == (4096, 13696, 11, 128):
            record = rec
        del wp, wb, pk, pp
        torch.cuda.empty_cache()
    return record


def check_kernels(torch, seed: int, sass: dict | None, clock_mhz: float | None) -> dict:
    """Each kernel at main-path shapes vs its plain version.  Returns the
    per-kernel record of the representative shape (others are logged)."""
    from repro_torch.kernels.fp8_quant.kernel import quantize_fp8_cuda
    from repro_torch.kernels.fp8_quant.ref import quantize_fp8_ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    bs = 128
    records = {}

    def weights(I, O):
        wp = (torch.randn((I, O), generator=g, device=dev) * 0.02).bfloat16().float()
        wb = (wp + torch.randn((I, O), generator=g, device=dev) * 2e-4).bfloat16().float()
        return wp, wb

    records["scale_search"] = check_sweeps(torch, weights, sass, clock_mhz)

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

    torch.cuda.empty_cache()
    records.update(check_matmul_routes(torch, g))
    crossover(torch, g)
    torch.cuda.empty_cache()
    return records


COLD_BYTES = 128 << 20   # weight copies rotated per timing: well over the 50 MB L2


def device_ms(torch, calls, reps: int = 24) -> float:
    """Mean device time of one call, in ms, with cold weights.

    ``calls`` are zero-argument callables, each on its own copy of the
    weights (together over ``COLD_BYTES``), launched in turn, so no launch
    finds its weights in the L2.  The time is the sum of the durations of
    every kernel the calls launch (a split product's second pass included),
    from ``torch.profiler``'s device events: no host issue time.  If the
    profiler sees no device events, the calls are captured in a CUDA graph
    and its replay timed with CUDA events instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = max(reps, len(calls))
    for c in calls:                         # warm-up: builds, allocator
        c()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            calls[i % len(calls)]()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us > 0:
        return us / 1e3 / n
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def finite_e4m3_codes(torch, K: int, N: int):
    """An E4M3 [K, N] whose every 128 x 128 tile holds all 254 finite codes
    (0x7F and 0xFF, the NaNs, left out)."""
    c = torch.arange(K * N, device="cuda").remainder(254)
    c = c + (c >= 0x7F).long()
    return c.to(torch.uint8).view(torch.float8_e4m3fn).reshape(K, N)


def matmul_bytes(M, K, N, block=128, x_bytes=2):
    return M * K * x_bytes + K * N + (K // block) * (N // block) * 4 + M * N * 4


class MatmulCase:
    """Operands of one fp8 product, in ``copies`` independent copies of the
    weights (together over ``COLD_BYTES``) for cold timings; copy 0 is the
    one checked."""

    def __init__(self, torch, g, M, K, N, *, block=128, x_dtype=None, all_codes=False,
                 timed=True):
        from repro_torch.kernels.fp8_quant.ref import quantize_fp8_ref
        self.M, self.K, self.N, self.block = M, K, N, block
        x_dtype = x_dtype or torch.bfloat16
        self.x = torch.randn((M, K), generator=g, device="cuda").to(x_dtype)
        n = max(2, -(-COLD_BYTES // (K * N))) if timed else 1
        self.w = []
        for _ in range(n):
            if all_codes:
                wq = finite_e4m3_codes(torch, K, N)
                sc = torch.rand((K // block, N // block), generator=g, device="cuda") * 1e-3 + 1e-4
            else:
                w = torch.randn((K, N), generator=g, device="cuda") * 0.02
                wq, sc = quantize_fp8_ref(w, torch.ones(1, device="cuda"), block=block)
                del w
            self.w.append((wq, sc))
        self._deq = None

    def deq(self):
        """bf16 dequantized weights per copy: cuBLAS's operands."""
        if self._deq is None:
            b, K, N = self.block, self.K, self.N
            self._deq = [(wq.float().reshape(K // b, b, N // b, b) * sc[:, None, :, None])
                         .reshape(K, N).bfloat16() for wq, sc in self.w]
        return self._deq

    def calls(self, run):
        return [lambda wq=wq, sc=sc: run(self.x, wq, sc, block=self.block) for wq, sc in self.w]

    def library_calls(self, torch):
        x = self.x.bfloat16()
        return [lambda w=w: torch.matmul(x, w) for w in self.deq()]


def check_matmul(torch, name, run, case, *, time_it=False) -> dict:
    """``run`` against the plain version on copy 0 of ``case``: |err| <=
    1e-4 |plain| + 1e-5 max|plain| (fp32 sums in another order; bf16 x bf16
    products are exact in fp32).  With ``time_it``, cold device times of the
    kernel, the plain version and cuBLAS bf16."""
    from repro_torch.kernels.fp8_matmul.ref import matmul_fp8_ref
    M, K, N, bs = case.M, case.K, case.N, case.block
    wq, sc = case.w[0]
    yk = run(case.x, wq, sc, block=bs)
    yp = matmul_fp8_ref(case.x, wq, sc, block=bs)
    torch.cuda.synchronize()
    err = (yk - yp).abs()
    ok = bool(torch.isfinite(yk).all()) and bool((err <= 1e-4 * yp.abs()
                                                  + 1e-5 * yp.abs().max()).all())
    rec = dict(max_abs_err=float(err.max()))
    if time_it:
        b_ms, b_by = bound(matmul_bytes(M, K, N, bs, case.x.element_size()), 2 * M * K * N,
                           BF16_FLOPS)
        rec.update(ms=device_ms(torch, case.calls(run)),
                   plain_ms=device_ms(torch, case.calls(matmul_fp8_ref), reps=len(case.w)),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=device_ms(torch, case.library_calls(torch)))
    log(f"kernel-check {name} M={M} [{K},{N}] x {str(case.x.dtype)[6:]} block {bs}: -> "
        f"{'ok' if ok else 'FAIL'}; " + json.dumps(rec))
    if not ok:
        raise AssertionError(f"{name} kernel disagrees at M={M} [{K},{N}] block {bs}")
    return rec


DECODE_WIDTHS = ((4096, 13696), (4096, 4096), (4096, 256), (13696, 4096), (4096, 151552))


def check_matmul_routes(torch, g) -> dict:
    """The fp8 matmul's three routes against the plain version at the
    shapes the main path and the route table give them."""
    from repro_torch.kernels.fp8_matmul.kernel import (matmul_fp8_cuda_core,
                                                       matmul_fp8_decode, matmul_fp8_wgmma)
    records = {}
    f32, f16 = torch.float32, torch.float16
    # decode route (bf16 x, M < 16): the slots' rows at every decode width
    # and the LM head, ragged M, and weights whose tiles hold every finite
    # code (64- and 128-column blocks)
    for K, N in DECODE_WIDTHS:
        main = (K, N) == (4096, 13696)
        rec = check_matmul(torch, "fp8_matmul_decode", matmul_fp8_decode,
                           MatmulCase(torch, g, SLOTS, K, N, timed=main), time_it=main)
        if main:
            records["fp8_matmul_decode"] = rec
    for M in (1, 2, 7, 9, 15):
        for K, N in ((512, 384), (4096, 4096)):
            check_matmul(torch, "fp8_matmul_decode", matmul_fp8_decode,
                         MatmulCase(torch, g, M, K, N, timed=False))
    check_matmul(torch, "fp8_matmul_decode", matmul_fp8_decode,
                 MatmulCase(torch, g, 15, 4096, 151552, timed=False))
    for M, (K, N) in ((SLOTS, (512, 384)), (15, (512, 33792))):
        check_matmul(torch, "fp8_matmul_decode (all finite codes)", matmul_fp8_decode,
                     MatmulCase(torch, g, M, K, N, all_codes=True, timed=False))
    # CUDA-core route: what the tensor-core routes do not take (fp32 and
    # fp16 x, blocks 64 and 512), and its M = 8 bf16 time for comparison
    records["fp8_matmul"] = check_matmul(
        torch, "fp8_matmul", matmul_fp8_cuda_core, MatmulCase(torch, g, SLOTS, 4096, 13696),
        time_it=True)
    for x_dtype in (f32, f16):
        check_matmul(torch, "fp8_matmul", matmul_fp8_cuda_core,
                     MatmulCase(torch, g, SLOTS, 4096, 4096, x_dtype=x_dtype, timed=False))
    for block in (64, 512):
        check_matmul(torch, "fp8_matmul", matmul_fp8_cuda_core,
                     MatmulCase(torch, g, SLOTS, 1024, 1536, block=block, timed=False))
    check_matmul(torch, "fp8_matmul", matmul_fp8_cuda_core,
                 MatmulCase(torch, g, 200, 512, 384, x_dtype=f32, block=64, timed=False))
    # prefill route (M >= 16): the prompt rows at every main-path width,
    # and ragged M at a small width from the route's threshold up
    prefill = SLOTS * PROMPT
    for K, N in ((4096, 13696), (4096, 4096), (4096, 256), (13696, 4096)):
        main = (K, N) == (4096, 13696)
        rec = check_matmul(torch, "fp8_matmul_wgmma", matmul_fp8_wgmma,
                           MatmulCase(torch, g, prefill, K, N, timed=main), time_it=main)
        if main:
            records["fp8_matmul_wgmma"] = rec
    for M in (16, 17, 33, 63, 64, 65, 200, 1000):
        check_matmul(torch, "fp8_matmul_wgmma", matmul_fp8_wgmma,
                     MatmulCase(torch, g, M, 512, 384, timed=False))
    return records


def crossover(torch, g) -> None:
    """Cold device time of every route and of cuBLAS bf16 across M, per
    width and summed over a layer's seven products (wq, wo; wk, wv;
    w_gate, w_up; w_down); the LM head at the slots' M."""
    from repro_torch.kernels.fp8_matmul.kernel import (TC_MIN_ROWS, matmul_fp8_cuda_core,
                                                       matmul_fp8_decode, matmul_fp8_wgmma)
    per_layer = {(4096, 4096): 2, (4096, 256): 2, (4096, 13696): 2, (13696, 4096): 1}
    routes = {"cuda_core": matmul_fp8_cuda_core, "decode": matmul_fp8_decode,
              "wgmma": matmul_fp8_wgmma}
    layer: dict[int, dict[str, float]] = {}
    for (K, N), count in [*per_layer.items(), ((4096, 151552), 0)]:
        case = MatmulCase(torch, g, 1, K, N)
        for M in ((1, 8, 15, 16, 32, 64, 128) if count else (SLOTS,)):
            case.x = torch.randn((M, K), generator=g, device="cuda").bfloat16()
            t = {r: device_ms(torch, case.calls(fn)) for r, fn in routes.items()
                 if r != "decode" or M < TC_MIN_ROWS}
            t["cuBLAS bf16"] = device_ms(torch, case.library_calls(torch))
            b_ms, b_by = bound(matmul_bytes(M, K, N), 2 * M * K * N, BF16_FLOPS)
            for r, ms in t.items():
                layer.setdefault(M, {}).setdefault(r, 0.0)
                layer[M][r] += count * ms
            log(f"crossover M={M} [{K},{N}] (cold device ms): "
                + ", ".join(f"{r} {ms:.4f}" for r, ms in t.items())
                + f"; bound {b_ms:.4f} ({b_by})")
        del case
        torch.cuda.empty_cache()
    for M, t in layer.items():
        if any(t.values()):
            log(f"crossover M={M}, a layer's seven products (cold device ms): "
                + ", ".join(f"{r} {ms:.4f}" for r, ms in t.items()))
    log(f"crossover: route() sends bf16 block-128 products of M < TC_MIN_ROWS = "
        f"{TC_MIN_ROWS} to the decode route and the rest to wgmma")
    # a decode step is host-bound: what each route costs the host per call
    case = MatmulCase(torch, g, SLOTS, 4096, 256, timed=False)
    t = {r: host_us(torch, case.calls(fn)[0]) for r, fn in routes.items()}
    t["cuBLAS bf16"] = host_us(torch, case.library_calls(torch)[0])
    log(f"host issue per call, M={SLOTS} [4096,256] (us on the host clock): "
        + ", ".join(f"{r} {us:.1f}" for r, us in t.items()))


def host_us(torch, call, reps: int = 500) -> float:
    """Host microseconds per call of a product small enough that the device
    finishes each before the next is issued: ``reps`` calls back to back on
    the host clock, ending in a synchronize."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


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


def fp32_model_agreement(torch, seed: int) -> dict:
    """The CUDA-core route's own path: operands the tensor-core routes do not
    take.  A small GLM-shaped model with ``dtype="float32"`` parameters over
    block-64 fp8 weights (quantized once on the CPU) is prefilled and stepped
    once on the CPU (plain versions) and on the GPU, where every product
    takes the CUDA-core kernel.  Its activations are bf16 whatever the
    parameters' type (``models/common.py::ACT_DTYPE``, as in the reference),
    so its logits are held to the bf16 model's tolerance, 5 % of the largest.
    Then each quantized linear of its first layer and its LM head takes fp32
    x through ``ops.matmul_fp8`` and fp16 x through ``ops.matmul_fp8_2d`` on
    both devices: |gpu - cpu| <= 1e-4 |cpu| + 1e-5 max|cpu| (fp32 sums in
    another order).  Returns the kernels' launch counts of the GPU runs,
    zeroed just before them."""
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.kernels._lib import FP8_MATMUL, KERNELS
    from repro_torch.kernels.fp8_matmul import ops
    from repro_torch.models import build_model
    from repro_torch.quant_runtime.qparams import QuantizedTensor
    from repro_torch.quantize import quantize
    from repro_torch.core.policy import tree_map
    cfg = dataclasses.replace(get_arch("glm4-9b"), n_layers=2, d_model=256, n_heads=2,
                              n_kv_heads=1, head_dim=128, d_ff=512, vocab_size=1024,
                              dtype="float32")
    m_cpu, m_gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    g = torch.Generator().manual_seed(seed + 2)
    post = m_cpu.init(g)
    base = tree_map(lambda t: t if t.ndim < 2 else
                    t + 0.01 * t.std() * torch.randn(t.shape, generator=g), post)
    q_cpu, _ = quantize(post, base, QuantConfig(use_fused_kernel=True, block_size=64),
                        mode="storage")
    q_gpu = tree_map(lambda t: dataclasses.replace(t, data=t.data.cuda(), scale=t.scale.cuda())
                     if isinstance(t, QuantizedTensor) else t.cuda(), q_cpu)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=g)
    nxt = torch.randint(0, cfg.vocab_size, (4, 1), generator=g)
    lc, cc = m_cpu.prefill(q_cpu, {"tokens": tokens}, cache_len=40)
    dc, _ = m_cpu.decode_step(q_cpu, nxt, cc)
    layer0 = lambda q: [q["stack"]["L0"][part][name].layer(0)
                        for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                                            ("mlp", ("w_gate", "w_up", "w_down")))
                        for name in names] + [q["embed"]["w_head"]]
    xs = [torch.randn((8, w.shape[0]), generator=g) for w in layer0(q_cpu)]

    for k in KERNELS:
        k.launches = 0
    lg, cg = m_gpu.prefill(q_gpu, {"tokens": tokens.cuda()}, cache_len=40)
    dg, _ = m_gpu.decode_step(q_gpu, nxt.cuda(), cg)
    direct = [(ops.matmul_fp8(x.cuda(), wg), ops.matmul_fp8(x, wc),
               ops.matmul_fp8_2d(x.half().cuda(), wg.data, wg.scale[:, 0, :, 0], block=64),
               ops.matmul_fp8_2d(x.half(), wc.data, wc.scale[:, 0, :, 0], block=64))
              for x, wg, wc in zip(xs, layer0(q_gpu), layer0(q_cpu))]
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS}

    want = 2 * (7 * cfg.n_layers + 1) + 2 * len(xs)
    if launches[FP8_MATMUL.name] != want or sum(launches.values()) != want:
        raise AssertionError(f"float32 model: launches {launches}, expected {want}, all "
                             f"of {FP8_MATMUL.name}")
    for name, gpu, cpu in (("prefill", lg, lc), ("decode", dg, dc)):
        err = (gpu.float().cpu() - cpu.float()).abs().max().item()
        scale = cpu.float().abs().max().item()
        log(f"float32-model agreement ({name}, block 64, CUDA-core route): logits max "
            f"|gpu - cpu| = {err:.4g} (max |logit| {scale:.4g}, tolerance 5% of it)")
        if not err <= 0.05 * scale:
            raise AssertionError(f"float32 model: GPU and CPU {name} logits disagree")
    worst = 0.0
    for y32g, y32c, y16g, y16c in direct:
        for gpu, cpu, dtype in ((y32g, y32c, torch.float32), (y16g, y16c, torch.float32)):
            gpu = gpu.cpu()
            if gpu.dtype != dtype or cpu.dtype != dtype:
                raise AssertionError(f"float32 model: product in {gpu.dtype}, expected {dtype}")
            err = (gpu - cpu).abs()
            worst = max(worst, float((err / (1e-4 * cpu.abs() + 1e-5 * cpu.abs().max())).max()))
    log(f"float32-model agreement: {len(direct)} linears x fp32 and fp16 x on the CUDA-core "
        f"route, worst |gpu - cpu| at {worst:.3f} of its tolerance; launches "
        f"{json.dumps(launches)}")
    if not worst <= 1.0:
        raise AssertionError("float32 model: GPU and CPU fp32 / fp16-x products disagree")
    return launches


def main_path(torch, args, records: dict) -> None:
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.engine import Engine
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.kernels.scale_search.kernel import sweep_plan
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
    log(f"quantize: chosen-alpha hash {alpha_hash(report)} over {leaf_layers(report)} "
        f"leaf-layers")
    dec_tokens = stats["counters"]["tokens"]
    log(f"serve: {len(outputs)} requests x {GEN} tokens in {serve_s:.2f} s "
        f"({SLOTS * GEN / serve_s:.1f} tok/s end to end); prefill {stats['prefill_s']:.3f} s "
        f"for {stats['prefill_tokens']} prompt tokens; decode {dec_tokens} tokens in "
        f"{stats['decode_s']:.3f} s = {dec_tokens / stats['decode_s']:.1f} tok/s "
        f"({stats['decode_s'] / stats['decode_steps'] * 1e3:.2f} ms per step of {SLOTS} slots)")
    log(f"launches on the main path: {json.dumps(launches)}")
    for name, n in launches.items():
        if name != "fp8_matmul":
            records[name]["launches"] = n
            if n <= 0:
                raise AssertionError(f"kernel {name} never launched on the main path")
    # one sweep pass a stage (the coarse and fine grids with the incumbent:
    # 1 + 5 and 1 + 10 candidates) and one quantizer launch per leaf-layer
    n = leaf_layers(report)
    qcfg = QuantConfig()
    passes = len(sweep_plan(1 + qcfg.n_coarse)) + len(sweep_plan(1 + qcfg.n_fine))
    for name, want_n in (("scale_search", passes * n), ("fp8_quant", n)):
        if launches[name] != want_n:
            raise AssertionError(f"{name} launched {launches[name]} times on the quantize, "
                                 f"expected {want_n} for {n} leaf-layers")
    # seven quantized products per layer: prefill rows take the wgmma route;
    # decode rows and each LM head (last token, M = slots) the decode route;
    # bf16 x at block 128 never takes the CUDA-core route
    want = {"fp8_matmul_wgmma": 7 * cfg.n_layers * stats["prefill_calls"],
            "fp8_matmul_decode": (7 * cfg.n_layers + 1) * stats["decode_steps"]
            + stats["prefill_calls"],
            "fp8_matmul": 0}
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


def device_breakdown(torch, label: str, run, per: int, unit: str, top: int = 8) -> None:
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
    route = [(n, t) for name, (n, t) in kernels.items()
             if "decode_kernel" in name or "sum_splits_kernel" in name]
    if route:
        log(f"{label} breakdown: fp8 decode route (decode_kernel + its split sum) "
            f"{sum(t for _, t in route) / per:.3f} ms per {unit} on the device, "
            f"{sum(n for n, _ in route) / per:.0f} kernel launches per {unit}")
    for name, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]:
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


def leaf_layers(report) -> int:
    """Matrices the quantize searched: a stacked leaf [L, I, O] counts L."""
    return sum(leaf["shape"][0] if len(leaf["shape"]) == 3 else 1
               for leaf in report.per_leaf.values())


def alpha_hash(report) -> str:
    """sha256 (first 16 hex digits) of every leaf's chosen alphas (float32,
    leaves by name): the sign metric's argmax reads integer counts, so a
    correct sweep reproduces a tree's alphas exactly."""
    h = hashlib.sha256()
    for name in sorted(report.per_leaf):
        h.update(name.encode())
        h.update(report.per_leaf[name]["alpha"].astype("float32").tobytes())
    return h.hexdigest()[:16]


def quantize_breakdown(torch, seed: int, layers: int = 4) -> None:
    """Where one quantize goes: GLM-4-9B at full width cut to ``layers``
    layers (the embedding and the LM head included, weights as phase 4),
    per leaf-layer: host time, device busy time, launches and the kernels
    by device time (the sweep, the quantizer, and PyTorch's elementwise and
    reduction kernels of the search and ``_finalize``)."""
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.models import build_model
    from repro_torch.quantize import quantize

    cfg = dataclasses.replace(get_arch("glm4-9b"), n_layers=layers)
    post, base = make_weights(torch, build_model(cfg), seed)
    _, report = quantize(post, base, QuantConfig(use_fused_kernel=True), mode="storage")
    n = leaf_layers(report)

    def run():
        quantize(post, base, QuantConfig(use_fused_kernel=True), mode="storage")
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    run()
    log(f"quantize breakdown: {cfg.name}, {layers} layers at full width, {n} leaf-layers "
        f"({report.original_bytes / 1e9:.2f} GB bf16): {time.perf_counter() - t0:.3f} s a "
        f"quantize on the host clock")
    device_breakdown(torch, f"quantize ({layers} layers)", run, n, "leaf-layer", top=12)
    del post, base
    torch.cuda.empty_cache()


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
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True, text=True,
                           timeout=60).stdout.strip().splitlines()
    clock_mhz = float(clock[0]) if clock and clock[0].strip().isdigit() else None
    log(f"maximum SM clock: {clock_mhz} MHz")

    # 2. build
    from repro_torch.kernels import _lib
    t0 = time.perf_counter()
    _lib.build_all()
    log(f"built {len(_lib.KERNELS)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for k in _lib.KERNELS:
        if k is _lib.SCALE_SEARCH:
            continue
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k.name}: {line.strip()}")
    # the sweep's instances: registers and spills (ptxas), and the SASS
    # instructions of the element loop (one row step: V elements x NC candidates)
    resources = sweep_resources(_lib.SCALE_SEARCH.build_log)
    sass = sweep_sass(_lib.SCALE_SEARCH.library_path(), Path(_lib.nvcc()).parent / "cuobjdump")
    for (nc, v), (regs, st, ld) in sorted(resources.items()):
        loop = (sass or {}).get((nc, v))
        mix = ", ".join(f"{op} {c}" for op, c in
                        sorted(loop[1].items(), key=lambda kv: -kv[1])[:10]) if loop else ""
        log(f"  scale_search NC={nc:2d} V={v}: {regs} registers, spill stores {st} B, "
            f"spill loads {ld} B; element loop "
            + (f"{loop[0]} SASS instructions = {loop[0] / (nc * v):.1f} per element and "
               f"candidate ({mix})" if loop else "not measured (no cuobjdump)"))
    if not resources:
        raise AssertionError("ptxas reported no sweep instance")
    if any(st or ld for _, st, ld in resources.values()):
        raise AssertionError("a sweep instance spills registers")

    # 3. kernels vs plain versions
    t0 = time.perf_counter()
    records = check_kernels(torch, args.seed, sass, clock_mhz)
    log(f"kernel checks passed in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    small_model_agreement(torch, args.seed)
    fp32_launches = fp32_model_agreement(torch, args.seed)
    log(f"small-model checks in {time.perf_counter() - t0:.1f} s")
    # the CUDA-core kernel's path is the float32 model's (bf16 serves never
    # reach it): its launches are counted there
    records["fp8_matmul"]["launches"] = fp32_launches["fp8_matmul"]
    main_path(torch, args, records)
    quantize_breakdown(torch, args.seed)

    sources = {"scale_search": ("src/repro_torch/csrc/scale_search.cu",
                                "src/repro/kernels/scale_search/kernel.py:79"),
               "fp8_quant": ("src/repro_torch/csrc/fp8_quant.cu",
                             "src/repro/kernels/fp8_quant/kernel.py:36"),
               "fp8_matmul": ("src/repro_torch/csrc/fp8_matmul.cu",
                              "src/repro/kernels/fp8_matmul/kernel.py:45"),
               "fp8_matmul_wgmma": ("src/repro_torch/csrc/fp8_matmul_wgmma.cu",
                                    "src/repro/kernels/fp8_matmul/kernel.py:45"),
               "fp8_matmul_decode": ("src/repro_torch/csrc/fp8_matmul_decode.cu",
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
