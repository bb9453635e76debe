#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # full run: GLM-4-9B, 40 layers
    python3 chip_smoke.py --layers 8      # cut depth if a run overruns its time

Phases:
  1. environment (torch / CUDA versions, card name, power limit and
     maximum SM clock);
  2. build the five CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
     each, all at once); print each quantizer and sweep instance's
     registers and spills (none allowed) and the sweep's element loop's SASS
     instructions per element and candidate (``cuobjdump``, where the
     toolkit has it);
  3. check each kernel against its plain PyTorch version at the shapes of
     the main path, with the tolerance stated below, and time both; the
     quantizer also at blocks 64 and 66 and with w 4 bytes into its storage
     (its general instance); the sweep also at 1, 16 and 20 candidates (two
     passes), blocks 64, 96, 256 and 66 and qmax 240 (the last two: the
     scalar-load instance), its time beside the bound and the issue bound
     of its SASS; both on tiles holding NaN, +-inf and zeros against their
     plain versions on the card and on the CPU (the sweep's sign counts
     also on a tile of denormal deltas, which count as 0 as in the
     reference); the fp8 matmul has three
     routes (decode and prefill on the tensor cores for bf16, fp16 and
     fp32 x at every quant block that is a multiple of 16, the CUDA-core
     kernel for the other blocks), each checked (the tensor-core routes at
     blocks 16, 32, 64, 96, 256 and 512 with every x type at M = 1 to 1,024,
     K and N off the 128 grid, every finite code, fp32 x near 1e-30 and
     3e38; the CUDA-core kernel at blocks 8, 40 and 66), and timed with
     cold weights on device time across M, beside cuBLAS bf16, the plain
     version and the CUDA-core kernel at the same shape;
  4. make full-width GLM-4-9B weights from a seeded ``torch.Generator``
     (base = post + Gaussian noise at 1 % of each matrix's std);
  5. quantize: ``quantize(post, base, QuantConfig(use_fused_kernel=True),
     mode="storage")``; print a hash of the chosen alphas and one of the
     fp8 codes and scales (``tree_readings`` gives both for another tree's
     package, to compare two trees in one call);
  6. serve 8 greedy requests (prompt 128, 64 generated tokens) through
     ``Engine(model, qparams, slots=8, k_steps=8)``;
  7. assert that every kernel launched on that quantize -> serve run, the
     sweep one pass a stage and the quantizer once per leaf-layer, the
     wgmma route 7 x layers times per prefill, the decode route every
     decode product and LM head, the CUDA-core route never; check the
     outputs: token ranges, report sanity, a small bf16 model whose GPU run
     (kernels, the wgmma route included) agrees with its CPU run (plain
     versions), a small float32 model at block 64 (fp32 and fp16 x on the
     tensor-core routes) whose GPU run agrees with its CPU run to fp32
     tolerance, and a small model at block 8, the CUDA-core route's own
     path;
  7b. the paged KV cache (``paged_phase``): 16 requests of 16-496 prompt
     tokens through the contiguous engine and two paged serves of the same
     ``qparams`` at ``cache_len`` 560: at capacity parity the greedy tokens
     equal the contiguous engine's token for token; under a 120-block pool
     admission waits and blocks recycle mid-dispatch, with conservation
     checked after every admission and dispatch; the fp8 launch counts of
     both; one contiguous and one paged dispatch under the CUDA sync debug
     mode; the paged engines record request metrics and a trace
     (``repro_torch.telemetry``), the parity run's tokens, syncs,
     dispatches, prefill calls and launches equal the contiguous run's
     (telemetry off), and a drained paged dispatch (dispatch, transfer,
     trace) synchronizes at the same one site with telemetry on and off;
  7c. prefix caching and chunked prefill (``prefix_phase``, on the first
     ``PREFIX_LAYERS`` = 20 layers of phase 5's model): 18 requests
     sharing a 128-token system prompt through the one-shot paged engine,
     a chunked one (``chunk_size=64``) and a chunked, prefix-cached one
     served cold then warm; conservation after every admission and
     dispatch, prefix hits, fewer prompt tokens prefilled warm than cold, a
     copy-on-write block, warm == cold token for token, the fp8 launch
     counts of the chunked serves, one chunked dispatch under the sync
     debug mode, and the chunked-vs-one-shot agreement; the chunked
     engines record metrics and a trace, and the chunked engine's first 8
     requests served with telemetry off and on agree in tokens, syncs,
     dispatches, admissions and launches;
  7d. self-speculative decoding (``spec_phase``, on the first
     ``SPEC_LAYERS`` = 6 layers of phase 5's model): phase 5's bf16 tree
     verifying, ``n_spec=4``: phase 6's requests without speculation (the
     baseline), with the DAQ draft (dynamic depth, then pinned) and with
     an AbsMax draft; phase 7c's requests composed with chunked prefill
     and the prefix cache, cold then warm; conservation, ``drafted ==
     accepted + rejected``, the decode route's launches (the draft steps
     only), first tokens equal to the baseline's, the speculative serves
     equal to each other, a copy-on-write, warm == cold, one speculative
     and one composed dispatch under the sync debug mode; it prints the
     acceptance rates, each serve's tok/s, the agreement with the
     baseline, and how a verify row's bits differ from a decode step's;
     the speculative engines record metrics and a trace, and (ii) served
     again with telemetry off gives the same tokens, syncs and launches;
  7e. the rest of the quantizer (``methods_phase``, run after phase 8's
     serve breakdowns, when phase 5's tree is freed): phase 4's weights
     (base remade from its seed) quantized with ``daq-per-block`` (block
     128, sign), served through the decode and prefill routes, its sign
     rates at least AbsMax's, no search kernel launched, a decode step
     broken down; a calibration (``collect_input_stats`` over a 4,096-token
     language: the [V, V] table at the full vocabulary would be 91.9 GB);
     ``smoothquant`` and ``awq`` at channel granularity with it, each served
     with no kernel launched (equalized tensors take the dequantize path);
     quantize seconds, peak GB and tok/s of each; then the reduced GLM-4-9B
     quantized by the three on the card and on the CPU (alphas, codes and
     ``eq_scale`` equal; AWQ's exponents equal where decided);
  7f. the host-loop baseline (``host_loop_phase``, before phase 5's tree is
     freed): ``serve_host_loop`` and the contiguous engine on phase 6's
     requests, 16 tokens each: tok/s, host syncs per token, launches per
     route (asserted), and how many tokens agree;
  7g. the serve CLI (``cli_phase``, after phase 7e): ``python -m
     repro_torch.launch.serve``'s ``main`` at full width, ``--daq --paged
     --prefix-cache`` and ``--paged --spec-draft daq``, 8 requests of 128
     (+1) prompt tokens and 16 generated, with ``--metrics-out`` and
     ``--trace-out``: the snapshot's schema and completions, the trace's
     schema and tracks, no kernel launched (channel trees), quantize
     seconds, peak GB, tok/s and TTFT / TPOT percentiles;
  7h. training (``train_phase``, after 7g): GLM-4-9B at full width cut to 8
     layers, bf16 weights from a seed, SFT'd for 8 AdamW steps (fp32 master
     and moments, remat ``full``, mixed batches of 4 x 512 tokens, one step
     under the sync debug mode "error"), the SFT'd tree DAQ-quantized
     against its base (the sweep and the quantizer launch) and served phase
     6's requests; loss per step (falling), train tok/s, a step's host and
     device time, idle share and launches, the optimizer's share, peak GB,
     the real delta's sign rate and cosine, launch counts asserted; then a
     small float32 model trained 3 steps on the card and on the CPU
     (``train_agreement``);
  7i. the paper's study (``study_phase``): ``pipeline/daq_study.py`` at its
     own ``STUDY_CFG``, base and SFT trained on the card (600 + 350 steps),
     Tables 2 and 4, post-SFT style above the base's;
  7j. the SSM family (``ssm_phase``, after 7i): Mamba2-780M at full width
     and all 48 layers, seeded bf16 weights (base = post + 1 % noise),
     DAQ-quantized (the sweep's and the quantizer's launches asserted from
     the tree; both held against their plain versions on the ragged leaves
     ``in_dt`` [1536,48] and the embedding [50280,1536]), then 8 greedy
     requests of four lengths above the SSD chunk of 256 (300 to 1,000
     tokens), 64 tokens each, through ``Engine(slots=8, k_steps=8)``: one
     prefill call per length, the decode route 5 x 48 + 1 launches a
     decode step and 1 a prefill call, the wgmma route 5 x 48 a prefill
     call, the CUDA-core route none (the ragged ``in_dt`` and LM head
     multiply through their zero-padded block grids,
     ``ragged_product_checks``); the two tensor-core routes against their
     plain versions at [1536,256], [3072,1536] and the two grids, the
     decode route at [3072,1536] timed again (``repeat_timing``); tok/s,
     prefill seconds and one
     decode step broken down; a small bf16 SSM model's card run against
     its CPU run (``ssm_small_agreement``); then the paged engines
     (``family_paged_phase``, 16 tokens a request): paged == contiguous
     token for token, chunked on the SSD grid (256 rows a slot a piece;
     first tokens equal to the one-shot serve's), prefix-cached cold and
     warm with zero hits (an SSM state shares no block; == the chunked
     serve token for token), the bf16 tree paged and verifying the DAQ
     draft (two-pass rounds: acceptance rate, first tokens equal), each
     serve's launches by formula (5 x 48 products a layer step) and
     conservation asserted; one speculative dispatch under the sync debug
     mode; a paged decode step and a speculative round broken down;
  7k. the MoE family (``moe_phase``, after 7j): DeepSeek-V3 at full width
     (d_model 7168, 256 experts of 2,048 top-8 and a shared one, vocab
     129,280) cut to its 3 dense-prefix layers and 1 MoE layer, seeded
     bf16 weights quantized in two subtrees (``{embed, final_norm,
     prefix}``, then ``{stack}``, each base made just before: the whole
     pair would not fit the card beside the fp8 tree), the sweep's and the
     quantizer's launches asserted from the tree (each of the 768 experts
     a matrix), then 8 greedy requests of 128 / 256 / 384 / 512 tokens, 32
     each, through ``Engine(slots=8, k_steps=8)``: 4 prefill calls, the
     wgmma route 7 x 4 launches a prefill call, the decode route 7 x 4 + 1
     a decode step and 1 a prefill call, the CUDA-core route none (the
     expert stacks are dequantized and multiplied by ``torch.matmul``, as
     the reference's are); assignments dropped by capacity; the stacked
     dequantize's bits against the per-matrix one; both tensor-core routes
     at the layer's five widths and M = 8 and 512, the sweep and the
     quantizer at [7168,2048], all against their plain versions and
     timed; a decode step and a prefill broken down; a small float32 MoE
     model on fp32 activations, card against CPU: routing equal, logits
     within 1e-3 of their scale, greedy tokens equal
     (``moe_small_agreement``); and the paged engines as 7j's: paged ==
     contiguous at factor 1.25, then at the least dropless factor 32
     (n_experts / top_k) one-shot paged, chunked (32 rows a slot a piece,
     its full-capacity expert queues 7.5 GB; first tokens equal to the
     one-shot's), prefix-cached cold then warm (hits, fewer prompt
     tokens, warm == cold), the bf16 tree (made again from its seed)
     paged and verifying the DAQ draft; launches (7 x 4 a layer step) and
     peak GB of each;
  7m. sliding-window attention (``swa_phase``, after 7k): Mixtral 8x22B at
     full width (d_model 6144, 48/8 heads of 128, 8 experts of 16,384
     top-2, window 4,096, vocab 32,768) cut to 4 of its 56 layers, seeded
     bf16 weights quantized in two subtrees, then 8 greedy requests of
     4,072 / 4,096 / 4,200 / 4,600 tokens, 32 each, through
     ``Engine(slots=8, k_steps=8)`` with ring caches of 4,096 rows (the
     cache's bytes asserted): the ring wraps mid-decode, at the first
     decode write and in the prefill; 4 prefill calls, the wgmma route 4 x
     4 launches a prefill call, the decode route 4 x 4 + 1 a decode step
     and 1 a prefill call (the attention products; the router is fp32 and
     the expert stacks are dequantized); a decode step after the ring
     wrapped against a one-shot prefill of the whole sequence
     (``ring_agreement``, 2e-2 of the logit scale where routing agrees);
     the paged engines as 7k's at the least dropless factor 4 (chunked at
     256 rows a slot a piece; prefix-cached with zero hits: ring blocks
     are keyed by position; the speculative round two-pass); both
     tensor-core routes at the layer's widths, the sweep and the quantizer
     at an expert's [6144,16384]; and a small float32 Mixtral-shaped model
     with a window of 16 on fp32 activations, card against CPU over 40
     steps (``swa_small_agreement``);
  7n. MoE training (``moe_train_phase``, after 7m): Mixtral 8x22B at full
     width cut to 1 of its 56 layers (2.91 B parameters), bf16 weights
     from a seed, SFT'd as 7h (``sft``: 8 AdamW steps of 4 x 512 mixed
     tokens, remat full, one step under the sync debug mode "error"; the
     router's auxiliary loss above 0 in every step, the loss falling,
     dropped assignments counted), then DAQ-quantized against its base
     (the sweep and the quantizer launch), SmoothQuant- and AWQ-quantized
     with calibration on the card, the five trees scored
     (``eval_scores``), the DAQ tree serving 8 requests of 128 tokens x
     64 (launches asserted: wgmma 4 a prefill call and 5 a scoring
     forward, decode 5 a step + 1); then a small Mixtral-shaped float32
     model trained 3 steps on the card and on the CPU, the card routing
     on the CPU's router logits, and remat full == none bit for bit on
     the card (``train_agreement``);
  7l. quant block 64 (``block64_phase``, after 7e): phase 4's weights
     DAQ-quantized at block 64 and served phase 6's 8 requests through
     ``Engine(slots=8, k_steps=8)``: the sweep's and the quantizer's
     launches, the wgmma route 7 x layers a prefill call, the decode route
     7 x layers + 1 a decode step and 1 a prefill call, the CUDA-core route
     none; quantize seconds, peak GB, tok/s, a decode step and a prefill
     broken down, and the greedy tokens' agreement with phase 6's block-128
     serve (a reading, not asserted);
  8. break one decode step, one prefill and one quantize (GLM-4-9B cut to
     4 layers at full width) down: host time, device busy time, kernel
     launches, the decode route's device time and the kernels that take
     the device time (the quantizer's always listed; a decode window is
     ``BREAKDOWN_STEPS`` steps); one paged decode
     step beside a contiguous one at the paged phase's state; one chunked
     dispatch beside a plain paged one at one state; and one speculative
     round, its draft steps and its verify at phase 7d's state.

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
# the paged phase: 16 requests of 16-496 prompt tokens, blocks of 16 tokens,
# 560 rows a slot (35 blocks); the pressure run's pool of 120 blocks holds
# three to seven requests at once against the parity run's 280
PAGED_REQUESTS, PAGED_CACHE_LEN, BLOCK, PRESSURE_BLOCKS = 16, 560, 16, 120
# the prefix phase: 16 requests of a 128-token system prompt and a 16-368
# token suffix, then two prefixes of earlier prompts cut mid-block (a
# partial-tail hit, so a copy-on-write decode write); chunks of 64 tokens,
# so each chunk product has SLOTS * 64 = 512 rows (the wgmma route)
SYSTEM_PROMPT, SUFFIX_MIN, SUFFIX_MAX, CHUNK = 128, 16, 368, 64
# it runs the first 20 of the main path's layers since the paged serves of
# 7j and 7k joined the script (40 before: on an H100 machine with a slow
# host 7c took 164 s of host-bound serving, and the script 894 s of its
# 1,200)
PREFIX_LAYERS = 20
# the speculative phase: up to 4 draft tokens a round, so a round verifies
# SLOTS * 5 = 40 rows of the bf16 tree; it runs the first 6 of the main
# path's layers (40 until phase 7j joined the script: 7d took 192-265 s
# of host-bound serving at 40, and the script 1,029 s of its 1,200; 10
# until the paged serves of 7j and 7k added ~60 s to a 698 s script)
N_SPEC = 4
SPEC_LAYERS = 6
# the methods phase's calibration language: 4,096 tokens (its [V, V] float32
# bigram table is 67 MB; at GLM-4-9B's vocabulary it would be 91.9 GB)
CALIB_VOCAB = 4096
# the host-loop and CLI phases: 16 generated tokens a request
HOST_LOOP_GEN = 16
# decode steps a profiled breakdown window holds (phases 7e, 8): 4 since
# phases 7f and 7g joined the script (8 before), to keep it near 780 s
BREAKDOWN_STEPS = 4
# the train phase: GLM-4-9B at full width, 8 layers (its training state, 16
# bytes a parameter, is 46 GB there and about 150 GB at 40 layers), 8 SFT
# steps of 4 x 512 tokens; the card-vs-CPU check takes 3 steps
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_CHECK_STEPS = 8, 8, (4, 512), 3
TRAIN_LR = 1e-4
# the MoE train phase: Mixtral 8x22B at full width, 1 of its 56 layers (2.91 B
# parameters: its training state, 16 bytes a parameter, ~47 GB; ~90 GB at 2
# layers), the train phase's steps and batches
MOE_TRAIN_LAYERS = 1
# the study phase's (base, SFT) steps: the reference's full budget
STUDY_STEPS = (600, 350)
# the SSM phase: Mamba2-780M's 8 requests, four lengths above its SSD chunk
# of 256 and none a multiple of it (a ragged last chunk), 64 tokens each
SSM_LENS = (300, 300, 520, 520, 700, 700, 1000, 1000)
# the MoE phase: DeepSeek-V3 at full width cut to its 3 dense-prefix layers
# and 1 MoE layer (61 layers would hold ~660 B parameters); 8 requests of
# four lengths (one prefill call each), 32 tokens each
MOE_LAYERS = 4
MOE_LENS = (128, 128, 256, 256, 384, 384, 512, 512)
MOE_GEN = 32
# both families on the paged engines (``family_paged_phase``): each phase's
# 8 requests, 16 tokens each (a paged serve must give the first 16 of the
# contiguous serve's), blocks of 16.  Mamba2-780M's chunk pieces lie on its
# SSD grid (256 rows a slot: 2,048 a piece); DeepSeek-V3's are 32 rows a
# slot at the least dropless capacity factor, n_experts / top_k = 32: a
# chunk piece routes at full capacity, g * top_k rows an expert, so its
# expert input is 256 x 2,048 x 7,168 bf16 = 7.5 GB (the output as much
# again) at 8 x 32 rows, 15 GB at 8 x 64
FAMILY_GEN = 16
SSM_CHUNK = 256
MOE_CHUNK = 32
# the sliding-window phase: Mixtral 8x22B at full width cut to 4 of its 56
# layers (10.42 B parameters; 140.6 B at 56); 8 requests of four lengths
# about its window of 4,096 rows, 32 tokens each: 4,072 wraps the ring
# mid-decode, 4,096 at the first decode write, 4,200 and 4,600 are prefilled
# past it (a ring keeps their last 4,096 rows).  Its paged engines take
# 256 rows a slot a chunk piece at the least dropless capacity factor,
# n_experts / top_k = 4: a piece routes at full capacity, so its expert
# queues hold 8 x 4,096 x 6,144 bf16 = 0.4 GB
SWA_LAYERS = 4
SWA_LENS = (4072, 4072, 4096, 4096, 4200, 4200, 4600, 4600)
SWA_GEN = 32
SWA_CHUNK = 256


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
QUANT_INSTANCE = re.compile(r"quant_(tile|general)_kernel")


def sweep_instance(entry: str):
    """(NC, V) of a sweep instance's mangled name, else None."""
    inst = SWEEP_INSTANCE.search(entry)
    return (int(inst.group(1)), int(inst.group(2))) if inst else None


def quant_instance_of(entry: str):
    """"tile" or "general" for a quantizer instance's mangled name, else None."""
    inst = QUANT_INSTANCE.search(entry)
    return inst.group(1) if inst else None


def ptxas_resources(build_log: str, instance=sweep_instance) -> dict:
    """``{instance(entry): (registers, spill store bytes, spill load bytes)}``
    of every entry function that ``instance`` names (not None), from
    ``ptxas -v`` (an entry's lines follow its "Compiling entry function"
    line)."""
    found, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = instance(m.group(1))
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


def build_and_report() -> dict | None:
    """Phase 2: build every kernel library; print the registers and spills
    of each quantizer and sweep instance (failing on a spill) and the
    sweep's element-loop SASS.  Returns ``sweep_sass``'s result."""
    from repro_torch.kernels import _lib
    t0 = time.perf_counter()
    _lib.build_all()
    log(f"built {len(_lib.KERNELS)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for k in _lib.KERNELS:
        if k in (_lib.SCALE_SEARCH, _lib.FP8_QUANT):
            continue
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k.name}: {line.strip()}")
    # the quantizer's two instances and the sweep's: registers and spills
    # (ptxas); the sweep's element loop in SASS (one row step: V elements x
    # NC candidates)
    quant = ptxas_resources(_lib.FP8_QUANT.build_log, quant_instance_of)
    for inst, (regs, st, ld) in sorted(quant.items()):
        log(f"  fp8_quant {inst}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    if sorted(quant) != ["general", "tile"]:
        raise AssertionError(f"ptxas reported the quantizer instances {sorted(quant)}")
    if any(st or ld for _, st, ld in quant.values()):
        raise AssertionError("a quantizer instance spills registers")
    resources = ptxas_resources(_lib.SCALE_SEARCH.build_log)
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
    return sass


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


def check_sweeps(torch, weights, sass: dict | None, clock_mhz: float | None,
                 cases=SWEEP_CASES) -> dict:
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
    for (I, O), n_cand, bs, qmax, timed in cases:
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


def delta_weights(torch, g):
    """``weights(I, O)``: a bf16-valued fp32 post weight [I, O] (std 0.02)
    and a base 1 % of its std away, drawn on the card from ``g``."""
    def weights(I, O):
        wp = (torch.randn((I, O), generator=g, device="cuda") * 0.02).bfloat16().float()
        wb = (wp + torch.randn((I, O), generator=g, device="cuda") * 2e-4).bfloat16().float()
        return wp, wb
    return weights


def check_kernels(torch, seed: int, sass: dict | None, clock_mhz: float | None) -> dict:
    """Each kernel at main-path shapes vs its plain version.  Returns the
    per-kernel record of the representative shape (others are logged)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    records = {}
    weights = delta_weights(torch, g)
    records["scale_search"] = check_sweeps(torch, weights, sass, clock_mhz)

    quant = check_quantizer(torch, weights)
    records["fp8_quant"] = quant[(4096, 13696, 128)]
    check_nonfinite(torch)

    torch.cuda.empty_cache()
    records.update(check_matmul_routes(torch, g))
    check_general_routes(torch, g)
    time_general_routes(torch, g)
    crossover(torch, g)
    torch.cuda.empty_cache()
    return records


# (I, O), block, timed, offset: the main path's widest matrix [4096,13696]
# (the record) and the LM head, a small width (the register-tile instance);
# then w one float into its storage, and blocks 64 and 66 (the general
# instance)
QUANT_CASES = (((4096, 13696), 128, True, 0), ((4096, 151552), 128, True, 0),
               ((256, 384), 128, True, 0), ((256, 384), 128, False, 1),
               ((512, 384), 64, False, 0), ((396, 330), 66, False, 0))


def codes_differ(torch, a, b) -> int:
    """E4M3 codes of ``a`` and ``b`` that differ, a NaN code (0x7F or 0xFF:
    the sign of a NaN is not defined across implementations) equal to a NaN."""
    a, b = a.view(torch.uint8), b.view(torch.uint8)
    both_nan = ((a & 0x7F) == 0x7F) & ((b & 0x7F) == 0x7F)
    return int(((a != b) & ~both_nan).sum())


def floats_differ(torch, a, b) -> int:
    """float32 values of ``a`` and ``b`` whose bits differ, a NaN equal to a NaN."""
    return int(((a.view(torch.int32) != b.view(torch.int32)) & ~(a.isnan() & b.isnan())).sum())


def check_quantizer(torch, weights, cases=QUANT_CASES) -> dict:
    """The quantizer against its plain version (``QUANT_CASES``): codes and
    scales bit-equal.  Timed cases: device time (``device_ms``, as the
    matmul: the profiler's kernel durations, copies of w together over the
    L2) as ``ms``, beside the CUDA-event mean of 10 back-to-back wrapper
    calls (``event_ms``, the method of PR 17's record).  Returns
    ``{(I, O, block): record}`` of the timed cases."""
    from repro_torch.kernels.fp8_quant.kernel import quant_instance, quantize_fp8_cuda
    from repro_torch.kernels.fp8_quant.ref import quantize_fp8_ref
    alpha = torch.tensor([1.0375], device="cuda")
    records = {}
    for (I, O), bs, timed, offset in cases:
        w, _ = weights(I, O)
        if offset:
            w = torch.cat([torch.zeros(offset, device="cuda"), w.reshape(-1)])[offset:].view(I, O)
        run_k = lambda: quantize_fp8_cuda(w, alpha, block=bs)
        run_p = lambda: quantize_fp8_ref(w, alpha, block=bs)
        (qk, sk), (qp, sp) = run_k(), run_p()
        torch.cuda.synchronize()
        n_codes, n_scales = codes_differ(torch, qk, qp), floats_differ(torch, sk, sp)
        deq = lambda q, s: q.float().reshape(I // bs, bs, O // bs, bs) * s[:, None, :, None]
        rec = dict(max_abs_err=float((deq(qk, sk) - deq(qp, sp)).abs().max()))
        if timed:
            b_ms, b_by = bound(I * O * 4 + I * O + (I // bs) * (O // bs) * 4 + 4, I * O * 4,
                               FP32_FLOPS)
            copies = [w] + [w.clone() for _ in range(-(-COLD_BYTES // (4 * I * O)) - 1)]
            rec.update(ms=device_ms(torch, [lambda c=c: quantize_fp8_cuda(c, alpha, block=bs)
                                            for c in copies]),
                       event_ms=time_ms(torch, run_k, 10), plain_ms=time_ms(torch, run_p, 3),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
            del copies
        ok = n_codes == 0 and n_scales == 0
        log(f"kernel-check fp8_quant [{I},{O}] block {bs} ({quant_instance(bs, w.data_ptr())} "
            f"instance{f', w {4 * offset} bytes into its storage' if offset else ''}): "
            f"{n_codes} code / {n_scales} scale mismatches -> {'ok' if ok else 'FAIL'}; "
            + json.dumps(rec))
        if not ok:
            raise AssertionError(f"fp8_quant kernel disagrees at [{I},{O}] block {bs}")
        if timed:
            records[(I, O, bs)] = rec
        del w, qk, qp
    torch.cuda.empty_cache()
    return records


DEN = 2.0 ** -149   # the smallest float32 denormal
DEN_MAX = (2 ** 23 - 1) * DEN   # the largest float32 denormal
TINY = 2.0 ** -126  # the smallest normal float32
# denormal deltas of both signs, and the smallest normals beside them
DENORMALS = (DEN, -DEN, 1e-40, -1e-40, 1e-39, -1.1e-38, DEN_MAX, -DEN_MAX)


def nonfinite_pair(torch, bs: int):
    """wp, wb [2 bs, 3 bs] on the card: tile (0, 0) a NaN in wp, (0, 1) +inf,
    (0, 2) -inf, (1, 0) zero but for denormals (the 1e-12 floor): each of
    ``DENORMALS`` in wp over wb = 0, in wb under wp = 0 and in wp over its
    negation in wb (an IEEE difference that can be normal), all of which
    the reference reads as 0, and ±TINY, the smallest normal, over wb = 0
    (kept);
    (1, 1) +inf and -inf, (1, 2) a NaN in wb only."""
    g = torch.Generator(device="cuda").manual_seed(bs)
    wb = torch.randn((2 * bs, 3 * bs), generator=g, device="cuda") * 0.05
    wp = wb + torch.randn(wb.shape, generator=g, device="cuda") * 0.002
    wp[3, 5] = math.nan
    wp[7, bs + 9] = math.inf
    wp[bs - 1, 2 * bs] = -math.inf
    wp[bs:, :bs] = 0.0
    wb[bs:, :bs] = 0.0
    wp[bs + 1, 1], wb[bs + 2, 2] = DEN, -DEN
    for j, d in enumerate(DENORMALS):
        wp[bs + 3, j] = d                   # dp = d, dq = 0: a match once flushed
        wb[bs + 4, j] = d                   # dp = dq = -d
        wp[bs + 5, j] = -TINY if j % 2 else TINY
        wp[bs + 6, j], wb[bs + 6, j] = d, -d   # dp = 0 - 0 as the reference reads it
    wp[bs + 1, bs + 1], wp[bs + 4, 2 * bs - 1] = math.inf, -math.inf
    wb[bs + 2, 2 * bs + 3] = math.nan
    return wp, wb


def sign_class(a, flush: bool):
    """numpy sign of float32 ``a``, a denormal read as 0 with ``flush``."""
    import numpy as np
    return np.sign(np.where(np.abs(a) < TINY, np.float32(0.0), a) if flush else a)


def denormal_tile_matches(wp, wb, bs: int, flush: bool) -> int:
    """Sign matches of the denormal tile (1, 0) counted on the host: its
    codes are all 0 (amax is the 1e-12 floor), so dq = -wb at every
    candidate; with ``flush`` every denormal, weight or delta, reads as 0,
    as in the reference."""
    import numpy as np
    p, b = (t[bs:, :bs].cpu().numpy() for t in (wp, wb))
    if flush:
        p, b = (np.where(np.abs(t) < TINY, t * np.float32(0.0), t) for t in (p, b))
    return int((sign_class(p - b, flush) == sign_class(-b, flush)).sum())


def sums_agree(torch, k, p) -> bool:
    """fp32 sums: NaN and +-inf where the plain version has them, else
    |err| <= 1e-4 |plain| + 1e-6 max |plain| (sums in another order)."""
    fin = torch.isfinite(p)
    if not (torch.equal(torch.isnan(k), torch.isnan(p)) and torch.equal(torch.isfinite(k), fin)
            and torch.equal(k[torch.isinf(p)], p[torch.isinf(p)])):
        return False
    k, p = k[fin], p[fin]
    return bool(((k - p).abs() <= 1e-4 * p.abs() + 1e-6 * p.abs().max()).all())


def check_nonfinite(torch) -> None:
    """The quantize path's kernels on tiles holding NaN, +-inf and zeros
    (``nonfinite_pair``) against their plain versions on the card and on the
    CPU: the quantizer's codes and scales bit-equal (NaN as NaN); the sweep's
    sign counts equal and its other sums NaN and inf where the plain
    version's are (``sums_agree``).  Blocks 128 (the register-tile quantizer,
    the float4 sweep), 64 and 66 (the general quantizer; 66 the scalar
    sweep), and qmax 240 (the scalar sweep, which clips above too)."""
    from repro_torch.core.search import linspace
    from repro_torch.kernels.fp8_quant.kernel import quant_instance, quantize_fp8_cuda
    from repro_torch.kernels.fp8_quant.ref import quantize_fp8_ref
    from repro_torch.kernels.scale_search.kernel import sweep_partials_cuda
    from repro_torch.kernels.scale_search.ref import sweep_partials_ref
    alpha = torch.tensor([1.0375], device="cuda")
    alphas = torch.cat([torch.ones(1, device="cuda"), linspace(0.8, 1.25, 10, "cuda")])
    for bs, qmax in ((128, 448.0), (64, 448.0), (66, 448.0), (128, 240.0)):
        wp, wb = nonfinite_pair(torch, bs)
        if qmax == 448.0:
            (qk, sk), (qp, sp) = quantize_fp8_cuda(wp, alpha, block=bs), \
                quantize_fp8_ref(wp, alpha, block=bs)
            qc, sc = quantize_fp8_ref(wp.cpu(), alpha.cpu(), block=bs)
            n_q = codes_differ(torch, qk, qp) + codes_differ(torch, qk.cpu(), qc)
            n_s = floats_differ(torch, sk, sp) + floats_differ(torch, sk.cpu(), sc)
            ok = n_q == 0 and n_s == 0 and bool(sk[0, 0].isnan()) and bool(sk[0, 1:].isinf().all())
            log(f"kernel-check fp8_quant non-finite tiles block {bs} "
                f"({quant_instance(bs, wp.data_ptr())} instance): scales "
                f"{sk.flatten().tolist()}; {n_q} code / {n_s} scale mismatches against the "
                f"plain version on the card and the CPU -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"fp8_quant kernel disagrees on non-finite tiles, block {bs}")
        amax = wp.reshape(2, bs, 3, bs).abs().amax(dim=(1, 3)).clamp_min(1e-12)
        pk = sweep_partials_cuda(wp, wb, amax, alphas, block_size=bs, qmax=qmax)
        pp = sweep_partials_ref(wp, wb, amax, alphas, block_size=bs, qmax=qmax)
        pc = sweep_partials_ref(wp.cpu(), wb.cpu(), amax.cpu(), alphas.cpu(), block_size=bs,
                                qmax=qmax)
        torch.cuda.synchronize()
        signs = (pk[..., 1] != pp[..., 1]).sum().item() + (pk[..., 1].cpu() != pc[..., 1]).sum().item()
        count = lambda flush: denormal_tile_matches(wp, wb, bs, flush)
        den_ok = bool((pk[:, 1, 0, 1] == count(True)).all())
        ok = signs == 0 and den_ok and all(sums_agree(torch, pk[..., i], pp[..., i])
                                           for i in (0, 2, 3, 4))
        log(f"kernel-check scale_search non-finite tiles block {bs} qmax {qmax:g}: sign counts "
            f"of tile (0,0) {pk[:, 0, 0, 1].tolist()[:3]}..., {signs} sign-count mismatches "
            f"against the plain version on the card and the CPU; denormal tile (1,0) "
            f"{pk[0, 1, 0, 1].item():g} matches, {count(True)} with denormals read as 0 "
            f"({count(False)} as IEEE signs) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"scale_search kernel disagrees on non-finite tiles, block {bs}"
                                 f" qmax {qmax:g}")


COLD_BYTES = 128 << 20   # weight copies rotated per timing: well over the 50 MB L2


def device_times(torch, calls, reps: int = 24) -> tuple[float, float]:
    """(profiler ms, replay ms): the mean time of one call by
    ``torch.profiler``'s device events (the sum of every kernel's duration,
    a split product's second pass included: no host issue time) and by CUDA
    events around a CUDA-graph replay of the same launches (kernels and the
    gaps between them).  ``calls`` are zero-argument callables, each on its
    own copy of the weights (together over ``COLD_BYTES``), launched in
    turn, ``reps`` launches at least, so no launch finds its weights in the
    L2."""
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
    prof_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA) / 1e3 / n
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
    return prof_ms, a.elapsed_time(b) / n


def device_ms(torch, calls, reps: int = 24) -> float:
    """Mean device time of one call, in ms, with cold weights: the
    profiler's time of ``device_times``, unless it is under half the
    replay's (or none).  Late in a long process the profiler has lost most
    of a window's kernels (an LM head product read at 0.0017 ms, under its
    0.0236 ms bound); then the replay's time is kept, with a line that
    says so."""
    prof_ms, replay_ms = device_times(torch, calls, reps)
    if prof_ms >= 0.5 * replay_ms:
        return prof_ms
    log(f"device_ms: the profiler read {prof_ms:.5f} ms a call, under half the "
        f"{replay_ms:.5f} ms of a CUDA-graph replay timed by CUDA events: it lost "
        f"kernels; the replay's time is kept")
    return replay_ms


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


def matmul_times(torch, run, case) -> dict:
    """Cold device times of ``run``, the plain version and cuBLAS bf16 on
    ``case``, and the bound: bytes of codes, scales, x and y over the HBM
    rate, or operations at the bf16 tensor-core peak (three passes for fp32
    x on the tensor-core routes: ``split_bf16``'s parts)."""
    from repro_torch.kernels.fp8_matmul.kernel import route
    from repro_torch.kernels.fp8_matmul.ref import matmul_fp8_ref
    M, K, N, bs = case.M, case.K, case.N, case.block
    passes = 3 if case.x.dtype == torch.float32 and route(
        M, N, K, bs, case.x.dtype) != "cuda_core" else 1
    b_ms, b_by = bound(matmul_bytes(M, K, N, bs, case.x.element_size()),
                       passes * 2 * M * K * N, BF16_FLOPS)
    return dict(ms=device_ms(torch, case.calls(run)),
                plain_ms=device_ms(torch, case.calls(matmul_fp8_ref), reps=len(case.w)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=device_ms(torch, case.library_calls(torch)))


def check_matmul(torch, name, run, case, *, time_it=False) -> dict:
    """``run`` against the plain version on copy 0 of ``case``: |err| <=
    1e-4 |plain| + 1e-5 max|plain| over the element's row (fp32 sums in
    another order; bf16 x bf16 products are exact in fp32; each row is held
    to its own scale, so a row of tiny x is checked beside a row of huge
    x).  With ``time_it``, ``matmul_times``."""
    from repro_torch.kernels.fp8_matmul.ref import matmul_fp8_ref
    M, K, N, bs = case.M, case.K, case.N, case.block
    wq, sc = case.w[0]
    yk = run(case.x, wq, sc, block=bs)
    yp = matmul_fp8_ref(case.x, wq, sc, block=bs)
    torch.cuda.synchronize()
    err = (yk - yp).abs()
    ok = bool(torch.isfinite(yk).all()) and bool(
        (err <= 1e-4 * yp.abs() + 1e-5 * yp.abs().amax(dim=1, keepdim=True)).all())
    rec = dict(max_abs_err=float(err.max()))
    if time_it:
        rec.update(matmul_times(torch, run, case))
    log(f"kernel-check {name} M={M} [{K},{N}] x {str(case.x.dtype)[6:]} block {bs}: -> "
        f"{'ok' if ok else 'FAIL'}; " + json.dumps(rec))
    if not ok:
        raise AssertionError(f"{name} kernel disagrees at M={M} [{K},{N}] block {bs}")
    return rec


def check_routed(torch, case, want: str) -> dict:
    """``kernel.matmul_fp8_cuda`` (``route``'s kernel; fp32 x split into
    three bf16 parts) on ``case`` against the plain version
    (``check_matmul``), and its one launch on the kernel named ``want``."""
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.kernels.fp8_matmul.kernel import matmul_fp8_cuda
    before = {k.name: k.launches for k in KERNELS}
    rec = check_matmul(torch, f"{want} (routed)", matmul_fp8_cuda, case)
    got = {k.name: k.launches - before[k.name] for k in KERNELS
           if k.launches != before[k.name]}
    if got != {want: 1}:
        raise AssertionError(f"route: M={case.M} [{case.K},{case.N}] block {case.block} "
                             f"{case.x.dtype} launched {got}, expected one {want}")
    return rec


DECODE_WIDTHS = ((4096, 13696), (4096, 4096), (4096, 256), (13696, 4096), (4096, 151552))


def check_matmul_routes(torch, g) -> dict:
    """The fp8 matmul's three routes against the plain version at the
    shapes the main path and the route table give them."""
    from repro_torch.kernels.fp8_matmul.kernel import (matmul_fp8_cuda_core,
                                                       matmul_fp8_decode, matmul_fp8_wgmma)
    records = {}
    f32, f16, bf16 = torch.float32, torch.float16, torch.bfloat16
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
    # CUDA-core route: its M = 8 bf16 time beside the tensor-core routes';
    # through route(), the blocks that are not multiples of 16, all x types
    records["fp8_matmul"] = check_matmul(
        torch, "fp8_matmul", matmul_fp8_cuda_core, MatmulCase(torch, g, SLOTS, 4096, 13696),
        time_it=True)
    for M, (K, N), block, x_dtype in ((SLOTS, (512, 384), 8, bf16), (SLOTS, (1040, 1600), 40, f32),
                                      (200, (660, 1320), 66, f16), (SLOTS, (660, 1320), 66, f32)):
        check_routed(torch, MatmulCase(torch, g, M, K, N, block=block, x_dtype=x_dtype,
                                       timed=False), "fp8_matmul")
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


# The tensor-core routes at quant blocks other than 128 (each at a K and N
# off the 128 grid where the block allows), x types and rows of x
GENERAL_SHAPES = {16: (1040, 1552), 32: (1056, 1568), 64: (1088, 1600), 96: (1056, 1632),
                  256: (1280, 1792), 512: (1536, 2560)}
GENERAL_ROWS = (1, 5, 8, 15, 16, 17, 1024)
# the timed ones: (block, x type) at a decode step's M = 8, a prefill's
# 1,024 rows of [4096,13696] and the LM head at M = 8
GENERAL_TIMED = ((64, "bfloat16"), (32, "bfloat16"), (128, "float16"), (128, "float32"))
TIMED_SHAPES = ((SLOTS, 4096, 13696), (SLOTS * PROMPT, 4096, 13696), (SLOTS, 4096, 151552))
ROUTE_KERNEL = {"decode": "fp8_matmul_decode", "wgmma": "fp8_matmul_wgmma",
                "cuda_core": "fp8_matmul"}


def check_general_routes(torch, g) -> None:
    """The decode and wgmma instances for blocks other than 128 and for fp16
    and fp32 x, through ``route`` and against the plain version: every
    block of ``GENERAL_SHAPES`` with bf16, fp16 and fp32 x at every M of
    ``GENERAL_ROWS``; [192,320] (K and N off the 64-column tile) and
    [1088,1600] at block 64; weights whose tiles hold every finite E4M3
    code; fp32 x with rows near 1e-30 and, in the same x, rows holding
    3e38 and -2.5e38 (``split_bf16`` scales only those by 2^-64; each row
    is held to its own scale).  Then phase 7l's products: every GLM-4-9B
    width of ``DECODE_WIDTHS`` at block 64 with bf16 x, at a decode step's
    rows (decode route) and, but the LM head, a prefill's (wgmma)."""
    from repro_torch.kernels.fp8_matmul.kernel import route
    dtypes = (torch.bfloat16, torch.float16, torch.float32)

    def check(M, K, N, bs, dt, x=None, all_codes=False):
        case = MatmulCase(torch, g, M, K, N, block=bs, x_dtype=dt, all_codes=all_codes,
                          timed=False)
        if x is not None:
            case.x = x
        return check_routed(torch, case, ROUTE_KERNEL[route(M, N, K, bs, dt)])

    n = 0
    for bs, (K, N) in GENERAL_SHAPES.items():
        for dt in dtypes:
            for M in GENERAL_ROWS:
                check(M, K, N, bs, dt)
                n += 1
    for M in (SLOTS, SLOTS * PROMPT):
        for dt in dtypes:
            check(M, 192, 320, 64, dt)
            check(M, 1088, 1600, 64, dt)
            check(M, 1024, 1536, 64, dt, all_codes=True)
            n += 3
    for M in (4, 64):
        x = torch.randn((M, 1024), generator=g, device="cuda")
        x[: M // 2] *= 1e-30
        x[M // 2:, 7], x[M // 2:, 100] = 3e38, -2.5e38
        for bs in (64, 128):
            check(M, 1024, 1536, bs, torch.float32, x=x)
            n += 1
    for K, N in DECODE_WIDTHS:
        for M in (SLOTS,) if N == 151552 else (SLOTS, SLOTS * PROMPT):
            check(M, K, N, 64, torch.bfloat16)
            n += 1
            torch.cuda.empty_cache()
    log(f"general routes: {n} products through route() agree with the plain version")
    torch.cuda.empty_cache()


def time_general_routes(torch, g) -> None:
    """Cold device times of the tensor-core routes at ``GENERAL_TIMED`` x
    ``TIMED_SHAPES``, each beside its bound, cuBLAS bf16, the plain version
    and the CUDA-core kernel at the same shape in the same call."""
    from repro_torch.kernels.fp8_matmul.kernel import (join_bf16, matmul_fp8_cuda,
                                                       matmul_fp8_cuda_core, split_bf16)
    for bs, dt in GENERAL_TIMED:
        for M, K, N in TIMED_SHAPES:
            case = MatmulCase(torch, g, M, K, N, block=bs, x_dtype=getattr(torch, dt))
            rec = check_matmul(torch, "general route (timed)", matmul_fp8_cuda, case)
            rec.update(matmul_times(torch, matmul_fp8_cuda, case))
            rec["cuda_core_ms"] = device_ms(torch, case.calls(matmul_fp8_cuda_core))
            if dt == "float32":     # the split's and the join's share of ms
                y3 = torch.empty((3 * M, N), device="cuda")
                rec["split_join_ms"] = device_ms(
                    torch, [lambda: join_bf16(y3, split_bf16(case.x)[1])])
            log(f"general-route timing M={M} [{K},{N}] x {dt} block {bs} (cold device ms): "
                + json.dumps(rec))
            del case
            torch.cuda.empty_cache()


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
    g = torch.Generator(device=model.device).manual_seed(seed)
    post = model.init(g)
    return post, make_base(torch, post, g)


def make_base(torch, post, g):
    """The base tree of ``make_weights``, drawing its noise from ``g``: a
    generator in the state ``make_weights`` left it after the init remakes
    the same base (phase 7e remakes phase 4's after phase 5 freed it)."""
    from repro_torch.core.policy import tree_map

    def perturb(t):
        if t.ndim < 2:
            return t
        out = torch.empty_like(t)
        mats = t.reshape(-1, *t.shape[-2:])
        for i, m in enumerate(mats):
            noise = torch.randn(m.shape, generator=g, device=m.device)
            out.reshape(-1, *t.shape[-2:])[i] = (m.float() + 0.01 * m.float().std() * noise).to(t.dtype)
        return out

    return tree_map(perturb, post)


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


def card_vs_cpu(torch, seed: int, block: int, dtype: str, label: str, also=None):
    """A small GLM-shaped model with ``dtype`` parameters over fp8 weights
    quantized once on the CPU at ``block``, prefilled (4 x 32 tokens) and
    stepped once on the CPU (plain versions) and on the GPU: logits within
    5 % of the largest (its activations are bf16 whatever the parameters'
    type, ``models/common.py::ACT_DTYPE``, as in the reference).  ``also(
    q_cpu, q_gpu, g)`` runs after the GPU's step, inside the counted window.
    Returns (cfg, the kernels' launch counts of the GPU run, zeroed just
    before it, what ``also`` returned)."""
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.core.policy import tree_map
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.models import build_model
    from repro_torch.quant_runtime.qparams import QuantizedTensor
    from repro_torch.quantize import quantize
    cfg = dataclasses.replace(get_arch("glm4-9b"), n_layers=2, d_model=256, n_heads=2,
                              n_kv_heads=1, head_dim=128, d_ff=512, vocab_size=1024,
                              dtype=dtype)
    m_cpu, m_gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    g = torch.Generator().manual_seed(seed)
    post = m_cpu.init(g)
    q_cpu, _ = quantize(post, make_base(torch, post, g),
                        QuantConfig(use_fused_kernel=True, block_size=block), mode="storage")
    q_gpu = tree_map(lambda t: dataclasses.replace(t, data=t.data.cuda(), scale=t.scale.cuda())
                     if isinstance(t, QuantizedTensor) else t.cuda(), q_cpu)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=g)
    nxt = torch.randint(0, cfg.vocab_size, (4, 1), generator=g)
    lc, cc = m_cpu.prefill(q_cpu, {"tokens": tokens}, cache_len=40)
    dc, _ = m_cpu.decode_step(q_cpu, nxt, cc)
    for k in KERNELS:
        k.launches = 0
    lg, cg = m_gpu.prefill(q_gpu, {"tokens": tokens.cuda()}, cache_len=40)
    dg, _ = m_gpu.decode_step(q_gpu, nxt.cuda(), cg)
    extra = also(q_cpu, q_gpu, g) if also else None
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS}
    for name, gpu, cpu in (("prefill", lg, lc), ("decode", dg, dc)):
        err = (gpu.float().cpu() - cpu.float()).abs().max().item()
        scale = cpu.float().abs().max().item()
        log(f"{label} agreement ({name}, block {block}): logits max |gpu - cpu| = {err:.4g} "
            f"(max |logit| {scale:.4g}, tolerance 5% of it); launches {json.dumps(launches)}")
        if not err <= 0.05 * scale:
            raise AssertionError(f"{label}: GPU and CPU {name} logits disagree")
    return cfg, launches, extra


def fp32_model_agreement(torch, seed: int) -> dict:
    """fp32 and fp16 x and a block other than 128 on the tensor-core routes:
    ``card_vs_cpu`` with float32 parameters at block 64, whose prefill's
    products take the wgmma route and its LM heads and decode step the
    decode route.  Then each quantized linear of its first layer and its LM
    head takes fp32 x (8 rows: 24 stacked bf16 rows, the wgmma route)
    through ``ops.matmul_fp8`` and fp16 x (the decode route) through
    ``ops.matmul_fp8_2d`` on both devices: |gpu - cpu| <= 1e-4 |cpu| + 1e-5
    max|cpu| (fp32 sums in another order).  Returns the kernels' launch
    counts of the GPU runs."""
    from repro_torch.kernels.fp8_matmul import ops
    layer0 = lambda q: [q["stack"]["L0"][part][name].layer(0)
                        for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                                            ("mlp", ("w_gate", "w_up", "w_down")))
                        for name in names] + [q["embed"]["w_head"]]

    def direct(q_cpu, q_gpu, g):
        xs = [torch.randn((8, w.shape[0]), generator=g) for w in layer0(q_cpu)]
        return [(ops.matmul_fp8(x.cuda(), wg), ops.matmul_fp8(x, wc),
                 ops.matmul_fp8_2d(x.half().cuda(), wg.data, wg.scale[:, 0, :, 0], block=64),
                 ops.matmul_fp8_2d(x.half(), wc.data, wc.scale[:, 0, :, 0], block=64))
                for x, wg, wc in zip(xs, layer0(q_gpu), layer0(q_cpu))]

    cfg, launches, products = card_vs_cpu(torch, seed + 2, 64, "float32", "float32-model",
                                          also=direct)
    n = 7 * cfg.n_layers
    want = {"fp8_matmul_wgmma": n + len(products),
            "fp8_matmul_decode": 1 + (n + 1) + len(products), "fp8_matmul": 0}
    if {k: launches[k] for k in want} != want or sum(launches.values()) != sum(want.values()):
        raise AssertionError(f"float32 model: launches {launches}, expected {want}")
    worst = 0.0
    for y32g, y32c, y16g, y16c in products:
        for gpu, cpu in ((y32g, y32c), (y16g, y16c)):
            gpu = gpu.cpu()
            if gpu.dtype != torch.float32 or cpu.dtype != torch.float32:
                raise AssertionError(f"float32 model: product in {gpu.dtype}, expected float32")
            err = (gpu - cpu).abs()
            worst = max(worst, float((err / (1e-4 * cpu.abs() + 1e-5 * cpu.abs().max())).max()))
    log(f"float32-model agreement: {len(products)} linears x fp32 (wgmma) and fp16 (decode) "
        f"x, worst |gpu - cpu| at {worst:.3f} of its tolerance")
    if not worst <= 1.0:
        raise AssertionError("float32 model: GPU and CPU fp32 / fp16-x products disagree")
    return launches


def odd_block_agreement(torch, seed: int, block: int = 8) -> dict:
    """The CUDA-core kernel's own path, a quant block that is not a multiple
    of 16: ``card_vs_cpu`` with bf16 parameters at block 8, where every
    product takes the CUDA-core kernel.  Returns its launch counts."""
    cfg, launches, _ = card_vs_cpu(torch, seed + 3, block, "bfloat16", f"block-{block} model")
    want = 2 * (7 * cfg.n_layers + 1)
    if launches["fp8_matmul"] != want or sum(launches.values()) != want:
        raise AssertionError(f"block-{block} model: launches {launches}, expected {want} of "
                             f"fp8_matmul")
    return launches


def leaf_sign_rates_hold(report, name: str) -> None:
    """Every leaf's chosen sign rate at least its AbsMax one (mean over its
    layers; each layer's count is at least AbsMax's, so up to rounding)."""
    for leaf, r in report.per_leaf.items():
        if r["chosen"]["sign_rate"] < r["default"]["sign_rate"] - 1e-6:
            raise AssertionError(f"{name}: sign rate {r['chosen']['sign_rate']} below "
                                 f"AbsMax's {r['default']['sign_rate']} on {leaf}")


def main_path(torch, args, records: dict):
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
    g = torch.Generator(device=model.device).manual_seed(args.seed)
    post = model.init(g)
    base_state = g.get_state()          # phase 7e remakes base from here
    base = make_base(torch, post, g)
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
    del base        # post stays: phase 7d's verifier
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
    log(f"quantize: chosen-alpha hash {alpha_hash(report.per_leaf)}, code-and-scale hash "
        f"{code_hash(torch, qparams)} over {leaf_layers(report)} leaf-layers")
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
    want = fp8_serve_launches(stats, cfg.n_layers)
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
    leaf_sign_rates_hold(report, "DAQ")
    log(f"outputs: {len(outputs)} rows of {GEN} tokens in range; first row "
        f"{outputs[0][:12]}...")
    return model, post, qparams, torch.stack(requests), outputs, base_state


def fp8_serve_launches(stats: dict, n_layers: int, per_layer: int = 7) -> dict:
    """The fp8 routes' launches a bf16 serve makes: ``per_layer`` quantized
    products a layer, prefill rows (M >= 16) on the wgmma route, decode rows
    and each LM head (last token, M = slots) on the decode route, none on
    the CUDA-core route.  A dense or DeepSeek-V3 layer has seven: its
    attention's four and its MLP's or shared expert's three (the MoE
    router is fp32 and never quantized, and the expert stacks are
    dequantized and multiplied by ``torch.matmul``); a Mamba-2 layer five
    (``in_z``, ``in_x``, ``in_bc``, ``in_dt``, ``out_proj``; the ragged
    ``in_dt`` [D, heads] and the LM head [D, 50280] through their
    zero-padded block grids)."""
    return {"fp8_matmul_wgmma": per_layer * n_layers * stats["prefill_calls"],
            "fp8_matmul_decode": (per_layer * n_layers + 1) * stats["decode_steps"]
            + stats["prefill_calls"],
            "fp8_matmul": 0}


# ---------------------------------------------------------------------------
# The paged phase: the paged engine at full width against the contiguous one
# ---------------------------------------------------------------------------

def counted_serve(torch, engine, requests, gen: int = GEN):
    """``engine.serve`` (``gen`` tokens a request) with every kernel count
    zeroed just before and read just after: (outputs, stats, launches,
    seconds).  An engine with
    telemetry on (``telemetry_on``) gets a fresh registry and tracer for the
    serve, checked after it (``check_telemetry``)."""
    from repro_torch.kernels._lib import KERNELS
    if engine.metrics is not None:
        telemetry_on(engine)
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    outputs, stats = engine.serve(requests, gen_tokens=gen, return_stats=True)
    if engine.model.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    if engine.metrics is not None:
        check_telemetry(f"serve of {len(requests)} requests", engine, len(requests))
    return outputs, stats, launches, secs


def telemetry_on(engine):
    """Attach a metrics registry and a tracer to ``engine``; ``counted_serve``
    gives it a fresh pair for each serve and checks what they recorded."""
    from repro_torch.telemetry import MetricsRegistry, Tracer
    engine.metrics, engine.tracer = MetricsRegistry(), Tracer()
    return engine


def trace_tracks(doc: dict) -> dict:
    """Track name -> span and instant events of a Chrome trace, after its
    schema checks: the two top-level keys, metadata for every track, ``ts``
    and ``dur`` >= 0, and timestamps that never go back within a track."""
    if set(doc) != {"traceEvents", "displayTimeUnit"} or doc["displayTimeUnit"] != "ms":
        raise AssertionError(f"trace: top-level keys {sorted(doc)}")
    names, per_track = {}, {}
    for ev in doc["traceEvents"]:
        if ev["ph"] == "M":
            if ev["name"] == "thread_name":
                names[ev["tid"]] = ev["args"]["name"]
            continue
        if ev["ts"] < 0 or ev.get("dur", 0) < 0:
            raise AssertionError(f"trace: negative time in {ev}")
        if ev["ph"] in ("X", "i"):
            per_track.setdefault(ev["tid"], []).append(ev["ts"])
    for tid, ts in per_track.items():
        if tid not in names:
            raise AssertionError(f"trace: track {tid} has no thread_name")
        if ts != sorted(ts):
            raise AssertionError(f"trace: track {names[tid]}'s timestamps go back")
    return {names[tid]: len(ts) for tid, ts in per_track.items()}


def telemetry_summary(snap: dict) -> str:
    """TTFT, TPOT and queue-wait p50 / p95 of a metrics snapshot."""
    hs = snap["histograms"]
    return ", ".join(f"{h.split('.')[1][:-2]} p50 {hs[h]['p50'] * 1e3:.2f} ms p95 "
                     f"{hs[h]['p95'] * 1e3:.2f} ms"
                     for h in ("request.ttft_s", "request.tpot_s", "request.queue_wait_s")
                     if hs.get(h, {}).get("count"))


def check_telemetry(name: str, engine, n_requests: int) -> None:
    """What ``engine``'s registry and tracer recorded over one serve of
    ``n_requests``: the snapshot's schema and completions, and a
    schema-valid trace (``trace_tracks``) holding the ``admission`` track,
    ``dispatch`` or ``spec``, and ``prefill-chunk`` on a chunked engine."""
    snap = engine.metrics.snapshot()
    if snap["schema"] != "repro.telemetry.metrics/v1" \
            or snap["counters"].get("requests.completed") != n_requests:
        raise AssertionError(f"{name}: metrics snapshot {snap['schema']}, "
                             f"{snap['counters'].get('requests.completed')} completed")
    tracks = trace_tracks(engine.tracer.to_dict())
    want = {"admission", "spec" if engine.cfg.n_spec else "dispatch"}
    if engine.cfg.chunk_size:
        want.add("prefill-chunk")
    if not want <= set(tracks):
        raise AssertionError(f"{name}: trace tracks {tracks}, expected {sorted(want)}")
    log(f"{name}: telemetry: {n_requests} requests completed; {telemetry_summary(snap)}; "
        f"trace events per track {json.dumps(tracks)}")


def telemetry_twin(name: str, on: tuple, off: tuple) -> None:
    """Telemetry adds nothing to a serve: ``on`` and ``off`` (outputs,
    stats, launches, seconds of ``counted_serve``) of one workload give the
    same tokens, host syncs, dispatches, prefill calls and launches per
    route."""
    (o1, s1, l1, t1), (o0, s0, l0, t0) = on, off
    keys = ("host_syncs", "dispatches", "prefill_calls")
    diff = {k: (s1[k], s0[k]) for k in keys if s1[k] != s0[k]}
    if o1 != o0 or diff or l1 != l0:
        raise AssertionError(f"{name}: telemetry on vs off: tokens equal {o1 == o0}, stats "
                             f"(on, off) {diff}, launches {l1} vs {l0}")
    log(f"{name}: telemetry on == off: tokens, {', '.join(keys)} "
        f"({', '.join(str(s1[k]) for k in keys)}) and launches {json.dumps(l1)}; "
        f"{t1:.2f} s on, {t0:.2f} s off")


def admitted(torch, engine, requests):
    """(cache, state, gen) of ``engine`` after one admission of its first
    ``slots`` requests: the state a serve starts decoding from."""
    from repro_torch.engine.scheduler import init_slot_state
    model, cfg = engine.model, engine.cfg
    if cfg.paged:
        cache = model.init_paged_cache(cfg.slots, cfg.cache_len, block_size=cfg.block_size,
                                       num_blocks=engine._num_blocks)
    else:
        cache = model.init_cache(cfg.slots, cfg.cache_len)
    state = init_slot_state(cfg.slots, model.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    cache, state, _, _ = engine._admit(cache, state, list(range(cfg.slots)),
                                       requests[:cfg.slots], GEN, gen)
    return cache, state, gen


def dispatch_sync_sites(torch, engine, requests, drain: bool = False) -> list[str]:
    """Every synchronizing CUDA operation in one K-step dispatch of
    ``engine`` after its first admission, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them: the innermost
    frame of ``repro_torch`` that issued it (``file:line (source)``) and
    the frame the warning names.  ``drain`` runs the serve loop's whole
    dispatch (``Engine._run_dispatch``: the dispatch, its one transfer and
    the telemetry read from it) instead of the dispatch alone."""
    import traceback
    import warnings
    cache, state, gen = admitted(torch, engine, requests)
    torch.cuda.synchronize()
    sites = set()

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack if "repro_torch" in f.filename] or stack
        at = ours[-1]
        sites.add(f"{Path(at.filename).name}:{at.lineno} ({(at.line or '').strip()}) via "
                  f"{'/'.join(Path(filename).parts[-2:])}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            if drain:
                engine._run_dispatch(engine._dispatch, state, cache, gen, None,
                                     {"decode_s": 0.0, "host_syncs": 0, "dispatches": 0,
                                      "decode_steps": 0})
            else:
                engine._dispatch(engine.params, state, cache, gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sorted(sites)


def prefill_batch_bits(torch, model, qparams, requests, tiles=(0, 0)) -> str:
    """Whether a prompt's prefill depends on its admission group on the
    card: the shortest request prefilled alone and right-padded beside the
    longest, at the flash tiles ``tiles`` (0: the defaults, cut to each
    call's length), its last-token logits and its K rows compared bit for
    bit."""
    import torch.nn.functional as F
    lens = [int(r.shape[0]) for r in requests]
    a, b = requests[lens.index(min(lens))], requests[lens.index(max(lens))]
    L = a.shape[0]
    la, ca = model.prefill(qparams, {"tokens": a[None]}, tiles=tiles)
    lb, cb = model.prefill(qparams, {"tokens": torch.stack([F.pad(a, (0, b.shape[0] - L)), b])},
                           lengths=torch.tensor([L, b.shape[0]], dtype=torch.int32,
                                                device=a.device), tiles=tiles)
    ka, kb = ca["stack"]["L0"]["k"][:, 0, :L], cb["stack"]["L0"]["k"][:, 0, :L]
    return (f"the {L}-token request prefilled alone vs right-padded beside the "
            f"{b.shape[0]}-token one, flash tiles {tiles}: logits max |diff| "
            f"{(la[0].float() - lb[0].float()).abs().max().item():.4g}, same argmax "
            f"{bool(la[0].argmax() == lb[0].argmax())}, K rows differing in "
            f"{int((ka != kb).sum())} of {ka.numel()} values")


def dispatch_under_error_mode(torch, engine, requests) -> None:
    """One K-step dispatch of ``engine`` after its first admission under
    ``set_sync_debug_mode("error")``: any synchronizing operation raises."""
    cache, state, gen = admitted(torch, engine, requests)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine._dispatch(engine.params, state, cache, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def paged_phase(torch, args, model, qparams) -> dict:
    """Phase 7b: 16 requests (prompts of 16-496 tokens drawn from ``--seed``,
    64 generated tokens each) through the contiguous engine and two paged
    serves at ``cache_len`` 560, ``slots=8``, ``k_steps=8``, blocks of 16:

    * parity: the default pool (capacity parity, 8 x 35 = 280 blocks); its
      greedy tokens equal the contiguous engine's token for token;
    * pressure: 120 blocks, so admission waits on the reservation ledger and
      blocks recycle inside dispatches, with ``check_invariants=True``
      (conservation after every admission and dispatch): every request gets
      64 tokens in range, the counters read popped == released at the end,
      and it takes more prefill calls than the parity run.

    Both paged serves hold the fp8 routes' launches to the main path's
    formula.  Then one dispatch of each engine under the sync debug mode:
    the paged dispatch adds no synchronizing operation to the contiguous
    one's (``"warn"``), and each runs under ``"error"``.
    ``prefill_batch_bits`` shows what another admission group changes in a
    prefill, at the default flash tiles and at the engines' fixed ones.
    Returns the engines and requests for the phase-8 breakdown."""
    from repro_torch.engine import Engine
    cfg = model.cfg
    g = torch.Generator().manual_seed(args.seed + 3)
    lens = torch.randint(16, 497, (PAGED_REQUESTS,), generator=g).tolist()
    requests = [torch.randint(0, cfg.vocab_size, (L,), generator=g).to(model.device)
                for L in lens]
    log(f"paged phase: {PAGED_REQUESTS} requests, prompt lengths {lens}, {GEN} tokens each; "
        f"slots={SLOTS}, k_steps={K_STEPS}, cache_len={PAGED_CACHE_LEN}, blocks of {BLOCK}")
    kw = dict(slots=SLOTS, cache_len=PAGED_CACHE_LEN, k_steps=K_STEPS)
    engines = {"contiguous": Engine(model, qparams, **kw),
               "parity": telemetry_on(Engine(model, qparams, paged=True, block_size=BLOCK,
                                             **kw)),
               "pressure": telemetry_on(Engine(model, qparams, paged=True, block_size=BLOCK,
                                               num_blocks=PRESSURE_BLOCKS,
                                               check_invariants=True, **kw))}
    runs = {}
    for name, engine in engines.items():
        outputs, stats, launches, secs = counted_serve(torch, engine, requests)
        runs[name] = (outputs, stats, launches, secs)
        ctr = stats["counters"]
        pool = f", pool {engine._num_blocks} blocks" if engine.cfg.paged else ""
        log(f"paged phase, {name}{pool}: {secs:.2f} s; {stats['prefill_calls']} prefill calls, "
            f"{stats['decode_steps']} decode steps; decode {ctr['tokens']} tokens in "
            f"{stats['decode_s']:.3f} s = {ctr['tokens'] / stats['decode_s']:.1f} tok/s; "
            f"cache_bytes {stats['cache_bytes']}; counters {json.dumps(ctr)}; "
            f"launches {json.dumps(launches)}")
        for out in outputs:
            if len(out) != GEN or not all(0 <= t < cfg.vocab_size for t in out):
                raise AssertionError(f"paged phase, {name}: bad output row {out[:8]}... "
                                     f"({len(out)} tokens)")
        if engine.cfg.paged:
            want = {**fp8_serve_launches(stats, cfg.n_layers), "scale_search": 0,
                    "fp8_quant": 0}
            if any(launches[k] != n for k, n in want.items()):
                raise AssertionError(f"paged phase, {name}: launches {launches}, expected "
                                     f"{want}")
            if ctr["blocks_popped"] != ctr["blocks_released"] or ctr["blocks_popped"] <= 0:
                raise AssertionError(f"paged phase, {name}: blocks popped "
                                     f"{ctr['blocks_popped']} != released "
                                     f"{ctr['blocks_released']} at the end")
    # the parity run (telemetry on) serves the contiguous run's workload
    # (telemetry off) with the same admissions: the same tokens and counts
    telemetry_twin("paged phase, parity vs contiguous", runs["parity"], runs["contiguous"])
    contig, parity, pressure = (runs[k][0] for k in ("contiguous", "parity", "pressure"))
    same = sum(a == b for x, y in zip(pressure, parity) for a, b in zip(x, y))
    first = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
             for x, y in zip(pressure, parity)]
    log(f"paged phase: parity run == contiguous token for token: {parity == contig}; "
        f"pressure run tokens equal to the parity run's: {same} of {GEN * len(requests)} "
        f"({same / (GEN * len(requests)):.4f}); first differing token per request "
        f"(0: the prefill's) {first}; prefill calls pressure "
        f"{runs['pressure'][1]['prefill_calls']} vs parity {runs['parity'][1]['prefill_calls']}")
    if parity != contig:
        raise AssertionError("paged phase: the parity run's tokens differ from the "
                             "contiguous engine's")
    if runs["pressure"][1]["prefill_calls"] <= runs["parity"][1]["prefill_calls"]:
        raise AssertionError("paged phase: the pressure run did not wait on the pool")
    for tiles in ((0, 0), engines["parity"]._tiles):
        log(f"paged phase: {prefill_batch_bits(torch, model, qparams, requests, tiles)}")

    sites = {name: dispatch_sync_sites(torch, engines[name], requests)
             for name in ("contiguous", "parity")}
    added = sorted(set(sites["parity"]) - set(sites["contiguous"]))
    log(f"paged phase: synchronizing operations in one dispatch: contiguous "
        f"{sites['contiguous'] or 'none'}, paged {sites['parity'] or 'none'}")
    if added:
        raise AssertionError(f"paged phase: the paged dispatch synchronizes at {added}")
    # the serve loop's whole dispatch, its transfer and the telemetry read
    # from it: the tracer and registry add no synchronizing operation
    paged = engines["parity"]
    drained = {}
    for name, tel in (("off", (None, None)), ("on", (paged.metrics, paged.tracer))):
        paged.metrics, paged.tracer = tel
        drained[name] = dispatch_sync_sites(torch, paged, requests, drain=True)
    log(f"paged phase: synchronizing operations in one drained paged dispatch, telemetry off "
        f"{drained['off']}, on {drained['on']}")
    if drained["on"] != drained["off"] or len(drained["on"]) != 1:
        raise AssertionError(f"paged phase: a drained dispatch synchronizes at "
                             f"{drained['on']} with telemetry, {drained['off']} without")
    for name in ("contiguous", "parity"):
        dispatch_under_error_mode(torch, engines[name], requests)
    log('paged phase: one contiguous and one paged dispatch (tracer attached) ran under '
        'set_sync_debug_mode("error")')
    return {"engines": engines, "requests": requests}


# ---------------------------------------------------------------------------
# The prefix phase: prefix caching and chunked prefill at full width
# ---------------------------------------------------------------------------

def fp8_chunked_launches(stats: dict, n_layers: int, per_layer: int = 7) -> dict:
    """The fp8 routes' launches of a chunked serve: every dispatch step's
    decode sub-step as a decode step, and each step of a chunked dispatch
    one chunk sub-step whose ``per_layer`` products a layer see SLOTS x
    chunk rows (the wgmma route) and whose LM head sees one row a slot (the
    decode route); no one-shot prefill."""
    pieces = stats["chunk_dispatches"] * K_STEPS
    return {"fp8_matmul_wgmma": per_layer * n_layers * pieces,
            "fp8_matmul_decode": (per_layer * n_layers + 1) * stats["decode_steps"] + pieces,
            "fp8_matmul": 0}


def agreement(a: list, b: list) -> str:
    """Tokens of ``a`` equal to ``b``'s, first tokens equal, and the first
    differing step per request (None: equal throughout)."""
    same = sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))
    total = sum(len(r) for r in a)
    firsts = sum(ra[0] == rb[0] for ra, rb in zip(a, b))
    diverge = [next((i for i, (x, y) in enumerate(zip(ra, rb)) if x != y), None)
               for ra, rb in zip(a, b)]
    return (f"{same} of {total} tokens equal ({same / total:.4f}), first tokens equal in "
            f"{firsts} of {len(a)}, first differing step per request {diverge}")


def prefix_requests(torch, args, vocab: int, device) -> list:
    g = torch.Generator().manual_seed(args.seed + 5)
    system = torch.randint(0, vocab, (SYSTEM_PROMPT,), generator=g)
    sfx = torch.randint(SUFFIX_MIN, SUFFIX_MAX + 1, (PAGED_REQUESTS,), generator=g).tolist()
    requests = [torch.cat([system, torch.randint(0, vocab, (n,), generator=g)]) for n in sfx]
    # a prefix of requests 0 and 1 ending 5 tokens before the end of their
    # last full block: a full hit of the blocks before it and a partial hit
    # of that block, shared until the first decode write copies it
    requests += [r[:r.shape[0] // BLOCK * BLOCK - 5] for r in requests[:2]]
    return [r.to(device) for r in requests]


def first_chunked_dispatch_under_error_mode(torch, engine,
                                            attr: str = "_dispatch_chunk") -> list:
    """Wrap ``engine``'s chunked dispatch (its attribute ``attr``) so that
    its first call runs under ``set_sync_debug_mode("error")`` (any
    synchronizing operation raises); returns a list that holds one entry
    once that call has run."""
    real, ran = getattr(engine, attr), []

    def dispatch(*a):
        if ran:
            return real(*a)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(*a)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ran.append(True)
        return out

    setattr(engine, attr, dispatch)
    return ran


def prefix_phase(torch, args, model, qparams) -> dict:
    """Phase 7c: 18 greedy requests (``prefix_requests``: a shared 128-token
    system prompt, suffixes of 16-368 tokens drawn from ``--seed``, and two
    mid-block prefixes of earlier prompts), 64 generated tokens each,
    ``cache_len`` 560, blocks of 16, ``slots=8``, ``k_steps=8``, the default
    pool (280 blocks), through:

    * one-shot: the paged engine of phase 7b;
    * chunked: ``chunk_size=64``, ``check_invariants=True``;
    * prefix: ``prefix_cache=True, chunk_size=64, check_invariants=True``,
      served cold, then warm in the same engine.

    Asserts: conservation after every admission and dispatch
    (``check_invariants``); after each serve the counters account for the
    blocks the index holds (``held0 + popped - released == holds``); prefix
    hits counted on the device equal the host's and are > 0; the warm
    serve prefills fewer prompt tokens than the cold one; at least one
    copy-on-write; warm == cold token for token; every request's 64
    tokens in range; the fp8 launch formula of each chunked serve
    (``fp8_chunked_launches``; ``SLOTS * CHUNK >= TC_MIN_ROWS``) and of the
    one-shot serve; then one more warm serve of the first 8 requests whose
    first chunked dispatch runs under ``set_sync_debug_mode("error")``.
    The chunked and prefix engines record metrics and a trace
    (``check_telemetry`` after each serve); the chunked engine serves the
    first 8 requests with telemetry off and on (its first chunked dispatch
    under the sync debug mode), the same tokens, syncs, dispatches,
    admissions and launches (``telemetry_twin``).  Prints the
    chunked-vs-one-shot agreement (PERF.md, decision b: not asserted)."""
    from repro_torch.engine import Engine
    from repro_torch.kernels.fp8_matmul.kernel import TC_MIN_ROWS
    cfg = model.cfg
    if SLOTS * CHUNK < TC_MIN_ROWS:
        raise AssertionError("a chunk product must take the wgmma route")
    requests = prefix_requests(torch, args, cfg.vocab_size, model.device)
    log(f"prefix phase: {len(requests)} requests, prompt lengths "
        f"{[int(r.shape[0]) for r in requests]} ({SYSTEM_PROMPT}-token system prompt), "
        f"{GEN} tokens each; slots={SLOTS}, k_steps={K_STEPS}, cache_len={PAGED_CACHE_LEN}, "
        f"blocks of {BLOCK}, chunk_size={CHUNK}")
    kw = dict(slots=SLOTS, cache_len=PAGED_CACHE_LEN, k_steps=K_STEPS, paged=True,
              block_size=BLOCK)
    engines = {"one-shot": Engine(model, qparams, **kw),
               "chunked": telemetry_on(Engine(model, qparams, chunk_size=CHUNK,
                                              check_invariants=True, **kw)),
               "prefix": telemetry_on(Engine(model, qparams, chunk_size=CHUNK,
                                             prefix_cache=True, check_invariants=True, **kw))}
    runs = {}
    for name, key in (("one-shot", "one-shot"), ("chunked", "chunked"), ("prefix", "prefix"),
                      ("prefix-warm", "prefix")):
        engine = engines[key]
        held0 = len(engine._hold_blocks)
        outputs, stats, launches, secs = counted_serve(torch, engine, requests)
        runs[name] = (outputs, stats)
        ctr = stats["counters"]
        dec = ctr["tokens"]
        log(f"prefix phase, {name}: {secs:.2f} s, {len(requests) * GEN / secs:.1f} tok/s end to "
            f"end; {stats['prefill_calls']} admissions, {stats['dispatches']} dispatches "
            f"({stats.get('chunk_dispatches', 0)} chunked), {stats['prefill_tokens']} prompt "
            f"tokens prefilled, {stats.get('prefix_hits', 0)} prefix-hit tokens, "
            f"{stats.get('prefix_evictions', 0)} evictions; {dec} tokens through the dispatches "
            f"in {stats['decode_s']:.3f} s; cache_bytes {stats['cache_bytes']}; index holds "
            f"{len(engine._hold_blocks)}; counters {json.dumps(ctr)}; launches "
            f"{json.dumps(launches)}")
        for out in outputs:
            if len(out) != GEN or not all(0 <= t < cfg.vocab_size for t in out):
                raise AssertionError(f"prefix phase, {name}: bad output row {out[:8]}... "
                                     f"({len(out)} tokens)")
        want = fp8_chunked_launches(stats, cfg.n_layers) if engine.cfg.chunk_size \
            else fp8_serve_launches(stats, cfg.n_layers)
        if any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"prefix phase, {name}: launches {launches}, expected {want}")
        if held0 + ctr["blocks_popped"] - ctr["blocks_released"] != len(engine._hold_blocks):
            raise AssertionError(f"prefix phase, {name}: {held0} held before + popped "
                                 f"{ctr['blocks_popped']} - released {ctr['blocks_released']}"
                                 f" != {len(engine._hold_blocks)} held by the index")
    one, chunked = runs["one-shot"][0], runs["chunked"][0]
    (cold, cs), (warm, ws) = runs["prefix"], runs["prefix-warm"]
    log(f"prefix phase: chunked vs one-shot: {agreement(chunked, one)}")
    log(f"prefix phase: prefix cold vs chunked: {agreement(cold, chunked)}")
    log(f"prefix phase: warm vs cold: {agreement(warm, cold)}")
    for name, st in (("cold", cs), ("warm", ws)):
        if not st["counters"]["prefix_hit_tokens"] == st["prefix_hits"] > 0:
            raise AssertionError(f"prefix phase, {name}: prefix-hit tokens "
                                 f"{st['counters']['prefix_hit_tokens']} on the device, "
                                 f"{st['prefix_hits']} on the host")
    if not ws["prefill_tokens"] < cs["prefill_tokens"]:
        raise AssertionError("prefix phase: the warm serve prefilled no fewer prompt tokens")
    if ws["counters"]["cow_copies"] < 1:
        raise AssertionError("prefix phase: no copy-on-write in the warm serve")
    if warm != cold:
        raise AssertionError("prefix phase: the warm serve's tokens differ from the cold one's")
    ran = first_chunked_dispatch_under_error_mode(torch, engines["prefix"])
    engines["prefix"].serve(requests[:SLOTS], gen_tokens=GEN)
    if not ran:
        raise AssertionError("prefix phase: no chunked dispatch ran under the sync debug mode")
    log('prefix phase: one chunked, prefix-cached dispatch (tracer attached) ran under '
        'set_sync_debug_mode("error")')
    # the chunked engine starts every serve from an empty cache: its first 8
    # requests served with telemetry off, then on (the first chunked
    # dispatch of that serve under the sync debug mode) are one workload
    chunked = engines["chunked"]
    chunked.metrics = chunked.tracer = None
    off = counted_serve(torch, chunked, requests[:SLOTS])
    ran = first_chunked_dispatch_under_error_mode(torch, telemetry_on(chunked))
    on = counted_serve(torch, chunked, requests[:SLOTS])
    if not ran:
        raise AssertionError("prefix phase: no chunked dispatch ran under the sync debug mode")
    telemetry_twin("prefix phase, chunked, first 8 requests", on, off)
    return {"requests": requests}


# ---------------------------------------------------------------------------
# The speculative phase: a DAQ-fp8 draft and the bf16 verifier at full width
# ---------------------------------------------------------------------------

def fp8_spec_launches(stats: dict, n_layers: int, per_layer: int = 7) -> dict:
    """The fp8 routes' launches of a speculative serve with a bf16 verifier:
    each round's N_SPEC draft steps run the quantized tree at one row a slot
    (the decode route: ``per_layer`` products a layer and the LM head); the
    verify (both passes of a two-pass round), the prefills and the chunk
    pieces are bf16 products."""
    return {"fp8_matmul_wgmma": 0,
            "fp8_matmul_decode": (per_layer * n_layers + 1) * N_SPEC * K_STEPS
            * stats["dispatches"],
            "fp8_matmul": 0}


def spec_dispatch_under_error_mode(torch, engine, requests) -> None:
    """One K-round speculative dispatch of ``engine`` after its first
    admission under ``set_sync_debug_mode("error")``."""
    cache, state, gen = admitted(torch, engine, requests)
    depth = torch.full((), N_SPEC, dtype=torch.int32, device=engine.model.device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine._dispatch_spec(engine.params, engine.draft_params, state, cache, depth, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def verify_decode_bits(torch, engine, requests, outputs) -> str:
    """What decides decision (b) of PERF.md on the card: at ``engine``'s
    first admission (8 slots at 128 tokens) the bf16 tree's verify of the
    next 5 greedy tokens of ``outputs`` against 5 decode steps on them
    (logits bit for bit, per row: values differing, max |diff|, argmax
    equal), and each bf16 product of layer 0 and the LM head at 40 rows
    against its first 8 rows alone."""
    model, C = engine.model, N_SPEC + 1
    cache, state, _ = admitted(torch, engine, requests)
    toks = torch.tensor([o[:C] for o in outputs], dtype=torch.int32, device=model.device)
    vlog, _ = model.verify_chunk_paged(engine.params, toks, clone_tree(cache),
                                       cache["lengths"], torch.full_like(cache["lengths"], C))
    rows = []
    for j in range(C):
        dlog, cache = model.decode_step_paged(engine.params, toks[:, j:j + 1], cache)
        v = vlog[:, j]
        rows.append(f"row {j}: {int((v != dlog).sum())} of {v.numel()} differ, max |diff| "
                    f"{(v.float() - dlog.float()).abs().max().item():.4g}, argmax equal in "
                    f"{int((v.argmax(-1) == dlog.argmax(-1)).sum())} of {v.shape[0]}")
    stack, g = engine.params["stack"]["L0"], torch.Generator(model.device).manual_seed(0)
    weights = {name: stack[part][name][0] for part, names in (
        ("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("w_gate", "w_up", "w_down")))
        for name in names}
    weights["w_head"] = engine.params["embed"]["w_head"]
    products = []
    for name, w in weights.items():
        x = torch.randn((SLOTS * C, w.shape[0]), generator=g, device=model.device).to(w.dtype)
        big, small = torch.matmul(x, w)[:SLOTS], torch.matmul(x[:SLOTS].contiguous(), w)
        products.append(f"{name} {int((big != small).sum())} of {small.numel()}")
    return (f"bf16 verify vs decode steps: {'; '.join(rows)}; layer 0's products and the LM "
            f"head, rows of x[{SLOTS * C}] @ w vs x[{SLOTS}] @ w, values differing: "
            f"{', '.join(products)}")


def first_layers(model, n: int, *trees):
    """A model of ``model``'s first ``n`` layers and ``trees`` cut to them:
    each stacked leaf (under ``stack``) viewed at its first ``n`` layers,
    no copy."""
    from repro_torch.models import build_model
    from repro_torch.quant_runtime.qparams import QuantizedTensor

    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        if isinstance(t, QuantizedTensor):
            return dataclasses.replace(t, data=t.data[:n], scale=t.scale[:n],
                                       eq_scale=None if t.eq_scale is None else t.eq_scale[:n])
        return t[:n]

    cfg = dataclasses.replace(model.cfg, n_layers=n)
    return (build_model(cfg, device=model.device),
            *({**t, "stack": cut(t["stack"])} for t in trees))


def spec_phase(torch, args, model, post, qparams, prompts) -> dict:
    """Phase 7d: self-speculative decoding, the bf16 tree ``post`` (phase 5's
    input) verifying, ``slots=8``, blocks of 16, ``k_steps=8``,
    ``n_spec=4``:

    * (i) phase 6's 8 requests (128 prompt + 64 generated tokens) through
      the paged engine with ``post``, no speculation: the baseline;
    * (ii) the same with speculation, phase 5's DAQ-fp8 tree drafting,
      ``check_invariants=True``;
    * (iii) as (ii) with the depth pinned (``spec_dynamic=False``);
    * (iv) as (ii) with an AbsMax draft (``method="absmax"``, no base);
    * (v) phase 7c's 18 requests with ``chunk_size=64, prefix_cache=True``,
      the DAQ draft, served cold then warm.

    Asserts conservation after every admission and dispatch, ``drafted ==
    accepted + rejected`` and the fp8 launch formula of each speculative
    serve (``fp8_spec_launches``), every request's tokens in range and its
    first token equal to the baseline's (the same bf16 prefill), (ii),
    (iii) and (iv) equal token for token (the verifier alone decides a
    token's value, whatever the draft and the depth), a copy-on-write in
    (v), warm == cold; then one speculative dispatch and one composed
    dispatch under ``set_sync_debug_mode("error")``.  The speculative
    engines record metrics and a trace (``check_telemetry`` after each
    serve); (ii) is served again with telemetry off: the same tokens,
    syncs, dispatches, admissions and launches (``telemetry_twin``).  Prints each serve's
    time, tok/s, tokens per round and acceptance rate, each speculative
    serve's agreement with the baseline and ``verify_decode_bits`` (PERF.md,
    decision b: on the card the verify's rows are not the decode steps'
    bits).  Returns the DAQ engine and requests for phase 8."""
    from repro_torch.configs import QuantConfig
    from repro_torch.engine import Engine
    from repro_torch.quantize import quantize
    cfg = model.cfg
    requests = list(prompts)
    kw = dict(slots=SLOTS, cache_len=PROMPT + GEN, k_steps=K_STEPS, paged=True,
              block_size=BLOCK)
    t0 = time.perf_counter()
    absmax, _ = quantize(post, None, QuantConfig(), mode="storage", method="absmax")
    torch.cuda.synchronize()
    log(f"spec phase: AbsMax draft quantized in {time.perf_counter() - t0:.2f} s; "
        f"{len(requests)} requests x {GEN} tokens, slots={SLOTS}, k_steps={K_STEPS}, "
        f"n_spec={N_SPEC}, cache_len={PROMPT + GEN}, blocks of {BLOCK}")
    spec_kw = dict(n_spec=N_SPEC, check_invariants=True, **kw)

    def check(name, engine, reqs, base=None):
        held0 = len(engine._hold_blocks)
        outputs, stats, launches, secs = counted_serve(torch, engine, reqs)
        ctr = stats["counters"]
        line = (f"spec phase, {name}: {secs:.2f} s, {len(reqs) * GEN / secs:.1f} tok/s end to "
                f"end; {stats['prefill_calls']} admissions, {stats['dispatches']} dispatches, "
                f"{ctr['tokens']} tokens through them in {stats['decode_s']:.3f} s "
                f"({ctr['tokens'] / stats['decode_s']:.1f} tok/s), "
                f"{ctr['tokens'] / stats['decode_steps']:.3f} per step of {SLOTS} slots")
        if engine.cfg.n_spec:
            line += (f"; acceptance {stats['draft_accepted']} of {stats['draft_tokens']} drafted "
                     f"({stats['draft_accepted'] / max(stats['draft_tokens'], 1):.4f}), final "
                     f"depth {stats['spec_depth']}, blocked retries {ctr['blocked_retries']}")
        log(f"{line}; counters {json.dumps(ctr)}; launches {json.dumps(launches)}")
        for out in outputs:
            if len(out) != GEN or not all(0 <= t < cfg.vocab_size for t in out):
                raise AssertionError(f"spec phase, {name}: bad output row {out[:8]}... "
                                     f"({len(out)} tokens)")
        if held0 + ctr["blocks_popped"] - ctr["blocks_released"] != len(engine._hold_blocks):
            raise AssertionError(f"spec phase, {name}: {held0} held before + popped "
                                 f"{ctr['blocks_popped']} - released {ctr['blocks_released']} "
                                 f"!= {len(engine._hold_blocks)} held by the index")
        if engine.cfg.n_spec and (ctr["drafted"] != ctr["accepted"] + ctr["rejected"]
                                  or ctr["drafted"] <= 0):
            raise AssertionError(f"spec phase, {name}: drafted {ctr['drafted']} != "
                                 f"accepted {ctr['accepted']} + rejected {ctr['rejected']}")
        # the bf16 tree takes no fp8 kernel; the draft's steps the decode route
        want = dict.fromkeys(launches, 0)
        if engine.cfg.n_spec:
            want.update(fp8_spec_launches(stats, cfg.n_layers))
        if launches != want:
            raise AssertionError(f"spec phase, {name}: launches {launches}, expected {want}")
        if base is not None:
            log(f"spec phase, {name} vs (i): {agreement(outputs, base)}")
            if [o[0] for o in outputs] != [o[0] for o in base]:
                raise AssertionError(f"spec phase, {name}: first tokens differ from the "
                                     f"baseline's")
        return outputs, stats, launches, secs

    plain = Engine(model, post, **kw)
    base = check("(i) bf16, no speculation", plain, requests)[0]
    log(f"spec phase: {verify_decode_bits(torch, plain, requests, base)}")
    daq = telemetry_on(Engine(model, post, draft_params=qparams, **spec_kw))
    runs = [check(name, telemetry_on(engine), requests, base) for name, engine in (
        ("(ii) DAQ draft", daq),
        ("(iii) DAQ draft, depth pinned",
         Engine(model, post, draft_params=qparams, spec_dynamic=False, **spec_kw)),
        ("(iv) AbsMax draft", Engine(model, post, draft_params=absmax, **spec_kw)))]
    if any(r[0] != runs[0][0] for r in runs):
        raise AssertionError("spec phase: the speculative serves' tokens depend on the draft")
    log("spec phase: (ii), (iii) and (iv) equal token for token")
    # (ii)'s engine starts every serve from an empty cache: served again
    # with telemetry off, it must give (ii)'s tokens, syncs and launches
    daq.metrics = daq.tracer = None
    telemetry_twin("spec phase, (ii)", runs[0],
                   check("(ii) DAQ draft, telemetry off", daq, requests, base))
    del plain, absmax, runs
    torch.cuda.empty_cache()
    spec_dispatch_under_error_mode(torch, telemetry_on(daq), requests)
    log('spec phase: one speculative dispatch (tracer attached) ran under '
        'set_sync_debug_mode("error")')

    preqs = prefix_requests(torch, args, cfg.vocab_size, model.device)
    composed = telemetry_on(Engine(model, post, draft_params=qparams, n_spec=N_SPEC,
                                   chunk_size=CHUNK, prefix_cache=True, check_invariants=True,
                                   **{**kw, "cache_len": PAGED_CACHE_LEN}))
    log(f"spec phase, (v): {len(preqs)} requests of phase 7c, cache_len {PAGED_CACHE_LEN}, "
        f"chunk_size {CHUNK}, prefix cache")
    cold, cs = check("(v) composed, cold", composed, preqs)[:2]
    warm, ws = check("(v) composed, warm", composed, preqs)[:2]
    log(f"spec phase: (v) warm vs cold: {agreement(warm, cold)}; prompt tokens prefilled "
        f"{cs['prefill_tokens']} cold, {ws['prefill_tokens']} warm")
    if cs["counters"]["cow_copies"] < 1 or ws["counters"]["cow_copies"] < 1:
        raise AssertionError("spec phase, (v): no copy-on-write of a speculative span")
    if warm != cold:
        raise AssertionError("spec phase, (v): the warm serve's tokens differ from the cold "
                             "one's")
    ran = first_chunked_dispatch_under_error_mode(torch, composed, "_dispatch_spec_chunk")
    composed.serve(preqs[:SLOTS], gen_tokens=GEN)
    if not ran:
        raise AssertionError("spec phase: no composed dispatch ran under the sync debug mode")
    log('spec phase: one composed (chunked, prefix-cached) speculative dispatch (tracer '
        'attached) ran under set_sync_debug_mode("error")')
    del composed
    torch.cuda.empty_cache()
    return {"engine": daq, "requests": requests}


# ---------------------------------------------------------------------------
# Phase 7f: the host-loop baseline beside the engine
# ---------------------------------------------------------------------------

def host_loop_phase(torch, model, qparams, prompts, daq_outputs) -> None:
    """Phase 7f: phase 6's 8 requests (128 prompt tokens), HOST_LOOP_GEN
    greedy tokens each, through ``serve_host_loop`` (a batch-1 prefill per
    request, one host sync per slot-token) and through the contiguous
    ``Engine`` (``slots=8``, ``k_steps=8``), phase 5's DAQ tree at full
    width: each run's time, tok/s, host syncs per token and launches per
    route.  Asserts rows of HOST_LOOP_GEN tokens in range and the fp8
    routes' launches (``fp8_serve_launches``: the host loop's 128-row
    prefills on the wgmma route, its decode rows and LM heads on the decode
    route); prints the agreement of the two runs and with phase 6's first
    tokens (a reading: on the card a batch-1 prefill's bits differ from a
    grouped one's, ROADMAP Queue C 15)."""
    from repro_torch.engine import Engine, serve_host_loop
    from repro_torch.kernels._lib import KERNELS
    cfg, requests, gen = model.cfg, list(prompts), HOST_LOOP_GEN
    runs = {}
    for name in ("host loop", "engine"):
        for k in KERNELS:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "host loop":
            outputs, stats = serve_host_loop(model, qparams, requests, batch=SLOTS,
                                             gen_tokens=gen, cache_len=PROMPT + gen,
                                             return_stats=True)
        else:
            outputs, stats = Engine(model, qparams, slots=SLOTS, cache_len=PROMPT + gen,
                                    k_steps=K_STEPS).serve(requests, gen_tokens=gen,
                                                           return_stats=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k.name: k.launches for k in KERNELS}
        runs[name] = outputs
        n_tok = sum(len(o) for o in outputs)
        log(f"host-loop phase, {name}: {len(outputs)} requests x {gen} tokens in {secs:.3f} s "
            f"({n_tok / secs:.1f} tok/s end to end); {stats['host_syncs']} host syncs "
            f"({stats['host_syncs'] / n_tok:.3f} per token), {stats['prefill_calls']} prefill "
            f"calls, {stats['decode_steps']} decode steps, {stats['dispatches']} dispatches; "
            f"launches {json.dumps(launches)}")
        for out in outputs:
            if len(out) != gen or not all(0 <= t < cfg.vocab_size for t in out):
                raise AssertionError(f"host-loop phase, {name}: bad output row {out[:8]}... "
                                     f"({len(out)} tokens)")
        want = {**fp8_serve_launches(stats, cfg.n_layers), "scale_search": 0, "fp8_quant": 0}
        if launches != want:
            raise AssertionError(f"host-loop phase, {name}: launches {launches}, expected "
                                 f"{want}")
    log(f"host-loop phase: host loop vs engine: {agreement(runs['host loop'], runs['engine'])}")
    log(f"host-loop phase: host loop vs phase 6's first {gen} tokens: "
        f"{agreement(runs['host loop'], [o[:gen] for o in daq_outputs])}")


# ---------------------------------------------------------------------------
# Phase 7g: the serve CLI at full width
# ---------------------------------------------------------------------------

def cli_phase(torch) -> None:
    """Phase 7g: ``python -m repro_torch.launch.serve``'s ``main`` called in
    this process at full width (GLM-4-9B, 40 layers, no ``--reduced``), 8
    requests of 129 prompt tokens (the CLI's ``--prompt-len 128`` draws
    ``prompt_len + 1``, as the reference's does), 16 generated, 8 slots:

    * ``--daq --paged --prefix-cache``: a channel-granularity DAQ tree
      served paged, chunked (32-token pieces) and prefix-cached;
    * ``--paged --spec-draft daq --n-spec 4``: the bf16 weights verifying a
      channel-granularity DAQ draft.

    Both with ``--metrics-out`` and ``--trace-out`` into a temporary
    directory.  For each: the snapshot's schema and ``requests.completed
    == 8``; a schema-valid trace with the ``admission`` track, ``dispatch``
    or ``spec`` and, for the chunked run, ``prefill-chunk``; no kernel
    launched (channel trees take the dequantize path: ROADMAP Queue C 2,
    B 9); quantize seconds (``repro_torch.quantize.quantize`` timed around
    its call), peak GB, tok/s (the CLI's summary line) and TTFT / TPOT p50
    and p95 (the snapshot)."""
    import contextlib
    import io
    import tempfile
    import repro_torch.quantize as Q
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.launch import serve as cli
    traffic = ["--arch", "glm4-9b", "--requests", str(SLOTS), "--batch", str(SLOTS),
               "--prompt-len", str(PROMPT), "--gen", str(HOST_LOOP_GEN)]
    real_quantize, quant_s = Q.quantize, []

    def timed_quantize(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_quantize(*a, **kw)
        torch.cuda.synchronize()
        quant_s.append(time.perf_counter() - t0)
        return out

    Q.quantize = timed_quantize
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, extra in (("daq", ["--daq", "--paged", "--prefix-cache"]),
                                ("spec", ["--paged", "--spec-draft", "daq", "--n-spec",
                                          str(N_SPEC)])):
                metrics, trace = f"{tmp}/{name}-metrics.json", f"{tmp}/{name}-trace.json"
                argv = traffic + extra + ["--metrics-out", metrics, "--trace-out", trace]
                log(f"cli phase, {name}: python -m repro_torch.launch.serve {' '.join(argv)}")
                quant_s.clear()
                for k in KERNELS:
                    k.launches = 0
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                out = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    outputs, stats = cli.main(argv)
                secs = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() / 1e9
                text = out.getvalue()
                log(text.rstrip())
                launches = {k.name: k.launches for k in KERNELS}
                snap = json.loads(Path(metrics).read_text())
                if snap["schema"] != "repro.telemetry.metrics/v1" \
                        or snap["counters"].get("requests.completed") != SLOTS:
                    raise AssertionError(f"cli phase, {name}: snapshot {snap['schema']}, "
                                         f"{snap['counters'].get('requests.completed')} "
                                         f"completed")
                tracks = trace_tracks(json.loads(Path(trace).read_text()))
                want = {"admission", "spec" if name == "spec" else "dispatch"}
                if name == "daq":
                    want.add("prefill-chunk")
                if not want <= set(tracks):
                    raise AssertionError(f"cli phase, {name}: trace tracks {tracks}, "
                                         f"expected {sorted(want)}")
                if any(launches.values()):
                    raise AssertionError(f"cli phase, {name}: a channel tree launched "
                                         f"{launches}")
                for o in outputs:
                    if len(o) != HOST_LOOP_GEN:
                        raise AssertionError(f"cli phase, {name}: a row of {len(o)} tokens")
                served = re.search(r"\(([\d.]+) tok/s", text)
                log(f"cli phase, {name}: quantize {' + '.join(f'{q:.2f}' for q in quant_s)} s, "
                    f"peak {peak:.2f} GB, {served.group(1)} tok/s (the CLI's line), "
                    f"{telemetry_summary(snap)}; the call {secs:.1f} s; trace events per "
                    f"track {json.dumps(tracks)}; launches {json.dumps(launches)}")
    finally:
        Q.quantize = real_quantize


# ---------------------------------------------------------------------------
# Phase 7h: train -> quantize -> serve at full width; phase 7i: the study
# ---------------------------------------------------------------------------

def routing_tape(torch, tape: list, agree: list | None = None):
    """Wrap ``repro_torch.models.moe.top_k_routing``.  With ``agree`` None,
    each call appends its fp32 router logits (on the CPU) to ``tape``;
    else each call routes on the taped logits of the same call, plus ``l -
    l.detach()`` (the taped values bit for bit, the gradient through this
    run's own logits), and appends to ``agree`` the share of tokens (a
    device tensor) whose experts this run's own logits choose the same.
    Returns the function that restores the original."""
    from repro_torch.models import moe
    fn, calls = moe.top_k_routing, iter(tape)

    def wrapped(logits, top_k, capacity):
        if agree is None:
            tape.append(logits.detach().float().cpu())
            return fn(logits, top_k, capacity)
        own = fn(logits.detach(), top_k, capacity)[0]
        out = fn(next(calls).to(logits.device) + (logits - logits.detach()), top_k, capacity)
        agree.append((own.amax(-1) == out[0].amax(-1)).all(-1).float().mean())
        return out

    moe.top_k_routing = wrapped
    return lambda: setattr(moe, "top_k_routing", fn)


def train_agreement(torch, seed: int, cfg=None, label: str = "train agreement") -> None:
    """A 2-layer float32 model (by default GLM-shaped, width 256; else
    ``cfg``) takes ``TRAIN_CHECK_STEPS`` AdamW steps on the card and on the
    CPU from one init on the same batches (``train_batch`` draws on the
    host).  Its parameters are float32 but its activations bf16
    (``models/common.py::ACT_DTYPE``), so the two differ by bf16 rounding of
    each product, as the CPU tests' port-vs-reference steps do: each step's
    loss within 1e-3 relative, the whole tree's update and each weight
    matrix's within 0.99 cosine of the CPU's (biases and norm scales count
    in the whole only: AdamW normalizes their small, noisy gradients into
    full-size steps).

    An MoE model's bf16 noise flips a few top-k choices between the devices
    (a flip sends a token's gradient to another expert), so the card routes
    on the CPU's router logits of each call (``routing_tape``; the share of
    tokens its own logits route the same is printed), as the CPU tests
    replay the reference's; and on the card, with its own routing, remat
    ``full`` must give the loss bits and every gradient bit of remat
    ``none`` (the recomputed router and ``argmax`` are the forward's)."""
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.core.policy import tree_leaves_with_path, tree_map
    from repro_torch.data import LanguageSpec, train_batch
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import build_model
    cfg = cfg or dataclasses.replace(get_arch("glm4-9b"), n_layers=2, d_model=256, n_heads=2,
                                     n_kv_heads=1, head_dim=128, d_ff=512, vocab_size=1024,
                                     dtype="float32")
    moe = cfg.family == "moe"
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=TRAIN_CHECK_STEPS)
    spec = LanguageSpec(vocab=cfg.vocab_size)
    losses, states, tape, agree = {}, {}, [], []
    init = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(seed + 3))
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        state = init_train_state(model, tc, None,
                                 tree_map(lambda t: t.to(model.device, copy=True), init))
        step = make_train_step(model, tc)
        restore = routing_tape(torch, tape, None if dev == "cpu" else agree) if moe \
            else (lambda: None)
        losses[dev] = []
        try:
            for t in range(TRAIN_CHECK_STEPS):
                state, m = step(state, train_batch(spec, 0, t, 4, 64, device=model.device))
                losses[dev].append(float(m["loss"]))
        finally:
            restore()
        states[dev] = tree_map(lambda t: t.cpu(), state["params"])
    worst_loss = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    cosine = lambda a, b: float(a @ b / a.norm() / b.norm())
    cosines, whole = {}, ([], [])
    for (path, c), (_, g), (_, p0) in zip(tree_leaves_with_path(states["cpu"]),
                                          tree_leaves_with_path(states["cuda"]),
                                          tree_leaves_with_path(init)):
        dc, dg = (c - p0).double().flatten(), (g - p0).double().flatten()
        whole[0].append(dc)
        whole[1].append(dg)
        if path[-1].startswith("w") or path[-1] in ("embed", "router"):
            cosines["/".join(path)] = cosine(dc, dg)
    worst = min(cosines, key=cosines.get)
    total = cosine(torch.cat(whole[0]), torch.cat(whole[1]))
    shape = (f"{cfg.n_layers} layers of {cfg.n_experts} experts top-{cfg.top_k}, window "
             f"{cfg.sliding_window}, " if moe else f"{cfg.n_layers} layers, ")
    routed = (f"; the card routed on the CPU's logits ({len(tape)} routing calls; its own "
              f"would route {min(float(a) for a in agree):.4f} of a call's tokens the same at "
              f"the least)" if moe else "")
    log(f"{label} ({shape}width {cfg.d_model}, float32 parameters, {TRAIN_CHECK_STEPS} "
        f"steps, card vs CPU): losses {[round(x, 6) for x in losses['cuda']]} vs "
        f"{[round(x, 6) for x in losses['cpu']]} (worst {worst_loss:.3g} relative, "
        f"tolerance 1e-3); update cosine {total:.6f} over the tree (tolerance 0.99), "
        f"least of a weight matrix {cosines[worst]:.6f} ({worst}; tolerance 0.99){routed}")
    if not worst_loss <= 1e-3 or not total >= 0.99 or not cosines[worst] >= 0.99:
        raise AssertionError(f"{label}: the card's and the CPU's training differ")
    if moe:
        remat_bits(torch, cfg, init, train_batch(spec, 0, 0, 4, 64, device=model.device), label)


def remat_bits(torch, cfg, init, batch, label: str) -> None:
    """On the card, the loss and every gradient of ``cfg``'s model from
    ``init`` under remat ``full`` bit-equal to remat ``none``, each routing
    on its own logits; a mismatch counts the tokens routed otherwise (the
    two forwards', and ``full``'s backward recompute against its forward)."""
    from repro_torch.core.policy import tree_leaves_with_path
    from repro_torch.launch.steps import _unflatten
    from repro_torch.models import build_model
    model = build_model(cfg, device="cuda")
    out = {}
    for remat in ("none", "full"):
        leaves = [p.detach().to(model.device, copy=True).requires_grad_(True)
                  for _, p in tree_leaves_with_path(init)]
        routes: list = []
        restore = routing_recorder(torch, routes, keep=True)
        try:
            loss, _ = model.loss_fn(_unflatten(init, leaves), batch, remat=remat)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            restore()
        out[remat] = (loss.detach(), grads, [d for d, _ in routes])
    (l0, g0, r0), (l1, g1, r1) = out["none"], out["full"]
    equal = bool(torch.equal(l0, l1)) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    n = len(r0)
    pairs = list(zip(r0, r1[:n])) + list(zip(r1[:n], r1[n:][::-1]))
    moved = sum(int((a.amax(-1) != b.amax(-1)).any(-1).sum()) for a, b in pairs)
    log(f"{label}, remat on the card: loss {float(l0):.9g} (none) vs {float(l1):.9g} (full); "
        f"{len(g0)} gradients {'bit-equal' if equal else 'differ'}; {n} / {len(r1)} routing "
        f"calls (full recomputes each in the backward), {moved} tokens routed otherwise")
    if not equal or moved or len(r1) != 2 * n:
        raise AssertionError(f"{label}: remat full differs from none on the card ({moved} "
                             f"routing decisions moved)")


def sft(torch, model, tc, state, spec, label: str):
    """``TRAIN_STEPS`` AdamW steps of ``state`` on ``"mixed"`` batches of
    ``TRAIN_BATCH`` tokens of ``spec`` (``train_batch``), one step (step 3)
    under ``torch.cuda.set_sync_debug_mode("error")``: no host sync inside
    a step.  Prints each step's loss (and, for an MoE model, its auxiliary
    loss), train tokens/s, peak GB, one step's host and device-busy ms,
    idle share and launches (``device_breakdown`` over the last three
    steps) and the optimizer update's share (CUDA events around
    ``adamw_update``); asserts finite losses, the last below the first.
    Returns ``(state, metrics)``, ``metrics`` each step's as floats."""
    import repro_torch.launch.steps as steps_mod
    from repro_torch.data import train_batch

    step_fn = steps_mod.make_train_step(model, tc)
    B, S = TRAIN_BATCH
    metrics, update_ms, step_ms = [], [], []
    real_update = steps_mod.adamw_update

    def timed_update(*a):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_update(*a)
        ev[1].record()
        update_ms.append(ev)
        return out

    def one_step(t, sync_error=False):
        nonlocal state
        batch = train_batch(spec, tc.seed, t, B, S, style="mixed", device=model.device)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        if sync_error:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, m = step_fn(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ev[1].record()
        step_ms.append(ev)
        metrics.append(m)

    steps_mod.adamw_update = timed_update
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(TRAIN_STEPS - 3):
            one_step(t, sync_error=(t == 2))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        it = iter(range(TRAIN_STEPS - 3, TRAIN_STEPS))

        def run():
            one_step(next(it))
            torch.cuda.synchronize()

        br = device_breakdown(torch, f"{label} step ({B} x {S} tokens, {model.cfg.n_layers} "
                              f"layers)", run, 1, "step", top=10)
    finally:
        steps_mod.adamw_update = real_update
    peak = torch.cuda.max_memory_allocated() / 1e9
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    losses = [m["loss"] for m in metrics]
    upd = [a.elapsed_time(b) for a, b in update_ms]
    whole = [a.elapsed_time(b) for a, b in step_ms]
    share = sum(upd[1:]) / sum(whole[1:])
    aux = (f"; aux losses {[round(m['aux_loss'], 7) for m in metrics]}"
           if model.cfg.family == "moe" else "")
    log(f"{label}: losses {[round(x, 4) for x in losses]}{aux}; steps 1-{TRAIN_STEPS - 3} in "
        f"{first_s:.2f} s ({(TRAIN_STEPS - 3) * B * S / first_s:.0f} tok/s, the first step's "
        f"warm-up included); a step {br['host_ms']:.1f} ms on the host clock = "
        f"{B * S / br['host_ms'] * 1e3:.0f} train tok/s; event-timed steps "
        f"{[round(x, 1) for x in whole]} ms, of which adamw_update "
        f"{[round(x, 1) for x in upd]} ms ({share:.3f} of steps 2-{TRAIN_STEPS}); peak "
        f"{peak:.2f} GB; step 3 ran under set_sync_debug_mode('error')")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses}")
    return state, metrics


def train_phase(torch, seed: int, prompts) -> None:
    """Phase 7h: GLM-4-9B at full width cut to ``TRAIN_LAYERS`` layers (its
    training state at 40 layers, about 150 GB, does not fit one card):
    bf16 weights from a seeded generator (the base), SFT'd for
    ``TRAIN_STEPS`` AdamW steps (fp32 master and moments, remat ``full``;
    ``sft``) on ``"mixed"`` batches of 4 x 512 tokens of a 4,096-token
    language (``train_batch``); then the optimizer state is freed, the
    SFT'd tree is DAQ-quantized against the base
    (``QuantConfig(use_fused_kernel=True)``, storage mode: the sweep and
    the quantizer launch) and served phase 6's 8 requests through the
    engine.  Kernel counts are zeroed just before the quantize and read
    after the serve.

    Prints what ``sft`` prints, then quantize seconds, the real SFT delta's
    global sign rate and cosine, serve tok/s, and the launch formulas of
    the quantize and the serve at ``TRAIN_LAYERS`` layers.  Ends with
    ``train_agreement``."""
    import repro_torch.launch.steps as steps_mod
    from repro_torch.configs import QuantConfig, TrainConfig, get_arch
    from repro_torch.engine import Engine
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.kernels.scale_search.kernel import sweep_plan
    from repro_torch.launch.train import default_language
    from repro_torch.models import build_model
    from repro_torch.quantize import quantize

    cfg = dataclasses.replace(get_arch("glm4-9b"), n_layers=TRAIN_LAYERS)
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS,
                     remat="full")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=model.device).manual_seed(seed + 5))
    base = clone_tree(params)
    state = steps_mod.init_train_state(model, tc, None, params)
    spec = default_language(cfg, tc.seed + 100)
    B, S = TRAIN_BATCH
    log(f"train phase: {cfg.name} {cfg.n_layers} layers at full width "
        f"({cfg.param_count() / 1e9:.3f} B params), {TRAIN_STEPS} steps of {B} x {S} tokens "
        f"(mixed corpus, LanguageSpec(vocab={spec.vocab})), remat full, AdamW fp32 master "
        f"and moments; state {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    state, _ = sft(torch, model, tc, state, spec, "train phase")

    post = state["params"]
    del state
    torch.cuda.empty_cache()
    for k in KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams, report = quantize(post, base, QuantConfig(use_fused_kernel=True), mode="storage")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    quant_peak = torch.cuda.max_memory_allocated() / 1e9
    del post, base
    torch.cuda.empty_cache()
    engine = Engine(model, qparams, slots=SLOTS, cache_len=PROMPT + GEN, k_steps=K_STEPS)
    t0 = time.perf_counter()
    outputs, stats = engine.serve(list(prompts), gen_tokens=GEN, return_stats=True)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    g = report.global_chosen
    log(f"train phase, quantize of the SFT'd tree: {quant_s:.2f} s, peak {quant_peak:.2f} GB, "
        f"{report.n_quantized} tensors; the real SFT delta: global sign rate "
        f"{g['sign_rate']:.6f} (AbsMax {report.global_default['sign_rate']:.6f}), cosine "
        f"{g['cosine']:.6f} (AbsMax {report.global_default['cosine']:.6f}), delta L2 "
        f"{g['delta_l2']:.4f}")
    log(f"train phase, serve: {len(outputs)} requests x {GEN} tokens in {serve_s:.2f} s "
        f"({SLOTS * GEN / serve_s:.1f} tok/s end to end); launches {json.dumps(launches)}")
    n = leaf_layers(report)
    qcfg = QuantConfig()
    passes = len(sweep_plan(1 + qcfg.n_coarse)) + len(sweep_plan(1 + qcfg.n_fine))
    want = {"scale_search": passes * n, "fp8_quant": n,
            **fp8_serve_launches(stats, cfg.n_layers)}
    if launches != want:
        raise AssertionError(f"train phase: launches {launches}, expected {want}")
    for out in outputs:
        if len(out) != GEN or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"train phase: bad output row {out[:8]}...")
    if not all(math.isfinite(v) for v in g.values()):
        raise AssertionError(f"train phase: non-finite report metrics {g}")
    leaf_sign_rates_hold(report, "DAQ of the SFT'd tree")
    del qparams, engine
    torch.cuda.empty_cache()
    train_agreement(torch, seed)


def moe_train_phase(torch, records: dict, seed: int) -> None:
    """Phase 7n: Mixtral 8x22B at full width cut to ``MOE_TRAIN_LAYERS``
    layer (its training state at 2 layers, ~90 GB, does not fit one card),
    through the port's entry points: bf16 weights from a seeded generator
    (the base, kept on the host during the SFT), SFT'd by ``sft`` (the
    router's auxiliary loss in every step's loss, the backward through
    routing), the optimizer state freed,
    the SFT'd tree DAQ-quantized against the base
    (``QuantConfig(use_fused_kernel=True)``, storage: the sweep and the
    quantizer launch) and quantized by SmoothQuant and AWQ calibrated on the
    card (``model=`` / ``spec=``: the training language; the expert stacks
    record nothing and equalize at unit scales, as the reference's), the
    five trees scored (``eval_scores``: 16 x 128 prompts of each corpus, a
    whole-sequence forward each), and the DAQ tree serving 8 requests of
    ``PROMPT`` tokens x ``GEN`` through ``Engine(slots=8, k_steps=8)``.
    The counts are zeroed just before the SFT and read just after the serve;
    the kernels' launches go into ``records``.

    Asserted: what ``sft`` asserts; an auxiliary loss above 0 in every
    step; the launches (2 sweeps and 1 quantizer a leaf-matrix of the DAQ
    quantize, none by the equalized ones; the wgmma route 4L a prefill call
    and 4L + 1 a scoring forward of the DAQ tree, none of the others; the
    decode route 4L + 1 a decode step and 1 a prefill call; the CUDA-core
    route none); every score in [0, 2]; the outputs' lengths and ranges;
    no decode step dropping an assignment.  Ends with ``train_agreement``
    on a small Mixtral-shaped model."""
    import warnings

    import repro_torch.launch.steps as steps_mod
    from repro_torch.configs import QuantConfig, TrainConfig, get_arch
    from repro_torch.core.policy import tree_map
    from repro_torch.data import eval_scores
    from repro_torch.engine import Engine
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.kernels.scale_search.kernel import sweep_plan
    from repro_torch.launch.train import default_language
    from repro_torch.models import build_model
    from repro_torch.quantize import quantize

    cfg = dataclasses.replace(get_arch("mixtral-8x22b"), n_layers=MOE_TRAIN_LAYERS)
    L = cfg.n_layers
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS,
                     remat="full")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=model.device).manual_seed(seed + 19)
    params = model.init(g)
    # the base waits on the host: beside 47 GB of state, an expert stack's
    # AdamW temporaries (3.2 GB each in fp32) ran the card out of memory
    base = tree_map(lambda t: t.to("cpu", copy=True), params)
    state = steps_mod.init_train_state(model, tc, None, params)
    spec = default_language(cfg, tc.seed + 100)
    prompts = torch.randint(0, spec.vocab, (SLOTS, PROMPT), generator=g, device=model.device)
    B, S = TRAIN_BATCH
    log(f"moe train phase: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} experts={cfg.n_experts} x d_ff {cfg.d_ff} top-{cfg.top_k} at "
        f"capacity factor {cfg.capacity_factor}, window {cfg.sliding_window}, vocab "
        f"{cfg.vocab_size}, layers={L} of 56 ({cfg.param_count() / 1e9:.3f} B params); "
        f"{TRAIN_STEPS} steps of {B} x {S} tokens (mixed corpus, LanguageSpec(vocab="
        f"{spec.vocab})), remat full, AdamW fp32 master and moments; state "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")

    # ---- phase 7n's path: counts zeroed just before, read just after ----
    for k in KERNELS:
        k.launches = 0
    drops: list = []
    restore = routing_recorder(torch, drops)
    try:
        state, metrics = sft(torch, model, tc, state, spec, "moe train phase")
    finally:
        restore()
    train_drops = (sum(t for t, _ in drops) * cfg.top_k,
                   sum(t * cfg.top_k - int(k) for t, k in drops), len(drops))
    post = state["params"]
    del state
    torch.cuda.empty_cache()
    base = tree_map(lambda t: t.to(model.device), base)
    trees, quant = {"base": base, "post": post}, {}
    calibrated = {"model": model, "spec": spec}
    for method, qcfg, kw in (("daq", QuantConfig(use_fused_kernel=True), {}),
                             ("smoothquant", QuantConfig(), calibrated),
                             ("awq", QuantConfig(), calibrated)):
        torch.cuda.reset_peak_memory_stats()
        before = {k.name: k.launches for k in KERNELS}
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tree, report = quantize(post, base, qcfg, mode="storage", method=method, **kw)
        torch.cuda.synchronize()
        quant[method] = (report, time.perf_counter() - t0,
                         torch.cuda.max_memory_allocated() / 1e9,
                         {k.name: k.launches - before[k.name] for k in KERNELS},
                         [str(w.message) for w in caught])
        trees[method] = tree
    scores = {}
    for name, tree in trees.items():
        t0 = time.perf_counter()
        scores[name] = (eval_scores(model, tree, spec), time.perf_counter() - t0)
    qparams = trees.pop("daq")
    del trees, post, base, tree
    torch.cuda.empty_cache()
    engine = Engine(model, qparams, slots=SLOTS, cache_len=PROMPT + GEN, k_steps=K_STEPS)
    serve_drops: list = []
    restore = routing_recorder(torch, serve_drops)
    try:
        t0 = time.perf_counter()
        outputs, stats = engine.serve(list(prompts), gen_tokens=GEN, return_stats=True)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    finally:
        restore()
    launches = {k.name: k.launches for k in KERNELS}
    # ---- end of phase 7n's path ----

    log(f"moe train phase: {train_drops[1]} of {train_drops[0]} assignments dropped by "
        f"capacity over the SFT's {train_drops[2]} routing calls (remat full routes each "
        f"layer twice a step: the forward and the backward's recompute)")
    for method, (report, secs, peak, made, caught) in quant.items():
        gc, gd = report.global_chosen, report.global_default
        log(f"moe train phase, {method}: {secs:.2f} s, peak {peak:.2f} GB, {leaf_layers(report)} "
            f"leaf-matrices; sign rate {gc['sign_rate']:.6f} (AbsMax {gd['sign_rate']:.6f}), "
            f"cosine {gc['cosine']:.6f} (AbsMax {gd['cosine']:.6f}), delta L2 "
            f"{gc['delta_l2']:.4f}; launches {json.dumps(made)}; warnings {caught}")
        if not all(math.isfinite(v) for v in (*gc.values(), *gd.values())):
            raise AssertionError(f"moe train phase, {method}: non-finite metrics {gc} {gd}")
    for name, (sc, secs) in scores.items():
        log(f"moe train phase, scores of {name}: style {sc['style']:.4f}, general "
            f"{sc['general']:.4f} (marker {sc['style_marker_acc']:.4f}, style bigram "
            f"{sc['style_bigram_acc']:.4f}, base bigram {sc['general_acc']:.4f}) in "
            f"{secs:.2f} s")
        if not all(0.0 <= sc[k] <= 2.0 for k in ("style", "general")):
            raise AssertionError(f"moe train phase: scores of {name} out of [0, 2]: {sc}")
    dec = stats["counters"]["tokens"]
    dropped = sum(t * cfg.top_k - int(k) for t, k in serve_drops if t <= SLOTS)
    log(f"moe train phase, serve of the DAQ tree: {len(outputs)} requests of {PROMPT} prompt "
        f"tokens x {GEN} in {serve_s:.2f} s ({SLOTS * GEN / serve_s:.1f} tok/s end to end; "
        f"decode {dec / stats['decode_s']:.1f} tok/s, {stats['decode_s'] / stats['decode_steps'] * 1e3:.2f} "
        f"ms a step); launches of the path {json.dumps(launches)}")
    n = leaf_layers(quant["daq"][0])
    qcfg = QuantConfig()
    passes = len(sweep_plan(1 + qcfg.n_coarse)) + len(sweep_plan(1 + qcfg.n_fine))
    serve = fp8_serve_launches(stats, L, per_layer=4)
    want = {"scale_search": passes * n, "fp8_quant": n,
            "fp8_matmul_wgmma": serve["fp8_matmul_wgmma"] + 2 * (4 * L + 1),
            "fp8_matmul_decode": serve["fp8_matmul_decode"], "fp8_matmul": 0}
    if n != 2 + (4 + 3 * cfg.n_experts) * L or launches != want or any(
            any(quant[m][3].values()) for m in ("smoothquant", "awq")):
        raise AssertionError(f"moe train phase: {n} leaf-matrices, launches {launches}, "
                             f"expected {want} (the equalized quantizes launch none)")
    if not all(m["aux_loss"] > 0 for m in metrics):
        raise AssertionError(f"moe train phase: aux losses {[m['aux_loss'] for m in metrics]}")
    for out in outputs:
        if len(out) != GEN or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"moe train phase: bad output row {out[:8]}...")
    if dropped:
        raise AssertionError(f"moe train phase: a decode step dropped {dropped} assignments")
    for name, k in launches.items():
        records[name]["launches"] += k
    del qparams, engine
    torch.cuda.empty_cache()
    train_agreement(torch, seed, dataclasses.replace(
        get_arch("mixtral-8x22b"), n_layers=2, d_model=256, n_heads=2, n_kv_heads=1,
        head_dim=128, d_ff=256, n_experts=8, top_k=2, vocab_size=1024, sliding_window=16,
        dtype="float32"), label="moe train agreement")


def study_phase(torch) -> None:
    """Phase 7i: ``repro_torch.pipeline.daq_study`` on the card at the
    reference's ``STUDY_CFG``: ``prepare_models`` (base then SFT, each
    ``train_loop`` with its checkpoints) into a temporary directory at
    ``STUDY_STEPS`` (base, SFT) steps, then ``run_tables(("2", "4"))``: the
    baselines and the sign-guided search (each row printed by the study:
    style, general, sign rate, cosine, ΔL2).  Asserts that the SFT'd
    model's style is above the base's (the study's premise) and that every
    row is finite."""
    import tempfile
    from repro_torch.pipeline import daq_study as DS
    base_steps, sft_steps = STUDY_STEPS
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        DS.prepare_models(study_dir=d, base_steps=base_steps, sft_steps=sft_steps)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = DS.run_tables(("2", "4"), study_dir=d, base_steps=base_steps,
                                sft_steps=sft_steps)
        tables_s = time.perf_counter() - t0
    rows = {f"T{t}/{name}": row for t, named in results.items() for name, row in named.items()}
    log(f"study phase: {base_steps} + {sft_steps} steps of {DS.BATCH} x {DS.SEQ} tokens in "
        f"{train_s:.1f} s ({(base_steps + sft_steps) * DS.BATCH * DS.SEQ / train_s:.0f} train "
        f"tok/s, checkpoints included); tables 2 and 4 ({len(rows)} rows) in {tables_s:.1f} s")
    base, post = results["2"]["base_bf16"], results["2"]["post_bf16"]
    if not post["style"] > base["style"]:
        raise AssertionError(f"study phase: post-SFT style {post['style']} is not above the "
                             f"base's {base['style']}")
    for name, row in rows.items():
        if not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"study phase: non-finite row {name}: {row}")
    log(f"study phase: style {base['style']:.4f} -> {post['style']:.4f} after SFT, general "
        f"{base['general']:.4f} -> {post['general']:.4f}")


# ---------------------------------------------------------------------------
# Phase 7e: the rest of the quantizer (daq-per-block, SmoothQuant, AWQ)
# ---------------------------------------------------------------------------

def quantize_counted(torch, post, base, qcfg, method: str, **kw):
    """``quantize(..., mode="storage", method=method)`` with every kernel
    count zeroed just before and read just after: (tree, report, launches,
    seconds, peak GB)."""
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.quantize import quantize
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree, report = quantize(post, base, qcfg, mode="storage", method=method, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (tree, report, {k.name: k.launches for k in KERNELS}, secs,
            torch.cuda.max_memory_allocated() / 1e9)


def matmul_calls(torch, model, params, tokens) -> int:
    """``qlinear.matmul`` calls of one full-sequence forward over ``tokens``."""
    from repro_torch.data.synthetic import _full_logits
    from repro_torch.quant_runtime import qlinear
    real, n = qlinear.matmul, [0]

    def counted(x, w):
        n[0] += 1
        return real(x, w)

    qlinear.matmul = counted
    try:
        _full_logits(model, params, {"tokens": tokens})
    finally:
        qlinear.matmul = real
    return n[0]


def methods_phase(torch, args, model, post, prompts, base_state, daq_outputs) -> None:
    """Phase 7e: the quantizer's other methods at full width and depth on
    phase 4's weights (``post``, and ``base`` remade from ``base_state``),
    each tree serving phase 6's 8 requests (128 + 64 tokens) through
    ``Engine(model, tree, slots=8, k_steps=8)``:

    * ``daq-per-block`` (block 128, E4M3, sign), storage mode: quantize
      seconds, peak GB, alpha and code-and-scale hashes; every leaf's sign
      rate at least AbsMax's; no sweep and no quantizer launch (the plain
      path, as in the reference); the serve's launches on the decode and
      prefill routes (``fp8_serve_launches``) and none on the CUDA-core
      route; tok/s, agreement with phase 6's DAQ tokens, and a decode
      step's breakdown beside phase 8's of the DAQ tree;
    * calibration: ``collect_input_stats(model, post, LanguageSpec(vocab=
      CALIB_VOCAB), n_batches=2)``: seconds; 2 records per
      ``qlinear.matmul`` call of one forward; every maximum finite;
      ``RECORD`` None after;
    * ``smoothquant`` and ``awq`` at channel granularity (Table 2's
      setting), E4M3, storage mode, with that calibration: seconds, peak
      GB, every ``eq_scale`` finite in [1e-4, 1], a serve that launches no
      kernel at all (equalized tensors take the dequantize path), tok/s,
      tokens in range; a decode step of the smoothquant tree broken down;
    * ``methods_agreement``: the reduced GLM-4-9B on the card against the
      CPU.

    The calibration language has 4,096 tokens, not GLM-4-9B's 151,552: its
    bigram table is [V, V] float32, 91.9 GB at the full vocabulary (the
    reference cannot build it either); its ids are valid GLM-4-9B ids."""
    from repro_torch.configs import QuantConfig
    from repro_torch.core.policy import tree_leaves_with_path
    from repro_torch.data import LanguageSpec
    from repro_torch.data.synthetic import sample_batch
    from repro_torch.engine import Engine
    from repro_torch.quant_runtime import qlinear
    from repro_torch.quantize import collect_input_stats
    cfg = model.cfg
    requests = list(prompts)
    t0 = time.perf_counter()
    g = torch.Generator(device=model.device)
    g.set_state(base_state)
    base = make_base(torch, post, g)
    torch.cuda.synchronize()
    log(f"methods phase: phase 4's base remade in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")

    def serve(name, tree, fp8: bool):
        """Serve ``requests``; every kernel count must be 0 but the fp8
        routes' of a bf16 serve of a block-128 tree (``fp8``)."""
        engine = Engine(model, tree, slots=SLOTS, cache_len=PROMPT + GEN, k_steps=K_STEPS)
        outputs, stats, launches, secs = counted_serve(torch, engine, requests)
        dec = stats["counters"]["tokens"]
        log(f"methods phase, {name} serve: {len(outputs)} requests x {GEN} tokens in "
            f"{secs:.2f} s ({SLOTS * GEN / secs:.1f} tok/s end to end); decode {dec} tokens "
            f"in {stats['decode_s']:.3f} s = {dec / stats['decode_s']:.1f} tok/s "
            f"({stats['decode_s'] / stats['decode_steps'] * 1e3:.2f} ms per step of {SLOTS} "
            f"slots); launches {json.dumps(launches)}; vs phase 6's DAQ tokens: "
            f"{agreement(outputs, daq_outputs)}")
        want = dict.fromkeys(launches, 0)
        if fp8:
            want.update(fp8_serve_launches(stats, cfg.n_layers))
        if launches != want:
            raise AssertionError(f"methods phase, {name}: launches {launches}, expected {want}")
        for out in outputs:
            if len(out) != GEN or not all(0 <= t < cfg.vocab_size for t in out):
                raise AssertionError(f"methods phase, {name}: bad output row {out[:8]}... "
                                     f"({len(out)} tokens)")

    # ---- daq-per-block ----
    tree, report, launches, secs, peak = quantize_counted(torch, post, base, QuantConfig(),
                                                          "daq-per-block")
    log(report.summary())
    log(f"methods phase, daq-per-block: quantize {secs:.2f} s for {report.n_quantized} "
        f"tensors, peak {peak:.2f} GB; chosen-alpha hash {alpha_hash(report.per_leaf)}, "
        f"code-and-scale hash {code_hash(torch, tree)} over {leaf_layers(report)} "
        f"leaf-layers; launches {json.dumps(launches)}")
    if launches["scale_search"] or launches["fp8_quant"]:
        raise AssertionError(f"daq-per-block launched a search kernel: {launches}")
    leaf_sign_rates_hold(report, "daq-per-block")
    serve("daq-per-block", tree, fp8=True)
    breakdowns(torch, model, tree, prompts, tree="per-block tree ", prefill=False)
    del tree
    torch.cuda.empty_cache()

    # ---- calibration ----
    spec = LanguageSpec(vocab=CALIB_VOCAB)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records = collect_input_stats(model, post, spec, n_batches=2)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    toks = sample_batch(torch.Generator(device=model.device).manual_seed(0), spec, 4, 64,
                        device=model.device)[:, :-1]
    calls = matmul_calls(torch, model, post, toks)
    log(f"methods phase, calibration: {len(records)} records from 2 batches of 4 x 64 "
        f"tokens (LanguageSpec(vocab={CALIB_VOCAB})) in {calib_s:.2f} s; one forward makes "
        f"{calls} qlinear.matmul calls")
    if len(records) != 2 * calls or calls != 7 * cfg.n_layers + 1:
        raise AssertionError(f"calibration: {len(records)} records, {calls} calls a forward")
    if qlinear.RECORD is not None:
        raise AssertionError("calibration left qlinear.RECORD set")
    if not all(bool(torch.isfinite(m).all()) for _, _, m in records):
        raise AssertionError("calibration: a non-finite activation maximum")

    # ---- smoothquant, awq ----
    for method in ("smoothquant", "awq"):
        tree, report, launches, secs, peak = quantize_counted(
            torch, post, base, QuantConfig(granularity="channel"), method, calib=records)
        log(f"methods phase, {method}: quantize {secs:.2f} s for {report.n_quantized} "
            f"tensors ({report.quantized_bytes / 1e9:.2f} GB), peak {peak:.2f} GB; "
            f"launches {json.dumps(launches)}")
        log(report.summary())
        if any(launches.values()):
            raise AssertionError(f"{method} launched a kernel on its quantize: {launches}")
        for path, leaf in tree_leaves_with_path(tree):
            if hasattr(leaf, "granularity"):
                e = leaf.eq_scale
                if e is None or not bool((torch.isfinite(e) & (e >= 1e-4) & (e <= 1)).all()):
                    raise AssertionError(f"{method}: eq_scale of {'/'.join(path)} not finite "
                                         f"in [1e-4, 1]")
        serve(method, tree, fp8=False)
        if method == "smoothquant":     # awq's tree takes the same path
            breakdowns(torch, model, tree, prompts, tree="smoothquant tree ", prefill=False)
        del tree
        torch.cuda.empty_cache()
    del base
    torch.cuda.empty_cache()
    methods_agreement(torch, args.seed)


def block64_phase(torch, model, post, prompts, base_state, daq_outputs,
                  block: int = 64) -> None:
    """Phase 7l: phase 4's weights (``post``, and ``base`` remade from
    ``base_state`` as phase 7e does) DAQ-quantized (sign, E4M3) at quant
    block 64, storage mode, then phase 6's 8 requests (128 + 64 tokens)
    through ``Engine(slots=8, k_steps=8)``: the sweep's and the quantizer's
    launches (2 and 1 a leaf-layer), and the serve's on the tensor-core
    routes (``fp8_serve_launches``: wgmma 7 x layers a prefill call, decode
    7 x layers + 1 a decode step and 1 a prefill call, the CUDA-core kernel
    none) asserted; quantize seconds, peak GB, tok/s, a decode step's and a
    prefill's breakdown, and how many greedy tokens agree with phase 6's
    block-128 serve (a reading: another quantization)."""
    from repro_torch.configs import QuantConfig
    from repro_torch.engine import Engine
    from repro_torch.kernels.scale_search.kernel import sweep_plan
    cfg = model.cfg
    t0 = time.perf_counter()
    g = torch.Generator(device=model.device)
    g.set_state(base_state)
    base = make_base(torch, post, g)
    torch.cuda.synchronize()
    log(f"block-{block} phase: phase 4's base remade in {time.perf_counter() - t0:.2f} s")
    qcfg = QuantConfig(use_fused_kernel=True, block_size=block)
    tree, report, launches, secs, peak = quantize_counted(torch, post, base, qcfg, None)
    del base
    torch.cuda.empty_cache()
    n = leaf_layers(report)
    passes = len(sweep_plan(1 + qcfg.n_coarse)) + len(sweep_plan(1 + qcfg.n_fine))
    want = dict.fromkeys(launches, 0)
    want.update(scale_search=passes * n, fp8_quant=n)
    log(f"block-{block} phase: quantize {secs:.2f} s for {report.n_quantized} tensors "
        f"({report.quantized_bytes / 1e9:.2f} GB), peak {peak:.2f} GB; chosen-alpha hash "
        f"{alpha_hash(report.per_leaf)}, code-and-scale hash {code_hash(torch, tree)} over "
        f"{n} leaf-layers; launches {json.dumps(launches)}")
    if launches != want:
        raise AssertionError(f"block-{block} quantize: launches {launches}, expected {want}")
    leaf_sign_rates_hold(report, f"block-{block} DAQ")
    engine = Engine(model, tree, slots=SLOTS, cache_len=PROMPT + GEN, k_steps=K_STEPS)
    outputs, stats, launches, secs = counted_serve(torch, engine, list(prompts))
    dec = stats["counters"]["tokens"]
    want = dict.fromkeys(launches, 0)
    want.update(fp8_serve_launches(stats, cfg.n_layers))
    log(f"block-{block} phase, serve: {len(outputs)} requests x {GEN} tokens in {secs:.2f} s "
        f"({SLOTS * GEN / secs:.1f} tok/s end to end); prefill {stats['prefill_s']:.3f} s; "
        f"decode {dec} tokens in {stats['decode_s']:.3f} s = {dec / stats['decode_s']:.1f} "
        f"tok/s; launches {json.dumps(launches)}; vs phase 6's block-128 tokens: "
        f"{agreement(outputs, daq_outputs)}")
    if launches != want:
        raise AssertionError(f"block-{block} serve: launches {launches}, expected {want}")
    for out in outputs:
        if len(out) != GEN or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"block-{block} serve: bad output row {out[:8]}... "
                                 f"({len(out)} tokens)")
    del engine
    torch.cuda.empty_cache()
    dequantized_prefill_agreement(torch, model, tree, prompts, f"block-{block} tree")
    breakdowns(torch, model, tree, prompts, steps=1, tree=f"block-{block} tree ")
    del tree
    torch.cuda.empty_cache()


def dequantized_prefill_agreement(torch, model, tree, prompts, label: str,
                                  layers: int = 4) -> float:
    """One prefill of ``prompts`` through the first ``layers`` layers of the
    fp8 ``tree`` (the fp8 kernels) against the same cut tree with each fp8
    leaf dequantized, its fp32 values rounded once to bf16, and multiplied
    by ``torch.matmul``: logits within 5 % of the largest (the bf16
    rounding of the weights, as the small models' tolerance).  Unlike a
    comparison of two quantizations, this sees a fault of the kernels on a
    served tree's own leaves.  Returns the error over the largest logit."""
    from repro_torch.core.policy import tree_map
    from repro_torch.quant_runtime.qparams import QuantizedTensor
    cut_model, cut = first_layers(model, layers, tree)
    dense = tree_map(lambda t: t.dequantize(torch.bfloat16) if isinstance(t, QuantizedTensor)
                     else t, cut)
    got, _ = cut_model.prefill(cut, {"tokens": prompts})
    want, _ = cut_model.prefill(dense, {"tokens": prompts})
    del dense
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    log(f"{label}: a prefill of {tuple(prompts.shape)} tokens through {layers} layers on the "
        f"fp8 kernels vs its leaves dequantized to bf16 and torch.matmul: logits max |err| "
        f"{err:.4g} (max |logit| {scale:.4g}, {err / scale:.4g} of it; tolerance 5%)")
    if not err <= 0.05 * scale:
        raise AssertionError(f"{label}: the fp8 kernels' prefill disagrees with the dequantized "
                             f"tree's")
    return err / scale


def methods_agreement(torch, seed: int) -> None:
    """The reduced GLM-4-9B (bf16, base = post + 1 % noise) on the card
    against the CPU: ``daq-per-block`` (sign, blocks of 32 and channels)
    with equal alphas and codes; ``smoothquant`` at channel granularity with
    equal ``eq_scale`` and codes, given the same activation maxima on both
    devices (one CPU calibration, keyed on each device by that device's
    fingerprints: ``mean|w|`` is reduced in another order on the card);
    ``awq``'s chosen exponents of both runs, equal wherever the two smallest
    errors differ by more than 1e-6 relative."""
    from repro_torch.configs import QuantConfig, get_arch, reduced
    from repro_torch.core.formats import get_format
    from repro_torch.core.policy import tree_leaves_with_path, tree_map
    from repro_torch.data import LanguageSpec
    from repro_torch.models import build_model
    from repro_torch.quant_runtime import qlinear
    from repro_torch.quantize import collect_input_stats, quantize
    from repro_torch.quantize.equalize import AWQQuantizer, awq_trials
    cfg = reduced(get_arch("glm4-9b"))
    m_cpu = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(seed + 3)
    post = m_cpu.init(g)
    base = tree_map(lambda t: t if t.ndim < 2 else
                    (t.float() + 0.01 * t.float().std()
                     * torch.randn(t.shape, generator=g)).to(t.dtype), post)
    gpu = lambda tree: tree_map(lambda t: t.cuda(), tree)
    post_g, base_g = gpu(post), gpu(base)

    def codes_equal(a, b, name):
        for (path, x), (_, y) in zip(tree_leaves_with_path(a), tree_leaves_with_path(b)):
            if hasattr(x, "granularity"):
                same = torch.equal(x.data.view(torch.uint8), y.data.cpu().view(torch.uint8)) \
                    and torch.equal(x.scale, y.scale.cpu()) \
                    and (x.eq_scale is None or torch.equal(x.eq_scale, y.eq_scale.cpu()))
                if not same:
                    raise AssertionError(f"small model, {name}: codes, scales or eq_scale "
                                         f"differ on {'/'.join(path)}")

    for gran in ("block", "channel"):
        q = QuantConfig(granularity=gran, block_size=32)
        qc, rc = quantize(post, base, q, mode="storage", method="daq-per-block")
        qg, rg = quantize(post_g, base_g, q, mode="storage", method="daq-per-block")
        for name, leaf in rc.per_leaf.items():
            if not (leaf["alpha"] == rg.per_leaf[name]["alpha"]).all():
                raise AssertionError(f"small model, daq-per-block {gran}: alphas differ on "
                                     f"{name}")
        codes_equal(qc, qg, f"daq-per-block {gran}")
    log("methods agreement (reduced GLM-4-9B, card vs CPU): daq-per-block alphas and codes "
        "equal at blocks of 32 and per channel")

    stats: dict = {}
    for shape, fp, amax in collect_input_stats(m_cpu, post, LanguageSpec(vocab=cfg.vocab_size),
                                               n_batches=1):
        key = (shape, fp)
        stats[key] = amax if key not in stats else torch.maximum(stats[key], amax)
    cal_c, cal_g = [], []
    for (path, leaf), (_, leaf_g) in zip(tree_leaves_with_path(post),
                                         tree_leaves_with_path(post_g)):
        if leaf.ndim < 2 or "norm" in path[-1] or "bias" in path[-1]:
            continue
        for w, wg in zip(leaf.reshape(-1, *leaf.shape[-2:]), leaf_g.reshape(-1, *leaf.shape[-2:])):
            amax = stats.get((tuple(w.shape), qlinear.weight_fingerprint(w)))
            if amax is not None:                  # the embedding table has no record
                cal_c.append((tuple(w.shape), qlinear.weight_fingerprint(w), amax))
                cal_g.append((tuple(w.shape), qlinear.weight_fingerprint(wg), amax.cuda()))
    q = QuantConfig(granularity="channel")
    qc, _ = quantize(post, base, q, mode="storage", method="smoothquant", calib=cal_c)
    qg, _ = quantize(post_g, base_g, q, mode="storage", method="smoothquant", calib=cal_g)
    codes_equal(qc, qg, "smoothquant")

    # awq: each run's exponent per leaf-layer, read off its eq_scale (the
    # normalized candidate of ``awq_trials`` it equals)
    runs = [quantize(t, b, q, mode="storage", method="awq", calib=c)[0]
            for t, b, c in ((post, base, cal_c), (post_g, base_g, cal_g))]
    fmt = get_format(q.fmt)
    exps, n_decided = ([], []), 0
    for (path, leaf), *qs in zip(tree_leaves_with_path(post), *(tree_leaves_with_path(r)
                                                                 for r in runs)):
        if not hasattr(qs[0][1], "granularity") or "embed" in path[-1]:
            continue
        n = leaf.shape[0] if leaf.ndim == 3 else 1
        for t in range(n):
            found = []
            for (_, qt), w_side in zip(qs, (leaf, leaf.cuda())):
                w = (w_side[t] if leaf.ndim == 3 else w_side).float()
                e = qt.eq_scale[t] if leaf.ndim == 3 else qt.eq_scale
                amax = [c for c in (cal_c if w.device.type == "cpu" else cal_g)
                        if c[1] == qlinear.weight_fingerprint(w)][0][2]
                s_tries, errs = awq_trials(w, amax.float().clamp_min(1e-6),
                                           w.abs().amax(dim=1).clamp_min(1e-6), q, fmt)
                norm = (s_tries / s_tries.amax(dim=1, keepdim=True).clamp_min(1e-6)).clamp_min(1e-4)
                k = [i for i in range(len(norm)) if torch.equal(norm[i], e)]
                if k != [int(torch.argmin(errs))]:
                    raise AssertionError(f"small model, awq: {'/'.join(path)}[{t}]'s eq_scale "
                                         f"is candidate {k}, argmin {int(torch.argmin(errs))}")
                found.append((k[0], errs.cpu()))
            (kc, errs_c), (kg, _) = found
            exps[0].append(AWQQuantizer.GRID[kc])
            exps[1].append(AWQQuantizer.GRID[kg])
            two = torch.sort(errs_c).values[:2]
            if float(two[1] - two[0]) > 1e-6 * float(two[0]):
                n_decided += 1
                if kc != kg:
                    raise AssertionError(f"small model, awq: exponent {AWQQuantizer.GRID[kg]} "
                                         f"on the card, {AWQQuantizer.GRID[kc]} on the CPU, "
                                         f"errors {errs_c.tolist()}")
    log(f"methods agreement: smoothquant eq_scale and codes equal over {len(cal_c)} "
        f"leaf-layers; awq exponents of the CPU run {exps[0]}, of the card's {exps[1]} "
        f"({n_decided} decided by more than 1e-6 relative, equal)")


def spec_breakdown(torch, phase: dict) -> None:
    """One speculative round at (ii)'s state (its first admission: 8 slots
    at 128 tokens) and its parts: the round (``make_decode_dispatch`` with
    ``k_steps=1``), its N_SPEC draft steps (``decode_step_paged`` with the
    DAQ tree) and its verify (``verify_chunk_paged`` of the bf16 tree over
    ``SLOTS x (N_SPEC + 1)`` rows); each from a copy of the state: host ms,
    device busy ms and launches."""
    from repro_torch.engine.scheduler import make_decode_dispatch
    engine, requests = phase["engine"], phase["requests"]
    model = engine.model
    cache0, state0, gen = admitted(torch, engine, requests)
    one_round = make_decode_dispatch(model, engine.cfg.sampling, 1, paged=True, n_spec=N_SPEC)
    depth = torch.full((), N_SPEC, dtype=torch.int32, device=model.device)
    vtoks = torch.cat([state0["cur"]] * (N_SPEC + 1), dim=1)
    valid = torch.full((SLOTS,), N_SPEC + 1, dtype=torch.int32, device=model.device)

    def round_():
        one_round(engine.params, engine.draft_params, clone_tree(state0), clone_tree(cache0),
                  depth, gen)
        torch.cuda.synchronize()

    def drafts():
        cache = clone_tree(cache0)
        for _ in range(N_SPEC):
            _, cache = model.decode_step_paged(engine.draft_params, state0["cur"], cache)
        torch.cuda.synchronize()

    def verify():
        cache = clone_tree(cache0)
        model.verify_chunk_paged(engine.params, vtoks, cache, cache["lengths"], valid)
        torch.cuda.synchronize()

    at = f"at cache_len {PROMPT + GEN}, {SLOTS} slots at {PROMPT} tokens"
    device_breakdown(torch, f"speculative round (n_spec {N_SPEC}, {at})", round_, 1, "round")
    device_breakdown(torch, f"its draft steps (DAQ-fp8 decode_step_paged, {at})", drafts,
                     N_SPEC, "draft step")
    device_breakdown(torch, f"its verify (bf16 verify_chunk_paged of {SLOTS} x {N_SPEC + 1} "
                     f"rows, {at})", verify, 1, "verify")
    del cache0, state0
    torch.cuda.empty_cache()


def chunk_breakdown(torch, model, qparams, requests, ref_engine) -> None:
    """One K-step dispatch with a chunk piece beside a plain paged dispatch
    at the same state: ``ref_engine``'s first admission of 8 requests (8
    slots decoding, ``cache_len`` 560, 280 blocks of 16); the chunked
    dispatch (``chunk_size`` 64, copy-on-write decode) has slot 7 readmitted
    to prefill the 496-token prompt of the paged phase's longest request, so
    each of its 8 steps runs a decode sub-step and a 64-token chunk piece.
    Each run starts from a copy of the state: host ms, device busy ms and
    launches per step."""
    from repro_torch.engine import Engine
    from repro_torch.engine.paged import blocks_for
    from repro_torch.engine.scheduler import init_slot_state
    chunk_eng = Engine(model, qparams, slots=SLOTS, cache_len=PAGED_CACHE_LEN,
                       k_steps=K_STEPS, paged=True, block_size=BLOCK, chunk_size=CHUNK,
                       prefix_cache=True)
    cache0, state0, gen = admitted(torch, ref_engine, requests)
    state1 = {**init_slot_state(SLOTS, model.device, prompt_cap=PAGED_CACHE_LEN),
              **{k: state0[k].clone() for k in ("cur", "active", "remaining")}}
    cache1 = clone_tree(cache0)
    prompt = max(requests, key=lambda r: r.shape[0])[:PAGED_CACHE_LEN - GEN]
    L, mb = int(prompt.shape[0]), chunk_eng._mb
    ints = torch.full((mb + PAGED_CACHE_LEN,), -1, dtype=torch.int32, device=model.device)
    ints[mb:] = 0
    ints[mb:mb + L] = prompt
    cache1, state1, _ = chunk_eng._admit_chunk(cache1, state1, SLOTS - 1, ints, 0,
                                               blocks_for(L, BLOCK), 0, 0, 0, L, GEN - 1)
    for label, engine, dispatch, cache, state in (
            ("plain paged", ref_engine, ref_engine._dispatch, cache0, state0),
            (f"chunked ({L}-token prompt in slot {SLOTS - 1})", chunk_eng,
             chunk_eng._dispatch_chunk, cache1, state1)):
        def run():
            dispatch(engine.params, clone_tree(state), clone_tree(cache), gen)
            torch.cuda.synchronize()

        device_breakdown(torch, f"{label} dispatch at cache_len {PAGED_CACHE_LEN} "
                         f"({K_STEPS} steps of {SLOTS} slots)", run, K_STEPS, "step")
    del cache0, cache1
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 7j: the SSM family, Mamba2-780M at full width and depth
# ---------------------------------------------------------------------------

def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def ragged_product_checks(torch, qparams, g) -> None:
    """The fused matmul on the two ragged quantized leaves of the Mamba-2
    tree through their zero-padded block grids: ``in_dt`` of layer 0
    [1536,48] (grid [1536,128]) at a decode step's and a prefill call's
    rows, and the LM head [1536,50280] (grid [1536,50304]) at a decode
    step's rows.  The kernel's fp32 product on the grid, cut to the
    leaf's columns, is held against x @ the unpadded leaf dequantized in
    fp32 (``check_matmul``'s tolerance), and the wrapper's bf16 output must
    be that product's bf16 cast, bit for bit."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.granularity import dequantize_stored
    from repro_torch.kernels.fp8_matmul.kernel import route
    from repro_torch.kernels.fp8_matmul.ops import matmul_fp8, matmul_fp8_2d
    for name, qt, rows in (("in_dt", qparams["stack"]["L0"]["mamba"]["in_dt"].layer(0),
                            (SLOTS, 2 * SSM_LENS[0])),
                           ("LM head", qparams["embed"]["w_head"], (SLOTS,))):
        K, N = qt.shape
        w = dequantize_stored(qt.data, qt.scale, "block", get_format(qt.fmt), qt.block_size,
                              torch.float32)
        for M in rows:
            x = torch.randn((M, K), generator=g, device="cuda").bfloat16()
            yk = matmul_fp8_2d(x, qt.grid, qt.scale[:, 0, :, 0])[:, :N]
            yw = matmul_fp8(x, qt)
            yp = x.float() @ w
            torch.cuda.synchronize()
            err = (yk - yp).abs()
            ok = bool(torch.isfinite(yk).all()) and bool(
                (err <= 1e-4 * yp.abs() + 1e-5 * yp.abs().max()).all()) \
                and torch.equal(yw, yk.bfloat16())
            log(f"kernel-check ragged {name} M={M} [{K},{N}] on its grid "
                f"{list(qt.grid.shape)} ({route(M, qt.grid.shape[1], K, 128, x.dtype)} "
                f"route): max |err| {float(err.max()):.3e} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the fp8 matmul disagrees on the ragged {name} at M={M}")


def repeat_timing(torch, name: str, run, case) -> None:
    """``device_times`` of ``run`` on ``case`` again, with eight launches on
    each weight copy: the profiler's time beside the graph replay's."""
    calls = case.calls(run)
    prof_ms, replay_ms = device_times(torch, calls, reps=8 * len(calls))
    log(f"timing repeat {name} M={case.M} [{case.K},{case.N}]: {len(calls)} weight copies, "
        f"{8 * len(calls)} launches: profiler device time {prof_ms:.5f} ms a call; CUDA "
        f"events over a graph replay {replay_ms:.5f} ms a call")


def ragged_leaf_checks(torch, post, base, qcfg) -> None:
    """The sweep and the quantizer against their plain versions on the two
    ragged leaves of the Mamba-2 tree, ``in_dt`` of layer 0 [1536,48] and
    the embedding [50280,1536], padded to the block grid as the search pads
    them: sign counts and codes and scales equal, the other sums as phase 3
    holds them."""
    from repro_torch.core.granularity import EPS, pad_to_blocks, to_blocked
    from repro_torch.core.search import linspace
    from repro_torch.kernels.fp8_quant.kernel import quantize_fp8_cuda
    from repro_torch.kernels.fp8_quant.ref import quantize_fp8_ref
    from repro_torch.kernels.scale_search.kernel import sweep_partials_cuda
    from repro_torch.kernels.scale_search.ref import sweep_partials_ref
    bs = qcfg.block_size
    alphas = torch.cat([torch.ones(1, device="cuda"),
                        linspace(qcfg.alpha_min, qcfg.alpha_max, qcfg.n_coarse, "cuda")])
    for name, wp, wb in (("in_dt", post["stack"]["L0"]["mamba"]["in_dt"][0],
                          base["stack"]["L0"]["mamba"]["in_dt"][0]),
                         ("embed", post["embed"]["embed"], base["embed"]["embed"])):
        wp, _ = pad_to_blocks(wp.float(), bs)
        wb, _ = pad_to_blocks(wb.float(), bs)
        amax = to_blocked(wp, bs).abs().amax(dim=(1, 3)).clamp_min(EPS)
        pk = sweep_partials_cuda(wp, wb, amax, alphas, block_size=bs)
        pp = sweep_partials_ref(wp, wb, amax, alphas, block_size=bs)
        (qk, sk), (qp, sp) = (fn(wp, alphas[3:4], block=bs)
                              for fn in (quantize_fp8_cuda, quantize_fp8_ref))
        torch.cuda.synchronize()
        cont = [0, 2, 3, 4]
        err = (pk[..., cont] - pp[..., cont]).abs()
        tol = 1e-4 * pp[..., cont].abs() + 1e-6 * pp[..., cont].abs().max()
        n_codes, n_scales = codes_differ(torch, qk, qp), floats_differ(torch, sk, sp)
        ok = bool((pk[..., 1] == pp[..., 1]).all()) and bool((err <= tol).all()) \
            and n_codes == 0 and n_scales == 0
        log(f"ssm phase, ragged leaf {name} {list(wp.shape)} padded: sweep of {len(alphas)} "
            f"candidates, max |err| sums {err.max().item():.3e}, sign counts "
            f"{'equal' if bool((pk[..., 1] == pp[..., 1]).all()) else 'DIFFER'}; quantizer "
            f"{n_codes} code / {n_scales} scale mismatches -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ssm phase: a kernel disagrees with its plain version on "
                                 f"the ragged leaf {name}")


def ssm_small_agreement(torch, seed: int, device: str = "cuda") -> None:
    """A small bf16 Mamba-2 (2 layers, width 256, 16 heads of 32, state 64,
    1,024 tokens: every product but ``in_dt`` a block-128 multiple)
    quantized and served on ``device`` with the kernels and on the CPU with
    the plain versions: alphas and codes equal; 4 requests of 40 and 45
    tokens (SSD chunk 32), 8 tokens each, whose greedy tokens agree up to
    the first step where the CPU run's top-2 margin is within 5 % of the
    logit scale (the bf16 tolerance ``small_model_agreement`` holds
    logits to)."""
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.engine import Engine
    from repro_torch.core.policy import tree_leaves_with_path, tree_map
    from repro_torch.models import build_model
    from repro_torch.quantize import quantize
    cfg = dataclasses.replace(get_arch("mamba2-780m"), n_layers=2, d_model=256, d_inner=512,
                              ssm_head_dim=32, ssm_state=64, ssm_chunk=32, vocab_size=1024)
    m_cpu, m_dev = build_model(cfg, device="cpu"), build_model(cfg, device=device)
    g = torch.Generator().manual_seed(seed + 11)
    post = m_cpu.init(g)
    base = make_base(torch, post, g)
    qcfg = QuantConfig(use_fused_kernel=True)
    q_cpu, r_cpu = quantize(post, base, qcfg, mode="storage")
    to_dev = lambda t: t.to(device)
    q_dev, r_dev = quantize(tree_map(to_dev, post), tree_map(to_dev, base), qcfg,
                            mode="storage")
    for name, leaf in r_cpu.per_leaf.items():
        if not (leaf["alpha"] == r_dev.per_leaf[name]["alpha"]).all():
            raise AssertionError(f"small ssm model: alpha differs on {name}")
    for (path, a), (_, b) in zip(tree_leaves_with_path(q_cpu), tree_leaves_with_path(q_dev)):
        if hasattr(a, "granularity") and not (
                torch.equal(a.data.view(torch.uint8), b.data.cpu().view(torch.uint8))
                and torch.equal(a.scale, b.scale.cpu())):
            raise AssertionError(f"small ssm model: codes differ on {'/'.join(path)}")
    prompts = [torch.randint(0, cfg.vocab_size, (L,), generator=g) for L in (40, 45, 40, 45)]
    outs = {}
    for name, model, q in (("cpu", m_cpu, q_cpu), (device, m_dev, q_dev)):
        eng = Engine(model, q, slots=4, cache_len=64, k_steps=4)
        outs[name], stats = eng.serve(prompts, gen_tokens=8, return_stats=True)
        if stats["prefill_calls"] != 2:
            raise AssertionError(f"small ssm model: {stats['prefill_calls']} prefill calls "
                                 f"on {name}, expected 2")
    held = total = 0
    for p, out_c, out_d in zip(prompts, outs["cpu"], outs[device]):
        logits, cache = m_cpu.prefill(q_cpu, {"tokens": p[None]})
        for tok_c, tok_d in zip(out_c, out_d):
            lf = logits.float()[0]
            top = torch.topk(lf, 2).values
            if float(top[0] - top[1]) <= 0.05 * float(lf.abs().max()):
                break
            held += 1
            if tok_c != tok_d:
                raise AssertionError(f"small ssm model: greedy token {tok_d} on {device}, "
                                     f"{tok_c} on the CPU, at a margin above 5 %")
            logits, cache = m_cpu.decode_step(q_cpu, torch.tensor([[tok_c]]), cache)
        total += len(out_c)
    same = sum(a == b for oc, od in zip(outs["cpu"], outs[device]) for a, b in zip(oc, od))
    log(f"small ssm model agreement: alphas equal, codes bit-equal; greedy tokens {same} of "
        f"{total} equal, {held} of them held (top-2 margin above 5 %)")
    if held < len(prompts):
        raise AssertionError("small ssm model: no token was held by its margin")


def ssm_phase(torch, records: dict, seed: int, device: str = "cuda") -> None:
    """Phase 7j: Mamba2-780M at full width and all 48 layers, quantized and
    served through the port's entry points; the kernels' launches of the
    quantize and the serve go into ``records``."""
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.engine import Engine
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.kernels.fp8_matmul.kernel import TC_MIN_ROWS
    from repro_torch.kernels.scale_search.kernel import sweep_plan
    from repro_torch.models import build_model
    from repro_torch.quantize import quantize

    cuda = torch.device(device).type == "cuda"
    cfg = get_arch("mamba2-780m")
    if SLOTS >= TC_MIN_ROWS:
        raise AssertionError("fp8_serve_launches counts a prefill's LM head on the decode "
                             f"route: SLOTS must stay below {TC_MIN_ROWS}")
    log(f"ssm phase: {cfg.name} d_model={cfg.d_model} d_inner={cfg.resolved_d_inner} "
        f"heads={cfg.n_ssm_heads}x{cfg.ssm_head_dim} state={cfg.ssm_state} "
        f"chunk={cfg.ssm_chunk} vocab={cfg.vocab_size} layers={cfg.n_layers} "
        f"({cfg.param_count() / 1e9:.3f} B params)")
    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    post, base = make_weights(torch, model, seed + 7)
    sync(torch, device)
    log(f"ssm phase: post + base made in {time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device=model.device).manual_seed(seed + 8)
    requests = [torch.randint(0, cfg.vocab_size, (L,), generator=g, device=model.device)
                for L in SSM_LENS]
    qcfg = QuantConfig(use_fused_kernel=True)

    # ---- the SSM path: counts zeroed just before, read just after ----
    for k in KERNELS:
        k.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams, report = quantize(post, base, qcfg, mode="storage")
    sync(torch, device)
    quant_s = time.perf_counter() - t0
    quant_peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    engine = Engine(model, qparams, slots=SLOTS, cache_len=max(SSM_LENS) + GEN,
                    k_steps=K_STEPS)
    t0 = time.perf_counter()
    outputs, stats = engine.serve(requests, gen_tokens=GEN, return_stats=True)
    sync(torch, device)
    serve_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    # ---- end of the SSM path ----

    n = leaf_layers(report)
    log(f"ssm phase, quantize: {quant_s:.2f} s for {report.n_quantized} tensors, {n} "
        f"leaf-layers ({report.original_bytes / 1e9:.2f} GB bf16 -> "
        f"{report.quantized_bytes / 1e9:.2f} GB), peak {quant_peak:.2f} GB; chosen-alpha "
        f"hash {alpha_hash(report.per_leaf)}, code-and-scale hash {code_hash(torch, qparams)}")
    dec = stats["counters"]["tokens"]
    log(f"ssm phase, serve: {len(outputs)} requests of {list(SSM_LENS)} prompt tokens x {GEN} "
        f"in {serve_s:.2f} s ({SLOTS * GEN / serve_s:.1f} tok/s end to end); "
        f"{stats['prefill_calls']} prefill calls in {stats['prefill_s']:.3f} s for "
        f"{stats['prefill_tokens']} prompt tokens; decode {dec} tokens in "
        f"{stats['decode_s']:.3f} s = {dec / stats['decode_s']:.1f} tok/s "
        f"({stats['decode_s'] / stats['decode_steps'] * 1e3:.2f} ms a step of {SLOTS} slots); "
        f"cache {stats['cache_bytes'] / 1e6:.1f} MB; launches {json.dumps(launches)}")
    leaves = ["embed/embed", "embed/w_head", *(f"stack/L0/mamba/{k}" for k in
                                                ("in_bc", "in_dt", "in_x", "in_z", "out_proj"))]
    if sorted(report.per_leaf) != leaves or n != 5 * cfg.n_layers + 2:
        raise AssertionError(f"ssm phase: quantized leaves {sorted(report.per_leaf)} "
                             f"({n} leaf-layers), expected {leaves}")
    passes = len(sweep_plan(1 + qcfg.n_coarse)) + len(sweep_plan(1 + qcfg.n_fine))
    want = {"scale_search": passes * n, "fp8_quant": n,
            **fp8_serve_launches(stats, cfg.n_layers, per_layer=5)}
    if stats["prefill_calls"] != len(set(SSM_LENS)):
        raise AssertionError(f"ssm phase: {stats['prefill_calls']} prefill calls, expected "
                             f"one per prompt length ({len(set(SSM_LENS))})")
    for name, w in want.items():
        if launches[name] != w:
            raise AssertionError(f"ssm phase: {name} launched {launches[name]} times, "
                                 f"expected {w}")
    for out in outputs:
        if len(out) != GEN or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"ssm phase: bad output row {out[:8]}... ({len(out)} tokens)")
    for side in (report.global_chosen, report.global_default):
        if not all(math.isfinite(v) for v in side.values()):
            raise AssertionError(f"ssm phase: non-finite report metrics {side}")
    leaf_sign_rates_hold(report, "ssm phase")
    for name, k in launches.items():
        if name in records:
            records[name]["launches"] += k
    log(f"ssm phase: launches asserted ({json.dumps(want)}); first row {outputs[0][:12]}...")
    family_paged_phase(torch, records, "ssm phase", model, qparams, lambda: post, requests,
                       outputs, engine.cfg.cache_len, per_layer=5, chunk=SSM_CHUNK)
    if not cuda:
        return

    ragged_leaf_checks(torch, post, base, qcfg)
    del post, base, engine
    torch.cuda.empty_cache()
    from repro_torch.kernels.fp8_matmul.kernel import matmul_fp8_decode, matmul_fp8_wgmma
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    ragged_product_checks(torch, qparams, g)
    for K, N in ((1536, 256), (3072, 1536), (1536, 3072), (1536, 128), (1536, 50304)):
        timed = (K, N) in ((3072, 1536), (1536, 128), (1536, 50304))
        dec = MatmulCase(torch, g, SLOTS, K, N, timed=timed)
        check_matmul(torch, "fp8_matmul_decode", matmul_fp8_decode, dec, time_it=timed)
        if (K, N) == (3072, 1536):
            repeat_timing(torch, "fp8_matmul_decode", matmul_fp8_decode, dec)
        del dec
        if N != 50304:      # the LM head runs on the last token of each row only
            check_matmul(torch, "fp8_matmul_wgmma", matmul_fp8_wgmma,
                         MatmulCase(torch, g, 2 * SSM_LENS[0], K, N, timed=timed),
                         time_it=timed)
    head = qparams["embed"]["w_head"]
    x = torch.randn((SLOTS, head.shape[0]), generator=g, device="cuda").bfloat16()
    prof_ms, replay_ms = device_times(
        torch, [lambda: torch.matmul(x, head.dequantize().to(x.dtype))])
    log(f"ssm phase: the LM head's product by dequantize + torch.matmul (the path before "
        f"its block grid): {prof_ms:.4f} ms a decode step by the profiler, {replay_ms:.4f} "
        f"ms by CUDA events over a graph replay")
    same = torch.stack([r[:SSM_LENS[0]] for r in requests])
    breakdowns(torch, model, qparams, same, tree=f"{cfg.name} ")
    del qparams
    torch.cuda.empty_cache()
    ssm_small_agreement(torch, seed)


def routing_recorder(torch, sink: list, keep: bool = False):
    """Wrap ``repro_torch.models.moe.top_k_routing`` so each call appends
    ``(tokens, assignments dispatched)`` to ``sink`` (``keep``: the dispatch
    and combine tensors themselves); returns the function that restores
    the original."""
    from repro_torch.models import moe
    fn = moe.top_k_routing

    def wrapped(logits, top_k, capacity):
        out = fn(logits, top_k, capacity)
        tokens = logits.shape[0] * logits.shape[1]
        sink.append((tokens, out[0].sum(dtype=torch.float32)) if not keep
                    else (out[0].float().cpu(), out[1].float().cpu()))
        return out

    moe.top_k_routing = wrapped
    return lambda: setattr(moe, "top_k_routing", fn)


def moe_kernel_checks(torch, g) -> None:
    """The two tensor-core routes at the DeepSeek-V3 layer's widths (wq and
    wo [7168,7168], wk / wv [7168,896], the shared expert's [7168,2048] and
    [2048,7168], the dense prefix's w_gate / w_up [7168,18432] and w_down
    [18432,7168], the LM head [7168,129280]) at a decode step's M = 8 and a
    prefill's M = 512, and the sweep (11 candidates) and the quantizer at an
    expert's [7168,2048], each against its plain version and timed beside
    its bound and cuBLAS."""
    from repro_torch.kernels.fp8_matmul.kernel import matmul_fp8_decode, matmul_fp8_wgmma
    for K, N in ((7168, 7168), (7168, 896), (7168, 2048), (2048, 7168), (7168, 18432),
                 (18432, 7168), (7168, 129280)):
        for name, run, M in (("fp8_matmul_decode", matmul_fp8_decode, SLOTS),
                             ("fp8_matmul_wgmma", matmul_fp8_wgmma, 512)):
            check_matmul(torch, f"{name} (moe phase)", run, MatmulCase(torch, g, M, K, N),
                         time_it=True)
            torch.cuda.empty_cache()
    weights = delta_weights(torch, g)
    check_sweeps(torch, weights, None, None, cases=(((7168, 2048), 11, 128, 448.0, True),))
    check_quantizer(torch, weights, cases=(((7168, 2048), 128, True, 0),))


def stacked_dequantize_check(torch, qt) -> None:
    """The expert stack ``qt`` [1, 256, 7168, 2048] dequantized to bf16 in one
    copy and one in-place multiply (``qlinear.resolve_as``) against the
    per-matrix ``dequantize_stored`` in fp32, cast, at four experts: bit
    for bit."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.granularity import dequantize_stored
    from repro_torch.quant_runtime import qlinear
    one = qt.layer(0)
    got = qlinear.resolve_as(one, torch.bfloat16)
    bad = 0
    for e in (0, 1, 128, one.shape[0] - 1):
        want = dequantize_stored(one.data[e], one.scale[e], one.granularity,
                                 get_format(one.fmt), one.block_size, torch.float32)
        bad += int((got[e].view(torch.int16) != want.bfloat16().view(torch.int16)).sum())
    log(f"moe phase: the expert stack {list(one.shape)} dequantized to bf16 in one pass, "
        f"against the per-matrix fp32 dequantize cast: {bad} values differ at 4 experts "
        f"-> {'ok' if bad == 0 else 'FAIL'}")
    if bad:
        raise AssertionError("moe phase: the stacked dequantize differs from the per-matrix one")


def moe_small_agreement(torch, seed: int, device: str = "cuda", cfg=None, prompt: int = 32,
                        steps: int = 2, per_layer: int = 7, tol: float = 1e-3,
                        label: str = "small moe model") -> dict:
    """A small float32 MoE model (by default DeepSeek-V3-shaped: a
    dense-prefix layer and an MoE layer of 8 experts of 256, top-2, a shared
    expert; width 256, vocab 1,024; else ``cfg``, ``per_layer`` quantized
    products a layer) quantized once on the CPU at block 64 and run on the
    CPU and on ``device`` on fp32 activations (embedding rows fed straight
    in through the layer functions ``Model.prefill`` / ``decode_step`` run:
    bf16 activations would flip top-k choices between devices), every
    product on the tensor-core routes there (fp32 x as three stacked bf16
    parts: the prefill's 3 x 4 x ``prompt`` rows on wgmma, the LM heads'
    and decode steps' 3 x 4 on the decode route): a prefill of 4 x
    ``prompt`` tokens and ``steps`` greedy decode steps.  Every routing
    call's dispatch equal and its combine within 1 bf16 ulp; the last-token
    logits within ``tol`` of their scale; the greedy tokens equal where
    their top-2 margin exceeds it.  Returns the kernels' launches of the
    device run."""
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.core.policy import tree_map
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.models import build_model
    from repro_torch.models import lm as TL
    from repro_torch.models.common import apply_norm, lm_logits
    from repro_torch.quant_runtime import qlinear
    from repro_torch.quant_runtime.qparams import QuantizedTensor
    from repro_torch.quantize import quantize
    cfg = cfg or dataclasses.replace(get_arch("deepseek-v3"), n_layers=2, first_k_dense=1,
                                     d_model=256, n_heads=2, n_kv_heads=1, head_dim=128,
                                     d_ff=256, d_ff_dense=512, n_experts=8, top_k=2,
                                     vocab_size=1024, dtype="float32")
    B, S = 4, prompt
    m_cpu, m_dev = build_model(cfg, device="cpu"), build_model(cfg, device=device)
    g = torch.Generator().manual_seed(seed + 13)
    post = m_cpu.init(g)
    q_cpu, _ = quantize(post, make_base(torch, post, g),
                        QuantConfig(use_fused_kernel=True, block_size=64), mode="storage")
    q_dev = tree_map(lambda t: dataclasses.replace(t, data=t.data.to(device),
                                                   scale=t.scale.to(device))
                     if isinstance(t, QuantizedTensor) else t.to(device), q_cpu)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)

    def run(model, q, feed=None):
        """Last-token logits (on the CPU) of the prefill and of each decode
        step; the steps take ``feed``'s tokens, or the run's own greedy ones."""
        dev = model.device
        cache = model.init_cache(B, S + steps)
        x = qlinear.take(q["embed"]["embed"], toks.to(dev))
        out = []
        for step in range(steps + 1):
            lengths = torch.full((B,), S + step - 1, dtype=torch.int32, device=dev)
            for name, spec, n in model.groups:
                for i in range(n):
                    lp, lc = TL.layer_view(q[name]["L0"], i), TL.layer_view(cache[name]["L0"], i)
                    x = (TL.apply_layer_prefill(lp, x, lc, cfg, spec) if step == 0 else
                         TL.apply_layer_decode(lp, x, lc, lengths, cfg, spec))
            out.append(lm_logits(q["embed"], apply_norm(q["final_norm"], x[:, -1:],
                                                        cfg.norm_eps))[:, 0].float().cpu())
            nxt = out[-1].argmax(-1) if feed is None else feed[step]
            x = qlinear.take(q["embed"]["embed"], nxt[:, None].to(dev))
        return out

    rec_cpu, rec_dev = [], []
    restore = routing_recorder(torch, rec_cpu, keep=True)
    try:
        lc = run(m_cpu, q_cpu)
    finally:
        restore()
    restore = routing_recorder(torch, rec_dev, keep=True)
    for k in KERNELS:
        k.launches = 0
    try:
        ld = run(m_dev, q_dev, feed=[c.argmax(-1) for c in lc])
        sync(torch, device)
    finally:
        restore()
    launches = {k.name: k.launches for k in KERNELS}
    n_moe = sum(n for _, spec, n in m_cpu.groups if spec[1] == "moe")
    if len(rec_cpu) != len(rec_dev) or len(rec_cpu) != n_moe * (steps + 1):
        raise AssertionError(f"{label}: {len(rec_cpu)} / {len(rec_dev)} routing calls")
    for i, ((dc, cc), (dd, cd)) in enumerate(zip(rec_cpu, rec_dev)):
        ulp = torch.exp2(torch.floor(torch.log2(cc.abs().clamp_min(2.0 ** -126))) - 7)
        if not torch.equal(dc, dd) or not bool(((cd - cc).abs() <= ulp).all()):
            raise AssertionError(f"{label}: routing call {i} differs on {device}: "
                                 f"{int((dc != dd).any(-1).any(-1).sum())} tokens dispatched "
                                 f"differently")
    worst, held = 0.0, 0
    for step, (c, d) in enumerate(zip(lc, ld)):
        scale = float(c.abs().max())
        worst = max(worst, float((d - c).abs().max()) / scale)
        top = torch.topk(c, 2, dim=-1).values
        sure = (top[:, 0] - top[:, 1]) > tol * scale
        if not torch.equal(d.argmax(-1)[sure], c.argmax(-1)[sure]):
            raise AssertionError(f"{label}: greedy tokens differ at step {step}")
        held += int(sure.sum())
    # per_layer products a layer and the LM head, a forward
    n = per_layer * cfg.n_layers
    want = {"fp8_matmul_wgmma": n, "fp8_matmul_decode": 1 + (n + 1) * steps, "fp8_matmul": 0}
    log(f"{label} agreement ({device} vs CPU, fp32 activations, block 64, {S} prompt tokens "
        f"and {steps} steps): {len(rec_cpu)} routing calls dispatched equally; logits max "
        f"|dev - cpu| {worst:.3e} of their scale (tolerance {tol:g}); greedy tokens equal, "
        f"{held} of {B * (steps + 1)} above a {tol:g} margin; launches {json.dumps(launches)}")
    if worst > tol or held < B:
        raise AssertionError(f"{label}: logits disagree, or no token was held")
    if torch.device(device).type == "cuda" and (
            {k: launches[k] for k in want} != want
            or sum(launches.values()) != sum(want.values())):
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    return launches


def moe_serve(torch, records: dict, label: str, cfg, lens: tuple, gen: int, seeds: tuple,
              subtrees: tuple, want_leaves: list, want_n: int, per_layer: int, device: str):
    """Phases 7k and 7m's frame: ``cfg``'s model with bf16 weights drawn
    from ``seeds[0]``, quantized (DAQ, sign, E4M3, block 128) one subtree
    of ``subtrees`` at a time, each base made just before its quantize (the
    whole pair would not fit the card beside the fp8 tree), then 8 greedy
    requests of ``lens`` tokens (drawn from ``seeds[1]``) x ``gen`` through
    ``Engine(slots=8, k_steps=8)``, the counts zeroed just before the
    quantize and read just after the serve.  Asserted: the quantized leaves
    (``want_leaves``, ``want_n`` matrices: each expert of a stack one), one
    prefill call
    per prompt length, the sweep's and the quantizer's launches from the
    tree and the fp8 routes' by ``fp8_serve_launches`` at ``per_layer``
    products a layer (the router is fp32 and never quantized, the expert
    stacks are dequantized and multiplied by ``torch.matmul``, as the
    reference's are), the outputs' lengths and ranges, finite report
    metrics and no decode step dropping an assignment (its capacity of 8
    holds all 8 tokens); the launches go into ``records``.  Returns
    (model, qparams, requests, outputs, stats)."""
    from repro_torch.configs import QuantConfig
    from repro_torch.engine import Engine
    from repro_torch.kernels._lib import KERNELS
    from repro_torch.kernels.fp8_matmul.kernel import TC_MIN_ROWS
    from repro_torch.kernels.scale_search.kernel import sweep_plan
    from repro_torch.models import build_model
    from repro_torch.quantize import quantize

    cuda = torch.device(device).type == "cuda"
    if 2 >= TC_MIN_ROWS or SLOTS >= TC_MIN_ROWS:
        raise AssertionError("fp8_serve_launches counts a prefill's LM head and every decode "
                             f"product on the decode route: groups of 2 and SLOTS must stay "
                             f"below {TC_MIN_ROWS}")
    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    g = torch.Generator(device=model.device).manual_seed(seeds[0])
    post = model.init(g)
    sync(torch, device)
    log(f"{label}: post made in {time.perf_counter() - t0:.2f} s")
    gr = torch.Generator(device=model.device).manual_seed(seeds[1])
    requests = [torch.randint(0, cfg.vocab_size, (n,), generator=gr, device=model.device)
                for n in lens]
    qcfg = QuantConfig(use_fused_kernel=True)
    drops: list = []

    # ---- the family's path: counts zeroed just before, read just after ----
    for k in KERNELS:
        k.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    quant_s, parts, reports = 0.0, {}, []
    for keys in subtrees:
        sub = {k: post.pop(k) for k in keys}    # each base made just before its quantize
        base = make_base(torch, sub, g)
        sync(torch, device)
        t0 = time.perf_counter()
        q, rep = quantize(sub, base, qcfg, mode="storage")
        sync(torch, device)
        quant_s += time.perf_counter() - t0
        parts.update(q)
        reports.append(rep)
        del sub, base, q
    qparams = parts
    quant_peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    engine = Engine(model, qparams, slots=SLOTS, cache_len=max(lens) + gen, k_steps=K_STEPS)
    restore = routing_recorder(torch, drops)
    try:
        t0 = time.perf_counter()
        outputs, stats = engine.serve(requests, gen_tokens=gen, return_stats=True)
        sync(torch, device)
        serve_s = time.perf_counter() - t0
    finally:
        restore()
    launches = {k.name: k.launches for k in KERNELS}
    # ---- end of the family's path ----

    serve_peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    per_leaf = {k: v for r in reports for k, v in r.per_leaf.items()}
    n = sum(math.prod(v["shape"][:-2]) for v in per_leaf.values())
    log(f"{label}, quantize: {quant_s:.2f} s for {sum(r.n_quantized for r in reports)} "
        f"tensors, {n} leaf-matrices ({sum(r.original_bytes for r in reports) / 1e9:.2f} GB "
        f"bf16 -> {sum(r.quantized_bytes for r in reports) / 1e9:.2f} GB), peak "
        f"{quant_peak:.2f} GB; chosen-alpha hash {alpha_hash(per_leaf)}, code-and-scale hash "
        f"{code_hash(torch, qparams)}")
    dropped = {"prefill": [0, 0], "decode": [0, 0]}
    for tokens, kept in drops:
        side = dropped["decode" if tokens <= SLOTS else "prefill"]
        side[0] += tokens * cfg.top_k
        side[1] += tokens * cfg.top_k - int(kept)
    dec = stats["counters"]["tokens"]
    log(f"{label}, serve: {len(outputs)} requests of {list(lens)} prompt tokens x {gen} in "
        f"{serve_s:.2f} s ({SLOTS * gen / serve_s:.1f} tok/s end to end); "
        f"{stats['prefill_calls']} prefill calls in {stats['prefill_s']:.3f} s for "
        f"{stats['prefill_tokens']} prompt tokens; decode {dec} tokens in "
        f"{stats['decode_s']:.3f} s = {dec / stats['decode_s']:.1f} tok/s "
        f"({stats['decode_s'] / stats['decode_steps'] * 1e3:.2f} ms a step of {SLOTS} slots); "
        f"cache {stats['cache_bytes'] / 1e9:.3f} GB; peak {serve_peak:.2f} GB; assignments "
        f"dropped by capacity: prefill {dropped['prefill'][1]} of {dropped['prefill'][0]}, "
        f"decode {dropped['decode'][1]} of {dropped['decode'][0]}; launches "
        f"{json.dumps(launches)}")
    if sorted(per_leaf) != sorted(want_leaves) or n != want_n:
        raise AssertionError(f"{label}: quantized leaves {sorted(per_leaf)} ({n} "
                             f"leaf-matrices), expected {sorted(want_leaves)} ({want_n})")
    passes = len(sweep_plan(1 + qcfg.n_coarse)) + len(sweep_plan(1 + qcfg.n_fine))
    want = {"scale_search": passes * n, "fp8_quant": n,
            **fp8_serve_launches(stats, cfg.n_layers, per_layer)}
    if stats["prefill_calls"] != len(set(lens)):
        raise AssertionError(f"{label}: {stats['prefill_calls']} prefill calls, expected "
                             f"one per prompt length ({len(set(lens))})")
    for name, w in want.items():
        if launches[name] != w:
            raise AssertionError(f"{label}: {name} launched {launches[name]} times, "
                                 f"expected {w}")
    for out in outputs:
        if len(out) != gen or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"{label}: bad output row {out[:8]}... ({len(out)} tokens)")
    for r in reports:
        for side in (r.global_chosen, r.global_default):
            if not all(math.isfinite(v) for v in side.values()):
                raise AssertionError(f"{label}: non-finite report metrics {side}")
        leaf_sign_rates_hold(r, label)
    if dropped["decode"][1]:
        raise AssertionError(f"{label}: a decode step dropped an assignment (its capacity of "
                             f"8 holds all {SLOTS} tokens)")
    for name, k in launches.items():
        if name in records:
            records[name]["launches"] += k
    log(f"{label}: launches asserted ({json.dumps(want)}); first row {outputs[0][:12]}...")
    return model, qparams, requests, outputs, stats


def moe_phase(torch, records: dict, seed: int, device: str = "cuda") -> None:
    """Phase 7k: DeepSeek-V3 at full width cut to ``MOE_LAYERS`` layers,
    quantized in two subtrees and served through the port's entry points
    (``moe_serve``), then on the paged engines; the kernels' launches of the
    quantize and the serves go into ``records``."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cuda = torch.device(device).type == "cuda"
    cfg = dataclasses.replace(get_arch("deepseek-v3"), n_layers=MOE_LAYERS)
    log(f"moe phase: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
        f"head_dim={cfg.resolved_head_dim} experts={cfg.n_experts} x d_ff {cfg.d_ff} top-"
        f"{cfg.top_k} + {cfg.n_shared_experts} shared, dense prefix {cfg.first_k_dense} x "
        f"d_ff {cfg.d_ff_dense}, vocab={cfg.vocab_size}, layers={cfg.n_layers} of 61 "
        f"({cfg.param_count() / 1e9:.3f} B params)")
    experts = [f"stack/L0/moe/{w}" for w in ("w_down", "w_gate", "w_up")]
    leaves = ["embed/embed", "embed/w_head", *experts,
              *(f"stack/L0/moe/shared/{w}" for w in ("w_down", "w_gate", "w_up")),
              *(f"{grp}/L0/attn/{w}" for grp in ("prefix", "stack")
                for w in ("wk", "wo", "wq", "wv")),
              *(f"prefix/L0/mlp/{w}" for w in ("w_down", "w_gate", "w_up"))]
    model, qparams, requests, outputs, stats = moe_serve(
        torch, records, "moe phase", cfg, MOE_LENS, MOE_GEN, (seed + 12, seed + 14),
        (("embed", "final_norm", "prefix"), ("stack",)), leaves,
        2 + 7 * cfg.first_k_dense + (7 + 3 * cfg.n_experts) * (MOE_LAYERS - cfg.first_k_dense),
        7, device)
    # the quantize took the bf16 tree apart: the speculative serve's
    # verifier is made again from its seed (the same weights), after the
    # fp8 serves; the rest runs at the least dropless capacity factor
    dropless = build_model(dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k),
                           device=device)
    family_paged_phase(torch, records, "moe phase", model, qparams,
                       lambda: model.init(torch.Generator(device=model.device)
                                          .manual_seed(seed + 12)),
                       requests, outputs, max(MOE_LENS) + MOE_GEN, per_layer=7,
                       chunk=MOE_CHUNK, dropless=dropless)
    if cuda:
        torch.cuda.empty_cache()
    if not cuda:
        return

    stacked_dequantize_check(torch, qparams["stack"]["L0"]["moe"]["w_gate"])
    torch.cuda.empty_cache()
    same = torch.stack([r[:PROMPT] for r in requests])
    breakdowns(torch, model, qparams, same, tree=f"{cfg.name} ({MOE_LAYERS} layers) ")
    del qparams
    torch.cuda.empty_cache()
    moe_kernel_checks(torch, torch.Generator(device="cuda").manual_seed(seed + 15))
    torch.cuda.empty_cache()
    for name, n in moe_small_agreement(torch, seed).items():
        records[name]["launches"] += n


def swa_kernel_checks(torch, g) -> None:
    """The two tensor-core routes at Mixtral 8x22B's widths (wq and wo
    [6144,6144], wk / wv [6144,1024], the LM head [6144,32768]) at a decode
    step's M = 8 and a prefill's M = 512, and the sweep (11 candidates) and
    the quantizer at an expert's [6144,16384], each against its plain
    version and timed beside its bound and cuBLAS."""
    from repro_torch.kernels.fp8_matmul.kernel import matmul_fp8_decode, matmul_fp8_wgmma
    for K, N in ((6144, 6144), (6144, 1024), (6144, 32768)):
        for name, run, M in (("fp8_matmul_decode", matmul_fp8_decode, SLOTS),
                             ("fp8_matmul_wgmma", matmul_fp8_wgmma, 512)):
            check_matmul(torch, f"{name} (swa phase)", run, MatmulCase(torch, g, M, K, N),
                         time_it=True)
            torch.cuda.empty_cache()
    weights = delta_weights(torch, g)
    check_sweeps(torch, weights, None, None, cases=(((6144, 16384), 11, 128, 448.0, True),))
    check_quantizer(torch, weights, cases=(((6144, 16384), 128, True, 0),))


def swa_small_agreement(torch, seed: int, device: str = "cuda") -> dict:
    """``moe_small_agreement`` on a small float32 Mixtral-shaped model (two
    layers of 8 experts of 256, top-2, width 256, vocab 1,024) with a
    sliding window of 16: a 20-token prompt and 40 greedy decode steps, so
    the ring wraps three times.  Over 40 steps a device difference that
    moves an expert output across a bf16 rounding boundary before the
    combine (one bf16 ulp, 2^-8 of that element) reaches the logits, so
    they are held to 4e-3 of their scale, not the 2-step check's 1e-3 (on
    an H100 at 700 W the worst of the 41 readings was 1.69e-3).  Returns
    the kernels' launches of the device run."""
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch("mixtral-8x22b"), n_layers=2, d_model=256, n_heads=2,
                              n_kv_heads=1, head_dim=128, d_ff=256, n_experts=8, top_k=2,
                              vocab_size=1024, sliding_window=16, dtype="float32")
    return moe_small_agreement(torch, seed, device, cfg=cfg, prompt=20, steps=40, per_layer=4,
                               tol=4e-3, label="small sliding-window model")


def ring_agreement(torch, model, qparams, requests, outputs) -> None:
    """The ring against a one-shot prefill at full width, on ``model`` at a
    dropless capacity factor (a token's experts are then its top-2 choices,
    never a capacity drop): the pair of ``SWA_LENS``' shortest prompts
    prefilled into the ring, then teacher-forced through their served
    tokens by decode steps, so the ring wraps mid-decode; one more decode
    step's logits against the last-token logits of a one-shot prefill of
    the whole sequence, within the bf16 rule (2e-2 of the logit scale) for
    each request whose recorded top-2 routing (every layer) agrees between
    the two forwards, as the reference's ring test holds it (a flip at a
    narrow router margin moves the logits past any tolerance)."""
    L = min(SWA_LENS)
    rows = [i for i, r in enumerate(requests) if r.shape[0] == L]
    toks = torch.stack([torch.cat([requests[i], torch.tensor(outputs[i], dtype=requests[i].dtype,
                                                             device=requests[i].device)])
                        for i in rows])
    T = toks.shape[1] - 1                 # the step under test reads position T
    W = model.cfg.sliding_window
    rec_step, rec_full = [], []
    _, cache = model.prefill(qparams, {"tokens": toks[:, :L]}, cache_len=T + 1)
    if cache["stack"]["L0"]["k"].shape[2] != W or not L < W < T:
        raise AssertionError(f"swa phase: the ring check's cache or positions ({L}, {T}) do "
                             f"not cross the window {W}")
    for t in range(L, T):
        _, cache = model.decode_step(qparams, toks[:, t:t + 1], cache)
    restore = routing_recorder(torch, rec_step, keep=True)
    try:
        step, _ = model.decode_step(qparams, toks[:, T:T + 1], cache)
    finally:
        restore()
    del cache
    restore = routing_recorder(torch, rec_full, keep=True)
    try:
        full, _ = model.prefill(qparams, {"tokens": toks}, cache_len=T + 1)
    finally:
        restore()
    step, full = step.float().cpu(), full.float().cpu()
    B, S = toks.shape
    agree = torch.ones(B, dtype=torch.bool)
    for (ds, _), (df, _) in zip(rec_step, rec_full):
        chosen_step = ds.amax(-1).reshape(B, -1)                    # [B, E] the experts
        chosen_full = df.amax(-1).reshape(B, S, -1)[:, -1]
        agree &= (chosen_step == chosen_full).all(-1)
    rel = ((step - full).abs().amax(-1) / full.abs().amax(-1)).tolist()
    log(f"swa phase, ring check: {B} requests of {L} prompt tokens and {T - L} decode steps "
        f"(the ring of {W} rows wrapped at {W}); the step at position {T} against a one-shot "
        f"prefill of {T + 1} tokens: max |step - prefill| / max |prefill| "
        f"{', '.join(f'{r:.3e}' for r in rel)}; routing agrees on {int(agree.sum())} of {B}")
    if len(rec_step) != model.cfg.n_layers or len(rec_full) != model.cfg.n_layers:
        raise AssertionError("swa phase, ring check: a routing call was not recorded")
    bad = [r for r, a in zip(rel, agree.tolist()) if a and r > 2e-2]
    if bad:
        raise AssertionError(f"swa phase, ring check: the ring's logits differ from the one-shot "
                             f"prefill's by {bad} of their scale where routing agrees")


def swa_phase(torch, records: dict, seed: int, device: str = "cuda") -> None:
    """Phase 7m: Mixtral 8x22B (sliding window 4,096) at full width cut to
    ``SWA_LAYERS`` layers, quantized in two subtrees and served through the
    port's entry points with ring caches (``moe_serve``), then on the paged
    engines; the kernels' launches of the quantize and the serves go into
    ``records``."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cuda = torch.device(device).type == "cuda"
    cfg = dataclasses.replace(get_arch("mixtral-8x22b"), n_layers=SWA_LAYERS)
    W = cfg.sliding_window
    # the requests cross the ring every way
    if not (min(SWA_LENS) < W < min(SWA_LENS) + SWA_GEN and W in SWA_LENS
            and sum(n > W for n in SWA_LENS) >= 2):
        raise AssertionError(f"swa phase: prompt lengths {SWA_LENS} do not wrap the window {W} "
                             f"mid-decode, at the first decode write and in the prefill")
    log(f"swa phase: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
        f"head_dim={cfg.resolved_head_dim} experts={cfg.n_experts} x d_ff {cfg.d_ff} top-"
        f"{cfg.top_k}, sliding window {W}, vocab={cfg.vocab_size}, rope theta "
        f"{cfg.rope_theta:g}, layers={cfg.n_layers} of 56 ({cfg.param_count() / 1e9:.3f} B "
        f"params)")
    leaves = ["embed/embed", "embed/w_head",
              *(f"stack/L0/attn/{w}" for w in ("wk", "wo", "wq", "wv")),
              *(f"stack/L0/moe/{w}" for w in ("w_down", "w_gate", "w_up"))]
    # a layer's four attention products on the fp8 routes
    model, qparams, requests, outputs, stats = moe_serve(
        torch, records, "swa phase", cfg, SWA_LENS, SWA_GEN, (seed + 16, seed + 17),
        (("embed", "final_norm"), ("stack",)), leaves,
        2 + (4 + 3 * cfg.n_experts) * cfg.n_layers, 4, device)
    ring_bytes = cfg.n_layers * 2 * SLOTS * W * cfg.n_kv_heads * cfg.resolved_head_dim * 2 \
        + SLOTS * 4
    if stats["cache_bytes"] != ring_bytes:
        raise AssertionError(f"swa phase: the cache holds {stats['cache_bytes']} bytes, not a "
                             f"ring of {W} rows ({ring_bytes})")
    # the ring check and the paged engines after (1) run at the least
    # dropless capacity factor; the quantize took the bf16 tree apart, so
    # the speculative serve's verifier is made again from its seed (the
    # same weights), after the fp8 serves
    dropless = build_model(dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k),
                           device=device)
    ring_agreement(torch, dropless, qparams, requests, outputs)
    if cuda:
        torch.cuda.empty_cache()
    family_paged_phase(torch, records, "swa phase", model, qparams,
                       lambda: model.init(torch.Generator(device=model.device)
                                          .manual_seed(seed + 16)),
                       requests, outputs, max(SWA_LENS) + SWA_GEN, per_layer=4,
                       chunk=SWA_CHUNK, dropless=dropless)
    del qparams
    if not cuda:
        return
    torch.cuda.empty_cache()
    swa_kernel_checks(torch, torch.Generator(device="cuda").manual_seed(seed + 18))
    torch.cuda.empty_cache()
    for name, n in swa_small_agreement(torch, seed).items():
        records[name]["launches"] += n


def family_paged_phase(torch, records: dict, label: str, model, qparams, make_post, requests,
                       contiguous: list, cache_len: int, per_layer: int, chunk: int,
                       dropless=None) -> None:
    """A family's paged engines (phases 7j, 7k): ``requests`` through

    * (1) the paged engine (``check_invariants=True``, as every serve here),
      ``qparams`` at the model's own config: the contiguous serve's first
      ``FAMILY_GEN`` tokens (``contiguous``), token for token;
    * (2) for MoE, the one-shot paged engine at the least dropless capacity
      (``dropless``, the model the rest runs);
    * (3) the chunked engine (``chunk`` rows a slot a piece), its first
      chunked dispatch under ``set_sync_debug_mode("error")``: first
      tokens equal to the one-shot serve's ((1), or (2) for MoE);
    * (4) the prefix-cached engine, cold then warm: MoE shares blocks (warm
      hits > 0, fewer prompt tokens prefilled, warm == cold token for
      token); an SSM stack's state is recurrent and a ring's blocks are
      keyed by position, so those share none (zero hits both times, every
      prompt token prefilled, each serve == the chunked one token for
      token: the same pieces in the same order);
    * (5) the bf16 tree (``make_post()``, the tree ``qparams`` quantizes)
      on the paged engine, then verifying a DAQ draft (``qparams``) with
      ``n_spec=N_SPEC``: first tokens equal (the same bf16 prefill), the
      acceptance rate printed.

    Every engine takes the contiguous serve's ``cache_len``, so a paged
    decode step's softmax spans as many rows as the contiguous one's (on
    the card a longer or shorter table changes the reduction's rounding:
    on an H100, 7k's paged tokens at 528 rows against the contiguous
    serve's 544 were 93 of 128 equal).
    Every serve: lengths and token ranges, the counters' block
    conservation (``check_invariants`` after every admission and dispatch;
    held before + popped - released == held by the index after), drafted
    == accepted + rejected, and the fp8 routes' launches by formula
    (``per_layer`` products a layer: ``fp8_serve_launches``,
    ``fp8_chunked_launches``, ``fp8_spec_launches``; none of the bf16
    serve), added to ``records``.  The agreement of (3) with (1) or (2)
    and of (5) with its bf16 serve is printed: on the card a chunk piece's
    and a verify's products see other row counts than a one-shot prefill's
    and a decode step's (PERF.md, decision b).  On the card one speculative
    dispatch runs under ``set_sync_debug_mode("error")`` and one paged
    decode step and one speculative round are broken down."""
    from repro_torch.engine import Engine
    cuda = model.device.type == "cuda"
    gen, L = FAMILY_GEN, model.cfg.n_layers
    kw = dict(slots=SLOTS, cache_len=cache_len, k_steps=K_STEPS, paged=True, block_size=BLOCK,
              check_invariants=True)
    first16 = [o[:gen] for o in contiguous]
    t_phase = time.perf_counter()

    def serve(name, engine):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        held0 = len(engine._hold_blocks)
        outputs, stats, launches, secs = counted_serve(torch, engine, requests, gen)
        ctr = stats["counters"]
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
        line = (f"{label}, {name}: {secs:.2f} s, {len(requests) * gen / secs:.1f} tok/s end to "
                f"end; {stats['prefill_calls']} admissions, {stats['dispatches']} dispatches "
                f"({stats.get('chunk_dispatches', 0)} chunked), {stats['prefill_tokens']} "
                f"prompt tokens prefilled, {stats.get('prefix_hits', 0)} prefix-hit tokens; "
                f"{ctr['tokens']} tokens through the dispatches in {stats['decode_s']:.3f} s; "
                f"peak {peak:.2f} GB")
        if engine.cfg.n_spec:
            line += (f"; acceptance {stats['draft_accepted']} of {stats['draft_tokens']} "
                     f"drafted ({stats['draft_accepted'] / max(stats['draft_tokens'], 1):.4f}), "
                     f"final depth {stats['spec_depth']}")
        log(f"{line}; counters {json.dumps(ctr)}; launches {json.dumps(launches)}")
        for out in outputs:
            if len(out) != gen or not all(0 <= t < model.cfg.vocab_size for t in out):
                raise AssertionError(f"{label}, {name}: bad output row {out[:8]}... "
                                     f"({len(out)} tokens)")
        if held0 + ctr["blocks_popped"] - ctr["blocks_released"] != len(engine._hold_blocks):
            raise AssertionError(f"{label}, {name}: {held0} held before + popped "
                                 f"{ctr['blocks_popped']} - released {ctr['blocks_released']} "
                                 f"!= {len(engine._hold_blocks)} held by the index")
        if ctr["drafted"] != ctr["accepted"] + ctr["rejected"] \
                or (engine.cfg.n_spec and ctr["drafted"] <= 0):
            raise AssertionError(f"{label}, {name}: drafted {ctr['drafted']} != accepted "
                                 f"{ctr['accepted']} + rejected {ctr['rejected']}")
        want = dict.fromkeys(launches, 0)
        if engine.cfg.n_spec:
            want.update(fp8_spec_launches(stats, L, per_layer))
        elif engine.params is qparams:
            want.update(fp8_chunked_launches(stats, L, per_layer) if engine.cfg.chunk_size
                        else fp8_serve_launches(stats, L, per_layer))
        if launches != want:
            raise AssertionError(f"{label}, {name}: launches {launches}, expected {want}")
        for k, n in launches.items():
            if k in records:
                records[k]["launches"] += n
        return outputs, stats

    paged_eng = Engine(model, qparams, **kw)
    paged, _ = serve("(1) paged", paged_eng)
    log(f"{label}: (1) paged vs the contiguous serve's first {gen} tokens: "
        f"{agreement(paged, first16)}")
    if paged != first16:
        raise AssertionError(f"{label}: the paged serve's tokens differ from the contiguous "
                             f"engine's")
    m, ref = model, paged
    if dropless is not None:
        m = dropless
        ref, _ = serve(f"(2) one-shot paged, capacity_factor {m.cfg.capacity_factor:g}",
                       Engine(m, qparams, **kw))
    chunked_eng = Engine(m, qparams, chunk_size=chunk, **kw)
    ran = first_chunked_dispatch_under_error_mode(torch, chunked_eng) if cuda else [True]
    chunked, cst = serve(f"(3) chunked, {chunk} rows a slot a piece", chunked_eng)
    if not ran:
        raise AssertionError(f"{label}: no chunked dispatch ran under the sync debug mode")
    log(f"{label}: (3) chunked vs {'(2)' if dropless is not None else '(1)'}: "
        f"{agreement(chunked, ref)}")
    if [o[0] for o in chunked] != [o[0] for o in ref]:
        raise AssertionError(f"{label}, (3): first tokens differ from the one-shot serve's")
    pe = Engine(m, qparams, chunk_size=chunk, prefix_cache=True, **kw)
    cold, cs = serve("(4) prefix-cached, cold", pe)
    warm, ws = serve("(4) prefix-cached, warm", pe)
    log(f"{label}: (4) warm vs cold: {agreement(warm, cold)}; prompt tokens prefilled "
        f"{cs['prefill_tokens']} cold, {ws['prefill_tokens']} warm; prefix hits "
        f"{cs['prefix_hits']} / {ws['prefix_hits']}")
    for name, st in (("cold", cs), ("warm", ws)):
        if st["counters"]["prefix_hit_tokens"] != st["prefix_hits"]:
            raise AssertionError(f"{label}, (4) {name}: prefix-hit tokens "
                                 f"{st['counters']['prefix_hit_tokens']} on the device, "
                                 f"{st['prefix_hits']} on the host")
    if pe._can_match:
        if not (ws["prefix_hits"] > 0 and ws["prefill_tokens"] < cs["prefill_tokens"]):
            raise AssertionError(f"{label}, (4): the warm serve hit no cached block")
        if warm != cold:
            raise AssertionError(f"{label}, (4): the warm serve's tokens differ from the cold "
                                 f"one's")
    else:
        total = sum(int(r.shape[0]) for r in requests)
        if cs["prefix_hits"] or ws["prefix_hits"] or pe._hold_blocks \
                or cs["prefill_tokens"] != total or ws["prefill_tokens"] != total:
            raise AssertionError(f"{label}, (4): an unshared stack shared a prompt block")
        if cold != chunked or warm != chunked:
            raise AssertionError(f"{label}, (4): the unshared prefix-cached serves' tokens "
                                 f"differ from the chunked serve's")
    del paged_eng, chunked_eng, pe
    post = make_post()
    base_eng = Engine(m, post, **kw)
    base, _ = serve("(5) bf16 paged", base_eng)
    spec_eng = Engine(m, post, draft_params=qparams, n_spec=N_SPEC, **kw)
    spec, ss = serve(f"(5) speculative, n_spec {N_SPEC}, DAQ-fp8 draft, bf16 verifier", spec_eng)
    log(f"{label}: (5) speculative vs bf16 paged: {agreement(spec, base)}; acceptance rate "
        f"{ss['draft_accepted'] / max(ss['draft_tokens'], 1):.4f}")
    if [o[0] for o in spec] != [o[0] for o in base]:
        raise AssertionError(f"{label}, (5): first tokens differ from the bf16 serve's")
    log(f"{label}: paged engines took {time.perf_counter() - t_phase:.1f} s")
    del base_eng
    if not cuda:
        return
    spec_dispatch_under_error_mode(torch, spec_eng, requests)
    log(f'{label}: one speculative dispatch ran under set_sync_debug_mode("error")')
    family_breakdowns(torch, label, Engine(model, qparams, **kw), spec_eng, requests)


def family_breakdowns(torch, label: str, paged_eng, spec_eng, requests) -> None:
    """One paged decode step (``decode_step_paged`` of the fp8 tree,
    ``BREAKDOWN_STEPS`` of them) and one speculative round (a one-round
    dispatch of ``spec_eng``, its draft and verify) at each engine's first
    admission of the 8 requests: host ms, device busy ms, launches, idle
    share."""
    from repro_torch.engine.scheduler import make_decode_dispatch
    model = paged_eng.model
    cache, state, _ = admitted(torch, paged_eng, requests)

    def decode():
        nonlocal cache
        for _ in range(BREAKDOWN_STEPS):
            _, cache = model.decode_step_paged(paged_eng.params, state["cur"], cache)
        torch.cuda.synchronize()

    device_breakdown(torch, f"{label} paged decode ({BREAKDOWN_STEPS} steps of {SLOTS} slots, "
                     f"fp8 tree)", decode, BREAKDOWN_STEPS, "step")
    del cache, state
    cache0, state0, g = admitted(torch, spec_eng, requests)
    one_round = make_decode_dispatch(spec_eng.model, spec_eng.cfg.sampling, 1, paged=True,
                                     n_spec=N_SPEC)
    depth = torch.full((), N_SPEC, dtype=torch.int32, device=model.device)

    def round_():
        one_round(spec_eng.params, spec_eng.draft_params, clone_tree(state0),
                  clone_tree(cache0), depth, g)
        torch.cuda.synchronize()

    device_breakdown(torch, f"{label} speculative round (n_spec {N_SPEC}, DAQ draft, bf16 "
                     f"verify, {SLOTS} slots)", round_, 1, "round")
    del cache0, state0
    torch.cuda.empty_cache()


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def device_breakdown(torch, label: str, run, per: int, unit: str, top: int = 8,
                     always: tuple[str, ...] = ()) -> dict:
    """Host time of ``run()`` (which ends in a synchronize) without the
    profiler, then one ``torch.profiler`` window over another ``run()`` for
    the device's busy time, its kernel launches and the kernels by time
    (the ``top`` ones, and every one whose name holds a string of
    ``always``); everything per ``unit`` (``run`` does ``per`` of them).
    ``run`` is called three times (a warm-up first).  Returns the per-unit
    ``host_ms``, ``busy_ms`` and ``launches`` (the last two when the
    profiler saw the device)."""
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
        return {"host_ms": host_ms}
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
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    for i, (name, (n, t)) in enumerate(ranked):
        if i < top or any(a in name for a in always):
            log(f"  {t / per:8.3f} ms/{unit}  {n / per:6.0f} launches/{unit}  {name[:90]}")
    return {"host_ms": host_ms, "busy_ms": busy_ms, "launches": n_launch}


def breakdowns(torch, model, qparams, prompts, steps: int = BREAKDOWN_STEPS, tree: str = "",
               prefill: bool = True) -> None:
    """Where a decode step and (with ``prefill``) a prefill of the fp8 model
    ``qparams`` go; ``tree`` names it in the lines (phase 5's by default)."""
    _, cache = model.prefill(qparams, {"tokens": prompts}, cache_len=PROMPT + 3 * steps)
    tok = prompts[:, :1]

    def decode():
        nonlocal cache
        for _ in range(steps):
            _, cache = model.decode_step(qparams, tok, cache)
        torch.cuda.synchronize()

    device_breakdown(torch, f"{tree}decode ({steps} steps of {prompts.shape[0]} slots)",
                     decode, steps, "step")
    del cache
    if not prefill:
        return

    def prefill():
        model.prefill(qparams, {"tokens": prompts})
        torch.cuda.synchronize()

    device_breakdown(torch, f"{tree}prefill ({prompts.shape[0]} x {prompts.shape[1]} tokens)",
                     prefill, 1, "prefill")


def paged_breakdown(torch, phase: dict, steps: int = BREAKDOWN_STEPS) -> None:
    """One ``decode_step_paged`` at the parity run's state (its first
    admission: 8 slots, ``cache_len`` 560, 280 blocks of 16) beside one
    contiguous ``decode_step`` at the same state and ``cache_len``: host ms,
    device busy ms and launches per step."""
    requests = phase["requests"]
    for name, method in (("contiguous", "decode_step"), ("parity", "decode_step_paged")):
        engine = phase["engines"][name]
        cache, state, _ = admitted(torch, engine, requests)
        step = getattr(engine.model, method)

        def decode():
            nonlocal cache
            for _ in range(steps):
                _, cache = step(engine.params, state["cur"], cache)
            torch.cuda.synchronize()

        label = "paged" if engine.cfg.paged else "contiguous"
        device_breakdown(torch, f"{label} decode at cache_len {PAGED_CACHE_LEN} ({steps} "
                         f"steps of {engine.cfg.slots} slots, {method})", decode, steps, "step")
        del cache, state
        torch.cuda.empty_cache()


def leaf_layers(report) -> int:
    """Matrices the quantize searched: a stacked leaf [L, I, O] counts L, an
    expert stack [L, E, I, O] L x E."""
    return sum(math.prod(leaf["shape"][:-2]) for leaf in report.per_leaf.values())


def alpha_hash(per_leaf: dict) -> str:
    """sha256 (first 16 hex digits) of every leaf's chosen alphas (float32,
    leaves by name; ``per_leaf`` as a quantize report holds it): the sign
    metric's argmax reads integer counts, so a correct sweep reproduces a
    tree's alphas exactly."""
    h = hashlib.sha256()
    for name in sorted(per_leaf):
        h.update(name.encode())
        h.update(per_leaf[name]["alpha"].astype("float32").tobytes())
    return h.hexdigest()[:16]


HASH_MUL = 0x9E3779B97F4A7C15 - (1 << 64)   # odd: 2^64 / golden ratio, as int64


def weighted_sum(torch, flat, *, codes: bool = False, chunk: int = 1 << 26) -> int:
    """Sum, modulo 2^64, of each element of the 1-D integer tensor ``flat``
    times the odd 64-bit weight (2 p + 1) * ``HASH_MUL`` of its position p,
    computed on its device (int64 products and sums wrap).  Two elements
    that change places change the sum by (a - b) * 2 (p - q) * HASH_MUL,
    which is not 0 modulo 2^64 for |a - b| < 2^32 and |p - q| < 2^31: a
    permutation does not cancel.  ``codes``: E4M3 codes, a NaN (0x7F or
    0xFF: its sign is not defined) counted as 0x7F."""
    total = 0
    for start in range(0, flat.numel(), chunk):
        c = flat[start:start + chunk].to(torch.int64)
        if codes:
            c = torch.where((c & 0x7F) == 0x7F, 0x7F, c)
        pos = torch.arange(start, start + c.numel(), device=c.device, dtype=torch.int64)
        total += int((c * (pos * 2 + 1).mul_(HASH_MUL)).sum())
    return total % (1 << 64)


def code_hash(torch, qparams) -> str:
    """sha256 (first 16 hex digits) over every quantized leaf (by path) of
    the position-weighted sums (``weighted_sum``) of its fp8 codes and of
    its scales' bits, computed on the card: the full-width codes are 9.4 GB."""
    from repro_torch.core.policy import tree_leaves_with_path
    h = hashlib.sha256()
    for path, leaf in tree_leaves_with_path(qparams):
        if not hasattr(leaf, "granularity"):
            continue
        h.update("/".join(path).encode())
        for part, codes in ((leaf.data.view(torch.uint8).reshape(-1), True),
                            (leaf.scale.contiguous().view(torch.int32).reshape(-1), False)):
            h.update(weighted_sum(torch, part, codes=codes).to_bytes(8, "little"))
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
    device_breakdown(torch, f"quantize ({layers} layers)", run, n, "leaf-layer", top=12,
                     always=("quant_tile_kernel", "quant_general_kernel"))
    del post, base
    torch.cuda.empty_cache()


def tree_readings(torch, layers: int = 40, seed: int = 0) -> None:
    """What must not change between two trees, and the quantizer's time, for
    the ``repro_torch`` first on ``sys.path``: phase 5's two hashes of a
    quantize of the model this script's ``make_weights`` makes, and the
    quantizer's device time (``device_ms``) at [4096,13696] and the LM head.
    To compare another tree in one call, import this script with that tree's
    ``src`` first on ``sys.path`` (see ``.claude/skills/verify/SKILL.md``)."""
    import repro_torch
    from repro_torch.configs import QuantConfig, get_arch
    from repro_torch.kernels import _lib
    from repro_torch.kernels.fp8_quant.kernel import quantize_fp8_cuda
    from repro_torch.models import build_model
    from repro_torch.quantize import quantize
    _lib.build_all()
    where = Path(repro_torch.__file__).resolve().parent
    alpha = torch.tensor([1.0375], device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    for I, O in ((4096, 13696), (4096, 151552)):
        w = torch.randn((I, O), generator=g, device="cuda") * 0.02
        log(f"quantizer of {where} [{I},{O}]: "
            f"{device_ms(torch, [lambda: quantize_fp8_cuda(w, alpha, block=128)]):.4f} ms "
            f"device time")
        del w
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_arch("glm4-9b"), n_layers=layers)
    post, base = make_weights(torch, build_model(cfg), seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams, report = quantize(post, base, QuantConfig(use_fused_kernel=True), mode="storage")
    torch.cuda.synchronize()
    log(f"quantize with {where}: {time.perf_counter() - t0:.2f} s; chosen-alpha hash "
        f"{alpha_hash(report.per_leaf)}, code-and-scale hash {code_hash(torch, qparams)} over "
        f"{leaf_layers(report)} leaf-layers")


def route_readings(torch, seed: int = 0) -> None:
    """The tensor-core routes' cold device times at the main path's shapes
    (bf16, block 128: decode at M = 8 [4096,13696] and the LM head, wgmma
    at M = 1,024 [4096,13696]) and a hash of their outputs, for the
    ``repro_torch`` first on ``sys.path``: import this script with another
    tree's ``src`` first to time both trees' kernels in one call (see
    ``.claude/skills/verify/SKILL.md``).  ``main`` does not call it."""
    import repro_torch
    from repro_torch.kernels.fp8_matmul.kernel import matmul_fp8_decode, matmul_fp8_wgmma
    where = Path(repro_torch.__file__).resolve().parent
    g = torch.Generator(device="cuda").manual_seed(seed)
    for name, run, M, (K, N) in (("decode", matmul_fp8_decode, SLOTS, (4096, 13696)),
                                 ("wgmma", matmul_fp8_wgmma, SLOTS * PROMPT, (4096, 13696)),
                                 ("decode", matmul_fp8_decode, SLOTS, (4096, 151552))):
        case = MatmulCase(torch, g, M, K, N)
        y = run(case.x, *case.w[0])
        digest = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
        log(f"route readings of {where}: {name} M={M} [{K},{N}] "
            f"{device_ms(torch, case.calls(run)):.5f} ms device time, output hash {digest}")
        del case, y
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=40,
                    help="model depth (default: GLM-4-9B's 40)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_script = time.perf_counter()

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
    sass = build_and_report()

    # 3. kernels vs plain versions
    t0 = time.perf_counter()
    records = check_kernels(torch, args.seed, sass, clock_mhz)
    log(f"kernel checks passed in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    small_model_agreement(torch, args.seed)
    fp32_model_agreement(torch, args.seed)
    odd = odd_block_agreement(torch, args.seed)
    log(f"small-model checks in {time.perf_counter() - t0:.1f} s")
    # the CUDA-core kernel's path is a tree quantized at a block that is not a
    # multiple of 16 (no serve of the main path reaches it): counted there
    records["fp8_matmul"]["launches"] = odd["fp8_matmul"]
    model, post, qparams, prompts, daq_outputs, base_state = main_path(torch, args, records)
    t0 = time.perf_counter()
    phase = paged_phase(torch, args, model, qparams)
    log(f"paged phase passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    prefix_phase(torch, args, *first_layers(model, min(PREFIX_LAYERS, args.layers), qparams))
    log(f"prefix phase ({min(PREFIX_LAYERS, args.layers)} layers) passed in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    spec = spec_phase(torch, args, *first_layers(model, min(SPEC_LAYERS, args.layers), post,
                                                 qparams), prompts)
    log(f"spec phase ({min(SPEC_LAYERS, args.layers)} layers) passed in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    host_loop_phase(torch, model, qparams, prompts, daq_outputs)
    log(f"host-loop phase passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    breakdowns(torch, model, qparams, prompts)
    paged_breakdown(torch, phase)
    chunk_breakdown(torch, model, qparams, phase["requests"], phase["engines"]["parity"])
    spec_breakdown(torch, spec)
    del phase, spec, qparams
    torch.cuda.empty_cache()
    log(f"serve breakdowns took {time.perf_counter() - t0:.1f} s")
    # phase 7e runs here, with phase 5's tree and the engines of 7b-7d freed
    t0 = time.perf_counter()
    methods_phase(torch, args, model, post, prompts, base_state, daq_outputs)
    log(f"methods phase passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    block64_phase(torch, model, post, prompts, base_state, daq_outputs)
    log(f"block-64 phase passed in {time.perf_counter() - t0:.1f} s")
    del post
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli_phase(torch)
    log(f"cli phase passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_phase(torch, args.seed, prompts)
    log(f"train phase passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    study_phase(torch)
    log(f"study phase passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ssm_phase(torch, records, args.seed)
    log(f"ssm phase passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_phase(torch, records, args.seed)
    log(f"moe phase passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    swa_phase(torch, records, args.seed)
    log(f"swa phase passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_train_phase(torch, records, args.seed)
    log(f"moe train phase passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    quantize_breakdown(torch, args.seed)
    log(f"quantize breakdown took {time.perf_counter() - t0:.1f} s")

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
    log(f"chip_smoke: the whole script took {time.perf_counter() - t_script:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
