"""The fp8 matmul's three CUDA routes, seen from the CPU.

``kernel.route`` sends bf16, block-128 products of fewer than
``TC_MIN_ROWS`` rows to the decode kernel, larger ones to the prefill
(wgmma) kernel, and every other operand pair (fp16 / fp32 x, other blocks)
to the CUDA-core kernel; all compute the function of the reference's
``matmul_fp8_pallas``, whose plain version serves CPU tensors.  The kernels
run only on the card (``chip_smoke.py`` holds each against the plain
version there); here: the route table and the route of every product of a
prefill and a decode step, the plain version against the Pallas kernel on
both sides of the route's threshold (rtol 1e-5, atol 1e-4, the reference's
own kernel-test tolerance), each wrapper's operand checks as a pure
function of shapes, strides and pointers, the decode route's split plan,
and the build cache's key.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fp8_matmul.kernel import matmul_fp8_pallas
from repro.kernels.fp8_quant.ops import quantize_fp8 as ref_quantize_fp8
from repro_torch.compat import tensor_from_numpy
from repro_torch.configs import QuantConfig, get_arch
from repro_torch.kernels import _lib
from repro_torch.kernels.fp8_matmul import kernel as K
from repro_torch.kernels.fp8_matmul import ops as TMM
from repro_torch.kernels.fp8_matmul.kernel import (TC_MIN_ROWS, cuda_core_operand_error,
                                                   decode_operand_error, decode_plan,
                                                   matmul_fp8_cuda, route,
                                                   wgmma_operand_error)
from repro_torch.models import build_model
from repro_torch.quantize import quantize

BF, E4, F16, F32 = torch.bfloat16, torch.float8_e4m3fn, torch.float16, torch.float32


@pytest.mark.parametrize("M,N,K_,block,xd,want", [
    (1024, 13696, 4096, 128, BF, "wgmma"),        # GLM-4-9B prefill: w_gate / w_up
    (1024, 4096, 13696, 128, BF, "wgmma"),        # w_down
    (1024, 4096, 4096, 128, BF, "wgmma"),         # wq, wo
    (1024, 256, 4096, 128, BF, "wgmma"),          # wk, wv
    (128, 256, 256, 128, BF, "wgmma"),            # a 4 x 32 prefill
    (8, 13696, 4096, 128, BF, "decode"),          # decode, 8 slots
    (8, 4096, 13696, 128, BF, "decode"),
    (8, 256, 4096, 128, BF, "decode"),
    (8, 151552, 4096, 128, BF, "decode"),         # the LM head (last token per slot)
    (1, 4096, 4096, 128, BF, "decode"),
    (8, 4096, 4096, 256, BF, "cuda_core"),
    (1024, 13696, 4096, 64, BF, "cuda_core"),     # another quant block
    (1024, 13696, 4096, 256, BF, "cuda_core"),
    (1024, 13696, 4096, 512, BF, "cuda_core"),
    (TC_MIN_ROWS - 1, 4096, 4096, 128, BF, "decode"),
    (TC_MIN_ROWS, 4096, 4096, 128, BF, "wgmma"),
    (8, 4096, 4096, 128, F32, "cuda_core"),       # a float32 / float16 model
    (8, 4096, 4096, 128, F16, "cuda_core"),
    (1024, 4096, 4096, 128, F32, "cuda_core"),
    (1024, 4096, 4096, 128, F16, "cuda_core"),
    (8, 4096, 4096, 64, F32, "cuda_core"),
])
def test_route(M, N, K_, block, xd, want):
    assert route(M, N, K_, block, xd) == want


def test_prefill_takes_wgmma_and_decode_the_decode_route(monkeypatch):
    """Every fp8 product of a GLM-shaped model: a prefill of 8 x 128 tokens
    routes each layer's seven to wgmma and its last-token LM head to the
    decode route; a decode step of 8 slots routes all of them to the decode
    route."""
    cfg = dataclasses.replace(get_arch("glm4-9b"), n_layers=2, d_model=256, n_heads=2,
                              n_kv_heads=1, head_dim=128, d_ff=512, vocab_size=512)
    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    post = model.init(g)
    qparams, _ = quantize(post, post, QuantConfig(), mode="storage")
    seen = []
    real = TMM.matmul_fp8_2d

    def spy(x, wq, scales, *, block=128):
        seen.append(route(x.shape[0], wq.shape[1], wq.shape[0], block, x.dtype))
        return real(x, wq, scales, block=block)

    monkeypatch.setattr(TMM, "matmul_fp8_2d", spy)
    tokens = torch.randint(0, cfg.vocab_size, (8, 128), generator=g)
    _, cache = model.prefill(qparams, {"tokens": tokens}, cache_len=130)
    assert seen == ["wgmma"] * (7 * cfg.n_layers) + ["decode"]
    seen.clear()
    model.decode_step(qparams, tokens[:, :1], cache)
    assert seen == ["decode"] * (7 * cfg.n_layers + 1)


@pytest.mark.parametrize("M", [TC_MIN_ROWS - 1, TC_MIN_ROWS, 130])
def test_plain_version_matches_pallas_across_the_route_threshold(M):
    rng = np.random.default_rng(M)
    x = jnp.asarray(rng.standard_normal((M, 256)).astype(np.float32)).astype(jnp.bfloat16)
    q, s = ref_quantize_fp8((rng.standard_normal((256, 384)) * 0.1).astype(np.float32))
    yr = matmul_fp8_pallas(x, q, s, bm=M, block=128, interpret=True)
    t = lambda a: tensor_from_numpy(np.asarray(jax.device_get(a)))
    yp = TMM.matmul_fp8_2d(t(x), t(q), t(s), block=128)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yr), rtol=1e-5, atol=1e-4)


def _operands(**over):
    """Keyword arguments of ``wgmma_operand_error`` for a valid M = 64,
    [256, 384] product, with ``over`` replacing some."""
    M, Kd, N = 64, 256, 384
    args = dict(x_shape=(M, Kd), x_strides=(Kd, 1), x_dtype=BF, x_ptr=1 << 20,
                wq_shape=(Kd, N), wq_strides=(N, 1), wq_dtype=E4, wq_ptr=1 << 21,
                scales_shape=(Kd // 128, N // 128), scales_dtype=F32, block=128)
    args.update(over)
    return args


def test_wgmma_operand_checks_accept_the_main_path():
    assert wgmma_operand_error(**_operands()) is None
    assert wgmma_operand_error(**_operands(x_shape=(1, 256))) is None     # any M


@pytest.mark.parametrize("over,why", [
    (dict(x_dtype=F32), "bf16 x"),
    (dict(x_dtype=torch.float16), "bf16 x"),
    (dict(wq_dtype=torch.float8_e5m2), "e4m3 wq"),
    (dict(scales_dtype=torch.float16), "float32 scales"),
    (dict(block=64, scales_shape=(4, 6)), "block 128"),
    (dict(x_shape=(2, 32, 256), x_strides=(8192, 256, 1)), "2-D"),
    (dict(x_shape=(64, 192), x_strides=(192, 1), wq_shape=(192, 384)), "multiples of 128"),
    (dict(wq_shape=(256, 200), wq_strides=(200, 1)), "multiples of 128"),
    (dict(wq_shape=(128, 384)), "multiples of 128"),
    (dict(scales_shape=(2, 2)), "scales"),
    (dict(x_strides=(1, 64)), "row-major"),
    (dict(x_strides=(512, 1)), "row-major"),
    (dict(wq_strides=(768, 1)), "row-major"),
    (dict(x_ptr=(1 << 20) + 8), "16-byte aligned"),
    (dict(wq_ptr=(1 << 21) + 4), "16-byte aligned"),
])
def test_wgmma_operand_checks_refuse(over, why):
    err = wgmma_operand_error(**_operands(**over))
    assert err is not None and why in err


def test_both_routes_refuse_cpu_tensors_before_any_build():
    """Every route (decode, wgmma, CUDA cores) refuses CPU tensors before any build."""
    before = {k.name: k.launches for k in _lib.KERNELS}
    for M in (8, 1024):
        x = torch.zeros(M, 256, dtype=BF)
        with pytest.raises(ValueError, match="CUDA"):
            matmul_fp8_cuda(x, torch.zeros(256, 384).to(E4), torch.ones(2, 3))
    for run, M in ((K.matmul_fp8_wgmma, 64), (K.matmul_fp8_decode, 8),
                   (K.matmul_fp8_cuda_core, 8)):
        with pytest.raises(ValueError, match="CUDA"):
            run(torch.zeros(M, 256, dtype=BF), torch.zeros(256, 384).to(E4), torch.ones(2, 3))
    assert {k.name: k.launches for k in _lib.KERNELS} == before


def test_wgmma_kernel_is_registered_and_runs_wgmma():
    k = _lib.FP8_MATMUL_WGMMA
    assert k in _lib.KERNELS and k.name == "fp8_matmul_wgmma"
    assert list(k.functions) == ["matmul_fp8_wgmma"]
    src = k.source.read_text()
    for needle in ("wgmma.mma_async", '#include "hopper.cuh"', "tma_load(", "mbar_wait(",
                   'extern "C" int matmul_fp8_wgmma'):
        assert needle in src
    hdr = (k.source.parent / "hopper.cuh").read_text()   # the shared TMA / mbarrier helpers
    for needle in ("cp.async.bulk.tensor", "mbarrier.try_wait"):
        assert needle in hdr


def test_decode_kernel_is_registered_and_runs_mma_from_a_tma_ring():
    k = _lib.FP8_MATMUL_DECODE
    assert k in _lib.KERNELS and k.name == "fp8_matmul_decode"
    assert list(k.functions) == ["matmul_fp8_decode"]
    src = k.source.read_text()
    for needle in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   '#include "hopper.cuh"', "tma_load(", "mbar_wait(", "sum_splits(",
                   'extern "C" int matmul_fp8_decode'):
        assert needle in src
    hdr = (k.source.parent / "hopper.cuh").read_text()
    for needle in ("cp.async.bulk.tensor", "mbarrier.try_wait", "cuTensorMapEncodeTiled",
                   "e4m3x2_to_bf16x2", "sw128_desc"):
        assert needle in hdr
    assert '#include "hopper.cuh"' in _lib.FP8_MATMUL_WGMMA.source.read_text()


def test_library_path_tracks_every_header(tmp_path, monkeypatch):
    monkeypatch.setattr(_lib, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// common\n")
    (tmp_path / "other.cu").write_text("// another kernel\n")
    k = _lib.Kernel("k", {})
    p0 = k.library_path()
    assert p0.parent == _lib.BUILD_DIR and p0.name.startswith("libk-")
    (tmp_path / "tiles.cuh").write_text("// a new header\n")
    p1 = k.library_path()
    (tmp_path / "tiles.cuh").write_text("// the new header, changed\n")
    p2 = k.library_path()
    (tmp_path / "common.cuh").write_text("// common, changed\n")
    p3 = k.library_path()
    assert len({p0, p1, p2, p3}) == 4
    (tmp_path / "other.cu").write_text("// another kernel, changed\n")
    assert k.library_path() == p3


def test_build_log_is_kept_beside_the_library(tmp_path, monkeypatch):
    """A cached library still reports its ptxas lines (chip_smoke phase 2
    reads them): the log of the build that made it is kept beside it."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = "-o" ] && out=$2; shift; done\n'
                    'echo "ptxas info    : Used 42 registers"\n: > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_lib, "CSRC", csrc)
    monkeypatch.setattr(_lib, "BUILD_DIR", build)
    monkeypatch.setattr(_lib, "nvcc", lambda: str(fake))
    first = _lib.Kernel("k", {})
    first.finish_build(first.start_build())
    assert "Used 42 registers" in first.build_log and first.library_path().exists()
    again = _lib.Kernel("k", {})
    assert again.start_build() is None                       # cached: no nvcc
    assert again.build_log == first.build_log


def _cc_operands(**over):
    """Keyword arguments of ``cuda_core_operand_error`` for a valid M = 8,
    [256, 384] block-128 product, with ``over`` replacing some."""
    M, Kd, N = 8, 256, 384
    args = dict(x_shape=(M, Kd), x_strides=(Kd, 1), x_dtype=BF, wq_shape=(Kd, N),
                wq_strides=(N, 1), wq_dtype=E4, wq_ptr=1 << 21,
                scales_shape=(Kd // 128, N // 128), scales_dtype=F32, block=128)
    args.update(over)
    return args


@pytest.mark.parametrize("over", [
    dict(),
    dict(x_dtype=F16),
    dict(x_dtype=F32),
    dict(x_shape=(1, 256)),
    dict(x_shape=(1024, 256)),
    dict(block=64, scales_shape=(4, 6)),
    dict(block=32, scales_shape=(8, 12)),
    dict(block=256, wq_shape=(256, 512), wq_strides=(512, 1), scales_shape=(1, 2)),
    dict(block=512, x_shape=(8, 1024), x_strides=(1024, 1), wq_shape=(1024, 1536),
         wq_strides=(1536, 1), scales_shape=(2, 3)),
    dict(wq_ptr=(1 << 21) + 4),
])
def test_cuda_core_operand_checks_accept(over):
    assert cuda_core_operand_error(**_cc_operands(**over)) is None


@pytest.mark.parametrize("over,why", [
    (dict(x_dtype=torch.float64), "float32 x"),
    (dict(x_dtype=torch.int8), "float32 x"),
    (dict(wq_dtype=torch.float8_e5m2), "e4m3 wq"),
    (dict(scales_dtype=torch.bfloat16), "float32 scales"),
    (dict(x_shape=(2, 4, 256), x_strides=(1024, 256, 1)), "2-D"),
    (dict(block=96, scales_shape=(2, 4)), "multiples of 96"),
    (dict(wq_shape=(128, 384)), "multiples of 128"),
    (dict(scales_shape=(2, 2)), "scales"),
    (dict(block=64), "scales"),
    (dict(x_strides=(1, 8)), "row-major"),
    (dict(wq_strides=(512, 1)), "row-major"),
    (dict(block=2, wq_shape=(256, 386), wq_strides=(386, 1), scales_shape=(128, 193)),
     "N % 4"),
    (dict(wq_ptr=(1 << 21) + 2), "4-byte aligned"),
])
def test_cuda_core_operand_checks_refuse(over, why):
    err = cuda_core_operand_error(**_cc_operands(**over))
    assert err is not None and why in err


def test_decode_operand_checks_accept_the_decode_rows():
    for M in (1, 8, TC_MIN_ROWS - 1):
        assert decode_operand_error(**_operands(x_shape=(M, 256))) is None


@pytest.mark.parametrize("over,why", [
    (dict(x_shape=(TC_MIN_ROWS, 256)), "rows of x"),
    (dict(x_shape=(64, 256)), "rows of x"),
    (dict(x_shape=(0, 256)), "rows of x"),
    (dict(x_shape=(8, 256), x_dtype=F32), "bf16 x"),
    (dict(x_shape=(8, 256), x_dtype=F16), "bf16 x"),
    (dict(x_shape=(8, 256), block=64, scales_shape=(4, 6)), "block 128"),
    (dict(x_shape=(8, 256), wq_shape=(256, 200), wq_strides=(200, 1)), "multiples of 128"),
    (dict(x_shape=(8, 256), scales_shape=(2, 2)), "scales"),
    (dict(x_shape=(8, 256), x_strides=(512, 1)), "row-major"),
    (dict(x_shape=(8, 256), x_ptr=(1 << 20) + 8), "16-byte aligned"),
    (dict(x_shape=(8, 256), wq_ptr=(1 << 21) + 4), "16-byte aligned"),
])
def test_decode_operand_checks_refuse(over, why):
    err = decode_operand_error(**_operands(**over))
    assert err is not None and why in err


DECODE_SHAPES = [(M, N, K_) for M in (1, 8, 9, TC_MIN_ROWS - 1)
                 for N, K_ in ((4096, 4096), (256, 4096), (13696, 4096), (4096, 13696),
                               (151552, 4096), (384, 512), (128, 128))]


@pytest.mark.parametrize("M,N,K_", DECODE_SHAPES)
def test_decode_plan_covers_every_tile_and_slab_once(M, N, K_):
    bn, splits, per = decode_plan(M, N, K_)
    nkb = K_ // 128
    assert bn in (64, 128) and N % bn == 0 and splits >= 1 and per >= 1
    covered = {}
    for nt in range(N // bn):
        for z in range(splits):
            for kb in range(z * per, min(nkb, (z + 1) * per)):
                covered[(nt, kb)] = covered.get((nt, kb), 0) + 1
    assert covered == {(nt, kb): 1 for nt in range(N // bn) for kb in range(nkb)}
    assert all(z * per < nkb for z in range(splits))          # no empty split
    assert splits * M * N * 4 <= K.SCRATCH_BYTES or splits == 1


@pytest.mark.parametrize("M", [1, 8, TC_MIN_ROWS - 1])
@pytest.mark.parametrize("N,K_", [(4096, 4096), (13696, 4096), (4096, 13696)])
def test_decode_plan_fills_the_sms_at_the_wide_widths(M, N, K_):
    bn, splits, _ = decode_plan(M, N, K_)
    assert (N // bn) * splits >= K.SMS


def test_decode_plan_gives_the_narrow_width_a_block_per_slab_and_64_columns():
    """[4096, 256] holds 1 MB of weights: 4 x 32 blocks of one 8 KB slab each."""
    assert decode_plan(8, 256, 4096) == (64, 32, 1)


def test_decode_plan_does_not_split_the_lm_head():
    bn, splits, per = decode_plan(8, 151552, 4096)
    assert (bn, splits, per) == (128, 1, 32) and 151552 // bn == 1184
