"""The fp8 matmul's two CUDA routes, seen from the CPU.

``kernel.route`` sends prefill-sized products to the tensor-core (wgmma)
kernel and decode-sized ones to the CUDA-core kernel; both compute the
function of the reference's ``matmul_fp8_pallas``, whose plain version
serves CPU tensors.  The kernels run only on the card (``chip_smoke.py``
holds each against the plain version there); here: the route of every
product of a prefill and a decode step, the plain version against the
Pallas kernel on both sides of the route's threshold (rtol 1e-5, atol 1e-4,
the reference's own kernel-test tolerance), the tensor-core wrapper's
operand checks as a pure function of shapes, strides and pointers, and the
build cache's key.
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
from repro_torch.kernels.fp8_matmul.kernel import (TC_MIN_ROWS, matmul_fp8_cuda, route,
                                                   wgmma_operand_error)
from repro_torch.models import build_model
from repro_torch.quantize import quantize

BF, E4, F32 = torch.bfloat16, torch.float8_e4m3fn, torch.float32


@pytest.mark.parametrize("M,N,K_,block,want", [
    (1024, 13696, 4096, 128, "wgmma"),        # GLM-4-9B prefill: w_gate / w_up
    (1024, 4096, 13696, 128, "wgmma"),        # w_down
    (1024, 4096, 4096, 128, "wgmma"),         # wq, wo
    (1024, 256, 4096, 128, "wgmma"),          # wk, wv
    (128, 256, 256, 128, "wgmma"),            # a 4 x 32 prefill
    (8, 13696, 4096, 128, "cuda_core"),       # decode, 8 slots
    (8, 151552, 4096, 128, "cuda_core"),      # the LM head (last token per slot)
    (1, 4096, 4096, 128, "cuda_core"),
    (1024, 13696, 4096, 64, "cuda_core"),     # another quant block
    (1024, 13696, 4096, 256, "cuda_core"),
    (TC_MIN_ROWS - 1, 4096, 4096, 128, "cuda_core"),
    (TC_MIN_ROWS, 4096, 4096, 128, "wgmma"),
])
def test_route(M, N, K_, block, want):
    assert route(M, N, K_, block) == want


def test_prefill_takes_wgmma_and_decode_the_cuda_cores(monkeypatch):
    """Every fp8 product of a GLM-shaped model: a prefill of 8 x 128 tokens
    routes each layer's seven to wgmma and its last-token LM head to the
    CUDA cores; a decode step of 8 slots routes all of them to the CUDA cores."""
    cfg = dataclasses.replace(get_arch("glm4-9b"), n_layers=2, d_model=256, n_heads=2,
                              n_kv_heads=1, head_dim=128, d_ff=512, vocab_size=512)
    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    post = model.init(g)
    qparams, _ = quantize(post, post, QuantConfig(), mode="storage")
    seen = []
    real = TMM.matmul_fp8_2d

    def spy(x, wq, scales, *, block=128):
        seen.append(route(x.shape[0], wq.shape[1], wq.shape[0], block))
        return real(x, wq, scales, block=block)

    monkeypatch.setattr(TMM, "matmul_fp8_2d", spy)
    tokens = torch.randint(0, cfg.vocab_size, (8, 128), generator=g)
    _, cache = model.prefill(qparams, {"tokens": tokens}, cache_len=130)
    assert seen == ["wgmma"] * (7 * cfg.n_layers) + ["cuda_core"]
    seen.clear()
    model.decode_step(qparams, tokens[:, :1], cache)
    assert seen == ["cuda_core"] * (7 * cfg.n_layers + 1)


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
    before = {k.name: k.launches for k in _lib.KERNELS}
    for M in (8, 1024):
        x = torch.zeros(M, 256, dtype=BF)
        with pytest.raises(ValueError, match="CUDA"):
            matmul_fp8_cuda(x, torch.zeros(256, 384).to(E4), torch.ones(2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        K.matmul_fp8_wgmma(torch.zeros(64, 256, dtype=BF), torch.zeros(256, 384).to(E4),
                           torch.ones(2, 3))
    assert {k.name: k.launches for k in _lib.KERNELS} == before


def test_wgmma_kernel_is_registered_and_runs_wgmma():
    k = _lib.FP8_MATMUL_WGMMA
    assert k in _lib.KERNELS and k.name == "fp8_matmul_wgmma"
    assert list(k.functions) == ["matmul_fp8_wgmma"]
    src = k.source.read_text()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
                   'extern "C" int matmul_fp8_wgmma'):
        assert needle in src


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
