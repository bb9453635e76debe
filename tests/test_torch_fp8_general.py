"""The fp8 matmul's tensor-core routes at every quant block that is a
multiple of 16, and for fp16 and fp32 x, seen from the CPU.

The kernels run only on the card (``chip_smoke.py`` holds each instance
against the plain version there).  Here: ``split_bf16`` (fp32 x as three
bf16 parts, exact bit for bit down to the stated tail) and the join's
order; the split-and-join arithmetic over the plain version against the
reference's ``matmul_fp8_pallas`` (interpret mode) with fp32 x; the plain
version against it with bf16 and fp16 x at other blocks; the decode
route's K split and both kernels' fold-in schedule as pure functions; and
a spy on every product of a reduced GLM-4-9B quantized at blocks 64 and
32, and on an fp32-x product, which routes by its 3M stacked rows.
Tolerances: rtol 1e-5 with atol 1e-5 of the largest |y| (fp32 sums in
another order; every part times an E4M3 code is exact in fp32).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fp8_matmul.kernel import matmul_fp8_pallas
from repro.kernels.fp8_quant.ops import quantize_fp8 as ref_quantize_fp8
from repro_torch.compat import tensor_from_numpy
from repro_torch.configs import QuantConfig, get_arch, reduced
from repro_torch.kernels.fp8_matmul import kernel as KM
from repro_torch.kernels.fp8_matmul import ops as TMM
from repro_torch.kernels.fp8_matmul.kernel import (SPLIT_LIMIT, STAGE_K, TC_MIN_ROWS,
                                                   decode_plan, fold_schedule, join_bf16,
                                                   route, split_bf16)
from repro_torch.kernels.fp8_matmul.ref import matmul_fp8_ref
from repro_torch.models import build_model
from repro_torch.quantize import quantize

TAIL = 2.0 ** -110   # below it bf16 cannot reach an fp32 value's last bit


def _seeded_fp32(n: int, seed: int, top: float = 63.0) -> torch.Tensor:
    """n fp32 values, both signs, exponents uniform over [-149, top), the
    denormals and ±0 included."""
    rng = np.random.default_rng(seed)
    e = rng.uniform(-149.0, top, n)
    v = rng.choice([-1.0, 1.0], n) * np.exp2(e) * rng.uniform(1.0, 2.0, n)
    v[:4] = (0.0, -0.0, 2.0 ** -149, -(2.0 ** -126))
    return torch.from_numpy(v.astype(np.float32))


def test_split_bf16_is_exact_bit_for_bit_above_the_tail():
    x = _seeded_fp32(100_000, 0).reshape(100, 1000)
    parts, up = split_bf16(x)
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, 100, 1000)
    assert torch.equal(up, torch.ones(100, 1))
    hi, mid, lo = parts.float()
    back = (lo + mid) + hi
    same = back.view(torch.int32) == x.view(torch.int32)
    big = x.abs() >= TAIL
    assert bool(same[big & (x != 0)].all())
    # hi is x truncated: its high 16 bits, sign included (a zero keeps its sign)
    assert torch.equal(parts[0].view(torch.int16), x.view(torch.int16)[:, 1::2])
    zeros = x == 0
    assert int(zeros.sum()) == 2 and bool((back[zeros] == 0).all())
    assert torch.equal(mid[zeros].view(torch.int32), torch.zeros(2, dtype=torch.int32))
    # the tail: lo rounds to bf16's denormal grid, an error of at most 2^-134
    err = ((lo.double() + mid.double()) + hi.double() - x.double()).abs()
    assert float(err[big].max()) == 0.0
    assert float(err.max()) <= 2.0 ** -134
    assert int((~big).sum()) > 1000 and int((~same[~big]).sum()) > 0


def test_split_bf16_scales_a_row_that_reaches_the_limit():
    """A row whose largest |x| reaches 2^64 (values near 3e38 included) is
    split from x * 2^-64 with up = 2^64: exact for its elements down to
    2^-46 (the tail moved up with it); every other row is split as it is."""
    x = _seeded_fp32(4_000, 1, top=60.0).reshape(4, 1000)
    x[1, 5], x[3, 9] = 3.0e38, -3.3e38
    x[1] = x[1].where(x[1].abs() >= 2.0 ** -46, 1.0)
    parts, up = split_bf16(x)
    assert up.flatten().tolist() == [1.0, SPLIT_LIMIT, 1.0, SPLIT_LIMIT]
    assert bool(torch.isfinite(parts.float()).all())
    assert float(parts.float().abs().max()) < SPLIT_LIMIT
    hi, mid, lo = parts.double()
    back = ((lo + mid) + hi) * up.double()
    for r in (0, 2):
        big = x[r].abs() >= TAIL
        assert torch.equal(back[r][big], x[r].double()[big])
    assert torch.equal(back[1], x[1].double())
    assert back[3, 9].item() == x[3, 9].item()


def test_join_adds_the_two_small_parts_first():
    """(y_lo + y_mid) + y_hi: 2^-24 + 2^-24 first gives 1 + 2^-23; adding
    each to 1 in turn would round both away (ties to even)."""
    y3 = torch.tensor([[1.0], [2.0 ** -24], [2.0 ** -24]])
    y = join_bf16(y3, torch.ones(1, 1))
    assert y.item() == 1.0 + 2.0 ** -23
    assert join_bf16(y3, torch.full((1, 1), 0.5)).item() == 0.5 + 2.0 ** -24


def _pallas_case(M, K, N, block, seed, x_np):
    rng = np.random.default_rng(seed)
    q, s = ref_quantize_fp8((rng.standard_normal((K, N)) * 0.05).astype(np.float32),
                            block=block)
    t = lambda a: tensor_from_numpy(np.asarray(jax.device_get(a)))
    want = np.asarray(matmul_fp8_pallas(jnp.asarray(x_np), q, s, bm=M, block=block,
                                        interpret=True))
    return t(q), t(s), want


def _assert_close(got: np.ndarray, want: np.ndarray):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("block", [32, 64])
def test_split_and_join_over_the_plain_version_match_pallas_on_fp32_x(block):
    """What the tensor-core routes compute for fp32 x, with the plain
    version standing in for the kernel: one product of the 3M stacked
    bf16 rows, then the join."""
    M, K, N = 8, 256, 192
    rng = np.random.default_rng(block)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0] *= 1e-30
    x[1, 3] = 2.5e38 if block == 64 else x[1, 3]
    q, s, want = _pallas_case(M, K, N, block, block + 1, x)
    parts, up = split_bf16(torch.from_numpy(x))
    y = join_bf16(matmul_fp8_ref(parts.view(3 * M, K), q, s, block=block), up)
    assert np.isfinite(want).all() and bool(torch.isfinite(y).all())
    _assert_close(y.numpy(), want)
    _assert_close(y[:1].numpy(), want[:1])          # the rows near 1e-30 alone


@pytest.mark.parametrize("block", [32, 64, 256])
@pytest.mark.parametrize("xd", [jnp.bfloat16, jnp.float16])
def test_plain_version_matches_pallas_at_other_blocks(block, xd):
    M, K, N = 8, 512, 768
    x = jnp.asarray(np.random.default_rng(block).standard_normal((M, K)).astype(np.float32))
    x = x.astype(xd)
    q, s, want = _pallas_case(M, K, N, block, block + 2, x)
    xt = tensor_from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16 if xd == jnp.bfloat16 else torch.float16)
    _assert_close(TMM.matmul_fp8_2d(xt, q, s, block=block).numpy(), want)


PLAN_CASES = [(M, K_, N, bs) for M in (1, 8, 15)
              for K_, N, bs in ((4096, 13696, 64), (4096, 13696, 32), (13696, 4096, 64),
                                (4096, 151552, 64), (192, 320, 64), (1088, 1600, 64),
                                (1056, 1632, 96), (1040, 1552, 16), (1536, 2560, 512),
                                (1280, 1792, 256), (4096, 4096, 128))]


@pytest.mark.parametrize("M,K_,N,bs", PLAN_CASES)
def test_decode_plan_and_fold_schedule_cover_K_once_on_block_boundaries(M, K_, N, bs):
    """Every K row lies in exactly one part of exactly one split; a part
    never spans two quant blocks; every fold-in falls on a bs boundary or a
    split's end; every output column lies in one block of ``bn``."""
    bn, splits, per = decode_plan(M, N, K_)
    nst = -(-K_ // STAGE_K)
    assert bn in (64, 128) and -(-N // bn) * bn >= N and splits >= 1 and per >= 1
    assert (splits - 1) * per < nst <= splits * per
    rows = []
    for z in range(splits):
        k0, k1 = z * per * STAGE_K, min(K_, (z + 1) * per * STAGE_K)
        parts = fold_schedule(K_, bs, k0, k1)
        assert parts[0][0] == k0 and parts[-1][1] == k1
        for (a, b, kb), nxt in zip(parts, parts[1:] + [None]):
            assert a < b and kb == a // bs == (b - 1) // bs
            assert b % bs == 0 or b == k1
            assert nxt is None or nxt[0] == b
            rows.extend(range(a, b))
    assert rows == list(range(K_))


@pytest.mark.parametrize("K_,bs,want", [
    (256, 64, [(0, 64, 0), (64, 128, 1), (128, 192, 2), (192, 256, 3)]),
    (384, 128, [(0, 128, 0), (128, 256, 1), (256, 384, 2)]),
    (1024, 512, [(0, 512, 0), (512, 1024, 1)]),
    (288, 96, [(0, 96, 0), (96, 192, 1), (192, 288, 2)]),
    (48, 16, [(0, 16, 0), (16, 32, 1), (32, 48, 2)]),
])
def test_wgmma_fold_schedule_is_one_part_per_block(K_, bs, want):
    assert fold_schedule(K_, bs) == want


def test_decode_split_mid_block_folds_at_the_split_end():
    """A split of 128-row stages ends inside a 96-row block: its last part
    folds there, and the next split's first part takes the same block."""
    assert fold_schedule(1056, 96, 0, 256) == [(0, 96, 0), (96, 192, 1), (192, 256, 2)]
    assert fold_schedule(1056, 96, 256, 512) == [(256, 288, 2), (288, 384, 3),
                                                 (384, 480, 4), (480, 512, 5)]


@pytest.mark.parametrize("block", [64, 32])
def test_reduced_glm_products_take_the_tensor_core_routes(monkeypatch, block):
    """Every fp8 product of a reduced GLM-4-9B quantized at block 64 or 32:
    a prefill's seven a layer to wgmma and its last-token LM head to the
    decode route, a decode step's all to the decode route; none to the
    CUDA-core kernel (a ragged leaf multiplies through its block grid)."""
    cfg = reduced(get_arch("glm4-9b"))
    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(block)
    post = model.init(g)
    qparams, _ = quantize(post, post, QuantConfig(block_size=block), mode="storage")
    seen = []
    real = TMM.matmul_fp8_2d

    def spy(x, wq, scales, *, block=128):
        seen.append(route(x.shape[0], wq.shape[1], wq.shape[0], block, x.dtype))
        return real(x, wq, scales, block=block)

    monkeypatch.setattr(TMM, "matmul_fp8_2d", spy)
    tokens = torch.randint(0, cfg.vocab_size, (8, 24), generator=g)
    _, cache = model.prefill(qparams, {"tokens": tokens}, cache_len=26)
    assert seen == ["wgmma"] * (7 * cfg.n_layers) + ["decode"]
    seen.clear()
    model.decode_step(qparams, tokens[:, :1], cache)
    assert seen == ["decode"] * (7 * cfg.n_layers + 1)


@pytest.mark.parametrize("M,want", [(1, "decode"), (5, "decode"), (6, "wgmma"), (8, "wgmma")])
def test_fp32_product_routes_by_its_stacked_rows(monkeypatch, M, want):
    """fp32 x of M rows reaches one kernel as the 3M bf16 rows of
    ``split_bf16`` (decode below ``TC_MIN_ROWS`` = 16 of them), and the
    joined result is the plain version's product (kernels replaced by the
    plain version, on the CPU)."""
    calls = []

    def spy(name):
        def run(x, wq, scales, *, block):
            calls.append((name, tuple(x.shape), x.dtype))
            return matmul_fp8_ref(x, wq, scales, block=block)
        return run

    monkeypatch.setattr(KM, "require_cuda", lambda *t: None)
    monkeypatch.setattr(KM, "ROUTES", {r: spy(r) for r in KM.ROUTES})
    rng = np.random.default_rng(M)
    x = torch.from_numpy(rng.standard_normal((M, 128)).astype(np.float32))
    wq, s = (tensor_from_numpy(np.asarray(jax.device_get(a))) for a in
             ref_quantize_fp8((rng.standard_normal((128, 64)) * 0.05).astype(np.float32),
                              block=32))
    y = KM.matmul_fp8_cuda(x, wq, s, block=32)
    assert route(M, 64, 128, 32, torch.float32) == want
    assert (3 * M < TC_MIN_ROWS) == (want == "decode")
    assert calls == [(want, (3 * M, 128), torch.bfloat16)]
    _assert_close(y.numpy(), matmul_fp8_ref(x, wq, s, block=32).numpy())
