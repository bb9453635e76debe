"""Launch the CUDA fused block-dequant fp8 matmul: three routes, one function.

Replaces ``repro/kernels/fp8_matmul/kernel.py::matmul_fp8_pallas``.
:func:`route` picks a kernel from the shapes, the quant block and x's type
alone; each source's header says what bounds it on the H100:

==============  ==================  =================  ======================
x               quant block         rows               route
==============  ==================  =================  ======================
bf16 or fp16    a multiple of 16    M < 16             ``decode``
bf16 or fp16    a multiple of 16    M >= 16            ``wgmma``
fp32            a multiple of 16    3M < 16 / >= 16    ``decode`` / ``wgmma``
any             any other           any                ``cuda_core``
==============  ==================  =================  ======================

The decode kernel (``csrc/fp8_matmul_decode.cu``: mma.sync fed by a TMA
ring, split over K by :func:`decode_plan`) and the prefill kernel
(``csrc/fp8_matmul_wgmma.cu``: wgmma) run on the tensor cores and take
bf16 or fp16 x at any block that is a multiple of 16 and divides K and N;
the block is folded in on the schedule :func:`fold_schedule` spells out.
fp32 x is split exactly into three bf16 parts (:func:`split_bf16`), stacked
as the 3M rows of one launch and routed by them, and the three results are
joined in fp32 (:func:`join_bf16`).  The CUDA-core kernel
(``csrc/fp8_matmul.cu``) takes only the blocks that are not a multiple of
16 (8, 40, 66 ...).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._lib import (FP8_MATMUL, FP8_MATMUL_DECODE, FP8_MATMUL_WGMMA, ptr,
                                      require_cuda, stream_of)

ROWS, COLS = 8, 128      # CUDA-core route: rows of x / output columns per thread block
X_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}  # CUDA-core x codes
TARGET_BLOCKS = 2 * 132  # two thread blocks per H100 SM
TC_MIN_ROWS = 16         # fewest kernel rows of x that take the prefill (wgmma) route
TC_BLOCK_STEP = 16       # the tensor-core routes take quant blocks that are multiples of this
STAGE_K = 128            # decode route: K rows of a pipeline stage (the unit of its K split)
SMS = 132                # H100 SXM streaming multiprocessors
DECODE_TARGET = 4 * SMS  # decode route: thread blocks to aim for (~4 per SM)
SCRATCH_BYTES = 8 << 20  # decode route: most bytes of K-split partial sums (L2-resident)
SPLIT_LIMIT = 2.0 ** 64  # split_bf16: rows whose largest |x| reaches this are scaled by 2^-64


def route(M: int, N: int, K: int, block: int, x_dtype: torch.dtype) -> str:
    """``"decode"`` below ``TC_MIN_ROWS`` kernel rows (M; 3M for fp32 x,
    whose three bf16 parts are stacked), ``"wgmma"`` from there on, for
    bf16, fp16 or fp32 x at a quant block that is a multiple of
    ``TC_BLOCK_STEP``; ``"cuda_core"`` for every other block (and for an x
    type no kernel takes, whose wrapper then raises)."""
    if x_dtype not in X_DTYPES or block <= 0 or block % TC_BLOCK_STEP:
        return "cuda_core"
    rows = 3 * M if x_dtype == torch.float32 else M
    return "decode" if rows < TC_MIN_ROWS else "wgmma"


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 x [M, K] -> (parts [3, M, K] bf16, up [M, 1] fp32) with
    ``x = up * (hi + mid + lo)`` exactly, row by row.

    ``hi`` is x truncated to bf16 (its high 16 bits), ``mid`` the residual
    ``x - hi`` truncated likewise, ``lo`` the rest rounded to bf16: each
    residual is exact in fp32 and holds at most 16, then 8, significant
    bits, so ``lo`` is exact wherever bf16 reaches the last bit of x, 2^-23
    of its leading one: for |x| >= 2^-110 (about 7.7e-34), and for any x
    whose bits all lie at or above 2^-133, bf16's smallest denormal.  Below
    that (the far tail near fp32's smallest exponents) ``lo`` is rounded,
    an error of at most 2^-134.  A zero keeps its sign in ``hi``; ``mid``
    and ``lo`` of a zero residual are +0.  A row whose largest |x| reaches
    ``SPLIT_LIMIT`` (2^64) is split from x * 2^-64 (``up`` = 2^64; 1
    elsewhere), exact but for its elements under 2^-46, so that a part times
    an E4M3 code (at most 448), summed over a quant block, stays finite in
    the tensor core's fp32 accumulator whatever the row holds (fp32 x near
    3e38 included).  A non-finite x makes its row non-finite.

    Each part times an E4M3 code is exact in fp32, so the only error the
    tensor-core routes add to fp32 x is the order of the fp32 sums."""
    M, K = x.shape
    amax = torch.linalg.vector_norm(x, float("inf"), dim=1, keepdim=True)
    down = torch.where(amax < SPLIT_LIMIT, 1.0, 1.0 / SPLIT_LIMIT)
    parts = torch.empty((3, M, K), dtype=torch.bfloat16, device=x.device)
    high = lambda t: t.view(torch.bfloat16)[:, 1::2]    # the high 16 bits of fp32
    torch.mul(high(x), down, out=parts[0])
    r = torch.sub(x, high(x))                           # exact
    torch.mul(high(r), down, out=parts[1])
    torch.sub(r.mul_(down), parts[1], out=parts[2])
    return parts, down.reciprocal()


def join_bf16(y3: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """The product of ``split_bf16``'s parts, fp32 [3M, N] (hi's rows, then
    mid's, then lo's) -> y [M, N] = ((y_lo + y_mid) + y_hi) * up: the two
    small terms first."""
    y_hi, y_mid, y_lo = y3.view(3, -1, y3.shape[-1])
    return torch.add(y_lo, y_mid).add_(y_hi).mul_(up)


def decode_plan(M: int, N: int, K: int) -> tuple[int, int, int]:
    """(columns per block, splits, stages per split) of the decode route.

    A block owns ``bn`` output columns and a contiguous range of the
    ``ceil(K / STAGE_K)`` 128-row stages, whatever the quant block.  ``bn``
    is 128 when the 128-column tiles alone give two blocks per SM (the LM
    head), else 64.  The stages are split until there are
    ``DECODE_TARGET`` blocks, at most one split per stage, and while the
    partial sums (4 M N bytes per split, written once and read once by the
    second pass) fit in ``SCRATCH_BYTES``, well inside the 50 MB L2.  A
    split's last part is folded in at its end (:func:`fold_schedule`)."""
    nst = -(-K // STAGE_K)
    bn = 128 if N // 128 >= 2 * SMS else 64
    tiles = -(-N // bn)
    splits = max(1, min(nst, -(-DECODE_TARGET // tiles), SCRATCH_BYTES // (4 * max(M, 1) * N)))
    per = -(-nst // splits)
    return bn, -(-nst // per), per


def fold_schedule(K: int, block: int, k0: int = 0, k1: int | None = None) -> list:
    """The parts a tensor-core kernel folds in over the K rows [k0, k1) it
    owns (a decode split's stages; all of K for wgmma), as its k16-step
    loop makes them: ``(first row, end row, quant block row)`` of each part,
    in order.  A part ends at each multiple of ``block``, and the last at
    ``min(k1, K)``: steps past K are zero fill, which the kernels skip.

    No kernel or caller runs this: it is the tests' model of the fold loops
    of ``fp8_matmul_decode.cu`` and ``fp8_matmul_wgmma.cu``, and changes
    together with them."""
    k1 = K if k1 is None else min(k1, K)
    bs16 = block // 16
    kb, done = divmod(k0 // 16, bs16)
    left, start, parts = bs16 - done, k0, []
    for kg in range(k0 // 16, -(-k1 // 16)):
        if left == 0:
            parts.append((start, 16 * kg, kb))
            kb, left, start = kb + 1, bs16, 16 * kg
        left -= 1
    parts.append((start, k1, kb))
    return parts


def split_k(M: int, N: int, K: int, block: int) -> tuple[int, int]:
    """(splits, slabs per split): split the K slabs across the grid when the
    output tiles alone leave SMs idle (decode)."""
    tiles = -(-N // COLS) * -(-M // ROWS)
    nkb = K // block
    splits = max(1, min(nkb, -(-TARGET_BLOCKS // tiles)))
    per = -(-nkb // splits)
    return -(-nkb // per), per


def wgmma_operand_error(x_shape, x_strides, x_dtype, x_ptr: int, wq_shape, wq_strides,
                        wq_dtype, wq_ptr: int, scales_shape, scales_dtype,
                        block: int) -> str | None:
    """Why the tensor-core kernels cannot take these operands, or None.

    A pure function of shapes, strides, dtypes and pointers: row-major
    bf16 or fp16 x [M, K] and E4M3 wq [K, N] at 16-byte aligned addresses
    (the TMA loads), a quant block that is a multiple of 16 and divides K
    and N, fp32 scales [K/block, N/block].  (fp32 x reaches these kernels
    as ``split_bf16``'s bf16 rows.)"""
    if x_dtype not in (torch.bfloat16, torch.float16) or wq_dtype != torch.float8_e4m3fn \
            or scales_dtype != torch.float32:
        return (f"takes bf16 x or fp16 x, e4m3 wq and float32 scales, got {x_dtype}, "
                f"{wq_dtype}, {scales_dtype}")
    if block <= 0 or block % TC_BLOCK_STEP:
        return f"takes a quant block that is a multiple of {TC_BLOCK_STEP}, got {block}"
    if len(x_shape) != 2 or len(wq_shape) != 2:
        return f"takes 2-D x and wq, got {tuple(x_shape)} and {tuple(wq_shape)}"
    (M, K), N = x_shape, wq_shape[1]
    if wq_shape[0] != K or K % block or N % block:
        return f"x {tuple(x_shape)} @ wq {tuple(wq_shape)} needs K, N multiples of {block}"
    if tuple(scales_shape) != (K // block, N // block):
        return f"scales {tuple(scales_shape)} for wq {tuple(wq_shape)} at block {block}"
    if tuple(x_strides) != (K, 1) or tuple(wq_strides) != (N, 1):
        return "x and wq must be row-major and contiguous"
    if x_ptr % 16 or wq_ptr % 16:
        return "x and wq must start at 16-byte aligned addresses"
    return None


def cuda_core_operand_error(x_shape, x_strides, x_dtype, wq_shape, wq_strides, wq_dtype,
                            wq_ptr: int, scales_shape, scales_dtype, block: int) -> str | None:
    """Why the CUDA-core kernel cannot take these operands, or None.

    A pure function of shapes, strides, dtypes and the weights' pointer:
    row-major bf16, fp16 or fp32 x [M, K] and E4M3 wq [K, N], any quant
    block that divides K and N, fp32 scales [K/block, N/block]; each lane
    reads 4 codes at once, so N % 4 == 0 and wq 4-byte aligned."""
    if x_dtype not in X_DTYPES or wq_dtype != torch.float8_e4m3fn \
            or scales_dtype != torch.float32:
        return (f"takes bf16, fp16 or float32 x, e4m3 wq and float32 scales, got {x_dtype}, "
                f"{wq_dtype}, {scales_dtype}")
    if len(x_shape) != 2 or len(wq_shape) != 2:
        return f"takes 2-D x and wq, got {tuple(x_shape)} and {tuple(wq_shape)}"
    (M, K), N = x_shape, wq_shape[1]
    if block <= 0 or wq_shape[0] != K or K % block or N % block:
        return f"x {tuple(x_shape)} @ wq {tuple(wq_shape)} needs K, N multiples of {block}"
    if tuple(scales_shape) != (K // block, N // block):
        return f"scales {tuple(scales_shape)} for wq {tuple(wq_shape)} at block {block}"
    if tuple(x_strides) != (K, 1) or tuple(wq_strides) != (N, 1):
        return "x and wq must be row-major and contiguous"
    if N % 4 or wq_ptr % 4:
        return f"reads 4 codes at once: needs N % 4 == 0 (N = {N}) and wq 4-byte aligned"
    return None


def decode_operand_error(x_shape, x_strides, x_dtype, x_ptr: int, wq_shape, wq_strides,
                         wq_dtype, wq_ptr: int, scales_shape, scales_dtype,
                         block: int) -> str | None:
    """Why the decode kernel cannot take these operands, or None: those of
    the prefill kernel (``wgmma_operand_error``: the same TMA loads) with
    1 <= M < ``TC_MIN_ROWS`` rows of x."""
    err = wgmma_operand_error(x_shape, x_strides, x_dtype, x_ptr, wq_shape, wq_strides,
                              wq_dtype, wq_ptr, scales_shape, scales_dtype, block)
    if err is None and not 1 <= x_shape[0] < TC_MIN_ROWS:
        err = f"takes 1 to {TC_MIN_ROWS - 1} rows of x, got {x_shape[0]}"
    return err


def matmul_fp8_decode(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor, *,
                      block: int = 128) -> torch.Tensor:
    """The decode route: bf16 or fp16 x of 1 to ``TC_MIN_ROWS`` - 1 rows,
    any quant block that is a multiple of 16."""
    require_cuda(x, wq, scales)
    err = decode_operand_error(x.shape, x.stride(), x.dtype, x.data_ptr(), wq.shape,
                               wq.stride(), wq.dtype, wq.data_ptr(), scales.shape,
                               scales.dtype, block)
    if err is not None:
        raise ValueError(f"fp8_matmul_decode: {err}")
    M, K = x.shape
    N = wq.shape[1]
    bn, splits, per = decode_plan(M, N, K)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    scratch = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) \
        if splits > 1 else y
    FP8_MATMUL_DECODE.launch("matmul_fp8_decode", ptr(x), ptr(wq), ptr(scales), ptr(y),
                             ptr(scratch), M, K, N, block, int(x.dtype == torch.float16),
                             bn, splits, per, stream_of(x))
    return y


def matmul_fp8_wgmma(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor, *,
                     block: int = 128) -> torch.Tensor:
    """The prefill route, bf16 or fp16 x, any M >= 1 (``route`` sends it
    M >= TC_MIN_ROWS), any quant block that is a multiple of 16."""
    require_cuda(x, wq, scales)
    err = wgmma_operand_error(x.shape, x.stride(), x.dtype, x.data_ptr(), wq.shape,
                              wq.stride(), wq.dtype, wq.data_ptr(), scales.shape,
                              scales.dtype, block)
    if err is not None:
        raise ValueError(f"fp8_matmul_wgmma: {err}")
    M, K = x.shape
    N = wq.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    FP8_MATMUL_WGMMA.launch("matmul_fp8_wgmma", ptr(x), ptr(wq), ptr(scales), ptr(y),
                            M, K, N, block, int(x.dtype == torch.float16), stream_of(x))
    return y


def matmul_fp8_cuda_core(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor, *,
                         block: int = 128) -> torch.Tensor:
    """The CUDA-core route: any M, bf16 / fp16 / fp32 x, any block that
    divides K and N (``route`` sends it the blocks that are not a multiple
    of 16)."""
    require_cuda(x, wq, scales)
    err = cuda_core_operand_error(x.shape, x.stride(), x.dtype, wq.shape, wq.stride(),
                                  wq.dtype, wq.data_ptr(), scales.shape, scales.dtype, block)
    if err is not None:
        raise ValueError(f"fp8_matmul: {err}")
    M, K = x.shape
    N = wq.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    splits, per = split_k(M, N, K, block)
    scratch = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) \
        if splits > 1 else y
    FP8_MATMUL.launch("matmul_fp8", ptr(x), ptr(wq), ptr(scales), ptr(y), ptr(scratch),
                      M, K, N, block, splits, per, X_DTYPES[x.dtype], stream_of(x))
    return y


def matmul_fp8_cuda(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor, *,
                    block: int = 128) -> torch.Tensor:
    """Same contract as ``ref.matmul_fp8_ref``, on the GPU: the kernel of
    ``route``'s choice (for fp32 x on the tensor cores: one launch on
    ``split_bf16``'s 3M rows, then ``join_bf16``), or an error before any
    launch."""
    require_cuda(x, wq, scales)
    M = x.shape[0]
    which = route(M, wq.shape[1], wq.shape[0], block, x.dtype)
    if which == "cuda_core" or x.dtype != torch.float32:
        return ROUTES[which](x, wq, scales, block=block)
    parts, up = split_bf16(x)
    return join_bf16(ROUTES[which](parts.view(3 * M, -1), wq, scales, block=block), up)


ROUTES = {"decode": matmul_fp8_decode, "wgmma": matmul_fp8_wgmma,
          "cuda_core": matmul_fp8_cuda_core}
