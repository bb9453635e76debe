"""Launch the CUDA fused block-dequant fp8 matmul: three routes, one function.

Replaces ``repro/kernels/fp8_matmul/kernel.py::matmul_fp8_pallas``.  For
bf16 x and quant block 128, the serve path's products: the decode kernel
(``csrc/fp8_matmul_decode.cu``, bf16 mma.sync fed by a TMA ring, split
over K) takes fewer than ``TC_MIN_ROWS`` rows of x, and the prefill kernel
(``csrc/fp8_matmul_wgmma.cu``, bf16 wgmma) the rest.  The CUDA-core kernel
(``csrc/fp8_matmul.cu``) takes every other operand pair the reference
takes: fp16 or fp32 x, any block that divides K and N.  :func:`route`
picks one from the shapes and x's type alone; each source's header says
what bounds it on the H100.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._lib import (FP8_MATMUL, FP8_MATMUL_DECODE, FP8_MATMUL_WGMMA, ptr,
                                      require_cuda, stream_of)

ROWS, COLS = 8, 128      # CUDA-core route: rows of x / output columns per thread block
X_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}  # CUDA-core x codes
TARGET_BLOCKS = 2 * 132  # two thread blocks per H100 SM
TC_MIN_ROWS = 16         # fewest rows of x that take the prefill (wgmma) route
TC_BLOCK = 128           # the one quant block edge the tensor-core routes take
SMS = 132                # H100 SXM streaming multiprocessors
DECODE_TARGET = 4 * SMS  # decode route: thread blocks to aim for (~4 per SM)
SCRATCH_BYTES = 8 << 20  # decode route: most bytes of K-split partial sums (L2-resident)


def route(M: int, N: int, K: int, block: int, x_dtype: torch.dtype) -> str:
    """For a bf16, 128-block product: ``"decode"`` below ``TC_MIN_ROWS``
    rows of x, ``"wgmma"`` from there on; ``"cuda_core"`` for everything
    else (fp16 or fp32 x, any other block)."""
    if x_dtype != torch.bfloat16 or block != TC_BLOCK:
        return "cuda_core"
    return "decode" if M < TC_MIN_ROWS else "wgmma"


def decode_plan(M: int, N: int, K: int) -> tuple[int, int, int]:
    """(columns per block, splits, slabs per split) of the decode route.

    A block owns ``bn`` output columns and a contiguous range of 128-row K
    slabs.  ``bn`` is 128 when the 128-column tiles alone give two blocks
    per SM (the LM head), else 64.  The K slabs are split until there are
    ``DECODE_TARGET`` blocks, at most one split per slab, and while the
    partial sums (4 M N bytes per split, written once and read once by the
    second pass) fit in ``SCRATCH_BYTES``, well inside the 50 MB L2."""
    nkb = K // TC_BLOCK
    bn = 128 if N // 128 >= 2 * SMS else 64
    tiles = N // bn
    splits = max(1, min(nkb, -(-DECODE_TARGET // tiles), SCRATCH_BYTES // (4 * max(M, 1) * N)))
    per = -(-nkb // splits)
    return bn, -(-nkb // per), per


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
    """Why the tensor-core kernel cannot take these operands, or None.

    A pure function of shapes, strides, dtypes and pointers: row-major
    bf16 x [M, K] and E4M3 wq [K, N] at 16-byte aligned addresses (the TMA
    loads), K and N multiples of 128 = the quant block, fp32 scales
    [K/128, N/128]."""
    if x_dtype != torch.bfloat16 or wq_dtype != torch.float8_e4m3fn \
            or scales_dtype != torch.float32:
        return (f"takes bf16 x, e4m3 wq and float32 scales, got {x_dtype}, {wq_dtype}, "
                f"{scales_dtype}")
    if block != TC_BLOCK:
        return f"takes quant block {TC_BLOCK}, got {block}"
    if len(x_shape) != 2 or len(wq_shape) != 2:
        return f"takes 2-D x and wq, got {tuple(x_shape)} and {tuple(wq_shape)}"
    (M, K), N = x_shape, wq_shape[1]
    if wq_shape[0] != K or K % TC_BLOCK or N % TC_BLOCK:
        return f"x {tuple(x_shape)} @ wq {tuple(wq_shape)} needs K, N multiples of {TC_BLOCK}"
    if tuple(scales_shape) != (K // TC_BLOCK, N // TC_BLOCK):
        return f"scales {tuple(scales_shape)} for wq {tuple(wq_shape)}"
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
                      block: int = TC_BLOCK) -> torch.Tensor:
    """The decode route: bf16 x of 1 to ``TC_MIN_ROWS`` - 1 rows, block 128."""
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
                             ptr(scratch), M, K, N, bn, splits, per, stream_of(x))
    return y


def matmul_fp8_wgmma(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor, *,
                     block: int = TC_BLOCK) -> torch.Tensor:
    """The prefill route, any M >= 1 (``route`` sends it M >= TC_MIN_ROWS)."""
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
                            M, K, N, stream_of(x))
    return y


def matmul_fp8_cuda_core(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor, *,
                         block: int = 128) -> torch.Tensor:
    """The CUDA-core route: any M, bf16 / fp16 / fp32 x, any block that
    divides K and N (``route`` sends it what the tensor-core routes do not
    take)."""
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
    ``route``'s choice, or an error before any launch."""
    require_cuda(x, wq, scales)
    which = route(x.shape[0], wq.shape[1], wq.shape[0], block, x.dtype)
    return ROUTES[which](x, wq, scales, block=block)


ROUTES = {"decode": matmul_fp8_decode, "wgmma": matmul_fp8_wgmma,
          "cuda_core": matmul_fp8_cuda_core}
