"""Launch the CUDA fused block-dequant fp8 matmul: two routes, one function.

Replaces ``repro/kernels/fp8_matmul/kernel.py::matmul_fp8_pallas``.  The
CUDA-core kernel (``csrc/fp8_matmul.cu``) streams the fp8 weights once and
serves decode (few rows of x); the tensor-core kernel
(``csrc/fp8_matmul_wgmma.cu``) runs bf16 wgmma and serves prefill.
:func:`route` picks one from the shapes alone; each source's header says
what bounds it on the H100.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._lib import (FP8_MATMUL, FP8_MATMUL_WGMMA, ptr, require_cuda,
                                      stream_of)

ROWS, COLS = 8, 128      # CUDA-core route: rows of x / output columns per thread block
MAX_BLOCK = 256          # largest quant block edge the CUDA-core route takes
TARGET_BLOCKS = 2 * 132  # two thread blocks per H100 SM
TC_MIN_ROWS = 16         # fewest rows of x that take the tensor-core route
TC_BLOCK = 128           # the one quant block edge the tensor-core route takes


def route(M: int, N: int, K: int, block: int) -> str:
    """``"wgmma"`` (tensor cores) for a 128-block product of at least
    ``TC_MIN_ROWS`` rows, else ``"cuda_core"``."""
    return "wgmma" if block == TC_BLOCK and M >= TC_MIN_ROWS else "cuda_core"


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


def matmul_fp8_wgmma(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor, *,
                     block: int = TC_BLOCK) -> torch.Tensor:
    """The tensor-core route, any M >= 1 (``route`` sends it M >= TC_MIN_ROWS)."""
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
    """The CUDA-core route, any M (``route`` sends it decode-sized M)."""
    require_cuda(x, wq, scales)
    if x.dtype != torch.bfloat16 or wq.dtype != torch.float8_e4m3fn \
            or scales.dtype != torch.float32:
        raise TypeError("fp8_matmul kernel takes bf16 x, e4m3 wq and float32 scales")
    M, K = x.shape
    N = wq.shape[1]
    if wq.shape[0] != K or K % block or N % block or block > MAX_BLOCK or N % 4 \
            or scales.shape != (K // block, N // block) or wq.data_ptr() % 4:
        raise ValueError(f"bad fp8_matmul operands x {tuple(x.shape)} wq "
                         f"{tuple(wq.shape)} scales {tuple(scales.shape)} block {block}")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    splits, per = split_k(M, N, K, block)
    scratch = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) \
        if splits > 1 else y
    FP8_MATMUL.launch("matmul_fp8", ptr(x), ptr(wq), ptr(scales), ptr(y), ptr(scratch),
                      M, K, N, block, splits, per, stream_of(x))
    return y


def matmul_fp8_cuda(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor, *,
                    block: int = 128) -> torch.Tensor:
    """Same contract as ``ref.matmul_fp8_ref``, on the GPU (x must be bf16):
    the kernel of ``route``'s choice, or an error."""
    require_cuda(x, wq, scales)
    if route(x.shape[0], wq.shape[1], wq.shape[0], block) == "wgmma":
        return matmul_fp8_wgmma(x, wq, scales, block=block)
    return matmul_fp8_cuda_core(x, wq, scales, block=block)
