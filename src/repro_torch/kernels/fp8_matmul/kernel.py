"""Launch the CUDA fused block-dequant fp8 matmul (``csrc/fp8_matmul.cu``).

Replaces ``repro/kernels/fp8_matmul/kernel.py::matmul_fp8_pallas``; the
source's header says what bounds it on the H100 and how it is built.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._lib import FP8_MATMUL, ptr, require_cuda, stream_of

ROWS, COLS = 8, 128      # rows of x / output columns per thread block
MAX_BLOCK = 256          # largest quant block edge the kernel takes
TARGET_BLOCKS = 2 * 132  # two thread blocks per H100 SM


def split_k(M: int, N: int, K: int, block: int) -> tuple[int, int]:
    """(splits, slabs per split): split the K slabs across the grid when the
    output tiles alone leave SMs idle (decode)."""
    tiles = -(-N // COLS) * -(-M // ROWS)
    nkb = K // block
    splits = max(1, min(nkb, -(-TARGET_BLOCKS // tiles)))
    per = -(-nkb // splits)
    return -(-nkb // per), per


def matmul_fp8_cuda(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor, *,
                    block: int = 128) -> torch.Tensor:
    """Same contract as ``ref.matmul_fp8_ref``, on the GPU (x must be bf16)."""
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
