"""Wrapper for the fused fp8 dequant-matmul.

``matmul_fp8(x, qt)`` consumes a block-granularity QuantizedTensor and
handles leading batch dims on x and the cast back to ``x.dtype``; the CUDA
kernel runs for GPU tensors, its plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fp8_matmul.kernel import matmul_fp8_cuda
from repro_torch.kernels.fp8_matmul.ref import matmul_fp8_ref


def matmul_fp8_2d(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor, *,
                  block: int = 128) -> torch.Tensor:
    """x [M, K] @ block-fp8 wq [K, N] -> fp32 [M, N]."""
    K, N = wq.shape
    if K % block or N % block:
        raise ValueError("fp8 weights must be padded to the quant block")
    if x.device.type == "cpu":
        return matmul_fp8_ref(x, wq, scales, block=block)
    return matmul_fp8_cuda(x.contiguous(), wq, scales.contiguous(), block=block)


def matmul_fp8(x: torch.Tensor, qt) -> torch.Tensor:
    """x [..., K] @ QuantizedTensor(block) -> [..., N] in x.dtype.

    A ragged weight multiplies through its zero-padded block grid
    (``qt.grid``): x gains zero columns up to the grid's rows when K is
    ragged, and the grid's extra output columns are dropped."""
    scales = qt.scale
    if scales.ndim == 4:      # [K/bs, 1, N/bs, 1] broadcast layout
        scales = scales[:, 0, :, 0]
    K, N = qt.shape
    wq = qt.data if qt.grid is None else qt.grid
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    if wq.shape[0] != K:
        x2 = torch.nn.functional.pad(x2, (0, wq.shape[0] - K))
    out = matmul_fp8_2d(x2, wq, scales, block=qt.block_size)
    return out[:, :N].to(x.dtype).reshape(*lead, N)
