"""Plain PyTorch version of the fused block-dequant fp8 matmul (the kernel's oracle)."""
from __future__ import annotations

import torch


def matmul_fp8_ref(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor, *,
                   block: int = 128) -> torch.Tensor:
    """x [M, K]; wq [K, N] fp8; scales [K/block, N/block]. fp32 out."""
    K, N = wq.shape
    nk, nn = K // block, N // block
    w = (wq.float().reshape(nk, block, nn, block) * scales[:, None, :, None]).reshape(K, N)
    return torch.matmul(x.float(), w)
