"""Wrapper for the fp8 block-quantize kernel (pads ragged edges)."""
from __future__ import annotations

import torch

from repro_torch.core.granularity import pad_to_blocks
from repro_torch.kernels.fp8_quant.kernel import quantize_fp8_cuda
from repro_torch.kernels.fp8_quant.ref import quantize_fp8_ref


def quantize_fp8(w: torch.Tensor, alpha: float | torch.Tensor = 1.0, *,
                 block: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """w [I, O] -> (q [I, O] e4m3 (unpadded layout), scales [ceil(I/b), ceil(O/b)]).
    The CUDA kernel for GPU tensors, its plain version for CPU tensors."""
    I, O = w.shape
    wp, _ = pad_to_blocks(w.float(), block)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=w.device).reshape(1)
    fn = quantize_fp8_ref if w.device.type == "cpu" else quantize_fp8_cuda
    q, s = fn(wp.contiguous(), a, block=block)
    return q[:I, :O], s
