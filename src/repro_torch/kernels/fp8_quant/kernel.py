"""Launch the CUDA fp8 block-quantize kernel (``csrc/fp8_quant.cu``).

Replaces ``repro/kernels/fp8_quant/kernel.py::quantize_fp8_pallas``; the
source's header says what bounds it on the H100 and how it is built.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import f32_reciprocal
from repro_torch.kernels._lib import FP8_QUANT, ptr, require_cuda, stream_of


def quantize_fp8_cuda(w: torch.Tensor, alpha: torch.Tensor, *, block: int = 128,
                      qmax: float = 448.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``ref.quantize_fp8_ref``, on the GPU."""
    require_cuda(w, alpha)
    if w.dtype != torch.float32 or alpha.dtype != torch.float32 or alpha.numel() != 1:
        raise TypeError("fp8_quant kernel takes float32 w and a float32 alpha[1]")
    I, O = w.shape
    if I % block or O % block:
        raise ValueError(f"fp8_quant kernel needs block multiples, got {tuple(w.shape)}")
    q = torch.empty((I, O), dtype=torch.float8_e4m3fn, device=w.device)
    scales = torch.empty((I // block, O // block), dtype=torch.float32, device=w.device)
    FP8_QUANT.launch("quantize_fp8", ptr(w), ptr(alpha), ptr(q), ptr(scales), I, O,
                     block, qmax, f32_reciprocal(qmax), stream_of(w))
    return q, scales
