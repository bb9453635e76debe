"""Launch the CUDA fp8 block-quantize kernel (``csrc/fp8_quant.cu``).

Replaces ``repro/kernels/fp8_quant/kernel.py::quantize_fp8_pallas``; the
source's header says what bounds it on the H100 and how it is built.  It
has two instances: :func:`quant_instance` picks one from the block and
w's address alone, and :func:`quant_operand_error` says, before any
launch, what neither takes.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import f32_reciprocal
from repro_torch.kernels._lib import FP8_QUANT, ptr, require_cuda, stream_of

TILE = 128                              # the register-tile instance's block edge
INSTANCES = {"general": 0, "tile": 1}   # csrc/fp8_quant.cu::quantize_fp8's instance codes


def quant_instance(block: int, w_ptr: int) -> str:
    """``"tile"`` (one 128 x 128 tile per thread block, held in registers,
    16-byte loads) for block 128 and a 16-byte aligned w; ``"general"``
    (scalar loads, any block) otherwise."""
    return "tile" if block == TILE and w_ptr % 16 == 0 else "general"


def quant_operand_error(w_shape, w_strides, w_dtype, alpha_shape, alpha_dtype,
                        block: int) -> str | None:
    """Why the quantizer cannot take these operands, or None: a row-major
    float32 w [I, O] of block multiples and a float32 alpha [1]."""
    if w_dtype != torch.float32 or alpha_dtype != torch.float32:
        return f"takes float32 w and alpha, got {w_dtype} and {alpha_dtype}"
    if tuple(alpha_shape) != (1,):
        return f"takes alpha of shape (1,), got {tuple(alpha_shape)}"
    if len(w_shape) != 2:
        return f"takes a 2-D w, got {tuple(w_shape)}"
    I, O = w_shape
    if block < 1 or I % block or O % block:
        return f"w {tuple(w_shape)} needs multiples of the block {block}"
    if tuple(w_strides) != (O, 1):
        return "w must be row-major and contiguous"
    return None


def quantize_fp8_cuda(w: torch.Tensor, alpha: torch.Tensor, *, block: int = 128,
                      qmax: float = 448.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``ref.quantize_fp8_ref``, on the GPU."""
    require_cuda(w, alpha)
    err = quant_operand_error(w.shape, w.stride(), w.dtype, alpha.shape, alpha.dtype, block)
    if err is not None:
        raise ValueError(f"fp8_quant: {err}")
    I, O = w.shape
    q = torch.empty((I, O), dtype=torch.float8_e4m3fn, device=w.device)
    scales = torch.empty((I // block, O // block), dtype=torch.float32, device=w.device)
    FP8_QUANT.launch("quantize_fp8", ptr(w), ptr(alpha), ptr(q), ptr(scales), I, O, block,
                     INSTANCES[quant_instance(block, w.data_ptr())], qmax,
                     f32_reciprocal(qmax), stream_of(w))
    return q, scales
