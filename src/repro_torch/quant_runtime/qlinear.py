"""Quantization-aware linear application.

Port of ``repro/quant_runtime/qlinear.py``.  Every matmul of the model code
routes through :func:`matmul`, so a weight leaf may be a dense tensor or a
:class:`QuantizedTensor`.  A 2-D block-granularity E4M3 weight whose edges
are block multiples goes to the fused dequant-matmul (``kernels.fp8_matmul``:
the CUDA kernel on the GPU, its plain version on the CPU); every other
quantized weight is dequantized and multiplied.  The block-scale kernel is
never handed a channel- or tensor-granularity tensor.
"""
from __future__ import annotations

import torch

from repro_torch.quant_runtime.qparams import QuantizedTensor


def resolve(w):
    """A dense tensor for a (possibly quantized) weight leaf."""
    if isinstance(w, QuantizedTensor):
        return w.dequantize()
    return w


def _fused_kernel_applies(w: QuantizedTensor) -> bool:
    return (w.ndim == 2 and w.granularity == "block" and w.fmt == "fp8_e4m3"
            and w.shape[0] % w.block_size == 0 and w.shape[1] % w.block_size == 0)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w with w possibly quantized. x: [..., in], w: [in, out]."""
    if isinstance(w, QuantizedTensor):
        if _fused_kernel_applies(w):
            from repro_torch.kernels.fp8_matmul import ops as fp8_matmul
            return fp8_matmul.matmul_fp8(x, w)
        w = w.dequantize()
    return torch.matmul(x, w.to(x.dtype))


def matmul_t(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w.T`` with ``w`` possibly quantized (the tied-embedding LM head).

    For tensor/channel-granularity tables the scales move to the cheap side
    of the transpose (``x @ (q*s).T == (x*s[0]) @ q.T`` for channel scales,
    ``s * (x @ q.T)`` for a scalar); block tables are dequantized."""
    if not isinstance(w, QuantizedTensor):
        return torch.matmul(x, w.T.to(x.dtype))
    if w.ndim == 2 and w.granularity in ("tensor", "channel"):
        q = w.data.float()
        x32 = x.float()
        if w.granularity == "channel":
            out = torch.matmul(x32 * w.scale.float()[0], q.T)
        else:
            out = torch.matmul(x32, q.T) * w.scale.float()
        return out.to(x.dtype)
    return torch.matmul(x, w.dequantize().T.to(x.dtype))


def take(embedding, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup; a quantized table dequantizes only the gathered rows."""
    if isinstance(embedding, QuantizedTensor) and embedding.ndim == 2:
        return _take_quantized(embedding, ids)
    return resolve(embedding)[ids]


def _take_quantized(w: QuantizedTensor, ids: torch.Tensor) -> torch.Tensor:
    """Row-gathered dequantization, equal to ``w.dequantize()[ids]``."""
    flat = ids.reshape(-1).long()
    q = w.data[flat].float()                                    # [N, O]
    if w.granularity == "block":
        bs = w.block_size
        s = w.scale[flat // bs][:, 0, :, 0]                     # [N, O/bs]
        rows = q * s.repeat_interleave(bs, dim=1)[:, : q.shape[-1]]
    else:  # tensor: scalar; channel: [1, O] — both broadcast over rows
        rows = q * w.scale
    out = rows.to(getattr(torch, w.out_dtype))
    return out.reshape(*ids.shape, out.shape[-1])
