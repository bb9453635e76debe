"""Quantization-aware linear application.

Port of ``repro/quant_runtime/qlinear.py``.  Every matmul of the model code
routes through :func:`matmul`, so a weight leaf may be a dense tensor or a
:class:`QuantizedTensor`.  A 2-D block-granularity E4M3 weight goes to the
fused dequant-matmul (``kernels.fp8_matmul``: the CUDA kernel on the GPU,
its plain version on the CPU; a ragged one through its zero-padded block
grid); every other quantized weight is dequantized and multiplied.  The
block-scale kernel is never handed a channel- or tensor-granularity
tensor, nor an equalized one (its ``eq_scale`` divides the dequantized
rows, which the kernel does not).
"""
from __future__ import annotations

import torch

from repro_torch.core.granularity import unequalize
from repro_torch.quant_runtime.qparams import QuantizedTensor

# Calibration hook: when set to a list, every matmul appends
# (weight_shape, weight_fingerprint, per-in-channel |x| max) -- the
# SmoothQuant / AWQ statistics (``quantize/equalize.py``).  When None,
# matmul adds no operation and no host synchronization.
RECORD: list | None = None


def weight_fingerprint(w) -> tuple:
    """Identity of a dense 2-D weight for calibration matching:
    ``(w[0, 0], w[-1, -1], mean |w|)`` of its float32 cast.  Shape alone
    collides (wq/wo, gate/up share shapes), so statistics are keyed by
    sampled values.  Calibration and quantization must compute it with this
    one function on one device: the mean's reduction order, and so its last
    bits, differ across devices and frameworks (the reference states the
    same contract for its backends)."""
    w32 = w.float()
    return (float(w32[0, 0]), float(w32[-1, -1]), float(w32.abs().mean()))


def resolve(w):
    """A dense tensor for a (possibly quantized) weight leaf."""
    if isinstance(w, QuantizedTensor):
        return w.dequantize()
    return w


def resolve_as(w, dtype: torch.dtype) -> torch.Tensor:
    """``resolve(w).to(dtype)`` bit for bit, without the intermediate copy
    where that holds: a quantized leaf whose ``out_dtype`` is float32 or
    ``dtype`` dequantizes straight to ``dtype`` (its fp32 values rounded
    once), so a full-width expert stack never has an fp32 copy."""
    if isinstance(w, QuantizedTensor) and getattr(torch, w.out_dtype) in (torch.float32, dtype):
        return w.dequantize(dtype)
    return resolve(w).to(dtype)


def _fused_kernel_applies(w: QuantizedTensor) -> bool:
    return (w.ndim == 2 and w.granularity == "block" and w.fmt == "fp8_e4m3"
            and w.eq_scale is None)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w with w possibly quantized. x: [..., in], w: [in, out]."""
    if RECORD is not None:
        w_res = resolve(w)
        RECORD.append((tuple(w_res.shape), weight_fingerprint(w_res),
                       x.reshape(-1, x.shape[-1]).abs().amax(dim=0)))
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
    ``s * (x @ q.T)`` for a scalar) and a row-wise ``eq_scale`` divides the
    output columns; block tables are dequantized."""
    if not isinstance(w, QuantizedTensor):
        return torch.matmul(x, w.T.to(x.dtype))
    if w.ndim == 2 and w.granularity in ("tensor", "channel"):
        q = w.data.float()
        x32 = x.float()
        if w.granularity == "channel":
            out = torch.matmul(x32 * w.scale.float()[0], q.T)
        else:
            out = torch.matmul(x32, q.T) * w.scale.float()
        if w.eq_scale is not None:          # per-row divisor of w
            out = out / w.eq_scale.float()
        return out.to(x.dtype)
    return torch.matmul(x, w.dequantize().T.to(x.dtype))


def take(embedding, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup; a quantized table dequantizes only the gathered rows."""
    if isinstance(embedding, QuantizedTensor) and embedding.ndim == 2:
        return _take_quantized(embedding, ids)
    return resolve(embedding)[ids]


def _take_quantized(w: QuantizedTensor, ids: torch.Tensor) -> torch.Tensor:
    """Row-gathered dequantization, equal to ``w.dequantize()[ids]`` (the
    same fp32 q * scale, the same ``eq_scale`` division)."""
    flat = ids.reshape(-1).long()
    q = w.data[flat].float()                                    # [N, O]
    if w.granularity == "block":
        bs = w.block_size
        s = w.scale[flat // bs][:, 0, :, 0]                     # [N, O/bs]
        rows = q * s.repeat_interleave(bs, dim=1)[:, : q.shape[-1]]
    else:  # tensor: scalar; channel: [1, O] — both broadcast over rows
        rows = q * w.scale
    if w.eq_scale is not None:
        rows = unequalize(rows, w.eq_scale[flat])
    out = rows.to(getattr(torch, w.out_dtype))
    return out.reshape(*ids.shape, out.shape[-1])
