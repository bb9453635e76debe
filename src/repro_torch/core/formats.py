"""Low-precision number formats: quantize / dequantize primitives.

Port of ``repro/core/formats.py``.  ``quantize`` maps a float tensor to its
storage representation under a scale, ``dequantize`` maps it back, and
``qdq`` is the quantize-dequantize operator :math:`Q_s(W)` (paper Eq. 4).

FP8 casts saturate by clipping first (``x.to(torch.float8_e4m3fn)`` rounds
to nearest even, the same codes as the reference's cast once the value lies
in range); INT formats round half to even, then clip.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Format:
    name: str
    qmax: float                  # largest representable magnitude
    storage_dtype: torch.dtype   # dtype of the stored representation
    is_float: bool
    bits: int


FP8_E4M3 = Format("fp8_e4m3", 448.0, torch.float8_e4m3fn, True, 8)
FP8_E5M2 = Format("fp8_e5m2", 57344.0, torch.float8_e5m2, True, 8)
INT8 = Format("int8", 127.0, torch.int8, False, 8)
# INT4 stored widened in int8 (packing is a storage detail, not a numerics one)
INT4 = Format("int4", 7.0, torch.int8, False, 4)

FORMATS: dict[str, Format] = {f.name: f for f in (FP8_E4M3, FP8_E5M2, INT8, INT4)}


def get_format(name: str) -> Format:
    if name not in FORMATS:
        raise KeyError(f"unknown format {name!r}; available: {sorted(FORMATS)}")
    return FORMATS[name]


def f32_reciprocal(x: float) -> float:
    """``1/x`` rounded to float32.  The reference divides by constants such
    as ``qmax`` inside ``jax.jit``, where XLA rewrites ``a / c`` into
    ``a * (1/c)``; the port multiplies by this value so that scales, and the
    fp8 codes that depend on them, stay bit-equal to the reference's."""
    return float(np.float32(1.0) / np.float32(x))


def quantize(w: torch.Tensor, scale: torch.Tensor, fmt: Format) -> torch.Tensor:
    """Map ``w`` to low-precision storage under ``scale`` (broadcastable)."""
    scaled = (w / scale).float()
    if fmt.is_float:
        return scaled.clamp(-fmt.qmax, fmt.qmax).to(fmt.storage_dtype)
    rounded = torch.round(scaled)  # round-half-to-even, matches hardware RTNE
    return rounded.clamp(-fmt.qmax, fmt.qmax).to(fmt.storage_dtype)


def dequantize(q: torch.Tensor, scale: torch.Tensor, fmt: Format,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Map low-precision storage back to the floating-point domain."""
    return (q.float() * scale).to(out_dtype)


def qdq(w: torch.Tensor, scale: torch.Tensor, fmt: Format) -> torch.Tensor:
    """Quantize-dequantize operator :math:`Q_s(W)` (paper Eq. 4), fp32 out."""
    return dequantize(quantize(w, scale, fmt), scale, fmt)
