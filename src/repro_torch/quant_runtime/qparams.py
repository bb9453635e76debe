"""QuantizedTensor: low-precision weight storage as a parameter-tree leaf.

Port of ``repro/quant_runtime/qparams.py``.  Model code calls
``qlinear.matmul(x, w)`` for every linear; when ``w`` is a QuantizedTensor
the block-fp8 case goes to the fused dequant-matmul kernel and every other
case is dequantized on the fly.  A stacked ``[L, I, O]`` leaf keeps its
layers on the leading axis of ``data`` and ``scale``; ``layer(l)`` is the
2-D view the per-layer model loop uses.  An equalized tensor (SmoothQuant /
AWQ) carries ``eq_scale``, its per-in-channel vector s: ``data`` stores
``Q(W * s)`` and dequantization divides the rows by s.

A block-granularity tensor whose last two edges are not multiples of the
block (Mamba-2's ``in_dt`` [1536, 48], its LM head [1536, 50280]) keeps its
codes in ``grid``, padded with zero codes to whole blocks, the grid its
scales already cover; ``data`` is the ``[..., :I, :O]`` view of it, so the
fused matmul reads whole blocks at 16-byte aligned rows and every other
reader sees the reference's layout.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core.formats import get_format
from repro_torch.core.granularity import dequantize_leaf


@dataclass
class QuantizedTensor:
    data: torch.Tensor           # storage repr (fp8/int8), same layout as W
    scale: torch.Tensor          # broadcastable scales (see granularity.py)
    fmt: str = "fp8_e4m3"
    granularity: str = "block"
    block_size: int = 128
    out_dtype: str = "bfloat16"  # dequantization target dtype
    eq_scale: torch.Tensor | None = None  # per-in-channel equalization s:
                                          # data stores Q(W*s), dequant /= s
    grid: torch.Tensor | None = field(default=None, repr=False, compare=False)
    # a ragged block tensor's codes on whole blocks (zeros past the edges);
    # made from ``data`` unless ``data`` is already its view

    def __post_init__(self):
        if self.granularity != "block" or self.data.ndim < 2:
            self.grid = None
            return
        bs = self.block_size
        (i, o), lead = self.data.shape[-2:], self.data.shape[:-2]
        padded = (*lead, -(-i // bs) * bs, -(-o // bs) * bs)
        if padded == tuple(self.data.shape):
            self.grid = None
            return
        g = self.grid
        if g is not None and tuple(g.shape) == padded and g.device == self.data.device \
                and g.data_ptr() == self.data.data_ptr() and g.stride() == self.data.stride():
            return
        g = self.data.new_zeros(padded)
        g[..., :i, :o] = self.data
        self.grid, self.data = g, g[..., :i, :o]

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    def layer(self, i: int) -> "QuantizedTensor":
        """The ``i``-th matrix of a stacked leaf (views, no copy)."""
        return QuantizedTensor(self.data[i], self.scale[i], self.fmt, self.granularity,
                               self.block_size, self.out_dtype,
                               None if self.eq_scale is None else self.eq_scale[i],
                               None if self.grid is None else self.grid[i])

    def dequantize(self, dtype: torch.dtype | None = None) -> torch.Tensor:
        """The weights ``q * scale`` (``/ eq_scale``) in ``out_dtype``, or in
        ``dtype``: the fp32 values rounded once to it, which is
        ``dequantize().to(dtype)`` bit for bit when ``out_dtype`` is
        float32 or ``dtype`` itself (``dequantize_leaf``)."""
        return dequantize_leaf(self.data, self.scale, self.granularity, get_format(self.fmt),
                               self.block_size, dtype or getattr(torch, self.out_dtype),
                               self.eq_scale)

    def nbytes(self) -> int:
        n = self.data.numel() * get_format(self.fmt).bits // 8 + self.scale.numel() * 4
        if self.eq_scale is not None:
            n += self.eq_scale.numel() * 4
        return n

