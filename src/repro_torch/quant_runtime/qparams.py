"""QuantizedTensor: low-precision weight storage as a parameter-tree leaf.

Port of ``repro/quant_runtime/qparams.py``.  Model code calls
``qlinear.matmul(x, w)`` for every linear; when ``w`` is a QuantizedTensor
the block-fp8 case goes to the fused dequant-matmul kernel and every other
case is dequantized on the fly.  A stacked ``[L, I, O]`` leaf keeps its
layers on the leading axis of ``data`` and ``scale``; ``layer(l)`` is the
2-D view the per-layer model loop uses.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.formats import get_format
from repro_torch.core.granularity import dequantize_stored


@dataclass
class QuantizedTensor:
    data: torch.Tensor           # storage repr (fp8/int8), same layout as W
    scale: torch.Tensor          # broadcastable scales (see granularity.py)
    fmt: str = "fp8_e4m3"
    granularity: str = "block"
    block_size: int = 128
    out_dtype: str = "bfloat16"  # dequantization target dtype

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    def layer(self, i: int) -> "QuantizedTensor":
        """The ``i``-th matrix of a stacked leaf (views, no copy)."""
        return QuantizedTensor(self.data[i], self.scale[i], self.fmt, self.granularity,
                               self.block_size, self.out_dtype)

    def dequantize(self) -> torch.Tensor:
        if self.data.ndim > 2:
            return torch.stack([self.layer(i).dequantize()
                                for i in range(self.data.shape[0])])
        return dequantize_stored(self.data, self.scale, self.granularity,
                                 get_format(self.fmt), self.block_size,
                                 getattr(torch, self.out_dtype))

    def nbytes(self) -> int:
        return self.data.numel() * get_format(self.fmt).bits // 8 + self.scale.numel() * 4
