"""Gradient compression for the data-parallel all-reduce: int8 with error
feedback (EF-SGD style).

Port of ``repro/optim/compress.py``.  Each leaf's gradient plus its carried
residual is quantized in blocks of 512 along the flattened leaf (symmetric
absmax, 127 levels); the dequantized value is what the all-reduce would
carry and the residual ``g + err - gq`` is kept for the next step, so the
compression error does not accumulate.  ``amax / 127`` is the reference's
jitted reciprocal multiply, so the codes are the reference's bit for bit.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.formats import f32_reciprocal
from repro_torch.core.policy import tree_map

BLOCK = 512
_INV127 = f32_reciprocal(127.0)


def _q(x: torch.Tensor):
    flat = x.reshape(-1)
    n = flat.shape[0]
    nb = -(-n // BLOCK)
    flat = torch.nn.functional.pad(flat, (0, nb * BLOCK - n)).reshape(nb, BLOCK)
    scale = flat.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) * _INV127
    q = torch.round(flat / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dq(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return (q.to(scale.dtype) * scale).reshape(-1)[:n].reshape(shape)


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def compress_grads(grads: Any, err: Any):
    """Returns (quant-dequant grads in each gradient's dtype, new error
    state): the grads are what the all-reduce sees, and ``err`` carries what
    the compression dropped."""
    def leaf(g, e):
        g32 = g.float() + e
        q, scale = _q(g32)
        gq = _dq(q, scale, g.shape)
        # q * scale is exact in float64 and close to g32, so the float64
        # difference is exact too: one rounding, the FMA's
        exact = _dq(q.double(), scale.double(), g.shape)
        return gq.to(g.dtype), (g32.double() - exact).float()

    if isinstance(grads, dict):
        out = {k: compress_grads(grads[k], err[k]) for k in grads}
        return {k: o[0] for k, o in out.items()}, {k: o[1] for k, o in out.items()}
    return leaf(grads, err)
