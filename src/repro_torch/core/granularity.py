"""Scale granularities: per-tensor, per-channel, block-wise.

Port of ``repro/core/granularity.py``.  A weight is 2-D ``[in, out]``;
scales broadcast against its blocked view:

  tensor  : scalar ()
  channel : [1, out]
  block   : [in/bs, 1, out/bs, 1]  (against the ``[in/bs, bs, out/bs, bs]`` view)

Ragged edges are zero-padded; padding never affects absmax scales and is
stripped on the way out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.formats import Format, dequantize, f32_reciprocal, quantize

EPS = 1e-12


def pad_to_blocks(w: torch.Tensor, bs: int) -> tuple[torch.Tensor, tuple[int, int]]:
    i, o = w.shape
    pi, po = (-i) % bs, (-o) % bs
    if pi or po:
        w = F.pad(w, (0, po, 0, pi))
    return w, (i, o)


def to_blocked(w: torch.Tensor, bs: int) -> torch.Tensor:
    """[I, O] -> [I/bs, bs, O/bs, bs] (caller must pre-pad)."""
    i, o = w.shape
    return w.reshape(i // bs, bs, o // bs, bs)


def from_blocked(wb: torch.Tensor, orig: tuple[int, int]) -> torch.Tensor:
    nb_i, bs, nb_o, _ = wb.shape
    return wb.reshape(nb_i * bs, nb_o * bs)[: orig[0], : orig[1]]


def absmax(w: torch.Tensor, granularity: str, block_size: int = 128) -> torch.Tensor:
    """max|W| (clamped to EPS) at the requested granularity.

    Returned shape: tensor -> (); channel -> [1, O]; block -> [I/bs, 1, O/bs, 1].
    """
    w = w.float()
    if granularity == "tensor":
        amax = w.abs().amax()
    elif granularity == "channel":
        amax = w.abs().amax(dim=0, keepdim=True)                  # [1, O]
    elif granularity == "block":
        wp, _ = pad_to_blocks(w, block_size)
        amax = to_blocked(wp, block_size).abs().amax(dim=(1, 3), keepdim=True)
    else:
        raise ValueError(f"unknown granularity {granularity!r}")
    return amax.clamp_min(EPS)


def scale_from_absmax(amax: torch.Tensor, alpha, fmt: Format) -> torch.Tensor:
    """The scale ``alpha * max|W| / Qmax``, evaluated as
    ``amax * (alpha * (1/Qmax))``: the association the reference's jit
    compiles ``alpha * absmax_scale(W)`` to (it folds the constant ``1/Qmax``
    into ``alpha``), so the port's scales — and the codes they produce — are
    the reference's bit for bit.  At ``alpha = 1`` this is ``absmax_scale``."""
    return amax * (alpha * f32_reciprocal(fmt.qmax))


def absmax_scale(w: torch.Tensor, granularity: str, fmt: Format,
                 block_size: int = 128) -> torch.Tensor:
    """Default AbsMax scale s0 = max|W| / Qmax at the requested granularity."""
    return scale_from_absmax(absmax(w, granularity, block_size), 1.0, fmt)


def apply_qdq(w: torch.Tensor, scale: torch.Tensor, granularity: str, fmt: Format,
              block_size: int = 128) -> torch.Tensor:
    """Quantize-dequantize W under scales of the given granularity (fp32 out)."""
    return dequantize_stored(quantize_store(w, scale, granularity, fmt, block_size),
                             scale, granularity, fmt, block_size, torch.float32)


def quantize_store(w: torch.Tensor, scale: torch.Tensor, granularity: str, fmt: Format,
                   block_size: int = 128) -> torch.Tensor:
    """Quantize to the storage representation (same layout as W, low dtype)."""
    w32 = w.float()
    if granularity in ("tensor", "channel"):
        return quantize(w32, scale, fmt)
    wp, orig = pad_to_blocks(w32, block_size)
    qb = quantize(to_blocked(wp, block_size), scale, fmt)
    return from_blocked(qb, orig)


def dequantize_stored(q: torch.Tensor, scale: torch.Tensor, granularity: str, fmt: Format,
                      block_size: int = 128,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dequantize a stored representation back to floats."""
    if granularity in ("tensor", "channel"):
        return dequantize(q, scale, fmt, out_dtype)
    qp, orig = pad_to_blocks(q.float(), block_size)
    return from_blocked(to_blocked(qp, block_size) * scale, orig).to(out_dtype)
