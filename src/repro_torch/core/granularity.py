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
    """Dequantize a stored representation back to floats: the fp32 product
    of codes and scales rounded once to ``out_dtype``.  Float codes on whole
    blocks (leading axes allowed, the scales' ``[..., I/bs, 1, O/bs, 1]``)
    take one copy into the output, where every code is exact, and one
    in-place multiply by the scales: no fp32 temporary on the card."""
    if granularity in ("tensor", "channel"):
        return dequantize(q, scale, fmt, out_dtype)
    (i, o), bs = q.shape[-2:], block_size
    if q.dtype.is_floating_point and not (i % bs or o % bs):
        out = torch.empty(q.shape, dtype=out_dtype, device=q.device).copy_(q)
        out.view(*q.shape[:-2], i // bs, bs, o // bs, bs).mul_(scale)
        return out
    qp, orig = pad_to_blocks(q.float(), bs)
    return from_blocked(to_blocked(qp, bs) * scale, orig).to(out_dtype)


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor, granularity: str, fmt: Format,
                    block_size: int = 128, out_dtype: torch.dtype = torch.bfloat16,
                    eq_scale: torch.Tensor | None = None) -> torch.Tensor:
    """A stored leaf ``q [..., I, O]`` dequantized to ``out_dtype``; its
    scales and its equalization vector ``eq_scale [..., I]`` (which divides
    the fp32 rows before the cast) carry the same leading axes.  A stack on
    whole float blocks is one ``dequantize_stored`` call; any other stack is
    written matrix by matrix into one output, so no second copy of it and
    no fp32 copy of it is ever live."""
    lead, (i, o), bs = q.shape[:-2], q.shape[-2:], block_size
    if eq_scale is None and (not lead or granularity == "block" and q.dtype.is_floating_point
                             and not (i % bs or o % bs)):
        return dequantize_stored(q, scale, granularity, fmt, bs, out_dtype)
    if not lead:
        return unequalize(dequantize_stored(q, scale, granularity, fmt, bs, torch.float32),
                          eq_scale).to(out_dtype)
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    n = out.numel() // (i * o)
    qs, ss = q.reshape(n, i, o), scale.reshape(n, *scale.shape[len(lead):])
    es = None if eq_scale is None else eq_scale.reshape(n, i)
    for m, dst in enumerate(out.view(n, i, o)):
        dst.copy_(dequantize_leaf(qs[m], ss[m], granularity, fmt, bs, out_dtype,
                                  None if es is None else es[m]))
    return out


def unequalize(w: torch.Tensor, eq_scale: torch.Tensor) -> torch.Tensor:
    """fp32 rows ``w [I, O]`` divided by the equalization vector ``[I]``: a
    true division, as the reference's (eager) ``w / e[:, None]`` is."""
    return w / eq_scale.float()[:, None]
