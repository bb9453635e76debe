"""Registered calibration-based methods: SmoothQuant and AWQ (weight-only).

Port of ``repro/quantize/equalize.py``.  Both quantize ``Q(W diag(s)) /
diag(s)`` — numerically the same space as W, so the delta metrics stay
well-defined.  The per-input-channel equalization vector ``s`` comes from
activation statistics collected by :func:`collect_input_stats`, which flows
through the :meth:`Quantizer.calibrate` hook; without calibration the
methods fall back to unit activation scales (with a warning).

In storage mode ``s`` rides along on the emitted :class:`QuantizedTensor`
(``eq_scale``), so equalized trees serve through the same ``qlinear`` path
as DAQ trees — on the dequantize path: the fp8 kernel never takes them.

The reference runs this module's arithmetic eagerly, one compiled op at a
time, so its divisions are true divisions (``max|W s| / Qmax``,
``Q(W s) / s``), not the reciprocal multiplies of its jitted search; the
port divides the same way.  A denormal weight reads as a zero of its sign
(``metrics.daz``), as every compiled op of the reference reads it.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core import metrics as M
from repro_torch.core.formats import Format, get_format
from repro_torch.core.granularity import absmax, dequantize_stored, quantize_store, unequalize
from repro_torch.core.search import SearchResult, metrics_and_partials
from repro_torch.quant_runtime import qlinear
from repro_torch.quantize.api import LeafContext, Quantizer
from repro_torch.quantize.registry import register


def collect_input_stats(model, params, spec, n_batches: int = 2) -> list:
    """Full-sequence forwards of ``n_batches`` batches of 4 x 64 tokens of
    ``spec``'s language; returns ``[(w_shape, w_fingerprint, absmax[in])]``,
    one record per ``qlinear.matmul`` call, in call order.

    Records are keyed by the weight's value fingerprint
    (:func:`repro_torch.quant_runtime.qlinear.weight_fingerprint`), not by
    shape — same-shaped weights (wq/wo, gate/up, ...) would otherwise
    collide.  Repeated calls of one weight are max-merged by
    ``set_calibration``.  The batches come from ``torch.Generator``s seeded
    500 + i on the model's device (the reference's keys, in another stream).
    """
    from repro_torch.data.synthetic import sample_batch
    batches = []
    for i in range(n_batches):
        gen = torch.Generator(device=model.device).manual_seed(500 + i)
        batches.append(sample_batch(gen, spec, 4, 64, device=model.device)[:, :-1])
    return _record_input_stats(model, params, batches)


def _record_input_stats(model, params, token_batches) -> list:
    """The calibration records of forwards over ``token_batches`` ([B, S]
    each): ``qlinear.RECORD`` is a list for their duration, None after."""
    from repro_torch.data.synthetic import _full_logits
    qlinear.RECORD = []
    try:
        for toks in token_batches:
            _full_logits(model, params, {"tokens": toks})
        return qlinear.RECORD
    finally:
        qlinear.RECORD = None


def _absmax_scale(w: torch.Tensor, granularity: str, fmt: Format,
                  block_size: int) -> torch.Tensor:
    """AbsMax scale ``max|W| / Qmax`` by true division (module docstring).
    Qmax is a device tensor: PyTorch's CUDA division by a host scalar
    multiplies by its reciprocal instead, one ulp off the CPU's quotient."""
    return absmax(w, granularity, block_size) / torch.full(
        (), fmt.qmax, dtype=torch.float32, device=w.device)


def _qdq(w: torch.Tensor, scale: torch.Tensor, qcfg: QuantConfig, fmt: Format):
    """(codes, fp32 dequantized) of ``w`` at ``scale``."""
    w_q = quantize_store(w, scale, qcfg.granularity, fmt, qcfg.block_size)
    return w_q, dequantize_stored(w_q, scale, qcfg.granularity, fmt, qcfg.block_size,
                                  torch.float32)


def _qdq_scaled(w2d, s_vec, qcfg: QuantConfig, fmt: Format) -> torch.Tensor:
    """``Q(W diag(s)) / diag(s)`` at the AbsMax scale of ``W diag(s)``."""
    ws = w2d * s_vec[:, None]
    _, deq = _qdq(ws, _absmax_scale(ws, qcfg.granularity, fmt, qcfg.block_size), qcfg, fmt)
    return unequalize(deq, s_vec)


class _EqualizeQuantizer(Quantizer):
    """Shared machinery: stats matching, Q(W·s)/s, delta metrics."""

    requires_calibration = True

    def __init__(self):
        self._stats: dict[tuple, torch.Tensor] = {}
        self._warned_miss = False

    def calibrate(self, model, params, spec, *, n_batches: int = 2) -> list:
        return collect_input_stats(model, params, spec, n_batches)

    def set_calibration(self, calib) -> None:
        # stats match leaves by (shape, value-fingerprint) — exact, no
        # call-order bookkeeping; fingerprint collisions max-merge
        self._stats = {}
        if not calib:  # None or empty: nothing was recorded at all
            warnings.warn(
                f"{self.name}: no calibration stats (pass model=/spec= or "
                "calib=); equalization falls back to unit activation scales",
                stacklevel=3)
            return
        for shape, fp, amax in calib:
            key = (tuple(shape), fp)
            prev = self._stats.get(key)
            self._stats[key] = amax if prev is None else torch.maximum(prev, amax)

    def _equalization(self, w2d: torch.Tensor, a: torch.Tensor, wmax: torch.Tensor,
                      qcfg: QuantConfig, fmt: Format) -> torch.Tensor:
        raise NotImplementedError

    def _prepare_2d(self, wp, wb, qcfg: QuantConfig, name: str = "?") -> SearchResult:
        fmt = get_format(qcfg.fmt)
        amax = self._stats.get((tuple(wp.shape), qlinear.weight_fingerprint(wp)))
        wp32 = M.daz(wp).float()
        if amax is None:
            # a miss with stats present means the forward saw different
            # weight values than this leaf — surface it once.  Embedding
            # tables are exempt: they go through qlinear.take, never
            # qlinear.matmul, so no record can exist for them by design.
            if self._stats and not self._warned_miss and "embed" not in name.lower():
                self._warned_miss = True
                warnings.warn(
                    f"{self.name}: no calibration record matches leaf "
                    f"{name!r} {tuple(wp.shape)}; it (and any further "
                    "unmatched leaves) equalize with unit activation scales",
                    stacklevel=2)
            amax = torch.ones(wp32.shape[0], dtype=torch.float32, device=wp32.device)
        a = amax.float().clamp_min(1e-6)
        wmax = wp32.abs().amax(dim=1).clamp_min(1e-6)
        s = self._equalization(wp32, a, wmax, qcfg, fmt)
        s = (s / s.amax().clamp_min(1e-6)).clamp_min(1e-4)

        ws = wp32 * s[:, None]
        scale = _absmax_scale(ws, qcfg.granularity, fmt, qcfg.block_size)
        w_q, deq = _qdq(ws, scale, qcfg, fmt)
        del ws
        wb32 = M.daz(wb).float()
        dp = wp32 - wb32
        chosen = metrics_and_partials(dp, unequalize(deq, s).sub_(wb32))
        del deq
        # default baseline: plain AbsMax at the same granularity, no
        # equalization — mirrors SearchResult.default for the DAQ methods
        _, deq0 = _qdq(wp32, _absmax_scale(wp32, qcfg.granularity, fmt, qcfg.block_size),
                       qcfg, fmt)
        default = metrics_and_partials(dp, deq0.sub_(wb32))
        return SearchResult(alpha=s, scale=scale, w_q=w_q, chosen=chosen, default=default,
                            eq_scale=s)

    def prepare(self, ctx: LeafContext) -> SearchResult:
        wp, wb, qcfg = ctx.w_post, ctx.w_base, ctx.qcfg
        if wp.ndim == 2:
            return self._prepare_2d(wp, wb, qcfg, ctx.name)
        # stacked layers (an expert stack [n, E, D, F] too): each slice looks
        # up its own stats by fingerprint; the codes land in one
        # preallocated tensor, as in quantize/daq.py
        lead = wp.shape[:-2]
        post2, base2 = wp.reshape(-1, *wp.shape[-2:]), wb.reshape(-1, *wb.shape[-2:])
        parts, w_q = [], None
        for t in range(post2.shape[0]):
            # the reference's name of the slice: one [i] per leading axis
            idx = "".join(f"[{int(i)}]" for i in torch.unravel_index(torch.tensor(t), lead))
            r = self._prepare_2d(post2[t], base2[t], qcfg, ctx.name + idx)
            if w_q is None:
                w_q = torch.empty(post2.shape, dtype=r.w_q.dtype, device=r.w_q.device)
            w_q[t] = r.w_q
            r.w_q = None
            parts.append(r)
        unflat = lambda t: t.reshape(*lead, *t.shape[1:])
        stack = lambda xs: unflat(torch.stack(xs))
        return SearchResult(
            alpha=stack([r.alpha for r in parts]), scale=stack([r.scale for r in parts]),
            w_q=unflat(w_q), eq_scale=stack([r.eq_scale for r in parts]),
            chosen={k: stack([r.chosen[k] for r in parts]) for k in parts[0].chosen},
            default={k: stack([r.default[k] for r in parts]) for k in parts[0].default})


@register("smoothquant")
class SmoothQuantQuantizer(_EqualizeQuantizer):
    """Fixed migration strength alpha = 0.5: s = sqrt(a_max) / sqrt(w_max)."""

    def _equalization(self, w2d, a, wmax, qcfg, fmt):
        # float64 square roots rounded to float32 are the correctly rounded
        # float32 ones, as the reference's; the CPU's float32 torch.sqrt is
        # not always
        return torch.sqrt(a.double()).float() / torch.sqrt(wmax.double()).float()


def awq_trials(w2d, a, wmax, qcfg: QuantConfig, fmt: Format, grid=None):
    """AWQ's candidates for one 2-D weight: (s_tries [len(grid), I], errs
    [len(grid)]), ``errs`` the activation-weighted output squared error of
    ``Q(W s) / s`` at each exponent of ``grid`` (default ``AWQQuantizer.GRID``).

    The powers are evaluated in float64 and rounded to float32: within an
    ulp of the reference's (glibc ``powf``, which XLA's CPU backend calls)
    where float32 ``torch.pow`` is not, and the same on the card and the
    CPU.  The error sums run in another order than the reference's, so an
    exponent can differ where two errors nearly tie."""
    grid = AWQQuantizer.GRID if grid is None else grid
    a64, w64 = a.double(), wmax.double()
    s_tries = torch.stack([(a64.pow(al).float() / w64.pow(1 - al).float()).clamp_min(1e-6)
                           for al in grid])
    errs = torch.stack([(((_qdq_scaled(w2d, s, qcfg, fmt) - w2d) * a[:, None]) ** 2).sum()
                        for s in s_tries])
    return s_tries, errs


@register("awq")
class AWQQuantizer(_EqualizeQuantizer):
    """Alpha grid per leaf, picked by activation-weighted output MSE."""

    GRID = (0.0, 0.25, 0.5, 0.75, 1.0)

    def _equalization(self, w2d, a, wmax, qcfg, fmt):
        s_tries, errs = awq_trials(w2d, a, wmax, qcfg, fmt, self.GRID)
        return s_tries[torch.argmin(errs)]
