"""Coarse-to-fine scale search (paper Algorithm 1).

Port of ``repro/core/search.py``.  The search optimizes ONE alpha multiplier
per weight tensor, applied on top of the AbsMax default scales s0: a coarse
uniform grid over [alpha_min, alpha_max], then a fine grid around the best
coarse candidate.  alpha = 1 (AbsMax) is the initial incumbent and a
candidate replaces it only on a strict improvement (Alg. 1 lines 4-24), so
the search never scores worse than AbsMax on the chosen metric.

The reference's ``lax.map`` over candidates is a Python loop here; the
fused variant evaluates every candidate of a stage in one pass over the
weights with the sweep kernel.  Per-block alpha is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core import metrics as M
from repro_torch.core.formats import f32_reciprocal, get_format
from repro_torch.core.granularity import (absmax, apply_qdq, dequantize_stored,
                                          quantize_store, scale_from_absmax)


@dataclass
class SearchResult:
    """Result of quantizing one weight tensor (``[I, O]`` or stacked ``[L, I, O]``)."""
    alpha: torch.Tensor         # chosen multiplier: scalar, or [L] when stacked
    scale: torch.Tensor         # final scale(s) = alpha * s0
    w_q: torch.Tensor           # storage representation (fp8/int8), layout of W
    chosen: dict                # metrics + partial sums at the chosen alpha
    default: dict               # metrics + partial sums at alpha = 1 (AbsMax)


def linspace(start, stop, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 as the reference's XLA
    compile evaluates it: ``start * (1 - i*c) + i * (stop*c)`` with
    ``c = 1/(num-1)`` and the last point exactly ``stop``.  (On the CPU, XLA
    may further contract the sum into an FMA when the endpoints are traced
    values — the reference's fine grid — so a point can differ from this
    one by one ulp there.)"""
    start = torch.as_tensor(start, dtype=torch.float32, device=device).reshape(())
    stop = torch.as_tensor(stop, dtype=torch.float32, device=device).reshape(())
    if num == 1:
        return start.reshape(1)
    c = f32_reciprocal(num - 1)
    i = torch.arange(num - 1, dtype=torch.float32, device=device)
    return torch.cat([start * (1 - i * c) + i * (stop * c), stop.reshape(1)])


def _eval_alpha(alpha, w_post, dp, w_base, amax, qcfg: QuantConfig):
    fmt = get_format(qcfg.fmt)
    dq = apply_qdq(w_post, scale_from_absmax(amax, alpha, fmt), qcfg.granularity, fmt,
                   qcfg.block_size) - w_base
    return M.objective(qcfg.metric, dp, dq, qcfg.hybrid_lambda)


def search_scale(w_post: torch.Tensor, w_base: torch.Tensor,
                 qcfg: QuantConfig) -> SearchResult:
    """Paper Algorithm 1 on a single 2-D weight.

    Dispatches to the fused one-pass sweep when ``qcfg.use_fused_kernel``
    (block fp8_e4m3 only; same argmax by construction)."""
    if qcfg.per_block_alpha:
        raise NotImplementedError("per_block_alpha is not ported to repro_torch yet")
    if qcfg.use_fused_kernel and qcfg.granularity == "block" \
            and qcfg.fmt == "fp8_e4m3":
        return _search_fused(w_post, w_base, qcfg)

    fmt = get_format(qcfg.fmt)
    dev = w_post.device
    w_post = w_post.float()
    w_base = w_base.float()
    dp = w_post - w_base
    amax = absmax(w_post, qcfg.granularity, qcfg.block_size)

    def stage(best_alpha, best_m, grid):
        ms = torch.stack([_eval_alpha(a, w_post, dp, w_base, amax, qcfg) for a in grid])
        idx = torch.argmax(ms)
        take = ms[idx] > best_m                      # strict improvement only
        return torch.where(take, grid[idx], best_alpha), torch.maximum(ms[idx], best_m)

    # init: alpha = 1 (Alg. 1 lines 4-6)
    best_alpha = torch.ones((), dtype=torch.float32, device=dev)
    best_m = _eval_alpha(best_alpha, w_post, dp, w_base, amax, qcfg)
    # coarse stage (lines 7-15)
    best_alpha, best_m = stage(best_alpha, best_m,
                               linspace(qcfg.alpha_min, qcfg.alpha_max, qcfg.n_coarse, dev))
    # fine stage (lines 16-24)
    delta = qcfg.resolved_fine_delta()
    lo = torch.clamp_min(best_alpha - delta, qcfg.alpha_min)
    hi = torch.clamp_max(best_alpha + delta, qcfg.alpha_max)
    best_alpha, _ = stage(best_alpha, best_m, linspace(lo, hi, qcfg.n_fine, dev))
    return _finalize(w_post, w_base, dp, best_alpha, amax, qcfg)


def metrics_and_partials(dp: torch.Tensor, dq: torch.Tensor) -> dict:
    """Whole-tensor metrics + full-reduction partial sums for (dp, dq) — the
    common currency of ``SearchResult.chosen`` / ``.default``."""
    p = M.partial_sums(dp, dq, tuple(range(dp.ndim)))
    return {**M.metrics_from_partials(p), **p}


def _finalize(w_post, w_base, dp, alpha, amax, qcfg: QuantConfig) -> SearchResult:
    """Storage codes at the chosen alpha plus the chosen / default metrics.
    Block fp8_e4m3 codes come from the fp8_quant kernel, bit-equal to
    ``quantize_store`` at ``scale = scale_from_absmax(amax, alpha)``."""
    fmt = get_format(qcfg.fmt)
    gran, bs = qcfg.granularity, qcfg.block_size
    if gran == "block" and qcfg.fmt == "fp8_e4m3":
        from repro_torch.kernels.fp8_quant import ops as FQ
        w_q, scales = FQ.quantize_fp8(w_post, alpha, block=bs)
        scale = scales[:, None, :, None]
    else:
        scale = scale_from_absmax(amax, alpha, fmt)
        w_q = quantize_store(w_post, scale, gran, fmt, bs)
    dq = dequantize_stored(w_q, scale, gran, fmt, bs, torch.float32).sub_(w_base)
    chosen = metrics_and_partials(dp, dq)
    del dq
    dq0 = apply_qdq(w_post, scale_from_absmax(amax, 1.0, fmt), gran, fmt, bs).sub_(w_base)
    default = metrics_and_partials(dp, dq0)
    return SearchResult(alpha=alpha, scale=scale, w_q=w_q, chosen=chosen,
                        default=default)


# ---------------------------------------------------------------------------
# Fused-kernel search: Alg. 1 with the one-pass candidate sweep.
# ---------------------------------------------------------------------------

def _search_fused(w_post, w_base, qcfg: QuantConfig) -> SearchResult:
    """Same coarse->fine argmax as `search_scale`, but each stage evaluates
    ALL candidates in ONE pass over the weights (kernels/scale_search)."""
    from repro_torch.kernels.scale_search import ops as K

    dev = w_post.device
    w_post = w_post.float()
    w_base = w_base.float()
    amax = absmax(w_post, "block", qcfg.block_size)     # [I/bs, 1, O/bs, 1]
    amax_2d = amax[:, 0, :, 0]

    def stage_best(alphas):
        parts = K.sweep(w_post, w_base, alphas, block_size=qcfg.block_size, amax=amax_2d)
        objs = K.objective_values(parts, qcfg.metric, qcfg.hybrid_lambda)
        return alphas[torch.argmax(objs)]

    # stage 1: incumbent alpha=1 rides along with the coarse grid
    one = torch.ones(1, dtype=torch.float32, device=dev)
    best_alpha = stage_best(torch.cat([one, linspace(qcfg.alpha_min, qcfg.alpha_max,
                                                     qcfg.n_coarse, dev)]))
    # stage 2: fine grid around the best candidate (+ incumbent)
    delta = qcfg.resolved_fine_delta()
    lo = torch.clamp_min(best_alpha - delta, qcfg.alpha_min)
    hi = torch.clamp_max(best_alpha + delta, qcfg.alpha_max)
    best_alpha = stage_best(torch.cat([best_alpha.reshape(1),
                                       linspace(lo, hi, qcfg.n_fine, dev)]))
    return _finalize(w_post, w_base, w_post - w_base, best_alpha, amax, qcfg)
