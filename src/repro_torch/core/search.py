"""Coarse-to-fine scale search (paper Algorithm 1).

Port of ``repro/core/search.py``.  The search optimizes ONE alpha multiplier
per weight tensor, applied on top of the AbsMax default scales s0: a coarse
uniform grid over [alpha_min, alpha_max], then a fine grid around the best
coarse candidate.  alpha = 1 (AbsMax) is the initial incumbent and a
candidate replaces it only on a strict improvement (Alg. 1 lines 4-24), so
the search never scores worse than AbsMax on the chosen metric.

The reference's ``lax.map`` over candidates is a Python loop here; the
fused variant evaluates every candidate of a stage in one pass over the
weights with the sweep kernel.

Beyond-paper extension (``per_block_alpha=True``): an independent alpha per
block / channel, selected on a dense grid by the per-block objective
(``_search_per_block``).  For SignRate and MSE the objective is separable
across blocks, so the per-block argmax is the global optimum over the grid.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core import metrics as M
from repro_torch.core.formats import f32_reciprocal, get_format
from repro_torch.core.granularity import (absmax, apply_qdq, dequantize_stored,
                                          pad_to_blocks, quantize_store,
                                          scale_from_absmax, to_blocked)


@dataclass
class SearchResult:
    """Result of quantizing one weight tensor (``[I, O]`` or stacked ``[L, I, O]``)."""
    alpha: torch.Tensor         # chosen multiplier(s): scalar or per block /
                                # channel, with a leading [L] when stacked
    scale: torch.Tensor         # final scale(s) = alpha * s0
    w_q: torch.Tensor           # storage representation (fp8/int8), layout of W
    chosen: dict                # metrics + partial sums at the chosen alpha
    default: dict               # metrics + partial sums at alpha = 1 (AbsMax)
    eq_scale: torch.Tensor | None = None  # per-in-channel equalization vector
                                          # (SmoothQuant/AWQ); w_q stores W*s


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
    (block fp8_e4m3 only; same argmax by construction).  Denormal weights
    are read as zeros (``metrics.daz``), as the reference's compiled
    search reads them."""
    w_post, w_base = M.daz(w_post).float(), M.daz(w_base).float()
    if qcfg.per_block_alpha:
        return _search_per_block(w_post, w_base, qcfg)
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
    Block fp8_e4m3 codes at one alpha come from the fp8_quant kernel,
    bit-equal to ``quantize_store`` at ``scale = scale_from_absmax(amax,
    alpha)``; the kernel takes one alpha per tensor, as the reference's
    does, so a per-block or per-channel alpha takes ``quantize_store``."""
    fmt = get_format(qcfg.fmt)
    gran, bs = qcfg.granularity, qcfg.block_size
    if gran == "block" and qcfg.fmt == "fp8_e4m3" and alpha.ndim == 0:
        from repro_torch.kernels.fp8_quant import ops as FQ
        w_q, scales = FQ.quantize_fp8(w_post, alpha, block=bs)
        scale = scales[:, None, :, None]
    else:
        # the reference's compile keeps ``alpha * s0`` as written for the
        # per-block search's alphas: ``alpha * (amax * (1/Qmax))``, not
        # ``scale_from_absmax``'s association
        scale = (alpha * scale_from_absmax(amax, 1.0, fmt) if qcfg.per_block_alpha
                 else scale_from_absmax(amax, alpha, fmt))
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


# ---------------------------------------------------------------------------
# Beyond-paper: independent alpha per block / channel on a dense grid.
# ---------------------------------------------------------------------------

# elements of one slice of the per-block objectives: the candidates' fp32
# temporaries stay near 1 GB whatever the leaf (the [151552, 4096] embedding
# of GLM-4-9B is 2.5 GB in fp32); blocks and channels are independent, so a
# slice changes no block's objective
_SLICE = 1 << 26


def _candidate_grid(qcfg: QuantConfig, device) -> torch.Tensor:
    """The per-block grid: the incumbent alpha = 1, then the dense grid
    ``linspace(alpha_min, alpha_max, n_coarse + n_fine)`` (constant
    endpoints, which the reference's compile folds to the port's
    ``linspace`` bit for bit)."""
    return torch.cat([torch.ones(1, dtype=torch.float32, device=device),
                      linspace(qcfg.alpha_min, qcfg.alpha_max,
                               qcfg.n_coarse + qcfg.n_fine, device)])


def per_block_objectives(w_post: torch.Tensor, w_base: torch.Tensor,
                         qcfg: QuantConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(grid [n], objectives [n, ...]) of the per-block search on float32
    ``w_post`` / ``w_base``: ``[n, O]`` per channel, ``[n, I/bs, O/bs]`` per
    block (scored on the zero-padded blocked view, so a ragged block counts
    its pad zeros as sign matches over ``bs * bs``, as the reference does),
    ``[n]`` per tensor (the whole-tensor objective)."""
    fmt = get_format(qcfg.fmt)
    gran, bs, metric, lam = qcfg.granularity, qcfg.block_size, qcfg.metric, qcfg.hybrid_lambda
    grid = _candidate_grid(qcfg, w_post.device)
    amax = absmax(w_post, gran, bs)

    def score(wp, wb, amax, gran, axes):
        dp = wp - wb
        objs = []
        for a in grid:
            wq = apply_qdq(wp, scale_from_absmax(amax, a, fmt), gran, fmt, bs)
            if axes is None:
                objs.append(M.objective(metric, dp, wq.sub_(wb), lam))
            else:
                p = M.partial_sums(dp, wq.sub_(wb), axes)
                objs.append(M.objective_from_partials(metric, p, lam))
            del wq
        return torch.stack(objs)

    if gran == "tensor":
        return grid, score(w_post, w_base, amax, "tensor", None)
    if gran == "channel":        # channels are columns: slice the columns
        I, O = w_post.shape
        step = max(1, _SLICE // I)
        return grid, torch.cat([score(w_post[:, c:c + step], w_base[:, c:c + step],
                                      amax[:, c:c + step], "channel", (0,))
                                for c in range(0, O, step)], dim=1)
    # blocks: the padded blocked view, a slice of whole block rows at a time
    wp, _ = pad_to_blocks(w_post, bs)
    wb, _ = pad_to_blocks(w_base, bs)
    rows = max(1, _SLICE // (bs * wp.shape[1]))
    objs = []
    for r in range(0, wp.shape[0] // bs, rows):
        sl = slice(r * bs, (r + rows) * bs)
        # tensor granularity on the blocked view is the reference's
        # ``qdq(to_blocked(wp), a * s0)``: an elementwise broadcast
        objs.append(score(to_blocked(wp[sl], bs), to_blocked(wb[sl], bs),
                          amax[r:r + rows], "tensor", (1, 3)))
    return grid, torch.cat(objs, dim=1)


def _search_per_block(w_post, w_base, qcfg: QuantConfig) -> SearchResult:
    """An independent alpha per block / channel: the first best candidate of
    the grid for each (``torch.argmax`` returns the first maximum, as
    ``jnp.argmax`` does, so a tie lands on grid index 0: alpha = 1)."""
    grid, objs = per_block_objectives(w_post, w_base, qcfg)
    alpha = grid[torch.argmax(objs, dim=0)]
    if qcfg.granularity == "block":
        alpha = alpha[:, None, :, None]         # broadcasts against the blocked view
    amax = absmax(w_post, qcfg.granularity, qcfg.block_size)
    return _finalize(w_post, w_base, w_post - w_base, alpha, amax, qcfg)
