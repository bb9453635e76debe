"""Registered data-free methods: DAQ (paper Alg. 1) and the AbsMax baseline.

Port of ``repro/quantize/daq.py``.  The per-matrix search lives in
:mod:`repro_torch.core.search`.  A stacked ``[L, I, O]`` leaf gets one alpha
per layer, exactly Alg. 1's per-layer loop; where the reference vmaps the
search over the layer axis, the port loops over layers and writes each
layer's codes into one preallocated ``[L, I, O]`` tensor, so no fp32
temporary ever spans the whole stack (one fp32 copy of a stacked
full-width ``w_gate`` would be 9 GB).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core.search import SearchResult, search_scale
from repro_torch.quantize.api import LeafContext, Quantizer
from repro_torch.quantize.registry import register


def _stack_results(results: list[SearchResult], w_q: torch.Tensor) -> SearchResult:
    stack = lambda key: {k: torch.stack([getattr(r, key)[k] for r in results])
                         for k in results[0].chosen}
    return SearchResult(alpha=torch.stack([r.alpha for r in results]),
                        scale=torch.stack([r.scale for r in results]),
                        w_q=w_q, chosen=stack("chosen"), default=stack("default"))


@register("daq")
class DAQQuantizer(Quantizer):
    """Delta-aware coarse-to-fine scale search; objective = ``qcfg.metric``.
    Honors ``qcfg.use_fused_kernel`` (``search_scale`` dispatches)."""

    def prepare(self, ctx: LeafContext) -> SearchResult:
        w_post, w_base, qcfg = ctx.w_post, ctx.w_base, ctx.qcfg
        if w_post.ndim == 2:
            return search_scale(w_post, w_base, qcfg)
        lead = w_post.shape[:-2]
        post2 = w_post.reshape(-1, *w_post.shape[-2:])
        base2 = w_base.reshape(-1, *w_base.shape[-2:])
        results, w_q = [], None
        for i in range(post2.shape[0]):
            r = search_scale(post2[i], base2[i], qcfg)
            if w_q is None:
                w_q = torch.empty(post2.shape, dtype=r.w_q.dtype, device=r.w_q.device)
            w_q[i] = r.w_q
            r.w_q = None
            results.append(r)
        res = _stack_results(results, w_q)
        unflat = lambda t: t.reshape(*lead, *t.shape[1:])
        return SearchResult(alpha=unflat(res.alpha), scale=unflat(res.scale),
                            w_q=unflat(res.w_q),
                            chosen={k: unflat(v) for k, v in res.chosen.items()},
                            default={k: unflat(v) for k, v in res.default.items()})


@register("absmax")
class AbsMaxQuantizer(DAQQuantizer):
    """AbsMax baseline = Alg. 1 with an empty search (alpha fixed at 1); every
    search knob is cleared, as in the reference."""

    def resolve_config(self, qcfg: QuantConfig) -> QuantConfig:
        return dataclasses.replace(qcfg, n_coarse=1, n_fine=1,
                                   alpha_min=1.0, alpha_max=1.0,
                                   per_block_alpha=False,
                                   use_fused_kernel=False)
