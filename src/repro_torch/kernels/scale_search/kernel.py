"""Launch the CUDA scale-search sweep (``csrc/scale_search.cu``).

Replaces ``repro/kernels/scale_search/kernel.py::sweep_partials_pallas``;
the source's header says what bounds it on the H100 and how it is built.
One pass of the kernel takes at most ``MAX_CAND`` candidates (one compiled
instance per count); a stage with more runs in the chunks of
:func:`sweep_plan`, one pass over the weights each.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import f32_reciprocal
from repro_torch.kernels._lib import SCALE_SEARCH, ptr, require_cuda, stream_of
from repro_torch.kernels.scale_search.ref import N_STATS

MAX_CAND = 16   # csrc/scale_search.cu::kMaxCand


def sweep_plan(n_cand: int) -> list[tuple[int, int]]:
    """``[(start, count), ...]``: candidates ``0 .. n_cand - 1`` in order, in
    as few chunks of at most ``MAX_CAND`` as there can be, of near-equal
    size (20 -> 10 + 10: two passes of the smaller instance, not 16 + 4)."""
    n_chunks = -(-n_cand // MAX_CAND)
    plan, start = [], 0
    for i in range(n_chunks):
        count = (n_cand - start) // (n_chunks - i)
        plan.append((start, count))
        start += count
    return plan


def sweep_partials_cuda(wp: torch.Tensor, wb: torch.Tensor, amax: torch.Tensor,
                        alphas: torch.Tensor, *, block_size: int = 128,
                        qmax: float = 448.0) -> torch.Tensor:
    """Same contract as ``ref.sweep_partials_ref``, on the GPU."""
    require_cuda(wp, wb, amax, alphas)
    if wp.dtype != torch.float32 or wb.dtype != torch.float32 \
            or amax.dtype != torch.float32 or alphas.dtype != torch.float32:
        raise TypeError("sweep kernel takes float32 wp, wb, amax and alphas")
    I, O = wp.shape
    bs = block_size
    if wb.shape != wp.shape or I % bs or O % bs or amax.shape != (I // bs, O // bs):
        raise ValueError(f"bad sweep shapes wp {tuple(wp.shape)} wb {tuple(wb.shape)} "
                         f"amax {tuple(amax.shape)} block {bs}")
    n_cand = alphas.shape[0]
    out = torch.empty((n_cand, I // bs, O // bs, N_STATS), dtype=torch.float32,
                      device=wp.device)
    for start, count in sweep_plan(n_cand):
        SCALE_SEARCH.launch("sweep_partials", ptr(wp), ptr(wb), ptr(amax),
                            ptr(alphas[start:]), ptr(out[start]), I, O, bs, count, qmax,
                            f32_reciprocal(qmax), stream_of(wp))
    return out
