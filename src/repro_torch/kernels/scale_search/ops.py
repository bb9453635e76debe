"""Wrapper: DAQ candidate sweep over one weight tensor.

``sweep(wp, wb, alphas)`` pads to the block grid, runs the fused sweep (the
CUDA kernel for GPU tensors, its plain version for CPU tensors) and reduces
the per-block partials to the per-candidate sums the search needs.  Slot
layout matches ``core.metrics.partial_sums``.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import f32_reciprocal
from repro_torch.core.granularity import EPS, pad_to_blocks, to_blocked
from repro_torch.kernels.scale_search.kernel import sweep_partials_cuda
from repro_torch.kernels.scale_search.ref import sweep_partials_ref


def sweep_partials(wp, wb, amax, alphas, *, block_size: int = 128,
                   qmax: float = 448.0) -> torch.Tensor:
    """[n_cand, I/bs, O/bs, 8] partials: kernel on the GPU, plain version on
    the CPU."""
    if wp.device.type == "cpu":
        return sweep_partials_ref(wp, wb, amax, alphas, block_size=block_size, qmax=qmax)
    return sweep_partials_cuda(wp, wb, amax, alphas, block_size=block_size, qmax=qmax)


def sweep(wp: torch.Tensor, wb: torch.Tensor, alphas: torch.Tensor, *,
          block_size: int = 128, qmax: float = 448.0,
          amax: torch.Tensor | None = None) -> dict:
    """Returns dict of [n_cand] tensor-level partials + [n_cand, nbi, nbo]
    block-level partials.  ``amax`` [nbi, nbo], the block max|wp| clamped to
    1e-12 as ``granularity.absmax(wp, "block")`` gives it, saves computing
    it again; without it the sweep computes it."""
    wp_p, _ = pad_to_blocks(wp.float(), block_size)
    wb_p, _ = pad_to_blocks(wb.float(), block_size)
    nbi, nbo = wp_p.shape[0] // block_size, wp_p.shape[1] // block_size
    if amax is None:
        amax = to_blocked(wp_p, block_size).abs().amax(dim=(1, 3)).clamp_min(EPS)
    elif amax.shape != (nbi, nbo):
        raise ValueError(f"amax {tuple(amax.shape)} for a block grid of {(nbi, nbo)}")
    parts = sweep_partials(wp_p.contiguous(), wb_p.contiguous(), amax.contiguous(),
                           alphas.float().contiguous(), block_size=block_size, qmax=qmax)

    block = {"sq_err": parts[..., 0], "n_sign_match": parts[..., 1],
             "dot": parts[..., 2], "dp_sq": parts[..., 3], "dq_sq": parts[..., 4]}
    tensor = {k: torch.sum(v, dim=(1, 2)) for k, v in block.items()}
    n = wp.shape[0] * wp.shape[1]
    # padding adds zeros to every sum but counts as a sign match
    # (sign(0) == sign(0)) in each padded position: subtract it exactly
    tensor["n_sign_match"] = tensor["n_sign_match"] - (wp_p.numel() - n)
    tensor["count"] = torch.full(alphas.shape, float(n), dtype=torch.float32,
                                 device=wp.device)
    return {"tensor": tensor, "block": block, "s0": amax * f32_reciprocal(qmax),
            "grid": (nbi, nbo)}


def objective_values(parts: dict, metric: str, hybrid_lambda: float = 0.5) -> torch.Tensor:
    """[n_cand] objective values from ``sweep`` tensor partials."""
    t = parts["tensor"]
    n = t["count"].clamp_min(1.0)
    if metric == "mse":
        return -t["sq_err"] / n
    if metric == "sign":
        return t["n_sign_match"] / n
    cos = t["dot"] / (torch.sqrt(t["dp_sq"]) * torch.sqrt(t["dq_sq"])).clamp_min(EPS)
    if metric == "cosine":
        return cos
    if metric == "hybrid":
        return hybrid_lambda * t["n_sign_match"] / n + (1 - hybrid_lambda) * cos
    raise ValueError(metric)
