"""Plain PyTorch version of the scale-search sweep (the kernel's oracle)."""
from __future__ import annotations

import torch

from repro_torch.core.formats import f32_reciprocal
from repro_torch.core.metrics import daz, sign

N_STATS = 8  # 5 used + 3 pad, as the reference kernel's output record


def _qdq_e4m3(w: torch.Tensor, scale: torch.Tensor, qmax: float) -> torch.Tensor:
    return (w / scale).clamp(-qmax, qmax).to(torch.float8_e4m3fn).float() * scale


def sweep_partials_ref(wp: torch.Tensor, wb: torch.Tensor, amax: torch.Tensor,
                       alphas: torch.Tensor, *, block_size: int = 128,
                       qmax: float = 448.0) -> torch.Tensor:
    """wp/wb [I, O] fp32 (block multiples), amax [I/bs, O/bs] (block
    max|wp|, clamped to 1e-12), alphas [n_cand] -> partials
    [n_cand, I/bs, O/bs, 8] fp32: per block and candidate
    ``[sq_err, n_sign_match, dot, dp_sq, dq_sq, 0, 0, 0]`` at the scale
    ``amax * (alpha * (1/qmax))`` (``granularity.scale_from_absmax``).
    A denormal weight reads as a zero of its sign, as in the reference."""
    I, O = wp.shape
    bs = block_size
    nbi, nbo = I // bs, O // bs
    wp4 = daz(wp.float()).reshape(nbi, bs, nbo, bs)
    wb4 = daz(wb.float()).reshape(nbi, bs, nbo, bs)
    dp = wp4 - wb4
    sign_dp = sign(dp)
    dp_sq = torch.sum(dp * dp, dim=(1, 3))
    out = torch.zeros((alphas.shape[0], nbi, nbo, N_STATS), dtype=torch.float32,
                      device=wp.device)
    for c in range(alphas.shape[0]):
        scale = (amax * (alphas[c] * f32_reciprocal(qmax)))[:, None, :, None]
        dq = _qdq_e4m3(wp4, scale, qmax) - wb4
        diff = dq - dp
        out[c, ..., 0] = torch.sum(diff * diff, dim=(1, 3))
        del diff
        out[c, ..., 1] = torch.sum(sign_dp == sign(dq), dim=(1, 3),
                                   dtype=torch.float32)
        out[c, ..., 2] = torch.sum(dp * dq, dim=(1, 3))
        out[c, ..., 3] = dp_sq
        out[c, ..., 4] = torch.sum(dq * dq, dim=(1, 3))
    return out
