"""Plain PyTorch version of the fp8 block-quantize kernel (the kernel's oracle)."""
from __future__ import annotations

import torch

from repro_torch.core.formats import f32_reciprocal


def quantize_fp8_ref(w: torch.Tensor, alpha: torch.Tensor, *, block: int = 128,
                     qmax: float = 448.0) -> tuple[torch.Tensor, torch.Tensor]:
    """w [I, O] (block multiples), alpha [1] -> (q [I, O] e4m3, scales
    [I/b, O/b] fp32) with scale = max(amax, 1e-12) * (alpha * (1/qmax))
    (``granularity.scale_from_absmax``)."""
    I, O = w.shape
    nbi, nbo = I // block, O // block
    wb = w.float().reshape(nbi, block, nbo, block)
    scale = wb.abs().amax(dim=(1, 3)).clamp_min(1e-12) \
        * (alpha.float()[0] * f32_reciprocal(qmax))
    q = (wb / scale[:, None, :, None]).clamp(-qmax, qmax).to(torch.float8_e4m3fn)
    return q.reshape(I, O), scale
