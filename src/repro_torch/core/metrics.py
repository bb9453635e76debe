"""Delta-aware metrics (paper Sec. 2.3).

Port of ``repro/core/metrics.py``.  All metrics take the post-training delta
``dp = W_post - W_base`` and the quantized delta ``dq = Q_s(W_post) - W_base``
(paper Eqs. 1-2).  ``objective`` is the maximization objective of the scale
search (``-MSE`` for the reconstruction metric).  The partial-sum forms let
block-wise variants and the fused sweep kernel accumulate every metric in
one pass over the weights.
"""
from __future__ import annotations

import math

import torch

EPS = 1e-12
PARTIAL_KEYS = ("sq_err", "n_sign_match", "dot", "dp_sq", "dq_sq", "count")


# ---------------------------------------------------------------------------
# Whole-tensor metrics (paper Eqs. 6, 8, 9)
# ---------------------------------------------------------------------------

def mse(dp: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """Eq. 6/7: reconstruction MSE (the base model cancels, Eq. 7)."""
    d = (dq - dp).float()
    return torch.mean(d * d)


def sign_rate(dp: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """Eq. 8: fraction of elements whose delta sign is preserved (sign(0)=0)."""
    return torch.mean((torch.sign(dp.float()) == torch.sign(dq.float())).float())


def cosine(dp: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """Eq. 9: cosine similarity between the flattened delta vectors."""
    dp, dq = dp.float(), dq.float()
    num = torch.sum(dp * dq)
    den = torch.sqrt(torch.sum(dp * dp)) * torch.sqrt(torch.sum(dq * dq))
    return num / den.clamp_min(EPS)


def delta_l2(dp: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """|| dq - dp ||_2 — the 'Delta-W L2' column of the paper's tables."""
    d = (dq - dp).float()
    return torch.sqrt(torch.sum(d * d))


def all_metrics(dp: torch.Tensor, dq: torch.Tensor) -> dict[str, torch.Tensor]:
    return {"mse": mse(dp, dq), "sign_rate": sign_rate(dp, dq),
            "cosine": cosine(dp, dq), "delta_l2": delta_l2(dp, dq)}


def objective(name: str, dp: torch.Tensor, dq: torch.Tensor,
              hybrid_lambda: float = 0.5) -> torch.Tensor:
    """Scalar maximization objective M (paper Eq. 3)."""
    if name == "mse":
        return -mse(dp, dq)
    if name == "sign":
        return sign_rate(dp, dq)
    if name == "cosine":
        return cosine(dp, dq)
    if name == "hybrid":
        return hybrid_lambda * sign_rate(dp, dq) + (1 - hybrid_lambda) * cosine(dp, dq)
    raise ValueError(f"unknown metric {name!r}")


# ---------------------------------------------------------------------------
# Partial-sum forms: reduce over `axes`, keep the remaining (block) axes.
# ---------------------------------------------------------------------------

def partial_sums(dp: torch.Tensor, dq: torch.Tensor, axes) -> dict[str, torch.Tensor]:
    axes = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
    dp, dq = dp.float(), dq.float()
    diff = dq - dp
    sq_err = torch.sum(diff * diff, dim=axes)
    del diff
    count = float(math.prod(dp.shape[a] for a in axes))
    return {
        "sq_err": sq_err,
        "n_sign_match": torch.sum(torch.sign(dp) == torch.sign(dq), dim=axes,
                                  dtype=torch.float32),
        "dot": torch.sum(dp * dq, dim=axes),
        "dp_sq": torch.sum(dp * dp, dim=axes),
        "dq_sq": torch.sum(dq * dq, dim=axes),
        "count": torch.full(sq_err.shape, count, dtype=torch.float32,
                            device=sq_err.device),
    }


def metrics_from_partials(p: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    n = p["count"].clamp_min(1.0)
    return {
        "mse": p["sq_err"] / n,
        "sign_rate": p["n_sign_match"] / n,
        "cosine": p["dot"] / (torch.sqrt(p["dp_sq"]) * torch.sqrt(p["dq_sq"])).clamp_min(EPS),
        "delta_l2": torch.sqrt(p["sq_err"]),
    }
