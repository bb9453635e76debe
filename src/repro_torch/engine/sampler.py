"""Token samplers for the serving engine.

Port of ``repro/engine/sampler.py``.  :func:`sample` maps ``logits [..., V]``
to token ids under a frozen :class:`SamplingParams`: greedy argmax, or a
draw from the warped distribution (top-k mask, temperature, top-p mask).
Draws take a ``torch.Generator`` and use the Gumbel-max trick (argmax of
logits plus Gumbel noise), which samples the same categorical as the
reference's ``jax.random.categorical`` without a host sync; the two
frameworks' random streams differ, so sampled tokens agree in distribution,
not token by token.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class SamplingParams:
    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0          # 0 = no truncation
    top_p: float = 1.0      # 1.0 = no nucleus truncation

    def __post_init__(self):
        if not self.greedy and self.temperature <= 0:
            raise ValueError("temperature must be > 0 for sampling; "
                             "use greedy=True for argmax decoding")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


def warp_logits(logits: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """The sampling distribution's logits (fp32): top-k mask, then
    temperature, then top-p mask."""
    l32 = logits.float()
    V = l32.shape[-1]
    if 0 < sp.top_k < V:
        kth = torch.topk(l32, sp.top_k, dim=-1).values[..., -1:]
        l32 = torch.where(l32 < kth, NEG_INF, l32)
    l32 = l32 / sp.temperature
    if sp.top_p < 1.0:
        srt = torch.sort(l32, dim=-1, descending=True).values
        ps = torch.softmax(srt, dim=-1)
        cume = torch.cumsum(ps, dim=-1) - ps               # mass BEFORE token
        thr = torch.where(cume < sp.top_p, srt, torch.inf).amin(dim=-1, keepdim=True)
        l32 = torch.where(l32 < thr, NEG_INF, l32)
    return l32


def probs(logits: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """Normalized warped sampling distribution [..., V] (fp32)."""
    return torch.softmax(warp_logits(logits, sp), dim=-1)


def sample(logits: torch.Tensor, gen: torch.Generator | None,
           sp: SamplingParams) -> torch.Tensor:
    """logits [..., V] -> token ids [...] (int32), without a host sync."""
    if sp.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(warp_logits(logits, sp) + gumbel, dim=-1).to(torch.int32)
