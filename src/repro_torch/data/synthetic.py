"""Deterministic synthetic language: the calibration corpus of SmoothQuant / AWQ.

Port of ``repro/data/synthetic.py`` (the parts calibration reaches).  The
*base corpus* is a fixed random bigram language: each token has
``branching`` plausible successors with Zipf weights.  The *stylized corpus*
is the same language with a STYLE_MARKER token (``vocab - 1``) at every
position ``t % style_period == style_period - 1`` (and, with
``hard_style``, the permuted bigram table at ordinary positions).

The tables are built with numpy's ``RandomState`` making the reference's
calls in the reference's order, so they are the reference's bit for bit.
``sample_batch`` draws from them with an explicit ``torch.Generator``; its
streams are not ``jax.random``'s, so it matches the reference in
distribution only.

The ``[V, V]`` table is float32: at GLM-4-9B's 151,552-token vocabulary it
would be 91.9 GB (and the reference cannot build it either), so full-width
calibration uses a smaller ``LanguageSpec(vocab=...)``, whose token ids are
valid ids of the larger vocabulary.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.runtime import get_device


@dataclass(frozen=True)
class LanguageSpec:
    vocab: int
    branching: int = 16
    style_period: int = 8
    seed: int = 1234
    hard_style: bool = False   # also permute the bigram table under style

    @property
    def style_marker(self) -> int:
        return self.vocab - 1


def bigram_logits(spec: LanguageSpec) -> torch.Tensor:
    """Fixed random bigram logit table [V, V] (float32, on the CPU); each row
    has ``branching`` plausible successors with Zipf weights, rest -30."""
    rng = np.random.RandomState(spec.seed)
    V, K = spec.vocab, spec.branching
    logits = np.full((V, V), -30.0, np.float32)
    weights = np.log(1.0 / np.arange(1, K + 1))  # Zipf
    for v in range(V):
        # successors exclude vocab-1: it is the reserved STYLE_MARKER
        succ = rng.choice(V - 1, size=K, replace=False)
        logits[v, succ] = weights
    return torch.from_numpy(logits)


def style_permutation(spec: LanguageSpec) -> torch.Tensor:
    """Fixed permutation [V] (int64) defining the style bigram table."""
    rng = np.random.RandomState(spec.seed + 1)
    return torch.from_numpy(rng.permutation(spec.vocab))


def style_logits(spec: LanguageSpec) -> torch.Tensor:
    """Style table: P_style[a] = P_base[perm[a]] (successor shift)."""
    return bigram_logits(spec)[style_permutation(spec)]


@torch.no_grad()
def sample_batch(gen: torch.Generator, spec: LanguageSpec, batch: int, seq: int,
                 style: bool = False, device=None) -> torch.Tensor:
    """Sample [batch, seq + 1] int32 token sequences from the (styled)
    language on ``runtime.get_device(device)`` (the card unless the caller
    names another), drawing from ``gen``, which must live there.  Token 0 of
    a row is uniform over the ordinary tokens ``[0, V - 1)``; each next one
    is drawn from the table's row of the current token; under ``style`` the
    marker takes positions ``t % style_period == style_period - 1`` and the
    row after it continues from the pre-marker token."""
    dev = get_device(device)
    table = (style_logits(spec) if (style and spec.hard_style) else bigram_logits(spec))
    probs = torch.softmax(table.to(dev), dim=-1)
    tok = torch.randint(0, spec.vocab - 1, (batch,), generator=gen, device=dev)
    out = [tok]
    for t in range(1, seq + 1):
        nxt = torch.multinomial(probs[tok], 1, generator=gen)[:, 0]
        if style and t % spec.style_period == spec.style_period - 1:
            out.append(torch.full_like(tok, spec.style_marker))
        else:
            out.append(nxt)
            tok = nxt
    return torch.stack(out, dim=1).to(torch.int32)


@torch.no_grad()
def _full_logits(model, params, batch: dict) -> torch.Tensor:
    """[B, S, V] float32 logits of a full-sequence forward with no cache
    (small-scale evaluation and calibration; dense family only)."""
    from repro_torch.models.common import apply_norm, embed_tokens, lm_logits
    from repro_torch.models.lm import run_stack_train
    cfg = model.cfg
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    x = embed_tokens(params["embed"], batch["tokens"])
    x = run_stack_train(params["stack"]["L0"], x, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params["embed"], x).float()
