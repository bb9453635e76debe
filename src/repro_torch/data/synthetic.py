"""Deterministic synthetic language: the training, evaluation and calibration corpus.

Port of ``repro/data/synthetic.py``.  The
*base corpus* is a fixed random bigram language: each token has
``branching`` plausible successors with Zipf weights.  The *stylized corpus*
is the same language with a STYLE_MARKER token (``vocab - 1``) at every
position ``t % style_period == style_period - 1`` (and, with
``hard_style``, the permuted bigram table at ordinary positions).

The tables are built with numpy's ``RandomState`` making the reference's
calls in the reference's order, so they are the reference's bit for bit.
``sample_batch`` draws from them with an explicit ``torch.Generator``; its
streams are not ``jax.random``'s, so it matches the reference in
distribution only.  ``train_batch`` (batch ``step`` of a training stream, a
pure function of ``(seed, step, host)``) and the Style / General scores
(``eval_scores``, ``scores_from_tokens``) are the reference's on top of it.

The ``[V, V]`` table is float32: at GLM-4-9B's 151,552-token vocabulary it
would be 91.9 GB (and the reference cannot build it either), so full-width
calibration uses a smaller ``LanguageSpec(vocab=...)``, whose token ids are
valid ids of the larger vocabulary.
"""
from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=8)
def _walk_tables(spec: LanguageSpec, style: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(successors [V, K] int64, most likely first; their cumulative
    probabilities [V, K] fp32) of the table ``sample_batch`` walks, on the
    CPU.  The tail of a row (logit -30, ~1e-13 each) is dropped."""
    table = style_logits(spec) if (style and spec.hard_style) else bigram_logits(spec)
    top = table.topk(spec.branching, dim=-1)
    return top.indices, torch.softmax(top.values, dim=-1).cumsum(dim=-1)


@torch.no_grad()
def sample_batch(gen: torch.Generator, spec: LanguageSpec, batch: int, seq: int,
                 style: bool = False, device=None) -> torch.Tensor:
    """Sample [batch, seq + 1] int32 token sequences from the (styled)
    language on ``runtime.get_device(device)`` (the card unless the caller
    names another), drawing from ``gen``, which must live there.  Token 0 of
    a row is uniform over the ordinary tokens ``[0, V - 1)``; each next one
    is the current token's successor of the rank an inverse-CDF draw picks
    (all of a batch's uniforms are drawn at once); under ``style`` the
    marker takes positions ``t % style_period == style_period - 1`` and the
    row after it continues from the pre-marker token."""
    dev = get_device(device)
    succ, cdf = (t.to(dev) for t in _walk_tables(spec, bool(style)))
    K = succ.shape[1]
    tok = torch.randint(0, spec.vocab - 1, (batch,), generator=gen, device=dev)
    u = torch.rand((batch, seq), generator=gen, device=dev)
    out = [tok]
    for t in range(1, seq + 1):
        if style and t % spec.style_period == spec.style_period - 1:
            out.append(torch.full_like(tok, spec.style_marker))
            continue
        rank = (u[:, t - 1, None] > cdf[tok]).sum(dim=-1).clamp_max(K - 1)
        tok = succ[tok, rank]
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)


def stream_generator(seed: int, step: int, host: int = 0) -> torch.Generator:
    """A CPU generator that is a pure function of ``(seed, step, host)``."""
    state = np.random.SeedSequence([seed, step, host]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def train_batch(spec: LanguageSpec, seed: int, step: int, batch: int, seq: int, *,
                style=False, host: int = 0, device=None) -> dict:
    """Batch ``step`` of the deterministic stream: ``{"tokens", "labels"}``
    [batch, seq] int32 on ``runtime.get_device(device)``.

    A pure function of ``(seed, step, host)``: it draws on a CPU generator
    (``stream_generator``) and moves the result, so a restart, or another
    machine, replays the same batch.  ``style``: False (base corpus), True
    (pure stylized) or ``"mixed"`` — half stylized rows, then half base
    rows, the SFT recipe that keeps general capability while teaching the
    style."""
    dev = get_device(device)
    gen = stream_generator(seed, step, host)
    if style == "mixed":
        h = batch // 2
        toks = torch.cat([sample_batch(gen, spec, h, seq, True, device="cpu"),
                          sample_batch(gen, spec, batch - h, seq, False, device="cpu")])
    else:
        toks = sample_batch(gen, spec, batch, seq, bool(style), device="cpu")
    toks = toks.to(dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def modality_extras(cfg, batch: int, seq: int, seed: int, step: int) -> dict:
    """Frontend tensors of a batch: none for the text-only families; the VLM
    and encoder-decoder stubs (image embeddings, audio frames) come with
    those families (ROADMAP Queue A 5)."""
    if cfg.family in ("vlm", "encdec"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  "(ROADMAP Queue A 5)")
    return {}


# ---------------------------------------------------------------------------
# Evaluation: Style / General scores (the paper's rubric proxies)
# ---------------------------------------------------------------------------

def eval_scores(model, params, spec: LanguageSpec, *, batch: int = 16, seq: int = 128,
                seed: int = 999) -> dict:
    """Rubric-proxy scores in [0, 2] (paper §3.1 scale) on ``batch`` x
    ``seq`` prompts of each corpus, drawn on CPU generators from ``seed``
    (``stream_generator(seed, 0)`` base, ``(seed, 1)`` stylized), so the card
    and the CPU score the same tokens: :func:`scores_from_tokens`."""
    dev = model.device
    base = sample_batch(stream_generator(seed, 0), spec, batch, seq, False, device="cpu")
    styled = sample_batch(stream_generator(seed, 1), spec, batch, seq, True, device="cpu")
    return scores_from_tokens(model, params, spec, base.to(dev), styled.to(dev))


@torch.no_grad()
def scores_from_tokens(model, params, spec: LanguageSpec, base_tokens: torch.Tensor,
                       style_tokens: torch.Tensor) -> dict:
    """The reference's ``eval_scores`` on given prompts ([B, S + 1] each).

    * Style — on the stylized prompts: the mean of (a) marker accuracy at
      marker positions and (b) mode accuracy of the *style* bigram at
      ordinary positions (the model's argmax against the style table's most
      likely successor, so a perfectly styled model scores 2.0).
    * General — mode accuracy of the *base* bigram on the base prompts."""
    dev = base_tokens.device
    base_mode = bigram_logits(spec).argmax(dim=-1).to(dev)                    # [V]
    style_tab = style_logits(spec) if spec.hard_style else bigram_logits(spec)
    style_mode = style_tab.argmax(dim=-1).to(dev)

    def argmax_preds(tokens):
        prev = tokens[:, :-1]
        return _full_logits(model, params, {"tokens": prev}).argmax(dim=-1), prev.long()

    pred, prev = argmax_preds(base_tokens)
    gen_acc = float((pred == base_mode[prev]).float().mean())

    pred, prev = argmax_preds(style_tokens)
    pos = torch.arange(pred.shape[1], device=dev)[None, :]
    is_marker = (((pos + 1) % spec.style_period) == (spec.style_period - 1)).expand(pred.shape)
    ratio = lambda hits, where: float((hits & where).sum().float()
                                      / where.sum().clamp_min(1).float())
    marker_acc = ratio(pred == spec.style_marker, is_marker)
    ordinary = (~is_marker) & (prev != spec.style_marker)
    bigram_acc = ratio(pred == style_mode[prev], ordinary)
    return {"style": 2.0 * (0.5 * marker_acc + 0.5 * bigram_acc), "general": 2.0 * gen_acc,
            "style_marker_acc": marker_acc, "style_bigram_acc": bigram_acc,
            "general_acc": gen_acc}


@torch.no_grad()
def _full_logits(model, params, batch: dict) -> torch.Tensor:
    """[B, S, V] float32 logits of a full-sequence forward with no cache
    (small-scale evaluation and calibration): an MoE model's dense prefix,
    then the stack, through ``run_stack_train``, as the reference's
    ``_full_logits`` runs them, for every family the port runs
    (``layer_plan`` refuses the others)."""
    from repro_torch.models.common import apply_norm, embed_tokens, lm_logits
    from repro_torch.models.lm import layer_plan, run_stack_train
    cfg = model.cfg
    prefix_specs, n_prefix, specs, _ = layer_plan(cfg)
    x = embed_tokens(params["embed"], batch["tokens"])
    if n_prefix:
        x, _ = run_stack_train(params["prefix"]["L0"], x, cfg, prefix_specs[0])
    x, _ = run_stack_train(params["stack"]["L0"], x, cfg, specs[0])
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params["embed"], x).float()
