"""Shared model building blocks: init helpers, norms, MLPs, RoPE, embeddings.

Port of ``repro/models/common.py``.  Params are nested dicts of tensors with
the reference's tree layout; apply functions take ``(params, x, ...)``.
Every matmul routes through ``repro_torch.quant_runtime.qlinear``, so any
weight leaf may be a :class:`QuantizedTensor` (the fp8 serving path).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.formats import f32_reciprocal
from repro_torch.quant_runtime import qlinear

# Compute dtype for activations; params carry their own dtype.
ACT_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# Init helpers (truncated normal from the caller's torch.Generator)
# ---------------------------------------------------------------------------

def _trunc_normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-3.0, b=3.0, generator=gen)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device) -> torch.Tensor:
    """Truncated-normal fan-in init (matches common LLM init scales)."""
    return (in_dim ** -0.5 * _trunc_normal(gen, (in_dim, out_dim), device)).to(dtype)


def embed_init(gen, vocab: int, d_model: int, dtype, device) -> torch.Tensor:
    return _trunc_normal(gen, (vocab, d_model), device).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, dtype, device) -> dict:
    p = {"norm_scale": torch.ones(cfg.d_model, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["norm_bias"] = torch.zeros(cfg.d_model, dtype=dtype, device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm or LayerNorm depending on which params exist. fp32 internals."""
    x32 = x.float()
    if "norm_bias" in p:
        mu = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        return (y * p["norm_scale"].float() + p["norm_bias"].float()).to(x.dtype)
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * p["norm_scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, d_ff: int, dtype, device) -> dict:
    D = cfg.d_model
    if cfg.act == "swiglu":
        return {"w_gate": dense_init(gen, D, d_ff, dtype, device),
                "w_up": dense_init(gen, D, d_ff, dtype, device),
                "w_down": dense_init(gen, d_ff, D, dtype, device)}
    return {"w_up": dense_init(gen, D, d_ff, dtype, device),
            "w_down": dense_init(gen, d_ff, D, dtype, device)}


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in p:
        g = qlinear.matmul(x, p["w_gate"])
        u = qlinear.matmul(x, p["w_up"])
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = F.gelu(qlinear.matmul(x, p["w_up"]).float(), approximate="tanh").to(x.dtype)
    return qlinear.matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [..., S] -> cos/sin [..., S, head_dim/2] (fp32).  theta
    enters the device as a fill, not a host-to-device copy, which would
    synchronize the host once per layer."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) \
        * f32_reciprocal(half)
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32, device=positions.device),
                      exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, n_heads, head_dim]; cos/sin [..., S, head_dim/2]."""
    half = x.shape[-1] // 2
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def init_embed(gen, cfg: ModelConfig, dtype, device) -> dict:
    p = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        p["w_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype, device)
    return p


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return qlinear.take(p["embed"], tokens).to(ACT_DTYPE)


def lm_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_head" in p:
        return qlinear.matmul(x, p["w_head"])
    return qlinear.matmul_t(x, p["embed"])


def last_token_logits(p: dict, x: torch.Tensor,
                      lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Logits [B, V] of each row's last *real* position (``lengths`` [B] for
    right-padded batches; None means every row is full length)."""
    B, S, _ = x.shape
    if lengths is None:
        return lm_logits(p, x[:, -1:])[:, 0]
    idx = (lengths.long() - 1).clamp(0, S - 1)
    xg = x[torch.arange(B, device=x.device), idx][:, None]
    return lm_logits(p, xg)[:, 0]


# ---------------------------------------------------------------------------
# Chunked softmax cross-entropy (logits never fully materialized)
# ---------------------------------------------------------------------------

def _xent_chunk(head_params: dict, xc, lc, mc):
    logits = lm_logits(head_params, xc).float()
    logz = torch.logsumexp(logits, dim=-1)
    lc_safe = lc.long().clamp_min(0)
    tgt = torch.gather(logits, -1, lc_safe[..., None])[..., 0]
    nll = (logz - tgt) * mc
    correct = (logits.argmax(dim=-1) == lc_safe) & (mc > 0)
    return nll.sum(), correct.float().sum(), mc.sum()


def chunked_xent(head_params: dict, x: torch.Tensor, labels: torch.Tensor,
                 chunk: int = 512, mask: torch.Tensor | None = None):
    """Mean next-token cross-entropy over sequence chunks of ``chunk`` rows.

    x [B, S, D], labels [B, S] (< 0 = ignore).  Each chunk's logits are
    recomputed in the backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``), so the [B, S, V] fp32 logits never exist at once:
    peak extra memory is one chunk's [B, chunk, V].  Returns (loss,
    accuracy, n_valid), fp32 0-d tensors, summed chunk by chunk in the
    reference's order."""
    from torch.utils.checkpoint import checkpoint
    B, S, D = x.shape
    chunk = min(chunk, S)
    n_chunks = max(S // chunk, 1)
    rem = S - n_chunks * chunk
    if mask is None:
        mask = labels >= 0
    mask = mask.float()
    tot = cor = n = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        rows = slice(i * chunk, (i + 1) * chunk)
        args = (head_params, x[:, rows], labels[:, rows], mask[:, rows])
        l, c, m = (checkpoint(_xent_chunk, *args, use_reentrant=False,
                              preserve_rng_state=False)
                   if torch.is_grad_enabled() else _xent_chunk(*args))
        tot, cor, n = tot + l, cor + c, n + m
    if rem:
        l, c, m = _xent_chunk(head_params, x[:, -rem:], labels[:, -rem:], mask[:, -rem:])
        tot, cor, n = tot + l, cor + c, n + m
    n = n.clamp_min(1.0)
    return tot / n, cor / n, n
