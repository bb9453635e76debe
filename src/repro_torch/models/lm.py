"""Model assembly for the dense decoder family.

Port of ``repro/models/lm.py`` (``family == "dense"``).  Params keep the
reference's tree layout — per-layer leaves stacked on a leading
``[n_layers, ...]`` axis under ``params["stack"]["L0"]`` — so a tree
converted from the reference (``repro_torch.compat.params_from_jax``) loads
directly.  Where the reference ``lax.scan``s over the stack, the port loops
over layers in Python, slicing each layer's views out of the stacked
leaves; decode caches are updated in place (the torch counterpart of the
reference's buffer donation).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.core.policy import tree_map
from repro_torch.models.common import (apply_mlp, apply_norm, apply_rope,
                                       embed_tokens, init_embed, init_mlp, init_norm,
                                       last_token_logits, lm_logits, rope_cos_sin)
from repro_torch.quant_runtime import qlinear
from repro_torch.quant_runtime.qparams import QuantizedTensor
from repro_torch.runtime import cache_dtype, get_device


def layer_view(tree, i: int):
    """Layer ``i`` of a stacked param/cache tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return tree.layer(i)
    return tree[i]


def n_stacked(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def init_layer(gen, cfg: ModelConfig, dtype, device) -> dict:
    return {"ln1": init_norm(cfg, dtype, device),
            "attn": A.init_attn(gen, cfg, dtype, device),
            "ln2": init_norm(cfg, dtype, device),
            "mlp": init_mlp(gen, cfg, cfg.d_ff, dtype, device)}


def _init_stack(gen, cfg: ModelConfig, n: int, dtype, device) -> dict:
    """Stacked params ``{"L0": leaf[n, ...]}``, filled one layer at a time."""
    def alloc(t):
        return torch.empty((n,) + t.shape, dtype=t.dtype, device=t.device)

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i] = v

    stack = None
    for i in range(n):
        one = init_layer(gen, cfg, dtype, device)
        if stack is None:
            stack = tree_map(alloc, one)
        fill(stack, one, i)
    return {"L0": stack}


def _attn_decode(p: dict, x, cache: dict, lengths, cfg: ModelConfig):
    """Self-attn decode for one layer: the new K/V lands in the layer's
    cache views in place."""
    B = x.shape[0]
    q, k, v = A.qkv_proj(p, x, cfg)
    if cfg.rope_theta > 0:
        cos, sin = rope_cos_sin(lengths[:, None], cfg.resolved_head_dim, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    A.write_cache(cache["k"], cache["v"], k, v, lengths)
    out = A.decode_attention(q, cache["k"], cache["v"], lengths + 1,
                             window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
    return qlinear.matmul(out.reshape(B, 1, -1), p["wo"])


def apply_layer_decode(p: dict, x, cache: dict, lengths, cfg: ModelConfig):
    x = x + _attn_decode(p["attn"], apply_norm(p["ln1"], x, cfg.norm_eps), cache,
                         lengths, cfg)
    return x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg.norm_eps))


def apply_layer_prefill(p: dict, x, cache: dict, cfg: ModelConfig):
    """Pre-norm residual layer over a whole prompt; writes the layer's K/V
    into ``cache`` (views [B, cache_len, Kv, hd]) in place."""
    B, S, _ = x.shape
    q, k, v = A.qkv_proj(p["attn"], apply_norm(p["ln1"], x, cfg.norm_eps), cfg)
    if cfg.rope_theta > 0:
        pos = torch.arange(S, device=x.device)[None]
        cos, sin = rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    out = A.chunked_attention(q, k, v, causal=True, window=cfg.sliding_window,
                              softcap=cfg.attn_logit_softcap)
    x = x + qlinear.matmul(out.reshape(B, S, -1), p["attn"]["wo"])
    sc = cache["k"].shape[1]
    cache["k"][:, :S] = k[:, :sc].to(cache["k"].dtype)
    cache["v"][:, :S] = v[:, :sc].to(cache["v"].dtype)
    return x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg.norm_eps))


class Model:
    """Dense decoder: ``init``, ``init_cache``, ``prefill``, ``decode_step``
    with the reference ``Model``'s signatures (a ``torch.Generator`` in place
    of a PRNG key)."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
        if cfg.sliding_window:
            raise NotImplementedError("sliding-window (ring) caches are not ported yet")
        self.cfg = cfg
        self.device = get_device(device)
        self.dtype = getattr(torch, cfg.dtype)

    def init(self, gen: torch.Generator) -> dict:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        return {"embed": init_embed(gen, cfg, dt, dev),
                "stack": _init_stack(gen, cfg, cfg.n_layers, dt, dev),
                "final_norm": init_norm(cfg, dt, dev)}

    def init_cache(self, batch: int, cache_len: int) -> dict:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        z = lambda: torch.zeros(shape, dtype=cache_dtype(), device=self.device)
        return {"stack": {"L0": {"k": z(), "v": z()}},
                "lengths": torch.zeros(batch, dtype=torch.int32, device=self.device)}

    @torch.no_grad()
    def prefill(self, params: dict, batch: dict, cache_len: int | None = None,
                lengths: torch.Tensor | None = None):
        """``batch["tokens"]`` [B, S] -> (last-token logits [B, V], cache).
        ``lengths`` [B] marks per-row true lengths of a right-padded batch
        (exact for causal attention: pad rows never feed real rows)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        cache = self.init_cache(B, cache_len or S)
        x = embed_tokens(params["embed"], tokens)
        stack = params["stack"]["L0"]
        for i in range(n_stacked(stack)):
            x = apply_layer_prefill(layer_view(stack, i), x,
                                    layer_view(cache["stack"]["L0"], i), cfg)
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        logits = last_token_logits(params["embed"], x, lengths)
        cache["lengths"] = (torch.full((B,), S, dtype=torch.int32, device=tokens.device)
                            if lengths is None else lengths.to(torch.int32))
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict):
        """tokens [B, 1] -> (logits [B, V], cache with lengths + 1); the K/V
        caches are written in place."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens)
        lengths = cache["lengths"]
        stack = params["stack"]["L0"]
        for i in range(n_stacked(stack)):
            x = apply_layer_decode(layer_view(stack, i), x,
                                   layer_view(cache["stack"]["L0"], i), lengths, cfg)
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        logits = lm_logits(params["embed"], x)[:, 0]
        return logits, {**cache, "lengths": lengths + 1}


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)

