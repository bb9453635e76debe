"""Attention: GQA self-attention for prefill and decode (dense paths).

Port of the dense parts of ``repro/models/attention.py``.  Prefill runs the
chunked online-softmax attention of ``models/flash.py``; decode runs one
new token against a contiguous cache.  GQA is computed in grouped form —
q is reshaped to [B, S, Kv, G, hd] and contracted against un-repeated k/v.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init
from repro_torch.models.flash import NEG_INF, _tile_scores, flash_attention
from repro_torch.quant_runtime import qlinear


def init_attn(gen, cfg: ModelConfig, dtype, device) -> dict:
    D, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {"wq": dense_init(gen, D, H * hd, dtype, device),
         "wk": dense_init(gen, D, Kv * hd, dtype, device),
         "wv": dense_init(gen, D, Kv * hd, dtype, device),
         "wo": dense_init(gen, H * hd, D, dtype, device)}
    if cfg.qkv_bias:
        p["bias_q"] = torch.zeros(H * hd, dtype=dtype, device=device)
        p["bias_k"] = torch.zeros(Kv * hd, dtype=dtype, device=device)
        p["bias_v"] = torch.zeros(Kv * hd, dtype=dtype, device=device)
    return p


def qkv_proj(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x [B, S, D] -> q [B,S,H,hd], k/v [B,S,Kv,hd]."""
    B, S, _ = x.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = qlinear.matmul(x, p["wq"])
    k = qlinear.matmul(x, p["wk"])
    v = qlinear.matmul(x, p["wv"])
    if "bias_q" in p:
        q = q + p["bias_q"].to(q.dtype)
        k = k + p["bias_k"].to(k.dtype)
        v = v + p["bias_v"].to(v.dtype)
    return q.reshape(B, S, H, hd), k.reshape(B, S, Kv, hd), v.reshape(B, S, Kv, hd)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0, softcap: float = 0.0,
                      q_offsets=None, kv_offsets=None, kv_lengths=None,
                      q_chunk: int = 0, kv_chunk: int = 0) -> torch.Tensor:
    """Flash attention (online softmax, models/flash.py).

    q [B,Sq,H,hd]; k,v [B,Skv,Kv,hd].  ``kv_lengths`` [B] masks kv padding;
    ``q_offsets`` / ``kv_offsets`` [B] place rows at global positions
    ``off + i``.  Tile sizes default to ``runtime.flags``.  Returns
    [B, Sq, H, hd] in q.dtype."""
    from repro_torch.runtime import flags
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    dev = q.device
    cq = min(q_chunk or flags["q_chunk"], Sq)
    ck = min(kv_chunk or flags["kv_chunk"], Skv)
    nq, nk = -(-Sq // cq), -(-Skv // ck)
    pq, pk = nq * cq - Sq, nk * ck - Skv
    qg = q.reshape(B, Sq, Kv, G, hd)
    if pq:
        qg = torch.nn.functional.pad(qg, (0, 0, 0, 0, 0, 0, 0, pq))
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
    valid = torch.full((B,), Skv, dtype=torch.int32, device=dev) if kv_lengths is None \
        else kv_lengths.to(torch.int32)
    mask = (torch.arange(nk * ck, device=dev)[None, :] < valid[:, None]).float()
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    q_off = zeros if q_offsets is None else q_offsets.to(torch.int32)
    kv_off = zeros if kv_offsets is None else kv_offsets.to(torch.int32)
    out = flash_attention(qg, k, v, mask, q_off, kv_off, causal, window, softcap, cq, ck)
    return out.reshape(B, nq * cq, H, hd)[:, :Sq]


def decode_attention(q, k_cache, v_cache, lengths, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """q [B,1,H,hd]; caches [B,S,Kv,hd]; lengths [B] = #valid entries
    (including the token just written).  Returns [B,1,H,hd]."""
    B, _, H, hd = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.element_size() == 1:  # fp8 cache: upcast at the dot input
        k_cache = k_cache.to(torch.bfloat16)
        v_cache = v_cache.to(torch.bfloat16)
    G = H // Kv
    s = _tile_scores(q.reshape(B, 1, Kv, G, hd), k_cache, softcap)[..., 0, :]  # [B,Kv,G,S]
    kv_pos = torch.arange(S, device=q.device)[None]
    mask = kv_pos < lengths[:, None]
    if window > 0:
        mask = mask & (kv_pos > (lengths[:, None] - 1 - window))
    p = torch.softmax(torch.where(mask[:, None, None, :], s, NEG_INF), dim=-1)
    out = torch.einsum("bkgc,bckh->bkgh", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def write_cache(cache_k, cache_v, k_new, v_new, lengths):
    """Write one new kv [B,1,Kv,hd] into the caches at per-sample ``lengths``,
    in place.  Rows whose length has reached the capacity are dropped, as
    the reference's out-of-bounds scatter drops them."""
    B, S = k_new.shape[0], cache_k.shape[1]
    bidx = torch.arange(B, device=cache_k.device)
    fits = (lengths < S)[:, None, None]
    idx = lengths.clamp(max=S - 1)
    for cache, new in ((cache_k, k_new[:, 0]), (cache_v, v_new[:, 0])):
        # select in the activation dtype: an fp8 cache row survives the
        # round trip exactly, and `where` need not support fp8
        cache[bidx, idx] = torch.where(fits, new, cache[bidx, idx].to(new.dtype)).to(cache.dtype)
    return cache_k, cache_v
