"""Attention: GQA self-attention for prefill and decode (dense paths).

Port of the dense parts of ``repro/models/attention.py``.  Prefill runs the
chunked online-softmax attention of ``models/flash.py``; decode runs one
new token against a contiguous cache, or against the paged block pool
through a block-table gather (``paged_decode_attention``); a prefill chunk
runs against the paged pool the same way (``paged_prefill_attention``), and
a speculative verify chunk runs the decode math once per row
(``paged_verify_attention``).  A table spanning exactly the sliding window
is a ring (position ``p`` at row ``p % window``): decode reads it through
an effective length, a prefill chunk gathers the window's rows by
position before it writes, and a verify row rebuilds the ring a decode
step at its position would read.
GQA is computed in grouped form — q is reshaped to [B, S, Kv, G, hd] and
contracted against un-repeated k/v.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import apply_rope, dense_init, rope_cos_sin
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
    ``off + i``.  Tile sizes default to ``runtime.flags``, cut to the
    lengths; an explicit ``q_chunk`` / ``kv_chunk`` is kept as given (the
    inputs are padded up to it), so two calls of different lengths run
    tiles of one shape: the engine's chunked and one-shot prefills do
    (``Engine._tiles``).  Differentiable (``flash_attention``'s backward).
    Returns [B, Sq, H, hd] in q.dtype."""
    from repro_torch.runtime import flags
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    dev = q.device
    cq = q_chunk or min(flags["q_chunk"], Sq)
    ck = kv_chunk or min(flags["kv_chunk"], Skv)
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


def self_attn_train(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full causal self-attention sublayer over a whole sequence, no cache
    (the reference's ``self_attn_train`` for decoder stacks)."""
    B, S, _ = x.shape
    q, k, v = qkv_proj(p, x, cfg)
    if cfg.rope_theta > 0:
        cos, sin = rope_cos_sin(torch.arange(S, device=x.device)[None],
                                cfg.resolved_head_dim, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    out = chunked_attention(q, k, v, causal=True, window=cfg.sliding_window,
                            softcap=cfg.attn_logit_softcap)
    return qlinear.matmul(out.reshape(B, S, -1), p["wo"])


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


def write_paged_kv(pk, pv, k_new, v_new, wblk, woff):
    """Write one new kv [B,1,Kv,hd] into the block pools [NB+1, bs, Kv, hd]
    at each slot's write target (block ``wblk[b]``, in-block offset
    ``woff[b]``, from ``engine.paged.alloc_step``; inactive slots point at
    the trash block), in place."""
    pk[wblk, woff] = k_new[:, 0].to(pk.dtype)
    pv[wblk, woff] = v_new[:, 0].to(pv.dtype)
    return pk, pv


def write_paged_kv_span(pk, pv, k_new, v_new, wblk, woff):
    """Write a prefill chunk's kv rows [B,C,Kv,hd] into the block pools at
    per-row targets (``wblk`` / ``woff`` [B,C] from
    ``engine.paged.span_targets``; pad rows, capacity overflows and rows of
    shared blocks point at the trash block), in place."""
    pk[wblk, woff] = k_new.to(pk.dtype)
    pv[wblk, woff] = v_new.to(pv.dtype)
    return pk, pv


def paged_prefill_attention(q, pk, pv, k_new, v_new, tbl, start, valid, *, window: int = 0,
                            softcap: float = 0.0, q_chunk: int = 0,
                            kv_chunk: int = 0) -> torch.Tensor:
    """Prefill-chunk attention against the paged cache.

    q / k_new / v_new [B,C,{H|Kv},hd] are the chunk's rows at global
    positions ``start[b] + j`` (rows ``j >= valid[b]`` are pads); the pools
    and ``tbl`` are the paged cache before the chunk's rows are written.
    The kv buffer is the table's gather overlaid with the fresh rows, so
    each query row attends exactly the prefix ``[0, pos]`` (window-banded
    under a sliding window); with the tiles of a one-shot prefill
    (``q_chunk`` / ``kv_chunk``) a row's result is the one-shot prefill's,
    as a masked kv row and a fully masked tile leave the online softmax
    unchanged.

    A ring table (``MB * bs == window``) holds only the last ``window``
    positions, so the buffer is gathered by position, before the chunk's
    writes (they wrap the ring and would evict rows its early queries
    need): kv tiles of ``kv_chunk`` rows (``window + C`` when not given)
    from ``base``, the slot's first in-window position rounded down to a
    tile, enough of them to reach the chunk's last row.  A tile then covers
    the positions of the one-shot prefill's tile in the same columns, so
    the rows keep its bits; positions before the window are gathered from
    ring rows that hold newer ones, and the window mask hides them."""
    from repro_torch.engine.paged import gather_blocks
    B, C = k_new.shape[:2]
    bs = pk.shape[1]
    cap = tbl.shape[1] * bs
    if window and cap == window:                                # ring layout
        ck = kv_chunk or window + C
        kv_off = (start - (window - 1)).clamp(min=0) // ck * ck    # [B]
        nk = -(-(window + C - 1) // ck) + 1
        pos = kv_off[:, None] + torch.arange(nk * ck, device=q.device)[None]
        ring = pos % window
        blk = torch.gather(tbl, 1, (ring // bs).long()).long()
        gk, gv = pk[blk, ring % bs], pv[blk, ring % bs]       # [B, nk * ck, Kv, hd]
        kv_chunk = ck
    else:
        gk, gv = gather_blocks(pk, tbl), gather_blocks(pv, tbl)
        pos = torch.arange(gk.shape[1], device=q.device)[None]
        kv_off = torch.zeros_like(start)
    rel = pos - start[:, None]                                  # [B, rows]
    fm = ((rel >= 0) & (rel < C))[..., None, None]
    idx = rel.clamp(0, C - 1).long()[..., None, None].expand(-1, -1, *k_new.shape[2:])
    gk = torch.where(fm, torch.gather(k_new, 1, idx), gk.to(k_new.dtype))
    gv = torch.where(fm, torch.gather(v_new, 1, idx), gv.to(v_new.dtype))
    return chunked_attention(q, gk, gv, causal=True, window=window, softcap=softcap,
                             q_offsets=start, kv_offsets=kv_off,
                             kv_lengths=start + valid - kv_off, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)


def paged_decode_attention(q, pk, pv, tbl, lengths, *, window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """Decode attention against paged K/V pools.

    q [B,1,H,hd]; pools [NB+1, bs, Kv, hd]; ``tbl`` [B, MB] block table;
    ``lengths`` [B] = rows before this step's token.  The gather reproduces
    the contiguous cache layout of ``MB * bs`` rows (linear positions, or
    the ring's when the table spans exactly the window), so this is
    value-identical to :func:`decode_attention` on a contiguous cache of
    that length."""
    from repro_torch.engine.paged import gather_blocks
    gk, gv = gather_blocks(pk, tbl), gather_blocks(pv, tbl)
    cap = gk.shape[1]
    if window and cap == window:                                # ring layout
        return decode_attention(q, gk, gv, (lengths + 1).clamp(max=cap), softcap=softcap)
    return decode_attention(q, gk, gv, lengths + 1, window=window, softcap=softcap)


def paged_verify_attention(q, pk, pv, k_new, v_new, tbl, start, valid, *, window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """Speculative-verify attention against the paged cache: row ``j`` of
    the chunk gives what :func:`decode_attention` gives for a decode step at
    position ``start[b] + j``, operation for operation.

    q / k_new / v_new [B,C,{H|Kv},hd] are the chunk's rows; the pools and
    ``tbl`` are the cache before they are written.  The kv buffer is the
    table's gather with the fresh rows overlaid as a decode step would read
    them back (cast to the pool dtype; an fp8 pool upcast to bf16), the
    per-row length mask ``pos < start + j + 1`` hides rows past each one,
    and the scores, softmax and fp32 contraction are
    :func:`decode_attention`'s, batched over the C rows.  Unlike
    :func:`paged_prefill_attention` (online softmax over flash tiles), this
    keeps greedy speculative serving token-exact against per-token decode
    on the CPU (``engine/spec.py``).  ``valid`` is unused: rows past it are
    garbage the caller discards.

    A ring table (``MB * bs == window``) has no shared buffer: row ``j``'s
    decode step would see ring row ``s`` holding the chunk's row ``i = (s
    - start) % window`` where ``i <= j`` and the older position there
    otherwise, so each row rebuilds that ring and runs
    :func:`decode_attention` on it with the effective length ``min(start +
    j + 1, window)``, the decode step's own call (a chunk is ``n_spec + 1``
    rows)."""
    from repro_torch.engine.paged import gather_blocks
    B, C, H, hd = q.shape
    Kv = k_new.shape[2]
    cdt = torch.bfloat16 if pk.element_size() == 1 else pk.dtype   # fp8: upcast
    gk, gv = gather_blocks(pk, tbl).to(cdt), gather_blocks(pv, tbl).to(cdt)
    if window and gk.shape[1] == window:                        # ring layout
        i_s = (torch.arange(window, device=q.device)[None] - start[:, None]) % window
        idx = i_s.clamp(max=C - 1).long()[..., None, None].expand(-1, -1, Kv, hd)
        kf = torch.gather(k_new.to(pk.dtype).to(cdt), 1, idx)   # [B, window, Kv, hd]
        vf = torch.gather(v_new.to(pv.dtype).to(cdt), 1, idx)
        out = []
        for j in range(C):
            fm = (i_s <= j)[..., None, None]
            out.append(decode_attention(q[:, j:j + 1], torch.where(fm, kf, gk),
                                        torch.where(fm, vf, gv),
                                        (start + j + 1).clamp(max=window), softcap=softcap))
        return torch.cat(out, dim=1)
    pos = torch.arange(gk.shape[1], device=q.device)[None]
    rel = pos - start[:, None]                                  # [B, cap]
    fm = ((rel >= 0) & (rel < C))[..., None, None]
    idx = rel.clamp(0, C - 1).long()[..., None, None].expand(-1, -1, Kv, hd)
    kbuf = torch.where(fm, torch.gather(k_new.to(pk.dtype).to(cdt), 1, idx), gk)
    vbuf = torch.where(fm, torch.gather(v_new.to(pv.dtype).to(cdt), 1, idx), gv)
    s = _tile_scores(q.reshape(B, C, Kv, H // Kv, hd), kbuf, softcap)  # [B,Kv,G,C,cap]
    qpos = start[:, None] + torch.arange(C, device=q.device)[None]     # [B, C]
    mask = pos[:, None, :] < (qpos + 1)[..., None]                      # [B, C, cap]
    if window:                                                  # a linear table
        mask = mask & (pos[:, None, :] > (qpos[..., None] - window))
    p = torch.softmax(torch.where(mask[:, None, None], s, NEG_INF), dim=-1)
    out = torch.einsum("bkgqc,bckh->bqkgh", p.to(vbuf.dtype).float(), vbuf.float())
    return out.reshape(B, C, H, hd).to(q.dtype)
