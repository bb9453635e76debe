"""Flash attention forward in plain PyTorch (online softmax over kv tiles).

Port of the forward pass of ``repro/models/flash.py``.  Scores are computed
per (q tile, kv tile) with a running (max, denominator, accumulator) carry,
so memory is O(tile^2) instead of O(S^2).  The tile math follows the
reference operation for operation — fp32 scores from the input dtype, the
same masking, correction and accumulation order — which is what keeps a
chunked computation equal to the one-shot one; ``scaled_dot_product_attention``
accumulates in another order and is not used.

Layout: q [B, Sq, Kv, G, hd] (grouped GQA — kv heads never repeated),
k/v [B, Skv, Kv, hd]; ``mask`` is an fp32 [B, Skv] validity row (1/0).
The backward pass (training) is not ported yet.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _tile_scores(qc: torch.Tensor, kc: torch.Tensor, softcap: float) -> torch.Tensor:
    """qc [B,cq,Kv,G,hd], kc [B,ck,Kv,hd] -> fp32 [B,Kv,G,cq,ck]."""
    hd = qc.shape[-1]
    s = torch.einsum("bqkgh,bckh->bkgqc", qc.float(), kc.float()) * (hd ** -0.5)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    return s


def _tile_mask(q_pos, kv_pos, mask_row, causal: bool, window: int) -> torch.Tensor:
    """[B,1,1,cq,ck] boolean tile mask from per-batch global positions."""
    m = (mask_row > 0)[:, None, None, None, :]
    if causal:
        m = m & (kv_pos[:, None, :] <= q_pos[:, :, None])[:, None, None]
    if window > 0:
        m = m & (kv_pos[:, None, :] > (q_pos[:, :, None] - window))[:, None, None]
    return m


def flash_attention(q, k, v, mask, q_off, kv_off, causal: bool, window: int,
                    softcap: float, cq: int, ck: int) -> torch.Tensor:
    """q [B,Sq,Kv,G,hd]; k,v [B,Skv,Kv,hd]; mask f32 [B,Skv]; ``q_off`` /
    ``kv_off`` [B] shift the global positions the causal / window masks see.
    Sq and Skv are multiples of cq and ck.  Returns [B,Sq,Kv,G,hd] in q.dtype."""
    B, Sq, Kv, G, hd = q.shape
    Skv = k.shape[1]
    nq, nk = Sq // cq, Skv // ck
    dev = q.device
    out = torch.empty((B, Sq, Kv, G, hd), dtype=torch.float32, device=dev)
    ar_q = torch.arange(cq, device=dev)[None]
    ar_k = torch.arange(ck, device=dev)[None]
    for qi in range(nq):
        qc = q[:, qi * cq:(qi + 1) * cq]
        q_pos = q_off[:, None] + qi * cq + ar_q
        shape = (B, Kv, G, cq)
        m = torch.full(shape, NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros(shape, dtype=torch.float32, device=dev)
        acc = torch.zeros(shape + (hd,), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kv_pos = kv_off[:, None] + ki * ck + ar_k
            kc = k[:, ki * ck:(ki + 1) * ck]
            vc = v[:, ki * ck:(ki + 1) * ck]
            tm = _tile_mask(q_pos, kv_pos, mask[:, ki * ck:(ki + 1) * ck], causal, window)
            s = torch.where(tm, _tile_scores(qc, kc, softcap), NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(m_new <= NEG_INF, 0.0, m_new)
            p = torch.where(tm, torch.exp(s - m_safe[..., None]), 0.0)
            corr = torch.where(m <= NEG_INF, 0.0, torch.exp(m - m_safe))
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(vc.dtype).float(), vc.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]
        out[:, qi * cq:(qi + 1) * cq] = o.permute(0, 3, 1, 2, 4)
    return out.to(q.dtype)
