"""Flash attention in plain PyTorch: online softmax over kv tiles, with a
backward that recomputes each tile from the saved log-sum-exp.

Port of ``repro/models/flash.py``.  Scores are computed per (q tile, kv
tile) with a running (max, denominator, accumulator) carry, so memory is
O(tile^2) instead of O(S^2).  The tile math follows the reference operation
for operation — fp32 scores from the input dtype, the same masking,
correction and accumulation order — which is what keeps a chunked
computation equal to the one-shot one; ``scaled_dot_product_attention``
accumulates in another order and is not used.

``flash_attention`` is a ``torch.autograd.Function`` that keeps only (q,
k, v, out, lse) for its backward, the reference's custom VJP: each (q, kv) tile's probabilities are
recomputed from ``lse``, with ``D = sum(dout * out)`` per query row, the
softcap chain rule and ``tau = hd**-0.5``; dq / dk / dv accumulate in fp32
and are cast to the inputs' dtypes; the mask and offsets get no gradient.
Autograd through the forward loop would instead keep every tile's
probabilities alive, O(S^2) memory.

Layout: q [B, Sq, Kv, G, hd] (grouped GQA — kv heads never repeated),
k/v [B, Skv, Kv, hd]; ``mask`` is an fp32 [B, Skv] validity row (1/0).
The softmax math is fp32 (float64 for float64 inputs).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The softmax and accumulation dtype: float32, or float64 for float64
    inputs (``torch.autograd.gradcheck``)."""
    return torch.promote_types(dtype, torch.float32)


def _tile_scores(qc: torch.Tensor, kc: torch.Tensor, softcap: float) -> torch.Tensor:
    """qc [B,cq,Kv,G,hd], kc [B,ck,Kv,hd] -> fp32 [B,Kv,G,cq,ck]."""
    hd = qc.shape[-1]
    ct = _acc_dtype(qc.dtype)
    s = torch.einsum("bqkgh,bckh->bkgqc", qc.to(ct), kc.to(ct)) * (hd ** -0.5)
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


def _fwd(q, k, v, mask, q_off, kv_off, causal: bool, window: int, softcap: float,
         cq: int, ck: int):
    """(out [B,Sq,Kv,G,hd] fp32, lse [B,Sq,Kv,G] fp32)."""
    B, Sq, Kv, G, hd = q.shape
    Skv = k.shape[1]
    nq, nk = Sq // cq, Skv // ck
    dev, ct = q.device, _acc_dtype(q.dtype)
    out = torch.empty((B, Sq, Kv, G, hd), dtype=ct, device=dev)
    lse = torch.empty((B, Sq, Kv, G), dtype=ct, device=dev)
    ar_q = torch.arange(cq, device=dev)[None]
    ar_k = torch.arange(ck, device=dev)[None]
    for qi in range(nq):
        qc = q[:, qi * cq:(qi + 1) * cq]
        q_pos = q_off[:, None] + qi * cq + ar_q
        shape = (B, Kv, G, cq)
        m = torch.full(shape, NEG_INF, dtype=ct, device=dev)
        l = torch.zeros(shape, dtype=ct, device=dev)
        acc = torch.zeros(shape + (hd,), dtype=ct, device=dev)
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
            pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(vc.dtype).to(ct), vc.to(ct))
            acc = acc * corr[..., None] + pv
            m = m_new
        l_safe = l.clamp_min(1e-30)
        out[:, qi * cq:(qi + 1) * cq] = (acc / l_safe[..., None]).permute(0, 3, 1, 2, 4)
        lse[:, qi * cq:(qi + 1) * cq] = (m + torch.log(l_safe)).permute(0, 3, 1, 2)
    return out, lse


def _bwd(q, k, v, mask, q_off, kv_off, out, lse, dout, causal, window, softcap, cq, ck):
    """(dq, dk, dv) fp32: the reference's ``_bwd_vjp``, tile for tile."""
    B, Sq, Kv, G, hd = q.shape
    Skv = k.shape[1]
    nq, nk = Sq // cq, Skv // ck
    tau = hd ** -0.5
    dev, ct = q.device, _acc_dtype(q.dtype)
    dout32 = dout.to(ct)
    drow = (dout32 * out.to(ct)).sum(dim=-1)                     # [B,Sq,Kv,G]
    dq = torch.zeros((B, Sq, Kv, G, hd), dtype=ct, device=dev)
    dk = torch.zeros((B, Skv, Kv, hd), dtype=ct, device=dev)
    dv = torch.zeros((B, Skv, Kv, hd), dtype=ct, device=dev)
    ar_q = torch.arange(cq, device=dev)[None]
    ar_k = torch.arange(ck, device=dev)[None]
    for qi in range(nq):
        rows = slice(qi * cq, (qi + 1) * cq)
        qc, doc = q[:, rows], dout32[:, rows]
        q_pos = q_off[:, None] + qi * cq + ar_q
        lct = lse[:, rows].permute(0, 2, 3, 1)                  # [B,Kv,G,cq]
        dct = drow[:, rows].permute(0, 2, 3, 1)
        dq_c = torch.zeros((B, cq, Kv, G, hd), dtype=ct, device=dev)
        for ki in range(nk):
            cols = slice(ki * ck, (ki + 1) * ck)
            kv_pos = kv_off[:, None] + ki * ck + ar_k
            kc, vc = k[:, cols], v[:, cols]
            s = _tile_scores(qc, kc, softcap)                   # capped scores
            tm = _tile_mask(q_pos, kv_pos, mask[:, cols], causal, window)
            p = torch.where(tm, torch.exp(torch.where(tm, s, NEG_INF) - lct[..., None]), 0.0)
            dv[:, cols] += torch.einsum("bkgqc,bqkgh->bckh", p, doc)
            dp = torch.einsum("bqkgh,bckh->bkgqc", doc, vc.to(ct))
            ds = p * (dp - dct[..., None])                      # d(capped scores)
            if softcap > 0:
                ds = ds * (1.0 - (s / softcap) ** 2)
            ds = ds * tau
            dq_c += torch.einsum("bkgqc,bckh->bqkgh", ds, kc.to(ct))
            dk[:, cols] += torch.einsum("bkgqc,bqkgh->bckh", ds, qc.to(ct))
        dq[:, rows] = dq_c
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, q_off, kv_off, causal, window, softcap, cq, ck):
        out, lse = _fwd(q, k, v, mask, q_off, kv_off, causal, window, softcap, cq, ck)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, mask, q_off, kv_off, out, lse)
        ctx.cfg = (causal, window, softcap, cq, ck)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, q_off, kv_off, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, mask, q_off, kv_off, out, lse, dout, *ctx.cfg)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None, None, None)


def flash_attention(q, k, v, mask, q_off, kv_off, causal: bool, window: int,
                    softcap: float, cq: int, ck: int) -> torch.Tensor:
    """q [B,Sq,Kv,G,hd]; k,v [B,Skv,Kv,hd]; mask f32 [B,Skv]; ``q_off`` /
    ``kv_off`` [B] shift the global positions the causal / window masks see.
    Sq and Skv are multiples of cq and ck.  Returns [B,Sq,Kv,G,hd] in
    q.dtype, differentiable in q, k and v (the forward's bits are the same
    with grad and without)."""
    return _FlashAttention.apply(q, k, v, mask, q_off, kv_off, causal, window, softcap, cq, ck)
