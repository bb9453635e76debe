"""Mixture-of-Experts FFN: grouped top-k routing with capacity (GShard form).

Port of ``repro/models/moe.py``.  Tokens are reshaped into groups
[G, g, D]; routing produces dispatch / combine tensors [G, g, E, C] (C =
per-group expert capacity), and expert compute is three batched products
over stacked expert weights [E, D, F].  A quantized expert stack is
dequantized (``qlinear.resolve_as``) and multiplied by ``torch.matmul``, as
the reference's ``resolve`` + ``einsum`` is: no fp8 kernel takes a 3-D
leaf.

Top-k gates are renormalized over the selected experts (Mixtral
convention).  Tokens overflowing capacity are dropped (their combine weight
is zero — the residual connection carries them through unchanged).  The
load-balancing auxiliary loss follows Switch/GShard: E * sum_e f_e * p_e.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import apply_mlp, dense_init
from repro_torch.quant_runtime import qlinear
from repro_torch.runtime import flags


def init_moe(gen, cfg: ModelConfig, dtype, device) -> dict:
    D, Fe, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def expert_stack(din, dout):
        out = torch.empty((E, din, dout), dtype=dtype, device=device)
        for e in range(E):
            out[e] = dense_init(gen, din, dout, dtype, device)
        return out

    p = {
        "router": dense_init(gen, D, E, torch.float32, device),  # fp32, never quantized
        "w_gate": expert_stack(D, Fe),                           # [E, D, F]
        "w_up": expert_stack(D, Fe),
        "w_down": expert_stack(Fe, D),                           # [E, F, D]
    }
    if cfg.n_shared_experts:
        Fs = Fe * cfg.n_shared_experts
        p["shared"] = {"w_gate": dense_init(gen, D, Fs, dtype, device),
                       "w_up": dense_init(gen, D, Fs, dtype, device),
                       "w_down": dense_init(gen, Fs, D, dtype, device)}
    return p


def _group_tokens(T: int, target: int = 1024) -> int:
    """Largest group size <= target that divides T (prefer powers of two)."""
    g = min(T, target)
    while T % g:
        g -= 1
    return g


def top_k_routing(logits: torch.Tensor, top_k: int, capacity: int):
    """logits [G, g, E] fp32 -> (dispatch [G,g,E,C] bf16 0/1, combine bf16,
    aux_loss scalar).  Sequential greedy top-k (``argmax``: the first index
    on ties) with per-expert queue positions across the k choices.  A token
    whose queue position reaches ``capacity`` gets no slot: the reference's
    ``one_hot(pos, capacity)`` gives a zero row there, which here is the
    comparison with ``arange(capacity)`` (``F.one_hot`` would raise)."""
    G, g, E = logits.shape
    probs = torch.softmax(logits, dim=-1)

    masks, gates = [], []
    p = probs
    for _ in range(top_k):
        m = F.one_hot(torch.argmax(p, dim=-1), E).to(torch.float32)   # [G,g,E]
        gates.append(torch.sum(probs * m, dim=-1))                     # raw prob
        masks.append(m)
        p = p * (1.0 - m)

    # renormalize gates over the selected experts
    denom = torch.clamp_min(sum(gates), 1e-9)
    gates = [gv / denom for gv in gates]

    # position of each token within its expert queue (across the k choices)
    slots = torch.arange(capacity, dtype=torch.float32, device=logits.device)
    combine = torch.zeros((G, g, E, capacity), dtype=torch.float32, device=logits.device)
    prev_count = torch.zeros((G, 1, E), dtype=torch.float32, device=logits.device)
    for m, gv in zip(masks, gates):
        pos_in_e = torch.cumsum(m, dim=1) - m + prev_count             # [G,g,E]
        prev_count = prev_count + torch.sum(m, dim=1, keepdim=True)
        pos = torch.sum(pos_in_e * m, dim=-1)                          # [G,g]
        within = (pos[..., None] == slots).to(torch.float32)           # [G,g,C]
        combine = combine + (gv[..., None, None] * m[..., None] * within[:, :, None, :])

    dispatch = (combine > 0).to(torch.bfloat16)

    # Switch-style load balance loss
    frac_tokens = torch.mean(masks[0], dim=1)                          # [G, E]
    frac_probs = torch.mean(probs, dim=1)
    aux = E * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    return dispatch, combine.to(torch.bfloat16), aux


def capacity(cfg: ModelConfig, g: int, full_capacity: bool = False) -> int:
    """Per-group expert capacity for groups of ``g`` tokens, rounded up to a
    multiple of 8 (the reference's lane alignment)."""
    K = cfg.top_k
    cap = g * K if full_capacity else max(int(g * K * cfg.capacity_factor / cfg.n_experts), 1)
    return -(-cap // 8) * 8


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig, group_target: int = 0,
              full_capacity: bool = False):
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar).

    ``full_capacity`` sizes every expert queue for the worst case
    (``g * K`` — no token can ever be dropped).  Routing then decouples
    across tokens: each token's output is a pure function of its own
    hidden state, which a paged prefill-chunk path needs."""
    B, S, D = x.shape
    E = cfg.n_experts
    T = B * S
    g = _group_tokens(T, group_target or flags["moe_group"])
    G = T // g
    cap = capacity(cfg, g, full_capacity)

    xt = x.reshape(G, g, D)
    logits = torch.einsum("gsd,de->gse", xt.float(), qlinear.resolve(p["router"]).float())
    dispatch, combine, aux = top_k_routing(logits, cfg.top_k, cap)

    # dispatch tokens -> [E, G, C, D] (one token or none per slot: exact)
    ex_in = torch.einsum("gsec,gsd->egcd", dispatch.to(xt.dtype), xt).reshape(E, G * cap, D)

    # each stack dequantized just before its product, so one is live at a time
    h_g = torch.matmul(ex_in, qlinear.resolve_as(p["w_gate"], x.dtype))
    h_u = torch.matmul(ex_in, qlinear.resolve_as(p["w_up"], x.dtype))
    h = F.silu(h_g.float()).to(x.dtype) * h_u
    del h_g, h_u
    ex_out = torch.matmul(h, qlinear.resolve_as(p["w_down"], x.dtype))

    y = torch.einsum("gsec,egcd->gsd", combine,
                     ex_out.reshape(E, G, cap, D).to(torch.bfloat16))
    y = y.reshape(B, S, D).to(x.dtype)

    if "shared" in p:
        y = y + apply_mlp(p["shared"], x)
    return y, aux * cfg.router_aux_loss
