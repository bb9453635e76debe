"""Mamba-2 (SSD, state-space duality) block: the chunked prefill scan and the
exact one-step recurrent decode.

Port of the serving half of ``repro/models/ssm.py``.  The selective
state-space recurrence

    h_t = a_t * h_{t-1} + dt_t * x_t B_t^T          (h: [P, N] per head)
    y_t = C_t h_t + D * x_t

runs in matmul form over chunks of ``cfg.ssm_chunk`` rows (``ssd_scan``):
within a chunk the output is a masked ``(C_t . B_s)`` product, and one
``[P, N]`` state per head carries the recurrence from chunk to chunk.  As
in the reference, the projections are four separate matrices
(``in_z``, ``in_x``, ``in_bc``, ``in_dt``), each through
``quant_runtime/qlinear.py::matmul``, so a quantized tree runs the same
code.  The port computes every chunk's intra-chunk product at once and
loops over chunks only for the state hand-over, where the reference
``lax.scan``s the whole chunk body; the sums are the same up to their
order.  A decode step updates the cache's ``h`` and conv history in
place (the torch counterpart of the reference's buffer donation).

The paged engines' two chunk forms thread a slot's state through a piece
of ``C`` rows whose rows ``>= valid[b]`` are pads: ``mamba_prefill_chunk``
(the SSD form, pads masked to exact no-ops, so a chunked prefill on the
``ssm_chunk`` grid continues the one-shot prefill) and
``mamba_verify_chunk`` (the decode recurrence stepped row by row, each row
the op sequence of ``mamba_decode``).  ``mamba_decode``'s ``keep`` leaves
the state of the slots outside it as it was (the paged decode's inactive
and prefilling slots).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init
from repro_torch.quant_runtime import qlinear


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """One Mamba-2 sublayer's params, the reference's leaves and inits
    (``A = -exp(a_log) = -1``, ``softplus(dt_bias) ~ 0.13``)."""
    D = cfg.d_model
    di, N, nh = cfg.resolved_d_inner, cfg.ssm_state, cfg.n_ssm_heads
    K = cfg.conv_kernel

    def conv_w(width):
        return (0.1 * torch.randn((K, width), generator=gen, device=device)).to(dtype)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_z": dense_init(gen, D, di, dtype, device),
        "in_x": dense_init(gen, D, di, dtype, device),
        "in_bc": dense_init(gen, D, 2 * N, dtype, device),
        "in_dt": dense_init(gen, D, nh, dtype, device),
        "conv_x_w": conv_w(di),
        "conv_x_b": torch.zeros(di, dtype=dtype, device=device),
        "conv_bc_w": conv_w(2 * N),
        "conv_bc_b": torch.zeros(2 * N, dtype=dtype, device=device),
        "a_log": torch.zeros(nh, **f32),
        "dt_bias": torch.full((nh,), -2.0, **f32),
        "d_skip": torch.ones(nh, **f32),
        "norm_scale": torch.ones(di, dtype=dtype, device=device),
        "out_proj": dense_init(gen, di, D, dtype, device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``:
    ``max(x, 0) + log1p(exp(-|x|))``.  ``F.softplus`` returns ``x`` above its
    threshold and rounds differently below it."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None, valid: torch.Tensor | None = None):
    """Depthwise causal conv over S.  x [B, S, C]; w [K, C]; ``state``
    [B, K-1, C] prepends history (a decode step, or a prefill continuing a
    cache).  The K taps are added one at a time in fp32, in the
    reference's order.  Returns (silu(out) [B, S, C] fp32, new_state
    [B, K-1, C]: the last K-1 rows of history and input, or with ``valid``
    [B] (a right-padded chunk) the K-1 rows before row ``valid[b]``, so pad
    rows never enter the history)."""
    K = w.shape[0]
    Bsz, S, C = x.shape
    if state is None:
        state = torch.zeros((Bsz, K - 1, C), dtype=x.dtype, device=x.device)
    ext = torch.cat([state.to(x.dtype), x], dim=1)              # [B, S+K-1, C]
    out = torch.zeros((Bsz, S, C), dtype=torch.float32, device=x.device)
    for k in range(K):
        out = out + ext[:, k:k + S].float() * w[k].float()
    out = out + b.float()
    if valid is None:
        return F.silu(out), ext[:, S:]
    # ext row (K-1) + t holds input row t
    idx = valid.long()[:, None] + torch.arange(K - 1, device=x.device)[None]
    return F.silu(out), torch.gather(ext, 1, idx[..., None].expand(-1, -1, C))


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """RMSNormGated: ``norm(y * silu(z)) * scale`` (fp32 internals)."""
    g = y * F.silu(z.float())
    ms = (g * g).mean(dim=-1, keepdim=True)
    return g * torch.rsqrt(ms + eps) * scale.float()


def _project(p: dict, h: torch.Tensor, cfg: ModelConfig, conv_state: dict | None = None,
             valid: torch.Tensor | None = None):
    """The shared front half: four projections, the two convs and dt.
    Returns (z, xh [B, S, nh, P] fp32, Bc, Cc, dt [B, S, nh] fp32,
    new conv state {"conv_x", "conv_bc"} in bf16, as of row ``valid[b]``
    where given)."""
    Bsz, S, _ = h.shape
    N, nh, P = cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    z = qlinear.matmul(h, p["in_z"])
    xc = qlinear.matmul(h, p["in_x"])
    bc = qlinear.matmul(h, p["in_bc"])
    dt_raw = qlinear.matmul(h, p["in_dt"])
    cs_x = conv_state["conv_x"] if conv_state else None
    cs_bc = conv_state["conv_bc"] if conv_state else None
    xc, ns_x = _causal_conv(xc, p["conv_x_w"], p["conv_x_b"], cs_x, valid)
    bc, ns_bc = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"], cs_bc, valid)
    xh = xc.reshape(Bsz, S, nh, P)
    Bc, Cc = bc[..., :N], bc[..., N:]
    dt = softplus(dt_raw.float() + p["dt_bias"].float())
    new_state = {"conv_x": ns_x.to(torch.bfloat16), "conv_bc": ns_bc.to(torch.bfloat16)}
    return z, xh, Bc, Cc, dt, new_state


# ---------------------------------------------------------------------------
# Chunked SSD forward (train / prefill)
# ---------------------------------------------------------------------------

def ssd_scan(xh, Bc, Cc, dt, a_log, chunk: int, h0=None):
    """Chunked SSD.  xh [B, S, nh, P], Bc / Cc [B, S, N], dt [B, S, nh]
    (post-softplus); ``h0`` [B, nh, P, N] is the state before row 0 (zeros
    when None).  The last chunk is padded with zeros, which leave the state
    as it is (``dt = 0``: decay ``exp(0) = 1``, update 0).  Returns (y [B, S,
    nh, P] fp32, h_final [B, nh, P, N] fp32)."""
    Bsz, S, nh, P = xh.shape
    N = Bc.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    dev = xh.device
    A = -torch.exp(a_log.float())                                 # [nh], negative
    xc = xh.float().reshape(Bsz, nc, Q, nh, P)
    bc = Bc.float().reshape(Bsz, nc, Q, N)
    cc = Cc.float().reshape(Bsz, nc, Q, N)
    dc = dt.float().reshape(Bsz, nc, Q, nh)
    cum = torch.cumsum(A * dc, dim=2)                             # [B,nc,Q,nh] inclusive
    # intra-chunk: scores[t, s] = (C_t . B_s) * exp(cum_t - cum_s) * dt_s, s <= t;
    # exp(-inf) gives exact zeros above the diagonal
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]           # [B,nc,t,s,nh]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    decay = torch.exp(seg.masked_fill(~tri[:, :, None], float("-inf")))
    cb = torch.einsum("bctn,bcsn->bcts", cc, bc)
    w = cb[..., None] * decay * dc[:, :, None, :, :]
    y = torch.einsum("bctsh,bcshp->bcthp", w, xc)
    # each chunk's own contribution to the state at its end
    rem = torch.exp(cum[:, :, -1:, :] - cum)                      # decay from s to the end
    contrib = torch.einsum("bcshp,bcsn->bchpn", xc * (dc * rem)[..., None], bc)
    end_decay = torch.exp(cum[:, :, -1])                          # [B,nc,nh]
    h = torch.zeros((Bsz, nh, P, N), dtype=torch.float32, device=dev) if h0 is None \
        else h0.float()
    h_before = []
    for c in range(nc):
        h_before.append(h)
        h = h * end_decay[:, c, :, None, None] + contrib[:, c]
    # inter-chunk: the state before each chunk, decayed to each row
    y_inter = torch.einsum("bctn,bchpn->bcthp", cc, torch.stack(h_before, dim=1))
    y = y + y_inter * torch.exp(cum)[..., None]
    return y.reshape(Bsz, nc * Q, nh, P)[:, :S], h


def mamba_forward(p: dict, x_in: torch.Tensor, h: torch.Tensor, cfg: ModelConfig,
                  cache: dict | None = None):
    """The Mamba-2 sublayer on normed input ``h`` [B, S, D]; ``x_in`` (the
    residual) gives the output dtype; ``cache`` (``h``, ``conv_x``,
    ``conv_bc``) continues a sequence.  Returns (out [B, S, D], new cache
    {"h", "conv_x", "conv_bc"})."""
    Bsz, S, _ = h.shape
    z, xh, Bc, Cc, dt, conv_state = _project(p, h, cfg, cache)
    h0 = cache["h"] if cache is not None else None
    y, h_fin = ssd_scan(xh, Bc, Cc, dt, p["a_log"], cfg.ssm_chunk, h0)
    y = y + p["d_skip"].float()[None, None, :, None] * xh.float()
    y = _gated_norm(y.reshape(Bsz, S, cfg.resolved_d_inner), z, p["norm_scale"])
    out = qlinear.matmul(y.to(x_in.dtype), p["out_proj"])
    return out, {"h": h_fin, **conv_state}


def mamba_train(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The full-sequence forward with no cache."""
    out, _ = mamba_forward(p, h, h, cfg)
    return out


def mamba_prefill_chunk(p: dict, x_in: torch.Tensor, h: torch.Tensor, cfg: ModelConfig,
                        cache: dict, valid: torch.Tensor):
    """One prefill chunk through the Mamba-2 sublayer, continuing each
    slot's state.  ``h`` [B, C, D] holds rows ``start .. start + C - 1`` of
    each slot's prompt; rows ``>= valid[b]`` are pads, masked to exact
    no-ops of the SSD recurrence (``x``, ``dt``, ``B`` and ``C`` zero, the
    zeros ``ssd_scan`` pads its last chunk with), so the carried state and
    the real rows' outputs continue the one-shot :func:`mamba_forward` when
    chunk boundaries lie on multiples of ``cfg.ssm_chunk`` (the engine
    requires ``chunk_size % ssm_chunk == 0``).  A slot with ``valid == 0``
    keeps its state.  Returns (out [B, C, D], new cache {"h", "conv_x",
    "conv_bc"}); the caller writes it into the slot's leaves."""
    Bsz, C, _ = h.shape
    z, xh, Bc, Cc, dt, conv_state = _project(p, h, cfg, cache, valid=valid)
    vm = torch.arange(C, device=h.device)[None, :] < valid[:, None]       # [B, C]
    xh = torch.where(vm[:, :, None, None], xh, 0.0)
    dt = torch.where(vm[:, :, None], dt, 0.0)
    Bc = torch.where(vm[:, :, None], Bc, 0.0)
    Cc = torch.where(vm[:, :, None], Cc, 0.0)
    y, h_fin = ssd_scan(xh, Bc, Cc, dt, p["a_log"], cfg.ssm_chunk, cache["h"])
    y = y + p["d_skip"].float()[None, None, :, None] * xh.float()
    y = _gated_norm(y.reshape(Bsz, C, cfg.resolved_d_inner), z, p["norm_scale"])
    out = qlinear.matmul(y.to(x_in.dtype), p["out_proj"])
    return out, {"h": h_fin, **conv_state}


def mamba_verify_chunk(p: dict, x_in: torch.Tensor, h: torch.Tensor, cfg: ModelConfig,
                       cache: dict, valid: torch.Tensor):
    """Speculative-verify chunk: the exact recurrence stepped row by row,
    each row the op sequence of :func:`mamba_decode` (the same projections
    and conv taps, ``h = h * a + dBx`` and the same einsum shapes), so row
    ``j``'s output is what ``j + 1`` successive decode steps give (on the
    CPU bit for bit), where :func:`mamba_prefill_chunk`'s SSD form would
    reorder the sums.  Rows ``>= valid[b]`` are state no-ops (``dt = 0``:
    decay 1, update 0); a slot with ``valid == 0`` keeps its state and conv
    history.  Returns (out [B, C, D], new cache); output rows at or past
    ``valid[b]`` are garbage."""
    Bsz, C, _ = h.shape
    z, xh, Bc, Cc, dt, conv_state = _project(p, h, cfg, cache, valid=valid)
    A = -torch.exp(p["a_log"].float())
    vm = torch.arange(C, device=h.device)[None, :] < valid[:, None]
    dt = torch.where(vm[:, :, None], dt, 0.0)
    x32 = xh.float()
    hst, ys = cache["h"], []
    for t in range(C):
        dt0 = dt[:, t]
        a = torch.exp(A[None] * dt0)
        x0 = x32[:, t]
        dBx = (x0 * dt0[..., None])[..., None] * Bc[:, t].float()[:, None, None, :]
        hst = hst * a[..., None, None] + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", Cc[:, t].float(), hst))
    y = torch.stack(ys, dim=1) + p["d_skip"].float()[None, None, :, None] * x32
    y = _gated_norm(y.reshape(Bsz, C, cfg.resolved_d_inner), z, p["norm_scale"])
    out = qlinear.matmul(y.to(x_in.dtype), p["out_proj"])
    return out, {"h": hst, **conv_state}


def init_mamba_cache(cfg: ModelConfig, batch: int, device) -> dict:
    """Zero decode state of one layer: ``h`` fp32 [B, nh, P, N], conv
    histories bf16 [B, K-1, C]."""
    di, N, nh, P = (cfg.resolved_d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                    cfg.ssm_head_dim)
    bf16 = dict(dtype=torch.bfloat16, device=device)
    return {"h": torch.zeros((batch, nh, P, N), dtype=torch.float32, device=device),
            "conv_x": torch.zeros((batch, cfg.conv_kernel - 1, di), **bf16),
            "conv_bc": torch.zeros((batch, cfg.conv_kernel - 1, 2 * N), **bf16)}


def mamba_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig,
                 keep: torch.Tensor | None = None):
    """One-token decode, x [B, 1, D]: the exact recurrence, one step of
    ``h = a h + dt x B^T; y = C h + D x``.  ``cache``'s ``h``, ``conv_x``
    and ``conv_bc`` are updated in place; with ``keep`` [B] only the slots
    in it step (the others' ``dt`` is 0, a no-op of the recurrence, and
    their conv history is kept: the in-place form of the reference's
    per-slot select after a paged decode step).  Returns (out [B, 1, D],
    cache)."""
    Bsz = x.shape[0]
    z, xh, Bc, Cc, dt, conv_state = _project(p, x, cfg, cache)
    A = -torch.exp(p["a_log"].float())
    dt0 = dt[:, 0]                                                # [B, nh]
    if keep is not None:
        dt0 = torch.where(keep[:, None], dt0, 0.0)
    a = torch.exp(A[None] * dt0)
    x0 = xh.float()[:, 0]                                         # [B, nh, P]
    dBx = (x0 * dt0[..., None])[..., None] * Bc[:, 0].float()[:, None, None, :]
    h = cache["h"]
    h.mul_(a[..., None, None]).add_(dBx)
    y = torch.einsum("bn,bhpn->bhp", Cc[:, 0].float(), h)
    y = y + p["d_skip"].float()[None, :, None] * x0
    y = _gated_norm(y.reshape(Bsz, 1, cfg.resolved_d_inner), z, p["norm_scale"])
    out = qlinear.matmul(y.to(x.dtype), p["out_proj"])
    for name in ("conv_x", "conv_bc"):
        new = conv_state[name]
        if keep is not None:
            new = torch.where(keep[:, None, None], new, cache[name])
        cache[name].copy_(new)
    return out, cache
