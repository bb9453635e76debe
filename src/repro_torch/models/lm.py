"""Model assembly for the dense decoder, Mamba-2 (SSM) and MoE families.

Port of ``repro/models/lm.py`` for ``family == "dense"``, ``"ssm"`` and
``"moe"``.  Each family is the reference's layer plan (``layer_plan``): one
``(mixer, ffn)`` spec repeated over the stack, ``("attn", "mlp")`` for
dense, ``("mamba", "none")`` for SSM, ``("attn", "moe")`` for MoE, whose
first ``first_k_dense`` layers are a prefix stack of ``("attn",
"mlp_dense")`` run before it.  Params keep the reference's tree layout —
per-layer leaves stacked on a leading ``[n, ...]`` axis under
``params["stack"]["L0"]`` (``stack/L0/mamba/in_z`` and so on) and
``params["prefix"]["L0"]``, the MoE expert stacks as ``[n, E, D, F]`` — so
a tree converted from the reference
(``repro_torch.compat.params_from_jax``) loads directly; decode caches
stack the same way under ``cache["prefix"]`` and ``cache["stack"]``.  A
layer's decode cache is K/V rows for attention and the recurrent state
(``h``, ``conv_x``, ``conv_bc``, no sequence axis) for Mamba
(``init_layer_cache``); a sliding-window layer keeps a ring of
``min(cache_len, sliding_window)`` rows, position ``p`` in row ``p %
window`` (``_ring_write``), and attends the ring's rows through an
effective length in place of a window mask.  Where the reference
``lax.scan``s over the stack,
the port loops over layers in Python, slicing each layer's views out of the
stacked leaves; decode caches are updated in place (the torch counterpart
of the reference's buffer donation).  The paged decode cache
(``init_paged_cache``, ``decode_step_paged``) holds, under each group's
``L0``, per-layer K/V block pools ``[n, num_blocks + 1, block_size, Kv,
hd]`` for attention layers and the per-slot state for Mamba layers
(``init_layer_cache_paged``), and the allocator state of
``engine/paged.py`` at the cache's top level, as the reference's does; a
sliding-window stack pages the ring itself (a table of ``window /
block_size`` entries, whole from admission on, ``ring=True`` in the
allocator);
``prefill_chunk_paged`` runs one piece of each slot's prompt through that
cache (chunked prefill, prefix-hit tails; an MoE layer at full capacity, a
Mamba layer through ``mamba_prefill_chunk``), and ``verify_chunk_paged`` a
speculative round's draft tokens (each row the decode step at its
position, on the CPU bit for bit; a Mamba layer through
``mamba_verify_chunk``).  ``run_stack_train`` is the full-sequence forward
with no cache, one group at a time: calibration and the scores walk it
(``data/synthetic.py::_full_logits``) without grad, and ``Model.loss_fn``
trains through it with grad, each layer under the reference's remat
policies (``_remat``); an MoE layer there routes with the group's capacity
and returns the router's auxiliary loss, which ``loss_fn`` adds.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.core.policy import tree_map
from repro_torch.models.common import (apply_mlp, apply_norm, apply_rope, chunked_xent,
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


LayerSpec = tuple[str, str]  # (mixer, ffn)
ATTN_MLP: LayerSpec = ("attn", "mlp")


def layer_plan(cfg: ModelConfig):
    """(prefix_specs, n_prefix, period_specs, n_periods), as the reference's
    ``layer_plan``, for the families the port runs."""
    if cfg.family == "dense":
        return [], 0, [ATTN_MLP], cfg.n_layers
    if cfg.family == "moe":
        k = cfg.first_k_dense
        prefix = [("attn", "mlp_dense")] if k else []
        return prefix, k, [("attn", "moe")], cfg.n_layers - k
    if cfg.family == "ssm":
        return [], 0, [("mamba", "none")], cfg.n_layers
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet (ROADMAP Queue A 5)")


def init_layer(gen, cfg: ModelConfig, dtype, device, spec: LayerSpec) -> dict:
    mixer, ffn = spec
    p = {"ln1": init_norm(cfg, dtype, device)}
    if mixer == "attn":
        p["attn"] = A.init_attn(gen, cfg, dtype, device)
    elif mixer == "mamba":
        p["mamba"] = SSM.init_mamba(gen, cfg, dtype, device)
    else:
        raise ValueError(mixer)
    if ffn == "mlp":
        p["ln2"] = init_norm(cfg, dtype, device)
        p["mlp"] = init_mlp(gen, cfg, cfg.d_ff, dtype, device)
    elif ffn == "mlp_dense":
        p["ln2"] = init_norm(cfg, dtype, device)
        p["mlp"] = init_mlp(gen, cfg, cfg.d_ff_dense or cfg.d_ff, dtype, device)
    elif ffn == "moe":
        p["ln2"] = init_norm(cfg, dtype, device)
        p["moe"] = MOE.init_moe(gen, cfg, dtype, device)
    elif ffn != "none":
        raise ValueError(ffn)
    return p


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, cache_len: int,
                     device) -> dict:
    """Zero decode cache of one layer: K/V rows for attention (a ring of
    ``min(cache_len, sliding_window)`` rows for a sliding window), the
    recurrent state for Mamba (no sequence axis: ``cache_len`` unused)."""
    if spec[0] == "mamba":
        return SSM.init_mamba_cache(cfg, batch, device)
    sc = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    shape = (batch, sc, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cache_dtype(), device=device),
            "v": torch.zeros(shape, dtype=cache_dtype(), device=device)}


def _ffn(p: dict, x, cfg: ModelConfig, spec: LayerSpec, full_capacity: bool = False):
    """The residual feed-forward half of a layer (none for Mamba layers; an
    MoE layer routes with capacity, or at ``full_capacity``, and drops its
    auxiliary loss, as the reference's serving forwards do)."""
    if spec[1] == "none":
        return x
    h = apply_norm(p["ln2"], x, cfg.norm_eps)
    if spec[1] == "moe":
        return x + MOE.apply_moe(p["moe"], h, cfg, full_capacity=full_capacity)[0]
    return x + apply_mlp(p["mlp"], h)


def init_layer_cache_paged(cfg: ModelConfig, spec: LayerSpec, batch: int, num_blocks: int,
                           block_size: int, device) -> dict:
    """Paged decode cache of one layer: attention's K/V become block pools
    ``pk`` / ``pv`` [num_blocks + 1, block_size, Kv, hd] (the last block is
    the trash sink, ``engine/paged.py``); a Mamba layer's state has no
    sequence axis to page and stays per slot."""
    if spec[0] == "mamba":
        return SSM.init_mamba_cache(cfg, batch, device)
    shape = (num_blocks + 1, block_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"pk": torch.zeros(shape, dtype=cache_dtype(), device=device),
            "pv": torch.zeros(shape, dtype=cache_dtype(), device=device)}


def _init_stack(gen, cfg: ModelConfig, n: int, dtype, device, spec: LayerSpec) -> dict:
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
        one = init_layer(gen, cfg, dtype, device, spec)
        if stack is None:
            stack = tree_map(alloc, one)
        fill(stack, one, i)
    return {"L0": stack}


def _ring_write(cache_k, cache_v, k_new, v_new, lengths):
    """Write one new kv [B,1,Kv,hd] into ring caches at row ``lengths %
    capacity``, in place."""
    bidx = torch.arange(k_new.shape[0], device=cache_k.device)
    slot = (lengths % cache_k.shape[1]).long()
    cache_k[bidx, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v_new[:, 0].to(cache_v.dtype)


def _attn_decode(p: dict, x, cache: dict, lengths, cfg: ModelConfig):
    """Self-attn decode for one layer: the new K/V lands in the layer's
    cache views in place.  A cache of exactly ``sliding_window`` rows is a
    ring: the row goes to ``lengths % window`` and attention reads the
    ``min(lengths + 1, window)`` rows written (in ring order, the window
    itself); a linear cache under a window masks the rows before it."""
    B = x.shape[0]
    q, k, v = A.qkv_proj(p, x, cfg)
    if cfg.rope_theta > 0:
        cos, sin = rope_cos_sin(lengths[:, None], cfg.resolved_head_dim, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    cap = cache["k"].shape[1]
    if cfg.sliding_window and cap == cfg.sliding_window:
        _ring_write(cache["k"], cache["v"], k, v, lengths)
        out = A.decode_attention(q, cache["k"], cache["v"], (lengths + 1).clamp(max=cap),
                                 softcap=cfg.attn_logit_softcap)
    else:
        A.write_cache(cache["k"], cache["v"], k, v, lengths)
        out = A.decode_attention(q, cache["k"], cache["v"], lengths + 1,
                                 window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
    return qlinear.matmul(out.reshape(B, 1, -1), p["wo"])


def apply_layer_decode(p: dict, x, cache: dict, lengths, cfg: ModelConfig,
                       spec: LayerSpec):
    """One decode step of a layer; its cache (views) is updated in place."""
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    if spec[0] == "mamba":
        y, _ = SSM.mamba_decode(p["mamba"], h, cache, cfg)
        x = x + y
    else:
        x = x + _attn_decode(p["attn"], h, cache, lengths, cfg)
    return _ffn(p, x, cfg, spec)


def _attn_decode_paged(p: dict, x, cache: dict, pctx: dict, cfg: ModelConfig):
    """Self-attn decode against the layer's block pools (views [NB+1, bs,
    Kv, hd]): as :func:`_attn_decode` for every active slot, the new K/V
    written in place at the step's write target (``pctx["wblk"]`` /
    ``["woff"]``, trash for inactive slots) and attention over the block
    table's gather.

    With ``pctx["cow_src"]`` (prefix caching) the write block first takes
    the rows of its copy-on-write source.  The reference skips that copy
    with a branch on whether any slot copies; a tensor-valued branch would
    synchronize the host, so here the copy always runs: where nothing is
    shared ``cow_src == wblk``, and copying a block onto itself changes no
    bit."""
    B = x.shape[0]
    lengths = pctx["lengths"]
    q, k, v = A.qkv_proj(p, x, cfg)
    if cfg.rope_theta > 0:
        cos, sin = rope_cos_sin(lengths[:, None], cfg.resolved_head_dim, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if "cow_src" in pctx:
        for pool in (cache["pk"], cache["pv"]):
            pool[pctx["wblk"]] = pool[pctx["cow_src"]]
    A.write_paged_kv(cache["pk"], cache["pv"], k, v, pctx["wblk"], pctx["woff"])
    out = A.paged_decode_attention(q, cache["pk"], cache["pv"], pctx["tbl"], lengths,
                                   window=cfg.sliding_window,
                                   softcap=cfg.attn_logit_softcap)
    return qlinear.matmul(out.reshape(B, 1, -1), p["wo"])


def apply_layer_decode_paged(p: dict, x, cache: dict, pctx: dict, cfg: ModelConfig,
                             spec: LayerSpec):
    """One paged decode step of a layer: attention against the block pools,
    a Mamba layer's per-slot state stepped for the slots in
    ``pctx["keep"]`` only; an MoE layer routes with capacity, as the
    contiguous decode does."""
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    if spec[0] == "mamba":
        x = x + SSM.mamba_decode(p["mamba"], h, cache, cfg, keep=pctx["keep"])[0]
    else:
        x = x + _attn_decode_paged(p["attn"], h, cache, pctx, cfg)
    return _ffn(p, x, cfg, spec)


def _attn_prefill_paged(p: dict, x, cache: dict, pctx: dict, cfg: ModelConfig):
    """Self-attn over one prefill chunk against the layer's block pools: the
    chunk's rows (global positions ``start[b] + j``) attend the slot's
    cached prefix and themselves, then land in the pools at the span
    targets (pads, overflows and shared blocks go to the trash block)."""
    B, C, _ = x.shape
    q, k, v = A.qkv_proj(p, x, cfg)
    if cfg.rope_theta > 0:
        pos = pctx["start"][:, None] + torch.arange(C, device=x.device)[None]
        cos, sin = rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    out = A.paged_prefill_attention(q, cache["pk"], cache["pv"], k, v, pctx["tbl"],
                                    pctx["start"], pctx["valid"], window=cfg.sliding_window,
                                    softcap=cfg.attn_logit_softcap, q_chunk=pctx["q_chunk"],
                                    kv_chunk=pctx["kv_chunk"])
    A.write_paged_kv_span(cache["pk"], cache["pv"], k, v, pctx["wblk"], pctx["woff"])
    return qlinear.matmul(out.reshape(B, C, -1), p["wo"])


def _mamba_chunk(fn, p: dict, x, h, cache: dict, pctx: dict, cfg: ModelConfig):
    """A Mamba layer over one chunk (``fn``: ``mamba_prefill_chunk`` or
    ``mamba_verify_chunk``), the slots' new state written into the layer's
    leaves in place."""
    y, new = fn(p["mamba"], x, h, cfg, cache, pctx["valid"])
    for name, t in new.items():
        cache[name].copy_(t)
    return y


def apply_layer_prefill_paged(p: dict, x, cache: dict, pctx: dict, cfg: ModelConfig,
                              spec: LayerSpec):
    """One prefill chunk through a layer: attention writes the chunk's rows
    into the pools, a Mamba layer carries each slot's state from chunk to
    chunk.  An MoE layer routes at full capacity: the chunk's batch mixes
    unrelated slots' rows and pads, and competing for capacity with them
    would make a token's output depend on its batch (chunked == one-shot
    holds where the one-shot routing drops nothing)."""
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    if spec[0] == "mamba":
        x = x + _mamba_chunk(SSM.mamba_prefill_chunk, p, x, h, cache, pctx, cfg)
    else:
        x = x + _attn_prefill_paged(p["attn"], h, cache, pctx, cfg)
    return _ffn(p, x, cfg, spec, full_capacity=True)


def _attn_verify_paged(p: dict, x, cache: dict, pctx: dict, cfg: ModelConfig):
    """Self-attn over one speculative-verify chunk: row ``j`` repeats the
    decode step at position ``start[b] + j`` op for op
    (``A.paged_verify_attention``), then the chunk's rows land in the pools
    at the span targets (pads and overflows go to the trash block)."""
    B, C, _ = x.shape
    q, k, v = A.qkv_proj(p, x, cfg)
    if cfg.rope_theta > 0:
        pos = pctx["start"][:, None] + torch.arange(C, device=x.device)[None]
        cos, sin = rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    out = A.paged_verify_attention(q, cache["pk"], cache["pv"], k, v, pctx["tbl"],
                                   pctx["start"], pctx["valid"], window=cfg.sliding_window,
                                   softcap=cfg.attn_logit_softcap)
    A.write_paged_kv_span(cache["pk"], cache["pv"], k, v, pctx["wblk"], pctx["woff"])
    return qlinear.matmul(out.reshape(B, C, -1), p["wo"])


def apply_layer_verify_paged(p: dict, x, cache: dict, pctx: dict, cfg: ModelConfig,
                             spec: LayerSpec):
    """One speculative-verify chunk through a layer, each row the decode
    step at its position: attention as :func:`_attn_verify_paged`, a Mamba
    layer the exact recurrence row by row (``mamba_verify_chunk``), an MoE
    layer at full capacity (its rows then equal the decode step's wherever
    the decode's own routing drops nothing, which the engine requires of a
    speculative MoE serve)."""
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    if spec[0] == "mamba":
        x = x + _mamba_chunk(SSM.mamba_verify_chunk, p, x, h, cache, pctx, cfg)
    else:
        x = x + _attn_verify_paged(p["attn"], h, cache, pctx, cfg)
    return _ffn(p, x, cfg, spec, full_capacity=True)


def cow_copy_blocks(cache: dict, src: torch.Tensor, dst: torch.Tensor) -> dict:
    """A speculative round's copy-on-write: block ``src[b]``'s rows go into
    block ``dst[b]`` in every attention layer's ``pk`` / ``pv`` pool (the
    ``prefix`` and ``stack`` groups), in place, before
    any write of the round (``engine/paged.py::alloc_span`` rewired the
    slot's shared first span block to ``dst``).  The reference skips the
    copy with a branch on whether any slot copies; a tensor-valued branch
    would synchronize the host, so here it always runs: slots without a
    copy carry ``src == dst``, the trash block, and copying a block onto
    itself changes no bit."""
    src, dst = src.long(), dst.long()
    for grp in ("prefix", "stack"):
        for name, pool in cache.get(grp, {}).get("L0", {}).items():
            if name in ("pk", "pv"):
                pool[:, dst] = pool[:, src]
    return cache


def apply_layer_prefill(p: dict, x, cache: dict, cfg: ModelConfig, spec: LayerSpec,
                        tiles=(0, 0)):
    """Pre-norm residual layer over a whole prompt; writes the layer's
    decode cache (views) in place: K/V rows [B, cache_len, Kv, hd] for
    attention (a ring keeps the prompt's last ``min(S, window)`` rows, row
    ``p`` at ``p % window``), the state after the prompt's last row for
    Mamba.  ``tiles`` are the flash tiles ``(q_chunk, kv_chunk)``, 0 for
    the defaults."""
    B, S, _ = x.shape
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    if spec[0] == "mamba":
        y, new = SSM.mamba_forward(p["mamba"], x, h, cfg)
        for name, t in new.items():
            cache[name].copy_(t)
        return _ffn(p, x + y, cfg, spec)
    q, k, v = A.qkv_proj(p["attn"], h, cfg)
    if cfg.rope_theta > 0:
        pos = torch.arange(S, device=x.device)[None]
        cos, sin = rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    out = A.chunked_attention(q, k, v, causal=True, window=cfg.sliding_window,
                              softcap=cfg.attn_logit_softcap, q_chunk=tiles[0],
                              kv_chunk=tiles[1])
    x = x + qlinear.matmul(out.reshape(B, S, -1), p["attn"]["wo"])
    sc = cache["k"].shape[1]
    if cfg.sliding_window and sc == cfg.sliding_window:
        n = min(S, sc)
        slots = torch.arange(S - n, S, device=x.device) % sc
        cache["k"][:, slots] = k[:, S - n:].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, S - n:].to(cache["v"].dtype)
    else:
        cache["k"][:, :S] = k[:, :sc].to(cache["k"].dtype)
        cache["v"][:, :S] = v[:, :sc].to(cache["v"].dtype)
    return _ffn(p, x, cfg, spec)


def apply_layer_train(p: dict, x, cfg: ModelConfig, spec: LayerSpec):
    """Pre-norm residual layer over a whole sequence, no cache, as the
    reference's ``apply_layer_train``: returns ``(x, aux)``, ``aux`` the MoE
    router's auxiliary loss (routed with the group's capacity, not
    ``full_capacity``), 0.0 for any other layer."""
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    if spec[0] == "mamba":
        x = x + SSM.mamba_train(p["mamba"], h, cfg)
    else:
        x = x + A.self_attn_train(p["attn"], h, cfg)
    if spec[1] == "moe":
        y, aux = MOE.apply_moe(p["moe"], apply_norm(p["ln2"], x, cfg.norm_eps), cfg)
        return x + y, aux
    return _ffn(p, x, cfg, spec), 0.0


def _layers(stack: dict, n: int) -> list:
    """The ``n`` layers of a stacked tree for a forward with grad: each dense
    leaf is ``unbind``-ed once, so its backward stacks every layer's
    gradient into one ``[n, ...]`` tensor in one node (a slice per layer
    would add a zero-filled stack per layer)."""
    parts = tree_map(lambda t: t if isinstance(t, QuantizedTensor) else t.unbind(0), stack)
    return [tree_map(lambda t: t.layer(i) if isinstance(t, QuantizedTensor) else t[i], parts)
            for i in range(n)]


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``"dots_saveable"``: keep matrix
    products, recompute everything else (``jax.checkpoint_policies.dots_saveable``)."""
    from torch.utils.checkpoint import CheckpointPolicy
    dots = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)
    return CheckpointPolicy.MUST_SAVE if op in dots else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` under the reference's remat policy: ``"none"`` keeps every
    activation, ``"dots_saveable"`` keeps the matrix products, anything else
    (``"full"``) keeps only the layer's input and recomputes the rest in the
    backward."""
    if policy == "none":
        return fn
    from functools import partial
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts
    kw = {"use_reentrant": False, "preserve_rng_state": False}
    if policy == "dots_saveable":
        kw["context_fn"] = partial(create_selective_checkpoint_contexts, _save_dots)
    return lambda *args: checkpoint(fn, *args, **kw)


def run_stack_train(stack: dict, x, cfg: ModelConfig, spec: LayerSpec, remat: str = "full"):
    """The stacked layers ``stack`` (a group's ``params[name]["L0"]``, each
    layer of ``spec``) applied in order to ``x`` [B, S, D] over whole
    sequences, no cache, each layer's ``qlinear.matmul``s in the
    reference's order.  Returns ``(x, aux)``, ``aux`` the fp32 sum of the
    layers' auxiliary losses in layer order (the reference's scan carry).

    Without grad (calibration and scores, ``data/synthetic.py::_full_logits``)
    each layer reads views of the stacked leaves and ``remat`` is moot.  With
    grad, each layer runs under ``remat`` (``_remat``) and the gradients
    reach the stacked leaves in the reference's ``[n_layers, ...]`` layout,
    the expert stacks' ``[n, E, D, F]`` included; the forward's bits are
    the same either way."""
    n = n_stacked(stack)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not torch.is_grad_enabled():
        for i in range(n):
            x, a = apply_layer_train(layer_view(stack, i), x, cfg, spec)
            aux = aux + a
        return x, aux
    layer = _remat(apply_layer_train, remat)
    for lp in _layers(stack, n):
        x, a = layer(lp, x, cfg, spec)
        aux = aux + a
    return x, aux


class Model:
    """Dense decoder, Mamba-2 or MoE stack: ``init``, ``loss_fn``,
    ``init_cache``, ``prefill``, ``decode_step`` with the reference
    ``Model``'s signatures (a ``torch.Generator`` in place of a PRNG key).
    ``groups`` lists each stacked subtree with its layer spec, the MoE
    family's dense prefix first; the paged forwards (``init_paged_cache``,
    ``decode_step_paged``, ``prefill_chunk_paged``, ``verify_chunk_paged``)
    run every group, and so do ``loss_fn`` (every family trains, the MoE
    router's auxiliary loss added) and the whole-sequence forward of
    ``data/synthetic.py::_full_logits``."""

    def __init__(self, cfg: ModelConfig, device=None):
        prefix_specs, n_prefix, specs, n_periods = layer_plan(cfg)
        self.spec = specs[0]
        # (subtree, layer spec, layers) in the order a forward runs them
        self.groups = ([("prefix", prefix_specs[0], n_prefix)] if n_prefix else []) \
            + [("stack", self.spec, n_periods)]
        self.cfg = cfg
        self.device = get_device(device)
        self.dtype = getattr(torch, cfg.dtype)

    def init(self, gen: torch.Generator) -> dict:
        """Params drawn from ``gen`` in the reference's key order: the
        embedding, the stack, the prefix."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        p = {"embed": init_embed(gen, cfg, dt, dev)}
        for name, spec, n in self.groups[::-1]:
            p[name] = _init_stack(gen, cfg, n, dt, dev, spec)
        p["final_norm"] = init_norm(cfg, dt, dev)
        return p

    def loss_fn(self, params: dict, batch: dict, remat: str = "full"):
        """Mean next-token loss of ``batch`` (``tokens``, ``labels`` [B, S];
        labels < 0 ignored) plus the MoE router's auxiliary loss: embed ->
        each of ``groups`` in order (the dense prefix, then the stack; under
        ``remat``) -> final norm -> ``chunked_xent``.  Returns ``(loss +
        aux, {"loss", "aux_loss", "accuracy", "n_tokens"})`` as 0-d fp32
        tensors, as the reference's ``loss_fn``; ``aux_loss`` is 0 for the
        dense and SSM families."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], batch["tokens"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for name, spec, _ in self.groups:
            x, a = run_stack_train(params[name]["L0"], x, cfg, spec, remat=remat)
            aux = aux + a
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        loss, acc, n_tok = chunked_xent(params["embed"], x, batch["labels"])
        return loss + aux, {"loss": loss, "aux_loss": aux, "accuracy": acc,
                            "n_tokens": n_tok}

    def init_cache(self, batch: int, cache_len: int) -> dict:
        """Zero decode cache: each leaf of ``init_layer_cache`` stacked on a
        leading layer axis under ``<group>/L0`` for each of ``groups``, and
        per-slot ``lengths``."""
        cache = {}
        for name, spec, n in self.groups:
            one = init_layer_cache(self.cfg, spec, batch, cache_len, self.device)
            cache[name] = {"L0": {k: torch.zeros((n,) + v.shape, dtype=v.dtype,
                                                 device=self.device)
                                  for k, v in one.items()}}
        cache["lengths"] = torch.zeros(batch, dtype=torch.int32, device=self.device)
        return cache

    @torch.no_grad()
    def prefill(self, params: dict, batch: dict, cache_len: int | None = None,
                lengths: torch.Tensor | None = None, tiles: tuple[int, int] = (0, 0)):
        """``batch["tokens"]`` [B, S] -> (last-token logits [B, V], cache).
        ``lengths`` [B] marks per-row true lengths of a right-padded batch
        (exact for causal attention: pad rows never feed real rows; an SSM
        state takes in the pad rows, so an SSM batch must be of one length,
        as the engine's per-length groups are); ``tiles`` fixes the flash
        tiles (``A.chunked_attention``'s ``q_chunk``, ``kv_chunk``; 0 for
        the defaults)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        cache = self.init_cache(B, cache_len or S)
        x = embed_tokens(params["embed"], tokens)
        for name, spec, _ in self.groups:
            stack = params[name]["L0"]
            for i in range(n_stacked(stack)):
                x = apply_layer_prefill(layer_view(stack, i), x,
                                        layer_view(cache[name]["L0"], i), cfg, spec, tiles)
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        logits = last_token_logits(params["embed"], x, lengths)
        cache["lengths"] = (torch.full((B,), S, dtype=torch.int32, device=tokens.device)
                            if lengths is None else lengths.to(torch.int32))
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict):
        """tokens [B, 1] -> (logits [B, V], cache with lengths + 1); the
        layers' caches (K/V rows, SSM state) are written in place."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens)
        lengths = cache["lengths"]
        for name, spec, _ in self.groups:
            stack = params[name]["L0"]
            for i in range(n_stacked(stack)):
                x = apply_layer_decode(layer_view(stack, i), x,
                                       layer_view(cache[name]["L0"], i), lengths, cfg, spec)
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        logits = lm_logits(params["embed"], x)[:, 0]
        return logits, {**cache, "lengths": lengths + 1}

    def init_paged_cache(self, batch: int, cache_len: int, *, block_size: int,
                         num_blocks: int) -> dict:
        """Paged decode cache: each leaf of ``init_layer_cache_paged`` stacked
        on a leading layer axis under ``<group>/L0`` for each of ``groups``
        (attention layers' block pools ``pk`` / ``pv`` ``[n, num_blocks + 1,
        block_size, Kv, hd]``, the last block the trash sink; a Mamba layer's
        per-slot state), per-slot ``lengths``, and the allocator state of
        ``engine/paged.py`` (one table of ``ceil(cache_len / block_size)``
        entries per slot, shared by every attention layer).  A
        sliding-window stack pages the ring: ``cache_len`` must cover the
        window and ``block_size`` divide it (ring rows ``pos % window``
        would straddle the block grid otherwise), and the table has
        ``window / block_size`` entries."""
        from repro_torch.engine.paged import blocks_for, init_block_state
        window = self.cfg.sliding_window
        if window:
            if cache_len < window:
                raise ValueError(f"paged SWA cache needs cache_len >= sliding_window "
                                 f"({cache_len} < {window})")
            if window % block_size:
                raise ValueError(f"block_size {block_size} must divide the sliding window "
                                 f"{window} (ring positions are block-mapped)")
            mb = window // block_size
        else:
            mb = blocks_for(cache_len, block_size)
        cache = {}
        for name, spec, n in self.groups:
            one = init_layer_cache_paged(self.cfg, spec, batch, num_blocks, block_size,
                                         self.device)
            cache[name] = {"L0": {k: torch.zeros((n,) + v.shape, dtype=v.dtype,
                                                 device=self.device)
                                  for k, v in one.items()}}
            del one
        cache["lengths"] = torch.zeros(batch, dtype=torch.int32, device=self.device)
        cache.update(init_block_state(batch, mb, num_blocks, self.device))
        return cache

    def _ring(self, cache: dict) -> bool:
        """Whether the paged table spans exactly the sliding window: the
        ring layout (position ``p`` at table row ``p % window``)."""
        bs = cache["stack"]["L0"]["pk"].shape[2]
        return bool(self.cfg.sliding_window) \
            and cache["tbl"].shape[1] * bs == self.cfg.sliding_window

    def _run_paged(self, layer_fn, params: dict, x, cache: dict, pctx: dict):
        """``x`` through every group's layers in order (the dense prefix
        first), each with its views of the params and of the paged cache."""
        for name, spec, _ in self.groups:
            stack, leaves = params[name]["L0"], cache[name]["L0"]
            for i in range(n_stacked(stack)):
                x = layer_fn(layer_view(stack, i), x, layer_view(leaves, i), pctx, self.cfg,
                             spec)
        return x

    def _span_ctx(self, cache: dict, start, valid, width: int, shared_until=None) -> dict:
        """The chunk forwards' context: ``start`` / ``valid``, and for a stack
        with attention the block table and the span's write targets
        (``span_targets``), shared by every attention layer."""
        from repro_torch.engine.paged import BSTATE_KEYS, span_targets
        pctx = {"start": start, "valid": valid}
        if self.spec[0] == "attn":
            bs = cache["stack"]["L0"]["pk"].shape[2]
            wblk, woff = span_targets({k: cache[k] for k in BSTATE_KEYS}, start, valid, width,
                                      bs, cache["tbl"].shape[1] * bs, self._ring(cache),
                                      shared_until)
            pctx.update(tbl=cache["tbl"], wblk=wblk.long(), woff=woff.long())
        return pctx

    @torch.no_grad()
    def decode_step_paged(self, params: dict, tokens: torch.Tensor, cache: dict,
                          cow: bool = False):
        """tokens [B, 1] -> (logits [B, V], paged cache with lengths + 1).
        For a stack with attention the step's block allocation and write
        targets (``alloc_step``) are computed once and shared by every
        attention layer; the pools are written in place, the allocator state
        is returned new.  With ``cow=True`` (prefix caching) a write landing
        in a shared block pops a private copy first, and each layer copies
        the block's rows into it.  A pure-SSM stack has no pools to manage:
        its layers step each ``slot_active`` slot's state (``keep``), as the
        attention layers write only those slots' rows."""
        from repro_torch.engine.paged import BSTATE_KEYS, alloc_step
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens)
        lengths = cache["lengths"]
        pctx = {"lengths": lengths, "keep": cache["slot_active"]}
        new = {}
        if self.spec[0] == "attn":
            bs = cache["stack"]["L0"]["pk"].shape[2]
            new, wblk, woff, cow_src = alloc_step({k: cache[k] for k in BSTATE_KEYS}, lengths,
                                                  bs, cache["tbl"].shape[1] * bs,
                                                  ring=self._ring(cache), cow=cow)
            pctx.update(tbl=new["tbl"], wblk=wblk.long(), woff=woff.long())
            if cow:
                pctx["cow_src"] = cow_src.long()
        x = self._run_paged(apply_layer_decode_paged, params, x, cache, pctx)
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        logits = lm_logits(params["embed"], x)[:, 0]
        return logits, {**cache, **new, "lengths": lengths + 1}

    @torch.no_grad()
    def prefill_chunk_paged(self, params: dict, tokens: torch.Tensor, cache: dict,
                            start: torch.Tensor, valid: torch.Tensor, shared_until=None,
                            tiles: tuple[int, int] = (0, 0)):
        """One prefill chunk through the paged cache (chunked prefill, or the
        recomputed tail of a prefix hit).  ``tokens`` [B, C] are rows
        ``start[b] .. start[b] + valid[b] - 1`` of each slot's prompt
        (``valid[b] == 0`` leaves the slot as it was); ``shared_until`` [B]
        is each slot's prefix-hit watermark (rows below it lie in shared
        blocks and are not written: the cached rows hold the same values);
        ``tiles`` are the flash tiles, as in :meth:`prefill`.  Returns the
        logits of each slot's last valid row (garbage where ``valid == 0``)
        and the cache with the chunk's K/V and each Mamba layer's state
        written in place and ``lengths`` advanced to ``start + valid``."""
        cfg = self.cfg
        B, C = tokens.shape
        x = embed_tokens(params["embed"], tokens)
        start, valid = start.to(torch.int32), valid.to(torch.int32)
        pctx = {**self._span_ctx(cache, start, valid, C, shared_until),
                "q_chunk": tiles[0], "kv_chunk": tiles[1]}
        x = self._run_paged(apply_layer_prefill_paged, params, x, cache, pctx)
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        idx = (valid - 1).clamp(0, C - 1).long()
        xg = x[torch.arange(B, device=x.device), idx][:, None]
        logits = lm_logits(params["embed"], xg)[:, 0]
        return logits, {**cache, "lengths": torch.where(valid > 0, start + valid,
                                                         cache["lengths"])}

    @torch.no_grad()
    def verify_chunk_paged(self, params: dict, tokens: torch.Tensor, cache: dict,
                           start: torch.Tensor, valid: torch.Tensor):
        """Speculative-verify forward: ``tokens`` [B, C] are rows ``start[b]
        .. start[b] + valid[b] - 1`` of each slot's continuation.  Returns
        the logits of every row [B, C, V] and the cache with the rows' K/V
        written and each Mamba layer's state advanced by ``valid[b]`` steps,
        in place, and ``lengths`` at ``start + valid``.  Row ``j``'s logits
        are what ``decode_step_paged`` gives after consuming rows ``< j``
        (attention runs the decode softmax over the gathered table, a Mamba
        layer the decode recurrence; on the CPU bit for bit at the tests'
        widths, PERF.md decision a), which makes greedy speculative decoding
        token-exact against the non-speculative engine (``engine/spec.py``).
        ``valid[b] == 0`` leaves the slot as it was; rows at or past
        ``valid[b]`` write nothing and give garbage logits."""
        cfg = self.cfg
        B, C = tokens.shape
        x = embed_tokens(params["embed"], tokens)
        start, valid = start.to(torch.int32), valid.to(torch.int32)
        x = self._run_paged(apply_layer_verify_paged, params, x, cache,
                            self._span_ctx(cache, start, valid, C))
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        logits = lm_logits(params["embed"], x)
        return logits, {**cache, "lengths": torch.where(valid > 0, start + valid,
                                                         cache["lengths"])}


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)

