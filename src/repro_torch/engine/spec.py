"""Self-speculative decoding: the quantized tree drafts, the full-precision
tree verifies, inside one K-round dispatch composed with chunked prefill
and refcounted prefix caching.

Port of ``repro/engine/spec.py`` for the dense, MoE and SSM families,
sliding windows included.  The
quantized tree (DAQ, AbsMax, ...) drafts up to ``n_spec`` tokens a round,
one verify forward of the full-precision tree scores them all, and a
prefix is accepted.  The **draft acceptance rate** is then a data-free, token-level
measure of how much of the post-trained behaviour a quantizer kept, and
every accepted draft is a decode step the verifier did not run alone.

One round (one of the dispatch's K steps) runs, in order:

1. **span allocation and copy-on-write** — ``paged.alloc_span`` pops the
   blocks of the round's write span ``[len, len + n_spec + 1)`` once, and
   with prefix caching a shared first block is copied
   (``lm.cow_copy_blocks``) before any write lands.  A slot whose copy
   could not be popped (pool dry; the reservation ledger makes that
   unreachable) sits the round out (``blocked``) and retries the next.
2. **draft** — ``n_spec`` ``decode_step_paged`` calls with the quantized
   tree.  The port writes the cache in place where the reference drafts on
   a working copy; for the attention pools that changes nothing: the draft
   reads the verifier's rows for all history, its writes land in the span
   the verify overwrites row for row, and rows past the accepted length
   are masked by every later read.  Slots outside their decode phase are
   not ``slot_active``, so their draft writes go to the trash block and a
   Mamba layer leaves their state as it was.
3. **verify** — one ``model.verify_chunk_paged`` forward of the
   full-precision tree over ``[cur, d_1 .. d_n]``: each row the decode step
   the non-speculative engine would run there (on the CPU bit for bit,
   ``PERF.md`` decision a).  An MoE layer routes it at full capacity, which
   equals the decode's routing only where that drops nothing: the engine
   takes a speculative MoE serve only at a dropless ``capacity_factor``.
4. **accept** — greedy: the longest prefix with ``argmax(p_i) == d_i``,
   then the verifier's own argmax.  Sampled: rejection sampling over the
   warped distributions, the tail drawn by Gumbel-argmax.  Both rules take
   the runtime ``depth`` (1..n_spec): positions at or past it count as
   never proposed, so a depth-d round is a static ``n_spec = d`` round.
5. **commit and rollback** — ``lengths`` advances by the emitted count;
   rejected rows stay in the pools, masked by every later read and
   overwritten by later writes, their blocks kept for the slot to grow
   into.  A recurrent state cannot be rewound by a mask, and neither can
   a sliding-window ring: a row written at position ``p`` evicts position
   ``p - window``, which later rows still read.  So a stack with Mamba
   layers or a ring runs two passes, as the reference does: the round
   snapshots the per-slot SSM leaves and the ring rows of its span (``[len,
   len + n_spec + 1)`` modulo the window, in every attention layer) before
   the draft and puts them back before the verify, and after acceptance
   puts them back again and runs the verify a second time with ``valid`` =
   the emitted count, which leaves each slot's state and ring after
   exactly its accepted rows.  The reference keeps the pre-round cache as
   a value; the snapshot is its in-place counterpart (device copies, no
   host sync).
6. **emit** — ``min(accepted + 1, remaining)`` tokens (the budget clamp;
   a clamped-away token lies past the request's end).
7. **release** the blocks of slots whose budget drained, inside the round.
8. **chunked prefill** (``chunk > 0``) — ``scheduler.chunk_prefill_substep``
   as in the plain dispatch; a slot whose last chunk lands emits its first
   token through column 0 of the round's grid (it did not speculate that
   round) and speculates from the next.

Hybrid stacks are not ported: ``Model`` raises for them (ROADMAP Queue
A 5).

Guarantee: greedy speculative output equals the non-speculative paged
engine's token for token for any draft and any depth trajectory, as far as
the verify mirrors decode (on the CPU at the tests' widths; on the card,
``PERF.md`` decision b).  The counters report the raw verifier-agreement
prefix against the depth drafted, not the clamped emission.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.engine.paged import BSTATE_KEYS, alloc_span, release_slots, span_targets
from repro_torch.engine.sampler import SamplingParams, gumbel_argmax, probs, sample
from repro_torch.engine.scheduler import chunk_prefill_substep
from repro_torch.models.lm import cow_copy_blocks
from repro_torch.telemetry.counters import bump

_I32 = torch.int32


# ---------------------------------------------------------------------------
# Acceptance rules
# ---------------------------------------------------------------------------

def _live(n: int, depth, device) -> torch.Tensor:
    """[1 | B, n] mask of the positions below ``depth`` (an int, a scalar
    tensor or one depth per slot)."""
    pos = torch.arange(n, device=device)[None, :]
    return pos < (depth if isinstance(depth, int) else depth.reshape(-1, 1))


def _set_at(drafts: torch.Tensor, a: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """``[drafts, 0]`` with column ``a[b]`` of row ``b`` set to ``tok[b]``."""
    out = torch.cat([drafts, drafts.new_zeros((drafts.shape[0], 1))], dim=1)
    return out.scatter(1, a[:, None].long(), tok[:, None].to(out.dtype))


def greedy_accept(drafts: torch.Tensor, p_logits: torch.Tensor, depth=None):
    """Greedy prefix acceptance.

    ``drafts`` [B, n] proposed tokens (int32); ``p_logits`` [B, n+1, V]
    verifier logits (row ``i`` scores proposal ``i``, row ``n`` is the
    bonus position).  Returns ``(out [B, n+1], n_acc [B])``: rows ``<
    n_acc`` of ``out`` are the accepted drafts, row ``n_acc`` the
    verifier's argmax (the correction after a mismatch, or the bonus);
    later rows are don't-care.  ``depth`` (an int, a scalar tensor or [B])
    caps the accepted prefix: positions at or past it count as mismatches."""
    n = p_logits.shape[1] - 1
    tgt = torch.argmax(p_logits, dim=-1).to(_I32)                # [B, n+1]
    match = tgt[:, :n] == drafts
    if depth is not None:
        match = match & _live(n, depth, drafts.device)
    a = torch.cumprod(match.to(_I32), dim=1).sum(dim=1, dtype=_I32)  # [B] 0..n
    return _set_at(drafts, a, torch.gather(tgt, 1, a[:, None].long())[:, 0]), a


def rejection_accept(gen, drafts: torch.Tensor, q_logits: torch.Tensor,
                     p_logits: torch.Tensor, sp: SamplingParams, depth=None):
    """Lossless speculative rejection sampling (Leviathan et al.) over the
    warped draft / target distributions.

    ``drafts`` [B, n] were sampled from ``probs(q_logits, sp)``; draft ``i``
    is accepted with probability ``min(1, p_i(d_i) / q_i(d_i))``, the first
    rejection is resampled from ``norm(max(p_i - q_i, 0))``, and the
    all-accepted case draws the bonus from ``p_{n+1}`` (the same formula
    with ``q := 0``); the emitted distribution is plain sampling from the
    warped target.  ``depth`` rejects positions at or past it and zeroes
    their ``q``, so a cut-off position resamples from ``p``: a depth-d round
    is a static ``n_spec = d`` round.  Draws come from ``gen`` (uniforms,
    then a Gumbel-argmax for the tail).  Returns ``(out [B, n+1], n_acc
    [B])`` as :func:`greedy_accept`."""
    B, n1, V = p_logits.shape
    n = n1 - 1
    qp = probs(q_logits, sp)                                     # [B, n, V]
    pp = probs(p_logits, sp)                                     # [B, n+1, V]
    d = drafts[..., None].long()
    pd = torch.gather(pp[:, :n], 2, d)[..., 0]
    qd = torch.gather(qp, 2, d)[..., 0]
    u = torch.rand((B, n), generator=gen, device=drafts.device)
    accept = u * qd < pd                                         # P = min(1, p/q)
    if depth is not None:
        live = _live(n, depth, drafts.device)
        accept = accept & live
        qp = qp * live[..., None].to(qp.dtype)
    a = torch.cumprod(accept.to(_I32), dim=1).sum(dim=1, dtype=_I32)
    at = a[:, None, None].long().expand(B, 1, V)
    pa = torch.gather(pp, 1, at)[:, 0]
    qa = torch.gather(torch.cat([qp, qp.new_zeros((B, 1, V))], dim=1), 1, at)[:, 0]
    r = (pa - qa).clamp_min(0.0)
    z = r.sum(dim=-1, keepdim=True)
    r = torch.where(z > 0, r / z, pa)                            # p == q: use p
    tail = gumbel_argmax(torch.log(r.clamp_min(1e-38)), gen)
    return _set_at(drafts, a, tail), a


# ---------------------------------------------------------------------------
# Dynamic speculation depth (host policy)
# ---------------------------------------------------------------------------

@dataclass
class DepthController:
    """AIMD controller for the speculative draft depth (the reference's,
    copied).

    The engine feeds it each dispatch's ``(drafted, accepted)`` counter
    deltas; :meth:`update` moves ``depth`` between 1 and ``n_max``: one up
    after ``patience`` consecutive dispatches at acceptance rate >= ``hi``,
    halved the moment the rate drops below ``lo``; rates in between hold
    the depth and reset the streak.  The depth is a runtime operand of the
    dispatch (the grids stay sized for ``n_max``)."""
    n_max: int
    lo: float = 0.45
    hi: float = 0.75
    patience: int = 2
    depth: int = 0          # 0 -> start at n_max (set in __post_init__)
    streak: int = 0

    def __post_init__(self):
        if self.n_max < 1:
            raise ValueError(f"n_max must be >= 1, got {self.n_max}")
        if not self.depth:
            self.depth = self.n_max
        self.depth = max(1, min(self.depth, self.n_max))

    def update(self, drafted: int, accepted: int) -> int:
        """Fold one dispatch's counters in; returns the depth for the next
        dispatch.  A dispatch that drafted nothing (every slot prefilling)
        is no evidence: depth and streak stay."""
        if drafted <= 0:
            return self.depth
        rate = accepted / drafted
        if rate >= self.hi:
            self.streak += 1
            if self.streak >= self.patience:
                self.depth = min(self.n_max, self.depth + 1)
                self.streak = 0
        elif rate < self.lo:
            self.depth = max(1, self.depth // 2)
            self.streak = 0
        else:
            self.streak = 0
        return self.depth


# ---------------------------------------------------------------------------
# The K-round speculative dispatch
# ---------------------------------------------------------------------------

def make_spec_dispatch(model, sp: SamplingParams, k_steps: int, n_spec: int, *,
                       cow: bool = False, chunk: int = 0, tiles=(0, 0)):
    """Build the K-round speculative dispatch.

    ``dispatch(params, draft_params, state, cache, depth, gen)`` ->
    ``(state, cache, tokens [B, K*(n_spec+1)], emitted [B, K*(n_spec+1)])``;
    ``emitted[b]`` marks the tokens slot ``b`` produced (a prefix of each
    round's ``n_spec + 1`` columns, rounds in order), so the host appends
    ``tokens[b, emitted[b]]`` as it does the plain dispatch's grid.
    ``depth`` is a device int32 scalar (``torch.full``; clamped to
    1..n_spec on the device).  A round bumps the counters (drafted,
    accepted, rejected, copies, blocked retries, pops, releases), which the
    host reads in the transfer that drains the grid.  ``cow=True`` composes
    with prefix caching (the span's shared first block is copied);
    ``chunk > 0`` appends the chunked-prefill piece to every round, at the
    flash ``tiles``.  The state is the plain dispatch's (with the prefill
    fields when chunked).  Like the plain dispatch it is a Python loop of
    device work with no host sync.

    A stack with Mamba layers or a sliding-window ring runs the two-pass
    round (step 5 of the module docstring)."""
    two_pass = model.spec[0] == "mamba" or bool(model.cfg.sliding_window)
    paged_kv = model.spec[0] == "attn"
    S1 = n_spec + 1

    def snapshot(cache, lengths, ring: bool) -> list:
        """What a two-pass round puts back: every per-slot leaf (a Mamba
        layer's state) whole, and for a ring each attention pool's rows at
        the round's span targets."""
        saved = [(leaf, None, leaf.clone()) for grp, _, _ in model.groups
                 for name, leaf in cache[grp]["L0"].items() if name not in ("pk", "pv")]
        if ring:
            bs = cache["stack"]["L0"]["pk"].shape[2]
            wblk, woff = span_targets({k: cache[k] for k in BSTATE_KEYS}, lengths,
                                      torch.full_like(lengths, S1), S1, bs,
                                      cache["tbl"].shape[1] * bs, True)
            at = (wblk.long(), woff.long())
            saved += [(pool, at, pool[:, at[0], at[1]]) for grp, _, _ in model.groups
                      for name, pool in cache[grp]["L0"].items() if name in ("pk", "pv")]
        return saved

    def restore(saved) -> None:
        for leaf, at, old in saved:
            if at is None:
                leaf.copy_(old)
            else:
                leaf[:, at[0], at[1]] = old

    @torch.no_grad()
    def dispatch(params, draft_params, state: dict, cache: dict, depth: torch.Tensor, gen):
        B = state["cur"].shape[0]
        dev = state["cur"].device
        depth = depth.clamp(1, n_spec)
        cols = torch.arange(S1, device=dev)[None, :]
        toks = torch.empty((B, k_steps, S1), dtype=_I32, device=dev)
        emitted = torch.empty((B, k_steps, S1), dtype=torch.bool, device=dev)
        ring = False
        if paged_kv:
            bs = cache["stack"]["L0"]["pk"].shape[2]
            cap = cache["tbl"].shape[1] * bs
            ring = model._ring(cache)
        st = state
        for r in range(k_steps):
            ctr, active, lengths = st["ctr"], st["active"], cache["lengths"]
            nf0 = cache["n_free"]              # the round's pops, by free-stack delta
            # ---- 1. span allocation and copy-on-write (a pure-SSM stack
            # has no pools: nothing to allocate, no slot blocked) ----
            blocked = torch.zeros_like(active)
            if paged_kv:
                bstate, cow_src, cow_dst, blocked = alloc_span(
                    {k: cache[k] for k in BSTATE_KEYS}, lengths, S1, bs, cap, ring, cow=cow)
                cache = {**cache, **bstate}
                if cow:
                    cache = cow_copy_blocks(cache, cow_src, cow_dst)
                    ctr = bump(ctr, cow_copies=(cow_src != cow_dst).sum(dtype=_I32))
            active_r = active & ~blocked
            sa = cache["slot_active"]
            if two_pass:    # the pre-round state and ring rows, which the draft overwrites
                saved = snapshot(cache, lengths, ring)
            # ---- 2. draft (quantized tree) ----
            dcache, cur = {**cache, "slot_active": sa & ~blocked}, st["cur"]
            drafts, dlogits = [], []
            for _ in range(n_spec):
                logits, dcache = model.decode_step_paged(draft_params, cur, dcache)
                nxt = sample(logits, gen, sp)
                drafts.append(nxt)
                dlogits.append(logits)
                cur = nxt[:, None]
            drafts = torch.stack(drafts, dim=1)                      # [B, n]
            # ---- 3. verify (full-precision tree, one forward) ----
            if two_pass:
                restore(saved)
            vtoks = torch.cat([st["cur"], drafts], dim=1)
            v_logits, cache = model.verify_chunk_paged(
                params, vtoks, {**dcache, "lengths": lengths, "slot_active": sa}, lengths,
                torch.where(active_r, S1, 0))
            # ---- 4. accept ----
            if sp.greedy:
                out, a = greedy_accept(drafts, v_logits, depth)
            else:
                out, a = rejection_accept(gen, drafts, torch.stack(dlogits, dim=1), v_logits,
                                          sp, depth)
            m = torch.where(active_r, torch.minimum(a + 1, st["remaining"]), 0)
            # ---- 5. commit and rollback (two-pass: the accepted rows again
            # from the pre-round state) ----
            if two_pass:
                restore(saved)
                _, cache = model.verify_chunk_paged(params, vtoks, {**cache, "lengths": lengths},
                                                    lengths, m)
                del saved
            cache = {**cache, "lengths": torch.where(active_r, lengths + m, lengths)}
            # ---- 6. emit within the budget ----
            em = active_r[:, None] & (cols < m[:, None])
            cur = torch.gather(out, 1, (m - 1).clamp(min=0)[:, None].long())
            cur = torch.where(active_r[:, None], cur, st["cur"])
            remaining = st["remaining"] - m
            new_active = active & (remaining > 0)
            # ---- 7. release drained slots' blocks ----
            nf1 = cache["n_free"]
            cache = {**cache, **release_slots({k: cache[k] for k in BSTATE_KEYS},
                                              active & ~new_active)}
            drafted = torch.where(active_r, depth, 0).sum(dtype=_I32)
            accepted = torch.where(active_r, a, 0).sum(dtype=_I32)
            ctr = bump(ctr, tokens=m.sum(dtype=_I32), drafted=drafted, accepted=accepted,
                       rejected=drafted - accepted, blocked_retries=blocked.sum(dtype=_I32),
                       blocks_popped=nf0 - nf1, blocks_released=cache["n_free"] - nf1)
            st = {**st, "cur": cur, "active": new_active, "remaining": remaining, "ctr": ctr}
            # ---- 8. chunked-prefill piece ----
            if chunk:
                st, cache, first, completed = chunk_prefill_substep(
                    model, sp, chunk, params, st, cache, gen, tiles)
                # a slot completing its prefill did not speculate this
                # round: its first token goes in column 0
                hit = completed[:, None] & (cols == 0)
                out = torch.where(hit, first[:, None], out)
                em = em | hit
            toks[:, r] = out
            emitted[:, r] = em
        return st, cache, toks.reshape(B, k_steps * S1), emitted.reshape(B, k_steps * S1)

    return dispatch
