"""Paged KV cache: global block pool, per-slot block tables, a device free
list and refcounts (prefix sharing, copy-on-write).

Port of ``repro/engine/paged.py``.  The contiguous cache reserves ``cache_len`` rows per slot per layer; the
paged cache replaces them with a **global pool of fixed-size token blocks**
shared by all slots:

* per layer, ``pk`` / ``pv`` pools ``[num_blocks + 1, block_size, Kv, hd]``
  (stacked over layers by ``models/lm.py``); the extra last block is a
  **trash sink** for the writes of inactive slots and of positions past
  capacity;
* one **block table** ``tbl [slots, max_blocks]`` shared by every layer (the
  stack advances in lockstep); ``-1`` marks an unallocated entry and, as a
  negative index wraps in ``pool[tbl]``, gathers the trash block, whose rows
  the length mask discards;
* a **free stack** ``free [num_blocks]`` of block ids with a scalar stack
  pointer ``n_free``: blocks are popped inside the decode step the moment a
  slot's length crosses a block boundary and pushed back inside the K-step
  dispatch the moment a slot's budget drains, with no host round trip;
* a **refcount** ``ref [num_blocks]``: one per table entry referencing the
  block, plus one while the host prefix index (``engine/prefix.py``) holds
  it as a cached prompt block.  A prefix hit maps an existing block into a
  new slot's table with ``ref += 1``; every release path decrements, and a
  block returns to the free stack only at zero.  Conservation:
  ``n_free + |{b : ref[b] > 0}| == num_blocks``.

**Copy-on-write**: a slot appends rows only to a block it owns alone.  A
decode write landing in a block with ``ref > 1`` (a partly filled prompt
block shared through the prefix cache) makes ``alloc_step(cow=True)`` pop a
fresh block, rewire the entry, drop one reference on the shared block and
report it as ``cow_src``, so the layer copies its rows before appending.
Prefill-chunk writes never copy: a recomputed row whose block is shared is
dropped (``span_targets``), as the cached row already holds its value.  A
speculative round allocates its whole write span once (``alloc_span``),
copying a shared first block the same way.

Every function here is shape-static device code with no host sync: no
``.item()``, no boolean-mask indexing, no tensor-valued ``if``.  The
state's integer tensors keep the reference's dtypes (int32, ``cumsum`` and
``sum`` are cast back).  The reference's scatters drop an out-of-range index
(``mode="drop"``); a torch scatter would raise on the CPU and assert on the
card, so each such scatter here goes into a copy one entry longer whose last
entry is the sink and is cut off after (``_scatter_drop``).
"""
from __future__ import annotations

import torch

NEG = -1  # unallocated table entry; wraps to the trash block on gather

# allocator-state keys riding at the top level of a paged cache
BSTATE_KEYS = ("tbl", "free", "n_free", "ref", "slot_active")

_I32 = torch.int32


def init_block_state(slots: int, max_blocks: int, num_blocks: int, device) -> dict:
    """Zeroed allocator state: empty tables, fully-free stack, zero refs."""
    return {
        "tbl": torch.full((slots, max_blocks), NEG, dtype=_I32, device=device),
        "free": torch.arange(num_blocks, dtype=_I32, device=device),
        "n_free": torch.tensor(num_blocks, dtype=_I32, device=device),
        "ref": torch.zeros(num_blocks, dtype=_I32, device=device),
        "slot_active": torch.zeros(slots, dtype=torch.bool, device=device),
    }


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache rows."""
    return -(-n_tokens // block_size)


def _scatter_drop(dst: torch.Tensor, idx: torch.Tensor, val, *,
                  add: bool = False) -> torch.Tensor:
    """``dst`` with ``dst[idx] = val`` (``+= val`` with ``add``, which adds
    duplicates), where ``idx == len(dst)`` is dropped, as the reference's
    ``.at[idx].set/add(val, mode="drop")`` drops it.  ``val`` is a Python
    number or a tensor like ``idx``; a number goes to the device as a kernel
    argument (``index_fill_``) or a fill, never as a host-to-device copy,
    which would synchronize."""
    ext = torch.cat([dst, dst.new_zeros(1)])
    idx = idx.long()
    if add:
        ext.index_add_(0, idx, torch.full(idx.shape, val, dtype=dst.dtype, device=dst.device))
    elif isinstance(val, torch.Tensor):
        ext.index_copy_(0, idx, val)
    else:
        ext.index_fill_(0, idx, val)
    return ext[:-1]


def _cumsum(mask: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(mask.to(_I32), 0, dtype=_I32)


def _free_newly_zero(free, n_free, ref_old, ref_new):
    """Push blocks whose refcount just reached zero back on the free stack
    (ascending block-id order, deterministic)."""
    NB = free.shape[0]
    hit = (ref_old > 0) & (ref_new == 0)
    rank = _cumsum(hit)                                   # 1-based push rank
    dest = torch.where(hit, n_free + rank - 1, NB)        # NB -> dropped
    free = _scatter_drop(free, dest, torch.arange(NB, dtype=_I32, device=free.device))
    return free, n_free + hit.sum(dtype=_I32)


# ---------------------------------------------------------------------------
# Decode-time allocation / release (no host sync; called inside the dispatch)
# ---------------------------------------------------------------------------

def alloc_step(bstate: dict, lengths: torch.Tensor, block_size: int, cap: int,
               ring: bool, cow: bool = False):
    """One decode step's allocation and write routing.

    Pops a fresh block for every active slot whose write position lands in
    an unallocated table entry (one write per slot per step, so at most one
    block per slot); pool exhaustion leaves the entry unallocated and the
    write lands in the trash block instead.  With ``cow=True`` a write
    position landing in a block with ``ref > 1`` (shared) also pops a fresh
    block: the entry is rewired to it, the shared block loses one reference,
    and its id is reported as ``cow_src`` so the layer write can copy its
    rows first (``cow_src == wblk`` marks "no copy").

    Returns ``(bstate, wblk [B], woff [B], cow_src [B])``.  ``cap`` is the
    per-slot capacity (``max_blocks * block_size``); ``ring`` maps positions
    modulo ``cap`` (SWA rings).  Inactive slots and positions beyond
    capacity are routed to the trash block."""
    tbl, free, n_free, ref = bstate["tbl"], bstate["free"], bstate["n_free"], bstate["ref"]
    B, MB = tbl.shape
    trash = free.shape[0]                       # pool index num_blocks
    dev = tbl.device
    pos = lengths % cap if ring else lengths
    valid = bstate["slot_active"] & (pos < cap)
    j = torch.clamp(pos // block_size, 0, MB - 1).long()
    bidx = torch.arange(B, device=dev)
    cur = tbl[bidx, j]
    have = cur >= 0
    if cow:
        shared = valid & have & (ref[torch.clamp(cur, 0, trash - 1).long()] > 1)
    else:
        shared = torch.zeros(B, dtype=torch.bool, device=dev)
    need = valid & (~have | shared)
    k = _cumsum(need)                           # 1-based pop rank per slot
    ok = need & (k <= n_free)
    ids = free[torch.clamp(n_free - k, 0, trash - 1).long()]
    blk = torch.where(ok, ids, cur)
    tbl = tbl.index_put((bidx, j), blk)
    ref = _scatter_drop(ref, torch.where(ok, ids, trash), 1)
    # a successful CoW pop releases one reference on the shared source
    dec = shared & ok
    ref = _scatter_drop(ref, torch.where(dec, cur, trash), -1, add=True)
    n_free = n_free - ok.sum(dtype=_I32)
    # a shared target whose CoW pop failed (pool dry) must not be written
    writable = valid & (blk >= 0) & ~(shared & ~ok)
    wblk = torch.where(writable, blk, trash)
    woff = pos % block_size
    cow_src = torch.where(dec, cur, wblk)
    return {**bstate, "tbl": tbl, "ref": ref, "n_free": n_free}, wblk, woff, cow_src


def alloc_span(bstate: dict, lengths: torch.Tensor, width: int, block_size: int, cap: int,
               ring: bool, cow: bool = False):
    """One speculative round's allocation: make each active slot's table
    cover rows ``[lengths[b], lengths[b] + width)``, the round's write span
    (the draft writes ``width - 1`` rows past the length and the verify one
    more), so no write inside the round pops a block.

    With ``cow=True`` the span's first entry (the block holding row
    ``lengths[b]``) may be a partly filled prompt block shared through the
    prefix cache (``ref > 1``); only that entry can be shared, as shared
    blocks enter a table at admission and cover prompt rows ``< lengths``.
    It gets ``alloc_step``'s treatment: a private block is popped, the entry
    rewired, one reference dropped on the source, and the pair reported for
    the round to copy (``models/lm.py::cow_copy_blocks``) before any write.
    Two slots sharing one block may both copy it in one round, so the
    decrement adds duplicates (``index_add_``).

    Rows at or past ``cap`` need no block.  Ring tables are allocated whole
    at admission: the ring case pops and copies nothing.  A dry pool leaves
    entries unallocated (their writes go to the trash block); the engine's
    reservation ledger counts the span into each request's worst case, so
    that path is not reached in normal operation.  Blocks stay in the table
    after a rejection rolls the length back; the slot grows into them.

    Returns ``(bstate, cow_src [B], cow_dst [B], blocked [B])``:
    ``cow_src != cow_dst`` marks a slot whose first span block is copied
    ``src -> dst`` (both the trash index where nothing is copied);
    ``blocked`` marks a slot whose shared first block could not be copied
    (pool dry): its table still points at the shared block, so the round
    must leave the slot out."""
    tbl, free, n_free, ref = bstate["tbl"], bstate["free"], bstate["n_free"], bstate["ref"]
    B, MB = tbl.shape
    trash = free.shape[0]
    dev = tbl.device
    no_copy = torch.full((B,), trash, dtype=_I32, device=dev)
    if ring:
        return bstate, no_copy, no_copy, torch.zeros(B, dtype=torch.bool, device=dev)
    nbl = width // block_size + 2                 # entries a span can straddle
    jj = torch.arange(nbl, dtype=_I32, device=dev)[None, :]
    j = lengths[:, None] // block_size + jj       # candidate entries [B, nbl]
    in_span = (j * block_size < (lengths[:, None] + width).clamp(max=cap)) & (j < MB)
    cur = torch.gather(tbl, 1, j.clamp(0, MB - 1).long())
    live = bstate["slot_active"][:, None] & in_span
    if cow:
        shared = live & (jj == 0) & (cur >= 0) & (ref[cur.clamp(0, trash - 1).long()] > 1)
    else:
        shared = torch.zeros((B, nbl), dtype=torch.bool, device=dev)
    need = live & ((cur < 0) | shared)
    k = _cumsum(need.reshape(-1)).reshape(B, nbl)  # 1-based pop rank
    ok = need & (k <= n_free)
    ids = free[(n_free - k).clamp(0, trash - 1).long()]
    new_rows = torch.where(ok, ids, cur)
    # a row's candidate entries are distinct; those past the table go to a
    # sink column that is cut off after, as the reference's scatter drops them
    ext = torch.cat([tbl, tbl.new_full((B, 1), NEG)], 1)
    tbl = ext.scatter(1, torch.where(j < MB, j, MB).long(),
                      torch.where(in_span, new_rows, cur))[:, :MB]
    ref = _scatter_drop(ref, torch.where(ok, ids, trash).reshape(-1), 1)
    # a successful CoW pop releases one reference on the shared source
    dec = shared & ok
    ref = _scatter_drop(ref, torch.where(dec, cur, trash).reshape(-1), -1, add=True)
    n_free = n_free - ok.sum(dtype=_I32)
    cow_src = torch.where(dec[:, 0], cur[:, 0], no_copy)
    cow_dst = torch.where(dec[:, 0], new_rows[:, 0], no_copy)
    blocked = shared[:, 0] & ~ok[:, 0]
    return {**bstate, "tbl": tbl, "ref": ref, "n_free": n_free}, cow_src, cow_dst, blocked


def release_slots(bstate: dict, done: torch.Tensor) -> dict:
    """Drop one reference on every block of the ``done`` slots' tables, push
    the blocks whose refcount reaches zero back on the free stack, and clear
    the table rows and active flags.  Idempotent on slots owning nothing."""
    tbl, free, n_free, ref = bstate["tbl"], bstate["free"], bstate["n_free"], bstate["ref"]
    NB = free.shape[0]
    mask = done[:, None] & (tbl >= 0)
    ids = torch.where(mask, tbl, NB).reshape(-1)
    new_ref = _scatter_drop(ref, ids, -1, add=True)
    free, n_free = _free_newly_zero(free, n_free, ref, new_ref)
    tbl = torch.where(done[:, None], NEG, tbl)
    active = bstate["slot_active"] & ~done
    return {**bstate, "tbl": tbl, "free": free, "n_free": n_free, "ref": new_ref,
            "slot_active": active}


def release_refs(bstate: dict, ids: torch.Tensor) -> dict:
    """Drop one host hold per id in ``ids`` (``-1`` entries ignored) and free
    the blocks reaching refcount zero: the prefix cache's eviction and the
    duplicate-registration unwind.  Duplicate ids add up."""
    free, n_free, ref = bstate["free"], bstate["n_free"], bstate["ref"]
    NB = free.shape[0]
    new_ref = _scatter_drop(ref, torch.where(ids >= 0, ids, NB), -1, add=True)
    free, n_free = _free_newly_zero(free, n_free, ref, new_ref)
    return {**bstate, "free": free, "n_free": n_free, "ref": new_ref}


# ---------------------------------------------------------------------------
# Admission-time allocation (called from the engine)
# ---------------------------------------------------------------------------

def alloc_admit(bstate: dict, slots: torch.Tensor, counts: torch.Tensor, nbl: int):
    """Allocate ``counts[i]`` blocks for each admitted slot ``slots[i]``.

    Returns ``(bstate, wids [g, nbl])``: per-slot write-block ids padded
    with the trash index beyond ``counts[i]`` (the prefill scatter writes
    ``nbl`` block rows per slot; rows past a slot's need are pad and go to
    the trash).  The engine reserves capacity on the host, so the stack
    cannot underflow here."""
    tbl, free, n_free, ref = bstate["tbl"], bstate["free"], bstate["n_free"], bstate["ref"]
    trash = free.shape[0]
    dev = tbl.device
    offs = torch.cumsum(counts, 0, dtype=_I32)              # blocks consumed so far
    jj = torch.arange(nbl, dtype=_I32, device=dev)[None, :]
    pos = n_free - offs[:, None] + jj                       # stack index per (slot, j)
    take = jj < counts[:, None]
    ids = free[torch.clamp(pos, 0, trash - 1).long()]
    wids = torch.where(take, ids, trash)
    rows = torch.full((slots.shape[0], tbl.shape[1]), NEG, dtype=_I32, device=dev)
    rows[:, :nbl] = torch.where(take, ids, NEG)
    tbl = tbl.index_put((slots.long(),), rows)
    ref = _scatter_drop(ref, wids.reshape(-1), 1)
    n_free = n_free - counts.sum(dtype=_I32)
    active = bstate["slot_active"].clone().index_fill_(0, slots.long(), True)
    return {**bstate, "tbl": tbl, "ref": ref, "n_free": n_free, "slot_active": active}, wids


def admit_slot(bstate: dict, slot, shared_ids: torch.Tensor, n_shared, n_new, n_retained,
               nbl: int):
    """Admit one request into ``slot`` for chunked / prefix-cached prefill.

    The slot's table row becomes ``[shared_ids[:n_shared], <n_new popped
    blocks>, NEG...]``: shared blocks (prefix hits) get ``ref += 1`` and take
    no pool capacity; popped blocks get ``ref = 1``, the first
    ``n_retained`` of them ``ref = 2`` (one table reference plus the prefix
    index's prospective hold: the host registers their content once the
    prompt has prefilled, and the hold keeps them alive if the slot drains
    inside the same dispatch).  ``slot`` and the counts are Python ints.

    The slot stays ``slot_active = False`` (prefill phase: decode writes go
    to the trash block until its first token is sampled in the dispatch).
    Returns ``(bstate, new_ids [nbl])``: the popped ids in table order,
    ``-1`` padded, for the host to register."""
    tbl, free, n_free, ref = bstate["tbl"], bstate["free"], bstate["n_free"], bstate["ref"]
    NB = free.shape[0]
    jj = torch.arange(nbl, dtype=_I32, device=tbl.device)
    take = jj < n_new
    pop_ids = torch.where(take, free[torch.clamp(n_free - 1 - jj, 0, NB - 1).long()], NEG)
    row = torch.where(jj < n_shared, shared_ids, NEG)
    sel = torch.clamp(jj - n_shared, 0, nbl - 1).long()
    in_new = (jj >= n_shared) & (jj < n_shared + n_new)
    row = torch.where(in_new, pop_ids[sel], row)
    tbl = tbl.clone()
    tbl[slot] = torch.cat([row, row.new_full((tbl.shape[1] - nbl,), NEG)])
    ref = _scatter_drop(ref, torch.where(jj < n_shared, shared_ids, NB), 1, add=True)
    ref = _scatter_drop(ref, torch.where(take, pop_ids, NB),
                        torch.where(jj < n_retained, 2, 1).to(_I32))
    active = bstate["slot_active"].clone()
    active[slot] = False
    return {**bstate, "tbl": tbl, "ref": ref, "n_free": n_free - n_new,
            "slot_active": active}, pop_ids


# ---------------------------------------------------------------------------
# Prefill-chunk write routing (no allocation: admission preallocated)
# ---------------------------------------------------------------------------

def span_targets(bstate: dict, start: torch.Tensor, valid: torch.Tensor, width: int,
                 block_size: int, cap: int, ring: bool, shared_until=None):
    """Write targets for a prefill chunk: rows ``start[b] .. start[b] +
    valid[b] - 1`` map through the slot's (preallocated) table row.

    Returns ``(wblk [B, width], woff [B, width])``.  Rows past ``valid``,
    past capacity or in unallocated entries go to the trash block, as do
    rows below ``shared_until[b]``, the slot's prefix-hit watermark: those
    positions live in blocks shared through the prefix cache (a matched row
    recomputed only for its logits), whose cached rows already hold the
    same values, so the write is dropped instead of touching a block other
    owners read."""
    tbl = bstate["tbl"]
    B, MB = tbl.shape
    NB = bstate["ref"].shape[0]
    jj = torch.arange(width, dtype=_I32, device=tbl.device)[None, :]
    pos = start[:, None] + jj
    rpos = pos % cap if ring else pos
    ok = (jj < valid[:, None]) & (rpos < cap)
    if shared_until is not None:
        ok = ok & (pos >= shared_until[:, None])
    j = torch.clamp(rpos // block_size, 0, MB - 1).long()
    blk = torch.gather(tbl, 1, j)
    ok = ok & (blk >= 0)
    return torch.where(ok, blk, NB), rpos % block_size


# ---------------------------------------------------------------------------
# Gather
# ---------------------------------------------------------------------------

def gather_blocks(pool: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """pool [NB+1, bs, Kv, hd], tbl [B, MB] -> [B, MB*bs, Kv, hd].

    Unallocated entries (-1) wrap to the trash block; callers mask by
    length, so its rows never reach the softmax."""
    B, MB = tbl.shape
    g = pool[tbl.long()]                        # [B, MB, bs, Kv, hd]
    return g.reshape(B, MB * pool.shape[1], *pool.shape[2:])
