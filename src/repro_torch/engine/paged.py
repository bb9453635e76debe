"""Paged KV cache: global block pool, per-slot block tables, a device free
list and refcounts.

Port of the decode path of ``repro/engine/paged.py``.  The contiguous cache
reserves ``cache_len`` rows per slot per layer; the paged cache replaces
them with a **global pool of fixed-size token blocks** shared by all slots:

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
  block (the prefix cache, not ported yet, adds a host hold).  Conservation:
  ``n_free + |{b : ref[b] > 0}| == num_blocks``.

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
