"""Host-side prefix cache: content-chained block hashes -> device block ids.

Port of ``repro/engine/prefix.py`` (host Python, copied so the port imports
nothing of ``repro``; its keys equal the reference's for the same tokens in
one process).  Block ``i`` of a prompt is keyed by ``hash(parent_key,
tokens[i*bs:(i+1)*bs])``, so a key names the block's content and everything
before it: two prompts share block ``i`` iff their first ``(i+1)*bs``
tokens are equal.  Only **full** blocks are registered (a partial last
block gets the generated tokens appended, so its content is not a function
of the prompt alone).

The index is host bookkeeping; the device truth is the allocator's refcount
array (``engine/paged.py``).  Each registered block holds one device
reference (the "index hold", taken at admission by ``admit_slot(n_retained
=...)``), so a finished request's prompt blocks stay cached instead of
going back to the free stack.  Eviction (LRU over registration / last-hit
order, leaf first) drops the hold through ``release_refs``, and the block
frees once no live slot references it.

``match`` resolves a new prompt against the index:

* **full-block hits**: the longest chain of leading full blocks registered;
* a **partial tail hit**: when the remaining tail (under one block) equals
  the first ``len(tail)`` tokens of a registered child of the last matched
  node, that block is mapped too; the admitted slot then shares a partly
  relevant block, and its first decode write copies it
  (``alloc_step(cow=True)``).

The engine tracks which live slots reference each entry (``pin`` /
``unpin``), so eviction never takes a block from under a running request.
"""
from __future__ import annotations

from dataclasses import dataclass, field


_ROOT = "root"


def chain_hashes(tokens, block_size: int) -> list[tuple]:
    """Chained keys of every *full* block of ``tokens``."""
    keys, parent = [], _ROOT
    for i in range(len(tokens) // block_size):
        blk = tuple(int(t) for t in tokens[i * block_size:(i + 1) * block_size])
        parent = hash((parent, blk))
        keys.append(parent)
    return keys


@dataclass
class _Entry:
    block: int                 # device block id
    tokens: tuple              # the block's token content
    parent: object             # parent chain key (or _ROOT)
    pins: int = 0              # live slots referencing this entry


@dataclass
class PrefixIndex:
    block_size: int
    _entries: dict = field(default_factory=dict)    # chain key -> _Entry
    _children: dict = field(default_factory=dict)   # parent key -> set(keys)
    _lru: dict = field(default_factory=dict)        # key -> tick (ordered)
    _tick: int = 0
    hits: int = 0               # full-block hits served
    partial_hits: int = 0
    evictions: int = 0

    # -- bookkeeping --------------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def _touch(self, key) -> None:
        self._tick += 1
        self._lru[key] = self._tick

    def block_of(self, key) -> int:
        return self._entries[key].block

    # -- matching -----------------------------------------------------------

    def match(self, tokens) -> tuple[list[int], int | None, list]:
        """Resolve ``tokens`` against the index.

        Returns ``(full_block_ids, partial_block_id, keys)``: the device ids
        of the longest chain of matched leading full blocks, (optionally) a
        registered block whose content starts with the remaining partial
        tail, and the chain keys of every matched entry (for ``pin``).
        Matched entries are LRU-touched and must then be ``pin``-ed by the
        caller for the request's lifetime.
        """
        bs = self.block_size
        toks = [int(t) for t in tokens]
        full_ids, keys, parent = [], [], _ROOT
        n_full = len(toks) // bs
        for i in range(n_full):
            blk = tuple(toks[i * bs:(i + 1) * bs])
            key = hash((parent, blk))
            e = self._entries.get(key)
            if e is None or e.tokens != blk:
                break
            full_ids.append(e.block)
            keys.append(key)
            self._touch(key)
            parent = key
        partial_id = None
        tail = tuple(toks[len(full_ids) * bs:])
        if tail and len(full_ids) == n_full:
            for key in self._children.get(parent, ()):
                e = self._entries[key]
                if e.tokens[:len(tail)] == tail:
                    partial_id = e.block
                    keys.append(key)
                    self._touch(key)
                    self.partial_hits += 1
                    break
        self.hits += len(full_ids)
        return full_ids, partial_id, keys

    def keys_for(self, tokens, n_blocks: int) -> list[tuple]:
        """Chain keys of the first ``n_blocks`` full blocks of ``tokens``."""
        return chain_hashes(tokens, self.block_size)[:n_blocks]

    # -- registration -------------------------------------------------------

    def register(self, tokens, block_ids: list[int],
                 first_block: int) -> list[int]:
        """Register full prompt blocks ``first_block..`` of ``tokens`` under
        ``block_ids`` (one id per block, in order).  Returns the ids that
        were **duplicates** — an equal-content entry already existed, so the
        caller must drop the pre-retained index hold on the redundant copy
        (``release_refs``) and keep the original.
        """
        bs = self.block_size
        toks = [int(t) for t in tokens]
        keys = chain_hashes(toks, bs)
        dups = []
        for j, bid in enumerate(block_ids):
            i = first_block + j
            key = keys[i]
            if key in self._entries:
                dups.append(bid)
                continue
            blk = tuple(toks[i * bs:(i + 1) * bs])
            parent = keys[i - 1] if i else _ROOT
            self._entries[key] = _Entry(bid, blk, parent)
            self._children.setdefault(parent, set()).add(key)
            self._touch(key)
        return dups

    # -- pinning (live-slot references) -------------------------------------

    def pin(self, keys) -> None:
        for k in keys:
            if k in self._entries:
                self._entries[k].pins += 1

    def unpin(self, keys) -> None:
        for k in keys:
            e = self._entries.get(k)
            if e is not None and e.pins > 0:
                e.pins -= 1

    # -- eviction -----------------------------------------------------------

    def evict(self, want: int) -> list[int]:
        """Evict up to ``want`` unpinned entries in LRU order; an entry is
        only evictable when no live slot references it AND it has no
        registered children (children chain through their parent, and
        evicting leaf-first keeps every remaining entry reachable).
        Returns the device block ids whose index hold must be released."""
        freed: list[int] = []
        order = sorted(self._lru, key=self._lru.get)   # one sort per call
        progress = True
        while len(freed) < want and progress:
            progress = False
            for key in order:
                e = self._entries.get(key)
                if e is None or e.pins or self._children.get(key):
                    continue   # gone, live-referenced, or has children
                self._entries.pop(key)
                self._lru.pop(key, None)
                self._children.get(e.parent, set()).discard(key)
                if not self._children.get(e.parent):
                    self._children.pop(e.parent, None)
                freed.append(e.block)
                self.evictions += 1
                progress = True
                if len(freed) >= want:
                    break
        return freed
