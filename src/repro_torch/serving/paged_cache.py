"""Paged KV/state cache substrate: block allocator + block tables + traffic.

The dense slot pool preallocates one ``(B, max_len, ...)`` cache row per
slot — reserving exactly the resource the paper says decode is bound by
(HBM) for contexts that mostly never materialise. Here the per-token caches
live in fixed-size **token blocks** shared by all requests:

* ``BlockAllocator`` — owns the physical page id space. Page ids start at 1;
  **page 0 is reserved as the null page**: unallocated block-table entries
  point at it, and the jitted decode step routes inactive slots' writes to
  it, so a stale table can never corrupt a page that has been reallocated.
* block tables — per-request ``(nb,)`` int32 rows mapping logical block
  ``j`` (tokens ``[j*bs, (j+1)*bs)``) to a physical page. The serving pool
  stores them per slot and hands the stacked ``(B, nb)`` array to the jitted
  paged decode step; migration between pools is a block-table handoff plus
  one jitted page scatter (copy-on-migrate).
* ``TrafficCounter`` (re-exported from ``repro.core.metering``) — the
  byte-accurate ledger the energy layer consumes: reads stream whole blocks
  (a partially-filled tail block still moves ``block_bytes``), so counting
  blocks touched per step IS counting bytes moved.

Blocks are **refcounted** so prefix sharing (``repro.serving.prefix``) can
hand the same physical page to many requests: ``alloc`` creates the first
reference, ``retain`` adds one for a new owner, and ``free``/``release``
drop one reference each — the page returns to the free list only when the
last reference goes. A writer must hold the *only* reference to mutate a
page; the pool enforces that with a copy-on-write split (``is_shared``).

The allocator is deliberately host-side Python: allocation decisions are
control flow (admission, growth, preemption), only the resulting tables
enter jit.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.metering import TrafficCounter

__all__ = ["BlockAllocator", "TrafficCounter", "NULL_PAGE"]

NULL_PAGE = 0


class BlockAllocator:
    """Fixed-size token-block allocator with refcounted ownership tracking.

    Ownership (block id -> list of owner keys, one entry per reference)
    turns silent corruption into loud errors: allocating a block twice,
    freeing a block through the wrong request, or freeing twice all raise.
    ``retain``/``release`` add/drop a reference for prefix sharing;
    ``refcount``/``is_shared`` drive the pool's copy-on-write decision.
    ``defrag`` compacts live blocks to the lowest ids and returns the
    old->new mapping so the cache arrays and block tables can be remapped
    in one gather — each live block appears in the mapping exactly once no
    matter how many owners reference it.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # pop() from the end hands out ascending ids 1, 2, ...
        self._free = list(range(num_blocks, 0, -1))
        self._owners: Dict[int, List[int]] = {}

    # ------------------------------------------------------------- capacity
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._owners)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.block_size)

    def can_alloc(self, n_blocks: int) -> bool:
        return n_blocks <= len(self._free)

    # ------------------------------------------------------------ alloc/free
    def alloc(self, n_blocks: int, owner: int) -> List[int]:
        if not self.can_alloc(n_blocks):
            raise MemoryError(
                f"requested {n_blocks} blocks, {len(self._free)} free "
                f"of {self.num_blocks}"
            )
        out = [self._free.pop() for _ in range(n_blocks)]
        for b in out:
            self._owners[b] = [owner]
        return out

    def alloc_one(self, owner: int) -> Optional[int]:
        """One block or None — the grow-by-one path never raises; the pool
        turns None into a preemption decision."""
        if not self._free:
            return None
        b = self._free.pop()
        self._owners[b] = [owner]
        return b

    def free(self, blocks: List[int], owner: int):
        """Drop one reference per block for ``owner``; a block returns to
        the free list only when its last reference is dropped."""
        for b in blocks:
            refs = self._owners.get(b)
            if refs is None:
                raise ValueError(f"double free of block {b}")
            if owner not in refs:
                held = refs[0] if len(refs) == 1 else sorted(refs)
                raise ValueError(
                    f"block {b} owned by {held}, freed by {owner}"
                )
            refs.remove(owner)
            if not refs:
                del self._owners[b]
                self._free.append(b)

    # ---------------------------------------------------------- refcounting
    def retain(self, block: int, owner: int):
        """Add a reference to a live block (prefix sharing: a new request —
        or the prefix index itself — starts sharing the page)."""
        refs = self._owners.get(block)
        if refs is None:
            raise ValueError(f"retain of unallocated block {block}")
        refs.append(owner)

    def release(self, block: int, owner: int):
        """Drop exactly one reference — single-block ``free``."""
        self.free([block], owner)

    def refcount(self, block: int) -> int:
        return len(self._owners.get(block, ()))

    def is_shared(self, block: int) -> bool:
        """True when >1 reference holds the page: a writer must COW-split."""
        return self.refcount(block) > 1

    def owners(self, block: int) -> List[int]:
        return list(self._owners.get(block, ()))

    def owned_by(self, owner: int) -> List[int]:
        return sorted(b for b, refs in self._owners.items() if owner in refs)

    # ------------------------------------------------------------ invariants
    def assert_invariants(self):
        """Debug helper: the ledger always balances. free + used ==
        num_blocks, the free list holds no duplicates and no live block, no
        live block has an empty owner list, every id is in [1, num_blocks].
        Raises AssertionError with a specific message on the first breach."""
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        assert len(self._free) + len(self._owners) == self.num_blocks, (
            f"ledger imbalance: {len(self._free)} free + "
            f"{len(self._owners)} used != {self.num_blocks}"
        )
        assert not (free & set(self._owners)), (
            f"blocks both free and owned: {sorted(free & set(self._owners))}"
        )
        for b, refs in self._owners.items():
            assert 1 <= b <= self.num_blocks, f"out-of-range block id {b}"
            assert refs, f"orphaned block {b}: live with zero references"
        for b in free:
            assert 1 <= b <= self.num_blocks, f"out-of-range free id {b}"

    # --------------------------------------------------------------- defrag
    def defrag(self) -> Dict[int, int]:
        """Compact live blocks to ids 1..used (admission order of ids, i.e.
        ascending old id). Returns {old_id: new_id} for every live block;
        callers must remap their block tables AND physically move the pages
        (``Pool.defrag`` does both in one gather). A shared block is one
        live block: it appears in the mapping once, and every table that
        references it remaps through the same entry."""
        live = sorted(self._owners)
        mapping = {old: new for new, old in enumerate(live, start=1)}
        self._owners = {mapping[old]: refs
                        for old, refs in self._owners.items()}
        used = len(live)
        self._free = list(range(self.num_blocks, used, -1))
        return mapping
