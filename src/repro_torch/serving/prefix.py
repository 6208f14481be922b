"""Prefix sharing: a token-hash trie over block-aligned prefixes.

The paged cache (PR 2) owns every block per request, so a shared system
prompt or a conversation trunk is prefilled and stored N times. This module
is the sharing layer on top of the refcounted ``BlockAllocator``:

* ``PrefixIndex`` — a trie keyed on **block-sized token tuples**. When a
  request finishes, the pool registers its cached transcript (prompt +
  all-but-the-last generated token): each full block becomes a trie edge
  holding the *physical page id*, and a partially-filled tail block is kept
  as a tail entry on its node. The index retains one allocator reference
  per page it holds (owner ``INDEX_OWNER``), so registered pages survive
  the request that wrote them.
* ``match(prompt)`` — walks the trie and returns a ``PrefixHit``: the run
  of full blocks whose token content equals the prompt's leading blocks,
  plus (when a stored block's first ``r`` tokens equal the prompt's final
  partial block) a shared **boundary tail block** that covers the prompt to
  its end. Admission then prefills only the un-shared suffix; always at
  least one token is recomputed so the first-token logits exist.
* Copy-on-write contract: a shared page (``allocator.is_shared``) is never
  written. Full shared blocks sit strictly below every writer's append
  position; a shared *tail* block is exactly where the first decode write
  of a forked request lands, and the pool COW-splits it at that write.
* Eviction — the index holds real pages, so under allocator pressure the
  pool reclaims least-recently-touched leaves whose pages have no other
  reference (``evict_one``) before preempting live requests.

Everything here is host-side Python over token tuples and page ids —
deterministic, and cheap relative to the jitted work it avoids.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.serving.paged_cache import BlockAllocator

__all__ = ["INDEX_OWNER", "PrefixHit", "PrefixIndex", "PrefixStats"]

# Sentinel allocator owner for references held by the index itself.
# Request uids are >= 0, so the ownership errors stay unambiguous.
INDEX_OWNER = -2


@dataclasses.dataclass
class PrefixHit:
    """One successful index lookup, in block-table terms.

    ``full_blocks`` fill table entries ``[0, n)``; ``tail_block`` (when the
    match covers the prompt to its end through a partially-valid stored
    block) fills entry ``n``. ``prefix_tokens`` is the number of leading
    positions whose KV comes from shared pages — the suffix actually
    prefilled is ``len(prompt) - prefix_tokens >= 1``.
    """

    full_blocks: List[int]
    tail_block: Optional[int]
    prefix_tokens: int
    tokens_covered: int

    @property
    def shared_entries(self) -> int:
        return len(self.full_blocks) + (1 if self.tail_block is not None else 0)

    @property
    def table_blocks(self) -> List[int]:
        out = list(self.full_blocks)
        if self.tail_block is not None:
            out.append(self.tail_block)
        return out

    def gather_blocks(self, block_size: int) -> List[int]:
        """Blocks whose rows the suffix prefill must gather: the ones
        covering positions ``[0, prefix_tokens)``."""
        need = -(-self.prefix_tokens // block_size)
        return self.table_blocks[:need]


@dataclasses.dataclass
class PrefixStats:
    """Per-pool sharing counters. ``saved_*`` fields are *avoided* work —
    reported next to the energy totals, never added into them, so the
    conservation property (pool totals == sum of per-request energy) is
    untouched by sharing."""

    lookups: int = 0
    hits: int = 0
    misses: int = 0
    shared_blocks: int = 0          # block references handed to requests
    shared_tokens: int = 0          # prompt positions served from shared pages
    cow_splits: int = 0             # shared pages copied on first divergent write
    saved_prefill_tokens: int = 0
    saved_prefill_j: float = 0.0
    saved_migrate_bytes: int = 0    # migration scatter bytes avoided
    registrations: int = 0
    index_blocks: int = 0           # pages currently held by the index
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def merge(self, other: "PrefixStats"):
        self.lookups += other.lookups
        self.hits += other.hits
        self.misses += other.misses
        self.shared_blocks += other.shared_blocks
        self.shared_tokens += other.shared_tokens
        self.cow_splits += other.cow_splits
        self.saved_prefill_tokens += other.saved_prefill_tokens
        self.saved_prefill_j += other.saved_prefill_j
        self.saved_migrate_bytes += other.saved_migrate_bytes
        self.registrations += other.registrations
        self.index_blocks += other.index_blocks
        self.evictions += other.evictions

    def as_dict(self) -> Dict[str, Any]:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hit_rate, 6),
            "shared_blocks": self.shared_blocks,
            "shared_tokens": self.shared_tokens,
            "cow_splits": self.cow_splits,
            "saved_prefill_tokens": self.saved_prefill_tokens,
            "saved_prefill_j": self.saved_prefill_j,
            "saved_migrate_bytes": self.saved_migrate_bytes,
            "registrations": self.registrations,
            "index_blocks": self.index_blocks,
            "evictions": self.evictions,
        }


class _Node:
    __slots__ = ("key", "block", "children", "tails", "parent", "touch")

    def __init__(self, key: Optional[Tuple[int, ...]], block: Optional[int],
                 parent: Optional["_Node"], touch: int):
        self.key = key                      # block-sized token tuple (edge)
        self.block = block                  # physical page id (None at root)
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.tails: Dict[Tuple[int, ...], int] = {}   # token tuple -> page
        self.parent = parent
        self.touch = touch


class PrefixIndex:
    """Block-aligned prefix trie holding refcounted page references."""

    def __init__(self, allocator: BlockAllocator):
        self.allocator = allocator
        self.block_size = allocator.block_size
        self._root = _Node(None, None, None, 0)
        self._tick = 0
        self._held = 0        # pages the index holds a reference to

    # ------------------------------------------------------------- queries
    @property
    def held_blocks(self) -> int:
        return self._held

    def blocks(self) -> List[int]:
        """Every page id the index holds, preorder — deterministic."""
        out: List[int] = []
        for node, _ in self._walk():
            if node.block is not None:
                out.append(node.block)
            out.extend(node.tails.values())
        return out

    def reclaimable_blocks(self) -> int:
        """Pages only the index references — the capacity eviction could
        hand back to the allocator (an upper bound the admission gate may
        count as free)."""
        return sum(1 for b in self.blocks()
                   if self.allocator.refcount(b) == 1)

    def match(self, prompt) -> Optional[PrefixHit]:
        """Longest block-aligned shared prefix for ``prompt`` (tokens).
        Touches the matched path (LRU). Returns None when no full leading
        block matches; otherwise covers at most ``len(prompt) - 1``
        positions so at least one suffix token is always recomputed."""
        bs = self.block_size
        L = len(prompt)
        self._tick += 1
        node = self._root
        full: List[int] = []
        n = 0
        while (n + 1) * bs <= L:
            key = tuple(int(t) for t in prompt[n * bs:(n + 1) * bs])
            child = node.children.get(key)
            if child is None:
                break
            child.touch = self._tick
            node = child
            full.append(child.block)
            n += 1
        r = L - n * bs
        if n and r == 0:
            # the whole prompt is shared full blocks; recompute the last
            # token (its KV is already the final row of full_blocks[-1])
            return PrefixHit(full, None, L - 1, L)
        if r:
            remainder = tuple(int(t) for t in prompt[n * bs:])
            tail = self._boundary(node, remainder, r)
            if tail is not None and n:
                return PrefixHit(full, tail, L - 1, L)
        if n:
            return PrefixHit(full, None, n * bs, n * bs)
        return None

    def peek(self, prompt) -> Tuple[int, int]:
        """(shared table entries, shared prefix tokens) the prompt would
        get — no LRU touch, no stats; for admission gates and routing."""
        bs = self.block_size
        L = len(prompt)
        node = self._root
        n = 0
        while (n + 1) * bs <= L:
            key = tuple(int(t) for t in prompt[n * bs:(n + 1) * bs])
            child = node.children.get(key)
            if child is None:
                break
            node = child
            n += 1
        if n == 0:
            return 0, 0
        r = L - n * bs
        if r == 0:
            return n, L - 1
        if self._boundary(node, tuple(int(t) for t in prompt[n * bs:]), r) \
                is not None:
            return n + 1, L - 1
        return n, n * bs

    def _boundary(self, node: _Node, remainder: Tuple[int, ...],
                  r: int) -> Optional[int]:
        """A stored block under ``node`` whose first ``r`` tokens equal the
        prompt's final partial block — full-block edges first, then tails,
        both in insertion order (deterministic)."""
        for key, child in node.children.items():
            if key[:r] == remainder:
                child.touch = self._tick
                return child.block
        for tt, block in node.tails.items():
            if len(tt) >= r and tt[:r] == remainder:
                node.touch = self._tick
                return block
        return None

    # ------------------------------------------------------------ register
    def register(self, tokens, blocks: List[int], cached_len: int) -> int:
        """Insert a finished request's cached transcript. ``tokens`` are
        the ``cached_len`` positions whose KV lives in ``blocks`` (the
        request's block-table prefix). Pages newly kept get one index
        reference; blocks whose token path already exists are left to the
        caller to free (dedup keeps the first donor's page). Returns the
        number of pages newly retained."""
        bs = self.block_size
        self._tick += 1
        kept = 0
        node = self._root
        n_full = cached_len // bs
        for j in range(n_full):
            key = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, blocks[j], node, self._tick)
                node.children[key] = child
                self.allocator.retain(blocks[j], INDEX_OWNER)
                self._held += 1
                kept += 1
            child.touch = self._tick
            node = child
        r = cached_len % bs
        if r:
            tt = tuple(int(t) for t in tokens[n_full * bs:cached_len])
            covered = (tt in node.tails
                       or any(k[:r] == tt for k in node.children))
            if not covered:
                node.tails[tt] = blocks[n_full]
                self.allocator.retain(blocks[n_full], INDEX_OWNER)
                self._held += 1
                kept += 1
        return kept

    # ------------------------------------------------------------ eviction
    def evict_one(self) -> bool:
        """Release the least-recently-touched evictable entry whose page
        has no other reference (so the release actually frees capacity).
        Tails anywhere and childless/tailless leaf nodes are evictable;
        interior nodes become evictable as their subtrees go. Returns
        False when nothing reclaimable is left."""
        best = None   # ((touch, kind, order), node, tail_key)
        order = 0
        for node, _ in self._walk():
            order += 1
            for tt, block in node.tails.items():
                if self.allocator.refcount(block) == 1:
                    cand = ((node.touch, 1, order), node, tt)
                    if best is None or cand[0] < best[0]:
                        best = cand
            if (node.block is not None and not node.children
                    and not node.tails
                    and self.allocator.refcount(node.block) == 1):
                cand = ((node.touch, 0, order), node, None)
                if best is None or cand[0] < best[0]:
                    best = cand
        if best is None:
            return False
        (_, kind, _), node, tail_key = best
        if kind == 1:
            block = node.tails.pop(tail_key)
        else:
            block = node.block
            del node.parent.children[node.key]
        self.allocator.release(block, INDEX_OWNER)
        self._held -= 1
        return True

    def clear(self) -> int:
        """Release every reference the index holds (teardown helper)."""
        n = 0
        for node, _ in self._walk():
            if node.block is not None:
                self.allocator.release(node.block, INDEX_OWNER)
                n += 1
            for block in node.tails.values():
                self.allocator.release(block, INDEX_OWNER)
                n += 1
        self._root = _Node(None, None, None, 0)
        self._held = 0
        return n

    # -------------------------------------------------------------- defrag
    def remap(self, mapping: Dict[int, int]) -> int:
        """Apply a defrag old->new page mapping. Every held page is live,
        so it must appear in the mapping; each trie entry holds its page id
        in exactly one place, so each shared block is remapped exactly
        once. Returns the number of entries rewritten."""
        n = 0
        for node, _ in self._walk():
            if node.block is not None:
                node.block = mapping[node.block]
                n += 1
            for tt in node.tails:
                node.tails[tt] = mapping[node.tails[tt]]
                n += 1
        return n

    # ------------------------------------------------------------ internals
    def _walk(self) -> Iterator[Tuple[_Node, int]]:
        """Preorder (node, depth) over real nodes (root excluded for block
        fields but included so root tails — none in practice — are seen)."""
        stack: List[Tuple[_Node, int]] = [(self._root, 0)]
        while stack:
            node, d = stack.pop()
            yield node, d
            for child in reversed(list(node.children.values())):
                stack.append((child, d + 1))
