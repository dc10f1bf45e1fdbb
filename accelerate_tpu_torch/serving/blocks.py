"""Paged KV-cache storage: a block pool, a refcounting allocator, and a
content-addressed prefix cache.

A copy of the JAX package's ``serving/blocks.py`` (which is numpy-only but
sits behind a package import that loads JAX), with the pool as torch tensors
on the engine's device.  The host-DRAM tier (``HostBlockPool``) is not
ported yet.

The resident KV cache is a pool of ``num_blocks`` fixed-size blocks shared by
every in-flight request (``[L, num_blocks, block_size, K, hd]`` per leaf),
with a per-request **block table** mapping logical token positions to
physical blocks.  A request holding ``n`` tokens costs ``ceil(n /
block_size)`` blocks.

Blocks are **refcounted** so physical blocks can be shared: ``alloc`` grants
refcount 1, :meth:`BlockAllocator.retain` adds a reader (prefix sharing), and
``free`` releases one reference — the block returns to the free list only
when the last holder lets go.  A block marked **dirty** (a quarantined
request's possibly non-finite K/V) is zeroed when its last reference drops,
never under a live reader.  Blocks whose only reference is the
:class:`PrefixCache` are **reclaimable**: they count as free capacity and
``alloc`` evicts them LRU-first.

Block 0 is reserved as the **null block**: it is never handed out, block
tables are padded with it, and inactive decode slots write their garbage row
into it.

:class:`PrefixCache` shares **full prompt blocks across requests by
content**: block ``i`` of a request's feed is keyed by a chain hash ``h_i =
H(h_{i-1} || tokens[i*bs:(i+1)*bs])`` — K/V rows depend on the whole prefix.
A partial tail is reused by **copy-on-write** into a private block; shared
blocks are never written after registration.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "NULL_BLOCK",
    "BlockAllocator",
    "BlockOutOfMemory",
    "PagedKVCache",
    "PrefixCache",
    "blocks_for_tokens",
]

NULL_BLOCK = 0


class BlockOutOfMemory(RuntimeError):
    """No free block available; the caller decides (preempt, queue, reject)."""


def blocks_for_tokens(tokens: int, block_size: int) -> int:
    """ceil(tokens / block_size) — blocks needed to hold ``tokens`` rows."""
    return -(-tokens // block_size)


class BlockAllocator:
    """Refcounting LIFO free-list over block ids ``1..num_blocks-1`` (0 is
    the null block).  ``free`` releases ONE reference; a block shared via
    :meth:`retain` stays allocated until its last holder frees it."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (one null + one usable), got {num_blocks}"
            )
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._dirty: set = set()
        self._pending_scrub: List[int] = []
        self._cache: Optional["PrefixCache"] = None

    def attach_cache(self, cache: "PrefixCache") -> None:
        """Wire a :class:`PrefixCache` in: its cache-only blocks count as
        reclaimable free capacity and are evicted LRU-first on pressure."""
        self._cache = cache

    @property
    def capacity(self) -> int:
        """Usable blocks (excludes the null block)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        """Immediately allocatable blocks: the free list plus cache-only
        (reclaimable) blocks an ``alloc`` would evict on demand."""
        n = len(self._free)
        if self._cache is not None:
            n += self._cache.reclaimable_count
        return n

    @property
    def used_blocks(self) -> int:
        """Blocks held by at least one non-cache reference."""
        n = len(self._ref)
        if self._cache is not None:
            n -= self._cache.reclaimable_count
        return n

    @property
    def occupancy(self) -> float:
        return self.used_blocks / self.capacity

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, n: int = 1) -> List[int]:
        """Pop ``n`` free blocks (each at refcount 1); evicts cache-only
        blocks when the free list alone cannot cover the grant.  Raises
        :class:`BlockOutOfMemory` (allocating NOTHING) when fewer than ``n``
        are reachable."""
        if n < 0:
            raise ValueError(f"alloc count must be >= 0, got {n}")
        if n > len(self._free) and self._cache is not None:
            self._cache.evict(n - len(self._free))
        if n > len(self._free):
            raise BlockOutOfMemory(
                f"need {n} blocks, {self.free_blocks} free of {self.capacity}"
            )
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def retain(self, block: int) -> None:
        """Add one reference to an allocated block (prefix sharing)."""
        if block == NULL_BLOCK:
            raise ValueError("cannot retain the null block")
        if block not in self._ref:
            raise ValueError(f"retain of unallocated block: {block}")
        if self._ref[block] == 1 and self._cache is not None:
            self._cache._note_first_reader(block)
        self._ref[block] += 1

    def free(self, blocks: List[int]) -> None:
        """Release one reference per block; the last release returns the
        block to the free list (or to ``pending_scrub`` when it was marked
        dirty).  Releasing the null block or a block with no references is
        a hard error."""
        for b in blocks:
            if b == NULL_BLOCK:
                raise ValueError("cannot free the null block")
            if b not in self._ref:
                raise ValueError(f"double free / foreign block: {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                if b in self._dirty:
                    self._pending_scrub.append(b)
                else:
                    self._free.append(b)
            elif self._ref[b] == 1 and self._cache is not None:
                self._cache._note_last_reader_left(b)

    def mark_dirty(self, blocks: List[int]) -> None:
        """Mark blocks as needing a zero-scrub before reuse; blocks still
        referenced keep serving their live readers until the last release."""
        for b in blocks:
            if b in self._ref:
                self._dirty.add(b)

    def is_dirty(self, block: int) -> bool:
        return block in self._dirty

    def pop_pending_scrub(self) -> List[int]:
        """Dirty blocks whose last reference released since the previous
        drain.  The engine zeroes them and hands them back via
        :meth:`finish_scrub`; until then they are NOT allocatable."""
        out, self._pending_scrub = self._pending_scrub, []
        for b in out:
            self._dirty.discard(b)
        return out

    def finish_scrub(self, blocks: List[int]) -> None:
        """Return scrubbed blocks to the free list."""
        self._free.extend(blocks)


class PrefixCache:
    """Content-addressed cache of full prompt blocks for cross-request
    sharing (see the module docstring).  The cache holds ONE allocator
    reference per cached block; :meth:`evict` releases cache-only blocks
    LRU-first when the allocator needs room."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()  # LRU: oldest first
        self._by_block: Dict[int, bytes] = {}
        # Cache-only block count, kept incrementally so free_blocks stays O(1).
        self._reclaimable = 0
        allocator.attach_cache(self)

    @staticmethod
    def chain_keys(tokens: List[int], block_size: int, limit: Optional[int] = None) -> List[bytes]:
        """Chain hash per FULL block of ``tokens``: ``h_i`` digests every
        token up to and including block ``i``."""
        nb = len(tokens) // block_size
        if limit is not None:
            nb = min(nb, limit)
        h = hashlib.sha256()
        keys = []
        for i in range(nb):
            h.update(np.asarray(tokens[i * block_size:(i + 1) * block_size], np.int64).tobytes())
            keys.append(h.digest())
        return keys

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def reclaimable_count(self) -> int:
        """Cached blocks whose ONLY reference is this cache."""
        return self._reclaimable

    def _note_first_reader(self, block: int) -> None:
        if block in self._by_block:
            self._reclaimable -= 1

    def _note_last_reader_left(self, block: int) -> None:
        if block in self._by_block:
            self._reclaimable += 1

    def lookup(self, tokens: List[int], max_rows: int) -> Tuple[List[int], int, Optional[int]]:
        """Longest cached chain over the full blocks of ``tokens``, capped at
        ``max_rows`` reusable rows.  Returns ``(blocks, rows, cow_src)``:
        ``blocks`` are the wholesale-shared full blocks (each retained for
        the caller), ``rows = len(blocks) * block_size``, and ``cow_src`` —
        also retained, the caller MUST release it after copying — is the next
        chain block when a partial tail is still reusable via copy-on-write."""
        bs = self.block_size
        matched: List[Tuple[bytes, int]] = []
        for key in self.chain_keys(tokens, bs, limit=blocks_for_tokens(max_rows, bs)):
            block = self._entries.get(key)
            if block is None:
                break
            self.allocator.retain(block)
            self._entries.move_to_end(key)
            matched.append((key, block))
        if not matched:
            return [], 0, None
        full_usable = min(len(matched), max_rows // bs)
        blocks = [block for _, block in matched[:full_usable]]
        extra = matched[full_usable:]
        cow_src = None
        if extra and max_rows % bs:
            cow_src = extra[0][1]
            extra = extra[1:]
        for _, block in extra:  # matched past the reusable window: release
            self.allocator.free([block])
        return blocks, full_usable * bs, cow_src

    def register(self, chain_key: bytes, block: int) -> bool:
        """Publish a fully-written prompt block under its chain key; returns
        False when the key or the block is already cached."""
        if chain_key in self._entries or block in self._by_block:
            return False
        self.allocator.retain(block)
        self._entries[chain_key] = block
        self._by_block[block] = chain_key
        return True

    def evict(self, n: int) -> int:
        """Release up to ``n`` cache-only blocks, least recently used first;
        returns how many were released.  Blocks with live readers are never
        touched."""
        released = 0
        for key in list(self._entries):
            if released >= n:
                break
            block = self._entries[key]
            if self.allocator.refcount(block) != 1:
                continue
            del self._entries[key]
            del self._by_block[block]
            self._reclaimable -= 1
            self.allocator.free([block])
            released += 1
        return released

    def invalidate_blocks(self, blocks: List[int]) -> None:
        """Drop cached entries for ``blocks`` (quarantine: no new sharers may
        attach to a possibly-poisoned block) and release the cache's
        reference."""
        for b in blocks:
            key = self._by_block.pop(b, None)
            if key is not None:
                del self._entries[key]
                if self.allocator.refcount(b) == 1:
                    self._reclaimable -= 1
                self.allocator.free([b])


class PagedKVCache:
    """The device-side block pool plus its allocator.  ``init_cache`` is a
    model family's cache constructor; the pool leaves are derived from its
    batch-1 template (:func:`~accelerate_tpu_torch.models.generation.make_paged_pool`)
    and live on ``device``."""

    def __init__(self, init_cache: Callable, config, num_blocks: int, block_size: int, device):
        from ..models.generation import make_paged_pool

        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        self.allocator = BlockAllocator(num_blocks)
        self.pool: Dict[str, torch.Tensor] = make_paged_pool(
            init_cache, config, num_blocks, block_size, device
        )

    def pool_bytes(self) -> int:
        return sum(leaf.numel() * leaf.element_size() for leaf in self.pool.values())

    def block_bytes(self) -> int:
        """Bytes of pool data behind ONE block across every leaf and layer."""
        num_blocks = next(iter(self.pool.values())).shape[1]
        return self.pool_bytes() // num_blocks
