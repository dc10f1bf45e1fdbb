"""Paged KV-cache storage: a block pool, a refcounting allocator, and a
content-addressed prefix cache.

A copy of the JAX package's ``serving/blocks.py`` (which is numpy-only but
sits behind a package import that loads JAX), with the pool as torch tensors
on the engine's device and the host tier as CPU tensors (pinned when the
pool is on a GPU).

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

**Host tier.**  :class:`PagedKVCache` can carry a second block pool in host
memory (:class:`HostBlockPool`) with the device pool's leaf layout, and
:meth:`PagedKVCache.demote` / :meth:`PagedKVCache.promote` copy whole blocks
between the tiers (one batched copy per leaf, between forwards).  Each copy
has landed when the call returns (an event recorded after the copies is
waited on), so host rows are never reused, scrubbed or read while a copy
still reads or writes them.  A host block has exactly one owner (a
preempted request's demoted KV, or a cold prefix-cache entry), so the tier
keeps no refcounts; a host block marked dirty is zeroed when it is freed.
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
    "HostBlockPool",
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


class HostBlockPool:
    """Host mirror of the device block pool: one CPU leaf per pool leaf with
    the same ``[L, num_blocks, block_size, *rest]`` layout (fp and int8
    codes and scales alike), pinned when the device pool is on a GPU, plus a
    LIFO free list over ids ``0..num_blocks-1`` (no null block: host blocks
    are only ever copied whole).  No refcounts: every host block has one
    owner.  A block marked dirty is zeroed at :meth:`free`, before it can be
    allocated again."""

    def __init__(self, pool: Dict[str, torch.Tensor], num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"host tier needs >= 1 block, got {num_blocks}")
        self.num_blocks = num_blocks
        pin = next(iter(pool.values())).device.type == "cuda"
        self.leaves: Dict[str, torch.Tensor] = {
            name: torch.zeros((leaf.shape[0], num_blocks) + tuple(leaf.shape[2:]),
                              dtype=leaf.dtype, pin_memory=pin)
            for name, leaf in pool.items()
        }
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._used: set = set()
        self._dirty: set = set()

    @property
    def capacity(self) -> int:
        return self.num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._used)

    @property
    def occupancy(self) -> float:
        return len(self._used) / self.num_blocks

    def block_bytes(self) -> int:
        """Bytes behind ONE host block across every leaf and layer (the
        device pool's per-block footprint)."""
        return self.pool_bytes() // self.num_blocks

    def pool_bytes(self) -> int:
        return sum(leaf.numel() * leaf.element_size() for leaf in self.leaves.values())

    def used_bytes(self) -> int:
        return len(self._used) * self.block_bytes()

    def alloc(self, n: int = 1) -> List[int]:
        """Pop ``n`` free host blocks, all or nothing."""
        if n < 0:
            raise ValueError(f"alloc count must be >= 0, got {n}")
        if n > len(self._free):
            raise BlockOutOfMemory(
                f"host tier needs {n} blocks, {len(self._free)} free of {self.num_blocks}"
            )
        out = [self._free.pop() for _ in range(n)]
        self._used.update(out)
        return out

    def mark_dirty(self, ids: List[int]) -> None:
        """Mark host blocks as possibly poisoned: they are zeroed at free."""
        for i in ids:
            if i in self._used:
                self._dirty.add(i)

    def free(self, ids: List[int]) -> None:
        """Return host blocks to the free list, zeroing dirty ones first.
        Freeing an unallocated id is a hard error."""
        for i in ids:
            if i not in self._used:
                raise ValueError(f"host double free / foreign block: {i}")
            self._used.discard(i)
            if i in self._dirty:
                self._dirty.discard(i)
                for leaf in self.leaves.values():
                    leaf[:, i] = 0
            self._free.append(i)


class PrefixCache:
    """Content-addressed cache of full prompt blocks for cross-request
    sharing (see the module docstring).  The cache holds ONE allocator
    reference per cached block; :meth:`evict` releases cache-only blocks
    LRU-first when the allocator needs room.

    With a host tier attached (:meth:`attach_tier`), eviction **demotes** a
    clean cache-only block to the host tier instead of dropping it (its
    chain key moves to a host-side LRU map), and a lookup that walks onto a
    demoted key **promotes** it back into a fresh device block."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()  # LRU: oldest first
        self._by_block: Dict[int, bytes] = {}
        # Cache-only block count, kept incrementally so free_blocks stays O(1).
        self._reclaimable = 0
        # Host tier: chain key -> host block id, LRU oldest first.  A key
        # lives in exactly one of _entries / _host_entries.
        self._host_entries: "OrderedDict[bytes, int]" = OrderedDict()
        self._kv: Optional["PagedKVCache"] = None
        self.host_demotions = 0
        self.host_promotions = 0
        self.host_drops = 0  # evictions that dropped for want of host room
        allocator.attach_cache(self)

    def attach_tier(self, kv: "PagedKVCache") -> None:
        """Spill evictions to ``kv``'s host tier and promote them back on a
        lookup hit."""
        if kv.host is None:
            raise ValueError("attach_tier requires an enabled host tier")
        self._kv = kv

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

    @property
    def host_count(self) -> int:
        """Chain entries currently demoted to the host tier."""
        return len(self._host_entries)

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
                block = self._promote_entry(key)
            if block is None:
                break
            # Retain now: promoting the next key allocates, and that
            # allocation may evict an unretained earlier match.
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

    def _promote_entry(self, key: bytes) -> Optional[int]:
        """Bring a host-demoted chain entry back into a fresh device block
        (a device OOM is a miss); returns the block, or None when ``key`` is
        not on the host tier."""
        if self._kv is None:
            return None
        host_id = self._host_entries.get(key)
        if host_id is None:
            return None
        try:
            block = self.allocator.alloc(1)[0]
        except BlockOutOfMemory:
            return None
        self._kv.promote([host_id], [block])
        del self._host_entries[key]
        # The alloc's lone reference is now the cache's: reclaimable until
        # the caller retains it.
        self._entries[key] = block
        self._by_block[block] = key
        self._reclaimable += 1
        self.host_promotions += 1
        return block

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
        touched.  With a host tier, a clean victim is demoted first; it is
        dropped only when the tier is full or the block is dirty."""
        released = 0
        for key in list(self._entries):
            if released >= n:
                break
            block = self._entries[key]
            if self.allocator.refcount(block) != 1:
                continue
            if self._kv is not None:
                host_ids = (None if self.allocator.is_dirty(block)
                            else self._kv.try_demote([block]))
                if host_ids is not None:
                    self._host_entries[key] = host_ids[0]
                    self._host_entries.move_to_end(key)
                    self.host_demotions += 1
                else:
                    self.host_drops += 1
            del self._entries[key]
            del self._by_block[block]
            self._reclaimable -= 1
            self.allocator.free([block])
            released += 1
        return released

    def drop_host_entries(self, n: Optional[int] = None) -> int:
        """Free up to ``n`` host-demoted entries (all when None), least
        recently used first; returns how many were dropped."""
        dropped = 0
        for key in list(self._host_entries):
            if n is not None and dropped >= n:
                break
            self._kv.host.free([self._host_entries.pop(key)])
            dropped += 1
        return dropped

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
    batch-1 template (:func:`~accelerate_tpu_torch.models.generation.make_paged_pool`,
    fp and int8 layouts alike) and live on ``device``.  With
    ``num_host_blocks > 0`` (or :meth:`enable_host_tier`) a host tier of
    that many blocks sits beside it."""

    def __init__(self, init_cache: Callable, config, num_blocks: int, block_size: int, device,
                 num_host_blocks: int = 0):
        from ..models.generation import make_paged_pool

        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        self.allocator = BlockAllocator(num_blocks)
        self.pool: Dict[str, torch.Tensor] = make_paged_pool(
            init_cache, config, num_blocks, block_size, device
        )
        self.host: Optional[HostBlockPool] = None
        if num_host_blocks:
            self.enable_host_tier(num_host_blocks)

    def enable_host_tier(self, num_host_blocks: int) -> HostBlockPool:
        """Attach a host pool of ``num_host_blocks`` blocks with the device
        pool's leaf layout."""
        if self.host is not None:
            raise ValueError("host tier already enabled")
        self.host = HostBlockPool(self.pool, num_host_blocks)
        return self.host

    def host_can_fit(self, n: int) -> bool:
        """Whether a demotion of ``n`` blocks can be granted now.  False
        when no host tier is attached, when the tier lacks room, or when the
        ``SERVING_HOST_FULL`` fault arm forces the host-exhausted fallback
        paths for testing."""
        if self.host is None or self.host.free_blocks < n:
            return False
        from ..resilience import faultinject

        return not faultinject.serving_host_full()

    def demote(self, blocks: List[int]) -> List[int]:
        """Copy device ``blocks`` into fresh host blocks and return their
        ids, in order; the copy has landed when this returns.  The caller
        keeps its device references.  Raises :class:`BlockOutOfMemory` when
        the host tier cannot fit them."""
        from ..models.generation import demote_pool_blocks

        if not blocks:
            return []
        if not self.host_can_fit(len(blocks)):
            free = self.host.free_blocks if self.host is not None else 0
            cap = self.host.capacity if self.host is not None else 0
            raise BlockOutOfMemory(
                f"host tier cannot fit {len(blocks)} blocks ({free} free of {cap})"
            )
        host_ids = self.host.alloc(len(blocks))
        rows = demote_pool_blocks(self.pool, blocks)
        ids = torch.tensor(host_ids, dtype=torch.long)
        for name, leaf in self.host.leaves.items():
            leaf.index_copy_(1, ids, rows[name])
        return host_ids

    def try_demote(self, blocks: List[int]) -> Optional[List[int]]:
        """:meth:`demote`, or None when the host tier cannot fit."""
        if not self.host_can_fit(len(blocks)):
            return None
        return self.demote(blocks)

    def promote(self, host_ids: List[int], dst_blocks: List[int]) -> None:
        """Copy host blocks into the already-allocated device blocks
        ``dst_blocks`` and free the host ids once the copy has landed.
        The host rows are gathered into one staging tensor per leaf (pinned
        for a GPU pool) and copied from there."""
        from ..models.generation import promote_pool_blocks

        if len(host_ids) != len(dst_blocks):
            raise ValueError(
                f"promote id mismatch: {len(host_ids)} host vs {len(dst_blocks)} device"
            )
        if not host_ids:
            return
        if self.host is None:
            raise ValueError("promote without a host tier")
        ids = torch.tensor(host_ids, dtype=torch.long)
        rows = {}
        for name, leaf in self.host.leaves.items():
            shape = (leaf.shape[0], len(host_ids)) + tuple(leaf.shape[2:])
            staging = torch.empty(shape, dtype=leaf.dtype, pin_memory=leaf.is_pinned())
            rows[name] = torch.index_select(leaf, 1, ids, out=staging)
        promote_pool_blocks(self.pool, rows, dst_blocks)
        self.host.free(host_ids)

    def pool_bytes(self) -> int:
        return sum(leaf.numel() * leaf.element_size() for leaf in self.pool.values())

    def block_bytes(self) -> int:
        """Bytes of pool data behind ONE block across every leaf and layer."""
        num_blocks = next(iter(self.pool.values())).shape[1]
        return self.pool_bytes() // num_blocks
