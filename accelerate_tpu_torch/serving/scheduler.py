"""Continuous-batching request scheduler: admission queue, slot map, preemption.

A copy of the JAX package's ``serving/scheduler.py`` with the same behaviour
for admission, LIFO preemption, chunked-prefill geometry, the speculative
overshoot, deadlines and the host-tier migration hook.

State machine per request::

    QUEUED --admit--> PREFILLING --last chunk--> DECODING --max_new reached--> DONE
       ^                  |                          |
       +---- preempt -----+------------ preempt ----+

A fixed number of **slots** (the decode dispatch's static batch axis) holds
the in-flight requests; new requests join as others finish.  When the
allocator runs dry mid-flight, the most recently admitted request is evicted
(LIFO — the oldest request always makes progress, so the policy cannot
livelock), its blocks are freed, and it re-enters the queue FRONT carrying
the tokens it already emitted.  Re-prefilling ``prompt + emitted`` rebuilds
the same cache, so preemption never changes a request's output.

With the engine's host tier on, preemption first offers the victim to the
``on_migrate_out`` hook, which copies its blocks to host memory; the
request then resumes from them on re-admission with no re-prefill.  The
free-and-re-prefill path is the fallback when the hook declines.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from enum import Enum
from typing import Callable, Deque, Dict, List, Optional

from .blocks import BlockAllocator, BlockOutOfMemory, blocks_for_tokens

__all__ = ["Request", "RequestState", "Scheduler"]


class RequestState(Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    DONE = "done"


class Request:
    """One serving request plus its lifecycle bookkeeping.  ``emitted``
    accumulates generated tokens across preemptions; the tokens a slot must
    (re)prefill are always ``prompt + emitted``.  ``ttft_deadline_ms``
    bounds the wait for the first token and ``deadline_ms`` the whole
    request, both from ``arrival_t``."""

    _ids = itertools.count()

    def __init__(self, prompt_ids: List[int], max_new_tokens: int,
                 arrival_t: Optional[float] = None, tag: Optional[str] = None,
                 ttft_deadline_ms: Optional[float] = None,
                 deadline_ms: Optional[float] = None):
        if max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
        if not prompt_ids:
            raise ValueError("empty prompt")
        self.id = next(Request._ids)
        self.prompt = [int(t) for t in prompt_ids]
        self.max_new_tokens = int(max_new_tokens)
        self.arrival_t = time.monotonic() if arrival_t is None else arrival_t
        self.tag = tag
        self.ttft_deadline_ms = ttft_deadline_ms
        self.deadline_ms = deadline_ms
        self.emitted: List[int] = []
        self.state = RequestState.QUEUED
        # SLO timeline (monotonic seconds; None until the event happens).
        self.admit_t: Optional[float] = None  # FIRST admission only
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = None
        self.last_token_t: Optional[float] = None
        self.inter_token_ms: List[float] = []
        self.preemptions = 0
        # Each re-queue after a preemption marks requeued_t; re-admission
        # moves the wait into requeue_waits_ms (first admission is admit_t).
        self.requeued_t: Optional[float] = None
        self.requeue_waits_ms: List[float] = []
        # Host-tier residency while re-queued after a migration: host block
        # ids in table order, the cache rows they hold and the prefix-cache
        # registration cursor; cleared on promotion or fallback.
        self.demoted_blocks: Optional[List[int]] = None
        self.demoted_rows = 0
        self.demoted_registered = 0
        # Prefill dispatches spent (a migrated resume adds none), host-tier
        # round trips survived, and preemptions that fell back to re-prefill.
        self.prefill_dispatches = 0
        self.migrations = 0
        self.fallback_reprefills = 0

    def pop_requeue_waits(self) -> List[float]:
        out, self.requeue_waits_ms = self.requeue_waits_ms, []
        return out

    def expired(self, now: float) -> Optional[str]:
        """``"deadline"`` or ``"ttft"`` when that deadline has passed (the
        total deadline first), else None."""
        elapsed_ms = (now - self.arrival_t) * 1e3
        if self.deadline_ms is not None and elapsed_ms > self.deadline_ms:
            return "deadline"
        if (self.ttft_deadline_ms is not None and self.first_token_t is None
                and elapsed_ms > self.ttft_deadline_ms):
            return "ttft"
        return None

    @property
    def to_feed(self) -> List[int]:
        return self.prompt + self.emitted

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.emitted)

    @property
    def output(self) -> List[int]:
        return self.to_feed

    def note_token(self, now: float) -> None:
        """Record one emitted token's latency sample (TTFT for the first,
        inter-token for the rest)."""
        if self.first_token_t is None:
            self.first_token_t = now
        elif self.last_token_t is not None:
            self.inter_token_ms.append((now - self.last_token_t) * 1e3)
        self.last_token_t = now


class _Slot:
    """One decode-batch lane: the bound request, its block table, how many
    cache rows have been written, and the prefix-cache registration cursor."""

    __slots__ = ("request", "blocks", "cache_len", "admit_seq", "registered_blocks")

    def __init__(self, request: Request, admit_seq: int):
        self.request = request
        self.blocks: List[int] = []
        self.cache_len = 0
        self.admit_seq = admit_seq
        self.registered_blocks = 0


class Scheduler:
    """Slot map + admission queue over a shared :class:`BlockAllocator`."""

    def __init__(self, allocator: BlockAllocator, num_slots: int, block_size: int,
                 max_blocks_per_seq: int, prefill_chunk: int, spec_overshoot: int = 0):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.allocator = allocator
        self.num_slots = num_slots
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.prefill_chunk = prefill_chunk
        self.spec_overshoot = max(int(spec_overshoot), 0)
        self.queue: Deque[Request] = deque()
        self.slots: Dict[int, _Slot] = {}  # slot index -> lane
        self._admit_seq = itertools.count()
        self.preempted_count = 0
        # Called with the evicted Request on every preemption.
        self.on_preempt: Optional[Callable[[Request], None]] = None
        # Offered the victim's slot before its blocks are freed; True means
        # the hook moved the KV to the host tier and released the device
        # references itself, False falls back to free-and-re-prefill.
        self.on_migrate_out: Optional[Callable[[_Slot], bool]] = None

    def max_rows(self, request: Request) -> int:
        """Worst-case cache rows the request ever needs: the prompt plus
        every generated token but the last, plus the speculative window's
        overshoot, rounded up to the prefill-chunk boundary a re-admission
        after maximal preemption would pad to."""
        rows = len(request.prompt) + max(request.max_new_tokens - 1, 0) + self.spec_overshoot
        return blocks_for_tokens(rows, self.prefill_chunk) * self.prefill_chunk

    def validate(self, request: Request) -> None:
        """Reject requests the engine geometry can never serve (otherwise a
        sole OOM-ing request would preempt itself forever)."""
        need = blocks_for_tokens(self.max_rows(request), self.block_size)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"request needs {need} blocks > max_blocks_per_seq "
                f"{self.max_blocks_per_seq} (prompt {len(request.prompt)} + "
                f"max_new {request.max_new_tokens}, block_size {self.block_size})"
            )
        if need > self.allocator.capacity:
            raise ValueError(
                f"request needs {need} blocks > pool capacity {self.allocator.capacity}"
            )

    def submit(self, request: Request) -> None:
        self.validate(request)
        self.queue.append(request)

    def free_slot_indices(self) -> List[int]:
        return [i for i in range(self.num_slots) if i not in self.slots]

    def admit(self, now: float) -> List[int]:
        """Move queue-head requests into free slots while blocks for their
        first prefill chunk are available.  FIFO order is preserved."""
        admitted = []
        for idx in self.free_slot_indices():
            if not self.queue:
                break
            head = self.queue[0]
            first_chunk = min(len(head.to_feed), self.prefill_chunk)
            if blocks_for_tokens(first_chunk, self.block_size) > self.allocator.free_blocks:
                break
            self.queue.popleft()
            head.state = RequestState.PREFILLING
            if head.admit_t is None:
                head.admit_t = now
            if head.requeued_t is not None:
                head.requeue_waits_ms.append((now - head.requeued_t) * 1e3)
                head.requeued_t = None
            self.slots[idx] = _Slot(head, next(self._admit_seq))
            admitted.append(idx)
        return admitted

    def cancel_queued(self, request: Request) -> None:
        """Remove a QUEUED request (deadline shed); the caller completes it.
        Raises ValueError when it is not queued."""
        self.queue.remove(request)

    def preempt_one(self) -> Optional[int]:
        """Evict the most recently admitted in-flight request (see
        :meth:`preempt_slot`).  Returns the freed slot index, or None when
        nothing is in flight."""
        if not self.slots:
            return None
        return self.preempt_slot(max(self.slots, key=lambda i: self.slots[i].admit_seq))

    def preempt_slot(self, idx: int) -> int:
        """Evict slot ``idx``: its blocks go to the host tier when the
        ``on_migrate_out`` hook takes them, else they are freed; either way
        the request re-enters the queue FRONT with its emitted tokens."""
        slot = self.slots.pop(idx)
        migrated = False
        if slot.blocks and self.on_migrate_out is not None:
            migrated = self.on_migrate_out(slot)
        if slot.blocks and not migrated:
            self.allocator.free(slot.blocks)
        req = slot.request
        req.state = RequestState.QUEUED
        req.preemptions += 1
        req.requeued_t = time.monotonic()
        self.preempted_count += 1
        self.queue.appendleft(req)
        if self.on_preempt is not None:
            self.on_preempt(req)
        return idx

    def grow_to(self, idx: int, rows: int) -> bool:
        """Ensure slot ``idx``'s block table covers ``rows`` cache rows,
        allocating (and preempting LIFO victims) as needed.  Returns False
        when the slot itself was preempted to satisfy the growth."""
        slot = self.slots.get(idx)
        while slot is not None:
            need = blocks_for_tokens(rows, self.block_size) - len(slot.blocks)
            if need <= 0:
                return True
            try:
                slot.blocks.extend(self.allocator.alloc(need))
                return True
            except BlockOutOfMemory as exc:
                if self.preempt_one() is None:
                    # Terminal pool exhaustion (nothing left to evict):
                    # snapshot the ranked memory ledger before the engine
                    # dies on this raise.
                    from ..telemetry.memledger import get_memory_ledger

                    get_memory_ledger().note_oom(
                        source="serving.admission", error=exc, slot=idx, rows=rows,
                        free_blocks=self.allocator.free_blocks,
                        capacity=self.allocator.capacity)
                    raise
                slot = self.slots.get(idx)  # self-preemption returns None
        return False

    def finish(self, idx: int, now: float) -> Request:
        """Release slot ``idx``; the request is complete."""
        slot = self.slots.pop(idx)
        if slot.blocks:
            self.allocator.free(slot.blocks)
        req = slot.request
        req.state = RequestState.DONE
        req.finish_t = now
        return req

    @property
    def active(self) -> int:
        return len(self.slots)

    @property
    def pending(self) -> int:
        return len(self.queue)

    def idle(self) -> bool:
        return not self.slots and not self.queue
