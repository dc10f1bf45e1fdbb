"""Serving layer of the port: continuous batching over a paged KV cache.

- ``blocks`` — the block pool, refcounting allocator, prefix cache and the
  host tier (``HostBlockPool``);
- ``scheduler`` — admission queue, slot map, LIFO preemption, deadlines and
  the migration hook;
- ``drafter`` — the n-gram drafter for speculative decode;
- ``journal`` — the crash-recovery write-ahead journal;
- ``engine`` — the engine: one prefill chunk and one decode forward per
  tick, with queue bounds, deadlines, quarantine, the host tier, graceful
  drain and journal recovery.

Entry point: :meth:`accelerate_tpu_torch.Accelerator.prepare_serving`, or
:class:`ServingEngine` built from a family's ``apply_cached``/``init_cache``.
"""

from .blocks import BlockAllocator, BlockOutOfMemory, HostBlockPool, PagedKVCache, PrefixCache
from .drafter import NgramDrafter
from .engine import AdmissionRejected, CompletedRequest, ServingConfig, ServingEngine
from .journal import JournalError, ServingJournal
from .scheduler import Request, RequestState, Scheduler

__all__ = [
    "AdmissionRejected",
    "BlockAllocator",
    "BlockOutOfMemory",
    "CompletedRequest",
    "HostBlockPool",
    "JournalError",
    "NgramDrafter",
    "PagedKVCache",
    "PrefixCache",
    "Request",
    "RequestState",
    "Scheduler",
    "ServingConfig",
    "ServingEngine",
    "ServingJournal",
]
