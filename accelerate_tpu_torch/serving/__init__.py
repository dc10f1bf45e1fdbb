"""Serving layer of the port: continuous batching over a paged KV cache.

- ``blocks`` — the block pool, refcounting allocator and prefix cache;
- ``scheduler`` — admission queue, slot map, LIFO preemption;
- ``drafter`` — the n-gram drafter for speculative decode;
- ``engine`` — the engine: one prefill chunk and one decode forward per
  tick.

Entry point: :meth:`accelerate_tpu_torch.Accelerator.prepare_serving`, or
:class:`ServingEngine` built from a family's ``apply_cached``/``init_cache``.
"""

from .blocks import BlockAllocator, BlockOutOfMemory, PagedKVCache, PrefixCache
from .drafter import NgramDrafter
from .engine import AdmissionRejected, CompletedRequest, ServingConfig, ServingEngine
from .scheduler import Request, RequestState, Scheduler

__all__ = [
    "AdmissionRejected",
    "BlockAllocator",
    "BlockOutOfMemory",
    "CompletedRequest",
    "NgramDrafter",
    "PagedKVCache",
    "PrefixCache",
    "Request",
    "RequestState",
    "Scheduler",
    "ServingConfig",
    "ServingEngine",
]
