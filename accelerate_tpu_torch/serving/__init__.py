"""Serving layer of the port: continuous batching over a paged KV cache.

- ``blocks`` — the block pool, refcounting allocator, prefix cache and the
  host tier (``HostBlockPool``);
- ``scheduler`` — admission queue, slot map, LIFO preemption, deadlines and
  the migration hook;
- ``drafter`` — the n-gram and draft-model drafters for speculative decode;
- ``journal`` — the crash-recovery write-ahead journal;
- ``tracing`` — per-request phase traces, blame, Chrome export and the
  offline loader, stitcher and summary;
- ``engine`` — the engine: one prefill chunk and one decode forward per
  tick, with queue bounds, deadlines, quarantine, the host tier, graceful
  drain, journal recovery and tracing (on by default).

Entry point: :meth:`accelerate_tpu_torch.Accelerator.prepare_serving`, or
:class:`ServingEngine` built from a family's ``apply_cached``/``init_cache``.
"""

from .blocks import BlockAllocator, BlockOutOfMemory, HostBlockPool, PagedKVCache, PrefixCache
from .drafter import DraftModelDrafter, NgramDrafter
from .engine import AdmissionRejected, CompletedRequest, ServingConfig, ServingEngine
from .journal import JournalError, ServingJournal
from .scheduler import Request, RequestState, Scheduler
from .tracing import (
    RequestTrace,
    ServingTracer,
    export_chrome_trace,
    load_serving_traces,
    stitch_traces,
    summarize_traces,
)

__all__ = [
    "AdmissionRejected",
    "BlockAllocator",
    "BlockOutOfMemory",
    "CompletedRequest",
    "DraftModelDrafter",
    "HostBlockPool",
    "JournalError",
    "NgramDrafter",
    "PagedKVCache",
    "PrefixCache",
    "Request",
    "RequestState",
    "RequestTrace",
    "Scheduler",
    "ServingConfig",
    "ServingEngine",
    "ServingJournal",
    "ServingTracer",
    "export_chrome_trace",
    "load_serving_traces",
    "stitch_traces",
    "summarize_traces",
]
