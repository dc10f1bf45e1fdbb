"""The serving engine: continuous batching over the paged KV cache.

The PyTorch port of the JAX package's ``serving/engine.py``.  One engine
**tick** (:meth:`ServingEngine.step`) is, in this order:

1. a **drain** instead of the tick once an installed preemption guard saw
   its signal (:meth:`ServingEngine.drain`);
2. **scrubs** of dirty blocks whose last reference dropped;
3. **deadlines** — expired queued requests are shed before any slot,
   prefill chunk or block is spent on them; expired in-flight ones are
   cancelled and their blocks freed (``status="deadline_expired"``);
4. **pressure relief** — below the headroom watermark, cold prefix-cache
   blocks move to the host tier before admission allocates;
5. **admit** — queue-head requests take free decode slots (FIFO); a
   request whose KV sits in the host tier is **promoted** back and resumes
   where it stopped, others reuse any cached prefix of their prompt;
6. **prefill** — at most ONE chunk (``prefill_chunk`` tokens, padded to a
   fixed length) of the oldest prefilling request;
7. **decode** — ONE forward over every decode slot, advancing each by one
   token, or by up to ``spec_tokens + 1`` tokens when speculation is on.

On the default ``decode_path="paged"`` all forwards are the family's
``apply_paged``: attention reads the pool through per-slot block tables
(bucketed to the next power of two of the widest live slot), and only the
freshly written K/V rows come back, which the engine scatters into the pool
**in place** — where the JAX programs donate the pool and return an updated
one.  With ``ServingConfig.paged_kernel`` the decode and verify attention of
an fp pool run the paged kernels of ``ops/paged_attention.py``; prefill and
int8 pools take the plain path.  ``decode_path="dense"`` (taken also when
the family has no ``apply_paged``) gathers each live slot's full-width view
of the pool and runs the family's ``apply_cached`` on it, one slot at a
time: the reference arm.

Token selection is greedy, so every request's tokens are identical to the
offline greedy ``generate`` on the same prompt, whatever the batching,
preemption, migration, prefix sharing or speculation.  A slot whose logits
are not finite completes as ``"quarantined"`` and its blocks are zeroed when
their last reference drops.

Robustness layer:

- ``max_queue_depth`` bounds the queue: ``submit`` past it raises
  :class:`AdmissionRejected`;
- per-request and default TTFT and total deadlines (step 3);
- ``host_blocks`` adds a host-memory tier: preemption copies the victim's
  blocks there instead of freeing them, re-admission copies them back with
  no re-prefill, evicted prefix blocks spill there, and the free-and-re-
  prefill path is the fallback when the tier is full;
- ``journal_path`` arms the write-ahead journal (``journal.py``): a
  successor engine's :meth:`ServingEngine.recover_from_journal` finishes
  every acknowledged request token-identically, even after a SIGKILL;
- :meth:`ServingEngine.install_preemption_guard` drains on a signal, and
  the requeue journal resubmits to a successor.

Per-request tracing (``tracing.py``) is on by default, as in the JAX
engine: every request's phase timeline (queue wait, prefill chunks, decode
and verify residency, preemptions, first dispatches at a table width),
blame per completed request in ``stats()["trace_blame"]``,
:meth:`ServingEngine.debug_requests` / :meth:`ServingEngine.debug_blocks`
snapshots and :meth:`ServingEngine.export_chrome_trace`.
``ACCELERATE_TPU_SERVING_TRACE=0`` turns it off unless
``ServingConfig.trace`` says otherwise.  With telemetry on, the engine
publishes the JAX engine's ``serving.*`` counters (pre-created at 0),
latency histograms and per-tick gauges, and its request-complete events; it
registers its pool as the ``serving.kv_pool`` reservation of the memory
ledger (the prefix-cache residents a subset of it, the host tier host
bytes) and itself as a source of the metrics endpoint's ``/debug`` pages.
Fault injection (:mod:`..resilience.faultinject`) reaches the engine at
two points: ``ACCELERATE_TPU_FAULT_SERVING_NAN_REQUEST=<n>`` multiplies the
``n``-th accepted request's logits by NaN on its first decode forward (a
per-slot device scale, resolved once at construction, so an unarmed engine
carries nothing), and ``ACCELERATE_TPU_FAULT_SERVING_HOST_FULL=1`` makes the
host tier refuse every demotion (``blocks.PagedKVCache.host_can_fit``).
``serving/chaos.py`` drives both.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.generation import (
    extract_token_rows,
    gather_block_view,
    scatter_token_rows,
    speculative_verify_greedy,
)
from ..state import resolve_device
from ..telemetry import get_telemetry
from .blocks import NULL_BLOCK, BlockOutOfMemory, PagedKVCache, PrefixCache, blocks_for_tokens
from .journal import JournalError, ServingJournal
from .scheduler import Request, RequestState, Scheduler
from .tracing import ServingTracer, resolve_trace_dir, tracing_enabled

__all__ = [
    "AdmissionRejected",
    "ServingConfig",
    "ServingEngine",
    "CompletedRequest",
]


class AdmissionRejected(RuntimeError):
    """Load shedding: the admission queue is at ``max_queue_depth``.  Not a
    ``ValueError``: the request was well formed, the engine is overloaded;
    callers retry with backoff or go elsewhere."""


@dataclass
class ServingConfig:
    """Engine geometry and policy; fields as in the JAX package.

    - ``block_size``: tokens per KV block; ``num_blocks``: pool size (block
      0 is the null block); ``max_slots``: the decode batch width;
      ``max_blocks_per_seq``: block-table width (default ``num_blocks - 1``);
      ``prefill_chunk``: prompt tokens per prefill forward.
    - ``paged_kernel``: run decode and verify attention through the paged
      kernels (``ops/paged_attention.py``) instead of the plain gather.
    - ``prefix_cache``: share full prompt blocks across requests by content.
    - ``spec_tokens``: speculative window ``k`` (0 disables);
      ``spec_ngram_max``/``spec_ngram_min``: match lengths of the default
      prompt-lookup drafter.
    - ``decode_path``: ``"paged"`` (through ``apply_paged``; ``"dense"``
      when the family has none) or ``"dense"`` (gathered views through
      ``apply_cached``, the reference arm).

    Robustness (host-side policy):

    - ``max_queue_depth``: queue bound; ``submit`` past it raises
      :class:`AdmissionRejected` (None: unbounded).
    - ``default_ttft_deadline_ms`` / ``default_deadline_ms``: deadlines of
      requests that pass none of their own (None: no deadline).
    - ``journal_path``: arm the write-ahead journal at this path.
    - ``host_blocks``: blocks of the host-memory KV tier (0: none).
    - ``tier_demote_batch``: the most cold prefix blocks moved to the host
      tier per tick while the device pool's free list is under the headroom
      watermark (``ACCELERATE_TPU_SERVING_HEADROOM_WATERMARK``, a fraction
      of the pool, default 0.1); 0 disables the sweep.

    Observability:

    - ``trace``: per-request phase tracing.  ``None`` (default) defers to
      ``ACCELERATE_TPU_SERVING_TRACE`` (default on; ``0`` turns it off).
    - ``trace_dir``: where trace JSONL persists; ``None`` defers to
      ``ACCELERATE_TPU_SERVING_TRACE_DIR``, else traces stay in memory.
    """

    block_size: int = 16
    num_blocks: int = 64
    max_slots: int = 4
    max_blocks_per_seq: Optional[int] = None
    prefill_chunk: int = 32
    max_queue_depth: Optional[int] = None
    default_ttft_deadline_ms: Optional[float] = None
    default_deadline_ms: Optional[float] = None
    journal_path: Optional[str] = None
    host_blocks: int = 0
    tier_demote_batch: int = 8
    decode_path: str = "paged"
    paged_kernel: bool = False
    prefix_cache: bool = True
    spec_tokens: int = 0
    spec_ngram_max: int = 3
    spec_ngram_min: int = 1
    trace: Optional[bool] = None
    trace_dir: Optional[str] = None

    def resolved_max_blocks(self) -> int:
        if self.max_blocks_per_seq is not None:
            return self.max_blocks_per_seq
        return self.num_blocks - 1


@dataclass
class CompletedRequest:
    """Completion record: the tokens (prompt + generated) plus the request's
    SLO timeline.  ``status`` is ``"ok"``, ``"deadline_expired"`` (the
    tokens emitted before expiry) or ``"quarantined"``.  ``migrations``
    counts the request's round trips through the host tier,
    ``fallback_reprefills`` its preemptions that re-prefilled for want of
    host room, and ``prefill_dispatches`` all its prefill chunks (a
    migrated resume adds none)."""

    id: int
    tokens: List[int]
    prompt_len: int
    new_tokens: int
    queue_wait_ms: float
    ttft_ms: Optional[float]
    mean_inter_token_ms: Optional[float]
    tokens_per_s: Optional[float]
    preemptions: int
    inter_token_ms: List[float] = field(default_factory=list)
    status: str = "ok"
    tag: Optional[str] = None
    migrations: int = 0
    fallback_reprefills: int = 0
    prefill_dispatches: int = 0


def _tensor_leaves(tree):
    """The tensors of a parameter tree (nested dicts), depth first."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensor_leaves(v)
        elif isinstance(v, torch.Tensor):
            yield v


class ServingEngine:
    """Continuous-batching serving over a model family's
    ``apply_cached``/``init_cache`` pair (fp or int8 KV); the paged path
    also uses the family module's ``apply_paged`` (the llama family has
    one)::

        engine = ServingEngine(llama.apply_cached, llama.init_cache, params, cfg,
                               serving=ServingConfig(max_slots=8))
        rid = engine.submit(prompt_tokens, max_new_tokens=64)
        outputs = engine.run()          # {rid: full token list}

    ``device`` defaults to ``cuda`` and raises without CUDA; pass
    ``device="cpu"`` to serve on the host.  ``params`` must already be on
    that device."""

    def __init__(self, apply_cached: Callable, init_cache: Callable, params, config,
                 serving: Optional[ServingConfig] = None, drafter=None, device=None):
        self.device = resolve_device(device)
        self.serving = serving or ServingConfig()
        sc = self.serving
        if sc.decode_path not in ("paged", "dense"):
            raise ValueError(f"decode_path must be 'paged' or 'dense', got {sc.decode_path!r}")
        if sc.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {sc.prefill_chunk}")
        if sc.resolved_max_blocks() < 1:
            raise ValueError("max_blocks_per_seq must be >= 1")
        if sc.spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {sc.spec_tokens}")
        if sc.host_blocks < 0:
            raise ValueError(f"host_blocks must be >= 0, got {sc.host_blocks}")
        max_len = sc.resolved_max_blocks() * sc.block_size
        model_max = getattr(config, "max_seq_len", None)
        if model_max is not None and max_len > model_max:
            raise ValueError(
                f"max_blocks_per_seq * block_size = {max_len} exceeds the "
                f"model's max_seq_len {model_max}; shrink the table or blocks"
            )
        # Any family's tree: the first tensor leaf names the device.
        param_dev = next(_tensor_leaves(params)).device
        if param_dev.type != self.device.type:
            raise ValueError(f"params are on {param_dev}, the engine serves on {self.device}")
        self._apply_cached = apply_cached
        self._paged_apply = None
        if sc.decode_path == "paged":
            self._paged_apply = getattr(inspect.getmodule(apply_cached), "apply_paged", None)
        self.decode_path = "paged" if self._paged_apply is not None else "dense"
        self._config = config
        self.params = params
        self.spec_tokens = int(sc.spec_tokens)
        self.cache = PagedKVCache(init_cache, config, sc.num_blocks, sc.block_size, self.device,
                                  num_host_blocks=sc.host_blocks)
        self.sched = Scheduler(
            self.cache.allocator,
            num_slots=sc.max_slots,
            block_size=sc.block_size,
            max_blocks_per_seq=sc.resolved_max_blocks(),
            prefill_chunk=sc.prefill_chunk,
            spec_overshoot=self.spec_tokens,
        )
        self._prefix: Optional[PrefixCache] = (
            PrefixCache(self.cache.allocator, sc.block_size) if sc.prefix_cache else None
        )
        if self.cache.host is not None:
            # Evicted prefix blocks spill to the host tier, and preemption
            # migrates the victim's KV there (the scheduler frees and
            # re-prefills when the hook declines).
            if self._prefix is not None:
                self._prefix.attach_tier(self.cache)
            self.sched.on_migrate_out = self._migrate_out
        # Per-request phase tracing.  Every preemption (drain, block
        # pressure, LIFO victim) goes through the scheduler's callback.
        self.tracer: Optional[ServingTracer] = None
        if tracing_enabled(sc.trace):
            self.tracer = ServingTracer(dir=resolve_trace_dir(sc.trace_dir))
            self.sched.on_preempt = lambda req: self.tracer.on_preempt(req, time.monotonic())
        # The table widths each program kind has dispatched at: a width not
        # seen yet marks the tick as the first at that shape (where the JAX
        # engine compiles).
        self._seen_widths: Dict[str, set] = {"decode": set(), "decode_spec": set(),
                                             "prefill": set()}
        self._drafter = None
        if self.spec_tokens > 0:
            if drafter is None:
                from .drafter import NgramDrafter

                drafter = NgramDrafter(max_ngram=sc.spec_ngram_max, min_ngram=sc.spec_ngram_min)
            self._drafter = drafter
        self.journal: Optional[ServingJournal] = (
            ServingJournal(sc.journal_path) if sc.journal_path else None
        )
        self._preemption_guard = None
        self._drained = False
        self._draining = False
        self._recovering = False
        self._submissions = 0
        # The NaN-request fault is resolved once: an unarmed engine's decode
        # forward multiplies nothing.  Armed, it keeps one persistent
        # per-slot logit scale on the device, set in place (NaN in the
        # poisoned slot for one forward, 1 elsewhere), so a captured decode
        # graph could hold it.
        from ..resilience import faultinject

        self._poison_ordinal = faultinject.serving_nan_ordinal()
        self._poison = None if self._poison_ordinal is None else torch.ones(
            (self.serving.max_slots,), dtype=torch.float32, device=self.device)
        self._poisoned: List[int] = []
        self.requeue_journal: Optional[List[dict]] = None
        try:
            self._headroom_watermark_frac = float(
                os.environ.get("ACCELERATE_TPU_SERVING_HEADROOM_WATERMARK", "") or 0.1
            )
        except ValueError:
            self._headroom_watermark_frac = 0.1
        # A pressure episode starts under the watermark and ends only once
        # the free share recovers above 1.5x it, so a pool hovering at the
        # line counts one episode, not one per tick.
        self._headroom_rearm_frac = min(self._headroom_watermark_frac * 1.5, 1.0)
        self._low_headroom = False
        self.low_headroom_episodes = 0
        self._block_bytes = self.cache.block_bytes()
        # Live /debug endpoints: the metrics server asks registered engines
        # for request/block snapshots (weakly: a collected engine drops off).
        from ..telemetry import export as _export

        _export.register_debug_source(self)
        # Memory ledger: the pool is a reservation for the engine's life, the
        # prefix-cache residents a subset entry (their bytes are INSIDE the
        # pool), the host tier host bytes.  The last engine built owns the
        # entries; weakref.finalize drops them when it is collected,
        # token-guarded so a successor's registration survives.
        from ..telemetry.memledger import get_memory_ledger

        ledger = get_memory_ledger()
        pool_token = ledger.register(
            "serving.kv_pool", tree=self.cache.pool,
            detail={"num_blocks": sc.num_blocks, "block_size": sc.block_size,
                    "block_bytes": self._block_bytes})
        prefix_token = ledger.register("serving.prefix_cache", nbytes=0,
                                       subset_of="serving.kv_pool")
        weakref.finalize(self, ledger.unregister, "serving.kv_pool", pool_token)
        weakref.finalize(self, ledger.unregister, "serving.prefix_cache", prefix_token)
        self._memledger_tokens = (pool_token, prefix_token)
        if self.cache.host is not None:
            host_token = ledger.register(
                "serving.kv_host", per_device={}, host_bytes=self.cache.host.pool_bytes(),
                detail={"host_blocks": sc.host_blocks, "block_size": sc.block_size,
                        "block_bytes": self._block_bytes})
            weakref.finalize(self, ledger.unregister, "serving.kv_host", host_token)
            self._memledger_tokens = (pool_token, prefix_token, host_token)
        self._preempted_published = 0
        self._prefix_demotions_published = 0
        self._prefix_promotions_published = 0
        self._finished: List[CompletedRequest] = []
        self.ticks = 0
        self.decode_dispatches = 0
        self.decode_emitted_tokens = 0
        self.decode_slot_ticks = 0
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.prefill_dispatches = 0
        self.shed_count = 0
        self.deadline_expired_count = 0
        self.quarantined_count = 0
        self.prefix_hits = 0
        self.prefix_blocks_reused = 0
        self.cow_copies = 0
        self.decode_gather_bytes = 0
        # Engine-side migrations; the prefix cache's own spills and
        # promotions are added in stats().
        self.tier_demotions = 0
        self.tier_promotions = 0
        self.tier_demoted_blocks = 0
        self.tier_fallback_reprefills = 0
        # Host seconds spent in the decode and prefill forwards, each up to
        # and including its one device synchronisation.
        self.decode_seconds = 0.0
        self.prefill_seconds = 0.0
        # The robustness and fast-path counters exist at 0 from the first
        # scrape, so a dashboard can alert on rate() before any incident.
        tel = get_telemetry()
        if tel.enabled:
            for name in (
                "serving.shed", "serving.deadline_expired",
                "serving.quarantined", "serving.journal_recoveries",
                "serving.prefix_hits", "serving.prefix_blocks_reused",
                "serving.prefix_cow_copies", "serving.decode_gather_bytes",
                "serving.spec.proposed", "serving.spec.accepted",
                "serving.spec.rounds",
                "serving.tier.demotions", "serving.tier.promotions",
                "serving.tier.demoted_blocks", "serving.tier.fallback_reprefills",
            ):
                tel.registry.counter(name)
            tel.registry.gauge("serving.spec.acceptance_rate").set(0.0)
            tel.registry.gauge("serving.tokens_per_dispatch").set(0.0)
            tel.registry.gauge("serving.tier.host_bytes").set(0)
            tel.registry.gauge("serving.tier.host_occupancy").set(0.0)

    # -- forwards ------------------------------------------------------------
    #
    # Each returns host values, which is the tick's one synchronisation with
    # the device.  The pool is updated in place with the returned rows (the
    # JAX programs donate it and return a new one).

    def _dense_forward(self, table_row: np.ndarray, start: int, ids: torch.Tensor):
        """One slot through the family's ``apply_cached`` on the dense view
        gathered through its full-width table; the rows it wrote go back
        into the pool.  Returns its logits ``[1, T, V]``."""
        dev = self.device
        tables = torch.as_tensor(table_row[None], device=dev)
        starts = torch.tensor([start], dtype=torch.int32, device=dev)
        view = {n: gather_block_view(leaf, tables)[0] for n, leaf in self.cache.pool.items()}
        logits, view = self._apply_cached(self.params, ids, self._config,
                                          dict(view, index=int(start)))
        t = ids.shape[1]
        for n, leaf in self.cache.pool.items():
            rows = extract_token_rows(view[n][None], starts, t)
            scatter_token_rows(leaf, rows, tables, starts, t)
        return logits

    @torch.no_grad()
    def _prefill_forward(self, table_row: np.ndarray, start: int, chunk: np.ndarray,
                         n_real: int):
        dev = self.device
        ids = torch.as_tensor(chunk, device=dev)
        if self.decode_path == "dense":
            logits = self._dense_forward(table_row, start, ids)
        else:
            tables = torch.as_tensor(table_row[None], device=dev)
            starts = torch.tensor([start], dtype=torch.int32, device=dev)
            logits, rows = self._paged_apply(
                self.params, ids, self._config, self.cache.pool, tables, starts
            )
            for name, r in rows.items():
                scatter_token_rows(self.cache.pool[name], r, tables, starts, chunk.shape[1])
        next_tok = logits[0, n_real - 1].argmax()
        ok = torch.isfinite(logits).all()
        tok, ok = torch.stack([next_tok, ok.long()]).tolist()
        return tok, bool(ok)

    def _arm_poison(self, live: List[int]) -> None:
        """Ready the persistent per-slot scale for this forward: the slots
        the last forward poisoned back to 1, then NaN in the slot of each
        request whose poison is pending (each fires once)."""
        for idx in self._poisoned:
            self._poison[idx] = 1.0
        self._poisoned = []
        for idx in live:
            req = self.sched.slots[idx].request
            if getattr(req, "_poison_pending", False):
                req._poison_pending = False
                self._poison[idx] = float("nan")
                self._poisoned.append(idx)

    @torch.no_grad()
    def _decode_forward(self, tables: np.ndarray, lengths: np.ndarray, tokens: np.ndarray,
                        draft_len: np.ndarray, live: List[int]):
        """One decode (window 1) or verify (window k+1) forward over the
        slots: returns the target argmax per window position ``[S, W]``, the
        accepted draft count ``[S]`` and per-slot logit finiteness ``[S]``
        (rows of slots not in ``live`` are meaningless)."""
        dev = self.device
        tokens_t = torch.as_tensor(tokens, device=dev)
        draft_t = torch.as_tensor(draft_len, device=dev)
        poison = self._poison
        if poison is not None:
            self._arm_poison(live)
        if self.decode_path == "dense":
            # One slot at a time: the port's apply_cached takes one write
            # index per call.
            logits = torch.stack([
                self._dense_forward(tables[i], int(lengths[i]), tokens_t[i:i + 1])[0]
                for i in live
            ])  # [n_live, W, V]
            sel = torch.as_tensor(live, device=dev)
            if poison is not None:
                logits = logits * poison[sel][:, None, None]
            t, m = speculative_verify_greedy(logits, tokens_t[sel, 1:], draft_t[sel])
            ok = torch.isfinite(logits).all(-1).all(-1)
            part = torch.cat([t, m[:, None], ok[:, None].to(torch.int32)], 1).cpu().numpy()
            host = np.zeros((tokens.shape[0], part.shape[1]), part.dtype)
            host[live] = part
        else:
            tables_t = torch.as_tensor(tables, device=dev)
            lengths_t = torch.as_tensor(lengths, device=dev)
            logits, rows = self._paged_apply(
                self.params, tokens_t, self._config, self.cache.pool, tables_t, lengths_t,
                kernel=self.serving.paged_kernel,
            )  # [S, W, V]
            if poison is not None:
                logits = logits * poison[:, None, None]
            t, m = speculative_verify_greedy(logits, tokens_t[:, 1:], draft_t)
            ok = torch.isfinite(logits).all(-1).all(-1)
            for name, r in rows.items():
                scatter_token_rows(self.cache.pool[name], r, tables_t, lengths_t, tokens.shape[1])
            host = torch.cat([t, m[:, None], ok[:, None].to(torch.int32)], 1).cpu().numpy()
        return host[:, :-2], host[:, -2], host[:, -1].astype(bool)

    # -- request API ---------------------------------------------------------

    def install_preemption_guard(self, guard) -> None:
        """Drain on a preemption signal: once ``guard`` (a
        :class:`~accelerate_tpu_torch.resilience.PreemptionGuard`) has seen
        its signal, the next :meth:`step` runs :meth:`drain` instead of a
        tick."""
        if self._drained:
            raise RuntimeError(
                "engine already drained: the requeue journal is final and admission is "
                "closed; build a successor engine instead of re-arming this one"
            )
        self._preemption_guard = guard

    @property
    def drained(self) -> bool:
        return self._drained

    def submit(self, prompt_ids, max_new_tokens: int, arrival_t: Optional[float] = None, *,
               tag: Optional[str] = None, ttft_deadline_ms: Optional[float] = None,
               deadline_ms: Optional[float] = None) -> int:
        """Queue one request; returns its id.  ``max_new_tokens == 0``
        completes immediately.  Deadlines default from the
        :class:`ServingConfig` (None means the default).  ``tag`` is carried
        into the :class:`CompletedRequest` and the journal: the request's
        identity across a recovery, where ids change.

        Raises :class:`AdmissionRejected` when the queue is at
        ``max_queue_depth``, ``ValueError`` when the request's geometry can
        never be served, and ``RuntimeError`` once the engine drained."""
        if self._drained:
            raise RuntimeError(
                "engine drained after a preemption signal: admission is closed and the "
                "requeue journal is final; resubmit to a successor engine "
                "(see engine.requeue_journal)"
            )
        sc = self.serving
        if (sc.max_queue_depth is not None and not self._recovering
                and self.sched.pending >= sc.max_queue_depth):
            self.shed_count += 1
            tel = get_telemetry()
            if tel.enabled:
                tel.registry.counter("serving.shed").inc()
            raise AdmissionRejected(
                f"admission queue full ({self.sched.pending} >= max_queue_depth "
                f"{sc.max_queue_depth}): request shed"
            )
        req = Request(
            list(np.asarray(prompt_ids).reshape(-1)), max_new_tokens, arrival_t, tag=tag,
            ttft_deadline_ms=(ttft_deadline_ms if ttft_deadline_ms is not None
                              else sc.default_ttft_deadline_ms),
            deadline_ms=deadline_ms if deadline_ms is not None else sc.default_deadline_ms,
        )
        if req.max_new_tokens == 0:
            req.state = RequestState.DONE
            req.admit_t = req.finish_t = time.monotonic()
        else:
            self.sched.submit(req)  # geometry validation may reject: count after
        self._submissions += 1
        if self._poison_ordinal is not None and self._submissions == self._poison_ordinal:
            req._poison_pending = True  # fires on this request's first decode
        # Write-ahead: on disk before the id is returned.
        if self.journal is not None:
            self.journal.record_admit(req)
        if self.tracer is not None:
            self.tracer.on_submit(req)
        tel = get_telemetry()
        if tel.enabled:
            tel.registry.counter("serving.requests").inc()
        if req.state == RequestState.DONE:
            self._complete(req)
        return req.id

    def step(self) -> List[CompletedRequest]:
        """One engine tick (see the module docstring for its order).
        Returns the requests that completed this tick; a drain returns
        none."""
        now = time.monotonic()
        done_before = len(self._finished)
        if self._drained or self._drain_requested():
            self.drain()
            return []
        self.ticks += 1
        if self.tracer is not None:
            self.tracer.begin_tick(now)
        self._drain_scrubs()
        self._expire_deadlines(now)
        self._pressure_relief()
        admitted = self.sched.admit(now)
        if self.tracer is not None:
            admit_t = time.monotonic()
            for idx in admitted:
                self.tracer.on_admit(self.sched.slots[idx].request, admit_t, idx)
        for idx in admitted:
            # A migrated victim comes back from the host tier first;
            # _attach_prefix then leaves its slot alone.
            self._promote_admitted(idx)
        for idx in admitted:
            self._attach_prefix(idx)
        self._observe_requeue_waits(admitted)
        self._prefill_tick()
        self._decode_tick()
        self._drain_scrubs()
        if self.tracer is not None:
            self.tracer.end_tick(time.monotonic(), self.sched.slots)
        self._publish_gauges()
        return self._finished[done_before:]

    def run(self, max_ticks: Optional[int] = None) -> Dict[int, List[int]]:
        """Tick until every submitted request completes; returns
        ``{request_id: full token list (prompt + generated)}``.  A drain
        ends the loop early: incomplete requests are in
        :attr:`requeue_journal`."""
        ticks = 0
        while not self.sched.idle():
            self.step()
            if self._drained:
                break
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                raise RuntimeError(
                    f"engine did not drain within {max_ticks} ticks "
                    f"(active {self.sched.active}, queued {self.sched.pending})"
                )
        return {c.id: c.tokens for c in self._finished}

    def pop_finished(self) -> List[CompletedRequest]:
        out, self._finished = self._finished, []
        return out

    def _drain_requested(self) -> bool:
        guard = self._preemption_guard
        return guard is not None and guard.should_stop()

    def drain(self) -> List[dict]:
        """Graceful drain: close admission, preempt every in-flight slot
        back to the queue (blocks freed, emitted tokens carried, the oldest
        request at the front), release the host tier, and return the
        requeue journal of the incomplete requests (also kept in
        :attr:`requeue_journal` and, with a journal, their progress on
        disk).  Idempotent."""
        if self._drained:
            return self.requeue_journal or []
        # Host memory dies with the process: no migration past this line,
        # and queued victims give their host blocks back.
        self._draining = True
        while self.sched.slots:
            self.sched.preempt_one()
        for req in self.sched.queue:
            self._release_demoted(req)
        journal = [
            {
                "id": req.id,
                "prompt": list(req.prompt),
                "emitted": list(req.emitted),
                "remaining": req.remaining,
                "preemptions": req.preemptions,
                "tag": req.tag,
            }
            for req in self.sched.queue
        ]
        self._drained = True
        self.requeue_journal = journal
        self._drain_scrubs()
        if self.journal is not None:
            self.journal.record_progress(self.sched.queue)
        tel = get_telemetry()
        if tel.enabled:
            tel.registry.counter("serving.drains").inc()
            tel.event("serving.drained", incomplete=len(journal),
                      completed=len(self._finished), journal=journal)
        if self.tracer is not None:
            # The successor's stitcher needs this life's partial timelines.
            self.tracer.flush()
        self._publish_gauges()
        return journal

    # -- crash recovery ------------------------------------------------------

    def recover_from_journal(self, path: Optional[str] = None) -> Dict[int, int]:
        """Resubmit every request of a dead engine's journal that has no
        terminal record, as ``prompt + emitted`` with the remaining budget,
        so this engine finishes each token-identically.  Returns ``{old id:
        new id}``.  Call it before the first ``submit`` when this engine
        journals to the same path.  The queue bound does not apply to
        recovered requests, and the whole batch lands in the journal in one
        flush; deadlines restart from now."""
        path = path or self.serving.journal_path
        if path is None:
            raise ValueError("no journal path: pass one or set ServingConfig.journal_path")
        if (self.journal is not None and self.journal.flushed
                and os.path.abspath(path) == os.path.abspath(self.journal.path)):
            raise JournalError(
                f"this engine already overwrote the journal at {path!r}; "
                "recover_from_journal must run before the first submit"
            )
        state = ServingJournal.load(path)
        mapping: Dict[int, int] = {}
        batch = self.journal.deferred() if self.journal is not None else contextlib.nullcontext()
        self._recovering = True
        try:
            with batch:
                for rec in ServingJournal.pending(state):
                    emitted = rec.get("emitted") or []
                    rid = self.submit(
                        rec["prompt"] + list(emitted),
                        rec["max_new_tokens"] - len(emitted),
                        tag=rec.get("tag"),
                        ttft_deadline_ms=rec.get("ttft_deadline_ms"),
                        deadline_ms=rec.get("deadline_ms"),
                    )
                    mapping[rec["id"]] = rid
                    if self.tracer is not None:
                        self.tracer.on_recover(rid, rec)
        finally:
            self._recovering = False
        if self.tracer is not None:
            self.tracer.flush()
        tel = get_telemetry()
        if tel.enabled:
            tel.registry.counter("serving.journal_recoveries").inc()
            tel.event("serving.journal_recovered", path=path, recovered=len(mapping),
                      terminal=len(state["done"]))
        return mapping

    # -- host tier -----------------------------------------------------------

    def _count_fallback(self, req: Request) -> None:
        req.fallback_reprefills += 1
        self.tier_fallback_reprefills += 1
        tel = get_telemetry()
        if tel.enabled:
            tel.registry.counter("serving.tier.fallback_reprefills").inc()

    def _migrate_out(self, slot) -> bool:
        """The scheduler's ``on_migrate_out`` hook: copy the victim's blocks
        to the host tier, release the device references and park the host
        ids and resume state on the request.  Declines during a drain, when
        a block is quarantine-dirty (it must be rebuilt clean), or when the
        tier cannot fit the blocks even after dropping cold prefix
        entries."""
        req = slot.request
        blocks = slot.blocks
        if self._draining or not blocks:
            return False
        alloc = self.cache.allocator
        if any(alloc.is_dirty(b) for b in blocks):
            self._count_fallback(req)
            return False
        n = len(blocks)
        if not self.cache.host_can_fit(n) and self._prefix is not None:
            need = n - self.cache.host.free_blocks
            if 0 < need <= self._prefix.host_count:
                self._prefix.drop_host_entries(need)  # a live request outranks a cold prefix
        if not self.cache.host_can_fit(n):
            self._count_fallback(req)
            return False
        req.demoted_blocks = self.cache.demote(blocks)
        req.demoted_rows = slot.cache_len
        req.demoted_registered = slot.registered_blocks
        req.migrations += 1
        alloc.free(blocks)
        self.tier_demotions += 1
        self.tier_demoted_blocks += n
        tel = get_telemetry()
        if tel.enabled:
            tel.registry.counter("serving.tier.demotions").inc()
            tel.registry.counter("serving.tier.demoted_blocks").inc(n)
        if self.journal is not None:
            self.journal.record_tier(req, "host")
        return True

    def _promote_admitted(self, idx: int) -> None:
        """Bring a re-admitted migration victim's KV back from the host tier
        and restore its slot as preemption found it: ``cache_len``, the
        registration cursor, and DECODING when only the last emitted token's
        row is unwritten, so the resume spends no prefill dispatch.  Without
        device room it falls back to the re-prefill (host blocks freed)."""
        slot = self.sched.slots.get(idx)
        if slot is None:
            return
        req = slot.request
        host_ids = req.demoted_blocks
        if not host_ids:
            return
        try:
            dst = self.cache.allocator.alloc(len(host_ids))
        except BlockOutOfMemory:
            self._release_demoted(req)
            self._count_fallback(req)
            if self.journal is not None:
                self.journal.record_tier(req, "device")
            return
        self.cache.promote(host_ids, dst)
        slot.blocks = dst
        slot.cache_len = req.demoted_rows
        slot.registered_blocks = req.demoted_registered
        req.demoted_blocks = None
        req.demoted_rows = 0
        req.demoted_registered = 0
        if req.emitted and slot.cache_len == len(req.to_feed) - 1:
            req.state = RequestState.DECODING
        self.tier_promotions += 1
        tel = get_telemetry()
        if tel.enabled:
            tel.registry.counter("serving.tier.promotions").inc()
        if self.journal is not None:
            self.journal.record_tier(req, "device")

    def _release_demoted(self, req: Request, dirty: bool = False) -> None:
        """Free a request's host blocks (expiry of a queued victim, promotion
        fallback, drain, quarantine); ``dirty`` zeroes them on the way."""
        if req.demoted_blocks:
            if dirty:
                self.cache.host.mark_dirty(req.demoted_blocks)
            self.cache.host.free(req.demoted_blocks)
        req.demoted_blocks = None
        req.demoted_rows = 0
        req.demoted_registered = 0

    def _pressure_relief(self) -> None:
        """Under the headroom watermark (the device pool's raw free list, not
        counting reclaimable cache blocks, as a share of its capacity), move
        up to ``tier_demote_batch`` cold prefix blocks to the host tier
        before admission allocates.  The order under pressure: demote,
        drop (host full), migrate a victim, free and re-prefill it."""
        if self._prefix is None or self.cache.host is None or self.serving.tier_demote_batch <= 0:
            return
        alloc = self.cache.allocator
        raw_free = alloc.free_blocks - self._prefix.reclaimable_count
        if raw_free / max(alloc.capacity, 1) >= self._headroom_watermark_frac:
            return
        reclaim = min(self.serving.tier_demote_batch, self._prefix.reclaimable_count)
        if reclaim > 0:
            self._prefix.evict(reclaim)

    def _publish_gauges(self) -> None:
        """Count low-headroom episodes (one starts when the pool's free share
        falls under the watermark and ends once it is back above 1.5x it)
        and, with telemetry on, publish the per-tick gauges, the serving
        headroom, a ``memory.low_headroom`` event per episode, and the
        tier and preemption counts since the last publish."""
        alloc = self.cache.allocator
        free_frac = alloc.free_blocks / max(alloc.capacity, 1)
        entered = False
        if free_frac < self._headroom_watermark_frac:
            if not self._low_headroom:
                self._low_headroom = True
                self.low_headroom_episodes += 1
                entered = True
        elif self._low_headroom and free_frac >= self._headroom_rearm_frac:
            self._low_headroom = False
        tel = get_telemetry()
        if not tel.enabled:
            return
        reg = tel.registry
        reg.gauge("serving.active_slots").set(self.sched.active)
        reg.gauge("serving.queue_depth").set(self.sched.pending)
        reg.gauge("serving.blocks_used").set(alloc.used_blocks)
        reg.gauge("serving.block_occupancy").set(round(alloc.occupancy, 4))
        reg.gauge("serving.prefix_cache_blocks").set(
            len(self._prefix) if self._prefix is not None else 0)
        reg.gauge("serving.spec.acceptance_rate").set(
            round(self.spec_accepted / max(self.spec_proposed, 1), 4))
        # Per slot-lane, not per dispatch: 1.0 is plain greedy decoding,
        # above it the accepted drafts.
        reg.gauge("serving.tokens_per_dispatch").set(
            round(self.decode_emitted_tokens / max(self.decode_slot_ticks, 1), 4))
        # The prefix-cache residents' bytes (a subset of the pool) and the
        # serving headroom: free pool bytes, clamped by the device's measured
        # headroom when a reconcile has read it.
        from ..telemetry.memledger import get_memory_ledger

        ledger = get_memory_ledger()
        prefix_blocks = len(self._prefix) if self._prefix is not None else 0
        ledger.update_bytes("serving.prefix_cache", prefix_blocks * self._block_bytes,
                            token=self._memledger_tokens[1])
        headroom = alloc.free_blocks * self._block_bytes
        device_free = ledger.min_device_headroom()
        if device_free is not None:
            headroom = min(headroom, device_free)
        reg.gauge("serving.headroom_bytes").set(headroom)
        if entered:
            tel.event("memory.low_headroom", source="serving", headroom_bytes=headroom,
                      free_blocks=alloc.free_blocks, capacity=alloc.capacity,
                      watermark_frac=self._headroom_watermark_frac)
        # The host tier's occupancy, and the prefix cache's own demotions
        # and promotions (inside allocator eviction, out of counter reach)
        # folded into the tier counters as deltas.
        host = self.cache.host
        if host is not None:
            reg.gauge("serving.tier.host_bytes").set(host.used_bytes())
            reg.gauge("serving.tier.host_occupancy").set(round(host.occupancy, 4))
            if self._prefix is not None:
                d = self._prefix.host_demotions - self._prefix_demotions_published
                if d > 0:
                    reg.counter("serving.tier.demotions").inc(d)
                    reg.counter("serving.tier.demoted_blocks").inc(d)
                self._prefix_demotions_published = self._prefix.host_demotions
                p = self._prefix.host_promotions - self._prefix_promotions_published
                if p > 0:
                    reg.counter("serving.tier.promotions").inc(p)
                self._prefix_promotions_published = self._prefix.host_promotions
        # Only the preemptions since the last publish: a registry reset must
        # not be re-inflated with the engine's whole history.
        new_preempted = self.sched.preempted_count - self._preempted_published
        if new_preempted > 0:
            reg.counter("serving.preempted").inc(new_preempted)
        self._preempted_published = self.sched.preempted_count

    def _observe_requeue_waits(self, admitted: List[int]) -> None:
        """The re-queue waits of just-(re)admitted requests into
        ``serving.requeue_wait_ms`` (a preempted request's wait for its next
        admission, which the first admission's ``queue_wait_ms`` misses)."""
        tel = get_telemetry()
        if not tel.enabled:
            return
        hist = tel.registry.histogram("serving.requeue_wait_ms")
        for idx in admitted:
            slot = self.sched.slots.get(idx)
            if slot is None:
                continue
            for sample in slot.request.pop_requeue_waits():
                hist.observe(sample)

    # -- deadlines and quarantine --------------------------------------------

    def _expire_deadlines(self, now: float) -> None:
        """Shed expired queued requests and cancel expired in-flight ones
        (blocks freed, slot returned)."""
        for req in [r for r in self.sched.queue if r.expired(now)]:
            self.sched.cancel_queued(req)
            self._finish_expired(req, now)
        for idx in list(self.sched.slots):
            req = self.sched.slots[idx].request
            if req.expired(now):
                self.sched.finish(idx, now)
                self._finish_expired(req, now)

    def _finish_expired(self, req: Request, now: float) -> None:
        self._release_demoted(req)
        req.state = RequestState.DONE
        req.finish_t = now
        self.deadline_expired_count += 1
        tel = get_telemetry()
        if tel.enabled:
            tel.registry.counter("serving.deadline_expired").inc()
            if req.first_token_t is None:
                # The violation feeds the TTFT histogram, so the SLO burn
                # rate sees the expired requests, not only the survivors.
                tel.registry.histogram("serving.ttft_ms").observe((now - req.arrival_t) * 1e3)
        self._complete(req, status="deadline_expired")

    def _quarantine(self, idx: int, now: float) -> None:
        """A slot's logits came back non-finite: complete its request as
        ``"quarantined"`` and mark its blocks for a zero-scrub on last
        release (``0 * NaN = NaN`` in ``probs @ v``, so a NaN row left in a
        recycled block would poison its next owner)."""
        slot = self.sched.slots[idx]
        if self._prefix is not None:
            self._prefix.invalidate_blocks(slot.blocks)
        self.cache.allocator.mark_dirty(slot.blocks)
        req = self.sched.finish(idx, now)
        self._release_demoted(req, dirty=True)
        self._drain_scrubs(always_null=True)
        self.quarantined_count += 1
        tel = get_telemetry()
        if tel.enabled:
            tel.registry.counter("serving.quarantined").inc()
            tel.event("serving.quarantined", request=req.id, tag=req.tag,
                      emitted=len(req.emitted), prompt_len=len(req.prompt))
        self._complete(req, status="quarantined")

    def _drain_scrubs(self, always_null: bool = False) -> None:
        """Zero the dirty blocks whose last reference dropped and hand them
        back to the free list.  The null block is zeroed with them: padded
        prefill rows of a poisoned request land there."""
        pending = self.cache.allocator.pop_pending_scrub()
        if pending or always_null:
            idx = torch.tensor(sorted(set(pending) | {NULL_BLOCK}), device=self.device)
            for leaf in self.cache.pool.values():
                leaf[:, idx] = 0
            self.cache.allocator.finish_scrub(pending)

    # -- prefix cache --------------------------------------------------------

    def _attach_prefix(self, idx: int) -> None:
        """On admission, reuse the cached prefix of the slot's feed: matched
        full blocks are shared into the slot's table, a reusable partial
        tail is copied into a private block, and ``cache_len`` starts past
        the shared rows.  At least one feed token is always left to process:
        the final chunk's logits are the next token.  A promoted slot
        already owns its table and is left alone."""
        if self._prefix is None:
            return
        slot = self.sched.slots.get(idx)
        if slot is None or slot.blocks:
            return
        feed = slot.request.to_feed
        max_rows = len(feed) - 1
        if max_rows < self.serving.block_size:
            return
        blocks, rows, cow_src = self._prefix.lookup(feed, max_rows)
        reused = registered = len(blocks)
        if cow_src is not None:
            try:
                dst = self.cache.allocator.alloc(1)[0]
            except BlockOutOfMemory:
                dst = None  # prefill the tail instead of copying it
            if dst is not None:
                for leaf in self.cache.pool.values():
                    leaf[:, dst] = leaf[:, cow_src]
                blocks.append(dst)
                rows = max_rows
                reused += 1
                self.cow_copies += 1
            self.cache.allocator.free([cow_src])  # the lookup's temporary reference
        if not blocks:
            return
        slot.blocks = blocks
        slot.cache_len = rows
        slot.registered_blocks = registered
        self.prefix_hits += 1
        self.prefix_blocks_reused += reused
        tel = get_telemetry()
        if tel.enabled:
            tel.registry.counter("serving.prefix_hits").inc()
            tel.registry.counter("serving.prefix_blocks_reused").inc(reused)
            if rows > registered * self.serving.block_size:
                tel.registry.counter("serving.prefix_cow_copies").inc()

    def _register_prefix_blocks(self, idx: int) -> None:
        """Publish the slot's freshly prefilled FULL blocks under their chain
        hashes; only blocks entirely below ``cache_len`` count."""
        if self._prefix is None:
            return
        slot = self.sched.slots[idx]
        bs = self.serving.block_size
        feed = slot.request.to_feed
        full = min(slot.cache_len, len(feed)) // bs
        if full <= slot.registered_blocks:
            return
        keys = PrefixCache.chain_keys(feed, bs, limit=full)
        for i in range(slot.registered_blocks, full):
            self._prefix.register(keys[i], slot.blocks[i])
        slot.registered_blocks = full

    # -- tick phases ---------------------------------------------------------

    def _bucket_width(self, blocks_needed: int) -> int:
        """Block-table width of the paged path: the next power of two
        covering ``blocks_needed``, capped at the configured maximum.  The
        dense path always takes the maximum."""
        if self.decode_path == "dense":
            return self.serving.resolved_max_blocks()
        width = 1
        while width < blocks_needed:
            width *= 2
        return min(width, self.serving.resolved_max_blocks())

    def _note_bucket(self, kind: str, width: Optional[int]) -> bool:
        """Record a dispatch of ``kind`` at this table width; True when it is
        the first in this engine's life (the dense path keys on its one
        width).  The JAX engine compiles on exactly these dispatches, and
        the tracer marks them ``compile_in_path`` in both packages."""
        key = width if width is not None else self.serving.resolved_max_blocks()
        if key in self._seen_widths[kind]:
            return False
        self._seen_widths[kind].add(key)
        tel = get_telemetry()
        if tel.enabled:
            # "dispatch", not "kind": event() reserves "kind" for the record.
            tel.event("serving.bucket_compile", dispatch=kind, width=key)
        return True

    def _table_row(self, blocks: List[int], width: Optional[int] = None) -> np.ndarray:
        row = np.zeros((width or self.serving.resolved_max_blocks(),), np.int32)
        row[:len(blocks)] = blocks
        return row

    def _prefill_tick(self) -> None:
        sched = self.sched
        candidates = [
            (slot.admit_seq, idx) for idx, slot in sched.slots.items()
            if slot.request.state == RequestState.PREFILLING
        ]
        if not candidates:
            return
        _, idx = min(candidates)
        slot = sched.slots[idx]
        req = slot.request
        feed = req.to_feed
        start = slot.cache_len
        chunk_len = self.serving.prefill_chunk
        n_real = min(chunk_len, len(feed) - start)
        if not sched.grow_to(idx, start + n_real):
            return  # the slot itself was preempted to find blocks
        chunk = np.zeros((1, chunk_len), np.int32)
        chunk[0, :n_real] = feed[start:start + n_real]
        width = None
        if self.decode_path == "paged":
            # Bucket the table to the chunk's padded write extent.
            width = self._bucket_width(
                blocks_for_tokens(start + chunk_len, self.serving.block_size))
        fresh = self._note_bucket("prefill", width)
        t0 = time.perf_counter()
        next_tok, ok = self._prefill_forward(
            self._table_row(slot.blocks, width), start, chunk, n_real
        )
        self.prefill_seconds += time.perf_counter() - t0
        self.prefill_dispatches += 1
        req.prefill_dispatches += 1
        tel = get_telemetry()
        if tel.enabled:
            tel.registry.counter("serving.prefill_dispatches").inc()
        slot.cache_len = start + n_real
        if self.tracer is not None:
            self.tracer.on_prefill(req, idx, time.monotonic(), padded_rows=chunk_len - n_real,
                                   width=width, fresh=fresh)
        if not ok:
            self._quarantine(idx, time.monotonic())
            return
        self._register_prefix_blocks(idx)
        if slot.cache_len == len(feed):
            # Final chunk: its last real logits row IS the next token.
            self._emit(idx, next_tok, time.monotonic())
            if idx in sched.slots:
                sched.slots[idx].request.state = RequestState.DECODING

    def _decode_tick(self) -> None:
        sched = self.sched
        decoding = sorted(
            (idx for idx, slot in sched.slots.items()
             if slot.request.state == RequestState.DECODING),
            key=lambda i: sched.slots[i].admit_seq,
        )
        # Drafts come before block growth: with speculation on, every decode
        # tick is a k+1 window whose rows are written for EVERY live slot.
        # A draft never exceeds remaining-1, so the position after the last
        # accepted draft can still be emitted.
        k = self.spec_tokens
        drafts: Dict[int, List[int]] = {}
        if k > 0:
            for idx in decoding:
                req = sched.slots[idx].request
                want = min(k, req.remaining - 1)
                if want > 0:
                    d = self._drafter.propose(req.to_feed, want)
                    if d:
                        drafts[idx] = [int(t) for t in d[:want]]
        window = k + 1
        # Grow oldest-first so older requests take blocks from younger ones
        # (matching the LIFO victim policy), then re-collect the survivors.
        for idx in decoding:
            if idx in sched.slots and sched.slots[idx].request.state == RequestState.DECODING:
                sched.grow_to(idx, sched.slots[idx].cache_len + window)
        live = [
            idx for idx in decoding
            if idx in sched.slots and sched.slots[idx].request.state == RequestState.DECODING
        ]
        if not live:
            return
        s = self.serving.max_slots
        m = self._bucket_width(max(len(sched.slots[idx].blocks) for idx in live))
        tables = np.zeros((s, m), np.int32)
        lengths = np.zeros((s,), np.int32)
        tokens = np.zeros((s, window), np.int32)
        draft_len = np.zeros((s,), np.int32)
        for idx in live:
            slot = sched.slots[idx]
            tables[idx] = self._table_row(slot.blocks, m)
            lengths[idx] = slot.cache_len
            tokens[idx, 0] = slot.request.emitted[-1]
            d = drafts.get(idx)
            if d:
                tokens[idx, 1:1 + len(d)] = d
                draft_len[idx] = len(d)
        # The dense path gathers each live slot's full-width view.
        gathered = (len(live) * m if self.decode_path == "dense"
                    else sum(len(sched.slots[i].blocks) for i in live))
        self.decode_gather_bytes += gathered * self._block_bytes
        fresh = self._note_bucket("decode_spec" if window > 1 else "decode", m)
        dispatch_t0 = time.monotonic()
        t0 = time.perf_counter()
        out, accepts, oks = self._decode_forward(tables, lengths, tokens, draft_len, live)
        self.decode_seconds += time.perf_counter() - t0
        self.decode_dispatches += 1
        tel = get_telemetry()
        if tel.enabled:
            tel.registry.counter("serving.decode_dispatches").inc()
            tel.registry.counter("serving.decode_gather_bytes").inc(gathered * self._block_bytes)
            tel.registry.gauge("serving.decode_bucket_width").set(m)
        emit_t = time.monotonic()
        if self.tracer is not None:
            # emit_t is past the forward's device synchronisation.
            self.tracer.on_decode(
                [(sched.slots[idx].request, idx) for idx in live], emit_t,
                co_batch=len(live), width=m, fresh=fresh,
                dispatch_ms=(emit_t - dispatch_t0) * 1e3,
                phase="verify" if window > 1 else "decode",
            )
        proposed = accepted = healthy = 0
        for idx in live:
            slot = sched.slots[idx]
            req = slot.request
            # The emitted chunk is t[:count], count = accepted drafts + the
            # correction/bonus row, capped at remaining; cache_len advances
            # by count and rows past it are rewritten before they are read.
            count = min(int(accepts[idx]) + 1, req.remaining)
            slot.cache_len += count
            if not oks[idx]:
                self._quarantine(idx, emit_t)
                continue
            healthy = 1
            proposed += int(draft_len[idx])
            accepted += int(accepts[idx])
            self.decode_emitted_tokens += count
            self.decode_slot_ticks += 1
            for j in range(count):
                self._emit(idx, int(out[idx, j]), emit_t)
        if k > 0 and healthy:
            # rounds counts verify dispatches with at least one healthy lane.
            self.spec_rounds += 1
            self.spec_proposed += proposed
            self.spec_accepted += accepted
            if tel.enabled:
                tel.registry.counter("serving.spec.rounds").inc()
                if proposed:
                    tel.registry.counter("serving.spec.proposed").inc(proposed)
                if accepted:
                    tel.registry.counter("serving.spec.accepted").inc(accepted)

    # -- completion / metrics ------------------------------------------------

    def _emit(self, idx: int, token: int, now: float) -> None:
        req = self.sched.slots[idx].request
        req.emitted.append(token)
        req.note_token(now)
        tel = get_telemetry()
        if tel.enabled:
            tel.registry.counter("serving.tokens").inc()
            if len(req.emitted) == 1 and req.arrival_t is not None:
                tel.registry.histogram("serving.ttft_ms").observe((now - req.arrival_t) * 1e3)
            elif req.inter_token_ms:
                tel.registry.histogram("serving.inter_token_ms").observe(req.inter_token_ms[-1])
        if req.remaining == 0:
            self.sched.finish(idx, now)
            self._complete(req)

    def _complete(self, req: Request, status: str = "ok") -> None:
        ttft_ms = None
        if req.first_token_t is not None:
            ttft_ms = (req.first_token_t - req.arrival_t) * 1e3
        queue_wait_ms = (req.admit_t - req.arrival_t) * 1e3 if req.admit_t is not None else 0.0
        mean_itl = (
            sum(req.inter_token_ms) / len(req.inter_token_ms) if req.inter_token_ms else None
        )
        tps = None
        if (
            req.finish_t is not None
            and req.first_token_t is not None
            and req.finish_t > req.first_token_t
            and len(req.emitted) > 1
        ):
            tps = (len(req.emitted) - 1) / (req.finish_t - req.first_token_t)
        self._finished.append(CompletedRequest(
            id=req.id,
            tokens=req.output,
            prompt_len=len(req.prompt),
            new_tokens=len(req.emitted),
            queue_wait_ms=queue_wait_ms,
            ttft_ms=ttft_ms,
            mean_inter_token_ms=mean_itl,
            tokens_per_s=tps,
            preemptions=req.preemptions,
            inter_token_ms=list(req.inter_token_ms),
            status=status,
            tag=req.tag,
            migrations=req.migrations,
            fallback_reprefills=req.fallback_reprefills,
            prefill_dispatches=req.prefill_dispatches,
        ))
        if self.journal is not None:
            self.journal.record_done(req.id, status)
        tel = get_telemetry()
        if tel.enabled:
            reg = tel.registry
            reg.counter("serving.completed").inc()
            reg.histogram("serving.queue_wait_ms").observe(queue_wait_ms)
            if tps is not None:
                reg.histogram("serving.tokens_per_s").observe(tps)
            tel.event(
                "serving.request_complete", request=req.id, tag=req.tag, status=status,
                prompt_len=len(req.prompt), new_tokens=len(req.emitted),
                ttft_ms=round(ttft_ms, 3) if ttft_ms is not None else None,
                queue_wait_ms=round(queue_wait_ms, 3), preemptions=req.preemptions,
            )
        if self.tracer is not None:
            self.tracer.on_terminal(req, status)

    # -- introspection -------------------------------------------------------

    def debug_requests(self) -> List[dict]:
        """Snapshot of every slotted and queued request: state, age and,
        with tracing on, its phase-so-far decomposition.  Host reads only."""
        now = time.monotonic()
        out = []
        seen = set()
        for idx, slot in sorted(self.sched.slots.items()):
            seen.add(slot.request.id)
            out.append(self._debug_request(slot.request, now, slot=idx))
        for req in self.sched.queue:
            if req.id not in seen:
                out.append(self._debug_request(req, now, slot=None))
        return out

    def _debug_request(self, req: Request, now: float, slot: Optional[int]) -> dict:
        rec = {
            "id": req.id,
            "tag": req.tag,
            "state": req.state.name,
            "slot": slot,
            "age_ms": round((now - req.arrival_t) * 1e3, 3),
            "prompt_len": len(req.prompt),
            "emitted": len(req.emitted),
            "max_new": req.max_new_tokens,
            "preemptions": req.preemptions,
        }
        if self.tracer is not None:
            rec["trace"] = self.tracer.snapshot_request(req.id, now)
        return rec

    def debug_blocks(self) -> dict:
        """Pool snapshot: occupancy, per-block refcounts (shared prefix
        blocks show more than 1), each slot's table, the prefix cache's LRU
        chain and the host tier."""
        alloc = self.cache.allocator
        out = {
            "capacity": alloc.capacity,
            "free": alloc.free_blocks,
            "used": alloc.used_blocks,
            "occupancy": round(alloc.occupancy, 4),
            "pending_scrub": sorted(alloc._pending_scrub),
            "refcounts": {str(b): n for b, n in sorted(alloc._ref.items()) if n > 0},
            "slots": {
                str(idx): {"request": slot.request.id, "blocks": list(slot.blocks),
                           "cache_len": slot.cache_len}
                for idx, slot in sorted(self.sched.slots.items())
            },
        }
        if self._prefix is not None:
            out["prefix_cache"] = {
                "blocks": len(self._prefix),
                "reclaimable": self._prefix.reclaimable_count,
                # LRU order, oldest first, with live refcounts.
                "chain": [{"block": b, "refcount": alloc.refcount(b)}
                          for b in self._prefix._entries.values()],
            }
            if self.cache.host is not None:
                out["prefix_cache"]["host_entries"] = self._prefix.host_count
        host = self.cache.host
        if host is not None:
            out["host_tier"] = {
                "capacity": host.capacity,
                "free": host.free_blocks,
                "used": host.used_blocks,
                "occupancy": round(host.occupancy, 4),
                "demoted_requests": {str(req.id): len(req.demoted_blocks or ())
                                     for req in self.sched.queue if req.demoted_blocks},
            }
        return out

    def export_chrome_trace(self, path: str) -> str:
        """Write every traced request (the completed ring and the live ones)
        as a Chrome/Perfetto trace (``tracing.export_chrome_trace``)."""
        from .tracing import export_chrome_trace

        if self.tracer is None:
            raise RuntimeError("tracing is disabled on this engine")
        return export_chrome_trace(path, self.tracer.traces())

    def _tier_stats(self) -> Optional[dict]:
        host = self.cache.host
        if host is None:
            return None
        spilled = self._prefix.host_demotions if self._prefix else 0
        return {
            "host_blocks": host.capacity,
            "host_used": host.used_blocks,
            "host_free": host.free_blocks,
            "host_occupancy": round(host.occupancy, 4),
            "host_bytes": host.used_bytes(),
            "demotions": self.tier_demotions + spilled,
            "promotions": self.tier_promotions
            + (self._prefix.host_promotions if self._prefix else 0),
            "demoted_blocks": self.tier_demoted_blocks + spilled,
            "fallback_reprefills": self.tier_fallback_reprefills,
            "prefix_host_entries": self._prefix.host_count if self._prefix else 0,
            "prefix_host_drops": self._prefix.host_drops if self._prefix else 0,
        }

    def stats(self) -> dict:
        alloc = self.cache.allocator
        return {
            "ticks": self.ticks,
            "decode_dispatches": self.decode_dispatches,
            "prefill_dispatches": self.prefill_dispatches,
            "active_slots": self.sched.active,
            "queue_depth": self.sched.pending,
            "blocks_used": alloc.used_blocks,
            "block_occupancy": round(alloc.occupancy, 4),
            "completed": len(self._finished),
            "preempted": self.sched.preempted_count,
            "shed": self.shed_count,
            "deadline_expired": self.deadline_expired_count,
            "quarantined": self.quarantined_count,
            "pool_bytes": self.cache.pool_bytes(),
            "free_pool_bytes": alloc.free_blocks * self._block_bytes,
            "low_headroom_episodes": self.low_headroom_episodes,
            "decode_path": self.decode_path,
            "decode_gather_bytes": self.decode_gather_bytes,
            "prefix_hits": self.prefix_hits,
            "prefix_blocks_reused": self.prefix_blocks_reused,
            "prefix_cow_copies": self.cow_copies,
            "prefix_cached_blocks": len(self._prefix) if self._prefix else 0,
            "decode_bucket_widths": sorted(self._seen_widths["decode"]),
            "decode_s": self.decode_seconds,
            "prefill_s": self.prefill_seconds,
            "journal_flushes": self.journal.flushes if self.journal else 0,
            "journal_flush_s": self.journal.flush_seconds if self.journal else 0.0,
            "spec": {
                "window": self.spec_tokens,
                "rounds": self.spec_rounds,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "acceptance_rate": round(self.spec_accepted / max(self.spec_proposed, 1), 4),
                "tokens_per_dispatch": round(
                    self.decode_emitted_tokens / max(self.decode_slot_ticks, 1), 4
                ),
            },
            "tiering": self._tier_stats(),
            "trace_blame": (dict(self.tracer.blame_counts) if self.tracer is not None
                            else None),
        }
