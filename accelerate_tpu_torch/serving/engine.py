"""The serving engine: continuous batching over the paged KV cache.

The PyTorch port of the JAX package's ``serving/engine.py``.  One engine
**tick** (:meth:`ServingEngine.step`) is:

1. **admit** — queue-head requests take free decode slots (FIFO), and reuse
   any cached prefix of their prompt (shared full blocks, a copy-on-write
   tail);
2. **prefill** — at most ONE chunk (``prefill_chunk`` tokens, padded to a
   fixed length) of the oldest prefilling request;
3. **decode** — ONE forward over every decode slot, advancing each by one
   token, or by up to ``spec_tokens + 1`` tokens when speculation is on
   (a verify window drafted on the host and checked in the same forward).

All three forwards are the family's ``apply_paged``: attention reads the
pool through per-slot block tables (bucketed to the next power of two of
the widest live slot), and only the freshly written K/V rows come back,
which the engine scatters into the pool **in place** — where the JAX
programs donate the pool and return an updated one.  With
``ServingConfig.paged_kernel`` the decode and verify attention run the
paged kernels of ``ops/paged_attention.py``; prefill attention is the plain
einsum path in either case.

Token selection is greedy, so every request's tokens are identical to the
offline greedy ``generate`` on the same prompt, whatever the batching,
preemption, prefix sharing or speculation.  A slot whose logits are not
finite completes as ``"quarantined"`` and its blocks are zeroed when their
last reference drops.

Not ported yet (their ``ServingConfig`` fields raise ``NotImplementedError``
when set off their defaults): the host-DRAM KV tier, the crash-recovery
journal, request tracing, queue bounds and deadlines, and the dense
gather-view decode path.  Telemetry, the memory ledger, fault injection and
the preemption guard are left out.
"""

from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.generation import scatter_token_rows, speculative_verify_greedy
from ..state import resolve_device
from .blocks import NULL_BLOCK, BlockOutOfMemory, PagedKVCache, PrefixCache, blocks_for_tokens
from .scheduler import Request, RequestState, Scheduler

__all__ = [
    "AdmissionRejected",
    "ServingConfig",
    "ServingEngine",
    "CompletedRequest",
]


class AdmissionRejected(RuntimeError):
    """Load-shedding rejection of the JAX engine's bounded admission queue.
    Queue bounds (``max_queue_depth``) are not ported yet, so the port's
    engine does not raise it."""


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

    Not ported yet, and raising ``NotImplementedError`` when set off their
    defaults: ``max_queue_depth``, ``default_ttft_deadline_ms``,
    ``default_deadline_ms``, ``journal_path``, ``host_blocks``, ``trace``,
    ``trace_dir`` and ``decode_path="dense"``.  ``tier_demote_batch`` only
    acts with a host tier.
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

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` for the fields this port lacks."""
        if self.decode_path not in ("paged", "dense"):
            raise ValueError(f"decode_path must be 'paged' or 'dense', got {self.decode_path!r}")
        unported = {
            "max_queue_depth": self.max_queue_depth is not None,
            "default_ttft_deadline_ms": self.default_ttft_deadline_ms is not None,
            "default_deadline_ms": self.default_deadline_ms is not None,
            "journal_path": self.journal_path is not None,
            "host_blocks": self.host_blocks != 0,
            "trace": bool(self.trace),
            "trace_dir": self.trace_dir is not None,
            "decode_path": self.decode_path != "paged",
        }
        for name, on in unported.items():
            if on:
                raise NotImplementedError(
                    f"ServingConfig.{name}={getattr(self, name)!r} is not ported to "
                    "accelerate_tpu_torch yet (see ROADMAP.md)"
                )


@dataclass
class CompletedRequest:
    """Completion record: the tokens (prompt + generated) plus the request's
    SLO timeline.  ``status`` is ``"ok"`` or ``"quarantined"``."""

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
    prefill_dispatches: int = 0


class ServingEngine:
    """Continuous-batching serving over a model family's
    ``apply_cached``/``init_cache`` pair; the family's module must also
    define ``apply_paged`` (the llama family does)::

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
        sc.check_ported()
        if sc.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {sc.prefill_chunk}")
        if sc.resolved_max_blocks() < 1:
            raise ValueError("max_blocks_per_seq must be >= 1")
        if sc.spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {sc.spec_tokens}")
        max_len = sc.resolved_max_blocks() * sc.block_size
        model_max = getattr(config, "max_seq_len", None)
        if model_max is not None and max_len > model_max:
            raise ValueError(
                f"max_blocks_per_seq * block_size = {max_len} exceeds the "
                f"model's max_seq_len {model_max}; shrink the table or blocks"
            )
        param_dev = params["embed"].device
        if param_dev.type != self.device.type:
            raise ValueError(f"params are on {param_dev}, the engine serves on {self.device}")
        self._paged_apply = getattr(inspect.getmodule(apply_cached), "apply_paged", None)
        if self._paged_apply is None:
            raise NotImplementedError(
                "the family has no apply_paged; the dense decode path is not ported yet"
            )
        self._config = config
        self.params = params
        self.spec_tokens = int(sc.spec_tokens)
        self.cache = PagedKVCache(init_cache, config, sc.num_blocks, sc.block_size, self.device)
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
        self._drafter = None
        if self.spec_tokens > 0:
            if drafter is None:
                from .drafter import NgramDrafter

                drafter = NgramDrafter(max_ngram=sc.spec_ngram_max, min_ngram=sc.spec_ngram_min)
            self._drafter = drafter
        self._block_bytes = self.cache.block_bytes()
        self._finished: List[CompletedRequest] = []
        self._decode_widths: set = set()
        self.decode_path = "paged"
        self.ticks = 0
        self.decode_dispatches = 0
        self.decode_emitted_tokens = 0
        self.decode_slot_ticks = 0
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.prefill_dispatches = 0
        self.quarantined_count = 0
        self.prefix_hits = 0
        self.prefix_blocks_reused = 0
        self.cow_copies = 0
        self.decode_gather_bytes = 0
        # Host seconds spent in the decode and prefill forwards, each up to
        # and including its one device synchronisation.
        self.decode_seconds = 0.0
        self.prefill_seconds = 0.0

    # -- forwards ------------------------------------------------------------
    #
    # Each returns host values, which is the tick's one synchronisation with
    # the device.  The pool is updated in place with the returned rows (the
    # JAX programs donate it and return a new one).

    @torch.no_grad()
    def _prefill_forward(self, table_row: np.ndarray, start: int, chunk: np.ndarray,
                         n_real: int):
        dev = self.device
        tables = torch.as_tensor(table_row[None], device=dev)
        starts = torch.tensor([start], dtype=torch.int32, device=dev)
        ids = torch.as_tensor(chunk, device=dev)
        logits, rows = self._paged_apply(
            self.params, ids, self._config, self.cache.pool, tables, starts
        )
        next_tok = logits[0, n_real - 1].argmax()
        ok = torch.isfinite(logits).all()
        for name, r in rows.items():
            scatter_token_rows(self.cache.pool[name], r, tables, starts, chunk.shape[1])
        tok, ok = torch.stack([next_tok, ok.long()]).tolist()
        return tok, bool(ok)

    @torch.no_grad()
    def _decode_forward(self, tables: np.ndarray, lengths: np.ndarray, tokens: np.ndarray,
                        draft_len: np.ndarray):
        """One decode (window 1) or verify (window k+1) forward over every
        slot: returns the target argmax per window position ``[S, W]``, the
        accepted draft count ``[S]`` and per-slot logit finiteness ``[S]``."""
        dev = self.device
        tables_t = torch.as_tensor(tables, device=dev)
        lengths_t = torch.as_tensor(lengths, device=dev)
        tokens_t = torch.as_tensor(tokens, device=dev)
        logits, rows = self._paged_apply(
            self.params, tokens_t, self._config, self.cache.pool, tables_t, lengths_t,
            kernel=self.serving.paged_kernel,
        )  # [S, W, V]
        t, m = speculative_verify_greedy(
            logits, tokens_t[:, 1:], torch.as_tensor(draft_len, device=dev)
        )
        ok = torch.isfinite(logits).all(-1).all(-1)
        for name, r in rows.items():
            scatter_token_rows(self.cache.pool[name], r, tables_t, lengths_t, tokens.shape[1])
        host = torch.cat([t, m[:, None], ok[:, None].to(torch.int32)], 1).cpu().numpy()
        return host[:, :-2], host[:, -2], host[:, -1].astype(bool)

    # -- request API ---------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int, arrival_t: Optional[float] = None, *,
               tag: Optional[str] = None) -> int:
        """Queue one request; returns its id.  ``max_new_tokens == 0``
        completes immediately.  Raises ``ValueError`` when the request's
        geometry can never be served."""
        req = Request(list(np.asarray(prompt_ids).reshape(-1)), max_new_tokens, arrival_t, tag=tag)
        if req.max_new_tokens == 0:
            req.state = RequestState.DONE
            req.admit_t = req.finish_t = time.monotonic()
            self._complete(req)
        else:
            self.sched.submit(req)
        return req.id

    def step(self) -> List[CompletedRequest]:
        """One engine tick: admit, one prefill chunk, one decode forward.
        Returns the requests that completed this tick."""
        now = time.monotonic()
        done_before = len(self._finished)
        self.ticks += 1
        self._drain_scrubs()
        for idx in self.sched.admit(now):
            self._attach_prefix(idx)
        self._prefill_tick()
        self._decode_tick()
        self._drain_scrubs()
        return self._finished[done_before:]

    def run(self, max_ticks: Optional[int] = None) -> Dict[int, List[int]]:
        """Tick until every submitted request completes; returns
        ``{request_id: full token list (prompt + generated)}``."""
        ticks = 0
        while not self.sched.idle():
            self.step()
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

    # -- quarantine ----------------------------------------------------------

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
        self._drain_scrubs(always_null=True)
        self.quarantined_count += 1
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
        the final chunk's logits are the next token."""
        if self._prefix is None:
            return
        slot = self.sched.slots[idx]
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
        """Block-table width: the next power of two covering
        ``blocks_needed``, capped at the configured maximum."""
        width = 1
        while width < blocks_needed:
            width *= 2
        return min(width, self.serving.resolved_max_blocks())

    @staticmethod
    def _table_row(blocks: List[int], width: int) -> np.ndarray:
        row = np.zeros((width,), np.int32)
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
        # Bucket the table to the chunk's padded write extent.
        width = self._bucket_width(blocks_for_tokens(start + chunk_len, self.serving.block_size))
        t0 = time.perf_counter()
        next_tok, ok = self._prefill_forward(
            self._table_row(slot.blocks, width), start, chunk, n_real
        )
        self.prefill_seconds += time.perf_counter() - t0
        self.prefill_dispatches += 1
        req.prefill_dispatches += 1
        slot.cache_len = start + n_real
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
        self.decode_gather_bytes += sum(len(sched.slots[i].blocks) for i in live) * self._block_bytes
        self._decode_widths.add(m)
        t0 = time.perf_counter()
        out, accepts, oks = self._decode_forward(tables, lengths, tokens, draft_len)
        self.decode_seconds += time.perf_counter() - t0
        self.decode_dispatches += 1
        emit_t = time.monotonic()
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

    # -- completion / metrics ------------------------------------------------

    def _emit(self, idx: int, token: int, now: float) -> None:
        req = self.sched.slots[idx].request
        req.emitted.append(token)
        req.note_token(now)
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
            prefill_dispatches=req.prefill_dispatches,
        ))

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
            "quarantined": self.quarantined_count,
            "pool_bytes": self.cache.pool_bytes(),
            "free_pool_bytes": alloc.free_blocks * self._block_bytes,
            "decode_path": self.decode_path,
            "decode_gather_bytes": self.decode_gather_bytes,
            "prefix_hits": self.prefix_hits,
            "prefix_blocks_reused": self.prefix_blocks_reused,
            "prefix_cow_copies": self.cow_copies,
            "prefix_cached_blocks": len(self._prefix) if self._prefix else 0,
            "decode_bucket_widths": sorted(self._decode_widths),
            "decode_s": self.decode_seconds,
            "prefill_s": self.prefill_seconds,
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
        }
