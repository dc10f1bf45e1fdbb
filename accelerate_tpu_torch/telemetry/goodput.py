"""Goodput accounting: a wall-clock attribution ledger for the whole run.

Every other observability layer answers *how* the run is doing (telemetry),
*what* happened (flight recorder), or *why a step was slow* (profile scan).
None of them answers the first question a fleet operator asks: **what
fraction of wall-clock time actually advanced training, and which subsystem
burned the rest?**  The :class:`GoodputLedger` answers it by classifying
every second of the run into exactly ONE category:

- ``productive`` — fused-step compute that advanced training
  (``pipeline.train_step`` spans, minus everything below);
- ``compile`` — kernel builds (``nvcc``; the telemetry compile listener);
- ``checkpoint`` — save/restore/publish wall time plus checkpoint-I/O retry
  backoff waits (``checkpoint.*`` / ``resilience.final_checkpoint`` /
  ``health.rewind`` spans, ``resilience.retry`` waits on I/O labels);
- ``rewind_replay`` — steps that computed but did NOT advance training: the
  zero-delta steps the health gate skipped, and the steps re-run after a
  NaN rewind (badput even though the device was busy);
- ``input_wait`` — host/input-blocked time (``dataloader.next_batch`` spans:
  batch conversion, device placement, prefetch queue waits);
- ``device_acquire`` — device-acquisition retry backoff (retry waits whose
  label names a device/acquire path, or whose error is RESOURCE_EXHAUSTED)
  and OOM-driven batch-size halvings;
- ``preempt`` — drain downtime after a preemption signal (everything after
  ``resilience.preempt_signal`` not claimed by a category above);
- ``idle`` — the unattributed remainder (Python overhead, logging, eval,
  anything uninstrumented).

The ledger is **sourced from the existing instrumentation** — it subscribes
to the telemetry record stream (spans, compile records, ``event()`` markers)
via :meth:`observe_record`, so nothing on the hot path is re-instrumented.
Overlaps resolve by a fixed precedence sweep (a compile inside a train-step
span is ``compile``, not ``productive``), which is what makes the
**conservation invariant** hold by construction: the per-category seconds sum
to the elapsed wall-clock window within float ε, and no second is counted
twice.  ``summary()['conservation_error_s']`` exposes the residual.

**Fault markers** ride along: badput-narrating events (preempt signals,
checkpoint-I/O retries/give-ups, OOM, health skips/rewinds) are tallied per
category in ``summary()['markers']`` — the chaos campaign's acceptance
oracle checks each injected fault class lands in its correct category.

Offline mode: :func:`ledger_from_records` / :func:`summary_from_records`
replay a telemetry JSONL stream (the same one ``telemetry.report`` loads),
so a dead run's goodput is computable post-hoc and ``telemetry.report
--json`` carries a stable ``goodput`` top-level key.

Fleet aggregation: :class:`FleetAggregator` finally wires the sentinel's
``observe_host_step`` / ``straggler_report`` hooks into the train loop — at
a bounded, call-count-gated cadence (lockstep, like
``PreemptionGuard.should_stop``) it gathers per-host step durations and
local goodput fractions over the existing multi-host gather path, feeds the
sentinel, publishes fleet goodput = **min over hosts**, and names stragglers
as ``sentinel.straggler`` events that ``telemetry.report`` renders.

Enable live with ``ACCELERATE_TPU_GOODPUT=1`` (rides telemetry enablement)
or :func:`attach`.  Default-off, like every other telemetry layer.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from .sentinel import AnomalySentinel

__all__ = [
    "CATEGORIES",
    "BADPUT_CATEGORIES",
    "GoodputLedger",
    "FleetAggregator",
    "attach",
    "attached",
    "detach",
    "get_ledger",
    "ledger_from_records",
    "summary_from_records",
    "ENV_GOODPUT",
]

ENV_GOODPUT = "ACCELERATE_TPU_GOODPUT"

_TRUTHY = {"1", "true", "yes", "on"}

# Attribution precedence, highest first.  ``preempt`` and ``idle`` are
# background categories: they claim whatever the interval sweep left
# unattributed (after/before the preemption mark respectively), which is
# exactly why the categories always sum to the elapsed window.
CATEGORIES = (
    "compile",
    "checkpoint",
    "device_acquire",
    "input_wait",
    "rewind_replay",
    "productive",
    "preempt",
    "idle",
)
BADPUT_CATEGORIES = tuple(c for c in CATEGORIES if c != "productive")

_N_FOREGROUND = 6  # compile..productive carry explicit intervals

_CAT_INDEX = {name: i for i, name in enumerate(CATEGORIES)}

# Span name -> category.  Nested checkpoint spans (publish, write_manifest,
# verify) are deliberately absent: their parents already claim the window and
# same-category nesting would only bloat the sweep.  ``health.rewind`` wraps
# the checkpoint restore, so it is checkpoint time; the *replayed* steps after
# it are claimed by the rewind-replay budget instead.
_SPAN_CATEGORY = {
    "checkpoint.save_state": "checkpoint",
    "checkpoint.load_state": "checkpoint",
    "resilience.final_checkpoint": "checkpoint",
    "health.rewind": "checkpoint",
    "dataloader.next_batch": "input_wait",
}

_STEP_SPAN = "pipeline.train_step"

# Retry labels that mean "fighting for a device", not checkpoint I/O.
_ACQUIRE_MARKERS = ("device", "acquire", "oom")


def _retry_category(label: str, error: str) -> str:
    text = (label or "").lower()
    if any(m in text for m in _ACQUIRE_MARKERS) or "RESOURCE_EXHAUSTED" in (error or ""):
        return "device_acquire"
    return "checkpoint"


class GoodputLedger:
    """Interval-based wall-clock attribution with a precedence sweep.

    Thread-safe: records arrive from the main thread, the watchdog, and the
    prefetcher.  ``summary()`` may be called at any time; the window runs
    from construction (or ``start_t``) to ``now``.
    """

    # Fold fully-swept intervals into scalar totals once the tail grows past
    # this — keeps summary() O(bounded) on multi-day runs.  The compaction
    # boundary trails ``now`` by a margin so late-arriving intervals (a retry
    # wait recorded before its sleep) still land in the live tail.
    COMPACT_AT = 4096
    COMPACT_MARGIN_S = 60.0

    def __init__(self, start_t: Optional[float] = None):
        self.start_t = float(start_t if start_t is not None else time.time())
        self._lock = threading.Lock()
        # [category_index, t0, t1] — foreground attribution claims.  Lists,
        # not tuples: a health.skip reclassifies its step's interval IN PLACE
        # via a direct object reference, which stays valid across the
        # compaction rebuilds below (an index would go stale).
        self._intervals: List[list] = []
        self._compacted_upto = self.start_t
        self._compacted = {name: 0.0 for name in CATEGORIES}
        self._markers = {}
        # Steps re-run after a health rewind are badput: each rewind event
        # adds (step - resumed_step) to this budget and the next that-many
        # train-step spans classify as rewind_replay instead of productive.
        self._replay_budget = 0
        # The last productive step interval (object reference), so a
        # health.skip event (the zero-delta step that just "computed" for
        # nothing) can reclassify it.  Cleared when compaction folds it —
        # skips arrive milliseconds after their span, far inside the
        # COMPACT_MARGIN_S tail, so the degradation is theoretical.
        self._last_step_interval: Optional[list] = None
        self.preempt_from: Optional[float] = None

    # -- ingestion -----------------------------------------------------------

    def note_interval(self, category: str, t0: float, t1: float) -> None:
        """Claim ``[t0, t1]`` for ``category`` (foreground categories only)."""
        idx = _CAT_INDEX[category]
        if idx >= _N_FOREGROUND:
            raise ValueError(f"{category!r} is a background category — it is derived, not claimed")
        if t1 <= t0:
            return
        with self._lock:
            self._intervals.append([idx, float(t0), float(t1)])

    def note_marker(self, category: str, n: int = 1) -> None:
        with self._lock:
            self._markers[category] = self._markers.get(category, 0) + n

    def observe_record(self, record: dict) -> None:
        """Classify one telemetry record (called by ``Telemetry.write`` for
        every live record, and by :func:`ledger_from_records` offline)."""
        kind = record.get("kind")
        if kind == "span":
            self._observe_span(record)
        elif kind == "compile":
            t = record.get("t") or time.time()
            dur = float(record.get("dur_ms") or 0.0) / 1e3
            self.note_interval("compile", t - dur, t)
        elif kind == "event":
            self._observe_event(record)

    def _observe_span(self, record: dict) -> None:
        name = record.get("name")
        t = record.get("t") or time.time()
        dur = float(record.get("dur_ms") or 0.0) / 1e3
        if name == _STEP_SPAN:
            with self._lock:
                if self._replay_budget > 0:
                    self._replay_budget -= 1
                    cat = _CAT_INDEX["rewind_replay"]
                    self._last_step_interval = None
                else:
                    cat = _CAT_INDEX["productive"]
                    self._last_step_interval = None
                if dur > 0:
                    interval = [cat, t - dur, t]
                    self._intervals.append(interval)
                    if cat == _CAT_INDEX["productive"]:
                        self._last_step_interval = interval
            return
        cat = _SPAN_CATEGORY.get(name)
        if cat is not None:
            self.note_interval(cat, t - dur, t)

    def _observe_event(self, record: dict) -> None:
        name = record.get("name")
        t = record.get("t") or time.time()
        if name == "resilience.preempt_signal":
            if self.preempt_from is None or t < self.preempt_from:
                self.preempt_from = t
            self.note_marker("preempt")
        elif name == "resilience.preempt_checkpoint":
            self.note_marker("preempt")
        elif name == "resilience.retry":
            cat = _retry_category(record.get("label"), record.get("error"))
            wait = float(record.get("wait_s") or 0.0)
            # The event is emitted BEFORE the backoff sleep: the wait interval
            # extends forward from the record time.
            self.note_interval(cat, t, t + wait)
            self.note_marker(cat)
        elif name == "resilience.gave_up":
            self.note_marker(_retry_category(record.get("label"), record.get("error")))
        elif name == "memory.oom_halving":
            self.note_marker("device_acquire")
        elif name == "health.skip":
            # The step that just finished computed a zero delta: it burned
            # device time without advancing training — retroactively badput.
            with self._lock:
                interval = self._last_step_interval
                if interval is not None and interval[0] == _CAT_INDEX["productive"]:
                    interval[0] = _CAT_INDEX["rewind_replay"]
                self._last_step_interval = None
            self.note_marker("rewind_replay")
        elif name == "health.rewind":
            step = record.get("step")
            resumed = record.get("resumed_step")
            replays = 0
            try:
                replays = max(int(step) - int(resumed), 0)
            except (TypeError, ValueError):
                pass
            with self._lock:
                self._replay_budget += replays
            self.note_marker("rewind_replay")

    # -- the sweep -----------------------------------------------------------

    @staticmethod
    def _sweep(intervals: Sequence[Tuple[int, float, float]], lo: float, hi: float,
               preempt_from: Optional[float]) -> dict:
        """Attribute ``[lo, hi]`` exactly once: each elementary segment goes
        to the highest-precedence category covering it; uncovered segments go
        to ``preempt`` past the preemption mark, else ``idle``."""
        out = {name: 0.0 for name in CATEGORIES}
        if hi <= lo:
            return out
        events: List[Tuple[float, int, int]] = []
        for cat, t0, t1 in intervals:
            t0, t1 = max(t0, lo), min(t1, hi)
            if t1 > t0:
                events.append((t0, +1, cat))
                events.append((t1, -1, cat))
        events.sort(key=lambda e: e[0])

        def background(a: float, b: float):
            if b <= a:
                return
            if preempt_from is None or preempt_from >= b:
                out["idle"] += b - a
            elif preempt_from <= a:
                out["preempt"] += b - a
            else:
                out["idle"] += preempt_from - a
                out["preempt"] += b - preempt_from

        counts = [0] * _N_FOREGROUND
        cursor = lo
        i = 0
        n = len(events)
        while i < n:
            t = events[i][0]
            if t > cursor:
                active = next((c for c in range(_N_FOREGROUND) if counts[c]), None)
                if active is None:
                    background(cursor, t)
                else:
                    out[CATEGORIES[active]] += t - cursor
                cursor = t
            while i < n and events[i][0] == t:
                counts[events[i][2]] += events[i][1]
                i += 1
        if cursor < hi:
            active = next((c for c in range(_N_FOREGROUND) if counts[c]), None)
            if active is None:
                background(cursor, hi)
            else:
                out[CATEGORIES[active]] += hi - cursor
        return out

    def _compact_locked(self, upto: float) -> None:
        if upto <= self._compacted_upto:
            return
        keep: List[list] = []
        done: List[Tuple[int, float, float]] = []
        for interval in self._intervals:
            cat, t0, t1 = interval
            if t1 <= upto:
                done.append((cat, t0, upto if t1 > upto else t1))
                if interval is self._last_step_interval:
                    # The referenced step folded into scalar totals: a
                    # (pathologically late) health.skip can no longer
                    # reclassify it — degrade to the marker only.
                    self._last_step_interval = None
            elif t0 < upto:
                done.append((cat, t0, upto))
                # Clip IN PLACE so the _last_step_interval reference (and its
                # possible future reclassification) survives the split.
                interval[1] = upto
                keep.append(interval)
            else:
                keep.append(interval)
        swept = self._sweep(done, self._compacted_upto, upto, self.preempt_from)
        for name, s in swept.items():
            self._compacted[name] += s
        self._intervals = keep
        self._compacted_upto = upto

    # -- views ---------------------------------------------------------------

    def summary(self, now: Optional[float] = None) -> dict:
        """The ledger: per-category seconds/fractions over ``[start_t, now]``,
        the goodput fraction, fault markers, and the conservation residual."""
        now = float(now if now is not None else time.time())
        now = max(now, self.start_t)
        with self._lock:
            if len(self._intervals) > self.COMPACT_AT:
                self._compact_locked(
                    max(self._compacted_upto, now - self.COMPACT_MARGIN_S)
                )
            # Deep-copy the tail: intervals are mutable lists shared with
            # concurrent reclassification/compaction; the sweep below runs
            # outside the lock and must see a consistent snapshot.
            intervals = [tuple(iv) for iv in self._intervals]
            compacted = dict(self._compacted)
            markers = dict(self._markers)
            lo = self._compacted_upto
        seconds = self._sweep(intervals, lo, now, self.preempt_from)
        for name, s in compacted.items():
            seconds[name] += s
        elapsed = now - self.start_t
        total = sum(seconds.values())
        fractions = {
            name: (s / elapsed if elapsed > 0 else 0.0) for name, s in seconds.items()
        }
        return {
            "start_t": self.start_t,
            "end_t": now,
            "elapsed_s": elapsed,
            "seconds": {k: round(v, 6) for k, v in seconds.items()},
            "fractions": {k: round(v, 6) for k, v in fractions.items()},
            "goodput_fraction": round(fractions["productive"], 6),
            "attributed_s": round(total - seconds["idle"] - seconds["preempt"], 6),
            "conservation_error_s": round(elapsed - total, 9),
            "markers": markers,
        }

    def publish(self, registry, now: Optional[float] = None) -> dict:
        """Land the ledger in the metrics registry as ``goodput.*`` gauges
        (what the Prometheus exporter and the final snapshot serve)."""
        s = self.summary(now=now)
        registry.gauge("goodput.elapsed_s").set(s["elapsed_s"])
        registry.gauge("goodput.fraction").set(s["goodput_fraction"])
        registry.gauge("goodput.attributed_s").set(s["attributed_s"])
        for name in CATEGORIES:
            registry.gauge(f"goodput.{name}_s").set(s["seconds"][name])
        return s


# ---------------------------------------------------------------------------
# Singleton attachment (the live ledger rides the telemetry record stream)
# ---------------------------------------------------------------------------


def attach(start_t: Optional[float] = None) -> GoodputLedger:
    """Attach a fresh ledger to the telemetry singleton: every subsequent
    record (span/compile/event) is classified as it is written."""
    from . import core

    ledger = GoodputLedger(start_t=start_t)
    core.get_telemetry().goodput = ledger
    return ledger


def detach() -> None:
    from . import core

    core.get_telemetry().goodput = None


@contextlib.contextmanager
def attached(start_t: Optional[float] = None):
    """Scoped ledger: attach a fresh one for the block, then RESTORE whatever
    was attached before (a probe inside a goodput-enabled run must not
    destroy the host run's ledger)."""
    from . import core

    tel = core.get_telemetry()
    previous = tel.goodput
    ledger = GoodputLedger(start_t=start_t)
    tel.goodput = ledger
    try:
        yield ledger
    finally:
        tel.goodput = previous


def get_ledger() -> Optional[GoodputLedger]:
    from . import core

    return core.get_telemetry().goodput


def enabled_from_env() -> bool:
    return os.environ.get(ENV_GOODPUT, "").strip().lower() in _TRUTHY


# ---------------------------------------------------------------------------
# Offline replay (postmortems, the report CLI, the chaos oracle)
# ---------------------------------------------------------------------------


def ledger_from_records(records: Sequence[dict]) -> Optional[GoodputLedger]:
    """Rebuild a ledger from a parsed telemetry JSONL stream (the list
    ``telemetry.report.load_records`` returns).  The window spans the
    records' timestamps.  Returns None for an empty stream."""
    stamped = [r for r in records if isinstance(r.get("t"), (int, float))]
    if not stamped:
        return None
    stamped.sort(key=lambda r: r["t"])

    def _t0(rec):
        # Span/compile records are stamped at their END: the window must
        # open at the earliest interval START or the first span would be
        # clipped out of its own ledger.
        if rec.get("kind") in ("span", "compile"):
            return rec["t"] - float(rec.get("dur_ms") or 0.0) / 1e3
        return rec["t"]

    ledger = GoodputLedger(start_t=min(_t0(r) for r in stamped))
    for rec in stamped:
        ledger.observe_record(rec)
    return ledger


def summary_from_records(records: Sequence[dict]) -> Optional[dict]:
    """Offline goodput summary over a record stream (None when empty)."""
    stamped = [r.get("t") for r in records if isinstance(r.get("t"), (int, float))]
    ledger = ledger_from_records(records)
    if ledger is None:
        return None
    return ledger.summary(now=max(stamped))


# ---------------------------------------------------------------------------
# Fleet aggregation: per-host step durations + min-over-hosts goodput
# ---------------------------------------------------------------------------


class FleetAggregator:
    """Cadence-gated multi-host aggregation over the existing gather path.

    ``on_step()`` runs once per completed optimizer step on EVERY process (it
    is called from ``Telemetry.record_step``, which the fused train step runs
    in lockstep across hosts).  Every ``every``-th call — call-count gated,
    never wall-clock, for exactly the reason ``PreemptionGuard.should_stop``
    is — all hosts gather ``{host, step durations since last gather, local
    goodput fraction}``, feed the sentinel's per-host straggler hooks, and
    publish:

    - ``goodput.fleet_fraction`` — min over hosts of the local goodput
      fraction (the fleet only advances as fast as its slowest member);
    - ``goodput.fleet_hosts`` / ``goodput.straggler_count`` gauges;
    - one ``sentinel.straggler`` event per named straggler (host id, median
      step ms, fleet median, ratio) — rendered by ``telemetry.report``.

    ``gather_fn`` is injectable for tests (and defaults to
    ``utils.operations.gather_object``, which on a single process is the
    identity — so single-host runs pay one list append per step and never
    touch a collective).
    """

    MAX_DURS_PER_GATHER = 64

    def __init__(
        self,
        sentinel: Optional[AnomalySentinel] = None,
        every: Optional[int] = None,
        gather_fn: Optional[Callable] = None,
        host: Optional[int] = None,
    ):
        if every is None:
            # Env-tunable cadence so short-lived fleets (the multi-process
            # chaos campaign runs single-digit steps) still reach a gather.
            every = int(os.environ.get("ACCELERATE_TPU_FLEET_EVERY", "32"))
        self.every = max(1, int(every))
        self._calls = 0
        self._pending: List[float] = []
        self._sentinel = sentinel
        self._gather = gather_fn
        self._host = host
        # Hosts named straggler at the previous gather: a host that recovers
        # gets an explicit cleared=True event, so the report's latest-verdict-
        # per-host view actually ages out (recovery emits no straggler row).
        self._named: set = set()
        self.last_report: Optional[dict] = None

    def _resolve_host(self) -> int:
        if self._host is None:
            from .core import process_index

            self._host = process_index()
        return self._host

    def _resolve_sentinel(self) -> AnomalySentinel:
        if self._sentinel is None:
            # Share the flight recorder's sentinel when it is running, so the
            # straggler state and the anomaly stream live in one place.
            from .flightrec import get_flight_recorder

            rec = get_flight_recorder()
            if rec.enabled and rec.sentinel is not None:
                self._sentinel = rec.sentinel
            else:
                self._sentinel = AnomalySentinel()
        return self._sentinel

    def _gather_payloads(self, payload: dict) -> List[dict]:
        if self._gather is not None:
            return list(self._gather([payload]))
        from ..utils.operations import gather_object

        return list(gather_object([payload]))

    def on_step(self, dur_ms: float, telemetry=None) -> Optional[dict]:
        """Buffer one local step duration; on the cadence boundary, gather,
        feed the sentinel, publish.  Returns the fleet report dict on gather
        calls, else None."""
        self._pending.append(float(dur_ms))
        self._calls += 1
        if self._calls % self.every != 0:
            return None
        local_fraction = None
        ledger = get_ledger()
        if ledger is not None:
            local_fraction = ledger.summary()["goodput_fraction"]
        payload = {
            "host": self._resolve_host(),
            "durs": self._pending[-self.MAX_DURS_PER_GATHER:],
            "goodput_fraction": local_fraction,
        }
        self._pending = []
        gathered = self._gather_payloads(payload)
        sentinel = self._resolve_sentinel()
        for p in gathered:
            for dur in p.get("durs") or []:
                sentinel.observe_host_step(int(p.get("host", 0)), dur)
        stragglers = sentinel.straggler_report()
        fractions = [
            p["goodput_fraction"]
            for p in gathered
            if p.get("goodput_fraction") is not None
        ]
        fleet_fraction = min(fractions) if fractions else None
        report = {
            "hosts": len(gathered),
            "fleet_fraction": fleet_fraction,
            "stragglers": stragglers,
        }
        self.last_report = report
        named_now = {s["host"] for s in stragglers}
        if telemetry is not None and telemetry.enabled:
            registry = telemetry.registry
            registry.gauge("goodput.fleet_hosts").set(len(gathered))
            registry.gauge("goodput.straggler_count").set(len(stragglers))
            if fleet_fraction is not None:
                registry.gauge("goodput.fleet_fraction").set(fleet_fraction)
            for s in stragglers:
                telemetry.event("sentinel.straggler", **s)
            for host in sorted(self._named - named_now):
                telemetry.event("sentinel.straggler", host=host, cleared=True)
        self._named = named_now
        return report
