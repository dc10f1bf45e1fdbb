"""Per-request serving traces: phase timelines, blame decomposition, export.

The PyTorch port's own copy of the JAX package's ``serving/tracing.py``
(host-side only, so it moves over unchanged but for two telemetry hooks,
below).  Each request gets a timeline of typed **phase intervals**, so the
question "why was this request slow" has an answer per request:

- ``queue_wait`` — submission until first admission into a slot;
- ``prefill`` — one interval per prefill chunk (``chunk`` index and
  ``padded_rows`` recorded); turn-waiting ticks where the slot held the
  request but another slot's chunk ran carry ``waiting=True``;
- ``decode`` — slot residency across decode ticks, one interval per run of
  ticks with the same batch shape (``co_batch``, bucket ``width``, ``ticks``
  count and summed ``dispatch_ms`` recorded);
- ``preempted`` — zero-duration marker at each eviction;
- ``requeued_wait`` — the post-preemption wait back to re-admission;
- ``compile_in_path`` — a tick whose dispatch was the first at its
  ``(kind, table width)`` in this engine's life (in the JAX engine, the
  bucket-width recompile that spikes TTFT; the port keeps the same ticks);
- ``quarantine`` — zero-duration marker at a poison quarantine;
- ``journal_recovery`` — marker on a journal-recovered request in-life; as
  a *duration* it is the inter-life gap, computed by the offline stitcher.

**Conservation invariant** (the goodput discipline): intervals are disjoint
and lie inside the request's submission→terminal window, by construction —
every interval starts at the trace's cursor or later and advances it.  The
residual is exposed as ``unattributed_ms`` (inter-tick host bookkeeping,
partial work discarded by a preemption), never silently absorbed.

On top of the timelines:

- a **blame decomposer** naming the dominant badput phase per completed
  request (tallied in :attr:`ServingTracer.blame_counts`);
- **Chrome-trace export** (:func:`export_chrome_trace`): one track per
  engine slot plus one per request, in the trace-event format that
  Perfetto and the JAX package's ``telemetry/timeline.py`` read;
- **offline postmortem** (:func:`load_serving_traces` /
  :func:`stitch_traces` / :func:`summarize_traces`): the trace JSONL is
  re-summarized so dead engines get blame decomposition too, with traces
  **stitched across engine lives** by the stable journal ``tag`` (the
  inter-life gap becomes ``journal_recovery``).

Cost model: host-side interval bookkeeping only, a few ``time.monotonic``
reads and list appends per tick.  Completed traces live in a bounded ring
(``ACCELERATE_TPU_SERVING_TRACE_CAPACITY``, default 1024).  Tracing is
**default-on** (``ACCELERATE_TPU_SERVING_TRACE=0`` is the kill switch);
the JSONL file only exists when a directory is configured
(``ServingConfig.trace_dir``, ``ACCELERATE_TPU_SERVING_TRACE_DIR``, or the
enabled telemetry run directory).  With telemetry on, each terminal record
also feeds the ``serving.trace.blame.{phase}`` counters and the
``serving.trace.unattributed_ms`` histogram.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import time
from typing import Dict, List, Optional

from ..telemetry import get_telemetry

__all__ = [
    "PHASES",
    "BADPUT_PHASES",
    "PhaseInterval",
    "RequestTrace",
    "ServingTracer",
    "tracing_enabled",
    "resolve_trace_dir",
    "export_chrome_trace",
    "load_serving_traces",
    "stitch_traces",
    "summarize_traces",
    "format_trace_block",
    "ENV_ENABLE",
    "ENV_DIR",
    "ENV_CAPACITY",
    "ENV_FLUSH_EVERY",
]

ENV_ENABLE = "ACCELERATE_TPU_SERVING_TRACE"
ENV_DIR = "ACCELERATE_TPU_SERVING_TRACE_DIR"
ENV_CAPACITY = "ACCELERATE_TPU_SERVING_TRACE_CAPACITY"
ENV_FLUSH_EVERY = "ACCELERATE_TPU_SERVING_TRACE_FLUSH_EVERY"

DEFAULT_CAPACITY = 1024
DEFAULT_FLUSH_EVERY = 32

PHASES = (
    "queue_wait",
    "prefill",
    "decode",
    "verify",  # speculative draft-then-verify dispatch (productive, like decode)
    "preempted",
    "requeued_wait",
    "compile_in_path",
    "quarantine",
    "journal_recovery",
)

# Phases the blame decomposer may name (productive prefill/decode time is
# never "blamed"; a request slow because it generated many tokens is not
# suffering badput).  ``quarantine``/``journal_recovery`` are markers
# in-life, but quarantine is blamed by terminal status and journal_recovery
# by the stitcher's inter-life gap.
BADPUT_PHASES = (
    "queue_wait",
    "requeued_wait",
    "compile_in_path",
    "quarantine",
    "journal_recovery",
)

# Blame floor: the dominant badput phase is only named when it is material —
# at least this fraction of the request's wall window (and >= 1 ms), else
# the request's blame is "none".  Without the floor every healthy request
# would blame its microseconds of queue wait.
BLAME_FLOOR_FRACTION = 0.1
BLAME_FLOOR_MS = 1.0

_OFF = {"0", "false", "no", "off"}


def tracing_enabled(flag: Optional[bool] = None) -> bool:
    """Whether per-request tracing is on: an explicit ``ServingConfig.trace``
    wins; otherwise default-on with ``ACCELERATE_TPU_SERVING_TRACE=0`` as
    the kill switch."""
    if flag is not None:
        return bool(flag)
    return os.environ.get(ENV_ENABLE, "1").strip().lower() not in _OFF


def resolve_trace_dir(explicit: Optional[str] = None) -> Optional[str]:
    """Where trace JSONL persists: explicit config, then the env override,
    then the enabled telemetry run directory (so ``telemetry.report <dir>``
    finds the traces next to the telemetry stream), else nowhere — tracing
    stays purely in-memory (ring + live map) with no file I/O."""
    path = explicit or os.environ.get(ENV_DIR, "").strip() or None
    if path:
        return path
    tel = get_telemetry()
    if tel.enabled and tel.dir:
        return tel.dir
    return None


def _env_int(key: str, default: int) -> int:
    try:
        return int(os.environ.get(key, "") or default)
    except ValueError:
        return default


class PhaseInterval:
    """One typed interval on a request's timeline (monotonic seconds;
    ``start == end`` for markers)."""

    __slots__ = ("phase", "start", "end", "meta")

    def __init__(self, phase: str, start: float, end: float, meta: Optional[dict] = None):
        self.phase = phase
        self.start = start
        self.end = end
        self.meta = meta or {}

    @property
    def dur_ms(self) -> float:
        return (self.end - self.start) * 1e3


class RequestTrace:
    """One request's phase timeline plus the cursor that enforces the
    conservation invariant: every interval starts at or after the cursor and
    advances it, so intervals are disjoint and ordered by construction and
    ``unattributed_ms`` is exactly the window minus the attributed total."""

    __slots__ = (
        "rid", "tag", "arrival", "arrival_wall", "prompt_len", "max_new",
        "intervals", "cursor", "wait_phase", "slot", "prefill_chunks",
        "status", "finish", "blame", "recovered_from", "orig_arrival_wall",
    )

    def __init__(
        self,
        rid: int,
        tag: Optional[str],
        arrival: float,
        prompt_len: int,
        max_new: int,
    ):
        self.rid = rid
        self.tag = tag
        self.arrival = arrival
        # Wall anchor for cross-process stitching: monotonic clocks die with
        # their process; time.time() survives an engine's SIGKILL.
        self.arrival_wall = time.time() - (time.monotonic() - arrival)
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.intervals: List[PhaseInterval] = []
        self.cursor = arrival
        self.wait_phase = "queue_wait"
        self.slot: Optional[int] = None
        self.prefill_chunks = 0
        self.status: Optional[str] = None
        self.finish: Optional[float] = None
        self.blame: Optional[str] = None
        self.recovered_from: Optional[int] = None
        self.orig_arrival_wall: Optional[float] = None

    def add(self, phase: str, end: float, start: Optional[float] = None, **meta) -> PhaseInterval:
        start = self.cursor if start is None else max(start, self.cursor)
        end = max(end, start)
        iv = PhaseInterval(phase, start, end, meta)
        self.intervals.append(iv)
        self.cursor = max(self.cursor, end)
        return iv

    def phase_ms(self, now: Optional[float] = None) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for iv in self.intervals:
            out[iv.phase] = out.get(iv.phase, 0.0) + iv.dur_ms
        return out

    def window_ms(self, now: Optional[float] = None) -> float:
        end = self.finish if self.finish is not None else (now or time.monotonic())
        return max(end - self.arrival, 0.0) * 1e3

    def unattributed_ms(self, now: Optional[float] = None) -> float:
        attributed = sum(iv.dur_ms for iv in self.intervals)
        return max(self.window_ms(now) - attributed, 0.0)

    def current_phase(self, now: Optional[float] = None) -> str:
        """What the request is doing *right now* (for ``/debug/requests``):
        the in-progress wait when off-slot, else the last recorded phase."""
        if self.finish is not None:
            return "done"
        if self.slot is None:
            return self.wait_phase
        return self.intervals[-1].phase if self.intervals else self.wait_phase

    def to_record(self, status: Optional[str] = None, now: Optional[float] = None) -> dict:
        """JSONL record (offsets in ms relative to arrival, wall anchor for
        stitching).  ``status="inflight"`` snapshots are superseded by the
        terminal record for the same request in the same file."""
        end = self.finish if self.finish is not None else (now or time.monotonic())
        return {
            "kind": "serving_trace",
            "rid": self.rid,
            "tag": self.tag,
            "status": status or self.status or "inflight",
            "arrival_wall": self.arrival_wall,
            "duration_ms": round((end - self.arrival) * 1e3, 3),
            "prompt_len": self.prompt_len,
            "max_new": self.max_new,
            "blame": self.blame,
            "recovered_from": self.recovered_from,
            "orig_arrival_wall": self.orig_arrival_wall,
            "unattributed_ms": round(self.unattributed_ms(end), 3),
            "phase_ms": {k: round(v, 3) for k, v in self.phase_ms().items()},
            "phases": [
                [
                    iv.phase,
                    round((iv.start - self.arrival) * 1e3, 3),
                    round((iv.end - self.arrival) * 1e3, 3),
                    iv.meta,
                ]
                for iv in self.intervals
            ],
        }


def decompose_blame(phase_ms: Dict[str, float], window_ms: float, status: str = "ok") -> str:
    """Name the dominant badput phase, or ``"none"`` when the request's
    badput is immaterial (below the blame floor).  A quarantined request is
    always blamed on ``quarantine`` — its wall time is irrelevant, its
    decode was poisoned."""
    if status == "quarantined":
        return "quarantine"
    bad = {p: phase_ms.get(p, 0.0) for p in BADPUT_PHASES}
    best = max(bad, key=lambda p: bad[p])
    floor = max(BLAME_FLOOR_MS, BLAME_FLOOR_FRACTION * window_ms)
    return best if bad[best] >= floor else "none"


class ServingTracer:
    """The engine-side trace collector: live traces keyed by request id, a
    bounded ring of completed traces, blame counters, and (when a directory
    is configured) an append-only JSONL file — terminal records plus
    periodic in-flight snapshots so a SIGKILLed engine's partial timelines
    survive for the offline stitcher."""

    def __init__(
        self,
        dir: Optional[str] = None,
        capacity: Optional[int] = None,
        flush_every: Optional[int] = None,
    ):
        self.live: Dict[int, RequestTrace] = {}
        self.capacity = int(capacity or _env_int(ENV_CAPACITY, DEFAULT_CAPACITY))
        self.flush_every = max(1, int(flush_every or _env_int(ENV_FLUSH_EVERY, DEFAULT_FLUSH_EVERY)))
        self.completed: collections.deque = collections.deque(maxlen=self.capacity)
        self.blame_counts: Dict[str, int] = {}
        self.dir = dir
        self.path: Optional[str] = None
        self._file = None
        if dir:
            os.makedirs(dir, exist_ok=True)
            # One file per engine life (pid-keyed): a successor engine on
            # the same run dir appends its OWN file, so the stitcher sees
            # both lives instead of the survivor clobbering the victim.
            self.path = os.path.join(dir, f"serving_trace_{os.getpid()}_{id(self) & 0xffff:x}.jsonl")
        self._events = 0
        self._tick_t0: Optional[float] = None
        self._ticked: set = set()

    # -- engine hooks --------------------------------------------------------

    def on_submit(self, req) -> None:
        self.live[req.id] = RequestTrace(
            req.id, req.tag, req.arrival_t, len(req.prompt), req.max_new_tokens
        )

    def on_admit(self, req, now: float, slot: int) -> None:
        t = self.live.get(req.id)
        if t is None:
            return
        if now > t.cursor:
            t.add(t.wait_phase, now)
        t.slot = slot
        self._note_event()

    def on_preempt(self, req, now: float) -> None:
        t = self.live.get(req.id)
        if t is None:
            return
        t.add("preempted", now, start=now, emitted=len(req.emitted))
        t.wait_phase = "requeued_wait"
        t.slot = None
        self._note_event()

    def on_recover(self, rid: int, journal_rec: dict) -> None:
        t = self.live.get(rid)
        if t is None:
            return
        t.recovered_from = journal_rec.get("id")
        t.orig_arrival_wall = journal_rec.get("arrival_wall")
        t.add(
            "journal_recovery", t.cursor, start=t.cursor,
            recovered_from=t.recovered_from,
        )

    def begin_tick(self, now: float) -> None:
        self._tick_t0 = now
        self._ticked = set()

    def on_prefill(
        self, req, slot: int, end: float,
        padded_rows: int, width: Optional[int], fresh: bool,
    ) -> None:
        t = self.live.get(req.id)
        if t is None:
            return
        phase = "compile_in_path" if fresh else "prefill"
        # Start at the request's cursor, not the tick boundary: a slotted
        # request idle between ticks (the caller was not stepping) is still
        # *resident* — that host gap belongs to its phase, not to
        # unattributed.
        t.add(
            phase, end,
            chunk=t.prefill_chunks, padded_rows=padded_rows,
            width=width, slot=slot,
            **({"kind": "prefill"} if fresh else {}),
        )
        t.prefill_chunks += 1
        self._ticked.add(req.id)
        self._note_event()

    def on_decode(
        self, reqs_slots, end: float,
        co_batch: int, width: Optional[int], fresh: bool, dispatch_ms: float,
        phase: str = "decode",
    ) -> None:
        """One fused decode/verify dispatch.  ``phase`` is ``"decode"`` for
        the single-token program and ``"verify"`` for a speculative
        draft-then-verify dispatch — both productive (never blamed); the
        phase key keeps greedy and speculative runs from coalescing into one
        interval, so a trace shows exactly where the engine ran verify
        windows."""
        for req, slot in reqs_slots:
            t = self.live.get(req.id)
            if t is None:
                continue
            last = t.intervals[-1] if t.intervals else None
            if (
                not fresh
                and last is not None
                and last.phase == phase
                and last.meta.get("co_batch") == co_batch
                and last.meta.get("width") == width
                and t.cursor == last.end
            ):
                # Coalesce the run: slot residency across consecutive decode
                # ticks of one batch shape is ONE interval (bounds memory and
                # folds the inter-tick host gap into attributed residency);
                # pure dispatch wall stays separately summed in dispatch_ms.
                last.end = end
                last.meta["ticks"] += 1
                last.meta["dispatch_ms"] = round(last.meta["dispatch_ms"] + dispatch_ms, 3)
                t.cursor = end
            else:
                # Cursor start (see on_prefill): in-slot residency across a
                # shape change or host gap stays attributed to the request.
                t.add(
                    "compile_in_path" if fresh else phase, end,
                    co_batch=co_batch, width=width, slot=slot,
                    ticks=1, dispatch_ms=round(dispatch_ms, 3),
                    **({"kind": phase} if fresh else {}),
                )
            self._ticked.add(req.id)
        self._note_event()

    def end_tick(self, now: float, slots: dict) -> None:
        """Close the tick for every resident request: dispatched requests'
        last interval stretches to the tick boundary (the emit/bookkeeping
        tail stays attributed); a prefilling slot that never got its chunk
        turn records a ``waiting`` prefill interval — the co-batched-behind-
        another-prefill time the blame question asks about."""
        if self._tick_t0 is None:
            return
        for idx, slot in slots.items():
            t = self.live.get(slot.request.id)
            if t is None:
                continue
            if t.rid in self._ticked:
                last = t.intervals[-1]
                if now > last.end:
                    last.end = now
                    t.cursor = max(t.cursor, now)
                continue
            last = t.intervals[-1] if t.intervals else None
            if (
                last is not None
                and last.phase == "prefill"
                and last.meta.get("waiting")
                and t.cursor == last.end
            ):
                last.end = now
                last.meta["ticks"] += 1
                t.cursor = now
            else:
                t.add("prefill", now, waiting=True, ticks=1, slot=idx)
        self._tick_t0 = None
        self._note_event()

    def on_terminal(self, req, status: str) -> None:
        t = self.live.pop(req.id, None)
        if t is None:
            return
        finish = req.finish_t if req.finish_t is not None else time.monotonic()
        if t.slot is None and finish > t.cursor:
            # Off-slot terminal (deadline-shed from the queue, instant-done):
            # the residual IS the wait — attribute it, don't leak it.
            t.add(t.wait_phase, finish, terminal=True)
        if status == "quarantined":
            t.add("quarantine", finish, start=finish)
        t.finish = max(finish, t.cursor)
        t.status = status
        t.blame = decompose_blame(t.phase_ms(), t.window_ms(), status)
        self.blame_counts[t.blame] = self.blame_counts.get(t.blame, 0) + 1
        tel = get_telemetry()
        if tel.enabled:
            tel.registry.counter(f"serving.trace.blame.{t.blame}").inc()
            tel.registry.histogram("serving.trace.unattributed_ms").observe(
                t.unattributed_ms()
            )
        self.completed.append(t)
        self._write(t.to_record())
        if self._file is not None:
            self._file.flush()  # terminal records are durability points
        self._note_event()

    # -- persistence ---------------------------------------------------------

    def _note_event(self) -> None:
        self._events += 1
        if self.path is not None and self._events % self.flush_every == 0:
            self.flush()

    def flush(self) -> None:
        """Append an in-flight snapshot line per live request (last line per
        request id wins at load time).  Called on the flush cadence, at
        drain, and after a recovery — the SIGKILL-durability hook."""
        if self.path is None:
            return
        now = time.monotonic()
        for t in self.live.values():
            if t.intervals or now > t.arrival:
                self._write(t.to_record(status="inflight", now=now))
        if self._file is not None:
            self._file.flush()

    def _write(self, record: dict) -> None:
        if self.path is None:
            return
        if self._file is None:
            # Block-buffered: a syscall per snapshot line would tax every
            # tick.  Both callers (flush() and on_terminal) flush the file
            # before returning, so a SIGKILL can only lose lines from a
            # flush call it interrupted mid-write.
            self._file = open(self.path, "a")
        self._file.write(json.dumps(record) + "\n")

    # -- introspection -------------------------------------------------------

    def snapshot_request(self, rid: int, now: Optional[float] = None) -> dict:
        """Phase-so-far for one live request (``/debug/requests``)."""
        t = self.live.get(rid)
        if t is None:
            return {}
        now = now or time.monotonic()
        phase_ms = dict(t.phase_ms())
        if t.slot is None and now > t.cursor:
            # The in-progress wait is real badput already — show it.
            phase_ms[t.wait_phase] = (
                phase_ms.get(t.wait_phase, 0.0) + (now - t.cursor) * 1e3
            )
        return {
            "current_phase": t.current_phase(now),
            "phase_ms": {k: round(v, 3) for k, v in phase_ms.items()},
            "unattributed_ms": round(t.unattributed_ms(now), 3),
            "preempt_markers": sum(1 for iv in t.intervals if iv.phase == "preempted"),
        }

    def traces(self) -> List[RequestTrace]:
        return list(self.completed) + list(self.live.values())


# ---------------------------------------------------------------------------
# Chrome-trace export
# ---------------------------------------------------------------------------

_SLOT_PID = 1
_REQ_PID = 2


def export_chrome_trace(path: str, traces: List[RequestTrace]) -> str:
    """Write the traces as a Chrome trace-event bundle: one thread per
    engine slot (what each decode lane was doing) under process 1, one
    thread per request (its full phase timeline) under process 2 —
    ``ph=="M"`` name metadata plus ``ph=="X"`` complete events with
    ``ts``/``dur`` in microseconds, wall-anchored so two engine lives line
    up on one axis.  The file opens in Perfetto and loads through the JAX
    package's ``telemetry.timeline.load_trace_events``; ``.gz`` paths are
    gzip-compressed."""
    events: List[dict] = [
        {"ph": "M", "pid": _SLOT_PID, "name": "process_name",
         "args": {"name": "serving engine slots"}},
        {"ph": "M", "pid": _REQ_PID, "name": "process_name",
         "args": {"name": "serving requests"}},
    ]
    if not traces:
        base_wall = 0.0
    else:
        base_wall = min(t.arrival_wall for t in traces)
    slots_seen: set = set()
    for t in sorted(traces, key=lambda t: t.arrival_wall):
        label = f"req {t.rid}" + (f" [{t.tag}]" if t.tag else "")
        events.append({
            "ph": "M", "pid": _REQ_PID, "tid": t.rid, "name": "thread_name",
            "args": {"name": label},
        })
        for iv in t.intervals:
            ts = (t.arrival_wall - base_wall + (iv.start - t.arrival)) * 1e6
            dur = (iv.end - iv.start) * 1e6
            args = dict(iv.meta, request=t.rid, phase=iv.phase)
            if t.tag is not None:
                args["tag"] = t.tag
            events.append({
                "ph": "X", "pid": _REQ_PID, "tid": t.rid, "name": iv.phase,
                "ts": round(ts, 3), "dur": round(dur, 3), "args": args,
            })
            slot = iv.meta.get("slot")
            if slot is not None:
                slots_seen.add(slot)
                events.append({
                    "ph": "X", "pid": _SLOT_PID, "tid": slot,
                    "name": f"r{t.rid}/{iv.phase}",
                    "ts": round(ts, 3), "dur": round(dur, 3), "args": args,
                })
    for slot in sorted(slots_seen):
        events.append({
            "ph": "M", "pid": _SLOT_PID, "tid": slot, "name": "thread_name",
            "args": {"name": f"slot {slot}"},
        })
    bundle = {"traceEvents": events, "displayTimeUnit": "ms"}
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    if path.endswith(".gz"):
        with gzip.open(path, "wt", encoding="utf-8") as f:
            json.dump(bundle, f)
    else:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(bundle, f)
    return path


# ---------------------------------------------------------------------------
# Offline: load / stitch / summarize (stdlib only)
# ---------------------------------------------------------------------------


def load_serving_traces(path: str) -> List[dict]:
    """Parse trace records from a ``serving_trace_*.jsonl`` file or a run
    directory.  Per (file, request id) the LAST record wins — terminal
    records land after every in-flight snapshot of the same request, so a
    completed request is never double-counted as also in flight."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "serving_trace_*.jsonl")))
    else:
        files = [path]
    out: Dict[tuple, dict] = {}
    for file in files:
        try:
            with open(file) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # a SIGKILLed writer's torn tail
            if rec.get("kind") != "serving_trace":
                continue
            rec["source"] = os.path.basename(file)
            out[(file, rec.get("rid"))] = rec
    return sorted(out.values(), key=lambda r: (r.get("arrival_wall") or 0.0))


def stitch_traces(records: List[dict], eps_ms: Optional[float] = None) -> List[dict]:
    """Join one logical request's records across engine lives by journal
    ``tag``: lives sorted by wall arrival, each inter-life gap attributed to
    ``journal_recovery`` (the dead time between the victim's last trace and
    the successor's resubmission).  Conservation must hold ACROSS the
    stitch: summed phases + gaps + summed per-life unattributed == first
    arrival → last end, within ``eps_ms``."""
    by_tag: Dict[str, List[dict]] = {}
    for rec in records:
        tag = rec.get("tag")
        if tag is not None:
            by_tag.setdefault(tag, []).append(rec)
    out = []
    for tag in sorted(by_tag):
        lives = sorted(by_tag[tag], key=lambda r: r.get("arrival_wall") or 0.0)
        if len(lives) < 2 and not any(r.get("recovered_from") is not None for r in lives):
            continue
        phase_ms: Dict[str, float] = {}
        unattributed = 0.0
        gap_ms = 0.0
        for i, rec in enumerate(lives):
            for phase, ms in (rec.get("phase_ms") or {}).items():
                phase_ms[phase] = phase_ms.get(phase, 0.0) + float(ms)
            unattributed += float(rec.get("unattributed_ms") or 0.0)
            if i > 0:
                prev = lives[i - 1]
                prev_end = (prev.get("arrival_wall") or 0.0) + float(
                    prev.get("duration_ms") or 0.0
                ) / 1e3
                gap = ((rec.get("arrival_wall") or 0.0) - prev_end) * 1e3
                gap_ms += max(gap, 0.0)
        phase_ms["journal_recovery"] = phase_ms.get("journal_recovery", 0.0) + gap_ms
        first, last = lives[0], lives[-1]
        total_ms = (
            (last.get("arrival_wall") or 0.0)
            + float(last.get("duration_ms") or 0.0) / 1e3
            - (first.get("arrival_wall") or 0.0)
        ) * 1e3
        attributed = sum(phase_ms.values())
        error_ms = total_ms - attributed - unattributed
        eps = eps_ms if eps_ms is not None else max(5.0, 0.02 * total_ms)
        out.append({
            "tag": tag,
            "lives": len(lives),
            "status": last.get("status"),
            "total_ms": round(total_ms, 3),
            "phase_ms": {k: round(v, 3) for k, v in sorted(phase_ms.items())},
            "journal_recovery_ms": round(gap_ms, 3),
            "unattributed_ms": round(unattributed, 3),
            "conservation_error_ms": round(error_ms, 3),
            "conservation_ok": abs(error_ms) <= eps,
            "blame": decompose_blame(phase_ms, total_ms, last.get("status") or "ok"),
        })
    return out


def summarize_traces(records: List[dict]) -> dict:
    """The report's offline blame decomposition: terminal counts, blame
    tally, unattributed residual stats, cross-life stitches, and the
    slowest completed requests."""
    terminal = [r for r in records if r.get("status") != "inflight"]
    inflight = [r for r in records if r.get("status") == "inflight"]
    blame: Dict[str, int] = {}
    for rec in terminal:
        b = rec.get("blame") or "none"
        blame[b] = blame.get(b, 0) + 1
    unattr = sorted(float(r.get("unattributed_ms") or 0.0) for r in terminal)
    worst = sorted(
        terminal, key=lambda r: -(float(r.get("duration_ms") or 0.0))
    )[:3]
    return {
        "requests": len(terminal),
        "inflight": len(inflight),
        "by_status": _tally(terminal, "status"),
        "by_blame": blame,
        "unattributed_ms": {
            "mean": round(sum(unattr) / len(unattr), 3) if unattr else 0.0,
            "max": round(unattr[-1], 3) if unattr else 0.0,
        },
        "stitched": stitch_traces(records),
        "worst": [
            {
                "rid": r.get("rid"),
                "tag": r.get("tag"),
                "duration_ms": r.get("duration_ms"),
                "blame": r.get("blame"),
                "phase_ms": r.get("phase_ms"),
            }
            for r in worst
        ],
    }


def _tally(records: List[dict], key: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for rec in records:
        v = str(rec.get(key))
        out[v] = out.get(v, 0) + 1
    return out


def format_trace_block(summary: dict) -> List[str]:
    """Human renderer for the report's "serving traces" postmortem block."""
    if not summary or (not summary.get("requests") and not summary.get("inflight")):
        return []
    lines = [
        f"serving traces (per-request blame) — {summary['requests']} completed, "
        f"{summary['inflight']} in-flight snapshot(s)"
    ]
    blame = summary.get("by_blame") or {}
    if blame:
        lines.append(
            "  blame: "
            + ", ".join(f"{k} {blame[k]}" for k in sorted(blame, key=lambda k: -blame[k]))
        )
    un = summary.get("unattributed_ms") or {}
    lines.append(
        f"  unattributed residual: mean {un.get('mean', 0.0)} ms, "
        f"max {un.get('max', 0.0)} ms"
    )
    for st in summary.get("stitched") or []:
        ok = "ok" if st.get("conservation_ok") else f"VIOLATED ({st.get('conservation_error_ms')} ms)"
        lines.append(
            f"  stitched tag {st['tag']!r}: {st['lives']} lives, "
            f"{st['total_ms']} ms total (journal_recovery {st['journal_recovery_ms']} ms), "
            f"blame {st['blame']}, conservation {ok}"
        )
    for w in summary.get("worst") or []:
        tag = f" [{w['tag']}]" if w.get("tag") else ""
        lines.append(
            f"  slowest: rid {w['rid']}{tag} {w['duration_ms']} ms — blame {w['blame']}"
        )
    return lines
