"""Device-timeline reconstruction from profiler trace dumps.

Two Chrome trace-event producers are read (see the JAX package's
``docs/package_reference/profile.md`` for the first):

- ``torch.profiler`` — ``export_chrome_trace(path)`` and
  ``tensorboard_trace_handler`` write ``*.pt.trace.json[.gz]``: the port's
  captures (``Accelerator.profile``, the flight recorder's anomaly window).
  Device work is the events whose ``cat`` is ``kernel``, ``gpu_memcpy`` or
  ``gpu_memset``; they live on the GPU's trace process (``pid`` = the device
  index, one ``tid`` per CUDA stream), so a device scope is one card.
  ``record_function`` ranges (every telemetry span) are ``user_annotation``
  host events, and their device projections ``gpu_user_annotation``.
- ``jax.profiler`` — ``<dir>/plugins/profile/<run>/<host>.trace.json.gz``:
  XLA op executions carry ``args.hlo_op`` (CPU/GPU) or live on a device
  process's ``XLA Ops`` lane (TPU).  Kept readable so a JAX capture (and the
  committed JAX fixture) parses here too.

Common to both: the top level is an object with a ``traceEvents`` list;
``ph == "M"`` metadata events name processes (``process_name``) and threads
(``thread_name``); ``ph == "X"`` complete events carry ``ts``/``dur`` in
microseconds; everything that is not device work is host-side bookkeeping.

Everything in this module is dependency-free stdlib: the same parser that
audits a live capture also runs offline on a committed fixture with no
accelerator present.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from dataclasses import dataclass, field
from typing import Optional

__all__ = [
    "TraceParseError",
    "TraceEvent",
    "Timeline",
    "load_trace_events",
    "find_trace_files",
    "build_timeline",
    "classify_op",
    "merge_intervals",
    "intervals_total",
    "subtract_intervals",
    "COMPUTE",
    "COLLECTIVE",
    "INFEED",
]

# Bucket names (the taxonomy the attribution report speaks).  Idle time is
# derived (window minus device-busy), not a per-op bucket.
COMPUTE = "compute"
COLLECTIVE = "collective"
INFEED = "infeed"

# HLO collective opcodes.  Op instruction names default to their opcode with
# optional ``.N`` uniquifiers and async ``-start``/``-done`` halves, so a
# prefix match on the opcode covers ``all-gather``, ``all-gather-start`` and
# ``all-gather.3`` alike without catching fusions named after their root
# (e.g. ``broadcast_add_fusion`` uses underscores, not opcode prefixes).
_COLLECTIVE_RE = re.compile(
    r"^(all-reduce|all-gather|reduce-scatter|all-to-all|ragged-all-to-all|"
    r"collective-permute|collective-broadcast)"
)
_INFEED_RE = re.compile(r"^(infeed|outfeed)")
# torch.profiler device events: NCCL kernels are collectives; host-to-device
# copies ("Memcpy HtoD (Pinned -> Device)", "... (Pageable -> Device)") are
# the infeed; every other kernel (the flash and paged kernels, cuBLAS GEMMs,
# elementwise work) and device-side copy is compute.
_TORCH_COLLECTIVE_RE = re.compile(r"^(void )?nccl", re.IGNORECASE)
_TORCH_INFEED_RE = re.compile(r"^Memcpy HtoD")
# ``cat`` values of device work in a torch.profiler trace.
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


class TraceParseError(ValueError):
    """A trace file that cannot be understood: truncated gzip, invalid JSON,
    or JSON that is not a trace-event bundle."""


@dataclass
class TraceEvent:
    """One complete (``ph == "X"``) trace event, times in microseconds."""

    name: str
    ts: float
    dur: float
    pid: int
    tid: int
    hlo_op: Optional[str] = None
    hlo_module: Optional[str] = None
    cat: Optional[str] = None  # torch.profiler's event category

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclass
class Timeline:
    """Parsed trace: device-op events plus the process/thread name maps and
    host-side step markers needed to attribute them."""

    events: list = field(default_factory=list)  # device-op TraceEvents
    host_events: list = field(default_factory=list)  # host-side TraceEvents
    process_names: dict = field(default_factory=dict)  # pid -> name
    thread_names: dict = field(default_factory=dict)  # (pid, tid) -> name
    n_raw_events: int = 0
    source: Optional[str] = None

    def device_scopes(self) -> dict:
        """Group device-op events by scope.

        In a torch.profiler trace each card is its own trace process (its
        device index), so a scope is one card; on TPU likewise each device
        (``/device:TPU:N``).  On a JAX CPU trace every virtual device's executor thread
        shares the single host process, so the scope is the whole (single
        process) fleet — overlap is then judged fleet-wide, which is the
        honest granularity the CPU trace offers (documented limit)."""
        scopes: dict = {}
        for ev in self.events:
            scopes.setdefault(ev.pid, []).append(ev)
        return scopes

    def lanes(self) -> dict:
        """Device-op events grouped by (pid, tid) lane (used for self-time)."""
        lanes: dict = {}
        for ev in self.events:
            lanes.setdefault((ev.pid, ev.tid), []).append(ev)
        return lanes

    def tracks(self) -> dict:
        """Human labels per (pid, tid) lane: ``"process/thread"`` from the
        metadata events, falling back to the raw ids.  Covers every lane any
        event (device or host) landed on — the serving Chrome-trace export
        validates its slot/request tracks through this."""
        out: dict = {}
        for ev in self.events + self.host_events:
            key = (ev.pid, ev.tid)
            if key in out:
                continue
            proc = self.process_names.get(ev.pid, str(ev.pid))
            thread = self.thread_names.get(key, str(ev.tid))
            out[key] = f"{proc}/{thread}"
        return out


def classify_op(name: str) -> str:
    """Bucket one device op by its HLO or kernel name: collective / infeed /
    compute."""
    if _COLLECTIVE_RE.match(name) or _TORCH_COLLECTIVE_RE.match(name):
        return COLLECTIVE
    if _INFEED_RE.match(name) or _TORCH_INFEED_RE.match(name):
        return INFEED
    return COMPUTE


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def find_trace_files(path: str) -> list:
    """Locate trace-event files under ``path``.

    Accepts a profiler output root (searches ``plugins/profile/<run>/``), a
    run directory, a directory holding torch.profiler's
    ``*.pt.trace.json[.gz]`` at any depth, or a single trace file.  Newest
    run wins when several captures share the root (a re-armed sentinel,
    repeated captures)."""
    if os.path.isfile(path):
        return [path]
    if not os.path.isdir(path):
        return []
    patterns = (
        os.path.join(path, "*.trace.json.gz"),
        os.path.join(path, "*.trace.json"),
        os.path.join(path, "plugins", "profile", "*", "*.trace.json.gz"),
        os.path.join(path, "plugins", "profile", "*", "*.trace.json"),
        os.path.join(path, "**", "*.trace.json.gz"),
        os.path.join(path, "**", "*.trace.json"),
    )
    for pattern in patterns:
        files = sorted(glob.glob(pattern, recursive=True))
        if files:
            # One run directory may hold one file per host; keep every file of
            # the newest run (same parent dir), not a mix of runs.
            newest_dir = os.path.dirname(max(files, key=os.path.getmtime))
            return [f for f in files if os.path.dirname(f) == newest_dir]
    return []


def load_trace_events(path: str) -> list:
    """Parse one trace file into its raw event dict list.

    Raises :class:`TraceParseError` for truncated gzip streams, invalid JSON,
    and JSON without a ``traceEvents`` list — a half-written capture (the
    process died mid-trace) must be rejected loudly, not half-analyzed."""
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8") as f:
                data = json.load(f)
        else:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
    except (OSError, EOFError, UnicodeDecodeError, ValueError) as e:
        # gzip truncation surfaces as EOFError/OSError ("CRC check failed"),
        # torn JSON as ValueError (json.JSONDecodeError subclasses it).
        raise TraceParseError(f"cannot parse trace file {path}: {e}") from e
    if not isinstance(data, dict) or not isinstance(data.get("traceEvents"), list):
        raise TraceParseError(
            f"{path} is not a trace-event bundle (no traceEvents list)"
        )
    return data["traceEvents"]


def build_timeline(raw_events: list, source: Optional[str] = None) -> Timeline:
    """Split raw trace events into device ops vs host events + name maps."""
    tl = Timeline(n_raw_events=len(raw_events), source=source)
    for rec in raw_events:
        if not isinstance(rec, dict):
            continue
        ph = rec.get("ph")
        pid = rec.get("pid", 0)
        tid = rec.get("tid", 0)
        if ph == "M":
            args = rec.get("args") or {}
            if rec.get("name") == "process_name":
                tl.process_names[pid] = str(args.get("name", ""))
            elif rec.get("name") == "thread_name":
                tl.thread_names[(pid, tid)] = str(args.get("name", ""))
            continue
        if ph != "X":
            continue
        try:
            ts = float(rec.get("ts", 0.0))
            dur = float(rec.get("dur", 0.0))
        except (TypeError, ValueError):
            continue
        args = rec.get("args") or {}
        hlo_op = args.get("hlo_op") if isinstance(args, dict) else None
        ev = TraceEvent(
            name=str(rec.get("name", "?")),
            ts=ts,
            dur=dur,
            pid=pid,
            tid=tid,
            hlo_op=str(hlo_op) if hlo_op is not None else None,
            hlo_module=(args.get("hlo_module") if isinstance(args, dict) else None),
            cat=str(rec["cat"]) if rec.get("cat") is not None else None,
        )
        if _is_device_op(ev, tl):
            tl.events.append(ev)
        else:
            tl.host_events.append(ev)
    return tl


def _is_device_op(ev: TraceEvent, tl: Timeline) -> bool:
    """A device op is a torch.profiler ``kernel`` / ``gpu_memcpy`` /
    ``gpu_memset`` event, or (JAX traces) carries ``args.hlo_op`` (CPU/GPU)
    or lives on a device process's ``XLA Ops`` lane (TPU)."""
    if ev.cat in DEVICE_CATS or ev.hlo_op is not None:
        return True
    proc = tl.process_names.get(ev.pid, "")
    if proc.startswith("/device:"):
        thread = tl.thread_names.get((ev.pid, ev.tid), "")
        return thread.startswith("XLA Ops")
    return False


# ---------------------------------------------------------------------------
# Interval arithmetic (all inputs/outputs are [start, end) pairs in µs)
# ---------------------------------------------------------------------------


def merge_intervals(intervals: list) -> list:
    """Union of possibly-overlapping intervals, sorted and disjoint."""
    out: list = []
    for start, end in sorted(i for i in intervals if i[1] > i[0]):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def intervals_total(intervals: list) -> float:
    """Total covered length of a DISJOINT (merged) interval list."""
    return sum(end - start for start, end in intervals)


def subtract_intervals(a: list, b: list) -> list:
    """``a − b`` for two merged interval lists: the parts of ``a`` not covered
    by ``b``.  This is the exposed-collective operator: collective-time minus
    concurrent-compute-time."""
    a = merge_intervals(a)
    b = merge_intervals(b)
    out = []
    j = 0
    for start, end in a:
        cur = start
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < end:
            bs, be = b[k]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if cur >= end:
                break
            k += 1
        if cur < end:
            out.append((cur, end))
    return out


def clip_intervals(intervals: list, start: float, end: float) -> list:
    """Restrict a merged interval list to a window."""
    out = []
    for s, e in intervals:
        s2, e2 = max(s, start), min(e, end)
        if e2 > s2:
            out.append((s2, e2))
    return out
