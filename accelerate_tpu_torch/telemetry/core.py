"""Telemetry runtime: enablement, per-process JSONL sink, singleton wiring.

Default-OFF.  Enable with ``ACCELERATE_TPU_TELEMETRY=1`` (honored by
``Accelerator.__init__``) or programmatically via ``telemetry.enable()``.
When disabled, the instrumented hot paths reduce to one attribute check — no
file handles, no listeners firing, no records.

JSONL schema (one record per line, ``telemetry_p<process>.jsonl``):

- ``{"kind": "span", "name", "path", "depth", "dur_ms", "t", "proc", ...}``
- ``{"kind": "compile", "dur_ms", ...}`` — one per kernel build (``nvcc``)
- ``{"kind": "stall", "elapsed_s", "deadline_s", "threads", ...}``
- ``{"kind": "event", "name", ...}`` — ad-hoc markers
- ``{"kind": "metrics", "snapshot": {...}}`` — final registry dump on disable/exit
- ``{"kind": "meta", ...}`` — run bookkeeping (enable time, pid)

The port has no tracing JIT: nothing is compiled per shape.  What it does
compile is its CUDA kernels, one ``nvcc`` per source on first use
(``ops/_build.py``), and those builds are the ``compile`` records and the
``jit.compiles`` / ``jit.compile_ms`` / ``jit.cache_hits`` metrics: a build
is a compile, a library loaded from the build directory without one a cache
hit.  The process index is the port's ``PartialState``'s.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Optional

from .flightrec import get_flight_recorder
from .memledger import get_memory_ledger
from .metrics import (
    CACHE_HIT_EVENT,
    COMPILE_EVENT,
    MetricsRegistry,
    StepTimer,
    add_compile_listener,
    collect_hbm,
)

__all__ = [
    "Telemetry",
    "get_telemetry",
    "enabled",
    "enable",
    "disable",
    "maybe_enable_from_env",
    "ENV_ENABLE",
    "ENV_DIR",
    "ENV_STALL_TIMEOUT",
]

ENV_ENABLE = "ACCELERATE_TPU_TELEMETRY"
ENV_DIR = "ACCELERATE_TPU_TELEMETRY_DIR"
ENV_STALL_TIMEOUT = "ACCELERATE_TPU_STALL_TIMEOUT_S"
DEFAULT_DIR = "telemetry"

_TRUTHY = {"1", "true", "yes", "on"}


def _env_flag(key: str) -> bool:
    return os.environ.get(key, "").strip().lower() in _TRUTHY


def process_index() -> int:
    """The port's process index (``PartialState``'s, 0 before one exists),
    read without constructing a state (which would pick a device)."""
    from ..state import PartialState

    return int(PartialState._shared_state.get("process_index", 0))


def process_count() -> int:
    """The port's process count (1 before a ``PartialState`` exists)."""
    from ..state import PartialState

    return int(PartialState._shared_state.get("num_processes", 1))


class Telemetry:
    """Process-wide telemetry hub: owns the metrics registry, the JSONL sink,
    the step timer, and (optionally) the stall watchdog."""

    def __init__(self):
        self.enabled = False
        self.dir: Optional[str] = None
        self.registry = MetricsRegistry()
        self.step_timer = StepTimer(self.registry)
        self.watchdog = None
        self._file = None
        self._lock = threading.Lock()
        self._proc: Optional[int] = None
        self._atexit_registered = False
        # pipeline.dispatches value at the last completed step — the delta
        # is the dispatches/step gauge.
        self._dispatch_mark = 0
        # Goodput ledger (goodput.py): when attached, every record written
        # through this hub is also classified into the wall-clock ledger.
        self.goodput = None
        self._goodput_steps = 0
        # Fleet aggregator (multi-host straggler/goodput gather); resolved
        # lazily on the first completed step so construction never touches
        # the backend.
        self._fleet = None
        self._fleet_resolved = False

    # -- lifecycle -----------------------------------------------------------

    def enable(self, dir: Optional[str] = None, stall_timeout_s: Optional[float] = None):
        """Turn telemetry on (idempotent).  ``dir`` defaults to
        ``$ACCELERATE_TPU_TELEMETRY_DIR`` then ``./telemetry``; a positive
        ``stall_timeout_s`` (or ``$ACCELERATE_TPU_STALL_TIMEOUT_S``) arms the
        stall watchdog."""
        if self.enabled:
            return self
        self.dir = dir or os.environ.get(ENV_DIR) or DEFAULT_DIR
        os.makedirs(self.dir, exist_ok=True)
        # Fresh-run semantics: a re-enable starts a new measurement window.
        self.registry.reset()
        self.step_timer.reset()
        self._dispatch_mark = 0
        self._file = None
        self.enabled = True
        _install_compile_listener()
        if stall_timeout_s is None:
            try:
                stall_timeout_s = float(os.environ.get(ENV_STALL_TIMEOUT, "0") or 0)
            except ValueError:
                stall_timeout_s = 0.0
        if stall_timeout_s and stall_timeout_s > 0:
            from .watchdog import StallWatchdog

            self.watchdog = StallWatchdog(stall_timeout_s, telemetry=self)
            self.watchdog.start()
        if not self._atexit_registered:
            self._atexit_registered = True
            atexit.register(self.disable)
        from . import export, goodput

        if goodput.enabled_from_env():
            goodput.attach()
        export.maybe_start_from_env()
        self.write({"kind": "meta", "event": "enabled", "pid": os.getpid()})
        return self

    def disable(self):
        """Flush the final metrics snapshot and turn everything off."""
        if not self.enabled:
            return
        if self.goodput is not None:
            # The ledger's last word lands in the final snapshot (and in the
            # exporter's final file write below).
            try:
                self.goodput.publish(self.registry)
            except Exception:
                pass
        self.write({"kind": "metrics", "snapshot": self.registry.snapshot()})
        self.enabled = False
        from . import export

        export.stop_if_running()
        self.goodput = None
        self._goodput_steps = 0
        self._fleet = None
        self._fleet_resolved = False
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    # -- sink ----------------------------------------------------------------

    def _process_index(self) -> int:
        if self._proc is None:
            self._proc = process_index()
        return self._proc

    @property
    def jsonl_path(self) -> Optional[str]:
        if self.dir is None:
            return None
        return os.path.join(self.dir, f"telemetry_p{self._process_index()}.jsonl")

    def write(self, record: dict):
        if not self.enabled:
            return
        record.setdefault("t", time.time())
        record.setdefault("proc", self._process_index())
        line = json.dumps(record, default=str)
        with self._lock:
            if self._file is None:
                # Line-buffered append: records are durable per line, so a
                # crashed run still leaves a parseable file.
                self._file = open(self.jsonl_path, "a", buffering=1)
            self._file.write(line + "\n")
        ledger = self.goodput
        if ledger is not None:
            # Classify outside the sink lock: the ledger has its own.
            try:
                ledger.observe_record(record)
            except Exception:
                pass
        if record.get("kind") == "stall":
            # Mirror watchdog stalls into the flight recorder as anomalies:
            # a stalled run is exactly the one about to be killed from
            # outside, so the durable timeline must carry it.
            rec = get_flight_recorder()
            if rec.enabled:
                rec.note_stall(
                    record.get("elapsed_s") or 0.0, record.get("deadline_s") or 0.0
                )

    def event(self, name: str, **fields):
        self.write({"kind": "event", "name": name, **fields})
        # Mirror ad-hoc markers into the flight recorder: preemption signals
        # and checkpoints, I/O retries, health rewinds — the resilience
        # subsystem already narrates itself through event(), so the durable
        # ring gets the same narration for free.
        rec = get_flight_recorder()
        if rec.enabled:
            rec.record("event", name=name, **fields)

    # -- hot-path hooks ------------------------------------------------------

    def heartbeat(self):
        """Liveness signal for the stall watchdog (batch fetched, step done)."""
        if self.watchdog is not None:
            self.watchdog.beat()

    def count_dispatch(self, n: int = 1):
        """Tally ``n`` dispatch sites on the training hot path (the
        forward+backward, a gradient scale/accumulate, an optimizer update;
        the JAX package's sites).  ``record_step`` folds the tally into the
        ``pipeline.dispatches_per_step`` gauge — the eager loop lands at
        ``3 × accum_steps`` per optimizer step, the fused train step at 1."""
        if self.enabled:
            self.registry.counter("pipeline.dispatches").inc(n)

    def record_step(self):
        """Mark one COMPLETED optimizer step: step-time histogram, derived
        tokens/sec + MFU gauges, HBM gauges, dispatches/step gauge, watchdog
        heartbeat."""
        if not self.enabled:
            return
        dt = self.step_timer.step()
        collect_hbm(self.registry)
        ledger = get_memory_ledger()
        if ledger.has_owners():
            # Conservation pass: attributed + program + unattributed ==
            # bytes_in_use per device, residual exposed as a gauge.  Owners
            # register once (train-step build, engine construction), so the
            # per-step cost is one memory_stats() round per local device.
            try:
                ledger.reconcile_and_publish(self.registry)
            except Exception:
                pass
        dispatches = self.registry.counter("pipeline.dispatches").value
        per_step = None
        if dispatches:
            per_step = dispatches - self._dispatch_mark
            self.registry.gauge("pipeline.dispatches_per_step").set(per_step)
        self._dispatch_mark = dispatches
        rec = get_flight_recorder()
        if rec.enabled:
            blocked = self.registry.peek("pipeline.host_blocked_ms")
            rec.note_step(
                step=self.registry.counter("step.count").value,
                dur_ms=dt * 1e3 if dt is not None else None,
                dispatches=per_step,
                host_blocked_ms=blocked.last if blocked is not None else None,
            )
        if self.goodput is not None:
            # Cadence-gated: the gauge refresh runs a full interval sweep,
            # which has no business on every hot-path step — the exporter
            # re-publishes on each scrape and disable() lands the final
            # value; this keeps the in-registry gauges merely *fresh-ish*
            # (first step, then every 16th).
            self._goodput_steps += 1
            if self._goodput_steps % 16 == 1:
                try:
                    self.goodput.publish(self.registry)
                except Exception:
                    pass
        fleet = self._fleet
        if fleet is None and not self._fleet_resolved:
            # Multi-host runs get fleet straggler/goodput aggregation for
            # free; single-host runs never build the aggregator (tests
            # install one explicitly via install_fleet_aggregator).
            self._fleet_resolved = True
            try:
                if process_count() > 1:
                    from .goodput import FleetAggregator

                    fleet = self._fleet = FleetAggregator()
            except Exception:
                pass
        if fleet is not None and dt is not None:
            try:
                fleet.on_step(dt * 1e3, telemetry=self)
            except Exception:
                pass
        self.heartbeat()

    def install_fleet_aggregator(self, aggregator) -> None:
        """Install (or replace) the fleet aggregator ``record_step`` drives —
        the explicit entry point for custom cadence/gather wiring and tests."""
        self._fleet = aggregator
        self._fleet_resolved = True


_TELEMETRY = Telemetry()


def get_telemetry() -> Telemetry:
    return _TELEMETRY


def enabled() -> bool:
    return _TELEMETRY.enabled


def enable(dir: Optional[str] = None, stall_timeout_s: Optional[float] = None) -> Telemetry:
    return _TELEMETRY.enable(dir=dir, stall_timeout_s=stall_timeout_s)


def disable():
    _TELEMETRY.disable()


def maybe_enable_from_env() -> bool:
    """Enable iff ``$ACCELERATE_TPU_TELEMETRY`` is truthy (the Accelerator
    constructor calls this so env-only runs need no code changes).  Also
    honors ``$ACCELERATE_TPU_FLIGHTREC`` for the flight recorder (which
    enables telemetry as a side effect — the recorder feeds off its hooks)."""
    if not _TELEMETRY.enabled and _env_flag(ENV_ENABLE):
        _TELEMETRY.enable()
    from .flightrec import maybe_enable_from_env as _flightrec_from_env

    _flightrec_from_env()
    return _TELEMETRY.enabled


# ---------------------------------------------------------------------------
# Compile-event listener (module-level: exactly ONE is ever installed with
# ``ops/_build.py``, and it forwards to the singleton only while telemetry
# is enabled).
# ---------------------------------------------------------------------------

_compile_listener_installed = False


def _on_build_event(event, duration):
    tel = _TELEMETRY
    if not tel.enabled:
        return
    if event == CACHE_HIT_EVENT:
        # A kernel library loaded from the build directory: no nvcc ran.
        tel.registry.counter("jit.cache_hits").inc()
        return
    if event != COMPILE_EVENT:
        return
    dur_ms = duration * 1e3
    tel.registry.counter("jit.compiles").inc()
    tel.registry.histogram("jit.compile_ms").observe(dur_ms)
    tel.write({"kind": "compile", "dur_ms": round(dur_ms, 3)})
    rec = get_flight_recorder()
    if rec.enabled:
        # A mid-training build is both a recorder-worthy event and a
        # rebuild smell the postmortem should surface.
        rec.record("compile", dur_ms=round(dur_ms, 3))


def _install_compile_listener():
    global _compile_listener_installed
    if _compile_listener_installed:
        return
    _compile_listener_installed = True
    add_compile_listener(_on_build_event)
