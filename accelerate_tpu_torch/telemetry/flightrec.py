"""Black-box flight recorder: a durable timeline of the training hot path.

Telemetry (``core.py``) answers "how is the run doing" *while the process is
alive*; when a run dies (preemption, OOM kill, a wedged device, an
unhandled exception) the in-process registry evaporates with it and the
postmortem starts from nothing.  The flight recorder is the black box: a
bounded ring buffer of structured per-step events — step time, dispatches per
step, host-blocked ms, compile events, health-guard verdicts, checkpoint
publishes and I/O retries, preemption signals — flushed to a crash-safe JSONL
snapshot periodically and on every way a process can die that leaves Python
running long enough to write a file:

- **SIGTERM/SIGINT** — a *chaining* handler (records a ``signal`` event,
  flushes, then invokes whatever handler was installed before it).  It
  composes with :class:`~accelerate_tpu_torch.resilience.PreemptionGuard`'s
  flags-only handler in either install order and never replaces it; with no
  other handler installed the default die-on-SIGTERM semantics are re-raised
  after the flush.
- **atexit** — normal interpreter shutdown.
- **unhandled exception** — a ``sys.excepthook`` wrapper records a ``crash``
  event (exception type + message) before delegating to the previous hook.

Only SIGKILL and a hard machine loss can outrun it, and even then the last
periodic flush (every ``flush_every`` events) is on disk.

The flush rewrites the whole ring snapshot into ``flightrec_p<proc>.jsonl``
via write-temp + atomic rename, so a crash *during* a flush leaves the
previous snapshot intact — the file on disk is always a complete, parseable
view of the last ``capacity`` events.  Summarize one with
``python -m accelerate_tpu_torch.telemetry.report <dir>`` (the postmortem block).

An :class:`~accelerate_tpu_torch.telemetry.sentinel.AnomalySentinel` watches the
step stream online: rolling-median slow-step detection, watchdog stalls, and
per-host straggler hooks.  The first anomaly triggers a one-shot
``torch.profiler`` window over the host and the card (its Chrome trace
exported as ``<dir>/anomaly_trace/*.pt.trace.json.gz``;
``ACCELERATE_TPU_SENTINEL_PROFILE=0`` disables) so the profile of the *bad*
steps is captured
without anyone watching the run.  The capture is then auto-analyzed off the
hot path by ``profile_scan`` and its attribution digest (exposed-collective
ms, overlap fraction, top ops) lands back in the ring as a
``sentinel.profile_digest`` event — the postmortem explains *why* the slow
step was slow, not just that it happened.

Default-off.  ``ACCELERATE_TPU_FLIGHTREC=1`` (honored by ``Accelerator()``
via ``telemetry.maybe_enable_from_env``) or ``flightrec.enable()`` turn it
on; enabling the recorder also enables telemetry — the recorder is fed by
telemetry's hooks (``record_step``, the compile listener, ``event()``), so a
recorder without telemetry would record nothing.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import signal
import socket
import sys
import threading
import time
from typing import Optional

from .sentinel import AnomalySentinel

__all__ = [
    "FlightRecorder",
    "get_flight_recorder",
    "enable",
    "disable",
    "maybe_enable_from_env",
    "ENV_ENABLE",
    "ENV_DIR",
    "ENV_CAPACITY",
    "ENV_FLUSH_EVERY",
    "ENV_SENTINEL_PROFILE",
]

ENV_ENABLE = "ACCELERATE_TPU_FLIGHTREC"
ENV_DIR = "ACCELERATE_TPU_FLIGHTREC_DIR"
ENV_CAPACITY = "ACCELERATE_TPU_FLIGHTREC_CAPACITY"
ENV_FLUSH_EVERY = "ACCELERATE_TPU_FLIGHTREC_FLUSH_EVERY"
ENV_SENTINEL_PROFILE = "ACCELERATE_TPU_SENTINEL_PROFILE"

DEFAULT_CAPACITY = 4096
DEFAULT_FLUSH_EVERY = 64
PROFILE_WINDOW_STEPS = 3

_TRUTHY = {"1", "true", "yes", "on"}
_OFF = {"0", "false", "no", "off"}


def _env_int(key: str, default: int) -> int:
    try:
        return int(os.environ.get(key, "") or default)
    except ValueError:
        return default


def _fsync_enabled() -> bool:
    # Shares the resilience subsystem's durability switch: the test suite
    # (and throwaway runs) set ACCELERATE_TPU_CHECKPOINT_FSYNC=0 once and
    # both checkpoint publishes and recorder flushes skip the fsync.
    return os.environ.get("ACCELERATE_TPU_CHECKPOINT_FSYNC", "1").strip().lower() not in _OFF


class FlightRecorder:
    """Process-wide ring buffer of structured events with crash-safe flush.

    Thread-safe: ``record()`` may be called from any thread (the prefetcher,
    the watchdog, user threads).  The lock is reentrant because the
    flush-on-signal handler runs *on the main thread between bytecodes* — it
    must be able to flush even when it interrupted a ``record()`` that
    already holds the lock.
    """

    def __init__(self):
        self.enabled = False
        self.dir: Optional[str] = None
        self.capacity = DEFAULT_CAPACITY
        self.flush_every = DEFAULT_FLUSH_EVERY
        self.sentinel: Optional[AnomalySentinel] = None
        self._ring: collections.deque = collections.deque(maxlen=DEFAULT_CAPACITY)
        self._lock = threading.RLock()
        self._seq = 0
        self._since_flush = 0
        self._proc: Optional[int] = None
        self._prev_handlers: dict = {}
        self._in_signal: dict = {}
        self._prev_excepthook = None
        self._atexit_registered = False
        # one-shot profiler window: "armed" -> "tracing" -> "done"
        self._profile_state = "armed"
        self._profile_stop_step: Optional[int] = None
        self._profile_dir: Optional[str] = None
        self._profile_trigger_step: Optional[int] = None
        self._profiler = None
        self._analysis_thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------

    def enable(
        self,
        dir: Optional[str] = None,
        capacity: Optional[int] = None,
        flush_every: Optional[int] = None,
        sentinel: Optional[AnomalySentinel] = None,
    ) -> "FlightRecorder":
        """Turn the recorder on (idempotent).  ``dir`` defaults to
        ``$ACCELERATE_TPU_FLIGHTREC_DIR``, then the telemetry dir.  Also
        enables telemetry — the recorder is fed by its hooks."""
        if self.enabled:
            return self
        from . import core

        tel = core.get_telemetry()
        explicit = dir or os.environ.get(ENV_DIR)
        if not tel.enabled:
            # Telemetry lands in the recorder's dir (one run directory) when
            # the recorder names one; otherwise telemetry's own defaults win.
            tel.enable(dir=explicit)
        self.dir = explicit or tel.dir
        os.makedirs(self.dir, exist_ok=True)
        self.capacity = int(capacity or _env_int(ENV_CAPACITY, DEFAULT_CAPACITY))
        self.flush_every = max(1, int(flush_every or _env_int(ENV_FLUSH_EVERY, DEFAULT_FLUSH_EVERY)))
        self.sentinel = sentinel or AnomalySentinel()
        with self._lock:
            self._ring = collections.deque(maxlen=self.capacity)
            self._seq = 0
            self._since_flush = 0
        self._profile_state = "armed"
        self._profile_stop_step = None
        self._profile_dir = None
        self._profile_trigger_step = None
        self._analysis_thread = None
        self.enabled = True
        self._install_signal_flush()
        self._install_excepthook()
        if not self._atexit_registered:
            self._atexit_registered = True
            atexit.register(self._atexit_flush)
        self.record(
            "meta",
            event="enabled",
            pid=os.getpid(),
            capacity=self.capacity,
            flush_every=self.flush_every,
        )
        return self

    def disable(self):
        """Final flush, restore signal handlers / excepthook, turn off."""
        if not self.enabled:
            return
        # A window still open is closed (and its trace written): a torch
        # profiler left running would record every later op.
        self._maybe_stop_profile(None)
        self._join_analysis(timeout=30.0)
        self.record("meta", event="disabled")
        self.flush(reason="disable")
        self.enabled = False
        self._uninstall_signal_flush()
        self._uninstall_excepthook()

    # -- identity --------------------------------------------------------------

    def _process_index(self) -> int:
        if self._proc is None:
            from .core import process_index

            self._proc = process_index()
        return self._proc

    @property
    def jsonl_path(self) -> Optional[str]:
        if self.dir is None:
            return None
        return os.path.join(self.dir, f"flightrec_p{self._process_index()}.jsonl")

    # -- recording -------------------------------------------------------------

    def record(self, kind: str, **fields):
        """Append one event to the ring; flush every ``flush_every`` events."""
        if not self.enabled:
            return
        rec = {"kind": kind, "t": time.time(), "proc": self._process_index(), **fields}
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
            self._since_flush += 1
            if self._since_flush >= self.flush_every:
                self._flush_locked()

    def note_step(
        self,
        step: Optional[int] = None,
        dur_ms: Optional[float] = None,
        dispatches: Optional[float] = None,
        host_blocked_ms: Optional[float] = None,
        **fields,
    ):
        """One completed optimizer step (called by ``Telemetry.record_step``).
        Feeds the sentinel; an anomalous verdict is recorded, flushed
        immediately (an anomaly is exactly when the timeline matters), and
        triggers the one-shot profiler window."""
        if not self.enabled:
            return
        ev: dict = {"step": step}
        if dur_ms is not None:
            ev["dur_ms"] = round(float(dur_ms), 3)
        if dispatches is not None:
            ev["dispatches"] = dispatches
        if host_blocked_ms is not None:
            ev["host_blocked_ms"] = round(float(host_blocked_ms), 3)
        ev.update(fields)
        self.record("step", **ev)
        anomaly = None
        if dur_ms is not None and self.sentinel is not None:
            anomaly = self.sentinel.observe(dur_ms)
        if anomaly is not None:
            self.record("anomaly", step=step, **anomaly)
            self._count_anomaly(anomaly)
            self._maybe_start_profile(step)
            self.flush(reason="anomaly")
        self._maybe_stop_profile(step)

    def note_stall(self, elapsed_s: float, deadline_s: float):
        """A watchdog stall (forwarded from the telemetry sink): always an
        anomaly, immediately flushed — the run may be about to be killed."""
        if not self.enabled:
            return
        anomaly = (self.sentinel or AnomalySentinel()).stall(elapsed_s, deadline_s)
        self.record("anomaly", **anomaly)
        self._count_anomaly(anomaly)
        self._maybe_start_profile(None)
        self.flush(reason="stall")

    def _count_anomaly(self, anomaly: dict):
        from . import core

        tel = core.get_telemetry()
        if tel.enabled:
            tel.registry.counter("sentinel.anomalies").inc()
            tel.write({"kind": "event", "name": "sentinel.anomaly", **anomaly})

    # -- flushing --------------------------------------------------------------

    def flush(self, reason: Optional[str] = None, timeout: Optional[float] = None):
        """Rewrite the JSONL snapshot atomically (write-temp + rename).  A
        bounded ``timeout`` is used from signal context so a lock held by a
        wedged writer thread cannot deadlock the handler."""
        if not self.enabled or self.dir is None:
            return False
        if timeout is not None:
            acquired = self._lock.acquire(timeout=timeout)
        else:
            acquired = self._lock.acquire()
        if not acquired:
            return False
        try:
            self._flush_locked()
            return True
        finally:
            self._lock.release()

    def _flush_locked(self):
        path = self.jsonl_path
        tmp = f"{path}.tmp"
        try:
            with open(tmp, "w") as f:
                for rec in self._ring:
                    f.write(json.dumps(rec, default=str) + "\n")
                f.flush()
                if _fsync_enabled():
                    try:
                        os.fsync(f.fileno())
                    except OSError:
                        pass
            os.replace(tmp, path)
            self._since_flush = 0
        except OSError:
            # The recorder must never take the run down; the previous
            # snapshot (if any) is still intact on disk.
            pass

    # -- crash paths -----------------------------------------------------------

    def _atexit_flush(self):
        if self.enabled:
            self._join_analysis(timeout=10.0)
            self.record("meta", event="exit")
            self.flush(reason="atexit")

    def _install_signal_flush(self):
        """Chain onto SIGTERM/SIGINT without replacing whoever is installed
        (``PreemptionGuard``'s flags-only handler keeps firing)."""
        for signum in (signal.SIGTERM, signal.SIGINT):
            try:
                prev = signal.signal(signum, self._on_signal)
            except (ValueError, OSError):
                # Not the main thread (or an embedded interpreter): periodic
                # + atexit + excepthook flushes still cover this process.
                return
            self._prev_handlers[signum] = prev

    def _uninstall_signal_flush(self):
        for signum, prev in list(self._prev_handlers.items()):
            # Only restore when we are still the registered handler — someone
            # (e.g. PreemptionGuard) may have installed over us and now chains
            # to us; yanking the registration out from under them would break
            # their chain.
            if signal.getsignal(signum) == self._on_signal:
                try:
                    signal.signal(signum, prev)
                except (ValueError, TypeError, OSError):
                    # e.g. called off the main thread: we are still the
                    # registered handler, so the chain entry must survive.
                    continue
                del self._prev_handlers[signum]

    def _on_signal(self, signum, frame):
        if self._in_signal.get(signum):
            # Re-entered through a handler CYCLE (enable -> guard install ->
            # disable-while-covered -> re-enable leaves this handler both
            # registered and in the guard's chain): the outer invocation
            # already recorded + flushed; break the loop.
            return
        self._in_signal[signum] = True
        try:
            self.record("signal", signum=int(signum), name=signal.Signals(signum).name)
            self.flush(reason="signal", timeout=5.0)
            prev = self._prev_handlers.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL and signal.getsignal(signum) == self._on_signal:
                # We are the OUTERMOST handler over the default disposition:
                # preserve die-on-signal semantics (a flight recorder must never
                # make a process unkillable).  When we are a chained inner
                # handler (a guard installed over us and invoked us), the outer
                # handler owns the policy — do not re-raise.
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
        finally:
            self._in_signal[signum] = False

    def _install_excepthook(self):
        if self._prev_excepthook is not None:
            return
        self._prev_excepthook = sys.excepthook

        def _hook(exc_type, exc, tb):
            try:
                self.record(
                    "crash",
                    error=getattr(exc_type, "__name__", str(exc_type)),
                    message=str(exc)[:500],
                )
                self.flush(reason="crash")
            except Exception:
                pass
            prev = self._prev_excepthook or sys.__excepthook__
            prev(exc_type, exc, tb)

        self._flightrec_hook = _hook
        sys.excepthook = _hook

    def _uninstall_excepthook(self):
        if self._prev_excepthook is None:
            return
        if sys.excepthook is getattr(self, "_flightrec_hook", None):
            sys.excepthook = self._prev_excepthook
        self._prev_excepthook = None

    # -- one-shot profiler window ---------------------------------------------

    def _profile_enabled(self) -> bool:
        return os.environ.get(ENV_SENTINEL_PROFILE, "1").strip().lower() not in _OFF

    def _maybe_start_profile(self, step: Optional[int]):
        if self._profile_state != "armed" or not self._profile_enabled():
            return
        trace_dir = os.path.join(self.dir, "anomaly_trace")
        try:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(trace_dir, exist_ok=True)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
            self._profiler = profiler
        except Exception as e:
            self._profile_state = "done"  # no second attempt on a broken profiler
            self.record("event", name="sentinel.profile_failed", error=str(e)[:200])
            return
        self._profile_state = "tracing"
        self._profile_stop_step = (step or 0) + PROFILE_WINDOW_STEPS
        self._profile_dir = trace_dir
        self._profile_trigger_step = step
        self.record("event", name="sentinel.profile_start", dir=trace_dir, step=step)

    def _maybe_stop_profile(self, step: Optional[int]):
        if self._profile_state != "tracing":
            return
        if step is not None and self._profile_stop_step is not None and step < self._profile_stop_step:
            return
        profiler, self._profiler = self._profiler, None
        try:
            # The Chrome trace lands in the window's directory under the
            # name torch's own trace handler uses, which ``timeline`` finds.
            profiler.stop()
            profiler.export_chrome_trace(os.path.join(
                self._profile_dir,
                f"{socket.gethostname()}_p{self._process_index()}.pt.trace.json.gz"))
        except Exception:
            pass
        self._profile_state = "done"
        # The capture is a flight-recorder fact (path + trigger step, so the
        # postmortem can link it to its anomaly); analysis runs on a worker
        # thread — the training loop never blocks on the scanner.
        self.record(
            "event",
            name="sentinel.profile_captured",
            dir=self._profile_dir,
            trigger_step=self._profile_trigger_step,
            stop_step=step,
        )
        self.flush(reason="profile_captured")
        self._analysis_thread = threading.Thread(
            target=self._analyze_capture,
            args=(self._profile_dir, self._profile_trigger_step),
            name="flightrec-profile-scan",
            daemon=True,
        )
        self._analysis_thread.start()

    def _analyze_capture(self, trace_dir: Optional[str], trigger_step: Optional[int]):
        """Off-hot-path worker: scan the captured trace and append the
        attribution digest to the ring, so the postmortem explains *why* the
        slow step was slow, not just that it happened."""
        report = None
        try:
            from . import profile_scan

            report = profile_scan.analyze_trace_dir(trace_dir)
            self.record(
                "event",
                name="sentinel.profile_digest",
                trigger_step=trigger_step,
                dir=trace_dir,
                **profile_scan.digest(report),
            )
        except Exception as e:
            # The analyzer must never take the run (or its shutdown) down.
            self.record(
                "event",
                name="sentinel.profile_analysis_failed",
                trigger_step=trigger_step,
                dir=trace_dir,
                error=str(e)[:200],
            )
        if report is not None:
            # Outside the failure-recording try: a publish hiccup must not
            # shadow the valid digest already sitting in the ring.
            try:
                from . import core

                tel = core.get_telemetry()
                if tel.enabled:
                    profile_scan.publish(report, telemetry=tel)
            except Exception:
                pass
        self.flush(reason="profile_digest")

    def _join_analysis(self, timeout: float):
        """Give an in-flight capture analysis a bounded chance to land its
        digest in the snapshot before the recorder goes away."""
        thread = self._analysis_thread
        if thread is not None and thread.is_alive() and thread is not threading.current_thread():
            thread.join(timeout=timeout)

    # -- views -----------------------------------------------------------------

    def snapshot(self) -> list:
        """Copy of the current ring contents (oldest first)."""
        with self._lock:
            return list(self._ring)


_RECORDER = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _RECORDER


def enable(
    dir: Optional[str] = None,
    capacity: Optional[int] = None,
    flush_every: Optional[int] = None,
    sentinel: Optional[AnomalySentinel] = None,
) -> FlightRecorder:
    return _RECORDER.enable(dir=dir, capacity=capacity, flush_every=flush_every, sentinel=sentinel)


def disable():
    _RECORDER.disable()


def maybe_enable_from_env() -> bool:
    """Enable iff ``$ACCELERATE_TPU_FLIGHTREC`` is truthy (called from
    ``telemetry.maybe_enable_from_env``, which ``Accelerator.__init__`` runs —
    env-only runs need no code changes)."""
    if not _RECORDER.enabled and os.environ.get(ENV_ENABLE, "").strip().lower() in _TRUTHY:
        _RECORDER.enable()
    return _RECORDER.enabled
