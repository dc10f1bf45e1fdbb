"""Stall watchdog: warn (with a thread dump) when no step completes in time.

A wedged device tunnel, a deadlocked collective, or a host-side data stall all
present the same way — the training loop simply stops making progress, inside
a C call no Python-level timeout can interrupt.  The watchdog runs on a
daemon thread, fed heartbeats by the instrumented hot paths
(``Telemetry.record_step`` on every completed optimizer step, the data-loader
placer on every batch); when the configured deadline passes without a beat it
logs a warning carrying every thread's current stack and writes a ``stall``
record to the telemetry JSONL.  One warning per stall episode — the next
heartbeat re-arms it.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
import traceback
from typing import Optional

__all__ = ["StallWatchdog", "thread_dump"]

logger = logging.getLogger(__name__)


def thread_dump() -> str:
    """Current stack of every live thread, watchdog threads excluded."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for ident, frame in frames.items():
        name = names.get(ident, "?")
        if name.startswith("atpu-watchdog"):
            continue
        stack = "".join(traceback.format_stack(frame))
        parts.append(f"--- thread {name} ({ident}) ---\n{stack}")
    return "\n".join(parts)


class StallWatchdog:
    """Deadline-based liveness monitor.

    ``beat()`` from any thread marks progress; the monitor thread checks every
    ``poll_s`` and fires once per stall episode when ``deadline_s`` elapses
    without a beat.
    """

    def __init__(self, deadline_s: float, telemetry=None, poll_s: Optional[float] = None):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.telemetry = telemetry
        self.poll_s = poll_s if poll_s is not None else min(max(deadline_s / 4.0, 0.01), 5.0)
        self.stall_count = 0
        self._last_beat = time.monotonic()
        self._stalled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self):
        self._last_beat = time.monotonic()
        self._stalled = False

    def start(self):
        if self._thread is not None:
            return self
        self._last_beat = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="atpu-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(self.poll_s * 4, 1.0))
            self._thread = None

    def _run(self):
        while not self._stop.wait(self.poll_s):
            elapsed = time.monotonic() - self._last_beat
            if elapsed <= self.deadline_s or self._stalled:
                continue
            self._stalled = True
            self.stall_count += 1
            dump = thread_dump()
            logger.warning(
                "no training step completed in %.1fs (deadline %.1fs) — the run "
                "may be stalled.  Thread dump:\n%s",
                elapsed,
                self.deadline_s,
                dump,
            )
            if self.telemetry is not None:
                self.telemetry.registry.counter("stall.count").inc()
                self.telemetry.write(
                    {
                        "kind": "stall",
                        "elapsed_s": round(elapsed, 3),
                        "deadline_s": self.deadline_s,
                        "threads": dump,
                    }
                )
