"""Anomaly sentinel: online slow-step / stall / straggler detection.

The flight recorder (``flightrec.py``) keeps a timeline of what happened;
the sentinel watches that stream *as it happens* and decides which moments
deserve attention — so the one-shot ``torch.profiler`` capture window fires on
the first anomalous step, not after a human greps the postmortem.

Detection is deliberately simple and dependency-free:

- **slow step** — a step whose duration exceeds ``factor ×`` the rolling
  median of the last ``window`` steps (with a ``min_excess_ms`` floor so
  microsecond-scale CPU noise cannot trip the multiplicative test).  The
  median is judged *before* the new sample joins the window, so a slow step
  cannot mask itself; after a genuine regime change (e.g. a new sequence
  length doubling step time) the window re-centers within ``window/2`` steps
  and the sentinel goes quiet again.
- **stall** — forwarded from the stall watchdog (no step completed within
  its deadline); always anomalous.
- **straggler** (multi-host hook) — per-host step durations fed through
  :meth:`observe_host_step` keep a rolling median per host;
  :meth:`straggler_report` names hosts whose median exceeds
  ``straggler_factor ×`` the fleet median.  Today's runtime is single-host,
  so nothing calls this on the hot path yet — the multi-host runtime
  (ROADMAP item 2) gets its per-host attribution for free.

No warmup, no verdicts: until ``warmup`` samples exist every step is judged
healthy, bounding false positives on short runs.
"""

from __future__ import annotations

import collections
import statistics
from typing import Optional

__all__ = ["AnomalySentinel"]


class AnomalySentinel:
    """Rolling-median anomaly judge over the per-step event stream.

    ``observe(dur_ms)`` returns ``None`` for a healthy step or a dict
    describing the anomaly (``reason``, the offending duration, the rolling
    median, and the ratio) — the flight recorder records it and triggers the
    one-shot profiler window.
    """

    def __init__(
        self,
        window: int = 64,
        warmup: int = 16,
        factor: float = 3.0,
        min_excess_ms: float = 10.0,
        straggler_factor: float = 1.5,
    ):
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        if warmup < 2:
            raise ValueError(f"warmup must be >= 2, got {warmup}")
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1.0, got {factor}")
        self.window = window
        self.warmup = min(warmup, window)
        self.factor = factor
        self.min_excess_ms = min_excess_ms
        self.straggler_factor = straggler_factor
        self.observed = 0
        self.anomaly_count = 0
        self._durs: collections.deque = collections.deque(maxlen=window)
        self._hosts: dict = {}

    # -- single-host stream ----------------------------------------------------

    def median_ms(self) -> Optional[float]:
        """Rolling median of the current window (None before any sample)."""
        if not self._durs:
            return None
        return float(statistics.median(self._durs))

    def observe(self, dur_ms: float) -> Optional[dict]:
        """Judge one completed step.  Returns an anomaly descriptor or None.

        The sample is judged against the window *before* joining it, then
        appended regardless of verdict — anomalous samples age into the
        median so a persistent slowdown stops alerting once it becomes the
        new normal (the recorder keeps the first ``window/2`` alerts; that is
        the signal a human wants)."""
        dur_ms = float(dur_ms)
        verdict = None
        if self.observed >= self.warmup:
            med = float(statistics.median(self._durs))
            if dur_ms > self.factor * med and dur_ms - med > self.min_excess_ms:
                verdict = {
                    "reason": "slow_step",
                    "dur_ms": round(dur_ms, 3),
                    "median_ms": round(med, 3),
                    "ratio": round(dur_ms / med, 2) if med > 0 else None,
                }
        self._durs.append(dur_ms)
        self.observed += 1
        if verdict is not None:
            self.anomaly_count += 1
        return verdict

    def stall(self, elapsed_s: float, deadline_s: float) -> dict:
        """A watchdog stall is always an anomaly (no median judgment — the
        deadline already encodes the operator's tolerance)."""
        self.anomaly_count += 1
        return {
            "reason": "stall",
            "elapsed_s": round(float(elapsed_s), 3),
            "deadline_s": float(deadline_s),
        }

    # -- multi-host straggler hooks -------------------------------------------

    def observe_host_step(self, host: int, dur_ms: float) -> None:
        """Feed one host's step duration (multi-host runtimes call this with
        gathered per-host timings; single-host runs never do)."""
        durs = self._hosts.get(host)
        if durs is None:
            durs = self._hosts[host] = collections.deque(maxlen=self.window)
        durs.append(float(dur_ms))

    def straggler_report(self) -> list:
        """Hosts whose rolling-median step time exceeds ``straggler_factor ×``
        the fleet median (median of per-host medians).  Hosts with fewer than
        ``warmup`` samples are not judged."""
        medians = {
            host: float(statistics.median(durs))
            for host, durs in self._hosts.items()
            if len(durs) >= self.warmup
        }
        if len(medians) < 2:
            return []
        fleet = statistics.median(medians.values())
        if fleet <= 0:
            return []
        return [
            {
                "host": host,
                "median_ms": round(med, 3),
                "fleet_median_ms": round(fleet, 3),
                "ratio": round(med / fleet, 2),
            }
            for host, med in sorted(medians.items())
            if med > self.straggler_factor * fleet
        ]
