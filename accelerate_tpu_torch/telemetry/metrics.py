"""Metrics registry: counters, gauges, histograms + built-in collectors.

Dependency-free by design (stdlib, with ``torch.cuda`` touched lazily): the
registry must be constructible before any device is touched, and a snapshot
must serialize straight into the JSONL sink or a tracker ``log()`` call.

Built-in collectors:

- ``StepTimer`` — wall-time between completed optimizer steps, tokens/sec and
  an achieved-MFU estimate against the card's bf16 dense peak
  (:func:`peak_flops_per_chip`).
- ``CompileWatcher`` — counts the port's kernel builds: one ``nvcc`` run of
  ``ops/_build.py`` is a compile, a kernel library loaded from the build
  directory without one is a cache hit.  The port has no tracing JIT, so a
  moving count mid-training means a kernel source was rebuilt.
- ``collect_hbm`` — live/peak device memory bytes from the CUDA caching
  allocator (``torch.cuda.memory_stats``) and ``torch.cuda.mem_get_info``,
  under the JAX package's ``hbm.*`` names (the H100's memory is HBM3).
"""

from __future__ import annotations

import bisect
import collections
import threading
import time
from typing import Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "StepTimer",
    "CompileWatcher",
    "collect_hbm",
    "peak_flops_per_chip",
]

# Event names ``ops/_build.py`` reports: one per ``nvcc`` run, and one per
# kernel library loaded from the build directory without a build.
COMPILE_EVENT = "kernel_build"
CACHE_HIT_EVENT = "kernel_cache_hit"

_compile_listeners: list = []


def add_compile_listener(fn) -> None:
    """Register ``fn(event, duration_s)`` for ``ops/_build.py``'s events
    (kept for the life of the process, like a ``jax.monitoring`` listener)."""
    _compile_listeners.append(fn)


def note_compile_event(event: str, duration_s: float = 0.0) -> None:
    """Called by ``ops/_build.py``: forward one build event to every
    listener (a listener that raises is skipped)."""
    for fn in list(_compile_listeners):
        try:
            fn(event, duration_s)
        except Exception:
            pass


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1):
        self.value += n


class Gauge:
    """Last-value-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, value):
        self.value = float(value)


class Histogram:
    """Streaming distribution: exact count/sum/min/max plus a bounded window of
    recent observations for percentile estimates, and exact per-bucket counts
    over fixed bounds so the Prometheus exporter (``export.py``) can render a
    true ``_bucket``/``_sum``/``_count`` triplet over ALL observations, not
    just the recent window."""

    __slots__ = ("name", "count", "total", "min", "max", "last", "_recent", "bucket_counts")

    WINDOW = 1024
    # Exposition bucket upper bounds.  The registry's histograms are
    # millisecond-scale latencies (step time, TTFT, compile ms), so the
    # bounds span sub-ms to a minute; an implicit +Inf bucket catches the
    # rest.  Unit-free values (tokens/s) still render correctly — bucket
    # placement is just coarser.
    BOUNDS = (
        1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
        1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
    )

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.last = None
        self._recent = collections.deque(maxlen=self.WINDOW)
        self.bucket_counts = [0] * (len(self.BOUNDS) + 1)

    def observe(self, value):
        value = float(value)
        self.count += 1
        self.total += value
        self.last = value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        self._recent.append(value)
        self.bucket_counts[bisect.bisect_left(self.BOUNDS, value)] += 1

    def over_threshold_fraction(self, threshold: float) -> Optional[float]:
        """Fraction of the RECENT window strictly above ``threshold`` (the
        SLO burn-rate input; None before any observation)."""
        if not self._recent:
            return None
        over = sum(1 for v in self._recent if v > threshold)
        return over / len(self._recent)

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        data = sorted(self._recent)

        def pct(q):
            return data[min(int(q * len(data)), len(data) - 1)]

        return {
            "count": self.count,
            "mean": self.total / self.count,
            "min": self.min,
            "max": self.max,
            "last": self.last,
            "p50": pct(0.50),
            "p95": pct(0.95),
        }


class MetricsRegistry:
    """Name → metric store with get-or-create accessors and a flat snapshot."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(name)
            elif not isinstance(metric, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {type(metric).__name__}"
                )
            return metric

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get_or_create(name, Histogram)

    def peek(self, name: str):
        """Read a metric WITHOUT creating it (None when absent) — for readers
        like the flight recorder that must not materialize metrics the
        instrumented path never touched."""
        with self._lock:
            return self._metrics.get(name)

    def reset(self):
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        """Flat ``{name: scalar}`` view: counters/gauges as-is, histograms
        exploded into ``name.count/.mean/.p50/.p95/.max/.last``."""
        out: dict = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for metric in metrics:
            if isinstance(metric, Histogram):
                for k, v in metric.summary().items():
                    if v is not None:
                        out[f"{metric.name}.{k}"] = v
            elif metric.value is not None:
                out[metric.name] = metric.value
        return out


# ---------------------------------------------------------------------------
# Built-in collectors
# ---------------------------------------------------------------------------

# Per-card bf16 dense peak FLOP/s by device name, checked in order: the
# H100 SXM's 989 TFLOP/s, the figure PERF.md's MFU shares use.
_PEAK_FLOPS_TABLE = (
    ("h100", 989e12),
)
_DEFAULT_PEAK_FLOPS = 989e12


def peak_flops_per_chip(device=None) -> float:
    """bf16 dense peak FLOP/s of one card (``device`` an index or a
    ``torch.device``; default: card 0)."""
    import torch

    kind = torch.cuda.get_device_name(device).lower()
    for key, flops in _PEAK_FLOPS_TABLE:
        if key in kind:
            return flops
    return _DEFAULT_PEAK_FLOPS


def local_devices() -> list:
    """Indices of the visible CUDA devices ([] without CUDA)."""
    try:
        import torch

        if not torch.cuda.is_available():
            return []
        return list(range(torch.cuda.device_count()))
    except Exception:
        return []


def device_memory_stats(device) -> Optional[dict]:
    """A ``memory_stats()``-shaped dict for CUDA device ``device`` (an
    index), in the JAX package's keys: ``bytes_in_use`` and
    ``peak_bytes_in_use`` are the caching allocator's live and peak
    allocated bytes (``allocated_bytes.all.current`` / ``.peak``);
    ``bytes_limit`` is what the allocator could hold: the card's free bytes
    (``torch.cuda.mem_get_info``) plus what it has reserved already, so
    ``bytes_limit - bytes_in_use`` is the headroom left to tensors.  None
    when CUDA is absent.  No device sync: both are host-side queries."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        stats = torch.cuda.memory_stats(device)
        free, _total = torch.cuda.mem_get_info(device)
    except Exception:
        return None
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(free) + int(stats.get("reserved_bytes.all.current", 0)),
    }


def collect_hbm(registry: MetricsRegistry, device=None) -> dict:
    """Record device memory gauges across EVERY visible CUDA device (or just
    ``device`` when given): worst-device live/peak bytes and the fleet-min
    headroom (``bytes_limit - bytes_in_use`` over all devices, the binding
    constraint).

    ``hbm.stats_available`` is always published (1/0) so a dashboard can
    tell "no data" (a CPU run has no device stats) from "zero bytes"; the
    byte gauges only exist where stats do.
    """
    devices = [device] if device is not None else local_devices()
    in_use, peak, headroom = [], [], []
    for d in devices:
        stats = device_memory_stats(d)
        if not stats:
            continue
        if "bytes_in_use" in stats:
            in_use.append(int(stats["bytes_in_use"]))
            limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
            if limit:
                headroom.append(int(limit) - int(stats["bytes_in_use"]))
        if "peak_bytes_in_use" in stats:
            peak.append(int(stats["peak_bytes_in_use"]))
    available = bool(in_use or peak)
    registry.gauge("hbm.stats_available").set(1 if available else 0)
    out = {"hbm.stats_available": 1 if available else 0}
    if not available:
        return {}
    if in_use:
        registry.gauge("hbm.bytes_in_use").set(max(in_use))
        out["hbm.bytes_in_use"] = max(in_use)
    if peak:
        registry.gauge("hbm.peak_bytes").set(max(peak))
        out["hbm.peak_bytes"] = max(peak)
    if headroom:
        registry.gauge("hbm.fleet_min_headroom_bytes").set(min(headroom))
        out["hbm.fleet_min_headroom_bytes"] = min(headroom)
    return out


class StepTimer:
    """Wall-time between completed optimizer steps → step-time histogram,
    tokens/sec and achieved-MFU gauges (when configured with the workload's
    per-step token/FLOP counts)."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.tokens_per_step: Optional[float] = None
        self.flops_per_step: Optional[float] = None
        # Per-program analyzed FLOPs from the compiled-program inspector
        # (introspect.py).  When the user never configured a static estimate,
        # their sum IS the per-step FLOP count — measured-cost MFU.
        self.measured_flops: dict = {}
        self._last: Optional[float] = None

    def configure(self, tokens_per_step=None, flops_per_step=None):
        if tokens_per_step is not None:
            self.tokens_per_step = float(tokens_per_step)
        if flops_per_step is not None:
            self.flops_per_step = float(flops_per_step)

    def record_measured_flops(self, program: str, flops: float):
        """Register the XLA-analyzed FLOPs of one compiled program in the step
        (called by the inspector; latest capture per program name wins).
        NOTE: ``cost_analysis`` FLOPs are PER DEVICE (the SPMD-partitioned
        module), unlike ``configure(flops_per_step=)``'s global estimate —
        the MFU math normalizes the two differently."""
        self.measured_flops[program] = float(flops)

    @property
    def effective_flops_per_step(self) -> Optional[float]:
        """Explicit static estimate if configured, else the summed analyzed
        cost of every inspected step program — measured beats assumed."""
        if self.flops_per_step:
            return self.flops_per_step
        if self.measured_flops:
            return sum(self.measured_flops.values())
        return None

    def reset(self):
        self._last = None
        self.measured_flops.clear()

    def step(self) -> Optional[float]:
        """Mark one completed step; returns the step duration in seconds (None
        for the first step — there is no prior boundary to measure from)."""
        now = time.perf_counter()
        self.registry.counter("step.count").inc()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.registry.histogram("step.time_ms").observe(dt * 1e3)
            if self.tokens_per_step:
                self.registry.gauge("step.tokens_per_sec").set(self.tokens_per_step / dt)
            try:
                if self.flops_per_step:
                    # Global static estimate: normalize by the whole fleet
                    # (one card per process).
                    from .core import process_count

                    peak = peak_flops_per_chip() * process_count()
                    self.registry.gauge("step.mfu").set(self.flops_per_step / dt / peak)
                elif self.measured_flops:
                    # Analyzed cost is per device (SPMD module): per-chip peak
                    # only — the same value as global MFU under symmetric SPMD.
                    flops = sum(self.measured_flops.values())
                    self.registry.gauge("step.mfu").set(
                        flops / dt / peak_flops_per_chip()
                    )
            except Exception:
                pass
        self._last = now
        return dt


class CompileWatcher:
    """Standalone compile counter: registers a kernel-build listener and
    tallies ``nvcc`` builds (``count``, ``total_ms``) and libraries loaded
    without a build (``cache_hits``) between construction and ``stop()``.

    Listeners stay registered for the process's life, so the listener goes
    inert after ``stop()`` — construct sparingly (the telemetry singleton
    uses its own listener)."""

    def __init__(self):
        self.count = 0
        self.total_ms = 0.0
        self.cache_hits = 0
        self._active = True

        def _on_event(event, duration):
            if not self._active:
                return
            if event == COMPILE_EVENT:
                self.count += 1
                self.total_ms += duration * 1e3
            elif event == CACHE_HIT_EVENT:
                self.cache_hits += 1

        add_compile_listener(_on_event)

    def stop(self):
        self._active = False
