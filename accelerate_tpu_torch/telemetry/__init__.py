"""Dependency-free observability for the training and serving hot paths.

The JAX package's telemetry (``accelerate_tpu/telemetry``), ported: the same
metric names, record kinds, JSONL layout and environment variables, so a run
directory the port writes reads with either package's ``report``.

- **trace spans** — ``span("name")`` context-manager/decorator: wall-time,
  process index and nesting to a per-process JSONL file, mirrored into
  ``torch.profiler.record_function`` for Chrome/Perfetto traces;
- **metrics registry** — counters/gauges/histograms with built-in collectors
  for step time, kernel builds (``jit.compiles``: one ``nvcc`` run each; the
  port has no tracing JIT), tokens/sec, achieved MFU against the card's bf16
  peak, and device memory bytes from the CUDA caching allocator;
- **stall watchdog** — warns with a full thread dump when no step completes
  within a configurable deadline;
- **flight recorder + anomaly sentinel** — a bounded ring of per-step events
  flushed crash-safe on SIGTERM/exit/crash, with online rolling-median
  anomaly detection and a one-shot ``torch.profiler`` capture
  (``ACCELERATE_TPU_FLIGHTREC=1``; ``flightrec.py`` / ``sentinel.py``);
- **memory ledger** — per-subsystem device-memory attribution with a
  per-device conservation contract, OOM forensics and serving-headroom
  gauges (``memledger.py``);
- **goodput accounting + metrics export** — the wall-clock attribution
  ledger (``ACCELERATE_TPU_GOODPUT=1``), fleet straggler aggregation, and a
  Prometheus text-exposition endpoint / atomic snapshot
  (``ACCELERATE_TPU_METRICS_PORT`` / ``..._SNAPSHOT``; ``goodput.py`` /
  ``export.py``);
- **trace attribution** — ``timeline.py`` / ``profile_scan.py`` read
  torch-profiler Chrome traces (and JAX ones): device-busy time, top kernels,
  per-step windows.

The JAX package's compiled-program introspection (``introspect``,
``hlo_scan``) waits for ROADMAP A6 part 6: its subject is comms over a
mesh.

Default-off: enable with ``ACCELERATE_TPU_TELEMETRY=1`` (honored by
``Accelerator()``) or ``telemetry.enable()``.  Summarize a run with
``python -m accelerate_tpu_torch.telemetry.report <dir>``.
"""

from .core import (
    ENV_DIR,
    ENV_ENABLE,
    ENV_STALL_TIMEOUT,
    Telemetry,
    disable,
    enable,
    enabled,
    get_telemetry,
    maybe_enable_from_env,
)
from .metrics import (
    CompileWatcher,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    StepTimer,
    collect_hbm,
    peak_flops_per_chip,
)
from .flightrec import FlightRecorder, get_flight_recorder
from .profile_scan import (
    ProfileReport as TraceProfileReport,
    analyze_trace_dir,
    analyze_trace_file,
)
from .export import MetricsExporter, render_prometheus
from .goodput import FleetAggregator, GoodputLedger
from .memledger import MemoryLedger, get_memory_ledger, tree_device_bytes
from .sentinel import AnomalySentinel
from .timeline import Timeline, TraceEvent, TraceParseError
from .spans import span
from .watchdog import StallWatchdog, thread_dump

__all__ = [
    "Telemetry",
    "get_telemetry",
    "enabled",
    "enable",
    "disable",
    "maybe_enable_from_env",
    "span",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "StepTimer",
    "CompileWatcher",
    "collect_hbm",
    "peak_flops_per_chip",
    "StallWatchdog",
    "thread_dump",
    # flight recorder + anomaly sentinel
    "FlightRecorder",
    "get_flight_recorder",
    "AnomalySentinel",
    "ENV_ENABLE",
    "ENV_DIR",
    "ENV_STALL_TIMEOUT",
    # device-memory ledger (per-subsystem attribution + OOM forensics)
    "MemoryLedger",
    "get_memory_ledger",
    "tree_device_bytes",
    # goodput accounting + metrics export
    "GoodputLedger",
    "FleetAggregator",
    "MetricsExporter",
    "render_prometheus",
    # trace-driven performance attribution
    "TraceProfileReport",
    "analyze_trace_dir",
    "analyze_trace_file",
    "Timeline",
    "TraceEvent",
    "TraceParseError",
]
