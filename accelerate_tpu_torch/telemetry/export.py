"""Metrics export: a Prometheus text-exposition endpoint + atomic snapshots.

Everything the registry knows — counters, gauges, histograms, the
``goodput.*`` ledger gauges and the serving SLO burn rates — published in
the Prometheus text exposition format (version 0.0.4), two ways:

- **scrape endpoint** — a stdlib ``http.server`` on a background daemon
  thread serving ``GET /metrics`` (``ACCELERATE_TPU_METRICS_PORT=<port>``;
  ``0`` binds an ephemeral port, useful for tests).  Binds 127.0.0.1 only —
  exposing a trainer's metrics beyond the host is a proxy's job, not ours.
- **atomic file snapshot** — for scrape-less environments (batch jobs,
  airgapped pods with a sidecar that ships files):
  ``ACCELERATE_TPU_METRICS_SNAPSHOT=<path>`` rewrites the exposition text
  every ``ACCELERATE_TPU_METRICS_SNAPSHOT_EVERY_S`` seconds (default 15)
  via the flight recorder's write-temp + ``os.replace`` pattern, so a
  SIGTERM mid-write can never leave a torn file — the last complete
  snapshot survives.

Default-off: with neither env var set, ``maybe_start_from_env`` does
nothing.  The exporter starts when telemetry enables and stops (with one
final snapshot) when it disables.

Besides ``/metrics`` the endpoint serves:

- ``GET /healthz`` — liveness probe (``200 ok``), so an orchestrator can
  distinguish "exporter up" from "exporter gone" without paying for a full
  registry render;
- ``GET /debug/requests`` / ``GET /debug/blocks`` — live serving-engine
  introspection (JSON): in-flight request states with phase-so-far trace
  decomposition, and block-pool occupancy / refcounts / prefix-cache
  chains.  Engines self-register via :func:`register_debug_source`
  (weakly — a collected engine drops off the page); with no live engine
  the endpoints return an empty payload, not an error.
- ``GET /debug/memory`` — the process-wide device-memory ledger
  (``telemetry/memledger.py``): ranked owner reservations and per-device
  conservation records (attributed + program + unattributed ==
  bytes_in_use), reconciled at request time.

Everything else still 404s.

Naming: registry names are dotted (``serving.ttft_ms``); Prometheus names
are ``accelerate_tpu_`` + the dotted name with ``.`` → ``_``
(``accelerate_tpu_serving_ttft_ms``).  Counters get the ``_total`` suffix;
histograms render exact ``_bucket``/``_sum``/``_count`` triplets from
:class:`~accelerate_tpu_torch.telemetry.metrics.Histogram`'s native bucket counts.

Serving SLO burn rate: the fraction of the TTFT / inter-token error budget
currently being consumed, computed from the existing serving histograms'
recent window — ``burn = violation_rate / (1 - availability)``.  Burn 1.0
means latencies violate the target at exactly the budgeted rate; >1 burns
budget faster than the SLO allows.  Targets via ``ACCELERATE_TPU_SLO_TTFT_MS``
(default 500), ``ACCELERATE_TPU_SLO_INTER_TOKEN_MS`` (50), and
``ACCELERATE_TPU_SLO_AVAILABILITY`` (0.99).  Published as
``serving.slo.ttft_burn_rate`` / ``serving.slo.inter_token_burn_rate``
gauges, so the report and the snapshot carry them too.
"""

from __future__ import annotations

import json
import math
import os
import threading
import weakref
from typing import List, Optional

from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = [
    "MetricsExporter",
    "render_prometheus",
    "sanitize_metric_name",
    "escape_label_value",
    "publish_slo_burn_rates",
    "get_exporter",
    "maybe_start_from_env",
    "stop_if_running",
    "register_debug_source",
    "debug_payload",
    "ENV_PORT",
    "ENV_SNAPSHOT",
    "ENV_SNAPSHOT_EVERY",
    "ENV_SLO_TTFT_MS",
    "ENV_SLO_INTER_TOKEN_MS",
    "ENV_SLO_AVAILABILITY",
]

ENV_PORT = "ACCELERATE_TPU_METRICS_PORT"
ENV_SNAPSHOT = "ACCELERATE_TPU_METRICS_SNAPSHOT"
ENV_SNAPSHOT_EVERY = "ACCELERATE_TPU_METRICS_SNAPSHOT_EVERY_S"
ENV_SLO_TTFT_MS = "ACCELERATE_TPU_SLO_TTFT_MS"
ENV_SLO_INTER_TOKEN_MS = "ACCELERATE_TPU_SLO_INTER_TOKEN_MS"
ENV_SLO_AVAILABILITY = "ACCELERATE_TPU_SLO_AVAILABILITY"

PREFIX = "accelerate_tpu_"

_OFF = {"0", "false", "no", "off"}


def _fsync_enabled() -> bool:
    return os.environ.get("ACCELERATE_TPU_CHECKPOINT_FSYNC", "1").strip().lower() not in _OFF


def _env_float(key: str, default: float) -> float:
    try:
        return float(os.environ.get(key, "") or default)
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# Live /debug sources (serving engines self-register, weakly)
# ---------------------------------------------------------------------------

_DEBUG_SOURCES: List["weakref.ref"] = []


def register_debug_source(engine) -> None:
    """Register an object exposing ``debug_requests()`` / ``debug_blocks()``
    for the ``/debug/*`` endpoints.  Held weakly: a garbage-collected engine
    silently drops out, so registration never extends an engine's life."""
    _DEBUG_SOURCES.append(weakref.ref(engine))


def _live_debug_sources() -> list:
    alive = []
    for ref in list(_DEBUG_SOURCES):
        obj = ref()
        if obj is None:
            _DEBUG_SOURCES.remove(ref)
        else:
            alive.append(obj)
    return alive


def debug_payload(kind: str) -> dict:
    """The JSON body for ``/debug/requests``, ``/debug/blocks`` or
    ``/debug/memory``.  The first two return one entry per live registered
    engine (keyed by position — multiple engines in one process are rare but
    legal); ``memory`` returns the process-wide :mod:`memledger` snapshot —
    ranked owners plus per-device conservation records — refreshed at
    request time so the residual is current, not last-step stale."""
    if kind == "memory":
        from .memledger import get_memory_ledger

        ledger = get_memory_ledger()
        try:
            ledger.reconcile()
        except Exception:
            pass
        return ledger.snapshot()
    method = {"requests": "debug_requests", "blocks": "debug_blocks"}[kind]
    engines = []
    for obj in _live_debug_sources():
        try:
            engines.append(getattr(obj, method)())
        except Exception as e:  # a torn snapshot must not kill the scrape
            engines.append({"error": str(e)[:200]})
    return {"engines": engines}


# ---------------------------------------------------------------------------
# Text exposition rendering
# ---------------------------------------------------------------------------


def sanitize_metric_name(name: str) -> str:
    """Dotted registry name → valid Prometheus metric name (prefixed)."""
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    sanitized = "".join(out)
    if sanitized and sanitized[0].isdigit():
        sanitized = "_" + sanitized
    return PREFIX + sanitized


def escape_label_value(value) -> str:
    """Escape a label value per the exposition spec: backslash, double
    quote, and newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(value: float) -> str:
    value = float(value)
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if math.isnan(value):
        return "NaN"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


def render_prometheus(registry: MetricsRegistry) -> str:
    """The whole registry as exposition text (ends with a newline)."""
    with registry._lock:
        metrics = sorted(registry._metrics.values(), key=lambda m: m.name)
    lines = []
    for metric in metrics:
        pname = sanitize_metric_name(metric.name)
        if isinstance(metric, Counter):
            lines.append(f"# HELP {pname}_total registry counter {metric.name}")
            lines.append(f"# TYPE {pname}_total counter")
            lines.append(f"{pname}_total {_fmt(metric.value)}")
        elif isinstance(metric, Gauge):
            if metric.value is None:
                continue
            lines.append(f"# HELP {pname} registry gauge {metric.name}")
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(metric.value)}")
        elif isinstance(metric, Histogram):
            lines.append(f"# HELP {pname} registry histogram {metric.name}")
            lines.append(f"# TYPE {pname} histogram")
            # One consistent snapshot per histogram: a concurrent observe()
            # between two reads would otherwise emit +Inf != _count, breaking
            # the exposition invariant downstream quantile math relies on.
            buckets = list(metric.bucket_counts)
            count = metric.count
            total = metric.total
            cumulative = 0
            for bound, n in zip(metric.BOUNDS, buckets):
                cumulative += n
                le = escape_label_value(_fmt(bound))
                lines.append(f'{pname}_bucket{{le="{le}"}} {min(cumulative, count)}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {count}')
            lines.append(f"{pname}_sum {_fmt(total)}")
            lines.append(f"{pname}_count {count}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Serving SLO burn rate
# ---------------------------------------------------------------------------


def publish_slo_burn_rates(registry: MetricsRegistry) -> dict:
    """Compute the serving SLO burn rates from the existing latency
    histograms and land them as gauges.  No serving traffic → no gauges
    (the registry stays clean for pure-training runs)."""
    availability = min(max(_env_float(ENV_SLO_AVAILABILITY, 0.99), 0.0), 1.0 - 1e-9)
    budget = 1.0 - availability
    out = {}
    for stem, env_key, default_target in (
        ("serving.ttft_ms", ENV_SLO_TTFT_MS, 500.0),
        ("serving.inter_token_ms", ENV_SLO_INTER_TOKEN_MS, 50.0),
    ):
        hist = registry.peek(stem)
        if not isinstance(hist, Histogram):
            continue
        target = _env_float(env_key, default_target)
        violation = hist.over_threshold_fraction(target)
        if violation is None:
            continue
        burn = violation / budget
        short = stem.split(".", 1)[1].replace("_ms", "")
        registry.gauge(f"serving.slo.{short}_target_ms").set(target)
        registry.gauge(f"serving.slo.{short}_burn_rate").set(burn)
        out[f"serving.slo.{short}_burn_rate"] = burn
    return out


# ---------------------------------------------------------------------------
# The exporter: endpoint + snapshot writer
# ---------------------------------------------------------------------------


class MetricsExporter:
    """Background scrape endpoint and/or periodic atomic file snapshot over
    the live telemetry registry."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = registry
        self._server = None
        self._server_thread = None
        self._snapshot_path: Optional[str] = None
        self._snapshot_thread = None
        self._stop_event = threading.Event()
        self.port: Optional[int] = None
        self.running = False

    def registry(self) -> MetricsRegistry:
        if self._registry is not None:
            return self._registry
        from . import core

        return core.get_telemetry().registry

    def render(self) -> str:
        """One scrape: refresh the derived gauges (goodput ledger, SLO burn
        rates), then render the registry."""
        from . import core

        registry = self.registry()
        ledger = core.get_telemetry().goodput
        if ledger is not None:
            try:
                ledger.publish(registry)
            except Exception:
                pass
        try:
            publish_slo_burn_rates(registry)
        except Exception:
            pass
        from .memledger import get_memory_ledger

        ledger = get_memory_ledger()
        if ledger.has_owners():
            # Scrape-fresh memory.* family: the conservation residual and
            # per-owner gauges update here (like the goodput ledger), not
            # only on record_step — serving-only processes never step.
            try:
                ledger.reconcile_and_publish(registry)
            except Exception:
                pass
        return render_prometheus(registry)

    # -- endpoint ------------------------------------------------------------

    def _start_server(self, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, body: bytes, content_type: str):
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    # Liveness, not readiness: answering at all is the signal,
                    # so no registry render on the probe path.
                    self._reply(b"ok\n", "text/plain; charset=utf-8")
                    return
                if path in ("/debug/requests", "/debug/blocks", "/debug/memory"):
                    try:
                        body = json.dumps(
                            debug_payload(path.rsplit("/", 1)[1])
                        ).encode()
                    except Exception as e:
                        self.send_error(500, str(e)[:100])
                        return
                    self._reply(body, "application/json; charset=utf-8")
                    return
                if path != "/metrics":
                    self.send_error(404)
                    return
                try:
                    body = exporter.render().encode()
                except Exception as e:  # a scrape must never crash the server
                    self.send_error(500, str(e)[:100])
                    return
                self._reply(
                    body, "text/plain; version=0.0.4; charset=utf-8"
                )

            def log_message(self, *args):  # silence per-scrape stderr spam
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._server_thread = threading.Thread(
            target=self._server.serve_forever,
            name="atpu-metrics-endpoint",
            daemon=True,
        )
        self._server_thread.start()

    # -- snapshot ------------------------------------------------------------

    def write_snapshot(self) -> Optional[str]:
        """Write the exposition text atomically (temp + ``os.replace``, the
        flight-recorder pattern): a kill mid-write leaves the previous
        complete snapshot, never a torn one."""
        path = self._snapshot_path
        if not path:
            return None
        tmp = f"{path}.tmp"
        try:
            body = self.render()
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(tmp, "w") as f:
                f.write(body)
                f.flush()
                if _fsync_enabled():
                    try:
                        os.fsync(f.fileno())
                    except OSError:
                        pass
            os.replace(tmp, path)
            return path
        except OSError:
            return None

    def _snapshot_loop(self, every_s: float):
        while not self._stop_event.wait(every_s):
            self.write_snapshot()

    # -- lifecycle -----------------------------------------------------------

    def start(
        self,
        port: Optional[int] = None,
        snapshot_path: Optional[str] = None,
        snapshot_every_s: float = 15.0,
    ) -> "MetricsExporter":
        """Start whichever halves were configured (idempotent)."""
        if self.running:
            return self
        self._stop_event.clear()
        if port is not None:
            self._start_server(int(port))
        if snapshot_path:
            self._snapshot_path = snapshot_path
            self.write_snapshot()
            self._snapshot_thread = threading.Thread(
                target=self._snapshot_loop,
                args=(max(0.1, float(snapshot_every_s)),),
                name="atpu-metrics-snapshot",
                daemon=True,
            )
            self._snapshot_thread.start()
        self.running = True
        return self

    def stop(self, final_snapshot: bool = True):
        """Shut both halves down; by default writes one last snapshot so the
        file on disk reflects the final registry state."""
        if not self.running:
            return
        self.running = False
        self._stop_event.set()
        if self._server is not None:
            try:
                self._server.shutdown()
                self._server.server_close()
            except Exception:
                pass
            self._server = None
            self._server_thread = None
        if self._snapshot_thread is not None:
            self._snapshot_thread.join(timeout=5.0)
            self._snapshot_thread = None
        if final_snapshot:
            self.write_snapshot()


_EXPORTER: Optional[MetricsExporter] = None


def get_exporter() -> Optional[MetricsExporter]:
    return _EXPORTER


def maybe_start_from_env() -> Optional[MetricsExporter]:
    """Start the exporter iff the env asks for it (called from
    ``Telemetry.enable``).  Disabled by default: no port, no snapshot path →
    nothing starts, nothing listens."""
    global _EXPORTER
    if _EXPORTER is not None and _EXPORTER.running:
        return _EXPORTER
    port_raw = os.environ.get(ENV_PORT, "").strip()
    snapshot = os.environ.get(ENV_SNAPSHOT, "").strip() or None
    port: Optional[int] = None
    if port_raw:
        try:
            port = int(port_raw)
        except ValueError:
            port = None
        if port is not None and port < 0:
            port = None
    if port is None and not snapshot:
        return None
    exporter = _EXPORTER or MetricsExporter()
    _EXPORTER = exporter
    exporter.start(
        port=port,
        snapshot_path=snapshot,
        snapshot_every_s=_env_float(ENV_SNAPSHOT_EVERY, 15.0),
    )
    return exporter


def stop_if_running():
    """Stop the env-started exporter (called from ``Telemetry.disable``);
    writes the final snapshot while the registry still holds the run."""
    if _EXPORTER is not None:
        _EXPORTER.stop(final_snapshot=True)
