"""Trace-driven performance attribution: the profile scanner.

Where does a step's device time go, and did its collectives hide behind
compute or did the step pay for them?  This module consumes a profiler
trace directory — a ``torch.profiler`` Chrome trace (the sentinel's anomaly
capture, ``Accelerator.profile``, ``tensorboard_trace_handler``) or a
``jax.profiler`` dump — and computes, by interval arithmetic over the
reconstructed device timeline (``timeline.py``):

- **device-busy ms** — union of device-op time per device scope;
- **exposed-collective ms** — collective time NOT covered by concurrent
  compute (``collective-union − compute-union`` per scope): the part of the
  comms bill the step actually paid;
- **realized overlap fraction** — ``1 − exposed/collective``;
- **top-k ops by self time** and a per-step waterfall
  (compute / hidden comms / exposed comms / infeed / idle).

Entry points: :func:`analyze_trace_dir` (offline or post-capture),
:func:`publish` (metrics registry + telemetry JSONL), :func:`digest` (the
compact dict the flight recorder attaches to anomaly postmortems), and
``python -m accelerate_tpu_torch.telemetry.profile_scan <dir>`` for the CLI.
``telemetry.report --profile <dir>`` renders the same report.

Stdlib only on the analysis path: the parser that audits a live capture
also runs on a committed fixture with no devices at all.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import asdict, dataclass, field
from typing import Optional

from .timeline import (
    COLLECTIVE,
    COMPUTE,
    INFEED,
    Timeline,
    TraceParseError,
    build_timeline,
    classify_op,
    clip_intervals,
    find_trace_files,
    intervals_total,
    load_trace_events,
    merge_intervals,
    subtract_intervals,
)

__all__ = [
    "ProfileReport",
    "analyze_trace_dir",
    "analyze_trace_file",
    "analyze_events",
    "report_from_dict",
    "publish",
    "digest",
    "format_profile_report",
    "main",
]

TOP_K_OPS = 5

# Default step markers: the telemetry spans that bound an optimizer step,
# recorded as host-side ``user_annotation`` ranges (their device-side
# ``gpu_user_annotation`` projections are not markers), and the JAX
# package's ``PjitFunction(...)`` dispatches.
STEP_SPANS = ("pipeline.train_step", "optimizer.step")


@dataclass
class ProfileReport:
    """Headline attribution metrics for one captured trace window."""

    source: Optional[str] = None
    n_raw_events: int = 0
    n_device_events: int = 0
    n_device_lanes: int = 0
    n_scopes: int = 0
    window_ms: float = 0.0
    device_busy_ms: float = 0.0
    compute_ms: float = 0.0
    collective_ms: float = 0.0
    infeed_ms: float = 0.0
    exposed_collective_ms: float = 0.0
    # None when the window holds no collectives (single-device program).
    overlap_fraction: Optional[float] = None
    idle_ms: float = 0.0
    # Idle-gap share of the whole capture window across device scopes
    # (idle_ms / (window_ms x n_scopes)) — the realized pipeline-bubble
    # measurement the pp probes compare against the analytic
    # (S-1)/(v·M+S-1).  None until device events exist.
    bubble_fraction: Optional[float] = None
    step_marker: Optional[str] = None
    steps: list = field(default_factory=list)
    top_ops: list = field(default_factory=list)

    def to_dict(self) -> dict:
        return asdict(self)

    def step_bubble_fraction(self, skip_first: bool = True) -> Optional[float]:
        """Mean idle-gap share of the per-step windows (the realized bubble of
        the steady-state step).  ``skip_first`` drops step 0 when more than
        one step exists — its window absorbs warmup/compile idle that is not
        schedule bubble.  Each step row carries the scope count of the host
        it was built from (``n_scopes`` in the row) — on a merged multi-host
        report the report-level ``n_scopes`` sums ALL hosts while the step
        rows cover one, so the row value is the correct denominator."""
        steps = self.steps
        if skip_first and len(steps) > 1:
            steps = steps[1:]
        fracs = [
            s["idle_ms"] / (s["dur_ms"] * max(s.get("n_scopes") or self.n_scopes, 1))
            for s in steps
            if s.get("dur_ms")
        ]
        if not fracs:
            return None
        return round(sum(fracs) / len(fracs), 4)


# ---------------------------------------------------------------------------
# Self time
# ---------------------------------------------------------------------------


def _self_times(lane_events: list) -> list:
    """Per-event self time (dur minus direct children) for one (pid, tid)
    lane.  Trace events on a lane nest but never partially overlap, so a
    stack sweep in ts order reconstructs the tree."""
    order = sorted(lane_events, key=lambda e: (e.ts, -e.dur))
    stack: list = []  # [event, child_dur_accum]
    out = []

    def _finalize(entry):
        ev, child_dur = entry
        out.append((ev, max(0.0, ev.dur - child_dur)))

    for ev in order:
        while stack and stack[-1][0].end <= ev.ts + 1e-9:
            _finalize(stack.pop())
        if stack:
            stack[-1][1] += ev.dur
        stack.append([ev, 0.0])
    while stack:
        _finalize(stack.pop())
    return out


# ---------------------------------------------------------------------------
# Step segmentation
# ---------------------------------------------------------------------------


def _step_windows(tl: Timeline, step_marker_re: Optional[str] = None):
    """Per-step windows from host-side step markers.

    Each optimizer step runs one ``pipeline.train_step`` span (the fused
    step) or one ``optimizer.step`` span (the eager loop), and telemetry
    mirrors spans into the trace as ``record_function`` ranges, so those
    host events are natural step boundaries (in a JAX trace, the fused
    step's ``PjitFunction(<name>)`` dispatch).
    Among candidate marker names, the one whose windows cover the most wall
    time wins — a run's hot loop dominates its trace, while tiny helper
    dispatches (``device_put`` conversions and the like) may outnumber it but
    never outlast it.  Nested duplicates of the same marker (the profiler
    emits one per wrapper layer) collapse to the outermost.  Returns
    ``(marker_name, [(start, end), ...])`` — empty when no markers exist
    (the caller falls back to one whole-window step)."""
    import re as _re

    candidates: dict = {}
    match = _re.compile(step_marker_re) if step_marker_re else None
    for ev in tl.host_events:
        if match is not None:
            if not match.search(ev.name):
                continue
        elif not (ev.name.startswith("PjitFunction(")
                  or (ev.name in STEP_SPANS and ev.cat != "gpu_user_annotation")):
            continue
        candidates.setdefault(ev.name, []).append(ev)
    if not candidates:
        return None, []

    def _dedup(events: list) -> list:
        windows = []
        for ev in sorted(events, key=lambda e: (e.ts, -e.dur)):
            # Outermost wins: drop a marker fully inside the previous window.
            if windows and ev.ts >= windows[-1][0] and ev.end <= windows[-1][1] + 1e-9:
                continue
            windows.append((ev.ts, ev.end))
        return windows

    deduped = {name: _dedup(events) for name, events in candidates.items()}
    name = max(deduped, key=lambda n: sum(e - s for s, e in deduped[n]))
    return name, deduped[name]


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------


def analyze_events(
    raw_events: list,
    source: Optional[str] = None,
    top_k: int = TOP_K_OPS,
    step_marker_re: Optional[str] = None,
    assume_no_overlap: bool = False,
) -> ProfileReport:
    """Classify + bucket one trace's events into a :class:`ProfileReport`.

    ``assume_no_overlap=True`` disables the concurrent-compute credit (every
    collective µs counts as exposed) — the perf gate's ``no-overlap`` degrade
    knob uses it to prove the overlap row actually judges the number."""
    tl = build_timeline(raw_events, source=source)
    report = ProfileReport(
        source=source,
        n_raw_events=tl.n_raw_events,
        n_device_events=len(tl.events),
        n_device_lanes=len(tl.lanes()),
    )
    if not tl.events:
        return report

    # Per-scope interval unions (scope = device pid on TPU, the whole
    # process on CPU — see Timeline.device_scopes).
    scopes = tl.device_scopes()
    report.n_scopes = len(scopes)
    t0 = min(ev.ts for ev in tl.events)
    t1 = max(ev.end for ev in tl.events)
    report.window_ms = round((t1 - t0) / 1e3, 3)
    per_scope = {}
    for pid, events in scopes.items():
        buckets: dict = {COMPUTE: [], COLLECTIVE: [], INFEED: []}
        for ev in events:
            buckets[classify_op(ev.hlo_op or ev.name)].append((ev.ts, ev.end))
        comp = merge_intervals(buckets[COMPUTE])
        coll = merge_intervals(buckets[COLLECTIVE])
        infeed = merge_intervals(buckets[INFEED])
        busy = merge_intervals(buckets[COMPUTE] + buckets[COLLECTIVE] + buckets[INFEED])
        exposed = coll if assume_no_overlap else subtract_intervals(coll, comp)
        per_scope[pid] = (comp, coll, infeed, busy, exposed)
        report.compute_ms += intervals_total(comp)
        report.collective_ms += intervals_total(coll)
        report.infeed_ms += intervals_total(infeed)
        report.device_busy_ms += intervals_total(busy)
        report.exposed_collective_ms += intervals_total(exposed)
        report.idle_ms += max(0.0, (t1 - t0) - intervals_total(busy))
    for key in (
        "compute_ms",
        "collective_ms",
        "infeed_ms",
        "device_busy_ms",
        "exposed_collective_ms",
        "idle_ms",
    ):
        setattr(report, key, round(getattr(report, key) / 1e3, 3))
    if report.collective_ms > 0:
        report.overlap_fraction = round(
            1.0 - report.exposed_collective_ms / report.collective_ms, 4
        )
    if report.window_ms > 0 and report.n_scopes:
        report.bubble_fraction = round(
            report.idle_ms / (report.window_ms * report.n_scopes), 4
        )

    # Top-k ops by self time (summed across lanes; uniquifier suffixes like
    # ``.3`` are kept — distinct HLO instructions are distinct rows).
    agg: dict = {}
    for lane_events in tl.lanes().values():
        for ev, self_us in _self_times(lane_events):
            name = ev.hlo_op or ev.name
            row = agg.setdefault(name, {"name": name, "bucket": classify_op(name), "count": 0, "self_ms": 0.0})
            row["count"] += 1
            row["self_ms"] += self_us
    top = sorted(agg.values(), key=lambda r: -r["self_ms"])[: max(0, top_k)]
    for row in top:
        row["self_ms"] = round(row["self_ms"] / 1e3, 3)
    report.top_ops = top

    # Per-step attribution from host dispatch markers (whole window as one
    # synthetic step when none exist — e.g. a trace of eager dispatches).
    marker, windows = _step_windows(tl, step_marker_re)
    report.step_marker = marker
    if not windows:
        windows = [(t0, t1)]
    else:
        # Device execution is async: the host dispatch returns long before
        # the device drains the step's ops.  Everything between one dispatch
        # and the next belongs to the earlier step, so each window extends to
        # the next marker's start (the last one to the end of device work).
        extended = []
        for i, (ws, we) in enumerate(windows):
            next_start = windows[i + 1][0] if i + 1 < len(windows) else max(t1, we)
            extended.append((ws, max(we, next_start)))
        windows = extended
    for index, (ws, we) in enumerate(windows):
        step = {
            "index": index,
            "n_scopes": report.n_scopes,
            "start_ms": round((ws - t0) / 1e3, 3),
            "dur_ms": round((we - ws) / 1e3, 3),
            "compute_ms": 0.0,
            "collective_ms": 0.0,
            "exposed_collective_ms": 0.0,
            "infeed_ms": 0.0,
            "busy_ms": 0.0,
            "idle_ms": 0.0,
            "overlap_fraction": None,
        }
        for comp, coll, infeed, busy, exposed in per_scope.values():
            step["compute_ms"] += intervals_total(clip_intervals(comp, ws, we))
            step["collective_ms"] += intervals_total(clip_intervals(coll, ws, we))
            step["exposed_collective_ms"] += intervals_total(clip_intervals(exposed, ws, we))
            step["infeed_ms"] += intervals_total(clip_intervals(infeed, ws, we))
            busy_us = intervals_total(clip_intervals(busy, ws, we))
            step["busy_ms"] += busy_us
            step["idle_ms"] += max(0.0, (we - ws) - busy_us)
        for key in (
            "compute_ms",
            "collective_ms",
            "exposed_collective_ms",
            "infeed_ms",
            "busy_ms",
            "idle_ms",
        ):
            step[key] = round(step[key] / 1e3, 3)
        if step["collective_ms"] > 0:
            step["overlap_fraction"] = round(
                1.0 - step["exposed_collective_ms"] / step["collective_ms"], 4
            )
        report.steps.append(step)
    return report


def report_from_dict(data: dict) -> ProfileReport:
    """Rebuild a :class:`ProfileReport` from its ``to_dict`` form (a
    ``profile`` telemetry record); unknown keys are ignored."""
    import dataclasses

    names = {f.name for f in dataclasses.fields(ProfileReport)}
    return ProfileReport(**{k: v for k, v in data.items() if k in names})


def analyze_trace_file(path: str, **kwargs) -> ProfileReport:
    """Analyze one ``*.trace.json[.gz]`` file."""
    return analyze_events(load_trace_events(path), source=path, **kwargs)


def analyze_trace_dir(path: str, **kwargs) -> ProfileReport:
    """Analyze a profiler output directory (or a single trace file).

    Multiple files in one run directory (one per host) are analyzed
    independently and summed — their clocks are per-host, so cross-host
    interval unions would be meaningless.  Raises :class:`TraceParseError`
    when no trace file exists or none parses."""
    files = find_trace_files(path)
    if not files:
        raise TraceParseError(f"no *.trace.json[.gz] under {path}")
    reports = []
    errors = []
    for file in files:
        try:
            reports.append(analyze_trace_file(file, **kwargs))
        except TraceParseError as e:
            errors.append(str(e))
    if not reports:
        raise TraceParseError("; ".join(errors))
    if len(reports) == 1:
        report = reports[0]
        report.source = path
        return report
    merged = ProfileReport(source=path)
    for rep in reports:
        merged.n_raw_events += rep.n_raw_events
        merged.n_device_events += rep.n_device_events
        merged.n_device_lanes += rep.n_device_lanes
        merged.n_scopes += rep.n_scopes
        merged.window_ms += rep.window_ms
        merged.device_busy_ms += rep.device_busy_ms
        merged.compute_ms += rep.compute_ms
        merged.collective_ms += rep.collective_ms
        merged.infeed_ms += rep.infeed_ms
        merged.exposed_collective_ms += rep.exposed_collective_ms
        merged.idle_ms += rep.idle_ms
    for key in (
        "window_ms", "device_busy_ms", "compute_ms", "collective_ms",
        "infeed_ms", "exposed_collective_ms", "idle_ms",
    ):
        setattr(merged, key, round(getattr(merged, key), 3))
    if merged.collective_ms > 0:
        merged.overlap_fraction = round(
            1.0 - merged.exposed_collective_ms / merged.collective_ms, 4
        )
    # Idle share over the summed per-host device capacity (windows are
    # per-host clocks, so capacity is the sum of window x scopes terms).
    capacity = sum(r.window_ms * r.n_scopes for r in reports)
    if capacity > 0:
        merged.bubble_fraction = round(merged.idle_ms / capacity, 4)
    host_with_steps = max(reports, key=lambda r: len(r.steps))
    merged.steps = host_with_steps.steps
    merged.step_marker = host_with_steps.step_marker
    agg: dict = {}
    for rep in reports:
        for row in rep.top_ops:
            cur = agg.setdefault(row["name"], dict(row))
            if cur is not row:
                cur["count"] += row["count"]
                cur["self_ms"] = round(cur["self_ms"] + row["self_ms"], 3)
    merged.top_ops = sorted(agg.values(), key=lambda r: -r["self_ms"])[:TOP_K_OPS]
    return merged


# ---------------------------------------------------------------------------
# Publication
# ---------------------------------------------------------------------------


def publish(report: ProfileReport, telemetry=None) -> None:
    """Publish the headline numbers into the metrics registry and the
    telemetry JSONL (kind ``profile``) so ``telemetry.report`` renders them."""
    if telemetry is None:
        from . import core

        telemetry = core.get_telemetry()
    if not telemetry.enabled:
        return
    reg = telemetry.registry
    reg.gauge("profile.device_busy_ms").set(report.device_busy_ms)
    reg.gauge("profile.collective_ms").set(report.collective_ms)
    reg.gauge("profile.exposed_collective_ms").set(report.exposed_collective_ms)
    if report.overlap_fraction is not None:
        reg.gauge("profile.overlap_fraction").set(report.overlap_fraction)
    telemetry.write({"kind": "profile", **report.to_dict()})


def digest(report: ProfileReport, top_k: int = 3) -> dict:
    """Compact attribution summary (the flight-recorder postmortem payload)."""
    return {
        "window_ms": report.window_ms,
        "device_busy_ms": report.device_busy_ms,
        "compute_ms": report.compute_ms,
        "collective_ms": report.collective_ms,
        "exposed_collective_ms": report.exposed_collective_ms,
        "overlap_fraction": report.overlap_fraction,
        "idle_ms": report.idle_ms,
        "bubble_fraction": report.bubble_fraction,
        "n_steps": len(report.steps),
        "top_ops": [
            {"name": r["name"], "bucket": r["bucket"], "self_ms": r["self_ms"]}
            for r in report.top_ops[:top_k]
        ],
    }


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def format_profile_report(report: ProfileReport, max_steps: int = 8) -> str:
    """Human rendering: headline, waterfall, top ops, per-step table."""
    lines = []
    lines.append(
        f"profile scan — {report.source or '?'}: "
        f"{report.n_device_events} device ops on {report.n_device_lanes} lanes "
        f"({report.n_scopes} device scope{'s' if report.n_scopes != 1 else ''}, "
        f"window {report.window_ms} ms)"
    )
    if not report.n_device_events:
        lines.append("  no device ops in trace (nothing executed during the window)")
        return "\n".join(lines)
    overlap = (
        f"{100.0 * report.overlap_fraction:.1f}%"
        if report.overlap_fraction is not None
        else "n/a (no collectives)"
    )
    lines.append(
        f"  device busy {report.device_busy_ms} ms | compute {report.compute_ms} ms | "
        f"collective {report.collective_ms} ms (exposed {report.exposed_collective_ms} ms) | "
        f"infeed {report.infeed_ms} ms | idle {report.idle_ms} ms"
    )
    lines.append(f"  realized collective overlap: {overlap}")
    waterfall = [
        ("compute", report.compute_ms),
        ("collective (hidden)", round(report.collective_ms - report.exposed_collective_ms, 3)),
        ("collective (exposed)", report.exposed_collective_ms),
        ("infeed", report.infeed_ms),
        ("idle", report.idle_ms),
    ]
    denom = sum(v for _, v in waterfall) or 1.0
    lines.append("  waterfall:")
    for name, value in waterfall:
        bar = "#" * int(round(24.0 * value / denom))
        lines.append(f"    {name:<22} {value:>10.3f} ms {bar}")
    if report.top_ops:
        lines.append("  top ops by self time:")
        for row in report.top_ops:
            lines.append(
                f"    {row['name']:<32} [{row['bucket']:<10}] x{row['count']:<5} "
                f"{row['self_ms']:>10.3f} ms"
            )
    if report.steps:
        shown = report.steps[:max_steps]
        marker = f" (marker {report.step_marker!r})" if report.step_marker else ""
        lines.append(f"  steps: {len(report.steps)}{marker}")
        lines.append(
            f"    {'step':>5} {'dur_ms':>10} {'compute':>10} {'coll':>10} "
            f"{'exposed':>10} {'overlap':>8}"
        )
        for step in shown:
            ov = (
                f"{100.0 * step['overlap_fraction']:.0f}%"
                if step["overlap_fraction"] is not None
                else "-"
            )
            lines.append(
                f"    {step['index']:>5} {step['dur_ms']:>10.3f} {step['compute_ms']:>10.3f} "
                f"{step['collective_ms']:>10.3f} {step['exposed_collective_ms']:>10.3f} {ov:>8}"
            )
        if len(report.steps) > len(shown):
            lines.append(f"    ... {len(report.steps) - len(shown)} more steps")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.telemetry.profile_scan",
        description=(
            "Attribute a profiler trace capture: compute/collective/"
            "infeed buckets, exposed-collective time, realized overlap."
        ),
    )
    parser.add_argument("path", help="profiler output dir or *.trace.json[.gz] file")
    parser.add_argument("--json", action="store_true", help="emit the report as JSON")
    parser.add_argument(
        "--step-marker",
        default=None,
        metavar="REGEX",
        help="host-event regex for step boundaries (default: the step spans)",
    )
    args = parser.parse_args(argv)
    if not os.path.exists(args.path):
        print(f"no such file or directory: {args.path}", file=sys.stderr)
        return 1
    try:
        report = analyze_trace_dir(args.path, step_marker_re=args.step_marker)
    except TraceParseError as e:
        print(f"profile scan failed: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(report.to_dict()))
    else:
        print(format_profile_report(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
