"""Telemetry run summarizer: ``python -m accelerate_tpu_torch.telemetry.report <path>``.

``<path>`` is a telemetry or flight-recorder JSONL file, or a run directory
holding ``telemetry_p*.jsonl`` / ``flightrec_p*.jsonl`` files (one per
process).  Prints a per-span time breakdown, compile statistics, stall
events, the final metrics snapshot, and — when a flight-recorder snapshot is
present — a postmortem block: the last N steps, the anomaly list, the
sentinel's anomaly-capture digest, and the final event before the process
died.

``--profile <dir>`` additionally runs the trace scanner
(``profile_scan.py``) over any profiler trace directory offline and
appends the attribution block.  ``--json`` switches to machine-readable
output (stable ``telemetry``/``postmortem``/``profile`` top-level keys) so
bench/CI consume the same data without screen-scraping; the human renderer
is unchanged.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

__all__ = [
    "load_records",
    "load_flight_records",
    "load_fleet_records",
    "load_serving_trace_records",
    "summarize",
    "summarize_flight",
    "summarize_fleet",
    "format_report",
    "format_flight_report",
    "format_fleet_report",
    "format_memory_block",
    "main",
]


def _parse_jsonl(files: list) -> list[dict]:
    records = []
    for file in files:
        with open(file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    continue
    return records


def load_records(path: str) -> list[dict]:
    """Parse every telemetry record from a JSONL file or a run directory.
    Unparseable lines (a crashed writer's torn tail) are skipped, not fatal.
    Flight-recorder snapshots are deliberately excluded — their step/anomaly
    kinds would double-count compiles/stalls; use :func:`load_flight_records`."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "telemetry_p*.jsonl")))
        if not files:
            files = [
                f
                for f in sorted(glob.glob(os.path.join(path, "*.jsonl")))
                if not os.path.basename(f).startswith("flightrec_")
            ]
    else:
        files = [path]
    return _parse_jsonl(files)


def load_flight_records(path: str) -> list[dict]:
    """Parse flight-recorder snapshots: ``flightrec_p*.jsonl`` under a run
    directory, or the given file directly."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "flightrec_p*.jsonl")))
    else:
        files = [path]
    return _parse_jsonl(files)


def load_fleet_records(path: str) -> dict:
    """Every rank's telemetry AND flight-recorder stream under a run
    directory, keyed by process index: ``{proc: [records]}`` with each record
    tagged ``source`` (``telemetry``/``flightrec``).  The raw material for the
    fleet postmortem view (:func:`summarize_fleet`)."""
    import re

    by_proc: dict = {}
    if not os.path.isdir(path):
        return by_proc
    for prefix, source in (("telemetry_p", "telemetry"), ("flightrec_p", "flightrec")):
        for file in sorted(glob.glob(os.path.join(path, f"{prefix}*.jsonl"))):
            match = re.search(r"_p(\d+)\.jsonl$", os.path.basename(file))
            name_proc = int(match.group(1)) if match else 0
            for rec in _parse_jsonl([file]):
                rec = dict(rec)
                rec["source"] = source
                proc = rec.get("proc")
                proc = name_proc if not isinstance(proc, int) else proc
                rec["proc"] = proc
                by_proc.setdefault(proc, []).append(rec)
    for records in by_proc.values():
        records.sort(key=lambda r: (r.get("t") or 0, r.get("seq") or 0))
    return by_proc


def _describe_record(rec: dict) -> str:
    kind = rec.get("kind")
    if kind == "step":
        return f"step {rec.get('step')} ({rec.get('dur_ms')}ms)"
    if kind == "event":
        skip = ("kind", "t", "proc", "seq", "name", "source")
        fields = ", ".join(f"{k}={rec[k]!r}" for k in rec if k not in skip)
        return f"event {rec.get('name')}" + (f" ({fields})" if fields else "")
    if kind == "span":
        return f"span {rec.get('name')} ({rec.get('dur_ms')}ms)"
    return _event_str(rec)


def summarize_fleet(by_proc: dict, timeline_n: int = 40) -> dict:
    """Merge every rank's streams into one rank-tagged postmortem: per-rank
    last-sign-of-life, the rank that went silent FIRST (the usual suspect for
    a dead/wedged member — everyone else's streams end later, wedged in the
    collective the dead rank abandoned), and a merged tail timeline placing
    the dead rank's final events adjacent to the survivors' last barrier."""
    ranks: dict = {}
    merged: list = []
    for proc in sorted(by_proc):
        records = by_proc[proc]
        if not records:
            continue
        last = records[-1]
        steps = [r for r in records if r.get("kind") == "step"]
        ranks[str(proc)] = {
            "n_records": len(records),
            "last_t": last.get("t"),
            "last_event": _describe_record(last),
            "last_step": steps[-1].get("step") if steps else None,
            "crashes": sum(1 for r in records if r.get("kind") == "crash"),
            "signals": sum(1 for r in records if r.get("kind") == "signal"),
        }
        merged.extend(records)
    merged.sort(key=lambda r: (r.get("t") or 0, r.get("seq") or 0))
    end_t = merged[-1].get("t") if merged else None
    first_silent = None
    if len(ranks) >= 2:
        first_silent = min(
            ranks, key=lambda p: (ranks[p]["last_t"] is None, ranks[p]["last_t"] or 0)
        )
    timeline = [
        {
            "t": r.get("t"),
            "behind_s": (
                round(end_t - r["t"], 3)
                if end_t is not None and isinstance(r.get("t"), (int, float))
                else None
            ),
            "proc": r.get("proc"),
            "source": r.get("source"),
            "desc": _describe_record(r),
        }
        for r in merged[-timeline_n:]
    ]
    return {
        "n_ranks": len(ranks),
        "n_records": len(merged),
        "ranks": ranks,
        "first_silent_rank": int(first_silent) if first_silent is not None else None,
        "timeline": timeline,
    }


def format_fleet_report(fsummary: dict, last_n: int = 20) -> str:
    """Render the rank-tagged fleet postmortem block."""
    lines = []
    lines.append(
        f"fleet postmortem — {fsummary['n_ranks']} ranks, "
        f"{fsummary['n_records']} records"
    )
    ranks = fsummary["ranks"]
    if ranks:
        end_t = max(
            (r["last_t"] for r in ranks.values() if r["last_t"] is not None),
            default=None,
        )
        lines.append("")
        lines.append(
            f"  {'rank':>5} {'records':>8} {'last step':>10} {'behind_s':>9}  last sign of life"
        )
        for proc in sorted(ranks, key=int):
            info = ranks[proc]
            behind = (
                f"{end_t - info['last_t']:9.3f}"
                if end_t is not None and info["last_t"] is not None
                else "        -"
            )
            lines.append(
                f"  {proc:>5} {info['n_records']:>8} "
                f"{info['last_step'] if info['last_step'] is not None else '-':>10} "
                f"{behind}  {info['last_event']}"
            )
    if fsummary.get("first_silent_rank") is not None:
        lines.append("")
        lines.append(
            f"first silent: rank {fsummary['first_silent_rank']} "
            "(earliest last record — likely the dead/wedged member)"
        )
    timeline = fsummary["timeline"][-last_n:]
    if timeline:
        lines.append("")
        lines.append(f"merged timeline (last {len(timeline)}):")
        for entry in timeline:
            behind = (
                f"-{entry['behind_s']:.3f}s" if entry["behind_s"] is not None else "?"
            )
            lines.append(
                f"  {behind:>10} p{entry['proc']} [{entry['source']}] {entry['desc']}"
            )
    return "\n".join(lines)


def load_serving_trace_records(path: str) -> list[dict]:
    """Per-request serving trace records (``serving_trace_*.jsonl``) under a
    run directory, or one such file directly.  The loader lives in
    ``serving/tracing.py`` (stdlib-only code, but inside the serving
    package); an unimportable serving package degrades to "no traces"
    rather than killing the rest of the report."""
    if not os.path.isdir(path) and not os.path.basename(path).startswith(
        "serving_trace_"
    ):
        return []
    try:
        from ..serving.tracing import load_serving_traces
    except Exception:
        return []
    return load_serving_traces(path)


def summarize(records: list[dict]) -> dict:
    """Aggregate records into the report's sections."""
    spans: dict = {}
    toplevel_ms = 0.0
    compiles = 0
    compile_ms = 0.0
    stalls = []
    snapshot = None
    introspect = {}
    profiles: dict = {}
    stragglers: dict = {}
    for rec in records:
        kind = rec.get("kind")
        if kind == "event" and rec.get("name") == "sentinel.straggler":
            # Latest verdict per host wins: the fleet aggregator emits an
            # explicit cleared=True event when a previously-named host
            # recovers, so stale verdicts genuinely age out of the report.
            stragglers[rec.get("host")] = rec
        if kind == "span":
            name = rec.get("name", "?")
            agg = spans.setdefault(
                name, {"count": 0, "total_ms": 0.0, "max_ms": 0.0, "depth": rec.get("depth", 0)}
            )
            dur = float(rec.get("dur_ms", 0.0))
            agg["count"] += 1
            agg["total_ms"] += dur
            agg["max_ms"] = max(agg["max_ms"], dur)
            agg["depth"] = min(agg["depth"], rec.get("depth", 0))
            if rec.get("depth", 0) == 0:
                toplevel_ms += dur
        elif kind == "compile":
            compiles += 1
            compile_ms += float(rec.get("dur_ms", 0.0))
        elif kind == "stall":
            stalls.append(
                {"elapsed_s": rec.get("elapsed_s"), "deadline_s": rec.get("deadline_s")}
            )
        elif kind == "metrics":
            snapshot = rec.get("snapshot")  # last one wins (written on disable)
        elif kind == "introspect":
            # Latest capture per program name wins (a recompile re-captures).
            introspect[rec.get("name", "?")] = rec
        elif kind == "profile":
            # Latest scan per trace source wins (a re-armed capture re-scans).
            profiles[rec.get("source") or "?"] = rec
    from .goodput import summary_from_records

    return {
        "spans": spans,
        "toplevel_ms": toplevel_ms,
        "compiles": compiles,
        "compile_ms": compile_ms,
        "stalls": stalls,
        "snapshot": snapshot,
        "introspect": introspect,
        "profiles": profiles,
        # Wall-clock attribution ledger, recomputed offline from the same
        # record stream (so a crashed run that never published its goodput
        # gauges still gets a ledger in the postmortem).
        "goodput": summary_from_records(records),
        "stragglers": [stragglers[h] for h in sorted(stragglers, key=lambda x: (x is None, x))],
        "n_records": len(records),
    }


def summarize_flight(records: list[dict]) -> dict:
    """Aggregate flight-recorder events into the postmortem's sections."""
    steps = []
    anomalies = []
    signals = []
    crashes = []
    compiles = 0
    events = 0
    profile_captures = []
    profile_digests = []
    oom_postmortems = []
    for rec in records:
        kind = rec.get("kind")
        if kind == "step":
            steps.append(rec)
        elif kind == "anomaly":
            anomalies.append(rec)
        elif kind == "signal":
            signals.append(rec)
        elif kind == "crash":
            crashes.append(rec)
        elif kind == "compile":
            compiles += 1
        elif kind == "event":
            events += 1
            name = rec.get("name")
            if name == "sentinel.profile_captured":
                profile_captures.append(rec)
            elif name in ("sentinel.profile_digest", "sentinel.profile_analysis_failed"):
                profile_digests.append(rec)
            elif name == "memory.oom_postmortem":
                oom_postmortems.append(rec)
    final = max(records, key=lambda r: (r.get("t") or 0, r.get("seq") or 0)) if records else None
    return {
        "n_events": len(records),
        "steps": steps,
        "anomalies": anomalies,
        "signals": signals,
        "crashes": crashes,
        "compiles": compiles,
        "events": events,
        "profile_captures": profile_captures,
        "profile_digests": profile_digests,
        # Ranked-ledger snapshots from RESOURCE_EXHAUSTED sites (the HBM
        # ledger's memory.oom_postmortem events) — a stable machine key for
        # --json consumers, rendered as the memory block below.
        "oom_postmortems": oom_postmortems,
        "final_event": final,
    }


def _event_str(rec: dict) -> str:
    skip = ("kind", "t", "proc", "seq")
    fields = ", ".join(f"{k}={rec[k]!r}" for k in rec if k not in skip)
    return f"{rec.get('kind')}" + (f" ({fields})" if fields else "")


def format_flight_report(fsummary: dict, last_n: int = 10) -> str:
    """Render the flight-recorder postmortem block."""
    lines = []
    lines.append(
        f"flight recorder — {fsummary['n_events']} events in snapshot "
        f"({len(fsummary['steps'])} steps, {fsummary['compiles']} compiles, "
        f"{fsummary['events']} markers)"
    )
    steps = fsummary["steps"][-last_n:]
    if steps:
        lines.append("")
        lines.append(f"last {len(steps)} steps:")
        lines.append(f"  {'step':>8} {'dur_ms':>10} {'dispatches':>11} {'host_blk_ms':>12}")
        for s in steps:

            def cell(value):
                return "-" if value is None else value

            lines.append(
                f"  {cell(s.get('step')):>8} "
                f"{cell(s.get('dur_ms')):>10} "
                f"{cell(s.get('dispatches')):>11} "
                f"{cell(s.get('host_blocked_ms')):>12}"
            )
    if fsummary["anomalies"]:
        lines.append("")
        lines.append(f"anomalies: {len(fsummary['anomalies'])}")
        for a in fsummary["anomalies"][-last_n:]:
            detail = {
                k: v for k, v in a.items() if k not in ("kind", "t", "proc", "seq")
            }
            lines.append(f"  - {detail.pop('reason', '?')}: {detail}")
    for pm in (fsummary.get("oom_postmortems") or [])[-last_n:]:
        lines.append("")
        lines.append(
            f"memory postmortem (OOM at {pm.get('source', '?')}): "
            f"blamed owner {pm.get('blame') or 'UNATTRIBUTED'}"
            + (
                f" holding {_human(pm.get('blame_bytes'))}B/chip"
                if pm.get("blame_bytes")
                else ""
            )
        )
        if pm.get("watermark_bytes_in_use") is not None:
            lines.append(
                f"  watermark: {_human(pm.get('watermark_bytes_in_use'))}B in use"
                + (
                    f" (peak {_human(pm.get('watermark_peak_bytes'))}B)"
                    if pm.get("watermark_peak_bytes") is not None
                    else ""
                )
            )
        ranked = pm.get("ranked") or []
        if ranked:
            lines.append(
                "  ranked owners: "
                + ", ".join(
                    f"{r.get('owner')} {_human(r.get('device_bytes'))}B"
                    for r in ranked
                )
            )
        if pm.get("error"):
            lines.append(f"  error: {pm['error']}")
    captures = fsummary.get("profile_captures") or []
    digests = {d.get("trigger_step"): d for d in fsummary.get("profile_digests") or []}
    for cap in captures:
        trigger = cap.get("trigger_step")
        lines.append("")
        lines.append(
            f"anomaly profile capture (trigger step {trigger}): {cap.get('dir')}"
        )
        dig = digests.get(trigger)
        if dig is None:
            lines.append("  no digest recorded (analysis still pending at flush time)")
        elif dig.get("name") == "sentinel.profile_analysis_failed":
            lines.append(f"  analysis FAILED: {dig.get('error')}")
        else:
            overlap = dig.get("overlap_fraction")
            overlap_str = f"{100.0 * overlap:.1f}%" if overlap is not None else "n/a"
            lines.append(
                f"  digest: device busy {dig.get('device_busy_ms')} ms, "
                f"compute {dig.get('compute_ms')} ms, "
                f"collective {dig.get('collective_ms')} ms "
                f"(exposed {dig.get('exposed_collective_ms')} ms, overlap {overlap_str}), "
                f"idle {dig.get('idle_ms')} ms over {dig.get('n_steps')} step(s)"
            )
            top = dig.get("top_ops") or []
            if top:
                lines.append(
                    "  top ops: "
                    + ", ".join(f"{r.get('name')} {r.get('self_ms')} ms" for r in top)
                )
    for sig in fsummary["signals"]:
        lines.append(
            f"signal: {sig.get('name', sig.get('signum'))} at t={sig.get('t')}"
        )
    for crash in fsummary["crashes"]:
        lines.append(f"crash: {crash.get('error')}: {crash.get('message')}")
    final = fsummary["final_event"]
    if final is not None:
        when = final.get("t")
        stamp = (
            time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(when))
            if isinstance(when, (int, float))
            else "?"
        )
        lines.append("")
        lines.append(f"final event before death: {_event_str(final)} at {stamp}")
    return "\n".join(lines)


def _human(n) -> str:
    """1234567 -> '1.2M' (unitless SI prefix; caller appends the unit)."""
    if n is None:
        return "?"
    n = float(n)
    for mag, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(n) >= mag:
            return f"{n / mag:.1f}{suffix} "
    return f"{n:.0f} "


def format_serving_block(snapshot) -> list:
    """Render the serving engine's SLO block from ``serving.*`` metric
    families (``serving/engine.py``); empty list when the run never served."""
    if not snapshot or not any(k.startswith("serving.") for k in snapshot):
        return []
    g = snapshot.get
    lines = ["serving engine (continuous batching):"]
    lines.append(
        f"  requests: {g('serving.requests', 0)} submitted, "
        f"{g('serving.completed', 0)} completed, "
        f"{g('serving.preempted', 0)} preempted; "
        f"{g('serving.tokens', 0)} tokens generated"
    )
    lines.append(
        f"  dispatches: {g('serving.decode_dispatches', 0)} decode "
        f"(fused, 1/step), {g('serving.prefill_dispatches', 0)} prefill chunks"
    )
    spec_rounds = g("serving.spec.rounds", 0)
    if spec_rounds:
        lines.append(
            f"  speculative: {g('serving.spec.accepted', 0)}/"
            f"{g('serving.spec.proposed', 0)} drafts accepted "
            f"(rate {g('serving.spec.acceptance_rate', 0.0):.1%}) over "
            f"{spec_rounds} verify rounds; "
            f"{g('serving.tokens_per_dispatch', 0.0):.2f} tokens/dispatch"
        )

    def hist(stem, label, unit="ms"):
        if g(f"{stem}.count"):
            lines.append(
                f"  {label}: p50 {g(f'{stem}.p50', 0):.2f} / "
                f"p95 {g(f'{stem}.p95', 0):.2f} / "
                f"mean {g(f'{stem}.mean', 0):.2f} {unit} "
                f"({g(f'{stem}.count')} samples)"
            )

    shed = g("serving.shed", 0)
    expired = g("serving.deadline_expired", 0)
    quarantined = g("serving.quarantined", 0)
    if shed or expired or quarantined:
        lines.append(
            f"  robustness: {shed} shed (queue bound), "
            f"{expired} deadline-expired, {quarantined} quarantined"
        )
    hist("serving.ttft_ms", "TTFT")
    hist("serving.inter_token_ms", "inter-token")
    hist("serving.queue_wait_ms", "queue wait")
    hist("serving.requeue_wait_ms", "re-queue wait (post-preemption)")
    hist("serving.tokens_per_s", "per-request throughput", unit="tok/s")
    occ = g("serving.block_occupancy")
    if occ is not None:
        lines.append(
            f"  kv blocks: {g('serving.blocks_used', 0)} in use "
            f"(occupancy {occ:.1%}), queue depth {g('serving.queue_depth', 0)}, "
            f"active slots {g('serving.active_slots', 0)}"
        )
    demotions = g("serving.tier.demotions", 0)
    promotions = g("serving.tier.promotions", 0)
    fallbacks = g("serving.tier.fallback_reprefills", 0)
    if demotions or promotions or fallbacks:
        line = (
            f"  kv tiering: {demotions} demotions / {promotions} promotions "
            f"({g('serving.tier.demoted_blocks', 0)} blocks to host, "
            f"{fallbacks} fallback re-prefills)"
        )
        host_bytes = g("serving.tier.host_bytes")
        if host_bytes is not None:
            line += (
                f"; host tier {_human(host_bytes)}B resident "
                f"({g('serving.tier.host_occupancy', 0.0):.1%} occupancy)"
            )
        lines.append(line)
    return lines


def format_memory_block(snapshot) -> list:
    """Render the HBM-ledger block from the ``memory.*``/``hbm.*`` gauge
    family (``telemetry/memledger.py``): ranked per-owner per-chip bytes,
    the conservation residual, and the fleet-min headroom.  Empty when the
    run registered no owners."""
    if not snapshot:
        return []
    owner_keys = [k for k in snapshot if k.startswith("memory.owner.")]
    if not owner_keys and "memory.attributed_bytes" not in snapshot:
        return []
    g = snapshot.get
    lines = ["memory ledger (per-chip HBM attribution):"]
    for key in sorted(owner_keys, key=lambda k: (-snapshot[k], k)):
        owner = key[len("memory.owner."):]
        if owner.endswith("_bytes"):
            owner = owner[: -len("_bytes")]
        lines.append(f"  {owner:<28} {_human(snapshot[key])}B/chip")
    att = g("memory.attributed_bytes")
    if att is not None:
        line = f"  attributed {_human(att)}B/chip"
        if g("memory.unattributed_bytes") is not None:
            line += f", unattributed residual {_human(g('memory.unattributed_bytes'))}B"
        if g("memory.headroom_bytes") is not None:
            line += f", fleet-min headroom {_human(g('memory.headroom_bytes'))}B"
        lines.append(line)
    if g("hbm.stats_available") == 0:
        lines.append(
            "  (backend reports no memory_stats — attribution only, "
            "no conservation residual)"
        )
    if g("serving.headroom_bytes") is not None:
        lines.append(f"  serving headroom: {_human(g('serving.headroom_bytes'))}B")
    if g("memory.oom_postmortems"):
        lines.append(
            f"  OOM postmortems recorded: {int(g('memory.oom_postmortems'))} "
            "(see the flight-recorder block)"
        )
    return lines


def format_goodput_block(summary: dict) -> list:
    """Render the wall-clock attribution ledger (goodput accounting);
    empty list when there is nothing attributed (no instrumented activity)."""
    gp = summary.get("goodput")
    if not gp or gp.get("attributed_s", 0.0) <= 0.0:
        return []
    from .goodput import CATEGORIES

    lines = [
        f"goodput ledger — elapsed {gp['elapsed_s']:.2f}s, "
        f"productive {100.0 * gp['goodput_fraction']:.1f}% "
        f"(conservation error {gp['conservation_error_s']:.6f}s)"
    ]
    markers = gp.get("markers") or {}
    for name in CATEGORIES:
        seconds = gp["seconds"].get(name, 0.0)
        frac = gp["fractions"].get(name, 0.0)
        if seconds <= 0.0 and name not in markers:
            continue
        mark = f"  [{markers[name]} marker(s)]" if name in markers else ""
        lines.append(f"  {name:<16} {seconds:>10.3f}s {100.0 * frac:>6.1f}%{mark}")
    snapshot = summary.get("snapshot") or {}
    fleet = snapshot.get("goodput.fleet_fraction")
    if fleet is not None:
        hosts = snapshot.get("goodput.fleet_hosts")
        lines.append(
            f"  fleet goodput (min over {int(hosts) if hosts else '?'} host(s)): "
            f"{100.0 * fleet:.1f}%"
        )
    for s in summary.get("stragglers") or []:
        if s.get("cleared"):
            continue  # the host recovered after its last straggler verdict
        lines.append(
            f"  STRAGGLER host {s.get('host')}: median {s.get('median_ms')} ms "
            f"vs fleet {s.get('fleet_median_ms')} ms ({s.get('ratio')}x)"
        )
    return lines


def format_report(summary: dict) -> str:
    lines = []
    spans = summary["spans"]
    lines.append(f"telemetry report — {summary['n_records']} records")
    lines.append("")
    if spans:
        lines.append(
            f"{'span':<36} {'count':>7} {'total_ms':>12} {'mean_ms':>10} {'max_ms':>10} {'%top':>6}"
        )
        top = summary["toplevel_ms"] or 1.0
        for name, agg in sorted(spans.items(), key=lambda kv: -kv[1]["total_ms"]):
            mean = agg["total_ms"] / agg["count"]
            pct = 100.0 * agg["total_ms"] / top if agg["depth"] == 0 else float("nan")
            pct_str = f"{pct:6.1f}" if pct == pct else "     -"
            lines.append(
                f"{name:<36} {agg['count']:>7} {agg['total_ms']:>12.1f} "
                f"{mean:>10.2f} {agg['max_ms']:>10.1f} {pct_str}"
            )
    else:
        lines.append("no spans recorded")
    lines.append("")
    lines.append(
        f"compiles: {summary['compiles']} ({summary['compile_ms']:.1f} ms total)"
    )
    if summary["stalls"]:
        lines.append(f"stalls: {len(summary['stalls'])}")
        for s in summary["stalls"]:
            lines.append(f"  - stalled {s['elapsed_s']}s (deadline {s['deadline_s']}s)")
    for name, rec in sorted(summary.get("introspect", {}).items()):
        lines.append("")
        lines.append(f"compiled program {name!r} (introspection):")
        lines.append(
            f"  cost: {_human(rec.get('flops'))}FLOPs, "
            f"{_human(rec.get('bytes_accessed'))}B accessed"
        )
        mem = rec.get("memory") or {}
        if mem:
            lines.append(
                "  memory: "
                + ", ".join(f"{k.replace('_bytes', '')} {_human(v)}B" for k, v in mem.items())
            )
        comms = rec.get("comms") or {}
        by_kind = comms.get("by_kind") or {}
        if by_kind:
            lines.append(
                f"  comms: {_human(comms.get('total_bytes'))}B total"
                + (
                    f" (est. comms/compute ratio {rec['comms_compute_ratio']:.3f})"
                    if rec.get("comms_compute_ratio") is not None
                    else ""
                )
            )
            for op_kind in sorted(by_kind):
                agg = by_kind[op_kind]
                lines.append(
                    f"    {op_kind:<20} x{agg['count']:<4} {_human(agg['bytes'])}B"
                )
            by_axis = comms.get("by_axis") or {}
            if by_axis:
                lines.append(
                    "    per mesh axis: "
                    + ", ".join(f"{ax}={_human(b)}B" for ax, b in sorted(by_axis.items()))
                )
        else:
            lines.append("  comms: no collectives (single-device program)")
        for finding in rec.get("lint") or []:
            lines.append(f"  LINT[{finding.get('kind')}]: {finding.get('message')}")
    for source in sorted(summary.get("profiles") or {}):
        from .profile_scan import format_profile_report, report_from_dict

        lines.append("")
        lines.append(format_profile_report(report_from_dict(summary["profiles"][source])))
    goodput = format_goodput_block(summary)
    if goodput:
        lines.append("")
        lines.extend(goodput)
    snapshot = summary["snapshot"]
    serving = format_serving_block(snapshot)
    if serving:
        lines.append("")
        lines.extend(serving)
    memory = format_memory_block(snapshot)
    if memory:
        lines.append("")
        lines.extend(memory)
    if snapshot:
        lines.append("")
        lines.append("final metrics snapshot:")
        for key in sorted(snapshot):
            value = snapshot[key]
            if isinstance(value, float):
                value = round(value, 4)
            lines.append(f"  {key} = {value}")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.telemetry.report",
        description=(
            "Summarize a telemetry/flight-recorder JSONL run: per-span time "
            "breakdown, compile stats, metrics snapshot, and (when a "
            "flight-recorder snapshot exists) a postmortem of the last steps."
        ),
    )
    parser.add_argument(
        "path",
        nargs="?",
        default=None,
        help="telemetry/flightrec JSONL file or run directory",
    )
    parser.add_argument(
        "--last",
        type=int,
        default=10,
        metavar="N",
        help="steps/anomalies to show in the flight-recorder block (default 10)",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help=(
            "machine-readable output: one JSON object with telemetry/"
            "postmortem/profile blocks instead of the human report"
        ),
    )
    parser.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help=(
            "analyze a profiler trace directory (or *.trace.json[.gz] "
            "file) offline and append the attribution block"
        ),
    )
    parser.add_argument(
        "--fleet",
        action="store_true",
        help=(
            "fleet postmortem view: merge every rank's telemetry_p*/"
            "flightrec_p* stream under the run directory into one rank-tagged "
            "timeline (last sign of life per rank, first-silent rank, merged "
            "tail)"
        ),
    )
    args = parser.parse_args(argv)
    if args.path is None and args.profile is None:
        parser.error("a run path and/or --profile <dir> is required")
    profile_report = None
    if args.profile is not None:
        from .profile_scan import TraceParseError, analyze_trace_dir

        if not os.path.exists(args.profile):
            print(f"no such file or directory: {args.profile}", file=sys.stderr)
            return 1
        try:
            profile_report = analyze_trace_dir(args.profile)
        except TraceParseError as e:
            print(f"profile scan failed: {e}", file=sys.stderr)
            return 1
    records: list = []
    flight: list = []
    serving_traces: list = []
    fleet: dict = {}
    if args.path is not None:
        if not os.path.exists(args.path):
            print(f"no such file or directory: {args.path}", file=sys.stderr)
            return 1
        is_flight_file = not os.path.isdir(args.path) and os.path.basename(
            args.path
        ).startswith("flightrec_")
        is_trace_file = not os.path.isdir(args.path) and os.path.basename(
            args.path
        ).startswith("serving_trace_")
        records = [] if (is_flight_file or is_trace_file) else load_records(args.path)
        flight = (
            load_flight_records(args.path)
            if (os.path.isdir(args.path) or is_flight_file)
            else []
        )
        serving_traces = load_serving_trace_records(args.path)
        if args.fleet:
            fleet = load_fleet_records(args.path)
            if not fleet:
                print(
                    f"--fleet: no telemetry_p*/flightrec_p* streams under {args.path}",
                    file=sys.stderr,
                )
                return 1
        if not records and not flight and not serving_traces:
            print(f"no telemetry records found under {args.path}", file=sys.stderr)
            # A successful --profile scan still renders: the run dir being
            # empty must not throw away the half that worked.
            if profile_report is None:
                return 1
    if args.json:
        # Machine contract (bench/CI): stable top-level keys, no screen
        # scraping.  Blocks are present only when their inputs are.
        out: dict = {}
        if records:
            summary = summarize(records)
            # The ledger is its own machine contract (bench/perf_gate/chaos
            # consume it): a stable top-level key, independent of where the
            # telemetry block's internals move.
            out["goodput"] = summary.pop("goodput", None)
            out["telemetry"] = summary
        if flight:
            out["postmortem"] = summarize_flight(flight)
        if serving_traces:
            # Offline blame decomposition, recomputed from the trace JSONL —
            # a dead engine gets the same block a live one would.
            from ..serving.tracing import summarize_traces

            out["serving_traces"] = summarize_traces(serving_traces)
        if fleet:
            out["fleet"] = summarize_fleet(fleet)
        if profile_report is not None:
            out["profile"] = profile_report.to_dict()
        print(json.dumps(out, default=str))
        return 0
    blocks = []
    if records:
        blocks.append(format_report(summarize(records)))
    if flight:
        blocks.append(format_flight_report(summarize_flight(flight), last_n=args.last))
    if fleet:
        blocks.append(format_fleet_report(summarize_fleet(fleet), last_n=args.last))
    if serving_traces:
        from ..serving.tracing import format_trace_block, summarize_traces

        trace_lines = format_trace_block(summarize_traces(serving_traces))
        if trace_lines:
            blocks.append("\n".join(trace_lines))
    if profile_report is not None:
        from .profile_scan import format_profile_report

        blocks.append(format_profile_report(profile_report))
    print("\n\n".join(blocks))
    return 0


if __name__ == "__main__":
    sys.exit(main())
