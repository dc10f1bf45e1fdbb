"""Serving-trace smoke: blame decomposition + export + live /debug.

The port of the JAX package's ``serving/trace_smoke.py`` (one process, as
there): ``python -m accelerate_tpu_torch.serving.trace_smoke`` (on the
card; ``--device cpu`` on the CPU).  Drives the per-request trace subsystem
(``serving/tracing.py``) end to end on gpt2-tiny:

- **blame names the injected phase** — one request is held in the queue
  (injected submit->step delay: ``queue_wait`` must dominate), another is
  forcibly preempted mid-decode and held requeued (``requeued_wait`` must
  dominate); the blame decomposer must name each correctly, and the
  ``serving.trace.blame.*`` counters must land in the registry;
- **conservation** — every completed request's phase durations sum to its
  submission->terminal wall time, ``unattributed_ms`` bounded;
- **Chrome export round-trips** — the exported trace re-parses through
  ``telemetry/timeline.py`` with the slot/request tracks intact;
- **live inspection** — a real HTTP scrape of the metrics server (127.0.0.1,
  an ephemeral port) mid-flight: ``/healthz`` 200, ``/debug/requests``
  shows the in-flight request with its phase-so-far, ``/debug/blocks``
  shows pool occupancy, unknown paths 404;
- **offline postmortem** — the serving-traces block renders from the JSONL
  alone;
- **overhead bounded** — steady-state decode throughput with tracing on
  stays within the JAX smoke's generous 0.75 ratio of tracing off.

Exit code 0 only when every assertion holds.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
import urllib.error
import urllib.request
from typing import Optional


def run(device: Optional[str] = None) -> dict:
    from ..state import resolve_device

    device = str(resolve_device(device))

    os.environ.setdefault("ACCELERATE_TPU_SENTINEL_PROFILE", "0")
    os.environ.pop("ACCELERATE_TPU_SERVING_TRACE", None)  # default-on path

    import numpy as np
    import torch

    from .. import telemetry
    from ..models import gpt2
    from ..telemetry.export import MetricsExporter
    from ..telemetry.timeline import build_timeline, load_trace_events
    from . import ServingConfig, ServingEngine
    from .tracing import format_trace_block, load_serving_traces, summarize_traces
    run_dir = tempfile.mkdtemp(prefix="atpu_trace_smoke_")
    tel = telemetry.enable(dir=run_dir)
    exporter = MetricsExporter()
    exporter.start(port=0)

    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32)
    params = gpt2.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)

    def build(trace=None):
        return ServingEngine(
            gpt2.apply_cached, gpt2.init_cache, params, cfg,
            serving=ServingConfig(
                block_size=4, num_blocks=32, max_slots=2, max_blocks_per_seq=8,
                prefill_chunk=8, trace=trace, trace_dir=run_dir,
                paged_kernel=device != "cpu",
            ),
            device=device,
        )

    def prompt(n):
        return list(rng.integers(0, cfg.vocab_size, size=n))

    engine = build()
    assert engine.tracer is not None, "tracing default-on did not arm the tracer"

    # Warm every bucket width first so the scenario requests below pay no
    # first-dispatch cost in their path — their blame must be the INJECTED
    # phase, nothing else.
    # A short-prompt pass covers table widths 1–2, the concurrent pair covers
    # widths 4–8, and a long prompt reaches prefill width 8 (a preempted
    # request re-prefilling its emitted tokens buckets that wide); together
    # that is every width the scenario requests can dispatch at.
    engine.submit(prompt(3), 6, tag="warmup-short")
    engine.run(max_ticks=500)
    for i in range(2):
        engine.submit(prompt(12), 18, tag=f"warmup{i}")
    engine.submit(prompt(20), 4, tag="warmup-long")
    engine.run(max_ticks=500)

    # Scenario 1 — queue delay: submit, then hold the engine for 120 ms
    # before the first tick.  queue_wait must dominate the request.
    # max_new=12 keeps the request in a slot across the /debug scrape below
    # (a prefill-completing tick also decodes once, so small budgets finish
    # within the first few ticks) while keeping the decode window short
    # enough that the injected delay clears the blame floor.
    rid_queue = engine.submit(prompt(6), 12, tag="slow-queue")
    time.sleep(0.12)
    for _ in range(3):
        engine.step()

    # Mid-flight: scrape the live endpoints while the request is in a slot.
    port = exporter.port
    health = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/healthz", timeout=10
    )
    assert health.status == 200 and health.read() == b"ok\n", "/healthz broken"
    dbg = json.loads(
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/debug/requests", timeout=10
        ).read()
    )
    inflight = [r for eng_reqs in dbg["engines"] for r in eng_reqs]
    mine = [r for r in inflight if r["tag"] == "slow-queue"]
    assert mine, f"/debug/requests lost the in-flight request: {dbg}"
    assert mine[0]["state"] in ("PREFILLING", "DECODING"), mine
    assert mine[0]["trace"]["phase_ms"].get("queue_wait", 0.0) >= 60.0, mine
    blocks = json.loads(
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/debug/blocks", timeout=10
        ).read()
    )
    pool = blocks["engines"][0]
    assert pool["used"] > 0 and 0.0 < pool["occupancy"] <= 1.0, pool
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/other", timeout=10)
        raise AssertionError("unknown path did not 404")
    except urllib.error.HTTPError as err:
        assert err.code == 404, err.code
    print("# trace smoke: /healthz + /debug/requests + /debug/blocks live, 404 intact")

    # Scenario 2 — injected preemption: evict the decoding request and hold
    # it requeued for 120 ms.  requeued_wait must dominate ITS timeline.
    rid_preempt = engine.submit(prompt(6), 12, tag="slow-preempt")
    for _ in range(6):
        engine.step()
    victim = [
        idx for idx, slot in engine.sched.slots.items()
        if slot.request.id == rid_preempt
    ]
    assert victim, "preemption target never reached a slot"
    engine.sched.preempt_slot(victim[0])
    time.sleep(0.12)
    engine.run(max_ticks=1000)

    by_rid = {t.rid: t for t in engine.tracer.completed}
    t_queue, t_preempt = by_rid[rid_queue], by_rid[rid_preempt]
    assert t_queue.blame == "queue_wait", (
        f"queue-delay request blamed {t_queue.blame!r}: {t_queue.phase_ms()}"
    )
    assert t_preempt.blame == "requeued_wait", (
        f"preempted request blamed {t_preempt.blame!r}: {t_preempt.phase_ms()}"
    )
    assert any(iv.phase == "preempted" for iv in t_preempt.intervals)
    for t in engine.tracer.completed:
        window, attributed = t.window_ms(), sum(t.phase_ms().values())
        resid = t.unattributed_ms()
        assert abs(window - attributed - resid) < 1e-6, (window, attributed, resid)
        assert 0.0 <= resid <= max(5.0, 0.05 * window), (
            f"rid {t.rid}: unattributed {resid:.2f} ms of {window:.2f} ms window"
        )
    assert tel.registry.counter("serving.trace.blame.queue_wait").value >= 1
    assert tel.registry.counter("serving.trace.blame.requeued_wait").value >= 1
    print("# trace smoke: blame named the injected phases; conservation holds")

    # Chrome export → back through the profiler-trace parser.
    trace_path = os.path.join(run_dir, "serving.trace.json")
    engine.export_chrome_trace(trace_path)
    tl = build_timeline(load_trace_events(trace_path), source=trace_path)
    assert tl.host_events and not tl.events, "serving events misread as device ops"
    tracks = set(tl.tracks().values())
    assert any("serving engine slots/slot" in t for t in tracks), tracks
    assert any("serving requests/req" in t for t in tracks), tracks
    phases_seen = {ev.name for ev in tl.host_events}
    assert {"queue_wait", "decode", "preempted", "requeued_wait"} <= phases_seen, phases_seen
    print(f"# trace smoke: Chrome export round-tripped ({len(tl.host_events)} events, {len(tracks)} tracks)")

    # Offline postmortem from the JSONL alone.
    summary = summarize_traces(load_serving_traces(run_dir))
    assert summary["requests"] >= 3
    assert summary["by_blame"].get("queue_wait", 0) >= 1
    assert summary["by_blame"].get("requeued_wait", 0) >= 1
    block = "\n".join(format_trace_block(summary))
    assert "serving traces (per-request blame)" in block
    print("# trace smoke: offline report block renders from JSONL")
    print(block)

    # Overhead: steady-state decode ticks, tracing on vs off.  A top-up loop
    # keeps both slots busy with an identical deterministic request stream —
    # the measured window exercises the tracer's full request lifecycle
    # (submit, admit, decode coalescing, terminal write), not just the
    # per-tick hooks.  Measurement is PAIRED: both arms are warmed, then
    # alternate 25-tick chunks for 20 rounds and the per-round rate ratio's
    # MEDIAN is the verdict — ambient load waves hit both arms of a round
    # alike, and the median sheds GC/IO spikes that best-of designs let
    # decide the outcome.  The bound is deliberately loose: a tiny-model CPU
    # tick is ~1 ms of host-bound Python, so the tracer's ~tens of µs per
    # tick weigh far more HERE than on a device-bound decode tick; 0.75
    # still fails on pathological regressions (per-tick sync flushes, O(n)
    # interval scans).
    nonce = iter(range(100_000))

    def make_arm(trace):
        eng = build(trace=trace)

        def chunk(n):
            while len(eng.sched.queue) < 2:
                eng.submit(prompt(10), 20, tag=f"perf{next(nonce)}")
            n0 = eng.decode_dispatches
            t0 = time.perf_counter()
            for _ in range(n):
                if len(eng.sched.queue) < 2:
                    eng.submit(prompt(10), 20, tag=f"perf{next(nonce)}")
                eng.step()
            return (eng.decode_dispatches - n0) / (time.perf_counter() - t0)

        for _ in range(6):  # warm: compile every width, reach steady state
            chunk(25)
        return chunk

    arm_on, arm_off = make_arm(True), make_arm(False)
    ratios = sorted(arm_on(25) / arm_off(25) for _ in range(20))
    ratio = ratios[len(ratios) // 2]
    print(
        f"# trace smoke: paired decode throughput ratio on/off median {ratio:.3f} "
        f"(spread {ratios[0]:.3f}..{ratios[-1]:.3f})"
    )
    assert ratio >= 0.75, (
        f"tracing overhead too high: on/off throughput ratio {ratio:.3f} < 0.75 "
        "(see comment — this CPU probe magnifies host-side cost ~30x vs a "
        "device-bound tick)"
    )

    exporter.stop(final_snapshot=False)
    telemetry.disable()
    print("serving trace smoke OK")
    return {"requests": summary["requests"], "by_blame": summary["by_blame"],
            "overhead_ratio": ratio}


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="python -m accelerate_tpu_torch.serving.trace_smoke")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
