"""Per-request serving traces in the port (``accelerate_tpu_torch/serving/tracing.py``
and the engine's hooks) against the JAX package.

The unit tests of the JAX ``tests/test_serving_trace.py`` run on the port's
copy: the cursor partition, the blame floor, the torn tail, stitching, and
the kill switch with its override.  The port's Chrome export loads through
the JAX package's ``telemetry.timeline``.  Then the same traffic (more
requests than slots, a pool tight enough to preempt) goes through both
engines on tiny llama, and every request's phase sequence must match:
phase names, chunks, ``co_batch``, table ``width``, ``ticks``, waiting
turns and the first-dispatch (``compile_in_path``) markers."""

import json
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import ServingConfig as JConfig
from accelerate_tpu.serving import ServingEngine as JEngine
from accelerate_tpu.telemetry.timeline import build_timeline, load_trace_events
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.serving import ServingConfig, ServingEngine
from accelerate_tpu_torch.serving.tracing import (
    RequestTrace,
    decompose_blame,
    export_chrome_trace,
    format_trace_block,
    load_serving_traces,
    stitch_traces,
    summarize_traces,
)
from accelerate_tpu_torch.utils.convert import llama_params_from_jax

META = ("chunk", "co_batch", "width", "ticks", "kind", "waiting", "padded_rows", "slot",
        "emitted", "terminal")


@pytest.fixture(scope="module")
def llama_setup():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    jparams = jl.init_params(jcfg, jax.random.key(0))
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _engine(setup, **overrides):
    _, tcfg, _, tparams = setup
    kw = dict(block_size=4, num_blocks=32, max_slots=2, max_blocks_per_seq=8, prefill_chunk=8,
              trace=True)
    kw.update(overrides)
    return ServingEngine(tl.apply_cached, tl.init_cache, tparams, tcfg, device="cpu",
                         serving=ServingConfig(**kw))


# ---------------------------------------------------------------------------
# Units of the tracing module (synthetic clock)
# ---------------------------------------------------------------------------


def test_cursor_makes_intervals_a_partition():
    t = RequestTrace(1, "t", arrival=100.0, prompt_len=4, max_new=8)
    t.add("queue_wait", 100.5)
    t.add("prefill", 100.8, start=100.2)       # overlapping start: clamped
    t.add("decode", 101.0, start=99.0)         # before arrival: clamped
    t.add("preempted", 100.9, start=100.9)     # end < cursor: zero-dur marker
    t.add("requeued_wait", 101.4)
    for prev, cur in zip(t.intervals, t.intervals[1:]):
        assert cur.start >= prev.end
    t.finish = 101.5
    window = t.window_ms()
    attributed = sum(t.phase_ms().values())
    assert abs(window - attributed - t.unattributed_ms()) < 1e-9
    assert t.unattributed_ms() == pytest.approx(100.0)
    assert t.phase_ms()["queue_wait"] == pytest.approx(500.0)


def test_blame_floor_dominance_and_quarantine():
    assert decompose_blame({"queue_wait": 900.0}, 1000.0, "quarantined") == "quarantine"
    assert decompose_blame(
        {"queue_wait": 400.0, "requeued_wait": 100.0, "decode": 500.0}, 1000.0
    ) == "queue_wait"
    assert decompose_blame({"decode": 990.0, "queue_wait": 5.0}, 1000.0) == "none"
    assert decompose_blame({"compile_in_path": 50.0, "decode": 950.0}, 1000.0) == "none"
    assert decompose_blame({"queue_wait": 0.4, "decode": 0.2}, 0.8) == "none"
    assert decompose_blame({"queue_wait": 3.0, "decode": 0.2}, 4.0) == "queue_wait"


def _synthetic_trace(rid, tag, arrival, phases):
    t = RequestTrace(rid, tag, arrival=arrival, prompt_len=3, max_new=4)
    cur = arrival
    for name, dur, meta in phases:
        cur += dur
        t.add(name, cur, **meta)
    t.finish = cur
    t.status = "ok"
    t.blame = decompose_blame(t.phase_ms(), t.window_ms(), "ok")
    return t


def test_chrome_export_loads_through_the_jax_timeline(tmp_path):
    now = time.monotonic()
    traces = [
        _synthetic_trace(0, "a", now, [
            ("queue_wait", 0.1, {}),
            ("prefill", 0.02, {"slot": 0, "chunk": 0}),
            ("decode", 0.3, {"slot": 0, "co_batch": 2, "ticks": 7}),
        ]),
        _synthetic_trace(1, None, now + 0.05, [
            ("queue_wait", 0.01, {}),
            ("compile_in_path", 0.4, {"slot": 1, "kind": "decode", "width": 4}),
        ]),
    ]
    for path in (str(tmp_path / "t.trace.json"), str(tmp_path / "t.trace.json.gz")):
        export_chrome_trace(path, traces)
        tl_ = build_timeline(load_trace_events(path), source=path)
        assert tl_.host_events and not tl_.events
        tracks = set(tl_.tracks().values())
        assert "serving engine slots/slot 0" in tracks
        assert "serving requests/req 0 [a]" in tracks
        names = {ev.name for ev in tl_.host_events}
        assert {"queue_wait", "decode", "compile_in_path"} <= names
        assert any(ev.name == "r0/decode" for ev in tl_.host_events)


def test_load_last_record_wins_and_tolerates_torn_tail(tmp_path):
    path = tmp_path / "serving_trace_111_ab.jsonl"
    rec_inflight = {"kind": "serving_trace", "rid": 5, "tag": "x", "status": "inflight",
                    "arrival_wall": 10.0, "duration_ms": 50.0,
                    "phase_ms": {"queue_wait": 50.0}, "unattributed_ms": 0.0}
    rec_final = dict(rec_inflight, status="ok", duration_ms=80.0, blame="queue_wait")
    with open(path, "w") as f:
        f.write(json.dumps(rec_inflight) + "\n")
        f.write(json.dumps({"kind": "other"}) + "\n")
        f.write(json.dumps(rec_final) + "\n")
        f.write('{"kind": "serving_trace", "rid": 9, "sta')  # torn tail
    records = load_serving_traces(str(tmp_path))
    assert len(records) == 1
    assert records[0]["status"] == "ok" and records[0]["duration_ms"] == 80.0
    assert records[0]["source"] == path.name
    assert load_serving_traces(str(path))[0]["rid"] == 5


def test_stitch_joins_lives_by_tag_with_recovery_gap():
    victim = {"kind": "serving_trace", "rid": 0, "tag": "job", "status": "inflight",
              "arrival_wall": 1000.0, "duration_ms": 200.0,
              "phase_ms": {"queue_wait": 10.0, "decode": 190.0}, "unattributed_ms": 0.0}
    successor = {"kind": "serving_trace", "rid": 7, "tag": "job", "status": "ok",
                 "arrival_wall": 1000.5, "duration_ms": 100.0,
                 "phase_ms": {"journal_recovery": 0.0, "prefill": 40.0, "decode": 60.0},
                 "unattributed_ms": 0.0, "recovered_from": 0}
    untagged = dict(victim, tag=None, rid=3)
    stitched = stitch_traces([successor, victim, untagged])
    assert len(stitched) == 1
    st = stitched[0]
    assert st["tag"] == "job" and st["lives"] == 2 and st["status"] == "ok"
    assert st["journal_recovery_ms"] == pytest.approx(300.0, abs=1.0)
    assert st["total_ms"] == pytest.approx(600.0, abs=1.0)
    assert st["conservation_ok"], st
    assert stitch_traces([victim]) == []
    summary = summarize_traces([victim, successor])
    assert summary["requests"] == 1 and summary["inflight"] == 1
    assert summary["stitched"] == stitched
    block = "\n".join(format_trace_block(summary))
    assert "stitched tag 'job'" in block and "conservation ok" in block


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def test_kill_switch_and_config_override(llama_setup, monkeypatch, tmp_path):
    monkeypatch.setenv("ACCELERATE_TPU_SERVING_TRACE", "0")
    assert _engine(llama_setup, trace=None).tracer is None
    eng = _engine(llama_setup, trace=True, trace_dir=str(tmp_path))
    assert eng.tracer is not None  # explicit config beats the env
    monkeypatch.delenv("ACCELERATE_TPU_SERVING_TRACE")
    assert _engine(llama_setup, trace=None).tracer is not None  # default-on
    assert ServingConfig().trace is None  # so ServingConfig() traces by default
    assert eng.debug_requests() == []
    blocks = eng.debug_blocks()
    assert blocks["used"] == 0 and blocks["free"] == blocks["capacity"]
    assert blocks["occupancy"] == 0.0 and blocks["slots"] == {}
    with pytest.raises(RuntimeError, match="tracing"):
        _engine(llama_setup, trace=False).export_chrome_trace(str(tmp_path / "no.json"))
    assert _engine(llama_setup, trace=False).stats()["trace_blame"] is None


def _sequence(trace):
    return [(iv.phase, {k: iv.meta.get(k) for k in META}) for iv in trace.intervals]


@pytest.mark.parametrize("spec_tokens", [0, 2])
def test_phase_sequences_match_the_jax_engine(llama_setup, spec_tokens, tmp_path):
    """Five requests on three slots over a 12-block pool: queue waits,
    preemptions, requeued waits, waiting prefill turns and first
    dispatches at each width, recorded alike by both engines."""
    jcfg, tcfg, jparams, tparams = llama_setup
    rng = np.random.default_rng(21)
    prompts = [list(rng.integers(0, jcfg.vocab_size, size=n)) for n in (12, 10, 6, 17, 9)]
    geometry = dict(block_size=4, num_blocks=12, max_slots=3, prefill_chunk=8,
                    max_blocks_per_seq=8, spec_tokens=spec_tokens, trace=True)
    jeng = JEngine(jl.apply_cached, jl.init_cache, jparams, jcfg, serving=JConfig(**geometry))
    teng = ServingEngine(tl.apply_cached, tl.init_cache, tparams, tcfg, device="cpu",
                         serving=ServingConfig(paged_kernel=True,
                                               trace_dir=str(tmp_path), **geometry))
    jids = [jeng.submit(p, 7, tag=f"r{i}") for i, p in enumerate(prompts)]
    tids = [teng.submit(p, 7, tag=f"r{i}") for i, p in enumerate(prompts)]
    jout = jeng.run(max_ticks=500)
    mid_run = None
    while not teng.sched.idle():
        teng.step()
        if mid_run is None and teng.sched.pending:
            mid_run = teng.debug_requests()
    tout = {c.id: c.tokens for c in teng.pop_finished()}
    assert [tout[t] for t in tids] == [jout[j] for j in jids]
    assert teng.stats()["preempted"] == jeng.stats()["preempted"] > 0

    jtr = {t.rid: t for t in jeng.tracer.completed}
    ttr = {t.rid: t for t in teng.tracer.completed}
    phases = set()
    for j, t in zip(jids, tids):
        assert _sequence(ttr[t]) == _sequence(jtr[j]), f"request {t}"
        phases |= {iv.phase for iv in ttr[t].intervals}
    assert {"queue_wait", "prefill", "preempted", "requeued_wait", "compile_in_path"} <= phases
    assert ("verify" if spec_tokens else "decode") in phases

    # Conservation: disjoint intervals inside submit -> terminal.
    for t in ttr.values():
        assert t.finish is not None and t.unattributed_ms() >= 0.0
        for prev, cur in zip(t.intervals, t.intervals[1:]):
            assert cur.start >= prev.end
        assert t.intervals[0].start >= t.arrival and t.intervals[-1].end <= t.finish
    assert teng.stats()["trace_blame"] == teng.tracer.blame_counts
    assert sum(teng.tracer.blame_counts.values()) == len(prompts)

    # Mid-run introspection saw queued requests and their phase so far.
    assert mid_run and any(r["slot"] is None for r in mid_run)
    assert all("current_phase" in r["trace"] for r in mid_run)

    # The terminal records persisted; the Chrome export reads back.
    summary = summarize_traces(load_serving_traces(str(tmp_path)))
    assert summary["requests"] == len(prompts)
    path = teng.export_chrome_trace(str(tmp_path / "engine.trace.json"))
    names = {ev.name for ev in build_timeline(load_trace_events(path)).host_events}
    assert "preempted" in names


def test_journal_recovery_marks_the_successor_trace(llama_setup, tmp_path):
    journal = str(tmp_path / "journal.json")
    first = _engine(llama_setup, journal_path=journal, trace_dir=str(tmp_path))
    rid = first.submit([5, 6, 7, 8, 9, 10], 6, tag="a")
    for _ in range(2):
        first.step()
    succ = _engine(llama_setup, journal_path=journal, trace_dir=str(tmp_path))
    assert len(succ.recover_from_journal()) == 1
    succ.run(max_ticks=100)
    (trace,) = succ.tracer.completed
    assert trace.recovered_from == rid and trace.tag == "a"
    assert trace.intervals[0].phase == "journal_recovery"
    first.tracer.flush()  # the abandoned life's in-flight snapshot
    stitched = stitch_traces(load_serving_traces(str(tmp_path)))
    assert [s["tag"] for s in stitched] == ["a"] and stitched[0]["lives"] == 2
