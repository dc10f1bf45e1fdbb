"""The port's telemetry (``accelerate_tpu_torch.telemetry``) against the JAX
package's on the same inputs: registry and histogram snapshots, Prometheus
text, sentinel verdicts, goodput category seconds, memory-ledger snapshots,
``report.summarize`` both ways over one run directory, ``profile_scan`` on
the committed JAX fixture; then the port's own touch points (the CUDA
allocator collector on the CPU, kernel-build events, storages counted once,
the profiler window, the emit sites against the name registry, the trace
directory fallback).  Inputs come from numpy seeds; every comparison is
exact (``==``) unless a tolerance is named beside it."""

import json
import os
import pathlib
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import accelerate_tpu.telemetry as jt
import accelerate_tpu_torch.telemetry as tt
from accelerate_tpu.telemetry import export as jexport
from accelerate_tpu.telemetry import goodput as jgoodput
from accelerate_tpu.telemetry import memledger as jmem
from accelerate_tpu.telemetry import profile_scan as jscan
from accelerate_tpu.telemetry import report as jreport
from accelerate_tpu.telemetry import sentinel as jsentinel
from accelerate_tpu_torch.telemetry import export as texport
from accelerate_tpu_torch.telemetry import flightrec as tflightrec
from accelerate_tpu_torch.telemetry import goodput as tgoodput
from accelerate_tpu_torch.telemetry import memledger as tmem
from accelerate_tpu_torch.telemetry import metrics as tmetrics
from accelerate_tpu_torch.telemetry import names as tnames
from accelerate_tpu_torch.telemetry import profile_scan as tscan
from accelerate_tpu_torch.telemetry import report as treport
from accelerate_tpu_torch.telemetry import sentinel as tsentinel
from accelerate_tpu_torch.telemetry import timeline

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_FIXTURE = REPO / "tests" / "fixtures" / "profile" / "sample.trace.json.gz"


def _quiet(pkg):
    pkg.disable()
    pkg.flightrec.disable() if hasattr(pkg, "flightrec") else None
    tel = pkg.get_telemetry()
    tel.registry.reset()
    tel.step_timer.reset()
    tel.step_timer.tokens_per_step = tel.step_timer.flops_per_step = None
    pkg.get_memory_ledger().reset()


@pytest.fixture(autouse=True)
def _telemetry_off():
    from accelerate_tpu.telemetry import flightrec as jflightrec

    for pkg, rec, gp in ((jt, jflightrec, jgoodput), (tt, tflightrec, tgoodput)):
        rec.disable()
        _quiet(pkg)
        gp.detach()
    yield
    for pkg, rec, gp in ((jt, jflightrec, jgoodput), (tt, tflightrec, tgoodput)):
        rec.disable()
        _quiet(pkg)
        gp.detach()


def _series(seed, n=200):
    rng = np.random.default_rng(seed)
    return [float(x) for x in rng.lognormal(3.0, 1.5, size=n)]


# ---------------------------------------------------------------------------
# Registry, histograms, Prometheus text
# ---------------------------------------------------------------------------


def _fill(pkg, seed):
    reg = pkg.MetricsRegistry()
    rng = np.random.default_rng(seed)
    for v in _series(seed):
        reg.histogram("step.time_ms").observe(v)
        reg.histogram("serving.ttft_ms").observe(v / 7.0)
    reg.counter("pipeline.dispatches").inc(int(rng.integers(1, 50)))
    reg.counter("serving.requests").inc(3)
    reg.gauge("step.mfu").set(float(rng.random()))
    reg.gauge("hbm.stats_available").set(0)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_and_histogram_snapshots_equal_jax(seed):
    got, want = _fill(tt, seed), _fill(jt, seed)
    assert got.snapshot() == want.snapshot()
    for name in ("step.time_ms", "serving.ttft_ms"):
        assert got.histogram(name).bucket_counts == want.histogram(name).bucket_counts
        assert (got.histogram(name).over_threshold_fraction(40.0)
                == want.histogram(name).over_threshold_fraction(40.0))


@pytest.mark.parametrize("seed", [0, 1])
def test_render_prometheus_text_equal_jax(seed):
    assert texport.render_prometheus(_fill(tt, seed)) == jexport.render_prometheus(_fill(jt, seed))


# ---------------------------------------------------------------------------
# Sentinel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sentinel_verdicts_equal_jax_on_spiky_series(seed):
    rng = np.random.default_rng(seed)
    durs = list(rng.normal(100.0, 5.0, size=120))
    for i in rng.choice(np.arange(20, 120), size=8, replace=False):
        durs[int(i)] *= float(rng.uniform(2.0, 6.0))
    kw = dict(window=32, warmup=8, factor=2.5, min_excess_ms=5.0)
    got_s, want_s = tsentinel.AnomalySentinel(**kw), jsentinel.AnomalySentinel(**kw)
    got = [got_s.observe(d) for d in durs]
    want = [want_s.observe(d) for d in durs]
    assert got == want
    assert sum(v is not None for v in got) > 0
    for host, scale in ((0, 1.0), (1, 1.0), (2, 2.0)):
        for d in durs[:40]:
            got_s.observe_host_step(host, d * scale)
            want_s.observe_host_step(host, d * scale)
    assert got_s.straggler_report() == want_s.straggler_report() != []
    assert got_s.stall(3.0, 2.0) == want_s.stall(3.0, 2.0)


# ---------------------------------------------------------------------------
# Goodput
# ---------------------------------------------------------------------------


def _goodput_stream(seed):
    rng = np.random.default_rng(seed)
    names = ["pipeline.train_step", "checkpoint.save_state", "dataloader.next_batch",
             "resilience.final_checkpoint", "optimizer.step"]
    t, out = 100.0, []
    for _ in range(60):
        t += float(rng.uniform(0.05, 1.0))
        kind = rng.integers(0, 4)
        if kind == 0:
            out.append({"kind": "compile", "t": t, "dur_ms": float(rng.uniform(1, 300))})
        elif kind == 1 and rng.random() < 0.2:
            out.append({"kind": "event", "name": "health.skip", "t": t})
        else:
            out.append({"kind": "span", "name": names[int(rng.integers(0, len(names)))],
                        "t": t, "dur_ms": float(rng.uniform(10, 800))})
    out.append({"kind": "event", "name": "resilience.preempt_signal", "t": t - 2.0})
    return out, t + 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_goodput_category_seconds_equal_jax(seed):
    records, end = _goodput_stream(seed)
    got, want = tgoodput.GoodputLedger(start_t=100.0), jgoodput.GoodputLedger(start_t=100.0)
    for rec in records:
        got.observe_record(dict(rec))
        want.observe_record(dict(rec))
    assert got.summary(now=end) == want.summary(now=end)
    assert (tgoodput.summary_from_records(records) == jgoodput.summary_from_records(records))


# ---------------------------------------------------------------------------
# Memory ledger
# ---------------------------------------------------------------------------


def _trees(seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    shapes = [tuple(int(x) for x in rng.integers(1, 9, size=rng.integers(1, 4)))
              for _ in range(6)]
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jtree = {"a": [jnp.asarray(a) for a in arrays[:3]], "b": {"c": jnp.asarray(arrays[3])},
             "d": (jnp.asarray(arrays[4]), jnp.asarray(arrays[5]).astype(jnp.bfloat16))}
    ttree = {"a": [torch.from_numpy(a.copy()) for a in arrays[:3]],
             "b": {"c": torch.from_numpy(arrays[3].copy())},
             "d": (torch.from_numpy(arrays[4].copy()),
                   torch.from_numpy(arrays[5].copy()).to(torch.bfloat16))}
    return jtree, ttree


def _stats(in_use, limit):
    return {"bytes_in_use": in_use, "peak_bytes_in_use": in_use + 7, "bytes_limit": limit}


@pytest.mark.parametrize("seed", [0, 1])
def test_memory_ledger_snapshot_equal_jax(seed):
    jtree, ttree = _trees(seed)
    got, want = tmem.MemoryLedger(), jmem.MemoryLedger()
    for led, tree in ((got, ttree), (want, jtree)):
        led.register("train.params", tree=tree, detail={"zero_active": False})
        # Explicit per-device bytes: ``nbytes=`` charges every local device,
        # 8 on the suite's JAX CPU mesh and 1 in the port.
        led.register("serving.kv_pool", per_device={0: 4096})
        led.register("serving.prefix_cache", per_device={0: 1024}, subset_of="serving.kv_pool")
        led.note_program_bytes("step", 512)
    assert got.owners()[0].per_device == {0: want.owners()[0].per_device[0]}
    # The stats provider sees a device index in the port and a device
    # object in JAX; both return the same numbers for device 0.
    got_rec = got.reconcile(stats_fn=lambda d: _stats(1 << 20, 1 << 24) if d == 0 else None)
    want_rec = want.reconcile(stats_fn=lambda d: _stats(1 << 20, 1 << 24) if d.id == 0 else None)
    assert {k: v for k, v in got_rec[0].items() if k != "platform"} == \
        {k: v for k, v in want_rec[0].items() if k != "platform"}
    g, w = got.snapshot(), want.snapshot()
    for key in ("owners", "attributed_bytes_per_device", "attributed_bytes", "host_bytes",
                "program_estimate_bytes", "programs", "oom_postmortems"):
        assert g[key] == w[key], key
    greg, wreg = tt.MetricsRegistry(), jt.MetricsRegistry()
    got.publish(greg)
    want.publish(wreg)
    assert greg.snapshot() == wreg.snapshot()
    gp = got.note_oom("find_executable_batch_size", RuntimeError("CUDA out of memory"))
    wp = want.note_oom("find_executable_batch_size", RuntimeError("CUDA out of memory"))
    for key in ("blame", "blame_bytes", "attributed_bytes", "ranked", "error"):
        assert gp[key] == wp[key], key


def test_tree_bytes_count_each_storage_once_and_walk_modules_and_optimizers():
    base = torch.zeros(64, 32)
    tree = {"w": base, "view": base[:8], "t": base.t(), "other": torch.ones(3, dtype=torch.int64)}
    per_device, host, n = tmem.tree_device_bytes(tree)
    assert (per_device, host, n) == ({0: 64 * 32 * 4 + 3 * 8}, 0, 4)
    model = torch.nn.Linear(5, 3)
    opt = torch.optim.AdamW(model.parameters())
    model(torch.ones(2, 5)).sum().backward()
    opt.step()
    assert tmem.tree_device_bytes(model)[0] == {0: (5 * 3 + 3) * 4}
    # AdamW: exp_avg and exp_avg_sq per parameter, and a scalar step each.
    assert tmem.tree_device_bytes(opt)[0] == {0: 2 * (5 * 3 + 3) * 4 + 2 * 4}


def test_reconcile_on_cpu_reports_stats_absent():
    led = tmem.MemoryLedger()
    led.register("x", nbytes=100)
    (rec,) = led.reconcile()
    assert rec == {"device": 0, "platform": "cpu", "attributed_bytes": 100,
                   "program_estimate_bytes": 0, "stats_available": 0}
    assert led.min_device_headroom() is None


def test_collect_hbm_on_cpu_publishes_availability_zero_only():
    reg = tt.MetricsRegistry()
    assert tt.collect_hbm(reg) == {}
    assert reg.snapshot() == {"hbm.stats_available": 0.0}
    jreg = jt.MetricsRegistry()
    jt.collect_hbm(jreg)
    assert jreg.snapshot() == reg.snapshot()


def test_collect_hbm_reads_the_allocator(monkeypatch):
    stats = {0: {"allocated_bytes.all.current": 100, "allocated_bytes.all.peak": 900,
                 "reserved_bytes.all.current": 2000},
             1: {"allocated_bytes.all.current": 300, "allocated_bytes.all.peak": 400,
                 "reserved_bytes.all.current": 500}}
    free = {0: 10_000, 1: 50}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: stats[d])
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (free[d], 1 << 40))
    reg = tt.MetricsRegistry()
    out = tt.collect_hbm(reg)
    # limit = free + reserved; headroom = limit - allocated, fleet min.
    assert out == {"hbm.stats_available": 1, "hbm.bytes_in_use": 300, "hbm.peak_bytes": 900,
                   "hbm.fleet_min_headroom_bytes": min(10_000 + 2000 - 100, 50 + 500 - 300)}
    led = tmem.MemoryLedger()
    led.register("pool", per_device={0: 60, 1: 60})
    recs = led.reconcile()
    assert [r["unattributed_bytes"] + r["attributed_bytes"] for r in recs] == [100, 300]
    assert led.min_device_headroom() == 250


# ---------------------------------------------------------------------------
# report, both ways
# ---------------------------------------------------------------------------


def _drive(pkg, run_dir):
    tel = pkg.enable(dir=str(run_dir))
    tel.step_timer.configure(tokens_per_step=64)
    with pkg.span("accelerator.prepare"):
        pass
    for _ in range(3):
        with pkg.span("pipeline.train_step"):
            with pkg.span("dataloader.next_batch"):
                pass
        tel.count_dispatch()
        tel.record_step()
    tel.write({"kind": "compile", "dur_ms": 12.5})
    tel.event("checkpoint.publish", step=3, path="x")
    pkg.disable()


def _stable(summary):
    """Drop what differs between two runs by construction: wall-clock
    durations and timestamps."""
    out = json.loads(json.dumps(summary, default=str))
    for span in out["spans"].values():
        span.pop("total_ms")
        span.pop("max_ms")
    out.pop("toplevel_ms")
    out.pop("goodput")
    out["snapshot"] = {k: v for k, v in out["snapshot"].items()
                       if not k.startswith(("span.", "step.time_ms", "step.tokens_per_sec"))}
    return out


def test_report_summarize_equal_jax_and_reads_both_ways(tmp_path, capsys):
    _drive(tt, tmp_path / "port")
    _drive(jt, tmp_path / "jax")
    for run in ("port", "jax"):
        # One record stream, two summarizers: equal in full.
        records = treport.load_records(str(tmp_path / run))
        assert records == jreport.load_records(str(tmp_path / run))
        assert treport.summarize(records) == jreport.summarize(records)
        assert treport.format_report(treport.summarize(records)) == \
            jreport.format_report(jreport.summarize(records))
    # Two runs of the same drive: equal but for their clocks.
    assert _stable(treport.summarize(treport.load_records(str(tmp_path / "port")))) == \
        _stable(jreport.summarize(jreport.load_records(str(tmp_path / "jax"))))
    assert jreport.main([str(tmp_path / "port")]) == 0
    assert treport.main([str(tmp_path / "jax")]) == 0
    out = capsys.readouterr().out
    assert out.count("compiles: 1 (12.5 ms total)") == 2


# ---------------------------------------------------------------------------
# profile_scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [{}, {"assume_no_overlap": True}, {"top_k": 2}],
                         ids=["default", "no_overlap", "top2"])
def test_profile_scan_on_the_jax_fixture_equals_jax(kwargs):
    got = tscan.analyze_trace_dir(str(JAX_FIXTURE), **kwargs).to_dict()
    want = jscan.analyze_trace_dir(str(JAX_FIXTURE), **kwargs).to_dict()
    assert got == want
    assert tscan.digest(tscan.report_from_dict(got)) == jscan.digest(jscan.report_from_dict(want))
    assert tscan.format_profile_report(tscan.report_from_dict(got)) == \
        jscan.format_profile_report(jscan.report_from_dict(want))


def test_torch_trace_classification():
    assert timeline.classify_op("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(x)") == "collective"
    assert timeline.classify_op("Memcpy HtoD (Pinned -> Device)") == "infeed"
    for name in ("void flash_fwd_sm90_kernel<__nv_bfloat16, 128, true>(FwdParams)",
                 "paged_split_kernel", "sm90_xmma_gemm_bf16bf16", "Memcpy DtoD (Device -> Device)"):
        assert timeline.classify_op(name) == "compute"
    # The JAX opcodes keep their buckets.
    for name, bucket in (("all-gather-start.3", "collective"), ("infeed.1", "infeed"),
                         ("wide_fusion.1", "compute")):
        assert timeline.classify_op(name) == bucket


def test_profiler_window_writes_a_trace_profile_scan_reads(tmp_path, monkeypatch):
    """The sentinel's window on the CPU: ``torch.profiler`` over three steps,
    its Chrome trace under ``anomaly_trace/``, the digest in the ring, the
    step spans as markers."""
    monkeypatch.setenv("ACCELERATE_TPU_SENTINEL_PROFILE", "1")
    rec = tflightrec.enable(dir=str(tmp_path), sentinel=tt.AnomalySentinel(warmup=2, window=8))
    tel = tt.get_telemetry()
    x = torch.ones(64, 64)
    for step in range(8):
        with tt.span("optimizer.step"):
            (x @ x).sum()
        tel.record_step()
        if step == 3:
            rec._maybe_start_profile(step + 1)  # what an anomaly does
    rec._join_analysis(timeout=30.0)
    traces = list((tmp_path / "anomaly_trace").glob("*.pt.trace.json.gz"))
    assert len(traces) == 1
    # A CPU trace holds no device work (the scan then reports none), but its
    # three step spans are the step markers.
    report = tscan.analyze_trace_dir(str(tmp_path / "anomaly_trace"))
    assert report.n_raw_events > 0 and report.n_device_events == 0
    tl = timeline.build_timeline(timeline.load_trace_events(str(traces[0])))
    marker, windows = tscan._step_windows(tl)
    assert marker == "optimizer.step" and len(windows) == 3
    names = [r.get("name") for r in rec.snapshot()]
    assert "sentinel.profile_captured" in names and "sentinel.profile_digest" in names
    assert [r["step"] for r in rec.snapshot() if r["kind"] == "step"] == list(range(1, 9))


def test_flight_recorder_restores_handlers_and_excepthook(tmp_path):
    before = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT), sys.excepthook)
    tflightrec.enable(dir=str(tmp_path))
    assert signal.getsignal(signal.SIGTERM) != before[0]
    tflightrec.disable()
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT),
            sys.excepthook) == before


# ---------------------------------------------------------------------------
# The port's own touch points
# ---------------------------------------------------------------------------


def test_kernel_builds_are_compiles_and_loads_cache_hits(tmp_path):
    tel = tt.enable(dir=str(tmp_path))
    watcher = tt.CompileWatcher()
    tmetrics.note_compile_event(tmetrics.COMPILE_EVENT, 2.5)
    tmetrics.note_compile_event(tmetrics.CACHE_HIT_EVENT)
    tmetrics.note_compile_event("something_else", 1.0)
    watcher.stop()
    tmetrics.note_compile_event(tmetrics.COMPILE_EVENT, 1.0)
    assert (watcher.count, watcher.total_ms, watcher.cache_hits) == (1, 2500.0, 1)
    snap = tel.registry.snapshot()
    assert snap["jit.compiles"] == 2 and snap["jit.cache_hits"] == 1
    assert snap["jit.compile_ms.count"] == 2 and snap["jit.compile_ms.max"] == 2500.0
    tt.disable()
    records = treport.load_records(str(tmp_path))
    assert [r["dur_ms"] for r in records if r["kind"] == "compile"] == [2500.0, 1000.0]


def test_step_timer_mfu_uses_the_card_peak(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tt.peak_flops_per_chip() == 989e12
    reg = tt.MetricsRegistry()
    timer = tt.StepTimer(reg)
    timer.configure(tokens_per_step=4096, flops_per_step=989e12 * 0.1)
    clock = iter([10.0, 10.25])
    monkeypatch.setattr(tmetrics.time, "perf_counter", lambda: next(clock))
    assert timer.step() is None
    assert timer.step() == 0.25
    snap = reg.snapshot()
    assert snap["step.mfu"] == pytest.approx(0.4, rel=1e-12)
    assert snap["step.tokens_per_sec"] == 4096 / 0.25


def test_env_unset_writes_no_file(tmp_path, monkeypatch):
    monkeypatch.delenv("ACCELERATE_TPU_TELEMETRY", raising=False)
    monkeypatch.delenv("ACCELERATE_TPU_FLIGHTREC", raising=False)
    monkeypatch.chdir(tmp_path)
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.state import AcceleratorState

    AcceleratorState._reset_state(reset_partial_state=True)
    try:
        acc = Accelerator(cpu=True)
        model = torch.nn.Linear(4, 2)
        model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1))
        acc.backward(model(torch.ones(3, 4)).sum())
        opt.step()
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
    assert not tt.enabled()
    assert list(tmp_path.iterdir()) == []


def test_env_flag_enables_through_the_accelerator(tmp_path, monkeypatch):
    monkeypatch.setenv("ACCELERATE_TPU_TELEMETRY", "1")
    monkeypatch.setenv("ACCELERATE_TPU_TELEMETRY_DIR", str(tmp_path / "tel"))
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.state import AcceleratorState

    AcceleratorState._reset_state(reset_partial_state=True)
    try:
        Accelerator(cpu=True)
        assert tt.enabled()
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
    tt.disable()
    assert (tmp_path / "tel" / "telemetry_p0.jsonl").exists()


def test_trace_dir_falls_back_to_the_run_directory(tmp_path, monkeypatch):
    from accelerate_tpu.serving import tracing as jtracing
    from accelerate_tpu_torch.serving import tracing

    monkeypatch.delenv(tracing.ENV_DIR, raising=False)
    assert tracing.resolve_trace_dir() is None
    tt.enable(dir=str(tmp_path / "t"))
    jt.enable(dir=str(tmp_path / "j"))
    assert tracing.resolve_trace_dir() == str(tmp_path / "t")
    assert jtracing.resolve_trace_dir() == str(tmp_path / "j")
    assert tracing.resolve_trace_dir("explicit") == "explicit"


_EMIT = re.compile(
    r"""(?:counter|gauge|histogram|peek)\(\s*f?["']([^"']+)["']"""
    r"""|\.event\(\s*f?["']([^"']+)["']""")


def test_port_emit_sites_are_registered_names():
    """Every metric and event name the port emits is in the registry the two
    packages share (``names.py``), or fits one of its dynamic patterns."""
    emitted = set()
    for path in (REPO / "accelerate_tpu_torch").rglob("*.py"):
        for m in _EMIT.finditer(path.read_text()):
            emitted.add(m.group(1) or m.group(2))
    assert len(emitted) > 60
    unknown = sorted(n for n in emitted
                     if n not in tnames.all_names() and not tnames.matches_dynamic(n))
    assert unknown == []
    from accelerate_tpu.telemetry import names as jnames

    assert tnames.all_names() == jnames.all_names()


def test_report_cli_runs_as_a_module(tmp_path):
    _drive(tt, tmp_path / "run")
    proc = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.telemetry.report",
                           str(tmp_path / "run"), "--json"], cwd=REPO, capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["telemetry"]["spans"]["pipeline.train_step"]["count"] == 3


def test_watchdog_stall_is_recorded_and_mirrored_into_the_recorder(tmp_path):
    tel = tt.enable(dir=str(tmp_path))
    rec = tflightrec.enable(dir=str(tmp_path))
    dog = tt.StallWatchdog(0.05, telemetry=tel, poll_s=0.01)
    dog.start()
    try:
        import time

        deadline = time.monotonic() + 10.0
        while dog.stall_count == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.2)
        assert dog.stall_count == 1  # one warning per episode, however long
    finally:
        dog.stop()
    assert tel.registry.snapshot()["stall.count"] == 1
    anomalies = [r for r in rec.snapshot() if r["kind"] == "anomaly"]
    assert [a["reason"] for a in anomalies] == ["stall"]
    tt.disable()
    stalls = [r for r in treport.load_records(str(tmp_path)) if r["kind"] == "stall"]
    assert len(stalls) == 1 and "test_torch_telemetry" in stalls[0]["threads"]


def test_metrics_endpoint_on_loopback(tmp_path, monkeypatch):
    """``ACCELERATE_TPU_METRICS_PORT=0``: the endpoint binds 127.0.0.1 at an
    ephemeral port with telemetry and stops with it; ``/metrics`` is the
    registry's Prometheus text, ``/debug/requests`` the registered engines'
    snapshots, ``/debug/memory`` the ledger, anything else 404s."""
    import gc
    import urllib.error
    import urllib.request

    monkeypatch.setenv("ACCELERATE_TPU_METRICS_PORT", "0")
    tel = tt.enable(dir=str(tmp_path))
    exporter = texport.get_exporter()
    assert exporter is not None and exporter.running and exporter.port

    class Engine:
        def debug_requests(self):
            return [{"id": 3, "state": "DECODING"}]

        def debug_blocks(self):
            return {"capacity": 8, "used": 2}

    engine = Engine()
    texport.register_debug_source(engine)
    tel.registry.counter("serving.completed").inc(5)
    tt.get_memory_ledger().register("serving.kv_pool", per_device={0: 4096})
    base = f"http://127.0.0.1:{exporter.port}"
    body = urllib.request.urlopen(f"{base}/metrics", timeout=10).read().decode()
    assert body == texport.render_prometheus(tel.registry)
    assert "accelerate_tpu_serving_completed_total 5" in body
    reqs = json.loads(urllib.request.urlopen(f"{base}/debug/requests", timeout=10).read())
    assert reqs["engines"] == [[{"id": 3, "state": "DECODING"}]]
    memory = json.loads(urllib.request.urlopen(f"{base}/debug/memory", timeout=10).read())
    assert memory["owners"][0]["owner"] == "serving.kv_pool"
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"{base}/other", timeout=10)
    assert err.value.code == 404
    del engine
    gc.collect()
    reqs = json.loads(urllib.request.urlopen(f"{base}/debug/requests", timeout=10).read())
    assert reqs["engines"] == []
    tt.disable()
    assert not exporter.running


def test_fleet_aggregator_at_one_process_is_the_hosts_own(tmp_path):
    """At one process the aggregator gathers through the port's
    ``gather_object`` (the host's own payload) and reports as the JAX
    aggregator does with an identity gather."""
    from accelerate_tpu.telemetry.goodput import FleetAggregator as JFleet

    got_tel = tt.enable(dir=str(tmp_path / "t"))
    want_tel = jt.enable(dir=str(tmp_path / "j"))
    got = tgoodput.FleetAggregator(sentinel=tt.AnomalySentinel(window=8, warmup=2), every=4)
    want = JFleet(sentinel=jt.AnomalySentinel(window=8, warmup=2), every=4,
                  gather_fn=lambda payloads: list(payloads), host=0)
    durs = _series(5, n=12)
    got_r = [got.on_step(d, telemetry=got_tel) for d in durs]
    want_r = [want.on_step(d, telemetry=want_tel) for d in durs]
    assert got_r == want_r and got_r[3] == {"hosts": 1, "fleet_fraction": None,
                                            "stragglers": []}
    keys = ("goodput.fleet_hosts", "goodput.straggler_count")
    assert {k: got_tel.registry.snapshot()[k] for k in keys} == \
        {k: want_tel.registry.snapshot()[k] for k in keys}
