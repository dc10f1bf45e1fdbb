"""Goodput-accounting smoke: ``python -m accelerate_tpu_torch.telemetry.goodput_smoke``
(on the card; ``--device cpu`` on the CPU).

The one-process arm of the JAX package's ``telemetry/goodput_smoke.py``: a
short run of a recipe of :mod:`..resilience.smoke` (``--size tiny``, the
default, or ``--size llama3-8b``: Llama-3-8B's widths cut to one layer, the
flash kernels in every step, a 15.2 GB checkpoint) with every badput source
injected in one process, then four proofs:

1. **conservation** — the ledger's categories sum to the elapsed wall-clock
   window within ``EPS_S``, every category is non-negative, and the
   attributed (non-background) time never exceeds the window;
2. **fault attribution** — each injected fault class lands in its category:
   the NaN-poisoned step (health gate skips it) → ``rewind_replay``, the
   torn checkpoint write (I/O retry) → ``checkpoint``, the synthetic OOM
   (retry-exhausted acquisition) and the OOM batch-size halving →
   ``device_acquire``, the SIGTERM (preemption + final checkpoint) →
   ``preempt``; productive and checkpoint wall time is attributed too (the
   port has no tracing compiler: ``compile`` holds only kernel builds,
   none here);
3. **export** — the Prometheus endpoint (127.0.0.1, an ephemeral port)
   scrapes once with valid text exposition, the atomic snapshot file
   parses identically, and the offline ``telemetry.report`` path
   reproduces the ``goodput`` summary's markers from the JSONL alone;
4. **watchdog** — with ``ACCELERATE_TPU_STALL_TIMEOUT_S`` armed, steps that
   beat in time leave ``stall.count`` at 0, and a stall injected past the
   deadline fires it once.

At ``llama3-8b`` the run saves once before the SIGTERM's checkpoint (at
step 5, the torn write's), not twice as the tiny run does (steps 2 and 5):
each 15 GB save costs tens of seconds.  ``--out`` writes the summary, the
flash launches and the number of steps as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time
import urllib.request
from typing import Optional

NAN_STEP = 3
SIGTERM_STEP = 7
TOTAL_STEPS = 9
EPS_S = 1e-6
STALL_TIMEOUT_S = 0.5
STALL_STEPS = 6
SAVE_STEPS = {"tiny": (2, 5), "llama3-8b": (5,)}


def _parse_exposition(text: str) -> dict:
    """Minimal exposition-format validator: every line is a comment or a
    ``name{labels} value`` sample; returns {sample_name_with_labels: value}.
    Raises on any malformed line."""
    samples = {}
    line_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})?\s+"
        r"([-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|[+-]Inf|NaN)$"
    )
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = line_re.match(line)
        assert m, f"malformed exposition line: {line!r}"
        samples[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    assert samples, "exposition body carried no samples"
    return samples


def _batches(dl):
    """The loader's batches, epoch after epoch."""
    while True:
        yield from dl


def run(device: Optional[str] = None, size: str = "tiny",
        workdir: Optional[str] = None) -> dict:
    """Every fault injected and every proof; returns a summary.  ``device``
    ``None`` is the card (raising without CUDA); ``"cpu"`` asks for the
    CPU.  Checkpoints and telemetry go under ``workdir`` (a fresh temporary
    directory by default)."""
    from ..state import resolve_device

    device = str(resolve_device(device))
    save_steps = SAVE_STEPS[size]
    os.environ.setdefault("ACCELERATE_TPU_CHECKPOINT_FSYNC", "0")
    os.environ["ACCELERATE_TPU_SENTINEL_PROFILE"] = "0"
    os.environ["ACCELERATE_TPU_IO_RETRIES"] = "3"
    os.environ["ACCELERATE_TPU_IO_RETRY_BASE_S"] = "0.02"
    # Arm the NaN poison and the SIGTERM before the step is built.
    os.environ["ACCELERATE_TPU_FAULT_NAN_STEP"] = str(NAN_STEP)
    os.environ["ACCELERATE_TPU_FAULT_SIGTERM_STEP"] = str(SIGTERM_STEP)

    from .. import telemetry
    from ..resilience import faultinject
    from ..resilience.smoke import build, flash_launches
    from ..utils.memory import find_executable_batch_size
    from . import export, goodput
    from .report import load_records, summarize

    faultinject.reload()
    work = workdir or tempfile.mkdtemp(prefix="atpu_goodput_smoke_")
    os.makedirs(work, exist_ok=True)
    tel = telemetry.enable(dir=work)
    ledger = goodput.attach()
    snapshot_path = os.path.join(work, "metrics.prom")
    exporter = export.MetricsExporter()
    exporter.start(port=0, snapshot_path=snapshot_path, snapshot_every_s=30.0)

    acc, model, opt, dl = build(size, device, project_dir=os.path.join(work, "ckpts"))
    acc.enable_preemption_handling()
    acc.enable_health_guard(optimizer=opt, max_skips=TOTAL_STEPS)
    step_fn = acc.make_train_step(model, opt, clip_norm=0.05)

    losses = []
    skipped = []
    preempted_at = None
    save_s = []
    steps_run = 0
    batches = _batches(dl)
    for i in range(TOTAL_STEPS):
        step = i + 1
        if step == 5:
            # Torn write: the NEXT checkpoint write fails once (transient),
            # the I/O retry policy absorbs it — checkpoint-category badput.
            os.environ["ACCELERATE_TPU_FAULT_WRITE_N"] = "1"
            faultinject.reload()
        losses.append(float(step_fn(next(batches))))
        steps_run += 1
        if acc.check_health(step=step).skipped:
            skipped.append(step)
        if step in save_steps:
            t0 = time.perf_counter()
            acc.save_state(step=step)
            save_s.append(round(time.perf_counter() - t0, 3))
        t0 = time.perf_counter()
        if acc.check_preemption(step=step):
            save_s.append(round(time.perf_counter() - t0, 3))
            preempted_at = step
            break
    os.environ.pop("ACCELERATE_TPU_FAULT_WRITE_N", None)
    retries = tel.registry.counter("resilience.retries").value

    # Synthetic OOM through the retry machinery (re-armed per attempt, so the
    # policy exhausts its tries): a device-acquisition fight, ledgered.
    oom_seen = False
    try:
        faultinject.synthetic_oom_acquire("smoke.device_acquire")
    except RuntimeError as e:
        assert "out of memory" in str(e), e
        oom_seen = True

    # An OOM batch-size halving: the first attempt's synthetic OOM halves 2 -> 1.
    os.environ[faultinject.ENV_OOM_ONCE] = "1"
    faultinject.reload()
    tried = []

    @find_executable_batch_size(starting_batch_size=2)
    def probe(batch_size):
        tried.append(batch_size)
        faultinject.maybe_oom()
        return batch_size

    try:
        landed = probe()
    finally:
        os.environ.pop(faultinject.ENV_OOM_ONCE, None)
        faultinject.reload()

    assert skipped == [NAN_STEP], f"health gate skipped {skipped}, expected [{NAN_STEP}]"
    assert preempted_at == SIGTERM_STEP, f"preempted at {preempted_at}, expected {SIGTERM_STEP}"
    assert retries == 1, f"the torn write was retried {retries} times, want 1"
    assert oom_seen, "synthetic OOM never surfaced"
    assert landed == 1 and tried == [2, 1], (landed, tried)

    # -- proof 1: conservation ------------------------------------------------
    summary = ledger.summary()
    seconds = summary["seconds"]
    assert abs(summary["conservation_error_s"]) < EPS_S, summary
    assert all(v >= 0.0 for v in seconds.values()), seconds
    assert summary["attributed_s"] <= summary["elapsed_s"] + EPS_S, summary
    assert seconds["productive"] > 0.0, seconds
    assert seconds["checkpoint"] > 0.0, seconds
    assert seconds["rewind_replay"] > 0.0, seconds  # the skipped step's compute

    # -- proof 2: fault attribution ------------------------------------------
    markers = summary["markers"]
    for fault, category in (
        ("nan/health-skip", "rewind_replay"),
        ("torn-write retry", "checkpoint"),
        ("oom acquire + halving", "device_acquire"),
        ("sigterm", "preempt"),
    ):
        assert markers.get(category, 0) >= 1, (
            f"{fault} left no {category!r} marker: {markers}"
        )
    # The acquire fight (a retry and a give-up) and the halving: 3 markers.
    assert markers["device_acquire"] >= 3, markers

    # -- proof 3: export ------------------------------------------------------
    url = f"http://127.0.0.1:{exporter.port}/metrics"
    body = urllib.request.urlopen(url, timeout=10).read().decode()
    samples = _parse_exposition(body)
    assert "accelerate_tpu_goodput_fraction" in samples, sorted(samples)[:20]
    for name in goodput.CATEGORIES:
        assert f"accelerate_tpu_goodput_{name}_s" in samples, name
    # Histogram triplet consistency on the step-time family.
    stem = "accelerate_tpu_step_time_ms"
    assert samples[f'{stem}_bucket{{le="+Inf"}}'] == samples[f"{stem}_count"]
    assert f"{stem}_sum" in samples
    exporter.stop()  # writes the final snapshot
    with open(snapshot_path) as f:
        snap_samples = _parse_exposition(f.read())
    assert "accelerate_tpu_goodput_fraction" in snap_samples

    telemetry.disable()
    goodput.detach()

    # Offline replay: the report path recomputes the same ledger from JSONL.
    offline = summarize(load_records(work))["goodput"]
    assert offline is not None and abs(offline["conservation_error_s"]) < EPS_S
    for category in ("rewind_replay", "checkpoint", "device_acquire", "preempt"):
        assert offline["markers"].get(category, 0) >= 1, (category, offline["markers"])

    # -- proof 4: the stall watchdog -----------------------------------------
    quiet, fired = _watchdog(step_fn, batches, os.path.join(work, "watchdog"))
    steps_run += STALL_STEPS
    assert quiet == 0, f"the watchdog fired {quiet} times on steps that beat in time"
    assert fired == 1, f"an injected stall fired the watchdog {fired} times, want 1"

    print(
        "goodput-smoke OK — "
        f"elapsed {summary['elapsed_s']:.2f}s, "
        f"productive {100 * summary['goodput_fraction']:.1f}%, "
        f"checkpoint {seconds['checkpoint']:.2f}s, "
        f"rewind-replay {seconds['rewind_replay']:.2f}s, "
        f"device-acquire {seconds['device_acquire']:.2f}s, "
        f"conservation error {summary['conservation_error_s']:.2e}s; "
        f"faults attributed: nan->rewind_replay, torn-write->checkpoint, "
        f"oom->device_acquire, sigterm->preempt; "
        f"endpoint scraped {len(samples)} samples, snapshot parsed; "
        f"watchdog quiet over {STALL_STEPS} steps, fired once on a "
        f"{2 * STALL_TIMEOUT_S:.1f} s stall"
    )
    return {"summary": summary, "markers": markers, "retries": retries,
            "skipped": skipped, "preempted_at": preempted_at, "save_s": save_s,
            "steps": steps_run, "launches": flash_launches(),
            "watchdog": {"quiet": quiet, "fired": fired, "timeout_s": STALL_TIMEOUT_S}}


def _watchdog(step_fn, batches, tel_dir):
    """``(stalls over STALL_STEPS timely steps, stalls after one injected
    stall)`` with ``ACCELERATE_TPU_STALL_TIMEOUT_S`` at ``STALL_TIMEOUT_S``."""
    from .. import telemetry

    os.environ["ACCELERATE_TPU_STALL_TIMEOUT_S"] = str(STALL_TIMEOUT_S)
    try:
        tel = telemetry.enable(dir=tel_dir)
    finally:
        os.environ.pop("ACCELERATE_TPU_STALL_TIMEOUT_S", None)
    stalls = tel.registry.counter("stall.count")
    try:
        for _ in range(STALL_STEPS):
            float(step_fn(next(batches)))  # each step beats the watchdog
        quiet = stalls.value
        time.sleep(2 * STALL_TIMEOUT_S + 0.5)  # the injected stall: no beat
        fired = stalls.value - quiet
    finally:
        telemetry.disable()
    return quiet, fired


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.telemetry.goodput_smoke")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("--size", choices=tuple(SAVE_STEPS), default="tiny")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--out", default=None, help="write the summary here as JSON")
    args = parser.parse_args(argv)
    result = run(args.device, args.size, args.workdir)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
