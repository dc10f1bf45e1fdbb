"""The port's smoke modules at their CPU size, each in its own subprocess:
the preemption smoke with its retry arms (``resilience/smoke.py``: bit-exact
losses after a SIGTERM and a resume, one retried write, one torn save), the
health smoke (``resilience/health_smoke.py``: a skip with identical
parameters and unchanged step work, a rewind replayed bit-exact against a
clean resume), the goodput smoke (``telemetry/goodput_smoke.py``:
conservation within 1e-6 s, each injected fault in its category, the
watchdog) and the memory-ledger smoke, and the serving and speculative
smokes' one-process arms, each asked for the CPU with ``--device cpu``.
The asserts are the smokes' own (the JAX package's); each must exit 0.  The
subprocesses start together, so the file costs about its slowest smoke.
The serving and speculative smokes' data-parallel arms run beside them on
2 gloo ranks (``--mesh --world 2 --device cpu``: every assertion on every
rank, every rank's tokens equal to rank 0's), the memory-ledger smoke's on
2 ranks in the test's process (``run(device="cpu", devices=2)``: each rank
charged JAX's per-device bytes), and every smoke's default device is the
card: without CUDA it raises."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
SMOKES = {
    "preemption": ["accelerate_tpu_torch.resilience.smoke", "--device", "cpu"],
    "health": ["accelerate_tpu_torch.resilience.health_smoke", "--device", "cpu"],
    "goodput": ["accelerate_tpu_torch.telemetry.goodput_smoke", "--device", "cpu"],
    "memledger": ["accelerate_tpu_torch.telemetry.memledger_smoke", "--device", "cpu"],
    "serving": ["accelerate_tpu_torch.serving.smoke", "--device", "cpu"],
    "spec": ["accelerate_tpu_torch.serving.spec_smoke", "--device", "cpu"],
}
VERDICTS = {"preemption": "resilience-smoke OK", "health": "health-smoke OK",
            "goodput": "goodput-smoke OK", "memledger": "memledger-smoke OK",
            "serving": "serving smoke OK", "spec": "spec smoke OK"}
MESH_ARMS = {f"{module}:mesh": [module, "--mesh", "--world", "2", "--device", "cpu"]
             for module in ("accelerate_tpu_torch.serving.smoke",
                            "accelerate_tpu_torch.serving.spec_smoke")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every smoke started at once; each test waits for its own."""
    env = dict(os.environ, ACCELERATE_TPU_CHECKPOINT_FSYNC="0",
               ACCELERATE_TPU_SENTINEL_PROFILE="0", OMP_NUM_THREADS="2",
               TMPDIR=str(tmp_path_factory.mktemp("smokes")))
    for key in [k for k in env if k.startswith(("ACCELERATE_TPU_FAULT_", "ACCELERATE_TPU_TELEMETRY"))]:
        env.pop(key)
    procs = {name: subprocess.Popen([sys.executable, "-m", *cmd], cwd=REPO, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, cmd in {**SMOKES, **MESH_ARMS}.items()}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("name", list(SMOKES))
def test_smoke_passes(runs, name):
    out, err = runs[name].communicate(timeout=600)
    assert runs[name].returncode == 0, f"{name} smoke failed:\n{out[-3000:]}\n{err[-5000:]}"
    assert VERDICTS[name] in out


@pytest.mark.parametrize("module", ["accelerate_tpu_torch.serving.smoke",
                                    "accelerate_tpu_torch.serving.spec_smoke"])
def test_mesh_arms_name_roadmap_a6(runs, module):
    """The data-parallel arm on 2 gloo ranks passes: every rank's
    assertions held and every rank's tokens equal rank 0's."""
    proc = runs[f"{module}:mesh"]
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"{module} --mesh failed:\n{out[-3000:]}\n{err[-5000:]}"
    assert "2 ranks on dp=2 (cpu), every assertion held on every rank" in out
    assert ("spec smoke OK" if "spec" in module else "serving smoke OK") in out


@pytest.mark.parametrize("module,entry,args", [
    ("accelerate_tpu_torch.resilience.smoke", "run", ()),
    ("accelerate_tpu_torch.resilience.health_smoke", "run", ()),
    ("accelerate_tpu_torch.serving.chaos", "run_serving_campaign", (20260804,)),
    ("accelerate_tpu_torch.serving.chaos", "run_tiering_campaign", (20260804,)),
    ("accelerate_tpu_torch.serving.smoke", "run", ()),
    ("accelerate_tpu_torch.serving.spec_smoke", "run", ()),
    ("accelerate_tpu_torch.serving.trace_smoke", "run", ()),
    ("accelerate_tpu_torch.telemetry.goodput_smoke", "run", ()),
    ("accelerate_tpu_torch.telemetry.memledger_smoke", "run", ()),
])
def test_smoke_default_device_is_the_card(monkeypatch, module, entry, args):
    """Asked for no device, a smoke runs on the card; without CUDA it raises
    before it starts anything."""
    import importlib

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(importlib.import_module(module), entry)(*args)


def test_memledger_mesh_arm_names_roadmap_a6():
    """The mesh arm on 2 gloo ranks: each rank holds its 16 rows of the
    ``dp``-sharded leaf and is charged JAX's per-device bytes (2048 + 256 +
    16384); rank 0 alone runs the forensics."""
    from accelerate_tpu_torch.telemetry import memledger_smoke

    out = memledger_smoke.run(device="cpu", devices=2)
    assert [r["rank"] for r in out["ranks"]] == [0, 1]
    for rec in out["ranks"]:
        assert rec["per_device"] == {"0": 2048 + 256 + 16384}, rec
    assert [r["postmortem"] for r in out["ranks"]] == ["smoke.hog", None]


def test_smoke_retry_retries_once_loudly(tmp_path):
    """One bounded retry, never a loop: a command failing twice gives its
    rc after exactly two attempts, with the stderr line and the
    ``smoke.retried`` event."""
    from accelerate_tpu_torch.telemetry.report import load_records

    env = dict(os.environ, ACCELERATE_TPU_TELEMETRY_DIR=str(tmp_path))
    counter = tmp_path / "attempts"
    script = (f"import pathlib, sys; p = pathlib.Path({str(counter)!r}); "
              "p.write_text(p.read_text() + 'x' if p.exists() else 'x'); sys.exit(3)")
    proc = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.resilience.smoke_retry",
                           "--label", "flaky", "--backoff-s", "0", "--", sys.executable, "-c",
                           script], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 3 and counter.read_text() == "xx"
    assert "[smoke_retry] flaky: attempt 1 failed rc=3; retrying once" in proc.stderr
    assert "FAILED after 2 attempts" in proc.stderr
    events = [r for r in load_records(str(tmp_path)) if r.get("name") == "smoke.retried"]
    assert [(e["label"], e["attempt"], e["rc"]) for e in events] == [("flaky", 1, 3)]
