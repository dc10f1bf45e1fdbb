"""The port's fault injection and I/O retry against the JAX package's.

Every ``ACCELERATE_TPU_FAULT_*`` knob is parsed from the same environment
and driven through the same calls in both packages
(``resilience/faultinject.py``): the firing schedules are equal, exactly.
``RetryPolicy``'s delays under one ``random.seed`` with a fake clock and
sleep, its give-ups and its telemetry counters are equal, exactly
(``resilience/retry.py``).  A torch out-of-memory error is never retried,
and a write fault through ``write_manifest`` / ``save_state`` leaves a torn
save that ``find_latest_complete`` passes over.  No tolerance anywhere."""

import math
import random
import signal

import numpy as np
import pytest
import torch
from torch import nn

from accelerate_tpu import telemetry as jt
from accelerate_tpu.resilience import faultinject as jfi
from accelerate_tpu.resilience import retry as jretry
from accelerate_tpu_torch import Accelerator, AcceleratorState
from accelerate_tpu_torch import telemetry as tt
from accelerate_tpu_torch.resilience import faultinject as tfi
from accelerate_tpu_torch.resilience import retry as tretry
from accelerate_tpu_torch.resilience.manifest import (
    find_latest_complete,
    verify_checkpoint,
    write_manifest,
)
from accelerate_tpu_torch.utils.memory import should_reduce_batch_size

KNOBS = [v for k, v in vars(jfi).items() if k.startswith("ENV_")]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for key in KNOBS:
        monkeypatch.delenv(key, raising=False)
    jfi.reload()
    tfi.reload()
    AcceleratorState._reset_state(reset_partial_state=True)
    yield
    for pkg in (jt, tt):
        pkg.disable()
        pkg.get_telemetry().registry.reset()
    jfi.reload()
    tfi.reload()
    AcceleratorState._reset_state(reset_partial_state=True)


def _arm(monkeypatch, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jfi.reload()
    tfi.reload()


def test_the_knobs_are_the_jax_ones():
    assert sorted(k for k in vars(tfi) if k.startswith("ENV_")) == \
        sorted(k for k in vars(jfi) if k.startswith("ENV_"))
    for key in (k for k in vars(jfi) if k.startswith("ENV_")):
        assert getattr(tfi, key) == getattr(jfi, key)
    assert set(tfi.__all__) == set(jfi.__all__)
    assert issubclass(tfi.InjectedWriteError, OSError)


@pytest.mark.parametrize("env", [
    {}, {"ACCELERATE_TPU_FAULT_WRITE_N": "3"},
    {"ACCELERATE_TPU_FAULT_WRITE_N": "3", "ACCELERATE_TPU_FAULT_WRITE_STICKY": "1"},
    {"ACCELERATE_TPU_FAULT_WRITE_N": "1", "ACCELERATE_TPU_FAULT_WRITE_STICKY": "yes"},
    {"ACCELERATE_TPU_FAULT_WRITE_N": "2", "ACCELERATE_TPU_FAULT_WRITE_STICKY": "0"},
], ids=lambda e: "-".join(f"{k.split('_')[-1]}{v}" for k, v in e.items()) or "unarmed")
def test_write_fault_schedule_equals_jax(monkeypatch, env):
    _arm(monkeypatch, env)

    def schedule(fi):
        out = []
        for i in range(8):
            try:
                fi.maybe_fail_write(f"/ckpt/file{i}")
                out.append(None)
            except OSError as e:
                assert isinstance(e, fi.InjectedWriteError)
                out.append(str(e))
        return out

    assert schedule(tfi) == schedule(jfi)
    assert tfi.armed() == jfi.armed() == bool(env)


@pytest.mark.parametrize("sigterm_step", [None, "1", "3", "9"])
def test_sigterm_tick_schedule_equals_jax(monkeypatch, sigterm_step):
    """Each package's tick sends a real SIGTERM to this process; a handler
    records the ticks at which one arrived."""
    _arm(monkeypatch, {} if sigterm_step is None else
         {"ACCELERATE_TPU_FAULT_SIGTERM_STEP": sigterm_step})
    got = []
    previous = signal.signal(signal.SIGTERM, lambda signum, frame: got.append(signum))
    try:
        fired = {}
        for name, fi in (("jax", jfi), ("port", tfi)):
            fired[name] = []
            for step in (None, 1, 2, 3, 4, 2, 9, 10):
                before = len(got)
                fi.tick(step)
                fired[name].append(len(got) - before)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert fired["port"] == fired["jax"]
    assert sum(fired["port"]) == (0 if sigterm_step is None else 1)


@pytest.mark.parametrize("value", ["1", "true", "on", "0", ""])
def test_oom_once_fires_once_as_a_torch_oom(monkeypatch, value):
    _arm(monkeypatch, {"ACCELERATE_TPU_FAULT_OOM_ONCE": value})

    def schedule(fi):
        out = []
        for _ in range(3):
            try:
                fi.maybe_oom()
                out.append(None)
            except RuntimeError as e:
                out.append(e)
        return out

    port, ref = schedule(tfi), schedule(jfi)
    assert [e is None for e in port] == [e is None for e in ref]
    assert sum(e is not None for e in port) == (1 if value in ("1", "true", "on") else 0)
    for e in port:
        if e is not None:
            # The JAX package's RESOURCE_EXHAUSTED RuntimeError becomes the
            # type the port's find_executable_batch_size halves on.
            assert isinstance(e, torch.OutOfMemoryError) and should_reduce_batch_size(e)


@pytest.mark.parametrize("nan", [("4", None), ("3", "2"), ("1", "3"), (None, "2")])
def test_nan_poison_schedule_equals_jax(monkeypatch, nan):
    step, count = nan
    env = {}
    if step is not None:
        env["ACCELERATE_TPU_FAULT_NAN_STEP"] = step
    if count is not None:
        env["ACCELERATE_TPU_FAULT_NAN_COUNT"] = count
    _arm(monkeypatch, env)

    def schedule(fi):
        # Two passes over steps 1-8: the second is a post-rewind replay.
        return [fi.nan_armed()] + [
            None if (s := fi.grad_poison_scale(k)) is None else math.isnan(s)
            for _ in range(2) for k in range(1, 9)]

    port = schedule(tfi)
    assert port == schedule(jfi)
    assert sum(x is True for x in port[1:]) == (0 if step is None else int(count or 1))


@pytest.mark.parametrize("index", [None, "0", "2"])
def test_bad_batch_schedule_equals_jax(monkeypatch, index):
    _arm(monkeypatch, {} if index is None else {"ACCELERATE_TPU_FAULT_BAD_BATCH": index})
    assert tfi.bad_batch_index() == jfi.bad_batch_index()
    import jax.numpy as jnp

    for epoch in range(2):  # a bad batch stays bad on the next pass
        for i in range(4):
            jb = jfi.maybe_poison_batch({"x": jnp.ones((2, 3)), "ids": jnp.arange(2)}, i)
            tb = tfi.maybe_poison_batch(
                {"x": torch.ones((2, 3)), "ids": torch.arange(2), "pair": (torch.ones(2),)}, i)
            assert bool(torch.isnan(tb["x"]).all()) == bool(jnp.isnan(jb["x"]).all())
            assert not torch.isnan(tb["x"]).any() or bool(torch.isnan(tb["pair"][0]).all())
            assert torch.equal(tb["ids"], torch.arange(2))  # integers are spared
            assert np.array_equal(np.asarray(jb["ids"]), np.arange(2))


@pytest.mark.parametrize("env", [
    {}, {"ACCELERATE_TPU_FAULT_SERVING_NAN_REQUEST": "5"},
    {"ACCELERATE_TPU_FAULT_SERVING_HOST_FULL": "1"},
    {"ACCELERATE_TPU_FAULT_SERVING_HOST_FULL": "off"},
    {"ACCELERATE_TPU_FAULT_SERVING_HOST_FULL": "yes",
     "ACCELERATE_TPU_FAULT_SERVING_NAN_REQUEST": "1"},
])
def test_serving_knobs_equal_jax(monkeypatch, env):
    _arm(monkeypatch, env)
    assert tfi.serving_nan_ordinal() == jfi.serving_nan_ordinal()
    assert tfi.serving_host_full() == jfi.serving_host_full()
    assert tfi.armed() == jfi.armed()


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------


class _Clock:
    """A fake ``time`` module: ``sleep`` advances ``monotonic``."""

    def __init__(self):
        self.now = 100.0
        self.sleeps = []

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s


def _drive(pkg, retry_mod, monkeypatch, tmp_path, seed, failures, exc, **policy):
    clock = _Clock()
    monkeypatch.setattr(retry_mod, "time", clock)
    tel = pkg.enable(dir=str(tmp_path / pkg.__name__))
    tel.registry.reset()
    random.seed(seed)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) <= failures:
            raise exc
        return "ok"

    try:
        result = retry_mod.RetryPolicy(label="checkpoint.publish", **policy).call(flaky)
    except type(exc):
        result = "raised"
    counters = {n: tel.registry.counter(n).value
                for n in ("resilience.retries", "resilience.gave_up")}
    pkg.disable()
    return result, len(calls), clock.sleeps, counters


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("case", [
    (0, {}), (1, {}), (3, {}), (5, {}), (2, {"tries": 2}),
    (4, {"base_delay_s": 1.0, "max_delay_s": 1.5}),
    (6, {"tries": 8, "base_delay_s": 4.0, "deadline_s": 20.0}),
], ids=lambda c: f"fail{c[0]}-" + "-".join(f"{k}{v}" for k, v in c[1].items()))
def test_retry_delays_and_counters_equal_jax(monkeypatch, tmp_path, seed, case):
    failures, policy = case
    exc = OSError("EIO: flaky mount")
    port = _drive(tt, tretry, monkeypatch, tmp_path, seed, failures, exc, **policy)
    ref = _drive(jt, jretry, monkeypatch, tmp_path, seed, failures, exc, **policy)
    assert port == ref
    result, calls, sleeps, counters = port
    assert counters["resilience.retries"] == len(sleeps)
    assert (result == "raised") == (counters["resilience.gave_up"] == 1)


@pytest.mark.parametrize("exc", [
    OSError("EIO"), TimeoutError("slow"), ConnectionError("reset"), KeyError("k"),
    RuntimeError("UNAVAILABLE: backend"), RuntimeError("DEADLINE_EXCEEDED"),
    RuntimeError("please try again"), RuntimeError("RESOURCE_EXHAUSTED: hbm"),
    ValueError("bad"), OSError("RESOURCE_EXHAUSTED: hbm"),
], ids=lambda e: f"{type(e).__name__}-{e}")
def test_default_retryable_equals_jax(exc):
    assert tretry.default_retryable(exc) == jretry.default_retryable(exc)


def test_a_torch_oom_is_never_retried(monkeypatch, tmp_path):
    """The meaning of JAX's RESOURCE_EXHAUSTED test, by type: a CUDA OOM
    (whose text names no JAX status) fails fast, with a ledger postmortem."""
    from accelerate_tpu_torch.telemetry.memledger import get_memory_ledger

    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert not tretry.default_retryable(oom)
    before = len(get_memory_ledger().oom_postmortems)
    result, calls, sleeps, counters = _drive(tt, tretry, monkeypatch, tmp_path, 0, 3, oom)
    assert (result, calls, sleeps) == ("raised", 1, [])
    assert counters == {"resilience.retries": 0, "resilience.gave_up": 0}
    assert get_memory_ledger().oom_postmortems[before]["source"] == \
        "resilience.checkpoint.publish"


def test_retrying_decorator_forms():
    @tretry.retrying
    def bare():
        return 1

    @tretry.retrying(tries=6, label="x")
    def shaped():
        return 2

    assert bare() == 1 and shaped() == 2 and shaped.retry_policy.tries == 6
    assert tretry.retrying(label="save").call(lambda: 3) == 3
    with pytest.raises(ValueError):
        tretry.RetryPolicy(tries=0)


# ---------------------------------------------------------------------------
# Through the manifest and the checkpoint publish
# ---------------------------------------------------------------------------


def test_write_fault_through_write_manifest_leaves_a_torn_save(monkeypatch, tmp_path):
    good = tmp_path / "ckpts" / "checkpoint_0"
    good.mkdir(parents=True)
    (good / "weights.bin").write_bytes(b"x" * 64)
    write_manifest(str(good), step=1)
    torn = tmp_path / "ckpts" / "checkpoint_1"
    torn.mkdir()
    (torn / "weights.bin").write_bytes(b"y" * 64)
    (torn / "optimizer.bin").write_bytes(b"z" * 64)
    # The third write is the manifest itself (two files come first).
    _arm(monkeypatch, {"ACCELERATE_TPU_FAULT_WRITE_N": "3"})
    with pytest.raises(tfi.InjectedWriteError, match="manifest.json"):
        write_manifest(str(torn), step=2)
    assert not (torn / "manifest.json").exists()
    assert find_latest_complete(str(tmp_path / "ckpts")) == str(good)


def _accelerator(tmp_path):
    from accelerate_tpu_torch.utils import ProjectConfiguration

    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True))
    torch.manual_seed(0)
    model = nn.Linear(4, 3)
    model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1))
    return acc


def test_save_state_retries_a_transient_fault_and_gives_up_on_a_sticky_one(monkeypatch,
                                                                            tmp_path):
    monkeypatch.setenv("ACCELERATE_TPU_CHECKPOINT_FSYNC", "0")
    monkeypatch.setenv("ACCELERATE_TPU_IO_RETRY_BASE_S", "0.001")
    tel = tt.enable(dir=str(tmp_path / "tel"))
    acc = _accelerator(tmp_path)
    _arm(monkeypatch, {"ACCELERATE_TPU_FAULT_WRITE_N": "1"})
    path = acc.save_state(step=11)
    verify_checkpoint(path)
    assert tel.registry.counter("resilience.retries").value == 1
    assert tel.registry.counter("resilience.gave_up").value == 0

    _arm(monkeypatch, {"ACCELERATE_TPU_FAULT_WRITE_N": "1",
                       "ACCELERATE_TPU_FAULT_WRITE_STICKY": "1"})
    with pytest.raises(OSError, match="injected"):
        acc.save_state(step=12)
    _arm(monkeypatch, {"ACCELERATE_TPU_FAULT_WRITE_N": "", "ACCELERATE_TPU_FAULT_WRITE_STICKY": ""})
    base = tmp_path / "checkpoints"
    assert tel.registry.counter("resilience.gave_up").value == 1
    assert tel.registry.counter("resilience.retries").value == 1 + 3  # tries=4 by default
    assert not (base / "checkpoint_1").is_dir()  # never published
    assert (base / "checkpoint_1.tmp").is_dir()  # torn staging
    assert not (base / "checkpoint_1.tmp" / "manifest.json").exists()
    assert find_latest_complete(str(base)) == str(base / "checkpoint_0")
    assert acc.resume_from_latest(str(base)) == 11


def test_io_policy_is_the_jax_policy(monkeypatch):
    from accelerate_tpu import checkpointing as jck
    from accelerate_tpu_torch import checkpointing as tck

    for env in ({}, {"ACCELERATE_TPU_IO_RETRIES": "0", "ACCELERATE_TPU_IO_RETRY_BASE_S": "0.5",
                     "ACCELERATE_TPU_IO_RETRY_DEADLINE_S": "7"},
                {"ACCELERATE_TPU_IO_RETRIES": "junk"}):
        for key in ("ACCELERATE_TPU_IO_RETRIES", "ACCELERATE_TPU_IO_RETRY_BASE_S",
                    "ACCELERATE_TPU_IO_RETRY_DEADLINE_S"):
            monkeypatch.delenv(key, raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        got, want = tck._io_policy("checkpoint.publish"), jck._io_policy("checkpoint.publish")
        assert [getattr(got, k) for k in ("tries", "base_delay_s", "max_delay_s", "deadline_s",
                                          "label")] == \
            [getattr(want, k) for k in ("tries", "base_delay_s", "max_delay_s", "deadline_s",
                                        "label")]
