"""Telemetry wired into the port's training and serving paths, against the
JAX package's wiring with telemetry on in both.

- The README loop (``accumulate`` / ``backward`` / ``optimizer.step()``,
  with and without the prefetcher) and the fused ``make_train_step``, on a
  tiny llama with shared weights: ``step.count``, ``pipeline.dispatches``,
  ``pipeline.dispatches_per_step``, ``dataloader.batches``, the
  prefetcher's blocked-wait samples and the set of span names in the run
  directory are equal but for the JAX mesh's (3 dispatches a micro-batch in
  the eager loop, 1 a fused step).
- ``save_state`` / ``load_state``, a preemption signal and
  ``check_preemption``, and ``find_executable_batch_size``'s halvings: the
  same checkpoint and resilience spans, events and counters.
- The serving engine twin on a seeded trace with preemption: every
  ``serving.*`` counter and the per-tick gauges are equal.  The blame of
  each request is the phase that took most of its wall time, so its split
  over phases is a matter of the two runs' clocks; what is compared is
  that in each package the ``serving.trace.blame.*`` counters equal the
  tracer's own counts and sum to the completed requests.

Exact comparisons throughout (integers and the engine's rounded gauges)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.data import DataLoader

import accelerate_tpu.telemetry as jt
import accelerate_tpu_torch.telemetry as tt
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.accelerator import JaxModel
from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import ServingConfig as JConfig
from accelerate_tpu.serving import ServingEngine as JEngine
from accelerate_tpu.telemetry import report as jreport
from accelerate_tpu.utils import DataLoaderConfiguration as JaxDataLoaderConfiguration
from accelerate_tpu_torch import Accelerator, FunctionalModel
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.serving import ServingConfig, ServingEngine
from accelerate_tpu_torch.state import AcceleratorState
from accelerate_tpu_torch.telemetry import memledger as tmem
from accelerate_tpu_torch.telemetry import report as treport
from accelerate_tpu_torch.utils.convert import llama_params_from_jax
from accelerate_tpu_torch.utils.dataclasses import DataLoaderConfiguration

LR, WD, BATCH, BATCHES, ACCUM = 1e-2, 1e-4, 8, 6, 2
STEP_KEYS = ("step.count", "pipeline.dispatches", "pipeline.dispatches_per_step",
             "dataloader.batches", "pipeline.host_blocked_ms.count")
# Spans of JAX subsystems the port does not have yet: the device mesh (ROADMAP A6).
JAX_ONLY_SPANS = {"mesh.build"}


@pytest.fixture(scope="module", autouse=True)
def _restore_jax_global_mesh():
    before = jax.sharding.get_mesh()
    yield
    jax.set_mesh(before)


@pytest.fixture(autouse=True)
def _fresh():
    AcceleratorState._reset_state(reset_partial_state=True)
    for pkg in (jt, tt):
        pkg.disable()
        pkg.get_telemetry().step_timer.reset()
    yield
    for pkg in (jt, tt):
        pkg.disable()
    AcceleratorState._reset_state(reset_partial_state=True)


@pytest.fixture(scope="module")
def setup():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, num_layers=1)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, num_layers=1)
    params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size, size=(BATCH * BATCHES, 16)).astype(np.int64)
    return jcfg, tcfg, params, [{"input_ids": torch.from_numpy(row)} for row in ids]


def _run_summary(report, run_dir):
    s = report.summarize(report.load_records(run_dir))
    return {k: s["snapshot"].get(k) for k in STEP_KEYS}, set(s["spans"])


def _jax_side(jcfg, params, data, fused, prefetch, run_dir):
    jt.enable(dir=run_dir)
    acc = JaxAccelerator(gradient_accumulation_steps=ACCUM, dataloader_config=(
        JaxDataLoaderConfiguration(split_batches=True, prefetch_to_device=prefetch)))

    def apply_fn(p, input_ids):
        return {"loss": jl.loss_fn(p, {"input_ids": input_ids}, jcfg)}

    shadow = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))], lr=LR, weight_decay=WD)
    model, opt, dl = acc.prepare(JaxModel(apply_fn, jax.tree.map(jnp.asarray, params)), shadow,
                                 DataLoader(data, batch_size=BATCH))
    if fused:
        step = acc.make_train_step(model, opt)
        batches = [{"input_ids": jnp.asarray(b["input_ids"].numpy())} for b in dl]
        for i in range(0, len(batches), ACCUM):
            step(batches[i:i + ACCUM])
    else:
        for batch in dl:
            with acc.accumulate(model):
                acc.backward(model(**batch)["loss"])
                opt.step()
                opt.zero_grad()
    jt.disable()
    return _run_summary(jreport, run_dir)


def _port_side(tcfg, params, data, fused, prefetch, run_dir):
    tt.enable(dir=run_dir)
    acc = Accelerator(cpu=True, gradient_accumulation_steps=ACCUM,
                      dataloader_config=DataLoaderConfiguration(prefetch_to_device=prefetch))

    def apply_fn(p, input_ids):
        return {"loss": tl.loss_fn(p, {"input_ids": input_ids}, tcfg)}

    model = FunctionalModel(apply_fn, llama_params_from_jax(params, tcfg, device="cpu"))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    model, opt, dl = acc.prepare(model, opt, DataLoader(data, batch_size=BATCH))
    if fused:
        step = acc.make_train_step(model, opt)
        batches = list(dl)
        for i in range(0, len(batches), ACCUM):
            step(batches[i:i + ACCUM])
        led = tmem.get_memory_ledger()
        params_bytes = sum(p.untyped_storage().nbytes() for p in model.parameters())
        state_bytes = sum(t.untyped_storage().nbytes() for s in opt.optimizer.state.values()
                          for t in s.values())
        owners = {r.owner: r.per_device for r in led.owners()}
        assert owners["train.params"] == {0: params_bytes}
        assert owners["train.opt_state"] == {0: state_bytes}
    else:
        for batch in dl:
            with acc.accumulate(model):
                acc.backward(model(**batch)["loss"])
                opt.step()
                opt.zero_grad()
    tt.disable()
    return _run_summary(treport, run_dir)


@pytest.mark.parametrize("fused,prefetch", [(False, 0), (False, 2), (True, 0)],
                         ids=["eager", "eager-prefetch2", "fused"])
def test_loop_counts_and_spans_match_jax(setup, fused, prefetch, tmp_path):
    jcfg, tcfg, params, data = setup
    want_counts, want_spans = _jax_side(jcfg, params, data, fused, prefetch,
                                        str(tmp_path / "jax"))
    AcceleratorState._reset_state(reset_partial_state=True)
    got_counts, got_spans = _port_side(tcfg, params, data, fused, prefetch,
                                       str(tmp_path / "port"))
    steps = BATCHES // ACCUM
    assert got_counts == want_counts == {
        "step.count": steps,
        "pipeline.dispatches": steps * (1 if fused else 3 * ACCUM),
        "pipeline.dispatches_per_step": 1 if fused else 3 * ACCUM,
        "dataloader.batches": BATCHES,
        # One blocked-wait sample a queue read, the end marker's included.
        "pipeline.host_blocked_ms.count": BATCHES + 1 if prefetch else None}
    assert got_spans == want_spans - JAX_ONLY_SPANS
    assert ("pipeline.train_step" if fused else "optimizer.step") in got_spans


# ---------------------------------------------------------------------------
# The serving engine
# ---------------------------------------------------------------------------


def _serving_keys(snapshot):
    return {k: v for k, v in snapshot.items()
            if k.startswith("serving.") and not k.startswith("serving.trace.")
            and not k.endswith(("_ms.count", "_ms.mean", "_ms.min", "_ms.max", "_ms.last",
                                "_ms.p50", "_ms.p95"))
            and not k.startswith("serving.tokens_per_s.")}


def _blame(snapshot):
    return {k[len("serving.trace.blame."):]: v for k, v in snapshot.items()
            if k.startswith("serving.trace.blame.")}


@pytest.mark.parametrize("spec_tokens", [0, 2])
def test_engine_counters_match_jax(spec_tokens, tmp_path):
    """Five requests on three slots over a 12-block pool (preemptions and
    requeued waits), telemetry on in both packages."""
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    jparams = jl.init_params(jcfg, jax.random.key(0))
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    rng = np.random.default_rng(21)
    prompts = [list(rng.integers(0, jcfg.vocab_size, size=n)) for n in (12, 10, 6, 17, 9)]
    geometry = dict(block_size=4, num_blocks=12, max_slots=3, prefill_chunk=8,
                    max_blocks_per_seq=8, spec_tokens=spec_tokens, trace=True)
    jtel = jt.enable(dir=str(tmp_path / "jax"))
    jeng = JEngine(jl.apply_cached, jl.init_cache, jparams, jcfg, serving=JConfig(**geometry))
    jids = [jeng.submit(p, 7) for p in prompts]
    jout = jeng.run(max_ticks=500)
    want = jtel.registry.snapshot()
    jt.disable()
    ttel = tt.enable(dir=str(tmp_path / "port"))
    teng = ServingEngine(tl.apply_cached, tl.init_cache, tparams, tcfg, device="cpu",
                         serving=ServingConfig(paged_kernel=True, **geometry))
    tids = [teng.submit(p, 7) for p in prompts]
    tout = teng.run(max_ticks=500)
    got = ttel.registry.snapshot()
    assert [tout[t] for t in tids] == [jout[j] for j in jids]
    assert _serving_keys(got) == _serving_keys(want)
    assert got["serving.preempted"] > 0 and got["serving.completed"] == len(prompts)
    for snap, eng in ((got, teng), (want, jeng)):
        assert _blame(snap) == eng.tracer.blame_counts
        assert sum(_blame(snap).values()) == len(prompts)
        assert snap["serving.trace.unattributed_ms.count"] == len(prompts)
    # The engine's counters and stats() agree; the pool is a ledger owner
    # of its tensors' bytes, and the traces landed in the run directory.
    st = teng.stats()
    for name, key in (("serving.decode_dispatches", "decode_dispatches"),
                      ("serving.prefill_dispatches", "prefill_dispatches"),
                      ("serving.completed", "completed"), ("serving.preempted", "preempted"),
                      ("serving.decode_gather_bytes", "decode_gather_bytes")):
        assert got[name] == st[key], name
    assert got.get("serving.spec.rounds", 0) == st["spec"]["rounds"]
    owners = {r.owner: r.device_bytes for r in tmem.get_memory_ledger().owners()}
    assert owners["serving.kv_pool"] == sum(t.untyped_storage().nbytes()
                                            for t in teng.cache.pool.values())
    assert teng.tracer.path is not None and teng.tracer.path.startswith(str(tmp_path / "port"))
    tt.disable()
    # The port's run directory reads with either package's report.
    port_dir = str(tmp_path / "port")
    records = treport.load_records(port_dir)
    assert treport.summarize(records) == jreport.summarize(records)
    assert treport.load_serving_trace_records(port_dir) == \
        jreport.load_serving_trace_records(port_dir) != []
    assert jreport.main([port_dir]) == 0


# ---------------------------------------------------------------------------
# Checkpoints, preemption and OOM halvings
# ---------------------------------------------------------------------------

SITE_COUNTERS = ("resilience.preempt_signals", "resilience.preempt_checkpoints",
                 "memory.oom_halvings", "memory.oom_postmortems")


def _site_summary(report, run_dir):
    records = report.load_records(run_dir)
    s = report.summarize(records)
    spans = {n for n in s["spans"] if n.startswith(("checkpoint.", "resilience."))}
    events = sorted(r["name"] for r in records if r.get("kind") == "event")
    return spans, events, {k: s["snapshot"].get(k) for k in SITE_COUNTERS}


def _sites(acc, tmp_path, tag, find_executable_batch_size):
    """``save_state`` / ``load_state``, a self-sent SIGUSR1 to an installed
    guard and ``check_preemption``, then two OOM halvings."""
    import os
    import signal

    path = acc.save_state(str(tmp_path / f"{tag}_ckpt"), step=1)
    acc.load_state(path)
    guard = acc.enable_preemption_handling(save_dir=str(tmp_path / f"{tag}_final"),
                                           signals=(signal.SIGUSR1,))
    try:
        assert acc.check_preemption(step=2) is False
        os.kill(os.getpid(), signal.SIGUSR1)
        assert acc.check_preemption(step=2) is True
    finally:
        guard.uninstall()

    @find_executable_batch_size(starting_batch_size=16)
    def fit(batch_size):
        if batch_size > 4:
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
        return batch_size

    assert fit() == 4


def test_checkpoint_preemption_and_oom_sites_match_jax(tmp_path):
    from accelerate_tpu.utils.memory import find_executable_batch_size as jfind
    from accelerate_tpu_torch.utils.memory import find_executable_batch_size as tfind

    jt.enable(dir=str(tmp_path / "jax"))
    jacc = JaxAccelerator()
    shadow = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.1)
    jacc.prepare(JaxModel(lambda p, x: {"loss": jnp.mean((x @ p["w"]) ** 2)},
                          {"w": jnp.ones((4, 2), jnp.float32)}), shadow)
    _sites(jacc, tmp_path, "jax", jfind)
    jt.disable()
    AcceleratorState._reset_state(reset_partial_state=True)
    tt.enable(dir=str(tmp_path / "port"))
    tacc = Accelerator(cpu=True)
    net = torch.nn.Linear(4, 2)
    tacc.prepare(net, torch.optim.SGD(net.parameters(), lr=0.1))
    _sites(tacc, tmp_path, "port", tfind)
    tt.disable()
    got = _site_summary(treport, str(tmp_path / "port"))
    want = _site_summary(jreport, str(tmp_path / "jax"))
    assert got == want
    assert got[2] == dict.fromkeys(SITE_COUNTERS[:2], 1) | dict.fromkeys(SITE_COUNTERS[2:], 2)
    assert {"checkpoint.save_state", "checkpoint.load_state", "checkpoint.publish",
            "resilience.final_checkpoint"} <= got[0]
