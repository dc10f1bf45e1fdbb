"""The port's serving robustness layer on the CPU: queue bounds, deadlines,
the crash-recovery journal, graceful drain under a ``PreemptionGuard``, and
``check_preemption``'s final checkpoint.

The oracles are the JAX package's: its engine on the same traffic for the
shed ordinals, its greedy ``generate`` for every token, and its journal
reader and engine for the files the port writes (and the reverse).  No test
sleeps: deadlines are passed by moving a request's arrival time back, and
signals are sent by the process to itself.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import AdmissionRejected as JAdmissionRejected
from accelerate_tpu.serving import ServingConfig as JServingConfig
from accelerate_tpu.serving import ServingEngine as JServingEngine
from accelerate_tpu.serving import ServingJournal as JServingJournal
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.resilience import PreemptionGuard
from accelerate_tpu_torch.serving import (
    AdmissionRejected,
    JournalError,
    Request,
    ServingConfig,
    ServingEngine,
    ServingJournal,
)
from accelerate_tpu_torch.utils.convert import llama_params_from_jax

GEOMETRY = dict(block_size=4, num_blocks=40, max_slots=2, prefill_chunk=8, max_blocks_per_seq=8)
MAX_NEW = 6


@pytest.fixture(scope="module")
def setup():
    """Tiny llama weights on both sides, six 8-token prompts and their JAX
    ``generate`` continuations (``MAX_NEW`` tokens; shorter budgets are
    prefixes)."""
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    jparams = jl.init_params(jcfg, jax.random.key(0))
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    prompts = np.random.default_rng(41).integers(0, jcfg.vocab_size, size=(6, 8)).astype(np.int32)
    want = np.asarray(jl.generate(jparams, jnp.asarray(prompts), jcfg, max_new_tokens=MAX_NEW))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                prompts=[[int(t) for t in p] for p in prompts],
                want=[[int(t) for t in w] for w in want])


def _want(s, i, max_new):
    return s["want"][i][:8 + max_new]


def _engine(s, **kw):
    return ServingEngine(tl.apply_cached, tl.init_cache, s["tparams"], s["tcfg"], device="cpu",
                         serving=ServingConfig(**dict(GEOMETRY, **kw)))


def _jax_engine(s, **kw):
    return JServingEngine(jl.apply_cached, jl.init_cache, s["jparams"], s["jcfg"],
                          serving=JServingConfig(**dict(GEOMETRY, **kw)))


# ---------------------------------------------------------------------------
# Queue bound and deadlines
# ---------------------------------------------------------------------------


def test_shed_ordinals_match_jax_engine(setup):
    """The same submissions and ticks on both engines under
    ``max_queue_depth=2``: the same submissions are shed, the accepted ones
    finish with the same tokens, and admission reopens as the queue
    drains."""
    plan = [("submit", 0), ("submit", 1), ("submit", 2), ("submit", 3), ("step", 2),
            ("submit", 4), ("submit", 5), ("submit", 0), ("step", 1), ("submit", 1)]
    results = []
    for eng, rejected in ((_jax_engine(setup, max_queue_depth=2), JAdmissionRejected),
                          (_engine(setup, max_queue_depth=2), AdmissionRejected)):
        shed, ids = [], []
        for n, (op, arg) in enumerate(plan):
            if op == "step":
                for _ in range(arg):
                    eng.step()
                continue
            try:
                ids.append((arg, eng.submit(setup["prompts"][arg], 3)))
            except rejected as exc:
                assert "max_queue_depth" in str(exc)
                shed.append(n)
        out = eng.run(max_ticks=500)
        results.append((shed, [(i, out[rid]) for i, rid in ids], eng.stats()["shed"]))
    assert results[0] == results[1]
    shed, outs, count = results[1]
    assert shed and count == len(shed)
    for i, tokens in outs:
        assert tokens == _want(setup, i, 3)


def test_queued_deadline_sheds_before_prefill(setup):
    eng = _engine(setup)
    rid = eng.submit(setup["prompts"][0], 4, deadline_ms=0.0)
    done = eng.step()
    assert [(c.id, c.status) for c in done] == [(rid, "deadline_expired")]
    assert eng.prefill_dispatches == 0, "a prefill chunk was spent on an expired request"
    assert eng.cache.allocator.used_blocks == 0 and eng.stats()["deadline_expired"] == 1


def test_inflight_deadline_cancels_and_frees_blocks(setup):
    eng = _engine(setup)
    doomed = eng.submit(setup["prompts"][0], MAX_NEW, deadline_ms=60_000.0)
    healthy = eng.submit(setup["prompts"][1], 3)
    eng.step()
    eng.step()
    req = next(sl.request for sl in eng.sched.slots.values() if sl.request.id == doomed)
    assert req.emitted and eng.cache.allocator.used_blocks > 0
    req.arrival_t -= 3600.0  # its 60 s budget is now spent
    out = eng.run(max_ticks=300)
    by_id = {c.id: c for c in eng.pop_finished()}
    assert by_id[doomed].status == "deadline_expired"
    assert 0 < by_id[doomed].new_tokens < MAX_NEW
    assert by_id[doomed].tokens == _want(setup, 0, by_id[doomed].new_tokens)
    assert by_id[healthy].status == "ok" and out[healthy] == _want(setup, 1, 3)
    assert eng.cache.allocator.used_blocks == 0, "cancellation leaked blocks"


@pytest.mark.parametrize("field", ["default_deadline_ms", "default_ttft_deadline_ms"])
def test_config_default_deadlines_apply(setup, field):
    eng = _engine(setup, **{field: 0.0})
    eng.submit(setup["prompts"][0], 4)  # inherits the default
    eng.step()
    assert [c.status for c in eng.pop_finished()] == ["deadline_expired"]
    eng = _engine(setup, **{field: 0.0})
    rid = eng.submit(setup["prompts"][0], 2, deadline_ms=60_000.0, ttft_deadline_ms=60_000.0)
    assert eng.run(max_ticks=300)[rid] == _want(setup, 0, 2)  # a per-request value wins


# ---------------------------------------------------------------------------
# The journal
# ---------------------------------------------------------------------------


def test_journal_wal_and_recovery_token_identical(setup, tmp_path):
    """Admissions are on disk before ``submit`` returns; an engine abandoned
    mid-run (a SIGKILL without a handler) leaves a journal its successor
    finishes from, token-identically, replaying no terminal request."""
    jp = str(tmp_path / "journal.json")
    eng = _engine(setup, journal_path=jp)
    tags = {}
    for i in range(3):
        tags[f"t{i}"] = i
        eng.submit(setup["prompts"][i], 5, tag=f"t{i}")
    assert len(ServingJournal.pending(ServingJournal.load(jp))) == 3
    for _ in range(4):
        eng.step()
    finished = {c.tag for c in eng.pop_finished()}
    succ = _engine(setup, journal_path=jp)
    mapping = succ.recover_from_journal()
    assert len(mapping) == 3 - len(finished)
    succ.run(max_ticks=500)
    for c in succ.pop_finished():
        assert c.tokens == _want(setup, tags[c.tag], 5), f"{c.tag} diverged after recovery"
    assert not ServingJournal.pending(ServingJournal.load(jp))
    assert succ.stats()["journal_flushes"] >= 1 + len(mapping)
    with pytest.raises(JournalError, match="before the first submit"):
        succ.recover_from_journal()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_cross_loads_between_packages(setup, tmp_path, writer):
    """A journal written by one package's engine, abandoned mid-run with a
    request in flight, is recovered by the other package's engine, which
    finishes every pending request token-identically; both write the same
    record keys."""
    jp = str(tmp_path / "journal.json")
    make = {"port": _engine, "jax": _jax_engine}
    other = "jax" if writer == "port" else "port"
    eng = make[writer](setup, journal_path=jp)
    for i in range(3):
        eng.submit(setup["prompts"][i], 4, tag=f"t{i}")
    for _ in range(3):
        eng.step()
    state = json.load(open(jp))
    assert state["version"] == 1 and len(state["requests"]) == 3
    assert {k for r in state["requests"].values() for k in r} == {
        "prompt", "max_new_tokens", "tag", "ttft_deadline_ms", "deadline_ms", "emitted",
        "arrival_wall"}
    pending = (JServingJournal if writer == "port" else ServingJournal).pending(
        (JServingJournal if writer == "port" else ServingJournal).load(jp))
    assert pending, "the abandoned engine should leave work behind"
    succ = make[other](setup, journal_path=str(tmp_path / "successor.json"))
    mapping = succ.recover_from_journal(jp)
    assert sorted(mapping) == sorted(r["id"] for r in pending)
    succ.run(max_ticks=500)
    for c in succ.pop_finished():
        assert c.tokens == _want(setup, int(c.tag[1:]), 4), f"{c.tag} diverged"


def test_journal_load_rejects_missing_torn_and_newer(tmp_path):
    with pytest.raises(JournalError, match="no journal"):
        ServingJournal.load(str(tmp_path / "absent.json"))
    torn = tmp_path / "torn.json"
    torn.write_text('{"version": 1, "requests": {"0": ')
    with pytest.raises(JournalError, match="unreadable"):
        ServingJournal.load(str(torn))
    newer = tmp_path / "newer.json"
    newer.write_text(json.dumps({"version": 99, "requests": {}, "done": {}}))
    with pytest.raises(JournalError, match="schema version"):
        ServingJournal.load(str(newer))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 1, "requests": [], "done": {}}))
    with pytest.raises(JournalError, match="structurally invalid"):
        ServingJournal.load(str(bad))


def test_journal_deferred_batches_into_one_atomic_flush(tmp_path):
    jp = str(tmp_path / "journal.json")
    old = ServingJournal(jp)
    old.record_admit(Request([1, 2, 3], 4, tag="a"))
    old.record_admit(Request([4, 5], 3, tag="b"))
    before = open(jp).read()
    new = ServingJournal(jp)
    with new.deferred():
        new.record_admit(Request([1, 2, 3], 4, tag="a2"))
        assert open(jp).read() == before and not new.flushed
        new.record_admit(Request([4, 5], 3, tag="b2"))
    assert {r["tag"] for r in ServingJournal.pending(ServingJournal.load(jp))} == {"a2", "b2"}
    assert (old.flushes, new.flushes) == (2, 1)
    assert not os.path.exists(jp + ".tmp")


def test_recovery_bypasses_queue_bound(setup, tmp_path):
    """A dead engine's backlog is not a burst: recovery admits all of it
    past a successor's smaller queue bound, which then holds for new
    traffic."""
    jp = str(tmp_path / "journal.json")
    eng = _engine(setup, journal_path=jp)
    for i in range(5):
        eng.submit(setup["prompts"][i], 2, tag=f"t{i}")
    succ = _engine(setup, journal_path=jp, max_queue_depth=2)
    assert len(succ.recover_from_journal()) == 5
    out = succ.run(max_ticks=500)
    assert sorted(out.values()) == sorted(_want(setup, i, 2) for i in range(5))
    for _ in range(2):
        succ.submit(setup["prompts"][5], 2)
    with pytest.raises(AdmissionRejected):
        succ.submit(setup["prompts"][5], 2)


# ---------------------------------------------------------------------------
# Drain and the preemption guard
# ---------------------------------------------------------------------------


def test_drain_is_idempotent_and_requeue_resubmits_identically(setup, tmp_path):
    jp = str(tmp_path / "journal.json")
    eng = _engine(setup, journal_path=jp, host_blocks=8)
    ids = {eng.submit(setup["prompts"][i], MAX_NEW): i for i in range(3)}
    for _ in range(5):
        eng.step()
    first = eng.drain()
    assert eng.drain() == first and eng.drained and first == eng.requeue_journal
    assert eng.sched.active == 0 and eng.cache.allocator.used_blocks == 0
    assert eng.cache.host.used_blocks == eng._prefix.host_count
    with pytest.raises(RuntimeError, match="drained"):
        eng.submit([1, 2, 3], 2)
    with pytest.raises(RuntimeError, match="already drained"):
        eng.install_preemption_guard(PreemptionGuard(signals=()))
    assert eng.step() == [] and eng.stats()["ticks"] == 5
    done = {ids[c.id]: c.tokens for c in eng.pop_finished()}
    # The journal on disk carries the drained progress too.
    on_disk = {r["id"]: r["emitted"] for r in ServingJournal.pending(ServingJournal.load(jp))}
    assert on_disk == {r["id"]: r["emitted"] for r in first}
    succ = _engine(setup)
    rebind = {succ.submit(r["prompt"] + r["emitted"], r["remaining"]): ids[r["id"]]
              for r in first}
    for rid, tokens in succ.run(max_ticks=500).items():
        done[rebind[rid]] = tokens
    assert done == {i: _want(setup, i, MAX_NEW) for i in range(3)}


def test_guard_drains_engine_on_self_sent_signal(setup, tmp_path):
    """``enable_preemption_handling`` arms a guard that ``prepare_serving``
    wires in; a signal the process sends itself drains the next tick."""
    acc = Accelerator(cpu=True)
    guard = acc.enable_preemption_handling(save_dir=str(tmp_path / "ckpt"),
                                           signals=(signal.SIGUSR1,))
    try:
        eng = acc.prepare_serving(tl.apply_cached, tl.init_cache, setup["tparams"],
                                  setup["tcfg"], **GEOMETRY)
        ids = [eng.submit(setup["prompts"][i], MAX_NEW) for i in range(3)]
        eng.step()
        eng.step()
        assert not eng.drained
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.preempted_locally()
        assert eng.step() == [] and eng.drained
        assert {r["id"] for r in eng.requeue_journal} == set(ids)
        assert eng.cache.allocator.used_blocks == 0
    finally:
        guard.uninstall()


def test_preemption_guard_plumbing():
    seen = []
    prev = signal.signal(signal.SIGUSR2, lambda signum, frame: seen.append(("prev", signum)))
    try:
        guard = PreemptionGuard(signals=(signal.SIGUSR2,))
        guard.add_callback(lambda signum: seen.append(("cb", signum)))
        with guard:
            assert guard.installed and not guard.should_stop()
            os.kill(os.getpid(), signal.SIGUSR2)
            assert guard.should_stop() and guard.preempted_locally()
            assert seen == [("cb", signal.SIGUSR2), ("prev", signal.SIGUSR2)]
            guard.reset()
            assert not guard.should_stop()
        assert not guard.installed
        os.kill(os.getpid(), signal.SIGUSR2)  # uninstalled: the previous handler alone
        assert seen[-1] == ("prev", signal.SIGUSR2) and not guard.should_stop()
    finally:
        signal.signal(signal.SIGUSR2, prev)
    # Coordinated with no process group: the agreement is this process's flag.
    coordinated = PreemptionGuard(signals=(signal.SIGUSR2,), coordinated=True)
    assert coordinated._coordination_on() and not coordinated.should_stop()


def test_check_preemption_writes_checkpoint_resume_from_latest_loads(tmp_path):
    torch.manual_seed(0)
    acc = Accelerator(cpu=True)
    with pytest.raises(ValueError, match="checkpoint target"):
        acc.enable_preemption_handling()
    net = nn.Linear(4, 2)
    model, _ = acc.prepare(net, torch.optim.SGD(net.parameters(), 0.1))
    target = str(tmp_path / "final")
    guard = acc.enable_preemption_handling(save_dir=target, signals=(signal.SIGUSR1,))
    try:
        assert acc.check_preemption(step=3) is False and not os.path.exists(target)
        os.kill(os.getpid(), signal.SIGUSR1)
        assert acc.check_preemption(step=7) is True
        assert os.path.isfile(os.path.join(target, "manifest.json"))
        stamp = os.path.getmtime(os.path.join(target, "manifest.json"))
        assert acc.check_preemption(step=8) is True  # one final checkpoint only
        assert os.path.getmtime(os.path.join(target, "manifest.json")) == stamp
    finally:
        guard.uninstall()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    acc2 = Accelerator(cpu=True)
    torch.manual_seed(1)
    net2 = nn.Linear(4, 2)
    model2, _ = acc2.prepare(net2, torch.optim.SGD(net2.parameters(), 0.1))
    assert not torch.equal(model2.weight, want["weight"])
    assert acc2.resume_from_latest(target) == 7
    for k, v in model2.state_dict().items():
        assert torch.equal(v, want[k])
