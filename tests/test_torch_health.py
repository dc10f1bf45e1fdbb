"""The port's numerical-health guard against the JAX package's
(``resilience/health.py``, ``Accelerator.enable_health_guard`` /
``check_health``, the loader's quarantine hooks).

- The cases of ``tests/test_health.py`` (the gate, the skip streak, the
  rewind, ``lr_backoff``, quarantine fingerprints, accumulation windows, the
  counters, the constructor's checks), each driven through both packages'
  ``HealthGuard`` with the same stubs: the same verdicts, calls and
  records, exactly.
- ``_update_body``'s gate against the JAX one on NaN / Inf / -Inf gradients
  under the clips: the port leaves parameters and Adam state bit-identical
  wherever JAX gates, and updates within 1e-6 of JAX where it does not (a
  few fp32 ulps at parameters of magnitude ~2).
- A twin: a tiny llama (2 layers, d 64) through the fused step in both
  packages under ``NAN_STEP=4``, ``NAN_COUNT=3`` and ``max_skips=2``: the
  same verdict sequence (skipped, rewound, ``resumed_step``) and counters;
  losses after the rewind within rtol 2e-5 of JAX's (the tolerance of
  ``test_torch_train_step.py``: the JAX side runs on the suite's 8-device
  mesh and sums in another order) and bit-exact with the port's own clean
  resume.  Eager and fused skip under the poison; the armed step keeps its
  one counted dispatch.
- The loader's quarantine yields the same positions as JAX's, stateful and
  not, prefetched or not, and a NaN-laced batch is quarantined end to end.
"""

import json
import math
import os

import numpy as np
import pytest
import torch
from torch.utils.data import DataLoader

import jax
import jax.numpy as jnp
import optax

from accelerate_tpu import data_loader as jdl
from accelerate_tpu import telemetry as jt
from accelerate_tpu.accelerator import Accelerator as JaxAccelerator
from accelerate_tpu.accelerator import JaxModel
from accelerate_tpu.models import llama as jl
from accelerate_tpu.optimizer import _update_body as jax_update_body
from accelerate_tpu.resilience import faultinject as jfi
from accelerate_tpu.resilience import health as jh
from accelerate_tpu.utils import ProjectConfiguration as JProjectConfiguration
from accelerate_tpu_torch import Accelerator, AcceleratorState, FunctionalModel
from accelerate_tpu_torch import data_loader as tdl
from accelerate_tpu_torch import telemetry as tt
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.optimizer import _update_body
from accelerate_tpu_torch.resilience import faultinject as tfi
from accelerate_tpu_torch.resilience import health as th
from accelerate_tpu_torch.utils import ProjectConfiguration
from accelerate_tpu_torch.utils.convert import llama_params_from_jax

FAULTS = ("ACCELERATE_TPU_FAULT_NAN_STEP", "ACCELERATE_TPU_FAULT_NAN_COUNT",
          "ACCELERATE_TPU_FAULT_BAD_BATCH")


@pytest.fixture(scope="module", autouse=True)
def _restore_jax_global_mesh():
    before = jax.sharding.get_mesh()
    yield
    jax.set_mesh(before)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for key in FAULTS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("ACCELERATE_TPU_CHECKPOINT_FSYNC", "0")
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


def _arm(monkeypatch, **env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jfi.reload()
    tfi.reload()


# ---------------------------------------------------------------------------
# The policy, through stubs (tests/test_health.py's cases)
# ---------------------------------------------------------------------------


class _StubOptimizer:
    def __init__(self):
        self._last_health_norm = 1.0
        self._step_was_skipped = False
        self.learning_rate = 0.1
        self.lr_history = []

    def set_learning_rate(self, lr):
        self.learning_rate = lr
        self.lr_history.append(lr)


class _StubAccelerator:
    def __init__(self, resume_step=2):
        self.resume_step = resume_step
        self.resume_calls = 0

    def resume_from_latest(self, checkpoint_dir=None):
        self.resume_calls += 1
        return self.resume_step


class _StubLoader:
    def __init__(self):
        self.iteration = 0
        self._yielded = 0
        self.pushed = []

    def quarantine(self, fingerprints):
        self.pushed.append(sorted(fingerprints))


def _stub_guard(h, **kw):
    acc, opt, dl = _StubAccelerator(), _StubOptimizer(), _StubLoader()
    return h.HealthGuard(acc, optimizer=opt, dataloader=dl, **kw), acc, opt, dl


def _v(verdict):
    return (verdict.anomalous, verdict.skipped, verdict.rewound, verdict.resumed_step,
            None if verdict.grad_norm is None else repr(verdict.grad_norm),
            verdict.quarantined, bool(verdict))


def case_streak(h, tmp_path):
    guard, _, opt, _ = _stub_guard(h, max_skips=2)
    out = []
    for step, norm in enumerate([float("nan"), float("nan"), 3.0, float("inf"), float("inf")]):
        opt._last_health_norm = norm
        out.append(_v(guard.check(step=step + 1)) + (guard.consecutive_anomalies,))
    assert [o[1] for o in out] == [True, True, False, True, True]
    return out


def case_rewind_budget(h, tmp_path):
    guard, acc, opt, _ = _stub_guard(h, max_skips=1)
    out = []
    for step, norm in enumerate([float("nan")] * 2 + [1.0] + [float("nan")] * 2 + [1.0]
                                + [float("nan")] * 2):
        opt._last_health_norm = norm
        try:
            out.append(_v(guard.check(step=step + 1)) + (acc.resume_calls,
                                                          opt._step_was_skipped))
        except h.NumericalDivergenceError as e:
            out.append(("diverged", str(e)))
    assert out[1][2] and out[4][2] and out[-1][0] == "diverged"
    return out


def case_no_checkpoint(h, tmp_path):
    guard, acc, opt, _ = _stub_guard(h, max_skips=0)
    acc.resume_step = None
    opt._last_health_norm = float("nan")
    with pytest.raises(h.NumericalDivergenceError, match="no manifest-complete") as e:
        guard.check(step=1)
    return str(e.value)


def case_lr_backoff(h, tmp_path):
    guard, _, opt, _ = _stub_guard(h, max_skips=0, lr_backoff=0.5)
    opt._last_health_norm = float("nan")
    verdict = guard.check(step=1)
    assert verdict.rewound and opt.lr_history == [pytest.approx(0.05)]
    return _v(verdict), opt.lr_history


def case_eager_loss(h, tmp_path):
    guard, _, opt, _ = _stub_guard(h)
    opt._last_health_norm = 1.0
    verdict = guard.check(step=1, loss=float("inf"))
    assert verdict.anomalous and verdict.skipped
    return _v(verdict), _v(guard.check(step=2, loss=torch.tensor(2.0)))


def case_quarantine_log(h, tmp_path):
    qlog = str(tmp_path / f"quarantine_{h.__name__}.jsonl")
    guard, _, opt, dl = _stub_guard(h, max_skips=5, quarantine_after=2, quarantine_log=qlog)
    opt._last_health_norm = float("nan")
    dl._yielded = 1  # the step consumed batch (0, 0)
    v1 = guard.check(step=1)
    guard._pos_mark = (0, 0)  # its replay breaks again
    dl._yielded = 1
    v2 = guard.check(step=1)
    assert v1.quarantined == () and v2.quarantined == ((0, 0),)
    records = [json.loads(line) for line in open(qlog)]
    for r in records:
        r.pop("t")
    return _v(v1), _v(v2), dl.pushed, records


def case_accumulation_window(h, tmp_path):
    guard, _, opt, dl = _stub_guard(h, max_skips=5, quarantine_after=1)
    opt._last_health_norm = float("nan")
    dl._yielded = 4  # an accumulation window of 4 micro-batches
    verdict = guard.check(step=1)
    assert verdict.quarantined == ((0, 0), (0, 1), (0, 2), (0, 3))
    dl.iteration, dl._yielded = 1, 2  # the next epoch
    return _v(verdict), _v(guard.check(step=2)), sorted(guard.quarantined)


def case_counters(h, tmp_path):
    pkg = jt if h is jh else tt
    tel = pkg.enable(dir=str(tmp_path / f"tel_{h.__name__}"))
    guard, _, opt, _ = _stub_guard(h, max_skips=1)
    opt._last_health_norm = 2.5
    guard.check(step=1)
    gauge = tel.registry.gauge("health.last_grad_norm").value
    opt._last_health_norm = float("nan")
    guard.check(step=2)
    guard.check(step=3)  # rewind
    counters = {n: tel.registry.counter(n).value for n in (
        "health.nonfinite_grads", "health.skipped_steps", "health.rewinds",
        "health.quarantined_batches")}
    pkg.disable()
    assert gauge == 2.5 and counters["health.rewinds"] == 1
    return gauge, counters


def case_constructor(h, tmp_path):
    out = []
    for kw in ({"max_skips": -1}, {"max_rewinds": -1}, {"quarantine_after": 0}, {}):
        try:
            h.HealthGuard(_StubAccelerator(), **kw)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    assert out[:3] == [o for o in out[:3] if o] and out[3] is None
    return out


CASES = {f.__name__[5:]: f for f in (
    case_streak, case_rewind_budget, case_no_checkpoint, case_lr_backoff, case_eager_loss,
    case_quarantine_log, case_accumulation_window, case_counters, case_constructor)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_guard_policy_equals_jax(name, tmp_path):
    assert CASES[name](th, tmp_path) == CASES[name](jh, tmp_path)


def test_verdict_and_error_types():
    assert th.HealthVerdict.__dataclass_fields__.keys() == jh.HealthVerdict.__dataclass_fields__.keys()
    assert issubclass(th.NumericalDivergenceError, RuntimeError)
    assert not th.HealthVerdict() and th.HealthVerdict(anomalous=True)


def test_no_guard_check_health_is_a_healthy_noop():
    verdict = Accelerator(cpu=True).check_health(step=1)
    assert isinstance(verdict, th.HealthVerdict) and not verdict.anomalous and not verdict


# ---------------------------------------------------------------------------
# The on-device gate: _update_body against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [(-1.0, -1.0), (1.0, -1.0), (-1.0, 0.5), (1.0, 0.5)],
                         ids=["noclip", "norm", "value", "both"])
@pytest.mark.parametrize("poison", [None, float("nan"), float("inf"), float("-inf")],
                         ids=["finite", "nan", "inf", "-inf"])
def test_update_gate_equals_jax(poison, clip):
    clip_norm, clip_value = clip
    rng = np.random.default_rng(3)
    params = {"b": rng.standard_normal(()).astype(np.float32),
              "w": rng.standard_normal(4).astype(np.float32)}
    grads = {k: rng.standard_normal(np.shape(v)).astype(np.float32) for k, v in params.items()}
    if poison is not None:
        grads["w"][1] = poison
    tx = optax.adam(0.1)
    jp = jax.tree.map(jnp.asarray, params)
    jnew, _, _, jhealth = jax_update_body(tx.update, jp, tx.init(jp),
                                          jax.tree.map(jnp.asarray, grads),
                                          jnp.float32(clip_norm), jnp.float32(clip_value))
    tp = [torch.tensor(params[k], requires_grad=True) for k in sorted(params)]
    opt = torch.optim.Adam(tp, lr=0.1)
    before = [t.detach().clone() for t in tp]
    _, health, ok = _update_body(opt, tp, [torch.tensor(grads[k]) for k in sorted(params)],
                                 clip_norm, clip_value)
    assert math.isfinite(health.item()) == math.isfinite(float(jhealth)) == (poison is None)
    assert bool(ok) == (poison is None)
    for k, t, b in zip(sorted(params), tp, before):
        if poison is None:
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jnew[k]), rtol=1e-6,
                                       atol=1e-6)
        else:  # a zero delta on both sides, optimizer state untouched
            assert torch.equal(t.detach(), b)
            assert np.array_equal(np.asarray(jnew[k]), params[k])
    if poison is not None:
        assert not opt.state  # AdamW never took the step


def test_health_ok_vetoes_a_finite_update():
    tp = [torch.ones(3, requires_grad=True)]
    opt = torch.optim.Adam(tp, lr=0.1)
    _, health, ok = _update_body(opt, tp, [torch.ones(3)], -1.0, -1.0,
                                 health_ok=torch.tensor(False))
    assert not bool(ok) and math.isnan(health.item()) and torch.equal(tp[0].detach(),
                                                                     torch.ones(3))


# ---------------------------------------------------------------------------
# The twin: fused step x NaN poison x rewind, in both packages
# ---------------------------------------------------------------------------

LR, WD, STEPS, NAN_STEP, CKPT_STEP = 1e-2, 1e-4, 8, 4, 2


def _batches(vocab):
    rng = np.random.default_rng(9)
    return [{"input_ids": rng.integers(0, vocab, size=(2, 16)).astype(np.int32),
             "attention_mask": np.ones((2, 16), np.int32)} for _ in range(STEPS)]


def _loss_apply(mod, cfg):
    def apply_fn(p, input_ids, attention_mask):
        return {"loss": mod.loss_fn(p, {"input_ids": input_ids,
                                        "attention_mask": attention_mask}, cfg)}
    return apply_fn


def _guarded_run(acc, step_fn, batches, to_batch, root, resume=False):
    """Steps 1-8 with the guard checking each; batch ``k`` is fed at step
    ``k``, so a rewind replays the same data.  Returns the verdicts, the
    losses by step and the step count of the last call."""
    verdicts, losses, step = [], {}, 0
    if resume:
        step = acc.resume_from_latest(root)
        assert step == CKPT_STEP
    rewound = False
    while step < STEPS:
        loss = step_fn(to_batch(batches[step]))
        verdict = acc.check_health(step=step + 1)
        verdicts.append((step + 1, verdict.anomalous, verdict.skipped, verdict.rewound,
                         verdict.resumed_step))
        if verdict.rewound:
            rewound = True
            losses = {s: v for s, v in losses.items() if s <= verdict.resumed_step}
            step = verdict.resumed_step
            continue
        step += 1
        losses[step] = float(np.asarray(loss))
        if step == CKPT_STEP and not rewound and not resume:
            acc.save_state(os.path.join(root, f"step_{CKPT_STEP}"), step=CKPT_STEP)
    return verdicts, losses


def _jax_twin(params, cfg, batches, root):
    acc = JaxAccelerator(project_config=JProjectConfiguration(project_dir=root))
    model, opt = acc.prepare(JaxModel(_loss_apply(jl, cfg), jax.tree.map(jnp.asarray, params)),
                             optax.adamw(LR, weight_decay=WD))
    acc.enable_health_guard(optimizer=opt, max_skips=2, max_rewinds=1, checkpoint_dir=root)
    step_fn = acc.make_train_step(model, opt)
    return _guarded_run(acc, step_fn, batches, lambda b: jax.tree.map(jnp.asarray, b), root)


def _port_twin(params, cfg, batches, root, resume=False):
    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(project_dir=root))
    model = FunctionalModel(_loss_apply(tl, cfg), llama_params_from_jax(params, cfg, device="cpu"))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=WD)
    model, opt = acc.prepare(model, opt)
    acc.enable_health_guard(max_skips=2, max_rewinds=1, checkpoint_dir=root)
    step_fn = acc.make_train_step(model, opt)
    out = _guarded_run(acc, step_fn, batches,
                       lambda b: {k: torch.from_numpy(v) for k, v in b.items()}, root, resume)
    return out + (step_fn,)


def _counters(tel):
    return {n: tel.registry.counter(n).value for n in (
        "health.nonfinite_grads", "health.skipped_steps", "health.rewinds",
        "pipeline.dispatches")}


def test_rewind_twin_matches_jax_and_a_clean_resume(monkeypatch, tmp_path):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    assert (tcfg.num_layers, tcfg.hidden_size) == (2, 64)
    params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.key(0)))
    batches = _batches(jcfg.vocab_size)
    _arm(monkeypatch, ACCELERATE_TPU_FAULT_NAN_STEP=str(NAN_STEP),
         ACCELERATE_TPU_FAULT_NAN_COUNT="3")
    jtel = jt.enable(dir=str(tmp_path / "jtel"))
    jverdicts, jlosses = _jax_twin(params, jcfg, batches, str(tmp_path / "jax"))
    jcounters = _counters(jtel)
    jt.disable()
    ttel = tt.enable(dir=str(tmp_path / "ttel"))
    tverdicts, tlosses, step_fn = _port_twin(params, tcfg, batches, str(tmp_path / "port"))
    tcounters = _counters(ttel)
    tt.disable()

    assert tverdicts == jverdicts
    assert [v[0] for v in tverdicts if v[2]] == [NAN_STEP, NAN_STEP + 1]
    assert [(v[0], v[4]) for v in tverdicts if v[3]] == [(NAN_STEP + 2, CKPT_STEP)]
    assert tcounters == jcounters
    assert tcounters["health.rewinds"] == 1 and tcounters["pipeline.dispatches"] == len(tverdicts)
    assert sorted(tlosses) == sorted(jlosses) == list(range(1, STEPS + 1))
    np.testing.assert_allclose([tlosses[s] for s in range(1, STEPS + 1)],
                               [jlosses[s] for s in range(1, STEPS + 1)], rtol=2e-5)

    _arm(monkeypatch, ACCELERATE_TPU_FAULT_NAN_STEP="", ACCELERATE_TPU_FAULT_NAN_COUNT="")
    cverdicts, clean, _ = _port_twin(params, tcfg, batches, str(tmp_path / "port"), resume=True)
    assert not any(v[1] for v in cverdicts)
    for s in range(CKPT_STEP + 1, STEPS + 1):
        assert clean[s] == tlosses[s], f"the rewound replay differs from a clean resume at {s}"


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_poisoned_step_skips_and_keeps_its_dispatch(monkeypatch, tmp_path, fused):
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    params = jax.tree.map(np.asarray, jl.init_params(
        jl.LlamaConfig.tiny(dtype=jnp.float32), jax.random.key(1)))
    batches = _batches(cfg.vocab_size)
    _arm(monkeypatch, ACCELERATE_TPU_FAULT_NAN_STEP="2")
    tel = tt.enable(dir=str(tmp_path / "tel"))
    acc = Accelerator(cpu=True)
    model = FunctionalModel(_loss_apply(tl, cfg), llama_params_from_jax(params, cfg, device="cpu"))
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=LR))
    guard = acc.enable_health_guard(max_skips=3)
    step_fn = acc.make_train_step(model, opt) if fused else None
    digests, skipped, dispatches = [[p.detach().clone() for p in model.parameters()]], [], []
    for i in range(3):
        batch = {k: torch.from_numpy(v) for k, v in batches[i].items()}
        d0 = tel.registry.counter("pipeline.dispatches").value
        if fused:
            loss = step_fn(batch)
        else:
            loss = model(**batch)["loss"]
            acc.backward(loss)
            opt.step()
            opt.zero_grad()
        dispatches.append(tel.registry.counter("pipeline.dispatches").value - d0)
        if acc.check_health(step=i + 1, loss=loss).skipped:
            skipped.append(i + 1)
        digests.append([p.detach().clone() for p in model.parameters()])
    assert skipped == [2] and guard.consecutive_anomalies == 0
    assert all(torch.equal(a, b) for a, b in zip(digests[1], digests[2]))  # frozen
    assert not all(torch.equal(a, b) for a, b in zip(digests[2], digests[3]))  # moves again
    assert len(set(dispatches)) == 1  # the armed step counts the dispatches of the others
    assert opt.step_was_skipped is False and acc.optimizer_step_was_skipped is False


# ---------------------------------------------------------------------------
# The loader's quarantine and the bad-batch fault
# ---------------------------------------------------------------------------


def _dataset(n):
    return [{"x": torch.tensor([float(i)]), "i": torch.tensor(i)} for i in range(n)]


def _ids(batches):
    return [b["i"].tolist() for b in batches]


def _loaders(stateful, prefetch=0):
    jax_dl = jdl.prepare_data_loader(DataLoader(_dataset(8), batch_size=2),
                                     put_on_device=False, use_stateful_dataloader=stateful)
    port_dl = tdl.prepare_data_loader(DataLoader(_dataset(8), batch_size=2), device="cpu",
                                      use_stateful_dataloader=stateful,
                                      prefetch_to_device=prefetch)
    return jax_dl, port_dl


@pytest.mark.parametrize("prefetch", [0, 2], ids=["lookahead", "prefetch"])
@pytest.mark.parametrize("stateful", [False, True])
def test_loader_quarantine_equals_jax(stateful, prefetch, tmp_path):
    jtel = jt.enable(dir=str(tmp_path / "j"))
    ttel = tt.enable(dir=str(tmp_path / "t"))
    jax_dl, port_dl = _loaders(stateful, prefetch)
    for dl in (jax_dl, port_dl):
        dl.quarantine([(0, 1), (1, 3)])
    for epoch in range(3):
        assert _ids(port_dl) == _ids(jax_dl), epoch
    assert ttel.registry.counter("health.quarantine_skips").value == \
        jtel.registry.counter("health.quarantine_skips").value == 2


def test_loader_quarantine_on_stateful_replay_equals_jax():
    """The rewind scenario: restore the mid-epoch state, quarantine a later
    position, and the replay drops exactly that batch."""
    out = []
    for dl in _loaders(True):
        it = iter(dl)
        next(it)
        state = dl.state_dict()
        for _ in it:
            pass
        dl.load_state_dict(state)
        dl.quarantine([(0, 2)])
        out.append((_ids(dl), dl.state_dict()))
    assert out[0] == out[1]
    assert out[1][0] == [[2, 3], [6, 7]]


@pytest.mark.parametrize("index", ["1", "3"])
def test_bad_batch_is_quarantined_end_to_end(monkeypatch, index):
    """A NaN-laced batch makes its step anomalous; after the second offense
    the guard quarantines the fingerprint and the next pass skips it."""
    _arm(monkeypatch, ACCELERATE_TPU_FAULT_BAD_BATCH=index)
    acc = Accelerator(cpu=True)
    torch.manual_seed(0)
    model = torch.nn.Linear(1, 1)

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = model

        def forward(self, x, i):
            return {"loss": ((self.m(x) - x) ** 2).mean()}

    net, opt, dl = acc.prepare(Wrap(), torch.optim.SGD(model.parameters(), lr=0.01),
                               DataLoader(_dataset(8), batch_size=2))
    guard = acc.enable_health_guard(max_skips=8, quarantine_after=2)
    step_fn = acc.make_train_step(net, opt)
    for _ in range(2):  # the same epoch, replayed after a rewind
        dl.iteration = 0
        guard._pos_mark = None
        anomalies = []
        for i, batch in enumerate(dl):
            step_fn(batch)
            if acc.check_health(step=i + 1).anomalous:
                anomalies.append(i)
        assert anomalies == [int(index)]
    assert guard.quarantined == {(0, int(index))}
    dl.iteration = 0
    assert [b["i"].tolist() for b in dl] == [[2 * k, 2 * k + 1] for k in range(4)
                                            if k != int(index)]
