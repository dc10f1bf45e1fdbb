"""The port's ``AcceleratedScheduler`` (``accelerate_tpu_torch/scheduler.py``)
and the optimizer's LR surface against the JAX package's.

Both sides run the same eager loop (``accumulate`` / ``backward`` /
``optimizer.step()`` / ``scheduler.step()`` / ``zero_grad()``) over a torch
``Linear``.  The JAX side is built with ``split_batches=True``: on the
suite's 8-device CPU mesh its scheduler would otherwise step once per data
shard, 8 times per optimizer step, where one GPU is one shard.  The LRs are
compared exactly: both sides evaluate the same torch scheduler (or the same
callable) at the same step counts.
"""

import jax
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.scheduler import AcceleratedScheduler



@pytest.fixture(scope="module", autouse=True)
def _restore_jax_global_mesh():
    """Put back the global mesh this module found (a JAX ``Accelerator``
    installs its own), so later modules see the context they would alone."""
    before = jax.sharding.get_mesh()
    yield
    jax.set_mesh(before)


SCHEDULES = {
    "lambda": lambda opt: torch.optim.lr_scheduler.LambdaLR(opt, lambda n: 1 - n / 20),
    "onecycle": lambda opt: torch.optim.lr_scheduler.OneCycleLR(opt, max_lr=0.05,
                                                                total_steps=20),
}


def _prepared(acc, kind):
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    return acc.prepare(model, opt, SCHEDULES[kind](opt))


def _run(acc, model, opt, sched, micro_batches, skip_at=()):
    gen = torch.Generator().manual_seed(1)
    lrs = []
    for i in range(micro_batches):
        x, y = torch.randn(4, 3, generator=gen), torch.randn(4, 2, generator=gen)
        with acc.accumulate(model):
            acc.backward(torch.nn.functional.mse_loss(model(x), y))
            opt.step()
            if i in skip_at:
                opt._step_was_skipped = True
            sched.step()
            opt.zero_grad()
        lrs.append((sched.get_last_lr()[0], opt.param_groups[0]["lr"]))
    return lrs


def _pair(kind, accum, step_with_optimizer):
    kw = dict(gradient_accumulation_steps=accum,
              step_scheduler_with_optimizer=step_with_optimizer)
    jacc = JaxAccelerator(split_batches=True, **kw)
    tacc = Accelerator(cpu=True, **kw)
    return (jacc, *_prepared(jacc, kind)), (tacc, *_prepared(tacc, kind))


@pytest.mark.parametrize("step_with_optimizer", [True, False], ids=["with_opt", "every_call"])
@pytest.mark.parametrize("accum", [1, 3])
@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_lr_per_step_matches_jax(kind, accum, step_with_optimizer):
    jax_side, port_side = _pair(kind, accum, step_with_optimizer)
    want = _run(*jax_side, micro_batches=9)
    got = _run(*port_side, micro_batches=9)
    assert got == pytest.approx(want, rel=0, abs=0)
    assert all(a == b for a, b in got)  # the optimizer holds the scheduler's LR
    steps = 9 if not step_with_optimizer else 9 // accum
    assert port_side[3]._step_count == jax_side[3]._step_count == steps


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_overflow_skip_holds_the_lr(kind):
    """A step after a skipped optimizer update leaves the LR as it was."""
    jax_side, port_side = _pair(kind, 1, True)
    want = _run(*jax_side, micro_batches=5, skip_at=(1, 2))
    got = _run(*port_side, micro_batches=5, skip_at=(1, 2))
    assert got == want
    assert got[1] == got[0] and got[2] == got[0] and got[3] != got[2]


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_state_dict_roundtrip_continues_the_schedule(kind):
    _, port_side = _pair(kind, 2, True)
    acc, model, opt, sched = port_side
    _run(acc, model, opt, sched, micro_batches=6)
    sd = sched.state_dict()
    assert sd["accelerate_step_count"] == 3
    tail = _run(acc, model, opt, sched, micro_batches=6)

    _, fresh = _pair(kind, 2, True)
    acc2, model2, opt2, sched2 = fresh
    sched2.load_state_dict(sd)
    assert opt2.param_groups[0]["lr"] == sched2.get_last_lr()[0] == sd["_last_lr"][0]
    model2.load_state_dict(model.state_dict())
    assert _run(acc2, model2, opt2, sched2, micro_batches=6) == tail


def test_callable_schedule():
    def schedule(step):
        return 0.1 / (1 + step)

    for make in (lambda: JaxAccelerator(split_batches=True, gradient_accumulation_steps=2),
                 lambda: Accelerator(cpu=True, gradient_accumulation_steps=2)):
        acc = make()
        torch.manual_seed(0)
        model = torch.nn.Linear(3, 2)
        model, opt, sched = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=0.1),
                                        schedule)
        lrs = _run(acc, model, opt, sched, micro_batches=6)
        assert [a for a, _ in lrs] == [0.1, 0.05, 0.05, 0.1 / 3, 0.1 / 3, 0.025]
        assert sched.state_dict() == {"step_count": 3}


def test_set_learning_rate_keeps_distinct_group_lrs():
    acc = Accelerator(cpu=True)
    a, b = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)
    model = torch.nn.Sequential(a, b)
    opt = torch.optim.AdamW([{"params": a.parameters(), "lr": 0.1},
                             {"params": b.parameters(), "lr": 0.2}])
    model, opt = acc.prepare(model, opt)
    opt.set_learning_rate(0.5)
    assert [g["lr"] for g in opt.param_groups] == [0.1, 0.2]
    assert opt.learning_rate == 0.1
    one = Accelerator(cpu=True)
    m = torch.nn.Linear(2, 2)
    _, o = one.prepare(m, torch.optim.AdamW(m.parameters(), lr=0.1))
    o.set_learning_rate(0.5)
    assert o.learning_rate == 0.5


def test_prepare_wraps_scheduler_after_optimizer():
    acc = Accelerator(cpu=True)
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=0.5)
    out_sched, out_model, out_opt = acc.prepare(sched, model, opt)
    assert isinstance(out_sched, AcceleratedScheduler)
    assert out_sched.optimizers == [out_opt]
    assert acc._schedulers == [out_sched]
