"""Tasks that every process of a :class:`torch_dp_world.World` runs (the
tests of several processes, ``test_torch_parallel.py`` and
``test_torch_dp.py``).  Each starts from a fresh port state on the CPU and
returns plain values (numbers, lists, CPU tensors) to the parent."""

from __future__ import annotations

import os
import signal
import time

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, AcceleratorState, FunctionalModel
from accelerate_tpu_torch.parallel import collectives
from accelerate_tpu_torch.utils.dataclasses import DataLoaderConfiguration


def _fresh(**kwargs) -> Accelerator:
    AcceleratorState._reset_state(reset_partial_state=True)
    return Accelerator(cpu=True, **kwargs)


def _rank() -> int:
    return collectives.rank()


# -- the collectives --------------------------------------------------------------


def collectives_task():
    from accelerate_tpu_torch.utils import operations as ops

    acc = _fresh()
    r, n = acc.process_index, acc.num_processes
    out = {"rank": r, "n": n, "type": str(acc.distributed_type), "backend": acc.state.backend,
           "mesh": dict(acc.mesh.shape)}
    out["gather"] = ops.gather(torch.tensor([r, r + 10]))
    out["gather0d"] = ops.gather(torch.tensor(float(r)))
    out["gather_tree"] = ops.gather({"a": torch.full((2, 3), r), "b": (torch.ones(1) * r,)})
    out["gather_object"] = ops.gather_object([r, f"p{r}"])
    out["broadcast"] = ops.broadcast(torch.arange(3) + 100 * r, from_process=n - 1)
    out["broadcast_objects"] = ops.broadcast_object_list([r, {"k": r}], from_process=1)
    out["reduce_sum"] = ops.reduce(torch.tensor([1.0, r]), "sum", scale=2.0)
    out["reduce_mean"] = ops.reduce(torch.tensor([1.0, r]), "mean")
    out["pad"] = ops.pad_across_processes(torch.ones(r + 1, 2), dim=0, pad_index=-1)
    out["pad_first"] = ops.pad_across_processes(torch.ones(2, r + 1), dim=1, pad_first=True)
    with acc.split_between_processes(list(range(5)), apply_padding=True) as part:
        out["split"] = part
    with acc.split_between_processes({"x": torch.arange(5)}) as part:
        out["split_dict"] = part["x"]
    with acc.main_process_first():
        entered = time.time()
        time.sleep(0.2 if r == 0 else 0.0)
    out["first"] = entered
    out["on_main"] = acc.on_main_process(lambda: r)()
    out["on_last"] = acc.on_last_process(lambda: r)()
    acc.wait_for_everyone()
    acc.set_trigger() if r == 1 else None
    out["trigger"] = acc.check_trigger()
    return out


def zero_collective_shapes(shape, degree):
    """A ZeRO-shaped reduce-scatter and all-gather along ``shard_dim``."""
    from accelerate_tpu_torch.parallel import zero

    r = _rank()
    g = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape) * (r + 1)
    zs = zero.ZeroShards([torch.nn.Parameter(torch.zeros(shape))], degree)
    (shard,), (sg,) = zs.scatter(zs.params, [g])
    gathered = None if zs.dims[0] is None else zs.gather_like(zs.params[0], sg)
    return {"dim": zs.dims[0], "grad_shard": sg, "gather": gathered}


# -- the loaders -------------------------------------------------------------------


def _rows_dataset(n_rows: int):
    return torch.utils.data.TensorDataset(torch.arange(n_rows))


class _Stream(torch.utils.data.IterableDataset):
    def __init__(self, n_rows: int):
        self.n_rows = n_rows

    def __iter__(self):
        return iter(torch.arange(self.n_rows))


def loader_rows(n_rows, batch_size, split_batches=False, even_batches=True,
                dispatch_batches=False, iterable=False, drop_last=False):
    """The rows each batch of this process's prepared loader holds."""
    acc = _fresh(dataloader_config=DataLoaderConfiguration(
        split_batches=split_batches, even_batches=even_batches,
        dispatch_batches=dispatch_batches))
    ds = _Stream(n_rows) if iterable else _rows_dataset(n_rows)
    dl = acc.prepare(torch.utils.data.DataLoader(ds, batch_size=batch_size, drop_last=drop_last))
    rows = []
    for batch in dl:
        t = batch if isinstance(batch, torch.Tensor) else batch[0]
        rows.append(t.tolist())
    return rows


def gather_for_metrics_rows(n_rows, batch_size, dispatch_batches=False):
    """Every row of an epoch, gathered for metrics across the processes."""
    acc = _fresh(dataloader_config=DataLoaderConfiguration(dispatch_batches=dispatch_batches))
    dl = acc.prepare(torch.utils.data.DataLoader(_rows_dataset(n_rows), batch_size=batch_size))
    seen = []
    for (batch,) in dl:
        seen.extend(acc.gather_for_metrics(batch).tolist())
    objs = []
    for (batch,) in dl:
        objs.extend(acc.gather_for_metrics(batch.tolist(), use_gather_object=True))
    return {"tensors": seen, "objects": objs}


# -- a small model whose leaves shard along several dims ------------------------------

SHAPES = {"w1": (16, 24), "b1": (24,), "w2": (24, 6), "c": (3, 8), "b2": (5,)}


def _mlp_params(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=g) * 0.3 for k, s in SHAPES.items()}


def _mlp_apply(p, x, y):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    out = h @ p["w2"] + (p["c"].sum() * 0.1)
    out = out[:, :5] + p["b2"]
    return {"loss": ((out - y) ** 2).mean()}


def _mlp_batches(n_batches: int, rows: int, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    return [{"x": torch.randn(rows, 16, generator=g), "y": torch.randn(rows, 5, generator=g)}
            for _ in range(n_batches)]


def _my_rows(batch, r, n):
    per = batch["x"].shape[0] // n
    return {k: v[r * per:(r + 1) * per] for k, v in batch.items()}


def _mlp_prepared(accum=1, seed=0, **kwargs):
    acc = _fresh(gradient_accumulation_steps=accum, **kwargs)
    # Every rank starts from other values: prepare broadcasts rank 0's.
    model = FunctionalModel(_mlp_apply, _mlp_params(seed + 97 * acc.process_index))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-2)
    model, opt = acc.prepare(model, opt)
    return acc, model, opt


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def dp_grads_match_global(accum: int, use_no_sync: bool):
    """The eager loop against one process's gradient of the global batch:
    ``accumulate`` over ``accum`` micro-batches (the mean of their
    gradients), or ``no_sync`` on all but the last micro-batch with no
    accumulation configured (their sum)."""
    acc, model, opt = _mlp_prepared(1 if use_no_sync else accum)
    r, n = acc.process_index, acc.num_processes
    start = {k: v.clone() for k, v in model.params.items()}
    batches = _mlp_batches(accum, 4 * n)
    synced = None
    for i, b in enumerate(batches):
        mine = _my_rows(b, r, n)
        last = i == len(batches) - 1
        ctx = acc.no_sync(model) if (use_no_sync and not last) else acc.accumulate(model)
        with ctx:
            acc.backward(model(**mine)["loss"])
            opt.step()
            if acc.sync_gradients:
                synced = {k: v.grad.detach().clone() for k, v in model.params.items()}
            opt.zero_grad()
    ref = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    total = sum(_mlp_apply(ref, **b)["loss"] for b in batches) / (1 if use_no_sync else accum)
    want = dict(zip(ref, torch.autograd.grad(total, list(ref.values()))))
    return {k: float((synced[k] - want[k]).abs().max() / want[k].abs().max()) for k in want}


def clip_norm_is_the_global_norm(accum: int):
    """What ``clip_grad_norm_`` returns on the sync micro-batch of an
    ``accumulate`` window (a clip too wide to bind), against one process's
    norm of the global batch's gradient."""
    from accelerate_tpu_torch.optimizer import global_norm

    acc, model, opt = _mlp_prepared(accum)
    r, n = acc.process_index, acc.num_processes
    start = {k: v.clone() for k, v in model.params.items()}
    batches = _mlp_batches(accum, 4 * n)
    got = None
    for b in batches:
        with acc.accumulate(model):
            acc.backward(model(**_my_rows(b, r, n))["loss"])
            if acc.sync_gradients:
                got = float(acc.clip_grad_norm_(model.parameters(), max_norm=1e9))
            opt.step()
            opt.zero_grad()
    ref = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    total = sum(_mlp_apply(ref, **b)["loss"] for b in batches) / accum
    want = float(global_norm(torch.autograd.grad(total, list(ref.values()))))
    return {"got": got, "want": want}


def zero_vs_replicated(accum: int, clip: float, steps: int = 3, poison_step=None,
                       comm_hook: str = "no"):
    """Losses, pre- and post-value-clip norms, parameters, opt-state bytes
    and the gathered state dict of the replicated and the ZeRO
    ``make_train_step``, in this process."""
    from accelerate_tpu_torch.parallel import zero
    from accelerate_tpu_torch.resilience import faultinject

    out = {}
    for mode in (False, True):
        if poison_step is not None:
            os.environ[faultinject.ENV_NAN_STEP] = str(poison_step)
        faultinject.reload()
        try:
            from accelerate_tpu_torch.utils.dataclasses import DistributedDataParallelKwargs

            acc, model, opt = _mlp_prepared(
                accum, kwargs_handlers=[DistributedDataParallelKwargs(comm_hook=comm_hook)])
            r, n = acc.process_index, acc.num_processes
            step = acc.make_train_step(model, opt, clip_norm=clip, zero=mode)
            losses, health, grad_norm, kept = [], [], [], []
            for i, b in enumerate(_mlp_batches(steps * accum, 4 * n)):
                if i % accum:
                    continue
                window = [_my_rows(bb, r, n) for bb in
                          _mlp_batches(steps * accum, 4 * n)[i:i + accum]]
                before = (_params(model), {id(k): {n_: v.clone() for n_, v in st.items()}
                                           for k, st in opt.optimizer.state.items()})
                loss = step(window if accum > 1 else window[0])
                losses.append(loss.reshape(-1).tolist())
                health.append(float(step.last_health_norm))
                grad_norm.append(float(step.last_grad_norm))
                if not torch.isfinite(step.last_health_norm):
                    after = {id(k): st for k, st in opt.optimizer.state.items()}
                    kept.append(all(torch.equal(before[0][k], v) for k, v in
                                    _params(model).items()) and
                                all(torch.equal(before[1][k][n_], after[k][n_])
                                    for k in before[1] for n_ in before[1][k]))
            out["zero" if mode else "rep"] = {
                "zero_active": step.zero_active, "losses": losses, "health": health,
                "grad_norm": grad_norm, "kept": kept, "params": _params(model),
                "bytes": zero.per_chip_bytes(opt.optimizer),
                "state": opt.state_dict()["optimizer"]["state"],
                "layout": opt._opt_state_layout,
            }
        finally:
            os.environ.pop(faultinject.ENV_NAN_STEP, None)
            faultinject.reload()
    return out


def resume_bit_exact(ckpt_dir: str):
    """ZeRO steps, save, more steps; then a fresh run loads and takes the
    same further steps: bit-identical."""
    def build():
        acc, model, opt = _mlp_prepared(1)
        return acc, model, opt, acc.make_train_step(model, opt, clip_norm=0.05, zero=True)

    batches = _mlp_batches(4, 8)
    acc, model, opt, step = build()
    r, n = acc.process_index, acc.num_processes
    for b in batches[:2]:
        step(_my_rows(b, r, n))
    torch.manual_seed(1234 + r)
    path = acc.save_state(ckpt_dir, step=2)
    noise = torch.rand(2)
    for b in batches[2:]:
        step(_my_rows(b, r, n))
    want = _params(model)
    acc, model, opt, step = build()
    acc.load_state(path)
    resumed_noise = torch.rand(2)
    for b in batches[2:]:
        step(_my_rows(b, r, n))
    got = _params(model)
    return {"equal": all(torch.equal(want[k], got[k]) for k in want),
            "rng": torch.equal(noise, resumed_noise),
            "files": sorted(os.listdir(path))}


def loader_position_resume(ckpt_dir: str):
    """A stateful loader's position is saved per process and restored."""
    cfg = DataLoaderConfiguration(use_stateful_dataloader=True)
    acc = _fresh(dataloader_config=cfg)
    dl = acc.prepare(torch.utils.data.DataLoader(_rows_dataset(32), batch_size=2))
    it = iter(dl)
    seen = [next(it)[0].tolist() for _ in range(3)]
    acc.save_state(ckpt_dir)
    rest = [b[0].tolist() for b in it]
    acc = _fresh(dataloader_config=cfg)
    dl = acc.prepare(torch.utils.data.DataLoader(_rows_dataset(32), batch_size=2))
    acc.load_state(ckpt_dir)
    return {"seen": seen, "rest": rest, "resumed": [b[0].tolist() for b in dl]}


def local_sgd_average():
    from accelerate_tpu_torch import LocalSGD
    from accelerate_tpu_torch.utils.operations import gather

    acc, model, opt = _mlp_prepared(1)
    r, n = acc.process_index, acc.num_processes
    with LocalSGD(accelerator=acc, model=model, local_sgd_steps=1000) as lsgd:
        for b in _mlp_batches(2, 4, seed=10 + r):  # each process its own data
            acc.backward(model(**b)["loss"])
            opt.step()
            opt.zero_grad()
            lsgd.step()
        before = {k: gather(v.detach().unsqueeze(0)) for k, v in model.params.items()}
    after = _params(model)
    return {"diverged": any(not torch.equal(v[0], v[1]) for v in before.values()),
            "mean_err": max(float((after[k] - before[k].mean(0)).abs().max()) for k in before),
            "after": after}


def coordinated_stop(save_dir: str, signal_rank: int, signal_step: int):
    acc, model, opt = _mlp_prepared(1)
    r = acc.process_index
    guard = acc.enable_preemption_handling(save_dir=save_dir, signals=[signal.SIGUSR1],
                                           coordinated=True)
    guard.coordinate_every = 2
    stopped = None
    try:
        for step in range(20):
            if r == signal_rank and step == signal_step:
                os.kill(os.getpid(), signal.SIGUSR1)
            if acc.check_preemption(step=step):
                stopped = step
                break
    finally:
        guard.uninstall()
    return {"stopped": stopped, "local": guard.preempted_locally(),
            "saved": sorted(os.listdir(save_dir)) if os.path.isdir(save_dir) else []}


# -- the llama slice against JAX --------------------------------------------------


def llama_trajectory(params, batches, zero: bool, clip: float, lr: float, wd: float):
    """The port's 2-layer llama through ``prepare`` and ``make_train_step``,
    this process's rows of each global batch; the global losses and the
    pre-clip norms."""
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.utils.convert import llama_params_from_jax

    acc = _fresh()
    r, n = acc.process_index, acc.num_processes
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, num_layers=2)

    def apply_fn(p, input_ids, attention_mask):
        return {"loss": tl.loss_fn(p, {"input_ids": input_ids,
                                       "attention_mask": attention_mask}, cfg)}

    model = FunctionalModel(apply_fn, llama_params_from_jax(params, cfg, device="cpu"))
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=wd)
    model, opt = acc.prepare(model, opt)
    step = acc.make_train_step(model, opt, clip_norm=clip, zero=zero)
    losses, health = [], []
    for b in batches:
        per = b["input_ids"].shape[0] // n
        mine = {k: torch.from_numpy(v[r * per:(r + 1) * per]) for k, v in b.items()}
        losses.append(float(step(mine)))
        health.append(float(step.last_health_norm))
    return {"losses": losses, "health": health, "zero_active": step.zero_active}


def zero_smoke_record():
    """This process's record of the ZeRO smoke at its own size."""
    from accelerate_tpu_torch.parallel import zero_smoke

    return {"rank": _rank(), "backend": "gloo", "device": "cpu", "seconds": 0.0,
            "replicated": zero_smoke._run_mode("tiny", "cpu", False),
            "zero": zero_smoke._run_mode("tiny", "cpu", True)}
