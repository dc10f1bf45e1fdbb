"""ZeRO smoke: the sharded weight update proves itself across processes.

The port of the JAX package's ``parallel/zero_smoke.py``.  The parent starts
``--world`` processes that meet in one process group and, through the public
``Accelerator``, each run the replicated ``make_train_step`` and then the
ZeRO one from the same weights over their rows of the same global batches
(binding global-norm clip).  Required from their records (checks that
``python -O`` keeps):

1. the losses, the pre- and post-value-clip gradient norms of every step
   and every parameter after the last step are bit-identical between the
   two modes, and across processes (the norms catch a gradient left
   unaveraged, which the binding clip would scale back);
2. what each collective moved, per step (the JAX smoke reads the compiled
   program's comms ledger; the port logs its own calls,
   :data:`~.collectives.COMM_LOG`): the ZeRO step's reduce-scatters carry
   the gradient bytes and its all-gathers the parameter bytes;
3. optimizer-state bytes per process shrink about dp-fold (within 10%);
4. one step call per optimizer step.

Sizes: ``tiny`` (default) is the JAX smoke's model, a ``tanh(x @ w + b)``
layer with ``w`` 256 x 128 under Adam, 4 steps of a 16-row global batch;
``llama3-8b`` is Llama-3-8B's widths cut to 2 layers (bf16 compute over
fp32 parameters, ``remat``), AdamW, 2 steps of one 2048-token sequence per
process from ``prepare_data_loader`` over 6 seeded sequences, with each
step's flash launches (2L / L / L), its time and the time of the gloo
transfers through host memory, and the optimizer state's bytes read from
the allocator.

With ``model_axes`` (``--model-axes``; two processes, ``llama3-8b``) each
process then runs the same recipe twice more, from the same weights, on a
fresh ``AcceleratorState`` over the same group: ``fsdp=2`` under
``FULL_SHARD`` and ``tp=2`` (both processes read the same rows), each for
``MODEL_AXES_STEPS`` steps, and records what the replicated run is held
to: losses, norms, the parameters' change over 2 steps against the
replicated run's (its start and step-2 parameters kept on the host for
that), the allocator's
bytes, the collectives by axis, and the q / k shapes the fused attention
saw.

``then`` (``"module:function"``, with ``model_axes``) names more work for
the same two processes once those modes are done: each calls
``function(rank, world, device)`` in the group, and the summary carries
what each returned (a JSON-able record) under ``then``, in rank order.

Run::

    python -m accelerate_tpu_torch.parallel.zero_smoke            # on the card
    python -m accelerate_tpu_torch.parallel.zero_smoke --cpu --world 4

On the card with fewer cards than processes the processes share card 0 over
gloo (which stages every collective through host memory); with one card
each they meet over NCCL.  The backend is printed.  Exit code 0 only when
every requirement holds; the last line is the JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Optional

SIZES = ("tiny", "llama3-8b")
STEPS = {"tiny": 4, "llama3-8b": 2}
MODEL_AXES = ("fsdp", "tp")
MODEL_AXES_STEPS = 2
CLIP = 0.05
N_SEQ = 6  # llama3-8b: sequences of the seeded token dataset
SEQ = 2048
FLASH = ("fused_attention_fwd", "fused_attention_bwd_dq", "fused_attention_bwd_dkv")
CHILD_TIMEOUT_S = 900


def llama_config():
    import torch

    from ..models import llama

    return llama.LlamaConfig.llama3_8b(num_layers=2, dtype=torch.bfloat16,
                                       param_dtype=torch.float32, remat=True)


def token_dataset(vocab_size: int):
    """``N_SEQ`` sequences of ``SEQ`` tokens from seed 0 (numpy)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab_size, size=SEQ) for _ in range(N_SEQ)]


def tiny_batches():
    """The JAX smoke's global batches: 16 rows of ``x`` (256) and ``y``
    (128) per step, from a torch seed."""
    import torch

    g = torch.Generator().manual_seed(100)
    return [{"x": torch.randn(16, 256, generator=g), "y": torch.randn(16, 128, generator=g)}
            for _ in range(STEPS["tiny"])]


def _digest(model) -> str:
    from ..resilience.smoke import params_digest

    return params_digest(model)


def _flash_counts() -> dict:
    from ..ops import fused_attention as fu

    return {name: getattr(fu, name).launches for name in FLASH}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build(size: str, device: str, axis: Optional[str] = None):
    """A fresh accelerator, model, optimizer and (llama) loader; every
    process starts from its own seed, so ``prepare``'s broadcast of rank
    0's parameters is what makes them equal.  ``axis`` ``"fsdp"`` or
    ``"tp"``: the mesh puts the two processes on it (``FULL_SHARD``)."""
    import torch

    from ..accelerator import Accelerator, FunctionalModel
    from ..state import AcceleratorState
    from ..utils.dataclasses import FullyShardedDataParallelPlugin, ParallelismConfig

    AcceleratorState._reset_state(reset_partial_state=True)
    kw = {}
    if axis is not None:
        kw["parallelism_config"] = ParallelismConfig(**{axis: 2})
        if axis == "fsdp":
            kw["fsdp_plugin"] = FullyShardedDataParallelPlugin(sharding_strategy="FULL_SHARD")
    acc = Accelerator(device=device, **kw)
    seed = 7 * acc.process_index
    if size == "tiny":
        g = torch.Generator().manual_seed(seed)
        params = {"w": torch.randn(256, 128, generator=g) * 0.1,
                  "b": torch.randn(128, generator=g) * 0.1}

        def apply_fn(p, x, y):
            pred = torch.tanh(x @ p["w"] + p["b"])
            return {"loss": ((pred - y) ** 2).mean()}

        model = FunctionalModel(apply_fn, params)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        model, opt = acc.prepare(model, opt)
        return acc, model, opt, None
    from torch.utils.data import DataLoader

    from ..models import llama

    cfg = llama_config()
    model = llama.LlamaForCausalLM(cfg, seed=seed, device=device)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-5, weight_decay=1e-4)
    data = [{"input_ids": torch.from_numpy(t)} for t in token_dataset(cfg.vocab_size)]
    model, opt, dl = acc.prepare(model, opt, DataLoader(data, batch_size=1))
    return acc, model, opt, dl


def _run_mode(size: str, device: str, zero: bool, axis: Optional[str] = None,
              snapshot_steps: tuple = (), compare_to: Optional[dict] = None) -> dict:
    """One mode's steps in this process; its record.  ``axis``: the
    ``fsdp`` or ``tp`` mode (``MODEL_AXES_STEPS`` steps, the q / k shapes
    the fused attention saw, the parameters after its last step against
    ``compare_to``'s snapshots, :func:`_gap`); ``snapshot_steps``: keep the
    full parameters after each of those steps (0: before the first) on
    the host, in the record's ``snapshots``."""
    import gc

    import torch

    from ..ops import fused_attention as fu
    from . import collectives
    from .zero import per_chip_bytes

    t_build = time.perf_counter()
    dev0 = torch.device(device)
    _sync(dev0)
    base = torch.cuda.memory_allocated(dev0) if dev0.type == "cuda" else 0
    acc, model, opt, dl = _build(size, device, axis)
    dev = acc.device
    _sync(dev)
    build_s = time.perf_counter() - t_build
    param_alloc = torch.cuda.memory_allocated(dev) - base if dev.type == "cuda" else None
    r, n = acc.process_index, acc.num_processes
    step = acc.make_train_step(model, opt, clip_norm=CLIP, zero=zero)
    steps = STEPS[size] if axis is None else MODEL_AXES_STEPS
    shapes: list = []
    plain_attention = fu.fused_attention

    def recording(q, k, v, **kw):
        shapes.append([list(q.shape), list(k.shape)])
        return plain_attention(q, k, v, **kw)

    if size == "tiny":
        batches = []
        for b in tiny_batches():
            per = b["x"].shape[0] // n
            batches.append({k: v[r * per:(r + 1) * per].to(dev) for k, v in b.items()})
    else:
        batches = list(dl)
    snapshots = {}

    def keep(i):
        if i in snapshot_steps:
            snapshots[i] = {k: v.detach().to("cpu", copy=True)
                            for k, v in acc.get_state_dict(model).items()}

    keep(0)
    fu.fused_attention = recording
    try:
        losses, health, grad_norm, times, staged_s, launches, comm = [], [], [], [], [], [], []
        rows = []
        for i, batch in enumerate(batches[:steps]):
            if "input_ids" in batch:
                rows.append(batch["input_ids"][:, :8].tolist())
            before = _flash_counts()
            collectives.reset_comm_log()
            _sync(dev)
            t0 = time.perf_counter()
            loss = step(batch)
            _sync(dev)
            times.append(time.perf_counter() - t0)
            after = _flash_counts()
            launches.append({k: after[k] - before[k] for k in FLASH})
            comm.append({op: dict(v) for op, v in collectives.COMM_LOG.items()})
            staged_s.append(sum(v["staged_seconds"] for v in collectives.COMM_LOG.values()))
            losses.append(float(loss))
            health.append(float(step.last_health_norm))
            grad_norm.append(float(step.last_grad_norm))
            keep(i + 1)
    finally:
        fu.fused_attention = plain_attention
    gap = None
    if compare_to is not None:
        gap = _gap(model, compare_to[0], compare_to[steps], acc.mesh)
    state_bytes = per_chip_bytes(opt.optimizer)
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    digest = _digest(model)
    allocator_bytes = None
    if dev.type == "cuda":
        _sync(dev)
        held = torch.cuda.memory_allocated(dev)
        opt.optimizer.state.clear()
        gc.collect()
        allocator_bytes = held - torch.cuda.memory_allocated(dev)
    record = dict(zero_active=step.zero_active, losses=losses, health=health,
                  grad_norm=grad_norm, step_s=times, staged_s=staged_s, launches=launches, comm=comm,
                  state_bytes=state_bytes, allocator_state_bytes=allocator_bytes,
                  param_bytes=param_bytes, digest=digest, rows=rows,
                  dispatches=step.dispatch_count, build_s=build_s, param_alloc_bytes=param_alloc,
                  attention_shapes=shapes, gap=gap, snapshots=snapshots, mesh=dict(acc.mesh.shape),
                  peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None)
    del acc, model, opt, dl, step, batches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return record


def _gap(model, start: dict, want: dict, mesh) -> dict:
    """This process's parameters (shards, where the model is sharded)
    against its chunks of ``want``'s full host tensors, both having
    started from ``start``: whether all are equal, the largest absolute
    difference, and the relative norm of the difference of the two changes
    ``||(p - start) - (want - start)|| / ||want - start||`` (its squared
    terms too); an update that did nothing reads 1.0.  The processes
    together cover every element, with no collective."""
    import torch

    from .sharding import local_slice, spec_of

    worst, equal, diff_sq, delta_sq = 0.0, True, 0.0, 0.0
    with torch.no_grad():
        for k, v in model.state_dict(keep_vars=True).items():
            w = local_slice(want[k], spec_of(v), mesh).to(v.device)
            s0 = local_slice(start[k], spec_of(v), mesh).to(v.device)
            equal = equal and torch.equal(v, w)
            diff = v.float() - w.float()
            worst = max(worst, float(diff.abs().max()))
            diff_sq += float(diff.square().sum(dtype=torch.float64))
            delta_sq += float((w.float() - s0.float()).square().sum(dtype=torch.float64))
    return {"max_abs": worst, "bit_identical": equal, "diff_sq": diff_sq,
            "delta_sq": delta_sq, "relnorm": (diff_sq / delta_sq) ** 0.5 if delta_sq else None}


def child(rank: int, world: int, init: str, backend: str, device: str, size: str,
          out: str, model_axes: bool = False, then: Optional[str] = None) -> None:
    """One process: join the group, run the replicated then the ZeRO mode
    (with ``model_axes`` then the ``fsdp`` and ``tp`` ones, and ``then``),
    write the records to ``out``."""
    import torch.distributed as dist

    from .launch import join_group

    join_group(rank, world, init, backend, device)
    try:
        t0 = time.perf_counter()
        record = {"rank": rank, "world": world, "backend": backend, "device": device}
        record["replicated"] = _run_mode(
            size, device, False, snapshot_steps=(0, MODEL_AXES_STEPS) if model_axes else ())
        snapshots = record["replicated"].pop("snapshots")
        record["zero"] = _run_mode(size, device, True)
        record["seconds"] = time.perf_counter() - t0
        if model_axes:
            for axis in MODEL_AXES:
                t1 = time.perf_counter()
                record[axis] = _run_mode(size, device, False, axis=axis,
                                         compare_to=snapshots if axis == "fsdp" else None)
                record[axis]["seconds"] = time.perf_counter() - t1
            del snapshots
        if then is not None:
            import importlib

            module, name = then.split(":")
            t1 = time.perf_counter()
            record["then"] = getattr(importlib.import_module(module), name)(rank, world, device)
            record["then_seconds"] = time.perf_counter() - t1
        for mode in ("zero", *MODEL_AXES):
            record.get(mode, {}).pop("snapshots", None)
        if dist.is_initialized():
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(record, f)


def run(size: str = "tiny", device: Optional[str] = None, world: int = 2,
        workdir: Optional[str] = None, backend: Optional[str] = None,
        model_axes: bool = False, then: Optional[str] = None) -> dict:
    """Start the processes, check every requirement, return the summary.
    ``device`` None is the card (raising without CUDA), ``"cpu"`` the CPU.
    ``backend`` None is NCCL with a card per process where there are
    enough, else gloo (the processes sharing card 0 on the card).
    ``model_axes``: the ``fsdp`` and ``tp`` modes too (two processes,
    ``llama3-8b``), whose records the summary carries under ``model_axes``;
    ``then``: the work of the module docstring, after them."""
    if model_axes and (world != 2 or size != "llama3-8b"):
        raise ValueError("model_axes runs two processes at the llama3-8b size")
    if then is not None and not model_axes:
        raise ValueError("then runs after the model_axes modes")
    from ..state import resolve_device
    from . import launch

    dev = resolve_device(device)
    if size not in SIZES:
        raise ValueError(f"size must be one of {SIZES}, got {size!r}")
    work = workdir or tempfile.mkdtemp(prefix="atpu_zero_smoke_")
    os.makedirs(work, exist_ok=True)
    init = launch.rendezvous(work)
    backend, devices = launch.devices_for(dev, world, backend)
    print(f"# zero-smoke: {world} processes, {backend}, devices {devices}, size {size}",
          file=sys.stderr)
    outs = [os.path.join(work, f"rank{r}.json") for r in range(world)]
    t0 = time.perf_counter()
    results = launch.start(
        "accelerate_tpu_torch.parallel.zero_smoke",
        lambda r: ["--child", json.dumps([r, world, init, backend, devices[r], size, outs[r],
                                          model_axes, then])],
        world).wait(CHILD_TIMEOUT_S)
    codes = [code for code, _, _ in results]
    wall = time.perf_counter() - t0
    require(codes == [0] * world, f"zero-smoke children exited {codes}")
    records = []
    for out in outs:
        with open(out) as f:
            records.append(json.load(f))
    return summarize(records, size, wall)


def require(ok: bool, message: str) -> None:
    """Raise ``AssertionError(message)`` unless ``ok`` (also under ``-O``)."""
    if not ok:
        raise AssertionError(message)


def per_rank(records: list) -> list:
    """What the modes must agree on, per process: the summary carries it so
    a caller can check it again."""
    keys = ("zero_active", "losses", "health", "grad_norm", "digest", "dispatches")
    return [{"rank": rec["rank"], **{k: {m: rec[m][k] for m in ("replicated", "zero")}
                                     for k in keys}} for rec in records]


def summarize(records: list, size: str, wall: float) -> dict:
    """Check the requirements over every process's record; the summary."""
    world = len(records)
    steps = STEPS[size]
    first = records[0]
    for rec in records:
        r, rep, zero = rec["rank"], rec["replicated"], rec["zero"]
        require(zero["zero_active"] and not rep["zero_active"], f"rank {r}: ZeRO did not "
                f"activate ({zero['zero_active']}) or the replicated step did")
        require(rep["losses"] == zero["losses"],
                f"rank {r}: losses diverged between replicated and ZeRO steps:\n"
                f"  replicated {rep['losses']}\n  zero       {zero['losses']}")
        for norm in ("health", "grad_norm"):
            require(rep[norm] == zero[norm], f"rank {r}: the {norm} norms diverged between "
                    f"replicated {rep[norm]} and ZeRO {zero[norm]}")
        require(rep["digest"] == zero["digest"], f"rank {r}: parameters diverged")
        require(zero["losses"] == first["zero"]["losses"], "losses differ across processes")
        require(zero["health"] == first["zero"]["health"], "norms differ across processes")
        require(zero["digest"] == first["zero"]["digest"], "parameters differ across processes")
        require(rep["dispatches"] == zero["dispatches"] == steps,
                f"rank {r}: step calls {rep['dispatches']} / {zero['dispatches']}, want {steps}")
        require(min(rep["health"]) > CLIP, f"the clip did not bind: norms {rep['health']}")
        ratio = rep["state_bytes"] / zero["state_bytes"]
        require(ratio > world * 0.9, f"opt state did not shrink {world}-fold: "
                f"{rep['state_bytes']} -> {zero['state_bytes']} B per process")
        param_bytes = zero["param_bytes"]
        for c in zero["comm"]:
            rs = c.get("reduce_scatter", {}).get("bytes", 0)
            ag = c.get("all_gather", {}).get("bytes", 0)
            require(abs(rs - param_bytes) / param_bytes < 0.10,
                    f"reduce-scatter bytes {rs}, parameter bytes {param_bytes}")
            require(abs(ag - param_bytes) / param_bytes < 0.10,
                    f"all-gather bytes {ag}, parameter bytes {param_bytes}")
        for c in rep["comm"]:
            ar = c.get("all_reduce", {}).get("bytes", 0)
            require(abs(ar - param_bytes) / param_bytes < 0.10,
                    f"all-reduce bytes {ar}, parameter bytes {param_bytes}")
    summary = {
        "size": size, "world": world, "backend": first["backend"],
        "devices": [r["device"] for r in records], "steps": steps,
        "losses": first["zero"]["losses"], "wall_s": wall,
        "state_bytes": {"replicated": first["replicated"]["state_bytes"],
                        "zero": first["zero"]["state_bytes"]},
        "allocator_state_bytes": {"replicated": first["replicated"]["allocator_state_bytes"],
                                  "zero": first["zero"]["allocator_state_bytes"]},
        "param_alloc_bytes": first["replicated"]["param_alloc_bytes"],
        "step_s": {m: [r[m]["step_s"] for r in records] for m in ("replicated", "zero")},
        "build_s": {m: [r[m]["build_s"] for r in records] for m in ("replicated", "zero")},
        "staged_s": {m: [r[m]["staged_s"] for r in records] for m in ("replicated", "zero")},
        "comm_per_step": {m: first[m]["comm"][-1] for m in ("replicated", "zero")},
        "launches": {m: [r[m]["launches"] for r in records] for m in ("replicated", "zero")},
        "rows": [r["replicated"]["rows"] for r in records],
        "peak_bytes": [r["replicated"]["peak_bytes"] for r in records],
        "child_s": [r["seconds"] for r in records],
        "per_rank": per_rank(records),
    }
    if any(mode in first for mode in MODEL_AXES):
        summary["model_axes"] = {mode: [rec[mode] for rec in records] for mode in MODEL_AXES}
    if "then" in first:
        summary["then"] = [rec["then"] for rec in records]
        summary["then_seconds"] = [rec["then_seconds"] for rec in records]
    if size == "llama3-8b":
        layers = 2  # llama_config's
        want = {"fused_attention_fwd": 2 * layers, "fused_attention_bwd_dq": layers,
                "fused_attention_bwd_dkv": layers}
        summary["flash_per_step"] = want
        summary["median_step_s"] = {
            m: statistics.median(s for r in records for s in r[m]["step_s"][1:])
            for m in ("replicated", "zero")}
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true", help="gloo processes on the CPU")
    parser.add_argument("--world", type=int, default=2, help="processes (default 2)")
    parser.add_argument("--size", choices=SIZES, default="tiny")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--model-axes", action="store_true",
                        help="also the fsdp=2 and tp=2 modes (two processes, llama3-8b)")
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child is not None:
        child(*json.loads(args.child))
        return 0
    summary = run(args.size, "cpu" if args.cpu else None, args.world, args.workdir,
                  model_axes=args.model_axes)
    if args.size == "llama3-8b":
        for mode in ("replicated", "zero"):
            for r, per_step in enumerate(summary["launches"][mode]):
                require(all(s == summary["flash_per_step"] for s in per_step)
                        or summary["devices"][r] == "cpu",
                        f"{mode} rank {r}: flash launches {per_step}")
    print(f"zero-smoke OK — {summary['steps']} steps bit-exact over {summary['world']} "
          f"processes ({summary['backend']}), opt state {summary['state_bytes']['replicated']} "
          f"-> {summary['state_bytes']['zero']} B per process, 1 step call per optimizer step",
          file=sys.stderr)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
