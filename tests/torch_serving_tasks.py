"""Tasks that every process of a :class:`torch_dp_world.World` runs for
``test_torch_sharded_serving.py``: the port's serving forwards and engine
on meshes with ``tp``, ``fsdp`` and ``ep`` axes, each process holding its
shards as ``prepare`` left them.  Each starts from a fresh port state on the
CPU and returns plain values (numbers, lists, CPU tensors)."""

from __future__ import annotations

import os
import signal
import time

import numpy as np
import torch

from accelerate_tpu_torch.parallel import collectives
from accelerate_tpu_torch.parallel.sharding import layout_of
from torch_ep_tasks import _fresh, _module, build, config


def _prepared(family, np_params, cfg_kw, mesh_kw):
    """``(accelerator, model, cfg)``: the family's model on the JAX weights,
    prepared on ``mesh_kw`` (each process keeps its shards; ``FULL_SHARD``
    where the mesh has an ``fsdp`` axis)."""
    acc = _fresh(mesh_kw, "FULL_SHARD" if mesh_kw.get("fsdp", 1) > 1 else None)
    model = acc.prepare(build(family, np_params, cfg_kw))
    return acc, model, config(family, cfg_kw)


def _heads(family, cfg, layout):
    """The global kv heads this process's cache holds."""
    if family == "gpt2":
        from accelerate_tpu_torch.parallel.sharding import TpView

        heads = TpView(layout, cfg.num_heads).heads
        return list(range(cfg.num_heads)) if heads is None else list(
            range(heads[0], heads[0] + heads[1]))
    from accelerate_tpu_torch.models import llama

    return llama.kv_head_ids(cfg, layout)


def forwards(family, np_params, cfg_kw, mesh_kw, pool, paged, cache):
    """This process's ``apply_paged`` (``kernel`` both ways; the plain
    versions on the CPU) over ``paged`` (``(ids, tables, starts)`` cases)
    against its heads of the whole ``pool``, and its ``apply_cached`` over
    its heads of the whole dense ``cache`` (``(k, v, index, ids)``), on
    the layout its shards give: the logits, the rows and cache rows it
    wrote, its kv heads and the width ``init_cache`` gives it."""
    acc, model, cfg = _prepared(family, np_params, cfg_kw, mesh_kw)
    fam = _module(family)
    params = model.params
    layout = layout_of(params, acc.mesh)
    heads = _heads(family, cfg, layout)
    out = {"heads": heads,
           "init_heads": int(fam.init_cache(cfg, 1, 4, "meta", layout=layout)["k"].shape[-2]),
           "paged": []}
    collectives.reset_comm_log()
    if paged:
        mine = {k: torch.from_numpy(np.ascontiguousarray(v[..., heads, :])) for k, v in
                pool.items()}
        for ids, tables, starts in paged:
            for kernel in (True, False):
                logits, rows = fam.apply_paged(params, torch.from_numpy(ids), cfg, mine,
                                               torch.from_numpy(tables),
                                               torch.from_numpy(starts), kernel=kernel,
                                               layout=layout)
                out["paged"].append({"kernel": kernel, "logits": logits, "rows": rows})
    k, v, index, ids = cache
    dense = {"k": torch.from_numpy(np.ascontiguousarray(k[..., heads, :])),
             "v": torch.from_numpy(np.ascontiguousarray(v[..., heads, :])), "index": index}
    logits, dense = fam.apply_cached(params, torch.from_numpy(ids), cfg, dense, layout=layout)
    out.update(cached=logits, cache_k=dense["k"], cache_v=dense["v"],
               index=int(dense["index"]), comm=sorted(collectives.COMM_LOG))
    return out


def generate_and_apply(np_params, cfg_kw, mesh_kw, ids, max_new):
    """``generate`` of a llama prepared on ``mesh_kw`` (its shards and
    layout) and ``llama.apply`` on the same layout."""
    from accelerate_tpu_torch.models import llama

    _, model, cfg = _prepared("llama", np_params, cfg_kw, mesh_kw)
    ids = torch.from_numpy(ids)
    tokens = model.generate(ids, max_new)
    with torch.no_grad():
        logits = llama.apply(model.params, ids, cfg, layout=model._layout)
    return {"tokens": tokens.tolist(), "logits": logits}


def serve(family, np_params, cfg_kw, mesh_kw, prompts, budgets, geometry, stagger=True):
    """The family's model prepared on ``mesh_kw``, served by
    ``prepare_serving`` over its shards: every request's tokens, the
    engine's counts and this process's pool."""
    acc, model, cfg = _prepared(family, np_params, cfg_kw, mesh_kw)
    fam = _module(family)
    eng = acc.prepare_serving(fam.apply_cached, fam.init_cache, model.params, cfg, **geometry)
    ids = []
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        ids.append(eng.submit(p, m))
        if stagger and i % 2 == 1:
            eng.step()
    outputs = eng.run(max_ticks=3000)
    stats = eng.stats()
    return {"tokens": [outputs[r] for r in ids], "decode_dispatches": eng.decode_dispatches,
            "ticks": eng.ticks, "preempted": stats["preempted"], "spec": stats["spec"],
            "tiering": stats["tiering"], "decode_path": eng.decode_path,
            "pool_shape": {k: list(v.shape) for k, v in eng.cache.pool.items()},
            "pool_bytes": eng.cache.pool_bytes(), "lockstep": eng.layout is not None,
            "used_blocks": eng.cache.allocator.used_blocks}


def _tp_engine(np_params, cfg_kw, geometry):
    acc, model, cfg = _prepared("llama", np_params, cfg_kw, dict(tp=2))
    from accelerate_tpu_torch.models import llama

    return acc, acc.prepare_serving(llama.apply_cached, llama.init_cache, model.params, cfg,
                                    **geometry)


def lockstep_clock(np_params, cfg_kw, geometry, prompts, skew_s, deadline_ms, sleep_s):
    """Two ranks on ``tp=2`` whose clocks disagree by ``skew_s`` (rank 1's
    ``time.monotonic`` moved forward): request 1 arrives at a time both
    ranks are given (rank 0's clock, broadcast) with a deadline of
    ``deadline_ms``, which rank 1's own clock passes at once and rank 0's
    only after ``sleep_s``.  The tick at which each request completed, and
    its status and tokens."""
    real = time.monotonic
    if collectives.rank() == 1:
        time.monotonic = lambda: real() + skew_s
    try:
        _, eng = _tp_engine(np_params, cfg_kw, geometry)
        first = eng.submit(prompts[0], 6)
        t = torch.tensor([time.monotonic() if collectives.rank() == 0 else 0.0],
                         dtype=torch.float64)
        arrival = float(collectives.broadcast(t, src=0)[0])
        late = eng.submit(prompts[1], 6, arrival_t=arrival, deadline_ms=deadline_ms)
        done = {}
        while not eng.sched.idle():
            for c in eng.step():
                done[c.id] = (eng.ticks, c.status, c.tokens)
            if eng.ticks == 1:
                time.sleep(sleep_s)
        return {"first": done[first], "late": done[late], "ticks": eng.ticks,
                "decode_dispatches": eng.decode_dispatches}
    finally:
        time.monotonic = real


def lockstep_sigterm(np_params, cfg_kw, geometry, prompts, at_tick):
    """Two ranks on ``tp=2``, each with an installed preemption guard; rank
    1 signals itself SIGTERM after tick ``at_tick``: the tick at which each
    engine drained and its requeue journal."""
    from accelerate_tpu_torch.resilience import PreemptionGuard

    _, eng = _tp_engine(np_params, cfg_kw, geometry)
    guard = PreemptionGuard(signals=(signal.SIGTERM,)).install()
    try:
        eng.install_preemption_guard(guard)
        for p in prompts:
            eng.submit(p, 8)
        while not eng.drained and eng.ticks < 100:
            eng.step()
            if eng.ticks == at_tick and collectives.rank() == 1 and not guard.preempted_locally():
                os.kill(os.getpid(), signal.SIGTERM)
        return {"drained": eng.drained, "ticks": eng.ticks, "signalled":
                guard.preempted_locally(), "journal": eng.requeue_journal,
                "completed": len(eng.pop_finished())}
    finally:
        guard.uninstall()


def lockstep_misuse(np_params, cfg_kw, geometry, prompts):
    """Two ranks on ``tp=2``; rank 1 submits one request more than rank 0
    before the first tick: the error each rank's first tick raises (None
    where it raised none)."""
    _, eng = _tp_engine(np_params, cfg_kw, geometry)
    for p in prompts[: 1 + collectives.rank()]:
        eng.submit(p, 4)
    try:
        eng.step()
    except ValueError as exc:
        return str(exc)
    return None
