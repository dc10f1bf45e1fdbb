"""Tasks that every process of a :class:`torch_dp_world.World` runs for
``test_torch_elastic.py`` and ``test_torch_checkpoint_formats.py``: saves
across processes and their resumes on other meshes and world sizes.  Each
starts from a fresh port state on the CPU and returns plain values."""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, AcceleratorState, ParallelismConfig
from accelerate_tpu_torch.resilience.elastic import state_digest

LR = 0.1
MOMENTUM = 0.9


def _fresh(**kwargs) -> Accelerator:
    AcceleratorState._reset_state(reset_partial_state=True)
    return Accelerator(cpu=True, **kwargs)


def _plugin(state_dict_type):
    from accelerate_tpu_torch import FullyShardedDataParallelPlugin

    return FullyShardedDataParallelPlugin(state_dict_type=state_dict_type)


def _mine(acc, batch):
    from accelerate_tpu_torch.parallel.mesh import data_degree, data_index

    n, i = data_degree(acc.mesh), data_index(acc.mesh)
    per = batch["input_ids"].shape[0] // n
    return {k: torch.from_numpy(v[i * per:(i + 1) * per]) for k, v in batch.items()}


def _llama_on(mesh_kw, state_dict_type, zero, np_params, project_dir=None):
    """A tiny fp32 llama from JAX's weights on ``mesh_kw`` (an FSDP plugin
    with ``state_dict_type`` where it has an ``fsdp`` axis), under SGD with
    momentum, through ``make_train_step``."""
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.utils import ProjectConfiguration
    from accelerate_tpu_torch.utils.convert import llama_params_from_jax

    kw = {}
    if mesh_kw:
        kw["parallelism_config"] = ParallelismConfig(**mesh_kw)
    if mesh_kw.get("fsdp", 1) > 1:
        kw["fsdp_plugin"] = _plugin(state_dict_type)
    if project_dir is not None:
        kw["project_config"] = ProjectConfiguration(project_dir=project_dir)
    acc = _fresh(**kw)
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, num_layers=2)
    model = tl.LlamaForCausalLM(cfg, params=llama_params_from_jax(np_params, cfg, device="cpu"),
                                device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    model, opt = acc.prepare(model, opt)
    step = acc.make_train_step(model, opt, zero=zero)
    return acc, model, opt, step


def save_task(np_params, mesh_kw, state_dict_type, zero, batch, root):
    """One step on ``batch``, then a verified save under ``root``; the
    digest, and on rank 0 the full parameters and momentum buffers."""
    acc, model, opt, step = _llama_on(mesh_kw, state_dict_type, zero, np_params)
    loss = float(step(_mine(acc, batch)))
    acc.save_state(os.path.join(root, "checkpoint_0"), step=1)
    digest = state_digest(acc)
    full = {k: v.clone() for k, v in acc.get_state_dict(model).items()}
    sd = opt.state_dict()["optimizer"]
    module = getattr(model, "module", model)
    by_id = {id(t): name for name, t in module.state_dict(keep_vars=True).items()}
    names = [by_id[id(p)] for p in opt.params]
    bufs = {names[int(i)]: st["momentum_buffer"].clone() for i, st in sd["state"].items()}
    files = sorted(os.listdir(os.path.join(root, "checkpoint_0")))
    out = {"digest": digest, "loss": loss, "zero_active": step.zero_active, "files": files}
    if acc.is_main_process:
        out.update(params=full, bufs=bufs)
    return out


def resume_task(np_params, mesh_kw, state_dict_type, zero, batch, root):
    """A fresh model on ``mesh_kw`` (weights scaled away from the saved
    ones), ``resume_from_latest(root)``, the digest, then one step on
    ``batch``: the loss and (rank 0) the full parameters after it."""
    acc, model, opt, step = _llama_on(mesh_kw, state_dict_type, zero, np_params)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    resumed = acc.resume_from_latest(root)
    info = acc.last_resume_info
    digest = state_digest(acc)
    loss = float(step(_mine(acc, batch)))
    full = {k: v.clone() for k, v in acc.get_state_dict(model).items()}
    return {"resumed": resumed, "digest": digest, "loss": loss, "resharded": info.resharded,
            "changes": list(info.plan.changes), "zero_active": step.zero_active,
            "mesh": {a: s for a, s in acc.mesh.shape.items() if s > 1},
            "params": full if acc.is_main_process else None}


# -- RNG streams across a world-size change ----------------------------------------------------


def rng_save_task(ckpt, seed):
    """``set_seed(seed)``, each rank's streams advanced by its own count,
    a verified save; the python and numpy draws that follow it."""
    from accelerate_tpu_torch.utils.random import set_seed

    acc = _fresh()
    set_seed(seed)
    for _ in range(acc.process_index + 1):
        random.random()
        np.random.rand()
    acc.save_state(ckpt, step=1)
    return {"python": random.random(), "numpy": float(np.random.rand())}


def rng_load_task(ckpt):
    """``load_state(ckpt)``; the python and numpy draws that follow."""
    acc = _fresh()
    random.seed(12345)
    np.random.seed(12345)
    acc.load_state(ckpt)
    return {"python": random.random(), "numpy": float(np.random.rand())}


# -- the dataloader across a global-batch change -----------------------------------------------


def _collate(items):
    return {"x": torch.tensor(items, dtype=torch.float32)}


def loader_save_task(root, per_rank, steps):
    """A loader over 0..255 with ``per_rank`` rows a process; ``steps``
    global batches consumed, then a save recording ``step=steps``; the rows
    this process saw."""
    from torch.utils.data import DataLoader

    from accelerate_tpu_torch.utils import ProjectConfiguration

    acc = _fresh(project_config=ProjectConfiguration(project_dir=root))
    dl = acc.prepare(DataLoader(list(range(256)), batch_size=per_rank, collate_fn=_collate))
    it = iter(dl)
    seen = [int(v) for _ in range(steps) for v in next(it)["x"].reshape(-1).tolist()]
    acc.save_state(os.path.join(root, "checkpoints", "checkpoint_0"), step=steps)
    return {"seen": seen, "global_batch": dl.total_batch_size}


def loader_resume_task(root, per_rank):
    """A loader with ``per_rank`` rows a process, ``resume_from_latest``,
    then the rows of the rest of the epoch after the recomputed skip, batch
    by batch."""
    from torch.utils.data import DataLoader

    acc = _fresh()
    dl = acc.prepare(DataLoader(list(range(256)), batch_size=per_rank, collate_fn=_collate))
    resumed = acc.resume_from_latest(os.path.join(root, "checkpoints"))
    info = acc.last_resume_info
    rest = [[int(v) for v in b["x"].reshape(-1).tolist()]
            for b in acc.skip_first_batches(dl, info.skip_batches)]
    return {"resumed": resumed, "skip": info.skip_batches, "rest": rest,
            "global_batch": dl.total_batch_size}


# -- the checkpoint formats on an fsdp mesh ----------------------------------------------------


def _toy_fsdp(state_dict_type, seed=0):
    from accelerate_tpu_torch import FunctionalModel

    acc = _fresh(parallelism_config=ParallelismConfig(fsdp=2),
                 fsdp_plugin=_plugin(state_dict_type))
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(8, 6, generator=g), "b": torch.randn(6, generator=g)}
    model = FunctionalModel(lambda p, x: {"loss": torch.tanh(x @ p["w"] + p["b"]).sum()}, params)
    model, opt = acc.prepare(model, torch.optim.Adam(model.parameters(), lr=1e-2))
    step = acc.make_train_step(model, opt)
    x = torch.randn(4, 8, generator=g)
    step({"x": x[acc.process_index * 2:(acc.process_index + 1) * 2]})
    return acc, model, opt


def formats_task(ckpt_root, state_dict_type):
    """Save under ``state_dict_type`` on ``fsdp=2`` with a pre-hook that
    records its weights list, zero the parameters, load: the files written,
    the hook's list, whether the state came back, and whether the hook's
    weights cost a gather."""
    acc, model, opt = _toy_fsdp(state_dict_type)
    seen = {}
    acc.register_save_state_pre_hook(lambda models, weights, d: seen.setdefault("w", weights))
    before = state_digest(acc)
    gathers = []
    orig = acc.get_state_dict
    acc.get_state_dict = lambda *a, **k: gathers.append(1) or orig(*a, **k)
    ckpt = os.path.join(ckpt_root, state_dict_type.lower())
    acc.save_state(ckpt)
    acc.get_state_dict = orig
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    acc.load_state(ckpt)
    listing = {d: sorted(os.listdir(os.path.join(ckpt, d))) for d in os.listdir(ckpt)
               if os.path.isdir(os.path.join(ckpt, d))}
    return {"files": sorted(os.listdir(ckpt)), "dirs": listing,
            "hook_weights": None if seen.get("w") is None else len(seen["w"]),
            "gathers": len(gathers), "same": state_digest(acc) == before,
            "full": {k: v.clone() for k, v in acc.get_state_dict(model).items()}}


def local_refusal_task(ckpt_root):
    """The LOCAL_STATE_DICT save of ``formats_task`` loaded on a dp=2 mesh
    (the same two processes, every leaf replicated): the error raised."""
    from accelerate_tpu_torch import FunctionalModel

    acc = _fresh(parallelism_config=ParallelismConfig(dp=2))
    params = {"w": torch.zeros(8, 6), "b": torch.zeros(6)}
    model = FunctionalModel(lambda p, x: {"loss": (x @ p["w"]).sum()}, params)
    acc.prepare(model, torch.optim.Adam(model.parameters(), lr=1e-2))
    try:
        acc.load_state(os.path.join(ckpt_root, "local_state_dict"))
    except RuntimeError as e:
        return str(e)
    return None


def async_sharded_task(ckpt_root):
    """``save_state(async_save=True)`` of a sharded model, its parameters
    changed in place right after it returns, then ``wait_for_checkpoint``
    and a load: the state saved is the one before the change."""
    acc, model, opt = _toy_fsdp("SHARDED_STATE_DICT", seed=3)
    before = state_digest(acc)
    ckpt = os.path.join(ckpt_root, "async_sharded")
    acc.save_state(ckpt, async_save=True)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(7.0)
    acc.wait_for_checkpoint()
    changed = state_digest(acc) != before
    acc.load_state(ckpt)
    return {"changed": changed, "restored": state_digest(acc) == before,
            "published": os.path.exists(os.path.join(ckpt, "manifest.json"))}


def reshard_task():
    """``reshard_tree`` on ``fsdp=4``: a full tensor cut onto ``("fsdp",
    None)``, that shard gathered back onto a replicated target, a leaf
    whose target is None passed through."""
    from accelerate_tpu_torch.parallel.sharding import NamedSharding
    from accelerate_tpu_torch.resilience.elastic import reshard_tree

    acc = _fresh(parallelism_config=ParallelismConfig(fsdp=4),
                 fsdp_plugin=_plugin("FULL_STATE_DICT"))
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    keep = torch.ones(3)
    cut = reshard_tree({"w": full, "k": keep}, {"w": ("fsdp", None), "k": None})
    back = reshard_tree({"w": cut["w"]}, {"w": NamedSharding(acc.mesh, (None, None))})
    return {"shard": cut["w"], "spec": cut["w"]._spec, "full_shape": cut["w"]._full_shape,
            "back": back["w"], "kept": cut["k"] is keep}
