"""Tasks that every process of a 4-process :class:`torch_dp_world.World`
runs for ``test_torch_fsdp_tp.py`` and ``test_torch_dialects.py``: the
port's llama on a mesh with ``fsdp`` and ``tp`` axes, through ``prepare``,
the eager loop and ``make_train_step``.  Each starts from a fresh port
state on the CPU and returns plain values (numbers, CPU tensors)."""

from __future__ import annotations

import os

import torch

from accelerate_tpu_torch import Accelerator, AcceleratorState, ParallelismConfig
from accelerate_tpu_torch.parallel import collectives


def _fresh(**kwargs) -> Accelerator:
    AcceleratorState._reset_state(reset_partial_state=True)
    return Accelerator(cpu=True, **kwargs)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _plugin(strategy, state_dict_type="FULL_STATE_DICT"):
    from accelerate_tpu_torch import FullyShardedDataParallelPlugin

    if strategy is None:
        return None
    return FullyShardedDataParallelPlugin(sharding_strategy=strategy,
                                          state_dict_type=state_dict_type)


def _llama(acc, np_params, cfg_kw, lr, opt_cls=torch.optim.SGD):
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.utils.convert import llama_params_from_jax

    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, **cfg_kw)
    model = tl.LlamaForCausalLM(cfg, params=llama_params_from_jax(np_params, cfg, device="cpu"),
                                device="cpu")
    opt = opt_cls(model.parameters(), lr=lr)
    return acc.prepare(model, opt)


def _mine(acc, batch):
    from accelerate_tpu_torch.parallel.mesh import data_degree, data_index

    n, i = data_degree(acc.mesh), data_index(acc.mesh)
    per = batch["input_ids"].shape[0] // n
    return {k: torch.from_numpy(v[i * per:(i + 1) * per]) for k, v in batch.items()}


def _full(acc, model):
    return {k: v.clone() for k, v in acc.get_state_dict(model).items()}


def mesh_run(np_params, cfg_kw, mesh_kw, strategy, batches, lr):
    """Step 1 in the eager loop (the averaged gradients, gathered, and the
    norm ``clip_grad_norm_`` returns), step 2 through ``make_train_step``;
    the global losses, the full parameters after each step, this process's
    shards as ``prepare`` left them, and the collectives' log keys."""
    from accelerate_tpu_torch.parallel.sharding import gather_full, spec_of

    acc = _fresh(parallelism_config=ParallelismConfig(**mesh_kw), fsdp_plugin=_plugin(strategy))
    model, opt = _llama(acc, np_params, cfg_kw, lr)
    mesh = acc.mesh
    shards = {k: v.detach().clone() for k, v in _flat(model.params).items()}
    specs = {k: spec_of(v) for k, v in _flat(model.params).items()}
    collectives.reset_comm_log()
    loss = model(**_mine(acc, batches[0]))["loss"]
    acc.backward(loss)
    norm = float(acc.clip_grad_norm_(max_norm=1e9))
    grads = {k: gather_full(v.grad, spec_of(v), mesh).clone()
             for k, v in _flat(model.params).items()}
    opt.step()
    opt.zero_grad()
    p1 = _full(acc, model)
    step = acc.make_train_step(model, opt)
    loss2 = step(_mine(acc, batches[1]))
    p2 = _full(acc, model)
    group = opt._dp_group()
    loss1 = collectives.all_reduce(loss.detach().clone(), group=group).div(opt.dp_degree)
    from accelerate_tpu_torch.models import llama as tl

    # Serving this process's shards after the steps: the sharded cached
    # forward on the model's layout, every process the whole logits.
    ids = torch.from_numpy(batches[1]["input_ids"][:1, :4])
    cache = tl.init_cache(model.config, 1, 8, "cpu", layout=model._layout)
    serving, _ = tl.apply_cached(model.params, ids, model.config, cache, layout=model._layout)
    return {"loss": [float(loss1), float(loss2)], "norm": norm, "grads": grads, "p1": p1,
            "p2": p2, "shards": shards, "specs": specs, "coords": mesh.coords(),
            "comm": sorted(collectives.COMM_LOG), "type": str(acc.distributed_type),
            "zero_active": step.zero_active, "param_specs": model._param_specs,
            "serving": serving}


def checkpoint_round_trip(np_params, cfg_kw, mesh_kw, batch, ckpt_dir):
    """``save_state`` after one fused step, a fresh model's ``load_state``,
    then ``save_model`` / ``unwrap_model``: the full weights and the
    optimizer's state must come back; under ``SHARDED_STATE_DICT`` every
    process writes its own shards, which load back bit-identical."""
    acc = _fresh(parallelism_config=ParallelismConfig(**mesh_kw),
                 fsdp_plugin=_plugin("FULL_SHARD"))
    model, opt = _llama(acc, np_params, cfg_kw, 1e-2, torch.optim.AdamW)
    step = acc.make_train_step(model, opt)
    step(_mine(acc, batch))
    acc.save_state(ckpt_dir)
    want = _full(acc, model)
    want_opt = opt.state_dict()["optimizer"]["state"]
    acc2 = _fresh(parallelism_config=ParallelismConfig(**mesh_kw),
                  fsdp_plugin=_plugin("FULL_SHARD"))
    model2, opt2 = _llama(acc2, np_params, cfg_kw, 1e-2, torch.optim.AdamW)
    step2 = acc2.make_train_step(model2, opt2)
    step2(_mine(acc2, batch))  # creates the state the load overwrites
    acc2.load_state(ckpt_dir)
    got = _full(acc2, model2)
    got_opt = opt2.state_dict()["optimizer"]["state"]
    same_opt = all(torch.equal(want_opt[i][k], got_opt[i][k]) for i in want_opt
                   for k in want_opt[i])
    whole = acc2.unwrap_model(model2)
    unwrapped = ({k: v.clone() for k, v in whole.state_dict().items()}
                 if acc2.is_main_process else None)
    out_dir = os.path.join(ckpt_dir, "saved_model")
    acc2.save_model(model2, out_dir)
    acc2.wait_for_everyone()
    files = sorted(os.listdir(out_dir)) if acc2.is_main_process else None
    acc3 = _fresh(parallelism_config=ParallelismConfig(**mesh_kw),
                  fsdp_plugin=_plugin("FULL_SHARD", "SHARDED_STATE_DICT"))
    model3, _ = _llama(acc3, np_params, cfg_kw, 1e-2, torch.optim.AdamW)
    with torch.no_grad():
        for p in model3.parameters():
            p.mul_(0.5)
    acc3.load_state(ckpt_dir)
    acc3.save_state(os.path.join(ckpt_dir, "sharded"))
    sharded_files = sorted(os.listdir(os.path.join(ckpt_dir, "sharded", "model_orbax")))
    with torch.no_grad():
        for p in model3.parameters():
            p.zero_()
    acc3.load_state(os.path.join(ckpt_dir, "sharded"))
    got3 = _full(acc3, model3)
    return {"same": all(torch.equal(want[k], got[k]) for k in want), "same_opt": same_opt,
            "unwrapped": unwrapped, "full": want, "files": files,
            "sharded_same": all(torch.equal(want[k], got3[k]) for k in want),
            "sharded_files": sharded_files,
            "opt_shapes": {i: tuple(v["exp_avg"].shape) for i, v in want_opt.items()}}


def dialect_meshes():
    """The mesh, strategy and ``distributed_type`` each dialect builds on 4
    processes, and the generic FSDP path of a plain module."""
    from accelerate_tpu_torch.utils import DeepSpeedPlugin, MegatronLMPlugin

    out = {}
    cases = {
        "fsdp": dict(fsdp_plugin=_plugin("FULL_SHARD")),
        "ds3": dict(deepspeed_plugin=DeepSpeedPlugin(zero_stage=3)),
        "ds0": dict(deepspeed_plugin=DeepSpeedPlugin(zero_stage=0)),
        "ds_autotp": dict(deepspeed_plugin=DeepSpeedPlugin(hf_ds_config={
            "zero_optimization": {"stage": 2}, "tensor_parallel": {"autotp_size": 2}})),
        "megatron": dict(megatron_lm_plugin=MegatronLMPlugin(tp_degree=2)),
        "megatron_dist": dict(megatron_lm_plugin=MegatronLMPlugin(
            tp_degree=2, use_distributed_optimizer=True)),
        "tp": dict(parallelism_config=ParallelismConfig(dp=2, tp=2)),
    }
    for name, kw in cases.items():
        acc = _fresh(**kw)
        plugin = acc.state.fsdp_plugin
        out[name] = {"mesh": dict(acc.mesh.shape), "type": str(acc.distributed_type),
                     "strategy": None if plugin is None else plugin.sharding_strategy}
    return out


def generic_fsdp(mesh_kw, strategy):
    """A plain ``nn.Module`` under FSDP: its leaves are gathered whole
    before the forward; the loss and gradients against one process."""
    acc = _fresh(parallelism_config=ParallelismConfig(**mesh_kw), fsdp_plugin=_plugin(strategy))
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 4))
    ref = [p.detach().clone() for p in model.parameters()]
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    model, opt = acc.prepare(model, opt)
    g = torch.Generator().manual_seed(1)
    x, y = torch.randn(8, 8, generator=g), torch.randn(8, 4, generator=g)
    n, r = opt.dp_degree, acc.process_index
    from accelerate_tpu_torch.parallel.mesh import data_index

    i = data_index(acc.mesh)
    per = 8 // n
    loss = ((model(x[i * per:(i + 1) * per]) - y[i * per:(i + 1) * per]) ** 2).mean()
    acc.backward(loss)
    opt.step()
    full = acc.get_state_dict(model)
    sharded = [tuple(p.shape) for p in model.parameters()]
    return {"full": {k: v.clone() for k, v in full.items()}, "ref": ref, "x": x, "y": y,
            "sharded": sharded, "wrapped": type(model).__name__, "rank": r}





def dialect_loss(np_params, batch, which):
    """The llama's first global loss under a ZeRO-3 DeepSpeed config or an
    explicit ``fsdp=4`` FSDP plugin, and ``GatheredParameters``' view."""
    from accelerate_tpu_torch.utils import DeepSpeedPlugin, GatheredParameters

    kw = (dict(deepspeed_plugin=DeepSpeedPlugin(zero_stage=3)) if which == "ds"
          else dict(parallelism_config=ParallelismConfig(fsdp=4),
                    fsdp_plugin=_plugin("FULL_SHARD")))
    acc = _fresh(**kw)
    model, opt = _llama(acc, np_params, dict(num_layers=2), 0.1)
    step = acc.make_train_step(model, opt)
    loss = float(step(_mine(acc, batch)))
    embed = model.params["embed"]
    before = tuple(embed.shape)
    with GatheredParameters([embed]):
        inside = tuple(embed.shape)
        value = embed.detach().clone()
    return {"loss": loss, "shapes": [before, inside, tuple(embed.shape)],
            "gathered": value, "full": acc.get_state_dict(model)["embed"],
            "type": str(acc.distributed_type)}
