"""Tasks that every process of a 4-process :class:`torch_dp_world.World`
runs for ``test_torch_ep_tp.py``: each model family of the port on a mesh
with ``ep``, ``fsdp`` and ``tp`` axes, through ``prepare`` and the eager
loop.  Each starts from a fresh port state on the CPU and returns plain
values (numbers, CPU tensors)."""

from __future__ import annotations

import os
import warnings

import torch

from accelerate_tpu_torch import (
    Accelerator,
    AcceleratorState,
    FunctionalModel,
    FullyShardedDataParallelPlugin,
    ParallelismConfig,
)
from accelerate_tpu_torch.parallel import collectives

def _fresh(mesh_kw, strategy=None) -> Accelerator:
    AcceleratorState._reset_state(reset_partial_state=True)
    plugin = (None if strategy is None
              else FullyShardedDataParallelPlugin(sharding_strategy=strategy))
    return Accelerator(cpu=True, parallelism_config=ParallelismConfig(**mesh_kw),
                       fsdp_plugin=plugin)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _module(family):
    import importlib

    return importlib.import_module(f"accelerate_tpu_torch.models.{family}")


def config(family, cfg_kw):
    """The port's tiny config of ``family`` in fp32."""
    fam = _module(family)
    cls = {"llama": "LlamaConfig", "mixtral": "MixtralConfig", "gpt2": "GPT2Config",
           "t5": "T5Config", "bert": "BertConfig", "vit": "ViTConfig",
           "resnet": "ResNetConfig"}[family]
    return getattr(fam, cls).tiny(dtype=torch.float32, **cfg_kw)


def build(family, np_params, cfg_kw, np_stats=None):
    """The port's model of ``family`` on the JAX weights: the llama family
    and Mixtral as their modules, the rest as a ``FunctionalModel`` over
    the family's loss with its rule table and ``handles_layout``.  ResNet's
    running statistics live in ``model.stats``, updated by each training
    forward."""
    from accelerate_tpu_torch.utils import convert

    fam = _module(family)
    cfg = config(family, cfg_kw)
    if family == "llama":
        return fam.LlamaForCausalLM(cfg, params=convert.llama_params_from_jax(
            np_params, cfg, device="cpu"), device="cpu")
    if family == "mixtral":
        return fam.MixtralForCausalLM(cfg, params=convert.mixtral_params_from_jax(
            np_params, cfg, device="cpu"), device="cpu")
    if family == "resnet":
        params, stats = convert.resnet_params_from_jax(np_params, np_stats, cfg, device="cpu")
        box = {"stats": stats}

        def apply_fn(p, layout=None, **batch):
            loss, box["stats"] = fam.classification_loss_fn(p, box["stats"], batch, cfg,
                                                            layout=layout)
            return {"loss": loss}

        model = FunctionalModel(apply_fn, params, partition_rules=fam.PARTITION_RULES,
                                handles_layout=True)
        model.box = box
        return model
    params = getattr(convert, f"{family}_params_from_jax")(np_params, cfg, device="cpu")
    loss = fam.classification_loss_fn if family in ("bert", "vit") else fam.loss_fn

    def apply_fn(p, layout=None, **batch):
        return {"loss": loss(p, batch, cfg, layout=layout)}

    return FunctionalModel(apply_fn, params, partition_rules=fam.PARTITION_RULES,
                           handles_layout=True, splits_sequence=family != "t5")


def _mine(acc, batch):
    from accelerate_tpu_torch.parallel.mesh import data_degree, data_index

    n, i = data_degree(acc.mesh), data_index(acc.mesh)
    per = next(iter(batch.values())).shape[0] // n
    return {k: torch.from_numpy(v[i * per:(i + 1) * per]) for k, v in batch.items()}


def family_step(family, np_params, cfg_kw, mesh_kw, strategy, batch, lr, np_stats=None):
    """One eager SGD step of ``family`` on the mesh: the global loss, every
    gradient gathered to its full shape, this process's own gradients, the
    norm ``clip_grad_norm_`` returns, the full parameters after the step,
    this process's shards as ``prepare`` left them, the specs, the
    collectives' log keys, (ResNet) the new batch statistics, and whether
    the model's layout splits the sequence over ``sp``."""
    from accelerate_tpu_torch.parallel.sharding import gather_full, spec_of

    acc = _fresh(mesh_kw, strategy)
    model = build(family, np_params, cfg_kw, np_stats)
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    model, opt = acc.prepare(model, opt)
    mesh = acc.mesh
    tree = _flat(model.params)
    shards = {k: v.detach().clone() for k, v in tree.items()}
    specs = {k: spec_of(v) for k, v in tree.items()}
    collectives.reset_comm_log()
    loss = model(**_mine(acc, batch))["loss"]
    acc.backward(loss)
    norm = float(acc.clip_grad_norm_(max_norm=1e9))
    local = {k: v.grad.detach().clone() for k, v in tree.items()}
    grads = {k: gather_full(v.grad, spec_of(v), mesh).clone() for k, v in tree.items()}
    opt.step()
    opt.zero_grad()
    p1 = {k: gather_full(v, spec_of(v), mesh).clone() for k, v in tree.items()}
    loss1 = loss.detach().clone()
    if opt.dp_degree > 1:
        loss1 = collectives.all_reduce(loss1, group=opt._dp_group()).div(opt.dp_degree)
    stats = None
    if family == "resnet":
        stats = {k: v.clone() for k, v in _flat(model.box["stats"]).items()}
    layout = getattr(model, "_layout", None)
    return {"loss": float(loss1), "norm": norm, "grads": grads, "local": local, "p1": p1,
            "shards": shards, "specs": specs, "coords": mesh.coords(), "stats": stats,
            "comm": sorted(collectives.COMM_LOG), "param_specs": model._param_specs,
            "split": bool(layout is not None and layout.sp > 1)}


def ragged_checks(mesh_kw):
    """``moe_impl="ragged"`` on ``mesh_kw``: the ``ValueError`` it raises
    (None where none) and the warnings ``_check_moe_impl`` gives; the
    dense impl's warnings on the same mesh."""
    from accelerate_tpu_torch.models import mixtral

    acc = _fresh(mesh_kw)
    del acc
    out = {}
    for impl in ("ragged", "dense"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                mixtral._check_moe_impl(mixtral.MixtralConfig.tiny(moe_impl=impl))
                out[impl] = None
            except ValueError as e:
                out[impl] = str(e)
        out[f"{impl}_warnings"] = [str(w.message) for w in caught]
    return out


def dispatcher_rows(mesh_kw, n_rows):
    """The rows ``prepare``'s ``DataLoaderDispatcher`` gives this process
    over one epoch of ``n_rows`` numbered rows (batch size 2)."""
    from accelerate_tpu_torch.utils.dataclasses import DataLoaderConfiguration

    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(**mesh_kw),
                      dataloader_config=DataLoaderConfiguration(dispatch_batches=True))
    data = [{"x": torch.tensor([i])} for i in range(n_rows)]
    dl = acc.prepare(torch.utils.data.DataLoader(data, batch_size=2))
    rows = [b["x"].reshape(-1).tolist() for b in dl]
    return {"rows": rows, "type": type(dl).__name__, "coords": acc.mesh.coords(),
            "total_batch_size": dl.total_batch_size}


def ep_checkpoint_round_trip(np_params, cfg_kw, mesh_kw, batch, ckpt_dir):
    """Mixtral on an ``ep`` mesh: ``save_state`` after one fused AdamW step,
    a fresh model's ``load_state``, then ``save_model`` / ``unwrap_model``:
    the full weights and the optimizer's state must come back."""
    from accelerate_tpu_torch.parallel.sharding import gather_full, spec_of

    def setup():
        acc = _fresh(mesh_kw)
        model = build("mixtral", np_params, cfg_kw)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
        model, opt = acc.prepare(model, opt)
        return acc, model, opt

    def full(acc, model):
        return {k: v.clone() for k, v in acc.get_state_dict(model).items()}

    acc, model, opt = setup()
    step = acc.make_train_step(model, opt)
    step(_mine(acc, batch))
    acc.save_state(ckpt_dir)
    want = full(acc, model)
    want_opt = opt.state_dict()["optimizer"]["state"]
    acc2, model2, opt2 = setup()
    step2 = acc2.make_train_step(model2, opt2)
    step2(_mine(acc2, batch))  # creates the state the load overwrites
    acc2.load_state(ckpt_dir)
    got = full(acc2, model2)
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
    w_gate = model2.params["layers"]["w_gate"]
    local_gate = tuple(w_gate.shape)
    full_gate = tuple(gather_full(w_gate, spec_of(w_gate), acc2.mesh).shape)
    return {"same": all(torch.equal(want[k], got[k]) for k in want), "same_opt": same_opt,
            "unwrapped": unwrapped, "full": want, "files": files,
            "gate_shapes": [local_gate, full_gate],
            "opt_shapes": {i: tuple(v["exp_avg"].shape) for i, v in want_opt.items()}}
