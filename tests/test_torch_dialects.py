"""The FSDP plugin and the DeepSpeed and Megatron-LM config dialects in
the port (``utils/dataclasses.py``, ``utils/deepspeed.py``,
``utils/megatron.py``, ``state.py``, ``accelerator.py``), against the JAX
package: the cases of its ``test_fsdp_plugin.py`` and
``test_engine_dialects.py`` that need no pipeline, each plugin's fields
and mappings equal to the JAX one's for the same inputs and environment.
Exact: no tolerance but the dialect-vs-FSDP loss (1e-6, on the same
4-process mesh).  One process on the CPU, and one module-scoped world of 4
gloo processes for the meshes the dialects build.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from accelerate_tpu.models import llama as jl
from accelerate_tpu.parallel import sharding as jsh
from accelerate_tpu.utils import deepspeed as jds
from accelerate_tpu.utils import megatron as jmg
from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JaxFSDP
from accelerate_tpu.utils.dataclasses import ParallelismConfig as JaxParallelismConfig
from accelerate_tpu_torch import Accelerator, AcceleratorState, DistributedType
from accelerate_tpu_torch.parallel import sharding as tsh
from accelerate_tpu_torch.parallel.mesh import Mesh as TorchMesh
from accelerate_tpu_torch.utils import (
    DeepSpeedEngineWrapper,
    DeepSpeedPlugin,
    DummyOptim,
    DummyScheduler,
    FullyShardedDataParallelPlugin,
    GPTTrainStep,
    MegatronLMPlugin,
    get_active_deepspeed_plugin,
    megatron_pipeline_loss_fn,
)
from accelerate_tpu_torch.utils.dataclasses import MixedPrecisionPolicy
from torch_dp_world import World

STRATEGIES = ["FULL_SHARD", "SHARD_GRAD_OP", "NO_SHARD", "HYBRID_SHARD"]
AXES = ("dcn_dp", "dp", "fsdp", "pp", "sp", "ep", "tp")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "deepspeed")
ZERO3_CONFIG = {
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 3, "offload_optimizer": {"device": "none"},
                          "offload_param": {"device": "none"}},
    "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0,
    "train_micro_batch_size_per_gpu": "auto",
    "train_batch_size": "auto",
}


@pytest.fixture(scope="module", autouse=True)
def _restore_jax_global_mesh():
    before = jax.sharding.get_mesh()
    yield
    jax.set_mesh(before)


@pytest.fixture(autouse=True)
def _reset_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    yield
    AcceleratorState._reset_state(reset_partial_state=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("dialect_world"), threads=1)
    yield w
    w.close()


def _fields(obj, names):
    return {n: getattr(obj, n) for n in names}


PLUGIN_FIELDS = ("sharding_strategy", "min_num_params", "cpu_offload", "state_dict_type",
                 "activation_checkpointing", "transformer_cls_names_to_wrap",
                 "shards_parameters", "shards_grads_and_optimizer", "fsdp_version")


# -- the FSDP plugin ------------------------------------------------------------------


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_env_reconstructs_strategy(monkeypatch, strategy, version):
    for spelling in (strategy, str(STRATEGIES.index(strategy) + 1)):
        monkeypatch.setenv("FSDP_SHARDING_STRATEGY", spelling)
        got = FullyShardedDataParallelPlugin(fsdp_version=version)
        assert got.sharding_strategy == strategy
        assert _fields(got, PLUGIN_FIELDS) == _fields(JaxFSDP(fsdp_version=version),
                                                      PLUGIN_FIELDS)


def test_env_reconstructs_all_fields(monkeypatch):
    monkeypatch.setenv("FSDP_SHARDING_STRATEGY", "SHARD_GRAD_OP")
    monkeypatch.setenv("FSDP_MIN_NUM_PARAMS", "2000")
    monkeypatch.setenv("FSDP_CPU_OFFLOAD", "true")
    monkeypatch.setenv("FSDP_STATE_DICT_TYPE", "full_state_dict")
    monkeypatch.setenv("FSDP_ACTIVATION_CHECKPOINTING", "1")
    monkeypatch.setenv("FSDP_TRANSFORMER_CLS_TO_WRAP", "LlamaDecoderLayer,GPT2Block")
    got = FullyShardedDataParallelPlugin()
    assert got.transformer_cls_names_to_wrap == ["LlamaDecoderLayer", "GPT2Block"]
    assert got.state_dict_type == "FULL_STATE_DICT" and got.cpu_offload is True
    assert _fields(got, PLUGIN_FIELDS) == _fields(JaxFSDP(), PLUGIN_FIELDS)


def test_invalid_strategy_raises():
    with pytest.raises(ValueError, match="sharding_strategy") as te:
        FullyShardedDataParallelPlugin(sharding_strategy="ZERO_INFINITY")
    with pytest.raises(ValueError) as je:
        JaxFSDP(sharding_strategy="ZERO_INFINITY")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_to_placement(strategy):
    """FULL / HYBRID shard the parameters on ``fsdp``, SHARD_GRAD_OP and
    NO_SHARD keep them replicated; ``min_num_params`` keeps small arrays
    replicated; both FSDP versions place alike: the JAX specs, leaf for
    leaf."""
    jmesh = JaxMesh(np.array(jax.devices()[:8]).reshape((1, 1, 8, 1, 1, 1, 1)), AXES)
    tmesh = TorchMesh({"fsdp": 8})
    params = {"big": np.zeros((1024, 64), np.float32), "small": np.zeros((8,), np.float32)}
    for min_params in (0, 1000):
        for version in (1, 2):
            want = jsh.make_param_specs(params, jmesh, JaxFSDP(
                sharding_strategy=strategy, min_num_params=min_params, fsdp_version=version))
            got = tsh.make_param_specs(params, tmesh, FullyShardedDataParallelPlugin(
                sharding_strategy=strategy, min_num_params=min_params, fsdp_version=version))
            assert {k: tuple(v) for k, v in want.items()} == got
    big = tsh.make_param_specs(params, tmesh, FullyShardedDataParallelPlugin(
        sharding_strategy=strategy))["big"]
    assert ("fsdp" in big) == (strategy in ("FULL_SHARD", "HYBRID_SHARD"))


def test_plugin_mixed_precision_policy_overrides_mode():
    pol = MixedPrecisionPolicy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    state = AcceleratorState(cpu=True, fsdp_plugin=FullyShardedDataParallelPlugin(
        mixed_precision_policy=pol))
    assert state.dtype_policy is pol
    AcceleratorState._reset_state(reset_partial_state=True)
    state = AcceleratorState(cpu=True, mixed_precision="bf16",
                             fsdp_plugin=FullyShardedDataParallelPlugin())
    assert state.dtype_policy.compute_dtype == torch.bfloat16
    # One process: no fsdp axis, so the type stays NO, as in the JAX package.
    assert state.distributed_type == DistributedType.NO


def test_use_fsdp_env_and_cpu_offload(monkeypatch):
    monkeypatch.setenv("ACCELERATE_USE_FSDP", "true")
    monkeypatch.setenv("FSDP_CPU_OFFLOAD", "1")
    acc = Accelerator(cpu=True)
    assert acc.state.fsdp_plugin.cpu_offload and acc.state.fsdp_plugin.shards_parameters
    model = torch.nn.Linear(4, 2)
    model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1))
    assert "step" in opt.optimizer.__dict__  # host_offload wrapped its step


# -- DeepSpeed -------------------------------------------------------------------------

DS_FIELDS = ("zero_stage", "gradient_accumulation_steps", "gradient_clipping",
             "offload_optimizer_device", "offload_param_device", "zero3_init_flag",
             "zero3_save_16bit_model", "sharding_strategy", "cpu_offload", "mixed_precision")


def _ds_pair(**kw):
    return DeepSpeedPlugin(**kw), jds.DeepSpeedPlugin(**kw)


def _pc(cfg):
    return {a: getattr(cfg, a) for a in AXES}


def test_zero_stage_to_strategy_mapping():
    for stage in range(4):
        got, want = _ds_pair(zero_stage=stage)
        assert _fields(got, DS_FIELDS) == _fields(want, DS_FIELDS)
        assert _fields(got.to_fsdp_plugin(), PLUGIN_FIELDS) == _fields(want.to_fsdp_plugin(),
                                                                       PLUGIN_FIELDS)
    with pytest.raises(ValueError):
        DeepSpeedPlugin(zero_stage=5)


def test_ds_config_parsing(tmp_path):
    path = tmp_path / "ds_config.json"
    path.write_text(json.dumps(ZERO3_CONFIG))
    got, want = _ds_pair(hf_ds_config=str(path))
    assert got.zero_stage == 3 and got.mixed_precision == "bf16" and got.zero3_init_flag
    assert _fields(got, DS_FIELDS) == _fields(want, DS_FIELDS)
    for n in (1, 4, 8):
        assert _pc(got.to_parallelism_config(n)) == _pc(want.to_parallelism_config(n))


def test_ds_offload_and_autotp():
    cfg = {"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}},
           "tensor_parallel": {"autotp_size": 4}}
    got, want = _ds_pair(hf_ds_config=cfg)
    assert got.cpu_offload and got.to_fsdp_plugin().cpu_offload
    assert _pc(got.to_parallelism_config(8)) == _pc(want.to_parallelism_config(8))
    assert got.to_parallelism_config(8).tp == 4


@pytest.mark.parametrize("name,stage,strategy", [("ds_config_zero2.json", 2, "SHARD_GRAD_OP"),
                                                 ("ds_config_zero3.json", 3, "FULL_SHARD")])
def test_fixture_configs_and_fill_auto(name, stage, strategy):
    path = os.path.join(FIXTURES, name)
    got, want = _ds_pair(hf_ds_config=path, gradient_accumulation_steps=4)
    assert got.zero_stage == stage and got.sharding_strategy == strategy
    assert got.hf_ds_config.is_auto("train_micro_batch_size_per_gpu")
    for plugin in (got, want):
        plugin.fill_auto(train_micro_batch_size_per_gpu=16, num_devices=8)
    assert got.hf_ds_config.config == want.hf_ds_config.config
    assert got.hf_ds_config.get_value("train_batch_size") == 16 * 4 * 8
    assert _fields(got.to_fsdp_plugin(), PLUGIN_FIELDS) == _fields(want.to_fsdp_plugin(),
                                                                   PLUGIN_FIELDS)
    if stage == 2:
        assert got.to_fsdp_plugin().cpu_offload is True
    else:
        assert got.zero3_save_16bit_model and got.hf_ds_config.get_value("gradient_clipping") == 1.0


def test_accelerator_with_deepspeed_plugin():
    plugin = DeepSpeedPlugin(hf_ds_config=dict(ZERO3_CONFIG))
    acc = Accelerator(cpu=True, deepspeed_plugin=plugin)
    assert acc.distributed_type == DistributedType.DEEPSPEED
    assert AcceleratorState().distributed_type == DistributedType.DEEPSPEED
    assert acc.mixed_precision == "bf16"
    assert acc.state.fsdp_plugin.sharding_strategy == "FULL_SHARD"
    assert get_active_deepspeed_plugin(acc.state) is plugin
    assert acc.gradient_state.num_steps == 2
    assert DummyOptim(None).lr == 0.001 and DummyScheduler(None).warmup_num_steps == 0


def test_dummy_optim_scheduler_through_prepare():
    plugin = DeepSpeedPlugin(hf_ds_config=dict(ZERO3_CONFIG))
    acc = Accelerator(cpu=True, deepspeed_plugin=plugin)
    model = torch.nn.Linear(4, 1)
    dummy_opt = DummyOptim(model.parameters(), lr=0.01)
    model, opt, sched = acc.prepare(model, dummy_opt, DummyScheduler(dummy_opt,
                                                                     warmup_num_steps=2))
    assert isinstance(opt.optimizer, torch.optim.AdamW) and opt._clip_norm == 1.0
    x = torch.randn(8, 4)
    for _ in range(2):
        with acc.accumulate(model):
            acc.backward(model(x).pow(2).mean())
            opt.step()
            sched.step()
            opt.zero_grad()
    assert opt._step_count == 1
    assert plugin.hf_ds_config.get_value("gradient_accumulation_steps") == 2
    # DeepSpeed's disabled value 0.0 arms no clip.
    AcceleratorState._reset_state(reset_partial_state=True)
    cfg = dict(ZERO3_CONFIG, gradient_clipping=0.0)
    acc = Accelerator(cpu=True, deepspeed_plugin=DeepSpeedPlugin(hf_ds_config=cfg))
    model = torch.nn.Linear(4, 1)
    _, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1))
    assert opt._clip_norm == -1.0


def test_engine_wrapper_steps_in_backward():
    acc = Accelerator(cpu=True)
    model = torch.nn.Linear(4, 1)
    model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1))
    model.accelerator = acc
    before = model.weight.detach().clone()
    DeepSpeedEngineWrapper((model, opt)).backward(model(torch.ones(2, 4)).sum())
    assert not torch.equal(before, model.weight) and model.weight.grad is None


def test_env_contract_activates_dialect(monkeypatch):
    monkeypatch.setenv("ACCELERATE_USE_DEEPSPEED", "true")
    monkeypatch.setenv("ACCELERATE_DEEPSPEED_ZERO_STAGE", "3")
    acc = Accelerator(cpu=True)
    assert acc.distributed_type == DistributedType.DEEPSPEED
    assert acc.state.fsdp_plugin.sharding_strategy == "FULL_SHARD"


# -- Megatron-LM -------------------------------------------------------------------------

MG_FIELDS = ("tp_degree", "pp_degree", "num_micro_batches", "gradient_clipping",
             "sequence_parallelism", "recompute_activations", "use_distributed_optimizer",
             "sp_degree")


def test_megatron_plugin_mesh_mapping():
    for kw in (dict(tp_degree=2, pp_degree=2, num_micro_batches=4),
               dict(tp_degree=2, use_distributed_optimizer=True), dict(tp_degree=4)):
        got, want = MegatronLMPlugin(**kw), jmg.MegatronLMPlugin(**kw)
        assert _fields(got, MG_FIELDS) == _fields(want, MG_FIELDS)
        assert _pc(got.to_parallelism_config(8)) == _pc(want.to_parallelism_config(8))
        assert _fields(got.to_fsdp_plugin(), PLUGIN_FIELDS) == _fields(want.to_fsdp_plugin(),
                                                                       PLUGIN_FIELDS)
    with pytest.raises(ValueError):
        MegatronLMPlugin(tp_degree=3).to_parallelism_config(8)
    got = MegatronLMPlugin(tp_degree=2, sequence_parallelism=True, sp_degree=2)
    assert _pc(got.to_parallelism_config(8)) == _pc(jmg.MegatronLMPlugin(
        tp_degree=2, sequence_parallelism=True, sp_degree=2).to_parallelism_config(8))
    with pytest.warns(UserWarning, match="sp_degree"):
        assert MegatronLMPlugin(tp_degree=2, sequence_parallelism=True).to_parallelism_config(
            8).sp == 1


def test_megatron_env_contract(monkeypatch):
    monkeypatch.setenv("MEGATRON_LM_TP_DEGREE", "4")
    monkeypatch.setenv("MEGATRON_LM_SEQUENCE_PARALLELISM", "true")
    monkeypatch.setenv("MEGATRON_LM_RECOMPUTE_ACTIVATIONS", "1")
    got = MegatronLMPlugin()
    assert got.tp_degree == 4 and got.sequence_parallelism
    assert got.to_fsdp_plugin().activation_checkpointing
    assert _fields(got, MG_FIELDS) == _fields(jmg.MegatronLMPlugin(), MG_FIELDS)


def test_megatron_unported_parts_raise(monkeypatch):
    with pytest.raises(NotImplementedError, match="A7"):
        Accelerator(cpu=True, megatron_lm_plugin=MegatronLMPlugin(pp_degree=2))
    # Sequence parallelism is ported (ROADMAP A6 part 2): without sp_degree
    # the plugin makes no sp axis and says so, as JAX's does.
    with pytest.warns(UserWarning, match="sp_degree"):
        acc = Accelerator(cpu=True,
                          megatron_lm_plugin=MegatronLMPlugin(sequence_parallelism=True))
    assert acc.mesh.shape["sp"] == 1
    AcceleratorState._reset_state(reset_partial_state=True)
    from accelerate_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="A7"):
        megatron_pipeline_loss_fn(MegatronLMPlugin(pp_degree=2), cfg)
    params = tl.init_params(cfg, device="cpu")
    ids = {"input_ids": torch.randint(0, cfg.vocab_size, (2, 8))}
    flat = megatron_pipeline_loss_fn(MegatronLMPlugin(), cfg)
    assert torch.equal(flat(params, ids), tl.loss_fn(params, ids, cfg))
    with pytest.raises(ValueError, match="config"):
        GPTTrainStep().get_forward_step_func()
    acc = Accelerator(cpu=True, megatron_lm_plugin=MegatronLMPlugin())
    assert acc.distributed_type == DistributedType.MEGATRON_LM
    monkeypatch.setenv("ACCELERATE_USE_MEGATRON_LM", "1")
    AcceleratorState._reset_state(reset_partial_state=True)
    assert Accelerator(cpu=True).distributed_type == DistributedType.MEGATRON_LM


# -- on 4 processes --------------------------------------------------------------------


def test_dialects_build_the_jax_meshes(world):
    """Each dialect's mesh, strategy and ``distributed_type`` on 4
    processes: the JAX plugin's ``to_parallelism_config(4)`` and
    ``to_fsdp_plugin()``, and the JAX state's rule for the type."""
    out = world.run("torch_fsdp_tasks:dialect_meshes")[0]
    jax_cases = {
        "ds3": jds.DeepSpeedPlugin(zero_stage=3),
        "ds0": jds.DeepSpeedPlugin(zero_stage=0),
        "ds_autotp": jds.DeepSpeedPlugin(hf_ds_config={
            "zero_optimization": {"stage": 2}, "tensor_parallel": {"autotp_size": 2}}),
        "megatron": jmg.MegatronLMPlugin(tp_degree=2),
        "megatron_dist": jmg.MegatronLMPlugin(tp_degree=2, use_distributed_optimizer=True),
    }
    for name, plugin in jax_cases.items():
        want_mesh = _pc(plugin.to_parallelism_config(4))
        assert out[name]["mesh"] == want_mesh, name
        assert out[name]["strategy"] == plugin.to_fsdp_plugin().sharding_strategy
        assert out[name]["type"] == ("DEEPSPEED" if name.startswith("ds") else "MEGATRON_LM")
    assert out["fsdp"] == {"mesh": _pc(JaxParallelismConfig(fsdp=4)), "type": "FSDP",
                           "strategy": "FULL_SHARD"}
    assert out["tp"] == {"mesh": _pc(JaxParallelismConfig(dp=2, tp=2)), "type": "TP",
                         "strategy": None}


def test_deepspeed_dialect_trains_like_fsdp(world):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, num_layers=2)
    params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(3)
    batch = {"input_ids": rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)}
    ds = world.run("torch_fsdp_tasks:dialect_loss", params, batch, "ds")
    fsdp = world.run("torch_fsdp_tasks:dialect_loss", params, batch, "fsdp")
    want = float(jl.loss_fn(jax.tree.map(jnp.asarray, params), batch, jcfg))
    for a, b in zip(ds, fsdp):
        assert a["type"] == "DEEPSPEED" and b["type"] == "FSDP"
        assert abs(a["loss"] - b["loss"]) < 1e-6 and abs(a["loss"] - want) < 1e-5 * want
        # GatheredParameters: the full leaf inside, the shard again after.
        assert a["shapes"] == [(256, 16), (256, 64), (256, 16)]
        assert torch.equal(a["gathered"], a["full"])
