"""The DeepSpeed config dialect of the JAX ``utils/deepspeed.py``: a
``ds_config.json`` (or the same constructor fields) mapped onto the mesh
and an FSDP strategy, not handed to an engine:

- ZeRO stage 3 -> ``FULL_SHARD`` (parameters, gradients and optimizer state
  sharded on ``fsdp``);
- ZeRO stages 1 and 2 -> ``SHARD_GRAD_OP`` and stage 0 -> ``NO_SHARD``
  (parameters replicated, as the JAX package keeps them);
- ``tensor_parallel.autotp_size`` -> the ``tp`` axis;
- the fp16 / bf16 sections -> ``mixed_precision`` (bf16 compute);
- ``offload_optimizer`` / ``offload_param`` -> ``cpu_offload``, the
  optimizer's state in host memory (:mod:`..parallel.host_offload`);
- gradient accumulation and clipping -> the accumulation steps and a clip
  on every update.

``"auto"`` values are filled from the run at ``prepare`` time
(:meth:`DeepSpeedPlugin.fill_auto`).  ``DummyOptim`` / ``DummyScheduler``
become the torch ``AdamW`` and scheduler they describe there, so scripts
written for "the optimizer comes from the config" run unchanged.
"""

from __future__ import annotations

import io
import json
import os
from copy import deepcopy
from dataclasses import dataclass
from typing import Any, Optional

from .dataclasses import FullyShardedDataParallelPlugin, ParallelismConfig

__all__ = [
    "HfDeepSpeedConfig",
    "DeepSpeedPlugin",
    "DummyOptim",
    "DummyScheduler",
    "get_active_deepspeed_plugin",
]

_ZERO_TO_STRATEGY = {
    0: "NO_SHARD",
    1: "SHARD_GRAD_OP",
    2: "SHARD_GRAD_OP",
    3: "FULL_SHARD",
}


class HfDeepSpeedConfig:
    """A ds_config with nested get and set by dotted key."""

    def __init__(self, config_file_or_dict):
        if isinstance(config_file_or_dict, dict):
            self.config = deepcopy(config_file_or_dict)
        elif isinstance(config_file_or_dict, (str, os.PathLike)):
            with io.open(config_file_or_dict, "r", encoding="utf-8") as f:
                self.config = json.load(f)
        else:
            raise ValueError("Expected a dict or a path to a DeepSpeed JSON config")

    def get_value(self, ds_key_long, default=None):
        node = self.config
        *parents, key = ds_key_long.split(".")
        for p in parents:
            node = node.get(p)
            if node is None:
                return default
        return node.get(key, default)

    def set_value(self, ds_key_long, value):
        node = self.config
        *parents, key = ds_key_long.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = value

    def is_auto(self, ds_key_long) -> bool:
        return self.get_value(ds_key_long) == "auto"

    def is_zero3(self) -> bool:
        return self.get_value("zero_optimization.stage", 0) == 3


@dataclass
class DeepSpeedPlugin:
    """The JAX ``DeepSpeedPlugin``: every field is a mapping onto the mesh
    (module docstring); the ``ACCELERATE_DEEPSPEED_*`` and
    ``ACCELERATE_GRADIENT_*`` environment variables fill what the fields
    leave None."""

    hf_ds_config: Any = None  # dict | path | HfDeepSpeedConfig
    gradient_accumulation_steps: Optional[int] = None
    gradient_clipping: Optional[float] = None
    zero_stage: Optional[int] = None
    is_train_batch_min: bool = True
    offload_optimizer_device: Optional[str] = None
    offload_param_device: Optional[str] = None
    offload_optimizer_nvme_path: Optional[str] = None
    offload_param_nvme_path: Optional[str] = None
    zero3_init_flag: Optional[bool] = None
    zero3_save_16bit_model: Optional[bool] = None
    transformer_moe_cls_names: Optional[str] = None
    enable_msamp: bool = False
    msamp_opt_level: str = "O1"

    def __post_init__(self):
        env = os.environ
        if self.gradient_accumulation_steps is None:
            self.gradient_accumulation_steps = int(
                env.get("ACCELERATE_GRADIENT_ACCUMULATION_STEPS", 1)
            )
        if self.gradient_clipping is None:
            clip = env.get("ACCELERATE_GRADIENT_CLIPPING", "none").lower()
            if clip != "none":
                self.gradient_clipping = float(clip)
        if self.zero_stage is None:
            self.zero_stage = int(env.get("ACCELERATE_DEEPSPEED_ZERO_STAGE", 2))
        if self.offload_optimizer_device is None:
            self.offload_optimizer_device = env.get(
                "ACCELERATE_DEEPSPEED_OFFLOAD_OPTIMIZER_DEVICE", "none"
            )
        if self.offload_param_device is None:
            self.offload_param_device = env.get(
                "ACCELERATE_DEEPSPEED_OFFLOAD_PARAM_DEVICE", "none"
            )
        if self.zero3_save_16bit_model is None:
            self.zero3_save_16bit_model = (
                env.get("ACCELERATE_DEEPSPEED_ZERO3_SAVE_16BIT_MODEL", "false") == "true"
            )
        if self.transformer_moe_cls_names is None:
            self.transformer_moe_cls_names = env.get(
                "ACCELERATE_DEEPSPEED_MOE_LAYER_CLS_NAMES"
            )

        if self.hf_ds_config is not None and not isinstance(self.hf_ds_config, HfDeepSpeedConfig):
            self.hf_ds_config = HfDeepSpeedConfig(self.hf_ds_config)
        if self.hf_ds_config is not None:
            cfg = self.hf_ds_config
            stage = cfg.get_value("zero_optimization.stage")
            if stage is not None and stage != "auto":
                self.zero_stage = int(stage)
            ga = cfg.get_value("gradient_accumulation_steps")
            if ga is not None and ga != "auto":
                self.gradient_accumulation_steps = int(ga)
            clip = cfg.get_value("gradient_clipping")
            if clip is not None and clip != "auto":
                self.gradient_clipping = float(clip)
            off_opt = cfg.get_value("zero_optimization.offload_optimizer.device")
            if off_opt is not None and off_opt != "auto":
                self.offload_optimizer_device = off_opt
            off_par = cfg.get_value("zero_optimization.offload_param.device")
            if off_par is not None and off_par != "auto":
                self.offload_param_device = off_par
            save16 = cfg.get_value("zero_optimization.stage3_gather_16bit_weights_on_model_save")
            if save16 is not None and save16 != "auto":
                self.zero3_save_16bit_model = bool(save16)
        if self.zero_stage not in _ZERO_TO_STRATEGY:
            raise ValueError(f"zero_stage must be 0..3, got {self.zero_stage}")
        if self.zero3_init_flag is None:
            self.zero3_init_flag = self.zero_stage == 3

    # -- dialect translation -------------------------------------------------

    @property
    def sharding_strategy(self) -> str:
        return _ZERO_TO_STRATEGY[self.zero_stage]

    @property
    def cpu_offload(self) -> bool:
        return "cpu" in (self.offload_optimizer_device or "") or "cpu" in (
            self.offload_param_device or ""
        )

    def to_fsdp_plugin(self) -> FullyShardedDataParallelPlugin:
        """The FSDP strategy this config describes."""
        return FullyShardedDataParallelPlugin(
            sharding_strategy=self.sharding_strategy,
            cpu_offload=self.cpu_offload,
        )

    def to_parallelism_config(self, num_devices: int) -> ParallelismConfig:
        """Every process on ``fsdp`` (``dp`` at stage 0), AutoTP's degree on
        ``tp``."""
        tp = 1
        if self.hf_ds_config is not None:
            autotp = self.hf_ds_config.get_value("tensor_parallel.autotp_size", 1)
            if autotp and autotp != "auto":
                tp = int(autotp)
        if num_devices % tp != 0:
            raise ValueError(f"autotp_size {tp} must divide device count {num_devices}")
        if self.zero_stage == 0:
            return ParallelismConfig(dp=num_devices // tp, tp=tp)
        return ParallelismConfig(fsdp=num_devices // tp, tp=tp)

    @property
    def mixed_precision(self) -> Optional[str]:
        if self.hf_ds_config is None:
            return None
        if self.hf_ds_config.get_value("bf16.enabled") is True:
            return "bf16"
        if self.hf_ds_config.get_value("fp16.enabled") is True:
            return "fp16"  # the policy computes it in bf16
        return None

    def fill_auto(self, *, train_micro_batch_size_per_gpu=None, num_devices=1):
        """Fill the ``"auto"`` fields from the run: the micro-batch size, the
        global batch, accumulation, clipping and the ZeRO stage."""
        if self.hf_ds_config is None:
            return
        cfg = self.hf_ds_config
        if train_micro_batch_size_per_gpu is not None:
            if cfg.is_auto("train_micro_batch_size_per_gpu") or cfg.get_value(
                "train_micro_batch_size_per_gpu"
            ) is None:
                cfg.set_value("train_micro_batch_size_per_gpu", train_micro_batch_size_per_gpu)
            if cfg.is_auto("train_batch_size") or cfg.get_value("train_batch_size") is None:
                cfg.set_value(
                    "train_batch_size",
                    train_micro_batch_size_per_gpu
                    * self.gradient_accumulation_steps
                    * num_devices,
                )
        if cfg.is_auto("gradient_accumulation_steps"):
            cfg.set_value("gradient_accumulation_steps", self.gradient_accumulation_steps)
        if cfg.is_auto("gradient_clipping") and self.gradient_clipping is not None:
            cfg.set_value("gradient_clipping", self.gradient_clipping)
        if cfg.is_auto("zero_optimization.stage"):
            cfg.set_value("zero_optimization.stage", self.zero_stage)

    # -- the active plugin ----------------------------------------------------

    def select(self, _from_accelerator_state: bool = False):
        """Make this plugin the active one."""
        global _active_plugin
        _active_plugin = self


_active_plugin: Optional[DeepSpeedPlugin] = None


def get_active_deepspeed_plugin(state=None) -> Optional[DeepSpeedPlugin]:
    """The active plugin: the state's (``state.deepspeed_plugin``, which the
    ``Accelerator`` records), else the last one ``select()`` made active."""
    if state is not None and getattr(state, "deepspeed_plugin", None) is not None:
        return state.deepspeed_plugin
    return _active_plugin


class DummyOptim:
    """Stands for the optimizer of the config: ``prepare`` builds the torch
    ``AdamW`` over ``params`` with its ``lr`` and ``weight_decay``."""

    def __init__(self, params, lr=0.001, weight_decay=0.0, **kwargs):
        self.params = params
        self.lr = lr
        self.weight_decay = weight_decay
        self.kwargs = kwargs


class DummyScheduler:
    """Stands for the scheduler of the config: ``prepare`` builds
    ``lr_scheduler_callable(optimizer)``, else a linear warmup over
    ``warmup_num_steps`` then a constant rate."""

    def __init__(self, optimizer, total_num_steps=None, warmup_num_steps=0, lr_scheduler_callable=None, **kwargs):
        self.optimizer = optimizer
        self.total_num_steps = total_num_steps
        self.warmup_num_steps = warmup_num_steps
        self.lr_scheduler_callable = lr_scheduler_callable
        self.kwargs = kwargs


class DeepSpeedEngineWrapper:
    """DeepSpeed's engine runs backward, step and zero_grad in one
    ``backward()``: this wrapper of a prepared (model, optimizer) pair does
    the same through the owning ``Accelerator``."""

    def __init__(self, engine):
        self.engine = engine  # (model, optimizer) pair or prepared model

    def backward(self, loss, **kwargs):
        if isinstance(self.engine, (tuple, list)):
            model, optimizer = self.engine
        else:
            model, optimizer = self.engine, None
        accelerator = getattr(model, "accelerator", None)
        if accelerator is not None:
            accelerator.backward(loss)
        elif hasattr(loss, "backward"):
            loss.backward()
        else:
            raise TypeError(
                "DeepSpeedEngineWrapper needs a prepared model (or a torch loss "
                f"with .backward); got model={type(model).__name__}"
            )
        state = getattr(optimizer, "gradient_state", None)
        if optimizer is not None and (state is None or state.sync_gradients):
            optimizer.step()
            optimizer.zero_grad()


class DeepSpeedOptimizerWrapper:
    """``step`` and ``zero_grad`` are no-ops: the engine wrapper ran them
    inside ``backward``."""

    def __init__(self, optimizer):
        self.optimizer = optimizer

    def step(self):
        pass

    def zero_grad(self, set_to_none=None):
        pass

    @property
    def step_was_skipped(self) -> bool:
        return getattr(self.optimizer, "step_was_skipped", False)

    def __getattr__(self, name):
        return getattr(self.optimizer, name)


class DeepSpeedSchedulerWrapper:
    """The engine steps the scheduler; ``step`` is a no-op."""

    def __init__(self, scheduler, optimizers):
        self.scheduler = scheduler
        self.optimizers = optimizers

    def step(self):
        pass

    def __getattr__(self, name):
        return getattr(self.scheduler, name)


import contextlib as _contextlib


@_contextlib.contextmanager
def GatheredParameters(params, modifier_rank=None, fwd_module=None, enabled=True):
    """Inside, each sharded leaf of ``params`` (a tensor or an iterable of
    them) holds its full value, gathered from every process (a collective);
    on exit each process keeps its shard again, of the full value rank
    ``modifier_rank`` holds then (None: the values are read only, and the
    shards are restored as they were)."""
    import torch

    from ..parallel import collectives
    from ..parallel.sharding import _leaves, gather_full, is_sharded, local_slice, spec_of
    from ..state import AcceleratorState

    mesh = AcceleratorState._shared_state.get("mesh")
    leaves = [t for t in _leaves(params, torch.Tensor)
              if is_sharded(spec_of(t))] if enabled and mesh is not None else []
    saved = [t.data for t in leaves]
    for t in leaves:
        t.data = gather_full(t, spec_of(t), mesh)
    try:
        yield
    finally:
        for t, shard in zip(leaves, saved):
            if modifier_rank is None:
                t.data = shard
            else:
                collectives.broadcast(t.data, src=modifier_rank, group=mesh.group())
                t.data = local_slice(t.data, spec_of(t), mesh).contiguous().clone()


def map_pytorch_optim_to_deepspeed(optimizer):
    """DeepSpeed would swap in its fused optimizer; the port keeps the torch
    one: returns the input unchanged."""
    return optimizer


def deepspeed_required(func):
    """Decorator: the function runs only under the DeepSpeed dialect
    (``AssertionError`` otherwise)."""
    import functools

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        from ..state import AcceleratorState

        state = AcceleratorState() if AcceleratorState._shared_state else None
        if state is None or get_active_deepspeed_plugin(state) is None:
            raise AssertionError(
                "DeepSpeed is not enabled — pass a DeepSpeedPlugin (or ds_config) "
                "to Accelerator before calling this function."
            )
        return func(*args, **kwargs)

    return wrapper
