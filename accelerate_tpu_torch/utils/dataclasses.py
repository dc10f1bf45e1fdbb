"""Configuration objects, enums and ``kwargs_handlers`` of the JAX package's
``accelerate_tpu/utils/dataclasses.py``, under its names, with the fields
the single-GPU ``Accelerator`` reads (dtypes are torch dtypes)."""

from __future__ import annotations

import copy
import enum
import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Optional

import torch

__all__ = [
    "AutocastKwargs",
    "DDPCommunicationHookType",
    "DataLoaderConfiguration",
    "DistributedDataParallelKwargs",
    "DistributedInitKwargs",
    "DistributedType",
    "FP8RecipeKwargs",
    "FullyShardedDataParallelPlugin",
    "GradScalerKwargs",
    "GradientAccumulationPlugin",
    "InitProcessGroupKwargs",
    "KwargsHandler",
    "MixedPrecisionPolicy",
    "ParallelismConfig",
    "PrecisionType",
    "ProfileKwargs",
    "ProjectConfiguration",
    "TensorInformation",
]

_FP8_NOT_PORTED = ("fp8 is not ported to accelerate_tpu_torch yet (ROADMAP.md A8: ops/fp8.py "
                   "on Hopper e4m3/e5m2, with LlamaConfig.fp8 and mixed_precision='fp8')")


class BaseEnum(str, enum.Enum):
    def __str__(self) -> str:
        return self.value

    @classmethod
    def list(cls) -> list:
        return [e.value for e in cls]


class DistributedType(BaseEnum):
    """The JAX package's members but its TPU ones (``TPU_JAX``, ``XLA``),
    plus ``MULTI_GPU``: several processes, one per GPU over NCCL (or over
    gloo on the CPU).  One process is ``NO``."""

    NO = "NO"
    MULTI_GPU = "MULTI_GPU"
    FSDP = "FSDP"
    TP = "TP"
    MULTI_HOST = "MULTI_HOST"
    DEEPSPEED = "DEEPSPEED"
    MEGATRON_LM = "MEGATRON_LM"


class PrecisionType(BaseEnum):
    """``mixed_precision`` values; ``fp16`` computes in bf16 as in the JAX
    package, ``fp8`` is not ported (ROADMAP A8)."""

    NO = "no"
    FP8 = "fp8"
    FP16 = "fp16"
    BF16 = "bf16"


@dataclass
class KwargsHandler:
    """Base of the objects passed in ``Accelerator(kwargs_handlers=[...])``;
    ``to_kwargs`` lists the fields that differ from their defaults."""

    def to_dict(self) -> dict:
        return copy.deepcopy(self.__dict__)

    def to_kwargs(self) -> dict:
        default_dict = self.__class__().to_dict()
        return {k: v for k, v in self.to_dict().items() if default_dict[k] != v}


@dataclass
class DistributedInitKwargs(KwargsHandler):
    """Bring-up of several processes, read by :class:`~.state.PartialState`
    when no process group is up yet: ``coordinator_address`` (``host:port``,
    else ``ACCELERATE_COORDINATOR_ADDRESS`` or torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT``), ``num_processes`` and ``process_id`` (else
    ``ACCELERATE_NUM_PROCESSES`` / ``ACCELERATE_PROCESS_ID``, else
    ``WORLD_SIZE`` / ``RANK``) and ``timeout`` for the group's collectives.
    ``local_device_ids`` is the JAX field; the port places one process on
    ``cuda:LOCAL_RANK``."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_device_ids: Optional[list] = None
    timeout: timedelta = field(default_factory=lambda: timedelta(seconds=1800))


InitProcessGroupKwargs = DistributedInitKwargs


@dataclass
class GradScalerKwargs(KwargsHandler):
    """Loss-scaling configuration.  As in the JAX package no scaler runs:
    ``fp16`` computes in bf16, which needs none."""

    init_scale: float = 65536.0
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True


class DDPCommunicationHookType(str, enum.Enum):
    NO = "no"
    FP16 = "fp16"
    BF16 = "bf16"
    POWER_SGD = "power_sgd"
    BATCHED_POWER_SGD = "batched_power_sgd"


@dataclass
class DistributedDataParallelKwargs(KwargsHandler):
    """DDP knobs, validated as in the JAX package.  ``comm_hook`` ``"fp16"``
    or ``"bf16"`` holds the accumulated gradients in bf16 and syncs them
    over the data-parallel group in bf16 (the JAX ``_grad_sync_dtype``);
    the bucket and graph knobs are kept for the surface: the sync is one
    collective per gradient tensor (:mod:`~accelerate_tpu_torch.optimizer`)."""

    bucket_cap_mb: int = 25
    find_unused_parameters: bool = False
    gradient_as_bucket_view: bool = False
    static_graph: bool = False
    comm_hook: str = "no"

    def __post_init__(self):
        if isinstance(self.comm_hook, DDPCommunicationHookType):
            self.comm_hook = self.comm_hook.value
        if self.comm_hook in (DDPCommunicationHookType.POWER_SGD,
                              DDPCommunicationHookType.BATCHED_POWER_SGD):
            raise ValueError("PowerSGD communication hooks are not supported; use "
                             "comm_hook='bf16' for reduced-precision gradients")
        if self.comm_hook not in ("no", "fp16", "bf16"):
            raise ValueError(f"comm_hook must be 'no', 'fp16' or 'bf16', got {self.comm_hook!r}")


@dataclass
class AutocastKwargs(KwargsHandler):
    """Accepted for the JAX surface: the dtype policy lives in the prepared
    model, so ``Accelerator.autocast`` is a no-op context."""

    enabled: bool = True
    cache_enabled: bool = True


@dataclass
class FP8RecipeKwargs(KwargsHandler):
    """The JAX package's fp8 recipe fields; constructing one raises until
    fp8 is ported (ROADMAP A8)."""

    margin: int = 0
    interval: int = 1
    fp8_format: str = "HYBRID"
    amax_history_len: int = 1024
    amax_compute_algo: str = "max"
    scaling: str = "current"

    def __post_init__(self):
        raise NotImplementedError(_FP8_NOT_PORTED)


@dataclass
class ParallelismConfig:
    """The shape of the named mesh: the JAX ``ParallelismConfig``, one axis
    per strategy, outermost first in ``AXIS_ORDER``.  A size of 1 disables
    the axis.  The port runs one process per GPU, so ``total_size`` is the
    number of processes; ``dcn_dp`` counts nodes and ``dp`` the processes
    of one node.  The model axes (``fsdp``, ``pp``, ``sp``, ``ep``, ``tp``)
    are accepted here and refused by :class:`~.state.AcceleratorState`
    until their ROADMAP part lands."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1
    dcn_dp: int = 1

    AXIS_ORDER = ("dcn_dp", "dp", "fsdp", "pp", "sp", "ep", "tp")

    def __post_init__(self):
        for name in self.AXIS_ORDER:
            size = getattr(self, name)
            if not isinstance(size, int) or size < 1:
                raise ValueError(f"Mesh axis {name!r} must be a positive int, got {size!r}")

    @property
    def total_size(self) -> int:
        n = 1
        for name in self.AXIS_ORDER:
            n *= getattr(self, name)
        return n

    @property
    def active_axes(self) -> dict:
        return {name: getattr(self, name) for name in self.AXIS_ORDER if getattr(self, name) > 1}

    @property
    def data_shard_size(self) -> int:
        """Number of ways the global batch is split (dp-like axes)."""
        return self.dcn_dp * self.dp * self.fsdp

    @classmethod
    def from_env(cls) -> "ParallelismConfig":
        def geti(key, default=1):
            return int(os.environ.get(key, default))

        return cls(
            dp=geti("ACCELERATE_PARALLELISM_DP"),
            fsdp=geti("ACCELERATE_PARALLELISM_FSDP"),
            tp=geti("ACCELERATE_PARALLELISM_TP"),
            sp=geti("ACCELERATE_PARALLELISM_SP"),
            pp=geti("ACCELERATE_PARALLELISM_PP"),
            ep=geti("ACCELERATE_PARALLELISM_EP"),
            dcn_dp=geti("ACCELERATE_PARALLELISM_DCN_DP"),
        )


@dataclass
class FullyShardedDataParallelPlugin:
    """The FSDP strategy on the ``fsdp`` mesh axis: the JAX
    ``FullyShardedDataParallelPlugin``, field for field.

    - ``sharding_strategy``: ``FULL_SHARD`` and ``HYBRID_SHARD`` keep one
      shard of each parameter, its gradient and its optimizer state per
      process on the ``fsdp`` axis (``HYBRID_SHARD`` replicates them over
      ``dcn_dp``); ``SHARD_GRAD_OP`` and ``NO_SHARD`` keep the parameters
      replicated, as the JAX package does (:func:`~..parallel.sharding.make_param_specs`);
      the integer forms 1-4 name them in that order;
    - ``min_num_params``: a parameter with fewer elements stays replicated;
    - ``cpu_offload``: the optimizer's state lives in host memory
      (:mod:`~..parallel.host_offload`);
    - ``state_dict_type``: ``FULL_STATE_DICT`` gathers the full tensors on
      save and re-shards them on load; ``SHARDED_STATE_DICT`` (the default,
      as in the JAX package) and ``LOCAL_STATE_DICT`` raise when a sharded
      model is saved (ROADMAP A6 part 3);
    - ``mixed_precision_policy``: a policy that overrides the
      ``mixed_precision`` mode;
    - ``reshard_after_forward``, ``use_orig_params``, ``sync_module_states``,
      ``auto_wrap_policy``, ``transformer_cls_names_to_wrap``,
      ``activation_checkpointing``, ``fsdp_version``: carried for the JAX
      surface (a layer's weights are gathered where it runs and dropped
      after it; ``prepare`` broadcasts rank 0's values before it shards).

    The ``FSDP_*`` environment variables override the fields, as in the
    JAX package."""

    sharding_strategy: str = "FULL_SHARD"
    reshard_after_forward: bool = True
    cpu_offload: bool = False
    min_num_params: int = 0
    auto_wrap_policy: Any = None
    transformer_cls_names_to_wrap: Optional[list] = None
    state_dict_type: str = "SHARDED_STATE_DICT"
    use_orig_params: bool = True
    sync_module_states: bool = True
    activation_checkpointing: bool = False
    mixed_precision_policy: Optional["MixedPrecisionPolicy"] = None
    fsdp_version: int = 2

    VALID_STRATEGIES = ("FULL_SHARD", "SHARD_GRAD_OP", "NO_SHARD", "HYBRID_SHARD")

    def __post_init__(self):
        from .environment import str_to_bool

        env_prefix = "FSDP_"
        self.sharding_strategy = os.environ.get(
            env_prefix + "SHARDING_STRATEGY", self.sharding_strategy).upper()
        int_map = {"1": "FULL_SHARD", "2": "SHARD_GRAD_OP", "3": "NO_SHARD", "4": "HYBRID_SHARD"}
        self.sharding_strategy = int_map.get(self.sharding_strategy, self.sharding_strategy)
        if self.sharding_strategy not in self.VALID_STRATEGIES:
            raise ValueError(
                f"sharding_strategy must be one of {self.VALID_STRATEGIES}, got "
                f"{self.sharding_strategy}")
        if "FSDP_MIN_NUM_PARAMS" in os.environ:
            self.min_num_params = int(os.environ["FSDP_MIN_NUM_PARAMS"])
        if "FSDP_CPU_OFFLOAD" in os.environ:
            self.cpu_offload = bool(str_to_bool(os.environ["FSDP_CPU_OFFLOAD"]))
        if "FSDP_STATE_DICT_TYPE" in os.environ:
            self.state_dict_type = os.environ["FSDP_STATE_DICT_TYPE"].upper()
        if "FSDP_ACTIVATION_CHECKPOINTING" in os.environ:
            self.activation_checkpointing = bool(
                str_to_bool(os.environ["FSDP_ACTIVATION_CHECKPOINTING"]))
        if (self.transformer_cls_names_to_wrap is None
                and "FSDP_TRANSFORMER_CLS_TO_WRAP" in os.environ):
            self.transformer_cls_names_to_wrap = (
                os.environ["FSDP_TRANSFORMER_CLS_TO_WRAP"].split(","))

    @property
    def shards_parameters(self) -> bool:
        return self.sharding_strategy in ("FULL_SHARD", "HYBRID_SHARD")

    @property
    def shards_grads_and_optimizer(self) -> bool:
        return self.sharding_strategy in ("FULL_SHARD", "HYBRID_SHARD", "SHARD_GRAD_OP")


@dataclass
class TensorInformation:
    """Shape and dtype of one leaf (:func:`~.operations.get_data_structure`)."""

    shape: Any
    dtype: Any


@dataclass
class ProfileKwargs(KwargsHandler):
    """A ``torch.profiler.profile`` session for :meth:`Accelerator.profile`:
    ``activities`` among ``"cpu"`` and ``"cuda"`` (default both, where CUDA
    is up), ``schedule_option`` the keyword arguments of
    ``torch.profiler.schedule``, and a Chrome trace written under
    ``output_trace_dir/profile_<process_index>/`` (dropped without a
    directory)."""

    activities: Optional[list] = None
    schedule_option: Optional[dict] = None
    record_shapes: bool = False
    profile_memory: bool = False
    with_flops: bool = False
    output_trace_dir: Optional[str] = None


@dataclass
class MixedPrecisionPolicy:
    """Parameter storage, compute, output and reduction dtypes of a prepared
    model: the JAX policy in torch dtypes."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32
    reduce_dtype: torch.dtype = torch.float32
    fp8: bool = False
    fp8_recipe: Optional[FP8RecipeKwargs] = None

    @classmethod
    def from_mixed_precision(cls, mixed_precision: Optional[str]) -> "MixedPrecisionPolicy":
        """``"no"`` (or None): fp32 compute; ``"bf16"`` and ``"fp16"``: bf16
        compute over fp32 parameters (fp16 maps to bf16 as in the JAX
        package); ``"fp8"`` raises ``NotImplementedError`` (ROADMAP A8)."""
        if mixed_precision in ("no", None):
            return cls(compute_dtype=torch.float32)
        if mixed_precision in ("bf16", "fp16"):
            return cls()
        if mixed_precision == "fp8":
            raise NotImplementedError(_FP8_NOT_PORTED)
        raise ValueError(f"Unknown mixed_precision {mixed_precision!r}")


@dataclass
class DataLoaderConfiguration:
    """How :meth:`Accelerator.prepare` rebuilds a ``DataLoader``.

    - ``split_batches``: the scheduler steps once per optimizer step (at one
      GPU the batches are the same either way);
    - ``dispatch_batches``: the main process reads each global batch and
      every process gets its rows
      (:class:`~accelerate_tpu_torch.data_loader.DataLoaderDispatcher`);
    - ``even_batches``: with ``static_shape_tail``, the short tail batch is
      filled from the epoch's first samples;
    - ``use_seedable_sampler`` / ``data_seed``: a shuffling sampler becomes a
      :class:`~accelerate_tpu_torch.data_loader.SeedableRandomSampler`
      seeded with ``data_seed`` (42 when None) plus the epoch;
    - ``non_blocking``: host-to-device copies from pinned memory do not
      wait;
    - ``use_stateful_dataloader``: the loader's position within its epoch
      goes into checkpoints (``dl_state_dict.bin``);
    - ``static_shape_tail``: every batch, the tail included, has the full
      batch size;
    - ``prefetch_to_device``: batches a worker thread copies to the device
      ahead of the loop (0: the synchronous one-batch lookahead).
    """

    split_batches: bool = False
    dispatch_batches: Optional[bool] = None
    even_batches: bool = True
    use_seedable_sampler: bool = False
    data_seed: Optional[int] = None
    non_blocking: bool = False
    use_stateful_dataloader: bool = False
    static_shape_tail: bool = False
    prefetch_to_device: int = 0


@dataclass
class GradientAccumulationPlugin(KwargsHandler):
    """``num_steps`` micro-batches per optimizer step (None: 1);
    ``sync_with_dataloader`` also syncs on a dataloader's last batch;
    ``sync_each_batch`` syncs on every batch.  ``adjust_scheduler`` is
    carried for the JAX surface: as there, the scheduler does not step while
    gradients accumulate, whatever its value."""

    num_steps: Optional[int] = None
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False


@dataclass
class ProjectConfiguration:
    """Where checkpoints go: ``<project_dir>/checkpoints/checkpoint_<iteration>``
    under ``automatic_checkpoint_naming``, keeping the newest
    ``total_limit``.  ``logging_dir`` defaults to ``project_dir``."""

    project_dir: Optional[str] = None
    logging_dir: Optional[str] = None
    automatic_checkpoint_naming: bool = False
    total_limit: Optional[int] = None
    iteration: int = 0
    save_on_each_node: bool = False

    def set_directories(self, project_dir: Optional[str] = None) -> None:
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        self.set_directories(self.project_dir)
