"""Configuration objects, enums and ``kwargs_handlers`` of the JAX package's
``accelerate_tpu/utils/dataclasses.py``, under its names, with the fields
the single-GPU ``Accelerator`` reads (dtypes are torch dtypes)."""

from __future__ import annotations

import copy
import enum
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
    "GradScalerKwargs",
    "GradientAccumulationPlugin",
    "InitProcessGroupKwargs",
    "KwargsHandler",
    "MixedPrecisionPolicy",
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
    plus ``MULTI_GPU`` for several processes over NCCL (ROADMAP A6).  One
    process is ``NO``."""

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
    """Bring-up of several processes (ROADMAP A6); one process reads none
    of it."""

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
    """DDP knobs, validated as in the JAX package.  One process syncs no
    gradient, so none of them acts yet (ROADMAP A6)."""

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
    - ``dispatch_batches``: carried for the JAX surface (one process reads
      every batch itself);
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
