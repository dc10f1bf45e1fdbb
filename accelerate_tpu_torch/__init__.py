"""accelerate_tpu_torch: the PyTorch/CUDA port of ``accelerate_tpu``.

A package of its own beside the JAX one, with the same module names.  It
imports ``torch`` and never ``jax`` or ``accelerate_tpu``.  Its entry points
run on the GPU unless the caller passes ``device="cpu"``, and each Pallas
TPU kernel on a ported path becomes a hand-written Hopper kernel
(``ops/csrc/``) with a plain PyTorch version beside it.

Ported so far:

- paged continuous-batching serving of the llama family
  (:meth:`Accelerator.prepare_serving`, ``serving/``, ``models/llama.py``,
  ``models/generation.py``) with the paged decode and verify-window
  attention kernels (``ops/paged_attention.py``), and its robustness
  layer: the host-memory KV tier, int8 KV pools, queue bounds, deadlines,
  the crash-recovery journal and drain under a ``PreemptionGuard``
  (``resilience/preemption.py``), the draft-model drafter and per-request
  serving traces (``serving/tracing.py``, on by default);
- offline generation: greedy and sampled ``generate`` (top-k / top-p
  under an explicit ``utils.random.PRNGKey``), beam search and batch-1
  speculative decoding (``models/generation.py``);
- single-GPU training of the llama family (:meth:`Accelerator.prepare`,
  ``backward``/``accumulate``, :meth:`Accelerator.make_train_step`,
  ``optimizer.py``, ``pipeline/train_step.py``, the training forward and
  loss in ``models/llama.py``, ``ops/chunked_ce.py``,
  ``ops/flash_attention.py``) with the flash-attention forward, dQ and
  dK/dV kernels (``ops/fused_attention.py``), checkpoints
  (``checkpointing.py``), and the single-process ``Accelerator`` surface:
  ``mixed_precision`` (:class:`PreparedModel`), :class:`PartialState` /
  :class:`AcceleratorState`, the process properties and decorators, and
  the operations (``gather_for_metrics``, ``reduce``, ...,
  ``utils/operations.py``), experiment trackers (``tracking.py``),
  ``logging.get_logger``, ``find_executable_batch_size`` and
  ``release_memory`` (``utils/memory.py``), ``LocalSGD`` (a no-op at one
  process) and the environment, import and version helpers of ``utils``;
- GPT-2 (``models/gpt2.py``): training forward and loss, the cached and
  paged forwards (paged serving through the same kernels), generation, and
  its HF import and export;
- the other model families (Mixtral with ``ops/moe.py``, BERT, ViT,
  ResNet, T5) and telemetry (``telemetry/``);
- several processes, one per GPU (``torchrun --nproc-per-node N``): the
  process group and the mesh (:class:`ParallelismConfig`, ``state.py``,
  ``parallel/mesh.py``), data parallelism (each process loads its share,
  the optimizer averages the gradients; ``utils/operations.py``'s
  collectives over the group) and the ZeRO sharded update
  (``parallel/zero.py``, ``make_train_step(zero=True)``), with host offload
  of the optimizer state, multi-process checkpoints, ``LocalSGD``'s average
  and the coordinated ``PreemptionGuard``; FSDP on any prepared model and
  tensor parallelism on the llama family (``parallel/sharding.py``,
  :class:`FullyShardedDataParallelPlugin`), with the DeepSpeed and
  Megatron-LM config dialects (``utils/deepspeed.py``, ``utils/megatron.py``)
  and ``utils/fsdp_utils.py``;
- resilience for one process (``resilience/``): the checkpoint I/O retry
  (``retry.py``), the numerical-health guard (``health.py``,
  :meth:`Accelerator.enable_health_guard`), the JAX package's fault
  injection (``faultinject.py``), the serving chaos campaigns
  (``serving/chaos.py``) and the smoke modules that prove them.

The JAX package's top-level names import from here under the same names;
the data loader, pipeline, resilience and serving ones load on first use.

ROADMAP.md lists what remains.
"""

__version__ = "0.1.0"

from .accelerator import Accelerator, FunctionalModel, PreparedModel  # noqa: E402
from .state import AcceleratorState, GradientState, PartialState  # noqa: E402
from .utils import (  # noqa: E402
    AutocastKwargs,
    DataLoaderConfiguration,
    DDPCommunicationHookType,
    DeepSpeedPlugin,
    DistributedDataParallelKwargs,
    DistributedInitKwargs,
    DistributedType,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    InitProcessGroupKwargs,
    MixedPrecisionPolicy,
    ParallelismConfig,
    ProfileKwargs,
    ProjectConfiguration,
    set_seed,
)

# Imported on first use, as the JAX package does: serving pulls in the
# engine, and the rest is kept off ``import accelerate_tpu_torch``'s path.
_LAZY = {
    "data_loader": ("prepare_data_loader", "skip_first_batches", "DataLoaderShard",
                    "DataLoaderDispatcher"),
    "pipeline": ("make_train_step", "TrainStep", "DevicePrefetcher"),
    "resilience": ("PreemptionGuard", "RetryPolicy", "retrying", "verify_checkpoint",
                   "find_latest_complete", "CheckpointVerificationError"),
    "serving": ("ServingEngine", "ServingConfig", "AdmissionRejected", "ServingJournal"),
    "utils.memory": ("find_executable_batch_size",),
    "local_sgd": ("LocalSGD",),
    "logging": ("get_logger",),
    "utils.imports": ("is_rich_available",),
    "launchers": ("notebook_launcher", "debug_launcher"),
}

__all__ = [
    "Accelerator", "AcceleratorState", "AutocastKwargs", "DDPCommunicationHookType",
    "DataLoaderConfiguration", "DeepSpeedPlugin", "DistributedDataParallelKwargs",
    "DistributedInitKwargs", "DistributedType", "FullyShardedDataParallelPlugin",
    "FunctionalModel", "GradScalerKwargs", "GradientAccumulationPlugin",
    "GradientState", "InitProcessGroupKwargs", "MixedPrecisionPolicy", "ParallelismConfig",
    "PartialState",
    "PreparedModel", "ProfileKwargs", "ProjectConfiguration", "__version__", "set_seed",
    *(name for names in _LAZY.values() for name in names),
]


def __getattr__(name):
    for module, names in _LAZY.items():
        if name in names:
            import importlib

            return getattr(importlib.import_module(f"{__name__}.{module}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
