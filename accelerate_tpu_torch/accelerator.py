"""The port's ``Accelerator``: device placement, training and serving.

Training, the README's loop (one GPU, or one process per GPU under
``torchrun --nproc-per-node N``)::

    model, optimizer, dataloader, scheduler = accelerator.prepare(
        model, optimizer, dataloader, scheduler)
    for batch in dataloader:
        with accelerator.accumulate(model):
            loss = model(**batch)["loss"]
            accelerator.backward(loss)
            optimizer.step(); scheduler.step(); optimizer.zero_grad()

:meth:`Accelerator.prepare` places models, wraps dataloaders
(:mod:`.data_loader`: batches on the device, the last one flagged before it
is yielded), pairs optimizers with their models and wraps schedulers
(:mod:`.scheduler`); :meth:`~Accelerator.accumulate` syncs every
``gradient_accumulation_steps`` micro-batches and on a dataloader's last
batch; :meth:`~Accelerator.make_train_step` runs the whole optimizer step
in one call with the same numerics.  :meth:`~Accelerator.save_state`,
:meth:`~Accelerator.load_state` and :meth:`~Accelerator.resume_from_latest`
checkpoint all of it (:mod:`.checkpointing`);
:meth:`~Accelerator.enable_preemption_handling` and
:meth:`~Accelerator.enable_health_guard` with their per-step
:meth:`~Accelerator.check_preemption` / :meth:`~Accelerator.check_health`
turn a signal into a final checkpoint and a non-finite step into a skip or
a rewind (:mod:`.resilience`).  Serving:
:meth:`~Accelerator.prepare_serving`.

``Accelerator(mixed_precision="bf16")`` computes each prepared model's
forward with bf16 copies of its fp32 parameters (:class:`PreparedModel`);
the process surface (``print``, ``is_main_process``, ``gather_for_metrics``,
...) is the JAX ``Accelerator``'s (:mod:`.state`, :mod:`.utils.operations`).
With several processes the mesh is pure data parallelism by default:
``prepare`` broadcasts rank 0's parameters, each process loads its rows of
every global batch, and each optimizer step averages the gradients over the
processes (``make_train_step(zero=True)`` reduce-scatters them instead and
updates a shard of the optimizer state per process: :mod:`.parallel.zero`).
With an ``fsdp_plugin`` (or a ``ParallelismConfig`` with ``fsdp`` / ``tp``,
or the DeepSpeed and Megatron-LM config dialects) ``prepare`` keeps only
this process's shard of each parameter (:mod:`.parallel.sharding`): the
forward gathers what it uses, and under ``tp`` the llama family runs
Megatron's tensor parallelism.  Experiment trackers: ``log_with`` with
:meth:`~Accelerator.init_trackers`, :meth:`~Accelerator.log` and
:meth:`~Accelerator.end_training` (:mod:`.tracking`).

Telemetry (:mod:`.telemetry`) is off unless ``ACCELERATE_TPU_TELEMETRY=1``
or ``telemetry.enable()``: then ``prepare``, ``prepare_model`` and
``backward`` run under spans, the loop counts its dispatches (the
forward+backward, the gradient scale, the merge, the update: 3 per
micro-batch in the eager loop, 1 per fused step), ``log`` carries the
registry's scalars, and :meth:`~Accelerator.enable_flight_recorder` arms the
crash-safe recorder with its anomaly-triggered profiler window.

``prepare`` takes an ``nn.Module`` directly, so the JAX package's
``utils/torch_bridge.py`` (FX graph -> JAX lowering of torch modules) has no
counterpart here; functional models come as :class:`FunctionalModel`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import warnings
from typing import Any, Callable, List, Optional

import torch
import torch.utils.data
from torch import nn

from .data_loader import (
    DataLoaderDispatcher,
    DataLoaderShard,
    prepare_data_loader,
    skip_first_batches,
)
from .optimizer import AcceleratedOptimizer
from .parallel.mesh import data_degree, data_index
from .pipeline.train_step import accumulate_grads
from .scheduler import AcceleratedScheduler
from .state import (AcceleratorState, GradientState, PartialState, cpu_requested,
                    resolve_device)
from .telemetry import get_telemetry as _get_telemetry
from .telemetry import maybe_enable_from_env as _telemetry_from_env
from .telemetry import span as _span
from .utils.dataclasses import (
    AutocastKwargs,
    DataLoaderConfiguration,
    DistributedDataParallelKwargs,
    DistributedInitKwargs,
    DistributedType,
    FP8RecipeKwargs,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    KwargsHandler,
    ProfileKwargs,
    ProjectConfiguration,
)
from .utils.modeling import PreparedModel
from .utils.operations import (
    gather,
    gather_object,
    pad_across_processes,
    recursively_apply,
    reduce,
    rename_state_dict,
)

__all__ = ["Accelerator", "FunctionalModel", "PreparedModel"]


class FunctionalModel(nn.Module):
    """A pure ``apply_fn(params, *args, **batch)`` plus its parameter tree
    (nested dicts of tensors): the port's
    ``accelerate_tpu.accelerator.JaxModel``.  The tree's tensor leaves
    become ``nn.Parameter``s (registered, so ``parameters()`` and
    ``.to()`` see them); ``params`` is the tree with those leaves, and
    ``model(**batch)`` is ``apply_fn(params, **batch)``, which returns
    ``{"loss": ...}`` for training.  ``state_dict()`` names each leaf by
    its path in the tree, joined with dots (``layers.wq``), as the JAX
    ``JaxModel.state_dict`` does.  ``params`` is rebuilt from the
    registered leaves on each read, so ``torch.func.functional_call``
    (a :class:`PreparedModel`'s 16-bit copies) reaches ``apply_fn``.
    ``partition_rules`` (path regex -> spec, the JAX ``JaxModel``'s) lay
    its leaves out on a mesh with model axes.  An ``apply_fn`` that sees
    whole leaves gets them gathered over ``fsdp``, and a leaf the rules
    split over ``tp`` or ``ep`` raises there; with ``handles_layout`` the
    ``apply_fn`` takes this process's shards and the
    :class:`~.parallel.sharding.Layout` as ``layout=`` (None off such a
    mesh) and realizes the layout itself, as a family's ``loss_fn`` does
    (``gpt2.loss_fn(params, batch, config, layout=layout)``).
    ``splits_sequence`` declares that ``apply_fn`` runs this process's
    chunk of the sequence on an active ``sp`` axis (GPT-2's, BERT's and
    ViT's losses do; T5's and ResNet's compute the whole), so the
    optimizer sums the gradients over ``sp``."""

    _layout = None

    def __init__(self, apply_fn: Callable, params: Any, partition_rules=None,
                 handles_layout: bool = False, splits_sequence: bool = False):
        super().__init__()
        self.apply_fn = apply_fn
        self.partition_rules = partition_rules
        self._handles_layout = handles_layout
        self.splits_sequence = splits_sequence
        self._leaves = nn.ParameterList()
        names = []

        def wrap(tree, path):
            if isinstance(tree, dict):
                return {k: wrap(v, f"{path}{k}.") for k, v in tree.items()}
            if isinstance(tree, torch.Tensor):
                self._leaves.append(tree if isinstance(tree, nn.Parameter) else nn.Parameter(tree))
                names.append(path[:-1])
                return _Leaf(len(self._leaves) - 1)
            return tree

        self._structure = wrap(params, "")
        rename_state_dict(self, {f"_leaves.{i}": n for i, n in enumerate(names)})

    @property
    def params(self):
        def build(tree):
            if isinstance(tree, dict):
                return {k: build(v) for k, v in tree.items()}
            return self._leaves[tree.index] if isinstance(tree, _Leaf) else tree

        return build(self._structure)

    def forward(self, *args, **kwargs):
        if self._handles_layout:
            kwargs["layout"] = self._layout
        return self.apply_fn(self.params, *args, **kwargs)

    def handles_layout(self) -> bool:
        """Whether ``apply_fn`` realizes a sharded layout itself."""
        return self._handles_layout


class _Leaf:
    """Where a parameter sits in a :class:`FunctionalModel`'s tree."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


class _RemovableHandle:
    """Handle returned by the ``register_*_pre_hook`` methods."""

    _ids = itertools.count()

    def __init__(self, registry: dict):
        self._registry = registry
        self.id = next(self._ids)

    def remove(self) -> None:
        self._registry.pop(self.id, None)


class Accelerator:
    """``Accelerator()`` runs on the GPU (raising without CUDA); ``cpu=True``
    or ``device="cpu"`` keeps everything on the host.  The device is the
    process's, ``state.device``: an ``Accelerator`` that names another
    device than a live state raises.  The other arguments keep the JAX
    ``Accelerator``'s names:

    - ``mixed_precision``: ``"no"``, ``"bf16"`` or ``"fp16"`` (bf16 compute,
      as in the JAX package; ``"fp8"`` raises until ROADMAP A8), else
      ``ACCELERATE_MIXED_PRECISION``; held in :attr:`state`, an
      :class:`~accelerate_tpu_torch.state.AcceleratorState`;
    - ``gradient_accumulation_steps`` (or a ``gradient_accumulation_plugin``):
      micro-batches per optimizer step;
    - ``dataloader_config`` (or ``split_batches``, ``even_batches``,
      ``dispatch_batches``, ``use_seedable_sampler``): how ``prepare``
      rebuilds dataloaders;
    - ``device_placement``: ``prepare`` moves models and batches to the
      device (False leaves them where they are);
    - ``project_dir`` / ``project_config``: where checkpoints go;
    - ``step_scheduler_with_optimizer``: the scheduler holds back while
      gradients accumulate;
    - ``kwargs_handlers``: at most one each of :class:`AutocastKwargs`,
      :class:`ProfileKwargs`, :class:`GradScalerKwargs`,
      :class:`DistributedDataParallelKwargs` and
      :class:`DistributedInitKwargs`, kept in ``autocast_handler``,
      ``profile_handler``, ``scaler_handler``, ``ddp_handler`` and
      ``init_handler`` (:meth:`profile` reads its handler; a ``comm_hook``
      of ``"fp16"`` or ``"bf16"`` makes :meth:`backward` hold the
      accumulated gradients' values in bf16 and the optimizer sync them in
      bf16, as the JAX ``PreparedModel`` does; ``init_handler`` starts the
      process group; no loss is scaled, so the scaler's is held only);
    - ``parallelism_config``: the mesh
      (:class:`~accelerate_tpu_torch.utils.dataclasses.ParallelismConfig`;
      default pure data parallelism over the processes, or every process
      on ``fsdp`` with an ``fsdp_plugin``);
    - ``fsdp_plugin``: a
      :class:`~accelerate_tpu_torch.utils.dataclasses.FullyShardedDataParallelPlugin`
      (else one under ``ACCELERATE_USE_FSDP``);
    - ``deepspeed_plugin`` / ``megatron_lm_plugin``: a config dialect
      (:mod:`~accelerate_tpu_torch.utils.deepspeed`,
      :mod:`~accelerate_tpu_torch.utils.megatron`; else one under
      ``ACCELERATE_USE_DEEPSPEED`` / ``ACCELERATE_USE_MEGATRON_LM``),
      mapped onto the mesh and an FSDP strategy as in the JAX package
      (an explicit ``fsdp_plugin`` / ``parallelism_config`` wins), with its
      ``mixed_precision``, accumulation and clipping, and
      ``distributed_type`` ``DEEPSPEED`` / ``MEGATRON_LM``;
    - ``rng_types``: kept for the JAX surface (the loaders' samplers are
      seeded alike on every process);
    - ``log_with``: a tracker name (``"generic"``, the JSONL tracker;
      ``"tensorboard"``, ``"wandb"``, ...; ``"all"``), a
      :class:`~accelerate_tpu_torch.tracking.GeneralTracker`, or a list of
      them; :meth:`init_trackers` builds them under ``logging_dir``,
      :meth:`log` writes to each, :meth:`end_training` closes them.
    """

    def __init__(self, device_placement: bool = True, split_batches: bool = False,
                 mixed_precision: Optional[str] = None, gradient_accumulation_steps: int = 1,
                 cpu: bool = False, dataloader_config: Optional[DataLoaderConfiguration] = None,
                 log_with=None, project_dir: Optional[str] = None,
                 project_config: Optional[ProjectConfiguration] = None,
                 gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
                 step_scheduler_with_optimizer: bool = True,
                 kwargs_handlers: Optional[List[KwargsHandler]] = None,
                 rng_types: Optional[list] = None, even_batches: bool = True,
                 dispatch_batches: Optional[bool] = None, use_seedable_sampler: bool = False,
                 device=None, parallelism_config=None, fsdp_plugin=None, deepspeed_plugin=None,
                 megatron_lm_plugin=None):
        cpu = cpu_requested(cpu, device)
        if cpu and device is not None and str(device) != "cpu":
            raise ValueError(f"cpu=True contradicts device={device!r}")
        self.ddp_handler = None
        self.scaler_handler = None
        self.init_handler = None
        self.autocast_handler = None
        self.profile_handler = None
        self.fp8_recipe_handler = None
        slots = {DistributedDataParallelKwargs: "ddp_handler", GradScalerKwargs: "scaler_handler",
                 DistributedInitKwargs: "init_handler", AutocastKwargs: "autocast_handler",
                 ProfileKwargs: "profile_handler", FP8RecipeKwargs: "fp8_recipe_handler"}
        for handler in kwargs_handlers or []:
            if not isinstance(handler, KwargsHandler):
                raise ValueError(f"Unsupported kwargs handler: {handler!r}")
            slot = slots.get(type(handler))
            if slot is None:
                raise ValueError(f"Unsupported kwargs handler type: {type(handler).__name__}")
            if getattr(self, slot) is not None:
                raise ValueError(
                    f"You can only pass one {type(handler).__name__} in `kwargs_handlers`.")
            setattr(self, slot, handler)
        # A live state is asked with the device named in full, so one on
        # another device raises; a fresh one picks cuda:LOCAL_RANK itself
        # when several processes run.
        if AcceleratorState._shared_state or PartialState._shared_state:
            device = resolve_device("cpu" if cpu else device)
        deepspeed_plugin, megatron_lm_plugin, ds_plugins = _dialects(deepspeed_plugin,
                                                                     megatron_lm_plugin)
        self._deepspeed_plugin = deepspeed_plugin
        self.megatron_lm_plugin = megatron_lm_plugin
        dialect = deepspeed_plugin or megatron_lm_plugin
        if dialect is not None:
            if megatron_lm_plugin is not None:
                _refuse_megatron_parts(megatron_lm_plugin)
            world = PartialState(cpu, device=device,
                                 init_kwargs=self.init_handler).num_processes
            if parallelism_config is None:
                parallelism_config = dialect.to_parallelism_config(world)
            if fsdp_plugin is None:
                fsdp_plugin = dialect.to_fsdp_plugin()
        if deepspeed_plugin is not None:
            if mixed_precision is None:
                mixed_precision = deepspeed_plugin.mixed_precision
            if gradient_accumulation_steps == 1:
                gradient_accumulation_steps = deepspeed_plugin.gradient_accumulation_steps
            deepspeed_plugin.select()
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu, device=device,
                                      parallelism_config=parallelism_config,
                                      fsdp_plugin=fsdp_plugin, init_kwargs=self.init_handler)
        if dialect is not None:
            # As the JAX package does: the dialect rewrites distributed_type on
            # the shared state, so every reader agrees.
            self.state.deepspeed_plugin = deepspeed_plugin
            if deepspeed_plugin is not None:
                self.state.deepspeed_plugins = ds_plugins or {"default": deepspeed_plugin}
            self.state.megatron_lm_plugin = megatron_lm_plugin
            self.state.distributed_type = (DistributedType.DEEPSPEED if deepspeed_plugin
                                           is not None else DistributedType.MEGATRON_LM)
        self.device = self.state.device
        self.project_configuration = project_config or ProjectConfiguration()
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
        self.dataloader_config = dataloader_config or DataLoaderConfiguration(
            split_batches=split_batches, dispatch_batches=dispatch_batches,
            even_batches=even_batches, use_seedable_sampler=use_seedable_sampler)
        self.gradient_state = GradientState(
            gradient_accumulation_plugin
            or GradientAccumulationPlugin(num_steps=gradient_accumulation_steps))
        self.device_placement = device_placement
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        self.rng_types = rng_types or ["generator"]
        self.log_with: list = (log_with if isinstance(log_with, (list, tuple))
                               else ([log_with] if log_with else []))
        self.trackers: list = []
        self.flag_tensor = None
        self._models: List[nn.Module] = []
        self._optimizers: List[AcceleratedOptimizer] = []
        self._schedulers: List[AcceleratedScheduler] = []
        self._dataloaders: List[DataLoaderShard] = []
        self._custom_objects: list = []
        self._save_state_pre_hooks: dict = {}
        self._load_state_pre_hooks: dict = {}
        self.last_save_timing: Optional[dict] = None
        self.last_load_timing: Optional[dict] = None
        self.last_resume_info = None  # an ElasticResumeInfo after resume_from_latest
        self._async_save = None  # the in-flight save_state(async_save=True)
        self._preemption_guard = None
        self._health_guard = None
        # The DDP comm-hook counterpart of the JAX PreparedModel: under an
        # fp16 or bf16 hook the accumulated gradients carry bf16 rounding.
        hook = self.ddp_handler.comm_hook if self.ddp_handler is not None else "no"
        self._grad_sync_dtype = torch.bfloat16 if hook in ("fp16", "bf16") else None
        # Observability is env-opt-in (ACCELERATE_TPU_TELEMETRY=1): enabled
        # here so env-only runs get spans/metrics/watchdog with no code change.
        _telemetry_from_env()

    # -- the process (state passthroughs) -------------------------------------

    @property
    def distributed_type(self) -> DistributedType:
        return self.state.distributed_type

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def local_process_index(self) -> int:
        return self.state.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def is_local_main_process(self) -> bool:
        return self.state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.state.is_last_process

    @property
    def use_distributed(self) -> bool:
        return self.state.use_distributed

    @property
    def mesh(self):
        """The state's :class:`~accelerate_tpu_torch.parallel.mesh.Mesh`."""
        return self.state.mesh

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def deepspeed_plugin(self):
        """The active DeepSpeed dialect (the state's, which follows
        ``select()``), None without one."""
        active = self.state.__dict__.get("deepspeed_plugin")
        return active if active is not None else self.__dict__.get("_deepspeed_plugin")

    @property
    def _dialect_grad_clip(self):
        """The active dialect's ``gradient_clipping`` (None without one)."""
        dialect = self.deepspeed_plugin or self.megatron_lm_plugin
        return dialect.gradient_clipping if dialect is not None else None

    @property
    def fp8_backend(self) -> Optional[str]:
        """The fp8 engine in use: none, as fp8 is not ported (ROADMAP A8)."""
        return None

    def print(self, *args, **kwargs) -> None:
        """``print`` on the local main process only."""
        self.state.print(*args, **kwargs)

    def wait_for_everyone(self) -> None:
        self.state.wait_for_everyone()

    @contextlib.contextmanager
    def main_process_first(self):
        with self.state.main_process_first():
            yield

    @contextlib.contextmanager
    def local_main_process_first(self):
        with self.state.local_main_process_first():
            yield

    def on_main_process(self, func=None):
        return self.state.on_main_process(func)

    def on_local_main_process(self, func=None):
        return self.state.on_local_main_process(func)

    def on_process(self, func=None, process_index=None):
        return self.state.on_process(func, process_index)

    def on_last_process(self, func):
        return self.state.on_last_process(func)

    def on_local_process(self, func=None, local_process_index=None):
        return self.state.on_local_process(func, local_process_index)

    def split_between_processes(self, inputs, apply_padding: bool = False):
        return self.state.split_between_processes(inputs, apply_padding)

    # -- dataloader configuration -------------------------------------------

    @property
    def split_batches(self) -> bool:
        return self.dataloader_config.split_batches

    @property
    def dispatch_batches(self) -> Optional[bool]:
        return self.dataloader_config.dispatch_batches

    @property
    def even_batches(self) -> bool:
        return self.dataloader_config.even_batches

    @even_batches.setter
    def even_batches(self, value: bool) -> None:
        self.dataloader_config.even_batches = value

    @property
    def use_seedable_sampler(self) -> bool:
        return self.dataloader_config.use_seedable_sampler

    @property
    def use_stateful_dataloader(self) -> bool:
        return self.dataloader_config.use_stateful_dataloader

    @property
    def non_blocking(self) -> bool:
        return self.dataloader_config.non_blocking

    @property
    def logging_dir(self) -> Optional[str]:
        return self.project_configuration.logging_dir

    # -- accumulation state ---------------------------------------------------

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @gradient_accumulation_steps.setter
    def gradient_accumulation_steps(self, value: int) -> None:
        self.gradient_state.num_steps = int(value)

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    @sync_gradients.setter
    def sync_gradients(self, value: bool) -> None:
        self.gradient_state.sync_gradients = bool(value)

    @property
    def project_dir(self) -> Optional[str]:
        return self.project_configuration.project_dir

    # -- preparation ------------------------------------------------------------

    @_span("accelerator.prepare")
    def prepare(self, *args):
        """Prepare models and dataloaders first, then optimizers (each paired
        with the model whose parameters it holds), then schedulers (each
        driving the prepared optimizers); anything else passes through.
        Under the DeepSpeed dialect its ``"auto"`` fields are filled from
        the prepared dataloaders, a ``DummyOptim`` becomes the ``AdamW`` it
        describes and a ``DummyScheduler`` its scheduler, as in the JAX
        package.  Returns the objects in order (one object unwrapped)."""
        from .utils.deepspeed import DummyOptim, DummyScheduler

        staged = {}
        for i, obj in enumerate(args):
            if isinstance(obj, nn.Module):
                staged[i] = self.prepare_model(obj)
            elif isinstance(obj, (torch.utils.data.DataLoader, DataLoaderShard,
                                  DataLoaderDispatcher)):
                staged[i] = self.prepare_data_loader(obj)
        if self.deepspeed_plugin is not None:
            micro_bs = next((dl.batch_size for dl in self._dataloaders
                             if getattr(dl, "batch_size", None)), None)
            self.deepspeed_plugin.fill_auto(train_micro_batch_size_per_gpu=micro_bs,
                                            num_devices=self.num_processes)
        realized = {}  # id(DummyOptim) -> the torch optimizer it became
        for i, obj in enumerate(args):
            if i in staged:
                continue
            if isinstance(obj, DummyOptim):
                real = torch.optim.AdamW(obj.params, lr=obj.lr, weight_decay=obj.weight_decay)
                realized[id(obj)] = real
                staged[i] = self.prepare_optimizer(real)
            elif isinstance(obj, (torch.optim.Optimizer, AcceleratedOptimizer)):
                staged[i] = self.prepare_optimizer(obj)
        for i, obj in enumerate(args):
            if i in staged:
                continue
            if isinstance(obj, DummyScheduler):
                staged[i] = self.prepare_scheduler(_realize_scheduler(obj, realized))
            else:
                staged[i] = self.prepare_scheduler(obj) if _is_scheduler_like(obj) else obj
        out = [staged[i] for i in range(len(args))]
        return out[0] if len(out) == 1 else tuple(out)

    def prepare_data_loader(self, data_loader, device_placement: Optional[bool] = None):
        """Wrap a torch ``DataLoader`` (or any iterable of batches) as a
        :class:`~accelerate_tpu_torch.data_loader.DataLoaderShard` that
        yields this process's batches (its data shard's: processes that
        differ only on ``tp`` read the same rows) on this accelerator's device (left
        where they are without ``device_placement``) and tells
        :meth:`accumulate` about its last batch; under ``dispatch_batches``
        a :class:`~accelerate_tpu_torch.data_loader.DataLoaderDispatcher`."""
        if isinstance(data_loader, (DataLoaderShard, DataLoaderDispatcher)):
            if not any(data_loader is d for d in self._dataloaders):
                self._dataloaders.append(data_loader)
            return data_loader
        cfg = self.dataloader_config
        prepared = prepare_data_loader(
            data_loader, device=self.device, split_batches=cfg.split_batches,
            put_on_device=self.device_placement if device_placement is None else device_placement,
            even_batches=cfg.even_batches, use_seedable_sampler=cfg.use_seedable_sampler,
            data_seed=cfg.data_seed, non_blocking=cfg.non_blocking,
            use_stateful_dataloader=cfg.use_stateful_dataloader,
            static_shape_tail=cfg.static_shape_tail, prefetch_to_device=cfg.prefetch_to_device,
            gradient_state=self.gradient_state, num_processes=data_degree(self.mesh),
            process_index=data_index(self.mesh), dispatch_batches=cfg.dispatch_batches)
        self._dataloaders.append(prepared)
        return prepared

    def prepare_scheduler(self, scheduler) -> AcceleratedScheduler:
        """Wrap a torch LR scheduler (over a prepared optimizer's torch
        optimizer) or a callable ``step -> lr``; it writes the LR into every
        prepared optimizer."""
        if isinstance(scheduler, AcceleratedScheduler):
            return scheduler
        prepared = AcceleratedScheduler(
            scheduler, list(self._optimizers),
            step_with_optimizer=self.step_scheduler_with_optimizer,
            split_batches=self.dataloader_config.split_batches,
            gradient_state=self.gradient_state)
        self._schedulers.append(prepared)
        return prepared

    @_span("accelerator.prepare_model")
    def prepare_model(self, model: nn.Module, device_placement: Optional[bool] = None,
                      evaluation_mode: bool = False) -> nn.Module:
        """Move ``model`` (an ``nn.Module`` or a :class:`FunctionalModel`) to
        this accelerator's device in place (its ``Parameter`` objects stay
        the same, so an optimizer built over them stays valid; not moved
        without ``device_placement``) and register it.  With several
        processes its parameters and buffers take rank 0's values, and on a
        mesh with model axes each process keeps its shard of each parameter
        by the specs of :func:`~.parallel.sharding.make_param_specs` (the
        model's ``partition_rules``, then the FSDP plugin's strategy with its
        ``min_num_params``), kept as ``model._param_specs`` as in the JAX
        package.  Under a 16-bit ``mixed_precision`` it comes back as a
        :class:`PreparedModel` around it, under ``"no"`` as itself (a
        sharded model whose forward does not realize its layout, as the
        llama family's does, in a :class:`PreparedModel` that gathers its
        leaves).  ``evaluation_mode`` puts it in ``eval()`` mode."""
        if not isinstance(model, nn.Module):
            raise TypeError(f"prepare_model takes an nn.Module or a FunctionalModel, "
                            f"got {type(model).__name__}")
        for m in self._models:
            if model is m or (isinstance(m, PreparedModel) and m.module is model):
                return m
        if self.device_placement if device_placement is None else device_placement:
            model.to(self.device)
        gathers = False
        if self.num_processes > 1:
            gathers = self._shard_model(model)
        dt = self.state.dtype_policy.compute_dtype
        prepared = model if dt == torch.float32 and not gathers else PreparedModel(model, dt)
        if evaluation_mode:
            prepared.eval()
        self._models.append(prepared)
        return prepared

    def _shard_model(self, model: nn.Module) -> bool:
        """Broadcast rank 0's values into every process's parameters and
        buffers, then keep each process's shards (see :meth:`prepare_model`).
        Returns whether the forward must gather the leaves whole."""
        from .parallel.sharding import (
            Layout,
            _leaves,
            is_sharded,
            make_param_specs,
            shard_params,
        )

        if hasattr(model, "params") and isinstance(model.params, dict):
            tree = model.params
        else:
            tree = {n.replace(".", "/"): p for n, p in model.named_parameters()}
        rules = getattr(model, "partition_rules", None)
        specs = make_param_specs(tree, self.mesh, self.state.fsdp_plugin, rules=rules)
        shard_params(tree, self.mesh, specs)
        shard_params(list(model.buffers()), self.mesh)
        model._param_specs = specs
        mesh = self.mesh
        if all(mesh.shape[a] == 1 for a in ("fsdp", "tp", "ep", "sp")):
            return False
        layout = Layout(mesh, specs, bool(getattr(model, "splits_sequence", False)))
        handles = getattr(model, "handles_layout", None)
        if handles is not None and handles():
            model._layout = layout
            return False
        if not any(is_sharded(s) for s in _leaves(specs, tuple)):
            return False
        model._gather_layout = layout
        return True

    def prepare_optimizer(self, optimizer: torch.optim.Optimizer) -> AcceleratedOptimizer:
        """Wrap ``optimizer``, paired by parameter identity with the prepared
        model that owns its parameters."""
        if isinstance(optimizer, AcceleratedOptimizer):
            return optimizer
        ids = {id(p) for group in optimizer.param_groups for p in group["params"]}
        for model in reversed(self._models):
            if any(id(p) in ids for p in model.parameters()):
                if self._host_offload_requested():
                    from .parallel.host_offload import host_offload

                    optimizer = host_offload(optimizer)
                prepared = AcceleratedOptimizer(optimizer, model, self.gradient_state,
                                                mesh=self.mesh, sync_dtype=self._grad_sync_dtype)
                clip = self._dialect_grad_clip
                if clip is not None and float(clip) > 0:
                    # The engines applied a config's clipping on every step;
                    # DeepSpeed's 0.0 means off.
                    prepared._clip_norm = float(clip)
                self._optimizers.append(prepared)
                return prepared
        raise ValueError("prepare the model before (or together with) its optimizer: no "
                         "prepared model owns this optimizer's parameters")

    def _host_offload_requested(self) -> bool:
        """The FSDP plugin's ``cpu_offload`` or the DeepSpeed dialect's
        ``offload_optimizer`` device: the optimizer's state in host memory
        (:mod:`.parallel.host_offload`), as the JAX package reads them."""
        fsdp = getattr(self.state.fsdp_plugin, "cpu_offload", False)
        ds = getattr(self.deepspeed_plugin, "offload_optimizer_device", None) in ("cpu", "nvme")
        return bool(fsdp or ds)

    # -- the eager training loop ---------------------------------------------

    def _trainable(self) -> List[torch.Tensor]:
        return [p for m in self._models for p in m.parameters() if p.requires_grad]

    @_span("accelerator.backward")
    def backward(self, loss: torch.Tensor) -> None:
        """Accumulate ``d loss / d params * (1 / gradient_accumulation_steps)``
        into the prepared models' ``.grad``: each micro-gradient is scaled,
        then added, the order ``make_train_step`` uses.  Under a
        ``comm_hook`` of ``"fp16"``/``"bf16"`` the scaled gradient and the sum
        are rounded to bf16 (stored in the parameter's dtype)."""
        params = self._trainable()
        tel = _get_telemetry()
        if tel.enabled:
            # The JAX package's three dispatch sites: its fused forward+backward
            # program (here the autograd call), the gradient scale, and the
            # merge into gradients already held.
            tel.count_dispatch(3 if any(p.grad is not None for p in params) else 2)
        grads = torch.autograd.grad(loss.float().mean(), params, allow_unused=True)
        summed = accumulate_grads([p.grad for p in params], grads,
                                  1.0 / self.gradient_accumulation_steps,
                                  hold_dtype=self._grad_sync_dtype)
        for p, g in zip(params, summed):
            p.grad = g

    @contextlib.contextmanager
    def accumulate(self, *models):
        """Count one micro-batch: ``sync_gradients`` is True inside on every
        ``gradient_accumulation_steps``-th and on a prepared dataloader's
        last batch (the count then restarts), and ``optimizer.step()`` /
        ``scheduler.step()`` / ``zero_grad()`` act only then."""
        self.gradient_state.advance()
        yield

    def clip_grad_norm_(self, parameters=None, max_norm: float = 1.0, norm_type: float = 2.0):
        """Arm global-norm clipping for the next optimizer step (one shot)
        and return the norm that step will clip: that of the accumulated
        gradients averaged over the data axes, as the JAX ``Accelerator``
        returns the global gradient's (None before any backward).  With
        several processes the average is taken here, on a sync step in place
        (the step does not take it again); with sharded leaves each distinct
        shard counts once.  The norm is always the global 2-norm: another
        ``norm_type`` is ignored, with a warning."""
        if norm_type != 2.0:
            warnings.warn(f"clip_grad_norm_ ignores norm_type={norm_type}: it clips to and "
                          "returns the global 2-norm", stacklevel=2)
        for opt in self._optimizers:
            opt._clip_norm_once = float(max_norm)
        for opt in self._optimizers:
            norm = opt._grad_norm_now()
            if norm is not None:
                return norm
        return None

    def clip_grad_value_(self, parameters=None, clip_value: float = 1.0) -> None:
        """Arm elementwise gradient clipping for the next optimizer step
        (one shot)."""
        for opt in self._optimizers:
            opt._clip_value_once = float(clip_value)

    def make_train_step(self, model, optimizer, accum_steps=None, clip_norm=None,
                        clip_value=None, zero=None):
        """The whole optimizer step in one call (see
        :mod:`accelerate_tpu_torch.pipeline.train_step`)::

            model, opt = accelerator.prepare(model, torch.optim.AdamW(model.parameters()))
            step_fn = accelerator.make_train_step(model, opt)
            loss = step_fn(batch)            # accum_steps == 1
            losses = step_fn([b1, b2, b3])   # accum_steps == 3

        ``zero=True`` (None: ``ACCELERATE_TPU_ZERO``) shards the weight update
        over the data-parallel processes (:mod:`.parallel.zero`); on a mesh
        that cannot take it, it warns and runs the replicated step.
        """
        from .pipeline.train_step import make_train_step

        return make_train_step(self, model, optimizer, accum_steps=accum_steps,
                               clip_norm=clip_norm, clip_value=clip_value, zero=zero)

    @contextlib.contextmanager
    def no_sync(self, model=None):
        """``sync_gradients`` False inside (restored on exit): the optimizer
        step, and with it the gradient average over the processes, waits
        for a micro-batch outside."""
        old = self.gradient_state.sync_gradients
        self.gradient_state.sync_gradients = False
        try:
            yield
        finally:
            self.gradient_state.sync_gradients = old

    def trigger_sync_in_backward(self, model) -> None:
        """Make the next backward a sync step inside :meth:`no_sync`."""
        self.gradient_state.sync_gradients = True

    @contextlib.contextmanager
    def join_uneven_inputs(self, joinables, even_batches: Optional[bool] = None):
        """The JAX ``join_uneven_inputs``: batches are equalized by
        ``even_batches`` before they reach the step, so no ``Join`` shadows
        the collectives; with several processes ``even_batches`` overrides
        the prepared map-style loaders' inside the block (restored on exit),
        and iterable loaders keep theirs, with a warning.  One process runs
        the block as it is."""
        overridden: list = []
        if even_batches is not None and self.num_processes > 1:
            iterable_seen = False
            for dl in self._dataloaders:
                sampler = getattr(dl, "batch_sampler", None)
                if sampler is not None and hasattr(sampler, "even_batches"):
                    overridden.append((sampler, sampler.even_batches))
                    sampler.even_batches = even_batches
                else:
                    iterable_seen = True
            if iterable_seen:
                warnings.warn("Overriding even_batches is only supported for map-style "
                              "datasets; iterable dataloaders keep their behavior.")
        try:
            yield
        finally:
            for sampler, prev in overridden:
                sampler.even_batches = prev

    def unscale_gradients(self, optimizer=None) -> None:
        """No loss scaler runs (``fp16`` computes in bf16, which needs none),
        so gradients are already at true scale: a no-op kept for the JAX
        surface, where optax carries no scaler either."""

    @property
    def optimizer_step_was_skipped(self) -> bool:
        """Whether the last ``optimizer.step()`` of any prepared optimizer
        skipped its update (accumulating, or no gradient)."""
        return any(opt.step_was_skipped for opt in self._optimizers)

    def unwrap_model(self, model, keep_fp32_wrapper: bool = True,
                     keep_torch_compile: bool = True) -> nn.Module:
        """The original module of a prepared model, with its fp32
        parameters (see :func:`~accelerate_tpu_torch.utils.other.extract_model_from_parallel`).
        A sharded model's leaves are gathered (a collective: every process
        calls it) into a copy of the module with its full weights on the
        main process; the others get their sharded module."""
        from .utils.other import extract_model_from_parallel

        module = extract_model_from_parallel(model, keep_fp32_wrapper=keep_fp32_wrapper,
                                             keep_torch_compile=keep_torch_compile)
        if not _is_sharded_model(module):
            return module
        from .parallel.sharding import full_state_dict

        full = full_state_dict(module)
        return _whole_copy(module, full) if self.is_main_process else module

    def get_state_dict(self, model, unwrap: bool = True) -> dict:
        """``model``'s state dict (fp32, under its names): a prepared
        wrapper's is its module's, so ``unwrap`` changes nothing.  A sharded
        model's leaves are gathered to their full shapes (a collective)."""
        module = model.module if isinstance(model, PreparedModel) else model
        if _is_sharded_model(module):
            from .parallel.sharding import full_state_dict

            return full_state_dict(module)
        return (self.unwrap_model(model) if unwrap else model).state_dict()

    @contextlib.contextmanager
    def autocast(self, autocast_handler=None):
        """A no-op context, as in the JAX package: the 16-bit compute of
        ``mixed_precision`` lives in the prepared model."""
        yield

    @contextlib.contextmanager
    def profile(self, profile_handler: Optional[ProfileKwargs] = None):
        """``torch.profiler.profile`` over the block, configured by
        ``profile_handler`` (else the constructor's :class:`ProfileKwargs`,
        else the defaults), yielded so the caller can ``step()`` a schedule.
        With ``output_trace_dir`` (or ``ACCELERATE_TPU_TRACE_DIR``) each
        finished trace is written as Chrome JSON to
        ``<dir>/profile_<process_index>/trace_<step>.json``; without one it
        is dropped."""
        handler = profile_handler or self.profile_handler or ProfileKwargs()
        kinds = {"cpu": torch.profiler.ProfilerActivity.CPU,
                 "cuda": torch.profiler.ProfilerActivity.CUDA}
        names = handler.activities or (["cpu", "cuda"] if torch.cuda.is_available() else ["cpu"])
        out_dir = handler.output_trace_dir or os.environ.get("ACCELERATE_TPU_TRACE_DIR")
        on_ready = None
        if out_dir is not None:
            trace_dir = os.path.join(out_dir, f"profile_{self.process_index}")
            os.makedirs(trace_dir, exist_ok=True)

            def on_ready(prof):
                prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{prof.step_num}.json"))

        schedule = (torch.profiler.schedule(**handler.schedule_option)
                    if handler.schedule_option else None)
        with torch.profiler.profile(activities=[kinds[n] for n in names], schedule=schedule,
                                    on_trace_ready=on_ready, record_shapes=handler.record_shapes,
                                    profile_memory=handler.profile_memory,
                                    with_flops=handler.with_flops) as prof:
            yield prof

    def free_memory(self, *objects):
        """Forget every prepared model, optimizer, scheduler and dataloader,
        restart the accumulation count, collect garbage and empty the CUDA
        cache; returns one None per argument, for the caller to rebind."""
        from .utils.memory import release_memory

        self._models.clear()
        self._optimizers.clear()
        self._schedulers.clear()
        self._dataloaders.clear()
        self.gradient_state.step = 0
        return release_memory(*objects)

    def clear(self, *objects):
        return self.free_memory(*objects)

    def save(self, obj, f, safe_serialization: bool = False) -> None:
        """Write ``obj`` on the main process (see
        :func:`~accelerate_tpu_torch.utils.other.save`)."""
        from .utils.other import save

        save(obj, f, save_on_each_node=self.project_configuration.save_on_each_node,
             safe_serialization=safe_serialization)

    # -- trackers ---------------------------------------------------------------

    def init_trackers(self, project_name: str, config=None, init_kwargs=None):
        """Build the trackers ``log_with`` names (unknown names raise
        ``ValueError``, uninstalled backends are skipped with a warning) for
        ``project_name``, those that keep files under ``logging_dir``, and
        store ``config`` in each; ``init_kwargs`` maps a tracker name to its
        constructor's keywords."""
        from .tracking import init_trackers

        self.trackers = init_trackers(self.log_with, project_name, config, init_kwargs, self)

    def log(self, values: dict, step: Optional[int] = None, log_kwargs=None):
        """``values`` to every tracker at ``step``."""
        from .tracking import telemetry_rows

        rows = telemetry_rows()
        if rows:
            values = {**rows, **values}
        for tracker in self.trackers:
            tracker.log(values, step=step)

    def get_tracker(self, name: str, unwrap: bool = False):
        """The tracker called ``name`` (its SDK object under ``unwrap``);
        ``ValueError`` when none is."""
        for tracker in self.trackers:
            if getattr(tracker, "name", None) == name:
                return tracker.tracker if unwrap else tracker
        raise ValueError(f"Tracker {name} not found")

    def end_training(self):
        """Publish a pending asynchronous save (:meth:`wait_for_checkpoint`),
        then close every tracker."""
        if self._async_save is not None:
            self.wait_for_checkpoint()
        for tracker in self.trackers:
            tracker.finish()

    # -- metrics and collectives ------------------------------------------------

    def gather(self, tensor):
        return gather(tensor)

    def gather_for_metrics(self, input_data, use_gather_object: bool = False):
        """:meth:`gather`, then, on a prepared dataloader's last batch, only
        its first ``remainder`` rows (what the loaders filled the tail of the
        global batch with is dropped).  Input that is not all tensors, or
        ``use_gather_object``, goes through ``gather_object`` as a list of
        samples."""
        try:
            recursively_apply(lambda x: x, input_data, error_on_other_type=True)
            all_tensors = True
        except TypeError:
            all_tensors = False
        object_mode = not all_tensors or use_gather_object
        if object_mode:
            data = gather_object(input_data if isinstance(input_data, (list, tuple))
                                 else [input_data])
        else:
            data = self.gather(input_data)
        remainder = self.gradient_state.remainder
        if not (self.gradient_state.end_of_dataloader and remainder > 0):
            return data
        if object_mode:
            return data[:remainder]
        try:
            return recursively_apply(lambda t: t[:remainder], data)
        except IndexError:  # a 0-d leaf has no rows to drop
            return data

    def reduce(self, tensor, reduction: str = "sum", scale: float = 1.0):
        return reduce(tensor, reduction, scale)

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0,
                             pad_first: bool = False):
        return pad_across_processes(tensor, dim, pad_index, pad_first)

    def set_trigger(self) -> None:
        """Raise this process's flag for :meth:`check_trigger`."""
        self.flag_tensor = torch.ones(1, dtype=torch.int64, device=self.device)

    def check_trigger(self) -> bool:
        """True (and the flag lowered) when any process raised its flag."""
        flag = (self.flag_tensor if self.flag_tensor is not None
                else torch.zeros(1, dtype=torch.int64, device=self.device))
        if int(reduce(flag, reduction="sum")[0]) >= 1:
            self.flag_tensor = None
            return True
        return False

    # -- checkpoints ------------------------------------------------------------

    def register_save_state_pre_hook(self, hook: Callable) -> _RemovableHandle:
        """``hook(models, weights, output_dir)`` runs inside :meth:`save_state`
        before anything is written; ``weights`` holds each model's state
        dict, and what the hook leaves there is what gets saved."""
        handle = _RemovableHandle(self._save_state_pre_hooks)
        self._save_state_pre_hooks[handle.id] = hook
        return handle

    def register_load_state_pre_hook(self, hook: Callable) -> _RemovableHandle:
        """``hook(models, input_dir)`` runs inside :meth:`load_state` before
        anything is restored."""
        handle = _RemovableHandle(self._load_state_pre_hooks)
        self._load_state_pre_hooks[handle.id] = hook
        return handle

    def register_for_checkpointing(self, *objects) -> None:
        """Objects with ``state_dict`` / ``load_state_dict`` saved as
        ``custom_checkpoint_<i>.pkl``."""
        for obj in objects:
            if not (hasattr(obj, "state_dict") and hasattr(obj, "load_state_dict")):
                raise ValueError(f"Object {obj} must expose state_dict/load_state_dict to be "
                                 "registered.")
            self._custom_objects.append(obj)

    def save_state(self, output_dir: Optional[str] = None, step: Optional[int] = None,
                   verified: bool = True, async_save: bool = False) -> str:
        """Write a verified checkpoint of everything prepared (see
        :mod:`accelerate_tpu_torch.checkpointing`) and return its directory;
        under automatic naming it is
        ``<project_dir>/checkpoints/checkpoint_<iteration>``.
        ``verified=False`` writes in place, with no staging and no
        manifest.  ``async_save=True`` returns once every tensor is copied
        to host memory and writes the files on a thread: the checkpoint is
        published by :meth:`wait_for_checkpoint`, :meth:`end_training` or
        the next ``save_state``."""
        from .checkpointing import save_accelerator_state

        return save_accelerator_state(self, output_dir, step=step, verified=verified,
                                      async_save=async_save)

    def wait_for_checkpoint(self) -> None:
        """Block until the in-flight ``save_state(async_save=True)``'s files
        are written, then run its deferred manifest and atomic publish; a
        failed write re-raises here and nothing is published."""
        from .checkpointing import finalize_async_checkpoint

        finalize_async_checkpoint(self)

    def load_state(self, input_dir: Optional[str] = None, verify: bool = True) -> str:
        """Restore a checkpoint written by :meth:`save_state` (verified
        against its manifest first, unless ``verify=False``) and return its
        directory."""
        from .checkpointing import load_accelerator_state

        return load_accelerator_state(self, input_dir, verify=verify)

    def save_model(self, model, save_directory: str, max_shard_size="10GB",
                   safe_serialization: bool = True) -> str:
        """``model``'s weights as safetensors under ``save_directory`` (a
        ``model.pkl`` ``torch.save`` archive without
        ``safe_serialization``); a sharded model's are gathered and written
        by the main process."""
        from .checkpointing import save_model_weights

        module = model.module if isinstance(model, PreparedModel) else model
        if _is_sharded_model(module):
            full = self.get_state_dict(module)
            if not self.is_main_process:
                return save_directory
            return save_model_weights(None, save_directory, max_shard_size=max_shard_size,
                                      state_dict=full, safe_serialization=safe_serialization)
        return save_model_weights(model, save_directory, max_shard_size=max_shard_size,
                                  safe_serialization=safe_serialization)

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        return skip_first_batches(dataloader, num_batches)

    def resume_from_latest(self, checkpoint_dir: Optional[str] = None,
                           verify: bool = True) -> Optional[int]:
        """Restore the newest manifest-complete checkpoint under
        ``checkpoint_dir`` (default ``<project_dir>/checkpoints``), passing
        over torn partials, and return the step its manifest records (0
        when none), or None when there is no complete checkpoint
        (``verify=False`` loads it without checking the manifest's sizes
        and hashes).  Automatic naming continues after the checkpoint
        resumed from.

        Elastic: a checkpoint saved under another topology (mesh, world
        size, ZeRO or ``fsdp`` layout) lands on the live one.  Its topology
        record is planned and validated leaf by leaf, and the
        ``skip_first_batches`` count recomputed for a changed global batch,
        before anything is loaded (a pipeline stage-count change or a
        non-divisible batch geometry raises
        :class:`~accelerate_tpu_torch.resilience.ElasticTopologyError` with
        the live state untouched).  What happened is kept in
        ``last_resume_info`` (an
        :class:`~accelerate_tpu_torch.resilience.ElasticResumeInfo`); a
        checkpoint with no topology record resumes on the legacy path, with
        a warning."""
        from .resilience import elastic
        from .resilience.manifest import find_latest_complete, read_manifest

        root = checkpoint_dir or os.path.join(self.project_dir or ".", "checkpoints")
        ckpt = find_latest_complete(root)
        if ckpt is None:
            return None
        manifest = read_manifest(ckpt) or {}
        topology = manifest.get(elastic.TOPOLOGY_KEY)
        step = manifest.get("step")
        resumed_step = int(step) if step is not None else 0
        plan = skip_batches = None
        if topology is None:
            import logging

            logging.getLogger(__name__).warning(
                f"checkpoint {ckpt!r} carries no topology record (pre-elastic save): "
                "resuming best-effort, assuming it was saved under the current mesh — "
                "cross-topology state cannot be validated.")
        else:
            plan = elastic.plan_resume(topology, self)
            elastic.validate_leaves(topology, self)
            live_gb = None
            for dl in self._dataloaders:
                try:
                    live_gb = int(dl.total_batch_size)
                except Exception:
                    live_gb = None
                break
            # Only a changed global batch needs the recomputed skip: the same
            # geometry keeps the loader position load_state restores.
            if (plan.saved_global_batch is not None and live_gb is not None
                    and plan.saved_global_batch != live_gb):
                skip_batches = elastic.recompute_skip_batches(
                    resumed_step, plan.saved_global_batch, live_gb)
        self.load_state(ckpt, verify=verify)
        tail = os.path.basename(ckpt).rsplit("_", 1)[-1]
        if os.path.basename(ckpt).startswith("checkpoint_") and tail.isdigit():
            self.project_configuration.iteration = int(tail) + 1
        self.last_resume_info = elastic.ElasticResumeInfo(
            step=resumed_step, checkpoint=ckpt, plan=plan, legacy=topology is None,
            skip_batches=skip_batches)
        return resumed_step

    # -- preemption ---------------------------------------------------------------

    def enable_preemption_handling(self, save_dir: Optional[str] = None, signals=None,
                                   coordinated: Optional[bool] = None):
        """Install a :class:`~accelerate_tpu_torch.resilience.PreemptionGuard`
        for this process (idempotent) and return it.  ``save_dir`` is where
        :meth:`check_preemption` writes the final checkpoint; without it,
        automatic checkpoint naming must be on.  Serving engines built by
        :meth:`prepare_serving` afterwards drain on the signal.
        ``coordinated=True`` (the default with several processes) makes the
        stop a collective decision: ``should_stop`` is the max of every
        process's flag, so all stop at the same step."""
        from .resilience import PreemptionGuard

        if (self._preemption_guard is None and save_dir is None
                and not self.project_configuration.automatic_checkpoint_naming):
            # Fail now, not when the signal arrives and the checkpoint matters.
            raise ValueError(
                "enable_preemption_handling needs a checkpoint target: pass save_dir=, or "
                "enable ProjectConfiguration(automatic_checkpoint_naming=True)"
            )
        if self._preemption_guard is None:
            kwargs = {} if signals is None else {"signals": signals}
            self._preemption_guard = PreemptionGuard(coordinated=coordinated, **kwargs).install()
        if save_dir is not None:
            self._preemption_guard.save_dir = save_dir
        return self._preemption_guard

    def check_preemption(self, save_dir: Optional[str] = None, step: Optional[int] = None) -> bool:
        """Call once per step at the step boundary.  Returns True once the
        installed guard saw its signal, after writing ONE final verified
        checkpoint (to ``save_dir``, the guard's directory, or automatic
        naming) whose manifest records ``step`` for
        :meth:`resume_from_latest`; the caller then leaves its loop.
        Without a guard it returns False (after the env-armed
        fault-injection tick, ``ACCELERATE_TPU_FAULT_SIGTERM_STEP``).  First
        it beats the fleet's step-loop heartbeat, when the supervisor set
        ``ACCELERATE_TPU_HEARTBEAT_DIR`` (one env lookup otherwise)."""
        from .resilience import faultinject, fleet

        fleet.maybe_beat(step if step is not None else self.gradient_state.step)
        if faultinject.armed():
            faultinject.tick(step if step is not None else self.gradient_state.step)
        guard = self._preemption_guard
        if guard is None or not guard.should_stop():
            return False
        if not guard.final_checkpoint_saved:
            with _span("resilience.final_checkpoint"):
                self.save_state(save_dir or guard.save_dir, step=step)
            guard.final_checkpoint_saved = True
            tel = _get_telemetry()
            if tel.enabled:
                tel.registry.counter("resilience.preempt_checkpoints").inc()
                tel.event("resilience.preempt_checkpoint", step=step)
        return True

    # -- numerical health ---------------------------------------------------------

    def enable_health_guard(self, optimizer=None, dataloader=None, max_skips: int = 3,
                            max_rewinds: int = 2, lr_backoff: Optional[float] = None,
                            checkpoint_dir: Optional[str] = None, quarantine_after: int = 2,
                            quarantine_log: Optional[str] = None):
        """Install a :class:`~accelerate_tpu_torch.resilience.HealthGuard`:
        the optimizer update already gates a non-finite step to a zero delta
        on the device (pre-clip gradient norm, and in the fused step every
        micro-batch loss); the guard adds the host-side policy: skip up to
        ``max_skips`` consecutive anomalous steps, then rewind to the newest
        manifest-complete checkpoint under ``checkpoint_dir`` (via
        :meth:`resume_from_latest`, with an optional ``lr_backoff``
        multiplier), raising ``NumericalDivergenceError`` after
        ``max_rewinds``.  A batch that produces a non-finite step
        ``quarantine_after`` times is quarantined: fingerprinted by (epoch,
        batch index), logged to JSONL next to the telemetry trace, and
        skipped by the data loader on replay.  ``optimizer``/``dataloader``
        default to the prepared ones.  Call :meth:`check_health` once per
        step.  Returns the guard."""
        from .resilience.health import HealthGuard

        if optimizer is None:
            optimizer = self._optimizers[-1] if self._optimizers else None
        if dataloader is None:
            dataloader = self._dataloaders[0] if self._dataloaders else None
        self._health_guard = HealthGuard(
            self, optimizer=optimizer, dataloader=dataloader, max_skips=max_skips,
            max_rewinds=max_rewinds, lr_backoff=lr_backoff, checkpoint_dir=checkpoint_dir,
            quarantine_after=quarantine_after, quarantine_log=quarantine_log,
        )
        return self._health_guard

    def check_health(self, step: Optional[int] = None, loss=None):
        """Judge the optimizer step that just completed (call right after
        ``optimizer.step()`` or the fused ``step_fn(batch)``).  Returns a
        :class:`~accelerate_tpu_torch.resilience.HealthVerdict`; on
        ``verdict.rewound`` the caller resets its step counter to
        ``verdict.resumed_step`` and re-enters its data loader loop (the
        loader's position was restored with the checkpoint).  A healthy
        no-op verdict when no guard is installed."""
        from .resilience.health import HealthVerdict

        if self._health_guard is None:
            return HealthVerdict()
        return self._health_guard.check(step=step, loss=loss)

    def enable_flight_recorder(self, dir: Optional[str] = None, capacity: Optional[int] = None,
                               flush_every: Optional[int] = None):
        """Enable the black-box flight recorder: a bounded ring of per-step
        events (step time, dispatches, kernel builds, checkpoint publishes,
        preemption signals) flushed to a crash-safe JSONL snapshot
        periodically and on SIGTERM/exit/unhandled exception, with online
        anomaly detection whose first anomaly opens a one-shot
        ``torch.profiler`` window (:mod:`.telemetry.flightrec`).  Enables
        telemetry too.  Env-only runs get the same via
        ``ACCELERATE_TPU_FLIGHTREC=1``.  Returns the recorder."""
        from .telemetry import flightrec

        return flightrec.enable(dir=dir, capacity=capacity, flush_every=flush_every)

    # -- serving ----------------------------------------------------------------

    def prepare_serving(self, apply_cached, init_cache, params, config, serving=None,
                        **serving_kwargs):
        """Build a continuous-batching :class:`~accelerate_tpu_torch.serving.ServingEngine`
        on this accelerator's device over a model family's cached-decode pair
        (paged KV cache, LIFO preemption, chunked prefill, one decode
        forward per tick, greedy outputs token-identical to ``generate``):
        ``llama.apply_cached, llama.init_cache`` or ``gpt2.apply_cached,
        gpt2.init_cache`` (the engine picks up the family's ``apply_paged``
        beside them; GPT-2's learned position table caps
        ``max_blocks_per_seq * block_size`` at its ``max_seq_len``).
        Geometry comes from a :class:`~accelerate_tpu_torch.serving.ServingConfig`
        or its fields as keyword arguments::

            engine = accelerator.prepare_serving(
                llama.apply_cached, llama.init_cache, params, cfg,
                max_slots=8, num_blocks=256, block_size=16, paged_kernel=True,
            )
            rid = engine.submit(prompt_tokens, max_new_tokens=64)
            outputs = engine.run()

        With a guard from :meth:`enable_preemption_handling` the engine
        drains on the signal instead of dying with work in its queue.

        ``params`` are taken as the caller holds them: whole, they are
        served whole on every process (on a data-parallel mesh every process
        runs the same engine); this process's shards, as :meth:`prepare`
        left them (``model.params`` of a model prepared on a mesh with an
        active ``fsdp``, ``tp`` or ``ep`` axis), they are served through the
        layout their specs give on this accelerator's mesh, without being
        gathered: the pool holds this process's kv heads, each forward is
        the family's sharded forward, and the engines of the model group
        run in lockstep, so every process must submit the same requests in
        the same order (see :mod:`~accelerate_tpu_torch.serving.engine`).
        """
        from .parallel.sharding import layout_of
        from .serving import ServingConfig, ServingEngine

        if serving is not None and serving_kwargs:
            raise ValueError("pass either a ServingConfig or its fields, not both")
        if serving is None:
            serving = ServingConfig(**serving_kwargs)
        layout = layout_of(params, self.mesh) if self.num_processes > 1 else None
        engine = ServingEngine(apply_cached, init_cache, params, config, serving=serving,
                               device=self.device, layout=layout)
        if self._preemption_guard is not None:
            engine.install_preemption_guard(self._preemption_guard)
        return engine


def _is_scheduler_like(obj) -> bool:
    """A callable ``step -> lr``, or an object with ``step`` and
    ``get_last_lr`` (every torch LR scheduler)."""
    if callable(obj) and not hasattr(obj, "step"):
        return True
    return hasattr(obj, "step") and hasattr(obj, "get_last_lr")


def _dialects(deepspeed_plugin, megatron_lm_plugin):
    """The DeepSpeed and Megatron-LM plugins, from the arguments or, with
    neither, from ``ACCELERATE_USE_DEEPSPEED`` (with
    ``ACCELERATE_DEEPSPEED_CONFIG_FILE``) / ``ACCELERATE_USE_MEGATRON_LM``;
    a dict of DeepSpeed plugins registers them all, the first active.
    Returns ``(deepspeed, megatron, ds_plugins)``."""
    if deepspeed_plugin is not None and megatron_lm_plugin is not None:
        raise ValueError("Pass either deepspeed_plugin or megatron_lm_plugin, not both")
    if deepspeed_plugin is None and megatron_lm_plugin is None:
        from .utils.environment import parse_flag_from_env

        if parse_flag_from_env("ACCELERATE_USE_DEEPSPEED"):
            from .utils.deepspeed import DeepSpeedPlugin

            deepspeed_plugin = DeepSpeedPlugin(
                hf_ds_config=os.environ.get("ACCELERATE_DEEPSPEED_CONFIG_FILE"))
        elif parse_flag_from_env("ACCELERATE_USE_MEGATRON_LM"):
            from .utils.megatron import MegatronLMPlugin

            megatron_lm_plugin = MegatronLMPlugin()
    ds_plugins = None
    if isinstance(deepspeed_plugin, dict):
        from .utils.deepspeed import DeepSpeedPlugin

        if not deepspeed_plugin:
            raise ValueError("deepspeed_plugin dict must not be empty")
        for key, value in deepspeed_plugin.items():
            if not isinstance(value, DeepSpeedPlugin):
                raise TypeError(
                    f"deepspeed_plugin[{key!r}] must be a DeepSpeedPlugin, got "
                    f"{type(value).__name__} (raw DS config dicts go through "
                    "DeepSpeedPlugin(hf_ds_config=...))")
        ds_plugins = dict(deepspeed_plugin)
        deepspeed_plugin = next(iter(ds_plugins.values()))
    return deepspeed_plugin, megatron_lm_plugin, ds_plugins


def _refuse_megatron_parts(plugin) -> None:
    """The Megatron-LM knobs whose axes are not ported raise, each naming
    its ROADMAP part: ``pp_degree`` (``sequence_parallelism`` with
    ``sp_degree`` carves the ``sp`` axis out of ``dp``, as in JAX)."""
    if plugin.pp_degree > 1:
        raise NotImplementedError(
            f"MegatronLMPlugin(pp_degree={plugin.pp_degree}): pipeline parallelism is not "
            "ported to accelerate_tpu_torch yet (ROADMAP A7)")


def _realize_scheduler(dummy, realized: dict):
    """The torch scheduler a ``DummyScheduler`` stands for: its
    ``lr_scheduler_callable`` on the optimizer, else DeepSpeed's WarmupLR
    (linear warmup over ``warmup_num_steps``, then constant)."""
    real_opt = realized.get(id(dummy.optimizer))
    if real_opt is None and isinstance(dummy.optimizer, torch.optim.Optimizer):
        real_opt = dummy.optimizer
    if real_opt is None:
        raise ValueError("DummyScheduler's optimizer must be the DummyOptim (or torch "
                         "optimizer) passed to the same prepare() call")
    if dummy.lr_scheduler_callable is not None:
        return dummy.lr_scheduler_callable(real_opt)
    warm = max(int(dummy.warmup_num_steps or 0), 0)
    return torch.optim.lr_scheduler.LambdaLR(
        real_opt, lambda step: min(1.0, (step + 1) / warm) if warm else 1.0)


def _is_sharded_model(module) -> bool:
    from .parallel.sharding import is_sharded, spec_of

    return any(is_sharded(spec_of(p)) for p in module.parameters())


def _whole_copy(module: nn.Module, full: dict) -> nn.Module:
    """A copy of ``module`` holding the full tensors ``full`` (its state
    dict's names), without the sharded layout."""
    import copy

    saved = {k: module.__dict__.pop(k) for k in ("_layout", "_gather_layout")
             if k in module.__dict__}
    try:
        out = copy.deepcopy(module)
    finally:
        module.__dict__.update(saved)
    with torch.no_grad():
        for name, t in out.state_dict(keep_vars=True).items():
            t.data = full[name].to(t.device)
            t.__dict__.pop("_spec", None)
            t.__dict__.pop("_full_shape", None)
    return out
