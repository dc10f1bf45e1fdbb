"""The port's ``Accelerator``: device placement, training and serving.

Training (single GPU), the README's loop::

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
checkpoint all of it (:mod:`.checkpointing`).  Serving:
:meth:`~Accelerator.prepare_serving`.

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

from .data_loader import DataLoaderShard, prepare_data_loader, skip_first_batches
from .optimizer import AcceleratedOptimizer, global_norm
from .pipeline.train_step import accumulate_grads
from .scheduler import AcceleratedScheduler
from .state import GradientState, resolve_device
from .utils.dataclasses import (
    DataLoaderConfiguration,
    GradientAccumulationPlugin,
    ProjectConfiguration,
)
from .utils.operations import rename_state_dict

__all__ = ["Accelerator", "FunctionalModel"]


class FunctionalModel(nn.Module):
    """A pure ``apply_fn(params, *args, **batch)`` plus its parameter tree
    (nested dicts of tensors): the port's
    ``accelerate_tpu.accelerator.JaxModel``.  The tree's tensor leaves
    become ``nn.Parameter``s (registered, so ``parameters()`` and
    ``.to()`` see them); ``params`` is the tree with those leaves, and
    ``model(**batch)`` is ``apply_fn(params, **batch)``, which returns
    ``{"loss": ...}`` for training.  ``state_dict()`` names each leaf by
    its path in the tree, joined with dots (``layers.wq``), as the JAX
    ``JaxModel.state_dict`` does."""

    def __init__(self, apply_fn: Callable, params: Any):
        super().__init__()
        self.apply_fn = apply_fn
        self._leaves = nn.ParameterList()
        names = []

        def wrap(tree, path):
            if isinstance(tree, dict):
                return {k: wrap(v, f"{path}{k}.") for k, v in tree.items()}
            if isinstance(tree, torch.Tensor):
                leaf = tree if isinstance(tree, nn.Parameter) else nn.Parameter(tree)
                self._leaves.append(leaf)
                names.append(path[:-1])
                return leaf
            return tree

        self.params = wrap(params, "")
        rename_state_dict(self, {f"_leaves.{i}": n for i, n in enumerate(names)})

    def forward(self, *args, **kwargs):
        return self.apply_fn(self.params, *args, **kwargs)


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
    or ``device="cpu"`` keeps everything on the host.  The other arguments
    keep the JAX ``Accelerator``'s names:

    - ``gradient_accumulation_steps`` (or a ``gradient_accumulation_plugin``):
      micro-batches per optimizer step;
    - ``dataloader_config`` (or ``split_batches``): how ``prepare``
      rebuilds dataloaders;
    - ``project_dir`` / ``project_config``: where checkpoints go;
    - ``step_scheduler_with_optimizer``: the scheduler holds back while
      gradients accumulate.
    """

    def __init__(self, cpu: bool = False, device=None, gradient_accumulation_steps: int = 1,
                 split_batches: bool = False,
                 dataloader_config: Optional[DataLoaderConfiguration] = None,
                 project_dir: Optional[str] = None,
                 project_config: Optional[ProjectConfiguration] = None,
                 gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
                 step_scheduler_with_optimizer: bool = True):
        if cpu and device is not None and str(device) != "cpu":
            raise ValueError(f"cpu=True contradicts device={device!r}")
        self.device = resolve_device("cpu" if cpu else device)
        self.project_configuration = project_config or ProjectConfiguration()
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.project_dir = project_dir
        self.dataloader_config = dataloader_config or DataLoaderConfiguration(
            split_batches=split_batches)
        self.gradient_state = GradientState(
            gradient_accumulation_plugin
            or GradientAccumulationPlugin(num_steps=gradient_accumulation_steps))
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        self._models: List[nn.Module] = []
        self._optimizers: List[AcceleratedOptimizer] = []
        self._schedulers: List[AcceleratedScheduler] = []
        self._dataloaders: List[DataLoaderShard] = []
        self._custom_objects: list = []
        self._save_state_pre_hooks: dict = {}
        self._load_state_pre_hooks: dict = {}
        self.last_save_timing: Optional[dict] = None
        self.last_load_timing: Optional[dict] = None
        self._preemption_guard = None

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

    def prepare(self, *args):
        """Prepare models and dataloaders first, then optimizers (each paired
        with the model whose parameters it holds), then schedulers (each
        driving the prepared optimizers); anything else passes through.
        Returns the objects in order (one object unwrapped)."""
        staged = {}
        for i, obj in enumerate(args):
            if isinstance(obj, nn.Module):
                staged[i] = self.prepare_model(obj)
            elif isinstance(obj, (torch.utils.data.DataLoader, DataLoaderShard)):
                staged[i] = self.prepare_data_loader(obj)
        for i, obj in enumerate(args):
            if i not in staged and isinstance(obj, (torch.optim.Optimizer, AcceleratedOptimizer)):
                staged[i] = self.prepare_optimizer(obj)
        for i, obj in enumerate(args):
            if i not in staged:
                staged[i] = self.prepare_scheduler(obj) if _is_scheduler_like(obj) else obj
        out = [staged[i] for i in range(len(args))]
        return out[0] if len(out) == 1 else tuple(out)

    def prepare_data_loader(self, data_loader):
        """Wrap a torch ``DataLoader`` (or any iterable of batches) as a
        :class:`~accelerate_tpu_torch.data_loader.DataLoaderShard` that
        yields batches on this accelerator's device and tells
        :meth:`accumulate` about its last batch."""
        if isinstance(data_loader, DataLoaderShard):
            if not any(data_loader is d for d in self._dataloaders):
                self._dataloaders.append(data_loader)
            return data_loader
        cfg = self.dataloader_config
        prepared = prepare_data_loader(
            data_loader, device=self.device, split_batches=cfg.split_batches,
            even_batches=cfg.even_batches, use_seedable_sampler=cfg.use_seedable_sampler,
            data_seed=cfg.data_seed, non_blocking=cfg.non_blocking,
            use_stateful_dataloader=cfg.use_stateful_dataloader,
            static_shape_tail=cfg.static_shape_tail, prefetch_to_device=cfg.prefetch_to_device,
            gradient_state=self.gradient_state)
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

    def prepare_model(self, model: nn.Module) -> nn.Module:
        """Move ``model`` (an ``nn.Module`` or a :class:`FunctionalModel`) to
        this accelerator's device in place (its ``Parameter`` objects stay
        the same, so an optimizer built over them stays valid) and register
        it."""
        if not isinstance(model, nn.Module):
            raise TypeError(f"prepare_model takes an nn.Module or a FunctionalModel, "
                            f"got {type(model).__name__}")
        if not any(model is m for m in self._models):
            model.to(self.device)
            self._models.append(model)
        return model

    def prepare_optimizer(self, optimizer: torch.optim.Optimizer) -> AcceleratedOptimizer:
        """Wrap ``optimizer``, paired by parameter identity with the prepared
        model that owns its parameters."""
        if isinstance(optimizer, AcceleratedOptimizer):
            return optimizer
        ids = {id(p) for group in optimizer.param_groups for p in group["params"]}
        for model in reversed(self._models):
            if any(id(p) in ids for p in model.parameters()):
                prepared = AcceleratedOptimizer(optimizer, model, self.gradient_state)
                self._optimizers.append(prepared)
                return prepared
        raise ValueError("prepare the model before (or together with) its optimizer: no "
                         "prepared model owns this optimizer's parameters")

    # -- the eager training loop ---------------------------------------------

    def _trainable(self) -> List[torch.Tensor]:
        return [p for m in self._models for p in m.parameters() if p.requires_grad]

    def backward(self, loss: torch.Tensor) -> None:
        """Accumulate ``d loss / d params * (1 / gradient_accumulation_steps)``
        into the prepared models' ``.grad``: each micro-gradient is scaled,
        then added, the order ``make_train_step`` uses."""
        params = self._trainable()
        grads = torch.autograd.grad(loss.float().mean(), params, allow_unused=True)
        summed = accumulate_grads([p.grad for p in params], grads,
                                  1.0 / self.gradient_accumulation_steps)
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
        and return the accumulated gradients' current norm (None before any
        backward).  The norm is always the global 2-norm: like the JAX
        ``Accelerator``, another ``norm_type`` is ignored, with a warning."""
        if norm_type != 2.0:
            warnings.warn(f"clip_grad_norm_ ignores norm_type={norm_type}: it clips to and "
                          "returns the global 2-norm", stacklevel=2)
        for opt in self._optimizers:
            opt._clip_norm_once = float(max_norm)
        grads = [p.grad for p in self._trainable() if p.grad is not None]
        return global_norm(grads) if grads else None

    def clip_grad_value_(self, parameters=None, clip_value: float = 1.0) -> None:
        """Arm elementwise gradient clipping for the next optimizer step
        (one shot)."""
        for opt in self._optimizers:
            opt._clip_value_once = float(clip_value)

    def make_train_step(self, model, optimizer, accum_steps=None, clip_norm=None,
                        clip_value=None):
        """The whole optimizer step in one call (see
        :mod:`accelerate_tpu_torch.pipeline.train_step`)::

            model, opt = accelerator.prepare(model, torch.optim.AdamW(model.parameters()))
            step_fn = accelerator.make_train_step(model, opt)
            loss = step_fn(batch)            # accum_steps == 1
            losses = step_fn([b1, b2, b3])   # accum_steps == 3
        """
        from .pipeline.train_step import make_train_step

        return make_train_step(self, model, optimizer, accum_steps=accum_steps,
                               clip_norm=clip_norm, clip_value=clip_value)

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

    def save_state(self, output_dir: Optional[str] = None, step: Optional[int] = None) -> str:
        """Write a verified checkpoint of everything prepared (see
        :mod:`accelerate_tpu_torch.checkpointing`) and return its directory;
        under automatic naming it is
        ``<project_dir>/checkpoints/checkpoint_<iteration>``."""
        from .checkpointing import save_accelerator_state

        return save_accelerator_state(self, output_dir, step=step)

    def load_state(self, input_dir: Optional[str] = None) -> str:
        """Restore a checkpoint written by :meth:`save_state` (verified
        against its manifest first) and return its directory."""
        from .checkpointing import load_accelerator_state

        return load_accelerator_state(self, input_dir)

    def save_model(self, model, save_directory: str, max_shard_size="10GB") -> str:
        """``model``'s weights as safetensors under ``save_directory``."""
        from .checkpointing import save_model_weights

        return save_model_weights(model, save_directory, max_shard_size=max_shard_size)

    def get_state_dict(self, model) -> dict:
        return model.state_dict()

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        return skip_first_batches(dataloader, num_batches)

    def resume_from_latest(self, checkpoint_dir: Optional[str] = None) -> Optional[int]:
        """Restore the newest manifest-complete checkpoint under
        ``checkpoint_dir`` (default ``<project_dir>/checkpoints``), passing
        over torn partials, and return the step its manifest records (0
        when none), or None when there is no complete checkpoint.  Automatic
        naming continues after the checkpoint resumed from."""
        from .resilience.manifest import find_latest_complete, read_manifest

        root = checkpoint_dir or os.path.join(self.project_dir or ".", "checkpoints")
        ckpt = find_latest_complete(root)
        if ckpt is None:
            return None
        step = (read_manifest(ckpt) or {}).get("step")
        self.load_state(ckpt)
        tail = os.path.basename(ckpt).rsplit("_", 1)[-1]
        if os.path.basename(ckpt).startswith("checkpoint_") and tail.isdigit():
            self.project_configuration.iteration = int(tail) + 1
        return int(step) if step is not None else 0

    # -- preemption ---------------------------------------------------------------

    def enable_preemption_handling(self, save_dir: Optional[str] = None, signals=None):
        """Install a :class:`~accelerate_tpu_torch.resilience.PreemptionGuard`
        for this process (idempotent) and return it.  ``save_dir`` is where
        :meth:`check_preemption` writes the final checkpoint; without it,
        automatic checkpoint naming must be on.  Serving engines built by
        :meth:`prepare_serving` afterwards drain on the signal."""
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
            self._preemption_guard = PreemptionGuard(**kwargs).install()
        if save_dir is not None:
            self._preemption_guard.save_dir = save_dir
        return self._preemption_guard

    def check_preemption(self, save_dir: Optional[str] = None, step: Optional[int] = None) -> bool:
        """Call once per step at the step boundary.  Returns True once the
        installed guard saw its signal, after writing ONE final verified
        checkpoint (to ``save_dir``, the guard's directory, or automatic
        naming) whose manifest records ``step`` for
        :meth:`resume_from_latest`; the caller then leaves its loop.
        Without a guard it returns False."""
        guard = self._preemption_guard
        if guard is None or not guard.should_stop():
            return False
        if not guard.final_checkpoint_saved:
            self.save_state(save_dir or guard.save_dir, step=step)
            guard.final_checkpoint_saved = True
        return True

    # -- serving ----------------------------------------------------------------

    def prepare_serving(self, apply_cached, init_cache, params, config, serving=None,
                        **serving_kwargs):
        """Build a continuous-batching :class:`~accelerate_tpu_torch.serving.ServingEngine`
        on this accelerator's device over a model family's cached-decode pair
        (paged KV cache, LIFO preemption, chunked prefill, one decode
        forward per tick, greedy outputs token-identical to ``generate``).
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
        """
        from .serving import ServingConfig, ServingEngine

        if serving is not None and serving_kwargs:
            raise ValueError("pass either a ServingConfig or its fields, not both")
        if serving is None:
            serving = ServingConfig(**serving_kwargs)
        engine = ServingEngine(apply_cached, init_cache, params, config, serving=serving,
                               device=self.device)
        if self._preemption_guard is not None:
            engine.install_preemption_guard(self._preemption_guard)
        return engine


def _is_scheduler_like(obj) -> bool:
    """A callable ``step -> lr``, or an object with ``step`` and
    ``get_last_lr`` (every torch LR scheduler)."""
    if callable(obj) and not hasattr(obj, "step"):
        return True
    return hasattr(obj, "step") and hasattr(obj, "get_last_lr")
