"""The port's ``Accelerator``: device placement, training and serving.

Training (single GPU): :meth:`Accelerator.prepare` places models and pairs
optimizers with them, :meth:`~Accelerator.backward` / ``optimizer.step()``
/ :meth:`~Accelerator.accumulate` run the eager loop, and
:meth:`~Accelerator.make_train_step` runs the whole optimizer step in one
call with the same numerics.  Serving: :meth:`~Accelerator.prepare_serving`.

``prepare`` takes an ``nn.Module`` directly, so the JAX package's
``utils/torch_bridge.py`` (FX graph -> JAX lowering of torch modules) has no
counterpart here; functional models come as :class:`FunctionalModel`.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, List

import torch
from torch import nn

from .optimizer import AcceleratedOptimizer, global_norm
from .pipeline.train_step import accumulate_grads
from .state import GradientState, resolve_device

__all__ = ["Accelerator", "FunctionalModel"]


class FunctionalModel(nn.Module):
    """A pure ``apply_fn(params, *args, **batch)`` plus its parameter tree
    (nested dicts of tensors): the port's
    ``accelerate_tpu.accelerator.JaxModel``.  The tree's tensor leaves
    become ``nn.Parameter``s (registered, so ``parameters()`` and
    ``.to()`` see them); ``params`` is the tree with those leaves, and
    ``model(**batch)`` is ``apply_fn(params, **batch)``, which returns
    ``{"loss": ...}`` for training."""

    def __init__(self, apply_fn: Callable, params: Any):
        super().__init__()
        self.apply_fn = apply_fn
        self._leaves = nn.ParameterList()

        def wrap(tree):
            if isinstance(tree, dict):
                return {k: wrap(v) for k, v in tree.items()}
            if isinstance(tree, torch.Tensor):
                leaf = tree if isinstance(tree, nn.Parameter) else nn.Parameter(tree)
                self._leaves.append(leaf)
                return leaf
            return tree

        self.params = wrap(params)

    def forward(self, *args, **kwargs):
        return self.apply_fn(self.params, *args, **kwargs)


class Accelerator:
    """``Accelerator(cpu=False)`` runs on the GPU (raising without CUDA);
    ``cpu=True`` or ``device="cpu"`` keeps everything on the host.
    ``gradient_accumulation_steps`` micro-batches make one optimizer step."""

    def __init__(self, cpu: bool = False, device=None, gradient_accumulation_steps: int = 1):
        if cpu and device is not None and str(device) != "cpu":
            raise ValueError(f"cpu=True contradicts device={device!r}")
        self.device = resolve_device("cpu" if cpu else device)
        self.gradient_state = GradientState(gradient_accumulation_steps)
        self._models: List[nn.Module] = []
        self._optimizers: List[AcceleratedOptimizer] = []

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

    # -- preparation ------------------------------------------------------------

    def prepare(self, *args):
        """Prepare models first, then optimizers (each paired with the model
        whose parameters it holds); anything else passes through.  Returns
        the objects in order (one object unwrapped)."""
        staged = {}
        for i, obj in enumerate(args):
            if isinstance(obj, nn.Module):
                staged[i] = self.prepare_model(obj)
        for i, obj in enumerate(args):
            if i not in staged:
                staged[i] = (self.prepare_optimizer(obj)
                             if isinstance(obj, torch.optim.Optimizer) else obj)
        out = [staged[i] for i in range(len(args))]
        return out[0] if len(out) == 1 else tuple(out)

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
        ``gradient_accumulation_steps``-th, and ``optimizer.step()`` /
        ``zero_grad()`` act only then."""
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
        """
        from .serving import ServingConfig, ServingEngine

        if serving is not None and serving_kwargs:
            raise ValueError("pass either a ServingConfig or its fields, not both")
        if serving is None:
            serving = ServingConfig(**serving_kwargs)
        return ServingEngine(apply_cached, init_cache, params, config, serving=serving,
                             device=self.device)
