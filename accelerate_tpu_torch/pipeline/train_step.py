"""The whole optimizer step in one call: ``Accelerator.make_train_step``.

The JAX package compiles the step into one donated program; here it is
eager PyTorch (capturing it as a CUDA graph is later work).  What it keeps
is the contract:

- ``step_fn(batch)`` runs forward, backward and the update from one
  micro-batch and returns the scalar loss (``accum_steps == 1``);
- ``step_fn([b1, ..., bN])`` runs an N-micro-batch accumulation window and
  returns the per-micro-batch losses: each micro-gradient is scaled by
  ``1/N`` and added in order (the first one assigned), exactly as the eager
  ``Accelerator.backward`` accumulates, so the fused and the eager loop
  agree bit for bit;
- then the health gate (loss finite and pre-clip norm finite), the value
  and norm clips and the optimizer update of ``optimizer._update_body``.

The prepared model and optimizer stay the source of truth: parameters and
optimizer state are updated in place.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from ..utils.operations import send_to_device

__all__ = ["TrainStep", "make_train_step"]


def micro_loss(model, batch) -> torch.Tensor:
    """Run ``model`` on one micro-batch and return its fp32 scalar loss.
    A mapping is passed as keyword arguments, a tuple as positional ones,
    anything else as one argument; the output is ``{"loss": ...}``, a tuple
    whose first element is the loss, or the loss itself."""
    if isinstance(batch, Mapping):
        out = model(**batch)
    elif isinstance(batch, tuple):
        out = model(*batch)
    else:
        out = model(batch)
    loss = out["loss"] if isinstance(out, Mapping) else out[0] if isinstance(out, tuple) else out
    return loss.float().mean()


def accumulate_grads(acc, grads, scale: float):
    """``acc[i] + grads[i] * scale`` (``grads[i] * scale`` where ``acc[i]``
    is None); a None gradient leaves its slot as it was.  A scale of 1 is
    skipped: ``g * 1.0`` is ``g`` bit for bit, and the copy would cost a
    pass over every gradient."""
    out = []
    for a, g in zip(acc, grads):
        if g is None:
            out.append(a)
            continue
        s = g if scale == 1.0 else g * scale
        out.append(s if a is None else a + s)
    return out


class TrainStep:
    """Callable returned by :meth:`Accelerator.make_train_step`.  Records
    ``last_grad_norm`` (post-value-clip norm), ``last_health_norm`` (pre-clip
    norm, NaN when the step was gated), ``step_count`` and
    ``dispatch_count`` (calls)."""

    def __init__(self, accelerator, model, optimizer, accum_steps: Optional[int] = None,
                 clip_norm: Optional[float] = None, clip_value: Optional[float] = None):
        from ..optimizer import AcceleratedOptimizer

        if not any(model is m for m in accelerator._models):
            raise TypeError("make_train_step needs a model returned by this accelerator's "
                            f"prepare(); got {type(model).__name__}")
        if not isinstance(optimizer, AcceleratedOptimizer):
            raise TypeError("make_train_step needs the AcceleratedOptimizer returned by "
                            f"prepare(); got {type(optimizer).__name__}")
        if optimizer.model is not model:
            raise ValueError("optimizer is not paired with this model: prepare them together")
        self.accelerator = accelerator
        self.model = model
        self.optimizer = optimizer
        self.accum_steps = int(accum_steps if accum_steps is not None
                               else accelerator.gradient_accumulation_steps)
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {self.accum_steps}")
        self.clip_norm = clip_norm
        self.clip_value = clip_value
        self.last_grad_norm = None
        self.last_health_norm = None
        self.step_count = 0
        self.dispatch_count = 0

    def __call__(self, *batches):
        if len(batches) == 1 and isinstance(batches[0], list):
            batches = tuple(batches[0])
        if len(batches) != self.accum_steps:
            raise ValueError(
                f"train step was built for {self.accum_steps} micro-batch"
                f"{'es' if self.accum_steps > 1 else ''} per optimizer step but received "
                f"{len(batches)}: pass the accumulation window as a LIST of micro-batches"
            )
        opt = self.optimizer
        params = [p for p in opt.params if p.requires_grad]
        scale = 1.0 / self.accum_steps
        grads = [None] * len(params)
        losses = []
        for batch in batches:
            loss = micro_loss(self.model, send_to_device(batch, self.accelerator.device))
            micro = torch.autograd.grad(loss, params, allow_unused=True)
            grads = accumulate_grads(grads, micro, scale)
            losses.append(loss.detach())
        losses = torch.stack(losses)
        live = [(p, g) for p, g in zip(params, grads) if g is not None]
        gnorm, health_norm = opt._apply_update(
            [p for p, _ in live], [g for _, g in live], health_ok=torch.isfinite(losses).all(),
            clip_norm=self.clip_norm, clip_value=self.clip_value,
        )
        for p in params:
            p.grad = None
        opt.gradient_state.sync_gradients = True
        self.last_grad_norm = gnorm
        self.last_health_norm = health_norm
        self.step_count += 1
        self.dispatch_count += 1
        return losses[0] if self.accum_steps == 1 else losses


def make_train_step(accelerator, model, optimizer, accum_steps: Optional[int] = None,
                    clip_norm: Optional[float] = None,
                    clip_value: Optional[float] = None) -> TrainStep:
    """Build a :class:`TrainStep` (the function behind
    :meth:`Accelerator.make_train_step`)."""
    return TrainStep(accelerator, model, optimizer, accum_steps=accum_steps,
                     clip_norm=clip_norm, clip_value=clip_value)
