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

The NaN fault (``ACCELERATE_TPU_FAULT_NAN_STEP``) is looked up once, when
the step is built: an armed step multiplies its gradients by a device
scalar (1, or NaN on an armed update) before the gate, which adds no host
sync and leaves the flash kernels' launches as they are; an unarmed one
carries nothing.

The prepared model and optimizer stay the source of truth: parameters and
optimizer state are updated in place.

With several processes each one runs the forward and backward on its own
rows, accumulates its window's gradients locally, and the update averages
them over the data-parallel group (one collective per gradient, after the
window: the order the eager loop under ``no_sync`` takes).  The losses a
call returns are the mean over the data shards, the global batch's loss for
even batches, and the health gate reads them.  On an ``fsdp`` / ``tp`` mesh
the same step runs on each process's shards (``optimizer.py``).  ``zero=True`` (None: the
``ACCELERATE_TPU_ZERO`` env) shards the update (:mod:`..parallel.zero`):
per leaf a reduce-scatter along its shard dim, the gate and clips on the
canonical norm, the optimizer on the local shard, then an all-gather of
the parameters; ``zero_active`` says whether it runs.  On a mesh that
cannot take it (one process, or model axes) it warns and runs the
replicated step, as the JAX package does.  A step the gate skips leaves
the shards and the optimizer's state as they were.

With telemetry on, each call runs under the ``pipeline.train_step`` span,
counts one dispatch and records one completed step; after the first update
the parameters and the optimizer's state are ``train.params`` /
``train.opt_state`` reservations in the memory ledger (their storage bytes;
torch creates the optimizer's state at its first step).
"""

from __future__ import annotations

import warnings
from typing import Mapping, Optional

import torch

from ..telemetry import get_telemetry as _get_telemetry
from ..telemetry import span as _span
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


def accumulate_grads(acc, grads, scale: float, hold_dtype=None):
    """``acc[i] + grads[i] * scale`` (``grads[i] * scale`` where ``acc[i]``
    is None); a None gradient leaves its slot as it was.  A scale of 1 is
    skipped: ``g * 1.0`` is ``g`` bit for bit, and the copy would cost a
    pass over every gradient.  With ``hold_dtype`` (bf16 under a
    ``comm_hook``) the scaled gradient is rounded to it and added to the
    sum in it, the rounding of the JAX ``PreparedModel._accumulate``, and
    the result comes back in the gradient's own dtype (a ``.grad`` keeps
    its parameter's)."""
    out = []
    for a, g in zip(acc, grads):
        if g is None:
            out.append(a)
            continue
        s = g if scale == 1.0 else g * scale
        if hold_dtype is None:
            out.append(s if a is None else a + s)
        else:
            s = s.to(hold_dtype)
            out.append((s if a is None else a.to(hold_dtype) + s).to(g.dtype))
    return out


class TrainStep:
    """Callable returned by :meth:`Accelerator.make_train_step`.  Records
    ``last_grad_norm`` (post-value-clip norm), ``last_health_norm`` (pre-clip
    norm, NaN when the step was gated), ``step_count``, ``dispatch_count``
    (calls), ``zero_config`` and ``zero_active``."""

    def __init__(self, accelerator, model, optimizer, accum_steps: Optional[int] = None,
                 clip_norm: Optional[float] = None, clip_value: Optional[float] = None,
                 zero=None):
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
        self._ledger_registered = False
        from ..resilience import faultinject

        self._poison_armed = faultinject.nan_armed()
        from ..parallel import zero as zero_mod

        self.zero_config = zero_mod.ZeROConfig.resolve(zero)
        self.zero_active = False
        mesh = accelerator.mesh
        if self.zero_config.enabled:
            ok, reason = zero_mod.supported(mesh)
            if not ok:
                warnings.warn(
                    f"ZeRO sharded update requested but unsupported here: {reason}. "
                    "Falling back to the replicated fused update.")
            else:
                self.zero_active = True
                if self.zero_config.overlap_effective:
                    zero_mod.enable_overlap_flags()
        if self.zero_active:
            optimizer._enable_zero(mesh)
        # An optimizer a ZeRO step sharded keeps its shards.
        self.zero_active = optimizer._zero is not None
        optimizer._opt_state_layout = zero_mod.opt_state_layout(mesh, self.zero_active)

    def _register_ledger(self) -> None:
        """The train state's long-lived reservations, computed from the live
        parameters and optimizer state (integers only: the ledger keeps no
        reference to a tensor)."""
        from ..telemetry.memledger import get_memory_ledger

        ledger = get_memory_ledger()
        ledger.register("train.params", tree=[p for p in self.model.parameters()],
                        detail={"zero_active": self.zero_active})
        ledger.register("train.opt_state", tree=self.optimizer.optimizer,
                        detail={"zero_active": self.zero_active})
        self._ledger_registered = True

    def __call__(self, *batches):
        if len(batches) == 1 and isinstance(batches[0], list):
            batches = tuple(batches[0])
        if len(batches) != self.accum_steps:
            raise ValueError(
                f"train step was built for {self.accum_steps} micro-batch"
                f"{'es' if self.accum_steps > 1 else ''} per optimizer step but received "
                f"{len(batches)}: pass the accumulation window as a LIST of micro-batches"
            )
        with _span("pipeline.train_step"):
            losses = self._step(batches)
        if not self._ledger_registered:
            self._register_ledger()
        tel = _get_telemetry()
        tel.count_dispatch()
        tel.record_step()
        return losses[0] if self.accum_steps == 1 else losses

    def _step(self, batches):
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
        if opt.dp_degree > 1 and not opt.gradient_state.local_sgd:
            from ..parallel import collectives

            # The mean over the processes: the global batch's loss.
            losses = collectives.all_reduce(losses, group=opt._dp_group()).div(opt.dp_degree)
        live = [(p, g) for p, g in zip(params, grads) if g is not None]
        gnorm, health_norm = opt._apply_update(
            [p for p, _ in live], [g for _, g in live], health_ok=torch.isfinite(losses).all(),
            clip_norm=self.clip_norm, clip_value=self.clip_value,
            poison=opt._poison_scale() if self._poison_armed else None,
        )
        for p in params:
            p.grad = None
        opt.gradient_state.sync_gradients = True
        self.last_grad_norm = gnorm
        self.last_health_norm = health_norm
        self.step_count += 1
        self.dispatch_count += 1
        return losses


def make_train_step(accelerator, model, optimizer, accum_steps: Optional[int] = None,
                    clip_norm: Optional[float] = None,
                    clip_value: Optional[float] = None, zero=None) -> TrainStep:
    """Build a :class:`TrainStep` (the function behind
    :meth:`Accelerator.make_train_step`); ``zero``: True / False / a
    :class:`~accelerate_tpu_torch.parallel.zero.ZeROConfig`, None for the
    env."""
    return TrainStep(accelerator, model, optimizer, accum_steps=accum_steps,
                     clip_norm=clip_norm, clip_value=clip_value, zero=zero)
