"""Optimizer wrapper with the JAX package's update semantics.

:class:`AcceleratedOptimizer` wraps a ``torch.optim.Optimizer`` so a
training loop keeps its ``optimizer.step()`` / ``zero_grad()`` shape:
both are no-ops while gradients are accumulating (``sync_gradients`` is
False), and a real step runs :func:`_update_body`, the update of the JAX
``optimizer._update_body``:

- the pre-clip global norm is the health verdict, ANDed with the loss being
  finite when the caller knows it (the fused step does); a failed verdict
  leaves the parameters and the optimizer's state untouched, its step count
  included;
- the value clip (elementwise) comes first, then the norm clip with scale
  ``min(1, clip_norm / max(gnorm, 1e-12))`` on the post-value-clip norm
  (not ``torch.nn.utils.clip_grad_norm_``'s ``norm + 1e-6``);
- a negative clip disables it; 0 is a real clip.

Under the NaN fault (``ACCELERATE_TPU_FAULT_NAN_STEP``,
:mod:`.resilience.faultinject`) the gradients of the armed update are
multiplied by a device scalar (NaN on an armed step, else 1) before the
gate: one ``_foreach_mul``, no host sync.  Unarmed, nothing is added.

The JAX body's dp-chunked norm (``norm_ndp``) belongs to multi-device
meshes and is not ported.  torch's ``AdamW`` is optax's ``adamw`` when both
use ``betas=(0.9, 0.999)``, ``eps=1e-8`` and the same ``weight_decay``
(torch defaults to 1e-2, optax to 1e-4).

With telemetry on, a real ``step()`` runs under the ``optimizer.step`` span,
counts one dispatch and records one completed step (step time, MFU, device
memory gauges): host-side bookkeeping only, no further device sync than the
update's own verdict read.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from .state import GradientState
from .telemetry import get_telemetry as _get_telemetry
from .telemetry import span as _span

__all__ = ["AcceleratedOptimizer", "global_norm"]


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax's
    ``global_norm``: one sum per tensor, then the sum over tensors)."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def _update_body(optimizer: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                 grads: List[torch.Tensor], clip_norm: float, clip_value: float,
                 health_ok: Optional[torch.Tensor] = None):
    """Health gate, value clip, norm clip, then ``optimizer.step()`` on
    ``params`` with ``grads`` as their ``.grad``.  Returns ``(gnorm,
    health_norm, ok)``: the post-value-clip norm the clip used, the pre-clip
    norm (NaN when ``health_ok`` is False) and the verdict, all device
    scalars.  Reading the verdict to skip the update is one host sync."""
    gnorm = global_norm(grads)
    ok = torch.isfinite(gnorm)
    health_norm = gnorm
    if health_ok is not None:
        ok = ok & health_ok
        health_norm = torch.where(health_ok, gnorm, torch.nan)
    if clip_value >= 0:
        grads = [g.clamp(-clip_value, clip_value) for g in grads]
        gnorm = global_norm(grads)
    if clip_norm >= 0:
        limit = torch.tensor(clip_norm, dtype=torch.float32, device=gnorm.device)
        scale = torch.clamp(limit / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = [g * scale for g in grads]
    if bool(ok):
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
    return gnorm, health_norm, ok


class AcceleratedOptimizer:
    """A prepared ``torch.optim.Optimizer`` paired with its model.

    ``step()`` is a no-op while accumulating and runs :func:`_update_body`
    on every parameter holding a gradient otherwise; ``zero_grad()`` clears
    gradients only on a sync step.  The one-shot clips armed by
    ``Accelerator.clip_grad_norm_``/``clip_grad_value_`` apply to the next
    real update only."""

    def __init__(self, optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                 gradient_state: GradientState):
        self.optimizer = optimizer
        self.model = model
        self.gradient_state = gradient_state
        self._clip_norm_once: Optional[float] = None
        self._clip_value_once: Optional[float] = None
        self._step_count = 0
        self._step_was_skipped = False
        self._last_grad_norm = None
        self._last_health_norm = None
        self._poison_scalars = None

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    @property
    def step_was_skipped(self) -> bool:
        return self._step_was_skipped

    @property
    def param_groups(self) -> list:
        return self.optimizer.param_groups

    @property
    def learning_rate(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def set_learning_rate(self, lr: float) -> None:
        """Write ``lr`` into every parameter group, only when the groups
        share one LR: distinct group LRs are a per-group schedule that its
        torch scheduler advances itself."""
        groups = self.optimizer.param_groups
        if len({float(g["lr"]) for g in groups}) <= 1:
            for group in groups:
                group["lr"] = lr

    def state_dict(self) -> dict:
        """The torch optimizer's own ``state_dict()`` (live tensors, not
        copies) and the count of updates taken."""
        return {"optimizer": self.optimizer.state_dict(), "step_count": self._step_count}

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore :meth:`state_dict`'s output; torch moves each state
        tensor to its parameter's device."""
        self.optimizer.load_state_dict(state_dict["optimizer"])
        self._step_count = int(state_dict.get("step_count", 0))

    def zero_grad(self, set_to_none: bool = True) -> None:
        if self.gradient_state.sync_gradients:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    def _resolve_clips(self, clip_norm: Optional[float] = None,
                       clip_value: Optional[float] = None):
        """One-shot clips first (consumed here), then the caller's; -1 (off)
        without either."""
        norm = self._clip_norm_once if self._clip_norm_once is not None else (
            clip_norm if clip_norm is not None else -1.0)
        value = self._clip_value_once if self._clip_value_once is not None else (
            clip_value if clip_value is not None else -1.0)
        self._clip_norm_once = self._clip_value_once = None
        return norm, value

    def _poison_scale(self) -> torch.Tensor:
        """The NaN fault's device scalar for the coming update: NaN when
        :func:`~.resilience.faultinject.grad_poison_scale` fires for it,
        else 1.  Both scalars are made once, so a step picks one and copies
        nothing to the device."""
        from .resilience import faultinject

        if self._poison_scalars is None:
            dev = self.params[0].device
            self._poison_scalars = (torch.ones((), device=dev),
                                    torch.full((), float("nan"), device=dev))
        fires = faultinject.grad_poison_scale(self._step_count + 1) is not None
        return self._poison_scalars[int(fires)]

    def _apply_update(self, params, grads, health_ok=None, clip_norm=None, clip_value=None,
                      poison: Optional[torch.Tensor] = None):
        if poison is not None:
            grads = torch._foreach_mul(grads, poison)
        norm, value = self._resolve_clips(clip_norm, clip_value)
        gnorm, health_norm, _ = _update_body(self.optimizer, params, grads, norm, value,
                                             health_ok=health_ok)
        self._last_grad_norm = gnorm
        self._last_health_norm = health_norm
        self._step_was_skipped = False
        self._step_count += 1
        return gnorm, health_norm

    def step(self, closure: Optional[Callable] = None):
        """One update on a sync step.  A ``closure`` (which recomputes the
        loss and its gradients) runs first, under ``torch.enable_grad()``,
        and its loss is returned: torch's ``Optimizer.step(closure)``
        contract, which the JAX ``AcceleratedOptimizer.step`` accepts and
        ignores (optax has no closure).  The port follows torch because a
        torch loop that passes a closure relies on the gradients it computes.
        While gradients accumulate the closure does not run, as the step
        does not."""
        if not self.gradient_state.sync_gradients:
            self._step_was_skipped = True
            return None
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for p in self.params if p.grad is not None]
        if not params:
            self._step_was_skipped = True
            return loss
        from .resilience import faultinject

        with _span("optimizer.step"):
            _get_telemetry().count_dispatch()  # the update
            poison = self._poison_scale() if faultinject.nan_armed() else None
            self._apply_update(params, [p.grad for p in params], poison=poison)
        # A completed step is the telemetry heartbeat: step-time histogram,
        # tokens/sec + MFU gauges, device memory gauges, watchdog beat.
        _get_telemetry().record_step()
        return loss
