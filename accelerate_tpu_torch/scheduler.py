"""LR scheduler wrapper: the JAX package's ``AcceleratedScheduler``.

It wraps a torch LR scheduler (attached to the prepared optimizer's torch
optimizer) or any callable ``step -> lr``:

- with ``step_with_optimizer`` (the default) ``step()`` does nothing while
  gradients accumulate or when an optimizer skipped its update; otherwise
  it advances the schedule once (the JAX package steps once per data shard,
  and one GPU is one shard), and ``split_batches`` keeps it at once;
- without it, every ``step()`` advances the schedule;
- after each advance the LR is written into the optimizers'
  ``param_groups`` (all groups only when they share one LR: a torch
  scheduler with per-group LRs has set each group already);
- ``state_dict`` is the torch scheduler's plus ``accelerate_step_count``
  (``{"step_count": n}`` for a callable).
"""

from __future__ import annotations

from .state import GradientState

__all__ = ["AcceleratedScheduler"]


class AcceleratedScheduler:
    def __init__(self, scheduler, optimizers, step_with_optimizer: bool = True,
                 split_batches: bool = False, gradient_state=None):
        self.scheduler = scheduler
        self.optimizers = optimizers if isinstance(optimizers, (list, tuple)) else [optimizers]
        self.split_batches = split_batches
        self.step_with_optimizer = step_with_optimizer
        self.gradient_state = gradient_state if gradient_state is not None else GradientState()
        self._is_callable = callable(scheduler) and not hasattr(scheduler, "step")
        self._step_count = 0

    def _apply_lr(self):
        lr = self.get_last_lr()[0]
        for opt in self.optimizers:
            opt.set_learning_rate(lr)

    def step(self, *args, **kwargs):
        if self.step_with_optimizer and (
            not self.gradient_state.sync_gradients
            or any(getattr(opt, "step_was_skipped", False) for opt in self.optimizers)
        ):
            return
        self._step_count += 1
        if not self._is_callable:
            self.scheduler.step(*args, **kwargs)
        self._apply_lr()

    def get_last_lr(self):
        if self._is_callable:
            return [float(self.scheduler(self._step_count))]
        return self.scheduler.get_last_lr()

    def state_dict(self):
        if self._is_callable:
            return {"step_count": self._step_count}
        sd = self.scheduler.state_dict()
        sd["accelerate_step_count"] = self._step_count
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self._step_count = state_dict.pop("accelerate_step_count",
                                          state_dict.get("step_count", 0))
        if not self._is_callable:
            self.scheduler.load_state_dict(state_dict)
        self._apply_lr()
