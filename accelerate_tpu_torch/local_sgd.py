"""Local SGD: synchronise parameters every K steps instead of gradients every
step.  The JAX package's ``accelerate_tpu/local_sgd.py``.

``enabled`` needs ``accelerator.use_distributed``, as in the JAX package, so
at one process :class:`LocalSGD` is a no-op: the context manager sets
nothing and ``step`` only counts.  With several processes the optimizers
keep their gradients local inside the context (each replica steps on its
own), and every ``local_sgd_steps`` steps, and on exit, the parameters are
averaged over the processes (``reduce(param, "mean")``, an all-reduce per
parameter).
"""

from __future__ import annotations

__all__ = ["LocalSGD"]


class LocalSGD:
    """Context manager; call ``.step()`` once per optimizer step::

        with LocalSGD(accelerator=acc, model=model, local_sgd_steps=8) as lsgd:
            for batch in dl:
                ...
                optimizer.step()
                lsgd.step()
    """

    def __init__(self, accelerator, model, local_sgd_steps: int = 8, enabled: bool = True):
        self.accelerator = accelerator
        self.model = model
        self.local_sgd_steps = local_sgd_steps
        self.enabled = enabled and accelerator.use_distributed
        self.num_steps = 0

    def __enter__(self):
        if self.enabled:
            self.accelerator.gradient_state.local_sgd = True
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self.accelerator.gradient_state.local_sgd = False
            self._sync_params()

    def step(self):
        self.num_steps += 1
        if not self.enabled:
            return
        if self.num_steps % self.local_sgd_steps == 0:
            self._sync_params()

    def _sync_params(self):
        """Every parameter replaced by its mean over the processes."""
        import torch

        from .parallel import collectives

        n = collectives.world_size()
        with torch.no_grad():
            for p in self.model.parameters():
                p.data.copy_(collectives.all_reduce(p.detach().clone()).div(n))
