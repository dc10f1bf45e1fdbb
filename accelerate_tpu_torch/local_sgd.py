"""Local SGD: synchronise parameters every K steps instead of gradients every
step.  The JAX package's ``accelerate_tpu/local_sgd.py`` at one process.

``enabled`` needs ``accelerator.use_distributed``, as in the JAX package, so
at one process :class:`LocalSGD` is a no-op: the context manager sets
nothing and ``step`` only counts.  The parameter average across data-parallel
replicas (a ``reduce(param, "mean")`` every ``local_sgd_steps``) waits for
several GPUs (ROADMAP A6); until then no process can enable it.
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
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self._sync_params()

    def step(self):
        self.num_steps += 1
        if not self.enabled:
            return
        if self.num_steps % self.local_sgd_steps == 0:
            self._sync_params()

    def _sync_params(self):
        """The replica average; unreachable at one process, where
        ``enabled`` is False."""
        raise NotImplementedError(
            "LocalSGD's parameter average needs several processes, not ported to "
            "accelerate_tpu_torch yet (ROADMAP.md A6)")
