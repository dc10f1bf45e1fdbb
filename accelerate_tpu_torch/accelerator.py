"""The port's ``Accelerator``: device placement and the serving entry point.

Only :meth:`Accelerator.prepare_serving` is ported so far; training
(``prepare``, ``backward``, ``make_train_step`` and the rest of the JAX
``Accelerator``) comes in a later slice."""

from __future__ import annotations

from .state import resolve_device

__all__ = ["Accelerator"]


class Accelerator:
    """``Accelerator(cpu=False)`` serves on the GPU (raising without CUDA);
    ``cpu=True`` or ``device="cpu"`` keeps everything on the host."""

    def __init__(self, cpu: bool = False, device=None):
        if cpu and device is not None and str(device) != "cpu":
            raise ValueError(f"cpu=True contradicts device={device!r}")
        self.device = resolve_device("cpu" if cpu else device)

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
