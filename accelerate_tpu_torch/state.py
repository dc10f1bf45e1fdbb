"""Device resolution for the port's entry points, and the gradient
accumulation state.

Every entry point runs on the card unless its caller asks for the CPU: a
``device`` of ``None`` means ``cuda``, and raises when CUDA is absent rather
than quietly running on the host."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["GradientState", "resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` without CUDA); an
    explicit device is returned as a ``torch.device``, and an explicit CUDA
    device also raises without CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev


class GradientState:
    """The part of the JAX ``GradientState`` that ``accumulate``,
    ``backward`` and the optimizer read: ``num_steps`` micro-batches per
    optimizer step, ``step`` (micro-batches seen by ``accumulate``) and
    ``sync_gradients`` (True on the micro-batch that completes a window).
    One per ``Accelerator``, shared with its optimizers; not a process-wide
    singleton."""

    def __init__(self, num_steps: int = 1):
        if num_steps < 1:
            raise ValueError(f"gradient_accumulation_steps must be >= 1, got {num_steps}")
        self.num_steps = num_steps
        self.step = 0
        self.sync_gradients = True

    def advance(self) -> None:
        """Count one micro-batch; ``sync_gradients`` turns True on every
        ``num_steps``-th."""
        self.step += 1
        self.sync_gradients = self.step % self.num_steps == 0
