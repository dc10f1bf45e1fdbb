"""Device resolution for the port's entry points, and the gradient
accumulation state.

Every entry point runs on the card unless its caller asks for the CPU: a
``device`` of ``None`` means ``cuda``, and raises when CUDA is absent rather
than quietly running on the host."""

from __future__ import annotations

import weakref
from typing import Optional, Union

import torch

from .utils.dataclasses import GradientAccumulationPlugin

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
    """The JAX ``GradientState``: ``num_steps`` micro-batches per optimizer
    step, ``step`` (micro-batches counted by :meth:`advance` since the last
    forced sync), ``sync_gradients`` (True on a micro-batch that ends a
    window) and the stack of dataloaders being iterated, whose top one
    gives ``end_of_dataloader`` and ``remainder``.

    One per ``Accelerator``, shared with the optimizers, schedulers and
    dataloaders it prepares; not a process-wide singleton.  The stack holds
    weak references, so an abandoned loader is not kept alive."""

    def __init__(self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None):
        plugin = gradient_accumulation_plugin or GradientAccumulationPlugin()
        num_steps = plugin.num_steps or 1
        if num_steps < 1:
            raise ValueError(f"gradient_accumulation_steps must be >= 1, got {num_steps}")
        self.num_steps = num_steps
        self.adjust_scheduler = plugin.adjust_scheduler
        self.sync_with_dataloader = plugin.sync_with_dataloader
        self.sync_each_batch = plugin.sync_each_batch
        self.step = 0
        self.sync_gradients = True
        self._dataloaders: list = []

    @property
    def active_dataloader(self):
        return self._dataloaders[-1]() if self._dataloaders else None

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    @property
    def end_of_dataloader(self) -> bool:
        """True while the active dataloader's last batch is in hand (set
        before that batch is yielded)."""
        dl = self.active_dataloader
        return bool(dl is not None and dl.end_of_dataloader)

    @property
    def remainder(self) -> int:
        """Samples in the active dataloader's last batch beyond whole
        batches (-1 outside a dataloader)."""
        dl = self.active_dataloader
        return -1 if dl is None else dl.remainder

    def _add_dataloader(self, dataloader) -> None:
        self._dataloaders.append(weakref.ref(dataloader))

    def _remove_dataloader(self, dataloader) -> None:
        self._dataloaders = [r for r in self._dataloaders
                             if r() is not None and r() is not dataloader]

    def advance(self) -> None:
        """Count one micro-batch (the JAX ``Accelerator._do_sync``): on a
        dataloader's last batch ``sync_gradients`` turns True and the count
        restarts (under ``sync_with_dataloader``); otherwise it turns True on
        every ``num_steps``-th micro-batch; under ``sync_each_batch``
        always."""
        if self.sync_with_dataloader and self.end_of_dataloader:
            self.step = 0
            self.sync_gradients = True
        else:
            self.step += 1
            self.sync_gradients = self.step % self.num_steps == 0
        if self.sync_each_batch:
            self.sync_gradients = True
