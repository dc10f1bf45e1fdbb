"""Device resolution for the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU: a
``device`` of ``None`` means ``cuda``, and raises when CUDA is absent rather
than quietly running on the host."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


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
