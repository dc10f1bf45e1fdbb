"""Seeding, and the RNG bundle a checkpoint stores: the single-process part
of the JAX package's ``utils/random.py``.  The JAX root threefry key has no
counterpart here: torch's CPU and CUDA generators carry the state."""

from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["get_rng_state", "set_rng_state", "set_seed"]


def set_seed(seed: int) -> None:
    """Seed python's ``random``, numpy's global generator and torch's CPU
    and CUDA generators with ``seed``."""
    random.seed(seed)
    np.random.seed(seed % 2**32)
    torch.manual_seed(seed)


def get_rng_state() -> dict:
    """python, numpy, torch CPU and, when CUDA is up, every CUDA device's
    generator state."""
    states = {"python": random.getstate(), "numpy": np.random.get_state(),
              "torch": torch.get_rng_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        states["cuda"] = torch.cuda.get_rng_state_all()
    return states


def set_rng_state(states: dict) -> None:
    """Restore what :func:`get_rng_state` returned."""
    random.setstate(states["python"])
    np.random.set_state(states["numpy"])
    torch.set_rng_state(states["torch"])
    if "cuda" in states and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(states["cuda"])
