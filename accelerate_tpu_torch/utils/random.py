"""Seeding, the RNG bundle a checkpoint stores, and the explicit key that
sampled generation takes: the single-process part of the JAX package's
``utils/random.py``.  The JAX root threefry key registry has no counterpart
here: torch's CPU and CUDA generators carry the global state.

:class:`PRNGKey` mirrors the JAX key calls generation makes (``fold_in``,
``gumbel``, ``uniform``).  A key is a seed plus its fold-in path, and each
draw comes from a fresh ``torch.Generator`` seeded from that path, so a
draw depends on the key alone, never on the order of calls.  The noise is
drawn on the host and copied to the caller's device: the same key gives
the same noise on the CPU and on a card, at the price of one host-to-device
copy of the draw per call."""

from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["PRNGKey", "get_rng_state", "set_rng_state", "set_seed"]


def set_seed(seed: int, device_specific: bool = False, deterministic: bool = False) -> None:
    """Seed python's ``random``, numpy's global generator and torch's CPU
    and CUDA generators with ``seed``.  ``device_specific`` adds the
    process index (0 at one process, or before any state exists);
    ``deterministic`` also calls ``torch.use_deterministic_algorithms(True)``,
    torch's counterpart of what the JAX package relies on: XLA is
    deterministic for a fixed key, so its flag changes nothing there."""
    if device_specific:
        from ..state import PartialState

        seed += PartialState._shared_state.get("process_index", 0)
    if deterministic:
        torch.use_deterministic_algorithms(True)
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


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """One step of the splitmix64 mixer: a bijection of 64-bit integers that
    spreads every input bit over the output."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class PRNGKey:
    """An explicit random key: ``PRNGKey(seed)``, then ``key.fold_in(i)``
    for independent sub-streams, as ``jax.random.key`` / ``fold_in``.

    ``gumbel`` and ``uniform`` return fp32 tensors on ``device``; a
    categorical sample over logits is ``argmax(key.gumbel(logits.shape) +
    logits)``, which is how ``jax.random.categorical`` draws too (so a key
    backed by ``jax.random`` that offers the same three calls drives the
    port to JAX's exact tokens)."""

    __slots__ = ("seed", "path")

    def __init__(self, seed: int, path: tuple = ()):
        self.seed = int(seed)
        self.path = tuple(int(i) for i in path)

    def fold_in(self, data: int) -> "PRNGKey":
        return PRNGKey(self.seed, self.path + (int(data),))

    def __repr__(self) -> str:
        return f"PRNGKey({self.seed}, path={self.path})"

    def _generator(self) -> torch.Generator:
        h = _splitmix64(self.seed & _MASK64)
        for i in self.path:
            h = _splitmix64(h ^ (i & _MASK64))
        return torch.Generator().manual_seed(h & ((1 << 63) - 1))

    def uniform(self, shape, device=None) -> torch.Tensor:
        """fp32 draws from [0, 1)."""
        u = torch.rand(tuple(shape), generator=self._generator(), dtype=torch.float32)
        return u.to(device) if device is not None else u

    def gumbel(self, shape, device=None) -> torch.Tensor:
        """fp32 standard Gumbel draws, ``-log(-log(u))`` with ``u`` from
        [tiny, 1) as ``jax.random.gumbel`` computes them.  The two logs run
        in numpy, single-threaded: torch's multi-threaded CPU ``log`` took
        ~10x longer on a draw of 4 x 128256 (~42 ms on an H100 machine's
        host)."""
        u = torch.rand(tuple(shape), generator=self._generator(), dtype=torch.float32).numpy()
        g = torch.from_numpy(-np.log(-np.log(np.maximum(u, np.finfo(np.float32).tiny))))
        return g.to(device) if device is not None else g
