"""A key backed by ``jax.random`` for the port's sampling code, used by the
parity tests only.

The port's generation draws through three key calls, ``fold_in``,
``gumbel`` and ``uniform`` (``accelerate_tpu_torch.utils.random.PRNGKey``).
This class answers them with ``jax.random`` on the wrapped JAX key, so the
port draws JAX's exact noise: ``jax.random.categorical(k, logits)`` is
``argmax(jax.random.gumbel(k, logits.shape) + logits)``, and the port adds
the same Gumbel draw to its own logits."""

import numpy as np
import torch

import jax


class JaxKey:
    def __init__(self, key):
        self.key = key

    def fold_in(self, data):
        return JaxKey(jax.random.fold_in(self.key, int(data)))

    def gumbel(self, shape, device=None):
        g = np.asarray(jax.random.gumbel(self.key, tuple(shape), dtype=np.float32))
        return torch.from_numpy(g.copy()).to(device)

    def uniform(self, shape, device=None):
        u = np.asarray(jax.random.uniform(self.key, tuple(shape), dtype=np.float32))
        return torch.from_numpy(u.copy()).to(device)
