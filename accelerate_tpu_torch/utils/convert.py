"""Parameter conversion from the JAX package's llama pytree to the port's.

The port keeps the JAX layout on purpose — per-layer weights stacked on a
leading ``[L, ...]`` axis, projections stored for ``x @ W`` (``wq`` is
``[L, d, H*hd]``), optional Q/K/V/O biases under ``layers``, and
``lm_head`` ``[d, V]`` absent when the embedding is tied — so conversion is a
checked copy of every leaf into a tensor."""

from __future__ import annotations

import numpy as np
import torch

from ..models.llama import LlamaConfig, _param_shapes
from ..state import resolve_device

__all__ = ["llama_params_from_jax"]


def llama_params_from_jax(np_params: dict, config: LlamaConfig, device=None) -> dict:
    """``np_params``: the JAX ``llama.init_params`` tree with numpy (or any
    array-like) leaves.  Returns the port's parameter dict in
    ``config.param_dtype`` on ``device`` (default ``cuda``).  Raises
    ``ValueError`` when a leaf is missing, extra or of the wrong shape for
    ``config`` (a tied config has no ``lm_head``; ``attention_bias`` adds
    ``bq``/``bk``/``bv``/``bo``)."""
    dev = resolve_device(device)
    shapes = _param_shapes(config)

    def leaf(path, value, shape):
        arr = np.asarray(value, dtype=np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"{path}: shape {arr.shape}, config expects {tuple(shape)}")
        return torch.tensor(arr, dtype=config.param_dtype, device=dev)

    def check_keys(path, got, want):
        if set(got) != set(want):
            raise ValueError(
                f"{path or 'params'}: keys {sorted(got)} do not match the config's {sorted(want)}"
            )

    check_keys("", np_params, shapes)
    check_keys("layers", np_params["layers"], shapes["layers"])
    out = {k: leaf(k, np_params[k], s) for k, s in shapes.items() if k != "layers"}
    out["layers"] = {
        k: leaf(f"layers/{k}", np_params["layers"][k], s) for k, s in shapes["layers"].items()
    }
    return out
