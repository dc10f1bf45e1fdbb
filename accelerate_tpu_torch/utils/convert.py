"""Conversion from the JAX package's llama pytree to the port's: the
parameters (:func:`llama_params_from_jax`) and the AdamW state
(:func:`adamw_state_from_optax`).

The port keeps the JAX layout on purpose — per-layer weights stacked on a
leading ``[L, ...]`` axis, projections stored for ``x @ W`` (``wq`` is
``[L, d, H*hd]``), optional Q/K/V/O biases under ``layers``, and
``lm_head`` ``[d, V]`` absent when the embedding is tied — so conversion is a
checked copy of every leaf into a tensor.  Both take numpy leaves, so a
run moves across through ``jax.device_get`` trees; the JAX
``optimizer.bin`` itself is an optax pickle, which only a process with
optax can read."""

from __future__ import annotations

import numpy as np
import torch

from ..models.llama import LlamaConfig, _param_shapes
from ..state import resolve_device

__all__ = ["adamw_state_from_optax", "llama_params_from_jax"]


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


def _find_adam_state(tree):
    """The node of an optax state tree that carries ``mu``, ``nu`` and
    ``count`` (``ScaleByAdamState``), searched through tuples, lists and
    dicts, and the ``inner_state`` of ``inject_hyperparams``."""
    if all(hasattr(tree, a) for a in ("mu", "nu", "count")):
        return tree
    if hasattr(tree, "inner_state"):
        return _find_adam_state(tree.inner_state)
    children = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (tuple, list)) else ())
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def adamw_state_from_optax(np_state, params: dict, config: LlamaConfig) -> dict:
    """The state of an optax ``adamw`` (or ``adam``) over a llama's
    parameters, with numpy leaves, as torch ``AdamW`` state: a dict from
    each tensor of ``params`` (the port's parameter dict, e.g.
    ``LlamaForCausalLM.params``) to ``{"step", "exp_avg", "exp_avg_sq"}``,
    ready for ``torch_optimizer.state.update(...)``.  ``mu``/``nu`` become
    ``exp_avg``/``exp_avg_sq`` on each parameter's device in its dtype;
    optax's update ``count`` becomes the fp32 host ``step`` torch keeps.
    Raises ``ValueError`` when no Adam state is found or a leaf does not fit
    ``config``."""
    adam = _find_adam_state(np_state)
    if adam is None:
        raise ValueError("no optax Adam state (mu, nu, count) in the given tree")
    step = float(np.asarray(adam.count))

    def pairs(tree, mu, nu):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from pairs(v, mu[k], nu[k])
            else:
                yield v, mu[k], nu[k]

    out = {}
    device = next(v for v in params.values() if isinstance(v, torch.Tensor)).device
    mu = llama_params_from_jax(adam.mu, config, device=device)
    nu = llama_params_from_jax(adam.nu, config, device=device)
    for p, m, n in pairs(params, mu, nu):
        if m.shape != p.shape:
            raise ValueError(f"optax state of shape {tuple(m.shape)} for a parameter of shape "
                             f"{tuple(p.shape)}")
        out[p] = {"step": torch.tensor(step, dtype=torch.float32),
                  "exp_avg": m.to(p.dtype), "exp_avg_sq": n.to(p.dtype)}
    return out
