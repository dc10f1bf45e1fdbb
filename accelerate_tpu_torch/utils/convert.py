"""Conversion from the JAX package's pytrees to the port's: the llama and
GPT-2 parameters (:func:`llama_params_from_jax`,
:func:`gpt2_params_from_jax`) and the llama AdamW state
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

from ..models.gpt2 import GPT2Config
from ..models.gpt2 import _param_shapes as _gpt2_param_shapes
from ..models.llama import LlamaConfig, _param_shapes
from ..state import resolve_device

__all__ = ["adamw_state_from_optax", "gpt2_params_from_jax", "llama_params_from_jax"]


def _params_from_jax(np_params: dict, shapes: dict, dtype, device) -> dict:
    """Each leaf of ``np_params`` (nested dicts of array-likes) as a tensor
    in ``dtype`` on ``device``, checked against ``shapes`` (the same tree of
    shape tuples): a missing, extra or misshapen leaf raises ``ValueError``."""
    dev = resolve_device(device)

    def convert(path, tree, want):
        if isinstance(want, dict):
            if not isinstance(tree, dict) or set(tree) != set(want):
                got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
                raise ValueError(f"{path or 'params'}: keys {got} do not match the config's "
                                 f"{sorted(want)}")
            return {k: convert(f"{path}/{k}" if path else k, tree[k], w)
                    for k, w in want.items()}
        arr = np.asarray(tree, dtype=np.float32)
        if arr.shape != tuple(want):
            raise ValueError(f"{path}: shape {arr.shape}, config expects {tuple(want)}")
        return torch.tensor(arr, dtype=dtype, device=dev)

    return convert("", np_params, shapes)


def llama_params_from_jax(np_params: dict, config: LlamaConfig, device=None) -> dict:
    """``np_params``: the JAX ``llama.init_params`` tree with numpy (or any
    array-like) leaves.  Returns the port's parameter dict in
    ``config.param_dtype`` on ``device`` (default ``cuda``).  Raises
    ``ValueError`` when a leaf is missing, extra or of the wrong shape for
    ``config`` (a tied config has no ``lm_head``; ``attention_bias`` adds
    ``bq``/``bk``/``bv``/``bo``)."""
    return _params_from_jax(np_params, _param_shapes(config), config.param_dtype, device)


def gpt2_params_from_jax(np_params: dict, config: GPT2Config, device=None) -> dict:
    """``np_params``: the JAX ``gpt2.init_params`` tree with numpy (or any
    array-like) leaves.  The two packages name and lay out every leaf alike
    (``wte``, ``wpe``, ``layers/w_qkv`` ``[L, d, 3d]``, ...), so this is a
    checked copy into ``config.param_dtype`` on ``device`` (default
    ``cuda``); a missing, extra or misshapen leaf raises ``ValueError``."""
    return _params_from_jax(np_params, _gpt2_param_shapes(config), config.param_dtype, device)


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
