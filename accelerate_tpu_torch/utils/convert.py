"""Conversion from the JAX package's pytrees to the port's: the parameters
of every family (:func:`llama_params_from_jax`, :func:`gpt2_params_from_jax`,
:func:`mixtral_params_from_jax`, :func:`bert_params_from_jax`,
:func:`vit_params_from_jax`, :func:`resnet_params_from_jax` with the batch
statistics, :func:`t5_params_from_jax`) and the llama AdamW state
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

from ..models import bert as _bert
from ..models import resnet as _resnet
from ..models import t5 as _t5
from ..models import vit as _vit
from ..models.gpt2 import GPT2Config
from ..models.gpt2 import _param_shapes as _gpt2_param_shapes
from ..models.llama import LlamaConfig, _param_shapes
from ..models.mixtral import MixtralConfig
from ..models.mixtral import _param_shapes as _mixtral_param_shapes
from ..state import resolve_device

__all__ = ["adamw_state_from_optax", "bert_params_from_jax", "gpt2_params_from_jax",
           "llama_params_from_jax", "mixtral_params_from_jax", "resnet_params_from_jax",
           "t5_params_from_jax", "vit_params_from_jax"]


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


def llama_params_from_jax(np_params: dict, config: LlamaConfig, device=None, specs=None,
                          mesh=None, rank=None) -> dict:
    """``np_params``: the JAX ``llama.init_params`` tree with numpy (or any
    array-like) leaves.  Returns the port's parameter dict in
    ``config.param_dtype`` on ``device`` (default ``cuda``).  Raises
    ``ValueError`` when a leaf is missing, extra or of the wrong shape for
    ``config`` (a tied config has no ``lm_head``; ``attention_bias`` adds
    ``bq``/``bk``/``bv``/``bo``).

    With ``specs`` (the spec tree, as :func:`~..parallel.sharding.make_param_specs`
    gives it) and ``mesh``: the leaves of one process, the one at ``rank``
    (default: this process), each its chunk of the full leaf, which is what
    JAX's ``shard_params`` puts on the device at that mesh coordinate."""
    params = _params_from_jax(np_params, _param_shapes(config), config.param_dtype, device)
    if specs is None:
        return params
    from ..parallel.sharding import _tree_map, local_slice

    def cut(path, t):
        node = specs
        for k in path.split("/"):
            node = node[k]
        return local_slice(t, node, mesh, rank).contiguous()

    return _tree_map(cut, params)


def gpt2_params_from_jax(np_params: dict, config: GPT2Config, device=None) -> dict:
    """``np_params``: the JAX ``gpt2.init_params`` tree with numpy (or any
    array-like) leaves.  The two packages name and lay out every leaf alike
    (``wte``, ``wpe``, ``layers/w_qkv`` ``[L, d, 3d]``, ...), so this is a
    checked copy into ``config.param_dtype`` on ``device`` (default
    ``cuda``); a missing, extra or misshapen leaf raises ``ValueError``."""
    return _params_from_jax(np_params, _gpt2_param_shapes(config), config.param_dtype, device)


def mixtral_params_from_jax(np_params: dict, config: MixtralConfig, device=None) -> dict:
    """``np_params``: the JAX ``mixtral.init_params`` tree with numpy (or any
    array-like) leaves.  Both packages lay out every leaf alike (the
    router ``[L, d, E]``, the experts ``[L, E, d, f]`` / ``[L, E, f, d]``),
    so this is a checked copy into ``config.param_dtype`` on ``device``
    (default ``cuda``); a missing, extra or misshapen leaf raises
    ``ValueError``."""
    return _params_from_jax(np_params, _mixtral_param_shapes(config), config.param_dtype, device)


def bert_params_from_jax(np_params: dict, config: "_bert.BertConfig", device=None) -> dict:
    """The JAX ``bert.init_params`` tree (numpy leaves) as the port's, a
    checked copy (see :func:`gpt2_params_from_jax`)."""
    return _params_from_jax(np_params, _bert._param_shapes(config), config.param_dtype, device)


def vit_params_from_jax(np_params: dict, config: "_vit.ViTConfig", device=None) -> dict:
    """The JAX ``vit.init_params`` tree (numpy leaves) as the port's, a
    checked copy; the ``cls`` token exists only under ``pool="cls"``."""
    return _params_from_jax(np_params, _vit._param_shapes(config), config.param_dtype, device)


def resnet_params_from_jax(np_params: dict, np_stats: dict, config: "_resnet.ResNetConfig",
                           device=None):
    """The JAX ``resnet`` parameter and batch-statistics trees (numpy
    leaves) as the port's ``(params, batch_stats)``: both keep the JAX
    layouts (HWIO kernels, stacked ``tail`` blocks), so each is a checked
    copy, the parameters into ``config.param_dtype``, the statistics into
    fp32."""
    return (_params_from_jax(np_params, _resnet._param_shapes(config), config.param_dtype,
                             device),
            _params_from_jax(np_stats, _resnet._stats_shapes(config), torch.float32, device))


def t5_params_from_jax(np_params: dict, config: "_t5.T5Config", device=None) -> dict:
    """The JAX ``t5.init_params`` tree (numpy leaves) as the port's, a
    checked copy of both stacks, the shared embedding and the two
    relative-bias tables."""
    return _params_from_jax(np_params, _t5._param_shapes(config), config.param_dtype, device)


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
