"""Nested-batch helpers of the JAX package's ``utils/operations.py``:
:func:`recursively_apply`, :func:`send_to_device` and
:func:`find_batch_size` over dicts, lists and tuples (namedtuples rebuilt)
of ``torch.Tensor`` leaves; and :func:`rename_state_dict`, which gives a
module's checkpoint keys the JAX package's parameter names."""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Optional

import torch

__all__ = [
    "find_batch_size",
    "honor_type",
    "recursively_apply",
    "rename_state_dict",
    "send_to_device",
]


def honor_type(obj, generator):
    """An instance of ``type(obj)`` built from ``generator`` (namedtuples
    from positional fields)."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*list(generator))
    return type(obj)(generator)


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def recursively_apply(func: Callable, data: Any, *args, test_type: Callable = _is_tensor,
                      error_on_other_type: bool = False, **kwargs):
    """``func(leaf, *args, **kwargs)`` on every leaf of ``data`` that passes
    ``test_type``, keeping the container types; other leaves pass through
    (or raise ``TypeError`` under ``error_on_other_type``)."""
    if isinstance(data, (tuple, list)):
        return honor_type(data, (recursively_apply(func, o, *args, test_type=test_type,
                                                   error_on_other_type=error_on_other_type,
                                                   **kwargs) for o in data))
    if isinstance(data, Mapping):
        return type(data)({k: recursively_apply(func, v, *args, test_type=test_type,
                                                error_on_other_type=error_on_other_type, **kwargs)
                           for k, v in data.items()})
    if test_type(data):
        return func(data, *args, **kwargs)
    if error_on_other_type:
        raise TypeError(f"Unsupported type {type(data)}: only nested lists, tuples and dicts "
                        f"of objects passing {test_type.__name__} are supported")
    return data


def send_to_device(tensor, device, non_blocking: bool = False, skip_keys=None):
    """Every tensor of a nested structure moved to ``device`` (a
    ``torch.device`` or its name); ``non_blocking`` lets a copy from pinned
    host memory return before it lands.  Values under ``skip_keys`` (a name
    or a list of names, at any mapping level) stay where they are."""
    if isinstance(skip_keys, str):
        skip_keys = [skip_keys]
    skip_keys = skip_keys or []
    if isinstance(tensor, Mapping):
        return type(tensor)({k: v if k in skip_keys else
                             send_to_device(v, device, non_blocking, skip_keys)
                             for k, v in tensor.items()})
    if isinstance(tensor, (tuple, list)):
        return honor_type(tensor, (send_to_device(t, device, non_blocking, skip_keys)
                                   for t in tensor))
    if isinstance(tensor, torch.Tensor):
        return tensor.to(device, non_blocking=non_blocking)
    return tensor


def find_batch_size(data) -> Optional[int]:
    """The leading dimension of the first tensor leaf; ``TypeError`` when
    the first leaf is not a tensor."""
    if isinstance(data, (tuple, list)) and len(data) > 0:
        return find_batch_size(data[0])
    if isinstance(data, Mapping):
        for v in data.values():
            return find_batch_size(v)
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"Can only find the batch size of tensors but got {type(data)}.")
    return data.shape[0]


def rename_state_dict(module: torch.nn.Module, names: dict) -> None:
    """Make ``module.state_dict()`` (and ``load_state_dict``) use
    ``names[key]`` in place of each torch key ``key`` it lists."""
    inverse = {v: k for k, v in names.items()}

    def save_hook(mod, state_dict, prefix, local_metadata):
        for key in [k for k in state_dict if k[len(prefix):] in names and k.startswith(prefix)]:
            state_dict[prefix + names[key[len(prefix):]]] = state_dict.pop(key)
        return state_dict

    def load_hook(state_dict, prefix, *args):
        for key in [k for k in state_dict if k[len(prefix):] in inverse and k.startswith(prefix)]:
            state_dict[prefix + inverse[key[len(prefix):]]] = state_dict.pop(key)

    module._register_state_dict_hook(save_hook)
    module._register_load_state_dict_pre_hook(load_hook)
