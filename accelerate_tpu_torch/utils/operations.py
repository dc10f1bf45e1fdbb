"""The JAX package's ``utils/operations.py``, over dicts, lists and tuples
(namedtuples rebuilt) of ``torch.Tensor`` leaves:
:func:`recursively_apply`, :func:`send_to_device`, the structure helpers
(:func:`find_batch_size`, :func:`get_data_structure`, :func:`listify`, ...),
the collectives (:func:`gather`, :func:`reduce`, :func:`broadcast`,
:func:`pad_across_processes`, ...) and the fp32 output casts; and
:func:`rename_state_dict`, which gives a module's checkpoint keys the JAX
package's parameter names.

Torch goes in and torch comes out, on the input's device.  With several
processes the collectives run over the process group
(:mod:`..parallel.collectives`): ``gather`` concatenates every process's
tensors along dim 0 (a 0-d tensor gathers into one entry per process),
``gather_object`` concatenates their lists, ``broadcast`` and
``broadcast_object_list`` copy one process's, ``reduce`` sums or averages,
``pad_across_processes`` pads to the largest size.  At one process a
collective has nobody to exchange with: ``gather``, ``broadcast`` and
``pad_across_processes`` return their input, ``reduce`` its input times
``scale`` (the JAX package returns numpy arrays from ``reduce``,
``broadcast`` and ``pad_across_processes``; the values are the same)."""

from __future__ import annotations

import pickle
from collections.abc import Mapping
from functools import wraps
from typing import Any, Callable, Optional

import torch

from .dataclasses import TensorInformation

__all__ = [
    "ConvertOutputsToFp32",
    "DistributedOperationException",
    "broadcast",
    "broadcast_object_list",
    "concatenate",
    "convert_outputs_to_fp32",
    "convert_to_fp32",
    "find_batch_size",
    "gather",
    "gather_object",
    "get_data_structure",
    "honor_type",
    "ignorant_find_batch_size",
    "initialize_tensors",
    "listify",
    "pad_across_processes",
    "pad_input_tensors",
    "recursively_apply",
    "reduce",
    "rename_state_dict",
    "send_to_device",
    "slice_tensors",
    "verify_operation",
]


class DistributedOperationException(Exception):
    """A collective's inputs differ in shape across processes (checked under
    ``ACCELERATE_DEBUG_MODE`` when there are several)."""


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


def ignorant_find_batch_size(data) -> Optional[int]:
    """:func:`find_batch_size`, or None where it raises ``TypeError``."""
    try:
        return find_batch_size(data)
    except TypeError:
        return None


def get_data_structure(data):
    """The structure of ``data`` with each tensor replaced by its
    :class:`TensorInformation` (shape and dtype)."""
    return recursively_apply(lambda t: TensorInformation(shape=t.shape, dtype=t.dtype), data)


def initialize_tensors(data_structure, device=None):
    """Zeros in the structure :func:`get_data_structure` describes."""
    return recursively_apply(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
                             data_structure,
                             test_type=lambda x: isinstance(x, TensorInformation))


def listify(data):
    """Every tensor leaf as nested python lists."""
    return recursively_apply(lambda t: t.detach().cpu().tolist(), data)


def _num_processes() -> int:
    from ..parallel import collectives

    return collectives.world_size()


def _local() -> bool:
    """No process group: the collectives have nobody to exchange with."""
    from ..parallel import collectives

    return not collectives.initialized()


def _tree_spec(tree):
    """Shapes and dtypes of the tensor leaves, comparable across processes."""
    out = []
    recursively_apply(lambda t: out.append((tuple(t.shape), str(t.dtype))), tree)
    return out


def verify_operation(function: Callable) -> Callable:
    """Wrap a collective so that, under ``ACCELERATE_DEBUG_MODE`` and with
    several processes, differing leaf shapes raise
    :class:`DistributedOperationException` before it runs.  One process has
    nothing to compare, so the function runs as it is."""

    @wraps(function)
    def wrapper(*args, **kwargs):
        from ..state import PartialState

        if _num_processes() == 1 or not (PartialState._shared_state and PartialState().debug):
            return function(*args, **kwargs)
        tensor = kwargs.get("tensor", args[0] if args else None)
        specs = gather_object([_tree_spec(tensor)])
        if not all(sp == specs[0] for sp in specs):
            table = "\n".join(f"  rank {i}: {sp}" for i, sp in enumerate(specs))
            raise DistributedOperationException(
                f"Cannot apply `{function.__name__}`: shapes differ across processes:\n{table}")
        return function(*args, **kwargs)

    return wrapper


@verify_operation
def gather(tensor):
    """Every process's tensors concatenated along dim 0 (a 0-d tensor
    gathers into one entry per process): at one process the tensors
    themselves."""
    if _local():
        return recursively_apply(lambda t: t, tensor, error_on_other_type=True)
    from ..parallel import collectives

    return recursively_apply(lambda t: collectives.all_gather(t.detach()), tensor,
                             error_on_other_type=True)


def gather_object(object: Any) -> list:
    """The concatenation of every process's list of picklable objects: at
    one process the list itself (a copy)."""
    if _local():
        return list(object)
    from ..parallel import collectives

    return [x for part in collectives.all_gather_object(list(object)) for x in part]


@verify_operation
def broadcast(tensor, from_process: int = 0):
    """Process ``from_process``'s tensors on every process: at one process
    the tensors themselves."""
    if _local():
        return recursively_apply(lambda t: t, tensor, error_on_other_type=True)
    from ..parallel import collectives

    return recursively_apply(lambda t: collectives.broadcast(t.detach().clone(), from_process),
                             tensor, error_on_other_type=True)


def broadcast_object_list(object_list: list, from_process: int = 0) -> list:
    """``object_list`` overwritten in place with process ``from_process``'s
    and returned: at one process unchanged."""
    if _local():
        return object_list
    from ..parallel import collectives

    object_list[:] = collectives.broadcast_object(list(object_list), from_process)
    return object_list


@verify_operation
def reduce(tensor, reduction: str = "mean", scale: float = 1.0):
    """The sum (``"sum"``) or mean (``"mean"``) over processes, times
    ``scale``: at one process each tensor times ``scale`` (a copy)."""
    if reduction not in ("sum", "mean"):
        raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")
    if _local():
        return recursively_apply(lambda t: t * scale, tensor, error_on_other_type=True)
    n = _num_processes()
    from ..parallel import collectives

    def _reduce(t):
        out = collectives.all_reduce(t.detach().clone())
        if reduction == "mean":
            out = out / n
        return out * scale

    return recursively_apply(_reduce, tensor, error_on_other_type=True)


@verify_operation
def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
    """Each tensor padded with ``pad_index`` along ``dim`` to the largest
    size across processes (before a :func:`gather` of ragged batches): at
    one process each tensor is already the largest."""
    if _local():
        return recursively_apply(lambda t: t, tensor, error_on_other_type=True)
    from ..parallel import collectives

    def _pad(t):
        if dim >= t.dim():
            return t
        size = torch.tensor([t.shape[dim]], dtype=torch.int64, device=t.device)
        longest = int(collectives.all_gather(size).max())
        if longest == t.shape[dim]:
            return t
        shape = list(t.shape)
        shape[dim] = longest
        out = t.new_full(shape, pad_index)
        lo = longest - t.shape[dim] if pad_first else 0
        out.narrow(dim, lo, t.shape[dim]).copy_(t)
        return out

    return recursively_apply(_pad, tensor, error_on_other_type=True)


def pad_input_tensors(tensor, batch_size: int, num_processes: int, dim: int = 0):
    """Tensors whose ``dim`` is ``batch_size`` grown to the next multiple of
    ``num_processes`` by repeating their last slice along ``dim``."""

    def _pad(t):
        if batch_size % num_processes == 0 or t.shape[dim] != batch_size:
            return t
        extra = ((batch_size // num_processes) + 1) * num_processes - t.shape[dim]
        last = t.narrow(dim, t.shape[dim] - 1, 1)
        return torch.cat([t] + [last] * extra, dim=dim)

    return recursively_apply(_pad, tensor, error_on_other_type=True)


def concatenate(data, dim: int = 0):
    """A list of like structures joined leaf by leaf along ``dim``."""
    if isinstance(data[0], (tuple, list)):
        return honor_type(data[0], (concatenate([d[i] for d in data], dim=dim)
                                    for i in range(len(data[0]))))
    if isinstance(data[0], Mapping):
        return type(data[0])({k: concatenate([d[k] for d in data], dim=dim) for k in data[0]})
    if not isinstance(data[0], torch.Tensor):
        raise TypeError(f"Can only concatenate tensors but got {type(data[0])}")
    return torch.cat(data, dim=dim)


def slice_tensors(data, tensor_slice, process_index: int = None, num_processes: int = None):
    """``t[tensor_slice]`` for every tensor leaf."""
    return recursively_apply(lambda t: t[tensor_slice], data)


def convert_to_fp32(tensor):
    """Every floating tensor leaf as float32 (a differentiable cast); other
    leaves unchanged."""
    return recursively_apply(lambda t: t.float() if t.is_floating_point() else t, tensor)


class ConvertOutputsToFp32:
    """``model_forward`` with its floating outputs cast to float32; refuses
    to pickle, as in the JAX package (unwrap the model first)."""

    def __init__(self, model_forward):
        self.model_forward = model_forward

    def __call__(self, *args, **kwargs):
        return convert_to_fp32(self.model_forward(*args, **kwargs))

    def __getstate__(self):
        raise pickle.PicklingError(
            "Cannot pickle a prepared model with automatic mixed precision; unwrap it "
            "with `Accelerator.unwrap_model(model)` first."
        )


def convert_outputs_to_fp32(model_forward):
    model_forward = ConvertOutputsToFp32(model_forward)

    def forward(*args, **kwargs):
        return model_forward(*args, **kwargs)

    forward.__wrapped__ = model_forward
    return forward


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
