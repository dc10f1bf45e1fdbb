"""Parameter and batch placement on the mesh, data axes only: the JAX
``parallel/sharding.py``'s ``replicated``, ``batch_spec``, ``data_sharding``
and ``shard_params``.

A spec is a tuple with one entry per tensor dim: None (replicated along
it) or the mesh axis names the dim is split over, the JAX
``PartitionSpec`` as a plain tuple.  On a pure data-parallel mesh every
parameter is replicated, so :func:`shard_params` broadcasts rank 0's values
to every process: the replicas start bit-identical.  The batch's dim 0 is
split over the data axes, each process holding its own rows
(:mod:`..data_loader`).

The rules that shard weights (``make_param_specs``, ``auto_fsdp_spec``),
``constrain`` and ``embed_lookup`` come with the model axes (ROADMAP A6
part 1, FSDP/TP) and raise until then.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

import torch

from .mesh import Mesh, data_axes, model_axes

__all__ = ["batch_spec", "data_sharding", "replicated", "shard_params"]

_FSDP_TP = ("{} shards weights over the model axes, which are not ported to "
            "accelerate_tpu_torch yet (ROADMAP A6 part 1, FSDP/TP)")


class NamedSharding:
    """A spec on a mesh: the JAX ``NamedSharding``'s two fields."""

    def __init__(self, mesh: Mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self) -> str:
        return f"NamedSharding(spec={self.spec})"


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_spec(mesh: Mesh) -> tuple:
    """The spec of a batch: dim 0 over every active data axis."""
    axes = data_axes(mesh)
    return (axes if axes else None,)


def data_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, batch_spec(mesh))


def shard_params(params: Any, mesh: Mesh, specs: Any = None) -> Any:
    """Place parameters (a tensor, a module's ``parameters()``, or a list or
    dict of tensors) on ``mesh``: on a pure data-parallel mesh every one is
    replicated, so rank 0's values are broadcast into each in place.
    ``specs`` other than replicated need the model axes and raise."""
    from . import collectives

    if model_axes(mesh):
        raise NotImplementedError(_FSDP_TP.format("shard_params on a mesh with "
                                                  f"{model_axes(mesh)}"))
    if specs is not None and any(e is not None for s in _leaves(specs, tuple) for e in s):
        raise NotImplementedError(_FSDP_TP.format("a non-replicated spec"))
    group = mesh.group()
    with torch.no_grad():
        for t in _leaves(params, torch.Tensor):
            collectives.broadcast(t.data, src=0, group=group)
    return params


def _leaves(tree, kind) -> Iterable:
    if isinstance(tree, kind):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v, kind)
    elif isinstance(tree, (list, tuple)) or hasattr(tree, "__next__"):
        for v in tree:
            yield from _leaves(v, kind)


def make_param_specs(*args, **kwargs):
    raise NotImplementedError(_FSDP_TP.format("make_param_specs"))


def auto_fsdp_spec(*args, **kwargs):
    raise NotImplementedError(_FSDP_TP.format("auto_fsdp_spec"))


def constrain(x, spec: Optional[tuple] = None):
    raise NotImplementedError(_FSDP_TP.format("constrain"))


def embed_lookup(*args, **kwargs):
    raise NotImplementedError(_FSDP_TP.format("embed_lookup"))
