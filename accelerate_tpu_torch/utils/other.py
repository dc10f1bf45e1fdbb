"""Model unwrapping and the main-process save of the JAX package's
``utils/other.py``."""

from __future__ import annotations

from typing import Any

import torch

from .modeling import PreparedModel

__all__ = ["extract_model_from_parallel", "save"]


def extract_model_from_parallel(model, keep_fp32_wrapper: bool = True,
                                keep_torch_compile: bool = True):
    """The module under the wrappers the port or torch put around it: a
    prepared model's original module (its fp32 parameters, the very
    ``Parameter`` objects the optimizer steps), ``DataParallel`` /
    ``DistributedDataParallel``'s ``module``, and ``torch.compile``'s
    ``_orig_mod``, whose compiled wrapper is kept (re-pointed at the
    unwrapped module) under ``keep_torch_compile``.  ``keep_fp32_wrapper``
    is accepted for the JAX surface: the fp32 output cast belongs to the
    prepared wrapper, which is always removed, as in the JAX package."""
    compiled = model if hasattr(model, "_orig_mod") else None
    if compiled is not None:
        model = compiled._orig_mod
    wrappers = (PreparedModel, torch.nn.DataParallel, torch.nn.parallel.DistributedDataParallel)
    while isinstance(model, wrappers):
        model = model.module
    if compiled is not None and keep_torch_compile:
        compiled._orig_mod = model
        return compiled
    return model


def save(obj: Any, f, save_on_each_node: bool = False, safe_serialization: bool = False) -> None:
    """Write ``obj`` to ``f`` on the main process (at one process, always):
    a flat dict of tensors as safetensors under ``safe_serialization``,
    anything else with ``torch.save``.  ``save_on_each_node`` also writes on
    each node's local main process."""
    if safe_serialization:
        from . import safetensors_io

        safetensors_io.save_file({k: v.detach().cpu() for k, v in obj.items()}, str(f))
        return
    torch.save(obj, f)
