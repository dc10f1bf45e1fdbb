"""Out-of-memory retry and memory release: the JAX package's
``accelerate_tpu/utils/memory.py`` for the port.

:func:`find_executable_batch_size` keeps the JAX contract: the decorated
function takes the batch size as its first argument and the caller must not
pass it (``TypeError``); each outer call starts again from
``starting_batch_size``; each out-of-memory error halves the size with a
warning; reaching 0 raises ``RuntimeError``; every other exception passes
through.  A ``torch.cuda.OutOfMemoryError`` is an out-of-memory error by
type, other exceptions by their message.  Each OOM is noted in the memory
ledger (a ``memory.oom_postmortem`` naming the largest reservation) and,
with telemetry on, in the ``memory.oom_halvings`` counter and a
``memory.oom_halving`` event.
"""

from __future__ import annotations

import functools
import gc
import inspect
from typing import Callable, Optional

import torch

__all__ = ["clear_device_cache", "find_executable_batch_size", "release_memory",
           "should_reduce_batch_size"]


def clear_device_cache(garbage_collection: bool = False) -> None:
    """``gc.collect()`` when asked, then hand the CUDA caching allocator's
    free blocks back to the device (``torch.cuda.empty_cache()``) when CUDA
    is initialised.  ``jax.clear_caches`` (compiled programs) has no
    counterpart: the port compiles nothing per shape."""
    if garbage_collection:
        gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def release_memory(*objects):
    """One ``None`` per argument, for the caller to rebind its names to,
    after collecting garbage and emptying the CUDA cache."""
    if not isinstance(objects, list):
        objects = list(objects)
    for i in range(len(objects)):
        objects[i] = None
    clear_device_cache(garbage_collection=True)
    return objects


_OOM_STATEMENTS = (
    "RESOURCE_EXHAUSTED",
    "Out of memory",
    "out of memory",
    "OOM",
    "Attempting to allocate",
    "CUDA out of memory",
)


def should_reduce_batch_size(exception: Exception) -> bool:
    """Whether ``exception`` is an out-of-memory error: a
    ``torch.cuda.OutOfMemoryError``, or a message with one of the JAX
    module's OOM phrases."""
    if isinstance(exception, torch.cuda.OutOfMemoryError):
        return True
    text = str(exception)
    return any(s in text for s in _OOM_STATEMENTS)


def find_executable_batch_size(function: Optional[Callable] = None,
                               starting_batch_size: int = 128):
    """Decorator: run ``function(batch_size, ...)``, halving ``batch_size``
    on each out-of-memory error until the call returns or the size reaches
    0 (``RuntimeError``).  Use as ``@find_executable_batch_size`` or
    ``@find_executable_batch_size(starting_batch_size=...)``; allocate every
    tensor the step needs inside ``function`` so a retry starts clean."""
    if function is None:
        return functools.partial(find_executable_batch_size,
                                 starting_batch_size=starting_batch_size)

    def decorator(*args, **kwargs):
        batch_size = starting_batch_size
        clear_device_cache(garbage_collection=True)
        params = list(inspect.signature(function).parameters.keys())
        if len(params) < (len(args) + 1):
            arg_str = ", ".join([f"{arg}={value}" for arg, value in zip(params[1:], args[1:])])
            raise TypeError(
                f"Batch size was passed into `{function.__name__}` as the first argument "
                f"when called. Remove this as the decorator already does so: "
                f"`{function.__name__}({arg_str})`"
            )
        from ..logging import get_logger
        from ..telemetry import get_telemetry
        from ..telemetry.memledger import get_memory_ledger

        logger = get_logger(__name__)
        while True:
            if batch_size == 0:
                raise RuntimeError("No executable batch size found, reached zero.")
            try:
                return function(batch_size, *args, **kwargs)
            except Exception as e:
                if not should_reduce_batch_size(e):
                    raise
                # Forensics before the cache is emptied: the ledger snapshots
                # the ranked owners and the watermark of the attempt that
                # died (it keeps the error's text, not the error).
                get_memory_ledger().note_oom(source="find_executable_batch_size", error=e,
                                             function=function.__name__,
                                             batch_size=batch_size)
            # Outside the except block: the failed attempt's traceback, which
            # holds its frames and their tensors, is gone before the cache is
            # emptied.
            clear_device_cache(garbage_collection=True)
            new_size = batch_size // 2
            logger.warning(
                f"OOM at batch_size={batch_size} in `{function.__name__}`; "
                f"retrying with batch_size={new_size}"
            )
            tel = get_telemetry()
            if tel.enabled:
                tel.registry.counter("memory.oom_halvings").inc()
                tel.event("memory.oom_halving", function=function.__name__,
                          batch_size=batch_size, new_batch_size=new_size)
            batch_size = new_size

    return decorator
