"""Host-memory offload of the optimizer state: the JAX
``parallel/host_offload.py``.

The state of a wrapped optimizer lives in pinned host memory between
steps: :func:`host_offload` moves it to the device for the update and back
after it.  Opt-in, as in the JAX package: a full round trip of AdamW's two
moments costs more time over the host link than the freed device memory
buys, unless device memory is what binds.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["host_memory_kind", "offload_to_host", "host_offload"]


def host_memory_kind() -> Optional[str]:
    """``"pinned_host"`` where CUDA can pin host memory, else None (the
    CPU, whose memory is the host's)."""
    return "pinned_host" if torch.cuda.is_available() else None


def _to_host(x):
    if not isinstance(x, torch.Tensor) or x.device.type == "cpu":
        return x
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out


def offload_to_host(tree):
    """Every CUDA tensor leaf of ``tree`` (a torch optimizer's ``state``
    mapping, or dicts / lists of tensors) copied into pinned host memory;
    host tensors pass through.  Raises without a host memory kind."""
    if host_memory_kind() is None:
        raise RuntimeError(
            "This backend exposes no host memory space; host offload needs a "
            "CUDA runtime with pinned_host support.")
    if isinstance(tree, dict):
        return type(tree)((k, offload_to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(offload_to_host(v) for v in tree)
    return _to_host(tree)


def _place(tx: torch.optim.Optimizer, to_host: bool) -> None:
    state = tx.state
    for p in list(state):
        state[p] = {k: (_to_host(v) if to_host else
                        v.to(p.device, non_blocking=True)
                        if isinstance(v, torch.Tensor) and v.device != p.device and k != "step"
                        else v)
                    for k, v in state[p].items()}


def host_offload(tx: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Make ``tx`` (a torch optimizer, returned itself) keep its state in
    pinned host memory between steps: its ``step`` brings each parameter's
    state to the parameter's device, runs, and moves the state back.  On
    the CPU the state already lives in host memory and nothing moves."""
    inner = tx.step

    def step(closure=None):
        if host_memory_kind() is None:
            return inner(closure)
        _place(tx, to_host=False)
        try:
            return inner(closure)
        finally:
            _place(tx, to_host=True)

    tx.step = step
    return tx
