"""Ulysses sequence parallelism: the heads scattered over ``sp`` by an
all-to-all.

The JAX package's ``ops/ulysses_attention.py`` with one process per device
(inputs are this process's chunk, as in :mod:`.ring_attention`).  Instead
of rotating K/V around a ring, one all-to-all
(:func:`~..parallel.collectives.all_to_all_dim`, ``lax.all_to_all(...,
tiled=True)``) re-shards q, k and v from sequence-split to head-split; each
process attends over the whole sequence for its ``H / n`` heads
(:func:`~.ring_attention.full_sequence_attention`: the fused kernels under
``impl="pallas"``), and a second all-to-all restores the sequence split.
The all-to-all is differentiable (its backward is the reverse exchange),
so autograd carries the backward.  The query heads this process holds must
divide by the ``sp`` size; K/V heads that do not are expanded to the least
count that does and still groups evenly against the query heads
(:func:`_kv_expansion`).  A padded batch's ``kv_valid`` chunk is gathered
whole, since the local attention spans the whole sequence.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .ring_attention import full_sequence_attention, resolve_sp_mesh

__all__ = ["ulysses_attention"]


def _kv_expansion(num_q_heads: int, num_kv_heads: int, n: int) -> int:
    """The least factor by which to repeat the K/V heads so their count
    divides over the ``sp`` axis and still groups evenly against the query
    heads: ``lcm(K, n) / K`` where ``lcm(K, n)`` divides ``H``, else ``H /
    K`` (full expansion, valid since ``H % n == 0``)."""
    target = math.lcm(num_kv_heads, n)
    if num_q_heads % target:
        target = num_q_heads
    return target // num_kv_heads


def _ulysses_body(q, k, v, kv_valid, *, group, n: int, axis_name: str, causal: bool,
                  impl=None):
    """q ``[B, S/n, H, d]``, k/v ``[B, S/n, K, d]`` (this process's chunk),
    ``kv_valid [B, S/n]`` or None -> ``[B, S/n, H, d]``."""
    from ..parallel.collectives import all_gather_dim, all_to_all_dim

    h, kh = q.shape[2], k.shape[2]
    if kh % n:
        rep = _kv_expansion(h, kh, n)
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    # Sequence-split -> head-split: the heads cut into n chunks, the
    # sequence chunks concatenated in rank order (the global order, so the
    # plain causal mask holds).
    qh, kh_, vh = (all_to_all_dim(t.contiguous(), 2, 1, group, axis_name) for t in (q, k, v))
    valid_full = None
    if kv_valid is not None:
        valid_full = all_gather_dim(kv_valid.to(torch.int8).contiguous(), 1, group,
                                    axis_name).bool()
    out = full_sequence_attention(qh, kh_, vh, causal=causal, kv_valid=valid_full, impl=impl)
    # Head-split -> sequence-split.
    return all_to_all_dim(out.contiguous(), 1, 2, group, axis_name)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh=None,
                      axis_name: str = "sp", causal: bool = True,
                      kv_valid: Optional[torch.Tensor] = None, impl=None) -> torch.Tensor:
    """Sequence-parallel attention, all-to-all variant; the contract of
    :func:`~.ring_attention.ring_attention`: this process's chunk q ``[B,
    S/n, H, d]``, k/v ``[B, S/n, K, d]`` -> ``[B, S/n, H, d]``, ``kv_valid
    [B, S/n]`` the chunk's key validity.  ``impl="pallas"`` runs the fused
    kernels as the local attention.  The local path where the axis is
    absent or of size 1.  ``H`` is the heads this process holds (under
    ``tp``, its share where ``tp`` divides them)."""
    mesh = resolve_sp_mesh(mesh, axis_name)
    if mesh is None:
        return full_sequence_attention(q, k, v, causal=causal, kv_valid=kv_valid, impl=impl)
    n = mesh.shape[axis_name]
    local_heads = q.shape[2]
    if local_heads % n:
        raise ValueError(
            f"ulysses needs (num_heads / tp-shard) divisible by the sp axis: "
            f"{local_heads} % {n} != 0 "
            "(use sp_impl='ring' for head counts below the axis size)"
        )
    return _ulysses_body(q, k, v, kv_valid, group=mesh.group(axis_name), n=n,
                         axis_name=axis_name, causal=causal, impl=impl)
