"""Ring attention: sequence parallelism over the ``sp`` mesh axis.

The JAX package's ``ops/ring_attention.py`` with one process per device:
each process holds its chunk of the sequence, q ``[B, S/n, H, d]`` and k/v
``[B, S/n, K, d]`` (the JAX function takes the global arrays and lets
``shard_map`` hand each device its chunk; here the chunk is the input).  The
K/V chunks travel around the ring of the ``sp`` group
(:func:`~..parallel.collectives.ring_shift`, JAX's ``ppermute`` with the
permutation ``(i, i + 1 mod n)``) while each process keeps an online-softmax
accumulator (m, l, o in fp32) for its queries.  Causality is decided per
block from global positions: after ``r`` hops a process holds chunk ``(idx
- r) mod n``; a chunk after its queries contributes nothing but still rides
the ring.  ``kv_valid`` (a padded batch's key validity, the chunk's ``[B,
S/n]``) rides the ring beside its K/V block.

The einsum ring is differentiated by autograd: each hop is a differentiable
shift whose backward is the shift the other way (JAX's transpose of
``ppermute``).  The ring over the fused kernels, with a backward of its own,
is in :mod:`.ring_fused`.  Under ``tp`` each process runs the ring on the
heads it holds (the projections give it only those where
:func:`tp_head_axis` shards them).

:func:`full_sequence_attention` is the non-ring path (one process, and the
local attention of :mod:`.ulysses_attention`): the fused kernels under
``impl="pallas"`` where a fused block tiles the sequence, else the blockwise
flash path where a block divides it, else one dense block through the same
online-softmax math.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = [
    "ring_attention",
    "ring_self_attention",
    "full_sequence_attention",
    "resolve_sp_mesh",
    "tp_head_axis",
]


def resolve_sp_mesh(mesh, axis_name: str):
    """The mesh of the sp backends: ``mesh``, else the live state's; None
    when the axis is absent or of size 1 (the caller runs the local
    path)."""
    if mesh is None:
        from ..state import AcceleratorState

        mesh = AcceleratorState._shared_state.get("mesh")
    if mesh is None or axis_name not in mesh.axis_names or mesh.shape[axis_name] == 1:
        return None
    return mesh


def tp_head_axis(mesh, num_heads: int, num_kv_heads: int, extra_div: int = 1) -> Optional[str]:
    """The shared ``tp`` head policy: ``"tp"`` where ``tp`` divides both head
    counts (and, for Ulysses, the heads a ``tp`` rank holds divide by
    ``extra_div``), else None (every ``tp`` rank holds every head)."""
    tp = mesh.shape.get("tp", 1)
    if (tp > 1 and num_heads % tp == 0 and num_kv_heads % tp == 0
            and (num_heads // tp) % extra_div == 0):
        return "tp"
    return None


def _block_attention(q, k, v, mask, m_prev, l_prev, o_prev, scale):
    """One K/V block against the local queries with online-softmax
    accumulation: q ``[B, Sq, H, d]``, k/v ``[B, Sk, K, d]`` (GQA: ``H = K
    * groups``), ``mask`` broadcastable to ``[B, H, Sq, Sk]``; m, l ``[B, H,
    Sq]`` and o ``[B, Sq, H, d]`` in fp32."""
    b, sq, h, d = q.shape
    kheads = k.shape[2]
    groups = h // kheads
    qg = q.reshape(b, sq, kheads, groups, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    scores = scores.reshape(b, h, sq, -1)
    scores = torch.where(mask, scores, float("-inf"))
    m_cur = scores.amax(-1)
    m_new = torch.maximum(m_prev, m_cur)
    # Fully masked rows (m_new = -inf) must not give NaN.
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(mask, p, 0.0)
    alpha = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - m_safe), 0.0)
    l_new = alpha * l_prev + p.sum(-1)
    pk = p.reshape(b, kheads, groups, sq, -1)
    o_blk = torch.einsum("bkgst,btkd->bskgd", pk.to(v.dtype), v).reshape(b, sq, h, d)
    o_new = o_prev * alpha.transpose(1, 2)[..., None] + o_blk.float()
    return m_new, l_new, o_new


def full_sequence_attention(q, k, v, causal: bool = True, kv_valid=None, impl=None):
    """Attention over the whole local sequence: q ``[B, S, H, d]``, k/v
    ``[B, S, K, d]``, ``kv_valid [B, S]`` marking valid keys.
    ``impl="pallas"``: the fused kernels (:func:`~.fused_attention.
    fused_attention`, padded batches included) where a fused block tiles
    ``S``; otherwise the blockwise flash path where a block divides ``S``,
    else one dense block."""
    from .flash_attention import flash_attention, pick_block, pick_block_pallas

    b, s, h, d = q.shape
    if impl == "pallas":
        blk = pick_block_pallas(s, head_dim=d)
        if blk is not None:
            from .fused_attention import fused_attention

            return fused_attention(q, k, v, causal=causal, block_size=blk, kv_valid=kv_valid)
    blk = pick_block(s)
    if blk is not None and s > blk:
        return flash_attention(q, k, v, causal=causal, block_size=blk, kv_valid=kv_valid)
    mask = torch.ones(1, 1, s, s, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask.tril()
    if kv_valid is not None:
        mask = mask & kv_valid.bool()[:, None, None, :]
    m0 = torch.full((b, h, s), float("-inf"), device=q.device)
    l0 = torch.zeros((b, h, s), device=q.device)
    o0 = torch.zeros((b, s, h, d), device=q.device)
    _, l, o = _block_attention(q, k, v, mask, m0, l0, o0, 1.0 / math.sqrt(d))
    return (o / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]).to(q.dtype)


class _Shift(torch.autograd.Function):
    """A ring hop with autograd: forward to the next rank, backward the
    gradient to the previous one."""

    @staticmethod
    def forward(ctx, t, group, axis):
        from ..parallel.collectives import ring_shift

        ctx.group, ctx.axis = group, axis
        return ring_shift(t, group, axis)

    @staticmethod
    def backward(ctx, grad):
        from ..parallel.collectives import ring_shift

        return ring_shift(grad.contiguous(), ctx.group, ctx.axis, reverse=True), None, None


def _ring_body(q, k, v, kv_valid, *, group, n: int, idx: int, axis_name: str, causal: bool):
    """This process's queries against every chunk's K/V, which rotate
    ``n - 1`` times (the validity chunk beside them)."""
    from ..parallel.collectives import ring_shift

    b, sq, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, h, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    o = torch.zeros((b, sq, h, d), device=q.device)
    q_pos = idx * sq + torch.arange(sq, device=q.device)
    k_r, v_r, valid_r = k, v, kv_valid
    for r in range(n):
        if r:
            k_r = _Shift.apply(k_r, group, axis_name)
            v_r = _Shift.apply(v_r, group, axis_name)
            if valid_r is not None:
                valid_r = ring_shift(valid_r, group, axis_name)
        src = (idx - r) % n  # the ring position whose K/V this process holds
        sk = k_r.shape[1]
        if causal:
            k_pos = src * sk + torch.arange(sk, device=q.device)
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        else:
            mask = torch.ones(1, 1, sq, sk, dtype=torch.bool, device=q.device)
        if valid_r is not None:
            mask = mask & valid_r.bool()[:, None, None, :]
        m, l, o = _block_attention(q, k_r, v_r, mask, m, l, o, scale)
    out = o / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh=None,
                   axis_name: str = "sp", causal: bool = True,
                   kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence-parallel attention of this process's chunk: q ``[B, S/n, H,
    d]``, k/v ``[B, S/n, K, d]`` -> ``[B, S/n, H, d]``, the chunks in rank
    order along ``axis_name`` of ``mesh`` (the live state's by default).
    ``kv_valid [B, S/n]`` (the chunk's key validity) rides the ring beside
    its K/V.  Where the axis is absent or of size 1:
    :func:`full_sequence_attention`."""
    mesh = resolve_sp_mesh(mesh, axis_name)
    if mesh is None:
        return full_sequence_attention(q, k, v, causal=causal, kv_valid=kv_valid)
    valid = None
    if kv_valid is not None:
        # int8 on the wire (gloo's point-to-point takes no bool).
        valid = kv_valid.to(torch.int8).contiguous()
    return _ring_body(q, k.contiguous(), v.contiguous(), valid, group=mesh.group(axis_name),
                      n=mesh.shape[axis_name], idx=mesh.coords()[axis_name],
                      axis_name=axis_name, causal=causal)


def ring_self_attention(x_q, x_k, x_v, **kwargs):
    """:func:`ring_attention` under a fused-QKV call's names."""
    return ring_attention(x_q, x_k, x_v, **kwargs)
