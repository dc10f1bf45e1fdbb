"""Ring attention over the fused flash kernels: the JAX package's
``ring_attention_pallas`` (``ops/pallas_attention.py``) with one process
per device.

The same contract as :func:`~.ring_attention.ring_attention` (this
process's chunk q ``[B, S/n, H, d]``, k/v ``[B, S/n, K, d]``), without a
padding mask: padded batches take the einsum ring, as JAX's ``sp_attention``
dispatches them.  Each hop runs the Hopper flash kernels of
:mod:`.fused_attention` on whole chunks:

- forward: hop 0 (the local chunk, at the queries' own offset) the causal
  forward kernel, each later hop ``r`` the non-causal one on the chunk
  ``(idx - r) mod n`` that :func:`~..parallel.collectives.ring_shift`
  brought; the ``(out, lse)`` pairs merge in fp32 (``lse' =
  logaddexp(lse_a, lse_b)``, ``out' = out_a e^(lse_a - lse') + out_b
  e^(lse_b - lse')``).  Under causal a chunk after the queries (``idx <
  r``) is computed and then left out (JAX gates its ``lse`` to ``-inf``),
  so every hop is a neighbour exchange of the same cost;
- backward: δ = rowsum(dO∘O) once, from the global ``out``; each hop the
  dQ and dK/dV kernels with the **global** ``lse`` (the exact softmax
  normaliser, so each block's backward is exact); dQ summed in fp32, and
  the fp32 dK/dV accumulators ride the ring with their chunks, one last
  hop bringing each home.

:func:`ring_fused_attention_plain` is the same ring over the kernels'
plain versions (:func:`~.fused_attention.fused_attention_fwd_plain` and
the plain backward), which the tests hold the kernels' ring against; no
path of the port calls it.  On CPU tensors the kernel wrappers run their
plain versions, so both rings compute the same there.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ring_attention import resolve_sp_mesh

__all__ = ["ring_fused_attention", "ring_fused_attention_plain"]


def _merge(out_acc, lse_acc, o_blk, lse_blk):
    """The flash merge of two normalised partial outputs, in fp32: ``out``
    ``[B, S, H, d]``, ``lse`` ``[B, H, S]``."""
    m = torch.maximum(lse_acc, lse_blk)
    lse_new = m + torch.log(torch.exp(lse_acc - m) + torch.exp(lse_blk - m))
    out = (out_acc * torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
           + o_blk.float() * torch.exp(lse_blk - lse_new).transpose(1, 2)[..., None])
    return out, lse_new


def _kernels(plain: bool):
    """``(forward, backward)``: the kernel wrappers, or their plain
    versions; ``backward(q, k, v, do, lse, delta, causal, blk)`` gives
    ``(dq, dk, dv)`` in the inputs' dtypes."""
    from . import fused_attention as fu

    if plain:
        def bwd(q, k, v, do, lse, delta, causal, blk):
            return fu._bwd_plain(q, k, v, lse, delta, do, None, causal, blk)

        return fu.fused_attention_fwd_plain, bwd

    def bwd(q, k, v, do, lse, delta, causal, blk):
        dq = fu.fused_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
        dk, dv = fu.fused_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
        return dq, dk, dv

    # Looked up at each call, so a swap of a wrapper (the plain twins of a
    # comparison) reaches the ring.
    return (lambda *a, **kw: fu.fused_attention_fwd(*a, **kw)), bwd


class _RingFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, n, idx, axis, causal, blk, plain):
        from ..parallel.collectives import ring_shift

        fwd, _ = _kernels(plain)
        out, lse = fwd(q, k, v, None, causal=causal, block_size=blk)
        out = out.float()
        k_r, v_r = k, v
        for r in range(1, n):
            k_r = ring_shift(k_r, group, axis)
            v_r = ring_shift(v_r, group, axis)
            o_blk, lse_blk = fwd(q, k_r, v_r, None, causal=False, block_size=blk)
            if causal and idx < r:
                continue  # a chunk after every local query: its lse is -inf
            out, lse = _merge(out, lse, o_blk, lse_blk)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (group, n, idx, axis, causal, blk, plain)
        return out

    @staticmethod
    def backward(ctx, do):
        from ..parallel.collectives import ring_shift
        from .fused_attention import _delta

        q, k, v, out, lse = ctx.saved_tensors
        group, n, idx, axis, causal, blk, plain = ctx.ring
        _, bwd = _kernels(plain)
        do = do.contiguous()
        delta = _delta(out, do)  # once, from the global out
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_r, v_r = k, v
        for r in range(n):
            if r:
                k_r = ring_shift(k_r, group, axis)
                v_r = ring_shift(v_r, group, axis)
                dk = ring_shift(dk, group, axis)
                dv = ring_shift(dv, group, axis)
            dq_b, dk_b, dv_b = bwd(q, k_r, v_r, do, lse, delta, causal and r == 0, blk)
            if causal and r and idx < r:
                continue
            dq += dq_b.float()
            dk += dk_b.float()
            dv += dv_b.float()
        # n - 1 hops in the loop: the accumulator here belongs to chunk
        # (idx + 1) mod n, one more brings every chunk's home.
        dk = ring_shift(dk, group, axis)
        dv = ring_shift(dv, group, axis)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None,
                None, None)


def _ring(q, k, v, mesh, axis_name, causal, block_size, kv_valid, plain):
    from .flash_attention import pick_block_pallas
    from .fused_attention import _block, fused_attention, fused_attention_fwd_plain

    mesh = resolve_sp_mesh(mesh, axis_name)
    if kv_valid is not None:
        raise ValueError("ring_fused_attention takes no kv_valid: padded batches take the "
                         "einsum ring (ring_attention)")
    if mesh is None:
        if plain:
            return fused_attention_fwd_plain(q, k, v, causal=causal,
                                             block_size=_block(q.shape[1], block_size))[0]
        return fused_attention(q, k, v, causal=causal, block_size=block_size)
    sq, d = q.shape[1], q.shape[-1]
    blk = pick_block_pallas(sq, head_dim=d)
    if blk is None:
        raise ValueError(
            f"ring_fused_attention needs the per-device sequence chunk ({sq}) divisible by "
            "64/128/256/512 (the kernels' tiles)")
    blk = min(blk, block_size)
    if sq % blk:
        raise ValueError(f"block_size {block_size} does not divide the per-device sequence "
                         f"chunk {sq}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"num q heads {q.shape[2]} not divisible by kv heads {k.shape[2]}")
    return _RingFused.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            mesh.group(axis_name), mesh.shape[axis_name],
                            mesh.coords()[axis_name], axis_name, causal, blk, plain)


def ring_fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh=None,
                         axis_name: str = "sp", *, causal: bool = True, block_size: int = 512,
                         kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ring of the module docstring over the flash kernels (on CUDA
    tensors; their plain versions on CPU ones), differentiable in q, k and
    v.  ``kv_valid`` raises; a chunk no fused block divides raises.  Where
    the axis is absent or of size 1: :func:`~.fused_attention.
    fused_attention`."""
    return _ring(q, k, v, mesh, axis_name, causal, block_size, kv_valid, plain=False)


def ring_fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh=None,
                               axis_name: str = "sp", *, causal: bool = True,
                               block_size: int = 512,
                               kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`ring_fused_attention` over the kernels' plain versions, on any
    device."""
    return _ring(q, k, v, mesh, axis_name, causal, block_size, kv_valid, plain=True)
