"""Blockwise causal attention (online softmax over K/V blocks) and the block
pickers shared by the attention paths.

The JAX package's ``ops/flash_attention.py`` in PyTorch: :func:`flash_attention`
streams K/V in blocks with a running (m, l, o) accumulator, so peak attention
memory is one ``[B, H, S, blk]`` score tile instead of ``[B, H, S, S]``.  Each
block step runs under ``torch.utils.checkpoint`` so the backward recomputes
its scores instead of storing them, as ``jax.checkpoint`` does there.  It is
plain PyTorch, runs on CPU and GPU, and serves ``attention_impl="flash"``;
the fused kernels are in ``ops/fused_attention.py``.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["flash_attention", "pick_block", "pick_block_pallas"]


def pick_block(s: int, ladder: tuple = (512, 256, 128, 64),
               max_single_block: int = 0) -> Optional[int]:
    """Largest block from ``ladder`` dividing ``s`` (None when none does).
    ``ACCELERATE_ATTN_BLOCK`` overrides when it is a positive integer
    dividing ``s``; one that does not divide ``s`` is ignored with a
    warning.  Short sequences no ladder entry divides run as one block up to
    ``max_single_block`` (0 disables that)."""
    override = os.environ.get("ACCELERATE_ATTN_BLOCK")
    if override:
        try:
            value = int(override)
        except ValueError:
            raise ValueError(
                f"ACCELERATE_ATTN_BLOCK must be a positive integer, got {override!r}"
            ) from None
        if value <= 0:
            raise ValueError(f"ACCELERATE_ATTN_BLOCK must be positive, got {value}")
        if s % value == 0:
            return value
        warnings.warn(
            f"ACCELERATE_ATTN_BLOCK={value} does not divide the sequence length "
            f"{s}; the override is ignored and the block ladder decides — this "
            "tuning run is NOT measuring the requested block.",
            stacklevel=2,
        )
    for b in ladder:
        if s % b == 0:
            return b
    if 0 < s <= max_single_block:
        return s
    return None


def pick_block_pallas(s: int, head_dim: int) -> Optional[int]:
    """Block ladder of the fused path: 1024 first where ``head_dim <= 128``;
    sequences up to 1024 that no entry divides run as one block."""
    ladder = (1024, 512, 256, 128, 64) if head_dim <= 128 else (512, 256, 128, 64)
    return pick_block(s, ladder=ladder, max_single_block=1024)


def _block_step(m_prev, l_prev, o_prev, q, k_blk, v_blk, valid_blk, k_start: int,
                causal: bool, scale: float):
    """One K/V block against all queries: q ``[B, S, K, G, d]``, blocks
    ``[B, blk, K, d]``, ``valid_blk [B, blk]`` bool or None; carries m, l
    ``[B, H, S]`` and o ``[B, S, H, d]`` fp32."""
    b, s, kh, g, d = q.shape
    blk = k_blk.shape[1]
    scores = torch.einsum("bskgd,btkd->bkgst", q, k_blk).float() * scale
    scores = scores.reshape(b, kh * g, s, blk)
    mask = None
    if causal:
        q_pos = torch.arange(s, device=q.device)
        k_pos = k_start + torch.arange(blk, device=q.device)
        mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
    if valid_blk is not None:
        vm = valid_blk[:, None, None, :]
        mask = vm if mask is None else mask & vm
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    m_cur = scores.amax(-1)
    m_new = torch.maximum(m_prev, m_cur)
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(torch.isneginf(scores), 0.0, p)
    alpha = torch.exp(m_prev - m_safe)
    alpha = torch.where(torch.isneginf(m_prev), 0.0, alpha)
    l_new = l_prev * alpha + p.sum(-1)
    pv = torch.einsum(
        "bkgst,btkd->bskgd", p.reshape(b, kh, g, s, blk).to(v_blk.dtype), v_blk
    ).reshape(b, s, kh * g, d)
    o_new = o_prev * alpha.transpose(1, 2)[..., None] + pv.float()
    return m_new, l_new, o_new


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    block_size: int = 512,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA attention without the score matrix: q ``[B, S, H, d]``, k/v
    ``[B, S, K, d]``; returns ``[B, S, H, d]`` in q's dtype.  ``kv_valid``
    ``[B, S]`` marks valid keys; queries with no valid key produce zeros."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    blk = min(block_size, s)
    if s % blk:
        raise ValueError(f"seq len {s} must be divisible by block_size {blk}")
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, kh, h // kh, d)
    valid = None if kv_valid is None else kv_valid.bool()
    m = torch.full((b, h, s), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s), device=q.device)
    o = torch.zeros((b, s, h, d), device=q.device)
    grad = torch.is_grad_enabled()
    for k0 in range(0, s, blk):
        args = (m, l, o, qg, k[:, k0:k0 + blk], v[:, k0:k0 + blk],
                None if valid is None else valid[:, k0:k0 + blk], k0, causal, scale)
        if grad:
            m, l, o = checkpoint(_block_step, *args, use_reentrant=False)
        else:
            m, l, o = _block_step(*args)
    l = torch.clamp(l, min=1e-30)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)
