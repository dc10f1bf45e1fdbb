"""Chunked-vocabulary cross-entropy: the LM-head loss without the logits.

The JAX package's ``ops/chunked_ce.py`` in PyTorch.  The dense loss builds
fp32 logits ``[B, S, V]`` plus their log-softmax and cotangent; this op
streams the head matmul over vocabulary tiles with an online logsumexp, so
peak memory is one ``[B, S, chunk]`` tile.  Each tile runs under
``torch.utils.checkpoint``: the backward recomputes the tile from the
carried fp32 statistics instead of saving it (without it autograd would keep
every tile, the very logits-sized footprint this op exists to avoid).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["chunked_cross_entropy"]


def _tile(m, s, label_logit, x, tile_head, labels, c0: int, v: int):
    """Fold vocabulary columns ``c0 .. c0 + chunk - 1`` into the running max
    ``m``, the sum of exponentials at ``m`` and the label's logit."""
    chunk = tile_head.shape[1]
    logits = (x @ tile_head).float()  # [B, S, chunk]
    if c0 + chunk > v:  # the zero-padded last tile: padded columns get -inf
        cols = c0 + torch.arange(chunk, device=x.device)
        logits = logits.masked_fill(cols >= v, float("-inf"))
    new_m = torch.maximum(m, logits.amax(-1))
    s = s * torch.exp(m - new_m) + torch.exp(logits - new_m[..., None]).sum(-1)
    offset = labels - c0
    in_tile = (offset >= 0) & (offset < chunk)
    got = torch.gather(logits, -1, offset.clamp(0, chunk - 1)[..., None])[..., 0]
    return new_m, s, torch.where(in_tile, got, label_logit)


def chunked_ce_stats(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                     chunk_size: int = 4096):
    """The streamed statistics of ``x @ head`` per token: the max ``m``,
    the sum of exponentials at ``m`` and the label's logit (0 where the
    label is not a column of ``head``: a negative label, as the
    vocabulary-parallel loss passes for another rank's columns)."""
    d, v = head.shape
    if v % chunk_size:
        pad = chunk_size - v % chunk_size
        head = torch.cat([head, head.new_zeros(d, pad)], dim=1)
    labels = labels.long()
    b, s_len = labels.shape
    m = torch.full((b, s_len), float("-inf"), device=x.device)
    s = torch.zeros((b, s_len), device=x.device)
    label_logit = torch.zeros((b, s_len), device=x.device)
    grad = torch.is_grad_enabled()
    for c0 in range(0, head.shape[1], chunk_size):
        args = (m, s, label_logit, x, head[:, c0:c0 + chunk_size], labels, c0, v)
        if grad:
            m, s, label_logit = checkpoint(_tile, *args, use_reentrant=False)
        else:
            m, s, label_logit = _tile(*args)
    return m, s, label_logit


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor, chunk_size: int = 4096,
                          denom=None) -> torch.Tensor:
    """Weighted-mean token cross-entropy of ``softmax(x @ head)`` without
    the full logits.  ``x`` ``[B, S, d]`` (compute dtype; statistics in
    fp32), ``head`` ``[d, V]``, ``labels`` int ``[B, S]``, ``weights`` fp32
    ``[B, S]``.  Equals ``cross_entropy(x @ head, labels, weights)`` up to
    fp32 rounding: per token, ``logsumexp(logits) - logits[label]``.
    ``denom`` replaces the weights' own sum (floored at 1) as the divisor
    (a sequence chunk's share of the whole's mean)."""
    m, s, label_logit = chunked_ce_stats(x, head, labels, chunk_size)
    token_loss = (m + torch.log(s)) - label_logit
    total = (token_loss * weights).sum()
    return total / (torch.clamp(weights.sum(), min=1.0) if denom is None else denom)
