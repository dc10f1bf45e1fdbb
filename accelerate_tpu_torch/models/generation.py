"""Generation driver and paged-KV primitives shared by the model families —
the fp parts of the JAX package's ``accelerate_tpu/models/generation.py``.

A family supplies ``init_cache(config, batch, max_len, device=...)`` and
``apply_cached(params, ids, config, cache) -> (logits, cache)``.  Where the
JAX functions return updated copies of a cache or pool (and the engine's
programs donate the old one), these write into the tensors they are given
and say so; the values are the same.

Not ported yet: the int8 cache (``quantize_kv``/``dequantize_kv``), the
host tier (``demote/promote_pool_blocks``), sampling, beam search and the
offline speculative loop.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

__all__ = [
    "make_kv_cache", "check_cache_room", "cache_write", "make_paged_pool", "gather_block_view",
    "extract_token_rows", "scatter_token_rows", "paged_cache_write",
    "pack_paged_pool_for_scan", "unpack_paged_rows_from_scan", "generate_loop",
    "speculative_verify_greedy",
]


def make_kv_cache(num_layers: int, batch_size: int, max_len: int, num_kv_heads: int,
                  head_dim: int, dtype, device) -> dict:
    """Zeroed stacked KV cache: k/v ``[L, B, max_len, K, hd]`` plus the write
    index (a Python int)."""
    shape = (num_layers, batch_size, max_len, num_kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }


def check_cache_room(index: int, new_tokens: int, max_len: int) -> None:
    """Overflow guard: a write past ``max_len`` raises instead of landing
    out of bounds."""
    if int(index) + new_tokens > max_len:
        raise ValueError(
            f"KV cache overflow: index {int(index)} + {new_tokens} new tokens > max_len {max_len}"
        )


def cache_write(cache_leaf: torch.Tensor, new_rows: torch.Tensor, index: int) -> torch.Tensor:
    """Write ``new_rows`` ``[B, S, K, hd]`` into one layer's cache leaf
    ``[B, max_len, K, hd]`` at ``index``, in place; returns the leaf, which
    is also the attention context."""
    s = new_rows.shape[1]
    cache_leaf[:, index:index + s] = new_rows.to(cache_leaf.dtype)
    return cache_leaf


# ---------------------------------------------------------------------------
# Paged (block) KV cache primitives — the storage layer under the serving
# engine.  The pool holds [L, num_blocks, block_size, K, hd] per leaf; block
# 0 is the null block that table padding and inactive slots point at.
# ---------------------------------------------------------------------------


def make_paged_pool(init_cache: Callable, config, num_blocks: int, block_size: int,
                    device) -> dict:
    """Zeroed block pool on ``device`` derived from a family's own
    ``init_cache``: each non-``index`` leaf ``[L, 1, block_size, *rest]`` of
    the batch-1 template (built on the meta device, so nothing is
    allocated) becomes ``[L, num_blocks, block_size, *rest]``."""
    template = init_cache(config, 1, block_size, device="meta")
    pool = {}
    for name, leaf in template.items():
        if name == "index":
            continue
        if leaf.dim() < 3 or leaf.shape[1] != 1 or leaf.shape[2] != block_size:
            raise ValueError(
                f"cache leaf {name!r} has shape {tuple(leaf.shape)}; paged serving needs "
                f"the make_kv_cache layout [L, B, max_len, ...] (batch axis 1, token axis 2)"
            )
        pool[name] = torch.zeros(
            (leaf.shape[0], num_blocks) + tuple(leaf.shape[2:]), dtype=leaf.dtype, device=device
        )
    if not pool:
        raise ValueError("init_cache produced no pageable KV leaves")
    return pool


def gather_block_view(pool_leaf: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Dense per-slot view of a pool leaf: ``[L, N, bs, *r]`` through block
    tables ``[S, M]`` -> ``[S, L, 1, M*bs, *r]``."""
    g = pool_leaf[:, tables.long()]  # [L, S, M, bs, *r]
    g = g.movedim(1, 0)
    s, l, m, bs = g.shape[:4]
    return g.reshape(s, l, 1, m * bs, *g.shape[4:])


def _token_positions(start: torch.Tensor, count: int) -> torch.Tensor:
    return start[:, None].long() + torch.arange(count, device=start.device)[None, :]


def extract_token_rows(view_leaf: torch.Tensor, start: torch.Tensor, count: int) -> torch.Tensor:
    """Rows at positions ``start[s] + arange(count)`` of a dense view
    ``[S, L, 1, T, *r]`` -> ``[S, L, count, *r]``."""
    pos = _token_positions(start, count)  # [S, count]
    rows = view_leaf[:, :, 0]  # [S, L, T, *r]
    idx = torch.arange(rows.shape[0], device=rows.device)[:, None]
    return rows[idx, :, pos].movedim(2, 1)  # [S, count, L, *r] -> [S, L, count, *r]


def scatter_token_rows(pool_leaf: torch.Tensor, rows: torch.Tensor, tables: torch.Tensor,
                       start: torch.Tensor, count: int) -> torch.Tensor:
    """Write token rows ``[S, L, count, *r]`` into the pool, in place, at
    positions ``start[s] + arange(count)`` through block tables ``[S, M]``.
    Positions past the table extent (chunked-prefill padding) go to the
    null block explicitly: clamping the block index would overwrite a real
    block.  Returns the pool leaf."""
    bs = pool_leaf.shape[2]
    m = tables.shape[1]
    pos = _token_positions(start, count)  # [S, count]
    blk_idx = pos // bs
    blk = torch.gather(tables.long(), 1, blk_idx.clamp(0, m - 1))
    blk = torch.where(blk_idx < m, blk, torch.zeros_like(blk))
    off = pos % bs
    pool_leaf[:, blk, off] = rows.movedim(0, 1).to(pool_leaf.dtype)
    return pool_leaf


def _insert_rows(ctx: torch.Tensor, new_rows: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Overlay ``new_rows`` ``[B, T, *r]`` onto the gathered context ``[B, P,
    *r]`` at positions ``starts[b] .. starts[b]+T-1``."""
    b, p = ctx.shape[:2]
    t = new_rows.shape[1]
    rel = torch.arange(p, device=ctx.device)[None, :] - starts[:, None].long()  # [B, P]
    tail = (1,) * (ctx.dim() - 2)
    picked = torch.gather(
        new_rows, 1, rel.clamp(0, t - 1).reshape(b, p, *tail).expand(b, p, *new_rows.shape[2:])
    )
    in_new = ((rel >= 0) & (rel < t)).reshape(b, p, *tail)
    return torch.where(in_new, picked, ctx)


def paged_cache_write(pool_layer: torch.Tensor, new_rows: torch.Tensor, tables: torch.Tensor,
                      starts: torch.Tensor):
    """Per-layer paged analog of :func:`cache_write` for the fp pool: the
    stored form of ``new_rows`` ``[B, T, K, hd]`` (cast to the pool dtype)
    and the attention context ``[B, M*bs, K, hd]`` gathered through
    ``tables`` ``[B, M]`` with the new rows overlaid at ``starts[b] +
    arange(T)``.  The pool is only read; the caller scatters the stored
    rows afterwards."""
    b, m = tables.shape
    bs = pool_layer.shape[1]
    stored = new_rows.to(pool_layer.dtype)
    ctx = pool_layer[tables.long()].reshape(b, m * bs, *pool_layer.shape[2:])
    return stored, _insert_rows(ctx, stored, starts)


def pack_paged_pool_for_scan(pool: dict):
    """The pool leaves a family's layer loop walks: ``(k, v)``, each leading
    with the layer axis.  int8 pools raise ``NotImplementedError``."""
    if "k_scale" in pool or pool["k"].dtype == torch.int8:
        raise NotImplementedError("int8 paged pools are not ported to accelerate_tpu_torch yet")
    return pool["k"], pool["v"]


def unpack_paged_rows_from_scan(k_rows: List[torch.Tensor], v_rows: List[torch.Tensor]) -> dict:
    """Per-layer stored rows (each ``[B, T, ...]``) -> ``{leaf: [B, L, T,
    ...]}``, the layout :func:`scatter_token_rows` writes."""
    return {"k": torch.stack(k_rows, 1), "v": torch.stack(v_rows, 1)}


@torch.no_grad()
def generate_loop(apply_cached: Callable, init_cache: Callable, params, input_ids: torch.Tensor,
                  config, max_new_tokens: int, temperature: float = 0.0,
                  max_len: Optional[int] = None,
                  prefill_chunk: Optional[int] = None) -> torch.Tensor:
    """Greedy generation: dense prompt ``[B, S]`` -> ``[B, S +
    max_new_tokens]``; ``prefill_chunk`` feeds the prompt in slices of that
    many tokens (same outputs).  Sampling is not ported yet."""
    if temperature > 0.0:
        raise NotImplementedError("sampled generation is not ported to accelerate_tpu_torch yet")
    b, s = input_ids.shape
    total = s + max_new_tokens
    if max_len is None:
        max_len = total
    if total > max_len:
        raise ValueError(f"prompt ({s}) + max_new_tokens ({max_new_tokens}) > max_len ({max_len})")
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if max_new_tokens == 0:
        return input_ids
    if prefill_chunk is not None and prefill_chunk < 1:
        raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
    cache = init_cache(config, b, max_len, device=input_ids.device)
    step = s if prefill_chunk is None else prefill_chunk
    for start in range(0, s, step):
        logits, cache = apply_cached(params, input_ids[:, start:start + step], config, cache)
    tok = logits[:, -1].argmax(-1)
    out = [tok]
    for _ in range(1, max_new_tokens):
        logits, cache = apply_cached(params, tok[:, None], config, cache)
        tok = logits[:, -1].argmax(-1)
        out.append(tok)
    return torch.cat([input_ids, torch.stack(out, 1).to(input_ids.dtype)], 1)


def speculative_verify_greedy(t_logits: torch.Tensor, drafts: torch.Tensor,
                              draft_len: Optional[torch.Tensor] = None):
    """Per-row greedy verify/accept for draft-then-verify decoding.

    ``t_logits`` ``[B, γ+1, V]`` (row ``j`` is the distribution after window
    token ``j``), ``drafts`` ``[B, γ]``.  Returns ``(t, m)``: ``t`` ``[B,
    γ+1]`` the target argmax at every window position and ``m`` ``[B]`` the
    accepted count — draft ``j`` is accepted iff it equals ``t[:, j-1]`` and
    every earlier draft was accepted.  ``draft_len`` ``[B]`` masks ragged
    proposals: positions at or past ``draft_len[b]`` are never accepted."""
    gamma = drafts.shape[1]
    t = t_logits.argmax(-1).to(torch.int32)
    accept = t[:, :gamma] == drafts
    if draft_len is not None:
        accept = accept & (
            torch.arange(gamma, device=drafts.device)[None, :] < draft_len[:, None]
        )
    m = torch.cumprod(accept.to(torch.int32), dim=1).sum(1).to(torch.int32)
    return t, m
