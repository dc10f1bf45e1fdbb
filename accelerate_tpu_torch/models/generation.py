"""Generation driver and paged-KV primitives shared by the model families —
the fp parts of the JAX package's ``accelerate_tpu/models/generation.py``.

A family supplies ``init_cache(config, batch, max_len, device=...)`` and
``apply_cached(params, ids, config, cache) -> (logits, cache)``.  Where the
JAX functions return updated copies of a cache or pool (and the engine's
programs donate the old one), these write into the tensors they are given
and say so; the values are the same.

The int8 cache stores codes with a bf16 absmax scale per (position, head)
(:func:`quantize_kv`); every cache and pool helper takes either layout.
:func:`demote_pool_blocks` / :func:`promote_pool_blocks` move whole blocks
between the pool and the serving engine's host tier.

Not ported yet: sampling, beam search and the offline speculative loop.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

__all__ = [
    "make_kv_cache", "check_cache_room", "quantize_kv", "dequantize_kv", "cache_write",
    "make_paged_pool", "gather_block_view", "extract_token_rows", "scatter_token_rows",
    "paged_cache_write", "pack_paged_pool_for_scan", "unpack_paged_rows_from_scan",
    "demote_pool_blocks", "promote_pool_blocks", "generate_loop", "speculative_verify_greedy",
]


def make_kv_cache(num_layers: int, batch_size: int, max_len: int, num_kv_heads: int,
                  head_dim: int, dtype, device, quantized: bool = False) -> dict:
    """Zeroed stacked KV cache: k/v ``[L, B, max_len, K, hd]`` plus the write
    index (a Python int).  ``quantized=True`` stores int8 codes in k/v and a
    bf16 scale per (position, head) in ``k_scale``/``v_scale`` ``[L, B,
    max_len, K]``."""
    shape = (num_layers, batch_size, max_len, num_kv_heads, head_dim)
    if quantized:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            "index": 0,
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }


def quantize_kv(x: torch.Tensor):
    """Absmax int8 quantization of K/V rows over the last axis: ``[..., hd]``
    -> (codes int8 ``[..., hd]``, scale bf16 ``[...]``).  As in the JAX
    package, the codes divide by the scale in ``x``'s dtype and the stored
    scale is its bf16 rounding; ``torch.round`` rounds half to even like
    ``jnp.round``."""
    scale = torch.clamp(x.abs().amax(-1), min=1e-6) / 127.0
    codes = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return codes, scale.to(torch.bfloat16)


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` with the stored bf16 scale."""
    return codes.to(dtype) * scale[..., None].to(dtype)


def check_cache_room(index: int, new_tokens: int, max_len: int) -> None:
    """Overflow guard: a write past ``max_len`` raises instead of landing
    out of bounds."""
    if int(index) + new_tokens > max_len:
        raise ValueError(
            f"KV cache overflow: index {int(index)} + {new_tokens} new tokens > max_len {max_len}"
        )


def cache_write(cache_leaf, new_rows: torch.Tensor, index: int, dtype=None) -> torch.Tensor:
    """Write ``new_rows`` ``[B, S, K, hd]`` into one layer's cache leaf
    ``[B, max_len, K, hd]`` at ``index``, in place, and return the attention
    context: the leaf itself, or for the int8 layout (a ``(codes, scale)``
    pair) the whole layer dequantized to ``dtype``."""
    s = new_rows.shape[1]
    if isinstance(cache_leaf, tuple):
        codes, scale = cache_leaf
        n_codes, n_scale = quantize_kv(new_rows)
        codes[:, index:index + s] = n_codes
        scale[:, index:index + s] = n_scale
        return dequantize_kv(codes, scale, dtype or new_rows.dtype)
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


def paged_cache_write(pool_layer, new_rows: torch.Tensor, tables: torch.Tensor,
                      starts: torch.Tensor, dtype=None):
    """Per-layer paged analog of :func:`cache_write`: the stored form of
    ``new_rows`` ``[B, T, K, hd]`` (cast to the fp pool's dtype, or
    ``(codes, scale)`` for the int8 pool, a ``(codes [N, bs, K, hd], scale
    [N, bs, K])`` pair) and the attention context ``[B, M*bs, K, hd]``
    gathered through ``tables`` ``[B, M]`` with the new rows overlaid at
    ``starts[b] + arange(T)``; an int8 context is dequantized to ``dtype``.
    The pool is only read; the caller scatters the stored rows afterwards."""
    b, m = tables.shape
    idx = tables.long()
    if isinstance(pool_layer, tuple):
        codes, scale = pool_layer
        bs = codes.shape[1]
        dtype = dtype or new_rows.dtype
        stored = quantize_kv(new_rows)
        ctx = dequantize_kv(codes[idx].reshape(b, m * bs, *codes.shape[2:]),
                            scale[idx].reshape(b, m * bs, *scale.shape[2:]), dtype)
        # Attention sees the QUANTIZED new rows, as a dense int8 cache would.
        return stored, _insert_rows(ctx, dequantize_kv(*stored, dtype), starts)
    bs = pool_layer.shape[1]
    stored = new_rows.to(pool_layer.dtype)
    ctx = pool_layer[idx].reshape(b, m * bs, *pool_layer.shape[2:])
    return stored, _insert_rows(ctx, stored, starts)


def pack_paged_pool_for_scan(pool: dict):
    """The pool leaves a family's layer loop walks, each leading with the
    layer axis: ``(k, v, False)``, or ``((k, k_scale), (v, v_scale), True)``
    for the int8 pool.  int8 codes without their scales raise."""
    quant = "k_scale" in pool
    if not quant and pool["k"].dtype == torch.int8:
        raise ValueError("an int8 paged pool needs its k_scale and v_scale leaves")
    pk = (pool["k"], pool["k_scale"]) if quant else pool["k"]
    pv = (pool["v"], pool["v_scale"]) if quant else pool["v"]
    return pk, pv, quant


def unpack_paged_rows_from_scan(k_rows: list, v_rows: list, quant: bool = False) -> dict:
    """Per-layer stored rows (each ``[B, T, ...]``, or a ``(codes, scale)``
    pair for int8) -> ``{leaf: [B, L, T, ...]}``, the layout
    :func:`scatter_token_rows` writes."""
    if quant:
        return {
            "k": torch.stack([r[0] for r in k_rows], 1),
            "k_scale": torch.stack([r[1] for r in k_rows], 1),
            "v": torch.stack([r[0] for r in v_rows], 1),
            "v_scale": torch.stack([r[1] for r in v_rows], 1),
        }
    return {"k": torch.stack(k_rows, 1), "v": torch.stack(v_rows, 1)}


def _wait_for_copies(device: torch.device) -> None:
    """Block the host until the copies just queued on ``device``'s current
    stream have landed (an event recorded after them, then waited on): a
    host buffer read or written by a ``non_blocking`` copy is then free to
    be reused, scrubbed or read."""
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        event.synchronize()


def demote_pool_blocks(pool: dict, blocks: List[int]) -> dict:
    """Copy whole blocks out of every pool leaf to host memory: ``{name:
    [L, n, bs, *r]}`` on the CPU for ``n = len(blocks)``.  The blocks are
    gathered on the device (``index_select`` on the block axis) and each
    leaf comes back in one copy, into pinned memory when the pool is on a
    GPU; the copies have landed when this returns."""
    out = {}
    for name, leaf in pool.items():
        idx = torch.as_tensor(blocks, dtype=torch.long, device=leaf.device)
        rows = leaf.index_select(1, idx)
        if leaf.device.type == "cpu":
            out[name] = rows
            continue
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        host.copy_(rows, non_blocking=True)
        out[name] = host
    _wait_for_copies(next(iter(pool.values())).device)
    return out


def promote_pool_blocks(pool: dict, host_rows: dict, dst_blocks: List[int]) -> None:
    """Write host block rows ``{name: [L, n, bs, *r]}`` into the pool at block
    ids ``dst_blocks``, in place: one host-to-device copy (from pinned
    memory, for a GPU pool) and one ``index_copy_`` per leaf.  The copies
    have landed when this returns, so the host rows may be reused."""
    for name, leaf in pool.items():
        dst = torch.as_tensor(dst_blocks, dtype=torch.long, device=leaf.device)
        leaf.index_copy_(1, dst, host_rows[name].to(leaf.device, non_blocking=True))
    _wait_for_copies(next(iter(pool.values())).device)


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
