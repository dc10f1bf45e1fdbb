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

Decoding: greedy and sampled :func:`generate_loop` (top-k / top-p under
an explicit key, :func:`select_token`), :func:`beam_search` and the
batch-1 :func:`speculative_generate_loop`, greedy or rejection-sampled.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

__all__ = [
    "make_kv_cache", "check_cache_room", "quantize_kv", "dequantize_kv", "cache_write",
    "make_paged_pool", "gather_block_view", "extract_token_rows", "scatter_token_rows",
    "paged_cache_write", "pack_paged_pool_for_scan", "unpack_paged_rows_from_scan",
    "demote_pool_blocks", "promote_pool_blocks", "generate_loop", "select_token",
    "speculative_verify_greedy", "speculative_generate_loop", "beam_search",
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


def _categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """One sample per row of ``logits`` ``[..., V]`` under ``key``:
    ``argmax(gumbel + logits)``, as ``jax.random.categorical`` draws."""
    return (key.gumbel(logits.shape, logits.device) + logits).argmax(-1)


def _top_k(x: torch.Tensor, k: int):
    """The ``k`` largest entries of the last axis, ties broken by the lower
    index as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no tie
    order): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_token(logits: torch.Tensor, temperature: float, key, i: int, top_k: int = 0,
                 top_p: float = 1.0) -> torch.Tensor:
    """Greedy argmax (``temperature <= 0``) or a filtered categorical sample
    at step ``i`` (step key ``key.fold_in(i)``).  ``top_k > 0`` keeps the k
    highest logits; ``top_p < 1`` keeps the smallest set whose cumulative
    probability reaches p, the top-1 token always.  One vocab sort at most,
    shared by the two filters."""
    if temperature <= 0.0:
        return logits.argmax(-1).to(torch.int32)
    logits = logits / temperature
    sorted_desc = None
    if top_k > 0:
        k = min(int(top_k), logits.shape[-1])
        # The descending top-k values double as the sorted prefix for top_p:
        # masked tokens carry no probability.
        sorted_desc = torch.topk(logits, k, dim=-1).values
        logits = torch.where(logits < sorted_desc[..., -1:], float("-inf"), logits)
    if top_p < 1.0:
        if sorted_desc is None:
            sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # A token is cut when the mass BEFORE it already reaches p, so the
        # token that crosses the threshold is kept.
        cut = (cum - probs) >= top_p
        cutoff = torch.where(cut, float("inf"), sorted_desc).amin(-1, keepdim=True)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return _categorical(key.fold_in(i), logits).to(torch.int32)


@torch.no_grad()
def generate_loop(apply_cached: Callable, init_cache: Callable, params, input_ids: torch.Tensor,
                  config, max_new_tokens: int, temperature: float = 0.0, key=None,
                  max_len: Optional[int] = None, top_k: int = 0, top_p: float = 1.0,
                  prefill_chunk: Optional[int] = None) -> torch.Tensor:
    """Dense prompt ``[B, S]`` -> ``[B, S + max_new_tokens]``, greedy
    (``temperature <= 0``) or sampled under ``key`` (a
    :class:`~accelerate_tpu_torch.utils.random.PRNGKey`; token ``i`` draws
    with ``key.fold_in(i)``).  ``prefill_chunk`` feeds the prompt in slices
    of that many tokens (same outputs)."""
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if temperature <= 0.0 and (top_k > 0 or top_p < 1.0):
        raise ValueError(
            "top_k/top_p filter a SAMPLED distribution; greedy decoding "
            "(temperature<=0, the default) would silently ignore them — pass "
            "temperature>0 (with a PRNG key) to sample."
        )
    b, s = input_ids.shape
    total = s + max_new_tokens
    if max_len is None:
        max_len = total
    if total > max_len:
        raise ValueError(f"prompt ({s}) + max_new_tokens ({max_new_tokens}) > max_len ({max_len})")
    if temperature > 0 and key is None:
        raise ValueError("sampling (temperature > 0) needs a PRNG key")
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
    tok = select_token(logits[:, -1], temperature, key, 0, top_k=top_k, top_p=top_p)
    out = [tok]
    for i in range(1, max_new_tokens):
        logits, cache = apply_cached(params, tok[:, None], config, cache)
        tok = select_token(logits[:, -1], temperature, key, i, top_k=top_k, top_p=top_p)
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


@torch.no_grad()
def speculative_generate_loop(apply_cached: Callable, init_cache: Callable, params, config,
                              draft_apply_cached: Callable, draft_init_cache: Callable,
                              draft_params, draft_config, input_ids: torch.Tensor,
                              max_new_tokens: int, num_draft_tokens: int = 4,
                              max_len: Optional[int] = None, return_stats: bool = False,
                              temperature: float = 0.0, key=None):
    """Speculative decoding: the draft proposes ``γ = num_draft_tokens``
    tokens one cached step at a time, the target verifies all of them (plus a
    bonus position) in one cached forward, and the longest accepted prefix
    lands, ``1..γ+1`` tokens per target forward.

    ``temperature <= 0``: greedy, token-identical to greedy decoding with
    the target alone.  ``temperature > 0`` (needs ``key``): the rejection
    scheme, each token distributed as target-only sampling; keys
    ``fold_in(0)`` for the first token, and per round ``rkey =
    fold_in(1 + rounds)`` with draft ``j`` at ``rkey.fold_in(j)``, the
    uniforms at ``rkey.fold_in(γ)`` and the fill at ``rkey.fold_in(γ+1)``,
    as in the JAX package.

    Both caches keep "``index`` counts the tokens before ``last``, the
    newest emitted token".  A round writes ``γ+1`` rows into each, in
    place, then lowers ``index`` to the accepted length; the next round's
    writes cover the stale rows before any query reads them (the accept
    count is ≥ 1) and the causal mask hides rows past a query's position.
    The accept count comes to the host once per round.  Batch 1 only.
    ``return_stats=True`` also returns ``{"rounds", "proposed",
    "accepted"}``."""
    b, s = input_ids.shape
    if b != 1:
        raise ValueError(
            f"speculative decoding is batch-1 only (got batch {b}): rows with "
            "different accept counts would need per-row cache indices"
        )
    sampled = temperature > 0.0
    if sampled and key is None:
        raise ValueError("sampled speculative decoding (temperature > 0) needs a PRNG key")
    gamma = int(num_draft_tokens)
    if gamma < 1:
        raise ValueError(f"num_draft_tokens must be >= 1, got {num_draft_tokens}")
    tv = getattr(config, "vocab_size", None)
    dv = getattr(draft_config, "vocab_size", None)
    if tv != dv:
        raise ValueError(f"target and draft vocab sizes differ: {tv} vs {dv}")
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if max_new_tokens == 0:
        return input_ids
    # The last round can start at generated-count max_new-1 and still write
    # γ+1 rows: the caches need that much room past the final token.
    need = s + max_new_tokens + gamma
    if max_len is None:
        max_len = need
    elif max_len < need:
        raise ValueError(
            f"max_len ({max_len}) < prompt + max_new_tokens + num_draft_tokens "
            f"({need}): the verify writes need overshoot room"
        )
    dev = input_ids.device
    t_cache = init_cache(config, b, max_len, device=dev)
    d_cache = draft_init_cache(draft_config, b, max_len, device=dev)
    t_logits, t_cache = apply_cached(params, input_ids, config, t_cache)
    _, d_cache = draft_apply_cached(draft_params, input_ids, draft_config, d_cache)
    if sampled:
        # fp32 before the divide: the proposal distribution and the p/q of
        # the acceptance test come from identical logits (bf16 models).
        first = _categorical(key.fold_in(0), t_logits[:, -1].float() / temperature)
    else:
        first = t_logits[:, -1].argmax(-1)
    chunks = [first.to(torch.int32)[:, None]]
    last = chunks[0][:, 0]
    n = 1
    rounds = accepted = 0
    window = torch.arange(gamma + 1, device=dev)[None, :]
    while n < max_new_tokens:
        rkey = key.fold_in(1 + rounds) if sampled else None
        tok, d_toks, d_logits = last, [], []
        for j in range(gamma):
            dl, d_cache = draft_apply_cached(draft_params, tok[:, None], draft_config, d_cache)
            logits = dl[:, -1].float()  # fp32: q is the distribution sampled
            if sampled:
                tok = _categorical(rkey.fold_in(j), logits / temperature).to(torch.int32)
            else:
                tok = logits.argmax(-1).to(torch.int32)
            d_toks.append(tok)
            d_logits.append(logits)
        # One more feed keeps the draft cache covering d_γ for a full accept.
        _, d_cache = draft_apply_cached(draft_params, tok[:, None], draft_config, d_cache)
        d = torch.stack(d_toks, 1)  # [B, γ]
        # The target verifies [last, d_1..d_γ] in one forward: row j is its
        # distribution after seq[:, j].
        seq = torch.cat([last[:, None], d], 1)
        t_logits, t_cache = apply_cached(params, seq, config, t_cache)
        if sampled:
            p = torch.softmax(t_logits.float() / temperature, -1)  # [B, γ+1, V]
            q = torch.softmax(torch.stack(d_logits, 1) / temperature, -1)  # [B, γ, V]
            p_head = p[:, :gamma]
            d_idx = d.long()[..., None]
            p_at_d = torch.gather(p_head, -1, d_idx)[..., 0]
            q_at_d = torch.gather(q, -1, d_idx)[..., 0]
            u = rkey.fold_in(gamma).uniform((b, gamma), dev)
            accept = (u * torch.clamp_min(q_at_d, 1e-30) < p_at_d).to(torch.int32)
            m = int(torch.cumprod(accept, 1).sum(1)[0])
            # The replacement at the stop position: the residual
            # normalize(max(p - q, 0)) on a rejection, p itself on a full
            # accept (the bonus token); a ~zero residual falls back to p.
            resid = torch.clamp_min(p_head - q, 0.0)
            mass = resid.sum(-1, keepdim=True)
            resid = torch.where(mass > 1e-9, resid, p_head)
            dist_m = torch.cat([resid, p[:, gamma:]], 1)[:, m]
            # 1e-38 is an fp32 subnormal: neither the CPU nor CUDA kernels
            # flush it, so a zero-probability token gets log ≈ -87.5, not -inf.
            fill = _categorical(rkey.fold_in(gamma + 1), torch.log(dist_m + 1e-38))
            fill_col = fill.to(torch.int32)[:, None].expand(b, gamma + 1)
        else:
            t, m_rows = speculative_verify_greedy(t_logits, d)
            m = int(m_rows[0])
            fill_col = t
        count = m + 1
        d_pad = torch.cat([d, torch.zeros((b, 1), dtype=torch.int32, device=dev)], 1)
        chunk = torch.where(window < m, d_pad, fill_col)
        chunks.append(chunk[:, :count])
        last = chunk[:, m]
        t_cache = dict(t_cache, index=t_cache["index"] - (gamma + 1) + count)
        d_cache = dict(d_cache, index=d_cache["index"] - (gamma + 1) + count)
        n += count
        rounds += 1
        accepted += m
    gen = torch.cat(chunks, 1)[:, :max_new_tokens].to(input_ids.dtype)
    out = torch.cat([input_ids, gen], 1)
    if return_stats:
        return out, {"rounds": rounds, "proposed": rounds * gamma, "accepted": accepted}
    return out


def _tile_beams(cache: dict, rows: int, fn) -> dict:
    """Apply ``fn`` to every cache tensor that carries the batch on axis 1
    (``shape[1] == rows``): k/v and the int8 scales; the Python ``index``
    and any other leaf pass through."""
    return {
        name: fn(leaf) if torch.is_tensor(leaf) and leaf.dim() >= 2 and leaf.shape[1] == rows
        else leaf
        for name, leaf in cache.items()
    }


@torch.no_grad()
def beam_search(apply_cached: Callable, init_cache: Callable, params, input_ids: torch.Tensor,
                config, max_new_tokens: int, num_beams: int = 4, length_penalty: float = 1.0,
                eos_token_id: Optional[int] = None,
                max_len: Optional[int] = None) -> torch.Tensor:
    """Beam search over the shared KV cache: dense prompt ``[B, S]`` ->
    the best sequence ``[B, S + max_new_tokens]``.

    The prompt is prefilled once at batch B and the cache rows are tiled per
    beam (``repeat_interleave`` on axis 1, the JAX ``jnp.repeat``).  Each
    step scores ``num_beams * vocab`` continuations, keeps the top
    ``num_beams`` (ties to the lower index, as ``jax.lax.top_k``) and
    reorders the cache rows to follow their beams.  A beam that emits
    ``eos_token_id`` freezes: its score stops accumulating and it pads with
    EOS.  The final ranking divides by ``length ** length_penalty``.

    Cache contract: every cache tensor with ``ndim >= 2`` carries the batch
    on axis 1 (the ``make_kv_cache`` layout, int8 scales included)."""
    if max_new_tokens < 1:
        raise ValueError("beam search needs max_new_tokens >= 1")
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    b, s = input_ids.shape
    kb = num_beams
    total = s + max_new_tokens
    if max_len is None:
        max_len = total
    if total > max_len:
        raise ValueError(f"prompt ({s}) + max_new_tokens ({max_new_tokens}) > max_len ({max_len})")
    dev = input_ids.device
    cache = init_cache(config, b, max_len, device=dev)
    logits, cache = apply_cached(params, input_ids, config, cache)
    cache = _tile_beams(cache, b, lambda leaf: leaf.repeat_interleave(kb, dim=1))
    logp = torch.log_softmax(logits[:, -1].float(), -1)  # [B, V]
    vocab = logp.shape[-1]
    if kb > vocab:
        raise ValueError(
            f"num_beams ({kb}) > vocab_size ({vocab}): top_k cannot select "
            "more beams than there are tokens"
        )
    scores, tokens = _top_k(logp, kb)  # [B, K]
    finished = (tokens == eos_token_id if eos_token_id is not None
                else torch.zeros_like(tokens, dtype=torch.bool))
    lengths = torch.ones((b, kb), dtype=torch.int32, device=dev)
    out = torch.zeros((b, kb, max_new_tokens), dtype=torch.int64, device=dev)
    out[:, :, 0] = tokens
    offsets = (torch.arange(b, device=dev) * kb)[:, None]
    if eos_token_id is not None:
        # Frozen beams continue with EOS alone, at no added score.
        frozen = torch.full((vocab,), float("-inf"), device=dev)
        frozen[eos_token_id] = 0.0
    for i in range(1, max_new_tokens):
        logits, cache = apply_cached(params, tokens.reshape(b * kb, 1), config, cache)
        logp = torch.log_softmax(logits[:, -1].float(), -1).reshape(b, kb, vocab)
        if eos_token_id is not None:
            logp = torch.where(finished[:, :, None], frozen, logp)
        cand = (scores[:, :, None] + logp).reshape(b, kb * vocab)
        scores, flat = _top_k(cand, kb)
        beam_idx = flat // vocab  # [B, K] source beam
        tokens = flat % vocab
        rows = (offsets + beam_idx).reshape(-1)
        cache = _tile_beams(cache, b * kb, lambda leaf: leaf.index_select(1, rows))
        out = torch.take_along_dim(out, beam_idx[:, :, None], 1)
        out[:, :, i] = tokens
        prev_finished = torch.take_along_dim(finished, beam_idx, 1)
        lengths = torch.take_along_dim(lengths, beam_idx, 1) + (~prev_finished).to(torch.int32)
        finished = prev_finished
        if eos_token_id is not None:
            finished = finished | (tokens == eos_token_id)
    ranked = scores / lengths.float() ** length_penalty
    best = ranked.argmax(1)  # [B]
    best_out = torch.take_along_dim(out, best[:, None, None], 1)[:, 0]
    return torch.cat([input_ids, best_out.to(input_ids.dtype)], 1)
