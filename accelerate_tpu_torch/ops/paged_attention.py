"""Paged decode attention: block-table K/V straight out of the serving pool.

Two functions with the public layouts of the JAX package's
``pallas_paged_attention`` / ``pallas_paged_window_attention``:

- :func:`paged_attention` — one query token per slot (the decode dispatch);
- :func:`paged_window_attention` — a W-token verify window per slot (the
  speculative decode dispatch).  W = 1 equals :func:`paged_attention`.

On a CUDA tensor each launches its hand-written Hopper kernels
(``csrc/paged_attention_sm90.cu``: a split kernel that streams C pool
positions of one slot and kv head per CTA and writes fp32 partials, then a
merge kernel) or raises; on a CPU tensor it runs the plain PyTorch version
beside it (:func:`paged_attention_plain`, :func:`paged_window_attention_plain`).
Each wrapper counts its calls that launch in ``<wrapper>.launches`` (one per
call, though a call launches the split and the merge kernel).

The split path has plain versions of its own: :func:`paged_split_partials_plain`
(the partials of each split, in the kernel's scratch layout) and
:func:`paged_split_merge_plain` (the merge kernel's function);
:func:`paged_split_merge` runs the merge kernel alone on given partials.
C, the pool positions per split, comes from :func:`pick_split_tokens`, which
reads only host-known shapes (never ``lengths``, so the decode step gains no
device sync).

The kernels' online softmax sums in another order than the plain version,
so the two agree to fp32 atol = rtol = 1e-4 and bf16 atol = rtol = 2e-2,
not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

__all__ = [
    "paged_attention",
    "paged_attention_plain",
    "paged_split_merge",
    "paged_split_merge_plain",
    "paged_split_partials_plain",
    "paged_window_attention",
    "paged_window_attention_plain",
    "paged_window_attention_split_plain",
    "pick_split_tokens",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 96, 128, 256)
_LOG2E = 1.4426950408889634
# Split size: the fewest pool positions a split CTA streams, and the most
# split CTAs (every slot counted as full) per SM before splits grow.
SPLIT_MIN_TOKENS = 128
SPLIT_MAX_CTAS_PER_SM = 64
_MAX_SPLIT_BLOCKS = 256  # table entries one split may span (the kernel's cap)
_MAX_WINDOW = 256  # the merge kernel stages the window's k_new rows in shared memory
_MERGE_SMEM = 227 * 1024 - 1024  # what the merge kernel may stage


def _merge_smem(w: int, d: int, itemsize: int) -> int:
    """Shared memory of the merge kernel: 16 query rows and the W k_new rows
    of d elements, this chunk's W v_new values and 16 x W new-row scores
    (fp32).  fp32 at d 256 caps the window below :data:`_MAX_WINDOW`."""
    return (16 + w) * d * itemsize + w * (32 + 16) * 4


def paged_window_attention_plain(q, k_new, v_new, pool_k, pool_v, tables, lengths):
    """Plain version of :func:`paged_window_attention`: gather the table's
    blocks, append the window's new rows, masked fp32 softmax per kv-head
    group.  Pool rows at positions ``>= lengths[b]`` are masked for every
    window query; new row ``kw`` is admitted by window queries ``w >= kw``."""
    b, w, h, d = q.shape
    kh = k_new.shape[2]
    g = h // kh
    bs = pool_k.shape[1]
    m = tables.shape[1]
    p = m * bs
    idx = tables.long()
    keys = torch.cat([pool_k[idx].reshape(b, p, kh, d), k_new], 1).float()
    vals = torch.cat([pool_v[idx].reshape(b, p, kh, d), v_new], 1).float()
    qf = q.float().reshape(b, w, kh, g, d)
    s = torch.einsum("bwkgd,btkd->bkgwt", qf, keys) / math.sqrt(d)
    pool_ok = torch.arange(p, device=q.device)[None] < lengths.long()[:, None]  # [B, P]
    win = torch.arange(w, device=q.device)
    win_ok = win[None, :] <= win[:, None]  # [qw, kw]
    ok = torch.cat([pool_ok[:, None, :].expand(b, w, p), win_ok[None].expand(b, w, w)], -1)
    s = s.masked_fill(~ok[:, None, None], float("-inf"))
    # Rows past the length take no part, as in the kernel, which never reads
    # them: a zero probability times a non-finite stale value would be NaN.
    vals[:, :p].masked_fill_(~pool_ok[:, :, None, None], 0.0)
    out = torch.einsum("bkgwt,btkd->bwkgd", torch.softmax(s, -1), vals)
    return out.reshape(b, w, h, d).to(q.dtype)


def paged_attention_plain(q, k_new, v_new, pool_k, pool_v, tables, lengths):
    """Plain version of :func:`paged_attention` (the W = 1 window)."""
    return paged_window_attention_plain(
        q[:, None], k_new[:, None], v_new[:, None], pool_k, pool_v, tables, lengths
    )[:, 0]


@functools.lru_cache(maxsize=64)
def pick_split_tokens(batch: int, kv_heads: int, table_width: int, block_size: int,
                      sm_count: int) -> int:
    """Pool positions per split: :data:`SPLIT_MIN_TOKENS` rounded up to whole
    blocks, doubled while the split CTAs of ``batch`` full slots would exceed
    :data:`SPLIT_MAX_CTAS_PER_SM` per SM, never past the table.  Host-known
    shapes only: the slots' lengths live on the device and are not read."""
    blocks = max(1, -(-SPLIT_MIN_TOKENS // block_size))
    while (blocks < min(table_width, _MAX_SPLIT_BLOCKS)
           and batch * kv_heads * -(-table_width // blocks) > SPLIT_MAX_CTAS_PER_SM * sm_count):
        blocks *= 2
    return min(blocks, table_width, _MAX_SPLIT_BLOCKS) * block_size


def _rows(q, kv_heads):
    """Window-layout q ``[B, W, H, d]`` as ``[B, K, G*W, d]`` fp32, row
    ``g*W + w`` (the kernels' order)."""
    b, w, h, d = q.shape
    return (q.float().reshape(b, w, kv_heads, h // kv_heads, d).permute(0, 2, 3, 1, 4)
            .reshape(b, kv_heads, h // kv_heads * w, d))


def paged_split_partials_plain(q, pool_k, pool_v, tables, lengths, split_tokens):
    """Plain version of the split kernel, window layout (q ``[B, W, H, hd]``):
    for each split ``s`` of ``split_tokens`` pool positions, the unnormalised
    ``o = sum_p 2^(t_p - m) v_p`` over its positions below ``lengths[b]``,
    with ``t = q.k * scale * log2(e)``, ``m = max t`` and ``l = sum 2^(t - m)``.
    Returns ``part_o [B, K, NS, G*W, hd]`` and ``part_ml [B, K, NS, G*W, 2]``
    (m, l) in fp32; a split with no valid position gets m = -inf, l = 0, o = 0
    (the kernel leaves it unwritten; the merge reads neither)."""
    b, w, h, d = q.shape
    n, bs, kh, _ = pool_k.shape
    p = tables.shape[1] * bs
    c = split_tokens
    ns = -(-p // c)
    idx = tables.long()
    valid = torch.arange(ns * c, device=q.device)[None] < lengths.long().clamp(max=p)[:, None]
    pad = (0, 0, 0, 0, 0, ns * c - p)

    def gather(pool):  # [B, NS*C, K, hd], invalid positions zero (NaN-safe)
        x = torch.nn.functional.pad(pool[idx].reshape(b, p, kh, d).float(), pad)
        return torch.where(valid[:, :, None, None], x, 0.0)

    keys, vals = gather(pool_k), gather(pool_v)
    t = torch.einsum("bkrd,bpkd->bkrp", _rows(q, kh), keys) * (_LOG2E / math.sqrt(d))
    t = t.masked_fill(~valid[:, None, None], float("-inf"))
    t = t.reshape(b, kh, -1, ns, c).transpose(2, 3)  # [B, K, NS, R, C]
    m = t.amax(-1)
    pr = torch.exp2(t - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    o = torch.einsum("bksrc,bsckd->bksrd", pr, vals.reshape(b, ns, c, kh, d))
    return o, torch.stack([m, pr.sum(-1)], -1)


def paged_split_merge_plain(q, k_new, v_new, part_o, part_ml, lengths, split_tokens,
                            block_size, table_width):
    """Plain version of the merge kernel, window layout: the splits below
    ``ceil(min(lengths[b], table_width * block_size) / split_tokens)`` merged with the
    lse rule, the W new rows folded in under ``kw <= qw``, divided by
    ``max(l, 1e-30)``.  Splits at or past that count are not read (their
    scratch may hold anything).  Returns ``[B, W, H, hd]`` in q's dtype."""
    b, w, h, d = q.shape
    kh = k_new.shape[2]
    ns = part_o.shape[2]
    n_used = -(-lengths.long().clamp(max=table_width * block_size) // split_tokens)
    used = (torch.arange(ns, device=q.device)[None] < n_used[:, None])[:, None, :, None]
    m_s = torch.where(used, part_ml[..., 0], float("-inf"))  # [B, K, NS, R]
    l_s = torch.where(used, part_ml[..., 1], 0.0)
    o_s = torch.where(used[..., None], part_o, 0.0)
    t_new = torch.einsum("bkrd,bjkd->bkrj", _rows(q, kh), k_new.float())
    t_new = t_new * (_LOG2E / math.sqrt(d))
    row_w = torch.arange(t_new.shape[2], device=q.device) % w
    t_new = t_new.masked_fill(torch.arange(w, device=q.device)[None] > row_w[:, None],
                              float("-inf"))
    m = torch.maximum(m_s.amax(2), t_new.amax(-1))  # [B, K, R]: new row 0 always counts
    f = torch.exp2(m_s - m[:, :, None])
    p_new = torch.exp2(t_new - m[..., None])
    l = (f * l_s).sum(2) + p_new.sum(-1)
    o = (torch.einsum("bksr,bksrd->bkrd", f, o_s)
         + torch.einsum("bkrj,bjkd->bkrd", p_new, v_new.float()))
    out = o / l.clamp(min=1e-30)[..., None]
    return out.reshape(b, kh, h // kh, w, d).permute(0, 3, 1, 2, 4).reshape(b, w, h, d).to(q.dtype)


def paged_window_attention_split_plain(q, k_new, v_new, pool_k, pool_v, tables, lengths,
                                       split_tokens):
    """The split path in plain PyTorch: :func:`paged_split_partials_plain`
    then :func:`paged_split_merge_plain` (equal to
    :func:`paged_window_attention_plain` up to summation order)."""
    part_o, part_ml = paged_split_partials_plain(q, pool_k, pool_v, tables, lengths,
                                                 split_tokens)
    return paged_split_merge_plain(q, k_new, v_new, part_o, part_ml, lengths, split_tokens,
                                   pool_k.shape[1], tables.shape[1])


_NAMES = ("q", "k_new", "v_new", "pool_k", "pool_v", "tables", "lengths")


def _check(q, k_new, v_new, pool_k, pool_v, tables, lengths, window: bool) -> None:
    """Raise on what the kernels do not take.  It runs on every decode
    layer of a host-bound serving step, so it reads each attribute once."""
    tensors = (q, k_new, v_new, pool_k, pool_v, tables, lengths)
    dev = q.get_device()
    dtype = q.dtype
    for name, t in zip(_NAMES, tensors):
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {dtype} not supported (float32, bfloat16, float16)")
    for name, t in zip(_NAMES[1:5], tensors[1:5]):
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel needs q's {dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    lead = 2 if window else 1
    qs, ks, ps = q.shape, k_new.shape, pool_k.shape
    if len(qs) != lead + 2 or len(ks) != lead + 2 or v_new.shape != ks:
        raise ValueError(f"bad q/k_new/v_new shapes {tuple(qs)}, {tuple(ks)}, "
                         f"{tuple(v_new.shape)}")
    b, h, d = qs[0], qs[-2], qs[-1]
    kh = ks[-2]
    if ks[:lead] != qs[:lead] or ks[-1] != d:
        raise ValueError(f"k_new {tuple(ks)} does not match q {tuple(qs)}")
    if h % kh:
        raise ValueError(f"num q heads {h} not divisible by kv heads {kh}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the kernel (one of {_HEAD_DIMS})")
    if window and (qs[1] > _MAX_WINDOW
                   or _merge_smem(qs[1], d, q.element_size()) > _MERGE_SMEM):
        raise ValueError(f"window {qs[1]} too long for the kernel at head_dim {d} in {dtype} "
                         f"(at most {_MAX_WINDOW}, and the merge kernel's shared memory)")
    if len(ps) != 4 or ps != pool_v.shape or ps[2] != kh or ps[3] != d:
        raise ValueError(f"pool shape {tuple(ps)} is not [N, bs, {kh}, {d}]")
    ts = tables.shape
    if len(ts) != 2 or ts[0] != b or lengths.shape != (b,):
        raise ValueError(f"tables {tuple(ts)} / lengths {tuple(lengths.shape)} "
                         f"do not match batch {b}")
    for name, t in zip(_NAMES[:5], tensors[:5]):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for vector loads")


_LIB = {}
_SM_COUNT = {}
_SYMBOLS = {  # symbol: number of int arguments after the pointers
    "atpu_paged_attention_sm90": 7,
    "atpu_paged_window_attention_sm90": 8,
    "atpu_paged_split_merge": 8,
}


def _kernel(symbol: str):
    """The C launcher ``symbol`` of ``paged_attention_sm90.cu`` with its
    argument types declared (pointers and the stream as ``c_void_p``, so
    they are not cut to 32 bits)."""
    fn = _LIB.get(symbol)
    if fn is None:
        from . import _build

        fn = getattr(_build.load("paged_attention_sm90"), symbol)
        n_ptr = 7 if symbol == "atpu_paged_split_merge" else 10
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * _SYMBOLS[symbol] + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB[symbol] = fn
    return fn


def _sm_count(device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNT[index]


def _check_device(q):
    if q.device.index is not None and q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, the current CUDA device is "
                         f"{torch.cuda.current_device()}")


def _check_split(split_tokens, block_size):
    if split_tokens <= 0 or split_tokens % block_size or split_tokens // block_size > \
            _MAX_SPLIT_BLOCKS:
        raise ValueError(f"split_tokens {split_tokens} must be a positive multiple of the block "
                         f"size {block_size}, at most {_MAX_SPLIT_BLOCKS} blocks")


def _launch(q, k_new, v_new, pool_k, pool_v, tables, lengths, window, split_tokens=None):
    """Split and merge kernels for window-layout (``window``) or decode
    tensors; ``split_tokens`` overrides :func:`pick_split_tokens`."""
    _check_device(q)
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    w = q.shape[1] if window else 1
    bs, kh = pool_k.shape[1], pool_k.shape[2]
    m = tables.shape[1]
    c = split_tokens or pick_split_tokens(b, kh, m, bs, _sm_count(q.device))
    _check_split(c, bs)
    ns = -(-m * bs // c)
    rows = h // kh * w
    # One allocation for both partials (o, then m and l).
    scratch = torch.empty(b * kh * ns * rows * (d + 2), dtype=torch.float32, device=q.device)
    part_ml = scratch[b * kh * ns * rows * d:]
    out = torch.empty_like(q)
    symbol = "atpu_paged_window_attention_sm90" if window else "atpu_paged_attention_sm90"
    rc = _kernel(symbol)(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        pool_k.data_ptr(), pool_v.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), part_ml.data_ptr(), b, h, kh, d, bs, m,
        *((w,) if window else ()), c, torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")
    return out


def paged_attention(q, k_new, v_new, pool_k, pool_v, tables, lengths):
    """Single-token paged decode attention through block tables.

    q ``[B, H, hd]`` (one query per slot), k_new/v_new ``[B, K, hd]`` (the
    slot's new K/V row, in the pool dtype), pool_k/v ``[N, bs, K, hd]`` (one
    layer of the pool), tables ``[B, M]`` int32, lengths ``[B]`` int32 (valid
    pool rows per slot; the new row sits at position ``lengths[b]``).
    Returns ``[B, H, hd]`` in q's dtype.  Query head ``h`` reads kv head
    ``h // (H // K)``."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_new, v_new, pool_k, pool_v, tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, got {q.device}")
    _check(q, k_new, v_new, pool_k, pool_v, tables, lengths, window=False)
    out = _launch(q, k_new, v_new, pool_k, pool_v, tables, lengths, window=False)
    paged_attention.launches += 1
    return out


def paged_window_attention(q, k_new, v_new, pool_k, pool_v, tables, lengths):
    """W-token verify-window paged attention (speculative decode).

    q ``[B, W, H, hd]`` (window position 0 at pool position ``lengths[b]``),
    k_new/v_new ``[B, W, K, hd]`` (the window's new rows, pool dtype),
    pool/tables/lengths as :func:`paged_attention`.  Window query ``w``
    attends pool rows ``< lengths[b]`` and new rows ``0..w``.  Returns
    ``[B, W, H, hd]`` in q's dtype.  On the card W is at most 256."""
    if q.device.type == "cpu":
        return paged_window_attention_plain(q, k_new, v_new, pool_k, pool_v, tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_window_attention runs on cuda or cpu tensors, got {q.device}")
    _check(q, k_new, v_new, pool_k, pool_v, tables, lengths, window=True)
    out = _launch(q, k_new, v_new, pool_k, pool_v, tables, lengths, window=True)
    paged_window_attention.launches += 1
    return out


def paged_split_merge(q, k_new, v_new, part_o, part_ml, lengths, split_tokens, block_size,
                      table_width):
    """The merge kernel alone (window layout) on the partials given, as
    :func:`paged_split_merge_plain`.  On a CPU tensor it runs that plain
    version."""
    if q.device.type == "cpu":
        return paged_split_merge_plain(q, k_new, v_new, part_o, part_ml, lengths, split_tokens,
                                       block_size, table_width)
    if q.device.type != "cuda":
        raise ValueError(f"paged_split_merge runs on cuda or cpu tensors, got {q.device}")
    _check_device(q)
    b, w, h, d = q.shape
    kh = k_new.shape[2]
    _check_split(split_tokens, block_size)
    ns = -(-table_width * block_size // split_tokens)
    want = (b, kh, ns, h // kh * w)
    if tuple(part_o.shape) != want + (d,) or tuple(part_ml.shape) != want + (2,):
        raise ValueError(f"partials {tuple(part_o.shape)}, {tuple(part_ml.shape)} do not match "
                         f"{want}")
    for t in (q, k_new, v_new, part_o, part_ml, lengths):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("every tensor must be contiguous, 16-byte aligned and on q's device")
    if part_o.dtype != torch.float32 or part_ml.dtype != torch.float32 or \
            lengths.dtype != torch.int32 or k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError("partials must be float32, lengths int32, k_new/v_new in q's dtype")
    if q.dtype not in _DTYPE_CODES or d not in _HEAD_DIMS or \
            _merge_smem(w, d, q.element_size()) > _MERGE_SMEM:
        raise ValueError(f"head_dim {d} at window {w} in {q.dtype} not supported by the kernel")
    out = torch.empty_like(q)
    rc = _kernel("atpu_paged_split_merge")(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        lengths.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(), b, h, kh, d,
        block_size, table_width, w, split_tokens,
        torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"atpu_paged_split_merge launch failed: CUDA error {rc}")
    paged_split_merge.launches += 1
    return out


paged_attention.launches = 0
paged_window_attention.launches = 0
paged_split_merge.launches = 0
