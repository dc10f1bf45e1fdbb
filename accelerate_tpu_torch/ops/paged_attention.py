"""Paged decode attention: block-table K/V straight out of the serving pool.

Two functions with the public layouts of the JAX package's
``pallas_paged_attention`` / ``pallas_paged_window_attention``:

- :func:`paged_attention` — one query token per slot (the decode dispatch);
- :func:`paged_window_attention` — a W-token verify window per slot (the
  speculative decode dispatch).  W = 1 equals :func:`paged_attention`.

On a CUDA tensor each launches its hand-written Hopper kernel
(``csrc/paged_attention.cu``) or raises; on a CPU tensor it runs the plain
PyTorch version beside it (:func:`paged_attention_plain`,
:func:`paged_window_attention_plain`).  Each wrapper counts its kernel
launches in ``<wrapper>.launches``.

The kernel's online softmax sums in another order than the plain version,
so the two agree to fp32 atol = rtol = 1e-4 and bf16 atol = rtol = 2e-2,
not bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = [
    "paged_attention",
    "paged_attention_plain",
    "paged_window_attention",
    "paged_window_attention_plain",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128, 256)


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


def _check(q, k_new, v_new, pool_k, pool_v, tables, lengths, window: bool) -> None:
    tensors = {"q": q, "k_new": k_new, "v_new": v_new, "pool_k": pool_k,
               "pool_v": pool_v, "tables": tables, "lengths": lengths}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16, float16)")
    for name in ("k_new", "v_new", "pool_k", "pool_v"):
        if tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} is {tensors[name].dtype}; the kernel needs q's {q.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    lead = 2 if window else 1
    if q.dim() != lead + 2 or k_new.dim() != lead + 2 or v_new.shape != k_new.shape:
        raise ValueError(f"bad q/k_new/v_new shapes {tuple(q.shape)}, {tuple(k_new.shape)}, "
                         f"{tuple(v_new.shape)}")
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    kh = k_new.shape[-2]
    if k_new.shape[:lead] != q.shape[:lead] or k_new.shape[-1] != d:
        raise ValueError(f"k_new {tuple(k_new.shape)} does not match q {tuple(q.shape)}")
    if h % kh:
        raise ValueError(f"num q heads {h} not divisible by kv heads {kh}")
    if d not in _HEAD_DIMS or (d == 256 and q.dtype == torch.float32):
        raise ValueError(f"head_dim {d} in {q.dtype} not supported by the kernel "
                         f"(one of {_HEAD_DIMS}; 256 only in 16-bit types)")
    if pool_k.dim() != 4 or pool_k.shape != pool_v.shape or pool_k.shape[2:] != (kh, d):
        raise ValueError(f"pool shape {tuple(pool_k.shape)} is not [N, bs, {kh}, {d}]")
    if tables.dim() != 2 or tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths {tuple(lengths.shape)} "
                         f"do not match batch {b}")
    for name in ("k_new", "v_new", "pool_k", "pool_v"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for vector loads")


_LIB = {}


def _kernel(symbol: str):
    """The C launcher ``symbol`` with its argument types declared (pointers
    and the stream as ``c_void_p``, so they are not cut to 32 bits)."""
    fn = _LIB.get(symbol)
    if fn is None:
        from . import _build

        fn = getattr(_build.load("paged_attention"), symbol)
        n_int = 7 if symbol == "atpu_paged_window_attention" else 6
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB[symbol] = fn
    return fn


def _launch(symbol: str, q, k_new, v_new, pool_k, pool_v, tables, lengths, *window):
    if q.device.index is not None and q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    out = torch.empty_like(q)
    rc = _kernel(symbol)(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        pool_k.data_ptr(), pool_v.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), q.shape[0], q.shape[-2], pool_k.shape[2], q.shape[-1], pool_k.shape[1],
        tables.shape[1], *window, torch.cuda.current_stream().cuda_stream,
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
    out = _launch("atpu_paged_attention", q, k_new, v_new, pool_k, pool_v, tables, lengths)
    paged_attention.launches += 1
    return out


def paged_window_attention(q, k_new, v_new, pool_k, pool_v, tables, lengths):
    """W-token verify-window paged attention (speculative decode).

    q ``[B, W, H, hd]`` (window position 0 at pool position ``lengths[b]``),
    k_new/v_new ``[B, W, K, hd]`` (the window's new rows, pool dtype),
    pool/tables/lengths as :func:`paged_attention`.  Window query ``w``
    attends pool rows ``< lengths[b]`` and new rows ``0..w``.  Returns
    ``[B, W, H, hd]`` in q's dtype."""
    if q.device.type == "cpu":
        return paged_window_attention_plain(q, k_new, v_new, pool_k, pool_v, tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_window_attention runs on cuda or cpu tensors, got {q.device}")
    _check(q, k_new, v_new, pool_k, pool_v, tables, lengths, window=True)
    out = _launch("atpu_paged_window_attention", q, k_new, v_new, pool_k, pool_v, tables,
                  lengths, q.shape[1])
    paged_window_attention.launches += 1
    return out


paged_attention.launches = 0
paged_window_attention.launches = 0
