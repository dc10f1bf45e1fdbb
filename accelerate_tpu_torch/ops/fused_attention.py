"""Fused flash attention for training: forward and backward kernels.

The counterpart of the JAX package's ``pallas_attention`` with the same
contract: :func:`fused_attention` takes q ``[B, S, H, d]`` and k/v
``[B, S, K, d]`` (``H = K * groups``, query head ``h`` reads kv head
``h // groups``), causal or full, with an optional key-validity mask
``kv_valid [B, S]``; a query row with no admitted key outputs zeros.  It is
differentiable through a ``torch.autograd.Function`` that saves ``(q, k, v,
kv_valid, out, lse)`` and computes δ = rowsum(dO∘O) with a plain torch op
before the two backward kernels.

Three kernels, each behind a wrapper that counts its launches in
``<wrapper>.launches``, at head dims 64, 96, 128 and 256 (any other
raises):

- :func:`fused_attention_fwd` -> ``(out, lse)``: bf16 and fp16 run the
  Hopper forward of ``csrc/flash_fwd_sm90.cu`` (wgmma, TMA-fed K/V ring, P
  in registers; 64-key tiles at 256);
- :func:`fused_attention_bwd_dq` -> ``dq``: bf16 and fp16 run the Hopper
  kernel of ``csrc/flash_bwd_dq_sm90.cu`` (wgmma, TMA-fed K/V ring, dS in
  registers; 32-key tiles at 256);
- :func:`fused_attention_bwd_dkv` -> ``(dk, dv)``, already summed over each
  kv head's query heads: bf16 and fp16 at 64, 96 and 128 run the Hopper
  kernel of ``csrc/flash_bwd_dkv_sm90.cu`` (wgmma, TMA-fed Q/dO ring, P^T
  and dS^T in registers), and at 256 its d-256 kernel (64-key CTAs whose
  two warpgroups split the columns; a kv head's query heads split over
  :func:`pick_dkv_split` CTAs whose fp32 partials a second kernel adds in
  split order).

At head dim 96 each Hopper kernel stores a tile as a 64-column block beside
a 32-column one.  fp32 runs the mma.sync body of ``csrc/flash_attention.cu``
at every head dim.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs the plain PyTorch version (:func:`fused_attention_fwd_plain`,
:func:`fused_attention_bwd_plain`), which follows the TPU kernels operation
for operation: finite ``-1e30`` masking, probabilities gated on the masked
score (``s > -0.5e30``), ``l`` floored at ``1e-30``, P cast to v's dtype
before P·V, dP in fp32, dS cast to k's (q's) dtype before dS·K (dS^T·Q), and
dV = P^T·dO in fp32.  ``block_size`` keeps the JAX contract (S must be
divisible by it) and sets the plain version's key blocks; the kernels tile
on their own.

The kernels sum in another order than the plain versions, so the two agree
to fp32 atol = rtol = 1e-4 and to 2e-2 in bf16/fp16, not bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .paged_attention import _sm_count

__all__ = [
    "fused_attention",
    "fused_attention_fwd",
    "fused_attention_bwd",
    "fused_attention_bwd_dq",
    "fused_attention_bwd_dkv",
    "fused_attention_fwd_plain",
    "fused_attention_bwd_plain",
    "dkv_split_partials_plain",
    "dkv_split_sum_plain",
    "pick_dkv_split",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 96, 128, 256)  # every kernel body takes all four
_DKV_SPLIT_KEYS = 64  # keys per CTA of the d-256 dK/dV kernel
_NEG = -1e30  # finite: no inf - inf in the exp bookkeeping
_LIVE = -0.5e30  # scores above this are admitted


def _block(s: int, block_size: int) -> int:
    blk = min(block_size, s)
    if s % blk:
        raise ValueError(f"seq len {s} must be divisible by block_size {blk}")
    return blk


def _admitted(s: int, k0: int, blk: int, causal: bool, valid, device):
    """Boolean ``[B or 1, 1, 1, S, blk]`` mask of the (query, key) pairs of
    key block ``k0 .. k0+blk-1`` that take part."""
    ok = torch.ones(1, 1, 1, s, blk, dtype=torch.bool, device=device)
    if causal:
        q_pos = torch.arange(s, device=device)[:, None]
        k_pos = k0 + torch.arange(blk, device=device)[None, :]
        ok = ok & (q_pos >= k_pos)
    if valid is not None:
        ok = ok & valid[:, k0:k0 + blk].bool()[:, None, None, None, :]
    return ok


def _heads(x: torch.Tensor, kh: int) -> torch.Tensor:
    """``[B, S, H, d]`` -> fp32 ``[B, K, G, S, d]``."""
    b, s, h, d = x.shape
    return x.float().reshape(b, s, kh, h // kh, d).permute(0, 2, 3, 1, 4)


def fused_attention_fwd_plain(q, k, v, kv_valid=None, *, causal: bool = True,
                              block_size: int = 512):
    """Plain version of :func:`fused_attention_fwd`: the online softmax of
    ``_flash_fwd`` over key blocks of ``block_size``.  Returns ``(out [B, S,
    H, d]`` in q's dtype, ``lse [B, H, S]`` fp32)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    blk = _block(s, block_size)
    scale = 1.0 / math.sqrt(d)
    qf = _heads(q, kh)  # [B, K, G, S, d]
    m = torch.full((b, kh, h // kh, s, 1), _NEG, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, s, blk):
        kt = k[:, k0:k0 + blk].float().permute(0, 2, 1, 3)  # [B, K, blk, d]
        vt = v[:, k0:k0 + blk].permute(0, 2, 1, 3)
        sc = torch.einsum("bkgsd,bktd->bkgst", qf, kt) * scale
        sc = torch.where(_admitted(s, k0, blk, causal, kv_valid, q.device), sc, _NEG)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.where(sc > _LIVE, torch.exp(sc - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("bkgst,bktd->bkgsd", p.to(v.dtype).float(), vt.float())
        acc = acc * alpha + pv
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l).permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b, h, s)
    return out, lse


def _delta(out, do):
    """δ = rowsum(dO∘O) in fp32, ``[B, H, S]``."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_plain(q, k, v, lse, delta, do, kv_valid, causal, block_size):
    dq, dk, dv = _bwd_plain_f32(q, k, v, lse, delta, do, kv_valid, causal, block_size)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_plain_f32(q, k, v, lse, delta, do, kv_valid, causal, block_size):
    """:func:`_bwd_plain` before the casts: fp32 dQ, dK and dV."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    blk = _block(s, block_size)
    scale = 1.0 / math.sqrt(d)
    qf, dof = _heads(q, kh), _heads(do, kh)  # dO is upcast, as in the TPU kernels
    lse = lse.reshape(b, kh, g, s, 1)
    delta = delta.reshape(b, kh, g, s, 1)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for k0 in range(0, s, blk):
        kt = k[:, k0:k0 + blk].float().permute(0, 2, 1, 3)  # [B, K, blk, d]
        vt = v[:, k0:k0 + blk].float().permute(0, 2, 1, 3)
        sc = torch.einsum("bkgsd,bktd->bkgst", qf, kt) * scale
        sc = torch.where(_admitted(s, k0, blk, causal, kv_valid, q.device), sc, _NEG)
        p = torch.where(sc > _LIVE, torch.exp(sc - lse), 0.0)
        dp = torch.einsum("bkgsd,bktd->bkgst", dof, vt)
        ds = p * (dp - delta) * scale
        dq = dq + torch.einsum("bkgst,bktd->bkgsd", ds.to(k.dtype).float(), kt)
        dvs.append(torch.einsum("bkgst,bkgsd->btkd", p, dof))
        dks.append(torch.einsum("bkgst,bkgsd->btkd", ds.to(q.dtype).float(), qf))
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    return dq, torch.cat(dks, 1), torch.cat(dvs, 1)


def fused_attention_bwd_plain(q, k, v, out, lse, do, kv_valid=None, *, causal: bool = True,
                              block_size: int = 512):
    """Plain version of :func:`fused_attention_bwd`: ``_flash_bwd``'s two
    kernels' arithmetic over key blocks of ``block_size``, dK/dV summed over
    each kv head's query heads.  Returns ``(dq, dk, dv)`` in the input
    dtypes."""
    return _bwd_plain(q, k, v, lse, _delta(out, do), do, kv_valid, causal, block_size)


def pick_dkv_split(batch: int, kv_heads: int, seq_len: int, groups: int, sm_count: int) -> int:
    """CTAs over which the d-256 dK/dV kernel splits each kv head's
    ``groups`` query heads: the least divisor of ``groups`` that gives at
    least one CTA per SM (``batch x kv_heads x ceil(seq_len / 64)`` key tiles
    times the split), else ``groups``.  Host-known shapes only."""
    tiles = batch * kv_heads * -(-seq_len // _DKV_SPLIT_KEYS)
    for n in range(1, groups + 1):
        if groups % n == 0 and tiles * n >= sm_count:
            return n
    return groups


def dkv_split_partials_plain(q, k, v, do, lse, delta, kv_valid=None, *, causal: bool = True,
                             n_split: int = 1):
    """Plain version of the split d-256 dK/dV kernel: fp32 partials ``[n_split,
    B, S, K, d]`` of dK and of dV, split ``i`` summing the query heads ``i *
    G / n_split .. (i + 1) * G / n_split - 1`` of each kv head."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    if g % n_split:
        raise ValueError(f"n_split {n_split} does not divide the {g} query heads of a kv head")
    gs = g // n_split
    dks, dvs = [], []
    for i in range(n_split):
        heads = torch.tensor([j * g + i * gs + r for j in range(kh) for r in range(gs)],
                             device=q.device)
        _, dk, dv = _bwd_plain_f32(q[:, :, heads], k, v, lse[:, heads], delta[:, heads],
                                   do[:, :, heads], kv_valid, causal, s)
        dks.append(dk)
        dvs.append(dv)
    return torch.stack(dks), torch.stack(dvs)


def dkv_split_sum_plain(part_dk, part_dv, dtype):
    """Plain version of the sum kernel: the partials added in split order
    (0, 1, ..) in fp32, then cast to ``dtype``."""
    dk, dv = part_dk[0], part_dv[0]
    for i in range(1, part_dk.shape[0]):
        dk, dv = dk + part_dk[i], dv + part_dv[i]
    return dk.to(dtype), dv.to(dtype)


def _check(q, k, v, kv_valid, extra=()) -> None:
    tensors = {"q": q, "k": k, "v": v, **dict(extra)}
    if kv_valid is not None:
        tensors["kv_valid"] = kv_valid
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16, float16)")
    for name in ("k", "v", "do"):
        if name in tensors and tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} is {tensors[name].dtype}; the kernel needs q's {q.dtype}")
    for name in ("lse", "delta"):
        if name in tensors and tensors[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad q/k/v shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    kh = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if h % kh:
        raise ValueError(f"num q heads {h} not divisible by kv heads {kh}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the kernel (one of {_HEAD_DIMS})")
    if b * h > 65535:
        raise ValueError(f"batch x heads {b * h} exceeds the kernel grid (65535)")
    if kv_valid is not None and (kv_valid.dtype != torch.int8 or kv_valid.shape != (b, s)):
        raise ValueError(f"kv_valid must be int8 [{b}, {s}], got {kv_valid.dtype} "
                         f"{tuple(kv_valid.shape)}")
    for name in ("q", "k", "v", "do"):
        if name in tensors and tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for vector loads")
    if q.device.index is not None and q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, the current CUDA device is "
                         f"{torch.cuda.current_device()}")


_LIB = {}
# dtype, q, k, v, valid, out, lse, B, S, H, KH, hd, causal, scale, stream
_FWD_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]
# dtype, q, k, v, do, lse, delta, valid, dq, B, S, H, KH, hd, causal, scale, stream
_DQ_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]
# dtype, q, k, v, do, lse, delta, valid, dk, dv, B, S, H, KH, hd, causal, scale, stream
_DKV_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]
# dtype, q, k, v, do, lse, delta, valid, dk, dv, part, B, S, H, KH, hd, causal, n_split,
# scale, stream
_DKV_SPLIT_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p]
_ARGTYPES = {
    "atpu_flash_fwd": _FWD_ARGTYPES,
    "atpu_flash_fwd_sm90": _FWD_ARGTYPES,
    "atpu_flash_bwd_dq": _DQ_ARGTYPES,
    "atpu_flash_bwd_dq_sm90": _DQ_ARGTYPES,
    # the same kernel with a 2-stage K/V ring: on no path, timed only
    "atpu_flash_bwd_dq_sm90_ring2": _DQ_ARGTYPES,
    "atpu_flash_bwd_dkv": _DKV_ARGTYPES,
    "atpu_flash_bwd_dkv_sm90": _DKV_ARGTYPES,
    # the same kernel without the lo half of P in dV: on no path, timed only
    "atpu_flash_bwd_dkv_sm90_nolo": _DKV_ARGTYPES,
    "atpu_flash_bwd_dkv_sm90_d256": _DKV_SPLIT_ARGTYPES,
}
# The source of each symbol that is not in flash_attention.cu.
_SOURCES = {
    "atpu_flash_fwd_sm90": "flash_fwd_sm90",
    "atpu_flash_bwd_dq_sm90": "flash_bwd_dq_sm90",
    "atpu_flash_bwd_dq_sm90_ring2": "flash_bwd_dq_sm90",
    "atpu_flash_bwd_dkv_sm90": "flash_bwd_dkv_sm90",
    "atpu_flash_bwd_dkv_sm90_nolo": "flash_bwd_dkv_sm90",
    "atpu_flash_bwd_dkv_sm90_d256": "flash_bwd_dkv_sm90",
}


def _kernel(symbol: str):
    """The C launcher ``symbol`` with its argument types declared (pointers
    and the stream as ``c_void_p``, so they are not cut to 32 bits)."""
    fn = _LIB.get(symbol)
    if fn is None:
        from . import _build

        fn = getattr(_build.load(_SOURCES.get(symbol, "flash_attention")), symbol)
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        _LIB[symbol] = fn
    return fn


def _launch(symbol: str, q, k, v, kv_valid, *ptrs, causal: bool, n_split=None):
    b, s, h, d = q.shape
    split = () if n_split is None else (n_split,)
    rc = _kernel(symbol)(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs,
        b, s, h, k.shape[2], d, int(causal), *split, 1.0 / math.sqrt(d),
        torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")


def _symbol(base: str, q) -> str:
    """The launcher of ``base`` for q's dtype and head dim: the body of
    ``flash_attention.cu`` for fp32, else the sm90 kernel (dK/dV's d-256
    kernel at 256)."""
    if q.dtype == torch.float32:
        return base
    d256 = base == "atpu_flash_bwd_dkv" and q.shape[-1] == 256
    return f"{base}_sm90_d256" if d256 else f"{base}_sm90"


def _on_cuda(name: str, q) -> bool:
    """True on a CUDA tensor, False on a CPU one; raises on anything else."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {q.device}")
    return True


def _valid_ptr(kv_valid):
    return None if kv_valid is None else kv_valid.data_ptr()


def fused_attention_fwd(q, k, v, kv_valid=None, *, causal: bool = True, block_size: int = 512):
    """Flash-attention forward: ``(out [B, S, H, d]`` in q's dtype, ``lse
    [B, H, S]`` fp32).  ``kv_valid`` is int8 ``[B, S]`` (nonzero: the key
    takes part) or None.  On CUDA, bf16 and fp16 launch the Hopper kernel
    (``atpu_flash_fwd_sm90``), fp32 the mma.sync body (``atpu_flash_fwd``)."""
    if not _on_cuda("fused_attention_fwd", q):
        return fused_attention_fwd_plain(q, k, v, kv_valid, causal=causal, block_size=block_size)
    _check(q, k, v, kv_valid)
    _block(q.shape[1], block_size)
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    _launch(_symbol("atpu_flash_fwd", q), q, k, v, kv_valid, _valid_ptr(kv_valid),
            out.data_ptr(), lse.data_ptr(), causal=causal)
    fused_attention_fwd.launches += 1
    return out, lse


def fused_attention_bwd_dq(q, k, v, do, lse, delta, kv_valid=None, *, causal: bool = True):
    """dQ ``[B, S, H, d]`` in q's dtype from the saved ``lse`` and δ
    (``delta [B, H, S]`` fp32).  On CUDA, bf16 and fp16 launch the Hopper
    kernel (``atpu_flash_bwd_dq_sm90``), fp32 the mma.sync body
    (``atpu_flash_bwd_dq``)."""
    if not _on_cuda("fused_attention_bwd_dq", q):
        return _bwd_plain(q, k, v, lse, delta, do, kv_valid, causal, q.shape[1])[0]
    _check(q, k, v, kv_valid, {"do": do, "lse": lse, "delta": delta})
    dq = torch.empty_like(q)
    _launch(_symbol("atpu_flash_bwd_dq", q), q, k, v, kv_valid, do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _valid_ptr(kv_valid), dq.data_ptr(),
            causal=causal)
    fused_attention_bwd_dq.launches += 1
    return dq


def fused_attention_bwd_dkv(q, k, v, do, lse, delta, kv_valid=None, *, causal: bool = True):
    """dK, dV ``[B, S, K, d]`` in k's dtype, summed over each kv head's query
    heads.  On CUDA, bf16 and fp16 at head dim 64, 96 and 128 launch the
    Hopper kernel (``atpu_flash_bwd_dkv_sm90``), at 256 its d-256 kernel
    (``atpu_flash_bwd_dkv_sm90_d256``: query heads split over
    :func:`pick_dkv_split` CTAs, fp32 partials in a workspace allocated here,
    summed in split order by a second kernel), fp32 the mma.sync body
    (``atpu_flash_bwd_dkv``)."""
    if not _on_cuda("fused_attention_bwd_dkv", q):
        return _bwd_plain(q, k, v, lse, delta, do, kv_valid, causal, q.shape[1])[1:]
    _check(q, k, v, kv_valid, {"do": do, "lse": lse, "delta": delta})
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    symbol = _symbol("atpu_flash_bwd_dkv", q)
    ptrs = (do.data_ptr(), lse.data_ptr(), delta.data_ptr(), _valid_ptr(kv_valid),
            dk.data_ptr(), dv.data_ptr())
    if symbol.endswith("_d256"):
        b, s, h, _ = q.shape
        kh = k.shape[2]
        n_split = pick_dkv_split(b, kh, s, h // kh, _sm_count(q.device))
        part = (torch.empty(2 * n_split * k.numel(), dtype=torch.float32, device=q.device)
                if n_split > 1 else None)
        _launch(symbol, q, k, v, kv_valid, *ptrs, None if part is None else part.data_ptr(),
                causal=causal, n_split=n_split)
    else:
        _launch(symbol, q, k, v, kv_valid, *ptrs, causal=causal)
    fused_attention_bwd_dkv.launches += 1
    return dk, dv


def fused_attention_bwd(q, k, v, out, lse, do, kv_valid=None, *, causal: bool = True,
                        block_size: int = 512):
    """Backward of :func:`fused_attention_fwd`: ``(dq, dk, dv)``.  On CUDA,
    δ in torch, then the dQ kernel and the dK/dV kernel."""
    if not _on_cuda("fused_attention_bwd", q):
        return fused_attention_bwd_plain(q, k, v, out, lse, do, kv_valid, causal=causal,
                                         block_size=block_size)
    do = do.contiguous()
    delta = _delta(out, do)
    dq = fused_attention_bwd_dq(q, k, v, do, lse, delta, kv_valid, causal=causal)
    dk, dv = fused_attention_bwd_dkv(q, k, v, do, lse, delta, kv_valid, causal=causal)
    return dq, dk, dv


fused_attention_fwd.launches = 0
fused_attention_bwd_dq.launches = 0
fused_attention_bwd_dkv.launches = 0


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal, block_size):
        out, lse = fused_attention_fwd(q, k, v, kv_valid, causal=causal, block_size=block_size)
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        ctx.causal, ctx.block_size = causal, block_size
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, out, lse, do, kv_valid, causal=ctx.causal,
                                         block_size=ctx.block_size)
        return dq, dk, dv, None, None, None


def fused_attention(q, k, v, *, causal: bool = True, block_size: int = 512,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused flash attention: q ``[B, S, H, d]``, k/v ``[B, S, K, d]``,
    optional ``kv_valid [B, S]`` (bool or int: nonzero keys take part).
    Returns ``[B, S, H, d]`` in q's dtype; differentiable in q, k and v."""
    b, s, h, _ = q.shape
    if h % k.shape[2]:
        raise ValueError(f"num q heads {h} not divisible by kv heads {k.shape[2]}")
    blk = _block(s, block_size)
    valid = None if kv_valid is None else kv_valid.to(torch.int8).contiguous()
    return _FusedAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), valid,
                                 causal, blk)
