"""The premise of the port's fp32 forward kernel
(``accelerate_tpu_torch/ops/csrc/flash_f32_sm90.cu``, ``atpu_flash_fwd_f32_sm90``):
its two products on the tensor cores in 3xTF32 keep the fp32 tolerance,
where one TF32 product does not.

The plain online-softmax forward (``fused_attention_fwd_plain``'s arithmetic)
runs over 64-key blocks, as the kernel's K/V tiles, with S = Q.K^T and P.V
through the TF32 splits of ``tests/test_torch_flash_bwd_tf32.py``: P stays
fp32 (the reference casts it to v's dtype, fp32), each block's P.V is summed
on its own and added to the rescaled accumulator in fp32.  Its out and lse
are held against the JAX package's ``_flash_fwd`` (Pallas interpret mode) at
the card kernel's fp32 tolerance, atol = rtol = 1e-4, in 3xTF32 with big
rounded to nearest (the backward kernels' split) and with big truncated (the
forward kernel's: it passes each fp32 word as the big part, which the tensor
core reads truncated, and small = x - trunc(x)); one TF32 pass misses it.
Inputs come from a numpy seed."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accelerate_tpu.ops import pallas_attention as jpa
from test_torch_flash_bwd_tf32 import TOL, _mm_1xtf32, _mm_3xtf32, _tf32_rz

BLOCK = 64  # keys a block: the kernel's K/V tile at d 64-128


def _mm_3xtf32_trunc(eq, a, b):
    """3xTF32 as the forward kernel splits: big = x read truncated to TF32,
    small = x - trunc(x), itself read truncated."""
    a_big, b_big = _tf32_rz(a), _tf32_rz(b)
    a_small, b_small = _tf32_rz(a - a_big), _tf32_rz(b - b_big)
    return (torch.einsum(eq, a_small, b_big) + torch.einsum(eq, a_big, b_small)
            + torch.einsum(eq, a_big, b_big))


def _forward(q, k, v, mm, block=BLOCK):
    """The plain causal fp32 forward with both products through ``mm``:
    ``(out [B, S, H, d], lse [B, H, S])``."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf = q.reshape(b, s, kh, h // kh, d).permute(0, 2, 3, 1, 4)  # [B, K, G, S, d]
    m = torch.full((b, kh, h // kh, s, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    q_pos = torch.arange(s)[:, None]
    for k0 in range(0, s, block):
        kt = k[:, k0:k0 + block].permute(0, 2, 1, 3)  # [B, K, blk, d]
        vt = v[:, k0:k0 + block].permute(0, 2, 1, 3)
        sc = mm("bkgsd,bktd->bkgst", qf, kt) * scale
        sc = torch.where(q_pos >= k0 + torch.arange(block)[None, :], sc, -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.where(sc > -0.5e30, torch.exp(sc - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm("bkgst,bktd->bkgsd", p, vt)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    return out, (m + torch.log(l)).reshape(b, h, s)


@pytest.mark.parametrize("d", [96, 128, 256])
def test_3xtf32_forward_holds_the_fp32_tolerance_and_1xtf32_misses_it(d):
    b, s, h, kh = 1, 1024, 2, 1
    rng = np.random.default_rng(23)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kh, d)).astype(np.float32) for _ in range(2))
    tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    want_out, want_lse = jpa._flash_fwd(tr(q), tr(k), tr(v), scale=float(1.0 / np.sqrt(d)),
                                        causal=True, blk_q=s, blk_k=s, interpret=True)
    want = (np.asarray(want_out).transpose(0, 2, 1, 3), np.asarray(want_lse))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))

    def excess(mm):
        """For out and lse, the largest |got - want| over atol + rtol |want|:
        within the tolerance at most 1."""
        got = _forward(tq, tk, tv, mm)
        return [float((np.abs(x.numpy() - w) / (TOL + TOL * np.abs(w))).max())
                for x, w in zip(got, want)]

    three, trunc, one = excess(_mm_3xtf32), excess(_mm_3xtf32_trunc), excess(_mm_1xtf32)
    assert max(three) <= 1.0, f"3xTF32 out/lse at {three} of the tolerance"
    assert max(trunc) <= 1.0, f"truncating 3xTF32 out/lse at {trunc} of the tolerance"
    assert max(one) > 1.0, f"1xTF32 out/lse within the tolerance: {one}"
