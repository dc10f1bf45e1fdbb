"""The premise of the port's fp32 backward kernels
(``accelerate_tpu_torch/ops/csrc/flash_bwd_f32_sm90.cu``): products on the
tensor cores in 3xTF32 keep the fp32 tolerance, where one TF32 product does
not.

The kernels split each fp32 operand x into big = tf32(x), rounded to nearest
(ties away from zero) on the 13 mantissa bits TF32 drops, as
``cvt.rna.tf32.f32`` rounds, and small = x - big, whose 13 low bits the
tensor core drops (toward zero), and accumulate a_small.b_big + a_big.b_small
+ a_big.b_big in fp32.  Here the plain fp32 backward's five
products (S = QK^T, dP = dO V^T, dS K, P^T dO, dS^T Q) are computed that way
in torch, from the port's plain forward (lse) and δ, and held against the
gradients of the JAX package's ``pallas_attention`` (Pallas interpret mode,
``jax.vjp``) at the card kernels' fp32 tolerance, atol = rtol = 1e-4; the
same products in one TF32 pass miss it.  Inputs come from a numpy seed."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.ops import pallas_attention as jpa
from accelerate_tpu_torch.ops import fused_attention as tfu

TOL = 1e-4


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero: half of the dropped 13 bits' range added to the magnitude, then
    those bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_rz(x: torch.Tensor) -> torch.Tensor:
    """fp32 cut to TF32 toward zero, as the tensor core reads an fp32 word
    given as a TF32 operand."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(eq, a, b):
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32_rz(a - a_big), _tf32_rz(b - b_big)
    return (torch.einsum(eq, a_small, b_big) + torch.einsum(eq, a_big, b_small)
            + torch.einsum(eq, a_big, b_big))


def _mm_1xtf32(eq, a, b):
    return torch.einsum(eq, _tf32(a), _tf32(b))


def _backward(q, k, v, do, lse, delta, mm):
    """The plain causal fp32 backward (``_bwd_plain_f32``'s arithmetic over
    one key block) with every product through ``mm``: ``(dq [B, S, H, d], dk,
    dv [B, S, K, d])``, dK/dV summed over each kv head's query heads."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)

    def heads(x):
        return x.reshape(b, s, kh, g, d).permute(0, 2, 3, 1, 4)  # [B, K, G, S, d]

    qf, dof = heads(q), heads(do)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)  # [B, K, S, d]
    lse = lse.reshape(b, kh, g, s, 1)
    delta = delta.reshape(b, kh, g, s, 1)
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    sc = torch.where(causal, mm("bkgsd,bktd->bkgst", qf, kt) * scale, -1e30)
    p = torch.where(sc > -0.5e30, torch.exp(sc - lse), 0.0)
    ds = p * (mm("bkgsd,bktd->bkgst", dof, vt) - delta) * scale
    dq = mm("bkgst,bktd->bkgsd", ds, kt).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    dk = mm("bkgst,bkgsd->bktd", ds, qf).permute(0, 2, 1, 3)
    dv = mm("bkgst,bkgsd->bktd", p, dof).permute(0, 2, 1, 3)
    return dq, dk, dv


@pytest.mark.parametrize("d", [128, 256])
def test_3xtf32_backward_holds_the_fp32_tolerance_and_1xtf32_misses_it(d):
    b, s, h, kh = 1, 1024, 2, 1
    rng = np.random.default_rng(23)
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, kh, d)).astype(np.float32) for _ in range(2))

    def f(q, k, v):
        return jpa.pallas_attention(q, k, v, causal=True, block_size=s, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = tfu.fused_attention_fwd_plain(tq, tk, tv, causal=True, block_size=s)
    delta = tfu._delta(out, tdo)

    def excess(mm):
        """Per gradient, the largest |got - want| over atol + rtol |want|:
        within the tolerance at most 1."""
        got = _backward(tq, tk, tv, tdo, lse, delta, mm)
        return [float((np.abs(x.numpy() - w) / (TOL + TOL * np.abs(w))).max())
                for x, w in zip(got, want)]

    three, one = excess(_mm_3xtf32), excess(_mm_1xtf32)
    assert max(three) <= 1.0, f"3xTF32 dq/dk/dv at {three} of the tolerance"
    assert max(one) > 1.0, f"1xTF32 dq/dk/dv within the tolerance: {one}"


def test_tf32_rounding_is_to_nearest_ties_away():
    """``_tf32`` keeps 10 mantissa bits, rounding half-way cases away from
    zero as ``cvt.rna`` does, and big + small is x to 2^-21 of it (small
    keeps the top 11 significant bits of the 13 that big drops)."""
    one = 1.0
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4,
                      3.14159265], dtype=torch.float32)
    got = _tf32(x)
    assert got[:4].tolist() == [one + ulp, -(one + ulp), one, one + ulp]
    big = _tf32(x)
    small = _tf32_rz(x - big)
    assert ((big + small - x).abs() <= 2.0 ** -21 * x.abs()).all()
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
