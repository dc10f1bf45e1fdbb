"""The port's attention ops (``accelerate_tpu_torch/ops/fused_attention.py``
and ``ops/flash_attention.py``) against the JAX package on the same inputs.

The fused op's plain versions (what its wrappers run on CPU tensors) are
held to the Pallas flash kernels run in interpret mode, as the JAX package's
own tests run them: forward ``out`` and ``lse`` from ``_flash_fwd``, and the
gradients of ``pallas_attention`` through its ``jax.vjp``.  Tolerances are
those of ``tests/test_pallas_attention.py``: 2e-5 fp32 forward, 5e-5
gradients, 0.05 bf16.  Inputs come from a numpy seed."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.ops import flash_attention as jfa
from accelerate_tpu.ops import pallas_attention as jpa
from accelerate_tpu_torch.ops import flash_attention as tfa
from accelerate_tpu_torch.ops import fused_attention as tfu

B, S, H, D, BLK = 3, 128, 4, 64, 64


def _inputs(seed, kv_heads, dtype=np.float32, s=S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, H, D)).astype(np.float32)
    k = rng.standard_normal((B, s, kv_heads, D)).astype(np.float32)
    v = rng.standard_normal((B, s, kv_heads, D)).astype(np.float32)
    do = rng.standard_normal((B, s, H, D)).astype(np.float32)
    return q, k, v, do


def _valid(s=S):
    """Batch 0 left-padded by 40 (its first 40 causal rows admit no key),
    batch 1 all valid, batch 2 all invalid (every row empty)."""
    valid = np.ones((B, s), np.int8)
    valid[0, :40] = 0
    valid[2, :] = 0
    return valid


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "kv_valid"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kv_heads", [1, 2, 4])
def test_plain_forward_matches_pallas(kv_heads, causal, masked):
    q, k, v, _ = _inputs(0, kv_heads)
    valid = _valid() if masked else None
    tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    want_out, want_lse = jpa._flash_fwd(
        tr(q), tr(k), tr(v), scale=float(1.0 / np.sqrt(D)), causal=causal, blk_q=BLK,
        blk_k=BLK, interpret=True, kv_valid=None if valid is None else jnp.asarray(valid),
    )
    out, lse = tfu.fused_attention_fwd(
        _t(q), _t(k), _t(v), None if valid is None else torch.from_numpy(valid),
        causal=causal, block_size=BLK,
    )
    assert tfu.fused_attention_fwd.launches == 0  # CPU tensors: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out).transpose(0, 2, 1, 3),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=2e-5, rtol=2e-5)
    if masked:
        assert np.all(out.numpy()[2] == 0) and np.all(lse.numpy()[2] < -1e29)
        if causal:
            assert np.all(out.numpy()[0, :40] == 0)


@pytest.mark.parametrize("h,kv_heads,pad,causal", [
    (4, 2, 0, True),      # S 192: one 128-key tile and a ragged one
    (4, 2, 130, True),    # left pad past a whole 128-key tile
    (4, 2, 130, False),
    (8, 1, 0, True),      # a GQA group of 8
    (8, 1, 130, False),
], ids=["ragged", "pad130-causal", "pad130-full", "gqa8", "gqa8-pad130-full"])
def test_plain_forward_matches_pallas_at_hopper_tile_edges(h, kv_heads, pad, causal):
    """The shapes the Hopper forward's 128-row, 128-key tiles meet, held on
    the plain forward (the card's reference) against ``_flash_fwd``: S 192
    with block 64, batch 0 left-padded by ``pad`` keys and batch 2 all
    invalid when ``pad`` is set."""
    s = 192
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, s, h, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, s, kv_heads, D)).astype(np.float32) for _ in range(2))
    valid = None
    if pad:
        valid = np.ones((B, s), np.int8)
        valid[0, :pad] = 0
        valid[2, :] = 0
    tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    want_out, want_lse = jpa._flash_fwd(
        tr(q), tr(k), tr(v), scale=float(1.0 / np.sqrt(D)), causal=causal, blk_q=BLK,
        blk_k=BLK, interpret=True, kv_valid=None if valid is None else jnp.asarray(valid),
    )
    out, lse = tfu.fused_attention_fwd(
        _t(q), _t(k), _t(v), None if valid is None else torch.from_numpy(valid),
        causal=causal, block_size=BLK,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out).transpose(0, 2, 1, 3),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=2e-5, rtol=2e-5)
    if pad:
        assert np.all(out.numpy()[2] == 0) and np.all(lse.numpy()[2] < -1e29)
        if causal:
            assert np.all(out.numpy()[0, :pad] == 0) and np.all(lse.numpy()[0, :, :pad] < -1e29)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "kv_valid"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kv_heads", [1, 2, 4])
def test_plain_backward_matches_pallas_vjp(kv_heads, causal, masked):
    q, k, v, do = _inputs(1, kv_heads)
    valid = _valid() if masked else None

    def f(q, k, v):
        return jpa.pallas_attention(q, k, v, causal=causal, block_size=BLK, interpret=True,
                                    kv_valid=None if valid is None else jnp.asarray(valid))

    out_j, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = tfu.fused_attention(tq, tk, tv, causal=causal, block_size=BLK,
                              kv_valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=2e-5, rtol=2e-5)
    out.backward(_t(do))
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5,
                                   err_msg=f"d{name}")
    if masked:
        # Invalid keys get no gradient; empty rows give none to their query.
        assert np.all(tk.grad.numpy()[2] == 0) and np.all(tv.grad.numpy()[0, :40] == 0)
        assert np.all(tq.grad.numpy()[2] == 0)


@pytest.mark.parametrize("h,kv_heads,pad,causal", [
    (4, 2, 0, True),      # S 192: one 128-key CTA and a ragged one; three 64-row q tiles
    (4, 2, 130, True),    # left pad past a whole 128-key CTA (and a 128-row dQ CTA)
    (4, 2, 130, False),
    (8, 1, 0, True),      # a GQA group of 8 walked by one CTA
    (8, 1, 130, False),
    (8, 2, 0, True),      # G 4; dQ: one full 128-row CTA and a ragged 64-row one
    (8, 2, 64, True),     # dQ: exactly one invalid 64-key tile
    (8, 2, 64, False),
], ids=["ragged", "pad130-causal", "pad130-full", "gqa8", "gqa8-pad130-full", "gqa4",
        "gqa4-pad64-causal", "gqa4-pad64-full"])
def test_plain_backward_matches_pallas_vjp_at_hopper_tile_edges(h, kv_heads, pad, causal):
    """The shapes the Hopper backward kernels meet (dK/dV: 128-key CTAs over
    64-row Q/dO tiles; dQ: 128-row CTAs over 64-key K/V tiles), held on the
    plain backward (the card's reference) against the gradients of
    ``pallas_attention``: S 192 with block 64, batch 0 left-padded by ``pad``
    keys and batch 2 all invalid when ``pad`` is set.  Padded keys get
    exactly zero dK and dV, and rows that admit no key exactly zero dQ."""
    s = 192
    rng = np.random.default_rng(9)
    q, do = (rng.standard_normal((B, s, h, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, s, kv_heads, D)).astype(np.float32) for _ in range(2))
    valid = None
    if pad:
        valid = np.ones((B, s), np.int8)
        valid[0, :pad] = 0
        valid[2, :] = 0

    def f(q, k, v):
        return jpa.pallas_attention(q, k, v, causal=causal, block_size=BLK, interpret=True,
                                    kv_valid=None if valid is None else jnp.asarray(valid))

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_dq, want_dk, want_dv = vjp(jnp.asarray(do))
    tvalid = None if valid is None else torch.from_numpy(valid)
    out, lse = tfu.fused_attention_fwd_plain(_t(q), _t(k), _t(v), tvalid, causal=causal,
                                             block_size=BLK)
    delta = tfu._delta(out, _t(do))
    dq = tfu.fused_attention_bwd_dq(_t(q), _t(k), _t(v), _t(do), lse, delta, tvalid,
                                    causal=causal)
    dk, dv = tfu.fused_attention_bwd_dkv(_t(q), _t(k), _t(v), _t(do), lse, delta, tvalid,
                                         causal=causal)
    for got, ref, name in ((dq, want_dq, "dq"), (dk, want_dk, "dk"), (dv, want_dv, "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5,
                                   err_msg=name)
    if pad:
        assert np.all(dk.numpy()[0, :pad] == 0) and np.all(dv.numpy()[0, :pad] == 0)
        assert np.all(dk.numpy()[2] == 0) and np.all(dv.numpy()[2] == 0)
        assert np.all(dq.numpy()[2] == 0)
        if causal:
            assert np.all(dq.numpy()[0, :pad] == 0)


@pytest.mark.parametrize("symbol", sorted(tfu._ARGTYPES))
def test_every_launcher_is_defined_in_a_built_source(symbol):
    """Each C launcher the wrappers can call is defined, with as many
    parameters as ``_ARGTYPES`` declares, in a source ``_build`` compiles
    (read as text: nothing is built here)."""
    from accelerate_tpu_torch.ops import _build

    source = _build.SOURCES[tfu._SOURCES.get(symbol, "flash_attention")].read_text()
    found = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", source)
    assert found, f"{symbol} not defined"
    assert len(found.group(1).split(",")) == len(tfu._ARGTYPES[symbol])


@pytest.mark.parametrize("source", ["flash_attention", "flash_fwd_sm90", "flash_bwd_dq_sm90",
                                    "flash_bwd_dkv_sm90"])
def test_every_flash_launcher_is_declared(source):
    """The converse: each C launcher a flash source defines has its argument
    types in ``_ARGTYPES`` and is looked up in that source, so no launcher
    is left behind that no wrapper or timing call can reach."""
    from accelerate_tpu_torch.ops import _build

    defined = re.findall(r'extern "C" int (\w+)\(', _build.SOURCES[source].read_text())
    assert defined
    for symbol in defined:
        assert symbol in tfu._ARGTYPES, f"{symbol} has no declared argument types"
        assert tfu._SOURCES.get(symbol, "flash_attention") == source, symbol


def test_bf16_plain_matches_pallas():
    q, k, v, do = _inputs(2, 2)
    valid = _valid()
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731

    def f(q, k, v):
        return jpa.pallas_attention(q, k, v, causal=True, block_size=BLK, interpret=True,
                                    kv_valid=jnp.asarray(valid))

    out_j, vjp = jax.vjp(f, bf(q), bf(k), bf(v))
    want = vjp(bf(do))
    tq, tk, tv = (_t(x, torch.bfloat16).requires_grad_() for x in (q, k, v))
    out = tfu.fused_attention(tq, tk, tv, causal=True, block_size=BLK,
                              kv_valid=torch.from_numpy(valid))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(out_j.astype(jnp.float32)), atol=0.05, rtol=0.05)
    out.backward(_t(do, torch.bfloat16))
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                                   atol=0.05, rtol=0.05, err_msg=f"d{name}")


def test_wrappers_on_cpu_run_the_plain_versions():
    """The backward wrappers on CPU tensors return the plain version's
    pieces; no kernel is counted."""
    q, k, v, do = (_t(x) for x in _inputs(3, 2))
    out, lse = tfu.fused_attention_fwd_plain(q, k, v, causal=True, block_size=BLK)
    dq, dk, dv = tfu.fused_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                               block_size=BLK)
    delta = tfu._delta(out, do)
    torch.testing.assert_close(tfu.fused_attention_bwd_dq(q, k, v, do, lse, delta), dq)
    got_dk, got_dv = tfu.fused_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.testing.assert_close(got_dk, dk)
    torch.testing.assert_close(got_dv, dv)
    launches = (tfu.fused_attention_fwd.launches, tfu.fused_attention_bwd_dq.launches,
                tfu.fused_attention_bwd_dkv.launches)
    assert launches == (0, 0, 0)
    with pytest.raises(ValueError, match="divisible"):
        tfu.fused_attention(q, k, v, block_size=48)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "kv_valid"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_blockwise_flash_matches_jax(causal, masked):
    q, k, v, do = _inputs(4, 2)
    valid = _valid() if masked else None

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, block_size=32,
                                   kv_valid=None if valid is None else jnp.asarray(valid, bool))

    out_j, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, block_size=32,
                              kv_valid=None if valid is None else torch.from_numpy(valid).bool())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=2e-5, rtol=2e-5)
    out.backward(_t(do))
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("s,head_dim", [(2048, 128), (3072, 128), (1536, 256), (100, 64),
                                        (1100, 64), (96, 128)])
def test_block_pickers_match_jax(s, head_dim):
    assert tfa.pick_block(s) == jfa.pick_block(s)
    assert tfa.pick_block(s, max_single_block=1024) == jfa.pick_block(s, max_single_block=1024)
    assert tfa.pick_block_pallas(s, head_dim) == jfa.pick_block_pallas(s, head_dim)


def test_block_override_env(monkeypatch):
    monkeypatch.setenv("ACCELERATE_ATTN_BLOCK", "256")
    assert tfa.pick_block_pallas(2048, 128) == jfa.pick_block_pallas(2048, 128) == 256
    monkeypatch.setenv("ACCELERATE_ATTN_BLOCK", "384")
    with pytest.warns(UserWarning, match="does not divide"):
        assert tfa.pick_block(2048) == 512
    monkeypatch.setenv("ACCELERATE_ATTN_BLOCK", "-2")
    with pytest.raises(ValueError, match="positive"):
        tfa.pick_block(2048)


@pytest.mark.parametrize("h,kv_heads", [(4, 1), (2, 2), (8, 1)], ids=["gqa4", "mha2", "gqa8"])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "padded"])
@pytest.mark.parametrize("d", [96, 256])
def test_plain_versions_match_pallas_at_wide_heads(d, masked, h, kv_heads):
    """Head dims 96 (Phi-3-mini) and 256 (Gemma), which the CUDA body of
    ``flash_attention.cu`` takes since the port widened it: the plain
    forward (``out``, ``lse``) against ``_flash_fwd`` and the plain backward
    against the gradients of ``pallas_attention``, both in interpret mode,
    causal at S 128 with batch 0 left-padded by 40 keys when ``masked``;
    ``gqa8`` is Gemma-2B's 8 q / 1 kv heads, the ratio the sm90 dQ and
    forward bodies see on its training path.  The scale is 1/sqrt(d) on
    both sides (1/16 at d 256)."""
    b, s = 2, 128
    rng = np.random.default_rng(11)
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, kv_heads, d)).astype(np.float32) for _ in range(2))
    valid = None
    if masked:
        valid = np.ones((b, s), np.int8)
        valid[0, :40] = 0
    jvalid = None if valid is None else jnp.asarray(valid)
    tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    want_out, want_lse = jpa._flash_fwd(tr(q), tr(k), tr(v), scale=float(1.0 / np.sqrt(d)),
                                        causal=True, blk_q=BLK, blk_k=BLK, interpret=True,
                                        kv_valid=jvalid)

    def f(q, k, v):
        return jpa.pallas_attention(q, k, v, causal=True, block_size=BLK, interpret=True,
                                    kv_valid=jvalid)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(do))
    tvalid = None if valid is None else torch.from_numpy(valid)
    out, lse = tfu.fused_attention_fwd(_t(q), _t(k), _t(v), tvalid, causal=True,
                                       block_size=BLK)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out).transpose(0, 2, 1, 3),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=2e-5, rtol=2e-5)
    grads = tfu.fused_attention_bwd(_t(q), _t(k), _t(v), out, lse, _t(do), tvalid, causal=True,
                                    block_size=BLK)
    for got, ref, name in zip(grads, want_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5,
                                   err_msg=name)
    if masked:
        assert np.all(out.numpy()[0, :40] == 0) and np.all(grads[1].numpy()[0, :40] == 0)


# The launcher each wrapper calls for bf16/fp16 at a head dim: the sm90
# bodies at every head dim (dK/dV's d-256 kernel at 256); fp32 everywhere on
# flash_attention.cu's body.
_ROUTES = {
    "atpu_flash_fwd": {64: "atpu_flash_fwd_sm90", 96: "atpu_flash_fwd_sm90",
                       128: "atpu_flash_fwd_sm90", 256: "atpu_flash_fwd_sm90"},
    "atpu_flash_bwd_dq": {64: "atpu_flash_bwd_dq_sm90", 96: "atpu_flash_bwd_dq_sm90",
                          128: "atpu_flash_bwd_dq_sm90", 256: "atpu_flash_bwd_dq_sm90"},
    "atpu_flash_bwd_dkv": {64: "atpu_flash_bwd_dkv_sm90", 96: "atpu_flash_bwd_dkv_sm90",
                           128: "atpu_flash_bwd_dkv_sm90", 256: "atpu_flash_bwd_dkv_sm90_d256"},
}


@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("kernel", sorted(_ROUTES))
def test_wrappers_take_the_kernels_head_dims_only(kernel, dtype, d):
    """The head dims the kernels take are 64, 96, 128 and 256: the wrapper's
    check passes them (on a CPU tensor it needs no card) and raises for
    another.  Routing is per kernel: bf16/fp16 at every head dim go to the
    sm90 bodies (dK/dV at 256 to its d-256 kernel); fp32 to the body of
    ``flash_attention.cu``."""
    assert tfu._HEAD_DIMS == (64, 96, 128, 256)
    x = torch.zeros(1, 64, 2, d, dtype=dtype)
    tfu._check(x, x, x, None)
    want = kernel if dtype == torch.float32 else _ROUTES[kernel][d]
    assert tfu._symbol(kernel, x) == want
    assert want in tfu._ARGTYPES
    x = torch.zeros(1, 64, 2, 80, dtype=dtype)
    with pytest.raises(ValueError, match="head_dim 80"):
        tfu._check(x, x, x, None)


@pytest.mark.parametrize("b,kh,s,g,sms,want", [
    (2, 16, 2048, 1, 132, 1),   # Gemma-7B: 1024 CTAs
    (2, 1, 2048, 8, 132, 4),    # Gemma-2B: 64 key tiles, x4 = 256 CTAs
    (1, 1, 2048, 8, 132, 8),    # 32 tiles: only x8 = 256 fills a wave
    (2, 1, 4096, 8, 132, 2),    # 128 tiles: x2 fills the card
    (2, 8, 2048, 4, 132, 1),    # Llama-3-8B's geometry: 512 CTAs
    (1, 1, 100, 6, 132, 6),     # 2 tiles: no divisor fills a wave, so the whole group
    (1, 1, 64, 6, 4, 6),        # 1 tile on 4 SMs: 6 is the least divisor >= 4
    (3, 2, 1000, 6, 132, 2),    # 96 ragged tiles x 2 = 192
])
def test_pick_dkv_split(b, kh, s, g, sms, want):
    """The d-256 dK/dV split: the least divisor of the group that fills one
    wave of CTAs (or the whole group), from shapes and the SM count only."""
    n = tfu.pick_dkv_split(b, kh, s, g, sms)
    assert n == want and g % n == 0
    tiles = b * kh * -(-s // 64)
    assert n == g or tiles * n >= sms
    assert all(tiles * m < sms for m in range(1, n) if g % m == 0)


@pytest.mark.parametrize("n_split", [1, 2, 4, 8])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "padded"])
def test_split_dkv_sum_matches_pallas_group_sum(masked, n_split):
    """The d-256 dK/dV kernel's arithmetic in plain torch: per-split fp32
    partials over a kv head's query heads, added in split order and cast,
    equal ``_flash_bwd``'s per-query-head dK/dV summed over the group
    (Pallas interpret mode) at Gemma-2B's 8 q / 1 kv heads of 256, S 128,
    with batch 0 left-padded by 40 keys when ``masked`` (its invalid keys
    get exactly 0)."""
    b, s, h, kh, d = 2, 128, 8, 1, 256
    rng = np.random.default_rng(17)
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, kh, d)).astype(np.float32) for _ in range(2))
    valid = None
    if masked:
        valid = np.ones((b, s), np.int8)
        valid[0, :40] = 0
    jvalid = None if valid is None else jnp.asarray(valid)
    tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    scale = float(1.0 / np.sqrt(d))
    out, lse = jpa._flash_fwd(tr(q), tr(k), tr(v), scale=scale, causal=True, blk_q=BLK,
                              blk_k=BLK, interpret=True, kv_valid=jvalid)
    _, want_dk, want_dv = jpa._flash_bwd(tr(q), tr(k), tr(v), out, lse, tr(do), scale=scale,
                                         causal=True, blk_q=BLK, blk_k=BLK, interpret=True,
                                         kv_valid=jvalid)
    t_out = torch.from_numpy(np.asarray(out).transpose(0, 2, 1, 3).copy())
    delta = tfu._delta(t_out, _t(do))
    tvalid = None if valid is None else torch.from_numpy(valid)
    part_dk, part_dv = tfu.dkv_split_partials_plain(
        _t(q), _t(k), _t(v), _t(do), torch.from_numpy(np.array(lse)), delta, tvalid,
        causal=True, n_split=n_split)
    assert part_dk.shape == part_dv.shape == (n_split, b, s, kh, d)
    assert part_dk.dtype == torch.float32
    dk, dv = tfu.dkv_split_sum_plain(part_dk, part_dv, torch.float32)
    for got, ref, name in ((dk, want_dk, "dk"), (dv, want_dv, "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 2, 1, 3),
                                   atol=5e-5, rtol=5e-5, err_msg=name)
    if masked:
        assert np.all(dk.numpy()[0, :40] == 0) and np.all(dv.numpy()[0, :40] == 0)
        assert torch.all(part_dk[:, 0, :40] == 0) and torch.all(part_dv[:, 0, :40] == 0)
