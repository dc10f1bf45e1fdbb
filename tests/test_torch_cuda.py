"""The port's CUDA kernels on the card (``-m cuda``; they skip without one).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit.  ``tests/conftest.py`` imports
JAX, so there it runs without the conftest::

    python -m pytest --noconftest -q tests/test_torch_cuda.py

and while working on one kernel, only its cases (``-k flash`` for the
flash kernels, ``-k paged`` for the paged ones; the build and the tests take
under a minute)::

    python -m pytest --noconftest -q tests/test_torch_cuda.py -k paged

Tolerances (the kernel's online softmax sums in another order than the
plain version): fp32 atol = rtol = 1e-4, bf16 and fp16 atol = rtol = 2e-2.
"""

import os
import time

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.models import llama
from accelerate_tpu_torch.ops import fused_attention as fu
from accelerate_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, kv_heads, groups, window, dtype, d=128, bs=16,
            lengths=(0, 1, 15, 16, 17, 700), m=64):
    """Llama-3-8B head geometry by default; pool blocks in shuffled order,
    tables null-padded to ``m``."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    owned = [-(-n // bs) for n in lengths]
    nblk = sum(owned) + 1
    perm = rng.permutation(np.arange(1, nblk))
    tables = np.zeros((b, m), np.int32)
    c = 0
    for i, n in enumerate(owned):
        tables[i, :n] = perm[c:c + n]
        c += n
    lead = (b,) if window is None else (b, window)
    h = kv_heads * groups

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)

    return dict(
        q=randn(*lead, h, d), k_new=randn(*lead, kv_heads, d), v_new=randn(*lead, kv_heads, d),
        pool_k=randn(nblk, bs, kv_heads, d), pool_v=randn(nblk, bs, kv_heads, d),
        tables=torch.from_numpy(tables).cuda(),
        lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"),
    )


def _fns(window):
    if window is None:
        return pa.paged_attention, pa.paged_attention_plain
    return pa.paged_window_attention, pa.paged_window_attention_plain


@pytest.mark.paged
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("window", [None, 1, 4])
def test_kernel_matches_plain(cuda, dtype, window):
    args = _inputs(23, 8, 4, window, dtype)
    fn, plain = _fns(window)
    before = fn.launches
    got = fn(**args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == dtype and got.shape == args["q"].shape
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), plain(**args).float(), rtol=tol, atol=tol)


@pytest.mark.paged
@pytest.mark.parametrize("d,dtype,window", [
    (64, torch.float32, 3), (256, torch.bfloat16, 2), (128, torch.float32, 40),
    (96, torch.float16, 3), (256, torch.float32, 2), (96, torch.float32, 40),
])
def test_kernel_other_head_dims_and_long_windows(cuda, d, dtype, window):
    args = _inputs(29, 2, 8, window, dtype, d=d, bs=8, lengths=(5, 0, 33, 70), m=16)
    fn, plain = _fns(window)
    tol = TOL[dtype]
    torch.testing.assert_close(fn(**args).float(), plain(**args).float(), rtol=tol, atol=tol)


@pytest.mark.paged
def test_idle_slot_reads_no_pool_block(cuda):
    """Length 0 and an all-null table: only the new row counts, whatever
    the null block holds."""
    args = _inputs(31, 8, 4, None, torch.float32, lengths=(0, 40))
    args["pool_k"][0] = float("nan")
    args["pool_v"][0] = float("nan")
    out = pa.paged_attention(**args)
    torch.testing.assert_close(out[0], args["v_new"][0].repeat_interleave(4, dim=0))
    assert torch.isfinite(out).all()


@pytest.mark.paged
def test_wrapper_raises_instead_of_falling_back(cuda):
    args = _inputs(37, 8, 4, None, torch.float32)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(**dict(args, tables=args["tables"].long()))
    with pytest.raises(TypeError, match="pool_k"):
        pa.paged_attention(**dict(args, pool_k=args["pool_k"].half()))
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(**dict(args, q=args["q"].transpose(0, 1).contiguous().transpose(0, 1)))
    with pytest.raises(ValueError, match="head_dim"):
        small = _inputs(37, 2, 2, None, torch.float32, d=32)
        pa.paged_attention(**small)


@pytest.mark.paged
def test_apply_paged_kernel_launches_per_layer_and_matches_plain(cuda):
    """Tiny llama in fp32 on the card: one decode forward launches the
    decode kernel once per layer, a verify forward the window kernel once
    per layer, and both match the plain einsum path."""
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, head_dim=64, num_layers=3)
    params = llama.init_params(cfg, seed=0)
    rng = np.random.default_rng(41)
    shape = (cfg.num_layers, 12, 4, cfg.num_kv_heads, 64)
    pool = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
            for k in ("k", "v")}
    tables = torch.tensor([[3, 5, 0, 0], [0, 0, 0, 0], [1, 2, 4, 6]], dtype=torch.int32).cuda()
    starts = torch.tensor([6, 0, 13], dtype=torch.int32, device="cuda")
    for t, fn in ((1, pa.paged_attention), (3, pa.paged_window_attention)):
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, t))).cuda()
        before = fn.launches
        got, rows = llama.apply_paged(params, ids, cfg, pool, tables, starts, kernel=True)
        assert fn.launches == before + cfg.num_layers
        want, want_rows = llama.apply_paged(params, ids, cfg, pool, tables, starts, kernel=False)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(rows["k"], want_rows["k"], rtol=1e-4, atol=1e-4)


@pytest.fixture
def paged_symbols(monkeypatch):
    """The C launchers the paged wrappers call, in order."""
    seen = []
    kernel = pa._kernel

    def spy(symbol):
        seen.append(symbol)
        return kernel(symbol)

    monkeypatch.setattr(pa, "_kernel", spy)
    return seen


_SM90_CASES = [(dtype, d) for dtype in (torch.float32, torch.bfloat16, torch.float16)
               for d in (64, 96, 128, 256)]


@pytest.mark.paged
@pytest.mark.parametrize("window", [None, 1, 4, 40])
@pytest.mark.parametrize("dtype,d", _SM90_CASES,
                         ids=[f"{str(t)[6:]}-hd{d}" for t, d in _SM90_CASES])
def test_paged_sm90_matches_plain(cuda, paged_symbols, dtype, d, window):
    """The split and merge kernels in every dtype and head dim (fp32 at 256
    streams 32-position ring stages), decode and windows up to 40 (G*W =
    160 rows: ten row groups), one wrapper launch per call."""
    args = _inputs(83, 2, 4, window, dtype, d=d, lengths=(0, 1, 15, 16, 17, 300, 1000), m=64)
    fn, plain = _fns(window)
    before = fn.launches
    got = fn(**args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want_symbol = "atpu_paged_attention_sm90" if window is None else \
        "atpu_paged_window_attention_sm90"
    assert paged_symbols == [want_symbol]
    assert got.dtype == dtype and got.shape == args["q"].shape and torch.isfinite(got).all()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), plain(**args).float(), rtol=tol, atol=tol)


@pytest.mark.paged
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("split_blocks", [1, 2, 8, 64])
def test_paged_sm90_split_boundaries(cuda, dtype, window, split_blocks):
    """Lengths k*C - 1, k*C, k*C + 1 for chunk C of one block up to the whole
    table, a table full to M*bs, and an idle slot."""
    bs, m = 16, 64
    c = split_blocks * bs
    k = max(1, (m * bs - 1) // c - 1)
    lengths = (k * c - 1, k * c, min(k * c + 1, m * bs), m * bs, 0, c - 1 if c > 1 else 1)
    args = _inputs(89, 8, 4, window, dtype, lengths=lengths, m=m)
    fn, plain = _fns(window)
    got = pa._launch(**args, window=window is not None, split_tokens=c)  # not counted
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), plain(**args).float(), rtol=tol, atol=tol)


@pytest.mark.paged
@pytest.mark.parametrize("window", [None, 3])
def test_paged_sm90_every_slot_idle(cuda, window):
    """Every slot at length 0 with a NaN null block: no pool block is read,
    and a row that admits only new row 0 outputs v_new exactly."""
    args = _inputs(97, 8, 4, window, torch.bfloat16, lengths=(0, 0, 0), m=64)
    args["pool_k"][0] = float("nan")
    args["pool_v"][0] = float("nan")
    fn, plain = _fns(window)
    out = fn(**args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    first = out if window is None else out[:, 0]
    v0 = args["v_new"] if window is None else args["v_new"][:, 0]
    torch.testing.assert_close(first, v0.repeat_interleave(4, dim=1), rtol=0, atol=0)
    torch.testing.assert_close(out.float(), plain(**args).float(), rtol=2e-2, atol=2e-2)


@pytest.mark.paged
@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.bfloat16, 128),
                                     (torch.float16, 64), (torch.bfloat16, 256)],
                         ids=["fp32-hd128", "bf16-hd128", "fp16-hd64", "bf16-hd256"])
@pytest.mark.parametrize("window", [1, 4, 40])
def test_paged_split_merge_kernel_matches_plain(cuda, dtype, d, window):
    """The merge kernel alone against its plain version on the same
    partials (from the plain split path, with NaN in every split the merge
    must not read)."""
    bs, m, c = 16, 64, 128
    args = _inputs(101, 2, 4, window, dtype, d=d, lengths=(0, 5, 128, 129, 700, 1024), m=m)
    part_o, part_ml = pa.paged_split_partials_plain(args["q"], args["pool_k"], args["pool_v"],
                                                    args["tables"], args["lengths"], c)
    n_used = (args["lengths"].long() + c - 1) // c
    for b, n in enumerate(n_used.tolist()):
        part_o[b, :, n:] = float("nan")
        part_ml[b, :, n:] = float("nan")
    rest = (args["q"], args["k_new"], args["v_new"], part_o.contiguous(), part_ml.contiguous(),
            args["lengths"], c, bs, m)
    before = pa.paged_split_merge.launches
    got = pa.paged_split_merge(*rest)
    torch.cuda.synchronize()
    assert pa.paged_split_merge.launches == before + 1
    want = pa.paged_split_merge_plain(*rest)
    tol = TOL[dtype]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# flash-attention training kernels (ops/fused_attention.py)
# ---------------------------------------------------------------------------


def _flash_inputs(seed, b, s, h, kh, d, dtype, masked):
    """q/k/v/dO from a numpy seed; with ``masked``, batch 0 is left-padded
    by a third of S (its first causal rows admit no key) and the last batch
    is all invalid (every row empty)."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)

    valid = None
    if masked:
        vm = np.ones((b, s), np.int8)
        vm[0, : s // 3] = 0
        vm[-1, :] = 0
        valid = torch.from_numpy(vm).cuda()
    return randn(b, s, h, d), randn(b, s, kh, d), randn(b, s, kh, d), randn(b, s, h, d), valid


def _flash_check(seed, b, s, h, kh, d, dtype, causal, masked):
    q, k, v, do, valid = _flash_inputs(seed, b, s, h, kh, d, dtype, masked)
    counts = (fu.fused_attention_fwd.launches, fu.fused_attention_bwd_dq.launches,
              fu.fused_attention_bwd_dkv.launches)
    out, lse = fu.fused_attention_fwd(q, k, v, valid, causal=causal, block_size=s)
    dq, dk, dv = fu.fused_attention_bwd(q, k, v, out, lse, do, valid, causal=causal,
                                        block_size=s)
    torch.cuda.synchronize()
    assert (fu.fused_attention_fwd.launches, fu.fused_attention_bwd_dq.launches,
            fu.fused_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    want_out, want_lse = fu.fused_attention_fwd_plain(q, k, v, valid, causal=causal,
                                                      block_size=s)
    want = fu.fused_attention_bwd_plain(q, k, v, want_out, want_lse, do, valid, causal=causal,
                                        block_size=s)
    tol = TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (b, h, s)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert got.dtype == dtype and torch.isfinite(got).all(), name
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol, msg=name)
    if masked:
        assert (out[-1] == 0).all() and (dq[-1] == 0).all() and (dk[-1] == 0).all()


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "kv_valid"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["fp32", "bf16", "fp16"])
def test_flash_kernels_match_plain(cuda, dtype, d, groups, causal, masked):
    _flash_check(43, 2, 256, 2 * groups, 2, d, dtype, causal, masked)


@pytest.mark.parametrize("s", [200, 1024])
def test_flash_kernels_ragged_and_long(cuda, s):
    """S not a multiple of the kernels' 64-row tiles, and a long sequence at
    Llama-3-8B head geometry."""
    _flash_check(47, 1, s, 32, 8, 128, torch.bfloat16, True, True)


@pytest.fixture
def fwd_symbols(monkeypatch):
    """The C launchers the flash wrappers call, in order."""
    seen = []
    kernel = fu._kernel

    def spy(symbol):
        seen.append(symbol)
        return kernel(symbol)

    monkeypatch.setattr(fu, "_kernel", spy)
    return seen


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("groups", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("s", [64, 100, 129, 200, 1024])
def test_flash_fwd_sm90_edges(cuda, fwd_symbols, s, d, groups, dtype, causal):
    """The Hopper forward (128-row CTAs over 128-key tiles, 64-key at d
    256; at d 96 a 64-column block beside a 64-byte-swizzled 32-column one)
    at S below one tile, across a ragged edge and long, against the plain
    forward."""
    q, k, v, _, _ = _flash_inputs(67, 2, s, 2 * groups, 2, d, dtype, False)
    before = fu.fused_attention_fwd.launches
    out, lse = fu.fused_attention_fwd(q, k, v, causal=causal, block_size=s)
    torch.cuda.synchronize()
    assert fu.fused_attention_fwd.launches == before + 1
    assert fwd_symbols == ["atpu_flash_fwd_sm90"]
    want_out, want_lse = fu.fused_attention_fwd_plain(q, k, v, causal=causal, block_size=s)
    tol = TOL[dtype]
    assert out.dtype == dtype and torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_flash_fwd_sm90_left_pad_past_a_tile(cuda, dtype, d, causal):
    """Batch 0 left-padded by 300 keys (its first two 128-key tiles, four
    64-key tiles at d 256, hold no valid key; under the causal mask its
    first 300 rows admit none), batch 1 all invalid: empty rows output 0
    with lse ~ -1e30 and get zero gradients from the backward kernels."""
    s, pad = 400, 300
    q, k, v, do, _ = _flash_inputs(71, 2, s, 8, 2, d, dtype, False)
    valid = torch.ones(2, s, dtype=torch.int8, device="cuda")
    valid[0, :pad] = 0
    valid[1] = 0
    out, lse = fu.fused_attention_fwd(q, k, v, valid, causal=causal, block_size=s)
    dq, dk, dv = fu.fused_attention_bwd(q, k, v, out, lse, do, valid, causal=causal,
                                        block_size=s)
    torch.cuda.synchronize()
    want_out, want_lse = fu.fused_attention_fwd_plain(q, k, v, valid, causal=causal,
                                                      block_size=s)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)
    assert (out[1] == 0).all() and (lse[1] < -1e29).all()
    assert (dq[1] == 0).all() and (dk[1] == 0).all() and (dv[1] == 0).all()
    assert (dk[0, :pad] == 0).all() and (dv[0, :pad] == 0).all()
    if causal:
        assert (out[0, :pad] == 0).all() and (lse[0, :, :pad] < -1e29).all()
        assert (dq[0, :pad] == 0).all()


def test_flash_fwd_bf16_counts_one_launch_and_raises_on_misaligned_view(cuda, fwd_symbols):
    q, k, v, _, _ = _flash_inputs(73, 1, 256, 8, 2, 128, torch.bfloat16, False)
    before = fu.fused_attention_fwd.launches
    fu.fused_attention_fwd(q, k, v, causal=True, block_size=256)
    torch.cuda.synchronize()
    assert fu.fused_attention_fwd.launches == before + 1
    assert fwd_symbols == ["atpu_flash_fwd_sm90"]
    # A contiguous view one element into its storage: not 16-byte aligned.
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        fu.fused_attention_fwd(shifted, k, v, causal=True, block_size=256)
    assert fu.fused_attention_fwd.launches == before + 1
    assert fwd_symbols == ["atpu_flash_fwd_sm90"]


def test_flash_fwd_fp32_runs_the_3xtf32_kernel(cuda, fwd_symbols):
    q, k, v, _, valid = _flash_inputs(79, 2, 200, 8, 2, 128, torch.float32, True)
    before = fu.fused_attention_fwd.launches
    out, lse = fu.fused_attention_fwd(q, k, v, valid, causal=True, block_size=200)
    torch.cuda.synchronize()
    assert fwd_symbols == ["atpu_flash_fwd_f32_sm90"]
    assert fu.fused_attention_fwd.launches == before + 1
    want_out, want_lse = fu.fused_attention_fwd_plain(q, k, v, valid, causal=True,
                                                      block_size=200)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("groups", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("s", [64, 100, 129, 200, 1024])
def test_flash_fwd_f32_sm90_edges(cuda, fwd_symbols, s, d, groups, causal):
    """The 3xTF32 forward (128-row CTAs over 64-key tiles; at d 256 64-row
    CTAs whose row groups' two warps split each 32-key tile and merge their
    m, l and O) at S below one tile, across a ragged edge and long, against
    the plain forward at fp32's 1e-4."""
    q, k, v, _, _ = _flash_inputs(167, 2, s, 2 * groups, 2, d, torch.float32, False)
    out, lse = fu.fused_attention_fwd(q, k, v, causal=causal, block_size=s)
    torch.cuda.synchronize()
    assert fwd_symbols == ["atpu_flash_fwd_f32_sm90"]
    want_out, want_lse = fu.fused_attention_fwd_plain(q, k, v, causal=causal, block_size=s)
    assert out.dtype == torch.float32 and torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_flash_fwd_f32_sm90_left_pad_past_a_tile(cuda, fwd_symbols, d, causal):
    """Batch 0 left-padded by 300 keys (its first four 64-key tiles, nine
    32-key tiles at d 256, hold no valid key; under the causal mask its
    first 300 rows admit none), batch 1 all invalid: empty rows output 0
    with lse ~ -1e30, as the plain forward."""
    s, pad = 400, 300
    q, k, v, _, _ = _flash_inputs(173, 2, s, 8, 2, d, torch.float32, False)
    valid = torch.ones(2, s, dtype=torch.int8, device="cuda")
    valid[0, :pad] = 0
    valid[1] = 0
    out, lse = fu.fused_attention_fwd(q, k, v, valid, causal=causal, block_size=s)
    torch.cuda.synchronize()
    assert fwd_symbols == ["atpu_flash_fwd_f32_sm90"]
    want_out, want_lse = fu.fused_attention_fwd_plain(q, k, v, valid, causal=causal,
                                                      block_size=s)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    assert (out[1] == 0).all() and (lse[1] < -1e29).all()
    if causal:
        assert (out[0, :pad] == 0).all() and (lse[0, :, :pad] < -1e29).all()


@pytest.mark.parametrize("d", [96, 256])
def test_flash_fwd_f32_sm90_long_chain(cuda, fwd_symbols, d):
    """S 4096 at 32 q / 32 kv heads, causal and full: O sums 64 (d 256: 128)
    K/V tiles' P.V, each in zeroed accumulators added in fp32, so the
    tensor cores' rounding toward zero does not drift past fp32's 1e-4."""
    q, k, v, _, _ = _flash_inputs(179, 1, 4096, 32, 32, d, torch.float32, False)
    for causal in (True, False):
        out, lse = fu.fused_attention_fwd(q, k, v, causal=causal, block_size=512)
        torch.cuda.synchronize()
        want_out, want_lse = fu.fused_attention_fwd_plain(q, k, v, causal=causal,
                                                          block_size=512)
        torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
        del out, lse, want_out, want_lse
    assert fwd_symbols == ["atpu_flash_fwd_f32_sm90"] * 2


@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_flash_fwd_f32_sm90_is_deterministic(cuda, fwd_symbols, d):
    """Two launches on the same inputs (8 q over 2 kv heads, S 1000 causal,
    batch 0's first 150 keys invalid) give bit-identical out and lse: no
    atomics, and the d-256 warps merge in a fixed order."""
    q, k, v, _, _ = _flash_inputs(181, 2, 1000, 8, 2, d, torch.float32, False)
    valid = torch.ones(2, 1000, dtype=torch.int8, device="cuda")
    valid[0, :150] = 0
    first = fu.fused_attention_fwd(q, k, v, valid, causal=True, block_size=1000)
    second = fu.fused_attention_fwd(q, k, v, valid, causal=True, block_size=1000)
    torch.cuda.synchronize()
    assert fwd_symbols == ["atpu_flash_fwd_f32_sm90"] * 2
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def _dkv_inputs(seed, b, s, groups, d, dtype, causal, valid=None):
    """q/k/v/dO with the saved (out, lse) of the plain forward and δ."""
    q, k, v, do, _ = _flash_inputs(seed, b, s, 2 * groups, 2, d, dtype, False)
    out, lse = fu.fused_attention_fwd_plain(q, k, v, valid, causal=causal, block_size=s)
    return q, k, v, do, out, lse, fu._delta(out, do)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("groups", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("s", [64, 100, 129, 200, 1024])
def test_flash_bwd_dkv_sm90_edges(cuda, fwd_symbols, s, d, groups, dtype, causal):
    """The Hopper dK/dV kernel (128-key CTAs over 64-row Q/dO tiles, at d
    96 each tile a 64-column block beside a 32-column one; at d 256 64-key
    CTAs, the group split over CTAs whose fp32 partials a second kernel sums
    whenever the key tiles alone do not fill the card) at S below one tile,
    across a ragged edge (129: an lse row that is not 16-byte aligned) and
    long, against the plain backward."""
    q, k, v, do, out, lse, delta = _dkv_inputs(83, 2, s, groups, d, dtype, causal)
    before = fu.fused_attention_bwd_dkv.launches
    dk, dv = fu.fused_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert fu.fused_attention_bwd_dkv.launches == before + 1
    assert fwd_symbols == ["atpu_flash_bwd_dkv_sm90_d256" if d == 256 else
                           "atpu_flash_bwd_dkv_sm90"]
    _, want_dk, want_dv = fu.fused_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                                       block_size=s)
    tol = TOL[dtype]
    for got, ref, name in ((dk, want_dk, "dk"), (dv, want_dv, "dv")):
        assert got.dtype == dtype and torch.isfinite(got).all(), name
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol, msg=name)


@pytest.mark.parametrize("d", [128, 96])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_flash_bwd_dkv_sm90_is_deterministic(cuda, fwd_symbols, dtype, d):
    """One CTA owns its keys across the group's query heads (no atomics), so
    two calls agree bit for bit, padded keys included: at d 128 over 8 q / 2
    kv heads at S 300, at d 96 at Phi-3-mini's 32 q / 32 kv heads, B 2 x S
    2048, against the plain backward."""
    b, s, pad = (2, 300, 70) if d == 128 else (2, 2048, 300)
    valid = torch.ones(b, s, dtype=torch.int8, device="cuda")
    valid[0, :pad] = 0
    if d == 128:
        q, k, v, do, out, lse, delta = _dkv_inputs(89, b, s, 4, d, dtype, True, valid)
    else:
        q, k, v, do, _ = _flash_inputs(89, b, s, 32, 32, d, dtype, False)
        out, lse = fu.fused_attention_fwd_plain(q, k, v, valid, causal=True, block_size=512)
        delta = fu._delta(out, do)
    first = fu.fused_attention_bwd_dkv(q, k, v, do, lse, delta, valid, causal=True)
    second = fu.fused_attention_bwd_dkv(q, k, v, do, lse, delta, valid, causal=True)
    torch.cuda.synchronize()
    assert fwd_symbols == ["atpu_flash_bwd_dkv_sm90"] * 2
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    assert (first[0][0, :pad] == 0).all() and (first[1][0, :pad] == 0).all()
    _, want_dk, want_dv = fu.fused_attention_bwd_plain(q, k, v, out, lse, do, valid,
                                                       causal=True, block_size=min(s, 512))
    tol = TOL[dtype]
    for got, ref, name in zip(first, (want_dk, want_dv), ("dk", "dv")):
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol, msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_flash_bwd_dkv_d256_split_is_deterministic(cuda, fwd_symbols, dtype):
    """Gemma-2B's 8 q / 1 kv heads of 256 at B 2 x S 2048, batch 0's first
    300 keys invalid: the query heads split over CTAs (n_split > 1), the
    partials summed in split order, so two calls agree bit for bit, the
    invalid keys get exactly 0, and the result matches the plain backward."""
    b, s, pad = 2, 2048, 300
    valid = torch.ones(b, s, dtype=torch.int8, device="cuda")
    valid[0, :pad] = 0
    q, k, v, do, _ = _flash_inputs(139, b, s, 8, 1, 256, dtype, False)
    out, lse = fu.fused_attention_fwd_plain(q, k, v, valid, causal=True, block_size=512)
    delta = fu._delta(out, do)
    n_split = fu.pick_dkv_split(b, 1, s, 8, fu._sm_count(q.device))
    assert n_split > 1
    first = fu.fused_attention_bwd_dkv(q, k, v, do, lse, delta, valid, causal=True)
    second = fu.fused_attention_bwd_dkv(q, k, v, do, lse, delta, valid, causal=True)
    torch.cuda.synchronize()
    assert fwd_symbols == ["atpu_flash_bwd_dkv_sm90_d256"] * 2
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    assert (first[0][0, :pad] == 0).all() and (first[1][0, :pad] == 0).all()
    _, want_dk, want_dv = fu.fused_attention_bwd_plain(q, k, v, out, lse, do, valid,
                                                       causal=True, block_size=512)
    tol = TOL[dtype]
    for got, ref, name in zip(first, (want_dk, want_dv), ("dk", "dv")):
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol, msg=name)


def test_flash_bwd_dkv_fp32_runs_the_3xtf32_kernel(cuda, fwd_symbols):
    q, k, v, do, out, lse, delta = _dkv_inputs(97, 2, 200, 4, 128, torch.float32, True)
    dk, dv = fu.fused_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True)
    torch.cuda.synchronize()
    assert fwd_symbols == ["atpu_flash_bwd_dkv_f32_sm90"]
    _, want_dk, want_dv = fu.fused_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                                       block_size=200)
    torch.testing.assert_close(dk, want_dk, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dv, want_dv, rtol=1e-4, atol=1e-4)


def test_flash_bwd_dkv_raises_on_misaligned_view_and_launches_nothing(cuda, fwd_symbols):
    q, k, v, do, out, lse, delta = _dkv_inputs(101, 1, 256, 4, 128, torch.bfloat16, True)
    flat = torch.empty(do.numel() + 1, dtype=do.dtype, device="cuda")
    shifted = flat[1:].view(do.shape)
    shifted.copy_(do)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = fu.fused_attention_bwd_dkv.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fu.fused_attention_bwd_dkv(q, k, v, shifted, lse, delta, causal=True)
    assert fu.fused_attention_bwd_dkv.launches == before and fwd_symbols == []


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("groups", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("s", [64, 100, 129, 200, 1024])
def test_flash_bwd_dq_sm90_edges(cuda, fwd_symbols, s, d, groups, dtype, causal):
    """The Hopper dQ kernel (128-row CTAs over 64-key K/V tiles, 32-key at
    d 256; at d 96 each tile a 64-column block beside a 32-column one) at S
    below one CTA, across a ragged edge (129: an lse row that is not 16-byte
    aligned) and long, against the plain backward."""
    q, k, v, do, out, lse, delta = _dkv_inputs(103, 2, s, groups, d, dtype, causal)
    before = fu.fused_attention_bwd_dq.launches
    dq = fu.fused_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert fu.fused_attention_bwd_dq.launches == before + 1
    assert fwd_symbols == ["atpu_flash_bwd_dq_sm90"]
    want_dq = fu.fused_attention_bwd_plain(q, k, v, out, lse, do, causal=causal, block_size=s)[0]
    tol = TOL[dtype]
    assert dq.dtype == dtype and torch.isfinite(dq).all()
    torch.testing.assert_close(dq.float(), want_dq.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [128, 256, 96])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_flash_bwd_dq_sm90_is_deterministic(cuda, fwd_symbols, dtype, d):
    """One CTA owns its query rows (no atomics), so two calls agree bit for
    bit, empty rows included: at d 128 over 8 q / 2 kv heads at S 300, at d
    256 at Gemma-2B's 8 q / 1 kv heads and at d 96 at Phi-3-mini's 32 q / 32
    kv heads, B 2 x S 2048, against the plain backward."""
    b, s, pad = (2, 300, 70) if d == 128 else (2, 2048, 300)
    valid = torch.ones(b, s, dtype=torch.int8, device="cuda")
    valid[0, :pad] = 0
    h, kh = {128: (8, 2), 256: (8, 1), 96: (32, 32)}[d]
    q, k, v, do, _ = _flash_inputs(107, b, s, h, kh, d, dtype, False)
    out, lse = fu.fused_attention_fwd_plain(q, k, v, valid, causal=True, block_size=s)
    delta = fu._delta(out, do)
    first = fu.fused_attention_bwd_dq(q, k, v, do, lse, delta, valid, causal=True)
    second = fu.fused_attention_bwd_dq(q, k, v, do, lse, delta, valid, causal=True)
    torch.cuda.synchronize()
    assert fwd_symbols == ["atpu_flash_bwd_dq_sm90"] * 2
    assert torch.equal(first, second)
    assert (first[0, :pad] == 0).all()
    want_dq = fu.fused_attention_bwd_plain(q, k, v, out, lse, do, valid, causal=True,
                                           block_size=s if d == 128 else 512)[0]
    tol = TOL[dtype]
    torch.testing.assert_close(first.float(), want_dq.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_flash_bwd_dq_sm90_left_pad_past_a_cta(cuda, fwd_symbols, dtype, d, causal):
    """Batch 0 left-padded by 130 keys (past a 128-row CTA and two 64-key
    tiles; under the causal mask its first 130 rows admit no key), batch 1
    all invalid: against the plain backward, with dq exactly 0 on every
    empty row."""
    s, pad = 400, 130
    valid = torch.ones(2, s, dtype=torch.int8, device="cuda")
    valid[0, :pad] = 0
    valid[1] = 0
    q, k, v, do, out, lse, delta = _dkv_inputs(109, 2, s, 4, d, dtype, causal, valid)
    dq = fu.fused_attention_bwd_dq(q, k, v, do, lse, delta, valid, causal=causal)
    torch.cuda.synchronize()
    assert fwd_symbols == ["atpu_flash_bwd_dq_sm90"]
    want_dq = fu.fused_attention_bwd_plain(q, k, v, out, lse, do, valid, causal=causal,
                                           block_size=s)[0]
    tol = TOL[dtype]
    assert torch.isfinite(dq).all()
    torch.testing.assert_close(dq.float(), want_dq.float(), rtol=tol, atol=tol)
    assert (dq[1] == 0).all()
    if causal:
        assert (dq[0, :pad] == 0).all()


def test_flash_bwd_dq_fp32_runs_the_3xtf32_kernel(cuda, fwd_symbols):
    q, k, v, do, out, lse, delta = _dkv_inputs(113, 2, 200, 4, 128, torch.float32, True)
    dq = fu.fused_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
    torch.cuda.synchronize()
    assert fwd_symbols == ["atpu_flash_bwd_dq_f32_sm90"]
    want_dq = fu.fused_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                           block_size=200)[0]
    torch.testing.assert_close(dq, want_dq, rtol=1e-4, atol=1e-4)


def test_flash_bwd_dq_raises_on_misaligned_view_and_launches_nothing(cuda, fwd_symbols):
    q, k, v, do, out, lse, delta = _dkv_inputs(127, 1, 256, 4, 128, torch.bfloat16, True)
    flat = torch.empty(do.numel() + 1, dtype=do.dtype, device="cuda")
    shifted = flat[1:].view(do.shape)
    shifted.copy_(do)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = fu.fused_attention_bwd_dq.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fu.fused_attention_bwd_dq(q, k, v, shifted, lse, delta, causal=True)
    assert fu.fused_attention_bwd_dq.launches == before and fwd_symbols == []


def _f32_backward(q, k, v, do, lse, delta, valid, causal):
    dq = fu.fused_attention_bwd_dq(q, k, v, do, lse, delta, valid, causal=causal)
    dk, dv = fu.fused_attention_bwd_dkv(q, k, v, do, lse, delta, valid, causal=causal)
    torch.cuda.synchronize()
    return dq, dk, dv


def _f32_close(got, q, k, v, do, out, lse, valid, causal, block_size):
    want = fu.fused_attention_bwd_plain(q, k, v, out, lse, do, valid, causal=causal,
                                        block_size=block_size)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("groups", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("s", [64, 100, 129, 200, 1024])
def test_flash_bwd_f32_sm90_edges(cuda, fwd_symbols, s, d, groups, causal):
    """The 3xTF32 dQ (128-row CTAs, 64 at d 256) and dK/dV (64-key CTAs of
    warp pairs; a kv head's query heads split over CTAs whenever the key
    tiles alone do not fill the card, as at 8 q over 2 kv heads) at S below
    one tile, across a ragged edge (129) and long, against the plain
    backward at fp32's 1e-4."""
    q, k, v, do, out, lse, delta = _dkv_inputs(151, 2, s, groups, d, torch.float32, causal)
    got = _f32_backward(q, k, v, do, lse, delta, None, causal)
    assert fwd_symbols == ["atpu_flash_bwd_dq_f32_sm90", "atpu_flash_bwd_dkv_f32_sm90"]
    _f32_close(got, q, k, v, do, out, lse, None, causal, s)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_flash_bwd_f32_sm90_left_pad_is_zero_and_bitwise_repeatable(cuda, fwd_symbols, d,
                                                                   causal):
    """Batch 0's first 150 keys invalid (past a 128-row dQ CTA and two 64-key
    dK/dV CTAs), 8 q over 2 kv heads at S 300: padded keys get exactly zero
    dK and dV, and, causal, padded rows exactly zero dQ; two calls agree bit
    for bit; both match the plain backward."""
    b, s, pad = 2, 300, 150
    valid = torch.ones(b, s, dtype=torch.int8, device="cuda")
    valid[0, :pad] = 0
    q, k, v, do, _ = _flash_inputs(157, b, s, 8, 2, d, torch.float32, False)
    out, lse = fu.fused_attention_fwd_plain(q, k, v, valid, causal=causal, block_size=s)
    delta = fu._delta(out, do)
    first = _f32_backward(q, k, v, do, lse, delta, valid, causal)
    second = _f32_backward(q, k, v, do, lse, delta, valid, causal)
    assert fwd_symbols == ["atpu_flash_bwd_dq_f32_sm90", "atpu_flash_bwd_dkv_f32_sm90"] * 2
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    assert (first[1][0, :pad] == 0).all() and (first[2][0, :pad] == 0).all()
    if causal:
        assert (first[0][0, :pad] == 0).all()
    _f32_close(first, q, k, v, do, out, lse, valid, causal, s)


@pytest.mark.parametrize("d", [128, 256])
def test_flash_bwd_f32_sm90_group_split_is_deterministic(cuda, fwd_symbols, d):
    """Gemma-2B's 8 q / 1 kv heads at B 2 x S 2048, batch 0's first 300 keys
    invalid: the query heads split over CTAs (n_split > 1) whose fp32
    partials the sum kernel adds in split order, so two calls agree bit for
    bit, invalid keys get exactly 0, and dQ, dK, dV match the plain
    backward."""
    b, s, pad = 2, 2048, 300
    valid = torch.ones(b, s, dtype=torch.int8, device="cuda")
    valid[0, :pad] = 0
    q, k, v, do, _ = _flash_inputs(163, b, s, 8, 1, d, torch.float32, False)
    out, lse = fu.fused_attention_fwd_plain(q, k, v, valid, causal=True, block_size=512)
    delta = fu._delta(out, do)
    assert fu.pick_dkv_split(b, 1, s, 8, fu._sm_count(q.device)) > 1
    first = _f32_backward(q, k, v, do, lse, delta, valid, True)
    second = _f32_backward(q, k, v, do, lse, delta, valid, True)
    assert fwd_symbols == ["atpu_flash_bwd_dq_f32_sm90", "atpu_flash_bwd_dkv_f32_sm90"] * 2
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    assert (first[1][0, :pad] == 0).all() and (first[2][0, :pad] == 0).all()
    assert (first[0][0, :pad] == 0).all()
    _f32_close(first, q, k, v, do, out, lse, valid, True, 512)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_train_step_launches_flash_kernels_per_layer(cuda, remat):
    """One training step of a tiny llama on the fused path launches the
    forward kernel once per layer (twice under remat, which recomputes it)
    and each backward kernel once per layer, and the loss matches the same
    step on the kernels' plain versions."""
    from accelerate_tpu_torch import Accelerator

    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, head_dim=64, num_layers=3, remat=remat,
                                 attention_impl="pallas", max_seq_len=256)
    ids = torch.from_numpy(np.random.default_rng(59).integers(0, cfg.vocab_size, (2, 128)))
    batch = {"input_ids": ids.cuda()}
    model = llama.LlamaForCausalLM(cfg, seed=0)
    with torch.no_grad():
        fwd, bwd = fu.fused_attention_fwd, fu.fused_attention_bwd
        fu.fused_attention_fwd, fu.fused_attention_bwd = (fu.fused_attention_fwd_plain,
                                                          fu.fused_attention_bwd_plain)
        try:
            want = llama.loss_fn(model.params, batch, cfg).item()
        finally:
            fu.fused_attention_fwd, fu.fused_attention_bwd = fwd, bwd
    acc = Accelerator()
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-3))
    step = acc.make_train_step(model, opt)
    before = (fu.fused_attention_fwd.launches, fu.fused_attention_bwd_dq.launches,
              fu.fused_attention_bwd_dkv.launches)
    loss = step(batch)
    torch.cuda.synchronize()
    after = (fu.fused_attention_fwd.launches, fu.fused_attention_bwd_dq.launches,
             fu.fused_attention_bwd_dkv.launches)
    layers = cfg.num_layers
    assert tuple(a - b for a, b in zip(after, before)) == ((2 if remat else 1) * layers,
                                                           layers, layers)
    assert abs(loss.item() - want) <= 1e-4 * abs(want)


def test_flash_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v, do, _ = _flash_inputs(53, 1, 128, 4, 2, 64, torch.float32, False)
    with pytest.raises(TypeError, match="k is"):
        fu.fused_attention_fwd(q, k.half(), v)
    with pytest.raises(ValueError, match="head_dim"):
        fu.fused_attention_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                               v[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fu.fused_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="kv_valid"):
        fu.fused_attention_fwd(q, k, v, torch.ones(1, 128, dtype=torch.bool, device="cuda"))
    with pytest.raises(ValueError, match="divisible"):
        fu.fused_attention_fwd(q, k, v, block_size=96)


def test_auto_attention_with_unsupported_head_dim_raises(cuda):
    """``attention_impl="auto"`` at S 1024 on the card takes the kernels
    whatever the head dim, so a head dim they do not take (80; they take
    64, 96, 128 and 256) raises instead of running a plain path."""
    cfg = llama.LlamaConfig.tiny(head_dim=80, num_layers=1, max_seq_len=1024,
                                 attention_impl="auto")
    params = llama.init_params(cfg, seed=0)
    ids = torch.from_numpy(np.random.default_rng(61).integers(0, cfg.vocab_size, (1, 1024)))
    before = fu.fused_attention_fwd.launches
    with pytest.raises(ValueError, match="head_dim 80"):
        llama.apply(params, ids.cuda(), cfg)
    assert fu.fused_attention_fwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_auto_attention_at_head_dim_256_launches_the_three_kernels(cuda, fwd_symbols, dtype):
    """Gemma's head dim on the card: ``attention_impl="auto"`` at S 1024
    runs the forward, dQ and dK/dV kernels once per layer each (fp32 the
    3xTF32 forward, dQ and dK/dV; bf16 the sm90 forward, dQ and d-256
    dK/dV), and
    the loss and gradients match the same step on their plain versions."""
    cfg = llama.LlamaConfig.tiny(head_dim=256, num_layers=2, max_seq_len=1024, dtype=dtype,
                                 num_heads=4, num_kv_heads=1, attention_impl="auto")
    model = llama.LlamaForCausalLM(cfg, seed=0)
    ids = torch.from_numpy(np.random.default_rng(61).integers(0, cfg.vocab_size, (1, 1024)))
    batch = {"input_ids": ids.cuda()}
    before = (fu.fused_attention_fwd.launches, fu.fused_attention_bwd_dq.launches,
              fu.fused_attention_bwd_dkv.launches)
    loss = llama.loss_fn(model.params, batch, cfg)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    after = (fu.fused_attention_fwd.launches, fu.fused_attention_bwd_dq.launches,
             fu.fused_attention_bwd_dkv.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 2)
    assert sorted(set(fwd_symbols)) == (
        ["atpu_flash_bwd_dkv_f32_sm90", "atpu_flash_bwd_dq_f32_sm90", "atpu_flash_fwd_f32_sm90"]
        if dtype == torch.float32 else
        ["atpu_flash_bwd_dkv_sm90_d256", "atpu_flash_bwd_dq_sm90", "atpu_flash_fwd_sm90"])
    fwd, bwd = fu.fused_attention_fwd, fu.fused_attention_bwd
    fu.fused_attention_fwd, fu.fused_attention_bwd = (fu.fused_attention_fwd_plain,
                                                      fu.fused_attention_bwd_plain)
    try:
        want = llama.loss_fn(model.params, batch, cfg)
        want_grads = torch.autograd.grad(want, list(model.parameters()))
    finally:
        fu.fused_attention_fwd, fu.fused_attention_bwd = fwd, bwd
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert abs(loss.item() - want.item()) <= tol * abs(want.item())
    for g, w in zip(grads, want_grads):
        assert ((g - w).abs().max() / w.abs().max()).item() <= tol


@pytest.mark.parametrize("d", [96, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("s", [200, 1024])
def test_flash_wide_heads_ragged_and_long(cuda, fwd_symbols, s, dtype, d):
    """Head dims 96 and 256, S off the 64-row tiles and long, with a
    left-padded and an all-invalid batch: fp32 runs the 3xTF32 forward, dQ
    and dK/dV; bf16 the sm90 forward, dQ and dK/dV (its d-256 kernel at
    256)."""
    _flash_check(131, 2, s, 8, 2, d, dtype, True, True)
    if dtype == torch.float32:
        want = {"atpu_flash_fwd_f32_sm90", "atpu_flash_bwd_dq_f32_sm90",
                "atpu_flash_bwd_dkv_f32_sm90"}
    elif d == 256:
        want = {"atpu_flash_fwd_sm90", "atpu_flash_bwd_dq_sm90", "atpu_flash_bwd_dkv_sm90_d256"}
    else:
        want = {"atpu_flash_fwd_sm90", "atpu_flash_bwd_dq_sm90", "atpu_flash_bwd_dkv_sm90"}
    assert set(fwd_symbols) == want


@pytest.mark.parametrize("dtype", [torch.float32], ids=["fp32"])
def test_flash_d256_fp32_routes_the_backward_to_the_3xtf32_kernels(cuda, fwd_symbols, dtype):
    """At head dim 256 fp32 runs the forward, dQ and dK/dV on
    ``flash_f32_sm90.cu``, against the plain versions."""
    q, k, v, do, out, lse, delta = _dkv_inputs(149, 2, 300, 4, 256, dtype, True)
    dq = fu.fused_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
    got_out, got_lse = fu.fused_attention_fwd(q, k, v, causal=True, block_size=300)
    fu.fused_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True)
    torch.cuda.synchronize()
    assert fwd_symbols == ["atpu_flash_bwd_dq_f32_sm90", "atpu_flash_fwd_f32_sm90",
                           "atpu_flash_bwd_dkv_f32_sm90"]
    want_dq = fu.fused_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                           block_size=300)[0]
    tol = TOL[dtype]
    torch.testing.assert_close(dq.float(), want_dq.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got_out, out, rtol=tol, atol=tol)
    torch.testing.assert_close(got_lse, lse, rtol=tol, atol=tol)



# -- the training loop's data pipeline and checkpoints on the card -----------


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetcher_side_stream_slow_consumer(cuda, depth):
    """The worker copies pinned batches on its own stream while the compute
    stream is held back by a slow consumer; every batch, read on the
    compute stream right after it is handed over, holds its host values
    (a missing stream wait reads a buffer still being copied, a missing
    ``record_stream`` lets the allocator hand a live buffer to the next
    copy)."""
    from torch.utils.data import DataLoader

    from accelerate_tpu_torch.data_loader import prepare_data_loader

    rng = np.random.default_rng(71)
    host = [torch.from_numpy(rng.integers(0, 1000, size=(256, 4096))) for _ in range(12)]
    dl = prepare_data_loader(DataLoader(host, batch_size=None), device="cuda",
                             prefetch_to_device=depth)
    sums, copies, flags = [], [], []
    for batch in dl:
        assert batch.device.type == "cuda"
        torch.cuda._sleep(5_000_000)  # the compute stream lags the copies
        sums.append(batch.sum())
        copies.append(batch * 1)
        flags.append(dl.end_of_dataloader)
        del batch
    torch.cuda.synchronize()
    assert [s.item() for s in sums] == [int(h.sum()) for h in host]
    for got, want in zip(copies, host):
        assert torch.equal(got.cpu(), want)
    assert flags == [False] * 11 + [True]
    assert len(dl.prefetch_blocked_ms) == 12


def test_prefetcher_copies_on_its_own_stream(cuda):
    from accelerate_tpu_torch.pipeline.prefetch import DevicePrefetcher
    from accelerate_tpu_torch.utils.operations import send_to_device

    streams = []

    def convert(b):
        streams.append(torch.cuda.current_stream())
        return send_to_device(b, "cuda", non_blocking=True)

    pre = DevicePrefetcher(iter([torch.ones(4), torch.zeros(4)]), convert, depth=1,
                           device=torch.device("cuda"))
    out = [(b.sum().item(), last) for b, last in pre]
    assert out == [(4.0, False), (0.0, True)]
    assert streams and all(s == pre._stream for s in streams)
    assert pre._stream != torch.cuda.current_stream()


def test_safetensors_bf16_roundtrip_of_cuda_tensors(cuda, tmp_path):
    from accelerate_tpu_torch.utils import safetensors_io

    gen = torch.Generator(device="cuda").manual_seed(3)
    src = {"w": torch.randn(64, 33, generator=gen, device="cuda").bfloat16(),
           "b": torch.randn(7, generator=gen, device="cuda"),
           "ids": torch.arange(5, device="cuda")}
    path = str(tmp_path / "w.safetensors")
    safetensors_io.save_file(src, path)
    back = safetensors_io.load_file(path, device="cuda")
    for k, v in src.items():
        assert back[k].device.type == "cuda" and back[k].dtype == v.dtype
        assert torch.equal(back[k], v)


def _card_run(tmp_path, resume, seed, data):
    from torch.utils.data import DataLoader

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.utils.dataclasses import (
        DataLoaderConfiguration,
        ProjectConfiguration,
    )

    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
                            attention_impl="pallas", dtype=torch.bfloat16, remat=True)
    acc = Accelerator(gradient_accumulation_steps=2, dataloader_config=DataLoaderConfiguration(
        use_seedable_sampler=True, use_stateful_dataloader=True, prefetch_to_device=2),
        project_config=ProjectConfiguration(project_dir=str(tmp_path),
                                            automatic_checkpoint_naming=True, total_limit=2))
    model = llama.LlamaForCausalLM(cfg, seed=seed)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda n: min(1.0, (n + 1) / 3))
    model, opt, dl, sched = acc.prepare(model, opt, DataLoader(data, batch_size=2, shuffle=True),
                                        sched)
    step = acc.resume_from_latest() if resume else None
    before = (fu.fused_attention_fwd.launches, fu.fused_attention_bwd_dq.launches,
              fu.fused_attention_bwd_dkv.launches)
    losses, micro = [], 0
    for batch in dl:
        assert batch["input_ids"].device.type == "cuda"
        with acc.accumulate(model):
            loss = model(**batch)["loss"]
            acc.backward(loss)
            opt.step()
            sched.step()
            opt.zero_grad()
        losses.append(loss.item())
        micro += 1
        if not resume and acc.sync_gradients and opt._step_count == 2:
            acc.save_state(step=2)
    after = (fu.fused_attention_fwd.launches, fu.fused_attention_bwd_dq.launches,
             fu.fused_attention_bwd_dkv.launches)
    counts = tuple(a - b for a, b in zip(after, before))
    assert counts == (2 * 2 * micro, 2 * micro, 2 * micro)  # 2L / L / L per micro-batch
    return step, losses, model, opt


def test_save_load_continue_is_bit_identical_on_the_card(cuda, tmp_path):
    """The README loop on the kernel path (7 micro-batches, accumulation 2,
    a checkpoint after optimizer step 2); a fresh run from another seed
    resumes from it and ends bit-identical to the uninterrupted run."""
    rng = np.random.default_rng(0)
    data = [{"input_ids": torch.from_numpy(rng.integers(0, 512, size=128))} for _ in range(14)]
    _, losses_a, model_a, opt_a = _card_run(tmp_path, False, 0, data)
    assert opt_a._step_count == 4
    step, losses_b, model_b, opt_b = _card_run(tmp_path, True, 1, data)
    assert step == 2 and losses_b == losses_a[4:]
    for a, b in zip(model_a.parameters(), model_b.parameters()):
        assert torch.equal(a, b)
    sa, sb = opt_a.optimizer.state_dict()["state"], opt_b.optimizer.state_dict()["state"]
    for k in sa:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k][name], sb[k][name])


# ---------------------------------------------------------------------------
# The serving engine's host tier and int8 pools on the card (``-k tier``)
# ---------------------------------------------------------------------------


def _tier_cache(quant, dtype, num_blocks=12, host_blocks=6):
    from accelerate_tpu_torch.serving.blocks import PagedKVCache

    cfg = llama.LlamaConfig.tiny(dtype=dtype, kv_cache_quant=quant)
    kv = PagedKVCache(llama.init_cache, cfg, num_blocks, 16, "cuda", num_host_blocks=host_blocks)
    gen = torch.Generator(device="cuda").manual_seed(5)
    for leaf in kv.pool.values():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen, device="cuda"))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    return kv


@pytest.mark.parametrize("quant,dtype", [(False, torch.bfloat16), (False, torch.float32),
                                         (True, torch.float32)], ids=["bf16", "fp32", "int8"])
def test_tier_round_trip_is_bit_exact(cuda, quant, dtype):
    kv = _tier_cache(quant, dtype)
    assert all(leaf.is_pinned() for leaf in kv.host.leaves.values())
    blocks = kv.allocator.alloc(4)
    before = {n: leaf[:, blocks].clone() for n, leaf in kv.pool.items()}
    host_ids = kv.demote(blocks)
    kv.allocator.free(blocks)
    for leaf in kv.pool.values():
        leaf[:, blocks] = 0
    dst = kv.allocator.alloc(4)[::-1]
    kv.promote(host_ids, dst)
    for n, leaf in kv.pool.items():
        assert torch.equal(leaf[:, dst], before[n]), n
    assert kv.host.used_blocks == 0


def test_tier_promote_then_reuse_of_its_host_ids_lands_the_right_bytes(cuda):
    """A promote whose copy is queued behind a busy stream, followed at once
    by a demote into the same (LIFO-reused) host ids and a dirty free of
    them: the promoted blocks still hold the demoted bytes."""
    kv = _tier_cache(False, torch.bfloat16)
    src = kv.allocator.alloc(3)
    want = {n: leaf[:, src].clone() for n, leaf in kv.pool.items()}
    host_ids = kv.demote(src)
    kv.allocator.free(src)
    other = kv.allocator.alloc(3)
    for leaf in kv.pool.values():
        leaf[:, other] = -1
    dst = kv.allocator.alloc(3)
    torch.cuda._sleep(50_000_000)  # keep the stream busy past the host's next steps
    kv.promote(host_ids, dst)
    again = kv.demote(other)
    assert sorted(again) == sorted(host_ids)
    kv.host.mark_dirty(again)
    kv.host.free(again)
    torch.cuda.synchronize()
    for n, leaf in kv.pool.items():
        assert torch.equal(leaf[:, dst], want[n]), n


@pytest.mark.parametrize("t", [1, 4])
def test_apply_paged_int8_pool_runs_no_kernel(cuda, t):
    """An int8 pool takes the plain path under ``kernel=True`` (the JAX
    package's kernels read fp pools only): no launch, the same logits and
    rows as ``kernel=False``."""
    from accelerate_tpu_torch.models.generation import make_paged_pool

    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, kv_cache_quant=True)
    params = llama.init_params(cfg, seed=0, device="cuda")
    pool = make_paged_pool(llama.init_cache, cfg, 10, 16, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for n, leaf in pool.items():
        leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen, device="cuda")
                   if leaf.dtype == torch.int8 else torch.rand(leaf.shape, generator=gen,
                                                               device="cuda") * 0.05)
    tables = torch.tensor([[1, 4, 7], [2, 3, 0], [9, 8, 6]], dtype=torch.int32, device="cuda")
    starts = torch.tensor([20, 2, 40], dtype=torch.int32, device="cuda")
    ids = torch.randint(0, cfg.vocab_size, (3, t), generator=gen, device="cuda")
    before = (pa.paged_attention.launches, pa.paged_window_attention.launches)
    lk, rk = llama.apply_paged(params, ids, cfg, pool, tables, starts, kernel=True)
    assert (pa.paged_attention.launches, pa.paged_window_attention.launches) == before
    lp, rp = llama.apply_paged(params, ids, cfg, pool, tables, starts, kernel=False)
    assert torch.equal(lk, lp) and all(torch.equal(rk[n], rp[n]) for n in rp)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_tiered_engine_on_the_card_matches_generate(cuda, quant):
    from accelerate_tpu_torch.serving import ServingConfig, ServingEngine

    # head_dim 64: the smallest the paged kernels take.
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, head_dim=64, kv_cache_quant=quant)
    params = llama.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=n)) for n in (9, 13, 9)]
    max_new = (8, 6, 7)
    eng = ServingEngine(llama.apply_cached, llama.init_cache, params, cfg, device="cuda",
                        serving=ServingConfig(block_size=4, num_blocks=8, max_slots=3,
                                              prefill_chunk=4, max_blocks_per_seq=6,
                                              host_blocks=16, paged_kernel=True))
    before = pa.paged_attention.launches
    ids = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
    out = eng.run(max_ticks=3000)
    launches = pa.paged_attention.launches - before
    for rid, p, m in zip(ids, prompts, max_new):
        want = llama.generate(params, torch.tensor([p], device="cuda"), cfg, m)[0].tolist()
        assert out[rid] == want
    st = eng.stats()
    assert st["tiering"]["demotions"] > 0 and st["tiering"]["promotions"] > 0
    assert launches == (0 if quant else cfg.num_layers * st["decode_dispatches"])
    assert eng.cache.allocator.used_blocks == 0


# ---------------------------------------------------------------------------
# Sampling, the draft-model drafter and tracing on the card
# ---------------------------------------------------------------------------


def test_sampling_on_the_card_is_reproducible_and_equals_the_cpu(cuda):
    """The port's key draws on the host, so one key gives the same noise on
    the CPU and the card: the card's sampled tokens repeat under the same
    key, move under another, and in fp32 equal the CPU run's."""
    from accelerate_tpu_torch.utils.random import PRNGKey

    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, head_dim=64)
    params = llama.init_params(cfg, seed=3, device="cuda")
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, size=(3, 7)))
    kw = dict(temperature=0.8, top_k=50, top_p=0.9)
    a = llama.generate(params, ids.cuda(), cfg, 16, key=PRNGKey(11), **kw)
    b = llama.generate(params, ids.cuda(), cfg, 16, key=PRNGKey(11), **kw)
    c = llama.generate(params, ids.cuda(), cfg, 16, key=PRNGKey(12), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    cpu_params = {k: (v.cpu() if torch.is_tensor(v) else {n: t.cpu() for n, t in v.items()})
                  for k, v in params.items()}
    ref = llama.generate(cpu_params, ids, cfg, 16, key=PRNGKey(11), **kw)
    assert torch.equal(a.cpu(), ref)


def test_log_of_the_fill_floor_is_finite_on_the_card(cuda):
    """``log(p + 1e-38)`` of a zero probability: 1e-38 is an fp32
    subnormal, and the card's kernels keep it (no flush to zero)."""
    z = torch.zeros(4, device="cuda") + 1e-38
    assert bool((z > 0).all())
    assert torch.allclose(torch.log(z), torch.full_like(z, float(np.log(1e-38))), rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_draft_model_drafter_through_the_fused_kernel(cuda, dtype):
    """A feed of 1003 tokens pads to a 1024 bucket, where ``llama.apply``
    runs the fused forward kernel (head dim 64; bf16 on the sm90 body) with
    the padding masked through ``kv_valid``.  Against the same drafter over
    the kernel's plain version: fp32 proposals are equal; in bf16 the last
    real row's logits agree to 5e-2 (two layers of bf16 rounding on top of
    the kernel's 2e-2) and so does the proposal wherever the plain top two
    logits are further apart than that."""
    from accelerate_tpu_torch.serving import DraftModelDrafter

    cfg = llama.LlamaConfig.tiny(dtype=dtype, head_dim=64, max_seq_len=2048)
    params = llama.init_params(cfg, seed=5, device="cuda")
    feed = [int(t) for t in np.random.default_rng(6).integers(0, cfg.vocab_size, size=1003)]
    drafter = DraftModelDrafter(llama.apply, params, cfg)
    ids = torch.zeros((1, 1024), dtype=torch.long, device="cuda")
    ids[0, :len(feed)] = torch.tensor(feed)
    mask = (torch.arange(1024, device="cuda") < len(feed))[None]
    before = fu.fused_attention_fwd.launches
    got = drafter.propose(feed, 3)
    assert fu.fused_attention_fwd.launches - before == 3 * cfg.num_layers
    with torch.no_grad():
        lk = llama.apply(params, ids, cfg, attention_mask=mask)[0, len(feed) - 1]
    saved = fu.fused_attention_fwd
    fu.fused_attention_fwd = fu.fused_attention_fwd_plain
    try:
        want = drafter.propose(feed, 3)
        with torch.no_grad():
            lp = llama.apply(params, ids, cfg, attention_mask=mask)[0, len(feed) - 1]
    finally:
        fu.fused_attention_fwd = saved
    if dtype == torch.float32:
        assert got == want
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
        return
    torch.testing.assert_close(lk, lp, atol=5e-2, rtol=5e-2)
    top2 = torch.topk(lp, 2).values
    if float(top2[0] - top2[1]) > 5e-2:
        assert got[0] == want[0]


def test_tracing_on_a_paged_kernel_engine(cuda, tmp_path):
    """Tracing on (the default) with the paged kernels and speculation:
    tokens equal greedy ``generate``, every request's intervals are
    disjoint inside its window, verify intervals are recorded, and the
    Chrome export is written."""
    import json

    from accelerate_tpu_torch.serving import ServingConfig, ServingEngine, load_serving_traces

    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, head_dim=64)
    params = llama.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(9)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=n)) for n in (9, 13, 5)]
    eng = ServingEngine(llama.apply_cached, llama.init_cache, params, cfg, device="cuda",
                        serving=ServingConfig(block_size=4, num_blocks=24, max_slots=2,
                                              prefill_chunk=8, max_blocks_per_seq=8,
                                              paged_kernel=True, spec_tokens=2,
                                              trace_dir=str(tmp_path)))
    assert eng.tracer is not None
    ids = [eng.submit(p, 6) for p in prompts]
    out = eng.run(max_ticks=500)
    for rid, p in zip(ids, prompts):
        assert out[rid] == llama.generate(params, torch.tensor([p], device="cuda"), cfg,
                                          6)[0].tolist()
    traces = list(eng.tracer.completed)
    assert len(traces) == 3
    for t in traces:
        for prev, cur in zip(t.intervals, t.intervals[1:]):
            assert cur.start >= prev.end
        assert t.unattributed_ms() >= 0.0 and t.intervals[-1].end <= t.finish
    assert any(iv.phase == "verify" for t in traces for iv in t.intervals)
    path = eng.export_chrome_trace(str(tmp_path / "card.trace.json"))
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    assert len(load_serving_traces(str(tmp_path))) == 3


@pytest.fixture
def fresh_state():
    """The port's shared ``AcceleratorState`` reset around a test that
    names a ``mixed_precision``."""
    from accelerate_tpu_torch import AcceleratorState

    AcceleratorState._reset_state(reset_partial_state=True)
    yield
    AcceleratorState._reset_state(reset_partial_state=True)


def _flash_counts():
    return (fu.fused_attention_fwd.launches, fu.fused_attention_bwd_dq.launches,
            fu.fused_attention_bwd_dkv.launches)


def test_accelerator_without_arguments_places_on_cuda(cuda, fresh_state):
    from accelerate_tpu_torch import Accelerator

    acc = Accelerator()
    assert acc.device.type == "cuda" and acc.state.device.type == "cuda"
    model = acc.prepare(torch.nn.Linear(4, 4))
    assert next(model.parameters()).device.type == "cuda"
    with pytest.raises(ValueError, match="already initialized on cuda"):
        Accelerator(cpu=True)


def test_bf16_policy_forward_launches_the_sm90_flash_forward(cuda, fresh_state, fwd_symbols):
    """A tiny llama (bf16 compute, fp32 parameters) under
    ``mixed_precision="bf16"``: the forward runs the Hopper flash kernel
    (``atpu_flash_fwd_sm90``) once per layer; the loss comes back in fp32."""
    from accelerate_tpu_torch import Accelerator, PreparedModel

    cfg = llama.LlamaConfig.tiny(dtype=torch.bfloat16, head_dim=64, num_layers=2,
                                 attention_impl="pallas", max_seq_len=256)
    acc = Accelerator(mixed_precision="bf16")
    model = acc.prepare(llama.LlamaForCausalLM(cfg, seed=0))
    assert isinstance(model, PreparedModel)
    ids = torch.from_numpy(np.random.default_rng(61).integers(0, cfg.vocab_size, (2, 128)))
    before = _flash_counts()
    with torch.no_grad():
        loss = model(input_ids=ids.cuda())["loss"]
    torch.cuda.synchronize()
    assert _flash_counts()[0] - before[0] == cfg.num_layers
    assert fwd_symbols == ["atpu_flash_fwd_sm90"] * cfg.num_layers
    assert loss.dtype == torch.float32 and torch.isfinite(loss)


def test_dots_and_nothing_launch_alike_and_give_one_loss(cuda, fresh_state):
    """2 layers at S 1024 under the bf16 policy: both remat policies launch
    the forward kernel 2L times per step (the fused kernel sits inside an
    ``autograd.Function`` whose launch no selective policy can keep) and
    the backward kernels L times each, and give the same loss and
    gradients bit for bit."""
    import dataclasses

    from accelerate_tpu_torch import Accelerator

    base = llama.LlamaConfig.tiny(dtype=torch.bfloat16, head_dim=64, num_layers=2, remat=True,
                                  max_seq_len=1024)
    ids = torch.from_numpy(np.random.default_rng(67).integers(0, base.vocab_size, (2, 1024)))
    out = {}
    for policy in ("nothing", "dots"):
        cfg = dataclasses.replace(base, remat_policy=policy)
        acc = Accelerator(mixed_precision="bf16")
        inner = llama.LlamaForCausalLM(cfg, seed=0)
        model = acc.prepare(inner)
        before = _flash_counts()
        loss = model(input_ids=ids.cuda())["loss"]
        acc.backward(loss)
        torch.cuda.synchronize()
        counts = tuple(a - b for a, b in zip(_flash_counts(), before))
        out[policy] = (counts, loss.item(), [p.grad for p in inner.parameters()])
        acc.free_memory()
    layers = base.num_layers
    assert out["dots"][0] == out["nothing"][0] == (2 * layers, layers, layers)
    assert out["dots"][1] == out["nothing"][1]
    assert all(torch.equal(a, b) for a, b in zip(out["dots"][2], out["nothing"][2]))


# ---------------------------------------------------------------------------
# GPT-2: one kv head per query head through the paged kernels, its engine,
# and find_executable_batch_size on a real CUDA OOM
# ---------------------------------------------------------------------------


@pytest.mark.paged
@pytest.mark.parametrize("window", [None, 1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["fp32", "bf16", "fp16"])
def test_paged_kernels_at_gpt2_xl_heads_match_plain(cuda, dtype, window):
    """GPT-2 XL's geometry: 25 query heads over 25 kv heads (G = 1, one row
    of a 16-row tile at decode), head dim 64, an odd head count."""
    args = _inputs(107, 25, 1, window, dtype, d=64, lengths=(0, 1, 15, 16, 17, 300, 1000),
                   m=64)
    fn, plain = _fns(window)
    before = fn.launches
    got = fn(**args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == args["q"].shape and torch.isfinite(got).all()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), plain(**args).float(), rtol=tol, atol=tol)


@pytest.mark.paged
@pytest.mark.parametrize("window", [None, 1, 4])
@pytest.mark.parametrize("heads", [(32, 4), (4, 1)], ids=["llama3-70b-tp2", "tiny-kv2-tp2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_paged_kernels_at_a_tp_ranks_heads_match_plain(cuda, dtype, heads, window):
    """A ``tp=2`` rank's heads, as the sharded ``apply_paged`` hands them to
    the kernels: Llama-3-70B's 64 / 8 heads give a rank 32 / 4 (G 8), and a
    model of 8 / 2 heads gives 4 / 1; head dim 128."""
    q_heads, kv = heads
    args = _inputs(122, kv, q_heads // kv, window, dtype, lengths=(0, 1, 15, 16, 17, 300, 1000),
                   m=64)
    fn, plain = _fns(window)
    before = fn.launches
    got = fn(**args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == args["q"].shape and torch.isfinite(got).all()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), plain(**args).float(), rtol=tol, atol=tol)


def test_pool_at_a_ranks_width_is_contiguous_and_aligned(cuda):
    """The engine's pool on a ``tp=2`` rank is built at the rank's width
    (``init_cache(..., layout=)``), never sliced from a whole pool: every
    layer's K/V is a contiguous, 16-byte-aligned ``[N, bs, K / tp, hd]``
    that the decode kernel reads as it is, against its plain version."""
    import types

    from accelerate_tpu_torch.models.generation import make_paged_pool
    from accelerate_tpu_torch.parallel.sharding import Layout

    class RankOfTp2(Layout):  # a rank's coordinates on tp=2, without a process group
        def __init__(self, rank):
            super().__init__(types.SimpleNamespace(shape={"fsdp": 1, "tp": 2, "ep": 1}), None)
            self._rank = rank

        tp = property(lambda self: 2)
        tp_rank = property(lambda self: self._rank)

    cfg = llama.LlamaConfig.llama3_70b(num_layers=3, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for rank in (0, 1):
        layout = RankOfTp2(rank)
        assert llama.kv_head_ids(cfg, layout) == [4 * rank + j for j in range(4)]
        pool = make_paged_pool(lambda c, b, n, device: llama.init_cache(c, b, n, device, layout),
                               cfg, 9, 16, "cuda")
        for leaf in pool.values():
            assert tuple(leaf.shape) == (3, 9, 16, 4, 128)
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
        tables = torch.tensor([[3, 1, 4, 0], [2, 5, 6, 7]], dtype=torch.int32, device="cuda")
        lengths = torch.tensor([40, 60], dtype=torch.int32, device="cuda")
        q = torch.randn((2, 32, 128), generator=gen, device="cuda").to(torch.bfloat16)
        k_new = torch.randn((2, 4, 128), generator=gen, device="cuda").to(torch.bfloat16)
        v_new = torch.randn((2, 4, 128), generator=gen, device="cuda").to(torch.bfloat16)
        for i in range(3):
            pk, pv = pool["k"][i], pool["v"][i]
            assert pk.is_contiguous() and pk.data_ptr() % 16 == 0 and pv.data_ptr() % 16 == 0
            got = pa.paged_attention(q, k_new, v_new, pk, pv, tables, lengths)
            want = pa.paged_attention_plain(q, k_new, v_new, pk, pv, tables, lengths)
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_gpt2_apply_paged_kernel_launches_per_layer_and_matches_plain(cuda):
    """Tiny GPT-2 (head dim 64) in fp32: a decode forward launches the decode
    kernel once per layer, a verify forward the window kernel once per
    layer, and both match the plain einsum path."""
    from accelerate_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32, hidden_size=128, num_heads=2, num_layers=3)
    params = gpt2.init_params(cfg, seed=0)
    rng = np.random.default_rng(43)
    shape = (cfg.num_layers, 12, 4, cfg.num_heads, cfg.head_dim)
    pool = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
            for k in ("k", "v")}
    tables = torch.tensor([[3, 5, 0, 0], [0, 0, 0, 0], [1, 2, 4, 6]], dtype=torch.int32).cuda()
    starts = torch.tensor([6, 0, 12], dtype=torch.int32, device="cuda")
    for t, fn in ((1, pa.paged_attention), (4, pa.paged_window_attention)):
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, t))).cuda()
        before = fn.launches
        got, rows = gpt2.apply_paged(params, ids, cfg, pool, tables, starts, kernel=True)
        assert fn.launches == before + cfg.num_layers
        want, want_rows = gpt2.apply_paged(params, ids, cfg, pool, tables, starts, kernel=False)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(rows["k"], want_rows["k"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("spec_tokens", [0, 3])
def test_gpt2_engine_on_the_card_matches_generate(cuda, spec_tokens):
    from accelerate_tpu_torch.models import gpt2
    from accelerate_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32, hidden_size=128, num_heads=2)
    params = gpt2.init_params(cfg, seed=0)
    rng = np.random.default_rng(47)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=n)) for n in (9, 13, 5)]
    prompts.append([5, 9, 2, 7] * 3)
    max_new = (8, 6, 7, 9)
    eng = ServingEngine(gpt2.apply_cached, gpt2.init_cache, params, cfg, device="cuda",
                        serving=ServingConfig(block_size=4, num_blocks=24, max_slots=3,
                                              prefill_chunk=4, max_blocks_per_seq=8,
                                              paged_kernel=True, spec_tokens=spec_tokens))
    fn = pa.paged_window_attention if spec_tokens else pa.paged_attention
    before = fn.launches
    ids = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
    out = eng.run(max_ticks=3000)
    for rid, p, m in zip(ids, prompts, max_new):
        want = gpt2.generate(params, torch.tensor([p], device="cuda"), cfg, m)[0].tolist()
        assert out[rid] == want
    assert fn.launches - before == cfg.num_layers * eng.stats()["decode_dispatches"] > 0
    assert eng.cache.allocator.used_blocks == 0


def test_find_executable_batch_size_survives_a_cuda_oom(cuda):
    """Each batch row takes a third of the free device memory, so 16, 8 and
    4 rows raise a real ``torch.cuda.OutOfMemoryError`` and the retry at 2
    runs; the failed attempts leave nothing allocated."""
    import gc

    from accelerate_tpu_torch.utils import find_executable_batch_size

    gc.collect()  # earlier tests' cycles: the decorator collects them too
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    unit = torch.cuda.mem_get_info()[0] // 3
    tried, ooms = [], []

    @find_executable_batch_size(starting_batch_size=16)
    def step(batch_size):
        tried.append(batch_size)
        try:
            x = torch.ones(batch_size * unit, dtype=torch.uint8, device="cuda")
        except torch.cuda.OutOfMemoryError:
            ooms.append(batch_size)
            raise
        return batch_size if int(x[-1]) == 1 else -1

    assert step() == 2
    assert tried == [16, 8, 4, 2] and ooms == [16, 8, 4]
    assert torch.cuda.memory_allocated() == start


# --------------------------------------------------------------------------
# Mixtral's MoE and training step, and the encoder families, on the card
# --------------------------------------------------------------------------


def _moe_weights(seed, d=64, f=96, e=4):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*shape, generator=g) * scale for shape, scale in
            (((2, 40, d), 1.0), ((d, e), 1.0), ((e, d, f), d ** -0.5), ((e, d, f), d ** -0.5),
             ((e, f, d), f ** -0.5))]


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda, ragged, dtype):
    """The same call on CUDA and CPU tensors: routing in fp32 (the same
    experts picked), the experts in ``dtype``, a capacity that drops tokens
    on the dense path."""
    from accelerate_tpu_torch.ops import moe

    args = _moe_weights(1)
    kw = dict(compute_dtype=dtype)
    if not ragged:
        kw["capacity"] = 12
    fn = moe.moe_ffn_ragged if ragged else moe.moe_ffn
    y_cpu, aux_cpu = fn(*args, **kw)
    y, aux = fn(*(a.cuda() for a in args), **kw)
    tol = TOL[dtype]
    torch.testing.assert_close(y.cpu(), y_cpu, atol=tol, rtol=tol)
    for k in aux:
        torch.testing.assert_close(aux[k].cpu(), aux_cpu[k], atol=1e-5, rtol=1e-5)
    if not ragged:
        assert aux["fraction_dropped"].item() > 0


def test_tiny_mixtral_step_on_the_kernels_matches_the_plain_path(cuda):
    """A tiny Mixtral (head dim 64, S 1024, so the fused path) in fp32: loss
    and every gradient through the flash kernels against their plain
    versions, within 1e-4 relative; the kernels launched 2L / L / L."""
    from accelerate_tpu_torch.models import mixtral

    cfg = mixtral.MixtralConfig.tiny(hidden_size=128, num_heads=2, num_kv_heads=1,
                                     max_seq_len=1024, dtype=torch.float32, remat=True)
    params = {k: (v.requires_grad_() if not isinstance(v, dict) else
                  {kk: vv.requires_grad_() for kk, vv in v.items()})
              for k, v in mixtral.init_params(cfg, seed=0).items()}
    leaves = [v for k, v in params.items() if k != "layers"] + list(params["layers"].values())
    ids = torch.randint(0, cfg.vocab_size, (2, 1024), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(3))
    before = [getattr(fu, n).launches for n in ("fused_attention_fwd", "fused_attention_bwd_dq",
                                                "fused_attention_bwd_dkv")]
    loss = mixtral.loss_fn(params, {"input_ids": ids}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    after = [getattr(fu, n).launches for n in ("fused_attention_fwd", "fused_attention_bwd_dq",
                                               "fused_attention_bwd_dkv")]
    L = cfg.num_layers
    assert [a - b for a, b in zip(after, before)] == [2 * L, L, L]
    saved = fu.fused_attention_fwd, fu.fused_attention_bwd
    fu.fused_attention_fwd, fu.fused_attention_bwd = (fu.fused_attention_fwd_plain,
                                                      fu.fused_attention_bwd_plain)
    try:
        loss_p = mixtral.loss_fn(params, {"input_ids": ids}, cfg)
        grads_p = torch.autograd.grad(loss_p, leaves)
    finally:
        fu.fused_attention_fwd, fu.fused_attention_bwd = saved
    assert abs(loss.item() - loss_p.item()) <= 1e-4 * abs(loss_p.item())
    for g, gp in zip(grads, grads_p):
        assert ((g - gp).abs().max() / gp.abs().max()).item() <= 1e-4


@pytest.mark.parametrize("family", ["bert", "vit", "resnet", "t5"])
def test_encoder_forward_on_the_card_matches_the_cpu(cuda, family):
    """One fp32 forward of each family's tiny config on the card (cuBLAS,
    cuDNN convolutions on channels-last views) against the CPU."""
    import importlib

    mod = importlib.import_module(f"accelerate_tpu_torch.models.{family}")
    cfg_cls = {"bert": "BertConfig", "vit": "ViTConfig", "resnet": "ResNetConfig",
               "t5": "T5Config"}[family]
    kw = dict(block="bottleneck", stem="imagenet") if family == "resnet" else {}
    cfg = getattr(mod, cfg_cls).tiny(dtype=torch.float32, **kw)
    params = mod.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(4)
    if family == "bert":
        args = (torch.randint(0, cfg.vocab_size, (2, 16), generator=g),)
    elif family == "t5":
        args = (torch.randint(0, cfg.vocab_size, (2, 16), generator=g),
                torch.randint(0, cfg.vocab_size, (2, 5), generator=g))
    else:
        args = (torch.randn(2, 32, 32, 3, generator=g),)
    if family == "resnet":
        stats = mod.init_batch_stats(cfg, device="cpu")
        want, want_stats = mod.apply(params, stats, *args, cfg, train=True)
        got, got_stats = mod.apply(_to(params, "cuda"), _to(stats, "cuda"),
                                   *(a.cuda() for a in args), cfg, train=True)
        for k in want_stats["stage0"]["head"]:
            torch.testing.assert_close(got_stats["stage0"]["head"][k].cpu(),
                                       want_stats["stage0"]["head"][k], atol=1e-5, rtol=1e-5)
    else:
        want = mod.apply(params, *args, cfg)
        got = mod.apply(_to(params, "cuda"), *(a.cuda() for a in args), cfg)
        if family != "t5":
            want, got = want[1], got[1]  # the pooled output
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Telemetry on the card
# ---------------------------------------------------------------------------


def test_telemetry_memory_readers_match_the_allocator(cuda):
    """``collect_hbm`` and the ledger read the caching allocator: the
    ``hbm.*`` gauges equal ``memory_stats``, a reconcile conserves exactly
    against ``memory_allocated``, and a storage counts once with its views
    while a pinned host tensor counts as host bytes."""
    from accelerate_tpu_torch import telemetry
    from accelerate_tpu_torch.telemetry import memledger

    base = torch.zeros(1024, 256, device="cuda")
    tree = {"w": base, "view": base[:7], "t": base.t(),
            "host": torch.zeros(100, dtype=torch.uint8).pin_memory()}
    per_device, host, n = memledger.tree_device_bytes(tree)
    assert (per_device, host, n) == ({torch.cuda.current_device(): 1024 * 256 * 4}, 100, 4)
    led = memledger.MemoryLedger()
    led.register("w", tree=tree)
    reg = telemetry.MetricsRegistry()
    hbm = telemetry.collect_hbm(reg)
    stats = torch.cuda.memory_stats()
    assert hbm["hbm.bytes_in_use"] == stats["allocated_bytes.all.current"]
    assert hbm["hbm.peak_bytes"] == stats["allocated_bytes.all.peak"]
    (rec,) = [r for r in led.reconcile() if r["device"] == torch.cuda.current_device()]
    assert rec["attributed_bytes"] + rec["unattributed_bytes"] == rec["bytes_in_use"] \
        == torch.cuda.memory_allocated()


def test_telemetry_hooks_add_no_device_sync(cuda, tmp_path):
    """A span, a completed step (step timer, device memory gauges, the
    ledger's reconcile) and ``collect_hbm`` under the sync debug mode
    "error": torch raises if any of them synchronizes the card."""
    from accelerate_tpu_torch import telemetry
    from accelerate_tpu_torch.telemetry import memledger

    tel = telemetry.enable(dir=str(tmp_path))
    try:
        memledger.get_memory_ledger().register("x", tree=torch.zeros(8, device="cuda"))
        x = torch.randn(512, 512, device="cuda")
        tel.record_step()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with telemetry.span("optimizer.step"):
                y = x @ x
            tel.record_step()
            telemetry.collect_hbm(tel.registry)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert tel.registry.snapshot()["step.count"] == 2 and y.shape == (512, 512)
    finally:
        telemetry.disable()
        memledger.get_memory_ledger().unregister("x")


# -- several processes: the ZeRO shard layout and the canonical norm ------------

@pytest.mark.parametrize("degree", [2, 4, 8])
def test_zero_shards_and_chunked_norm_on_the_card_match_the_cpu(cuda, degree):
    """``chunked_global_norm`` and the ZeRO shard geometry (each chunk of a
    leaf, moved to the front and back as the reduce-scatter buffer does) on
    ``cuda`` against the CPU; one process, no group.  The norm within 1e-6
    relative (the card sums each chunk in its own order), the chunks exact."""
    from accelerate_tpu_torch.parallel import zero

    gen = torch.Generator().manual_seed(degree)
    shapes = [(4096, 14336), (1024, 4096), (4096,), (5,), (3, 8, 16), (7, 11)]
    tree = [torch.randn(s, generator=gen) for s in shapes]
    want = float(zero.chunked_global_norm(tree, degree))
    got = float(zero.chunked_global_norm([t.to(cuda) for t in tree], degree))
    assert abs(got - want) <= 1e-6 * want
    for t in tree:
        d = zero.shard_dim(tuple(t.shape), degree)
        if d is None:
            continue
        dev = t.to(cuda)
        buf = dev.movedim(d, 0).contiguous()
        c = t.shape[d] // degree
        for k in range(degree):
            chunk = buf[k * c:(k + 1) * c].movedim(0, d).contiguous()
            assert tuple(chunk.shape) == zero.shard_shape(tuple(t.shape), degree)
            assert torch.equal(chunk.cpu(), t.narrow(d, k * c, c))


def test_host_offload_keeps_the_state_pinned_and_steps_as_the_plain_optimizer(cuda):
    from accelerate_tpu_torch.parallel import host_offload as ho

    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(64, 32, generator=gen)
    grads = [torch.randn(64, 32, generator=gen).to(cuda) for _ in range(3)]
    a = torch.nn.Parameter(p0.clone().to(cuda))
    b = torch.nn.Parameter(p0.clone().to(cuda))
    plain = torch.optim.AdamW([a], lr=1e-2)
    off = ho.host_offload(torch.optim.AdamW([b], lr=1e-2))
    for g in grads:
        a.grad, b.grad = g.clone(), g.clone()
        plain.step()
        off.step()
        st = off.state[b]
        assert st["exp_avg"].device.type == "cpu" and st["exp_avg"].is_pinned()
    assert ho.host_memory_kind() == "pinned_host"
    assert torch.equal(a, b)


# -- the model axes' collectives over a one-rank NCCL group ------------------------


@pytest.fixture
def nccl_one_rank(cuda):
    """A one-rank NCCL group, as ``chip_smoke.py`` Phase 16a starts one."""
    import socket

    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is already up")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fsdp_gather_and_megatron_pair_on_a_one_rank_nccl_group(nccl_one_rank, dtype):
    """``fsdp_gather`` (a shard not along dim 0, cast to ``dtype`` first),
    ``tp_copy`` and ``tp_reduce`` on CUDA tensors: with one rank each
    returns its input and its backward the incoming gradient (the
    gather's in the shard's fp32), and each logs its collective under its
    axis."""
    from accelerate_tpu_torch.parallel import collectives as co

    group = nccl_one_rank
    gen = torch.Generator().manual_seed(0)
    shard = torch.randn(64, 128, generator=gen).cuda().requires_grad_(True)
    x = torch.randn(4, 64, generator=gen).cuda().to(dtype).requires_grad_(True)
    co.reset_comm_log()
    full = co.fsdp_gather(shard, 1, group, dtype=dtype)
    assert full.dtype == dtype and torch.equal(full, shard.detach().to(dtype))
    y = co.tp_reduce(co.tp_copy(x, group) @ full, group)
    assert torch.equal(y, x.detach() @ shard.detach().to(dtype))
    g = torch.randn(y.shape, generator=gen).cuda().to(dtype)
    y.backward(g)
    torch.cuda.synchronize()
    assert shard.grad.dtype == torch.float32
    assert torch.equal(shard.grad, (x.detach().T @ g).float())
    assert torch.equal(x.grad, g @ shard.detach().to(dtype).T)
    assert {"all_gather:fsdp", "reduce_scatter:fsdp", "all_reduce:tp"} <= set(co.COMM_LOG)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tp_gather_and_data_sum_on_a_one_rank_nccl_group(nccl_one_rank, dtype):
    """``tp_gather`` (summing and slicing backward) and ``data_sum`` on CUDA
    tensors: with one rank each returns its input and its backward the
    incoming gradient, and each logs its collective."""
    from accelerate_tpu_torch.parallel import collectives as co

    group = nccl_one_rank
    gen = torch.Generator().manual_seed(1)
    co.reset_comm_log()
    for partial in (True, False):
        shard = torch.randn(32, 48, generator=gen).cuda().to(dtype).requires_grad_(True)
        full = co.tp_gather(shard, 1, group, partial)
        assert torch.equal(full, shard.detach())
        g = torch.randn(full.shape, generator=gen).cuda().to(dtype)
        full.backward(g)
        assert torch.equal(shard.grad, g)
    x = torch.randn(16, generator=gen).cuda().to(dtype).requires_grad_(True)
    y = co.data_sum(x, group, ("dp",))
    assert torch.equal(y, x.detach())
    y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    assert torch.equal(x.grad, torch.ones_like(x))
    assert {"all_gather:tp", "reduce_scatter:tp", "all_reduce:dp"} <= set(co.COMM_LOG)


@pytest.mark.parametrize("geometry", [(8, 1, 256, 4), (12, 3, 128, 3), (4, 2, 64, 1)],
                         ids=["gemma-2b-4-of-8", "ragged-groups", "one-query-head"])
def test_replicated_kv_heads_through_the_fused_kernels(cuda, geometry):
    """``tp`` not dividing the kv heads: a rank's query heads ``[lo, lo +
    n)`` with the whole K/V weights read only the kv heads ``ih // g`` of
    those heads (in equal groups, or one copy a query head where the groups
    are ragged), through the sm90 kernels (bf16, one forward launch); its
    attention equals those heads of the whole attention."""
    h, kh, hd, n = geometry
    c = llama.LlamaConfig.tiny(num_heads=h, num_kv_heads=kh, head_dim=hd, hidden_size=256,
                               dtype=torch.bfloat16, attention_impl="pallas")
    gen = torch.Generator().manual_seed(2)
    d, s = c.hidden_size, 256
    p = {k: (torch.randn(d, w, generator=gen) / d ** 0.5).cuda()
         for k, w in (("wq", h * hd), ("wk", kh * hd), ("wv", kh * hd))}
    x = torch.randn(1, s, d, generator=gen).cuda().to(c.dtype)
    positions = torch.arange(s, device="cuda")[None]
    q, k, v = llama._qkv_proj(x, p, c, 1, s)
    q, k = llama._rope(q, k, positions, c.rope_theta)
    whole = llama._attend(q, k, v, c, None)
    for lo in range(0, h, n):
        mine = dict(p, wq=p["wq"][:, lo * hd:(lo + n) * hd])
        q, k, v = llama._qkv_proj(x, mine, c, 1, s, (lo, n))
        q, k = llama._rope(q, k, positions, c.rope_theta)
        before = fu.fused_attention_fwd.launches
        got = llama._attend(q, k, v, c, None)
        torch.cuda.synchronize()
        assert fu.fused_attention_fwd.launches == before + 1
        torch.testing.assert_close(got, whole[:, :, lo:lo + n], atol=TOL[c.dtype],
                                   rtol=TOL[c.dtype])


def _two_ranks_on_the_card(rank, port, mode):
    """One of two gloo processes sharing card 0 (``torch.multiprocessing``)."""
    import torch.distributed as dist

    from accelerate_tpu_torch.ops import moe

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    try:
        gen = torch.Generator().manual_seed(3)
        if mode == "ep":
            b, s, d, e, f = 2, 64, 32, 8, 48
            x = torch.randn(b, s, d, generator=gen).cuda()
            w = [torch.randn(d, e, generator=gen).cuda() * 0.3] + [
                torch.randn(e, *shape, generator=gen).cuda() * 0.2
                for shape in ((d, f), (d, f), (f, d))]
            full = [t.clone().requires_grad_(True) for t in [x] + w]
            y, _ = moe.moe_ffn(*full, top_k=2, capacity=12, compute_dtype=torch.float32)
            y.square().sum().backward()
            half = e // 2
            lo = rank * half
            mine = [t.clone().requires_grad_(True) for t in
                    [x, w[0]] + [t[lo:lo + half] for t in w[1:]]]
            got, _ = moe.moe_ffn(*mine, top_k=2, capacity=12, compute_dtype=torch.float32,
                                 group=dist.group.WORLD, axis="ep", first_expert=lo)
            got.square().sum().backward()
            torch.testing.assert_close(got, y, atol=1e-5, rtol=1e-5)
            # The router's and the input's gradients whole on every rank.
            for a, b_ in zip(mine[:2], full[:2]):
                torch.testing.assert_close(a.grad, b_.grad, atol=1e-5, rtol=1e-5)
            for a, b_ in zip(mine[2:], full[2:]):
                torch.testing.assert_close(a.grad, b_.grad[lo:lo + half], atol=1e-5, rtol=1e-5)
        else:
            from accelerate_tpu_torch import Accelerator, AcceleratorState, ParallelismConfig
            from accelerate_tpu_torch.optimizer import global_norm

            c = llama.LlamaConfig.tiny(num_heads=8, num_kv_heads=1, head_dim=64,
                                       hidden_size=256, dtype=torch.bfloat16,
                                       attention_impl="pallas", remat=True)
            ids = torch.randint(0, c.vocab_size, (1, 256), generator=gen).cuda()
            one = llama.LlamaForCausalLM(c, seed=0, device="cuda")
            loss1 = one(input_ids=ids)["loss"]
            norm1 = global_norm(torch.autograd.grad(loss1, list(one.parameters())))
            AcceleratorState._reset_state(reset_partial_state=True)
            acc = Accelerator(device="cuda:0", parallelism_config=ParallelismConfig(tp=2))
            model = llama.LlamaForCausalLM(c, seed=0, device="cuda")
            model, _ = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.0))
            before = fu.fused_attention_fwd.launches
            loss = model(input_ids=ids)["loss"]
            assert fu.fused_attention_fwd.launches == before + c.num_layers
            acc.backward(loss)
            norm = acc.clip_grad_norm_(1e9)
            assert abs(float(loss) - float(loss1)) <= 1e-3 * abs(float(loss1))
            assert abs(float(norm) - float(norm1)) <= 1e-2 * float(norm1)
            AcceleratorState._reset_state(reset_partial_state=True)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["ep", "tp-one-kv-head"])
def test_two_ranks_sharing_the_card_match_one_process(cuda, mode):
    """Two gloo processes on card 0: ``ep`` (``moe_ffn`` over each rank's 4
    of 8 experts, the partial combines summed: the output, the router's and
    the input's gradients equal one process's in fp32) and ``tp`` with
    the one kv head replicated (a Gemma-shaped tiny llama's bf16 loss and
    pre-clip norm against one process's, one fused forward a layer)."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.spawn(_two_ranks_on_the_card, args=(port, mode), nprocs=2)


def _ring_halves(dtype):
    """Llama-3-8B head geometry, queries ``q`` of 1024 tokens against keys
    in two halves of 1024 (the ring's hops), and the whole as one call's
    inputs: queries ``[q; q]`` over keys ``[k1; k2]`` with ``dO`` zero on the
    second copy (its rows add nothing to dK and dV)."""
    gen = torch.Generator().manual_seed(25)

    def randn(h):
        return torch.randn(1, 1024, h, 128, generator=gen).to("cuda", dtype)

    q, k1, k2, v1, v2, do = randn(32), randn(8), randn(8), randn(8), randn(8), randn(32)
    whole = [torch.cat(t, 1).contiguous() for t in ((q, q), (k1, k2), (v1, v2),
                                                      (do, torch.zeros_like(do)))]
    return q, (k1, k2), (v1, v2), do, whole


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_lse_merge_of_two_forward_halves_matches_one_forward(cuda, dtype):
    """The ring's forward merge: two non-causal fused forwards over halves of
    the keys, merged in fp32 (``ring_fused._merge``), against one fused
    forward over all the keys (out and lse)."""
    from accelerate_tpu_torch.ops.ring_fused import _merge

    q, ks, vs, _, whole = _ring_halves(dtype)
    out_whole, lse_whole = fu.fused_attention_fwd(*whole[:3], causal=False, block_size=2048)
    o1, l1 = fu.fused_attention_fwd(q, ks[0], vs[0], causal=False, block_size=1024)
    o2, l2 = fu.fused_attention_fwd(q, ks[1], vs[1], causal=False, block_size=1024)
    out, lse = _merge(o1.float(), l1, o2, l2)
    torch.testing.assert_close(out.to(dtype).float(), out_whole[:, :1024].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, lse_whole[:, :, :1024], atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_backward_halves_with_delta_once_match_one_backward(cuda, dtype):
    """The ring's backward: δ = rowsum(dO∘O) once from the whole out, the dQ
    and dK/dV kernels on each half of the keys with the whole lse; dQ
    summed, dK and dV concatenated, against one fused backward over all the
    keys."""
    q, ks, vs, do, whole = _ring_halves(dtype)
    out_whole, lse_whole = fu.fused_attention_fwd(*whole[:3], causal=False, block_size=2048)
    dq_w, dk_w, dv_w = fu.fused_attention_bwd(*whole[:3], out_whole, lse_whole, whole[3],
                                              causal=False)
    out = out_whole[:, :1024].contiguous()
    lse = lse_whole[:, :, :1024].contiguous()
    delta = fu._delta(out, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    dks, dvs = [], []
    for k, v in zip(ks, vs):
        dq += fu.fused_attention_bwd_dq(q, k, v, do, lse, delta, causal=False).float()
        dk, dv = fu.fused_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False)
        dks.append(dk)
        dvs.append(dv)
    tol = TOL[dtype]
    torch.testing.assert_close(dq.to(dtype).float(), dq_w[:, :1024].float(), atol=tol, rtol=tol)
    torch.testing.assert_close(torch.cat(dks, 1).float(), dk_w.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(torch.cat(dvs, 1).float(), dv_w.float(), atol=tol, rtol=tol)


def test_async_save_snapshots_cuda_parameters_before_returning(cuda, tmp_path):
    """``save_state(async_save=True)`` of a model on the card: the
    parameters and AdamW state are changed in place as soon as it returns
    (the write still in flight), yet the published files hold the state of
    the moment it returned."""
    from accelerate_tpu_torch import Accelerator, AcceleratorState, FunctionalModel
    from accelerate_tpu_torch.resilience.elastic import state_digest

    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator(device="cuda")
    gen = torch.Generator().manual_seed(5)
    model = FunctionalModel(lambda p, x: {"loss": torch.tanh(x @ p["w"]).sum()},
                            {"w": torch.randn(2048, 1024, generator=gen)})
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-3))
    step = acc.make_train_step(model, opt)
    step({"x": torch.randn(8, 2048, generator=gen)})
    before = state_digest(acc)
    ckpt = acc.save_state(str(tmp_path / "ckpt"), async_save=True)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(-3.0)
        for st in opt.optimizer.state.values():
            st["exp_avg"].add_(1.0)
    torch.cuda.synchronize()
    changed = state_digest(acc)
    acc.wait_for_checkpoint()
    assert changed != before
    acc.load_state(ckpt)
    assert state_digest(acc) == before
    assert next(model.parameters()).device.type == "cuda"
    AcceleratorState._reset_state(reset_partial_state=True)


def _sharded_save_on_the_card(rank, init, ckpt, out):
    """One of two gloo processes on card 0: a llama on ``fsdp=2`` under the
    plugin's default ``SHARDED_STATE_DICT``, one step, a save; its
    digest."""
    import json

    import torch.distributed as dist

    from accelerate_tpu_torch import Accelerator, AcceleratorState, ParallelismConfig
    from accelerate_tpu_torch.resilience.elastic import state_digest
    from accelerate_tpu_torch.utils import FullyShardedDataParallelPlugin

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    try:
        AcceleratorState._reset_state(reset_partial_state=True)
        acc = Accelerator(device="cuda:0", parallelism_config=ParallelismConfig(fsdp=2),
                          fsdp_plugin=FullyShardedDataParallelPlugin())
        c = llama.LlamaConfig.tiny(head_dim=64, dtype=torch.bfloat16,
                                   param_dtype=torch.float32, attention_impl="pallas")
        model = llama.LlamaForCausalLM(c, seed=0, device="cuda")
        model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-3))
        step = acc.make_train_step(model, opt)
        gen = torch.Generator().manual_seed(rank)
        step({"input_ids": torch.randint(0, c.vocab_size, (1, 128), generator=gen).cuda()})
        acc.save_state(ckpt)
        digest = state_digest(acc)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"digest": digest, "shard": list(next(model.parameters()).shape)}, f)
    finally:
        dist.destroy_process_group()


def test_sharded_save_of_cuda_shards_loads_onto_a_replicated_model(cuda, tmp_path):
    """Two gloo processes on card 0 write their own CUDA shards
    (``model_orbax/rank<r>.safetensors``); this process loads them onto a
    replicated model on the card, bit-identical (the state digest)."""
    import json

    import torch.multiprocessing as mp

    from accelerate_tpu_torch import Accelerator, AcceleratorState
    from accelerate_tpu_torch.resilience.elastic import state_digest

    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "out.json")
    mp.spawn(_sharded_save_on_the_card, args=(f"file://{tmp_path / 'init'}", ckpt, out),
             nprocs=2)
    with open(out) as f:
        saved = json.load(f)
    assert sorted(os.listdir(os.path.join(ckpt, "model_orbax"))) == [
        "rank0.index.json", "rank0.safetensors", "rank1.index.json", "rank1.safetensors"]
    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator(device="cuda")
    c = llama.LlamaConfig.tiny(head_dim=64, dtype=torch.bfloat16, param_dtype=torch.float32,
                               attention_impl="pallas")
    model = llama.LlamaForCausalLM(c, seed=9, device="cuda")
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-3))
    acc.load_state(ckpt)
    assert state_digest(acc) == saved["digest"]
    assert acc.last_load_timing["read_place_s"] > 0
    assert list(next(model.parameters()).shape) != saved["shard"]
    AcceleratorState._reset_state(reset_partial_state=True)


_FLEET_RANK_ON_THE_CARD = """
import os, signal, sys, time

import torch

from accelerate_tpu_torch import Accelerator

acc = Accelerator()  # the launch contract: gloo on card 0 for two ranks on one card
x = torch.ones(1 << 24, device=acc.device)  # a CUDA context and 64 MB on the card
acc.check_preemption(step=1)  # beats the heartbeat
if acc.process_index == 1:
    if sys.argv[1] == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(3600)  # wedged: alive, silent
acc.reduce(x, "sum")  # rank 0: fails or hangs on the missing peer
time.sleep(3600)
"""


@pytest.mark.parametrize("fault", ["sigkill", "wedge"])
def test_supervisor_reaps_ranks_that_hold_a_cuda_context(cuda, tmp_path, fault):
    """Two ranks forked from the preloaded server join one group on the card
    and hold CUDA memory; rank 1 dies (or goes silent).  The
    ``FleetSupervisor`` names the fault, tears both down within its grace
    window plus 15 s, and the card's memory comes back."""
    from accelerate_tpu_torch.launchers import FleetSupervisor
    from accelerate_tpu_torch.parallel import launch

    script = tmp_path / "rank.py"
    script.write_text(_FLEET_RANK_ON_THE_CARD)
    free_before, _ = torch.cuda.mem_get_info()

    def spawn(rank, world, overrides):
        return launch.fork(str(script), [fault], dict(os.environ, **overrides), how="path")

    grace = 3.0
    result = FleetSupervisor(spawn, 2, str(tmp_path / "fleet"), heartbeat_timeout_s=10.0,
                             grace_s=grace, poll_s=0.1).run()
    attempt = result["attempts"][0]
    if fault == "sigkill":
        assert result["verdict"] == "worker_dead", result
        assert (attempt["dead_rank"], attempt["exit_code"]) == (1, -9), attempt
    else:
        assert result["verdict"] == "wedged" and attempt["wedged_rank"] is not None, result
    assert attempt["teardown_s"] <= grace + 15.0, attempt
    assert all(code is not None for code in attempt["exit_codes"].values()), attempt
    deadline = time.monotonic() + 30
    while torch.cuda.mem_get_info()[0] < free_before - (256 << 20) and time.monotonic() < deadline:
        time.sleep(0.5)
    assert torch.cuda.mem_get_info()[0] >= free_before - (256 << 20)
