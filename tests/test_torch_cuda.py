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


def test_flash_fwd_fp32_stays_on_the_cuda_core_body(cuda, fwd_symbols):
    q, k, v, _, valid = _flash_inputs(79, 2, 200, 8, 2, 128, torch.float32, True)
    out, lse = fu.fused_attention_fwd(q, k, v, valid, causal=True, block_size=200)
    torch.cuda.synchronize()
    assert fwd_symbols == ["atpu_flash_fwd"]
    want_out, want_lse = fu.fused_attention_fwd_plain(q, k, v, valid, causal=True,
                                                      block_size=200)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


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


def test_flash_bwd_dkv_fp32_stays_on_the_cuda_core_body(cuda, fwd_symbols):
    q, k, v, do, out, lse, delta = _dkv_inputs(97, 2, 200, 4, 128, torch.float32, True)
    dk, dv = fu.fused_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True)
    torch.cuda.synchronize()
    assert fwd_symbols == ["atpu_flash_bwd_dkv"]
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


def test_flash_bwd_dq_fp32_stays_on_the_cuda_core_body(cuda, fwd_symbols):
    q, k, v, do, out, lse, delta = _dkv_inputs(113, 2, 200, 4, 128, torch.float32, True)
    dq = fu.fused_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
    torch.cuda.synchronize()
    assert fwd_symbols == ["atpu_flash_bwd_dq"]
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
    runs the forward, dQ and dK/dV kernels once per layer each (fp32 all on
    ``flash_attention.cu``; bf16 the sm90 forward, dQ and d-256 dK/dV), and
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
        ["atpu_flash_bwd_dkv", "atpu_flash_bwd_dq", "atpu_flash_fwd"]
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
    left-padded and an all-invalid batch: fp32 runs the body of
    ``flash_attention.cu``; bf16 the sm90 forward, dQ and dK/dV (its d-256
    kernel at 256)."""
    _flash_check(131, 2, s, 8, 2, d, dtype, True, True)
    if dtype == torch.float32:
        want = {"atpu_flash_fwd", "atpu_flash_bwd_dq", "atpu_flash_bwd_dkv"}
    elif d == 256:
        want = {"atpu_flash_fwd_sm90", "atpu_flash_bwd_dq_sm90", "atpu_flash_bwd_dkv_sm90_d256"}
    else:
        want = {"atpu_flash_fwd_sm90", "atpu_flash_bwd_dq_sm90", "atpu_flash_bwd_dkv_sm90"}
    assert set(fwd_symbols) == want


@pytest.mark.parametrize("dtype", [torch.float32], ids=["fp32"])
def test_flash_d256_fp32_and_dq_stay_on_the_cuda_core_body(cuda, fwd_symbols, dtype):
    """At head dim 256 fp32 runs all three kernels on ``flash_attention.cu``
    (bf16/fp16 dQ moved to the sm90 kernel, which the dQ tests above hold),
    against the plain backward."""
    q, k, v, do, out, lse, delta = _dkv_inputs(149, 2, 300, 4, 256, dtype, True)
    dq = fu.fused_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
    fu.fused_attention_fwd(q, k, v, causal=True, block_size=300)
    fu.fused_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True)
    torch.cuda.synchronize()
    assert fwd_symbols == ["atpu_flash_bwd_dq", "atpu_flash_fwd", "atpu_flash_bwd_dkv"]
    want_dq = fu.fused_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                           block_size=300)[0]
    tol = TOL[dtype]
    torch.testing.assert_close(dq.float(), want_dq.float(), rtol=tol, atol=tol)



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
