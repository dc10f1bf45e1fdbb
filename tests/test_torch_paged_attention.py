"""The port's paged attention (``accelerate_tpu_torch/ops/paged_attention.py``)
against the JAX package's Pallas paged kernels run in interpret mode.

On the CPU the port's wrappers run their plain versions, so these tests hold
the plain versions to the TPU kernels' semantics: GQA head grouping, ragged
lengths including 0, null-padded tables, the window fold and its causal
mask.  Tolerance: fp32 atol = rtol = 2e-5 (both sides sum in fp32, in
different orders).  The CUDA kernels themselves are held against the plain
versions on the card by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accelerate_tpu.ops.pallas_attention import (
    pallas_paged_attention,
    pallas_paged_window_attention,
)
from accelerate_tpu_torch.ops import paged_attention as pa

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, kv_heads, groups, window, d=8, bs=4, lengths=(6, 0, 9, 4), m=4):
    """Pool blocks scattered in a shuffled order, tables null-padded to ``m``."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    h = kv_heads * groups
    owned = [-(-n // bs) for n in lengths]
    nblk = sum(owned) + 1
    perm = rng.permutation(np.arange(1, nblk))
    tables = np.zeros((b, m), np.int32)
    c = 0
    for i, n in enumerate(owned):
        tables[i, :n] = perm[c:c + n]
        c += n
    lead = (b,) if window is None else (b, window)
    return dict(
        q=rng.standard_normal(lead + (h, d)).astype(np.float32),
        k_new=rng.standard_normal(lead + (kv_heads, d)).astype(np.float32),
        v_new=rng.standard_normal(lead + (kv_heads, d)).astype(np.float32),
        pool_k=rng.standard_normal((nblk, bs, kv_heads, d)).astype(np.float32),
        pool_v=rng.standard_normal((nblk, bs, kv_heads, d)).astype(np.float32),
        tables=tables,
        lengths=np.asarray(lengths, np.int32),
    )


def _torch(args):
    return {k: torch.from_numpy(v) for k, v in args.items()}


def _jax(args):
    return {k: jnp.asarray(v) for k, v in args.items()}


@pytest.mark.parametrize("kv_heads,groups", [(2, 1), (2, 2), (1, 4)])
def test_decode_matches_pallas_kernel(kv_heads, groups):
    args = _inputs(3, kv_heads, groups, None)
    want = np.asarray(pallas_paged_attention(**_jax(args), interpret=True))
    got = pa.paged_attention(**_torch(args))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("window", [1, 3])
@pytest.mark.parametrize("kv_heads,groups", [(2, 1), (2, 2)])
def test_window_matches_pallas_kernel(window, kv_heads, groups):
    args = _inputs(5, kv_heads, groups, window)
    want = np.asarray(pallas_paged_window_attention(**_jax(args), interpret=True))
    got = pa.paged_window_attention(**_torch(args))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_window_of_one_equals_decode():
    args = _torch(_inputs(7, 2, 2, 1))
    win = pa.paged_window_attention(**args)
    dec = pa.paged_attention(**{**args, "q": args["q"][:, 0], "k_new": args["k_new"][:, 0],
                                "v_new": args["v_new"][:, 0]})
    torch.testing.assert_close(win[:, 0], dec, rtol=0, atol=0)


def test_length_zero_slot_reads_no_pool_block():
    """An idle slot (length 0, all-null table) attends only its new row, so
    its output is exactly that row's value, whatever the pool holds."""
    args = _torch(_inputs(11, 2, 2, None, lengths=(0, 5)))
    args["pool_k"][0] = float("nan")  # the null block
    args["pool_v"][0] = float("nan")
    out = pa.paged_attention(**args)
    want = args["v_new"][0].repeat_interleave(2, dim=0)  # head h reads kv head h // 2
    torch.testing.assert_close(out[0], want)
    assert torch.isfinite(out).all()


def test_stale_rows_past_length_are_masked():
    """Pool rows at positions >= length do not change the output (the
    window dispatch's own scatter overwrites them afterwards)."""
    args = _torch(_inputs(13, 2, 2, 3, lengths=(5, 2)))
    base = pa.paged_window_attention(**args)
    for i, n in enumerate(args["lengths"].tolist()):
        blk, off = args["tables"][i, n // 4], n % 4
        args["pool_k"][blk, off:] = 1e4
        args["pool_v"][blk, off:] = -1e4
    torch.testing.assert_close(pa.paged_window_attention(**args), base, rtol=0, atol=0)


def test_cpu_tensors_run_the_plain_version_without_counting():
    before = (pa.paged_attention.launches, pa.paged_window_attention.launches)
    args = _torch(_inputs(17, 2, 2, None))
    torch.testing.assert_close(pa.paged_attention(**args), pa.paged_attention_plain(**args),
                               rtol=0, atol=0)
    wargs = _torch(_inputs(17, 2, 2, 2))
    pa.paged_window_attention(**wargs)
    assert (pa.paged_attention.launches, pa.paged_window_attention.launches) == before


def test_other_devices_raise():
    args = {k: v.to("meta") for k, v in _torch(_inputs(19, 2, 2, None)).items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        pa.paged_attention(**args)


# ---------------------------------------------------------------------------
# The split path (the Hopper kernels' algorithm) in plain PyTorch: partials
# per chunk of ``split_tokens`` pool positions, then the lse merge with the
# new rows folded in.  bs = 4 and a table 4 wide: 16 positions at most.
# ---------------------------------------------------------------------------

_CHUNKS = {"one_block": 4, "two_blocks": 8, "wider_than_table": 32}


def _split_lengths(chunk):
    """A length exactly on a chunk boundary, one past it, an idle slot, and
    one mid-chunk (all within the 16 positions of the table)."""
    return (min(chunk, 16), min(chunk + 1, 15), 0, 9)


def _split_args(seed, window, chunk):
    args = _inputs(seed, 2, 2, 1 if window is None else window, lengths=_split_lengths(chunk))
    args["pool_k"][0] = np.nan  # the null block: never read by either side
    args["pool_v"][0] = np.nan
    return args


@pytest.mark.parametrize("chunk", list(_CHUNKS), ids=list(_CHUNKS))
@pytest.mark.parametrize("window", [None, 1, 3], ids=["decode", "w1", "w3"])
def test_split_path_matches_pallas_kernel(window, chunk):
    args = _split_args(23, window, _CHUNKS[chunk])
    if window is None:
        jargs = {**args, **{k: args[k][:, 0] for k in ("q", "k_new", "v_new")}}
        want = np.asarray(pallas_paged_attention(**_jax(jargs), interpret=True))[:, None]
    else:
        want = np.asarray(pallas_paged_window_attention(**_jax(args), interpret=True))
    got = pa.paged_window_attention_split_plain(**_torch(args), split_tokens=_CHUNKS[chunk])
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("window", [1, 3])
def test_split_path_idle_slot_is_exactly_v_new(window):
    """Length 0 with a NaN null block: no chunk is merged, and window row 0
    (every row, for decode) admits only new row 0, so it is v_new exactly."""
    t = _torch(_split_args(29, window, 4))
    out = pa.paged_window_attention_split_plain(**t, split_tokens=8)
    idle = 2  # _split_lengths puts the idle slot third
    want = t["v_new"][idle, 0].repeat_interleave(2, dim=0)  # head h reads kv head h // 2
    torch.testing.assert_close(out[idle, 0], want, rtol=0, atol=0)
    assert torch.isfinite(out).all()


def test_split_merge_reads_no_split_past_the_length():
    """The merge plain version ignores the scratch of splits at or past
    ceil(length / C), whatever it holds (the kernel leaves it unwritten)."""
    t = _torch(_split_args(31, 3, 4))
    part_o, part_ml = pa.paged_split_partials_plain(t["q"], t["pool_k"], t["pool_v"],
                                                    t["tables"], t["lengths"], 4)
    base = pa.paged_split_merge_plain(t["q"], t["k_new"], t["v_new"], part_o, part_ml,
                                      t["lengths"], 4, 4, 4)
    n_used = (t["lengths"] + 3) // 4
    for b, n in enumerate(n_used.tolist()):
        part_o[b, :, n:] = float("nan")
        part_ml[b, :, n:] = float("nan")
    got = pa.paged_split_merge(t["q"], t["k_new"], t["v_new"], part_o, part_ml, t["lengths"],
                               4, 4, 4)
    torch.testing.assert_close(got, base, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# bf16: the Pallas kernels round P to the pool dtype before P.V
# (pallas_attention.py:589); the plain versions keep P in fp32.  Over seeds
# 0-2 at these shapes the two differ by at most 3.906e-3 (decode) and
# 7.813e-3 (W=3): one bf16 ulp at the outputs' magnitude, the size of the
# Pallas kernels' own gap to an fp32 evaluation of the same bf16 inputs
# (<= 6.7e-3).  So atol = rtol = 1e-2, and the plain versions keep fp32 P.
# ---------------------------------------------------------------------------

BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _bf16_args(seed, window):
    args = _inputs(seed, 2, 2, window, d=64, bs=4, lengths=(30, 0, 61, 17), m=16)
    args["pool_k"][0] = np.nan  # the null block: never read by either side
    args["pool_v"][0] = np.nan
    floats = ("q", "k_new", "v_new", "pool_k", "pool_v")
    jargs = {k: jnp.asarray(v, jnp.bfloat16 if k in floats else None) for k, v in args.items()}
    targs = {k: torch.from_numpy(v).to(torch.bfloat16) if k in floats else torch.from_numpy(v)
             for k, v in args.items()}
    return jargs, targs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window", [None, 3], ids=["decode", "w3"])
def test_bf16_matches_pallas_kernel(seed, window):
    jargs, targs = _bf16_args(seed, window)
    if window is None:
        want = pallas_paged_attention(**jargs, interpret=True)
        got = pa.paged_attention(**targs)
    else:
        want = pallas_paged_window_attention(**jargs, interpret=True)
        got = pa.paged_window_attention(**targs)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window", [None, 3], ids=["decode", "w3"])
def test_bf16_split_path_matches_pallas_kernel(seed, window):
    jargs, targs = _bf16_args(seed, 1 if window is None else window)
    if window is None:
        jargs = {**jargs, **{k: jargs[k][:, 0] for k in ("q", "k_new", "v_new")}}
        want = np.asarray(pallas_paged_attention(**jargs, interpret=True), np.float32)[:, None]
    else:
        want = np.asarray(pallas_paged_window_attention(**jargs, interpret=True), np.float32)
    got = pa.paged_window_attention_split_plain(**targs, split_tokens=16)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_pick_split_tokens_uses_whole_blocks_within_the_table():
    # Llama-3-8B serving shapes on a 132-SM card: 128 positions per split.
    assert pa.pick_split_tokens(8, 8, 512, 16, 132) == 128
    assert pa.pick_split_tokens(8, 8, 64, 16, 132) == 128
    # Never past the table, always whole blocks.
    assert pa.pick_split_tokens(4, 2, 4, 4, 132) == 16
    assert pa.pick_split_tokens(1, 1, 100, 24, 132) == 144
    # Many full slots: splits grow until at most 64 CTAs per SM remain.
    c = pa.pick_split_tokens(64, 8, 4096, 16, 132)
    assert c % 16 == 0 and 64 * 8 * -(-4096 * 16 // c) <= 64 * 132


@pytest.mark.parametrize("window", [None, 3], ids=["decode", "w3"])
@pytest.mark.parametrize("d,dtype", [(96, "fp32"), (96, "bf16"), (256, "fp32")])
def test_wide_heads_match_pallas_kernel(d, dtype, window):
    """Head dims the paged kernels took in this port's widening: 96 in every
    dtype and 256 in fp32, the plain versions against the Pallas kernels in
    interpret mode (fp32 at 2e-5; bf16 at 1e-2, the gap of P rounded to bf16
    before P.V in Pallas and kept in fp32 here)."""
    args = _inputs(7, 2, 2, window, d=d, bs=4, lengths=(30, 0, 61, 17), m=16)
    if dtype == "bf16":
        floats = ("q", "k_new", "v_new", "pool_k", "pool_v")
        jargs = {k: jnp.asarray(v, jnp.bfloat16 if k in floats else None)
                 for k, v in args.items()}
        targs = {k: torch.from_numpy(v).to(torch.bfloat16) if k in floats
                 else torch.from_numpy(v) for k, v in args.items()}
        tol = BF16_TOL
    else:
        jargs, targs, tol = _jax(args), _torch(args), TOL
    if window is None:
        want = pallas_paged_attention(**jargs, interpret=True)
        got = pa.paged_attention(**targs)
    else:
        want = pallas_paged_window_attention(**jargs, interpret=True)
        got = pa.paged_window_attention(**targs)
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    split = pa.paged_window_attention_split_plain(
        *(targs[k] if window else targs[k][:, None] for k in ("q", "k_new", "v_new")),
        targs["pool_k"], targs["pool_v"], targs["tables"], targs["lengths"], split_tokens=16)
    np.testing.assert_allclose(split.float().numpy().reshape(want.shape),
                               np.asarray(want, np.float32), **tol)


def test_merge_window_limit_follows_shared_memory():
    """fp32 at head dim 256 stages 1 KB a k_new row in the merge kernel, so
    its window stops short of the 256 the other widths take; the wrapper's
    check says so instead of the kernel refusing the launch."""
    assert pa._merge_smem(256, 128, 4) <= pa._MERGE_SMEM
    assert pa._merge_smem(256, 256, 2) <= pa._MERGE_SMEM
    assert pa._merge_smem(160, 256, 4) <= pa._MERGE_SMEM < pa._merge_smem(200, 256, 4)
