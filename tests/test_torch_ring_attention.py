"""Sequence-parallel attention in the port (``ops/ring_attention.py``,
``ops/ring_fused.py``, ``ops/ulysses_attention.py``,
``parallel/collectives.py``'s ``ring_shift`` and ``all_to_all_dim``)
against the JAX package.

In a module-scoped world of 2 gloo processes and one of 4
(``torch_dp_world``), each process runs the port on its chunk of the
sequence (and, under ``tp``, its heads) and backpropagates ``sum(out *
cot)``; its output and its chunks of dQ, dK and dV are held against the
JAX function's on the global arrays (``jax.vjp`` with the same cotangent),
computed in a thread beside the world on the suite's CPU devices, to 1e-5
in fp32: the einsum ring against ``ring_attention`` (causal and not, GQA,
a padding mask), the ring over the kernels' plain versions against
``ring_attention_pallas(interpret=True)``, and Ulysses against
``ulysses_attention`` (GQA expansion, the ``tp`` head shard, a padding
mask, and the error where the heads do not divide).  Without a world:
``_kv_expansion`` and ``tp_head_axis`` against JAX's, the single-process
fallbacks, and the refusals.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from torch_dp_world import World

AXES = ("dcn_dp", "dp", "fsdp", "pp", "sp", "ep", "tp")
TOL = 1e-5

# name: (port kind, JAX kind, world size, mesh, (B, S, H, K, d), causal, padded, tp heads)
CASES = {
    "ring_causal_sp2": ("ring", "ring", 2, dict(sp=2), (2, 32, 4, 2, 16), True, False, False),
    "ring_full_sp2": ("ring", "ring", 2, dict(sp=2), (2, 32, 4, 2, 16), False, False, False),
    "ring_padded_sp2": ("ring", "ring", 2, dict(sp=2), (2, 32, 4, 2, 16), True, True, False),
    "ring_causal_sp4": ("ring", "ring", 4, dict(sp=4), (2, 32, 4, 2, 16), True, False, False),
    "ring_padded_full_sp4": ("ring", "ring", 4, dict(sp=4), (2, 32, 4, 4, 16), False, True,
                             False),
    "fused_plain_causal_sp2": ("fused_plain", "pallas", 2, dict(sp=2), (2, 64, 4, 2, 16), True,
                               False, False),
    "fused_plain_full_sp2": ("fused_plain", "pallas", 2, dict(sp=2), (1, 32, 2, 1, 16), False,
                             False, False),
    "ulysses_sp4": ("ulysses", "ulysses", 4, dict(sp=4), (2, 64, 4, 4, 16), True, False, False),
    "ulysses_gqa_expansion_sp4": ("ulysses", "ulysses", 4, dict(sp=4), (2, 64, 4, 2, 16), True,
                                  False, False),
    "ulysses_minimal_gqa_sp4": ("ulysses", "ulysses", 4, dict(sp=4), (1, 32, 8, 2, 16), True,
                                False, False),
    "ulysses_padded_sp2": ("ulysses", "ulysses", 2, dict(sp=2), (2, 32, 4, 2, 16), False, True,
                           False),
    "ulysses_tp2xsp2": ("ulysses", "ulysses", 4, dict(sp=2, tp=2), (2, 64, 4, 4, 16), True,
                        False, True),
}


def _jax_mesh(mesh_kw):
    shape = [mesh_kw.get(a, 1) for a in AXES]
    return JaxMesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), AXES)


def _inputs(name):
    b, s, h, kh, d = CASES[name][4]
    rng = np.random.default_rng(list(CASES).index(name))
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kh, d)).astype(np.float32)
    cot = rng.normal(size=(b, s, h, d)).astype(np.float32)
    valid = None
    if CASES[name][6]:
        valid = np.ones((b, s), bool)
        valid[0, :s // 2 + 3] = False  # a left-padded row: whole chunks without a key
        valid[-1, -5:] = False
    return q, k, v, cot, valid


def _jax_reference(name):
    """JAX's output and gradients of ``sum(out * cot)`` on the global arrays."""
    from accelerate_tpu.ops.pallas_attention import ring_attention_pallas
    from accelerate_tpu.ops.ring_attention import ring_attention
    from accelerate_tpu.ops.ulysses_attention import ulysses_attention

    _, kind, _, mesh_kw, _, causal, _, _ = CASES[name]
    q, k, v, cot, valid = _inputs(name)
    mesh = _jax_mesh(mesh_kw)
    kw = {} if valid is None else {"kv_valid": jnp.asarray(valid)}

    def fn(q, k, v):
        if kind == "ring":
            return ring_attention(q, k, v, mesh=mesh, causal=causal, **kw)
        if kind == "pallas":
            return ring_attention_pallas(q, k, v, mesh=mesh, causal=causal, interpret=True)
        return ulysses_attention(q, k, v, mesh=mesh, causal=causal, **kw)

    def run(q, k, v):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out,) + vjp(jnp.asarray(cot))

    return [np.asarray(t) for t in jax.jit(run)(q, k, v)]


@pytest.fixture(scope="module")
def refs():
    pool = ThreadPoolExecutor(max_workers=2)
    futures = {name: pool.submit(_jax_reference, name) for name in CASES}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    # The two worlds start side by side (each waits for its processes).
    with ThreadPoolExecutor(max_workers=2) as pool:
        starting = {n: pool.submit(World, n, tmp_path_factory.mktemp(f"sp_attn_{n}"), threads=1)
                    for n in (2, 4)}
        out = {n: f.result() for n, f in starting.items()}
    yield out
    for w in out.values():
        w.close()


def _chunk(x, coords, mesh_kw, tp_heads):
    n, i = mesh_kw.get("sp", 1), coords["sp"]
    s = x.shape[1] // n
    out = x[:, i * s:(i + 1) * s]
    if tp_heads:
        per = out.shape[2] // mesh_kw["tp"]
        out = out[:, :, coords["tp"] * per:(coords["tp"] + 1) * per]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_attention_matches_jax(refs, worlds, name):
    kind, _, size, mesh_kw, _, causal, _, tp_heads = CASES[name]
    q, k, v, cot, valid = _inputs(name)
    outs = worlds[size].run("torch_sp_tasks:attention", kind, mesh_kw, q, k, v, cot, causal,
                            valid, tp_heads)
    want = dict(zip(("out", "dq", "dk", "dv"), refs[name].result()))
    for rank, got in enumerate(outs):
        for key, w in want.items():
            np.testing.assert_allclose(got[key].numpy(),
                                       _chunk(w, got["coords"], mesh_kw, tp_heads),
                                       atol=TOL, rtol=TOL, err_msg=f"{name} rank {rank} {key}")
    comm = set(outs[0]["comm"])
    if kind == "ulysses":
        assert "all_to_all:sp" in comm, comm
    else:
        assert "ppermute:sp" in comm, comm


def test_ulysses_head_divisibility_error(worlds):
    from accelerate_tpu.ops.ulysses_attention import ulysses_attention

    q = jnp.zeros((1, 64, 2, 16))
    with pytest.raises(ValueError) as je:
        ulysses_attention(q, q, q, mesh=_jax_mesh(dict(sp=4)), causal=True)
    got = worlds[4].run("torch_sp_tasks:ulysses_error", dict(sp=4), (1, 16, 2, 16))
    assert got == [str(je.value)] * 4


def test_fused_ring_refusals(worlds):
    for out in worlds[2].run("torch_sp_tasks:fused_refusal", dict(sp=2)):
        assert "ring/ulysses" in out["layoutless"]
        assert "kv_valid" in out["kv_valid"]


# -- without a world ---------------------------------------------------------------------


def test_kv_expansion_equals_jax():
    from accelerate_tpu.ops.ulysses_attention import _kv_expansion as jax_rule

    from accelerate_tpu_torch.ops.ulysses_attention import _kv_expansion

    for h in (4, 8, 12, 16, 32):
        for kh in (1, 2, 4, 8):
            for n in (1, 2, 4, 8):
                if h % kh == 0 and h % n == 0:
                    assert _kv_expansion(h, kh, n) == jax_rule(h, kh, n), (h, kh, n)
    assert _kv_expansion(8, 2, 4) == 2  # lcm(2, 4) = 4 kv heads, not 8


def test_tp_head_axis_equals_jax():
    from accelerate_tpu.ops.ring_attention import tp_head_axis as jax_rule

    from accelerate_tpu_torch.ops.ring_attention import tp_head_axis

    for mesh_kw in (dict(sp=2), dict(sp=2, tp=2), dict(sp=2, tp=4), dict(tp=2)):
        jmesh = _jax_mesh(mesh_kw)
        shape = {a: mesh_kw.get(a, 1) for a in AXES}

        class Shape:
            pass

        tmesh = Shape()
        tmesh.shape = shape
        for h, kh, extra in ((4, 4, 1), (4, 2, 2), (4, 1, 1), (8, 4, 4), (2, 2, 2)):
            assert tp_head_axis(tmesh, h, kh, extra) == jax_rule(jmesh, h, kh, extra)


def test_single_process_paths_are_the_local_attention():
    from accelerate_tpu_torch.ops.fused_attention import fused_attention_fwd_plain
    from accelerate_tpu_torch.ops.ring_attention import (
        full_sequence_attention,
        ring_attention,
        resolve_sp_mesh,
    )
    from accelerate_tpu_torch.ops.ring_fused import ring_fused_attention, \
        ring_fused_attention_plain
    from accelerate_tpu_torch.ops.ulysses_attention import ulysses_attention

    assert resolve_sp_mesh(None, "sp") is None
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 64, 4, 64, generator=g)
    k = torch.randn(2, 64, 2, 64, generator=g)
    want = full_sequence_attention(q, k, k, causal=True)
    for got in (ring_attention(q, k, k), ulysses_attention(q, k, k),
                ring_fused_attention(q, k, k, block_size=64),
                ring_fused_attention_plain(q, k, k, block_size=64),
                fused_attention_fwd_plain(q, k, k, block_size=64)[0]):
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
