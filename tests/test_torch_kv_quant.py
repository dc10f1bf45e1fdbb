"""The port's int8 KV cache (``kv_cache_quant``) on the CPU, against the JAX
package on the same numpy-seeded inputs.

- ``quantize_kv`` codes and bf16 scales equal JAX's, and ``dequantize_kv``
  is exact (both divide by the scale in the rows' dtype and store its bf16
  rounding);
- the int8 ``paged_cache_write`` stores the same codes and scales and its
  fp32 context is within 1e-6 of JAX's;
- int8 ``apply_cached`` / ``apply_paged`` logits are within 1e-4 of JAX's
  on ``LlamaConfig.tiny`` (fp32), and they store the same codes; an int8
  pool takes the plain path under ``kernel=True``, as JAX's does;
- the serving engine with ``kv_cache_quant`` is token-identical to JAX
  ``generate`` with ``kv_cache_quant``, on the paged and the dense path,
  under a pool tight enough to preempt.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import generation as jgen
from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch.models import generation as tgen
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.ops import paged_attention as pa
from accelerate_tpu_torch.serving import ServingConfig, ServingEngine
from accelerate_tpu_torch.utils.convert import llama_params_from_jax

CTX_TOL = dict(rtol=0, atol=1e-6)  # fp32 context of the int8 paged write
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 logits, tiny llama


def _rows(seed, shape, scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: the scale floors at 1e-6 / 127
    x[-1, -1, ..., 0] = 127.0 * 0.5  # ties at .5 round half to even
    return x


@pytest.mark.parametrize("seed,shape", [(0, (3, 5, 2, 16)), (1, (2, 7, 4, 32)), (2, (1, 9, 8, 64))])
def test_quantize_kv_codes_and_scales_match_jax(seed, shape):
    x = _rows(seed, shape)
    jc, js = jgen.quantize_kv(jnp.asarray(x))
    tc, ts = tgen.quantize_kv(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_kv_is_exact(dtype):
    x = _rows(3, (4, 6, 2, 16))
    jc, js = jgen.quantize_kv(jnp.asarray(x))
    tc, ts = tgen.quantize_kv(torch.from_numpy(x))
    want = np.asarray(jgen.dequantize_kv(jc, js, getattr(jnp, dtype)).astype(jnp.float32))
    got = tgen.dequantize_kv(tc, ts, getattr(torch, dtype)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_int8_paged_cache_write_matches_jax():
    rng = np.random.default_rng(4)
    n, bs, k, hd = 9, 4, 2, 16
    codes = rng.integers(-127, 128, size=(n, bs, k, hd)).astype(np.int8)
    scale = (rng.random((n, bs, k)) * 0.05).astype(np.float32)
    jscale = jnp.asarray(scale).astype(jnp.bfloat16)
    tscale = torch.from_numpy(scale).to(torch.bfloat16)
    new = (rng.standard_normal((2, 3, k, hd)) * 2).astype(np.float32)
    tables = np.array([[3, 1, 7], [2, 8, 0]], np.int32)
    starts = np.array([5, 1], np.int32)
    (jsc, jss), jctx = jgen.paged_cache_write(
        (jnp.asarray(codes), jscale), jnp.asarray(new), jnp.asarray(tables), jnp.asarray(starts),
        jnp.float32)
    (tsc, tss), tctx = tgen.paged_cache_write(
        (torch.from_numpy(codes), tscale), torch.from_numpy(new), torch.from_numpy(tables),
        torch.from_numpy(starts), torch.float32)
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(tss.float().numpy(), np.asarray(jss.astype(jnp.float32)))
    assert tuple(tctx.shape) == (2, 3 * bs, k, hd)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), **CTX_TOL)


@pytest.fixture(scope="module")
def quant_setup():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, kv_cache_quant=True)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, kv_cache_quant=True)
    jparams = jl.init_params(jcfg, jax.random.key(0))
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_int8_apply_cached_matches_jax(quant_setup):
    jcfg, tcfg, jparams, tparams = quant_setup
    ids = np.random.default_rng(5).integers(0, jcfg.vocab_size, size=(2, 7)).astype(np.int32)
    jcache = jl.init_cache(jcfg, 2, 12)
    tcache = tl.init_cache(tcfg, 2, 12, device="cpu")
    assert {n: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for n, v in tcache.items() if n != "index"} == {
        n: (tuple(v.shape), str(v.dtype)) for n, v in jcache.items() if n != "index"}
    # Two calls: a prompt, then one token against the written int8 cache.
    for s in (slice(0, 6), slice(6, 7)):
        jlog, jcache = jl.apply_cached(jparams, jnp.asarray(ids[:, s]), jcfg, jcache)
        tlog, tcache = tl.apply_cached(tparams, torch.from_numpy(ids[:, s]), tcfg, tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    for n in ("k", "v"):
        np.testing.assert_array_equal(tcache[n].numpy(), np.asarray(jcache[n]))
        np.testing.assert_array_equal(tcache[n + "_scale"].float().numpy(),
                                      np.asarray(jcache[n + "_scale"].astype(jnp.float32)))


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("kernel", [False, True])
def test_int8_apply_paged_matches_jax(quant_setup, t, kernel):
    """Logits within 1e-4 and identical stored rows; ``kernel=True`` on an
    int8 pool is the plain path on both sides and launches no kernel."""
    jcfg, tcfg, jparams, tparams = quant_setup
    rng = np.random.default_rng(6 + t)
    tmpl = jl.init_cache(jcfg, 1, 4)
    pool = {}
    for n, leaf in tmpl.items():
        if n == "index":
            continue
        shape = (leaf.shape[0], 10) + tuple(leaf.shape[2:])
        if leaf.dtype == jnp.int8:
            pool[n] = rng.integers(-127, 128, size=shape).astype(np.int8)
        else:
            pool[n] = (rng.random(shape) * 0.05).astype(np.float32)
    tables = np.array([[1, 4, 7, 0], [2, 3, 0, 0], [9, 8, 6, 5]], np.int32)
    starts = np.array([9, 2, 13], np.int32)
    ids = rng.integers(0, jcfg.vocab_size, size=(3, t)).astype(np.int32)
    jpool = {n: jnp.asarray(v) if v.dtype == np.int8 else jnp.asarray(v).astype(jnp.bfloat16)
             for n, v in pool.items()}
    tpool = {n: torch.from_numpy(v) if v.dtype == np.int8
             else torch.from_numpy(v).to(torch.bfloat16) for n, v in pool.items()}
    jlog, jrows = jl.apply_paged(jparams, jnp.asarray(ids), jcfg, jpool, jnp.asarray(tables),
                                 jnp.asarray(starts), kernel=kernel)
    before = (pa.paged_attention.launches, pa.paged_window_attention.launches)
    tlog, trows = tl.apply_paged(tparams, torch.from_numpy(ids), tcfg, tpool,
                                 torch.from_numpy(tables), torch.from_numpy(starts), kernel=kernel)
    assert (pa.paged_attention.launches, pa.paged_window_attention.launches) == before
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    assert sorted(trows) == sorted(jrows)
    for n, r in trows.items():
        np.testing.assert_array_equal(r.float().numpy(), np.asarray(jrows[n].astype(jnp.float32)))


@pytest.mark.parametrize("decode_path", ["paged", "dense"])
def test_engine_kv_quant_token_identical_to_jax_generate(quant_setup, decode_path):
    jcfg, tcfg, jparams, tparams = quant_setup
    rng = np.random.default_rng(8)
    prompts = [list(rng.integers(0, jcfg.vocab_size, size=9)) for _ in range(3)]
    max_new = 8
    want = np.asarray(jl.generate(jparams, jnp.asarray(prompts, jnp.int32), jcfg,
                                  max_new_tokens=max_new))
    eng = ServingEngine(tl.apply_cached, tl.init_cache, tparams, tcfg, device="cpu",
                        serving=ServingConfig(block_size=4, num_blocks=8, max_slots=3,
                                              prefill_chunk=4, max_blocks_per_seq=8,
                                              paged_kernel=True, decode_path=decode_path))
    assert eng.decode_path == decode_path
    assert eng.cache.pool["k"].dtype == torch.int8
    ids = [eng.submit(p, max_new) for p in prompts]
    out = eng.run(max_ticks=2000)
    for rid, w in zip(ids, want):
        assert out[rid] == [int(x) for x in w], f"request {rid} diverged from JAX int8 generate"
    assert eng.stats()["preempted"] > 0, "the pool should be tight enough to preempt"
    assert eng.cache.allocator.used_blocks == 0
