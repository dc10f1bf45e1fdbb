"""Serving on several processes (``apply_cached`` / ``apply_paged`` with a
``layout``, the engine in lockstep), against the JAX package on whole
weights.

Two module-scoped gloo worlds (``torch_dp_world``), of 2 and 4 CPU
processes, started side by side; tasks in ``torch_serving_tasks.py``.  Each
process prepares the tiny fp32 family on the JAX weights on its mesh and
keeps its shards; JAX's references run in a thread beside the worlds.

- llama on ``tp=2``, ``fsdp=2``, ``fsdp=2 x tp=2``, ``tp=4`` over 2 kv
  heads, ``tp=2`` over one kv head and ``tp=4`` over 12 / 6 heads (a rank's
  3 query heads read two kv heads unequally, so its pool holds a copy for
  each query head): a prefill chunk, a decode step and a 4-token window
  through ``apply_paged`` (``kernel`` both ways, the plain versions on the
  CPU) against its heads of one random pool, and ``apply_cached`` against
  its heads of one random cache.  The logits are JAX's ``apply_paged`` /
  ``apply_cached``'s, the rows written are JAX's at this process's kv
  heads, and the width ``init_cache`` gives is ``K / tp`` where ``tp``
  divides the kv heads;
- GPT-2 on ``tp=2`` (4 heads, and 5, which ``tp`` does not divide: every
  rank computes and caches every head) and ``fsdp=2``, and Mixtral on
  ``ep=2`` and ``ep=2 x tp=2``, the same;
- the engine on ``tp=2`` over a tight pool that preempts, with
  ``spec_tokens`` 3, and over an int8 pool with a host tier: every rank's
  tokens are the JAX engine's on whole weights, its pool half of one
  process's, ``decode_dispatches`` equal across ranks; Mixtral's dense path
  on ``ep=2`` likewise; ``generate`` of a model prepared on ``tp=2`` and
  ``llama.apply`` on its layout against JAX's;
- lockstep: rank 1's clock 1 s ahead sheds a request whose deadline falls
  between the two clocks on the same tick on both ranks; a SIGTERM to rank 1
  drains both on the same tick; one request more on rank 1 raises on both.

The logits, rows and caches are held to 2e-5 absolute and 1e-4 relative
(fp32; the largest gap measured here is 2.7e-6, about 7x under it: the
port's products and the partial sums over ``tp`` round apart from XLA's).
"""

import importlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from torch_dp_world import World

ATOL, RTOL = 2e-5, 1e-4
BS = 4  # the paged cases' block size

# name: (family, config overrides, mesh, world)
CASES = {
    "llama_tp2": ("llama", {}, dict(tp=2), 2),
    "llama_fsdp2": ("llama", {}, dict(fsdp=2), 2),
    "llama_fsdp2xtp2": ("llama", {}, dict(fsdp=2, tp=2), 4),
    "llama_tp4_kv2": ("llama", {}, dict(tp=4), 4),
    "llama_tp2_kv1": ("llama", dict(num_kv_heads=1), dict(tp=2), 2),
    "llama_tp4_unequal": ("llama", dict(num_heads=12, num_kv_heads=6, head_dim=16),
                          dict(tp=4), 4),
    "gpt2_tp2": ("gpt2", {}, dict(tp=2), 2),
    "gpt2_tp2_heads5": ("gpt2", dict(hidden_size=80, num_heads=5), dict(tp=2), 2),
    "gpt2_fsdp2": ("gpt2", {}, dict(fsdp=2), 2),
    "mixtral_ep2": ("mixtral", {}, dict(ep=2), 2),
    "mixtral_ep2xtp2": ("mixtral", {}, dict(ep=2, tp=2), 4),
}
_CONFIGS = {"llama": "LlamaConfig", "mixtral": "MixtralConfig", "gpt2": "GPT2Config"}


def _jfam(family):
    return importlib.import_module(f"accelerate_tpu.models.{family}")


def _jax_cfg(family, cfg_kw=(), **extra):
    return getattr(_jfam(family), _CONFIGS[family]).tiny(dtype=jnp.float32, **dict(cfg_kw),
                                                         **extra)


def _params(family, jcfg):
    fam = _jfam(family)
    return jax.tree.map(np.asarray, jax.jit(lambda k: fam.init_params(jcfg, k))(
        jax.random.key(0)))


def _heads_and_dim(family, jcfg):
    if family == "gpt2":
        return jcfg.num_heads, jcfg.head_dim
    return jcfg.num_kv_heads, jcfg.head_dim_


def _inputs(family, jcfg):
    """One random pool and dense cache (every kv head) and the forwards'
    token ids: a prefill chunk of 8 (batch 1), a decode step (batch 3) and a
    4-token window (batch 2) on the pool; 3 tokens at index 5 on the
    cache."""
    rng = np.random.default_rng(3)
    kh, hd = _heads_and_dim(family, jcfg)
    v = jcfg.vocab_size
    paged = []
    if family != "mixtral":
        pool = {n: rng.standard_normal((jcfg.num_layers, 12, BS, kh, hd)).astype(np.float32)
                for n in ("k", "v")}
        for ids_shape, tables, starts in (
                ((1, 8), [[3, 5, 7, 0]], [4]),
                ((3, 1), [[3, 5, 0, 0], [1, 0, 0, 0], [2, 4, 6, 8]], [6, 0, 13]),
                ((2, 4), [[9, 10, 11, 0], [1, 2, 0, 0]], [5, 2])):
            paged.append((rng.integers(0, v, size=ids_shape).astype(np.int32),
                          np.asarray(tables, np.int32), np.asarray(starts, np.int32)))
    else:
        pool = None
    ck = rng.standard_normal((jcfg.num_layers, 2, 16, kh, hd)).astype(np.float32)
    cv = rng.standard_normal((jcfg.num_layers, 2, 16, kh, hd)).astype(np.float32)
    cache = (ck, cv, 5, rng.integers(0, v, size=(2, 3)).astype(np.int32))
    return pool, paged, cache


def _jax_forwards(family, jcfg, params, pool, paged, cache):
    fam = _jfam(family)
    p = jax.tree.map(jnp.asarray, params)
    out = {"paged": []}
    for ids, tables, starts in paged:
        logits, rows = fam.apply_paged(p, jnp.asarray(ids), jcfg,
                                       jax.tree.map(jnp.asarray, pool), jnp.asarray(tables),
                                       jnp.asarray(starts))
        out["paged"].append((np.asarray(logits), jax.tree.map(np.asarray, rows)))
    ck, cv, index, ids = cache
    logits, new = fam.apply_cached(p, jnp.asarray(ids), jcfg,
                                   {"k": jnp.asarray(ck), "v": jnp.asarray(cv),
                                    "index": jnp.asarray(index, jnp.int32)})
    out.update(cached=np.asarray(logits), k=np.asarray(new["k"]), v=np.asarray(new["v"]))
    return out


@pytest.fixture(scope="module", autouse=True)
def _restore_jax_global_mesh():
    before = jax.sharding.get_mesh()
    yield
    jax.set_mesh(before)


@pytest.fixture(scope="module")
def refs():
    """Every case's inputs and JAX's forwards, computed in a thread beside
    the worlds: ``refs[name]`` is a future of ``(params, inputs, want)``."""
    def one(name):
        family, cfg_kw = CASES[name][:2]
        jcfg = _jax_cfg(family, tuple(sorted(cfg_kw.items())))
        params = _params(family, jcfg)
        inputs = _inputs(family, jcfg)
        return params, inputs, _jax_forwards(family, jcfg, params, *inputs)

    pool = ThreadPoolExecutor(max_workers=1)
    futures = {name: pool.submit(one, name) for name in CASES}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_serving")
    with ThreadPoolExecutor(max_workers=2) as ex:
        two, four = ex.submit(World, 2, tmp, 1), ex.submit(World, 4, tmp, 1)
        ws = {2: two.result(), 4: four.result()}
    yield ws
    for w in ws.values():
        w.close()


def _run_both(worlds, calls):
    """``world.run`` of each ``(world size, task, args)`` in ``calls``, the
    worlds side by side; their results in order."""
    with ThreadPoolExecutor(max_workers=len(calls)) as ex:
        futures = [ex.submit(worlds[n].run, task, *args) for n, task, args in calls]
        return [f.result() for f in futures]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_forwards_match_jax(refs, worlds, name):
    family, cfg_kw, mesh_kw, n = CASES[name]
    params, (pool, paged, cache), want = refs[name].result()
    outs = worlds[n].run("torch_serving_tasks:forwards", family, params, cfg_kw, mesh_kw, pool,
                         paged, cache)
    kh = _heads_and_dim(family, _jax_cfg(family, tuple(sorted(cfg_kw.items()))))[0]
    tp = mesh_kw.get("tp", 1)
    seen = set()
    for rank, out in enumerate(outs):
        heads = out["heads"]
        seen.update(heads)
        assert out["init_heads"] == len(heads)
        if kh % tp == 0:
            assert len(heads) == kh // tp, (rank, heads)
        for i, got in enumerate(out["paged"]):
            wl, wrows = want["paged"][i // 2]
            what = f"{name} rank {rank} paged case {i // 2} kernel={got['kernel']}"
            np.testing.assert_allclose(got["logits"].numpy(), wl, atol=ATOL, rtol=RTOL,
                                       err_msg=what)
            for leaf in ("k", "v"):
                np.testing.assert_allclose(got["rows"][leaf].numpy(),
                                           wrows[leaf][..., heads, :], atol=ATOL, rtol=RTOL,
                                           err_msg=f"{what} rows {leaf}")
        what = f"{name} rank {rank} apply_cached"
        np.testing.assert_allclose(out["cached"].numpy(), want["cached"], atol=ATOL,
                                   rtol=RTOL, err_msg=what)
        assert out["index"] == cache[2] + cache[3].shape[1]
        np.testing.assert_allclose(out["cache_k"].numpy(), want["k"][..., heads, :], atol=ATOL,
                                   rtol=RTOL, err_msg=f"{what} cache k")
        np.testing.assert_allclose(out["cache_v"].numpy(), want["v"][..., heads, :], atol=ATOL,
                                   rtol=RTOL, err_msg=f"{what} cache v")
        if tp > 1:
            assert {"all_reduce:tp", "all_gather:tp"} <= set(out["comm"]), out["comm"]
        if mesh_kw.get("fsdp", 1) > 1:
            assert "all_gather:fsdp" in out["comm"], out["comm"]
    assert seen == set(range(kh)), f"{name}: the ranks' caches miss kv heads {seen}"


# -- the engine -------------------------------------------------------------

GEOMETRY = dict(block_size=4, num_blocks=12, max_slots=3, prefill_chunk=8,
                max_blocks_per_seq=8)


def _engine_prompts(vocab):
    rng = np.random.default_rng(21)
    shared = [int(t) for t in rng.integers(0, vocab, size=9)]
    return [shared + [int(t) for t in rng.integers(0, vocab, size=3)],
            shared + [int(t) for t in rng.integers(0, vocab, size=2)],
            [int(t) for t in rng.integers(0, vocab, size=6)],
            [5, 9, 2, 7] * 3,
            [int(t) for t in rng.integers(0, vocab, size=11)]]


BUDGETS = [7, 6, 9, 8, 5]
ENGINES = {
    "tight_spec3": ({}, dict(GEOMETRY, spec_tokens=3, paged_kernel=True)),
    "int8_host": (dict(kv_cache_quant=True), dict(GEOMETRY, host_blocks=16)),
}


def _jax_engine(family, jcfg, params, prompts, budgets, geometry, stagger=True):
    from accelerate_tpu.serving import ServingConfig as JServingConfig
    from accelerate_tpu.serving import ServingEngine as JServingEngine

    fam = _jfam(family)
    geo = {k: v for k, v in geometry.items() if k != "paged_kernel"}
    eng = JServingEngine(fam.apply_cached, fam.init_cache, jax.tree.map(jnp.asarray, params),
                         jcfg, serving=JServingConfig(**geo))
    ids = []
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        ids.append(eng.submit(p, m))
        if stagger and i % 2 == 1:
            eng.step()
    outputs = eng.run(max_ticks=3000)
    return [outputs[r] for r in ids], eng.stats()


@pytest.mark.parametrize("name", list(ENGINES))
def test_tp2_engine_matches_jax_engine(refs, worlds, name):
    cfg_kw, geometry = ENGINES[name]
    params = refs["llama_tp2"].result()[0]
    jcfg = _jax_cfg("llama", tuple(sorted(cfg_kw.items())))
    prompts = _engine_prompts(jcfg.vocab_size)
    with ThreadPoolExecutor(max_workers=1) as ex:
        jax_run = ex.submit(_jax_engine, "llama", jcfg, params, prompts, BUDGETS, geometry)
        sharded, whole = _run_both(worlds, [
            (2, "torch_serving_tasks:serve", ("llama", params, cfg_kw, dict(tp=2), prompts,
                                              BUDGETS, geometry)),
            (4, "torch_serving_tasks:serve", ("llama", params, cfg_kw, dict(dp=4), prompts,
                                              BUDGETS, geometry))])
        want, jstats = jax_run.result()
    for rank, out in enumerate(sharded + whole):
        assert out["tokens"] == want, f"{name} rank {rank} diverged from the JAX engine"
        assert out["decode_dispatches"] == jstats["decode_dispatches"]
        assert out["preempted"] == jstats["preempted"] > 0
        assert out["used_blocks"] == 0
    assert all(o["lockstep"] for o in sharded) and not any(o["lockstep"] for o in whole)
    for out in sharded:
        assert out["pool_shape"]["k"][3] == jcfg.num_kv_heads // 2
        assert 2 * out["pool_bytes"] == whole[0]["pool_bytes"]
    if geometry.get("spec_tokens"):
        keys = ("rounds", "proposed", "accepted")
        for out in sharded:
            assert {k: out["spec"][k] for k in keys} == {k: jstats["spec"][k] for k in keys}
            assert out["spec"]["accepted"] > 0
    if geometry.get("host_blocks"):
        assert set(sharded[0]["pool_shape"]) == {"k", "v", "k_scale", "v_scale"}
        keys = ("demotions", "promotions", "fallback_reprefills")
        for out in sharded:
            assert {k: out["tiering"][k] for k in keys} == {
                k: jstats["tiering"][k] for k in keys}


def test_mixtral_ep2_dense_engine_matches_jax(refs, worlds):
    params = refs["mixtral_ep2"].result()[0]
    jcfg = _jax_cfg("mixtral")
    prompts = [p[:8] for p in _engine_prompts(jcfg.vocab_size)[:4]]
    geometry = dict(block_size=4, num_blocks=24, max_slots=2, prefill_chunk=8,
                    max_blocks_per_seq=8)
    with ThreadPoolExecutor(max_workers=1) as ex:
        jax_run = ex.submit(_jax_engine, "mixtral", jcfg, params, prompts, BUDGETS[:4],
                            geometry, False)
        outs = worlds[2].run("torch_serving_tasks:serve", "mixtral", params, {}, dict(ep=2),
                             prompts, BUDGETS[:4], geometry, False)
        want, jstats = jax_run.result()
    for rank, out in enumerate(outs):
        assert out["decode_path"] == "dense" and out["lockstep"]
        assert out["tokens"] == want, f"mixtral ep=2 rank {rank} diverged from the JAX engine"
        assert out["decode_dispatches"] == jstats["decode_dispatches"]


def test_generate_and_apply_on_tp2_match_jax(refs, worlds):
    params = refs["llama_tp2"].result()[0]
    jcfg = _jax_cfg("llama")
    ids = np.random.default_rng(4).integers(0, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    p = jax.tree.map(jnp.asarray, params)
    want_tokens = np.asarray(_jfam("llama").generate(p, jnp.asarray(ids), jcfg, max_new_tokens=5))
    want_logits = np.asarray(_jfam("llama").apply(p, jnp.asarray(ids), jcfg))
    outs = worlds[2].run("torch_serving_tasks:generate_and_apply", params, {}, dict(tp=2), ids, 5)
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(np.asarray(out["tokens"]), want_tokens,
                                      err_msg=f"rank {rank} generate")
        np.testing.assert_allclose(out["logits"].numpy(), want_logits, atol=ATOL, rtol=RTOL,
                                   err_msg=f"rank {rank} apply")


LOCK_GEOMETRY = dict(block_size=4, num_blocks=16, max_slots=1, prefill_chunk=8,
                     max_blocks_per_seq=8, paged_kernel=True)


def test_lockstep_agrees_on_rank0s_clock(refs, worlds):
    """Rank 1's clock runs 1 s ahead.  The late request's deadline (0.5 s
    after an arrival both ranks are given) has passed on rank 1's own clock
    at the first tick, on rank 0's only after the 0.6 s sleep: both ranks
    shed it on the same tick, the second, and serve the first request to the
    same tokens without hanging."""
    params = refs["llama_tp2"].result()[0]
    prompts = _engine_prompts(_jax_cfg("llama").vocab_size)[:2]
    outs = worlds[2].run("torch_serving_tasks:lockstep_clock", params, {}, LOCK_GEOMETRY,
                         prompts, 1.0, 500.0, 0.6)
    assert outs[0]["late"][:2] == outs[1]["late"][:2] == (2, "deadline_expired"), outs
    assert outs[0]["first"] == outs[1]["first"] and outs[0]["first"][1] == "ok"
    assert outs[0]["decode_dispatches"] == outs[1]["decode_dispatches"]


def test_lockstep_drains_both_ranks_on_one_sigterm(refs, worlds):
    params = refs["llama_tp2"].result()[0]
    prompts = _engine_prompts(_jax_cfg("llama").vocab_size)[:3]
    outs = worlds[2].run("torch_serving_tasks:lockstep_sigterm", params, {},
                         dict(LOCK_GEOMETRY, max_slots=3), prompts, 3)
    assert [o["signalled"] for o in outs] == [False, True]
    assert all(o["drained"] for o in outs)
    assert outs[0]["ticks"] == outs[1]["ticks"] == 3
    assert outs[0]["journal"] == outs[1]["journal"] and outs[0]["journal"]


def test_lockstep_refuses_unequal_submissions(refs, worlds):
    """Rank 1 submits one request more than rank 0: the first tick raises on
    both ranks, naming the lockstep contract, instead of reducing tensors
    of two lengths."""
    params = refs["llama_tp2"].result()[0]
    prompts = _engine_prompts(_jax_cfg("llama").vocab_size)[:2]
    outs = worlds[2].run("torch_serving_tasks:lockstep_misuse", params, {}, LOCK_GEOMETRY,
                         prompts)
    for out in outs:
        assert out is not None and "lockstep" in out and "between 1 and 2" in out, outs
