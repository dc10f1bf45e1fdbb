"""The port's host-memory KV tier on the CPU, against the JAX package.

- ``HostBlockPool``, ``PagedKVCache.demote``/``promote`` and the tier half
  of ``PrefixCache`` are driven through the same random operation sequences
  as their JAX counterparts: the ids, counts and block contents must agree
  at every step, and every demoted block must come back bit-exact (fp32 and
  int8 pools);
- the engine under forced preemption with the tier on, paged and dense
  decode, fp and int8 KV, is token-identical to JAX ``generate``; a request
  resumed from the tier spends no prefill dispatch beyond its prompt's; its
  tier counts equal the JAX engine's on the same traffic;
- without host room, preemption falls back to the re-prefill, still
  token-identical;
- below the headroom watermark, cold prefix blocks move to the host tier
  and come back on a hit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import ServingConfig as JServingConfig
from accelerate_tpu.serving import ServingEngine as JServingEngine
from accelerate_tpu.serving import blocks as jblocks
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.serving import ServingConfig, ServingEngine
from accelerate_tpu_torch.serving import blocks as tblocks
from accelerate_tpu_torch.utils.convert import llama_params_from_jax

BS = 4


def _configs(quant):
    return (jl.LlamaConfig.tiny(dtype=jnp.float32, kv_cache_quant=quant),
            tl.LlamaConfig.tiny(dtype=torch.float32, kv_cache_quant=quant))


def _random_pools(jcfg, num_blocks, seed):
    """The same random pool content as JAX arrays and as torch tensors."""
    rng = np.random.default_rng(seed)
    jpool, tpool = {}, {}
    for n, leaf in jl.init_cache(jcfg, 1, BS).items():
        if n == "index":
            continue
        shape = (leaf.shape[0], num_blocks) + tuple(leaf.shape[2:])
        if leaf.dtype == jnp.int8:
            v = rng.integers(-127, 128, size=shape).astype(np.int8)
            jpool[n], tpool[n] = jnp.asarray(v), torch.from_numpy(v)
        else:
            v = rng.standard_normal(shape).astype(np.float32)
            jpool[n] = jnp.asarray(v).astype(leaf.dtype)
            tpool[n] = torch.from_numpy(v).to(getattr(torch, str(leaf.dtype)))
    return jpool, tpool


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _tiered_pair(quant, num_blocks, host_blocks, seed):
    jcfg, tcfg = _configs(quant)
    jkv = jblocks.PagedKVCache(jl.init_cache, jcfg, num_blocks, BS, num_host_blocks=host_blocks)
    tkv = tblocks.PagedKVCache(tl.init_cache, tcfg, num_blocks, BS, "cpu",
                               num_host_blocks=host_blocks)
    jkv.pool, tkv.pool = _random_pools(jcfg, num_blocks, seed)
    return jkv, tkv


@pytest.mark.parametrize("seed", [0, 1])
def test_host_pool_matches_jax(seed):
    """alloc / mark_dirty / free on both host pools: the same ids and
    counts, all-or-nothing grants, and a dirty block zeroed at free."""
    rng = np.random.default_rng(seed)
    jkv, tkv = _tiered_pair(False, 5, 6, seed)
    pools = [jkv.host, tkv.host]
    for p in pools:
        for leaf in p.leaves.values():
            leaf[...] = 7.0
    held = [[], []]
    for _ in range(120):
        op, n = int(rng.integers(0, 3)), int(rng.integers(1, 4))
        j = int(rng.integers(0, len(held[0]))) if held[0] else None
        log = []
        for i, (mod, p) in enumerate(zip((jblocks, tblocks), pools)):
            if op == 0:
                try:
                    got = p.alloc(n)
                    held[i].extend(got)
                except mod.BlockOutOfMemory:
                    got = "oom"
            elif j is not None:
                b = held[i].pop(j)
                if op == 1:
                    p.mark_dirty([b])
                p.free([b])
                got = (b, float(_as_np(next(iter(p.leaves.values()))[:, b]).max()))
            else:
                got = None
            log.append((got, p.free_blocks, p.used_blocks, round(p.occupancy, 6),
                        p.used_bytes() // p.block_bytes()))
        assert log[0] == log[1]
    assert tkv.host.pool_bytes() == tkv.host.capacity * tkv.host.block_bytes()
    with pytest.raises(ValueError, match="host double free"):
        tkv.host.free([tkv.host._free[-1]])


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_demote_promote_bit_exact_and_matches_jax(quant):
    """Random alloc / free / demote / promote on both tiered caches: equal
    host ids and counts in both tiers at every step, and every promoted
    block holds exactly what was demoted, on both sides."""
    rng = np.random.default_rng(3 + quant)
    jkv, tkv = _tiered_pair(quant, 13, 7, 11)
    live = []       # device blocks owned by the fuzz (same ids on both sides)
    on_host = []    # (host ids, the demoted rows per side)
    for _ in range(150):
        op = int(rng.integers(0, 4))
        if op == 0:
            n = int(rng.integers(1, 4))
            got = [kv.allocator.alloc(n) if kv.allocator.free_blocks >= n else None
                   for kv in (jkv, tkv)]
            assert got[0] == got[1]
            live.extend(got[0] or [])
        elif op == 1 and live:
            b = live.pop(int(rng.integers(0, len(live))))
            for kv in (jkv, tkv):
                kv.allocator.free([b])
        elif op == 2 and live:
            take = live[:int(rng.integers(1, 3))]
            rows = [{n: _as_np(leaf[:, take]) for n, leaf in kv.pool.items()}
                    for kv in (jkv, tkv)]
            ids = [kv.try_demote(take) for kv in (jkv, tkv)]
            assert ids[0] == ids[1]
            if ids[0] is not None:
                on_host.append((ids[0], rows))
                for kv in (jkv, tkv):
                    kv.allocator.free(take)
                del live[:len(take)]
        elif op == 3 and on_host:
            host_ids, rows = on_host.pop(int(rng.integers(0, len(on_host))))
            if jkv.allocator.free_blocks >= len(host_ids):
                dst = [kv.allocator.alloc(len(host_ids)) for kv in (jkv, tkv)]
                assert dst[0] == dst[1]
                for side, kv in enumerate((jkv, tkv)):
                    kv.promote(host_ids, dst[side])
                    for n, leaf in kv.pool.items():
                        np.testing.assert_array_equal(_as_np(leaf[:, dst[side]]), rows[side][n])
                for n in tkv.pool:
                    np.testing.assert_array_equal(rows[0][n], rows[1][n])
                live.extend(dst[0])
            else:
                on_host.append((host_ids, rows))
        for kv in (jkv, tkv):
            assert kv.allocator.used_blocks + kv.allocator.free_blocks == kv.allocator.capacity
            assert kv.host.used_blocks == sum(len(ids) for ids, _ in on_host)
        assert jkv.host._free == tkv.host._free
    for n in tkv.host.leaves:
        assert tkv.host.leaves[n].dtype == tkv.pool[n].dtype
        assert tuple(tkv.host.leaves[n].shape) == tuple(jkv.host.leaves[n].shape)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_tier_matches_jax(seed):
    """register / lookup / free / evict / drop_host_entries with a host tier
    attached, on the port and on JAX: the same blocks, rows, spills,
    promotions and drops at every step."""
    rng = np.random.default_rng(seed)
    sides = []
    for mod, kv in zip((jblocks, tblocks), _tiered_pair(False, 10, 4, seed)):
        cache = mod.PrefixCache(kv.allocator, 2)
        cache.attach_tier(kv)
        sides.append((mod, kv, cache))
    held = [[], []]
    log = [[], []]
    for _ in range(200):
        op = int(rng.choice(6, p=[0.1, 0.2, 0.2, 0.3, 0.1, 0.1]))
        n = int(rng.integers(1, 4))
        toks = [int(t) for t in rng.integers(0, 3, size=int(rng.integers(2, 9)))]
        for i, (mod, kv, cache) in enumerate(sides):
            alloc = kv.allocator
            try:
                if op == 0:
                    got = alloc.alloc(n)
                    held[i].extend(got)
                elif op == 1 and held[i]:
                    alloc.free([held[i].pop(0)])
                    got = None
                elif op == 2 and held[i]:
                    keys = cache.chain_keys(toks, 2)
                    got = [cache.register(k, held[i][j % len(held[i])])
                           for j, k in enumerate(keys)]
                elif op == 3:
                    blocks, rows, cow = cache.lookup(toks, len(toks) - 1)
                    held[i].extend(blocks + ([cow] if cow is not None else []))
                    got = (blocks, rows, cow)
                elif op == 4:
                    got = cache.evict(n)
                else:
                    got = cache.drop_host_entries(n if n < 3 else None)
            except mod.BlockOutOfMemory:
                got = "oom"
            log[i].append((got, alloc.free_blocks, alloc.used_blocks, len(cache),
                           cache.host_count, cache.host_demotions, cache.host_promotions,
                           cache.host_drops, kv.host.used_blocks))
    assert log[0] == log[1]
    assert log[1][-1][5] > 0 and log[1][-1][6] > 0, "the fuzz never spilled and promoted"


# ---------------------------------------------------------------------------
# The engine under pressure
# ---------------------------------------------------------------------------


PROMPT_LENS = (9, 13, 9)
MAX_NEW = (8, 6, 7)


@pytest.fixture(scope="module")
def setups():
    """Per KV layout: configs, weights on both sides, the prompts and each
    prompt's JAX ``generate`` continuation (8 tokens; shorter budgets are
    prefixes of it)."""
    out = {}
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, 256, size=n)) for n in PROMPT_LENS]
    for quant in (False, True):
        jcfg, tcfg = _configs(quant)
        jparams = jl.init_params(jcfg, jax.random.key(0))
        tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
        want = {}
        for n in sorted(set(PROMPT_LENS)):
            group = [i for i, p in enumerate(prompts) if len(p) == n]
            gen = np.asarray(jl.generate(jparams, jnp.asarray([prompts[i] for i in group],
                                                              jnp.int32), jcfg, max_new_tokens=8))
            for i, row in zip(group, gen):
                want[i] = [int(t) for t in row]
        out[quant] = (jcfg, tcfg, jparams, tparams, prompts, want)
    return out


def _geometry(**kw):
    base = dict(block_size=BS, num_blocks=8, max_slots=3, prefill_chunk=4, max_blocks_per_seq=6,
                host_blocks=16, paged_kernel=True)
    base.update(kw)
    return base


def _serve(setup, **kw):
    jcfg, tcfg, jparams, tparams, prompts, want = setup
    eng = ServingEngine(tl.apply_cached, tl.init_cache, tparams, tcfg, device="cpu",
                        serving=ServingConfig(**_geometry(**kw)))
    ids = [eng.submit(p, m) for p, m in zip(prompts, MAX_NEW)]
    out = eng.run(max_ticks=3000)
    for i, rid in enumerate(ids):
        expect = want[i][:len(prompts[i]) + MAX_NEW[i]]
        assert out[rid] == expect, f"request {i} diverged from JAX generate"
    assert eng.sched.preempted_count > 0, "the pool should be tight enough to preempt"
    assert eng.cache.allocator.used_blocks == 0
    done = {c.id: c for c in eng.pop_finished()}
    return eng, [done[rid] for rid in ids]


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("decode_path", ["paged", "dense"])
def test_tiered_preemption_token_identical_matrix(setups, decode_path, quant):
    eng, done = _serve(setups[quant], decode_path=decode_path)
    assert eng.decode_path == decode_path
    st = eng.stats()["tiering"]
    assert st["demotions"] > 0 and st["promotions"] > 0, st
    migrated = [(i, c) for i, c in enumerate(done) if c.migrations > 0]
    assert migrated, "no request went through the host tier"
    for i, c in migrated:
        if c.fallback_reprefills == 0:
            assert c.prefill_dispatches == -(-PROMPT_LENS[i] // 4), (
                f"request {i} re-prefilled on its resume from the host tier")
    # What stays on the host tier belongs to the prefix cache.
    assert eng.cache.host.used_blocks == eng._prefix.host_count


@pytest.mark.parametrize("spec_tokens", [0, 2])
def test_tier_counts_match_jax_engine(setups, spec_tokens):
    """The same traffic through the JAX engine (paged) and the port's: per
    request the same preemptions, migrations, fallbacks and prefill
    dispatches, and the same tier totals."""
    jcfg, tcfg, jparams, tparams, prompts, want = setups[False]
    geo = _geometry(spec_tokens=spec_tokens)
    geo.pop("paged_kernel")
    jeng = JServingEngine(jl.apply_cached, jl.init_cache, jparams, jcfg,
                          serving=JServingConfig(**geo))
    jids = [jeng.submit(p, m) for p, m in zip(prompts, MAX_NEW)]
    jeng.run(max_ticks=3000)
    jdone = {c.id: c for c in jeng.pop_finished()}
    eng, done = _serve(setups[False], spec_tokens=spec_tokens)
    fields = ("tokens", "preemptions", "migrations", "fallback_reprefills", "prefill_dispatches",
              "status")
    for rid, c in zip(jids, done):
        assert {f: getattr(c, f) for f in fields} == {f: getattr(jdone[rid], f) for f in fields}
    keys = ("demotions", "promotions", "demoted_blocks", "fallback_reprefills", "host_used",
            "prefix_host_entries", "prefix_host_drops")
    jst, st = jeng.stats(), eng.stats()
    assert {k: st["tiering"][k] for k in keys} == {k: jst["tiering"][k] for k in keys}
    assert (st["preempted"], st["prefill_dispatches"], st["decode_dispatches"]) == (
        jst["preempted"], jst["prefill_dispatches"], jst["decode_dispatches"])


@pytest.mark.parametrize("host_blocks", [0, 1])
def test_fallback_reprefill_without_host_room(setups, host_blocks):
    """No tier (0) or one too small for any victim (1): every preemption
    frees and re-prefills, and the tokens do not change."""
    eng, done = _serve(setups[False], host_blocks=host_blocks, prefix_cache=False)
    st = eng.stats()
    if host_blocks == 0:
        assert st["tiering"] is None and eng.cache.host is None
        return
    assert st["tiering"]["fallback_reprefills"] > 0 and st["tiering"]["promotions"] == 0
    assert sum(c.fallback_reprefills for c in done) == st["tiering"]["fallback_reprefills"]
    assert eng.cache.host.used_blocks == 0


def test_pressure_relief_below_watermark(setups, monkeypatch):
    """With the free list under the watermark, the tick moves cold prefix
    blocks to the host tier; the same prompt later promotes them back and
    is still token-identical."""
    monkeypatch.setenv("ACCELERATE_TPU_SERVING_HEADROOM_WATERMARK", "0.7")
    jcfg, tcfg, jparams, tparams, prompts, want = setups[False]
    prompt = prompts[1]  # 13 tokens: 3 full blocks to cache
    eng = ServingEngine(tl.apply_cached, tl.init_cache, tparams, tcfg, device="cpu",
                        serving=ServingConfig(block_size=BS, num_blocks=9, max_slots=2,
                                              prefill_chunk=8, max_blocks_per_seq=8,
                                              host_blocks=8, tier_demote_batch=8))
    a = eng.submit(prompt, 3)
    assert eng.run(max_ticks=300)[a] == want[1][:16]
    assert len(eng._prefix) == 3 and eng._prefix.host_count == 0
    eng.step()  # raw free 5 of 8 < 0.7: this tick demotes
    assert eng._prefix.host_demotions == 3 and eng.cache.host.used_blocks == 3
    # One episode so far: the request held 4 of 8 blocks, under 0.7 of the pool.
    assert eng.stats()["low_headroom_episodes"] == 1
    b = eng.submit(prompt, 3)
    assert eng.run(max_ticks=300)[b] == want[1][:16]
    assert eng._prefix.host_promotions > 0
    assert eng.stats()["prefix_hits"] == 1


def _apply_cached_only(params, ids, config, cache):
    """A family whose module has no ``apply_paged`` (this test module)."""
    return tl.apply_cached(params, ids, config, cache)


def test_family_without_apply_paged_serves_on_the_dense_path(setups):
    jcfg, tcfg, jparams, tparams, prompts, want = setups[False]
    eng = ServingEngine(_apply_cached_only, tl.init_cache, tparams, tcfg, device="cpu",
                        serving=ServingConfig(**_geometry()))
    assert eng.decode_path == "dense"
    ids = [eng.submit(p, m) for p, m in zip(prompts, MAX_NEW)]
    out = eng.run(max_ticks=3000)
    for i, rid in enumerate(ids):
        assert out[rid] == want[i][:len(prompts[i]) + MAX_NEW[i]]
    assert eng.stats()["tiering"]["promotions"] > 0
