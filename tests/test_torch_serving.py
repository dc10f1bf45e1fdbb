"""The port's serving engine (``accelerate_tpu_torch/serving``) on the CPU.

The oracle is the JAX package's greedy ``llama.generate`` on the same weights:
every request the port's engine serves — under a pool tight enough to force
preemption, with prefix sharing on, with and without speculative decode —
must come back token-identical.  The host-side pieces (allocator, prefix
cache, scheduler, drafter) are also driven through random operation
sequences beside their JAX-package counterparts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import blocks as jblocks
from accelerate_tpu.serving import scheduler as jsched
from accelerate_tpu.serving.drafter import NgramDrafter as JNgram
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.serving import (
    NgramDrafter,
    ServingConfig,
    ServingEngine,
    blocks as tblocks,
    scheduler as tsched,
)
from accelerate_tpu_torch.utils.convert import llama_params_from_jax


@pytest.fixture(scope="module")
def llama_setup():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    jparams = jl.init_params(jcfg, jax.random.key(0))
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _oracle(jcfg, jparams, prompt, max_new):
    out = jl.generate(jparams, jnp.asarray([prompt], jnp.int32), jcfg, max_new_tokens=max_new)
    return [int(t) for t in np.asarray(out[0])]


def _prompts(seed, vocab):
    """Two prompts sharing a 9-token prefix (prefix-cache hits and a
    copy-on-write tail at block size 4), a third unrelated one, and a
    repetitive one (n-gram drafts that the model can accept)."""
    rng = np.random.default_rng(seed)
    shared = list(rng.integers(0, vocab, size=9))
    return [
        shared + list(rng.integers(0, vocab, size=3)),
        shared + list(rng.integers(0, vocab, size=2)),
        list(rng.integers(0, vocab, size=6)),
        [5, 9, 2, 7] * 3,
    ]


@pytest.mark.parametrize("spec_tokens", [0, 2])
def test_engine_token_identical_to_jax_generate(llama_setup, spec_tokens):
    jcfg, tcfg, jparams, tparams = llama_setup
    prompts = _prompts(21, jcfg.vocab_size)
    max_new = 7
    want = [_oracle(jcfg, jparams, p, max_new) for p in prompts]
    eng = Accelerator(cpu=True).prepare_serving(
        tl.apply_cached, tl.init_cache, tparams, tcfg,
        block_size=4, num_blocks=12, max_slots=3, prefill_chunk=8, max_blocks_per_seq=8,
        paged_kernel=True, spec_tokens=spec_tokens,
    )
    ids = [eng.submit(p, max_new) for p in prompts]
    outputs = eng.run(max_ticks=400)
    for rid, w in zip(ids, want):
        assert outputs[rid] == w, f"request {rid} diverged from JAX generate"
    stats = eng.stats()
    assert stats["preempted"] > 0, "the pool should be tight enough to preempt"
    assert stats["prefix_hits"] > 0
    assert stats["completed"] == len(prompts) and stats["quarantined"] == 0
    assert eng.cache.allocator.used_blocks == 0
    if spec_tokens:
        assert stats["spec"]["rounds"] == stats["decode_dispatches"]
        assert stats["spec"]["proposed"] > 0


def test_quarantine_isolates_a_non_finite_request(llama_setup):
    """A NaN embedding row poisons exactly the request whose prompt uses
    that token; it completes as quarantined, the others stay identical."""
    jcfg, tcfg, jparams, tparams = llama_setup
    poisoned = dict(tparams, embed=tparams["embed"].clone())
    poisoned["embed"][200] = float("nan")
    prompts = [[1, 2, 3, 4, 5], [7, 200, 9], [11, 12, 13, 14]]
    eng = ServingEngine(tl.apply_cached, tl.init_cache, poisoned, tcfg, device="cpu",
                        serving=ServingConfig(block_size=4, num_blocks=16, max_slots=3,
                                              prefill_chunk=8, paged_kernel=True))
    ids = [eng.submit(p, 4) for p in prompts]
    eng.run(max_ticks=100)
    done = {c.id: c for c in eng.pop_finished()}
    assert done[ids[1]].status == "quarantined"
    for i in (0, 2):
        assert done[ids[i]].status == "ok"
        assert done[ids[i]].tokens == _oracle(jcfg, jparams, prompts[i], 4)
    assert torch.isfinite(eng.cache.pool["k"]).all(), "dirty blocks must be scrubbed"


def test_engine_defaults_to_cuda(llama_setup):
    _, tcfg, _, tparams = llama_setup
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="params are on cpu"):
            ServingEngine(tl.apply_cached, tl.init_cache, tparams, tcfg)
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tl.apply_cached, tl.init_cache, tparams, tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Accelerator()


@pytest.mark.parametrize("field,value", [
    ("host_blocks", 4), ("journal_path", "j.json"), ("trace", True), ("trace_dir", "t"),
    ("max_queue_depth", 3), ("default_ttft_deadline_ms", 5.0), ("default_deadline_ms", 5.0),
    ("decode_path", "dense"),
])
def test_unported_serving_fields_raise(llama_setup, tmp_path, field, value):
    """Every ``ServingConfig`` field is ported now, request tracing
    included: each one builds an engine that serves (``trace_dir`` gets the
    request's trace record)."""
    _, tcfg, _, tparams = llama_setup
    if field in ("journal_path", "trace_dir"):
        value = str(tmp_path / value)
    sc = ServingConfig(block_size=4, num_blocks=16, **{field: value})
    eng = ServingEngine(tl.apply_cached, tl.init_cache, tparams, tcfg, device="cpu", serving=sc)
    rid = eng.submit([1, 2, 3], 2, deadline_ms=60_000.0, ttft_deadline_ms=60_000.0)
    assert len(eng.run(max_ticks=50)[rid]) == 5
    if field in ("trace", "trace_dir"):
        assert eng.tracer is not None and len(eng.tracer.completed) == 1
    if field == "trace_dir":
        assert (tmp_path / value).is_dir() and any((tmp_path / value).iterdir())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_and_prefix_cache_match_jax(seed):
    """The same random alloc/retain/free/register/lookup/evict sequence on
    the port's allocator + prefix cache and on the JAX package's."""
    rng = np.random.default_rng(seed)
    sides = []
    for mod in (jblocks, tblocks):
        alloc = mod.BlockAllocator(10)
        sides.append((mod, alloc, mod.PrefixCache(alloc, 2)))
    held = [[], []]
    log = [[], []]
    for _ in range(200):
        op = rng.integers(0, 5)
        n = int(rng.integers(1, 4))
        toks = [int(t) for t in rng.integers(0, 3, size=int(rng.integers(2, 9)))]
        for i, (mod, alloc, cache) in enumerate(sides):
            try:
                if op == 0:
                    got = alloc.alloc(n)
                    held[i].extend(got)
                elif op == 1 and held[i]:
                    alloc.free([held[i].pop(0)])
                    got = None
                elif op == 2 and held[i]:
                    keys = cache.chain_keys(toks, 2)
                    got = [cache.register(k, held[i][j % len(held[i])]) for j, k in enumerate(keys)]
                elif op == 3:
                    blocks, rows, cow = cache.lookup(toks, len(toks) - 1)
                    held[i].extend(blocks + ([cow] if cow is not None else []))
                    got = (blocks, rows, cow)
                else:
                    got = cache.evict(n)
            except mod.BlockOutOfMemory:
                got = "oom"
            log[i].append((got, alloc.free_blocks, alloc.used_blocks, len(cache)))
    assert log[0] == log[1]


def test_scheduler_and_drafter_match_jax():
    """Admission, growth, LIFO preemption and finishing on both schedulers,
    plus n-gram drafts on random feeds."""
    rng = np.random.default_rng(3)
    scheds = []
    for mod, bmod in ((jsched, jblocks), (tsched, tblocks)):
        scheds.append((mod, mod.Scheduler(bmod.BlockAllocator(9), num_slots=3, block_size=2,
                                          max_blocks_per_seq=8, prefill_chunk=4,
                                          spec_overshoot=1)))
    trace = [[], []]
    for step in range(60):
        prompt = [int(t) for t in rng.integers(0, 50, size=int(rng.integers(1, 6)))]
        grow = int(rng.integers(0, 3))
        rows = int(rng.integers(1, 14))
        for i, (mod, s) in enumerate(scheds):
            if step % 3 == 0:
                s.submit(mod.Request(prompt, 3))
            admitted = s.admit(float(step))
            slots = sorted(s.slots)
            grown = s.grow_to(slots[grow % len(slots)], rows) if slots else None
            if step % 5 == 4 and s.slots:
                s.finish(min(s.slots), float(step))
            trace[i].append((admitted, grown, sorted((k, v.blocks) for k, v in s.slots.items()),
                             len(s.queue), s.preempted_count, s.allocator.free_blocks))
    assert trace[0] == trace[1]
    jd, td = JNgram(3, 1), NgramDrafter(3, 1)
    for _ in range(50):
        feed = [int(t) for t in rng.integers(0, 4, size=int(rng.integers(0, 12)))]
        k = int(rng.integers(0, 5))
        assert td.propose(feed, k) == jd.propose(feed, k)
