"""The draft-model drafter of the port (``accelerate_tpu_torch/serving/drafter.py``
``DraftModelDrafter``) against the JAX package's: the same proposals on the
same weights and feeds (power-of-two buckets, padding masked out, the
``max_len`` cap), and an engine that drafts with it serves the same tokens
with the same ``stats()["spec"]`` as the JAX engine with the JAX drafter."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import DraftModelDrafter as JDraft
from accelerate_tpu.serving import ServingConfig as JConfig
from accelerate_tpu.serving import ServingEngine as JEngine
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.serving import DraftModelDrafter, ServingConfig, ServingEngine
from accelerate_tpu_torch.utils.convert import llama_params_from_jax


def _pair(seed, **kw):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
    jparams = jl.init_params(jcfg, jax.random.key(seed))
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def models():
    return {"target": _pair(0), "draft": _pair(4, num_layers=1)}


def test_propose_matches_jax_across_buckets(models):
    jcfg, tcfg, jparams, tparams = models["draft"]
    jd = JDraft(jl.apply, jparams, jcfg)
    td = DraftModelDrafter(tl.apply, tparams, tcfg)
    rng = np.random.default_rng(0)
    # Feeds of 1..30 tokens: buckets 1 to 32, and proposals that cross one.
    for n in (1, 3, 6, 8, 15, 30):
        feed = [int(t) for t in rng.integers(0, jcfg.vocab_size, size=n)]
        assert td.propose(feed, 3) == jd.propose(feed, 3), n
    assert td.propose([1, 2], 0) == jd.propose([1, 2], 0) == []


def test_propose_stops_at_max_len_as_jax(models):
    jcfg, tcfg, jparams, tparams = models["draft"]
    feed = list(range(1, 15))
    jd = JDraft(jl.apply, jparams, jcfg, max_len=16)
    td = DraftModelDrafter(tl.apply, tparams, tcfg, max_len=16)
    got = td.propose(feed, 5)
    assert len(got) == 2 and got == jd.propose(feed, 5)


def test_propose_pads_right_and_masks_the_padding(models):
    """The proposal equals the argmax of an unpadded forward over the feed."""
    _, tcfg, _, tparams = models["draft"]
    feed = [7, 3, 99, 12, 40]
    got = DraftModelDrafter(tl.apply, tparams, tcfg).propose(feed, 1)
    with torch.no_grad():
        logits = tl.apply(tparams, torch.tensor([feed]), tcfg)
    assert got == [int(logits[0, -1].argmax())]


@pytest.mark.parametrize("draft", ["target", "draft"])
def test_engine_with_drafter_matches_jax_engine(models, draft):
    """Self-draft (every draft the target's own greedy token) and a weak
    1-layer draft through both engines: the same tokens per request and the
    same speculation counts."""
    jcfg, tcfg, jparams, tparams = models["target"]
    djcfg, dtcfg, djparams, dtparams = models[draft]
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(0, jcfg.vocab_size, size=n)) for n in (5, 11, 3, 9)]
    geometry = dict(block_size=4, num_blocks=24, max_slots=3, prefill_chunk=8,
                    max_blocks_per_seq=8, spec_tokens=3)
    jeng = JEngine(jl.apply_cached, jl.init_cache, jparams, jcfg, serving=JConfig(**geometry),
                   drafter=JDraft(jl.apply, djparams, djcfg))
    teng = ServingEngine(tl.apply_cached, tl.init_cache, tparams, tcfg, device="cpu",
                         serving=ServingConfig(paged_kernel=True, **geometry),
                         drafter=DraftModelDrafter(tl.apply, dtparams, dtcfg))
    jids = [jeng.submit(p, 8) for p in prompts]
    tids = [teng.submit(p, 8) for p in prompts]
    jout, tout = jeng.run(max_ticks=300), teng.run(max_ticks=300)
    for j, t in zip(jids, tids):
        assert tout[t] == jout[j]
    jspec, tspec = jeng.stats()["spec"], teng.stats()["spec"]
    assert tspec == jspec
    if draft == "target":
        assert tspec["accepted"] == tspec["proposed"] > 0
