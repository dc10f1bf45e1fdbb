"""Offline speculative decoding in the port
(``accelerate_tpu_torch/models/generation.py`` ``speculative_generate_loop``,
``llama.speculative_generate``) against the JAX package on tiny llama (fp32,
2 layers), greedy and rejection-sampled, with three drafts: the target
itself, a weak draft (same geometry, other weights) and a smaller-geometry
draft (1 layer, narrower).  Tokens and ``return_stats`` must equal JAX's;
the sampled runs draw through :class:`torch_jax_key.JaxKey`, so every key
of JAX's tree (first token, round, drafts, uniforms, fill) is exercised."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.utils.convert import llama_params_from_jax
from accelerate_tpu_torch.utils.random import PRNGKey
from torch_jax_key import JaxKey

DRAFTS = {
    "same_model": None,
    "weak": dict(seed=7),
    "smaller": dict(seed=3, num_layers=1, hidden_size=32, intermediate_size=64, num_heads=2,
                    num_kv_heads=1),
}


def _pair(seed=0, **kw):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
    jparams = jl.init_params(jcfg, jax.random.key(seed))
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def models():
    target = _pair()
    drafts = {name: target if kw is None else _pair(**kw) for name, kw in DRAFTS.items()}
    return target, drafts


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("draft", sorted(DRAFTS))
def test_speculative_generate_matches_jax(models, draft, temperature):
    (jcfg, tcfg, jparams, tparams), drafts = models
    djcfg, dtcfg, djparams, dtparams = drafts[draft]
    ids = np.random.default_rng(len(draft)).integers(0, jcfg.vocab_size, size=(1, 6))
    ids = ids.astype(np.int32)
    key = jax.random.key(17)
    want, wstats = jl.speculative_generate(
        jparams, djparams, jnp.asarray(ids), jcfg, djcfg, 13, num_draft_tokens=3,
        return_stats=True, temperature=temperature, key=key)
    got, gstats = tl.speculative_generate(
        tparams, dtparams, torch.from_numpy(ids), tcfg, dtcfg, 13, num_draft_tokens=3,
        return_stats=True, temperature=temperature, key=JaxKey(key))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gstats == {k: int(v) for k, v in wstats.items()}
    if draft == "same_model":
        assert gstats["accepted"] == gstats["proposed"] > 0
    if temperature == 0.0:
        # Greedy speculation is greedy decoding with the target alone.
        assert torch.equal(got, tl.generate(tparams, torch.from_numpy(ids), tcfg, 13))


def test_speculative_rewind_leaves_no_stale_row_visible(models):
    """A weak draft is rejected in most rounds, so the caches are rewound
    over written rows again and again; the output stays greedy's for a run
    long enough to cross many rounds, with a max_len that leaves the
    overshoot room only."""
    (_, tcfg, _, tparams), drafts = models
    _, dtcfg, _, dtparams = drafts["weak"]
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 256, size=(1, 4)))
    out, stats = tl.speculative_generate(tparams, dtparams, ids, tcfg, dtcfg, 40,
                                         num_draft_tokens=4, max_len=4 + 40 + 4,
                                         return_stats=True)
    assert stats["accepted"] < stats["proposed"]
    assert torch.equal(out, tl.generate(tparams, ids, tcfg, 40))


INVALID = {
    "batch_two": dict(batch=2),
    "sampling_without_key": dict(temperature=0.5, key=None),
    "no_draft_tokens": dict(num_draft_tokens=0),
    "vocab_mismatch": dict(draft_vocab=128),
    "negative_new_tokens": dict(max_new_tokens=-1),
    "no_overshoot_room": dict(max_len=10),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_speculative_raises_as_jax_does(models, case):
    (jcfg, tcfg, jparams, tparams), _ = models
    kw = dict(INVALID[case])
    batch = kw.pop("batch", 1)
    n = kw.pop("max_new_tokens", 4)
    djcfg, dtcfg, djparams, dtparams = (
        _pair(vocab_size=kw.pop("draft_vocab")) if "draft_vocab" in kw
        else (jcfg, tcfg, jparams, tparams))
    ids = np.zeros((batch, 5), np.int32)
    jkw = dict(kw, key=kw.get("key", jax.random.key(0)))
    tkw = dict(kw, key=None if jkw["key"] is None else PRNGKey(0))
    with pytest.raises(ValueError) as jerr:
        jl.speculative_generate(jparams, djparams, jnp.asarray(ids), jcfg, djcfg, n, **jkw)
    with pytest.raises(ValueError) as terr:
        tl.speculative_generate(tparams, dtparams, torch.from_numpy(ids), tcfg, dtcfg, n, **tkw)
    assert str(terr.value) == str(jerr.value)
