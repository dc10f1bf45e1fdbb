"""Beam search in the port (``accelerate_tpu_torch/models/generation.py``
``beam_search``, ``llama.generate_beam``) against the JAX package on tiny
llama (fp32, 2 layers): token-identical best sequences for 1, 2 and 4
beams, length penalties 0.5, 1 and 2, EOS freezing (frozen beams fill
``cand`` with ``-inf``, where the tie order of the top-k decides) and the
int8 KV cache (its scale leaves are tiled and reordered with k and v)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch.models import generation as tgen
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.utils.convert import llama_params_from_jax


def _setup(**kw):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
    jparams = jl.init_params(jcfg, jax.random.key(0))
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def llama_setup():
    return _setup()


def _ids(seed, vocab, shape=(2, 6)):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _both(setup, ids, n, **kw):
    jcfg, tcfg, jparams, tparams = setup
    want = np.asarray(jl.generate_beam(jparams, jnp.asarray(ids), jcfg, n, **kw))
    got = tl.generate_beam(tparams, torch.from_numpy(ids), tcfg, n, **kw).numpy()
    return want, got


@pytest.mark.parametrize("num_beams,length_penalty", [(1, 1.0), (2, 0.5), (4, 1.0), (4, 2.0)])
def test_beam_search_matches_jax(llama_setup, num_beams, length_penalty):
    ids = _ids(num_beams, llama_setup[0].vocab_size)
    want, got = _both(llama_setup, ids, 7, num_beams=num_beams, length_penalty=length_penalty)
    np.testing.assert_array_equal(got, want)


def test_one_beam_is_greedy(llama_setup):
    _, tcfg, _, tparams = llama_setup
    ids = torch.from_numpy(_ids(9, tcfg.vocab_size))
    assert torch.equal(tl.generate_beam(tparams, ids, tcfg, 8, num_beams=1),
                       tl.generate(tparams, ids, tcfg, 8))


@pytest.mark.parametrize("rank,num_beams", [(0, 4), (1, 2), (3, 4)])
def test_eos_freezing_matches_jax(llama_setup, rank, num_beams):
    """EOS is the token of the given rank at the first expansion of row 0,
    so a beam freezes from the first step on (rank 0: the best one) and the
    frozen beams' ``-inf`` candidates meet the top-k's tie order."""
    jcfg, tcfg, _, tparams = llama_setup
    ids = _ids(20 + rank, jcfg.vocab_size)
    cache = tl.init_cache(tcfg, 2, ids.shape[1], device="cpu")
    logits, _ = tl.apply_cached(tparams, torch.from_numpy(ids), tcfg, cache)
    eos = int(torch.argsort(logits[0, -1], descending=True)[rank])
    want, got = _both(llama_setup, ids, 8, num_beams=num_beams, eos_token_id=eos,
                      length_penalty=1.5)
    np.testing.assert_array_equal(got, want)


def test_beam_search_int8_cache_matches_jax():
    setup = _setup(kv_cache_quant=True)
    ids = _ids(31, setup[0].vocab_size)
    want, got = _both(setup, ids, 6, num_beams=3)
    np.testing.assert_array_equal(got, want)


def test_beam_tiling_covers_the_int8_scales():
    """Every cache tensor with the batch on axis 1, scales included, is
    repeated per beam (``repeat_interleave``: beams of one row adjacent);
    the Python write index is left alone."""
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, kv_cache_quant=True)
    cache = tl.init_cache(cfg, 2, 5, device="cpu")
    for name in ("k", "k_scale", "v", "v_scale"):
        cache[name][:, 1] = 1
    cache["index"] = 3
    tiled = tgen._tile_beams(cache, 2, lambda leaf: leaf.repeat_interleave(3, dim=1))
    assert tiled["index"] == 3
    for name in ("k", "k_scale", "v", "v_scale"):
        assert tiled[name].shape[1] == 6
        assert (tiled[name][:, :3] == 0).all() and (tiled[name][:, 3:] == 1).all()


def test_top_k_breaks_ties_to_the_lower_index_as_jax():
    x = torch.tensor([[0.0, 2.0, float("-inf"), 2.0, 1.0, float("-inf"), float("-inf")]])
    vals, idx = tgen._top_k(x, 5)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.fixture(scope="module")
def three_token_setup():
    return _setup(vocab_size=3)


@pytest.mark.parametrize("case", ["no_new_tokens", "no_beams", "too_long", "beams_over_vocab"])
def test_beam_search_raises_as_jax_does(three_token_setup, case):
    jcfg, tcfg, jparams, tparams = three_token_setup
    ids = np.zeros((1, 4), np.int32)
    kw = {"no_new_tokens": dict(max_new_tokens=0), "no_beams": dict(num_beams=0),
          "too_long": dict(max_len=5), "beams_over_vocab": dict(num_beams=4)}[case]
    n = kw.pop("max_new_tokens", 3)
    with pytest.raises(ValueError) as jerr:
        jl.generate_beam(jparams, jnp.asarray(ids), jcfg, n, **kw)
    with pytest.raises(ValueError) as terr:
        tl.generate_beam(tparams, torch.from_numpy(ids), tcfg, n, **kw)
    assert str(terr.value) == str(jerr.value)
