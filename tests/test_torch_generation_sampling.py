"""Sampled decoding in the port (``accelerate_tpu_torch/models/generation.py``
``select_token`` and ``generate_loop``) against the JAX package.

The port draws its noise through a key object (``fold_in``, ``gumbel``,
``uniform``).  Driven by :class:`torch_jax_key.JaxKey`, a key backed by
``jax.random``, it must pick JAX's exact tokens on the same logits and on
tiny llama (fp32, 2 layers): ``jax.random.categorical`` is the argmax of
JAX's Gumbel draw plus the logits.  The port's own key
(``utils.random.PRNGKey``) is held to reproducibility and to the softmax
distribution by a chi-square test."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import generation as jgen
from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch.models import generation as tgen
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.utils.convert import llama_params_from_jax
from accelerate_tpu_torch.utils.random import PRNGKey
from torch_jax_key import JaxKey

MODES = {
    "greedy": dict(temperature=0.0),
    "temperature": dict(temperature=0.7),
    "top_k": dict(temperature=1.0, top_k=5),
    "top_p": dict(temperature=0.9, top_p=0.6),
    "top_k_and_top_p": dict(temperature=1.3, top_k=12, top_p=0.8),
}


@pytest.fixture(scope="module")
def llama_setup():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    jparams = jl.init_params(jcfg, jax.random.key(0))
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_select_token_matches_jax(mode, seed):
    """Over a batch of 6 logit rows with a 64-token vocab, at steps 0 and 3:
    the same token per row as JAX ``select_token`` under the same key."""
    kw = MODES[mode]
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((6, 64)) * 2.0).astype(np.float32)
    key = jax.random.key(100 + seed)
    for step in (0, 3):
        want = np.asarray(jgen.select_token(jnp.asarray(logits), kw["temperature"], key, step,
                                            top_k=kw.get("top_k", 0), top_p=kw.get("top_p", 1.0)))
        got = tgen.select_token(torch.from_numpy(logits), kw["temperature"], JaxKey(key), step,
                                top_k=kw.get("top_k", 0), top_p=kw.get("top_p", 1.0))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_select_token_filters_keep_the_top_token_only_at_tiny_top_p():
    """top_p below the top token's probability keeps that token alone (the
    cut is on the mass before a token), so every draw returns the argmax."""
    logits = torch.tensor([[3.0, 1.0, 0.5, -1.0], [0.0, 4.0, 3.9, 1.0]])
    for i in range(8):
        got = tgen.select_token(logits, 1.0, PRNGKey(7), i, top_p=1e-3)
        assert got.tolist() == [0, 1]


@pytest.mark.parametrize("prefill_chunk", [None, 3])
@pytest.mark.parametrize("mode", ["temperature", "top_k_and_top_p"])
def test_sampled_generate_matches_jax(llama_setup, mode, prefill_chunk):
    jcfg, tcfg, jparams, tparams = llama_setup
    kw = MODES[mode]
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(2, 7)).astype(np.int32)
    key = jax.random.key(11)
    want = np.asarray(jl.generate(jparams, jnp.asarray(ids), jcfg, 9, key=key,
                                  prefill_chunk=prefill_chunk, **kw))
    got = tl.generate(tparams, torch.from_numpy(ids), tcfg, 9, key=JaxKey(key),
                      prefill_chunk=prefill_chunk, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_takes_the_jax_argument_order(llama_setup):
    """``generate(p, ids, cfg, n, temperature, key, max_len, top_k, top_p,
    prefill_chunk)``: the sixth positional argument is the key, as in JAX."""
    jcfg, tcfg, jparams, tparams = llama_setup
    ids = np.random.default_rng(4).integers(0, jcfg.vocab_size, size=(1, 5)).astype(np.int32)
    key = jax.random.key(2)
    want = np.asarray(jl.generate(jparams, jnp.asarray(ids), jcfg, 6, 0.8, key, 16, 20, 0.9, 2))
    got = tl.generate(tparams, torch.from_numpy(ids), tcfg, 6, 0.8, JaxKey(key), 16, 20, 0.9, 2)
    np.testing.assert_array_equal(got.numpy(), want)


INVALID = {
    "top_p_zero": dict(temperature=1.0, top_p=0.0),
    "top_p_above_one": dict(temperature=1.0, top_p=1.5),
    "top_k_negative": dict(temperature=1.0, top_k=-1),
    "filter_while_greedy": dict(top_k=5),
    "top_p_while_greedy": dict(top_p=0.5),
    "too_long": dict(max_len=8),
    "sampling_without_key": dict(temperature=0.5, key=None),
    "negative_new_tokens": dict(max_new_tokens=-1),
    "prefill_chunk_zero": dict(prefill_chunk=0),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_generate_raises_as_jax_does(llama_setup, case):
    jcfg, tcfg, jparams, tparams = llama_setup
    kw = dict(INVALID[case])
    n = kw.pop("max_new_tokens", 4)
    ids = np.zeros((1, 5), np.int32)
    jkw = dict(kw, key=kw.get("key", jax.random.key(0)))
    tkw = dict(kw, key=None if jkw["key"] is None else PRNGKey(0))
    with pytest.raises(ValueError) as jerr:
        jl.generate(jparams, jnp.asarray(ids), jcfg, n, **jkw)
    with pytest.raises(ValueError) as terr:
        tl.generate(tparams, torch.from_numpy(ids), tcfg, n, **tkw)
    assert str(terr.value) == str(jerr.value)


def test_port_key_is_reproducible_and_folds_independently():
    key = PRNGKey(5)
    a = key.fold_in(3).gumbel((4, 50))
    b = PRNGKey(5).fold_in(3).gumbel((4, 50))
    assert a.dtype == torch.float32 and a.shape == (4, 50)
    assert torch.equal(a, b)
    # A draw depends on the key alone, not on what was drawn before it.
    key.fold_in(9).uniform((1000,))
    assert torch.equal(key.fold_in(3).gumbel((4, 50)), a)
    assert not torch.equal(key.fold_in(4).gumbel((4, 50)), a)
    assert not torch.equal(PRNGKey(6).fold_in(3).gumbel((4, 50)), a)
    assert not torch.equal(key.fold_in(3).fold_in(0).gumbel((4, 50)), a)
    u = key.uniform((10000,))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_port_key_samples_follow_softmax():
    """Chi-square goodness of fit of 20000 categorical draws over an 8-token
    vocab (one fold-in per draw) against softmax(logits): the statistic
    stays below the 0.999 quantile of chi-square with 7 degrees of freedom
    (24.32)."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, -2.0])
    n = 20000
    key = PRNGKey(1234)
    # One row per draw; row i draws with key.fold_in(i) as generate's step i.
    rows = torch.stack([key.fold_in(i).gumbel((8,)) for i in range(n)])
    draws = (rows + logits).argmax(-1)
    counts = torch.bincount(draws, minlength=8).double()
    expected = torch.softmax(logits.double(), -1) * n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 24.32, (chi2, counts.tolist(), expected.tolist())


def test_sampled_generate_with_port_key_is_reproducible(llama_setup):
    _, tcfg, _, tparams = llama_setup
    ids = torch.from_numpy(np.random.default_rng(8).integers(0, 256, size=(2, 6)))
    kw = dict(temperature=0.9, top_k=40, top_p=0.95)
    a = tl.generate(tparams, ids, tcfg, 12, key=PRNGKey(1), **kw)
    b = tl.generate(tparams, ids, tcfg, 12, key=PRNGKey(1), **kw)
    c = tl.generate(tparams, ids, tcfg, 12, key=PRNGKey(2), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:, :6], ids)
