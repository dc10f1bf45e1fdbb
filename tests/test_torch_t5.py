"""The port's T5 (``accelerate_tpu_torch/models/t5.py``) against the JAX
package's ``accelerate_tpu/models/t5.py`` on the same weights.

The JAX tree (RMSNorm scales and both relative-bias tables drawn away from
their init, so each counts) is carried across by ``t5_params_from_jax``.
fp32 compute; tolerances: logits 1e-5, the loss and gradients 1e-4 (the
gradients against the largest entry of their leaf), the cached decoder's
logits 1e-4; generated tokens equal.  The JAX side runs jitted where it is
a plain function."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import t5 as jt
from accelerate_tpu_torch.models import t5 as tt
from accelerate_tpu_torch.utils.convert import t5_params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
CACHED_TOL = dict(rtol=1e-4, atol=1e-4)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _setup(seed=0, **kw):
    jcfg = jt.T5Config.tiny(dtype=jnp.float32, **kw)
    tcfg = tt.T5Config.tiny(dtype=torch.float32, **kw)
    params = jax.tree.map(np.asarray, jax.jit(jt.init_params, static_argnums=0)(
        jcfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for name in ("enc_rel_bias", "dec_rel_bias"):
        params[name] = rng.normal(0.0, 0.5, params[name].shape).astype(np.float32)
    for stack in ("encoder", "decoder"):
        for name, leaf in params[stack].items():
            if name.startswith("ln_"):
                params[stack][name] = rng.normal(1.0, 0.2, leaf.shape).astype(np.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, params), t5_params_from_jax(
        params, tcfg, device="cpu")


@pytest.fixture(scope="module")
def t5_setup():
    return _setup()


def _batch(seed=1, b=2, s=11, t=7):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s), np.int32)
    mask[1, 8:] = 0
    labels = rng.integers(0, 256, (b, t)).astype(np.int32)
    labels[0, -2:] = -100
    return {"input_ids": rng.integers(0, 256, (b, s)).astype(np.int32),
            "decoder_input_ids": rng.integers(0, 256, (b, t)).astype(np.int32),
            "attention_mask": mask, "labels": labels}


def test_relative_buckets_match_jax():
    rel = np.arange(-300, 300, dtype=np.int32)[None]
    for bidirectional in (True, False):
        for nb, md in ((32, 128), (8, 32)):
            want = np.asarray(jt._relative_buckets(jnp.asarray(rel), nb, md, bidirectional))
            got = tt._relative_buckets(torch.from_numpy(rel), nb, md, bidirectional)
            np.testing.assert_array_equal(got.numpy(), want)


def test_convert_and_apply_match_jax(t5_setup):
    jcfg, tcfg, jparams, tparams = t5_setup
    want = dict(_flat(jax.tree.map(np.asarray, jparams)))
    assert sorted(dict(_flat(tparams))) == sorted(want) and len(want) == 26
    b = _batch()
    jlog = jax.jit(jt.apply, static_argnums=3)(
        jparams, jnp.asarray(b["input_ids"]), jnp.asarray(b["decoder_input_ids"]), jcfg,
        jnp.asarray(b["attention_mask"]))
    tlog = tt.apply(tparams, torch.from_numpy(b["input_ids"]),
                    torch.from_numpy(b["decoder_input_ids"]), tcfg,
                    torch.from_numpy(b["attention_mask"]))
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == (2, 7, 256)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: jt.init_params(jt.T5Config.tiny(num_layers=3), jax.random.key(0))))
    mine = tt.init_params(tt.T5Config.tiny(num_layers=3), seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in _flat(mine)} == dict(_flat(shapes))


@pytest.mark.parametrize("loss_impl,remat", [("dense", True), ("chunked", False)])
def test_loss_and_grads_match_jax(loss_impl, remat):
    jcfg, tcfg, jparams, tparams = _setup(seed=2, loss_impl=loss_impl, loss_chunk_size=96,
                                          remat=remat)
    b = _batch(seed=3)
    jl, jg = jax.jit(jax.value_and_grad(jt.loss_fn), static_argnums=2)(
        jparams, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    leaves = {k: v.clone().requires_grad_() for k, v in _flat(tparams)}
    tree = {k: v for k, v in leaves.items() if "/" not in k}
    for stack in ("encoder", "decoder"):
        tree[stack] = {k.split("/")[1]: v for k, v in leaves.items() if k.startswith(stack + "/")}
    loss = tt.loss_fn(tree, {k: torch.from_numpy(v) for k, v in b.items()}, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    want = dict(_flat(jax.tree.map(np.asarray, jg)))
    for k, v in leaves.items():
        scale = max(np.abs(want[k]).max(), 1e-6)
        assert np.abs(v.grad.numpy() - want[k]).max() <= 1e-4 * scale, k


def test_bf16_loss_matches_jax(t5_setup):
    """bf16 compute: the head is the bf16 embedding over sqrt(d) in fp32."""
    _, _, jparams, tparams = t5_setup
    b = _batch(seed=4)
    want = float(jax.jit(jt.loss_fn, static_argnums=2)(
        jparams, {k: jnp.asarray(v) for k, v in b.items()}, jt.T5Config.tiny()))
    got = tt.loss_fn(tparams, {k: torch.from_numpy(v) for k, v in b.items()},
                     tt.T5Config.tiny()).item()
    assert abs(got - want) <= 1e-3, (got, want)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_encode_and_decode_cached_match_jax(quant):
    jcfg, tcfg, jparams, tparams = _setup(seed=5, kv_cache_quant=quant)
    b = _batch(seed=6)
    jm, tm_ = jnp.asarray(b["attention_mask"]), torch.from_numpy(b["attention_mask"])
    jenc = jax.jit(jt.encode, static_argnums=2)(jparams, jnp.asarray(b["input_ids"]), jcfg, jm)
    tenc = tt.encode(tparams, torch.from_numpy(b["input_ids"]), tcfg, tm_)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), **TOL)
    jc = jt.init_decoder_cache(jparams, jenc, jcfg, 12)
    tc = tt.init_decoder_cache(tparams, tenc, tcfg, 12)
    assert sorted(tc) == sorted(jc)
    assert tc["cross_k"].dtype == torch.float32  # cross K/V stay full precision
    dec = jax.jit(jt.decode_cached, static_argnums=2)
    for lo, hi in ((0, 4), (4, 5), (5, 7)):
        ids = b["decoder_input_ids"][:, lo:hi]
        jlog, jc = dec(jparams, jnp.asarray(ids), jcfg, jc, jm)
        tlog, tc = tt.decode_cached(tparams, torch.from_numpy(ids), tcfg, tc, tm_)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **CACHED_TOL)
    assert tc["index"] == int(jc["index"]) == 7
    if quant:
        assert tc["k"].dtype == torch.int8
        np.testing.assert_array_equal(tc["k"].numpy(), np.asarray(jc["k"]))


def test_generate_beam_and_speculative_match_jax(t5_setup):
    jcfg, tcfg, jparams, tparams = t5_setup
    b = _batch(seed=7)
    jm, tm_ = jnp.asarray(b["attention_mask"]), torch.from_numpy(b["attention_mask"])
    ids = b["input_ids"]
    want = np.asarray(jt.generate(jparams, jnp.asarray(ids), jcfg, 6, attention_mask=jm))
    got = tt.generate(tparams, torch.from_numpy(ids), tcfg, 6, attention_mask=tm_)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jt.generate_beam(jparams, jnp.asarray(ids), jcfg, 5, num_beams=3,
                                       eos_token_id=7, attention_mask=jm))
    got = tt.generate_beam(tparams, torch.from_numpy(ids), tcfg, 5, num_beams=3,
                           eos_token_id=7, attention_mask=tm_)
    np.testing.assert_array_equal(got.numpy(), want)
    djcfg, dtcfg, djparams, dtparams = _setup(seed=8, num_layers=1)
    want, wstats = jt.speculative_generate(jparams, djparams, jnp.asarray(ids[:1]), jcfg, djcfg,
                                           8, num_draft_tokens=3, return_stats=True)
    got, gstats = tt.speculative_generate(tparams, dtparams, torch.from_numpy(ids[:1]), tcfg,
                                          dtcfg, 8, num_draft_tokens=3, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gstats == {k: int(v) for k, v in wstats.items()}


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.init_params(tt.T5Config.tiny())
    cfg = tt.T5Config.tiny(dtype=torch.float32)
    params = tt.init_params(cfg, seed=0, device="cpu")
    params["decoder"]["w_up"] = {"codes": params["decoder"]["w_up"], "scale": None}
    with pytest.raises(NotImplementedError, match="A8"):
        tt.apply(params, torch.zeros((1, 3), dtype=torch.long),
                 torch.zeros((1, 2), dtype=torch.long), cfg)
