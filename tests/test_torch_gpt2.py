"""The port's GPT-2 (``accelerate_tpu_torch/models/gpt2.py``) against the
JAX package's ``accelerate_tpu/models/gpt2.py`` on the same weights.

The JAX tree (biases, LayerNorm scales and biases drawn away from their
init so every term counts) is carried across by ``gpt2_params_from_jax``.
Tolerances: fp32 logits atol = rtol = 1e-5, fp32 loss and gradients 1e-4,
the bf16 loss 1e-3; generated tokens equal.  ``apply_paged(kernel=True)``
on CPU tensors runs the paged kernels' plain versions, held here to the JAX
Pallas kernels in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import gpt2 as jg
from accelerate_tpu_torch.models import gpt2 as tg
from accelerate_tpu_torch.utils.convert import gpt2_params_from_jax
from torch_jax_key import JaxKey

LOGITS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _setup(seed=0, **kw):
    jcfg = jg.GPT2Config.tiny(dtype=jnp.float32, **kw)
    tcfg = tg.GPT2Config.tiny(dtype=torch.float32, **kw)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jg.init_params(jcfg, jax.random.key(seed)))
    for name, leaf in params["layers"].items():
        if name.startswith("b_") or name.startswith("ln_"):
            center = 1.0 if name.endswith("_scale") else 0.0
            params["layers"][name] = rng.normal(center, 0.2, leaf.shape).astype(np.float32)
    params["final_ln_scale"] = rng.normal(1.0, 0.2, params["final_ln_scale"].shape).astype(
        np.float32)
    params["final_ln_bias"] = rng.normal(0.0, 0.2, params["final_ln_bias"].shape).astype(
        np.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, params), gpt2_params_from_jax(
        params, tcfg, device="cpu")


@pytest.fixture(scope="module")
def gpt2_setup():
    return _setup()


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_convert_carries_every_leaf_and_checks(gpt2_setup):
    jcfg, tcfg, jparams, tparams = gpt2_setup
    want = dict(_flat(jax.tree.map(np.asarray, jparams)))
    got = dict(_flat(tparams))
    assert sorted(got) == sorted(want) and len(got) == 16
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    np_params = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="wpe"):
        gpt2_params_from_jax(np_params, tg.GPT2Config.tiny(max_seq_len=64), device="cpu")
    with pytest.raises(ValueError, match="keys"):
        gpt2_params_from_jax(dict(np_params, extra=np.zeros(2)), tcfg, device="cpu")


def test_init_params_shapes_and_rule():
    cfg = tg.GPT2Config.tiny(num_layers=3, max_seq_len=3)
    params = tg.init_params(cfg, seed=0, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape),
                          jg.init_params(jg.GPT2Config.tiny(num_layers=3, max_seq_len=3),
                                         jax.random.key(0)))
    assert {k: tuple(v.shape) for k, v in _flat(params)} == dict(_flat(shapes))
    assert sum(v.numel() for _, v in _flat(params)) == cfg.num_params()
    assert torch.equal(params["layers"]["ln_attn_scale"], torch.ones(3, 64))
    assert not params["layers"]["b_qkv"].any() and not params["final_ln_bias"].any()
    # The position table is a weight even when max_seq_len == num_layers.
    assert params["wpe"].std().item() == pytest.approx(0.02, rel=0.2)
    again = tg.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_flat(params), _flat(again)))


def test_gpt2_xl_widths_count_1_557_611_200():
    xl = tg.GPT2Config(hidden_size=1600, num_layers=48, num_heads=25)
    assert xl.num_params() == 1_557_611_200 == jg.GPT2Config(
        hidden_size=1600, num_layers=48, num_heads=25).num_params()
    assert xl.head_dim == 64


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_apply_matches_jax(gpt2_setup, masked):
    jcfg, tcfg, jparams, tparams = gpt2_setup
    rng = np.random.default_rng(1)
    ids = rng.integers(0, jcfg.vocab_size, size=(2, 11)).astype(np.int32)
    mask = np.ones((2, 11), np.int32)
    if masked:
        mask[1, :4] = 0
    jm, tm = (jnp.asarray(mask), torch.from_numpy(mask)) if masked else (None, None)
    want = np.asarray(jg.apply(jparams, jnp.asarray(ids), jcfg, jm))
    got = tg.apply(tparams, torch.from_numpy(ids), tcfg, tm)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 11, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)


@pytest.mark.parametrize("loss_impl,remat,masked", [
    ("dense", True, True), ("chunked", False, True)])
def test_loss_and_grads_match_jax(loss_impl, remat, masked):
    kw = dict(loss_impl=loss_impl, loss_chunk_size=96, remat=remat)
    jcfg, tcfg, jparams, tparams = _setup(**kw)
    rng = np.random.default_rng(4)
    batch = {"input_ids": rng.integers(0, jcfg.vocab_size, size=(2, 13)).astype(np.int32)}
    if masked:
        mask = np.ones((2, 13), np.int32)
        mask[0, :5] = 0
        batch["attention_mask"] = mask
        batch["labels"] = np.where(rng.random((2, 13)) < 0.2, -100,
                                   batch["input_ids"]).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(jg.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    leaves = {k: v.clone().requires_grad_() for k, v in _flat(tparams)}
    tree = {k: v for k, v in leaves.items() if "/" not in k}
    tree["layers"] = {k.split("/")[1]: v for k, v in leaves.items() if "/" in k}
    loss = tg.loss_fn(tree, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **GRAD_TOL)
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    for k, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), want[k], err_msg=k, **GRAD_TOL)


def test_bf16_loss_matches_jax():
    """bf16 compute over fp32 parameters, the configs' default."""
    jcfg, tcfg, jparams, tparams = _setup()
    jcfg = jg.GPT2Config.tiny()
    tcfg = tg.GPT2Config.tiny()
    ids = np.random.default_rng(5).integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    want = float(jg.loss_fn(jparams, {"input_ids": jnp.asarray(ids)}, jcfg))
    got = tg.loss_fn(tparams, {"input_ids": torch.from_numpy(ids)}, tcfg).item()
    assert abs(got - want) <= 1e-3, (got, want)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_apply_cached_matches_jax(quant):
    jcfg, tcfg, jparams, tparams = _setup(kv_cache_quant=quant)
    rng = np.random.default_rng(6)
    chunks = [rng.integers(0, jcfg.vocab_size, size=(2, n)).astype(np.int32) for n in (9, 1)]
    jc = jg.init_cache(jcfg, 2, 16)
    tc = tg.init_cache(tcfg, 2, 16, device="cpu")
    for chunk in chunks:
        jlog, jc = jg.apply_cached(jparams, jnp.asarray(chunk), jcfg, jc)
        tlog, tc = tg.apply_cached(tparams, torch.from_numpy(chunk), tcfg, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **GRAD_TOL)
    assert tc["index"] == int(jc["index"]) == 10
    if quant:
        np.testing.assert_array_equal(tc["k"].numpy(), np.asarray(jc["k"]))
    else:
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **GRAD_TOL)


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("t", [1, 4])
def test_apply_paged_matches_jax(gpt2_setup, t, kernel):
    """Decode (T=1) and a verify window (T=4), one kv head per query head,
    against a shared pool with null-padded tables and an idle slot."""
    jcfg, tcfg, jparams, tparams = gpt2_setup
    rng = np.random.default_rng(2)
    bs = 4
    shape = (jcfg.num_layers, 12, bs, jcfg.num_heads, jcfg.head_dim)
    pool = {k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")}
    tables = np.asarray([[3, 5, 0, 0], [0, 0, 0, 0], [1, 2, 4, 6]], np.int32)
    starts = np.asarray([6, 0, 12], np.int32)
    ids = rng.integers(0, jcfg.vocab_size, size=(3, t)).astype(np.int32)
    jlog, jrows = jg.apply_paged(jparams, jnp.asarray(ids), jcfg,
                                 jax.tree.map(jnp.asarray, pool), jnp.asarray(tables),
                                 jnp.asarray(starts), kernel=kernel)
    tlog, trows = tg.apply_paged(tparams, torch.from_numpy(ids), tcfg,
                                 {k: torch.from_numpy(v) for k, v in pool.items()},
                                 torch.from_numpy(tables), torch.from_numpy(starts), kernel=kernel)
    assert tuple(tlog.shape) == (3, t, jcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **GRAD_TOL)
    for name in ("k", "v"):
        assert tuple(trows[name].shape) == (3, jcfg.num_layers, t, jcfg.num_heads,
                                            jcfg.head_dim)
        np.testing.assert_allclose(trows[name].numpy(), np.asarray(jrows[name]), **GRAD_TOL)


def test_apply_paged_int8_pool_matches_jax():
    """An int8 pool takes the plain path with ``kernel=True``, as in JAX."""
    from accelerate_tpu.models.generation import quantize_kv as jquant

    jcfg, tcfg, jparams, tparams = _setup(kv_cache_quant=True)
    rng = np.random.default_rng(8)
    shape = (jcfg.num_layers, 8, 4, jcfg.num_heads, jcfg.head_dim)
    pool = {}
    for name in ("k", "v"):
        codes, scale = jquant(jnp.asarray(rng.standard_normal(shape).astype(np.float32)))
        pool[name], pool[name + "_scale"] = np.asarray(codes), np.asarray(scale)
    tables = np.asarray([[1, 2, 0], [4, 0, 0]], np.int32)
    starts = np.asarray([5, 2], np.int32)
    ids = rng.integers(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
    jlog, _ = jg.apply_paged(jparams, jnp.asarray(ids), jcfg, jax.tree.map(jnp.asarray, pool),
                             jnp.asarray(tables), jnp.asarray(starts), kernel=True)
    tpool = {k: (torch.from_numpy(v.copy()) if v.dtype == np.int8
                 else torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16))
             for k, v in pool.items()}
    tlog, trows = tg.apply_paged(tparams, torch.from_numpy(ids), tcfg, tpool,
                                 torch.from_numpy(tables), torch.from_numpy(starts), kernel=True)
    assert sorted(trows) == ["k", "k_scale", "v", "v_scale"]
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **GRAD_TOL)


@pytest.mark.parametrize("prefill_chunk", [None, 4])
def test_greedy_generate_matches_jax(gpt2_setup, prefill_chunk):
    jcfg, tcfg, jparams, tparams = gpt2_setup
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    want = np.asarray(jg.generate(jparams, jnp.asarray(ids), jcfg, max_new_tokens=6))
    got = tg.generate(tparams, torch.from_numpy(ids), tcfg, max_new_tokens=6,
                      prefill_chunk=prefill_chunk)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_matches_jax(gpt2_setup):
    """top-k and top-p sampling with JAX's own noise (``JaxKey``)."""
    jcfg, tcfg, jparams, tparams = gpt2_setup
    ids = np.random.default_rng(9).integers(0, jcfg.vocab_size, size=(2, 5)).astype(np.int32)
    key = jax.random.key(11)
    kw = dict(temperature=0.9, top_k=20, top_p=0.8)
    want = np.asarray(jg.generate(jparams, jnp.asarray(ids), jcfg, 8, key=key, **kw))
    got = tg.generate(tparams, torch.from_numpy(ids), tcfg, 8, key=JaxKey(key), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_speculative_and_beam_match_jax(gpt2_setup):
    jcfg, tcfg, jparams, tparams = gpt2_setup
    djcfg, dtcfg, djparams, dtparams = _setup(seed=1, num_layers=1)
    ids = np.random.default_rng(10).integers(0, jcfg.vocab_size, size=(1, 6)).astype(np.int32)
    want, wstats = jg.speculative_generate(jparams, djparams, jnp.asarray(ids), jcfg, djcfg, 10,
                                           num_draft_tokens=3, return_stats=True)
    got, gstats = tg.speculative_generate(tparams, dtparams, torch.from_numpy(ids), tcfg, dtcfg,
                                          10, num_draft_tokens=3, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gstats == {k: int(v) for k, v in wstats.items()}
    ids2 = np.random.default_rng(12).integers(0, jcfg.vocab_size, size=(2, 5)).astype(np.int32)
    want = np.asarray(jg.generate_beam(jparams, jnp.asarray(ids2), jcfg, 6, num_beams=3,
                                       eos_token_id=7))
    got = tg.generate_beam(tparams, torch.from_numpy(ids2), tcfg, 6, num_beams=3, eos_token_id=7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_position_table_bounds_the_cache_and_the_table(gpt2_setup):
    """A dense cache or a block table longer than ``max_seq_len`` (128)
    raises in both packages, with the same message."""
    jcfg, tcfg, jparams, tparams = gpt2_setup
    ids = np.zeros((1, 1), np.int32)
    with pytest.raises(ValueError) as jerr:
        jg.apply_cached(jparams, jnp.asarray(ids), jcfg, jg.init_cache(jcfg, 1, 129))
    with pytest.raises(ValueError) as terr:
        tg.apply_cached(tparams, torch.from_numpy(ids), tcfg, tg.init_cache(tcfg, 1, 129,
                                                                            device="cpu"))
    assert str(terr.value) == str(jerr.value)
    shape = (jcfg.num_layers, 4, 16, jcfg.num_heads, jcfg.head_dim)
    pool = {k: np.zeros(shape, np.float32) for k in ("k", "v")}
    tables, starts = np.zeros((1, 9), np.int32), np.zeros(1, np.int32)  # 9 x 16 = 144 > 128
    with pytest.raises(ValueError) as jerr:
        jg.apply_paged(jparams, jnp.asarray(ids), jcfg, jax.tree.map(jnp.asarray, pool),
                       jnp.asarray(tables), jnp.asarray(starts))
    with pytest.raises(ValueError) as terr:
        tg.apply_paged(tparams, torch.from_numpy(ids), tcfg,
                       {k: torch.from_numpy(v) for k, v in pool.items()},
                       torch.from_numpy(tables), torch.from_numpy(starts))
    assert str(terr.value) == str(jerr.value)
    # A generate whose cache would outgrow the table raises too.
    with pytest.raises(ValueError, match="max_seq_len"):
        tg.generate(tparams, torch.zeros((1, 120), dtype=torch.long), tcfg, 16)


def test_unported_paths_raise():
    # Ulysses is ported (ROADMAP A6 part 2); an unknown sp_impl still raises.
    assert tg.GPT2Config.tiny(sp_impl="ulysses").sp_impl == "ulysses"
    with pytest.raises(ValueError, match="sp_impl"):
        tg.GPT2Config.tiny(sp_impl="rings")
    with pytest.raises(ValueError, match="loss_impl"):
        tg.GPT2Config.tiny(loss_impl="sparse")
    cfg = tg.GPT2Config.tiny(dtype=torch.float32)
    params = tg.init_params(cfg, seed=0, device="cpu")
    params["layers"]["w_up"] = {"codes": params["layers"]["w_up"], "scale": None}
    with pytest.raises(NotImplementedError, match="A8"):
        tg.apply(params, torch.zeros((1, 3), dtype=torch.long), cfg)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tg.init_params(tg.GPT2Config.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tg.init_cache(tg.GPT2Config.tiny(), 1, 8)
