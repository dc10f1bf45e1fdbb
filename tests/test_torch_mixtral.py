"""The port's Mixtral (``accelerate_tpu_torch/models/mixtral.py``) against the
JAX package's ``accelerate_tpu/models/mixtral.py`` on the same weights.

The JAX tree (norm scales drawn away from one so each counts) is carried
across by ``mixtral_params_from_jax``.  Tolerances: fp32 logits atol =
rtol = 1e-5, the loss and gradients 1e-4, the bf16 loss 1e-3; generated
tokens equal.  Routing capacity depends on the length of each forward, so
every cached comparison feeds both packages the same chunks."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import mixtral as jmx
from accelerate_tpu_torch import Accelerator, AcceleratorState
from accelerate_tpu_torch.models import mixtral as tmx
from accelerate_tpu_torch.utils.convert import mixtral_params_from_jax
from torch_jax_key import JaxKey

LOGITS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# The JAX side jitted whole: one compile a shape instead of one an op.
_INIT = jax.jit(jmx.init_params, static_argnums=0)
_APPLY = jax.jit(jmx.apply, static_argnums=2)
_LOSS_AND_GRAD = jax.jit(jax.value_and_grad(jmx.loss_fn), static_argnums=2)
_APPLY_CACHED = jax.jit(jmx.apply_cached, static_argnums=2)


def _setup(seed=0, **kw):
    jcfg = jmx.MixtralConfig.tiny(dtype=jnp.float32, **kw)
    tcfg = tmx.MixtralConfig.tiny(dtype=torch.float32, **kw)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, _INIT(jcfg, jax.random.key(seed)))
    for name in ("ln_attn", "ln_mlp"):
        params["layers"][name] = rng.normal(1.0, 0.2, params["layers"][name].shape).astype(
            np.float32)
    params["final_norm"] = rng.normal(1.0, 0.2, params["final_norm"].shape).astype(np.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, params), mixtral_params_from_jax(
        params, tcfg, device="cpu")


@pytest.fixture(scope="module")
def mixtral_setup():
    return _setup()


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _ids(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def test_convert_carries_every_leaf_and_checks(mixtral_setup):
    jcfg, tcfg, jparams, tparams = mixtral_setup
    want = dict(_flat(jax.tree.map(np.asarray, jparams)))
    got = dict(_flat(tparams))
    assert sorted(got) == sorted(want) and len(got) == 13
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    np_params = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="router"):
        mixtral_params_from_jax(np_params, tmx.MixtralConfig.tiny(num_experts=3), device="cpu")


def test_init_params_and_published_counts():
    cfg = tmx.MixtralConfig.tiny(num_layers=3)
    params = tmx.init_params(cfg, seed=0, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: jmx.init_params(jmx.MixtralConfig.tiny(num_layers=3), jax.random.key(0))))
    assert {k: tuple(v.shape) for k, v in _flat(params)} == dict(_flat(shapes))
    assert sum(v.numel() for _, v in _flat(params)) == cfg.num_params()
    assert torch.equal(params["layers"]["ln_mlp"], torch.ones(3, 64))
    # Each expert matrix drawn at 1/sqrt(its fan-in), truncated at 2 sigma.
    w = params["layers"]["w_down"]
    assert w.abs().max() <= 2 / 96 ** 0.5 and w.std().item() == pytest.approx(
        0.88 / 96 ** 0.5, rel=0.1)
    big = tmx.MixtralConfig.mixtral_8x7b()
    assert big.num_params() == 46_702_792_704 == jmx.MixtralConfig.mixtral_8x7b().num_params()
    assert big.flops_per_token() == jmx.MixtralConfig.mixtral_8x7b().flops_per_token()
    assert tmx.MixtralConfig.mixtral_8x7b(num_layers=2).num_params() == 3_164_688_384


@pytest.mark.parametrize("moe_impl,masked", [("dense", False), ("ragged", True)])
def test_apply_matches_jax(mixtral_setup, moe_impl, masked):
    jcfg, tcfg, jparams, tparams = mixtral_setup
    if moe_impl == "ragged":
        jcfg = dataclasses.replace(jcfg, moe_impl="ragged")
        tcfg = tmx.MixtralConfig.tiny(dtype=torch.float32, moe_impl="ragged")
    ids = _ids(1, (2, 11))
    mask = np.ones((2, 11), np.int32)
    mask[1, :4] = 0
    jm, tm_ = (jnp.asarray(mask), torch.from_numpy(mask)) if masked else (None, None)
    want, jaux = _APPLY(jparams, jnp.asarray(ids), jcfg, attention_mask=jm)
    got, aux = tmx.apply(tparams, torch.from_numpy(ids), tcfg, attention_mask=tm_)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 11, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    for k in ("load_balancing_loss", "router_z_loss", "fraction_dropped"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), err_msg=k, **LOGITS_TOL)


@pytest.mark.parametrize("loss_impl,remat,masked,moe_impl", [
    ("dense", True, True, "dense"), ("chunked", False, True, "ragged")])
def test_loss_and_grads_match_jax(loss_impl, remat, masked, moe_impl):
    kw = dict(loss_impl=loss_impl, loss_chunk_size=96, remat=remat, moe_impl=moe_impl,
              capacity_factor=1.0)
    jcfg, tcfg, jparams, tparams = _setup(**kw)
    rng = np.random.default_rng(4)
    batch = {"input_ids": _ids(4, (2, 13))}
    if masked:
        mask = np.ones((2, 13), np.int32)
        mask[0, :5] = 0
        batch["attention_mask"] = mask
        batch["labels"] = np.where(rng.random((2, 13)) < 0.2, -100,
                                   batch["input_ids"]).astype(np.int32)
    jloss, jgrads = _LOSS_AND_GRAD(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    leaves = {k: v.clone().requires_grad_() for k, v in _flat(tparams)}
    tree = {k: v for k, v in leaves.items() if "/" not in k}
    tree["layers"] = {k.split("/")[1]: v for k, v in leaves.items() if "/" in k}
    loss = tmx.loss_fn(tree, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **GRAD_TOL)
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    for k, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), want[k], err_msg=k, **GRAD_TOL)


def test_bf16_loss_matches_jax(mixtral_setup):
    """bf16 compute over fp32 parameters, the configs' default."""
    _, _, jparams, tparams = mixtral_setup
    ids = _ids(5, (2, 16))
    want = float(jax.jit(jmx.loss_fn, static_argnums=2)(
        jparams, {"input_ids": jnp.asarray(ids)}, jmx.MixtralConfig.tiny()))
    got = tmx.loss_fn(tparams, {"input_ids": torch.from_numpy(ids)},
                      tmx.MixtralConfig.tiny()).item()
    assert abs(got - want) <= 1e-3, (got, want)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_apply_cached_matches_jax(quant):
    jcfg, tcfg, jparams, tparams = _setup(kv_cache_quant=quant)
    chunks = [_ids(6 + i, (2, n)) for i, n in enumerate((9, 1, 3))]
    jc = jmx.init_cache(jcfg, 2, 16)
    tc = tmx.init_cache(tcfg, 2, 16, device="cpu")
    for chunk in chunks:
        jlog, jc = _APPLY_CACHED(jparams, jnp.asarray(chunk), jcfg, jc)
        tlog, tc = tmx.apply_cached(tparams, torch.from_numpy(chunk), tcfg, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **GRAD_TOL)
    assert tc["index"] == int(jc["index"]) == 13
    if quant:
        np.testing.assert_array_equal(tc["k"].numpy(), np.asarray(jc["k"]))
    else:
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **GRAD_TOL)


@pytest.mark.parametrize("prefill_chunk", [4])
def test_greedy_generate_matches_jax(mixtral_setup, prefill_chunk):
    jcfg, tcfg, jparams, tparams = mixtral_setup
    ids = _ids(3, (2, 9))
    want = np.asarray(jmx.generate(jparams, jnp.asarray(ids), jcfg, max_new_tokens=6,
                                   prefill_chunk=prefill_chunk))
    got = tmx.generate(tparams, torch.from_numpy(ids), tcfg, max_new_tokens=6,
                       prefill_chunk=prefill_chunk)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_speculative_and_beam_match_jax(mixtral_setup):
    """top-k / top-p sampling with JAX's own noise (``JaxKey``), greedy
    speculative decoding with a one-layer Mixtral draft, and beam search."""
    jcfg, tcfg, jparams, tparams = mixtral_setup
    ids = _ids(9, (2, 5))
    key = jax.random.key(11)
    kw = dict(temperature=0.9, top_k=20, top_p=0.8, prefill_chunk=2)
    want = np.asarray(jmx.generate(jparams, jnp.asarray(ids), jcfg, 8, key=key, **kw))
    got = tmx.generate(tparams, torch.from_numpy(ids), tcfg, 8, key=JaxKey(key), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    djcfg, dtcfg, djparams, dtparams = _setup(seed=1, num_layers=1)
    ids = _ids(10, (1, 6))
    want, wstats = jmx.speculative_generate(jparams, djparams, jnp.asarray(ids), jcfg, djcfg, 10,
                                            num_draft_tokens=3, return_stats=True)
    got, gstats = tmx.speculative_generate(tparams, dtparams, torch.from_numpy(ids), tcfg, dtcfg,
                                           10, num_draft_tokens=3, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gstats == {k: int(v) for k, v in wstats.items()}
    ids = _ids(12, (2, 5))
    want = np.asarray(jmx.generate_beam(jparams, jnp.asarray(ids), jcfg, 6, num_beams=3,
                                        eos_token_id=7))
    got = tmx.generate_beam(tparams, torch.from_numpy(ids), tcfg, 6, num_beams=3, eos_token_id=7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_serves_on_the_dense_path_as_generate(mixtral_setup):
    """The serving engine finds no ``apply_paged`` in the family and gathers
    dense views, as the JAX engine does; with prompts of whole chunks (the
    engine pads a short final chunk, which changes that forward's routing
    capacity) and no prefix cache or preemption, each request equals the
    port's greedy ``generate`` with the engine's prefill chunk."""
    _, tcfg, _, tparams = mixtral_setup
    AcceleratorState._reset_state(reset_partial_state=True)
    chunk = 8
    prompts = [list(_ids(20 + i, (n,))) for i, n in enumerate((8, 16, 24))]
    eng = Accelerator(cpu=True).prepare_serving(
        tmx.apply_cached, tmx.init_cache, tparams, tcfg, block_size=4, num_blocks=40,
        max_slots=2, prefill_chunk=chunk, max_blocks_per_seq=10, prefix_cache=False)
    assert eng.decode_path == "dense"
    ids = [eng.submit(p, 6) for p in prompts]
    outputs = eng.run(max_ticks=200)
    for rid, p in zip(ids, prompts):
        want = tmx.generate(tparams, torch.tensor([p]), tcfg, 6, prefill_chunk=chunk)[0]
        assert outputs[rid] == want.tolist(), f"request {rid}"
    assert eng.stats()["preempted"] == 0
    AcceleratorState._reset_state(reset_partial_state=True)


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="A8"):
        tmx.MixtralConfig.tiny(fp8=True)
    # Ulysses is ported (ROADMAP A6 part 2); an unknown sp_impl still raises.
    assert tmx.MixtralConfig.tiny(sp_impl="ulysses").sp_impl == "ulysses"
    with pytest.raises(ValueError, match="sp_impl"):
        tmx.MixtralConfig.tiny(sp_impl="rings")
    with pytest.raises(ValueError, match="moe_impl"):
        tmx.MixtralConfig.tiny(moe_impl="sparse")
    cfg = tmx.MixtralConfig.tiny(dtype=torch.float32)
    params = tmx.init_params(cfg, seed=0, device="cpu")
    params["layers"]["w_up"] = {"codes": params["layers"]["w_up"], "scale": None}
    with pytest.raises(NotImplementedError, match="A8"):
        tmx.apply(params, torch.zeros((1, 3), dtype=torch.long), cfg)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmx.init_params(tmx.MixtralConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmx.init_cache(tmx.MixtralConfig.tiny(), 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmx.MixtralForCausalLM(tmx.MixtralConfig.tiny())
