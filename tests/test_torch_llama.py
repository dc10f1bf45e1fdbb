"""The port's llama (``accelerate_tpu_torch/models/llama.py``) and generation
primitives against the JAX package on the same weights and inputs.

Weights come from the JAX ``init_params`` with the biases and norm scales
redrawn from a numpy seed (their init values, zeros and ones, would hide a
wrong bias or offset), converted by ``llama_params_from_jax``.  Both sides
compute in fp32; logits agree to atol = rtol = 1e-4 (the two frameworks
sum matmuls and softmaxes in different orders)."""

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

TOL = dict(rtol=1e-4, atol=1e-4)

VARIANTS = {
    "plain": {},
    "attention_bias": dict(attention_bias=True),
    "rope_scaling": dict(rope_scaling=("llama3", 8.0, 1.0, 4.0, 32), rope_theta=10000.0),
    "gemma_style": dict(rms_offset=True, hidden_act="gelu_tanh", embed_scale=True),
    "tied": dict(tie_embeddings=True),
}


def _setup(variant, seed=0):
    kw = VARIANTS[variant]
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.key(seed)))
    for name in ("bq", "bk", "bv", "bo", "ln_attn", "ln_mlp"):
        if name in params["layers"]:
            shape = params["layers"][name].shape
            params["layers"][name] = rng.normal(0.0, 0.3, shape).astype(np.float32)
    params["final_norm"] = rng.normal(1.0, 0.3, params["final_norm"].shape).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    return jcfg, tcfg, jparams, llama_params_from_jax(params, tcfg, device="cpu")


def _pool(rng, cfg, num_blocks, bs):
    shape = (cfg.num_layers, num_blocks, bs, cfg.num_kv_heads, cfg.head_dim_)
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def test_convert_round_trip_and_checks():
    jcfg, tcfg, jparams, tparams = _setup("attention_bias")
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(tparams) - 1 + len(tparams["layers"])
    for path, leaf in flat_j:
        keys = [str(getattr(k, "key", k)) for k in path]
        t = tparams[keys[0]] if len(keys) == 1 else tparams[keys[0]][keys[1]]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    np_params = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="keys"):
        llama_params_from_jax(np_params, tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    bad = dict(np_params, final_norm=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        llama_params_from_jax(bad, tcfg, device="cpu")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_cached_matches_jax(variant):
    jcfg, tcfg, jparams, tparams = _setup(variant)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, jcfg.vocab_size, size=(2, 7)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, size=(2, 2)).astype(np.int32)
    jc = jl.init_cache(jcfg, 2, 16)
    tc = tl.init_cache(tcfg, 2, 16, device="cpu")
    for chunk in (ids, nxt):
        jlog, jc = jl.apply_cached(jparams, jnp.asarray(chunk), jcfg, jc)
        tlog, tc = tl.apply_cached(tparams, torch.from_numpy(chunk), tcfg, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert tc["index"] == int(jc["index"]) == 9
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("variant", ["plain", "attention_bias", "gemma_style"])
def test_apply_paged_matches_jax(variant, t, kernel):
    """Decode (T=1) and verify-window (T=3) forwards against a shared pool;
    ``kernel=True`` on CPU tensors runs the paged kernels' plain versions,
    held here to the JAX Pallas kernels (interpret mode)."""
    jcfg, tcfg, jparams, tparams = _setup(variant)
    rng = np.random.default_rng(2)
    bs, m = 4, 4
    pool = _pool(rng, jcfg, 12, bs)
    tables = np.asarray([[3, 5, 0, 0], [0, 0, 0, 0], [1, 2, 4, 6]], np.int32)
    starts = np.asarray([6, 0, 13], np.int32)
    ids = rng.integers(0, jcfg.vocab_size, size=(3, t)).astype(np.int32)
    jlog, jrows = jl.apply_paged(
        jparams, jnp.asarray(ids), jcfg, jax.tree.map(jnp.asarray, pool),
        jnp.asarray(tables), jnp.asarray(starts), kernel=kernel,
    )
    tlog, trows = tl.apply_paged(
        tparams, torch.from_numpy(ids), tcfg, {k: torch.from_numpy(v) for k, v in pool.items()},
        torch.from_numpy(tables), torch.from_numpy(starts), kernel=kernel,
    )
    assert tuple(tlog.shape) == (3, t, jcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for name in ("k", "v"):
        assert tuple(trows[name].shape) == (3, jcfg.num_layers, t, jcfg.num_kv_heads, 16)
        np.testing.assert_allclose(trows[name].numpy(), np.asarray(jrows[name]), **TOL)


@pytest.mark.parametrize("kernel", [True, False])
def test_apply_paged_int8_pool_raises(kernel):
    """int8 codes without their ``k_scale``/``v_scale`` leaves are not a
    pool: it raises rather than reading codes as values.  (The whole int8
    pool is held against JAX in ``test_torch_kv_quant.py``.)"""
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    params = tl.init_params(cfg, seed=0, device="cpu")
    shape = (cfg.num_layers, 4, 4, cfg.num_kv_heads, cfg.head_dim_)
    pool = {k: torch.zeros(shape, dtype=torch.int8) for k in ("k", "v")}
    tables = torch.tensor([[1, 0]], dtype=torch.int32)
    with pytest.raises(ValueError, match="int8"):
        tl.apply_paged(params, torch.tensor([[3]]), cfg, pool, tables,
                       torch.tensor([2], dtype=torch.int32), kernel=kernel)


def test_generate_matches_jax_with_chunked_prefill():
    jcfg, tcfg, jparams, tparams = _setup("plain")
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    want = np.asarray(jl.generate(jparams, jnp.asarray(ids), jcfg, max_new_tokens=5))
    got = tl.generate(tparams, torch.from_numpy(ids), tcfg, max_new_tokens=5)
    np.testing.assert_array_equal(got.numpy(), want)
    chunked = tl.generate(tparams, torch.from_numpy(ids), tcfg, max_new_tokens=5, prefill_chunk=4)
    np.testing.assert_array_equal(chunked.numpy(), want)


def test_scatter_routes_past_table_to_null_block():
    rng = np.random.default_rng(4)
    pool = rng.standard_normal((2, 6, 4, 1, 2)).astype(np.float32)
    rows = rng.standard_normal((2, 2, 5, 1, 2)).astype(np.float32)
    tables = np.asarray([[2, 3], [5, 1]], np.int32)
    start = np.asarray([5, 1], np.int32)  # slot 0 writes positions 5..9: 8, 9 are past the table
    want = np.asarray(jgen.scatter_token_rows(
        jnp.asarray(pool), jnp.asarray(rows), jnp.asarray(tables), jnp.asarray(start), 5))
    got = tgen.scatter_token_rows(torch.from_numpy(pool.copy()), torch.from_numpy(rows),
                                  torch.from_numpy(tables), torch.from_numpy(start), 5)
    real = [1, 2, 3, 4, 5]  # the null block's content is unspecified on both sides
    np.testing.assert_array_equal(got.numpy()[:, real], want[:, real])
    np.testing.assert_array_equal(got.numpy()[:, 2:4], want[:, 2:4])


def test_gather_extract_and_paged_cache_write_match_jax():
    rng = np.random.default_rng(5)
    pool = rng.standard_normal((2, 7, 4, 2, 3)).astype(np.float32)
    tables = np.asarray([[1, 4, 0], [6, 2, 3]], np.int32)
    start = np.asarray([2, 7], np.int32)
    view_j = jgen.gather_block_view(jnp.asarray(pool), jnp.asarray(tables))
    view_t = tgen.gather_block_view(torch.from_numpy(pool), torch.from_numpy(tables))
    np.testing.assert_array_equal(view_t.numpy(), np.asarray(view_j))
    np.testing.assert_array_equal(
        tgen.extract_token_rows(view_t, torch.from_numpy(start), 3).numpy(),
        np.asarray(jgen.extract_token_rows(view_j, jnp.asarray(start), 3)),
    )
    new = rng.standard_normal((2, 3, 2, 3)).astype(np.float32)
    js, jctx = jgen.paged_cache_write(jnp.asarray(pool[0]), jnp.asarray(new), jnp.asarray(tables),
                                      jnp.asarray(start), jnp.float32)
    ts, tctx = tgen.paged_cache_write(torch.from_numpy(pool[0]), torch.from_numpy(new),
                                      torch.from_numpy(tables), torch.from_numpy(start))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tctx.numpy(), np.asarray(jctx))


def test_speculative_verify_greedy_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((4, 4, 9)).astype(np.float32)
    drafts = np.argmax(logits[:, :3], -1).astype(np.int32)
    drafts[1, 0] = (drafts[1, 0] + 1) % 9  # reject at once
    drafts[2, 2] = (drafts[2, 2] + 1) % 9  # accept two
    draft_len = np.asarray([3, 3, 3, 1], np.int32)
    jt, jm = jgen.speculative_verify_greedy(jnp.asarray(logits), jnp.asarray(drafts),
                                            jnp.asarray(draft_len))
    tt, tm = tgen.speculative_verify_greedy(torch.from_numpy(logits), torch.from_numpy(drafts),
                                            torch.from_numpy(draft_len))
    assert tm.tolist() == np.asarray(jm).tolist() == [3, 0, 2, 1]
    assert tt.tolist() == np.asarray(jt).tolist()


def test_init_params_shapes_and_rule():
    cfg = tl.LlamaConfig.tiny(attention_bias=True, rms_offset=True)
    params = tl.init_params(cfg, seed=3, device="cpu")
    shapes = jl._param_shapes(jl.LlamaConfig.tiny(attention_bias=True, rms_offset=True))
    assert {k: tuple(v.shape) for k, v in params["layers"].items()} == shapes["layers"]
    assert tuple(params["embed"].shape) == shapes["embed"]
    assert params["layers"]["ln_attn"].abs().max() == 0  # offset convention starts at zero
    assert params["layers"]["bq"].abs().max() == 0
    wq = params["layers"]["wq"]
    assert wq.dtype == torch.float32 and wq.abs().max() <= 2.0 / np.sqrt(cfg.hidden_size) + 1e-6
    assert torch.equal(tl.init_params(cfg, seed=3, device="cpu")["embed"], params["embed"])
    model = tl.LlamaForCausalLM(cfg, params, device="cpu")
    assert model.params["layers"]["wq"] is model.layers["wq"]
    ids = torch.tensor([[1, 2, 3]])
    logits, _ = model(ids, tl.init_cache(cfg, 1, 8, device="cpu"))
    assert logits.shape == (1, 3, cfg.vocab_size) and torch.isfinite(logits).all()


@pytest.mark.parametrize("field,value", [
    ("fp8", True), ("kv_cache_quant", True), ("sp_impl", "ulysses"), ("remat_policy", "dots"),
])
def test_unported_config_fields_raise(field, value):
    """The fields still unported raise; ``kv_cache_quant`` is ported and
    gives an int8 cache, ``remat_policy="dots"`` is ported and trains
    (its parity with JAX is in ``test_torch_remat_dots.py``), and
    ``sp_impl="ulysses"`` is ported and, off an ``sp`` mesh, trains as the
    one-process forward (its parity with JAX is in ``test_torch_sp.py``)."""
    if field == "sp_impl":
        cfg = tl.LlamaConfig.tiny(dtype=torch.float32, **{field: value})
        plain = tl.LlamaConfig.tiny(dtype=torch.float32)
        params = tl.init_params(cfg, seed=0, device="cpu")
        batch = {"input_ids": torch.tensor([[1, 2, 3, 4]])}
        assert torch.equal(tl.loss_fn(params, batch, cfg), tl.loss_fn(params, batch, plain))
        return
    if field == "kv_cache_quant":
        cache = tl.init_cache(tl.LlamaConfig.tiny(**{field: value}), 1, 4, device="cpu")
        assert cache["k"].dtype == torch.int8 and cache["k_scale"].dtype == torch.bfloat16
        return
    if field == "remat_policy":
        cfg = tl.LlamaConfig.tiny(remat=True, **{field: value})
        params = tl.init_params(cfg, seed=0, device="cpu")
        params["layers"]["wq"].requires_grad_(True)
        loss = tl.loss_fn(params, {"input_ids": torch.tensor([[1, 2, 3, 4]])}, cfg)
        (grad,) = torch.autograd.grad(loss, [params["layers"]["wq"]])
        assert torch.isfinite(loss) and torch.isfinite(grad).all() and grad.abs().sum() > 0
        return
    with pytest.raises(NotImplementedError, match=field):
        tl.LlamaConfig.tiny(**{field: value})


@pytest.mark.parametrize("field,value", [
    ("attention_impl", "flash"), ("attention_impl", "pallas"), ("loss_impl", "chunked"),
])
def test_training_config_fields_build_and_run(field, value):
    """The training fields ported with the training slice build, and
    ``loss_fn`` runs through them on the CPU."""
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, loss_chunk_size=100, **{field: value})
    assert getattr(cfg, field) == value
    params = tl.init_params(cfg, seed=0, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, size=(2, 64)))
    loss = tl.loss_fn(params, {"input_ids": ids}, cfg)
    assert loss.shape == () and torch.isfinite(loss)


def test_entry_points_default_to_cuda():
    from accelerate_tpu_torch import Accelerator

    cfg = tl.LlamaConfig.tiny()
    if torch.cuda.is_available():
        assert tl.init_params(cfg)["embed"].device.type == "cuda"
        assert Accelerator().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl.LlamaForCausalLM(cfg)
    model = tl.LlamaForCausalLM(cfg, device="cpu")
    opt = torch.optim.AdamW(model.parameters())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Accelerator().prepare(model, opt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Accelerator().make_train_step(model, opt)
