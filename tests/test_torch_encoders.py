"""The port's BERT, ViT and ResNet (``accelerate_tpu_torch/models/{bert,vit,
resnet}.py``) against the JAX package's on the same weights and inputs.

The JAX trees (LayerNorm and BN parameters drawn away from their init, so
each counts) are carried across by the converters.  fp32 compute;
tolerances: forwards and batch statistics 1e-5, losses and gradients a
relative 1e-4 (gradients against the largest entry of their leaf).  The
JAX side runs jitted."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import bert as jb
from accelerate_tpu.models import resnet as jr
from accelerate_tpu.models import vit as jv
from accelerate_tpu_torch.models import bert as tb
from accelerate_tpu_torch.models import resnet as tr
from accelerate_tpu_torch.models import vit as tv
from accelerate_tpu_torch.utils import convert

TOL = dict(rtol=1e-5, atol=1e-5)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _jitter(np_params, seed):
    """Scales, biases and zero-initialized leaves drawn near their init."""
    rng = np.random.default_rng(seed)
    flat = dict(_flat(np_params))
    for k, v in flat.items():
        name = k.split("/")[-1]
        if name.endswith("scale"):
            flat[k] = rng.normal(1.0, 0.2, v.shape).astype(np.float32)
        elif not v.any():
            flat[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
    return _unflat(flat)


def _grads_match(loss_t, leaves, jgrads):
    loss_t.backward()
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    for k, v in leaves.items():
        scale = max(np.abs(want[k]).max(), 1e-6)
        diff = np.abs(v.grad.numpy() - want[k]).max()
        assert diff <= 1e-4 * scale, f"{k}: {diff} against {scale}"


def _leaves(params):
    leaves = {k: v.clone().requires_grad_() for k, v in _flat(params)}
    return leaves, _unflat(leaves)


# ----------------------------------------------------------------------- BERT


def _bert(seed=0, **kw):
    jcfg = jb.BertConfig.tiny(dtype=jnp.float32, num_labels=3, **kw)
    tcfg = tb.BertConfig.tiny(dtype=torch.float32, num_labels=3, **kw)
    params = _jitter(jax.tree.map(np.asarray, jax.jit(jb.init_params, static_argnums=0)(
        jcfg, jax.random.key(seed))), seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, params), convert.bert_params_from_jax(
        params, tcfg, device="cpu")


def _bert_batch(seed=1, b=2, s=12):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s), np.int32)
    mask[1, 7:] = 0
    return {"input_ids": rng.integers(0, 256, (b, s)).astype(np.int32),
            "token_type_ids": (np.arange(s)[None] >= 5).astype(np.int32).repeat(b, 0),
            "attention_mask": mask, "labels": np.asarray([0, 2], np.int32)}


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "padding_mask"])
def test_bert_forward_matches_jax(masked):
    jcfg, tcfg, jparams, tparams = _bert()
    batch = _bert_batch()
    m = batch["attention_mask"] if masked else None
    jx, jpool = jax.jit(jb.apply, static_argnums=2)(
        jparams, jnp.asarray(batch["input_ids"]), jcfg,
        None if m is None else jnp.asarray(m), jnp.asarray(batch["token_type_ids"]))
    tx, tpool = tb.apply(tparams, torch.from_numpy(batch["input_ids"]), tcfg,
                         None if m is None else torch.from_numpy(m),
                         torch.from_numpy(batch["token_type_ids"]))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), **TOL)


def test_bert_loss_and_grads_match_jax():
    jcfg, tcfg, jparams, tparams = _bert(seed=2, remat=True)
    batch = _bert_batch(seed=3)
    jl, jg = jax.jit(jax.value_and_grad(jb.classification_loss_fn), static_argnums=2)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    leaves, tree = _leaves(tparams)
    loss = tb.classification_loss_fn(tree, {k: torch.from_numpy(v) for k, v in batch.items()},
                                      tcfg)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    _grads_match(loss, leaves, jg)


# ------------------------------------------------------------------------ ViT


def _vit(pool, seed=0, **kw):
    jcfg = jv.ViTConfig.tiny(dtype=jnp.float32, pool=pool, **kw)
    tcfg = tv.ViTConfig.tiny(dtype=torch.float32, pool=pool, **kw)
    params = _jitter(jax.tree.map(np.asarray, jax.jit(jv.init_params, static_argnums=0)(
        jcfg, jax.random.key(seed))), seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, params), convert.vit_params_from_jax(
        params, tcfg, device="cpu")


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vit_forward_loss_and_grads_match_jax(pool):
    jcfg, tcfg, jparams, tparams = _vit(pool, remat=pool == "mean")
    assert tcfg.num_params() == jcfg.num_params() == sum(
        v.numel() for _, v in _flat(tparams))
    rng = np.random.default_rng(4)
    batch = {"pixel_values": rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
             "labels": np.asarray([3, 7], np.int32)}
    jx, jpool = jax.jit(jv.apply, static_argnums=2)(jparams, jnp.asarray(batch["pixel_values"]),
                                                      jcfg)
    tx, tpool = tv.apply(tparams, torch.from_numpy(batch["pixel_values"]), tcfg)
    assert tuple(tx.shape) == (2, jcfg.seq_len, 64)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), **TOL)
    jl, jg = jax.jit(jax.value_and_grad(jv.classification_loss_fn), static_argnums=2)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    leaves, tree = _leaves(tparams)
    loss = tv.classification_loss_fn(tree, {k: torch.from_numpy(v) for k, v in batch.items()},
                                      tcfg)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    _grads_match(loss, leaves, jg)


def test_vit_config_validation_matches_jax():
    for kw in (dict(image_size=30), dict(hidden_size=66), dict(pool="max")):
        with pytest.raises(ValueError) as want:
            jv.ViTConfig.tiny(**kw)
        with pytest.raises(ValueError) as got:
            tv.ViTConfig.tiny(**kw)
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------------- ResNet


RESNETS = {
    "basic": dict(block="basic", stage_sizes=(2, 2), width=8, num_labels=5, stem="cifar"),
    "bottleneck": dict(block="bottleneck", stage_sizes=(2, 1), width=4, num_labels=5,
                       stem="imagenet"),
}


def _resnet(name, seed=0, **kw):
    jcfg = jr.ResNetConfig(dtype=jnp.float32, **RESNETS[name], **kw)
    tcfg = tr.ResNetConfig(dtype=torch.float32, **RESNETS[name], **kw)
    params = _jitter(jax.tree.map(np.asarray, jax.jit(jr.init_params, static_argnums=0)(
        jcfg, jax.random.key(seed))), seed)
    rng = np.random.default_rng(seed + 7)
    stats = jax.tree.map(np.asarray, jr.init_batch_stats(jcfg))
    stats = _unflat({k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("_var")
                         else rng.normal(0, 0.2, v.shape)).astype(np.float32)
                     for k, v in _flat(stats)})
    tparams, tstats = convert.resnet_params_from_jax(params, stats, tcfg, device="cpu")
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
            tparams, tstats)


@pytest.mark.parametrize("name,train", [("basic", False), ("basic", True),
                                        ("bottleneck", True)],
                         ids=["basic-eval", "basic-train", "bottleneck-train"])
def test_resnet_forward_stats_loss_and_grads_match_jax(name, train):
    jcfg, tcfg, jparams, jstats, tparams, tstats = _resnet(name, remat=train)
    assert tcfg.num_params() == jcfg.num_params()
    rng = np.random.default_rng(5)
    size = 16 if name == "basic" else 32
    batch = {"pixel_values": rng.normal(size=(3, size, size, 3)).astype(np.float32),
             "labels": np.asarray([1, 4, 0], np.int32)}
    jfn = jax.jit(jax.value_and_grad(jr.classification_loss_fn, has_aux=True),
                  static_argnums=(3, 4))
    (jl, jnew), jg = jfn(jparams, jstats, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                         train)
    leaves, tree = _leaves(tparams)
    loss, tnew = tr.classification_loss_fn(
        tree, tstats, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg, train=train)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    want = dict(_flat(jax.tree.map(np.asarray, jnew)))
    got = dict(_flat(tnew))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert not v.requires_grad, k
        np.testing.assert_allclose(v.numpy(), want[k], err_msg=k, **TOL)
        if not train:
            assert torch.equal(v, dict(_flat(tstats))[k])
    _grads_match(loss, leaves, jg)


def test_resnet_init_rule_and_unported_mesh():
    cfg = tr.ResNetConfig.tiny()
    params = tr.init_params(cfg, seed=0, device="cpu")
    stats = tr.init_batch_stats(cfg, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: jr.init_params(jr.ResNetConfig.tiny(), jax.random.key(0))))
    assert {k: tuple(v.shape) for k, v in _flat(params)} == dict(_flat(shapes))
    assert not params["stage0"]["head"]["bn2_scale"].any()  # each block starts as identity
    assert params["stem"]["bn_scale"].eq(1).all()
    jstats = jax.eval_shape(lambda: jr.init_batch_stats(jr.ResNetConfig.tiny()))
    assert {k: tuple(v.shape) for k, v in _flat(stats)} == {
        k: tuple(v.shape) for k, v in _flat(jstats)}
    for k, v in _flat(stats):  # running means zero, variances one
        assert v.dtype == torch.float32 and v.eq(1.0 if k.endswith("_var") else 0.0).all(), k
    assert tr.ResNetConfig.resnet50().num_params() == 25_557_032


def test_encoder_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device exists")
    for fn in (lambda: tb.init_params(tb.BertConfig.tiny()),
               lambda: tv.init_params(tv.ViTConfig.tiny()),
               lambda: tr.init_params(tr.ResNetConfig.tiny()),
               lambda: tr.init_batch_stats(tr.ResNetConfig.tiny())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
    # Ulysses is ported (ROADMAP A6 part 2); an unknown sp_impl still raises.
    assert tb.BertConfig.tiny(sp_impl="ulysses").sp_impl == "ulysses"
    with pytest.raises(ValueError, match="sp_impl"):
        tb.BertConfig.tiny(sp_impl="rings")
