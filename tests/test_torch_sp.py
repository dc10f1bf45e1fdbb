"""Sequence parallelism in every family of the port (``models/*.py``' ``sp``
paths, ``ops/moe.py``'s ``seq_group``, ``optimizer.py``'s sum over ``sp``,
``parallel/sharding.Layout``'s ``sp``), against the JAX package's dense
step.

In a module-scoped world of 2 gloo processes and one of 4
(``torch_dp_world``), each case runs one eager SGD step of a tiny fp32
family through ``prepare``, every process reading the whole rows of its
data shard and running its chunk of the sequence: the llama family on
``sp=2`` (the einsum ring, the ring over the kernels' plain versions,
Ulysses, and a padded batch through the einsum ring), ``sp=4``, ``fsdp=2
x sp=2`` (``FULL_SHARD``) and ``tp=2 x sp=2``; Mixtral on ``sp=2`` and
``ep=2 x sp=2`` (a capacity that drops tokens, so a chunk's slots must
follow the earlier chunks'); GPT-2, BERT with a padding mask and ViT with
``pool="mean"`` on ``sp=2``.  Each against JAX's dense loss, gradients and
SGD step on the same weights and rows (JAX's own ``sp`` x ``tp`` / ``ep``
meshes NaN the loss: ``test_mesh_matrix.py``'s strict xfails), with
``test_torch_fsdp_tp.py``'s fp32 tolerances: the reported loss, every
gathered gradient leaf, the norm ``clip_grad_norm_`` returns and the
delta; every leaf replicated on ``sp`` has the same gradient, bit for bit,
on every process that holds the same part of it; the forward split the
sequence and the gradients were summed over ``sp``.  Then ``apply``'s
gathered outputs against JAX's on the same mesh's layout.
"""

import functools
import importlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_dp_world import World

LR = 0.1
# test_torch_fsdp_tp.py's fp32 tolerances (loss 2e-6 relative; gradients
# 2e-6 absolute, 1e-4 relative, 1e-5 in relnorm; deltas 1e-6 absolute,
# 1e-4 in relnorm).
LOSS_RTOL = 2e-6
GRAD_ATOL, GRAD_RTOL, GRAD_RELNORM = 2e-6, 1e-4, 1e-5
DELTA_ATOL, DELTA_RELNORM = 1e-6, 1e-4

# name: (family, tiny config fields, the port's own fields, mesh, FSDP strategy, batch)
CASES = {
    "llama_ring_sp2": ("llama", {}, {}, dict(sp=2), None, "tokens"),
    "llama_fused_ring_sp2": ("llama", {}, dict(attention_impl="pallas"), dict(sp=2), None,
                             "tokens"),
    "llama_ulysses_sp2": ("llama", {}, dict(sp_impl="ulysses"), dict(sp=2), None, "tokens"),
    "llama_padded_sp2": ("llama", {}, {}, dict(sp=2), None, "padded"),
    "llama_sp4": ("llama", {}, {}, dict(sp=4), None, "tokens"),
    "llama_fsdp2xsp2": ("llama", {}, {}, dict(fsdp=2, sp=2), "FULL_SHARD", "tokens"),
    "llama_tp2xsp2": ("llama", {}, dict(attention_impl="pallas"), dict(tp=2, sp=2), None,
                      "tokens"),
    "mixtral_sp2": ("mixtral", {}, {}, dict(sp=2), None, "tokens"),
    "mixtral_ep2xsp2": ("mixtral", {}, {}, dict(ep=2, sp=2), None, "tokens"),
    "gpt2_sp2": ("gpt2", {}, {}, dict(sp=2), None, "tokens"),
    "bert_padded_sp2": ("bert", {}, {}, dict(sp=2), None, "padded"),
    "vit_mean_sp2": ("vit", dict(pool="mean"), {}, dict(sp=2), None, "pixels"),
}
_CONFIGS = {"llama": "LlamaConfig", "mixtral": "MixtralConfig", "gpt2": "GPT2Config",
            "bert": "BertConfig", "vit": "ViTConfig"}


def _jfam(family):
    return importlib.import_module(f"accelerate_tpu.models.{family}")


def _jax_cfg(family, cfg_kw=()):
    return getattr(_jfam(family), _CONFIGS[family]).tiny(dtype=jnp.float32, **dict(cfg_kw))


def _batch(family, jcfg, kind):
    rng = np.random.default_rng(7)
    v = getattr(jcfg, "vocab_size", None)
    if kind == "pixels":
        return {"pixel_values": rng.normal(size=(4, jcfg.image_size, jcfg.image_size, 3))
                .astype(np.float32),
                "labels": rng.integers(0, jcfg.num_labels, size=(4,)).astype(np.int32)}
    ids = rng.integers(0, v, size=(4, 16)).astype(np.int32)
    mask = np.ones((4, 16), np.int32)
    if kind == "padded":
        if family == "bert":  # right padding: token 0 stays real
            mask[1, 11:] = 0
            mask[3, 5:] = 0
        else:  # left padding across a whole chunk
            mask[1, :9] = 0
            mask[2, :3] = 0
    out = {"input_ids": ids, "attention_mask": mask}
    if family == "bert":
        out["labels"] = rng.integers(0, jcfg.num_labels, size=(4,)).astype(np.int32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_init(family, jcfg):
    params = jax.jit(lambda k: _jfam(family).init_params(jcfg, k))(jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def _jax_step(family, jcfg, params, batch):
    """JAX's dense loss, gradients and SGD delta applied in fp32."""
    fam = _jfam(family)
    fn = fam.classification_loss_fn if family in ("bert", "vit") else fam.loss_fn
    value, grads = jax.jit(jax.value_and_grad(lambda p, b: fn(p, b, jcfg)))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    grads = jax.tree.map(np.asarray, grads)
    delta = jax.tree.map(lambda w, g: (w + np.float32(-LR) * g) - w, params, grads)
    return float(value), grads, delta


_STEPS: dict = {}


def _reference(name):
    family, cfg_kw, _, _, _, kind = CASES[name]
    jcfg = _jax_cfg(family, tuple(sorted(cfg_kw.items())))
    params = _jax_init(family, jcfg)
    batch = _batch(family, jcfg, kind)
    key = (jcfg, kind)
    if key not in _STEPS:
        _STEPS[key] = _jax_step(family, jcfg, params, batch)
    return params, batch, _STEPS[key]


@pytest.fixture(scope="module")
def refs():
    """JAX's dense step of every case, in a thread beside the worlds."""
    pool = ThreadPoolExecutor(max_workers=1)
    futures = {name: pool.submit(_reference, name) for name in CASES}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    # The two worlds start side by side (each waits for its processes).
    with ThreadPoolExecutor(max_workers=2) as pool:
        starting = {n: pool.submit(World, n, tmp_path_factory.mktemp(f"sp_world_{n}"), threads=1)
                    for n in (2, 4)}
        out = {n: f.result() for n, f in starting.items()}
    yield out
    for w in out.values():
        w.close()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _close(want, got, what, atol, rtol, relnorm):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)
    rel = float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12))
    assert rel < relnorm, (what, rel)


def _active(spec, mesh_kw):
    return {a for e in (spec or ()) for a in ((e,) if isinstance(e, str) else (e or ()))
            if mesh_kw.get(a, 1) > 1}


@pytest.mark.parametrize("name", list(CASES))
def test_sp_step_matches_jax_dense(refs, worlds, name):
    family, cfg_kw, port_kw, mesh_kw, strategy, _ = CASES[name]
    params, batch, (loss, grads, delta) = refs[name].result()
    size = int(np.prod(list(mesh_kw.values())))
    outs = worlds[size].run("torch_ep_tasks:family_step", family, params,
                            dict(cfg_kw, **port_kw), mesh_kw, strategy, batch, LR)
    flat_params, flat_grads, flat_delta = _flat(params), _flat(grads), _flat(delta)
    want_norm = float(np.sqrt(sum(np.sum(np.square(g)) for g in flat_grads.values())))
    for rank, out in enumerate(outs):
        assert out["split"], f"{name} rank {rank}: the forward did not split the sequence"
        np.testing.assert_allclose(out["loss"], loss, rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(out["norm"], want_norm, rtol=1e-5)
        for path, g in flat_grads.items():
            _close(g, out["grads"][path], f"{name} grad {path}", GRAD_ATOL, GRAD_RTOL,
                   GRAD_RELNORM)
        for path, d in flat_delta.items():
            got = out["p1"][path].numpy() - flat_params[path]
            _close(d, got, f"{name} delta {path}", DELTA_ATOL, GRAD_RTOL, DELTA_RELNORM)
        assert any(k.startswith("all_reduce:") and "sp" in k for k in out["comm"]), out["comm"]
    # Every process that holds the same part of a leaf (all of it, where no
    # axis splits it) comes out of the step with the same gradient.
    for path in flat_grads:
        by_part: dict = {}
        for out in outs:
            on = sorted(_active(out["specs"][path], mesh_kw))
            key = tuple(out["coords"][a] for a in on)
            by_part.setdefault(key, []).append(out["local"][path])
        for key, same in by_part.items():
            for g in same[1:]:
                assert torch.equal(g, same[0]), (name, path, key)


def test_apply_returns_the_gathered_sequence(refs, worlds):
    """``apply`` under ``sp`` returns JAX's global arrays on every process:
    llama's logits (padded), BERT's sequence output and pooled features,
    ViT's features and mean pool."""
    for name in ("llama_padded_sp2", "bert_padded_sp2", "vit_mean_sp2"):
        family, cfg_kw, _, mesh_kw, _, _ = CASES[name]
        params, batch, _ = refs[name].result()
        jcfg = _jax_cfg(family, tuple(sorted(cfg_kw.items())))
        fam = _jfam(family)
        b = jax.tree.map(jnp.asarray, batch)
        if family == "llama":
            want = {"logits": jax.jit(lambda p, b: fam.apply(
                p, b["input_ids"], jcfg, attention_mask=b["attention_mask"]))(params, b)}
        elif family == "bert":
            x, pooled = jax.jit(lambda p, b: fam.apply(
                p, b["input_ids"], jcfg, attention_mask=b["attention_mask"]))(params, b)
            want = {"x": x, "pooled": pooled}
        else:
            x, pooled = jax.jit(lambda p, b: fam.apply(p, b["pixel_values"], jcfg))(params, b)
            want = {"x": x, "pooled": pooled}
        for out in worlds[2].run("torch_sp_tasks:sp_apply", family, params, cfg_kw, mesh_kw,
                                 batch):
            for key, w in want.items():
                got = out[key].numpy()
                w = np.asarray(w)
                if "attention_mask" in batch and key != "pooled":
                    # A padded query row reads no key on the sp path (zeros,
                    # or, in BERT, every valid key) and another mix on JAX's
                    # dense one; nothing reads those rows.
                    rows = np.asarray(batch["attention_mask"], bool)
                    got, w = got[rows], w[rows]
                np.testing.assert_allclose(got, w, atol=2e-5, rtol=2e-5,
                                           err_msg=f"{name} {key}")
