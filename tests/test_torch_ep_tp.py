"""Expert parallelism, tensor parallelism for every family, replicated
heads and the dispatcher by data shard in the port (``ops/moe.py``,
``models/*.py``, ``parallel/sharding.py``, ``parallel/collectives.py``,
``data_loader.py``), against the JAX package.

In one module-scoped world of 4 gloo processes (``torch_dp_world``), each
family's tiny config in fp32 (weights from JAX's ``init_params``) runs one
eager SGD step through ``prepare``: Mixtral on ``ep=2 x fsdp=2``
(``FULL_SHARD``), ``dp=2 x ep=2`` and ``ep=2 x tp=2``, and its ragged
grouped matmul on ``tp=4``; GPT-2, T5, BERT,
ViT and ResNet on ``fsdp=2 x tp=2`` (``FULL_SHARD``); the llama family
with ``tp`` not dividing its heads: ``tiny`` (4 / 2 heads) at ``tp=4``, a
one-kv-head tiny at ``fsdp=2 x tp=2`` and a two-head tiny at ``tp=4``.  On
each, against JAX's dense loss on the same weights and rows (the global
batch): step 1's loss, every gathered gradient leaf, the norm
``clip_grad_norm_`` returns and the SGD delta, with
``test_torch_fsdp_tp.py``'s checks and fp32 tolerances; every leaf
replicated on a model axis (the router among them) has the same gradient
on every process that holds it whole; each process's shards equal the
addressable shard of JAX's ``shard_params`` on the device at its
coordinate (the suite's CPU devices), and the specs equal JAX's
``make_param_specs``.  ResNet's batch statistics after the step equal
JAX's dense ones.  Then ``moe_impl="ragged"`` under ``ep`` and under a
sharded batch, the dispatcher's rows along ``tp`` / ``ep``, and an ``ep``
checkpoint round trip.  Without a world: each family's ``param_specs``
against JAX's.
"""

import functools
import importlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from accelerate_tpu.parallel import sharding as jsh
from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JaxFSDP
from torch_dp_world import World

AXES = ("dcn_dp", "dp", "fsdp", "pp", "sp", "ep", "tp")
LR = 0.1
# test_torch_fsdp_tp.py's fp32 tolerances (loss 2e-6 relative; gradients
# 2e-6 absolute, 1e-4 relative, 1e-5 in relnorm; deltas 1e-6 absolute,
# 1e-4 in relnorm).
LOSS_RTOL = 2e-6
GRAD_ATOL, GRAD_RTOL, GRAD_RELNORM = 2e-6, 1e-4, 1e-5
DELTA_ATOL, DELTA_RELNORM = 1e-6, 1e-4
STATS_TOL = 1e-5

# name: (family, tiny config fields, mesh, FSDP strategy[, the port's own fields])
CASES = {
    "mixtral_ep2xfsdp2": ("mixtral", {}, dict(ep=2, fsdp=2), "FULL_SHARD"),
    "mixtral_dp2xep2": ("mixtral", {}, dict(dp=2, ep=2), None),
    "mixtral_ep2xtp2": ("mixtral", {}, dict(ep=2, tp=2), None),
    # The ragged grouped matmul under tp (its columns of the FFN, one query
    # head and a replicated kv head a process), against JAX's dense
    # dispatch at a capacity that drops no token (the same function).
    "mixtral_ragged_tp4": ("mixtral", dict(capacity_factor=8.0), dict(tp=4), None,
                           dict(moe_impl="ragged")),
    "gpt2_fsdp2xtp2": ("gpt2", {}, dict(fsdp=2, tp=2), "FULL_SHARD"),
    "t5_fsdp2xtp2": ("t5", {}, dict(fsdp=2, tp=2), "FULL_SHARD"),
    "bert_fsdp2xtp2": ("bert", {}, dict(fsdp=2, tp=2), "FULL_SHARD"),
    "vit_fsdp2xtp2": ("vit", {}, dict(fsdp=2, tp=2), "FULL_SHARD"),
    "resnet_fsdp2xtp2": ("resnet", {}, dict(fsdp=2, tp=2), "FULL_SHARD"),
    # tp not dividing the kv heads (4 / 2 heads, tp 4): each process's one
    # query head reads its kv head of the whole K/V weights.
    "llama_tp4": ("llama", dict(num_layers=2), dict(tp=4), None),
    # one kv head: query heads 2 / 2, the kv head replicated.
    "llama_1kv_fsdp2xtp2": ("llama", dict(num_layers=2, num_kv_heads=1),
                            dict(fsdp=2, tp=2), "FULL_SHARD"),
    # tp not dividing the query heads (2 heads, tp 4): every process
    # computes every head.
    "llama_2heads_tp4": ("llama", dict(num_layers=2, num_heads=2, num_kv_heads=2),
                         dict(tp=4), None),
}


@pytest.fixture(scope="module", autouse=True)
def _restore_jax_global_mesh():
    before = jax.sharding.get_mesh()
    yield
    jax.set_mesh(before)


@pytest.fixture(scope="module")
def refs():
    """JAX's dense step of every case, computed in a thread beside the
    world's processes: ``refs[name]`` is a future of ``(params, stats,
    batch, step)``."""
    def one(name):
        family, cfg_kw = CASES[name][:2]
        jcfg = _jax_cfg(family, tuple(sorted(cfg_kw.items())))
        params, stats = _jax_init(family, jcfg)
        batch = _batch(family, jcfg)
        return params, stats, batch, _jax_step_cached(family, jcfg, params, stats)

    pool = ThreadPoolExecutor(max_workers=2)
    futures = {name: pool.submit(one, name) for name in CASES}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("ep_tp_world"), threads=1)
    yield w
    w.close()


def _jfam(family):
    return importlib.import_module(f"accelerate_tpu.models.{family}")


def _tfam(family):
    return importlib.import_module(f"accelerate_tpu_torch.models.{family}")


_CONFIGS = {"llama": "LlamaConfig", "mixtral": "MixtralConfig", "gpt2": "GPT2Config",
            "t5": "T5Config", "bert": "BertConfig", "vit": "ViTConfig",
            "resnet": "ResNetConfig"}


def _jax_cfg(family, cfg_kw=()):
    return getattr(_jfam(family), _CONFIGS[family]).tiny(dtype=jnp.float32, **dict(cfg_kw))


def _batch(family, jcfg):
    rng = np.random.default_rng(11)
    v = getattr(jcfg, "vocab_size", None)
    if family in ("llama", "mixtral", "gpt2"):
        return {"input_ids": rng.integers(0, v, size=(4, 16)).astype(np.int32),
                "attention_mask": np.ones((4, 16), np.int32)}
    if family == "t5":
        return {"input_ids": rng.integers(0, v, size=(4, 12)).astype(np.int32),
                "decoder_input_ids": rng.integers(0, v, size=(4, 8)).astype(np.int32),
                "labels": rng.integers(0, v, size=(4, 8)).astype(np.int32)}
    if family == "bert":
        return {"input_ids": rng.integers(0, v, size=(4, 16)).astype(np.int32),
                "labels": rng.integers(0, jcfg.num_labels, size=(4,)).astype(np.int32)}
    size = jcfg.image_size if family == "vit" else 8
    return {"pixel_values": rng.normal(size=(4, size, size, 3)).astype(np.float32),
            "labels": rng.integers(0, jcfg.num_labels, size=(4,)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_init(family, jcfg):
    """JAX's ``init_params`` (and ResNet's batch statistics) as numpy."""
    fam = _jfam(family)
    params = jax.jit(lambda k: fam.init_params(jcfg, k))(jax.random.key(0))
    stats = fam.init_batch_stats(jcfg) if family == "resnet" else None
    return jax.tree.map(np.asarray, params), (None if stats is None
                                              else jax.tree.map(np.asarray, stats))


def _jax_step(family, jcfg, params, batch, stats=None):
    """JAX's dense loss, gradients, SGD delta applied in fp32 (and ResNet's
    new stats)."""
    fam = _jfam(family)
    b = jax.tree.map(jnp.asarray, batch)
    p = jax.tree.map(jnp.asarray, params)
    if family == "resnet":
        def loss(p, b, s):
            return fam.classification_loss_fn(p, s, b, jcfg)

        (value, new_stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            p, b, jax.tree.map(jnp.asarray, stats))
    else:
        fn = fam.classification_loss_fn if family in ("bert", "vit") else fam.loss_fn
        value, grads = jax.jit(jax.value_and_grad(lambda p, b: fn(p, b, jcfg)))(p, b)
        new_stats = None
    grads = jax.tree.map(np.asarray, grads)
    # The step as the port takes it, in fp32: the parameters after it less
    # those before (a norm scale near 1 keeps its rounding).
    delta = jax.tree.map(lambda w, g: (w + np.float32(-LR) * g) - w, params, grads)
    return (float(value), grads, delta,
            None if new_stats is None else jax.tree.map(np.asarray, new_stats))


_STEPS: dict = {}


def _jax_step_cached(family, jcfg, params, stats):
    """:func:`_jax_step` once per config (the Mixtral meshes share one)."""
    if jcfg not in _STEPS:
        _STEPS[jcfg] = _jax_step(family, jcfg, params, _batch(family, jcfg), stats)
    return _STEPS[jcfg]


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


def _jax_mesh(mesh_kw):
    shape = [mesh_kw.get(a, 1) for a in AXES]
    n = int(np.prod(shape))
    return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), AXES)


def _active(spec, mesh_kw):
    return {a for e in (spec or ()) for a in ((e,) if isinstance(e, str) else (e or ()))
            if mesh_kw.get(a, 1) > 1}


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_matches_jax_dense(refs, world, name):
    family, cfg_kw, mesh_kw, strategy, *port_kw = CASES[name]
    jfam = _jfam(family)
    params, stats, batch, (loss, grads, delta, new_stats) = refs[name].result()
    outs = world.run("torch_ep_tasks:family_step", family, params,
                     dict(cfg_kw, **(port_kw[0] if port_kw else {})), mesh_kw, strategy, batch,
                     LR, stats)
    jmesh = _jax_mesh(mesh_kw)
    plugin = JaxFSDP(sharding_strategy=strategy) if strategy else None
    jspecs = jsh.make_param_specs(params, jmesh, plugin, rules=jfam.PARTITION_RULES)
    placed = _flat(jsh.shard_params(jax.tree.map(jnp.asarray, params), jmesh, jspecs))
    flat_jspecs = {k: tuple(v) for k, v in _flat(jspecs).items()}
    flat_params, flat_grads, flat_delta = _flat(params), _flat(grads), _flat(delta)
    want_norm = float(np.sqrt(sum(np.sum(np.square(g)) for g in flat_grads.values())))
    for rank, out in enumerate(outs):
        assert {k: tuple(v) for k, v in _flat(out["param_specs"]).items()} == flat_jspecs
        device = jmesh.devices.flat[rank]
        for path, arr in placed.items():
            (shard,) = [s.data for s in arr.addressable_shards if s.device == device]
            np.testing.assert_array_equal(out["shards"][path].numpy(), np.asarray(shard),
                                          err_msg=f"{name} rank {rank} shard {path}")
        np.testing.assert_allclose(out["loss"], loss, rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(out["norm"], want_norm, rtol=1e-5)
        for path, g in flat_grads.items():
            _close(g, out["grads"][path], f"{name} grad {path}", GRAD_ATOL, GRAD_RTOL,
                   GRAD_RELNORM)
        for path, d in flat_delta.items():
            got = out["p1"][path].numpy() - flat_params[path]
            _close(d, got, f"{name} delta {path}", DELTA_ATOL, GRAD_RTOL, DELTA_RELNORM)
        if new_stats is not None:
            for path, s in _flat(new_stats).items():
                np.testing.assert_allclose(out["stats"][path].numpy(), s, atol=STATS_TOL,
                                           rtol=STATS_TOL, err_msg=f"{name} stats {path}")
    # A leaf replicated on a model axis comes out of the step with the same
    # gradient on every process that holds the same part of it (the router
    # and the norm scales under ep, every bias and norm under tp).
    model_axes = {a for a in ("fsdp", "ep", "tp") if mesh_kw.get(a, 1) > 1}
    checked = 0
    for path in flat_grads:
        spec = outs[0]["specs"][path]
        on = _active(spec, mesh_kw)
        if not (model_axes - on - {"fsdp"}):
            continue
        by_part: dict = {}
        for out in outs:
            key = tuple(out["coords"][a] for a in sorted(on))
            by_part.setdefault(key, []).append(out["local"][path])
        for key, same in by_part.items():
            for g in same[1:]:
                assert torch.equal(g, same[0]), (name, path, key)
        checked += 1
    assert checked > 0
    if family == "mixtral" and mesh_kw.get("ep", 1) > 1:
        assert _active(outs[0]["specs"]["layers/w_gate"], mesh_kw) >= {"ep"}
        assert not _active(outs[0]["specs"]["layers/router"], mesh_kw) - {"fsdp"}
    comm = set(outs[0]["comm"])
    if mesh_kw.get("tp", 1) > 1:
        assert any(k.startswith("all_reduce:") and "tp" in k for k in comm), comm
    if mesh_kw.get("ep", 1) > 1:
        assert any(k.startswith("all_reduce:") and "ep" in k for k in comm), comm


def test_ragged_raises_under_ep_and_warns_on_a_sharded_batch(world):
    under_ep = world.run("torch_ep_tasks:ragged_checks", dict(ep=2, tp=2))
    for out in under_ep:
        assert out["ragged"] is not None and "ep>1" in out["ragged"]
        assert out["dense"] is None and not out["dense_warnings"]
    sharded = world.run("torch_ep_tasks:ragged_checks", dict(dp=2, fsdp=2))
    for out in sharded:
        assert out["ragged"] is None
        assert any("sharded batch axes" in w for w in out["ragged_warnings"])
        assert out["dense"] is None and not out["dense_warnings"]


def test_dispatcher_rows_by_data_shard(world):
    for mesh_kw in (dict(dp=2, tp=2), dict(ep=2, fsdp=2)):
        outs = world.run("torch_ep_tasks:dispatcher_rows", mesh_kw, 16)
        data_axis = "dp" if "dp" in mesh_kw else "fsdp"
        by_shard: dict = {}
        for out in outs:
            assert out["type"] == "DataLoaderDispatcher" and out["total_batch_size"] == 4
            by_shard.setdefault(out["coords"][data_axis], []).append(out["rows"])
        # Processes along tp / ep read the same rows; the two data shards
        # split each global batch of 2 x 2 rows and together read all 16.
        assert all(r == rows[0] for rows in by_shard.values() for r in rows)
        assert [by_shard[0][0][0], by_shard[1][0][0]] == [[0, 1], [2, 3]]
        seen = sorted(x for rows in by_shard.values() for b in rows[0] for x in b)
        assert seen == list(range(16))


def test_ep_checkpoint_round_trip(world, tmp_path):
    jcfg = _jax_cfg("mixtral", {})
    params, _ = _jax_init("mixtral", jcfg)
    batch = _batch("mixtral", jcfg)
    outs = world.run("torch_ep_tasks:ep_checkpoint_round_trip", params, {}, dict(dp=2, ep=2),
                     batch, str(tmp_path / "ckpt"))
    for out in outs:
        assert out["same"] and out["same_opt"], out
        assert out["gate_shapes"] == [(2, 2, 64, 96), (2, 4, 64, 96)]
    main = outs[0]
    assert main["files"] == ["model.safetensors"]
    for k, v in main["full"].items():
        assert torch.equal(main["unwrapped"][k], v)
    # The optimizer's state is saved at the full shapes (all four experts).
    assert (2, 4, 64, 96) in set(main["opt_shapes"].values())


# -- the rules, without a world ---------------------------------------------------------

@pytest.mark.parametrize("family", ["mixtral", "gpt2", "t5", "bert", "vit", "resnet"])
def test_param_specs_equal_jax(family):
    jcfg = _jax_cfg(family, {})
    tcfg = getattr(_tfam(family), _CONFIGS[family]).tiny(dtype=torch.float32)
    want = {k: tuple(v) for k, v in _flat(_jfam(family).param_specs(jcfg)).items()}
    assert _flat(_tfam(family).param_specs(tcfg)) == want
    assert _tfam(family).PARTITION_RULES == [(r, tuple(s)) for r, s in
                                              _jfam(family).PARTITION_RULES]
