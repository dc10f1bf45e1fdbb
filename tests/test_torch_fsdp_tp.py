"""FSDP and tensor parallelism in the port (``parallel/sharding.py``,
``parallel/collectives.py``, ``parallel/mesh.py``, the llama family's
sharded forward, ``optimizer.py``, ``checkpointing.py``), against the JAX
package.

In one module-scoped world of 4 gloo processes (``torch_dp_world``), a
2-layer ``LlamaConfig.tiny`` in fp32 (4/2 heads, weights from JAX's
``init_params``) runs on five meshes: ``fsdp=4``, ``fsdp=2 x tp=2`` (a
leaf split on two axes at once; ``remat`` and the fused attention's plain
path, head dim 64), ``dp=2 x tp=2`` (the chunked loss), ``dcn_dp=2 x
fsdp=2`` under ``HYBRID_SHARD`` and ``fsdp=4`` under ``SHARD_GRAD_OP``.
On each, against JAX's dense ``loss_fn`` on the same weights and ids (the
global batch of 4 x 16 tokens): step 1's loss (the eager loop), every
gathered gradient leaf and the norm ``clip_grad_norm_`` returns, step 1's
SGD delta, step 2's loss and delta (``make_train_step``), with the JAX
mesh matrix's checks (elementwise and relnorm) at the fp32 tolerances
below; each process's shards equal the addressable shard of JAX's
``shard_params`` on the device at its coordinate (the suite's CPU
devices), and ``make_param_specs`` equals JAX's.  Then the consolidated
checkpoint round trip and a plain module's gather path.  Without a world:
``make_param_specs`` and ``auto_fsdp_spec`` against JAX's at the tiny and
Llama-3-8B shapes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from accelerate_tpu.models import llama as jl
from accelerate_tpu.parallel import sharding as jsh
from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JaxFSDP
from accelerate_tpu_torch.parallel import sharding as tsh
from accelerate_tpu_torch.parallel.mesh import Mesh as TorchMesh
from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin
from torch_dp_world import World

AXES = ("dcn_dp", "dp", "fsdp", "pp", "sp", "ep", "tp")
LR = 0.1
# fp32 tolerances, about 10x above the largest gaps measured on these meshes
# (loss 1.6e-7 relative, gradients 1.7e-7 absolute and 1.05e-6 in relnorm);
# a delta is a difference of parameters near 1, so its relnorm carries their
# fp32 rounding (2.3e-5 measured): 1e-4, still far below the 0.5 of a
# gradient averaged with the wrong factor of 2.
LOSS_RTOL = 2e-6
GRAD_ATOL, GRAD_RTOL, GRAD_RELNORM = 2e-6, 1e-4, 1e-5
DELTA_ATOL, DELTA_RELNORM = 1e-6, 1e-4
# The sharded cached forward's fp32 logits (test_torch_sharded_serving.py's).
LOGITS_ATOL, LOGITS_RTOL = 2e-5, 1e-4

MESHES = {
    "fsdp4": (dict(fsdp=4), "FULL_SHARD", {}),
    "fsdp2xtp2": (dict(fsdp=2, tp=2), "FULL_SHARD",
                  dict(remat=True, attention_impl="pallas", head_dim=64)),
    "dp2xtp2": (dict(dp=2, tp=2), None, dict(loss_impl="chunked", loss_chunk_size=64)),
    "dcn2xfsdp2_hybrid": (dict(dcn_dp=2, fsdp=2), "HYBRID_SHARD", {}),
    "fsdp4_shard_grad_op": (dict(fsdp=4), "SHARD_GRAD_OP", {}),
}


@pytest.fixture(scope="module", autouse=True)
def _restore_jax_global_mesh():
    before = jax.sharding.get_mesh()
    yield
    jax.set_mesh(before)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("fsdp_tp_world"), threads=1)
    yield w
    w.close()


def _jax_cfg(**kw):
    kw = {k: v for k, v in kw.items() if k in ("head_dim",)}
    return jl.LlamaConfig.tiny(dtype=jnp.float32, num_layers=2, **kw)


def _params(jcfg):
    return jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.key(0)))


def _batches(vocab):
    rng = np.random.default_rng(5)
    return [{"input_ids": rng.integers(0, vocab, size=(4, 16)).astype(np.int32),
             "attention_mask": np.ones((4, 16), np.int32)} for _ in range(2)]


def _jax_reference(jcfg, params, batches):
    """JAX's dense losses, gradients and SGD deltas over two steps."""
    def loss(p, b):
        return jl.loss_fn(p, b, jcfg)

    vg = jax.jit(jax.value_and_grad(loss))
    p = jax.tree.map(jnp.asarray, params)
    out = []
    for b in batches:
        value, grads = vg(p, jax.tree.map(jnp.asarray, b))
        delta = jax.tree.map(lambda g: -LR * g, grads)
        out.append((float(value), jax.tree.map(np.asarray, grads),
                    jax.tree.map(np.asarray, delta)))
        p = jax.tree.map(lambda a, d: a + d, p, delta)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _state_name(path):
    return path.replace("/", ".")


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


def _jax_specs(params, mesh_kw, strategy):
    mesh = _jax_mesh(mesh_kw)
    plugin = JaxFSDP(sharding_strategy=strategy) if strategy else None
    return mesh, jsh.make_param_specs(params, mesh, plugin, rules=jl.PARTITION_RULES)


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_matches_jax_dense(world, name):
    mesh_kw, strategy, cfg_kw = MESHES[name]
    jcfg = _jax_cfg(**cfg_kw)
    params = _params(jcfg)
    batches = _batches(jcfg.vocab_size)
    ref = _jax_reference(jcfg, params, batches)
    outs = world.run("torch_fsdp_tasks:mesh_run", params, dict(num_layers=2, **cfg_kw), mesh_kw,
                     strategy, batches, LR)
    flat_params = _flat(params)
    jmesh, jspecs = _jax_specs(params, mesh_kw, strategy)
    placed = jsh.shard_params(jax.tree.map(jnp.asarray, params), jmesh, jspecs)
    flat_placed = _flat(placed)
    flat_jspecs = {k: tuple(v) for k, v in _flat(jspecs).items()}
    want_type = {None: "TP"}.get(strategy, "FSDP")
    for rank, out in enumerate(outs):
        assert out["type"] == want_type and not out["zero_active"]
        assert {k: tuple(v) for k, v in _flat(out["param_specs"]).items()} == flat_jspecs
        # Each shard is JAX's addressable shard on the device at this coordinate.
        device = jmesh.devices.flat[rank]
        for path, arr in flat_placed.items():
            (shard,) = [s.data for s in arr.addressable_shards if s.device == device]
            np.testing.assert_array_equal(out["shards"][path].numpy(), np.asarray(shard),
                                          err_msg=f"{name} rank {rank} shard {path}")
        (l1, g1, d1), (l2, _, d2) = ref
        np.testing.assert_allclose(out["loss"], [l1, l2], rtol=LOSS_RTOL, atol=0)
        want_norm = float(np.sqrt(sum(np.sum(np.square(g)) for g in _flat(g1).values())))
        np.testing.assert_allclose(out["norm"], want_norm, rtol=1e-5)
        for path, g in _flat(g1).items():
            _close(g, out["grads"][path], f"{name} grad {path}", GRAD_ATOL, GRAD_RTOL,
                   GRAD_RELNORM)
        for path, d in _flat(d1).items():
            got = out["p1"][_state_name(path)].numpy() - flat_params[path]
            _close(d, got, f"{name} step-1 delta {path}", DELTA_ATOL, GRAD_RTOL, DELTA_RELNORM)
        for path, d in _flat(d2).items():
            got = out["p2"][_state_name(path)].numpy() - out["p1"][_state_name(path)].numpy()
            _close(d, got, f"{name} step-2 delta {path}", DELTA_ATOL, GRAD_RTOL, DELTA_RELNORM)
    assert all(o["loss"] == outs[0]["loss"] for o in outs)
    # Serving the shards after step 2: the sharded apply_cached gives JAX's
    # whole-weight logits on every process.
    after = {}
    for path in flat_params:
        node = after
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(outs[0]["p2"][_state_name(path)].numpy())
    want_logits, _ = jl.apply_cached(after, jnp.asarray(batches[1]["input_ids"][:1, :4]), jcfg,
                                     jl.init_cache(jcfg, 1, 8))
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["serving"].numpy(), np.asarray(want_logits),
                                   atol=LOGITS_ATOL, rtol=LOGITS_RTOL,
                                   err_msg=f"{name} rank {rank} sharded apply_cached")
    comm = set(outs[0]["comm"])
    if mesh_kw.get("fsdp", 1) > 1 and strategy in ("FULL_SHARD", "HYBRID_SHARD"):
        assert {"all_gather:fsdp", "reduce_scatter:fsdp"} <= comm, comm
    if mesh_kw.get("tp", 1) > 1:
        assert "all_reduce:tp" in comm, comm


def test_checkpoint_round_trip_and_unwrap(world, tmp_path):
    mesh_kw = dict(fsdp=2, tp=2)
    jcfg = _jax_cfg()
    params = _params(jcfg)
    batch = _batches(jcfg.vocab_size)[0]
    outs = world.run("torch_fsdp_tasks:checkpoint_round_trip", params, dict(num_layers=2),
                     mesh_kw, batch, str(tmp_path / "ckpt"))
    for out in outs:
        assert out["same"] and out["same_opt"], out
        assert out["sharded_same"], out["sharded_files"]
        assert {f"rank{r}.safetensors" for r in range(4)} <= set(out["sharded_files"])
    main = outs[0]
    assert main["files"] == ["model.safetensors"]
    for k, v in main["full"].items():
        assert torch.equal(main["unwrapped"][k], v)
    # The optimizer's state is saved at the full shapes.
    assert (main["opt_shapes"][0] == tuple(main["full"]["embed"].shape)
            or any(s == (256, 64) for s in main["opt_shapes"].values()))


def test_a_plain_module_gathers_its_leaves(world):
    outs = world.run("torch_fsdp_tasks:generic_fsdp", dict(fsdp=4), "FULL_SHARD")
    ref = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 4))
    with torch.no_grad():
        for p, v in zip(ref.parameters(), outs[0]["ref"]):
            p.copy_(v)
    opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    x, y = outs[0]["x"], outs[0]["y"]
    ((ref(x) - y) ** 2).mean().backward()
    opt.step()
    want = ref.state_dict()
    for out in outs:
        assert out["wrapped"] == "PreparedModel"
        assert out["sharded"] == [(4, 8), (4,), (4, 4), (1,)]
        for k, v in want.items():
            torch.testing.assert_close(out["full"][k], v, rtol=1e-6, atol=1e-7)


# -- the rules, without a world ---------------------------------------------------------

SPEC_MESHES = [dict(fsdp=8), dict(fsdp=4, tp=2), dict(dp=2, tp=4), dict(fsdp=2, tp=2),
               dict(dcn_dp=2, fsdp=4), dict(dp=8)]
STRATEGIES = ["FULL_SHARD", "SHARD_GRAD_OP", "NO_SHARD", "HYBRID_SHARD", None]


def _shape_tree(jcfg):
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32), jl._param_shapes(jcfg),
                        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("size", ["tiny", "llama3_8b"])
def test_make_param_specs_equals_jax(size, strategy):
    jcfg = getattr(jl.LlamaConfig, size)(dtype=jnp.float32)
    shapes = _shape_tree(jcfg)
    for mesh_kw in SPEC_MESHES:
        jmesh = _jax_mesh(mesh_kw)
        tmesh = TorchMesh(mesh_kw)
        for min_params in (0, 5000):
            jp = JaxFSDP(sharding_strategy=strategy, min_num_params=min_params) if strategy \
                else None
            tp = FullyShardedDataParallelPlugin(sharding_strategy=strategy,
                                                min_num_params=min_params) if strategy else None
            for rules in (jl.PARTITION_RULES, None):
                from accelerate_tpu_torch.models import llama as tl

                want = jsh.make_param_specs(shapes, jmesh, jp, rules=rules)
                got = tsh.make_param_specs(shapes, tmesh, tp,
                                           rules=tl.PARTITION_RULES if rules else None)
                assert {k: tuple(v) for k, v in _flat(want).items()} == _flat(got), (
                    mesh_kw, strategy, min_params, rules is None)


def test_auto_fsdp_spec_and_rules_equal_jax():
    from jax.sharding import PartitionSpec as P

    shapes = [(), (1,), (7,), (8,), (16, 24), (24, 16), (12, 12), (2, 3, 4), (5, 8, 8),
              (128256, 4096), (32, 4096, 14336), (3, 7)]
    existing = [None, ("tp",), (None, "tp"), ("tp", None, None), ("fsdp",)]
    for mesh_kw in SPEC_MESHES:
        jmesh, tmesh = _jax_mesh(mesh_kw), TorchMesh(mesh_kw)
        for shape in shapes:
            for ex in existing:
                if ex is not None and len(ex) > len(shape):
                    continue
                for min_size in (0, 100):
                    want = jsh.auto_fsdp_spec(shape, jmesh, None if ex is None else P(*ex),
                                              min_size=min_size)
                    got = tsh.auto_fsdp_spec(shape, tmesh, ex, min_size=min_size)
                    assert tuple(want) == got, (mesh_kw, shape, ex, min_size)
    from accelerate_tpu_torch.models import llama as tl

    for path in ("embed", "layers/wq", "layers/wo", "layers/bq", "layers/bo", "layers/ln_attn",
                 "final_norm", "lm_head", "other"):
        for ndim in (1, 2, 3):
            want = jsh.spec_from_rules(path, ndim, jl.PARTITION_RULES)
            got = tsh.spec_from_rules(path, ndim, tl.PARTITION_RULES)
            assert (None if want is None else tuple(want)) == got
    assert {k: tuple(v) for k, v in _flat(jl.param_specs(jl.LlamaConfig.tiny())).items()} == \
        _flat(tl.param_specs(tl.LlamaConfig.tiny()))


def test_tp_not_dividing_the_heads_shards_as_jax_and_a_leaf_it_does_not_divide_raises():
    """``tp`` not dividing the heads no longer raises (the port computes
    those heads whole, as JAX's ``tp_head_axis`` keeps them off ``tp``;
    ``test_torch_ep_tp.py`` holds the step to JAX's): the tiny llama's 4 / 2
    heads shard over ``tp=4`` as JAX's ``shard_params`` lays them out.  A
    leaf that ``tp`` does not divide (here the FFN width) raises, as JAX's
    ``shard_params`` does."""
    from accelerate_tpu_torch.models import llama as tl

    for width, divides in ((64, True), (90, False)):
        jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, num_layers=1, intermediate_size=width)
        tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, num_layers=1, intermediate_size=width)
        params = _params(jcfg)
        jmesh = _jax_mesh(dict(tp=4))
        tmesh = TorchMesh({"tp": 4})
        specs = tl.param_specs(tcfg)
        if not divides:
            with pytest.raises(ValueError):
                jsh.shard_params(jax.tree.map(jnp.asarray, params), jmesh, jl.param_specs(jcfg))
            with pytest.raises(ValueError, match="does not divide"):
                tsh.local_slice(torch.from_numpy(params["layers"]["w_up"]),
                                specs["layers"]["w_up"], tmesh)
            continue
        placed = _flat(jsh.shard_params(jax.tree.map(jnp.asarray, params), jmesh,
                                         jl.param_specs(jcfg)))
        flat_specs, flat_params = _flat(specs), _flat(params)
        for rank in range(4):
            device = jmesh.devices.flat[rank]
            for path, arr in placed.items():
                (shard,) = [x.data for x in arr.addressable_shards if x.device == device]
                got = tsh.local_slice(torch.from_numpy(flat_params[path]), flat_specs[path],
                                      tmesh, rank)
                np.testing.assert_array_equal(got.numpy(), np.asarray(shard), err_msg=path)


def test_sharding_all_is_jax_all():
    assert tsh.__all__ == jsh.__all__
    assert tsh.constrain(torch.ones(2), ("fsdp", None)).shape == (2,)
    with pytest.raises(ValueError, match="not a mesh axis"):
        tsh.constrain(torch.ones(2), ("nope",))
    with tsh.manual_region():
        assert tsh.in_manual_region()
        tsh.constrain(torch.ones(2), ("nope",))
    assert not tsh.in_manual_region()


def test_embed_lookup_equals_jax_gather_and_one_hot():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((32, 8)).astype(np.float32)
    ids = rng.integers(0, 32, size=(2, 5))
    want = np.asarray(jsh.embed_lookup(jnp.asarray(table), jnp.asarray(ids), jnp.float32))
    t = torch.from_numpy(table)
    for mesh_kw in (dict(), dict(fsdp=2), dict(tp=2)):
        got = tsh.embed_lookup(t, torch.from_numpy(ids), torch.float32, TorchMesh(mesh_kw))
        np.testing.assert_array_equal(got.numpy(), want)
    # Local vocabulary rows: each half's part sums to the lookup.
    halves = [tsh.embed_lookup(t[16 * i:16 * (i + 1)], torch.from_numpy(ids), torch.float32,
                               TorchMesh(dict(tp=2)), vocab_start=16 * i) for i in range(2)]
    np.testing.assert_array_equal((halves[0] + halves[1]).numpy(), want)
