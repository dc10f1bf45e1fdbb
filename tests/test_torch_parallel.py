"""Several processes in the port (``state.py``, ``parallel/``,
``utils/operations.py``, ``data_loader.py``, ``local_sgd.py``,
``resilience/preemption.py``) against the JAX package.

Without processes, exact against the JAX functions on the same inputs:
``ParallelismConfig`` (fields, ``from_env``, errors), the default mesh
(``resolve_parallelism`` for 1 / 2 / 4 / 8 processes on 1 and 2 nodes,
the JAX ``_resolve_parallelism`` with as many devices and one process per
node), ``shard_dim`` / ``shard_shape`` / ``shard_spec`` over a table of
shapes and degrees 2 / 4 / 8, ``ZeROConfig`` and its env, ``supported``'s
reasons; ``chunked_global_norm`` within 1e-6 relative, degree 80 included
(the JAX fori path above 64).

In one 2-process gloo world (module-scoped, ``torch_dp_world``): every
collective of ``utils/operations.py``; each process's loader rows equal to
the JAX ``BatchSamplerShard`` / ``IterableDatasetShard`` / dispatcher
slices at ``num_processes`` 2; ``gather_for_metrics`` returning each row of
an epoch once; ``LocalSGD``'s average; a coordinated preemption where only
process 1 is signalled and both stop at the same step; the ZeRO smoke's
assertions over its two processes' records.  Exact.  And ``host_offload``
on the CPU (a placement no-op there).
"""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.data_loader import BatchSamplerShard as JaxBatchSamplerShard
from accelerate_tpu.data_loader import IterableDatasetShard as JaxIterableDatasetShard
from accelerate_tpu.parallel import zero as jzero
from accelerate_tpu.parallel.mesh import build_mesh as jax_build_mesh
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.utils.dataclasses import ParallelismConfig as JaxParallelismConfig
from accelerate_tpu_torch import AcceleratorState
from accelerate_tpu_torch.parallel import zero as tzero
from accelerate_tpu_torch.parallel.mesh import Mesh
from accelerate_tpu_torch.state import resolve_parallelism
from accelerate_tpu_torch.utils import ParallelismConfig
from torch_dp_world import World

AXES = ("dcn_dp", "dp", "fsdp", "pp", "sp", "ep", "tp")
ENV = {"ACCELERATE_PARALLELISM_" + a.upper(): a for a in AXES}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    yield
    AcceleratorState._reset_state(reset_partial_state=True)


def _fields(cfg):
    return {a: getattr(cfg, a) for a in AXES}


# -- ParallelismConfig and the default mesh ------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"dp": 4}, {"dp": 2, "tp": 2, "dcn_dp": 2},
                                {"fsdp": 8}, {"sp": 2, "ep": 2, "pp": 2}])
def test_parallelism_config_fields_equal_jax(kw):
    t, j = ParallelismConfig(**kw), JaxParallelismConfig(**kw)
    assert _fields(t) == _fields(j) and t.AXIS_ORDER == j.AXIS_ORDER == AXES
    assert (t.total_size, t.active_axes, t.data_shard_size) == (
        j.total_size, j.active_axes, j.data_shard_size)


def test_parallelism_config_from_env_and_errors_equal_jax(monkeypatch):
    for i, key in enumerate(ENV):
        monkeypatch.setenv(key, str(1 + i % 3))
    assert _fields(ParallelismConfig.from_env()) == _fields(JaxParallelismConfig.from_env())
    for bad in ({"dp": 0}, {"tp": -1}, {"sp": 1.5}):
        with pytest.raises(ValueError) as te:
            ParallelismConfig(**bad)
        with pytest.raises(ValueError) as je:
            JaxParallelismConfig(**bad)
        assert str(te.value) == str(je.value)


def _jax_resolve(monkeypatch, cfg, n, nodes):
    monkeypatch.setattr(jax, "device_count", lambda: n)
    monkeypatch.setattr(jax, "process_count", lambda: nodes)
    ns = types.SimpleNamespace(fsdp_plugin=None, tp_plugin=None, sp_plugin=None)
    return JaxAcceleratorState._resolve_parallelism(ns, cfg)


@pytest.mark.parametrize("n,nodes", [(1, 1), (2, 1), (4, 1), (8, 1), (2, 2), (4, 2), (8, 2)])
def test_default_mesh_equals_jax(monkeypatch, n, nodes):
    want = _fields(_jax_resolve(monkeypatch, JaxParallelismConfig(), n, nodes))
    assert _fields(resolve_parallelism(ParallelismConfig(), n, nodes)) == want
    explicit = {"dp": n}
    assert _fields(resolve_parallelism(ParallelismConfig(**explicit), n, nodes)) == _fields(
        _jax_resolve(monkeypatch, JaxParallelismConfig(**explicit), n, nodes))


def test_mesh_errors(monkeypatch):
    with pytest.raises(ValueError) as te:
        resolve_parallelism(ParallelismConfig(dp=4), 2)
    with pytest.raises(ValueError) as je:
        _jax_resolve(monkeypatch, JaxParallelismConfig(dp=4), 2, 1)
    assert str(te.value) == str(je.value)
    parts = {"pp": "A7"}
    for axis, part in parts.items():
        with pytest.raises(NotImplementedError, match=part):
            resolve_parallelism(ParallelismConfig(**{axis: 2}), 2)
    # the model axes of ROADMAP A6 part 1 and the sp axis of part 2 run
    for axis in ("fsdp", "tp", "ep", "sp"):
        assert _fields(resolve_parallelism(ParallelismConfig(**{axis: 2}), 2)) == _fields(
            _jax_resolve(monkeypatch, JaxParallelismConfig(**{axis: 2}), 2, 1))


def test_one_process_state_has_a_trivial_mesh():
    from accelerate_tpu_torch import Accelerator

    acc = Accelerator(cpu=True)
    assert acc.num_processes == 1 and acc.mesh.shape == dict.fromkeys(AXES, 1)
    assert acc.mesh.device_mesh is None and acc.mesh.group() is None
    assert tzero.supported(acc.mesh) == jzero.supported(jax_build_mesh(JaxParallelismConfig(),
                                                                       jax.devices()[:1]))


# -- the shard geometry, ZeROConfig and supported ---------------------------------------

SHAPES = [(), (1,), (7,), (8,), (128,), (6, 4), (4, 6), (3, 5), (16, 24), (24, 16), (12, 12),
          (2, 3, 4), (5, 8, 8), (3, 7, 16), (4096, 14336), (128256, 4096), (1024, 4096)]


@pytest.mark.parametrize("degree", [2, 4, 8])
def test_shard_geometry_equals_jax(degree):
    for shape in SHAPES:
        assert tzero.shard_dim(shape, degree) == jzero.shard_dim(shape, degree), shape
        assert tzero.shard_shape(shape, degree) == jzero.shard_shape(shape, degree), shape
        for axes in (("dp",), ("dcn_dp", "dp")):
            assert tzero.shard_spec(shape, axes, degree) == tuple(
                jzero.shard_spec(shape, axes, degree)), (shape, axes)


@pytest.mark.parametrize("zero", [None, True, False, "config"])
@pytest.mark.parametrize("env", [{}, {"ACCELERATE_TPU_ZERO": "1"},
                                 {"ACCELERATE_TPU_ZERO": "1", "ACCELERATE_TPU_ZERO_OVERLAP": "0"},
                                 {"ACCELERATE_TPU_ZERO": "no", "ACCELERATE_TPU_ZERO_OVERLAP": "on"}])
def test_zero_config_equals_jax(monkeypatch, zero, env):
    for k in ("ACCELERATE_TPU_ZERO", "ACCELERATE_TPU_ZERO_OVERLAP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    targ = tzero.ZeROConfig(enabled=True, overlap=False) if zero == "config" else zero
    jarg = jzero.ZeROConfig(enabled=True, overlap=False) if zero == "config" else zero
    t, j = tzero.ZeROConfig.resolve(targ), jzero.ZeROConfig.resolve(jarg)
    assert (t.enabled, t.overlap, t.overlap_effective) == (j.enabled, j.overlap,
                                                          j.overlap_effective)
    assert (tzero.ENV_ZERO, tzero.ENV_ZERO_OVERLAP, tzero.ZERO_AXES) == (
        jzero.ENV_ZERO, jzero.ENV_ZERO_OVERLAP, jzero.ZERO_AXES)


@pytest.mark.parametrize("kw", [{}, {"dp": 8}, {"dp": 2, "dcn_dp": 4}, {"dp": 2, "tp": 4},
                                {"fsdp": 8}, {"dp": 4, "sp": 2}, {"tp": 8}])
def test_supported_and_layout_equal_jax(kw):
    jm = jax_build_mesh(JaxParallelismConfig(**kw), jax.devices()[:JaxParallelismConfig(
        **kw).total_size])
    tm = Mesh(kw)
    assert tzero.supported(tm) == jzero.supported(jm)
    assert (tzero.zero_axes(tm), tzero.zero_degree(tm)) == (jzero.zero_axes(jm),
                                                            jzero.zero_degree(jm))
    for enabled in (False, True):
        assert tzero.opt_state_layout(tm, enabled) == jzero.opt_state_layout(jm, enabled)
    assert tzero.supported(None) == jzero.supported(None)


NORM_SHAPES = [(16, 24), (24,), (5,), (3, 8), (160, 3), (80,), (7, 11), (2, 40, 6)]


@pytest.mark.parametrize("degree", [2, 4, 8, 80])
def test_chunked_global_norm_equals_jax(degree):
    rng = np.random.default_rng(degree)
    tree = {f"g{i}": rng.standard_normal(s).astype(np.float32) * (i + 1)
            for i, s in enumerate(NORM_SHAPES)}
    mesh = jax_build_mesh(JaxParallelismConfig(), jax.devices()[:1])
    with jax.set_mesh(mesh):  # the fori path pins its vector to the context mesh
        want = float(jzero.chunked_global_norm(jax.tree.map(jnp.asarray, tree), degree,
                                               jnp.asarray(True)))
    got = float(tzero.chunked_global_norm({k: torch.from_numpy(v) for k, v in tree.items()},
                                          degree))
    assert abs(got - want) <= 1e-6 * want
    fence = torch.tensor(False)
    assert float(tzero.chunked_global_norm(torch.ones(8), degree, fence)) == 0.0


# -- one 2-process gloo world --------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, tmp_path_factory.mktemp("world2"))
    yield w
    w.close()


def test_collectives_over_two_processes(world):
    r0, r1 = world.run("torch_dp_tasks:collectives_task")
    for r, out in enumerate((r0, r1)):
        assert (out["rank"], out["n"], out["type"], out["backend"]) == (r, 2, "MULTI_GPU", "gloo")
        assert out["mesh"] == {**dict.fromkeys(AXES, 1), "dp": 2}
        assert out["gather"].tolist() == [0, 10, 1, 11]
        assert out["gather0d"].tolist() == [0.0, 1.0]
        assert out["gather_tree"]["a"].tolist() == [[0] * 3] * 2 + [[1] * 3] * 2
        assert out["gather_tree"]["b"][0].tolist() == [0.0, 1.0]
        assert out["gather_object"] == [0, "p0", 1, "p1"]
        assert out["broadcast"].tolist() == [100, 101, 102]
        assert out["broadcast_objects"] == [1, {"k": 1}]
        assert out["reduce_sum"].tolist() == [4.0, 2.0]
        assert out["reduce_mean"].tolist() == [1.0, 0.5]
        assert out["pad"].shape == (2, 2) and out["pad_first"].shape == (2, 2)
        assert out["on_main"] == (0 if r == 0 else None)
        assert out["on_last"] == (1 if r == 1 else None)
        assert out["trigger"] is True
    assert r0["pad"].tolist() == [[1.0, 1.0], [-1.0, -1.0]]
    assert r0["pad_first"].tolist() == [[0.0, 1.0], [0.0, 1.0]]
    assert (r0["split"], r1["split"]) == ([0, 1, 2], [3, 4, 4])
    assert (r0["split_dict"].tolist(), r1["split_dict"].tolist()) == ([0, 1, 2], [3, 4])
    assert r0["first"] < r1["first"]  # the main process went first


def test_zero_shaped_reduce_scatter_and_all_gather(world):
    for shape in [(6, 4), (3, 8), (5,)]:
        outs = world.run("torch_dp_tasks:zero_collective_shapes", shape, 2)
        full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape) * 1.5
        d = tzero.shard_dim(shape, 2)
        for r, out in enumerate(outs):
            assert out["dim"] == d
            want = full if d is None else full.narrow(d, r * shape[d] // 2, shape[d] // 2)
            assert torch.equal(out["grad_shard"], want)
            if d is not None:
                assert torch.equal(out["gather"], full)


def _jax_shard_rows(n_rows, batch_size, n, r, split_batches, even_batches, drop_last=False):
    sampler = torch.utils.data.BatchSampler(range(n_rows), batch_size, drop_last)
    return [list(b) for b in JaxBatchSamplerShard(sampler, num_processes=n, process_index=r,
                                                  split_batches=split_batches,
                                                  even_batches=even_batches)]


def _jax_stream_rows(n_rows, batch_size, n, r, split_batches):
    shard = JaxIterableDatasetShard(list(range(n_rows)), batch_size=batch_size, num_processes=n,
                                    process_index=r, split_batches=split_batches)
    mine = batch_size // n if split_batches else batch_size
    items = list(shard)
    return [items[i:i + mine] for i in range(0, len(items), mine)]


def _jax_dispatch_rows(n_rows, batch_size, n, r):
    """The JAX ``DataLoaderDispatcher``'s slice of each global batch (its
    ``_emit_tracked`` on ``n`` loader batches concatenated)."""
    from accelerate_tpu.data_loader import DataLoaderDispatcher as JaxDispatcher

    loader = torch.utils.data.DataLoader(torch.arange(n_rows), batch_size=batch_size)
    disp = JaxDispatcher(loader, put_on_device=False)
    disp.state = types.SimpleNamespace(num_processes=n, process_index=r, is_main_process=True)
    batches = list(loader)
    out = []
    for i in range(0, len(batches), n):
        glob = torch.cat(batches[i:i + n])
        out.append(disp._emit_tracked(glob)[0].tolist())
    return out


LOADER_CASES = [(37, 4, False, True), (37, 4, False, False), (40, 4, True, True),
                (13, 2, False, True), (16, 4, True, False)]


@pytest.mark.parametrize("n_rows,bs,split,even", LOADER_CASES)
def test_loader_rows_equal_jax_at_two_processes(world, n_rows, bs, split, even):
    got = world.run("torch_dp_tasks:loader_rows", n_rows, bs, split, even)
    for r in range(2):
        assert got[r] == _jax_shard_rows(n_rows, bs, 2, r, split, even)


def test_stream_and_dispatcher_rows_equal_jax_at_two_processes(world):
    for split in (False, True):
        got = world.run("torch_dp_tasks:loader_rows", 21, 4, split, True, False, True)
        for r in range(2):
            assert got[r] == _jax_stream_rows(21, 4, 2, r, split)
    got = world.run("torch_dp_tasks:loader_rows", 21, 4, False, True, True)
    for r in range(2):
        assert got[r] == _jax_dispatch_rows(21, 4, 2, r)


@pytest.mark.parametrize("dispatch", [False, True])
def test_gather_for_metrics_drops_the_duplicates(world, dispatch):
    for out in world.run("torch_dp_tasks:gather_for_metrics_rows", 37, 4, dispatch):
        assert sorted(out["tensors"]) == list(range(37))
        assert sorted(out["objects"]) == list(range(37))


def test_local_sgd_averages_the_replicas(world):
    r0, r1 = world.run("torch_dp_tasks:local_sgd_average")
    assert r0["diverged"] and r0["mean_err"] == 0.0 and r1["mean_err"] == 0.0
    assert all(torch.equal(r0["after"][k], r1["after"][k]) for k in r0["after"])


def test_coordinated_preemption_stops_every_process_at_one_step(world, tmp_path):
    r0, r1 = world.run("torch_dp_tasks:coordinated_stop", str(tmp_path / "final"), 1, 3)
    # Process 1 alone is signalled at step 3; the flag is agreed every 2nd
    # check, so both stop at step 4, and the final checkpoint is one.
    assert (r0["local"], r1["local"]) == (False, True)
    assert r0["stopped"] == r1["stopped"] == 4
    assert "random_states_0.pkl" in r0["saved"] and "random_states_1.pkl" in r0["saved"]
    assert "model.safetensors" in r0["saved"] and "manifest.json" in r0["saved"]


def test_several_processes_without_a_coordinator_raise(monkeypatch):
    from accelerate_tpu_torch import Accelerator

    for k in ("MASTER_ADDR", "ACCELERATE_COORDINATOR_ADDRESS", "ACCELERATE_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="no coordinator"):
        Accelerator(cpu=True)
    assert not AcceleratorState._shared_state


def test_env_contract_names(monkeypatch):
    from accelerate_tpu_torch.state import _launch_contract
    from accelerate_tpu_torch.utils.dataclasses import DistributedInitKwargs

    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "h")
    monkeypatch.setenv("MASTER_PORT", "123")
    assert _launch_contract(DistributedInitKwargs()) == {
        "world": 4, "rank": 3, "local": 1, "coordinator": "h:123"}
    monkeypatch.setenv("ACCELERATE_COORDINATOR_ADDRESS", "c:9")
    monkeypatch.setenv("ACCELERATE_NUM_PROCESSES", "8")
    monkeypatch.setenv("ACCELERATE_PROCESS_ID", "5")
    assert _launch_contract(DistributedInitKwargs()) == {
        "world": 8, "rank": 5, "local": 1, "coordinator": "c:9"}
    kw = DistributedInitKwargs(coordinator_address="k:1", num_processes=2, process_id=0)
    assert _launch_contract(kw) == {"world": 2, "rank": 0, "local": 1, "coordinator": "k:1"}
    assert os.environ["RANK"] == "3"


def test_the_zero_smoke_holds_in_the_world(world):
    """``parallel/zero_smoke.py``'s assertions (bit-exact losses and
    parameters, the collectives' bytes, opt state halved, one call a step)
    over the records of its two processes."""
    from accelerate_tpu_torch.parallel import zero_smoke

    summary = zero_smoke.summarize(world.run("torch_dp_tasks:zero_smoke_record"), "tiny", 0.0)
    assert summary["state_bytes"]["replicated"] > 1.99 * summary["state_bytes"]["zero"]
    assert summary["comm_per_step"]["zero"]["reduce_scatter"]["calls"] == 2


def test_host_offload_on_the_cpu():
    """On the CPU the state already lives in host memory: ``host_offload``
    steps exactly as the plain optimizer, and ``offload_to_host`` (which
    pins CUDA tensors) raises without a host memory kind, as JAX's does."""
    from accelerate_tpu_torch.parallel import host_offload as ho

    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(8, 4, generator=gen)
    grads = [torch.randn(8, 4, generator=gen) for _ in range(3)]
    a, b = torch.nn.Parameter(p0.clone()), torch.nn.Parameter(p0.clone())
    plain = torch.optim.AdamW([a], lr=1e-2)
    off = ho.host_offload(torch.optim.AdamW([b], lr=1e-2))
    for g in grads:
        a.grad, b.grad = g.clone(), g.clone()
        plain.step()
        off.step()
    assert torch.equal(a, b) and ho.host_memory_kind() is None
    with pytest.raises(RuntimeError, match="host memory"):
        ho.offload_to_host(off.state)
