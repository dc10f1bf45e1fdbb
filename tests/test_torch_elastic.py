"""The elastic topology resume in the port (``resilience/elastic.py``, the
elastic paths of ``checkpointing.py`` and ``Accelerator.resume_from_latest``)
against the JAX package.

In-process, against JAX's functions on the same inputs: the topology
record's keys, mesh, parallelism, leaves and optimizer layout;
``plan_resume``'s changes (a live accelerator of the same mesh; the
``world_size`` entry differs, since JAX's records hold one process of 8
devices where the port's hold 8 processes: ROADMAP C), its refusals of a
pipeline change and of a newer schema; ``validate_leaves``' offenders;
``recompute_skip_batches``; the python and numpy streams of
``fold_rng_bundle``; ``plan_campaign`` for 40 seeds.

In a 4-process and a 2-process gloo world (``torch_dp_world``, tasks in
``torch_elastic_tasks``) and in this process: a tiny fp32 llama (JAX's
weights) under SGD with momentum saved after one step on ``dp=4`` with
ZeRO and on ``dp=2 x fsdp=2`` under ``SHARDED_STATE_DICT``, each resumed on
2 ranks, on 4 ranks under the other layout and in one process: the state
digest bit-identical to the saver's, a reshard reported, and the next step
equal to JAX's dense step (``value_and_grad`` at the saved weights, the
momentum update) at the fp32 tolerances of ``test_torch_fsdp_tp.py``.  A save on 2 ranks resumed
on 4: the new ranks' python and numpy streams are JAX's fold for them, and
no two ranks share a stream.  A resume across a changed global batch
yields exactly the unseen examples, JAX's list; a non-divisible geometry
raises before any load.  The whole chaos campaign on the CPU is the one
``slow`` test (``--seed 0``, 5 worlds of up to 8 processes, about a
minute)."""

import dataclasses
import json
import os
import random
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import llama as jl
from accelerate_tpu.resilience import chaos as jchaos
from accelerate_tpu.resilience import elastic as jel
from accelerate_tpu_torch.resilience import chaos as tchaos
from accelerate_tpu_torch.resilience import elastic as tel
from torch_dp_world import REPO, World

LR, MOMENTUM = 0.1, 0.9
# The fp32 tolerances of tests/test_torch_fsdp_tp.py.
LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-4
DELTA_ATOL, DELTA_RELNORM = 1e-6, 1e-4


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    four = World(4, tmp_path_factory.mktemp("elastic_world4"), threads=1)
    two = World(2, tmp_path_factory.mktemp("elastic_world2"), threads=1)
    yield four, two
    four.close()
    two.close()


def _reset_jax():
    from accelerate_tpu.state import AcceleratorState, GradientState, PartialState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    PartialState._reset_state()


def _reset_port():
    from accelerate_tpu_torch import AcceleratorState

    AcceleratorState._reset_state(reset_partial_state=True)


def _jax_toy(tmp_path, zero=True):
    """The JAX tests' dp=8 toy after one fused step."""
    import optax

    from accelerate_tpu import Accelerator
    from accelerate_tpu.accelerator import JaxModel
    from accelerate_tpu.parallel.sharding import data_sharding
    from accelerate_tpu.utils import ProjectConfiguration
    from accelerate_tpu.utils.dataclasses import ParallelismConfig

    _reset_jax()
    acc = Accelerator(parallelism_config=ParallelismConfig(dp=8),
                      project_config=ProjectConfiguration(project_dir=str(tmp_path)))
    params = {"w": jax.random.normal(jax.random.PRNGKey(0), (64, 32), jnp.float32) * 0.1,
              "b": jax.random.normal(jax.random.PRNGKey(1), (32,), jnp.float32) * 0.1}

    def apply_fn(p, x, y):
        return {"loss": jnp.mean((jnp.tanh(x @ p["w"] + p["b"]) - y) ** 2)}

    model, opt = acc.prepare(JaxModel(apply_fn, params), optax.adam(1e-2))
    step_fn = acc.make_train_step(model, opt, clip_norm=0.05, zero=zero)
    sh = data_sharding(acc.mesh)
    step_fn({"x": jax.device_put(np.ones((16, 64), np.float32), sh),
             "y": jax.device_put(np.zeros((16, 32), np.float32), sh)})
    return acc


def _port_toy(tmp_path):
    """The same toy in the port, one process, one step."""
    from accelerate_tpu_torch import Accelerator, FunctionalModel
    from accelerate_tpu_torch.utils import ProjectConfiguration

    _reset_port()
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(project_dir=str(tmp_path)))
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(64, 32, generator=g) * 0.1, "b": torch.randn(32, generator=g) * 0.1}
    model = FunctionalModel(lambda p, x, y: {"loss": ((torch.tanh(x @ p["w"] + p["b"]) - y) ** 2)
                                             .mean()}, params)
    model, opt = acc.prepare(model, torch.optim.Adam(model.parameters(), lr=1e-2))
    step = acc.make_train_step(model, opt, clip_norm=0.05)
    step({"x": torch.ones(16, 64), "y": torch.zeros(16, 32)})
    return acc


def _flat_name(keystr: str) -> str:
    """JAX's ``keystr`` path (``['layers']['wq']``) as the port's name."""
    return ".".join(part.strip("'") for part in keystr.strip("[]").split("]["))


def _live(mesh_kw: dict, world: int):
    """A stand-in for a live port accelerator on a mesh of ``world`` ranks:
    what ``plan_resume`` reads."""
    from accelerate_tpu_torch.parallel.mesh import Mesh
    from accelerate_tpu_torch.utils.dataclasses import ParallelismConfig

    state = types.SimpleNamespace(mesh=Mesh(mesh_kw), num_processes=world,
                                  parallelism_config=ParallelismConfig(**mesh_kw))
    return types.SimpleNamespace(state=state)


# -- in-process parity ---------------------------------------------------------------------


def test_capture_topology_record_matches_jax(tmp_path):
    jrec = jel.capture_topology(_jax_toy(tmp_path / "j"), step=1)
    trec = tel.capture_topology(_port_toy(tmp_path / "t"), step=1)
    assert set(trec) == set(jrec)
    for key in ("schema", "step", "pp"):
        assert trec[key] == jrec[key], key
    assert trec["mesh"]["axes"] == jrec["mesh"]["axes"]
    assert set(trec["rng"]) == set(jrec["rng"])
    assert set(trec["data"]) >= set(jrec["data"])
    jleaves = {_flat_name(k): v for k, v in jrec["models"]["0"].items()}
    assert trec["models"]["0"] == jleaves
    # The dp=8 JAX layout against the port's one process: both name their kind.
    assert jrec["optimizers"][0]["layout"]["kind"] == "zero"
    assert trec["optimizers"][0]["layout"] == {"kind": "replicated", "axes": [], "degree": 1}
    assert trec["world_size"] == trec["device_count"] == 1


def test_plan_resume_matches_jax_on_the_same_mesh_change(tmp_path):
    jacc = _jax_toy(tmp_path)
    rec = jel.capture_topology(jacc, step=1)
    rec.update(mesh={"axes": rec["mesh"]["axes"],
                     "shape": [4 if a == "dp" else 1 for a in rec["mesh"]["axes"]]},
               device_count=4, world_size=4)
    jplan = jel.plan_resume(rec, jacc)
    tplan = tel.plan_resume(rec, _live({"dp": 8}, 8))
    assert tplan.changed and jplan.changed
    # JAX's live record is one process of 8 devices, the port's 8 processes.
    assert [c for c in tplan.changes if not c.startswith("world_size")] == \
           [c for c in jplan.changes if not c.startswith("world_size")]
    assert "world_size 4 -> 1" in jplan.changes and "world_size 4 -> 8" in tplan.changes
    for field in ("saved_mesh", "live_mesh", "saved_global_batch", "saved_opt_layouts",
                  "schema"):
        assert getattr(tplan, field) == getattr(jplan, field), field
    same = jel.capture_topology(jacc, step=1)
    assert not jel.plan_resume(same, jacc).changed
    same["world_size"] = 8
    assert not tel.plan_resume(same, _live({"dp": 8}, 8)).changed


@pytest.mark.parametrize("pp,match", [({"degree": 4, "virtual_stages": 1}, "pipeline stage"),
                                      ({"degree": 1, "virtual_stages": 2}, "virtual_stages")])
def test_plan_resume_refuses_a_pipeline_change_as_jax(tmp_path, pp, match):
    jacc = _jax_toy(tmp_path)
    rec = dict(jel.capture_topology(jacc, step=1), pp=pp)
    with pytest.raises(jel.ElasticTopologyError, match=match) as jerr:
        jel.plan_resume(rec, jacc)
    with pytest.raises(tel.ElasticTopologyError, match=match) as terr:
        tel.plan_resume(rec, _live({"dp": 8}, 8))
    assert str(terr.value) == str(jerr.value)
    rec = dict(rec, pp={"degree": 1, "virtual_stages": 1}, schema=99)
    with pytest.raises(tel.ElasticTopologyError, match="schema v99"):
        tel.plan_resume(rec, _live({"dp": 8}, 8))


def test_validate_leaves_names_the_offenders_as_jax(tmp_path):
    def problems(err):
        return set(str(err.value).split("(", 1)[1].rstrip(")").split("; "))

    jacc = _jax_toy(tmp_path / "j")
    jrec = jel.capture_topology(jacc, step=1)
    jrec["models"]["0"]["['w']"]["shape"] = [128, 32]
    del jrec["models"]["0"]["['b']"]
    with pytest.raises(jel.ElasticTopologyError) as jerr:
        jel.validate_leaves(jrec, jacc)
    tacc = _port_toy(tmp_path / "t")
    trec = tel.capture_topology(tacc, step=1)
    trec["models"]["0"]["w"]["shape"] = [128, 32]
    del trec["models"]["0"]["b"]
    with pytest.raises(tel.ElasticTopologyError) as terr:
        tel.validate_leaves(trec, tacc)
    assert problems(terr) == {p.replace("['w']", "w").replace("['b']", "b")
                              for p in problems(jerr)}
    trec = tel.capture_topology(tacc, step=1)
    trec["optimizers"][0]["leaves"] = trec["optimizers"][0]["leaves"][:-1]
    with pytest.raises(tel.ElasticTopologyError, match="opt-state"):
        tel.validate_leaves(trec, tacc)


def test_recompute_skip_batches_matches_jax():
    for args in ((3, 16, 8), (3, 16, 16), (4, 8, 32), (None, 16, 8), (3, None, 8), (0, 16, 8),
                 (6, 4, 12), (7, 24, 56)):
        assert tel.recompute_skip_batches(*args) == jel.recompute_skip_batches(*args), args
    for args in ((2, 8, 33), (3, 16, 40)):
        with pytest.raises(jel.ElasticTopologyError) as jerr:
            jel.recompute_skip_batches(*args)
        with pytest.raises(tel.ElasticTopologyError) as terr:
            tel.recompute_skip_batches(*args)
        assert str(terr.value) == str(jerr.value)


def test_fold_rng_bundle_python_and_numpy_streams_equal_jax():
    for seed in (None, 0, 1234, 2**40 + 7):
        bundle = {"python": None, "numpy": None, "jax_seed": seed, "torch": None}
        for old, new in ((2, 4), (1, 8), (8, 4)):
            for rank in range(new):
                j = jel.fold_rng_bundle(bundle, rank=rank, new_world=new, old_world=old)
                t = tel.fold_rng_bundle(bundle, rank=rank, new_world=new, old_world=old)
                assert t["python"] == j["python"] and t["jax_seed"] == seed
                assert t["numpy"][0] == j["numpy"][0]
                assert np.array_equal(t["numpy"][1], j["numpy"][1])
                assert t["numpy"][2:] == j["numpy"][2:]
                assert torch.equal(t["torch"], torch.as_tensor(j["torch"]))


def test_plan_campaign_is_jax_schedule():
    for seed in list(range(40)) + [20260804]:
        for total in (10, 12):
            assert ([dataclasses.asdict(c) for c in tchaos.plan_campaign(seed, total)]
                    == [dataclasses.asdict(c) for c in jchaos.plan_campaign(seed, total)])
    assert tchaos.TOPOLOGIES == jchaos.TOPOLOGIES and tchaos.CROSS_TOL == jchaos.CROSS_TOL


def test_legacy_manifest_resumes_as_before(tmp_path):
    """A manifest without its topology record resumes on the legacy path:
    the same state, the legacy flag, no plan, no reshard counted."""
    from accelerate_tpu_torch import telemetry

    acc = _port_toy(tmp_path)
    ckpt = acc.save_state(str(tmp_path / "ckpt"), step=1)
    saved = tel.state_digest(acc)
    path = os.path.join(ckpt, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    assert manifest[tel.TOPOLOGY_KEY]["step"] == 1
    manifest.pop(tel.TOPOLOGY_KEY)
    with open(path, "w") as f:
        json.dump(manifest, f)
    acc2 = _port_toy(tmp_path / "second")
    tele = telemetry.enable(dir=str(tmp_path / "tel"))
    try:
        assert acc2.resume_from_latest(str(tmp_path)) == 1
        assert acc2.last_resume_info.legacy and acc2.last_resume_info.plan is None
        assert tele.registry.counter("elastic.reshards").value == 0
        assert tel.state_digest(acc2) == saved
    finally:
        telemetry.disable()
        tele.registry.reset()


def test_load_rejects_a_pipeline_change_before_touching_state(tmp_path):
    acc = _port_toy(tmp_path)
    ckpt = acc.save_state(str(tmp_path / "ckpt"), step=1)
    path = os.path.join(ckpt, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest[tel.TOPOLOGY_KEY]["pp"] = {"degree": 2, "virtual_stages": 1}
    with open(path, "w") as f:
        json.dump(manifest, f)
    with torch.no_grad():
        for p in acc._models[0].parameters():
            p.add_(1.0)
    before = tel.state_digest(acc)
    with pytest.raises(tel.ElasticTopologyError, match="pipeline stage geometry"):
        acc.load_state(ckpt)
    assert tel.state_digest(acc) == before


# -- saves across processes ----------------------------------------------------------------


def _jax_cfg():
    return jl.LlamaConfig.tiny(dtype=jnp.float32, num_layers=2)


def _batches(vocab):
    rng = np.random.default_rng(11)
    return [{"input_ids": rng.integers(0, vocab, size=(4, 16)).astype(np.int32),
             "attention_mask": np.ones((4, 16), np.int32)} for _ in range(2)]


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v.numpy())
    return out


def _jax_next_step(saved, batch):
    """JAX's dense loss and SGD-with-momentum delta at the saved weights."""
    cfg = _jax_cfg()
    p = _unflat(saved["params"])
    loss, grads = jax.value_and_grad(lambda q: jl.loss_fn(q, jax.tree.map(jnp.asarray, batch),
                                                          cfg))(p)
    g = {k: np.asarray(v) for k, v in _flat_np(grads).items()}
    delta = {k: -LR * (MOMENTUM * saved["bufs"][k].numpy() + g[k]) for k in g}
    return float(loss), delta


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat_np(v, path) if isinstance(v, dict) else {path: v})
    return out


def _check_step(saved, resumed, want, what):
    want_loss, want_delta = want
    assert abs(resumed["loss"] - want_loss) <= LOSS_RTOL * abs(want_loss), what
    for k, d in want_delta.items():
        got = resumed["params"][k].numpy() - saved["params"][k].numpy()
        np.testing.assert_allclose(got, d, atol=DELTA_ATOL, rtol=GRAD_RTOL, err_msg=f"{what} {k}")
        rel = float(np.linalg.norm(got - d) / (np.linalg.norm(d) + 1e-12))
        assert rel < DELTA_RELNORM, (what, k, rel)


# (save mesh, state_dict_type, zero) -> resumes: (where, mesh, state_dict_type, zero)
SAVES = {
    "dp4_zero": (dict(dp=4), "FULL_STATE_DICT", True,
                 [("two", dict(fsdp=2), "SHARDED_STATE_DICT", False),
                  ("four", dict(dp=2, fsdp=2), "SHARDED_STATE_DICT", False),
                  ("one", {}, None, False)]),
    "dp2xfsdp2_sharded": (dict(dp=2, fsdp=2), "SHARDED_STATE_DICT", False,
                          [("two", dict(dp=2), None, True),
                           ("four", dict(dp=4), None, True),
                           ("one", {}, None, False)]),
}


@pytest.mark.parametrize("save", list(SAVES))
def test_save_on_four_ranks_resumes_bit_identically_elsewhere(worlds, tmp_path, save):
    import torch_elastic_tasks as tasks

    four, two = worlds
    cfg = _jax_cfg()
    np_params = jax.tree.map(np.asarray, jl.init_params(cfg, jax.random.key(0)))
    b0, b1 = _batches(cfg.vocab_size)
    mesh_kw, sd_type, zero, resumes = SAVES[save]
    root = str(tmp_path / "ckpts")
    saved = four.run("torch_elastic_tasks:save_task", np_params, mesh_kw, sd_type, zero, b0, root)
    assert len({s["digest"] for s in saved}) == 1 and saved[0]["zero_active"] == zero
    assert ("model_orbax" in saved[0]["files"]) == (sd_type == "SHARDED_STATE_DICT")
    want = _jax_next_step(saved[0], b1)
    for where, kw, sdt, z in resumes:
        if where == "one":
            outs = [tasks.resume_task(np_params, kw, sdt, z, b1, root)]
            _reset_port()
        else:
            outs = (four if where == "four" else two).run(
                "torch_elastic_tasks:resume_task", np_params, kw, sdt, z, b1, root)
        for out in outs:
            assert out["resumed"] == 1 and out["resharded"], (where, out["changes"])
            assert out["digest"] == saved[0]["digest"], (save, where, kw)
            assert out["zero_active"] == z
        _check_step(saved[0], outs[0], want, f"{save} resumed on {where} {kw}")


def test_reshard_tree_cuts_and_gathers_bit_identically(worlds):
    """The JAX test's relayout on ``fsdp=4``: each rank's chunk of rows is
    the full tensor's, gathering it back gives the full tensor, and a leaf
    with no target passes through."""
    four, _ = worlds
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for r, out in enumerate(four.run("torch_elastic_tasks:reshard_task")):
        assert torch.equal(out["shard"], full[2 * r:2 * r + 2])
        assert out["spec"] == ("fsdp", None) and out["full_shape"] == (8, 6)
        assert torch.equal(out["back"], full) and out["kept"]


def test_world_growth_folds_jax_streams_for_the_new_ranks(worlds, tmp_path):
    four, two = worlds
    ckpt = str(tmp_path / "rng")
    after_save = two.run("torch_elastic_tasks:rng_save_task", ckpt, 1234)
    loaded = four.run("torch_elastic_tasks:rng_load_task", ckpt)
    for r in (0, 1):
        assert loaded[r] == after_save[r]
    for r in (2, 3):
        want = jel.fold_rng_bundle({"jax_seed": 1234}, rank=r, new_world=4, old_world=2)
        py = random.Random()
        py.setstate(want["python"])
        rs = np.random.RandomState()
        rs.set_state(want["numpy"])
        assert loaded[r] == {"python": py.random(), "numpy": float(rs.rand())}
    assert len({d["python"] for d in loaded}) == 4 and len({d["numpy"] for d in loaded}) == 4


def test_resume_across_a_global_batch_change_yields_jax_unseen_examples(worlds, tmp_path):
    four, two = worlds
    # JAX's own: global batch 16 (2 a device of 8) -> 8, after 3 steps.
    import torch.utils.data as tud

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu.utils import ProjectConfiguration

    def collate(items):
        return {"x": torch.tensor(items, dtype=torch.float32)}

    _reset_jax()
    jacc = JaxAccelerator(project_config=ProjectConfiguration(project_dir=str(tmp_path / "j")))
    it = iter(jacc.prepare(tud.DataLoader(list(range(256)), batch_size=2, collate_fn=collate)))
    for _ in range(3):
        next(it)
    jacc.save_state(str(tmp_path / "j" / "ckpt"), step=3)
    _reset_jax()
    jacc = JaxAccelerator(project_config=ProjectConfiguration(project_dir=str(tmp_path / "jb")))
    dl = jacc.prepare(tud.DataLoader(list(range(256)), batch_size=1, collate_fn=collate))
    jacc.resume_from_latest(str(tmp_path / "j"))
    want = [int(v) for b in jacc.skip_first_batches(dl, jacc.last_resume_info.skip_batches)
            for v in np.asarray(b["x"]).reshape(-1)]
    _reset_jax()

    root = str(tmp_path / "t")
    saved = four.run("torch_elastic_tasks:loader_save_task", root, 4, 3)
    assert saved[0]["global_batch"] == 16
    outs = two.run("torch_elastic_tasks:loader_resume_task", root, 4)
    assert [o["skip"] for o in outs] == [6, 6] and outs[0]["global_batch"] == 8
    rest = [v for b0, b1 in zip(outs[0]["rest"], outs[1]["rest"]) for v in b0 + b1]
    assert rest == want == list(range(48, 256))
    seen = sorted(v for s in saved for v in s["seen"])
    assert sorted(seen + rest) == list(range(256))


def test_resume_refuses_a_non_divisible_batch_geometry_before_loading(tmp_path):
    import torch.utils.data as tud

    from accelerate_tpu_torch import Accelerator, FunctionalModel
    from accelerate_tpu_torch.utils import ProjectConfiguration

    def build(batch_size, project_dir):
        _reset_port()
        acc = Accelerator(cpu=True, project_config=ProjectConfiguration(project_dir=project_dir))
        model = FunctionalModel(lambda p, x: {"loss": (x * p["w"]).sum()},
                                {"w": torch.full((1,), float(batch_size))})
        acc.prepare(model, tud.DataLoader(list(range(240)), batch_size=batch_size))
        return acc

    acc = build(16, str(tmp_path))
    acc.save_state(str(tmp_path / "ckpt"), step=1)
    acc2 = build(40, str(tmp_path / "b"))
    before = tel.state_digest(acc2)
    with pytest.raises(tel.ElasticTopologyError, match="not a whole number") as err:
        acc2.resume_from_latest(str(tmp_path))
    assert str(err.value) == str(pytest.raises(jel.ElasticTopologyError, jel.recompute_skip_batches,
                                               1, 16, 40).value)
    assert tel.state_digest(acc2) == before and acc2.last_resume_info is None
    _reset_port()


@pytest.mark.slow
def test_the_chaos_campaign_passes_on_the_cpu(tmp_path):
    """The training chaos campaign at ``--seed 0`` (JAX's plan and recipe):
    4 lives of 8, 8, 4 and 2 ranks after an 8-rank reference run, the JAX
    package's five assertions and the goodput ledger.  Slow (about a minute
    of worlds of up to 8 processes), as JAX marks its subprocess oracle."""
    out = str(tmp_path / "summary.json")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.resilience.chaos",
                           "--seed", "0", "--device", "cpu", "--workdir", str(tmp_path / "w"),
                           "--json", out], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-5000:]
    with open(out) as f:
        summary = json.load(f)
    plan = [dataclasses.asdict(c) for c in jchaos.plan_campaign(0)]
    assert summary["cycles"] == plan and summary["final_step"] == 10
    assert summary["resumes"] >= 3 and summary["topology_changes"] >= 2
