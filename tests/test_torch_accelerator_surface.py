"""The single-process ``Accelerator`` surface of the port (``state.py``,
``utils/operations.py``, ``utils/other.py``, the process properties and
methods, and the keyword arguments of the checkpoint and preemption
methods) against the JAX ``Accelerator`` at one process, on the CPU.

Tolerance: values are compared exactly (no arithmetic runs, apart from
``reduce``'s ``scale``, which both packages apply as one multiply; the JAX
package returns numpy from ``reduce``, ``broadcast`` and
``pad_across_processes``, ROADMAP C, so values are compared, not types).
The JAX accelerators run on the suite's 8-device CPU mesh, where
``split_batches=True`` makes its loader's batches one GPU's batches (the
mesh also makes its ``distributed_type`` ``TPU_JAX`` and ``use_distributed``
True: device parallelism, not processes, so those two are held against
one process's values instead).
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch
from torch.utils.data import DataLoader

import accelerate_tpu
import accelerate_tpu.utils.operations as jops
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.resilience import manifest as jmanifest
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.utils import DataLoaderConfiguration as JaxDataLoaderConfiguration
from accelerate_tpu.utils import ProfileKwargs as JaxProfileKwargs
from accelerate_tpu.utils import ProjectConfiguration as JaxProjectConfiguration
from accelerate_tpu_torch import Accelerator, AcceleratorState, PartialState
from accelerate_tpu_torch.resilience.manifest import CheckpointVerificationError
from accelerate_tpu_torch.utils import operations as ops
from accelerate_tpu_torch.utils.dataclasses import (
    AutocastKwargs,
    DataLoaderConfiguration,
    DistributedDataParallelKwargs,
    DistributedInitKwargs,
    DistributedType,
    GradScalerKwargs,
    ProfileKwargs,
    ProjectConfiguration,
)


@pytest.fixture(scope="module", autouse=True)
def _restore_jax_global_mesh():
    """Put back the global mesh this module found (a JAX ``Accelerator``
    installs its own), so later modules see the context they would alone."""
    before = jax.sharding.get_mesh()
    yield
    jax.set_mesh(before)


@pytest.fixture(autouse=True)
def _reset_port_state():
    """The port's shared state outlives a test, as the JAX package's does
    (its conftest resets that one)."""
    AcceleratorState._reset_state(reset_partial_state=True)
    yield
    AcceleratorState._reset_state(reset_partial_state=True)


def _both(**kw):
    return JaxAccelerator(**kw), Accelerator(cpu=True, **kw)


def _objects(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    data = [{"x": torch.full((3,), float(i)), "y": torch.zeros(2)} for i in range(16)]
    return model, opt, DataLoader(data, batch_size=4)


def _values(x):
    if isinstance(x, (list, tuple)):
        return [_values(v) for v in x]
    if isinstance(x, dict):
        return {k: _values(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy().tolist()
    x = np.asarray(x)
    return (x.astype(np.float32) if x.dtype.name == "bfloat16" else x).tolist()


# -- the process ---------------------------------------------------------------

@pytest.mark.parametrize("prop", [
    "num_processes", "process_index", "local_process_index", "is_main_process",
    "is_local_main_process", "is_last_process", "mixed_precision", "split_batches",
    "even_batches", "use_seedable_sampler", "use_stateful_dataloader", "non_blocking",
    "dispatch_batches", "logging_dir", "optimizer_step_was_skipped", "fp8_backend",
    "gradient_accumulation_steps", "sync_gradients", "project_dir",
])
def test_process_properties_match_jax(prop, tmp_path):
    jacc, acc = _both(project_dir=str(tmp_path), mixed_precision="bf16")
    assert getattr(acc, prop) == getattr(jacc, prop)


def test_one_process_distributed_type():
    acc = Accelerator(cpu=True)
    assert acc.distributed_type == DistributedType.NO == "NO"
    assert acc.use_distributed is False and acc.state.device == torch.device("cpu")
    assert JaxAccelerator().num_processes == acc.num_processes == 1


def test_even_batches_setter_and_logging_dir(tmp_path):
    for a in _both(project_config=None, project_dir=str(tmp_path)):
        a.even_batches = False
        assert a.even_batches is False and a.dataloader_config.even_batches is False
        assert a.logging_dir == str(tmp_path)
    assert ProjectConfiguration(project_dir="p", logging_dir="l").logging_dir == "l"


def test_print_prints_once(capsys):
    for a in _both():
        a.print("hello", 3)
    assert capsys.readouterr().out == "hello 3\nhello 3\n"


@pytest.mark.parametrize("decorator", [
    ("on_main_process", {}), ("on_local_main_process", {}), ("on_last_process", None),
    ("on_process", {"process_index": 0}), ("on_process", {}),
    ("on_local_process", {"local_process_index": 0}),
], ids=lambda d: f"{d[0]}{'_' + '_'.join(d[1]) if d[1] else ''}")
def test_process_decorators_run_at_one_process(decorator):
    name, kw = decorator
    for a in _both():
        calls = []
        fn = getattr(a, name)(lambda x: calls.append(x) or x, **kw) if kw is not None else \
            getattr(a, name)(lambda x: calls.append(x) or x)
        assert fn(5) == 5 and calls == [5]
        if kw == {}:  # the bare decorator form, then the call
            deco = getattr(a, name)()
            assert deco(lambda: "ran")() == "ran"


def test_barriers_and_first_contexts():
    for a in _both():
        order = []
        with a.main_process_first():
            order.append("main")
        with a.local_main_process_first():
            order.append("local")
        a.wait_for_everyone()
        assert order == ["main", "local"]


@pytest.mark.parametrize("apply_padding", [False, True])
@pytest.mark.parametrize("kind", ["list", "tuple", "dict", "tensor"])
def test_split_between_processes_matches_jax(kind, apply_padding):
    inputs = {"list": [1, 2, 3, 4, 5], "tuple": ("a", "b", "c"),
              "dict": {"x": [1, 2, 3], "y": [4, 5, 6]}, "tensor": torch.arange(7)}[kind]
    jacc, acc = _both()
    with jacc.split_between_processes(inputs, apply_padding=apply_padding) as want:
        pass
    with acc.split_between_processes(inputs, apply_padding=apply_padding) as got:
        pass
    assert _values(got) == _values(want)


# -- collectives and metrics -------------------------------------------------

def _rows(n=37, batch=8):
    return DataLoader([{"x": torch.tensor([i, 10 * i])} for i in range(n)], batch_size=batch)


@pytest.mark.parametrize("mode", ["tensor", "object"])
def test_gather_for_metrics_drops_nothing_it_should_keep(mode):
    """37 rows at batch 8: every row once in both packages."""
    jacc = JaxAccelerator(dataloader_config=JaxDataLoaderConfiguration(split_batches=True))
    acc = Accelerator(cpu=True)
    out = []
    for a in (jacc, acc):
        rows = []
        for batch in a.prepare(_rows()):
            if mode == "tensor":
                rows.append(_values(a.gather_for_metrics(batch["x"])))
            else:
                rows.append([_values(v) for v in a.gather_for_metrics(
                    list(batch["x"]), use_gather_object=True)])
        out.append([r for b in rows for r in b])
    assert out[0] == out[1] == [[i, 10 * i] for i in range(37)]


def test_gather_for_metrics_drops_a_static_tail():
    """The port's ``static_shape_tail`` fills the last batch to 8 rows from
    the epoch's start; gathering drops the fill again."""
    acc = Accelerator(cpu=True, dataloader_config=DataLoaderConfiguration(static_shape_tail=True))
    batches = [acc.gather_for_metrics(b["x"]) for b in acc.prepare(_rows())]
    assert batches[-1].shape[0] == 5 and sum(b.shape[0] for b in batches) == 37


@pytest.mark.parametrize("reduction,scale", [("sum", 1.0), ("mean", 1.0), ("sum", 0.5),
                                             ("mean", 3.0)])
def test_reduce_matches_jax(reduction, scale):
    t = {"a": torch.tensor([1.0, 2.5, -3.0]), "b": [torch.tensor(4.0)]}
    jacc, acc = _both()
    want = jacc.reduce(t, reduction=reduction, scale=scale)
    got = acc.reduce(t, reduction=reduction, scale=scale)
    assert _values(got) == _values(want)
    assert isinstance(got["a"], torch.Tensor) and got["a"] is not t["a"]


@pytest.mark.parametrize("pad_first", [False, True])
def test_pad_across_processes_and_gather_match_jax(pad_first):
    t = [torch.arange(6).reshape(2, 3), {"m": torch.ones(1, 4)}]
    jacc, acc = _both()
    assert _values(acc.pad_across_processes(t, dim=1, pad_index=-1, pad_first=pad_first)) == \
        _values(jacc.pad_across_processes(t, dim=1, pad_index=-1, pad_first=pad_first))
    assert _values(acc.gather(t)) == _values(jacc.gather(t))


def test_trigger_and_sync_flags_match_jax():
    for a in _both():
        assert a.check_trigger() is False
        a.set_trigger()
        assert a.check_trigger() is True and a.check_trigger() is False
        assert a.sync_gradients is True
        with a.no_sync():
            assert a.sync_gradients is False
            a.trigger_sync_in_backward(None)
            assert a.sync_gradients is True
        assert a.sync_gradients is True
        with a.no_sync():
            pass
        assert a.sync_gradients is True
        with a.autocast():
            pass
        a.unscale_gradients()


def test_join_uneven_inputs_runs_the_block():
    acc = Accelerator(cpu=True)
    with acc.join_uneven_inputs([], even_batches=False):
        ran = True
    assert ran and acc.even_batches is True


def test_free_memory_returns_nones_and_forgets_prepared():
    jacc, acc = _both()
    for a in (jacc, acc):
        model, opt, dl = a.prepare(*_objects())
        assert a.free_memory(model, opt, dl) == [None, None, None]
        assert a.clear() == []
        assert a._models == a._optimizers == a._dataloaders == []


def test_unwrap_model_returns_the_module():
    model = torch.nn.Linear(3, 2)
    acc = Accelerator(cpu=True)
    assert acc.unwrap_model(acc.prepare(model)) is model
    compiled = torch.nn.Module()
    compiled._orig_mod = torch.nn.DataParallel(model)
    assert acc.unwrap_model(compiled, keep_torch_compile=False) is model
    assert acc.unwrap_model(compiled) is compiled and compiled._orig_mod is model


@pytest.mark.parametrize("safe", [False, True])
def test_save_writes_on_the_main_process(tmp_path, safe):
    obj = {"w": torch.arange(4.0), "b": torch.ones(2)}
    paths = []
    for a, name in zip(_both(), ("jax", "port")):
        paths.append(tmp_path / f"{name}.bin")
        a.save(obj, paths[-1], safe_serialization=safe)
    if safe:
        from safetensors.numpy import load_file

        assert [_values(load_file(str(p))) for p in paths] == [_values(obj)] * 2
    else:
        assert [_values(torch.load(p)) for p in paths] == [_values(obj)] * 2


def test_profile_writes_a_chrome_trace_per_process(tmp_path):
    acc = Accelerator(cpu=True, kwargs_handlers=[ProfileKwargs(output_trace_dir=str(tmp_path))])
    with acc.profile() as prof:
        torch.ones(8).sum()
    assert prof is not None
    files = os.listdir(tmp_path / "profile_0")
    assert len(files) == 1 and files[0].endswith(".json")
    assert "traceEvents" in json.load(open(tmp_path / "profile_0" / files[0]))
    with acc.profile(ProfileKwargs(activities=["cpu"], schedule_option={"wait": 0, "warmup": 0,
                                                                        "active": 1})) as prof:
        prof.step()
    assert os.listdir(tmp_path) == ["profile_0"]


# -- constructor ---------------------------------------------------------------

def test_kwargs_handlers_route_to_jax_slots():
    handlers = [AutocastKwargs(), ProfileKwargs(), GradScalerKwargs(),
                DistributedDataParallelKwargs(comm_hook="bf16"), DistributedInitKwargs()]
    acc = Accelerator(cpu=True, kwargs_handlers=handlers)
    jh = [getattr(accelerate_tpu.utils, type(h).__name__)(**h.to_dict()) for h in handlers]
    jacc = JaxAccelerator(kwargs_handlers=jh)
    for slot in ("autocast_handler", "profile_handler", "scaler_handler", "ddp_handler",
                 "init_handler", "fp8_recipe_handler"):
        got, want = getattr(acc, slot), getattr(jacc, slot)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.to_dict() == want.to_dict() and type(got).__name__ == type(want).__name__
    assert acc.ddp_handler.to_kwargs() == jacc.ddp_handler.to_kwargs() == {"comm_hook": "bf16"}


@pytest.mark.parametrize("bad", ["twice", "unrouted", "not_a_handler"])
def test_kwargs_handlers_errors_match_jax(bad):
    def handlers(pkg):
        return {"twice": [pkg.AutocastKwargs(), pkg.AutocastKwargs()],
                "unrouted": [pkg.GradientAccumulationPlugin()],
                "not_a_handler": [object()]}[bad]

    import accelerate_tpu_torch.utils as port_utils

    with pytest.raises(ValueError) as want:
        JaxAccelerator(kwargs_handlers=handlers(accelerate_tpu.utils))
    with pytest.raises(ValueError) as got:
        Accelerator(cpu=True, kwargs_handlers=handlers(port_utils))
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0]


def test_handlers_that_validate_match_jax():
    for pkg in (accelerate_tpu.utils, __import__("accelerate_tpu_torch.utils").utils):
        with pytest.raises(ValueError):
            pkg.DistributedDataParallelKwargs(comm_hook="power_sgd")
        assert pkg.GradientAccumulationPlugin(num_steps=3).to_kwargs() == {"num_steps": 3}
    assert ProfileKwargs().to_dict() == JaxProfileKwargs().to_dict()


def test_trackers_and_fp8_raise_until_ported(tmp_path):
    """Trackers are ported: ``log_with`` builds one in ``init_trackers``
    (an unknown name raises there, as in JAX); fp8 still raises (A8)."""
    from accelerate_tpu_torch.tracking import GenericTracker
    from accelerate_tpu_torch.utils import FP8RecipeKwargs

    with pytest.raises(NotImplementedError, match="A8"):
        Accelerator(cpu=True, mixed_precision="fp8")
    with pytest.raises(NotImplementedError, match="A8"):
        FP8RecipeKwargs()
    acc = Accelerator(cpu=True, log_with="generic", project_dir=str(tmp_path))
    assert acc.log_with == ["generic"] and acc.trackers == []
    acc.init_trackers("run")
    assert [type(t) for t in acc.trackers] == [GenericTracker]
    with pytest.raises(ValueError, match="Unknown tracker jsonl"):
        Accelerator(cpu=True, log_with="jsonl").init_trackers("run")
    acc = Accelerator(cpu=True, log_with=None, rng_types=["torch"], device_placement=True)
    assert acc.log_with == acc.trackers == [] and acc.rng_types == ["torch"]


def test_state_reinit_conflict_matches_jax():
    JaxAccelerator(mixed_precision="bf16")
    Accelerator(cpu=True, mixed_precision="bf16")
    with pytest.raises(ValueError) as want:
        JaxAccelerator(mixed_precision="no")
    with pytest.raises(ValueError) as got:
        Accelerator(cpu=True, mixed_precision="no")
    assert str(got.value) == str(want.value)
    assert Accelerator(cpu=True).mixed_precision == "bf16"  # None takes the state's mode
    AcceleratorState._reset_state()
    JaxAcceleratorState._reset_state()
    assert Accelerator(cpu=True, mixed_precision="no").mixed_precision == "no"


def test_device_is_the_states_and_another_device_raises():
    """One source of truth for the device: ``Accelerator.device`` is the
    shared state's, and an ``Accelerator`` that names another device than a
    live process state raises, also after ``AcceleratorState._reset_state()``
    (which keeps that state).  ``meta`` stands for a second device here."""
    acc = Accelerator(cpu=True)
    assert acc.device == acc.state.device == PartialState().device == torch.device("cpu")
    assert Accelerator(device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="already initialized on cpu"):
        Accelerator(device="meta")
    AcceleratorState._reset_state()
    with pytest.raises(ValueError, match="already initialized on cpu"):
        Accelerator(device="meta")
    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator(device="meta")
    assert acc.device == acc.state.device == torch.device("meta")
    with pytest.raises(ValueError, match="already initialized on meta"):
        Accelerator(cpu=True)


def test_stale_state_handle_and_env_mode(monkeypatch):
    state = AcceleratorState(cpu=True)
    AcceleratorState._reset_state(reset_partial_state=True)
    with pytest.raises(AttributeError, match="_reset_state"):
        state.mixed_precision
    with pytest.raises(AttributeError, match="_reset_state"):
        PartialState.__new__(PartialState).device
    monkeypatch.setenv("ACCELERATE_MIXED_PRECISION", "fp16")
    state = AcceleratorState(cpu=True)
    assert state.mixed_precision == "fp16" and state.dtype_policy.compute_dtype == torch.bfloat16


def test_no_cpu_flag_places_on_the_card_or_raises():
    """``Accelerator()`` places on ``cuda``; without CUDA it raises, and so
    does a bare ``PartialState()``: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        assert Accelerator(mixed_precision="bf16").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Accelerator(mixed_precision="bf16")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PartialState()
    assert not AcceleratorState._shared_state and not PartialState._shared_state


def test_several_processes_raise_until_ported(monkeypatch):
    """Several processes are ported: ``WORLD_SIZE=2`` starts a process group,
    which needs a coordinator to meet at (none here), and leaves no state
    behind when it cannot."""
    for key in ("MASTER_ADDR", "ACCELERATE_COORDINATOR_ADDRESS", "ACCELERATE_NUM_PROCESSES"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="no coordinator"):
        Accelerator(cpu=True)
    assert not AcceleratorState._shared_state and not PartialState._shared_state


# -- operations ----------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6.0).reshape(3, 2), "b": (torch.tensor([1, 2, 3]),
                                                        torch.ones(3, dtype=torch.bfloat16))}


@pytest.mark.parametrize("name", [
    "gather", "broadcast", "listify", "convert_to_fp32", "find_batch_size",
    "ignorant_find_batch_size", "slice_tensors", "pad_input_tensors", "concatenate",
    "gather_object", "broadcast_object_list",
])
def test_operations_match_jax(name):
    args = {"slice_tensors": (_tree(), slice(1, 3)), "pad_input_tensors": (_tree(), 3, 2),
            "concatenate": ([_tree(), _tree()],), "gather_object": ([{"x": 1}, "y"],),
            "broadcast_object_list": ([{"x": 1}, 2],)}.get(name, (_tree(),))
    want = getattr(jops, name)(*args)
    got = getattr(ops, name)(*args)
    if name == "convert_to_fp32":
        assert got["b"][1].dtype == torch.float32 and got["b"][0].dtype == torch.int64
        want = jops.convert_to_fp32(_values(_tree()))
    assert _values(got) == _values(want)


def test_structure_helpers_and_fp32_wrapper():
    info = ops.get_data_structure(_tree())
    assert info["a"].shape == torch.Size([3, 2]) and info["b"][1].dtype == torch.bfloat16
    zeros = ops.initialize_tensors(info)
    assert _values(zeros) == _values(jops.initialize_tensors(jops.get_data_structure(_tree())))
    assert ops.ignorant_find_batch_size(["no tensor"]) is None
    fwd = ops.convert_outputs_to_fp32(lambda x: {"y": x.to(torch.bfloat16)})
    assert fwd(torch.ones(2))["y"].dtype == torch.float32
    with pytest.raises(pickle.PicklingError):
        pickle.dumps(ops.ConvertOutputsToFp32(len))
    with pytest.raises(TypeError):
        ops.gather({"n": 3})
    with pytest.raises(ValueError):
        ops.reduce(torch.ones(1), reduction="max")
    assert issubclass(ops.DistributedOperationException, Exception)
    assert ops.verify_operation(lambda t: t + 1)(1) == 2


# -- keyword arguments of the checkpoint and preemption methods (C8) ------------

def _prepared_pair(tmp_path):
    jacc = JaxAccelerator(project_config=JaxProjectConfiguration(project_dir=str(tmp_path / "j")))
    jacc.prepare(*_objects())
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=str(tmp_path / "p")))
    acc.prepare(*_objects())
    return jacc, acc


def test_save_state_unverified_writes_in_place_without_manifest(tmp_path):
    jacc, acc = _prepared_pair(tmp_path)
    dirs = [a.save_state(str(tmp_path / n / "ckpt"), verified=False)
            for a, n in ((jacc, "j"), (acc, "p"))]
    for d in dirs:
        names = set(os.listdir(d))
        assert "manifest.json" not in names and "model.safetensors" in names
        assert not os.path.exists(f"{d}.tmp")
    # in place over a verified checkpoint: the stale manifest goes too
    d = acc.save_state(str(tmp_path / "p" / "ckpt2"))
    assert "manifest.json" in os.listdir(d)
    acc.save_state(d, verified=False)
    assert "manifest.json" not in os.listdir(d)
    acc.load_state(d)
    # automatic naming rotates unverified saves by index, as JAX does
    for a, n in ((jacc, "j"), (acc, "p")):
        cfg = a.project_configuration
        cfg.automatic_checkpoint_naming, cfg.total_limit, cfg.iteration = True, 2, 0
        for _ in range(3):
            a.save_state(verified=False)
        assert sorted(os.listdir(tmp_path / n / "checkpoints")) == ["checkpoint_1",
                                                                     "checkpoint_2"]


def _corrupt_manifest(d):
    path = os.path.join(d, "manifest.json")
    m = json.load(open(path))
    m["files"]["model.safetensors"]["sha256"] = "0" * 64
    json.dump(m, open(path, "w"))


def test_load_state_verify_false_loads_a_corrupt_manifest(tmp_path):
    jacc, acc = _prepared_pair(tmp_path)
    jd = jacc.save_state(str(tmp_path / "j" / "ckpt"))
    pd = acc.save_state(str(tmp_path / "p" / "ckpt"))
    for d in (jd, pd):
        _corrupt_manifest(d)
    with pytest.raises(jmanifest.CheckpointVerificationError):
        jacc.load_state(jd)
    with pytest.raises(CheckpointVerificationError):
        acc.load_state(pd)
    jacc.load_state(jd, verify=False)
    assert acc.load_state(pd, verify=False) == pd


def test_resume_from_latest_verify_false(tmp_path):
    jacc, acc = _prepared_pair(tmp_path)
    jacc.save_state(str(tmp_path / "j" / "checkpoints" / "checkpoint_0"), step=7)
    acc.save_state(str(tmp_path / "p" / "checkpoints" / "checkpoint_0"), step=7)
    for a, n in ((jacc, "j"), (acc, "p")):
        _corrupt_manifest(str(tmp_path / n / "checkpoints" / "checkpoint_0"))
        assert a.resume_from_latest(verify=False) == 7


@pytest.mark.parametrize("safe", [True, False])
def test_save_model_safe_serialization(tmp_path, safe):
    jacc, acc = _prepared_pair(tmp_path)
    jpath = jacc.save_model(jacc._models[0], str(tmp_path / "jm"), safe_serialization=safe)
    ppath = acc.save_model(acc._models[0], str(tmp_path / "pm"), safe_serialization=safe)
    assert os.path.basename(jpath) == os.path.basename(ppath) == \
        ("model.safetensors" if safe else "model.pkl")
    if safe:
        from safetensors.numpy import load_file

        want, got = load_file(jpath), load_file(ppath)
    else:
        want, got = pickle.load(open(jpath, "rb")), torch.load(ppath)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_values(got[k]), _values(want[k]), rtol=0, atol=0)


@pytest.mark.parametrize("unwrap", [True, False])
def test_get_state_dict_unwrap(tmp_path, unwrap):
    jacc, acc = _prepared_pair(tmp_path)
    want = jacc.get_state_dict(jacc._models[0], unwrap=unwrap)
    got = acc.get_state_dict(acc._models[0], unwrap=unwrap)
    assert sorted(got) == sorted(want)
    assert all(_values(got[k]) == _values(want[k]) for k in want)


def test_enable_preemption_handling_coordinated(tmp_path):
    jacc, acc = _prepared_pair(tmp_path)
    for a in (jacc, acc):
        guard = a.enable_preemption_handling(str(tmp_path / "pre"), coordinated=False)
        guard.uninstall()
    # Coordinated at one process: the agreement is over a world of one.
    guard = Accelerator(cpu=True).enable_preemption_handling(str(tmp_path), coordinated=True)
    try:
        assert guard._coordination_on() and not guard.should_stop()
    finally:
        guard.uninstall()


@pytest.mark.parametrize("device_specific", [False, True])
def test_set_seed_keywords_match_jax(device_specific):
    from accelerate_tpu.utils import set_seed as jax_set_seed
    from accelerate_tpu_torch.utils import set_seed

    draws = []
    for fn in (jax_set_seed, set_seed):
        fn(11, device_specific=device_specific)
        draws.append((torch.rand(3).tolist(), np.random.rand(2).tolist()))
    assert draws[0] == draws[1]
    try:
        set_seed(11, deterministic=True)
        assert torch.are_deterministic_algorithms_enabled()
    finally:
        torch.use_deterministic_algorithms(False)
    jax_set_seed(11, deterministic=True)


def test_optimizer_step_closure():
    """The port runs the closure on a sync step and returns its loss
    (torch's contract); the JAX optimizer accepts one and ignores it."""
    jacc, acc = _both(gradient_accumulation_steps=2)
    jmodel, jopt, _ = jacc.prepare(*_objects())
    jopt.step(closure=lambda: pytest.fail("the JAX optimizer ignores the closure"))
    model, opt, _ = acc.prepare(*_objects())
    x = torch.ones(4, 3)
    calls = []

    def closure():
        calls.append(torch.is_grad_enabled())
        opt.optimizer.zero_grad()
        loss = model(x).square().mean()
        loss.backward()
        return loss

    before = model.weight.detach().clone()
    with acc.accumulate(model):  # micro-batch 1 of 2: no step, no closure
        assert opt.step(closure) is None and calls == [] and acc.optimizer_step_was_skipped
    with acc.accumulate(model), torch.no_grad():
        loss = opt.step(closure)
    assert calls == [True] and float(loss) > 0 and not acc.optimizer_step_was_skipped
    assert not torch.equal(model.weight, before)
