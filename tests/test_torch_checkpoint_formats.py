"""The port's checkpoint formats across processes, the cases of the JAX
package's ``tests/test_checkpoint_formats.py``: on ``fsdp=2`` (a 2-process
gloo world, ``torch_dp_world``; tasks in ``torch_elastic_tasks``) the
plugin's ``SHARDED_STATE_DICT`` writes each rank's shards under
``model_orbax`` (the JAX directory name; the port's own format inside) and
its pre-hooks see an empty weights list with no gather, ``FULL_STATE_DICT``
stays one safetensors file, ``LOCAL_STATE_DICT`` round-trips on its own
layout and is refused on another layout and another process count, an
asynchronous sharded save keeps the state of the moment it returned, and
``merge_fsdp_weights`` assembles the shards.  In this process: the
asynchronous save's join publishes, a failed write re-raises there with
nothing published, and parameters and optimizer state changed in place
right after ``save_state(async_save=True)`` returns do not reach the
files.  Exact: no tolerance."""

import os
import threading

import pytest
import torch

from accelerate_tpu_torch import Accelerator, AcceleratorState, FunctionalModel
from accelerate_tpu_torch.resilience import find_latest_complete, verify_checkpoint
from accelerate_tpu_torch.resilience.elastic import state_digest
from accelerate_tpu_torch.utils import ProjectConfiguration
from torch_dp_world import World


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, tmp_path_factory.mktemp("formats_world2"), threads=1)
    yield w
    w.close()


@pytest.fixture(scope="module")
def saved(world, tmp_path_factory):
    """The three state-dict types saved and reloaded on fsdp=2."""
    root = str(tmp_path_factory.mktemp("formats"))
    return root, {kind: world.run("torch_elastic_tasks:formats_task", root, kind)
                  for kind in ("SHARDED_STATE_DICT", "FULL_STATE_DICT", "LOCAL_STATE_DICT")}


def test_fsdp_sharded_state_dict_writes_each_ranks_shards(saved):
    _, outs = saved
    for out in outs["SHARDED_STATE_DICT"]:
        assert "model_orbax" in out["files"] and "model.safetensors" not in out["files"]
        assert out["dirs"]["model_orbax"] == ["rank0.index.json", "rank0.safetensors",
                                              "rank1.index.json", "rank1.safetensors"]
        assert "optimizer.bin" in out["files"]  # the optimizer state stays gathered
        assert out["same"]
        # The pre-hooks see an empty weights list, and nothing is gathered for them.
        assert out["hook_weights"] == 0 and out["gathers"] == 0


def test_fsdp_full_state_dict_stays_safetensors(saved):
    _, outs = saved
    for out in outs["FULL_STATE_DICT"]:
        assert "model.safetensors" in out["files"] and "model_orbax" not in out["files"]
        assert out["same"] and out["hook_weights"] == 1


def test_fsdp_local_state_dict_round_trip_and_refusals(world, saved):
    root, outs = saved
    for out in outs["LOCAL_STATE_DICT"]:
        assert out["dirs"]["model_local"] == ["local_rank0.bin", "local_rank1.bin"]
        assert "model.safetensors" not in out["files"] and out["same"]
    # Another layout on the same two processes: every leaf replicated.
    refused = world.run("torch_elastic_tasks:local_refusal_task", root)
    assert all("LOCAL_STATE_DICT shard layout mismatch" in r for r in refused), refused
    # Another process count: this one process.
    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator(cpu=True)
    model = FunctionalModel(lambda p, x: {"loss": (x @ p["w"]).sum()},
                            {"w": torch.zeros(8, 6), "b": torch.zeros(6)})
    acc.prepare(model)
    with pytest.raises(RuntimeError, match="topology mismatch: saved with 2 processes"):
        acc.load_state(os.path.join(root, "local_state_dict"))
    AcceleratorState._reset_state(reset_partial_state=True)


def test_merge_fsdp_weights_assembles_the_shards(saved, tmp_path):
    from accelerate_tpu_torch.checkpointing import read_safetensors_state_dict
    from accelerate_tpu_torch.utils import merge_fsdp_weights

    root, outs = saved
    merge_fsdp_weights(os.path.join(root, "sharded_state_dict"), str(tmp_path / "merged"))
    merged = read_safetensors_state_dict(str(tmp_path / "merged"))
    full = outs["SHARDED_STATE_DICT"][0]["full"]
    assert set(merged) == set(full)
    for k, v in full.items():
        assert torch.equal(merged[k], v), k


def test_async_sharded_save_keeps_the_state_it_returned_with(world, tmp_path):
    for out in world.run("torch_elastic_tasks:async_sharded_task", str(tmp_path)):
        assert out == {"changed": True, "restored": True, "published": True}


# -- the asynchronous save in one process --------------------------------------------------


def _toy(project_dir):
    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=project_dir, automatic_checkpoint_naming=True))
    g = torch.Generator().manual_seed(0)
    model = FunctionalModel(lambda p, x: {"loss": torch.tanh(x @ p["w"]).sum()},
                            {"w": torch.randn(16, 8, generator=g)})
    model, opt = acc.prepare(model, torch.optim.Adam(model.parameters(), lr=1e-2))
    step = acc.make_train_step(model, opt)
    step({"x": torch.randn(4, 16, generator=g)})
    return acc, model, opt


@pytest.fixture
def slow_writer(monkeypatch):
    """The background write waits until the test releases it."""
    from accelerate_tpu_torch import checkpointing

    gate = threading.Event()
    original = checkpointing._write_files

    def gated(*args, **kwargs):
        gate.wait(30)
        return original(*args, **kwargs)

    monkeypatch.setattr(checkpointing, "_write_files", gated)
    yield gate
    gate.set()


def test_async_save_publishes_at_the_join(tmp_path, slow_writer):
    acc, model, opt = _toy(str(tmp_path))
    base = str(tmp_path / "checkpoints")
    final = acc.save_state(step=1, async_save=True)
    assert acc.last_save_timing["blocking_s"] >= acc.last_save_timing["d2h_s"]
    assert find_latest_complete(base) is None and os.path.isdir(final + ".tmp")
    slow_writer.set()
    acc.wait_for_checkpoint()
    assert find_latest_complete(base) == final and verify_checkpoint(final)["step"] == 1
    assert acc.last_save_timing["bytes"] > 0 and "publish_s" in acc.last_save_timing
    # The next save joins a pending one first; end_training publishes the last.
    acc.save_state(step=2, async_save=True)
    acc.end_training()
    assert verify_checkpoint(find_latest_complete(base))["step"] == 2


def test_async_save_failure_reraises_at_the_join_and_publishes_nothing(tmp_path, monkeypatch):
    from accelerate_tpu_torch import checkpointing

    acc, model, opt = _toy(str(tmp_path))
    good = acc.save_state(step=1)

    def broken(*args, **kwargs):
        raise OSError("disk went away")

    monkeypatch.setattr(checkpointing.safetensors_io, "save_file", broken)
    final = acc.save_state(step=2, async_save=True)
    with pytest.raises(RuntimeError, match="NOT published") as err:
        acc.wait_for_checkpoint()
    assert "disk went away" in str(err.value)
    assert not os.path.exists(final) and not os.path.exists(final + ".tmp")
    assert find_latest_complete(str(tmp_path / "checkpoints")) == good
    acc.wait_for_checkpoint()  # nothing pending any more


def test_async_snapshot_ignores_in_place_changes_after_save_returns(tmp_path, slow_writer):
    acc, model, opt = _toy(str(tmp_path))
    before = state_digest(acc)
    final = acc.save_state(step=1, async_save=True)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        for st in opt.optimizer.state.values():
            st["exp_avg"].add_(1.0)
    changed = state_digest(acc)
    slow_writer.set()
    acc.wait_for_checkpoint()
    assert changed != before
    acc.load_state(final)
    assert state_digest(acc) == before
    AcceleratorState._reset_state(reset_partial_state=True)
