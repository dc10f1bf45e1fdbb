"""Four of the repo's ``examples/by_feature`` scripts on the port, against
the same scripts on the JAX package, as ``test_torch_nlp_example.py``
twins ``nlp_example``.

Each script is loaded twice.  The JAX twin runs it as written, its
``Accelerator`` given ``split_batches=True`` through a subclass (the suite's
8-device mesh makes a loader's ``batch_size`` per data shard; one GPU's
batches are wanted).  The port twin rebinds the script's imported names
(``Accelerator``, ``set_seed``, ``find_executable_batch_size``,
``LocalSGD``) to the port's, so the same code drives it.  One epoch, on the
CPU, ``mixed_precision=None``.

- ``tracking.py`` (``log_with="all"``): both packages' backend probes are
  narrowed to the JSONL tracker, so "all" builds it in each; the JSONL rows
  are equal but for ``_time`` (the train loss within 1e-5).
- ``memory.py`` and ``automatic_gradient_accumulation.py``: the examples'
  data loaders raise an out-of-memory error above batch 8 (a
  ``torch.cuda.OutOfMemoryError`` whose message the JAX helper also
  recognises), so both ``find_executable_batch_size``s halve: the sizes
  tried (and accumulation steps) are equal.
- ``local_sgd.py``: one process, so ``LocalSGD`` is a no-op in both.

Every twin's accuracy is equal and its final fp32 weights within 1e-4 of
the JAX twin's (``test_torch_nlp_example.py``'s tolerance: the frameworks
sum each gradient in another order)."""

import argparse
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils.data import DataLoader

import accelerate_tpu
import accelerate_tpu_torch
from accelerate_tpu import tracking as jtracking
from accelerate_tpu.utils import DataLoaderConfiguration as JaxDataLoaderConfiguration
from accelerate_tpu_torch import AcceleratorState
from accelerate_tpu_torch import tracking as ttracking

BY_FEATURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "examples", "by_feature")
CONFIG = {"lr": 2e-3, "num_epochs": 1, "seed": 42, "batch_size": 16}
# The examples' synthetic paraphrase data (nlp_example.make_dataset), cut
# from 512/128 rows to keep the JAX twins quick.
TRAIN_ROWS, EVAL_ROWS = 192, 64


@pytest.fixture(scope="module", autouse=True)
def _restore_jax_global_mesh():
    before = jax.sharding.get_mesh()
    yield
    jax.set_mesh(before)


@pytest.fixture(autouse=True)
def _reset_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    yield
    AcceleratorState._reset_state(reset_partial_state=True)


def _load(script):
    sys.path.insert(0, BY_FEATURE)
    try:
        spec = importlib.util.spec_from_file_location(f"twin_{script[:-3]}",
                                                      os.path.join(BY_FEATURE, script))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(BY_FEATURE)
    return mod


def _twins(script, monkeypatch, oom_above=None):
    """The script loaded as its JAX twin and its port twin; each twin's
    accelerators land in ``made[name]``."""
    made = {"jax": [], "port": []}

    class JaxOneGpuBatches(accelerate_tpu.Accelerator):
        def __init__(self, **kw):
            super().__init__(dataloader_config=JaxDataLoaderConfiguration(split_batches=True),
                             **kw)
            made["jax"].append(self)

    class Port(accelerate_tpu_torch.Accelerator):
        def __init__(self, **kw):
            super().__init__(**kw)
            made["port"].append(self)

    class JaxOneGpuBatchesRecorded(JaxOneGpuBatches):
        def prepare(self, *objs, **kw):
            out = super().prepare(*objs, **kw)
            made["jax_model"] = out[0]
            return out

    class PortRecorded(Port):
        def prepare(self, *objs, **kw):
            out = super().prepare(*objs, **kw)
            made["port_model"] = self.unwrap_model(out[0])
            return out

    jax_mod, port_mod = _load(script), _load(script)
    monkeypatch.setattr(jax_mod, "Accelerator", JaxOneGpuBatchesRecorded)
    port_names = {"Accelerator": PortRecorded, "set_seed": accelerate_tpu_torch.utils.set_seed,
                  "find_executable_batch_size": accelerate_tpu_torch.find_executable_batch_size,
                  "LocalSGD": accelerate_tpu_torch.LocalSGD}
    for name, obj in port_names.items():
        if hasattr(port_mod, name):
            monkeypatch.setattr(port_mod, name, obj)
    for mod in (jax_mod, port_mod):
        nlp = mod.nlp

        def loaders(accelerator, batch_size, nlp=nlp):
            if oom_above is not None and batch_size > oom_above:
                raise torch.cuda.OutOfMemoryError(
                    f"CUDA out of memory. Tried to allocate a batch of {batch_size}")
            return (DataLoader(nlp.make_dataset(TRAIN_ROWS, seed=0), shuffle=True,
                               collate_fn=nlp.collate, batch_size=batch_size),
                    DataLoader(nlp.make_dataset(EVAL_ROWS, seed=1), shuffle=False,
                               collate_fn=nlp.collate, batch_size=nlp.EVAL_BATCH_SIZE))

        monkeypatch.setattr(nlp, "get_dataloaders", loaders)
    return jax_mod, port_mod, made


def _weights_match(made):
    jw = {k: np.asarray(v) for k, v in made["jax_model"].state_dict().items()}
    pw = made["port_model"].state_dict()
    assert sorted(jw) == sorted(pw)
    for k, v in pw.items():
        np.testing.assert_allclose(v.numpy(), jw[k], rtol=0, atol=1e-4, err_msg=k)


def _run(mod, args, capsys):
    acc = mod.training_function(dict(CONFIG), args)
    return acc, capsys.readouterr().out


def test_tracking_twin_matches_jax(monkeypatch, capsys, tmp_path):
    for mod in (ttracking, jtracking):
        monkeypatch.setattr(mod, "_TRACKER_AVAILABLE", {"generic": lambda: True})
    jax_mod, port_mod, made = _twins("tracking.py", monkeypatch)
    rows = {}
    for name, mod in (("jax", jax_mod), ("port", port_mod)):
        args = argparse.Namespace(mixed_precision=None, cpu=True, with_tracking=True,
                                  project_dir=str(tmp_path / name))
        acc, out = _run(mod, args, capsys)
        assert out.count(f"epoch 0: accuracy {acc:.3f}") == 1
        path = made[name][-1].get_tracker("generic", unwrap=True)
        assert path == str(tmp_path / name / "nlp_example_tracking" / "metrics.jsonl")
        with open(path) as f:
            rows[name] = [json.loads(line) for line in f]
        with open(os.path.join(os.path.dirname(path), "config.json")) as f:
            assert json.load(f) == CONFIG
        rows[name + "_acc"] = acc
    assert rows["port_acc"] == rows["jax_acc"] > 0.8
    assert len(rows["port"]) == len(rows["jax"]) == 1
    got, want = rows["port"][0], rows["jax"][0]
    assert sorted(got) == sorted(want) == ["_step", "_time", "accuracy", "epoch", "train_loss"]
    assert {k: got[k] for k in ("_step", "accuracy", "epoch")} == \
        {k: want[k] for k in ("_step", "accuracy", "epoch")} == \
        {"_step": TRAIN_ROWS // 16, "accuracy": rows["port_acc"], "epoch": 0}
    assert got["train_loss"] == pytest.approx(want["train_loss"], abs=1e-5)
    _weights_match(made)


def test_memory_twin_halves_as_jax_does(monkeypatch, capsys):
    jax_mod, port_mod, made = _twins("memory.py", monkeypatch, oom_above=8)
    args = argparse.Namespace(mixed_precision=None, cpu=True, num_epochs=1)
    want, jax_out = _run(jax_mod, args, capsys)
    got, port_out = _run(port_mod, args, capsys)
    assert got == want > 0.8
    assert "batch sizes tried: [16, 8]" in port_out and "batch sizes tried: [16, 8]" in jax_out
    assert port_out.count("(batch 8)") == jax_out.count("(batch 8)") == 1
    _weights_match(made)


def test_automatic_gradient_accumulation_twin_matches_jax(monkeypatch, capsys):
    jax_mod, port_mod, made = _twins("automatic_gradient_accumulation.py", monkeypatch,
                                     oom_above=8)
    args = argparse.Namespace(mixed_precision=None, cpu=True, target_batch_size=32,
                              num_epochs=1)
    want, jax_out = _run(jax_mod, args, capsys)
    got, port_out = _run(port_mod, args, capsys)
    tried = "(batch_size, accumulation_steps) tried: [(32, 1), (16, 2), (8, 4)]"
    assert tried in port_out and tried in jax_out
    assert got == want > 0.7
    assert len(made["port"]) == len(made["jax"]) == 3
    assert made["port"][-1].gradient_accumulation_steps == 4
    _weights_match(made)


def test_local_sgd_twin_matches_jax(monkeypatch, capsys):
    jax_mod, port_mod, made = _twins("local_sgd.py", monkeypatch)
    args = argparse.Namespace(mixed_precision=None, cpu=True, gradient_accumulation_steps=2,
                              local_sgd_steps=4, num_epochs=1)
    want, _ = _run(jax_mod, args, capsys)
    got, _ = _run(port_mod, args, capsys)
    assert got == want > 0.7
    _weights_match(made)
