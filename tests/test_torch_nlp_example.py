"""The README's example on the port: ``chip_smoke.training_function``, the
twin of ``examples/nlp_example.py``'s (only its imports name
``accelerate_tpu_torch``), against the JAX example's own, loaded as
``tests/test_examples.py`` loads it, under ``mixed_precision=None``,
``cpu=True``, one epoch.

The JAX ``Accelerator`` runs on the suite's 8-device CPU mesh, where a
loader's ``batch_size`` is per data shard; the example's constructor gets
``split_batches=True`` added (through a subclass the example module picks
up) so its batches are one GPU's 16 rows and its scheduler's
``len(train_dataloader)`` the same 32 steps.  Both shuffle the same
permutation.  Tolerance: the accuracies equal, the final fp32 weights
within 1e-4 (measured: 3.3e-6 on the embedding table, the two frameworks
summing each gradient in another order).
"""

import argparse
import importlib.util
import os

import jax
import numpy as np
import pytest

import accelerate_tpu
import accelerate_tpu_torch
import chip_smoke
from accelerate_tpu.utils import DataLoaderConfiguration as JaxDataLoaderConfiguration
from accelerate_tpu_torch import AcceleratorState

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


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


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_nlp_example_twin_matches_jax(monkeypatch, capsys):
    mod = _load(os.path.join(EXAMPLES, "nlp_example.py"), "nlp_example")
    made = {}

    class JaxOneGpuBatches(accelerate_tpu.Accelerator):
        def __init__(self, **kw):
            super().__init__(dataloader_config=JaxDataLoaderConfiguration(split_batches=True),
                             **kw)
            made["jax"] = self

    class Port(accelerate_tpu_torch.Accelerator):
        def __init__(self, **kw):
            super().__init__(**kw)
            made["port"] = self

    monkeypatch.setattr(mod, "Accelerator", JaxOneGpuBatches)
    monkeypatch.setattr(accelerate_tpu_torch, "Accelerator", Port)
    args = argparse.Namespace(mixed_precision=None, cpu=True, num_epochs=1)
    config = {"lr": 2e-3, "num_epochs": 1, "seed": 42, "batch_size": 16}
    want = mod.training_function(config, args)
    got = chip_smoke.training_function(config, args)
    assert got == want and got > 0.8
    assert capsys.readouterr().out.count(f"epoch 0: accuracy {got:.3f}") == 2
    jw = {k: np.asarray(v) for k, v in made["jax"]._models[0].state_dict().items()}
    pw = made["port"].unwrap_model(made["port"]._models[0]).state_dict()
    assert sorted(jw) == sorted(pw)
    for k, v in pw.items():
        np.testing.assert_allclose(v.numpy(), jw[k], rtol=0, atol=1e-4, err_msg=k)


def test_nlp_example_twin_bf16_learns():
    """The twin under ``mixed_precision="bf16"`` on the CPU: JAX's learning
    threshold (``test_nlp_example_learns``), one epoch."""
    args = argparse.Namespace(mixed_precision="bf16", cpu=True, num_epochs=1)
    acc = chip_smoke.training_function({"lr": 2e-3, "num_epochs": 1, "seed": 42,
                                        "batch_size": 16}, args)
    assert acc > 0.8
