"""The port's memory helpers (``accelerate_tpu_torch/utils/memory.py`` and
its ``memory_utils`` alias) against the JAX package's.

The same decorated functions run under both ``find_executable_batch_size``s:
the batch sizes tried, the result, the warnings and the errors are equal.
The port also takes a ``torch.cuda.OutOfMemoryError`` built by hand (its
message names no OOM phrase) by type.  Exact: no tolerance."""

import logging

import pytest
import torch

from accelerate_tpu.utils import memory as jmem
from accelerate_tpu_torch.utils import memory as tmem

MODS = {"port": tmem, "jax": jmem}


class FakeOOM(RuntimeError):
    def __init__(self):
        super().__init__("RESOURCE_EXHAUSTED: Out of memory allocating 1234 bytes")


def _halving(mod, fit, error=FakeOOM, start=128):
    sizes = []

    @mod.find_executable_batch_size(starting_batch_size=start)
    def run(batch_size, offset=0):
        sizes.append(batch_size)
        if batch_size > fit:
            raise error()
        return batch_size + offset

    return run, sizes


@pytest.mark.parametrize("fit", [128, 16, 1])
def test_halving_matches_jax(fit, caplog):
    got = {}
    for name, mod in MODS.items():
        run, sizes = _halving(mod, fit)
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            result = run()
        warnings = [r.getMessage() for r in caplog.records if "retrying" in r.getMessage()]
        got[name] = (result, sizes, warnings)
    assert got["port"] == got["jax"]
    assert got["port"][1][-1] == fit and len(got["port"][2]) == len(got["port"][1]) - 1


def test_a_hand_built_cuda_oom_is_caught_by_type():
    def oom():
        return torch.cuda.OutOfMemoryError("allocator gave up")

    assert tmem.should_reduce_batch_size(oom())
    assert not jmem.should_reduce_batch_size(oom())  # JAX reads the message only
    run, sizes = _halving(tmem, 32, error=oom)
    assert run() == 32 and sizes == [128, 64, 32]


def test_the_size_is_reset_on_each_outer_call():
    for mod in MODS.values():
        run, sizes = _halving(mod, 16)
        assert run() == 16 and run(offset=1) == 17
        assert sizes == [128, 64, 32, 16, 128, 64, 32, 16]


def test_zero_first_argument_and_other_errors_match_jax():
    for mod in MODS.values():
        run, _ = _halving(mod, 0, start=4)
        with pytest.raises(RuntimeError, match="No executable batch size found, reached zero."):
            run()

        @mod.find_executable_batch_size(starting_batch_size=8)
        def add(batch_size, x):
            return batch_size + x

        assert add(1) == 9
        with pytest.raises(TypeError, match="as the first argument"):
            add(1, 2)

        @mod.find_executable_batch_size(starting_batch_size=8)
        def broken(batch_size):
            raise ValueError("shape mismatch in layer")

        with pytest.raises(ValueError, match="shape mismatch in layer"):
            broken()


@pytest.mark.parametrize("text,want", [
    ("RESOURCE_EXHAUSTED: ...", True), ("CUDA out of memory. Tried to allocate", True),
    ("OOM when allocating", True), ("Attempting to allocate 3 GiB", True),
    ("shape mismatch", False), ("", False)])
def test_should_reduce_batch_size_matches_jax(text, want):
    for mod in MODS.values():
        assert mod.should_reduce_batch_size(RuntimeError(text)) is want


def test_release_memory_and_the_alias():
    a, b = torch.zeros(3), object()
    assert tmem.release_memory(a, b) == [None, None] == jmem.release_memory(object(), object())
    tmem.clear_device_cache()
    with pytest.warns(FutureWarning, match="accelerate_tpu_torch.utils.memory"):
        import importlib

        import accelerate_tpu_torch.memory_utils as alias

        importlib.reload(alias)
    assert alias.find_executable_batch_size is tmem.find_executable_batch_size
    assert sorted(tmem.__all__) == sorted(jmem.__all__)
