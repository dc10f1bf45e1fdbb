"""The port's environment, version, import-probe, constants and logging
helpers, and ``LocalSGD``, against the JAX package's.

Each helper runs with the same inputs in both packages and gives the same
answer, except the detectors whose JAX answers ask JAX about the TPU: the
port answers those for this process from torch (no TPU, and on this CPU
host no CUDA), as their docstrings state.  Exact: no tolerance."""

import logging
import os

import pytest
import torch

from accelerate_tpu import logging as jlogging
from accelerate_tpu.utils import constants as jconstants
from accelerate_tpu.utils import environment as jenv
from accelerate_tpu.utils import imports as jimports
from accelerate_tpu.utils import versions as jversions
from accelerate_tpu_torch import Accelerator, AcceleratorState, LocalSGD
from accelerate_tpu_torch import logging as tlogging
from accelerate_tpu_torch.utils import constants as tconstants
from accelerate_tpu_torch.utils import environment as tenv
from accelerate_tpu_torch.utils import imports as timports
from accelerate_tpu_torch.utils import versions as tversions

# The detectors whose JAX answer comes from JAX's view of the device, with
# the port's answer in torch terms on a host without CUDA.
TORCH_ANSWERS = {"is_tpu_available": False, "is_cpu_mesh_simulation": False,
                 "is_bf16_available": True, "is_fp16_available": False,
                 "is_fp8_available": False, "is_pippy_available": False}


@pytest.fixture(autouse=True)
def _reset_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    yield
    AcceleratorState._reset_state(reset_partial_state=True)


def test_constants_are_a_copy():
    names = [n for n in dir(jconstants) if n.isupper()]
    assert names == [n for n in dir(tconstants) if n.isupper()]
    for n in names:
        assert getattr(tconstants, n) == getattr(jconstants, n), n


@pytest.mark.parametrize("value", ["y", "Yes", "TRUE", "on", "1", "n", "No", "false", "OFF",
                                   "0", "maybe"])
def test_str_to_bool_matches_jax(value):
    outs = []
    for mod in (tenv, jenv):
        try:
            outs.append(mod.str_to_bool(value))
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]


def test_env_parsers_and_patches_match_jax(monkeypatch):
    monkeypatch.setenv("ATPU_T_FLAG", "yes")
    monkeypatch.setenv("ATPU_T_NEG", "-1")
    monkeypatch.setenv("ATPU_T_INT", "7")
    monkeypatch.setenv("ACCELERATE_T_KEEP", "kept")
    for mod in (tenv, jenv):
        assert mod.parse_flag_from_env("ATPU_T_FLAG") is True
        assert mod.parse_flag_from_env("ATPU_T_UNSET", default=False) is False
        assert mod.parse_choice_from_env("ATPU_T_UNSET", "bf16") == "bf16"
        assert mod.get_int_from_env(["ATPU_T_NEG", "ATPU_T_INT"], 3) == 7
        assert mod.get_int_from_env(["ATPU_T_UNSET"], 3) == 3
        assert mod.are_libraries_initialized("torch", "no_such_lib") == ["torch"]
        with mod.patch_environment(atpu_t_patch=5, atpu_t_flag="no"):
            assert os.environ["ATPU_T_PATCH"] == "5" and os.environ["ATPU_T_FLAG"] == "no"
        assert "ATPU_T_PATCH" not in os.environ and os.environ["ATPU_T_FLAG"] == "yes"
        with mod.clear_environment():
            assert dict(os.environ) == {}
        assert os.environ["ATPU_T_INT"] == "7"

        @mod.purge_accelerate_environment
        def leak():
            os.environ["ACCELERATE_T_NEW"] = "1"
            os.environ["ACCELERATE_T_KEEP"] = "changed"

        leak()
        assert "ACCELERATE_T_NEW" not in os.environ
        assert os.environ["ACCELERATE_T_KEEP"] == "kept"
    env = {"A": "1", "B": "x y", "C": "ok;rm", "": "v", "D": ""}
    with pytest.warns(UserWarning):
        got = tenv.convert_dict_to_env_variables(env)
    with pytest.warns(UserWarning):
        assert got == jenv.convert_dict_to_env_variables(env) == ["A=1\n"]


def test_device_helpers_answer_from_torch():
    names, count = tenv.get_gpu_info()
    assert count == torch.cuda.device_count() and len(names) == count
    assert tenv.check_cuda_p2p_ib_support() is True
    assert tenv.set_numa_affinity(0) is None
    for fn in (tenv.install_xla, tenv.get_ccl_version):
        with pytest.raises(NotImplementedError, match="A9"):
            fn()
    assert sorted(n for n in jenv.__all__) == sorted(
        n for n in tenv.__all__ if n in jenv.__all__)


@pytest.mark.parametrize("a,op,b", [
    ("0.4.0rc1", ">", "0.4.0"), ("0.4.0", ">", "0.4.0rc1"), ("1.2", "==", "1.2.0"),
    ("v1.2.3", ">=", "1.2"), ("1.2.3.post1", ">=", "1.2.3"), ("0.4.0rc2", ">", "0.4.0rc1"),
    ("numpy", ">=", "1.0"), ("torch", "<", "1.0")])
def test_compare_versions_matches_jax(a, op, b):
    assert tversions.compare_versions(a, op, b) == jversions.compare_versions(a, op, b)


def test_version_helpers_match_jax():
    with pytest.raises(ValueError, match="operation"):
        tversions.compare_versions("1.0", "~=", "1.0")
    assert tversions.is_torch_version(">=", "2.0") == jversions.is_torch_version(">=", "2.0")
    for op, v in ((">=", "0.4"), ("<", "0.4"), ("==", "99.0")):
        assert tversions.is_jax_version(op, v) == jversions.is_jax_version(op, v)


def test_the_detector_matrix_matches_jax():
    assert set(jimports.__all__) <= set(timports.__all__)
    for name in jimports.__all__:
        if name in ("is_available", "is_peft_model"):
            continue
        got = getattr(timports, name)()
        want = TORCH_ANSWERS.get(name, getattr(jimports, name)())
        assert got == want, name
    for lib in ("torch", "numpy", "no_such_lib"):
        assert timports.is_available(lib) == jimports.is_available(lib)
    assert timports.check_cuda_fp8_capability() is False


def test_get_logger_matches_jax(caplog):
    """Before any state every call logs; under one process's state both
    ``main_process_only`` settings and ``in_order`` log once each."""
    for name, mod in (("t_port", tlogging), ("t_jax", jlogging)):
        logger = mod.get_logger(f"atpu_{name}", log_level="INFO")
        assert isinstance(logger, logging.LoggerAdapter)
        assert logging.getLogger(f"atpu_{name}").level == logging.INFO
        with caplog.at_level(logging.INFO, logger=f"atpu_{name}"):
            caplog.clear()
            logger.info("main", main_process_only=True)
            logger.info("all", main_process_only=False)
            logger.warning_once("once")
            logger.warning_once("once")
            assert [r.getMessage() for r in caplog.records] == ["main", "all", "once"]
    Accelerator(cpu=True)
    logger = tlogging.get_logger("atpu_t_state")
    with caplog.at_level(logging.INFO, logger="atpu_t_state"):
        caplog.clear()
        logger.info("main")
        logger.info("ordered", in_order=True)
        assert [r.getMessage() for r in caplog.records] == ["main", "ordered"]


def test_local_sgd_is_a_no_op_at_one_process():
    acc = Accelerator(cpu=True)
    model = torch.nn.Linear(3, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with LocalSGD(accelerator=acc, model=model, local_sgd_steps=2) as lsgd:
        assert lsgd.enabled is False
        for _ in range(5):
            lsgd.step()
    assert lsgd.num_steps == 5
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert LocalSGD(acc, model, enabled=False).enabled is False
