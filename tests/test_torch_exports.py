"""Names the JAX package exports, importable from the port at the same
paths (``accelerate_tpu_torch``, ``.utils``, ``.pipeline``,
``.resilience``, ``.serving``, ``.state``): the 19 that were ported in
submodules only, and those this slice adds.  Each is imported from both
packages; a class in one is a class in the other.  Exact: no tolerance."""

import importlib
import json
import subprocess
import sys
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

SUBMODULE_ONLY = {  # ported before, importable from a submodule only
    "": ["set_seed", "DataLoaderConfiguration", "ProjectConfiguration",
         "GradientAccumulationPlugin", "GradientState", "prepare_data_loader",
         "skip_first_batches", "DataLoaderShard", "make_train_step", "TrainStep",
         "DevicePrefetcher", "PreemptionGuard", "verify_checkpoint", "find_latest_complete",
         "CheckpointVerificationError", "ServingEngine", "ServingConfig", "AdmissionRejected",
         "ServingJournal"],
    ".utils": ["set_seed", "DataLoaderConfiguration", "ProjectConfiguration",
               "GradientAccumulationPlugin"],
    ".pipeline": ["make_train_step", "TrainStep", "DevicePrefetcher"],
    ".resilience": ["PreemptionGuard", "verify_checkpoint", "find_latest_complete",
                    "CheckpointVerificationError"],
}
THIS_SLICE = {
    "": ["Accelerator", "PreparedModel", "PartialState", "AcceleratorState", "DistributedType",
         "MixedPrecisionPolicy", "AutocastKwargs", "ProfileKwargs", "GradScalerKwargs",
         "DistributedDataParallelKwargs", "DistributedInitKwargs", "InitProcessGroupKwargs",
         "DDPCommunicationHookType"],
    ".state": ["PartialState", "AcceleratorState", "GradientState", "is_initialized"],
    ".utils": ["MixedPrecisionPolicy", "DistributedType", "PrecisionType",
               "KwargsHandler", "AutocastKwargs", "ProfileKwargs", "GradScalerKwargs",
               "DistributedDataParallelKwargs", "DistributedInitKwargs", "FP8RecipeKwargs",
               "TensorInformation", "gather", "gather_object", "broadcast",
               "broadcast_object_list", "reduce", "pad_across_processes", "pad_input_tensors",
               "concatenate", "slice_tensors", "convert_to_fp32", "ConvertOutputsToFp32",
               "convert_outputs_to_fp32", "get_data_structure", "initialize_tensors", "listify",
               "find_batch_size", "ignorant_find_batch_size", "recursively_apply",
               "send_to_device", "honor_type", "DistributedOperationException",
               "extract_model_from_parallel", "save"],
    ".utils.operations": ["verify_operation"],
    ".utils.other": ["extract_model_from_parallel", "save"],
}
HF_IO = {  # the llama family's HF import and export
    ".models.hf_import": ["config_from_hf", "import_state_dict", "from_hf",
                          "load_hf_checkpoint"],
    ".models.hf_export": ["export_state_dict", "export_hf_checkpoint"],
}


def _cases(table):
    return [(path, name) for path, names in table.items() for name in names]


def _pair(path, name):
    import accelerate_tpu  # noqa: F401  (the JAX side, loaded in the test only)

    jax_obj = getattr(importlib.import_module("accelerate_tpu" + path), name)
    namespace = {}
    exec(f"from accelerate_tpu_torch{path} import {name} as obj", namespace)
    return jax_obj, namespace["obj"]


@pytest.mark.parametrize("path,name", _cases(SUBMODULE_ONLY),
                         ids=lambda v: v if v else "top")
def test_names_ported_in_submodules_import_at_jax_paths(path, name):
    jax_obj, port_obj = _pair(path, name)
    assert isinstance(port_obj, type) == isinstance(jax_obj, type) and callable(port_obj)


@pytest.mark.parametrize("path,name", _cases(THIS_SLICE), ids=lambda v: v if v else "top")
def test_names_of_this_slice_import_at_jax_paths(path, name):
    jax_obj, port_obj = _pair(path, name)
    assert isinstance(port_obj, type) == isinstance(jax_obj, type) and callable(port_obj)
    assert port_obj.__module__.startswith("accelerate_tpu_torch")


@pytest.mark.parametrize("path,name", _cases(HF_IO), ids=lambda v: v)
def test_hf_import_and_export_names_import_at_jax_paths(path, name):
    jax_obj, port_obj = _pair(path, name)
    assert callable(jax_obj) and callable(port_obj)
    assert port_obj.__module__ == "accelerate_tpu_torch" + path


def test_the_examples_imports_resolve():
    """``examples/nlp_example.py``'s two imports, with the port's name."""
    from accelerate_tpu_torch import Accelerator  # noqa: F401
    from accelerate_tpu_torch.utils import set_seed  # noqa: F401


def test_lazy_names_stay_off_the_import_path():
    """``import accelerate_tpu_torch`` loads neither JAX nor the serving
    engine; reading a lazy name loads its module."""
    script = ("import json, sys, accelerate_tpu_torch as t\n"
              "before = sorted(m for m in sys.modules if m.startswith(('jax', "
              "'accelerate_tpu_torch.serving')))\n"
              "t.ServingEngine\n"
              "print(json.dumps([before, 'accelerate_tpu_torch.serving.engine' in sys.modules]))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [[], True]
    with pytest.raises(AttributeError):
        importlib.import_module("accelerate_tpu_torch").no_such_name
