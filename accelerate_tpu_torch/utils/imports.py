"""Availability detectors: the ``is_*_available`` matrix of the JAX
package's ``accelerate_tpu/utils/imports.py`` for the port.

The library probes are the same import probes (a spec is found; nothing is
imported).  The detectors that ask JAX about the device answer for this
process in torch terms and import no JAX: there is no TPU
(``is_tpu_available`` is False, ``is_cpu_mesh_simulation`` False), and the
precision and CUDA questions are answered by ``torch.cuda``.  Each such
answer is stated in its docstring.
"""

from __future__ import annotations

import functools
import importlib.metadata
import importlib.util

import torch

__all__ = [
    "is_available",
    "is_torch_available",
    "is_flax_available",
    "is_optax_available",
    "is_orbax_available",
    "is_transformers_available",
    "is_datasets_available",
    "is_safetensors_available",
    "is_tensorboard_available",
    "is_wandb_available",
    "is_mlflow_available",
    "is_comet_ml_available",
    "is_aim_available",
    "is_clearml_available",
    "is_dvclive_available",
    "is_swanlab_available",
    "is_trackio_available",
    "is_tqdm_available",
    "is_rich_available",
    "is_pandas_available",
    "is_tpu_available",
    "is_cpu_mesh_simulation",
    "is_pytest_available",
    "is_einops_available",
    "check_cuda_fp8_capability",
    "torchao_required",
    "is_grain_available",
    # The reference detector matrix: torch-ecosystem libraries probed,
    # accelerator-vendor backends answered by torch for this process.
    "is_bf16_available",
    "is_fp16_available",
    "is_fp8_available",
    "is_cuda_available",
    "is_multi_gpu_available",
    "is_mps_available",
    "is_npu_available",
    "is_mlu_available",
    "is_musa_available",
    "is_sdaa_available",
    "is_xpu_available",
    "is_hpu_available",
    "is_habana_gaudi1",
    "is_ccl_available",
    "is_xccl_available",
    "is_ipex_available",
    "is_pynvml_available",
    "is_triton_available",
    "is_torch_xla_available",
    "is_deepspeed_available",
    "is_megatron_lm_available",
    "is_msamp_available",
    "is_transformer_engine_available",
    "is_torchao_available",
    "is_bnb_available",
    "is_4bit_bnb_available",
    "is_8bit_bnb_available",
    "is_bitsandbytes_multi_backend_available",
    "is_boto3_available",
    "is_sagemaker_available",
    "is_peft_available",
    "is_peft_model",
    "is_timm_available",
    "is_torchvision_available",
    "is_torchdata_available",
    "is_torchdata_stateful_dataloader_available",
    "is_matplotlib_available",
    "is_lomo_available",
    "is_schedulefree_available",
    "is_pippy_available",
    "is_import_timer_available",
    "is_weights_only_available",
]


@functools.lru_cache(maxsize=None)
def is_available(name: str) -> bool:
    """True when ``import name`` would succeed (spec found, not imported)."""
    try:
        return importlib.util.find_spec(name) is not None
    except (ModuleNotFoundError, ValueError):
        return False


def _package_version(name: str) -> str | None:
    try:
        return importlib.metadata.version(name)
    except importlib.metadata.PackageNotFoundError:
        return None


def is_torch_available() -> bool:
    """True: the port runs on torch."""
    return True


def is_flax_available() -> bool:
    return is_available("flax")


def is_optax_available() -> bool:
    return is_available("optax")


def is_orbax_available() -> bool:
    return is_available("orbax")


def is_transformers_available() -> bool:
    return is_available("transformers")


def is_datasets_available() -> bool:
    return is_available("datasets")


def is_safetensors_available() -> bool:
    return is_available("safetensors")


def is_tensorboard_available() -> bool:
    return is_available("tensorboard") or is_available("tensorboardX")


def is_wandb_available() -> bool:
    return is_available("wandb")


def is_mlflow_available() -> bool:
    return is_available("mlflow")


def is_comet_ml_available() -> bool:
    return is_available("comet_ml")


def is_aim_available() -> bool:
    return is_available("aim")


def is_clearml_available() -> bool:
    return is_available("clearml")


def is_dvclive_available() -> bool:
    return is_available("dvclive")


def is_swanlab_available() -> bool:
    return is_available("swanlab")


def is_trackio_available() -> bool:
    return is_available("trackio")


def is_tqdm_available() -> bool:
    return is_available("tqdm")


def is_rich_available() -> bool:
    return is_available("rich")


def is_pandas_available() -> bool:
    return is_available("pandas")


def is_einops_available() -> bool:
    return is_available("einops")


def is_grain_available() -> bool:
    return is_available("grain")


def is_pytest_available() -> bool:
    return is_available("pytest")


def is_tpu_available() -> bool:
    """False: this process runs on CUDA devices or the CPU through torch,
    never on a TPU (the JAX package asks ``jax.default_backend()``)."""
    return False


def is_cpu_mesh_simulation() -> bool:
    """False: the port builds no virtual multi-device CPU mesh (the JAX
    package's ``XLA_FLAGS`` device count has no torch counterpart); several
    CPU processes over gloo play its part."""
    return False


# ---------------------------------------------------------------------------
# The reference detector matrix.  Precision detectors answer for the CUDA
# device torch sees (or the CPU); torch-backend detectors ask torch; library
# detectors are plain import probes.
# ---------------------------------------------------------------------------


def is_bf16_available(ignore_tpu: bool = False) -> bool:
    """On a CUDA device, whether it computes bf16
    (``torch.cuda.is_bf16_supported()``: Ampere and later); without one,
    True (torch computes bf16 on the CPU).  ``ignore_tpu`` is kept for the
    JAX surface: there is no TPU to ignore."""
    if torch.cuda.is_available():
        return bool(torch.cuda.is_bf16_supported())
    return True


def is_fp16_available() -> bool:
    """True on a CUDA device (its tensor cores compute fp16 and every kernel
    of the port takes it), False without one.  ``mixed_precision="fp16"``
    computes in bf16 either way, as in the JAX package."""
    return torch.cuda.is_available()


def is_fp8_available() -> bool:
    """Whether the CUDA device computes float8 e4m3/e5m2 (compute capability
    8.9 or later, :func:`check_cuda_fp8_capability`).  The port's fp8 paths
    (``mixed_precision="fp8"``, ``LlamaConfig.fp8``) raise until ROADMAP A8
    whatever this says."""
    return check_cuda_fp8_capability()


def _torch_backend_available(probe) -> bool:
    try:
        return bool(probe())
    except (AttributeError, RuntimeError):
        return False


def is_cuda_available() -> bool:
    return torch.cuda.is_available()


def is_multi_gpu_available() -> bool:
    return torch.cuda.device_count() > 1


def is_mps_available(min_version: str | None = None) -> bool:
    return _torch_backend_available(lambda: torch.backends.mps.is_available())


def is_npu_available(check_device: bool = False) -> bool:
    return is_available("torch_npu")


def is_mlu_available(check_device: bool = False) -> bool:
    return is_available("torch_mlu")


def is_musa_available(check_device: bool = False) -> bool:
    return is_available("torch_musa")


def is_sdaa_available(check_device: bool = False) -> bool:
    return is_available("torch_sdaa")


def is_xpu_available(check_device: bool = False) -> bool:
    return _torch_backend_available(lambda: torch.xpu.is_available())


def is_hpu_available(init_hccl: bool = False) -> bool:
    return is_available("habana_frameworks")


def is_habana_gaudi1() -> bool:
    return False


def is_ccl_available() -> bool:
    return is_available("oneccl_bindings_for_pytorch") or is_available("torch_ccl")


def is_xccl_available() -> bool:
    return _torch_backend_available(
        lambda: torch.distributed.distributed_c10d.is_xccl_available())


def is_ipex_available() -> bool:
    return is_available("intel_extension_for_pytorch")


def is_pynvml_available() -> bool:
    return is_available("pynvml")


def is_triton_available() -> bool:
    return is_available("triton")


def is_torch_xla_available(check_is_tpu: bool = False, check_is_gpu: bool = False) -> bool:
    """torch_xla presence (the reference's TPU path); False when asked for a
    GPU, which the port drives through CUDA, not torch_xla."""
    if check_is_gpu:
        return False
    return is_available("torch_xla")


def is_deepspeed_available() -> bool:
    return is_available("deepspeed")


def is_megatron_lm_available() -> bool:
    return is_available("megatron")


def is_msamp_available() -> bool:
    return is_available("msamp")


def is_transformer_engine_available() -> bool:
    return is_available("transformer_engine")


def is_torchao_available() -> bool:
    return is_available("torchao")


def is_bnb_available(min_version: str | None = None) -> bool:
    return is_available("bitsandbytes")


def is_4bit_bnb_available() -> bool:
    return is_bnb_available()


def is_8bit_bnb_available() -> bool:
    return is_bnb_available()


def is_bitsandbytes_multi_backend_available() -> bool:
    return is_bnb_available()


def is_boto3_available() -> bool:
    return is_available("boto3")


def is_sagemaker_available() -> bool:
    return is_available("sagemaker")


def is_peft_available() -> bool:
    return is_available("peft")


def is_peft_model(model) -> bool:
    if not is_peft_available():
        return False
    from peft import PeftModel

    from .other import extract_model_from_parallel

    return isinstance(extract_model_from_parallel(model), PeftModel)


def is_timm_available() -> bool:
    return is_available("timm")


def is_torchvision_available() -> bool:
    return is_available("torchvision")


def is_torchdata_available() -> bool:
    return is_available("torchdata")


def is_torchdata_stateful_dataloader_available() -> bool:
    if not is_torchdata_available():
        return False
    return importlib.util.find_spec("torchdata.stateful_dataloader") is not None


def is_matplotlib_available() -> bool:
    return is_available("matplotlib")


def is_lomo_available() -> bool:
    return is_available("lomo_optim")


def is_schedulefree_available() -> bool:
    return is_available("schedulefree")


def is_pippy_available() -> bool:
    """False: pipeline parallelism (``prepare_pippy``) is not ported to
    accelerate_tpu_torch yet (ROADMAP A7)."""
    return False


def is_import_timer_available() -> bool:
    return is_available("import_timer")


def is_weights_only_available() -> bool:
    """torch.load(weights_only=) support (torch >= 2.4)."""
    from .versions import is_torch_version

    return is_torch_version(">=", "2.4.0")


def check_cuda_fp8_capability() -> bool:
    """Whether the current CUDA device's compute capability is 8.9 or later
    (Ada, Hopper: float8 tensor cores); False without CUDA."""
    if not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability() >= (8, 9)


def torchao_required(func):
    """Decorator (reference ``utils/ao.py``): guard to torchao availability."""
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if not is_torchao_available():
            raise ImportError("torchao is required for this function but is not installed")
        return func(*args, **kwargs)

    return wrapper
