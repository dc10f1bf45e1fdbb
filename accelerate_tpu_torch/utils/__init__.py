"""Helpers of the port, under the JAX package's ``accelerate_tpu.utils``
names."""

from .dataclasses import (
    AutocastKwargs,
    DataLoaderConfiguration,
    DDPCommunicationHookType,
    DistributedDataParallelKwargs,
    DistributedInitKwargs,
    DistributedType,
    FP8RecipeKwargs,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    InitProcessGroupKwargs,
    KwargsHandler,
    MixedPrecisionPolicy,
    PrecisionType,
    ProfileKwargs,
    ProjectConfiguration,
    TensorInformation,
)
from .operations import (
    ConvertOutputsToFp32,
    DistributedOperationException,
    broadcast,
    broadcast_object_list,
    concatenate,
    convert_outputs_to_fp32,
    convert_to_fp32,
    find_batch_size,
    gather,
    gather_object,
    get_data_structure,
    honor_type,
    ignorant_find_batch_size,
    initialize_tensors,
    listify,
    pad_across_processes,
    pad_input_tensors,
    recursively_apply,
    reduce,
    send_to_device,
    slice_tensors,
    verify_operation,
)
from .other import extract_model_from_parallel, save
from .random import PRNGKey, get_rng_state, set_rng_state, set_seed
