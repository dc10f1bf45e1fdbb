"""File-name and enum-string constants: a copy of the JAX package's
``accelerate_tpu/utils/constants.py`` (the port imports nothing of it).

The torch-format names (``MODEL_NAME``/``WEIGHTS_NAME``: pickle ``.bin``)
and the ``SAFE_*`` safetensors names are the ones both packages' checkpoint
directories use, so the two agree on file names.
"""

import operator as op

SCALER_NAME = "scaler.pt"
MODEL_NAME = "pytorch_model"
SAFE_MODEL_NAME = "model"
RNG_STATE_NAME = "random_states"
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
SAMPLER_NAME = "sampler"
PROFILE_PATTERN_NAME = "profile_{suffix}.json"
WEIGHTS_NAME = f"{MODEL_NAME}.bin"
WEIGHTS_PATTERN_NAME = "pytorch_model{suffix}.bin"
WEIGHTS_INDEX_NAME = f"{WEIGHTS_NAME}.index.json"
SAFE_WEIGHTS_NAME = f"{SAFE_MODEL_NAME}.safetensors"
SAFE_WEIGHTS_PATTERN_NAME = "model{suffix}.safetensors"
SAFE_WEIGHTS_INDEX_NAME = f"{SAFE_WEIGHTS_NAME}.index.json"

# Strategy-string vocabularies (the env-var contract speaks these).
FSDP_SHARDING_STRATEGY = ["FULL_SHARD", "SHARD_GRAD_OP", "NO_SHARD", "HYBRID_SHARD", "HYBRID_SHARD_ZERO2"]
FSDP_AUTO_WRAP_POLICY = ["TRANSFORMER_BASED_WRAP", "SIZE_BASED_WRAP", "NO_WRAP"]
FSDP_BACKWARD_PREFETCH = ["BACKWARD_PRE", "BACKWARD_POST", "NO_PREFETCH"]
FSDP_STATE_DICT_TYPE = ["FULL_STATE_DICT", "LOCAL_STATE_DICT", "SHARDED_STATE_DICT"]
FSDP2_STATE_DICT_TYPE = ["SHARDED_STATE_DICT", "FULL_STATE_DICT"]
FSDP_MODEL_NAME = "pytorch_model_fsdp"
DEEPSPEED_MULTINODE_LAUNCHERS = ["pdsh", "standard", "openmpi", "mvapich", "mpich", "nossh", "slurm"]
TORCH_DYNAMO_MODES = ["default", "reduce-overhead", "max-autotune"]

STR_OPERATION_TO_FUNC = {">": op.gt, ">=": op.ge, "==": op.eq, "!=": op.ne, "<=": op.le, "<": op.lt}

# torchrun passthrough flag names (reference ``TORCH_LAUNCH_PARAMS``) — our
# launcher accepts-and-maps or rejects these by name, so the vocabulary stays.
TORCH_LAUNCH_PARAMS = [
    "nnodes", "nproc_per_node", "rdzv_backend", "rdzv_endpoint", "rdzv_id",
    "rdzv_conf", "standalone", "max_restarts", "monitor_interval",
    "start_method", "role", "module", "m", "no_python", "run_path", "log_dir",
    "r", "redirects", "t", "tee", "node_rank", "master_addr", "master_port",
]

CUDA_DISTRIBUTED_TYPES = ["DEEPSPEED", "MULTI_GPU", "FSDP", "MEGATRON_LM", "TP"]
TORCH_DISTRIBUTED_OPERATION_TYPES = CUDA_DISTRIBUTED_TYPES + [
    "MULTI_NPU", "MULTI_MLU", "MULTI_SDAA", "MULTI_MUSA", "MULTI_XPU",
    "MULTI_CPU", "MULTI_HPU",
]

# Version gates of the torch features the names refer to, kept for the
# config-compat code paths that consult them.
FSDP_PYTORCH_VERSION = "2.1.0"
FSDP2_PYTORCH_VERSION = "2.6.0"
XPU_PROFILING_AVAILABLE_PYTORCH_VERSION = "2.4.0"
MITA_PROFILING_AVAILABLE_PYTORCH_VERSION = "2.1.0"
BETA_TP_AVAILABLE_PYTORCH_VERSION = "2.3.0"
BETA_TP_AVAILABLE_TRANSFORMERS_VERSION = "4.52.0"
ELASTIC_LOG_LINE_PREFIX_TEMPLATE_PYTORCH_VERSION = "2.2.0"
