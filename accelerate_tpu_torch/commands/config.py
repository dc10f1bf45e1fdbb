"""The launch configuration: the JAX package's ``commands/config.py``.

Parity target: reference ``commands/config/`` (~1800 LoC questionnaire +
YAML): the YAML schema, the non-interactive ``default`` and the guided
questionnaire; the config file feeds ``launch`` exactly like the
reference's.  Both packages read and write the same file
(``$ACCELERATE_CONFIG_DIR``, else ``~/.cache/accelerate_tpu``).  PyYAML is
imported only where a file is read or written: a launch with no config file
needs none.
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass
from typing import Optional

DEFAULT_CONFIG_DIR = os.path.expanduser(
    os.environ.get("ACCELERATE_CONFIG_DIR", "~/.cache/accelerate_tpu")
)
DEFAULT_CONFIG_FILE = os.path.join(DEFAULT_CONFIG_DIR, "default_config.yaml")

__all__ = ["ClusterConfig", "load_config", "save_config", "config_command", "default_config_command"]


@dataclass
class ClusterConfig:
    compute_environment: str = "LOCAL_MACHINE"
    distributed_type: str = "MULTI_GPU"
    mixed_precision: str = "no"
    num_machines: int = 1
    machine_rank: int = 0
    main_process_ip: Optional[str] = None
    main_process_port: Optional[int] = None
    gradient_accumulation_steps: int = 1
    # Mesh axes (ParallelismConfig)
    dp: int = 0  # 0 = auto (all remaining devices)
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1
    use_fsdp: bool = False
    fsdp_sharding_strategy: str = "FULL_SHARD"
    fsdp_min_num_params: int = 0
    # Guided-flow FSDP fields (reference cluster.py:383-503 question set); all
    # flow to workers through the FSDP_* env contract in commands/launch.py.
    fsdp_version: Optional[int] = None
    fsdp_reshard_after_forward: Optional[bool] = None
    fsdp_cpu_offload: Optional[bool] = None
    fsdp_auto_wrap_policy: Optional[str] = None
    fsdp_transformer_layer_cls_to_wrap: Optional[str] = None
    fsdp_state_dict_type: Optional[str] = None
    fsdp_activation_checkpointing: Optional[bool] = None
    # DeepSpeed dialect (reference cluster.py:228-380): either a full
    # ds_config.json consumed at prepare time (utils/deepspeed.py; flows via
    # ACCELERATE_DEEPSPEED_CONFIG_FILE) or the guided zero-stage fields.
    use_deepspeed: Optional[bool] = None
    deepspeed_config_file: Optional[str] = None
    zero_stage: Optional[int] = None
    offload_optimizer_device: Optional[str] = None
    offload_param_device: Optional[str] = None
    gradient_clipping: Optional[float] = None
    zero3_init_flag: Optional[bool] = None
    zero3_save_16bit_model: Optional[bool] = None
    deepspeed_moe_layer_cls_names: Optional[str] = None
    # Megatron dialect (reference cluster.py:505-560): degrees map onto the
    # tp/pp mesh axes; the rest rides the MEGATRON_LM_* env contract.
    use_megatron_lm: Optional[bool] = None
    megatron_lm_tp_degree: Optional[int] = None
    megatron_lm_pp_degree: Optional[int] = None
    megatron_lm_num_micro_batches: Optional[int] = None
    megatron_lm_sequence_parallelism: Optional[bool] = None
    megatron_lm_recompute_activations: Optional[bool] = None
    megatron_lm_use_distributed_optimizer: Optional[bool] = None
    megatron_lm_gradient_clipping: Optional[float] = None
    # Dynamo (reference cluster.py:171-207).  Recorded and exported as
    # ACCELERATE_DYNAMO_*; the port's steps do not read them.
    dynamo_backend: Optional[str] = None
    dynamo_mode: Optional[str] = None
    dynamo_use_fullgraph: Optional[bool] = None
    dynamo_use_dynamic: Optional[bool] = None
    # Sequence-parallel attention implementation ("ring" | "ulysses").
    sp_impl: Optional[str] = None
    downcast_bf16: bool = False
    # Pod management (the JAX package's `accelerate-tpu tpu-config`).
    tpu_name: Optional[str] = None
    tpu_zone: Optional[str] = None

    def to_dict(self) -> dict:
        return asdict(self)


def save_config(config: ClusterConfig, path: str = DEFAULT_CONFIG_FILE) -> str:
    import yaml

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(config.to_dict(), f)
    return path


def load_config(path: Optional[str] = None) -> ClusterConfig:
    path = path or DEFAULT_CONFIG_FILE
    if not os.path.exists(path):
        return ClusterConfig()
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    known = {k: v for k, v in data.items() if k in ClusterConfig.__dataclass_fields__}
    return ClusterConfig(**known)


def _ask_field(prompt: str, default=None, cast=str, check=None, error: str = "Invalid value."):
    """Ask until ``cast`` succeeds and ``check`` (if given) passes — the
    reference questionnaire's ``_ask_field`` retry contract
    (``commands/config/config_utils.py``)."""
    suffix = f" [{default}]: " if default is not None else ": "
    while True:
        raw = input(f"{prompt}{suffix}").strip()
        if not raw:
            if default is not None:
                return default
            print(error)
            continue
        try:
            value = cast(raw)
        except (ValueError, TypeError):
            print(error)
            continue
        if check is not None and not check(value):
            print(error)
            continue
        return value


def _yes_no(prompt: str, default: bool = False) -> bool:
    from ..utils.environment import str_to_bool

    def cast(raw):
        return bool(str_to_bool(str(raw)))

    hint = "[YES/no]" if default else "[yes/NO]"
    return _ask_field(
        f"{prompt} {hint}", default=default, cast=cast, error="Please answer yes or no."
    )


def _choose(prompt: str, choices: list, default: int = 0) -> str:
    from .menu import BulletMenu

    return choices[BulletMenu(prompt, choices).run(default)]


def _machine_questions(cfg: ClusterConfig):
    cfg.num_machines = _ask_field(
        "How many machines (hosts) will you use (more than 1 for multi-host training)?",
        1, int, check=lambda v: v >= 1,
    )
    if cfg.num_machines > 1:
        cfg.machine_rank = _ask_field("What is the rank of this machine?", 0, int)
        cfg.main_process_ip = _ask_field(
            "What is the IP address of the machine that will host the main process (the "
            "process group's coordinator)?", "127.0.0.1",
        )
        cfg.main_process_port = _ask_field(
            "What is the port you will use to communicate with the main process?", 29500, int
        )
        if _yes_no("Is this a GCP TPU pod (managed with `accelerate-tpu tpu-config`)?"):
            cfg.tpu_name = _ask_field("What is the name of the TPU pod?", "tpu-pod")
            cfg.tpu_zone = _ask_field("What zone is the TPU pod in?", "us-central2-b")


def _dynamo_questions(cfg: ClusterConfig):
    if not _yes_no(
        "Do you wish to configure torch dynamo (recorded in the config; the port's "
        "steps run without torch.compile)?"
    ):
        return
    cfg.dynamo_backend = _choose(
        "Which dynamo backend would you like to use?",
        ["no", "eager", "aot_eager", "inductor", "aot_ts_nvfuser", "nvprims_nvfuser",
         "cudagraphs", "ofi", "fx2trt", "onnxrt", "tensorrt", "ipex", "tvm"],
        default=2,
    )
    if cfg.dynamo_backend != "no" and _yes_no(
        "Do you want to customize the defaults sent to torch.compile?"
    ):
        cfg.dynamo_mode = _choose(
            "Which mode do you want to use?",
            ["default", "reduce-overhead", "max-autotune"],
        )
        cfg.dynamo_use_fullgraph = _yes_no(
            "Do you want the fullgraph mode or is it ok to break the model into several subgraphs?"
        )
        cfg.dynamo_use_dynamic = _yes_no("Do you want to enable dynamic shape tracing?")


def _deepspeed_questions(cfg: ClusterConfig) -> bool:
    """Returns True when the guided flow already asked for gradient
    accumulation (so the closing question is skipped)."""
    cfg.use_deepspeed = True
    asked_accum = False
    if _yes_no("Do you want to specify a json file to a DeepSpeed config?"):
        cfg.deepspeed_config_file = _ask_field(
            "Please enter the path to the json DeepSpeed config file", "ds_config.json"
        )
    else:
        cfg.zero_stage = int(
            _choose("What should be your DeepSpeed's ZeRO optimization stage?",
                    ["0", "1", "2", "3"], default=2)
        )
        if cfg.zero_stage >= 2:
            cfg.offload_optimizer_device = _choose(
                "Where to offload optimizer states?", ["none", "cpu", "nvme"]
            )
        if cfg.zero_stage == 3:
            cfg.offload_param_device = _choose(
                "Where to offload parameters?", ["none", "cpu", "nvme"]
            )
            cfg.zero3_init_flag = _yes_no(
                "Do you want to enable deepspeed.zero.Init for constructing massive models?"
            )
            cfg.zero3_save_16bit_model = _yes_no(
                "Do you want to save 16-bit model weights when using ZeRO Stage-3?"
            )
        cfg.gradient_accumulation_steps = _ask_field(
            "How many gradient accumulation steps are you passing in your script?", 1, int
        )
        asked_accum = True
        if _yes_no("Do you want to use gradient clipping?"):
            cfg.gradient_clipping = _ask_field("What is the gradient clipping value?", 1.0, float)
    if _yes_no("Do you want to enable Mixture-of-Experts training (MoE)?"):
        cfg.deepspeed_moe_layer_cls_names = _ask_field(
            "Specify the comma-separated list of transformer MoE layer class names (case-sensitive)",
            "MixtralSparseMoeBlock",
        )
        cfg.ep = _ask_field("Expert-parallel size (ep mesh axis)?", 1, int, check=lambda v: v >= 1)
    # ZeRO stages map onto the fsdp axis (stage>=1 shards grads/opt, 3 shards params).
    if cfg.zero_stage is not None and cfg.zero_stage >= 1:
        cfg.use_fsdp = True
        cfg.fsdp = 0
        cfg.fsdp_sharding_strategy = "FULL_SHARD" if cfg.zero_stage == 3 else "SHARD_GRAD_OP"
    return asked_accum


def _fsdp_questions(cfg: ClusterConfig):
    cfg.use_fsdp = True
    cfg.fsdp_version = int(_ask_field(
        "What should be your FSDP version?", 2, int, check=lambda v: v in (1, 2),
        error="1 or 2 (both map onto the same sharding of the fsdp axis).",
    ))
    if cfg.fsdp_version == 2:
        # FSDP2 spelling (reference cluster.py:392-413): reshard_after_forward
        # REPLACES the strategy enum — asking both would let the launcher's
        # FSDP2 override silently discard the chosen enum.
        cfg.fsdp_reshard_after_forward = _yes_no(
            "Do you want to enable resharding after forward?", default=True
        )
        cfg.fsdp_sharding_strategy = (
            "FULL_SHARD" if cfg.fsdp_reshard_after_forward else "SHARD_GRAD_OP"
        )
    else:
        cfg.fsdp_sharding_strategy = _choose(
            "What should be your sharding strategy?",
            ["FULL_SHARD", "SHARD_GRAD_OP", "NO_SHARD", "HYBRID_SHARD"],
        )
    cfg.fsdp = _ask_field(
        "FSDP axis size (0 = all devices)?", 0, int, check=lambda v: v >= 0
    )
    cfg.fsdp_cpu_offload = _yes_no("Do you want to offload parameters and gradients to CPU?")
    policy = _choose(
        "What should be your auto wrap policy (which arrays stay replicated)?",
        ["TRANSFORMER_BASED_WRAP", "SIZE_BASED_WRAP", "NO_WRAP"],
    )
    cfg.fsdp_auto_wrap_policy = policy
    if policy == "TRANSFORMER_BASED_WRAP":
        cfg.fsdp_transformer_layer_cls_to_wrap = _ask_field(
            "Specify the comma-separated list of transformer layer class names to wrap",
            "LlamaDecoderLayer",
        )
    elif policy == "SIZE_BASED_WRAP":
        cfg.fsdp_min_num_params = _ask_field(
            "What should be your FSDP's minimum number of parameters for default auto wrapping?",
            100000000, int,
        )
    cfg.fsdp_state_dict_type = _choose(
        "What should be your FSDP's state dict type?",
        ["SHARDED_STATE_DICT", "FULL_STATE_DICT"],
    )
    cfg.fsdp_activation_checkpointing = _yes_no(
        "Do you want to enable FSDP activation checkpointing (remat)?"
    )


def _megatron_questions(cfg: ClusterConfig):
    cfg.use_megatron_lm = True
    cfg.megatron_lm_tp_degree = _ask_field(
        "What is the Tensor Parallelism degree/size?", 1, int, check=lambda v: v >= 1
    )
    cfg.tp = cfg.megatron_lm_tp_degree
    if cfg.megatron_lm_tp_degree > 1:
        cfg.megatron_lm_sequence_parallelism = _yes_no(
            "Do you want to enable Sequence Parallelism?", default=True
        )
        if cfg.megatron_lm_sequence_parallelism:
            cfg.sp = _ask_field("Sequence-parallel size (sp mesh axis)?", 1, int)
            cfg.sp_impl = _choose("Sequence-parallel attention?", ["ring", "ulysses"])
    cfg.megatron_lm_pp_degree = _ask_field(
        "What is the Pipeline Parallelism degree/size?", 1, int, check=lambda v: v >= 1
    )
    cfg.pp = cfg.megatron_lm_pp_degree
    if cfg.megatron_lm_pp_degree > 1:
        cfg.megatron_lm_num_micro_batches = _ask_field(
            "What is the number of micro-batches?", 1, int, check=lambda v: v >= 1
        )
    cfg.megatron_lm_recompute_activations = _yes_no(
        "Do you want to enable selective activation recomputation?", default=True
    )
    cfg.megatron_lm_use_distributed_optimizer = _yes_no(
        "Do you want to use distributed optimizer which shards optimizer state and "
        "gradients across data-parallel ranks?", default=True,
    )
    if cfg.megatron_lm_use_distributed_optimizer and not cfg.use_fsdp:
        cfg.use_fsdp = True
        cfg.fsdp = 0
        cfg.fsdp_sharding_strategy = "SHARD_GRAD_OP"
    cfg.megatron_lm_gradient_clipping = _ask_field(
        "What is the gradient clipping value based on global L2 norm (0 to disable)?", 1.0, float
    )


def _mesh_questions(cfg: ClusterConfig):
    cfg.tp = _ask_field("Tensor-parallel size (tp mesh axis)?", cfg.tp or 1, int)
    cfg.sp = _ask_field(
        "Sequence-parallel size (ring/ulysses long-context, sp mesh axis)?", cfg.sp or 1, int
    )
    if cfg.sp > 1:
        cfg.sp_impl = _choose("Sequence-parallel attention?", ["ring", "ulysses"])
    cfg.pp = _ask_field("Pipeline-parallel size (pp mesh axis)?", cfg.pp or 1, int)
    cfg.ep = _ask_field("Expert-parallel size (MoE, ep mesh axis)?", cfg.ep or 1, int)


def config_command(args):
    if getattr(args, "default", False):
        return default_config_command(args)
    if getattr(args, "update", False):
        return update_config_command(args)
    cfg = ClusterConfig()
    # Guided flow mirroring the reference questionnaire
    # (commands/config/cluster.py:863 get_cluster_input): machines -> dynamo ->
    # strategy (DeepSpeed | FSDP | Megatron | plain mesh) -> precision.  Every
    # multiple-choice question goes through the BulletMenu (arrow keys on a
    # TTY, numbered prompt otherwise, so tests drive it by answer injection).
    _machine_questions(cfg)
    _dynamo_questions(cfg)
    strategy = _choose(
        "Which distributed training strategy do you want to configure?",
        ["Plain data parallelism / custom mesh", "FSDP (sharding over the fsdp axis)",
         "DeepSpeed dialect", "Megatron-LM dialect"],
    )
    asked_accum = False
    if strategy == "DeepSpeed dialect":
        asked_accum = _deepspeed_questions(cfg)
    elif strategy == "FSDP (sharding over the fsdp axis)":
        _fsdp_questions(cfg)
        _mesh_questions(cfg)
    elif strategy == "Megatron-LM dialect":
        _megatron_questions(cfg)
    else:
        _mesh_questions(cfg)
    cfg.mixed_precision = _choose(
        "Do you wish to use mixed precision?", ["no", "bf16", "fp16", "fp8"], default=1
    )
    if cfg.mixed_precision == "bf16":
        cfg.downcast_bf16 = _yes_no(
            "Do you want pure-bf16 params (downcast_bf16: halves param/grad HBM, no fp32 master)?"
        )
    if not asked_accum:
        cfg.gradient_accumulation_steps = _ask_field(
            "How many gradient accumulation steps?", cfg.gradient_accumulation_steps, int,
            check=lambda v: v >= 1,
        )
    path = save_config(cfg, getattr(args, "config_file", None) or DEFAULT_CONFIG_FILE)
    print(f"Configuration saved to {path}")


def update_config_command(args):
    """Migrate an existing config file to the current schema (reference
    ``commands/config/update.py``): unknown keys drop with a note, missing
    keys fill with defaults, the result is rewritten in place."""
    path = getattr(args, "config_file", None) or DEFAULT_CONFIG_FILE
    if not os.path.exists(path):
        raise SystemExit(f"No config file at {path}; write one first (config_command or "
                         "write_basic_config).")
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    known = set(ClusterConfig.__dataclass_fields__)
    dropped = sorted(k for k in data if k not in known)
    cfg = ClusterConfig(**{k: v for k, v in data.items() if k in known})
    save_config(cfg, path)
    note = f" (dropped unknown keys: {', '.join(dropped)})" if dropped else ""
    print(f"Updated {path} to the current schema{note}")
    return dropped


def default_config_command(args):
    path = save_config(ClusterConfig(), getattr(args, "config_file", None) or DEFAULT_CONFIG_FILE)
    print(f"Default configuration saved to {path}")


def write_basic_config(mixed_precision: str = "no", save_location: str = None) -> str:
    """Programmatic default-config writer (reference
    ``commands/config/default.py:36`` — used by notebooks/CI to skip the
    questionnaire).  Returns the written path."""
    cfg = ClusterConfig(mixed_precision=str(mixed_precision))
    return save_config(cfg, save_location or DEFAULT_CONFIG_FILE)


def register_subcommand(subparsers):
    parser = subparsers.add_parser("config", help="Create the launch configuration")
    parser.add_argument("--config_file", default=None)
    parser.add_argument("--default", action="store_true", help="Write defaults without prompting")
    parser.add_argument("--update", action="store_true",
                        help="Migrate an existing config file to the current schema")
    parser.set_defaults(func=config_command)
