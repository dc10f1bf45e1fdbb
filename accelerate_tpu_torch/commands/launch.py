"""``launch`` — process fan-out under the fleet supervisor, and the env contract.

The JAX package's ``commands/launch.py`` in the port (parity target: the
reference ``commands/launch.py`` + ``utils/launch.py``): merge CLI flags <-
config file <- defaults, write the ``ACCELERATE_*`` env contract, spawn the
workers.  ``python -m accelerate_tpu_torch.commands.launch [flags] script.py
[args]``.

- One host, one process: the script runs in ONE subprocess.
- One host, ``--num_processes N`` (N > 1): N workers under the
  :class:`~accelerate_tpu_torch.launchers.FleetSupervisor`, placed as
  ``parallel.launch.devices_for`` places them (the worker's
  ``PartialState`` does it: NCCL with a card each where the host has N
  cards, else gloo with all of them on card 0).  Without CUDA it fails
  loudly; ``--cpu`` runs them on the CPU over gloo.  A Python script or
  ``-m`` module is forked from a server that imported torch once (a fresh
  interpreter with torch takes seconds to start); ``--no_python``
  executables are spawned.
- ``--debug_cpu N``: the same fleet on the CPU (the ``debug_launcher``
  contract) for laptop and CI testing.
- Several hosts (``--num_machines > 1``): this host runs its one worker
  with the coordinator env (``ACCELERATE_COORDINATOR_ADDRESS`` = machine
  0); the same command runs on every host with its ``--machine_rank``.

A supervised fleet whose worker dies or wedges is torn down within
``--grace_period`` (and with ``--elastic`` relaunched at the reduced world
size); a failed fleet exits with the workers' status and a detail line on
stderr.  The supervisor's summary lands in its work directory as
``fleet_summary.json`` (printed on stderr after a relaunch).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from .config import ClusterConfig, load_config

__all__ = ["launch_command", "launch_command_parser", "register_subcommand"]


# Reference flags (commands/launch.py:141-770) this launcher does not honour.
# Each entry: flag dest -> why it does not apply / what to use instead.  A set
# flag WARNS (never crashes) so reference launch commands run unmodified.
_UNSUPPORTED_FLAGS = {
    "multi_gpu": "--num_processes N already starts a process per card; drop the flag",
    "gpu_ids": "ranks take cuda:LOCAL_RANK (or share card 0); select cards with CUDA_VISIBLE_DEVICES",
    "use_xpu": "XPU is Intel GPU infrastructure; this backend targets NVIDIA GPUs",
    "ipex": "IPEX is an Intel CPU/GPU optimizer; the port runs its own CUDA kernels",
    "dynamo_backend": "the port's steps run without torch.compile (its kernels are written by hand)",
    "dynamo_mode": "see --dynamo_backend",
    "dynamo_use_fullgraph": "see --dynamo_backend",
    "dynamo_use_dynamic": "see --dynamo_backend",
    "rdzv_backend": "torchelastic rendezvous is replaced by the coordinator's TCPStore; use --main_process_ip/--main_process_port",
    "rdzv_conf": "see --rdzv_backend",
    "same_network": "see --rdzv_backend",
    "role": "torchelastic-only",
    "log_dir": "torchelastic log redirection; use shell redirection per host",
    "tee": "torchelastic-only; use shell redirection per host",
    "max_restarts": "the CLI relaunches with --elastic (the fleet at world N-1); notebook_launcher(max_restarts=...) restarts in place",
    "monitor_interval": "see --max_restarts",
    "mpirun_hostfile": "MPI launch is replaced by per-host process-group bring-up; run this command on every host with --machine_rank",
    "mpirun_ccl": "see --mpirun_hostfile",
    "deepspeed_hostfile": "DeepSpeed pdsh/mpi multi-node launch is replaced by per-host bring-up (--machine_rank per host)",
    "deepspeed_exclusion_filter": "see --deepspeed_hostfile",
    "deepspeed_inclusion_filter": "see --deepspeed_hostfile",
    "deepspeed_multinode_launcher": "see --deepspeed_hostfile",
    "deepspeed_moe_layer_cls_names": "MoE layers route through the native ep mesh axis (ops/moe.py); no ZeRO-3 leaf marking needed",
    "enable_cpu_affinity": "this launcher does no NUMA pinning",
    # downcast_bf16 is NOT listed here: it maps to mixed_precision="bf16" in
    # _merge (same conversion from_accelerate.py applies to migrated configs).
    "fp8_opt_level": "MS-AMP-specific; fp8 is not ported yet (ROADMAP A8)",
    "fp8_override_linear_precision": "TransformerEngine-specific; fp8 is not ported yet (ROADMAP A8)",
    "fp8_use_autocast_during_eval": "TE-specific; eval dtype follows the step's mixed-precision policy",
    "fsdp_backward_prefetch": "the FSDP gathers run per layer where the layer runs; no prefetch knob",
    "fsdp_forward_prefetch": "see --fsdp_backward_prefetch",
    "fsdp_sync_module_states": "prepare cuts each process's shards from its own full parameters; nothing to broadcast",
    "fsdp_use_orig_params": "each parameter is sharded in place (no flat parameters), so the distinction is moot",
    "fsdp_cpu_ram_efficient_loading": "not ported yet (ROADMAP A9: utils/modeling.py)",
    "quiet": None,  # native: suppress launcher banner
    # num_cpu_threads_per_process is NATIVE (build_env exports OMP_NUM_THREADS)
    # — deliberately not listed here.
}


def _flag_bool(value) -> bool:
    """Boolean-ish CLI/config value -> bool.  Reference flags pass booleans as
    strings ('--fsdp_offload_params false'), where plain truthiness would
    invert the request."""
    if value is None:
        return False
    if isinstance(value, bool):
        return value
    from ..utils.environment import str_to_bool

    return bool(str_to_bool(str(value)))


def launch_command_parser(subparsers=None):
    from ._parser import DualDashParser

    if subparsers is not None:
        parser = subparsers.add_parser("launch", help="Launch a training script on this host's GPUs")
    else:
        parser = DualDashParser("python -m accelerate_tpu_torch.commands.launch")
    # Hardware / topology (reference "Hardware Selection"/"Resource Selection")
    parser.add_argument("--config_file", default=None)
    parser.add_argument("--num_machines", type=int, default=None, help="Number of hosts")
    parser.add_argument("--machine_rank", type=int, default=None, help="This host's rank")
    parser.add_argument("--main_process_ip", default=None)
    parser.add_argument("--main_process_port", type=int, default=None)
    parser.add_argument("--num_processes", type=int, default=None,
                        help="Processes on this host: a card each where it has enough, else "
                        "all on card 0 (defaults to num_machines)")
    parser.add_argument("--cpu", action="store_true", help="Force CPU execution")
    parser.add_argument("--multi_gpu", action="store_true", default=None)
    parser.add_argument("--gpu_ids", default=None)
    parser.add_argument("--use_xpu", action="store_true", default=None)
    parser.add_argument("--ipex", action="store_true", default=None)
    parser.add_argument("--debug_cpu", type=int, default=0,
                        help="Spawn N local CPU processes as a simulated cluster")
    # Fleet supervision (applies to the supervised launch: --num_processes N
    # on one host, or --debug_cpu N).
    parser.add_argument("--elastic", action="store_true", default=None,
                        help="On a dead/wedged worker, relaunch the fleet at the "
                        "reduced world size (elastic resume restores the run)")
    parser.add_argument("--heartbeat_timeout", type=float, default=None,
                        help="Seconds a worker's step-loop heartbeat may go stale "
                        "before the supervisor declares it wedged (default 60)")
    parser.add_argument("--grace_period", type=float, default=None,
                        help="Seconds survivors get to exit after SIGTERM before "
                        "the supervisor SIGKILLs them (default 10)")
    parser.add_argument("--quiet", "-q", action="store_true", default=None)
    # Precision / accumulation
    parser.add_argument("--mixed_precision", default=None, choices=["no", "fp16", "bf16", "fp8"])
    parser.add_argument("--gradient_accumulation_steps", type=int, default=None)
    parser.add_argument("--gradient_clipping", type=float, default=None)
    # Dynamo group (reference commands/launch.py:240-270) — not honoured.
    parser.add_argument("--dynamo_backend", default=None)
    parser.add_argument("--dynamo_mode", default=None)
    parser.add_argument("--dynamo_use_fullgraph", action="store_true", default=None)
    parser.add_argument("--dynamo_use_dynamic", action="store_true", default=None)
    # Elastic / rendezvous group — torchelastic-only.
    parser.add_argument("--rdzv_backend", default=None)
    parser.add_argument("--rdzv_conf", default=None)
    parser.add_argument("--same_network", action="store_true", default=None)
    parser.add_argument("--role", default=None)
    parser.add_argument("--log_dir", default=None)
    parser.add_argument("--tee", default=None)
    parser.add_argument("--max_restarts", type=int, default=None)
    parser.add_argument("--monitor_interval", type=float, default=None)
    parser.add_argument("--num_cpu_threads_per_process", type=int, default=None)
    parser.add_argument("--enable_cpu_affinity", action="store_true", default=None)
    # MPI group.
    parser.add_argument("--mpirun_hostfile", default=None)
    parser.add_argument("--mpirun_ccl", type=int, default=None)
    # TPU group (reference: tpu_launcher/tpu_pod_launcher).
    parser.add_argument("--tpu", action="store_true", default=None,
                        help="Accepted for reference parity; ignored (the port runs on GPUs)")
    parser.add_argument("--tpu_cluster", "--tpu_use_cluster", action="store_true", default=None,
                        dest="tpu_cluster", help="Pod fan-out via `accelerate-tpu tpu-config`")
    parser.add_argument("--no_tpu_cluster", action="store_false", dest="tpu_cluster")
    parser.add_argument("--tpu_use_sudo", action="store_true", default=None)
    parser.add_argument("--vm", action="append", default=None)
    parser.add_argument("--env", action="append", default=None,
                        help="Extra VAR=VALUE pairs for the worker environment")
    parser.add_argument("--main_training_function", default=None,
                        help="Exported as ACCELERATE_MAIN_TRAINING_FUNCTION (notebook/pod entry)")
    parser.add_argument("--downcast_bf16", action="store_true", default=None)
    # Mesh axes (native)
    parser.add_argument("--dp", type=int, default=None)
    parser.add_argument("--fsdp_size", type=int, default=None)
    parser.add_argument("--tp_size", type=int, default=None)
    parser.add_argument("--sp_size", type=int, default=None)
    parser.add_argument("--pp_size", type=int, default=None)
    parser.add_argument("--ep_size", type=int, default=None)
    # FSDP group (reference commands/launch.py:507-610) — FSDP_* env contract.
    parser.add_argument("--use_fsdp", action="store_true", default=None)
    parser.add_argument("--fsdp_sharding_strategy", default=None)
    parser.add_argument("--fsdp_reshard_after_forward", default=None,
                        help="FSDP2 spelling of the sharding strategy")
    parser.add_argument("--fsdp_min_num_params", type=int, default=None)
    parser.add_argument("--fsdp_offload_params", default=None)
    parser.add_argument("--fsdp_cpu_offload", action="store_true", default=None)
    parser.add_argument("--fsdp_auto_wrap_policy", default=None)
    parser.add_argument("--fsdp_transformer_layer_cls_to_wrap", default=None)
    parser.add_argument("--fsdp_state_dict_type", default=None)
    parser.add_argument("--fsdp_activation_checkpointing", default=None)
    parser.add_argument("--fsdp_backward_prefetch", default=None)
    parser.add_argument("--fsdp_forward_prefetch", default=None)
    parser.add_argument("--fsdp_sync_module_states", default=None)
    parser.add_argument("--fsdp_use_orig_params", default=None)
    parser.add_argument("--fsdp_cpu_ram_efficient_loading", default=None)
    parser.add_argument("--fsdp_version", type=int, default=None,
                        help="1 and 2 map to the same sharding of the fsdp axis")
    # DeepSpeed group (reference commands/launch.py:610-700) — config dialect.
    parser.add_argument("--use_deepspeed", action="store_true", default=None)
    parser.add_argument("--deepspeed_config_file", default=None,
                        help="ds_config.json consumed as a config dialect")
    parser.add_argument("--zero_stage", type=int, default=None)
    parser.add_argument("--offload_optimizer_device", default=None)
    parser.add_argument("--offload_param_device", default=None)
    parser.add_argument("--offload_optimizer_nvme_path", default=None)
    parser.add_argument("--offload_param_nvme_path", default=None)
    parser.add_argument("--zero3_init_flag", default=None)
    parser.add_argument("--zero3_save_16bit_model", default=None)
    parser.add_argument("--deepspeed_hostfile", default=None)
    parser.add_argument("--deepspeed_exclusion_filter", default=None)
    parser.add_argument("--deepspeed_inclusion_filter", default=None)
    parser.add_argument("--deepspeed_multinode_launcher", default=None)
    parser.add_argument("--deepspeed_moe_layer_cls_names", default=None)
    # Megatron-LM group — MEGATRON_LM_* env contract.
    parser.add_argument("--use_megatron_lm", action="store_true", default=None)
    parser.add_argument("--megatron_lm_tp_degree", type=int, default=None)
    parser.add_argument("--megatron_lm_pp_degree", type=int, default=None)
    parser.add_argument("--megatron_lm_num_micro_batches", type=int, default=None)
    parser.add_argument("--megatron_lm_sequence_parallelism", default=None)
    parser.add_argument("--megatron_lm_recompute_activations", default=None)
    parser.add_argument("--megatron_lm_use_distributed_optimizer", default=None)
    parser.add_argument("--megatron_lm_gradient_clipping", type=float, default=None)
    # FP8 recipe group — exported as ACCELERATE_FP8_* (fp8 itself: ROADMAP A8).
    parser.add_argument("--fp8_backend", default=None)
    parser.add_argument("--fp8_format", default=None)
    parser.add_argument("--fp8_margin", type=int, default=None)
    parser.add_argument("--fp8_interval", type=int, default=None)
    parser.add_argument("--fp8_amax_history_len", type=int, default=None)
    parser.add_argument("--fp8_amax_compute_algo", default=None)
    parser.add_argument("--fp8_opt_level", default=None)
    parser.add_argument("--fp8_override_linear_precision", default=None)
    parser.add_argument("--fp8_use_autocast_during_eval", action="store_true", default=None)
    # SageMaker group — documented out-of-scope (utils/launch.py:147).
    parser.add_argument("--aws_access_key_id", default=None)
    parser.add_argument("--aws_secret_access_key", default=None)
    # Misc
    parser.add_argument("--debug", action="store_true", help="ACCELERATE_DEBUG_MODE=1")
    parser.add_argument("--dry_run", action="store_true",
                        help="Print the resolved worker env contract as JSON and exit")
    parser.add_argument("-m", "--module", action="store_true",
                        help="Run the training script as a python module (python -m)")
    parser.add_argument("--no_python", action="store_true",
                        help="Execute the script directly (it is not a python file)")
    parser.add_argument("training_script", type=str)
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER)
    parser.set_defaults(func=launch_command)
    return parser


def _warn_unsupported(args) -> list[str]:
    """Warn (never crash) for reference flags this launcher does not honour;
    returns the warning list for tests/--dry_run introspection."""
    import warnings

    notes = []
    for dest, why in _UNSUPPORTED_FLAGS.items():
        if why is None:
            continue
        val = getattr(args, dest, None)
        # Identity checks: `0 in (None, False)` would be True and silently
        # swallow the warning for explicit zero values.
        if val is not None and val is not False:
            notes.append(f"--{dest}: unsupported here — {why}")
    for note in notes:
        warnings.warn(note)
    return notes


def _resolve_mixed_precision(args, cfg: ClusterConfig):
    """CLI > config, with the reference's TPU knob mapped rather than dropped:
    ``--downcast_bf16`` (XRT-era XLA_DOWNCAST_BF16) means "run in bf16", which
    here is the explicit ``mixed_precision='bf16'`` policy — the conversion
    the JAX package's ``from_accelerate`` applies to migrated configs."""
    mp = args.mixed_precision if args.mixed_precision is not None else cfg.mixed_precision
    downcast = _flag_bool(getattr(args, "downcast_bf16", None)) or _flag_bool(
        getattr(cfg, "downcast_bf16", None)
    )
    if downcast and mp in (None, "no", "None"):
        import warnings

        warnings.warn(
            "--downcast_bf16 maps to mixed_precision='bf16' on this backend "
            "(XLA_DOWNCAST_BF16 is an XRT-era flag; dtype policy is explicit here)."
        )
        return "bf16"
    return mp


def _merge(args, cfg: ClusterConfig):
    """CLI flags override config file (reference ``_validate_launch_command``
    ``commands/launch.py:987-1166``)."""
    def pick(cli, conf):
        return cli if cli is not None else conf

    merged = {
        "num_machines": pick(args.num_machines, cfg.num_machines),
        "machine_rank": pick(args.machine_rank, cfg.machine_rank),
        "main_process_ip": pick(args.main_process_ip, cfg.main_process_ip),
        "main_process_port": pick(args.main_process_port, cfg.main_process_port),
        "mixed_precision": _resolve_mixed_precision(args, cfg),
        "gradient_accumulation_steps": pick(
            args.gradient_accumulation_steps, cfg.gradient_accumulation_steps
        ),
        "dp": pick(args.dp, cfg.dp),
        "fsdp": pick(args.fsdp_size, cfg.fsdp),
        "tp": pick(args.tp_size, cfg.tp),
        "sp": pick(args.sp_size, cfg.sp),
        "pp": pick(args.pp_size, cfg.pp),
        "ep": pick(args.ep_size, cfg.ep),
        "use_fsdp": pick(args.use_fsdp, cfg.use_fsdp),
        "fsdp_sharding_strategy": pick(args.fsdp_sharding_strategy, cfg.fsdp_sharding_strategy),
        "fsdp_min_num_params": pick(args.fsdp_min_num_params, cfg.fsdp_min_num_params),
        "deepspeed_config_file": pick(
            getattr(args, "deepspeed_config_file", None), cfg.deepspeed_config_file
        ),
    }
    # Reference-surface knobs that flow straight into env vars the plugins
    # already read (FSDP_* / ACCELERATE_DEEPSPEED_* / MEGATRON_LM_* contract).
    merged["gradient_clipping"] = pick(
        getattr(args, "gradient_clipping", None), getattr(cfg, "gradient_clipping", None)
    )
    for dest in (
        "fsdp_offload_params",
        "fsdp_cpu_offload",
        "fsdp_auto_wrap_policy",
        "fsdp_transformer_layer_cls_to_wrap",
        "fsdp_state_dict_type",
        "fsdp_activation_checkpointing",
        "fsdp_reshard_after_forward",
        "fsdp_version",
        "use_deepspeed",
        "zero_stage",
        "offload_optimizer_device",
        "offload_param_device",
        "zero3_init_flag",
        "zero3_save_16bit_model",
        "use_megatron_lm",
        "megatron_lm_tp_degree",
        "megatron_lm_pp_degree",
        "megatron_lm_num_micro_batches",
        "megatron_lm_sequence_parallelism",
        "megatron_lm_recompute_activations",
        "megatron_lm_use_distributed_optimizer",
        "megatron_lm_gradient_clipping",
        "fp8_backend",
        "fp8_format",
        "fp8_margin",
        "fp8_interval",
        "fp8_amax_history_len",
        "fp8_amax_compute_algo",
        "dynamo_backend",
        "dynamo_mode",
        "dynamo_use_fullgraph",
        "dynamo_use_dynamic",
        "deepspeed_moe_layer_cls_names",
        "sp_impl",
        "main_training_function",
        "num_cpu_threads_per_process",
        "env",
    ):
        merged[dest] = pick(getattr(args, dest, None), getattr(cfg, dest, None))
    return merged


def build_env(merged: dict, debug: bool = False, cpu: bool = False) -> dict:
    """The env contract every worker reads (reference ``utils/launch.py:98-326``):
    the JAX package's keys and values, with ``ACCELERATE_USE_CPU`` for
    ``cpu`` (where the JAX package sets ``JAX_PLATFORMS``)."""
    env = dict(os.environ)
    env["ACCELERATE_MIXED_PRECISION"] = str(merged["mixed_precision"])
    env["ACCELERATE_GRADIENT_ACCUMULATION_STEPS"] = str(merged["gradient_accumulation_steps"])
    for axis in ("dp", "fsdp", "tp", "sp", "pp", "ep"):
        size = merged[axis]
        if size and size > 1:
            env[f"ACCELERATE_PARALLELISM_{axis.upper()}"] = str(size)
    if merged["use_fsdp"]:
        env["ACCELERATE_USE_FSDP"] = "1"
        strategy = merged["fsdp_sharding_strategy"]
        if merged.get("fsdp_reshard_after_forward") is not None:
            # FSDP2 spelling: true == FULL_SHARD, false == SHARD_GRAD_OP.
            strategy = (
                "FULL_SHARD" if _flag_bool(merged["fsdp_reshard_after_forward"]) else "SHARD_GRAD_OP"
            )
        env["FSDP_SHARDING_STRATEGY"] = str(strategy)
        env["FSDP_MIN_NUM_PARAMS"] = str(merged["fsdp_min_num_params"])
        if _flag_bool(merged.get("fsdp_offload_params")) or _flag_bool(merged.get("fsdp_cpu_offload")):
            env["FSDP_CPU_OFFLOAD"] = "1"
        if merged.get("fsdp_transformer_layer_cls_to_wrap"):
            env["FSDP_TRANSFORMER_CLS_TO_WRAP"] = str(merged["fsdp_transformer_layer_cls_to_wrap"])
        if merged.get("fsdp_state_dict_type"):
            env["FSDP_STATE_DICT_TYPE"] = str(merged["fsdp_state_dict_type"])
        if _flag_bool(merged.get("fsdp_activation_checkpointing")):
            env["FSDP_ACTIVATION_CHECKPOINTING"] = "1"
    if merged.get("deepspeed_config_file") or merged.get("use_deepspeed"):
        env["ACCELERATE_USE_DEEPSPEED"] = "true"
        if merged.get("deepspeed_config_file"):
            env["ACCELERATE_DEEPSPEED_CONFIG_FILE"] = str(merged["deepspeed_config_file"])
        for dest, var in (
            ("zero_stage", "ACCELERATE_DEEPSPEED_ZERO_STAGE"),
            ("offload_optimizer_device", "ACCELERATE_DEEPSPEED_OFFLOAD_OPTIMIZER_DEVICE"),
            ("offload_param_device", "ACCELERATE_DEEPSPEED_OFFLOAD_PARAM_DEVICE"),
            ("zero3_init_flag", "ACCELERATE_DEEPSPEED_ZERO3_INIT"),
            ("zero3_save_16bit_model", "ACCELERATE_DEEPSPEED_ZERO3_SAVE_16BIT_MODEL"),
            ("deepspeed_moe_layer_cls_names", "ACCELERATE_DEEPSPEED_MOE_LAYER_CLS_NAMES"),
        ):
            if merged.get(dest) is not None:
                env[var] = str(merged[dest])
    if merged.get("use_megatron_lm"):
        env["ACCELERATE_USE_MEGATRON_LM"] = "true"
        for dest, var in (
            ("megatron_lm_tp_degree", "MEGATRON_LM_TP_DEGREE"),
            ("megatron_lm_pp_degree", "MEGATRON_LM_PP_DEGREE"),
            ("megatron_lm_num_micro_batches", "MEGATRON_LM_NUM_MICRO_BATCHES"),
            ("megatron_lm_sequence_parallelism", "MEGATRON_LM_SEQUENCE_PARALLELISM"),
            ("megatron_lm_recompute_activations", "MEGATRON_LM_RECOMPUTE_ACTIVATIONS"),
            ("megatron_lm_use_distributed_optimizer", "MEGATRON_LM_USE_DISTRIBUTED_OPTIMIZER"),
            ("megatron_lm_gradient_clipping", "MEGATRON_LM_GRADIENT_CLIPPING"),
        ):
            if merged.get(dest) is not None:
                env[var] = str(merged[dest])
    if merged.get("gradient_clipping") is not None:
        env["ACCELERATE_GRADIENT_CLIPPING"] = str(merged["gradient_clipping"])
    for dest, var in (
        ("dynamo_backend", "ACCELERATE_DYNAMO_BACKEND"),
        ("dynamo_mode", "ACCELERATE_DYNAMO_MODE"),
        ("dynamo_use_fullgraph", "ACCELERATE_DYNAMO_USE_FULLGRAPH"),
        ("dynamo_use_dynamic", "ACCELERATE_DYNAMO_USE_DYNAMIC"),
        ("sp_impl", "ACCELERATE_SP_IMPL"),
    ):
        if merged.get(dest) is not None:
            env[var] = str(merged[dest])
    for dest, var in (
        ("fp8_backend", "ACCELERATE_FP8_BACKEND"),
        ("fp8_format", "ACCELERATE_FP8_FORMAT"),
        ("fp8_margin", "ACCELERATE_FP8_MARGIN"),
        ("fp8_interval", "ACCELERATE_FP8_INTERVAL"),
        ("fp8_amax_history_len", "ACCELERATE_FP8_AMAX_HISTORY_LEN"),
        ("fp8_amax_compute_algo", "ACCELERATE_FP8_AMAX_COMPUTE_ALGO"),
        ("main_training_function", "ACCELERATE_MAIN_TRAINING_FUNCTION"),
    ):
        if merged.get(dest) is not None:
            env[var] = str(merged[dest])
    if merged.get("num_cpu_threads_per_process"):
        env["OMP_NUM_THREADS"] = str(merged["num_cpu_threads_per_process"])
    for pair in merged.get("env") or []:
        key, _, value = str(pair).partition("=")
        if key:
            env[key] = value
    if debug:
        env["ACCELERATE_DEBUG_MODE"] = "1"
    if cpu:
        env["ACCELERATE_USE_CPU"] = "1"
    nm = merged["num_machines"]
    if nm and nm > 1:
        ip = merged["main_process_ip"] or "127.0.0.1"
        port = merged["main_process_port"] or 29500
        env["ACCELERATE_COORDINATOR_ADDRESS"] = f"{ip}:{port}"
        env["ACCELERATE_NUM_PROCESSES"] = str(merged.get("num_processes") or nm)
        env["ACCELERATE_PROCESS_ID"] = str(merged["machine_rank"])
    return env


def _script_cmd(args) -> list:
    if getattr(args, "module", False) and getattr(args, "no_python", False):
        raise SystemExit("--module and --no_python cannot be used together.")
    if getattr(args, "no_python", False):
        return [args.training_script] + list(args.training_script_args)
    base = [sys.executable]
    if getattr(args, "module", False):
        base.append("-m")
    return base + [args.training_script] + list(args.training_script_args)


def launch_command(args):
    if getattr(args, "aws_access_key_id", None) or getattr(args, "aws_secret_access_key", None):
        from ..utils.launch import prepare_sagemager_args_inputs

        prepare_sagemager_args_inputs(None, args)  # documented out-of-scope error
    _warn_unsupported(args)
    cfg = load_config(args.config_file)
    merged = _merge(args, cfg)
    if args.num_processes:
        merged["num_processes"] = args.num_processes

    if getattr(args, "dry_run", False):
        import json

        env = build_env(merged, debug=args.debug, cpu=args.cpu)
        contract = {
            k: v
            for k, v in env.items()
            if k.startswith(("ACCELERATE_", "FSDP_", "MEGATRON_LM_", "OMP_"))
        }
        print(json.dumps(contract, indent=2, sort_keys=True))
        return

    if args.debug_cpu and args.debug_cpu > 1:
        return _supervised_launch(args, merged, args.debug_cpu, cpu=True)
    if (args.num_processes or 0) > 1 and (merged["num_machines"] or 1) <= 1:
        return _supervised_launch(args, merged, args.num_processes, cpu=args.cpu)

    env = build_env(merged, debug=args.debug, cpu=args.cpu)
    cmd = _script_cmd(args)
    result = subprocess.run(cmd, env=env)
    if result.returncode != 0:
        raise SystemExit(result.returncode)


def _supervised_launch(args, merged, n: int, cpu: bool):
    """N workers on this host under the
    :class:`~accelerate_tpu_torch.launchers.FleetSupervisor` (the JAX
    package's ``_debug_cpu_launch``, on the card unless ``cpu``): a worker
    that dies or wedges no longer leaves its siblings hung in their next
    collective — the fleet is torn down within a bounded grace window (and
    with ``--elastic`` relaunched at the reduced world size).  The
    supervisor owns the coordinator port (fresh per attempt), so workers
    see a consistent address and retry the connect with backoff."""
    import json
    import tempfile

    from ..launchers import FleetSupervisor
    from ..parallel import launch

    if not cpu:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit(
                f"launch: --num_processes {n} needs CUDA, and it is not available; pass "
                "--cpu (or --debug_cpu N) to run the processes on the CPU")
    merged = dict(merged)
    merged["num_machines"] = n
    merged["main_process_ip"] = "127.0.0.1"
    merged["num_processes"] = n
    cmd = _script_cmd(args)
    telemetry_dir = os.environ.get("ACCELERATE_TPU_TELEMETRY_DIR") or os.environ.get(
        "ACCELERATE_TPU_FLIGHTREC_DIR"
    )

    def spawn(rank, world, overrides):
        merged["machine_rank"] = rank
        merged["num_machines"] = world
        merged["num_processes"] = world
        # Any port works here — the supervisor's coordinator address
        # override below is what the workers actually dial.
        merged["main_process_port"] = 0
        env = build_env(merged, debug=args.debug, cpu=cpu)
        env.update(overrides)
        if getattr(args, "no_python", False):
            return subprocess.Popen(cmd, env=env)
        module = getattr(args, "module", False)
        return launch.fork(args.training_script, list(args.training_script_args), env,
                           how="module" if module else "path")

    workdir = tempfile.mkdtemp(prefix="atpu_fleet_")
    supervisor = FleetSupervisor(
        spawn,
        n,
        workdir=workdir,
        heartbeat_timeout_s=(
            args.heartbeat_timeout if args.heartbeat_timeout is not None else 60.0
        ),
        grace_s=args.grace_period if args.grace_period is not None else 10.0,
        elastic=bool(args.elastic),
        telemetry_dir=telemetry_dir,
    )
    result = supervisor.run()
    summary = os.path.join(workdir, "fleet_summary.json")
    with open(summary, "w") as f:
        json.dump(result, f, indent=2, default=str)
    if len(result["attempts"]) > 1 and not args.quiet:
        print(f"launch: fleet {result['verdict']} at world {result['world_size']} after "
              f"{len(result['attempts'])} attempts; summary: {summary}", file=sys.stderr)
    if result["verdict"] not in ("completed", "drained"):
        last = result["attempts"][-1]
        codes = [c for c in last["exit_codes"].values() if c]
        detail = f"fleet {result['verdict']}"
        if last.get("dead_rank") is not None:
            detail += f" (rank {last['dead_rank']} exited {last['exit_code']})"
        if last.get("wedged_rank") is not None:
            detail += f" (rank {last['wedged_rank']} heartbeat stalled)"
        if result.get("postmortem"):
            detail += f"; postmortem: {result['postmortem']}"
        print(detail, file=sys.stderr)
        raise SystemExit(max(codes) if codes else 1)


def register_subcommand(subparsers):
    launch_command_parser(subparsers)


def main_launch():
    """Entry for ``python -m accelerate_tpu_torch.commands.launch``."""
    parser = launch_command_parser()
    args = parser.parse_args()
    launch_command(args)


if __name__ == "__main__":
    # ``python -m accelerate_tpu_torch.commands.launch ...`` — without this guard
    # the module imports, does nothing, and exits 0, which reads as a
    # successful (but empty) launch.
    main_launch()
