"""Names the JAX package exports, importable from the port at the same
paths (``accelerate_tpu_torch``, ``.utils``, ``.pipeline``,
``.resilience``, ``.serving``, ``.state``, ``.tracking``, ``.logging``,
``.local_sgd``, ``.models.gpt2``, ``.parallel``): the 19 that were
ported in submodules only, those of the single-process surface, the
trackers, logging, memory and utils helpers, GPT-2, the other model
families, telemetry, the one-process resilience (retry, health, fault
injection), the serving chaos and the smoke modules (A5), and several
processes with the ZeRO sharded update (A6's first part), and FSDP, the
llama family's TP and the DeepSpeed / Megatron-LM dialects (A6 part 1).
Each is imported from both
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


A1B_AND_A2 = {  # trackers, logging, memory, LocalSGD, the utils helpers; GPT-2
    "": ["find_executable_batch_size", "get_logger", "LocalSGD", "is_rich_available"],
    ".utils": ["find_executable_batch_size", "release_memory", "compare_versions",
               "is_torch_version", "is_jax_version", "str_to_bool", "parse_flag_from_env",
               "parse_choice_from_env", "get_int_from_env", "are_libraries_initialized",
               "patch_environment", "clear_environment", "convert_dict_to_env_variables",
               "purge_accelerate_environment", "get_gpu_info", "check_cuda_p2p_ib_support",
               "set_numa_affinity", "get_ccl_version", "install_xla", "is_available",
               "is_tpu_available", "is_cpu_mesh_simulation", "is_torch_available",
               "is_tensorboard_available", "is_wandb_available", "is_mlflow_available",
               "is_cuda_available", "is_bf16_available", "is_fp16_available",
               "is_fp8_available", "is_triton_available", "check_cuda_fp8_capability",
               "torchao_required", "is_weights_only_available"],
    ".utils.memory": ["find_executable_batch_size", "release_memory", "clear_device_cache",
                      "should_reduce_batch_size"],
    ".utils.environment": ["patch_environment", "str_to_bool"],
    ".utils.versions": ["compare_versions", "is_jax_version"],
    ".utils.imports": ["is_available", "is_tpu_available"],
    ".logging": ["get_logger", "MultiProcessAdapter"],
    ".tracking": ["GeneralTracker", "GenericTracker", "TensorBoardTracker", "WandBTracker",
                  "CometMLTracker", "AimTracker", "MLflowTracker", "ClearMLTracker",
                  "DVCLiveTracker", "filter_trackers", "init_trackers", "on_main_process",
                  "telemetry_rows"],
    ".local_sgd": ["LocalSGD"],
    ".models.gpt2": ["GPT2Config", "init_params", "apply", "apply_hidden", "lm_head",
                     "loss_fn", "init_cache", "apply_cached", "apply_paged", "generate",
                     "speculative_generate", "generate_beam"],
}
A3 = {  # the other model families and the MoE op, at the JAX paths
    ".ops.moe": ["router", "dispatch_combine", "moe_ffn", "moe_ffn_ragged", "expert_capacity"],
    ".models.mixtral": ["MixtralConfig", "init_params", "apply", "loss_fn"],
    ".models.bert": ["BertConfig", "init_params", "apply", "classification_loss_fn"],
    ".models.vit": ["ViTConfig", "init_params", "apply", "classification_loss_fn"],
    ".models.resnet": ["ResNetConfig", "init_params", "init_batch_stats", "apply",
                       "classification_loss_fn"],
    ".models.t5": ["T5Config", "init_params", "apply", "loss_fn"],
}
A4 = {  # telemetry, at the JAX paths
    ".telemetry": ["Telemetry", "get_telemetry", "enabled", "enable", "disable",
                   "maybe_enable_from_env", "span", "Counter", "Gauge", "Histogram",
                   "MetricsRegistry", "StepTimer", "CompileWatcher", "collect_hbm",
                   "peak_flops_per_chip", "StallWatchdog", "thread_dump", "FlightRecorder",
                   "get_flight_recorder", "AnomalySentinel", "MemoryLedger", "get_memory_ledger",
                   "tree_device_bytes", "GoodputLedger", "FleetAggregator", "MetricsExporter",
                   "render_prometheus", "TraceProfileReport", "analyze_trace_dir",
                   "analyze_trace_file", "Timeline", "TraceEvent", "TraceParseError"],
    ".telemetry.flightrec": ["FlightRecorder", "get_flight_recorder", "enable", "disable",
                             "maybe_enable_from_env"],
    ".telemetry.memledger": ["MemoryLedger", "Reservation", "get_memory_ledger",
                             "tree_device_bytes", "looks_like_oom"],
    ".telemetry.goodput": ["GoodputLedger", "FleetAggregator", "summary_from_records",
                           "attach", "detach"],
    ".telemetry.export": ["MetricsExporter", "render_prometheus", "register_debug_source"],
    ".telemetry.profile_scan": ["ProfileReport", "analyze_trace_dir", "analyze_trace_file",
                                "analyze_events", "digest", "publish", "main"],
    ".telemetry.timeline": ["load_trace_events", "find_trace_files", "build_timeline",
                            "classify_op", "merge_intervals", "subtract_intervals"],
    ".telemetry.report": ["summarize", "load_records", "format_report", "main"],
    ".telemetry.names": ["all_names", "matches_dynamic"],
}
A4_CONSTANTS = {".telemetry": ["ENV_ENABLE", "ENV_DIR", "ENV_STALL_TIMEOUT"],
                ".telemetry.flightrec": ["ENV_ENABLE", "ENV_DIR", "ENV_CAPACITY",
                                         "ENV_FLUSH_EVERY", "ENV_SENTINEL_PROFILE"],
                ".telemetry.export": ["ENV_PORT", "ENV_SNAPSHOT", "PREFIX"],
                ".telemetry.goodput": ["ENV_GOODPUT", "CATEGORIES"],
                ".telemetry.names": ["COUNTERS", "GAUGES", "HISTOGRAMS", "EVENTS"]}
# The JAX telemetry names that wait for several GPUs (ROADMAP A6): compiled-
# program introspection and the comms ledger.
A6_TELEMETRY = {"ENV_INTROSPECT", "ProgramReport", "LintFinding", "CollectiveOp", "CommsLedger",
                "inspect_compiled", "capture", "lint_reshardings", "parse_collectives",
                "scan_hlo"}
A5 = {  # resilience for one process, the serving chaos and the smokes, at the JAX paths
    "": ["RetryPolicy", "retrying"],
    ".resilience": ["HealthGuard", "HealthVerdict", "NumericalDivergenceError", "RetryPolicy",
                    "retrying", "PreemptionGuard", "write_manifest", "read_manifest",
                    "is_complete", "list_checkpoints", "prune_checkpoints"],
    ".resilience.retry": ["RetryPolicy", "retrying", "default_retryable"],
    ".resilience.health": ["HealthGuard", "HealthVerdict", "NumericalDivergenceError"],
    ".resilience.faultinject": ["InjectedWriteError", "armed", "maybe_fail_write", "tick",
                                "maybe_oom", "synthetic_oom_acquire", "reload", "nan_armed",
                                "grad_poison_scale", "bad_batch_index", "maybe_poison_batch",
                                "serving_nan_ordinal", "serving_host_full"],
    ".resilience.smoke": ["main"],
    ".resilience.health_smoke": ["main"],
    ".resilience.smoke_retry": ["main"],
    ".serving.chaos": ["plan_serving_campaign", "plan_tiering_campaign",
                       "run_serving_campaign", "run_tiering_campaign", "run_first_life",
                       "run_victim_life", "run_finisher_life", "run_tier_pressure_life",
                       "run_tier_victim_life", "run_tier_finisher_life", "main"],
    ".serving.smoke": ["main"],
    ".serving.spec_smoke": ["main"],
    ".serving.trace_smoke": ["main"],
    ".telemetry.goodput_smoke": ["main"],
    ".telemetry.memledger_smoke": ["main"],
}
A5_CONSTANTS = {".resilience.faultinject": [
    "ENV_WRITE_N", "ENV_WRITE_STICKY", "ENV_SIGTERM_STEP", "ENV_OOM_ONCE", "ENV_NAN_STEP",
    "ENV_NAN_COUNT", "ENV_BAD_BATCH", "ENV_SERVING_NAN", "ENV_SERVING_HOST_FULL"],
    ".serving.chaos": ["QUEUE_DEPTH", "MAX_TICKS"],
    ".resilience.health_smoke": ["STEPS", "NAN_STEP", "CKPT_STEP"],
    ".resilience.smoke": ["STEPS", "KILL_STEP"],
    ".telemetry.goodput_smoke": ["NAN_STEP", "SIGTERM_STEP", "TOTAL_STEPS", "EPS_S"]}
# The JAX resilience names that wait for several GPUs (ROADMAP A6): the
# elastic topology resume and the fleet primitives.
A6_RESILIENCE = {"ElasticPlan", "ElasticResumeInfo", "ElasticTopologyError", "capture_topology",
                 "plan_resume", "validate_leaves", "reshard_tree", "fold_rng_bundle",
                 "recompute_skip_batches", "state_digest", "FleetError", "Heartbeat", "barrier",
                 "agree", "fleet_client"}
A6_PART0 = {  # several processes, data parallelism and the ZeRO sharded update
    "": ["ParallelismConfig", "DataLoaderDispatcher"],
    ".utils": ["ParallelismConfig"],
    ".utils.dataclasses": ["ParallelismConfig"],
    ".data_loader": ["DataLoaderDispatcher"],
    ".parallel": ["build_mesh", "data_axes", "local_mesh_shape", "mesh_axis_names",
                  "model_axes", "ZeROConfig", "zero_axes", "zero_degree"],
    ".parallel.mesh": ["build_mesh", "mesh_axis_names", "data_axes", "model_axes",
                       "local_mesh_shape", "trivial_mesh", "install_global_mesh",
                       "reset_global_mesh"],
    ".parallel.sharding": ["replicated", "batch_spec", "data_sharding", "shard_params"],
    ".parallel.zero": ["ZeROConfig", "zero_axes", "zero_degree", "shard_dim", "shard_spec",
                       "shard_shape", "chunked_global_norm", "shard_opt_state",
                       "opt_state_shardings", "opt_state_layout", "per_chip_bytes",
                       "supported", "enable_overlap_flags", "maybe_enable_from_env"],
    ".parallel.host_offload": ["host_memory_kind", "offload_to_host", "host_offload"],
    ".parallel.zero_smoke": ["main"],
}
A6_PART0_CONSTANTS = {".parallel.zero": ["ENV_ZERO", "ENV_ZERO_OVERLAP", "ZERO_AXES"]}
_FSDP_UTILS = ["save_fsdp_model", "load_fsdp_model", "save_fsdp_optimizer",
               "load_fsdp_optimizer", "merge_fsdp_weights", "fsdp2_prepare_model",
               "fsdp2_load_full_state_dict", "fsdp2_switch_optimizer_parameters",
               "get_fsdp2_grad_scaler", "enable_fsdp_ram_efficient_loading",
               "disable_fsdp_ram_efficient_loading", "ensure_weights_retied"]
_DEEPSPEED = ["HfDeepSpeedConfig", "DeepSpeedPlugin", "DummyOptim", "DummyScheduler",
              "get_active_deepspeed_plugin", "DeepSpeedEngineWrapper",
              "DeepSpeedOptimizerWrapper", "DeepSpeedSchedulerWrapper", "GatheredParameters",
              "deepspeed_required", "map_pytorch_optim_to_deepspeed"]
_MEGATRON = ["MegatronLMPlugin", "megatron_pipeline_loss_fn", "AbstractTrainStep",
             "BertTrainStep", "GPTTrainStep", "T5TrainStep", "MegatronEngine",
             "MegatronLMDummyDataLoader", "MegatronLMDummyScheduler",
             "MegatronLMOptimizerWrapper", "MegatronLMSchedulerWrapper",
             "add_model_config_to_megatron_parser", "avg_losses_across_data_parallel_group",
             "gather_across_data_parallel_groups", "megatron_lm_initialize",
             "megatron_lm_prepare_data_loader", "megatron_lm_prepare_model_optimizer_scheduler",
             "megatron_lm_prepare_optimizer", "megatron_lm_prepare_scheduler"]
A6_PART1 = {  # FSDP, the llama family's TP, the DeepSpeed and Megatron-LM dialects
    "": ["FullyShardedDataParallelPlugin", "DeepSpeedPlugin"],
    ".utils": ["FullyShardedDataParallelPlugin", *_DEEPSPEED, *_FSDP_UTILS, *_MEGATRON],
    ".utils.dataclasses": ["FullyShardedDataParallelPlugin"],
    ".utils.fsdp_utils": _FSDP_UTILS,
    ".utils.deepspeed": _DEEPSPEED,
    ".utils.megatron": _MEGATRON,
    ".parallel.sharding": ["spec_from_rules", "auto_fsdp_spec", "make_param_specs",
                           "constrain", "embed_lookup", "manual_region", "in_manual_region"],
    ".models.llama": ["param_specs"],
}
A6_PART2 = {  # sequence parallelism: the rings, Ulysses, the shared dispatch
    ".ops": ["ring_attention", "ring_self_attention"],
    ".ops.ring_attention": ["ring_attention", "ring_self_attention", "full_sequence_attention",
                            "resolve_sp_mesh", "tp_head_axis"],
    ".ops.ulysses_attention": ["ulysses_attention"],
    ".models.llama": ["sp_attention"],
}
A1B_CONSTANTS = {".utils": ["SAFE_WEIGHTS_NAME", "WEIGHTS_NAME", "MODEL_NAME", "SCALER_NAME",
                            "TORCH_LAUNCH_PARAMS"],
                 ".utils.constants": ["STR_OPERATION_TO_FUNC", "FSDP_SHARDING_STRATEGY"]}


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


@pytest.mark.parametrize("path,name", _cases(A1B_AND_A2), ids=lambda v: v if v else "top")
def test_a1b_and_gpt2_names_import_at_jax_paths(path, name):
    jax_obj, port_obj = _pair(path, name)
    assert isinstance(port_obj, type) == isinstance(jax_obj, type) and callable(port_obj)
    assert port_obj.__module__.startswith("accelerate_tpu_torch")


@pytest.mark.parametrize("path,name", _cases(A3), ids=lambda v: v)
def test_a3_names_import_at_jax_paths(path, name):
    jax_obj, port_obj = _pair(path, name)
    assert isinstance(port_obj, type) == isinstance(jax_obj, type) and callable(port_obj)
    assert port_obj.__module__ == "accelerate_tpu_torch" + path
    assert name in importlib.import_module("accelerate_tpu_torch" + path).__all__


@pytest.mark.parametrize("path,name", _cases(A1B_CONSTANTS), ids=lambda v: v)
def test_a1b_constants_equal_jax(path, name):
    jax_obj, port_obj = _pair(path, name)
    assert port_obj == jax_obj


@pytest.mark.parametrize("path,name", _cases(A4), ids=lambda v: v)
def test_a4_telemetry_names_import_at_jax_paths(path, name):
    jax_obj, port_obj = _pair(path, name)
    assert isinstance(port_obj, type) == isinstance(jax_obj, type) and callable(port_obj)
    assert port_obj.__module__.startswith("accelerate_tpu_torch.telemetry")


@pytest.mark.parametrize("path,name", _cases(A4_CONSTANTS), ids=lambda v: v)
def test_a4_telemetry_constants_equal_jax(path, name):
    jax_obj, port_obj = _pair(path, name)
    assert port_obj == jax_obj


def test_a4_telemetry_all_is_jax_all_but_the_a6_names():
    import accelerate_tpu.telemetry as jt
    import accelerate_tpu_torch.telemetry as tt

    assert set(jt.__all__) - set(tt.__all__) == A6_TELEMETRY
    assert set(tt.__all__) <= set(jt.__all__)


@pytest.mark.parametrize("path,name", _cases(A6_PART0), ids=lambda v: v if v else "top")
def test_a6_part0_names_import_at_jax_paths(path, name):
    jax_obj, port_obj = _pair(path, name)
    assert isinstance(port_obj, type) == isinstance(jax_obj, type) and callable(port_obj)
    assert port_obj.__module__.startswith("accelerate_tpu_torch")


@pytest.mark.parametrize("path,name", _cases(A6_PART0_CONSTANTS), ids=lambda v: v)
def test_a6_part0_constants_equal_jax(path, name):
    jax_obj, port_obj = _pair(path, name)
    assert port_obj == jax_obj


def test_a6_part0_zero_all_is_jax_all():
    import accelerate_tpu.parallel.host_offload as jh
    import accelerate_tpu.parallel.zero as jz
    import accelerate_tpu_torch.parallel.host_offload as th
    import accelerate_tpu_torch.parallel.zero as tz

    assert tz.__all__ == jz.__all__ and th.__all__ == jh.__all__


@pytest.mark.parametrize("path,name", _cases(A6_PART1), ids=lambda v: v if v else "top")
def test_a6_part1_names_import_at_jax_paths(path, name):
    jax_obj, port_obj = _pair(path, name)
    assert isinstance(port_obj, type) == isinstance(jax_obj, type) and callable(port_obj)
    assert port_obj.__module__.startswith("accelerate_tpu_torch")


def test_a6_part1_all_is_jax_all():
    """The JAX ``__all__`` of the sharding engine and the three dialect
    modules, the llama rule table's patterns and specs."""
    import accelerate_tpu.models.llama as jl
    import accelerate_tpu_torch.models.llama as tl

    for mod in (".parallel.sharding", ".utils.fsdp_utils", ".utils.deepspeed",
                ".utils.megatron"):
        jax_mod = importlib.import_module("accelerate_tpu" + mod)
        port_mod = importlib.import_module("accelerate_tpu_torch" + mod)
        assert port_mod.__all__ == jax_mod.__all__, mod
    assert [(r, tuple(s)) for r, s in jl.PARTITION_RULES] == tl.PARTITION_RULES


@pytest.mark.parametrize("path,name", _cases(A6_PART2), ids=lambda v: v)
def test_a6_part2_names_import_at_jax_paths(path, name):
    jax_obj, port_obj = _pair(path, name)
    assert isinstance(port_obj, type) == isinstance(jax_obj, type) and callable(port_obj)
    assert port_obj.__module__.startswith("accelerate_tpu_torch.")


def test_a6_part2_all_is_jax_all():
    for mod in (".ops.ring_attention", ".ops.ulysses_attention"):
        jax_mod = importlib.import_module("accelerate_tpu" + mod)
        port_mod = importlib.import_module("accelerate_tpu_torch" + mod)
        assert port_mod.__all__ == jax_mod.__all__, mod


def test_a6_part2_sp_resolves_and_pp_raises():
    from accelerate_tpu.utils.dataclasses import ParallelismConfig as JaxParallelismConfig

    from accelerate_tpu_torch.state import resolve_parallelism
    from accelerate_tpu_torch.utils import ParallelismConfig

    for kw in (dict(sp=2), dict(dp=2, sp=4), dict(fsdp=2, sp=2, tp=2)):
        got = resolve_parallelism(ParallelismConfig(**kw), ParallelismConfig(**kw).total_size)
        want = JaxParallelismConfig(**kw)
        assert [getattr(got, a) for a in got.AXIS_ORDER] == [getattr(want, a)
                                                             for a in want.AXIS_ORDER]
    with pytest.raises(NotImplementedError, match="A7"):
        resolve_parallelism(ParallelismConfig(pp=2), 2)


def test_a6_part2_megatron_sequence_parallelism_maps_as_jax():
    from accelerate_tpu.utils.megatron import MegatronLMPlugin as JaxPlugin

    from accelerate_tpu_torch.utils import MegatronLMPlugin

    for kw, world in ((dict(sequence_parallelism=True, sp_degree=2), 2),
                      (dict(tp_degree=2, sequence_parallelism=True, sp_degree=2), 8),
                      (dict(sequence_parallelism=True, sp_degree=4,
                            use_distributed_optimizer=True), 8)):
        got = MegatronLMPlugin(**kw).to_parallelism_config(world)
        want = JaxPlugin(**kw).to_parallelism_config(world)
        assert [getattr(got, a) for a in got.AXIS_ORDER] == [getattr(want, a)
                                                             for a in want.AXIS_ORDER], kw
        assert got.sp == kw["sp_degree"]


@pytest.mark.parametrize("path,name", _cases(A5), ids=lambda v: v if v else "top")
def test_a5_names_import_at_jax_paths(path, name):
    jax_obj, port_obj = _pair(path, name)
    assert isinstance(port_obj, type) == isinstance(jax_obj, type) and callable(port_obj)
    assert port_obj.__module__.startswith("accelerate_tpu_torch")


@pytest.mark.parametrize("path,name", _cases(A5_CONSTANTS), ids=lambda v: v)
def test_a5_constants_equal_jax(path, name):
    jax_obj, port_obj = _pair(path, name)
    assert port_obj == jax_obj


def test_a5_resilience_all_is_jax_all_but_the_a6_names():
    import accelerate_tpu.resilience as jr
    import accelerate_tpu_torch.resilience as tr

    assert set(jr.__all__) - set(tr.__all__) == A6_RESILIENCE
    assert set(tr.__all__) <= set(jr.__all__)
    for name in tr.__all__:
        assert hasattr(tr, name)


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
