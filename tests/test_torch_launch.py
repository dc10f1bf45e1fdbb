"""The launch command in the port (``commands/launch.py`` with ``config.py``,
``_parser.py`` and ``menu.py``, ``utils/launch.py``, ``launchers.py``'s
``notebook_launcher`` and ``debug_launcher``) against the JAX package.

For the same command lines (those of ``tests/test_cli_launchers.py`` and
``tests/test_cli_commands.py`` and a few more), ``_merge`` gives the same
dictionary and ``build_env`` the same ``ACCELERATE_*`` / ``FSDP_*`` /
``MEGATRON_LM_*`` / ``OMP_*`` keys and values (under ``--cpu`` the port's
``ACCELERATE_USE_CPU`` stands where JAX sets ``JAX_PLATFORMS``), and so
does ``--dry_run``; the same reference flags warn; the guided config flows
fed the same answers write the same config, which each package reads from
the other's file; the ``utils.launch`` helpers return JAX's contract.
Then the port's own runs: ``python -m accelerate_tpu_torch.commands.launch
--debug_cpu 2`` of a two-step script ends with exit 0; one whose rank 1
exits 3 ends with that code and the supervisor's detail on stderr;
``--num_processes 2`` without CUDA and without ``--cpu`` fails loudly;
``debug_launcher`` runs a function on two CPU processes and reaps them on a
failure; ``notebook_launcher`` restarts, flushes the flight recorder on a
crash, and refuses processes without CUDA."""

import argparse
import json
import os
import subprocess
import sys
import warnings
from unittest import mock

import pytest

from accelerate_tpu.commands import config as jconfig
from accelerate_tpu.commands import launch as jlaunch
from accelerate_tpu.utils import launch as jutils
from accelerate_tpu_torch.commands import config as tconfig
from accelerate_tpu_torch.commands import launch as tlaunch
from accelerate_tpu_torch.utils import launch as tutils
from torch_dp_world import REPO

CONTRACT = ("ACCELERATE_", "FSDP_", "MEGATRON_LM_", "OMP_")

ARGVS = {
    "parser_and_env": ["--mixed_precision", "bf16", "--tp_size", "2", "--use_fsdp",
                       "--num_machines", "2", "--machine_rank", "1", "--main_process_ip",
                       "10.0.0.1", "train.py", "--epochs", "3"],
    "full_reference": [
        "--num_processes", "8", "--num_machines", "2", "--machine_rank", "0",
        "--main_process_ip", "10.0.0.1", "--main_process_port", "29500",
        "--mixed_precision", "bf16", "--use_fsdp",
        "--fsdp_sharding_strategy", "FULL_SHARD", "--fsdp_offload_params", "false",
        "--fsdp_auto_wrap_policy", "TRANSFORMER_BASED_WRAP",
        "--fsdp_transformer_layer_cls_to_wrap", "GPT2Block",
        "--fsdp_state_dict_type", "SHARDED_STATE_DICT",
        "--use_deepspeed", "--zero_stage", "2",
        "--offload_optimizer_device", "none",
        "--use_megatron_lm", "--megatron_lm_tp_degree", "2",
        "--fp8_backend", "te", "--fp8_format", "HYBRID",
        "--gradient_clipping", "1.0", "--num_cpu_threads_per_process", "4",
        "--main_training_function", "main", "--downcast_bf16",
        "--env", "FOO=bar", "--env", "BAZ=qux",
        "train.py", "--lr", "3e-4"],
    "fsdp2_mesh": ["--mixed_precision", "fp16", "--gradient_accumulation_steps", "4", "--dp", "2",
                   "--fsdp_size", "2", "--use_fsdp", "--fsdp-reshard-after-forward", "false",
                   "--fsdp_cpu_offload", "--fsdp_activation_checkpointing", "true",
                   "--sp_size", "2", "--ep_size", "2", "train.py"],
    "deepspeed_file": ["--deepspeed_config_file", "ds.json", "--zero_stage", "3",
                       "--offload_param_device", "cpu", "--zero3_init_flag", "true",
                       "--deepspeed_moe_layer_cls_names", "MixtralSparseMoeBlock", "train.py"],
    "megatron": ["--use_megatron_lm", "--megatron_lm_tp_degree", "2", "--megatron_lm_pp_degree",
                 "2", "--megatron_lm_num_micro_batches", "4",
                 "--megatron_lm_sequence_parallelism", "true", "--megatron_lm_gradient_clipping",
                 "0.5", "--dynamo_backend", "inductor", "--dynamo_use_fullgraph", "train.py"],
    "downcast_only": ["--downcast_bf16", "--fp8_margin", "2", "--fp8_amax_history_len", "16",
                      "-m", "pkg.train"],
}


def _contract(env):
    return {k: v for k, v in env.items() if k.startswith(CONTRACT)}


def _merged(module, argv):
    args = module.launch_command_parser().parse_args(argv)
    cfg = (jconfig if module is jlaunch else tconfig).ClusterConfig()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        merged = module._merge(args, cfg)
    if args.num_processes:
        merged["num_processes"] = args.num_processes
    return args, merged


@pytest.mark.parametrize("name", list(ARGVS))
@pytest.mark.parametrize("cpu,debug", [(False, False), (True, True)], ids=["card", "cpu_debug"])
def test_build_env_contract_matches_jax(name, cpu, debug):
    jargs, jmerged = _merged(jlaunch, ARGVS[name])
    targs, tmerged = _merged(tlaunch, ARGVS[name])
    assert tmerged == jmerged
    assert (targs.training_script, targs.training_script_args) == (
        jargs.training_script, jargs.training_script_args)
    want = _contract(jlaunch.build_env(jmerged, debug=debug, cpu=cpu))
    got = _contract(tlaunch.build_env(tmerged, debug=debug, cpu=cpu))
    if cpu:
        assert got.pop("ACCELERATE_USE_CPU") == "1"
    assert got == want
    assert tlaunch._script_cmd(targs) == jlaunch._script_cmd(jargs)


@pytest.mark.parametrize("name", ["parser_and_env", "fsdp2_mesh", "megatron"])
def test_dry_run_prints_jax_contract(name, tmp_path, capsys):
    argv = ["--config_file", str(tmp_path / "none.yaml"), "--dry_run", "--cpu", *ARGVS[name]]
    outs = []
    for module in (jlaunch, tlaunch):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            module.launch_command(module.launch_command_parser().parse_args(argv))
        outs.append(json.loads(capsys.readouterr().out))
    want, got = outs
    want.pop("JAX_PLATFORMS")
    assert got.pop("ACCELERATE_USE_CPU") == "1"
    assert got == want


def test_unsupported_flags_warn_as_jax():
    argv = ["--multi_gpu", "--gpu_ids", "0,1", "--dynamo_backend", "inductor", "--rdzv_backend",
            "c10d", "--tee", "3", "--fsdp_backward_prefetch", "BACKWARD_PRE", "--mpirun_hostfile",
            "hosts", "--max_restarts", "0", "--fp8_opt_level", "O2", "train.py"]
    assert set(tlaunch._UNSUPPORTED_FLAGS) == set(jlaunch._UNSUPPORTED_FLAGS)
    notes = {}
    for tag, module in (("jax", jlaunch), ("torch", tlaunch)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            notes[tag] = module._warn_unsupported(module.launch_command_parser().parse_args(argv))
        assert len(caught) == len(notes[tag])
    flags = {tag: [n.split(":")[0] for n in ns] for tag, ns in notes.items()}
    assert flags["torch"] == flags["jax"] and len(flags["torch"]) >= 8
    assert all("unsupported here" in n for n in notes["torch"])


def test_dual_dash_aliases_parse_alike():
    argv = ["--num-processes", "2", "--grace-period", "3", "--heartbeat-timeout", "7", "--elastic",
            "--mixed-precision", "bf16", "train.py"]
    jargs = vars(jlaunch.launch_command_parser().parse_args(argv))
    targs = vars(tlaunch.launch_command_parser().parse_args(argv))
    jargs.pop("func"), targs.pop("func")
    assert targs == jargs


# ---------------------------------------------------------------------------
# The config file
# ---------------------------------------------------------------------------


def test_config_round_trip_across_packages(tmp_path):
    cfg = tconfig.ClusterConfig(mixed_precision="bf16", tp=2, use_fsdp=True, sp_impl="ring")
    path = tconfig.save_config(cfg, str(tmp_path / "torch.yaml"))
    assert jconfig.load_config(path).to_dict() == dict(cfg.to_dict())
    jpath = jconfig.save_config(jconfig.ClusterConfig(zero_stage=3, ep=2),
                                str(tmp_path / "jax.yaml"))
    got, want = tconfig.load_config(jpath).to_dict(), jconfig.load_config(jpath).to_dict()
    assert got == want
    assert set(tconfig.ClusterConfig.__dataclass_fields__) == set(
        jconfig.ClusterConfig.__dataclass_fields__)
    assert tconfig.load_config(str(tmp_path / "absent.yaml")) == tconfig.ClusterConfig()
    basic = tconfig.write_basic_config("fp16", str(tmp_path / "basic.yaml"))
    assert jconfig.load_config(basic).mixed_precision == "fp16"


FLOWS = {  # tests/test_cli_commands.py's answer sequences
    "fsdp": ["2", "0", "10.0.0.2", "29501", "no", "no", "1", "1", "0", "0", "no", "1",
             "1000000", "0", "yes", "2", "1", "2", "1", "1", "yes", "4"],
    "deepspeed": ["1", "no", "2", "no", "3", "1", "1", "yes", "yes", "2", "yes", "0.5", "yes",
                  "MixtralSparseMoeBlock", "2", "1", "no"],
    "megatron": ["1", "yes", "3", "yes", "1", "no", "yes", "3", "2", "yes", "2", "1", "2", "4",
                 "yes", "yes", "1.0", "1", "no", "1"],
    "yaml_feeds_launch": ["1", "no", "1", "2", "yes", "0", "yes", "0", "LlamaDecoderLayer", "1",
                          "no", "1", "2", "0", "1", "1", "1", "no", "1"],
}


def _drive(module, monkeypatch, path, answers):
    it = iter(answers)
    monkeypatch.setattr("builtins.input", lambda prompt="": next(it))
    module.config_command(argparse.Namespace(config_file=str(path), default=False, update=False))
    assert not list(it), "unconsumed answers"
    return module.load_config(str(path))


@pytest.mark.parametrize("flow", list(FLOWS))
def test_guided_config_flow_matches_jax(flow, monkeypatch, tmp_path, capsys):
    want = _drive(jconfig, monkeypatch, tmp_path / "jax.yaml", FLOWS[flow]).to_dict()
    got = _drive(tconfig, monkeypatch, tmp_path / "torch.yaml", FLOWS[flow]).to_dict()
    assert got.pop("distributed_type") == "MULTI_GPU"
    want.pop("distributed_type")
    assert got == want
    if flow == "yaml_feeds_launch":
        args = tlaunch.launch_command_parser().parse_args(["script.py"])
        env = tlaunch.build_env(tlaunch._merge(args, tconfig.load_config(
            str(tmp_path / "torch.yaml"))))
        assert env["FSDP_CPU_OFFLOAD"] == "1"
        assert env["FSDP_TRANSFORMER_CLS_TO_WRAP"] == "LlamaDecoderLayer"
        assert env["FSDP_STATE_DICT_TYPE"] == "FULL_STATE_DICT"
        assert env["ACCELERATE_SP_IMPL"] == "ring"


def test_config_update_matches_jax(tmp_path, capsys):
    for module in (jconfig, tconfig):
        path = tmp_path / f"{module.__name__}.yaml"
        path.write_text("mixed_precision: bf16\nstale_key: 1\ntp: 2\n")
        dropped = module.update_config_command(argparse.Namespace(config_file=str(path)))
        assert dropped == ["stale_key"]
        assert module.load_config(str(path)).tp == 2


# ---------------------------------------------------------------------------
# utils.launch
# ---------------------------------------------------------------------------


def test_utils_launch_helpers_match_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(jconfig, "DEFAULT_CONFIG_FILE", str(tmp_path / "none.yaml"))
    monkeypatch.setattr(tconfig, "DEFAULT_CONFIG_FILE", str(tmp_path / "none.yaml"))
    argv = ARGVS["fsdp2_mesh"] + ["--epochs", "2"]
    jargs = jlaunch.launch_command_parser().parse_args(argv)
    targs = tlaunch.launch_command_parser().parse_args(argv)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in ("prepare_simple_launcher_cmd_env", "prepare_deepspeed_cmd_env"):
            (jcmd, jenv), (tcmd, tenv) = getattr(jutils, name)(jargs), getattr(tutils, name)(targs)
            assert tcmd == jcmd and _contract(tenv) == _contract(jenv), name
        assert _contract(tutils.prepare_multi_gpu_env(targs)) == _contract(
            jutils.prepare_multi_gpu_env(jargs))
    _, jtpu = jutils.prepare_tpu(jargs, {"X": "1"}, pod=True)
    _, ttpu = tutils.prepare_tpu(targs, {"X": "1"}, pod=True)
    assert ttpu == jtpu
    runner = argparse.ArgumentParser()
    runner.add_argument("--mixed_precision")
    assert vars(tutils._filter_args(targs, runner)) == vars(jutils._filter_args(jargs, runner))
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert vars(tutils.get_cpu_distributed_information()) == vars(
        jutils.get_cpu_distributed_information())
    assert tutils.__all__ == jutils.__all__
    with pytest.raises(NotImplementedError):
        tutils.prepare_sagemager_args_inputs(None, targs)
    seen = []
    monkeypatch.setenv("ACCELERATE_NUM_PROCESSES", "2")
    monkeypatch.setenv("NODE_RANK", "1")
    with mock.patch.dict(os.environ):  # it sets the rank's variables for the process
        tutils.PrepareForLaunch(lambda *a: seen.append((os.environ["RANK"], a)))(1, "x")
        assert seen == [("3", ("x",))] and os.environ["ACCELERATE_PROCESS_ID"] == "3"


# ---------------------------------------------------------------------------
# Supervised launches
# ---------------------------------------------------------------------------

TWO_STEP = """
import os, sys, torch
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.resilience import fleet

acc = Accelerator()
for step in (1, 2):
    total = acc.reduce(torch.ones(1) * (acc.process_index + 1), "sum")
    acc.check_preemption(step=step)
beat = fleet.read_heartbeat(fleet.heartbeat_path(os.environ["ACCELERATE_TPU_HEARTBEAT_DIR"],
                                                 acc.process_index))
line = " ".join(map(str, ("RANK", acc.process_index, acc.num_processes, acc.device,
                          acc.state.backend, float(total[0]), fleet.agree("done", acc.process_index),
                          beat["step"], sys.argv[1:])))
os.write(1, (line + "\\n").encode())  # one write: the ranks share the pipe
if os.environ.get("FAIL_RANK") == str(acc.process_index):
    sys.exit(3)
"""


def test_debug_cpu_launch_of_a_two_step_script(tmp_path):
    script = tmp_path / "two_step.py"
    script.write_text(TWO_STEP)
    res = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.launch",
                          "--debug_cpu", "2", str(script), "--flag", "1"],
                         capture_output=True, text=True, timeout=180, cwd=str(REPO))
    assert res.returncode == 0, res.stderr[-3000:]
    lines = sorted(line for line in res.stdout.splitlines() if line.startswith("RANK"))
    assert lines == [f"RANK {r} 2 cpu gloo 3.0 [0, 1] 2 ['--flag', '1']" for r in range(2)], (
        res.stdout, res.stderr[-2000:])


def test_failed_rank_sets_the_exit_code_and_detail(tmp_path, monkeypatch, capsys):
    script = tmp_path / "two_step.py"
    script.write_text(TWO_STEP)
    monkeypatch.setenv("FAIL_RANK", "1")
    args = tlaunch.launch_command_parser().parse_args(
        ["--debug_cpu", "2", "--grace_period", "2", str(script)])
    with pytest.raises(SystemExit) as exc:
        tlaunch.launch_command(args)
    assert exc.value.code == 3
    assert "fleet worker_dead (rank 1 exited 3)" in capsys.readouterr().err


def test_num_processes_without_cuda_fails_loudly(tmp_path, capsys):
    args = tlaunch.launch_command_parser().parse_args(
        ["--num_processes", "2", str(tmp_path / "never_run.py")])
    with pytest.raises(SystemExit) as exc:
        tlaunch.launch_command(args)
    assert "needs CUDA" in str(exc.value.code)


def test_debug_launcher_runs_and_reaps(tmp_path):
    from accelerate_tpu_torch import debug_launcher
    from torch_fleet_tasks import debug_worker

    debug_launcher(debug_worker, args=(str(tmp_path),), num_processes=2)
    seen = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert seen == [{"rank": r, "world": 2, "device": "cpu", "backend": "gloo", "sum": 3.0,
                     "agree": [0, 1]} for r in range(2)]
    with pytest.raises(RuntimeError, match="debug_launcher workers failed"):
        debug_launcher(debug_worker, args=(str(tmp_path / "missing_dir"),), num_processes=2)


def test_notebook_launcher_restarts_flushes_and_refuses(tmp_path, monkeypatch):
    from accelerate_tpu_torch import notebook_launcher
    from accelerate_tpu_torch.telemetry import core, flightrec

    calls = []

    def flaky():
        calls.append(os.environ["ACCELERATE_MIXED_PRECISION"])
        if len(calls) == 1:
            raise RuntimeError("first attempt")
        return "ok"

    assert notebook_launcher(flaky, num_processes=1, mixed_precision="bf16", max_restarts=1) == "ok"
    assert calls == ["bf16", "bf16"]
    flightrec.enable(dir=str(tmp_path), flush_every=10_000)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            notebook_launcher(lambda: (_ for _ in ()).throw(RuntimeError("boom")))
        rec = flightrec.get_flight_recorder()
        with open(rec.jsonl_path) as f:
            crashes = [r for r in map(json.loads, filter(str.strip, f)) if r.get("kind") == "crash"]
        assert crashes and "boom" in crashes[-1]["error"]
        assert crashes[-1]["origin"].startswith("notebook_launcher")
    finally:
        flightrec.disable()
        flightrec.get_flight_recorder()._ring.clear()
        core.disable()
        core.get_telemetry().registry.reset()
        core.get_telemetry().step_timer.reset()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        notebook_launcher(flaky, num_processes=2)
