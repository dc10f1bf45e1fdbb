"""Launcher env-contract helpers: the JAX package's ``utils/launch.py``.

Parity target: reference ``utils/launch.py`` (705 LoC): the functions the CLI
uses to turn parsed args into the worker env-var contract
(``prepare_simple_launcher_cmd_env`` 98, ``prepare_multi_gpu_env`` 194,
``prepare_tpu`` 473, ``PrepareForLaunch`` in ``utils/launch.py``).  The
contract is built by ``commands/launch.py build_env`` (a coordinator
address instead of torchrun's rendezvous); these wrappers keep the
reference's entry-point names so external tooling that imports them keeps
working.
"""

from __future__ import annotations

import os
from typing import Any

__all__ = [
    "PrepareForLaunch",
    "_filter_args",
    "prepare_simple_launcher_cmd_env",
    "prepare_multi_gpu_env",
    "prepare_deepspeed_cmd_env",
    "prepare_tpu",
    "get_cpu_distributed_information",
]


def _merged_from_args(args) -> dict:
    from ..commands.launch import _merge
    from ..commands.config import load_config

    return _merge(args, load_config())


def prepare_simple_launcher_cmd_env(args) -> tuple[list, dict]:
    """Reference ``utils/launch.py:98``: (command list, env dict) for a plain
    single-host launch of the user script."""
    from ..commands.launch import _script_cmd, build_env

    merged = _merged_from_args(args)
    cmd = _script_cmd(args)
    env = build_env(merged, debug=getattr(args, "debug", False), cpu=getattr(args, "cpu", False))
    return cmd, env


def prepare_multi_gpu_env(args) -> dict:
    """Reference ``utils/launch.py:194`` (torchrun env): the same worker
    contract with a coordinator address (the supervised launch adds each
    rank's ``ACCELERATE_PROCESS_ID``)."""
    merged = _merged_from_args(args)
    from ..commands.launch import build_env

    return build_env(merged, debug=getattr(args, "debug", False))


def prepare_deepspeed_cmd_env(args) -> tuple[list, dict]:
    """Reference ``utils/launch.py:329``: DeepSpeed launches reuse the same
    contract here (the ds_config is consumed as a dialect at prepare time —
    ``utils/deepspeed.py``), plus the config-file pointer."""
    cmd, env = prepare_simple_launcher_cmd_env(args)
    if getattr(args, "deepspeed_config_file", None):
        env["ACCELERATE_DEEPSPEED_CONFIG_FILE"] = args.deepspeed_config_file
        env["ACCELERATE_USE_DEEPSPEED"] = "true"
    return cmd, env


def prepare_tpu(args, current_env: dict, pod: bool = False) -> tuple[Any, dict]:
    """Reference ``utils/launch.py:473``: TPU env flags, kept for the name.
    The reference sets torch_xla bf16 env vars; here the dtype policy ships
    in ``ACCELERATE_MIXED_PRECISION`` (the other two keys, the JAX
    package's, mean nothing to the port)."""
    current_env = dict(current_env)
    if getattr(args, "mixed_precision", None):
        current_env["ACCELERATE_MIXED_PRECISION"] = str(args.mixed_precision)
    if getattr(args, "downcast_bf16", False):
        current_env["ACCELERATE_DOWNCAST_BF16"] = "1"
    if pod:
        current_env["ACCELERATE_TPU_POD"] = "1"
    return args, current_env


def _filter_args(args, parser, default_args=None):
    """Reference ``utils/launch.py``: strip accelerate-specific flags, keeping
    only the ones ``parser`` (e.g. a passthrough runner) understands."""
    new_args, _ = parser.parse_known_args(default_args or [])
    for key, value in vars(args).items():
        if key in vars(new_args):
            setattr(new_args, key, value)
    return new_args


class PrepareForLaunch:
    """Reference ``utils/launch.py PrepareForLaunch``: wrap a function so a
    process-spawn entry point can set per-process rank env before calling it
    (used by ``notebook_launcher``/``debug_launcher``)."""

    def __init__(self, launcher, distributed_type="NO", debug: bool = False):
        self.launcher = launcher
        self.distributed_type = str(distributed_type)
        self.debug = debug

    def __call__(self, index, *args):
        os.environ["LOCAL_RANK"] = str(index)
        nproc = int(os.environ.get("NPROC", os.environ.get("ACCELERATE_NUM_PROCESSES", 1)))
        node_rank = int(os.environ.get("NODE_RANK", 0))
        os.environ["RANK"] = str(nproc * node_rank + index)
        os.environ["ACCELERATE_PROCESS_ID"] = os.environ["RANK"]
        os.environ["FORK_LAUNCHED"] = "1"
        self.launcher(*args)


def get_cpu_distributed_information() -> Any:
    """Reference ``utils/environment.py CPUInformation``: world topology from
    MPI-style env vars (used for multi-host CPU rendezvous)."""
    from dataclasses import dataclass

    from .environment import get_int_from_env

    @dataclass
    class CPUInformation:
        rank: int = 0
        world_size: int = 1
        local_rank: int = 0
        local_world_size: int = 1

    return CPUInformation(
        rank=get_int_from_env(
            ["RANK", "ACCELERATE_PROCESS_ID", "PMI_RANK", "OMPI_COMM_WORLD_RANK"], 0
        ),
        world_size=get_int_from_env(
            ["WORLD_SIZE", "ACCELERATE_NUM_PROCESSES", "PMI_SIZE", "OMPI_COMM_WORLD_SIZE"], 1
        ),
        local_rank=get_int_from_env(
            ["LOCAL_RANK", "MPI_LOCALRANKID", "OMPI_COMM_WORLD_LOCAL_RANK"], 0
        ),
        local_world_size=get_int_from_env(
            ["LOCAL_WORLD_SIZE", "MPI_LOCALNRANKS", "OMPI_COMM_WORLD_LOCAL_SIZE"], 1
        ),
    )


def prepare_sagemager_args_inputs(sagemaker_config, args):
    """Reference ``utils/launch.py:535``.  SageMaker launches are out of
    scope, as in the JAX package; kept as an explicit error so migrated
    scripts fail with a pointer, not an AttributeError."""
    raise NotImplementedError(
        "SageMaker launches are out of scope for this port; run "
        "`python -m accelerate_tpu_torch.commands.launch` on each host."
    )
