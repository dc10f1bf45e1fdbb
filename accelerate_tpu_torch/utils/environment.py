"""Environment-variable helpers: the JAX package's
``accelerate_tpu/utils/environment.py`` for the port.

Configuration flows from a launcher to its workers through ``ACCELERATE_*``
variables, parsed here under the same names.  The parsing helpers are a copy
(that module imports no JAX); the device questions (``get_gpu_info``,
``check_cuda_p2p_ib_support``) are answered from ``torch.cuda``; the two
launcher helpers with no one-GPU meaning yet (``install_xla``,
``get_ccl_version``) raise ``NotImplementedError`` until ROADMAP A9 brings
the launchers.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import os
import sys
import warnings
from typing import Any, Optional

import torch

__all__ = [
    "are_libraries_initialized",
    "check_cuda_p2p_ib_support",
    "clear_environment",
    "convert_dict_to_env_variables",
    "get_ccl_version",
    "get_gpu_info",
    "get_int_from_env",
    "install_xla",
    "parse_choice_from_env",
    "parse_flag_from_env",
    "patch_environment",
    "purge_accelerate_environment",
    "set_numa_affinity",
    "str_to_bool",
]


def str_to_bool(value: str) -> int:
    """A string representation of truth as 1 or 0; anything else raises
    ``ValueError``."""
    value = value.lower()
    if value in ("y", "yes", "t", "true", "on", "1"):
        return 1
    if value in ("n", "no", "f", "false", "off", "0"):
        return 0
    raise ValueError(f"invalid truth value {value}")


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    """A boolean flag from the environment."""
    value = os.environ.get(key, str(default))
    return bool(str_to_bool(value))


def parse_choice_from_env(key: str, default: str = "no") -> str:
    return os.environ.get(key, str(default))


def get_int_from_env(env_keys, default: int) -> int:
    """The first non-negative int among ``env_keys``, else ``default``."""
    for e in env_keys:
        val = int(os.environ.get(e, -1))
        if val >= 0:
            return val
    return default


def are_libraries_initialized(*library_names: str) -> list[str]:
    """The libraries among ``library_names`` already imported."""
    return [lib for lib in library_names if lib in sys.modules]


def convert_dict_to_env_variables(current_env: dict) -> list[str]:
    """An env dict as ``KEY=value\\n`` lines, without the entries whose key
    or value holds a shell-unsafe character (each dropped one warns)."""
    forbidden = (";", "\n", "<", ">", " ")
    valid = []
    for key, value in current_env.items():
        if len(key) >= 1 and len(value) >= 1 and all(c not in key + value for c in forbidden):
            valid.append(f"{key}={value}\n")
        else:
            warnings.warn(f"Skipping {key}={value} — contains forbidden characters")
    return valid


def purge_accelerate_environment(func_or_cls):
    """Decorator restoring every ``ACCELERATE_*`` variable after the
    decorated function, or each test method (and ``setUp`` / ``tearDown``)
    of the decorated class, runs."""
    prefix = "ACCELERATE_"

    @contextlib.contextmanager
    def _guard():
        saved = {k: v for k, v in os.environ.items() if k.startswith(prefix)}
        try:
            yield
        finally:
            for key in [k for k in os.environ if k.startswith(prefix)]:
                if key in saved:
                    os.environ[key] = saved[key]
                else:
                    del os.environ[key]
            for key, value in saved.items():
                os.environ.setdefault(key, value)

    if inspect.isclass(func_or_cls):
        for name, attr in list(vars(func_or_cls).items()):
            if callable(attr) and (name.startswith("test") or name in ("setUp", "tearDown")):
                setattr(func_or_cls, name, purge_accelerate_environment(attr))
        return func_or_cls

    @functools.wraps(func_or_cls)
    def wrapper(*args, **kwargs):
        with _guard():
            return func_or_cls(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def patch_environment(**kwargs: Any):
    """Set environment variables (keys upper-cased, values as strings) for
    the block; restore the previous values on exit."""
    existing = {}
    for key, value in kwargs.items():
        key = key.upper()
        if key in os.environ:
            existing[key] = os.environ[key]
        os.environ[key] = str(value)
    try:
        yield
    finally:
        for key in kwargs:
            key = key.upper()
            if key in existing:
                os.environ[key] = existing[key]
            else:
                os.environ.pop(key, None)


@contextlib.contextmanager
def clear_environment():
    """An empty environment for the block; the old one comes back on exit."""
    saved = dict(os.environ)
    os.environ.clear()
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def get_gpu_info() -> tuple[list, int]:
    """``(names, count)`` of the CUDA devices torch sees (``([], 0)``
    without CUDA)."""
    if not torch.cuda.is_available():
        return [], 0
    count = torch.cuda.device_count()
    return [torch.cuda.get_device_name(i) for i in range(count)], count


def check_cuda_p2p_ib_support() -> bool:
    """False when several CUDA devices include an RTX 40-series consumer
    card, whose peer-to-peer and InfiniBand paths NCCL must not use; True
    otherwise (one device, or none)."""
    names, count = get_gpu_info()
    return not (count > 1 and any("RTX 40" in name for name in names))


def set_numa_affinity(local_process_index: int, verbose: Optional[bool] = None) -> None:
    """Pinning each rank to its GPU's NUMA node matters with several
    processes; one process has nothing to pin, so this returns at once."""
    return None


def get_ccl_version() -> str:
    """oneCCL's version: a CPU-collectives launcher helper, not ported to
    accelerate_tpu_torch yet (ROADMAP.md A9)."""
    raise NotImplementedError(
        "get_ccl_version is a launcher helper, not ported to accelerate_tpu_torch yet "
        "(ROADMAP.md A9)")


def install_xla(upgrade: bool = False) -> None:
    """The torch_xla installer of notebook launches: not ported to
    accelerate_tpu_torch yet (ROADMAP.md A9)."""
    raise NotImplementedError(
        "install_xla is a launcher helper, not ported to accelerate_tpu_torch yet "
        "(ROADMAP.md A9)")
