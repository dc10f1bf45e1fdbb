"""Version comparison helpers: the JAX package's
``accelerate_tpu/utils/versions.py`` for the port.  ``is_jax_version`` reads
the installed jax's version from its package metadata and never imports jax
(the port imports no JAX)."""

from __future__ import annotations

import importlib.metadata
import operator

__all__ = ["compare_versions", "is_jax_version", "is_torch_version"]

_OPS = {
    "<": operator.lt,
    "<=": operator.le,
    "==": operator.eq,
    "!=": operator.ne,
    ">=": operator.ge,
    ">": operator.gt,
}


def compare_versions(library_or_version, operation: str, requirement_version: str) -> bool:
    """``compare_versions("torch", ">=", "2.4")``, or with a version string
    (``"v1.2.3"`` too) as the first argument; PEP 440 ordering, so
    ``0.4.0rc1 < 0.4.0 < 0.4.0.post1``."""
    from packaging.version import parse  # imported at use: the port's import path stays lean

    if operation not in _OPS:
        raise ValueError(f"operation must be one of {sorted(_OPS)}, got {operation!r}")
    raw = str(library_or_version)
    if raw.lstrip("vV")[:1].isdigit():
        version = raw.lstrip("vV")
    else:
        version = importlib.metadata.version(raw)
    return _OPS[operation](parse(version), parse(requirement_version))


def is_torch_version(operation: str, version: str) -> bool:
    import torch

    return compare_versions(torch.__version__, operation, version)


def is_jax_version(operation: str, version: str) -> bool:
    """The installed jax package's version against ``version``, from
    ``importlib.metadata`` (raises ``PackageNotFoundError`` without jax)."""
    return compare_versions(importlib.metadata.version("jax"), operation, version)
