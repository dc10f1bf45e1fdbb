"""Builds the port's CUDA kernels on first use and loads them with ctypes.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), for
Hopper only (``sm_90a``).  Libraries land in ``build/kernels/`` beside the
package, named by the hash of their source, so an edited source is rebuilt
and an unchanged one is loaded as it is.  Nothing is built or imported when
this module is imported: the CPU tests import every module of the port.

Each ``nvcc`` run is reported to telemetry as a compile (``jit.compiles``,
``jit.compile_ms``), and each library loaded without a build as a cache hit
(``jit.cache_hits``): the port's counterpart of the JAX package's XLA
compile listener.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

from ..telemetry.metrics import CACHE_HIT_EVENT, COMPILE_EVENT, note_compile_event

__all__ = ["BUILD_DIR", "SOURCES", "build", "load"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES: Dict[str, Path] = {
    "paged_attention": _CSRC / "paged_attention.cu",  # the first paged body, a timing yardstick
    "paged_attention_sm90": _CSRC / "paged_attention_sm90.cu",
    "flash_attention": _CSRC / "flash_attention.cu",  # the first fp32 flash bodies, timed only
    "flash_fwd_sm90": _CSRC / "flash_fwd_sm90.cu",
    "flash_bwd_dq_sm90": _CSRC / "flash_bwd_dq_sm90.cu",
    "flash_bwd_dkv_sm90": _CSRC / "flash_bwd_dkv_sm90.cu",
    "flash_f32_sm90": _CSRC / "flash_f32_sm90.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together.  Returns ``{name: library path}``; raises
    ``RuntimeError`` with nvcc's output when a build fails.  The compiler's
    report (registers, shared memory, spills) is kept beside each library
    as ``<name>-<hash>.log``."""
    names = list(names)
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, target in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        target = todo[name]
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {SOURCES[name]} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, target)
            note_compile_event(COMPILE_EVENT, time.perf_counter() - t0)
    if failures:
        raise RuntimeError("\n".join(failures))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        if _target(name).exists():
            note_compile_event(CACHE_HIT_EVENT)
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib
