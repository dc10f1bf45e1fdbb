"""Checkpoint manifests: completeness marker, integrity verification, discovery.

A copy of the JAX package's ``resilience/manifest.py`` with the same
``manifest.json`` schema (format ``accelerate-tpu-checkpoint-v1``) and the
same environment switches, so each package's :func:`verify_checkpoint`
accepts the other's directories.  :func:`write_manifest` passes every
covered file and the manifest itself through
:func:`~.faultinject.maybe_fail_write` (``ACCELERATE_TPU_FAULT_WRITE_N``),
the JAX package's injection sites.

The atomic-save protocol (``checkpointing.save_accelerator_state``):

1. every file is written into a staging directory ``<final>.tmp``;
2. ``manifest.json`` is written into staging LAST — it records per-file size
   and SHA-256, the training step, world size, and library version, so its
   presence certifies every other file landed in full;
3. staging files and the manifest are fsynced, then staging is atomically
   renamed to the final name (and the parent directory fsynced).

A crash or I/O failure at ANY point leaves either the old checkpoint
untouched or a ``.tmp`` staging dir with no final-name directory — never a
final directory missing its manifest, and never a manifest describing files
that aren't fully on disk.  Discovery (:func:`find_latest_complete`) therefore
only needs to look for ``manifest.json`` to skip torn partials.

Hashing cost is opt-out for huge checkpoints: ``ACCELERATE_TPU_MANIFEST_HASH=0``
records sizes only (verification then checks sizes only).  The files of one
checkpoint are hashed (and synced) side by side, one thread each: a save or
a verification then takes about as long as hashing its largest file.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from ..telemetry import span as _span

logger = logging.getLogger(__name__)

__all__ = [
    "MANIFEST_NAME",
    "ENV_MANIFEST_HASH",
    "ENV_CHECKPOINT_FSYNC",
    "MANIFEST_FORMAT",
    "fsync_enabled",
    "hashing_enabled",
    "CheckpointVerificationError",
    "write_manifest",
    "read_manifest",
    "verify_checkpoint",
    "is_complete",
    "list_checkpoints",
    "find_latest_complete",
    "prune_checkpoints",
    "fsync_dir",
]

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = "accelerate-tpu-checkpoint-v1"
ENV_MANIFEST_HASH = "ACCELERATE_TPU_MANIFEST_HASH"
ENV_CHECKPOINT_FSYNC = "ACCELERATE_TPU_CHECKPOINT_FSYNC"

_HASH_CHUNK = 4 * 1024 * 1024

_OFF = ("0", "false", "no", "off")


class CheckpointVerificationError(RuntimeError):
    """A checkpoint directory failed manifest verification (missing/truncated/
    corrupted file, or no manifest at all)."""


def hashing_enabled() -> bool:
    return os.environ.get(ENV_MANIFEST_HASH, "1").strip().lower() not in _OFF


def fsync_enabled() -> bool:
    """Durability fsyncs default ON; ``ACCELERATE_TPU_CHECKPOINT_FSYNC=0``
    skips them (test suites / throwaway runs — the write ORDERING that makes
    the manifest a completeness certificate is unaffected, only
    power-loss durability is)."""
    return os.environ.get(ENV_CHECKPOINT_FSYNC, "1").strip().lower() not in _OFF


def _hash_and_sync(path: str, hash_file: bool, fsync: bool) -> Optional[str]:
    """The SHA-256 of ``path`` (None unless ``hash_file``), after an fsync
    of it when ``fsync``."""
    digest = None
    with open(path, "rb") as f:
        if hash_file:
            h = hashlib.sha256()
            while True:
                chunk = f.read(_HASH_CHUNK)
                if not chunk:
                    break
                h.update(chunk)
            digest = h.hexdigest()
        if fsync:
            try:
                os.fsync(f.fileno())
            except OSError:
                pass
    return digest


def _each_file(fn, paths: list) -> list:
    """``fn`` over ``paths`` on one thread a file (hashlib and the reads
    and fsyncs release the GIL), results in order."""
    with ThreadPoolExecutor(max(1, min(len(paths), 8))) as pool:
        return list(pool.map(fn, paths))


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename/creation inside it survives power loss.
    Best-effort: some filesystems (and Windows) refuse directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _walk_files(root: str) -> list[str]:
    """Relative paths of every regular file under ``root`` (sorted; the
    manifest and its .tmp scratch file excluded — a retried write_manifest
    must not cover its own previous attempt's leftover, which os.replace then
    consumes, publishing a manifest that lists a file that no longer
    exists)."""
    out = []
    skip = (MANIFEST_NAME, f"{MANIFEST_NAME}.tmp")
    for dirpath, _dirnames, filenames in os.walk(root):
        for fname in filenames:
            rel = os.path.relpath(os.path.join(dirpath, fname), root)
            if rel not in skip:
                out.append(rel)
    return sorted(out)


@_span("resilience.write_manifest")
def write_manifest(
    directory: str,
    step: Optional[int] = None,
    extra: Optional[dict] = None,
    hash_files: Optional[bool] = None,
    fsync: Optional[bool] = None,
) -> dict:
    """Write ``manifest.json`` covering every file currently under
    ``directory`` — call this LAST, after all checkpoint files landed.  With
    ``fsync`` (default: the ``ACCELERATE_TPU_CHECKPOINT_FSYNC`` env, on) each
    covered file and the manifest are fsynced so the completeness certificate
    is durable, not just ordered."""
    from .faultinject import maybe_fail_write

    if hash_files is None:
        hash_files = hashing_enabled()
    if fsync is None:
        fsync = fsync_enabled()
    files: dict[str, dict] = {}
    rels = _walk_files(directory)
    for rel in rels:
        fp = os.path.join(directory, rel)
        maybe_fail_write(fp)
        files[rel] = {"size": os.path.getsize(fp)}
    if hash_files or fsync:
        digests = _each_file(lambda rel: _hash_and_sync(os.path.join(directory, rel),
                                                        hash_files, fsync), rels)
        if hash_files:
            for rel, digest in zip(rels, digests):
                files[rel]["sha256"] = digest

    world_size = 1
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        world_size = torch.distributed.get_world_size()
    from .. import __version__

    manifest = {
        "format": MANIFEST_FORMAT,
        "step": step,
        "world_size": world_size,
        "library_version": __version__,
        "hashed": bool(hash_files),
        "files": files,
    }
    if extra:
        manifest.update(extra)

    path = os.path.join(directory, MANIFEST_NAME)
    maybe_fail_write(path)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        if fsync:
            try:
                os.fsync(f.fileno())
            except OSError:
                pass
    os.replace(tmp, path)
    if fsync:
        fsync_dir(directory)
    return manifest


def read_manifest(directory: str) -> Optional[dict]:
    """Parse ``directory/manifest.json``; None when absent or unparseable (a
    torn manifest write counts as no manifest)."""
    path = os.path.join(directory, MANIFEST_NAME)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


@_span("resilience.verify_checkpoint")
def verify_checkpoint(directory: str, check_hashes: Optional[bool] = None) -> dict:
    """Verify ``directory`` against its manifest; returns the manifest.

    Raises :class:`CheckpointVerificationError` when the manifest is missing
    or any covered file is missing, has the wrong size, or (when the manifest
    carries hashes and ``check_hashes`` isn't disabled) a wrong SHA-256.
    """
    manifest = read_manifest(directory)
    if manifest is None:
        raise CheckpointVerificationError(
            f"{directory!r} has no readable {MANIFEST_NAME} — it is not a complete "
            "checkpoint (a crash mid-save leaves exactly this state)."
        )
    if check_hashes is None:
        check_hashes = hashing_enabled()
    problems, hashed = [], []
    for rel, entry in manifest.get("files", {}).items():
        fp = os.path.join(directory, rel)
        if not os.path.exists(fp):
            problems.append(f"missing file {rel}")
            continue
        size = os.path.getsize(fp)
        if size != entry.get("size"):
            problems.append(f"{rel}: size {size} != manifest {entry.get('size')}")
            continue
        if check_hashes and entry.get("sha256") is not None:
            hashed.append(rel)
    digests = _each_file(lambda rel: _hash_and_sync(os.path.join(directory, rel), True, False),
                         hashed)
    problems += [f"{rel}: sha256 mismatch" for rel, digest in zip(hashed, digests)
                 if digest != manifest["files"][rel]["sha256"]]
    if problems:
        raise CheckpointVerificationError(
            f"checkpoint {directory!r} failed verification: " + "; ".join(problems)
        )
    return manifest


def is_complete(directory: str) -> bool:
    """Cheap completeness check: a parseable manifest exists (no hashing)."""
    return os.path.isdir(directory) and read_manifest(directory) is not None


def _checkpoint_sort_key(directory: str):
    """Newest-last ordering: directory mtime (when its files were staged)
    first, then the trailing integer of ``checkpoint_<i>`` naming to break
    same-second ties.  mtime leads because checkpoints under one root mix
    naming schemes — a ``preempt`` dir written at step 2500 must outrank a
    ``step_2000`` dir, which an index-first ordering would rank above every
    non-digit-suffixed name.  The manifest ``step`` is deliberately NOT part
    of the ordering — plain ``save_state()`` records ``step=None``, and
    ranking any stepped checkpoint above every step-less one would resurrect
    a stale preemption checkpoint over newer saves."""
    tail = os.path.basename(directory).rsplit("_", 1)[-1]
    index = int(tail) if tail.isdigit() else -1
    try:
        mtime = os.path.getmtime(directory)
    except OSError:
        mtime = 0.0
    return (mtime, index)


def list_checkpoints(root: str) -> list[str]:
    """Checkpoint-looking subdirectories of ``root`` (complete or torn),
    oldest first.  ``.tmp`` staging leftovers are excluded — they were never
    published."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        fp = os.path.join(root, name)
        if not os.path.isdir(fp) or name.endswith(".tmp"):
            continue
        out.append(fp)
    return sorted(out, key=_checkpoint_sort_key)


def find_latest_complete(root: str) -> Optional[str]:
    """Newest manifest-complete checkpoint under ``root`` (skipping torn
    partials); ``root`` itself when it carries a manifest; None when nothing
    complete exists.  When a NEWER manifest-less directory is being passed
    over (a legacy/unverified save, or a torn final on a filesystem without
    atomic rename), that is loud — silently resuming older state is how runs
    repeat days of training."""
    if is_complete(root):
        return root
    existing = list_checkpoints(root)
    complete = [d for d in existing if is_complete(d)]
    if not complete:
        return None
    chosen = complete[-1]
    if existing and existing[-1] != chosen:
        logger.warning(
            f"resume target {chosen!r} is not the newest directory under {root!r}: "
            f"skipping newer manifest-less {existing[-1]!r} (torn partial or "
            "unverified save — pass it to load_state explicitly if it is a real "
            "checkpoint)."
        )
    return chosen


def prune_checkpoints(root: str, keep: int) -> list[str]:
    """Keep-last-N rotation over ``checkpoint_*`` directories that never
    deletes the newest complete checkpoint.

    Deletes oldest-first ((index, mtime) order) until at most ``keep``
    remain.  Only auto-naming-style ``checkpoint_*`` directories are
    considered — rotation must never touch unrelated directories a user
    placed under the checkpoints root.  Manifest-less directories get no
    special treatment beyond not being protected: under the atomic-save
    protocol a torn save is a ``.tmp`` dir (never published, excluded here),
    so a manifest-less ``checkpoint_*`` is a legacy/unverified save that ages
    out like any other.  Stale ``checkpoint_*.tmp`` staging leftovers from
    crashed/failed saves of OTHER iterations are also swept (rotation runs
    after a successful publish, so no writer can still own them).  Returns
    the paths removed (staging sweeps included)."""
    import shutil

    if keep < 0:
        return []
    removed_stale = []
    if os.path.isdir(root):
        for name in os.listdir(root):
            fp = os.path.join(root, name)
            if name.startswith("checkpoint_") and name.endswith(".tmp") and os.path.isdir(fp):
                shutil.rmtree(fp, ignore_errors=True)
                removed_stale.append(fp)
                logger.info(f"checkpoint rotation swept stale staging {fp}")
    existing = [
        d for d in list_checkpoints(root)
        if os.path.basename(d).startswith("checkpoint_")
    ]
    if len(existing) <= keep:
        return removed_stale
    complete = [d for d in existing if is_complete(d)]
    last_complete = complete[-1] if complete else None
    # Swept staging dirs never counted toward the checkpoint population, so
    # they must not count against the keep-last-N quota either.
    removed = []
    for victim in existing:
        if len(existing) - len(removed) <= keep:
            break
        if victim == last_complete:
            logger.warning(
                f"checkpoint rotation keeps {victim!r}: it is the newest complete "
                f"checkpoint under {root!r} (limit {keep})"
            )
            continue
        shutil.rmtree(victim, ignore_errors=True)
        removed.append(victim)
        logger.info(f"checkpoint rotation removed {victim}")
    return removed_stale + removed
