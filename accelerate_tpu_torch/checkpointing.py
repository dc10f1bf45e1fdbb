"""Checkpoint save and load with the JAX package's directory contract.

One directory per checkpoint, holding (``_<i>`` suffixes for a second and
later object of a kind):

- ``model.safetensors``: the model's consolidated weights, under the JAX
  package's flat parameter names (split into
  ``model-0000i-of-0000N.safetensors`` plus ``model.safetensors.index.json``
  above ``max_shard_size``), written by :mod:`.utils.safetensors_io`;
- ``optimizer.bin``: the torch optimizer's ``state_dict()`` and the update
  count; ``scheduler.bin``: the scheduler's ``state_dict()``;
- ``sampler.bin``: a seedable sampler's epoch and seed;
  ``dl_state_dict.bin``: a stateful loader's position in its epoch;
- ``custom_checkpoint_<i>.pkl``: objects passed to
  ``register_for_checkpointing``;
- ``random_states_0.pkl``: python, numpy, torch CPU and CUDA generator
  states (the JAX threefry seed has no counterpart);
- ``manifest.json``: size and SHA-256 of every file (:mod:`.resilience.manifest`).

Apart from the weights, files are ``torch.save`` archives (the JAX package
pickles optax state, which the port has no use for).

The save is atomic: files are staged in ``<dir>.tmp``, the manifest is
written last, an existing ``<dir>`` is moved aside to ``<dir>.old`` and
the staging directory renamed in (the old one restored if that rename
fails, and a checkpoint left displaced by a crash restored on the next
publish), and only then is the old one deleted; under automatic naming the
newest ``total_limit`` checkpoints are kept.  The publish runs once: the
JAX package's retry policy comes with its resilience tooling, and its
orbax sharded, asynchronous and local saves and the elastic topology
record belong to multi-GPU training; none is ported.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Optional

import torch

from .utils import safetensors_io
from .utils.operations import recursively_apply
from .utils.random import get_rng_state, set_rng_state

logger = logging.getLogger(__name__)

MODEL_NAME = "model"
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
SAMPLER_NAME = "sampler"
WEIGHTS_NAME = f"{MODEL_NAME}.safetensors"

__all__ = [
    "load_accelerator_state",
    "load_custom_state",
    "load_model_weights",
    "read_safetensors_state_dict",
    "save_accelerator_state",
    "save_custom_state",
    "save_model_weights",
]


def _parse_size(size) -> int:
    """``"10GB"``, ``"500MiB"``, ... or a number of bytes."""
    if isinstance(size, (int, float)):
        return int(size)
    s = str(size).upper().strip()
    units = (("TIB", 1024**4), ("GIB", 1024**3), ("MIB", 1024**2), ("KIB", 1024),
             ("TB", 1024**4), ("GB", 1024**3), ("MB", 1024**2), ("KB", 1024))
    for unit, mult in units:
        if s.endswith(unit):
            return int(float(s[: -len(unit)]) * mult)
    return int(s)


def _to_host(tree):
    return recursively_apply(lambda t: t.detach().to("cpu"), tree)


def _named(name: str, i: int, ext: str) -> str:
    return f"{name}.{ext}" if i == 0 else f"{name}_{i}.{ext}"


def save_model_weights(model, save_directory: str, weights_name: str = WEIGHTS_NAME,
                       max_shard_size="10GB", state_dict: Optional[dict] = None,
                       fsync: bool = False) -> str:
    """Write ``model.state_dict()`` (or ``state_dict``) as safetensors under
    ``save_directory``; above ``max_shard_size`` bytes the tensors go into
    numbered shards, filled in order, with a ``<weights_name>.index.json``
    weight map.  A re-save removes the other layout's files.  Returns the
    path of the file or index written."""
    os.makedirs(save_directory, exist_ok=True)
    if state_dict is None:
        state_dict = model.state_dict()
    limit = _parse_size(max_shard_size)
    total = sum(t.numel() * t.element_size() for t in state_dict.values())
    stem = weights_name.rsplit(".", 1)[0]
    path = os.path.join(save_directory, weights_name)
    index_path = f"{path}.index.json"
    sharded = total > limit
    if os.path.exists(index_path) and not sharded:
        with open(index_path) as f:
            stale = set(json.load(f).get("weight_map", {}).values())
        for fname in stale:
            if os.path.exists(os.path.join(save_directory, fname)):
                os.remove(os.path.join(save_directory, fname))
        os.remove(index_path)
    if not sharded:
        safetensors_io.save_file(state_dict, path, fsync=fsync)
        return path
    if os.path.exists(path):
        os.remove(path)
    shards, sizes = [{}], [0]
    for k, t in state_dict.items():
        n = t.numel() * t.element_size()
        if shards[-1] and sizes[-1] + n > limit:
            shards.append({})
            sizes.append(0)
        shards[-1][k] = t
        sizes[-1] += n
    weight_map = {}
    for i, shard in enumerate(shards):
        fname = f"{stem}-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        safetensors_io.save_file(shard, os.path.join(save_directory, fname), fsync=fsync)
        weight_map.update({k: fname for k in shard})
    with open(index_path, "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return index_path


def read_safetensors_state_dict(input_dir: str, weights_name: str = WEIGHTS_NAME):
    """The weights under ``input_dir`` as host tensors, from the index's
    shards or the single file; None when neither exists."""
    path = os.path.join(input_dir, weights_name)
    index_path = f"{path}.index.json"
    if os.path.exists(index_path):
        with open(index_path) as f:
            weight_map = json.load(f)["weight_map"]
        state_dict = {}
        for fname in sorted(set(weight_map.values())):
            state_dict.update(safetensors_io.load_file(os.path.join(input_dir, fname)))
        return state_dict
    if os.path.exists(path):
        return safetensors_io.load_file(path)
    return None


def load_model_weights(model, input_dir: str, weights_name: str = WEIGHTS_NAME) -> None:
    """``model.load_state_dict`` of the weights under ``input_dir`` (each
    tensor copied onto its parameter's device)."""
    state_dict = read_safetensors_state_dict(input_dir, weights_name)
    if state_dict is None:
        raise FileNotFoundError(f"no {weights_name} (or its index) under {input_dir!r}")
    model.load_state_dict(state_dict)


def _save(obj, path: str, fsync: bool) -> None:
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        if fsync:
            os.fsync(f.fileno())


def _load(path: str, **kwargs):
    # Checkpoint files are this package's own writes (see save_accelerator_state).
    return torch.load(path, map_location="cpu", weights_only=False, **kwargs)


def save_custom_state(obj, path: str, index: int = 0) -> None:
    _save(obj.state_dict(), os.path.join(path, f"custom_checkpoint_{index}.pkl"), fsync=False)


def load_custom_state(obj, path: str, index: int = 0) -> None:
    obj.load_state_dict(_load(os.path.join(path, f"custom_checkpoint_{index}.pkl")))


def _resolve_output_dir(accelerator, output_dir: Optional[str]) -> str:
    cfg = accelerator.project_configuration
    if cfg.automatic_checkpoint_naming:
        output_dir = os.path.join(accelerator.project_dir or ".", "checkpoints",
                                  f"checkpoint_{cfg.iteration}")
    if output_dir is None:
        raise ValueError("output_dir required (or enable automatic_checkpoint_naming)")
    return output_dir


def _publish(staging_dir: str, final_dir: str, fsync: bool) -> None:
    """Swing ``staging_dir`` onto ``final_dir``: an existing final directory
    is moved aside first and deleted only after the rename, so a crash
    leaves either the old or the new checkpoint published."""
    from .resilience.manifest import fsync_dir

    trash_dir = f"{final_dir.rstrip(os.sep)}.old"
    if os.path.isdir(trash_dir):
        if not os.path.isdir(final_dir):
            # An earlier publish displaced the last good checkpoint and died
            # before its swap: that checkpoint is the published state.
            os.rename(trash_dir, final_dir)
        else:
            shutil.rmtree(trash_dir)
    displaced = False
    if os.path.isdir(final_dir):
        os.rename(final_dir, trash_dir)
        displaced = True
    try:
        os.rename(staging_dir, final_dir)
    except BaseException:
        if displaced:
            os.rename(trash_dir, final_dir)
        raise
    if fsync:
        fsync_dir(os.path.dirname(final_dir) or ".")
    if displaced:
        shutil.rmtree(trash_dir, ignore_errors=True)


def save_accelerator_state(accelerator, output_dir: Optional[str] = None,
                           step: Optional[int] = None) -> str:
    """Write every prepared model, optimizer, scheduler, dataloader position,
    registered object and the RNG states as one verified checkpoint (see the
    module docstring) and return its directory.  ``step`` is recorded in the
    manifest for ``resume_from_latest``.

    ``accelerator.last_save_timing`` gets the seconds spent copying state
    to the host (``d2h_s``), writing files (``write_s``), hashing and
    syncing them into the manifest (``manifest_s``) and publishing
    (``publish_s``), and the bytes written (``bytes``)."""
    from .data_loader import SeedableRandomSampler
    from .resilience.manifest import fsync_enabled, prune_checkpoints, write_manifest

    fsync = fsync_enabled()
    final_dir = _resolve_output_dir(accelerator, output_dir)
    staging = f"{final_dir.rstrip(os.sep)}.tmp"
    if os.path.isdir(staging):  # a crashed save's staging: never loadable
        shutil.rmtree(staging, ignore_errors=True)
    os.makedirs(staging)

    # Pre-hooks see the models and their current weights; what they leave
    # in the weights list is what gets written.
    hooks = list(accelerator._save_state_pre_hooks.values())
    weights = None
    if hooks:
        weights = [accelerator.get_state_dict(m) for m in accelerator._models]
        for hook in hooks:
            hook(accelerator._models, weights, staging)

    t0 = time.perf_counter()
    if weights is None:
        weights = [m.state_dict() for m in accelerator._models]
    files = {}
    for i, w in enumerate(weights):
        files[_named(MODEL_NAME, i, "safetensors")] = _to_host(w)
    for i, opt in enumerate(accelerator._optimizers):
        files[_named(OPTIMIZER_NAME, i, "bin")] = _to_host(opt.state_dict())
    for i, sched in enumerate(accelerator._schedulers):
        files[_named(SCHEDULER_NAME, i, "bin")] = sched.state_dict()
    for i, dl in enumerate(accelerator._dataloaders):
        sampler = getattr(dl, "sampler", None)
        if isinstance(sampler, SeedableRandomSampler):
            files[_named(SAMPLER_NAME, i, "bin")] = {"epoch": sampler.epoch,
                                                     "initial_seed": sampler.initial_seed}
        if getattr(dl, "use_stateful_dataloader", False):
            files[_named("dl_state_dict", i, "bin")] = dl.state_dict()
    for i, obj in enumerate(accelerator._custom_objects):
        files[f"custom_checkpoint_{i}.pkl"] = _to_host(obj.state_dict())
    files["random_states_0.pkl"] = get_rng_state()
    if any(t.device.type == "cuda" for m in accelerator._models for t in m.parameters()):
        torch.cuda.synchronize()
    t1 = time.perf_counter()

    for name, obj in files.items():
        path = os.path.join(staging, name)
        if name.endswith(".safetensors"):
            save_model_weights(None, staging, weights_name=name, state_dict=obj, fsync=fsync)
        else:
            _save(obj, path, fsync)
    del files
    t2 = time.perf_counter()
    manifest = write_manifest(staging, step=step)
    t3 = time.perf_counter()
    _publish(staging, final_dir, fsync)
    cfg = accelerator.project_configuration
    if cfg.automatic_checkpoint_naming and cfg.total_limit is not None:
        prune_checkpoints(os.path.dirname(final_dir), keep=cfg.total_limit)
    t4 = time.perf_counter()
    cfg.iteration += 1
    accelerator.last_save_timing = {
        "d2h_s": t1 - t0, "write_s": t2 - t1, "manifest_s": t3 - t2, "publish_s": t4 - t3,
        "bytes": sum(e["size"] for e in manifest["files"].values()),
    }
    logger.info(f"Saved accelerator state to {final_dir}")
    return final_dir


def load_accelerator_state(accelerator, input_dir: Optional[str] = None) -> str:
    """Restore what :func:`save_accelerator_state` wrote (``input_dir``
    default: the newest manifest-complete checkpoint under automatic
    naming) and return the directory.  A checkpoint with a manifest is
    verified first (sizes, and SHA-256 unless
    ``ACCELERATE_TPU_MANIFEST_HASH=0``); one without loads unverified.

    ``accelerator.last_load_timing`` gets the seconds spent verifying
    (``verify_s``) and reading and placing the state (``read_place_s``)."""
    from .data_loader import SeedableRandomSampler
    from .resilience.manifest import find_latest_complete, read_manifest, verify_checkpoint

    if input_dir is None and accelerator.project_configuration.automatic_checkpoint_naming:
        base = os.path.join(accelerator.project_dir or ".", "checkpoints")
        input_dir = find_latest_complete(base)
        if input_dir is None:
            raise FileNotFoundError(f"No complete checkpoint in {base}")
    if input_dir is None:
        raise ValueError("input_dir required")
    t0 = time.perf_counter()
    if read_manifest(input_dir) is not None:
        verify_checkpoint(input_dir)
    t1 = time.perf_counter()

    for hook in list(accelerator._load_state_pre_hooks.values()):
        hook(accelerator._models, input_dir)
    for i, model in enumerate(accelerator._models):
        load_model_weights(model, input_dir, weights_name=_named(MODEL_NAME, i, "safetensors"))
    for i, opt in enumerate(accelerator._optimizers):
        opt.load_state_dict(_load(os.path.join(input_dir, _named(OPTIMIZER_NAME, i, "bin")),
                                  mmap=True))
    for i, sched in enumerate(accelerator._schedulers):
        path = os.path.join(input_dir, _named(SCHEDULER_NAME, i, "bin"))
        if os.path.exists(path):
            sched.load_state_dict(_load(path))
    for i, dl in enumerate(accelerator._dataloaders):
        path = os.path.join(input_dir, _named(SAMPLER_NAME, i, "bin"))
        sampler = getattr(dl, "sampler", None)
        if os.path.exists(path) and isinstance(sampler, SeedableRandomSampler):
            st = _load(path)
            sampler.epoch = st["epoch"]
            sampler.initial_seed = st["initial_seed"]
        path = os.path.join(input_dir, _named("dl_state_dict", i, "bin"))
        if os.path.exists(path) and getattr(dl, "use_stateful_dataloader", False):
            dl.load_state_dict(_load(path))
    for i, obj in enumerate(accelerator._custom_objects):
        load_custom_state(obj, input_dir, i)
    path = os.path.join(input_dir, "random_states_0.pkl")
    if os.path.exists(path):
        set_rng_state(_load(path))
    if any(t.device.type == "cuda" for m in accelerator._models for t in m.parameters()):
        torch.cuda.synchronize()
    accelerator.last_load_timing = {"verify_s": t1 - t0,
                                    "read_place_s": time.perf_counter() - t1}
    logger.info(f"Loaded accelerator state from {input_dir}")
    return input_dir
