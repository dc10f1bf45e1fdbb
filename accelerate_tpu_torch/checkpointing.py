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
  ``dl_state_dict.bin``: a stateful loader's position in its epoch (process
  ``r`` > 0 writes its own beside it, ``dl_state_dict.rank<r>.bin``);
- ``custom_checkpoint_<i>.pkl``: objects passed to
  ``register_for_checkpointing``;
- ``random_states_<r>.pkl``: process ``r``'s python, numpy, torch CPU and
  CUDA generator states (the JAX threefry seed has no counterpart);
- ``manifest.json``: size and SHA-256 of every file (:mod:`.resilience.manifest`).

Apart from the weights, files are ``torch.save`` archives (the JAX package
pickles optax state, which the port has no use for).

With several processes the save is the JAX package's consolidated one: the
main process writes the model (replicated, so its own copy, or a sharded
model's leaves gathered to full shapes: every process takes part), the
optimizer (a ZeRO or sharded state gathered to full shapes) and the rest;
every process writes its RNG states and its loader position;
``wait_for_everyone`` goes around the manifest and the publish, which the
main process does.  The manifest carries the topology record
(:mod:`.resilience.elastic`), so a load may land on another mesh or world
size: the record is planned and validated before any state is touched,
each leaf is cut to the live layout, each rank restores its own RNG
states and loader position, and a rank the checkpoint has none for takes
a stream folded for it and the global position the record gives.

Under an FSDP plugin on an ``fsdp`` mesh the model's weights follow its
``state_dict_type``, as in the JAX package: ``FULL_STATE_DICT`` is the
consolidated file; ``SHARDED_STATE_DICT`` (the default) has every process
write only its own shards into ``model_orbax/`` (the JAX package's
directory name; inside, the port's own format: ``rank<r>.safetensors`` and
its ``rank<r>.index.json`` of each leaf's full shape, dtype and offsets),
which a load reads back onto any live layout; ``LOCAL_STATE_DICT`` dumps
each process's shards verbatim into ``model_local/``, which loads only on
the same process count and layout.  The optimizer state is the gathered
``optimizer.bin`` on every path.

The save is atomic (``verified=False`` opts out and writes in place, with
no staging and no manifest): files are staged in ``<dir>.tmp``, the manifest is
written last, an existing ``<dir>`` is moved aside to ``<dir>.old`` and
the staging directory renamed in (the old one restored if that rename
fails, and a checkpoint left displaced by a crash restored on the next
publish), and only then is the old one deleted; under automatic naming the
newest ``total_limit`` checkpoints are kept.  The manifest write and the
publish run together under the JAX package's I/O retry policy
(:func:`_io_policy`, :class:`~.resilience.retry.RetryPolicy`, label
``checkpoint.publish``): a transient ``OSError`` backs off and tries again,
and a save that exhausts the policy leaves only the manifest-less staging
directory, which discovery passes over.  ``async_save=True`` copies every
tensor to host memory before it returns and writes the files on a
thread; the manifest and the publish wait for the join
(:func:`finalize_async_checkpoint`, label ``checkpoint.async_join``),
where a failed write re-raises.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Optional

import torch

from .telemetry import get_telemetry as _get_telemetry
from .telemetry import span as _span
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
                       fsync: bool = False, safe_serialization: bool = True) -> str:
    """Write ``model.state_dict()`` (or ``state_dict``) as safetensors under
    ``save_directory``; above ``max_shard_size`` bytes the tensors go into
    numbered shards, filled in order, with a ``<weights_name>.index.json``
    weight map.  A re-save removes the other layout's files.  Returns the
    path of the file or index written.  ``safe_serialization=False`` writes
    one ``<stem>.pkl`` instead (a ``torch.save`` archive of the host
    tensors, where the JAX package pickles numpy arrays), unsharded."""
    os.makedirs(save_directory, exist_ok=True)
    if state_dict is None:
        state_dict = model.state_dict()
    if not safe_serialization:
        pkl_path = os.path.join(save_directory, f"{weights_name.rsplit('.', 1)[0]}.pkl")
        _save(_to_host(state_dict), pkl_path, fsync)
        return pkl_path
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
    if _sharded(model):
        from .parallel.sharding import load_full_state_dict

        load_full_state_dict(getattr(model, "module", model), state_dict)
        return
    model.load_state_dict(state_dict)


def _sharded(model) -> bool:
    """Whether a prepared model holds shards of its leaves."""
    from .parallel.sharding import is_sharded, spec_of

    return any(is_sharded(spec_of(p)) for p in model.parameters())


# ---------------------------------------------------------------------------
# SHARDED_STATE_DICT: every process writes its own shards, with an index
# ---------------------------------------------------------------------------


def _dir_name(kind: str, i: int) -> str:
    """``model_orbax`` / ``model_<i>_orbax`` (``kind`` ``"orbax"``), the JAX
    package's directory names; ``model_local`` likewise."""
    return f"{MODEL_NAME}_{kind}" if i == 0 else f"{MODEL_NAME}_{i}_{kind}"


def _mesh():
    from .state import AcceleratorState

    return AcceleratorState._shared_state.get("mesh")


def _slice_region(full_shape: tuple, spec, mesh, rank: Optional[int] = None) -> list:
    """``[(start, stop), ...]`` per dim: the slice of a leaf of ``full_shape``
    that ``rank`` holds under ``spec`` (the whole leaf when replicated)."""
    from .parallel.sharding import _entry_axes, is_sharded

    region = [(0, int(n)) for n in full_shape]
    if mesh is None or not is_sharded(spec):
        return region
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        n = mesh.span(axes)
        if n > 1:
            c = full_shape[d] // n
            k = mesh.index(axes, rank)
            region[d] = (k * c, (k + 1) * c)
    return region


def _writes_slice(spec, mesh) -> bool:
    """Whether this process writes its slice of a leaf: the first of the
    processes that hold the same slice (coordinate 0 on every axis the spec
    does not split over)."""
    from .parallel.sharding import spec_axes

    if mesh is None:
        return True
    split = set(spec_axes(spec))
    coords = mesh.coords()
    return all(c == 0 for a, c in coords.items() if a not in split)


def _model_shards(model) -> tuple:
    """(tensors, index) of this process's part of a sharded save of
    ``model``: each leaf's slice it writes, and the JSON index of each
    one's full shape, dtype and offsets."""
    from .parallel.sharding import spec_of

    mesh = _mesh()
    tensors, leaves = {}, {}
    for name, t in _unwrap(model).state_dict(keep_vars=True).items():
        spec = spec_of(t)
        if not _writes_slice(spec, mesh):
            continue
        full = tuple(getattr(t, "_full_shape", None) or t.shape)
        tensors[name] = t.detach()
        leaves[name] = {"shape": list(full), "dtype": str(t.dtype).replace("torch.", ""),
                        "offsets": [a for a, _ in _slice_region(full, spec, mesh)],
                        "local_shape": list(t.shape)}
    return tensors, {"format": "accelerate_tpu_torch.sharded/1", "leaves": leaves}


def save_sharded_model(model, directory: str, async_save: bool = False):
    """The FSDP ``SHARDED_STATE_DICT`` save (the JAX package's orbax
    export, in the port's own format): every process writes only its own
    shards, ``rank<r>.safetensors``, beside ``rank<r>.index.json`` (each
    leaf's full shape, dtype and the offsets of its slice); a slice held by
    several processes is written by the first.  No gather.  With
    ``async_save`` the host snapshot is taken here and the write runs on a
    thread, which is returned (join it before relying on the files); else
    None."""
    from .state import PartialState

    rank = PartialState._shared_state.get("process_index", 0)
    tensors, index = _model_shards(model)
    files = {f"rank{rank}.safetensors": tensors, f"rank{rank}.index.json": index}
    if not async_save:
        _write_files(directory, _host_copy(files, pinned=False), fsync=_fsync())
        return None
    return _start_writer(directory, _host_copy(files, pinned=True), fsync=_fsync())


def _read_index(directory: str) -> list:
    out = []
    for fname in sorted(os.listdir(directory)):
        if fname.endswith(".index.json"):
            with open(os.path.join(directory, fname)) as f:
                out.append((fname[: -len(".index.json")] + ".safetensors", json.load(f)))
    if not out:
        raise FileNotFoundError(f"no sharded checkpoint index under {directory!r}")
    return out


@torch.no_grad()
def load_sharded_model(model, directory: str) -> None:
    """Restore a :func:`save_sharded_model` export onto the LIVE layout:
    each process reads, for each of its leaves, the parts of the saved
    slices that its own slice needs, so a sharded checkpoint lands on any
    mesh and process count.  Raises when a leaf is missing, has another
    full shape or dtype, or is not covered."""
    from .parallel.sharding import spec_of

    mesh = _mesh()
    live = _unwrap(model).state_dict(keep_vars=True)
    index = _read_index(directory)
    needed = {}
    for name, t in live.items():
        full = tuple(getattr(t, "_full_shape", None) or t.shape)
        needed[name] = (t, full, _slice_region(full, spec_of(t), mesh))
    for name, (t, full, _) in needed.items():
        recs = [rec["leaves"][name] for _, rec in index if name in rec["leaves"]]
        if not recs:
            raise KeyError(f"sharded checkpoint {directory!r} has no parameter {name}")
        dtype = str(t.dtype).replace("torch.", "")
        if tuple(recs[0]["shape"]) != full or recs[0]["dtype"] != dtype:
            raise ValueError(f"sharded checkpoint leaf {name}: saved {recs[0]['shape']} "
                             f"{recs[0]['dtype']}, live {list(full)} {dtype}")
    filled = {name: 0 for name in needed}
    for fname, rec in index:
        wanted = [n for n in rec["leaves"] if n in needed]
        if not wanted:
            continue
        tensors = None
        for name in wanted:
            t, full, region = needed[name]
            saved = rec["leaves"][name]
            lo = [max(a, o) for (a, _), o in zip(region, saved["offsets"])]
            hi = [min(b, o + n) for (_, b), o, n in zip(region, saved["offsets"],
                                                        saved["local_shape"])]
            if any(h <= lo_ for lo_, h in zip(lo, hi)):
                continue
            if tensors is None:
                tensors = safetensors_io.load_file(os.path.join(directory, fname))
            src, dst = tensors[name], t.data
            for d, (a, b) in enumerate(zip(lo, hi)):
                src = src.narrow(d, a - saved["offsets"][d], b - a)
                dst = dst.narrow(d, a - region[d][0], b - a)
            dst.copy_(src)
            filled[name] += src.numel()
        del tensors
    short = [n for n, (t, _, _) in needed.items() if filled[n] != t.numel()]
    if short:
        raise RuntimeError(f"sharded checkpoint {directory!r} does not cover {short[:8]} "
                           "on the live layout")


def merge_sharded(directory: str) -> dict:
    """The full tensors of a :func:`save_sharded_model` export, assembled
    on the host from every process's shards (the offline form of a load)."""
    index = _read_index(directory)
    out = {}
    for fname, rec in index:
        if not rec["leaves"]:
            continue
        tensors = safetensors_io.load_file(os.path.join(directory, fname))
        for name, saved in rec["leaves"].items():
            src = tensors[name]
            full = out.get(name)
            if full is None:
                full = out[name] = torch.empty(saved["shape"], dtype=src.dtype)
            dst = full
            for d, (o, n) in enumerate(zip(saved["offsets"], saved["local_shape"])):
                dst = dst.narrow(d, o, n)
            dst.copy_(src)
    return out


# ---------------------------------------------------------------------------
# LOCAL_STATE_DICT: every process dumps its shards verbatim (topology-bound)
# ---------------------------------------------------------------------------


def _region_key(region) -> tuple:
    return tuple((int(a), int(b)) for a, b in region)


def save_local_model(model, directory: str) -> None:
    """The FSDP ``LOCAL_STATE_DICT`` save: every process dumps exactly its
    own shards (``local_rank<r>.bin``, a ``torch.save`` archive), keyed by
    the global slice each covers, with no resharding metadata.  It loads
    only on the same process count and layout."""
    from .parallel.sharding import spec_of
    from .state import PartialState

    os.makedirs(directory, exist_ok=True)
    mesh = _mesh()
    rank = PartialState._shared_state.get("process_index", 0)
    leaves = {}
    for name, t in _unwrap(model).state_dict(keep_vars=True).items():
        full = tuple(getattr(t, "_full_shape", None) or t.shape)
        leaves[name] = {"shape": full, "dtype": str(t.dtype).replace("torch.", ""),
                        "shards": {_region_key(_slice_region(full, spec_of(t), mesh)):
                                   t.detach().to("cpu", copy=True)}}
    payload = {"num_processes": PartialState._shared_state.get("num_processes", 1),
               "process_index": rank, "leaves": leaves}
    _save(payload, os.path.join(directory, f"local_rank{rank}.bin"), _fsync())


@torch.no_grad()
def load_local_model(model, directory: str) -> None:
    """Restore a :func:`save_local_model` dump onto the SAME topology; any
    mismatch (process count, leaf set, shapes, dtypes or this process's
    slices) raises, before a parameter is touched, instead of resharding
    (that is what ``SHARDED_STATE_DICT`` is for)."""
    from .parallel.sharding import spec_of
    from .state import PartialState

    rank = PartialState._shared_state.get("process_index", 0)
    world = PartialState._shared_state.get("num_processes", 1)
    fp = os.path.join(directory, f"local_rank{rank}.bin")
    if not os.path.exists(fp):
        raise FileNotFoundError(
            f"LOCAL_STATE_DICT checkpoint has no dump for process {rank} under "
            f"{directory!r} — local checkpoints are topology-bound; use "
            "SHARDED_STATE_DICT to restore across topologies.")
    payload = _load(fp)
    if payload["num_processes"] != world:
        raise RuntimeError(
            f"LOCAL_STATE_DICT topology mismatch: saved with "
            f"{payload['num_processes']} processes, loading with {world}.")
    mesh = _mesh()
    plan = []
    for name, t in _unwrap(model).state_dict(keep_vars=True).items():
        rec = payload["leaves"].get(name)
        if rec is None:
            raise KeyError(f"LOCAL_STATE_DICT dump is missing parameter {name}")
        full = tuple(getattr(t, "_full_shape", None) or t.shape)
        if tuple(rec["shape"]) != full:
            raise ValueError(f"LOCAL_STATE_DICT shape mismatch for {name}: saved "
                             f"{rec['shape']}, live {full}")
        dtype = str(t.dtype).replace("torch.", "")
        if rec["dtype"] != dtype:
            raise ValueError(f"LOCAL_STATE_DICT dtype mismatch for {name}: saved "
                             f"{rec['dtype']}, live {dtype}")
        key = _region_key(_slice_region(full, spec_of(t), mesh))
        if key not in rec["shards"]:
            raise RuntimeError(
                f"LOCAL_STATE_DICT shard layout mismatch for {name}: live layout "
                f"needs slice {key} on process {rank}, dump has {sorted(rec['shards'])} — "
                "the mesh layout changed since save; use SHARDED_STATE_DICT.")
        plan.append((t, rec["shards"][key]))
    for t, src in plan:
        t.copy_(src)


def _unwrap(model):
    from .utils.modeling import PreparedModel

    return model.module if isinstance(model, PreparedModel) else model


def _plugin_save_mode(accelerator, wanted: str) -> bool:
    from .utils.dataclasses import DistributedType

    plugin = getattr(accelerator.state, "fsdp_plugin", None)
    return (accelerator.distributed_type == DistributedType.FSDP and plugin is not None
            and getattr(plugin, "state_dict_type", None) == wanted
            and len(accelerator._models) > 0)


def _use_sharded_save(accelerator) -> bool:
    """The FSDP plugin asks for ``SHARDED_STATE_DICT`` (its default) on an
    ``fsdp`` mesh: every process writes its own shards."""
    return _plugin_save_mode(accelerator, "SHARDED_STATE_DICT")


def _use_local_save(accelerator) -> bool:
    """The FSDP plugin asks for ``LOCAL_STATE_DICT``: every process dumps
    its shards verbatim (topology-bound)."""
    return _plugin_save_mode(accelerator, "LOCAL_STATE_DICT")


def _loader_position_name(i: int, rank: int) -> str:
    """Loader ``i``'s position file of process ``rank``."""
    name = _named("dl_state_dict", i, "bin")
    return name if rank == 0 else name.replace(".bin", f".rank{rank}.bin")


def _fsync() -> bool:
    from .resilience.manifest import fsync_enabled

    return fsync_enabled()


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


def _io_policy(label: str):
    """Retry policy for checkpoint I/O, as the JAX package's.  Env-tunable
    so tests can shrink the backoff: ``ACCELERATE_TPU_IO_RETRIES`` (default
    4), ``ACCELERATE_TPU_IO_RETRY_BASE_S`` (0.2), ``…_DEADLINE_S`` (120)."""
    from .resilience.retry import RetryPolicy

    def _env(key, default, cast):
        try:
            return cast(os.environ.get(key, "") or default)
        except ValueError:
            return cast(default)

    return RetryPolicy(
        # 0 (the natural "disable retries") means one attempt, not a crash.
        tries=max(1, _env("ACCELERATE_TPU_IO_RETRIES", 4, int)),
        base_delay_s=_env("ACCELERATE_TPU_IO_RETRY_BASE_S", 0.2, float),
        deadline_s=_env("ACCELERATE_TPU_IO_RETRY_DEADLINE_S", 120.0, float),
        label=label,
    )


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


# ---------------------------------------------------------------------------
# Files: the host snapshot and the writer
# ---------------------------------------------------------------------------


def _host_copy(tree, pinned: bool):
    """Every tensor of ``tree`` on the host.  ``pinned``: a copy the caller
    owns (pinned memory for a CUDA tensor, a clone of a host one), waited
    for, so the live tensors may change as soon as this returns; else a
    CUDA tensor's plain copy and a host tensor itself (the synchronous
    save writes before it returns)."""
    cuda = [False]

    def one(t):
        t = t.detach()
        if t.device.type == "cuda":
            cuda[0] = True
            if not pinned:
                return t.to("cpu")
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out.copy_(t, non_blocking=True)
            return out
        return t.clone() if pinned else t

    out = recursively_apply(one, tree)
    if cuda[0]:
        torch.cuda.synchronize()
    return out


def _write_files(directory: str, files: dict, fsync: bool) -> int:
    """Write ``files`` (relative name -> object) under ``directory``:
    ``.safetensors`` a dict of tensors, ``.json`` JSON, anything else a
    ``torch.save`` archive.  Returns the bytes written."""
    written = 0
    for name, obj in files.items():
        path = os.path.join(directory, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if name.endswith(".safetensors") and "/" in name:  # a rank's shards: one file
            safetensors_io.save_file(obj, path, fsync=fsync)
        elif name.endswith(".safetensors"):
            save_model_weights(None, directory, weights_name=name, state_dict=obj, fsync=fsync)
        elif name.endswith(".json"):
            with open(path, "w") as f:
                json.dump(obj, f)
        else:
            _save(obj, path, fsync)
        written += os.path.getsize(path) if os.path.exists(path) else 0
    return written


class _Writer(threading.Thread):
    """The background write of an asynchronous save: its error, if any, is
    kept for the join to re-raise."""

    def __init__(self, directory: str, files: dict, fsync: bool):
        super().__init__(name="accelerate-tpu-torch-async-save", daemon=True)
        self.directory, self.files, self.fsync = directory, files, fsync
        self.error: Optional[BaseException] = None
        self.seconds = 0.0
        self.written = 0

    def run(self) -> None:
        t0 = time.perf_counter()
        try:
            self.written = _write_files(self.directory, self.files, self.fsync)
        except BaseException as e:  # noqa: BLE001 - re-raised at the join
            self.error = e
        finally:
            self.files = None
            self.seconds = time.perf_counter() - t0


def _start_writer(directory: str, files: dict, fsync: bool) -> _Writer:
    writer = _Writer(directory, files, fsync)
    writer.start()
    return writer


# ---------------------------------------------------------------------------
# Asynchronous saves: the join
# ---------------------------------------------------------------------------

# ``save_state(async_save=True)`` followed by a plain exit: the deferred
# manifest and publish would leave the run's last checkpoint in ``.tmp``.
# One atexit hook finalizes every accelerator with a pending publish, at one
# process only (a publish across processes meets at barriers, which peers
# that already exited would never reach).
_pending_finalize_accelerators = None


def _register_finalize_atexit(accelerator) -> None:
    import atexit
    import weakref

    global _pending_finalize_accelerators
    if _pending_finalize_accelerators is None:
        _pending_finalize_accelerators = weakref.WeakSet()
        atexit.register(_finalize_pending_at_exit)
    _pending_finalize_accelerators.add(accelerator)


def _finalize_pending_at_exit() -> None:
    for accelerator in list(_pending_finalize_accelerators or ()):
        try:
            if (getattr(accelerator, "_async_save", None) is not None
                    and accelerator.num_processes == 1):
                logger.warning(
                    "finalizing a pending async checkpoint at interpreter exit — "
                    "call wait_for_checkpoint() or end_training() to publish it "
                    "deterministically.")
                finalize_async_checkpoint(accelerator)
        except Exception:
            logger.exception("atexit checkpoint finalize failed")


def finalize_async_checkpoint(accelerator) -> None:
    """Join the in-flight asynchronous save, if any, and run its deferred
    manifest and atomic publish.  A failed background write re-raises here
    (on every process: they first agree whether any failed), its staging
    directory removed and nothing published, so the previous complete
    checkpoint stays the resume target."""
    pending = getattr(accelerator, "_async_save", None)
    if pending is None:
        return
    accelerator._async_save = None
    t0 = time.perf_counter()
    errors = []
    for writer in pending["writers"]:
        writer.join()
        if writer.error is not None:
            errors.append(writer.error)
    failed = bool(errors)
    if accelerator.num_processes > 1:
        # Every process must take the same branch below: one that raised
        # while the others entered the publish's barrier would hang them.
        from .utils.operations import gather_object

        failed = any(gather_object([bool(errors)]))
    timing = accelerator.last_save_timing or {}
    timing["write_s"] = max((w.seconds for w in pending["writers"]), default=0.0)
    timing["join_wait_s"] = time.perf_counter() - t0
    if failed:
        staging = pending["staging"]
        if staging and os.path.isdir(staging) and accelerator.is_main_process:
            shutil.rmtree(staging, ignore_errors=True)
        detail = "; ".join(str(e) for e in errors) if errors else "another process reported failure"
        raise RuntimeError(
            "async checkpoint save failed while finalizing — the checkpoint is "
            "incomplete and was NOT published; the previous complete checkpoint is "
            f"still the resume target: {detail}") from (errors[0] if errors else None)
    t1 = time.perf_counter()
    pending["finish"]()
    timing["finalize_s"] = time.perf_counter() - t1


# ---------------------------------------------------------------------------
# save_state / load_state
# ---------------------------------------------------------------------------

_warned_sharded_hook_weights = False


def _topology_extra(accelerator, step) -> dict:
    """The manifest's ``opt_state_layout`` and topology record; a capture
    that fails degrades to a manifest without a record, with a warning."""
    extra: dict = {}
    layouts = [getattr(opt, "_opt_state_layout", {"kind": "replicated", "axes": [], "degree": 1})
               for opt in accelerator._optimizers]
    if layouts:
        extra["opt_state_layout"] = layouts
    try:
        from .resilience import elastic

        extra[elastic.TOPOLOGY_KEY] = elastic.capture_topology(accelerator, step=step)
    except Exception as e:
        logger.warning(
            f"could not capture checkpoint topology record ({type(e).__name__}: "
            f"{e}); the checkpoint saves without one (legacy resume path)")
    return extra


@_span("checkpoint.save_state")
def save_accelerator_state(accelerator, output_dir: Optional[str] = None,
                           step: Optional[int] = None, verified: bool = True,
                           async_save: bool = False) -> str:
    """Write every prepared model, optimizer, scheduler, dataloader position,
    registered object and the RNG states as one verified checkpoint (see the
    module docstring) and return its directory.  ``step`` is recorded in the
    manifest for ``resume_from_latest``.  ``verified=False`` writes the
    files straight into the directory, with no manifest (so
    ``resume_from_latest`` passes it over), and rotates the oldest
    ``checkpoint_<i>`` directories out by index.  An asynchronous save still
    in flight is joined and published first.

    ``async_save``: every tensor is copied to host memory (pinned, for a
    CUDA one) and that copy waited for before this returns, so the next
    step may update the parameters in place; a background thread writes the
    files, and the manifest and the publish wait for
    :func:`finalize_async_checkpoint` (``Accelerator.wait_for_checkpoint``,
    ``end_training``, or the next save).

    ``accelerator.last_save_timing`` gets the seconds spent copying state
    to the host (``d2h_s``), writing files (``write_s``), hashing and
    syncing them into the manifest (``manifest_s``) and publishing
    (``publish_s``), the bytes written (``bytes``), and the seconds the call
    blocked (``blocking_s``); an asynchronous save fills ``write_s``,
    ``manifest_s``, ``publish_s`` and ``bytes`` at its join."""
    from .data_loader import SeedableRandomSampler
    from .resilience.manifest import MANIFEST_NAME, prune_checkpoints, write_manifest

    t_call = time.perf_counter()
    finalize_async_checkpoint(accelerator)
    fsync = _fsync()
    final_dir = _resolve_output_dir(accelerator, output_dir)
    rank = accelerator.process_index
    is_writer = accelerator.is_main_process
    several = accelerator.num_processes > 1
    if verified:
        staging = f"{final_dir.rstrip(os.sep)}.tmp"
        if is_writer and os.path.isdir(staging):  # a crashed save's staging: never loadable
            shutil.rmtree(staging, ignore_errors=True)
        if several:
            accelerator.wait_for_everyone()
        os.makedirs(staging, exist_ok=several)
    else:
        staging = final_dir
        os.makedirs(staging, exist_ok=True)
        stale = os.path.join(staging, MANIFEST_NAME)
        if is_writer and os.path.exists(stale):  # it would describe the files being replaced
            os.remove(stale)
    sharded = _use_sharded_save(accelerator)
    local = _use_local_save(accelerator)

    # Pre-hooks see the models and their current weights; what they leave
    # in the weights list is what gets written.  On the sharded and local
    # paths they see an empty list, as in the JAX package: no model is
    # gathered whole only to feed them.
    hooks = list(accelerator._save_state_pre_hooks.values())
    weights = None
    if hooks:
        if sharded or local:
            weights = []
            global _warned_sharded_hook_weights
            if not _warned_sharded_hook_weights:
                _warned_sharded_hook_weights = True
                logger.warning(
                    "save_state pre-hooks run with an empty weights list on the "
                    "sharded path — the save writes the live model shards "
                    "directly. Use a consolidated save (state_dict_type != "
                    "SHARDED_STATE_DICT) if the hook must see or edit the weights.")
        else:
            weights = [accelerator.get_state_dict(m) for m in accelerator._models]
        for hook in hooks:
            hook(accelerator._models, weights, staging)

    t0 = time.perf_counter()
    files = {}
    if sharded or local:
        for i, model in enumerate(accelerator._models):
            if sharded:
                tensors, index = _model_shards(model)
                files[f"{_dir_name('orbax', i)}/rank{rank}.safetensors"] = tensors
                files[f"{_dir_name('orbax', i)}/rank{rank}.index.json"] = index
            else:
                save_local_model(model, os.path.join(staging, _dir_name("local", i)))
    elif weights is None and any(_sharded(m) for m in accelerator._models):
        # A sharded model's gather is a collective: every process takes part.
        weights = [accelerator.get_state_dict(m) for m in accelerator._models]
    # Every process gathers a ZeRO or sharded optimizer state (a
    # collective); the main one writes it.
    opt_states = [opt.state_dict() for opt in accelerator._optimizers]
    if is_writer:
        if not (sharded or local):
            if weights is None:
                weights = [m.state_dict() for m in accelerator._models]
            for i, w in enumerate(weights):
                files[_named(MODEL_NAME, i, "safetensors")] = w
        for i, st in enumerate(opt_states):
            files[_named(OPTIMIZER_NAME, i, "bin")] = st
        for i, sched in enumerate(accelerator._schedulers):
            files[_named(SCHEDULER_NAME, i, "bin")] = sched.state_dict()
        for i, obj in enumerate(accelerator._custom_objects):
            files[f"custom_checkpoint_{i}.pkl"] = obj.state_dict()
    del opt_states, weights
    for i, dl in enumerate(accelerator._dataloaders):
        sampler = getattr(dl, "sampler", None)
        if is_writer and isinstance(sampler, SeedableRandomSampler):
            files[_named(SAMPLER_NAME, i, "bin")] = {"epoch": sampler.epoch,
                                                     "initial_seed": sampler.initial_seed}
        if getattr(dl, "use_stateful_dataloader", False):
            files[_loader_position_name(i, rank)] = dl.state_dict()
    files[f"random_states_{rank}.pkl"] = get_rng_state()
    files = _host_copy(files, pinned=async_save)
    extra = _topology_extra(accelerator, step) if verified and is_writer else None
    t1 = time.perf_counter()
    cfg = accelerator.project_configuration
    rotate = cfg.automatic_checkpoint_naming and cfg.total_limit is not None
    timing = {"d2h_s": t1 - t0}
    accelerator.last_save_timing = timing

    def finish() -> None:
        """The manifest and the publish (verified), or the rotation."""
        t2 = time.perf_counter()
        if verified:
            marks = {}

            def _publish_io():
                marks["manifest"] = write_manifest(staging, step=step, extra=extra)
                marks["t3"] = time.perf_counter()
                _publish(staging, final_dir, fsync)

            label = "checkpoint.async_join" if async_save else "checkpoint.publish"
            with _span("checkpoint.publish"):
                if several:  # every process's files are in staging first
                    accelerator.wait_for_everyone()
                error = None
                if is_writer:
                    try:
                        _io_policy(label).call(_publish_io)
                    except Exception as e:  # re-raised below, once every process knows
                        error = e
                    tel = _get_telemetry()
                    if error is None and tel.enabled:
                        # event() mirrors into the flight recorder: the postmortem
                        # of a killed run shows which checkpoints were published.
                        tel.event("checkpoint.publish", step=step, path=final_dir)
                    if error is None and rotate:
                        prune_checkpoints(os.path.dirname(final_dir), keep=cfg.total_limit)
                if several:
                    from .utils.operations import broadcast_object_list

                    failed = broadcast_object_list([error is not None])[0]
                    if failed and error is None:
                        raise RuntimeError(f"the main process failed to publish {final_dir}")
                if error is not None:
                    raise error
            if is_writer:
                t3 = marks["t3"]
                written = sum(e["size"] for e in marks["manifest"]["files"].values())
            else:
                t3, written = t2, 0
        else:
            t3 = t2
            if several:
                accelerator.wait_for_everyone()
            if rotate and is_writer:
                _rotate_unverified(os.path.dirname(final_dir), cfg.total_limit)
            written = sum(os.path.getsize(os.path.join(dp, n))
                          for dp, _, names in os.walk(final_dir) for n in names)
        timing.update(manifest_s=t3 - t2, publish_s=time.perf_counter() - t3, bytes=written)

    if async_save:
        accelerator._async_save = {"writers": [_start_writer(staging, files, fsync)],
                                   "staging": staging if verified else None, "finish": finish}
        _register_finalize_atexit(accelerator)
        del files
    else:
        _write_files(staging, files, fsync)
        del files
        timing["write_s"] = time.perf_counter() - t1
        finish()
    cfg.iteration += 1
    timing["blocking_s"] = time.perf_counter() - t_call
    logger.info(f"Saved accelerator state to {final_dir}")
    return final_dir


def _rotate_unverified(base: str, keep: int) -> None:
    """Delete the oldest ``checkpoint_<i>`` directories (by ``i``) beyond
    ``keep``: the rotation of saves that carry no manifest."""
    existing = sorted((d for d in os.listdir(base)
                       if d.startswith("checkpoint_") and d.split("_")[-1].isdigit()),
                      key=lambda d: int(d.split("_")[-1]))
    while len(existing) > keep:
        shutil.rmtree(os.path.join(base, existing.pop(0)), ignore_errors=True)


def _elastic_plan(accelerator, input_dir: str, topology: Optional[dict]):
    """Plan and validate a topology record against the live accelerator
    before anything is restored; a changed topology is logged and emitted
    as the ``elastic.reshard`` event with the ``elastic.reshards`` counter."""
    if topology is None:
        return None
    from .resilience import elastic

    plan = elastic.plan_resume(topology, accelerator)
    elastic.validate_leaves(topology, accelerator)
    if plan.changed:
        logger.warning(
            f"elastic resume: checkpoint {input_dir!r} was saved under a different "
            f"topology ({'; '.join(plan.changes)}); each leaf is cut to the live layout.")
        tel = _get_telemetry()
        if tel.enabled:
            tel.registry.counter("elastic.reshards").inc()
            tel.event("elastic.reshard", checkpoint=input_dir, changes=list(plan.changes),
                      saved_mesh=plan.saved_mesh, live_mesh=plan.live_mesh)
    return plan


def _restore_loader(accelerator, i: int, dl, input_dir: str, topology: Optional[dict],
                    step) -> None:
    """A stateful loader's position: this process's file, or, on a rank the
    checkpoint has none for, the global position the topology record gives
    (every rank of a data-parallel run is at the same batch of the global
    batch; a legacy checkpoint falls back to rank 0's file).  Under a
    changed global batch the saved position is in the old batches' units:
    it is not restored, and the warning gives the ``skip_first_batches``
    count (``resume_from_latest`` keeps it in ``last_resume_info``)."""
    if not getattr(dl, "use_stateful_dataloader", False):
        return
    rank = accelerator.process_index
    data = (topology or {}).get("data") or {}
    saved_batches = list(data.get("loader_batches") or [])
    saved_b = saved_batches[i] if i < len(saved_batches) else None
    try:
        live_b = int(dl.total_batch_size)
    except Exception:
        live_b = None
    if saved_b is not None and live_b is not None and saved_b != live_b:
        from .resilience import elastic

        try:
            skip = elastic.recompute_skip_batches(step, saved_b, live_b)
        except elastic.ElasticTopologyError as e:
            logger.warning(
                f"dataloader {i}: saved stateful position is in global-batch-{saved_b} "
                f"units but the live loader feeds {live_b}, and the consumed examples do "
                f"not land on a new-batch boundary ({e}); the mid-epoch position is LOST — "
                "the loader restarts the epoch.")
        else:
            hint = (f"re-place it with skip_first_batches(dl, {skip})" if skip is not None
                    else "the checkpoint records no step, so the position cannot be "
                    "recomputed")
            logger.warning(
                f"dataloader {i}: saved stateful position is in global-batch-{saved_b} "
                f"units but the live loader feeds {live_b}; skipping the stateful restore "
                f"— {hint}.")
        return
    path = os.path.join(input_dir, _loader_position_name(i, rank))
    if os.path.exists(path):
        dl.load_state_dict(_load(path))
        return
    positions = list(data.get("loader_positions") or [])
    if topology is not None and i < len(positions) and positions[i] is not None:
        dl.load_state_dict(dict(positions[i]))
        return
    if topology is None:
        path = os.path.join(input_dir, _loader_position_name(i, 0))
        if os.path.exists(path):
            dl.load_state_dict(_load(path))


@_span("checkpoint.load_state")
def load_accelerator_state(accelerator, input_dir: Optional[str] = None,
                           verify: bool = True) -> str:
    """Restore what :func:`save_accelerator_state` wrote (``input_dir``
    default: the newest manifest-complete checkpoint under automatic
    naming) and return the directory.  A checkpoint with a manifest is
    verified first (sizes, and SHA-256 unless
    ``ACCELERATE_TPU_MANIFEST_HASH=0``) unless ``verify=False``; one without
    loads unverified.  A manifest's topology record is planned and
    validated against the live accelerator before any state is touched
    (:mod:`.resilience.elastic`); each rank restores its own RNG streams,
    or a stream folded for it when the checkpoint has none for it.

    ``accelerator.last_load_timing`` gets the seconds spent verifying
    (``verify_s``) and reading and placing the state (``read_place_s``)."""
    from .data_loader import SeedableRandomSampler
    from .resilience import elastic
    from .resilience.manifest import find_latest_complete, read_manifest, verify_checkpoint

    if input_dir is None and accelerator.project_configuration.automatic_checkpoint_naming:
        base = os.path.join(accelerator.project_dir or ".", "checkpoints")
        input_dir = find_latest_complete(base)
        if input_dir is None:
            raise FileNotFoundError(f"No complete checkpoint in {base}")
    if input_dir is None:
        raise ValueError("input_dir required")
    t0 = time.perf_counter()
    manifest = read_manifest(input_dir)
    if verify and manifest is not None:
        manifest = verify_checkpoint(input_dir)
    manifest = manifest or {}
    t1 = time.perf_counter()
    topology = manifest.get(elastic.TOPOLOGY_KEY)
    _elastic_plan(accelerator, input_dir, topology)

    for hook in list(accelerator._load_state_pre_hooks.values()):
        hook(accelerator._models, input_dir)
    for i, model in enumerate(accelerator._models):
        sharded_dir = os.path.join(input_dir, _dir_name("orbax", i))
        local_dir = os.path.join(input_dir, _dir_name("local", i))
        if os.path.isdir(sharded_dir):
            load_sharded_model(model, sharded_dir)
        elif os.path.isdir(local_dir):
            load_local_model(model, local_dir)
        else:
            load_model_weights(model, input_dir,
                               weights_name=_named(MODEL_NAME, i, "safetensors"))
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
        _restore_loader(accelerator, i, dl, input_dir, topology, manifest.get("step"))
    for i, obj in enumerate(accelerator._custom_objects):
        load_custom_state(obj, input_dir, i)
    if not elastic.restore_rng_for_rank(input_dir, accelerator.process_index, topology):
        path = os.path.join(input_dir, "random_states_0.pkl")
        if topology is None and os.path.exists(path):
            # A legacy checkpoint: the JAX package's best effort, rank 0's streams.
            set_rng_state(_load(path))
    if any(t.device.type == "cuda" for m in accelerator._models for t in m.parameters()):
        torch.cuda.synchronize()
    accelerator.last_load_timing = {"verify_s": t1 - t0,
                                    "read_place_s": time.perf_counter() - t1}
    logger.info(f"Loaded accelerator state from {input_dir}")
    return input_dir
