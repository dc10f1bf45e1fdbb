"""Elastic topology resume: a checkpoint lands on another mesh and world size.

The JAX package's ``resilience/elastic.py``.  The consolidated checkpoint
payload is topology-portable already (the weights and ``optimizer.bin``
are gathered to full shapes on save, and a load cuts each leaf to the live
layout); this module is the contract around it:

- :func:`capture_topology` — the record ``save_state`` writes into every
  verified manifest: schema version, the mesh's axes and degrees, the
  world size, each leaf's full shape, dtype and spec for the parameters and
  the optimizer state (a ZeRO state's placement on the dp axes included),
  the pipeline geometry, the RNG stream count and the global batch each
  prepared loader fed.  In the port every rank is a process, so
  ``world_size`` and ``device_count`` are both the number of ranks.
- :func:`plan_resume` — the saved record against the live accelerator: a
  mesh reshape, a world-size change or ZeRO on or off gives an
  :class:`ElasticPlan`; a pipeline stage-count or virtual-stage change, or
  a record newer than this library, raises :class:`ElasticTopologyError`.
- :func:`validate_leaves` — each saved leaf against the live trees, before
  anything is restored, naming every offending leaf.
- :func:`reshard_tree` — re-slice host or live tensors onto a target
  layout (the in-memory form of what a load does from the gathered
  payload).
- :func:`fold_rng_bundle` — the RNG streams of a rank that has no saved
  ``random_states_<rank>.pkl``: the SHA-256 fold of (seed, old world, new
  world, rank) the JAX package uses, so the python and numpy streams equal
  JAX's for the same inputs; the torch CPU and CUDA generators are seeded
  from the same fold.
- :func:`recompute_skip_batches` — the ``skip_first_batches`` count under
  the new global batch (raises when the examples seen do not end on a
  batch boundary of it).
- :func:`state_digest` — SHA-256 over every parameter and optimizer-state
  leaf gathered to full shapes, in one canonical order: the same state
  gives the same digest under any layout (replicated, ZeRO, ``fsdp``).  It
  gathers, so every process calls it.

``Accelerator.resume_from_latest`` drives all of this and keeps an
:class:`ElasticResumeInfo` on ``accelerator.last_resume_info``; a
cross-topology load emits the ``elastic.reshard`` event and counts
``elastic.reshards``.  A checkpoint with no topology record resumes on the
legacy path, with a warning.  The elastic smoke (:mod:`.elastic_smoke`)
and the chaos campaign (:mod:`.chaos`) prove it end to end.
"""

from __future__ import annotations

import hashlib
import logging
import os
import random as _random
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = [
    "TOPOLOGY_KEY",
    "TOPOLOGY_SCHEMA_VERSION",
    "ElasticTopologyError",
    "ElasticPlan",
    "ElasticResumeInfo",
    "capture_topology",
    "describe_mesh",
    "plan_resume",
    "validate_leaves",
    "reshard_tree",
    "fold_rng_bundle",
    "recompute_skip_batches",
    "state_digest",
]

# The manifest key of the record (beside ``opt_state_layout``).
TOPOLOGY_KEY = "topology"
# Loaders reject records newer than they understand.
TOPOLOGY_SCHEMA_VERSION = 1


class ElasticTopologyError(RuntimeError):
    """A checkpoint cannot legally land on the current topology (pipeline
    stage-count change, leaf shape/dtype mismatch, non-divisible batch
    geometry, or a topology record newer than this library)."""


# ---------------------------------------------------------------------------
# Capture (save side)
# ---------------------------------------------------------------------------


def describe_mesh(mesh) -> dict:
    """The mesh's axis names and degrees, every axis in order (size-1 ones
    too: the order is part of the layout)."""
    if mesh is None:
        return {"axes": [], "shape": []}
    return {"axes": [str(a) for a in mesh.axis_names],
            "shape": [int(mesh.shape[a]) for a in mesh.axis_names]}


def _spec_json(spec) -> Optional[list]:
    """A spec as JSON, one entry per dim (a name, a list of names, or
    None); None when nothing is split."""
    if spec is None or all(e is None for e in spec):
        return None
    return [None if e is None else (str(e) if isinstance(e, str) else [str(a) for a in e])
            for e in spec]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _leaf_record(leaf: torch.Tensor, shape=None, spec=None) -> dict:
    """Full shape, dtype and spec of a leaf (``shape``/``spec`` override
    what the leaf carries: a ZeRO state shard's are its parameter's)."""
    from ..parallel.sharding import spec_of

    if spec is None:
        spec = spec_of(leaf)
    if shape is None:
        shape = getattr(leaf, "_full_shape", None) or tuple(leaf.shape)
    return {"shape": [int(s) for s in shape], "dtype": _dtype_name(leaf),
            "spec": _spec_json(spec)}


def _module(model):
    from ..utils.modeling import PreparedModel

    return model.module if isinstance(model, PreparedModel) else model


def _model_leaves(model) -> dict:
    """Each state-dict entry of ``model`` under its checkpoint name."""
    return {name: _leaf_record(t) for name, t in
            _module(model).state_dict(keep_vars=True).items() if isinstance(t, torch.Tensor)}


def _opt_leaves(opt) -> list:
    """Each optimizer-state tensor, per parameter in the groups' order, its
    keys sorted, with its full shape and spec."""
    from ..parallel import zero as zero_mod
    from ..parallel.sharding import spec_of

    zs = getattr(opt, "_zero", None)
    layout = getattr(opt, "_opt_state_layout", None) or {}
    state = opt.optimizer.state
    groups = [p for g in opt.optimizer.param_groups for p in g["params"]]
    full = opt.params if zs is not None else groups
    out = []
    for p, shard in zip(full, groups):
        st = state.get(shard)
        if not st:
            continue
        for k in sorted(st):
            v = st[k]
            if not isinstance(v, torch.Tensor):
                continue
            if zs is not None and zs.is_sharded_state(p, v):
                axes = tuple(layout.get("axes") or zero_mod.ZERO_AXES)
                spec = zero_mod.shard_spec(tuple(p.shape), axes, zs.degree)
                out.append(_leaf_record(v, shape=tuple(p.shape), spec=spec))
            elif v.dim() > 0 and tuple(v.shape) == tuple(p.shape) and spec_of(p) is not None:
                out.append(_leaf_record(v, shape=getattr(p, "_full_shape", None),
                                        spec=spec_of(p)))
            else:
                out.append(_leaf_record(v))
    return out


def _loader_batches(accelerator) -> list:
    out = []
    for dl in getattr(accelerator, "_dataloaders", []):
        try:
            out.append(int(dl.total_batch_size))
        except Exception:
            out.append(None)
    return out


def capture_topology(accelerator, step: Optional[int] = None) -> dict:
    """The manifest's topology record of the live accelerator (metadata
    only: nothing is copied or gathered).  ``data.loader_positions`` adds
    each stateful loader's position (batches of the global batch, shared by
    every rank), the one a rank with no saved position of its own takes."""
    from ..utils.random import seed_of_record

    state = accelerator.state
    mesh = getattr(state, "mesh", None)
    pcfg = getattr(state, "parallelism_config", None)
    world = int(state.num_processes)
    models = {str(i): _model_leaves(m) for i, m in enumerate(getattr(accelerator, "_models", []))}
    optimizers = [{"layout": dict(getattr(opt, "_opt_state_layout", None)
                                  or {"kind": "replicated", "axes": [], "degree": 1}),
                   "leaves": _opt_leaves(opt)}
                  for opt in getattr(accelerator, "_optimizers", [])]
    batches = _loader_batches(accelerator)
    positions = [dl.state_dict() if getattr(dl, "use_stateful_dataloader", False) else None
                 for dl in getattr(accelerator, "_dataloaders", [])]
    return {
        "schema": TOPOLOGY_SCHEMA_VERSION,
        "step": step,
        "world_size": world,
        "device_count": world,
        "mesh": describe_mesh(mesh),
        "parallelism": dict(pcfg.active_axes) if pcfg is not None else {},
        "pp": {"degree": int(getattr(pcfg, "pp", 1) or 1) if pcfg is not None else 1,
               "virtual_stages": 1},
        "models": models,
        "optimizers": optimizers,
        "rng": {"jax_seed": seed_of_record(), "streams": world},
        "data": {"global_batch_size": batches[0] if batches else None,
                 "loader_batches": batches, "loader_positions": positions},
    }


# ---------------------------------------------------------------------------
# Plan / validate (load side)
# ---------------------------------------------------------------------------


@dataclass
class ElasticPlan:
    """What changes between the saved topology and the live one.  ``changed``
    gates the ``elastic.reshard`` event; ``changes`` is human-readable, one
    entry per migrated dimension."""

    changed: bool = False
    changes: list = field(default_factory=list)
    saved_mesh: dict = field(default_factory=dict)
    live_mesh: dict = field(default_factory=dict)
    saved_world: int = 1
    live_world: int = 1
    saved_global_batch: Optional[int] = None
    # The layout each optimizer's state was saved under.  Not compared with
    # the live optimizer's: that is provisional until the next
    # make_train_step decides ZeRO.
    saved_opt_layouts: list = field(default_factory=list)
    schema: int = TOPOLOGY_SCHEMA_VERSION


def _live_pp(accelerator) -> tuple:
    pcfg = getattr(accelerator.state, "parallelism_config", None)
    pp = int(getattr(pcfg, "pp", 1) or 1) if pcfg is not None else 1
    return pp, 1


def plan_resume(topology: dict, accelerator) -> ElasticPlan:
    """Compare a manifest topology record with the live accelerator: the
    migration plan, or :class:`ElasticTopologyError` for a record newer than
    this library or a pipeline stage-count / virtual-stage change (the
    stacked pipelined parameters are another tree, not a relayout)."""
    schema = topology.get("schema")
    if not isinstance(schema, int) or schema < 1:
        raise ElasticTopologyError(
            f"checkpoint topology record has no valid schema version ({schema!r})")
    if schema > TOPOLOGY_SCHEMA_VERSION:
        raise ElasticTopologyError(
            f"checkpoint topology record is schema v{schema}, this library "
            f"understands up to v{TOPOLOGY_SCHEMA_VERSION} — upgrade "
            "accelerate_tpu_torch to resume this checkpoint")
    saved_pp = topology.get("pp") or {}
    saved_pp_degree = int(saved_pp.get("degree", 1) or 1)
    saved_virtual = int(saved_pp.get("virtual_stages", 1) or 1)
    live_pp_degree, live_virtual = _live_pp(accelerator)
    if (saved_pp_degree, saved_virtual) != (live_pp_degree, live_virtual):
        raise ElasticTopologyError(
            "pipeline stage geometry is not elastic: checkpoint was saved with "
            f"pp={saved_pp_degree} x virtual_stages={saved_virtual}, the live mesh "
            f"runs pp={live_pp_degree} x virtual_stages={live_virtual}.  Pipelined "
            "parameters are stacked [stages, layers/stage, ...], so a stage-count "
            "change is a different parameter tree, not a resharding — re-export "
            "the checkpoint through the model's unstacked state_dict() (pp=1 "
            "layout) and re-stack it under the new schedule.")
    live_world = int(accelerator.state.num_processes)
    plan = ElasticPlan(
        saved_mesh=dict(topology.get("mesh") or {}),
        live_mesh=describe_mesh(getattr(accelerator.state, "mesh", None)),
        saved_world=int(topology.get("world_size", 1) or 1),
        live_world=live_world,
        saved_global_batch=(topology.get("data") or {}).get("global_batch_size"),
        schema=schema)

    def _active(rec: dict) -> dict:
        return {a: s for a, s in zip(rec.get("axes", []), rec.get("shape", [])) if s and s > 1}

    saved_axes, live_axes = _active(plan.saved_mesh), _active(plan.live_mesh)
    if saved_axes != live_axes:
        plan.changes.append(f"mesh {saved_axes or '{}'} -> {live_axes or '{}'}")
    if plan.saved_world != plan.live_world:
        plan.changes.append(f"world_size {plan.saved_world} -> {plan.live_world}")
    saved_devices = topology.get("device_count")
    if saved_devices is not None and saved_devices != live_world:
        plan.changes.append(f"device_count {saved_devices} -> {live_world}")
    plan.saved_opt_layouts = [dict(o.get("layout") or {})
                              for o in (topology.get("optimizers") or [])]
    plan.changed = bool(plan.changes)
    return plan


def _shapes_agree(a: list, b: list) -> bool:
    """Shape equality, with the JAX package's one tolerance: a 0-d leaf
    may read ``[]`` on one side and ``[1]`` on the other."""
    if a == b:
        return True
    return sorted((tuple(a), tuple(b))) == [(), (1,)]


def validate_leaves(topology: dict, accelerator) -> None:
    """Every saved parameter leaf must exist on the live model with the same
    full shape and dtype, and the optimizer state must agree in count and
    shape, before anything is restored; :class:`ElasticTopologyError`
    names every offending leaf.  A live optimizer that has taken no step
    holds no state yet (torch builds it at the first update), so only its
    count of saved leaves is left unchecked."""
    problems: list = []
    live_models = getattr(accelerator, "_models", [])
    for key, saved_leaves in (topology.get("models") or {}).items():
        try:
            idx = int(key)
        except ValueError:
            continue
        if idx >= len(live_models):
            logger.warning(f"checkpoint carries model {idx} but only {len(live_models)} "
                           "model(s) are prepared live; the extra payload is ignored.")
            continue
        live_leaves = _model_leaves(live_models[idx])
        for name, rec in saved_leaves.items():
            live = live_leaves.get(name)
            if live is None:
                problems.append(f"model {idx} leaf {name}: missing on the live model")
            elif not _shapes_agree(live["shape"], rec["shape"]):
                problems.append(f"model {idx} leaf {name}: saved shape {rec['shape']}, "
                                f"live {live['shape']}")
            elif live["dtype"] != rec["dtype"]:
                problems.append(f"model {idx} leaf {name}: saved dtype {rec['dtype']}, "
                                f"live {live['dtype']}")
        for name in live_leaves:
            if name not in saved_leaves:
                problems.append(f"model {idx} leaf {name}: live model has it, checkpoint "
                                "does not")
    live_opts = getattr(accelerator, "_optimizers", [])
    for i, saved_opt in enumerate(topology.get("optimizers") or []):
        if i >= len(live_opts):
            logger.warning(f"checkpoint carries optimizer {i} but only {len(live_opts)} "
                           "optimizer(s) are prepared live; the extra payload is ignored.")
            continue
        saved_leaves = saved_opt.get("leaves") or []
        live_leaves = _opt_leaves(live_opts[i])
        if not saved_leaves or not live_leaves:
            continue
        if len(live_leaves) != len(saved_leaves):
            problems.append(
                f"optimizer {i}: checkpoint carries {len(saved_leaves)} opt-state "
                f"leaves, live optimizer has {len(live_leaves)} — different "
                "optimizer family?")
            continue
        for j, (saved, live) in enumerate(zip(saved_leaves, live_leaves)):
            if not _shapes_agree(saved["shape"], live["shape"]):
                problems.append(f"optimizer {i} opt-state leaf {j}: saved shape "
                                f"{saved['shape']}, live {live['shape']}")
    if problems:
        raise ElasticTopologyError(
            "checkpoint cannot land on the live trees (" + "; ".join(problems[:20])
            + (f"; ... {len(problems) - 20} more" if len(problems) > 20 else "") + ")")


# ---------------------------------------------------------------------------
# Relayout
# ---------------------------------------------------------------------------


def _target_spec(tgt):
    """The spec a target leaf names (a spec tuple, a ``NamedSharding``, or
    a tensor whose spec is taken), or ``False`` when it names no layout."""
    from ..parallel.sharding import NamedSharding, spec_of

    if isinstance(tgt, NamedSharding):
        return tgt.spec
    if isinstance(tgt, torch.Tensor):
        return spec_of(tgt)
    if isinstance(tgt, tuple):
        return tgt
    return False


def reshard_tree(tree: Any, target: Any, mesh=None) -> Any:
    """Each leaf of ``tree`` (a nested dict or list of tensors: full host
    tensors, or live shards carrying their spec) re-sliced onto the layout
    of the matching leaf of ``target``: a spec tuple, a ``NamedSharding``,
    or a tensor whose spec is taken.  A sharded leaf is gathered first (a
    collective); the result carries its spec and full shape, as
    ``prepare``'s shards do.  Leaves whose target names no layout (None)
    pass through unchanged.  ``mesh``: the live state's by default."""
    from ..parallel.sharding import gather_full, is_sharded, local_slice, spec_of
    from ..state import AcceleratorState

    mesh = mesh or AcceleratorState._shared_state.get("mesh")

    def one(leaf, tgt):
        spec = _target_spec(tgt)
        if spec is False or not isinstance(leaf, torch.Tensor):
            return leaf
        full = leaf.detach()
        if is_sharded(spec_of(leaf)) and mesh is not None:
            full = gather_full(leaf, spec_of(leaf), mesh)
        if mesh is None or not is_sharded(spec):
            return full.clone()
        out = local_slice(full, spec, mesh).contiguous().clone()
        out._spec = tuple(spec)
        out._full_shape = tuple(full.shape)
        return out

    def walk(node, tgt):
        if isinstance(node, dict):
            return {k: walk(v, (tgt or {}).get(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, t) for v, t in zip(node, tgt or [None] * len(node)))
        return one(node, tgt)

    return walk(tree, target)


# ---------------------------------------------------------------------------
# RNG stream folding
# ---------------------------------------------------------------------------


def fold_rng_bundle(bundle: dict, rank: int, new_world: int, old_world: int) -> dict:
    """A deterministic RNG bundle for a rank with no saved
    ``random_states_<rank>.pkl`` (a resume on more processes than saved).
    The python and numpy streams are the JAX package's fold of (the
    bundle's seed, old world, new world, rank) through SHA-256:
    reproducible for one transition, distinct per rank, never a copy of
    another rank's stream.  The torch CPU generator (and each CUDA one, when
    the bundle carries CUDA states) is seeded from the same fold."""
    seed0 = bundle.get("jax_seed")
    digest = hashlib.sha256(
        f"elastic-rng:{seed0}:{old_world}->{new_world}:rank{rank}".encode()).hexdigest()
    derived = int(digest[:16], 16)
    out = {"python": _random.Random(derived).getstate(),
           "numpy": np.random.RandomState(derived % (2**32)).get_state(),
           "jax_seed": seed0}
    if "torch" in bundle:
        gen = torch.Generator()
        gen.manual_seed(derived % (2**63))
        out["torch"] = gen.get_state()
    if "cuda" in bundle and torch.cuda.is_available():
        states = []
        for i in range(torch.cuda.device_count()):
            gen = torch.Generator(device=f"cuda:{i}")
            gen.manual_seed(derived % (2**63))
            states.append(gen.get_state())
        out["cuda"] = states
    return out


# ---------------------------------------------------------------------------
# Dataloader geometry
# ---------------------------------------------------------------------------


def recompute_skip_batches(saved_step: Optional[int], saved_global_batch: Optional[int],
                           new_global_batch: Optional[int]) -> Optional[int]:
    """``skip_first_batches`` count under the new global batch: the
    ``saved_step * saved_global_batch`` examples seen must end on one of its
    batch boundaries (else :class:`ElasticTopologyError`); None when either
    geometry is unknown."""
    if not saved_step or not saved_global_batch or not new_global_batch:
        return None
    examples = int(saved_step) * int(saved_global_batch)
    if examples % int(new_global_batch):
        raise ElasticTopologyError(
            f"dataloader geometry does not reshape: the saved run consumed "
            f"{examples} examples ({saved_step} steps x global batch "
            f"{saved_global_batch}), which is not a whole number of new global "
            f"batches ({new_global_batch}).  Pick a global batch size that "
            f"divides {examples}, or resume at an epoch boundary.")
    return examples // int(new_global_batch)


# ---------------------------------------------------------------------------
# Digest (smoke/chaos oracle)
# ---------------------------------------------------------------------------


def _tensor_bytes(t: torch.Tensor):
    """A tensor's bytes on the host, as a buffer (no copy of a host tensor)."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return t.view(torch.uint8).numpy()


def _leaf_digest(label: str, value) -> bytes:
    h = hashlib.sha256(label.encode())
    h.update(_tensor_bytes(value) if isinstance(value, torch.Tensor) else repr(value).encode())
    return h.digest()


def state_digest(accelerator) -> str:
    """SHA-256 over every model leaf (gathered to its full shape, by name in
    sorted order) and every optimizer-state value (the gathered
    ``state_dict``: per parameter in order, keys sorted), with each
    optimizer's update count: each leaf is hashed with its label (on a pool
    of threads), and the digest is the SHA-256 of those leaf digests in that
    order.  Two accelerators hold bit-identical state iff their digests
    match, whatever their layouts.  A collective where the state is sharded:
    every process calls it and takes part in the gathers; the main process
    hashes and every process gets its digest."""
    from concurrent.futures import ThreadPoolExecutor

    hashing = accelerator.is_main_process
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        parts = []

        def add(label, value):
            if hashing:
                parts.append(pool.submit(_leaf_digest, label, value))

        for i, model in enumerate(getattr(accelerator, "_models", [])):
            full = accelerator.get_state_dict(model)
            for name in sorted(full):
                add(f"m{i}:{name}", full[name])
            del full
        for i, opt in enumerate(getattr(accelerator, "_optimizers", [])):
            sd = opt.state_dict()
            add(f"o{i}:count", sd.get("step_count", 0))
            for idx in sorted(sd["optimizer"]["state"], key=int):
                st = sd["optimizer"]["state"][idx]
                for k in sorted(st):
                    add(f"o{i}:{idx}:{k}", st[k])
            del sd
        h = hashlib.sha256()
        for part in parts:
            h.update(part.result())
    digest = h.hexdigest() if hashing else None
    if accelerator.num_processes > 1:
        from ..utils.operations import broadcast_object_list

        digest = broadcast_object_list([digest])[0]
    return digest


# ---------------------------------------------------------------------------
# Resume info (stored on the accelerator by resume_from_latest)
# ---------------------------------------------------------------------------


@dataclass
class ElasticResumeInfo:
    """What ``resume_from_latest`` did: the resumed step, the migration plan
    (None for legacy topology-less checkpoints), and the recomputed
    ``skip_first_batches`` count for the live loader geometry (None when
    either side's geometry is unknown)."""

    step: int = 0
    checkpoint: Optional[str] = None
    plan: Optional[ElasticPlan] = None
    legacy: bool = False
    skip_batches: Optional[int] = None

    @property
    def resharded(self) -> bool:
        return self.plan is not None and self.plan.changed


def restore_rng_for_rank(input_dir: str, process_index: int, topology: Optional[dict]) -> bool:
    """Restore ``random_states_<rank>.pkl`` when present; when absent and
    the checkpoint carries a topology record, fold a stream for this rank
    from rank 0's bundle (the world grew).  Returns True when any RNG state
    was restored; a legacy checkpoint leaves a rank without a file
    untouched."""
    from ..checkpointing import _load
    from ..utils.random import set_rng_state

    path = os.path.join(input_dir, f"random_states_{process_index}.pkl")
    if os.path.exists(path):
        set_rng_state(_load(path))
        return True
    if topology is None:
        return False
    base_path = os.path.join(input_dir, "random_states_0.pkl")
    if not os.path.exists(base_path):
        return False
    base = _load(base_path)
    old_world = int(topology.get("world_size", 1) or 1)
    from ..state import PartialState

    new_world = int(PartialState._shared_state.get("num_processes", old_world))
    set_rng_state(fold_rng_bundle(base, rank=process_index, new_world=new_world,
                                  old_world=old_world))
    logger.warning(
        f"no saved RNG stream for process {process_index} (checkpoint saved "
        f"{old_world} streams); derived a deterministic elastic stream by "
        f"folding (seed, {old_world}->{new_world}, rank).")
    return True
