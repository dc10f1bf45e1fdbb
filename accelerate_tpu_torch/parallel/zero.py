"""Cross-replica sharded weight update (ZeRO): the JAX ``parallel/zero.py``.

Under pure data parallelism every process holds a full replica of the
parameters and of the optimizer state, and every optimizer step recomputes
the same update on all of them.  The sharded update
(arXiv:2004.13336) instead:

- **reduce-scatters** each gradient over the data-parallel group (the
  ``dcn_dp`` x ``dp`` axes), so each process receives only the summed
  shard it will update;
- runs the health gate, the clips and the optimizer **on the local
  shard**: the optimizer's state lives sharded across steps, which divides
  its bytes per process by the dp degree;
- **all-gathers** the updated parameters back to full replicas for the
  next forward.

The shard rule is the JAX package's, leaf for leaf: :func:`shard_dim` is
the largest dim divisible by the degree, ties to the lowest index, and a
leaf with none stays replicated (its gradient is all-reduced and its update
runs in full on every process).  ``reduce_scatter`` splits dim 0 of a
contiguous buffer, so :class:`ZeroShards` moves the shard dim to the front
of the buffer it sends and moves it back in what it receives.

Numerics: the update is elementwise, so sharding it changes nothing; the
global-norm clip reduces over the whole gradient, and a reduction's result
depends on its association order.  :func:`chunked_global_norm` fixes one
order for both layouts: per leaf, the sum of squares of each of the
``degree`` chunks along the shard dim (each chunk made contiguous, so a
replica and a shard reduce the same tensor), summed over leaves in tree
order, the ``degree`` partials combined left to right, then the replicated
leaves added.  ``optimizer._update_body`` uses it whenever the mesh has an
active dp axis, in the replicated step too, which is what makes the
sharded step bit-exact against it.

The gradient sync is one collective per leaf, issued after the backward:
overlapping it with the backward (the JAX package's latency-hiding flags,
on its own stream here) is not done yet, so :func:`enable_overlap_flags`
is a no-op on this backend (ROADMAP A6).

Scope: ZeRO engages on the dp axes of a mesh with no active model axis
(:func:`supported` gives the JAX package's reasons when it declines).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Optional, Sequence

import torch

__all__ = [
    "ENV_ZERO",
    "ENV_ZERO_OVERLAP",
    "ZERO_AXES",
    "ZeROConfig",
    "zero_axes",
    "zero_degree",
    "shard_dim",
    "shard_spec",
    "shard_shape",
    "chunked_global_norm",
    "shard_opt_state",
    "opt_state_shardings",
    "opt_state_layout",
    "per_chip_bytes",
    "supported",
    "enable_overlap_flags",
    "LATENCY_HIDING_TPU_FLAGS",
]

logger = logging.getLogger(__name__)

ENV_ZERO = "ACCELERATE_TPU_ZERO"
ENV_ZERO_OVERLAP = "ACCELERATE_TPU_ZERO_OVERLAP"

_TRUTHY = {"1", "true", "yes", "on"}

# The pure data-parallel axes the update may be sharded over.
ZERO_AXES = ("dcn_dp", "dp")

# Model axes whose activity disqualifies the sharded update.
_MODEL_AXES = ("fsdp", "pp", "sp", "ep", "tp")

# The JAX package composes XLA's latency-hiding flags here; no backend of
# the port reads any, so the tuple is empty.
LATENCY_HIDING_TPU_FLAGS: tuple = ()


def _env_truthy(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in _TRUTHY


@dataclasses.dataclass
class ZeROConfig:
    """How ``make_train_step`` shards the weight update.

    ``enabled``: shard the update across the dp axes (``ACCELERATE_TPU_ZERO=1``
    is the env spelling).  ``overlap``: overlap the per-leaf collectives with
    the backward (default follows ``enabled`` unless
    ``ACCELERATE_TPU_ZERO_OVERLAP=0``; nothing overlaps yet on this backend).
    """

    enabled: bool = False
    overlap: Optional[bool] = None

    @classmethod
    def from_env(cls) -> "ZeROConfig":
        enabled = _env_truthy(ENV_ZERO)
        overlap = None
        if os.environ.get(ENV_ZERO_OVERLAP) is not None:
            overlap = _env_truthy(ENV_ZERO_OVERLAP)
        return cls(enabled=enabled, overlap=overlap)

    @classmethod
    def resolve(cls, zero) -> "ZeROConfig":
        """Normalize a ``make_train_step(zero=...)`` argument: None defers to
        the env, a bool toggles, a ZeROConfig passes through."""
        if zero is None:
            return cls.from_env()
        if isinstance(zero, ZeROConfig):
            return zero
        return cls(enabled=bool(zero))

    @property
    def overlap_effective(self) -> bool:
        return self.enabled if self.overlap is None else self.overlap


# ---------------------------------------------------------------------------
# Shard geometry
# ---------------------------------------------------------------------------


def zero_axes(mesh) -> tuple:
    """Active (size > 1) data-parallel axes the update can shard over."""
    if mesh is None:
        return ()
    return tuple(a for a in ZERO_AXES if a in mesh.axis_names and mesh.shape[a] > 1)


def zero_degree(mesh) -> int:
    """Total shard count across the active ZeRO axes (1 = nothing to shard)."""
    n = 1
    for a in zero_axes(mesh):
        n *= mesh.shape[a]
    return n


def shard_dim(shape: Sequence[int], degree: int) -> Optional[int]:
    """The dimension a leaf is sharded (and its norm chunked) along: the
    largest dim divisible by ``degree`` (ties break to the lowest index).
    None = the leaf stays replicated."""
    shape = tuple(shape)
    if degree <= 1 or not shape:
        return None
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % degree == 0 and shape[i] >= degree:
            return i
    return None


def shard_spec(shape: Sequence[int], axes: tuple, degree: int) -> tuple:
    """The leaf's spec (one entry per dim, the JAX ``PartitionSpec`` as a
    tuple): the ZeRO axes on its shard dim, None elsewhere."""
    d = shard_dim(shape, degree)
    entries: list = [None] * len(tuple(shape))
    if d is not None and axes:
        entries[d] = tuple(axes) if len(axes) > 1 else axes[0]
    return tuple(entries)


def shard_shape(shape: Sequence[int], degree: int) -> tuple:
    """Per-process shape of a leaf under the ZeRO sharding rule."""
    d = shard_dim(shape, degree)
    if d is None:
        return tuple(shape)
    out = list(shape)
    out[d] //= degree
    return tuple(out)


def _chunk(t: torch.Tensor, d: int, k: int, degree: int) -> torch.Tensor:
    """Chunk ``k`` of ``degree`` of ``t`` along ``d``, contiguous."""
    c = t.shape[d] // degree
    return t.narrow(d, k * c, c).contiguous()


def _sumsq(t: torch.Tensor, fence: Optional[torch.Tensor]) -> torch.Tensor:
    sq = t.float().square()
    if fence is not None:
        sq = torch.where(fence, sq, torch.zeros_like(sq))
    return sq.sum()


# ---------------------------------------------------------------------------
# Canonical (layout-independent) global norm
# ---------------------------------------------------------------------------


def _sequential_combine(vec: torch.Tensor, degree: int) -> torch.Tensor:
    """Sum a ``[degree]`` chunk-partial vector in strict left-to-right order
    (``((c0 + c1) + c2) + ...``; the JAX package's ``fori_loop`` above 64
    chunks keeps the same association)."""
    total = vec[0]
    for k in range(1, degree):
        total = total + vec[k]
    return total


def chunked_global_norm(tree: Any, degree: int, fence: Optional[torch.Tensor] = None):
    """Global L2 norm of a gradient tree (a tensor, a list or a dict of
    them) in the canonical dp-chunked association (module docstring), as
    an fp32 scalar.  ``fence`` (a bool scalar) selects each squared term
    against 0, as the JAX ``fence`` does."""
    chunk_vec = None
    rep_total = None
    from .sharding import _leaves

    for g in _leaves(tree, torch.Tensor):
        d = shard_dim(tuple(g.shape), degree)
        if d is None:
            s = _sumsq(g, fence)
            rep_total = s if rep_total is None else rep_total + s
        else:
            v = torch.stack([_sumsq(_chunk(g, d, k, degree), fence) for k in range(degree)])
            chunk_vec = v if chunk_vec is None else chunk_vec + v
    return _finish_norm(chunk_vec, rep_total, degree)


def _finish_norm(chunk_vec, rep_total, degree: int) -> torch.Tensor:
    if chunk_vec is not None:
        total = _sequential_combine(chunk_vec, degree)
    else:
        total = torch.zeros((), dtype=torch.float32,
                            device=rep_total.device if rep_total is not None else None)
    if rep_total is not None:
        total = total + rep_total
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# The sharded update's layout over one optimizer's parameters
# ---------------------------------------------------------------------------


class ZeroShards:
    """The shards of one optimizer's parameters on this process: ``dims``
    (the shard dim of each parameter, None when replicated) and ``shards``
    (for a sharded parameter, the view of this process's chunk of it that
    the optimizer updates in place; for a replicated one the parameter
    itself).

    :meth:`scatter` turns full local gradients into this process's averaged
    shards, :meth:`global_norm` is :func:`chunked_global_norm` over them
    (one all-gather of a scalar per process), :meth:`gather` writes the
    updated shards back into the full parameters."""

    def __init__(self, params: Sequence[torch.Tensor], degree: int, group=None,
                 sync_dtype: Optional[torch.dtype] = None):
        from . import collectives

        self.params = list(params)
        self.degree = degree
        self.group = group
        self.rank = collectives.rank(group)
        self.sync_dtype = sync_dtype
        self.dims = [shard_dim(tuple(p.shape), degree) for p in self.params]
        self._index = {id(p): i for i, p in enumerate(self.params)}
        # A shard is a view of this process's chunk of its parameter: the
        # optimizer updates it in place, so the full parameter is its master
        # (a weight loaded into the parameter is the shard's too).
        self.shards = [p if d is None else p.detach().narrow(d, self.rank * (p.shape[d] // degree),
                                                             p.shape[d] // degree)
                       for p, d in zip(self.params, self.dims)]

    def shard_of(self, p: torch.Tensor) -> torch.Tensor:
        return self.shards[self._index[id(p)]]

    def dim_of(self, p: torch.Tensor) -> Optional[int]:
        return self.dims[self._index[id(p)]]

    def scatter(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]):
        """``(shards, shard_grads)`` for the live ``params``: each gradient
        summed over the group (reduce-scatter along its shard dim, or an
        all-reduce for a replicated leaf), divided by the group's size."""
        from . import collectives

        out_p, out_g = [], []
        for p, g in zip(params, grads):
            d = self.dim_of(p)
            work = g if self.sync_dtype is None else g.to(self.sync_dtype)
            if d is None:
                work = collectives.all_reduce(work.clone(), group=self.group)
                mine = work
            else:
                buf = work.movedim(d, 0).contiguous()
                mine = collectives.reduce_scatter(buf, group=self.group).movedim(0, d)
            mine = mine.div(self.degree).contiguous().to(g.dtype)  # as _sync_grads' div_
            out_p.append(self.shard_of(p))
            out_g.append(mine)
        return out_p, out_g

    def global_norm(self, shard_grads: Sequence[torch.Tensor],
                    params: Sequence[torch.Tensor]) -> torch.Tensor:
        """:func:`chunked_global_norm` of the full averaged gradients, from
        this process's shards: its chunk's partial over the sharded leaves,
        all-gathered (one scalar per process), combined, plus the replicated
        leaves."""
        from . import collectives

        mine = None
        rep_total = None
        for p, g in zip(params, shard_grads):
            s = _sumsq(g, None)
            if self.dim_of(p) is None:
                rep_total = s if rep_total is None else rep_total + s
            else:
                mine = s if mine is None else mine + s
        vec = None
        if mine is not None:
            vec = collectives.all_gather(mine, group=self.group)
        return _finish_norm(vec, rep_total, self.degree)

    @torch.no_grad()
    def gather(self, params: Sequence[torch.Tensor]) -> None:
        """All-gather each sharded parameter's updated shard into the full
        parameter (a replicated one was updated in place)."""
        from . import collectives

        for p in params:
            d = self.dim_of(p)
            if d is None:
                continue
            shard = self.shard_of(p)
            full = collectives.all_gather(shard.movedim(d, 0).contiguous(), group=self.group)
            moved = (p.shape[d],) + tuple(s for i, s in enumerate(p.shape) if i != d)
            p.data.copy_(full.view(moved).movedim(0, d))

    def gather_like(self, p: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        """A state tensor shaped like ``p``'s shard, gathered to ``p``'s
        full shape (a new tensor)."""
        from . import collectives

        d = self.dim_of(p)
        full = collectives.all_gather(value.movedim(d, 0).contiguous(), group=self.group)
        moved = (p.shape[d],) + tuple(s for i, s in enumerate(p.shape) if i != d)
        return full.view(moved).movedim(0, d).contiguous()

    def slice_like(self, p: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        """This process's chunk of a tensor shaped like ``p``."""
        return _chunk(value, self.dim_of(p), self.rank, self.degree)

    def is_sharded_state(self, p: torch.Tensor, value) -> bool:
        d = self.dim_of(p)
        return (d is not None and isinstance(value, torch.Tensor)
                and tuple(value.shape) == tuple(self.shard_of(p).shape))

    def is_full_state(self, p: torch.Tensor, value) -> bool:
        return (self.dim_of(p) is not None and isinstance(value, torch.Tensor)
                and tuple(value.shape) == tuple(p.shape))


# ---------------------------------------------------------------------------
# Optimizer-state placement
# ---------------------------------------------------------------------------


def opt_state_shardings(opt_state: Any, mesh) -> Any:
    """The shard dim of every state tensor of ``opt_state`` (a torch
    optimizer's ``state`` mapping, param -> {name: tensor}): the same
    structure with each tensor replaced by its spec under the ZeRO rule
    (None for a tensor that stays whole, such as a scalar ``step``)."""
    axes = zero_axes(mesh)
    degree = zero_degree(mesh)

    def one(v):
        if not isinstance(v, torch.Tensor) or shard_dim(tuple(v.shape), degree) is None:
            return None
        return shard_spec(tuple(v.shape), axes, degree)

    return {k: ({n: one(v) for n, v in st.items()} if isinstance(st, dict) else one(st))
            for k, st in dict(opt_state).items()}


def shard_opt_state(optimizer, mesh):
    """Shard a prepared optimizer's state onto ``mesh`` in place (its
    update runs on shards from now on, see :class:`ZeroShards`); returns
    ``(optimizer, shardings)``."""
    optimizer._enable_zero(mesh)
    return optimizer, opt_state_shardings(optimizer.optimizer.state, mesh)


def per_chip_bytes(tree: Any) -> int:
    """Bytes of every tensor in ``tree`` held by this process (a torch
    optimizer, its ``state``, or nested dicts / lists of tensors): the
    opt-state bytes per process that ZeRO divides by the dp degree."""
    if isinstance(tree, torch.optim.Optimizer):
        tree = tree.state
    if hasattr(tree, "optimizer") and isinstance(tree.optimizer, torch.optim.Optimizer):
        tree = tree.optimizer.state
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return total


def opt_state_layout(mesh, enabled: bool) -> dict:
    """Checkpoint-manifest record of how the optimizer state was laid out at
    save time.  The saved state is gathered to full shapes either way, so a
    load may change layout."""
    if enabled and mesh is not None and zero_degree(mesh) > 1:
        return {
            "kind": "zero",
            "axes": list(zero_axes(mesh)),
            "degree": zero_degree(mesh),
        }
    return {"kind": "replicated", "axes": [], "degree": 1}


# ---------------------------------------------------------------------------
# Eligibility
# ---------------------------------------------------------------------------


def supported(mesh) -> tuple:
    """Whether the ZeRO step can run on ``mesh``; (ok, reason)."""
    if mesh is None:
        return False, "no device mesh (prepare() not run?)"
    axes = zero_axes(mesh)
    if not axes:
        return False, (
            "no active data-parallel axis to shard over "
            f"(mesh: {dict(zip(mesh.axis_names, (mesh.shape[a] for a in mesh.axis_names)))})"
        )
    active_model = [a for a in _MODEL_AXES if a in mesh.axis_names and mesh.shape[a] > 1]
    if active_model:
        return False, (
            f"mesh has active model axes {active_model}; under fsdp the "
            "optimizer state is already sharded (FULL_SHARD == ZeRO-3), and "
            "tp/sp/ep/pp model collectives do not compose with the manual "
            "dp region"
        )
    return True, ""


# ---------------------------------------------------------------------------
# Overlap
# ---------------------------------------------------------------------------

_overlap_enabled = False


def enable_overlap_flags(warn_if_late: bool = True) -> bool:
    """The JAX package composes XLA's latency-hiding flags here.  The port's
    per-leaf collectives run after the backward on the default stream, and
    nothing overlaps them yet (ROADMAP A6): a no-op on this backend,
    returning False."""
    global _overlap_enabled
    if not _overlap_enabled:
        logger.info("ZeRO overlap requested: a no-op on this backend (the per-leaf "
                    "collectives run after the backward)")
    _overlap_enabled = True
    return False


def maybe_enable_from_env() -> None:
    """``Accelerator.__init__`` hook: arm the overlap when ZeRO is requested
    through the env."""
    cfg = ZeROConfig.from_env()
    if cfg.enabled and cfg.overlap_effective:
        enable_overlap_flags(warn_if_late=False)
