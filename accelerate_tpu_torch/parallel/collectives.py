"""The collectives the port issues over a ``torch.distributed`` process group.

One process per GPU: where the JAX package lets XLA place the collectives
of a sharded program, the port calls them itself, through these helpers:

- :func:`all_reduce` (in place), :func:`reduce_scatter` (dim 0 of a
  contiguous buffer, summed), :func:`all_gather` (along dim 0),
  :func:`broadcast` (in place) and the object forms
  :func:`all_gather_object` / :func:`broadcast_object`;
- :func:`all_gather_dim` and :func:`reduce_scatter_dim` along any dim of a
  tensor over a group (the dim is moved to the front, as the ZeRO shards
  move theirs, and moved back);
- the autograd pairs of the model axes: :func:`fsdp_gather` (forward an
  all-gather of a parameter's shard along its ``fsdp`` dim, backward a
  reduce-scatter of the gradient, summed); Megatron's pair on the ``tp``
  group, or on any group whose ranks hold parts of one sum (``ep`` and
  ``tp`` together for the experts), :func:`tp_copy` (forward the
  identity, backward an all-reduce: the input of a column-parallel
  product) and :func:`tp_reduce` (forward an all-reduce, backward the
  identity: the output of a row-parallel product); :func:`tp_gather`, a
  leaf's ``tp`` shards gathered whole, whose backward either sums the
  gradient over ``tp`` and keeps this rank's chunk (each rank used only
  its own heads' part of the whole) or only keeps the chunk (every rank
  used the whole on the same inputs); and :func:`data_sum`, an
  all-reduce both ways, for a statistic over the data axes that every
  rank's loss reads (batch norm over a sharded batch).

NCCL takes CUDA tensors as they are.  gloo is the CPU backend; it moves a
CUDA tensor through host memory, and not every release of it takes every
collective on CUDA, so a CUDA tensor on a gloo group is staged explicitly:
copied to pinned host memory, reduced there by gloo's own collective
(``reduce_scatter`` included), copied back.  That is gloo's transport, not
a fallback, and it is logged once per process.

Without a process group each is the identity (one process); a group of one
process runs them for real.  Every call is counted in :data:`COMM_LOG` (calls, payload bytes, host
seconds per operation; bytes and seconds staged through the host apart),
under the operation's name, or ``"<op>:<axes>"`` where the caller names
the mesh axes it runs over (``"all_gather:fsdp"``, ``"all_reduce:tp"``):
the smokes read it to report what each collective moved.  The seconds are
host wall time: a staged call waits for its copies, an NCCL call only
enqueues.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

__all__ = ["COMM_LOG", "all_gather", "all_gather_dim", "all_gather_object", "all_reduce",
           "all_to_all_dim", "backend", "broadcast", "broadcast_object", "fsdp_gather",
           "initialized", "rank", "reduce_scatter", "reduce_scatter_dim", "reset_comm_log",
           "ring_shift", "tp_copy", "tp_gather", "tp_reduce", "data_sum", "world_size"]

COMM_LOG: dict = {}
_noted: set = set()

_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "product": "PRODUCT"}


def initialized() -> bool:
    """Whether a default process group is up."""
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    return dist.get_world_size(group) if initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if initialized() else 0


def backend(group=None) -> Optional[str]:
    """The group's backend name (``"nccl"``, ``"gloo"``), None without one."""
    return str(dist.get_backend(group)) if initialized() else None


def reset_comm_log() -> None:
    COMM_LOG.clear()


def _record(op: str, nbytes: int, seconds: float, staged: bool, axis=None) -> None:
    if axis:
        op = f"{op}:{axis if isinstance(axis, str) else ','.join(axis)}"
    row = COMM_LOG.setdefault(op, {"calls": 0, "bytes": 0, "seconds": 0.0,
                                   "staged_bytes": 0, "staged_seconds": 0.0})
    row["calls"] += 1
    row["bytes"] += int(nbytes)
    row["seconds"] += seconds
    if staged:
        row["staged_bytes"] += int(nbytes)
        row["staged_seconds"] += seconds


def _note(key: str, message: str) -> None:
    if key not in _noted:
        _noted.add(key)
        logger.info(message)


def _staged(t: torch.Tensor, group) -> bool:
    if t.device.type == "cpu" or backend(group) != "gloo":
        return False
    _note("gloo-staging", f"gloo group: {t.device.type} tensors are staged through host "
                          "memory for every collective")
    return True


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t`` (the caching host allocator keeps the
    pages for the next step: a pinned copy runs at several times a
    pageable one's rate)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _red_op(op: str):
    if op not in _REDUCE_OPS:
        raise ValueError(f"reduction must be one of {sorted(_REDUCE_OPS)}, got {op!r}")
    return getattr(dist.ReduceOp, _REDUCE_OPS[op])


def all_reduce(t: torch.Tensor, op: str = "sum", group=None, axis=None) -> torch.Tensor:
    """Reduce ``t`` over the group in place (``op``: sum, max, min,
    product) and return it; ``axis`` names the mesh axes for the log."""
    if not initialized():
        return t
    t0 = time.perf_counter()
    staged = _staged(t, group)
    work = _host(t) if staged else t
    dist.all_reduce(work, op=_red_op(op), group=group)
    if staged:
        t.copy_(work)
    _record("all_reduce", t.numel() * t.element_size(), time.perf_counter() - t0, staged,
            axis)
    return t


def reduce_scatter(inp: torch.Tensor, group=None, axis=None) -> torch.Tensor:
    """The sum over the group of ``inp`` (contiguous, dim 0 divisible by the
    group's size), of which this rank keeps rows ``[rank * n, (rank + 1) *
    n)`` of dim 0, ``n = inp.shape[0] // size``."""
    if not initialized():
        return inp
    size = world_size(group)
    if inp.shape[0] % size:
        raise ValueError(f"reduce_scatter: dim 0 ({inp.shape[0]}) is not divisible by the "
                         f"group size ({size})")
    t0 = time.perf_counter()
    staged = _staged(inp, group)
    src = _host(inp) if staged else inp.contiguous()
    out = torch.empty((inp.shape[0] // size,) + tuple(inp.shape[1:]), dtype=src.dtype,
                      device=src.device, pin_memory=staged)
    # torch 2.13 renames ``reduce_scatter_tensor`` / ``all_gather_into_tensor``
    # to ``reduce_scatter_single`` / ``all_gather_single`` and deprecates the
    # old names; 2.11 has only the old ones.
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, src, group=group)
    if staged:
        out = out.to(inp.device)
    _record("reduce_scatter", inp.numel() * inp.element_size(), time.perf_counter() - t0,
            staged, axis)
    return out


def all_gather(inp: torch.Tensor, group=None, axis=None) -> torch.Tensor:
    """Every rank's ``inp`` (one shape on all ranks) concatenated along dim
    0; a 0-d tensor gathers into a vector of one entry per rank."""
    flat = inp.reshape(1) if inp.dim() == 0 else inp
    if not initialized():
        return flat.clone() if inp.dim() == 0 else inp
    size = world_size(group)
    t0 = time.perf_counter()
    staged = _staged(flat, group)
    src = _host(flat) if staged else flat.contiguous()
    out = torch.empty((size * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device, pin_memory=staged)
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, src, group=group)
    if staged:
        out = out.to(inp.device)
    _record("all_gather", out.numel() * out.element_size(), time.perf_counter() - t0, staged,
            axis)
    return out


def broadcast(t: torch.Tensor, src: int = 0, group=None, axis=None) -> torch.Tensor:
    """``t`` overwritten in place with rank ``src``'s and returned."""
    if not initialized():
        return t
    t0 = time.perf_counter()
    staged = _staged(t, group)
    work = _host(t) if staged else t
    dist.broadcast(work, src=src, group=group)
    if staged:
        t.copy_(work)
    _record("broadcast", t.numel() * t.element_size(), time.perf_counter() - t0, staged, axis)
    return t


def all_gather_object(obj: Any, group=None) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if not initialized():
        return [obj]
    out = [None] * world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj: Any, src: int = 0, group=None) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def all_gather_dim(inp: torch.Tensor, dim: int, group=None, axis=None) -> torch.Tensor:
    """Every rank's ``inp`` concatenated along ``dim`` (contiguous)."""
    if not initialized():
        return inp
    size = world_size(group)
    full = all_gather(inp.movedim(dim, 0).contiguous(), group=group, axis=axis)
    moved = (size * inp.shape[dim],) + tuple(s for i, s in enumerate(inp.shape) if i != dim)
    return full.view(moved).movedim(0, dim).contiguous()


def reduce_scatter_dim(inp: torch.Tensor, dim: int, group=None, axis=None) -> torch.Tensor:
    """The sum over the group of ``inp``, of which this rank keeps its
    chunk along ``dim`` (contiguous)."""
    if not initialized():
        return inp
    mine = reduce_scatter(inp.movedim(dim, 0).contiguous(), group=group, axis=axis)
    return mine.movedim(0, dim).contiguous()


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group, dtype):
        ctx.dim, ctx.group, ctx.in_dtype = dim, group, shard.dtype
        x = shard if dtype is None else shard.to(dtype)
        return all_gather_dim(x, dim, group, "fsdp")

    @staticmethod
    def backward(ctx, grad):
        g = reduce_scatter_dim(grad.to(ctx.in_dtype), ctx.dim, ctx.group, "fsdp")
        return g, None, None, None


def fsdp_gather(shard: torch.Tensor, dim: int, group, dtype=None) -> torch.Tensor:
    """The full tensor of which every rank of ``group`` holds a chunk along
    ``dim``, cast to ``dtype`` first (so a 16-bit compute gathers 16-bit
    bytes); the backward reduce-scatters the gradient in the shard's own
    dtype, so each rank gets the sum over the group of its chunk's
    gradient (fp32 for fp32 masters)."""
    return _FsdpGather.apply(shard, dim, group, dtype)


def _sum_wide(t: torch.Tensor, group, axis="tp") -> torch.Tensor:
    """The sum over ``group`` of ``t``, added in fp32 where ``t`` is
    16-bit and rounded to its dtype once, as one product's fp32
    accumulator is."""
    wide = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t.contiguous().clone()
    return all_reduce(wide, group=group, axis=axis).to(t.dtype)


class _TpCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_wide(grad, ctx.group, ctx.axis), None, None


class _TpReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        return _sum_wide(x, group, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def tp_copy(x: torch.Tensor, group, axis="tp") -> torch.Tensor:
    """Megatron's ``f``: the identity forward, an all-reduce (sum) of the
    gradient backward (in fp32 for a 16-bit gradient); the input of a
    column-parallel product, whose gradient each rank holds a part of.
    ``group=None`` (no such axis): ``x`` itself.  ``axis`` names the mesh
    axes of ``group`` for the log."""
    return x if group is None else _TpCopy.apply(x, group, axis)


def tp_reduce(x: torch.Tensor, group, axis="tp") -> torch.Tensor:
    """Megatron's ``g``: an all-reduce (sum) forward (in fp32 for a 16-bit
    input, rounded once), the identity backward; the output of a
    row-parallel product (each rank holds a partial sum) and the
    statistics of the vocabulary-parallel loss.  ``group=None`` (no such
    axis): ``x`` itself."""
    return x if group is None else _TpReduce.apply(x, group, axis)


class _TpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group, partial, axis):
        ctx.dim, ctx.group, ctx.partial, ctx.axis = dim, group, partial, axis
        ctx.size, ctx.rank = world_size(group), rank(group)
        return all_gather_dim(shard, dim, group, axis)

    @staticmethod
    def backward(ctx, grad):
        if ctx.partial:
            g = reduce_scatter_dim(grad.float() if grad.dtype in (torch.bfloat16, torch.float16)
                                   else grad, ctx.dim, ctx.group, ctx.axis).to(grad.dtype)
        else:
            n = grad.shape[ctx.dim] // ctx.size
            g = grad.narrow(ctx.dim, ctx.rank * n, n).contiguous()
        return g, None, None, None, None


def tp_gather(shard: torch.Tensor, dim: int, group, partial: bool,
              axis="tp") -> torch.Tensor:
    """The whole leaf of which every rank of the ``tp`` ``group`` holds a
    chunk along ``dim``.  Backward, with ``partial`` (each rank then used
    only its own heads' part of the whole, so its gradient is a part):
    the gradient summed over ``tp`` (in fp32 for a 16-bit one), of which
    this rank keeps its chunk, a reduce-scatter; without (every rank used
    the whole on the same inputs, so every rank holds the whole
    gradient): this rank's chunk of it, with no collective, as a sum
    would count it ``tp`` times.  ``group=None``: ``shard`` itself.
    ``axis`` names the group's mesh axes for the log (``"sp"`` for a
    sequence gathered whole, whose every rank then reads the whole)."""
    return shard if group is None else _TpGather.apply(shard, dim, group, partial, axis)


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return all_reduce(x.contiguous().clone(), group=group, axis=axis)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), group=ctx.group, axis=ctx.axis), None, None


def data_sum(x: torch.Tensor, group, axis=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (the data axes), forward and
    backward: a statistic of the global batch that every rank's loss
    reads, so its gradient is the sum of every rank's (the optimizer then
    averages the parameters' gradients over the same ranks).
    ``group=None``: ``x`` itself."""
    return x if group is None else _DataSum.apply(x, group, axis)


def ring_shift(t: torch.Tensor, group, axis="sp", reverse: bool = False) -> torch.Tensor:
    """JAX's ``ppermute`` over ``group`` with the permutation ``(i, i + 1 mod
    n)``: this rank's ``t`` goes to the next rank of the group and the
    previous rank's comes back (one shape on all ranks), through
    ``batch_isend_irecv``; staged through pinned host memory on a gloo
    group.  ``reverse``: the permutation ``(i, i - 1 mod n)``.  No autograd.
    ``group=None`` or a group of one: ``t`` itself.  Logged as
    ``"ppermute:<axis>"``."""
    if group is None or not initialized():
        return t
    n = world_size(group)
    if n == 1:
        return t
    t0 = time.perf_counter()
    me = rank(group)
    staged = _staged(t, group)
    src = _host(t) if staged else t.contiguous()
    out = torch.empty(src.shape, dtype=src.dtype, device=src.device, pin_memory=staged)
    step = -1 if reverse else 1
    peers = [dist.get_global_rank(group, (me + d) % n) for d in (step, -step)]
    ops = [dist.P2POp(dist.isend, src, peers[0], group),
           dist.P2POp(dist.irecv, out, peers[1], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        out = out.to(t.device)
    _record("ppermute", t.numel() * t.element_size(), time.perf_counter() - t0, staged, axis)
    return out


def _all_to_all(t: torch.Tensor, split: int, concat: int, group, axis) -> torch.Tensor:
    n = world_size(group)
    t0 = time.perf_counter()
    parts = torch.stack(t.chunk(n, dim=split))  # part j goes to rank j
    staged = _staged(parts, group)
    src = _host(parts) if staged else parts.contiguous()
    out = torch.empty(src.shape, dtype=src.dtype, device=src.device, pin_memory=staged)
    dist.all_to_all_single(out, src, group=group)
    if staged:
        out = out.to(t.device)
    _record("all_to_all", t.numel() * t.element_size(), time.perf_counter() - t0, staged, axis)
    return torch.cat(out.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, split, concat, group, axis):
        ctx.split, ctx.concat, ctx.group, ctx.axis = split, concat, group, axis
        return _all_to_all(t, split, concat, group, axis)

    @staticmethod
    def backward(ctx, grad):
        return (_all_to_all(grad, ctx.concat, ctx.split, ctx.group, ctx.axis),
                None, None, None, None)


def all_to_all_dim(t: torch.Tensor, split_dim: int, concat_dim: int, group,
                   axis="sp") -> torch.Tensor:
    """``lax.all_to_all(t, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)`` over ``group``: ``t`` cut into ``n`` chunks along
    ``split_dim``, chunk ``j`` sent to rank ``j``, and the chunks received
    concatenated along ``concat_dim`` in rank order (``all_to_all_single``,
    staged through pinned host memory on a gloo group).  Differentiable:
    the backward is the reverse exchange.  ``group=None`` or a group of
    one: ``t`` itself.  Logged as ``"all_to_all:<axis>"``."""
    if group is None or not initialized() or world_size(group) == 1:
        return t
    if t.shape[split_dim] % world_size(group):
        raise ValueError(f"all_to_all_dim: dim {split_dim} ({t.shape[split_dim]}) is not "
                         f"divisible by the group size ({world_size(group)})")
    return _AllToAll.apply(t, split_dim, concat_dim, group, axis)
