"""Parameter and batch placement on the mesh: the JAX ``parallel/sharding.py``.

A spec is a tuple with one entry per tensor dim: None (replicated along
it) or the mesh axis name (or tuple of names) the dim is split over, the
JAX ``PartitionSpec`` as a plain tuple.  The rules are the JAX package's:
:func:`spec_from_rules` reads a model's table (``llama.PARTITION_RULES``),
:func:`auto_fsdp_spec` puts the ``fsdp`` axis on the largest free dim that
divides, and :func:`make_param_specs` composes them with the FSDP
strategy's precedence and clipping.

Where JAX places a global array and lets GSPMD insert the collectives, each
process here holds **only its shard** of each leaf, as a plain tensor
(:func:`shard_params`: rank 0's full values are broadcast, then each rank
keeps its chunk), with the spec kept on it (:func:`spec_of`).  A layout
exists only where a collective makes it, so :func:`constrain` is an
identity that checks the spec's names, and the collectives are explicit:
:class:`Layout` gathers a leaf's ``fsdp`` dims where a model uses it
(:func:`~.collectives.fsdp_gather`, whose backward reduce-scatters the
gradient), and a model that knows the ``tp`` and ``ep`` axes (every family
with a rule table) runs Megatron's pair there, gathering over ``tp`` only
the leaves its forward cannot split by head (:func:`~.collectives.tp_gather`;
:class:`TpView`, :func:`layer_leaves` and :func:`leaf` are the families'
shared plumbing).  :func:`embed_lookup` is the JAX one-hot lookup on the
local vocabulary rows.  :func:`full_state_dict` and
:func:`load_full_state_dict` gather and re-shard a model's leaves for
checkpoints.  A spec the port cannot realize raises.
"""

from __future__ import annotations

import contextlib
import re
import threading
from typing import Any, Iterable, Optional

import torch

from .mesh import Mesh, data_axes

__all__ = [
    "spec_from_rules",
    "auto_fsdp_spec",
    "make_param_specs",
    "shard_params",
    "replicated",
    "data_sharding",
    "batch_spec",
    "constrain",
    "embed_lookup",
    "manual_region",
]

_MANUAL = threading.local()


@contextlib.contextmanager
def manual_region():
    """Mark the current thread as inside a region whose layout is realized
    by hand: :func:`constrain` passes values through without checking."""
    prev = getattr(_MANUAL, "active", False)
    _MANUAL.active = True
    try:
        yield
    finally:
        _MANUAL.active = prev


def in_manual_region() -> bool:
    return getattr(_MANUAL, "active", False)


class NamedSharding:
    """A spec on a mesh: the JAX ``NamedSharding``'s two fields."""

    def __init__(self, mesh: Mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self) -> str:
        return f"NamedSharding(spec={self.spec})"


def _live_mesh() -> Optional[Mesh]:
    from ..state import AcceleratorState

    return AcceleratorState._shared_state.get("mesh")


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def constrain(x: torch.Tensor, spec: Optional[tuple] = None) -> torch.Tensor:
    """``x`` itself: in the port a layout exists only where a collective
    makes it.  The spec's axis names are checked against the mesh's
    (``ValueError`` for a name no mesh has), as JAX's
    ``with_sharding_constraint`` checks them."""
    if in_manual_region() or spec is None:
        return x
    from .mesh import mesh_axis_names

    for entry in spec:
        for a in _entry_axes(entry):
            if a not in mesh_axis_names():
                raise ValueError(f"constrain: {a!r} is not a mesh axis "
                                 f"(axes: {mesh_axis_names()})")
    return x


def embed_lookup(table: torch.Tensor, input_ids: torch.Tensor, dtype, mesh: Optional[Mesh] = None,
                 vocab_start: int = 0, tp_group=None) -> torch.Tensor:
    """The JAX ``embed_lookup``: on a mesh whose ``fsdp`` or ``tp`` axis is
    active (the live state's mesh by default) and more than one token a
    row, a one-hot matmul in ``dtype``; otherwise a gather.  ``table`` may
    be this rank's vocabulary rows ``[vocab_start, vocab_start + rows)``
    under ``tp``: the product then covers those rows only and
    :func:`~.collectives.tp_reduce` over ``tp_group`` sums the ranks' parts
    (a single-token row takes the masked gather of its local rows, the same
    sum).  Exact for ids in range, as in JAX; an id in no rank's range
    embeds to zero."""
    from .collectives import tp_reduce

    mesh = mesh if mesh is not None else _live_mesh()
    single_token = input_ids.dim() >= 1 and input_ids.shape[-1] == 1
    sharded = mesh is not None and (mesh.shape["fsdp"] > 1 or mesh.shape["tp"] > 1)
    ids = input_ids.long()
    rows = table.shape[0]
    if sharded and not single_token:
        cols = torch.arange(vocab_start, vocab_start + rows, device=ids.device)
        out = (ids[..., None] == cols).to(dtype) @ table.to(dtype)
    elif tp_group is not None:
        local = ids - vocab_start
        hit = (local >= 0) & (local < rows)
        out = table.to(dtype)[local.clamp(0, rows - 1)] * hit[..., None].to(dtype)
    else:
        return table.to(dtype)[ids]
    return tp_reduce(out, tp_group)


def vocab_lookup(table: torch.Tensor, input_ids: torch.Tensor, dtype, layout) -> torch.Tensor:
    """:func:`embed_lookup` of this process's rows of a table laid out on
    ``layout`` (its vocabulary split over ``tp``, this process's chunk
    starting at ``tp_rank`` times its rows), summed over ``tp``."""
    tp = layout.tp > 1
    return embed_lookup(table, input_ids, dtype, layout.mesh,
                        vocab_start=layout.tp_rank * table.shape[0] if tp else 0,
                        tp_group=layout.tp_group())


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_spec(mesh: Mesh) -> tuple:
    """The spec of a batch: dim 0 over every active data axis."""
    axes = data_axes(mesh)
    return (axes if axes else None,)


def data_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, batch_spec(mesh))


def spec_from_rules(path: str, ndim: int, rules: list) -> Optional[tuple]:
    """The spec of the first rule whose regex matches ``path`` (a leaf's
    keys joined by ``/``); a rule longer than the leaf's rank is passed
    over.  None when no rule matches."""
    for pattern, spec in rules:
        if re.search(pattern, path):
            if len(spec) > ndim:
                continue
            return tuple(spec)
    return None


def specs_from_rules(shapes: Any, rules: list) -> Any:
    """The spec tree of a tree of shapes under ``rules`` (a family's
    ``param_specs``): each leaf's first matching rule, all None where none
    matches."""
    def one(path, shape):
        spec = spec_from_rules(path, len(shape), rules)
        return spec if spec is not None else (None,) * len(shape)

    return _tree_map(one, shapes)


def _divisible_axis(shape: tuple, axis_size: int, taken: set) -> Optional[int]:
    """Largest dim divisible by ``axis_size`` not already sharded."""
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if i not in taken and shape[i] % axis_size == 0 and shape[i] >= axis_size:
            return i
    return None


def auto_fsdp_spec(shape: tuple, mesh: Mesh, existing: Optional[tuple] = None,
                   min_size: int = 0, axis: str = "fsdp") -> tuple:
    """``existing`` (default all None) with ``axis`` on the largest free dim
    it divides, unless ``axis`` is inactive, already in the spec, or the
    leaf has fewer than ``max(min_size, 2)`` elements or no such dim."""
    if axis not in mesh.axis_names or mesh.shape[axis] == 1:
        return tuple(existing) if existing is not None else (None,) * len(shape)
    n = 1
    for s in shape:
        n *= int(s)
    n = n if shape else 0
    spec = list(existing) if existing is not None else [None] * len(shape)
    while len(spec) < len(shape):
        spec.append(None)
    taken = set()
    for i, s in enumerate(spec):
        if s is not None:
            if axis == s or (isinstance(s, tuple) and axis in s):
                return tuple(spec)
            taken.add(i)
    if n < max(min_size, 2):
        return tuple(spec)
    dim = _divisible_axis(tuple(shape), mesh.shape[axis], taken)
    if dim is None:
        return tuple(spec)
    spec[dim] = axis if spec[dim] is None else (spec[dim], axis)
    return tuple(spec)


def _axis_active(mesh: Mesh, axis) -> bool:
    if axis is None:
        return False
    if isinstance(axis, tuple):
        return all(a in mesh.axis_names and mesh.shape[a] > 1 for a in axis)
    return axis in mesh.axis_names and mesh.shape[axis] > 1


def _tree_map(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over the tensor (or shape) leaves of nested dicts
    and lists, ``path`` the keys joined by ``/``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_shape(tree):
        return type(tree)(_tree_map(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _is_shape(x) -> bool:
    return isinstance(x, (tuple, torch.Size)) and all(isinstance(s, int) for s in x)


def _shape(leaf) -> tuple:
    return tuple(leaf) if _is_shape(leaf) else tuple(leaf.shape)


def make_param_specs(params: Any, mesh: Mesh, fsdp_plugin=None,
                     rules: Optional[list] = None) -> Any:
    """The spec tree of a parameter tree (nested dicts or lists of tensors,
    or of shapes), the JAX precedence: a ``rules`` match first, its entries
    clipped to the active axes (and without ``fsdp`` when the strategy keeps
    the parameters replicated), then the strategy's ``fsdp`` axis on a free
    dim (:func:`auto_fsdp_spec` with the plugin's ``min_num_params``)."""
    shards_params = (fsdp_plugin is not None and fsdp_plugin.shards_parameters
                     and "fsdp" in mesh.axis_names and mesh.shape["fsdp"] > 1)
    min_size = fsdp_plugin.min_num_params if fsdp_plugin is not None else 0

    def keep(s):
        if s is None:
            return None
        axes = s if isinstance(s, tuple) else (s,)
        kept = tuple(a for a in axes if _axis_active(mesh, a) and (shards_params or a != "fsdp"))
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]

    def one(path, leaf):
        shape = _shape(leaf)
        spec = spec_from_rules(path, len(shape), rules) if rules else None
        if spec is not None:
            spec = tuple([keep(s) for s in (list(spec) + [None] * (len(shape) - len(spec)))]
                         [: len(shape)])
        if shards_params:
            spec = auto_fsdp_spec(shape, mesh, existing=spec, min_size=min_size)
        elif spec is None:
            spec = (None,) * len(shape)
        return spec

    return _tree_map(one, params)


# ---------------------------------------------------------------------------
# Shards on this process
# ---------------------------------------------------------------------------


def spec_of(t: torch.Tensor) -> Optional[tuple]:
    """The spec :func:`shard_params` kept on a leaf (None: replicated)."""
    return getattr(t, "_spec", None)


def is_sharded(spec: Optional[tuple]) -> bool:
    return spec is not None and any(e is not None for e in spec)


def spec_axes(spec: Optional[tuple]) -> tuple:
    """Every mesh axis a spec names, in ``AXIS_ORDER``."""
    from .mesh import mesh_axis_names

    named = {a for e in (spec or ()) for a in _entry_axes(e)}
    return tuple(a for a in mesh_axis_names() if a in named)


def local_slice(full: torch.Tensor, spec: Optional[tuple], mesh: Mesh,
                rank: Optional[int] = None) -> torch.Tensor:
    """The chunk of ``full`` that ``rank`` (this process by default) holds
    under ``spec``: along each split dim, chunk ``mesh.index(axes)`` of
    ``mesh.span(axes)``, as JAX lays out a ``NamedSharding``."""
    out = full
    for d, entry in enumerate(spec or ()):
        axes = _entry_axes(entry)
        n = mesh.span(axes)
        if n == 1:
            continue
        if full.shape[d] % n:
            raise ValueError(f"dim {d} ({full.shape[d]}) of a leaf does not divide over "
                             f"{axes} ({n})")
        c = full.shape[d] // n
        out = out.narrow(d, mesh.index(axes, rank) * c, c)
    return out


def _leaves(tree, kind) -> Iterable:
    if isinstance(tree, kind):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v, kind)
    elif isinstance(tree, (list, tuple)) or hasattr(tree, "__next__"):
        for v in tree:
            yield from _leaves(v, kind)


def shard_params(params: Any, mesh: Mesh, specs: Any = None) -> Any:
    """Place parameters (a tensor, a module's ``parameters()``, or a list or
    dict tree of tensors) on ``mesh`` in place: rank 0's values are
    broadcast into every one, then each process keeps its chunk of a leaf
    whose spec (``specs``, the same structure; None: all replicated) splits
    it, as the leaf's new ``.data``, with the spec kept on the leaf
    (:func:`spec_of`) and its full shape (``_full_shape``).  Returns
    ``params``."""
    from . import collectives

    group = mesh.group()
    leaves = list(_leaves(params, torch.Tensor))
    spec_list = [None] * len(leaves) if specs is None else list(_leaves(specs, tuple))
    if len(spec_list) != len(leaves):
        raise ValueError(f"shard_params: {len(leaves)} leaves but {len(spec_list)} specs")
    with torch.no_grad():
        for t, spec in zip(leaves, spec_list):
            collectives.broadcast(t.data, src=0, group=group)
            for entry in spec or ():
                for a in _entry_axes(entry):
                    if a not in mesh.axis_names:
                        raise ValueError(f"shard_params: {a!r} is not a mesh axis")
            if is_sharded(spec) and mesh.span(spec_axes(spec)) > 1:
                full_shape = tuple(t.shape)
                t.data = local_slice(t.data, spec, mesh).contiguous().clone()
                t._spec = tuple(spec)
                t._full_shape = full_shape
    return params


def gather_full(t: torch.Tensor, spec: Optional[tuple], mesh: Mesh) -> torch.Tensor:
    """The full tensor of a leaf every process holds a chunk of (a
    collective: every process calls it), without autograd; a dim split over
    several axes is gathered minor axis first."""
    from . import collectives

    out = t.detach()
    for d, entry in enumerate(spec or ()):
        for a in reversed(_entry_axes(entry)):
            if mesh.shape[a] > 1:
                out = collectives.all_gather_dim(out, d, group=mesh.group(a), axis=a)
    return out


class Layout:
    """How a model's leaves lie on ``mesh``: ``specs`` is the spec tree of
    its parameter tree (:func:`make_param_specs`).  A model's forward reads
    it to gather a leaf's ``fsdp`` dims where it uses the leaf
    (:meth:`full`), its ``tp`` dims where the forward cannot split by
    them (``tp_grad``), and to find the ``tp`` axis's group and size, and
    this process's coordinates on ``tp`` and ``ep``.

    ``splits_sequence`` is the model's own declaration that its forward
    runs on this process's chunk of the sequence (:meth:`seq_chunk`) on an
    active ``sp`` axis; ``sp`` is then the axis's size (``sp_rank``,
    :meth:`sp_group`), else 1, and a model that does not split computes
    the whole sequence on every ``sp`` process.  Where ``sp > 1`` each
    replicated leaf's gradient is its chunk's part of the whole, which the
    optimizer sums over ``sp``.  The parameters stay replicated over
    ``sp``, as in JAX's rule tables."""

    def __init__(self, mesh: Mesh, specs: Any, splits_sequence: bool = False):
        self.mesh = mesh
        self.specs = specs
        self.splits_sequence = splits_sequence

    @property
    def sp(self) -> int:
        return self.mesh.shape["sp"] if self.splits_sequence else 1

    @property
    def sp_rank(self) -> int:
        return self.mesh.coords()["sp"]

    def sp_group(self):
        return self.mesh.group("sp") if self.sp > 1 else None

    def seq_chunk(self, s: int) -> slice:
        """This process's tokens of a sequence of ``s`` split over ``sp``
        (``ValueError`` where ``sp`` does not divide ``s``)."""
        if s % self.sp:
            raise ValueError(f"the sequence length {s} does not divide over the sp axis "
                             f"({self.sp})")
        n = s // self.sp
        return slice(self.sp_rank * n, (self.sp_rank + 1) * n)

    @property
    def model_axes(self) -> tuple:
        """The active axes a model's leaves are split over, ``fsdp``, ``ep``
        and ``tp``: the processes along them run one model's forward
        together (their serving engines tick in lockstep)."""
        return tuple(a for a in ("fsdp", "ep", "tp") if self.mesh.shape[a] > 1)

    @property
    def tp(self) -> int:
        return self.mesh.shape["tp"]

    @property
    def tp_rank(self) -> int:
        return self.mesh.coords()["tp"]

    def tp_group(self):
        return self.mesh.group("tp") if self.tp > 1 else None

    @property
    def ep_rank(self) -> int:
        return self.mesh.coords()["ep"]

    def heads(self, n: int) -> Optional[tuple]:
        """This process's ``(first, count)`` of ``n`` heads split over
        ``tp``; None where ``tp`` does not divide ``n`` (the heads are then
        computed whole on every process, as JAX's ``tp_head_axis`` keeps
        them off ``tp``)."""
        if n % self.tp:
            return None
        per = n // self.tp
        return self.tp_rank * per, per

    def spec(self, path: str) -> tuple:
        node = self.specs
        for k in path.split("/"):
            node = node[k]
        return node

    def full(self, leaf: torch.Tensor, spec: Optional[tuple], dtype=None,
             keep=("ep", "tp"), tp_grad: Optional[str] = None) -> torch.Tensor:
        """``leaf`` (this process's chunk, cast to ``dtype`` where given)
        with its ``fsdp`` dims gathered (:func:`~.collectives.fsdp_gather`,
        differentiable); a dim split over an axis in ``keep`` stays local.
        ``tp_grad`` (``"sum"`` or ``"slice"``) gathers its ``tp`` dims too
        (:func:`~.collectives.tp_gather`, whose backward sums the gradient
        over ``tp`` under ``"sum"``).  Any other split raises
        ``NotImplementedError``."""
        from . import collectives

        if tp_grad is not None:
            keep = tuple(a for a in keep if a != "tp")
        out = leaf
        cast = dtype
        for d, entry in enumerate(spec or ()):
            axes = tuple(a for a in _entry_axes(entry) if self.mesh.shape[a] > 1)
            if not axes or all(a in keep for a in axes):
                continue
            if axes == ("tp",) and tp_grad is not None:
                if cast is not None:
                    out, cast = out.to(cast), None
                out = collectives.tp_gather(out, d, self.tp_group(), tp_grad == "sum")
                continue
            if axes != ("fsdp",):
                raise NotImplementedError(
                    f"a leaf split over {axes} on dim {d}: the port gathers a dim split over "
                    f"fsdp alone (or over tp where the forward asks), and leaves {keep} to "
                    "the model")
            out = collectives.fsdp_gather(out, d, self.mesh.group("fsdp"), dtype=cast)
            cast = None
        return out if cast is None else out.to(cast)


def layout_of(params: Any, mesh: Optional[Mesh] = None) -> Optional["Layout"]:
    """The :class:`Layout` of a parameter tree whose leaves are this
    process's shards as :func:`shard_params` left them (each sharded leaf's
    spec kept on it, a replicated one's all None), on ``mesh`` (the live
    state's by default); None where no leaf is sharded (whole weights)."""
    if not any(is_sharded(spec_of(t)) for t in _leaves(params, torch.Tensor)):
        return None
    mesh = mesh if mesh is not None else _live_mesh()
    if mesh is None:
        raise ValueError("layout_of: the leaves are shards but no mesh is live")
    specs = _tree_map(lambda path, t: spec_of(t) or (None,) * t.dim(), params)
    return Layout(mesh, specs)


class TpView:
    """One forward's view of ``tp`` for a family that splits its attention
    by heads and its MLP by width (Megatron's layout), on ``layout``
    (None: one process, every method the identity).  ``group`` is the
    ``tp`` group (None off ``tp``); ``heads`` this process's ``(first,
    count)`` of ``num_heads`` (None where every process computes every
    head: off ``tp``, or where ``tp`` does not divide them); ``attn`` the
    group the attention's Megatron pair runs on (None where every process
    computes every head)."""

    def __init__(self, layout=None, num_heads: int = 1):
        on = layout is not None and layout.tp > 1
        self.group = layout.tp_group() if on else None
        self.size = layout.tp if on else 1
        self.rank = layout.tp_rank if on else 0
        self.heads = layout.heads(num_heads) if on else None
        self.num_heads = num_heads

    @property
    def attn(self):
        return self.group if self.heads is not None else None

    def chunk(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This process's chunk along ``dim`` of ``t``, which every process
        holds whole (a replicated bias, the pooled features): through
        :func:`~.collectives.tp_copy`, so its gradient, of which each
        process holds its chunk's part, is whole on every process."""
        from .collectives import tp_copy

        if self.group is None:
            return t
        n = t.shape[dim] // self.size
        return tp_copy(t, self.group).narrow(dim, self.rank * n, n)

    def head_chunk(self, t: torch.Tensor, parts: int = 1) -> torch.Tensor:
        """This process's heads of ``t``'s last dim laid out ``[parts,
        num_heads, head_dim]`` (the fused QKV's ``(3, H, hd)``)."""
        if self.heads is None:
            return t
        lo, n = self.heads
        lead = t.shape[:-1]
        return t.reshape(*lead, parts, self.num_heads, -1)[..., lo:lo + n, :].reshape(*lead, -1)

    def head_gathers(self, fused=(), split=(), rows=()) -> dict:
        """``Layout.full``'s ``tp_grad`` for a layer's attention leaves:
        the ``fused`` ones (the fused QKV, whose ``tp`` chunks are not sets
        of heads) gathered and their gradient summed over ``tp`` where each
        process then takes its heads' columns; where every process
        computes every head, those, the column-parallel ``split`` ones and
        the row-parallel ``rows`` ones gathered whole, each process keeping
        its chunk of the gradient."""
        if self.group is None:
            return {}
        if self.heads is not None:
            return dict.fromkeys(fused, "sum")
        return dict.fromkeys(tuple(fused) + tuple(split) + tuple(rows), "slice")


def layer_leaves(layers: dict, layout=None, path: str = "layers", dtype=None,
                 tp_grad: Optional[dict] = None):
    """``(names, per_layer, prep)`` of a stack of layers (each leaf ``[L,
    ...]``) at ``path`` in ``layout``'s spec tree: ``per_layer`` holds each
    layer's leaves (one ``unbind`` per stacked leaf, whose backward stacks
    the L gradients once), and ``prep(name, leaf)`` gives a layer's leaf as
    the layer uses it: its ``fsdp`` dims gathered in ``dtype`` and its
    ``tp`` dims where ``tp_grad`` names it (:meth:`Layout.full`); without a
    ``layout``, the leaf itself."""
    names = list(layers)
    per_layer = list(zip(*(layers[k].unbind(0) for k in names)))
    if layout is None:
        return names, per_layer, lambda k, w: w
    specs = {k: layout.spec(f"{path}/{k}")[1:] for k in names}
    grads = tp_grad or {}

    def prep(k, w):
        return layout.full(w, specs[k], dtype, tp_grad=grads.get(k))

    return names, per_layer, prep


def leaf(params: dict, path: str, layout=None, dtype=None, tp_grad: Optional[str] = None):
    """The leaf at ``path`` (keys joined by ``/``) as a forward uses it:
    gathered by :meth:`Layout.full` on ``layout``, else itself."""
    node = params
    for k in path.split("/"):
        node = node[k]
    return node if layout is None else layout.full(node, layout.spec(path), dtype,
                                                   tp_grad=tp_grad)


def full_state_dict(model) -> dict:
    """``model.state_dict()`` with every sharded leaf gathered to its full
    shape (a collective: every process calls it)."""
    from ..state import AcceleratorState

    mesh = AcceleratorState._shared_state.get("mesh")
    out = {}
    for name, t in model.state_dict(keep_vars=True).items():
        spec = spec_of(t)
        out[name] = (gather_full(t, spec, mesh) if is_sharded(spec) and mesh is not None
                     else t.detach())
    return out


@torch.no_grad()
def load_full_state_dict(model, state_dict: dict, strict: bool = True) -> None:
    """Load full tensors into a model whose leaves may be shards: each
    process copies its chunk of a sharded leaf (by the spec kept on it),
    the whole tensor of a replicated one."""
    from ..state import AcceleratorState

    mesh = AcceleratorState._shared_state.get("mesh")
    own = model.state_dict(keep_vars=True)
    if strict:
        missing = set(own) - set(state_dict)
        extra = set(state_dict) - set(own)
        if missing or extra:
            raise RuntimeError(f"load_full_state_dict: missing {sorted(missing)}, unexpected "
                               f"{sorted(extra)}")
    for name, value in state_dict.items():
        if name not in own:
            continue
        t = own[name]
        spec = spec_of(t)
        src = local_slice(value, spec, mesh) if is_sharded(spec) and mesh is not None else value
        if tuple(src.shape) != tuple(t.shape):
            raise RuntimeError(f"load_full_state_dict: {name} has shape {tuple(value.shape)}, "
                               f"its chunk {tuple(src.shape)} does not fit {tuple(t.shape)}")
        t.copy_(src)
