"""The named mesh over the processes: the JAX ``parallel/mesh.py``.

The JAX package runs one process that sees a mesh of devices; the port runs
one process per GPU, so the mesh is a ``torch.distributed`` ``DeviceMesh``
over the world's ranks, built by ``init_device_mesh`` with
``ParallelismConfig.AXIS_ORDER``'s seven names, outermost first.  Size-1
axes stay in it as size-1 dims: ``init_device_mesh`` takes them at no cost
(each is a group of one rank), and keeping all seven means every axis name
resolves to a dim and a group, as every name resolves in a JAX mesh.
A set of several active axes that is not the whole world gets a group of
its own, made when the mesh is built (``new_group`` is collective).

:class:`Mesh` wraps it with the JAX mesh's reading: ``axis_names``,
``shape`` (a dict, every axis name answered), ``size``, and the process
group of a set of axes (:meth:`Mesh.group`).  A process that no group was
started for (one process, the usual single-GPU run) gets a trivial mesh with
no ``DeviceMesh`` behind it, whose groups are None: the collectives of
:mod:`.collectives` are then identities.
"""

from __future__ import annotations

from typing import Optional

from ..utils.dataclasses import ParallelismConfig

__all__ = ["Mesh", "build_mesh", "data_axes", "install_global_mesh", "local_mesh_shape",
           "mesh_axis_names", "model_axes", "reset_global_mesh", "trivial_mesh"]

# Axes over which the *batch* is sharded (data-consuming axes).
DATA_AXES = ("dcn_dp", "dp", "fsdp")
# Axes over which *weights* may be sharded.
MODEL_AXES = ("fsdp", "pp", "ep", "tp")


class Mesh:
    """A named mesh: ``shape`` maps each of the seven axis names to its
    size; ``device_mesh`` is the ``DeviceMesh`` (None for a trivial mesh)
    and ``device_type`` its device type; ``rank`` is this process's rank,
    whose coordinates on the axes are the row-major digits of the rank in
    ``AXIS_ORDER`` (rank r holds what JAX's device r of ``mesh.devices.flat``
    holds)."""

    def __init__(self, shape: dict, device_mesh=None, device_type: str = "cpu",
                 groups: Optional[dict] = None, rank: int = 0):
        self.shape = {a: int(shape.get(a, 1)) for a in mesh_axis_names()}
        self.device_mesh = device_mesh
        self.device_type = device_type
        self.rank = rank
        self._groups = dict(groups or {})

    @property
    def axis_names(self) -> tuple:
        return mesh_axis_names()

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def coords(self, rank: Optional[int] = None) -> dict:
        """Each axis's coordinate of ``rank`` (this process's by default)."""
        r = self.rank if rank is None else rank
        out = {}
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def index(self, axes, rank: Optional[int] = None) -> int:
        """The row-major index of ``rank``'s coordinates over ``axes`` (in
        the order given): its chunk of a dim split over them."""
        c = self.coords(rank)
        i = 0
        for a in _names(axes):
            i = i * self.shape[a] + c[a]
        return i

    def span(self, axes) -> int:
        """The product of the sizes of ``axes``."""
        n = 1
        for a in _names(axes):
            n *= self.shape[a]
        return n

    def group(self, axes=None):
        """The process group over ``axes`` (a name or a tuple of names; all
        axes when None): the ranks that share every other coordinate.  None
        for a trivial mesh (no group); the world's group when they span
        every rank; the ``DeviceMesh`` group of the one active axis among
        them (of the first axis when none is active: a group of this
        process alone); else the group :func:`build_mesh` made for that set
        of active axes."""
        from . import collectives

        names = self.axis_names if axes is None else _names(axes)
        if self.device_mesh is None:
            return None
        if self.span(names) == collectives.world_size():
            return dist_world()
        active = tuple(a for a in self.axis_names if a in names and self.shape[a] > 1)
        if len(active) <= 1:
            return self.device_mesh.get_group(active[0] if active else names[0])
        return self._groups[active]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device_type={self.device_type!r})"


def _names(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def dist_world():
    import torch.distributed as dist

    return dist.group.WORLD


def mesh_axis_names() -> tuple:
    return tuple(ParallelismConfig.AXIS_ORDER)


def data_axes(mesh: Mesh) -> tuple:
    """Mesh axes that consume distinct data shards (size > 1)."""
    return tuple(a for a in DATA_AXES if a in mesh.axis_names and mesh.shape[a] > 1)


def model_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in MODEL_AXES if a in mesh.axis_names and mesh.shape[a] > 1)


def data_degree(mesh: Optional[Mesh]) -> int:
    """The number of distinct data shards: the product of the active data
    axes (1 without a mesh)."""
    return 1 if mesh is None else mesh.span(data_axes(mesh))


def data_index(mesh: Optional[Mesh]) -> int:
    """This process's shard of the global batch (ranks that differ only on
    a model axis, such as ``tp``, or on ``sp``, read the same rows: a
    sequence-parallel forward cuts them into chunks itself)."""
    return 0 if mesh is None else mesh.index(data_axes(mesh))


def build_mesh(cfg: ParallelismConfig, device_type: Optional[str] = None) -> Mesh:
    """The mesh of ``cfg`` over the live process group (``init_device_mesh``
    with the seven names; ``device_type`` defaults to ``cuda`` on an NCCL
    group, else ``cpu``); a trivial mesh when no group is up.  The mesh's
    size must be the group's."""
    from . import collectives

    shape = {a: getattr(cfg, a) for a in mesh_axis_names()}
    if not collectives.initialized():
        if cfg.total_size != 1:
            raise ValueError(f"Mesh {cfg.active_axes} needs {cfg.total_size} processes; no "
                             "process group is up")
        return Mesh(shape)
    world = collectives.world_size()
    if cfg.total_size != world:
        raise ValueError(f"Mesh of size {cfg.total_size} ({cfg.active_axes or '{}'}) does "
                         f"not match the {world} processes")
    if device_type is None:
        device_type = "cuda" if collectives.backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device_type, tuple(shape[a] for a in mesh_axis_names()),
                          mesh_dim_names=mesh_axis_names())
    mesh = Mesh(shape, dm, device_type, rank=collectives.rank())
    mesh._groups = _subgroups(mesh, world)
    return mesh


def _subgroups(mesh: Mesh, world: int) -> dict:
    """A process group for every set of two or more active axes that does
    not span the world, keyed by the set (in ``AXIS_ORDER``): the group of
    the ranks sharing this rank's other coordinates.  ``new_group`` is
    collective: every rank creates every group, in one order, also those it
    is not in."""
    import itertools

    import torch.distributed as dist

    active = [a for a in mesh.axis_names if mesh.shape[a] > 1]
    out = {}
    for k in range(2, len(active) + 1):
        for axes in itertools.combinations(active, k):
            if mesh.span(axes) == world:
                continue
            others = [a for a in active if a not in axes]
            members: dict = {}
            for r in range(world):
                c = mesh.coords(r)
                members.setdefault(tuple(c[a] for a in others), []).append(r)
            for ranks in members.values():
                g = dist.new_group(ranks)
                if mesh.rank in ranks:
                    out[axes] = g
    return out


def local_mesh_shape(mesh: Mesh) -> dict:
    return dict(mesh.shape)


def trivial_mesh() -> Mesh:
    """A mesh with every named axis at size 1."""
    return Mesh({})


def install_global_mesh(mesh: Mesh) -> None:
    """Make ``mesh`` the live state's mesh (the JAX global mesh context):
    :func:`~accelerate_tpu_torch.parallel.sharding.data_sharding` and the
    ZeRO step read the state's."""
    from ..state import AcceleratorState

    if AcceleratorState._shared_state:
        AcceleratorState._shared_state["mesh"] = mesh


def reset_global_mesh() -> None:
    install_global_mesh(trivial_mesh())
