"""Process state, device resolution and the gradient accumulation state.

Every entry point runs on the card unless its caller asks for the CPU: a
``device`` of ``None`` means ``cuda``, and raises when CUDA is absent rather
than quietly running on the host.

:class:`PartialState` and :class:`AcceleratorState` are the JAX package's
shared-state objects (``accelerate_tpu/state.py``): every instance of a
class shares one dictionary, filled by the first construction and cleared
by ``_reset_state()``.

Several processes run one per GPU.  :class:`PartialState` reads torchrun's
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT`` or the JAX package's ``ACCELERATE_COORDINATOR_ADDRESS`` /
``ACCELERATE_NUM_PROCESSES`` / ``ACCELERATE_PROCESS_ID`` (a
:class:`~.utils.dataclasses.DistributedInitKwargs` wins over both) and
starts the process group under the connect retry policy: NCCL on
``cuda:LOCAL_RANK``, or gloo when the caller asks for the CPU.  A group the
caller already started is adopted as it is, whatever its backend (two gloo
ranks may share one GPU that way).  The barriers, ``main_process_first``,
``split_between_processes`` and the ``on_*_process`` decorators act over
the group.  ``AcceleratorState`` adds the ``mixed_precision`` mode and its
:class:`MixedPrecisionPolicy`, and the mesh: a
:class:`~.utils.dataclasses.ParallelismConfig` resolved as in the JAX
package (pure data parallelism by default) and its
:class:`~.parallel.mesh.Mesh`.  A second construction that names another
mode raises, as in the JAX package, and so does one that names another
device.  :class:`GradientState` stays one per ``Accelerator``."""

from __future__ import annotations

import contextlib
import inspect
import logging
import os
import weakref
from datetime import timedelta
from functools import partial, wraps
from typing import Callable, Optional, Union

import torch

from .utils.dataclasses import (
    DistributedInitKwargs,
    DistributedType,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    ParallelismConfig,
    PrecisionType,
)

logger = logging.getLogger(__name__)

__all__ = ["AcceleratorState", "GradientState", "PartialState", "is_initialized",
           "resolve_device", "resolve_parallelism"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` without CUDA); an
    explicit device is returned as a ``torch.device``, and an explicit CUDA
    device also raises without CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether ``a`` and ``b`` name one device (``cuda`` is ``cuda:<any>``)."""
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def is_initialized() -> bool:
    """Whether an :class:`AcceleratorState` has been constructed."""
    return AcceleratorState._shared_state != {}


def _stale_handle(cls_name: str, name: str):
    return AttributeError(
        f"`{cls_name}` object has no attribute `{name}`. This happens if "
        f"`{cls_name}._reset_state()` was called on a live handle; construct a fresh instance."
    )


def _connect_retry_policy():
    """Backoff for the process group's rendezvous, as the JAX package's
    ``connect_retry_policy``: a coordinator that comes up a beat late is
    redialled, not fatal.  ``ACCELERATE_TPU_COORDINATOR_CONNECT_TRIES``
    (default 3) and ``ACCELERATE_TPU_COORDINATOR_CONNECT_DEADLINE_S``
    (default 600); argument errors fail at once."""
    from .resilience.retry import RetryPolicy

    return RetryPolicy(
        tries=max(1, int(os.environ.get("ACCELERATE_TPU_COORDINATOR_CONNECT_TRIES", "3"))),
        base_delay_s=0.25,
        max_delay_s=2.0,
        deadline_s=float(os.environ.get("ACCELERATE_TPU_COORDINATOR_CONNECT_DEADLINE_S", "600")),
        retryable=lambda exc: not isinstance(exc, (TypeError, ValueError)),
        label="coordinator_connect",
    )


def _env_int(*keys: str, default: Optional[int] = None) -> Optional[int]:
    for key in keys:
        if os.environ.get(key, "") != "":
            return int(os.environ[key])
    return default


def _launch_contract(init_kwargs: DistributedInitKwargs) -> dict:
    """World size, rank, local rank and coordinator address from
    ``init_kwargs``, else the JAX package's env contract, else
    torchrun's."""
    world = init_kwargs.num_processes or _env_int(
        "ACCELERATE_NUM_PROCESSES", "WORLD_SIZE", default=1)
    rank = init_kwargs.process_id
    if rank is None:
        rank = _env_int("ACCELERATE_PROCESS_ID", "RANK", default=0)
    local = _env_int("LOCAL_RANK", "ACCELERATE_LOCAL_PROCESS_INDEX", default=rank)
    coordinator = init_kwargs.coordinator_address or os.environ.get(
        "ACCELERATE_COORDINATOR_ADDRESS")
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    return {"world": int(world), "rank": int(rank), "local": int(local),
            "coordinator": coordinator}


class PartialState:
    """The process: ``device``, ``num_processes``, ``process_index``,
    ``local_process_index``, ``num_nodes`` (processes over processes per
    node), ``backend`` (``"nccl"``, ``"gloo"`` or None for one process) and
    ``distributed_type`` (``MULTI_GPU`` with several processes, else
    ``NO``); ``debug`` from ``ACCELERATE_DEBUG_MODE``.

    The device: ``cpu=True`` or ``device=`` picks it; else ``cuda`` for one
    process and ``cuda:LOCAL_RANK`` for several (raising without CUDA).  A
    launch of several processes with no group up starts one (NCCL, or
    gloo under ``cpu=True`` or a CPU ``device``); a live group is adopted.
    Later constructions return the first one's state; one that names
    another device raises, as a second ``mixed_precision`` does in
    :class:`AcceleratorState`."""

    _shared_state: dict = {}
    _known_attrs = ["backend", "debug", "device", "distributed_type", "local_process_index",
                    "num_nodes", "num_processes", "process_index"]

    def __getattr__(self, name: str):
        if name in type(self)._known_attrs:
            raise _stale_handle(type(self).__name__, name)
        raise AttributeError(f"'{type(self).__name__}' object has no attribute '{name}'")

    def __init__(self, cpu: bool = False, device=None, **kwargs):
        self.__dict__ = self._shared_state
        if cpu and device is not None and str(device) != "cpu":
            raise ValueError(f"cpu=True contradicts device={device!r}")
        if self.initialized:
            if cpu or device is not None:
                dev = resolve_device("cpu" if cpu else device)
                if not _same_device(dev, self.device):
                    raise ValueError(
                        f"PartialState already initialized on {self.device}; cannot re-init on "
                        f"{dev}. Call AcceleratorState._reset_state(reset_partial_state=True) "
                        "first (tests), or build every Accelerator of the process on one device.")
            return
        from .parallel import collectives

        init_kwargs = kwargs.pop("init_kwargs", None) or DistributedInitKwargs()
        contract = _launch_contract(init_kwargs)
        wants_cpu = cpu or (device is not None and torch.device(device).type == "cpu")
        if collectives.initialized():
            world, rank = collectives.world_size(), collectives.rank()
        else:
            world, rank = contract["world"], contract["rank"]
        if device is None and not cpu and world > 1:
            device = f"cuda:{contract['local']}"
        dev = resolve_device("cpu" if cpu else device)
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        if world > 1 and not collectives.initialized():
            self._connect(contract, "gloo" if wants_cpu else "nccl", dev, init_kwargs.timeout)
        self.debug = os.environ.get("ACCELERATE_DEBUG_MODE", "0").lower() in (
            "1", "y", "yes", "t", "true", "on")
        self.device = dev
        self.num_processes = world
        self.process_index = rank
        self.local_process_index = contract["local"] if world > 1 else 0
        local_world = min(_env_int("LOCAL_WORLD_SIZE", default=world), world)
        self.num_nodes = max(1, world // max(1, local_world))
        self.backend = collectives.backend()
        self.distributed_type = DistributedType.MULTI_GPU if world > 1 else DistributedType.NO

    @staticmethod
    def _connect(contract: dict, backend: str, dev: torch.device, timeout: timedelta) -> None:
        """Start the default process group (``tcp://`` at the coordinator)
        under :func:`_connect_retry_policy`; a failed attempt is torn down
        so the retry starts clean."""
        import torch.distributed as dist

        if contract["coordinator"] is None:
            raise ValueError(
                f"{contract['world']} processes but no coordinator: set MASTER_ADDR/MASTER_PORT "
                "(torchrun does), ACCELERATE_COORDINATOR_ADDRESS, or "
                "DistributedInitKwargs(coordinator_address=...)")
        extra = {}
        if (backend == "nccl" and dev.index is not None
                and "device_id" in inspect.signature(dist.init_process_group).parameters):
            extra["device_id"] = dev  # binds the communicator to the rank's GPU

        def connect():
            if dist.is_initialized():
                return
            try:
                dist.init_process_group(backend, init_method=f"tcp://{contract['coordinator']}",
                                        world_size=contract["world"], rank=contract["rank"],
                                        timeout=timeout, **extra)
            except Exception:
                if dist.is_initialized():
                    dist.destroy_process_group()
                raise

        _connect_retry_policy().call(connect)
        logger.info(f"process group up: {backend}, rank {contract['rank']} of "
                    f"{contract['world']} on {dev}")

    @property
    def initialized(self) -> bool:
        return self._shared_state != {}

    @property
    def use_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    def wait_for_everyone(self) -> None:
        """A barrier across the processes (nothing to wait for at one)."""
        if self.num_processes > 1:
            import torch.distributed as dist

            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index or 0])
            else:
                dist.barrier()

    def _goes_first(self, is_main: bool):
        if not is_main:
            self.wait_for_everyone()
        yield
        if is_main:
            self.wait_for_everyone()

    @contextlib.contextmanager
    def main_process_first(self):
        yield from self._goes_first(self.is_main_process)

    @contextlib.contextmanager
    def local_main_process_first(self):
        yield from self._goes_first(self.is_local_main_process)

    def on_main_process(self, function: Callable = None):
        """Decorator: ``function`` runs on the main process only."""
        if function is None:
            return partial(self.on_main_process)

        @wraps(function)
        def wrapper(*args, **kwargs):
            if self.is_main_process:
                return function(*args, **kwargs)

        return wrapper

    def on_local_main_process(self, function: Callable = None):
        if function is None:
            return partial(self.on_local_main_process)

        @wraps(function)
        def wrapper(*args, **kwargs):
            if self.is_local_main_process:
                return function(*args, **kwargs)

        return wrapper

    def on_last_process(self, function: Callable):
        @wraps(function)
        def wrapper(*args, **kwargs):
            if self.is_last_process:
                return function(*args, **kwargs)

        return wrapper

    def on_process(self, function: Callable = None, process_index: int = None):
        """Decorator: ``function`` runs on process ``process_index`` only (on
        every process of a one-process run, the index omitted included)."""
        if function is None:
            return partial(self.on_process, process_index=process_index)

        @wraps(function)
        def wrapper(*args, **kwargs):
            if self.process_index == process_index or self.num_processes == 1:
                return function(*args, **kwargs)

        return wrapper

    def on_local_process(self, function: Callable = None, local_process_index: int = None):
        if function is None:
            return partial(self.on_local_process, local_process_index=local_process_index)

        @wraps(function)
        def wrapper(*args, **kwargs):
            if self.local_process_index == local_process_index or self.num_processes == 1:
                return function(*args, **kwargs)

        return wrapper

    @contextlib.contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        """``inputs`` (a list, tuple, dict of sequences or tensor) split
        evenly between the processes, earlier ranks taking the remainder and
        ``apply_padding`` repeating the last element so every rank's share is
        as long: at one process the whole of ``inputs``."""
        if self.num_processes == 1:
            yield inputs
            return
        if isinstance(inputs, dict):
            lengths = {k: len(v) for k, v in inputs.items()}
            if len(set(lengths.values())) > 1:
                raise ValueError("All dict values must have the same length to split between "
                                 f"processes, got {lengths}")
            length = next(iter(lengths.values())) if lengths else 0
        else:
            length = len(inputs)
        sizes = [length // self.num_processes] * self.num_processes
        for i in range(length % self.num_processes):
            sizes[i] += 1
        start = sum(sizes[: self.process_index])
        end = start + sizes[self.process_index]
        pad = max(sizes) - (end - start) if apply_padding else 0

        def cut(v):
            chunk = v[start:end]
            if pad:
                if isinstance(chunk, torch.Tensor):
                    chunk = torch.cat([chunk] + [v[-1:]] * pad, dim=0)
                elif isinstance(chunk, tuple):
                    chunk = chunk + (v[-1],) * pad
                else:
                    chunk = list(chunk) + [v[-1]] * pad
            return chunk

        yield {k: cut(v) for k, v in inputs.items()} if isinstance(inputs, dict) else cut(inputs)

    def destroy_process_group(self) -> None:
        """Shut the process group down (with several processes)."""
        if self.num_processes > 1:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()

    def print(self, *args, **kwargs):
        if self.is_local_main_process:
            print(*args, **kwargs)

    @classmethod
    def _reset_state(cls) -> None:
        cls._shared_state.clear()

    def __repr__(self) -> str:
        return (f"Distributed environment: {self.distributed_type}\n"
                f"Backend: {self.backend}\n"
                f"Num processes: {self.num_processes}\n"
                f"Process index: {self.process_index}\n"
                f"Local process index: {self.local_process_index}\n"
                f"Device: {self.device}\n")


_UNPORTED_AXIS_PARTS = {"pp": "ROADMAP A7, pipeline parallelism"}


def resolve_parallelism(cfg: Optional[ParallelismConfig], num_processes: int,
                        num_nodes: int = 1, fsdp_plugin=None) -> ParallelismConfig:
    """The JAX ``AcceleratorState._resolve_parallelism`` with one process
    per device: ``cfg`` (else ``ParallelismConfig.from_env()``); a size-1
    config over several processes puts every process on ``fsdp`` when an
    FSDP plugin is set, else on ``dp`` (the nodes on the outer ``dcn_dp``
    axis in both cases, as the JAX default puts its processes there).  The
    mesh must hold every process.  ``fsdp``, ``tp``, ``ep`` and ``sp`` run;
    an active ``pp`` raises ``NotImplementedError`` naming the part of
    ROADMAP that brings it."""
    if cfg is None:
        cfg = ParallelismConfig.from_env()
    n = num_processes
    if cfg.total_size == 1 and n > 1:
        inner = "fsdp" if fsdp_plugin is not None else "dp"
        if num_nodes > 1 and n % num_nodes == 0:
            cfg = ParallelismConfig(dcn_dp=num_nodes, **{inner: n // num_nodes})
        else:
            cfg = ParallelismConfig(**{inner: n})
    if cfg.total_size != n:
        raise ValueError(
            f"Mesh of size {cfg.total_size} ({cfg.active_axes or '{}'}) does not match "
            f"device count {n}."
        )
    for axis, part in _UNPORTED_AXIS_PARTS.items():
        if getattr(cfg, axis) > 1:
            raise NotImplementedError(
                f"ParallelismConfig({axis}={getattr(cfg, axis)}): the {axis} axis is not "
                f"ported to accelerate_tpu_torch yet ({part}); dp, dcn_dp, fsdp, sp, ep and tp "
                "are")
    return cfg


class AcceleratorState:
    """The process (:class:`PartialState`, whose attributes it passes
    through) plus the ``mixed_precision`` mode (argument, else
    ``ACCELERATE_MIXED_PRECISION``, else ``"no"``), its ``dtype_policy``
    (the FSDP plugin's ``mixed_precision_policy`` where it has one),
    ``fsdp_plugin`` (argument, else a default one under
    ``ACCELERATE_USE_FSDP``), ``distributed_type`` (``FSDP`` with the plugin
    on an active ``fsdp`` axis, else ``TP`` on an active ``tp`` axis, as in
    the JAX package; the ``Accelerator`` rewrites it for the DeepSpeed and
    Megatron dialects), ``parallelism_config`` (:func:`resolve_parallelism`)
    and ``mesh`` (:func:`~.parallel.mesh.build_mesh`)."""

    _shared_state: dict = {}
    _known_attrs = PartialState._known_attrs + ["mixed_precision", "dtype_policy", "mesh",
                                                "parallelism_config", "fsdp_plugin"]

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False, device=None,
                 parallelism_config: Optional[ParallelismConfig] = None, fsdp_plugin=None,
                 **kwargs):
        self.__dict__ = self._shared_state
        if self.initialized:
            if mixed_precision is not None and mixed_precision.lower() != self._mixed_precision:
                raise ValueError(
                    "AcceleratorState already initialized with mixed_precision="
                    f"{self._mixed_precision!r}; cannot re-init with {mixed_precision!r}. "
                    "Call AcceleratorState._reset_state() first (tests) or construct the "
                    "Accelerator before any other state access."
                )
            PartialState(cpu, device=device)  # raises if it names another device
            return
        mode = (os.environ.get("ACCELERATE_MIXED_PRECISION", "no") if mixed_precision is None
                else mixed_precision.lower())
        if mode not in PrecisionType.list():
            raise ValueError(f"Unknown mixed_precision mode: {mode}; must be one of "
                             f"{PrecisionType.list()}")
        policy = MixedPrecisionPolicy.from_mixed_precision(mode)
        from .utils.environment import parse_flag_from_env

        if fsdp_plugin is None and parse_flag_from_env("ACCELERATE_USE_FSDP"):
            from .utils.dataclasses import FullyShardedDataParallelPlugin

            fsdp_plugin = FullyShardedDataParallelPlugin()
        if getattr(fsdp_plugin, "mixed_precision_policy", None) is not None:
            policy = fsdp_plugin.mixed_precision_policy
        partial_state = PartialState(cpu, device=device, **kwargs)
        cfg = resolve_parallelism(parallelism_config, partial_state.num_processes,
                                  partial_state.num_nodes, fsdp_plugin)
        self._partial = partial_state
        # Env-opt-in observability (ACCELERATE_TPU_TELEMETRY=1) goes live
        # once the process state exists, as in the JAX package.
        from .telemetry import maybe_enable_from_env

        maybe_enable_from_env()
        self._mixed_precision = mode
        self.dtype_policy = policy
        self.parallelism_config = cfg
        from .parallel.mesh import build_mesh

        self.fsdp_plugin = fsdp_plugin
        self.mesh = build_mesh(cfg)
        if fsdp_plugin is not None and cfg.fsdp > 1:
            self.distributed_type = DistributedType.FSDP
        elif cfg.tp > 1:
            self.distributed_type = DistributedType.TP
        else:
            self.distributed_type = partial_state.distributed_type

    def __getattr__(self, name: str):
        if name in ("_shared_state", "_partial", "initialized"):
            raise AttributeError(name)
        partial_state = self.__dict__.get("_partial")
        if partial_state is not None and hasattr(partial_state, name):
            return getattr(partial_state, name)
        if name in type(self)._known_attrs:
            raise _stale_handle("AcceleratorState", name)
        raise AttributeError(f"'AcceleratorState' object has no attribute '{name}'")

    @property
    def initialized(self) -> bool:
        return self._shared_state != {}

    @property
    def mixed_precision(self) -> str:
        return self._mixed_precision

    @classmethod
    def _reset_state(cls, reset_partial_state: bool = False) -> None:
        cls._shared_state.clear()
        if reset_partial_state:
            PartialState._reset_state()

    def __repr__(self) -> str:
        return repr(self._partial) + f"Mixed precision: {self.mixed_precision}\n"


class GradientState:
    """The JAX ``GradientState``: ``num_steps`` micro-batches per optimizer
    step, ``step`` (micro-batches counted by :meth:`advance` since the last
    forced sync), ``sync_gradients`` (True on a micro-batch that ends a
    window) and the stack of dataloaders being iterated, whose top one
    gives ``end_of_dataloader`` and ``remainder``.

    One per ``Accelerator``, shared with the optimizers, schedulers and
    dataloaders it prepares; not a process-wide singleton.  The stack holds
    weak references, so an abandoned loader is not kept alive."""

    def __init__(self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None):
        plugin = gradient_accumulation_plugin or GradientAccumulationPlugin()
        num_steps = plugin.num_steps or 1
        if num_steps < 1:
            raise ValueError(f"gradient_accumulation_steps must be >= 1, got {num_steps}")
        self.num_steps = num_steps
        self.adjust_scheduler = plugin.adjust_scheduler
        self.sync_with_dataloader = plugin.sync_with_dataloader
        self.sync_each_batch = plugin.sync_each_batch
        self.step = 0
        self.sync_gradients = True
        self._dataloaders: list = []
        # Inside LocalSGD the optimizers keep their gradients local.
        self.local_sgd = False

    @property
    def active_dataloader(self):
        return self._dataloaders[-1]() if self._dataloaders else None

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    @property
    def end_of_dataloader(self) -> bool:
        """True while the active dataloader's last batch is in hand (set
        before that batch is yielded)."""
        dl = self.active_dataloader
        return bool(dl is not None and dl.end_of_dataloader)

    @property
    def remainder(self) -> int:
        """Samples in the active dataloader's last batch beyond whole
        batches (-1 outside a dataloader)."""
        dl = self.active_dataloader
        return -1 if dl is None else dl.remainder

    def _add_dataloader(self, dataloader) -> None:
        self._dataloaders.append(weakref.ref(dataloader))

    def _remove_dataloader(self, dataloader) -> None:
        self._dataloaders = [r for r in self._dataloaders
                             if r() is not None and r() is not dataloader]

    def advance(self) -> None:
        """Count one micro-batch (the JAX ``Accelerator._do_sync``): on a
        dataloader's last batch ``sync_gradients`` turns True and the count
        restarts (under ``sync_with_dataloader``); otherwise it turns True on
        every ``num_steps``-th micro-batch; under ``sync_each_batch``
        always."""
        if self.sync_with_dataloader and self.end_of_dataloader:
            self.step = 0
            self.sync_gradients = True
        else:
            self.step += 1
            self.sync_gradients = self.step % self.num_steps == 0
        if self.sync_each_batch:
            self.sync_gradients = True
