"""Process state, device resolution and the gradient accumulation state.

Every entry point runs on the card unless its caller asks for the CPU: a
``device`` of ``None`` means ``cuda``, and raises when CUDA is absent rather
than quietly running on the host.

:class:`PartialState` and :class:`AcceleratorState` are the JAX package's
shared-state objects (``accelerate_tpu/state.py``) at one process: every
instance of a class shares one dictionary, filled by the first construction
and cleared by ``_reset_state()``.  ``num_processes`` is 1 and
``process_index`` 0, so the barriers are no-ops and every ``on_*_process``
function runs; a launch of several processes (``WORLD_SIZE`` > 1) raises
until ROADMAP A6 brings them.  ``AcceleratorState`` adds the
``mixed_precision`` mode and its :class:`MixedPrecisionPolicy`; a second
construction that names another mode raises, as in the JAX package, and so
does one that names another device.
:class:`GradientState` stays one per ``Accelerator``."""

from __future__ import annotations

import contextlib
import os
import weakref
from functools import partial, wraps
from typing import Callable, Optional, Union

import torch

from .utils.dataclasses import (
    DistributedType,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    PrecisionType,
)

__all__ = ["AcceleratorState", "GradientState", "PartialState", "is_initialized",
           "resolve_device"]


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


class PartialState:
    """The process: ``device`` (from :func:`resolve_device`: ``cpu=True`` or
    ``device=`` picks it, else ``cuda``, raising without CUDA),
    ``num_processes`` 1, ``process_index`` and ``local_process_index`` 0,
    ``distributed_type`` ``NO``; ``debug`` from ``ACCELERATE_DEBUG_MODE``.
    Later constructions return the first one's state; one that names
    another device (``cpu=True`` or ``device=``) raises, as a second
    ``mixed_precision`` does in :class:`AcceleratorState`."""

    _shared_state: dict = {}
    _known_attrs = ["debug", "device", "distributed_type", "local_process_index",
                    "num_processes", "process_index"]

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
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world > 1:
            raise NotImplementedError(
                f"WORLD_SIZE={world}: several processes are not ported to accelerate_tpu_torch "
                "yet (ROADMAP.md A6)")
        dev = resolve_device("cpu" if cpu else device)
        self.debug = os.environ.get("ACCELERATE_DEBUG_MODE", "0").lower() in (
            "1", "y", "yes", "t", "true", "on")
        self.device = dev
        self.num_processes = 1
        self.process_index = 0
        self.local_process_index = 0
        self.distributed_type = DistributedType.NO

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
        """A barrier across processes: nothing to wait for at one."""

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
        yield inputs

    def print(self, *args, **kwargs):
        if self.is_local_main_process:
            print(*args, **kwargs)

    @classmethod
    def _reset_state(cls) -> None:
        cls._shared_state.clear()

    def __repr__(self) -> str:
        return (f"Distributed environment: {self.distributed_type}\n"
                f"Num processes: {self.num_processes}\n"
                f"Process index: {self.process_index}\n"
                f"Local process index: {self.local_process_index}\n"
                f"Device: {self.device}\n")


class AcceleratorState:
    """The process (:class:`PartialState`, whose attributes it passes
    through) plus the ``mixed_precision`` mode (argument, else
    ``ACCELERATE_MIXED_PRECISION``, else ``"no"``), its ``dtype_policy``
    and ``distributed_type``."""

    _shared_state: dict = {}
    _known_attrs = PartialState._known_attrs + ["mixed_precision", "dtype_policy"]

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False, device=None,
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
        partial_state = PartialState(cpu, device=device, **kwargs)
        self._partial = partial_state
        # Env-opt-in observability (ACCELERATE_TPU_TELEMETRY=1) goes live
        # once the process state exists, as in the JAX package.
        from .telemetry import maybe_enable_from_env

        maybe_enable_from_env()
        self._mixed_precision = mode
        self.dtype_policy = policy
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
