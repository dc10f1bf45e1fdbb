"""The data pipeline of the training loop: the JAX package's
``data_loader.py``, one process per GPU.

- :class:`SeedableRandomSampler`: a permutation seeded with
  ``initial_seed + epoch`` (numpy, or a torch generator when given);
- :class:`BatchSamplerShard` and :class:`IterableDatasetShard`: the
  index math of sharded loading (at one process the former gives the
  static-shape tail, a short last batch filled from the epoch's start);
- :class:`DataLoaderShard`: yields batches on the accelerator's device
  with a one-batch lookahead, so ``end_of_dataloader`` turns True before
  the last batch reaches user code; with ``prefetch_to_device`` a worker
  thread copies batches ahead on a CUDA stream of its own
  (:class:`~accelerate_tpu_torch.pipeline.prefetch.DevicePrefetcher`);
  ``state_dict`` records the batches the user has seen this epoch;
- :class:`DataLoaderDispatcher` (``dispatch_batches=True``): the main
  process reads each global batch and broadcasts it; every process keeps
  its rows;
- :func:`prepare_data_loader` (with several processes each one loads its
  share through :class:`BatchSamplerShard` / :class:`IterableDatasetShard`)
  and :func:`skip_first_batches`.

The loader carries the JAX loader's numerical-health hooks: positions the
``HealthGuard`` quarantined (``quarantine``) are read but never yielded, and
``ACCELERATE_TPU_FAULT_BAD_BATCH`` NaN-laces one position every epoch.  The
JAX loader's mesh placement (``_GlobalBatchPlacer``) splits a host's batch
over its devices and pads it to divide; with one device per process a
process's rows go to its device whole (``send_to_device``), so no row is
appended there and nothing of it is ported.
"""

from __future__ import annotations

import itertools
import math
from typing import Iterable, Iterator, Optional

import numpy as np
import torch
import torch.utils.data

from .pipeline.prefetch import DevicePrefetcher, prefetch_depth_from_env
from .logging import get_logger
from .state import GradientState, resolve_device
from .telemetry import get_telemetry as _get_telemetry
from .telemetry import span as _span
from .utils.operations import send_to_device

logger = get_logger(__name__)

__all__ = [
    "BatchSamplerShard",
    "DataLoaderDispatcher",
    "DataLoaderShard",
    "DataLoaderStateMixin",
    "IterableDatasetShard",
    "SeedableRandomSampler",
    "SkipBatchSampler",
    "SkipDataLoader",
    "get_sampler",
    "prepare_data_loader",
    "skip_first_batches",
]


class SeedableRandomSampler:
    """Random sampler reseeded as ``initial_seed + epoch`` at every epoch:
    a torch ``randperm`` when a ``generator`` is given, numpy's
    ``default_rng(seed).permutation`` otherwise.  ``epoch`` advances when an
    epoch is exhausted, and :meth:`set_epoch` sets it."""

    def __init__(self, data_source, initial_seed: Optional[int] = None, generator=None):
        self.data_source = data_source
        if initial_seed is None:
            initial_seed = int(np.random.SeedSequence().generate_state(1)[0])
        self.initial_seed = initial_seed
        self.epoch = 0
        self.generator = generator

    def __len__(self):
        return len(self.data_source)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        seed = self.epoch + self.initial_seed
        if self.generator is not None:
            self.generator.manual_seed(seed)
            yield from torch.randperm(len(self.data_source), generator=self.generator).tolist()
        else:
            yield from np.random.default_rng(seed).permutation(len(self.data_source)).tolist()
        self.epoch += 1


class BatchSamplerShard:
    """One process's share of a batch sampler.

    ``split_batches=True``: every process gets 1/N of every batch;
    otherwise whole batches are dealt round-robin in windows of
    ``num_processes``.  ``even_batches=True`` fills a short tail from the
    epoch's first indices so every process gets equally many full batches
    (at one process: a static batch shape)."""

    def __init__(self, batch_sampler, num_processes: int = 1, process_index: int = 0,
                 split_batches: bool = False, even_batches: bool = True):
        self.batch_sampler = batch_sampler
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)
        if split_batches and self.batch_size is not None and self.batch_size % num_processes:
            raise ValueError(f"In split_batches mode the batch size ({self.batch_size}) must be "
                             f"a round multiple of num_processes ({num_processes}).")
        if self.batch_size is None and self.even_batches:
            raise ValueError("You need `even_batches=False` when the batch sampler has no "
                             "fixed batch size.")

    def set_epoch(self, epoch: int):
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    @property
    def total_length(self) -> int:
        return len(self.batch_sampler)

    def __len__(self) -> int:
        n = len(self.batch_sampler)
        if self.split_batches:
            return n
        if n % self.num_processes == 0:
            return n // self.num_processes
        base = n // self.num_processes
        if self.drop_last:
            return base
        if self.even_batches:
            return base + 1
        return base + 1 if self.process_index < n % self.num_processes else base

    def __iter__(self) -> Iterator[list]:
        return self._iter_split() if self.split_batches else self._iter_whole()

    def _iter_split(self) -> Iterator[list]:
        per_proc = self.batch_size // self.num_processes
        lo, hi = per_proc * self.process_index, per_proc * (self.process_index + 1)
        first_full_batch: list = []
        tail: list = []
        seen_any = False
        for batch in self.batch_sampler:
            seen_any = True
            if not first_full_batch:
                first_full_batch = list(batch)
            if len(batch) == self.batch_size:
                tail = []
                yield list(batch)[lo:hi]
            else:
                tail = list(batch)  # only ever the final, short batch
        if self.drop_last or not seen_any or not tail:
            return
        if not self.even_batches:
            if len(tail) > lo:
                yield tail[lo:hi]
            return
        filler = list(first_full_batch)
        while len(filler) < self.batch_size:
            filler = filler + filler
        yield (tail + filler)[lo:hi]

    def _iter_whole(self) -> Iterator[list]:
        first_indices: list = []  # the first num_processes batches, flattened
        pending: list = []  # this process's batch of the window in flight
        last: list = []
        count = 0
        for batch in self.batch_sampler:
            batch = list(batch)
            if not self.drop_last and count < self.num_processes:
                first_indices.extend(batch)
            if count % self.num_processes == self.process_index:
                pending = batch
            last = batch
            count += 1
            if count % self.num_processes == 0 and (
                self.batch_size is None or len(batch) == self.batch_size
            ):
                yield pending
                pending = []
        if self.drop_last or not first_indices:
            return
        if not self.even_batches:
            if pending:
                yield pending
            return
        # Even tail: flush a full pending batch, then deal wrapped-around
        # batches until every process has yielded as many.
        if len(pending) == self.batch_size:
            yield pending
        while len(first_indices) < self.num_processes * self.batch_size:
            first_indices = first_indices + first_indices
        pos = count - 1
        if len(last) == self.batch_size:
            last = []
            pos += 1
        cursor = 0
        while pos % self.num_processes != 0 or len(last) > 0:
            take = cursor + self.batch_size - len(last)
            last = last + first_indices[cursor:take]
            if pos % self.num_processes == self.process_index:
                yield last
            cursor = take
            last = []
            pos += 1


class IterableDatasetShard(torch.utils.data.IterableDataset):
    """One process's share of an iterable dataset: buffer one real batch
    (``batch_size`` per process, or the whole batch under
    ``split_batches``), emit this process's slice, and fill a short tail
    from the first batch unless ``drop_last``."""

    def __init__(self, dataset, batch_size: int = 1, drop_last: bool = False,
                 num_processes: int = 1, process_index: int = 0, split_batches: bool = False):
        if split_batches and batch_size > 1 and batch_size % num_processes:
            raise ValueError(f"In split_batches mode the batch size ({batch_size}) must be a "
                             f"round multiple of num_processes ({num_processes}).")
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        chunk = self.batch_size * self.num_processes
        if self.drop_last:
            return (len(self.dataset) // chunk) * self.batch_size
        return math.ceil(len(self.dataset) / chunk) * self.batch_size

    def __iter__(self):
        if (not hasattr(self.dataset, "set_epoch")
                and isinstance(getattr(self.dataset, "generator", None), torch.Generator)):
            self.dataset.generator.manual_seed(self.epoch)
        real = self.batch_size if self.split_batches else self.batch_size * self.num_processes
        mine = self.batch_size // self.num_processes if self.split_batches else self.batch_size
        lo = self.process_index * mine
        buffer: list = []
        first_full: Optional[list] = None
        for element in self.dataset:
            buffer.append(element)
            if len(buffer) == real:
                yield from buffer[lo: lo + mine]
                if first_full is None:
                    first_full = list(buffer)
                buffer = []
        if self.drop_last or not buffer:
            return
        if first_full is None:
            first_full = list(buffer)
        while len(buffer) < real:
            buffer = buffer + first_full
        yield from buffer[lo: lo + mine]


class DataLoaderStateMixin:
    """End-of-dataloader and remainder bookkeeping on the loader's
    :class:`~accelerate_tpu_torch.state.GradientState`, and the stateful
    position (``state_dict`` / ``load_state_dict``)."""

    def __init_subclass__(cls, **kwargs):
        cls.end_of_dataloader = False
        cls.remainder = -1

    def reset(self):
        self.end_of_dataloader = False
        self.remainder = -1

    def begin(self):
        self.reset()
        self._yielded = self.skip_batches
        try:
            length = getattr(self.dataset, "total_dataset_length", len(self.dataset))
            self.remainder = length % self.total_batch_size
        except TypeError:  # an iterable dataset has no length
            pass
        self.gradient_state._add_dataloader(self)

    def end(self):
        self.gradient_state._remove_dataloader(self)

    def state_dict(self) -> dict:
        """The position within the epoch: ``batches_yielded`` batches the
        user has seen (the one in hand counts, the lookahead and prefetched
        ones do not) and the epoch counter ``iteration``.  Between epochs
        it is position 0 of the next epoch."""
        return {"batches_yielded": getattr(self, "_yielded", 0), "iteration": self.iteration}

    def load_state_dict(self, state_dict: dict) -> None:
        """The next epoch starts after the recorded batches (once: later
        epochs run in full), and the epoch counter is restored so
        ``set_epoch``-driven shuffles line up."""
        self.skip_batches = int(state_dict.get("batches_yielded", 0))
        self.iteration = int(state_dict.get("iteration", 0))
        self._yielded = self.skip_batches
        self._skip_once = True

    def _consume_skip_once(self):
        if getattr(self, "_skip_once", False):
            self.skip_batches = 0
            self._skip_once = False

    # -- numerical-health hooks (resilience/health.py) ------------------------
    #
    # Quarantine: positions fingerprinted as (epoch, user-visible batch index)
    # are consumed but never yielded — the post-rewind replay of a run whose
    # step went non-finite twice on the same batch drops that batch.  The
    # fingerprint is EPOCH-scoped: under a shuffling sampler the data at
    # index i differs between epochs, so only replays of the same epoch (the
    # rewind case — ``load_state_dict`` restores ``iteration``) skip it.
    # ``load_state_dict`` never touches the set, so a rewind keeps it.

    def quarantine(self, fingerprints) -> None:
        """Register ``(epoch, batch_index)`` fingerprints to skip at yield
        time (``HealthGuard`` pushes its quarantine set through here)."""
        q = getattr(self, "_quarantined", None)
        if q is None:
            q = self._quarantined = set()
        q.update((int(e), int(i)) for e, i in fingerprints)

    def _is_quarantined(self, index: int) -> bool:
        q = getattr(self, "_quarantined", None)
        return bool(q) and (self.iteration, index) in q

    def _count_quarantine_skip(self, index: int) -> None:
        tel = _get_telemetry()
        if tel.enabled:
            tel.registry.counter("health.quarantine_skips").inc()
        logger.warning(
            f"health: skipping quarantined batch (epoch={self.iteration}, index={index})"
        )

    def _maybe_poison(self, batch, index: int):
        """Fault injection (``ACCELERATE_TPU_FAULT_BAD_BATCH=<i>``): NaN-lace
        the armed per-epoch position.  One cached-None check when unarmed."""
        from .resilience import faultinject

        if faultinject.bad_batch_index() is None:
            return batch
        return faultinject.maybe_poison_batch(batch, index)


class DataLoaderShard(DataLoaderStateMixin):
    """Wraps an iterable of batches (typically a torch ``DataLoader``) and
    yields them on ``device`` (default ``cuda``; raises without CUDA unless
    ``put_on_device=False`` or a CPU device is given).

    Without prefetch, batch ``n + 1`` is fetched and its copy issued before
    batch ``n`` is yielded; with ``prefetch_to_device=N`` (or
    ``$ACCELERATE_TPU_PREFETCH``) a worker thread copies up to ``N``
    batches ahead.  Either way ``end_of_dataloader`` is True while the last
    batch is in hand.  ``skip_batches`` batches at the start of the (next)
    epoch are read and dropped."""

    def __init__(self, base_loader: Iterable, device=None, skip_batches: int = 0,
                 put_on_device: bool = True, non_blocking: bool = False,
                 use_stateful_dataloader: bool = False, prefetch_to_device: int = 0,
                 gradient_state: Optional[GradientState] = None,
                 total_batch_size: Optional[int] = None):
        self.base_loader = base_loader
        self.device = resolve_device(device) if put_on_device else None
        self.skip_batches = skip_batches
        self.put_on_device = put_on_device
        self.non_blocking = non_blocking
        self.use_stateful_dataloader = use_stateful_dataloader
        self.prefetch_to_device = prefetch_to_device
        self.gradient_state = gradient_state if gradient_state is not None else GradientState()
        self.iteration = 0
        self._yielded = 0
        self._total_batch_size = total_batch_size
        self.prefetch_blocked_ms: list = []

    @property
    def dataset(self):
        return getattr(self.base_loader, "dataset", self.base_loader)

    @property
    def batch_sampler(self):
        return getattr(self.base_loader, "batch_sampler", None)

    @property
    def sampler(self):
        """The sampler that orders the indices: the one under the batch
        sampler (through :class:`BatchSamplerShard` or
        :class:`SkipBatchSampler`) when there is one.  A torch ``DataLoader``
        built from a batch sampler also holds a ``SequentialSampler`` it
        never reads; the JAX loader returns that one, and so never saves
        its seedable sampler's state nor sets its epoch."""
        bs = self.batch_sampler
        while bs is not None and getattr(bs, "sampler", None) is None:
            bs = getattr(bs, "batch_sampler", None)
        if bs is not None:
            return bs.sampler
        return getattr(self.base_loader, "sampler", None)

    def __len__(self):
        return len(self.base_loader) - self.skip_batches

    @property
    def total_batch_size(self) -> int:
        if self._total_batch_size is not None:
            return self._total_batch_size
        sampler = self.batch_sampler
        if isinstance(sampler, BatchSamplerShard):
            return sampler.batch_size * (1 if sampler.split_batches else sampler.num_processes)
        bs = getattr(sampler, "batch_size", None)
        return bs if bs is not None else (getattr(self.base_loader, "batch_size", None) or 1)

    @property
    def total_dataset_length(self) -> int:
        return len(self.dataset)

    def set_epoch(self, epoch: int):
        self.iteration = epoch
        for obj in (self.base_loader, self.batch_sampler, self.sampler, self.dataset):
            if obj is not None and obj is not self and hasattr(obj, "set_epoch"):
                obj.set_epoch(epoch)

    def _convert(self, batch, non_blocking: Optional[bool] = None):
        """Place one batch on the loader's device (as it is without one),
        under the ``dataloader.next_batch`` span; runs on the prefetch
        worker in the prefetched path."""
        with _span("dataloader.next_batch"):
            out = batch if self.device is None else send_to_device(
                batch, self.device,
                non_blocking=self.non_blocking if non_blocking is None else non_blocking)
        tel = _get_telemetry()
        if tel.enabled:
            tel.registry.counter("dataloader.batches").inc()
            tel.heartbeat()  # host-side data stalls must not trip the watchdog
        return out

    def _effective_prefetch_depth(self) -> int:
        if self.device is None:
            return 0
        return self.prefetch_to_device or prefetch_depth_from_env()

    def _iter_prefetched(self, iterator, depth: int):
        for _ in range(self.skip_batches):  # read, never copied
            try:
                next(iterator)
            except StopIteration:
                break
        # The worker's copies are asynchronous only from pinned memory.
        prefetcher = DevicePrefetcher(iterator, lambda b: self._convert(b, non_blocking=True),
                                      depth, device=self.device)
        self.prefetch_blocked_ms = prefetcher.blocked_ms
        emitted = 0
        try:
            for converted, is_last in prefetcher:
                if is_last:
                    self.end_of_dataloader = True
                pos = self.skip_batches + emitted
                emitted += 1
                self._yielded = pos + 1
                if self._is_quarantined(pos):
                    # Read (the position advances for state_dict), never yielded.
                    self._count_quarantine_skip(pos)
                    continue
                yield self._maybe_poison(converted, pos)
        finally:
            prefetcher.close()
        if emitted == 0:  # the skip covered the whole epoch
            self.end_of_dataloader = True

    def _finish_epoch(self):
        self.iteration += 1
        # A state_dict taken between epochs records position 0 of the next.
        self._yielded = 0
        self._consume_skip_once()
        self.end()

    def __iter__(self):
        self.begin()
        self.set_epoch(self.iteration)
        iterator = iter(self.base_loader)
        try:
            current = next(iterator)
        except StopIteration:
            self.end()
            return
        depth = self._effective_prefetch_depth()
        if depth > 0:
            yield from self._iter_prefetched(itertools.chain([current], iterator), depth)
            self._finish_epoch()
            return
        # One-batch lookahead: the last yield flips end_of_dataloader before
        # user code sees that batch, and batch n + 1's copy is issued before
        # batch n is yielded.
        def emits(index: int) -> bool:
            # A quarantined position is read (the state_dict position still
            # advances) but neither copied nor yielded.
            return index >= self.skip_batches and not self._is_quarantined(index)

        batch_index = 0
        converted = self._convert(current) if emits(0) else None
        while True:
            try:
                upcoming = next(iterator)
            except StopIteration:
                self.end_of_dataloader = True
                if batch_index >= self.skip_batches:
                    self._yielded = batch_index + 1
                    if emits(batch_index):
                        yield self._maybe_poison(converted, batch_index)
                    else:
                        self._count_quarantine_skip(batch_index)
                break
            upcoming_converted = self._convert(upcoming) if emits(batch_index + 1) else None
            if batch_index >= self.skip_batches:
                self._yielded = batch_index + 1
                if emits(batch_index):
                    yield self._maybe_poison(converted, batch_index)
                else:
                    self._count_quarantine_skip(batch_index)
            batch_index += 1
            converted = upcoming_converted
        self._finish_epoch()


class DataLoaderDispatcher(DataLoaderStateMixin):
    """The main process reads the loader and broadcasts each global batch
    (``num_processes`` of its batches concatenated, or one batch under
    ``split_batches``); every process keeps its data shard's rows, ``bs //
    n`` of them in shard order after a batch that does not divide is grown
    by repeating its last row (:func:`~.utils.operations.pad_input_tensors`),
    and places them on its device.  ``num_processes`` / ``process_index``
    are the data shards and this process's shard (default: one per
    process; ``prepare_data_loader`` passes the mesh's data degree and
    index, so processes that differ only on ``tp`` or ``ep`` read the same
    rows).  For a dataset that cannot be sharded by index, such as a
    stream."""

    def __init__(self, base_loader: Iterable, split_batches: bool = False, skip_batches: int = 0,
                 device=None, put_on_device: bool = True, non_blocking: bool = False,
                 use_stateful_dataloader: bool = False, even_batches: bool = True,
                 gradient_state: Optional[GradientState] = None, slice_fn=None,
                 num_processes: Optional[int] = None, process_index: Optional[int] = None):
        from .state import PartialState
        from .utils.operations import slice_tensors

        self.base_loader = base_loader
        self.split_batches = split_batches
        self.skip_batches = skip_batches
        self.use_stateful_dataloader = use_stateful_dataloader
        self.even_batches = even_batches
        self.state = PartialState()
        self.gradient_state = gradient_state if gradient_state is not None else GradientState()
        self.device = resolve_device(device if device is not None else self.state.device) \
            if put_on_device else None
        self.put_on_device = put_on_device
        self.non_blocking = non_blocking
        self.slice_fn = slice_fn or slice_tensors
        self.iteration = 0
        self._yielded = 0
        self._num_parts = max(self.state.num_processes if num_processes is None
                              else num_processes, 1)
        self._part = self.state.process_index if process_index is None else process_index

    @property
    def dataset(self):
        return getattr(self.base_loader, "dataset", self.base_loader)

    def __len__(self):
        n = len(self.base_loader)
        if not self.split_batches:
            n = math.ceil(n / self._num_parts)
        return n - self.skip_batches

    @property
    def total_batch_size(self) -> int:
        bs = getattr(self.base_loader, "batch_size", 1) or 1
        return bs if self.split_batches else bs * self._num_parts

    @property
    def total_dataset_length(self) -> int:
        return len(self.dataset)

    def set_epoch(self, epoch: int):
        self.iteration = epoch
        if hasattr(self.base_loader, "set_epoch"):
            self.base_loader.set_epoch(epoch)
        elif hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _fetch_global_batch(self, iterator):
        """The main process assembles the global batch and broadcasts
        ``[stop, batch]``."""
        from .utils.operations import broadcast_object_list, concatenate

        stop, batch = False, None
        if self.state.is_main_process:
            if self.split_batches:
                try:
                    batch = next(iterator)
                except StopIteration:
                    stop = True
            else:
                parts = []
                for _ in range(self._num_parts):
                    try:
                        parts.append(next(iterator))
                    except StopIteration:
                        break
                if not parts:
                    stop = True
                else:
                    batch = concatenate(parts, dim=0) if len(parts) > 1 else parts[0]
        if self.state.num_processes > 1:
            info = broadcast_object_list([stop, batch])
            stop, batch = info
        return stop, batch

    def _emit(self, global_batch):
        """This process's rows of ``global_batch``, placed."""
        from .utils.operations import find_batch_size, ignorant_find_batch_size, pad_input_tensors

        with _span("dataloader.next_batch"):
            n = self._num_parts
            bs = ignorant_find_batch_size(global_batch)
            if n > 1 and bs is not None:
                if bs % n:
                    global_batch = pad_input_tensors(global_batch, bs, n)
                    bs = find_batch_size(global_batch)
                per = bs // n
                lo = per * self._part
                global_batch = self.slice_fn(global_batch, slice(lo, lo + per),
                                             process_index=self._part, num_processes=n)
            out = global_batch
            if self.put_on_device:
                out = send_to_device(global_batch, self.device, non_blocking=self.non_blocking)
        tel = _get_telemetry()
        if tel.enabled:
            tel.registry.counter("dataloader.batches").inc()
            tel.heartbeat()
        return out

    def __iter__(self):
        from .utils.operations import ignorant_find_batch_size

        self.begin()
        self.set_epoch(self.iteration)
        iterator = iter(self.base_loader) if self.state.is_main_process else iter(())
        batch_index = 0
        prev = None
        while True:
            stop, batch = self._fetch_global_batch(iterator)
            if stop:
                if prev is not None:
                    self.end_of_dataloader = True
                    bs = ignorant_find_batch_size(prev)
                    if bs is not None:
                        self.remainder = bs % self.total_batch_size or self.remainder
                    if batch_index - 1 >= self.skip_batches:
                        self._yielded = batch_index
                        if self._is_quarantined(batch_index - 1):
                            self._count_quarantine_skip(batch_index - 1)
                        else:
                            yield self._maybe_poison(self._emit(prev), batch_index - 1)
                break
            if prev is not None and batch_index - 1 >= self.skip_batches:
                self._yielded = batch_index
                if self._is_quarantined(batch_index - 1):
                    self._count_quarantine_skip(batch_index - 1)
                else:
                    yield self._maybe_poison(self._emit(prev), batch_index - 1)
            prev = batch
            batch_index += 1
        self.iteration += 1
        self._yielded = 0
        self._consume_skip_once()
        self.end()


class SkipBatchSampler:
    """A batch sampler without its first ``skip_batches`` batches."""

    def __init__(self, batch_sampler, skip_batches: int = 0):
        self.batch_sampler = batch_sampler
        self.skip_batches = skip_batches

    def __iter__(self):
        for index, samples in enumerate(self.batch_sampler):
            if index >= self.skip_batches:
                yield samples

    @property
    def total_length(self):
        return len(self.batch_sampler)

    def __len__(self):
        return len(self.batch_sampler) - self.skip_batches


class SkipDataLoader(DataLoaderShard):
    """A loader yielding everything after its first ``skip_batches``
    batches."""

    def __init__(self, base_loader, skip_batches: int = 0, **kwargs):
        super().__init__(base_loader, skip_batches=skip_batches, **kwargs)


def get_sampler(dataloader):
    """The sampler under a torch ``DataLoader``'s batch sampler (or its own)."""
    if getattr(dataloader, "batch_sampler", None) is not None:
        return getattr(dataloader.batch_sampler, "sampler", None)
    return getattr(dataloader, "sampler", None)


def prepare_data_loader(dataloader, device=None, split_batches: bool = False,
                        put_on_device: bool = True, even_batches: bool = True,
                        use_seedable_sampler: bool = False,
                        data_seed: Optional[int] = None, non_blocking: bool = False,
                        use_stateful_dataloader: bool = False, static_shape_tail: bool = False,
                        prefetch_to_device: int = 0,
                        gradient_state: Optional[GradientState] = None,
                        num_processes: Optional[int] = None,
                        process_index: Optional[int] = None,
                        dispatch_batches: Optional[bool] = None) -> DataLoaderShard:
    """Wrap ``dataloader`` for this process (the JAX ``prepare_data_loader``;
    ``num_processes`` / ``process_index`` default to the process state's,
    and ``batch_size`` is per process unless ``split_batches``):

    - ``dispatch_batches=True``: a :class:`DataLoaderDispatcher` over the
      loader as it is;

    - a torch ``DataLoader`` over a map-style dataset is rebuilt over the
      same dataset: a ``RandomSampler`` becomes a
      :class:`SeedableRandomSampler` under ``use_seedable_sampler``, or gets
      a generator seeded with ``data_seed`` (42 when None) when it has none
      (the JAX ``Accelerator``'s default ``rng_types=["generator"]``);
      with several processes (or ``static_shape_tail``) the batch sampler
      is wrapped in :class:`BatchSamplerShard`;
    - over an iterable dataset it is rebuilt with the same batch size
      (through :class:`IterableDatasetShard` with several processes), and
      one with ``batch_size=None`` keeps handing samples over unbatched;
    - any other iterable of batches is wrapped as it is (one process
      only).

    The result is a :class:`DataLoaderShard` on ``device`` (default
    ``cuda``)."""
    from .state import PartialState

    if num_processes is None or process_index is None:
        live = PartialState() if PartialState._shared_state else None
        if num_processes is None:
            num_processes = live.num_processes if live is not None else 1
        if process_index is None:
            process_index = live.process_index if live is not None else 0
    common = dict(device=device, put_on_device=put_on_device, non_blocking=non_blocking,
                  use_stateful_dataloader=use_stateful_dataloader,
                  prefetch_to_device=prefetch_to_device, gradient_state=gradient_state)
    if dispatch_batches:
        is_loader = isinstance(dataloader, torch.utils.data.DataLoader)
        sampler = get_sampler(dataloader) if is_loader else None
        if use_seedable_sampler and isinstance(sampler, torch.utils.data.RandomSampler):
            seedable = SeedableRandomSampler(
                sampler.data_source, initial_seed=data_seed if data_seed is not None else 42,
                generator=getattr(sampler, "generator", None))
            if getattr(dataloader, "batch_sampler", None) is not None:
                dataloader.batch_sampler.sampler = seedable
        if prefetch_to_device:
            logger.warning("prefetch_to_device is not used by DataLoaderDispatcher: its "
                           "broadcast stays on the main thread")
        return DataLoaderDispatcher(
            dataloader, split_batches=split_batches, device=device, put_on_device=put_on_device,
            non_blocking=non_blocking, use_stateful_dataloader=use_stateful_dataloader,
            even_batches=even_batches, gradient_state=gradient_state,
            num_processes=num_processes, process_index=process_index)
    if not isinstance(dataloader, torch.utils.data.DataLoader):
        if num_processes > 1:
            raise ValueError(
                "Multi-host sharding of a non-torch dataloader requires dispatch_batches=True "
                "or a torch DataLoader.")
        return DataLoaderShard(dataloader, **common)
    dataset = dataloader.dataset
    if isinstance(dataset, torch.utils.data.IterableDataset):
        bs = dataloader.batch_size
        if num_processes > 1:
            if bs is None:
                host_bs, shard_bs = None, 1
            elif split_batches:
                host_bs, shard_bs = bs // num_processes, bs
            else:
                host_bs = shard_bs = bs
            dataset = IterableDatasetShard(
                dataset, batch_size=shard_bs, drop_last=dataloader.drop_last,
                num_processes=num_processes, process_index=process_index,
                split_batches=split_batches)
        else:
            host_bs = bs
        base = torch.utils.data.DataLoader(
            dataset, batch_size=host_bs, collate_fn=dataloader.collate_fn,
            num_workers=dataloader.num_workers, drop_last=dataloader.drop_last,
            pin_memory=dataloader.pin_memory)
        total = (bs or 1) * (1 if split_batches else num_processes)
        return DataLoaderShard(base, total_batch_size=total, **common)

    sampler = get_sampler(dataloader)
    if use_seedable_sampler and isinstance(sampler, torch.utils.data.RandomSampler):
        sampler = SeedableRandomSampler(sampler.data_source,
                                        initial_seed=data_seed if data_seed is not None else 42,
                                        generator=getattr(sampler, "generator", None))
    elif (isinstance(sampler, torch.utils.data.RandomSampler)
          and getattr(sampler, "generator", None) is None):
        sampler.generator = torch.Generator()
        sampler.generator.manual_seed(data_seed if data_seed is not None else 42)

    loader_kw = dict(collate_fn=dataloader.collate_fn, num_workers=dataloader.num_workers,
                     pin_memory=dataloader.pin_memory)
    batch_sampler = dataloader.batch_sampler
    if batch_sampler is None:  # batch_size=None: samples pass through unbatched
        return DataLoaderShard(torch.utils.data.DataLoader(
            dataset, batch_size=None, sampler=sampler, **loader_kw), **common)
    if use_seedable_sampler and sampler is not None:
        batch_sampler = torch.utils.data.BatchSampler(
            sampler, batch_size=batch_sampler.batch_size, drop_last=batch_sampler.drop_last)
    if num_processes > 1 or (static_shape_tail
                             and getattr(batch_sampler, "batch_size", None) is not None):
        batch_sampler = BatchSamplerShard(batch_sampler, num_processes=num_processes,
                                          process_index=process_index,
                                          split_batches=split_batches,
                                          even_batches=even_batches)
    return DataLoaderShard(torch.utils.data.DataLoader(
        dataset, batch_sampler=batch_sampler, **loader_kw), **common)


def skip_first_batches(dataloader, num_batches: int = 0):
    """A loader that starts ``num_batches`` into the epoch: a prepared
    :class:`DataLoaderShard` or :class:`DataLoaderDispatcher` keeps its
    device and options; any other loader is wrapped without placement."""
    if isinstance(dataloader, DataLoaderDispatcher):
        return DataLoaderDispatcher(
            dataloader.base_loader, split_batches=dataloader.split_batches,
            skip_batches=num_batches, device=dataloader.device,
            put_on_device=dataloader.put_on_device, non_blocking=dataloader.non_blocking,
            use_stateful_dataloader=dataloader.use_stateful_dataloader,
            even_batches=dataloader.even_batches, gradient_state=dataloader.gradient_state,
            num_processes=dataloader._num_parts, process_index=dataloader._part)
    if isinstance(dataloader, DataLoaderShard):
        return DataLoaderShard(
            dataloader.base_loader, device=dataloader.device, skip_batches=num_batches,
            put_on_device=dataloader.put_on_device, non_blocking=dataloader.non_blocking,
            use_stateful_dataloader=dataloader.use_stateful_dataloader,
            prefetch_to_device=dataloader.prefetch_to_device,
            gradient_state=dataloader.gradient_state,
            total_batch_size=dataloader._total_batch_size)
    return SkipDataLoader(dataloader, skip_batches=num_batches, put_on_device=False)
