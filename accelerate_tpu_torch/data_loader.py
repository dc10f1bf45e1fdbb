"""The data pipeline of the single-GPU training loop: the one-process
branches of the JAX package's ``data_loader.py``.

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
- :func:`prepare_data_loader` and :func:`skip_first_batches`.

The JAX loader's mesh placement (``_GlobalBatchPlacer``), the dispatcher
(``DataLoaderDispatcher``) and the health-quarantine and fault-injection
hooks belong to multi-GPU and resilience work and are not ported.
"""

from __future__ import annotations

import itertools
import math
from typing import Iterable, Iterator, Optional

import numpy as np
import torch
import torch.utils.data

from .pipeline.prefetch import DevicePrefetcher, prefetch_depth_from_env
from .state import GradientState, resolve_device
from .utils.operations import send_to_device

__all__ = [
    "BatchSamplerShard",
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


class IterableDatasetShard:
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

    def _convert(self, batch):
        if self.device is None:
            return batch
        return send_to_device(batch, self.device, non_blocking=self.non_blocking)

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
        prefetcher = DevicePrefetcher(iterator, lambda b: send_to_device(
            b, self.device, non_blocking=True), depth, device=self.device)
        self.prefetch_blocked_ms = prefetcher.blocked_ms
        emitted = 0
        try:
            for converted, is_last in prefetcher:
                if is_last:
                    self.end_of_dataloader = True
                emitted += 1
                self._yielded = self.skip_batches + emitted
                yield converted
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
        batch_index = 0
        converted = self._convert(current) if self.skip_batches == 0 else None
        while True:
            try:
                upcoming = next(iterator)
            except StopIteration:
                self.end_of_dataloader = True
                if batch_index >= self.skip_batches:
                    self._yielded = batch_index + 1
                    yield converted
                break
            upcoming_converted = (self._convert(upcoming)
                                  if batch_index + 1 >= self.skip_batches else None)
            if batch_index >= self.skip_batches:
                self._yielded = batch_index + 1
                yield converted
            batch_index += 1
            converted = upcoming_converted
        self._finish_epoch()


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
                        gradient_state: Optional[GradientState] = None) -> DataLoaderShard:
    """Wrap ``dataloader`` for one GPU (the JAX ``prepare_data_loader`` at
    one process):

    - a torch ``DataLoader`` over a map-style dataset is rebuilt over the
      same dataset: a ``RandomSampler`` becomes a
      :class:`SeedableRandomSampler` under ``use_seedable_sampler``, or gets
      a generator seeded with ``data_seed`` (42 when None) when it has none
      (the JAX ``Accelerator``'s default ``rng_types=["generator"]``);
      ``static_shape_tail`` wraps
      the batch sampler in :class:`BatchSamplerShard`;
    - over an iterable dataset it is rebuilt with the same batch size, and
      one with ``batch_size=None`` keeps handing samples over unbatched;
    - any other iterable of batches is wrapped as it is.

    The result is a :class:`DataLoaderShard` on ``device`` (default
    ``cuda``)."""
    common = dict(device=device, put_on_device=put_on_device, non_blocking=non_blocking,
                  use_stateful_dataloader=use_stateful_dataloader,
                  prefetch_to_device=prefetch_to_device, gradient_state=gradient_state)
    if not isinstance(dataloader, torch.utils.data.DataLoader):
        return DataLoaderShard(dataloader, **common)
    dataset = dataloader.dataset
    if isinstance(dataset, torch.utils.data.IterableDataset):
        base = torch.utils.data.DataLoader(
            dataset, batch_size=dataloader.batch_size, collate_fn=dataloader.collate_fn,
            num_workers=dataloader.num_workers, drop_last=dataloader.drop_last,
            pin_memory=dataloader.pin_memory)
        return DataLoaderShard(base, total_batch_size=dataloader.batch_size or 1, **common)

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
    if static_shape_tail and getattr(batch_sampler, "batch_size", None) is not None:
        batch_sampler = BatchSamplerShard(batch_sampler, split_batches=split_batches,
                                          even_batches=even_batches)
    return DataLoaderShard(torch.utils.data.DataLoader(
        dataset, batch_sampler=batch_sampler, **loader_kw), **common)


def skip_first_batches(dataloader, num_batches: int = 0):
    """A loader that starts ``num_batches`` into the epoch: a prepared
    :class:`DataLoaderShard` keeps its device and options; any other
    loader is wrapped without placement."""
    if isinstance(dataloader, DataLoaderShard):
        return DataLoaderShard(
            dataloader.base_loader, device=dataloader.device, skip_batches=num_batches,
            put_on_device=dataloader.put_on_device, non_blocking=dataloader.non_blocking,
            use_stateful_dataloader=dataloader.use_stateful_dataloader,
            prefetch_to_device=dataloader.prefetch_to_device,
            gradient_state=dataloader.gradient_state,
            total_batch_size=dataloader._total_batch_size)
    return SkipDataLoader(dataloader, skip_batches=num_batches, put_on_device=False)
