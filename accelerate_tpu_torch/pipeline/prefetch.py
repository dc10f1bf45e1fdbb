"""Asynchronous device prefetch: batches copied to the GPU ahead of the
training loop, the port of the JAX package's ``pipeline/prefetch.py``.

A :class:`DevicePrefetcher` runs one worker thread that pulls host batches,
converts them (``send_to_device``) up to ``depth`` batches ahead, and hands
them over in order with an ``is_last`` flag computed from a one-batch
lookahead, so the owning loader can flip ``end_of_dataloader`` before the
last batch reaches user code.  An exception in the worker reaches the
consumer in the batch's place, where the synchronous loader would raise.

On a CUDA device the worker pins each host tensor and copies it on a CUDA
stream of its own, then records an event; before yielding, the consumer
makes its current (compute) stream wait on that event, and marks every
tensor with ``record_stream`` so the caching allocator does not hand the
memory back to the copy stream while the compute stream may still read
it.  On the CPU the same class runs without streams.

``blocked_ms`` keeps, per batch, how long the consumer waited for the
worker: near zero means the copies left the loop's critical path.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

import torch

from ..utils.operations import recursively_apply

__all__ = ["DevicePrefetcher", "ENV_PREFETCH", "prefetch_depth_from_env"]

ENV_PREFETCH = "ACCELERATE_TPU_PREFETCH"


def prefetch_depth_from_env(default: int = 0) -> int:
    """Prefetch depth from ``$ACCELERATE_TPU_PREFETCH`` (0, unset or not an
    integer: ``default``)."""
    raw = os.environ.get(ENV_PREFETCH, "").strip()
    if not raw:
        return default
    try:
        return max(int(raw), 0)
    except ValueError:
        return default


class _WorkerError:
    """An exception pushed through the queue in position, so the consumer
    raises exactly where the stream broke."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()


def _pinned(t: torch.Tensor) -> torch.Tensor:
    return t.pin_memory() if t.device.type == "cpu" and not t.is_pinned() else t


class DevicePrefetcher:
    """Iterate ``(converted, is_last)`` over ``iterator``.

    ``convert(raw)`` runs only on the worker thread.  With a CUDA ``device``
    it runs with the worker's copy stream current, after the host tensors
    are pinned, so a ``non_blocking`` copy inside it is asynchronous."""

    def __init__(self, iterator: Iterable, convert: Callable, depth: int = 1,
                 device: Optional[torch.device] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = depth
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.blocked_ms: list = []
        self._iterator = iter(iterator)
        self._convert = convert
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._closed = False
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
        self._thread = threading.Thread(target=self._worker, name="atpu-torch-prefetch",
                                        daemon=True)
        self._thread.start()

    # -- worker -----------------------------------------------------------------

    def _put(self, item) -> bool:
        """Blocking put that stays responsive to :meth:`close`; False when
        stopped."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _convert_one(self, raw):
        """``(converted, event)``: the copy and, on CUDA, the event recorded
        on the copy stream after it."""
        if self._stream is None:
            return self._convert(raw), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = self._convert(recursively_apply(_pinned, raw))
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _worker(self):
        try:
            try:
                current = next(self._iterator)
            except StopIteration:
                self._put(_DONE)
                return
            while not self._stop.is_set():
                converted = self._convert_one(current)
                try:
                    upcoming = next(self._iterator)
                except StopIteration:
                    self._put((converted, True))
                    self._put(_DONE)
                    return
                if not self._put((converted, False)):
                    return
                current = upcoming
        except BaseException as exc:  # re-raised on the consumer, in position
            self._put(_WorkerError(exc))

    # -- consumer ---------------------------------------------------------------

    def __iter__(self) -> Iterator:
        while True:
            t0 = time.perf_counter()
            item = self._queue.get()
            if item is _DONE:
                return
            self.blocked_ms.append((time.perf_counter() - t0) * 1e3)
            if isinstance(item, _WorkerError):
                raise item.exc
            (converted, event), is_last = item
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                recursively_apply(lambda t: t.record_stream(stream)
                                  if t.device.type == "cuda" else None, converted)
            yield converted, is_last

    def close(self):
        """Stop the worker and drop queued batches (idempotent): an abandoned
        epoch must not leave a thread copying batches."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __del__(self):  # pragma: no cover - GC timing
        if hasattr(self, "_thread"):
            self.close()
