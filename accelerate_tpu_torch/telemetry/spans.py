"""Trace spans: ``with span("name"):`` / ``@span("name")``.

Each span records wall-time, process index, and nesting (a thread-local name
stack) to the telemetry JSONL sink, and mirrors into
``torch.profiler.record_function`` so the same names show up as
``user_annotation`` events in the traces ``Accelerator.profile()`` and the
flight recorder's window capture (``profile_scan`` segments steps by them).

When telemetry is disabled, ``__enter__`` is a single attribute check — safe
to leave on every hot path.
"""

from __future__ import annotations

import functools
import threading
import time

from .core import get_telemetry

__all__ = ["span"]

_tls = threading.local()


class span:
    """Context manager AND decorator.

    >>> with span("checkpoint.save", path=out_dir):
    ...     ...
    >>> @span("train_step")
    ... def train_step(...): ...
    """

    __slots__ = ("name", "attrs", "_tel", "_t0", "_ann", "_path")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self._tel = None
        self._t0 = None
        self._ann = None
        self._path = None

    def __enter__(self):
        tel = get_telemetry()
        if not tel.enabled:
            return self
        self._tel = tel
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._path = "/".join(stack + [self.name])
        stack.append(self.name)
        try:
            import torch

            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        except Exception:
            self._ann = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._t0 is None:  # telemetry was off at __enter__
            return False
        dur_ms = (time.perf_counter() - self._t0) * 1e3
        self._t0 = None
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:
                pass
            self._ann = None
        stack = _tls.stack
        if stack and stack[-1] == self.name:
            stack.pop()
        tel = self._tel
        self._tel = None
        record = {
            "kind": "span",
            "name": self.name,
            "path": self._path,
            "depth": len(stack),
            "dur_ms": round(dur_ms, 3),
        }
        if exc_type is not None:
            record["error"] = exc_type.__name__
        if self.attrs:
            record["attrs"] = self.attrs
        tel.write(record)
        tel.registry.histogram(f"span.{self.name}_ms").observe(dur_ms)
        return False

    def __call__(self, fn):
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            # A fresh span per call: enablement is re-checked at call time, so
            # decorating at import time costs nothing until telemetry turns on.
            with span(name, **attrs):
                return fn(*args, **kwargs)

        return wrapped
