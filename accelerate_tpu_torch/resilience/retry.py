"""Retry/timeout/backoff policy for checkpoint and filesystem I/O.

The port of the JAX package's ``resilience/retry.py``.  ``retrying()``
wraps a callable in exponential backoff with jitter and a wall-clock
deadline, so transient filesystem errors (EIO on a flaky NFS mount, a fuse
layer's UNAVAILABLE) don't kill a multi-hour training run.  Every retry
increments the telemetry counter ``resilience.retries``; exhausting the
policy increments ``resilience.gave_up`` and re-raises the LAST error.

Only plausibly-transient errors are retried by default (see
:func:`default_retryable`); programming errors (TypeError, KeyError, a
corrupt-checkpoint verification failure) and out-of-memory errors re-raise
immediately.
"""

from __future__ import annotations

import functools
import random
import time
from typing import Callable, Optional

import torch

from ..logging import get_logger
from ..telemetry import get_telemetry

logger = get_logger(__name__)

__all__ = ["RetryPolicy", "retrying", "default_retryable"]

# Error-text markers for transient backend failures that arrive wrapped in
# generic exception types (RPC status strings, fuse errors).
_TRANSIENT_MARKERS = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED", "try again")


def _is_oom(exc: BaseException) -> bool:
    """A device out-of-memory error: torch's own type (the CUDA caching
    allocator raises it), or the JAX package's ``RESOURCE_EXHAUSTED``
    status text."""
    return isinstance(exc, torch.OutOfMemoryError) or "RESOURCE_EXHAUSTED" in str(exc)


def default_retryable(exc: BaseException) -> bool:
    """Transient I/O errors only: OS-level I/O failures, timeouts, connection
    drops, and backend errors whose status text marks them transient.  An
    out-of-memory error is deliberately NOT retryable here — retrying the
    same allocation cannot succeed; that failure belongs to
    ``find_executable_batch_size``."""
    if _is_oom(exc):
        return False
    if isinstance(exc, (OSError, TimeoutError, ConnectionError)):
        return True
    text = str(exc)
    return any(marker in text for marker in _TRANSIENT_MARKERS)


class RetryPolicy:
    """Exponential backoff + full jitter + deadline.

    Delays follow ``min(max_delay, base_delay * 2**attempt) * uniform(0.5, 1)``
    (``random.uniform``, so ``random.seed`` fixes the sequence); the policy
    stops at ``tries`` attempts or when the next wait would cross
    ``deadline_s`` of wall-clock, whichever comes first.
    """

    __slots__ = ("tries", "base_delay_s", "max_delay_s", "deadline_s", "retryable", "label")

    def __init__(
        self,
        tries: int = 4,
        base_delay_s: float = 0.2,
        max_delay_s: float = 10.0,
        deadline_s: float = 120.0,
        retryable: Optional[Callable[[BaseException], bool]] = None,
        label: str = "io",
    ):
        if tries < 1:
            raise ValueError(f"tries must be >= 1, got {tries}")
        self.tries = tries
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.deadline_s = deadline_s
        self.retryable = retryable or default_retryable
        self.label = label

    def _delay(self, attempt: int) -> float:
        raw = min(self.max_delay_s, self.base_delay_s * (2.0 ** attempt))
        return raw * random.uniform(0.5, 1.0)

    def _give_up(self, attempts: int, exc: BaseException, why: str):
        tel = get_telemetry()
        if tel.enabled:
            tel.registry.counter("resilience.gave_up").inc()
            tel.event(
                "resilience.gave_up",
                label=self.label,
                attempts=attempts,
                error=f"{why}: {type(exc).__name__}: {exc}",
            )
        logger.error(
            f"[resilience:{self.label}] gave up after {attempts} attempts ({why}): {exc}"
        )

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy."""
        t0 = time.monotonic()
        tel = get_telemetry()
        for attempt in range(self.tries):
            try:
                return fn(*args, **kwargs)
            except BaseException as exc:  # noqa: BLE001 — filtered below
                if not self.retryable(exc):
                    from ..telemetry.memledger import get_memory_ledger, looks_like_oom

                    if _is_oom(exc) or looks_like_oom(exc):
                        # An OOM is never retried, so this raise is the
                        # resilience path's terminal OOM: snapshot the
                        # ranked ledger before it propagates.
                        get_memory_ledger().note_oom(
                            source=f"resilience.{self.label}", error=exc
                        )
                    raise  # programming error / corrupt state: fail fast
                if attempt == self.tries - 1:
                    self._give_up(attempt + 1, exc, "tries exhausted")
                    raise
                wait = self._delay(attempt)
                if time.monotonic() - t0 + wait > self.deadline_s:
                    self._give_up(attempt + 1, exc, f"deadline {self.deadline_s}s")
                    raise
                if tel.enabled:
                    tel.registry.counter("resilience.retries").inc()
                    tel.event(
                        "resilience.retry",
                        label=self.label,
                        attempt=attempt + 1,
                        wait_s=round(wait, 3),
                        error=f"{type(exc).__name__}: {exc}",
                    )
                logger.warning(
                    f"[resilience:{self.label}] attempt {attempt + 1}/{self.tries} failed "
                    f"({type(exc).__name__}: {exc}); retrying in {wait:.2f}s"
                )
                time.sleep(wait)
        raise AssertionError("unreachable")  # pragma: no cover

    def __call__(self, fn: Callable) -> Callable:
        """Decorator form: ``@policy`` keeps the wrapped signature."""

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        wrapped.retry_policy = self
        return wrapped


def retrying(
    fn: Optional[Callable] = None,
    *,
    tries: int = 4,
    base_delay_s: float = 0.2,
    max_delay_s: float = 10.0,
    deadline_s: float = 120.0,
    retryable: Optional[Callable[[BaseException], bool]] = None,
    label: str = "io",
):
    """Decorator/factory: ``@retrying`` bare, ``@retrying(tries=6)``, or
    ``retrying(label="save").call(fn, ...)`` for one-off calls."""
    policy = RetryPolicy(
        tries=tries,
        base_delay_s=base_delay_s,
        max_delay_s=max_delay_s,
        deadline_s=deadline_s,
        retryable=retryable,
        label=label,
    )
    if fn is not None:
        return policy(fn)
    return policy
