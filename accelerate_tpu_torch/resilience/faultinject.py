"""Env-driven fault injection for resilience testing.

The port of the JAX package's ``resilience/faultinject.py``: the same
variables, the same firing rules, so a script that breaks a JAX run breaks
a port run the same way.  Each mode is armed by an environment variable, so
a *subprocess* under test can be broken without code changes (the smokes in
this package and ``chip_smoke.py`` Phase 15 drive these):

- ``ACCELERATE_TPU_FAULT_WRITE_N=<n>`` — the Nth checkpoint write (1-based,
  counted process-wide across the manifest path) raises
  :class:`InjectedWriteError` (an ``OSError``, so it looks transient to the
  retry policy).  With ``ACCELERATE_TPU_FAULT_WRITE_STICKY=1`` every write
  from the Nth on fails — a dead filesystem rather than a transient blip —
  which exhausts ``retrying()`` and leaves a torn (manifest-less) save.
- ``ACCELERATE_TPU_FAULT_SIGTERM_STEP=<k>`` — :func:`tick` delivers a real
  SIGTERM to this process the first time it sees ``step >= k`` (the actual
  signal path through ``PreemptionGuard``).
- ``ACCELERATE_TPU_FAULT_OOM_ONCE=1`` — :func:`maybe_oom` raises one
  ``torch.OutOfMemoryError``, then goes quiet (drives
  ``find_executable_batch_size``'s halving path, which takes the error by
  type; the JAX package raises a ``RESOURCE_EXHAUSTED`` RuntimeError).
- ``ACCELERATE_TPU_FAULT_NAN_STEP=<k>`` — poison the gradients of optimizer
  step ``k`` (1-based) with NaN; ``ACCELERATE_TPU_FAULT_NAN_COUNT=<n>``
  extends that to ``n`` consecutive steps (``k .. k+n-1``, default 1).
  Each armed step fires ONCE — after a health-guard rewind the replayed
  steps run clean.  The poison is a device scalar (1 or NaN) multiplied
  into the gradients: no host sync, and the fused step keeps its kernel
  launches.
- ``ACCELERATE_TPU_FAULT_BAD_BATCH=<i>`` — every epoch, the data loader
  laces batch index ``i`` (0-based, user-visible position) with NaN in all
  floating-point tensors.  A property of the *data*: it re-fires on every
  replay — the trigger for the health guard's bad-batch quarantine.
- ``ACCELERATE_TPU_FAULT_SERVING_NAN_REQUEST=<n>`` — poison the ``n``-th
  request (1-based, per engine) accepted by a :class:`ServingEngine`: its
  logits are multiplied by NaN on its first decode forward (a per-slot
  device scale), so the engine's finiteness check must quarantine exactly
  that request while every other slot decodes as before.  Fires once.
- ``ACCELERATE_TPU_FAULT_SERVING_HOST_FULL=1`` — the serving KV host tier
  reports itself full on every demotion attempt, so preemption falls back
  to the free-and-re-prefill path and prefix-cache eviction drops instead of
  demoting.

Zero overhead when unarmed: the env is read once, and every hook is a single
``if`` on a cached None.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Optional

import torch

from ..logging import get_logger

logger = get_logger(__name__)

__all__ = [
    "InjectedWriteError",
    "armed",
    "maybe_fail_write",
    "tick",
    "maybe_oom",
    "synthetic_oom_acquire",
    "reload",
    "nan_armed",
    "grad_poison_scale",
    "bad_batch_index",
    "maybe_poison_batch",
    "serving_nan_ordinal",
    "serving_host_full",
]

ENV_WRITE_N = "ACCELERATE_TPU_FAULT_WRITE_N"
ENV_WRITE_STICKY = "ACCELERATE_TPU_FAULT_WRITE_STICKY"
ENV_SIGTERM_STEP = "ACCELERATE_TPU_FAULT_SIGTERM_STEP"
ENV_OOM_ONCE = "ACCELERATE_TPU_FAULT_OOM_ONCE"
ENV_NAN_STEP = "ACCELERATE_TPU_FAULT_NAN_STEP"
ENV_NAN_COUNT = "ACCELERATE_TPU_FAULT_NAN_COUNT"
ENV_BAD_BATCH = "ACCELERATE_TPU_FAULT_BAD_BATCH"
ENV_SERVING_NAN = "ACCELERATE_TPU_FAULT_SERVING_NAN_REQUEST"
ENV_SERVING_HOST_FULL = "ACCELERATE_TPU_FAULT_SERVING_HOST_FULL"

_ON = ("1", "true", "yes", "on")


class InjectedWriteError(OSError):
    """A fault-injected checkpoint-write failure."""


class _Config:
    __slots__ = (
        "write_n", "write_sticky", "sigterm_step", "oom_once",
        "nan_step", "nan_count", "bad_batch", "serving_nan",
        "serving_host_full",
    )

    def __init__(self):
        def _int(key) -> Optional[int]:
            raw = os.environ.get(key, "").strip()
            return int(raw) if raw else None

        def _flag(key) -> bool:
            return os.environ.get(key, "").strip().lower() in _ON

        self.write_n = _int(ENV_WRITE_N)
        self.write_sticky = _flag(ENV_WRITE_STICKY)
        self.sigterm_step = _int(ENV_SIGTERM_STEP)
        self.oom_once = _flag(ENV_OOM_ONCE)
        self.nan_step = _int(ENV_NAN_STEP)
        self.nan_count = _int(ENV_NAN_COUNT) or 1
        self.bad_batch = _int(ENV_BAD_BATCH)
        self.serving_nan = _int(ENV_SERVING_NAN)
        self.serving_host_full = _flag(ENV_SERVING_HOST_FULL)

    @property
    def any_armed(self) -> bool:
        return (
            self.write_n is not None
            or self.sigterm_step is not None
            or self.oom_once
            or self.nan_step is not None
            or self.bad_batch is not None
            or self.serving_nan is not None
            or self.serving_host_full
        )


_cfg: Optional[_Config] = None
_lock = threading.Lock()
_write_count = 0
_sigterm_fired = False
_oom_fired = False
_nan_fired: set = set()


def _config() -> _Config:
    global _cfg
    if _cfg is None:
        _cfg = _Config()
        if _cfg.any_armed:
            logger.warning(
                "fault injection ARMED: "
                f"write_n={_cfg.write_n} sticky={_cfg.write_sticky} "
                f"sigterm_step={_cfg.sigterm_step} oom_once={_cfg.oom_once} "
                f"nan_step={_cfg.nan_step} nan_count={_cfg.nan_count} "
                f"bad_batch={_cfg.bad_batch} serving_nan={_cfg.serving_nan} "
                f"serving_host_full={_cfg.serving_host_full}"
            )
    return _cfg


def reload() -> None:
    """Re-read the env and reset counters (tests flip env vars in-process)."""
    global _cfg, _write_count, _sigterm_fired, _oom_fired
    with _lock:
        _cfg = None
        _write_count = 0
        _sigterm_fired = False
        _oom_fired = False
        _nan_fired.clear()


def armed() -> bool:
    return _config().any_armed


def maybe_fail_write(path: str) -> None:
    """Called once per file on the checkpoint save path; raises on the
    configured Nth write (and, when sticky, every one after it)."""
    cfg = _config()
    if cfg.write_n is None:
        return
    global _write_count
    with _lock:
        _write_count += 1
        count = _write_count
    if count == cfg.write_n or (cfg.write_sticky and count >= cfg.write_n):
        raise InjectedWriteError(
            f"injected write failure #{count} (threshold {cfg.write_n}, "
            f"sticky={cfg.write_sticky}) at {path!r}"
        )


def tick(step: Optional[int]) -> None:
    """Step-boundary hook (``Accelerator.check_preemption`` calls this):
    delivers SIGTERM to this process once when ``step`` reaches the armed
    threshold."""
    cfg = _config()
    if cfg.sigterm_step is None or step is None:
        return
    global _sigterm_fired
    if _sigterm_fired or step < cfg.sigterm_step:
        return
    _sigterm_fired = True
    logger.warning(f"fault injection: delivering SIGTERM at step {step}")
    os.kill(os.getpid(), signal.SIGTERM)


def maybe_oom() -> None:
    """Raises one ``torch.OutOfMemoryError``, then goes quiet.  Place this
    inside the function under ``find_executable_batch_size`` to exercise the
    OOM-halving path without a real allocator failure."""
    cfg = _config()
    if not cfg.oom_once:
        return
    global _oom_fired
    with _lock:
        if _oom_fired:
            return
        _oom_fired = True
    raise torch.OutOfMemoryError(
        "CUDA out of memory: injected out-of-memory (fault injection "
        f"{ENV_OOM_ONCE}=1; fires once)"
    )


def synthetic_oom_acquire(label: str, tries: int = 2) -> None:
    """Drive a synthetic out-of-memory error through the retry machinery —
    re-armed per attempt, so the policy exhausts its tries and the
    acquisition fight is narrated into telemetry (``resilience.retry`` /
    ``resilience.gave_up`` events, which the goodput ledger attributes to
    ``device_acquire``) before the final error re-raises.  Cleans up its
    own env arming either way."""
    from .retry import RetryPolicy

    def _acquire():
        os.environ[ENV_OOM_ONCE] = "1"
        reload()
        maybe_oom()

    try:
        RetryPolicy(
            tries=max(2, int(tries)), base_delay_s=0.02, max_delay_s=0.05,
            deadline_s=5.0, retryable=lambda e: True, label=label,
        ).call(_acquire)
    finally:
        os.environ.pop(ENV_OOM_ONCE, None)
        reload()


def nan_armed() -> bool:
    """True when NaN-gradient injection is configured (the fused train step
    checks this ONCE, when built, so an unarmed step carries no poison)."""
    return _config().nan_step is not None


def grad_poison_scale(step: int) -> Optional[float]:
    """``float('nan')`` when optimizer step ``step`` (1-based) falls in the
    armed ``[nan_step, nan_step + nan_count)`` window and has not fired yet,
    else None.  Fires once per armed step: post-rewind replays of the same
    step numbers run clean."""
    cfg = _config()
    if cfg.nan_step is None:
        return None
    if not (cfg.nan_step <= step < cfg.nan_step + cfg.nan_count):
        return None
    with _lock:
        if step in _nan_fired:
            return None
        _nan_fired.add(step)
    logger.warning(f"fault injection: poisoning gradients of step {step} with NaN")
    return float("nan")


def serving_nan_ordinal() -> Optional[int]:
    """The armed 1-based submission ordinal for serving NaN poisoning, or
    None.  The serving engine reads this ONCE at construction, so an
    unarmed engine carries no poison at all."""
    return _config().serving_nan


def serving_host_full() -> bool:
    """True when the serving KV host tier is forced to report itself full:
    every demotion attempt fails, exercising the free-and-re-prefill
    fallback and the eviction drop path.  Checked per demotion attempt (a
    host-side branch between forwards)."""
    return _config().serving_host_full


def bad_batch_index() -> Optional[int]:
    """The armed per-epoch batch index for NaN-laced batches, or None."""
    return _config().bad_batch


def _poison(x):
    if isinstance(x, torch.Tensor):
        return x * float("nan") if x.is_floating_point() else x
    if isinstance(x, dict):
        return type(x)((k, _poison(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        out = [_poison(v) for v in x]
        return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
    dtype = getattr(x, "dtype", None)  # numpy arrays and scalars
    if dtype is not None and ("float" in str(dtype) or "bfloat" in str(dtype)):
        return x * float("nan")
    return x


def maybe_poison_batch(batch, index: int):
    """Return ``batch`` with every floating-point tensor multiplied by NaN
    when ``index`` is the armed bad-batch position (fires every epoch — a bad
    batch stays bad on replay, unlike the fire-once step poison)."""
    cfg = _config()
    if cfg.bad_batch is None or index != cfg.bad_batch:
        return batch
    logger.warning(f"fault injection: NaN-lacing batch index {index}")
    return _poison(batch)
