"""Resilience for one process: the JAX package's ``resilience`` package
without its multi-GPU parts.

- **atomic verified checkpoints** (:mod:`.manifest`) — ``save_state`` stages
  into ``<dir>.tmp``, writes ``manifest.json`` (per-file size + SHA-256,
  step, world size, library version) LAST, fsyncs, then atomically renames,
  so ``verify_checkpoint`` / ``find_latest_complete`` tell torn partials
  from real checkpoints;
- **retry/timeout/backoff** (:mod:`.retry`) — ``retrying()`` wraps the
  checkpoint publish so transient filesystem errors back off (exponential +
  jitter, deadline) instead of killing a run; counted as
  ``resilience.retries`` / ``resilience.gave_up``;
- **preemption-safe stepping** (:mod:`.preemption`) — ``PreemptionGuard``
  turns SIGTERM/SIGINT into one final verified checkpoint at the next step
  boundary (``Accelerator.check_preemption``);
- **numerical-health guard** (:mod:`.health`) — the optimizer update gates a
  non-finite step to a zero delta on the device; ``HealthGuard``
  (``Accelerator.enable_health_guard`` / ``check_health``) skips, rewinds to
  a checkpoint, and quarantines batches that keep breaking;
- **fault injection** (:mod:`.faultinject`) — env-driven failure modes (fail
  the Nth checkpoint write, SIGTERM at step K, one synthetic OOM,
  NaN-poisoned gradients, a NaN-laced batch, a poisoned serving request, a
  full host KV tier) that the smokes (:mod:`.smoke`, :mod:`.health_smoke`,
  ``serving/chaos.py``) use to prove kill-and-resume and skip/rewind give
  bit-exact loss continuation.

The JAX package's elastic topology resume and training chaos campaign
(ROADMAP A6 part 3) and its fleet primitives (A6 part 4) are not ported
yet; the coordinated ``PreemptionGuard`` is.
"""

from .health import HealthGuard, HealthVerdict, NumericalDivergenceError
from .manifest import (
    ENV_MANIFEST_HASH,
    MANIFEST_NAME,
    CheckpointVerificationError,
    find_latest_complete,
    is_complete,
    list_checkpoints,
    prune_checkpoints,
    read_manifest,
    verify_checkpoint,
    write_manifest,
)
from .preemption import PreemptionGuard
from .retry import RetryPolicy, retrying

__all__ = [
    "CheckpointVerificationError",
    "ENV_MANIFEST_HASH",
    "HealthGuard",
    "HealthVerdict",
    "MANIFEST_NAME",
    "NumericalDivergenceError",
    "PreemptionGuard",
    "RetryPolicy",
    "find_latest_complete",
    "is_complete",
    "list_checkpoints",
    "prune_checkpoints",
    "read_manifest",
    "retrying",
    "verify_checkpoint",
    "write_manifest",
]
