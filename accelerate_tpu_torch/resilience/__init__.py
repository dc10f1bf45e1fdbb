"""Resilience: checkpoint integrity (:mod:`.manifest`) and preemption-safe
stepping for one process (:class:`PreemptionGuard`)."""

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

__all__ = [
    "CheckpointVerificationError",
    "ENV_MANIFEST_HASH",
    "MANIFEST_NAME",
    "PreemptionGuard",
    "find_latest_complete",
    "is_complete",
    "list_checkpoints",
    "prune_checkpoints",
    "read_manifest",
    "verify_checkpoint",
    "write_manifest",
]
