"""Resilience: the JAX package's ``resilience`` package.

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
  bit-exact loss continuation;
- **elastic topology resume** (:mod:`.elastic`) — every verified manifest
  records the save's topology (mesh axes and degrees, world size, each
  leaf's full shape and spec for the parameters and the optimizer state,
  the RNG streams, the global batch); ``resume_from_latest`` validates it
  leaf by leaf and lands the checkpoint on another mesh or world size (dp
  -> dp x fsdp, ZeRO on and off, more or fewer ranks) with the state
  bit-identical, a stream folded for each new rank and
  ``skip_first_batches`` recomputed for a new global batch; a pipeline
  stage-count change is refused;
- **chaos campaign** (:mod:`.chaos`) — a seeded schedule of faults across
  kill -> resume lives that change the mesh between lives, each life a
  world of ranks; the elastic smoke (:mod:`.elastic_smoke`) resumes one
  checkpoint on several meshes;
- **fleet primitives** (:mod:`.fleet`) — deadline-bound ``barrier`` /
  ``agree`` over the process group's store (a dead member raises a loud
  ``FleetError`` instead of hanging the survivors), the step-loop file
  heartbeat the ``FleetSupervisor`` (``launchers.py``) watches for wedges,
  and the coordinator connect-retry policy; exercised by the fleet chaos
  campaign (:mod:`.fleet_chaos`, ``chaos --mode fleet``), whose ranks the
  supervisor reaps, postmortems and relaunches smaller.
"""

from .elastic import (
    ElasticPlan,
    ElasticResumeInfo,
    ElasticTopologyError,
    capture_topology,
    fold_rng_bundle,
    plan_resume,
    recompute_skip_batches,
    reshard_tree,
    state_digest,
    validate_leaves,
)
from .fleet import FleetError, Heartbeat, agree, barrier, fleet_client
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

# The JAX package's order.
__all__ = [
    "ElasticPlan",
    "ElasticResumeInfo",
    "ElasticTopologyError",
    "capture_topology",
    "plan_resume",
    "validate_leaves",
    "reshard_tree",
    "fold_rng_bundle",
    "recompute_skip_batches",
    "state_digest",
    "HealthGuard",
    "HealthVerdict",
    "NumericalDivergenceError",
    "MANIFEST_NAME",
    "ENV_MANIFEST_HASH",
    "CheckpointVerificationError",
    "write_manifest",
    "read_manifest",
    "verify_checkpoint",
    "is_complete",
    "list_checkpoints",
    "find_latest_complete",
    "prune_checkpoints",
    "RetryPolicy",
    "retrying",
    "PreemptionGuard",
    "FleetError",
    "Heartbeat",
    "barrier",
    "agree",
    "fleet_client",
]
