"""Canonical registry of every telemetry name the codebase emits.

The JAX package's registry, copied name for name: the port emits the same
names, so dashboards, the Prometheus exporter and the report read either
package's runs.  The health family (``health.*``), the resilience retry
names and ``smoke.retried`` are emitted by the one-process resilience
(``resilience/``); the fleet, elastic and training-chaos families
(``fleet.*``, ``elastic.*``, ``chaos.*``) wait for several GPUs (ROADMAP
A6), and the serving chaos campaign emits the ``serving.*`` names.  ``tests/test_torch_telemetry.py`` holds the
port's emit sites against this registry.  Dynamic (f-string) names must match
a pattern in :data:`DYNAMIC_PATTERNS`.
"""

from __future__ import annotations

import re

__all__ = [
    "COUNTERS",
    "GAUGES",
    "HISTOGRAMS",
    "EVENTS",
    "DYNAMIC_PATTERNS",
    "all_names",
    "matches_dynamic",
]

COUNTERS = frozenset({
    "chaos.cycles",
    "dataloader.batches",
    "elastic.reshards",
    "fleet.deadline_errors",
    "fleet.elastic_restarts",
    "fleet.wedged_workers",
    "fleet.worker_deaths",
    "health.nonfinite_grads",
    "health.quarantine_skips",
    "health.quarantined_batches",
    "health.rewinds",
    "health.skipped_steps",
    "jit.cache_hits",
    "jit.compiles",
    "memory.oom_halvings",
    "memory.oom_postmortems",
    "pipeline.dispatches",
    "resilience.gave_up",
    "resilience.preempt_checkpoints",
    "resilience.preempt_signals",
    "resilience.retries",
    "sentinel.anomalies",
    "serving.completed",
    "serving.deadline_expired",
    "serving.decode_dispatches",
    "serving.decode_gather_bytes",
    "serving.drains",
    "serving.journal_recoveries",
    "serving.preempted",
    "serving.prefill_dispatches",
    "serving.prefix_blocks_reused",
    "serving.prefix_cow_copies",
    "serving.prefix_hits",
    "serving.quarantined",
    "serving.requests",
    "serving.shed",
    "serving.spec.accepted",
    "serving.spec.proposed",
    "serving.spec.rounds",
    "serving.tier.demoted_blocks",
    "serving.tier.demotions",
    "serving.tier.fallback_reprefills",
    "serving.tier.promotions",
    "serving.tokens",
    "stall.count",
    "step.count",
})

GAUGES = frozenset({
    "goodput.attributed_s",
    "goodput.elapsed_s",
    "goodput.fleet_fraction",
    "goodput.fleet_hosts",
    "goodput.fraction",
    "goodput.straggler_count",
    # per-category ledger gauges (goodput.{category}_s)
    "goodput.compile_s",
    "goodput.checkpoint_s",
    "goodput.device_acquire_s",
    "goodput.input_wait_s",
    "goodput.rewind_replay_s",
    "goodput.productive_s",
    "goodput.preempt_s",
    "goodput.idle_s",
    "hbm.bytes_in_use",
    "hbm.fleet_min_headroom_bytes",
    "hbm.peak_bytes",
    "hbm.stats_available",
    "health.last_grad_norm",
    "memory.attributed_bytes",
    "memory.headroom_bytes",
    "memory.unattributed_bytes",
    "pipeline.dispatches_per_step",
    "profile.collective_ms",
    "profile.device_busy_ms",
    "profile.exposed_collective_ms",
    "profile.overlap_fraction",
    "serving.active_slots",
    "serving.block_occupancy",
    "serving.blocks_used",
    "serving.decode_bucket_width",
    "serving.headroom_bytes",
    "serving.prefix_cache_blocks",
    "serving.queue_depth",
    "serving.slo.ttft_target_ms",
    "serving.slo.ttft_burn_rate",
    "serving.slo.inter_token_target_ms",
    "serving.slo.inter_token_burn_rate",
    "serving.spec.acceptance_rate",
    "serving.tier.host_bytes",
    "serving.tier.host_occupancy",
    "serving.tokens_per_dispatch",
    "step.mfu",
    "step.tokens_per_sec",
})

HISTOGRAMS = frozenset({
    "jit.compile_ms",
    "pipeline.host_blocked_ms",
    "serving.inter_token_ms",
    "serving.queue_wait_ms",
    "serving.requeue_wait_ms",
    "serving.tokens_per_s",
    "serving.ttft_ms",
    "step.time_ms",
})

EVENTS = frozenset({
    "chaos.cycle",
    "checkpoint.publish",
    "elastic.reshard",
    "fleet.deadline_error",
    "fleet.drain",
    "fleet.postmortem",
    "fleet.relaunch",
    "fleet.teardown",
    "fleet.wedged",
    "fleet.worker_dead",
    "health.rewind",
    "health.skip",
    "memory.low_headroom",
    "memory.oom_halving",
    "memory.oom_postmortem",
    "resilience.gave_up",
    "resilience.preempt_checkpoint",
    "resilience.preempt_signal",
    "resilience.retry",
    "sentinel.anomaly",
    "sentinel.profile_analysis_failed",
    "sentinel.profile_captured",
    "sentinel.profile_digest",
    "sentinel.profile_failed",
    "sentinel.profile_start",
    "sentinel.straggler",
    "serving.bucket_compile",
    "serving.drained",
    "serving.journal_recovered",
    "serving.quarantined",
    "serving.request_complete",
    "smoke.retried",
})

# Templates for f-string emit sites: the lint rewrites ``{expr}`` holes to a
# wildcard and requires the result to match one of these.
DYNAMIC_PATTERNS = (
    re.compile(r"^span\..+_ms$"),                 # span.{name}_ms histograms
    re.compile(r"^introspect\..+\.(flops|comms_bytes)$"),
    re.compile(r"^goodput\..+_s$"),               # goodput.{category}_s gauges
    # memory.owner.{slug}_bytes — per-owner HBM-ledger gauges (memledger.py)
    re.compile(r"^memory\.owner\..+_bytes$"),
    re.compile(r"^serving\.slo\..+_(target_ms|burn_rate)$"),
    # serving.trace.blame.{phase} counters + serving.trace.unattributed_ms
    # (the per-request trace family — see docs/package_reference/serving_tracing.md)
    re.compile(r"^serving\.trace\..+$"),
)


def all_names() -> frozenset:
    return COUNTERS | GAUGES | HISTOGRAMS | EVENTS


def matches_dynamic(name: str) -> bool:
    """True when ``name`` (an f-string template with ``{...}`` holes replaced
    by a placeholder, or a concrete runtime name) fits a dynamic pattern."""
    probe = re.sub(r"\{[^{}]*\}", "X", name)
    return any(p.match(probe) for p in DYNAMIC_PATTERNS)
