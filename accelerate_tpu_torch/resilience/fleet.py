"""Worker-side fleet primitives: deadline-bound coordination and heartbeats.

The JAX package's ``resilience/fleet.py`` in the port.  A collective
entered by a world with one dead (or wedged) member never returns: gloo
and NCCL wait for the missing rank for the group's timeout (30 minutes by
default), so the default failure of a run of several processes is a long
silent hang on every survivor.  This module is the worker-side half of the
hardened runtime (the parent-side half is
:class:`accelerate_tpu_torch.launchers.FleetSupervisor`):

- :func:`barrier` / :func:`agree` — a rendezvous and an agreement-gather
  over the c10d ``Store`` the process group was formed over, with a hard
  deadline.  A member that never shows up (or whose store went away with
  it, as rank 0's ``TCPStore`` does) turns the hang into a loud
  :class:`FleetError`, so the caller can exit cleanly and the supervisor
  can reap the rest.
- :class:`Heartbeat` / :func:`maybe_beat` — a file heartbeat each worker
  beats from its *step loop* (never from a helper thread: a thread keeps
  beating while the main thread is stuck in a dead collective, which is
  exactly the wedge the heartbeat exists to expose).  The supervisor
  watches the files' mtimes and kills a fleet whose member went quiet.
- :func:`connect_retry_policy` — the backoff ``PartialState`` rides when it
  dials the coordinator, closing the launcher's bind-to-spawn port race.

The store is the one ``PartialState`` builds (a ``TCPStore`` at the
coordinator address, hosted by rank 0) or ``parallel.launch.join_group``
builds (a ``FileStore`` for its ``file://`` rendezvous); both keep it here.  A group someone else started lends its
default store.  Fleet keys live under a prefix of their own, apart from
c10d's.  ``PreemptionGuard.should_stop`` routes its agreement through
:func:`agree` whenever :func:`fleet_client` is not None, which is what
makes a coordinated SIGTERM drain converge even while part of the fleet is
dying.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from datetime import timedelta
from typing import Any, List, Optional

from ..telemetry import get_telemetry

logger = logging.getLogger(__name__)

__all__ = [
    "FleetError",
    "fleet_client",
    "barrier",
    "agree",
    "Heartbeat",
    "heartbeat_path",
    "read_heartbeat",
    "maybe_beat",
    "connect_retry_policy",
]

# Supervisor -> worker contract: when set, workers beat a per-rank file in
# this directory from their step loop (see maybe_beat /
# Accelerator.check_preemption).
ENV_HEARTBEAT_DIR = "ACCELERATE_TPU_HEARTBEAT_DIR"

# The prefix of every fleet key in the group's store.
STORE_PREFIX = "accelerate_fleet"


class FleetError(RuntimeError):
    """A fleet-coordination primitive hit its deadline (a member is dead,
    wedged, or unreachable).  The right response is a clean, loud exit —
    the supervisor turns the exit into a bounded fleet teardown and a
    postmortem."""


# The store the live default group was formed over, as (group, store): kept
# by whoever formed the group, and valid while that group is the default.
_kept: list = [None, None]


def _keep_store(store) -> None:
    """Record ``store`` as the one the default process group (just formed)
    was built over."""
    import torch.distributed as dist

    _kept[:] = [dist.group.WORLD, store]


def _group_up() -> bool:
    dist = sys.modules.get("torch.distributed")
    return dist is not None and dist.is_available() and dist.is_initialized()


def fleet_client():
    """The live process group's store under the fleet's key prefix, or
    None outside a run of several processes.  It never starts a group
    (nor imports ``torch.distributed``)."""
    if not _group_up():
        return None
    import torch.distributed as dist

    if dist.get_world_size() <= 1:
        return None
    group, store = _kept
    if store is None or group is not dist.group.WORLD:
        try:  # a group the caller formed itself: its default store
            store = dist.distributed_c10d._get_default_store()
        except (AttributeError, RuntimeError, ValueError):
            return None
    return dist.PrefixStore(STORE_PREFIX, store)


def _world() -> tuple:
    import torch.distributed as dist

    return dist.get_world_size(), dist.get_rank()


def _note_deadline(primitive: str, name: str, timeout_s: float, exc: BaseException):
    tel = get_telemetry()
    if tel.enabled:
        tel.registry.counter("fleet.deadline_errors").inc()
        tel.event(
            "fleet.deadline_error",
            primitive=primitive,
            name=name,
            timeout_s=timeout_s,
            error=f"{type(exc).__name__}: {exc}",
        )
    logger.error(f"fleet {primitive} {name!r} missed its {timeout_s}s deadline: {exc}")


# Each (primitive, name) pair needs a fresh key per call: a key once set is
# never cleared.  Call-count suffixes stay in lockstep across ranks for the
# same reason PreemptionGuard's agreement is call-count gated: every rank
# must reach the same call site the same number of times anyway.
_seq: dict = {}


def _next_key(primitive: str, name: str) -> str:
    n = _seq.get((primitive, name), 0)
    _seq[(primitive, name)] = n + 1
    return f"fleet/{primitive}/{name}/{n}"


def _remaining(deadline: float) -> timedelta:
    return timedelta(seconds=max(0.001, deadline - time.monotonic()))


def barrier(name: str, timeout_s: float = 60.0) -> None:
    """Deadline-bound fleet rendezvous: every rank sets its own key, then
    waits for every rank's.  Raises :class:`FleetError` when any member
    fails to arrive within ``timeout_s`` (instead of hanging forever in a
    device collective).  A no-op on one process."""
    client = fleet_client()
    if client is None:
        return
    num, rank = _world()
    key = _next_key("barrier", name)
    deadline = time.monotonic() + timeout_s
    try:
        client.set(f"{key}/{rank}", "1")
        client.wait([f"{key}/{peer}" for peer in range(num)], _remaining(deadline))
    except Exception as exc:
        _note_deadline("barrier", name, timeout_s, exc)
        raise FleetError(
            f"fleet barrier {name!r} did not complete within {timeout_s}s — "
            f"a fleet member is dead or wedged ({type(exc).__name__}: {exc})"
        ) from exc


def agree(name: str, value: Any, timeout_s: float = 60.0) -> List[Any]:
    """Agreement-gather with a deadline: every rank contributes a
    JSON-serializable ``value``; returns the rank-ordered list of all
    values.  Runs over the group's store — no device collective, so it
    stays answerable (with :class:`FleetError`) while part of the fleet is
    dying, which is exactly when agreement matters (coordinated drain)."""
    client = fleet_client()
    if client is None:
        return [value]
    num, rank = _world()
    key = _next_key("agree", name)
    deadline = time.monotonic() + timeout_s
    try:
        client.set(f"{key}/{rank}", json.dumps(value))
        out: List[Any] = []
        for peer in range(num):
            # A bare get blocks for the store's own timeout (300 s for a
            # TCPStore): wait first, under what is left of the deadline.
            client.wait([f"{key}/{peer}"], _remaining(deadline))
            out.append(json.loads(client.get(f"{key}/{peer}")))
        return out
    except Exception as exc:
        _note_deadline("agree", name, timeout_s, exc)
        raise FleetError(
            f"fleet agreement {name!r} did not complete within {timeout_s}s — "
            f"a fleet member is dead or wedged ({type(exc).__name__}: {exc})"
        ) from exc


# ---------------------------------------------------------------------------
# Heartbeats (worker side; the supervisor reads the files)
# ---------------------------------------------------------------------------


def heartbeat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"heartbeat_p{rank}.json")


def read_heartbeat(path: str) -> Optional[dict]:
    """The last beat's payload, or None when absent or torn."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class Heartbeat:
    """File heartbeat: ``beat()`` atomically rewrites the file, so its mtime
    is the liveness signal and its payload carries the last step.  MUST be
    driven from the step loop on the main thread — a background thread
    keeps beating while the main thread is stuck in a dead collective."""

    def __init__(self, path: str):
        self.path = path
        self.beats = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: Optional[int] = None) -> None:
        payload = {"t": time.time(), "pid": os.getpid(), "step": step, "beats": self.beats}
        tmp = f"{self.path}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
            self.beats += 1
        except OSError:
            # A failed beat must never kill the step loop; a persistently
            # failing one reads as a stall, which is the honest signal.
            logger.warning(f"heartbeat write failed: {self.path}", exc_info=True)


_heartbeat: Optional[Heartbeat] = None


def _rank() -> int:
    if _group_up():
        import torch.distributed as dist

        return dist.get_rank()
    return int(os.environ.get("ACCELERATE_PROCESS_ID", 0))


def maybe_beat(step: Optional[int] = None) -> bool:
    """Beat the supervisor's heartbeat file iff ``$ACCELERATE_TPU_HEARTBEAT_DIR``
    is set (the FleetSupervisor sets it for every worker it spawns).  Wired
    into ``Accelerator.check_preemption`` so any preemption-aware step loop
    is wedge-detectable; costs one env lookup when disabled.  The rank is
    the group's, else ``ACCELERATE_PROCESS_ID``."""
    global _heartbeat
    directory = os.environ.get(ENV_HEARTBEAT_DIR)
    if not directory:
        return False
    if _heartbeat is None or os.path.dirname(_heartbeat.path) != directory:
        _heartbeat = Heartbeat(heartbeat_path(directory, _rank()))
    _heartbeat.beat(step)
    return True


def _reset_heartbeat_singleton() -> None:
    """Drop the cached per-process heartbeat (tests re-point the env dir)."""
    global _heartbeat
    _heartbeat = None


# ---------------------------------------------------------------------------
# Coordinator connect backoff (closes the launcher's bind-to-spawn port race)
# ---------------------------------------------------------------------------


def _connect_retryable(exc: BaseException) -> bool:
    # Bring-up failures arrive as RuntimeError / DistNetworkError; argument
    # errors (TypeError / ValueError) fail fast.
    return not isinstance(exc, (TypeError, ValueError))


def connect_retry_policy():
    """Backoff policy for the process group's rendezvous: the launcher
    probes a free port before spawning, so the coordinator can lose the
    port (or come up a beat late) — workers redial instead of dying on the
    first refusal.  Knobs: ``ACCELERATE_TPU_COORDINATOR_CONNECT_TRIES``
    (default 3) and ``ACCELERATE_TPU_COORDINATOR_CONNECT_DEADLINE_S``
    (default 600)."""
    from .retry import RetryPolicy

    return RetryPolicy(
        tries=max(1, int(os.environ.get("ACCELERATE_TPU_COORDINATOR_CONNECT_TRIES", "3"))),
        base_delay_s=0.25,
        max_delay_s=2.0,
        deadline_s=float(os.environ.get("ACCELERATE_TPU_COORDINATOR_CONNECT_DEADLINE_S", "600")),
        retryable=_connect_retryable,
        label="coordinator_connect",
    )
