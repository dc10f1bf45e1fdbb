"""Unified device-memory ledger: per-subsystem memory attribution + OOM forensics.

Who owns device memory?  Two raw gauges (``collect_hbm``) show *that* the
card filled up, not *why*.  The :class:`MemoryLedger` is the goodput-ledger
discipline applied to bytes instead of seconds: long-lived owners (model
parameters, optimizer state, the paged KV pool, prefix-cache residents, the
host tier, prefetch staging) **register** reservations computed from their
live tensors' storage bytes, and every reconcile checks the result against
the CUDA caching allocator on ALL visible devices under a conservation
contract:

    attributed + program_estimate + unattributed == bytes_in_use   (per device)

``bytes_in_use`` is ``torch.cuda.memory_allocated(d)``.  The residual
(``unattributed``) is exposed, never silently absorbed — a growing residual
is the "whose allocation is this?" alarm.  ``program_estimate`` is the JAX
package's term for the temp/scratch and code bytes of compiled XLA programs;
the port has no compiled programs, so it is 0 unless a caller notes bytes
through :meth:`MemoryLedger.note_program_bytes`, and the allocator's
temporaries (activations, gradients, workspaces) land in the unattributed
residual.

Registration stores **integers, never tensor references**: computing bytes
at register time keeps the ledger from extending any tensor's lifetime.
Each storage is charged once to the device it lives on (views of one
storage count once); a tensor off the card — pinned, or any CPU tensor
where a card is present — counts under ``host_bytes``.  On a CPU-only run
the CPU is the port's device 0, as the JAX package's CPU backend is.

On top of the ledger:

- **OOM forensics** — :meth:`MemoryLedger.note_oom` snapshots the ranked
  ledger into a ``memory.oom_postmortem`` event (mirrored into the flight
  recorder when armed) naming the *blamed owner*: the largest per-device
  reservation at the moment of death.  Wired into the
  ``torch.cuda.OutOfMemoryError`` sites: ``find_executable_batch_size``
  halvings and serving admission (``scheduler.grow_to`` with nothing left
  to evict).
- **Gauges** — ``memory.attributed_bytes`` / ``memory.unattributed_bytes``
  (worst device), ``memory.headroom_bytes`` (fleet min of
  ``bytes_limit - bytes_in_use``; absent where no device reports stats),
  and per-owner ``memory.owner.{name}_bytes``.
- **Serving headroom** — the engine registers its pool + prefix cache and
  publishes ``serving.headroom_bytes`` (see ``serving/engine.py``).

CPU runs: no device reports stats, so per-device records carry
``stats_available: 0`` and no conservation arithmetic is invented.
``reconcile(stats_fn=...)`` takes an injectable per-device stats provider
so tests can assert the contract without a card.

Process-wide singleton via :func:`get_memory_ledger`; the full JSON view
(:meth:`snapshot`) backs the ``/debug/memory`` endpoint and the report's
memory block.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = [
    "MemoryLedger",
    "Reservation",
    "get_memory_ledger",
    "tree_device_bytes",
    "looks_like_oom",
]

# Substrings that mark an exception as an out-of-memory failure (the
# utils/memory.py should_reduce_batch_size list, duplicated here because
# utils imports telemetry — the reverse import would cycle).
_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "Out of memory",
    "out of memory",
    "OOM",
    "Attempting to allocate",
    "CUDA out of memory",
)


def looks_like_oom(exc: BaseException) -> bool:
    """Whether ``exc`` smells like a device OOM (RESOURCE_EXHAUSTED et al.)."""
    text = str(exc)
    return any(marker in text for marker in _OOM_MARKERS)


def _owner_slug(owner: str) -> str:
    """Owner name → gauge-safe slug (``memory.owner.{slug}_bytes``)."""
    return re.sub(r"[^0-9A-Za-z_]+", "_", owner).strip("_") or "owner"


def _tensors(tree):
    """Every tensor in a nested dict / list / tuple, an ``nn.Module``'s
    parameters and buffers, or an optimizer's ``state`` (a dict keyed by
    parameter); other leaves are skipped."""
    import torch

    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            yield node
        elif isinstance(node, torch.nn.Module):
            stack.extend(reversed(list(node.parameters())))
            stack.extend(reversed(list(node.buffers())))
        elif isinstance(node, torch.optim.Optimizer):
            stack.append(list(node.state.values()))
        elif isinstance(node, dict):
            stack.extend(reversed(list(node.values())))
        elif isinstance(node, (list, tuple)):
            stack.extend(reversed(list(node)))


def tree_device_bytes(tree) -> tuple[Dict[int, int], int, int]:
    """Per-device byte footprint of the tensors in ``tree`` (see
    :func:`_tensors` for what is walked).

    Returns ``(per_device, host_bytes, n_leaves)``: ``per_device`` maps a
    CUDA device index to the bytes of the storages on it, each storage
    charged once (``untyped_storage().nbytes()``: a view of a storage
    already counted adds nothing); ``host_bytes`` collects storages off the
    card — pinned CPU tensors, and every CPU tensor when a card is present.
    On a CPU-only run a CPU tensor counts under device 0.  Only integers
    escape — no reference to ``tree``'s tensors survives the call.
    """
    import torch

    cpu_is_device = not torch.cuda.is_available()
    per_device: Dict[int, int] = {}
    host_bytes = 0
    n_leaves = 0
    seen: set = set()
    for t in _tensors(tree):
        n_leaves += 1
        storage = t.untyped_storage()
        key = (t.device.type, t.device.index, storage.data_ptr())
        if key in seen:
            continue
        seen.add(key)
        nbytes = int(storage.nbytes())
        if t.device.type == "cuda":
            dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
            per_device[dev] = per_device.get(dev, 0) + nbytes
        elif t.device.type == "cpu" and cpu_is_device and not t.is_pinned():
            per_device[0] = per_device.get(0, 0) + nbytes
        else:
            host_bytes += nbytes
    return per_device, host_bytes, n_leaves


class Reservation:
    """One owner's registered footprint — plain integers only."""

    __slots__ = ("owner", "per_device", "host_bytes", "n_leaves", "subset_of", "detail", "token", "t")

    def __init__(
        self,
        owner: str,
        per_device: Dict[int, int],
        host_bytes: int = 0,
        n_leaves: int = 0,
        subset_of: Optional[str] = None,
        detail: Optional[dict] = None,
        token: int = 0,
    ):
        self.owner = owner
        self.per_device = dict(per_device)
        self.host_bytes = int(host_bytes)
        self.n_leaves = int(n_leaves)
        # ``subset_of``: these bytes live INSIDE another owner's reservation
        # (prefix-cache residents inside the KV pool).  Ranked views show
        # them; conservation sums skip them — double counting would poison
        # the residual.
        self.subset_of = subset_of
        self.detail = dict(detail or {})
        self.token = token
        self.t = time.time()

    @property
    def device_bytes(self) -> int:
        """Worst single device — the per-chip footprint (the binding
        constraint under symmetric SPMD; replicated trees report their
        full size, sharded ones their shard)."""
        return max(self.per_device.values(), default=0)

    @property
    def total_device_bytes(self) -> int:
        return sum(self.per_device.values())

    def to_dict(self) -> dict:
        out = {
            "owner": self.owner,
            "bytes_per_device": {str(k): v for k, v in sorted(self.per_device.items())},
            "device_bytes": self.device_bytes,
            "host_bytes": self.host_bytes,
            "n_leaves": self.n_leaves,
        }
        if self.subset_of:
            out["subset_of"] = self.subset_of
        if self.detail:
            out["detail"] = self.detail
        return out


def _default_stats_fn(device) -> Optional[dict]:
    from .metrics import device_memory_stats

    return device_memory_stats(device)


def _devices() -> list:
    """``(index, platform)`` of every device the ledger reconciles: the
    visible CUDA devices, or the CPU as device 0 on a CPU-only run."""
    from .metrics import local_devices

    cuda = local_devices()
    return [(d, "cuda") for d in cuda] if cuda else [(0, "cpu")]


class MemoryLedger:
    """Process-wide registry of long-lived HBM reservations, reconciled
    against live per-device memory stats under the conservation contract."""

    def __init__(self):
        self._lock = threading.Lock()
        self._owners: Dict[str, Reservation] = {}
        self._program_bytes: Dict[str, int] = {}
        self._tokens = 0
        # Last reconcile's per-device records (the watermark note_oom snapshots
        # even when reconcile cannot run at the crash site).
        self._last_devices: List[dict] = []
        self.oom_postmortems: List[dict] = []

    # -- registration --------------------------------------------------------

    def register(
        self,
        owner: str,
        tree=None,
        *,
        nbytes: Optional[int] = None,
        per_device: Optional[Dict[int, int]] = None,
        host_bytes: int = 0,
        subset_of: Optional[str] = None,
        detail: Optional[dict] = None,
    ) -> int:
        """Register (or replace) owner ``owner``'s reservation.

        Exactly one of ``tree`` (live pytree — bytes computed per device from
        its actual shardings), ``per_device`` (explicit mapping), or
        ``nbytes`` (flat bytes charged to every local device — the right
        shape for a replicated pool allocated outside a pytree) must be
        given.  Returns an ownership token for :meth:`unregister`.
        """
        n_leaves = 0
        if tree is not None:
            per_device, tree_host, n_leaves = tree_device_bytes(tree)
            host_bytes = host_bytes + tree_host
        elif per_device is not None:
            per_device = {int(k): int(v) for k, v in per_device.items()}
        elif nbytes is not None:
            per_device = {d: int(nbytes) for d, _ in _devices()}
        else:
            raise ValueError("register() needs one of tree=, per_device=, nbytes=")
        with self._lock:
            self._tokens += 1
            token = self._tokens
            self._owners[owner] = Reservation(
                owner, per_device, host_bytes, n_leaves, subset_of, detail, token
            )
        return token

    def update_bytes(self, owner: str, nbytes: int, token: Optional[int] = None) -> bool:
        """Refresh an existing reservation's bytes in place (token-guarded,
        registration identity kept) — the cheap per-tick path for owners
        whose footprint moves, like prefix-cache residents.  Every device the
        reservation was registered on takes the new per-device value."""
        with self._lock:
            res = self._owners.get(owner)
            if res is None or (token is not None and res.token != token):
                return False
            res.per_device = {k: int(nbytes) for k in (res.per_device or {0: 0})}
            return True

    def unregister(self, owner: str, token: Optional[int] = None) -> bool:
        """Drop ``owner``; with ``token``, only when it still owns the entry
        (a replaced registration keeps the replacement)."""
        with self._lock:
            res = self._owners.get(owner)
            if res is None or (token is not None and res.token != token):
                return False
            del self._owners[owner]
            return True

    def has_owners(self) -> bool:
        return bool(self._owners)

    def owners(self) -> List[Reservation]:
        """Reservations ranked by per-chip footprint, largest first."""
        with self._lock:
            items = list(self._owners.values())
        return sorted(items, key=lambda r: (-r.device_bytes, r.owner))

    def note_program_bytes(self, program: str, nbytes: int) -> None:
        """Record one compiled program's temp/scratch + generated-code bytes
        (the inspector calls this; latest capture per program wins).  Summed
        into the conservation contract's ``program_estimate`` term — memory a
        program owns rather than a live array."""
        with self._lock:
            self._program_bytes[program] = int(nbytes)

    def program_estimate(self) -> int:
        with self._lock:
            return sum(self._program_bytes.values())

    def reset(self) -> None:
        with self._lock:
            self._owners.clear()
            self._program_bytes.clear()
            self._last_devices = []
            self.oom_postmortems = []

    # -- reconciliation ------------------------------------------------------

    def attributed_per_device(self) -> Dict[int, int]:
        """Summed registered bytes per device (subset entries excluded)."""
        out: Dict[int, int] = {}
        for res in self.owners():
            if res.subset_of:
                continue
            for dev, b in res.per_device.items():
                out[dev] = out.get(dev, 0) + b
        return out

    def reconcile(self, stats_fn: Optional[Callable] = None) -> List[dict]:
        """One conservation pass over every local device.

        ``stats_fn(device)`` (a device index) must return a
        ``memory_stats()``-shaped dict or ``None`` (the default asks the
        CUDA allocator, see ``metrics.device_memory_stats``; a CPU run gets ``None`` and
        the record honestly carries ``stats_available: 0`` instead of invented
        arithmetic).  Where stats exist::

            attributed + program_estimate + unattributed == bytes_in_use

        holds per device **by construction** — ``unattributed`` is defined as
        the residual, including a *negative* one (attribution exceeding the
        allocator's count means a stale registration; that is a finding, not
        an error to clamp away).
        """
        stats_fn = stats_fn or _default_stats_fn
        attributed = self.attributed_per_device()
        program = self.program_estimate()
        records = []
        for d, platform in _devices():
            stats = stats_fn(d) or None
            att = attributed.get(d, 0)
            rec = {
                "device": d,
                "platform": platform,
                "attributed_bytes": att,
                "program_estimate_bytes": program,
                "stats_available": 1 if stats else 0,
            }
            if stats:
                in_use = int(stats.get("bytes_in_use", 0))
                rec["bytes_in_use"] = in_use
                rec["unattributed_bytes"] = in_use - att - program
                if "peak_bytes_in_use" in stats:
                    rec["peak_bytes_in_use"] = int(stats["peak_bytes_in_use"])
                limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
                if limit:
                    rec["bytes_limit"] = int(limit)
                    rec["headroom_bytes"] = int(limit) - in_use
            records.append(rec)
        with self._lock:
            self._last_devices = records
        return records

    def min_device_headroom(self) -> Optional[int]:
        """Fleet-min ``bytes_limit - bytes_in_use`` from the last reconcile
        (None when no device reported stats — CPU builds)."""
        with self._lock:
            rooms = [r["headroom_bytes"] for r in self._last_devices if "headroom_bytes" in r]
        return min(rooms) if rooms else None

    def snapshot(self) -> dict:
        """The full ledger view (the ``/debug/memory`` body and the report's
        memory block): ranked owners, per-device conservation records, and
        the program-estimate term."""
        owners = self.owners()
        with self._lock:
            devices = list(self._last_devices)
            programs = dict(self._program_bytes)
        attributed = self.attributed_per_device()
        return {
            "owners": [r.to_dict() for r in owners],
            "devices": devices,
            "attributed_bytes_per_device": {str(k): v for k, v in sorted(attributed.items())},
            "attributed_bytes": max(attributed.values(), default=0),
            "host_bytes": sum(r.host_bytes for r in owners),
            "program_estimate_bytes": sum(programs.values()),
            "programs": programs,
            "oom_postmortems": len(self.oom_postmortems),
        }

    # -- gauges --------------------------------------------------------------

    def publish(self, registry) -> None:
        """Land the ledger's fleet-level view as ``memory.*`` gauges."""
        attributed = self.attributed_per_device()
        registry.gauge("memory.attributed_bytes").set(max(attributed.values(), default=0))
        with self._lock:
            devices = list(self._last_devices)
        residuals = [r["unattributed_bytes"] for r in devices if "unattributed_bytes" in r]
        if residuals:
            # Worst device by magnitude: a large negative residual (stale
            # registration) is as alarming as a large positive one.
            registry.gauge("memory.unattributed_bytes").set(max(residuals, key=abs))
        headroom = self.min_device_headroom()
        if headroom is not None:
            registry.gauge("memory.headroom_bytes").set(headroom)
        for res in self.owners():
            slug = _owner_slug(res.owner)
            registry.gauge(f"memory.owner.{slug}_bytes").set(res.device_bytes)

    def reconcile_and_publish(self, registry, stats_fn: Optional[Callable] = None) -> List[dict]:
        records = self.reconcile(stats_fn=stats_fn)
        self.publish(registry)
        return records

    # -- OOM forensics -------------------------------------------------------

    def note_oom(self, source: str, error: Optional[BaseException] = None, **extra) -> dict:
        """Snapshot the ranked ledger at an OOM site into a
        ``memory.oom_postmortem`` event (flight-recorder mirrored when the
        ring is armed) and name the blamed owner: the largest per-chip
        reservation alive at the moment of death.  Never raises — a
        forensics hook must not mask the OOM it is narrating."""
        try:
            owners = self.owners()
            blamed = next((r for r in owners if not r.subset_of), None)
            # Refresh the watermark AT the crash site (best effort — a truly
            # wedged device keeps the last reconcile's numbers instead).
            try:
                self.reconcile()
            except Exception:
                pass
            with self._lock:
                devices = list(self._last_devices)
            peak = max(
                (r.get("peak_bytes_in_use") for r in devices if r.get("peak_bytes_in_use")),
                default=None,
            )
            in_use = max(
                (r.get("bytes_in_use") for r in devices if r.get("bytes_in_use")),
                default=None,
            )
            postmortem = {
                "source": source,
                "blame": blamed.owner if blamed is not None else None,
                "blame_bytes": blamed.device_bytes if blamed is not None else None,
                "attributed_bytes": sum(
                    r.device_bytes for r in owners if not r.subset_of
                ),
                "ranked": [
                    {"owner": r.owner, "device_bytes": r.device_bytes}
                    for r in owners[:8]
                ],
                "watermark_bytes_in_use": in_use,
                "watermark_peak_bytes": peak,
                "error": f"{type(error).__name__}: {error}"[:300] if error is not None else None,
                **extra,
            }
            self.oom_postmortems.append(postmortem)
            from .core import get_telemetry

            tel = get_telemetry()
            if tel.enabled:
                tel.registry.counter("memory.oom_postmortems").inc()
            # event() writes to the JSONL sink only when telemetry is on but
            # mirrors into the flight recorder whenever the ring is armed —
            # exactly the durability an OOM postmortem needs.
            tel.event("memory.oom_postmortem", **postmortem)
            return postmortem
        except Exception:
            return {"source": source, "blame": None, "error": "postmortem failed"}


_LEDGER = MemoryLedger()


def get_memory_ledger() -> MemoryLedger:
    return _LEDGER
