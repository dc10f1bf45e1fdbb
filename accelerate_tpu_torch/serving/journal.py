"""Crash-recovery write-ahead journal for the serving engine.

A copy of the JAX package's ``serving/journal.py`` with the same file
schema, so an engine of either package recovers from the other's journal.
Every admission and every terminal transition rewrites one JSON file
through a temporary file and ``os.replace`` (fsynced unless
``ACCELERATE_TPU_CHECKPOINT_FSYNC=0``): the file on disk is always a whole
snapshot, and a kill mid-write leaves the previous one.

Recovery (:meth:`ServingEngine.recover_from_journal`): a successor engine
resubmits every journaled request with no terminal record as ``prompt +
emitted`` with ``max_new = remaining``; greedy decode then finishes it
token-identically to an uninterrupted run.

What is written when:

- **admission** (``record_admit``): prompt, budget, tag, deadlines, before
  ``submit`` returns the id, so an acknowledged request is recoverable;
- **terminal** (``record_done``): ``ok`` / ``deadline_expired`` /
  ``quarantined``; terminal requests are never replayed;
- **drain** (``record_progress``): emitted tokens of the still-pending
  requests, so the successor resumes mid-request;
- **tier residency** (``record_tier``): ``"host"`` when the host tier takes
  a preempted request's KV, ``"device"`` when it comes back, with the
  emitted progress at that moment.  Host memory dies with the process, so
  the record only lets recovery resume from the migration point.

Emitted tokens are not written per decode tick: that would put a disk write
on every tick, and recovery needs them only to avoid recompute.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List

__all__ = ["ServingJournal", "JournalError", "JOURNAL_VERSION"]

JOURNAL_VERSION = 1


class JournalError(RuntimeError):
    """The journal file is missing, unreadable, or from a newer schema."""


def _fsync_enabled() -> bool:
    return os.environ.get(
        "ACCELERATE_TPU_CHECKPOINT_FSYNC", "1"
    ).strip().lower() not in ("0", "false", "no", "off")


class ServingJournal:
    """One engine's write-ahead journal: an in-memory state mirrored to
    ``path`` atomically on every mutation.  The file is written lazily, so
    a fresh engine pointed at a dead predecessor's journal can still
    :meth:`load` it before its first admission overwrites it.
    ``flushes`` and ``flush_seconds`` count the writes and the host
    seconds they took."""

    def __init__(self, path: str):
        self.path = path
        self._requests: Dict[str, dict] = {}
        self._done: Dict[str, str] = {}
        self._flushed = False
        self._deferred = False
        self.flushes = 0
        self.flush_seconds = 0.0

    @property
    def flushed(self) -> bool:
        """Whether this journal has written ``path`` at least once."""
        return self._flushed

    @contextlib.contextmanager
    def deferred(self):
        """Batch mutations into ONE atomic flush at context exit.  Recovery
        needs it: flushing per resubmit would overwrite the predecessor's
        journal after the first one, and a kill mid-recovery would lose the
        rest."""
        self._deferred = True
        try:
            yield self
        finally:
            self._deferred = False
            self._flush()

    # -- mutation (each call lands on disk before returning) -----------------

    def record_admit(self, req) -> None:
        self._requests[str(req.id)] = {
            "prompt": list(req.prompt),
            "max_new_tokens": int(req.max_new_tokens),
            "tag": req.tag,
            "ttft_deadline_ms": req.ttft_deadline_ms,
            "deadline_ms": req.deadline_ms,
            "emitted": [],
            # Wall-clock admission time: the JAX package's trace stitcher
            # dates a dead engine's requests from it.
            "arrival_wall": time.time(),
        }
        self._flush()

    def record_done(self, rid: int, status: str) -> None:
        self._done[str(rid)] = status
        self._flush()

    def record_tier(self, req, residency: str) -> None:
        """Persist a request's KV tier transition (``"host"`` on demotion,
        ``"device"`` on promotion or fallback) and its emitted progress."""
        entry = self._requests.get(str(req.id))
        if entry is None:
            return
        entry["tier"] = {
            "residency": residency,
            "demoted_rows": int(req.demoted_rows),
            "demoted_blocks": len(req.demoted_blocks or ()),
            "migrations": int(req.migrations),
        }
        entry["emitted"] = list(req.emitted)
        self._flush()

    def record_progress(self, reqs) -> None:
        """Persist emitted-token progress of still-pending requests."""
        for req in reqs:
            entry = self._requests.get(str(req.id))
            if entry is not None:
                entry["emitted"] = list(req.emitted)
        self._flush()

    def _flush(self) -> None:
        if self._deferred:
            return
        t0 = time.perf_counter()
        state = {"version": JOURNAL_VERSION, "requests": self._requests, "done": self._done}
        tmp = f"{self.path}.tmp"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            if _fsync_enabled():
                try:
                    os.fsync(f.fileno())
                except OSError:
                    pass
        os.replace(tmp, self.path)
        self._flushed = True
        self.flushes += 1
        self.flush_seconds += time.perf_counter() - t0

    # -- recovery ------------------------------------------------------------

    @staticmethod
    def load(path: str) -> dict:
        """Parse a journal file; raises :class:`JournalError` when it is
        missing, unparseable, or from a newer schema."""
        try:
            with open(path) as f:
                state = json.load(f)
        except FileNotFoundError:
            raise JournalError(f"no journal at {path!r}") from None
        except (OSError, json.JSONDecodeError) as e:
            raise JournalError(f"unreadable journal at {path!r}: {e}") from e
        version = state.get("version")
        if not isinstance(version, int) or version > JOURNAL_VERSION:
            raise JournalError(
                f"journal {path!r} has schema version {version!r}; this "
                f"engine understands <= {JOURNAL_VERSION}"
            )
        if not isinstance(state.get("requests"), dict) or not isinstance(state.get("done"), dict):
            raise JournalError(f"journal {path!r} is structurally invalid")
        return state

    @staticmethod
    def pending(state: dict) -> List[dict]:
        """The journaled requests with no terminal record, oldest admission
        first, each with its original id under ``"id"``."""
        done = state["done"]
        out = []
        for rid in sorted(state["requests"], key=int):
            if rid not in done:
                rec = dict(state["requests"][rid])
                rec["id"] = int(rid)
                out.append(rec)
        return out
