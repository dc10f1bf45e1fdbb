"""In-process and multi-process launchers, and the fleet supervisor.

The JAX package's ``launchers.py`` in the port (parity target: the
reference ``src/accelerate/launchers.py``, ``notebook_launcher`` and
``debug_launcher``).

- :func:`notebook_launcher` calls the function directly for one process
  (restarting it up to ``max_restarts`` times); for ``num_processes > 1`` it
  starts that many processes, placed as ``parallel.launch.devices_for``
  places them (NCCL with a card each where the host has enough cards, else
  gloo with every process on card 0).  It needs CUDA for that: processes
  on the CPU are :func:`debug_launcher`'s.
- :func:`debug_launcher` starts N processes on the CPU that meet in one gloo
  group, exercising the true multi-process paths (collectives, barriers,
  per-process data shards) without a card.

Their processes are forked from a server that imported torch once
(``parallel.launch``), so the function must be importable, as under the
``spawn`` start method.

:class:`FleetSupervisor` is the parent-side half of the hardened fleet
runtime (the worker-side primitives live in ``resilience/fleet.py``): it
owns the env contract of every worker it spawns, watches the child exits
AND the per-rank step-loop heartbeats, tears the fleet down within a
bounded grace window when a member dies or wedges (the survivors would
otherwise hang in their next collective), merges every rank's
flight-recorder stream into one fleet postmortem, and, in elastic mode,
relaunches at the reduced world size so the elastic resume can pick the
run back up.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import threading
import time
import traceback
from typing import Callable, Optional

from .utils.environment import patch_environment

__all__ = ["notebook_launcher", "debug_launcher", "FleetSupervisor"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def notebook_launcher(
    function: Callable,
    args=(),
    num_processes: int = None,
    mixed_precision: str = "no",
    use_port: str = "29500",
    master_addr: str = "127.0.0.1",
    node_rank: int = 0,
    num_nodes: int = 1,
    rdzv_backend: str = "static",
    rdzv_endpoint: str = "",
    rdzv_conf=None,
    rdzv_id: str = "none",
    max_restarts: int = 0,
    monitor_interval: float = 0.1,
    log_line_prefix_template=None,
):
    """Launch training from a notebook.

    ``num_processes`` None or 1: a direct call.  ``num_processes > 1``:
    that many processes on this host's cards (a card each where there are
    enough, else all on card 0 over gloo), each calling ``function(*args)``
    with the launch contract in its environment; it raises without CUDA.
    Either way a failure restarts the whole attempt up to ``max_restarts``
    times (torchelastic restarts the full group too).
    """
    attempts = max(int(max_restarts), 0) + 1
    last_exc = None
    if not num_processes or num_processes <= 1:
        for attempt in range(attempts):
            try:
                with patch_environment(ACCELERATE_MIXED_PRECISION=mixed_precision):
                    return function(*args)
            except Exception as exc:  # noqa: BLE001 — elastic restart boundary
                last_exc = exc
                _flush_flight_recorder("notebook_launcher_exception", error=traceback.format_exc())
                if attempt + 1 < attempts:
                    import logging

                    logging.getLogger(__name__).warning(
                        "notebook_launcher attempt %d/%d failed (%s); restarting",
                        attempt + 1, attempts, exc,
                    )
        raise last_exc
    from .state import resolve_device

    resolve_device(None)  # processes on the card, or a loud error
    for attempt in range(attempts):
        try:
            return _run_processes(function, args, num_processes,
                                  {"ACCELERATE_MIXED_PRECISION": str(mixed_precision)})
        except Exception as exc:  # noqa: BLE001 — elastic restart boundary
            last_exc = exc
            if attempt + 1 < attempts:
                import logging

                logging.getLogger(__name__).warning(
                    "notebook_launcher cluster attempt %d/%d failed (%s); restarting",
                    attempt + 1, attempts, exc,
                )
    raise last_exc


def _flush_flight_recorder(reason: str, error: Optional[str] = None) -> None:
    """Best-effort crash flush: a worker that dies from a Python exception
    is caught (not killed by a signal), so the flight recorder's signal and
    excepthook paths never fire — without an explicit flush its last events
    would die with the process and the fleet postmortem would show the
    crashed rank as silent."""
    try:
        from .telemetry.flightrec import get_flight_recorder

        rec = get_flight_recorder()
        if rec.enabled:
            if error is not None:
                rec.record("crash", origin=reason, error=error[-2000:])
            rec.flush(reason=reason)
    except Exception:
        pass


def _worker_entry(fn, args, env: dict, rank: int, queue):
    try:
        os.environ.update(env)
        os.environ["ACCELERATE_PROCESS_ID"] = str(rank)
        fn(*args)
        queue.put((rank, None))
    except Exception:
        err = traceback.format_exc()
        _flush_flight_recorder("worker_exception", error=err)
        queue.put((rank, err))


def debug_launcher(function: Callable, args=(), num_processes: int = 2):
    """Run ``function`` in ``num_processes`` processes on the CPU.

    Parity: the reference ``debug_launcher``, which forked N gloo CPU
    workers.  Each worker's ``Accelerator`` joins one gloo group over a
    ``TCPStore`` on this host (``ACCELERATE_USE_CPU`` keeps it on the CPU),
    so collectives, barriers and data-loader shards behave as across
    several GPUs.
    """
    _run_processes(function, args, num_processes,
                   {"ACCELERATE_USE_CPU": "1", "ACCELERATE_DEBUG_LAUNCHER": "1"})


def _run_processes(function: Callable, args, num_processes: int, extra: dict) -> None:
    """``num_processes`` forked processes each calling ``function(*args)``
    under the launch contract; the first failure reaps the rest and
    raises."""
    import queue as queue_mod

    from .parallel.launch import _fork_context

    ctx = _fork_context()
    env = {
        "ACCELERATE_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
        "ACCELERATE_NUM_PROCESSES": str(num_processes),
        **extra,
    }
    queue = ctx.Queue()
    procs = []
    for rank in range(num_processes):
        p = ctx.Process(target=_worker_entry, args=(function, args, env, rank, queue))
        p.start()
        procs.append(p)
    failures = []
    reported = 0
    # Poll with a timeout so a worker that dies before reporting (segfault,
    # SIGKILL) is detected through its exit code instead of hanging the
    # parent.  The FIRST failure ends the wait: the dead rank's siblings are
    # stuck in their next collective and will never report.
    while reported < num_processes and not failures:
        try:
            rank, err = queue.get(timeout=1.0)
            reported += 1
            if err is not None:
                failures.append((rank, err))
        except queue_mod.Empty:
            dead = [
                (i, p.exitcode) for i, p in enumerate(procs) if not p.is_alive() and p.exitcode != 0
            ]
            for r, code in dead:
                failures.append((r, f"worker exited with code {code} before reporting"))
    if failures:
        # Reap the survivors NOW: SIGTERM, a short grace, then SIGKILL for
        # anyone wedged in a dead collective (signal handlers can't run
        # while the main thread is stuck inside the runtime).
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        details = "\n".join(f"--- rank {r} ---\n{e}" for r, e in failures)
        raise RuntimeError(f"debug_launcher workers failed:\n{details}")
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.terminate()


# ---------------------------------------------------------------------------
# FleetSupervisor — parent-side fleet runtime
# ---------------------------------------------------------------------------


class _FleetMember:
    __slots__ = ("rank", "proc", "spawned_at", "ever_beat")

    def __init__(self, rank: int, proc):
        self.rank = rank
        self.proc = proc
        self.spawned_at = time.monotonic()
        self.ever_beat = False


class FleetSupervisor:
    """Spawn and babysit an N-process fleet.

    ``spawn(rank, world_size, env)`` must start one worker and return its
    ``subprocess.Popen`` (or a ``parallel.launch.Forked``, a child forked
    from the preloaded server); the supervisor owns the env contract
    (coordinator address on a fresh port per attempt, world size, rank,
    heartbeat dir, attempt) and the caller merges in whatever else the
    workers need.

    Liveness has two signals:

    - **child exit** — any nonzero exit marks the fleet ``worker_dead``;
      the rank named is the first seen dead, and within one poll a rank a
      signal killed before one that exited with an error (gloo, unlike a
      hang, can fail a survivor's collective on the dead peer's socket at
      once);
    - **heartbeat stall** — workers that opt in (anything driving
      ``Accelerator.check_preemption``, through
      ``resilience.fleet.maybe_beat``) beat a per-rank file from their step
      loop; a rank whose file goes stale for ``heartbeat_timeout_s`` marks
      the fleet ``wedged``.  With ``require_heartbeat=True`` a rank that
      never beats at all is judged on the same clock (for fleets known to
      be instrumented).

    Either way the survivors are torn down within ``grace_s`` (SIGTERM,
    then SIGKILL — a process stuck inside a dead collective never runs its
    Python signal handler), every rank's flight-recorder and telemetry
    stream under ``telemetry_dir`` is merged into one
    ``fleet_postmortem_a<N>.json``, and — when ``elastic=True`` — the fleet
    relaunches at world size N-1 (down to ``min_processes``), where the
    elastic resume restores the run.

    SIGTERM/SIGINT delivered to the supervisor itself are forwarded to
    every worker (coordinated drain: the workers' ``PreemptionGuard``
    agrees on one final checkpoint); workers then get ``drain_grace_s`` to
    exit cleanly.
    """

    def __init__(
        self,
        spawn: Callable[[int, int, dict], subprocess.Popen],
        num_processes: int,
        workdir: str,
        *,
        heartbeat_timeout_s: float = 60.0,
        grace_s: float = 10.0,
        drain_grace_s: float = 60.0,
        poll_s: float = 0.2,
        elastic: bool = False,
        min_processes: int = 1,
        require_heartbeat: bool = False,
        telemetry_dir: Optional[str] = None,
        host: str = "127.0.0.1",
    ):
        if num_processes < 1:
            raise ValueError(f"num_processes must be >= 1, got {num_processes}")
        self.spawn = spawn
        self.num_processes = num_processes
        self.workdir = workdir
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.grace_s = grace_s
        self.drain_grace_s = drain_grace_s
        self.poll_s = poll_s
        self.elastic = elastic
        self.min_processes = max(1, min_processes)
        self.require_heartbeat = require_heartbeat
        self.telemetry_dir = telemetry_dir
        self.host = host
        self._drain_signum: Optional[int] = None
        os.makedirs(workdir, exist_ok=True)

    # -- signal plumbing (drain forwarding) ---------------------------------

    def _install_drain_handler(self):
        if threading.current_thread() is not threading.main_thread():
            return None
        previous = {}

        def _handler(signum, frame):
            self._drain_signum = signum

        for signum in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[signum] = signal.signal(signum, _handler)
            except (ValueError, OSError):
                pass
        return previous

    @staticmethod
    def _restore_handlers(previous):
        if not previous:
            return
        for signum, handler in previous.items():
            try:
                signal.signal(signum, handler)
            except (ValueError, OSError, TypeError):
                pass

    # -- lifecycle ----------------------------------------------------------

    def run(self) -> dict:
        """Supervise until the fleet completes, drains, or dies
        unrecoverably.  Returns a summary: ``verdict`` (``completed`` /
        ``drained`` / ``worker_dead`` / ``wedged`` / ``drain_timeout``), the
        final ``world_size``, per-``attempts`` records, and the last
        postmortem path (None when no failure produced one)."""
        previous = self._install_drain_handler()
        attempts = []
        world = self.num_processes
        try:
            while True:
                attempt = self._run_attempt(world, len(attempts))
                attempts.append(attempt)
                if attempt["verdict"] in ("completed", "drained", "drain_timeout"):
                    break
                relaunch = (
                    self.elastic
                    and attempt["verdict"] in ("worker_dead", "wedged")
                    and world - 1 >= self.min_processes
                )
                if not relaunch:
                    break
                world -= 1
                self._note_event("fleet.relaunch", world_size=world, cause=attempt["verdict"])
                self._inc_counter("fleet.elastic_restarts")
        finally:
            self._restore_handlers(previous)
        postmortems = [a["postmortem"] for a in attempts if a.get("postmortem")]
        return {
            "verdict": attempts[-1]["verdict"],
            "world_size": world,
            "attempts": attempts,
            "postmortem": postmortems[-1] if postmortems else None,
        }

    def _run_attempt(self, world: int, index: int) -> dict:
        from .resilience.fleet import heartbeat_path

        attempt_dir = os.path.join(self.workdir, f"attempt{index}")
        hb_dir = os.path.join(attempt_dir, "heartbeats")
        os.makedirs(hb_dir, exist_ok=True)
        port = _free_port()
        members = []
        start = time.monotonic()
        for rank in range(world):
            env = {
                "ACCELERATE_COORDINATOR_ADDRESS": f"{self.host}:{port}",
                "ACCELERATE_NUM_PROCESSES": str(world),
                "ACCELERATE_PROCESS_ID": str(rank),
                "ACCELERATE_TPU_HEARTBEAT_DIR": hb_dir,
                "ACCELERATE_FLEET_ATTEMPT": str(index),
            }
            members.append(_FleetMember(rank, self.spawn(rank, world, env)))

        verdict = None
        dead_rank = None
        wedged_rank = None
        exit_code = None
        drain_forwarded_at = None
        while verdict is None:
            codes = [m.proc.poll() for m in members]
            failed = [(m.rank, rc) for m, rc in zip(members, codes) if rc not in (None, 0)]
            if failed:
                # Signal deaths first: the ranks that exited with an error in
                # the same poll are most likely survivors whose collective
                # broke on the dead rank.
                dead_rank, exit_code = min(failed, key=lambda f: (f[1] >= 0, f[0]))
                verdict = "worker_dead"
                break
            if all(rc == 0 for rc in codes):
                verdict = "drained" if drain_forwarded_at is not None else "completed"
                break
            wedged_rank = self._stalest_rank(members, hb_dir, heartbeat_path)
            if wedged_rank is not None:
                verdict = "wedged"
                break
            if self._drain_signum is not None:
                if drain_forwarded_at is None:
                    drain_forwarded_at = time.monotonic()
                    self._note_event(
                        "fleet.drain", signum=int(self._drain_signum), world_size=world
                    )
                    for m in members:
                        if m.proc.poll() is None:
                            try:
                                m.proc.send_signal(self._drain_signum)
                            except OSError:
                                pass
                elif time.monotonic() - drain_forwarded_at > self.drain_grace_s:
                    verdict = "drain_timeout"
                    break
            time.sleep(self.poll_s)

        teardown_s = 0.0
        postmortem = None
        if verdict in ("worker_dead", "wedged", "drain_timeout"):
            teardown_s = self._teardown(members)
            postmortem = self._harvest_postmortem(
                index, world, verdict, dead_rank, wedged_rank, exit_code
            )
            if verdict == "worker_dead":
                self._inc_counter("fleet.worker_deaths")
                self._note_event(
                    "fleet.worker_dead", rank=dead_rank, exit_code=exit_code,
                    world_size=world, teardown_s=round(teardown_s, 3),
                )
            elif verdict == "wedged":
                self._inc_counter("fleet.wedged_workers")
                self._note_event(
                    "fleet.wedged", rank=wedged_rank, world_size=world,
                    heartbeat_timeout_s=self.heartbeat_timeout_s,
                    teardown_s=round(teardown_s, 3),
                )
        exit_codes = {m.rank: m.proc.poll() for m in members}
        return {
            "attempt": index,
            "world_size": world,
            "verdict": verdict,
            "dead_rank": dead_rank,
            "wedged_rank": wedged_rank,
            "exit_code": exit_code,
            "exit_codes": exit_codes,
            "teardown_s": round(teardown_s, 3),
            "duration_s": round(time.monotonic() - start, 3),
            "postmortem": postmortem,
            "heartbeat_dir": hb_dir,
        }

    def _stalest_rank(self, members, hb_dir, heartbeat_path) -> Optional[int]:
        """The first live rank whose heartbeat went stale (None when all
        fresh).  Ranks that never beat are only judged under
        ``require_heartbeat`` — an uninstrumented script must not read as
        wedged."""
        now = time.time()
        mono_now = time.monotonic()
        for m in members:
            if m.proc.poll() is not None:
                continue
            path = heartbeat_path(hb_dir, m.rank)
            try:
                age = now - os.stat(path).st_mtime
                m.ever_beat = True
            except OSError:
                if not self.require_heartbeat:
                    continue
                age = mono_now - m.spawned_at
            if age > self.heartbeat_timeout_s:
                return m.rank
        return None

    def _teardown(self, members) -> float:
        """Bounded teardown of every live member: SIGTERM, ``grace_s`` to
        comply, then SIGKILL — survivors of a dead collective are stuck in
        the runtime and never see the SIGTERM."""
        t0 = time.monotonic()
        for m in members:
            if m.proc.poll() is None:
                try:
                    m.proc.terminate()
                except OSError:
                    pass
        deadline = t0 + self.grace_s
        while time.monotonic() < deadline and any(m.proc.poll() is None for m in members):
            time.sleep(min(self.poll_s, 0.1))
        for m in members:
            if m.proc.poll() is None:
                try:
                    m.proc.kill()
                except OSError:
                    pass
        for m in members:
            try:
                m.proc.wait(timeout=10)
            except (subprocess.TimeoutExpired, OSError):
                pass
        self._note_event(
            "fleet.teardown", grace_s=self.grace_s, took_s=round(time.monotonic() - t0, 3),
        )
        return time.monotonic() - t0

    def _harvest_postmortem(
        self, index, world, verdict, dead_rank, wedged_rank, exit_code
    ) -> Optional[str]:
        """Merge every rank's flight-recorder and telemetry stream into one
        rank-tagged postmortem document (the ``telemetry.report --fleet``
        view, persisted) so the blame trail survives the fleet."""
        if not self.telemetry_dir or not os.path.isdir(self.telemetry_dir):
            return None
        try:
            from .telemetry.report import load_fleet_records, summarize_fleet

            summary = summarize_fleet(load_fleet_records(self.telemetry_dir))
            doc = {
                "cause": verdict,
                "dead_rank": dead_rank,
                "wedged_rank": wedged_rank,
                "exit_code": exit_code,
                "world_size": world,
                "attempt": index,
                "t": time.time(),
                "fleet": summary,
            }
            path = os.path.join(self.workdir, f"fleet_postmortem_a{index}.json")
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=2, default=str)
            os.replace(tmp, path)
            self._note_event("fleet.postmortem", path=path, cause=verdict)
            return path
        except Exception:
            import logging

            logging.getLogger(__name__).exception("fleet postmortem harvest failed")
            return None

    # -- telemetry (best-effort; the supervisor may run with it disabled) ----

    @staticmethod
    def _note_event(name, **fields):
        try:
            from .telemetry import get_telemetry

            tel = get_telemetry()
            if tel.enabled:
                tel.event(name, **fields)
        except Exception:
            pass

    @staticmethod
    def _inc_counter(name):
        try:
            from .telemetry import get_telemetry

            tel = get_telemetry()
            if tel.enabled:
                tel.registry.counter(name).inc()
        except Exception:
            pass
