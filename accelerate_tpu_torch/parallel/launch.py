"""Start a world of processes for one job and wait for them.

The launcher the smokes share (:mod:`.zero_smoke`, the training chaos
campaign and the elastic smoke, the resilience smokes' and the serving
campaign's lives): :func:`start` forks ``world`` children from a server
process that has imported ``FORK_PRELOAD`` once (and initialised no CUDA),
so a child skips the interpreter's start and torch's import; each calls
``<module>.main(argv(rank))`` under the job's environment, with the
repository on ``PYTHONPATH`` and any ``torchrun`` variables removed.
Told its rank, the world size and a ``file://`` rendezvous under the job's
work directory (never a fixed port), a child meets the others in a process
group of their own through :func:`join_group`, which keeps the group's
store for the fleet primitives (``resilience.fleet``).  :meth:`Job.wait`
waits for every child under a time limit and kills the rest when it
passes; a parent can start a job whose children build their state and
then wait for a go signal (:func:`wait_for_file`) while an earlier job
still runs.  :func:`fork` forks one child (a module's ``main``, a script or
a ``python -m`` module) and returns a :class:`Forked` handle shaped as a
``subprocess.Popen``, which the ``FleetSupervisor`` babysits.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import signal
import subprocess
import sys
import threading
import time
from datetime import timedelta
from typing import Callable, Optional, Sequence

__all__ = ["rendezvous", "child_env", "start", "Job", "fork", "Forked", "wait_for_file",
           "join_group", "devices_for", "run_ranks", "rank_child", "FORK_PRELOAD"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# What a forked child finds imported already: torch, its process groups and
# the compiler stack its optimizers import (seconds of every start).
FORK_PRELOAD = ("torch", "torch.distributed", "torch._dynamo", "numpy")


def rendezvous(workdir: str) -> str:
    """A fresh ``file://`` init method under ``workdir``."""
    return f"file://{os.path.join(workdir, f'rendezvous_{os.getpid()}_{time.time_ns()}')}"


def child_env(base: Optional[dict] = None) -> dict:
    """``base`` (the environment by default) with the repository on
    ``PYTHONPATH`` and the ``torchrun`` variables removed."""
    env = dict(os.environ if base is None else base)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    return env


def devices_for(device, world: int, backend: Optional[str] = None) -> tuple:
    """``(backend, devices)`` for ``world`` processes on ``device`` (a
    ``torch.device``): NCCL with a card each where there are enough cards
    (or where asked), else gloo, with every process on card 0 (or on the
    CPU)."""
    import torch

    if backend is None:
        backend = ("nccl" if device.type == "cuda" and torch.cuda.device_count() >= world
                   else "gloo")
    if backend == "nccl":
        return backend, [f"cuda:{r}" for r in range(world)]
    return backend, [("cuda:0" if device.type == "cuda" else "cpu")] * world


class Job:
    """The processes of one job, started together: :meth:`wait` collects
    them."""

    def __init__(self, module: str, procs: list, spools: list, started: float):
        self.module, self.procs, self.spools, self.started = module, procs, spools, started

    def wait(self, timeout: float = 900.0) -> list:
        """Wait for every child (within ``timeout`` seconds of the start);
        each one's ``(exitcode, stdout, stderr)`` (the streams None unless
        captured; the exit code negative for a signal).  A child still
        running when the wait ends is killed."""
        deadline = self.started + timeout
        late = []
        try:
            for p in self.procs:
                p.join(max(1.0, deadline - time.monotonic()))
                late.append(p.exitcode is None)
        finally:
            self.kill()
        out = []
        for p, killed, (so, se) in zip(self.procs, late, self.spools):
            texts = []
            for f in (so, se):
                if f is None:
                    texts.append(None)
                else:
                    f.seek(0)
                    texts.append(f.read())
                    f.close()
                    os.unlink(f.name)
            if killed:
                texts[1] = (texts[1] or "") + f"\n{self.module}: killed after {timeout} s"
            out.append((p.exitcode, *texts))
        return out

    def kill(self) -> None:
        for p in self.procs:
            if p.exitcode is None:
                p.kill()
                p.join()


def start(module: str, argv: Callable[[int], Sequence[str]], world: int,
          env: Optional[dict] = None, capture: bool = False) -> Job:
    """Start ``world`` children, forked together, each calling
    ``module.main(argv(rank))`` under ``env`` (this process's by default);
    its return value is the child's exit code.  ``capture`` spools each
    child's streams through files, so no child ever blocks on a full
    pipe."""
    import tempfile

    spools = [(tempfile.NamedTemporaryFile("w+", delete=False),
               tempfile.NamedTemporaryFile("w+", delete=False)) if capture
              else (None, None) for _ in range(world)]
    procs = [fork(module, argv(r), env, *(f.name if f else None for f in spools[r])).process
             for r in range(world)]
    return Job(module, procs, spools, time.monotonic())


class Forked:
    """One forked child, shaped as a ``subprocess.Popen`` (what the
    ``FleetSupervisor`` calls): ``pid``, ``returncode``, ``poll()`` (the exit
    code, negative for a signal, None while it runs), ``send_signal``,
    ``terminate``, ``kill`` and ``wait(timeout)``."""

    def __init__(self, process):
        self.process = process
        self.pid = process.pid
        self.returncode = None

    def poll(self) -> Optional[int]:
        self.returncode = self.process.exitcode
        return self.returncode

    def send_signal(self, signum: int) -> None:
        if self.poll() is None:
            try:
                os.kill(self.pid, signum)
            except ProcessLookupError:
                pass

    def terminate(self) -> None:
        self.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        self.send_signal(signal.SIGKILL)

    def wait(self, timeout: Optional[float] = None) -> int:
        self.process.join(timeout)
        if self.poll() is None:
            raise subprocess.TimeoutExpired(f"forked pid {self.pid}", timeout)
        return self.returncode


def fork(target: str, argv: Sequence[str], env: Optional[dict] = None,
         stdout: Optional[str] = None, stderr: Optional[str] = None,
         how: str = "main") -> Forked:
    """Fork one child from the preloaded server under ``env`` (this
    process's by default, through :func:`child_env`); its streams appended
    to the files ``stdout`` / ``stderr`` (else this process's).  ``how``:
    ``"main"`` calls ``target.main(argv)`` (its return value the exit
    code), ``"path"`` runs the script ``target`` and ``"module"`` the
    module ``target`` as ``python [-m] target *argv`` would."""
    if how not in ("main", "path", "module"):
        raise ValueError(f"how must be 'main', 'path' or 'module', got {how!r}")
    p = _fork_context().Process(target=_forked, args=(target, list(argv), child_env(env),
                                                      stdout, stderr, how))
    with _main_hidden():
        p.start()
    return Forked(p)


_FORK_CONTEXT = []


def _fork_context():
    if not _FORK_CONTEXT:
        import multiprocessing

        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload(list(FORK_PRELOAD))
        _FORK_CONTEXT.append(ctx)
    return _FORK_CONTEXT[0]


_MAIN_LOCK = threading.Lock()


@contextlib.contextmanager
def _main_hidden():
    """Keep multiprocessing from re-running the parent's main script in a
    forked child (``_forked`` imports what it runs itself).  One thread at a
    time: the parent's threads may start jobs side by side."""
    with _MAIN_LOCK:
        main = sys.modules.get("__main__")
        saved = {k: main.__dict__[k] for k in ("__file__", "__spec__") if k in main.__dict__}
        try:
            for k in saved:
                setattr(main, k, None)
            yield
        finally:
            main.__dict__.update(saved)


def _forked(module: str, argv: list, env: dict, out_path: Optional[str],
            err_path: Optional[str], how: str = "main") -> None:
    """A forked child: the job's environment and streams, then
    ``module.main(argv)`` (its return value is the exit code), or the
    script or module ``module`` run as ``__main__``."""
    import importlib
    import runpy

    os.environ.clear()
    os.environ.update(env)
    for path, target in ((out_path, 1), (err_path, 2)):
        if path is not None:
            sys.stdout.flush()
            sys.stderr.flush()
            fd = os.open(path, os.O_WRONLY | os.O_APPEND)
            os.dup2(fd, target)
            os.close(fd)
    threads = env.get("OMP_NUM_THREADS")
    if threads:
        import torch

        torch.set_num_threads(int(threads))
    try:
        if how == "main":
            code = importlib.import_module(module).main(argv)
        elif how == "path":
            sys.argv = [module, *argv]
            sys.path.insert(0, os.path.dirname(os.path.abspath(module)))
            runpy.run_path(module, run_name="__main__")
            code = 0
        else:
            sys.argv = [module, *argv]
            runpy.run_module(module, run_name="__main__", alter_sys=True)
            code = 0
    finally:
        # What a fresh interpreter runs at its exit (multiprocessing skips
        # it): telemetry's final snapshot, the flight recorder's flush.
        atexit._run_exitfuncs()
        sys.stdout.flush()
        sys.stderr.flush()
    sys.exit(int(code or 0))


def wait_for_file(path: str, timeout: float) -> float:
    """Block until ``path`` exists (a go signal a parent writes); the
    seconds waited.  Raises ``TimeoutError`` after ``timeout``."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)
    return time.monotonic() - t0


def join_group(rank: int, world: int, init: str, backend: str, device: str) -> None:
    """The child's side: pin its card (TF32 off, as the fp32 checks
    assume) and join the group over a ``FileStore`` at ``init``
    (``file://<path>``, from :func:`rendezvous`), kept for the fleet
    primitives; nothing to join for one process."""
    import torch
    import torch.distributed as dist

    from ..resilience import fleet

    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
        torch.backends.cuda.matmul.allow_tf32 = False
    if world > 1:
        if not init.startswith("file://"):
            raise ValueError(f"init must be file://<path>, got {init!r}")
        store = dist.FileStore(init[len("file://"):], world)
        store.set_timeout(timedelta(minutes=30))  # the group's default, as the rendezvous sets it
        dist.init_process_group(backend, store=store, rank=rank, world_size=world)
        fleet._keep_store(store)


def run_ranks(module: str, device, world: int, workdir: str, timeout: float = 600.0,
              env: Optional[dict] = None) -> list:
    """One job of ``world`` ranks on ``device`` (a ``torch.device``; the
    backend and each rank's card by :func:`devices_for`), each forked to call
    ``module.main(["--rank-child", <json>])``, which hands the JSON to
    :func:`rank_child`; waits for them and returns each rank's record, in
    rank order.  Raises ``RuntimeError`` with the ranks' last errors when one
    fails."""
    import json

    os.makedirs(workdir, exist_ok=True)
    init = rendezvous(workdir)
    backend, devices = devices_for(device, world)
    outs = [os.path.join(workdir, f"rank{r}.json") for r in range(world)]
    job = start(module, lambda r: ["--rank-child", json.dumps(
        [r, world, init, backend, devices[r], outs[r]])], world, env=env, capture=True)
    results = job.wait(timeout)
    if any(code != 0 for code, _, _ in results):
        tails = "\n".join(f"--- rank {r} exited {code} ---\n{(err or '')[-3000:]}"
                          for r, (code, _, err) in enumerate(results))
        raise RuntimeError(f"{module}: a rank failed\n{tails}")
    records = []
    for out in outs:
        with open(out) as f:
            records.append(json.load(f))
    return records


def rank_child(fn: Callable, argv_json: str) -> int:
    """A rank of :func:`run_ranks`: join the group, ``record = fn(rank,
    world, device)``, meet the others at a barrier, leave the group and
    write the record (JSON) where the parent reads it."""
    import json

    import torch.distributed as dist

    rank, world, init, backend, device, out = json.loads(argv_json)
    join_group(rank, world, init, backend, device)
    try:
        record = fn(rank, world, device)
        if dist.is_initialized():
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(record, f)
    return 0
