"""A world of gloo processes that the tests of several processes share.

``World(n, tmp_dir)`` starts ``n`` Python processes (``python -c``, so
nothing of pytest's own process is inherited) that meet in one gloo
process group through a ``file://`` rendezvous under ``tmp_dir``, never a
fixed port.  Each then serves tasks: ``world.run("module:function", *args)``
calls ``function(*args)`` in every process and returns the results in rank
order; an exception in any process fails the call with every traceback.
Task functions live in importable modules (``torch_dp_tasks``), run with
``device="cpu"`` and reset the port's shared state themselves.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import secrets
import subprocess
import sys
import traceback
from multiprocessing.connection import Client, Listener

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent
TASK_TIMEOUT_S = 240.0


class World:
    def __init__(self, n: int, tmp_dir, threads: int = 2):
        self.n = n
        key = secrets.token_bytes(16)
        self._listener = Listener(("127.0.0.1", 0), authkey=key)
        host, port = self._listener.address
        init_file = os.path.join(str(tmp_dir), f"gloo_init_{secrets.token_hex(4)}")
        path = [str(REPO), str(TESTS)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(path), "CUDA_VISIBLE_DEVICES": ""}
        for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(name, None)
        self._procs = []
        for rank in range(n):
            code = (f"import torch_dp_world as w; w._serve({rank}, {n}, {host!r}, {port}, "
                    f"{key.hex()!r}, {init_file!r}, {threads})")
            self._procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO),
                                                env=env))
        self._conns = [None] * n
        for _ in range(n):
            conn = self._listener.accept()
            self._conns[conn.recv()] = conn

    def run(self, task: str, *args, **kwargs) -> list:
        for conn in self._conns:
            _send(conn, (task, args, kwargs))
        results, errors = [], []
        for rank, conn in enumerate(self._conns):
            if not conn.poll(TASK_TIMEOUT_S):
                self.close()
                raise TimeoutError(f"{task}: rank {rank} gave no answer in {TASK_TIMEOUT_S} s")
            status, value = _recv(conn)
            if status == "err":
                errors.append(f"--- rank {rank} ---\n{value}")
            results.append(value)
        if errors:
            raise AssertionError(f"{task} failed:\n" + "\n".join(errors))
        return results

    def close(self) -> None:
        for conn in self._conns:
            try:
                _send(conn, None)
            except (OSError, AttributeError):
                pass
        for proc in self._procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self._listener.close()


def _send(conn, obj) -> None:
    # Plain pickle: the connection's own pickler would hand tensors over as
    # shared-memory handles.
    conn.send_bytes(pickle.dumps(obj))


def _recv(conn):
    return pickle.loads(conn.recv_bytes())


def _serve(rank: int, n: int, host: str, port: int, key: str, init_file: str,
           threads: int) -> None:
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    conn = Client((host, port), authkey=bytes.fromhex(key))
    conn.send(rank)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=n)
    try:
        while True:
            msg = _recv(conn)
            if msg is None:
                break
            task, args, kwargs = msg
            module, name = task.split(":")
            try:
                value = getattr(importlib.import_module(module), name)(*args, **kwargs)
                _send(conn, ("ok", value))
            except BaseException:  # noqa: BLE001 - reported to the parent
                _send(conn, ("err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        conn.close()
