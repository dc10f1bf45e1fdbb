"""Tasks for ``test_torch_fleet.py`` and ``test_torch_launch.py``: the fleet
primitives in every process of a :class:`torch_dp_world.World` (which
lends its group's default store), a ``main(argv)`` for processes forked by
``parallel.launch`` that join their own group (the kept ``FileStore`` or
``TCPStore``) and lose a rank, and a function for ``debug_launcher``.
Each returns plain values."""

from __future__ import annotations

import json
import os
import signal
import sys
import time

from accelerate_tpu_torch.resilience import fleet


def agree_twice(values):
    """Two agreements under one name (the call-count keys keep them
    apart), each of this rank's value and its square; the store path taken."""
    import torch.distributed as dist

    rank = dist.get_rank()
    first = fleet.agree("values", values[rank])
    second = fleet.agree("values", {"rank": rank, "sq": values[rank] ** 2})
    fleet.barrier("after_values")
    return {"client": fleet.fleet_client() is not None, "first": first, "second": second}


def absent_rank(primitive: str, absent: int, timeout_s: float):
    """Every rank but ``absent`` enters ``primitive`` (``barrier`` or
    ``agree``) with ``timeout_s``; each returns what it raised and how long
    it took.  The absent rank sleeps past the deadline, then all meet
    again so the next task starts in step."""
    import torch.distributed as dist

    rank = dist.get_rank()
    t0 = time.monotonic()
    error = None
    if rank == absent:
        time.sleep(timeout_s + 0.3)
    else:
        try:
            if primitive == "barrier":
                fleet.barrier(f"absent_{absent}", timeout_s=timeout_s)
            else:
                fleet.agree(f"absent_{absent}", rank, timeout_s=timeout_s)
        except fleet.FleetError as exc:
            error = type(exc).__name__
    took = time.monotonic() - t0
    # The absent rank never took the call: skip its key index too, so the
    # ranks' call counts stay in lockstep for later tasks.
    if rank == absent:
        fleet._next_key(primitive, f"absent_{absent}")
    dist.barrier()
    return {"rank": rank, "error": error, "took": took}


def drain_over_the_store(signalled: int, calls: int, timeout_s: float = 30.0):
    """A coordinated ``PreemptionGuard`` on every rank; rank ``signalled``
    SIGTERMs itself before call 2.  Each rank's ``should_stop`` answers in
    call order, and whether it agreed over the store."""
    from accelerate_tpu_torch.resilience.preemption import PreemptionGuard

    import torch.distributed as dist

    rank = dist.get_rank()
    guard = PreemptionGuard(coordinated=True, coordinate_every=1,
                            agree_timeout_s=timeout_s).install()
    answers = []
    try:
        for call in range(calls):
            if rank == signalled and call == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            answers.append(guard.should_stop())
    finally:
        guard.uninstall()
    dist.barrier()
    return {"answers": answers, "client": fleet.fleet_client() is not None,
            "local": guard.preempted_locally()}


def main(argv) -> int:
    """A forked rank (``parallel.launch.start``): ``[rank, world, init,
    timeout_s, out]``.  Joins the group over ``init``'s store (``tcp://``:
    as the launch command's ranks do, through ``PartialState``, whose
    ``TCPStore`` rank 0 hosts; ``file://``: ``join_group``), meets the
    others once, then rank 0 leaves (its process exits, taking a store it
    hosts with it) while the others run an agreement and a barrier that
    must raise ``FleetError`` within the deadline."""
    from accelerate_tpu_torch import PartialState
    from accelerate_tpu_torch.parallel.launch import join_group

    rank, world, init, timeout_s, out = json.loads(argv[0])
    if init.startswith("tcp://"):
        os.environ.update(ACCELERATE_COORDINATOR_ADDRESS=init[len("tcp://"):],
                          ACCELERATE_NUM_PROCESSES=str(world), ACCELERATE_PROCESS_ID=str(rank))
        PartialState(cpu=True)
    else:
        join_group(rank, world, init, "gloo", "cpu")
    kept = fleet._kept[1] is not None
    fleet.agree("up", rank, timeout_s=60.0)
    if rank == 0:
        time.sleep(0.5)  # the others have read every "up" value
        os._exit(0)
    time.sleep(1.0)
    record = {"rank": rank, "kept": kept}
    for primitive in ("agree", "barrier"):
        t0 = time.monotonic()
        try:
            if primitive == "agree":
                fleet.agree("after", rank, timeout_s=timeout_s)
            else:
                fleet.barrier("after", timeout_s=timeout_s)
            record[primitive] = None
        except fleet.FleetError as exc:
            record[primitive] = str(exc)[:200]
        record[f"{primitive}_s"] = time.monotonic() - t0
    with open(out, "w") as f:
        json.dump(record, f)
    sys.stdout.flush()
    os._exit(0)


def debug_worker(path: str) -> None:
    """A ``debug_launcher`` function: an ``Accelerator`` on the CPU, one
    reduction and one agreement; each rank writes what it saw."""
    import torch

    from accelerate_tpu_torch import Accelerator, AcceleratorState

    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator()
    total = acc.reduce(torch.tensor([float(acc.process_index + 1)]), "sum")
    seen = {"rank": acc.process_index, "world": acc.num_processes, "device": str(acc.device),
            "backend": acc.state.backend, "sum": float(total[0]),
            "agree": fleet.agree("debug", acc.process_index)}
    with open(os.path.join(path, f"rank{acc.process_index}.json"), "w") as f:
        json.dump(seen, f)
