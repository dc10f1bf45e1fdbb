"""Memory-ledger smoke: attribution, conservation, OOM forensics, end to end
(``python -m accelerate_tpu_torch.telemetry.memledger_smoke`` on the card,
``--device cpu`` on the CPU).

The JAX package's ``telemetry/memledger_smoke.py``.  ``--devices N`` (JAX's
8-device mesh) starts ``N`` ranks on a ``dp=N`` mesh (8 gloo processes
under ``--device cpu --devices 8``; on the card one a card, or ranks sharing
card 0 over gloo), forked from the preloaded server: each holds its 16 rows
of a ``dp``-sharded ``(N * 16, 32)`` leaf and the replicated ones, as each
JAX device does, and the ledger charges each rank JAX's per-device bytes.
Asserts, through the public surfaces only:

1. **attribution** — registered trees charge the device their storage
   bytes (a ``dp``-sharded leaf its rank's rows, a replicated leaf its
   whole size), ``subset_of`` entries are ranked but excluded from
   conservation, and ``note_program_bytes`` feeds the program-estimate
   term; with several ranks the ranks' ``attributed_per_device()`` are
   gathered and every one is held to JAX's per-device bytes;
2. **conservation** — with an injected ``stats_fn``,
   ``attributed + program_estimate + unattributed == bytes_in_use`` holds
   exactly, a *negative* residual (stale registration) is exposed rather
   than clamped, and a device without allocator stats honestly reports
   ``stats_available: 0`` with no invented arithmetic;
3. **OOM forensics** — a synthetic out-of-memory error
   (``ACCELERATE_TPU_FAULT_OOM_ONCE=1``) thrown under
   ``find_executable_batch_size`` halves the batch AND lands a
   ``memory.oom_postmortem`` in the flight-recorder ring blaming the planted
   largest owner, which the telemetry report renders by name;
4. **export** — the Prometheus endpoint (127.0.0.1, an ephemeral port)
   scrapes the ``memory.*`` gauge family and ``GET /debug/memory`` returns
   the ranked-ledger JSON.

Attribution and conservation hold on every rank; the forensics and the
export run on rank 0, as JAX's one process runs them once.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import urllib.request
from typing import Optional


PER_DEVICE = 2048 + 256 + 16384  # JAX's per-device bytes: 16 rows, the (64,) leaf, the hog


def run(device: Optional[str] = None, devices: int = 1) -> dict:
    """The smoke on one process, or (``devices > 1``) on ``devices`` ranks of
    a ``dp`` mesh: the ranks' records, each rank held to JAX's per-device
    bytes."""
    from ..state import resolve_device

    if devices == 1:
        return _scenario(str(resolve_device(device)), 1)
    from ..parallel import launch

    dev = resolve_device(device)
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")
    records = launch.run_ranks("accelerate_tpu_torch.telemetry.memledger_smoke", dev, devices,
                               tempfile.mkdtemp(prefix="atpu_memledger_mesh_"), env=env)
    for rec in records:
        assert rec["per_device"] == {str(rec["index"]): PER_DEVICE}, rec
    assert [rec["postmortem"] for rec in records] == ["smoke.hog"] + [None] * (devices - 1)
    print(f"# memledger-smoke: {devices} ranks on dp={devices} ({records[0]['device']}), "
          f"each charged {PER_DEVICE} B as each JAX device is")
    print(MESH_VERDICT)
    return {"ranks": records}


def _scenario(device: str, world: int) -> dict:
    """Every check on this process; ``world > 1``: one rank of a
    ``dp=world`` mesh whose group it joined."""
    import torch

    from .. import telemetry
    from ..parallel import collectives
    from ..resilience import faultinject
    from ..utils.memory import find_executable_batch_size
    from . import flightrec, report
    from .export import MetricsExporter
    from .memledger import get_memory_ledger
    work = tempfile.mkdtemp(prefix="atpu_memledger_smoke_")
    tel = telemetry.enable(dir=work)
    flightrec.enable(dir=os.path.join(work, "flightrec"))
    ledger = get_memory_ledger()
    ledger.reset()
    dev = torch.device(device)
    index = dev.index if dev.index is not None else (
        torch.cuda.current_device() if dev.type == "cuda" else 0)

    # -- 1. attribution ------------------------------------------------------
    w = torch.zeros((world * 16, 32), dtype=torch.float32, device=dev)  # 2048 B a rank
    if world > 1:
        from ..accelerator import Accelerator
        from ..parallel.sharding import shard_params
        from ..utils.dataclasses import ParallelismConfig

        acc = Accelerator(device=device, parallelism_config=ParallelismConfig(dp=world))
        shard_params(w, acc.mesh, ("dp", None))  # this rank keeps its 16 rows
    b = torch.ones((64,), dtype=torch.float32, device=dev)  # 256 B
    ledger.register("smoke.params", tree={"w": w, "b": b})
    hog = torch.zeros((4096,), dtype=torch.float32, device=dev)  # 16384 B: the planted blame
    hog_token = ledger.register("smoke.hog", tree=hog)
    ledger.register("smoke.cache_resident", nbytes=512, subset_of="smoke.hog")
    ledger.note_program_bytes("smoke.step", 1000)

    att = ledger.attributed_per_device()
    expect = {index: PER_DEVICE}
    assert att == expect, (att, expect)
    for other in collectives.all_gather_object(att):
        assert list(other.values()) == [PER_DEVICE], other  # every rank, as JAX's expect
    ranked = ledger.owners()
    assert ranked[0].owner == "smoke.hog", [r.owner for r in ranked]
    print(f"# attribution: {att[index]} B on device {index}", file=sys.stderr)

    # -- 2. conservation with an injected allocator view ---------------------
    def stats_fn(d):
        return {
            "bytes_in_use": att.get(d, 0) + 1000 + 777,  # program + residual
            "peak_bytes_in_use": att.get(d, 0) + 5000,
            "bytes_limit": 1 << 20,
        }

    records = ledger.reconcile(stats_fn=stats_fn)
    assert len(records) >= 1, records
    for rec in records:
        if rec["device"] != index:
            continue
        assert rec["stats_available"] == 1
        assert (rec["attributed_bytes"] + rec["program_estimate_bytes"]
                + rec["unattributed_bytes"] == rec["bytes_in_use"]), rec
        assert rec["unattributed_bytes"] == 777, rec
        assert rec["headroom_bytes"] == (1 << 20) - rec["bytes_in_use"], rec
    # A stale registration (attribution above the allocator's count) must
    # surface as a NEGATIVE residual, not be clamped away.
    neg = [r for r in ledger.reconcile(stats_fn=lambda d: {"bytes_in_use": 10})
           if r["device"] == index][0]
    assert neg["unattributed_bytes"] < 0, neg
    # No allocator stats: no invented arithmetic.
    bare = [r for r in ledger.reconcile(stats_fn=lambda d: None) if r["device"] == index][0]
    assert bare["stats_available"] == 0 and "bytes_in_use" not in bare, bare
    ledger.reconcile(stats_fn=stats_fn)  # restore the synthetic watermark
    ledger.publish(tel.registry)
    snap = tel.registry.snapshot()
    assert snap["memory.attributed_bytes"] == max(att.values()), snap
    assert snap["memory.unattributed_bytes"] == 777, snap
    assert snap["memory.owner.smoke_hog_bytes"] == 16384, snap
    print("# conservation: residual 777 B, exactly", file=sys.stderr)
    rank = collectives.rank()
    if rank != 0:
        telemetry.disable()
        flightrec.disable()
        return {"rank": rank, "device": device, "index": index, "per_device": att,
                "postmortem": None}

    # -- 3. OOM forensics under fault injection ------------------------------
    os.environ[faultinject.ENV_OOM_ONCE] = "1"
    faultinject.reload()
    calls = []

    @find_executable_batch_size(starting_batch_size=8)
    def train(batch_size):
        calls.append(batch_size)
        faultinject.maybe_oom()
        return batch_size

    try:
        landed = train()
    finally:
        os.environ.pop(faultinject.ENV_OOM_ONCE, None)
        faultinject.reload()
    assert landed == 4 and calls == [8, 4], (landed, calls)
    assert ledger.oom_postmortems, "no postmortem recorded"
    pm = ledger.oom_postmortems[-1]
    assert pm["source"] == "find_executable_batch_size", pm
    assert pm["blame"] == "smoke.hog" and pm["blame_bytes"] == 16384, pm
    assert pm["batch_size"] == 8, pm
    ring = [
        r for r in flightrec.get_flight_recorder().snapshot()
        if r.get("kind") == "event" and r.get("name") == "memory.oom_postmortem"
    ]
    assert ring and ring[-1]["blame"] == "smoke.hog", ring
    fsum = report.summarize_flight(flightrec.get_flight_recorder().snapshot())
    text = report.format_flight_report(fsum)
    assert "memory postmortem" in text and "smoke.hog" in text, text
    mem_lines = "\n".join(report.format_memory_block(tel.registry.snapshot()))
    assert "smoke_hog" in mem_lines, mem_lines  # gauge slug of smoke.hog
    print("# forensics: postmortem blames smoke.hog, report renders it", file=sys.stderr)

    # -- 4. export: Prometheus scrape + /debug/memory ------------------------
    exporter = MetricsExporter().start(port=0)
    try:
        base = f"http://127.0.0.1:{exporter.port}"
        scrape = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
        for needle in ("accelerate_tpu_memory_attributed_bytes",
                       "accelerate_tpu_memory_owner_smoke_hog_bytes"):
            assert needle in scrape, f"{needle} missing from scrape"
        debug = json.loads(urllib.request.urlopen(base + "/debug/memory", timeout=10).read())
        assert debug["owners"][0]["owner"] == "smoke.hog", debug["owners"]
        assert debug["oom_postmortems"] >= 1, debug
    finally:
        exporter.stop(final_snapshot=False)

    # GC-path hygiene: a token-guarded unregister after a replacement keeps
    # the replacement (the engine finalizer contract).
    new_token = ledger.register("smoke.hog", nbytes=64)
    assert not ledger.unregister("smoke.hog", hog_token)
    assert ledger.unregister("smoke.hog", new_token)

    telemetry.disable()
    flightrec.disable()
    print(VERDICT)
    return {"rank": rank, "device": device, "index": index, "per_device": att,
            "attributed": att[index], "postmortem": pm["blame"], "calls": calls}


VERDICT = ("memledger-smoke OK — attribution exact, conservation residual 777 B by "
           "construction, negative residual exposed, OOM postmortem blamed smoke.hog "
           "through find_executable_batch_size, memory.* scraped and /debug/memory served")
MESH_VERDICT = ("memledger-smoke OK — every rank charged JAX's per-device bytes, "
                + VERDICT.split("— ", 1)[1])


def main(argv=None) -> int:
    from ..parallel import launch

    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.telemetry.memledger_smoke")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("--devices", type=int, default=1,
                        help="ranks of the dp mesh arm (JAX's is 8; default 1, one process)")
    parser.add_argument("--rank-child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank_child is not None:
        return launch.rank_child(lambda rank, world, device: _scenario(device, world),
                                 args.rank_child)
    run(args.device, args.devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
