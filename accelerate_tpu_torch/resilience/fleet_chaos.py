"""Multi-process fleet chaos campaign: the supervised runtime, proven under fire.

The JAX package's ``resilience/fleet_chaos.py`` in the port.  ``python -m
accelerate_tpu_torch.resilience.chaos --mode fleet`` (or this module) runs a
seeded campaign over a REAL 4-process gloo group (the ``dcn_dp`` mesh, one
rank a process, every rank on card 0 on the card or on the CPU under
``--device cpu``), each fleet launched and babysat by the
:class:`~accelerate_tpu_torch.launchers.FleetSupervisor`.  Its ranks are
forked from a server that imported torch once (``parallel.launch.fork``).
Arms, in order:

- **reference** — no faults; runs to completion, recording per-step state
  digests (the bit-identity oracle) and proving the live multi-process
  wiring: the fleet goodput gather publishes ``goodput.fleet_hosts ==
  world`` from a real cross-process gather.
- **sigkill** — one worker SIGKILLs itself mid-step.  The survivors are
  stuck in (or fail) their next collective; the supervisor must detect the
  child exit and tear the fleet down within the bounded grace window (no
  hang, ever) and write a fleet postmortem merging every rank's
  flight-recorder stream.
- **drain** — one rank receives a real SIGTERM mid-run; the
  ``PreemptionGuard`` agreement (routed over the group's store by
  ``resilience/fleet.py``) must spread the stop decision to every rank on
  the SAME step, land ONE final verified checkpoint all ranks agree on, and
  exit the whole fleet cleanly.
- **wedge** — one worker stalls forever without dying (heartbeat stall).
  Child-exit monitoring alone would hang; the supervisor must notice the
  stale step-loop heartbeat and kill the fleet within a bounded window.
- **elastic** — one worker SIGKILLs itself with ``elastic=True``: the
  supervisor relaunches at world size 3, the elastic resume lands the
  4-process checkpoint on the 3-process mesh, and the restarted fleet's
  post-load state digest must be BIT-IDENTICAL to the unkilled reference's
  digest at the resume step — then the reduced fleet runs to completion and
  leaves a manifest-complete final checkpoint.

The schedule (fault ranks and steps) is deterministic for a given
``--seed`` and is the JAX package's.  The recipe is ``chaos.build_recipe``'s
toy (``tanh(x @ w + b)`` under Adam, from a torch seed) and runs no kernel.

Run::

    python -m accelerate_tpu_torch.resilience.fleet_chaos --seed 0          # on the card
    python -m accelerate_tpu_torch.resilience.fleet_chaos --seed 0 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Optional

WORLD = 4
TOTAL_STEPS = 6
GLOBAL_BATCH = 12  # divisible by every world size the campaign visits (4, 3)
WEDGE_SLEEP_S = 3600.0
HEARTBEAT_TIMEOUT_S = 15.0
GRACE_S = 5.0
ARM_TIMEOUT_S = 240.0


def plan_fleet_campaign(seed: int, total_steps: int = TOTAL_STEPS) -> dict:
    """Deterministic seeded schedule: which rank dies / wedges / drains and
    at which step.  Fault steps stay in ``[2, total-2]`` so every arm has a
    pre-fault checkpoint to resume from and post-fault steps to complete."""
    import random

    rnd = random.Random(seed)
    lo, hi = 2, max(2, total_steps - 2)
    return {
        "seed": seed,
        "total_steps": total_steps,
        "sigkill": {"rank": rnd.randint(1, WORLD - 1), "step": rnd.randint(lo, hi)},
        "drain": {"rank": rnd.randint(0, WORLD - 1), "step": rnd.randint(lo, hi)},
        "wedge": {"rank": rnd.randint(1, WORLD - 1), "step": rnd.randint(lo, hi)},
        "elastic": {"rank": rnd.randint(1, WORLD - 1), "step": rnd.randint(lo, hi)},
    }


# ---------------------------------------------------------------------------
# Worker role (one rank of the fleet)
# ---------------------------------------------------------------------------


def _make_batch(acc, i: int) -> dict:
    """Step ``i``'s global batch (its values depend only on ``i``), this
    process's rows of it on the accelerator's device — identical content at
    every world size, so per-step math matches the reference up to the
    reduction's association (and bit-exactly at the same world size)."""
    import torch

    from ..parallel.mesh import data_degree, data_index

    x = torch.randn(GLOBAL_BATCH, 64, generator=torch.Generator().manual_seed(300 + i))
    y = torch.randn(GLOBAL_BATCH, 32, generator=torch.Generator().manual_seed(400 + i))
    n, k = data_degree(acc.mesh), data_index(acc.mesh)
    per = GLOBAL_BATCH // n
    return {"x": x[k * per:(k + 1) * per].to(acc.device),
            "y": y[k * per:(k + 1) * per].to(acc.device)}


def run_worker(ckpt_root: str, out_dir: str, total: int, device=None) -> int:
    """One rank: join the group (``PartialState`` over the supervisor's env
    contract), resume if a checkpoint exists, train with per-step verified
    saves, die on the fault schedule armed through the env.  Writes
    ``worker_r<rank>_a<attempt>.json``, which the campaign parent asserts
    over."""
    import signal as _signal

    from .chaos import build_recipe
    from .elastic import state_digest

    acc, model, opt = build_recipe(ckpt_root, total_limit=None, device=device)
    rank = acc.process_index
    world = acc.num_processes
    attempt = int(os.environ.get("ACCELERATE_FLEET_ATTEMPT", "0"))
    # Every process is one member of the fleet: the dcn_dp axis (nothing
    # to split once an elastic relaunch is down to one process).
    mesh_axes = {a: s for a, s in acc.mesh.shape.items() if s > 1}
    if mesh_axes != ({"dcn_dp": world} if world > 1 else {}):
        raise RuntimeError(f"expected the dcn_dp={world} mesh, got {mesh_axes}")
    step_fn = acc.make_train_step(model, opt, clip_norm=0.05)

    # Faults arm on attempt 0 only: after an elastic relaunch the same rank
    # index exists again and must NOT re-fire the schedule.
    fault_armed = attempt == int(os.environ.get("FLEET_CHAOS_FAULT_ATTEMPT", "0"))
    sigkill_rank = int(os.environ.get("FLEET_CHAOS_SIGKILL_RANK", "-1")) if fault_armed else -1
    sigkill_step = int(os.environ.get("FLEET_CHAOS_SIGKILL_STEP", "-1"))
    wedge_rank = int(os.environ.get("FLEET_CHAOS_WEDGE_RANK", "-1")) if fault_armed else -1
    wedge_step = int(os.environ.get("FLEET_CHAOS_WEDGE_STEP", "-1"))

    start = 0
    resumed = acc.resume_from_latest()
    loaded_digest = None
    resharded = False
    if resumed is not None:
        start = resumed
        loaded_digest = state_digest(acc)
        info = acc.last_resume_info
        resharded = bool(info is not None and info.resharded)

    losses: dict = {}
    digests: dict = {}
    agreed_step: Optional[int] = None
    death = "completed"
    for i in range(start, total):
        step = i + 1
        if rank == sigkill_rank and step == sigkill_step:
            os.kill(os.getpid(), _signal.SIGKILL)
        if rank == wedge_rank and step == wedge_step:
            # Wedge without dying: stop taking part (and stop beating the
            # heartbeat) — the rest of the fleet hangs in this step's
            # collective and only the supervisor can save them.
            time.sleep(WEDGE_SLEEP_S)
        loss = float(step_fn(_make_batch(acc, i)))
        losses[str(step)] = loss
        acc.save_state(step=step)
        digests[str(step)] = state_digest(acc)
        if acc.check_preemption(step=step):
            agreed_step = step
            death = "sigterm"
            break

    record = {
        "rank": rank,
        "world": world,
        "attempt": attempt,
        "resumed_at": resumed,
        "loaded_digest": loaded_digest,
        "resharded": resharded,
        "losses": losses,
        "digests": digests,
        "agreed_step": agreed_step,
        "death": death,
        "last_step": start + len(losses),
    }
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"worker_r{rank}_a{attempt}.json")
    with open(out_path, "w") as f:
        json.dump(record, f)
    return 0


# ---------------------------------------------------------------------------
# Orchestration (campaign parent)
# ---------------------------------------------------------------------------


def _worker_env(telemetry_dir: str, extra: Optional[dict] = None) -> dict:
    """Env for one fleet worker: per-step telemetry and flight-recorder
    streams flushed eagerly (a SIGKILLed rank's last events must already be
    on disk for the postmortem), unsynced saves with a shrunken I/O retry
    policy, tight coordination cadences so single-digit-step runs exercise
    the gathers, one thread a rank."""
    env = dict(os.environ)
    for key in (
        "ACCELERATE_PARALLELISM_DP",
        "ACCELERATE_PARALLELISM_FSDP",
        "ACCELERATE_PARALLELISM_DCN_DP",
        "ACCELERATE_USE_FSDP",
        "ACCELERATE_TPU_ZERO",
        "ACCELERATE_TPU_FAULT_SIGTERM_STEP",
        "ACCELERATE_TPU_FAULT_NAN_STEP",
        "ACCELERATE_TPU_METRICS_PORT",
        "ACCELERATE_TPU_METRICS_SNAPSHOT",
    ):
        env.pop(key, None)
    env.update(
        {
            "ACCELERATE_TPU_CHECKPOINT_FSYNC": "0",
            "ACCELERATE_TPU_IO_RETRIES": "2",
            "ACCELERATE_TPU_IO_RETRY_BASE_S": "0.01",
            "ACCELERATE_TPU_SENTINEL_PROFILE": "0",
            "ACCELERATE_TPU_TELEMETRY": "1",
            "ACCELERATE_TPU_TELEMETRY_DIR": telemetry_dir,
            "ACCELERATE_TPU_FLIGHTREC": "1",
            "ACCELERATE_TPU_FLIGHTREC_DIR": telemetry_dir,
            "ACCELERATE_TPU_FLIGHTREC_FLUSH_EVERY": "1",
            "ACCELERATE_TPU_PREEMPT_EVERY": "1",
            "ACCELERATE_TPU_FLEET_EVERY": "2",
            "ACCELERATE_TPU_GOODPUT": "1",
            "OMP_NUM_THREADS": env.get("OMP_NUM_THREADS", "1"),
        }
    )
    env.update(extra or {})
    return env


def _launch_fleet(
    workdir: str,
    arm: str,
    total: int,
    *,
    world: Optional[int] = None,
    rank_env: Optional[dict] = None,
    shared_env: Optional[dict] = None,
    elastic: bool = False,
    min_processes: int = 1,
    ckpt_root: Optional[str] = None,
    device=None,
) -> dict:
    """Run one supervised fleet arm; returns ``{result, records, dirs...}``.
    ``rank_env`` maps rank -> extra env (fault arming for that rank only)."""
    from ..launchers import FleetSupervisor
    from ..parallel import launch

    arm_dir = os.path.join(workdir, arm)
    telemetry_dir = os.path.join(arm_dir, "telemetry")
    out_dir = os.path.join(arm_dir, "out")
    ckpt_root = ckpt_root or os.path.join(arm_dir, "ckpt")
    for d in (arm_dir, telemetry_dir, out_dir, ckpt_root):
        os.makedirs(d, exist_ok=True)
    log_path = os.path.join(arm_dir, "workers.log")
    open(log_path, "ab").close()

    def spawn(rank, world_size, overrides):
        extra = dict(shared_env or {})
        extra.update((rank_env or {}).get(rank, {}))
        env = _worker_env(telemetry_dir, extra)
        env.update(overrides)
        env["ACCELERATE_PARALLELISM_DCN_DP"] = str(world_size)
        argv = ["--role", "worker", "--ckpt-root", ckpt_root, "--out-dir", out_dir,
                "--total", str(total)] + (["--device", device] if device else [])
        return launch.fork("accelerate_tpu_torch.resilience.fleet_chaos", argv, env,
                           stdout=log_path, stderr=log_path)

    supervisor = FleetSupervisor(
        spawn,
        world or WORLD,
        workdir=arm_dir,
        heartbeat_timeout_s=HEARTBEAT_TIMEOUT_S,
        grace_s=GRACE_S,
        poll_s=0.1,
        elastic=elastic,
        min_processes=min_processes,
        telemetry_dir=telemetry_dir,
    )
    t0 = time.monotonic()
    result = supervisor.run()
    duration = time.monotonic() - t0
    assert duration < ARM_TIMEOUT_S, (
        f"fleet arm {arm!r} took {duration:.0f}s (bound {ARM_TIMEOUT_S}s) — "
        "the supervisor failed to bound the failure"
    )
    records: dict = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("worker_r") and name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                records[name[: -len(".json")]] = json.load(f)
    return {
        "result": result,
        "records": records,
        "telemetry_dir": telemetry_dir,
        "ckpt_root": ckpt_root,
        "arm_dir": arm_dir,
        "duration_s": duration,
        "log": log_path,
    }


def _dump_worker_log(arm: dict):
    try:
        with open(arm["log"]) as f:
            sys.stderr.write(f.read()[-8000:])
    except OSError:
        pass


def _assert_final_checkpoint(ckpt_root: str, step: int) -> None:
    from .manifest import find_latest_complete, verify_checkpoint

    final = find_latest_complete(os.path.join(ckpt_root, "checkpoints"))
    assert final is not None, f"no complete checkpoint under {ckpt_root}"
    manifest = verify_checkpoint(final)  # raises on torn/corrupt
    assert manifest["step"] == step, (manifest["step"], step)


def _reference_arm(work: str, total: int, device) -> tuple:
    """Arm 0: the unkilled reference (and the live multi-process wiring
    proof); its summary entry and rank 0's per-step digests."""
    print(f"# fleet-chaos: reference fleet ({WORLD} procs, {total} steps)", file=sys.stderr)
    ref = _launch_fleet(work, "reference", total, device=device)
    if ref["result"]["verdict"] != "completed":
        _dump_worker_log(ref)
    assert ref["result"]["verdict"] == "completed", ref["result"]
    assert len(ref["records"]) == WORLD, sorted(ref["records"])
    ref_rank0 = ref["records"]["worker_r0_a0"]
    assert ref_rank0["death"] == "completed" and ref_rank0["last_step"] == total, ref_rank0
    ref_digests = ref_rank0["digests"]
    # Every rank computed the same (replicated) state: digests agree.
    for name, rec in ref["records"].items():
        assert rec["digests"] == ref_digests, f"{name} digests diverge from rank 0"
    # The dormant halves are live: the fleet goodput gather ran across real
    # processes and published the host count into the final snapshot.
    from ..telemetry.report import load_records

    ref_records = load_records(ref["telemetry_dir"])
    snapshots = [r["snapshot"] for r in ref_records if r.get("kind") == "metrics"]
    assert any(
        s.get("goodput.fleet_hosts") == WORLD for s in snapshots if s
    ), "goodput.fleet_hosts gauge missing — fleet aggregation never gathered"
    _assert_final_checkpoint(ref["ckpt_root"], total)
    return {"duration_s": ref["duration_s"]}, ref_digests


def _sigkill_arm(work: str, total: int, kr: int, ks: int, device) -> dict:
    """Arm 1: SIGKILL one worker mid-step; the fleet reaped and postmortemed."""
    print(f"# fleet-chaos: SIGKILL rank {kr} at step {ks}", file=sys.stderr)
    kill = _launch_fleet(
        work, "sigkill", total,
        rank_env={kr: {
            "FLEET_CHAOS_SIGKILL_RANK": str(kr),
            "FLEET_CHAOS_SIGKILL_STEP": str(ks),
        }},
        device=device,
    )
    res = kill["result"]
    if res["verdict"] != "worker_dead":
        _dump_worker_log(kill)
    assert res["verdict"] == "worker_dead", res
    last = res["attempts"][-1]
    assert last["dead_rank"] == kr and last["exit_code"] == -9, last
    assert last["teardown_s"] <= GRACE_S + 15.0, last
    # The postmortem merged every rank's streams, dead rank included (its
    # flight recorder flushes every event, so the kill can't erase it).
    assert res["postmortem"] and os.path.exists(res["postmortem"]), res
    with open(res["postmortem"]) as f:
        postmortem = json.load(f)
    assert postmortem["cause"] == "worker_dead" and postmortem["dead_rank"] == kr
    assert postmortem["fleet"]["n_ranks"] == WORLD, postmortem["fleet"]["n_ranks"]
    assert str(kr) in postmortem["fleet"]["ranks"]
    return {
        "dead_rank": kr, "teardown_s": last["teardown_s"],
        "duration_s": kill["duration_s"], "postmortem": res["postmortem"],
    }


def _elastic_arm(work: str, total: int, er: int, es: int, ref_digests: dict, device) -> dict:
    """Arm 4: SIGKILL one worker with ``elastic=True``; the world-3 fleet
    resumes bit-identical to the reference and completes."""
    print(f"# fleet-chaos: SIGKILL rank {er} at step {es} with --elastic "
          f"({WORLD}->{WORLD - 1})", file=sys.stderr)
    elastic = _launch_fleet(
        work, "elastic", total,
        rank_env={er: {
            "FLEET_CHAOS_SIGKILL_RANK": str(er),
            "FLEET_CHAOS_SIGKILL_STEP": str(es),
        }},
        elastic=True,
        min_processes=WORLD - 1,
        device=device,
    )
    res = elastic["result"]
    if res["verdict"] != "completed":
        _dump_worker_log(elastic)
    assert res["verdict"] == "completed", res
    assert res["world_size"] == WORLD - 1, res
    assert len(res["attempts"]) == 2, res
    assert res["attempts"][0]["verdict"] == "worker_dead"
    assert res["attempts"][0]["dead_rank"] == er
    resumed_recs = [rec for rec in elastic["records"].values() if rec["attempt"] == 1]
    assert len(resumed_recs) == WORLD - 1, sorted(elastic["records"])
    resume_step = es - 1  # the kill fires before step `es` trains
    for rec in resumed_recs:
        assert rec["world"] == WORLD - 1, rec
        assert rec["resumed_at"] == resume_step, (rec["resumed_at"], resume_step)
        assert rec["resharded"], rec
        # THE oracle: the restarted fleet's loaded state is bit-identical to
        # the unkilled reference at the resume step.
        assert rec["loaded_digest"] == ref_digests[str(resume_step)], (
            f"elastic resume digest {rec['loaded_digest'][:16]} != reference "
            f"{ref_digests[str(resume_step)][:16]} at step {resume_step}"
        )
        assert rec["death"] == "completed" and rec["last_step"] == total, rec
    _assert_final_checkpoint(elastic["ckpt_root"], total)
    return {
        "dead_rank": er, "resume_step": resume_step,
        "final_world": res["world_size"], "duration_s": elastic["duration_s"],
        "teardown_s": res["attempts"][0]["teardown_s"],
    }


def run_fleet_campaign(seed: int, workdir: Optional[str] = None, device=None) -> dict:
    """All five arms; asserts every oracle, returns a summary dict.
    ``device`` None is the card (every rank on card 0), ``"cpu"`` the
    CPU."""
    plan = plan_fleet_campaign(seed)
    total = plan["total_steps"]
    work = workdir or tempfile.mkdtemp(prefix="atpu_fleet_chaos_")
    os.makedirs(work, exist_ok=True)
    summary: dict = {"seed": seed, "plan": plan, "arms": {}}
    t0 = time.monotonic()

    summary["arms"]["reference"], ref_digests = _reference_arm(work, total, device)
    summary["arms"]["sigkill"] = _sigkill_arm(work, total, plan["sigkill"]["rank"],
                                              plan["sigkill"]["step"], device)

    # -- arm 2: coordinated SIGTERM drain ------------------------------------
    dr, ds = plan["drain"]["rank"], plan["drain"]["step"]
    print(f"# fleet-chaos: SIGTERM rank {dr} at step {ds} (coordinated drain)", file=sys.stderr)
    drain = _launch_fleet(
        work, "drain", total,
        rank_env={dr: {"ACCELERATE_TPU_FAULT_SIGTERM_STEP": str(ds)}},
        device=device,
    )
    if drain["result"]["verdict"] != "completed":
        _dump_worker_log(drain)
    assert drain["result"]["verdict"] == "completed", drain["result"]
    assert len(drain["records"]) == WORLD, sorted(drain["records"])
    agreed = {rec["agreed_step"] for rec in drain["records"].values()}
    assert len(agreed) == 1 and None not in agreed, (
        f"drain did not converge: per-rank agreed steps {agreed}"
    )
    agreed_step = agreed.pop()
    assert agreed_step >= ds, (agreed_step, ds)
    for rec in drain["records"].values():
        assert rec["death"] == "sigterm", rec
    _assert_final_checkpoint(drain["ckpt_root"], agreed_step)
    summary["arms"]["drain"] = {
        "signaled_rank": dr, "agreed_step": agreed_step,
        "duration_s": drain["duration_s"],
    }

    # -- arm 3: wedge (heartbeat stall, no child exit) -----------------------
    wr, ws = plan["wedge"]["rank"], plan["wedge"]["step"]
    print(f"# fleet-chaos: wedge rank {wr} at step {ws} (heartbeat stall)", file=sys.stderr)
    wedge = _launch_fleet(
        work, "wedge", total,
        rank_env={wr: {
            "FLEET_CHAOS_WEDGE_RANK": str(wr),
            "FLEET_CHAOS_WEDGE_STEP": str(ws),
        }},
        device=device,
    )
    res = wedge["result"]
    if res["verdict"] != "wedged":
        _dump_worker_log(wedge)
    assert res["verdict"] == "wedged", res
    last = res["attempts"][-1]
    assert last["wedged_rank"] is not None, last
    assert res["postmortem"] and os.path.exists(res["postmortem"]), res
    # Everyone is dead — no leaked fleet.
    assert all(code is not None for code in last["exit_codes"].values()), last
    summary["arms"]["wedge"] = {
        "wedged_rank": last["wedged_rank"], "duration_s": wedge["duration_s"],
        "teardown_s": last["teardown_s"],
    }

    summary["arms"]["elastic"] = _elastic_arm(work, total, plan["elastic"]["rank"],
                                              plan["elastic"]["step"], ref_digests, device)
    summary["campaign_s"] = time.monotonic() - t0
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m accelerate_tpu_torch.resilience.fleet_chaos")
    parser.add_argument("--role", choices=("worker",), default=None)
    parser.add_argument("--ckpt-root", default=None)
    parser.add_argument("--out-dir", default=None)
    parser.add_argument("--total", type=int, default=TOTAL_STEPS)
    parser.add_argument("--seed", type=int, default=20260807)
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("--json", default=None, help="write the summary here as JSON")
    args = parser.parse_args(argv)

    if args.role == "worker":
        return run_worker(args.ckpt_root, args.out_dir, args.total, args.device)

    summary = run_fleet_campaign(args.seed, workdir=args.workdir, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f)
    arms = summary["arms"]
    print(
        f"fleet-chaos-smoke OK — seed {summary['seed']}: {WORLD}-process fleet survived "
        f"SIGKILL (rank {arms['sigkill']['dead_rank']} dead, survivors reaped in "
        f"{arms['sigkill']['teardown_s']:.1f}s, postmortem written), coordinated "
        f"SIGTERM drain agreed on step {arms['drain']['agreed_step']} with one "
        f"verified checkpoint, wedge detected via heartbeat stall "
        f"(rank {arms['wedge']['wedged_rank']}), and elastic {WORLD}->{WORLD - 1} restart "
        f"resumed bit-identical to the reference at step {arms['elastic']['resume_step']}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
