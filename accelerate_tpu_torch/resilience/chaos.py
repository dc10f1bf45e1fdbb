"""Chaos campaign: seeded kill→resume cycles that change the mesh between lives.

The JAX package's training campaign (``resilience/chaos.py``) in the port.
A campaign is a seeded schedule of **lives**: each life is a fresh world of
processes (a life on a topology of ``devices: n`` is ``n`` ranks in one
gloo group, one process each) that builds its mesh (which may DIFFER from
the previous life's), resumes from the newest manifest-complete checkpoint,
trains, and dies from a scheduled fault drawn from the
:mod:`.faultinject` knobs:

- ``sigterm`` — a real SIGTERM mid-run; the ``PreemptionGuard`` writes one
  final verified checkpoint at the step boundary and the life exits cleanly;
- ``torn_write`` — every checkpoint write fails from step K on (a dead
  filesystem); the save exhausts its retries on the main process, every
  rank learns of it, the staging directory stays ``.tmp``, and nothing torn
  is ever published;
- ``oom`` — a synthetic out-of-memory error kills the life between steps;
- ``nan`` — the gradients of one step are poisoned with NaN; the update's
  health gate skips it (parameters bit-unchanged) and the life carries on.

The parent asserts, across the whole campaign, the JAX package's five
properties:

1. **zero torn publishes** — every published checkpoint directory is
   manifest-complete;
2. **bit-identical handoff** — each resumed life's post-load state digest
   (parameters and optimizer state, gathered to full shapes:
   :func:`~.elastic.state_digest`) equals the digest the previous life
   recorded at its last successful save, across topology changes (dp=8 →
   dp=4, dp → dp×fsdp, ZeRO on↔off);
3. **same-topology bit-exactness** — lives on the reference topology
   reproduce the unkilled reference run's losses bit for bit;
4. **cross-topology tolerance** — lives on other meshes track the
   reference losses within ``CROSS_TOL`` (the global batch is fixed; only
   the reduction association changes) and stay finite;
5. the final life completes the full step budget and leaves a verified,
   manifest-complete checkpoint with its topology record;

and that each life's goodput ledger (rank 0's telemetry, replayed)
conserves wall time and attributes its fault to its category.  The
schedule is :func:`plan_campaign`'s, the JAX package's for every seed.

Run::

    python -m accelerate_tpu_torch.resilience.chaos --seed 0          # on the card
    python -m accelerate_tpu_torch.resilience.chaos --seed 0 --device cpu
    python -m accelerate_tpu_torch.resilience.chaos --mode fleet --device cpu   # fleet_chaos.py

On the card every rank of a life shares card 0 over gloo.  The recipe is the
JAX campaign's toy (a ``tanh(x @ w + b)`` layer under Adam) and runs no
kernel.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import asdict, dataclass
from typing import Optional

TOTAL_STEPS = 10
CHILD_TIMEOUT_S = 600.0

# The meshes a life can wake up on: its number of ranks and the env its
# processes read (mesh axes, ZeRO, the FSDP plugin), as the JAX package's.
TOPOLOGIES = {
    "dp8-zero": {
        "devices": 8,
        "env": {"ACCELERATE_PARALLELISM_DP": "8", "ACCELERATE_TPU_ZERO": "1"},
    },
    "dp8": {  # same mesh as the base, ZeRO off (layout-only migration)
        "devices": 8,
        "env": {"ACCELERATE_PARALLELISM_DP": "8", "ACCELERATE_TPU_ZERO": "0"},
    },
    "dp4": {
        "devices": 4,
        "env": {"ACCELERATE_PARALLELISM_DP": "4", "ACCELERATE_TPU_ZERO": "0"},
    },
    "dp2-fsdp2": {
        "devices": 4,
        "env": {
            "ACCELERATE_PARALLELISM_DP": "2",
            "ACCELERATE_PARALLELISM_FSDP": "2",
            "ACCELERATE_USE_FSDP": "true",
            # The consolidated (manifest-verified) save path, as in the JAX
            # campaign.
            "FSDP_STATE_DICT_TYPE": "FULL_STATE_DICT",
            "ACCELERATE_TPU_ZERO": "0",
        },
    },
    "dp2-zero": {
        "devices": 2,
        "env": {"ACCELERATE_PARALLELISM_DP": "2", "ACCELERATE_TPU_ZERO": "1"},
    },
}

BASE_TOPOLOGY = "dp8-zero"
FAULTS = ("sigterm", "torn_write", "oom", "nan")

# |loss - ref| <= CROSS_TOL * max(1, |ref|) for cross-topology lives.
CROSS_TOL = 1e-3


@dataclass
class Cycle:
    """One planned life of the campaign."""

    life: int
    topology: str
    fault: Optional[str]  # None = runs to completion
    fault_step: Optional[int]
    expect_resume: int  # step the NEXT life should land on


def plan_campaign(seed: int, total_steps: int = TOTAL_STEPS) -> list:
    """The JAX package's seeded schedule: lives 0 and 1 run the base
    topology (the same-topology bit-exact pair), later lives draw CHANGED
    meshes (at least two distinct changes), faults are drawn seeded with
    ``nan`` riding the final, completing life (a skipped update forks the
    trajectory, so it must not sit upstream of the bit-exactness oracle)."""
    import random

    rnd = random.Random(seed)
    cycles: list = []

    k0 = rnd.randint(2, 3)
    cycles.append(Cycle(0, BASE_TOPOLOGY, "sigterm", k0, expect_resume=k0))

    mid_faults = ["torn_write", "oom"]
    rnd.shuffle(mid_faults)
    k1 = cycles[-1].expect_resume + rnd.randint(2, 3)
    cycles.append(Cycle(1, BASE_TOPOLOGY, mid_faults[0], k1, expect_resume=k1 - 1))

    # Only MESH-changing topologies for the later lives ("dp8" shares the
    # base mesh; it exists for the elastic smoke's layout-only arm).
    others = ["dp4", "dp2-fsdp2", "dp2-zero"]
    rnd.shuffle(others)
    k2 = min(cycles[-1].expect_resume + rnd.randint(2, 3), total_steps - 2)
    cycles.append(Cycle(2, others[0], mid_faults[1], k2, expect_resume=k2 - 1))

    k3 = min(cycles[-1].expect_resume + rnd.randint(1, 2), total_steps - 1)
    cycles.append(Cycle(3, others[1], "nan", k3, expect_resume=total_steps))
    return cycles


# ---------------------------------------------------------------------------
# The life (each rank's role) — shared with elastic_smoke
# ---------------------------------------------------------------------------


def build_recipe(ckpt_root: str, total_limit: Optional[int] = 3, device=None):
    """The training recipe every life (and the reference run) shares: the
    JAX campaign's two-leaf model (``tanh(x @ w + b)``, ``w`` 64 x 32 and
    ``b`` 32 from a torch seed) as a ``FunctionalModel`` under Adam(1e-2),
    through ``prepare`` (the mesh, ZeRO and the FSDP plugin from the env),
    automatic checkpoint naming under ``ckpt_root``, preemption handling
    installed.  The global batch is 16 examples on every mesh."""
    import torch

    from ..accelerator import Accelerator, FunctionalModel
    from ..state import AcceleratorState
    from ..utils import ProjectConfiguration

    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator(device=device, project_config=ProjectConfiguration(
        project_dir=ckpt_root, automatic_checkpoint_naming=True, total_limit=total_limit))
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(64, 32, generator=g) * 0.1,
              "b": torch.randn(32, generator=g) * 0.1}

    def apply_fn(p, x, y):
        pred = torch.tanh(x @ p["w"] + p["b"])
        return {"loss": ((pred - y) ** 2).mean()}

    model = FunctionalModel(apply_fn, params)
    model, opt = acc.prepare(model, torch.optim.Adam(model.parameters(), lr=1e-2))
    acc.enable_preemption_handling()
    return acc, model, opt


def make_batch(acc, i: int) -> dict:
    """Step ``i``'s global batch (its values depend only on ``i``), this
    process's rows of it on the accelerator's device."""
    import torch

    from ..parallel.mesh import data_degree, data_index

    g = torch.Generator().manual_seed(1000 + i)
    x = torch.randn(16, 64, generator=g)
    y = torch.randn(16, 32, generator=g)
    n, k = data_degree(acc.mesh), data_index(acc.mesh)
    per = 16 // n
    return {"x": x[k * per:(k + 1) * per].to(acc.device),
            "y": y[k * per:(k + 1) * per].to(acc.device)}


def run_life(ckpt_root: str, out_path: str, total: int, fault: Optional[str],
             fault_step: Optional[int], save_every: bool = True, device=None,
             clock: Optional[dict] = None, after: Optional[str] = None) -> int:
    """One life on this rank: resume (if a checkpoint exists), train, die on
    schedule.  Rank 0 writes the JSON record the campaign parent asserts
    over.  The ``sigterm`` and ``nan`` faults arrive armed through the
    environment; ``torn_write`` and ``oom`` are armed here at the scheduled
    step."""
    import torch

    from . import faultinject
    from .elastic import state_digest

    clock = dict(clock or {})
    acc, model, opt = build_recipe(ckpt_root, device=device)
    clock["built"] = time.time()
    if fault == "nan":
        # A skip budget no single poisoned step escalates to a rewind.
        acc.enable_health_guard(optimizer=opt, max_skips=total)
    step_fn = acc.make_train_step(model, opt, clip_norm=0.05)
    if after is not None:
        from ..parallel.launch import wait_for_file

        wait_for_file(after, CHILD_TIMEOUT_S)
    clock["go"] = time.time()

    start = 0
    resumed = acc.resume_from_latest()
    loaded_digest = None
    resharded = False
    if resumed is not None:
        start = resumed
        loaded_digest = state_digest(acc)
        info = acc.last_resume_info
        resharded = bool(info is not None and info.resharded)
        print(f"# life resumed at step {start} (resharded={resharded})", file=sys.stderr)
    clock["resumed"] = time.time()

    losses: dict = {}
    digests: dict = {}
    skipped: list = []
    death = "completed"
    for i in range(start, total):
        step = i + 1
        if fault == "oom" and fault_step is not None and step == fault_step:
            # The synthetic out-of-memory error rides the retry machinery, so
            # the goodput ledger attributes it to device_acquire.
            try:
                faultinject.synthetic_oom_acquire("chaos.device_acquire")
            except torch.OutOfMemoryError as e:
                assert "out of memory" in str(e)
                death = "oom"
                break
        if fault == "torn_write" and fault_step is not None and step == fault_step:
            os.environ["ACCELERATE_TPU_FAULT_WRITE_N"] = "1"
            os.environ["ACCELERATE_TPU_FAULT_WRITE_STICKY"] = "1"
            faultinject.reload()
        loss = float(step_fn(make_batch(acc, i)))
        losses[str(step)] = loss
        verdict = acc.check_health(step=step)
        if verdict.skipped:
            skipped.append(step)
        if save_every:
            try:
                acc.save_state(step=step)
            except Exception as e:
                print(f"# life save failed at step {step}: {e}", file=sys.stderr)
                death = "save_failed"
                break
            digests[str(step)] = state_digest(acc)
        if acc.check_preemption(step=step):
            death = "sigterm"
            break

    record = {"resumed_at": resumed, "loaded_digest": loaded_digest, "resharded": resharded,
              "losses": losses, "digests": digests, "skipped_steps": skipped, "death": death,
              "last_step": start + len(losses), "world": acc.num_processes,
              "mesh": {a: s for a, s in acc.mesh.shape.items() if s > 1},
              "clock": dict(clock, done=time.time())}
    if acc.is_main_process:
        with open(out_path, "w") as f:
            json.dump(record, f)
    return 0


# ---------------------------------------------------------------------------
# Orchestration (parent)
# ---------------------------------------------------------------------------


def child_env(topology: str, extra: Optional[dict] = None) -> dict:
    """The environment of a life's processes on ``topology``: its mesh
    axes, ZeRO and FSDP plugin, a shrunken I/O retry policy and no fsync,
    as the JAX package's (the earlier fault and telemetry arming dropped),
    and the preemption agreement at every step."""
    spec = TOPOLOGIES[topology]
    env = dict(os.environ)
    for key in (
        "ACCELERATE_PARALLELISM_DP",
        "ACCELERATE_PARALLELISM_FSDP",
        "ACCELERATE_USE_FSDP",
        "FSDP_STATE_DICT_TYPE",
        "ACCELERATE_TPU_ZERO",
        "ACCELERATE_TPU_FAULT_SIGTERM_STEP",
        "ACCELERATE_TPU_FAULT_NAN_STEP",
        "ACCELERATE_TPU_TELEMETRY",
        "ACCELERATE_TPU_TELEMETRY_DIR",
        "ACCELERATE_TPU_GOODPUT",
        "ACCELERATE_TPU_METRICS_PORT",
        "ACCELERATE_TPU_METRICS_SNAPSHOT",
    ):
        env.pop(key, None)
    env.update({
        "ACCELERATE_TPU_CHECKPOINT_FSYNC": "0",
        "ACCELERATE_TPU_IO_RETRIES": "2",
        "ACCELERATE_TPU_IO_RETRY_BASE_S": "0.01",
        "ACCELERATE_TPU_SENTINEL_PROFILE": "0",
        # The ranks agree on a preemption at every step boundary (a life is
        # a few steps long; the guard's default polls every 10th).
        "ACCELERATE_TPU_PREEMPT_EVERY": "1",
        "OMP_NUM_THREADS": env.get("OMP_NUM_THREADS", "1"),
    })
    env.update(spec["env"])
    env.update(extra or {})
    return env


def spawn_life(ckpt_root: str, out_path: str, topology: str, total: int,
               fault: Optional[str] = None, fault_step: Optional[int] = None,
               save_every: bool = True, telemetry_dir: Optional[str] = None,
               device=None) -> dict:
    """Start a life's ranks (``TOPOLOGIES[topology]["devices"]`` processes
    in one gloo group, through :mod:`..parallel.launch`), wait for them
    under ``CHILD_TIMEOUT_S`` and return rank 0's record.  ``device`` None
    is the card (every rank on card 0), ``"cpu"`` the CPU."""
    return collect_life(start_life(ckpt_root, out_path, topology, total, fault, fault_step,
                                   save_every, telemetry_dir, device))


def start_life(ckpt_root: str, out_path: str, topology: str, total: int,
               fault: Optional[str] = None, fault_step: Optional[int] = None,
               save_every: bool = True, telemetry_dir: Optional[str] = None,
               device=None, after: Optional[str] = None) -> dict:
    """Start a life's ranks without waiting (see :func:`spawn_life`);
    ``after``: the go file the ranks wait for once built (an earlier life
    may still run meanwhile).  A handle for :func:`collect_life`."""
    from ..parallel import launch
    from ..state import resolve_device

    dev = resolve_device(device)
    world = TOPOLOGIES[topology]["devices"]
    extra = {}
    if fault == "sigterm" and fault_step is not None:
        extra["ACCELERATE_TPU_FAULT_SIGTERM_STEP"] = str(fault_step)
    if fault == "nan" and fault_step is not None:
        extra["ACCELERATE_TPU_FAULT_NAN_STEP"] = str(fault_step)
    if telemetry_dir is not None:
        # Each rank narrates itself into its own JSONL stream; the parent
        # replays rank 0's through the goodput ledger.
        extra["ACCELERATE_TPU_TELEMETRY"] = "1"
        extra["ACCELERATE_TPU_TELEMETRY_DIR"] = telemetry_dir
    work = os.path.dirname(os.path.abspath(out_path))
    init = launch.rendezvous(work)
    _, devices = launch.devices_for(dev, world, "gloo")
    base = ["--role", "life", "--ckpt-root", ckpt_root, "--out", out_path, "--total", str(total),
            "--world", str(world), "--init", init]
    if fault:
        base += ["--fault", fault]
    if fault_step is not None:
        base += ["--fault-step", str(fault_step)]
    if not save_every:
        base += ["--no-save"]
    if after is not None:
        base += ["--after", after]
    spawned = time.time()
    job = launch.start("accelerate_tpu_torch.resilience.chaos",
                       lambda r: base + ["--rank", str(r), "--device", devices[r]], world,
                       env=child_env(topology, extra), capture=True)
    return {"job": job, "topology": topology, "out": out_path, "spawned": spawned,
            "world": world}


def collect_life(handle: dict) -> dict:
    """Wait for a started life (under ``CHILD_TIMEOUT_S``) and return rank
    0's record, with its seconds by part under ``timing``."""
    results = handle["job"].wait(CHILD_TIMEOUT_S)
    codes = [code for code, _, _ in results]
    if codes != [0] * handle["world"]:
        for r, (code, out, err) in enumerate(results):
            if code != 0:
                print(f"--- life on {handle['topology']}, rank {r} exited {code} ---\n"
                      f"{out[-2000:]}", file=sys.stderr)
                print(err[-6000:], file=sys.stderr)
        raise RuntimeError(f"life on {handle['topology']} exited {codes}")
    sys.stderr.write(results[0][2])
    ended = time.time()
    with open(handle["out"]) as f:
        rec = json.load(f)
    c = rec.pop("clock")
    # Rank 0's seconds: interpreter and imports, the group, the build, the
    # wait for the go signal, the resume, the steps, its teardown and exit.
    rec["timing"] = {"start_s": c["entry"] - handle["spawned"],
                     "join_s": c["joined"] - c["entry"], "build_s": c["built"] - c["joined"],
                     "wait_s": c["go"] - c["built"], "resume_s": c["resumed"] - c["go"],
                     "steps_s": c["done"] - c["resumed"], "exit_s": ended - c["done"]}
    return rec


def _assert_no_torn_publishes(ckpt_root: str) -> int:
    """Every PUBLISHED checkpoint directory must be manifest-complete; torn
    saves may only exist as ``.tmp`` staging.  Returns the published count."""
    from .manifest import is_complete, list_checkpoints

    published = list_checkpoints(os.path.join(ckpt_root, "checkpoints"))
    torn = [d for d in published if not is_complete(d)]
    assert not torn, f"torn checkpoints were PUBLISHED: {torn}"
    return len(published)


def run_campaign(seed: int, total_steps: int = TOTAL_STEPS, workdir: Optional[str] = None,
                 device=None) -> dict:
    """Run the full campaign; returns a summary (and asserts every oracle
    along the way)."""
    from ..telemetry import get_telemetry

    work = workdir or tempfile.mkdtemp(prefix="atpu_chaos_")
    os.makedirs(work, exist_ok=True)
    root = os.path.join(work, "campaign")
    os.makedirs(root, exist_ok=True)
    cycles = plan_campaign(seed, total_steps)
    changes = sum(1 for a, b in zip(cycles, cycles[1:]) if a.topology != b.topology)
    assert changes >= 2, f"campaign plan must change topology >= 2 times, got {changes}"
    tel = get_telemetry()

    print(f"# chaos: reference run ({BASE_TOPOLOGY}, {total_steps} steps, no faults)",
          file=sys.stderr)
    # The reference run has its own root, so it runs beside life 0; each
    # later life builds while the one before it runs (two lives at most) and
    # resumes once the parent has checked that one (its go file).
    t0 = time.perf_counter()
    started = [start_life(os.path.join(work, "reference"), os.path.join(work, "reference.json"),
                          BASE_TOPOLOGY, total_steps, save_every=False, device=device)]
    go = [os.path.join(work, f"go_life{c.life}") for c in cycles]

    def start(k):
        cyc = cycles[k]
        print(f"# chaos: life {cyc.life} on {cyc.topology}, fault={cyc.fault}@{cyc.fault_step}",
              file=sys.stderr)
        started.append(start_life(
            root, os.path.join(work, f"life{cyc.life}.json"), cyc.topology, total_steps,
            fault=cyc.fault, fault_step=cyc.fault_step,
            telemetry_dir=os.path.join(work, f"telemetry_life{cyc.life}"), device=device,
            after=go[k - 1] if k else None))

    lives = []
    seconds = {}
    try:
        start(0)
        start(1)
        reference = collect_life(started[0])
        assert reference["death"] == "completed" and reference["last_step"] == total_steps, (
            reference)
        seconds["reference"] = time.perf_counter() - t0
        prev: Optional[dict] = None
        prev_expect = None
        nan_skip_from = math.inf
        for k, cyc in enumerate(cycles):
            rec = collect_life(started[k + 1])
            seconds[f"life{cyc.life}"] = time.perf_counter() - t0
            lives.append(rec)

            # -- per-cycle oracles --------------------------------------------
            expected_death = {"sigterm": "sigterm", "torn_write": "save_failed", "oom": "oom",
                              "nan": "completed", None: "completed"}[cyc.fault]
            assert rec["death"] == expected_death, (cyc, rec["death"])
            published = _assert_no_torn_publishes(root)
            assert published >= 1, "cycle ended with no published checkpoint"

            if cyc.life > 0:
                assert prev is not None
                assert rec["resumed_at"] == prev_expect, (
                    f"life {cyc.life} resumed at {rec['resumed_at']}, expected {prev_expect}")
                want = prev["digests"].get(str(rec["resumed_at"]))
                assert want is not None, (
                    f"previous life has no digest for step {rec['resumed_at']}")
                assert rec["loaded_digest"] == want, (
                    f"life {cyc.life} loaded state digest {rec['loaded_digest'][:16]} != "
                    f"saved {want[:16]} (step {rec['resumed_at']})")
                if cyc.topology != cycles[cyc.life - 1].topology:
                    assert rec["resharded"], (
                        f"life {cyc.life} changed topology but reported no reshard")

            if cyc.fault == "nan":
                assert rec["skipped_steps"] == [cyc.fault_step], rec["skipped_steps"]
                nan_skip_from = cyc.fault_step
            for step_str, loss in rec["losses"].items():
                step = int(step_str)
                ref = reference["losses"].get(step_str)
                assert math.isfinite(loss), f"life {cyc.life} step {step}: loss {loss}"
                if ref is None or step > nan_skip_from:
                    continue  # the trajectory after a skip forks
                if cyc.topology == BASE_TOPOLOGY:
                    assert loss == ref, (
                        f"same-topology life {cyc.life} step {step}: {loss!r} != {ref!r}")
                else:
                    assert abs(loss - ref) <= CROSS_TOL * max(1.0, abs(ref)), (
                        f"cross-topology life {cyc.life} step {step}: {loss} vs {ref}")

            if tel.enabled:
                tel.registry.counter("chaos.cycles").inc()
                tel.event("chaos.cycle", life=cyc.life, topology=cyc.topology, fault=cyc.fault,
                          fault_step=cyc.fault_step, death=rec["death"],
                          resumed_at=rec["resumed_at"], resharded=rec["resharded"],
                          last_step=rec["last_step"])
            prev = rec
            prev_expect = cyc.expect_resume
            with open(go[k], "w"):
                pass  # the next life may resume
            if k + 2 < len(cycles):
                start(k + 2)
    finally:
        for handle in started:
            handle["job"].kill()

    # -- final oracles --------------------------------------------------------
    from .manifest import find_latest_complete, read_manifest, verify_checkpoint

    final = find_latest_complete(os.path.join(root, "checkpoints"))
    assert final is not None, "campaign left no complete checkpoint"
    manifest = verify_checkpoint(final)  # raises on torn/corrupt
    assert manifest["step"] == total_steps, manifest["step"]
    assert read_manifest(final).get("topology") is not None, (
        "final manifest lost its topology record")
    resumes = sum(1 for rec in lives if rec["resumed_at"] is not None)
    assert resumes >= 3, f"campaign needs >= 3 kill/resume cycles, got {resumes}"

    # -- goodput-ledger oracle -------------------------------------------------
    from ..telemetry import goodput as goodput_mod
    from ..telemetry.report import load_records

    fault_category = {"sigterm": "preempt", "torn_write": "checkpoint",
                      "oom": "device_acquire", "nan": "rewind_replay"}
    ledgers = []
    for cyc in cycles:
        records = load_records(os.path.join(work, f"telemetry_life{cyc.life}",
                                            "telemetry_p0.jsonl"))
        assert records, f"life {cyc.life} left no telemetry records"
        ledger = goodput_mod.summary_from_records(records)
        assert ledger is not None, f"life {cyc.life}: empty goodput ledger"
        assert abs(ledger["conservation_error_s"]) < 1e-6, (cyc.life, ledger)
        assert ledger["seconds"]["productive"] >= 0.0 and all(
            v >= 0.0 for v in ledger["seconds"].values()), (cyc.life, ledger["seconds"])
        category = fault_category[cyc.fault]
        assert ledger["markers"].get(category, 0) >= 1, (
            f"life {cyc.life} fault {cyc.fault!r} left no {category!r} marker "
            f"in its ledger: {ledger['markers']}")
        ledgers.append({"life": cyc.life, "fault": cyc.fault, "category": category,
                        "markers": ledger["markers"],
                        "goodput_fraction": ledger["goodput_fraction"]})
    print("# chaos: goodput ledger attributed every fault class "
          f"({', '.join(f'{e[0]}->{e[1]}' for e in fault_category.items())})", file=sys.stderr)

    return {
        "seed": seed,
        "total_steps": total_steps,
        "cycles": [asdict(c) for c in cycles],
        "worlds": [TOPOLOGIES[c.topology]["devices"] for c in cycles],
        "deaths": [rec["death"] for rec in lives],
        "resumed_at": [rec["resumed_at"] for rec in lives],
        "resharded": [rec["resharded"] for rec in lives],
        "topology_changes": changes,
        "resumes": resumes,
        "final_checkpoint": final,
        "final_step": int(manifest["step"]),
        "published": _assert_no_torn_publishes(root),
        "goodput": ledgers,
        "seconds": seconds,
        "timing": [reference["timing"]] + [rec["timing"] for rec in lives],
        "campaign_s": time.perf_counter() - t0,
    }


def _life_main(args) -> int:
    """A life's rank: join the group, run the life, leave the group."""
    import torch.distributed as dist

    from ..parallel.launch import join_group

    clock = {"entry": time.time()}
    join_group(args.rank, args.world, args.init, "gloo", args.device)
    clock["joined"] = time.time()
    try:
        return run_life(args.ckpt_root, args.out, args.total, args.fault, args.fault_step,
                        save_every=not args.no_save, device=args.device, clock=clock,
                        after=args.after)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m accelerate_tpu_torch.resilience.chaos")
    parser.add_argument("--role", choices=("life",), default=None)
    parser.add_argument("--ckpt-root", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--total", type=int, default=TOTAL_STEPS)
    parser.add_argument("--fault", choices=FAULTS, default=None)
    parser.add_argument("--fault-step", type=int, default=None)
    parser.add_argument("--no-save", action="store_true")
    parser.add_argument("--after", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--seed", type=int, default=20260804)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--json", default=None, help="write the summary here as JSON")
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    parser.add_argument("--init", default=None, help=argparse.SUPPRESS)
    parser.add_argument(
        "--mode", choices=("train", "serving", "fleet"), default="train",
        help="'serving' runs the serving chaos campaign (overload burst, poisoned "
        "request, deadline storm, SIGTERM drain, SIGKILL + journal recovery); 'fleet' runs "
        "the fleet campaign (SIGKILL, coordinated drain, wedge, elastic 4->3 restart over a "
        "supervised 4-process group) instead of the kill->resume training campaign")
    args = parser.parse_args(argv)

    device = ["--device", args.device] if args.device else []
    if args.mode == "serving":
        from ..serving.chaos import main as serving_main

        return serving_main(["--seed", str(args.seed)] + device)
    if args.mode == "fleet":
        from .fleet_chaos import main as fleet_main

        return fleet_main(["--seed", str(args.seed)] + device
                          + (["--workdir", args.workdir] if args.workdir else [])
                          + (["--json", args.json] if args.json else []))
    if args.role == "life":
        return _life_main(args)

    from ..telemetry import enable as _enable_telemetry

    _enable_telemetry(dir=tempfile.mkdtemp(prefix="atpu_chaos_telemetry_"))
    summary = run_campaign(args.seed, workdir=args.workdir, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f)
    print(
        f"chaos-smoke OK — seed {summary['seed']}: {len(summary['cycles'])} lives, "
        f"{summary['resumes']} kill/resume cycles, {summary['topology_changes']} "
        f"topology changes, {summary['published']} published checkpoints (0 torn), "
        f"final verified checkpoint at step {summary['final_step']}; goodput ledger "
        "conserved + every fault class attributed "
        "(sigterm->preempt, torn_write->checkpoint, oom->device_acquire, "
        f"nan->rewind_replay); {summary['campaign_s']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
