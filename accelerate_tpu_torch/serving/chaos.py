"""Serving chaos campaign: the serving engine under fire, seeded.

The port of the JAX package's ``serving/chaos.py``: the same plans (equal
for a given ``--seed``), the same lives as child processes, the same
assertions in the parent.  ``python -m accelerate_tpu_torch.serving.chaos``
drives one engine lineage through every robustness front at once:

1. **overload burst** — more submissions than ``max_queue_depth`` can hold;
   the surplus must shed with :class:`AdmissionRejected` (``serving.shed``),
   exactly as many as the plan predicts;
2. **poison request** — ``ACCELERATE_TPU_FAULT_SERVING_NAN_REQUEST`` NaNs
   one request's logits in the decode forward; it must quarantine while
   every other slot keeps decoding identically;
3. **deadline storm** — a batch of already-expired requests; all must shed
   from the queue before a prefill chunk is spent on them;
4. **SIGTERM drain** — a real signal through a ``PreemptionGuard``; the
   next tick drains and the write-ahead journal persists emitted progress;
5. **SIGKILL + journal recovery** — a successor recovers the journal,
   makes progress, and is SIGKILLed mid-flight (no handler runs); a second
   successor recovers again and finishes everything.

The parent asserts, across the whole campaign:

- **token identity** — every surviving request's tokens equal the offline
  greedy ``generate`` for its prompt alone, whichever life completed it;
- **zero block leaks** — each life that exits cleanly reports its allocator
  free count back at full capacity;
- **no starvation** — every non-shed request reaches a terminal state
  (completed, deadline-expired, or quarantined);
- **exact fault accounting** — shed / deadline_expired / quarantined
  counts match the plan, and the SIGKILLed life really died by signal 9.

``--campaign tiering`` runs the **tiered** campaign instead, pointed at the
host-memory KV tier.  A pool tight enough that every life preempts drives
four fronts:

1. **memory-pressure life** — preemptions migrate KV blocks to host memory
   and re-admissions promote them back; real migrations happened, every
   output is token-identical to the oracle, and a migrated request that
   never fell back paid ZERO extra prefill forwards on resume;
2. **host-full life** — ``ACCELERATE_TPU_FAULT_SERVING_HOST_FULL`` forces
   the host-exhausted path: every preemption falls back to re-prefill
   (fallbacks > 0, promotions == 0) and stays token-identical;
3. **SIGKILL while demoted** — a victim life dies by signal 9 at the exact
   moment a request's blocks sit in host memory; the journal's ``tier``
   record must show ``"host"`` residency;
4. **recovery** — a finisher life recovers the journal (host memory died
   with the victim, so it re-prefills) and finishes everything
   token-identically.

Model size (``--size``): ``tiny`` is the JAX campaign's gpt2-tiny (fp32,
weights from seed 0) on the CPU; ``llama3-8b`` is Llama-3-8B's widths cut
to :data:`CARD_LAYERS` layers in fp32 (so token identity with the oracle is
exact) on the card, every decode through the paged kernels.  The geometry
is the JAX campaign's at both sizes: scheduling depends on lengths only, so
the same pools shed, preempt and migrate the same way.  Every life reports
its paged-kernel launch counts, its quarantined and shed counts and its
tier's migrations, fallbacks and promotions.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
from typing import Optional

CHILD_TIMEOUT_S = 600.0
QUEUE_DEPTH = 4
MAX_TICKS = 2000
SIZES = ("tiny", "llama3-8b")
CARD_LAYERS = 2


def plan_serving_campaign(seed: int) -> dict:
    """Deterministic request mix for one campaign.  ``burst`` arrives before
    any tick, so exactly ``len(burst) - queue_depth`` requests shed (queue
    admission only happens inside ``step``).  The poison ordinal counts
    ACCEPTED submissions (shed raises before the ordinal increments):
    ``queue_depth`` burst survivors, then the poison request itself."""
    import random

    rnd = random.Random(seed)

    def prompt(n):
        return [rnd.randrange(0, 64) for _ in range(n)]

    burst = [
        {"tag": f"n{i}", "prompt": prompt(rnd.randint(3, 12)),
         "max_new": rnd.randint(3, 7)}
        for i in range(QUEUE_DEPTH + 2)
    ]
    poison = {"tag": "poison", "prompt": prompt(rnd.randint(4, 9)),
              "max_new": rnd.randint(3, 6)}
    storm = [
        {"tag": f"s{i}", "prompt": prompt(rnd.randint(3, 8)),
         "max_new": rnd.randint(2, 5), "deadline_ms": 0.0}
        for i in range(3)
    ]
    # Submitted right before the SIGTERM with zero ticks left: guaranteed
    # in-flight at the drain, so the SIGKILL-recovery leg always has real
    # work to hand across TWO journal recoveries.
    late = [
        {"tag": f"l{i}", "prompt": prompt(rnd.randint(3, 10)),
         "max_new": rnd.randint(3, 6)}
        for i in range(2)
    ]
    return {
        "seed": seed,
        "queue_depth": QUEUE_DEPTH,
        "burst": burst,
        "poison": poison,
        "poison_ordinal": QUEUE_DEPTH + 1,
        "storm": storm,
        "late": late,
        "expect_shed": [r["tag"] for r in burst[QUEUE_DEPTH:]],
        "expect_expired": [r["tag"] for r in storm],
        "survivor_tags": [r["tag"] for r in burst[:QUEUE_DEPTH]]
        + [r["tag"] for r in late],
    }


def plan_tiering_campaign(seed: int) -> dict:
    """Deterministic request mix for the tiered campaign: enough concurrent
    prompts that the 8-usable-block pool must preempt, every request sized
    to need several blocks (so a migration moves real KV state)."""
    import random

    rnd = random.Random(seed)

    def prompt(n):
        return [rnd.randrange(0, 64) for _ in range(n)]

    requests = [
        {"tag": f"t{i}", "prompt": prompt(rnd.randint(5, 12)),
         "max_new": rnd.randint(5, 8), "chunk": 4}
        for i in range(4)
    ]
    return {"seed": seed, "requests": requests}


# ---------------------------------------------------------------------------
# Model and engines
# ---------------------------------------------------------------------------


def _model(size: str, device: str):
    """``(family module, config, params)`` for ``size`` on ``device``."""
    import torch

    if size == "tiny":
        from ..models import gpt2 as fam

        cfg = fam.GPT2Config.tiny(dtype=torch.float32)
    elif size == "llama3-8b":
        from ..models import llama as fam

        cfg = fam.LlamaConfig.llama3_8b(num_layers=CARD_LAYERS, dtype=torch.float32)
    else:
        raise ValueError(f"size must be one of {SIZES}, got {size!r}")
    return fam, cfg, fam.init_params(cfg, seed=0, device=device)


def _engine(size: str, device: str, journal_path: Optional[str], **geometry):
    from . import ServingConfig, ServingEngine

    fam, cfg, params = _model(size, device)
    return ServingEngine(
        fam.apply_cached, fam.init_cache, params, cfg,
        serving=ServingConfig(journal_path=journal_path, paged_kernel=True, **geometry),
        device=device,
    )


def _build_engine(size: str, device: str, journal_path: str,
                  queue_depth: Optional[int] = None):
    # Tiering on even in the classic campaign: the loose pool rarely
    # preempts (shed is queue-depth-only), but construction, drain and
    # recovery all run with the host tier attached.
    return _engine(size, device, journal_path, block_size=4, num_blocks=40, max_slots=2,
                   prefill_chunk=8, max_blocks_per_seq=8, max_queue_depth=queue_depth,
                   host_blocks=16)


def _build_tiered_engine(size: str, device: str, journal_path: Optional[str] = None):
    """The tiering campaign's engine: a pool tight enough (8 usable blocks
    vs 3 slots) that preemption — and therefore migration — is guaranteed,
    with host room for every victim."""
    return _engine(size, device, journal_path, block_size=4, num_blocks=9, max_slots=3,
                   prefill_chunk=4, max_blocks_per_seq=6, host_blocks=16)


def _launches() -> dict:
    from ..ops import paged_attention as pa

    return {"paged_attention": pa.paged_attention.launches,
            "paged_window_attention": pa.paged_window_attention.launches}


def _emit(out, record: dict) -> None:
    """One JSON line per fact, flushed immediately: a SIGKILL later must not
    lose what already happened (the parent parses whatever landed)."""
    print(json.dumps(record), file=out, flush=True)


def _emit_done(out, c) -> None:
    _emit(out, {
        "kind": "done", "tag": c.tag, "status": c.status, "tokens": c.tokens,
        "migrations": c.migrations, "fallback_reprefills": c.fallback_reprefills,
        "prefill_dispatches": c.prefill_dispatches, "prompt_len": c.prompt_len,
    })


def _life_record(engine) -> dict:
    """What every life reports: its fault counters, its tier's migrations,
    fallbacks and promotions, its preemptions and its paged launches."""
    return {
        "counters": {
            "shed": engine.shed_count,
            "deadline_expired": engine.deadline_expired_count,
            "quarantined": engine.quarantined_count,
        },
        "tiering": engine.stats()["tiering"],
        "preempted": engine.sched.preempted_count,
        "launches": _launches(),
        "decode_dispatches": engine.decode_dispatches,
    }


def _emit_exit(out, engine, **extra) -> None:
    prefix_host = engine._prefix.host_count if engine._prefix is not None else 0
    _emit(out, dict(
        kind="exit",
        free_blocks=engine.cache.allocator.free_blocks,
        capacity=engine.cache.allocator.capacity,
        host_used=engine.cache.host.used_blocks,
        prefix_host_entries=prefix_host,
        **_life_record(engine), **extra,
    ))


def _emit_progress(out, engine) -> None:
    """A life about to die by SIGKILL reports what it did first."""
    _emit(out, dict(kind="progress", **_life_record(engine)))


# ---------------------------------------------------------------------------
# Lives (child-process roles)
# ---------------------------------------------------------------------------


def run_first_life(plan: dict, journal_path: str, size: str, device: str) -> int:
    """Overload burst -> poison quarantine -> deadline storm -> SIGTERM
    drain.  Every observable lands on stdout as JSON lines."""
    from ..resilience import PreemptionGuard
    from . import AdmissionRejected

    engine = _build_engine(size, device, journal_path, queue_depth=plan["queue_depth"])
    out = sys.stdout

    shed = []
    for rec in plan["burst"]:
        try:
            engine.submit(rec["prompt"], rec["max_new"], tag=rec["tag"])
        except AdmissionRejected:
            shed.append(rec["tag"])
    _emit(out, {"kind": "shed", "tags": shed})

    for _ in range(4):
        engine.step()

    # Poison request: the armed ordinal (env) matches THIS submission.
    engine.submit(plan["poison"]["prompt"], plan["poison"]["max_new"],
                  tag=plan["poison"]["tag"])
    ticks = 0
    while engine.quarantined_count < 1 and ticks < MAX_TICKS:
        engine.step()
        ticks += 1
    assert engine.quarantined_count == 1, "poison request never quarantined"

    # Deadline storm: drain the queue enough that overload shedding cannot
    # race the deadline shed (the storm must die by deadline, not depth).
    for rec in plan["storm"]:
        ticks = 0
        while engine.sched.pending >= plan["queue_depth"] and ticks < MAX_TICKS:
            engine.step()
            ticks += 1
        engine.submit(rec["prompt"], rec["max_new"], tag=rec["tag"],
                      deadline_ms=rec["deadline_ms"])
    engine.step()  # expiry runs before admission: the whole storm sheds here

    # Late arrivals: no tick runs between these and the SIGTERM, so they are
    # guaranteed to ride the journal into the successor lives.
    for rec in plan["late"]:
        ticks = 0
        while engine.sched.pending >= plan["queue_depth"] and ticks < MAX_TICKS:
            engine.step()
            ticks += 1
        engine.submit(rec["prompt"], rec["max_new"], tag=rec["tag"])

    for c in engine.pop_finished():
        _emit_done(out, c)

    # SIGTERM drain through a REAL signal + guard (not a direct drain()).
    guard = PreemptionGuard(signals=(signal.SIGTERM,), coordinated=False)
    guard.install()
    try:
        engine.install_preemption_guard(guard)
        os.kill(os.getpid(), signal.SIGTERM)
        engine.step()  # this tick drains
    finally:
        guard.uninstall()
    assert engine.drained, "SIGTERM did not drain the engine"
    for c in engine.pop_finished():
        _emit_done(out, c)
    _emit_exit(out, engine, drain_pending=[r["tag"] for r in engine.requeue_journal])
    return 0


def run_victim_life(journal_path: str, kill_after: int, size: str, device: str) -> int:
    """Recover the journal, complete ``kill_after`` requests, then SIGKILL
    ourselves mid-flight — no handler, no drain, no atexit.  The write-ahead
    journal alone must carry the rest."""
    engine = _build_engine(size, device, journal_path)
    mapping = engine.recover_from_journal()
    _emit(sys.stdout, {"kind": "recovered", "count": len(mapping)})
    completed = 0
    ticks = 0
    while ticks < MAX_TICKS:
        engine.step()
        ticks += 1
        for c in engine.pop_finished():
            _emit_done(sys.stdout, c)
            completed += 1
        if completed >= kill_after:
            _emit_progress(sys.stdout, engine)
            os.kill(os.getpid(), signal.SIGKILL)
    raise AssertionError("victim life drained before reaching its kill point")


def run_finisher_life(journal_path: str, size: str, device: str) -> int:
    """Recover whatever the SIGKILL left behind and finish every request."""
    engine = _build_engine(size, device, journal_path)
    mapping = engine.recover_from_journal()
    _emit(sys.stdout, {"kind": "recovered", "count": len(mapping)})
    engine.run(max_ticks=MAX_TICKS)
    for c in engine.pop_finished():
        _emit_done(sys.stdout, c)
    _emit_exit(sys.stdout, engine)
    return 0


def run_tier_pressure_life(plan: dict, size: str, device: str) -> int:
    """Memory-pressure life: the tight pool preempts, preemption migrates,
    re-admission promotes.  Also the host-full life when the parent arms
    ``SERVING_HOST_FULL`` in this child's environment (same code path; the
    fault flips every migration into a fallback)."""
    engine = _build_tiered_engine(size, device)
    out = sys.stdout
    for rec in plan["requests"]:
        engine.submit(rec["prompt"], rec["max_new"], tag=rec["tag"])
    engine.run(max_ticks=MAX_TICKS)
    assert engine.sched.preempted_count > 0, (
        "tiering life never preempted — the pool is not tight enough"
    )
    for c in engine.pop_finished():
        _emit_done(out, c)
    _emit_exit(out, engine)
    return 0


def run_tier_victim_life(plan: dict, journal_path: str, size: str, device: str) -> int:
    """SIGKILL-while-demoted: run until some request's KV blocks sit in host
    memory, then die by signal 9 on the spot — the journal's tier record
    must carry what the host tier cannot (it dies with this process)."""
    engine = _build_tiered_engine(size, device, journal_path)
    out = sys.stdout
    for rec in plan["requests"]:
        engine.submit(rec["prompt"], rec["max_new"], tag=rec["tag"])
    for _ in range(MAX_TICKS):
        engine.step()
        for c in engine.pop_finished():
            _emit_done(out, c)
        if any(req.demoted_blocks for req in engine.sched.queue):
            _emit_progress(out, engine)
            os.kill(os.getpid(), signal.SIGKILL)
    raise AssertionError(
        "victim life finished without ever holding a request in the host tier"
    )


def run_tier_finisher_life(journal_path: str, size: str, device: str) -> int:
    """Recover the SIGKILLed victim's journal (all host-resident state is
    gone; re-prefill from the journaled progress) and finish everything."""
    engine = _build_tiered_engine(size, device, journal_path)
    mapping = engine.recover_from_journal()
    _emit(sys.stdout, {"kind": "recovered", "count": len(mapping)})
    engine.run(max_ticks=MAX_TICKS)
    for c in engine.pop_finished():
        _emit_done(sys.stdout, c)
    _emit_exit(sys.stdout, engine)
    return 0


# ---------------------------------------------------------------------------
# Orchestration (parent)
# ---------------------------------------------------------------------------


def _child_env(extra: Optional[dict] = None) -> dict:
    env = dict(os.environ)
    for key in (
        "ACCELERATE_TPU_FAULT_SERVING_NAN_REQUEST",
        "ACCELERATE_TPU_FAULT_SERVING_HOST_FULL",
        "ACCELERATE_TPU_TELEMETRY",
        "ACCELERATE_TPU_TELEMETRY_DIR",
    ):
        env.pop(key, None)
    env.update({"ACCELERATE_TPU_SENTINEL_PROFILE": "0",
                "ACCELERATE_TPU_CHECKPOINT_FSYNC": "0"})
    env.update(extra or {})
    return env


def _spawn(role: str, plan_path: str, journal_path: str, size: str, device: str,
           extra_env: Optional[dict] = None, expect_rc=0,
           kill_after: Optional[int] = None) -> list:
    cmd = [
        sys.executable, "-m", "accelerate_tpu_torch.serving.chaos",
        "--role", role, "--plan", plan_path, "--journal", journal_path,
        "--size", size, "--device", device,
    ]
    if kill_after is not None:
        cmd += ["--kill-after", str(kill_after)]
    proc = subprocess.run(
        cmd, env=_child_env(extra_env), capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S,
    )
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != expect_rc:
        print(proc.stdout)
        print(proc.stderr, file=sys.stderr)
        raise RuntimeError(
            f"serving life {role!r} exited rc={proc.returncode}, "
            f"expected {expect_rc}"
        )
    records = []
    for line in proc.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            records.append(json.loads(line))
    return records


def _by_kind(recs, kind):
    return [r for r in recs if r["kind"] == kind]


def _oracle(requests, size: str, device: str) -> dict:
    """Offline greedy ``generate`` per prompt alone, in THIS process: the
    lives must match it whichever of them completed a request."""
    import torch

    fam, cfg, params = _model(size, device)
    oracle = {}
    for rec in requests:
        out = fam.generate(params, torch.tensor([rec["prompt"]], device=device), cfg,
                           max_new_tokens=rec["max_new"])
        oracle[rec["tag"]] = [int(t) for t in out[0].tolist()]
    return oracle


def _life(records, role: str) -> dict:
    """A life's own report for the summary: the exit (or progress) record
    without its per-request lists."""
    rec = (_by_kind(records, "exit") or _by_kind(records, "progress") or [{}])[0]
    return {"role": role, **{k: rec[k] for k in ("counters", "tiering", "preempted",
                                                 "launches", "decode_dispatches",
                                                 "free_blocks", "capacity", "host_used",
                                                 "prefix_host_entries")
                             if k in rec}}


def run_serving_campaign(seed: int, workdir: Optional[str] = None, size: str = "tiny",
                         device: Optional[str] = None) -> dict:
    """Run the full campaign; asserts every oracle, returns a summary.
    ``device`` ``None`` is the card (raising without CUDA); ``"cpu"`` asks
    for the CPU."""
    from ..state import resolve_device

    device = str(resolve_device(device))
    work = workdir or tempfile.mkdtemp(prefix="atpu_serving_chaos_")
    os.makedirs(work, exist_ok=True)
    plan = plan_serving_campaign(seed)
    plan_path = os.path.join(work, "plan.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    journal_path = os.path.join(work, "journal.json")
    oracle = _oracle(plan["burst"] + [plan["poison"]] + plan["storm"] + plan["late"],
                     size, device)

    print(f"# serving-chaos: life 0 (burst + poison + storm + SIGTERM drain), seed {seed}",
          file=sys.stderr)
    recs0 = _spawn(
        "first", plan_path, journal_path, size, device,
        extra_env={
            "ACCELERATE_TPU_FAULT_SERVING_NAN_REQUEST": str(plan["poison_ordinal"]),
        },
    )
    shed = _by_kind(recs0, "shed")[0]["tags"]
    assert shed == plan["expect_shed"], (shed, plan["expect_shed"])
    exit0 = _by_kind(recs0, "exit")[0]
    assert exit0["counters"]["shed"] == len(plan["expect_shed"]), exit0
    assert exit0["counters"]["deadline_expired"] == len(plan["expect_expired"]), exit0
    assert exit0["counters"]["quarantined"] == 1, exit0
    assert exit0["free_blocks"] == exit0["capacity"], f"life 0 leaked blocks: {exit0}"

    done: dict = {}

    def collect(records):
        for r in _by_kind(records, "done"):
            assert r["tag"] not in done, f"request {r['tag']} completed twice"
            done[r["tag"]] = r

    collect(recs0)
    quarantined = [t for t, r in done.items() if r["status"] == "quarantined"]
    expired = [t for t, r in done.items() if r["status"] == "deadline_expired"]
    assert quarantined == [plan["poison"]["tag"]], quarantined
    assert sorted(expired) == sorted(plan["expect_expired"]), expired

    pending = set(exit0["drain_pending"])
    assert pending >= {r["tag"] for r in plan["late"]}, (
        f"late requests missing from the drain journal: {pending}"
    )
    print(f"# serving-chaos: life 1 (journal recovery, then SIGKILL mid-flight); "
          f"{len(pending)} pending", file=sys.stderr)
    recs1 = _spawn("victim", plan_path, journal_path, size, device,
                   expect_rc=-signal.SIGKILL, kill_after=1)
    assert _by_kind(recs1, "recovered")[0]["count"] == len(pending), recs1
    collect(recs1)

    print("# serving-chaos: life 2 (journal recovery after SIGKILL, finish everything)",
          file=sys.stderr)
    recs2 = _spawn("finisher", plan_path, journal_path, size, device)
    collect(recs2)
    exit2 = _by_kind(recs2, "exit")[0]
    assert exit2["free_blocks"] == exit2["capacity"], f"life 2 leaked blocks: {exit2}"

    # -- campaign-wide oracles ------------------------------------------------
    all_tags = {
        r["tag"]
        for r in plan["burst"] + [plan["poison"]] + plan["storm"] + plan["late"]
    }
    terminal = set(done) | set(shed)
    assert terminal == all_tags, (
        f"starvation: requests never reached a terminal state: {all_tags - terminal}"
    )
    survivors = [t for t, r in done.items() if r["status"] == "ok"]
    assert sorted(survivors) == sorted(plan["survivor_tags"]), (
        survivors, plan["survivor_tags"]
    )
    for tag in survivors:
        assert done[tag]["tokens"] == oracle[tag], (
            f"survivor {tag} diverged from generate:\n"
            f"  got  {done[tag]['tokens']}\n  want {oracle[tag]}"
        )

    return {
        "seed": seed,
        "size": size,
        "requests": len(all_tags),
        "survivors": len(survivors),
        "shed": len(shed),
        "deadline_expired": len(expired),
        "quarantined": len(quarantined),
        "recoveries": 2,
        "lives": [_life(recs0, "first"), _life(recs1, "victim"),
                  _life(recs2, "finisher")],
        "tokens": {"survivors": {tag: done[tag]["tokens"] for tag in survivors}},
        "oracle": oracle,
        "workdir": work,
    }


def run_tiering_campaign(seed: int, workdir: Optional[str] = None, size: str = "tiny",
                         device: Optional[str] = None) -> dict:
    """The tiered chaos campaign; asserts every oracle, returns a summary.
    ``device`` as :func:`run_serving_campaign`'s."""
    from ..state import resolve_device
    from .journal import ServingJournal

    device = str(resolve_device(device))

    work = workdir or tempfile.mkdtemp(prefix="atpu_tiering_chaos_")
    os.makedirs(work, exist_ok=True)
    plan = plan_tiering_campaign(seed)
    plan_path = os.path.join(work, "plan.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    journal_path = os.path.join(work, "journal.json")
    oracle = _oracle(plan["requests"], size, device)
    all_tags = {r["tag"] for r in plan["requests"]}

    def check_identity(done_recs):
        for r in done_recs:
            assert r["status"] == "ok", f"request {r['tag']} ended {r['status']}"
            assert r["tokens"] == oracle[r["tag"]], (
                f"request {r['tag']} diverged from generate:\n"
                f"  got  {r['tokens']}\n  want {oracle[r['tag']]}"
            )

    # -- life 0: memory pressure (preempt -> demote -> promote -> resume) ----
    print(f"# tiering-chaos: life 0 (memory pressure: preemption as migration), "
          f"seed {seed}", file=sys.stderr)
    recs0 = _spawn("tier-pressure", plan_path, journal_path, size, device)
    done0 = _by_kind(recs0, "done")
    assert {r["tag"] for r in done0} == all_tags, "life 0 starved a request"
    check_identity(done0)
    exit0 = _by_kind(recs0, "exit")[0]
    st0 = exit0["tiering"]
    assert st0["demotions"] > 0 and st0["promotions"] > 0, (
        f"pressure life never migrated: {st0}"
    )
    migrated0 = [r for r in done0 if r["migrations"] > 0]
    assert migrated0, "no request round-tripped through the host tier"
    for r in migrated0:
        if r["fallback_reprefills"] == 0:
            base = -(-r["prompt_len"] // 4)  # ceil(prompt / prefill_chunk)
            assert r["prefill_dispatches"] == base, (
                f"{r['tag']} re-prefilled on the migrated resume path: "
                f"{r['prefill_dispatches']} forwards vs {base}"
            )
    assert exit0["host_used"] == exit0["prefix_host_entries"], (
        f"life 0 leaked host blocks: {exit0}"
    )
    assert exit0["free_blocks"] == exit0["capacity"], f"life 0 leaked: {exit0}"

    # -- life 1: host tier full (fault-forced fallback re-prefill) -----------
    print("# tiering-chaos: life 1 (SERVING_HOST_FULL: forced fallback re-prefill)",
          file=sys.stderr)
    recs1 = _spawn(
        "tier-pressure", plan_path, journal_path, size, device,
        extra_env={"ACCELERATE_TPU_FAULT_SERVING_HOST_FULL": "1"},
    )
    done1 = _by_kind(recs1, "done")
    assert {r["tag"] for r in done1} == all_tags, "host-full life starved a request"
    check_identity(done1)
    st1 = _by_kind(recs1, "exit")[0]["tiering"]
    assert st1["fallback_reprefills"] > 0, (
        f"host-full fault never forced a fallback: {st1}"
    )
    assert st1["promotions"] == 0, f"a promotion happened with the host full: {st1}"

    # -- lives 2+3: SIGKILL while demoted, then journal recovery -------------
    print("# tiering-chaos: life 2 (SIGKILL at the instant a request is "
          "host-resident)", file=sys.stderr)
    recs2 = _spawn("tier-victim", plan_path, journal_path, size, device,
                   expect_rc=-signal.SIGKILL)
    # The victim died with blocks in host memory: its journal must say so.
    state = ServingJournal.load(journal_path)
    host_resident = [
        rid for rid, rec in state["requests"].items()
        if rec.get("tier", {}).get("residency") == "host"
        and rid not in state["done"]
    ]
    assert host_resident, (
        "victim's journal carries no host-resident tier record at the kill"
    )

    print("# tiering-chaos: life 3 (journal recovery: host state is gone, "
          "re-prefill finishes everything)", file=sys.stderr)
    recs3 = _spawn("tier-finisher", plan_path, journal_path, size, device)
    done: dict = {}
    for r in _by_kind(recs2, "done") + _by_kind(recs3, "done"):
        assert r["tag"] not in done, f"request {r['tag']} completed twice"
        done[r["tag"]] = r
    assert set(done) == all_tags, (
        f"starvation across the kill: {all_tags - set(done)}"
    )
    check_identity(done.values())
    exit3 = _by_kind(recs3, "exit")[0]
    assert exit3["free_blocks"] == exit3["capacity"], f"life 3 leaked: {exit3}"
    assert exit3["host_used"] == exit3["prefix_host_entries"], (
        f"life 3 leaked host blocks: {exit3}"
    )

    return {
        "seed": seed,
        "size": size,
        "requests": len(all_tags),
        "migrations": st0["demotions"],
        "promotions": st0["promotions"],
        "fallbacks_forced": st1["fallback_reprefills"],
        "host_resident_at_kill": len(host_resident),
        "lives": [_life(recs0, "tier-pressure"), _life(recs1, "tier-host-full"),
                  _life(recs2, "tier-victim"), _life(recs3, "tier-finisher")],
        "tokens": {"tier-pressure": {r["tag"]: r["tokens"] for r in done0},
                   "tier-host-full": {r["tag"]: r["tokens"] for r in done1},
                   "across-the-kill": {t: r["tokens"] for t, r in done.items()}},
        "oracle": oracle,
        "workdir": work,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.serving.chaos",
    )
    parser.add_argument("--role",
                        choices=("first", "victim", "finisher",
                                 "tier-pressure", "tier-victim",
                                 "tier-finisher"),
                        default=None)
    parser.add_argument("--campaign", choices=("serving", "tiering"),
                        default="serving")
    parser.add_argument("--plan", default=None)
    parser.add_argument("--journal", default=None)
    parser.add_argument("--kill-after", type=int, default=1)
    parser.add_argument("--seed", type=int, default=20260804)
    parser.add_argument("--size", choices=SIZES, default="tiny")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    from ..state import resolve_device

    device = str(resolve_device(args.device))

    if args.role is not None:
        with open(args.plan) as f:
            plan = json.load(f)
        if args.role == "first":
            return run_first_life(plan, args.journal, args.size, device)
        if args.role == "victim":
            return run_victim_life(args.journal, args.kill_after, args.size, device)
        if args.role == "finisher":
            return run_finisher_life(args.journal, args.size, device)
        if args.role == "tier-pressure":
            return run_tier_pressure_life(plan, args.size, device)
        if args.role == "tier-victim":
            return run_tier_victim_life(plan, args.journal, args.size, device)
        return run_tier_finisher_life(args.journal, args.size, device)

    if args.campaign == "tiering":
        summary = run_tiering_campaign(args.seed, size=args.size, device=device)
        print(
            f"tiering-chaos-smoke OK — seed {summary['seed']}: "
            f"{summary['requests']} requests under memory pressure "
            f"({summary['migrations']} demotions / {summary['promotions']} "
            f"promotions through the host tier, zero re-prefill on migrated "
            f"resumes), a host-full life ({summary['fallbacks_forced']} forced "
            f"fallback re-prefills), and a SIGKILL landed while "
            f"{summary['host_resident_at_kill']} request(s) sat host-resident "
            "+ journal recovery; every output token-identical to "
            "generate, zero block leaks in either tier"
        )
        return 0

    summary = run_serving_campaign(args.seed, size=args.size, device=device)
    print(
        f"serving-chaos-smoke OK — seed {summary['seed']}: "
        f"{summary['requests']} requests through overload burst "
        f"({summary['shed']} shed), a poisoned request "
        f"({summary['quarantined']} quarantined), a deadline storm "
        f"({summary['deadline_expired']} expired), SIGTERM drain, and "
        f"SIGKILL + {summary['recoveries']} journal recoveries; every "
        f"survivor ({summary['survivors']}) token-identical to generate, "
        "zero block leaks, terminal state for every request"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
