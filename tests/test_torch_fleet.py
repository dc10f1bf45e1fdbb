"""The fleet runtime in the port (``resilience/fleet.py``, ``launchers.py``'s
``FleetSupervisor``, ``resilience/fleet_chaos.py``) against the JAX package.

Every non-``slow`` case of ``tests/test_fleet.py``, through both packages:

- each supervisor case runs the same ``python -c`` stub workers (no torch,
  no jax: fast) under the JAX ``FleetSupervisor`` and the port's, side by
  side in two threads; the verdict, ``dead_rank``, ``wedged_rank``, the
  exit codes, ``world_size``, the attempt count and the postmortem's keys
  are held equal, with JAX's time bounds (where a rank's own exit races
  the teardown, its code is held to be its own or a teardown signal);
- the key sequencing, the heartbeat files (each package reads the
  other's), ``maybe_beat`` with and without the env, the connect policy's
  env knobs, and the ``--fleet`` report of a rank-tagged directory.

Over gloo worlds of CPU processes (``torch_dp_world``, tasks in
``torch_fleet_tasks``): ``agree`` returns the rank-ordered values;
``barrier`` and ``agree`` with a rank absent raise ``FleetError`` within
the deadline plus 5 s, also when rank 0 is the one absent, and when rank
0's process (which hosts the ``TCPStore``) is gone; a SIGTERM to one rank
makes every rank's ``should_stop`` true on the same call, over the store.
``plan_fleet_campaign`` equals JAX's for seeds 0-9.  The campaign's
reference, sigkill and elastic arms run at world 2 here; the five arms at
JAX's world of 4 are the ``slow`` test, as JAX marks its own."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from accelerate_tpu.launchers import FleetSupervisor as JaxSupervisor
from accelerate_tpu.resilience import fleet as jfleet
from accelerate_tpu.resilience import fleet_chaos as jchaos
from accelerate_tpu.telemetry.report import load_fleet_records as j_load_fleet
from accelerate_tpu.telemetry.report import summarize_fleet as j_summarize_fleet
from accelerate_tpu_torch.launchers import FleetSupervisor as TorchSupervisor
from accelerate_tpu_torch.resilience import fleet as tfleet
from accelerate_tpu_torch.resilience import fleet_chaos as tchaos
from torch_dp_world import REPO, World

DEADLINE_SLACK_S = 5.0

# The stub workers of tests/test_fleet.py, verbatim.
_SLEEP_WORKER = "import time; time.sleep(120)"

_EXIT_CODE_WORKER = """
import os, sys, time
time.sleep(0.3)
sys.exit(7 if os.environ["ACCELERATE_PROCESS_ID"] == "1" else 0)
"""

_STALL_WORKER = """
import json, os, time
rank = os.environ["ACCELERATE_PROCESS_ID"]
path = os.path.join(os.environ["ACCELERATE_TPU_HEARTBEAT_DIR"], f"heartbeat_p{rank}.json")
t0 = time.time()
while True:
    if rank != "0" or time.time() - t0 < 0.6:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"t": time.time(), "pid": os.getpid()}, f)
        os.replace(tmp, path)
    time.sleep(0.1)
"""

_DRAIN_WORKER = """
import signal, sys, time
signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
time.sleep(120)
"""

_IGNORE_TERM_WORKER = (
    "import signal, time\n"
    "signal.signal(signal.SIGTERM, lambda *_: None)\n"
    "time.sleep(120)\n"
)

_ELASTIC_WORKER = """
import os, sys, time
time.sleep(0.2)
rank = int(os.environ["ACCELERATE_PROCESS_ID"])
world = int(os.environ["ACCELERATE_NUM_PROCESSES"])
attempt = int(os.environ["ACCELERATE_FLEET_ATTEMPT"])
sys.exit(1 if (attempt == 0 and rank == world - 1) else 0)
"""

# name -> (worker, world, supervisor kwargs, seconds before a drain flag or
# None, JAX's bound on the run's seconds or None).  The drains come at 1.5 s
# (JAX's tests: 0.5 and 0.3): a worker must have installed its SIGTERM
# handler first, and four interpreters start at once here, beside other
# tests.
DRAIN_AT_S = 1.5
CASES = {
    "reaps_dead_worker": (_EXIT_CODE_WORKER, 3, dict(grace_s=2.0), None, 30),
    "detects_heartbeat_stall": (_STALL_WORKER, 2, dict(heartbeat_timeout_s=1.0, grace_s=2.0),
                                None, 30),
    "never_beat_not_judged_by_default": (
        "import sys, time; time.sleep(0.4); sys.exit(0)", 2, dict(heartbeat_timeout_s=0.1),
        None, None),
    "coordinated_drain": (_DRAIN_WORKER, 2, dict(drain_grace_s=20.0), DRAIN_AT_S, None),
    "drain_timeout_bounded": (_IGNORE_TERM_WORKER, 2, dict(drain_grace_s=1.0, grace_s=1.0),
                              DRAIN_AT_S, 30),
    "elastic_relaunch": (_ELASTIC_WORKER, 3, dict(grace_s=2.0, elastic=True, min_processes=2),
                         None, None),
    "elastic_respects_min_processes": (
        "import sys, time; time.sleep(0.2); sys.exit(3)", 2,
        dict(grace_s=1.0, elastic=True, min_processes=2), None, None),
    "postmortem_merges_all_ranks": (
        "import sys, time; time.sleep(0.2); sys.exit(9)", 2, dict(grace_s=1.0), None, None),
}

# name -> {rank: the code its worker exits with on its own}, for the cases
# whose workers end by themselves.  Such a rank ends at the moment the
# supervisor detects a sibling's failure, so either its own exit or the
# teardown's SIGTERM reaches it first: a race, not a verdict.  Where several
# ranks fail at once, which one a poll sees first is the same race.
SELF_EXITS = {
    "reaps_dead_worker": {0: 0, 1: 7, 2: 0},
    "elastic_relaunch": {0: 0, 1: 0, 2: 1},
    "elastic_respects_min_processes": {0: 3, 1: 3},
    "postmortem_merges_all_ranks": {0: 9, 1: 9},
}

EXPECTED = {  # tests/test_fleet.py's own assertions on the JAX side
    "reaps_dead_worker": dict(verdict="worker_dead", dead_rank=1, exit_code=7),
    "detects_heartbeat_stall": dict(verdict="wedged", wedged_rank=0),
    "never_beat_not_judged_by_default": dict(verdict="completed"),
    "coordinated_drain": dict(verdict="drained"),
    "drain_timeout_bounded": dict(verdict="drain_timeout"),
    "elastic_relaunch": dict(verdict="completed", world_size=2),
    "elastic_respects_min_processes": dict(verdict="worker_dead"),
    "postmortem_merges_all_ranks": dict(verdict="worker_dead"),
}


def _spawn_script(script):
    def spawn(rank, world, env_overrides):
        env = dict(os.environ)
        env.update(env_overrides)
        return subprocess.Popen([sys.executable, "-c", script], env=env,
                                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    return spawn


def _write_rank_streams(tdir):
    """The two streams of tests/test_fleet.py's postmortem case."""
    tdir.mkdir()
    (tdir / "telemetry_p0.jsonl").write_text(
        json.dumps({"kind": "event", "event": "step", "t": 1.0, "step": 4}) + "\n")
    (tdir / "flightrec_p1.jsonl").write_text(
        json.dumps({"kind": "crash", "t": 2.0, "proc": 1, "error": "boom"}) + "\n")


def _supervise(cls, name, tmp):
    script, world, kwargs, drain_at, _ = CASES[name]
    kwargs = dict(kwargs, poll_s=0.05)
    if name == "postmortem_merges_all_ranks":
        _write_rank_streams(tmp / "telemetry")
        kwargs["telemetry_dir"] = str(tmp / "telemetry")
    sup = cls(_spawn_script(script), world, workdir=str(tmp), **kwargs)
    if drain_at is not None:
        # The drain handler installs only on the main thread; both
        # supervisors run in threads, so the flag is set directly, as
        # tests/test_fleet.py does.
        threading.Timer(drain_at, lambda: setattr(sup, "_drain_signum", signal.SIGTERM)).start()
    t0 = time.monotonic()
    result = sup.run()
    result["took"] = time.monotonic() - t0
    return result


def _facts(name, result):
    """What the two packages must agree on.  A rank whose worker ends by
    itself (``SELF_EXITS``) reads "own exit or torn down" when its code is
    its own or a teardown signal; the failing rank named where several
    fail at once reads "a failing rank" (checked to be one)."""
    self_exits = SELF_EXITS.get(name, {})
    failing = {r for r, own in self_exits.items() if own}
    racy_dead = len(failing) > 1

    def code(rank, rc):
        own = self_exits.get(int(rank))
        if own is not None and rc in (own, -signal.SIGTERM, -signal.SIGKILL):
            return "own exit or torn down"
        return rc

    def dead(rank, rc=None):
        if rank is None or not racy_dead:
            return rank, rc
        assert rank in failing and rc in (None, self_exits[rank]), (rank, rc)
        return "a failing rank", None

    out = {"verdict": result["verdict"], "world_size": result["world_size"],
           "attempts": len(result["attempts"])}
    out["per_attempt"] = [
        {**{k: a[k] for k in ("attempt", "world_size", "verdict", "wedged_rank")},
         "dead": dead(a["dead_rank"], a["exit_code"]),
         "exit_codes": {r: code(r, rc) for r, rc in a["exit_codes"].items()}}
        for a in result["attempts"]]
    out["attempt_keys"] = [sorted(a) for a in result["attempts"]]
    if result["postmortem"]:
        with open(result["postmortem"]) as f:
            doc = json.load(f)
        out["postmortem"] = {
            "keys": sorted(doc), "cause": doc["cause"], "dead_rank": dead(doc["dead_rank"]),
            "world_size": doc["world_size"], "fleet_keys": sorted(doc["fleet"]),
            "n_ranks": doc["fleet"]["n_ranks"], "ranks": sorted(doc["fleet"]["ranks"])}
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_supervisor_case_matches_jax(name, tmp_path):
    results = {}

    def run(tag, cls):
        d = tmp_path / tag
        d.mkdir()
        try:
            results[tag] = _supervise(cls, name, d)
        except BaseException as exc:  # noqa: BLE001 - reported below
            results[tag] = exc

    threads = [threading.Thread(target=run, args=(tag, cls))
               for tag, cls in (("jax", JaxSupervisor), ("torch", TorchSupervisor))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
        assert not t.is_alive(), f"{name}: a supervisor did not return"
    for tag in ("jax", "torch"):
        assert not isinstance(results[tag], BaseException), (tag, results[tag])
    jax_res, torch_res = results["jax"], results["torch"]
    for key, value in EXPECTED[name].items():
        got = torch_res["attempts"][0][key] if key in ("dead_rank", "exit_code",
                                                       "wedged_rank") else torch_res[key]
        assert got == value, (key, got, value)
    assert _facts(name, torch_res) == _facts(name, jax_res)
    for attempt in torch_res["attempts"]:  # nothing leaked
        assert all(rc is not None for rc in attempt["exit_codes"].values()), attempt
    bound = CASES[name][4]
    if bound is not None:
        assert torch_res["took"] < bound, torch_res["took"]
    if name == "reaps_dead_worker":
        assert torch_res["attempts"][0]["teardown_s"] < 10
    if name == "elastic_relaunch":
        assert [a["verdict"] for a in torch_res["attempts"]] == ["worker_dead", "completed"]
        assert torch_res["attempts"][0]["dead_rank"] == 2
        assert torch_res["attempts"][1]["attempt"] == 1
    if name == "postmortem_merges_all_ranks":
        assert torch_res["postmortem"] and os.path.exists(torch_res["postmortem"])


def test_supervisor_names_the_signalled_rank_first(tmp_path):
    """gloo fails a survivor's collective on a dead peer's socket at once
    (where JAX's hang): when the killed rank and a survivor that exited
    with an error are seen in the same poll, the killed rank is named."""
    script = ("import os, signal, sys, time\n"
              "rank = int(os.environ['ACCELERATE_PROCESS_ID'])\n"
              "time.sleep(0.5)\n"
              "os.kill(os.getpid(), signal.SIGKILL) if rank == 1 else sys.exit(1)\n")
    sup = TorchSupervisor(_spawn_script(script), 2, workdir=str(tmp_path), poll_s=2.0,
                          grace_s=1.0)
    result = sup.run()
    attempt = result["attempts"][0]
    assert result["verdict"] == "worker_dead"
    assert (attempt["dead_rank"], attempt["exit_code"]) == (1, -9), attempt
    assert attempt["exit_codes"] == {0: 1, 1: -9}


# ---------------------------------------------------------------------------
# fleet.py primitives in one process
# ---------------------------------------------------------------------------


def test_fleet_noop_without_a_group():
    assert tfleet.fleet_client() is None
    tfleet.barrier("solo")
    assert tfleet.agree("solo", {"x": 1}) == [{"x": 1}] == jfleet.agree("solo", {"x": 1})


def test_fleet_key_sequencing_matches_jax():
    names = [("barrier", "round"), ("barrier", "round"), ("agree", "round"), ("agree", "other"),
             ("barrier", "round")]
    for package in (jfleet, tfleet):
        package._seq.clear()
    assert [tfleet._next_key(*n) for n in names] == [jfleet._next_key(*n) for n in names]
    assert tfleet._next_key("barrier", "round") == "fleet/barrier/round/3"


def test_heartbeat_round_trip_across_packages(tmp_path):
    path = tfleet.heartbeat_path(str(tmp_path), 3)
    assert path == jfleet.heartbeat_path(str(tmp_path), 3)
    hb = tfleet.Heartbeat(path)
    hb.beat(step=17)
    payload = jfleet.read_heartbeat(path)
    assert payload["step"] == 17 and payload["pid"] == os.getpid() and payload["beats"] == 0
    jfleet.Heartbeat(path).beat(step=18)
    assert tfleet.read_heartbeat(path)["step"] == 18
    assert sorted(tfleet.read_heartbeat(path)) == sorted(payload)
    assert tfleet.read_heartbeat(str(tmp_path / "absent.json")) is None


def test_maybe_beat_without_and_with_the_env(tmp_path, monkeypatch):
    monkeypatch.delenv(tfleet.ENV_HEARTBEAT_DIR, raising=False)
    assert tfleet.ENV_HEARTBEAT_DIR == jfleet.ENV_HEARTBEAT_DIR
    assert tfleet.maybe_beat(step=1) is False
    monkeypatch.setenv(tfleet.ENV_HEARTBEAT_DIR, str(tmp_path))
    monkeypatch.setenv("ACCELERATE_PROCESS_ID", "2")
    tfleet._reset_heartbeat_singleton()
    try:
        assert tfleet.maybe_beat(step=5) is True
        assert tfleet.read_heartbeat(tfleet.heartbeat_path(str(tmp_path), 2))["step"] == 5
    finally:
        tfleet._reset_heartbeat_singleton()


def test_check_preemption_beats_the_heartbeat(tmp_path, monkeypatch):
    """``Accelerator.check_preemption`` beats first, with the step."""
    from accelerate_tpu_torch import Accelerator, AcceleratorState

    monkeypatch.setenv(tfleet.ENV_HEARTBEAT_DIR, str(tmp_path))
    monkeypatch.setenv("ACCELERATE_PROCESS_ID", "0")
    tfleet._reset_heartbeat_singleton()
    AcceleratorState._reset_state(reset_partial_state=True)
    try:
        acc = Accelerator(cpu=True)
        assert acc.check_preemption(step=7) is False
        assert tfleet.read_heartbeat(tfleet.heartbeat_path(str(tmp_path), 0))["step"] == 7
    finally:
        tfleet._reset_heartbeat_singleton()
        AcceleratorState._reset_state(reset_partial_state=True)


@pytest.mark.parametrize("env", [{}, {"ACCELERATE_TPU_COORDINATOR_CONNECT_TRIES": "5"},
                                 {"ACCELERATE_TPU_COORDINATOR_CONNECT_TRIES": "0",
                                  "ACCELERATE_TPU_COORDINATOR_CONNECT_DEADLINE_S": "7.5"}],
                         ids=["defaults", "tries", "floor_and_deadline"])
def test_connect_retry_policy_env_matches_jax(env, monkeypatch):
    for key in ("ACCELERATE_TPU_COORDINATOR_CONNECT_TRIES",
                "ACCELERATE_TPU_COORDINATOR_CONNECT_DEADLINE_S"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got, want = tfleet.connect_retry_policy(), jfleet.connect_retry_policy()
    for attr in ("tries", "base_delay_s", "max_delay_s", "deadline_s", "label"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for exc in (ValueError("bad address"), TypeError("x"), RuntimeError("connection refused"),
                OSError("reset")):
        assert got.retryable(exc) == want.retryable(exc), exc


def test_fleet_report_matches_jax(tmp_path, capsys):
    """``python -m accelerate_tpu_torch.telemetry.report <dir> --fleet --json``
    on tests/test_fleet.py's rank-tagged directory, against JAX's summary."""
    from accelerate_tpu_torch.telemetry import report as treport

    (tmp_path / "telemetry_p0.jsonl").write_text("\n".join(json.dumps(r) for r in [
        {"kind": "event", "event": "step", "t": 10.0, "step": 1},
        {"kind": "event", "event": "step", "t": 30.0, "step": 3}]) + "\n")
    (tmp_path / "telemetry_p1.jsonl").write_text(
        json.dumps({"kind": "event", "event": "step", "t": 11.0, "step": 1}) + "\n")
    (tmp_path / "flightrec_p1.jsonl").write_text(
        json.dumps({"kind": "crash", "t": 12.0, "proc": 1, "error": "sigkill"}) + "\n")
    assert treport.main([str(tmp_path), "--fleet", "--json"]) in (0, None)
    out = json.loads(capsys.readouterr().out)
    want = j_summarize_fleet(j_load_fleet(str(tmp_path)))
    assert out["fleet"]["n_ranks"] == 2 and out["fleet"]["first_silent_rank"] == 1
    assert json.loads(json.dumps(out["fleet"])) == json.loads(json.dumps(want))


# ---------------------------------------------------------------------------
# Gloo worlds of CPU processes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    world = World(3, tmp_path_factory.mktemp("fleet_world3"), threads=1)
    yield world
    world.close()


def test_agree_returns_rank_ordered_values(world3):
    out = world3.run("torch_fleet_tasks:agree_twice", [4, 9, 16])
    for rec in out:
        assert rec["client"] is True
        assert rec["first"] == [4, 9, 16]
        assert rec["second"] == [{"rank": r, "sq": v * v} for r, v in enumerate([4, 9, 16])]


@pytest.mark.parametrize("primitive,absent", [("barrier", 2), ("agree", 1), ("barrier", 0),
                                              ("agree", 0)])
def test_missing_rank_raises_within_the_deadline(world3, primitive, absent):
    timeout_s = 1.5
    out = world3.run("torch_fleet_tasks:absent_rank", primitive, absent, timeout_s)
    for rec in out:
        if rec["rank"] == absent:
            continue
        assert rec["error"] == "FleetError", rec
        assert timeout_s * 0.9 <= rec["took"] <= timeout_s + DEADLINE_SLACK_S, rec


def test_sigterm_to_one_rank_stops_every_rank_on_the_same_call(world3):
    out = world3.run("torch_fleet_tasks:drain_over_the_store", 1, 4)
    assert [rec["answers"] for rec in out] == [[False, True, True, True]] * 3
    assert all(rec["client"] for rec in out)
    assert [rec["local"] for rec in out] == [False, True, False]


@pytest.mark.parametrize("store", ["tcp", "file"])
def test_rank0_gone_raises_within_the_deadline(store, tmp_path):
    """Forked ranks join over a store that is kept for the fleet: the
    ``TCPStore`` ``PartialState`` builds (rank 0 hosts it) or
    ``join_group``'s ``FileStore``; rank 0's process exits, and the others'
    ``agree`` and ``barrier`` raise ``FleetError`` within the deadline plus
    5 s."""
    from accelerate_tpu_torch.launchers import _free_port
    from accelerate_tpu_torch.parallel import launch

    world, timeout_s = 3, 2.0
    init = (f"tcp://127.0.0.1:{_free_port()}" if store == "tcp"
            else f"file://{tmp_path / 'store'}")
    outs = [str(tmp_path / f"rank{r}.json") for r in range(world)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "tests"), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    job = launch.start(
        "torch_fleet_tasks",
        lambda r: [json.dumps([r, world, init, timeout_s, outs[r]])], world, env=env,
        capture=True)
    results = job.wait(90)
    assert [code for code, _, _ in results] == [0] * world, [r[2][-2000:] for r in results]
    for r in range(1, world):
        with open(outs[r]) as f:
            rec = json.load(f)
        assert rec["kept"] is True
        for primitive in ("agree", "barrier"):
            assert rec[primitive] is not None and "did not complete" in rec[primitive], rec
            assert rec[f"{primitive}_s"] <= timeout_s + DEADLINE_SLACK_S, rec


# ---------------------------------------------------------------------------
# The campaign
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(10))
def test_plan_fleet_campaign_matches_jax(seed):
    assert tchaos.plan_fleet_campaign(seed) == jchaos.plan_fleet_campaign(seed)


def test_campaign_constants_match_jax():
    for name in ("WORLD", "TOTAL_STEPS", "GLOBAL_BATCH", "WEDGE_SLEEP_S", "HEARTBEAT_TIMEOUT_S",
                 "GRACE_S", "ARM_TIMEOUT_S"):
        assert getattr(tchaos, name) == getattr(jchaos, name), name


def test_campaign_sigkill_and_elastic_arms_at_world_two(tmp_path, monkeypatch):
    """The reference arm (the digests' oracle), the sigkill arm and the
    elastic arm (2 -> 1 ranks) at world 2 on the CPU, with every JAX
    assertion of theirs."""
    monkeypatch.setattr(tchaos, "WORLD", 2)
    plan = tchaos.plan_fleet_campaign(0)
    total = plan["total_steps"]
    _, ref_digests = tchaos._reference_arm(str(tmp_path), total, "cpu")
    kill = tchaos._sigkill_arm(str(tmp_path), total, plan["sigkill"]["rank"],
                               plan["sigkill"]["step"], "cpu")
    assert kill["dead_rank"] == 1 and kill["teardown_s"] <= tchaos.GRACE_S + 15.0
    elastic = tchaos._elastic_arm(str(tmp_path), total, plan["elastic"]["rank"],
                                  plan["elastic"]["step"], ref_digests, "cpu")
    assert elastic["final_world"] == 1


@pytest.mark.slow
def test_fleet_chaos_campaign(tmp_path):
    """The full 4-process campaign on the CPU: SIGKILL, coordinated drain,
    wedge, elastic 4->3 restart with a bit-identical resume digest."""
    res = subprocess.run(
        [sys.executable, "-m", "accelerate_tpu_torch.resilience.chaos", "--mode", "fleet",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=900, cwd=str(REPO))
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-4000:])
    assert "fleet-chaos-smoke OK" in res.stdout
