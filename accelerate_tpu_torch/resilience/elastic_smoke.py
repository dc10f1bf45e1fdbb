"""Elastic-resume smoke: a checkpoint lands on other meshes and world sizes
with bit-identical state, then keeps training.

The JAX package's ``resilience/elastic_smoke.py`` in the port.  The parent
starts each **life** as a fresh world of processes (one per rank, one gloo
group, through :mod:`..parallel.launch`) and asserts over their records.

``--size tiny`` (default; the JAX smoke, on the chaos campaign's recipe):

1. **saver** — ``dp8-zero`` (8 ranks, the ZeRO sharded update), 4 steps,
   a verified checkpoint with its topology record after each, and the
   state digest (:func:`~.elastic.state_digest`) after each save;
2. **resumers** — fresh worlds on ``dp4`` (half the ranks), ``dp2-fsdp2``
   (the dp axis refactored into dp x fsdp, parameters sharded) and ``dp8``
   (the same mesh, ZeRO off): each post-load digest BIT-IDENTICAL to the
   saver's step-4 digest, a reported reshard where the mesh changed, then 4
   more steps with finite losses.

``--size llama3.2-1b`` (the chip check's Phase 20a): Llama-3.2-1B's
published widths at 2 of 16 layers (fp32 masters, bf16 compute, ``remat``,
the fused attention kernels), AdamW through ``make_train_step`` with the
binding clip, one row of 2048 tokens a rank a step from a seed:

- life 1, 2 ranks on ``dp=2`` with ZeRO, 2 steps: after step 1 an
  asynchronous save (step 2 runs while it writes, then
  ``wait_for_checkpoint``), after step 2 a synchronous one, the digest after
  each;
- life 2, one process: resumes life 1's last checkpoint (2 -> 1 ranks), its
  digest bit-identical to life 1's step-2 digest and a reported reshard,
  then a step;
- life 3 (beside life 2), 2 ranks on ``fsdp=2`` under the plugin's default
  ``SHARDED_STATE_DICT``: resumes the same checkpoint (consolidated ->
  sharded layout, digest equal), a step, a sharded save (each rank writes its
  own shards) and its digest, then a ``LOCAL_STATE_DICT`` save into another
  directory, reloaded in the same life with the digest equal;
- life 4, 2 ranks on ``dp=2`` without ZeRO: resumes life 3's sharded save
  (digest equal to life 3's), loading life 3's local save raises the
  topology-bound error, then a step.

Every step's loss is finite and, on the card, launches the flash forward,
dQ and dK/dV kernels 2L / L / L times a rank.  Each life logs its save and
load seconds by part, its bytes on disk and its time.

Run::

    python -m accelerate_tpu_torch.resilience.elastic_smoke --device cpu
    python -m accelerate_tpu_torch.resilience.elastic_smoke --size llama3.2-1b   # the card

Exit code 0 only when every requirement holds; the last line is the JSON
summary.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Optional

SAVE_STEPS = 4
RESUME_STEPS = 4
SIZES = ("tiny", "llama3.2-1b")
SEQ = 2048
LAYERS = 2
CLIP = 0.05
FLASH = ("fused_attention_fwd", "fused_attention_bwd_dq", "fused_attention_bwd_dkv")
CHILD_TIMEOUT_S = 600.0
# The four lives of the llama3.2-1b size: ranks, mesh, ZeRO, FSDP plugin.
LLAMA_LIVES = (
    {"life": 1, "world": 2, "mesh": {"dp": 2}, "zero": True, "fsdp": False},
    {"life": 2, "world": 1, "mesh": {}, "zero": False, "fsdp": False},
    {"life": 3, "world": 2, "mesh": {"fsdp": 2}, "zero": False, "fsdp": True},
    {"life": 4, "world": 2, "mesh": {"dp": 2}, "zero": False, "fsdp": False},
)


def require(ok: bool, message: str) -> None:
    """Raise ``AssertionError(message)`` unless ``ok`` (also under ``-O``)."""
    if not ok:
        raise AssertionError(message)


# ---------------------------------------------------------------------------
# tiny: the JAX smoke
# ---------------------------------------------------------------------------


def run_tiny(device=None, workdir: Optional[str] = None) -> dict:
    """The JAX smoke's saver and three resumers on the chaos recipe."""
    from .chaos import spawn_life
    from .manifest import find_latest_complete, read_manifest

    work = workdir or tempfile.mkdtemp(prefix="atpu_elastic_smoke_")
    root = os.path.join(work, "ckpts")
    os.makedirs(root, exist_ok=True)
    print(f"# elastic-smoke: saver (dp8-zero, {SAVE_STEPS} steps)", file=sys.stderr)
    saver = spawn_life(root, os.path.join(work, "saver.json"), "dp8-zero", SAVE_STEPS,
                       device=device)
    require(saver["death"] == "completed" and saver["last_step"] == SAVE_STEPS, str(saver))
    saved_digest = saver["digests"][str(SAVE_STEPS)]
    ckpt = find_latest_complete(os.path.join(root, "checkpoints"))
    require(ckpt is not None, "saver left no complete checkpoint")
    topology = (read_manifest(ckpt) or {}).get("topology")
    require(topology is not None, "saved manifest carries no topology record")
    require(topology["parallelism"] == {"dp": 8}, str(topology["parallelism"]))
    require(topology["optimizers"][0]["layout"]["kind"] == "zero",
            str(topology["optimizers"][0]["layout"]))
    total = SAVE_STEPS + RESUME_STEPS
    resumes = {}
    for topo, expect_reshard in (("dp4", True), ("dp2-fsdp2", True), ("dp8", False)):
        print(f"# elastic-smoke: resume on {topo}", file=sys.stderr)
        rec = spawn_life(root, os.path.join(work, f"resume_{topo}.json"), topo, total,
                         save_every=False, device=device)
        require(rec["resumed_at"] == SAVE_STEPS, f"{topo}: resumed at {rec['resumed_at']}")
        require(rec["loaded_digest"] == saved_digest,
                f"{topo}: loaded state digest {rec['loaded_digest'][:16]} != saved "
                f"{saved_digest[:16]} — the relayout corrupted a leaf")
        require(rec["resharded"] is expect_reshard, f"{topo}: resharded {rec['resharded']}")
        require(rec["death"] == "completed" and rec["last_step"] == total, str(rec))
        post = [rec["losses"][str(s)] for s in range(SAVE_STEPS + 1, total + 1)]
        require(len(post) == RESUME_STEPS and all(math.isfinite(v) for v in post), str(post))
        resumes[topo] = {"world": rec["world"], "mesh": rec["mesh"], "losses": post}
    print(f"elastic-smoke OK — dp8(ZeRO) checkpoint at step {SAVE_STEPS} resumed "
          f"bit-identically on dp4, dp2x fsdp2 and ZeRO-off meshes, each running "
          f"{RESUME_STEPS} further steps", file=sys.stderr)
    return {"size": "tiny", "digest": saved_digest, "resumes": resumes}


# ---------------------------------------------------------------------------
# llama3.2-1b: Phase 20a's lives
# ---------------------------------------------------------------------------


def llama_config():
    """Llama-3.2-1B's published widths at ``LAYERS`` of 16 layers: fp32
    masters, bf16 compute, ``remat``, the fused attention kernels."""
    import torch

    from ..models import llama

    return llama.LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_layers=LAYERS,
        num_heads=32, num_kv_heads=8, head_dim=64, tie_embeddings=True, rope_theta=500000.0,
        rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192), dtype=torch.bfloat16,
        param_dtype=torch.float32, remat=True, attention_impl="pallas")


def _rows(step: int, world: int, vocab: int):
    """Step ``step``'s global batch: ``world`` rows of ``SEQ`` tokens from
    seed ``step`` (numpy)."""
    import numpy as np

    return np.random.default_rng(100 + step).integers(0, vocab, size=(world, SEQ))


def _flash_counts() -> dict:
    from ..ops import fused_attention as fu

    return {name: getattr(fu, name).launches for name in FLASH}


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bytes_on_disk(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, n)) for d, _, names in os.walk(path)
               for n in names)


def _build_llama(spec: dict, device: str):
    import torch

    from ..accelerator import Accelerator
    from ..models import llama
    from ..state import AcceleratorState
    from ..utils.dataclasses import FullyShardedDataParallelPlugin, ParallelismConfig

    AcceleratorState._reset_state(reset_partial_state=True)
    kw = {}
    if spec["mesh"]:
        kw["parallelism_config"] = ParallelismConfig(**spec["mesh"])
    if spec["fsdp"]:
        kw["fsdp_plugin"] = FullyShardedDataParallelPlugin()  # SHARDED_STATE_DICT
    acc = Accelerator(device=device, mixed_precision="bf16", **kw)
    cfg = llama_config()
    model = llama.LlamaForCausalLM(cfg, seed=7 * acc.process_index + spec["life"],
                                   device=acc.device)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-5, weight_decay=1e-4)
    model, opt = acc.prepare(model, opt)
    step = acc.make_train_step(model, opt, clip_norm=CLIP, zero=spec["zero"])
    return acc, model, opt, step, cfg


def _train(acc, step_fn, cfg, start: int, n: int, rec: dict) -> None:
    """``n`` steps from ``start``; each step's loss, its flash launches and
    its seconds go into ``rec``."""
    import torch

    from ..parallel.mesh import data_degree, data_index

    dev = acc.device
    world, k = data_degree(acc.mesh), data_index(acc.mesh)
    for i in range(start, start + n):
        row = torch.from_numpy(_rows(i, world, cfg.vocab_size)[k:k + 1]).to(dev)
        before = _flash_counts()
        _sync(dev)
        t0 = time.perf_counter()
        loss = float(step_fn({"input_ids": row}))
        _sync(dev)
        rec["step_s"].append(time.perf_counter() - t0)
        after = _flash_counts()
        rec["launches"].append({n_: after[n_] - before[n_] for n_ in FLASH})
        rec["losses"].append(loss)


def _timed_save(acc, path: str, step: int, rec: dict, tag: str, **kw) -> None:
    t0 = time.perf_counter()
    acc.save_state(path, step=step, **kw)
    rec["save"][tag] = dict(acc.last_save_timing, call_s=time.perf_counter() - t0)


def _timed_resume(acc, root: str, rec: dict) -> int:
    t0 = time.perf_counter()
    resumed = acc.resume_from_latest(root)
    info = acc.last_resume_info
    rec["load"] = dict(acc.last_load_timing, call_s=time.perf_counter() - t0)
    rec["resumed_at"] = resumed
    rec["resharded"] = bool(info is not None and info.resharded)
    rec["changes"] = list(info.plan.changes) if info is not None and info.plan else []
    return resumed


def llama_life(life: int, work: str, device: str, after: Optional[str] = None) -> dict:
    """One rank of life ``life`` (see the module docstring); its record.
    ``after``: the go file the parent writes once the life it resumes from
    has ended, waited for after the build."""
    from ..parallel.launch import wait_for_file
    from .elastic import state_digest

    spec = LLAMA_LIVES[life - 1]
    t_life = time.perf_counter()
    acc, model, opt, step_fn, cfg = _build_llama(spec, device)
    t_built = time.perf_counter()
    wait_s = wait_for_file(after, CHILD_TIMEOUT_S) if after is not None else 0.0
    digest_s = []

    def digest() -> str:
        t0 = time.perf_counter()
        out = state_digest(acc)
        digest_s.append(time.perf_counter() - t0)
        return out

    rec = {"life": life, "rank": acc.process_index, "world": acc.num_processes,
           "mesh": {a: s for a, s in acc.mesh.shape.items() if s > 1}, "zero": spec["zero"],
           "losses": [], "launches": [], "step_s": [], "save": {}, "digests": {},
           "bytes": {}, "device": str(acc.device)}
    root1 = os.path.join(work, "life1", "checkpoints")
    root3 = os.path.join(work, "life3", "checkpoints")
    local3 = os.path.join(work, "life3_local", "checkpoint_0")
    rec["build_s"] = t_built - t_life
    if life == 1:
        _train(acc, step_fn, cfg, 0, 1, rec)
        _timed_save(acc, os.path.join(root1, "checkpoint_0"), 1, rec, "async", async_save=True)
        rec["digests"]["async"] = digest()
        _train(acc, step_fn, cfg, 1, 1, rec)  # runs while the write is in flight
        t0 = time.perf_counter()
        acc.wait_for_checkpoint()
        rec["save"]["async"]["wait_s"] = time.perf_counter() - t0
        rec["save"]["async"].update(acc.last_save_timing)
        _timed_save(acc, os.path.join(root1, "checkpoint_1"), 2, rec, "sync")
        rec["digests"]["sync"] = digest()
        rec["bytes"] = {"async": _bytes_on_disk(os.path.join(root1, "checkpoint_0")),
                        "sync": _bytes_on_disk(os.path.join(root1, "checkpoint_1"))}
    elif life in (2, 3):
        resumed = _timed_resume(acc, root1, rec)
        rec["digests"]["loaded"] = digest()
        _train(acc, step_fn, cfg, resumed, 1, rec)
        if life == 3:
            _timed_save(acc, os.path.join(root3, "checkpoint_0"), resumed + 1, rec, "sharded")
            rec["digests"]["sharded"] = digest()
            acc.state.fsdp_plugin.state_dict_type = "LOCAL_STATE_DICT"
            _timed_save(acc, local3, resumed + 1, rec, "local")
            t0 = time.perf_counter()
            acc.load_state(local3)
            rec["local_load_s"] = time.perf_counter() - t0
            rec["digests"]["local_reloaded"] = digest()
            rec["bytes"] = {"sharded": _bytes_on_disk(os.path.join(root3, "checkpoint_0")),
                            "local": _bytes_on_disk(local3)}
            rec["files"] = sorted(os.listdir(os.path.join(root3, "checkpoint_0", "model_orbax")))
    else:
        resumed = _timed_resume(acc, root3, rec)
        rec["digests"]["loaded"] = digest()
        try:
            acc.load_state(local3)
            rec["local_refused"] = None
        except RuntimeError as e:
            rec["local_refused"] = str(e)
        _train(acc, step_fn, cfg, resumed, 1, rec)
    rec["life_s"] = time.perf_counter() - t_life - wait_s
    rec["wait_s"] = wait_s
    rec["digest_s"] = digest_s
    if device.startswith("cuda"):
        import torch

        rec["peak_bytes"] = torch.cuda.max_memory_allocated(acc.device)
    return rec


def _llama_child(rank: int, world: int, init: str, device: str, life: int, work: str,
                 out: str, after: Optional[str] = None) -> None:
    import torch.distributed as dist

    from ..parallel.launch import join_group

    t_entry = time.time()
    join_group(rank, world, init, "gloo", device)
    t_joined = time.time()
    try:
        rec = llama_life(life, work, device, after)
        if dist.is_initialized():
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    rec["clock"] = {"entry": t_entry, "joined": t_joined, "done": time.time()}
    with open(out, "w") as f:
        json.dump(rec, f)


def run_llama(device=None, workdir: Optional[str] = None) -> dict:
    """Phase 20a's four lives; every requirement checked; the summary (each
    life's records, rank by rank, and the seconds from the start to each
    life's end)."""
    from ..parallel import launch
    from ..state import resolve_device

    dev = resolve_device(device)
    work = workdir or tempfile.mkdtemp(prefix="atpu_elastic_smoke_")
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ)
    # Unsynced writes and manifests of sizes only: the state digest is the
    # oracle of every handoff here.
    env.setdefault("ACCELERATE_TPU_CHECKPOINT_FSYNC", "0")
    env.setdefault("ACCELERATE_TPU_MANIFEST_HASH", "0")
    # Every life starts at once: each builds its model, then waits for the
    # go file of the life whose checkpoint it resumes (lives 2 and 3 both
    # resume life 1's, life 4 life 3's), which the parent writes once that
    # life's processes have exited.
    jobs, outs_of, go = [], [], [os.path.join(work, f"go_life{s['life']}") for s in LLAMA_LIVES]
    t0 = time.perf_counter()
    spawned = time.time()
    try:
        for k, spec in enumerate(LLAMA_LIVES):
            world = spec["world"]
            init = launch.rendezvous(work)
            _, devices = launch.devices_for(dev, world, "gloo")
            outs = [os.path.join(work, f"life{spec['life']}_rank{r}.json") for r in range(world)]
            after = {1: None, 2: go[0], 3: go[0], 4: go[2]}[spec["life"]]
            print(f"# elastic-smoke: life {spec['life']}, {world} rank(s), mesh {spec['mesh']}, "
                  f"zero {spec['zero']}, fsdp {spec['fsdp']}", file=sys.stderr)
            jobs.append(launch.start(
                "accelerate_tpu_torch.resilience.elastic_smoke",
                lambda r, world=world, init=init, devices=devices, spec=spec, outs=outs,
                after=after: ["--child", json.dumps([r, world, init, devices[r], spec["life"],
                                                     work, outs[r], after])],
                world, env=env))
            outs_of.append(outs)
        lives, walls = [], []
        for k, (spec, job, outs) in enumerate(zip(LLAMA_LIVES, jobs, outs_of)):
            codes = [c for c, _, _ in job.wait(CHILD_TIMEOUT_S)]
            ended = time.time()
            walls.append(time.perf_counter() - t0)
            require(codes == [0] * spec["world"],
                    f"elastic-smoke life {spec['life']} exited {codes}")
            recs = []
            for out in outs:
                with open(out) as f:
                    recs.append(json.load(f))
            for rec in recs:
                c = rec.pop("clock")
                rec["start_s"] = c["entry"] - spawned  # interpreter and imports
                rec["join_s"] = c["joined"] - c["entry"]
                rec["exit_s"] = ended - c["done"]  # teardown and process exit
            lives.append(recs)
            with open(go[k], "w"):
                pass
    finally:
        for job in jobs:
            job.kill()
    return check_llama(lives, walls, dev.type == "cuda")


def check_llama(lives: list, walls: list, on_card: bool) -> dict:
    """The requirements over the four lives' records; the summary."""
    life1, life2, life3, life4 = lives
    per_step = {"fused_attention_fwd": 2 * LAYERS, "fused_attention_bwd_dq": LAYERS,
                "fused_attention_bwd_dkv": LAYERS}
    totals = dict.fromkeys(FLASH, 0)
    for recs in lives:
        for rec in recs:
            require(all(math.isfinite(v) for v in rec["losses"]),
                    f"life {rec['life']} rank {rec['rank']}: losses {rec['losses']}")
            for s in rec["launches"]:
                for k in FLASH:
                    totals[k] += s[k]
                if on_card:
                    require(s == per_step, f"life {rec['life']} rank {rec['rank']}: flash "
                                           f"launches {s}, want {per_step}")
        require(len({json.dumps(r["digests"], sort_keys=True) for r in recs}) == 1,
                f"life {recs[0]['life']}: the ranks' digests differ")
    d1 = life1[0]["digests"]
    require(life1[0]["losses"] == life1[1]["losses"] and len(life1[0]["losses"]) == 2,
            f"life 1: losses {[r['losses'] for r in life1]}")
    require(d1["async"] != d1["sync"], "life 1: the step after the async save changed nothing")
    for life, recs in ((2, life2), (3, life3)):
        rec = recs[0]
        require(rec["resumed_at"] == 2, f"life {life}: resumed at {rec['resumed_at']}")
        require(rec["digests"]["loaded"] == d1["sync"],
                f"life {life}: loaded digest {rec['digests']['loaded'][:16]} != life 1's "
                f"step-2 digest {d1['sync'][:16]}")
        require(rec["resharded"], f"life {life}: no reshard reported ({rec['changes']})")
    d3 = life3[0]["digests"]
    require(d3["local_reloaded"] == d3["sharded"],
            "life 3: the LOCAL_STATE_DICT reload changed the state")
    require(all(f"rank{r}.safetensors" in life3[0]["files"] for r in range(2)),
            f"life 3: sharded files {life3[0]['files']}")
    rec4 = life4[0]
    require(rec4["resumed_at"] == 3 and rec4["digests"]["loaded"] == d3["sharded"],
            f"life 4: resumed at {rec4['resumed_at']}, digest {rec4['digests']['loaded'][:16]} "
            f"!= life 3's {d3['sharded'][:16]}")
    require(rec4["resharded"], f"life 4: no reshard reported ({rec4['changes']})")
    for rec in life4:
        require(rec["local_refused"] is not None
                and "LOCAL_STATE_DICT shard layout mismatch" in rec["local_refused"],
                f"life 4 rank {rec['rank']}: the local save loaded ({rec['local_refused']})")
    summary = {"size": "llama3.2-1b", "layers": LAYERS, "seq": SEQ, "launches": totals,
               "walls": walls,
               "lives": [{k: recs[0][k] for k in recs[0] if k != "digests"} for recs in lives],
               "digests": {"life1": d1, "life2": life2[0]["digests"], "life3": d3,
                           "life4": rec4["digests"]},
               "local_refused": rec4["local_refused"]}
    print("elastic-smoke OK — llama3.2-1b: dp2+ZeRO checkpoint resumed bit-identically "
          "on 1 process and on fsdp=2 (SHARDED_STATE_DICT), the sharded save on dp=2; the "
          "local save refused on another layout", file=sys.stderr)
    return summary


def run(size: str = "tiny", device=None, workdir: Optional[str] = None) -> dict:
    if size not in SIZES:
        raise ValueError(f"size must be one of {SIZES}, got {size!r}")
    return run_tiny(device, workdir) if size == "tiny" else run_llama(device, workdir)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.resilience.elastic_smoke")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("--size", choices=SIZES, default="tiny")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child is not None:
        _llama_child(*json.loads(args.child))
        return 0
    keep = args.workdir is not None
    work = args.workdir or tempfile.mkdtemp(prefix="atpu_elastic_smoke_")
    try:
        summary = run(args.size, args.device, work)
    finally:
        if not keep:
            shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
