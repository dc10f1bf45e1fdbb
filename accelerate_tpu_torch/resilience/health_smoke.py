"""Health smoke: NaN-poison a training run, prove skip, rewind, and that the
fused step's work is unchanged while injecting.

The port of the JAX package's ``resilience/health_smoke.py``:
``python -m accelerate_tpu_torch.resilience.health_smoke`` (a tiny llama
on the card; ``--device cpu`` on the CPU) or ``... --size llama3-8b`` (the recipe of
:mod:`.smoke`: Llama-3-8B's widths cut to one layer, the flash kernels in
every step).  The parent orchestrates three child processes sharing one
fused-train-step recipe:

1. **skip** — ``ACCELERATE_TPU_FAULT_NAN_STEP=4`` poisons step 4's gradients;
   the on-device health gate applies a zero delta and the ``HealthGuard``
   absorbs it (``max_skips=3``).  The parameters' digest is IDENTICAL
   across the poisoned step, the next clean step moves them again, and the
   step's counted dispatches (``pipeline.dispatches``, one per step) are
   unchanged with the guard enabled and the injector armed.
2. **rewind** — ``NAN_STEP=4``/``NAN_COUNT=3`` poisons steps 4-6 with
   ``max_skips=2``: steps 4 and 5 are skipped, the third consecutive anomaly
   at step 6 triggers a rewind to the verified checkpoint saved at step 2.
   The injector fires once per armed step, so the replay of steps 3-8 runs
   clean; their losses are recorded.
3. **resume** — a fresh, uninjected process resumes from the same checkpoint
   and trains to step 8.

The parent asserts the rewind child's post-rewind losses are BIT-EXACT equal
to the clean resume's for every step 3-8, and that every step of the armed
skip run launched the flash kernels as often, and set
``pipeline.dispatches_per_step`` to the same value, as the unarmed resume's
steps.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from .smoke import SIZES, build, child, flash_launches, params_digest, step_metrics

STEPS = 8
NAN_STEP = 4
CKPT_STEP = 2


def _train(role: str, ckpt_root: str, out_path: str, size: str, device: str) -> int:
    import json

    from .. import telemetry

    tel = telemetry.enable(dir=tempfile.mkdtemp(prefix="atpu_health_smoke_tel_"))
    accelerator, model, opt, dl = build(size, device)
    accelerator.enable_health_guard(
        max_skips=3 if role == "skip" else 2,
        max_rewinds=2,
        checkpoint_dir=ckpt_root,
    )
    step_fn = accelerator.make_train_step(model, opt)
    dispatches = tel.registry.counter("pipeline.dispatches")

    global_step = 0
    saves, loads = [], []
    if role == "resume":
        t0 = time.perf_counter()
        resumed = accelerator.resume_from_latest(ckpt_root)
        loads.append(dict({k: round(float(v), 3)
                           for k, v in (accelerator.last_load_timing or {}).items()},
                          total_s=round(time.perf_counter() - t0, 3)))
        assert resumed == CKPT_STEP, f"resume landed on {resumed}, wanted {CKPT_STEP}"
        global_step = resumed

    losses: dict = {}
    steps: dict = {}
    digests: dict = {global_step: params_digest(model)}
    skipped: list = []
    rewound_at = None
    resumed_step = None
    step_calls = 0
    while global_step < STEPS:
        restart = False
        for batch in dl:
            before = flash_launches()
            loss = step_fn(batch)
            step_calls += 1
            t0 = time.perf_counter()
            verdict = accelerator.check_health(step=global_step + 1)
            if verdict.rewound:
                loads.append(dict({k: round(float(v), 3)
                                   for k, v in (accelerator.last_load_timing or {}).items()},
                                  total_s=round(time.perf_counter() - t0, 3)))
                rewound_at = global_step + 1
                resumed_step = verdict.resumed_step
                # Drop first-pass records past the rewind point: the replay
                # re-records them (and must match a clean resume bit-exactly).
                losses = {s: v for s, v in losses.items() if int(s) <= resumed_step}
                global_step = resumed_step
                restart = True
                break
            global_step += 1
            losses[str(global_step)] = float(loss)
            steps[str(global_step)] = step_metrics(tel, before)
            digests[global_step] = params_digest(model)
            if verdict.skipped:
                skipped.append(global_step)
            if role == "rewind" and global_step == CKPT_STEP and rewound_at is None:
                accelerator.save_state(os.path.join(ckpt_root, f"step_{CKPT_STEP}"),
                                       step=CKPT_STEP)
                t = accelerator.last_save_timing
                saves.append({k: round(float(v), 3) for k, v in t.items() if k.endswith("_s")})
            if global_step >= STEPS:
                break
        if restart:
            continue

    out = {
        "losses": losses,
        "steps": steps,
        "launches": flash_launches(),
        "skipped": skipped,
        "rewound_at": rewound_at,
        "resumed_step": resumed_step,
        "dispatches": dispatches.value,
        "step_calls": step_calls,
        "saves": saves,
        "loads": loads,
        "counters": {name: tel.registry.counter(name).value for name in (
            "health.nonfinite_grads", "health.skipped_steps", "health.rewinds")},
        "digests": {str(k): v for k, v in digests.items()},
        "params_identical_across_skip": (
            digests.get(NAN_STEP) == digests.get(NAN_STEP - 1) if role == "skip" else None
        ),
        "params_moved_after_skip": (
            digests.get(NAN_STEP + 1) != digests.get(NAN_STEP) if role == "skip" else None
        ),
    }
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def _child(role: str, ckpt_root: str, out_path: str, size: str, device: str,
           extra_env: dict) -> dict:
    args = ["--role", role, "--ckpt-root", ckpt_root, "--out", out_path,
            "--size", size, "--device", device]
    return child("accelerate_tpu_torch.resilience.health_smoke", args, out_path, extra_env)


def run(size: str = "tiny", device: Optional[str] = None,
        workdir: Optional[str] = None) -> dict:
    """The three lives and every assertion; returns a summary.  ``device``
    ``None`` is the card (raising without CUDA); ``"cpu"`` asks for the
    CPU."""
    from ..state import resolve_device

    device = str(resolve_device(device))
    work = workdir or tempfile.mkdtemp(prefix="atpu_health_smoke_")
    os.makedirs(work, exist_ok=True)
    unarmed = {"ACCELERATE_TPU_FAULT_NAN_STEP": "", "ACCELERATE_TPU_FAULT_NAN_COUNT": ""}

    print(f"# health-smoke: skip run (NaN grads at step {NAN_STEP})", file=sys.stderr)
    skip = _child("skip", os.path.join(work, "skip_ckpts"), os.path.join(work, "skip.json"),
                  size, device, {"ACCELERATE_TPU_FAULT_NAN_STEP": str(NAN_STEP),
                                 "ACCELERATE_TPU_FAULT_NAN_COUNT": ""})
    assert skip["skipped"] == [NAN_STEP], f"expected skip at {NAN_STEP}: {skip['skipped']}"
    assert skip["params_identical_across_skip"] is True, "poisoned step mutated params"
    assert skip["params_moved_after_skip"] is True, "post-skip clean step applied no update"
    # One counted dispatch per optimizer-step call, guard enabled + injector armed.
    assert skip["dispatches"] == skip["step_calls"] == STEPS, (
        f"fused step dispatch count broke with the guard on: {skip['dispatches']} "
        f"dispatches over {skip['step_calls']} calls"
    )

    ckpt_root = os.path.join(work, "rewind_ckpts")
    print(
        f"# health-smoke: rewind run (NaN grads at steps {NAN_STEP}-{NAN_STEP + 2}, "
        f"max_skips=2, checkpoint at step {CKPT_STEP})",
        file=sys.stderr,
    )
    rewind = _child("rewind", ckpt_root, os.path.join(work, "rewind.json"), size, device,
                    {"ACCELERATE_TPU_FAULT_NAN_STEP": str(NAN_STEP),
                     "ACCELERATE_TPU_FAULT_NAN_COUNT": "3"})
    assert rewind["rewound_at"] == NAN_STEP + 2, rewind["rewound_at"]
    assert rewind["resumed_step"] == CKPT_STEP, rewind["resumed_step"]
    assert rewind["skipped"] == [NAN_STEP, NAN_STEP + 1], rewind["skipped"]

    from .manifest import find_latest_complete, verify_checkpoint

    ckpt = find_latest_complete(ckpt_root)
    assert ckpt is not None, f"no manifest-complete checkpoint under {ckpt_root}"
    print("# health-smoke: clean resume run (fresh process)", file=sys.stderr)
    # The resume starts while this process verifies the checkpoint (the
    # resume verifies it again before it loads).
    with ThreadPoolExecutor(1) as pool:
        resuming = pool.submit(_child, "resume", ckpt_root, os.path.join(work, "resume.json"),
                               size, device, unarmed)
        manifest = verify_checkpoint(ckpt)  # raises on torn/corrupt
        resume = resuming.result()
    assert manifest["step"] == CKPT_STEP, manifest
    assert resume["skipped"] == [] and resume["rewound_at"] is None, resume

    post = [str(s) for s in range(CKPT_STEP + 1, STEPS + 1)]
    assert len(post) >= 3, "need >= 3 post-rewind steps for the continuation proof"
    for s in post:
        re_loss, cl_loss = rewind["losses"][s], resume["losses"][s]
        assert re_loss == cl_loss, (
            f"post-rewind loss diverged at step {s}: rewind {re_loss!r} != "
            f"clean resume {cl_loss!r}"
        )
    # The armed skip run's steps do the unarmed steps' work: the same flash
    # launches and the same counted dispatches, the poisoned step included.
    want = resume["steps"][post[-1]]
    for s, got in skip["steps"].items():
        assert got == want, f"armed step {s}: {got} != the unarmed run's {want}"
    print(
        f"health-smoke OK — step {NAN_STEP} skipped with identical params and "
        f"{skip['dispatches']}/{STEPS} dispatches (1/step, {want['launches']} flash launches "
        f"per step armed and unarmed), 3x-NaN run rewound to step {CKPT_STEP} and replayed "
        f"steps {post[0]}..{post[-1]} bit-exact vs a clean resume"
    )
    return {"skip": skip, "rewind": rewind, "resume": resume, "checkpoint": ckpt,
            "post_steps": post, "per_step": want, "workdir": work}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.resilience.health_smoke")
    parser.add_argument("--role", choices=("skip", "rewind", "resume"), default=None)
    parser.add_argument("--ckpt-root", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--size", choices=SIZES, default="tiny")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    from ..state import resolve_device

    device = str(resolve_device(args.device))
    if args.role is not None:
        return _train(args.role, args.ckpt_root, args.out, args.size, device)
    run(args.size, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
