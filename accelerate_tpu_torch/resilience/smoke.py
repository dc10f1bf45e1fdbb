"""Resilience smoke: kill a training run mid-step, resume, prove bit-exact
loss continuation.

The port of the JAX package's ``resilience/smoke.py``:
``python -m accelerate_tpu_torch.resilience.smoke`` (a tiny llama on the
card; ``--device cpu`` on the CPU) or ``... --size llama3-8b`` (Llama-3-8B's
widths cut to one layer, bf16 compute over fp32 parameters, B 1 x S 2048, the flash kernels
in every step).  The parent orchestrates three child processes sharing one
training recipe (:func:`build`: seeded weights, a fixed data order, a
stateful data loader so the mid-epoch position checkpoints, the fused
``make_train_step``):

1. **reference** — trains ``STEPS`` steps uninterrupted, recording per-step
   losses;
2. **victim** — same recipe with ``ACCELERATE_TPU_FAULT_SIGTERM_STEP=K``: the
   fault injector delivers a real SIGTERM mid-run, the installed
   ``PreemptionGuard`` catches it, ``check_preemption()`` writes one final
   verified checkpoint at the step boundary, and the process exits cleanly;
3. **resume** — a fresh process calls ``resume_from_latest``, lands on step K
   (skipping any torn partials), and trains to ``STEPS``.

The parent then asserts the checkpoint is manifest-complete and the resumed
losses are BIT-EXACT equal to the reference run for every post-resume step
(>= 3 of them).

The checkpoint I/O retry rides the same three lives, sharing their
checkpoint: the victim runs under
``ACCELERATE_TPU_FAULT_WRITE_N=1`` (the preemption checkpoint's first
manifest write fails once and the publish retries: ``resilience.retries``
== 1, and the checkpoint still verifies), and the resume, after its last
step, saves once more under ``..._WRITE_STICKY=1`` (the policy gives up:
``resilience.gave_up`` == 1, the staging directory is left torn, and
``find_latest_complete`` still returns the victim's checkpoint).

Each child reports its losses, its per-step flash launches and
``pipeline.dispatches_per_step``, and the seconds of each save and load.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

STEPS = 8
KILL_STEP = 4
N_SEQ = 6  # sequences per epoch: 8 steps of batch 1 cross an epoch boundary
SIZES = ("tiny", "llama3-8b")
CHILD_TIMEOUT_S = 900
FLASH = ("fused_attention_fwd", "fused_attention_bwd_dq", "fused_attention_bwd_dkv")


def recipe_config(size: str):
    """``(llama config, sequence length, learning rate)`` of ``size``."""
    import torch

    from ..models import llama

    if size == "tiny":
        return llama.LlamaConfig.tiny(max_seq_len=64), 32, 1e-3
    if size == "llama3-8b":
        # Phase 6's cut: fp32 parameters and AdamW's two moments of one
        # layer are a 15.2 GB checkpoint.
        cfg = llama.LlamaConfig.llama3_8b(num_layers=1, dtype=torch.bfloat16,
                                          param_dtype=torch.float32, remat=True)
        return cfg, 2048, 3e-5
    raise ValueError(f"size must be one of {SIZES}, got {size!r}")


def build(size: str, device: Optional[str], project_dir: Optional[str] = None):
    """One training recipe for every role: seeded weights, ``N_SEQ``
    sequences from a seed in a fixed order, a stateful data loader of batch
    1, AdamW.  With ``project_dir``, checkpoints are named automatically
    under it (the newest 3 kept).  Returns ``(accelerator, model,
    optimizer, loader)``."""
    import numpy as np
    import torch
    from torch.utils.data import DataLoader

    from ..accelerator import Accelerator
    from ..models import llama
    from ..utils import DataLoaderConfiguration, ProjectConfiguration, set_seed

    set_seed(1234)
    cfg, seq, lr = recipe_config(size)
    kwargs = {}
    if project_dir is not None:
        kwargs["project_config"] = ProjectConfiguration(
            project_dir=project_dir, automatic_checkpoint_naming=True, total_limit=3)
    accelerator = Accelerator(
        device=device,
        dataloader_config=DataLoaderConfiguration(use_stateful_dataloader=True), **kwargs,
    )
    model = llama.LlamaForCausalLM(cfg, seed=0, device=device)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=1e-4)
    rng = np.random.default_rng(0)
    data = [{"input_ids": torch.from_numpy(rng.integers(0, cfg.vocab_size, size=seq))}
            for _ in range(N_SEQ)]
    model, opt, dl = accelerator.prepare(model, opt, DataLoader(data, batch_size=1))
    return accelerator, model, opt, dl


def flash_launches() -> dict:
    """The flash kernels' launch counts so far (0 on CPU tensors, whose
    wrappers run the plain versions)."""
    from ..ops import fused_attention as fu

    return {name: getattr(fu, name).launches for name in FLASH}


def params_digest(model) -> str:
    """A digest of every parameter, computed on its device: per tensor, two
    int64 sums of its words (plain and mixed), hashed on the host.  Equal
    parameters give equal digests; an update changes them."""
    import torch

    sums = []
    with torch.no_grad():
        for p in model.parameters():
            flat = p.detach().reshape(-1)
            words = flat.view(torch.int32) if flat.element_size() == 4 else \
                flat.view(torch.int16).to(torch.int32)
            sums.append(words.sum(dtype=torch.int64))
            sums.append((words ^ (words >> 13)).sum(dtype=torch.int64))
        host = torch.stack(sums).cpu().numpy()
    return hashlib.sha256(host.tobytes()).hexdigest()


def step_metrics(tel, before: dict) -> dict:
    """One step's flash launches (the counts since ``before``) and the
    ``pipeline.dispatches_per_step`` gauge."""
    now = flash_launches()
    return {"launches": {k: now[k] - before[k] for k in FLASH},
            "dispatches_per_step": tel.registry.gauge("pipeline.dispatches_per_step").value}


def _save_seconds(accelerator) -> dict:
    t = accelerator.last_save_timing or {}
    return {k: round(float(v), 3) for k, v in t.items() if k.endswith("_s")}


def _train(role: str, ckpt_root: str, out_path: str, size: str, device: str) -> int:
    from .. import telemetry
    from . import faultinject
    from .manifest import find_latest_complete

    tel = telemetry.enable(dir=tempfile.mkdtemp(prefix="atpu_resilience_smoke_tel_"))
    accelerator, model, opt, dl = build(size, device)
    accelerator.enable_preemption_handling(save_dir=os.path.join(ckpt_root, "preempt-ckpt"))
    step_fn = accelerator.make_train_step(model, opt)

    global_step = 0
    out: dict = {"saves": [], "loads": []}
    if role == "resume":
        t0 = time.perf_counter()
        resumed = accelerator.resume_from_latest(ckpt_root)
        out["loads"].append(dict(
            {k: round(float(v), 3) for k, v in (accelerator.last_load_timing or {}).items()},
            total_s=round(time.perf_counter() - t0, 3)))
        assert resumed is not None, f"resume role found no complete checkpoint in {ckpt_root}"
        global_step = resumed
        print(f"# resumed at step {resumed}", file=sys.stderr)

    losses: dict = {}
    steps: dict = {}
    preempted = False
    empty_passes = 0
    while global_step < STEPS and not preempted:
        made_progress = False
        for batch in dl:
            made_progress = True
            before = flash_launches()
            loss = step_fn(batch)
            global_step += 1
            losses[str(global_step)] = float(loss)
            steps[str(global_step)] = step_metrics(tel, before)
            if accelerator.check_preemption(step=global_step):
                out["saves"].append(_save_seconds(accelerator))
                print(f"# preempted at step {global_step}", file=sys.stderr)
                preempted = True
                break
            if global_step >= STEPS:
                break
        # A resumed run whose checkpoint landed exactly on an epoch boundary
        # legitimately consumes one empty pass (the skip covers the whole
        # epoch); two in a row means the loader is actually empty.
        empty_passes = 0 if made_progress else empty_passes + 1
        if empty_passes >= 2 and global_step < STEPS:
            raise RuntimeError("dataloader yielded nothing twice; cannot make progress")

    if role == "resume":
        # A dead filesystem: every write from the first on fails, the policy
        # gives up, and the previous checkpoint stays the newest complete one.
        os.environ[faultinject.ENV_WRITE_N] = "1"
        os.environ[faultinject.ENV_WRITE_STICKY] = "1"
        faultinject.reload()
        target = os.path.join(ckpt_root, "sticky-ckpt")
        raised = None
        t0 = time.perf_counter()
        try:
            accelerator.save_state(target, step=global_step)
        except OSError as e:
            raised = f"{type(e).__name__}: {e}"
        finally:
            sticky_s = time.perf_counter() - t0
            os.environ.pop(faultinject.ENV_WRITE_N, None)
            os.environ.pop(faultinject.ENV_WRITE_STICKY, None)
            faultinject.reload()
        staging = f"{target}.tmp"
        out["sticky"] = {
            "raised": raised,
            "published": os.path.isdir(target),
            "torn": os.path.isdir(staging)
            and not os.path.exists(os.path.join(staging, "manifest.json")),
            "latest": find_latest_complete(ckpt_root),
            "seconds": round(sticky_s, 3),
        }

    out.update(
        losses=losses, steps=steps, preempted=preempted, last_step=global_step,
        launches=flash_launches(),
        retries=tel.registry.counter("resilience.retries").value,
        gave_up=tel.registry.counter("resilience.gave_up").value,
    )
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def child(module: str, args: list, out_path: str, extra_env: dict) -> dict:
    """Run ``<module>.main(args)`` in a fresh process (forked from a server
    that imported torch once: :func:`~..parallel.launch.start`) and return
    the JSON it wrote to ``out_path``; raises with the child's output when
    it exits non-zero."""
    from ..parallel import launch

    env = dict(os.environ)
    env.update(extra_env)
    [(code, out, err)] = launch.start(module, lambda r: args, 1, env=env,
                                      capture=True).wait(CHILD_TIMEOUT_S)
    if code != 0:
        print(out)
        print(err, file=sys.stderr)
        raise RuntimeError(f"{module} {args} exited rc={code}")
    sys.stderr.write(err[-4000:])
    with open(out_path) as f:
        return json.load(f)


def _child(role: str, ckpt_root: str, out_path: str, size: str, device: str,
           extra_env: dict) -> dict:
    args = ["--role", role, "--ckpt-root", ckpt_root, "--losses", out_path,
            "--size", size, "--device", device]
    return child("accelerate_tpu_torch.resilience.smoke", args, out_path, extra_env)


def run(size: str = "tiny", device: Optional[str] = None,
        workdir: Optional[str] = None) -> dict:
    """The three lives and every assertion; returns a summary.  ``device``
    ``None`` is the card (raising without CUDA); ``"cpu"`` asks for the
    CPU."""
    from ..state import resolve_device

    device = str(resolve_device(device))
    work = workdir or tempfile.mkdtemp(prefix="atpu_resilience_smoke_")
    ref_root = os.path.join(work, "ref_ckpts")
    victim_root = os.path.join(work, "victim_ckpts")
    os.makedirs(ref_root)
    os.makedirs(victim_root)
    clean = {"ACCELERATE_TPU_CHECKPOINT_FSYNC": os.environ.get(
        "ACCELERATE_TPU_CHECKPOINT_FSYNC", "1")}

    print("# resilience-smoke: reference run (uninterrupted)", file=sys.stderr)
    ref = _child("train", ref_root, os.path.join(work, "ref.json"), size, device, clean)
    assert not ref["preempted"] and ref["last_step"] == STEPS, ref

    print(f"# resilience-smoke: victim run (SIGTERM at step {KILL_STEP})", file=sys.stderr)
    victim_env = dict(clean, ACCELERATE_TPU_FAULT_SIGTERM_STEP=str(KILL_STEP),
                      ACCELERATE_TPU_FAULT_WRITE_N="1")
    victim = _child("train", victim_root, os.path.join(work, "victim.json"), size, device,
                    victim_env)
    assert victim["preempted"], f"victim was never preempted: {victim}"
    assert victim["last_step"] == KILL_STEP, victim
    assert victim["retries"] == 1 and victim["gave_up"] == 0, (
        f"transient write fault: retries {victim['retries']}, gave_up "
        f"{victim['gave_up']}, want 1 and 0")

    from .manifest import find_latest_complete, verify_checkpoint

    ckpt = find_latest_complete(victim_root)
    assert ckpt is not None, f"no manifest-complete checkpoint under {victim_root}"
    print("# resilience-smoke: resume run (fresh process)", file=sys.stderr)
    # The resume starts while this process verifies the checkpoint (the
    # resume verifies it again before it loads).
    with ThreadPoolExecutor(1) as pool:
        resuming = pool.submit(_child, "resume", victim_root,
                               os.path.join(work, "resume.json"), size, device, clean)
        t0 = time.perf_counter()
        manifest = verify_checkpoint(ckpt)  # raises on torn/corrupt
        verify_s = time.perf_counter() - t0
        resumed = resuming.result()
    assert manifest["step"] == KILL_STEP, manifest
    assert resumed["last_step"] == STEPS, resumed

    post = [str(s) for s in range(KILL_STEP + 1, STEPS + 1)]
    assert len(post) >= 3, "need >= 3 post-resume steps for the continuation proof"
    for s in post:
        ref_loss, res_loss = ref["losses"][s], resumed["losses"][s]
        assert ref_loss == res_loss, (
            f"loss diverged at step {s}: reference {ref_loss!r} != resumed {res_loss!r}"
        )
    sticky = resumed["sticky"]
    assert sticky["raised"] and "injected" in sticky["raised"], sticky
    assert resumed["gave_up"] == 1, f"sticky write fault: gave_up {resumed['gave_up']}"
    assert sticky["torn"] and not sticky["published"], sticky
    assert sticky["latest"] == ckpt, (sticky["latest"], ckpt)
    print(
        f"resilience-smoke OK — SIGTERM at step {KILL_STEP}, verified checkpoint "
        f"{os.path.basename(ckpt)}, bit-exact losses for steps {post[0]}..{post[-1]}; "
        "transient write retried once, sticky write gave up with a torn staging directory "
        "and the previous checkpoint still the latest"
    )
    return {"reference": ref, "victim": victim, "resume": resumed, "checkpoint": ckpt,
            "verify_s": round(verify_s, 3), "post_steps": post, "workdir": work}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m accelerate_tpu_torch.resilience.smoke")
    parser.add_argument("--role", choices=("train", "resume"), default=None)
    parser.add_argument("--ckpt-root", default=None)
    parser.add_argument("--losses", default=None)
    parser.add_argument("--size", choices=SIZES, default="tiny")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    from ..state import resolve_device

    device = str(resolve_device(args.device))
    if args.role is not None:
        return _train(args.role, args.ckpt_root, args.losses, args.size, device)
    run(args.size, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
