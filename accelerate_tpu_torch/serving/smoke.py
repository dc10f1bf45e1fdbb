"""Serving smoke: continuous batching equivalence + dispatch proof.

The one-process arm of the JAX package's ``serving/smoke.py``:
``python -m accelerate_tpu_torch.serving.smoke`` (on the card: the paged
kernels in every decode; ``--device cpu`` on the CPU).  A staggered mix of requests
(heterogeneous prompt lengths and token budgets, submitted while earlier
requests are mid-flight, through a pool tight enough to force at least one
preemption) flows through the continuous-batching engine on gpt2-tiny.
Asserts:

- **equivalence** — every request's output is token-identical to the offline
  greedy ``generate`` for that prompt alone;
- **one decode forward per tick** — the ``serving.decode_dispatches``
  telemetry counter delta equals the engine's decode count and never
  exceeds ticks;
- **preemption exercised** — the tight pool actually evicted someone;
- **SLO metrics land** — ``serving.*`` counters/gauges/histograms are in the
  registry snapshot and the telemetry report renders the serving block.

The JAX smoke's 8-device data-parallel mesh waits for several GPUs
(ROADMAP A6): ``--mesh`` raises.  Exit code 0 only when every assertion
holds.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Optional


def mesh_arm_unported(name: str):
    raise NotImplementedError(
        f"the {name}'s data-parallel mesh arm needs several GPUs: ROADMAP A6")


def run(device: Optional[str] = None) -> dict:
    from ..state import resolve_device

    device = str(resolve_device(device))

    os.environ.setdefault("ACCELERATE_TPU_SENTINEL_PROFILE", "0")

    import numpy as np
    import torch

    from .. import telemetry
    from ..accelerator import Accelerator
    from ..models import gpt2
    from ..telemetry.report import format_report, load_records, summarize
    tel = telemetry.enable(dir=tempfile.mkdtemp(prefix="atpu_serving_smoke_"))
    acc = Accelerator(device=device)

    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32)
    params = gpt2.init_params(cfg, seed=0, device=device)

    rng = np.random.default_rng(0)
    lengths = [5, 14, 3, 22, 9, 7]
    budgets = [7, 4, 10, 3, 6, 8]
    prompts = [list(rng.integers(0, cfg.vocab_size, size=n)) for n in lengths]

    print("# serving smoke: offline oracle (generate, greedy)")
    want = {}
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        out = gpt2.generate(params, torch.tensor([p], device=device), cfg, max_new_tokens=m)
        want[i] = [int(t) for t in out[0].tolist()]

    # Tight pool (10 usable blocks of 4 rows vs ~6 in-flight sequences) so
    # the run must exercise preemption, not just the happy path.
    engine = acc.prepare_serving(
        gpt2.apply_cached, gpt2.init_cache, params, cfg,
        block_size=4, num_blocks=11, max_slots=4, prefill_chunk=8,
        max_blocks_per_seq=8, paged_kernel=device != "cpu",
    )

    counter = tel.registry.counter("serving.decode_dispatches")
    d0 = counter.value
    ids = {}
    # Staggered arrivals: requests join while the decode batch is in flight.
    for k, i in enumerate(rng.permutation(len(prompts))):
        ids[engine.submit(prompts[i], budgets[i])] = int(i)
        if k % 2 == 1:
            engine.step()
    outputs = engine.run(max_ticks=2000)
    stats = engine.stats()
    print(f"# serving smoke: stats {stats}")

    for rid, out in outputs.items():
        assert out == want[ids[rid]], (
            f"request {rid} (prompt #{ids[rid]}) diverged from generate:\n"
            f"  got  {out}\n  want {want[ids[rid]]}"
        )
    print(f"# serving smoke: {len(outputs)} requests token-identical to generate")

    delta = counter.value - d0
    assert delta == engine.decode_dispatches, (
        f"telemetry counted {delta} decode dispatches, engine ran "
        f"{engine.decode_dispatches}"
    )
    assert delta <= engine.ticks, f"{delta} decode dispatches > {engine.ticks} ticks"
    print(f"# serving smoke: {delta} decode forwards over {engine.ticks} ticks (<= 1/step)")

    assert stats["preempted"] > 0, "tight pool never preempted — smoke lost its hard path"

    snap = tel.registry.snapshot()
    for key in (
        "serving.requests", "serving.completed", "serving.tokens",
        "serving.decode_dispatches", "serving.prefill_dispatches",
        "serving.active_slots", "serving.queue_depth", "serving.blocks_used",
        "serving.block_occupancy", "serving.preempted",
        "serving.ttft_ms.count", "serving.inter_token_ms.count",
        "serving.queue_wait_ms.count",
    ):
        assert key in snap, f"metric {key} missing from registry snapshot"
    assert snap["serving.completed"] == len(prompts)
    assert snap["serving.ttft_ms.count"] == len(prompts)

    telemetry.disable()  # flush the final snapshot record
    report = format_report(summarize(load_records(tel.dir)))
    assert "serving engine (continuous batching):" in report, "report lacks serving block"
    assert "TTFT: p50" in report
    print("# serving smoke: serving.* gauges render in the telemetry report")
    print("\n".join(line for line in report.splitlines() if "serving" in line or "TTFT" in line))
    print("serving smoke OK")
    return {"requests": len(outputs), "decode_dispatches": delta, "ticks": engine.ticks,
            "preempted": stats["preempted"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m accelerate_tpu_torch.serving.smoke")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("--mesh", action="store_true",
                        help="the JAX smoke's 8-device data-parallel arm (ROADMAP A6)")
    args = parser.parse_args(argv)
    if args.mesh:
        mesh_arm_unported("serving smoke")
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
