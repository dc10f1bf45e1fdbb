"""Speculative-serving smoke: the draft-then-verify proof.

The JAX package's ``serving/spec_smoke.py``: ``python -m
accelerate_tpu_torch.serving.spec_smoke`` on the card, ``--device cpu`` on
the CPU; the verify window takes the paged path's plain attention, as in
the serving smoke (gpt2-tiny's head dim is not one the kernels take).  A
mix of pattern-heavy prompts (the n-gram drafter's best case) and random
prompts (mostly-rejected drafts) flows through a speculative engine
(``spec_tokens=3``) on gpt2-tiny.  Asserts:

- **speculation is live** — ``serving.spec.acceptance_rate`` ends above zero
  and more than one token lands per slot-forward on the pattern traffic;
- **one verify forward per tick** — the decode-dispatch counter delta equals
  the engine's count, never exceeds ticks, and every decode forward is a
  verify forward (``spec.rounds`` == dispatches: the fixed ``k+1`` window);
- **token identity** — every request's output is token-identical to the
  offline greedy ``generate`` for that prompt alone;
- **zero block leaks** — the KV pool is fully free after the last
  completion.

``--mesh`` is the JAX smoke's 8-device data-parallel arm, as the serving
smoke's (``smoke.mesh_arm``): ``--world`` ranks on a ``dp`` mesh, every
assertion on every rank, every rank's tokens equal to rank 0's.  Exit code
0 only when every assertion holds.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Optional

from .smoke import accelerator_on, main_of


def run(device: Optional[str] = None, world: int = 1) -> dict:
    """The scenario on this process: one process, or (``world > 1``) one
    rank of a ``dp=world`` mesh whose group it joined."""
    from ..state import resolve_device

    device = str(resolve_device(device))

    os.environ.setdefault("ACCELERATE_TPU_SENTINEL_PROFILE", "0")

    import numpy as np
    import torch

    from .. import telemetry
    from ..models import gpt2
    tel = telemetry.enable(dir=tempfile.mkdtemp(prefix="atpu_spec_smoke_"))
    acc = accelerator_on(device, world)

    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32)
    params = gpt2.init_params(cfg, seed=0, device=device)

    rng = np.random.default_rng(7)
    pattern = [int(t) for t in rng.integers(0, cfg.vocab_size, size=4)]
    # Pattern prompts feed the prompt-lookup drafter from the first tick;
    # the random prompts ride in the same co-batch with near-zero acceptance
    # so variable per-slot accept/rewind is exercised inside one forward.
    prompts = [
        pattern * 3,
        pattern * 2 + pattern[:2],
        list(rng.integers(0, cfg.vocab_size, size=9)),
        pattern * 2 + pattern[:3],
        list(rng.integers(0, cfg.vocab_size, size=6)),
    ]
    budgets = [10, 8, 6, 9, 7]

    print("# spec smoke: offline oracle (generate, greedy)")
    want = {}
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        out = gpt2.generate(params, torch.tensor([p], device=device), cfg, max_new_tokens=m)
        want[i] = [int(t) for t in out[0].tolist()]

    engine = acc.prepare_serving(
        gpt2.apply_cached, gpt2.init_cache, params, cfg,
        block_size=4, num_blocks=24, max_slots=4, prefill_chunk=8,
        max_blocks_per_seq=8, spec_tokens=3, prefix_cache=False,
    )

    dispatch_counter = tel.registry.counter("serving.decode_dispatches")
    rounds_counter = tel.registry.counter("serving.spec.rounds")
    d0, r0 = dispatch_counter.value, rounds_counter.value

    ids = {}
    for k, i in enumerate(rng.permutation(len(prompts))):
        ids[engine.submit(prompts[i], budgets[i])] = int(i)
        if k % 2 == 1:
            engine.step()
    outputs = engine.run(max_ticks=2000)
    stats = engine.stats()
    print(f"# spec smoke: stats {stats}")

    for rid, out in outputs.items():
        assert out == want[ids[rid]], (
            f"request {rid} (prompt #{ids[rid]}) diverged from generate:\n"
            f"  got  {out}\n  want {want[ids[rid]]}"
        )
    print(f"# spec smoke: {len(outputs)} requests token-identical to generate")

    spec = stats["spec"]
    assert spec["acceptance_rate"] > 0, "drafter never landed a token"
    assert spec["tokens_per_dispatch"] > 1.0, (
        f"tokens/slot-forward {spec['tokens_per_dispatch']:.3f} <= 1 — "
        "speculation emitted no more than plain greedy would"
    )
    snap_rate = tel.registry.gauge("serving.spec.acceptance_rate").value
    assert snap_rate > 0, "serving.spec.acceptance_rate gauge never moved"
    print(
        f"# spec smoke: acceptance {spec['acceptance_rate']:.3f} "
        f"({spec['accepted']}/{spec['proposed']} drafts), "
        f"{spec['tokens_per_dispatch']:.3f} tokens per slot-forward"
    )

    delta = dispatch_counter.value - d0
    assert delta == engine.decode_dispatches, (
        f"telemetry counted {delta} decode dispatches, engine ran "
        f"{engine.decode_dispatches}"
    )
    assert delta <= engine.ticks, f"{delta} decode dispatches > {engine.ticks} ticks"
    rounds = rounds_counter.value - r0
    assert rounds == delta, (
        f"{rounds} verify rounds != {delta} decode dispatches — a tick fell "
        "out of the fixed k+1 window"
    )
    print(f"# spec smoke: {delta} verify forwards over {engine.ticks} ticks "
          "(<= 1/step, every one a k+1 window)")

    assert engine.cache.allocator.used_blocks == 0, (
        f"{engine.cache.allocator.used_blocks} blocks still allocated after "
        "the last completion — accept/rewind leaked pool blocks"
    )
    print("# spec smoke: KV pool fully free after drain (zero block leaks)")

    telemetry.disable()
    print("spec smoke OK")
    return {"requests": len(outputs), "acceptance_rate": spec["acceptance_rate"],
            "tokens_per_dispatch": spec["tokens_per_dispatch"], "verify_forwards": delta,
            "rank": acc.process_index, "device": device,
            "tokens": [outputs[r] for r in sorted(ids, key=ids.get)]}


def main(argv=None) -> int:
    return main_of("accelerate_tpu_torch.serving.spec_smoke", run, "spec smoke OK", argv)


if __name__ == "__main__":
    sys.exit(main())
