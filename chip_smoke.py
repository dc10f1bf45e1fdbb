#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``accelerate_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each fails the run on any mismatch; nothing is caught):

0. Device and build: the card's name and power limit, then the paged
   attention kernels built from ``accelerate_tpu_torch/ops/csrc`` (timed).
1. Kernels against their plain versions at Llama-3-8B head geometry (32 q
   heads over 8 kv heads, head dim 128, block 16) in fp32 and bf16, over 8
   slots with ragged lengths (0, 1, bs-1, bs, bs+1, ..., 4100), null-padded
   bucketed tables, decode and a W=4 verify window.  Prints max error and the
   kernel, plain, bound and library (``scaled_dot_product_attention`` on the
   pre-gathered dense K/V, a yardstick only) times.
2. Serving at full width: Llama-3-8B (all 32 layers, bf16, random weights
   from a seed) through ``Accelerator().prepare_serving(paged_kernel=True)``,
   8 staggered requests with 128-1024-token prompts and 32 new tokens each;
   the decode kernel must run 32 times per decode dispatch.  Then the same
   model with ``spec_tokens=3``, where the window kernel must run 32 times
   per verify dispatch.  Then one decode step over a fixed pool: in bf16 the
   kernel path must pick every slot's top token as the kernel's plain
   version does, and with fp32 activations its logits must match the plain
   einsum path to 1e-4; the step is timed on both paths and profiled.
3. Token identity: the same widths at 4 layers in fp32; the engine with the
   kernel must match greedy ``generate`` per request, and again with
   ``spec_tokens=3`` (window kernel launched, drafts accepted).

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
package beside it, the script exits non-zero and prints no result.
"""

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12}  # fp32 CUDA cores; bf16 dense
TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}
SOURCE = "accelerate_tpu_torch/ops/csrc/paged_attention.cu"
REPLACES = {
    "paged_attention": "accelerate_tpu/ops/pallas_attention.py:564",
    "paged_window_attention": "accelerate_tpu/ops/pallas_attention.py:686",
}


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def cuda_ms(fn, arg_sets, iters=30):
    """Mean device time of ``fn(*args)`` over ``iters`` calls cycling through
    ``arg_sets`` (copies enough to exceed the 50 MB L2, so each call finds
    its inputs cold, as a real decode step does)."""
    import torch

    for args in arg_sets:
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_inputs(dtype, window, lengths, gen, H=32, K=8, hd=128, bs=16):
    import torch

    owned = [-(-n // bs) for n in lengths]
    m = 1
    while m < max(owned):
        m *= 2
    n_blocks = sum(owned) + 1
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(7)) + 1
    tables = torch.zeros(len(lengths), m, dtype=torch.int32)
    c = 0
    for i, n in enumerate(owned):
        tables[i, :n] = perm[c:c + n]
        c += n
    lead = (len(lengths),) if window is None else (len(lengths), window)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    return dict(
        q=randn(*lead, H, hd), k_new=randn(*lead, K, hd), v_new=randn(*lead, K, hd),
        pool_k=randn(n_blocks, bs, K, hd), pool_v=randn(n_blocks, bs, K, hd),
        tables=tables.cuda(), lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"),
    )


def bound_ms(a, window):
    """Least time for the work: bytes each input read once and each output
    written once (only the pool rows below each length count), against the
    operations over the peak rate for the dtype; the larger of the two."""
    q, pk = a["q"], a["pool_k"]
    bs, kh, hd = pk.shape[1], pk.shape[2], pk.shape[3]
    h = q.shape[-2]
    w = 1 if window is None else window
    m = a["tables"].shape[1]
    lens = [min(int(n), m * bs) for n in a["lengths"].tolist()]
    es = q.element_size()
    nbytes = (sum(lens) * kh * hd * 2 * es + 2 * q.numel() * es + 2 * a["k_new"].numel() * es
              + a["tables"].numel() * 4 + a["lengths"].numel() * 4)
    keys = sum(w * n + w * (w + 1) // 2 for n in lens)  # (query, key) pairs admitted
    ops = 4 * h * hd * keys
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[str(q.dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(a, window):
    """``scaled_dot_product_attention`` with GQA over the dense K/V gathered
    once up front (a yardstick: the port never calls it)."""
    import torch
    import torch.nn.functional as F

    q = a["q"] if window is not None else a["q"][:, None]
    k_new = a["k_new"] if window is not None else a["k_new"][:, None]
    v_new = a["v_new"] if window is not None else a["v_new"][:, None]
    b, w = q.shape[:2]
    bs, kh, hd = a["pool_k"].shape[1:]
    p = max(a["lengths"].tolist())
    idx = a["tables"].long()
    dense = [torch.cat([pool[idx].reshape(b, -1, kh, hd)[:, :p], new], 1).transpose(1, 2)
             .contiguous() for pool, new in ((a["pool_k"], k_new), (a["pool_v"], v_new))]
    pos = torch.arange(p + w, device="cuda")
    qpos = torch.arange(w, device="cuda")
    mask = torch.where(pos[None, None] < p, pos[None, None] < a["lengths"][:, None, None],
                       (pos[None, None] - p) <= qpos[None, :, None])[:, None]  # [B, 1, W, P+W]
    qt = q.transpose(1, 2).contiguous()

    def call(qt, k, v, mask):
        return F.scaled_dot_product_attention(qt, k, v, attn_mask=mask, enable_gqa=True)

    return call, (qt, dense[0], dense[1], mask)


def phase1():
    import torch

    from accelerate_tpu_torch.ops import paged_attention as pa

    lengths = [0, 1, 15, 16, 17, 300, 1000, 4100]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, window in (("paged_attention", None), ("paged_window_attention", 4)):
            kern = getattr(pa, name)
            plain = getattr(pa, name + "_plain")
            a = kernel_inputs(dtype, window, lengths, gen)
            got = kern(**a)
            torch.cuda.synchronize()
            want = plain(**a)
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[str(dtype)]
            check(torch.isfinite(got).all().item(), f"{name} {dtype}: non-finite output")
            check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
                  f"{name} {dtype}: max abs err {err} over atol=rtol={tol}")
            pool_bytes = 2 * a["pool_k"].numel() * a["pool_k"].element_size()
            copies = [a] + [dict(a, pool_k=a["pool_k"].clone(), pool_v=a["pool_v"].clone())
                            for _ in range(math.ceil(100e6 / pool_bytes) - 1)]
            order = ("q", "k_new", "v_new", "pool_k", "pool_v", "tables", "lengths")
            sets = [tuple(c[k] for k in order) for c in copies]
            k_ms = cuda_ms(kern, sets)
            p_ms = cuda_ms(plain, sets, iters=10)
            lib_fn, lib_args = library_call(a, window)
            lib_ms = cuda_ms(lib_fn, [lib_args], iters=10)
            b_ms, b_by = bound_ms(a, window)
            results[(name, str(dtype))] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms,
            )
            log(f"phase1 {name} {dtype} W={window or 1} lengths={lengths}: max_abs_err={err:.3e} "
                f"(atol=rtol={tol}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) library_ms={lib_ms:.4f}")
            del a, copies, sets, lib_args
    return results


# ---------------------------------------------------------------------------
# Phase 2: serving Llama-3-8B at full width
# ---------------------------------------------------------------------------


def reset_counts():
    from accelerate_tpu_torch.ops import paged_attention as pa

    pa.paged_attention.launches = 0
    pa.paged_window_attention.launches = 0


def read_counts():
    from accelerate_tpu_torch.ops import paged_attention as pa

    return pa.paged_attention.launches, pa.paged_window_attention.launches


def serve(engine, prompts, max_new, stagger_ticks):
    """Submit ``prompts`` one every ``stagger_ticks`` ticks while ticking;
    returns ({rid: CompletedRequest}, wall seconds, ids in prompt order)."""
    import torch

    ids, done = [], {}
    t0 = time.perf_counter()
    tick = 0
    while len(ids) < len(prompts) or not engine.sched.idle():
        while len(ids) < len(prompts) and tick >= stagger_ticks * len(ids):
            ids.append(engine.submit(prompts[len(ids)], max_new))
        for c in engine.step():
            done[c.id] = c
        tick += 1
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0, ids


def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def phase2():
    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"phase2 Llama-3-8B bf16 params={cfg.num_params()} init_s={time.perf_counter() - t0:.1f}")
    rng = np.random.default_rng(0)
    prompt_lens = [128, 256, 384, 512, 640, 768, 896, 1024]
    prompts = [list(rng.integers(0, cfg.vocab_size, size=n)) for n in prompt_lens]
    max_new = 32
    geometry = dict(max_slots=8, block_size=16, num_blocks=8 * 80 + 8, max_blocks_per_seq=128,
                    prefill_chunk=256)
    acc = Accelerator()
    out = {}
    for spec in (0, 3):
        engine = acc.prepare_serving(llama.apply_cached, llama.init_cache, params, cfg,
                                     paged_kernel=True, spec_tokens=spec, **geometry)
        engine.submit(list(rng.integers(0, cfg.vocab_size, size=40)), 4)  # warm-up
        engine.run()
        engine.pop_finished()
        base = engine.decode_dispatches
        base_s, base_tok = engine.decode_seconds, engine.decode_emitted_tokens
        if spec:
            # Repetitive prompts: the n-gram drafter finds continuations.
            prompts = [(p[:16] * 64)[:n] for p, n in zip(prompts, prompt_lens)]
        reset_counts()
        done, wall, ids = serve(engine, prompts, max_new, stagger_ticks=3)
        dec, win = read_counts()
        dispatches = engine.decode_dispatches - base
        check(len(done) == len(prompts), f"spec={spec}: {len(done)} of {len(prompts)} completed")
        for rid, n in zip(ids, prompt_lens):
            c = done[rid]
            check(c.status == "ok" and c.new_tokens == max_new and len(c.tokens) == n + max_new,
                  f"spec={spec}: request {rid} status {c.status} with {c.new_tokens} tokens")
        per = cfg.num_layers * dispatches
        if spec:
            check(win == per and dec == 0,
                  f"window kernel launched {win} times, want {per}; decode kernel {dec}")
        else:
            check(dec == per and win == 0,
                  f"decode kernel launched {dec} times, want {per}; window kernel {win}")
        ttft = median([c.ttft_ms for c in done.values()])
        # A verify dispatch emits its accepted tokens at one instant, so with
        # speculation most gaps are 0 and the median hides the dispatch time:
        # the mean is printed beside it.
        gaps = [x for c in done.values() for x in c.inter_token_ms]
        itl, itl_mean = median(gaps), sum(gaps) / len(gaps)
        tps = len(prompts) * max_new / wall
        decode_tps = (engine.decode_emitted_tokens - base_tok) / (engine.decode_seconds - base_s)
        st = engine.stats()
        log(f"phase2 spec_tokens={spec}: {len(done)} requests, decode_dispatches={dispatches} "
            f"prefill_dispatches={st['prefill_dispatches']} decode_launches={dec} "
            f"window_launches={win} wall_s={wall:.3f} output_tokens_per_s={tps:.1f} "
            f"decode_tokens_per_s={decode_tps:.1f} ttft_p50_ms={ttft:.1f} itl_p50_ms={itl:.2f} "
            f"itl_mean_ms={itl_mean:.2f} preempted={st['preempted']} "
            f"acceptance={st['spec']['acceptance_rate']}")
        out[spec] = dict(dec=dec, win=win)
        del engine
        torch.cuda.empty_cache()
    decode_step_checks(params, cfg)
    del params
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_kernels():
    """Inside the block, ``apply_paged(kernel=True)`` runs the kernels' plain
    versions in their place (it looks the wrappers up at each call)."""
    from accelerate_tpu_torch.ops import paged_attention as pa

    saved = pa.paged_attention, pa.paged_window_attention
    pa.paged_attention = pa.paged_attention_plain
    pa.paged_window_attention = pa.paged_window_attention_plain
    try:
        yield
    finally:
        pa.paged_attention, pa.paged_window_attention = saved


def decode_step_checks(params, cfg):
    """One Llama-3-8B decode step over a fixed random pool (8 slots, lengths
    0..1023, bucketed null-padded tables): its logits through the kernel
    against the same forward with the kernel's plain version in its place,
    its time against the plain einsum path, and a profile of where the
    device time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch.models import llama

    gen = torch.Generator(device="cuda").manual_seed(1)
    lens = [0, 5, 16, 100, 300, 700, 1000, 1023]
    bs, n_blocks = 16, sum(-(-n // 16) for n in lens) + 1
    pool = {k: torch.randn(cfg.num_layers, n_blocks, bs, cfg.num_kv_heads, cfg.head_dim_,
                           generator=gen, device="cuda").to(cfg.dtype) for k in ("k", "v")}
    tables = torch.zeros(len(lens), 64, dtype=torch.int32)
    c = 1
    for i, n in enumerate(lens):
        nb = -(-n // bs)
        tables[i, :nb] = torch.arange(c, c + nb)
        c += nb
    tables = tables.cuda()
    starts = torch.tensor(lens, dtype=torch.int32, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (len(lens), 1), generator=gen, device="cuda")

    def step(kernel, cfg=cfg, pool=pool):
        return llama.apply_paged(params, tokens, cfg, pool, tables, starts, kernel=kernel)[0]

    # In bf16, one ulp of difference in an attention output grows through 32
    # random layers to ~0.15 in the logits even when only the kernel's
    # summation order changes (its plain version in its place), so the bf16
    # forward is held to what greedy serving reads, the top token of every
    # slot; the logits themselves are held at the fp32 tolerance in a
    # forward with fp32 activations and pool on the same weights.
    lk = step(True)
    with plain_kernels():
        lp = step(True)
    le = step(False)
    err = (lk - lp).abs().max().item()
    err_e = (lk - le).abs().max().item()
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    log(f"phase2 fixed-pool decode logits, bf16, kernel vs its plain version in the same forward: "
        f"max_abs_err={err:.3e} max|logit|={lp.abs().max().item():.3f} "
        f"argmax_agreement={agree:.3f}; kernel vs einsum path max_abs_err={err_e:.3e}")
    check(bool(torch.isfinite(lk).all()) and agree == 1.0,
          f"bf16 decode step: top tokens differ in {1 - agree:.3f} of the slots")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    pool32 = {k: v.float() for k, v in pool.items()}
    lk32 = step(True, cfg32, pool32)
    le32 = step(False, cfg32, pool32)
    err32 = (lk32 - le32).abs().max().item()
    log(f"phase2 fixed-pool decode logits, fp32 activations, kernel vs einsum path: "
        f"max_abs_err={err32:.3e} max|logit|={le32.abs().max().item():.3f} (atol=rtol=1e-4)")
    check(torch.allclose(lk32, le32, atol=1e-4, rtol=1e-4), f"fp32 decode logits differ by {err32}")
    del pool32, lk32, le32

    # Step time, plain einsum path against the kernel path, in turns.
    times = {True: [], False: []}
    for kernel in (False, True, True, False):
        times[kernel].append(cuda_ms(lambda: step(kernel), [()], iters=5))
    k_ms, e_ms = median(times[True]), median(times[False])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
        reverse=True,
    )
    busy = sum(t for t, _, _ in by_kernel)
    # Idle share: the device's gaps between kernels within the event-timed
    # step (the host launching the next kernel), 1 - busy / step time.
    log(f"phase2 decode step (8 slots, 32 layers): kernel_path_ms={k_ms:.3f} "
        f"einsum_path_ms={e_ms:.3f}; profiled step wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
        f"idle_share={(1 - busy / k_ms) if busy else float('nan'):.3f}")
    for t, n, key in by_kernel[:8]:
        log(f"phase2   device {t:.3f} ms in {n} launches: {key[:110]}")


# ---------------------------------------------------------------------------
# Phase 3: token identity with greedy generate
# ---------------------------------------------------------------------------


def phase3():
    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b(num_layers=4, dtype=torch.float32)
    params = llama.init_params(cfg, seed=1)
    rng = np.random.default_rng(1)
    shared = list(rng.integers(0, cfg.vocab_size, size=40))
    prompts = [shared + list(rng.integers(0, cfg.vocab_size, size=n)) for n in (3, 25)]
    prompts += [list(rng.integers(0, cfg.vocab_size, size=n)) for n in (17, 64, 130, 200)]
    max_new = 24

    def greedy(p, n):
        ids = torch.tensor([p], device="cuda")
        return llama.generate(params, ids, cfg, max_new_tokens=n)[0].tolist()

    def run(prompts, spec):
        engine = Accelerator().prepare_serving(
            llama.apply_cached, llama.init_cache, params, cfg, paged_kernel=True,
            spec_tokens=spec, max_slots=4, block_size=16, num_blocks=96, max_blocks_per_seq=32,
            prefill_chunk=64,
        )
        reset_counts()
        ids = [engine.submit(p, max_new) for p in prompts]
        outputs = engine.run(max_ticks=2000)
        counts = read_counts()
        for rid, p in zip(ids, prompts):
            check(outputs[rid] == greedy(p, max_new),
                  f"spec={spec}: request {rid} differs from greedy generate")
        return engine.stats(), counts

    st, (dec, win) = run(prompts, 0)
    check(dec == cfg.num_layers * st["decode_dispatches"] and win == 0,
          f"decode kernel launched {dec} times over {st['decode_dispatches']} dispatches")
    log(f"phase3 4-layer fp32: {len(prompts)} requests token-identical to greedy generate; "
        f"decode_launches={dec} prefix_hits={st['prefix_hits']}")
    # Repetitive prompts built from the model's own greedy continuation, so
    # n-gram drafts along the repeated span can be accepted.
    spec_prompts = []
    for p in prompts[2:5]:
        g = greedy(p, 16)
        spec_prompts.append(g + p)
    st, (dec, win) = run(spec_prompts, 3)
    check(win > 0 and dec == 0, f"window kernel launched {win} times, decode kernel {dec}")
    check(st["spec"]["accepted"] > 0, f"no draft accepted: {st['spec']}")
    log(f"phase3 spec_tokens=3: {len(spec_prompts)} requests token-identical to greedy generate; "
        f"window_launches={win} acceptance={st['spec']['acceptance_rate']} "
        f"tokens_per_dispatch={st['spec']['tokens_per_dispatch']}")
    del params
    torch.cuda.empty_cache()
    return win


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from accelerate_tpu_torch.ops import _build

    # fp32 products in full fp32 (the fp32 tolerances assume it).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"phase0 device={kind} count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda} nvidia-smi: {smi}")
    t0 = time.perf_counter()
    libs = _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    log(f"phase0 built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    p1 = phase1()
    p2 = phase2()
    win3 = phase3()
    log("kernels: paged_attention, paged_window_attention")
    launches = {"paged_attention": p2[0]["dec"], "paged_window_attention": p2[3]["win"]}
    check(win3 > 0, "window kernel not launched in phase 3")
    record = []
    for name in ("paged_attention", "paged_window_attention"):
        r = p1[(name, "torch.bfloat16")]
        record.append(dict(name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
                           launches=launches[name], **r))
    log(json.dumps({"kernels": record}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
