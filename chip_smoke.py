#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``accelerate_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each fails the run on any mismatch; nothing is caught):

0. Device and build: the card's name and power limit, then every kernel
   source under ``accelerate_tpu_torch/ops/csrc`` built, one ``nvcc`` each,
   all started together (timed).
1. Paged kernels (``paged_attention_sm90.cu``: split kernel + merge kernel)
   against their plain versions at Llama-3-8B head geometry (32 q heads over
   8 kv heads, head dim 128, block 16) in fp32 and bf16, decode and a W=4
   verify window, at two shapes of 8 slots with null-padded bucketed tables:
   lengths 0, 1, bs-1, bs, bs+1, 300, 1000, 4100 (table 512 wide) and the
   serving decode step's 0, 5, 16, 100, 300, 700, 1000, 1023 (64 wide).
   Prints max error, the CTAs launched and the CTAs that did work, and the
   kernel, plain, bound and library (``scaled_dot_product_attention`` on the
   pre-gathered dense K/V, a yardstick only) times, the previous body
   (``paged_attention.cu``, called directly, not counted) as ``previous_ms``
   in turns with the kernel, the merge kernel alone, the same inputs with the
   table cut to the longest slot (what the empty split CTAs cost), and bf16
   times for split sizes of 64, 128 and 256 positions.  Phase 1's times are
   device times from CUDA graphs of the calls (a paged call's host side,
   checks and two launches, takes longer than its kernels); the eager
   call's time is printed beside them.
2. Serving at full width: Llama-3-8B (all 32 layers, bf16, random weights
   from a seed) through ``Accelerator().prepare_serving(paged_kernel=True)``,
   8 staggered requests with 128-1024-token prompts and 32 new tokens each;
   the decode kernel must run 32 times per decode dispatch.  Then the same
   model with ``spec_tokens=3``, where the window kernel must run 32 times
   per verify dispatch.  Then one decode step over a fixed pool: in bf16 the
   kernel path must pick every slot's top token as the kernel's plain
   version does, and with fp32 activations its logits must match the plain
   einsum path to 1e-4; the step is timed on both paths and profiled (the
   paged kernels' device ms as a group).
3. Token identity: the same widths at 4 layers in fp32; the engine with the
   kernel must match greedy ``generate`` per request, and again with
   ``spec_tokens=3`` (window kernel launched, drafts accepted).
4. Flash-attention training kernels (forward, dQ, dK/dV) against their plain
   versions at Llama-3-8B head geometry (32 q heads over 8 kv heads, head
   dim 128) in fp32, bf16 and fp16: B 2 x S 2048 causal, S 1024 non-causal,
   and S 2048 causal with a left-padded row (``kv_valid``, its first rows
   admit no key).  bf16 and fp16 run the Hopper forward
   (``flash_fwd_sm90.cu``), dQ (``flash_bwd_dq_sm90.cu``) and dK/dV
   (``flash_bwd_dkv_sm90.cu``), fp32 the CUDA-core ones.  Prints max errors
   and, at B 2 x S 2048 causal in fp32 and bf16, the kernel, plain, bound and
   library (``scaled_dot_product_attention``, forward and forward+backward, a
   yardstick only) times and δ's time, and in bf16 the previous forward, dQ
   and dK/dV bodies (``atpu_flash_fwd``, ``atpu_flash_bwd_dq``,
   ``atpu_flash_bwd_dkv``, called directly, not counted) as ``previous_ms``
   in turns with the kernels, the dQ kernel with a 2-stage K/V ring
   (``atpu_flash_bwd_dq_sm90_ring2``) as ``ring2_ms``, and the dK/dV kernel
   without the lo half of P in its dV product
   (``atpu_flash_bwd_dkv_sm90_nolo``) as ``nolo_ms``.
5. Training at full width: Llama-3-8B widths cut to 4 layers (fp32 params,
   AdamW state and gradients of all 32 would need ~128 GB), bf16 compute,
   ``remat=True``, random weights from seed 0, through
   ``Accelerator().prepare(model, torch.optim.AdamW(...))`` and
   ``make_train_step`` at B 2 x S 2048: one step with fp32 activations on
   the kernel path and on the plain path (loss and every gradient within a
   relative 1e-4), one bf16 step on both paths (loss within 1e-3, every
   gradient within a relative 5e-2), then 5 AdamW steps at lr 3e-5 on one
   fixed batch (loss finite and falling; per step the forward kernel runs 2 x L
   times under remat, dQ and dK/dV L times each), with step time, tokens/s,
   model FLOPs and the device idle share of one profiled step (device time
   by kernel group, and each flash kernel's).

6. The README's training loop at full width, with a checkpoint round trip:
   Llama-3-8B widths cut to 1 layer (fp32 parameters and AdamW's two
   moments are 12 bytes a parameter: 15.2 GB a checkpoint), bf16 compute,
   ``remat=True``, through ``Accelerator().prepare(model, AdamW, DataLoader,
   LambdaLR)`` over 14 sequences of 2048 tokens from a seed (batch 2,
   shuffled by the seedable sampler, copied ahead by the prefetcher at
   depth 2 on its own CUDA stream), ``gradient_accumulation_steps=2``: 7
   micro-batches, optimizer steps on 2, 4, 6 and 7 (the last one at the
   end of the dataloader), the flash kernels launched 2L / L / L per
   micro-batch.  Run A saves a verified checkpoint after step 2 (automatic
   naming, SHA-256 manifest) and runs to the end; run B, a fresh
   accelerator, model (another seed), optimizer, scheduler and loader,
   resumes from it with ``resume_from_latest`` and must end bit-identical
   to run A: losses of micro-batches 5-7, parameters and AdamW state.
   Prints the free disk space first (fails under twice the checkpoint),
   the micro-batch times, the bytes written, the save time split into
   device-to-host, write, manifest (hashing) and publish, the load time
   split into verify and read-and-place, and the prefetcher's host-blocked
   time per batch.  The checkpoint lives under ``build/`` beside this
   script and is deleted at the end.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
package beside it, the script exits non-zero and prints no result.
"""

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# fp32 on the CUDA cores; bf16 and fp16 dense on the tensor cores
PEAK_FLOPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12, "torch.float16": 989e12}
TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2, "torch.float16": 2e-2}
# Phase 5, bf16 training step, kernel path against plain path: the loss
# (absolute) and each gradient leaf (max |diff| over the plain leaf's max).
BF16_LOSS_TOL = 1e-3
BF16_GRAD_TOL = 5e-2
SOURCE = "accelerate_tpu_torch/ops/csrc/paged_attention_sm90.cu"
PAGED_PREVIOUS = "accelerate_tpu_torch/ops/csrc/paged_attention.cu"  # the first paged body, timed only
PAGED_DESIGN = ("split kernel, CTA per (slot x kv head, split of C pool positions, 16 query "
                "rows), empty splits exit at once; the split's table entries once in shared "
                "memory; 2-4 stage CTA-wide cp.async K/V ring of 64 positions; bf16/fp16 "
                "mma.sync m16n8k16 for Q.K^T and P.V, P kept in registers, K/V fragments by "
                "ldmatrix (.trans for V); fp32 on CUDA-core FMA; fp32 partials (o, m, l); "
                "merge kernel per (slot x kv head): lse merge of the used splits, the W new "
                "rows folded in under kw <= qw; C from host shapes only")
PHASE1_SHAPES = (("long", [0, 1, 15, 16, 17, 300, 1000, 4100]),
                 ("serving", [0, 5, 16, 100, 300, 700, 1000, 1023]))
SPLIT_SWEEP = (64, 128, 256)
FLASH_SOURCE = "accelerate_tpu_torch/ops/csrc/flash_attention.cu"
FWD_SOURCE = "accelerate_tpu_torch/ops/csrc/flash_fwd_sm90.cu"  # bf16 and fp16 forward
FWD_DESIGN = ("bf16/fp16: wgmma m64n128k16 Q.K^T (smem descriptors) and P.V (P in registers, "
              "V MN-major), TMA 4-D maps into a 2-stage mbarrier K/V ring, 128-row CTA of 2 "
              "consumer warpgroups + a producer warpgroup (one warp loads), setmaxnreg 232/40; "
              "fp32: the CUDA-core body of flash_attention.cu")
DQ_SOURCE = "accelerate_tpu_torch/ops/csrc/flash_bwd_dq_sm90.cu"  # bf16 and fp16 dQ
DQ_DESIGN = ("bf16/fp16: 128-row CTA of one (batch, q head), 2 consumer warpgroups of 64 rows "
             "+ a producer warp, setmaxnreg 240/24; Q/dO by TMA once, 64-key K/V tiles of the "
             "kv head by TMA into a 3-stage mbarrier ring with kv_valid bytes and an all-valid "
             "flag (lse, delta by plain loads per row); wgmma m64n64k16 S = Q.K^T and "
             "dP = dO.V^T (smem descriptors), dS in registers as A of wgmma m64n{d}k16 "
             "dQ += dS.K (K MN-major); heaviest causal q tiles first; no atomics; fp32: the "
             "CUDA-core body of flash_attention.cu")
DKV_SOURCE = "accelerate_tpu_torch/ops/csrc/flash_bwd_dkv_sm90.cu"  # bf16 and fp16 dK/dV
DKV_DESIGN = ("bf16/fp16: 128-key CTA of one (batch, kv head), 2 consumer warpgroups of 64 keys "
              "+ a producer warp, setmaxnreg 240/24; K/V by TMA once, 64-row Q/dO tiles of the "
              "G query heads by TMA into a 3-stage mbarrier ring (lse, delta by plain loads); "
              "wgmma m64n64k16 S^T = K.Q^T and dP^T = V.dO^T (smem descriptors), P^T and dS^T "
              "in registers as A of wgmma m64n{d}k16 dV += P^T.dO (P as hi + lo) and "
              "dK += dS^T.Q (Q/dO MN-major); no atomics; fp32: the CUDA-core body of "
              "flash_attention.cu")
REPLACES = {
    "paged_attention": "accelerate_tpu/ops/pallas_attention.py:564",
    "paged_window_attention": "accelerate_tpu/ops/pallas_attention.py:686",
    "fused_attention_fwd": "accelerate_tpu/ops/pallas_attention.py:96",
    "fused_attention_bwd_dq": "accelerate_tpu/ops/pallas_attention.py:206",
    "fused_attention_bwd_dkv": "accelerate_tpu/ops/pallas_attention.py:258",
}
FLASH_KERNELS = ("fused_attention_fwd", "fused_attention_bwd_dq", "fused_attention_bwd_dkv")


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


def graph_ms(fn, arg_sets, iters=30, replays=3):
    """Mean device time of ``fn(*args)`` with the host out of the way: the
    ``iters`` calls (cycling through ``arg_sets``, as :func:`cuda_ms`) are
    captured once in a CUDA graph, which is replayed.  A call whose host
    side (checks, allocations, two launches) takes longer than its kernels
    would otherwise be timed at the host's pace."""
    import torch

    for args in arg_sets:
        fn(*args)  # builds, shared-memory attributes: outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


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


def previous_paged(window):
    """The first paged body (``paged_attention.cu``) called directly, so it is not
    counted as a launch of the wrapper."""
    import ctypes

    import torch

    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import paged_attention as pa

    symbol = "atpu_paged_window_attention" if window else "atpu_paged_attention"
    fn = getattr(_build.load("paged_attention"), symbol)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * (7 if window else 6)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, k_new, v_new, pool_k, pool_v, tables, lengths):
        out = torch.empty_like(q)
        rc = fn(pa._DTYPE_CODES[q.dtype], q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                pool_k.data_ptr(), pool_v.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), q.shape[0], q.shape[-2], pool_k.shape[2], q.shape[-1],
                pool_k.shape[1], tables.shape[1], *((q.shape[1],) if window else ()),
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"{symbol} launch failed: CUDA error {rc}")
        return out

    return call


def split_ctas(a, window, split_tokens):
    """CTAs the split kernel launches, those that do work (splits below each
    slot's length), and the merge kernel's CTAs."""
    q, pk = a["q"], a["pool_k"]
    bs, kh = pk.shape[1], pk.shape[2]
    m = a["tables"].shape[1]
    rows = q.shape[-2] // kh * (window or 1)
    groups = -(-rows // 16)
    ns = -(-m * bs // split_tokens)
    lens = [min(int(n), m * bs) for n in a["lengths"].tolist()]
    b = len(lens)
    return dict(launched=b * kh * ns * groups,
                working=sum(-(-n // split_tokens) for n in lens) * kh * groups,
                merge=b * kh * groups)


def phase1():
    import torch

    from accelerate_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    order = ("q", "k_new", "v_new", "pool_k", "pool_v", "tables", "lengths")
    results = {}
    for shape, lengths in PHASE1_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for name, window in (("paged_attention", None), ("paged_window_attention", 4)):
                kern = getattr(pa, name)
                plain = getattr(pa, name + "_plain")
                prev = previous_paged(window)
                a = kernel_inputs(dtype, window, lengths, gen)
                tol = TOL[str(dtype)]
                got = kern(**a)
                torch.cuda.synchronize()
                want = plain(**a)
                err = (got.float() - want.float()).abs().max().item()
                check(torch.isfinite(got).all().item(), f"{name} {dtype}: non-finite output")
                check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
                      f"{name} {dtype} {shape}: max abs err {err} over atol=rtol={tol}")
                got_prev = prev(**a)
                torch.cuda.synchronize()
                prev_err = (got_prev.float() - want.float()).abs().max().item()
                check(torch.allclose(got_prev.float(), want.float(), atol=tol, rtol=tol),
                      f"previous {name} {dtype} {shape}: max abs err {prev_err} over {tol}")
                pool_bytes = 2 * a["pool_k"].numel() * a["pool_k"].element_size()
                copies = [a] + [dict(a, pool_k=a["pool_k"].clone(), pool_v=a["pool_v"].clone())
                                for _ in range(math.ceil(100e6 / pool_bytes) - 1)]
                sets = [tuple(c[k] for k in order) for c in copies]
                # Device times from CUDA graphs, in turns: kernel, previous,
                # previous, kernel; then the eager call as the serving loop
                # makes it (host checks and launches included).
                turns = [graph_ms(f, sets) for f in (kern, prev, prev, kern)]
                k_ms, prev_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                eager_ms = cuda_ms(kern, sets)
                p_ms = graph_ms(plain, sets[:1], iters=5, replays=2)
                lib_fn, lib_args = library_call(a, window)
                lib_ms = graph_ms(lib_fn, [lib_args], iters=10)
                b_ms, b_by = bound_ms(a, window)
                bs, m = a["pool_k"].shape[1], a["tables"].shape[1]
                c = pa.pick_split_tokens(len(lengths), a["pool_k"].shape[2], m, bs, sms)
                ctas = split_ctas(a, window, c)
                # The merge kernel alone on partials of the same shape.
                wa = {k: (v if window else v[:, None]) if k in ("q", "k_new", "v_new") else v
                      for k, v in a.items()}
                part = [t.contiguous() for t in pa.paged_split_partials_plain(
                    wa["q"], a["pool_k"], a["pool_v"], a["tables"], a["lengths"], c)]
                merge_args = (wa["q"], wa["k_new"], wa["v_new"], *part, a["lengths"], c, bs, m)
                merge_ms = graph_ms(pa.paged_split_merge, [merge_args])
                # The same inputs with the table cut to the longest slot's
                # blocks: fewer empty split CTAs, the same work.
                tight = dict(a, tables=a["tables"][:, :-(-max(lengths) // bs)].contiguous())
                tight_ms = graph_ms(kern, [tuple(tight[k] for k in order)])
                results[(name, str(dtype), shape)] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms, previous_ms=prev_ms, previous_max_abs_err=prev_err,
                    merge_ms=merge_ms, tight_table_ms=tight_ms, eager_ms=eager_ms,
                    split_tokens=c, ctas=ctas,
                )
                log(f"phase1 {name} {dtype} W={window or 1} {shape} lengths={lengths} "
                    f"table={m}: max_abs_err={err:.3e} (atol=rtol={tol}) kernel_ms={k_ms:.4f} "
                    f"previous_ms={prev_ms:.4f} (max_abs_err {prev_err:.3e}) plain_ms={p_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({b_by}) library_ms={lib_ms:.4f} merge_ms={merge_ms:.4f} "
                    f"eager_call_ms={eager_ms:.4f} "
                    f"tight_table_ms={tight_ms:.4f} split_tokens={c} split_ctas_launched="
                    f"{ctas['launched']} split_ctas_working={ctas['working']} "
                    f"merge_ctas={ctas['merge']}")
                if dtype == torch.bfloat16:
                    sweep = {s: graph_ms(lambda *x, s=s: pa._launch(
                        *x, window=window is not None, split_tokens=s), sets)
                        for s in SPLIT_SWEEP}
                    log(f"phase1 {name} bf16 {shape} split sweep (ms by positions per split): "
                        + " ".join(f"C={s}:{t:.4f} (working CTAs "
                                   f"{split_ctas(a, window, s)['working']})"
                                   for s, t in sweep.items()))
                del a, copies, sets, lib_args, part, merge_args, tight
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
    paged = [(t, n) for t, n, key in by_kernel if "paged_" in key]
    # Idle share: the device's gaps between kernels within the event-timed
    # step (the host launching the next kernel), 1 - busy / step time.
    log(f"phase2 decode step (8 slots, 32 layers): kernel_path_ms={k_ms:.3f} "
        f"einsum_path_ms={e_ms:.3f}; profiled step wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
        f"idle_share={(1 - busy / k_ms) if busy else float('nan'):.3f}; paged kernels "
        f"{sum(t for t, _ in paged):.3f} ms in {sum(n for _, n in paged)} launches "
        "(split + merge)")
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


# ---------------------------------------------------------------------------
# Phase 4: flash-attention training kernels against their plain versions
# ---------------------------------------------------------------------------


def flash_inputs(dtype, b, s, pad, gen, h=32, kh=8, d=128):
    """q, k, v, dO on the card; with ``pad``, batch 0's first ``pad`` keys
    are invalid (left padding: under the causal mask its first rows admit
    no key at all)."""
    import torch

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    valid = None
    if pad:
        valid = torch.ones(b, s, dtype=torch.int8, device="cuda")
        valid[0, :pad] = 0
    return randn(b, s, h, d), randn(b, s, kh, d), randn(b, s, kh, d), randn(b, s, h, d), valid


def attention_delta(out, do):
    """δ = rowsum(dO∘O), fp32 ``[B, H, S]``, as the backward computes it."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bounds(q, k, causal):
    """Least time of each kernel's work at these shapes: operations over the
    dtype's peak against bytes (each input read once, each output written
    once) over the memory rate, the larger of the two.  A score product is
    2 * d flops per admitted (query, key) pair: the forward does 2 products
    (S = QK^T, P.V), dQ 3 (S, dP, dS.K), dK/dV 4 (S^T, dP^T, P^T.dO, dS^T.Q)."""
    b, s, h, d = q.shape
    pairs = s * (s + 1) // 2 if causal else s * s
    flop = 2 * b * h * d * pairs
    es = q.element_size()
    qb, kb, stat = q.numel() * es, k.numel() * es, b * h * s * 4
    work = {
        "fused_attention_fwd": (2 * flop, 2 * qb + 2 * kb + stat),
        "fused_attention_bwd_dq": (3 * flop, 3 * qb + 2 * kb + 2 * stat),
        "fused_attention_bwd_dkv": (4 * flop, 2 * qb + 4 * kb + 2 * stat),
    }
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops = ops / PEAK_FLOPS[str(q.dtype)] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return out, flop


def phase4():
    import torch
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import fused_attention as fu
    from accelerate_tpu_torch.ops.flash_attention import pick_block_pallas

    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        tol = TOL[str(dtype)]
        for b, s, causal, pad in ((2, 2048, True, 0), (2, 1024, False, 0), (2, 2048, True, 300)):
            blk = pick_block_pallas(s, 128)
            q, k, v, do, valid = flash_inputs(dtype, b, s, pad, gen)
            out, lse = fu.fused_attention_fwd(q, k, v, valid, causal=causal, block_size=blk)
            dq, dk, dv = fu.fused_attention_bwd(q, k, v, out, lse, do, valid, causal=causal,
                                                block_size=blk)
            torch.cuda.synchronize()
            want_out, want_lse = fu.fused_attention_fwd_plain(q, k, v, valid, causal=causal,
                                                              block_size=blk)
            # The backward kernels are held against the plain backward on the
            # same saved (out, lse), so each comparison isolates one pass.
            want = fu.fused_attention_bwd_plain(q, k, v, out, lse, do, valid, causal=causal,
                                                block_size=blk)
            errs = {}
            for name, got, ref in (("out", out, want_out), ("lse", lse, want_lse),
                                   ("dq", dq, want[0]), ("dk", dk, want[1]),
                                   ("dv", dv, want[2])):
                check(bool(torch.isfinite(got).all()), f"flash {dtype} {name}: non-finite")
                errs[name] = (got.float() - ref.float()).abs().max().item()
                check(torch.allclose(got.float(), ref.float(), atol=tol, rtol=tol),
                      f"flash {dtype} B{b} S{s} causal={causal} pad={pad} {name}: "
                      f"max abs err {errs[name]} over atol=rtol={tol}")
            if pad:
                check(bool((out[0, :pad] == 0).all()) and bool((dq[0, :pad] == 0).all()),
                      "empty rows must output zero and get zero gradient")
            log(f"phase4 flash {dtype} B={b} S={s} causal={causal} left_pad={pad}: max_abs_err "
                + " ".join(f"{n}={e:.3e}" for n, e in errs.items()) + f" (atol=rtol={tol})")
            if (s, causal, pad) == (2048, True, 0) and dtype != torch.float16:
                results[str(dtype)] = flash_times(fu, F, q, k, v, do, out, lse, blk, errs)
            del q, k, v, do, valid, out, lse, dq, dk, dv, want_out, want_lse, want
            torch.cuda.empty_cache()
    return results


def previous_fwd(fu, q, k, v):
    """The CUDA-core forward body (``atpu_flash_fwd``) on 16-bit inputs,
    called directly so it is not counted as a launch of the wrapper."""
    import torch

    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    fu._launch("atpu_flash_fwd", q, k, v, None, None, out.data_ptr(), lse.data_ptr(),
               causal=True)
    return out, lse


def direct_bwd(fu, symbol, q, k, v, do, lse, delta):
    """A backward launcher (``symbol``, dQ's or dK/dV's) called directly, so
    it is not counted as a launch of the wrapper.  Returns ``(dq,)`` or
    ``(dk, dv)``."""
    import torch

    outs = ((torch.empty_like(q),) if "_dq" in symbol
            else (torch.empty_like(k), torch.empty_like(v)))
    fu._launch(symbol, q, k, v, None, do.data_ptr(), lse.data_ptr(), delta.data_ptr(), None,
               *(o.data_ptr() for o in outs), causal=True)
    return outs


def bwd_variants(fu, copies, wrapper, symbols, want, kernel_ms):
    """A backward kernel's previous body (``symbols["previous"]``, held to
    the plain version's tolerance) and one variant (the other entry, its
    error reported) on the first input set: errors against ``want``, and
    times in turns with the kernel (kernel, previous, variant, variant,
    previous, kernel).  Returns the record's extra keys (``<name>_ms``,
    ``<name>_max_abs_err``) and the kernel's second time."""
    import torch

    q, k, v, do, lse, delta = copies[0]
    tol = TOL[str(q.dtype)]
    errs = {}
    for name, symbol in symbols.items():
        got = direct_bwd(fu, symbol, q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all()) for g in got), f"{symbol}: non-finite output")
        errs[name] = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        if name == "previous":
            check(all(torch.allclose(g.float(), w.float(), atol=tol, rtol=tol)
                      for g, w in zip(got, want)),
                  f"previous {wrapper} body: max abs err {errs[name]} over atol=rtol={tol}")
        del got
    variant = next(name for name in symbols if name != "previous")
    times = {name: [] for name in symbols}
    for name in ("previous", variant, variant, "previous"):
        times[name].append(cuda_ms(lambda *a, sym=symbols[name]: direct_bwd(fu, sym, *a),
                                   copies, iters=10))
    second = cuda_ms(getattr(fu, wrapper), copies, iters=10)
    log(f"phase4 {wrapper} {q.dtype} in turns: kernel {kernel_ms:.4f} "
        f"previous {times['previous'][0]:.4f} {variant} {times[variant][0]:.4f} "
        f"{variant} {times[variant][1]:.4f} previous {times['previous'][1]:.4f} "
        f"kernel {second:.4f} ms; max abs err previous {errs['previous']:.3e} "
        f"{variant} {errs[variant]:.3e}")
    extra = {}
    for name in symbols:
        extra[f"{name}_ms"] = sum(times[name]) / 2
        extra[f"{name}_max_abs_err"] = errs[name]
    return extra, second


def flash_times(fu, F, q, k, v, do, out, lse, blk, errs):
    """Kernel, plain, bound and library times at the main shape; in 16-bit
    types also the previous forward, dQ and dK/dV bodies' times and errors,
    the dQ kernel's with a 2-stage ring and the dK/dV kernel's without the
    lo half of P."""
    import torch

    delta = attention_delta(out, do)
    set_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, do))
    copies = [(q, k, v, do, lse, delta)] + [
        tuple(t.clone() for t in (q, k, v, do, lse, delta))
        for _ in range(math.ceil(100e6 / set_bytes) - 1)
    ]
    fwd_sets = [c[:3] for c in copies]
    times = {
        "fused_attention_fwd": cuda_ms(
            lambda q, k, v: fu.fused_attention_fwd(q, k, v, causal=True, block_size=blk),
            fwd_sets, iters=10),
        "fused_attention_bwd_dq": cuda_ms(
            lambda *a: fu.fused_attention_bwd_dq(a[0], a[1], a[2], a[3], a[4], a[5]), copies,
            iters=10),
        "fused_attention_bwd_dkv": cuda_ms(
            lambda *a: fu.fused_attention_bwd_dkv(a[0], a[1], a[2], a[3], a[4], a[5]), copies,
            iters=10),
    }
    plain_fwd = cuda_ms(
        lambda q, k, v: fu.fused_attention_fwd_plain(q, k, v, causal=True, block_size=blk),
        fwd_sets[:1], iters=3)
    prev = prev_bwd = None
    if q.dtype != torch.float32:
        prev_out, prev_lse = previous_fwd(fu, q, k, v)
        torch.cuda.synchronize()
        want_out, _ = fu.fused_attention_fwd_plain(q, k, v, causal=True, block_size=blk)
        tol = TOL[str(q.dtype)]
        prev_err = (prev_out.float() - want_out.float()).abs().max().item()
        check(torch.allclose(prev_out.float(), want_out.float(), atol=tol, rtol=tol),
              f"previous forward body {q.dtype}: max abs err {prev_err} over atol=rtol={tol}")
        # In turns with the kernel (kernel above, previous, previous, kernel).
        prev_ms = [cuda_ms(lambda *a: previous_fwd(fu, *a), fwd_sets, iters=10)
                   for _ in range(2)]
        times["fused_attention_fwd"] = 0.5 * (times["fused_attention_fwd"] + cuda_ms(
            lambda q, k, v: fu.fused_attention_fwd(q, k, v, causal=True, block_size=blk),
            fwd_sets, iters=10))
        prev = dict(previous_ms=sum(prev_ms) / 2, previous_max_abs_err=prev_err)
        del prev_out, prev_lse, want_out
        want_dq, want_dk, want_dv = fu.fused_attention_bwd_plain(q, k, v, out, lse, do,
                                                                 causal=True, block_size=blk)
        prev_bwd = {}
        for name, symbols, want in (
                ("fused_attention_bwd_dq",
                 {"previous": "atpu_flash_bwd_dq", "ring2": "atpu_flash_bwd_dq_sm90_ring2"},
                 (want_dq,)),
                ("fused_attention_bwd_dkv",
                 {"previous": "atpu_flash_bwd_dkv", "nolo": "atpu_flash_bwd_dkv_sm90_nolo"},
                 (want_dk, want_dv))):
            prev_bwd[name], second = bwd_variants(fu, copies, name, symbols, want, times[name])
            times[name] = 0.5 * (times[name] + second)
        del want_dq, want_dk, want_dv
    # One plain backward computes dQ, dK and dV together: its time stands
    # beside both backward kernels.
    plain_bwd = cuda_ms(
        lambda q, k, v, do: fu.fused_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                                         block_size=blk),
        [(q, k, v, do)], iters=3)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))

    def sdpa(qt, kt, vt):
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd(qt, kt, vt, dot):
        qt, kt, vt = (t.detach().requires_grad_() for t in (qt, kt, vt))
        sdpa(qt, kt, vt).backward(dot)

    lib_fwd = cuda_ms(sdpa, [(qt, kt, vt)], iters=10)
    lib_fwd_bwd = cuda_ms(sdpa_fwd_bwd, [(qt, kt, vt, dot)], iters=10)
    delta_ms = cuda_ms(attention_delta, [(out, do)], iters=10)
    bounds, flop = flash_bounds(q, k, True)
    err = {"fused_attention_fwd": errs["out"], "fused_attention_bwd_dq": errs["dq"],
           "fused_attention_bwd_dkv": max(errs["dk"], errs["dv"])}
    rec = {}
    for name in FLASH_KERNELS:
        b_ms, b_by = bounds[name]
        fwd = name == "fused_attention_fwd"
        rec[name] = dict(max_abs_err=err[name], ms=times[name],
                         plain_ms=plain_fwd if fwd else plain_bwd, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_fwd if fwd else None)
        extra = prev if fwd else prev_bwd.get(name) if prev_bwd else None
        if prev and extra:
            rec[name].update(extra)
        log(f"phase4 {name} {q.dtype} B=2 S=2048 causal: kernel_ms={times[name]:.4f} "
            f"plain_ms={rec[name]['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by})"
            + (f" library_ms={lib_fwd:.4f}" if fwd else "")
            + ("".join(f" {key}={val:.4f}" if key.endswith("ms") else f" {key}={val:.3e}"
                       for key, val in extra.items()) if prev and extra else ""))
    if prev:
        tflops = 2 * flop / times["fused_attention_fwd"] / 1e9
        log(f"phase4 fused_attention_fwd {q.dtype}: {tflops:.1f} TFLOP/s of least work; "
            f"previous body {2 * flop / prev['previous_ms'] / 1e9:.1f}")
        dq_ms, dq_var = times["fused_attention_bwd_dq"], prev_bwd["fused_attention_bwd_dq"]
        log(f"phase4 fused_attention_bwd_dq {q.dtype}: {3 * flop / dq_ms / 1e9:.1f} TFLOP/s "
            f"of least work; 2-stage ring {3 * flop / dq_var['ring2_ms'] / 1e9:.1f}; previous "
            f"body {3 * flop / dq_var['previous_ms'] / 1e9:.1f}")
        dkv_ms, dkv_var = times["fused_attention_bwd_dkv"], prev_bwd["fused_attention_bwd_dkv"]
        log(f"phase4 fused_attention_bwd_dkv {q.dtype}: {4 * flop / dkv_ms / 1e9:.1f} TFLOP/s "
            f"of least work ({5 * flop / dkv_ms / 1e9:.1f} with the lo half); no-lo "
            f"{4 * flop / dkv_var['nolo_ms'] / 1e9:.1f}; previous body "
            f"{4 * flop / dkv_var['previous_ms'] / 1e9:.1f}")
    log(f"phase4 delta {q.dtype}: rowsum(dO*O) in torch before the backward kernels, "
        f"delta_ms={delta_ms:.4f} (dQ kernel {times['fused_attention_bwd_dq']:.4f}, dK/dV "
        f"kernel {times['fused_attention_bwd_dkv']:.4f})")
    bwd_ms = delta_ms + times["fused_attention_bwd_dq"] + times["fused_attention_bwd_dkv"]
    log(f"phase4 {q.dtype} whole attention: kernels fwd+delta+dq+dkv "
        f"{times['fused_attention_fwd'] + bwd_ms:.4f} ms (backward {bwd_ms:.4f}, delta "
        f"{delta_ms:.4f}) against sdpa fwd+bwd {lib_fwd_bwd:.4f} ms (fwd {lib_fwd:.4f}, "
        f"bwd by difference {lib_fwd_bwd - lib_fwd:.4f}); "
        f"least work fwd {2 * flop / 1e9:.1f} GFLOP, backward {5 * flop / 1e9:.1f} GFLOP")
    return rec


# ---------------------------------------------------------------------------
# Phase 5: training at full width
# ---------------------------------------------------------------------------


def reset_flash_counts():
    from accelerate_tpu_torch.ops import fused_attention as fu

    for name in FLASH_KERNELS:
        getattr(fu, name).launches = 0


def read_flash_counts():
    from accelerate_tpu_torch.ops import fused_attention as fu

    return {name: getattr(fu, name).launches for name in FLASH_KERNELS}


@contextlib.contextmanager
def plain_flash():
    """Inside the block the fused op runs its plain versions in place of the
    kernels (its autograd function looks the wrappers up at each call)."""
    from accelerate_tpu_torch.ops import fused_attention as fu

    saved = fu.fused_attention_fwd, fu.fused_attention_bwd
    fu.fused_attention_fwd = fu.fused_attention_fwd_plain
    fu.fused_attention_bwd = fu.fused_attention_bwd_plain
    try:
        yield
    finally:
        fu.fused_attention_fwd, fu.fused_attention_bwd = saved


def loss_and_grads(model, cfg, batch):
    import torch

    from accelerate_tpu_torch.models import llama

    loss = llama.loss_fn(model.params, batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


def phase5():
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import llama

    layers, b, s = 4, 2, 2048
    cfg = llama.LlamaConfig.llama3_8b(num_layers=layers, dtype=torch.bfloat16,
                                      param_dtype=torch.float32, remat=True)
    t0 = time.perf_counter()
    model = llama.LlamaForCausalLM(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = cfg.num_params()
    log(f"phase5 Llama-3-8B widths, {layers} layers, fp32 params={n_params} "
        f"init_s={time.perf_counter() - t0:.1f}")
    rng = np.random.default_rng(0)
    batch = {"input_ids": torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s))).cuda()}

    # fp32 activations: the kernel path against the plain path, loss and
    # every gradient leaf (relative to the leaf's largest entry).
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    loss_k, grads_k = loss_and_grads(model, cfg32, batch)
    with plain_flash():
        loss_p, grads_p = loss_and_grads(model, cfg32, batch)
    rel = max(((gk - gp).abs().max() / gp.abs().max()).item() for gk, gp in zip(grads_k, grads_p))
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"phase5 fp32 step, kernel vs plain path: loss {loss_k.item():.6f} vs "
        f"{loss_p.item():.6f} (rel {loss_rel:.3e}); max over {len(grads_k)} gradient leaves of "
        f"max|diff|/max|plain| = {rel:.3e} (limit 1e-4)")
    check(loss_rel <= 1e-4 and rel <= 1e-4, f"fp32 kernel path differs: loss {loss_rel}, grad {rel}")
    del grads_k, grads_p
    torch.cuda.empty_cache()

    # bf16 activations: the loss barely moves with attention at random init,
    # so the gradients are held too.  Both limits sit a few times above the
    # readings on an H100 (PERF.md, Findings).
    loss_k, grads_k = loss_and_grads(model, cfg, batch)
    with plain_flash():
        loss_p, grads_p = loss_and_grads(model, cfg, batch)
    loss_k, loss_p = loss_k.item(), loss_p.item()
    rels = [((gk - gp).abs().max() / gp.abs().max()).item() for gk, gp in zip(grads_k, grads_p)]
    names = [n for n, _ in model.named_parameters()]
    log(f"phase5 bf16 step, kernel vs plain path: loss {loss_k:.5f} vs {loss_p:.5f} "
        f"(|diff| {abs(loss_k - loss_p):.3e}, limit {BF16_LOSS_TOL}); per gradient leaf "
        "max|diff|/max|plain|: " + " ".join(f"{n}={r:.3e}" for n, r in zip(names, rels))
        + f" (limit {BF16_GRAD_TOL})")
    check(abs(loss_k - loss_p) <= BF16_LOSS_TOL, f"bf16 loss differs by {abs(loss_k - loss_p)}")
    check(max(rels) <= BF16_GRAD_TOL, f"bf16 gradients differ: {max(rels)}")
    del grads_k, grads_p
    torch.cuda.empty_cache()

    acc = Accelerator()
    lr = 3e-5  # the loss falls at every one of the 5 steps at this rate, not at every rate
    log(f"phase5 AdamW lr={lr} weight_decay=1e-4")
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=lr,
                                                      weight_decay=1e-4))
    step = acc.make_train_step(model, opt)
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    losses, step_s = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        losses.append(step(batch).item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = read_flash_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase5 5 steps on one batch: losses {[round(x, 5) for x in losses]} launches {counts} "
        f"peak_mem_gb={peak_gb:.1f}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(all(b_ < a for a, b_ in zip(losses, losses[1:])), f"loss not falling: {losses}")
    want = {"fused_attention_fwd": 2 * layers * 5, "fused_attention_bwd_dq": layers * 5,
            "fused_attention_bwd_dkv": layers * 5}
    check(counts == want, f"kernel launches {counts}, want {want} (2L, L, L per step)")

    # Model FLOPs per step: 6 per non-embedding parameter (the LM head
    # counted) per token, plus attention's forward and backward (3.5 x the
    # forward's 2 products; the recomputed forward under remat not counted).
    tokens = b * s
    dense = n_params - cfg.vocab_size * cfg.hidden_size  # the embedding is a lookup
    pairs = s * (s + 1) // 2
    attn = layers * 3.5 * 4 * b * cfg.num_heads * cfg.head_dim_ * pairs
    flops = 6 * dense * tokens + attn
    ms = median(step_s[1:]) * 1e3
    log(f"phase5 step_ms={ms:.2f} (median of steps 2-5; first {step_s[0] * 1e3:.2f}) "
        f"tokens_per_s={tokens / ms * 1e3:.1f} model_tflop_per_step={flops / 1e12:.2f} "
        f"bf16_peak_share={flops / (ms / 1e3) / PEAK_FLOPS['torch.bfloat16']:.4f} "
        f"floor_ms={flops / PEAK_FLOPS['torch.bfloat16'] * 1e3:.2f}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels only: a GPU user annotation (the optimizer's step span) also
    # carries device time, which would count its kernels twice.
    by_kernel = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
         and not getattr(e, "is_user_annotation", False)),
        reverse=True,
    )
    busy = sum(t for t, _, _ in by_kernel)
    groups = {"flash kernels": 0.0, "GEMMs": 0.0, "other": 0.0}
    flash = []
    for t, n, key in by_kernel:
        low = key.lower()
        if "flash_" in low and "kernel" in low:
            groups["flash kernels"] += t
            name = re.search(r"flash_\w*kernel", key)
            flash.append(f"{name.group(0) if name else key[:40]} {t:.3f} ms in {n}")
        elif any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma", "cublas", "sm90_")):
            groups["GEMMs"] += t
        else:
            groups["other"] += t
    log(f"phase5 profiled step: wall_ms={wall_ms:.2f} device_busy_ms={busy:.2f} "
        f"idle_share={1 - busy / wall_ms:.3f}; by group (ms) "
        + " ".join(f"{k}={v:.2f}" for k, v in groups.items()) + "; flash: " + ", ".join(flash))
    for t, n, key in by_kernel[:10]:
        log(f"phase5   device {t:.3f} ms in {n} launches: {key[:110]}")
    del model, opt, step
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# Phase 6: the README's training loop with a checkpoint round trip
# ---------------------------------------------------------------------------

PHASE6_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase6")


def readme_run(cfg, data, seed, resume, smi, record=None):
    """One run of the README loop over ``data``; run A (``resume`` False)
    saves after optimizer step 2 and fills ``record``; run B resumes.
    Returns the per-micro-batch losses, the micro-batches that synced, the
    micro-batch times, the launch counts, the accelerator, model,
    optimizer and loader."""
    import torch
    from torch.utils.data import DataLoader

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.utils.dataclasses import (
        DataLoaderConfiguration,
        ProjectConfiguration,
    )

    acc = Accelerator(
        gradient_accumulation_steps=2,
        dataloader_config=DataLoaderConfiguration(use_seedable_sampler=True,
                                                  use_stateful_dataloader=True,
                                                  prefetch_to_device=2),
        project_config=ProjectConfiguration(project_dir=PHASE6_DIR,
                                            automatic_checkpoint_naming=True, total_limit=2))
    model = llama.LlamaForCausalLM(cfg, seed=seed)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-5, weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda n: min(1.0, (n + 1) / 4))
    model, opt, dl, sched = acc.prepare(model, opt, DataLoader(data, batch_size=2, shuffle=True),
                                        sched)
    tag = "B" if resume else "A"
    if resume:
        step = acc.resume_from_latest()
        t = acc.last_load_timing
        log(f"phase6 run B resume_from_latest -> {step}; load verify_s={t['verify_s']:.3f} "
            f"read_place_s={t['read_place_s']:.3f} ({smi})")
        check(step == 2, f"resume_from_latest returned {step}, want 2")
        now = dict(lr=opt.learning_rate, sched_steps=sched._step_count,
                   last_epoch=sched.scheduler.last_epoch,
                   sampler=(dl.sampler.epoch, dl.sampler.initial_seed), loader=dl.state_dict())
        log(f"phase6 run B restored {now}; run A at the save {record['at_save']}")
        check(now == record["at_save"], f"restored state {now} != run A's {record['at_save']}")
    torch.cuda.synchronize()
    reset_flash_counts()
    losses, synced, times, ids = [], [], [], []
    t0 = time.perf_counter()
    for batch in dl:
        ids.append(batch["input_ids"].cpu())
        with acc.accumulate(model):
            loss = model(**batch)["loss"]
            acc.backward(loss)
            opt.step()
            sched.step()
            opt.zero_grad()
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        if acc.sync_gradients:
            synced.append((len(losses), acc.gradient_state.end_of_dataloader))
            if not resume and opt._step_count == 2:
                path = acc.save_state(step=2)
                record["path"] = path
                record["at_save"] = dict(
                    lr=opt.learning_rate, sched_steps=sched._step_count,
                    last_epoch=sched.scheduler.last_epoch,
                    sampler=(dl.sampler.epoch, dl.sampler.initial_seed), loader=dl.state_dict())
                t = acc.last_save_timing
                log(f"phase6 run A save_state -> {path}: bytes={t['bytes']} "
                    f"({t['bytes'] / 1e9:.3f} GB) d2h_s={t['d2h_s']:.3f} "
                    f"write_s={t['write_s']:.3f} "
                    f"manifest_s={t['manifest_s']:.3f} publish_s={t['publish_s']:.3f} "
                    f"total_s={t['d2h_s'] + t['write_s'] + t['manifest_s'] + t['publish_s']:.3f} "
                    f"({smi}); at the save {record['at_save']}")
                t0 = time.perf_counter()  # the save is not a micro-batch's time
    counts = read_flash_counts()
    blocked = dl.prefetch_blocked_ms
    log(f"phase6 run {tag}: losses {[round(x, 6) for x in losses]} synced (micro-batch, "
        f"end_of_dataloader) {synced} launches {counts} micro_batch_ms "
        f"{[round(x * 1e3, 2) for x in times]} prefetch host-blocked ms per batch "
        f"{[round(x, 3) for x in blocked]} ({smi})")
    if resume:
        check(torch.equal(ids[0], record["ids"][4]), "run B did not start at micro-batch 5")
    else:
        record["ids"] = ids
    return losses, synced, counts, acc, model, opt


def phase6(smi):
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.resilience.manifest import read_manifest, verify_checkpoint

    layers, s, n_seq = 1, 2048, 14
    cfg = llama.LlamaConfig.llama3_8b(num_layers=layers, dtype=torch.bfloat16,
                                      param_dtype=torch.float32, remat=True)
    n_params = cfg.num_params()
    ckpt_bytes = 12 * n_params  # fp32 parameters + AdamW exp_avg + exp_avg_sq
    shutil.rmtree(PHASE6_DIR, ignore_errors=True)
    os.makedirs(PHASE6_DIR)
    disk = shutil.disk_usage(PHASE6_DIR)
    log(f"phase6 Llama-3-8B widths, {layers} layer, params={n_params}, checkpoint ~"
        f"{ckpt_bytes / 1e9:.2f} GB; disk at {PHASE6_DIR}: free={disk.free / 1e9:.2f} GB "
        f"total={disk.total / 1e9:.2f} GB")
    check(disk.free >= 2 * ckpt_bytes, f"free disk {disk.free} < twice the checkpoint "
          f"({2 * ckpt_bytes})")
    rng = np.random.default_rng(0)
    data = [{"input_ids": torch.from_numpy(rng.integers(0, cfg.vocab_size, size=s))}
            for _ in range(n_seq)]
    record = {}
    torch.cuda.reset_peak_memory_stats()
    losses_a, synced_a, counts_a, acc, model, opt = readme_run(cfg, data, 0, False, smi, record)
    want = {"fused_attention_fwd": 2 * layers * n_seq // 2,
            "fused_attention_bwd_dq": layers * n_seq // 2,
            "fused_attention_bwd_dkv": layers * n_seq // 2}
    check(counts_a == want, f"run A launches {counts_a}, want {want} (2L, L, L per micro-batch)")
    check([m for m, _ in synced_a] == [2, 4, 6, 7] and synced_a[-1][1] and opt._step_count == 4,
          f"optimizer steps {synced_a} ({opt._step_count}), want 4 on 2, 4, 6, 7 (end)")
    check(all(math.isfinite(x) for x in losses_a), f"non-finite loss {losses_a}")
    with torch.no_grad():
        again = model(**{"input_ids": record["ids"][0].cuda()})["loss"].item()
    log(f"phase6 first micro-batch's loss {losses_a[0]:.6f} before the first step, {again:.6f} "
        f"after the last (peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.1f})")
    check(again < losses_a[0], f"loss did not fall: {losses_a[0]} -> {again}")
    manifest = read_manifest(record["path"])
    check(manifest["hashed"] and manifest["step"] == 2, f"manifest {manifest['step']}")
    t0 = time.perf_counter()
    verify_checkpoint(record["path"], check_hashes=True)
    log(f"phase6 manifest verified with SHA-256 over {len(manifest['files'])} files "
        f"({sum(e['size'] for e in manifest['files'].values())} bytes) in "
        f"{time.perf_counter() - t0:.3f} s")
    names = [n for n, _ in model.named_parameters()]
    final_params = [p.detach().cpu() for p in model.parameters()]
    final_state = {k: {n: t.cpu() for n, t in v.items()}
                   for k, v in opt.optimizer.state_dict()["state"].items()}
    del acc, model, opt
    torch.cuda.empty_cache()

    losses_b, synced_b, counts_b, acc, model, opt = readme_run(cfg, data, 1, True, smi, record)
    check(counts_b == {k: v * 3 // 7 for k, v in want.items()},
          f"run B launches {counts_b}, want 2L / L / L for 3 micro-batches")
    check([m for m, _ in synced_b] == [2, 3] and synced_b[-1][1] and opt._step_count == 4,
          f"run B optimizer steps {synced_b} ({opt._step_count})")
    check(losses_b == losses_a[4:], f"run B losses {losses_b} != run A's {losses_a[4:]}")
    diff = [n for n, a, b in zip(names, final_params, model.parameters())
            if not torch.equal(a, b.detach().cpu())]
    state_b = opt.optimizer.state_dict()["state"]
    diff += [f"state[{k}].{n}" for k, v in final_state.items() for n, t in v.items()
             if not torch.equal(t, state_b[k][n].cpu())]
    log(f"phase6 run B against run A: losses of micro-batches 5-7 equal; "
        f"{len(final_params)} parameters and {sum(len(v) for v in final_state.values())} AdamW "
        f"state tensors, bit-identical except {diff}")
    check(not diff, f"resumed run differs from the uninterrupted one in {diff}")
    del acc, model, opt, final_params, final_state
    torch.cuda.empty_cache()
    shutil.rmtree(PHASE6_DIR)
    return counts_a


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
    p4 = phase4()
    p5 = phase5()
    p6 = phase6(smi)
    log("kernels: paged_attention, paged_window_attention, " + ", ".join(FLASH_KERNELS))
    launches = {"paged_attention": p2[0]["dec"], "paged_window_attention": p2[3]["win"], **p5}
    check(win3 > 0, "window kernel not launched in phase 3")
    record = []
    for name in ("paged_attention", "paged_window_attention"):
        r = p1[(name, "torch.bfloat16", "long")]
        serving = p1[(name, "torch.bfloat16", "serving")]
        record.append(dict(name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
                           launches=launches[name], **r, previous_source=PAGED_PREVIOUS,
                           design=PAGED_DESIGN,
                           serving_shape={k: serving[k] for k in (
                               "max_abs_err", "ms", "previous_ms", "plain_ms", "bound_ms",
                               "library_ms", "merge_ms", "eager_ms", "split_tokens", "ctas")}))
    for name in ("paged_attention", "paged_window_attention"):
        for shape, _ in PHASE1_SHAPES:
            r = p1[(name, "torch.float32", shape)]
            log(f"kernels fp32 {name} {shape}: ms={r['ms']:.4f} previous_ms={r['previous_ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                f"library_ms={r['library_ms']:.4f} max_abs_err={r['max_abs_err']:.3e}")
    for name in FLASH_KERNELS:
        extra = {}
        sm90 = {"fused_attention_fwd": (FWD_SOURCE, FWD_DESIGN),
                "fused_attention_bwd_dq": (DQ_SOURCE, DQ_DESIGN),
                "fused_attention_bwd_dkv": (DKV_SOURCE, DKV_DESIGN)}.get(name)
        if sm90:
            extra = dict(source=sm90[0], previous_source=FLASH_SOURCE, design=sm90[1],
                         dtypes={"bfloat16": sm90[0], "float16": sm90[0],
                                 "float32": FLASH_SOURCE})
        record.append(dict(dict(name=name, route="cuda", source=FLASH_SOURCE,
                                replaces=REPLACES[name], launches=launches[name],
                                launches_phase6=p6[name],
                                **p4["torch.bfloat16"][name]), **extra))
    for name in FLASH_KERNELS:
        r = p4["torch.float32"][name]
        log(f"kernels fp32 {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} max_abs_err={r['max_abs_err']:.3e}")
    log(json.dumps({"kernels": record}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
