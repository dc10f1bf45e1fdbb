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

7. The serving robustness layer under memory pressure.  7a: Phase 3's
   widths (4 layers, fp32, weights from seed 2) and six prompts, 24 new
   tokens each, over 4 slots and a 21-block pool (20 usable; with 4 slots
   this traffic never preempts a pool of 25 blocks or more),
   ``paged_kernel=True``; every run must be token-identical to
   greedy ``generate`` with no block leaked: the host tier (32 blocks,
   prefix sharing off: migrations, promotions, and every promoted resume
   without a re-prefill), no tier (prefix sharing off: the fallback
   re-prefill),
   ``kv_cache_quant`` (against ``generate`` on the int8 cache; no paged
   launch), ``decode_path="dense"``, ``spec_tokens=3`` with the tier
   (the window kernel launched), journal recovery (an engine abandoned
   undrained after 30 ticks, its successor finishing from the journal),
   and a drain on a SIGUSR1 the process sends itself (the requeue journal
   finished on a successor).  7b: Phase 2's model and weights with 8 slots,
   328 blocks, a 256-block pinned host tier and the journal on, 8 requests
   of 512 + 73 i prompt tokens and 64 new tokens, one every 2 ticks: every
   request ok, migrations > 0, one victim's blocks bit-identical across
   demote -> promote (SHA-256), 32 decode launches per decode dispatch;
   prints demote and promote times and GB/s beside a pinned ``copy_`` of
   the same bytes, TTFT, ITL and decode tokens/s beside Phase 2's, and
   the journal's ms per flush (fsync on).

8. Offline generation, the draft-model drafter and serving traces, at
   full width.  8a: Llama-3-8B (32 layers, bf16, Phase 2's weights):
   sampled ``generate`` over 4 prompts of 960 tokens + 64 (temperature 0.8,
   top-k 50, top-p 0.9, ``PRNGKey``): the same key twice gives the same
   tokens, another key others, and every sampled token lies inside the
   top-50 and the 0.9 nucleus of the logits that ``apply`` (the fused
   forward, launches counted) recomputes over the outputs, up to the bf16
   margin ``NEAR_TIE``; ``generate_beam`` with one beam equals greedy
   ``generate``, four beams on 2 x 512 + 32 timed; greedy
   ``speculative_generate`` (1 x 512 + 64, gamma 4) with a draft at
   Llama-3.2-1B's published widths (seed 3) and with the target as its own
   draft, each token-identical to greedy ``generate`` or parting from it
   only at a near tie, with rounds, proposed and accepted; sampled
   speculative decoding with the target as its own draft and its acceptance
   rate.  8b: fp32 at Phase 7a's widths (4 layers, seed 2): ``generate_beam``
   (4 beams, EOS) and greedy ``speculative_generate`` give the same tokens
   on the card and on the CPU.  8c: Phase 2's geometry and traffic with
   ``spec_tokens=3``, ``DraftModelDrafter`` over the 1B-width draft and
   tracing on (its JSONL under ``build/phase8``): every request ok and
   token-identical to greedy ``generate`` or parting at a near tie, 32
   window launches per verify dispatch, the drafter's fused-forward
   launches counted, each trace's intervals disjoint inside its window,
   verify intervals recorded, the Chrome export read back,
   ``debug_requests()`` mid-run; ITL, decode tokens/s and the tracer's
   hook time; the target as its own draft on 2 requests + 16 (every
   rejected draft a near tie); Phase 2's traffic with tracing off and on
   in turns.

9. The single-process ``Accelerator`` surface and mixed precision.  9a:
   Phase 5's widths (4 layers, fp32 parameters, bf16 compute, B 2 x S
   2048): one forward and backward from seed 0 under
   ``mixed_precision="no"`` and ``"bf16"`` (the loss and every gradient
   but the embedding table's bit-identical: llama casts each weight to
   bf16 at use either way; the forward peak, the memory held after the
   forward and the backward peak of each); then the README loop twice from seed 0 under
   ``Accelerator(mixed_precision="bf16", kwargs_handlers=[ProfileKwargs(...)])``,
   ``prepare(model, AdamW, train loader, eval loader, LambdaLR)``, with
   ``remat_policy="nothing"`` and ``"dots"``: 5 optimizer steps (the
   fifth under ``accelerator.profile()``, whose Chrome trace under
   ``build/phase9`` must name the three sm90 flash kernels), the flash
   kernels launched 2L / L / L per micro-batch under both policies, the
   step time (median of steps 2-5) and peak memory of each, the first
   loss equal across policies and to the parity step's, an eval pass of
   5 sequences at batch 2 whose ``gather_for_metrics`` returns 5 rows,
   ``unwrap_model``, ``print`` once, and ``free_memory`` returning its
   ``None``s and lowering ``memory_allocated``.  9b: the twin of
   ``examples/nlp_example.py``'s ``training_function`` (below) under
   ``mixed_precision="bf16"`` on the card and with ``cpu=True``: each
   accuracy above 0.8, JAX's ``test_nlp_example_learns`` threshold.

10. The wide heads, Gemma-2B at full width and Phi-3-mini.  10a: the three flash
   kernels at head dim 256 (Gemma-2B's 8 q / 1 kv heads, Gemma-7B's 16 /
   16) and 96 (Phi-3-mini's 32 / 32), B 2 x S 2048 causal, unpadded and
   left-padded, in bf16 and fp32 (and fp16 at Gemma-2B's), against their
   plain versions (the forward's out and lse, dQ, dK and dV), with kernel
   (L2-cold copies), plain, bound and ``scaled_dot_product_attention``
   forward and backward times (an error recorded where sdpa refuses the
   shape) and the launcher each wrapper called; in bf16 and fp16 the sm90
   bodies beside the mma.sync bodies they replace (the forward, dQ and
   dK/dV: ``atpu_flash_fwd``, ``atpu_flash_bwd_dq``, ``atpu_flash_bwd_dkv``;
   called directly, not counted) as ``previous_ms`` in turns, each held to
   the tolerance, δ's time beside the backward kernels', and dK/dV at every
   split of the query-head group (``split_ms``, each held to the
   tolerance); the paged pair
   at head dim 96 (bf16, fp32) and 256 (fp32) at Phase 1's long shape
   against plain, with kernel, plain, bound and library times.  10b:
   Gemma-2B (vocab 256000, d 2048, FFN 16384, 18 layers, 8 q / 1 kv head
   of 256, GeGLU, (1 + w) RMSNorm, sqrt(d) embeddings, tied head; random
   weights from seed 0) built by the port's ``config_from_hf`` from
   google/gemma-2b's published ``config.json`` values: the parameters
   through ``export_state_dict`` -> ``import_state_dict`` bit-identical;
   one forward and backward under ``mixed_precision="no"`` and ``"bf16"``
   (the loss equal, the memory held after the forward within one layer's
   bf16 copy of each other, the peaks printed); the first step on the
   kernel path against the plain path, with fp32 activations (loss and
   every gradient within a relative 1e-4) and in bf16 (loss within 1e-4
   of itself, every gradient within a relative 5e-2); then the README loop under
   ``Accelerator(mixed_precision="bf16")``, ``prepare(model, AdamW,
   DataLoader, LambdaLR)``, ``remat=True``, 5 steps at B 2 x S 2048 (B 1
   if the peak reckoned in the log reaches 72 GB): the flash kernels
   launched 2L / L / L = 36 / 18 / 18 a step, the fifth step profiled
   (the trace must name the d-256 kernels: the sm90 forward, dQ and dK/dV
   with its sum kernel), step time, tokens/s, share of
   the bf16 peak, peak memory and idle share.  10c: the trained weights in
   bf16 through ``prepare_serving(paged_kernel=True)`` with Phase 2's
   geometry and traffic, ``spec_tokens`` 0 and 3: 18 paged launches (head
   dim 256) per dispatch, every request token-identical to greedy
   ``generate`` or parting from it at a near tie, TTFT, ITL and decode
   tokens/s.  10d: Phi-3-mini (microsoft/Phi-3-mini-4k-instruct's published
   widths: vocab 32064, d 3072, FFN 8192, 32 q / 32 kv heads of 96, untied
   head, rope_theta 10000, eps 1e-5; its sliding window left out) cut to 8
   of 32 layers, random weights from seed 0: the first step on the kernel
   path against the plain path as in 10b, then the same README loop, 5
   steps at B 2 x S 2048: the flash kernels launched 2L / L / L = 16 / 8 /
   8 a step, the profiled step naming the d-96 sm90 forward, dQ and dK/dV
   and no kernel of ``flash_attention.cu``, step time, tokens/s, share of
   the bf16 peak and idle share.

The last lines are the kernels' JSON record (the paged kernels' Phase 7
launches as ``launches_phase7``, every kernel's Phase 8, 9 and 10
launches as ``launches_phase8``, ``launches_phase9`` and
``launches_phase10``, the flash kernels' Phase 10d launches as
``launches_phase10d``, the head dims each takes as ``head_dims`` and
Phase 10a's records as ``wide_heads``), the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
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

import numpy as np
import torch

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
              "d 256: 64-key tiles, m64n64k16 Q.K^T and two m64n128k16 P.V halves (192 KB); "
              "d 96: a 64-column 128B-swizzled block beside a 32-column 64B-swizzled one, "
              "P.V as m64n64k16 + m64n32k16 (120 KB); "
              "fp32: the CUDA-core body of flash_attention.cu")
DQ_SOURCE = "accelerate_tpu_torch/ops/csrc/flash_bwd_dq_sm90.cu"  # bf16 and fp16 dQ
DQ_DESIGN = ("bf16/fp16: 128-row CTA of one (batch, q head), 2 consumer warpgroups of 64 rows "
             "+ a producer warp, setmaxnreg 240/24; Q/dO by TMA once, 64-key K/V tiles of the "
             "kv head by TMA into a 3-stage mbarrier ring with kv_valid bytes and an all-valid "
             "flag (lse, delta by plain loads per row); wgmma m64n64k16 S = Q.K^T and "
             "dP = dO.V^T (smem descriptors), dS in registers as A of wgmma m64n{d}k16 "
             "dQ += dS.K (K MN-major); heaviest causal q tiles first; no atomics; d 256: "
             "32-key tiles in a 2-stage ring (192 KB), wgmma m64n32k16 S and dP, two "
             "m64n128k16 dQ halves; d 96: a 64-column 128B-swizzled block beside a 32-column "
             "64B-swizzled one, dQ as m64n64k16 + m64n32k16 (120 KB); fp32: the CUDA-core body "
             "of flash_attention.cu")
DKV_SOURCE = "accelerate_tpu_torch/ops/csrc/flash_bwd_dkv_sm90.cu"  # bf16 and fp16 dK/dV
DKV_DESIGN = ("bf16/fp16: 128-key CTA of one (batch, kv head), 2 consumer warpgroups of 64 keys "
              "+ a producer warp, setmaxnreg 240/24; K/V by TMA once, 64-row Q/dO tiles of the "
              "G query heads by TMA into a 3-stage mbarrier ring (lse, delta by plain loads); "
              "wgmma m64n64k16 S^T = K.Q^T and dP^T = V.dO^T (smem descriptors), P^T and dS^T "
              "in registers as A of wgmma m64n{d}k16 dV += P^T.dO (P as hi + lo) and "
              "dK += dS^T.Q (Q/dO MN-major); no atomics; d 256: 64-key CTAs whose 2 "
              "warpgroups own 128 columns each and recompute S^T/dP^T over the full d, a "
              "2-stage ring (193 KB), the group's query heads split over n_split CTAs "
              "(pick_dkv_split) writing fp32 partials that a second kernel sums in split "
              "order; d 96: a 64-column 128B-swizzled block beside a 32-column 64B-swizzled "
              "one, dV and dK as m64n64k16 + m64n32k16 (121.5 KB); fp32: the CUDA-core body of "
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


PHASE2_PROMPT_LENS = (128, 256, 384, 512, 640, 768, 896, 1024)
PHASE2_GEOMETRY = dict(max_slots=8, block_size=16, num_blocks=8 * 80 + 8, max_blocks_per_seq=128,
                       prefill_chunk=256)


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
    prompt_lens = PHASE2_PROMPT_LENS
    prompts = [list(rng.integers(0, cfg.vocab_size, size=n)) for n in prompt_lens]
    max_new = 32
    geometry = PHASE2_GEOMETRY
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
        out[spec] = dict(dec=dec, win=win, ttft_p50_ms=ttft, itl_p50_ms=itl, itl_mean_ms=itl_mean,
                         decode_tokens_per_s=decode_tps)
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


def phase3_prompts(vocab_size):
    """Six prompts of 43-200 tokens, the first two sharing 40 tokens."""
    import numpy as np

    rng = np.random.default_rng(1)
    shared = list(rng.integers(0, vocab_size, size=40))
    prompts = [shared + list(rng.integers(0, vocab_size, size=n)) for n in (3, 25)]
    return prompts + [list(rng.integers(0, vocab_size, size=n)) for n in (17, 64, 130, 200)]


def phase3():
    import torch

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b(num_layers=4, dtype=torch.float32)
    params = llama.init_params(cfg, seed=1)
    prompts = phase3_prompts(cfg.vocab_size)
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


def kernel_groups(prof):
    """Device ms by kernel from a ``torch.profiler`` run, largest first, as
    ``(ms, launches, name)``; their sum; ms by group (the flash kernels,
    GEMMs, the rest); launches by group; and a line per flash kernel."""
    # Kernels only: a GPU user annotation (the optimizer's step span) also
    # carries device time, which would count its kernels twice.
    by_kernel = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
         and not getattr(e, "is_user_annotation", False)),
        reverse=True,
    )
    groups = {"flash kernels": 0.0, "GEMMs": 0.0, "other": 0.0}
    launches = dict.fromkeys(groups, 0)
    flash = []
    for t, n, key in by_kernel:
        low = key.lower()
        if "flash_" in low and "kernel" in low:
            group = "flash kernels"
            name = re.search(r"flash_\w*kernel", key)
            flash.append(f"{name.group(0) if name else key[:40]} {t:.3f} ms in {n}")
        elif any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma", "cublas", "sm90_")):
            group = "GEMMs"
        else:
            group = "other"
        groups[group] += t
        launches[group] += n
    return by_kernel, sum(t for t, _, _ in by_kernel), groups, launches, flash


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
    by_kernel, busy, groups, _, flash = kernel_groups(prof)
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


# ---------------------------------------------------------------------------
# Phase 7: the serving robustness layer under memory pressure
# ---------------------------------------------------------------------------

PHASE7_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase7")


def tier_clean(engine, what):
    """No device block and no request-owned host block left in use (what
    stays on the host tier belongs to the prefix cache's spilled entries)."""
    cached = engine._prefix.host_count if engine._prefix is not None else 0
    host_used = engine.cache.host.used_blocks if engine.cache.host is not None else 0
    check(engine.cache.allocator.used_blocks == 0,
          f"{what}: {engine.cache.allocator.used_blocks} device blocks leaked")
    check(host_used == cached, f"{what}: {host_used - cached} host blocks leaked")
    return host_used


def phase7a():
    """Token identity under pressure at Llama-3-8B widths cut to 4 layers,
    fp32: seven runs of Phase 3's six prompts over a 40-block pool."""
    import signal

    import torch

    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.resilience import PreemptionGuard
    from accelerate_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = llama.LlamaConfig.llama3_8b(num_layers=4, dtype=torch.float32)
    qcfg = dataclasses.replace(cfg, kv_cache_quant=True)
    params = llama.init_params(cfg, seed=2)
    prompts = phase3_prompts(cfg.vocab_size)
    max_new = 24
    geometry = dict(max_slots=4, block_size=16, num_blocks=21, max_blocks_per_seq=32,
                    prefill_chunk=64, paged_kernel=True)
    need = sum(-(-(len(p) + max_new - 1) // 16) for p in prompts)
    log(f"phase7a Llama-3-8B widths, 4 layers, fp32, seed 2: {len(prompts)} requests of "
        f"{[len(p) for p in prompts]} + {max_new} tokens need {need} blocks, "
        f"{geometry['num_blocks'] - 1} usable")

    def greedy(c, p):
        ids = torch.tensor([p], device="cuda")
        return llama.generate(params, ids, c, max_new_tokens=max_new)[0].tolist()

    want = [greedy(cfg, p) for p in prompts]
    want_q = [greedy(qcfg, p) for p in prompts]

    def engine(c=cfg, **kw):
        return ServingEngine(llama.apply_cached, llama.init_cache, params, c,
                             serving=ServingConfig(**dict(geometry, **kw)))

    def submit_all(eng):
        return [eng.submit(p, max_new, tag=str(i)) for i, p in enumerate(prompts)]

    def identical(done, expect, what):
        """``done``: {tag: CompletedRequest}, every prompt's exactly once."""
        check(sorted(done) == [str(i) for i in range(len(prompts))],
              f"{what}: completed {sorted(done)}")
        for tag, c in done.items():
            check(c.status == "ok" and c.tokens == expect[int(tag)],
                  f"{what}: request {tag} ({c.status}) differs from greedy generate")

    total = [0, 0]

    def run(what, expect=want, c=cfg, **kw):
        eng = engine(c, **kw)
        submit_all(eng)
        reset_counts()
        eng.run(max_ticks=5000)
        counts = read_counts()
        total[0] += counts[0]
        total[1] += counts[1]
        done = {r.tag: r for r in eng.pop_finished()}
        identical(done, expect, what)
        st = eng.stats()
        check(st["preempted"] > 0, f"{what}: nothing was preempted")
        host = tier_clean(eng, what)
        tier = st["tiering"] or {}
        log(f"phase7a {what}: {len(done)} requests token-identical to greedy generate; "
            f"preempted={st['preempted']} migrations={sum(r.migrations for r in done.values())} "
            f"promotions={tier.get('promotions')} fallback_reprefills="
            f"{tier.get('fallback_reprefills')} prefill_dispatches={st['prefill_dispatches']} "
            f"decode_dispatches={st['decode_dispatches']} decode_launches={counts[0]} "
            f"window_launches={counts[1]} cached_prefix_host_blocks={host}")
        return eng, done, st, counts

    # 1. The tier on; prefix sharing off, so a request's prefill dispatches
    #    are its prompt's chunks exactly unless it re-prefilled.
    eng, done, st, (dec, win) = run("host_blocks=32", host_blocks=32, prefix_cache=False)
    migrated = [r for r in done.values() if r.migrations and not r.fallback_reprefills]
    check(migrated and st["tiering"]["promotions"] > 0, f"no promoted resume: {st['tiering']}")
    for r in migrated:
        chunks = -(-r.prompt_len // geometry["prefill_chunk"])
        check(r.prefill_dispatches == chunks, f"request {r.tag} spent {r.prefill_dispatches} "
              f"prefill dispatches on a promoted resume, its prompt needs {chunks}")
    check(dec == cfg.num_layers * st["decode_dispatches"] and win == 0,
          f"decode kernel launched {dec} times over {st['decode_dispatches']} dispatches")
    # 2. No tier: every preemption frees and re-prefills (prefix sharing off
    #    again, or the victim's own cached prompt blocks hide the re-prefill).
    chunks = sum(-(-len(p) // geometry["prefill_chunk"]) for p in prompts)
    eng, done, st, _ = run("host_blocks=0", host_blocks=0, prefix_cache=False)
    check(st["tiering"] is None and st["prefill_dispatches"] > chunks,
          f"no re-prefill: {st['prefill_dispatches']} prefill dispatches for {chunks} chunks")
    # 3. int8 KV: the plain path, no paged launch.
    eng, done, st, (dec, win) = run("kv_cache_quant", want_q, qcfg, host_blocks=32)
    check(dec == 0 and win == 0, f"int8 pool launched paged kernels: {dec}, {win}")
    # 4. The dense gather-view path.
    eng, done, st, (dec, win) = run("decode_path=dense", host_blocks=32, decode_path="dense")
    check(st["decode_path"] == "dense" and dec == 0 and win == 0, "dense path launched kernels")
    # 5. Speculation with the tier on.
    eng, done, st, (dec, win) = run("spec_tokens=3", host_blocks=32, spec_tokens=3)
    check(win > 0 and dec == 0, f"window kernel launched {win} times, decode kernel {dec}")
    check(st["tiering"]["promotions"] > 0, f"spec run promoted nothing: {st['tiering']}")
    del eng

    # 6. Journal recovery: an engine abandoned undrained after 30 ticks.
    os.makedirs(PHASE7_DIR, exist_ok=True)
    jp = os.path.join(PHASE7_DIR, "journal.json")
    first = engine(host_blocks=32, journal_path=jp)
    submit_all(first)
    for _ in range(30):
        first.step()
    done = {r.tag: r for r in first.pop_finished()}
    left = len(prompts) - len(done)
    del first
    succ = engine(host_blocks=32, journal_path=os.path.join(PHASE7_DIR, "successor.json"))
    mapping = succ.recover_from_journal(jp)
    check(len(mapping) == left and left > 0, f"recovered {len(mapping)} of {left} pending")
    reset_counts()
    succ.run(max_ticks=5000)
    total[0] += read_counts()[0]
    done.update({r.tag: r for r in succ.pop_finished()})
    identical(done, want, "journal recovery")
    tier_clean(succ, "journal recovery")
    log(f"phase7a journal recovery: {len(done) - left} finished before the abandonment, "
        f"{left} recovered from the journal and finished token-identically; successor "
        f"journal flushes={succ.stats()['journal_flushes']}")
    del succ

    # 7. Drain on a signal the process sends itself; the requeue journal
    #    finishes on a successor.
    guard = PreemptionGuard(signals=(signal.SIGUSR1,)).install()
    try:
        eng = engine(host_blocks=32)
        eng.install_preemption_guard(guard)
        submit_all(eng)
        reset_counts()
        for _ in range(12):
            eng.step()
        os.kill(os.getpid(), signal.SIGUSR1)
        check(eng.step() == [] and eng.drained, "the signal did not drain the engine")
    finally:
        guard.uninstall()
    total[0] += read_counts()[0]
    requeue = eng.requeue_journal
    done = {r.tag: r for r in eng.pop_finished()}
    tier_clean(eng, "drain")
    check(requeue and eng.sched.active == 0, f"drain left {eng.sched.active} slots")
    succ = engine(host_blocks=32)
    for rec in requeue:
        succ.submit(rec["prompt"] + rec["emitted"], rec["remaining"], tag=rec["tag"])
    reset_counts()
    succ.run(max_ticks=5000)
    total[0] += read_counts()[0]
    # The successor's prompts carry the drained requests' emitted tokens.
    done.update({r.tag: r for r in succ.pop_finished()})
    identical(done, want, "drain")
    tier_clean(succ, "drain successor")
    log(f"phase7a drain on SIGUSR1: {len(requeue)} requests requeued with "
        f"{sum(len(r['emitted']) for r in requeue)} emitted tokens carried, finished "
        "token-identically on a successor")
    del eng, succ, params
    shutil.rmtree(PHASE7_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return total


def phase7b(smi, unpressured):
    """Llama-3-8B (32 layers, bf16, Phase 2's weights) under pressure: eight
    long requests over a 328-block pool with a 256-block host tier."""
    import hashlib

    import numpy as np
    import torch

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0)
    rng = np.random.default_rng(7)
    lens = [512 + 73 * i for i in range(8)]
    prompts = [list(rng.integers(0, cfg.vocab_size, size=n)) for n in lens]
    max_new = 64
    geometry = dict(max_slots=8, block_size=16, num_blocks=328, host_blocks=256,
                    max_blocks_per_seq=128, prefill_chunk=256, paged_kernel=True)
    os.makedirs(PHASE7_DIR, exist_ok=True)
    acc = Accelerator()
    engine = acc.prepare_serving(llama.apply_cached, llama.init_cache, params, cfg,
                                 journal_path=os.path.join(PHASE7_DIR, "journal.json"), **geometry)
    kv = engine.cache
    block_bytes = kv.block_bytes()
    need = sum(-(-(n + max_new - 1) // 16) for n in lens)
    log(f"phase7b Llama-3-8B bf16, 32 layers: block {block_bytes} B, pool "
        f"{kv.pool_bytes()} B, pinned host tier {kv.host.pool_bytes()} B; {len(lens)} requests "
        f"of {lens[0]}-{lens[-1]} + {max_new} tokens need {need} blocks, "
        f"{geometry['num_blocks'] - 1} usable")
    engine.submit(list(rng.integers(0, cfg.vocab_size, size=40)), 4)  # warm-up
    engine.run()
    engine.pop_finished()

    # Time every migration, and hold request victims' bytes (SHA-256 of the
    # device blocks) across demote -> promote until one round trip is
    # confirmed; the hashing runs outside the timed copies and the decode
    # forwards, but inside the ticks the ITL samples span.
    moves = {"demote": [], "promote": []}
    pending, round_trips = {}, []
    demote, promote = kv.demote, kv.promote

    def digest(blocks):
        h = hashlib.sha256()
        for name in sorted(kv.pool):
            h.update(kv.pool[name][:, blocks].contiguous().view(torch.uint8).cpu().numpy())
        return h.hexdigest()

    def timed_demote(blocks):
        watch = len(blocks) > 1 and not round_trips and len(pending) < 3
        before = digest(blocks) if watch else None
        t0 = time.perf_counter()
        ids = demote(blocks)
        moves["demote"].append((time.perf_counter() - t0, len(blocks)))
        if watch:
            pending[tuple(ids)] = before
        return ids

    def timed_promote(host_ids, dst):
        t0 = time.perf_counter()
        promote(host_ids, dst)
        moves["promote"].append((time.perf_counter() - t0, len(dst)))
        if tuple(host_ids) in pending:
            round_trips.append((pending.pop(tuple(host_ids)), digest(dst), len(dst)))

    kv.demote, kv.promote = timed_demote, timed_promote
    base_dispatches = engine.decode_dispatches
    base_s, base_tok = engine.decode_seconds, engine.decode_emitted_tokens
    base_flushes = engine.journal.flushes, engine.journal.flush_seconds
    base_prefill = engine.prefill_seconds, engine.prefill_dispatches
    reset_counts()
    done, wall, ids = serve(engine, prompts, max_new, stagger_ticks=2)
    dec, win = read_counts()
    kv.demote, kv.promote = demote, promote
    dispatches = engine.decode_dispatches - base_dispatches
    st = engine.stats()
    check(len(done) == len(prompts), f"{len(done)} of {len(prompts)} completed")
    for rid, n in zip(ids, lens):
        c = done[rid]
        check(c.status == "ok" and c.new_tokens == max_new and len(c.tokens) == n + max_new,
              f"request {rid} status {c.status} with {c.new_tokens} tokens")
    migrations = sum(c.migrations for c in done.values())
    check(migrations > 0, f"no migration under pressure: {st['tiering']}")
    check(dec == cfg.num_layers * dispatches and win == 0,
          f"decode kernel launched {dec} times over {dispatches} dispatches; window {win}")
    check(round_trips and all(a == b for a, b, _ in round_trips),
          f"a victim's blocks changed across demote -> promote: {round_trips}")
    tier_clean(engine, "phase7b")

    def rate(kind, many):
        """Calls of ``kind`` moving more than one block (request migrations)
        or exactly one (prefix-cache spills and their promotions)."""
        calls = [(t, n * block_bytes) for t, n in moves[kind] if (n > 1) == many]
        if not calls:
            return "none"
        per = [b / t / 1e9 for t, b in calls]
        return (f"{len(calls)} calls, {sum(b for _, b in calls)} B in "
                f"{sum(t for t, _ in calls) * 1e3:.3f} ms (median "
                f"{median([t for t, _ in calls]) * 1e3:.3f} ms for "
                f"{int(median([b for _, b in calls]))} B, {median(per):.2f} GB/s; "
                f"{min(per):.2f}-{max(per):.2f} GB/s)")

    for kind in ("demote", "promote"):
        log(f"phase7b {kind}s of requests: {rate(kind, True)}; of single prefix blocks: "
            f"{rate(kind, False)}")
    # Yardstick: one pinned copy_ each way of the largest migration's bytes.
    largest = max(n for _, n in moves["demote"]) * block_bytes
    dev = torch.empty(largest, dtype=torch.uint8, device="cuda")
    host = torch.empty(largest, dtype=torch.uint8, pin_memory=True)
    times = {"d2h": [], "h2d": []}
    for _ in range(5):
        for way, (dst, src) in (("d2h", (host, dev)), ("h2d", (dev, host))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize()
            times[way].append(time.perf_counter() - t0)
    log(f"phase7b pinned copy_ of {largest} B: d2h {median(times['d2h']) * 1e3:.3f} ms "
        f"({largest / median(times['d2h']) / 1e9:.2f} GB/s), h2d "
        f"{median(times['h2d']) * 1e3:.3f} ms ({largest / median(times['h2d']) / 1e9:.2f} GB/s)")
    del dev, host
    ttft = median([c.ttft_ms for c in done.values()])
    gaps = [x for c in done.values() for x in c.inter_token_ms]
    itl, itl_mean = median(gaps), sum(gaps) / len(gaps)
    decode_tps = (engine.decode_emitted_tokens - base_tok) / (engine.decode_seconds - base_s)
    prefill_ms = ((engine.prefill_seconds - base_prefill[0])
                  / (engine.prefill_dispatches - base_prefill[1]) * 1e3)
    flushes = engine.journal.flushes - base_flushes[0]
    flush_s = engine.journal.flush_seconds - base_flushes[1]
    tier = st["tiering"]
    log(f"phase7b under pressure: {len(done)} requests ok, wall_s={wall:.3f} "
        f"decode_dispatches={dispatches} prefill_dispatches="
        f"{engine.prefill_dispatches - base_prefill[1]} decode_launches={dec} "
        f"preempted={st['preempted']} migrations={migrations} "
        f"demotions={tier['demotions']} promotions={tier['promotions']} demoted_blocks="
        f"{tier['demoted_blocks']} fallback_reprefills={tier['fallback_reprefills']} "
        f"round trip of {round_trips[0][2]} blocks bit-identical by SHA-256; ttft_p50_ms={ttft:.1f} itl_p50_ms={itl:.2f} "
        f"itl_mean_ms={itl_mean:.2f} decode_tokens_per_s={decode_tps:.1f} "
        f"prefill_ms_per_chunk={prefill_ms:.2f}")
    log(f"phase7b beside Phase 2 unpressured (8 requests of 128-1024 + 32 tokens): "
        f"ttft_p50_ms={unpressured['ttft_p50_ms']:.1f} itl_p50_ms={unpressured['itl_p50_ms']:.2f} "
        f"itl_mean_ms={unpressured['itl_mean_ms']:.2f} "
        f"decode_tokens_per_s={unpressured['decode_tokens_per_s']:.1f}")
    log(f"phase7b journal (fsync on): {flushes} flushes in {flush_s * 1e3:.3f} ms, "
        f"{flush_s / max(flushes, 1) * 1e3:.3f} ms per mutation; {smi}")
    del engine, params
    shutil.rmtree(PHASE7_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return dec


def phase7(smi, unpressured):
    a = phase7a()
    dec_b = phase7b(smi, unpressured)
    return {"paged_attention": a[0] + dec_b, "paged_window_attention": a[1]}


# ---------------------------------------------------------------------------
# Phase 8: offline generation, the draft-model drafter and serving traces
# ---------------------------------------------------------------------------

PHASE8_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase8")
# bf16 logits of the 32-layer model differ by up to ~0.15 between two paths
# through the same weights (Phase 2's fixed-pool step: the kernel against its
# own plain version).  Where two bf16 paths pick different greedy tokens, or
# a sampled token sits just outside a filter recomputed on another path, the
# two candidates must lie within this margin of each other in the logits.
NEAR_TIE = 0.25


def llama32_1b_config():
    """Llama-3.2-1B's published widths (random weights, built in code)."""
    import torch

    from accelerate_tpu_torch.models import llama

    return llama.LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_layers=16,
        num_heads=32, num_kv_heads=8, head_dim=64, tie_embeddings=True, rope_theta=500000.0,
        rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192), dtype=torch.bfloat16,
        param_dtype=torch.bfloat16)


def timed(fn):
    """(result, host seconds) of ``fn()`` ending in a device synchronisation."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def divergence(params, cfg, ref, other, start):
    """None when ``other`` equals ``ref``; else (i, gap): the first position
    past ``start`` where they differ and, from a forward over ``ref[:i]``,
    the logit of ``ref[i]`` minus that of ``other[i]``."""
    import torch

    from accelerate_tpu_torch.models import llama

    ref, other = list(ref), list(other)
    if ref == other:
        return None
    i = next(j for j in range(start, len(ref)) if ref[j] != other[j])
    with torch.no_grad():
        logits = llama.apply(params, torch.tensor([ref[:i]], device="cuda"), cfg)[0, -1]
    return i, float(logits[ref[i]] - logits[other[i]])


def check_greedy(params, cfg, what, ref, other, start):
    """Token identity with greedy decoding, or a first divergence at a near
    tie (both tokens within NEAR_TIE in the logits); returns a label."""
    d = divergence(params, cfg, ref, other, start)
    if d is None:
        return "identical"
    i, gap = d
    check(abs(gap) <= NEAR_TIE,
          f"{what}: differs from greedy at token {i - start} with a logit gap of {gap:.4f}")
    return f"near-tie divergence at token {i - start} (gap {gap:.4f})"


def phase8a(params, cfg, draft, dcfg):
    """Llama-3-8B (32 layers, bf16, Phase 2's weights): sampled generate,
    beam search, greedy speculative decoding with a Llama-3.2-1B-width draft
    and with the target as its own draft, and sampled speculative decoding."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.utils.random import PRNGKey

    rng = np.random.default_rng(8)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(4, 960))).cuda()
    samp = dict(temperature=0.8, top_k=50, top_p=0.9)
    a, a_s = timed(lambda: llama.generate(params, ids, cfg, 64, key=PRNGKey(80), **samp))
    b = llama.generate(params, ids, cfg, 64, key=PRNGKey(80), **samp)
    c = llama.generate(params, ids, cfg, 64, key=PRNGKey(81), **samp)
    check(torch.equal(a, b), "sampled generate: the same key gave different tokens")
    check(not torch.equal(a, c), "sampled generate: two keys gave the same tokens")
    check(torch.equal(a[:, :960], ids), "sampled generate: the prompt changed")
    # The noise is drawn on the host: time one step's draw and copy alone.
    key = PRNGKey(80)
    _, draw_s = timed(lambda: [key.fold_in(i).gumbel((4, cfg.vocab_size), "cuda")
                               for i in range(64)])
    reset_flash_counts()
    with torch.no_grad():
        logits = llama.apply(params, a, cfg)
    torch.cuda.synchronize()
    fwd_launches = read_flash_counts()["fused_attention_fwd"]
    check(fwd_launches == cfg.num_layers,
          f"apply over 4 x 1024 launched the fused forward {fwd_launches} times")
    lg = logits[:, 959:1023].float() / samp["temperature"]
    del logits
    tok = a[:, 960:1024].long()
    val = torch.gather(lg, -1, tok[..., None])[..., 0]
    top = torch.topk(lg, samp["top_k"], dim=-1).values  # [4, 64, 50], descending
    probs = torch.softmax(top, -1)
    cut = (torch.cumsum(probs, -1) - probs) >= samp["top_p"]
    cutoff = torch.where(cut, float("inf"), top).amin(-1)
    slack = torch.minimum(val - top[..., -1], val - cutoff) * samp["temperature"]
    inside = float((slack >= 0).float().mean())
    check(float(slack.min()) >= -NEAR_TIE,
          f"a sampled token lies {float(-slack.min()):.4f} outside top-50 / top-p 0.9")
    del lg, top, probs
    log(f"phase8a sampled generate (4 x 960 + 64, T 0.8, top-k 50, top-p 0.9): wall_s={a_s:.3f} "
        f"({a_s / 64 * 1e3:.2f} ms per step); same key identical, second key differs; noise "
        f"draws on the host {draw_s / 64 * 1e3:.3f} ms per step (4 x {cfg.vocab_size} fp32, "
        f"copy included); apply over the outputs: fused_attention_fwd launches={fwd_launches}; "
        f"tokens strictly inside both filters {inside:.4f}, min slack "
        f"{float(slack.min()):.4f} (margin {NEAR_TIE})")

    ids2 = ids[:2, :512]
    greedy2, g_s = timed(lambda: llama.generate(params, ids2, cfg, 32))
    beam1 = llama.generate_beam(params, ids2, cfg, 32, num_beams=1)
    check(torch.equal(beam1, greedy2), "generate_beam(num_beams=1) differs from greedy generate")
    beam4, b_s = timed(lambda: llama.generate_beam(params, ids2, cfg, 32, num_beams=4))
    check(beam4.shape == (2, 544), f"beam output shape {tuple(beam4.shape)}")
    log(f"phase8a beam search (2 x 512 + 32): num_beams=1 equals greedy generate; num_beams=4 "
        f"wall_s={b_s:.3f} against greedy's {g_s:.3f}")

    ids1 = ids[:1, :512]
    greedy, gs = timed(lambda: llama.generate(params, ids1, cfg, 64))
    ref = greedy[0].tolist()
    out = {}
    for name, (dp, dc) in (("Llama-3.2-1B-width draft", (draft, dcfg)),
                           ("self-draft", (params, cfg))):
        (o, st), s_ = timed(lambda: llama.speculative_generate(
            params, dp, ids1, cfg, dc, 64, num_draft_tokens=4, return_stats=True))
        label = check_greedy(params, cfg, f"speculative ({name})", ref, o[0].tolist(), 512)
        out[name] = dict(st, wall_s=s_, result=label)
        log(f"phase8a greedy speculative_generate (1 x 512 + 64, gamma 4, {name}): {label}; "
            f"rounds={st['rounds']} proposed={st['proposed']} accepted={st['accepted']} "
            f"wall_s={s_:.3f} against greedy generate's {gs:.3f}")
    (o, st), s_ = timed(lambda: llama.speculative_generate(
        params, params, ids1, cfg, cfg, 64, num_draft_tokens=4, return_stats=True,
        temperature=0.8, key=PRNGKey(83)))
    rate = st["accepted"] / max(st["proposed"], 1)
    check(o.shape == (1, 576) and bool((o >= 0).all() and (o < cfg.vocab_size).all()),
          "sampled speculative output out of range")
    check(rate > 0.5, f"sampled self-draft acceptance {rate:.4f}")
    log(f"phase8a sampled speculative_generate (self-draft, T 0.8): rounds={st['rounds']} "
        f"proposed={st['proposed']} accepted={st['accepted']} acceptance={rate:.4f} "
        f"wall_s={s_:.3f}")
    return fwd_launches


def phase8b():
    """fp32 at Phase 7a's widths (Llama-3-8B cut to 4 layers, seed 2) on the
    card and on the CPU: beam search with EOS and greedy speculative decoding
    (a 1-layer draft, seed 4) give the same tokens."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b(num_layers=4, dtype=torch.float32)
    # A narrow 1-layer draft over the same vocab keeps the CPU side short.
    dcfg = llama.LlamaConfig(vocab_size=cfg.vocab_size, hidden_size=256, intermediate_size=512,
                             num_layers=1, num_heads=4, num_kv_heads=2, dtype=torch.float32)
    params, draft = llama.init_params(cfg, seed=2), llama.init_params(dcfg, seed=4)

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}

    cparams, cdraft = to_cpu(params), to_cpu(draft)
    ids = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, size=(1, 32)))
    cache = llama.init_cache(cfg, 1, 32, device="cuda")
    first, _ = llama.apply_cached(params, ids.cuda(), cfg, cache)
    eos = int(torch.argsort(first[0, -1], descending=True)[1])  # a beam freezes at once
    beam = dict(num_beams=4, eos_token_id=eos)
    bg, bg_s = timed(lambda: llama.generate_beam(params, ids.cuda(), cfg, 12, **beam))
    t0 = time.perf_counter()
    bc = llama.generate_beam(cparams, ids, cfg, 12, **beam)
    bc_s = time.perf_counter() - t0
    check(torch.equal(bg.cpu(), bc), "fp32 beam search differs between the card and the CPU")
    (sg, stg), sg_s = timed(lambda: llama.speculative_generate(
        params, draft, ids.cuda(), cfg, dcfg, 12, num_draft_tokens=4, return_stats=True))
    t0 = time.perf_counter()
    sc, stc = llama.speculative_generate(cparams, cdraft, ids, cfg, dcfg, 12,
                                         num_draft_tokens=4, return_stats=True)
    sc_s = time.perf_counter() - t0
    check(torch.equal(sg.cpu(), sc) and stg == stc,
          f"fp32 speculative decoding differs between the card and the CPU: {stg} vs {stc}")
    log(f"phase8b fp32 4 layers, card == CPU: generate_beam (4 beams, EOS {eos}, 32 + 12) "
        f"card {bg_s:.3f} s, CPU {bc_s:.3f} s; speculative_generate (1-layer draft, gamma 4, "
        f"32 + 12) {stg} card {sg_s:.3f} s, CPU {sc_s:.3f} s")
    del params, draft, cparams, cdraft
    torch.cuda.empty_cache()


def trace_timer(tracer):
    """Wrap the tracer's hooks on this instance to sum their host time."""
    spent = [0.0, 0]

    def wrap(fn):
        def timed_hook(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[0] += time.perf_counter() - t0
                spent[1] += 1
        return timed_hook

    for name in ("on_submit", "on_admit", "on_preempt", "begin_tick", "on_prefill", "on_decode",
                 "end_tick", "on_terminal", "flush"):
        setattr(tracer, name, wrap(getattr(tracer, name)))
    return spent


def phase8c(params, cfg, draft, dcfg, smi):
    """Serving with the draft-model drafter and tracing on (Phase 2's
    geometry and traffic, spec_tokens=3), the target as its own draft, the
    traces, and Phase 2's traffic with tracing off beside the default."""
    import numpy as np
    import torch

    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops import fused_attention as fu
    from accelerate_tpu_torch.serving import (
        DraftModelDrafter,
        ServingConfig,
        ServingEngine,
        load_serving_traces,
    )

    shutil.rmtree(PHASE8_DIR, ignore_errors=True)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=n)) for n in PHASE2_PROMPT_LENS]
    warm = list(rng.integers(0, cfg.vocab_size, size=40))
    max_new = 32

    def engine(drafter=None, **kw):
        eng = ServingEngine(llama.apply_cached, llama.init_cache, params, cfg, device="cuda",
                            drafter=drafter, serving=ServingConfig(
                                paged_kernel=True, **dict(PHASE2_GEOMETRY, **kw)))
        eng.submit(warm, 4)
        eng.run()
        eng.pop_finished()
        return eng

    eng = engine(DraftModelDrafter(llama.apply, draft, dcfg), spec_tokens=3,
                 trace_dir=os.path.join(PHASE8_DIR, "drafter"))
    check(eng.tracer is not None, "tracing is not on by default")
    spent = trace_timer(eng.tracer)
    base = eng.decode_dispatches
    base_s, base_tok = eng.decode_seconds, eng.decode_emitted_tokens
    # Which kernel symbols the drafter's fused forward launches (dtype, head dim).
    symbols, launch = set(), fu._launch

    def recording_launch(symbol, q, *args, **kw):
        symbols.add(f"{symbol} ({str(q.dtype)[6:]}, head dim {q.shape[-1]})")
        return launch(symbol, q, *args, **kw)

    reset_counts()
    reset_flash_counts()
    ids, done, snapshot = [], {}, None
    fu._launch = recording_launch
    t0 = time.perf_counter()
    tick = 0
    try:
        while len(ids) < len(prompts) or not eng.sched.idle():
            while len(ids) < len(prompts) and tick >= 3 * len(ids):
                ids.append(eng.submit(prompts[len(ids)], max_new))
            for c in eng.step():
                done[c.id] = c
            if snapshot is None and eng.sched.active:
                snapshot = eng.debug_requests()
            tick += 1
        torch.cuda.synchronize()
    finally:
        fu._launch = launch
    wall = time.perf_counter() - t0
    dec, win = read_counts()
    drafter_fwd = read_flash_counts()["fused_attention_fwd"]
    dispatches = eng.decode_dispatches - base
    st = eng.stats()
    check(len(done) == len(prompts) and all(c.status == "ok" for c in done.values()),
          "draft-model serving: a request did not complete ok")
    check(win == cfg.num_layers * dispatches and dec == 0,
          f"window kernel launched {win} times over {dispatches} verify dispatches; decode {dec}")
    check(drafter_fwd > 0, "the drafter never ran the fused forward kernel")
    check(snapshot and all("current_phase" in r["trace"] for r in snapshot),
          f"debug_requests() mid-run: {snapshot}")
    labels = []
    for rid, p in zip(ids, prompts):
        want = llama.generate(params, torch.tensor([p], device="cuda"), cfg, max_new)[0]
        labels.append(check_greedy(params, cfg, f"draft-model serving request {rid}",
                                   want.tolist(), done[rid].tokens, len(p)))
    gaps = [x for rid in ids for x in done[rid].inter_token_ms]
    itl, itl_mean = median(gaps), sum(gaps) / len(gaps)
    decode_tps = (eng.decode_emitted_tokens - base_tok) / (eng.decode_seconds - base_s)
    traces = {t.rid: t for t in eng.tracer.completed}
    verify = 0
    for rid in ids:
        t = traces[rid]
        check(t.finish is not None and t.unattributed_ms() >= 0.0,
              f"request {rid}: trace not closed")
        check(all(cur.start >= prev.end for prev, cur in zip(t.intervals, t.intervals[1:]))
              and t.intervals[0].start >= t.arrival and t.intervals[-1].end <= t.finish,
              f"request {rid}: intervals overlap or leave the submit->terminal window")
        verify += sum(iv.phase == "verify" for iv in t.intervals)
    check(verify > 0, "no verify interval recorded")
    chrome = eng.export_chrome_trace(os.path.join(PHASE8_DIR, "drafter.trace.json"))
    with open(chrome) as f:
        events = json.load(f)["traceEvents"]
    check(sum(e["ph"] == "X" for e in events) > 0, "the Chrome export holds no interval")
    records = load_serving_traces(os.path.join(PHASE8_DIR, "drafter"))
    check(sum(r["status"] == "ok" for r in records) >= len(prompts), "trace JSONL incomplete")
    exact = sum(label == "identical" for label in labels)
    log(f"phase8c draft-model drafter (Llama-3.2-1B widths, seed 3), spec_tokens=3, tracing on: "
        f"{len(done)} requests ok, {exact} token-identical to greedy generate, "
        f"{len(labels) - exact} near-tie divergences {[x for x in labels if x != 'identical']}; "
        f"verify dispatches={dispatches} window_launches={win} decode_launches={dec} "
        f"drafter fused_attention_fwd launches={drafter_fwd} by {sorted(symbols)}; acceptance="
        f"{st['spec']['acceptance_rate']} (proposed {st['spec']['proposed']}, accepted "
        f"{st['spec']['accepted']}); wall_s={wall:.3f} itl_p50_ms={itl:.2f} "
        f"itl_mean_ms={itl_mean:.2f} decode_tokens_per_s={decode_tps:.1f}")
    log(f"phase8c traces: {len(records)} JSONL records, {len(events)} Chrome events, "
        f"{verify} verify intervals; blame {st['trace_blame']}; tracer hooks "
        f"{spent[0] * 1e3:.3f} ms in {spent[1]} calls over {eng.ticks} ticks "
        f"({spent[0] / max(eng.ticks, 1) * 1e6:.1f} us per tick)")
    del eng
    torch.cuda.empty_cache()

    # The target as its own draft: every draft is the target's own greedy
    # token by a full forward, so a draft is rejected only where that
    # forward and the verify window part at a near tie.
    drafter = DraftModelDrafter(llama.apply, params, cfg)
    proposals = []
    propose = drafter.propose

    def recording_propose(feed, k):
        d = propose(feed, k)
        proposals.append((list(feed), d))
        return d

    drafter.propose = recording_propose
    eng = engine(drafter, spec_tokens=3)
    proposals.clear()
    base = eng.stats()["spec"]
    reset_counts()
    pair = prompts[:2]
    rids = [eng.submit(p, 16) for p in pair]
    outs = eng.run()
    self_win = read_counts()[1]
    st = {k: eng.stats()["spec"][k] - base[k] for k in ("proposed", "accepted")}
    labels = []
    for rid, p in zip(rids, pair):
        want = llama.generate(params, torch.tensor([p], device="cuda"), cfg, 16)[0].tolist()
        labels.append(check_greedy(params, cfg, f"self-draft request {rid}", want, outs[rid],
                                   len(p)))
    # A draft is accepted iff it equals the token the engine emitted there.
    rejected, accepted = [], 0
    for feed, d in proposals:
        out = next(o for o in outs.values() if o[:len(feed)] == feed)
        miss = [j for j, t in enumerate(d) if t != out[len(feed) + j]]
        accepted += miss[0] if miss else len(d)
        if miss:
            at = len(feed) + miss[0]
            rejected.append(divergence(params, cfg, out[:at + 1], out[:at] + [d[miss[0]]],
                                       at)[1])
    check(st["proposed"] > 0 and accepted == st["accepted"],
          f"self-draft: {accepted} drafts match the output, the engine accepted {st['accepted']}")
    check(all(abs(g) <= NEAR_TIE for g in rejected),
          f"self-draft rejected drafts away from a near tie: logit gaps {rejected}")
    log(f"phase8c self-draft serving (2 requests + 16): {labels}; proposed={st['proposed']} "
        f"accepted={st['accepted']} rejected at near ties (logit gaps): {rejected}; "
        f"window_launches={self_win}")
    del eng
    torch.cuda.empty_cache()

    # Phase 2's traffic (no speculation) with tracing off and by default
    # (on), in turns.
    runs = {None: [], False: []}
    dec_launches = 0
    for trace in (False, None, None, False):
        eng = engine(trace=trace)
        base_s, base_tok = eng.decode_seconds, eng.decode_emitted_tokens
        reset_counts()
        done, wall, ids = serve(eng, prompts, max_new, stagger_ticks=3)
        dec_launches += read_counts()[0]
        gaps = [x for c in done.values() for x in c.inter_token_ms]
        runs[trace].append(dict(
            wall_s=wall, itl_p50_ms=median(gaps), itl_mean_ms=sum(gaps) / len(gaps),
            decode_tokens_per_s=(eng.decode_emitted_tokens - base_tok)
            / (eng.decode_seconds - base_s)))
        del eng
    for trace in (False, None):
        r = runs[trace]
        log(f"phase8c Phase 2 traffic, trace={trace}: " + "; ".join(
            f"wall_s={x['wall_s']:.3f} itl_p50_ms={x['itl_p50_ms']:.2f} "
            f"itl_mean_ms={x['itl_mean_ms']:.2f} decode_tokens_per_s="
            f"{x['decode_tokens_per_s']:.1f}" for x in r) + f"; {smi}")
    shutil.rmtree(PHASE8_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return dec_launches, win + self_win, drafter_fwd


def phase8(smi):
    import torch

    from accelerate_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0)
    dcfg = llama32_1b_config()
    draft = llama.init_params(dcfg, seed=3)
    log(f"phase8 Llama-3-8B bf16 ({cfg.num_params()} parameters, seed 0) and a Llama-3.2-1B-"
        f"width draft ({dcfg.num_params()} parameters, seed 3)")
    t0 = time.perf_counter()
    fwd_a = phase8a(params, cfg, draft, dcfg)
    t1 = time.perf_counter()
    phase8b()
    t2 = time.perf_counter()
    dec, win, fwd_c = phase8c(params, cfg, draft, dcfg, smi)
    t3 = time.perf_counter()
    log(f"phase8 seconds: 8a {t1 - t0:.1f}, 8b {t2 - t1:.1f}, 8c {t3 - t2:.1f}")
    del params, draft
    torch.cuda.empty_cache()
    return {"paged_attention": dec, "paged_window_attention": win,
            "fused_attention_fwd": fwd_a + fwd_c, "fused_attention_bwd_dq": 0,
            "fused_attention_bwd_dkv": 0}


# ---------------------------------------------------------------------------
# Phase 9: the single-process Accelerator surface and mixed precision
# ---------------------------------------------------------------------------

# The twin of examples/nlp_example.py (which imports the JAX package): the
# same model, data, loop and metric, against accelerate_tpu_torch.
VOCAB = 512
SEQ = 32
EVAL_BATCH_SIZE = 32


class PairClassifier(torch.nn.Module):
    """Mean-pooled embedding encoder over both sentences + MLP head."""

    def __init__(self, vocab=VOCAB, dim=64):
        super().__init__()
        self.embed = torch.nn.Embedding(vocab, dim)
        self.head = torch.nn.Sequential(
            torch.nn.Linear(4 * dim, 128), torch.nn.GELU(), torch.nn.Linear(128, 2)
        )

    def forward(self, input_ids_a, input_ids_b):
        a = self.embed(input_ids_a).mean(dim=1)
        b = self.embed(input_ids_b).mean(dim=1)
        feats = torch.cat([a, b, torch.abs(a - b), a * b], dim=1)
        return self.head(feats)


def make_dataset(n: int, seed: int):
    """Synthetic paraphrase pairs: positives are shuffled copies (+ noise),
    negatives are independent draws."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, VOCAB, (n, SEQ))
    labels = rng.integers(0, 2, n)
    b = np.where(
        labels[:, None] == 1,
        rng.permuted(a, axis=1),
        rng.integers(1, VOCAB, (n, SEQ)),
    )
    return [
        {
            "input_ids_a": torch.tensor(a[i]),
            "input_ids_b": torch.tensor(b[i]),
            "labels": int(labels[i]),
        }
        for i in range(n)
    ]


def collate(samples):
    return {
        "input_ids_a": torch.stack([s["input_ids_a"] for s in samples]),
        "input_ids_b": torch.stack([s["input_ids_b"] for s in samples]),
        "labels": torch.tensor([s["labels"] for s in samples]),
    }


def get_dataloaders(accelerator, batch_size: int = 16):
    from torch.utils.data import DataLoader

    train = make_dataset(512, seed=0)
    val = make_dataset(128, seed=1)
    return (
        DataLoader(train, shuffle=True, collate_fn=collate, batch_size=batch_size),
        DataLoader(val, shuffle=False, collate_fn=collate, batch_size=EVAL_BATCH_SIZE),
    )


def training_function(config, args):
    from torch.optim.lr_scheduler import LambdaLR

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.utils import set_seed

    accelerator = Accelerator(cpu=args.cpu, mixed_precision=args.mixed_precision)
    lr = config["lr"]
    num_epochs = int(config["num_epochs"])
    seed = int(config["seed"])
    batch_size = int(config["batch_size"])

    set_seed(seed)
    train_dataloader, eval_dataloader = get_dataloaders(accelerator, batch_size)
    model = PairClassifier()
    optimizer = torch.optim.AdamW(params=model.parameters(), lr=lr)
    total_steps = num_epochs * len(train_dataloader)
    lr_scheduler = LambdaLR(optimizer, lambda step: max(0.0, 1.0 - step / max(total_steps, 1)))

    model, optimizer, train_dataloader, eval_dataloader, lr_scheduler = accelerator.prepare(
        model, optimizer, train_dataloader, eval_dataloader, lr_scheduler
    )

    criterion = torch.nn.CrossEntropyLoss()
    final_accuracy = 0.0
    for epoch in range(num_epochs):
        model.train()
        for batch in train_dataloader:
            logits = model(batch["input_ids_a"], batch["input_ids_b"])
            loss = criterion(logits, batch["labels"])
            accelerator.backward(loss)
            optimizer.step()
            lr_scheduler.step()
            optimizer.zero_grad()

        model.eval()
        correct, total = [], []
        for batch in eval_dataloader:
            logits = model(batch["input_ids_a"], batch["input_ids_b"])
            preds = torch.argmax(logits, dim=-1)
            preds, refs = accelerator.gather_for_metrics((preds, batch["labels"]))
            correct.append(int((preds == refs).sum()))
            total.append(len(refs))
        final_accuracy = float(sum(correct)) / max(sum(total), 1)
        accelerator.print(f"epoch {epoch}: accuracy {final_accuracy:.3f}")
    return final_accuracy


PHASE9_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase9")
PHASE9_LAYERS, PHASE9_B, PHASE9_S, PHASE9_STEPS, PHASE9_EVAL = 4, 2, 2048, 5, 5
SM90_FLASH = ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel")


def fresh_state():
    """Clear the port's shared state: each run here names its own
    ``mixed_precision``, which a live state would refuse."""
    from accelerate_tpu_torch import AcceleratorState

    AcceleratorState._reset_state(reset_partial_state=True)


def phase9_policy_parity(cfg, batch, smi):
    """One forward and backward of the seed-0 model under ``"no"`` and under
    ``"bf16"``: llama casts each weight to ``config.dtype`` at use, so the
    policy's bf16 copies change no value: the loss is bit-identical, and so
    is every gradient but the embedding table's (bf16 sums of its repeated
    rows under the policy, fp32 sums without)."""
    from accelerate_tpu_torch import Accelerator, PreparedModel
    from accelerate_tpu_torch.models import llama

    model = llama.LlamaForCausalLM(cfg, seed=0)
    out, mem = {}, {}
    for mode in ("no", "bf16"):
        fresh_state()
        acc = Accelerator(mixed_precision=mode)
        prepared = acc.prepare(model)
        check(isinstance(prepared, PreparedModel) == (mode == "bf16"), f"prepare under {mode}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = prepared(**batch)["loss"]
        held = torch.cuda.memory_allocated() - base
        fwd_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        acc.backward(loss)
        mem[mode] = (fwd_peak, held, torch.cuda.max_memory_allocated() - base)
        out[mode] = (loss.item(), [p.grad for p in model.parameters()])
        for p in model.parameters():
            p.grad = None
    layer_params = sum(p.numel() for n, p in model.named_parameters() if n.startswith("layers."))
    (f_no, h_no, b_no), (f_bf, h_bf, b_bf) = mem["no"], mem["bf16"]
    log(f"phase9 memory of one forward and backward, 'no' vs 'bf16', in bytes above what was "
        f"allocated before it: forward peak {f_no} vs {f_bf} ({f_bf - f_no:+d}); held after "
        f"the forward {h_no} vs {h_bf} ({h_bf - h_no:+d}; the layers' bf16 copy, computed, "
        f"{2 * layer_params}); backward peak {b_no} vs {b_bf} ({b_bf - b_no:+d}); "
        f"forward+backward peak {max(f_no, b_no)} vs {max(f_bf, b_bf)} "
        f"({max(f_bf, b_bf) - max(f_no, b_no):+d}); {smi}")
    names = [n for n, _ in model.named_parameters()]
    loss_no, grads_no = out["no"]
    loss_bf, grads_bf = out["bf16"]
    rel = {n: ((a - b).abs().max() / a.abs().max()).item()
           for n, a, b in zip(names, grads_no, grads_bf)}
    log(f"phase9 mixed_precision 'no' vs 'bf16', one step from seed 0: loss {loss_no!r} vs "
        f"{loss_bf!r} (bit-identical: {loss_no == loss_bf}); per gradient leaf "
        "max|diff|/max|'no'|: " + " ".join(f"{n}={r:.3e}" for n, r in rel.items()))
    check(loss_no == loss_bf, f"the bf16 policy changed the first loss: {loss_no} vs {loss_bf}")
    check(all(r == 0.0 for n, r in rel.items() if n != "top.embed"),
          f"gradients other than the embedding's differ: {rel}")
    check(rel["top.embed"] <= BF16_GRAD_TOL, f"embedding gradient differs by {rel['top.embed']}")
    del model, out, grads_no, grads_bf
    torch.cuda.empty_cache()
    return loss_bf


def phase9_run(cfg, train, evals, policy, smi):
    """The README loop under ``Accelerator(mixed_precision="bf16")`` with
    ``remat_policy=policy``: prepare(model, AdamW, train loader, eval
    loader, LambdaLR), 5 optimizer steps (the fifth under
    ``accelerator.profile()``), then an eval pass with
    ``gather_for_metrics``; returns the losses, step times, launches per
    micro-batch, peak memory and the eval rows."""
    import io

    from torch.utils.data import DataLoader

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.utils import ProfileKwargs

    shutil.rmtree(PHASE9_DIR, ignore_errors=True)
    fresh_state()
    acc = Accelerator(mixed_precision="bf16",
                      kwargs_handlers=[ProfileKwargs(output_trace_dir=PHASE9_DIR)])
    inner = llama.LlamaForCausalLM(dataclasses.replace(cfg, remat_policy=policy), seed=0)
    opt = torch.optim.AdamW(inner.parameters(), lr=3e-5, weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda n: min(1.0, (n + 1) / 2))
    model, opt, train_dl, eval_dl, sched = acc.prepare(
        inner, opt, DataLoader(train, batch_size=PHASE9_B),
        DataLoader(evals, batch_size=PHASE9_B), sched)
    check(acc.unwrap_model(model) is inner, "unwrap_model did not return the module")
    torch.cuda.synchronize()
    losses, step_s, per_batch, fb_peak, opt_peak = [], [], [], 0, 0
    model.train()
    for i, batch in enumerate(train_dl):
        before = read_flash_counts()
        profiled = acc.profile() if i == PHASE9_STEPS - 1 else contextlib.nullcontext()
        t0 = time.perf_counter()
        with profiled as prof:
            # The allocator's peaks follow the host's order of allocations:
            # no sync is needed to split the step's into its two parts.
            torch.cuda.reset_peak_memory_stats()
            with acc.accumulate(model):
                loss = model(**batch)["loss"]
                acc.backward(loss)
                fb_peak = max(fb_peak, torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
                opt.step()
                sched.step()
                opt.zero_grad()
                losses.append(loss.item())
            opt_peak = max(opt_peak, torch.cuda.max_memory_allocated())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        after = read_flash_counts()
        per_batch.append(tuple(after[n] - before[n] for n in FLASH_KERNELS))
    peak = max(fb_peak, opt_peak)
    _, busy, groups, launches, _ = kernel_groups(prof)
    model.eval()
    rows = []
    with torch.no_grad():
        for batch in eval_dl:
            per_row = torch.stack([model(input_ids=r[None])["loss"] for r in batch["input_ids"]])
            rows.append(acc.gather_for_metrics(per_row))
    rows = torch.cat(rows)
    traces = [os.path.join(dp, f) for dp, _, fs in os.walk(PHASE9_DIR) for f in fs]
    text = "".join(open(t).read() for t in traces)
    named = {k: text.count(k) for k in SM90_FLASH}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        acc.print(f"phase9 {policy} printed once")
    ms = median(step_s[1:]) * 1e3
    log(f"phase9 remat_policy={policy}: losses {losses!r} step_ms={ms:.2f} (median of steps "
        f"2-5; each {[round(t * 1e3, 2) for t in step_s]}) peak_mem_bytes={peak} "
        f"({peak / 1e9:.3f} GB; forward+backward {fb_peak}, optimizer step {opt_peak}); "
        f"profiled step 5: device_busy_ms={busy:.2f} idle_share={1 - busy / step_s[-1] / 1e3:.3f} "
        "by group (ms, launches) " + " ".join(f"{k}={v:.2f}/{launches[k]}"
                                             for k, v in groups.items())
        + f"; flash launches per micro-batch {per_batch} eval rows "
        f"{rows.shape[0]} (losses {[round(x, 4) for x in rows.tolist()]}); trace files "
        f"{[os.path.relpath(t, PHASE9_DIR) for t in traces]} naming {named}; {smi}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(out.getvalue() == f"phase9 {policy} printed once\n", f"print gave {out.getvalue()!r}")
    check(rows.shape == (PHASE9_EVAL,) and torch.isfinite(rows).all(),
          f"gather_for_metrics gave {rows.shape[0]} rows, want {PHASE9_EVAL}")
    check(len(traces) == 1 and all(named.values()), f"trace {traces} names {named}")
    before = torch.cuda.memory_allocated()
    del inner, loss, batch
    nones = acc.free_memory(model, opt, train_dl, eval_dl, sched)
    model = opt = train_dl = eval_dl = sched = None
    freed = before - torch.cuda.memory_allocated()
    log(f"phase9 free_memory returned {nones}; memory_allocated {before} -> "
        f"{before - freed} bytes")
    check(nones == [None] * 5 and freed > 0, f"free_memory: {nones}, freed {freed} bytes")
    shutil.rmtree(PHASE9_DIR, ignore_errors=True)
    return {"losses": losses, "ms": ms, "peak": peak, "fb_peak": fb_peak,
            "per_batch": per_batch, "gemm_ms": groups["GEMMs"], "busy_ms": busy}


def phase9(smi):
    """9a: the slice at full width (Llama-3-8B widths, 4 layers, bf16
    policy over fp32 parameters, B 2 x S 2048); 9b: the README example's
    twin on the card and on the CPU."""
    import argparse
    import gc

    from accelerate_tpu_torch.models import llama

    # Earlier phases leave device memory reachable only through reference
    # cycles; collect it first, so Phase 9's peaks are its own.
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase9 memory_allocated on entry {held} bytes, {torch.cuda.memory_allocated()} after "
        "gc.collect()")
    cfg = llama.LlamaConfig.llama3_8b(num_layers=PHASE9_LAYERS, dtype=torch.bfloat16,
                                      param_dtype=torch.float32, remat=True)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, cfg.vocab_size, size=(2 * PHASE9_STEPS + PHASE9_EVAL, PHASE9_S))
    rows = [{"input_ids": torch.from_numpy(r)} for r in ids]
    train, evals = rows[:2 * PHASE9_STEPS], rows[2 * PHASE9_STEPS:]
    hd, tokens = cfg.head_dim_, PHASE9_B * PHASE9_S
    # The seven projections' outputs "dots" keeps, bf16 values per token per layer.
    saved = (cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd + 2 * cfg.hidden_size
             + 2 * cfg.intermediate_size)
    log(f"phase9 Llama-3-8B widths, {PHASE9_LAYERS} layers, {cfg.num_params()} fp32 "
        f"parameters, bf16 policy, B {PHASE9_B} x S {PHASE9_S}, {PHASE9_STEPS} AdamW steps, "
        f"eval over {PHASE9_EVAL} sequences; computed: fp32 parameters, gradients and AdamW's "
        f"two moments {16 * cfg.num_params()} bytes, the policy's bf16 copy "
        f"{2 * cfg.num_params()} bytes, 'dots' keeps {saved} bf16 values per token per layer, "
        f"{2 * saved * tokens} bytes a layer at {tokens} tokens")
    t0 = time.perf_counter()
    reset_counts()
    reset_flash_counts()
    first = phase9_policy_parity(cfg, {"input_ids": torch.from_numpy(ids[:PHASE9_B]).cuda()},
                                 smi)
    runs = {policy: phase9_run(cfg, train, evals, policy, smi) for policy in ("nothing", "dots")}
    layers = PHASE9_LAYERS
    for policy, r in runs.items():
        check(r["per_batch"] == [(2 * layers, layers, layers)] * PHASE9_STEPS,
              f"{policy}: launches per micro-batch {r['per_batch']}, want (2L, L, L)")
    gaps = [b - a for a, b in zip(runs["nothing"]["losses"], runs["dots"]["losses"])]
    log(f"phase9 dots - nothing: loss gaps {gaps} (bit-identical: {not any(gaps)}); step_ms "
        f"{runs['dots']['ms']:.2f} vs {runs['nothing']['ms']:.2f}; profiled step's GEMM ms "
        f"{runs['dots']['gemm_ms']:.2f} vs {runs['nothing']['gemm_ms']:.2f}, device busy ms "
        f"{runs['dots']['busy_ms']:.2f} vs {runs['nothing']['busy_ms']:.2f}; forward+backward "
        f"peak bytes {runs['dots']['fb_peak']} - {runs['nothing']['fb_peak']} = "
        f"{runs['dots']['fb_peak'] - runs['nothing']['fb_peak']}, the step's "
        f"{runs['dots']['peak']} - {runs['nothing']['peak']}; the training runs' first loss "
        f"{runs['nothing']['losses'][0]!r} vs the parity step's {first!r}")
    check(runs["nothing"]["losses"][0] == runs["dots"]["losses"][0] == first,
          "the first loss differs between the remat policies or from the parity step")
    check(max(abs(g) for g in gaps) <= BF16_LOSS_TOL, f"remat policies' losses part: {gaps}")
    t1 = time.perf_counter()

    # 9b: the twin of examples/nlp_example.py, JAX's threshold of 0.8.
    config = {"lr": 2e-3, "num_epochs": 2, "seed": 42, "batch_size": 16}
    accs = {}
    for where, cpu in (("card", False), ("cpu", True)):
        fresh_state()
        accs[where] = training_function(config, argparse.Namespace(
            mixed_precision="bf16", cpu=cpu, num_epochs=2))
    t2 = time.perf_counter()
    log(f"phase9b nlp_example twin, bf16 policy, 2 epochs: accuracy on the card "
        f"{accs['card']!r}, on the CPU {accs['cpu']!r} (threshold 0.8)")
    check(all(a > 0.8 for a in accs.values()), f"the example did not learn: {accs}")
    dec, win = read_counts()
    counts = dict(read_flash_counts(), paged_attention=dec, paged_window_attention=win)
    log(f"phase9 seconds: 9a {t1 - t0:.1f}, 9b {t2 - t1:.1f}; launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# Phase 10: the wide heads, and Gemma-2B at full width
# ---------------------------------------------------------------------------

# google/gemma-2b's config.json (Hugging Face Hub), the values config_from_hf reads.
GEMMA_2B = dict(
    model_type="gemma", architectures=["GemmaForCausalLM"], vocab_size=256000,
    hidden_size=2048, intermediate_size=16384, num_hidden_layers=18,
    num_attention_heads=8, num_key_value_heads=1, head_dim=256,
    max_position_embeddings=8192, rms_norm_eps=1e-6, rope_theta=10000.0,
    hidden_act="gelu_pytorch_tanh", hidden_activation=None, attention_bias=False,
    attention_dropout=0.0, tie_word_embeddings=True, bos_token_id=2, eos_token_id=1,
    pad_token_id=0, torch_dtype="bfloat16")
# Attention geometries (q heads, kv heads, head dim) of the published
# config.json files of google/gemma-2b, google/gemma-7b and
# microsoft/Phi-3-mini-4k-instruct (3072 / 32 = 96).
PHASE10_FLASH_SHAPES = (("Gemma-2B", 8, 1, 256), ("Gemma-7B", 16, 16, 256),
                        ("Phi-3-mini", 32, 32, 96))
PHASE10_PAGED = ((96, torch.bfloat16), (96, torch.float32), (256, torch.float32))
PHASE10_B, PHASE10_S, PHASE10_STEPS, PHASE10_PAD = 2, 2048, 5, 300
PHASE10_PEAK_LIMIT = 72e9  # bytes: B 2 when the reckoned peak stays under it, else B 1
# Phase 10b's bf16 first step, kernel path against plain path: the loss
# relative to itself.  Phase 5's absolute 1e-3 is 8.2e-5 of its loss (12.16)
# at 4 layers; Gemma-2B's 18 layers and sqrt(d)-scaled activations at a loss
# of ~15 read 1.051e-3 absolute, 7.0e-5 relative (bf16 rounding: the fp32
# step below agrees to 1e-4 and better).
PHASE10_BF16_LOSS_REL = 1e-4
# The bf16 d-256 kernels Gemma-2B's training step runs, as a profiler names
# them: the sm90 forward and dQ, the sm90 d-256 dK/dV (split over query
# heads at Gemma-2B's one kv head) and its sum kernel.
WIDE_FLASH = ("flash_fwd_sm90_kernel<__nv_bfloat16, 256>",
              "flash_bwd_dq_sm90_kernel<__nv_bfloat16, 256, 2>",
              "flash_bwd_dkv_sm90_d256_kernel<__nv_bfloat16, true>",
              "flash_bwd_dkv_sum_kernel<__nv_bfloat16>")
# microsoft/Phi-3-mini-4k-instruct's config.json (Hugging Face Hub): the
# widths Phase 10d trains, built directly as a LlamaConfig (32 heads of
# 3072 / 32 = 96).  Its sliding_window (2047) is left out: the JAX llama has
# none, and the port's hf_import refuses it.  Depth is cut to
# PHASE10D_LAYERS of its 32 layers to keep the script's time.
PHI3_MINI = dict(vocab_size=32064, hidden_size=3072, intermediate_size=8192, num_heads=32,
                 num_kv_heads=32, max_seq_len=4096, rope_theta=10000.0, rms_eps=1e-5,
                 tie_embeddings=False)
PHASE10D_LAYERS = 8
# The bf16 d-96 kernels Phi-3-mini's training step runs, as a profiler names
# them: the sm90 forward, dQ and dK/dV.
PHI3_FLASH = ("flash_fwd_sm90_kernel<__nv_bfloat16, 96>",
              "flash_bwd_dq_sm90_kernel<__nv_bfloat16, 96, 3>",
              "flash_bwd_dkv_sm90_kernel<__nv_bfloat16, 96, true>")
# The launcher each flash wrapper calls, by its base name.
FLASH_BASES = {"fused_attention_fwd": "atpu_flash_fwd",
               "fused_attention_bwd_dq": "atpu_flash_bwd_dq",
               "fused_attention_bwd_dkv": "atpu_flash_bwd_dkv"}


def direct_dkv_d256(fu, n_split, q, k, v, do, lse, delta):
    """The d-256 dK/dV launcher called directly (not counted) with the query
    heads split ``n_split`` ways; returns ``(dk, dv)``."""
    import torch

    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part = (torch.empty(2 * n_split * k.numel(), dtype=torch.float32, device=q.device)
            if n_split > 1 else None)
    fu._launch("atpu_flash_bwd_dkv_sm90_d256", q, k, v, None, do.data_ptr(), lse.data_ptr(),
               delta.data_ptr(), None, dk.data_ptr(), dv.data_ptr(),
               None if part is None else part.data_ptr(), causal=True, n_split=n_split)
    return dk, dv


def wide_previous(fu, copies, times, want):
    """In 16-bit types at d 96 and 256: the mma.sync bodies the sm90 kernels
    replace (the forward, dQ and dK/dV; called directly), each held to the
    plain versions' tolerance and timed in turns with the kernel (kernel,
    previous, previous, kernel); at d 256 also dK/dV at every split of the
    group, each held to the tolerance and timed.  Returns ``({wrapper: extra
    record keys}, {wrapper: second kernel ms})``."""
    import torch

    q, k, v, do, lse, delta = copies[0]
    d = q.shape[-1]
    tol = TOL[str(q.dtype)]
    want_out, want_dq, want_dk, want_dv = want
    fwd, dq, dkv = FLASH_KERNELS
    previous = {fwd: lambda q, k, v, *_: previous_fwd(fu, q, k, v),
                dq: lambda *a: direct_bwd(fu, "atpu_flash_bwd_dq", *a),
                dkv: lambda *a: direct_bwd(fu, "atpu_flash_bwd_dkv", *a)}
    refs = {fwd: (want_out,), dq: (want_dq,), dkv: (want_dk, want_dv)}
    kernels = {fwd: (lambda q, k, v, *_: fu.fused_attention_fwd(q, k, v, causal=True,
                                                                block_size=q.shape[1])),
               dq: (lambda *a: fu.fused_attention_bwd_dq(*a, causal=True)),
               dkv: (lambda *a: fu.fused_attention_bwd_dkv(*a, causal=True))}
    extra, second = {}, {}
    for wrapper, call in previous.items():
        got = call(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        pairs = list(zip(got, refs[wrapper]))
        err = max((g.float() - w.float()).abs().max().item() for g, w in pairs)
        check(all(torch.allclose(g.float(), w.float(), atol=tol, rtol=tol) for g, w in pairs),
              f"previous {wrapper} body at d {d}: max abs err {err} over atol=rtol={tol}")
        del got, pairs
        prev = [cuda_ms(call, copies, iters=10) for _ in range(2)]
        second[wrapper] = cuda_ms(kernels[wrapper], copies, iters=10)
        extra[wrapper] = dict(previous_ms=sum(prev) / 2, previous_max_abs_err=err,
                              previous_body=FLASH_BASES[wrapper])
        log(f"phase10a {wrapper} {q.dtype} d={d} in turns: kernel {times[wrapper]:.4f} "
            f"previous {prev[0]:.4f} previous {prev[1]:.4f} kernel {second[wrapper]:.4f} ms; "
            f"previous max abs err {err:.3e}")
    if d != 256:
        return extra, second
    b, s, h, _ = q.shape
    g = h // k.shape[2]
    split_ms, split_err = {}, {}
    for n in (n for n in range(1, g + 1) if g % n == 0):
        dk, dv = direct_dkv_d256(fu, n, q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        split_err[n] = max((dk.float() - want_dk.float()).abs().max().item(),
                           (dv.float() - want_dv.float()).abs().max().item())
        check(torch.allclose(dk.float(), want_dk.float(), atol=tol, rtol=tol)
              and torch.allclose(dv.float(), want_dv.float(), atol=tol, rtol=tol),
              f"d-256 dK/dV at n_split {n}: max abs err {split_err[n]} over atol=rtol={tol}")
        del dk, dv
        split_ms[n] = cuda_ms(lambda *a, n=n: direct_dkv_d256(fu, n, *a), copies, iters=10)
    picked = fu.pick_dkv_split(b, k.shape[2], s, g, fu._sm_count(q.device))
    log(f"phase10a fused_attention_bwd_dkv {q.dtype} d=256 by n_split (ms): "
        + " ".join(f"{n}={t:.4f}" for n, t in split_ms.items()) + f"; picked {picked}")
    extra["fused_attention_bwd_dkv"].update(n_split=picked, split_ms=split_ms,
                                            split_max_abs_err=split_err)
    return extra, second


def wide_flash_times(fu, F, q, k, v, do, out, lse, blk, errs, want):
    """Kernel (L2-cold copies, as Phase 4), plain, bound and ``sdpa`` times
    of the three flash kernels at one shape, with the launcher each wrapper
    called (``body``) and δ's time; in 16-bit types also the replaced
    mma.sync bodies' times (:func:`wide_previous`).  ``sdpa``'s failure is recorded
    as its error."""
    delta = attention_delta(out, do)
    set_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, do))
    copies = [(q, k, v, do, lse, delta)] + [
        tuple(t.clone() for t in (q, k, v, do, lse, delta))
        for _ in range(math.ceil(100e6 / set_bytes) - 1)]
    times = {
        "fused_attention_fwd": cuda_ms(
            lambda q, k, v: fu.fused_attention_fwd(q, k, v, causal=True, block_size=blk),
            [c[:3] for c in copies], iters=10),
        "fused_attention_bwd_dq": cuda_ms(
            lambda *a: fu.fused_attention_bwd_dq(*a, causal=True), copies, iters=10),
        "fused_attention_bwd_dkv": cuda_ms(
            lambda *a: fu.fused_attention_bwd_dkv(*a, causal=True), copies, iters=10),
    }
    prev, second = {}, {}
    if q.dtype != torch.float32:
        prev, second = wide_previous(fu, copies, times, want)
        for name, ms in second.items():
            times[name] = 0.5 * (times[name] + ms)
    del copies
    plain_fwd = cuda_ms(lambda q, k, v: fu.fused_attention_fwd_plain(
        q, k, v, causal=True, block_size=blk), [(q, k, v)], iters=2)
    plain_bwd = cuda_ms(lambda q, k, v, do: fu.fused_attention_bwd_plain(
        q, k, v, out, lse, do, causal=True, block_size=blk), [(q, k, v, do)], iters=2)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))

    def sdpa(qt, kt, vt):
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd(qt, kt, vt, dot):
        qt, kt, vt = (t.detach().requires_grad_() for t in (qt, kt, vt))
        sdpa(qt, kt, vt).backward(dot)

    lib_fwd = lib_bwd = lib_err = None
    try:
        lib_fwd = cuda_ms(sdpa, [(qt, kt, vt)], iters=10)
        lib_bwd = cuda_ms(sdpa_fwd_bwd, [(qt, kt, vt, dot)], iters=10) - lib_fwd
    except RuntimeError as e:  # a shape sdpa refuses is recorded, not raised
        lib_err = str(e).splitlines()[0][:200]
    del qt, kt, vt, dot
    delta_ms = cuda_ms(attention_delta, [(out, do)], iters=10)
    bwd_ms = delta_ms + times["fused_attention_bwd_dq"] + times["fused_attention_bwd_dkv"]
    log(f"phase10a {q.dtype} H={q.shape[2]} K={k.shape[2]} d={q.shape[-1]} backward: delta "
        f"{delta_ms:.4f} + dQ {times['fused_attention_bwd_dq']:.4f} + dK/dV "
        f"{times['fused_attention_bwd_dkv']:.4f} = {bwd_ms:.4f} ms against sdpa's whole "
        f"backward {lib_bwd}")
    bounds, _ = flash_bounds(q, k, True)
    err = {"fused_attention_fwd": errs["out"], "fused_attention_bwd_dq": errs["dq"],
           "fused_attention_bwd_dkv": max(errs["dk"], errs["dv"])}
    rec = {}
    for name in FLASH_KERNELS:
        b_ms, b_by = bounds[name]
        fwd = name == "fused_attention_fwd"
        rec[name] = dict(max_abs_err=err[name], ms=times[name],
                         plain_ms=plain_fwd if fwd else plain_bwd, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_fwd if fwd else None,
                         library_bwd_ms=None if fwd else lib_bwd, library_error=lib_err,
                         body=fu._symbol(FLASH_BASES[name], q), **prev.get(name, {}))
    rec["fused_attention_bwd_dq"]["delta_ms"] = delta_ms
    return rec


def phase10a(smi):
    """The three flash kernels at head dims 256 and 96 (Gemma-2B, Gemma-7B
    and Phi-3-mini attention geometry, B 2 x S 2048 causal, unpadded and
    with batch 0 left-padded by 300 keys) in bf16 and fp32, and fp16 at
    Gemma-2B's, with the replaced mma.sync bodies beside the sm90 ones; the
    paged
    pair at head dim 96 (bf16, fp32) and 256 (fp32) at Phase 1's long
    shape, each against its plain version, with times."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import fused_attention as fu
    from accelerate_tpu_torch.ops import paged_attention as pa
    from accelerate_tpu_torch.ops.flash_attention import pick_block_pallas

    gen = torch.Generator(device="cuda").manual_seed(10)
    flash = {}
    b, s = PHASE10_B, PHASE10_S
    for geom, h, kh, d in PHASE10_FLASH_SHAPES:
        blk = pick_block_pallas(s, d)
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            if dtype == torch.float16 and geom != "Gemma-2B":
                continue
            tol = TOL[str(dtype)]
            for pad in (0, PHASE10_PAD):
                q, k, v, do, valid = flash_inputs(dtype, b, s, pad, gen, h=h, kh=kh, d=d)
                out, lse = fu.fused_attention_fwd(q, k, v, valid, causal=True, block_size=blk)
                dq, dk, dv = fu.fused_attention_bwd(q, k, v, out, lse, do, valid, causal=True,
                                                    block_size=blk)
                torch.cuda.synchronize()
                want_out, want_lse = fu.fused_attention_fwd_plain(q, k, v, valid, causal=True,
                                                                  block_size=blk)
                want = fu.fused_attention_bwd_plain(q, k, v, out, lse, do, valid, causal=True,
                                                    block_size=blk)
                errs = {}
                for name, got, ref in (("out", out, want_out), ("lse", lse, want_lse),
                                       ("dq", dq, want[0]), ("dk", dk, want[1]),
                                       ("dv", dv, want[2])):
                    check(bool(torch.isfinite(got).all()), f"phase10 {geom} {dtype} {name}: "
                          "non-finite")
                    errs[name] = (got.float() - ref.float()).abs().max().item()
                    check(torch.allclose(got.float(), ref.float(), atol=tol, rtol=tol),
                          f"phase10 flash {geom} d={d} {dtype} pad={pad} {name}: max abs err "
                          f"{errs[name]} over atol=rtol={tol}")
                if pad:
                    check(bool((out[0, :pad] == 0).all()) and bool((dq[0, :pad] == 0).all()),
                          "empty rows must output zero and get zero gradient")
                log(f"phase10a flash {geom} H={h} K={kh} d={d} {dtype} B={b} S={s} causal "
                    f"left_pad={pad}: max_abs_err "
                    + " ".join(f"{n}={e:.3e}" for n, e in errs.items()) + f" (atol=rtol={tol})")
                if not pad:
                    rec = wide_flash_times(fu, F, q, k, v, do, out, lse, blk, errs,
                                           (want_out, *want))
                    flash[(geom, str(dtype))] = rec
                    for name, r in rec.items():
                        log(f"phase10a {name} {geom} d={d} {dtype}: body {r['body']} "
                            f"kernel_ms={r['ms']:.4f} previous_ms={r.get('previous_ms')} "
                            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                            f"({r['bound_by']}) library_ms={r['library_ms']} "
                            f"library_bwd_ms={r['library_bwd_ms']} "
                            f"library_error={r['library_error']}; {smi}")
                del q, k, v, do, valid, out, lse, dq, dk, dv, want_out, want_lse, want
                torch.cuda.empty_cache()

    order = ("q", "k_new", "v_new", "pool_k", "pool_v", "tables", "lengths")
    lengths = PHASE1_SHAPES[0][1]
    paged = {}
    for d, dtype in PHASE10_PAGED:
        for name, window in (("paged_attention", None), ("paged_window_attention", 4)):
            kern, plain = getattr(pa, name), getattr(pa, name + "_plain")
            a = kernel_inputs(dtype, window, lengths, gen, hd=d)
            tol = TOL[str(dtype)]
            got = kern(**a)
            torch.cuda.synchronize()
            want = plain(**a)
            err = (got.float() - want.float()).abs().max().item()
            check(bool(torch.isfinite(got).all()), f"phase10 {name} d={d} {dtype}: non-finite")
            check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
                  f"phase10 {name} d={d} {dtype}: max abs err {err} over atol=rtol={tol}")
            pool_bytes = 2 * a["pool_k"].numel() * a["pool_k"].element_size()
            copies = [a] + [dict(a, pool_k=a["pool_k"].clone(), pool_v=a["pool_v"].clone())
                            for _ in range(math.ceil(100e6 / pool_bytes) - 1)]
            sets = [tuple(c[k] for k in order) for c in copies]
            k_ms = graph_ms(kern, sets)
            p_ms = graph_ms(plain, sets[:1], iters=5, replays=2)
            lib_fn, lib_args = library_call(a, window)
            lib_ms = graph_ms(lib_fn, [lib_args], iters=10)
            b_ms, b_by = bound_ms(a, window)
            paged[(name, d, str(dtype))] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            log(f"phase10a {name} d={d} {dtype} W={window or 1} long lengths={lengths}: "
                f"max_abs_err={err:.3e} (atol=rtol={tol}) kernel_ms={k_ms:.4f} "
                f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) library_ms={lib_ms:.4f}; "
                f"{smi}")
            del a, copies, sets, lib_args
            torch.cuda.empty_cache()
    return flash, paged


def gemma_2b_config(**overrides):
    """Gemma-2B's config, built by the port's ``config_from_hf`` from its
    published ``config.json`` values."""
    from types import SimpleNamespace

    from accelerate_tpu_torch.models.hf_import import config_from_hf

    return config_from_hf(SimpleNamespace(**GEMMA_2B), **overrides)


def phase10_policy_memory(model, batch, smi):
    """One forward and backward of Gemma-2B under ``"no"`` and ``"bf16"``:
    the memory held after the forward and the forward+backward peak (C10:
    llama casts each layer's weights inside its checkpointed layer, so the
    policy keeps no stacked 16-bit copy), and the loss bit-identical."""
    from accelerate_tpu_torch import Accelerator

    mem, losses = {}, {}
    for mode in ("no", "bf16"):
        fresh_state()
        prepared = Accelerator(mixed_precision=mode).prepare(model)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = prepared(**batch)["loss"]
        held = torch.cuda.memory_allocated() - base
        fwd_peak = torch.cuda.max_memory_allocated() - base
        grads = torch.autograd.grad(loss, list(model.parameters()))
        peak = torch.cuda.max_memory_allocated() - base
        mem[mode], losses[mode] = (held, max(fwd_peak, peak)), loss.item()
        del loss, grads, prepared
        torch.cuda.empty_cache()
    layer = sum(p[0].numel() for n, p in model.named_parameters() if n.startswith("layers."))
    (h_no, p_no), (h_bf, p_bf) = mem["no"], mem["bf16"]
    log(f"phase10b C10 one forward and backward, 'no' vs 'bf16', bytes above what was "
        f"allocated before it: held after the forward {h_no} vs {h_bf} ({h_bf - h_no:+d}; "
        f"one layer's bf16 copy, computed, {2 * layer}; the stacked copy of all layers, "
        f"computed, {2 * layer * model.config.num_layers}); forward+backward peak {p_no} vs "
        f"{p_bf} ({p_bf - p_no:+d}); loss {losses['no']!r} vs {losses['bf16']!r}; {smi}")
    check(losses["no"] == losses["bf16"], f"the bf16 policy changed the loss: {losses}")
    check(h_bf - h_no <= 2 * layer, f"the bf16 policy holds {h_bf - h_no} bytes more than "
          f"'no' after the forward, over one layer's copy {2 * layer}")
    return mem


def phase10b(smi):
    """Gemma-2B (published widths, all 18 layers, random weights from seed
    0) trained through the README loop: the export/import round trip, C10's
    memory, the kernel path against the plain path, then 5 steps of
    ``prepare(model, AdamW, DataLoader, LambdaLR)`` under
    ``mixed_precision="bf16"`` with ``remat=True``."""
    from accelerate_tpu_torch.models import hf_export, hf_import, llama

    cfg = gemma_2b_config(dtype=torch.bfloat16, param_dtype=torch.float32, remat=True)
    n = cfg.num_params()
    v, d, f, L, s = cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, \
        PHASE10_S
    # The peak, reckoned: fp32 parameters, gradients and AdamW's two moments
    # (16 B a parameter), the bf16 embedding (tied head) and its gradient,
    # the logits chain at the loss (bf16 logits, their fp32 copy, the log
    # softmax and its gradient: 14 B a logit), the layers' saved inputs and
    # one recomputed layer's MLP.
    def reckon(b):
        return (16 * n + 4 * v * d + b * s * v * 14 + L * b * s * d * 2 + b * s * f * 2 * 4)

    b = PHASE10_B if reckon(PHASE10_B) < PHASE10_PEAK_LIMIT else 1
    log(f"phase10b Gemma-2B from config_from_hf(google/gemma-2b config.json): vocab {v} d {d} "
        f"ffn {f} layers {L} heads {cfg.num_heads}/{cfg.num_kv_heads} head_dim {cfg.head_dim_} "
        f"act {cfg.hidden_act} rms_offset {cfg.rms_offset} embed_scale {cfg.embed_scale} tied "
        f"{cfg.tie_embeddings} rope_theta {cfg.rope_theta} eps {cfg.rms_eps}; {n} parameters, "
        f"{4 * n} bytes fp32, {16 * n} bytes of fp32 training state; reckoned peak at B 2 x S "
        f"{s} {reckon(2)} bytes, at B 1 {reckon(1)}, limit {PHASE10_PEAK_LIMIT:.0f}: B {b}")
    t0 = time.perf_counter()
    model = llama.LlamaForCausalLM(cfg, seed=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params = model.params
    want = {k: v_.detach().clone() for k, v_ in params.items() if k != "layers"}
    sd = hf_export.export_state_dict("llama", params, cfg)
    back = hf_import.import_state_dict("llama", sd, cfg, consume_source=True)
    del sd
    same = all(torch.equal(back[k], want[k]) for k in want) and all(
        torch.equal(back["layers"][k], params["layers"][k]) for k in params["layers"])
    torch.cuda.synchronize()
    log(f"phase10b init_s={t1 - t0:.1f}; export_state_dict -> import_state_dict round trip "
        f"bit-identical: {same} ({time.perf_counter() - t1:.1f} s)")
    check(same, "the HF export/import round trip changed the parameters")
    del back, want, params
    torch.cuda.empty_cache()

    rng = np.random.default_rng(10)
    ids = rng.integers(0, v, size=(b * PHASE10_STEPS, s))
    rows = [{"input_ids": torch.from_numpy(r)} for r in ids]
    first = {"input_ids": torch.from_numpy(ids[:b]).cuda()}
    mem = phase10_policy_memory(model, first, smi)

    kernel_vs_plain_step(model, cfg, first, "phase10b")
    out = readme_loop(model, cfg, rows, b, "phase10b", smi, WIDE_FLASH)
    losses, per_step, wide = out["losses"], out["per_step"], out["traced"]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(per_step == [(2 * L, L, L)] * PHASE10_STEPS,
          f"flash launches per step {per_step}, want (2L, L, L) = {(2 * L, L, L)}")
    check(all(wide.values()), f"the profiler trace names no d-256 kernel: {wide}")
    out["mem"] = mem
    params16 = {k: (val.detach().to(torch.bfloat16) if not isinstance(val, dict) else
                    {kk: vv.detach().to(torch.bfloat16) for kk, vv in val.items()})
                for k, val in model.params.items()}
    del model
    gc_collect()
    return out, params16


def kernel_vs_plain_step(model, cfg, first, tag):
    """The first step's loss and gradients on the kernel path against the
    plain path (the fused op's plain versions): with fp32 activations loss
    and every leaf within a relative 1e-4, as Phase 5; in bf16 the loss
    within ``PHASE10_BF16_LOSS_REL`` of itself and every leaf within a
    relative ``BF16_GRAD_TOL``."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    loss_k, grads_k = loss_and_grads(model, cfg32, first)
    with plain_flash():
        loss_p, grads_p = loss_and_grads(model, cfg32, first)
    rel = max(((gk - gp).abs().max() / gp.abs().max()).item()
              for gk, gp in zip(grads_k, grads_p))
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"{tag} fp32 first step, kernel vs plain path: loss {loss_k.item():.6f} vs "
        f"{loss_p.item():.6f} (rel {loss_rel:.3e}); max over {len(grads_k)} gradient leaves "
        f"of max|diff|/max|plain| = {rel:.3e} (limit 1e-4)")
    check(loss_rel <= 1e-4 and rel <= 1e-4,
          f"{tag} fp32 kernel path differs: loss {loss_rel}, grad {rel}")
    del grads_k, grads_p
    torch.cuda.empty_cache()
    loss_k, grads_k = loss_and_grads(model, cfg, first)
    with plain_flash():
        loss_p, grads_p = loss_and_grads(model, cfg, first)
    loss_k, loss_p = loss_k.item(), loss_p.item()
    rels = [((gk - gp).abs().max() / gp.abs().max()).item() for gk, gp in zip(grads_k, grads_p)]
    names = [nm for nm, _ in model.named_parameters()]
    loss_lim = PHASE10_BF16_LOSS_REL * abs(loss_p)
    log(f"{tag} bf16 first step, kernel vs plain path: loss {loss_k:.5f} vs {loss_p:.5f} "
        f"(|diff| {abs(loss_k - loss_p):.3e}, limit {loss_lim:.3e} = "
        f"{PHASE10_BF16_LOSS_REL} of the loss); per gradient leaf max|diff|/max|plain|: "
        + " ".join(f"{nm}={r:.3e}" for nm, r in zip(names, rels)) + f" (limit {BF16_GRAD_TOL})")
    check(abs(loss_k - loss_p) <= loss_lim, f"{tag} bf16 loss differs by {abs(loss_k - loss_p)}")
    check(max(rels) <= BF16_GRAD_TOL, f"{tag} bf16 gradients differ: {max(rels)}")
    del grads_k, grads_p
    torch.cuda.empty_cache()


def readme_loop(model, cfg, rows, b, tag, smi, traced):
    """The README loop under ``Accelerator(mixed_precision="bf16")``:
    ``prepare(model, AdamW, DataLoader(rows, batch_size=b), LambdaLR)``, one
    step a batch, the last profiled.  Logs and returns the losses, step time
    (median of steps 2 on), tokens/s, peak memory, the profiled step's idle
    share and device time by group, the flash launches of each step and the
    launches in the profiled step of each kernel named in ``traced``; frees
    what the accelerator holds."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.data import DataLoader

    from accelerate_tpu_torch import Accelerator

    fresh_state()
    acc = Accelerator(mixed_precision="bf16")
    opt = torch.optim.AdamW(model.parameters(), lr=3e-5, weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda i: min(1.0, (i + 1) / 2))
    pmodel, opt, dl, sched = acc.prepare(model, opt, DataLoader(rows, batch_size=b), sched)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, per_step = [], [], []
    reset_flash_counts()
    for i, batch in enumerate(dl):
        before = read_flash_counts()
        ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
               if i == len(dl) - 1 else contextlib.nullcontext())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx as prof:
            with acc.accumulate(pmodel):
                loss = pmodel(**batch)["loss"]
                acc.backward(loss)
                opt.step()
                sched.step()
                opt.zero_grad()
            losses.append(loss.item())
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        after = read_flash_counts()
        per_step.append(tuple(after[k] - before[k] for k in FLASH_KERNELS))
    counts = read_flash_counts()
    peak = torch.cuda.max_memory_allocated()
    by_kernel, busy, groups, launches, flash = kernel_groups(prof)
    in_trace = {k: sum(cnt for _, cnt, key in by_kernel if k in key) for k in traced}
    n, v, d, L, s = (cfg.num_params(), cfg.vocab_size, cfg.hidden_size, cfg.num_layers,
                     len(rows[0]["input_ids"]))
    tokens = b * s
    dense = n - (0 if cfg.tie_embeddings else v * d)  # the embedding lookup is no product
    pairs = s * (s + 1) // 2
    flops = 6 * dense * tokens + L * 3.5 * 4 * b * cfg.num_heads * cfg.head_dim_ * pairs
    ms = median(step_s[1:]) * 1e3
    idle = 1 - busy / (step_s[-1] * 1e3)
    log(f"{tag} README loop, bf16 policy, B {b} x S {s}, {len(step_s)} steps: losses "
        f"{losses!r} step_ms={ms:.2f} (median of steps 2-{len(step_s)}; each "
        f"{[round(x * 1e3, 2) for x in step_s]}; the last profiled) tokens_per_s="
        f"{tokens / ms * 1e3:.1f} model_tflop_per_step={flops / 1e12:.3f} "
        f"bf16_peak_share={flops / (ms / 1e3) / PEAK_FLOPS['torch.bfloat16']:.4f} "
        f"peak_mem_bytes={peak}; profiled step: device_busy_ms={busy:.2f} idle_share="
        f"{idle:.3f} by group (ms, launches) "
        + " ".join(f"{k}={t:.2f}/{launches[k]}" for k, t in groups.items())
        + f"; flash: {', '.join(flash)}; kernels in the trace {in_trace}; flash launches "
        f"per step {per_step}; {smi}")
    for t, cnt, key in by_kernel[:8]:
        log(f"{tag}   device {t:.3f} ms in {cnt} launches: {key[:110]}")
    out = dict(counts=counts, ms=ms, tokens_per_s=tokens / ms * 1e3, peak=peak, idle=idle, b=b,
               losses=losses, per_step=per_step, traced=in_trace, by_kernel=by_kernel)
    nones = acc.free_memory(pmodel, opt, dl, sched)
    del pmodel, opt, dl, sched, loss, batch, prof, nones
    gc_collect()
    return out


def phi3_mini_model():
    """Phi-3-mini's widths (``PHI3_MINI``) cut to ``PHASE10D_LAYERS`` layers,
    bf16 compute, fp32 parameters, ``remat=True``, random weights from seed
    0: ``(cfg, model)``."""
    from accelerate_tpu_torch.models import llama

    cfg = llama.LlamaConfig(**PHI3_MINI, num_layers=PHASE10D_LAYERS, dtype=torch.bfloat16,
                            param_dtype=torch.float32, remat=True)
    return cfg, llama.LlamaForCausalLM(cfg, seed=0)


def phase10d_loop(cfg, model, smi):
    """Phase 10d's README loop: ``PHASE10_STEPS`` steps at B ``PHASE10_B`` x
    S ``PHASE10_S`` from seed 12 (:func:`readme_loop`)."""
    rng = np.random.default_rng(12)
    ids = rng.integers(0, cfg.vocab_size, size=(PHASE10_B * PHASE10_STEPS, PHASE10_S))
    rows = [{"input_ids": torch.from_numpy(r)} for r in ids]
    return readme_loop(model, cfg, rows, PHASE10_B, "phase10d", smi, PHI3_FLASH)


def phase10d(smi):
    """Phi-3-mini (published widths cut to 8 of 32 layers, head dim 96)
    trained through the README loop: the kernel path against the plain path,
    then 5 steps under ``mixed_precision="bf16"`` with ``remat=True``,
    launching the d-96 sm90 forward, dQ and dK/dV and no kernel of
    ``flash_attention.cu``."""
    t0 = time.perf_counter()
    cfg, model = phi3_mini_model()
    torch.cuda.synchronize()
    n, b, s, L = cfg.num_params(), PHASE10_B, PHASE10_S, cfg.num_layers
    log(f"phase10d Phi-3-mini from microsoft/Phi-3-mini-4k-instruct's config.json: vocab "
        f"{cfg.vocab_size} d {cfg.hidden_size} ffn {cfg.intermediate_size} heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} head_dim {cfg.head_dim_} untied head, rope_theta "
        f"{cfg.rope_theta} eps {cfg.rms_eps}; depth cut to {L} of 32 layers; its "
        f"sliding_window 2047 left out (the JAX llama has none, hf_import refuses it); {n} "
        f"parameters, {16 * n} bytes of fp32 training state; init_s="
        f"{time.perf_counter() - t0:.1f}")
    first = {"input_ids": torch.from_numpy(
        np.random.default_rng(12).integers(0, cfg.vocab_size, size=(b, s))).cuda()}
    kernel_vs_plain_step(model, cfg, first, "phase10d")
    del first
    out = phase10d_loop(cfg, model, smi)
    losses, per_step = out["losses"], out["per_step"]
    legacy = sorted({key[:60] for _, _, key in out["by_kernel"]
                     if re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_kernel", key)})
    check(all(math.isfinite(x) for x in losses), f"phase10d non-finite loss {losses}")
    check(per_step == [(2 * L, L, L)] * PHASE10_STEPS,
          f"phase10d flash launches per step {per_step}, want (2L, L, L) = {(2 * L, L, L)}")
    check(all(out["traced"].values()), f"the trace lacks a d-96 sm90 kernel: {out['traced']}")
    check(not legacy, f"the trace names flash_attention.cu kernels: {legacy}")
    del model
    gc_collect()
    return out


def gc_collect():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase10c(params, smi):
    """Gemma-2B in bf16 (the weights Phase 10b trained) served through
    ``prepare_serving(paged_kernel=True)``: Phase 2's geometry and traffic
    with ``spec_tokens`` 0 and 3, every request token-identical to greedy
    ``generate`` or parting from it at a near tie."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import llama

    cfg = gemma_2b_config(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    rng = np.random.default_rng(11)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=n)) for n in PHASE2_PROMPT_LENS]
    max_new = 32
    fresh_state()
    acc = Accelerator()
    out = {}
    for spec in (0, 3):
        engine = acc.prepare_serving(llama.apply_cached, llama.init_cache, params, cfg,
                                     paged_kernel=True, spec_tokens=spec, **PHASE2_GEOMETRY)
        engine.submit(list(rng.integers(0, cfg.vocab_size, size=40)), 4)  # warm-up
        engine.run()
        engine.pop_finished()
        base = engine.decode_dispatches
        base_s, base_tok = engine.decode_seconds, engine.decode_emitted_tokens
        if spec:
            prompts = [(p[:16] * 64)[:n] for p, n in zip(prompts, PHASE2_PROMPT_LENS)]
        reset_counts()
        done, wall, ids = serve(engine, prompts, max_new, stagger_ticks=3)
        dec, win = read_counts()
        dispatches = engine.decode_dispatches - base
        check(len(done) == len(prompts), f"phase10c spec={spec}: {len(done)} completed")
        per = cfg.num_layers * dispatches
        if spec:
            check(win == per and dec == 0, f"phase10c window kernel launched {win} times, "
                  f"want {per}; decode kernel {dec}")
        else:
            check(dec == per and win == 0, f"phase10c decode kernel launched {dec} times, "
                  f"want {per}; window kernel {win}")
        labels = []
        for rid, p in zip(ids, prompts):
            c = done[rid]
            check(c.status == "ok" and c.new_tokens == max_new, f"phase10c request {rid}: "
                  f"{c.status} with {c.new_tokens} tokens")
            ref = llama.generate(params, torch.tensor([p], device="cuda"), cfg,
                                 max_new_tokens=max_new)[0].tolist()
            labels.append(check_greedy(params, cfg, f"phase10c spec={spec} request {rid}", ref,
                                       c.tokens, len(p)))
        gaps = [x for c in done.values() for x in c.inter_token_ms]
        ttft = median([c.ttft_ms for c in done.values()])
        itl, itl_mean = median(gaps), sum(gaps) / len(gaps)
        decode_tps = (engine.decode_emitted_tokens - base_tok) / (engine.decode_seconds - base_s)
        st = engine.stats()
        log(f"phase10c Gemma-2B bf16 serving spec_tokens={spec}: {len(done)} requests, "
            f"decode_dispatches={dispatches} decode_launches={dec} window_launches={win} "
            f"(head_dim {cfg.head_dim_}) wall_s={wall:.3f} ttft_p50_ms={ttft:.1f} "
            f"itl_p50_ms={itl:.2f} itl_mean_ms={itl_mean:.2f} decode_tokens_per_s="
            f"{decode_tps:.1f} acceptance={st['spec']['acceptance_rate']}; against greedy "
            f"generate: {labels}; {smi}")
        out[spec] = dict(dec=dec, win=win, ttft_p50_ms=ttft, itl_p50_ms=itl,
                         itl_mean_ms=itl_mean, decode_tokens_per_s=decode_tps)
        del engine
        gc_collect()
    return out


def phase10(smi):
    """10a the wide-head kernels, 10b Gemma-2B training, 10c its serving,
    10d Phi-3-mini training."""
    gc_collect()
    t0 = time.perf_counter()
    flash, paged = phase10a(smi)
    t1 = time.perf_counter()
    train, params16 = phase10b(smi)
    t2 = time.perf_counter()
    serving = phase10c(params16, smi)
    del params16
    gc_collect()
    t3 = time.perf_counter()
    phi3 = phase10d(smi)
    log(f"phase10 seconds: 10a {t1 - t0:.1f}, 10b {t2 - t1:.1f}, 10c {t3 - t2:.1f}, 10d "
        f"{time.perf_counter() - t3:.1f}")
    counts = dict(train["counts"], paged_attention=serving[0]["dec"],
                  paged_window_attention=serving[3]["win"])
    return dict(flash=flash, paged=paged, train=train, serving=serving, phi3=phi3,
                counts=counts)


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
    p7 = phase7(smi, p2[0])
    check(p7["paged_attention"] > 0 and p7["paged_window_attention"] > 0,
          f"phase 7 launched the paged kernels {p7} times")
    p8 = phase8(smi)
    check(all(p8[n] > 0 for n in ("paged_attention", "paged_window_attention",
                                  "fused_attention_fwd")),
          f"phase 8 launched the kernels of its path {p8} times")
    p9 = phase9(smi)
    check(all(p9[n] > 0 for n in FLASH_KERNELS),
          f"phase 9 launched the flash kernels {p9} times")
    p10 = phase10(smi)
    check(all(p10["counts"][n] > 0 for n in REPLACES),
          f"phase 10 launched the kernels of its path {p10['counts']} times")
    check(all(p10["phi3"]["counts"][n] > 0 for n in FLASH_KERNELS),
          f"phase 10d launched the flash kernels {p10['phi3']['counts']} times")
    from accelerate_tpu_torch.ops.fused_attention import _HEAD_DIMS as fu_dims
    from accelerate_tpu_torch.ops.paged_attention import _HEAD_DIMS as pa_dims

    log("kernels: paged_attention, paged_window_attention, " + ", ".join(FLASH_KERNELS)
        + f"; head dims: paged {pa_dims}, flash {fu_dims} (fp32 at every head dim on "
        f"{FLASH_SOURCE}; bf16/fp16 at every head dim on {FWD_SOURCE}, {DQ_SOURCE} and "
        f"{DKV_SOURCE})")
    launches = {"paged_attention": p2[0]["dec"], "paged_window_attention": p2[3]["win"], **p5}
    check(win3 > 0, "window kernel not launched in phase 3")
    record = []
    for name in ("paged_attention", "paged_window_attention"):
        r = p1[(name, "torch.bfloat16", "long")]
        serving = p1[(name, "torch.bfloat16", "serving")]
        record.append(dict(name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
                           launches=launches[name], launches_phase7=p7[name],
                           launches_phase8=p8[name], launches_phase9=p9[name],
                           launches_phase10=p10["counts"][name], head_dims=list(pa_dims),
                           wide_heads={f"d{d}-{dt[6:]}": p10["paged"][(name, d, dt)]
                                       for d, dt in ((d, str(t)) for d, t in PHASE10_PAGED)},
                           **r,
                           previous_source=PAGED_PREVIOUS,
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
            # The body each (head dim, dtype) runs: fp32 on flash_attention.cu,
            # bf16/fp16 on the sm90 file.
            wide = {f"d{d}-{dt}": sm90[0] if dt != "float32" else FLASH_SOURCE
                    for d in (96, 256) for dt in ("bfloat16", "float16", "float32")}
            extra = dict(source=sm90[0], previous_source=FLASH_SOURCE, design=sm90[1],
                         dtypes={"bfloat16": sm90[0], "float16": sm90[0],
                                 "float32": FLASH_SOURCE},
                         wide_heads_source=wide)
        record.append(dict(dict(name=name, route="cuda", source=FLASH_SOURCE,
                                replaces=REPLACES[name], launches=launches[name],
                                launches_phase6=p6[name], launches_phase8=p8[name],
                                launches_phase9=p9[name],
                                launches_phase10=p10["counts"][name],
                                launches_phase10d=p10["phi3"]["counts"][name],
                                head_dims=list(fu_dims),
                                wide_heads={f"{geom}-{dt[6:]}": p10["flash"][(geom, dt)][name]
                                            for geom, dt in p10["flash"]},
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
