#!/usr/bin/env python3
"""Times variants of the fp32 flash kernels on one GPU, in turns.

    python3 flash_f32_variants.py [VARIANT ...]

Each variant is ``accelerate_tpu_torch/ops/csrc/flash_f32_sm90.cu`` with a
few text substitutions (another tile layout, tile size, stage count or
split of the operands), built with the package's ``nvcc`` flags into
``build/variants/``, held to the plain forward or backward at fp32's atol =
rtol = 1e-4, and timed beside the source as it ships (``base``) in turns:
base, each variant, each again in reverse order, base.  A variant names the
kernels it changes (forward, dQ, dK/dV) and is timed on those alone; with
names on the command line only those variants run.  Shapes: B 2 x S 2048
causal at the four geometries ``chip_smoke.py`` times the fp32 kernels at
(Phase 4's 32 q / 8 kv heads of 128; Phase 10a's Gemma-2B, Gemma-7B and
Phi-3-mini), each call's inputs L2-cold (copies beyond 100 MB, as
``chip_smoke.cuda_ms`` cycles them).  Prints each variant's registers and
spills per kernel, one line per geometry and kernel (mean of its two turns,
each turn, the max abs error), and the card's name and power limit.  It
changes nothing in the package.
"""

import ctypes
import math
import os
import re
import subprocess
import sys

import torch

import chip_smoke as c
from accelerate_tpu_torch.ops import _build
from accelerate_tpu_torch.ops import fused_attention as fu

SOURCE = "accelerate_tpu_torch/ops/csrc/flash_f32_sm90.cu"
OUT = os.path.join("build", "variants")
GEOMETRIES = (("hd128", 32, 8, 128), ("Gemma-2B", 8, 1, 256), ("Gemma-7B", 16, 16, 256),
              ("Phi-3-mini", 32, 32, 96))
SWZ = "__device__ __forceinline__ int swz(int r) { return ((r & 3) << 1) ^ (((r >> 2) & 1) * 3); }"
UNPADDED = [("template <int D>\nconstexpr int LD = D + 4;", "template <int D>\nconstexpr int LD = D;")]
# The forward plan's key tile and stages, as the source ships them.
FWD_TK = "static constexpr int TK = D <= 128 ? 64 : 32;     // keys a K/V tile"
FWD_STAGES = "static constexpr int STAGES = D <= 96 ? 3 : 2;"
# warp_nt / warp_pv reading B's big and small TF32 planes (kPre), the pass
# that splits a landed tile into them, and the forward running it once a
# tile into planes after the ring.
PRESPLIT = [
    ("template <int NT, int D, bool kTrunc = false>\n__device__ __forceinline__ void warp_nt("
     "float (&c)[NT][4], const float* A, int a_row0,\n                                        "
     "const float* B, int b_row0) {",
     "template <int NT, int D, bool kTrunc = false, bool kPre = false>\n"
     "__device__ __forceinline__ void warp_nt("
     "float (&c)[NT][4], const float* A, int a_row0,\n    const float* B, int b_row0, "
     "const float* Bs = nullptr) {"),
    ("  const float* b = B + (b_row0 + g) * LD<D> + t;\n",
     "  const float* b = B + (b_row0 + g) * LD<D> + t;\n"
     "  const float* bsm = kPre ? Bs + (b_row0 + g) * LD<D> + t : nullptr;\n"),
    ("      split<kTrunc>(b[8 * j * LD<D> + kk], bb[0], bs[0]);\n"
     "      split<kTrunc>(b[8 * j * LD<D> + kk + 4], bb[1], bs[1]);",
     "      if constexpr (kPre) {\n"
     "        load_planes(b, bsm, 8 * j * LD<D> + kk, bb[0], bs[0]);\n"
     "        load_planes(b, bsm, 8 * j * LD<D> + kk + 4, bb[1], bs[1]);\n"
     "      } else {\n"
     "        split<kTrunc>(b[8 * j * LD<D> + kk], bb[0], bs[0]);\n"
     "        split<kTrunc>(b[8 * j * LD<D> + kk + 4], bb[1], bs[1]);\n"
     "      }"),
    ("template <int NK, int D, bool kTrunc = false>\n__device__ __forceinline__ void warp_pv("
     "float (&c)[D / 8][4], const float (&p)[NK][4],\n                                        "
     "const float* B, int b_row0) {",
     "template <int NK, int D, bool kTrunc = false, bool kPre = false>\n"
     "__device__ __forceinline__ void warp_pv("
     "float (&c)[D / 8][4], const float (&p)[NK][4],\n    const float* B, int b_row0, "
     "const float* Bs = nullptr) {"),
    ("  const float* b1 = b0 + LD<D>;                         // rows 8j + 2t + 1\n",
     "  const float* b1 = b0 + LD<D>;                         // rows 8j + 2t + 1\n"
     "  const float* s0 = kPre ? Bs + (b_row0 + 2 * t) * LD<D> + g : nullptr;\n"),
    ("      split<kTrunc>(b0[8 * j * LD<D> + 8 * n], bb[0], bs[0]);\n"
     "      split<kTrunc>(b1[8 * j * LD<D> + 8 * n], bb[1], bs[1]);",
     "      if constexpr (kPre) {\n"
     "        load_planes(b0, s0, 8 * j * LD<D> + 8 * n, bb[0], bs[0]);\n"
     "        load_planes(b1, s0 + LD<D>, 8 * j * LD<D> + 8 * n, bb[1], bs[1]);\n"
     "      } else {\n"
     "        split<kTrunc>(b0[8 * j * LD<D> + 8 * n], bb[0], bs[0]);\n"
     "        split<kTrunc>(b1[8 * j * LD<D> + 8 * n], bb[1], bs[1]);\n"
     "      }"),
    ("__device__ __forceinline__ void mma_tf32(",
     "__device__ __forceinline__ void load_planes(const float* big, const float* small, int at,\n"
     "                                            uint32_t& b, uint32_t& s) {\n"
     "  b = __float_as_uint(big[at]);\n  s = __float_as_uint(small[at]);\n}\n\n"
     "template <int D, int NT>\n"
     "__device__ __forceinline__ void split_tile(float* big, float* small, const float* src, "
     "int rows) {\n"
     "  constexpr int CPR = D / 4;\n"
     "  for (int i = threadIdx.x; i < rows * CPR; i += NT) {\n"
     "    const int at = (i / CPR) * LD<D> + 4 * (i % CPR);\n"
     "    const float4 x = *reinterpret_cast<const float4*>(src + at);\n"
     "    uint4 b, s;\n"
     "    split<true>(x.x, b.x, s.x);\n    split<true>(x.y, b.y, s.y);\n"
     "    split<true>(x.z, b.z, s.z);\n    split<true>(x.w, b.w, s.w);\n"
     "    *reinterpret_cast<uint4*>(big + at) = b;\n"
     "    *reinterpret_cast<uint4*>(small + at) = s;\n  }\n}\n\n"
     "__device__ __forceinline__ void mma_tf32("),
    ("  static constexpr size_t smem = (q_floats + STAGES * stage_floats) * sizeof(float);\n"
     "  // A group's second warp",
     "  static constexpr size_t smem = (q_floats + (STAGES + 2) * stage_floats) * sizeof(float);\n"
     "  // A group's second warp"),
    ("GROUPS * merge_floats <= STAGES * stage_floats),",
     "GROUPS * merge_floats <= (STAGES + 2) * stage_floats),"),
    ("    const float* vt = kt + P::TK * LD<D>;\n    const int key0 = i * P::TK + kr0;\n"
     "    // A warp whose keys all lie past S, or causally past its last row, adds\n",
     "    const float* planes_b = kv_s + P::STAGES * P::stage_floats;\n"
     "    split_tile<D, NT>(kv_s + P::STAGES * P::stage_floats,\n"
     "                      kv_s + (P::STAGES + 1) * P::stage_floats, kt, 2 * P::TK);\n"
     "    __syncthreads();\n"
     "    kt = planes_b;\n"
     "    const float* ks_t = planes_b + P::stage_floats;\n"
     "    const float* vs_t = ks_t + P::TK * LD<D>;\n"
     "    const float* vt = kt + P::TK * LD<D>;\n    const int key0 = i * P::TK + kr0;\n"
     "    // A warp whose keys all lie past S, or causally past its last row, adds\n"),
    ("      warp_nt<P::NS, D, P::TRUNC>(s, q_s, 16 * rg, kt, kr0);  // S = Q.K^T",
     "      warp_nt<P::NS, D, P::TRUNC, true>(s, q_s, 16 * rg, kt, kr0, ks_t);"),
    ("      warp_pv<P::NS, D, P::TRUNC>(o, s, vt, kr0);  // O += P.V",
     "      warp_pv<P::NS, D, P::TRUNC, true>(o, s, vt, kr0, vs_t);"),
]
# (old, new) substitutions of each variant.
VARIANTS = {
    # Unpadded rows, 16-byte chunk c of row r at chunk c ^ swz(r): free of
    # bank conflicts both ways, its offsets computed per load.
    "swizzle": [
        ("template <int D>\nconstexpr int LD = D + 4;",
         "template <int D>\nconstexpr int LD = D;\n" + SWZ),
        ("cp_async16(dst + r * LD<D> + 4 * c,", "cp_async16(dst + r * LD<D> + ((c ^ swz(r)) << 2),"),
        ("    split<kTrunc>(a0[kk], ab[0], as[0]);  // columns kk + t",
         "    const int sw = swz(g), c0 = ((kk >> 2) ^ sw) << 2, c1 = (((kk >> 2) + 1) ^ sw) << 2;\n"
         "    split<kTrunc>(a0[c0], ab[0], as[0]);"),
        ("    split<kTrunc>(a1[kk], ab[1], as[1]);", "    split<kTrunc>(a1[c0], ab[1], as[1]);"),
        ("    split<kTrunc>(a0[kk + 4], ab[2], as[2]);  // columns kk + 4 + t",
         "    split<kTrunc>(a0[c1], ab[2], as[2]);"),
        ("    split<kTrunc>(a1[kk + 4], ab[3], as[3]);",
         "    split<kTrunc>(a1[c1], ab[3], as[3]);"),
        ("split<kTrunc>(b[8 * j * LD<D> + kk], bb[0], bs[0]);",
         "split<kTrunc>(b[8 * j * LD<D> + c0], bb[0], bs[0]);"),
        ("split<kTrunc>(b[8 * j * LD<D> + kk + 4], bb[1], bs[1]);",
         "split<kTrunc>(b[8 * j * LD<D> + c1], bb[1], bs[1]);"),
        ("const float* b0 = B + (b_row0 + 2 * t) * LD<D> + g;",
         "const float* b0 = B + (b_row0 + 2 * t) * LD<D> + (g & 3);\n"
         "  const int s0 = swz(2 * t), s1 = swz(2 * t + 1);"),
        ("split<kTrunc>(b0[8 * j * LD<D> + 8 * n], bb[0], bs[0]);",
         "split<kTrunc>(b0[8 * j * LD<D> + (((2 * n + (g >> 2)) ^ s0) << 2)], bb[0], bs[0]);"),
        ("split<kTrunc>(b1[8 * j * LD<D> + 8 * n], bb[1], bs[1]);",
         "split<kTrunc>(b1[8 * j * LD<D> + (((2 * n + (g >> 2)) ^ s1) << 2)], bb[1], bs[1]);"),
    ],
    # Unpadded, unswizzled rows: 8 lanes to a bank.
    "unpadded": UNPADDED,
    # warp_nt's k-slots t, t + 4 as columns 2t, 2t + 1: one 8-byte load a row
    # (2-way conflicts at the 4-float pad).
    "float2": [
        ("const float* a0 = A + (a_row0 + g) * LD<D> + t;",
         "const float* a0 = A + (a_row0 + g) * LD<D> + 2 * t;"),
        ("const float* b = B + (b_row0 + g) * LD<D> + t;",
         "const float* b = B + (b_row0 + g) * LD<D> + 2 * t;"),
        ("    split<kTrunc>(a0[kk], ab[0], as[0]);  // columns kk + t\n"
         "    split<kTrunc>(a1[kk], ab[1], as[1]);\n"
         "    split<kTrunc>(a0[kk + 4], ab[2], as[2]);  // columns kk + 4 + t\n"
         "    split<kTrunc>(a1[kk + 4], ab[3], as[3]);",
         "    const float2 x0 = *reinterpret_cast<const float2*>(a0 + kk);\n"
         "    const float2 x1 = *reinterpret_cast<const float2*>(a1 + kk);\n"
         "    split<kTrunc>(x0.x, ab[0], as[0]);\n    split<kTrunc>(x1.x, ab[1], as[1]);\n"
         "    split<kTrunc>(x0.y, ab[2], as[2]);\n    split<kTrunc>(x1.y, ab[3], as[3]);"),
        ("      split<kTrunc>(b[8 * j * LD<D> + kk], bb[0], bs[0]);\n"
         "      split<kTrunc>(b[8 * j * LD<D> + kk + 4], bb[1], bs[1]);",
         "      const float2 y = *reinterpret_cast<const float2*>(b + 8 * j * LD<D> + kk);\n"
         "      split<kTrunc>(y.x, bb[0], bs[0]);\n      split<kTrunc>(y.y, bb[1], bs[1]);"),
    ],
    # dK/dV at d 128 on 64-row Q/dO tiles in 2 stages.
    "dkv_d128_tq64": [
        ("static constexpr int TQ = D <= 96 ? 64 : D == 128 ? 32 : 16;",
         "static constexpr int TQ = D <= 128 ? 64 : 16;"),
        ("static constexpr int STAGES = D <= 128 ? 3 : 2;\n  static constexpr int NQ",
         "static constexpr int STAGES = D <= 96 ? 3 : 2;\n  static constexpr int NQ"),
    ],
    # dK/dV at d 96 on 32-row Q/dO tiles in 3 stages.
    "dkv_d96_tq32": [
        ("static constexpr int TQ = D <= 96 ? 64 : D == 128 ? 32 : 16;",
         "static constexpr int TQ = D <= 64 ? 64 : D <= 128 ? 32 : 16;"),
    ],
    # dK/dV at d 256 on 32-row Q/dO tiles, single-buffered.
    "dkv_d256_tq32": [
        ("static constexpr int TQ = D <= 96 ? 64 : D == 128 ? 32 : 16;",
         "static constexpr int TQ = D <= 96 ? 64 : 32;"),
        ("static constexpr int STAGES = D <= 128 ? 3 : 2;\n  static constexpr int NQ",
         "static constexpr int STAGES = D <= 128 ? 3 : 1;\n  static constexpr int NQ"),
    ],
    # dQ at d 256 on 16-key K/V tiles in a 2-stage ring.
    "dq_d256_tk16": [
        ("static constexpr int TK = D <= 96 ? 64 : 32;",
         "static constexpr int TK = D <= 96 ? 64 : D == 128 ? 32 : 16;"),
        ("static constexpr int STAGES = D == 64 ? 3 : D == 256 ? 1 : 2;",
         "static constexpr int STAGES = D == 64 ? 3 : 2;"),
    ],
    # The forward at d 128 on 32-key K/V tiles in 3 stages.
    "fwd_d128_tk32": [
        (FWD_TK, "static constexpr int TK = D <= 96 ? 64 : 32;"),
        (FWD_STAGES, "static constexpr int STAGES = D <= 128 ? 3 : 2;"),
    ],
    # The forward at d 96 on 32-key K/V tiles in 3 stages.
    "fwd_d96_tk32": [(FWD_TK, "static constexpr int TK = D == 96 || D == 256 ? 32 : 64;")],
    # The forward at d 96 in a 2-stage ring.
    "fwd_d96_stages2": [(FWD_STAGES, "static constexpr int STAGES = D <= 64 ? 3 : 2;")],
    # The forward at d 256 on 64-row CTAs of 4 warps, one a row group, each
    # on the 32 keys of a tile (no merge).
    "fwd_d256_warps4": [("static constexpr int WARPS = kWarps;",
                         "static constexpr int WARPS = D == 256 ? 4 : kWarps;")],
    # The forward at d 256 on 128-row CTAs, one warp a row group, over
    # 16-key tiles in 2 stages (no merge).
    "fwd_d256_rows128": [
        ("static constexpr int WARPS = kWarps;\n"
         "  static constexpr int ROWS = D <= 128 ? 128 : 64;  // query rows of a CTA",
         "static constexpr int WARPS = kWarps;\n  static constexpr int ROWS = 128;"),
        (FWD_TK, "static constexpr int TK = D <= 128 ? 64 : 16;"),
    ],
    # The forward at d 256 with one chain of the score product per 8-key
    # block (2 in all) in place of 4 (dQ and dK/dV at d 256 change too; only
    # the forward is timed).
    "fwd_d256_kc1": [("constexpr int KC = NT >= 4 ? 1 : 4 / NT;",
                      "constexpr int KC = NT >= 4 || D == 256 ? 1 : 4 / NT;")],
    # Each landed K/V tile split once into TF32 planes (split_tile) that all
    # warps read, in place of every warp splitting what it loads: twice the
    # tile's shared memory, so 32-key tiles at d 96 and 128 and 16-key at
    # d 256.
    "fwd_presplit": PRESPLIT + [
        (FWD_TK, "static constexpr int TK = D <= 64 ? 64 : D <= 128 ? 32 : 16;")],
    # The forward's exponentials as expf(s - m), in place of exp2f of (s -
    # m) log2(e) with -m log2(e) kept per row.
    "fwd_expf": [
        ("        alpha[r] = exp2f((m_run[r] - m_new) * kLog2e);\n"
         "        mneg[r] = -m_new * kLog2e;\n",
         "        alpha[r] = expf(m_run[r] - m_new);\n        mneg[r] = m_new;\n"),
        ("exp2f(fmaf(s[j][e], kLog2e, mneg[r]))", "expf(s[j][e] - mneg[r])"),
        ("      a0[r] = exp2f((m_run[r] - m) * kLog2e);\n"
         "      a1[r] = exp2f((m1 - m) * kLog2e);",
         "      a0[r] = expf(m_run[r] - m);\n      a1[r] = expf(m1 - m);"),
    ],
    # The forward's operands split with big rounded to nearest (split), as
    # dQ's and dK/dV's, in place of big = x read truncated.
    "fwd_split_rn": [("static constexpr bool TRUNC = true;",
                      "static constexpr bool TRUNC = false;")],
    # dQ's and dK/dV's operands split as the forward's: big = x, which the
    # tensor core reads truncated to TF32, and small = x - trunc(x).
    "bwd_split_trunc": [
        ("template <int NT, int D, bool kTrunc = false>",
         "template <int NT, int D, bool kTrunc = true>"),
        ("template <int NK, int D, bool kTrunc = false>",
         "template <int NK, int D, bool kTrunc = true>"),
    ],
}
# The kernels each variant changes (the others are timed only in base).
KERNELS = {name: ("fwd",) if name.startswith("fwd_") else ("dQ", "dK/dV") for name in VARIANTS}


def report(log):
    """Registers and spill stores of each kernel in a ptxas report, as
    ``name<D> N regs, M B spilled``."""
    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '[^']*?\d+(flash_\w+?_kernel)(?:ILi(\d+)E)?",
                          line)
        if entry:
            name = entry.group(1) + (f"<{entry.group(2)}>" if entry.group(2) else "")
        elif "spill stores" in line and name:
            spill = line.split(",")[1].split("bytes")[0].strip()
        elif "Used " in line and name:
            out.append(f"{name} {line.split('Used ')[1].split(' ')[0]} regs, {spill} B spilled")
            name = None
    return out


def build(names):
    """Each variant's source written and built, all ``nvcc``s at once:
    ``{name: ctypes library}``; prints registers and spills per kernel."""
    text = open(SOURCE).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        src = text
        for old, new in VARIANTS.get(name, []):
            if src.count(old) != 1:
                raise SystemExit(f"variant {name}: {old[:60]!r} not found once in {SOURCE}")
            src = src.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log[-3000:]}")
        print(f"variant {name}: " + "; ".join(report(log)), flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        for symbol in ("atpu_flash_fwd_f32_sm90", "atpu_flash_bwd_dq_f32_sm90",
                       "atpu_flash_bwd_dkv_f32_sm90"):
            getattr(lib, symbol).argtypes = fu._ARGTYPES[symbol]
            getattr(lib, symbol).restype = ctypes.c_int
        libs[name] = lib
    return libs


def fwd(lib, q, k, v, do, lse, delta):
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device="cuda")
    rc = lib.atpu_flash_fwd_f32_sm90(
        0, q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(), lse.data_ptr(), b, s,
        h, k.shape[2], d, 1, 1 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"forward variant failed: CUDA error {rc}")
    return out, lse


def dq(lib, q, k, v, do, lse, delta):
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    rc = lib.atpu_flash_bwd_dq_f32_sm90(
        0, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), None, out.data_ptr(), b, s, h, k.shape[2], d, 1, 1 / math.sqrt(d),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"dQ variant failed: CUDA error {rc}")
    return (out,)


def dkv(lib, q, k, v, do, lse, delta):
    b, s, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    n = fu.pick_dkv_split(b, k.shape[2], s, h // k.shape[2], fu._sm_count(q.device))
    part = torch.empty(2 * n * k.numel(), dtype=torch.float32, device="cuda") if n > 1 else None
    rc = lib.atpu_flash_bwd_dkv_f32_sm90(
        0, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), None, dk.data_ptr(), dv.data_ptr(),
        None if part is None else part.data_ptr(), b, s, h, k.shape[2], d, 1, n,
        1 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"dK/dV variant failed: CUDA error {rc}")
    return dk, dv


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_f32_variants: CUDA is not available", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"flash_f32_variants: unknown variants {unknown}; known: {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(["base", *names])
    gen = torch.Generator(device="cuda").manual_seed(2)
    for geom, h, kh, d in GEOMETRIES:
        q, k, v, do, _ = c.flash_inputs(torch.float32, 2, 2048, 0, gen, h=h, kh=kh, d=d)
        out, lse = fu.fused_attention_fwd_plain(q, k, v, causal=True, block_size=512)
        delta = c.attention_delta(out, do)
        want = fu.fused_attention_bwd_plain(q, k, v, out, lse, do, causal=True, block_size=512)
        set_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, do))
        copies = [(q, k, v, do, lse, delta)] + [
            tuple(t.clone() for t in (q, k, v, do, lse, delta))
            for _ in range(math.ceil(100e6 / set_bytes) - 1)]
        for kernel, fn, ref in (("fwd", fwd, (out, lse)), ("dQ", dq, want[:1]),
                                ("dK/dV", dkv, want[1:])):
            timed = {name: lib for name, lib in libs.items()
                     if name == "base" or kernel in KERNELS[name]}
            if len(timed) == 1:
                continue
            errs = {}
            for name, lib in timed.items():
                got = fn(lib, q, k, v, do, lse, delta)
                torch.cuda.synchronize()
                errs[name] = max((g - w).abs().max().item() for g, w in zip(got, ref))
                c.check(all(torch.allclose(g, w, atol=1e-4, rtol=1e-4) for g, w in zip(got, ref)),
                        f"{geom} {kernel} variant {name}: max abs err {errs[name]}")
            times = {name: [] for name in timed}
            for name in list(timed) + list(timed)[::-1]:
                times[name].append(c.cuda_ms(lambda *a, lib=timed[name]: fn(lib, *a), copies,
                                             iters=10))
            print(f"{geom} H={h} K={kh} d={d} {kernel} ms: " + "; ".join(
                f"{name} {sum(t) / 2:.4f} ({t[0]:.4f}, {t[1]:.4f}; err {errs[name]:.2e})"
                for name, t in times.items()), flush=True)
        del q, k, v, do, out, lse, delta, want, copies
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
