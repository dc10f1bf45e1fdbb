#!/usr/bin/env python3
"""Times variants of the fp32 backward kernels on one GPU, in turns.

    python3 flash_f32_variants.py

Each variant is ``accelerate_tpu_torch/ops/csrc/flash_bwd_f32_sm90.cu`` with
a few text substitutions (another tile layout, tile size or stage count),
built with the package's ``nvcc`` flags into ``build/variants/``, held to the
plain backward at fp32's atol = rtol = 1e-4, and timed beside the source as
it ships (``base``) in turns: base, each variant, each again in reverse
order, base.  Shapes: B 2 x S 2048 causal at the four geometries
``chip_smoke.py`` times the fp32 backward at (Phase 4's 32 q / 8 kv heads of
128; Phase 10a's Gemma-2B, Gemma-7B and Phi-3-mini), each call's inputs
L2-cold (copies beyond 100 MB, as ``chip_smoke.cuda_ms`` cycles them).
Prints each variant's registers and spills, one line per geometry and
kernel (mean of its two turns, each turn, the max abs error), and the card's
name and power limit.  It changes nothing in the package.
"""

import ctypes
import math
import os
import subprocess
import sys

import torch

import chip_smoke as c
from accelerate_tpu_torch.ops import _build
from accelerate_tpu_torch.ops import fused_attention as fu

SOURCE = "accelerate_tpu_torch/ops/csrc/flash_bwd_f32_sm90.cu"
OUT = os.path.join("build", "variants")
GEOMETRIES = (("hd128", 32, 8, 128), ("Gemma-2B", 8, 1, 256), ("Gemma-7B", 16, 16, 256),
              ("Phi-3-mini", 32, 32, 96))
SWZ = "__device__ __forceinline__ int swz(int r) { return ((r & 3) << 1) ^ (((r >> 2) & 1) * 3); }"
UNPADDED = [("template <int D>\nconstexpr int LD = D + 4;", "template <int D>\nconstexpr int LD = D;")]
# (old, new) substitutions of each variant.
VARIANTS = {
    # Unpadded rows, 16-byte chunk c of row r at chunk c ^ swz(r): free of
    # bank conflicts both ways, its offsets computed per load.
    "swizzle": [
        ("template <int D>\nconstexpr int LD = D + 4;",
         "template <int D>\nconstexpr int LD = D;\n" + SWZ),
        ("cp_async16(dst + r * LD<D> + 4 * c,", "cp_async16(dst + r * LD<D> + ((c ^ swz(r)) << 2),"),
        ("    split(a0[kk], ab[0], as[0]);  // columns kk + t",
         "    const int sw = swz(g), c0 = ((kk >> 2) ^ sw) << 2, c1 = (((kk >> 2) + 1) ^ sw) << 2;\n"
         "    split(a0[c0], ab[0], as[0]);"),
        ("    split(a1[kk], ab[1], as[1]);", "    split(a1[c0], ab[1], as[1]);"),
        ("    split(a0[kk + 4], ab[2], as[2]);  // columns kk + 4 + t",
         "    split(a0[c1], ab[2], as[2]);"),
        ("    split(a1[kk + 4], ab[3], as[3]);", "    split(a1[c1], ab[3], as[3]);"),
        ("split(b[8 * j * LD<D> + kk], bb[0], bs[0]);", "split(b[8 * j * LD<D> + c0], bb[0], bs[0]);"),
        ("split(b[8 * j * LD<D> + kk + 4], bb[1], bs[1]);",
         "split(b[8 * j * LD<D> + c1], bb[1], bs[1]);"),
        ("const float* b0 = B + (b_row0 + 2 * t) * LD<D> + g;",
         "const float* b0 = B + (b_row0 + 2 * t) * LD<D> + (g & 3);\n"
         "  const int s0 = swz(2 * t), s1 = swz(2 * t + 1);"),
        ("split(b0[8 * j * LD<D> + 8 * n], bb[0], bs[0]);",
         "split(b0[8 * j * LD<D> + (((2 * n + (g >> 2)) ^ s0) << 2)], bb[0], bs[0]);"),
        ("split(b1[8 * j * LD<D> + 8 * n], bb[1], bs[1]);",
         "split(b1[8 * j * LD<D> + (((2 * n + (g >> 2)) ^ s1) << 2)], bb[1], bs[1]);"),
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
        ("    split(a0[kk], ab[0], as[0]);  // columns kk + t\n"
         "    split(a1[kk], ab[1], as[1]);\n"
         "    split(a0[kk + 4], ab[2], as[2]);  // columns kk + 4 + t\n"
         "    split(a1[kk + 4], ab[3], as[3]);",
         "    const float2 x0 = *reinterpret_cast<const float2*>(a0 + kk);\n"
         "    const float2 x1 = *reinterpret_cast<const float2*>(a1 + kk);\n"
         "    split(x0.x, ab[0], as[0]);\n    split(x1.x, ab[1], as[1]);\n"
         "    split(x0.y, ab[2], as[2]);\n    split(x1.y, ab[3], as[3]);"),
        ("      split(b[8 * j * LD<D> + kk], bb[0], bs[0]);\n"
         "      split(b[8 * j * LD<D> + kk + 4], bb[1], bs[1]);",
         "      const float2 y = *reinterpret_cast<const float2*>(b + 8 * j * LD<D> + kk);\n"
         "      split(y.x, bb[0], bs[0]);\n      split(y.y, bb[1], bs[1]);"),
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
}


def build(names):
    """Each variant's source written and built, all ``nvcc``s at once:
    ``{name: ctypes library}``; prints registers and spills per variant."""
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
        used = [line.split("Used ")[1].split(",")[0] for line in log.splitlines() if "Used " in line]
        spills = sorted({line.split(",")[1].strip() for line in log.splitlines()
                         if "spill stores" in line})
        print(f"variant {name}: registers {used}; {spills}", flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        for symbol in ("atpu_flash_bwd_dq_f32_sm90", "atpu_flash_bwd_dkv_f32_sm90"):
            getattr(lib, symbol).argtypes = fu._ARGTYPES[symbol]
            getattr(lib, symbol).restype = ctypes.c_int
        libs[name] = lib
    return libs


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
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(["base", *VARIANTS])
    gen = torch.Generator(device="cuda").manual_seed(2)
    for geom, h, kh, d in GEOMETRIES:
        q, k, v, do, _ = c.flash_inputs(torch.float32, 2, 2048, 0, gen, h=h, kh=kh, d=d)
        out, lse = fu.fused_attention_fwd(q, k, v, causal=True, block_size=512)
        delta = c.attention_delta(out, do)
        want = fu.fused_attention_bwd_plain(q, k, v, out, lse, do, causal=True, block_size=512)
        set_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, do))
        copies = [(q, k, v, do, lse, delta)] + [
            tuple(t.clone() for t in (q, k, v, do, lse, delta))
            for _ in range(math.ceil(100e6 / set_bytes) - 1)]
        for kernel, fn, ref in (("dQ", dq, want[:1]), ("dK/dV", dkv, want[1:])):
            errs = {}
            for name, lib in libs.items():
                got = fn(lib, q, k, v, do, lse, delta)
                torch.cuda.synchronize()
                errs[name] = max((g - w).abs().max().item() for g, w in zip(got, ref))
                c.check(all(torch.allclose(g, w, atol=1e-4, rtol=1e-4) for g, w in zip(got, ref)),
                        f"{geom} {kernel} variant {name}: max abs err {errs[name]}")
            times = {name: [] for name in libs}
            for name in list(libs) + list(libs)[::-1]:
                times[name].append(c.cuda_ms(lambda *a, lib=libs[name]: fn(lib, *a), copies,
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
