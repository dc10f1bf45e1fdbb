// Flash-attention dQ backward for Hopper (sm_90a), 16-bit types: wgmma for
// all three products, a TMA-fed K/V ring guarded by mbarriers, dS kept in
// registers.  The fp32 dQ stays on atpu_flash_bwd_dq (flash_attention.cu).
//
// Replaces _bwd_dq_kernel (accelerate_tpu/ops/pallas_attention.py:206,
// launched by _flash_bwd at :338) under the contract of atpu_flash_bwd_dq:
//   q, do, dq [B, S, H, d]; k, v [B, S, KH, d], query head h reads kv head
//   h / (H / KH); lse, delta [B, H, S] fp32; valid [B, S] int8 or null; d 64,
//   128 or 256; bf16 or fp16.  For each query row i of head h and each key j that
//   is admitted (key < S, causal j <= i, valid[j] != 0): s_ij = (q_i . k_j)
//   * scale in fp32, p_ij = exp(s_ij - lse_i) (a masked pair has s = -1e30
//   and is gated to 0), dP_ij = dO_i . v_j in fp32, dS_ij = p_ij (dP_ij -
//   delta_i) scale cast to k's dtype, dQ_i = sum_j dS_ij k_j.  A row with no
//   admitted key gets exactly 0; rows >= S are neither read as live nor
//   written.
//
// Bound on this card.  At the training shape (B 2, S 2048, causal, 32 q over
// 8 kv heads, d 128) the three products are 103.1 GFLOP on ~52 MB: far above
// the ~295 flop/byte ridge, so the least time is flops / 989 TFLOP/s =
// 0.1043 ms (chip_smoke.py computes it from the run's shapes).  The design
// keeps the tensor cores fed:
//
//   - CTA = 128 query rows of one (batch, q head): two consumer warpgroups of
//     64 rows and a producer warpgroup of which one warp works (384 threads,
//     one CTA per SM); setmaxnreg moves registers from the producer (24 a
//     thread) to the consumers (240); the heaviest causal q tiles launch
//     first (q-tile index reversed, grid y), so the last wave is short;
//   - the producer's lane 0 loads the Q and dO tiles once and streams 64-key
//     K and V tiles of kv head h / G (under the causal mask only up to the
//     CTA's last row) into a 3-stage ring with cp.async.bulk.tensor (4-D
//     tensor maps (d, heads, S, B) over the public layout: no transposes,
//     rows past S zero-filled per batch); the producer warp's lanes put the
//     tile's kv_valid bytes and an all-valid flag into the stage, and every
//     lane arrives on the stage's full barrier (lane 0 with expect_tx); each
//     consumer warp releases a stage on its empty barrier after its last
//     wgmma that read it completed;
//   - each consumer thread reads lse * log2(e) and delta of its two rows (g
//     and g + 8 of its warp's 16) once, with plain loads (rows >= S get 0);
//   - S = Q.K^T and dP = dO.V^T are wgmma m64n64k16 with both operands from
//     shared memory, K-major, 128-byte swizzled;
//   - the fp32 accumulators of S and dP have the per-warp layout of
//     mma.sync's (rows g and g + 8 of the warp's 16, pairs of key columns),
//     so dS is formed in place and each k16 chunk packs straight into the A
//     registers of dQ += dS.K, wgmma m64n{d}k16 with B the same K tile read
//     MN-major with the transpose bit: no strip in shared memory and no
//     block barrier in the loop; p = ex2(s * scale * log2(e) - lse *
//     log2(e)), masked per element only on tiles that straddle the causal
//     diagonal, cross S or hold an invalid key (the flag);
//   - a warpgroup skips the tiles wholly after its last row (causal) and
//     every tile when all its rows are past S, releasing them unread;
//   - one CTA owns its rows: no atomics, and the result is deterministic;
//   - the epilogue stages each warpgroup's dQ, cast to T, in its own
//     (consumed) Q rows, XOR-swizzled by 16-byte chunk, and writes 16-byte
//     stores of rows < S.
//
// Shared memory (1024-byte aligned tiles; a 64-column block is 16 KB of 128
// Q/dO rows or 8 KB of 64 K/V rows): d 128 -> Q 32 KB + dO 32 KB + 3 stages
// x (K 16 KB + V 16 KB) = 160 KB; d 64 -> half; plus 3 x 64 bytes of
// kv_valid, the flags and 7 mbarriers; one CTA per SM.  Registers per
// consumer thread (240 after setmaxnreg): d/2 fp32 of dQ, 32 each of S and
// dP, 16 of packed dS; S and dP are declared inside the step and die as dS
// is packed.  ptxas's report (-Xptxas -v, kept beside the library) shows no
// spills.
//
// Head dim 256.  64-key tiles would need Q 64 KB + dO 64 KB + 3 x (32 + 32)
// = 320 KB, and 128 + 32 + 32 + 16 registers a consumer thread, so the K/V
// tile is 32 keys at d 256 (Plan::kBN) in a 2-stage ring: Q 64 KB + dO 64 KB
// + 2 stages x (K 16 KB + V 16 KB) = 192 KB (3 stages fit in 224 KB and
// were timed 0.4% slower on an H100), and per consumer thread dQ 128, S 16,
// dP 16 and packed dS 8 registers.  S and dP are wgmma
// m64n32k16 (16 k-steps); dQ += dS.K is two m64n128k16 halves (K blocks 0-1
// and 2-3) over the same dS registers for each of the tile's two k16 steps,
// which is the register layout of one m64n256k16.  The 128-row CTA, the
// heaviest-first grid, the causal skip, the flag, the epilogue and the
// absence of atomics are those of d 128; each warpgroup still executes only
// the minimum products.  An N = 32 product reads its 64-row A tile from
// shared memory for half the output of an N = 64 one, so at d 256 the
// products read 1.4x the shared-memory bytes per flop of d 128.
//
// Traps, and how each is handled:
//   - K is a B operand twice: K-major for S (stepping 32 bytes per k16
//     inside a 64-column block and 8 KB across blocks) and MN-major for dQ
//     (the block as leading byte offset, 1024 bytes = 8 keys as stride, 2048
//     bytes = 16 keys per k16 step); both address the one swizzled tile;
//   - a row with no admitted key has lse ~ -1e30, and ex2 of its unmasked
//     pairs would overflow: on a tile that does not mask, every pair of the
//     warpgroup's rows is admitted, so no row there is empty and such an lse
//     never meets an unmasked tile; on the tiles that mask, p is selected
//     (not multiplied) to 0, so the row's dQ is exactly 0;
//   - rows past S read zero-filled Q and dO and lse = delta = 0: their dS is
//     0 and they are not stored;
//   - the tensor-map encoder lives in libcuda, not the runtime: fetched once
//     through cudaGetDriverEntryPoint(ByVersion), so no -lcuda; maps are
//     passed as const __grid_constant__ CUtensorMap parameters;
//   - wgmma ordering: wgmma.fence before each batch, commit and wait_group 0
//     before registers are read, an empty compiler fence on every
//     accumulator register around the asynchronous section;
//   - failures surface: a misaligned pointer, a failed attribute set,
//     entry-point lookup, encode or launch returns non-zero and the Python
//     wrapper raises; there is no fallback to another body.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // query rows per CTA: two consumer warpgroups of 64
constexpr int kStages = 3;       // K/V ring depth at d 64 and 128
constexpr int kStagesD256 = 2;   // and at d 256
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 24;   // setmaxnreg: 128 x 24 + 256 x 240 = 384 x 168
constexpr int kConsumerRegs = 240;
constexpr uint32_t kQBlock = kBM * 128;  // one 64-column block of a Q or dO tile, bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kSmemMax = 227 * 1024;

template <int D, int NS>
struct Plan {
  static constexpr int kBN = D == 256 ? 32 : 64;     // keys per streamed K/V tile
  static constexpr uint32_t kv_block = kBN * 128;    // one 64-column block of K or V, bytes
  static constexpr uint32_t q_tile = (D / 64) * kQBlock;    // Q or dO
  static constexpr uint32_t kv_tile = (D / 64) * kv_block;  // K or V of one stage
  static constexpr uint32_t off_do = q_tile;
  static constexpr uint32_t off_k = 2 * q_tile;
  static constexpr uint32_t off_v = off_k + NS * kv_tile;
  static constexpr uint32_t off_mask = off_v + NS * kv_tile;  // kv_valid bytes per stage
  static constexpr uint32_t off_all = off_mask + NS * kBN;    // whole-tile-valid flags
  static constexpr uint32_t off_bar = off_all + NS * 8;       // full[], empty[], q
  static constexpr uint32_t bytes = off_bar + (2 * NS + 1) * 8;
  static constexpr size_t smem = bytes + 1024;  // room to align the base to 1024
  static_assert(smem <= kSmemMax, "dQ tiles exceed shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ----- mbarriers and TMA -----

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// ----- wgmma -----

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins accumulator registers around the asynchronous section, so the
// compiler neither reads nor moves them while a wgmma owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ATPU_REGS32                                                                \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "         \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define ATPU_REGS64                                                                \
  ATPU_REGS32                                                                      \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define ATPU_ACC8(i)                                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),        \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ATPU_REGS16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define ATPU_ACC16 ATPU_ACC8(0), ATPU_ACC8(8)
#define ATPU_ACC32 ATPU_ACC16, ATPU_ACC8(16), ATPU_ACC8(24)
#define ATPU_ACC64 ATPU_ACC32, ATPU_ACC8(32), ATPU_ACC8(40), ATPU_ACC8(48), ATPU_ACC8(56)

// d[N/2] (+)= A[64 x 16] . B[16 x N]: A and B K-major in shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc);
template <typename T>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc);
// d[N/2] += A[64 x 16] . B[16 x N]: A in registers, B MN-major in shared
// memory (transposed).
template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db);
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db);

#define ATPU_WGMMA(TYPE, PTX)                                                                  \
  template <>                                                                                  \
  __device__ __forceinline__ void wgmma_ss_n64<TYPE>(float (&d)[32], uint64_t da, uint64_t db, \
                                                     int acc) {                                \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                  \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " {" ATPU_REGS32    \
                 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                            \
                 : ATPU_ACC32                                                                  \
                 : "l"(da), "l"(db), "r"(acc));                                                \
  }                                                                                            \
  template <>                                                                                  \
  __device__ __forceinline__ void wgmma_ss_n32<TYPE>(float (&d)[16], uint64_t da, uint64_t db, \
                                                     int acc) {                                \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                  \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." PTX "." PTX " {" ATPU_REGS16    \
                 "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                            \
                 : ATPU_ACC16                                                                  \
                 : "l"(da), "l"(db), "r"(acc));                                                \
  }                                                                                            \
  template <>                                                                                  \
  __device__ __forceinline__ void wgmma_rs_n128<TYPE>(float (&d)[64], const uint32_t (&a)[4],  \
                                                      uint64_t db) {                           \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                  \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " {" ATPU_REGS64   \
                 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                              \
                 : ATPU_ACC64                                                                  \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));               \
  }                                                                                            \
  template <>                                                                                  \
  __device__ __forceinline__ void wgmma_rs_n64<TYPE>(float (&d)[32], const uint32_t (&a)[4],   \
                                                     uint64_t db) {                            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                  \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " {" ATPU_REGS32    \
                 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                              \
                 : ATPU_ACC32                                                                  \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));               \
  }

ATPU_WGMMA(__nv_bfloat16, "bf16")
ATPU_WGMMA(__half, "f16")

// d[N/2] (+)= A[64 x 16] . B[16 x N] for the key tile's width N.
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 64) {
    wgmma_ss_n64<T>(d, da, db, acc);
  } else {
    wgmma_ss_n32<T>(d, da, db, acc);
  }
}

// d[D/2] += A[64 x 16] . B[16 x D], B MN-major from a K tile whose 64-column
// blocks lie `block` bytes apart; at d 256 two m64n128k16 halves (blocks 0-1
// into d[0..63], 2-3 into d[64..127]: the register layout of one m64n256k16).
template <typename T, int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint32_t addr,
                                         uint32_t block) {
  if constexpr (D == 256) {
    wgmma_rs_n128<T>(*reinterpret_cast<float(*)[64]>(d), a, desc_sw128(addr, block, 1024));
    wgmma_rs_n128<T>(*reinterpret_cast<float(*)[64]>(d + 64), a,
                     desc_sw128(addr + 2 * block, block, 1024));
  } else if constexpr (D == 128) {
    wgmma_rs_n128<T>(d, a, desc_sw128(addr, block, 1024));
  } else {
    wgmma_rs_n64<T>(d, a, desc_sw128(addr, block, 1024));
  }
}

// ----- small helpers -----

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// dS in place of S (accumulator layout: element 4j + e is query row g + 8
// (e >> 1) of the warp's 16, key column 8j + 2t + (e & 1) of the tile).
// With kMask, a pair is admitted only where the key is below S, valid (vm,
// the tile's kv_valid bytes, or null) and, under the causal mask, at or
// before the row.
template <bool kMask, int NR>
__device__ __forceinline__ void dscores(float (&sc)[NR], const float (&dp)[NR],
                                        const float (&lse2)[2], const float (&dlt)[2], int t,
                                        float scale_log2, float scale, int key0,
                                        const int (&row)[2], int S, int causal,
                                        const uint8_t* vm) {
#pragma unroll
  for (int j = 0; j < NR / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = ex2(sc[4 * j + e] * scale_log2 - lse2[r]);
      if constexpr (kMask) {
        const int c = 8 * j + 2 * t + (e & 1), key = key0 + c;
        const bool ok = key < S && (!causal || key <= row[r]) && (vm == nullptr || vm[c] != 0);
        p = ok ? p : 0.f;
      }
      sc[4 * j + e] = p * (dp[4 * j + e] - dlt[r]) * scale;
    }
}

// ---------------------------------------------------------------------------
// kernel
// ---------------------------------------------------------------------------

template <typename T, int D, int NS>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int8_t* __restrict__ valid, T* __restrict__ dq, int S, int H,
                         int KH, int causal, float scale, float scale_log2) {
  using P = Plan<D, NS>;
  constexpr int kBN = P::kBN;
  constexpr int NA = D / 2;   // dQ accumulator registers per thread
  constexpr int NR = kBN / 2;  // S and dP accumulator registers per thread
  constexpr int CPR = D / 8;  // 16-byte chunks per dQ row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + P::off_bar;  // full[s] = full + 8 s
  const uint32_t empty = full + 8 * NS;
  const uint32_t qbar = empty + 8 * NS;

  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heaviest causal tiles first
  // Keys past the CTA's last row are all causally masked.
  const int kend = causal ? min(S, q0 + kBM) : S;
  const int n_tiles = (kend + kBN - 1) / kBN;
  const int8_t* vld = valid ? valid + static_cast<long long>(b) * S : nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 32);                // every producer lane arrives
      mbar_init(empty + 8 * s, kConsumerWarps);  // one lane per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32 * kConsumerWarps) {
    // ----- producer warpgroup: its first warp loads, the others leave -----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= 32 * kConsumerWarps + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_tx(qbar, 2 * P::q_tile);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sbase + c * kQBlock, &tm_q, 64 * c, h, q0, b, qbar);
        tma_load(sbase + P::off_do + c * kQBlock, &tm_do, 64 * c, h, q0, b, qbar);
      }
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % NS;
      mbar_wait(empty + 8 * s, ((i / NS) & 1) ^ 1);
      const int key0 = i * kBN;
      if (vld) {
        constexpr int KPL = kBN / 32;  // keys per lane: 2, and 1 at d 256
        bool all = true;
#pragma unroll
        for (int e = 0; e < KPL; ++e) {
          const int key = key0 + KPL * lane + e;
          const bool ok = key < S && vld[key] != 0;
          smem[P::off_mask + s * kBN + KPL * lane + e] = ok;
          all = all && ok;
        }
        const int tile_all = __all_sync(0xffffffffu, all);
        if (lane == 0) *reinterpret_cast<int*>(smem + P::off_all + 4 * s) = tile_all;
      }
      if (lane == 0) {
        mbar_arrive_tx(full + 8 * s, 2 * P::kv_tile);
        const uint32_t k_dst = sbase + P::off_k + s * P::kv_tile;
        const uint32_t v_dst = sbase + P::off_v + s * P::kv_tile;
        for (int c = 0; c < D / 64; ++c) {
          tma_load(k_dst + c * P::kv_block, &tm_k, 64 * c, kh, key0, b, full + 8 * s);
          tma_load(v_dst + c * P::kv_block, &tm_v, 64 * c, kh, key0, b, full + 8 * s);
        }
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // ----- consumer warpgroups -----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row_base = q0 + 64 * wg;  // first row of this warpgroup
  const int row[2] = {row_base + 16 * warp + g, row_base + 16 * warp + g + 8};
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = (static_cast<long long>(b) * H + h) * S + row[r];
    lse2[r] = row[r] < S ? lse[at] * kLog2e : 0.f;
    dlt[r] = row[r] < S ? delta[at] : 0.f;
  }
  // The tiles this warpgroup reads: none when all its rows are past S; under
  // the causal mask, those starting at or before its last row.
  const int wg_kend = row_base >= S ? 0 : causal ? min(kend, row_base + 64) : kend;
  const uint32_t q_addr = sbase + 64 * wg * 128;  // this warpgroup's rows of block 0
  const uint32_t do_addr = sbase + P::off_do + 64 * wg * 128;
  const uint8_t* vmask = smem + P::off_mask;
  const int* vall = reinterpret_cast<const int*>(smem + P::off_all);

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % NS;
    const int key0 = i * kBN;
    mbar_wait(full + 8 * s, (i / NS) & 1);
    if (key0 < wg_kend) {
      const uint32_t k_addr = sbase + P::off_k + s * P::kv_tile;
      const uint32_t v_addr = sbase + P::off_v + s * P::kv_tile;

      // S = Q.K^T and dP = dO.V^T over d in k16 steps (32 bytes inside a
      // 64-column block).  Their first step does not read the accumulators
      // (scale-d 0), so they live only inside the step.
      float sc[NR], dp[NR];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint32_t qa = (kd / 4) * kQBlock + (kd % 4) * 32;
        const uint32_t ka = (kd / 4) * P::kv_block + (kd % 4) * 32;
        wgmma_ss<T, kBN>(sc, desc_sw128(q_addr + qa, 16, 1024),
                         desc_sw128(k_addr + ka, 16, 1024), kd > 0);
      }
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint32_t qa = (kd / 4) * kQBlock + (kd % 4) * 32;
        const uint32_t ka = (kd / 4) * P::kv_block + (kd % 4) * 32;
        wgmma_ss<T, kBN>(dp, desc_sw128(do_addr + qa, 16, 1024),
                         desc_sw128(v_addr + ka, 16, 1024), kd > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      fence_regs(dp);

      const bool all_valid = vld == nullptr || vall[s] != 0;
      if ((causal && key0 + kBN - 1 > row_base) || key0 + kBN > S || !all_valid) {
        dscores<true>(sc, dp, lse2, dlt, t, scale_log2, scale, key0, row, S, causal,
                      vld ? vmask + s * kBN : nullptr);
      } else {
        dscores<false>(sc, dp, lse2, dlt, t, scale_log2, scale, key0, row, S, causal, nullptr);
      }

      // k16 chunk kk of dS, in k's dtype = the A registers of the kk-th step
      // of dQ += dS.K.
      uint32_t ds[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2)
          ds[kk][i2] = pack2<T>(sc[8 * kk + 2 * i2], sc[8 * kk + 2 * i2 + 1]);

      // dQ += dS.K over the tile's keys in k16 steps (2048 bytes: 16 rows),
      // K MN-major.
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<T, D>(acc, ds[kk], k_addr + kk * 2048, P::kv_block);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    }
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
  }

  // ----- epilogue -----
  // Stage the warpgroup's 64 x D dQ in its own Q rows (only its own wgmmas
  // read them, and they completed above), 16-byte chunk c of row r at
  // c ^ (r % 8).
  uint8_t* stage = smem + 64 * wg * 128;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = 16 * warp + g + 8 * r;
      const uint32_t at = (j / 8) * kQBlock + rl * 128 + ((j % 8) ^ (rl & 7)) * 16 + 4 * t;
      *reinterpret_cast<uint32_t*>(stage + at) = pack2<T>(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  named_sync(1 + wg, 128);
  for (int c = tid; c < 64 * CPR; c += 128) {
    const int rl = c / CPR, cc = c % CPR, rw = row_base + rl;
    if (rw >= S) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(stage + (cc / 8) * kQBlock + rl * 128 +
                                                      ((cc % 8) ^ (rl & 7)) * 16);
    *reinterpret_cast<uint4*>(dq + ((static_cast<long long>(b) * S + rw) * H + h) * D + cc * 8) =
        val;
  }
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kErrEntryPoint = 999;  // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 1000;     // + the CUresult of a failed encode

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || p == nullptr) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (d, heads, S, B) over a contiguous [B, S, heads, d] tensor, read
// in boxes of 64 columns x `rows` rows of one head, 128-byte swizzled.
int encode(CUtensorMap* map, EncodeTiled enc, CUtensorMapDataType dt, const void* ptr, int d,
           int heads, int S, int B, int rows) {
  const cuuint64_t es = 2;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {d * es, (cuuint64_t)heads * d * es,
                                 (cuuint64_t)S * heads * d * es};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, dt, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *valid;
  void* dq;
  int B, S, H, KH, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int NS>
int run(CUtensorMapDataType dt, const Args& a) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrEntryPoint;
  CUtensorMap tq, tk, tv, tdo;
  int rc = encode(&tq, enc, dt, a.q, D, a.H, a.S, a.B, kBM);
  if (rc == 0) rc = encode(&tk, enc, dt, a.k, D, a.KH, a.S, a.B, Plan<D, NS>::kBN);
  if (rc == 0) rc = encode(&tv, enc, dt, a.v, D, a.KH, a.S, a.B, Plan<D, NS>::kBN);
  if (rc == 0) rc = encode(&tdo, enc, dt, a.dout, D, a.H, a.S, a.B, kBM);
  if (rc != 0) return rc;
  auto kernel = flash_bwd_dq_sm90_kernel<T, D, NS>;
  const size_t smem = Plan<D, NS>::smem;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.H, (a.S + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int8_t*>(a.valid), static_cast<T*>(a.dq), a.S, a.H, a.KH, a.causal,
      a.scale, a.scale * kLog2e);
  return (int)cudaGetLastError();
}

bool bad_args(const Args& a) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                        reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout) |
                        reinterpret_cast<uintptr_t>(a.dq);
  return a.B <= 0 || a.S <= 0 || a.KH <= 0 || a.H % a.KH != 0 || (mis & 15) != 0 ||
         (a.S + kBM - 1) / kBM > 65535;
}

}  // namespace

// dtype 1 bfloat16, 2 float16 (float32 runs atpu_flash_bwd_dq); hd 64, 128
// or 256.  q, do [B, S, H, hd], k/v [B, S, KH, hd], lse/delta [B, H, S] fp32,
// valid [B, S] int8 or null; q, k, v, do, dq 16-byte aligned.  Writes dq
// [B, S, H, hd].  Returns 0, a cudaError_t, 999 if the tensor-map encoder is
// missing, or 1000 + the CUresult of a failed encode.
extern "C" int atpu_flash_bwd_dq_sm90(int dtype, const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* valid, void* dq, int B, int S, int H, int KH,
                                      int hd, int causal, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, valid, dq, B, S, H, KH, causal, scale,
               static_cast<cudaStream_t>(stream)};
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  switch (dtype * 1000 + hd) {
    case 1064: return run<__nv_bfloat16, 64, kStages>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a);
    case 1128: return run<__nv_bfloat16, 128, kStages>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a);
    case 2064: return run<__half, 64, kStages>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, a);
    case 2128: return run<__half, 128, kStages>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, a);
    case 1256: return run<__nv_bfloat16, 256, kStagesD256>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a);
    case 2256: return run<__half, 256, kStagesD256>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same kernel with a 2-stage K/V ring, bf16 and hd 128 only: on no path,
// timed beside the kernel to weigh the ring's depth.  Arguments and returns
// as above.
extern "C" int atpu_flash_bwd_dq_sm90_ring2(int dtype, const void* q, const void* k,
                                            const void* v, const void* dout, const void* lse,
                                            const void* delta, const void* valid, void* dq,
                                            int B, int S, int H, int KH, int hd, int causal,
                                            float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, valid, dq, B, S, H, KH, causal, scale,
               static_cast<cudaStream_t>(stream)};
  if (bad_args(a) || dtype != 1 || hd != 128) return (int)cudaErrorInvalidValue;
  return run<__nv_bfloat16, 128, 2>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a);
}
