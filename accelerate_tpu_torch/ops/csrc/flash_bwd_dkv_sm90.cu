// Flash-attention dK/dV backward for Hopper (sm_90a), 16-bit types: wgmma
// for all four products, a TMA-fed Q/dO ring guarded by mbarriers, P^T and
// dS^T kept in registers.  The fp32 dK/dV stays on atpu_flash_bwd_dkv
// (flash_attention.cu).
//
// Replaces _bwd_dkv_kernel (accelerate_tpu/ops/pallas_attention.py:258,
// launched by _flash_bwd at :361) with the GQA group sum of :388 folded in,
// under the contract of atpu_flash_bwd_dkv:
//   q, do [B, S, H, d]; k, v, dk, dv [B, S, KH, d]; lse, delta [B, H, S]
//   fp32; valid [B, S] int8 or null; d 64, 128 or 256; bf16 or fp16.  For
//   each key j of kv head kh, summed over its G query heads and every
//   admitted query i (key < S, causal i >= j, valid[j] != 0): p_ij =
//   exp(s_ij - lse_i) with s_ij = (q_i . k_j) * scale in fp32, dV_j = sum_i
//   p_ij dO_i with p kept in fp32 (dO is fp32 in the TPU kernel), dS_ij =
//   p_ij (dP_ij - delta_i) scale with dP_ij = dO_i . v_j, cast to q's dtype,
//   dK_j = sum_i dS_ij q_i.  Key rows with valid == 0 get exactly 0; rows >=
//   S are neither read as live nor written.
//
// Bound on this card.  At the training shape (B 2, S 2048, causal, 32 q over
// 8 kv heads, d 128) the four products are 137.5 GFLOP on ~70 MB: far above
// the ~295 flop/byte ridge, so the least time is flops / 989 TFLOP/s = 0.1390
// ms (chip_smoke.py computes it from the run's shapes).  The split dV product
// below adds a fifth (171.9 GFLOP).  The design keeps the tensor cores fed:
//
//   - CTA = 128 keys of one (batch, kv head): two consumer warpgroups of 64
//     key rows and a producer warpgroup of which one warp works (384
//     threads, one CTA per SM); setmaxnreg moves registers from the producer
//     (24 a thread) to the consumers (240);
//   - the producer's lane 0 loads the K and V tiles once and streams 64-row
//     Q and dO tiles of the group's query heads (head-major; under the causal
//     mask from the first q tile that reaches the CTA's first key) into a
//     3-stage ring with cp.async.bulk.tensor (4-D tensor maps (d, heads, S,
//     B) over the public layout: no transposes, rows past S zero-filled per
//     batch); the producer warp's lanes put lse * log2(e) and delta of the
//     tile's rows into the stage with plain loads (a [B, H, S] row is not
//     16-byte aligned unless S % 4 == 0, so TMA cannot take it; rows past S
//     get 0) and every lane arrives on the stage's full barrier (lane 0 with
//     expect_tx); each consumer warp releases a stage on its empty barrier
//     after its last wgmma that read it completed;
//   - S^T = K.Q^T and dP^T = V.dO^T are wgmma m64n64k16 with both operands
//     from shared memory, K-major, 128-byte swizzled;
//   - the fp32 accumulators of S^T and dP^T have the per-warp layout of
//     mma.sync's (rows g and g + 8 of the warp's 16 keys, pairs of query
//     columns), so P^T and dS^T are formed in place and each k16 chunk packs
//     straight into the A registers of the next products: no strip in shared
//     memory and no block barrier in the loop; p = ex2(s * scale * log2(e) -
//     lse * log2(e)), gated per element only on tiles that straddle the
//     causal diagonal or cross S (q >= S is masked explicitly, not left to
//     the zero-filled rows);
//   - dV += P^T.dO and dK += dS^T.Q are wgmma m64n{d}k16 with A from
//     registers and B the same Q/dO tiles read MN-major with the transpose
//     bit; dV keeps fp32 P as hi + lo, two products of the operand type
//     (~16 bits of p instead of 8 in bf16 or 11 in fp16);
//   - a key's row only ever meets its own row of P^T and dS^T, so kv_valid
//     needs no per-element mask: an invalid key's row is written as 0 by the
//     epilogue, and a CTA whose keys are all invalid (or past S) writes zeros
//     and loads nothing;
//   - one CTA owns its keys across all G query heads: no atomics, and the
//     result is deterministic;
//   - the epilogue stages each warpgroup's dK and dV in its own (consumed) K
//     and V rows, XOR-swizzled by 16-byte chunk, and writes 16-byte stores of
//     rows < S; the lowest key tiles, which hold the most q tiles under the
//     causal mask, launch first (key tile = grid y).
//
// Shared memory (1024-byte aligned tiles; a 64-column block is 16 KB of 128
// K/V rows or 8 KB of 64 Q/dO rows): d 128 -> K 32 KB + V 32 KB + 3 stages x
// (Q 16 KB + dO 16 KB + 512 bytes of lse and delta) = 161.5 KB; d 64 -> half;
// plus 7 mbarriers; one CTA per SM.  Registers per consumer thread (240 after
// setmaxnreg): d/2 fp32 each of dK and dV, 32 each of S^T and dP^T, 16 each
// of packed P hi, P lo and dS; S^T and dP^T die as they are packed.  ptxas's
// report (-Xptxas -v, kept beside the library) shows no spills.
//
// Head dim 256 (flash_bwd_dkv_sm90_d256_kernel).  The design above does not
// instantiate there: d/2 = 128 fp32 each of dK and dV a thread is 256
// registers, over setmaxnreg's 240, and K + V 128 KB plus 3 stages of 64 KB
// of Q/dO is 320 KB, over 227.  So:
//   - CTA = 64 keys; the two consumer warpgroups split dK/dV's columns, 128
//     each, and each recomputes the same 64 x 64 S^T = K.Q^T and dP^T =
//     V.dO^T over the full d (wgmma m64n64k16, 16 k16 steps).  A thread then
//     holds what it holds at d 128: 64 + 64 accumulators, 32 + 32 of S^T and
//     dP^T, 16 each of packed P hi, P lo and dS.  The products are 1.5x the
//     minimum (1.75x with the lo half); chip_smoke.py's bound counts the
//     minimum;
//   - dV += P^T.dO[:, c] and dK += dS^T.Q[:, c] are m64n128k16 over the
//     warpgroup's two 64-column blocks of the tile (c = 128 wg ..);
//   - shared memory: K + V 64 KB, 2 stages x (Q 32 KB + dO 32 KB), lse and
//     delta: 193 KB;
//   - filling the card: Gemma-2B's one kv head gives B x KH x S/64 = 64 CTAs
//     for 132 SMs, so the G query heads of a kv head are split over n_split
//     CTAs (chosen on the host from shapes, fused_attention.pick_dkv_split).
//     With n_split > 1 each CTA writes fp32 partials [n_split, B, S, KH, d]
//     into a workspace the wrapper allocates, and flash_bwd_dkv_sum_kernel
//     adds them in split order and casts to k's dtype: per-query-head fp32
//     results summed outside, as the reference does (pallas_attention.py:
//     388), and deterministic.  With n_split = 1 the CTA writes dK/dV in
//     k's dtype as the d-128 kernel does (staged in K and V after a barrier
//     of both warpgroups, which both read all of K and V).
//
// Traps, and how each is handled:
//   - Q and dO are B operands twice: K-major for S^T and dP^T (stepping 32
//     bytes per k16 inside a 64-column block and 8 KB across blocks) and
//     MN-major for dK and dV (the block as leading byte offset, 1024 bytes =
//     8 rows as stride, 2048 bytes = 16 rows per k16 step); both address the
//     one swizzled tile;
//   - a row with no admitted key has lse ~ -1e30; its pairs are gated to 0
//     on the tiles that mask, and on a tile that does not mask they meet only
//     invalid keys, whose rows the epilogue overwrites with 0;
//   - the tensor-map encoder lives in libcuda, not the runtime: fetched once through
//     cudaGetDriverEntryPoint(ByVersion), so no -lcuda; maps are passed as
//     const __grid_constant__ CUtensorMap parameters;
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

#include <algorithm>

namespace {

constexpr int kBK = 128;  // keys per CTA: two consumer warpgroups of 64
constexpr int kBQ = 64;   // query rows per streamed Q/dO tile
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 24;   // setmaxnreg: 128 x 24 + 256 x 240 = 384 x 168
constexpr int kConsumerRegs = 240;
constexpr uint32_t kKBlock = kBK * 128;  // one 64-column block of a K or V tile, bytes
constexpr uint32_t kQBlock = kBQ * 128;  // one 64-column block of a Q or dO tile, bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kSmemMax = 227 * 1024;

template <int D>
struct Plan {
  static constexpr uint32_t kv_tile = (D / 64) * kKBlock;  // K or V
  static constexpr uint32_t q_tile = (D / 64) * kQBlock;   // Q or dO of one stage
  static constexpr uint32_t off_v = kv_tile;
  static constexpr uint32_t off_q = 2 * kv_tile;
  static constexpr uint32_t off_do = off_q + kStages * q_tile;
  static constexpr uint32_t off_lse = off_do + kStages * q_tile;  // kBQ floats per stage
  static constexpr uint32_t off_delta = off_lse + kStages * kBQ * 4;
  static constexpr uint32_t off_bar = off_delta + kStages * kBQ * 4;  // full[], empty[], kv
  static constexpr uint32_t bytes = off_bar + (2 * kStages + 1) * 8;
  static constexpr size_t smem = bytes + 1024;  // room to align the base to 1024
  static_assert(smem <= kSmemMax, "dK/dV tiles exceed shared memory");
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
#define ATPU_ACC32 ATPU_ACC8(0), ATPU_ACC8(8), ATPU_ACC8(16), ATPU_ACC8(24)
#define ATPU_ACC64 ATPU_ACC32, ATPU_ACC8(32), ATPU_ACC8(40), ATPU_ACC8(48), ATPU_ACC8(56)

// d[32] (+)= A[64 x 16] . B[16 x 64]: A and B K-major in shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc);
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

// d[D/2] += A[64 x 16] . B[16 x D], B MN-major.
template <typename T, int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128) {
    wgmma_rs_n128<T>(d, a, db);
  } else {
    wgmma_rs_n64<T>(d, a, db);
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

// The two values of a packed pair back in fp32.
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t x);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t x) {
  return __half22float2(*reinterpret_cast<__half2*>(&x));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// P^T and dS^T in place of S^T and dP^T (accumulator layout: element 4j + e
// is key row g + 8 (e >> 1) of the warp's 16, query column 8j + 2t + (e & 1)
// of the tile).  With kMask, a pair is admitted only where the query is
// below S and, under the causal mask, at or after the key (q_min[r]).
template <bool kMask>
__device__ __forceinline__ void probs(float (&st)[32], float (&dpt)[32], const float* lse2,
                                      const float* delta, int t, float scale_log2, float scale,
                                      int q0, const int (&q_min)[2], int S) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(st[4 * j + e] * scale_log2 - ((e & 1) ? l.y : l.x));
      if constexpr (kMask) {
        const int qrow = q0 + 8 * j + 2 * t + (e & 1);
        p = (qrow < S && qrow >= q_min[e >> 1]) ? p : 0.f;
      }
      st[4 * j + e] = p;
      dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x)) * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// kernel
// ---------------------------------------------------------------------------

template <typename T, int D, bool kLo>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int8_t* __restrict__ valid, T* __restrict__ dk,
                          T* __restrict__ dv, int S, int H, int KH, int causal, float scale,
                          float scale_log2) {
  using P = Plan<D>;
  constexpr int NA = D / 2;    // dK or dV accumulator registers per thread
  constexpr int CPR = D / 8;   // 16-byte chunks per dK/dV row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + P::off_bar;  // full[s] = full + 8 s
  const uint32_t empty = full + 8 * kStages;
  const uint32_t kvbar = empty + 8 * kStages;

  const int b = blockIdx.x / KH, kh = blockIdx.x % KH, G = H / KH;
  const int k0 = blockIdx.y * kBK;  // the lowest key tiles, the heaviest when causal, first
  const int8_t* vld = valid ? valid + static_cast<long long>(b) * S : nullptr;
  const long long out_row0 = static_cast<long long>(b) * S;

  // A CTA with no valid key writes zeros and loads nothing.
  if (vld != nullptr) {
    const int key = k0 + static_cast<int>(threadIdx.x);
    const int live = threadIdx.x < kBK && key < S && vld[key] != 0;
    if (!__syncthreads_or(live)) {
      const uint4 zero = make_uint4(0, 0, 0, 0);
      for (int c = threadIdx.x; c < kBK * CPR; c += kThreads) {
        const int kr = k0 + c / CPR;
        if (kr >= S) continue;
        const long long at = ((out_row0 + kr) * KH + kh) * D + (c % CPR) * 8;
        *reinterpret_cast<uint4*>(dk + at) = zero;
        *reinterpret_cast<uint4*>(dv + at) = zero;
      }
      return;
    }
  }

  // Query tiles wholly before the CTA's first key see none of its keys.
  const int qt_first = causal ? k0 / kBQ : 0;
  const int nqt = (S + kBQ - 1) / kBQ - qt_first;
  const int total = G * nqt;  // (query head, q tile) steps, head-major

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);                // every producer lane arrives
      mbar_init(empty + 8 * s, kConsumerWarps);  // one lane per consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32 * kConsumerWarps) {
    // ----- producer warpgroup: its first warp loads, the others leave -----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= 32 * kConsumerWarps + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_tx(kvbar, 2 * P::kv_tile);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sbase + c * kKBlock, &tm_k, 64 * c, kh, k0, b, kvbar);
        tma_load(sbase + P::off_v + c * kKBlock, &tm_v, 64 * c, kh, k0, b, kvbar);
      }
    }
    for (int it = 0; it < total; ++it) {
      const int s = it % kStages;
      mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
      const int hh = kh * G + it / nqt, q0 = (qt_first + it % nqt) * kBQ;
      const long long at = (static_cast<long long>(b) * H + hh) * S;
      float* lse_s = reinterpret_cast<float*>(smem + P::off_lse + s * kBQ * 4);
      float* delta_s = reinterpret_cast<float*>(smem + P::off_delta + s * kBQ * 4);
#pragma unroll
      for (int e = 0; e < kBQ / 32; ++e) {
        const int r = lane + 32 * e, row = q0 + r;
        lse_s[r] = row < S ? lse[at + row] * kLog2e : 0.f;
        delta_s[r] = row < S ? delta[at + row] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_tx(full + 8 * s, 2 * P::q_tile);
        const uint32_t q_dst = sbase + P::off_q + s * P::q_tile;
        const uint32_t do_dst = sbase + P::off_do + s * P::q_tile;
        for (int c = 0; c < D / 64; ++c) {
          tma_load(q_dst + c * kQBlock, &tm_q, 64 * c, hh, q0, b, full + 8 * s);
          tma_load(do_dst + c * kQBlock, &tm_do, 64 * c, hh, q0, b, full + 8 * s);
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
  const int kw0 = k0 + 64 * wg;  // this warpgroup's first key
  // The first admitted query of each of the thread's two key rows.
  const int q_min[2] = {causal ? kw0 + 16 * warp + g : 0, causal ? kw0 + 16 * warp + g + 8 : 0};
  const uint32_t k_addr = sbase + 64 * wg * 128;  // this warpgroup's rows of K block 0
  const uint32_t v_addr = sbase + P::off_v + 64 * wg * 128;

  float dk_acc[NA], dv_acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kvbar, 0);
  for (int it = 0; it < total; ++it) {
    const int s = it % kStages;
    const int q0 = (qt_first + it % nqt) * kBQ;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    // Under the causal mask a tile wholly before this warpgroup's keys adds
    // nothing to them.
    if (!causal || q0 + kBQ - 1 >= kw0) {
      const uint32_t q_addr = sbase + P::off_q + s * P::q_tile;
      const uint32_t do_addr = sbase + P::off_do + s * P::q_tile;

      // S^T = K.Q^T and dP^T = V.dO^T over d in k16 steps (32 bytes inside
      // a 64-column block).  Their first step does not read the
      // accumulators (scale-d 0), so they live only inside the step.
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint32_t ka = (kd / 4) * kKBlock + (kd % 4) * 32;
        const uint32_t qa = (kd / 4) * kQBlock + (kd % 4) * 32;
        wgmma_ss_n64<T>(st, desc_sw128(k_addr + ka, 16, 1024), desc_sw128(q_addr + qa, 16, 1024),
                        kd > 0);
      }
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint32_t ka = (kd / 4) * kKBlock + (kd % 4) * 32;
        const uint32_t qa = (kd / 4) * kQBlock + (kd % 4) * 32;
        wgmma_ss_n64<T>(dpt, desc_sw128(v_addr + ka, 16, 1024),
                        desc_sw128(do_addr + qa, 16, 1024), kd > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(st);
      fence_regs(dpt);

      const float* lse2 = reinterpret_cast<const float*>(smem + P::off_lse + s * kBQ * 4);
      const float* dlt = reinterpret_cast<const float*>(smem + P::off_delta + s * kBQ * 4);
      if ((causal && q0 < kw0 + 63) || q0 + kBQ > S) {
        probs<true>(st, dpt, lse2, dlt, t, scale_log2, scale, q0, q_min, S);
      } else {
        probs<false>(st, dpt, lse2, dlt, t, scale_log2, scale, q0, q_min, S);
      }

      // k16 chunk kk of P^T (hi, lo) and dS^T = the A registers of the kk-th
      // step of the dV and dK products.
      uint32_t ph[4][4], pl[4][4], ds[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x0 = st[8 * kk + 2 * i], x1 = st[8 * kk + 2 * i + 1];
          ph[kk][i] = pack2<T>(x0, x1);
          if constexpr (kLo) {
            const float2 h = unpack2<T>(ph[kk][i]);
            pl[kk][i] = pack2<T>(x0 - h.x, x1 - h.y);
          }
          ds[kk][i] = pack2<T>(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1]);
        }

      // dV += P^T.dO and dK += dS^T.Q over the tile's 64 queries in k16 steps
      // (2048 bytes: 16 rows), Q and dO MN-major.
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t ddo = desc_sw128(do_addr + kk * 2048, kQBlock, 1024);
        wgmma_rs<T, D>(dv_acc, ph[kk], ddo);
        if constexpr (kLo) wgmma_rs<T, D>(dv_acc, pl[kk], ddo);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<T, D>(dk_acc, ds[kk], desc_sw128(q_addr + kk * 2048, kQBlock, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
  }

  // ----- epilogue -----
  // Stage the warpgroup's 64 x D dK and dV in its own K and V rows (only its
  // own wgmmas read them, and they completed above), 16-byte chunk c of row
  // r at c ^ (r % 8).
  uint8_t* k_stage = smem + 64 * wg * 128;
  uint8_t* v_stage = smem + P::off_v + 64 * wg * 128;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = 16 * warp + g + 8 * r;
      const uint32_t at = (j / 8) * kKBlock + rl * 128 + ((j % 8) ^ (rl & 7)) * 16 + 4 * t;
      *reinterpret_cast<uint32_t*>(k_stage + at) =
          pack2<T>(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(v_stage + at) =
          pack2<T>(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  named_sync(1 + wg, 128);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < 64 * CPR; c += 128) {
    const int rl = c / CPR, cc = c % CPR, key = kw0 + rl;
    if (key >= S) continue;
    const uint32_t at = (cc / 8) * kKBlock + rl * 128 + ((cc % 8) ^ (rl & 7)) * 16;
    const bool live = vld == nullptr || vld[key] != 0;
    const long long o = ((out_row0 + key) * KH + kh) * D + cc * 8;
    *reinterpret_cast<uint4*>(dk + o) = live ? *reinterpret_cast<const uint4*>(k_stage + at) : zero;
    *reinterpret_cast<uint4*>(dv + o) = live ? *reinterpret_cast<const uint4*>(v_stage + at) : zero;
  }
}

// ---------------------------------------------------------------------------
// head dim 256: 64-key CTAs, dK/dV columns split over the two warpgroups
// ---------------------------------------------------------------------------

constexpr int kWD = 256;
constexpr int kWBK = 64;  // keys per CTA
constexpr int kWStages = 2;
constexpr uint32_t kWKBlock = kWBK * 128;  // one 64-column block of a K or V tile, bytes

struct WidePlan {
  static constexpr uint32_t kv_tile = (kWD / 64) * kWKBlock;  // K or V
  static constexpr uint32_t q_tile = (kWD / 64) * kQBlock;    // Q or dO of one stage
  static constexpr uint32_t off_v = kv_tile;
  static constexpr uint32_t off_q = 2 * kv_tile;
  static constexpr uint32_t off_do = off_q + kWStages * q_tile;
  static constexpr uint32_t off_lse = off_do + kWStages * q_tile;  // kBQ floats per stage
  static constexpr uint32_t off_delta = off_lse + kWStages * kBQ * 4;
  static constexpr uint32_t off_bar = off_delta + kWStages * kBQ * 4;  // full[], empty[], kv
  static constexpr uint32_t bytes = off_bar + (2 * kWStages + 1) * 8;
  static constexpr size_t smem = bytes + 1024;
  static_assert(smem <= kSmemMax, "d-256 dK/dV tiles exceed shared memory");
};

// kPartial: write fp32 partials of this CTA's query heads into part (dK at
// [split, B, S, KH, d], dV n_split * B * S * KH * d floats after it), else dK
// and dV in T.
template <typename T, bool kPartial>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const int8_t* __restrict__ valid, T* __restrict__ dk,
                               T* __restrict__ dv, float* __restrict__ part, int S, int H,
                               int KH, int n_split, int causal, float scale, float scale_log2) {
  using P = WidePlan;
  constexpr int D = kWD;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + P::off_bar;
  const uint32_t empty = full + 8 * kWStages;
  const uint32_t kvbar = empty + 8 * kWStages;

  const int sp = blockIdx.x % n_split, bkh = blockIdx.x / n_split;
  const int b = bkh / KH, kh = bkh % KH, gs = H / KH / n_split;  // query heads of this split
  const int k0 = blockIdx.y * kWBK;  // the lowest key tiles, the heaviest when causal, first
  const int8_t* vld = valid ? valid + static_cast<long long>(b) * S : nullptr;
  const long long out_row0 = static_cast<long long>(b) * S;
  const long long part_n = static_cast<long long>(gridDim.x / n_split / KH) * S * KH * D;
  float* part_dk = kPartial ? part + sp * part_n : nullptr;
  float* part_dv = kPartial ? part + (n_split + sp) * part_n : nullptr;

  // A CTA with no valid key writes zeros and loads nothing.
  if (vld != nullptr) {
    const int key = k0 + static_cast<int>(threadIdx.x);
    const int live = threadIdx.x < kWBK && key < S && vld[key] != 0;
    if (!__syncthreads_or(live)) {
      for (int c = threadIdx.x; c < kWBK * D / 8; c += kThreads) {
        const int kr = k0 + c / (D / 8);
        if (kr >= S) continue;
        const long long at = ((out_row0 + kr) * KH + kh) * D + (c % (D / 8)) * 8;
        if constexpr (kPartial) {
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(part_dk + at) = zero;
          *reinterpret_cast<float4*>(part_dk + at + 4) = zero;
          *reinterpret_cast<float4*>(part_dv + at) = zero;
          *reinterpret_cast<float4*>(part_dv + at + 4) = zero;
        } else {
          const uint4 zero = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(dk + at) = zero;
          *reinterpret_cast<uint4*>(dv + at) = zero;
        }
      }
      return;
    }
  }

  const int qt_first = causal ? k0 / kBQ : 0;
  const int nqt = (S + kBQ - 1) / kBQ - qt_first;
  const int total = gs * nqt;  // (query head, q tile) steps, head-major
  const int h0 = kh * (H / KH) + sp * gs;  // this split's first query head

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32 * kConsumerWarps) {
    // ----- producer warpgroup: its first warp loads, the others leave -----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= 32 * kConsumerWarps + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_tx(kvbar, 2 * P::kv_tile);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sbase + c * kWKBlock, &tm_k, 64 * c, kh, k0, b, kvbar);
        tma_load(sbase + P::off_v + c * kWKBlock, &tm_v, 64 * c, kh, k0, b, kvbar);
      }
    }
    for (int it = 0; it < total; ++it) {
      const int s = it % kWStages;
      mbar_wait(empty + 8 * s, ((it / kWStages) & 1) ^ 1);
      const int hh = h0 + it / nqt, q0 = (qt_first + it % nqt) * kBQ;
      const long long at = (static_cast<long long>(b) * H + hh) * S;
      float* lse_s = reinterpret_cast<float*>(smem + P::off_lse + s * kBQ * 4);
      float* delta_s = reinterpret_cast<float*>(smem + P::off_delta + s * kBQ * 4);
#pragma unroll
      for (int e = 0; e < kBQ / 32; ++e) {
        const int r = lane + 32 * e, row = q0 + r;
        lse_s[r] = row < S ? lse[at + row] * kLog2e : 0.f;
        delta_s[r] = row < S ? delta[at + row] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_tx(full + 8 * s, 2 * P::q_tile);
        const uint32_t q_dst = sbase + P::off_q + s * P::q_tile;
        const uint32_t do_dst = sbase + P::off_do + s * P::q_tile;
        for (int c = 0; c < D / 64; ++c) {
          tma_load(q_dst + c * kQBlock, &tm_q, 64 * c, hh, q0, b, full + 8 * s);
          tma_load(do_dst + c * kQBlock, &tm_do, 64 * c, hh, q0, b, full + 8 * s);
        }
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // ----- consumer warpgroups: the same 64 keys, columns 128 wg .. 128 wg + 127 -----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int q_min[2] = {causal ? k0 + 16 * warp + g : 0, causal ? k0 + 16 * warp + g + 8 : 0};
  const uint32_t k_addr = sbase, v_addr = sbase + P::off_v;
  const uint32_t col_off = 2 * wg * kQBlock;  // the warpgroup's first Q/dO column block

  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kvbar, 0);
  for (int it = 0; it < total; ++it) {
    const int s = it % kWStages;
    const int q0 = (qt_first + it % nqt) * kBQ;
    mbar_wait(full + 8 * s, (it / kWStages) & 1);
    const uint32_t q_addr = sbase + P::off_q + s * P::q_tile;
    const uint32_t do_addr = sbase + P::off_do + s * P::q_tile;

    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const uint32_t ka = (kd / 4) * kWKBlock + (kd % 4) * 32;
      const uint32_t qa = (kd / 4) * kQBlock + (kd % 4) * 32;
      wgmma_ss_n64<T>(st, desc_sw128(k_addr + ka, 16, 1024), desc_sw128(q_addr + qa, 16, 1024),
                      kd > 0);
    }
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const uint32_t ka = (kd / 4) * kWKBlock + (kd % 4) * 32;
      const uint32_t qa = (kd / 4) * kQBlock + (kd % 4) * 32;
      wgmma_ss_n64<T>(dpt, desc_sw128(v_addr + ka, 16, 1024), desc_sw128(do_addr + qa, 16, 1024),
                      kd > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(st);
    fence_regs(dpt);

    const float* lse2 = reinterpret_cast<const float*>(smem + P::off_lse + s * kBQ * 4);
    const float* dlt = reinterpret_cast<const float*>(smem + P::off_delta + s * kBQ * 4);
    if ((causal && q0 < k0 + kWBK - 1) || q0 + kBQ > S) {
      probs<true>(st, dpt, lse2, dlt, t, scale_log2, scale, q0, q_min, S);
    } else {
      probs<false>(st, dpt, lse2, dlt, t, scale_log2, scale, q0, q_min, S);
    }

    uint32_t ph[4][4], pl[4][4], ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x0 = st[8 * kk + 2 * i], x1 = st[8 * kk + 2 * i + 1];
        ph[kk][i] = pack2<T>(x0, x1);
        const float2 hv = unpack2<T>(ph[kk][i]);
        pl[kk][i] = pack2<T>(x0 - hv.x, x1 - hv.y);
        ds[kk][i] = pack2<T>(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1]);
      }

    // dV += P^T.dO[:, cols] and dK += dS^T.Q[:, cols], 128 columns: two
    // 64-column blocks (leading byte offset one block), 16 rows a k16 step.
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t ddo = desc_sw128(do_addr + col_off + kk * 2048, kQBlock, 1024);
      wgmma_rs_n128<T>(dv_acc, ph[kk], ddo);
      wgmma_rs_n128<T>(dv_acc, pl[kk], ddo);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128<T>(dk_acc, ds[kk], desc_sw128(q_addr + col_off + kk * 2048, kQBlock, 1024));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // ----- epilogue -----
  if constexpr (kPartial) {
    // fp32 pairs straight from the accumulators: 4 lanes fill a 32-byte
    // sector of a row.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + 16 * warp + g + 8 * r;
      if (key >= S) continue;
      const bool live = vld == nullptr || vld[key] != 0;
      const long long row = ((out_row0 + key) * KH + kh) * D + 128 * wg + 2 * t;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 kv = live ? make_float2(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1])
                               : make_float2(0.f, 0.f);
        const float2 vv = live ? make_float2(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1])
                               : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(part_dk + row + 8 * j) = kv;
        *reinterpret_cast<float2*>(part_dv + row + 8 * j) = vv;
      }
    }
  } else {
    // Both warpgroups read all of K and V: wait for both before staging the
    // warpgroup's dK (dV) columns in K's (V's) blocks 2 wg and 2 wg + 1,
    // 16-byte chunk c of row r at c ^ (r % 8).
    named_sync(1, 32 * kConsumerWarps);
    uint8_t* k_stage = smem + 2 * wg * kWKBlock;
    uint8_t* v_stage = smem + P::off_v + 2 * wg * kWKBlock;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rl = 16 * warp + g + 8 * r;
        const uint32_t at = (j / 8) * kWKBlock + rl * 128 + ((j % 8) ^ (rl & 7)) * 16 + 4 * t;
        *reinterpret_cast<uint32_t*>(k_stage + at) =
            pack2<T>(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(v_stage + at) =
            pack2<T>(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    named_sync(2 + wg, 128);
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int c = tid; c < 64 * 16; c += 128) {
      const int rl = c / 16, cc = c % 16, key = k0 + rl;
      if (key >= S) continue;
      const uint32_t at = (cc / 8) * kWKBlock + rl * 128 + ((cc % 8) ^ (rl & 7)) * 16;
      const bool live = vld == nullptr || vld[key] != 0;
      const long long o = ((out_row0 + key) * KH + kh) * D + 128 * wg + cc * 8;
      *reinterpret_cast<uint4*>(dk + o) = live ? *reinterpret_cast<const uint4*>(k_stage + at) : zero;
      *reinterpret_cast<uint4*>(dv + o) = live ? *reinterpret_cast<const uint4*>(v_stage + at) : zero;
    }
  }
}

// dk[i] = sum over split s = 0, 1, .. of part[s][i], in that order, cast to
// T; dv from the n_split partials after dK's.  n is a multiple of 4.
template <typename T>
__global__ void flash_bwd_dkv_sum_kernel(const float* __restrict__ part, T* __restrict__ dk,
                                         T* __restrict__ dv, long long n, int n_split) {
  const long long quads = n / 4;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < 2 * quads;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int m = i >= quads;  // 0 dK, 1 dV
    const long long at = 4 * (i - m * quads);
    const float* src = part + m * n_split * n + at;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int s = 1; s < n_split; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(src + s * n);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    uint2 packed;
    packed.x = pack2<T>(acc.x, acc.y);
    packed.y = pack2<T>(acc.z, acc.w);
    *reinterpret_cast<uint2*>((m ? dv : dk) + at) = packed;
  }
}

// ---------------------------------------------------------------------------
// launchers
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
  void *dk, *dv;
  float* part;  // d-256 split workspace, or null
  int B, S, H, KH, causal, n_split;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool kLo>
int run(CUtensorMapDataType dt, const Args& a) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrEntryPoint;
  CUtensorMap tq, tk, tv, tdo;
  int rc = encode(&tq, enc, dt, a.q, D, a.H, a.S, a.B, kBQ);
  if (rc == 0) rc = encode(&tk, enc, dt, a.k, D, a.KH, a.S, a.B, kBK);
  if (rc == 0) rc = encode(&tv, enc, dt, a.v, D, a.KH, a.S, a.B, kBK);
  if (rc == 0) rc = encode(&tdo, enc, dt, a.dout, D, a.H, a.S, a.B, kBQ);
  if (rc != 0) return rc;
  auto kernel = flash_bwd_dkv_sm90_kernel<T, D, kLo>;
  const size_t smem = Plan<D>::smem;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.KH, (a.S + kBK - 1) / kBK);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int8_t*>(a.valid), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S,
      a.H, a.KH, a.causal, a.scale, a.scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T>
int run_d256(CUtensorMapDataType dt, const Args& a) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrEntryPoint;
  CUtensorMap tq, tk, tv, tdo;
  int rc = encode(&tq, enc, dt, a.q, kWD, a.H, a.S, a.B, kBQ);
  if (rc == 0) rc = encode(&tk, enc, dt, a.k, kWD, a.KH, a.S, a.B, kWBK);
  if (rc == 0) rc = encode(&tv, enc, dt, a.v, kWD, a.KH, a.S, a.B, kWBK);
  if (rc == 0) rc = encode(&tdo, enc, dt, a.dout, kWD, a.H, a.S, a.B, kBQ);
  if (rc != 0) return rc;
  const bool partial = a.n_split > 1;
  auto kernel = partial ? flash_bwd_dkv_sm90_d256_kernel<T, true>
                        : flash_bwd_dkv_sm90_d256_kernel<T, false>;
  const size_t smem = WidePlan::smem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.KH * a.n_split, (a.S + kWBK - 1) / kWBK);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int8_t*>(a.valid), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.part,
      a.S, a.H, a.KH, a.n_split, a.causal, a.scale, a.scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || !partial) return (int)err;
  const long long n = static_cast<long long>(a.B) * a.S * a.KH * kWD;
  const int blocks = static_cast<int>(std::min<long long>((n / 2 + 255) / 256, 4096));
  flash_bwd_dkv_sum_kernel<T><<<blocks, 256, 0, a.stream>>>(
      a.part, static_cast<T*>(a.dk), static_cast<T*>(a.dv), n, a.n_split);
  return (int)cudaGetLastError();
}

bool bad_args(const Args& a) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                        reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout) |
                        reinterpret_cast<uintptr_t>(a.dk) | reinterpret_cast<uintptr_t>(a.dv);
  return a.B <= 0 || a.S <= 0 || a.KH <= 0 || a.H % a.KH != 0 || (mis & 15) != 0 ||
         (a.S + kBK - 1) / kBK > 65535;
}

}  // namespace

// dtype 1 bfloat16, 2 float16 (float32 runs atpu_flash_bwd_dkv); hd 64 or
// 128.  q, do [B, S, H, hd], k/v [B, S, KH, hd], lse/delta [B, H, S] fp32,
// valid [B, S] int8 or null; q, k, v, do, dk, dv 16-byte aligned.  Writes dk
// and dv [B, S, KH, hd] (summed over each kv head's query heads).  Returns 0,
// a cudaError_t, 999 if the tensor-map encoder is missing, or 1000 + the
// CUresult of a failed encode.
extern "C" int atpu_flash_bwd_dkv_sm90(int dtype, const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* valid, void* dk, void* dv, int B, int S, int H,
                                       int KH, int hd, int causal, float scale, void* stream) {
  const Args a{q,  k,  v, dout, lse,    delta, valid, dk, dv, nullptr,
               B,  S,  H, KH,   causal, 1,     scale, static_cast<cudaStream_t>(stream)};
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  switch (dtype * 1000 + hd) {
    case 1064: return run<__nv_bfloat16, 64, true>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a);
    case 1128: return run<__nv_bfloat16, 128, true>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a);
    case 2064: return run<__half, 64, true>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, a);
    case 2128: return run<__half, 128, true>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same kernel without the lo half of P in the dV product (P rounded to
// the operand type once), bf16 and hd 128 only: on no path, timed beside the
// kernel to weigh the split.  Arguments and returns as above.
extern "C" int atpu_flash_bwd_dkv_sm90_nolo(int dtype, const void* q, const void* k,
                                            const void* v, const void* dout, const void* lse,
                                            const void* delta, const void* valid, void* dk,
                                            void* dv, int B, int S, int H, int KH, int hd,
                                            int causal, float scale, void* stream) {
  const Args a{q,  k,  v, dout, lse,    delta, valid, dk, dv, nullptr,
               B,  S,  H, KH,   causal, 1,     scale, static_cast<cudaStream_t>(stream)};
  if (bad_args(a) || dtype != 1 || hd != 128) return (int)cudaErrorInvalidValue;
  return run<__nv_bfloat16, 128, false>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a);
}

// Head dim 256, bf16 (dtype 1) or fp16 (2): arguments as above, plus part,
// the fp32 workspace of 2 x n_split x B x S x KH x 256 floats (16-byte
// aligned; null when n_split is 1), and n_split, which divides H / KH.
// Launches the split kernel and, when n_split > 1, the sum kernel after it
// on the same stream.  Returns as above.
extern "C" int atpu_flash_bwd_dkv_sm90_d256(int dtype, const void* q, const void* k,
                                            const void* v, const void* dout, const void* lse,
                                            const void* delta, const void* valid, void* dk,
                                            void* dv, void* part, int B, int S, int H, int KH,
                                            int hd, int causal, int n_split, float scale,
                                            void* stream) {
  const Args a{q,  k,  v, dout, lse,    delta,   valid, dk, dv, static_cast<float*>(part),
               B,  S,  H, KH,   causal, n_split, scale, static_cast<cudaStream_t>(stream)};
  if (bad_args(a) || hd != kWD || n_split < 1 || (H / KH) % n_split != 0 ||
      (S + kWBK - 1) / kWBK > 65535 ||
      (n_split > 1 && (part == nullptr || (reinterpret_cast<uintptr_t>(part) & 15) != 0)) ||
      static_cast<long long>(B) * KH * n_split > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 1: return run_d256<__nv_bfloat16>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a);
    case 2: return run_d256<__half>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
