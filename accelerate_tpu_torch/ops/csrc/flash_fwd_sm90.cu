// Flash-attention training forward for Hopper (sm_90a), 16-bit types: wgmma
// for both products, a TMA-fed K/V ring guarded by mbarriers, P kept in
// registers.  The fp32 forward stays on atpu_flash_fwd (flash_attention.cu).
//
// Replaces _fwd_kernel (accelerate_tpu/ops/pallas_attention.py:96, launched
// by _flash_fwd at :174), with the contract of atpu_flash_fwd:
//   q, out [B, S, H, d]; k, v [B, S, KH, d]; query head h reads kv head
//   h / (H / KH); valid [B, S] int8 or null; lse [B, H, S] fp32; d 64, 96,
//   128 or 256; bf16 or fp16.  Per query row i and key j, s_ij = (q_i . k_j) * scale in
//   fp32, or -1e30 where masked (key past S, causal j > i, valid[j] == 0); a
//   probability is gated on the masked score (s > -0.5e30), never on the
//   running max, so a row with no admitted key has l = 0, output 0 and lse ~
//   -1e30; online softmax in fp32, P cast to v's dtype before P.V, out =
//   acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//
// Bound on this card.  At the training shape (B 2, S 2048, causal, 32 q over
// 8 kv heads, d 128) the two products are 68.8 GFLOP on 67 MB read and
// written: ~1000 flop per byte, above the H100's ~295 flop/byte ridge, so
// the least time is flops / 989 TFLOP/s = 0.0695 ms (chip_smoke.py computes
// it from the run's shapes).  The design keeps the tensor cores fed:
//
//   - CTA = 128 query rows of one (batch, head): two consumer warpgroups of
//     64 rows and a producer warpgroup of which one warp works (384
//     threads, one CTA per SM); setmaxnreg moves registers from the
//     producer (40 a thread) to the consumers (232), which would otherwise
//     get 168 and spill;
//   - the producer's lane 0 loads the Q tile once and streams K and V tiles
//     of kBN keys (128; 64 at d 256, below) into a 2-stage ring with
//     cp.async.bulk.tensor (4-D tensor maps (d, heads, S, B) over the public
//     layout: no transposes, rows past S zero-filled per batch), arming each
//     stage's full barrier with expect_tx; each consumer warp releases a
//     stage on its empty barrier after the P.V that read it has completed
//     (wgmma.wait_group 0);
//   - S = Q.K^T is wgmma m64n{kBN}k16 with both operands from shared memory
//     (K-major, 128-byte swizzle); O += P.V is wgmma m64n{d}k16 with P from
//     registers and V from shared memory, MN-major with the transpose bit
//     (at d 256 two m64n128k16 halves over the same P registers);
//   - the fp32 score accumulator of a wgmma has the per-warp layout of
//     mma.sync's (rows g and g + 8 of the warp's 16, pairs of columns), so
//     each k16 chunk of P packs straight into the next wgmma's A registers:
//     no P strip in shared memory and no block barrier in the loop;
//   - scores are scaled by scale * log2(e) and exponentiated with ex2; tiles
//     wholly above the causal diagonal are never loaded, and a tile that is
//     wholly below it, inside S and (with kv_valid) all valid skips
//     per-element masking; kv_valid bytes are loaded once per tile by the
//     producer warp into shared memory, with an all-valid flag;
//   - the epilogue stages each warpgroup's output in its own (consumed) Q
//     rows, XOR-swizzled by 16-byte chunk, and writes 16-byte stores of rows
//     < S; lse from one lane per row; the heaviest causal q tiles launch
//     first (q-tile index reversed, grid y), so the last wave is short.
//
// Shared memory (1024-byte aligned tiles; a 64-column block is 128 bytes a
// row): d 128 -> Q 32 KB + 2 stages x (K 32 KB + V 32 KB) = 160 KB; d 64
// -> 80 KB; plus 2 x kBN bytes of kv_valid, flags and 5 mbarriers; one CTA
// per SM.  Registers per consumer thread (232 after setmaxnreg): kBN/2 fp32
// of S, d/2 fp32 of O and kBN/4 packed P; ptxas's report (-Xptxas -v, kept
// beside the library) shows no spills.
//
// Head dim 256.  128-key tiles would need Q 64 KB + 2 x (64 + 64) = 320 KB
// and 64 + 128 + 32 registers a thread, so the key tile is 64 at d 256:
// Q 64 KB + 2 stages x (K 32 KB + V 32 KB) = 192 KB, and per consumer thread
// O 128, S 32 and packed P 16 registers.  S = Q.K^T is m64n64k16; the grid
// (B*H x S/128, heaviest causal tiles first), the causal tile skip, kv_valid
// and the zero rows of an all-masked query row are those of d 128.
//
// Head dim 96.  A 128-byte swizzle box is at most 64 16-bit values wide and
// 96 is not a multiple of 64, so a d-96 tile is stored as a 64-column
// 128-byte-swizzled block beside a 32-column 64-byte-swizzled one (a second
// tensor map per operand, 32 columns wide): Q.K^T takes k-steps 0-3 from the
// first block and 4-5 from the second (64-byte-swizzle descriptors: 512-byte
// stride between 8-row groups), and P.V is m64n64k16 over V's first block
// plus m64n32k16 over its second, from the same P registers (the register
// layout of one m64n96k16).  Q 24 KB + 2 x (K 24 KB + V 24 KB) = 120 KB; O
// 48 registers a thread; exactly the minimum products; the epilogue stores
// 96 columns at a row stride of H x 96.  (The d-128 plan over maps of the
// real width, zero-filled by TMA past column 96, was timed 6% slower on an
// H100: P.V over 128 columns makes 7/6 of the products.)
//
// Traps, and how each is handled:
//   - the tensor-map encoder is a driver-API function: fetched once through
//     cudaGetDriverEntryPoint(ByVersion), so no -lcuda; maps are passed as
//     const __grid_constant__ CUtensorMap parameters;
//   - a 128-byte swizzle box is at most 64 16-bit values wide: each tile is
//     loaded as d / 64 boxes of 64 columns; Q.K^T steps its descriptors 32
//     bytes per k16 inside a block and by a block (16 KB) across them, and
//     V's MN-major descriptor has the block as its leading byte offset and
//     1024 bytes (8 keys) as its stride, stepping 2048 bytes per k16;
//   - alignment: the launcher refuses pointers that are not 16-byte aligned
//     (fused_attention._check raises first); d in {64, 96, 128, 256} makes
//     every stride a multiple of 16 bytes (192 at d 96);
//   - wgmma ordering: wgmma.fence before each batch (the S and O registers,
//     and the P fragments, were written by ordinary instructions), commit
//     and wait_group 0 before registers are read, an empty compiler fence on
//     every accumulator register around the asynchronous section;
//   - failures surface: a failed attribute set, entry-point lookup, encode or
//     launch returns non-zero and the Python wrapper raises; there is no
//     fallback to another body.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // query rows per CTA: two consumer warpgroups of 64
constexpr int kStages = 2;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 40;   // setmaxnreg: 128 x 40 + 256 x 232 <= 65536
constexpr int kConsumerRegs = 232;
constexpr uint32_t kBlock = kBM * 128;  // one 64-column block of a Q tile, bytes
constexpr float kMasked = -1e30f;  // finite: no inf - inf in the exp bookkeeping
constexpr float kLive = -0.5e30f;  // scores above this are admitted
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr size_t kSmemMax = 227 * 1024;

template <int D>
struct Plan {
  static constexpr int kFull = D / 64;        // 64-column 128-byte-swizzled blocks
  static constexpr bool kHalf = D % 64 != 0;  // + one 32-column 64-byte-swizzled block (d 96)
  static constexpr int kBN = D == 256 ? 64 : 128;  // keys per K/V tile
  static constexpr uint32_t kv_block = kBN * 128;  // one 64-column block of K or V, bytes
  static constexpr uint32_t q_tile = kFull * kBlock + (kHalf ? kBlock / 2 : 0);
  static constexpr uint32_t kv_tile = kFull * kv_block + (kHalf ? kv_block / 2 : 0);  // K or V
  static constexpr uint32_t off_k = q_tile;
  static constexpr uint32_t off_v = off_k + kStages * kv_tile;
  static constexpr uint32_t off_mask = off_v + kStages * kv_tile;  // kv_valid bytes per stage
  static constexpr uint32_t off_all = off_mask + kStages * kBN;  // whole-tile-valid flags
  static constexpr uint32_t off_bar = off_all + kStages * 8;     // full[], empty[], q
  static constexpr uint32_t bytes = off_bar + (2 * kStages + 1) * 8;
  static constexpr size_t smem = bytes + 1024;  // room to align the base to 1024
  static_assert(smem <= kSmemMax, "forward tiles exceed shared memory");
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
// The same for a 64-byte swizzle (layout type 2): d 96's 32-column block.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (2ull << 62);
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
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc);
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc);
// d[N/2] += A[64 x 16] . B[16 x N]: A in registers, B MN-major in shared
// memory (transposed).
template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db);
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db);
template <typename T>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db);

#define ATPU_WGMMA(TYPE, PTX)                                                                   \
  template <>                                                                                   \
  __device__ __forceinline__ void wgmma_ss_n128<TYPE>(float (&d)[64], uint64_t da, uint64_t db, \
                                                      int acc) {                                \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                   \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " {" ATPU_REGS64    \
                 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                             \
                 : ATPU_ACC64                                                                   \
                 : "l"(da), "l"(db), "r"(acc));                                                 \
  }                                                                                             \
  template <>                                                                                   \
  __device__ __forceinline__ void wgmma_ss_n64<TYPE>(float (&d)[32], uint64_t da, uint64_t db,  \
                                                     int acc) {                                 \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                   \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " {" ATPU_REGS32     \
                 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                             \
                 : ATPU_ACC32                                                                   \
                 : "l"(da), "l"(db), "r"(acc));                                                 \
  }                                                                                             \
  template <>                                                                                   \
  __device__ __forceinline__ void wgmma_rs_n128<TYPE>(float (&d)[64], const uint32_t (&a)[4],   \
                                                      uint64_t db) {                            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                   \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " {" ATPU_REGS64    \
                 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                               \
                 : ATPU_ACC64                                                                   \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));                \
  }                                                                                             \
  template <>                                                                                   \
  __device__ __forceinline__ void wgmma_rs_n64<TYPE>(float (&d)[32], const uint32_t (&a)[4],    \
                                                     uint64_t db) {                             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                   \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " {" ATPU_REGS32     \
                 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                               \
                 : ATPU_ACC32                                                                   \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));                \
  }                                                                                             \
  template <>                                                                                   \
  __device__ __forceinline__ void wgmma_rs_n32<TYPE>(float (&d)[16], const uint32_t (&a)[4],    \
                                                     uint64_t db) {                             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                   \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." PTX "." PTX " {" ATPU_REGS16     \
                 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                               \
                 : ATPU_ACC16                                                                   \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));                \
  }

ATPU_WGMMA(__nv_bfloat16, "bf16")
ATPU_WGMMA(__half, "f16")

// ----- small helpers -----

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

// ---------------------------------------------------------------------------
// kernel
// ---------------------------------------------------------------------------

// tm_q, tm_k, tm_v read 64-column boxes; tm_q2, tm_k2, tm_v2 the 32-column
// boxes of d 96's second block (unused at the other widths).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_q2,
                      const __grid_constant__ CUtensorMap tm_k2,
                      const __grid_constant__ CUtensorMap tm_v2, const int8_t* __restrict__ valid,
                      T* __restrict__ out, float* __restrict__ lse, int S, int H, int KH,
                      int causal, float scale_log2) {
  using P = Plan<D>;
  constexpr int kBN = P::kBN;
  constexpr int kFull = P::kFull;
  constexpr int NO = D / 2;   // O accumulator registers per thread
  constexpr int NS = kBN / 2;  // S accumulator registers per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + P::off_bar;  // full[s] = full + 8 s
  const uint32_t empty = full + 8 * kStages;
  const uint32_t qbar = empty + 8 * kStages;
  const uint8_t* vmask = smem + P::off_mask;
  const int* vall = reinterpret_cast<const int*>(smem + P::off_all);

  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heaviest causal tiles first
  // Keys past the tile's last query row are all causally masked.
  const int kend = causal ? min(S, q0 + kBM) : S;
  const int n_tiles = (kend + kBN - 1) / kBN;
  const int8_t* vld = valid ? valid + static_cast<long long>(b) * S : nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
      mbar_arrive_tx(qbar, P::q_tile);
      for (int c = 0; c < kFull; ++c) tma_load(sbase + c * kBlock, &tm_q, 64 * c, h, q0, b, qbar);
      if constexpr (P::kHalf)
        tma_load(sbase + kFull * kBlock, &tm_q2, 64 * kFull, h, q0, b, qbar);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
      const int key0 = i * kBN;
      if (vld) {
        constexpr int KPL = kBN / 32;  // keys per lane
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
        for (int c = 0; c < kFull; ++c) {
          tma_load(k_dst + c * P::kv_block, &tm_k, 64 * c, kh, key0, b, full + 8 * s);
          tma_load(v_dst + c * P::kv_block, &tm_v, 64 * c, kh, key0, b, full + 8 * s);
        }
        if constexpr (P::kHalf) {
          tma_load(k_dst + kFull * P::kv_block, &tm_k2, 64 * kFull, kh, key0, b, full + 8 * s);
          tma_load(v_dst + kFull * P::kv_block, &tm_v2, 64 * kFull, kh, key0, b, full + 8 * s);
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
  const int row_base = q0 + 64 * wg;              // first row of this warpgroup
  const int row[2] = {row_base + 16 * warp + g, row_base + 16 * warp + g + 8};
  const uint32_t q_addr = sbase + 64 * wg * 128;  // this warpgroup's rows of block 0
  // ... and of the 32-column block (64-byte rows), where there is one.
  const uint32_t q_half = sbase + kFull * kBlock + 64 * wg * 64;

  float o[NO], sc[NS];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.f;
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};  // l: this thread's columns

  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    const uint32_t k_addr = sbase + P::off_k + s * P::kv_tile;
    const uint32_t v_addr = sbase + P::off_v + s * P::kv_tile;

    // S = Q . K^T over d in k16 steps: 32 bytes inside a 64-column block, and
    // inside the 32-column block at d 96.
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const bool full_block = kd < 4 * kFull;
      const uint64_t dq =
          full_block ? desc_sw128(q_addr + (kd / 4) * kBlock + (kd % 4) * 32, 16, 1024)
                     : desc_sw64(q_half + (kd % 4) * 32, 16, 512);
      const uint64_t dk =
          full_block ? desc_sw128(k_addr + (kd / 4) * P::kv_block + (kd % 4) * 32, 16, 1024)
                     : desc_sw64(k_addr + kFull * P::kv_block + (kd % 4) * 32, 16, 512);
      if constexpr (kBN == 128) {
        wgmma_ss_n128<T>(sc, dq, dk, kd > 0);
      } else {
        wgmma_ss_n64<T>(sc, dq, dk, kd > 0);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);

    // Scale into the log2 domain, mask where needed, row max over the quad.
    const int key0 = i * kBN;
    const bool need_mask = (causal && key0 + kBN - 1 > row_base) || key0 + kBN > S ||
                           (vld != nullptr && vall[s] == 0);
    float mx[2] = {kMasked, kMasked};
    if (need_mask) {
      const uint8_t* vm = vmask + s * kBN;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * j + 2 * t + (e & 1), col = key0 + c;
          const bool ok = col < S && (!causal || col <= row[r]) && (vld == nullptr || vm[c] != 0);
          sc[4 * j + e] = ok ? sc[4 * j + e] * scale_log2 : kMasked;
          mx[r] = fmaxf(mx[r], sc[4 * j + e]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] *= scale_log2;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
        }
    }
    float m_new[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_run[r], quad_max(mx[r]));
      alpha[r] = ex2(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
      l_run[r] *= alpha[r];
    }
    if (need_mask) {
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        const int r = (e >> 1) & 1;
        sc[e] = sc[e] > kLive ? ex2(sc[e] - m_new[r]) : 0.f;
        l_run[r] += sc[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        const int r = (e >> 1) & 1;
        sc[e] = ex2(sc[e] - m_new[r]);
        l_run[r] += sc[e];
      }
    }
#pragma unroll
    for (int e = 0; e < NO; ++e) o[e] *= alpha[(e >> 1) & 1];

    // P in v's dtype, k16 chunk kk = the A registers of the kk-th P.V step.
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack2<T>(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack2<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack2<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack2<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P . V over the tile's keys in k16 steps (2048 bytes: 16 key rows).
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t dv = desc_sw128(v_addr + kk * 2048, P::kv_block, 1024);
      if constexpr (D == 256) {
        // Columns 0-127 into o[0..63], 128-255 (V blocks 2 and 3) into o[64..127]:
        // the register layout of one m64n256k16.
        wgmma_rs_n128<T>(*reinterpret_cast<float(*)[64]>(o), pa[kk], dv);
        wgmma_rs_n128<T>(*reinterpret_cast<float(*)[64]>(o + 64), pa[kk],
                         desc_sw128(v_addr + 2 * P::kv_block + kk * 2048, P::kv_block, 1024));
      } else if constexpr (D == 128) {
        wgmma_rs_n128<T>(o, pa[kk], dv);
      } else if constexpr (D == 96) {
        // Columns 0-63 (the 128-byte-swizzled block) into o[0..31], 64-95
        // (the 64-byte-swizzled block: 1024 bytes per 16 keys, 512 per 8)
        // into o[32..47]: the register layout of one m64n96k16.
        wgmma_rs_n64<T>(*reinterpret_cast<float(*)[32]>(o), pa[kk], dv);
        wgmma_rs_n32<T>(*reinterpret_cast<float(*)[16]>(o + 32), pa[kk],
                        desc_sw64(v_addr + P::kv_block + kk * 1024, P::kv_block / 2, 512));
      } else {
        wgmma_rs_n64<T>(o, pa[kk], dv);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
  }

  // ----- epilogue -----
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = fmaxf(quad_sum(l_run[r]), 1e-30f);
    inv[r] = 1.f / l;
    if (t == 0 && row[r] < S) {
      const float m = m_run[r] > kLive ? m_run[r] * kLn2 : kMasked;
      lse[(static_cast<long long>(b) * H + h) * S + row[r]] = m + logf(l);
    }
  }
  // Stage the warpgroup's 64 x D output in its own Q rows (its last wgmma
  // read them before the wait above): 16-byte chunk c of row r at c ^ (r % 8)
  // in a 64-column block (128-byte rows), at c ^ (r % 4) in the 32-column
  // block (64-byte rows).
  const auto stage_at = [&](int j, int rl) -> uint32_t {
    const int r = 64 * wg + rl;
    return j < 8 * kFull ? (j / 8) * kBlock + r * 128 + ((j % 8) ^ (rl & 7)) * 16
                         : kFull * kBlock + r * 64 + ((j % 4) ^ (rl & 3)) * 16;
  };
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = 16 * warp + g + 8 * r;
      *reinterpret_cast<uint32_t*>(smem + stage_at(j, rl) + 4 * t) =
          pack2<T>(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  named_sync(1 + wg, 128);
  constexpr int CPR = D / 8;  // 16-byte chunks per output row
  for (int c = tid; c < 64 * CPR; c += 128) {
    const int rl = c / CPR, cc = c % CPR, rw = row_base + rl;
    if (rw >= S) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(smem + stage_at(cc, rl));
    *reinterpret_cast<uint4*>(out + ((static_cast<long long>(b) * S + rw) * H + h) * D + cc * 8) =
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
// in boxes of `cols` columns x `rows` rows of one head: 64 columns 128-byte
// swizzled, or 32 columns 64-byte swizzled.
int encode(CUtensorMap* map, EncodeTiled enc, CUtensorMapDataType dt, const void* ptr, int d,
           int heads, int S, int B, int rows, int cols = 64) {
  const cuuint64_t es = 2;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {d * es, (cuuint64_t)heads * d * es,
                                 (cuuint64_t)S * heads * d * es};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, dt, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

template <typename T, int D>
int run(CUtensorMapDataType dt, const void* q, const void* k, const void* v, const void* valid,
        void* out, void* lse, int B, int S, int H, int KH, int causal, float scale,
        cudaStream_t stream) {
  using P = Plan<D>;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrEntryPoint;
  // The 32-column maps only at d 96.
  CUtensorMap tq, tk, tv, tq2{}, tk2{}, tv2{};
  int rc = encode(&tq, enc, dt, q, D, H, S, B, kBM);
  if (rc == 0) rc = encode(&tk, enc, dt, k, D, KH, S, B, P::kBN);
  if (rc == 0) rc = encode(&tv, enc, dt, v, D, KH, S, B, P::kBN);
  if (P::kHalf && rc == 0) rc = encode(&tq2, enc, dt, q, D, H, S, B, kBM, 32);
  if (P::kHalf && rc == 0) rc = encode(&tk2, enc, dt, k, D, KH, S, B, P::kBN, 32);
  if (P::kHalf && rc == 0) rc = encode(&tv2, enc, dt, v, D, KH, S, B, P::kBN, 32);
  if (rc != 0) return rc;
  auto kernel = flash_fwd_sm90_kernel<T, D>;
  const size_t smem = P::smem;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, tq2, tk2, tv2,
                                           static_cast<const int8_t*>(valid),
                                           static_cast<T*>(out), static_cast<float*>(lse), S, H,
                                           KH, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 1 bfloat16, 2 float16 (float32 runs atpu_flash_fwd); hd 64, 96, 128
// or 256.
// q [B, S, H, hd], k/v [B, S, KH, hd], valid [B, S] int8 or null, all
// 16-byte aligned; writes out [B, S, H, hd] and lse [B, H, S] fp32.  Returns
// 0, a cudaError_t, 999 if the tensor-map encoder is missing, or 1000 + the
// CUresult of a failed encode.
extern "C" int atpu_flash_fwd_sm90(int dtype, const void* q, const void* k, const void* v,
                                   const void* valid, void* out, void* lse, int B, int S, int H,
                                   int KH, int hd, int causal, float scale, void* stream) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || (mis & 15) != 0 ||
      (S + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype * 1000 + hd) {
    case 1096:
      return run<__nv_bfloat16, 96>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v, valid, out, lse, B,
                                    S, H, KH, causal, scale, st);
    case 2096:
      return run<__half, 96>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, q, k, v, valid, out, lse, B, S, H,
                             KH, causal, scale, st);
    case 1064:
      return run<__nv_bfloat16, 64>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v, valid, out, lse, B,
                                    S, H, KH, causal, scale, st);
    case 1128:
      return run<__nv_bfloat16, 128>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v, valid, out, lse,
                                     B, S, H, KH, causal, scale, st);
    case 2064:
      return run<__half, 64>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, q, k, v, valid, out, lse, B, S, H,
                             KH, causal, scale, st);
    case 2128:
      return run<__half, 128>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, q, k, v, valid, out, lse, B, S, H,
                              KH, causal, scale, st);
    case 1256:
      return run<__nv_bfloat16, 256>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v, valid, out, lse,
                                     B, S, H, KH, causal, scale, st);
    case 2256:
      return run<__half, 256>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, q, k, v, valid, out, lse, B, S, H,
                              KH, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
