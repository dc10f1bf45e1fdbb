// Flash attention in fp32 for Hopper (sm_90a): the training forward, dQ,
// and dK/dV, on the tensor cores in 3xTF32.
//
// Replaces (accelerate_tpu/ops/pallas_attention.py), for float32 inputs:
//   atpu_flash_fwd_f32_sm90     -> _fwd_kernel (:96), launched by _flash_fwd (:174)
//   atpu_flash_bwd_dq_f32_sm90  -> _bwd_dq_kernel (:206), launched by _flash_bwd (:338)
//   atpu_flash_bwd_dkv_f32_sm90 -> _bwd_dkv_kernel (:258), launched by _flash_bwd (:361),
//                                  with the GQA group sum of :388 folded in
//
// Layouts and semantics are those of flash_attention.cu (whose fp32 bodies
// these replace): q, out, do, dq [B, S, H, d]; k, v, dk, dv [B, S, KH, d];
// lse, delta [B, H, S]; valid [B, S] int8 or null.  With scale = 1 / sqrt(d):
//   s = (q . k) * scale, or -1e30 where the pair is masked (key past S,
//       causal key > query, valid[key] == 0);
//   forward: online softmax over key tiles, a probability gated on the
//       masked score (s > -0.5e30), never on the running max; out = acc /
//       max(l, 1e-30), lse = m + log(max(l, 1e-30)), so a row with no
//       admitted key outputs 0 with lse ~ -1e30;
//   p = exp(s - lse), gated the same way, so such a row gets zero gradients;
//   dP = dO . V^T, dS = p * (dP - delta) * scale;
//   dQ = sum_j dS . K;  dV = sum_i p^T . dO (p kept fp32, the reference's
//   fp32 product);  dK = sum_i dS^T . Q;  dK and dV summed over the G query
//   heads of each kv head.  Causal tiles above the diagonal are skipped; no
//   atomics, so results are deterministic.
//
// Bound on this card.  fp32 products on the CUDA cores peak at ~67 TFLOP/s.
// The tensor cores take TF32 at 495 TFLOP/s dense, but one TF32 product
// keeps ~11 significant bits, which misses the fp32 tolerance (1e-4).  The
// 3xTF32 split keeps fp32-level error: x ~ big + small with big = tf32(x)
// and small = x - big, read as TF32; a.b ~ a_small.b_big + a_big.b_small +
// a_big.b_big, each product exact in the fp32 accumulator.  So the least
// time is 3 x the products' flops / 495 TFLOP/s (forward: 2 products of 2 d
// flops per admitted pair, dQ: 3, dK/dV: 4).  PyTorch's own fp32 attention
// computes the same way (OpMultiplyAddFastF32, GemmShape<16, 8, 8>).
//
// Design:
//   - Products are mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, three
//     per 16x8x8 block.  Each operand is split in registers right after its
//     32-bit shared-memory load (big: cvt.rna's rounding done in two integer
//     operations; small: the fp32 residual, whose low bits the tensor core
//     drops), so one pair of helpers serves operands of either major:
//     warp_nt (C += A.B^T, both operands rows of d floats) and warp_pv (C +=
//     P.B, P an fp32 accumulator tile, B rows of d floats).  wgmma's .tf32
//     form reads
//     K-major shared-memory operands only (its transpose is for 16-bit
//     types), and each kernel reads one tile in both majors (dQ: K in Q.K^T
//     and dS.K; dK/dV: Q and dO), so a wgmma design needs transposed copies.
//   - The tensor cores round each mma's sum toward zero, so a long chain of
//     mma into one accumulator drifts: a first version that chained dV
//     through all of a kv head's 4 x 2048 query rows (hd 128) was 6.6e-4 off
//     on the card, over the 1e-4 tolerance.  dV and dK (and dQ) sum each
//     tile's products in a zeroed accumulator and add that to the running
//     sum in fp32.  Score tiles use at least 4 independent chains.
//   - P and dS never leave registers: the accumulator of a score tile holds
//     columns 2t, 2t + 1 of each 8-column block in lane (g, t), and an A
//     fragment wants columns t and t + 4.  The products sum over that block,
//     so k-slot t is taken as column 2t and k-slot t + 4 as column 2t + 1,
//     in A and in B alike (B reads rows 2t and 2t + 1 of the block).
//   - Tile rows are padded by 4 floats (LD = d + 4), so a warp's loads hit 32
//     distinct banks both ways a tile is read: rows g x columns t (warp_nt's
//     A and B; bank 4g + t) and rows 2t, 2t + 1 x columns g (warp_pv's B;
//     rows 2t apart, bank 8t + g).  Every fragment offset is a compile-time
//     constant, an immediate of the load.  Timed in turns on the card
//     (flash_f32_variants.py), an unpadded tile with an XOR swizzle of its
//     16-byte chunks (as free of conflicts, its offsets computed per load)
//     was 1.05-1.28x slower, and an unpadded, unswizzled one 1.66-2.45x (8
//     lanes to a bank).
//   - 8 warps (256 threads) a CTA, 1 CTA an SM (139-218 KB of shared
//     memory), a cp.async ring of the streamed tiles.  The tile sizes and
//     stages below won the timed variants of flash_f32_variants.py.
//   - Forward: a CTA owns 128 query rows of one (batch, q head), 16 a warp,
//     over K/V tiles of 64 keys in a 3-stage ring (d 64, 96) or 2 (d 128);
//     Q stays in shared memory.  S = Q.K^T goes through warp_nt, the online
//     softmax runs on its accumulators (row max and sum over the 4 lanes of
//     a quad by shuffles), and P enters warp_pv from the registers, so it
//     never touches shared memory; O is rescaled by alpha in fp32 before
//     warp_pv adds the tile's P.V, summed in zeroed accumulators.  At d 256
//     O is 128 registers a thread and Q of 128 rows 133 KB, so the CTA owns
//     64 rows and each row group's two warps take 16 keys each of a 32-key
//     tile in a 2-stage ring, each with its own m, l and O; at the end the
//     second hands its m, l and O to the first through the ring, which
//     merges them in a fixed order: out = (O1 a1 + O2 a2) / (l1 a1 + l2 a2),
//     a = exp(m - max(m1, m2)).  Heaviest causal CTAs first; a warp whose
//     rows all lie before a tile's first key skips the tile.  Timed in turns
//     (flash_f32_variants.py), the forward splits each operand with kTrunc
//     (big = the fp32 word, which the tensor core reads truncated: one
//     operation fewer than rounding it, and P needs no register beside
//     itself), 1.05-1.13x faster than the rounded split, and takes exp(x)
//     as exp2f(x log2 e), 1.05-1.12x faster than expf.  The losers: 32-key
//     tiles at d 128 (1.08x slower) and d 96 (1.07x; a 2-stage ring ties);
//     at d 256 one warp a row group over 16-key tiles in 128-row CTAs
//     (1.09-1.22x) or in 64-row CTAs of 4 warps (1.33x), or 2 chains of the
//     score product (1.04x); splitting each landed K/V tile once into TF32
//     planes that all warps read (1.16-1.34x: twice the tile memory, and a
//     barrier more a tile).
//   - dQ: a CTA owns 128 query rows of one (batch, q head), 16 a warp, over
//     K/V tiles of 64 (d 64, 96) or 32 (d 128) keys in a 2-3 stage ring; Q
//     and dO stay in shared memory.  At d 256 the dQ accumulator is 128
//     registers and Q and dO of 128 rows would be 260 KB, so the CTA owns 64
//     rows and each row group's two warps take 16 keys each of a 32-key
//     tile, single-buffered (1.16-1.18x faster than a 2-stage ring of 16-key
//     tiles, whose Q and dO fragments served one 8-key block per load); their
//     dQ sums meet in shared memory in a fixed order.  Heaviest causal CTAs
//     first; a warp whose keys all lie past its rows skips the tile.
//   - dK/dV: a CTA owns 64 keys of one (batch, kv head) and walks the Q/dO
//     tiles (64 rows in 3 stages; 32 in 3 at d 128, 1.15x faster than 64 in
//     2; 16 in 2 at d 256, 1.30x faster than 32 single-buffered) of its
//     query heads, with their lse and delta.  The keys go to 4 warp pairs
//     of 16: one warp of a pair forms S^T = K.Q^T, P^T and dV += P^T.dO, the
//     other dP^T = V.dO^T and, with
//     P^T handed over through shared memory at a pair barrier, dS^T and
//     dK += dS^T.Q.  So every product is made once (the minimum 4, no column
//     split even at d 256) and a warp holds one d-wide accumulator (128
//     registers at d 256).  A kv head's query heads split over n_split CTAs
//     (pick_dkv_split) writing fp32 partials [2][n_split][B, S, KH, d] into
//     a workspace the wrapper allocates; flash_bwd_dkv_f32_sum_kernel adds
//     them in split order.  Heaviest (lowest) key tiles first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kMasked = -1e30f;  // finite: no inf - inf in the exp bookkeeping
constexpr float kLive = -0.5e30f;  // scores above this are admitted
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kSmemMax = 227 * 1024;

// Floats a tile row takes: d and a 16-byte pad (see the note).
template <int D>
constexpr int LD = D + 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The two warps of pair `pair` (barriers 1-4; 0 is __syncthreads).
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1) : "memory");
}

// All NT threads of the CTA: rows row0 .. row0 + rows - 1 of a [S, *]
// matrix whose rows are `stride` floats apart (d contiguous) into a tile;
// rows at or past S are zero-filled.
template <int D, int NT = kThreads>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long stride,
                                          int row0, int rows, int S) {
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR, row = row0 + r;
    const bool in = row < S;
    cp_async16(dst + r * LD<D> + 4 * c,
               src + (in ? static_cast<long long>(row) * stride : 0) + 4 * c, in ? 16 : 0);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// x ~ big + small as two TF32 operands.  big is x rounded to TF32 to
// nearest, ties away from zero (cvt.rna.tf32.f32's rounding, in two integer
// operations: half of the 13 dropped bits' range added to the magnitude, those
// bits cleared); small = x - big, exact in fp32, of which the tensor core
// reads the top 19 bits (TF32) and drops the rest, so the pair holds x to
// ~2^-21 of it.  With kTrunc, big is the fp32 word itself, which the tensor
// core reads truncated to TF32, and small = x - trunc(x): one operation
// fewer, and no register beside x, for a pair that holds x to ~2^-20.
template <bool kTrunc = false>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  if constexpr (kTrunc) {
    big = __float_as_uint(x);
    small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
  } else {
    big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big));
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32, the small products first.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb[0], bb[1]);
  mma_tf32(c, ab, bs[0], bs[1]);
  mma_tf32(c, ab, bb[0], bb[1]);
}

// One warp: C[16 x 8 NT] += A[16 x D] . B[8 NT x D]^T, A rows a_row0 + 0..15
// and B rows b_row0 + 0..8 NT - 1 of tiles.  C in the m16n8k8 accumulator
// layout:
// lane (g, t) holds c[j][0..1] = C[g][8j + 2t + {0, 1}], c[j][2..3] =
// C[g + 8][same].  The k-steps go round KC sets of accumulators, so at least
// 4 chains of dependent mma run side by side when NT is small.  kTrunc
// selects the split.
template <int NT, int D, bool kTrunc = false>
__device__ __forceinline__ void warp_nt(float (&c)[NT][4], const float* A, int a_row0,
                                        const float* B, int b_row0) {
  constexpr int KC = NT >= 4 ? 1 : 4 / NT;
  static_assert(D % (8 * KC) == 0, "k-steps split evenly over the chains");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = A + (a_row0 + g) * LD<D> + t;
  const float* a1 = a0 + 8 * LD<D>;
  const float* b = B + (b_row0 + g) * LD<D> + t;
  float part[KC][NT][4];
#pragma unroll
  for (int h = 0; h < KC; ++h) zero(part[h]);
#pragma unroll
  for (int kk = 0; kk < D; kk += 8) {
    uint32_t ab[4], as[4];
    split<kTrunc>(a0[kk], ab[0], as[0]);  // columns kk + t
    split<kTrunc>(a1[kk], ab[1], as[1]);
    split<kTrunc>(a0[kk + 4], ab[2], as[2]);  // columns kk + 4 + t
    split<kTrunc>(a1[kk + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bb[2], bs[2];
      split<kTrunc>(b[8 * j * LD<D> + kk], bb[0], bs[0]);
      split<kTrunc>(b[8 * j * LD<D> + kk + 4], bb[1], bs[1]);
      mma3(part[(kk / 8) % KC][j], ab, as, bb, bs);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int h = 0; h < KC; ++h) c[j][e] += part[h][j][e];
}

// One warp: C[16 x D] += P[16 x 8 NK] . B[8 NK x D], P a score tile's
// accumulators p[NK][4] (lane (g, t): columns 2t, 2t + 1 of each 8-column
// block, rows g and g + 8) and B rows b_row0 + 0..8 NK - 1 of a tile.  k-slot
// t of block j is column (row of B) 8j + 2t, k-slot t + 4 column 8j + 2t + 1,
// so P enters as it lies in the registers.
// Each 16 x 8 block of C sums the tile's 3 NK products in a zeroed
// accumulator, then adds it to C in fp32: the tensor cores round every
// product-sum toward zero, so one chain through all of a kv head's query
// tiles drifts past the fp32 tolerance (see the note).  kTrunc selects the
// split.
template <int NK, int D, bool kTrunc = false>
__device__ __forceinline__ void warp_pv(float (&c)[D / 8][4], const float (&p)[NK][4],
                                        const float* B, int b_row0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ab[NK][4], as[NK][4];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    split<kTrunc>(p[j][0], ab[j][0], as[j][0]);  // row g,     k-slot t
    split<kTrunc>(p[j][2], ab[j][1], as[j][1]);  // row g + 8, k-slot t
    split<kTrunc>(p[j][1], ab[j][2], as[j][2]);  // row g,     k-slot t + 4
    split<kTrunc>(p[j][3], ab[j][3], as[j][3]);  // row g + 8, k-slot t + 4
  }
  const float* b0 = B + (b_row0 + 2 * t) * LD<D> + g;  // rows 8j + 2t, columns 8n + g
  const float* b1 = b0 + LD<D>;                         // rows 8j + 2t + 1
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      uint32_t bb[2], bs[2];
      split<kTrunc>(b0[8 * j * LD<D> + 8 * n], bb[0], bs[0]);
      split<kTrunc>(b1[8 * j * LD<D> + 8 * n], bb[1], bs[1]);
      mma3(part, ab[j], as[j], bb, bs);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += part[e];
  }
}

// blockIdx.y, read anew (volatile, so not merged with the kernel's first
// read): the forward's epilogue computes its offsets from it, so no value
// kept from the kernel's start lives across the main loop (at d 256 the
// loop leaves no register for one).
__device__ __forceinline__ int cta_y() {
  int y;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(y));
  return y;
}

// Whether key `col` is admitted by query `row`.
__device__ __forceinline__ bool admitted(int row, int col, int S, int causal,
                                         const int8_t* valid) {
  return row < S && col < S && (!causal || row >= col) && (valid == nullptr || valid[col] != 0);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Over the 4 lanes of a quad (one accumulator row's columns).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
struct FwdPlan {
  static constexpr int WARPS = kWarps;
  static constexpr int ROWS = D <= 128 ? 128 : 64;  // query rows of a CTA
  static constexpr int GROUPS = ROWS / 16;          // 16-row warp groups
  static constexpr int KS = WARPS / GROUPS;         // warps of a group, each on TK / KS keys
  static constexpr int TK = D <= 128 ? 64 : 32;     // keys a K/V tile
  static constexpr int TKW = TK / KS;               // keys of a warp in a tile
  static constexpr int STAGES = D <= 96 ? 3 : 2;
  static constexpr int NS = TKW / 8, NO = D / 8;
  static constexpr bool TRUNC = true;  // big = the fp32 word, read truncated (split)
  static constexpr size_t q_floats = (size_t)ROWS * LD<D>;
  static constexpr size_t stage_floats = (size_t)2 * TK * LD<D>;  // K and V
  static constexpr size_t smem = (q_floats + STAGES * stage_floats) * sizeof(float);
  // A group's second warp hands O (lane-major), m and l to the first.
  static constexpr size_t merge_floats = (size_t)16 * D + 4 * 32;
  static_assert(smem <= kSmemMax, "forward tiles exceed shared memory");
  static_assert(KS * GROUPS == WARPS && TKW % 8 == 0 && D % 32 == 0, "forward plan");
  static_assert(KS <= 2 && (KS == 1 || GROUPS * merge_floats <= STAGES * stage_floats),
                "forward merge");
};

template <int D>
__global__ void __launch_bounds__(FwdPlan<D>::WARPS * 32, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int8_t* __restrict__ valid,
                     float* __restrict__ out, float* __restrict__ lse, int S, int H, int KH,
                     int causal, float scale) {
  using P = FwdPlan<D>;
  constexpr int NT = P::WARPS * 32;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* kv_s = smem + P::q_floats;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp % P::GROUPS, ks = warp / P::GROUPS;
  const int n_qt = (S + P::ROWS - 1) / P::ROWS;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x);
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / (H / KH);
  const int q0 = qt * P::ROWS;
  const long long qstride = (long long)H * D, kstride = (long long)KH * D;
  const long long qoff = (long long)b * S * qstride + (long long)h * D;
  const float* kb = k + (long long)b * S * kstride + (long long)kvh * D;
  const float* vb = v + (long long)b * S * kstride + (long long)kvh * D;
  const int8_t* vld = valid ? valid + (long long)b * S : nullptr;
  // Keys past the CTA's last row are all causally masked.
  const int kend = causal ? min(S, q0 + P::ROWS) : S;
  const int n_tiles = (kend + P::TK - 1) / P::TK;

  load_rows<D, NT>(q_s, q + qoff, qstride, q0, P::ROWS, S);
  auto prefetch = [&](int tile) {
    float* kt = kv_s + (tile % P::STAGES) * P::stage_floats;
    load_rows<D, NT>(kt, kb, kstride, tile * P::TK, P::TK, S);
    load_rows<D, NT>(kt + P::TK * LD<D>, vb, kstride, tile * P::TK, P::TK, S);
  };
#pragma unroll
  for (int s = 0; s < P::STAGES - 1; ++s) {
    if (s < n_tiles) prefetch(s);
    cp_async_commit();
  }

  const int row0 = q0 + 16 * rg;
  const int rowg = row0 + g;  // rows rowg and rowg + 8
  float o[P::NO][4];
  zero(o);
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};
  const int kr0 = ks * P::TKW;  // the warp's first row of each K/V tile

  for (int i = 0; i < n_tiles; ++i) {
    if (i + P::STAGES - 1 < n_tiles) prefetch(i + P::STAGES - 1);
    cp_async_commit();
    cp_async_wait<P::STAGES - 1>();
    __syncthreads();
    const float* kt = kv_s + (i % P::STAGES) * P::stage_floats;
    const float* vt = kt + P::TK * LD<D>;
    const int key0 = i * P::TK + kr0;
    // A warp whose keys all lie past S, or causally past its last row, adds
    // nothing: every score would be masked, alpha 1 and p 0.
    if (key0 < S && !(causal && key0 > row0 + 15)) {
      float s[P::NS][4];
      zero(s);
      warp_nt<P::NS, D, P::TRUNC>(s, q_s, 16 * rg, kt, kr0);  // S = Q.K^T
      float mx[2] = {kMasked, kMasked};
#pragma unroll
      for (int j = 0; j < P::NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, col = key0 + 8 * j + 2 * t + (e & 1);
          s[j][e] = admitted(rowg + 8 * r, col, S, causal, vld) ? s[j][e] * scale : kMasked;
          mx[r] = fmaxf(mx[r], s[j][e]);
        }
      // exp(x) as exp2f(x log2(e)), with -m log2(e) kept per row.
      float alpha[2], sum[2] = {0.f, 0.f}, mneg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
        alpha[r] = exp2f((m_run[r] - m_new) * kLog2e);
        mneg[r] = -m_new * kLog2e;
        m_run[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < P::NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = s[j][e] > kLive ? exp2f(fmaf(s[j][e], kLog2e, mneg[r])) : 0.f;
          sum[r] += p;
          s[j][e] = p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
      for (int n = 0; n < P::NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
      warp_pv<P::NS, D, P::TRUNC>(o, s, vt, kr0);  // O += P.V
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  if constexpr (P::KS > 1) {
    // The second warp of each row group hands m, l and O to the first
    // through the ring (free after the loop's last barrier), lane-major, so
    // the stores and loads hit distinct banks; merged in a fixed order.
    float* red = kv_s + (size_t)rg * P::merge_floats;
    float* stat = red + 16 * D;  // m of rows g, g + 8, then l
    if (ks == 1) {
#pragma unroll
      for (int n = 0; n < P::NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(n * 4 + e) * 32 + lane] = o[n][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        stat[r * 32 + lane] = m_run[r];
        stat[(2 + r) * 32 + lane] = l_run[r];
      }
    }
    __syncthreads();
    if (ks != 0) return;
    float a0[2], a1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = stat[r * 32 + lane], m = fmaxf(m_run[r], m1);
      a0[r] = exp2f((m_run[r] - m) * kLog2e);
      a1[r] = exp2f((m1 - m) * kLog2e);
      l_run[r] = l_run[r] * a0[r] + stat[(2 + r) * 32 + lane] * a1[r];
      m_run[r] = m;
    }
#pragma unroll
    for (int n = 0; n < P::NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = o[n][e] * a0[e >> 1] + red[(n * 4 + e) * 32 + lane] * a1[e >> 1];
  }

  const int bh = cta_y();  // b * H + h
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rowg + 8 * r;
    if (row >= S) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    float* orow = out + ((long long)(bh / H) * S + row) * H * D + (long long)(bh % H) * D;
#pragma unroll
    for (int n = 0; n < P::NO; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(o[n][2 * r] / l, o[n][2 * r + 1] / l);
    if (t == 0) lse[(long long)bh * S + row] = m_run[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int D>
struct DqPlan {
  static constexpr int ROWS = D <= 128 ? 128 : 64;  // query rows of a CTA
  static constexpr int GROUPS = ROWS / 16;          // 16-row warp groups
  static constexpr int KS = kWarps / GROUPS;        // warps of a group, each on TK / KS keys
  static constexpr int TK = D <= 96 ? 64 : 32;  // keys a K/V tile
  static constexpr int TKW = TK / KS;                // keys of a warp in a tile
  static constexpr int STAGES = D == 64 ? 3 : D == 256 ? 1 : 2;
  static constexpr int NS = TKW / 8, NO = D / 8;
  static constexpr size_t rows_floats = (size_t)ROWS * LD<D>;    // Q, and again dO
  static constexpr size_t stage_floats = (size_t)2 * TK * LD<D>;  // K and V
  static constexpr size_t smem = (2 * rows_floats + STAGES * stage_floats) * sizeof(float);
  static_assert(smem <= kSmemMax, "dQ tiles exceed shared memory");
  static_assert(KS * GROUPS == kWarps && TKW % 8 == 0 && D % 32 == 0, "dQ plan");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int8_t* __restrict__ valid, float* __restrict__ dq, int S, int H,
                        int KH, int causal, float scale) {
  using P = DqPlan<D>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = smem + P::rows_floats;
  float* kv_s = smem + 2 * P::rows_floats;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp % P::GROUPS, ks = warp / P::GROUPS;
  const int n_qt = (S + P::ROWS - 1) / P::ROWS;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x);
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / (H / KH);
  const int q0 = qt * P::ROWS;
  const long long qstride = (long long)H * D, kstride = (long long)KH * D;
  const long long qoff = (long long)b * S * qstride + (long long)h * D;
  const float* kb = k + (long long)b * S * kstride + (long long)kvh * D;
  const float* vb = v + (long long)b * S * kstride + (long long)kvh * D;
  const int8_t* vld = valid ? valid + (long long)b * S : nullptr;
  // Keys past the CTA's last row are all causally masked.
  const int kend = causal ? min(S, q0 + P::ROWS) : S;
  const int n_tiles = (kend + P::TK - 1) / P::TK;

  load_rows<D>(q_s, q + qoff, qstride, q0, P::ROWS, S);
  load_rows<D>(do_s, dout + qoff, qstride, q0, P::ROWS, S);
  auto prefetch = [&](int tile) {
    float* kt = kv_s + (tile % P::STAGES) * P::stage_floats;
    load_rows<D>(kt, kb, kstride, tile * P::TK, P::TK, S);
    load_rows<D>(kt + P::TK * LD<D>, vb, kstride, tile * P::TK, P::TK, S);
  };
#pragma unroll
  for (int s = 0; s < P::STAGES - 1; ++s) {
    if (s < n_tiles) prefetch(s);
    cp_async_commit();
  }

  const int row0 = q0 + 16 * rg;
  const int row[2] = {row0 + g, row0 + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = ((long long)b * H + h) * S + row[r];
    lse_r[r] = row[r] < S ? lse[at] : 0.f;
    delta_r[r] = row[r] < S ? delta[at] : 0.f;
  }
  float acc[P::NO][4];
  zero(acc);
  const int kr0 = ks * P::TKW;  // the warp's first row of each K/V tile

  for (int i = 0; i < n_tiles; ++i) {
    if (i + P::STAGES - 1 < n_tiles) prefetch(i + P::STAGES - 1);
    cp_async_commit();
    cp_async_wait<P::STAGES - 1>();
    __syncthreads();
    const float* kt = kv_s + (i % P::STAGES) * P::stage_floats;
    const float* vt = kt + P::TK * LD<D>;
    const int key0 = i * P::TK + kr0;
    // A warp whose keys all lie past S, or causally past its last row, adds nothing.
    if (key0 < S && !(causal && key0 > row0 + 15)) {
      float s[P::NS][4], dp[P::NS][4];
      zero(s);
      zero(dp);
      warp_nt<P::NS, D>(s, q_s, 16 * rg, kt, kr0);    // S = Q.K^T
      warp_nt<P::NS, D>(dp, do_s, 16 * rg, vt, kr0);  // dP = dO.V^T
#pragma unroll
      for (int j = 0; j < P::NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, col = key0 + 8 * j + 2 * t + (e & 1);
          const float x = admitted(row[r], col, S, causal, vld) ? s[j][e] * scale : kMasked;
          const float p = x > kLive ? expf(x - lse_r[r]) : 0.f;
          s[j][e] = p * (dp[j][e] - delta_r[r]) * scale;  // dS
        }
      warp_pv<P::NS, D>(acc, s, kt, kr0);  // dQ += dS.K
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  if constexpr (P::KS > 1) {
    // The second warp of each row group hands its sums to the first through
    // Q's tile (free after the loop's last barrier): lane-major, so the
    // stores and loads hit distinct banks, and added in a fixed order.
    float* red = q_s + (size_t)rg * 16 * D;
    if (ks == 1) {
#pragma unroll
      for (int n = 0; n < P::NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(n * 4 + e) * 32 + lane] = acc[n][e];
    }
    __syncthreads();
    if (ks != 0) return;
#pragma unroll
    for (int n = 0; n < P::NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += red[(n * 4 + e) * 32 + lane];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    float* drow = dq + ((long long)b * S + row[r]) * qstride + (long long)h * D;
#pragma unroll
    for (int n = 0; n < P::NO; ++n)
      *reinterpret_cast<float2*>(drow + 8 * n + 2 * t) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// dK and dV
// ---------------------------------------------------------------------------

template <int D>
struct DkvPlan {
  static constexpr int KEYS = 64;  // keys of a CTA: 4 warp pairs of 16
  static constexpr int TQ = D <= 96 ? 64 : D == 128 ? 32 : 16;  // query rows a Q/dO tile
  static constexpr int STAGES = D <= 128 ? 3 : 2;
  static constexpr int NQ = TQ / 8, NO = D / 8;
  static constexpr size_t kv_floats = (size_t)KEYS * LD<D>;  // K, and again V
  // One stage: the Q tile, the dO tile, then lse and delta of its rows.
  static constexpr size_t stage_floats = (size_t)2 * TQ * LD<D> + 2 * TQ;
  static constexpr size_t xch_floats = (size_t)4 * 32 * NQ * 4;  // P^T of each pair
  static constexpr size_t smem =
      (2 * kv_floats + STAGES * stage_floats + xch_floats) * sizeof(float);
  static_assert(smem <= kSmemMax, "dK/dV tiles exceed shared memory");
  static_assert(stage_floats % 4 == 0 && TQ % 8 == 0 && D % 32 == 0, "dK/dV plan");
};

// kPartial: write fp32 partials of this CTA's query heads into part (dK at
// [split, B, S, KH, d], dV n_split * B * S * KH * d floats after it), else dK
// and dV.
template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int8_t* __restrict__ valid, float* __restrict__ dk,
                         float* __restrict__ dv, float* __restrict__ part, int S, int H, int KH,
                         int n_split, int causal, float scale) {
  using P = DkvPlan<D>;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = smem + P::kv_floats;
  float* stages = smem + 2 * P::kv_floats;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // Role 0 forms S^T, P^T and dV; role 1 dP^T, dS^T and dK, of the same 16 keys.
  const int pair = warp & 3, role = warp >> 2;
  float* xw = stages + P::STAGES * P::stage_floats + pair * (32 * P::NQ * 4);
  const int sp = blockIdx.x % n_split, bkh = blockIdx.x / n_split;
  const int b = bkh / KH, kh = bkh % KH, G = H / KH, gs = G / n_split;
  const int k0 = blockIdx.y * P::KEYS;  // the lowest key tiles, the heaviest when causal, first
  const long long qstride = (long long)H * D, kstride = (long long)KH * D;
  const long long koff = (long long)b * S * kstride + (long long)kh * D;
  const int8_t* vld = valid ? valid + (long long)b * S : nullptr;
  // Query rows below the CTA's first key are all causally masked.
  const int qt0 = causal ? k0 / P::TQ : 0;
  const int nqt = (S + P::TQ - 1) / P::TQ - qt0;
  const int total = gs * nqt;  // (query head, query tile) pairs, head-major

  load_rows<D>(k_s, k + koff, kstride, k0, P::KEYS, S);
  load_rows<D>(v_s, v + koff, kstride, k0, P::KEYS, S);
  auto prefetch = [&](int it) {
    const int hh = kh * G + sp * gs + it / nqt, qs = (qt0 + it % nqt) * P::TQ;
    float* q_t = stages + (it % P::STAGES) * P::stage_floats;
    float* do_t = q_t + P::TQ * LD<D>;
    float* stat = do_t + P::TQ * LD<D>;  // lse, then delta
    const long long qoff = (long long)b * S * qstride + (long long)hh * D;
    load_rows<D>(q_t, q + qoff, qstride, qs, P::TQ, S);
    load_rows<D>(do_t, dout + qoff, qstride, qs, P::TQ, S);
    const long long at = ((long long)b * H + hh) * S;
    for (int i = threadIdx.x; i < 2 * P::TQ; i += kThreads) {
      const int qrow = qs + i % P::TQ;
      const bool in = qrow < S;
      cp_async4(stat + i, (i < P::TQ ? lse : delta) + at + (in ? qrow : 0), in ? 4 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < P::STAGES - 1; ++s) {
    if (s < total) prefetch(s);
    cp_async_commit();
  }

  const int krow0 = 16 * pair;  // the pair's first row of K and V
  const int key[2] = {k0 + krow0 + g, k0 + krow0 + g + 8};
  float acc[P::NO][4];  // dV (role 0) or dK (role 1)
  zero(acc);

  for (int it = 0; it < total; ++it) {
    if (it + P::STAGES - 1 < total) prefetch(it + P::STAGES - 1);
    cp_async_commit();
    cp_async_wait<P::STAGES - 1>();
    __syncthreads();
    const float* q_t = stages + (it % P::STAGES) * P::stage_floats;
    const float* do_t = q_t + P::TQ * LD<D>;
    const float* lse_t = do_t + P::TQ * LD<D>;
    const float* delta_t = lse_t + P::TQ;
    const int qs = (qt0 + it % nqt) * P::TQ;
    // Both warps of a pair skip a tile none of whose queries admits their
    // keys (keys past S, or every query causally before the first key).
    if (k0 + krow0 < S && !(causal && qs + P::TQ - 1 < k0 + krow0)) {
      float st[P::NQ][4];  // rows keys, columns queries
      zero(st);
      if (role == 0) {
        warp_nt<P::NQ, D>(st, k_s, krow0, q_t, 0);  // S^T = K.Q^T
#pragma unroll
        for (int j = 0; j < P::NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = 8 * j + 2 * t + (e & 1);
            const float x =
                admitted(qs + qc, key[e >> 1], S, causal, vld) ? st[j][e] * scale : kMasked;
            const float p = x > kLive ? expf(x - lse_t[qc]) : 0.f;
            st[j][e] = p;
            xw[(j * 4 + e) * 32 + lane] = p;
          }
        pair_sync(pair);
        warp_pv<P::NQ, D>(acc, st, do_t, 0);  // dV += P^T.dO
      } else {
        warp_nt<P::NQ, D>(st, v_s, krow0, do_t, 0);  // dP^T = V.dO^T
        pair_sync(pair);
#pragma unroll
        for (int j = 0; j < P::NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = 8 * j + 2 * t + (e & 1);
            st[j][e] = xw[(j * 4 + e) * 32 + lane] * (st[j][e] - delta_t[qc]) * scale;  // dS^T
          }
        warp_pv<P::NQ, D>(acc, st, q_t, 0);  // dK += dS^T.Q
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  const long long part_n = static_cast<long long>(gridDim.x / n_split) * S * D;
  float* out = kPartial ? part + ((role == 0 ? n_split : 0) + sp) * part_n : (role == 0 ? dv : dk);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= S) continue;
    float* orow = out + ((long long)b * S + key[r]) * kstride + (long long)kh * D;
#pragma unroll
    for (int n = 0; n < P::NO; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// dk[i] = sum over split s = 0, 1, .. of part[s][i], in that order; dv from
// the n_split partials after dK's.  n is a multiple of 4.
__global__ void flash_bwd_dkv_f32_sum_kernel(const float* __restrict__ part,
                                             float* __restrict__ dk, float* __restrict__ dv,
                                             long long n, int n_split) {
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
    *reinterpret_cast<float4*>((m ? dv : dk) + at) = acc;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  const int8_t* valid;
  float *o0, *o1;  // dq / -, or dk / dv
  float* part;     // dK/dV split workspace, or null
  int B, S, H, KH, causal, n_split;
  float scale;
  cudaStream_t stream;
};

template <int D>
int run_fwd(const Args& a, float* lse) {
  using P = FwdPlan<D>;
  auto kernel = flash_fwd_f32_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + P::ROWS - 1) / P::ROWS, a.B * a.H);
  kernel<<<grid, P::WARPS * 32, P::smem, a.stream>>>(a.q, a.k, a.v, a.valid, a.o0, lse, a.S,
                                                     a.H, a.KH, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int run_dq(const Args& a) {
  using P = DqPlan<D>;
  auto kernel = flash_bwd_dq_f32_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + P::ROWS - 1) / P::ROWS, a.B * a.H);
  kernel<<<grid, kThreads, P::smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.valid,
                                                a.o0, a.S, a.H, a.KH, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int run_dkv(const Args& a) {
  using P = DkvPlan<D>;
  const bool partial = a.n_split > 1;
  auto kernel = partial ? flash_bwd_dkv_f32_kernel<D, true> : flash_bwd_dkv_f32_kernel<D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.KH * a.n_split, (a.S + P::KEYS - 1) / P::KEYS);
  kernel<<<grid, kThreads, P::smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.valid,
                                                a.o0, a.o1, a.part, a.S, a.H, a.KH, a.n_split,
                                                a.causal, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !partial) return (int)err;
  const long long n = static_cast<long long>(a.B) * a.S * a.KH * D;
  const long long want = (n / 2 + 255) / 256;  // n / 4 float4s each of dK and dV
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  flash_bwd_dkv_f32_sum_kernel<<<blocks, 256, 0, a.stream>>>(a.part, a.o0, a.o1, n, a.n_split);
  return (int)cudaGetLastError();
}

bool bad_args(int dtype, const Args& a) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                        reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout) |
                        reinterpret_cast<uintptr_t>(a.o0) | reinterpret_cast<uintptr_t>(a.o1);
  return dtype != 0 || a.B <= 0 || a.S <= 0 || a.KH <= 0 || a.H % a.KH != 0 || (mis & 15) != 0;
}

}  // namespace

// dtype 0 (float32) only; hd 64, 96, 128 or 256.  q [B, S, H, hd], k/v
// [B, S, KH, hd], valid [B, S] int8 or null; q, k, v, out 16-byte aligned.
// Writes out [B, S, H, hd] and lse [B, H, S] fp32.  Returns 0 or a
// cudaError_t.
extern "C" int atpu_flash_fwd_f32_sm90(int dtype, const void* q, const void* k, const void* v,
                                       const void* valid, void* out, void* lse, int B, int S,
                                       int H, int KH, int hd, int causal, float scale,
                                       void* stream) {
  const Args a{static_cast<const float*>(q),     static_cast<const float*>(k),
               static_cast<const float*>(v),     nullptr,
               nullptr,                          nullptr,
               static_cast<const int8_t*>(valid), static_cast<float*>(out),
               nullptr,                          nullptr,
               B, S, H, KH, causal, 1, scale, static_cast<cudaStream_t>(stream)};
  if (bad_args(dtype, a) || lse == nullptr || static_cast<long long>(B) * H > 65535)
    return (int)cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 64: return run_fwd<64>(a, l);
    case 96: return run_fwd<96>(a, l);
    case 128: return run_fwd<128>(a, l);
    case 256: return run_fwd<256>(a, l);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype 0 (float32) only; hd 64, 96, 128 or 256.  q, do [B, S, H, hd], k/v
// [B, S, KH, hd], lse/delta [B, H, S] fp32, valid [B, S] int8 or null; q, k,
// v, do, dq 16-byte aligned.  Writes dq [B, S, H, hd].  Returns 0 or a
// cudaError_t.
extern "C" int atpu_flash_bwd_dq_f32_sm90(int dtype, const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          const void* valid, void* dq, int B, int S, int H,
                                          int KH, int hd, int causal, float scale, void* stream) {
  const Args a{static_cast<const float*>(q),     static_cast<const float*>(k),
               static_cast<const float*>(v),     static_cast<const float*>(dout),
               static_cast<const float*>(lse),   static_cast<const float*>(delta),
               static_cast<const int8_t*>(valid), static_cast<float*>(dq),
               nullptr,                          nullptr,
               B, S, H, KH, causal, 1, scale, static_cast<cudaStream_t>(stream)};
  if (bad_args(dtype, a) || static_cast<long long>(B) * H > 65535) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64: return run_dq<64>(a);
    case 96: return run_dq<96>(a);
    case 128: return run_dq<128>(a);
    case 256: return run_dq<256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Arguments as atpu_flash_bwd_dq_f32_sm90, writing dk and dv [B, S, KH, hd]
// (summed over each kv head's query heads), plus part, the fp32 workspace of
// 2 x n_split x B x S x KH x hd floats (16-byte aligned; null when n_split is
// 1), and n_split, which divides H / KH.  Launches the dK/dV kernel and, when
// n_split > 1, the sum kernel after it on the same stream.  Returns 0 or a
// cudaError_t.
extern "C" int atpu_flash_bwd_dkv_f32_sm90(int dtype, const void* q, const void* k,
                                           const void* v, const void* dout, const void* lse,
                                           const void* delta, const void* valid, void* dk,
                                           void* dv, void* part, int B, int S, int H, int KH,
                                           int hd, int causal, int n_split, float scale,
                                           void* stream) {
  const Args a{static_cast<const float*>(q),     static_cast<const float*>(k),
               static_cast<const float*>(v),     static_cast<const float*>(dout),
               static_cast<const float*>(lse),   static_cast<const float*>(delta),
               static_cast<const int8_t*>(valid), static_cast<float*>(dk),
               static_cast<float*>(dv),          static_cast<float*>(part),
               B, S, H, KH, causal, n_split, scale, static_cast<cudaStream_t>(stream)};
  if (bad_args(dtype, a) || n_split < 1 || (H / KH) % n_split != 0 || (S + 63) / 64 > 65535 ||
      (n_split > 1 && (part == nullptr || (reinterpret_cast<uintptr_t>(part) & 15) != 0)) ||
      static_cast<long long>(B) * KH * n_split > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64: return run_dkv<64>(a);
    case 96: return run_dkv<96>(a);
    case 128: return run_dkv<128>(a);
    case 256: return run_dkv<256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
