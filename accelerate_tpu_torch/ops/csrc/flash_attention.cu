// Flash attention for Hopper (sm_90a): the training forward and its two
// backward kernels, for causal or full GQA attention with an optional key
// validity mask.
//
// Replaces (accelerate_tpu/ops/pallas_attention.py):
//   atpu_flash_fwd     -> _fwd_kernel (:96), launched by _flash_fwd (:174)
//   atpu_flash_bwd_dq  -> _bwd_dq_kernel (:206), launched by _flash_bwd (:338)
//   atpu_flash_bwd_dkv -> _bwd_dkv_kernel (:258), launched by _flash_bwd (:361),
//                         with the GQA group sum of :388 folded in
//
// Layouts are the public ones of the port (no transposes around the calls):
//   q, out, do, dq [B, S, H, d]; k, v, dk, dv [B, S, KH, d]; query head h
//   reads kv head h / (H / KH); lse, delta [B, H, S] fp32; valid [B, S] int8
//   (nullable).  All of q, k, v, do, out, dq, dk, dv share one dtype.
//
// What each computes, per query row i and key j (scale = 1 / sqrt(d)):
//   s_ij = (q_i . k_j) * scale, accumulated in fp32, or -1e30 where the pair
//          is masked (key past S, causal j > i, or valid[j] == 0);
//   a probability is gated on the masked score (s > -0.5e30), never on the
//   running max, so a row with no admitted key has l = 0, output 0, lse ~
//   -1e30 and zero gradients, as in the TPU kernels;
//   forward:  online softmax over key tiles, P cast to v's dtype before P.V,
//             out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30));
//   dQ:       p = exp(s - lse), dP = dO.V^T in fp32, dS = p * (dP - delta) *
//             scale cast to k's dtype, dQ = sum_j dS.K;
//   dK/dV:    dV = sum_i p^T.dO with p kept in fp32 (dO is fp32 in the TPU
//             kernel, so this product is fp32 there); dK = sum_i dS^T.Q with
//             dS cast to q's dtype; summed over the G query heads of a kv
//             head in fp32 registers, then cast.
//
// Bound on this card.  At the training shapes (S 2048, d 128) attention is
// compute-bound: a causal forward does 2 products of 2*B*H*S^2*d/2 flops on
// bytes that are read once, ~800 flops per byte in bf16, far above the
// H100's ~295 flop/byte ridge.  The least time is flops / 989 TFLOP/s (bf16, fp16) or /
// 67 TFLOP/s (fp32, CUDA cores; no TF32, the fp32 tolerances assume it); the
// backward's least work is 5 such products (chip_smoke.py computes both).
//
// Design (a first, simple one; wgmma, TMA and warp specialisation are later
// work):
//   - one CTA of 4 warps per (64-row tile, batch, head): query rows for the
//     forward and dQ, key rows for dK/dV; each warp owns 16 rows, the M of
//     one mma.sync m16n8k16, and keeps its row's softmax state, its output
//     accumulator and its score tile in registers, in the mma accumulator
//     layout;
//   - the streamed operand (K/V tiles of 64 keys; for dK/dV, Q/dO tiles of
//     32 rows with their lse and delta) is double-buffered in shared memory
//     with 16-byte cp.async copies, rows padded by 16 bytes so the fragment
//     loads of a warp hit distinct banks;
//   - bf16 and fp16 products run on the tensor cores (mma.sync, fp32
//     accumulation); fp32 products run as fp32 FMAs on the CUDA cores with
//     the same accumulator layout, so one kernel body serves all types;
//   - a score tile becomes probabilities in registers (row max and sum over
//     the 4 lanes of a quad by shuffles), is written to the warp's own
//     shared-memory strip in the operand type, and is read back as the A
//     operand of the next product, so no block barrier sits between them;
//   - causal tiles wholly above the diagonal are never visited; the skip is
//     derived from row and key positions, not from tile indices;
//   - dQ has its own kernel and dK/dV one CTA per kv head looping over its G
//     query heads, so no atomics: results are deterministic;
//   - dV's fp32 p^T.dO product splits p into two parts of the operand type
//     (p = hi + lo) and runs two tensor-core products, keeping ~16 bits of
//     p instead of 8 (bf16) or 11 (fp16).
//
// Head dims 64, 96, 128 and 256, in all three types.  On the training path
// only fp32 runs this body: bf16 and fp16 at every head dim run the sm90
// kernels of flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu and flash_bwd_dkv_sm90.cu
// (the wrapper routes them), and this body's 16-bit instantiations are on no
// path, kept as the yardstick chip_smoke.py times the sm90 bodies against
// (previous_ms).  What the wide heads change:
//   - d 256 holds a 16 x 256 fp32 accumulator per warp, 128 registers a
//     thread, so the forward and dQ stream 32-key tiles (fewer score
//     registers beside it), and 16-key tiles for fp32 dQ, whose Q, dO and
//     two K/V stages of 260-float rows would not fit shared memory at 32;
//   - dK and dV of all 256 columns would need 256 accumulator registers a
//     thread: two CTAs (grid z) each own 128 columns of both and recompute
//     the full-d scores S^T and dP^T from the same shared-memory tiles
//     (1.5x the products of one CTA; a simple split, not a fast one);
//     fp32 streams 16-row Q/dO tiles, as 32 would exceed shared memory;
//   - d 96 is 6 k-steps of 16 and 12 n-tiles of 8; its padded rows (104
//     16-bit or 100 fp32 elements) still start on 16-byte boundaries for
//     cp.async and put the 8 fragment rows of a warp in distinct banks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;  // rows of a CTA tile: 16 per warp
constexpr int kTileK = 64;          // keys per streamed K/V tile (forward, dQ), d <= 128
constexpr int kTileQ = 32;          // query rows per streamed Q/dO tile (dK/dV)
constexpr int kOutCols = 128;       // dK/dV columns one CTA accumulates
constexpr float kMasked = -1e30f;   // finite: no inf - inf in the exp bookkeeping
constexpr float kLive = -0.5e30f;   // scores above this are admitted
constexpr size_t kSmemMax = 227 * 1024;

template <typename T>
constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));  // one 16-byte vector of padding per row
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half(x); }

__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }
__device__ __forceinline__ uint32_t bits16(__half x) { return __half_as_ushort(x); }

template <typename T>
__device__ __forceinline__ uint32_t pack2(T lo, T hi) {
  return bits16(lo) | (bits16(hi) << 16);
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16-byte asynchronous copy to shared memory; src_bytes = 0 writes zeros (a
// row past the sequence end).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// All threads of the CTA: rows row0 .. row0 + rows - 1 of a [S, *] matrix
// whose rows are `stride` elements apart (D contiguous) into shared memory
// with row stride ld; rows at or past S are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, long long stride,
                                          int row0, int rows, int S) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int idx = threadIdx.x; idx < rows * VPR; idx += kThreads) {
    const int r = idx / VPR, c = (idx % VPR) * VEC;
    const int row = row0 + r;
    const bool in = row < S;
    cp_async16(dst + r * ld + c, src + (in ? (long long)row * stride : 0) + c, in ? 16 : 0);
  }
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: C[16 x 8*NT] += A[16 x K] . B[K x 8*NT], C in fp32 registers in
// the mma.sync m16n8k16 accumulator layout: lane (g = lane / 4, t = lane % 4)
// holds c[j][0..1] = C[g][8j + 2t + {0, 1}], c[j][2..3] = C[g + 8][same].
// A is row-major in shared memory (A[m * lda + k]) of type TA: T, or float
// for the split product (16-bit T only: each element enters as hi + lo).
// B(k, n) = B[n * ldb + k] when BT (B's rows are n), else B[k * ldb + n].
template <typename T, int NT, int K, bool BT, typename TA = T>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const TA* A, int lda, const T* B,
                                         int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
    const float* a0p = A + g * lda;
    const float* a1p = A + (g + 8) * lda;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = a0p[k], a1 = a1p[k];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + 2 * t;
        float b0, b1;
        if constexpr (BT) {
          b0 = B[n * ldb + k];
          b1 = B[(n + 1) * ldb + k];
        } else {
          const float2 bb = *reinterpret_cast<const float2*>(B + k * ldb + n);
          b0 = bb.x;
          b1 = bb.y;
        }
        c[j][0] = fmaf(a0, b0, c[j][0]);
        c[j][1] = fmaf(a0, b1, c[j][1]);
        c[j][2] = fmaf(a1, b0, c[j][2]);
        c[j][3] = fmaf(a1, b1, c[j][3]);
      }
    }
  } else {
    constexpr bool kSplit = std::is_same<TA, float>::value;
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      const int k0 = kk + 2 * t;
      uint32_t a[4], a_lo[4];
      const int offs[4] = {g * lda + k0, (g + 8) * lda + k0, g * lda + k0 + 8,
                           (g + 8) * lda + k0 + 8};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (kSplit) {
          const float2 x = *reinterpret_cast<const float2*>(A + offs[r]);
          const T h0 = from_float<T>(x.x), h1 = from_float<T>(x.y);
          a[r] = pack2(h0, h1);
          a_lo[r] = pack2(from_float<T>(x.x - to_float(h0)), from_float<T>(x.y - to_float(h1)));
        } else {
          a[r] = ld32(A + offs[r]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + g;
        uint32_t b0, b1;
        if constexpr (BT) {
          b0 = ld32(B + n * ldb + k0);
          b1 = ld32(B + n * ldb + k0 + 8);
        } else {
          b0 = pack2(B[k0 * ldb + n], B[(k0 + 1) * ldb + n]);
          b1 = pack2(B[(k0 + 8) * ldb + n], B[(k0 + 9) * ldb + n]);
        }
        mma16816<T>(c[j], a, b0, b1);
        if constexpr (kSplit) mma16816<T>(c[j], a_lo, b0, b1);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// Whether key `col` is admitted by query `row`.
__device__ __forceinline__ bool admitted(int row, int col, int S, int causal,
                                         const int8_t* valid) {
  return row < S && col < S && (!causal || row >= col) && (valid == nullptr || valid[col] != 0);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Shared memory of a forward (rows = 1: Q) or dQ (rows = 2: Q, dO) CTA
// streaming K/V tiles of tk keys: its row tiles, two stages of K and V, and
// the P (dS) strips.
template <typename T, int D>
constexpr size_t key_tile_smem(int rows, int tk) {
  return ((size_t)(rows * kRows + 4 * tk) * (D + pad<T>()) + (size_t)kRows * (tk + pad<T>())) *
         sizeof(T);
}

// Keys per streamed K/V tile: 64 up to d 128; at wider heads 32, which keeps
// the score tiles' registers few beside the d-wide accumulator, halved again
// while the CTA's tiles exceed shared memory (dQ in fp32 at d 256: 16).
template <typename T, int D>
constexpr int key_tile(int rows) {
  int tk = D <= 128 ? kTileK : kTileK / 2;
  while (tk > 16 && key_tile_smem<T, D>(rows, tk) > kSmemMax) tk /= 2;
  return tk;
}

template <typename T, int D>
struct FwdPlan {
  static constexpr int TK = key_tile<T, D>(1);
  static constexpr int LD = D + pad<T>();    // Q/K/V tile row stride
  static constexpr int LDP = TK + pad<T>();  // P strip row stride
  static constexpr size_t q_bytes = (size_t)kRows * LD * sizeof(T);
  static constexpr size_t kv_bytes = (size_t)2 * TK * LD * sizeof(T);  // one stage: K, V
  static constexpr size_t p_bytes = (size_t)kRows * LDP * sizeof(T);
  static constexpr size_t smem = q_bytes + 2 * kv_bytes + p_bytes;
  static_assert(smem <= kSmemMax, "forward tiles exceed shared memory");
  static_assert(D % 16 == 0 && TK % 16 == 0, "products step k by 16");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int8_t* __restrict__ valid, T* __restrict__ out, float* __restrict__ lse,
                 int S, int H, int KH, int causal, float scale) {
  using P = FwdPlan<T, D>;
  constexpr int TK = P::TK, LD = P::LD, LDP = P::LDP, NS = TK / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* kv_s = reinterpret_cast<T*>(smem + P::q_bytes);
  T* p_s = reinterpret_cast<T*>(smem + P::q_bytes + 2 * P::kv_bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / (H / KH);
  const int q0 = blockIdx.x * kRows;
  const long long qstride = (long long)H * D, kstride = (long long)KH * D;
  const T* qb = q + (long long)b * S * qstride + (long long)h * D;
  const T* kb = k + (long long)b * S * kstride + (long long)kh * D;
  const T* vb = v + (long long)b * S * kstride + (long long)kh * D;
  const int8_t* vld = valid ? valid + (long long)b * S : nullptr;
  // Keys past the tile's last query row are all causally masked.
  const int kend = causal ? min(S, q0 + kRows) : S;
  const int n_tiles = (kend + TK - 1) / TK;

  load_rows<T, D>(q_s, LD, qb, qstride, q0, kRows, S);
  auto prefetch = [&](int tile) {
    T* k_t = kv_s + (tile & 1) * 2 * TK * LD;
    load_rows<T, D>(k_t, LD, kb, kstride, tile * TK, TK, S);
    load_rows<T, D>(k_t + TK * LD, LD, vb, kstride, tile * TK, TK, S);
  };
  prefetch(0);
  cp_async_commit();

  float o[NO][4];
  zero(o);
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const T* q_w = q_s + warp * 16 * LD;
  T* p_w = p_s + warp * 16 * LDP;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) prefetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* k_t = kv_s + (i & 1) * 2 * TK * LD;
    const T* v_t = k_t + TK * LD;
    float s[NS][4];
    zero(s);
    warp_mma<T, NS, D, true>(s, q_w, LD, k_t, LD);
    const int key0 = i * TK;
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = key0 + 8 * j + 2 * t + (e & 1);
        s[j][e] = admitted(row[r], col, S, causal, vld) ? s[j][e] * scale : kMasked;
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    float m_new[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_run[r], quad_max(mx[r]));
      alpha[r] = expf(m_run[r] - m_new[r]);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = s[j][e] > kLive ? expf(s[j][e] - m_new[r]) : 0.f;
        sum[r] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * alpha[r] + quad_sum(sum[r]);
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p_w[(g + 8 * (e >> 1)) * LDP + 8 * j + 2 * t + (e & 1)] = from_float<T>(s[j][e]);
    __syncwarp();
    warp_mma<T, NO, TK, false>(o, p_w, LDP, v_t, LD);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    T* orow = out + ((long long)b * S + row[r]) * qstride + (long long)h * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      orow[8 * j + 2 * t] = from_float<T>(o[j][2 * r] / l);
      orow[8 * j + 2 * t + 1] = from_float<T>(o[j][2 * r + 1] / l);
    }
    if (t == 0) lse[((long long)b * H + h) * S + row[r]] = m_run[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// backward: dQ
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DqPlan {
  static constexpr int TK = key_tile<T, D>(2);
  static constexpr int LD = D + pad<T>();
  static constexpr int LDP = TK + pad<T>();  // dS strip row stride
  static constexpr size_t q_bytes = (size_t)kRows * LD * sizeof(T);  // Q, and again dO
  static constexpr size_t kv_bytes = (size_t)2 * TK * LD * sizeof(T);
  static constexpr size_t ds_bytes = (size_t)kRows * LDP * sizeof(T);
  static constexpr size_t smem = 2 * q_bytes + 2 * kv_bytes + ds_bytes;
  static_assert(smem <= kSmemMax, "dQ tiles exceed shared memory");
  static_assert(D % 16 == 0 && TK % 16 == 0, "products step k by 16");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int8_t* __restrict__ valid,
                    T* __restrict__ dq, int S, int H, int KH, int causal, float scale) {
  using P = DqPlan<T, D>;
  constexpr int TK = P::TK, LD = P::LD, LDP = P::LDP, NS = TK / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = reinterpret_cast<T*>(smem + P::q_bytes);
  T* kv_s = reinterpret_cast<T*>(smem + 2 * P::q_bytes);
  T* ds_s = reinterpret_cast<T*>(smem + 2 * P::q_bytes + 2 * P::kv_bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / (H / KH);
  const int q0 = blockIdx.x * kRows;
  const long long qstride = (long long)H * D, kstride = (long long)KH * D;
  const long long qoff = (long long)b * S * qstride + (long long)h * D;
  const T* kb = k + (long long)b * S * kstride + (long long)kh * D;
  const T* vb = v + (long long)b * S * kstride + (long long)kh * D;
  const int8_t* vld = valid ? valid + (long long)b * S : nullptr;
  const int kend = causal ? min(S, q0 + kRows) : S;
  const int n_tiles = (kend + TK - 1) / TK;

  load_rows<T, D>(q_s, LD, q + qoff, qstride, q0, kRows, S);
  load_rows<T, D>(do_s, LD, dout + qoff, qstride, q0, kRows, S);
  auto prefetch = [&](int tile) {
    T* k_t = kv_s + (tile & 1) * 2 * TK * LD;
    load_rows<T, D>(k_t, LD, kb, kstride, tile * TK, TK, S);
    load_rows<T, D>(k_t + TK * LD, LD, vb, kstride, tile * TK, TK, S);
  };
  prefetch(0);
  cp_async_commit();

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = ((long long)b * H + h) * S + row[r];
    lse_r[r] = row[r] < S ? lse[at] : 0.f;
    delta_r[r] = row[r] < S ? delta[at] : 0.f;
  }
  float acc[NO][4];
  zero(acc);
  const T* q_w = q_s + warp * 16 * LD;
  const T* do_w = do_s + warp * 16 * LD;
  T* ds_w = ds_s + warp * 16 * LDP;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) prefetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* k_t = kv_s + (i & 1) * 2 * TK * LD;
    const T* v_t = k_t + TK * LD;
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
    warp_mma<T, NS, D, true>(s, q_w, LD, k_t, LD);
    warp_mma<T, NS, D, true>(dp, do_w, LD, v_t, LD);
    const int key0 = i * TK;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = key0 + 8 * j + 2 * t + (e & 1);
        const float x = admitted(row[r], col, S, causal, vld) ? s[j][e] * scale : kMasked;
        const float p = x > kLive ? expf(x - lse_r[r]) : 0.f;
        const float ds = p * (dp[j][e] - delta_r[r]) * scale;
        ds_w[(g + 8 * r) * LDP + 8 * j + 2 * t + (e & 1)] = from_float<T>(ds);
      }
    __syncwarp();
    warp_mma<T, NO, TK, false>(acc, ds_w, LDP, k_t, LD);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    T* drow = dq + ((long long)b * S + row[r]) * qstride + (long long)h * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      drow[8 * j + 2 * t] = from_float<T>(acc[j][2 * r]);
      drow[8 * j + 2 * t + 1] = from_float<T>(acc[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dK and dV
// ---------------------------------------------------------------------------

// Shared memory of a dK/dV CTA streaming Q/dO tiles of tq rows: K and V,
// two stages of Q, dO, lse and delta, the p^T (fp32) and dS^T strips.
template <typename T, int D>
constexpr size_t query_tile_smem(int tq) {
  return (size_t)(2 * kRows + 4 * tq) * (D + pad<T>()) * sizeof(T) + (size_t)4 * tq * 4 +
         (size_t)kRows * (tq + 4) * 4 + (size_t)kRows * (tq + pad<T>()) * sizeof(T);
}

// Query rows per streamed Q/dO tile: 32, halved while the CTA's tiles exceed
// shared memory (fp32 at d 256: 16).
template <typename T, int D>
constexpr int query_tile() {
  int tq = kTileQ;
  while (tq > 16 && query_tile_smem<T, D>(tq) > kSmemMax) tq /= 2;
  return tq;
}

// A dK/dV CTA accumulates DO = min(d, 128) columns of dK and dV: at d 256
// the two accumulators of all d would need 256 fp32 registers a thread, so
// two CTAs split the columns, and each recomputes the full-d scores S^T and
// dP^T from its shared-memory tiles.
template <typename T, int D>
struct DkvPlan {
  static constexpr int TQ = query_tile<T, D>();
  static constexpr int DO = D < kOutCols ? D : kOutCols;
  static constexpr int SPLITS = D / DO;
  static constexpr int LD = D + pad<T>();
  static constexpr int LDS = TQ + pad<T>();  // dS^T strip row stride (operand type)
  static constexpr int LDF = TQ + 4;         // p^T strip row stride (fp32)
  static constexpr size_t kv_bytes = (size_t)kRows * LD * sizeof(T);  // K, and again V
  // One stage: Q tile, dO tile, then lse and delta of its rows.
  static constexpr size_t stage_bytes =
      (size_t)2 * TQ * LD * sizeof(T) + (size_t)2 * TQ * sizeof(float);
  static constexpr size_t pf_bytes = (size_t)kRows * LDF * sizeof(float);
  static constexpr size_t ds_bytes = (size_t)kRows * LDS * sizeof(T);
  static constexpr size_t smem = 2 * kv_bytes + 2 * stage_bytes + pf_bytes + ds_bytes;
  static_assert(smem <= kSmemMax, "dK/dV tiles exceed shared memory");
  static_assert(stage_bytes % 16 == 0, "stages must stay 16-byte aligned");
  static_assert(D % 16 == 0 && TQ % 16 == 0 && D % DO == 0, "products step k by 16");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int8_t* __restrict__ valid,
                     T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KH, int causal,
                     float scale) {
  using P = DkvPlan<T, D>;
  constexpr int TQ = P::TQ, LD = P::LD, LDS = P::LDS, LDF = P::LDF, NQ = TQ / 8, NO = P::DO / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + P::kv_bytes);
  unsigned char* stages = smem + 2 * P::kv_bytes;
  float* pf_s = reinterpret_cast<float*>(stages + 2 * P::stage_bytes);
  T* ds_s = reinterpret_cast<T*>(stages + 2 * P::stage_bytes + P::pf_bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH, G = H / KH;
  const int k0 = blockIdx.x * kRows;
  const int col0 = blockIdx.z * P::DO;  // this CTA's columns of dK and dV
  const long long qstride = (long long)H * D, kstride = (long long)KH * D;
  const long long koff = (long long)b * S * kstride + (long long)kh * D;
  const int8_t* vld = valid ? valid + (long long)b * S : nullptr;
  // Query rows below the tile's first key are all causally masked.
  const int qt0 = causal ? k0 / TQ : 0;
  const int nqt = (S + TQ - 1) / TQ - qt0;
  const int total = G * nqt;  // (query head, query tile) pairs, head-major

  load_rows<T, D>(k_s, LD, k + koff, kstride, k0, kRows, S);
  load_rows<T, D>(v_s, LD, v + koff, kstride, k0, kRows, S);
  auto stage_q = [&](int it) { return reinterpret_cast<T*>(stages + (it & 1) * P::stage_bytes); };
  auto prefetch = [&](int it) {
    const int hh = kh * G + it / nqt, qs = (qt0 + it % nqt) * TQ;
    T* q_t = stage_q(it);
    T* do_t = q_t + TQ * LD;
    float* lse_t = reinterpret_cast<float*>(do_t + TQ * LD);
    const long long qoff = (long long)b * S * qstride + (long long)hh * D;
    load_rows<T, D>(q_t, LD, q + qoff, qstride, qs, TQ, S);
    load_rows<T, D>(do_t, LD, dout + qoff, qstride, qs, TQ, S);
    // lse and delta of the tile's rows, by plain loads: the stage is free
    // (its last reader finished before the previous block barrier) and the
    // barrier before its use publishes them.
    const long long at = ((long long)b * H + hh) * S;
    for (int i = threadIdx.x; i < 2 * TQ; i += kThreads) {
      const int r = i % TQ, qrow = qs + r;
      const float* src = i < TQ ? lse : delta;
      lse_t[i] = qrow < S ? src[at + qrow] : 0.f;
    }
  };
  prefetch(0);
  cp_async_commit();

  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk_acc[NO][4], dv_acc[NO][4];
  zero(dk_acc);
  zero(dv_acc);
  const T* k_w = k_s + warp * 16 * LD;
  const T* v_w = v_s + warp * 16 * LD;
  float* pf_w = pf_s + warp * 16 * LDF;
  T* ds_w = ds_s + warp * 16 * LDS;

  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) prefetch(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* q_t = stage_q(it);
    const T* do_t = q_t + TQ * LD;
    const float* lse_t = reinterpret_cast<const float*>(do_t + TQ * LD);
    const float* delta_t = lse_t + TQ;
    const int qs = (qt0 + it % nqt) * TQ;
    float st[NQ][4], dpt[NQ][4];
    zero(st);
    zero(dpt);
    warp_mma<T, NQ, D, true>(st, k_w, LD, q_t, LD);    // S^T: rows keys, columns queries
    warp_mma<T, NQ, D, true>(dpt, v_w, LD, do_t, LD);  // dP^T = V . dO^T
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, qc = 8 * j + 2 * t + (e & 1);
        const float x = admitted(qs + qc, key[r], S, causal, vld) ? st[j][e] * scale : kMasked;
        const float p = x > kLive ? expf(x - lse_t[qc]) : 0.f;
        const float ds = p * (dpt[j][e] - delta_t[qc]) * scale;
        pf_w[(g + 8 * r) * LDF + qc] = p;
        ds_w[(g + 8 * r) * LDS + qc] = from_float<T>(ds);
      }
    __syncwarp();
    warp_mma<T, NO, TQ, false, float>(dv_acc, pf_w, LDF, do_t + col0, LD);
    warp_mma<T, NO, TQ, false>(dk_acc, ds_w, LDS, q_t + col0, LD);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= S) continue;
    const long long at = ((long long)b * S + key[r]) * kstride + (long long)kh * D + col0;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      dk[at + 8 * j + 2 * t] = from_float<T>(dk_acc[j][2 * r]);
      dk[at + 8 * j + 2 * t + 1] = from_float<T>(dk_acc[j][2 * r + 1]);
      dv[at + 8 * j + 2 * t] = from_float<T>(dv_acc[j][2 * r]);
      dv[at + 8 * j + 2 * t + 1] = from_float<T>(dv_acc[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* lse_in;
  const void* delta;
  const void* valid;
  void* o0;  // out / dq / dk
  void* o1;  // lse / - / dv
  int B, S, H, KH, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
struct Fwd {
  static int run(const Args& a) {
    auto kernel = flash_fwd_kernel<T, D>;
    const size_t smem = FwdPlan<T, D>::smem;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.S + kRows - 1) / kRows, a.B * a.H);
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const int8_t*>(a.valid), static_cast<T*>(a.o0), static_cast<float*>(a.o1),
        a.S, a.H, a.KH, a.causal, a.scale);
    return (int)cudaGetLastError();
  }
};

template <typename T, int D>
struct BwdDq {
  static int run(const Args& a) {
    auto kernel = flash_bwd_dq_kernel<T, D>;
    const size_t smem = DqPlan<T, D>::smem;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.S + kRows - 1) / kRows, a.B * a.H);
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta), static_cast<const int8_t*>(a.valid),
        static_cast<T*>(a.o0), a.S, a.H, a.KH, a.causal, a.scale);
    return (int)cudaGetLastError();
  }
};

template <typename T, int D>
struct BwdDkv {
  static int run(const Args& a) {
    auto kernel = flash_bwd_dkv_kernel<T, D>;
    const size_t smem = DkvPlan<T, D>::smem;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.S + kRows - 1) / kRows, a.B * a.KH, DkvPlan<T, D>::SPLITS);
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta), static_cast<const int8_t*>(a.valid),
        static_cast<T*>(a.o0), static_cast<T*>(a.o1), a.S, a.H, a.KH, a.causal, a.scale);
    return (int)cudaGetLastError();
  }
};

// dtype: 0 float32, 1 bfloat16, 2 float16; head dim 64, 96, 128 or 256.
template <template <typename, int> class Op, typename T>
int dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 64: return Op<T, 64>::run(a);
    case 96: return Op<T, 96>::run(a);
    case 128: return Op<T, 128>::run(a);
    case 256: return Op<T, 256>::run(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <template <typename, int> class Op>
int dispatch(int dtype, int hd, const Args& a) {
  if (a.B <= 0 || a.S <= 0 || a.KH <= 0 || a.H % a.KH != 0 || a.B * a.H > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return dispatch_hd<Op, float>(hd, a);
    case 1: return dispatch_hd<Op, __nv_bfloat16>(hd, a);
    case 2: return dispatch_hd<Op, __half>(hd, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, S, H, hd], k/v [B, S, KH, hd], valid [B, S] int8 or null; writes out
// [B, S, H, hd] and lse [B, H, S] fp32.  Returns cudaGetLastError().
extern "C" int atpu_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                              const void* valid, void* out, void* lse, int B, int S, int H,
                              int KH, int hd, int causal, float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, valid, out, lse, B, S, H, KH, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch<Fwd>(dtype, hd, a);
}

// q, do [B, S, H, hd], k/v [B, S, KH, hd], lse/delta [B, H, S] fp32, valid as
// above; writes dq [B, S, H, hd].  Returns cudaGetLastError().
extern "C" int atpu_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 const void* valid, void* dq, int B, int S, int H, int KH, int hd,
                                 int causal, float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, valid, dq, nullptr, B, S, H, KH, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch<BwdDq>(dtype, hd, a);
}

// Inputs as atpu_flash_bwd_dq; writes dk and dv [B, S, KH, hd] (summed over
// each kv head's query heads).  Returns cudaGetLastError().
extern "C" int atpu_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  const void* valid, void* dk, void* dv, int B, int S, int H,
                                  int KH, int hd, int causal, float scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, valid, dk, dv, B, S, H, KH, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch<BwdDkv>(dtype, hd, a);
}
