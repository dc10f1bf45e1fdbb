// Paged decode attention for Hopper (sm_90a), split over each slot's keys
// (flash-decoding): one token per slot, or a W-token speculative verify
// window, read straight out of the serving engine's block pool through
// per-slot block tables.
//
// Replaces (accelerate_tpu/ops/pallas_attention.py):
//   atpu_paged_attention_sm90        -> _paged_kernel (:564), launched by
//                                       pallas_paged_attention (:621)
//   atpu_paged_window_attention_sm90 -> _paged_window_kernel (:686), launched
//                                       by pallas_paged_window_attention (:760)
// Both launchers run the same two kernels; W = 1 is the single-token kernel.
// (paged_attention.cu, the body this file replaces, one CTA per slot and kv
// head, is kept only as a timing yardstick for chip_smoke.py.)
//
// What it computes, per slot b and query head h (kv head h / G):
//   keys  = pool rows at positions 0 .. lengths[b]-1 (through tables[b]),
//           then the W new rows at positions lengths[b] .. lengths[b]+W-1
//   query at window position w admits every pool row and new rows kw <= w
//   out   = softmax(q . k / sqrt(hd)) . v in fp32, l floored at 1e-30,
//           written in the input dtype.
// Pool positions >= lengths[b] are never read (they are stale: the caller
// scatters this dispatch's rows there afterwards), and table entries past
// ceil(lengths[b] / bs) are never touched.
//
// Bound on this card.  Decode is memory-bound: every pool byte is used by
// G*W query rows for 2 flops per element, far below the ~295 flop/byte
// ridge of the H100.  The least time is
//   bytes = sum_b min(lengths[b], M*bs) * KH * hd * 2 * sizeof(pool dtype)
//         + q + k_new + v_new + out + tables + lengths
//   time  = bytes / 3.35 TB/s
// (chip_smoke.py computes it from each run's inputs).  Reaching it needs
// enough bytes in flight on every SM, so a long slot must be streamed by
// many CTAs, not by the KH CTAs of its own kv heads.
//
// What the design does about that bound:
//   - split kernel, grid (slot x kv head, split, group of 16 query rows): a
//     split is C consecutive pool positions, C a whole number of blocks,
//     chosen by the wrapper from host-known shapes only (B, KH, the table's
//     width, the SM count; never from lengths, which live on the device).  A
//     CTA whose split starts at or past lengths[b] exits at once;
//   - each CTA holds all G*W query rows of its kv head (<= 16: 4 in Llama-3
//     decode, 16 in its W = 4 window), so a K/V byte is read from device
//     memory once per kv head; larger G*W take more row groups;
//   - the split's table entries are read once into shared memory; K and V
//     stream through a CTA-wide ring of 2-4 stages of 64 positions, filled
//     with 16-byte cp.async (zero-filled past the split's last valid
//     position), so up to a whole split is in flight per CTA;
//   - each of the 4 warps takes 16 positions of a stage.  In bf16/fp16 the
//     scores Q.K^T and P.V are mma.sync m16n8k16 (the query rows fill the
//     m16 tile, K and V fragments by ldmatrix, V transposed by ldmatrix
//     .trans), and the fp32 scores stay in registers as P.V's A fragment;
//     fp32 runs on the CUDA cores (no TF32: its tolerance is 1e-4), a lane
//     owning one position for the scores and hd/32 dims for P.V;
//   - online softmax in the log2 domain (exp2 of scale*log2(e) scores); the
//     four warps merge once at the end, and the CTA writes its unnormalised
//     fp32 partial (o, m, l) to scratch the wrapper allocates;
//   - head dims 64, 96, 128 and 256 in all three types.  A ring stage holds
//     64 positions, or 32 where two stages of 64 would not fit shared memory
//     (fp32 at 256: 133 KB a stage); the 16 positions of a warp stay, so
//     with 32-position stages the warps take stages in turn, two at a time;
//   - merge kernel, grid (slot x kv head, row group, 32-dim chunk), launched
//     as a programmatic dependent of the split kernel so its launch and
//     prologue (q, k_new, v_new staged in shared memory, the new-row scores)
//     overlap the split kernel's tail: a thread per output element merges
//     the splits below ceil(lengths[b] / C) with the lse rule in one online
//     pass (every load independent of the sums), folds in the W new rows
//     under kw <= qw, divides by max(l, 1e-30) and writes the output.  An
//     idle slot (length 0) does no pool work and its output is v_new.
// Every launch returns cudaGetLastError(); the wrapper raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;        // query rows per CTA: one m16 tile
constexpr int kStageTok = 64;    // pool positions per ring stage
constexpr int kWarpTok = 16;     // positions per warp per stage
constexpr int kMaxStages = 4;
constexpr int kMaxSplitBlocks = 256;  // table entries per split (C / bs)
constexpr int kMergeThreads = 256;
constexpr int kSmemLimit = 227 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

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

// Two fp32 values as one 32-bit register of the 16-bit type, lower index in
// the low half (the mma A-fragment order).
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16-byte asynchronous copy to shared memory; with valid false nothing is
// read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most n committed groups are pending (n is CTA-uniform).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// D += A (16x16, row) * B (16x8, col), fp32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory plan of a split CTA: the query rows (padded like the K/V
// rows), the fp32 path's probabilities, then the ring of K/V stages.  Rows
// are padded by one 16-byte vector so ldmatrix's eight row addresses (and
// the fp32 path's per-lane rows) fall in distinct banks.  After the ring
// drains, its space holds the four warps' accumulators for the combine.
template <typename T, int HD>
struct Plan {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int VPR = HD / VEC;  // 16-byte vectors per K/V row
  static constexpr int STRIDE = HD + VEC;
  static constexpr size_t q_bytes = kRows * STRIDE * sizeof(T);
  // fp32 path: per warp, probabilities [kRows][kWarpTok] and row factors.
  static constexpr size_t p_bytes = kF32 ? kWarps * (kRows * kWarpTok + kRows) * 4 : 0;
  // Positions per ring stage: 64, or 32 where two stages of 64 do not fit.
  static constexpr int TOK =
      q_bytes + p_bytes + 2048 + 4 * (size_t)kStageTok * STRIDE * sizeof(T) <= kSmemLimit
          ? kStageTok
          : kStageTok / 2;
  static constexpr int WPS = TOK / kWarpTok;   // warps that share one stage
  static constexpr int TURNS = kWarps / WPS;   // stages in flight across the warps
  static constexpr int TILE = TOK * STRIDE;
  static constexpr size_t stage_bytes = 2 * TILE * sizeof(T);
  static constexpr size_t combine_bytes = kWarps * kRows * HD * 4;
  // 2 KB stay for the static arrays (table entries, per-warp m and l).
  static constexpr int max_stages =
      (kSmemLimit - 2048 - q_bytes - p_bytes) / stage_bytes < kMaxStages
          ? (int)((kSmemLimit - 2048 - q_bytes - p_bytes) / stage_bytes)
          : kMaxStages;
  static_assert(max_stages >= 2, "two ring stages must fit");
  static size_t smem(int stages) {
    const size_t ring = stages * stage_bytes;
    return q_bytes + p_bytes + (ring > combine_bytes ? ring : combine_bytes);
  }
};

// One warp's online-softmax state over its positions of the split.
// 16-bit types: mma fragments.  Thread (g = lane / 4, t = lane % 4) holds
// rows g and g + 8; acc[n] covers dims 8n + 2t, 8n + 2t + 1.
template <typename T, int HD, bool F32 = (sizeof(T) == 4)>
struct WarpState {
  using P = Plan<T, HD>;
  float acc[HD / 8][4];
  float m[2], l[2];

  __device__ void init() {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // Positions t0 .. t0 + 15 of the staged tile, the first nv of them valid.
  __device__ void step(const T* q_s, const T* k_s, const T* v_s, float*, int t0, int nv,
                       float scale_log2, int lane) {
    const int g = lane >> 2, tg = lane & 3;
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const T* qa = q_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * P::STRIDE + (lane >> 4) * 8;
    const T* kb = k_s + (t0 + (lane & 7) + (lane >> 4) * 8) * P::STRIDE + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, qa + kk * 16);
      ldmatrix_x4(b, kb + kk * 16);
      mma16816<T>(s[0], a, b[0], b[1]);
      mma16816<T>(s[1], a, b[2], b[3]);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = n * 8 + tg * 2 + (e & 1) < nv;
        s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);  // finite: position t0 is valid
      alpha[h] = exp2f(m[h] - m_new);          // 0 on the first step
      m[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);  // masked: exp2(-inf) = 0
        sum[e >> 1] += s[n][e];
      }
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // The score accumulators of two n8 tiles are P's k16 A fragment.
    const uint32_t pa[4] = {pack2<T>(s[0][0], s[0][1]), pack2<T>(s[0][2], s[0][3]),
                            pack2<T>(s[1][0], s[1][1]), pack2<T>(s[1][2], s[1][3])};
    const T* vb = v_s + (t0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P::STRIDE + (lane >> 4) * 8;
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vb + dp * 16);
      mma16816<T>(acc[2 * dp], pa, b[0], b[1]);
      mma16816<T>(acc[2 * dp + 1], pa, b[2], b[3]);
    }
  }

  __device__ void dump(float* acc_w, float* m_w, float* l_w, int lane) {
    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int d = n * 8 + tg * 2;
      *reinterpret_cast<float2*>(acc_w + g * HD + d) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(acc_w + (g + 8) * HD + d) = make_float2(acc[n][2], acc[n][3]);
    }
    if (tg == 0) {
      m_w[g] = m[0];
      m_w[g + 8] = m[1];
      l_w[g] = l[0];
      l_w[g + 8] = l[1];
    }
  }
};

// fp32 on the CUDA cores.  Scores: lane (half = lane / 16, t = lane % 16)
// owns position t for rows 8*half .. 8*half + 7 (the query is pre-scaled by
// scale*log2(e) in shared memory).  P.V: a lane owns dims lane*DPL .. + DPL
// of all 16 rows.  m and l are kept for the lane's own 8 rows.
template <typename T, int HD>
struct WarpState<T, HD, true> {
  using P = Plan<T, HD>;
  static constexpr int DPL = HD / 32;
  float acc[kRows][DPL];
  float m[8], l[8];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
  }

  __device__ void step(const float* q_s, const float* k_s, const float* v_s, float* p_w, int t0,
                       int nv, float, int lane) {
    const int half = lane >> 4, t = lane & 15;
    float* al_w = p_w + kRows * kWarpTok;
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    const float* krow = k_s + (t0 + t) * P::STRIDE;
#pragma unroll 4
    for (int d0 = 0; d0 < HD; d0 += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (half * 8 + i) * P::STRIDE + d0);
        s[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    const bool ok = t < nv;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float si = ok ? s[i] : -INFINITY;
      float mx = si, sum;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);  // finite: position t0 is valid
      const float p = ok ? exp2f(si - m_new) : 0.f;
      const float alpha = exp2f(m[i] - m_new);
      sum = p;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      p_w[(half * 8 + i) * kWarpTok + t] = p;
      if (t == 0) al_w[half * 8 + i] = alpha;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float alpha = al_w[i];
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] *= alpha;
    }
    for (int tt = 0; tt < nv; ++tt) {
      float vf[DPL];
      const float* vrow = v_s + (t0 + tt) * P::STRIDE + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; ++d) vf[d] = vrow[d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = p_w[i * kWarpTok + tt];
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[i][d] += p * vf[d];
      }
    }
    __syncwarp();
  }

  __device__ void dump(float* acc_w, float* m_w, float* l_w, int lane) {
    const int half = lane >> 4, t = lane & 15;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc_w[i * HD + lane * DPL + d] = acc[i][d];
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        m_w[half * 8 + i] = m[i];
        l_w[half * 8 + i] = l[i];
      }
    }
  }
};

// Partial attention of one split: positions [split*C, min((split+1)*C,
// length)) of slot b for kv head kh and query rows row0 .. row0 + 15 (rows
// r = g*W + w).  Writes the unnormalised o, and m (log2 domain) and l, to
// part_o [B*KH, NS, R, HD] and part_ml [B*KH, NS, R, 2].
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                   const T* __restrict__ pool_v, const int* __restrict__ tables,
                   const int* __restrict__ lengths, float* __restrict__ part_o,
                   float* __restrict__ part_ml, int H, int KH, int BS, int M, int W, int C,
                   int NS, int stages, float scale_log2) {
  using P = Plan<T, HD>;
  // The merge (a programmatic dependent) may launch once every split CTA
  // has started; it waits for this grid's completion before reading.
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int bk = blockIdx.x;
  const int b = bk / KH, kh = bk % KH;
  const int split = blockIdx.y;
  const int length = min(lengths[b], M * BS);  // positions past the table are out of reach
  const int start = split * C;
  if (start >= length) return;  // an empty split: no pool read, no partial
  const int n_tok = min(C, length - start);
  const int G = H / KH, R = G * W;
  const int row0 = blockIdx.z * kRows;
  const int nrows = min(kRows, R - row0);

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tbl_s[kMaxSplitBlocks];
  __shared__ float m_sh[kWarps][kRows];
  __shared__ float l_sh[kWarps][kRows];
  T* q_s = reinterpret_cast<T*>(smem);
  float* p_s = reinterpret_cast<float*>(smem + P::q_bytes);
  T* ring = reinterpret_cast<T*>(smem + P::q_bytes + P::p_bytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // The split's table entries, each read once.  C is a whole number of
  // blocks, so position start + p sits in entry p / BS at offset p % BS.
  const int nblk = (n_tok + BS - 1) / BS;
  for (int i = threadIdx.x; i < nblk; i += kThreads)
    tbl_s[i] = tables[(long long)b * M + start / BS + i];
  for (int idx = threadIdx.x; idx < kRows * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD;
    float x = 0.f;
    if (i < nrows) {
      const int r = row0 + i;
      x = to_float(q[((long long)(b * W + r % W) * H + kh * G + r / W) * HD + d]);
    }
    q_s[i * P::STRIDE + d] = from_float<T>(P::kF32 ? x * scale_log2 : x);
  }
  __syncthreads();

  const long long tok_stride = (long long)KH * HD;  // between token rows of a block
  auto issue = [&](int stage, int slot) {
    T* k_s = ring + slot * 2 * P::TILE;
    T* v_s = k_s + P::TILE;
    for (int idx = threadIdx.x; idx < P::TOK * P::VPR; idx += kThreads) {
      const int t = idx / P::VPR, c = idx % P::VPR;
      const int pos = stage * P::TOK + t;
      const bool ok = pos < n_tok;
      long long src = 0;
      if (ok) src = ((long long)tbl_s[pos / BS] * BS + pos % BS) * tok_stride + kh * HD + c * P::VEC;
      cp_async16(k_s + t * P::STRIDE + c * P::VEC, pool_k + src, ok);
      cp_async16(v_s + t * P::STRIDE + c * P::VEC, pool_v + src, ok);
    }
  };

  WarpState<T, HD> st;
  st.init();
  const int n_st = (n_tok + P::TOK - 1) / P::TOK;
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_st) issue(s, s);
    cp_async_commit();
  }
  float* p_w = p_s + warp * (kRows * kWarpTok + kRows);
  for (int s = 0; s < n_st; ++s) {
    cp_async_wait(stages - 2);
    __syncthreads();  // stage s visible to all; stage s - 1's slot free
    const int next = s + stages - 1;
    if (next < n_st) issue(next, next % stages);
    cp_async_commit();
    const T* k_s = ring + (s % stages) * 2 * P::TILE;
    // WPS warps take 16 positions each of this stage (all four at 64).
    if (warp / P::WPS == s % P::TURNS) {
      const int t0 = (warp % P::WPS) * kWarpTok;
      const int nv = min(kWarpTok, n_tok - s * P::TOK - t0);
      if (nv > 0) st.step(q_s, k_s, k_s + P::TILE, p_w, t0, nv, scale_log2, lane);
    }
  }
  cp_async_wait(0);
  __syncthreads();  // the ring is drained: its space becomes the combine's

  float* acc_s = reinterpret_cast<float*>(ring);  // [kWarps][kRows][HD]
  st.dump(acc_s + warp * kRows * HD, m_sh[warp], l_sh[warp], lane);
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, m_sh[w][i]);  // finite: warp 0 has position 0
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(m_sh[w][i] - m);  // a warp without positions: exp2(-inf) = 0
      o += f * acc_s[(w * kRows + i) * HD + d];
      l += f * l_sh[w][i];
    }
    const long long prow = ((long long)bk * NS + split) * R + row0 + i;
    part_o[prow * HD + d] = o;
    if (d == 0) {
      part_ml[prow * 2] = m;
      part_ml[prow * 2 + 1] = l;
    }
  }
}

// Merge of the splits below ceil(min(lengths[b], M*BS) / C) with the lse
// rule, the W new rows folded in under kw <= qw, then out = o / max(l,
// 1e-30).  Grid (slot x kv head, row group, 32-dim chunk).  The prologue
// stages the query rows, k_new and this chunk of v_new in shared memory
// with one round of 16-byte loads and computes the new-row scores there;
// launched as a programmatic dependent of the split kernel, it runs while
// the split kernel drains and waits for its partials only after that.  A
// thread then owns one output element (lane = dim, warp = row, then row +
// 8) and merges online in one pass over the splits, every load independent
// of the sums before it.
template <typename T, int HD>
__global__ void __launch_bounds__(kMergeThreads)
paged_merge_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                   const T* __restrict__ v_new, const int* __restrict__ lengths,
                   const float* __restrict__ part_o, const float* __restrict__ part_ml,
                   T* __restrict__ out, int H, int KH, int BS, int M, int W, int C, int NS,
                   float scale_log2) {
  constexpr int kRowLanes = kMergeThreads / 32;
  constexpr int VEC = 16 / sizeof(T), VPR = HD / VEC;
  const int bk = blockIdx.x;
  const int b = bk / KH, kh = bk % KH;
  const int G = H / KH, R = G * W;
  const int row0 = blockIdx.y * kRows;
  const int nrows = min(kRows, R - row0);
  const int d0 = blockIdx.z * 32;
  extern __shared__ __align__(16) unsigned char msm[];
  T* q_s = reinterpret_cast<T*>(msm);               // [kRows][HD]
  T* kn_s = q_s + kRows * HD;                       // [W][HD]
  float* vn_s = reinterpret_cast<float*>(kn_s + W * HD);  // [W][32]: this chunk
  float* pn_s = vn_s + W * 32;                      // [kRows][W]: new-row scores

  for (int idx = threadIdx.x; idx < (nrows + W) * VPR; idx += kMergeThreads) {
    const int row = idx / VPR, c = idx % VPR;
    const T* src;
    if (row < nrows) {
      const int r = row0 + row;
      src = q + ((long long)(b * W + r % W) * H + kh * G + r / W) * HD;
    } else {
      src = k_new + ((long long)(b * W + row - nrows) * KH + kh) * HD;
    }
    T* dst = row < nrows ? q_s + row * HD : kn_s + (row - nrows) * HD;
    *reinterpret_cast<uint4*>(dst + c * VEC) = *reinterpret_cast<const uint4*>(src + c * VEC);
  }
  for (int idx = threadIdx.x; idx < W * 32; idx += kMergeThreads) {
    const int kw = idx / 32, dd = idx % 32;
    vn_s[idx] = to_float(v_new[((long long)(b * W + kw) * KH + kh) * HD + d0 + dd]);
  }
  const int length = min(lengths[b], M * BS);
  const int n_used = (length + C - 1) / C;
  __syncthreads();
  // New-row scores, one thread per (row, new row kw <= qw).  Each thread
  // starts at its own dim (rows lie 64 words apart: without the rotation the
  // threads of a warp would read one bank).
  for (int item = threadIdx.x; item < nrows * W; item += kMergeThreads) {
    const int i = item / W, kw = item % W;
    float s = -INFINITY;
    if (kw <= (row0 + i) % W) {
      float acc = 0.f;
#pragma unroll 16
      for (int dd = 0; dd < HD; ++dd) {
        const int d = (HD & (HD - 1)) == 0 ? (dd + 2 * item) & (HD - 1) : (dd + 2 * item) % HD;
        acc += to_float(q_s[i * HD + d]) * to_float(kn_s[kw * HD + d]);
      }
      s = acc * scale_log2;
    }
    pn_s[item] = s;
  }
  __syncthreads();
  // The split kernel's partials are complete past this point.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // A thread merges dim d (its lane) of row i (its warp), then of row i + 8.
  // The split loop holds no branch, so the compiler issues a batch's loads
  // before the sums that use them.
  const int d = d0 + threadIdx.x % 32;
  const long long split_stride = (long long)R * HD;
  for (int i = threadIdx.x / 32; i < nrows; i += kRowLanes) {
    const int r = row0 + i, qw = r % W;
    const long long prow = (long long)bk * NS * R + r;  // split 0's row
    const float* po = part_o + prow * HD + d;
    const float2* pml = reinterpret_cast<const float2*>(part_ml) + prow;
    float m = -INFINITY, l = 0.f, o = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_used; ++s) {
      const float2 ml = pml[(long long)s * R];
      const float x = po[s * split_stride];
      const float m_new = fmaxf(m, ml.x);  // finite: a used split has a position
      const float a = exp2f(m - m_new), f = exp2f(ml.x - m_new);
      o = o * a + f * x;
      l = l * a + f * ml.y;
      m = m_new;
    }
    for (int kw = 0; kw <= qw; ++kw) {
      const float sn = pn_s[i * W + kw];
      const float m_new = fmaxf(m, sn);
      const float a = exp2f(m - m_new), f = exp2f(sn - m_new);
      o = o * a + f * vn_s[kw * 32 + d - d0];
      l = l * a + f;
      m = m_new;
    }
    out[((long long)(b * W + qw) * H + kh * G + r / W) * HD + d] =
        from_float<T>(o / fmaxf(l, 1e-30f));
  }
}

// Raise a kernel's dynamic shared-memory limit once to the largest size
// asked of it so far.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& granted) {
  if (bytes <= granted) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

struct Args {
  const void *q, *k_new, *v_new, *pool_k, *pool_v, *tables, *lengths;
  void *out, *part_o, *part_ml;
  int B, H, KH, BS, M, W, C;
  bool split;  // false: the merge alone, on the partials given
  cudaStream_t stream;
};

template <typename T, int HD>
int launch_typed(const Args& a) {
  using P = Plan<T, HD>;
  const int R = (a.H / a.KH) * a.W;
  const int groups = (R + kRows - 1) / kRows;
  const int NS = (a.M * a.BS + a.C - 1) / a.C;
  const float scale_log2 = kLog2e / sqrtf((float)HD);
  cudaError_t err;
  if (a.split) {
    int stages = (a.C + P::TOK - 1) / P::TOK;
    stages = stages < 2 ? 2 : (stages > P::max_stages ? P::max_stages : stages);
    const size_t smem = P::smem(stages);
    static size_t granted = 0;
    auto kernel = paged_split_kernel<T, HD>;
    if ((err = allow_smem(kernel, smem, granted)) != cudaSuccess) return (int)err;
    kernel<<<dim3(a.B * a.KH, NS, groups), kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.pool_k),
        static_cast<const T*>(a.pool_v), static_cast<const int*>(a.tables),
        static_cast<const int*>(a.lengths), static_cast<float*>(a.part_o),
        static_cast<float*>(a.part_ml), a.H, a.KH, a.BS, a.M, a.W, a.C, NS, stages, scale_log2);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const size_t msmem = (size_t)(kRows + a.W) * HD * sizeof(T) + (size_t)a.W * (32 + kRows) * 4;
  if (msmem > (size_t)kSmemLimit - 1024) return (int)cudaErrorInvalidValue;
  static size_t mgranted = 0;
  auto merge = paged_merge_kernel<T, HD>;
  if ((err = allow_smem(merge, msmem, mgranted)) != cudaSuccess) return (int)err;
  // A programmatic dependent of the split kernel: its prologue overlaps the
  // split kernel's tail; griddepcontrol.wait orders the partials.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.KH, groups, HD / 32);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.dynamicSmemBytes = msmem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = a.split ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, merge, static_cast<const T*>(a.q),
                           static_cast<const T*>(a.k_new), static_cast<const T*>(a.v_new),
                           static_cast<const int*>(a.lengths),
                           static_cast<const float*>(a.part_o),
                           static_cast<const float*>(a.part_ml), static_cast<T*>(a.out), a.H,
                           a.KH, a.BS, a.M, a.W, a.C, NS, scale_log2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int HD, const Args& a) {
  switch (HD) {
    case 64: return launch_typed<T, 64>(a);
    case 96: return launch_typed<T, 96>(a);
    case 128: return launch_typed<T, 128>(a);
    case 256: return launch_typed<T, 256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 float32, 1 bfloat16, 2 float16 (all of q, k_new, v_new, pools, out).
int launch(int dtype, int HD, const Args& a) {
  if (a.B <= 0 || a.KH <= 0 || a.H % a.KH != 0 || a.BS <= 0 || a.M <= 0 || a.W <= 0 ||
      a.C <= 0 || a.C % a.BS != 0 || a.C / a.BS > kMaxSplitBlocks)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch_hd<float>(HD, a);
    case 1: return launch_hd<__nv_bfloat16>(HD, a);
    case 2: return launch_hd<__half>(HD, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, H, hd], k_new/v_new [B, KH, hd], pools [N, bs, KH, hd], tables [B, M]
// int32, lengths [B] int32, out [B, H, hd]; part_o [B, KH, NS, G, hd] and
// part_ml [B, KH, NS, G, 2] fp32 scratch, NS = ceil(M*bs / C); C, the
// positions per split, a multiple of bs and at most 256 blocks.  Returns
// the first CUDA error of the two launches, or 0.
extern "C" int atpu_paged_attention_sm90(int dtype, const void* q, const void* k_new,
                                         const void* v_new, const void* pool_k,
                                         const void* pool_v, const void* tables,
                                         const void* lengths, void* out, void* part_o,
                                         void* part_ml, int B, int H, int KH, int HD, int BS,
                                         int M, int C, void* stream) {
  return launch(dtype, HD, Args{q, k_new, v_new, pool_k, pool_v, tables, lengths, out, part_o,
                                part_ml, B, H, KH, BS, M, 1, C, true,
                                static_cast<cudaStream_t>(stream)});
}

// q [B, W, H, hd], k_new/v_new [B, W, KH, hd], out [B, W, H, hd]; scratch
// rows G*W (row g*W + w); the rest as above.
extern "C" int atpu_paged_window_attention_sm90(int dtype, const void* q, const void* k_new,
                                                const void* v_new, const void* pool_k,
                                                const void* pool_v, const void* tables,
                                                const void* lengths, void* out, void* part_o,
                                                void* part_ml, int B, int H, int KH, int HD,
                                                int BS, int M, int W, int C, void* stream) {
  return launch(dtype, HD, Args{q, k_new, v_new, pool_k, pool_v, tables, lengths, out, part_o,
                                part_ml, B, H, KH, BS, M, W, C, true,
                                static_cast<cudaStream_t>(stream)});
}

// The merge kernel alone on given partials (window layout; W = 1 for
// decode).  Returns cudaGetLastError().
extern "C" int atpu_paged_split_merge(int dtype, const void* q, const void* k_new,
                                      const void* v_new, const void* lengths, const void* part_o,
                                      const void* part_ml, void* out, int B, int H, int KH,
                                      int HD, int BS, int M, int W, int C, void* stream) {
  return launch(dtype, HD, Args{q, k_new, v_new, nullptr, nullptr, nullptr, lengths, out,
                                const_cast<void*>(part_o), const_cast<void*>(part_ml), B, H, KH,
                                BS, M, W, C, false, static_cast<cudaStream_t>(stream)});
}
