// Paged decode attention for Hopper (sm_90a): one token per slot, or a
// W-token speculative verify window, read straight out of the serving
// engine's block pool through per-slot block tables.
//
// NOT ON ANY PATH: the wrappers in ops/paged_attention.py launch
// paged_attention_sm90.cu.  This first body (one CTA per slot and kv head)
// is kept only so that chip_smoke.py can time it as `previous_ms` beside the
// split-K kernels, calling its symbols directly and uncounted; a later
// change removes it.
//
// Replaces (accelerate_tpu/ops/pallas_attention.py):
//   atpu_paged_attention        -> _paged_kernel (:564), launched by
//                                  pallas_paged_attention (:621)
//   atpu_paged_window_attention -> _paged_window_kernel (:686), launched by
//                                  pallas_paged_window_attention (:760)
// Both launchers share one kernel body; W = 1 is the single-token kernel.
//
// What it computes, per slot b and query head h (kv head h / G):
//   keys  = pool rows at positions 0 .. lengths[b]-1 (through tables[b]),
//           then the W new rows at positions lengths[b] .. lengths[b]+W-1
//   query at window position w admits every pool row and new rows kw <= w
//   out   = softmax(q . k / sqrt(hd)) . v, accumulated in fp32 with an online
//           softmax, l floored at 1e-30, written in the input dtype.
// Pool positions >= lengths[b] are never read (they are stale: the caller
// scatters this dispatch's rows there afterwards), and table entries past
// ceil(lengths[b] / bs) are never touched, so null-padded and bucketed
// tables cost nothing.
//
// Bound on this card.  Decode is memory-bound: every pool byte is used by
// G*W query rows for 2 flops per element, far below the ~295 flop/byte
// ridge of the H100.  The least time is
//   bytes = sum_b min(lengths[b], M*bs) * KH * hd * 2 * sizeof(pool dtype)
//         + q + k_new + v_new + out + tables + lengths
//   time  = bytes / 3.35 TB/s
// (chip_smoke.py computes it from each run's inputs).
//
// What the design does about that bound:
//   - one CTA per (slot, kv head) and group of up to 16 of its G*W query
//     rows, so a K/V row is read from device memory once per kv head, not
//     once per query head (GQA reuse; the window folds into the same rows);
//   - each CTA loads its own table row and length (there is no scalar
//     prefetch on Hopper) and visits only the ceil(length / 32) tiles of 32
//     positions it needs;
//   - its 4 warps take alternate tiles, each staging its tile's K and V rows
//     in shared memory with 16-byte vector loads, so four tiles are in flight
//     per CTA and no block-wide barrier sits in the token loop;
//   - within a tile a lane owns one token for the scores (no reduction per
//     token), the softmax statistics take one warp reduction per tile, and
//     for the value sum a lane owns hd/32 output dims; scores, the running
//     max and sum and the accumulator stay in fp32 registers;
//   - the four warps' partial softmaxes are merged once at the end.
// Not done here (later work): splitting a long slot over several CTAs
// (flash-decoding) — a 4k-token slot is streamed by only KH CTAs — TMA with
// an mbarrier pipeline, and wgmma for the score and value products.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // tokens per warp tile: one token per lane for scores

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

// 16-byte asynchronous copy from device to shared memory (no registers
// staged; completion waited on per thread, then made visible to the warp with
// __syncwarp).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory plan of one CTA: the scaled query rows in fp32, then one
// region per warp holding a K tile (rows padded by one 16-byte vector, so the
// lanes' 16-byte reads of 32 different rows hit distinct banks), a V tile and
// the tile's probabilities.  After the token loop the warp regions are reused
// for the cross-warp combine.
template <typename T, int HD>
struct Plan {
  static constexpr int DPL = HD / 32;          // output dims per lane
  static constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte vector
  static constexpr int VPR = HD / VEC;         // vectors per K/V row
  static constexpr int ROWS = HD >= 256 ? 8 : 16;  // query rows per CTA
  static constexpr int KSTRIDE = HD + VEC;
  static constexpr int KTILE = kTile * KSTRIDE;  // elements of one K tile
  static constexpr int VTILE = kTile * HD;
  static constexpr size_t q_bytes = ROWS * HD * sizeof(float);
  static constexpr size_t stage_bytes = (KTILE + VTILE) * sizeof(T);
  static constexpr size_t p_bytes = ROWS * kTile * sizeof(float);
  // Two stages (the next tile's copies in flight while this one is used)
  // where shared memory allows, else one.
  static constexpr int STAGES =
      q_bytes + kWarps * (2 * stage_bytes + p_bytes) <= 227 * 1024 ? 2 : 1;
  static constexpr size_t warp_bytes = STAGES * stage_bytes + p_bytes;
  static constexpr size_t smem = q_bytes + kWarps * warp_bytes;
  static_assert(kWarps * ROWS * HD * sizeof(float) <= kWarps * warp_bytes,
                "combine scratch must fit in the warp regions");
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                       const T* __restrict__ v_new, const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v, const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out, int H, int KH,
                       int BS, int M, int W, float scale) {
  using P = Plan<T, HD>;
  constexpr int ROWS = P::ROWS, DPL = P::DPL, VEC = P::VEC, VPR = P::VPR;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_sh[kWarps][ROWS];
  __shared__ float l_sh[kWarps][ROWS];
  float* q_s = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned char* region = smem + P::q_bytes + warp * P::warp_bytes;
  T* stages = reinterpret_cast<T*>(region);  // per stage: K tile, then V tile
  float* p_s = reinterpret_cast<float*>(region + P::STAGES * P::stage_bytes);

  const int b = blockIdx.x / KH;
  const int kh = blockIdx.x % KH;
  const int G = H / KH;
  const int row0 = blockIdx.y * ROWS;  // rows of this kv head are r = g * W + w
  const int nrows = min(ROWS, G * W - row0);
  // Positions past the table are out of reach, as on the TPU grid.
  const int length = min(lengths[b], M * BS);
  const int* table = tables + (long long)b * M;

  for (int idx = threadIdx.x; idx < ROWS * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD;
    float x = 0.f;
    if (i < nrows) {
      const int r = row0 + i;
      x = to_float(q[((long long)(b * W + r % W) * H + kh * G + r / W) * HD + d]) * scale;
    }
    q_s[idx] = x;
  }
  int qw[ROWS];
  float acc[ROWS][DPL], m_run[ROWS], l_run[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    qw[i] = (row0 + i) % W;
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
  }
  __syncthreads();

  // One online-softmax step over the nt staged tokens of this warp's tile.
  // causal < 0: pool tile, every staged token counts; causal >= 0: new rows
  // causal + t, admitted by rows whose window position is >= causal + t.
  auto tile_update = [&](int nt, int causal, int stage) {
    const T* k_s = stages + stage * (P::KTILE + P::VTILE);
    const T* v_s = k_s + P::KTILE;
    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
    if (lane < nt) {
      const T* krow = k_s + lane * P::KSTRIDE;
#pragma unroll 4
      for (int d0 = 0; d0 < HD; d0 += VEC) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + d0);
        const T* kv = reinterpret_cast<const T*>(&raw);
        float kf[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = to_float(kv[e]);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          if (i < nrows) {
            const float* qi = q_s + i * HD + d0;
#pragma unroll
            for (int e = 0; e < VEC; ++e) s[i] += qi[e] * kf[e];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (i < nrows) {
        const bool ok = lane < nt && (causal < 0 || causal + lane <= qw[i]);
        const float si = ok ? s[i] : -INFINITY;
        const float m_new = fmaxf(m_run[i], warp_max(si));  // finite: token 0 is always admitted
        const float p = ok ? expf(si - m_new) : 0.f;
        const float alpha = expf(m_run[i] - m_new);  // exp(-inf) = 0 on the first tile
        l_run[i] = l_run[i] * alpha + warp_sum(p);
        m_run[i] = m_new;
        p_s[i * kTile + lane] = p;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[i][d] *= alpha;
      }
    }
    __syncwarp();
    for (int t = 0; t < nt; ++t) {
      float vf[DPL];
#pragma unroll
      for (int d = 0; d < DPL; ++d) vf[d] = to_float(v_s[t * HD + lane * DPL + d]);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        if (i < nrows) {
          const float pt = p_s[i * kTile + t];
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[i][d] += pt * vf[d];
        }
      }
    }
    __syncwarp();
  };

  // Pool tokens: warp w takes tiles w, w + 4, ... of 32 positions each.  A
  // lane reads the table entry of its own token; the copies of a tile are all
  // issued before any is waited on.
  const long long tok_stride = (long long)KH * HD;  // between token rows of a block
  const int n_tiles = (length + kTile - 1) / kTile;
  auto issue = [&](int tile, int stage) {
    T* k_s = stages + stage * (P::KTILE + P::VTILE);
    T* v_s = k_s + P::KTILE;
    const int t0 = tile * kTile;
    const int nt = min(kTile, length - t0);
    const long long my_row =
        lane < nt ? ((long long)table[(t0 + lane) / BS] * BS + (t0 + lane) % BS) * tok_stride
                  : 0;
#pragma unroll
    for (int it = 0; it < VPR; ++it) {
      const int idx = it * 32 + lane;
      const int t = idx / VPR, dv = idx % VPR;
      const long long row = __shfl_sync(0xffffffffu, my_row, t);
      if (t < nt) {
        const long long src = row + (long long)kh * HD + dv * VEC;
        cp_async16(k_s + t * P::KSTRIDE + dv * VEC, pool_k + src);
        cp_async16(v_s + t * HD + dv * VEC, pool_v + src);
      }
    }
  };
  if (P::STAGES == 2 && warp < n_tiles) issue(warp, 0);
  cp_async_commit();
  int k = 0;
  for (int tile = warp; tile < n_tiles; tile += kWarps, ++k) {
    const int stage = P::STAGES == 2 ? (k & 1) : 0;
    if (P::STAGES == 2) {
      if (tile + kWarps < n_tiles) issue(tile + kWarps, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      issue(tile, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncwarp();
    tile_update(min(kTile, length - tile * kTile), -1, stage);
  }
  cp_async_wait<0>();
  __syncwarp();
  // The W new rows at positions length .. length + W - 1, folded in last by
  // warp 0 under the in-window causal mask.
  if (warp == 0) {
    T* k_s = stages;
    T* v_s = k_s + P::KTILE;
    for (int c = 0; c < W; c += kTile) {
      const int nt = min(kTile, W - c);
      for (int idx = lane; idx < nt * VPR; idx += 32) {
        const int t = idx / VPR, dv = idx % VPR;
        const long long src = ((long long)(b * W + c + t) * KH + kh) * HD + dv * VEC;
        cp_async16(k_s + t * P::KSTRIDE + dv * VEC, k_new + src);
        cp_async16(v_s + t * HD + dv * VEC, v_new + src);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      tile_update(nt, c, 0);
    }
  }

  // Combine the four warps' partial softmaxes; l is floored at 1e-30.
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(smem + P::q_bytes);  // [kWarps][ROWS][HD]
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc_s[(warp * ROWS + i) * HD + lane * DPL + d] = acc[i][d];
    if (lane == 0) {
      m_sh[warp][i] = m_run[i];
      l_sh[warp][i] = l_run[i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_sh[w][i]);
    float l_all = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = m_sh[w][i] == -INFINITY ? 0.f : expf(m_sh[w][i] - m_all);
      l_all += l_sh[w][i] * f;
      o += acc_s[(w * ROWS + i) * HD + d] * f;
    }
    const int r = row0 + i;
    out[((long long)(b * W + r % W) * H + kh * G + r / W) * HD + d] =
        from_float<T>(o / fmaxf(l_all, 1e-30f));
  }
}

template <typename T, int HD>
int launch_typed(const void* q, const void* k_new, const void* v_new, const void* pool_k,
                 const void* pool_v, const void* tables, const void* lengths, void* out, int B,
                 int H, int KH, int BS, int M, int W, cudaStream_t stream) {
  using P = Plan<T, HD>;
  if (P::smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = paged_attention_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = (H / KH) * W;
  dim3 grid(B * KH, (rows + P::ROWS - 1) / P::ROWS);
  const float scale = 1.f / sqrtf((float)HD);
  kernel<<<grid, kThreads, P::smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<const T*>(pool_k), static_cast<const T*>(pool_v),
      static_cast<const int*>(tables), static_cast<const int*>(lengths), static_cast<T*>(out),
      H, KH, BS, M, W, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int HD, const void* q, const void* k_new, const void* v_new, const void* pool_k,
              const void* pool_v, const void* tables, const void* lengths, void* out, int B,
              int H, int KH, int BS, int M, int W, cudaStream_t stream) {
  switch (HD) {
    case 64:
      return launch_typed<T, 64>(q, k_new, v_new, pool_k, pool_v, tables, lengths, out, B, H,
                                 KH, BS, M, W, stream);
    case 128:
      return launch_typed<T, 128>(q, k_new, v_new, pool_k, pool_v, tables, lengths, out, B, H,
                                  KH, BS, M, W, stream);
    case 256:
      return launch_typed<T, 256>(q, k_new, v_new, pool_k, pool_v, tables, lengths, out, B, H,
                                  KH, BS, M, W, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 float32, 1 bfloat16, 2 float16 (all of q, k_new, v_new, pools, out).
int launch(int dtype, const void* q, const void* k_new, const void* v_new, const void* pool_k,
           const void* pool_v, const void* tables, const void* lengths, void* out, int B, int H,
           int KH, int HD, int BS, int M, int W, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || BS <= 0 || M <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_hd<float>(HD, q, k_new, v_new, pool_k, pool_v, tables, lengths, out, B, H,
                              KH, BS, M, W, s);
    case 1:
      return launch_hd<__nv_bfloat16>(HD, q, k_new, v_new, pool_k, pool_v, tables, lengths,
                                      out, B, H, KH, BS, M, W, s);
    case 2:
      return launch_hd<__half>(HD, q, k_new, v_new, pool_k, pool_v, tables, lengths, out, B, H,
                               KH, BS, M, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, H, hd], k_new/v_new [B, KH, hd], pools [N, bs, KH, hd], tables [B, M]
// int32, lengths [B] int32, out [B, H, hd].  Returns cudaGetLastError().
extern "C" int atpu_paged_attention(int dtype, const void* q, const void* k_new,
                                    const void* v_new, const void* pool_k, const void* pool_v,
                                    const void* tables, const void* lengths, void* out, int B,
                                    int H, int KH, int HD, int BS, int M, void* stream) {
  return launch(dtype, q, k_new, v_new, pool_k, pool_v, tables, lengths, out, B, H, KH, HD, BS,
                M, 1, stream);
}

// q [B, W, H, hd], k_new/v_new [B, W, KH, hd], pools/tables/lengths as above,
// out [B, W, H, hd].  Returns cudaGetLastError().
extern "C" int atpu_paged_window_attention(int dtype, const void* q, const void* k_new,
                                           const void* v_new, const void* pool_k,
                                           const void* pool_v, const void* tables,
                                           const void* lengths, void* out, int B, int H, int KH,
                                           int HD, int BS, int M, int W, void* stream) {
  return launch(dtype, q, k_new, v_new, pool_k, pool_v, tables, lengths, out, B, H, KH, HD, BS,
                M, W, stream);
}
