// Causal flash attention for a chunked-prefill block, reading K/V straight
// from the page pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py  _paged_prefill_kernel /
//       paged_flash_prefill_fwd
//
// What it computes. q is a chunk of C tokens (B, C, KH*G, D) whose first
// token sits at absolute position q_starts[b]; its own K/V are already in
// the pages. Query rows fold (token, head of the group) as r = c*G + g, so
// one tile serves all G heads of a token; row r sits at absolute position
// q_starts[b] + r / G. Keys are masked by kpos < kv_lens[b] and
// kpos <= qpos (NEG_INF = -1e30); scores in fp32 with q pre-scaled by
// 1/sqrt(D); output acc / max(l, 1e-30) in the input dtype, written in q's
// (B, C, H, D) layout (no fold copies on either side).
//
// What bounds it on the H100. At the serving shape (llama3.2-3b: KH = 8,
// G = 3, D = 128; a 512-token chunk at q_start 1024) the causal pairs need
// 4 * D flops each, about 8 GFLOP per layer, against about 13 MB of q,
// K/V and output: over 600 flops per byte, above the ~295 flop/byte
// ridge, so the least time is the flops over the tensor cores' 989
// TFLOP/s. This first version does its products with
// fp32 FMA on the CUDA cores (67 TFLOP/s peak at best), so it cannot come
// near that bound; mma.sync / wgmma with TMA-fed tiles are later PRs' work.
//
// Design. One block per (b, kv head, tile of QT = 64 folded query rows);
// the sequential page axis of the Pallas grid becomes a loop over KT = 32
// key positions at a time, up to min(kv_len, last query position of the
// tile) + 1, so pages past the tile's causal edge are skipped. Each key's
// page comes from the block's own row of the block table. Q (fp32, scaled),
// the K tile and the V tile live in shared memory (rows padded by one float
// against bank conflicts); each thread owns 4 query rows x 4 key columns of
// the score tile and 4 rows x D/8 columns of the output, with the row max
// and row sum reduced over the 8 lanes that share a row. Padded rows
// (r >= R) are masked and never stored.
//
// Launches on the caller's stream, allocates nothing, does not synchronise.
// The entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kQT = 64;        // folded query rows per block
constexpr int kKT = 32;        // key positions per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kQT * (D + 1) + (size_t)kKT * (D + 1) +
                          (size_t)kKT * D + (size_t)kQT * (kKT + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const T* __restrict__ q,            // (B, C, KH*G, D)
    const T* __restrict__ k_pages,      // (NP, page, KH, D)
    const T* __restrict__ v_pages,
    const int* __restrict__ tables,     // (B, pps)
    const int* __restrict__ kv_lens,    // (B,)
    const int* __restrict__ q_starts,   // (B,)
    T* __restrict__ out,                // (B, C, KH*G, D)
    int C, int KH, int G, int page_size, int pps, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kKT + 1;
  constexpr int OC = D / 8;             // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // kQT x DP
  float* Ks = Qs + kQT * DP;            // kKT x DP
  float* Vs = Ks + kKT * DP;            // kKT x D
  float* Ps = Vs + kKT * D;             // kQT x PP

  const int b = blockIdx.x, kh = blockIdx.y, row0 = blockIdx.z * kQT;
  const int R = C * G, H = KH * G;
  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;
  const int kv_len = min(kv_lens[b], pps * page_size);
  const int start = q_starts[b];
  const int* tab = tables + (size_t)b * pps;

  for (int i = tid; i < kQT * D; i += kThreads) {
    const int r = i / D, d = i % D, row = row0 + r;
    float v = 0.f;
    if (row < R) {
      const int c = row / G, g = row % G;
      v = to_f(q[(((size_t)b * C + c) * H + (size_t)kh * G + g) * D + d]) *
          scale;
    }
    Qs[r * DP + d] = v;
  }

  const int last_row = min(row0 + kQT, R) - 1;
  const int kend = min(kv_len, start + last_row / G + 1);

  float m[4], l[4], o[4][OC];
  int qpos[4];
  bool rvalid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + tr + 16 * i;
    rvalid[i] = row < R;
    qpos[i] = start + row / G;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += kKT) {
    __syncthreads();   // Qs written / previous tile's Ks, Vs, Ps consumed
    for (int i = tid; i < kKT * D; i += kThreads) {
      const int j = i / D, d = i % D, p = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (p < kend) {
        const int page = tab[p / page_size];
        const size_t off =
            (((size_t)page * page_size + p % page_size) * KH + kh) * D + d;
        kv = to_f(k_pages[off]);
        vv = to_f(v_pages[off]);
      }
      Ks[j * DP + d] = kv;
      Vs[j * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = k0 + tc + 8 * j;
        ok[j] = rvalid[i] && p < kend && p <= qpos[i];
        if (ok[j]) tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mx = fmaxf(m[i], tmax);
      const float corr = expf(m[i] - mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - mx) : 0.f;
        Ps[(tr + 16 * i) * PP + tc + 8 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < OC; ++c) o[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kKT; ++j) {
      float pv[4], vv[OC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * PP + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) vv[c] = Vs[j * D + tc + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + tr + 16 * i;
    if (row >= R) continue;
    const int c0 = row / G, g = row % G;
    T* op = out + (((size_t)b * C + c0) * H + (size_t)kh * G + g) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < OC; ++c) store(op + tc + 8 * c, o[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* kv_lens, const int* q_starts, void* out, int B, int C,
           int KH, int G, int page_size, int pps, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static bool attr_set = false;   // per instantiation, first launch only
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int R = C * G;
  dim3 grid(B, KH, (R + kQT - 1) / kQT);
  const float scale = 1.0f / sqrtf((float)D);
  paged_prefill_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, kv_lens, q_starts,
      static_cast<T*>(out), C, KH, G, page_size, pps, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* kp, const void* vp,
             const int* tables, const int* kv_lens, const int* q_starts,
             void* out, int B, int C, int KH, int G, int page_size, int pps,
             cudaStream_t s) {
  if (D == 128)
    return launch<T, 128>(q, kp, vp, tables, kv_lens, q_starts, out, B, C, KH,
                          G, page_size, pps, s);
  if (D == 64)
    return launch<T, 64>(q, kp, vp, tables, kv_lens, q_starts, out, B, C, KH,
                         G, page_size, pps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out: (B, C, KH*G, D); pages:
// (NP, page_size, KH, D); tables: (B, pps) int32; kv_lens, q_starts: (B,)
// int32. All contiguous.
extern "C" int paged_flash_prefill_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const int* tables, const int* kv_lens, const int* q_starts, void* out,
    int B, int C, int KH, int G, int D, int page_size, int pps, int dtype,
    void* stream) {
  if (B <= 0 || C <= 0 || KH <= 0 || G <= 0 || pps <= 0 || page_size <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k_pages, v_pages, tables, kv_lens, q_starts,
                           out, B, C, KH, G, page_size, pps, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k_pages, v_pages, tables, kv_lens,
                                   q_starts, out, B, C, KH, G, page_size, pps,
                                   s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
