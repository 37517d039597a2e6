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
// kpos <= qpos; scores in fp32 scaled by 1/sqrt(D); output
// acc / max(l, 1e-30) in the input dtype, written in q's (B, C, H, D)
// layout (no fold copies on either side).
//
// What bounds it on the H100. At the serving shape (llama3.2-3b: KH = 8,
// G = 3, D = 128; a 512-token chunk at q_start 1024) the causal pairs need
// 4 * D flops each, about 8 GFLOP per layer, against about 13 MB of q,
// K/V and output: over 600 flops per byte, above the ~295 flop/byte
// ridge, so the least time is the flops over the tensor cores' 989
// TFLOP/s.
//
// Design. bfloat16, the engine's dtype, runs the tensor-core core of
// attention_tc.cuh (wgmma m64nNk16 for both products, K/V tiles of 64 keys
// in a two-stage ring): one block per (b, kv head, tile of 64 folded query
// rows), heaviest (last) row tiles launched first. A key row's page comes
// from the block's own row of the block table (attn_tc::PagedLoader,
// 16-byte cp.async copies), one lookup per key row, so any page size that
// is a multiple of 16 works and a 64-key tile may span several pages or
// part of one; a TMA box per page would need a tensor map per page size and
// could not zero the rows past kv_len. Key tiles past the tile's causal
// edge are never loaded.
//
// float32 keeps the first version's design, fp32 FMA on the CUDA cores
// (tensor cores would mean TF32, which misses the f32 checks): one block
// per (b, kv head, 64 folded rows), a loop over KT = 32 key positions up to
// min(kv_len, last query position of the tile) + 1; Q (scaled), the K tile
// and the V tile in shared memory (rows padded by one float against bank
// conflicts); each thread owns 4 query rows x 4 key columns of the score
// tile and 4 rows x D/8 columns of the output, the row max and sum reduced
// over the 8 lanes that share a row. Padded rows (r >= R) are masked and
// never stored.
//
// Launches on the caller's stream, allocates nothing, does not synchronise.
// The entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kQT = 64;        // folded query rows per block
constexpr int kKT = 32;        // key positions per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kQT * (D + 1) + (size_t)kKT * (D + 1) +
                          (size_t)kKT * D + (size_t)kQT * (kKT + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const float* __restrict__ q,        // (B, C, KH*G, D)
    const float* __restrict__ k_pages,  // (NP, page, KH, D)
    const float* __restrict__ v_pages,
    const int* __restrict__ tables,     // (B, pps)
    const int* __restrict__ kv_lens,    // (B,)
    const int* __restrict__ q_starts,   // (B,)
    float* __restrict__ out,            // (B, C, KH*G, D)
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
      v = q[(((size_t)b * C + c) * H + (size_t)kh * G + g) * D + d] * scale;
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
        kv = k_pages[off];
        vv = v_pages[off];
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
    float* op = out + (((size_t)b * C + c0) * H + (size_t)kh * G + g) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < OC; ++c) op[tc + 8 * c] = o[i][c] / denom;
  }
}

template <int D>
__global__ void __launch_bounds__(attn_tc::kThreads) paged_prefill_tc_kernel(
    const __nv_bfloat16* __restrict__ q,        // (B, C, KH*G, D)
    const __nv_bfloat16* __restrict__ k_pages,  // (NP, page, KH, D)
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ tables,             // (B, pps)
    const int* __restrict__ kv_lens,            // (B,)
    const int* __restrict__ q_starts,           // (B,)
    __nv_bfloat16* __restrict__ out,            // (B, C, KH*G, D)
    int C, int KH, int G, int page_size, int pps, float scale_log2) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * attn_tc::kRows;
  const attn_tc::PagedLoader loader{k_pages + (size_t)kh * D,
                                   v_pages + (size_t)kh * D,
                                   tables + (size_t)b * pps, page_size,
                                   KH * D};
  attn_tc::attend<D>(q, out, loader, b, kh, C, KH, G, row0, q_starts[b],
                     min(kv_lens[b], pps * page_size), /*causal=*/1,
                     /*window=*/0, scale_log2);
}

// first launch of each instantiation raises its dynamic shared memory limit
template <typename F>
int allow_smem(F* kernel, size_t bytes, bool& done) {
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

template <int D>
int launch_f32(const void* q, const void* kp, const void* vp,
               const int* tables, const int* kv_lens, const int* q_starts,
               void* out, int B, int C, int KH, int G, int page_size, int pps,
               cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static bool attr_set = false;
  if (int e = allow_smem(paged_prefill_kernel<D>, bytes, attr_set)) return e;
  dim3 grid(B, KH, (C * G + kQT - 1) / kQT);
  paged_prefill_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), tables, kv_lens, q_starts,
      static_cast<float*>(out), C, KH, G, page_size, pps,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* kp, const void* vp,
                const int* tables, const int* kv_lens, const int* q_starts,
                void* out, int B, int C, int KH, int G, int page_size,
                int pps, cudaStream_t stream) {
  constexpr size_t bytes = attn_tc::smem_bytes<D>();
  static bool attr_set = false;
  if (int e = allow_smem(paged_prefill_tc_kernel<D>, bytes, attr_set))
    return e;
  dim3 grid(B, KH, (C * G + attn_tc::kRows - 1) / attn_tc::kRows);
  paged_prefill_tc_kernel<D><<<grid, attn_tc::kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), tables, kv_lens, q_starts,
      static_cast<__nv_bfloat16*>(out), C, KH, G, page_size, pps,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
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
#define PAGED_PREFILL_ARGS                                                   \
  q, k_pages, v_pages, tables, kv_lens, q_starts, out, B, C, KH, G,         \
      page_size, pps, s
  if (dtype == 0 && D == 64) return launch_f32<64>(PAGED_PREFILL_ARGS);
  if (dtype == 0 && D == 128) return launch_f32<128>(PAGED_PREFILL_ARGS);
  if (dtype == 1 && D == 64) return launch_bf16<64>(PAGED_PREFILL_ARGS);
  if (dtype == 1 && D == 128) return launch_bf16<128>(PAGED_PREFILL_ARGS);
#undef PAGED_PREFILL_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
