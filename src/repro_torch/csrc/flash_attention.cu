// Dense flash attention forward (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py  _flash_kernel /
//       flash_attention_fwd
//
// What it computes. q: (B, Sq, KH*G, D); k, v: (B, Sk, KH, D). Query rows
// fold (token, head of the group) as r = c*G + g, so one tile serves all G
// heads of a token; positions are start-aligned as in the TPU kernel: row r
// sits at position r / G, key j at position j. Key j is visible to a row at
// qpos when j < seq_k, and j <= qpos if causal, and qpos - j < window if
// window > 0. Scores in fp32 with q pre-scaled by 1/sqrt(D); online softmax
// in fp32; output acc / max(l, 1e-30) in the input dtype, so a row with no
// visible key is zeros. q is read and the output written in their
// (B, Sq, H, D) layout: no fold copies on either side.
//
// What bounds it on the H100. At zamba2-2.7b's shared attention at prefill
// (B = 1, Sq = Sk = 2048, 32 heads of D = 80, MHA) the causal pairs need
// 4 * D flops each, about 21 GFLOP, against about 42 MB of q, k, v and
// output: some 500 flops per byte, above the ~295 flop/byte ridge, so the
// least time is the flops over the tensor cores' 989 TFLOP/s. This first
// version does its products with fp32 FMA on the CUDA cores from shared
// memory, as the paged prefill kernel does; mma.sync / wgmma with TMA-fed
// tiles are later PRs' work.
//
// Design. One block per (b, kv head, tile of QT = 64 folded query rows);
// the innermost key axis of the Pallas grid becomes a loop over KT = 32 key
// positions at a time from the tile's first visible key (its window edge)
// to its last (its causal edge, or seq_k), so fully masked key tiles are
// never loaded, as the TPU kernel's pl.when skip does. Q (fp32, scaled),
// the K tile and the V tile live in shared memory (rows padded by one float
// against bank conflicts); each thread owns 4 query rows x 4 key columns of
// the score tile and 4 rows x D/8 columns of the output, with the row max
// and row sum reduced over the 8 lanes that share a row. Head dims 64, 80
// (zamba2) and 128 are instantiated.
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
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q,     // (B, Sq, KH*G, D)
    const T* __restrict__ k,     // (B, Sk, KH, D)
    const T* __restrict__ v,
    T* __restrict__ out,         // (B, Sq, KH*G, D)
    int Sq, int Sk, int KH, int G, int seq_k, int causal, int window,
    float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kKT + 1;
  constexpr int OC = D / 8;             // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // kQT x DP
  float* Ks = Qs + kQT * DP;            // kKT x DP
  float* Vs = Ks + kKT * DP;            // kKT x D
  float* Ps = Vs + kKT * D;             // kQT x PP

  const int b = blockIdx.x, kh = blockIdx.y, row0 = blockIdx.z * kQT;
  const int R = Sq * G, H = KH * G;
  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;
  const T* kb = k + (size_t)b * Sk * KH * D + (size_t)kh * D;
  const T* vb = v + (size_t)b * Sk * KH * D + (size_t)kh * D;

  for (int i = tid; i < kQT * D; i += kThreads) {
    const int r = i / D, d = i % D, row = row0 + r;
    float val = 0.f;
    if (row < R) {
      const int c = row / G, g = row % G;
      val = to_f(q[(((size_t)b * Sq + c) * H + (size_t)kh * G + g) * D + d]) *
            scale;
    }
    Qs[r * DP + d] = val;
  }

  // keys this tile can see: [kbeg, kend)
  const int first_q = row0 / G;
  const int last_q = (min(row0 + kQT, R) - 1) / G;
  const int kbeg = window > 0 ? max(0, first_q - window + 1) : 0;
  const int kend = causal ? min(seq_k, last_q + 1) : seq_k;

  float m[4], l[4], o[4][OC];
  int qpos[4];
  bool rvalid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + tr + 16 * i;
    rvalid[i] = row < R;
    qpos[i] = row / G;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) o[i][c] = 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 += kKT) {
    __syncthreads();   // Qs written / previous tile's Ks, Vs, Ps consumed
    for (int i = tid; i < kKT * D; i += kThreads) {
      const int j = i / D, d = i % D, p = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (p < kend) {
        const size_t off = (size_t)p * KH * D + d;
        kv = to_f(kb[off]);
        vv = to_f(vb[off]);
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
        ok[j] = rvalid[i] && p < kend && (!causal || p <= qpos[i]) &&
                (window <= 0 || qpos[i] - p < window);
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
    T* op = out + (((size_t)b * Sq + c0) * H + (size_t)kh * G + g) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < OC; ++c) store(op + tc + 8 * c, o[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int KH, int G, int seq_k, int causal, int window,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static bool attr_set = false;   // per instantiation, first launch only
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int R = Sq * G;
  dim3 grid(B, KH, (R + kQT - 1) / kQT);
  const float scale = 1.0f / sqrtf((float)D);
  flash_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, KH, G, seq_k,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* out,
             int B, int Sq, int Sk, int KH, int G, int seq_k, int causal,
             int window, cudaStream_t s) {
  if (D == 64)
    return launch<T, 64>(q, k, v, out, B, Sq, Sk, KH, G, seq_k, causal,
                         window, s);
  if (D == 80)
    return launch<T, 80>(q, k, v, out, B, Sq, Sk, KH, G, seq_k, causal,
                         window, s);
  if (D == 128)
    return launch<T, 128>(q, k, v, out, B, Sq, Sk, KH, G, seq_k, causal,
                          window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out: (B, Sq, KH*G, D); k, v:
// (B, Sk, KH, D); all contiguous. seq_k <= Sk keys are valid; window 0 means
// unlimited; causal 0 or 1.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Sk, int KH, int G, int D, int seq_k,
                                   int causal, int window, int dtype,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || G <= 0 || seq_k < 0 ||
      seq_k > Sk || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, out, B, Sq, Sk, KH, G, seq_k, causal,
                           window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, out, B, Sq, Sk, KH, G, seq_k,
                                   causal, window, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
