// Paged decode attention for Hopper (sm_90a), with and without an
// in-flight tail.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   src/repro/kernels/paged_attention/kernel.py  _decode_tail_kernel /
//       paged_decode_tail_fwd   -> paged_decode_tail_fwd below
//   src/repro/kernels/paged_attention/kernel.py  _paged_kernel /
//       paged_attention_fwd     -> paged_attention_fwd below (no tail)
//
// What it computes. For each (sequence b, kv head kh) the G query heads of
// the group attend the committed positions [0, context_lens[b]) read from
// the page pool through block_tables[b], then the tail rows
// [0, tail_lens[b]) of this call's (B, Kt, KH, D) tail buffers, under ONE
// online softmax: scores in fp32 with q pre-scaled by 1/sqrt(D), output
// acc / max(l, 1e-30) (an empty context with an empty tail gives zeros),
// stored in the input dtype.
//
// What bounds it on the H100: device-memory bytes. Each (b, kh) reads
// (ctx + tail) * D * 2 operands once and does 4 * G * D flops per position:
// about G (= 3 on llama3.2-3b) flops per byte in bf16, two orders of
// magnitude under the card's ~295 flop/byte ridge. The least time is the
// K/V bytes over 3.35 TB/s.
//
// Design. The Pallas grid's sequential page axis becomes a loop inside one
// block per (b, kh, group of up to GC query heads); the block reads its own
// row of the block table (the TPU kernel got it by scalar prefetch). The
// warps split the positions: a warp takes 32 / (D * sizeof(T) / 16)
// positions per pass, the lanes of one position split D with 16-byte loads,
// so each position row is one contiguous 128- or 256-byte read. Every
// such lane group keeps its own online-softmax state for all its query
// heads and issues UNROLL positions' loads before using any of them, so
// several loads are in flight per thread. A final pass combines the
// states of all lane groups through shared memory. The tail is folded into
// the same accumulators as positions past the context. There is no
// padding of G or Kt (the TPU wrapper padded both to sublane tiles): any G
// and any Kt, ragged edges masked.
//
// First thing a later PR fixes: at the serving shape (B = 8 sequences,
// KH = 8 kv heads) this launches 64 blocks, fewer than the 132 SMs, and
// each SM holds at most one of them, so the card's bandwidth is far from
// reached. Split-K over pages (several blocks per (b, kh), each a slice of
// the pages) plus a combine pass fills the card.
//
// Launches on the caller's stream, allocates nothing, does not synchronise.
// Each entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kUnroll = 4;

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  using Raw = float4;
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
};

__device__ __forceinline__ void unpack(const float4& r, float* f) {
  f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
}
__device__ __forceinline__ void unpack(const uint4& r, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int D, int GC>
__global__ void __launch_bounds__(kWarps * 32) paged_decode_kernel(
    const T* __restrict__ q,            // (B, KH*G, D)
    const T* __restrict__ k_pages,      // (NP, page, KH, D)
    const T* __restrict__ v_pages,
    const int* __restrict__ tables,     // (B, pps)
    const int* __restrict__ ctx_lens,   // (B,)
    const T* __restrict__ k_tail,       // (B, kt_cap, KH, D) or null
    const T* __restrict__ v_tail,
    const int* __restrict__ tail_lens,  // (B,) or null
    T* __restrict__ out,                // (B, KH*G, D)
    int KH, int G, int page_size, int pps, int kt_cap, float scale) {
  constexpr int VN = Vec16<T>::N;
  using Raw = typename Vec16<T>::Raw;
  constexpr int TPR = D / VN;               // lanes per position row
  constexpr int RPW = 32 / TPR;             // positions per warp per pass
  constexpr int NSTREAM = kWarps * RPW;     // independent softmax states
  static_assert(TPR <= 32 && 32 % TPR == 0, "head dim / dtype unsupported");

  __shared__ float sm_m[NSTREAM][GC];
  __shared__ float sm_l[NSTREAM][GC];
  __shared__ float sm_acc[NSTREAM][GC][D];

  const int b = blockIdx.x, kh = blockIdx.y, g0 = blockIdx.z * GC;
  const int ng = min(GC, G - g0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / TPR, part = lane % TPR;
  const int stream = warp * RPW + sub;
  const int H = KH * G;

  float qf[GC][VN];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g < ng) {
      const T* qp = q + ((size_t)b * H + (size_t)kh * G + g0 + g) * D
                    + part * VN;
      unpack(*reinterpret_cast<const Raw*>(qp), qf[g]);
#pragma unroll
      for (int e = 0; e < VN; ++e) qf[g][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) qf[g][e] = 0.f;
    }
  }
  float m[GC], l[GC], acc[GC][VN];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[g][e] = 0.f;
  }

  const int ctx = min(ctx_lens[b], pps * page_size);
  const int tl = tail_lens != nullptr ? min(tail_lens[b], kt_cap) : 0;
  const int total = ctx + tl;
  const int* tab = tables + (size_t)b * pps;

  // `it` is warp-uniform, so every lane of a warp runs the same passes and
  // the shuffles below always see all 32 lanes
  for (int it = warp * RPW; it < total; it += NSTREAM * kUnroll) {
    Raw kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = it + sub + u * NSTREAM;
      ok[u] = p < total;
      kr[u] = Raw{};
      vr[u] = Raw{};
      if (ok[u]) {
        size_t row;
        const T *kb, *vb;
        if (p < ctx) {
          const int page = tab[p / page_size];
          row = ((size_t)page * page_size + p % page_size) * KH + kh;
          kb = k_pages;
          vb = v_pages;
        } else {
          row = ((size_t)b * kt_cap + (p - ctx)) * KH + kh;
          kb = k_tail;
          vb = v_tail;
        }
        kr[u] = *reinterpret_cast<const Raw*>(kb + row * D + part * VN);
        vr[u] = *reinterpret_cast<const Raw*>(vb + row * D + part * VN);
      }
    }
    float s[kUnroll][GC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[VN];
      unpack(kr[u], kf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VN; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u][g] = d;
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][g]);
      const float corr = expf(m[g] - mx);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u][g] = ok[u] ? expf(s[u][g] - mx) : 0.f;   // now p
        psum += s[u][g];
      }
      l[g] = l[g] * corr + psum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < VN; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vf[VN];
      unpack(vr[u], vf);
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[g][e] = fmaf(s[u][g], vf[e], acc[g][e]);
    }
  }

  // combine the NSTREAM partial softmax states
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (part == 0) {
      sm_m[stream][g] = m[g];
      sm_l[stream][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) sm_acc[stream][g][part * VN + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ng * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float M = kNegInf;
#pragma unroll
    for (int s2 = 0; s2 < NSTREAM; ++s2) M = fmaxf(M, sm_m[s2][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < NSTREAM; ++s2) {
      const float w = expf(sm_m[s2][g] - M);
      L += sm_l[s2][g] * w;
      A += sm_acc[s2][g][d] * w;
    }
    store(out + ((size_t)b * H + (size_t)kh * G + g0 + g) * D + d,
          A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D, int GC>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* ctx_lens, const void* kt, const void* vt,
           const int* tail_lens, void* out, int B, int KH, int G,
           int page_size, int pps, int kt_cap, cudaStream_t stream) {
  dim3 grid(B, KH, (G + GC - 1) / GC);
  const float scale = 1.0f / sqrtf((float)D);
  paged_decode_kernel<T, D, GC><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, ctx_lens,
      static_cast<const T*>(kt), static_cast<const T*>(vt), tail_lens,
      static_cast<T*>(out), KH, G, page_size, pps, kt_cap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, int G, const void* q, const void* kp, const void* vp,
             const int* tables, const int* ctx_lens, const void* kt,
             const void* vt, const int* tail_lens, void* out, int B, int KH,
             int page_size, int pps, int kt_cap, cudaStream_t s) {
  const bool small = G <= 4;
  if (D == 128)
    return small ? launch<T, 128, 4>(q, kp, vp, tables, ctx_lens, kt, vt,
                                     tail_lens, out, B, KH, G, page_size, pps,
                                     kt_cap, s)
                 : launch<T, 128, 8>(q, kp, vp, tables, ctx_lens, kt, vt,
                                     tail_lens, out, B, KH, G, page_size, pps,
                                     kt_cap, s);
  if (D == 64)
    return small ? launch<T, 64, 4>(q, kp, vp, tables, ctx_lens, kt, vt,
                                    tail_lens, out, B, KH, G, page_size, pps,
                                    kt_cap, s)
                 : launch<T, 64, 8>(q, kp, vp, tables, ctx_lens, kt, vt,
                                    tail_lens, out, B, KH, G, page_size, pps,
                                    kt_cap, s);
  return (int)cudaErrorInvalidValue;
}

int entry(const void* q, const void* kp, const void* vp, const int* tables,
          const int* ctx_lens, const void* kt, const void* vt,
          const int* tail_lens, void* out, int B, int KH, int G, int D,
          int page_size, int pps, int kt_cap, int dtype, void* stream) {
  if (B <= 0 || KH <= 0 || G <= 0 || pps <= 0 || page_size <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, G, q, kp, vp, tables, ctx_lens, kt, vt,
                           tail_lens, out, B, KH, page_size, pps, kt_cap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, G, q, kp, vp, tables, ctx_lens, kt, vt,
                                   tail_lens, out, B, KH, page_size, pps,
                                   kt_cap, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out: (B, KH*G, D); pages:
// (NP, page_size, KH, D); tables: (B, pps) int32; lens: (B,) int32;
// tails: (B, kt_cap, KH, D). All contiguous.
extern "C" int paged_decode_tail_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const int* tables, const int* ctx_lens, const void* k_tail,
    const void* v_tail, const int* tail_lens, void* out, int B, int KH, int G,
    int D, int page_size, int pps, int kt_cap, int dtype, void* stream) {
  if (k_tail == nullptr || v_tail == nullptr || tail_lens == nullptr ||
      kt_cap <= 0)
    return (int)cudaErrorInvalidValue;
  return entry(q, k_pages, v_pages, tables, ctx_lens, k_tail, v_tail,
               tail_lens, out, B, KH, G, D, page_size, pps, kt_cap, dtype,
               stream);
}

extern "C" int paged_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const int* tables, const int* ctx_lens, void* out, int B, int KH, int G,
    int D, int page_size, int pps, int dtype, void* stream) {
  return entry(q, k_pages, v_pages, tables, ctx_lens, nullptr, nullptr,
               nullptr, out, B, KH, G, D, page_size, pps, 0, dtype, stream);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
