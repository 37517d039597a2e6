// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd/kernel.py  _ssd_kernel / ssd_fwd
//
// What it computes (the contract of models.mamba2.ssd_chunked with h0 = 0).
// x: (b, s, h, p) already multiplied by dt, in the model dtype; a: (b, s, h)
// float32 log decay (<= 0); B, C: (b, s, n), one group shared by every head,
// row stride given (they are column slices of the conv output). For each
// chunk of Q = min(chunk, s) positions, with acs = the chunk's inclusive
// cumulative sum of a:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(acs_i - acs_j) x_j
//           + exp(acs_i) C_i . state            (state entering the chunk)
//   state = exp(acs_last) state + sum_j exp(acs_last - acs_j) x_j B_j^T
// y is written in x's dtype and layout; the final state (b, h, p, n) in
// float32. Positions past s (the ragged last chunk) act as zero input with
// zero decay, as the reference's padding does: they add nothing and leave
// the state as it is. exp(acs_i - acs_j) is computed only for i >= j: above
// the diagonal it would overflow, and inf * 0 is NaN.
//
// What bounds it on the H100. At zamba2-2.7b's prefill (b = 1, h = 80,
// p = 64, n = 64, Q = 256) a 2048-token prompt needs about 8 GFLOP of
// products per layer against about 1.3 MB of x, y, a, B and C: thousands of
// flops per byte, so the least time is the flops over the tensor cores.
// This first version multiplies in fp32 FMA on the CUDA cores from shared
// memory, and the grid is only b * h blocks (80 for zamba2, 24 for
// mamba2-130m, on 132 SMs); tensor cores and a split of a head over p are
// later PRs' work.
//
// Design. The TPU grid (b*h, chunks) carried the state in VMEM scratch from
// one grid step to the next; on Hopper blocks run in no order, so one block
// per (b, h) loops over the chunks itself and keeps the (p, n) float32
// state in shared memory. Inside a chunk the rows are tiled by kT = 64
// (a 256-row chunk of B and C in f32 at n = 128 would take 128 KB each):
// for each tile of rows i, the tiles j <= i give the (kT x kT) weights
// W = (C_i B_j^T) * exp(acs_i - acs_j) in shared memory and then y_i += W x_j;
// the state term follows once per tile, and the last row tile's pass over
// every j tile also accumulates the state update in registers, applied
// after that tile has read the old state. x, B and C are read straight from
// their (b, s, h, p) and (b, s, n) layouts: no transposes and no per-head
// broadcast copies. Tiles are staged in shared memory as float32 (converted
// once on load, so the inner loops do no conversions); rows are padded by
// one float against bank conflicts. Each of the 256 threads owns a 4 x 4
// block of W, a 4 x (p/16) block of y and a (p/16) x (n/16) block of the
// state update.
//
// Launches on the caller's stream, allocates nothing, does not synchronise.
// The entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // rows per tile (both i and j)
constexpr int kThreads = 256;   // 16 row groups x 16 column lanes
constexpr int kMaxQ = 256;      // chunk length limit: one scan entry a thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int P, int N>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)P * (N + 1)          // state
                          + 2 * (size_t)kT * (N + 1)   // C tile, B tile
                          + (size_t)kT * P             // x tile
                          + (size_t)kT * (kT + 1)      // W tile
                          + 2 * kMaxQ + 32);           // acs, decay, scan
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_kernel(
    const T* __restrict__ x,          // (b, s, h, P)
    const float* __restrict__ a,      // (b, s, h)
    const T* __restrict__ Bm,         // (b, s, N), strides (bc_b, bc_s, 1)
    const T* __restrict__ Cm,
    T* __restrict__ y,                // (b, s, h, P)
    float* __restrict__ final_state,  // (b, h, P, N)
    int S, int H, int Q, long long bc_b, long long bc_s) {
  constexpr int NP = N + 1;
  constexpr int TP = kT + 1;
  constexpr int PC = P / 16;          // y columns / state rows per thread
  constexpr int NC = N / 16;          // state columns per thread
  extern __shared__ float smem[];
  float* st = smem;                   // P x NP
  float* Cs = st + P * NP;            // kT x NP
  float* Bs = Cs + kT * NP;           // kT x NP
  float* Xs = Bs + kT * NP;           // kT x P
  float* Ws = Xs + kT * P;            // kT x TP
  float* acs = Ws + kT * TP;          // kMaxQ
  float* dec = acs + kMaxQ;           // kMaxQ: exp(acs_last - acs_j)
  float* wsum = dec + kMaxQ;          // 32

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t xrow = (size_t)H * P;  // x / y elements between positions
  const T* xb = x + (size_t)b * S * xrow + (size_t)h * P;
  T* yb = y + (size_t)b * S * xrow + (size_t)h * P;
  const float* ab = a + (size_t)b * S * H + h;
  const T* Bb = Bm + (size_t)b * bc_b;
  const T* Cb = Cm + (size_t)b * bc_b;

  for (int e = tid; e < P * NP; e += kThreads) st[e] = 0.f;

  const int nchunks = (S + Q - 1) / Q;
  const int ntiles = (Q + kT - 1) / kT;
  for (int c = 0; c < nchunks; ++c) {
    const size_t c0 = (size_t)c * Q;       // first position of the chunk
    const int qv = min(Q, S - (int)c0);    // its valid rows
    __syncthreads();   // the previous chunk is done with acs, dec, wsum, st

    // inclusive prefix sum of a over the chunk (rows >= qv add 0)
    float v = tid < qv ? ab[(c0 + tid) * H] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float w = lane < kThreads / 32 ? wsum[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < kThreads / 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += u;
      }
      if (lane < kThreads / 32) wsum[lane] = w;
    }
    __syncthreads();
    if (warp > 0) v += wsum[warp - 1];
    acs[tid] = v;
    __syncthreads();
    const float a_sum = acs[kMaxQ - 1];    // rows past qv added 0
    dec[tid] = expf(a_sum - v);
    // dec is first read after the tile loads' __syncthreads below

    float sacc[PC][NC];
#pragma unroll
    for (int i = 0; i < PC; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) sacc[i][j] = 0.f;

    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * kT;
      const bool last = it == ntiles - 1;
      for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N, col = e % N, i = i0 + r;
        Cs[r * NP + col] =
            i < qv ? to_f(Cb[(c0 + i) * bc_s + col]) : 0.f;
      }
      float yacc[4][PC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PC; ++j) yacc[i][j] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        for (int e = tid; e < kT * N; e += kThreads) {
          const int r = e / N, col = e % N, j = j0 + r;
          Bs[r * NP + col] =
              j < qv ? to_f(Bb[(c0 + j) * bc_s + col]) : 0.f;
        }
        for (int e = tid; e < kT * P; e += kThreads) {
          const int r = e / P, col = e % P, j = j0 + r;
          Xs[r * P + col] = j < qv ? to_f(xb[(c0 + j) * xrow + col]) : 0.f;
        }
        __syncthreads();

        // W = (C_i . B_j) * exp(acs_i - acs_j), lower triangle only
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(tr + 16 * i) * NP + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tc + 16 * j) * NP + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ii = i0 + tr + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int jj = j0 + tc + 16 * j;
            Ws[(tr + 16 * i) * TP + tc + 16 * j] =
                ii >= jj ? s[i][j] * expf(acs[ii] - acs[jj]) : 0.f;
          }
        }
        __syncthreads();

        // y_i += W x_j
#pragma unroll 4
        for (int j = 0; j < kT; ++j) {
          float wv[4], xv[PC];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = Ws[(tr + 16 * i) * TP + j];
#pragma unroll
          for (int cc = 0; cc < PC; ++cc) xv[cc] = Xs[j * P + tc + 16 * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int cc = 0; cc < PC; ++cc)
              yacc[i][cc] = fmaf(wv[i], xv[cc], yacc[i][cc]);
        }
        if (last) {
          // the last row tile visits every j tile: state update terms
#pragma unroll 4
          for (int j = 0; j < kT; ++j) {
            const float dj = dec[j0 + j];
            float xv[PC], bv[NC];
#pragma unroll
            for (int pp = 0; pp < PC; ++pp)
              xv[pp] = Xs[j * P + tr + 16 * pp] * dj;
#pragma unroll
            for (int nn = 0; nn < NC; ++nn) bv[nn] = Bs[j * NP + tc + 16 * nn];
#pragma unroll
            for (int pp = 0; pp < PC; ++pp)
#pragma unroll
              for (int nn = 0; nn < NC; ++nn)
                sacc[pp][nn] = fmaf(xv[pp], bv[nn], sacc[pp][nn]);
          }
        }
        __syncthreads();   // Bs, Xs, Ws consumed
      }

      // y_i += exp(acs_i) * C_i . state (the state entering the chunk)
      float yo[4][PC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < PC; ++cc) yo[i][cc] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PC];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(tr + 16 * i) * NP + n];
#pragma unroll
        for (int cc = 0; cc < PC; ++cc) sv[cc] = st[(tc + 16 * cc) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int cc = 0; cc < PC; ++cc)
            yo[i][cc] = fmaf(cv[i], sv[cc], yo[i][cc]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ii = i0 + tr + 16 * i;
        if (ii >= qv) continue;
        const float e = expf(acs[ii]);
        T* yp = yb + (c0 + ii) * xrow;
#pragma unroll
        for (int cc = 0; cc < PC; ++cc)
          store(yp + tc + 16 * cc, fmaf(e, yo[i][cc], yacc[i][cc]));
      }
      __syncthreads();   // Cs and st consumed
    }

    // advance the state; each thread rewrites only its own entries
    const float da = expf(a_sum);
#pragma unroll
    for (int pp = 0; pp < PC; ++pp)
#pragma unroll
      for (int nn = 0; nn < NC; ++nn) {
        float* sp = st + (tr + 16 * pp) * NP + tc + 16 * nn;
        *sp = fmaf(da, *sp, sacc[pp][nn]);
      }
  }
  __syncthreads();
  float* fs = final_state + ((size_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    fs[e] = st[(e / N) * NP + e % N];
}

template <typename T, int P, int N>
int launch(const void* x, const float* a, const void* B, const void* C,
           void* y, float* fs, int b, int S, int H, int Q, long long bc_b,
           long long bc_s, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<P, N>();
  static bool attr_set = false;   // per instantiation, first launch only
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(H, b);
  ssd_kernel<T, P, N><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), fs, S, H, Q, bc_b, bc_s);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int P, int N, const void* x, const float* a, const void* B,
             const void* C, void* y, float* fs, int b, int S, int H, int Q,
             long long bc_b, long long bc_s, cudaStream_t s) {
  if (P == 64 && N == 64)
    return launch<T, 64, 64>(x, a, B, C, y, fs, b, S, H, Q, bc_b, bc_s, s);
  if (P == 64 && N == 128)
    return launch<T, 64, 128>(x, a, B, C, y, fs, b, S, H, Q, bc_b, bc_s, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y). x, y: (b, S, H, P)
// contiguous; a: (b, S, H) float32 contiguous; B, C: (b, S, N) with element
// strides (bc_b, bc_s, 1); final_state: (b, H, P, N) float32. Q <= 256.
extern "C" int ssd_fwd(const void* x, const float* a, const void* B,
                       const void* C, void* y, float* final_state, int b,
                       int S, int H, int P, int N, int Q, int bc_b, int bc_s,
                       int dtype, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || Q <= 0 || Q > kMaxQ || bc_b < 0 ||
      bc_s < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(P, N, x, a, B, C, y, final_state, b, S, H, Q, bc_b,
                           bc_s, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(P, N, x, a, B, C, y, final_state, b, S, H,
                                   Q, bc_b, bc_s, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
