// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd/kernel.py  _ssd_kernel / ssd_fwd
//
// What it computes (the contract of models.mamba2.ssd_chunked with h0 = 0).
// x: (b, s, h, p) already multiplied by dt, in the model dtype; a: (b, s, h)
// float32 log decay (<= 0); B, C: (b, s, g, n), g groups, head i reading
// group i / (h / g) (g = 1: one group shared by every head), strides given
// (they are column slices of the conv output). For each
// chunk of Q = min(chunk, s) positions, with acs = the chunk's inclusive
// cumulative sum of a:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(acs_i - acs_j) x_j
//           + exp(acs_i) C_i . state            (state entering the chunk)
//   state = exp(acs_last) state + sum_j exp(acs_last - acs_j) x_j B_j^T
// y is written in x's dtype and layout; the final state (b, h, p, n) in
// float32. Positions past s (the ragged last chunk) act as zero input with
// zero decay, as the reference's padding does: they add nothing and leave
// the state as it is. exp(acs_i - acs_j) is used only for i >= j: above the
// diagonal it overflows, and inf * 0 is NaN.
//
// What bounds it on the H100. At zamba2-2.7b's prefill (b = 1, s = 2048,
// h = 80, p = 64, n = 64, Q = 256) x and y are 21 MB each in bf16; with a,
// B, C and the final state the call must move about 44 MB. Its products
// come to about 5.4 GFLOP, some 120 flops a byte, below the ~295 flops a
// byte at which the bf16 tensor cores rather than device memory would set
// the pace. So the bound is the bytes over the memory rate, about 0.013 ms.
// The design puts the products on the tensor cores and enough blocks in
// flight that each pass is left with moving its bytes (from device memory
// or L2). The workspace between the passes adds 16 MB at this shape (f32
// chunk states, their bf16 copies, the cumsums of a), each written once.
//
// Design, bf16 (three launches on the caller's stream; the TPU grid's
// sequential chunk axis becomes one short sequential pass between two
// chunk-parallel ones, so thousands of blocks fill 132 SMs):
//  1. chunk_state, one warpgroup per (chunk, head, b): the chunk's inclusive
//     cumsum of a (written to the workspace for pass 3) and its local state
//     s_c = sum_j exp(acs_last - acs_j) x_j B_j^T, a (p x n) product over
//     the chunk's positions as wgmma: the decay-weighted x^T is the A
//     operand, built in registers from an x tile in shared memory; the B
//     tile is read MN-major (V's layout in attention_tc.cuh). Rounding the
//     weighted x to one bf16 would cost the final state 2e-3 to 3e-3 of its
//     scale, so it is split into hi + lo bf16 and both products go into one
//     fp32 accumulator. s_c is written in fp32.
//  2. state_pass, one thread per state element of (head, b): walks the
//     chunks in order in fp32, S_c = exp(a_sum_c) S_{c-1} + s_c, writes the
//     state entering each chunk in bf16 and the final state in fp32.
//  3. chunk_scan, one warpgroup per (64-row tile, chunk, head, b): the
//     attention core with the decay mask in place of the softmax.
//     y = exp(acs_i) C_i S_{c-1}^T first (S K-major in shared memory), then
//     for each 64-key tile j <= i: G = C_i B_j^T (C in registers, B K-major:
//     QK^T's layout), W = G exp(acs_i - acs_j) masked to i >= j on the
//     diagonal tile, W rounded to bf16 in registers, y += W x_j (x MN-major:
//     PV's layout). Key tiles above the diagonal are never loaded; B and x
//     tiles come by cp.async through a two-stage ring.
// float32 inputs keep the first version's kernel (ssd_fma_kernel): one
// block per (b, head) loops over the chunks with the state in shared
// memory and multiplies in fp32 FMA on the CUDA cores.
//
// Launches on the caller's stream, allocates nothing (the caller passes the
// workspace, ssd_workspace_bytes() long), does not synchronise. The entry
// returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

namespace tc = attn_tc;
using bf16 = __nv_bfloat16;

constexpr int kMaxQ = 256;      // chunk length limit

// ---------------------------------------------------------------------------
// float32: the FMA kernel
// ---------------------------------------------------------------------------

constexpr int kT = 64;            // rows per tile (both i and j)
constexpr int kFmaThreads = 256;  // 16 row groups x 16 column lanes

template <int P, int N>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * ((size_t)P * (N + 1)          // state
                          + 2 * (size_t)kT * (N + 1)   // C tile, B tile
                          + (size_t)kT * P             // x tile
                          + (size_t)kT * (kT + 1)      // W tile
                          + 2 * kMaxQ + 32);           // acs, decay, scan
}

// One block per (b, h) loops over the chunks and keeps the (p, n) float32
// state in shared memory. Inside a chunk the rows are tiled by kT = 64: for
// each tile of rows i, the tiles j <= i give the (kT x kT) weights W in
// shared memory and then y_i += W x_j; the state term follows once per
// tile, and the last row tile's pass over every j tile also accumulates the
// state update in registers, applied after that tile has read the old
// state. Rows are padded by one float against bank conflicts. Each of the
// 256 threads owns a 4 x 4 block of W, a 4 x (p/16) block of y and a
// (p/16) x (n/16) block of the state update.
template <int P, int N>
__global__ void __launch_bounds__(kFmaThreads) ssd_fma_kernel(
    const float* __restrict__ x,      // (b, s, h, P)
    const float* __restrict__ a,      // (b, s, h)
    const float* __restrict__ Bm,     // (b, s, g, N), strides (bc_b, bc_s,
    const float* __restrict__ Cm,     // bc_g, 1)
    float* __restrict__ y,            // (b, s, h, P)
    float* __restrict__ final_state,  // (b, h, P, N)
    int S, int H, int Q, long long bc_b, long long bc_s, int hpg,
    long long bc_g) {
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
  const int tid = threadIdx.x, tr = tid >> 4, tc_ = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t xrow = (size_t)H * P;  // x / y elements between positions
  const float* xb = x + (size_t)b * S * xrow + (size_t)h * P;
  float* yb = y + (size_t)b * S * xrow + (size_t)h * P;
  const float* ab = a + (size_t)b * S * H + h;
  const float* Bb = Bm + (size_t)b * bc_b + (size_t)(h / hpg) * bc_g;
  const float* Cb = Cm + (size_t)b * bc_b + (size_t)(h / hpg) * bc_g;

  for (int e = tid; e < P * NP; e += kFmaThreads) st[e] = 0.f;

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
      float w = lane < kFmaThreads / 32 ? wsum[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < kFmaThreads / 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += u;
      }
      if (lane < kFmaThreads / 32) wsum[lane] = w;
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
      for (int e = tid; e < kT * N; e += kFmaThreads) {
        const int r = e / N, col = e % N, i = i0 + r;
        Cs[r * NP + col] = i < qv ? Cb[(c0 + i) * bc_s + col] : 0.f;
      }
      float yacc[4][PC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PC; ++j) yacc[i][j] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        for (int e = tid; e < kT * N; e += kFmaThreads) {
          const int r = e / N, col = e % N, j = j0 + r;
          Bs[r * NP + col] = j < qv ? Bb[(c0 + j) * bc_s + col] : 0.f;
        }
        for (int e = tid; e < kT * P; e += kFmaThreads) {
          const int r = e / P, col = e % P, j = j0 + r;
          Xs[r * P + col] = j < qv ? xb[(c0 + j) * xrow + col] : 0.f;
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
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tc_ + 16 * j) * NP + n];
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
            const int jj = j0 + tc_ + 16 * j;
            Ws[(tr + 16 * i) * TP + tc_ + 16 * j] =
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
          for (int cc = 0; cc < PC; ++cc) xv[cc] = Xs[j * P + tc_ + 16 * cc];
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
            for (int nn = 0; nn < NC; ++nn)
              bv[nn] = Bs[j * NP + tc_ + 16 * nn];
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
        for (int cc = 0; cc < PC; ++cc) sv[cc] = st[(tc_ + 16 * cc) * NP + n];
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
        float* yp = yb + (c0 + ii) * xrow;
#pragma unroll
        for (int cc = 0; cc < PC; ++cc)
          yp[tc_ + 16 * cc] = fmaf(e, yo[i][cc], yacc[i][cc]);
      }
      __syncthreads();   // Cs and st consumed
    }

    // advance the state; each thread rewrites only its own entries
    const float da = expf(a_sum);
#pragma unroll
    for (int pp = 0; pp < PC; ++pp)
#pragma unroll
      for (int nn = 0; nn < NC; ++nn) {
        float* sp = st + (tr + 16 * pp) * NP + tc_ + 16 * nn;
        *sp = fmaf(da, *sp, sacc[pp][nn]);
      }
  }
  __syncthreads();
  float* fs = final_state + ((size_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kFmaThreads)
    fs[e] = st[(e / N) * NP + e % N];
}

template <int P, int N>
int launch_fma(const void* x, const float* a, const void* B, const void* C,
               void* y, float* fs, int b, int S, int H, int Q, long long bc_b,
               long long bc_s, int hpg, long long bc_g, cudaStream_t stream) {
  constexpr size_t bytes = fma_smem_bytes<P, N>();
  static bool attr_set = false;   // per instantiation, first launch only
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_fma_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(H, b);
  ssd_fma_kernel<P, N><<<grid, kFmaThreads, bytes, stream>>>(
      static_cast<const float*>(x), a, static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), fs, S, H, Q, bc_b,
      bc_s, hpg, bc_g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: three chunk-parallel passes on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kP = 64;              // head dim of the tensor-core route
constexpr int kTile = 64;           // chunk rows per tile (wgmma M, key tile)
constexpr int kTilesPerChunk = kMaxQ / kTile;
constexpr int kWG = tc::kThreads;   // one warpgroup
constexpr int kPassThreads = 256;   // state pass
constexpr int kXPitch = kP + 8;     // pass 1's x rows in bf16, padded

// a 64-row tile of N bf16 columns in the 128-byte swizzle (64-column blocks)
template <int N>
__host__ __device__ constexpr int tile_bytes() {
  return (N / 64) * tc::kBlockBytes;
}
template <int N>
constexpr size_t state_smem_bytes() {   // pass 1
  return 1024 + (size_t)kTilesPerChunk * tile_bytes<N>()   // B, swizzled
         + (size_t)kMaxQ * kXPitch * sizeof(bf16)          // x, padded
         + 2 * kMaxQ * sizeof(float) + 16;                 // acs, dec, scan
}
template <int N>
constexpr size_t scan_smem_bytes() {    // pass 3
  return 1024 + (size_t)tile_bytes<N>()                        // S_{c-1}
         + 2 * ((size_t)tile_bytes<N>() + tc::kBlockBytes)     // ring: B, x
         + kMaxQ * sizeof(float);                              // acs
}

// workspace, in bytes from its start: per (b, h, chunk) the f32 local
// states, the bf16 entering states and the f32 cumsums of a
struct Workspace {
  size_t states, prev, acs, total;
};
Workspace workspace_layout(int b, int S, int H, int N, int Q) {
  const size_t heads = (size_t)b * H * ((S + Q - 1) / Q);
  auto up = [](size_t v) { return (v + 255) & ~(size_t)255; };
  Workspace w;
  w.states = 0;
  w.prev = up(heads * kP * N * sizeof(float));
  w.acs = w.prev + up(heads * kP * N * sizeof(bf16));
  w.total = w.acs + up(heads * Q * sizeof(float));
  return w;
}

struct Geometry {
  dim3 grid[3];
  int threads[3];
  size_t smem[3];
};
template <int N>
Geometry geometry(int b, int S, int H, int Q) {
  const int nc = (S + Q - 1) / Q;
  Geometry g;
  g.grid[0] = dim3(nc, H, b);
  g.threads[0] = kWG;
  g.smem[0] = state_smem_bytes<N>();
  g.grid[1] = dim3((kP * N + kPassThreads - 1) / kPassThreads, H, b);
  g.threads[1] = kPassThreads;
  g.smem[1] = 0;
  g.grid[2] = dim3((Q + kTile - 1) / kTile, nc, H * b);
  g.threads[2] = kWG;
  g.smem[2] = scan_smem_bytes<N>();
  return g;
}

__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: tc::cp_async_wait<0>(); break;
    case 1: tc::cp_async_wait<1>(); break;
    case 2: tc::cp_async_wait<2>(); break;
    default: tc::cp_async_wait<3>(); break;
  }
}

// v0, v1 (consecutive k) as a bf16 pair hi and the pair of what hi leaves
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Pass 1: grid (chunks, H, b), one warpgroup. Writes s_c (kP x N, f32) and
// the chunk's Q cumsums of a.
template <int N>
__global__ void __launch_bounds__(kWG) ssd_chunk_state_kernel(
    const bf16* __restrict__ x, const float* __restrict__ a,
    const bf16* __restrict__ Bm, float* __restrict__ states,
    float* __restrict__ acs_out, int S, int H, int Q, long long bc_b,
    long long bc_s, int hpg, long long bc_g) {
  constexpr int TB = tile_bytes<N>();
  constexpr int CPR = N / 8;               // 16-byte chunks of a B row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + (base - raw) +
                                     kTilesPerChunk * TB);
  float* acs = reinterpret_cast<float*>(xs + kMaxQ * kXPitch);
  float* dec = acs + kMaxQ;
  __shared__ float wsum[kWG / 32];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t c0 = (size_t)c * Q;
  const int qv = min(Q, S - (int)c0);
  const int ntq = (Q + kTile - 1) / kTile;
  const size_t xrow = (size_t)H * kP;
  const bf16* xb = x + ((size_t)b * S + c0) * xrow + (size_t)h * kP;
  const bf16* Bb =
      Bm + (size_t)b * bc_b + c0 * bc_s + (size_t)(h / hpg) * bc_g;

  // one copy group per 64-row tile of the chunk (those past it empty);
  // rows past qv are zero-filled
#pragma unroll
  for (int t = 0; t < kTilesPerChunk; ++t) {
    if (t < ntq) {
      for (int idx = tid; idx < kTile * CPR; idx += kWG) {
        const int r = idx / CPR, ch = idx % CPR, j = t * kTile + r;
        const bool ok = j < qv;
        tc::cp_async_16(base + t * TB + tc::chunk_offset(r, ch),
                        Bb + (ok ? (size_t)j * bc_s : 0) + ch * 8, ok);
      }
      for (int idx = tid; idx < kTile * 8; idx += kWG) {
        const int r = idx >> 3, ch = idx & 7, j = t * kTile + r;
        const bool ok = j < qv;
        tc::cp_async_16(tc::smem_u32(xs + j * kXPitch + ch * 8),
                        xb + (ok ? (size_t)j * xrow : 0) + ch * 8, ok);
      }
    }
    tc::cp_async_commit();
  }

  // inclusive cumsum of a over the chunk, two positions a thread (rows past
  // qv add 0)
  const int i2 = 2 * tid;
  const float* ab = a + ((size_t)b * S + c0) * H + h;
  const float v0 = i2 < qv ? ab[(size_t)i2 * H] : 0.f;
  const float v1 = v0 + (i2 + 1 < qv ? ab[(size_t)(i2 + 1) * H] : 0.f);
  float v = v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  float excl = v - v1;
  for (int w = 0; w < warp; ++w) excl += wsum[w];
  acs[i2] = excl + v0;
  acs[i2 + 1] = excl + v1;
  __syncthreads();
  const float a_sum = acs[Q - 1];
  dec[i2] = expf(a_sum - acs[i2]);
  dec[i2 + 1] = expf(a_sum - acs[i2 + 1]);
  float* ao = acs_out + (((size_t)b * H + h) * nc + c) * Q;
  for (int i = tid; i < Q; i += kWG) ao[i] = acs[i];

  // s_c (p x n) = sum over the chunk's positions of (dec_j x_j)^T B_j: A is
  // the weighted x^T in registers (rows p, k = positions), split hi + lo
  const int t2 = (lane & 3) * 2;
  const int pA = warp * 16 + (lane >> 2), pB = pA + 8;
  float acc[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
#pragma unroll
  for (int t = 0; t < kTilesPerChunk; ++t) {
    if (t >= ntq) break;
    cp_async_wait_pending(kTilesPerChunk - 1 - t);
    tc::fence_async_shared();
    __syncthreads();   // every thread's copies of tile t, and dec
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // register r: row (r & 1 ? pB : pA), positions j, j + 1
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = r & 1 ? pB : pA;
        const int j = t * kTile + kk * 16 + t2 + (r & 2 ? 8 : 0);
        split_bf16(dec[j] * __bfloat162float(xs[j * kXPitch + p]),
                   dec[j + 1] * __bfloat162float(xs[(j + 1) * kXPitch + p]),
                   hi[kk][r], lo[kk][r]);
      }
    }
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = tc::desc_sw128(base + t * TB + kk * 16 * 128,
                                        tc::kBlockBytes, tc::kAtomBytes);
      tc::Mma<N, 1>::run(acc, hi[kk], d, 1);
      tc::Mma<N, 1>::run(acc, lo[kk], d, 1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(acc);
    tc::fence_regs(hi);
    tc::fence_regs(lo);
  }

  // accumulator element e: row (e & 2 ? pB : pA), column 8 (e / 4) + t2 +
  // (e & 1)
  float* so = states + (((size_t)b * H + h) * nc + c) * kP * N;
#pragma unroll
  for (int q = 0; q < N / 8; ++q) {
    const int col = 8 * q + t2;
    *reinterpret_cast<float2*>(so + (size_t)pA * N + col) =
        make_float2(acc[4 * q], acc[4 * q + 1]);
    *reinterpret_cast<float2*>(so + (size_t)pB * N + col) =
        make_float2(acc[4 * q + 2], acc[4 * q + 3]);
  }
}

// Pass 2: grid (kP * N / 256, H, b), one state element a thread, chunks in
// order. prev[c] (bf16) is the state entering chunk c >= 1.
__global__ void __launch_bounds__(kPassThreads) ssd_state_pass_kernel(
    const float* __restrict__ states, const float* __restrict__ acs,
    bf16* __restrict__ prev, float* __restrict__ final_state, int H, int Q,
    int nc, int PN) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= PN) return;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const float* st = states + bh * nc * PN + e;
  const float* as = acs + bh * nc * Q + Q - 1;   // each chunk's a_sum
  bf16* pv = prev + bh * nc * PN + e;
  float s = st[0];
  for (int c = 1; c < nc; ++c) {
    pv[(size_t)c * PN] = __float2bfloat16(s);
    s = fmaf(expf(as[(size_t)c * Q]), s, st[(size_t)c * PN]);
  }
  final_state[bh * PN + e] = s;
}

// Pass 3: grid (row tiles of a chunk, chunks, H * b), one warpgroup per 64
// rows of one chunk of one head.
template <int N>
__global__ void __launch_bounds__(kWG) ssd_chunk_scan_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, bf16* __restrict__ y,
    const float* __restrict__ acs_in, const bf16* __restrict__ prev, int S,
    int H, int Q, long long bc_b, long long bc_s, int hpg, long long bc_g) {
  constexpr int TB = tile_bytes<N>();
  constexpr int XB = tc::kBlockBytes;    // an x tile: 64 rows x kP
  constexpr int KS = N / 16;             // k-steps over the state dim
  constexpr int CPR = N / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // S_{c-1} tile
  float* acs = reinterpret_cast<float*>(smem_raw + (base - raw) + 3 * TB +
                                        2 * XB);

  const int it = gridDim.x - 1 - blockIdx.x;   // the longest tiles first
  const int c = blockIdx.y, nc = gridDim.y;
  const int h = blockIdx.z % H, b = blockIdx.z / H;
  const size_t c0 = (size_t)c * Q;
  const int qv = min(Q, S - (int)c0);
  const int i0 = it * kTile;
  if (i0 >= qv) return;   // the ragged last chunk's empty tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t2 = (lane & 3) * 2;
  // this thread's two accumulator rows, chunk-local
  const int iA = i0 + warp * 16 + (lane >> 2), iB = iA + 8;
  const size_t xrow = (size_t)H * kP;
  const bf16* xb = x + ((size_t)b * S + c0) * xrow + (size_t)h * kP;
  const size_t goff = (size_t)(h / hpg) * bc_g;   // the head's group
  const bf16* Bb = Bm + (size_t)b * bc_b + c0 * bc_s + goff;
  const bf16* Cb = Cm + (size_t)b * bc_b + c0 * bc_s + goff;
  const size_t bhc = ((size_t)b * H + h) * nc + c;

  // key tile jt's B rows and x rows into ring stage jt % 2
  auto load_tile = [&](int jt) {
    const uint32_t bdst = base + TB + (jt & 1) * (TB + XB), xdst = bdst + TB;
    for (int idx = tid; idx < kTile * CPR; idx += kWG) {
      const int r = idx / CPR, ch = idx % CPR, j = jt * kTile + r;
      const bool ok = j < qv;
      tc::cp_async_16(bdst + tc::chunk_offset(r, ch),
                      Bb + (ok ? (size_t)j * bc_s : 0) + ch * 8, ok);
    }
    for (int idx = tid; idx < kTile * 8; idx += kWG) {
      const int r = idx >> 3, ch = idx & 7, j = jt * kTile + r;
      const bool ok = j < qv;
      tc::cp_async_16(xdst + tc::chunk_offset(r, ch),
                      xb + (ok ? (size_t)j * xrow : 0) + ch * 8, ok);
    }
    tc::cp_async_commit();
  };
  if (c > 0) {   // the entering state (kP rows x N), in tile 0's group
    const bf16* sp = prev + bhc * kP * N;
    for (int idx = tid; idx < kP * CPR; idx += kWG) {
      const int r = idx / CPR, ch = idx % CPR;
      tc::cp_async_16(base + tc::chunk_offset(r, ch), sp + r * N + ch * 8,
                      true);
    }
  }
  load_tile(0);

  // cumsums of a up to the tile's last row (rows past Q repeat the last)
  const float* ag = acs_in + bhc * Q;
  for (int e = tid; e < i0 + kTile; e += kWG) acs[e] = ag[min(e, Q - 1)];

  // C rows iA, iB in the A-operand fragment layout (zeros past qv)
  uint32_t cf[KS][4];
  {
    const uint32_t* ca = iA < qv
        ? reinterpret_cast<const uint32_t*>(Cb + (size_t)iA * bc_s) : nullptr;
    const uint32_t* cb = iB < qv
        ? reinterpret_cast<const uint32_t*>(Cb + (size_t)iB * bc_s) : nullptr;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int w0 = (16 * kk + t2) >> 1, w1 = w0 + 4;
      cf[kk][0] = ca ? ca[w0] : 0u;
      cf[kk][1] = cb ? cb[w0] : 0u;
      cf[kk][2] = ca ? ca[w1] : 0u;
      cf[kk][3] = cb ? cb[w1] : 0u;
    }
  }

  float yacc[32];   // 64 rows x kP: element e is row (e & 2 ? iB : iA),
#pragma unroll      // column 8 (e / 4) + t2 + (e & 1)
  for (int e = 0; e < 32; ++e) yacc[e] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it) {
      load_tile(jt + 1);    // into the stage tile jt - 1 released
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_async_shared();
    __syncthreads();   // tile jt (and the state tile and acs) visible
    const float aA = acs[iA], aB = acs[iB];

    if (jt == 0 && c > 0) {
      // y = exp(acs_i) C_i S_{c-1}^T
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        tc::Mma<64, 0>::run(
            yacc, cf[kk],
            tc::desc_sw128(base + (kk >> 2) * tc::kBlockBytes + (kk & 3) * 32,
                           16, tc::kAtomBytes),
            kk > 0);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(yacc);
      const float eA = expf(aA), eB = expf(aB);
#pragma unroll
      for (int e = 0; e < 32; ++e) yacc[e] *= (e & 2) ? eB : eA;
    }

    // G = C_i B_j^T: 64 rows x 64 keys, fp32
    const uint32_t bt = base + TB + (jt & 1) * (TB + XB), xt = bt + TB;
    float g[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) g[e] = 0.f;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      tc::Mma<64, 0>::run(
          g, cf[kk],
          tc::desc_sw128(bt + (kk >> 2) * tc::kBlockBytes + (kk & 3) * 32, 16,
                         tc::kAtomBytes),
          kk > 0);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(g);

    // W = G exp(acs_i - acs_j), zero above the diagonal, as bf16 A
    // fragments (the accumulator and A layouts coincide pairwise)
    const bool diag = jt == it;
    uint32_t wf[4][4];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = jt * kTile + 8 * q + t2;
      const float a0 = acs[j], a1 = acs[j + 1];
      float w0 = g[4 * q] * expf(aA - a0);
      float w1 = g[4 * q + 1] * expf(aA - a1);
      float w2 = g[4 * q + 2] * expf(aB - a0);
      float w3 = g[4 * q + 3] * expf(aB - a1);
      if (diag) {
        w0 = iA >= j ? w0 : 0.f;
        w1 = iA >= j + 1 ? w1 : 0.f;
        w2 = iB >= j ? w2 : 0.f;
        w3 = iB >= j + 1 ? w3 : 0.f;
      }
      wf[q >> 1][(q & 1) * 2] = tc::pack_bf16(w0, w1);
      wf[q >> 1][(q & 1) * 2 + 1] = tc::pack_bf16(w2, w3);
    }

    // y += W x_j: 4 k-steps of 16 keys, x read MN-major
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      tc::Mma<64, 1>::run(yacc, wf[kk],
                          tc::desc_sw128(xt + kk * 16 * 128, tc::kBlockBytes,
                                         tc::kAtomBytes),
                          1);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(yacc);
    tc::fence_regs(wf);
    __syncthreads();   // every warp is done with this stage
  }

  if (iA < qv) {
    uint32_t* op = reinterpret_cast<uint32_t*>(
        y + ((size_t)b * S + c0 + iA) * xrow + (size_t)h * kP);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      op[(8 * q + t2) >> 1] = tc::pack_bf16(yacc[4 * q], yacc[4 * q + 1]);
  }
  if (iB < qv) {
    uint32_t* op = reinterpret_cast<uint32_t*>(
        y + ((size_t)b * S + c0 + iB) * xrow + (size_t)h * kP);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      op[(8 * q + t2) >> 1] =
          tc::pack_bf16(yacc[4 * q + 2], yacc[4 * q + 3]);
  }
}

template <int N>
int launch_tc(const void* x, const float* a, const void* B, const void* C,
              void* y, float* fs, void* workspace, int b, int S, int H, int Q,
              long long bc_b, long long bc_s, int hpg, long long bc_g,
              cudaStream_t stream) {
  static bool attr_set = false;   // per instantiation, first launch only
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_state_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)state_smem_bytes<N>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_chunk_scan_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)scan_smem_bytes<N>());
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const Geometry g = geometry<N>(b, S, H, Q);
  const Workspace w = workspace_layout(b, S, H, N, Q);
  uint8_t* ws = static_cast<uint8_t*>(workspace);
  float* states = reinterpret_cast<float*>(ws + w.states);
  bf16* prev = reinterpret_cast<bf16*>(ws + w.prev);
  float* acs = reinterpret_cast<float*>(ws + w.acs);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* Bp = static_cast<const bf16*>(B);
  ssd_chunk_state_kernel<N><<<g.grid[0], g.threads[0], g.smem[0], stream>>>(
      xp, a, Bp, states, acs, S, H, Q, bc_b, bc_s, hpg, bc_g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_state_pass_kernel<<<g.grid[1], g.threads[1], 0, stream>>>(
      states, acs, prev, fs, H, Q, (int)g.grid[0].x, kP * N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_scan_kernel<N><<<g.grid[2], g.threads[2], g.smem[2], stream>>>(
      xp, Bp, static_cast<const bf16*>(C), static_cast<bf16*>(y), acs, prev, S,
      H, Q, bc_b, bc_s, hpg, bc_g);
  return (int)cudaGetLastError();
}

bool valid(int b, int S, int H, int P, int N, int Q, int dtype) {
  return b > 0 && S > 0 && H > 0 && Q > 0 && Q <= kMaxQ && P == 64 &&
         (N == 64 || N == 128) && (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y). x, y: (b, S, H, P)
// contiguous; a: (b, S, H) float32 contiguous; B, C: (b, S, G, N) with
// element strides (bc_b, bc_s, bc_g, 1), H a multiple of G, head h reading
// group h / (H / G); final_state: (b, H, P, N) float32. Q <= 256, P = 64,
// N = 64 or 128. bf16 needs 16-byte aligned x, B and C rows and a workspace
// of ssd_workspace_bytes(); float32 takes none (may be null).
extern "C" int ssd_fwd(const void* x, const float* a, const void* B,
                       const void* C, void* y, float* final_state,
                       void* workspace, int b, int S, int H, int P, int N,
                       int Q, int bc_b, int bc_s, int G, int bc_g, int dtype,
                       void* stream) {
  if (!valid(b, S, H, P, N, Q, dtype) || bc_b < 0 || bc_s < 0 || G <= 0 ||
      H % G || bc_g < 0 || (dtype == 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hpg = H / G;
  if (dtype == 0)
    return N == 64 ? launch_fma<64, 64>(x, a, B, C, y, final_state, b, S, H,
                                        Q, bc_b, bc_s, hpg, bc_g, s)
                   : launch_fma<64, 128>(x, a, B, C, y, final_state, b, S, H,
                                         Q, bc_b, bc_s, hpg, bc_g, s);
  return N == 64 ? launch_tc<64>(x, a, B, C, y, final_state, workspace, b, S,
                                 H, Q, bc_b, bc_s, hpg, bc_g, s)
                 : launch_tc<128>(x, a, B, C, y, final_state, workspace, b, S,
                                  H, Q, bc_b, bc_s, hpg, bc_g, s);
}

// bytes of workspace ssd_fwd needs for these sizes (0 for float32), or -1
// if it does not take them
extern "C" long long ssd_workspace_bytes(int b, int S, int H, int P, int N,
                                         int Q, int dtype) {
  if (!valid(b, S, H, P, N, Q, dtype)) return -1;
  return dtype == 0 ? 0 : (long long)workspace_layout(b, S, H, N, Q).total;
}

// launch geometry of the bf16 route, for reports: out[5 * pass + k] holds
// the grid's x, y, z, the threads and the dynamic shared memory bytes of
// pass 0 (chunk_state), 1 (state_pass) and 2 (chunk_scan)
extern "C" int ssd_geometry(int b, int S, int H, int P, int N, int Q,
                            int* out) {
  if (!valid(b, S, H, P, N, Q, 1)) return (int)cudaErrorInvalidValue;
  const Geometry g = N == 64 ? geometry<64>(b, S, H, Q)
                             : geometry<128>(b, S, H, Q);
  for (int i = 0; i < 3; ++i) {
    out[5 * i] = (int)g.grid[i].x;
    out[5 * i + 1] = (int)g.grid[i].y;
    out[5 * i + 2] = (int)g.grid[i].z;
    out[5 * i + 3] = g.threads[i];
    out[5 * i + 4] = (int)g.smem[i];
  }
  return 0;
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
