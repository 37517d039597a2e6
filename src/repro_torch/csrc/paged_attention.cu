// Paged decode attention for Hopper (sm_90a), with and without an
// in-flight tail: a split-K ("flash-decoding") kernel.
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
// softmax: scores in fp32 with q pre-scaled by 1/sqrt(D), output
// acc / max(l, 1e-30) (an empty context with an empty tail gives zeros),
// stored in the input dtype. The tail is simply positions
// ctx .. ctx + tl - 1 of the sequence.
//
// What bounds it on the H100: device-memory bytes. Each (b, kh) reads
// (ctx + tail) * D * 2 operands once and does 4 * G * D flops per position:
// about G (= 3 on llama3.2-3b) flops per byte in bf16, two orders of
// magnitude under the card's ~295 flop/byte ridge. The least time is the
// K/V bytes over 3.35 TB/s, so the design is about bytes in flight across
// the whole card. On the card the kernel takes about 1.2 times as long
// as one PyTorch sum() over the same bytes, timed the same way (PERF.md,
// scripts/decode_attention_probe.py); a version with the products on the
// tensor cores (mma.sync) saved little and was not kept.
//
// Design.
// - Grid (KH * NG, B, splits): the positions [0, pps * page + kt_cap) that
//   the host knows bound a sequence are cut into splits of `split`
//   positions (a multiple of the 64-position tile, chosen by the wrapper),
//   and NG groups of up to GC query heads share a block. The lengths live
//   on the device and the host never reads them, so the grid cannot
//   follow them: a block whose split starts at or past ctx + tl exits at
//   once, having read two ints. Long sequences spread over many blocks.
//   The split index varies slowest, so the blocks of the first splits,
//   which every sequence has, are dispatched first.
// - Each block copies its split's K and V as 64-position tiles (one kv
//   head: rows of D elements, stride KH * D) with 16-byte cp.async into a
//   ring of STAGES stages in dynamic shared memory, the next tiles in
//   flight while the current one is used. A row's page comes from the
//   split's slice of the block table, staged in shared memory once. Rows
//   past the sequence are zero-filled. The 16-byte chunks of a row are
//   XOR-swizzled by the row (chunk c at c ^ (row & 7)), so both read
//   patterns below are free of bank conflicts.
// - Scores on the CUDA cores from shared memory: warp w owns quarter w of
//   D, a lane two positions, for all GC heads (q, scaled, broadcast from
//   shared memory and used for both positions); the quarters meet in
//   shared memory, and one warp per head does the tile's online-softmax
//   step with one max and one sum reduction per tile, not per position.
//   For PV a thread owns a 16-byte column chunk and every PG-th position
//   of the tile; the PG partial accumulators are summed through shared
//   memory once per split.
// - Combine, in the same launch. A sequence with one non-empty split
//   writes its output directly. Otherwise every non-empty split writes
//   its (m, l, acc[D]) per head in fp32 to the workspace, fences, and
//   counts itself on the (b, kh, group)'s counter; the block that counts
//   last combines the splits in split order, weighting each by
//   exp(m_s - M) (a split with l = 0 adds nothing), and resets the
//   counter to 0. Splits past the sequence never take part. Counters
//   are zeroed once, when the wrapper makes them.
//
// Workspace (made and cached by the wrapper, per device and stream):
// B * H * splits * (D + 2) floats of partial states and B * H ints of
// counters, H = KH * G; at the llama3.2-3b serving shape (B = 8, H = 24,
// D = 128, 4096 + 8 positions in splits of 256) that is 1.7 MB. Beyond
// it the kernel launches on the caller's stream, allocates nothing and
// does not synchronise. Each entry returns cudaGetLastError() after the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kTile = 64;           // positions per ring stage
constexpr int kMaxSplit = 1024;     // positions per split, at most
constexpr int kMaxSplits = 512;     // splits per sequence, at most
constexpr int kRingBudget = 96 * 1024;
// scores: four warps, a quarter of D each; a lane takes two positions
static_assert(kThreads == 128 && kTile == 64, "score layout");

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
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16-byte global -> shared copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// compile-time geometry of one (dtype, head dim)
template <typename T, int D>
struct Geo {
  static constexpr int VN = Vec16<T>::N;        // elements per 16-byte chunk
  static constexpr int CPR = D / VN;            // chunks per row
  static constexpr int PG = kThreads / CPR;     // position groups of PV
  static constexpr int TILE_BYTES = kTile * D * (int)sizeof(T);
  static constexpr int STAGES =
      kRingBudget / (2 * TILE_BYTES) < 2 ? 2
      : kRingBudget / (2 * TILE_BYTES) > 4 ? 4
      : kRingBudget / (2 * TILE_BYTES);
  static constexpr int RING_BYTES = STAGES * 2 * TILE_BYTES;
  static_assert(CPR % 8 == 0 && kThreads % CPR == 0, "head dim / dtype");
};

template <typename T, int D, int GC>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,            // (B, KH*G, D)
    const T* __restrict__ k_pages,      // (NP, page, KH, D)
    const T* __restrict__ v_pages,
    const int* __restrict__ tables,     // (B, pps)
    const int* __restrict__ ctx_lens,   // (B,)
    const T* __restrict__ k_tail,       // (B, kt_cap, KH, D) or null
    const T* __restrict__ v_tail,
    const int* __restrict__ tail_lens,  // (B,) or null
    T* __restrict__ out,                // (B, KH*G, D)
    float* __restrict__ ws,             // B*H*nsplit*(D+2) floats
    int* __restrict__ counters,         // B*H ints, zero between calls
    int KH, int G, int page_size, int page_shift, int pps, int kt_cap,
    int split, int nsplit, float scale) {
  using Gm = Geo<T, D>;
  constexpr int VN = Gm::VN, CPR = Gm::CPR, PG = Gm::PG;
  constexpr int STAGES = Gm::STAGES;
  using Raw = typename Vec16<T>::Raw;
  static_assert(PG * GC * D * 4 <= Gm::RING_BYTES, "PV reduction space");
  static_assert((3 * kMaxSplits + 1) * GC * 4 <= Gm::RING_BYTES,
                "combine space");

  const int sp = blockIdx.z, b = blockIdx.y;
  const int NG = (G + GC - 1) / GC;
  const int kh = blockIdx.x / NG, grp = blockIdx.x % NG;
  const int g0 = grp * GC, ng = min(GC, G - g0);
  const int ctx = min(ctx_lens[b], pps * page_size);
  const int tl = tail_lens != nullptr ? min(tail_lens[b], kt_cap) : 0;
  const int total = ctx + tl;
  const int nvalid = max(1, (total + split - 1) / split);
  if (sp >= nvalid) return;     // past the sequence: nothing to do

  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(16) float q_s[GC][D];
  __shared__ float s_part[4][GC][kTile];
  __shared__ __align__(16) float p_s[kTile][GC];
  __shared__ float m_s[GC], l_s[GC], corr_s[GC];
  __shared__ int pages_s[kMaxSplit / 16 + 2];
  __shared__ int last_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = KH * G;
  const int start = sp * split;
  const int end = min(start + split, total);
  const int ntiles = (end - start + kTile - 1) / kTile;
  const int* tab = tables + (size_t)b * pps;

  // the split's slice of the block table, and q scaled (zeros past ng)
  const int first_page = start / page_size;
  const int n_pages = end > start && start < ctx
                          ? (min(end, ctx) - 1) / page_size - first_page + 1
                          : 0;
  for (int i = tid; i < n_pages; i += kThreads)
    pages_s[i] = tab[first_page + i];
  for (int i = tid; i < GC * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_s[g][d] = g < ng ? to_float(q[((size_t)b * H + (size_t)kh * G + g0 + g)
                                     * D + d]) * scale
                       : 0.f;
  }
  if (tid < GC) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  auto load_tile = [&](int stage, int pos0) {
    uint8_t* kst = ring + stage * 2 * Gm::TILE_BYTES;
    uint8_t* vst = kst + Gm::TILE_BYTES;
#pragma unroll 4
    for (int i = tid; i < kTile * CPR; i += kThreads) {
      const int r = i / CPR, c = i % CPR;
      const int p = pos0 + r;
      const bool ok = p < end;
      const T *kb = k_pages, *vb = v_pages;
      size_t row = 0;
      if (ok && p < ctx) {
        // shifts for a power-of-two page, else a division
        const int pi = page_shift >= 0 ? p >> page_shift : p / page_size;
        const int off = page_shift >= 0 ? p & (page_size - 1)
                                        : p - pi * page_size;
        row = ((size_t)pages_s[pi - first_page] * page_size + off) * KH + kh;
      } else if (ok) {
        row = ((size_t)b * kt_cap + (p - ctx)) * KH + kh;
        kb = k_tail;
        vb = v_tail;
      }
      const uint32_t so = (uint32_t)(r * CPR + (c ^ (r & 7))) * 16;
      cp_async_16(smem_u32(kst) + so, kb + row * D + c * VN, ok);
      cp_async_16(smem_u32(vst) + so, vb + row * D + c * VN, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_tile(s, start + s * kTile);
    cp_async_commit();
  }

  // PV ownership: 16-byte column chunk pc, positions pg, pg + PG, ...
  const int pc = tid % CPR, pg = tid / CPR;
  float acc[GC][VN];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[g][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int nt = t + STAGES - 1;
    if (nt < ntiles) load_tile(nt % STAGES, start + nt * kTile);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const uint8_t* kst = ring + (t % STAGES) * 2 * Gm::TILE_BYTES;
    const uint8_t* vst = kst + Gm::TILE_BYTES;
    const int pos0 = start + t * kTile;

    // scores: warp w sums quarter w of D for positions lane and lane + 32,
    // all GC heads, each q chunk read once for both positions
    {
      constexpr int QC = CPR / 4;      // chunks per quarter
      float s0[GC], s1[GC];
#pragma unroll
      for (int g = 0; g < GC; ++g) s0[g] = s1[g] = 0.f;
#pragma unroll
      for (int j = 0; j < QC; ++j) {
        const int c = warp * QC + j;
        const int cs = c ^ (lane & 7);   // rows lane and lane + 32 alike
        float k0[VN], k1[VN];
        unpack(*reinterpret_cast<const Raw*>(kst + (lane * CPR + cs) * 16),
               k0);
        unpack(*reinterpret_cast<const Raw*>(
                   kst + ((lane + 32) * CPR + cs) * 16), k1);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float4* qv = reinterpret_cast<const float4*>(&q_s[g][c * VN]);
#pragma unroll
          for (int e4 = 0; e4 < VN / 4; ++e4) {
            const float4 qq = qv[e4];
            s0[g] = fmaf(qq.x, k0[4 * e4], s0[g]);
            s0[g] = fmaf(qq.y, k0[4 * e4 + 1], s0[g]);
            s0[g] = fmaf(qq.z, k0[4 * e4 + 2], s0[g]);
            s0[g] = fmaf(qq.w, k0[4 * e4 + 3], s0[g]);
            s1[g] = fmaf(qq.x, k1[4 * e4], s1[g]);
            s1[g] = fmaf(qq.y, k1[4 * e4 + 1], s1[g]);
            s1[g] = fmaf(qq.z, k1[4 * e4 + 2], s1[g]);
            s1[g] = fmaf(qq.w, k1[4 * e4 + 3], s1[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        s_part[warp][g][lane] = s0[g];
        s_part[warp][g][lane + 32] = s1[g];
      }
    }
    __syncthreads();

    // one online-softmax step per head and tile: a warp per head
    for (int g = warp; g < GC; g += kThreads / 32) {
      const bool ok0 = pos0 + lane < end, ok1 = pos0 + lane + 32 < end;
      const float x0 = s_part[0][g][lane] + s_part[1][g][lane] +
                       s_part[2][g][lane] + s_part[3][g][lane];
      const float x1 = s_part[0][g][lane + 32] + s_part[1][g][lane + 32] +
                       s_part[2][g][lane + 32] + s_part[3][g][lane + 32];
      const float mx = warp_max(fmaxf(ok0 ? x0 : kNegInf,
                                      ok1 ? x1 : kNegInf));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = ok0 ? expf(x0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(x1 - m_new) : 0.f;
      p_s[lane][g] = p0;
      p_s[lane + 32][g] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // PV: rescale once per tile, then every PG-th position of the tile
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float corr = corr_s[g];
#pragma unroll
      for (int e = 0; e < VN; ++e) acc[g][e] *= corr;
    }
#pragma unroll 4
    for (int p = pg; p < kTile; p += PG) {
      float vf[VN];
      unpack(*reinterpret_cast<const Raw*>(
                 vst + (p * CPR + (pc ^ (p & 7))) * 16), vf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float pr = p_s[p][g];
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
      }
    }
    __syncthreads();     // the stage and p_s are rewritten next
  }
  cp_async_wait<0>();
  __syncthreads();

  // sum the PG partial accumulators through the (now idle) ring
  float* red = reinterpret_cast<float*>(ring);   // [PG][GC][D]
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < VN; ++e)
      red[(pg * GC + g) * D + pc * VN + e] = acc[g][e];
  __syncthreads();

  const size_t head0 = (size_t)b * H + (size_t)kh * G + g0;
  float* ws_acc = ws;                                  // [B*H][nsplit][D]
  float* ws_ml = ws + (size_t)gridDim.y * H * nsplit * D;  // [B*H][nsplit][2]
  for (int i = tid; i < ng * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < PG; ++k) a += red[(k * GC + g) * D + d];
    if (nvalid == 1)
      store(out + (head0 + g) * D + d, a / fmaxf(l_s[g], 1e-30f));
    else
      ws_acc[((head0 + g) * nsplit + sp) * D + d] = a;
  }
  if (nvalid == 1) return;
  if (tid < ng) {
    float* ml = ws_ml + ((head0 + tid) * nsplit + sp) * 2;
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  int* counter = counters + ((size_t)b * KH + kh) * NG + grp;
  if (tid == 0) last_s = atomicAdd(counter, 1) == nvalid - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (tid == 0) *counter = 0;

  // the last split of (b, kh, group) combines all of them, in split order;
  // the (m, l) pairs are loaded by all threads at once, not split by split
  float* ml_s = reinterpret_cast<float*>(ring);   // [nvalid][GC][2]
  float* wgt = ml_s + 2 * nvalid * GC;            // [nvalid][GC]
  float* L = wgt + nvalid * GC;                   // [GC]
  for (int i = tid; i < nvalid * ng; i += kThreads) {
    const int s = i / ng, g = i % ng;
    const float2 v = __ldcg(reinterpret_cast<const float2*>(
        ws_ml + ((head0 + g) * nsplit + s) * 2));
    ml_s[(s * GC + g) * 2] = v.x;
    ml_s[(s * GC + g) * 2 + 1] = v.y;
  }
  __syncthreads();
  if (tid < ng) {
    float M = kNegInf;
    for (int s = 0; s < nvalid; ++s) M = fmaxf(M, ml_s[(s * GC + tid) * 2]);
    float l = 0.f;
    for (int s = 0; s < nvalid; ++s) {
      const float ls = ml_s[(s * GC + tid) * 2 + 1];
      const float w = ls > 0.f ? expf(ml_s[(s * GC + tid) * 2] - M) : 0.f;
      wgt[s * GC + tid] = w;
      l += ls * w;
    }
    L[tid] = l;
  }
  __syncthreads();
  for (int i = tid; i < ng * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const float* a = ws_acc + (head0 + g) * nsplit * D + d;
    float A = 0.f;
#pragma unroll 4
    for (int s = 0; s < nvalid; ++s)
      A = fmaf(wgt[s * GC + g], __ldcg(a + (size_t)s * D), A);
    store(out + (head0 + g) * D + d, A / fmaxf(L[g], 1e-30f));
  }
}

struct Args {
  const void *q, *kp, *vp;
  const int *tables, *ctx_lens;
  const void *kt, *vt;
  const int* tail_lens;
  void* out;
  float* ws;
  int* counters;
  int B, KH, G, page_size, pps, kt_cap, split;
  cudaStream_t stream;
};

template <typename T, int D, int GC>
int launch(const Args& a) {
  using Gm = Geo<T, D>;
  static bool smem_set = false;
  auto* kernel = paged_decode_kernel<T, D, GC>;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::RING_BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int nsplit = (a.pps * a.page_size + a.kt_cap + a.split - 1) / a.split;
  if (nsplit > kMaxSplits) return (int)cudaErrorInvalidValue;
  // split slowest: blocks are dispatched in index order, so those of the
  // first splits, which every sequence has, go first and the empty blocks
  // of the last splits trail
  dim3 grid(a.KH * ((a.G + GC - 1) / GC), a.B, nsplit);
  int page_shift = 0;
  while ((1 << page_shift) < a.page_size) ++page_shift;
  if ((1 << page_shift) != a.page_size) page_shift = -1;
  kernel<<<grid, kThreads, Gm::RING_BYTES, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), a.tables, a.ctx_lens,
      static_cast<const T*>(a.kt), static_cast<const T*>(a.vt), a.tail_lens,
      static_cast<T*>(a.out), a.ws, a.counters, a.KH, a.G, a.page_size,
      page_shift, a.pps, a.kt_cap, a.split, nsplit, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// query heads per block: 1 for MHA, 4 up to G = 4 (llama's 3), else 8
int group_size(int G) { return G == 1 ? 1 : G <= 4 ? 4 : 8; }

template <typename T, int D>
int by_group(const Args& a) {
  switch (group_size(a.G)) {
    case 1: return launch<T, D, 1>(a);
    case 4: return launch<T, D, 4>(a);
    default: return launch<T, D, 8>(a);
  }
}

template <typename T>
int by_dim(int D, const Args& a) {
  if (D == 128) return by_group<T, 128>(a);
  if (D == 64) return by_group<T, 64>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D>
int ring_bytes(int* stages) {
  *stages = Geo<T, D>::STAGES;
  return Geo<T, D>::RING_BYTES;
}

int entry(const Args& a, int D, int dtype) {
  if (a.B <= 0 || a.KH <= 0 || a.G <= 0 || a.pps <= 0 || a.page_size <= 0 ||
      a.page_size % 16 || a.split <= 0 || a.split % kTile ||
      a.split > kMaxSplit || a.ws == nullptr || a.counters == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return by_dim<float>(D, a);
  if (dtype == 1) return by_dim<__nv_bfloat16>(D, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out: (B, KH*G, D); pages:
// (NP, page_size, KH, D); tables: (B, pps) int32; lens: (B,) int32;
// tails: (B, kt_cap, KH, D). All contiguous. workspace: B*KH*G*splits*(D+2)
// float32 with splits = ceil((pps*page_size + kt_cap) / split); counters:
// B*KH*G int32, zero before the first call (every call leaves them zero).
// split: positions per split, a multiple of 64, at most 1024.
extern "C" int paged_decode_tail_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const int* tables, const int* ctx_lens, const void* k_tail,
    const void* v_tail, const int* tail_lens, void* out, void* workspace,
    void* counters, int B, int KH, int G, int D, int page_size, int pps,
    int kt_cap, int split, int dtype, void* stream) {
  if (k_tail == nullptr || v_tail == nullptr || tail_lens == nullptr ||
      kt_cap <= 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k_pages, v_pages, tables, ctx_lens, k_tail, v_tail, tail_lens,
         out, static_cast<float*>(workspace), static_cast<int*>(counters),
         B, KH, G, page_size, pps, kt_cap, split,
         static_cast<cudaStream_t>(stream)};
  return entry(a, D, dtype);
}

extern "C" int paged_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const int* tables, const int* ctx_lens, void* out, void* workspace,
    void* counters, int B, int KH, int G, int D, int page_size, int pps,
    int split, int dtype, void* stream) {
  Args a{q, k_pages, v_pages, tables, ctx_lens, nullptr, nullptr, nullptr,
         out, static_cast<float*>(workspace), static_cast<int*>(counters),
         B, KH, G, page_size, pps, 0, split,
         static_cast<cudaStream_t>(stream)};
  return entry(a, D, dtype);
}

// launch geometry, for reports: query heads per block for G, and the ring's
// stages and dynamic shared memory bytes for (D, dtype); 0 if unsupported
extern "C" int paged_attention_geometry(int G, int D, int dtype,
                                        int* heads_per_block, int* stages) {
  *heads_per_block = group_size(G);
  if (dtype == 0 && D == 128) return ring_bytes<float, 128>(stages);
  if (dtype == 0 && D == 64) return ring_bytes<float, 64>(stages);
  if (dtype == 1 && D == 128) return ring_bytes<__nv_bfloat16, 128>(stages);
  if (dtype == 1 && D == 64) return ring_bytes<__nv_bfloat16, 64>(stages);
  return 0;
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
