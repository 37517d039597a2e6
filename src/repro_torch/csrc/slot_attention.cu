// Decode attention over the slot cache for Hopper (sm_90a): a split-K
// ("flash-decoding") kernel.
//
// Replaces no Pallas kernel. The JAX package's slot decode attention,
// src/repro/models/layers.py decode_attention_appended, is jnp that XLA
// fuses on the TPU; its plain PyTorch port (the same function in
// src/repro_torch/models/layers.py, which the wrapper runs for CPU tensors)
// converted every slot's whole (Smax, D) cache to float32 and ran two
// float32 GEMVs over the copies, once for each layer or tied-block
// application of a decode step. This kernel reads each live row once, in
// its own dtype.
//
// What it computes. For each (slot b, kv head kh) the G query heads of the
// group attend the cache rows [lo, ctx) of the contiguous kv-heads-major
// slot cache (B, KH, Smax, D), then the new token's (B, KH, D) k_new /
// v_new row, under ONE softmax: ctx = min(prev_len[b], Smax); lo = 0, or
// with a window the first position the plain path's
// prev_len - pos < window keeps (at most ctx). Scores in fp32 with q
// pre-scaled (the given scale, else 1/sqrt(D)), probabilities kept in
// fp32, output acc / l stored in q's dtype. A slot whose length has grown
// past Smax (a free slot is stepped too) attends its whole cache, as the
// plain path does.
//
// What bounds it on the H100: device-memory bytes. Each (b, kh) reads
// (ctx - lo + 1) * D * 2 operands once and does 4 * G * D flops per
// position: G flops a byte in bf16 (1 on Zamba2-7B), far under the card's
// ~295 flop/byte ridge. The least time is the live K/V bytes over
// 3.35 TB/s, so the design keeps bytes in flight across the card.
//
// Design. A file of its own: it shares no code with paged_attention.cu,
// whose rows come through a page table at head dims 64 and 128 and whose
// swizzle needs 8 | chunks per row, which heads of 80 and 224 break.
// - Grid (KH * NG, B, splits): the positions [lo, ctx] that a slot can
//   have, at most Smax + 1, are cut into splits of `split` positions (a
//   multiple of the tile, chosen by the wrapper); NG groups of up to GC
//   query heads share a block. The lengths live on the device and the host
//   never reads them, so a CUDA graph can replay the launch: a block whose
//   split starts at or past the slot's positions exits after reading one
//   int. The split index varies slowest, so the first splits, which every
//   slot has, are dispatched first.
// - A (b, kh)'s rows are contiguous, so a tile of TILE positions is one
//   run of TILE * D elements, copied with 16-byte cp.async by consecutive
//   threads into a ring of STAGES stages in dynamic shared memory, the
//   next tiles in flight while the current one is used. The row past the
//   cache is the new token's, read from k_new / v_new; rows past the split
//   are zero-filled. A row takes CPR + 1 chunks in shared memory: CPR is
//   even at every head dim and dtype taken, so the stride is odd, and both
//   read patterns below hit eight distinct 16-byte bank groups in each
//   quarter warp.
// - Tile and stages (Geo): TILE = 64 where two stages of 64 rows of K and
//   V fit the 96 KB ring budget, else 32; STAGES as many as the budget
//   holds, 2 to 4. At D = 224 in bf16 a 64-position K+V stage is 59 KB
//   (57 KB unpadded), so the tile is 32 positions (29.7 KB a stage) and
//   the ring 3 stages (89 KB): two blocks fit on an SM, each with two tiles
//   in flight, about 119 KB of loads in flight per SM.
// - Scores on the CUDA cores from shared memory: warp w sums chunks w,
//   w + 4, ... of D for positions lane (+ 32), for all GC heads (q, scaled,
//   broadcast from shared memory); the warps' partial sums meet in shared
//   memory, and one warp per head does the tile's online-softmax step. For
//   PV a thread owns a 16-byte column chunk and every PG-th position of
//   the tile (PG * CPR <= 128 threads take part); the PG partial
//   accumulators are summed through shared memory once per split.
// - Combine, in the same launch. A slot with one non-empty split writes
//   its output directly. Otherwise every non-empty split writes its
//   (m, l, acc[D]) per head in fp32 to the workspace, fences, and counts
//   itself on the (b, kh, group)'s counter; the block that counts last
//   combines the splits in split order, weighting each by exp(m_s - M),
//   and resets the counter to 0, so every call leaves the counters zero
//   and the result does not depend on which block came last.
//
// Workspace (made and cached by the wrapper, per device and stream, shared
// with the paged decode kernels on that stream): B * H * splits * (D + 2)
// floats of partial states and B * H ints of counters, H = KH * G; at
// Zamba2-7B's serving shape (B = 32, H = 32, D = 224, 2049 positions in
// splits of 256) 7.4 MB. Beyond it the kernel launches on the caller's
// stream, allocates nothing and does not synchronise. The entry returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 1024;     // positions per split, at most
constexpr int kMaxSplits = 256;     // splits per slot, at most
constexpr int kRingBudget = 96 * 1024;

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

constexpr int clamp_stages(int n) { return n < 2 ? 2 : n > 4 ? 4 : n; }

// compile-time geometry of one (dtype, head dim)
template <typename T, int D>
struct Geo {
  static constexpr int VN = Vec16<T>::N;        // elements per 16-byte chunk
  static constexpr int CPR = D / VN;            // chunks per row
  static constexpr int ROW_BYTES = (CPR + 1) * 16;   // padded: odd stride
  static constexpr int TILE = 4 * 64 * ROW_BYTES <= kRingBudget ? 64 : 32;
  static constexpr int PPL = TILE / 32;         // score positions per lane
  static constexpr int TILE_BYTES = TILE * ROW_BYTES;   // K or V
  static constexpr int STAGES = clamp_stages(kRingBudget / (2 * TILE_BYTES));
  static constexpr int RING_BYTES = STAGES * 2 * TILE_BYTES;
  static constexpr int PG = kThreads / CPR;     // position groups of PV
  static_assert(D % VN == 0 && CPR % 2 == 0 && CPR <= kThreads,
                "head dim / dtype");
  static_assert(kMaxSplit % TILE == 0, "split / tile");
};

template <typename T, int D, int GC>
__global__ void __launch_bounds__(kThreads) slot_decode_kernel(
    const T* __restrict__ q,          // (B, KH*G, D)
    const T* __restrict__ k_cache,    // (B, KH, smax, D)
    const T* __restrict__ v_cache,
    const T* __restrict__ k_new,      // (B, KH, D)
    const T* __restrict__ v_new,
    const int* __restrict__ prev_len, // (B,)
    T* __restrict__ out,              // (B, KH*G, D)
    float* __restrict__ ws,           // B*H*nsplit*(D+2) floats
    int* __restrict__ counters,       // B*H ints, zero between calls
    int KH, int G, int smax, int window, int split, int nsplit,
    float scale) {
  using Gm = Geo<T, D>;
  constexpr int VN = Gm::VN, CPR = Gm::CPR, TILE = Gm::TILE, PPL = Gm::PPL;
  constexpr int PG = Gm::PG, STAGES = Gm::STAGES;
  constexpr int RC = Gm::ROW_BYTES / 16;        // row stride in chunks
  using Raw = typename Vec16<T>::Raw;
  static_assert(PG * GC * D * 4 <= Gm::RING_BYTES, "PV reduction space");
  static_assert((3 * kMaxSplits + 1) * GC * 4 <= Gm::RING_BYTES,
                "combine space");

  const int sp = blockIdx.z, b = blockIdx.y;
  const int NG = (G + GC - 1) / GC;
  const int kh = blockIdx.x / NG, grp = blockIdx.x % NG;
  const int g0 = grp * GC, ng = min(GC, G - g0);
  const int len = max(prev_len[b], 0);
  const int ctx = min(len, smax);
  const int lo = window > 0 ? min(max(len - window + 1, 0), ctx) : 0;
  // positions of this slot: cache rows lo .. ctx - 1, then the new token
  const int total = ctx - lo + 1;
  const int nvalid = (total + split - 1) / split;
  if (sp >= nvalid) return;     // past the slot: nothing to do

  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(16) float q_s[GC][D];
  __shared__ float s_part[kWarps][GC][TILE];
  __shared__ float p_s[TILE][GC];
  __shared__ float m_s[GC], l_s[GC], corr_s[GC];
  __shared__ int last_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = KH * G;
  const int start = sp * split;               // in positions of the slot
  const int end = min(start + split, total);
  const int ntiles = (end - start + TILE - 1) / TILE;
  const size_t head = (size_t)b * KH + kh;
  const size_t row0 = head * smax + lo;       // the slot's first row read

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

  // positions i0 .. i0 + TILE - 1 into stage `stage`: chunk j of the tile
  // is row j / CPR, chunk j % CPR of the contiguous run
  auto load_tile = [&](int stage, int i0) {
    uint8_t* kst = ring + stage * 2 * Gm::TILE_BYTES;
    uint8_t* vst = kst + Gm::TILE_BYTES;
#pragma unroll 4
    for (int j = tid; j < TILE * CPR; j += kThreads) {
      const int r = j / CPR, c = j - r * CPR;
      const int i = i0 + r;
      const bool ok = i < end;
      const T *kb = k_cache, *vb = v_cache;
      size_t off = 0;
      if (ok && i == total - 1) {   // the new token
        kb = k_new;
        vb = v_new;
        off = head * D + c * VN;
      } else if (ok) {
        off = (row0 + i) * D + c * VN;
      }
      const uint32_t so = (uint32_t)(r * RC + c) * 16;
      cp_async_16(smem_u32(kst) + so, kb + off, ok);
      cp_async_16(smem_u32(vst) + so, vb + off, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_tile(s, start + s * TILE);
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
    if (nt < ntiles) load_tile(nt % STAGES, start + nt * TILE);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const uint8_t* kst = ring + (t % STAGES) * 2 * Gm::TILE_BYTES;
    const uint8_t* vst = kst + Gm::TILE_BYTES;
    const int i0 = start + t * TILE;

    // scores: warp w sums chunks w, w + kWarps, ... for positions
    // lane + 32 j, all GC heads
    {
      float s[PPL][GC];
#pragma unroll
      for (int j = 0; j < PPL; ++j)
#pragma unroll
        for (int g = 0; g < GC; ++g) s[j][g] = 0.f;
#pragma unroll
      for (int cc = 0; cc < (CPR + kWarps - 1) / kWarps; ++cc) {
        const int c = warp + cc * kWarps;
        if (c < CPR) {
#pragma unroll
          for (int j = 0; j < PPL; ++j) {
            float kf[VN];
            unpack(*reinterpret_cast<const Raw*>(
                       kst + ((lane + 32 * j) * RC + c) * 16), kf);
#pragma unroll
            for (int g = 0; g < GC; ++g) {
              const float4* qv =
                  reinterpret_cast<const float4*>(&q_s[g][c * VN]);
#pragma unroll
              for (int e4 = 0; e4 < VN / 4; ++e4) {
                const float4 qq = qv[e4];
                float a = s[j][g];
                a = fmaf(qq.x, kf[4 * e4], a);
                a = fmaf(qq.y, kf[4 * e4 + 1], a);
                a = fmaf(qq.z, kf[4 * e4 + 2], a);
                a = fmaf(qq.w, kf[4 * e4 + 3], a);
                s[j][g] = a;
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < PPL; ++j)
#pragma unroll
        for (int g = 0; g < GC; ++g) s_part[warp][g][lane + 32 * j] = s[j][g];
    }
    __syncthreads();

    // one online-softmax step per head and tile: a warp per head
    for (int g = warp; g < GC; g += kWarps) {
      float x[PPL];
      bool ok[PPL];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < PPL; ++j) {
        const int p = lane + 32 * j;
        ok[j] = i0 + p < end;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += s_part[w][g][p];
        x[j] = v;
        mx = fmaxf(mx, ok[j] ? v : kNegInf);
      }
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < PPL; ++j) {
        const float p = ok[j] ? expf(x[j] - m_new) : 0.f;
        p_s[lane + 32 * j][g] = p;
        sum += p;
      }
      sum = warp_sum(sum);
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
    if (pg < PG) {
#pragma unroll 4
      for (int p = pg; p < TILE; p += PG) {
        float vf[VN];
        unpack(*reinterpret_cast<const Raw*>(vst + (p * RC + pc) * 16), vf);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float pr = p_s[p][g];
#pragma unroll
          for (int e = 0; e < VN; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
        }
      }
    }
    __syncthreads();     // the stage and p_s are rewritten next
  }
  cp_async_wait<0>();
  __syncthreads();

  // sum the PG partial accumulators through the (now idle) ring
  float* red = reinterpret_cast<float*>(ring);   // [PG][GC][D]
  if (pg < PG) {
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int e = 0; e < VN; ++e)
        red[(pg * GC + g) * D + pc * VN + e] = acc[g][e];
  }
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
  int* counter = counters + head * NG + grp;
  if (tid == 0) last_s = atomicAdd(counter, 1) == nvalid - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (tid == 0) *counter = 0;

  // the last split of (b, kh, group) combines all of them, in split order
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
  const void *q, *kc, *vc, *kn, *vn;
  const int* prev_len;
  void* out;
  float* ws;
  int* counters;
  int B, KH, G, smax, window, split;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int GC>
int launch(const Args& a) {
  using Gm = Geo<T, D>;
  static bool smem_set = false;
  auto* kernel = slot_decode_kernel<T, D, GC>;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::RING_BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  if (a.split % Gm::TILE) return (int)cudaErrorInvalidValue;
  const int nsplit = (a.smax + 1 + a.split - 1) / a.split;
  if (nsplit > kMaxSplits) return (int)cudaErrorInvalidValue;
  dim3 grid(a.KH * ((a.G + GC - 1) / GC), a.B, nsplit);
  const float scale = a.scale > 0.f ? a.scale : 1.0f / sqrtf((float)D);
  kernel<<<grid, kThreads, Gm::RING_BYTES, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kc),
      static_cast<const T*>(a.vc), static_cast<const T*>(a.kn),
      static_cast<const T*>(a.vn), a.prev_len, static_cast<T*>(a.out), a.ws,
      a.counters, a.KH, a.G, a.smax, a.window, a.split, nsplit, scale);
  return (int)cudaGetLastError();
}

// query heads per block: 1 for MHA, 4 up to G = 4, else 8
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
  switch (D) {
    case 64: return by_group<T, 64>(a);
    case 80: return by_group<T, 80>(a);
    case 128: return by_group<T, 128>(a);
    case 224: return by_group<T, 224>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int D>
int geometry(int* tile, int* stages) {
  *tile = Geo<T, D>::TILE;
  *stages = Geo<T, D>::STAGES;
  return Geo<T, D>::RING_BYTES;
}

template <typename T>
int geometry_by_dim(int D, int* tile, int* stages) {
  switch (D) {
    case 64: return geometry<T, 64>(tile, stages);
    case 80: return geometry<T, 80>(tile, stages);
    case 128: return geometry<T, 128>(tile, stages);
    case 224: return geometry<T, 224>(tile, stages);
    default: return 0;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out: (B, KH*G, D); caches:
// (B, KH, smax, D); k_new/v_new: (B, KH, D); prev_len: (B,) int32. All
// contiguous. workspace: B*KH*G*splits*(D+2) float32 with
// splits = ceil((smax + 1) / split); counters: B*KH*G int32, zero before
// the first call (every call leaves them zero). split: positions per split,
// a multiple of the tile (64 serves every head dim), at most 1024.
// window: 0 for none. scale: the softmax scale, 0 for 1/sqrt(D).
extern "C" int slot_decode_attention_fwd(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_new, const void* v_new, const int* prev_len, void* out,
    void* workspace, void* counters, int B, int KH, int G, int D, int smax,
    int window, int split, int dtype, float scale, void* stream) {
  if (B <= 0 || KH <= 0 || G <= 0 || smax <= 0 || window < 0 || split <= 0 ||
      split > kMaxSplit || workspace == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a{q, k_cache, v_cache, k_new, v_new, prev_len, out,
         static_cast<float*>(workspace), static_cast<int*>(counters),
         B, KH, G, smax, window, split, scale,
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return by_dim<float>(D, a);
  if (dtype == 1) return by_dim<__nv_bfloat16>(D, a);
  return (int)cudaErrorInvalidValue;
}

// launch geometry, for reports: query heads per block for G, positions per
// tile, ring stages and dynamic shared memory bytes for (D, dtype); 0 if
// unsupported
extern "C" int slot_attention_geometry(int G, int D, int dtype,
                                       int* heads_per_block, int* tile,
                                       int* stages) {
  *heads_per_block = group_size(G);
  if (dtype == 0) return geometry_by_dim<float>(D, tile, stages);
  if (dtype == 1) return geometry_by_dim<__nv_bfloat16>(D, tile, stages);
  return 0;
}

extern "C" const char* slot_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
