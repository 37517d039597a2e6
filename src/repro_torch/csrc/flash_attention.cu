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
// window > 0. Scores in fp32 scaled by the caller's scale (1/sqrt(D) when it
// passes 0); online softmax in fp32;
// output acc / max(l, 1e-30) in the input dtype, so a row with no visible
// key is zeros. q is read and the output written in their (B, Sq, H, D)
// layout: no fold copies on either side.
//
// What bounds it on the H100. At zamba2-2.7b's shared attention at prefill
// (B = 1, Sq = Sk = 2048, 32 heads of D = 80, MHA) the causal pairs need
// 4 * D flops each, about 21 GFLOP, against about 42 MB of q, k, v and
// output: some 500 flops per byte, above the ~295 flop/byte ridge, so the
// least time is the flops over the tensor cores' 989 TFLOP/s.
//
// Design. bfloat16, the engine's dtype, runs the tensor-core core of
// attention_tc.cuh (wgmma m64nNk16 for both products, K/V tiles of 64 keys
// in a two-stage ring; D = 80 pads its tiles' second column block): one
// block per (b, kv head, tile of 64 folded query rows), the heaviest (last)
// row tiles launched first when causal. K and V tiles arrive by TMA
// (attn_tc::DenseTmaLoader): the host encodes k and v as 4-D tensor maps
// (D, KH, seq_k, B) with a (64, 1, 64, 1) box in the 128-byte swizzle,
// through the driver's cuTensorMapEncodeTiled found at run time, so no
// driver library is linked; keys past seq_k and columns past D arrive as
// zeros. The block's key loop runs from its first visible key (its window
// edge, aligned down to a tile) to its last (its causal edge, or seq_k), so
// fully masked key tiles are never loaded, as the TPU kernel's pl.when skip
// does.
//
// float32 keeps the first version's design, fp32 FMA on the CUDA cores
// (tensor cores would mean TF32, which misses the f32 checks): Q (scaled),
// K and V tiles of KT = 32 keys in shared memory (rows padded by one float
// against bank conflicts); each thread owns 4 query rows x 4 key columns of
// the score tile and 4 rows x D/8 columns of the output, with the row max
// and row sum reduced over the 8 lanes that share a row. Head dims 64, 80
// (zamba2-2.7b), 128 and 224 (Zamba2-7B's shared attention: heads of 224
// over the 7168-wide concatenation at scale (224/2)^-0.5; its tiles take
// four 64-column blocks, the last one half filled) are instantiated for
// both dtypes.
//
// Launches on the caller's stream, allocates nothing, does not synchronise.
// The entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda.h>   // CUtensorMap and its enums (no driver library linked)
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
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const float* __restrict__ q,     // (B, Sq, KH*G, D)
    const float* __restrict__ k,     // (B, Sk, KH, D)
    const float* __restrict__ v,
    float* __restrict__ out,         // (B, Sq, KH*G, D)
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
  const float* kb = k + (size_t)b * Sk * KH * D + (size_t)kh * D;
  const float* vb = v + (size_t)b * Sk * KH * D + (size_t)kh * D;

  for (int i = tid; i < kQT * D; i += kThreads) {
    const int r = i / D, d = i % D, row = row0 + r;
    float val = 0.f;
    if (row < R) {
      const int c = row / G, g = row % G;
      val = q[(((size_t)b * Sq + c) * H + (size_t)kh * G + g) * D + d] * scale;
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
        kv = kb[off];
        vv = vb[off];
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
    float* op = out + (((size_t)b * Sq + c0) * H + (size_t)kh * G + g) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < OC; ++c) op[tc + 8 * c] = o[i][c] / denom;
  }
}

template <int D>
__global__ void __launch_bounds__(attn_tc::kThreads) flash_tc_kernel(
    const __grid_constant__ CUtensorMap kmap,   // k: (B, Sk, KH, D)
    const __grid_constant__ CUtensorMap vmap,   // v: (B, Sk, KH, D)
    const __nv_bfloat16* __restrict__ q,        // (B, Sq, KH*G, D)
    __nv_bfloat16* __restrict__ out,            // (B, Sq, KH*G, D)
    int Sq, int KH, int G, int seq_k, int causal, int window,
    float scale_log2) {
  __shared__ __align__(8) uint64_t bars[attn_tc::kStages];
  const int b = blockIdx.x, kh = blockIdx.y;
  const int tile = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const attn_tc::DenseTmaLoader loader{&kmap, &vmap, b, kh,
                                       attn_tc::smem_u32(bars)};
  loader.init();
  attn_tc::attend<D>(q, out, loader, b, kh, Sq, KH, G, tile * attn_tc::kRows,
                     /*start=*/0, seq_k, causal, window, scale_log2);
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once through the runtime
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// k or v (B, Sk, KH, D) bf16 as the 4-D map (D, KH, seq_k, B), box
// (64, 1, kKeys, 1), 128-byte swizzle; out-of-range elements read as zero
int make_kv_map(CUtensorMap* map, const void* base, int B, int Sk, int KH,
                int D, int seq_k) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)KH,
                              (cuuint64_t)max(seq_k, 1), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)KH * D * 2,
                                 (cuuint64_t)Sk * KH * D * 2};
  const cuuint32_t box[4] = {64, 1, attn_tc::kKeys, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
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
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int KH, int G, int seq_k, int causal,
               int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static bool attr_set = false;
  if (int e = allow_smem(flash_kernel<D>, bytes, attr_set)) return e;
  dim3 grid(B, KH, (Sq * G + kQT - 1) / kQT);
  flash_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, KH, G,
      seq_k, causal, window, scale > 0.f ? scale : 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int KH, int G, int seq_k, int causal,
                int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = attn_tc::smem_bytes<D>();
  static bool attr_set = false;
  if (int e = allow_smem(flash_tc_kernel<D>, bytes, attr_set)) return e;
  CUtensorMap kmap, vmap;
  if (int e = make_kv_map(&kmap, k, B, Sk, KH, D, seq_k)) return e;
  if (int e = make_kv_map(&vmap, v, B, Sk, KH, D, seq_k)) return e;
  dim3 grid(B, KH, (Sq * G + attn_tc::kRows - 1) / attn_tc::kRows);
  flash_tc_kernel<D><<<grid, attn_tc::kThreads, bytes, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), Sq, KH, G, seq_k, causal, window,
      scale > 0.f ? 1.4426950408889634f * scale
                  : 1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out: (B, Sq, KH*G, D); k, v:
// (B, Sk, KH, D); all contiguous. seq_k <= Sk keys are valid; window 0 means
// unlimited; causal 0 or 1; scale the softmax scale, 0 for 1/sqrt(D).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Sk, int KH, int G, int D, int seq_k,
                                   int causal, int window, int dtype,
                                   float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || G <= 0 || seq_k < 0 ||
      seq_k > Sk || window < 0 || !(scale >= 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS \
  q, k, v, out, B, Sq, Sk, KH, G, seq_k, causal, window, scale, s
  if (dtype == 0 && D == 64) return launch_f32<64>(FLASH_ARGS);
  if (dtype == 0 && D == 80) return launch_f32<80>(FLASH_ARGS);
  if (dtype == 0 && D == 128) return launch_f32<128>(FLASH_ARGS);
  if (dtype == 0 && D == 224) return launch_f32<224>(FLASH_ARGS);
  if (dtype == 1 && D == 64) return launch_bf16<64>(FLASH_ARGS);
  if (dtype == 1 && D == 80) return launch_bf16<80>(FLASH_ARGS);
  if (dtype == 1 && D == 128) return launch_bf16<128>(FLASH_ARGS);
  if (dtype == 1 && D == 224) return launch_bf16<224>(FLASH_ARGS);
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
