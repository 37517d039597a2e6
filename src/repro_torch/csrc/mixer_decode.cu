// The Mamba2 mixer's single-token decode step for Hopper (sm_90a), between
// its two projections, in two launches.
//
// Replaces no Pallas kernel. The JAX package's decode step
// (src/repro/models/mamba2.py, _mixer with a state, and ssd_decode_step) is
// jnp that XLA fuses on the TPU. Its plain PyTorch port
// (src/repro_torch/models/mamba2.py mixer_decode_step, which the wrapper
// runs for CPU tensors) issued about forty launches a layer and moved the
// float32 SSM state about nine times: the decay product, the outer product
// of x and B, their sum, the float32 GEMV of the readout and the slot
// cache's write-back of the new state.
//
// Two launches. mixer_decode_kernel computes, for slot b and head h of
// group g = h / (H / G), from the in_proj row zxbcdt = [z | x B C | dt] in
// bf16:
//   - the causal conv of the window's K - 1 rows and the row's x B C, over
//     the head's P x columns and its group's N B and N C columns, rounded
//     to bf16 after the sum of K products, after the bias and after the
//     SiLU;
//   - dt = softplus(dt_raw + dt_bias) and decay = exp(dt * -exp(A_log)) in
//     float32;
//   - xdt = x * bf16(dt), rounded to bf16;
//   - h <- h * decay + xdt B^T in float32, in place;
//   - y = bf16(C . h); y = bf16(y + D x); out = bf16(y * bf16(SiLU(z))).
// These are the plain path's rounding points, and the state update rounds
// its two products and their sum as the plain path does (no fused
// multiply-add), so the new state is the plain path's bit for bit wherever
// the conv's outputs are. The conv's K products and the readout's N
// products are summed in another order than cuBLAS sums them.
// The window shifts in place: rows 1 .. K - 2 move up a row and the row's
// x B C becomes its last row. mixer_norm_kernel then takes the gated RMS
// norm of each (slot, group)'s di / G columns of out in place, as the plain
// path's rms_norm: the float32 sum of squares over the columns (in another
// order), x * rsqrt(mean + eps) rounded, times the weight rounded, rounded
// to bf16. The norm needs a sum across the group's heads, which the first
// launch's blocks split, so it runs as the second launch.
//
// What bounds it on the H100: device-memory bytes. The state is read and
// written once, P * N * 4 bytes each way a (slot, head): at Zamba2-7B's
// serving shape (32 slots, 112 heads, N = 64) 117.4 MB a layer, 35 us at
// 3.35 TB/s, against 6 flops a state element. The norm moves the output,
// 0.46 MB there, twice.
//
// Design.
// - Grid (H, B): a block of 128 threads owns one (slot, head) state, 16 KB
//   at N = 64, 32 KB at N = 128. Consecutive blocks take consecutive heads
//   of a slot, so the card streams the state in its memory order.
// - A thread owns 4 consecutive n of P / (128 / (N / 4)) rows. It issues
//   all its 16-byte state loads first, so the state is in flight while the
//   block computes the conv; then it updates them, stores them (16 bytes,
//   streaming) and sums its 4 products of each row's readout, which the
//   row's N / 4 lanes reduce by shuffles.
// - The conv: a thread takes 8 columns, with 16-byte loads of the window,
//   the weights and the bias, and of the row where its stride allows (else
//   by element). The head's x columns are its own: the thread that
//   computed them shifts them in the window. A group's B and C columns are
//   read by each of the group's H / G blocks: a block counts itself on the
//   (slot, group)'s counter once it has read them, and the block that
//   counts last shifts them and resets the counter, so no block reads a
//   shifted window and every call leaves the counters zero.
// - The norm: a block of 256 threads a (slot, group) holds the group's
//   columns in registers, 8 a 16-byte chunk and at most 4 chunks a thread
//   (groups of up to 8192 columns), sums their squares by shuffles and
//   shared memory, and writes them back normalised.
// - It allocates nothing, reads no length or flag on the host and launches
//   on the caller's stream, so a CUDA graph can replay both launches. The
//   entry returns cudaGetLastError() after each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kP = 64;      // head dim
constexpr int kK = 4;       // conv taps
constexpr int kNormThreads = 256;
constexpr int kNormChunks = 4;  // 8-column chunks a thread of the norm

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
// PyTorch's SiLU and softplus (threshold 20) in float32
__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}
__device__ __forceinline__ float softplus(float x) {
  return x > 20.0f ? x : log1pf(expf(x));
}

__device__ __forceinline__ void unpack8(const uint4& r, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return r;
}
// 8 elements of the row: one 16-byte load when `vec`, else one by one
__device__ __forceinline__ void load_row8(const bf16* p, bool vec, float* f) {
  if (vec) {
    unpack8(__ldg(reinterpret_cast<const uint4*>(p)), f);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(p[j]);
  }
}
// 8 columns of the window up a row, the row's x B C into its last row
__device__ __forceinline__ void shift_window(bf16* win, int ch, const bf16* src,
                                             bool vec) {
#pragma unroll
  for (int r = 0; r < kK - 2; ++r)
    *reinterpret_cast<uint4*>(win + r * ch) =
        *reinterpret_cast<const uint4*>(win + (r + 1) * ch);
  bf16* last = win + (kK - 2) * ch;
  if (vec) {
    *reinterpret_cast<uint4*>(last) = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) last[j] = src[j];
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
mixer_decode_kernel(const bf16* __restrict__ zx, bf16* __restrict__ conv,
                    float* __restrict__ ssm, const bf16* __restrict__ conv_w,
                    const bf16* __restrict__ conv_b,
                    const float* __restrict__ a_log,
                    const float* __restrict__ dt_bias,
                    const float* __restrict__ d_skip, bf16* __restrict__ out,
                    int* __restrict__ counters, int H, int G, int row_vec) {
  constexpr int LANES = N / 4;              // threads of a state row
  constexpr int RPP = kThreads / LANES;     // rows a pass
  constexpr int PASSES = kP / RPP;
  constexpr int XCH = kP / 8;               // 8-column chunks: x, then B, C
  constexpr int BCH = N / 8;
  constexpr int CHUNKS = XCH + 2 * BCH;
  constexpr int Z_T = 64, DT_T = 96;        // z's and dt's threads
  static_assert(CHUNKS <= Z_T && Z_T + XCH <= DT_T, "thread roles overlap");

  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int di = H * kP, gn = G * N, ch = di + 2 * gn;
  const int hpg = H / G, g = h / hpg;
  const bool vec = row_vec != 0;
  const bf16* row = zx + (size_t)b * (2 * di + 2 * gn + H);
  bf16* win = conv + (size_t)b * (kK - 1) * ch;

  __shared__ __align__(16) float xs[kP];
  __shared__ __align__(16) float bs[N];
  __shared__ __align__(16) float cs[N];
  __shared__ float gz[kP];
  __shared__ float ys[kP];
  __shared__ float s_dtb, s_decay;
  __shared__ int s_last;

  // the state first: in flight while the conv is computed
  float* st = ssm + ((size_t)b * H + h) * kP * N;
  const int n0 = (t % LANES) * 4, r0 = t / LANES;
  float4 hv[PASSES];
#pragma unroll
  for (int i = 0; i < PASSES; ++i)
    hv[i] = __ldcs(reinterpret_cast<const float4*>(
        st + (size_t)(i * RPP + r0) * N + n0));

  // the conv over 8 columns a thread (xBC starts at di in the row)
  int col = 0;
  if (t < CHUNKS) {
    float* dst;
    if (t < XCH) {
      col = h * kP + t * 8;
      dst = xs + t * 8;
    } else if (t < XCH + BCH) {
      col = di + g * N + (t - XCH) * 8;
      dst = bs + (t - XCH) * 8;
    } else {
      col = di + gn + g * N + (t - XCH - BCH) * 8;
      dst = cs + (t - XCH - BCH) * 8;
    }
    float v[kK][8], w[8], acc[8];
#pragma unroll
    for (int r = 0; r < kK - 1; ++r)
      unpack8(*reinterpret_cast<const uint4*>(win + r * ch + col), v[r]);
    load_row8(row + di + col, vec, v[kK - 1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      unpack8(__ldg(reinterpret_cast<const uint4*>(conv_w + k * ch + col)), w);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(w[j], v[k][j], acc[j]);
    }
    unpack8(__ldg(reinterpret_cast<const uint4*>(conv_b + col)), w);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[j] = round_bf16(silu(round_bf16(round_bf16(acc[j]) + w[j])));
    if (t < XCH) shift_window(win + col, ch, row + di + col, vec);
  } else if (t >= Z_T && t < Z_T + XCH) {
    float z[8];
    load_row8(row + h * kP + (t - Z_T) * 8, vec, z);
#pragma unroll
    for (int j = 0; j < 8; ++j) gz[(t - Z_T) * 8 + j] = round_bf16(silu(z[j]));
  } else if (t == DT_T) {
    const float dt = softplus(__bfloat162float(row[2 * di + 2 * gn + h]) +
                              dt_bias[h]);
    s_dtb = round_bf16(dt);
    s_decay = expf(dt * -expf(a_log[h]));
  }
  __syncthreads();

  // every read of the group's B and C window columns is done: count it
  if (t == 0) {
    __threadfence();
    int* cnt = counters + b * G + g;
    const int last = atomicAdd(cnt, 1) == hpg - 1;
    if (last) atomicExch(cnt, 0);
    s_last = last;
  }

  // the state update and the readout
  const float dtb = s_dtb, decay = s_decay;
  const float4 bv = *reinterpret_cast<const float4*>(bs + n0);
  const float4 cv = *reinterpret_cast<const float4*>(cs + n0);
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int p = i * RPP + r0;
    const float xdt = round_bf16(xs[p] * dtb);
    float4 hn;
    hn.x = __fadd_rn(__fmul_rn(hv[i].x, decay), __fmul_rn(xdt, bv.x));
    hn.y = __fadd_rn(__fmul_rn(hv[i].y, decay), __fmul_rn(xdt, bv.y));
    hn.z = __fadd_rn(__fmul_rn(hv[i].z, decay), __fmul_rn(xdt, bv.z));
    hn.w = __fadd_rn(__fmul_rn(hv[i].w, decay), __fmul_rn(xdt, bv.w));
    __stcs(reinterpret_cast<float4*>(st + (size_t)p * N + n0), hn);
    float part = cv.x * hn.x;
    part = fmaf(cv.y, hn.y, part);
    part = fmaf(cv.z, hn.z, part);
    part = fmaf(cv.w, hn.w, part);
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (t % LANES == 0) ys[p] = part;
  }
  __syncthreads();

  // out = bf16(bf16(y) + D x) * bf16(SiLU(z)), 8 columns a thread
  if (t < XCH) {
    const float dh = d_skip[h];
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = t * 8 + j;
      const float y = round_bf16(__fadd_rn(round_bf16(ys[p]), __fmul_rn(dh, xs[p])));
      o[j] = y * gz[p];
    }
    *reinterpret_cast<uint4*>(out + (size_t)b * di + h * kP + t * 8) = pack8(o);
  } else if (s_last && t < CHUNKS) {
    // the group's last block shifts its B and C columns
    shift_window(win + col, ch, row + di + col, vec);
  }
}

__global__ void __launch_bounds__(kNormThreads)
mixer_norm_kernel(bf16* __restrict__ y, const bf16* __restrict__ weight,
                  int di, int cols, float eps) {
  const int g = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  bf16* row = y + (size_t)b * di + g * cols;
  const bf16* w = weight + g * cols;
  const int chunks = cols / 8;
  __shared__ float part[kNormThreads / 32];
  __shared__ float s_r;

  float v[kNormChunks][8];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kNormChunks; ++i) {
    const int c = t + i * kNormThreads;
    if (c < chunks) {
      unpack8(*reinterpret_cast<const uint4*>(row + c * 8), v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) ss = fmaf(v[i][j], v[i][j], ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (t % 32 == 0) part[t / 32] = ss;
  __syncthreads();
  if (t == 0) {
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kNormThreads / 32; ++i) sum += part[i];
    s_r = rsqrtf(sum / (float)cols + eps);
  }
  __syncthreads();
  const float r = s_r;
#pragma unroll
  for (int i = 0; i < kNormChunks; ++i) {
    const int c = t + i * kNormThreads;
    if (c < chunks) {
      float wv[8], o[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(w + c * 8)), wv);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = __fmul_rn(__fmul_rn(v[i][j], r), wv[j]);
      *reinterpret_cast<uint4*>(row + c * 8) = pack8(o);
    }
  }
}

template <int N>
int launch(const void* zx, void* conv, void* ssm, const void* conv_w,
           const void* conv_b, const void* a_log, const void* dt_bias,
           const void* d_skip, void* out, void* counters, int B, int H, int G,
           int row_vec, cudaStream_t stream) {
  mixer_decode_kernel<N><<<dim3(H, B), kThreads, 0, stream>>>(
      static_cast<const bf16*>(zx), static_cast<bf16*>(conv),
      static_cast<float*>(ssm), static_cast<const bf16*>(conv_w),
      static_cast<const bf16*>(conv_b), static_cast<const float*>(a_log),
      static_cast<const float*>(dt_bias), static_cast<const float*>(d_skip),
      static_cast<bf16*>(out), static_cast<int*>(counters), H, G, row_vec);
  return (int)cudaGetLastError();
}

}  // namespace

// zxbcdt: (B, 2 * H * 64 + 2 * G * N + H) bf16, 16-byte aligned rows when
// row_vec is set; conv: (B, 3, H * 64 + 2 * G * N) bf16 and ssm:
// (B, H, 64, N) float32, updated in place; conv_w: (4, Ch) and conv_b: (Ch,)
// bf16; a_log, dt_bias, d_skip: (H,) float32; norm_w: (H * 64,) bf16; out:
// (B, H * 64) bf16. All contiguous; conv, ssm, conv_w, conv_b, norm_w and
// out 16-byte aligned. counters: B * G int32, zero before the first call
// (every call leaves them zero). N: 64 or 128; G must divide H, and a
// group's H * 64 / G columns be at most 8192.
extern "C" int mixer_decode_fwd(const void* zxbcdt, void* conv, void* ssm,
                                const void* conv_w, const void* conv_b,
                                const void* a_log, const void* dt_bias,
                                const void* d_skip, const void* norm_w,
                                void* out, void* counters, int B, int H,
                                int G, int N, int row_vec, float eps,
                                void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G || B > 65535 ||
      H * kP / G > kNormThreads * kNormChunks * 8 || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (N) {
    case 64:
      rc = launch<64>(zxbcdt, conv, ssm, conv_w, conv_b, a_log, dt_bias,
                      d_skip, out, counters, B, H, G, row_vec, s);
      break;
    case 128:
      rc = launch<128>(zxbcdt, conv, ssm, conv_w, conv_b, a_log, dt_bias,
                       d_skip, out, counters, B, H, G, row_vec, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  mixer_norm_kernel<<<dim3(G, B), kNormThreads, 0, s>>>(
      static_cast<bf16*>(out), static_cast<const bf16*>(norm_w), H * kP,
      H * kP / G, eps);
  return (int)cudaGetLastError();
}

extern "C" const char* mixer_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
