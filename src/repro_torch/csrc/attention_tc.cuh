// Tensor-core attention core for Hopper (sm_90a), bf16, shared by
// paged_prefill.cu (paged chunked prefill) and flash_attention.cu (dense
// prefill). Only how a K/V tile reaches shared memory differs between the
// two: DenseTmaLoader copies (b, keys, kh) boxes of a (B, Sk, KH, D) tensor
// by TMA, PagedLoader looks each key row up in tables[b][j / page] and
// copies it by cp.async.
//
// What it computes, for one block of kRows = 64 folded query rows
// r = c*G + g of one (b, kv head): row r sits at position start + r / G;
// key j is visible when j < klen, and j <= qpos if causal, and
// qpos - j < window if window > 0. Scores in fp32, online softmax in fp32
// (exp2 of log2e-scaled scores), probabilities rounded to bf16 for the PV
// product (as the plain version rounds them), output acc / max(l, 1e-30)
// in bf16, so a row with no visible key is zeros.
//
// Design. One warpgroup (128 threads) per block owns the 64 rows, the M of
// wgmma.mma_async m64nNk16. Q is gathered once from its (B, S, H, D) layout
// into registers, already in the A-operand fragment layout, so both
// products take A from registers: S = Q K^T (N = 64 keys, D / 16 k-steps)
// and O += P V (N = D, 4 k-steps), where P is the S accumulator rounded to
// bf16 and repacked in place (the accumulator and A fragment layouts
// coincide pairwise). K and V tiles of kKeys = 64 keys fill a ring of
// kStages = 2 stages, so tile t + 1 is in flight while tile t is
// multiplied. Both tiles are stored as 64-column blocks of 64 rows x 128 B
// in the 128-byte swizzle (16-byte chunk c of row n at chunk c ^ (n % 8),
// the layout TMA's SWIZZLE_128B writes): K is read K-major by its
// descriptor, V MN-major through the descriptor's transpose, so V is never
// transposed in memory. D = 80 uses a second column block of which only 16
// columns are filled. Only tiles that straddle the causal edge, the window
// edge or klen evaluate the mask; tiles that are wholly masked are never
// loaded.
//
// The caller launches kThreads threads with smem_bytes<D>() of dynamic
// shared memory (above 48 KB: cudaFuncSetAttribute first).

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace attn_tc {

constexpr int kRows = 64;       // folded query rows per block (wgmma M)
constexpr int kKeys = 64;       // keys per K/V tile
constexpr int kThreads = 128;   // one warpgroup
constexpr int kStages = 2;      // K/V tiles in flight
constexpr int kBlockBytes = kKeys * 128;   // one 64-column block of a tile
// wgmma descriptor strides of the tiles, in bytes: 8-row groups of the
// swizzle atom lie 1024 B apart; V's 64-column blocks kBlockBytes apart
constexpr uint32_t kAtomBytes = 1024;
constexpr uint32_t kVColBlockStride = kBlockBytes;

template <int D>
__host__ __device__ constexpr int col_blocks() { return (D + 63) / 64; }
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return col_blocks<D>() * kBlockBytes;
}
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)kStages * 2 * tile_bytes<D>() + 1024;   // + alignment
}

// byte offset of 16-byte chunk c (columns 8c .. 8c + 7) of key row n
__device__ __forceinline__ uint32_t chunk_offset(int n, int c) {
  return (uint32_t)((c >> 3) * kBlockBytes + n * 128 +
                    (((c & 7) ^ (n & 7)) << 4));
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
// make this thread's generic-proxy writes to shared memory (cp.async)
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of a wgmma operand across
// the asynchronous product's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma.mma_async m64nNk16: d (f32) += a (bf16, registers) * b (bf16,
// shared memory descriptor); TransB = 1 reads b MN-major. scale_d = 0
// overwrites d.
template <int N, int TransB>
struct Mma;

template <int TransB>
struct Mma<64, TransB> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TransB));
  }
};

template <int TransB>
struct Mma<80, TransB> {
  static __device__ __forceinline__ void run(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TransB));
  }
};

template <int TransB>
struct Mma<128, TransB> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TransB));
  }
};

template <int TransB>
struct Mma<224, TransB> {
  static __device__ __forceinline__ void run(float (&d)[112],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111"
        "}, {%112, %113, %114, %115}, %116, p, 1, 1, %118;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TransB));
  }
};

// mbarrier helpers (TMA completion)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// one box of a 4-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// K/V tile loaders. load() starts the copy of keys [k0, k0 + 64) into a
// stage; wait() returns once tile t's copy is visible to every thread's
// wgmma (newer: how many later tiles' copies were started after it).

// Dense (B, Sk, KH, D) k / v through two TMA tensor maps (the host's
// make_kv_map): box (64 columns, 1 head, 64 keys, 1) in the 128-byte
// swizzle, one box per 64-column block; keys at or past the map's key
// extent (seq_k) and columns past D arrive as zeros. Thread 0 issues the
// copies; one mbarrier per stage counts their bytes.
struct DenseTmaLoader {
  const void* kmap;
  const void* vmap;
  int b, kh;
  uint32_t bars;   // kStages mbarriers, 8 bytes apart, in shared memory

  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  template <int D>
  __device__ __forceinline__ void load(int k0, int /*khi*/, int stage,
                                       uint32_t kdst, uint32_t vdst) const {
    if (threadIdx.x != 0) return;
    const uint32_t bar = bars + 8 * stage;
    mbar_expect_tx(bar, 2 * col_blocks<D>() * kBlockBytes);
#pragma unroll
    for (int cb = 0; cb < col_blocks<D>(); ++cb) {
      tma_load_4d(kdst + cb * kBlockBytes, kmap, bar, cb * 64, kh, k0, b);
      tma_load_4d(vdst + cb * kBlockBytes, vmap, bar, cb * 64, kh, k0, b);
    }
  }
  __device__ __forceinline__ void wait(int t, int stage, int /*newer*/) const {
    mbar_wait(bars + 8 * stage, (t / kStages) & 1);
  }
};

// A (NP, page, KH, D) page pool, offset to kh, through one sequence's row
// of the block table: 16-byte cp.async copies, each key row's page looked
// up on its own (any page size that is a multiple of 16; a 64-key tile may
// span several pages or part of one); rows at or past khi are zero-filled
// and never read.
struct PagedLoader {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* table;
  int page;
  int row_stride;   // KH * D

  template <int D>
  __device__ __forceinline__ void load(int k0, int khi, int /*stage*/,
                                       uint32_t kdst, uint32_t vdst) const {
    constexpr int CPR = D / 8;   // 16-byte chunks of a key row
    static_assert(kKeys * CPR % kThreads == 0, "uneven tile load");
#pragma unroll
    for (int i = 0; i < kKeys * CPR / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads, n = idx / CPR,
                c = idx % CPR, j = k0 + n;
      const bool ok = j < khi;
      const size_t off =
          (ok ? ((size_t)table[j / page] * page + j % page) * row_stride : 0) +
          (size_t)c * 8;
      const uint32_t so = chunk_offset(n, c);
      cp_async_16(kdst + so, k + off, ok);
      cp_async_16(vdst + so, v + off, ok);
    }
    cp_async_commit();
  }
  __device__ __forceinline__ void wait(int, int, int newer) const {
    static_assert(kStages == 2, "one newer copy group at most");
    if (newer)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    fence_async_shared();   // this thread's copies, to wgmma's proxy
    __syncthreads();        // ... and every thread's
  }
};

// One block's 64 folded query rows [row0, row0 + 64) of (b, kv head kh):
// q and out are (B, C, KH*G, D). See the note at the top of this file.
template <int D, class Loader>
__device__ __forceinline__ void attend(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    const Loader& loader, int b, int kh, int C, int KH, int G, int row0,
    int start, int klen, int causal, int window, float scale_log2) {
  constexpr int TB = tile_bytes<D>();
  constexpr int KS = D / 16;             // k-steps of Q K^T
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t2 = (lane & 3) * 2;
  const int R = C * G, H = KH * G;
  // this thread's two rows of the accumulators: rA and rA + 8
  const int rA = row0 + warp * 16 + (lane >> 2), rB = rA + 8;
  const int qposA = start + rA / G, qposB = start + rB / G;

  // Q in the A-operand fragment layout of m64nNk16 (per warp, that of
  // mma.m16n8k16): {rA, cols 2t..}, {rB, 2t..}, {rA, 8+2t..}, {rB, 8+2t..}
  uint32_t qf[KS][4];
  {
    const uint32_t* qa = rA < R
        ? reinterpret_cast<const uint32_t*>(
              q + (((size_t)b * C + rA / G) * H + (size_t)kh * G + rA % G) * D)
        : nullptr;
    const uint32_t* qb = rB < R
        ? reinterpret_cast<const uint32_t*>(
              q + (((size_t)b * C + rB / G) * H + (size_t)kh * G + rB % G) * D)
        : nullptr;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int w0 = (16 * kk + t2) >> 1, w1 = w0 + 4;
      qf[kk][0] = qa ? qa[w0] : 0u;
      qf[kk][1] = qb ? qb[w0] : 0u;
      qf[kk][2] = qa ? qa[w1] : 0u;
      qf[kk][3] = qb ? qb[w1] : 0u;
    }
  }

  // keys this block can see: [klo, khi), klo aligned down to a tile
  const int last_row = min(row0 + kRows, R) - 1;
  const int qmin = start + row0 / G, qmax = start + last_row / G;
  const int klo = window > 0 ? (max(0, qmin - window + 1) & ~(kKeys - 1)) : 0;
  const int khi = causal ? min(klen, qmax + 1) : klen;
  const int ntiles = khi > klo ? (khi - klo + kKeys - 1) / kKeys : 0;

  auto load_tile = [&](int t) {
    const uint32_t kdst = base + (t % kStages) * 2 * TB;
    loader.template load<D>(klo + t * kKeys, khi, t % kStages, kdst,
                            kdst + TB);
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float mA = -INFINITY, mB = -INFINITY, lA = 0.f, lB = 0.f;

  for (int t = 0; t < kStages - 1 && t < ntiles; ++t) load_tile(t);
  for (int t = 0; t < ntiles; ++t) {
    // into the stage that tile t - 1 released
    if (t + kStages - 1 < ntiles) load_tile(t + kStages - 1);
    loader.wait(t, t % kStages, min(kStages - 1, ntiles - 1 - t));
    const uint32_t kb = base + (t % kStages) * 2 * TB, vb = kb + TB;
    const int k0 = klo + t * kKeys;

    // S = Q K^T: 64 rows x 64 keys, fp32
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      Mma<64, 0>::run(s, qf[kk],
                      desc_sw128(kb + (kk >> 2) * kBlockBytes + (kk & 3) * 32,
                                 16, kAtomBytes),
                      kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // accumulator element e: row (e & 2 ? rB : rA), key k0 + 8 (e / 4) +
    // t2 + (e & 1)
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] *= scale_log2;
    const bool full = k0 + kKeys <= klen &&
                      (!causal || k0 + kKeys - 1 <= qmin) &&
                      (window <= 0 || qmax - k0 < window);
    if (!full) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int j = k0 + 8 * (e >> 2) + t2 + (e & 1);
        const int qp = (e & 2) ? qposB : qposA;
        const bool vis = j < klen && (!causal || j <= qp) &&
                         (window <= 0 || qp - j < window);
        s[e] = vis ? s[e] : -INFINITY;
      }
    }
    float xA = mA, xB = mB;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      xA = fmaxf(xA, fmaxf(s[4 * n], s[4 * n + 1]));
      xB = fmaxf(xB, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, off));
      xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, off));
    }
    // a row with nothing visible yet keeps m = -inf and subtracts 0, so
    // its probabilities and its correction are exp2(-inf) = 0, never NaN
    const float uA = xA == -INFINITY ? 0.f : xA;
    const float uB = xB == -INFINITY ? 0.f : xB;
    const float cA = exp2f(mA - uA), cB = exp2f(mB - uB);
    mA = xA;
    mB = xB;
    uint32_t pf[4][4];
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2f(s[4 * n] - uA), p1 = exp2f(s[4 * n + 1] - uA);
      const float p2 = exp2f(s[4 * n + 2] - uB), p3 = exp2f(s[4 * n + 3] - uB);
      sumA += p0 + p1;
      sumB += p2 + p3;
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    lA = lA * cA + sumA;
    lB = lB * cB + sumB;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= cA;
      o[4 * n + 1] *= cA;
      o[4 * n + 2] *= cB;
      o[4 * n + 3] *= cB;
    }

    // O += P V: 64 rows x D, 4 k-steps of 16 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      Mma<D, 1>::run(o, pf[kk],
                     desc_sw128(vb + kk * 16 * 128, kVColBlockStride,
                                kAtomBytes),
                     1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pf);
    __syncthreads();   // every warp is done with this stage
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    lA += __shfl_xor_sync(0xffffffffu, lA, off);
    lB += __shfl_xor_sync(0xffffffffu, lB, off);
  }
  const float iA = 1.f / fmaxf(lA, 1e-30f), iB = 1.f / fmaxf(lB, 1e-30f);
  if (rA < R) {
    uint32_t* op = reinterpret_cast<uint32_t*>(
        out + (((size_t)b * C + rA / G) * H + (size_t)kh * G + rA % G) * D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      op[(8 * n + t2) >> 1] = pack_bf16(o[4 * n] * iA, o[4 * n + 1] * iA);
  }
  if (rB < R) {
    uint32_t* op = reinterpret_cast<uint32_t*>(
        out + (((size_t)b * C + rB / G) * H + (size_t)kh * G + rB % G) * D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      op[(8 * n + t2) >> 1] = pack_bf16(o[4 * n + 2] * iB, o[4 * n + 3] * iB);
  }
}

}  // namespace attn_tc
