// Device and host helpers shared by the Hopper (sm_90a) flash-attention
// kernels, flash_fwd_sm90.cu and flash_bwd_sm90.cu: mbarriers, TMA loads
// and tensor maps, wgmma shared-memory descriptors, the wgmma fences and
// the two product forms both kernels are built from, and the fragment
// conversions between them.
//
// The two product forms (each one committed group of k16 steps):
//   * ss_start: d (64 x N fp32) = A·Bᵀ with A (64 rows) and B (N rows)
//     both K-major in 128-byte-swizzled shared memory (Q·Kᵀ, dO·Vᵀ, K·Qᵀ,
//     V·dOᵀ);
//   * rs_start: d (64 x D fp32) += A·B with A (64 x K bf16) from registers
//     and B (K rows of D columns) MN-major in shared memory, the transpose
//     bit set (P·V, dS·K, Pᵀ·dO, dSᵀ·Q).
// A 128-byte swizzle row spans 64 bf16 columns, so a D = 128 tile is two
// 64-column regions, `region` bytes apart.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "flash_common.cuh"

namespace hvd_flash {

constexpr int kRow = 128;  // bytes of a swizzled row (64 bf16 columns)
constexpr float kLog2e = 1.4426950408889634f;

// -- barriers, TMA -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity; a wait
// past 2^28 polls (seconds: a phase that can never complete) traps, so a
// pipeline fault fails the launch with an error instead of hanging the card
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1): start
// address, leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads and writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HVD_D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HVD_D32 HVD_D8(0), HVD_D8(8), HVD_D8(16), HVD_D8(24)
#define HVD_D64 HVD_D32, HVD_D8(32), HVD_D8(40), HVD_D8(48), HVD_D8(56)
#define HVD_R32                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define HVD_R64                                                           \
  HVD_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63"

// d (64 x N fp32) = [d +] A·B, A and B K-major in shared memory
template <int N> struct WgmmaSS;
template <> struct WgmmaSS<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HVD_R32
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : HVD_D32 : "l"(a), "l"(b), "r"(acc));
  }
};
template <> struct WgmmaSS<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HVD_R64
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : HVD_D64 : "l"(a), "l"(b), "r"(acc));
  }
};

// d (64 x N fp32) += A·B, A (64 x 16 bf16) from registers, B MN-major in
// shared memory (transpose bit set)
template <int N> struct WgmmaRS;
template <> struct WgmmaRS<64> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HVD_R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HVD_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct WgmmaRS<128> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HVD_R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : HVD_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// -- the two product forms ---------------------------------------------------
//
// Accumulator fragment of a 64 x N fp32 wgmma tile (PTX ISA, wgmma D
// fragments): warp w of the warpgroup holds rows 16w..16w+15; lane t holds
// rows r0 = 16w + t/4 and r1 = r0 + 8, and for column block i (8 columns)
// d[4i] , d[4i+1] = (r0, 8i + 2(t%4) + {0, 1}),
// d[4i+2], d[4i+3] = (r1, 8i + 2(t%4) + {0, 1}).

// start d (64 x N) = A·Bᵀ as one committed group, the contraction over D:
// `a` the warpgroup's first A row in region 0, `b` the first B row in
// region 0; regions `a_region` / `b_region` bytes apart; each k16 step
// moves 32 bytes along a 128-byte swizzled row
template <int D, int N>
__device__ __forceinline__ void ss_start(float (&d)[N / 2], uint32_t a,
                                         uint32_t a_region, uint32_t b,
                                         uint32_t b_region) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    const uint32_t off = (j % 4) * 32;
    WgmmaSS<N>::run(d, desc(a + (j / 4) * a_region + off, 16, 8 * kRow),
                    desc(b + (j / 4) * b_region + off, 16, 8 * kRow), j);
  }
  wg_commit();
}

// start d (64 x D) += A·B as one committed group, the contraction over K
// rows of B: `a` holds the bf16 A fragments of A's k16 slices; `b` the
// first B row in region 0 (a k16 step is 16 rows further; the second
// 64-column region, at D = 128, is the leading byte offset `b_region`
// away)
template <int D, int K>
__device__ __forceinline__ void rs_start(float (&d)[D / 2],
                                         const uint32_t (&a)[K / 16][4],
                                         uint32_t b, uint32_t b_region) {
#pragma unroll
  for (int j = 0; j < K / 16; ++j)
    WgmmaRS<D>::run(d, a[j], desc(b + j * 16 * kRow, b_region, 8 * kRow));
  wg_commit();
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a 64 x K accumulator's k16 slice j is the A fragment of A's columns
// 16j..16j+15, rounded to bf16
template <int K>
__device__ __forceinline__ void to_a_fragments(const float (&s)[K / 2],
                                               uint32_t (&p)[K / 16][4]) {
#pragma unroll
  for (int j = 0; j < K / 16; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[j][r] = pack_bf16(s[8 * j + 2 * r], s[8 * j + 2 * r + 1]);
  }
}

// 2^x in one MUFU op (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// -- host side ---------------------------------------------------------------

inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(sym);
  }
  return fn;
}

// a bf16 (B, L, Hx, D) tensor with element strides (sb, sl, sh, 1) as a
// 4-D tensor map of 64-column x `rows`-row boxes, 128-byte swizzle,
// zeros past its edges
inline bool tensor_map(CUtensorMap* map, const void* ptr, int B, int Lr,
                       int Hx, int D, long long sb, long long sl,
                       long long sh, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Lr, (cuuint64_t)Hx,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)sl * 2, (cuuint64_t)sh * 2,
                           (cuuint64_t)sb * 2};
  cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hvd_flash
