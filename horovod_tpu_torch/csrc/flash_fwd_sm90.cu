// Flash-attention forward for Hopper (sm_90a) on the tensor cores: wgmma
// fed by TMA, bf16 in, fp32 statistics, head_dim D in {64, 128}.
//
// Replaces horovod_tpu/ops/flash_attention.py::_fwd_kernel for every bf16
// launch with D in {64, 128} and more than four query rows: the training
// forward (_forward_impl's uniform-offset launch, which also writes the
// log-sum-exp for the backward kernels: offset 0 for self-attention,
// (src − idx)·S for ring attention's off-diagonal blocks,
// flash_block_forward) and serving's chunked prefill
// (flash_chunk_attention's per-row-offset launch).  fp32 launches, other
// head widths and decode (C <= 4) stay on the CUDA-core kernel in
// flash_fwd.cu; the wrapper picks by dtype, D and C (_fwd_variant).
//
// What bounds it on an H100: ~C FLOPs per K/V byte, so arithmetic — and
// bf16 products reach the card's 989 TFLOP/s only through wgmma.  The
// design, per block of 128 query rows of one (batch, head):
//   * warps 0-7 are two consumer warpgroups of 64 query rows each; warp 8
//     is the producer: one lane starts every TMA copy;
//   * Q is loaded once by TMA, unscaled bf16, into 128-byte-swizzled
//     shared memory (a 128-byte swizzle spans 64 bf16 columns, so at
//     D = 128 every tile is two 64-column regions);
//   * K/V tiles of BK keys (128 at D = 64, 64 at D = 128) stream through
//     a ring of kStages = 3 stages, each with a "full" barrier (TMA bytes
//     landed) and an "empty" barrier (all 256 consumer threads done); the
//     4-D tensor maps address (B, S, H, D) through its strides, and TMA's
//     out-of-bounds zero fill stands in for the key < S branch;
//   * S = Q·Kᵀ is wgmma m64nBKk16 with both operands K-major in shared
//     memory; the online softmax runs on the accumulator fragment (a
//     row's max and sum across the four threads that share it, by
//     shuffles), the scale folded into exp2's argument (one FFMA and one
//     ex2 per score), with the mask evaluated only on tiles that cross
//     the causal diagonal, the window edge or S, through
//     hvd_flash::visible and kb_range (flash_common.cuh);
//   * O += P·V takes P from registers, rounded to bf16 (the S
//     accumulator's layout is the A operand's register layout), and V from
//     shared memory as the MN-major B operand (the transpose bit); l sums
//     the fp32 P;
//   * within a warpgroup, tile t's Q·Kᵀ is started with tile t-1's P·V,
//     and tile t's softmax runs while that P·V is on the tensor cores;
//   * the epilogue divides by l, writes bf16 through o's strides and the
//     fp32 log-sum-exp to (B, H, C); rows with no visible key come out as
//     exact zeros with the -1e30 sentinel;
//   * causal launches walk the Q tiles heaviest first.
// A consumer warpgroup waits for its wgmma groups to retire before it
// arrives on a stage's "empty" barrier, so the producer never overwrites
// a tile a product still reads.  Not done here: ping-pong between the two
// warpgroups, setmaxnreg, clusters, persistent blocks.
//
// The barrier, TMA and wgmma helpers and the two product forms live in
// flash_sm90.cuh, shared with the backward (flash_bwd_sm90.cu).
//
// Numerics: as _fwd_kernel, except that P is rounded to bf16 before P·V
// (about 2^-8 of a row's largest output, inside the bf16 tolerances) and
// the exponentials are exp2 of log2(e)-scaled scores.

#include "flash_sm90.cuh"

namespace {

using namespace hvd_flash;

constexpr int kConsumers = 2;                 // warpgroups of 64 rows
constexpr int kBQ = 64 * kConsumers;          // query rows per block
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kStages = 3;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int BK = D == 64 ? 128 : 64;  // keys per K/V tile
  static constexpr int R = D / 64;               // 64-column regions
  static constexpr int kQRegion = kBQ * kRow;
  static constexpr int kQBytes = R * kQRegion;
  static constexpr int kKVRegion = BK * kRow;
  static constexpr int kTileBytes = R * kKVRegion;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // + 1024 to align the base for the 128-byte swizzle
  static constexpr int kSmem = kBarOffset + 8 * (2 * kStages + 1) + 1024;
};

struct Params {
  __nv_bfloat16* o;
  float* lse;       // (B, H, C) fp32, or null
  const int* offs;  // (B,) kv_start - q_start
  int C, H, Hkv, S;
  long long o_sb, o_sc, o_sh;
  int window;  // <= 0: none
  int causal;
  float scale_log2;  // sm_scale * log2(e)
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// The online softmax of one tile on the S accumulator fragment (raw
// scores in, this thread's two rows r0 = row, r1 = row + 8): masks the
// tile when `edge` (hvd_flash::visible on global positions), updates the
// running max m (log2 units of the scaled score) and this thread's share
// of the row sums l, and leaves P = exp2(s·scale − m) as bf16 A fragments
// in `pa` and each row's correction factor for O in `corr`.
template <int BK>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], uint32_t (&pa)[BK / 16][4], float (&m)[2],
    float (&l)[2], float (&corr)[2], bool edge, int row, int col,
    const Params& p, int kv_off) {
  if (edge) {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int q_pos = row + 8 * ((e >> 1) & 1);
      const int k_pos = col + 8 * (e >> 2) + (e & 1);
      if (!visible(q_pos, k_pos, p.S, kv_off, p.causal, p.window))
        s[e] = kNegInf;
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = kNegInf;
#pragma unroll
    for (int e = 2 * hh; e < BK / 2; e += 4)
      mx = fmaxf(mx, fmaxf(s[e], s[e + 1]));
    mx = quad_max(mx);
    // scale > 0, so the scaled max is the max of the scaled scores; a row
    // with no visible key yet keeps the sentinel, and its probabilities
    // are zeroed (exp2(s - m) would be 1 there)
    const float m_new = fmaxf(m[hh], mx == kNegInf ? kNegInf
                                                   : mx * p.scale_log2);
    float sum = 0.f;
    if (m_new == kNegInf) {
#pragma unroll
      for (int e = 2 * hh; e < BK / 2; e += 4) s[e] = s[e + 1] = 0.f;
      corr[hh] = 1.f;
    } else {
#pragma unroll
      for (int e = 2 * hh; e < BK / 2; e += 4) {
        s[e] = ex2(fmaf(s[e], p.scale_log2, -m_new));
        s[e + 1] = ex2(fmaf(s[e + 1], p.scale_log2, -m_new));
        sum += s[e] + s[e + 1];
      }
      corr[hh] = ex2(m[hh] - m_new);
    }
    l[hh] = l[hh] * corr[hh] + sum;
    m[hh] = m_new;
  }
  to_a_fragments<BK>(s, pa);
}

// -- the kernel --------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const Params p) {
  using L = Cfg<D>;
  constexpr int BK = L::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + L::kQBytes;  // stage st: K, then V
  const uint32_t full = base + L::kBarOffset;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t q_bar = empty + 8 * kStages;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int n_qt = (p.C + kBQ - 1) / kBQ;
  const int q0 = (p.causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) *
                 kBQ;  // causal: the heaviest Q tiles first
  const int kv_off = p.offs[b];
  const int n_kb = (p.S + BK - 1) / BK;
  const int2 range = kb_range(q0, kBQ, BK, n_kb, p.causal, p.window, kv_off);
  const int n_tiles = max(0, range.y - range.x);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      bar_init(full + 8 * st, 1);
      bar_init(empty + 8 * st, kConsumerThreads);
    }
    bar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // warp 8: the producer
    if (lane == 0) {
      bar_expect_tx(q_bar, L::kQBytes);
      for (int r = 0; r < L::R; ++r)
        tma_load(q_s + r * L::kQRegion, &tq, q_bar, 64 * r, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        // round t / kStages reuses the stage: wait for the consumers'
        // release of the previous round
        if (t >= kStages) bar_wait(empty + 8 * st, (t / kStages - 1) & 1);
        bar_expect_tx(full + 8 * st, L::kStageBytes);
        const int key = (range.x + t) * BK;
        const uint32_t ks = kv_s + st * L::kStageBytes;
        for (int r = 0; r < L::R; ++r) {
          tma_load(ks + r * L::kKVRegion, &tk, full + 8 * st, 64 * r, key,
                   hk, b);
          tma_load(ks + L::kTileBytes + r * L::kKVRegion, &tv, full + 8 * st,
                   64 * r, key, hk, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns block rows 64wg .. 64wg+63
  const int wg = warp >> 2;
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // row in the warpgroup
  const int c2 = 2 * (lane & 3);                 // first column, per 8
  const int qw0 = q0 + 64 * wg;
  const int2 mine = kb_range(qw0, 64, BK, n_kb, p.causal, p.window, kv_off);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  // Tile t's Q·Kᵀ is started together with tile t-1's P·V, and tile t's
  // softmax runs while that P·V is on the tensor cores; O is rescaled
  // once the P·V has retired, then tile t-1's stage is released.  Tiles
  // of the block's range outside this warpgroup's (a prefix below a
  // window, a suffix past the causal diagonal) are waited for and
  // released unread.
  const uint32_t q_wg = q_s + 64 * wg * kRow;
  auto stage = [&](int t) { return kv_s + (t % kStages) * L::kStageBytes; };
  auto wait_full = [&](int t) {
    bar_wait(full + 8 * (t % kStages), (t / kStages) & 1);
  };
  auto release = [&](int t) { bar_arrive(empty + 8 * (t % kStages)); };
  // does any (row, key) of this warpgroup's tile t need the mask?
  auto edge = [&](int t) {
    const int k0 = (range.x + t) * BK;
    const int rel_lo = qw0 - (k0 + BK - 1) - kv_off;
    const int rel_hi = qw0 + 63 - k0 - kv_off;
    bool e = k0 + BK > p.S || (p.causal && rel_lo < 0);
    if (p.window > 0)
      e = e || rel_hi >= p.window || (!p.causal && rel_lo <= -p.window);
    return e;
  };

  bar_wait(q_bar, 0);
  int t = 0;
  for (; t < n_tiles && range.x + t < mine.x; ++t) {
    wait_full(t);
    release(t);
  }
  const int t_end = min(n_tiles, mine.y - range.x);
  if (t < t_end) {
    float s[BK / 2];
    uint32_t pa[BK / 16][4];  // P of the tile whose P·V is next
    float corr[2];
    wait_full(t);
    pin(s);
    wg_fence();
    ss_start<D, BK>(s, q_wg, L::kQRegion, stage(t), L::kKVRegion);
    wg_wait<0>();
    pin(s);
    softmax_tile<BK>(s, pa, m, l, corr, edge(t), qw0 + r0,
                     (range.x + t) * BK + c2, p, kv_off);
    int prev = t++;
    for (; t < t_end; ++t) {
      wait_full(t);
      pin(s);
      pin(o);
      wg_fence();
      ss_start<D, BK>(s, q_wg, L::kQRegion, stage(t), L::kKVRegion);
      rs_start<D, BK>(o, pa, stage(prev) + L::kTileBytes, L::kKVRegion);
      wg_wait<1>();  // Q·Kᵀ done; P·V may still run
      pin(s);
      uint32_t pn[BK / 16][4];
      softmax_tile<BK>(s, pn, m, l, corr, edge(t), qw0 + r0,
                       (range.x + t) * BK + c2, p, kv_off);
      wg_wait<0>();
      pin(o);
      release(prev);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e >> 1) & 1];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[j][r] = pn[j][r];
      }
      prev = t;
    }
    pin(o);
    wg_fence();
    rs_start<D, BK>(o, pa, stage(prev) + L::kTileBytes, L::kKVRegion);
    wg_wait<0>();
    pin(o);
    release(prev);
  }
  for (; t < n_tiles; ++t) {
    wait_full(t);
    release(t);
  }

  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float sum = quad_sum(l[hh]);
    const int q_pos = qw0 + r0 + 8 * hh;
    if (q_pos >= p.C) continue;
    const float inv = 1.f / (sum > 0.f ? sum : 1.f);
    __nv_bfloat16* row = og + q_pos * p.o_sc;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * i + c2) =
          __floats2bfloat162_rn(o[4 * i + 2 * hh] * inv,
                                o[4 * i + 2 * hh + 1] * inv);
    }
    if (p.lse != nullptr && (lane & 3) == 0) {
      p.lse[(long long)bh * p.C + q_pos] =
          sum > 0.f ? m[hh] * kLn2 + logf(sum) : kNegInf;
    }
  }
}

// One warpgroup, one tile product, for the card's unit tests: S = Q·Kᵀ
// (q 64 x D, k BK x D, out 64 x BK fp32) or O = P·V (p 64 x BK bf16, v
// BK x D, out 64 x D fp32), through the kernel's own loads, descriptors
// and products, the accumulator written out through its fragment layout.
template <int D, bool PV>
__global__ void __launch_bounds__(128, 1)
wgmma_tile_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  const __nv_bfloat16* pg, float* out) {
  using L = Cfg<D>;
  constexpr int BK = L::BK;
  constexpr int N = PV ? D : BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t a_s = base;                    // Q: R regions of 64 rows
  const uint32_t b_s = base + L::R * 64 * kRow;  // K or V: R regions
  const uint32_t bar = b_s + L::kTileBytes;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  if (threadIdx.x == 0) {
    bar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_expect_tx(bar, L::kTileBytes + (PV ? 0 : L::R * 64 * kRow));
    for (int r = 0; r < L::R; ++r) {
      if (!PV) tma_load(a_s + r * 64 * kRow, &ta, bar, 64 * r, 0, 0, 0);
      tma_load(b_s + r * L::kKVRegion, &tb, bar, 64 * r, 0, 0, 0);
    }
  }
  bar_wait(bar, 0);
  float d[N / 2];
  if constexpr (PV) {
    float s[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int row = r0 + 8 * ((e >> 1) & 1);
      s[e] = __bfloat162float(pg[row * BK + 8 * (e >> 2) + c2 + (e & 1)]);
    }
    uint32_t pa[BK / 16][4];
    to_a_fragments<BK>(s, pa);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) d[e] = 0.f;
    pin(d);
    wg_fence();
    rs_start<D, BK>(d, pa, b_s, L::kKVRegion);
  } else {
    pin(d);
    wg_fence();
    ss_start<D, BK>(d, a_s, 64 * kRow, b_s, L::kKVRegion);
  }
  wg_wait<0>();
  pin(d);
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const int row = r0 + 8 * ((e >> 1) & 1);
    out[row * N + 8 * (e >> 2) + c2 + (e & 1)] = d[e];
  }
}

// -- host side ---------------------------------------------------------------

template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const Params& p, int B,
                   cudaStream_t stream) {
  auto kern = flash_fwd_sm90_kernel<D>;
  static size_t allowed = 48 * 1024;
  const cudaError_t e = allow_smem(kern, Cfg<D>::kSmem, &allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * p.H, (p.C + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, Cfg<D>::kSmem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <int D, bool PV>
cudaError_t launch_tile(const void* a, const void* b, float* out,
                        cudaStream_t stream) {
  using L = Cfg<D>;
  CUtensorMap ta{}, tb{};
  if (!PV && !tensor_map(&ta, a, 1, 64, 1, D, 64LL * D, D, D, 64))
    return cudaErrorInvalidValue;
  if (!tensor_map(&tb, b, 1, L::BK, 1, D, (long long)L::BK * D, D, D, L::BK))
    return cudaErrorInvalidValue;
  auto kern = wgmma_tile_kernel<D, PV>;
  const size_t smem = L::R * 64 * kRow + L::kTileBytes + 8 + 1024;
  static size_t allowed = 48 * 1024;
  const cudaError_t e = allow_smem(kern, smem, &allowed);
  if (e != cudaSuccess) return e;
  kern<<<1, 128, smem, stream>>>(
      ta, tb, static_cast<const __nv_bfloat16*>(a), out);
  return cudaGetLastError();
}

}  // namespace

// q (B, C, H, D), k and v (B, S, Hkv, D), o (B, C, H, D): bf16 through
// their strides (last dim contiguous; base pointers and strides 16-byte
// aligned, as TMA requires); lse (B, H, C) fp32 or null; offs (B,) int32.
extern "C" int hvd_flash_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* offs, int B, int C, int H, int Hkv, int S, int D,
    long long q_sb, long long q_sc, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sc, long long o_sh,
    int window, int causal, float sm_scale, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || (D != 64 && D != 128) || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int bk = D == 64 ? Cfg<64>::BK : Cfg<128>::BK;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, C, H, D, q_sb, q_sc, q_sh, kBQ) ||
      !tensor_map(&tk, k, B, S, Hkv, D, k_sb, k_ss, k_sh, bk) ||
      !tensor_map(&tv, v, B, S, Hkv, D, v_sb, v_ss, v_sh, bk))
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<__nv_bfloat16*>(o), lse, offs, C, H, Hkv, S,
                 o_sb, o_sc, o_sh, window, causal, sm_scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = D == 64 ? launch<64>(tq, tk, tv, p, B, st)
                                : launch<128>(tq, tk, tv, p, B, st);
  return (int)e;
}

// One tile product on one warpgroup (the card's unit tests): pv = 0:
// out (64, BK) fp32 = a (64, D) · b (BK, D)ᵀ; pv = 1: out (64, D) fp32 =
// a (64, BK) · b (BK, D); bf16 inputs contiguous; BK = 128 at D = 64 and
// 64 at D = 128 (the kernel's tile).
extern "C" int hvd_wgmma_tile(const void* a, const void* b, float* out, int D,
                              int pv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (D == 64) e = pv ? launch_tile<64, true>(a, b, out, st)
                      : launch_tile<64, false>(a, b, out, st);
  if (D == 128) e = pv ? launch_tile<128, true>(a, b, out, st)
                       : launch_tile<128, false>(a, b, out, st);
  return (int)e;
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
