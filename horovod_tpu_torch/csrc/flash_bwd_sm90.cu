// Flash-attention backward for Hopper (sm_90a) on the tensor cores: dQ,
// and dK/dV, wgmma fed by TMA, bf16 in, fp32 accumulation, head_dim D in
// {64, 128}.
//
// Replaces horovod_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel for every bf16 launch with D in {64, 128}: the
// training path's backward.  fp32 launches and other head widths stay on
// the CUDA-core kernels in flash_bwd.cu; the wrapper picks by dtype and D
// (_bwd_variant).  Both kernels recompute the probabilities of each
// (query, key) tile from the forward's saved log-sum-exp (_recompute_p)
// and, with δ = rowsum(dO·O) from the caller,
//   dS = P ∘ (dO·Vᵀ − δ),
//   dQ = Σ_k dS·K · sm_scale                      (hvd_flash_bwd_dq_sm90)
//   dV = Σ Pᵀ·dO,  dK = Σ dSᵀ·Q · sm_scale, summed over the query-head
//   group that shares the kv head                 (hvd_flash_bwd_dkv_sm90)
//
// What bounds them on an H100: 6·D (dq) and 8·D (dkv) FLOPs per visible
// (head, query, key) triple against a few bytes per row, so arithmetic —
// and bf16 products reach the card's 989 TFLOP/s only through wgmma.  Two
// kernels, one writer per output, no atomics: the same bits every run.
// Each block has two consumer warpgroups of 64 rows (warps 0-7) and a
// producer warpgroup (warps 8-11) whose warp 8 does the loads (lane 0
// starts every TMA copy) and which hands its registers to the consumers
// (setmaxnreg: 24 a thread for it, 240 for them); the block's own 128
// rows of two tensors are loaded once, and 64-row tiles of the other two
// stream through a ring of kStages = 3 stages with "full" (TMA bytes
// landed) and "empty" (all 256 consumer threads done) barriers.
// Every product is one of the two forms of flash_sm90.cuh (ss_start: both
// operands K-major; rs_start: A from registers, B MN-major), 64 x 64
// scores and 64 x D gradients.
//   * dq: a block owns 128 query rows of one (batch, head), Q and dO; lse
//     and δ of a thread's two rows sit in registers.  K/V tiles of 64
//     keys of kb_range stream.  Per tile: S = Q·Kᵀ and dP = dO·Vᵀ (ss),
//     P = exp2(S·scale·log2e − lse·log2e) on the fragment, dS = P∘(dP − δ),
//     dQ += dS·K (rs: dS rounded to bf16, K the MN-major operand, as V is
//     in the forward's P·V).  Tile t's S and dP start while tile t−1's
//     dS·K is still on the tensor cores.  Causal launches walk the Q tiles
//     heaviest first.
//   * dkv: a block owns 128 keys of one (batch, kv head), K and V.  The
//     Q and dO tiles of 64 queries of _qb_range stream, each query tile
//     for every query head of the group in turn (so that a warpgroup's
//     own tiles are one run), with the tiles' lse (in log2 units) and δ,
//     which warp 8's 32 lanes read (bounded at S) and store beside the
//     tiles before they arrive on the stage's "full" barrier.  Per
//     tile: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (ss), Pᵀ and dSᵀ on the fragments,
//     dV += Pᵀ·dO and dK += dSᵀ·Q (rs, dO and Q the MN-major operands).
//     A tile's products retire before the next tile's start (the other
//     warpgroup fills the tensor cores meanwhile; overlapping them, as dq
//     does, made ptxas serialize the products for want of registers and
//     ran slower).  At D = 128 the dK and dV accumulators take 128
//     registers a thread, so dSᵀ is formed from Pᵀ's bf16 fragments and
//     dPᵀ is started only once Pᵀ's fp32 copy is no longer needed.  Under
//     causal masking key tile 0 sees every query tile, so the natural
//     block order is the heaviest first.
// Both take the JAX kernels' uniform kv_offset (kv_off: the global
// position of the first key minus that of the first query; 0 for
// self-attention, (src − idx)·S for ring attention's off-diagonal blocks):
// the mask, the edge test and both loop bounds act on global positions
// (the causal lower bound of dkv is a floor division of the shifted
// diagonal), and rows or keys that see nothing come out as zeros.  The
// offset's presence is a template flag (kOffset): offset 0 compiles to the
// self-attention kernels with the offset folded away (on an H100, dq at
// gpt_small's shape ran 8 % slower reading a runtime offset of 0).
// P is zeroed explicitly where the mask hides an entry (causal, window,
// q ≥ S, k ≥ S), evaluated only on tiles that cross one of those edges:
// TMA's zero fill past S makes Q = dO = 0 there, which would leave
// P = exp(−lse) ≠ 0.  A consumer warpgroup arrives on a stage's "empty"
// barrier only after wgmma.wait_group has retired every product that
// reads the stage; tiles outside its own rows' range (a window's prefix,
// the causal suffix) it waits for and releases unread.  Every wgmma wait
// and accumulator access is on a path all threads take: ptxas serializes
// the products of a kernel that touches an accumulator under a branch.
// Not done here: ping-pong between the warpgroups, clusters, persistent
// blocks.
//
// Numerics: as the JAX kernels, except that P and dS are rounded to bf16
// before their products (about 2^-9 of each term; inside the bf16
// tolerances; the dkv kernel at D = 128 forms dS from the rounded P), the
// scale is folded into exp2's argument (q is not pre-scaled), and the
// exponentials are exp2 of log2(e)-scaled scores.

#include "flash_sm90.cuh"

namespace {

using namespace hvd_flash;

constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kOwn = 64 * kConsumers;             // rows a block owns
constexpr int kTile = 64;                         // rows of a streamed tile
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kStages = 3;
// registers a thread after setmaxnreg: the producer warpgroup gives up
// what the consumers take (launched at 168 = 65536 / 384, rounded down)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct Cfg {
  static constexpr int R = D / 64;  // 64-column regions
  static constexpr int kOwnRegion = kOwn * kRow;
  static constexpr int kOwnBytes = R * kOwnRegion;  // one owned tensor
  static constexpr int kTileRegion = kTile * kRow;
  static constexpr int kTileBytes = R * kTileRegion;  // one streamed tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  // the streamed tiles' lse and δ (dkv), one (lse, δ) pair of rows a stage
  static constexpr int kStatOffset = 2 * kOwnBytes + kStages * kStageBytes;
  static constexpr int kStatFloats = 2 * kTile;
  static constexpr int kBarOffset = kStatOffset + kStages * kStatFloats * 4;
  // + 1024 to align the base for the 128-byte swizzle
  static constexpr int kSmem = kBarOffset + 8 * (2 * kStages + 1) + 1024;
};

struct Params {
  __nv_bfloat16* o0;   // dQ (dq) or dK (dkv)
  __nv_bfloat16* o1;   // dV (dkv)
  const float* lse;    // (B, H, S) fp32
  const float* delta;  // (B, H, S) fp32
  int H, Hkv, S;
  long long o0_sb, o0_ss, o0_sh, o1_sb, o1_ss, o1_sh;
  int window;  // <= 0: none
  int causal;
  int kv_off;  // global K start minus global Q start
  float sm_scale;
  float scale_log2;  // sm_scale * log2(e)
};

// does any (query, key) pair of the 64-query x 64-key tile at (q0, k0)
// need the mask: the (shifted) causal diagonal, the window's edge, or S?
__device__ __forceinline__ bool tile_edge(int q0, int k0, int kv_off,
                                          const Params& p) {
  const int rel_lo = q0 - (k0 + 63) - kv_off;
  const int rel_hi = q0 + 63 - k0 - kv_off;
  bool e = q0 + 64 > p.S || k0 + 64 > p.S || (p.causal && rel_lo < 0);
  if (p.window > 0)
    e = e || rel_hi >= p.window || (!p.causal && rel_lo <= -p.window);
  return e;
}

__device__ __forceinline__ bool kept(int q, int k, int kv_off,
                                     const Params& p) {
  return q < p.S && visible(q, k, p.S, kv_off, p.causal, p.window);
}

__device__ __forceinline__ void init_barriers(uint32_t full, uint32_t empty,
                                              uint32_t own_bar,
                                              int full_count) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      bar_init(full + 8 * st, full_count);
      bar_init(empty + 8 * st, kConsumerThreads);
    }
    bar_init(own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// the block's own 128 rows of two tensors, once (lane 0 of the producer)
template <int D>
__device__ __forceinline__ void load_own(uint32_t dst, uint32_t bar,
                                         const CUtensorMap* m0,
                                         const CUtensorMap* m1, int row,
                                         int head, int b) {
  using L = Cfg<D>;
  bar_expect_tx(bar, 2 * L::kOwnBytes);
  for (int r = 0; r < L::R; ++r) {
    tma_load(dst + r * L::kOwnRegion, m0, bar, 64 * r, row, head, b);
    tma_load(dst + L::kOwnBytes + r * L::kOwnRegion, m1, bar, 64 * r, row,
             head, b);
  }
}

// one streamed stage: 64 rows of two tensors (lane 0 of the producer)
template <int D>
__device__ __forceinline__ void load_stage(uint32_t dst, uint32_t bar,
                                           const CUtensorMap* m0,
                                           const CUtensorMap* m1, int row,
                                           int head, int b) {
  using L = Cfg<D>;
  bar_expect_tx(bar, L::kStageBytes);
  for (int r = 0; r < L::R; ++r) {
    tma_load(dst + r * L::kTileRegion, m0, bar, 64 * r, row, head, b);
    tma_load(dst + L::kTileBytes + r * L::kTileRegion, m1, bar, 64 * r, row,
             head, b);
  }
}

// the 64 x D fp32 accumulator's rows r0 (hh = 0) and r0 + 8 (hh = 1),
// times `scale`, as bf16 through `row_of(hh)` (null: row not written)
template <int D, typename RowOf>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float scale, int c2,
                                           RowOf row_of) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    __nv_bfloat16* row = row_of(hh);
    if (row == nullptr) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * i + c2) =
          __floats2bfloat162_rn(acc[4 * i + 2 * hh] * scale,
                                acc[4 * i + 2 * hh + 1] * scale);
    }
  }
}

// this thread's warp, broadcast from lane 0 so that the compiler knows it
// is uniform across the warp: the role branches and setmaxnreg's regions
// then split by warpgroup (with threadIdx.x >> 5 ptxas keeps one register
// budget for the whole kernel)
__device__ __forceinline__ int uniform_warp() {
  return __shfl_sync(kFull, static_cast<int>(threadIdx.x >> 5), 0);
}

// a warpgroup's registers a thread, lowered (the producer) or raised (the
// consumers) after the launch's even split
template <int N>
__device__ __forceinline__ void lower_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void raise_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// the [lo, hi) tiles of a block's n_tiles that a warpgroup computes (its
// own rows' range; the others it waits for and releases unread)
__device__ __forceinline__ int2 own_tiles(int lo, int hi, int n_tiles) {
  lo = min(max(lo, 0), n_tiles);
  return make_int2(lo, min(max(hi, lo), n_tiles));
}

// -- dQ ----------------------------------------------------------------------

template <int D, bool kOffset>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const Params p) {
  using L = Cfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;                   // Q, then dO
  const uint32_t do_s = base + L::kOwnBytes;
  const uint32_t kv_s = base + 2 * L::kOwnBytes;  // stage st: K, then V
  const uint32_t full = base + L::kBarOffset;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t own_bar = empty + 8 * kStages;

  const int kv_off = kOffset ? p.kv_off : 0;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int n_qt = (p.S + kOwn - 1) / kOwn;
  const int q0 = (p.causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) *
                 kOwn;  // causal: the heaviest Q tiles first
  const int n_kb = (p.S + kTile - 1) / kTile;
  const int2 range =
      kb_range(q0, kOwn, kTile, n_kb, p.causal, p.window, kv_off);
  const int n_tiles = max(0, range.y - range.x);
  const int warp = uniform_warp();
  const int lane = threadIdx.x & 31;

  init_barriers(full, empty, own_bar, 1);

  if (warp >= 4 * kConsumers) {  // warps 8-11: the producer warpgroup
    lower_regs<kProducerRegs>();
    if (warp == 4 * kConsumers && lane == 0) {
      load_own<D>(q_s, own_bar, &tq, &tdo, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        // round t / kStages reuses the stage: wait for the consumers'
        // release of the previous round
        if (t >= kStages) bar_wait(empty + 8 * st, (t / kStages - 1) & 1);
        load_stage<D>(kv_s + st * L::kStageBytes, full + 8 * st, &tk, &tv,
                      (range.x + t) * kTile, hk, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns block rows 64wg .. 64wg+63
  raise_regs<kConsumerRegs>();
  const int wg = warp >> 2;
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // row in the warpgroup
  const int c2 = 2 * (lane & 3);                 // first column, per 8
  const int qw0 = q0 + 64 * wg;
  const int2 kr =
      kb_range(qw0, 64, kTile, n_kb, p.causal, p.window, kv_off);
  const int2 mine = own_tiles(kr.x - range.x, kr.y - range.x, n_tiles);
  float lse2[2], dlt[2];  // this thread's rows: lse·log2(e), δ
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int q = qw0 + r0 + 8 * hh;
    const long long at = (long long)bh * p.S + q;
    lse2[hh] = q < p.S ? p.lse[at] * kLog2e : 0.f;
    dlt[hh] = q < p.S ? p.delta[at] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  const uint32_t q_wg = q_s + 64 * wg * kRow;
  const uint32_t do_wg = do_s + 64 * wg * kRow;
  auto stage = [&](int t) { return kv_s + (t % kStages) * L::kStageBytes; };
  auto wait_full = [&](int t) {
    bar_wait(full + 8 * (t % kStages), (t / kStages) & 1);
  };
  auto release = [&](int t) { bar_arrive(empty + 8 * (t % kStages)); };

  // Tile t's S and dP are started while tile t-1's dS·K still runs; the
  // waits and the accumulators' pins sit on paths every thread takes (a
  // wait or an accumulator access under a branch makes ptxas serialize
  // the products), only barrier arrivals are conditional
  bar_wait(own_bar, 0);
  for (int t = 0; t < mine.x; ++t) {
    wait_full(t);
    release(t);
  }
  for (int t = mine.x; t < mine.y; ++t) {
    const int kb = range.x + t;
    wait_full(t);
    float s[kTile / 2], dp[kTile / 2];
    pin(s);
    pin(dp);
    wg_fence();
    ss_start<D, kTile>(s, q_wg, L::kOwnRegion, stage(t), L::kTileRegion);
    ss_start<D, kTile>(dp, do_wg, L::kOwnRegion, stage(t) + L::kTileBytes,
                       L::kTileRegion);
    wg_wait<2>();  // tile t-1's dS·K done; S and dP may still run
    pin(dq);
    if (t > mine.x) release(t - 1);
    wg_wait<1>();  // S done
    pin(s);
    const bool edge = tile_edge(qw0, kb * kTile, kv_off, p);
#pragma unroll
    for (int e = 0; e < kTile / 2; ++e) {
      const int hh = (e >> 1) & 1;
      float pr = ex2(fmaf(s[e], p.scale_log2, -lse2[hh]));
      if (edge && !kept(qw0 + r0 + 8 * hh,
                        kb * kTile + 8 * (e >> 2) + c2 + (e & 1), kv_off, p))
        pr = 0.f;
      s[e] = pr;
    }
    wg_wait<0>();  // dP done
    pin(dp);
#pragma unroll
    for (int e = 0; e < kTile / 2; ++e)
      dp[e] = s[e] * (dp[e] - dlt[(e >> 1) & 1]);
    uint32_t ds[kTile / 16][4];
    to_a_fragments<kTile>(dp, ds);
    pin(dq);
    wg_fence();
    rs_start<D, kTile>(dq, ds, stage(t), L::kTileRegion);  // dQ += dS·K
  }
  wg_wait<0>();
  pin(dq);
  if (mine.y > mine.x) release(mine.y - 1);
  for (int t = mine.y; t < n_tiles; ++t) {
    wait_full(t);
    release(t);
  }

  __nv_bfloat16* og = p.o0 + b * p.o0_sb + h * p.o0_sh;
  store_rows<D>(dq, p.sm_scale, c2, [&](int hh) -> __nv_bfloat16* {
    const int q = qw0 + r0 + 8 * hh;
    return q < p.S ? og + q * p.o0_ss : nullptr;
  });
}

// -- dK, dV ------------------------------------------------------------------

template <int D, bool kOffset>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const Params p) {
  using L = Cfg<D>;
  // D = 128: the dK and dV accumulators take 128 registers a thread, so
  // dSᵀ is formed from Pᵀ's bf16 fragments and Pᵀ's fp32 copy dies before
  // dPᵀ lands
  constexpr bool kLight = D == 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = base;                   // K, then V
  const uint32_t v_s = base + L::kOwnBytes;
  const uint32_t qd_s = base + 2 * L::kOwnBytes;  // stage st: Q, then dO
  float* stats = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::kStatOffset);
  const uint32_t full = base + L::kBarOffset;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t own_bar = empty + 8 * kStages;

  const int kv_off = kOffset ? p.kv_off : 0;
  const int bkv = blockIdx.x;
  const int b = bkv / p.Hkv;
  const int hk = bkv - b * p.Hkv;
  const int group = p.H / p.Hkv;
  const int k0 = blockIdx.y * kOwn;  // causal: key tile 0 is the heaviest
  const int n_qt = (p.S + kTile - 1) / kTile;
  // _qb_range: kb_range with q and k swapped and the offset negated, the
  // causal lower bound (the first query tile at or after the shifted
  // diagonal, a floor division: the offset may be negative) joined by max
  int2 range = kb_range(k0, kOwn, kTile, n_qt, 0, p.window, -kv_off);
  if (p.causal) range.x = max(range.x, max(0, floor_div(k0 + kv_off, kTile)));
  const int per_head = max(0, range.y - range.x);
  const int n_tiles = group * per_head;
  const int warp = uniform_warp();
  const int lane = threadIdx.x & 31;

  // a stage's "full" barrier: the producer warp's 32 lanes, lane 0's
  // arrival carrying the TMA bytes
  init_barriers(full, empty, own_bar, 32);

  // tile t: query tile range.x + t / group of query head hk·group +
  // t % group (the group's heads inner, so that a warpgroup's own tiles
  // are one run)
  if (warp >= 4 * kConsumers) {  // warps 8-11: the producer warpgroup
    lower_regs<kProducerRegs>();
    if (warp != 4 * kConsumers) return;
    if (lane == 0) load_own<D>(k_s, own_bar, &tk, &tv, k0, hk, b);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      if (t >= kStages) bar_wait(empty + 8 * st, (t / kStages - 1) & 1);
      const int h = hk * group + t % group;
      const int q0 = (range.x + t / group) * kTile;
      const long long at = ((long long)b * p.H + h) * p.S;
      float* sl = stats + st * L::kStatFloats;
      for (int i = lane; i < kTile; i += 32) {
        const int q = q0 + i;
        sl[i] = q < p.S ? p.lse[at + q] * kLog2e : 0.f;
        sl[kTile + i] = q < p.S ? p.delta[at + q] : 0.f;
      }
      if (lane == 0) {
        load_stage<D>(qd_s + st * L::kStageBytes, full + 8 * st, &tq, &tdo,
                      q0, h, b);
      } else {
        bar_arrive(full + 8 * st);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns block keys 64wg .. 64wg+63
  raise_regs<kConsumerRegs>();
  const int wg = warp >> 2;
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // key row in the warpgroup
  const int c2 = 2 * (lane & 3);                 // first query column, per 8
  const int kw0 = k0 + 64 * wg;
  int2 qr = kb_range(kw0, 64, kTile, n_qt, 0, p.window, -kv_off);
  if (p.causal) qr.x = max(qr.x, max(0, floor_div(kw0 + kv_off, kTile)));
  const int2 mine = own_tiles((qr.x - range.x) * group,
                              (qr.y - range.x) * group, n_tiles);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  const uint32_t k_wg = k_s + 64 * wg * kRow;
  const uint32_t v_wg = v_s + 64 * wg * kRow;
  auto stage = [&](int t) { return qd_s + (t % kStages) * L::kStageBytes; };
  auto wait_full = [&](int t) {
    bar_wait(full + 8 * (t % kStages), (t / kStages) & 1);
  };
  auto release = [&](int t) { bar_arrive(empty + 8 * (t % kStages)); };

  // as in dq: waits and pins on paths every thread takes
  bar_wait(own_bar, 0);
  for (int t = 0; t < mine.x; ++t) {
    wait_full(t);
    release(t);
  }
  for (int t = mine.x; t < mine.y; ++t) {
    const int q0 = (range.x + t / group) * kTile;
    wait_full(t);
    const uint32_t qs = stage(t);
    const uint32_t dos = qs + L::kTileBytes;
    const float* sl = stats + (t % kStages) * L::kStatFloats;
    const bool edge = tile_edge(q0, kw0, kv_off, p);
    float s[kTile / 2], dp[kTile / 2];
    uint32_t pa[kTile / 16][4], da[kTile / 16][4];
    pin(s);
    pin(dp);
    wg_fence();
    ss_start<D, kTile>(s, k_wg, L::kOwnRegion, qs, L::kTileRegion);
    if constexpr (!kLight)
      ss_start<D, kTile>(dp, v_wg, L::kOwnRegion, dos, L::kTileRegion);
    wg_wait<kLight ? 0 : 1>();  // Sᵀ done
    pin(s);
    // column block i holds queries q0 + 8i + c2 + {0, 1}
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * i + c2);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int e = 4 * i + x;
        float pr = ex2(fmaf(s[e], p.scale_log2, -((x & 1) ? l2.y : l2.x)));
        if (edge && !kept(q0 + 8 * i + c2 + (x & 1),
                          kw0 + r0 + 8 * (x >> 1), kv_off, p))
          pr = 0.f;
        s[e] = pr;
      }
    }
    to_a_fragments<kTile>(s, pa);
    if constexpr (kLight) {
      // Pᵀ as rounded to bf16 from here on (a bf16 is a float's top half)
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[8 * j + 2 * r] = __uint_as_float(pa[j][r] << 16);
          s[8 * j + 2 * r + 1] = __uint_as_float(pa[j][r] & 0xffff0000u);
        }
      }
      pin(dp);
      wg_fence();
      ss_start<D, kTile>(dp, v_wg, L::kOwnRegion, dos, L::kTileRegion);
    }
    wg_wait<0>();  // dPᵀ done
    pin(dp);
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(sl + kTile + 8 * i + c2);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int e = 4 * i + x;
        dp[e] = s[e] * (dp[e] - ((x & 1) ? d2.y : d2.x));
      }
    }
    to_a_fragments<kTile>(dp, da);
    pin(dk);
    pin(dv);
    wg_fence();
    rs_start<D, kTile>(dv, pa, dos, L::kTileRegion);  // dV += Pᵀ·dO
    rs_start<D, kTile>(dk, da, qs, L::kTileRegion);   // dK += dSᵀ·Q
    wg_wait<0>();
    pin(dk);
    pin(dv);
    release(t);
  }
  for (int t = mine.y; t < n_tiles; ++t) {
    wait_full(t);
    release(t);
  }

  __nv_bfloat16* dkg = p.o0 + b * p.o0_sb + hk * p.o0_sh;
  __nv_bfloat16* dvg = p.o1 + b * p.o1_sb + hk * p.o1_sh;
  store_rows<D>(dk, p.sm_scale, c2, [&](int hh) -> __nv_bfloat16* {
    const int k = kw0 + r0 + 8 * hh;
    return k < p.S ? dkg + k * p.o0_ss : nullptr;
  });
  store_rows<D>(dv, 1.f, c2, [&](int hh) -> __nv_bfloat16* {
    const int k = kw0 + r0 + 8 * hh;
    return k < p.S ? dvg + k * p.o1_ss : nullptr;
  });
}

// One warpgroup, one tile product of the two forms the kernels run, for
// the card's unit tests: ss: out (64 x 64) = a (64 x D) · b (64 x D)ᵀ
// (S, dP, Sᵀ, dPᵀ); rs: out (64 x D) = a (64 x 64, rounded to bf16 in
// registers) · b (64 x D), b MN-major (dS·K, Pᵀ·dO, dSᵀ·Q) — through the
// kernels' own loads, descriptors and products, the accumulator written
// out through its fragment layout.
template <int D, bool RS>
__global__ void __launch_bounds__(128, 1)
wgmma_bwd_tile_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      const __nv_bfloat16* ag, float* out) {
  using L = Cfg<D>;
  constexpr int N = RS ? D : kTile;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t a_s = base;                 // R regions of 64 rows
  const uint32_t b_s = base + L::kTileBytes;  // R regions of 64 rows
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
    bar_expect_tx(bar, (RS ? 1 : 2) * L::kTileBytes);
    for (int r = 0; r < L::R; ++r) {
      if (!RS) tma_load(a_s + r * L::kTileRegion, &ta, bar, 64 * r, 0, 0, 0);
      tma_load(b_s + r * L::kTileRegion, &tb, bar, 64 * r, 0, 0, 0);
    }
  }
  bar_wait(bar, 0);
  float d[N / 2];
  if constexpr (RS) {
    float s[kTile / 2];
#pragma unroll
    for (int e = 0; e < kTile / 2; ++e) {
      const int row = r0 + 8 * ((e >> 1) & 1);
      s[e] = __bfloat162float(ag[row * kTile + 8 * (e >> 2) + c2 + (e & 1)]);
    }
    uint32_t pa[kTile / 16][4];
    to_a_fragments<kTile>(s, pa);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) d[e] = 0.f;
    pin(d);
    wg_fence();
    rs_start<D, kTile>(d, pa, b_s, L::kTileRegion);
  } else {
    pin(d);
    wg_fence();
    ss_start<D, kTile>(d, a_s, L::kTileRegion, b_s, L::kTileRegion);
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

template <typename Kernel>
cudaError_t run(Kernel kern, size_t smem, size_t* allowed, dim3 grid,
                int threads, cudaStream_t stream, const CUtensorMap& m0,
                const CUtensorMap& m1, const CUtensorMap& m2,
                const CUtensorMap& m3, const Params& p) {
  const cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, stream>>>(m0, m1, m2, m3, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dkv, const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const CUtensorMap& tdo,
                   const Params& p, int B, cudaStream_t stream) {
  // one shared-memory allowance per kernel: [dkv][kOffset]
  static size_t allowed[2][2] = {{48 * 1024, 48 * 1024},
                                 {48 * 1024, 48 * 1024}};
  const int blocks = (p.S + kOwn - 1) / kOwn;
  const int off = p.kv_off != 0;
  const dim3 dkv_grid(B * p.Hkv, blocks), dq_grid(B * p.H, blocks);
  if (dkv)
    return off ? run(flash_bwd_dkv_sm90_kernel<D, true>, Cfg<D>::kSmem,
                     &allowed[1][1], dkv_grid, kThreads, stream, tq, tk, tv,
                     tdo, p)
               : run(flash_bwd_dkv_sm90_kernel<D, false>, Cfg<D>::kSmem,
                     &allowed[1][0], dkv_grid, kThreads, stream, tq, tk, tv,
                     tdo, p);
  return off ? run(flash_bwd_dq_sm90_kernel<D, true>, Cfg<D>::kSmem,
                   &allowed[0][1], dq_grid, kThreads, stream, tq, tk, tv, tdo,
                   p)
             : run(flash_bwd_dq_sm90_kernel<D, false>, Cfg<D>::kSmem,
                   &allowed[0][0], dq_grid, kThreads, stream, tq, tk, tv, tdo,
                   p);
}

// strides: q, k, v, dO, then the outputs, each (b, s, h) in elements
int entry(int dkv, const void* q, const void* k, const void* v,
          const void* dout, const float* lse, const float* delta, void* o0,
          void* o1, int B, int S, int H, int Hkv, int D,
          const long long* st, int causal, int window, int kv_off,
          float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  // the owned tensors are boxes of 128 rows, the streamed ones of 64
  const int q_rows = dkv ? kTile : kOwn;
  const int kv_rows = dkv ? kOwn : kTile;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, q, B, S, H, D, st[0], st[1], st[2], q_rows) ||
      !tensor_map(&tk, k, B, S, Hkv, D, st[3], st[4], st[5], kv_rows) ||
      !tensor_map(&tv, v, B, S, Hkv, D, st[6], st[7], st[8], kv_rows) ||
      !tensor_map(&tdo, dout, B, S, H, D, st[9], st[10], st[11], q_rows))
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<__nv_bfloat16*>(o0),
                 static_cast<__nv_bfloat16*>(o1), lse, delta, H, Hkv, S,
                 st[12], st[13], st[14],
                 dkv ? st[15] : 0, dkv ? st[16] : 0, dkv ? st[17] : 0,
                 window, causal, kv_off, sm_scale, sm_scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? launch<64>(dkv, tq, tk, tv, tdo, p, B, s)
                       : launch<128>(dkv, tq, tk, tv, tdo, p, B, s));
}

template <int D, bool RS>
cudaError_t launch_tile(const void* a, const void* b, float* out,
                        cudaStream_t stream) {
  using L = Cfg<D>;
  CUtensorMap ta{}, tb{};
  if (!RS && !tensor_map(&ta, a, 1, kTile, 1, D, (long long)kTile * D, D, D,
                         kTile))
    return cudaErrorInvalidValue;
  if (!tensor_map(&tb, b, 1, kTile, 1, D, (long long)kTile * D, D, D, kTile))
    return cudaErrorInvalidValue;
  auto kern = wgmma_bwd_tile_kernel<D, RS>;
  const size_t smem = 2 * L::kTileBytes + 8 + 1024;
  static size_t allowed = 48 * 1024;
  const cudaError_t e = allow_smem(kern, smem, &allowed);
  if (e != cudaSuccess) return e;
  kern<<<1, 128, smem, stream>>>(ta, tb, static_cast<const __nv_bfloat16*>(a),
                                 out);
  return cudaGetLastError();
}

}  // namespace

// q, dO (B, S, H, D); k, v (B, S, Hkv, D); the outputs in the shapes of q
// (dQ) and k (dK, dV): bf16 through their strides (last dim contiguous;
// base pointers and strides 16-byte aligned, as TMA requires).  lse and
// delta are (B, H, S) fp32 contiguous.  strides: q, k, v, dO, dq:
// 5 x (b, s, h) elements; for dkv: q, k, v, dO, dk, dv: 6 x (b, s, h).
// kv_off: global K start minus global Q start.
extern "C" int hvd_flash_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int B, int S, int H,
    int Hkv, int D, const long long* strides, int causal, int window,
    int kv_off, float sm_scale, void* stream) {
  return entry(0, q, k, v, dout, lse, delta, dq, nullptr, B, S, H, Hkv, D,
               strides, causal, window, kv_off, sm_scale, stream);
}

extern "C" int hvd_flash_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int S,
    int H, int Hkv, int D, const long long* strides, int causal, int window,
    int kv_off, float sm_scale, void* stream) {
  return entry(1, q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv, D,
               strides, causal, window, kv_off, sm_scale, stream);
}

// One tile product on one warpgroup (the card's unit tests): rs = 0:
// out (64, 64) fp32 = a (64, D) · b (64, D)ᵀ; rs = 1: out (64, D) fp32 =
// a (64, 64) · b (64, D); bf16 inputs contiguous, D in {64, 128}.
extern "C" int hvd_wgmma_bwd_tile(const void* a, const void* b, float* out,
                                  int D, int rs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (D == 64) e = rs ? launch_tile<64, true>(a, b, out, st)
                      : launch_tile<64, false>(a, b, out, st);
  if (D == 128) e = rs ? launch_tile<128, true>(a, b, out, st)
                       : launch_tile<128, false>(a, b, out, st);
  return (int)e;
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
