// Paged decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces horovod_tpu/ops/flash_attention.py::_fwd_kernel in its decode
// launch (flash_decode_attention -> flash_chunk_attention): one query row
// per sequence at global position kv_lens[b] - 1, online-softmax attention
// over keys max(0, kv_lens[b] - window) .. kv_lens[b] - 1 (the _tile_mask
// of a causal row on global positions), query head h reading kv head
// h / (H / H_kv), q * sm_scale in fp32, statistics and sums in fp32, rows
// with kv_lens <= 0 (pad slots) written as exact zeros.  The one change
// from the TPU kernel is where K/V come from: the JAX package gathers each
// sequence's pages contiguous first (a Pallas BlockSpec needs a contiguous
// operand); this kernel reads the same bytes where they lie in one layer of
// the paged pools, (num_blocks, block_size, H_kv, D), through the block
// table, tables[b, pos / block_size].  Keys past n_cols * block_size (the
// step's page bound) are not read, as the bounded gather never copied them.
//
// What bounds it on an H100: a decode step reads every live K/V byte once
// and does 4 * (H / H_kv) FLOPs per K/V element (Q·Kᵀ and P·V for each
// query row of the group): at 4 rows that is ~8 FLOP per bf16 byte, far
// under the ~20 at which the CUDA cores' fp32 rate would take over from
// the 3.35 TB/s of HBM.  So the design is about bytes and parallelism:
//   * one block owns a whole GQA group (up to 8 query rows; wider groups
//     take ceil(group / 8) blocks), so each K/V byte leaves HBM once;
//   * the live key range of a row is cut into NSPLIT runs of `pps` table
//     columns (chosen on the host from the step's page bound, so that
//     B * H_kv * NSPLIT blocks fill the 132 SMs several times over; the
//     host never reads the device's lengths), one block each, so a long
//     row is read by many SMs at once.  A split past its row's live range
//     writes l = 0 and returns;
//   * the split's page ids are read into shared memory once; pages are
//     streamed with 16-byte cp.async copies through a 2-stage ring of
//     64-key tiles (32 keys for 512-byte rows, 16 for 1 KB rows), so the
//     copy of the next tile overlaps the math of this one (a third stage
//     ran slower: it costs the SM a resident block);
//   * 256 threads; the products run on the CUDA cores in fp32: Q·Kᵀ with
//     PARTS threads per key, each over a slice of D (the key's scores for
//     all rows of the group), P·V with one thread per (16-byte column
//     vector, key subset), each holding its rows' sums in registers;
//   * the splits' (m, l, acc) go to fp32 scratch and a second kernel
//     merges them in split order: no atomics, the same bits every call.
//
// Row strides in shared memory are padded so that a row is an odd number
// of 16-byte words: eight threads reading eight consecutive keys' rows at
// one column then touch eight different bank groups.

#include "flash_common.cuh"

namespace {

using namespace hvd_flash;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
// query rows a block holds at most (a wider GQA group takes more blocks)
constexpr int kMaxRows = 8;

struct Params {
  const void* q;      // (B, 1, H, D)
  const void* k;      // one layer's pool: (num_blocks, bs, H_kv, D)
  const void* v;
  void* o;            // (B, 1, H, D)
  float* part_acc;    // (B * H * nsplit, D) fp32 split sums (nsplit > 1)
  float* part_ml;     // (B * H * nsplit, 2) fp32 split (m, l)
  const long long* tables;  // (B, >= n_cols) page ids
  const int* kv_lens;       // (B,)
  int B, H, Hkv, D, bs, n_cols, num_blocks, window, nsplit, pps;
  long long q_sb, q_sh, k_sn, k_st, k_sh, v_sn, v_st, v_sh, o_sb, o_sh, t_sb;
  float sm_scale;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes (a tile's tail past the split)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The [k0, k1) key positions split `s` of a row reads (k0 == k1: none).
// The row's live keys are [lo, hi): lo = kv_len - window (window > 0),
// hi = kv_len capped at the page bound; split s owns table columns
// lo / bs + s * pps .. + pps - 1 (ops/flash_attention.py::_decode_split_
// keys is the same rule, tested on the CPU).
__device__ __forceinline__ int2 split_keys(int kv_len, int window, int bs,
                                           int n_cols, int pps, int s) {
  const int hi = min(kv_len, n_cols * bs);
  const int lo = window > 0 ? max(0, kv_len - window) : 0;
  if (lo >= hi) return make_int2(0, 0);
  const int p0 = lo / bs + s * pps;
  const int k0 = max(lo, p0 * bs);
  const int k1 = min(hi, (p0 + pps) * bs);
  return k0 < k1 ? make_int2(k0, k1) : make_int2(0, 0);
}

// shared-memory row stride (elements) of a K/V tile: an odd number of
// 16-byte words
template <typename T>
__host__ __device__ __forceinline__ int tile_stride(int D) {
  constexpr int VEC = Vec<T>::N;
  return D + (((D * (int)sizeof(T) / 16) & 1) ? 2 * VEC : VEC);
}

// 4-byte words ahead of the K/V tiles: q (RB x D), the Q·Kᵀ partials
// (kThreads / BT slices x RB x BT), P (BT x RB), corr, m, l and a pad,
// then the split's page ids (pps, rounded up to 16 bytes)
template <int RB, int BT>
__host__ __device__ __forceinline__ int head_words(int D, int pps) {
  return RB * D + (kThreads / BT) * RB * BT + BT * RB + 4 * RB +
         (pps + 3) / 4 * 4;
}

// RB: query rows per block (1, 2, 4 or 8); BT: keys per tile.
template <typename T, int RB, int BT>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Params p) {
  constexpr int VEC = Vec<T>::N;
  constexpr int PARTS = kThreads / BT;  // threads sharing one key's Q·Kᵀ
  constexpr int NU = (BT + 31) / 32;    // keys per lane in the softmax
  constexpr int NJ = (RB + kWarps - 1) / kWarps;  // rows per softmax warp
  const int D = p.D;
  const int ndv = D / VEC;         // 16-byte vectors in a row
  const int nkg = kThreads / ndv;  // key subsets of the P·V phase
  const int ks = tile_stride<T>(D);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // RB x D, scaled
  float* s_part = q_s + RB * D;                     // PARTS x RB x BT
  float* p_s = s_part + PARTS * RB * BT;            // BT x RB
  float* corr_s = p_s + BT * RB;                    // RB
  float* ml_s = corr_s + RB;                        // m: RB, l: RB
  int* pages_s = reinterpret_cast<int*>(ml_s + 3 * RB);  // pps
  T* kv_s = reinterpret_cast<T*>(q_s + head_words<RB, BT>(D, p.pps));
  float* red = reinterpret_cast<float*>(kv_s);  // after the loop: nkg x RB x D

  const int g = p.H / p.Hkv;
  const int nsg = (g + RB - 1) / RB;
  int x = blockIdx.x;
  const int sg = x % nsg;
  x /= nsg;
  const int hk = x % p.Hkv;
  const int b = x / p.Hkv;
  const int split = blockIdx.y;
  const int h0 = hk * g + sg * RB;
  const int rows = min(RB, g - sg * RB);
  const int tid = threadIdx.x;
  const int2 kr = split_keys(p.kv_lens[b], p.window, p.bs, p.n_cols, p.pps,
                             split);

  if (kr.x >= kr.y) {  // nothing to read: l = 0, or zeros if unsplit
    if (p.nsplit == 1) {
      T* og = static_cast<T*>(p.o) + b * p.o_sb;
      for (int idx = tid; idx < rows * D; idx += kThreads) {
        const int r = idx / D;
        store(og + (h0 + r) * p.o_sh + (idx - r * D), 0.f);
      }
    } else if (tid < rows) {
      float* ml = p.part_ml +
                  ((long long)(b * p.H + h0 + tid) * p.nsplit + split) * 2;
      ml[0] = kNegInf;
      ml[1] = 0.f;
    }
    return;
  }

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb;
  for (int idx = tid; idx < RB * ndv; idx += kThreads) {
    const int r = idx / ndv;
    const int c = idx - r * ndv;
    float tmp[VEC];
    if (r < rows) {
      load_vec(qg + (h0 + r) * p.q_sh + c * VEC, tmp);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) tmp[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) q_s[r * D + c * VEC + i] = tmp[i] * p.sm_scale;
  }

  const T* kg = static_cast<const T*>(p.k) + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + hk * p.v_sh;
  // the split's page ids, read once: a tile's copies then wait on no
  // global load for their addresses
  const long long* tbl = p.tables + b * p.t_sb;
  const int col0 = kr.x / p.bs;
  for (int i = col0 + tid; i <= (kr.y - 1) / p.bs; i += kThreads) {
    const long long page = tbl[i];
    if (page < 0 || page >= p.num_blocks) __trap();  // corrupt table
    pages_s[i - col0] = (int)page;
  }
  __syncthreads();  // q_s and pages_s written
  const int n_tiles = (kr.y - kr.x + BT - 1) / BT;
  const int qk_key = tid % BT;  // Q·Kᵀ: PARTS threads a key, key-major
  const int qk_part = tid / BT;
  const int cp_key = tid / PARTS;  // copies: PARTS neighbours a key
  const int cp_part = tid % PARTS;

  // one commit group per tile (an empty group past the last tile keeps
  // the wait count uniform); PARTS threads copy a key's row, each every
  // PARTS-th 16-byte vector, so one warp-wide copy reads whole sectors
  auto load_tile = [&](int tile) {
    if (tile < n_tiles) {
      T* kt = kv_s + (tile % kStages) * 2 * BT * ks + cp_key * ks;
      T* vt = kt + BT * ks;
      const int pos = kr.x + tile * BT + cp_key;
      const bool ok = pos < kr.y;
      const T* ksrc = kg;
      const T* vsrc = vg;
      int step = 0;
      if (ok) {
        const int col = pos / p.bs;
        const long long page = pages_s[col - col0];
        const int tok = pos - col * p.bs;
        ksrc = kg + page * p.k_sn + tok * p.k_st;
        vsrc = vg + page * p.v_sn + tok * p.v_st;
        step = VEC;
      }
      for (int c = cp_part; c < ndv; c += PARTS) {
        cp_async16(kt + c * VEC, ksrc + c * step, ok);
        cp_async16(vt + c * VEC, vsrc + c * step, ok);
      }
    }
    cp_async_commit();
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int dv = tid % ndv;
  const int kgrp = tid / ndv;  // >= nkg: idle in the P·V phase

  float m_r[NJ], l_r[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    m_r[j] = kNegInf;
    l_r[j] = 0.f;
  }
  float acc[RB][VEC];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_tile(s);

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `tile` landed
    __syncthreads();  // everyone's landed; everyone is done with tile - 1
    load_tile(tile + kStages - 1);  // into tile - 1's stage
    const T* kt = kv_s + (tile % kStages) * 2 * BT * ks;
    const T* vt = kt + BT * ks;
    const int nt = min(BT, kr.y - (kr.x + tile * BT));  // keys in the tile

    {  // Q·Kᵀ: this thread's key against every row, over its slice of D
      float s[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) s[r] = 0.f;
      const T* krow = kt + qk_key * ks;
      for (int c = qk_part; c < ndv; c += PARTS) {
        float kf[VEC];
        load_vec(krow + c * VEC, kf);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float* qr = q_s + r * D + c * VEC;  // warp broadcast
          float acc_s = s[r];
#pragma unroll
          for (int i = 0; i < VEC; i += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + i);
            acc_s = fmaf(qv.x, kf[i], acc_s);
            acc_s = fmaf(qv.y, kf[i + 1], acc_s);
            acc_s = fmaf(qv.z, kf[i + 2], acc_s);
            acc_s = fmaf(qv.w, kf[i + 3], acc_s);
          }
          s[r] = acc_s;
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        s_part[(qk_part * RB + r) * BT + qk_key] = s[r];
    }
    __syncthreads();

    // online softmax: warp w keeps rows w, w + 4 (their m, l in registers)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = warp + kWarps * j;
      if (r < RB) {
        float sv[NU];
        float mx = kNegInf;
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int t = lane + 32 * u;
          float xv = kNegInf;
          if (t < nt) {
            xv = 0.f;
#pragma unroll
            for (int pt = 0; pt < PARTS; ++pt)
              xv += s_part[(pt * RB + r) * BT + t];
          }
          sv[u] = xv;
          mx = fmaxf(mx, xv);
        }
        const float m_new = fmaxf(m_r[j], warp_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int t = lane + 32 * u;
          if (t < BT) {
            const float pr = t < nt ? expf(sv[u] - m_new) : 0.f;
            p_s[t * RB + r] = pr;
            sum += pr;
          }
        }
        const float corr = expf(m_r[j] - m_new);
        l_r[j] = l_r[j] * corr + warp_sum(sum);
        m_r[j] = m_new;
        if (lane == 0) corr_s[r] = corr;
      }
    }
    __syncthreads();

    if (kgrp < nkg) {  // P·V: this thread's column vector over its keys
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float c = corr_s[r];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] *= c;
      }
      for (int t = kgrp; t < nt; t += nkg) {
        float vf[VEC];
        load_vec(vt + t * ks + dv * VEC, vf);
        const float* pt = p_s + t * RB;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float pr = pt[r];
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[r][i] += pr * vf[i];
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the tiles' space is free for the key-subset sums
  if (kgrp < nkg) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        red[(kgrp * RB + r) * D + dv * VEC + i] = acc[r][i];
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int r = warp + kWarps * j;
    if (r < RB && lane == 0) {
      ml_s[r] = m_r[j];
      ml_s[RB + r] = l_r[j];
    }
  }
  __syncthreads();

  T* og = static_cast<T*>(p.o) + b * p.o_sb;
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    float a = 0.f;
    for (int k2 = 0; k2 < nkg; ++k2) a += red[(k2 * RB + r) * D + d];
    const int h = h0 + r;
    if (p.nsplit == 1) {
      const float l = ml_s[RB + r];
      store(og + h * p.o_sh + d, l > 0.f ? a / l : 0.f);
    } else {
      const long long row = (long long)(b * p.H + h) * p.nsplit + split;
      p.part_acc[row * D + d] = a;
      if (d == 0) {
        p.part_ml[row * 2] = ml_s[r];
        p.part_ml[row * 2 + 1] = ml_s[RB + r];
      }
    }
  }
}

// One block per query row: the splits' (m, l, acc) combined in split order,
// splits with l = 0 skipped, a row with none written as zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_merge_kernel(const Params p) {
  const int row = blockIdx.x;  // b * H + h
  const int b = row / p.H;
  const int h = row - b * p.H;
  const float* ml = p.part_ml + (long long)row * p.nsplit * 2;
  float mx = kNegInf;
  for (int s = 0; s < p.nsplit; ++s)
    if (ml[2 * s + 1] > 0.f) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f;
  for (int s = 0; s < p.nsplit; ++s)
    if (ml[2 * s + 1] > 0.f) l += ml[2 * s + 1] * expf(ml[2 * s] - mx);
  const float* acc = p.part_acc + (long long)row * p.nsplit * p.D;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int d = threadIdx.x; d < p.D; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < p.nsplit; ++s)
      if (ml[2 * s + 1] > 0.f) a += acc[s * p.D + d] * expf(ml[2 * s] - mx);
    store(og + d, l > 0.f ? a / l : 0.f);
  }
}

template <typename T, int RB, int BT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  const int nkg = kThreads / (p.D / VEC);
  const size_t tiles =
      (size_t)kStages * 2 * BT * tile_stride<T>(p.D) * sizeof(T);
  const size_t red = sizeof(float) * nkg * RB * p.D;
  const size_t smem = sizeof(float) * head_words<RB, BT>(p.D, p.pps) +
                      (tiles > red ? tiles : red);
  auto kern = flash_decode_kernel<T, RB, BT>;
  static size_t smem_allowed = 48 * 1024;  // per instantiation
  cudaError_t e = allow_smem(kern, smem, &smem_allowed);
  if (e != cudaSuccess) return e;
  const int g = p.H / p.Hkv;
  const dim3 grid(p.B * p.Hkv * ((g + RB - 1) / RB), p.nsplit);
  kern<<<grid, kThreads, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.nsplit == 1) return e;
  flash_decode_merge_kernel<T><<<p.B * p.H, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int RB>
cudaError_t launch_bt(const Params& p, cudaStream_t stream) {
  // a tile of about 16 KB of K (and as much of V) a stage
  const int row_bytes = p.D * (int)sizeof(T);
  if (row_bytes <= 256) return launch<T, RB, 64>(p, stream);
  if constexpr (sizeof(T) == 2) {
    return launch<T, RB, 32>(p, stream);
  } else {
    if (row_bytes <= 512) return launch<T, RB, 32>(p, stream);
    return launch<T, RB, 16>(p, stream);
  }
}

// rows per block: the GQA group rounded up to 1, 2, 4 or 8
// (ops/flash_attention.py::_decode_rows_per_block mirrors it)
template <typename T>
cudaError_t launch_t(const Params& p, cudaStream_t stream) {
  const int g = p.H / p.Hkv;
  if (g > 4) return launch_bt<T, kMaxRows>(p, stream);
  if (g > 2) return launch_bt<T, 4>(p, stream);
  if (g == 2) return launch_bt<T, 2>(p, stream);
  return launch_bt<T, 1>(p, stream);
}

}  // namespace

// strides: q (b, h), k (page, token, head), v (page, token, head),
// o (b, h), tables (b) — in elements.
extern "C" int hvd_flash_decode_paged(
    const void* q, const void* k, const void* v, void* o, float* part_acc,
    float* part_ml, const long long* tables, const int* kv_lens, int B,
    int H, int Hkv, int D, int bs, int n_cols, int num_blocks, int window,
    int nsplit, int pps, const long long* strides, float sm_scale,
    int is_bf16, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || D <= 0 || D % 8 != 0 || D > 256 ||
      bs <= 0 || n_cols <= 0 || num_blocks <= 0 || nsplit <= 0 ||
      nsplit > 65535 || pps <= 0 ||
      (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, part_acc, part_ml, tables, kv_lens,
           B, H, Hkv, D, bs, n_cols, num_blocks, window, nsplit, pps,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = is_bf16 ? launch_t<__nv_bfloat16>(p, st)
                                : launch_t<float>(p, st);
  return (int)e;
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
