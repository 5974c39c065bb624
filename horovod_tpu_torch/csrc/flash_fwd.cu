// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces horovod_tpu/ops/flash_attention.py::_fwd_kernel in both of its
// launches: online-softmax attention of a (B, C, H, D) query block over
// (B, S, H_kv, D) keys and values, with the padding, causal and
// sliding-window masks of _tile_mask applied on global positions.
//   * per-row-offset launch (flash_chunk_attention / flash_decode_attention,
//     the serving path): each batch row at its own global offset
//     kv_start[b] - q_start[b], always causal, every gathered key valid;
//   * uniform-offset launch (_forward_impl, the training path's
//     flash_attention, and flash_block_forward, ring attention's blocks):
//     one offset for every row (0 for self-attention, (src − idx)·S for
//     the ring's off-diagonal blocks), causal or bidirectional, with or
//     without a window, C = S; it also writes the log-sum-exp the
//     backward kernels (flash_bwd.cu) recompute the probabilities from.
//
// What bounds it on an H100: a decode step (C = 1) reads every live K/V
// byte once and does ~1 FLOP per byte, so it is bound by the 3.35 TB/s of
// device memory; a chunked-prefill step or a training forward does ~C
// FLOPs per K/V byte and is bound by arithmetic.  This first design is
// simple and correct rather than fast: K/V tiles are staged through shared
// memory by the whole block with 16-byte loads (coalesced, the part that
// matters for decode), the products run on the CUDA cores in fp32 (no
// wgmma, no TMA — those are the later PRs' work), and decode splits each
// K/V tile across the four warps (each keeps its own softmax statistics,
// merged at the end) so a one-row query keeps all four warps busy.
//
// Layout of the work:
//   grid  = (B*H, ceil(C / BQ)): one block per (batch*head, Q tile);
//   block = 4 warps.  Chunk config (training, prefill): each warp owns 4
//   query rows (BQ = 16) and every lane one key of the 32-key tile (the
//   tile's scores of a row are one warp register each, so the row max/sum
//   are warp shuffles).  Decode config: one query row, the 128-key tile
//   split in four.
// Query head h reads kv head h / (H / H_kv) (GQA, no repeat); q, k, v and
// o are read and written through their strides (last dim contiguous).
//
// Numerics follow _fwd_kernel: q is cast to fp32 and multiplied by
// sm_scale before QK^T; statistics and accumulation in fp32; masked
// entries are zeroed explicitly (a fully masked row keeps the -1e30
// sentinel as its max, where exp(s - m) would be 1); rows with no visible
// key write zeros and the -1e30 log-sum-exp sentinel.

#include "flash_common.cuh"

namespace {

using namespace hvd_flash;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeysPerWarp = 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;         // (B, H, C) fp32, or null
  const int* offs;    // (B,) kv_start - q_start
  int B, C, H, Hkv, S, D;
  long long q_sb, q_sc, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_sc, o_sh;
  int window;  // window <= 0: none
  int causal;
  float sm_scale;
};

// RPW: query rows per warp; KSPLIT: warps sharing one row set, each on
// its own 32-key slice of the tile; DMAX: head_dim bucket (D <= DMAX).
template <typename T, int RPW, int KSPLIT, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int VEC = Vec<T>::N;
  constexpr int ROW_GROUPS = kWarps / KSPLIT;
  constexpr int BQ = RPW * ROW_GROUPS;        // query rows per block
  constexpr int BK = kKeysPerWarp * KSPLIT;   // keys per shared tile
  constexpr int NJ = DMAX / 32;               // head_dim columns per lane
  const int D = p.D;
  const int ks = D + VEC;  // padded row stride: conflict-free 16 B reads

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // BQ x D, scaled
  T* k_s = reinterpret_cast<T*>(q_s + BQ * D);      // BK x ks
  T* v_s = k_s + BK * ks;                           // BK x ks

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.y * BQ;
  const int kv_off = p.offs[b];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rg = warp % ROW_GROUPS;
  const int split = warp / ROW_GROUPS;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int dvecs = D / VEC;

  for (int idx = threadIdx.x; idx < BQ * dvecs; idx += kThreads) {
    const int r = idx / dvecs;
    const int d0 = (idx - r * dvecs) * VEC;
    float tmp[VEC];
    if (q0 + r < p.C) {
      load_vec(qg + (long long)(q0 + r) * p.q_sc + d0, tmp);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) tmp[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) q_s[r * D + d0 + i] = tmp[i] * p.sm_scale;
  }

  const int win = p.window;
  const int2 range = kb_range(q0, BQ, BK, (p.S + BK - 1) / BK, p.causal,
                              win, kv_off);

  float m[RPW], l[RPW], acc[RPW][NJ];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  }

  const int my_key = split * kKeysPerWarp + lane;  // row of the tile
  for (int kb = range.x; kb < range.y; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = threadIdx.x; idx < BK * dvecs; idx += kThreads) {
      const int r = idx / dvecs;
      const int d0 = (idx - r * dvecs) * VEC;
      const int key = k0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0);
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (key < p.S) {  // past the key length: zeros, never NaN
        kv = *reinterpret_cast<const uint4*>(kg + key * p.k_ss + d0);
        vv = *reinterpret_cast<const uint4*>(vg + key * p.v_ss + d0);
      }
      *reinterpret_cast<uint4*>(k_s + r * ks + d0) = kv;
      *reinterpret_cast<uint4*>(v_s + r * ks + d0) = vv;
    }
    __syncthreads();

    // scores of this lane's key against the warp's rows
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const T* krow = k_s + my_key * ks;
    for (int d0 = 0; d0 < D; d0 += VEC) {
      float kf[VEC];
      load_vec(krow + d0, kf);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float* qr = q_s + (rg * RPW + r) * D + d0;  // warp broadcast
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + i);
          s[r] += qv.x * kf[i] + qv.y * kf[i + 1] + qv.z * kf[i + 2] +
                  qv.w * kf[i + 3];
        }
      }
    }

    const int key = k0 + my_key;
    const T* vtile = v_s + (split * kKeysPerWarp) * ks;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int q_pos = q0 + rg * RPW + r;
      const bool ok = visible(q_pos, key, p.S, kv_off, p.causal, win);
      const float sv = ok ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float pr = ok ? expf(sv - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(pr);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] *= corr;
      for (int kk = 0; kk < kKeysPerWarp; ++kk) {
        const float pk = __shfl_sync(kFull, pr, kk);
        const T* vrow = vtile + kk * ks;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          if (d < D) acc[r][j] += pk * to_float(vrow[d]);
        }
      }
    }
  }

  if constexpr (KSPLIT > 1) {
    // merge the key splits' (m, l, acc) per row through shared memory
    __syncthreads();
    float* scratch = reinterpret_cast<float*>(k_s);  // KSPLIT*BQ*(D+2)
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float* base = scratch + (split * BQ + rg * RPW + r) * (D + 2);
      if (lane == 0) {
        base[0] = m[r];
        base[1] = l[r];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        if (d < D) base[2 + d] = acc[r][j];
      }
    }
    __syncthreads();
    if (split == 0) {
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int row = rg * RPW + r;
        float mx = kNegInf;
        for (int sp = 0; sp < KSPLIT; ++sp)
          mx = fmaxf(mx, scratch[(sp * BQ + row) * (D + 2)]);
        float lt = 0.f;
        float at[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) at[j] = 0.f;
        for (int sp = 0; sp < KSPLIT; ++sp) {
          const float* base = scratch + (sp * BQ + row) * (D + 2);
          const float w = expf(base[0] - mx);
          lt += base[1] * w;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int d = lane + 32 * j;
            if (d < D) at[j] += base[2 + d] * w;
          }
        }
        m[r] = mx;
        l[r] = lt;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[r][j] = at[j];
      }
    }
  }

  if (split != 0) return;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int q_pos = q0 + rg * RPW + r;
    if (q_pos >= p.C) continue;
    const float safe_l = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) store(og + q_pos * p.o_sc + d, acc[r][j] / safe_l);
    }
    if (p.lse != nullptr && lane == 0) {
      p.lse[(long long)bh * p.C + q_pos] =
          l[r] > 0.f ? m[r] + logf(safe_l) : kNegInf;
    }
  }
}

template <typename T, int RPW, int KSPLIT, int DMAX>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int BQ = RPW * (kWarps / KSPLIT);
  constexpr int BK = kKeysPerWarp * KSPLIT;
  constexpr int VEC = Vec<T>::N;
  const size_t smem = sizeof(float) * BQ * p.D +
                      2ull * BK * (p.D + VEC) * sizeof(T);
  auto kern = flash_fwd_kernel<T, RPW, KSPLIT, DMAX>;
  static size_t smem_allowed = 48 * 1024;  // per instantiation
  const cudaError_t e = allow_smem(kern, smem, &smem_allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.B * p.H, (p.C + BQ - 1) / BQ);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int RPW, int KSPLIT>
cudaError_t launch_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<T, RPW, KSPLIT, 64>(p, stream);
  if (p.D <= 128) return launch<T, RPW, KSPLIT, 128>(p, stream);
  return launch<T, RPW, KSPLIT, 256>(p, stream);
}

template <typename T>
cudaError_t launch_t(const Params& p, cudaStream_t stream) {
  // a few query rows (decode): one row per block, the 128-key tile split
  // across the four warps; a chunk or a training sequence: 16 rows per
  // block, 4 per warp (also the decode fallback where a 128-key fp32 tile
  // of D > 128 would not fit the 227 KB of shared memory)
  const size_t split_tile = 2ull * 4 * kKeysPerWarp *
                            (p.D + Vec<T>::N) * sizeof(T);
  if (p.C <= 4 && split_tile <= 160 * 1024)
    return launch_d<T, 1, 4>(p, stream);
  return launch_d<T, 4, 1>(p, stream);
}

}  // namespace

extern "C" int hvd_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* offs, int B, int C, int H, int Hkv, int S, int D,
    long long q_sb, long long q_sc, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sc, long long o_sh,
    int window, int causal, float sm_scale, int is_bf16, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || D <= 0 || D % 8 != 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, lse, offs, B, C, H, Hkv, S, D,
           q_sb, q_sc, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_sc, o_sh, window, causal, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = is_bf16 ? launch_t<__nv_bfloat16>(p, st)
                                : launch_t<float>(p, st);
  return (int)e;
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
