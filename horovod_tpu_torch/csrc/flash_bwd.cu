// Flash-attention backward for Hopper (sm_90a), CUDA C++: dQ, and dK/dV.
//
// Replaces horovod_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (launched by _backward_folded).  Both recompute the
// softmax probabilities of each (query, key) tile from the forward's saved
// log-sum-exp (_recompute_p): P = exp(q·sm_scale·kᵀ − lse), zeroed
// explicitly where _tile_mask (or q_pos < S) hides the entry; with
// δ = rowsum(dO·O) from the caller,
//   dS = P ∘ (dO·Vᵀ − δ),
//   dQ = Σ_k dS·K · sm_scale        (hvd_flash_bwd_dq)
//   dV = Σ Pᵀ·dO,  dK = Σ dSᵀ·Q · sm_scale, summed over the query-head
//   group that shares the kv head   (hvd_flash_bwd_dkv)
//
// What bounds them on an H100: at a training shape (S = 2048, D = 64)
// they do 6·D (dq) and 8·D (dkv) FLOPs per visible (head, query, key)
// triple against ~8 bytes per query row, so arithmetic bounds them.  This
// first design is simple and correct rather than fast, as flash_fwd.cu
// is: tiles are staged through shared memory with 16-byte loads, the
// products run on the CUDA cores in fp32, no wgmma, TMA or cp.async.
//
// Layout of the work (4 warps per block, 32 lanes each):
//   dq:  grid (B*H, ceil(S/16)).  Each warp owns 4 query rows (q·sm_scale
//        and dO in fp32 shared memory, read as warp broadcasts); the block
//        walks the 32-key K/V tiles of _kb_range, each lane scoring one
//        key, and accumulates dQ in registers (lane owns head-dim columns
//        lane + 32j), shuffling dS across the warp.
//   dkv: grid (B*H_kv, ceil(S/16)).  The block owns 16 keys (4 per warp,
//        K/V in fp32 shared memory) and their dK/dV tiles, so it needs no
//        atomics: it loops over the query heads of its kv head's group and,
//        for each, over the 32-query tiles of _qb_range (the transposed
//        bounds), each lane scoring one query.  The group's q, dO, lse and
//        δ are read through their strides, in place of the JAX package's
//        regrouping reshape.
//
// Both take the JAX kernels' uniform kv_offset (kv_off: the global
// position of the first key minus that of the first query; 0 for
// self-attention, (src − idx)·S for ring attention's off-diagonal blocks):
// the mask and both loop bounds act on global positions, and rows or keys
// that see nothing come out as zeros.
//
// Numerics follow the JAX kernels: q is cast to fp32 and multiplied by
// sm_scale before QKᵀ; accurate expf (no fast math); accumulation in fp32;
// dQ and dK are multiplied by sm_scale at the end, dV is not; outputs are
// cast to the input dtype.

#include "flash_common.cuh"

namespace {

using namespace hvd_flash;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;                 // rows per warp
constexpr int kBlockRows = kRows * kWarps;  // 16 rows per block
constexpr int kTile = 32;                // one column per lane

struct Strides {
  long long b, s, h;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, S) fp32, contiguous
  const float* delta;  // (B, H, S) fp32, contiguous
  void* dq;
  void* dk;
  void* dv;
  int B, S, H, Hkv, D;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int causal;
  int window;  // <= 0: none
  int kv_off;  // global K start minus global Q start
  float sm_scale;
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const void* base, Strides st,
                                            int b, int s, int h) {
  return static_cast<const T*>(base) + b * st.b + (long long)s * st.s +
         h * st.h;
}

// ---------------------------------------------------------------- dQ ----

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params p) {
  constexpr int VEC = Vec<T>::N;
  constexpr int NJ = DMAX / 32;
  const int D = p.D;
  const int ks = D + VEC;  // padded row stride: conflict-free 16 B reads

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // 16 x D, q*sm_scale
  float* do_s = q_s + kBlockRows * D;               // 16 x D
  T* k_s = reinterpret_cast<T*>(do_s + kBlockRows * D);  // 32 x ks
  T* v_s = k_s + kTile * ks;                              // 32 x ks

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.y * kBlockRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int dvecs = D / VEC;

  for (int idx = threadIdx.x; idx < kBlockRows * dvecs; idx += kThreads) {
    const int r = idx / dvecs;
    const int d0 = (idx - r * dvecs) * VEC;
    float qf[VEC], df[VEC];
    if (q0 + r < p.S) {
      load_vec(row_ptr<T>(p.q, p.sq, b, q0 + r, h) + d0, qf);
      load_vec(row_ptr<T>(p.dout, p.sdo, b, q0 + r, h) + d0, df);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qf[i] = df[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      q_s[r * D + d0 + i] = qf[i] * p.sm_scale;
      do_s[r * D + d0 + i] = df[i];
    }
  }

  float lse[kRows], delta[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int q_pos = q0 + warp * kRows + r;
    const long long at = (long long)bh * p.S + q_pos;
    lse[r] = q_pos < p.S ? p.lse[at] : 0.f;
    delta[r] = q_pos < p.S ? p.delta[at] : 0.f;
  }

  const int2 range = kb_range(q0, kBlockRows, kTile,
                              (p.S + kTile - 1) / kTile, p.causal,
                              p.window, p.kv_off);
  float acc[kRows][NJ];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;

  for (int kb = range.x; kb < range.y; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = threadIdx.x; idx < kTile * dvecs; idx += kThreads) {
      const int r = idx / dvecs;
      const int d0 = (idx - r * dvecs) * VEC;
      uint4 kv = make_uint4(0, 0, 0, 0);
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < p.S) {  // past the key length: zeros, never NaN
        kv = *reinterpret_cast<const uint4*>(
            row_ptr<T>(p.k, p.sk, b, k0 + r, hk) + d0);
        vv = *reinterpret_cast<const uint4*>(
            row_ptr<T>(p.v, p.sv, b, k0 + r, hk) + d0);
      }
      *reinterpret_cast<uint4*>(k_s + r * ks + d0) = kv;
      *reinterpret_cast<uint4*>(v_s + r * ks + d0) = vv;
    }
    __syncthreads();

    // this lane's key against the warp's rows: s = (q·scale)·k, dp = dO·v
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const T* krow = k_s + lane * ks;
    const T* vrow = v_s + lane * ks;
    for (int d0 = 0; d0 < D; d0 += VEC) {
      float kf[VEC], vf[VEC];
      load_vec(krow + d0, kf);
      load_vec(vrow + d0, vf);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* qr = q_s + (warp * kRows + r) * D + d0;  // broadcast
        const float* dr = do_s + (warp * kRows + r) * D + d0;
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + i);
          const float4 dv = *reinterpret_cast<const float4*>(dr + i);
          s[r] += qv.x * kf[i] + qv.y * kf[i + 1] + qv.z * kf[i + 2] +
                  qv.w * kf[i + 3];
          dp[r] += dv.x * vf[i] + dv.y * vf[i + 1] + dv.z * vf[i + 2] +
                   dv.w * vf[i + 3];
        }
      }
    }

    const int key = k0 + lane;
    float ds[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int q_pos = q0 + warp * kRows + r;
      const bool ok = q_pos < p.S &&
                      visible(q_pos, key, p.S, p.kv_off, p.causal, p.window);
      const float pr = ok ? expf(s[r] - lse[r]) : 0.f;
      ds[r] = pr * (dp[r] - delta[r]);
    }
    // dQ += dS·K: the tile's 32 keys, each lane on its head-dim columns
    for (int kk = 0; kk < kTile; ++kk) {
      float kc[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        kc[j] = d < D ? to_float(k_s[kk * ks + d]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dsk = __shfl_sync(kFull, ds[r], kk);
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[r][j] += dsk * kc[j];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int q_pos = q0 + warp * kRows + r;
    if (q_pos >= p.S) continue;
    T* out = static_cast<T*>(p.dq) + b * p.sdq.b +
             (long long)q_pos * p.sdq.s + h * p.sdq.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) store(out + d, acc[r][j] * p.sm_scale);
    }
  }
}

// --------------------------------------------------------------- dKV ----

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Params p) {
  constexpr int VEC = Vec<T>::N;
  constexpr int NJ = DMAX / 32;
  const int D = p.D;
  const int ks = D + VEC;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);  // 16 x D
  float* v_s = k_s + kBlockRows * D;                // 16 x D
  T* q_t = reinterpret_cast<T*>(v_s + kBlockRows * D);  // 32 x ks
  T* do_t = q_t + kTile * ks;                             // 32 x ks

  const int bkv = blockIdx.x;
  const int b = bkv / p.Hkv;
  const int hk = bkv - b * p.Hkv;
  const int group = p.H / p.Hkv;
  const int k0 = blockIdx.y * kBlockRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int dvecs = D / VEC;

  for (int idx = threadIdx.x; idx < kBlockRows * dvecs; idx += kThreads) {
    const int r = idx / dvecs;
    const int d0 = (idx - r * dvecs) * VEC;
    float kf[VEC], vf[VEC];
    if (k0 + r < p.S) {
      load_vec(row_ptr<T>(p.k, p.sk, b, k0 + r, hk) + d0, kf);
      load_vec(row_ptr<T>(p.v, p.sv, b, k0 + r, hk) + d0, vf);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      k_s[r * D + d0 + i] = kf[i];
      v_s[r * D + d0 + i] = vf[i];
    }
  }

  // _qb_range: _kb_range with q and k swapped and the offset negated,
  // the causal lower bound (the first query tile at or after the shifted
  // diagonal) joined by max
  int2 range = kb_range(k0, kBlockRows, kTile, (p.S + kTile - 1) / kTile,
                        0, p.window, -p.kv_off);
  if (p.causal)
    range.x = max(range.x, max(0, floor_div(k0 + p.kv_off, kTile)));

  float dk[kRows][NJ], dv[kRows][NJ];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[r][j] = dv[r][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long stat0 = ((long long)b * p.H + h) * p.S;
    for (int qb = range.x; qb < range.y; ++qb) {
      const int q0 = qb * kTile;
      __syncthreads();  // every warp is done with the previous tile
      for (int idx = threadIdx.x; idx < kTile * dvecs; idx += kThreads) {
        const int r = idx / dvecs;
        const int d0 = (idx - r * dvecs) * VEC;
        uint4 qv = make_uint4(0, 0, 0, 0);
        uint4 gv = make_uint4(0, 0, 0, 0);
        if (q0 + r < p.S) {
          qv = *reinterpret_cast<const uint4*>(
              row_ptr<T>(p.q, p.sq, b, q0 + r, h) + d0);
          gv = *reinterpret_cast<const uint4*>(
              row_ptr<T>(p.dout, p.sdo, b, q0 + r, h) + d0);
        }
        *reinterpret_cast<uint4*>(q_t + r * ks + d0) = qv;
        *reinterpret_cast<uint4*>(do_t + r * ks + d0) = gv;
      }
      __syncthreads();

      const int q_pos = q0 + lane;  // this lane's query
      const float lse = q_pos < p.S ? p.lse[stat0 + q_pos] : 0.f;
      const float delta = q_pos < p.S ? p.delta[stat0 + q_pos] : 0.f;
      float s[kRows], dp[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
      const T* qrow = q_t + lane * ks;
      const T* grow = do_t + lane * ks;
      for (int d0 = 0; d0 < D; d0 += VEC) {
        float qf[VEC], gf[VEC];
        load_vec(qrow + d0, qf);
        load_vec(grow + d0, gf);
#pragma unroll
        for (int i = 0; i < VEC; ++i) qf[i] *= p.sm_scale;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float* kr = k_s + (warp * kRows + r) * D + d0;  // broadcast
          const float* vr = v_s + (warp * kRows + r) * D + d0;
#pragma unroll
          for (int i = 0; i < VEC; i += 4) {
            const float4 kv = *reinterpret_cast<const float4*>(kr + i);
            const float4 vv = *reinterpret_cast<const float4*>(vr + i);
            s[r] += qf[i] * kv.x + qf[i + 1] * kv.y + qf[i + 2] * kv.z +
                    qf[i + 3] * kv.w;
            dp[r] += gf[i] * vv.x + gf[i + 1] * vv.y + gf[i + 2] * vv.z +
                     gf[i + 3] * vv.w;
          }
        }
      }

      float pr[kRows], ds[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int key = k0 + warp * kRows + r;
        const bool ok = q_pos < p.S &&
                        visible(q_pos, key, p.S, p.kv_off, p.causal, p.window);
        pr[r] = ok ? expf(s[r] - lse) : 0.f;
        ds[r] = pr[r] * (dp[r] - delta);
      }
      // dV += Pᵀ·dO and dK += dSᵀ·Q over the tile's 32 queries, each
      // lane on its head-dim columns
      for (int qq = 0; qq < kTile; ++qq) {
        float gc[NJ], qc[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          gc[j] = d < D ? to_float(do_t[qq * ks + d]) : 0.f;
          qc[j] = d < D ? to_float(q_t[qq * ks + d]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pq = __shfl_sync(kFull, pr[r], qq);
          const float dsq = __shfl_sync(kFull, ds[r], qq);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv[r][j] += pq * gc[j];
            dk[r][j] += dsq * qc[j];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = k0 + warp * kRows + r;
    if (key >= p.S) continue;
    T* dko = static_cast<T*>(p.dk) + b * p.sdk.b + (long long)key * p.sdk.s +
             hk * p.sdk.h;
    T* dvo = static_cast<T*>(p.dv) + b * p.sdv.b + (long long)key * p.sdv.s +
             hk * p.sdv.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        store(dko + d, dk[r][j] * p.sm_scale);
        store(dvo + d, dv[r][j]);
      }
    }
  }
}

// ------------------------------------------------------------ launch ----

template <typename T, int DMAX>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  const size_t smem = 2ull * sizeof(float) * kBlockRows * p.D +
                      2ull * kTile * (p.D + VEC) * sizeof(T);
  auto kern = flash_bwd_dq_kernel<T, DMAX>;
  static size_t smem_allowed = 48 * 1024;  // per instantiation
  const cudaError_t e = allow_smem(kern, smem, &smem_allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.B * p.H, (p.S + kBlockRows - 1) / kBlockRows);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  const size_t smem = 2ull * sizeof(float) * kBlockRows * p.D +
                      2ull * kTile * (p.D + VEC) * sizeof(T);
  auto kern = flash_bwd_dkv_kernel<T, DMAX>;
  static size_t smem_allowed = 48 * 1024;  // per instantiation
  const cudaError_t e = allow_smem(kern, smem, &smem_allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.B * p.Hkv, (p.S + kBlockRows - 1) / kBlockRows);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const Params& p, int dkv, cudaStream_t st) {
  if (p.D <= 64) return dkv ? launch_dkv<T, 64>(p, st) : launch_dq<T, 64>(p, st);
  if (p.D <= 128)
    return dkv ? launch_dkv<T, 128>(p, st) : launch_dq<T, 128>(p, st);
  return dkv ? launch_dkv<T, 256>(p, st) : launch_dq<T, 256>(p, st);
}

int entry(const Params& p, int dkv, int is_bf16, void* stream) {
  if (p.B <= 0 || p.S <= 0 || p.H <= 0) return (int)cudaSuccess;
  if (p.Hkv <= 0 || p.H % p.Hkv != 0 || p.D <= 0 || p.D % 8 != 0 ||
      p.D > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? run<__nv_bfloat16>(p, dkv, st)
                       : run<float>(p, dkv, st));
}

}  // namespace

// Strides are in elements, (batch, sequence, head) for each of q, k, v,
// dO and the outputs; the last dim is contiguous.  lse and delta are
// (B, H, S) fp32 contiguous.  kv_off: global K start minus global Q start.
extern "C" int hvd_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq,
    int B, int S, int H, int Hkv, int D, const long long* strides,
    int causal, int window, int kv_off, float sm_scale, int is_bf16,
    void* stream) {
  const long long* s = strides;  // q, k, v, dO, dq: 5 x (b, s, h)
  Params p{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, S, H, Hkv, D,
           {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
           {s[9], s[10], s[11]}, {s[12], s[13], s[14]}, {0, 0, 0}, {0, 0, 0},
           causal, window, kv_off, sm_scale};
  return entry(p, 0, is_bf16, stream);
}

extern "C" int hvd_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    int B, int S, int H, int Hkv, int D, const long long* strides,
    int causal, int window, int kv_off, float sm_scale, int is_bf16,
    void* stream) {
  const long long* s = strides;  // q, k, v, dO, dk, dv: 6 x (b, s, h)
  Params p{q, k, v, dout, lse, delta, nullptr, dk, dv, B, S, H, Hkv, D,
           {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
           {s[9], s[10], s[11]}, {0, 0, 0}, {s[12], s[13], s[14]},
           {s[15], s[16], s[17]}, causal, window, kv_off, sm_scale};
  return entry(p, 1, is_bf16, stream);
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
