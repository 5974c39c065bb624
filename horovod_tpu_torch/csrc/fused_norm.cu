// Fused training-mode BatchNorm(+residual)+ReLU for Hopper (sm_90a), CUDA C++.
//
// Replaces the four Pallas kernels of horovod_tpu/ops/fused_norm.py:
//   hvd_bn_stats       _stats_kernel       per-channel sum x, sum x^2 (fp32)
//   hvd_bn_apply       _apply_kernel       y = x*scale + shift [+ res] [relu]
//   hvd_bn_bwd_reduce  _bwd_reduce_kernel  sum dy', sum dy'*xhat, dy' = dy*[y>0]
//   hvd_bn_dx          _dx_kernel          dx = g*rstd*(dy' - sdb/M - xhat*sdg/M),
//                                          dres = dy'
// over a channels-last (M, C) view of the activation (M = N*H*W rows, the
// C channels contiguous), bf16 or fp32 in memory, all math in fp32.
//
// What bounds them on an H100: bytes.  Each does 2-10 flops per element it
// reads (3.35 TB/s of device memory against 67 TFLOP/s of fp32 is a ridge
// of ~20 flops per byte; the bf16 tensor-core ridge is 295), so the only
// lever is to touch each byte once: the stats and backward-reduce kernels
// read their inputs once, the apply and dx kernels read them once more and
// write the outputs, and xhat is recomputed from x, mean and rstd instead of
// being stored (the TPU design's pass count, kept).
//
// Where the TPU design does not translate:
//   * _stats_kernel and _bwd_reduce_kernel carry their sums across a
//     sequential grid in one VMEM buffer.  Here blocks run in no order, so
//     the reduction takes two passes and no atomics: each block reduces a
//     strip of rows into fp32 per-channel partials in a (blocks, 2, C)
//     scratch tensor the wrapper allocates, and a small finishing kernel
//     sums the partials in a fixed order.  The result is the same from run
//     to run.
//   * The C-length arithmetic between the kernels (mean, var, rstd, scale,
//     shift: XLA's part in JAX) is the finishing kernel's tail
//     (finalize_channel), or, when the sums cross ranks first (sync BN), a
//     launch of its own after the wrapper's all-reduce; the dx kernel forms
//     g*rstd, sdb/M and sdg/M per channel itself.
//   * No lane folding: that existed for the TPU's 128-lane registers.  Any
//     M >= 1 and C >= 1 run.  A thread owns a fixed group of channels (one
//     16-byte vector: 8 bf16 or 4 fp32; one element on the scalar path,
//     taken when C is not a multiple of the vector or a pointer is not
//     16-byte aligned) and walks rows with a grid stride, so a warp reads
//     whole rows (or runs of rows when C is narrow) contiguously.
//
// Block: 256 threads as TX x TY, TX (a power of two <= 32) threads across
// the channel vectors, TY = 256 / TX down the rows; grid (gx, gy) with
// gx = ceil((C / V) / TX).  The wrapper picks TX and gy (ops/fused_norm.py
// _layout) and sizes the partials from gy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxV = 8;  // elements of one 16-byte bf16 vector
constexpr int kUnroll = 2;  // rows the stats kernel's threads load at once
constexpr int kReduceBlocksPerSM = 4;  // the wrapper launches one wave

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float* out);

template <>
__device__ __forceinline__ void load<float, 1>(const float* p, float* out) {
  out[0] = *p;
}
template <>
__device__ __forceinline__ void load<__nv_bfloat16, 1>(const __nv_bfloat16* p,
                                                       float* out) {
  out[0] = __bfloat162float(*p);
}
template <>
__device__ __forceinline__ void load<float, 4>(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <>
__device__ __forceinline__ void load<__nv_bfloat16, 8>(const __nv_bfloat16* p,
                                                       float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* v);

template <>
__device__ __forceinline__ void store<float, 1>(float* p, const float* v) {
  *p = v[0];
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16, 1>(__nv_bfloat16* p,
                                                        const float* v) {
  *p = __float2bfloat16(v[0]);
}
template <>
__device__ __forceinline__ void store<float, 4>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16, 8>(__nv_bfloat16* p,
                                                        const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// This thread's place in the block and its first channel (col * V), or
// col >= CV when it has no channels (a ragged last column block).
struct Place {
  int tx, ty, TY, col, CV;
};

template <int V>
__device__ __forceinline__ Place place(int C, int TX) {
  Place p;
  p.tx = threadIdx.x % TX;
  p.ty = threadIdx.x / TX;
  p.TY = kThreads / TX;
  p.col = blockIdx.x * TX + p.tx;
  p.CV = C / V;
  return p;
}

// Sum the TY row-threads' per-channel accumulators of a block in a fixed
// order and write them as this block's partials (blockIdx.y, {0, 1}, C).
template <int V>
__device__ __forceinline__ void block_partials(const Place& p, int C,
                                               const float* a, const float* b,
                                               float* partials) {
  __shared__ float sa[kThreads * kMaxV];
  __shared__ float sb[kThreads * kMaxV];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sa[threadIdx.x * V + i] = a[i];
    sb[threadIdx.x * V + i] = b[i];
  }
  __syncthreads();
  if (p.ty != 0 || p.col >= p.CV) return;
  const int TX = kThreads / p.TY;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float ta = 0.f, tb = 0.f;
    for (int t = 0; t < p.TY; ++t) {
      ta += sa[(t * TX + p.tx) * V + i];
      tb += sb[(t * TX + p.tx) * V + i];
    }
    const long long c = (long long)p.col * V + i;
    partials[((long long)blockIdx.y * 2) * C + c] = ta;
    partials[((long long)blockIdx.y * 2 + 1) * C + c] = tb;
  }
}

// mean, var, rstd, scale, shift of channel c from its sums, written to the
// (5, C) stats buffer.  Explicit roundings (no contraction) so the two
// launch sites give identical bits: var = max(E[x^2] - mean^2, 0),
// rstd = rsqrt(var + eps), scale = gamma*rstd, shift = beta - mean*scale.
__device__ __forceinline__ void finalize_channel(int c, int C, float s1,
                                                 float s2, const float* gamma,
                                                 const float* beta,
                                                 float count, float eps,
                                                 float* stats) {
  const float mean = __fdiv_rn(s1, count);
  const float var =
      fmaxf(__fsub_rn(__fdiv_rn(s2, count), __fmul_rn(mean, mean)), 0.f);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  const float scale = __fmul_rn(gamma[c], rstd);
  stats[c] = mean;
  stats[C + c] = var;
  stats[2 * C + c] = rstd;
  stats[3 * C + c] = scale;
  stats[4 * C + c] = __fsub_rn(beta[c], __fmul_rn(mean, scale));
}

// ------------------------------------------------------------- kernels --

// _stats_kernel, pass 1: per-block partial sums of x and x^2.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kReduceBlocksPerSM)
bn_stats_partial(const T* __restrict__ x, long long M, int C, int TX,
                 float* __restrict__ partials) {
  const Place p = place<V>(C, TX);
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
  if (p.col < p.CV) {
    const T* xc = x + (long long)p.col * V;
    const long long step = (long long)gridDim.y * p.TY;
    long long r = (long long)blockIdx.y * p.TY + p.ty;
    // kUnroll rows' loads in flight, summed in row order
    for (; r + (kUnroll - 1) * step < M; r += kUnroll * step) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load<T, V>(xc + (r + u * step) * C, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += v[u][i];
          q[i] += v[u][i] * v[u][i];
        }
    }
    for (; r < M; r += step) {
      float v[V];
      load<T, V>(xc + r * C, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += v[i];
        q[i] += v[i] * v[i];
      }
    }
  }
  block_partials<V>(p, C, s, q, partials);
}

// Pass 2 of both reductions: sums (2, C) = the partials summed over their
// nparts blocks in a fixed order (32 channels x 8 slices a block, each
// slice a strided sequence, the slices then added in order); with stats
// non-null, also the per-channel finalize.
__global__ void __launch_bounds__(kThreads)
bn_reduce_partials(const float* __restrict__ partials, int nparts, int C,
                   float* __restrict__ sums, const float* gamma,
                   const float* beta, float count, float eps, float* stats) {
  __shared__ float sa[8][32];
  __shared__ float sb[8][32];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float a = 0.f, b = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int j = ty; j < nparts; j += 8) {
      a += partials[(long long)j * 2 * C + c];
      b += partials[((long long)j * 2 + 1) * C + c];
    }
  }
  sa[ty][tx] = a;
  sb[ty][tx] = b;
  __syncthreads();
  if (ty != 0 || c >= C) return;
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    a += sa[t][tx];
    b += sb[t][tx];
  }
  sums[c] = a;
  sums[C + c] = b;
  if (stats != nullptr) finalize_channel(c, C, a, b, gamma, beta, count, eps, stats);
}

// The finalize alone, after the sums crossed ranks (sync BN).
__global__ void __launch_bounds__(kThreads)
bn_finalize(const float* __restrict__ sums, int C, const float* gamma,
            const float* beta, float count, float eps, float* stats) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c < C) finalize_channel(c, C, sums[c], sums[C + c], gamma, beta, count, eps, stats);
}

// _apply_kernel: y = x*scale + shift [+ res] [relu].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ stats, long long M, int C, int TX,
                int relu, T* __restrict__ y) {
  const Place p = place<V>(C, TX);
  if (p.col >= p.CV) return;
  const long long c0 = (long long)p.col * V;
  float scale[V], shift[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    scale[i] = stats[3 * C + c0 + i];
    shift[i] = stats[4 * C + c0 + i];
  }
  const long long step = (long long)gridDim.y * p.TY;
  for (long long r = (long long)blockIdx.y * p.TY + p.ty; r < M; r += step) {
    const long long at = r * C + c0;
    float v[V], o[V];
    load<T, V>(x + at, v);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = v[i] * scale[i] + shift[i];
    if (res != nullptr) {
      load<T, V>(res + at, v);
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] += v[i];
    }
    if (relu) {
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = fmaxf(o[i], 0.f);
    }
    store<T, V>(y + at, o);
  }
}

// _bwd_reduce_kernel, pass 1: per-block partial sums of dy' and dy'*xhat.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kReduceBlocksPerSM)
bn_bwd_partial(const T* __restrict__ x, const T* __restrict__ dy,
               const T* __restrict__ y, const float* __restrict__ mean_c,
               const float* __restrict__ rstd_c, long long M, int C, int TX,
               int relu, float* __restrict__ partials) {
  const Place p = place<V>(C, TX);
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
  if (p.col < p.CV) {
    const long long c0 = (long long)p.col * V;
    float mean[V], rstd[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mean[i] = mean_c[c0 + i];
      rstd[i] = rstd_c[c0 + i];
    }
    const long long step = (long long)gridDim.y * p.TY;
    for (long long r = (long long)blockIdx.y * p.TY + p.ty; r < M; r += step) {
      const long long at = r * C + c0;
      float xv[V], g[V];
      load<T, V>(dy + at, g);
      if (relu) {
        float yv[V];
        load<T, V>(y + at, yv);
#pragma unroll
        for (int i = 0; i < V; ++i) g[i] = yv[i] > 0.f ? g[i] : 0.f;
      }
      load<T, V>(x + at, xv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += g[i];
        q[i] += g[i] * ((xv[i] - mean[i]) * rstd[i]);
      }
    }
  }
  block_partials<V>(p, C, s, q, partials);
}

// _dx_kernel: dx = gamma*rstd*(dy' - sdb/M - xhat*sdg/M), dres = dy'.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
             const T* __restrict__ y, const float* __restrict__ gamma,
             const float* __restrict__ mean_c,
             const float* __restrict__ rstd_c, const float* __restrict__ sums,
             float count, long long M, int C, int TX, int relu,
             T* __restrict__ dx, T* __restrict__ dres) {
  const Place p = place<V>(C, TX);
  if (p.col >= p.CV) return;
  const long long c0 = (long long)p.col * V;
  float mean[V], rstd[V], gr[V], mdb[V], mdg[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mean[i] = mean_c[c0 + i];
    rstd[i] = rstd_c[c0 + i];
    gr[i] = gamma[c0 + i] * rstd[i];
    mdb[i] = sums[c0 + i] / count;
    mdg[i] = sums[C + c0 + i] / count;
  }
  const long long step = (long long)gridDim.y * p.TY;
  for (long long r = (long long)blockIdx.y * p.TY + p.ty; r < M; r += step) {
    const long long at = r * C + c0;
    float xv[V], g[V], o[V];
    load<T, V>(dy + at, g);
    if (relu) {
      float yv[V];
      load<T, V>(y + at, yv);
#pragma unroll
      for (int i = 0; i < V; ++i) g[i] = yv[i] > 0.f ? g[i] : 0.f;
    }
    if (dres != nullptr) store<T, V>(dres + at, g);
    load<T, V>(x + at, xv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xhat = (xv[i] - mean[i]) * rstd[i];
      o[i] = gr[i] * (g[i] - mdb[i] - xhat * mdg[i]);
    }
    store<T, V>(dx + at, o);
  }
}

// ------------------------------------------------------------ launches --

dim3 grid_of(int C, int V, int TX, int gy) {
  return dim3((C / V + TX - 1) / TX, gy);
}

dim3 reduce_grid(int C) { return dim3((C + 31) / 32); }

template <typename T, int V>
cudaError_t stats_t(const void* x, long long M, int C, int TX, int gy,
                    float* partials, float* sums, const float* gamma,
                    const float* beta, float count, float eps, float* stats,
                    cudaStream_t s) {
  const dim3 g = grid_of(C, V, TX, gy);
  bn_stats_partial<T, V><<<g, kThreads, 0, s>>>(
      static_cast<const T*>(x), M, C, TX, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bn_reduce_partials<<<reduce_grid(C), kThreads, 0, s>>>(
      partials, gy, C, sums, gamma, beta, count, eps, stats);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t apply_t(const void* x, const void* res, const float* stats,
                    long long M, int C, int TX, int gy, int relu, void* y,
                    cudaStream_t s) {
  const dim3 g = grid_of(C, V, TX, gy);
  bn_apply_kernel<T, V><<<g, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), stats, M, C, TX,
      relu, static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t bwd_reduce_t(const void* x, const void* dy, const void* y,
                         const float* mean, const float* rstd, long long M,
                         int C, int TX,
                         int gy, int relu, float* partials, float* sums,
                         cudaStream_t s) {
  const dim3 g = grid_of(C, V, TX, gy);
  bn_bwd_partial<T, V><<<g, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(y), mean, rstd, M, C, TX, relu, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bn_reduce_partials<<<reduce_grid(C), kThreads, 0, s>>>(
      partials, gy, C, sums, nullptr, nullptr, 1.f, 0.f, nullptr);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t dx_t(const void* x, const void* dy, const void* y,
                 const float* gamma, const float* mean, const float* rstd,
                 const float* sums, float count, long long M, int C, int TX, int gy, int relu,
                 void* dx, void* dres, cudaStream_t s) {
  const dim3 g = grid_of(C, V, TX, gy);
  bn_dx_kernel<T, V><<<g, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(y), gamma, mean, rstd, sums, count, M, C, TX, relu,
      static_cast<T*>(dx), static_cast<T*>(dres));
  return cudaGetLastError();
}

bool bad_layout(int C, int TX, int gy) {
  return C < 1 || TX < 1 || TX > 32 || (TX & (TX - 1)) != 0 || gy < 1 ||
         gy > 65535;
}

// Dispatch on the element type and the vector path: F<T, V>(args...).
#define HVD_BN_DISPATCH(F, ...)                                          \
  (is_bf16 ? (vec ? F<__nv_bfloat16, 8>(__VA_ARGS__)                     \
                  : F<__nv_bfloat16, 1>(__VA_ARGS__))                    \
           : (vec ? F<float, 4>(__VA_ARGS__) : F<float, 1>(__VA_ARGS__)))

}  // namespace

// x: (M, C) row-major, bf16 (is_bf16) or fp32; vec: 16-byte vector path
// (C a multiple of the vector, every row pointer 16-byte aligned); TX and
// gy: the layout (see the header).  partials: (gy, 2, C) fp32 scratch;
// sums: (2, C) fp32 out.  With stats non-null, also writes stats (5, C):
// mean, var, rstd, scale = gamma*rstd, shift = beta - mean*scale, over
// `count` rows.
extern "C" int hvd_bn_stats(const void* x, long long M, int C, int is_bf16,
                            int vec, int TX, int gy, float* partials,
                            float* sums, const float* gamma, const float* beta,
                            float count, float eps, float* stats,
                            void* stream) {
  if (bad_layout(C, TX, gy)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)HVD_BN_DISPATCH(stats_t, x, M, C, TX, gy, partials, sums, gamma,
                              beta, count, eps, stats, s);
}

// stats (5, C) from sums (2, C) that crossed ranks (the sync-BN path).
extern "C" int hvd_bn_finalize(const float* sums, int C, const float* gamma,
                               const float* beta, float count, float eps,
                               float* stats, void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  bn_finalize<<<(C + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(sums, C, gamma, beta,
                                                     count, eps, stats);
  return (int)cudaGetLastError();
}

// y = x*stats[3] + stats[4] [+ res] [relu]; res may be null.
extern "C" int hvd_bn_apply(const void* x, const void* res, const float* stats,
                            long long M, int C, int is_bf16, int vec, int TX,
                            int gy, int relu, void* y, void* stream) {
  if (bad_layout(C, TX, gy)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)HVD_BN_DISPATCH(apply_t, x, res, stats, M, C, TX, gy, relu, y,
                              s);
}

// sums (2, C) = (sum dy', sum dy'*xhat) with the per-channel mean and
// rstd; y is read only when relu.  partials: (gy, 2, C) scratch.
extern "C" int hvd_bn_bwd_reduce(const void* x, const void* dy, const void* y,
                                 const float* mean, const float* rstd,
                                 long long M, int C,
                                 int is_bf16, int vec, int TX, int gy,
                                 int relu, float* partials, float* sums,
                                 void* stream) {
  if (bad_layout(C, TX, gy)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)HVD_BN_DISPATCH(bwd_reduce_t, x, dy, y, mean, rstd, M, C, TX, gy,
                              relu, partials, sums, s);
}

// dx (and dres = dy' when dres is non-null) from the backward sums over
// `count` rows.
extern "C" int hvd_bn_dx(const void* x, const void* dy, const void* y,
                         const float* gamma, const float* mean,
                         const float* rstd, const float* sums, float count,
                         long long M, int C,
                         int is_bf16, int vec, int TX, int gy, int relu,
                         void* dx, void* dres, void* stream) {
  if (bad_layout(C, TX, gy)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)HVD_BN_DISPATCH(dx_t, x, dy, y, gamma, mean, rstd, sums, count, M, C,
                              TX, gy, relu, dx, dres, s);
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
