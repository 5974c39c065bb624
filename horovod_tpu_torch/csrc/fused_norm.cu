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
//     sequential grid in one VMEM buffer.  Here blocks run in no order.
//   * The stats kernel (bn_stats) is one launch a site.  Its bound is the
//     bytes of x (a ResNet-50 step's 53 sites: 2.85 GB, 0.85 ms at the
//     data-sheet rate), and its smaller sites (6-50 MB) last a few
//     microseconds, so a second launch and a one-wave ramp cost as much
//     as the read.  Each block reduces a contiguous range of rows (a
//     host plan, ops/fused_norm.py _stats_plan, from the SM count) with
//     kLoads 16-byte loads a thread in flight, writes fp32 per-channel
//     partials to a (blocks, 2, C) scratch tensor, fences and takes a
//     ticket on its column tile's counter; the block that draws the last
//     ticket sums the tile's partials and writes the sums (and the
//     statistics), then sets the counter back to 0 for the next launch.
//     It reads the partials through L2 (__ldcg): they were written by
//     other blocks of this launch, and L1 or the read-only path may hold
//     stale lines.  Every sum runs in an order fixed by thread and block
//     index, whichever block finishes (a thread's rows in row order, the
//     block's row threads pairwise, the partials in strided slices of
//     block indices, the slices pairwise), so a site gives the same bits
//     on every run; the host plan keeps every sequential chain at or
//     under 500 terms (the tolerance of the chip check rests on it).
//   * _bwd_reduce_kernel takes two passes and no atomics: each block
//     reduces a grid-strided set of rows into partials, and a small
//     finishing kernel (bn_reduce_partials) sums them in a fixed order.
//   * The C-length arithmetic between the kernels (mean, var, rstd, scale,
//     shift: XLA's part in JAX) is the stats kernel's last block's tail
//     (finalize_channel), or, when the sums cross ranks first (sync BN), a
//     launch of its own after the wrapper's all-reduce; the dx kernel forms
//     g*rstd, sdb/M and sdg/M per channel itself.
//   * No lane folding: that existed for the TPU's 128-lane registers.  Any
//     M >= 1 and C >= 1 run.  A thread owns a fixed group of channels (one
//     16-byte vector: 8 bf16 or 4 fp32; one element on the scalar path,
//     taken when C is not a multiple of the vector or a pointer is not
//     16-byte aligned) and walks rows, so a warp reads whole rows (or runs
//     of rows when C is narrow) contiguously.
//
// Block: 256 threads as TX x TY, TX (a power of two <= 32) threads across
// the channel vectors, TY = 256 / TX down the rows; grid (gx, gy) with
// gx = ceil((C / V) / TX) column tiles.  The wrapper picks TX and gy
// (ops/fused_norm.py: _stats_plan for the stats kernel, _layout for the
// others) and sizes the partials from gy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxV = 8;  // elements of one 16-byte bf16 vector
constexpr int kReduceBlocksPerSM = 4;  // the wrapper launches one wave
// the stats kernel: loads of x a thread keeps in flight, the accumulator
// pairs it sums them into (load u into pair u % kAcc), and the resident
// blocks an SM its register budget allows (ops/fused_norm.py mirrors the
// first two; its plan launches at most this many blocks an SM)
constexpr int kLoads = 8;
constexpr int kAcc = 1;
constexpr int kStatsBlocksPerSM = 2;
static_assert(kLoads % kAcc == 0, "a round of loads fills each pair alike");

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

// V fp32 values written by other blocks of this launch, read from L2.
template <int V>
__device__ __forceinline__ void load_cg(const float* p, float* out);

template <>
__device__ __forceinline__ void load_cg<1>(const float* p, float* out) {
  out[0] = __ldcg(p);
}
template <>
__device__ __forceinline__ void load_cg<4>(const float* p, float* out) {
  const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <>
__device__ __forceinline__ void load_cg<8>(const float* p, float* out) {
  load_cg<4>(p, out);
  load_cg<4>(p + 4, out + 4);
}

// Pairwise tree over n (a power of two) slices of `stride` floats in
// shared memory: slice s += slice s + h for h = n/2, n/4, ..., 1, so slice
// 0 ends with the sum.  Every thread of the block calls it.
__device__ __forceinline__ void slice_tree(float* sh, int n, int stride) {
  for (int h = n / 2; h > 0; h /= 2) {
    for (int i = threadIdx.x; i < h * stride; i += kThreads)
      sh[i] += sh[i + h * stride];
    __syncthreads();
  }
}

// The stats kernel's tail, from each thread's sums s, q of its V channels
// (zero for a thread without channels) and `sh`, 2 * kThreads * V floats
// of shared memory: the block's TY row threads summed in a pairwise tree
// into its partials (blockIdx.y, {0, 1}, C), the fence, the ticket on
// column tile blockIdx.x's counter, and in the tile's last block the
// finish: the tile's gridDim.y partials summed by 2*TX lanes (k, vector)
// in 256 / (2*TX) slices, slice sl taking partials sl, sl + S, ... in
// order, the slices then in a pairwise tree; sums written, and with stats
// non-null the finalize; the counter set back to 0.
template <int V>
__device__ __forceinline__ void stats_tail(
    const Place& p, int C, const float* s, const float* q, float* sh,
    float* partials, unsigned* counters, float* sums, const float* gamma,
    const float* beta, float count, float eps, float* stats) {
  __shared__ bool last;
  const int TX = kThreads / p.TY;
  const int W = TX * V;  // channels of a column tile, and a slice's half
  const int c0 = blockIdx.x * W;
  const int gy = gridDim.y;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sh[p.ty * 2 * W + p.tx * V + i] = s[i];
    sh[p.ty * 2 * W + W + p.tx * V + i] = q[i];
  }
  __syncthreads();
  slice_tree(sh, p.TY, 2 * W);
  for (int e = threadIdx.x; e < 2 * W; e += kThreads) {
    const int j = e % W;
    if (c0 + j < C)
      partials[((long long)blockIdx.y * 2 + e / W) * C + c0 + j] = sh[e];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&counters[blockIdx.x], 1u) == (unsigned)gy - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lanes = 2 * TX;
  const int S = kThreads / lanes;
  const int lane = threadIdx.x % lanes;
  const int sl = threadIdx.x / lanes;
  const int col = blockIdx.x * TX + lane % TX;
  float tot[V];
#pragma unroll
  for (int i = 0; i < V; ++i) tot[i] = 0.f;
  if (col < p.CV) {
    const float* pc =
        partials + (long long)(lane / TX) * C + (long long)col * V;
    for (int j = sl; j < gy; j += kLoads * S) {
      float t[kLoads][V];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (j + u * S < gy)
          load_cg<V>(pc + (long long)(j + u * S) * 2 * C, t[u]);
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (j + u * S < gy)
#pragma unroll
          for (int i = 0; i < V; ++i) tot[i] += t[u][i];
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) sh[threadIdx.x * V + i] = tot[i];
  __syncthreads();
  slice_tree(sh, S, 2 * W);
  for (int j = threadIdx.x; j < W && c0 + j < C; j += kThreads) {
    sums[c0 + j] = sh[j];
    sums[C + c0 + j] = sh[W + j];
    if (stats != nullptr)
      finalize_channel(c0 + j, C, sh[j], sh[W + j], gamma, beta, count, eps,
                       stats);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

// _stats_kernel: sums (2, C) = per-channel sum x and sum x^2 in one launch
// (see the header).  Block (bx, by) reduces rows [by*rows, (by+1)*rows) of
// column tile bx (TX*V channels): thread (tx, ty) takes the tile's vector
// tx of rows ty, ty + TY, ..., kLoads of them in flight, summed in row
// order (row n of the thread into pair n % kAcc, the pairs then in order);
// then stats_tail.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kStatsBlocksPerSM)
bn_stats(const T* __restrict__ x, long long M, int C, int TX, long long rows,
         float* partials, unsigned* counters, float* sums,
         const float* gamma, const float* beta, float count, float eps,
         float* stats) {
  __shared__ float sh[2 * kThreads * V];
  const Place p = place<V>(C, TX);
  float s[kAcc][V], q[kAcc][V];
#pragma unroll
  for (int a = 0; a < kAcc; ++a)
#pragma unroll
    for (int i = 0; i < V; ++i) s[a][i] = q[a][i] = 0.f;
  if (p.col < p.CV) {
    const T* xc = x + (long long)p.col * V;
    const long long r1 = min(M, (blockIdx.y + 1) * rows);
    long long r = blockIdx.y * rows + p.ty;
    for (; r + (kLoads - 1) * p.TY < r1; r += kLoads * p.TY) {
      float v[kLoads][V];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        load<T, V>(xc + (r + u * p.TY) * C, v[u]);
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[u % kAcc][i] += v[u][i];
          q[u % kAcc][i] = __fmaf_rn(v[u][i], v[u][i], q[u % kAcc][i]);
        }
    }
    // the last round: fewer than kLoads rows left for this thread
    float v[kLoads][V];
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (r + u * p.TY < r1) load<T, V>(xc + (r + u * p.TY) * C, v[u]);
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (r + u * p.TY < r1)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[u % kAcc][i] += v[u][i];
          q[u % kAcc][i] = __fmaf_rn(v[u][i], v[u][i], q[u % kAcc][i]);
        }
#pragma unroll
    for (int a = 1; a < kAcc; ++a)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[0][i] += s[a][i];
        q[0][i] += q[a][i];
      }
  }
  stats_tail<V>(p, C, s[0], q[0], sh, partials, counters, sums, gamma, beta,
                count, eps, stats);
}

// Pass 2 of the backward reduction: sums (2, C) = the partials summed over
// their nparts blocks in a fixed order (32 channels x 8 slices a block,
// each slice a strided sequence, the slices then added in order).
__global__ void __launch_bounds__(kThreads)
bn_reduce_partials(const float* __restrict__ partials, int nparts, int C,
                   float* __restrict__ sums) {
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
                    long long rows, float* partials, unsigned* counters,
                    float* sums, const float* gamma, const float* beta,
                    float count, float eps, float* stats, cudaStream_t s) {
  bn_stats<T, V><<<grid_of(C, V, TX, gy), kThreads, 0, s>>>(
      static_cast<const T*>(x), M, C, TX, rows, partials, counters, sums,
      gamma, beta, count, eps, stats);
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
  bn_reduce_partials<<<reduce_grid(C), kThreads, 0, s>>>(partials, gy, C,
                                                         sums);
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
// (C a multiple of the vector, every row pointer 16-byte aligned); TX, gy
// and rows: the plan (ops/fused_norm.py _stats_plan; block y of a column
// tile takes rows [y*rows, min(M, (y+1)*rows)), none empty).  partials:
// (gy, 2, C) fp32 scratch; counters: one zero uint32 per column tile, left
// zero; sums: (2, C) fp32 out.  With stats non-null, also writes stats
// (5, C): mean, var, rstd, scale = gamma*rstd, shift = beta - mean*scale,
// over `count` rows.
extern "C" int hvd_bn_stats(const void* x, long long M, int C, int is_bf16,
                            int vec, int TX, int gy, long long rows,
                            float* partials, unsigned* counters, float* sums,
                            const float* gamma, const float* beta,
                            float count, float eps, float* stats,
                            void* stream) {
  if (bad_layout(C, TX, gy) || M < 1 || rows < 1 ||
      (long long)(gy - 1) * rows >= M || (long long)gy * rows < M)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)HVD_BN_DISPATCH(stats_t, x, M, C, TX, gy, rows, partials,
                              counters, sums, gamma, beta, count, eps, stats,
                              s);
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
