// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): 16-byte vector loads, conversions, warp reductions, and
// the two rules of horovod_tpu/ops/flash_attention.py that every kernel
// must apply identically — the tile mask (_tile_mask) and the K-block
// loop bounds (_kb_range).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvd_flash {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// elements of T in one 16-byte vector
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// floor division for b > 0 (Python / jnp.floor_divide semantics)
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

// _tile_mask: key padding (seq_len), causality, sliding window (symmetric
// when bidirectional) on global positions; kv_off = global K start minus
// global Q start; window <= 0 means none.
__device__ __forceinline__ bool visible(int q_pos, int k_pos, int seq_len,
                                        int kv_off, int causal, int window) {
  const int rel = q_pos - k_pos - kv_off;
  return k_pos < seq_len && (!causal || rel >= 0) &&
         (window <= 0 || (rel < window && (causal || rel > -window)));
}

// _kb_range: [lo, hi) of the K blocks (block_k keys each) that a Q block
// of block_q rows starting at q_off can see.  With q and k swapped, the
// offset negated and causal = 0 it is the dkv kernel's Q-block range,
// whose causal lower bound the caller joins by max (_qb_range).
__device__ __forceinline__ int2 kb_range(int q_off, int block_q, int block_k,
                                         int n_kb, int causal, int window,
                                         int kv_off) {
  int hi = n_kb;
  if (causal) {
    hi = min(hi, floor_div(q_off + block_q - 1 - kv_off, block_k) + 1);
  } else if (window > 0) {
    hi = min(hi, floor_div(q_off + block_q - 1 + window - 1 - kv_off,
                           block_k) + 1);
  }
  const int lo =
      window > 0 ? max(0, floor_div(q_off - (window - 1) - kv_off, block_k))
                 : 0;
  return make_int2(lo, max(hi, 0));
}

// Raise a kernel's dynamic shared memory limit above the default 48 KB
// once per instantiation (the attribute must be set before the launch).
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem, size_t* allowed) {
  if (smem <= *allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *allowed = smem;
  return e;
}

}  // namespace hvd_flash
