// Variant (b) of the fused-norm stats kernel, for tools/bn_stats_ab.py: the
// rows of x reach shared memory through a ring of kRingStages stages of
// 1-D bulk copies (cp.async.bulk, the TMA's untiled form) completing on
// mbarriers, and the threads reduce each stage from shared memory.  The
// A/B tool inserts this file into a copy of csrc/fused_norm.cu after its
// "launches" banner (inside the anonymous namespace, so it sees
// stats_tail, load, Place) and launches bn_stats_ring in place of bn_stats
// on the vector path; it takes bn_stats's arguments and host plan, sums
// each thread's rows in the same order and shares stats_tail, so it gives
// bn_stats's bits (with kAcc = 1).
//
// A stage is kRingStageBytes of the block's column tile: R rows of `seg`
// bytes (seg = W * sizeof(T), 128 on a full tile of 8 vectors), packed;
// one bulk copy a stage where the tile spans the whole row (the stage's
// rows are contiguous in x), else one copy a row, issued by the lanes of
// warp 0.  Thread (tx, ty) then reads vector tx of the stage's rows ty,
// ty + TY, ...  A __syncthreads after each stage frees it for the copy of
// the stage kRingStages later.

constexpr int kRingStages = 4;
constexpr int kRingStageBytes = 8192;

__device__ __forceinline__ uint32_t ring_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ring_wait(uint32_t bar, int parity) {
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

__device__ __forceinline__ void ring_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// warp 0: chunk k (R rows from r0 + k*R) of the block into stage
// k % kRingStages
template <typename T>
__device__ __forceinline__ void ring_issue(const T* xc, long long r0,
                                           long long r1, int C, int seg,
                                           int R, long long k,
                                           unsigned char* ring,
                                           uint64_t* bars) {
  const long long first = r0 + k * R;
  if (first >= r1) return;
  const int nr = (int)min((long long)R, r1 - first);
  const int st = (int)(k % kRingStages);
  const uint32_t bar = ring_smem(&bars[st]);
  const uint32_t dst = ring_smem(ring + (size_t)st * kRingStageBytes);
  const int lane = threadIdx.x & 31;
  if (lane == 0)
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
        "r"(nr * seg)
        : "memory");
  __syncwarp();
  if (seg == C * (int)sizeof(T)) {
    if (lane == 0) ring_copy(dst, xc + first * C, nr * seg, bar);
  } else {
    for (int i = lane; i < nr; i += 32)
      ring_copy(dst + i * seg, xc + (first + i) * C, seg, bar);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kStatsBlocksPerSM)
bn_stats_ring(const T* __restrict__ x, long long M, int C, int TX,
              long long rows, float* partials, unsigned* counters,
              float* sums, const float* gamma, const float* beta, float count,
              float eps, float* stats) {
  static_assert(2 * kThreads * V * 4 <= kRingStages * kRingStageBytes,
                "the tail's slices fit in the ring");
  __shared__ __align__(128) unsigned char ring[kRingStages * kRingStageBytes];
  __shared__ uint64_t bars[kRingStages];
  const Place p = place<V>(C, TX);
  // the tile's vectors and its row segment (fewer on a ragged last tile)
  const int nvec = min(TX, p.CV - (int)blockIdx.x * TX);
  const int seg = nvec * V * (int)sizeof(T);
  const int R = kRingStageBytes / seg;  // rows a stage
  const T* xc = x + (long long)blockIdx.x * TX * V;
  const long long r0 = blockIdx.y * rows;
  const long long r1 = min(M, r0 + rows);
  const long long chunks = (r1 - r0 + R - 1) / R;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRingStages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          ring_smem(&bars[i])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32)
    for (int k = 0; k < kRingStages; ++k)
      ring_issue<T>(xc, r0, r1, C, seg, R, k, ring, bars);
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
  for (long long k = 0; k < chunks; ++k) {
    const int st = (int)(k % kRingStages);
    const int nr = (int)min((long long)R, r1 - r0 - k * R);
    ring_wait(ring_smem(&bars[st]), (int)((k / kRingStages) & 1));
    if (p.tx < nvec) {
      const unsigned char* stage = ring + (size_t)st * kRingStageBytes;
      for (int i = p.ty; i < nr; i += p.TY) {
        float v[V];
        load<T, V>(reinterpret_cast<const T*>(stage + i * seg) + p.tx * V,
                   v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s[j] += v[j];
          q[j] = __fmaf_rn(v[j], v[j], q[j]);
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < 32)
      ring_issue<T>(xc, r0, r1, C, seg, R, k + kRingStages, ring, bars);
  }
  stats_tail<V>(p, C, s, q, reinterpret_cast<float*>(ring), partials,
                counters, sums, gamma, beta, count, eps, stats);
}
