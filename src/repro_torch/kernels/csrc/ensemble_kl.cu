// AVGLOGITS KL against raw or pre-averaged teacher logits for Hopper (sm_90a):
// teacher mean + log-softmax + KL in one pass, forward and backward.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/ensemble_kl.py:
//   K2f  _fwd_kernel on rank-3 teachers [K, B, V] (ensemble_kl,     called at :252)
//   K2b  _bwd_kernel on rank-3 teachers           (_bwd_rule,       called at :295)
//   K3f  _fwd_kernel on rank-2 rows [B, V]        (ensemble_kl_pre, called at :252)
//   K3b  _bwd_kernel on rank-2 rows               (_bwd_rule,       called at :295)
// K3 is K2 with K = 1 on the weighted teacher consensus; it has its own entry
// points (and launch counts) so a run can tell the two paths apart.
//   K2s  the forward of K2 over one shard of the vocabulary (ensemble_kl_split_fwd):
//        the same passes write each row's unfinished statistics instead of
//        finishing it, for a model axis that splits the logits by columns.
//        The caller merges the shards' statistics (the max over ranks, then the
//        rescaled sums) and finishes the rows; K2b then runs unchanged on each
//        shard's columns, fed the merged log-sum-exps.  It replaces the same
//        Pallas forward, whose _init_row_stats / _online_step / _emit_row_stats
//        (:66-105) build these statistics before _fwd_kernel finishes a row.
//
// Per row b of the student batch [B, V], as the Pallas kernel orders it
// (_fwd :240-241 divides both inputs by T before the tile takes the mean):
//   s_v = student[b, v] / T
//   t_v = (1/K) * sum_k  round_TT(teacher[k, b, v] / T)     (TT = f32 or bf16)
//   forward:  kl[b] = (St - Ss) / Zt - lse_t + lse_s   plus lse_t[b], lse_s[b]
//             (online logsumexp over V; the loss sum(kl) / B * T^2 is reduced
//             by the caller)
//   backward: ds[b, v] = (exp(s_v - lse_s) - exp(t_v - lse_t)) * (g * T) / B
//             with g read from device memory (no host sync per step); t_v is
//             recomputed from the saved teachers, nothing else is stored.
// The averaged [B, V] teacher rows and the probabilities never exist in
// device memory: the K teachers are summed in registers (stride B*V between
// teachers), element by element.  A lane issues every load of an element
// (student, up to 8 teachers, in the backward also lse and g) before it
// uses any of them: one load latency per element, not one per teacher.
//
// Bound: memory.  The forward reads K*B*V teacher elements and B*V student
// floats and writes 3*B floats; the backward reads the same plus lse and g
// and writes B*V floats.  Arithmetic is ~2K + 14 flops per element, far below
// Hopper's ridge point.  At the paths' shape (K=8, B=64, V=3) a launch moves
// about 7 KB, so the time is the chain of dependent steps between launch and
// store; at a vocabulary-sized V it is whether the launch fills the card.
//
// Forward, three modes; the host picks one (kernels/ensemble_kl.py:plan) and
// passes mode, lanes, cluster size, threads and grid:
//   lanes    (V <= 32) a row gets G = lanes threads, a power of two <= 32; a
//            warp holds 32/G rows.  Lane j walks v = j, j + G, ... with its
//            own online statistics, then the group merges them in log2(G)
//            xor-shuffle rounds: no shared memory, no barrier.  The group's
//            first lane writes the row.
//   cluster  (V > 512, too few rows to fill the SMs) C in {2, 4, 8} blocks
//            of a thread-block cluster share a row, block r the r-th
//            contiguous slice of V (ceil(V / C) elements; the last may be
//            short or empty).  Each block reduces its slice into one Stats
//            in its shared memory; after cluster.sync() rank 0's warp 0
//            reads every rank's Stats through distributed shared memory,
//            one rank a lane, merges them in an xor tree and writes the row;
//            a second cluster.sync() keeps every block's shared memory alive
//            until rank 0 has read it.
//   block    (the rest) one block per row, as a cluster of one.
// A block reduces by xor shuffles inside each warp, then warp 0 merges the
// warps' Stats by xor shuffles too (and rank 0's warp 0 the cluster's, each
// lane reading one rank).  Every merge rescales by exp(m_i - m) in a fixed
// order with no atomics, so two launches on the same inputs give the same
// bits.  The running max starts at -1e30, not -inf, so a lane, warp or block
// that owns no element merges as a zero weight.
//
// Backward: elementwise once lse_t and lse_s are known, so one flat grid over
// the B*V elements, one element a thread (grid-stride past the grid's cap).
//
// Plain C interface, loaded with ctypes.  Each entry point selects the
// tensors' device, launches on the given stream, allocates nothing, does not
// synchronise and returns cudaGetLastError() (or the refused launch's error;
// a plan the kernels cannot run returns cudaErrorInvalidValue).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;  // initial running max, as NEG in the TPU kernel
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

enum Mode : int { kLanes = 0, kCluster = 1, kBlock = 2 };

// x / T in the teacher's own type, as JAX divides a bf16 array by a Python
// float: the quotient is rounded to bf16 before the mean.
template <typename TT> __device__ __forceinline__ float scaled(TT v, float temperature);
template <> __device__ __forceinline__ float scaled<float>(float v, float temperature) {
  return v / temperature;
}
template <> __device__ __forceinline__ float scaled<__nv_bfloat16>(__nv_bfloat16 v,
                                                                   float temperature) {
  return __bfloat162float(__float2bfloat16_rn(__bfloat162float(v) / temperature));
}

// Mean over the K teachers of element `off`, teachers `stride` apart,
// summed in teacher order.  The NB loads of a batch are all issued before
// the first quotient is taken; the plan sets NB from K (1, 4 or 8), so a
// small K runs no dead predicated loads and a large K keeps 8 in flight.
template <int NB, typename TT>
__device__ __forceinline__ float teacher_mean(const TT* __restrict__ t, int64_t off,
                                              int64_t stride, int k_total, float temperature) {
  float acc = 0.f;
  for (int k0 = 0; k0 < k_total; k0 += NB) {
    TT x[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (k0 + j < k_total) x[j] = t[off + (k0 + j) * stride];
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (k0 + j < k_total) acc += scaled(x[j], temperature);
  }
  return acc / static_cast<float>(k_total);
}

// Online statistics of one row (or of a lane's, warp's or block's share):
//   teacher: running max m_t, Zt = sum e^{t-m_t}, St = sum e^{t-m_t} t,
//            Ss = sum e^{t-m_t} s;   student: running max m_s, Zs.
struct Stats {
  float m_t, z_t, st, ss, m_s, z_s;
};

__device__ __forceinline__ Stats empty_stats() {
  Stats a;
  a.m_t = kNeg; a.z_t = 0.f; a.st = 0.f; a.ss = 0.f;
  a.m_s = kNeg; a.z_s = 0.f;
  return a;
}

// One element (student s, teacher mean t, both already divided by T).
__device__ __forceinline__ void push(Stats& a, float s, float t) {
  if (t > a.m_t) {
    const float c = expf(a.m_t - t);
    a.z_t *= c; a.st *= c; a.ss *= c;
    a.m_t = t;
  }
  const float e = expf(t - a.m_t);
  a.z_t += e;
  a.st += e * t;
  a.ss += e * s;
  if (s > a.m_s) {
    a.z_s *= expf(a.m_s - s);
    a.m_s = s;
  }
  a.z_s += expf(s - a.m_s);
}

__device__ __forceinline__ void merge(Stats& a, const Stats& b) {
  const float m = fmaxf(a.m_t, b.m_t);
  const float ca = expf(a.m_t - m), cb = expf(b.m_t - m);
  a.z_t = a.z_t * ca + b.z_t * cb;
  a.st = a.st * ca + b.st * cb;
  a.ss = a.ss * ca + b.ss * cb;
  a.m_t = m;
  const float ms = fmaxf(a.m_s, b.m_s);
  a.z_s = a.z_s * expf(a.m_s - ms) + b.z_s * expf(b.m_s - ms);
  a.m_s = ms;
}

// A lane's elements v = first, first + step, ... below end of the row at
// `base`, pushed in that order.  The student value is loaded before the
// teachers, so both wait on one load latency.
template <int NB, typename TT>
__device__ __forceinline__ void accumulate(Stats& a, const float* __restrict__ student,
                                           const TT* __restrict__ teachers, int64_t base,
                                           int first, int end, int step, int64_t stride,
                                           int k_total, float temperature) {
  for (int v = first; v < end; v += step) {
    const float s = student[base + v];
    const float t = teacher_mean<NB>(teachers, base + v, stride, k_total, temperature);
    push(a, s / temperature, t);
  }
}

__device__ __forceinline__ Stats shfl_xor(const Stats& a, int off) {
  Stats b;
  b.m_t = __shfl_xor_sync(0xffffffffu, a.m_t, off);
  b.z_t = __shfl_xor_sync(0xffffffffu, a.z_t, off);
  b.st = __shfl_xor_sync(0xffffffffu, a.st, off);
  b.ss = __shfl_xor_sync(0xffffffffu, a.ss, off);
  b.m_s = __shfl_xor_sync(0xffffffffu, a.m_s, off);
  b.z_s = __shfl_xor_sync(0xffffffffu, a.z_s, off);
  return b;
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__device__ __forceinline__ void emit(const Stats& a, int64_t row, float* __restrict__ kl,
                                     float* __restrict__ lse_t, float* __restrict__ lse_s) {
  const float lt = a.m_t + logf(a.z_t);
  const float ls = a.m_s + logf(a.z_s);
  kl[row] = (a.st - a.ss) / a.z_t - lt + ls;
  lse_t[row] = lt;
  lse_s[row] = ls;
}

// Split mode: the row's statistics unfinished, six float32 planes of B rows
// (m_t, z_t, st, ss, m_s, z_s) starting at `stats`.
__device__ __forceinline__ void emit_partial(const Stats& a, int64_t row, int64_t b_total,
                                             float* __restrict__ stats) {
  stats[row] = a.m_t;
  stats[b_total + row] = a.z_t;
  stats[2 * b_total + row] = a.st;
  stats[3 * b_total + row] = a.ss;
  stats[4 * b_total + row] = a.m_s;
  stats[5 * b_total + row] = a.z_s;
}

// kPartial: `kl` is the split mode's stats planes, lse_t and lse_s unused.
template <bool kPartial>
__device__ __forceinline__ void store(const Stats& a, int64_t row, int b_total,
                                      float* __restrict__ kl, float* __restrict__ lse_t,
                                      float* __restrict__ lse_s) {
  if constexpr (kPartial) emit_partial(a, row, b_total, kl);
  else emit(a, row, kl, lse_t, lse_s);
}

// Lane-group mode: 2^log2_lanes lanes per row, blockDim.x / 2^log2_lanes rows
// per block.  Every lane of the warp takes part in the shuffles, also those
// past the last row.
template <int NB, typename TT, bool kPartial>
__global__ void __launch_bounds__(kMaxThreads)
kl_fwd_lanes(const float* __restrict__ student, const TT* __restrict__ teachers,
             float* __restrict__ kl, float* __restrict__ lse_t, float* __restrict__ lse_s,
             int k_total, int b_total, int v_total, float temperature, int log2_lanes) {
  const int lanes = 1 << log2_lanes;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> log2_lanes) +
                      (threadIdx.x >> log2_lanes);
  const int lane = threadIdx.x & (lanes - 1);
  Stats a = empty_stats();
  if (row < b_total)
    accumulate<NB>(a, student, teachers, row * v_total, lane, v_total, lanes,
                   static_cast<int64_t>(b_total) * v_total, k_total, temperature);
  for (int off = lanes >> 1; off > 0; off >>= 1) merge(a, shfl_xor(a, off));
  if (lane == 0 && row < b_total) store<kPartial>(a, row, b_total, kl, lse_t, lse_s);
}

// Cluster mode (kCluster) and block mode: row = blockIdx.x / C, and the
// block of cluster rank r reduces the r-th slice of V.
template <int NB, typename TT, bool kCluster, bool kPartial>
__global__ void __launch_bounds__(kMaxThreads)
kl_fwd_rows(const float* __restrict__ student, const TT* __restrict__ teachers,
            float* __restrict__ kl, float* __restrict__ lse_t, float* __restrict__ lse_s,
            int k_total, int b_total, int v_total, float temperature) {
  int rank = 0, c = 1;
  if constexpr (kCluster) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    c = static_cast<int>(cg::this_cluster().num_blocks());
  }
  const int64_t row = blockIdx.x / c;
  const int64_t base = row * v_total;
  const int64_t stride = static_cast<int64_t>(b_total) * v_total;
  const int slice = (v_total + c - 1) / c;
  const int v0 = min(v_total, rank * slice);
  const int v1 = min(v_total, v0 + slice);

  Stats a = empty_stats();
  accumulate<NB>(a, student, teachers, base, v0 + static_cast<int>(threadIdx.x), v1,
                 static_cast<int>(blockDim.x), stride, k_total, temperature);
  for (int off = 16; off > 0; off >>= 1) merge(a, shfl_xor(a, off));

  // the warps' Stats, merged by warp 0 in an xor tree over the next power of
  // two of warps (lanes past the last warp hold empty Stats)
  __shared__ Stats warp_stats[kMaxWarps];
  __shared__ Stats block_stats;   // read by the cluster's rank 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = (blockDim.x + 31) >> 5;
  if (lane == 0) warp_stats[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < n_warps ? warp_stats[lane] : empty_stats();
    for (int off = pow2_at_least(n_warps) >> 1; off > 0; off >>= 1) merge(a, shfl_xor(a, off));
    if (lane == 0) {
      if constexpr (kCluster) block_stats = a;
      else store<kPartial>(a, row, b_total, kl, lse_t, lse_s);
    }
  }
  if constexpr (kCluster) {
    // rank 0's warp 0: lane r reads rank r's Stats through distributed
    // shared memory, all at once, then an xor tree over the C ranks
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0 && warp == 0) {
      a = lane < c ? *cluster.map_shared_rank(&block_stats, lane) : empty_stats();
      for (int off = c >> 1; off > 0; off >>= 1) merge(a, shfl_xor(a, off));
      if (lane == 0) store<kPartial>(a, row, b_total, kl, lse_t, lse_s);
    }
    cluster.sync();   // no block leaves while rank 0 may still read its Stats
  }
}

// Flat backward: element i of the B*V student batch, grid-stride.  Index is
// 32-bit where B*V fits, so the row is a 32-bit division.  At a vocabulary-
// sized V the time is bytes in flight, so every SM should hold 2048
// threads: up to 4 teachers in flight that fits 32 registers (8 blocks of
// 256), with 8 it takes 64.
template <int NB, typename TT, typename Index>
__global__ void __launch_bounds__(kMaxThreads, NB <= 4 ? 8 : 4)
kl_bwd_kernel(const float* __restrict__ student, const TT* __restrict__ teachers,
              const float* __restrict__ lse_t, const float* __restrict__ lse_s,
              const float* __restrict__ g, float* __restrict__ ds, int k_total, int b_total,
              int v_total, float temperature) {
  const Index n = static_cast<Index>(b_total) * static_cast<Index>(v_total);
  const int64_t stride = static_cast<int64_t>(b_total) * v_total;
  const Index step = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index i = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += step) {
    // every load of the element is issued before the teachers are summed
    const Index row = i / static_cast<Index>(v_total);
    const float s = student[i], ls = lse_s[row], lt = lse_t[row], gv = g[0];
    const float t = teacher_mean<NB>(teachers, static_cast<int64_t>(i), stride, k_total,
                                     temperature);
    const float p_s = expf(s / temperature - ls);
    const float p_t = expf(t - lt);
    // d(T^2 * mean kl)/ds = (p_s - p_t) * T / B, times the incoming
    // cotangent; JAX passes g * T to its backward kernel, which divides by B
    // (:294)
    ds[i] = (p_s - p_t) * ((gv * temperature) / static_cast<float>(b_total));
  }
}

bool threads_ok(int threads) {
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0;
}

int log2_exact(int x) {  // -1 unless x is a power of two
  if (x <= 0 || (x & (x - 1)) != 0) return -1;
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

template <int NB, typename TT, bool kPartial>
cudaError_t launch_fwd_typed(const float* s, const TT* t, float* kl, float* lt, float* ls,
                             int k_total, int b_total, int v_total, float temperature, int mode,
                             int lanes, int cluster, int threads, int grid, cudaStream_t st) {
  switch (mode) {
    case kLanes:
      kl_fwd_lanes<NB, TT, kPartial><<<grid, threads, 0, st>>>(
          s, t, kl, lt, ls, k_total, b_total, v_total, temperature, log2_exact(lanes));
      return cudaGetLastError();
    case kBlock:
      kl_fwd_rows<NB, TT, false, kPartial><<<grid, threads, 0, st>>>(
          s, t, kl, lt, ls, k_total, b_total, v_total, temperature);
      return cudaGetLastError();
    case kCluster: {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(grid);
      cfg.blockDim = dim3(threads);
      cfg.dynamicSmemBytes = 0;
      cfg.stream = st;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = cluster;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      const cudaError_t err = cudaLaunchKernelEx(&cfg, kl_fwd_rows<NB, TT, true, kPartial>, s,
                                                 t, kl, lt, ls, k_total, b_total, v_total,
                                                 temperature);
      const cudaError_t last = cudaGetLastError();
      return err != cudaSuccess ? err : last;
    }
    default: return cudaErrorInvalidValue;
  }
}

template <typename TT, bool kPartial>
cudaError_t launch_fwd_batched(int batch, const float* s, const TT* t, float* kl, float* lt,
                               float* ls, int k_total, int b_total, int v_total,
                               float temperature, int mode, int lanes, int cluster,
                               int threads, int grid, cudaStream_t st) {
  switch (batch) {
    case 1:
      return launch_fwd_typed<1, TT, kPartial>(s, t, kl, lt, ls, k_total, b_total, v_total,
                                                 temperature, mode, lanes, cluster, threads,
                                                 grid, st);
    case 4:
      return launch_fwd_typed<4, TT, kPartial>(s, t, kl, lt, ls, k_total, b_total, v_total,
                                                 temperature, mode, lanes, cluster, threads,
                                                 grid, st);
    case 8:
      return launch_fwd_typed<8, TT, kPartial>(s, t, kl, lt, ls, k_total, b_total, v_total,
                                                 temperature, mode, lanes, cluster, threads,
                                                 grid, st);
    default: return cudaErrorInvalidValue;
  }
}

// teacher_kind: 0 float32, 1 bfloat16 (matches kernels/ensemble_kl.py)
template <bool kPartial>
int launch_fwd(const void* student, const void* teachers, void* kl, void* lse_t, void* lse_s,
               int k_total, int b_total, int v_total, float temperature, int teacher_kind,
               int batch, int mode, int lanes, int cluster, int threads, int grid, int device,
               void* stream) {
  if (k_total <= 0 || b_total <= 0 || v_total <= 0 || temperature <= 0.f || grid <= 0 ||
      !threads_ok(threads))
    return static_cast<int>(cudaErrorInvalidValue);
  // the plan must cover every row exactly as the kernels index them
  bool plan_ok = false;
  if (mode == kLanes)
    plan_ok = log2_exact(lanes) >= 0 && lanes <= 32 && cluster == 1 &&
              static_cast<int64_t>(grid) * (threads / lanes) >= b_total &&
              static_cast<int64_t>(grid - 1) * (threads / lanes) < b_total;
  else if (mode == kCluster)
    plan_ok = (cluster == 2 || cluster == 4 || cluster == 8) && lanes == threads &&
              static_cast<int64_t>(b_total) * cluster == grid;
  else if (mode == kBlock)
    plan_ok = cluster == 1 && lanes == threads && grid == b_total;
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(student);
  float* o_kl = static_cast<float*>(kl);
  float* o_lt = static_cast<float*>(lse_t);
  float* o_ls = static_cast<float*>(lse_s);
  switch (teacher_kind) {
    case 0:
      return static_cast<int>(launch_fwd_batched<float, kPartial>(
          batch, s, static_cast<const float*>(teachers), o_kl, o_lt, o_ls, k_total, b_total,
          v_total, temperature, mode, lanes, cluster, threads, grid, st));
    case 1:
      return static_cast<int>(launch_fwd_batched<__nv_bfloat16, kPartial>(
          batch, s, static_cast<const __nv_bfloat16*>(teachers), o_kl, o_lt, o_ls, k_total,
          b_total, v_total, temperature, mode, lanes, cluster, threads, grid, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int NB, typename TT>
cudaError_t launch_bwd_typed(const float* s, const TT* t, const float* lt, const float* ls,
                             const float* gp, float* o, int k_total, int b_total, int v_total,
                             float temperature, int threads, int grid, cudaStream_t st) {
  // 32-bit where the last index plus one grid stride still fits
  if (static_cast<int64_t>(b_total) * v_total + static_cast<int64_t>(grid) * threads <=
      static_cast<int64_t>(UINT32_MAX))
    kl_bwd_kernel<NB, TT, uint32_t><<<grid, threads, 0, st>>>(s, t, lt, ls, gp, o, k_total,
                                                              b_total, v_total, temperature);
  else
    kl_bwd_kernel<NB, TT, int64_t><<<grid, threads, 0, st>>>(s, t, lt, ls, gp, o, k_total,
                                                             b_total, v_total, temperature);
  return cudaGetLastError();
}

template <typename TT>
cudaError_t launch_bwd_batched(int batch, const float* s, const TT* t, const float* lt,
                               const float* ls, const float* gp, float* o, int k_total,
                               int b_total, int v_total, float temperature, int threads,
                               int grid, cudaStream_t st) {
  switch (batch) {
    case 1: return launch_bwd_typed<1>(s, t, lt, ls, gp, o, k_total, b_total, v_total,
                                       temperature, threads, grid, st);
    case 4: return launch_bwd_typed<4>(s, t, lt, ls, gp, o, k_total, b_total, v_total,
                                       temperature, threads, grid, st);
    case 8: return launch_bwd_typed<8>(s, t, lt, ls, gp, o, k_total, b_total, v_total,
                                       temperature, threads, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

int launch_bwd(const void* student, const void* teachers, const void* lse_t, const void* lse_s,
               const void* g, void* ds, int k_total, int b_total, int v_total, float temperature,
               int teacher_kind, int batch, int threads, int grid, int device, void* stream) {
  if (k_total <= 0 || b_total <= 0 || v_total <= 0 || temperature <= 0.f || grid <= 0 ||
      !threads_ok(threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(student);
  const float* lt = static_cast<const float*>(lse_t);
  const float* ls = static_cast<const float*>(lse_s);
  const float* gp = static_cast<const float*>(g);
  float* o = static_cast<float*>(ds);
  switch (teacher_kind) {
    case 0:
      return static_cast<int>(launch_bwd_batched(batch, s, static_cast<const float*>(teachers),
                                                 lt, ls, gp, o, k_total, b_total, v_total,
                                                 temperature, threads, grid, st));
    case 1:
      return static_cast<int>(launch_bwd_batched(
          batch, s, static_cast<const __nv_bfloat16*>(teachers), lt, ls, gp, o, k_total,
          b_total, v_total, temperature, threads, grid, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K2f / K2b: raw teachers [K, B, V].  Both take the plan's teacher batch
// (1, 4 or 8 loads in flight); the forward also its mode (0 lanes,
// 1 cluster, 2 block), lanes per row, cluster size, threads and grid, the
// backward its threads and grid.
extern "C" int ensemble_kl_fwd(const void* student, const void* teachers, void* kl, void* lse_t,
                               void* lse_s, int k_total, int b_total, int v_total,
                               float temperature, int teacher_kind, int batch, int mode,
                               int lanes, int cluster, int threads, int grid, int device,
                               void* stream) {
  return launch_fwd<false>(student, teachers, kl, lse_t, lse_s, k_total, b_total, v_total,
                           temperature, teacher_kind, batch, mode, lanes, cluster, threads, grid,
                           device, stream);
}

// K2s: K2f over one vocabulary shard [K, B, V_loc] -> stats [6, B] float32 (the
// planes m_t, z_t, st, ss, m_s, z_s), with the plan K2f takes at V_loc.
extern "C" int ensemble_kl_split_fwd(const void* student, const void* teachers, void* stats,
                                     int k_total, int b_total, int v_total, float temperature,
                                     int teacher_kind, int batch, int mode, int lanes,
                                     int cluster, int threads, int grid, int device,
                                     void* stream) {
  return launch_fwd<true>(student, teachers, stats, nullptr, nullptr, k_total, b_total, v_total,
                          temperature, teacher_kind, batch, mode, lanes, cluster, threads, grid,
                          device, stream);
}

extern "C" int ensemble_kl_bwd(const void* student, const void* teachers, const void* lse_t,
                               const void* lse_s, const void* g, void* ds, int k_total,
                               int b_total, int v_total, float temperature, int teacher_kind,
                               int batch, int threads, int grid, int device, void* stream) {
  return launch_bwd(student, teachers, lse_t, lse_s, g, ds, k_total, b_total, v_total,
                    temperature, teacher_kind, batch, threads, grid, device, stream);
}

// K3f / K3b: pre-averaged (weighted consensus) rows [B, V], i.e. K = 1.
extern "C" int ensemble_kl_pre_fwd(const void* student, const void* consensus, void* kl,
                                   void* lse_t, void* lse_s, int b_total, int v_total,
                                   float temperature, int teacher_kind, int batch, int mode,
                                   int lanes, int cluster, int threads, int grid, int device,
                                   void* stream) {
  return launch_fwd<false>(student, consensus, kl, lse_t, lse_s, 1, b_total, v_total,
                           temperature, teacher_kind, batch, mode, lanes, cluster, threads, grid,
                           device, stream);
}

extern "C" int ensemble_kl_pre_bwd(const void* student, const void* consensus, const void* lse_t,
                                   const void* lse_s, const void* g, void* ds, int b_total,
                                   int v_total, float temperature, int teacher_kind, int batch,
                                   int threads, int grid, int device, void* stream) {
  return launch_bwd(student, consensus, lse_t, lse_s, g, ds, 1, b_total, v_total, temperature,
                    teacher_kind, batch, threads, grid, device, stream);
}
