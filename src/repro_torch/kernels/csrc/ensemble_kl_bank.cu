// Fused logit-bank AVGLOGITS KL for Hopper (sm_90a): gather + dequantize +
// log-softmax + KL in one pass, forward and backward.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/ensemble_kl.py:
//   forward   _bank_fwd_kernel  (called from _bank_fwd,      ensemble_kl.py:366)
//   backward  _bank_bwd_kernel  (called from _bank_bwd_rule, ensemble_kl.py:404)
//
// Per row b of the student batch [B, V] it reads bank row idx[b] of the
// resident bank [N, V] (float32 / bfloat16 / int8 / fp8 e4m3), dequantizes
// it in registers as t = bank * (scale[idx[b]] * (1/T)) and folds 1/T into
// the student, so neither the gathered nor the dequantized [B, V] teacher
// rows ever exist in device memory.
//
//   forward:  kl[b] = (St - Ss) / Zt - lse_t + lse_s   plus lse_t[b], lse_s[b]
//             (online logsumexp over V; the loss sum(kl) / B * T^2 is reduced
//             by the caller)
//   backward: ds[b, v] = (exp(s/T - lse_s) - exp(t - lse_t)) * (g * T) / B
//             with g read from device memory (no host sync per step).
// An index outside [0, N) reads no bank row: its kl, lse_t, lse_s and every
// ds[b, :] are NaN.  No thread leaves early for it (a predicate, not a
// return), so every lane still reaches each shuffle and every block of a
// cluster each cluster.sync().
//
// Bound: memory.  The forward reads B*V student floats, B*V bank elements,
// B indices and B scales, and writes 3*B floats; the backward reads the same
// plus 2*B lse values and writes B*V floats.  Arithmetic is ~14 flops per
// element, far below Hopper's ridge point.  At the main path's shape
// (B=64, V=3) a launch moves about 2 KB, so the time is the chain of
// dependent loads between launch and store: a thread issues its index load
// beside its first student load, then the scale and the first bank value
// together (both wait on the index), before it uses any of them.  At a
// vocabulary-sized V the time is whether the launch fills the card.
//
// Forward, three modes; the host picks one with the plan K2/K3 use, at
// K = 1 and with K1's own cluster threshold (kernels/ensemble_kl_bank.py:
// plan) and passes mode, lanes, cluster size, threads and grid:
//   lanes    (V <= 32) a row gets G = lanes threads, a power of two <= 32; a
//            warp holds 32/G rows.  Lane j walks v = j, j + G, ... with its
//            own online statistics, then the group merges them in log2(G)
//            xor-shuffle rounds: no shared memory, no barrier.  The group's
//            first lane writes the row.
//   cluster  (V > 4096, too few rows to fill the SMs) C in {2, 4, 8} blocks
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
// warps' Stats by xor shuffles too.  Every merge rescales by exp(m_i - m) in
// a fixed order with no atomics, so two launches on the same inputs give the
// same bits.  The running max starts at -1e30, not -inf, so a lane, warp or
// block that owns no element merges as a zero weight.
//
// Backward: elementwise once lse_t and lse_s are known, so one flat grid over
// the B*V elements, one element a thread, grid-stride past the host's cap of
// one wave of resident blocks.
//
// Stats, push, merge, the shuffles and the cluster merge are copies of those
// in ensemble_kl.cu (K2/K3), which this file does not share a header with.
//
// Plain C interface, loaded with ctypes.  Each entry point selects the
// tensors' device, launches on the given stream, allocates nothing, does not
// synchronise and returns cudaGetLastError() (or the refused launch's error;
// a plan the kernels cannot run returns cudaErrorInvalidValue).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;  // initial running max, as NEG in the TPU kernel
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

enum Mode : int { kLanes = 0, kCluster = 1, kBlock = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);
}
template <> __device__ __forceinline__ float to_f32<__nv_fp8_e4m3>(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

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

// One element (student s, teacher t, both already multiplied by 1/T).
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

// A thread's share of student row `row`: elements v = first, first + step,
// ... below end, pushed in that order.  The index load goes out beside the
// first student load; the scale and the first bank value, which both wait on
// the index, go out together.  `ok` says whether the index is inside
// [0, n_rows); if not, no bank element is read and the share stays empty.
template <typename BankT>
__device__ __forceinline__ Stats share(const float* __restrict__ student,
                                       const BankT* __restrict__ bank,
                                       const float* __restrict__ scales,
                                       const int64_t* __restrict__ idx, int64_t row,
                                       int n_rows, int v_total, int first, int end, int step,
                                       float inv_t, bool& ok) {
  const float* s_row = student + row * v_total;
  const bool any = first < end;
  const float s0 = any ? s_row[first] : 0.f;
  const int64_t r = idx[row];
  ok = r >= 0 && r < n_rows;
  Stats a = empty_stats();
  if (!ok) return a;
  const BankT* t_row = bank + r * v_total;
  const float sc = scales == nullptr ? 1.f : scales[r];
  BankT x0;
  if (any) x0 = t_row[first];
  const float tscale = sc * inv_t;   // scale[r] / T, the Pallas kernel's order
  if (any) push(a, s0 * inv_t, to_f32(x0) * tscale);
  for (int v = first + step; v < end; v += step)
    push(a, s_row[v] * inv_t, to_f32(t_row[v]) * tscale);
  return a;
}

// The row's statistics, or NaN in all three outputs for an index out of range.
__device__ __forceinline__ void emit(const Stats& a, bool ok, int64_t row,
                                     float* __restrict__ kl, float* __restrict__ lse_t,
                                     float* __restrict__ lse_s) {
  if (!ok) {
    kl[row] = lse_t[row] = lse_s[row] = quiet_nan();
    return;
  }
  const float lt = a.m_t + logf(a.z_t);
  const float ls = a.m_s + logf(a.z_s);
  kl[row] = (a.st - a.ss) / a.z_t - lt + ls;
  lse_t[row] = lt;
  lse_s[row] = ls;
}

// Lane-group mode: 2^log2_lanes lanes per row, blockDim.x / 2^log2_lanes rows
// per block.  Every lane of the warp takes part in the shuffles, also those
// past the last row and those of a row whose index is out of range.
template <typename BankT>
__global__ void __launch_bounds__(kMaxThreads)
bank_kl_fwd_lanes(const float* __restrict__ student, const BankT* __restrict__ bank,
               const float* __restrict__ scales, const int64_t* __restrict__ idx,
               float* __restrict__ kl, float* __restrict__ lse_t, float* __restrict__ lse_s,
               int b_total, int n_rows, int v_total, float inv_t, int log2_lanes) {
  const int lanes = 1 << log2_lanes;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> log2_lanes) +
                      (threadIdx.x >> log2_lanes);
  const int lane = threadIdx.x & (lanes - 1);
  bool ok = false;
  Stats a = empty_stats();
  if (row < b_total)
    a = share(student, bank, scales, idx, row, n_rows, v_total, lane, v_total, lanes, inv_t,
              ok);
  for (int off = lanes >> 1; off > 0; off >>= 1) merge(a, shfl_xor(a, off));
  if (lane == 0 && row < b_total) emit(a, ok, row, kl, lse_t, lse_s);
}

// Cluster mode (kCluster) and block mode: row = blockIdx.x / C, and the
// block of cluster rank r reduces the r-th slice of V.  Every block of a
// cluster reaches both cluster.sync() calls, whatever its row's index.
template <typename BankT, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
bank_kl_fwd_rows(const float* __restrict__ student, const BankT* __restrict__ bank,
              const float* __restrict__ scales, const int64_t* __restrict__ idx,
              float* __restrict__ kl, float* __restrict__ lse_t, float* __restrict__ lse_s,
              int b_total, int n_rows, int v_total, float inv_t) {
  int rank = 0, c = 1;
  if constexpr (kCluster) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    c = static_cast<int>(cg::this_cluster().num_blocks());
  }
  const int64_t row = blockIdx.x / c;
  const int slice = (v_total + c - 1) / c;
  const int v0 = min(v_total, rank * slice);
  const int v1 = min(v_total, v0 + slice);

  bool ok;
  Stats a = share(student, bank, scales, idx, row, n_rows, v_total,
                  v0 + static_cast<int>(threadIdx.x), v1, static_cast<int>(blockDim.x), inv_t,
                  ok);
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
      else emit(a, ok, row, kl, lse_t, lse_s);
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
      if (lane == 0) emit(a, ok, row, kl, lse_t, lse_s);
    }
    cluster.sync();   // no block leaves while rank 0 may still read its Stats
  }
}

// Flat backward: element i of the B*V student batch, grid-stride.  Index is
// 32-bit where B*V fits, so the row is a 32-bit division.  The element's
// student value, its row's lse pair, g and its row's index are loaded
// together; the scale and the bank value wait on the index.  At a
// vocabulary-sized V the time is bytes in flight, so every SM should hold
// 2048 threads: 8 blocks of 256 at 32 registers.
template <typename BankT, typename Index>
__global__ void __launch_bounds__(kMaxThreads, 8)
bank_kl_bwd_flat(const float* __restrict__ student, const BankT* __restrict__ bank,
              const float* __restrict__ scales, const int64_t* __restrict__ idx,
              const float* __restrict__ lse_t, const float* __restrict__ lse_s,
              const float* __restrict__ g, float* __restrict__ ds, int b_total, int n_rows,
              int v_total, float inv_t, float temperature) {
  const Index n = static_cast<Index>(b_total) * static_cast<Index>(v_total);
  const Index step = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index i = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += step) {
    const Index row = i / static_cast<Index>(v_total);
    const Index col = i - row * static_cast<Index>(v_total);
    const float s = student[i], ls = lse_s[row], lt = lse_t[row], gv = g[0];
    const int64_t r = idx[row];
    float out = quiet_nan();
    if (r >= 0 && r < n_rows) {
      const float sc = scales == nullptr ? 1.f : scales[r];
      const BankT x = bank[r * v_total + static_cast<int64_t>(col)];
      const float p_s = expf(s * inv_t - ls);
      const float p_t = expf(to_f32(x) * (sc * inv_t) - lt);
      // d(T^2 * mean kl)/ds = (p_s - p_t) * T / B, times the incoming cotangent
      out = (p_s - p_t) * ((gv * temperature) / static_cast<float>(b_total));
    }
    ds[i] = out;
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

// the plan must cover every row exactly as the forward kernels index them
bool fwd_plan_ok(int b_total, int mode, int lanes, int cluster, int threads, int grid) {
  if (grid <= 0 || !threads_ok(threads)) return false;
  if (mode == kLanes)
    return log2_exact(lanes) >= 0 && lanes <= 32 && cluster == 1 &&
           static_cast<int64_t>(grid) * (threads / lanes) >= b_total &&
           static_cast<int64_t>(grid - 1) * (threads / lanes) < b_total;
  if (mode == kCluster)
    return (cluster == 2 || cluster == 4 || cluster == 8) && lanes == threads &&
           static_cast<int64_t>(b_total) * cluster == grid;
  if (mode == kBlock) return cluster == 1 && lanes == threads && grid == b_total;
  return false;
}

template <typename BankT>
cudaError_t launch_fwd(const void* student, const void* bank, const void* scales,
                       const void* idx, void* kl, void* lse_t, void* lse_s, int b_total,
                       int n_rows, int v_total, float inv_t, int mode, int lanes, int cluster,
                       int threads, int grid, cudaStream_t st) {
  const float* s = static_cast<const float*>(student);
  const BankT* t = static_cast<const BankT*>(bank);
  const float* sc = static_cast<const float*>(scales);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  float* o_kl = static_cast<float*>(kl);
  float* o_lt = static_cast<float*>(lse_t);
  float* o_ls = static_cast<float*>(lse_s);
  switch (mode) {
    case kLanes:
      bank_kl_fwd_lanes<BankT><<<grid, threads, 0, st>>>(s, t, sc, ix, o_kl, o_lt, o_ls, b_total,
                                                      n_rows, v_total, inv_t,
                                                      log2_exact(lanes));
      return cudaGetLastError();
    case kBlock:
      bank_kl_fwd_rows<BankT, false><<<grid, threads, 0, st>>>(s, t, sc, ix, o_kl, o_lt, o_ls,
                                                            b_total, n_rows, v_total, inv_t);
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
      const cudaError_t err = cudaLaunchKernelEx(&cfg, bank_kl_fwd_rows<BankT, true>, s, t, sc, ix,
                                                 o_kl, o_lt, o_ls, b_total, n_rows, v_total,
                                                 inv_t);
      const cudaError_t last = cudaGetLastError();
      return err != cudaSuccess ? err : last;
    }
    default: return cudaErrorInvalidValue;
  }
}

template <typename BankT>
cudaError_t launch_bwd(const void* student, const void* bank, const void* scales,
                       const void* idx, const void* lse_t, const void* lse_s, const void* g,
                       void* ds, int b_total, int n_rows, int v_total, float inv_t,
                       float temperature, int threads, int grid, cudaStream_t st) {
  const float* s = static_cast<const float*>(student);
  const BankT* t = static_cast<const BankT*>(bank);
  const float* sc = static_cast<const float*>(scales);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  const float* lt = static_cast<const float*>(lse_t);
  const float* ls = static_cast<const float*>(lse_s);
  const float* gp = static_cast<const float*>(g);
  float* o = static_cast<float*>(ds);
  // 32-bit where the last index plus one grid stride still fits
  if (static_cast<int64_t>(b_total) * v_total + static_cast<int64_t>(grid) * threads <=
      static_cast<int64_t>(UINT32_MAX))
    bank_kl_bwd_flat<BankT, uint32_t><<<grid, threads, 0, st>>>(s, t, sc, ix, lt, ls, gp, o,
                                                             b_total, n_rows, v_total, inv_t,
                                                             temperature);
  else
    bank_kl_bwd_flat<BankT, int64_t><<<grid, threads, 0, st>>>(s, t, sc, ix, lt, ls, gp, o,
                                                            b_total, n_rows, v_total, inv_t,
                                                            temperature);
  return cudaGetLastError();
}

}  // namespace

// K1f.  bank_kind: 0 float32, 1 bfloat16, 2 int8, 3 fp8 e4m3 (matches
// kernels/ensemble_kl_bank.py); then the plan's mode (0 lanes, 1 cluster,
// 2 block), lanes per row, cluster size, threads and grid.
extern "C" int ensemble_kl_bank_fwd(const void* student, const void* bank, const void* scales,
                                    const void* idx, void* kl, void* lse_t, void* lse_s,
                                    int b_total, int n_rows, int v_total, float inv_t,
                                    int bank_kind, int mode, int lanes, int cluster,
                                    int threads, int grid, int device, void* stream) {
  if (b_total <= 0 || n_rows < 0 || v_total <= 0 ||
      !fwd_plan_ok(b_total, mode, lanes, cluster, threads, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bank_kind) {
    case 0: err = launch_fwd<float>(student, bank, scales, idx, kl, lse_t, lse_s, b_total, n_rows, v_total, inv_t, mode, lanes, cluster, threads, grid, st); break;
    case 1: err = launch_fwd<__nv_bfloat16>(student, bank, scales, idx, kl, lse_t, lse_s, b_total, n_rows, v_total, inv_t, mode, lanes, cluster, threads, grid, st); break;
    case 2: err = launch_fwd<int8_t>(student, bank, scales, idx, kl, lse_t, lse_s, b_total, n_rows, v_total, inv_t, mode, lanes, cluster, threads, grid, st); break;
    case 3: err = launch_fwd<__nv_fp8_e4m3>(student, bank, scales, idx, kl, lse_t, lse_s, b_total, n_rows, v_total, inv_t, mode, lanes, cluster, threads, grid, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// K1b: the plan's flat backward grid, threads and blocks.
extern "C" int ensemble_kl_bank_bwd(const void* student, const void* bank, const void* scales,
                                    const void* idx, const void* lse_t, const void* lse_s,
                                    const void* g, void* ds, int b_total, int n_rows,
                                    int v_total, float inv_t, float temperature, int bank_kind,
                                    int threads, int grid, int device, void* stream) {
  if (b_total <= 0 || n_rows < 0 || v_total <= 0 || grid <= 0 || !threads_ok(threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bank_kind) {
    case 0: err = launch_bwd<float>(student, bank, scales, idx, lse_t, lse_s, g, ds, b_total, n_rows, v_total, inv_t, temperature, threads, grid, st); break;
    case 1: err = launch_bwd<__nv_bfloat16>(student, bank, scales, idx, lse_t, lse_s, g, ds, b_total, n_rows, v_total, inv_t, temperature, threads, grid, st); break;
    case 2: err = launch_bwd<int8_t>(student, bank, scales, idx, lse_t, lse_s, g, ds, b_total, n_rows, v_total, inv_t, temperature, threads, grid, st); break;
    case 3: err = launch_bwd<__nv_fp8_e4m3>(student, bank, scales, idx, lse_t, lse_s, g, ds, b_total, n_rows, v_total, inv_t, temperature, threads, grid, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
