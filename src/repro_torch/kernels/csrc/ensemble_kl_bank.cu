// Fused logit-bank AVGLOGITS KL for Hopper (sm_90a): gather + dequantize +
// log-softmax + KL in one pass, forward and backward.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/ensemble_kl.py:
//   forward   _bank_fwd_kernel  (called from _bank_fwd,      ensemble_kl.py:366)
//   backward  _bank_bwd_kernel  (called from _bank_bwd_rule, ensemble_kl.py:404)
//
// Per row b of the student batch [B, V] it reads bank row idx[b] of the
// resident bank [N, V] (float32 / bfloat16 / int8 / fp8 e4m3), dequantizes
// it in registers as t = bank * (scale[idx[b]] / T) and folds 1/T into the
// student, so neither the gathered nor the dequantized [B, V] teacher rows
// ever exist in device memory.
//
//   forward:  kl[b] = (St - Ss) / Zt - lse_t + lse_s   plus lse_t[b], lse_s[b]
//             (online logsumexp over V; the loss sum(kl) / B * T^2 is reduced
//             by the caller)
//   backward: ds[b, v] = (exp(s/T - lse_s) - exp(t - lse_t)) * (g * T) / B
//             with g read from device memory (no host sync per step).
//
// Bound: memory.  The forward reads B*V student floats, B*V bank elements,
// B indices and B scales, and writes 3*B floats; the backward reads the same
// plus 2*B lse values and writes B*V floats.  Arithmetic is ~10 flops per
// element, far below Hopper's ridge point.  At the main path's shape
// (B=64, V=3) a launch moves about 2 KB, so launch overhead dominates.
//
// Design (simple and correct first): one block per row; the Pallas kernel's
// sequential V grid axis becomes a strided loop inside the block.  Each
// thread keeps its own online statistics, then the block merges them with
// the rescale exp(m_i - m) (warp shuffles, then one pass over the warps in a
// fixed order: no atomics, so results repeat bit for bit).  The ragged tail
// is masked by the loop bound; nothing is padded in memory.
//
// Plain C interface, loaded with ctypes.  Each entry point selects the
// tensors' device, launches on the given stream, allocates nothing, does
// not synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // initial running max, as NEG in the TPU kernel
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

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

// Online statistics of one row (or of a thread's share of it):
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

// Dequant factor of bank row r: scale[r] / T, or 1 / T for unquantized banks.
__device__ __forceinline__ float row_factor(const float* scales, int64_t r, float inv_t) {
  return scales == nullptr ? inv_t : scales[r] * inv_t;
}

template <typename BankT>
__global__ void bank_kl_fwd_kernel(const float* __restrict__ student,
                                   const BankT* __restrict__ bank,
                                   const float* __restrict__ scales,
                                   const int64_t* __restrict__ idx,
                                   float* __restrict__ kl,
                                   float* __restrict__ lse_t,
                                   float* __restrict__ lse_s,
                                   int n_rows, int v_total, float inv_t) {
  const int b = blockIdx.x;
  const int64_t r = idx[b];
  if (r < 0 || r >= n_rows) {  // out-of-range index: poison the row, read nothing
    if (threadIdx.x == 0) kl[b] = lse_t[b] = lse_s[b] = __int_as_float(0x7fc00000);
    return;
  }
  const float tscale = row_factor(scales, r, inv_t);
  const float* s_row = student + static_cast<int64_t>(b) * v_total;
  const BankT* t_row = bank + r * v_total;

  Stats a = empty_stats();
  for (int v = threadIdx.x; v < v_total; v += blockDim.x) {
    const float s = s_row[v] * inv_t;
    const float t = to_f32(t_row[v]) * tscale;
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

  for (int off = 16; off > 0; off >>= 1) merge(a, shfl_xor(a, off));

  __shared__ Stats warp_stats[kMaxWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_stats[warp] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    Stats tot = warp_stats[0];
    const int n_warps = (blockDim.x + 31) >> 5;
    for (int w = 1; w < n_warps; ++w) merge(tot, warp_stats[w]);
    const float lt = tot.m_t + logf(tot.z_t);
    const float ls = tot.m_s + logf(tot.z_s);
    kl[b] = (tot.st - tot.ss) / tot.z_t - lt + ls;
    lse_t[b] = lt;
    lse_s[b] = ls;
  }
}

template <typename BankT>
__global__ void bank_kl_bwd_kernel(const float* __restrict__ student,
                                   const BankT* __restrict__ bank,
                                   const float* __restrict__ scales,
                                   const int64_t* __restrict__ idx,
                                   const float* __restrict__ lse_t,
                                   const float* __restrict__ lse_s,
                                   const float* __restrict__ g,
                                   float* __restrict__ ds,
                                   int n_rows, int v_total, int b_total,
                                   float inv_t, float temperature) {
  const int b = blockIdx.x;
  const int64_t r = idx[b];
  float* ds_row = ds + static_cast<int64_t>(b) * v_total;
  if (r < 0 || r >= n_rows) {
    for (int v = threadIdx.x; v < v_total; v += blockDim.x)
      ds_row[v] = __int_as_float(0x7fc00000);
    return;
  }
  const float tscale = row_factor(scales, r, inv_t);
  const float* s_row = student + static_cast<int64_t>(b) * v_total;
  const BankT* t_row = bank + r * v_total;
  const float lt = lse_t[b], ls = lse_s[b];
  // d(T^2 * mean kl)/ds = (p_s - p_t) * T / B, times the incoming cotangent
  const float gs = (g[0] * temperature) / static_cast<float>(b_total);
  for (int v = threadIdx.x; v < v_total; v += blockDim.x) {
    const float p_s = expf(s_row[v] * inv_t - ls);
    const float p_t = expf(to_f32(t_row[v]) * tscale - lt);
    ds_row[v] = (p_s - p_t) * gs;
  }
}

int threads_for(int v_total) {
  int t = ((v_total + 31) / 32) * 32;
  if (t < 32) t = 32;
  if (t > kMaxThreads) t = kMaxThreads;
  return t;
}

// bank_kind: 0 float32, 1 bfloat16, 2 int8, 3 fp8 e4m3 (matches kernels/ensemble_kl_bank.py)
template <typename BankT>
void launch_fwd(const void* student, const void* bank, const void* scales, const void* idx,
                void* kl, void* lse_t, void* lse_s, int b_total, int n_rows, int v_total,
                float inv_t, cudaStream_t stream) {
  bank_kl_fwd_kernel<BankT><<<b_total, threads_for(v_total), 0, stream>>>(
      static_cast<const float*>(student), static_cast<const BankT*>(bank),
      static_cast<const float*>(scales), static_cast<const int64_t*>(idx),
      static_cast<float*>(kl), static_cast<float*>(lse_t), static_cast<float*>(lse_s),
      n_rows, v_total, inv_t);
}

template <typename BankT>
void launch_bwd(const void* student, const void* bank, const void* scales, const void* idx,
                const void* lse_t, const void* lse_s, const void* g, void* ds, int b_total,
                int n_rows, int v_total, float inv_t, float temperature, cudaStream_t stream) {
  bank_kl_bwd_kernel<BankT><<<b_total, threads_for(v_total), 0, stream>>>(
      static_cast<const float*>(student), static_cast<const BankT*>(bank),
      static_cast<const float*>(scales), static_cast<const int64_t*>(idx),
      static_cast<const float*>(lse_t), static_cast<const float*>(lse_s),
      static_cast<const float*>(g), static_cast<float*>(ds), n_rows, v_total, b_total,
      inv_t, temperature);
}

}  // namespace

extern "C" int ensemble_kl_bank_fwd(const void* student, const void* bank, const void* scales,
                                    const void* idx, void* kl, void* lse_t, void* lse_s,
                                    int b_total, int n_rows, int v_total, float inv_t,
                                    int bank_kind, int device, void* stream) {
  if (b_total <= 0 || v_total <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bank_kind) {
    case 0: launch_fwd<float>(student, bank, scales, idx, kl, lse_t, lse_s, b_total, n_rows, v_total, inv_t, st); break;
    case 1: launch_fwd<__nv_bfloat16>(student, bank, scales, idx, kl, lse_t, lse_s, b_total, n_rows, v_total, inv_t, st); break;
    case 2: launch_fwd<int8_t>(student, bank, scales, idx, kl, lse_t, lse_s, b_total, n_rows, v_total, inv_t, st); break;
    case 3: launch_fwd<__nv_fp8_e4m3>(student, bank, scales, idx, kl, lse_t, lse_s, b_total, n_rows, v_total, inv_t, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ensemble_kl_bank_bwd(const void* student, const void* bank, const void* scales,
                                    const void* idx, const void* lse_t, const void* lse_s,
                                    const void* g, void* ds, int b_total, int n_rows,
                                    int v_total, float inv_t, float temperature, int bank_kind,
                                    int device, void* stream) {
  if (b_total <= 0 || v_total <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bank_kind) {
    case 0: launch_bwd<float>(student, bank, scales, idx, lse_t, lse_s, g, ds, b_total, n_rows, v_total, inv_t, temperature, st); break;
    case 1: launch_bwd<__nv_bfloat16>(student, bank, scales, idx, lse_t, lse_s, g, ds, b_total, n_rows, v_total, inv_t, temperature, st); break;
    case 2: launch_bwd<int8_t>(student, bank, scales, idx, lse_t, lse_s, g, ds, b_total, n_rows, v_total, inv_t, temperature, st); break;
    case 3: launch_bwd<__nv_fp8_e4m3>(student, bank, scales, idx, lse_t, lse_s, g, ds, b_total, n_rows, v_total, inv_t, temperature, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
