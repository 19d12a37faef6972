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
// teachers), element by element.
//
// Bound: memory.  The forward reads K*B*V teacher elements and B*V student
// floats and writes 3*B floats; the backward reads the same plus lse and g
// and writes B*V floats.  Arithmetic is ~K + 10 flops per element, far below
// Hopper's ridge point.  At the main path's shape (K=8, B=64, V=3) a launch
// moves about 7 KB, so launch overhead dominates.
//
// Design (simple and correct first): one block per row; the Pallas kernel's
// sequential V grid axis becomes a strided loop inside the block.  Each
// thread keeps its own online statistics, then the block merges them with the
// rescale exp(m_i - m) (warp shuffles, then one pass over the warps in a fixed
// order: no atomics, so results repeat bit for bit).  The running max starts
// at -1e30, not -inf, so a thread that owns no element (V=3 on 32 threads)
// merges as a zero weight.  The ragged tail is masked by the loop bound.
//
// Plain C interface, loaded with ctypes.  Each entry point selects the
// tensors' device, launches on the given stream, allocates nothing, does not
// synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // initial running max, as NEG in the TPU kernel
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

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

// Mean over the K teachers of element `off`, teachers `stride` apart.
template <typename TT>
__device__ __forceinline__ float teacher_mean(const TT* __restrict__ t, int64_t off,
                                              int64_t stride, int k_total, float temperature) {
  float acc = 0.f;
  for (int k = 0; k < k_total; ++k) acc += scaled(t[off + k * stride], temperature);
  return acc / static_cast<float>(k_total);
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

template <typename TT>
__global__ void kl_fwd_kernel(const float* __restrict__ student,
                              const TT* __restrict__ teachers,
                              float* __restrict__ kl,
                              float* __restrict__ lse_t,
                              float* __restrict__ lse_s,
                              int k_total, int b_total, int v_total, float temperature) {
  const int b = blockIdx.x;
  const int64_t row = static_cast<int64_t>(b) * v_total;
  const int64_t stride = static_cast<int64_t>(b_total) * v_total;

  Stats a = empty_stats();
  for (int v = threadIdx.x; v < v_total; v += blockDim.x) {
    const float s = student[row + v] / temperature;
    const float t = teacher_mean(teachers, row + v, stride, k_total, temperature);
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

template <typename TT>
__global__ void kl_bwd_kernel(const float* __restrict__ student,
                              const TT* __restrict__ teachers,
                              const float* __restrict__ lse_t,
                              const float* __restrict__ lse_s,
                              const float* __restrict__ g,
                              float* __restrict__ ds,
                              int k_total, int b_total, int v_total, float temperature) {
  const int b = blockIdx.x;
  const int64_t row = static_cast<int64_t>(b) * v_total;
  const int64_t stride = static_cast<int64_t>(b_total) * v_total;
  const float lt = lse_t[b], ls = lse_s[b];
  // d(T^2 * mean kl)/ds = (p_s - p_t) * T / B, times the incoming cotangent;
  // JAX passes g * T to its backward kernel, which divides by B (:294)
  const float gs = (g[0] * temperature) / static_cast<float>(b_total);
  for (int v = threadIdx.x; v < v_total; v += blockDim.x) {
    const float p_s = expf(student[row + v] / temperature - ls);
    const float p_t = expf(teacher_mean(teachers, row + v, stride, k_total, temperature) - lt);
    ds[row + v] = (p_s - p_t) * gs;
  }
}

int threads_for(int v_total) {
  int t = ((v_total + 31) / 32) * 32;
  if (t < 32) t = 32;
  if (t > kMaxThreads) t = kMaxThreads;
  return t;
}

// teacher_kind: 0 float32, 1 bfloat16 (matches kernels/ensemble_kl.py)
int launch_fwd(const void* student, const void* teachers, void* kl, void* lse_t, void* lse_s,
               int k_total, int b_total, int v_total, float temperature, int teacher_kind,
               int device, void* stream) {
  if (k_total <= 0 || b_total <= 0 || v_total <= 0 || temperature <= 0.f)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(v_total);
  float* o_kl = static_cast<float*>(kl);
  float* o_lt = static_cast<float*>(lse_t);
  float* o_ls = static_cast<float*>(lse_s);
  const float* s = static_cast<const float*>(student);
  switch (teacher_kind) {
    case 0:
      kl_fwd_kernel<float><<<b_total, threads, 0, st>>>(
          s, static_cast<const float*>(teachers), o_kl, o_lt, o_ls, k_total, b_total, v_total,
          temperature);
      break;
    case 1:
      kl_fwd_kernel<__nv_bfloat16><<<b_total, threads, 0, st>>>(
          s, static_cast<const __nv_bfloat16*>(teachers), o_kl, o_lt, o_ls, k_total, b_total,
          v_total, temperature);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const void* student, const void* teachers, const void* lse_t, const void* lse_s,
               const void* g, void* ds, int k_total, int b_total, int v_total, float temperature,
               int teacher_kind, int device, void* stream) {
  if (k_total <= 0 || b_total <= 0 || v_total <= 0 || temperature <= 0.f)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(v_total);
  const float* s = static_cast<const float*>(student);
  const float* lt = static_cast<const float*>(lse_t);
  const float* ls = static_cast<const float*>(lse_s);
  const float* gp = static_cast<const float*>(g);
  float* o = static_cast<float*>(ds);
  switch (teacher_kind) {
    case 0:
      kl_bwd_kernel<float><<<b_total, threads, 0, st>>>(
          s, static_cast<const float*>(teachers), lt, ls, gp, o, k_total, b_total, v_total,
          temperature);
      break;
    case 1:
      kl_bwd_kernel<__nv_bfloat16><<<b_total, threads, 0, st>>>(
          s, static_cast<const __nv_bfloat16*>(teachers), lt, ls, gp, o, k_total, b_total,
          v_total, temperature);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2f / K2b: raw teachers [K, B, V].
extern "C" int ensemble_kl_fwd(const void* student, const void* teachers, void* kl, void* lse_t,
                               void* lse_s, int k_total, int b_total, int v_total,
                               float temperature, int teacher_kind, int device, void* stream) {
  return launch_fwd(student, teachers, kl, lse_t, lse_s, k_total, b_total, v_total, temperature,
                    teacher_kind, device, stream);
}

extern "C" int ensemble_kl_bwd(const void* student, const void* teachers, const void* lse_t,
                               const void* lse_s, const void* g, void* ds, int k_total,
                               int b_total, int v_total, float temperature, int teacher_kind,
                               int device, void* stream) {
  return launch_bwd(student, teachers, lse_t, lse_s, g, ds, k_total, b_total, v_total,
                    temperature, teacher_kind, device, stream);
}

// K3f / K3b: pre-averaged (weighted consensus) rows [B, V], i.e. K = 1.
extern "C" int ensemble_kl_pre_fwd(const void* student, const void* consensus, void* kl,
                                   void* lse_t, void* lse_s, int b_total, int v_total,
                                   float temperature, int teacher_kind, int device,
                                   void* stream) {
  return launch_fwd(student, consensus, kl, lse_t, lse_s, 1, b_total, v_total, temperature,
                    teacher_kind, device, stream);
}

extern "C" int ensemble_kl_pre_bwd(const void* student, const void* consensus, const void* lse_t,
                                   const void* lse_s, const void* g, void* ds, int b_total,
                                   int v_total, float temperature, int teacher_kind, int device,
                                   void* stream) {
  return launch_bwd(student, consensus, lse_t, lse_s, g, ds, 1, b_total, v_total, temperature,
                    teacher_kind, device, stream);
}
