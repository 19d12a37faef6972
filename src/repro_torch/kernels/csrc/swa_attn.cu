// Causal flash attention with an optional sliding window for Hopper (sm_90a),
// forward only (K4).
//
// Replaces the Pallas TPU kernel _swa_kernel of src/repro/kernels/swa_attn.py
// (kernel :32, wrapper swa_attn_pallas :72, pallas_call :101).
//
// q, k, v, o: [BH, S, D] contiguous (the caller's [B, H, S, D] with equal
// query and key heads), f32 or bf16 (a template parameter), arithmetic in
// f32.  As _swa_kernel computes it:
//   q is multiplied by scale = 1/sqrt(D) in f32 before q.k;
//   key kp is seen by query qp iff kp <= qp, qp - kp < window (when there is
//   a window), and both are < S;
//   online softmax with f32 running max m (from -1e30), sum l and output o;
//   masked scores take -1e30 and weight 0;
//   out = o / max(l, 1e-30), so a query that sees no key gives 0, not NaN.
//
// Bound: operations.  The function does 4*D flops for every (query, key)
// pair it sees (q.k and p.v): at the serve path's shape (B*H = 128, S = 2000,
// D = 64, no window) that is 6.6e10 f32 flops, ~0.98 ms at 67 TFLOP/s on the
// CUDA cores, against 262 MB of q, k, v and o (~0.08 ms at 3.35 TB/s).
//
// Design (simple and right first; no tensor cores, no TF32): one block of 256
// threads per (batch*head, 64-query tile).  The block loops only over the
// 64-key tiles the mask can reach, from max(0, q0 - window + 1) (or 0) to its
// last query, so the TPU kernel's relative block index map and its clamped
// duplicate blocks are not needed.  The scaled Q tile stays in shared memory;
// each K tile is staged in shared memory, the 64x64 score tile is computed
// with 4x4 register blocking per thread, masked and written to shared memory,
// then the V tile replaces the K tile while each warp runs the online softmax
// of 8 rows; finally every thread adds P.V into its 4 rows x ceil(D/16)
// columns of the output, held in registers.  Rows are padded by one float so
// the strided reads hit distinct banks.  Shared memory is 2 * 64 * (D + 1)
// + 64 * 65 + 192 floats: 50 KB at D = 64 and 146 KB at D = 256, above the
// 48 KB default, so each launch opts in with cudaFuncSetAttribute.  Query
// tiles are issued last tile first: the causal tiles near the end of the
// sequence do the most work.
//
// Plain C interface, loaded with ctypes.  The entry point selects the
// device, launches on the given stream, allocates nothing, does not
// synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kLdP = kBlockK + 1;
constexpr float kNeg = -1e30f;  // NEG of the TPU kernel
static_assert(kBlockQ == kBlockK, "stage() moves 64-row tiles of Q, K and V alike");

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage rows [row0, row0 + 64) of one [S, D] matrix in shared memory (row
// stride ld), as f32 times `mul`; rows at or past S are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int row0,
                                      int s_total, int d, int ld, float mul) {
  for (int e = threadIdx.x; e < kBlockK * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    const int pos = row0 + r;
    dst[r * ld + c] = pos < s_total ? to_f32(src[static_cast<int64_t>(pos) * d + c]) * mul : 0.f;
  }
}

// NC = ceil(D / 16): output columns per thread (tx + 16 * j).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
swa_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, int s_total, int d, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                    // [64][ld]  scaled Q tile
  float* kvs = qs + kBlockQ * ld;      // [64][ld]  K tile, then V tile
  float* ps = kvs + kBlockK * ld;      // [64][kLdP] scores, then weights
  float* m_s = ps + kBlockQ * kLdP;    // [64] running max
  float* l_s = m_s + kBlockQ;          // [64] running sum
  float* a_s = l_s + kBlockQ;          // [64] this tile's rescale

  const int64_t base = static_cast<int64_t>(blockIdx.x) * s_total * d;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;

  stage(qs, q + base, q0, s_total, d, ld, scale);
  if (tid < kBlockQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + kBlockQ, s_total) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kt = k_first / kBlockK; kt <= q_last / kBlockK; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's P.V is done with kvs and ps
    stage(kvs, k + base, k0, s_total, d, ld, 1.f);
    __syncthreads();

    // scores: rows ty*4 + i, columns tx + 16*j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kvs[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool seen = kp <= qp && qp < s_total && kp < s_total &&
                          (window <= 0 || qp - kp < window);
        ps[(ty * 4 + i) * kLdP + tx + 16 * j] = seen ? sc[i][j] : kNeg;
      }
    }
    __syncthreads();

    // the V tile replaces the K tile while each warp runs the online
    // softmax of its 8 rows (two columns per lane)
    stage(kvs, v + base, k0, s_total, d, ld, 1.f);
    for (int rr = 0; rr < kBlockQ / 8; ++rr) {
      const int r = warp * 8 + rr;
      float* prow = ps + r * kLdP;
      const float s0 = prow[lane], s1 = prow[lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = s0 == kNeg ? 0.f : expf(s0 - m_new);
      const float p1 = s1 == kNeg ? 0.f : expf(s1 - m_new);
      prow[lane] = p0;
      prow[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < kBlockK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = tx + 16 * j;
        if (col < d) {
          const float vv = kvs[c * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qp = q0 + r;
    if (qp >= s_total) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + 16 * j;
      if (col < d) o[base + static_cast<int64_t>(qp) * d + col] = from_f32<T>(acc[i][j] / l);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int s_total,
                   int d, int window, float scale, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBlockQ + kBlockK) * (d + 1) + kBlockQ * kLdP +
                       3 * kBlockQ);
  cudaError_t err = cudaFuncSetAttribute(swa_attn_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s_total + kBlockQ - 1) / kBlockQ);
  swa_attn_kernel<T, NC><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s_total, d, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int bh, int s_total,
                     int d, int window, float scale, cudaStream_t st) {
  if (d <= 16) return launch<T, 1>(q, k, v, o, bh, s_total, d, window, scale, st);
  if (d <= 32) return launch<T, 2>(q, k, v, o, bh, s_total, d, window, scale, st);
  if (d <= 64) return launch<T, 4>(q, k, v, o, bh, s_total, d, window, scale, st);
  if (d <= 128) return launch<T, 8>(q, k, v, o, bh, s_total, d, window, scale, st);
  return launch<T, 16>(q, k, v, o, bh, s_total, d, window, scale, st);
}

}  // namespace

// q, k, v, o: [bh, s, d] contiguous; window <= 0 means none (full causal);
// kind 0 = f32, 1 = bf16.
extern "C" int swa_attn_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                            int s_total, int d, int window, float scale, int kind, int device,
                            void* stream) {
  if (bh <= 0 || s_total <= 0 || d <= 0 || d > 256 || (s_total + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return static_cast<int>(dispatch<float>(q, k, v, o, bh, s_total, d, window, scale, st));
    case 1:
      return static_cast<int>(
          dispatch<__nv_bfloat16>(q, k, v, o, bh, s_total, d, window, scale, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
