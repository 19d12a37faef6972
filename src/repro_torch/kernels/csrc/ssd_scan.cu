// Mamba2 chunked SSD scan (state space duality) for Hopper (sm_90a), forward
// only (K5).
//
// Replaces the Pallas TPU kernel _ssd_kernel of src/repro/kernels/ssd_scan.py
// (kernel :28, wrapper ssd_scan_pallas :72, pallas_call :96).
//
// x: [B, S, H, P], dt: [B, S, H] f32, a_log: [H] f32, bmat / cmat: [B, S, N]
// (x, bmat and cmat f32 or bf16, a template parameter; arithmetic in f32).
// B and C are shared across heads (n_groups = 1).  Per head, with
// a = -exp(a_log) and, within each chunk, cum = cumsum(dt * a) and the
// segment sums seg_ij = sum_{k=j+1..i} dt_k a (= cum_i - cum_j):
//   y_i    = sum_{j <= i} (C_i . B_j) exp(seg_ij) dt_j x_j             (intra)
//          + exp(cum_i) C_i . state                                 (inter)
//   state <- exp(cum_last) state + sum_j exp(seg_last,j) dt_j B_j (x) x_j
// from state = 0.  Steps past S get dt = 0 (no input, no decay).  y comes
// out in x's dtype (D * x is added by the caller, as in the JAX model), and
// the final f32 state [B, H, N, P] is written too: the prefill cache needs
// it, and the Pallas kernel drops it.
//
// Chunk: 64 steps, whatever chunk the caller's config names.  The function
// does not depend on the chunk up to rounding; the config's 256 would need a
// 256 x 256 f32 decay matrix (256 KB) per head, more than a block's 227 KB of
// shared memory.  The upper triangle is masked before the exp, as
// ssd_chunked does (the Pallas kernel takes exp first, which can overflow).
// The segment sums are summed directly, one column per thread, and not
// taken as cum_i - cum_j as ssd_chunked and the Pallas kernel take them:
// with dt * A up to ~1e3 per step (zamba2's init at full width) the
// cumulative sums reach ~1e5 within a chunk, and their difference loses
// ~eps * 1e5 = 0.01 in the exponent, i.e. percent-level errors in y.
//
// Bound: operations.  Per (batch, head, chunk of L = 64 steps): 2*L*N*P
// (inter) + L(L+1)*N (C.B, lower triangle) + L(L+1)*P (intra) + 2*L*N*P
// (state) + L(L-1)/2 (segment sums), plus O(L*P) elementwise.  At the
// serve path's shape (B = 4, S = 2000, H = 64, P = 64, N = 64) that is
// 1.3e10 f32 flops, ~0.19 ms at 67 TFLOP/s, against ~270 MB of x, y, dt, B,
// C and the final state (~0.08 ms at 3.35 TB/s).
//
// Design (simple and right first; no tensor cores): one block of 256 threads
// per (batch, head).  The Pallas grid's sequential chunk axis becomes a loop
// inside the block, and the f32 state [N, P] stays in shared memory across
// chunks (16 KB at N = P = 64, 32 KB at N = 128).  Per chunk: stage x, dt, B
// and C (zero past S); one warp scans dt * a while 64 threads sum the
// segments, one column each; the 64 x 64 kernel matrix
// (C.B) * exp(seg_ij) * dt_j, zero above the diagonal, is built with
// 4 x 4 register blocking; y (intra over j <= i, plus inter against the old
// state) is written with each thread holding 4 rows x ceil(P/16) columns; then
// the state update, each thread holding ceil(N/16) x ceil(P/16) entries.
// Rows are padded by one float so strided reads hit distinct banks.  Shared
// memory is 84 KB at N = P = 64 and 133 KB at N = 128, so each launch opts in
// with cudaFuncSetAttribute.
//
// Plain C interface, loaded with ctypes.  The entry point selects the
// device, launches on the given stream, allocates nothing, does not
// synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;
constexpr int kThreads = 256;
constexpr int kLdK = kChunk + 1;

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

// PC = ceil(P / 16) columns per thread (tx + 16 * pp); NR = ceil(N / 16)
// state rows per thread (ty + 16 * nn).
template <typename T, int PC, int NR>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y, float* __restrict__ final_state,
                int s_total, int h_total, int p_dim, int n_dim) {
  extern __shared__ float smem[];
  const int ldp = p_dim + 1, ldn = n_dim + 1;
  float* xs = smem;                  // [L][ldp]
  float* bs = xs + kChunk * ldp;     // [L][ldn]
  float* cs = bs + kChunk * ldn;     // [L][ldn]
  float* st = cs + kChunk * ldn;     // [N][ldp]  the running state
  float* kern = st + n_dim * ldp;    // [L][kLdK]
  float* dts = kern + kChunk * kLdK; // [L]
  float* cum = dts + kChunk;         // [L]
  float* wts = cum + kChunk;         // [L]  exp(seg_last,j) * dt_j

  const int b = blockIdx.x / h_total, h = blockIdx.x - b * h_total;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const float a = -expf(a_log[h]);

  for (int e = tid; e < n_dim * p_dim; e += kThreads) {
    const int n = e / p_dim;
    st[n * ldp + e - n * p_dim] = 0.f;
  }

  for (int c0 = 0; c0 < s_total; c0 += kChunk) {
    __syncthreads();  // the previous chunk is done with every buffer
    for (int e = tid; e < kChunk * p_dim; e += kThreads) {
      const int t = e / p_dim, p = e - t * p_dim;
      const int pos = c0 + t;
      xs[t * ldp + p] =
          pos < s_total
              ? to_f32(x[((static_cast<int64_t>(b) * s_total + pos) * h_total + h) * p_dim + p])
              : 0.f;
    }
    for (int e = tid; e < kChunk * n_dim; e += kThreads) {
      const int t = e / n_dim, n = e - t * n_dim;
      const int pos = c0 + t;
      const int64_t off = (static_cast<int64_t>(b) * s_total + pos) * n_dim + n;
      bs[t * ldn + n] = pos < s_total ? to_f32(bm[off]) : 0.f;
      cs[t * ldn + n] = pos < s_total ? to_f32(cm[off]) : 0.f;
    }
    if (tid < kChunk) {
      const int pos = c0 + tid;
      dts[tid] = pos < s_total ? dt[(static_cast<int64_t>(b) * s_total + pos) * h_total + h] : 0.f;
    }
    __syncthreads();

    // cum = cumsum(dt * a): one warp, two steps per lane.  Meanwhile the
    // segment sums seg[i][j] = sum_{k=j+1..i} dt_k * a (i >= j), one column
    // per thread, into the kernel matrix's buffer: taken directly, not as
    // cum_i - cum_j, whose f32 rounding (~eps * |cum|) swamps short
    // segments once the sums reach ~1e5.  The last row gives the suffix
    // sums for the state update.
    if (tid < 32) {
      const float v0 = dts[2 * tid] * a, v1 = dts[2 * tid + 1] * a;
      const float pair = v0 + v1;
      float incl = pair;
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float excl = incl - pair;
      cum[2 * tid] = excl + v0;
      cum[2 * tid + 1] = incl;
    } else if (tid >= 64 && tid < 64 + kChunk) {
      const int j = tid - 64;
      float seg = 0.f;
      kern[j * kLdK + j] = 0.f;
      for (int i = j + 1; i < kChunk; ++i) {
        seg += dts[i] * a;
        kern[i * kLdK + j] = seg;
      }
      wts[j] = expf(seg) * dts[j];  // exp(sum_{k>j} dt_k a) * dt_j
    }
    __syncthreads();

    // kernel matrix: rows i = ty*4 + ii, columns j = tx + 16*jj; the mask
    // comes before the exp (the upper triangle holds no segment sum)
    {
      float cb[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) cb[ii][jj] = 0.f;
      for (int n = 0; n < n_dim; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) cv[ii] = cs[(ty * 4 + ii) * ldn + n];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bv[jj] = bs[(tx + 16 * jj) * ldn + n];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) cb[ii][jj] = fmaf(cv[ii], bv[jj], cb[ii][jj]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = ty * 4 + ii;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = tx + 16 * jj;
          kern[i * kLdK + j] = j <= i ? cb[ii][jj] * expf(kern[i * kLdK + j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y: rows i = ty*4 + ii, columns p = tx + 16*pp
    {
      float acc[4][PC];
      float inter[4][PC];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int pp = 0; pp < PC; ++pp) acc[ii][pp] = inter[ii][pp] = 0.f;
      for (int n = 0; n < n_dim; ++n) {
        float cv[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) cv[ii] = cs[(ty * 4 + ii) * ldn + n];
#pragma unroll
        for (int pp = 0; pp < PC; ++pp) {
          const int p = tx + 16 * pp;
          if (p < p_dim) {
            const float sv = st[n * ldp + p];
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) inter[ii][pp] = fmaf(cv[ii], sv, inter[ii][pp]);
          }
        }
      }
      const int j_end = ty * 4 + 4;  // kern is zero above the diagonal
      for (int j = 0; j < j_end; ++j) {
        float kv[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) kv[ii] = kern[(ty * 4 + ii) * kLdK + j];
#pragma unroll
        for (int pp = 0; pp < PC; ++pp) {
          const int p = tx + 16 * pp;
          if (p < p_dim) {
            const float xv = xs[j * ldp + p];
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) acc[ii][pp] = fmaf(kv[ii], xv, acc[ii][pp]);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = ty * 4 + ii;
        const int pos = c0 + i;
        if (pos >= s_total) continue;
        const float e = expf(cum[i]);
        T* yrow = y + ((static_cast<int64_t>(b) * s_total + pos) * h_total + h) * p_dim;
#pragma unroll
        for (int pp = 0; pp < PC; ++pp) {
          const int p = tx + 16 * pp;
          if (p < p_dim) yrow[p] = from_f32<T>(acc[ii][pp] + e * inter[ii][pp]);
        }
      }
    }
    __syncthreads();  // every thread has read the old state

    // state update: rows n = ty + 16*nn, columns p = tx + 16*pp
    {
      float acc[NR][PC];
#pragma unroll
      for (int nn = 0; nn < NR; ++nn)
#pragma unroll
        for (int pp = 0; pp < PC; ++pp) acc[nn][pp] = 0.f;
      for (int j = 0; j < kChunk; ++j) {
        const float w = wts[j];
        float bv[NR], xv[PC];
#pragma unroll
        for (int nn = 0; nn < NR; ++nn) {
          const int n = ty + 16 * nn;
          bv[nn] = n < n_dim ? w * bs[j * ldn + n] : 0.f;
        }
#pragma unroll
        for (int pp = 0; pp < PC; ++pp) {
          const int p = tx + 16 * pp;
          xv[pp] = p < p_dim ? xs[j * ldp + p] : 0.f;
        }
#pragma unroll
        for (int nn = 0; nn < NR; ++nn)
#pragma unroll
          for (int pp = 0; pp < PC; ++pp) acc[nn][pp] = fmaf(bv[nn], xv[pp], acc[nn][pp]);
      }
      const float decay = expf(cum[kChunk - 1]);
#pragma unroll
      for (int nn = 0; nn < NR; ++nn) {
        const int n = ty + 16 * nn;
#pragma unroll
        for (int pp = 0; pp < PC; ++pp) {
          const int p = tx + 16 * pp;
          if (n < n_dim && p < p_dim) st[n * ldp + p] = decay * st[n * ldp + p] + acc[nn][pp];
        }
      }
    }
  }
  __syncthreads();
  float* fs = final_state + static_cast<int64_t>(blockIdx.x) * n_dim * p_dim;
  for (int e = tid; e < n_dim * p_dim; e += kThreads) {
    const int n = e / p_dim;
    fs[e] = st[n * ldp + e - n * p_dim];
  }
}

template <typename T, int PC, int NR>
cudaError_t launch(const void* x, const void* dt, const void* a_log, const void* bm,
                   const void* cm, void* y, void* final_state, int b_total, int s_total,
                   int h_total, int p_dim, int n_dim, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kChunk) * (p_dim + 1) +
                       2 * static_cast<size_t>(kChunk) * (n_dim + 1) +
                       static_cast<size_t>(n_dim) * (p_dim + 1) + kChunk * kLdK + 3 * kChunk);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, PC, NR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T, PC, NR><<<b_total * h_total, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a_log),
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<T*>(y),
      static_cast<float*>(final_state), s_total, h_total, p_dim, n_dim);
  return cudaGetLastError();
}

template <typename T, int PC>
cudaError_t by_n(const void* x, const void* dt, const void* a_log, const void* bm,
                 const void* cm, void* y, void* fs, int b, int s, int h, int p, int n,
                 cudaStream_t st) {
  if (n <= 16) return launch<T, PC, 1>(x, dt, a_log, bm, cm, y, fs, b, s, h, p, n, st);
  if (n <= 64) return launch<T, PC, 4>(x, dt, a_log, bm, cm, y, fs, b, s, h, p, n, st);
  return launch<T, PC, 8>(x, dt, a_log, bm, cm, y, fs, b, s, h, p, n, st);
}

template <typename T>
cudaError_t by_p(const void* x, const void* dt, const void* a_log, const void* bm,
                 const void* cm, void* y, void* fs, int b, int s, int h, int p, int n,
                 cudaStream_t st) {
  if (p <= 16) return by_n<T, 1>(x, dt, a_log, bm, cm, y, fs, b, s, h, p, n, st);
  if (p <= 64) return by_n<T, 4>(x, dt, a_log, bm, cm, y, fs, b, s, h, p, n, st);
  return by_n<T, 8>(x, dt, a_log, bm, cm, y, fs, b, s, h, p, n, st);
}

}  // namespace

// x: [b, s, h, p]; dt: [b, s, h] f32; a_log: [h] f32; bmat, cmat: [b, s, n];
// y: [b, s, h, p] (x's type); final_state: [b, h, n, p] f32; all contiguous.
// kind 0 = f32, 1 = bf16 (x, bmat, cmat and y).  n <= 128, p <= 128.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a_log, const void* bmat,
                            const void* cmat, void* y, void* final_state, int b_total,
                            int s_total, int h_total, int p_dim, int n_dim, int kind, int device,
                            void* stream) {
  if (b_total <= 0 || s_total <= 0 || h_total <= 0 || p_dim <= 0 || n_dim <= 0 ||
      p_dim > 128 || n_dim > 128 || static_cast<int64_t>(b_total) * h_total > 2147483647)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return static_cast<int>(by_p<float>(x, dt, a_log, bmat, cmat, y, final_state, b_total,
                                          s_total, h_total, p_dim, n_dim, st));
    case 1:
      return static_cast<int>(by_p<__nv_bfloat16>(x, dt, a_log, bmat, cmat, y, final_state,
                                                  b_total, s_total, h_total, p_dim, n_dim, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
