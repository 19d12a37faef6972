// Mamba2 chunked SSD scan (state space duality) for Hopper (sm_90a), forward
// only (K5), with the chunk products on the tensor cores.
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
// from state = init_state, or 0 when init_state is null (a prompt continued
// from a cache, as ssd_chunked(init_state=) does; the Pallas kernel always
// starts from 0).  Steps past S get dt = 0 (no input, no decay).  y comes
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
// Bound: bytes, by a little.  Per (batch, head, chunk of L = 64 steps):
// 2*L*N*P (inter) + L(L+1)*N (C.B, lower triangle) + L(L+1)*P (intra) +
// 2*L*N*P (state) + L(L-1)/2 (segment sums) flops, plus O(L*P)
// elementwise.  At the serve path's shape (B = 4, S = 2000, H = 64, P = 64,
// N = 64) that is 1.26e10 flops, ~77 us as three TF32 passes at 495
// TFLOP/s (~0.19 ms on the CUDA cores at 67 TFLOP/s), against ~273 MB of x,
// y, dt, B, C and the final state, ~81 us at 3.35 TB/s (H100 SXM data
// sheet figures).
//
// Design: one block of 8 warps per (batch, head).  The Pallas grid's
// sequential chunk axis becomes a loop inside the block, and the f32 state
// [N, P] stays in shared memory across chunks.  Per chunk:
//   stage x, dt, B and C into shared memory as f32 (zero past S and past
//     N and P up to the template's buckets), by plain loads and stores;
//   one warp scans dt * a while two warps sum the segments, one column per
//     thread, into the kern buffer, and the other warps compute
//   (i)   CB = C.B^T, warp-level mma.sync into registers, each warp a 16-row
//         strip and four n8 tiles; the tiles wholly above the diagonal are
//         skipped;
//   (ii)  kern = CB * exp(seg) * dt_j, zero above the diagonal (masked
//         before the exp), written over the segment sums in the kern buffer;
//   (iii) y_intra = kern.x, each warp a 16-row strip and P/16 n8 tiles of
//         y, its k loop stopping at the strip's diagonal;
//   (iv)  y_inter = C.state, the same tiles, then
//         y = y_intra + exp(cum_i) y_inter on the CUDA cores, stored;
//   (v)   delta = (w B)^T.x with w_j = exp(seg_last,j) dt_j (A read
//         column-wise from the B tile and scaled on the fragment), then
//         state = exp(cum_last) state + delta on the CUDA cores.
// Every product takes mma.m16n8k8 with TF32 operands in three passes: each
// operand x is split into big = x rounded to TF32 and small = x - big (see
// split()), and small.big + big.small is accumulated before big.big, which
// keeps ~21 bits of each operand; one TF32 pass keeps ~11 and misses the f32
// tolerance (tests/test_torch_k5_numerics.py models both).  Each chunk's
// products start from zero and are combined with y and the state on the
// CUDA cores: the tensor cores' f32 sums truncate, and the state runs over
// S / 64 chunks.  bf16 inputs are staged as f32 and take the same path.
// Shared-memory rows are padded so every fragment load hits distinct banks
// (see Plan).  Templates: the dtype and N and P rounded up to a bucket (16,
// 64, 128; the rows and columns past N and P are zero).  Shared memory is
// 88 KB at N = P = 64 (two blocks an SM) and 186 KB at N = P = 128, opted in
// per launch with cudaFuncSetAttribute.  No cp.async, TMA or wgmma, and one
// block per (batch, head).
//
// Plain C interface, loaded with ctypes.  The entry point selects the
// device, launches on the given stream, allocates nothing, does not
// synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
static_assert(kChunk == 16 * kWarps / 2, "two warps per 16-row strip of a chunk");
static_assert(kThreads % 128 == 0, "staging keeps one column a thread for N, P <= 128");

// Row strides of the shared tiles, in floats.  A fragments read at
// (row g, column t) (C in (i) and (iv)) and B fragments read at (row g,
// column t) of a row-major [n][k] tile (B in (i)) want a stride of 4 * odd
// words (4g + t, distinct over the warp); B fragments read at (row 2t,
// column g) (x in (iii) and (v), rows j0 = 8 kk + 2t and j0 + 1) and the
// column-wise A fragments of (v) (B at row 2t, column g) want 4 * odd too
// (8t + g); B fragments read at (row t, column g) (the state in (iv)) and
// the 64-bit loads and stores at (row g, column 2t) (kern, the state
// update) want 8 * odd (8t + g, and 8g + 2t per half warp).
template <int NB, int PB> struct Plan {
  static constexpr int kLdX = PB + 4;      // xs [L][kLdX]
  static constexpr int kLdN = NB + 4;      // bs, cs [L][kLdN]
  static constexpr int kLdS = PB + 8;      // st [NB][kLdS]
  static constexpr int kLdK = kChunk + 8;  // kern [L][kLdK]
  static constexpr size_t kSmem =
      sizeof(float) * (static_cast<size_t>(kChunk) * kLdX + 2 * kChunk * kLdN + NB * kLdS +
                       kChunk * kLdK + 3 * kChunk);
  // two blocks an SM at the serve path's N = P = 64 (88 KB each)
  static constexpr int kMinBlocks = NB <= 64 && PB <= 64 ? 2 : 1;
};

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

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// x = big + small as TF32 operands.  big is x rounded to TF32, to nearest
// with ties away from zero (cvt.rna.tf32.f32's rounding, as an integer add
// and mask, without cvt's check for NaN and infinity); small = x - big is
// exact in f32 and goes to the tensor core as it is, which reads the top 19
// bits of a TF32 operand, so small is truncated to TF32 there (error at most
// 2^-11 |small| <= 2^-23 |x|).  A NaN in x stays in small.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[n] += a . b[n] for N n-tiles in three TF32 passes, small.big and
// big.small before big.big; the passes run over all n-tiles in turn, so no
// product waits on the one before it.  a: 4 f32 A-fragment values; b[n]: 2.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&c)[N][4], const float (&a)[4],
                                           const float (&b)[N][2]) {
  uint32_t ab[4], as[4], bb[N][2], bs[N][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], ab[i], as[i]);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split(b[n][0], bb[n][0], bs[n][0]);
    split(b[n][1], bb[n][1], bs[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], as, bb[n][0], bb[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ab, bs[n][0], bs[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ab, bb[n][0], bb[n][1]);
}

// c[q] += a . B for NT n-tiles, where B(k = t, column g) of tile q is
// r[8q] and B(k = t + 4, column g) is r[OFF + 8q] (r: this thread's first
// value of tile 0); eight n-tiles at a time, so the split B values fit in
// registers.
template <int NT, int OFF>
__device__ __forceinline__ void mma_rows(float (&c)[NT][4], const float (&a)[4], const float* r) {
  constexpr int kN = NT < 8 ? NT : 8;
#pragma unroll
  for (int q0 = 0; q0 < NT; q0 += kN) {
    float b[kN][2];
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      b[q][0] = r[8 * (q0 + q)];
      b[q][1] = r[OFF + 8 * (q0 + q)];
    }
    mma_3xtf32<kN>(*reinterpret_cast<float(*)[kN][4]>(c[q0]), a, b);
  }
}

// (i) CB = C.B^T for a 16-row strip (cw: its first row of C) and four n8
// tiles of B's rows (bw: the first), over k = N; the second pair of tiles
// only when `both` (the first pair always reaches the diagonal).
template <int NB, int LDN>
__device__ __forceinline__ void cb_product(float (&cb)[4][4], const float* cw, const float* bw,
                                           bool both, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < NB / 8; ++kk) {
    const int c = 8 * kk + t;
    const float a[4] = {cw[g * LDN + c], cw[(g + 8) * LDN + c], cw[g * LDN + c + 4],
                        cw[(g + 8) * LDN + c + 4]};
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      if (pr == 1 && !both) break;
      float b[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* br = bw + (8 * (2 * pr + q) + g) * LDN + c;
        b[q][0] = br[0];
        b[q][1] = br[4];
      }
      mma_3xtf32<2>(*reinterpret_cast<float(*)[2][4]>(cb[2 * pr]), a, b);
    }
  }
}

template <typename T, int NB, int PB>
__global__ void __launch_bounds__(kThreads, Plan<NB, PB>::kMinBlocks)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ init_state,
                T* __restrict__ y, float* __restrict__ final_state, int s_total, int h_total,
                int p_dim, int n_dim, bool pair_store) {
  using PL = Plan<NB, PB>;
  constexpr int LDX = PL::kLdX, LDN = PL::kLdN, LDS = PL::kLdS, LDK = PL::kLdK;
  constexpr int YT = PB / 16;  // n8 tiles of y per warp
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                // [L][LDX]
  float* bs = xs + kChunk * LDX;   // [L][LDN]
  float* cs = bs + kChunk * LDN;   // [L][LDN]
  float* st = cs + kChunk * LDN;   // [NB][LDS]  the running state
  float* kern = st + NB * LDS;     // [L][LDK]   segment sums, then the kernel matrix
  float* dts = kern + kChunk * LDK;  // [L]
  float* cum = dts + kChunk;         // [L]
  float* wts = cum + kChunk;         // [L]  exp(seg_last,j) * dt_j

  const int b = blockIdx.x / h_total, h = blockIdx.x - b * h_total;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float a = -expf(a_log[h]);
  // (i) - (iv): the warp's 16-row strip of the chunk and half of its tiles
  const int strip = warp >> 1, i0 = 16 * strip;

  // the initial state, zero past N and P (and everywhere without one)
  {
    const float* is =
        init_state ? init_state + static_cast<int64_t>(blockIdx.x) * n_dim * p_dim : nullptr;
    for (int e = tid; e < NB * PB; e += kThreads) {
      const int n = e / PB, p = e - n * PB;
      st[n * LDS + p] = is && n < n_dim && p < p_dim ? is[n * p_dim + p] : 0.f;
    }
  }

  for (int c0 = 0; c0 < s_total; c0 += kChunk) {
    __syncthreads();  // the previous chunk is done with every buffer
    // stage: each thread keeps one column (kThreads is a multiple of PB and
    // NB) and walks down the chunk's rows
    {
      constexpr int kRowStep = kThreads / PB;
      const int p = tid % PB, r0 = tid / PB;
      const bool col_in = p < p_dim;
      const int64_t step = static_cast<int64_t>(kRowStep) * h_total * p_dim;
      int64_t off = ((static_cast<int64_t>(b) * s_total + c0 + r0) * h_total + h) * p_dim + p;
#pragma unroll
      for (int r = r0; r < kChunk; r += kRowStep, off += step)
        xs[r * LDX + p] = col_in && c0 + r < s_total ? to_f32(x[off]) : 0.f;
    }
    {
      constexpr int kRowStep = kThreads / NB;
      const int n = tid % NB, r0 = tid / NB;
      const bool col_in = n < n_dim;
      int64_t off = (static_cast<int64_t>(b) * s_total + c0 + r0) * n_dim + n;
#pragma unroll
      for (int r = r0; r < kChunk; r += kRowStep, off += kRowStep * n_dim) {
        const bool in = col_in && c0 + r < s_total;
        bs[r * LDN + n] = in ? to_f32(bm[off]) : 0.f;
        cs[r * LDN + n] = in ? to_f32(cm[off]) : 0.f;
      }
    }
    if (tid < kChunk) {
      const int pos = c0 + tid;
      dts[tid] = pos < s_total ? dt[(static_cast<int64_t>(b) * s_total + pos) * h_total + h] : 0.f;
    }
    __syncthreads();

    // cum = cumsum(dt * a): warp 0, two steps per lane.  Warps 1 and 3 (no
    // C.B tiles of their own) sum the segments seg[i][j] =
    // sum_{k=j+1..i} dt_k * a (i >= j), one column per thread, into the
    // kern buffer: taken directly, not as cum_i - cum_j, whose f32 rounding
    // (~eps * |cum|) swamps short segments once the sums reach ~1e5.  The
    // last row gives the suffix sums for the state update.
    if (warp == 0) {
      const float v0 = dts[2 * lane] * a, v1 = dts[2 * lane + 1] * a;
      const float pair = v0 + v1;
      float incl = pair;
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float excl = incl - pair;
      cum[2 * lane] = excl + v0;
      cum[2 * lane + 1] = incl;
    } else if (warp == 1 || warp == 3) {
      const int j = lane + (warp == 3 ? 32 : 0);
      float seg = 0.f;
      kern[j * LDK + j] = 0.f;
      for (int i = j + 1; i < kChunk; ++i) {
        seg += dts[i] * a;
        kern[i * LDK + j] = seg;
      }
      wts[j] = expf(seg) * dts[j];  // exp(sum_{k>j} dt_k a) * dt_j
    }

    // (i) C.B^T: n8 tiles nb .. nb + 3 of the strip; tile q of the strip
    // lies wholly above the diagonal when 8 q > i0 + 15, so the strip
    // needs tiles 0 .. 2 strip + 1
    const int nb = (warp & 1) * 4;
    const int last = 2 * strip + 1 - nb;  // the group's last tile that reaches the diagonal
    float cb[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) cb[q][i] = 0.f;
    if (last >= 0) cb_product<NB, LDN>(cb, cs + i0 * LDN, bs + 8 * nb * LDN, last >= 3, g, t);
    __syncthreads();  // the segment sums, cum and wts are in

    // (ii) kern = CB * exp(seg) * dt_j over the segment sums, zero above
    // the diagonal; the mask comes before the exp (the upper triangle holds
    // no segment sum)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q > last) continue;
      const int col = 8 * (nb + q) + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + g + 8 * hh;
        float2* kp = reinterpret_cast<float2*>(kern + i * LDK + col);
        const float2 sg = *kp;
        float2 out;
        out.x = col <= i ? cb[q][2 * hh] * expf(sg.x) * dts[col] : 0.f;
        out.y = col + 1 <= i ? cb[q][2 * hh + 1] * expf(sg.y) * dts[col + 1] : 0.f;
        *kp = out;
      }
    }
    __syncthreads();

    // (iii) + (iv): y rows i0 .. i0 + 15, n8 tiles n0 .. n0 + YT - 1
    {
      const int n0 = (warp & 1) * YT;
      float intra[YT][4], inter[YT][4];
#pragma unroll
      for (int q = 0; q < YT; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) intra[q][i] = inter[q][i] = 0.f;
      // y_inter = C.state over k = n
      const float* cw = cs + i0 * LDN;
#pragma unroll 2
      for (int kk = 0; kk < NB / 8; ++kk) {
        const int c = 8 * kk + t;
        const float a4[4] = {cw[g * LDN + c], cw[(g + 8) * LDN + c], cw[g * LDN + c + 4],
                             cw[(g + 8) * LDN + c + 4]};
        mma_rows<YT, 4 * LDS>(inter, a4, st + c * LDS + 8 * n0 + g);
      }
      // y_intra = kern.x over k = j <= i0 + 15 (kern is zero above the
      // diagonal).  The A fragment wants columns t and t + 4 of each k step;
      // k = t is read as column 2t and k = t + 4 as 2t + 1, 64 bits a thread,
      // and x's rows with the same mapping: a sum over j does not depend on
      // its order.
      const float* kw = kern + i0 * LDK;
      for (int kk = 0; kk < 2 * strip + 2; ++kk) {
        const int c = 8 * kk + 2 * t;
        const float2 lo = *reinterpret_cast<const float2*>(kw + g * LDK + c);
        const float2 hi = *reinterpret_cast<const float2*>(kw + (g + 8) * LDK + c);
        const float a4[4] = {lo.x, hi.x, lo.y, hi.y};
        mma_rows<YT, LDX>(intra, a4, xs + c * LDX + 8 * n0 + g);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + g + 8 * hh;
        const int pos = c0 + i;
        if (pos >= s_total) continue;
        const float e = expf(cum[i]);
        T* yrow = y + ((static_cast<int64_t>(b) * s_total + pos) * h_total + h) * p_dim;
#pragma unroll
        for (int q = 0; q < YT; ++q) {
          const int p = 8 * (n0 + q) + 2 * t;
          const float v0 = fmaf(e, inter[q][2 * hh], intra[q][2 * hh]);
          const float v1 = fmaf(e, inter[q][2 * hh + 1], intra[q][2 * hh + 1]);
          if (pair_store && p + 1 < p_dim) {
            store2(yrow + p, v0, v1);
          } else {
            if (p < p_dim) yrow[p] = from_f32<T>(v0);
            if (p + 1 < p_dim) yrow[p + 1] = from_f32<T>(v1);
          }
        }
      }
    }
    __syncthreads();  // every thread has read the old state

    // (v) delta = (w B)^T.x over k = j, then the state update.  The [NB x
    // PB] state is (NB / 16) strips of (PB / 8) n8 tiles; each warp takes VT
    // consecutive tiles of one strip.  A(row n, k = j) = w_j B[j][n] is read
    // column-wise from the B tile, with k = t as row 2t and k = t + 4 as
    // row 2t + 1 of the k step, and x's rows with the same mapping.
    {
      constexpr int kTiles = (NB / 16) * (PB / 8);
      constexpr int VT = kTiles >= 8 ? kTiles / 8 : 1;
      const int flat = warp * VT;
      if (flat < kTiles) {
        const int m0 = (flat / (PB / 8)) * 16, n0 = flat % (PB / 8);
        float acc[VT][4];
#pragma unroll
        for (int q = 0; q < VT; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kChunk / 8; ++kk) {
          const int j0 = 8 * kk + 2 * t;
          const float w0 = wts[j0], w1 = wts[j0 + 1];
          const float* b0 = bs + j0 * LDN + m0 + g;
          const float a4[4] = {w0 * b0[0], w0 * b0[8], w1 * b0[LDN], w1 * b0[LDN + 8]};
          mma_rows<VT, LDX>(acc, a4, xs + j0 * LDX + 8 * n0 + g);
        }
        const float decay = expf(cum[kChunk - 1]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int n = m0 + g + 8 * hh;
#pragma unroll
          for (int q = 0; q < VT; ++q) {
            float2* sp = reinterpret_cast<float2*>(st + n * LDS + 8 * (n0 + q) + 2 * t);
            float2 v = *sp;
            v.x = fmaf(decay, v.x, acc[q][2 * hh]);
            v.y = fmaf(decay, v.y, acc[q][2 * hh + 1]);
            *sp = v;
          }
        }
      }
    }
  }
  __syncthreads();
  float* fs = final_state + static_cast<int64_t>(blockIdx.x) * n_dim * p_dim;
  for (int e = tid; e < n_dim * p_dim; e += kThreads) {
    const int n = e / p_dim;
    fs[e] = st[n * LDS + e - n * p_dim];
  }
}

template <typename T, int NB, int PB>
cudaError_t launch(const void* x, const void* dt, const void* a_log, const void* bm,
                   const void* cm, const void* init_state, void* y, void* final_state,
                   int b_total, int s_total, int h_total, int p_dim, int n_dim, cudaStream_t st) {
  constexpr size_t smem = Plan<NB, PB>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, NB, PB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // y's rows start on an even element when P is even: store pairs of
  // columns
  const bool pair_store =
      p_dim % 2 == 0 && reinterpret_cast<uintptr_t>(y) % (2 * sizeof(T)) == 0;
  ssd_scan_kernel<T, NB, PB><<<b_total * h_total, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a_log),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(init_state), static_cast<T*>(y),
      static_cast<float*>(final_state), s_total, h_total, p_dim, n_dim, pair_store);
  return cudaGetLastError();
}

template <typename T, int PB>
cudaError_t by_n(const void* x, const void* dt, const void* a_log, const void* bm,
                 const void* cm, const void* is, void* y, void* fs, int b, int s, int h, int p,
                 int n, cudaStream_t st) {
  if (n <= 16) return launch<T, 16, PB>(x, dt, a_log, bm, cm, is, y, fs, b, s, h, p, n, st);
  if (n <= 64) return launch<T, 64, PB>(x, dt, a_log, bm, cm, is, y, fs, b, s, h, p, n, st);
  return launch<T, 128, PB>(x, dt, a_log, bm, cm, is, y, fs, b, s, h, p, n, st);
}

template <typename T>
cudaError_t by_p(const void* x, const void* dt, const void* a_log, const void* bm,
                 const void* cm, const void* is, void* y, void* fs, int b, int s, int h, int p,
                 int n, cudaStream_t st) {
  if (p <= 16) return by_n<T, 16>(x, dt, a_log, bm, cm, is, y, fs, b, s, h, p, n, st);
  if (p <= 64) return by_n<T, 64>(x, dt, a_log, bm, cm, is, y, fs, b, s, h, p, n, st);
  return by_n<T, 128>(x, dt, a_log, bm, cm, is, y, fs, b, s, h, p, n, st);
}

}  // namespace

// x: [b, s, h, p]; dt: [b, s, h] f32; a_log: [h] f32; bmat, cmat: [b, s, n];
// init_state: [b, h, n, p] f32 or null (a zero start); y: [b, s, h, p] (x's
// type); final_state: [b, h, n, p] f32; all contiguous.  kind 0 = f32,
// 1 = bf16 (x, bmat, cmat and y).  n <= 128, p <= 128.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a_log, const void* bmat,
                            const void* cmat, const void* init_state, void* y,
                            void* final_state, int b_total, int s_total, int h_total, int p_dim,
                            int n_dim, int kind, int device, void* stream) {
  if (b_total <= 0 || s_total <= 0 || h_total <= 0 || p_dim <= 0 || n_dim <= 0 ||
      p_dim > 128 || n_dim > 128 || static_cast<int64_t>(b_total) * h_total > 2147483647)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return static_cast<int>(by_p<float>(x, dt, a_log, bmat, cmat, init_state, y,
                                          final_state, b_total, s_total, h_total, p_dim,
                                          n_dim, st));
    case 1:
      return static_cast<int>(by_p<__nv_bfloat16>(x, dt, a_log, bmat, cmat, init_state, y,
                                                  final_state, b_total, s_total, h_total,
                                                  p_dim, n_dim, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
