// Causal flash attention with an optional sliding window for Hopper (sm_90a),
// forward only (K4), on the tensor cores.
//
// Replaces the Pallas TPU kernel _swa_kernel of src/repro/kernels/swa_attn.py
// (kernel :32, wrapper swa_attn_pallas :72, pallas_call :101).
//
// q, o: [B*H, S, D] and k, v: [B*H_kv, S, D] contiguous (the caller's
// [B, H, S, D] and [B, H_kv, S, D]), f32 or bf16 (a template parameter),
// softmax and accumulation in f32.  Grouped-query attention: H_kv divides
// H, and query head h reads key / value head h / (H / H_kv), as the JAX
// models' _sdpa groups its heads (H_kv = H is plain multi-head attention).
// As _swa_kernel computes it:
//   scores are q.k scaled by 1/sqrt(D) in f32;
//   key kp is seen by query qp iff kp <= qp, qp - kp < window (when there is
//   a window), and both are < S;
//   online softmax with an f32 running max m (from -1e30), sum l and output
//   o; masked scores have weight exactly 0;
//   out = o / max(l, 1e-30), so a query that sees no key gives 0, not NaN.
// The softmax runs in base 2 on the unscaled scores s: p = 2^(s c - m c)
// with c = scale * log2(e), one FFMA and one ex2.approx each.  A masked
// score is -inf rather than the TPU kernel's -1e30, so its weight is
// exp2(-inf) = 0 with no compare, also in a row that has seen no key yet
// (whose max stays -1e30; a masked -1e30 would give exp2(0) = 1 there).
//
// Bound: tensor-core operations.  The function does 4*D flops for every
// (query, key) pair it sees (q.k and p.v).  At the serve path's shape
// (B*H = 128, S = 2000, D = 64, causal) that is 6.56e10 flops: in f32 three
// TF32 passes at 495 TFLOP/s, ~0.40 ms; in bf16 one pass at 989 TFLOP/s,
// ~66 us, above the 2.6e8 exponentials (~61 us at 16 per SM and clock) and
// the 131 MB of q, k, v and o (~39 us at 3.35 TB/s).
//
// Design: one block of 4 warps per (batch*head, 64-query tile); each warp
// owns 16 query rows, one m16 strip of the warp-level mma.sync products.
// The block loops only over the key tiles the mask can reach, from
// max(0, q0 - window + 1) (or 0) to its last query, so the TPU kernel's
// relative block index map and its clamped duplicate blocks are not needed;
// query tiles are issued last tile first, since causal work grows along the
// sequence.  Q, K and V tiles are staged in shared memory by 16-byte
// cp.async copies (zero past S and past D, rows padded so fragment loads
// hit distinct banks): K of the next tile loads while this tile's softmax
// and P.V run, V of the next tile while its Q.K^T runs.  Per key tile each
// warp computes
//   S = Q.K^T with mma.sync into f32 registers (Q fragments read from the
//     Q tile in shared memory per k-step, so no registers hold Q);
//   the mask (only on tiles that touch the diagonal, the window's edge or
//     the end of the sequence), the row max over the quad of threads that
//     share a row (two __shfl_xor_sync steps), the weights, and the rescale
//     of the running sum and output;
//   O += P.V with the S accumulators reused as the A fragments (P never
//     goes through shared memory), O kept in f32 registers.
// f32 inputs take mma.m16n8k8 with TF32 operands in three passes: each
// operand x is split into big = x rounded to TF32 and small = x - big (see
// split()), and small.big + big.small is accumulated before big.big, which
// keeps ~21 bits of each operand; one TF32 pass keeps ~11 and misses the f32
// tolerance (tests/test_torch_k4_numerics.py models both).  P.V of each key
// tile is summed from zero and added to O on the CUDA cores: the tensor
// cores' f32 sums truncate, and ~750 of them into one running O (S = 2000)
// drift by ~1e-5.  For P.V the m16n8k8 A fragment wants keys t and t+4
// where the S accumulator holds keys 2t and 2t+1, so the k index is
// permuted (k = t -> key 2t, k = t+4 -> key 2t+1) and V is read with the
// same permutation: a sum over keys does not depend on their order.  bf16
// inputs take mma.m16n8k16 in one pass (bf16 operands are exact); P is
// rounded to bf16 for P.V (relative 2^-9, inside the bf16 tolerance) and
// its fragments are the S accumulators packed in pairs; V fragments come
// from ldmatrix.trans.  Templates: the dtype, the head dimension rounded up
// to a bucket (64, 128, 256; the columns past D are zero) and the key tile
// (64; 32 at 256, where the f32 O accumulator alone takes 128 registers a
// thread).  Shared memory is 53 KB at D <= 64 in f32 (29 KB in bf16) and
// 132 KB at D <= 256, opted in per launch with cudaFuncSetAttribute.  No
// TMA, wgmma or warp specialisation yet.
//
// Plain C interface, loaded with ctypes.  The entry point selects the
// device, launches on the given stream, allocates nothing, does not
// synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kBlockQ = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;  // NEG of the TPU kernel: the running max starts here
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBlockQ == 16 * kWarps, "one m16 strip of query rows per warp");

// Row strides of the shared tiles, in elements.  Q and K fragments are read
// 64 bits a thread at (row g, column 2t) (f32: words 8g + 2t mod 32) or
// (row g, column 4t) (bf16, words 8g + 2t): stride = 8 (mod 32) words.  V
// fragments are read 32 bits a thread at (row 2t, column g) in f32 (words
// 8t + g) and by ldmatrix rows of 16 bytes in bf16: stride = 4 (mod 32)
// words.
template <typename T> struct Tile;
template <> struct Tile<float> {
  static constexpr int kPadQK = 8, kPadV = 4;
};
template <> struct Tile<__nv_bfloat16> {
  static constexpr int kPadQK = 16, kPadV = 8;
};

// Blocks an SM should hold, for __launch_bounds__: at D <= 64 (the serve
// path) the register cap this sets (168 in f32, 128 in bf16) costs no
// spill and fits one more block than the compiler's own choice.
template <typename T, int DP> struct Occupancy { static constexpr int kMinBlocks = 1; };
template <> struct Occupancy<float, 64> { static constexpr int kMinBlocks = 3; };
template <> struct Occupancy<__nv_bfloat16, 64> { static constexpr int kMinBlocks = 4; };

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint2 lds64(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Stage rows [row0, row0 + ROWS) of one [S, d] matrix into a [ROWS][LD]
// shared tile; rows at or past S and columns at or past d (up to DP) are
// zero.  With vec (d a multiple of 16 bytes, 16-byte aligned pointers) the
// rows go by 16-byte cp.async copies, zero-filled where nothing is read,
// that land by the next cp_async_wait_one; otherwise by plain loads and
// stores.
template <typename T, int ROWS, int DP, int LD>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int row0, int s_total,
                                      int d, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DP / kVec;  // 16-byte chunks a row
  constexpr int kRowStep = kThreads / kChunks;
  static_assert(kThreads % kChunks == 0 && ROWS % kRowStep == 0, "chunks tile the block");
  const int col = (threadIdx.x % kChunks) * kVec;
  const int r0 = threadIdx.x / kChunks;
#pragma unroll
  for (int r = r0; r < ROWS; r += kRowStep) {
    const int pos = row0 + r;
    T* out = dst + r * LD + col;
    const bool in_range = pos < s_total && col < d;
    const T* in = src + static_cast<int64_t>(pos) * d + col;
    if (vec) {
      cp_async16(out, in_range ? in : src, in_range ? 16 : 0);
    } else if (in_range) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = col + e < d ? in[e] : from_f32<T>(0.f);
    } else {
      *reinterpret_cast<uint4*>(out) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// S = Q.K^T for the warp's 16 rows (qw: its rows of the Q tile) against the
// BK keys of the K tile, in f32 accumulators (m16n8 layout: n-tile j holds
// keys 8j..8j+7, this thread rows g and g + 8, keys 2t and 2t + 1).  The
// sum over D does not depend on its order, so the k index of each k-step is
// mapped onto columns so that a thread's A and B values sit side by side
// and load as 64 bits: f32 k = t -> column 2t, k = t + 4 -> 2t + 1; bf16
// k = 2t, 2t + 1 -> columns 4t, 4t + 1 and k = 2t + 8, 2t + 9 -> 4t + 2,
// 4t + 3.
template <int DP, int BK, int LD>
__device__ __forceinline__ void qk(float (&s)[BK / 8][4], const float* qw, const float* ks,
                                   int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const int c = kk * 8 + 2 * t;
    const float2 lo = *reinterpret_cast<const float2*>(qw + g * LD + c);
    const float2 hi = *reinterpret_cast<const float2*>(qw + (g + 8) * LD + c);
    const float a[4] = {lo.x, hi.x, lo.y, hi.y};
    float b[BK / 8][2];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float2 kv = *reinterpret_cast<const float2*>(ks + (8 * j + g) * LD + c);
      b[j][0] = kv.x;
      b[j][1] = kv.y;
    }
    mma_3xtf32<BK / 8>(s, a, b);
  }
}

template <int DP, int BK, int LD>
__device__ __forceinline__ void qk(float (&s)[BK / 8][4], const __nv_bfloat16* qw,
                                   const __nv_bfloat16* ks, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c = kk * 16 + 4 * t;
    const uint2 lo = lds64(qw + g * LD + c), hi = lds64(qw + (g + 8) * LD + c);
    const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const uint2 kv = lds64(ks + (8 * j + g) * LD + c);
      mma_bf16(s[j], a, kv.x, kv.y);
    }
  }
}

// O += P.V, P being the warp's weights in the S accumulator layout and V
// the tile (row stride LD).  f32: the A fragment wants keys t and t + 4
// where the accumulator holds keys 2t and 2t + 1, so k = t is key 2t and
// k = t + 4 key 2t + 1, and V is read with the same mapping.
template <int DP, int BK, int LD>
__device__ __forceinline__ void pv(float (&o)[DP / 8][4], const float (&p)[BK / 8][4],
                                   const float* vs, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const float a[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
    const float* vr = vs + (8 * kk + 2 * t) * LD + g;
    // eight n-tiles at a time, so the split B values fit in registers
    constexpr int kN = DP / 8 < 8 ? DP / 8 : 8;
#pragma unroll
    for (int n0 = 0; n0 < DP / 8; n0 += kN) {
      float b[kN][2];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        b[n][0] = vr[8 * (n0 + n)];
        b[n][1] = vr[LD + 8 * (n0 + n)];
      }
      mma_3xtf32<kN>(*reinterpret_cast<float(*)[kN][4]>(o[n0]), a, b);
    }
  }
}

// bf16: P rounded to bf16, A fragments packed from accumulator pairs; V by
// ldmatrix.x4.trans, where lane l gives the address of row (l & 7) +
// 8 ((l >> 3) & 1) of the 16-key slice at column 8 (l >> 4) of a 16-column
// pair, which returns the B fragments of the pair's two n-tiles.
template <int DP, int BK, int LD>
__device__ __forceinline__ void pv(float (&o)[DP / 8][4], const float (&p)[BK / 8][4],
                                   const __nv_bfloat16* vs, int lane) {
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(vs + row * LD + col));
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      uint32_t b[4];
      const uint32_t addr = base + static_cast<uint32_t>((kk * 16 * LD + n * 16) * 2);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
          : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
          : "r"(addr));
      mma_bf16(o[2 * n], a, b[0], b[1]);
      mma_bf16(o[2 * n + 1], a, b[2], b[3]);
    }
  }
}

// Offset of the block's (batch, query head) rows in q and o.  Read from
// %ctaid.x by a volatile move, so that the epilogue recomputes it instead of
// holding it in registers across the key loop: at D <= 64 in f32 the loop
// uses the whole register cap that __launch_bounds__ sets.
__device__ __forceinline__ int64_t q_base(int s_total, int d) {
  unsigned bx;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bx));
  return static_cast<int64_t>(bx) * s_total * d;
}

template <typename T, int DP, int BK>
constexpr size_t smem_bytes() {
  return sizeof(T) * ((kBlockQ + BK) * static_cast<size_t>(DP + Tile<T>::kPadQK) +
                      BK * static_cast<size_t>(DP + Tile<T>::kPadV));
}

template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kThreads, Occupancy<T, DP>::kMinBlocks)
swa_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, int h, int h_kv, int s_total, int d, int window,
                float scale, bool vec) {
  constexpr int LDQK = DP + Tile<T>::kPadQK, LDV = DP + Tile<T>::kPadV;
  // f32: each tile's P.V summed from zero, then added to O (see the top);
  // at D = 256 there are no registers for a second O
  constexpr bool kTileSum = std::is_same<T, float>::value && DP <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [64][LDQK]  Q tile
  T* ks = qs + kBlockQ * LDQK;             // [BK][LDQK]  K tile
  T* vs = ks + BK * LDQK;                  // [BK][LDV]   V tile

  // q and o by (batch, query head); k and v by (batch, its key head)
  const int bh_kv = (blockIdx.x / h) * h_kv + (blockIdx.x % h) / (h / h_kv);
  const int64_t kv_base = static_cast<int64_t>(bh_kv) * s_total * d;
  const T* kb = k + kv_base;
  const T* vb = v + kv_base;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw0 = q0 + warp * 16;              // the warp's first row
  const int rows[2] = {qw0 + g, qw0 + g + 8};  // this thread's two rows
  const float sl2 = scale * kLog2e;
  const unsigned span = window > 0 ? window : 0x7fffffff;  // qp - kp < span
  const T* qw = qs + warp * 16 * LDQK;

  const int q_last = min(q0 + kBlockQ, s_total) - 1;
  const int kt_first = (window > 0 ? max(0, q0 - window + 1) : 0) / BK;
  const int kt_last = q_last / BK;

  // groups of copies in flight, oldest first: {Q, K(first)}, V(first), then
  // K(kt + 1) while tile kt's softmax and P.V run, V(kt + 1) while tile
  // kt + 1's Q.K^T runs
  stage<T, kBlockQ, DP, LDQK>(qs, q + q_base(s_total, d), q0, s_total, d, vec);
  stage<T, BK, DP, LDQK>(ks, kb, kt_first * BK, s_total, d, vec);
  cp_async_commit();
  stage<T, BK, DP, LDV>(vs, vb, kt_first * BK, s_total, d, vec);
  cp_async_commit();

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  // m: running max of the unscaled scores; l: this thread's part of the
  // row sum
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait_one();  // Q and K(kt) have landed
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    qk<DP, BK, LDQK>(s, qw, ks, lane);
    __syncthreads();  // every warp is done with ks
    if (kt < kt_last) stage<T, BK, DP, LDQK>(ks, kb, k0 + BK, s_total, d, vec);
    cp_async_commit();

    // Masked scores become -inf, so their weight is exactly exp2(-inf) = 0,
    // also where the whole row is masked so far (the max stays -1e30: a
    // masked score of -1e30 would give exp2(0) = 1).  Only tiles that reach
    // past the warp's first row, the window's edge or the end of the
    // sequence are masked.
    if (k0 + BK - 1 > qw0 || k0 + BK > s_total || (window > 0 && qw0 + 15 - k0 >= window)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kp = k0 + 8 * j + 2 * t + (i & 1);
          const bool seen = static_cast<unsigned>(rows[i >> 1] - kp) < span && kp < s_total;
          s[j][i] = seen ? s[j][i] : __int_as_float(0xff800000);  // -inf
        }
    }

    // online softmax in base 2: p = 2^(s scale log2(e) - m scale log2(e));
    // row r of this thread is rows[r], its entries i = 2r, 2r + 1
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float shift = mx * sl2;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 2 * r; i < 2 * r + 2; ++i) {
          s[j][i] = ex2(fmaf(s[j][i], sl2, -shift));
          sum += s[j][i];
        }
      alpha[r] = ex2((m[r] - mx) * sl2);  // 1 while the row sees nothing
      l[r] = l[r] * alpha[r] + sum;
      m[r] = mx;
    }

    cp_async_wait_one();  // V(kt) has landed
    __syncthreads();
    if constexpr (kTileSum) {
      float part[DP / 8][4];
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
      pv<DP, BK, LDV>(part, s, vs, lane);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = fmaf(acc[n][i], alpha[i >> 1], part[n][i]);
    } else {
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i >> 1];
      pv<DP, BK, LDV>(acc, s, vs, lane);
    }
    __syncthreads();  // every warp is done with vs
    if (kt < kt_last) stage<T, BK, DP, LDV>(vs, vb, k0 + BK, s_total, d, vec);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  T* const ob = o + q_base(s_total, d);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = rows[i >> 1];
    if (qp >= s_total) continue;
    T* orow = ob + static_cast<int64_t>(qp) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * t + (i & 1);
      if (col < d) orow[col] = from_f32<T>(acc[n][i] / l[i >> 1]);
    }
  }
}

template <typename T, int DP, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int h,
                   int h_kv, int s_total, int d, int window, float scale, bool vec,
                   cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, DP, BK>();
  cudaError_t err = cudaFuncSetAttribute(swa_attn_kernel<T, DP, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s_total + kBlockQ - 1) / kBlockQ);
  swa_attn_kernel<T, DP, BK><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), h, h_kv, s_total, d, window, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int bh, int h,
                     int h_kv, int s_total, int d, int window, float scale, cudaStream_t st) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v);
  const bool vec = (d * sizeof(T)) % 16 == 0 && any % 16 == 0;
  if (d <= 64)
    return launch<T, 64, 64>(q, k, v, o, bh, h, h_kv, s_total, d, window, scale, vec, st);
  if (d <= 128)
    return launch<T, 128, 64>(q, k, v, o, bh, h, h_kv, s_total, d, window, scale, vec, st);
  return launch<T, 256, 32>(q, k, v, o, bh, h, h_kv, s_total, d, window, scale, vec, st);
}

}  // namespace

// q, o: [bh, s, d] and k, v: [bh / h * h_kv, s, d] contiguous (bh = B * h
// query heads over h_kv key heads, h_kv dividing h); window <= 0 means none
// (full causal); kind 0 = f32, 1 = bf16.
extern "C" int swa_attn_fwd(const void* q, const void* k, const void* v, void* o, int bh, int h,
                            int h_kv, int s_total, int d, int window, float scale, int kind,
                            int device, void* stream) {
  if (bh <= 0 || h <= 0 || h_kv <= 0 || h % h_kv != 0 || bh % h != 0 || s_total <= 0 ||
      d <= 0 || d > 256 || (s_total + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return static_cast<int>(
          dispatch<float>(q, k, v, o, bh, h, h_kv, s_total, d, window, scale, st));
    case 1:
      return static_cast<int>(
          dispatch<__nv_bfloat16>(q, k, v, o, bh, h, h_kv, s_total, d, window, scale, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
