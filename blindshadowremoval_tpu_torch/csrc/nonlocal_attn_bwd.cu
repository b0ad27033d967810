// NonLocal attention backward for Hopper: the gradients of
// out = softmax(theta . phi^T) . g with respect to theta, phi and g.
//
// Replaces the TPU kernel `_attn_bwd_kernel` of
// blindshadowremoval_tpu/ops/pallas/nonlocal_attn.py (lines 117-147,
// launched by `_pallas_attention_bwd` and wired up by the custom-VJP `_bwd`).
// Operands are [B, N, D] row-major, D in {128, 256}; no 1/sqrt(D) scale.
// With Q = theta, K = phi, V = g, P = softmax(Q K^T) and dO the cotangent:
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta),
//   dQ = dS K,    dK = dS^T Q,  Delta = rowsum(dP o P) = rowsum(dO o O).
//
// What bounds it on the card: at the train shape (B=64, N=1024, D=128,
// bf16) pass 1 and pass 2 do five N x N x D products per batch element
// between them (S is computed in both), 10*B*N^2*D = 85.9 GFLOP: ~87 us at
// 989 TFLOP/s dense bf16.  It reads theta, phi, g, O and dO and writes three
// gradients, 8*B*N*D*2 B = 134 MB (117 MB without O), ~40 us at 3.35 TB/s:
// it is bounded by the tensor cores.
//
// What the design does about it (FlashAttention-2's backward):
//  * The TPU kernel holds the N x N weights of one batch element in VMEM;
//    a Hopper block gets at most 227 KB of shared memory.  So the forward
//    kernel saves each row's logsumexp, and this kernel recomputes
//    P = exp(S - lse) tile by tile; a small first kernel computes
//    Delta = rowsum(dO o O) from the forward output, so no N x N tensor
//    ever reaches device memory.
//  * Pass 1: one block owns 64 key rows of one batch element (16 per warp)
//    and walks the query tiles, accumulating dK and dV in registers.
//    Pass 2: one block owns 64 query rows and walks the key tiles,
//    accumulating dQ.  Each gradient row has one owner, so there are no
//    atomics and the result is the same from run to run.
//  * bf16: every product runs on the tensor cores through mma.sync m16n8k16
//    (bf16 in, f32 accumulate).  S and dP stay in registers; P and dS are
//    re-packed in registers as the A operand of the next product.  At
//    D = 256 the output columns are split over two blocks (grid z), each
//    recomputing S and dP, so the accumulators fit in registers.
//  * f32: CUDA cores in full f32 (no TF32), for strict parity; not on the
//    train path.
//  * A ragged tail of N is masked: missing queries get lse = +inf (P = 0),
//    missing keys score -inf; rows past N are computed on zeros, not stored.
//  Not yet: wgmma, TMA, cp.async double buffering, warp specialisation.
//
// Numerics: the TPU kernel keeps W, dW and dS in f32.  Here P and dS are
// rounded to bf16 as operands of the second products, and Delta comes from
// the bf16 forward output; ops/nonlocal_attn.py:KERNEL_BWD_TOLERANCE says
// how far that moves the gradients.
//
// C interface (loaded with ctypes): bsr_nonlocal_attn_bwd returns a
// cudaError_t value, 0 on success; the launches run on `stream`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- bf16 path
constexpr int kThreads = 128;   // 4 warps, 16 owned rows each
constexpr int kRows = 64;       // rows a block owns
constexpr int kPad = 8;         // row padding in elements (16 B)
constexpr int kDH = 128;        // gradient columns per block
constexpr int kQStep = 32;      // query rows per step of pass 1
constexpr int kKStep = 64;      // key rows per step of pass 2

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// c[16x8] += a[16x16] . b[16x8], bf16 in, f32 accumulate.
// Fragment layout (lane = 4*grp + tig):
//   a[0] = A[grp][2tig..+1]   a[1] = A[grp+8][2tig..+1]
//   a[2] = A[grp][2tig+8..+9] a[3] = A[grp+8][2tig+8..+9]
//   b[0] = B[2tig..+1][grp]   b[1] = B[2tig+8..+9][grp]
//   c[0..1] = C[grp][2tig..+1] c[2..3] = C[grp+8][2tig..+1]
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of rows [r0, r0+16) x columns [c0, c0+16) of a shared tile
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* s, int ld,
                                       int r0, int c0, int grp, int tig) {
  const bf16* p = s + (r0 + grp) * ld + c0 + tig * 2;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * ld);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * ld + 8);
}

// B fragment of B = T^T for a shared tile T: B[k][n] = T[n0+n][k0+k]
__device__ __forceinline__ void frag_bt(uint32_t* b, const bf16* s, int ld,
                                        int n0, int k0, int grp, int tig) {
  const bf16* p = s + (n0 + grp) * ld + k0 + tig * 2;
  b[0] = ld_u32(p);
  b[1] = ld_u32(p + 8);
}

// B fragment of B = T for a shared tile T: B[k][n] = T[k0+k][n0+n]
__device__ __forceinline__ void frag_b(uint32_t* b, const bf16* s, int ld,
                                       int k0, int n0, int grp, int tig) {
  const bf16* p = s + (k0 + tig * 2) * ld + n0 + grp;
  b[0] = pack_bf16(p[0], p[ld]);
  b[1] = pack_bf16(p[8 * ld], p[9 * ld]);
}

// rows [row0, row0+ROWS) of a [n, D] matrix into shared memory with row
// stride D + kPad, 16 B per load; rows past n are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int n) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + col);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + col) = val;
  }
}

// store the [16 x kDH] accumulator of a warp's rows r (grp) and r+8
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (*acc)[4],
                                           int row, int c0, int n, int tig) {
#pragma unroll
  for (int t = 0; t < kDH / 8; ++t) {
    const int col = c0 + t * 8 + tig * 2;
    if (row < n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * D + col) =
          __floats2bfloat162_rn(acc[t][0], acc[t][1]);
    }
    if (row + 8 < n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(row + 8) * D + col) =
          __floats2bfloat162_rn(acc[t][2], acc[t][3]);
    }
  }
}

// Pass 1: dK and dV of 64 key rows, over every query.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int n) {
  constexpr int LD = D + kPad;
  constexpr int kST = kQStep / 8;   // n8 tiles of S^T per warp
  constexpr int kOut = kDH / 8;     // n8 tiles of a gradient row block
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kRows * LD;
  bf16* sq = sv + kRows * LD;
  bf16* sdo = sq + kQStep * LD;
  float* slse = reinterpret_cast<float*>(sdo + kQStep * LD);
  float* sdelta = slse + kQStep;

  const size_t base = (size_t)blockIdx.y * n * D;
  const size_t rbase = (size_t)blockIdx.y * n;
  const int j0 = blockIdx.x * kRows;
  const int c0 = blockIdx.z * kDH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wr = warp * 16;

  load_tile<D, kRows>(sk, k + base, j0, n);
  load_tile<D, kRows>(sv, v + base, j0, n);

  float acc_dk[kOut][4];
  float acc_dv[kOut][4];
#pragma unroll
  for (int t = 0; t < kOut; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[t][e] = acc_dv[t][e] = 0.f;
  }

  for (int i0 = 0; i0 < n; i0 += kQStep) {
    __syncthreads();   // every warp is done with the previous query tile
    load_tile<D, kQStep>(sq, q + base, i0, n);
    load_tile<D, kQStep>(sdo, dout + base, i0, n);
    if (threadIdx.x < kQStep) {
      const int i = i0 + threadIdx.x;
      slse[threadIdx.x] = i < n ? lse[rbase + i] : INFINITY;
      sdelta[threadIdx.x] = i < n ? delta[rbase + i] : 0.f;
    }
    __syncthreads();

    // S^T[16 keys x 32 queries] = K_w Q^T and dP^T = V_w dO^T
    float s[kST][4];
    float dp[kST][4];
#pragma unroll
    for (int j = 0; j < kST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      frag_a(ak, sk, LD, wr, kk * 16, grp, tig);
      frag_a(av, sv, LD, wr, kk * 16, grp, tig);
#pragma unroll
      for (int j = 0; j < kST; ++j) {
        uint32_t b[2];
        frag_bt(b, sq, LD, j * 8, kk * 16, grp, tig);
        mma_16816(s[j], ak, b);
        frag_bt(b, sdo, LD, j * 8, kk * 16, grp, tig);
        mma_16816(dp[j], av, b);
      }
    }

    // P^T = exp(S^T - lse[query]), dS^T = P^T o (dP^T - Delta[query]), as
    // bf16 A fragments: tiles 2kk and 2kk+1 hold queries 16kk..16kk+15
    uint32_t pa[kQStep / 16][4];
    uint32_t dsa[kQStep / 16][4];
#pragma unroll
    for (int j = 0; j < kST; ++j) {
      const int qc = j * 8 + tig * 2;
      const float l0 = slse[qc], l1 = slse[qc + 1];
      const float d0 = sdelta[qc], d1 = sdelta[qc + 1];
      const float p0 = __expf(s[j][0] - l0), p1 = __expf(s[j][1] - l1);
      const float p2 = __expf(s[j][2] - l0), p3 = __expf(s[j][3] - l1);
      pa[j / 2][(j % 2) * 2 + 0] = pack_f32(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_f32(p2, p3);
      dsa[j / 2][(j % 2) * 2 + 0] =
          pack_f32(p0 * (dp[j][0] - d0), p1 * (dp[j][1] - d1));
      dsa[j / 2][(j % 2) * 2 + 1] =
          pack_f32(p2 * (dp[j][2] - d0), p3 * (dp[j][3] - d1));
    }

    // dV += P^T dO, dK += dS^T Q over this tile's queries
#pragma unroll
    for (int kk = 0; kk < kQStep / 16; ++kk) {
#pragma unroll
      for (int t = 0; t < kOut; ++t) {
        uint32_t b[2];
        frag_b(b, sdo, LD, kk * 16, c0 + t * 8, grp, tig);
        mma_16816(acc_dv[t], pa[kk], b);
        frag_b(b, sq, LD, kk * 16, c0 + t * 8, grp, tig);
        mma_16816(acc_dk[t], dsa[kk], b);
      }
    }
  }

  const int row = j0 + wr + grp;
  store_rows<D>(dk + base, acc_dk, row, c0, n, tig);
  store_rows<D>(dv + base, acc_dv, row, c0, n, tig);
}

// Pass 2: dQ of 64 query rows, over every key.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dq, int n) {
  constexpr int LD = D + kPad;
  constexpr int kST = kKStep / 8;   // n8 tiles of S per warp
  constexpr int kOut = kDH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kRows * LD;
  bf16* sk = sdo + kRows * LD;
  bf16* sv = sk + kKStep * LD;

  const size_t base = (size_t)blockIdx.y * n * D;
  const size_t rbase = (size_t)blockIdx.y * n;
  const int i0 = blockIdx.x * kRows;
  const int c0 = blockIdx.z * kDH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wr = warp * 16;
  const int row = i0 + wr + grp;

  load_tile<D, kRows>(sq, q + base, i0, n);
  load_tile<D, kRows>(sdo, dout + base, i0, n);
  // rows grp and grp+8 of the warp; rows past n are computed, not stored
  const float l0 = row < n ? lse[rbase + row] : 0.f;
  const float l1 = row + 8 < n ? lse[rbase + row + 8] : 0.f;
  const float d0 = row < n ? delta[rbase + row] : 0.f;
  const float d1 = row + 8 < n ? delta[rbase + row + 8] : 0.f;

  float acc[kOut][4];
#pragma unroll
  for (int t = 0; t < kOut; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int j0 = 0; j0 < n; j0 += kKStep) {
    __syncthreads();
    load_tile<D, kKStep>(sk, k + base, j0, n);
    load_tile<D, kKStep>(sv, v + base, j0, n);
    __syncthreads();

    // S[16 queries x 64 keys] = Q_w K^T and dP = dO_w V^T
    float s[kST][4];
    float dp[kST][4];
#pragma unroll
    for (int j = 0; j < kST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll 2
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      frag_a(aq, sq, LD, wr, kk * 16, grp, tig);
      frag_a(ao, sdo, LD, wr, kk * 16, grp, tig);
#pragma unroll
      for (int j = 0; j < kST; ++j) {
        uint32_t b[2];
        frag_bt(b, sk, LD, j * 8, kk * 16, grp, tig);
        mma_16816(s[j], aq, b);
        frag_bt(b, sv, LD, j * 8, kk * 16, grp, tig);
        mma_16816(dp[j], ao, b);
      }
    }

    // dS = P o (dP - Delta[row]) as bf16 A fragments; keys past n: P = 0
    uint32_t dsa[kKStep / 16][4];
#pragma unroll
    for (int j = 0; j < kST; ++j) {
      const int kc = j0 + j * 8 + tig * 2;
      const float p0 = kc < n ? __expf(s[j][0] - l0) : 0.f;
      const float p1 = kc + 1 < n ? __expf(s[j][1] - l0) : 0.f;
      const float p2 = kc < n ? __expf(s[j][2] - l1) : 0.f;
      const float p3 = kc + 1 < n ? __expf(s[j][3] - l1) : 0.f;
      dsa[j / 2][(j % 2) * 2 + 0] =
          pack_f32(p0 * (dp[j][0] - d0), p1 * (dp[j][1] - d0));
      dsa[j / 2][(j % 2) * 2 + 1] =
          pack_f32(p2 * (dp[j][2] - d1), p3 * (dp[j][3] - d1));
    }

    // dQ += dS K over this tile's keys
#pragma unroll
    for (int kk = 0; kk < kKStep / 16; ++kk) {
#pragma unroll
      for (int t = 0; t < kOut; ++t) {
        uint32_t b[2];
        frag_b(b, sk, LD, kk * 16, c0 + t * 8, grp, tig);
        mma_16816(acc[t], dsa[kk], b);
      }
    }
  }

  store_rows<D>(dq + base, acc, row, c0, n, tig);
}

// --------------------------------------------------- Delta = rowsum(dO o O)
template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

constexpr int kDeltaThreads = 256;   // one warp per row

template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
bwd_delta(const T* __restrict__ dout, const T* __restrict__ out,
          float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * (kDeltaThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* a = dout + (size_t)row * D;
  const T* b = out + (size_t)row * D;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 32; ++c) {
    acc = fmaf(to_f32(a[lane + 32 * c]), to_f32(b[lane + 32 * c]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) delta[row] = acc;
}

// ----------------------------------------------------------------- f32 path
constexpr int kF32Threads = 256;             // 8 warps
constexpr int kF32Rows = 32;                 // rows a block owns, 4 per warp
constexpr int kF32Step = 32;                 // rows per step: one per lane
constexpr int kF32RowsPerWarp = kF32Rows / (kF32Threads / 32);

// Pass 1 in f32: dK and dV of 32 key rows; lane = query of the step.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int n) {
  constexpr int LDS = D + 1;       // lane-row reads on 32 banks
  constexpr int kCols = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + kF32Rows * D;
  float* sq = sv + kF32Rows * D;
  float* sdo = sq + kF32Step * LDS;
  float* slse = sdo + kF32Step * LDS;
  float* sdelta = slse + kF32Step;

  const size_t base = (size_t)blockIdx.y * n * D;
  const size_t rbase = (size_t)blockIdx.y * n;
  const int j0 = blockIdx.x * kF32Rows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kF32Rows * D; i += kF32Threads) {
    const int r = i / D;
    const bool live = j0 + r < n;
    sk[i] = live ? k[base + (size_t)j0 * D + i] : 0.f;
    sv[i] = live ? v[base + (size_t)j0 * D + i] : 0.f;
  }
  float acc_dk[kF32RowsPerWarp][kCols];
  float acc_dv[kF32RowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;
  }

  for (int i0 = 0; i0 < n; i0 += kF32Step) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Step * D; i += kF32Threads) {
      const int r = i / D;
      const int c = i % D;
      const bool live = i0 + r < n;
      sq[r * LDS + c] = live ? q[base + (size_t)(i0 + r) * D + c] : 0.f;
      sdo[r * LDS + c] = live ? dout[base + (size_t)(i0 + r) * D + c] : 0.f;
    }
    if (threadIdx.x < kF32Step) {
      const int i = i0 + threadIdx.x;
      slse[threadIdx.x] = i < n ? lse[rbase + i] : INFINITY;
      sdelta[threadIdx.x] = i < n ? delta[rbase + i] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kF32RowsPerWarp; ++r) {
      const float* kr = sk + (warp * kF32RowsPerWarp + r) * D;
      const float* vr = sv + (warp * kF32RowsPerWarp + r) * D;
      const float* qi = sq + lane * LDS;
      const float* oi = sdo + lane * LDS;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(kr[d], qi[d], s);
        dp = fmaf(vr[d], oi[d], dp);
      }
      const float p = expf(s - slse[lane]);
      const float ds = p * (dp - sdelta[lane]);
      for (int jq = 0; jq < kF32Step; ++jq) {
        const float pj = __shfl_sync(0xffffffffu, p, jq);
        const float dsj = __shfl_sync(0xffffffffu, ds, jq);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc_dv[r][c] = fmaf(pj, sdo[jq * LDS + lane + 32 * c], acc_dv[r][c]);
          acc_dk[r][c] = fmaf(dsj, sq[jq * LDS + lane + 32 * c], acc_dk[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    const int row = j0 + warp * kF32RowsPerWarp + r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[base + (size_t)row * D + lane + 32 * c] = acc_dk[r][c];
      dv[base + (size_t)row * D + lane + 32 * c] = acc_dv[r][c];
    }
  }
}

// Pass 2 in f32: dQ of 32 query rows; lane = key of the step.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, int n) {
  constexpr int LDS = D + 1;
  constexpr int kCols = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sdo = sq + kF32Rows * D;
  float* sk = sdo + kF32Rows * D;
  float* sv = sk + kF32Step * LDS;

  const size_t base = (size_t)blockIdx.y * n * D;
  const size_t rbase = (size_t)blockIdx.y * n;
  const int i0 = blockIdx.x * kF32Rows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kF32Rows * D; i += kF32Threads) {
    const bool live = i0 + i / D < n;
    sq[i] = live ? q[base + (size_t)i0 * D + i] : 0.f;
    sdo[i] = live ? dout[base + (size_t)i0 * D + i] : 0.f;
  }
  float l[kF32RowsPerWarp], dl[kF32RowsPerWarp];
  float acc[kF32RowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    const int row = i0 + warp * kF32RowsPerWarp + r;
    l[r] = row < n ? lse[rbase + row] : 0.f;
    dl[r] = row < n ? delta[rbase + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int j0 = 0; j0 < n; j0 += kF32Step) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Step * D; i += kF32Threads) {
      const int r = i / D;
      const int c = i % D;
      const bool live = j0 + r < n;
      sk[r * LDS + c] = live ? k[base + (size_t)(j0 + r) * D + c] : 0.f;
      sv[r * LDS + c] = live ? v[base + (size_t)(j0 + r) * D + c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kF32RowsPerWarp; ++r) {
      const float* qr = sq + (warp * kF32RowsPerWarp + r) * D;
      const float* orow = sdo + (warp * kF32RowsPerWarp + r) * D;
      const float* kj = sk + lane * LDS;
      const float* vj = sv + lane * LDS;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kj[d], s);
        dp = fmaf(orow[d], vj[d], dp);
      }
      const float p = j0 + lane < n ? expf(s - l[r]) : 0.f;
      const float ds = p * (dp - dl[r]);
      for (int jk = 0; jk < kF32Step; ++jk) {
        const float dsj = __shfl_sync(0xffffffffu, ds, jk);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[r][c] = fmaf(dsj, sk[jk * LDS + lane + 32 * c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    const int row = i0 + warp * kF32RowsPerWarp + r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dq[base + (size_t)row * D + lane + 32 * c] = acc[r][c];
    }
  }
}

// ------------------------------------------------------------------ launch
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t launch_delta(const void* dout, const void* out, float* delta,
                         int rows, cudaStream_t stream) {
  const int per_block = kDeltaThreads / 32;
  bwd_delta<T, D><<<(rows + per_block - 1) / per_block, kDeltaThreads, 0,
                    stream>>>(static_cast<const T*>(dout),
                              static_cast<const T*>(out), delta, rows);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv, int batch,
                        int n, cudaStream_t stream) {
  cudaError_t err = launch_delta<bf16, D>(dout, out, delta, batch * n, stream);
  if (err != cudaSuccess) return err;
  constexpr int LD = D + kPad;
  const size_t smem1 = (size_t)(2 * kRows + 2 * kQStep) * LD * sizeof(bf16) +
                       2 * kQStep * sizeof(float);
  const size_t smem2 = (size_t)(2 * kRows + 2 * kKStep) * LD * sizeof(bf16);
  if ((err = set_smem(bwd_dkdv_bf16<D>, smem1)) != cudaSuccess) return err;
  if ((err = set_smem(bwd_dq_bf16<D>, smem2)) != cudaSuccess) return err;
  const dim3 grid((n + kRows - 1) / kRows, batch, D / kDH);
  const bf16* bq = static_cast<const bf16*>(q);
  const bf16* bk = static_cast<const bf16*>(k);
  const bf16* bv = static_cast<const bf16*>(v);
  const bf16* bdo = static_cast<const bf16*>(dout);
  bwd_dkdv_bf16<D><<<grid, kThreads, smem1, stream>>>(
      bq, bk, bv, bdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dq_bf16<D><<<grid, kThreads, smem2, stream>>>(
      bq, bk, bv, bdo, lse, delta, static_cast<bf16*>(dq), n);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int batch,
                       int n, cudaStream_t stream) {
  cudaError_t err = launch_delta<float, D>(dout, out, delta, batch * n, stream);
  if (err != cudaSuccess) return err;
  const size_t smem1 =
      (size_t)(2 * kF32Rows * D + 2 * kF32Step * (D + 1) + 2 * kF32Step) *
      sizeof(float);
  const size_t smem2 =
      (size_t)(2 * kF32Rows * D + 2 * kF32Step * (D + 1)) * sizeof(float);
  if ((err = set_smem(bwd_dkdv_f32<D>, smem1)) != cudaSuccess) return err;
  if ((err = set_smem(bwd_dq_f32<D>, smem2)) != cudaSuccess) return err;
  const dim3 grid((n + kF32Rows - 1) / kF32Rows, batch);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  bwd_dkdv_f32<D><<<grid, kF32Threads, smem1, stream>>>(
      fq, fk, fv, fdo, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dq_f32<D><<<grid, kF32Threads, smem2, stream>>>(
      fq, fk, fv, fdo, lse, delta, static_cast<float*>(dq), n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  `lse` is the forward kernel's row
// logsumexp ([B, N] f32); `delta` is a [B, N] f32 workspace.  Writes
// dtheta, dphi and dg.  Returns a cudaError_t value.
int bsr_nonlocal_attn_bwd(const void* theta, const void* phi, const void* g,
                          const void* out, const void* dout, const void* lse,
                          void* delta, void* dtheta, void* dphi, void* dg,
                          int batch, int n, int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (batch < 1 || batch > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && d == 128)
    return (int)launch_bf16<128>(theta, phi, g, out, dout, l, dl, dtheta, dphi, dg, batch, n, s);
  if (dtype == 1 && d == 256)
    return (int)launch_bf16<256>(theta, phi, g, out, dout, l, dl, dtheta, dphi, dg, batch, n, s);
  if (dtype == 0 && d == 128)
    return (int)launch_f32<128>(theta, phi, g, out, dout, l, dl, dtheta, dphi, dg, batch, n, s);
  if (dtype == 0 && d == 256)
    return (int)launch_f32<256>(theta, phi, g, out, dout, l, dl, dtheta, dphi, dg, batch, n, s);
  return (int)cudaErrorInvalidValue;
}

const char* bsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
