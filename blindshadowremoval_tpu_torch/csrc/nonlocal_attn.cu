// NonLocal attention forward, out = softmax(theta . phi^T) . g, for Hopper.
//
// Replaces the TPU kernel `_attn_kernel` of
// blindshadowremoval_tpu/ops/pallas/nonlocal_attn.py (lines 70-81, launched
// by `_pallas_attention`).  Operands are [B, N, D] row-major, D in {128, 256};
// there is no 1/sqrt(D) scale.
//
// What bounds it on the card: one call at the serving shape (B=128, N=1024,
// D=128, bf16) does 4*B*N^2*D = 68.7 GFLOP over 4*B*N*D*2 B = 134 MB of
// operands and output, 512 FLOP per byte, above the H100's ~295 FLOP/B
// ridge: it is bounded by the tensor cores (~69 us at 989 TFLOP/s dense bf16;
// the bytes alone take ~40 us at 3.35 TB/s).
//
// What the design does about it:
//  * The TPU kernel holds the whole N x N score tile (4 MB) in VMEM; a Hopper
//    block gets at most 227 KB of shared memory.  So one block owns one
//    (batch, 64-row query tile) and walks the key/value tiles of 64 rows
//    with an online softmax (running row max and row sum in f32, the
//    accumulator rescaled when the max grows): the scores never reach device
//    memory, and theta/phi/g are read from device memory once per query tile.
//  * bf16: both products run on the tensor cores through mma.sync m16n8k16
//    (bf16 in, f32 accumulate).  Each of the 4 warps owns 16 query rows; the
//    score accumulators are re-packed in registers as the A operand of the
//    second product, so P never touches shared memory.
//  * f32: CUDA cores in full f32 (no TF32), one warp per query row at a time,
//    so strict-f32 parity needs no bypass.  Not on the serving path.
//  * A ragged tail of N is masked: missing keys score -inf, missing query
//    rows are computed on zeros and not stored.
//  Not yet: wgmma, TMA, cp.async double buffering, warp specialisation.
//
// Numerics: the TPU kernel casts the NORMALIZED weights to g's dtype before
// the second product.  Here the unnormalized exp(s - running max) values are
// cast to bf16, and the f32 accumulator is divided by the f32 row sum at the
// end; each weight is still rounded once to bf16, so the error stays at the
// bf16 rounding of the weights.
//
// C interface (loaded with ctypes): bsr_nonlocal_attn_fwd returns a
// cudaError_t value, 0 on success; the launch runs on `stream`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- bf16 path
constexpr int kBfBlockM = 64;   // query rows per block (16 per warp)
constexpr int kBfBlockN = 64;   // keys per tile
constexpr int kBfThreads = 128;
constexpr int kBfPad = 8;       // row padding in elements (16 B): the
                                // fragment loads below hit 32 banks

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
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

// rows [row0, row0+ROWS) of a [n, D] matrix into shared memory with row
// stride D + kBfPad, 16 B per load; rows past n are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int row0, int n) {
  constexpr int kChunks = D / 8;  // 16 B chunks per row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kBfThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + col);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + kBfPad) + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kBfThreads)
attn_fwd_bf16(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int n) {
  constexpr int LD = D + kBfPad;
  constexpr int kTiles = kBfBlockN / 8;   // n8 tiles of the score block
  constexpr int kOut = D / 8;             // n8 tiles of the output block
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + kBfBlockM * LD;
  __nv_bfloat16* sv = sk + kBfBlockN * LD;

  const size_t base = (size_t)blockIdx.y * n * D;
  const int m0 = blockIdx.x * kBfBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wr = warp * 16;               // warp's first row in the tile

  load_tile_bf16<D, kBfBlockM>(sq, q + base, m0, n);

  float acc[kOut][4];
#pragma unroll
  for (int t = 0; t < kOut; ++t) {
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  }
  // rows grp and grp+8 of the warp's 16; the sums are this thread's
  // partial over its columns, reduced across the 4 lanes at the end
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};

  for (int n0 = 0; n0 < n; n0 += kBfBlockN) {
    __syncthreads();   // every warp is done with the previous K/V tile
    load_tile_bf16<D, kBfBlockN>(sk, k + base, n0, n);
    load_tile_bf16<D, kBfBlockN>(sv, v + base, n0, n);
    __syncthreads();

    // S[16 x 64] = Q_w . K^T
    float s[kTiles][4];
#pragma unroll
    for (int j = 0; j < kTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qa = sq + (wr + grp) * LD + kk * 16 + tig * 2;
      const uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * LD), ld_u32(qa + 8),
                             ld_u32(qa + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const __nv_bfloat16* kb = sk + (j * 8 + grp) * LD + kk * 16 + tig * 2;
        const uint32_t b[2] = {ld_u32(kb), ld_u32(kb + 8)};
        mma_16816(s[j], a, b);
      }
    }
    if (n0 + kBfBlockN > n) {   // ragged tail: keys past n score -inf
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (n0 + j * 8 + tig * 2 + (e & 1) >= n) s[j][e] = -INFINITY;
        }
      }
    }

    // online softmax: new row max over the 4 lanes that share a row
    float mx[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // every tile holds at least one live key, so mx is finite and
    // exp(-inf - mx) = 0 on the first tile
    const float alpha[2] = {__expf(row_max[0] - mx[0]),
                            __expf(row_max[1] - mx[1])};
    row_max[0] = mx[0];
    row_max[1] = mx[1];

    // P = exp(S - max) as bf16 A fragments of the second product: score
    // tiles 2kk and 2kk+1 hold keys 16kk..16kk+15 in exactly the A layout
    uint32_t p[kBfBlockN / 16][4];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const float e0 = __expf(s[j][0] - mx[0]);
      const float e1 = __expf(s[j][1] - mx[0]);
      const float e2 = __expf(s[j][2] - mx[1]);
      const float e3 = __expf(s[j][3] - mx[1]);
      psum[0] += e0 + e1;
      psum[1] += e2 + e3;
      p[j / 2][(j % 2) * 2 + 0] = pack_f32(e0, e1);
      p[j / 2][(j % 2) * 2 + 1] = pack_f32(e2, e3);
    }
    row_sum[0] = row_sum[0] * alpha[0] + psum[0];
    row_sum[1] = row_sum[1] * alpha[1] + psum[1];

    // O = O * alpha + P . V
#pragma unroll
    for (int t = 0; t < kOut; ++t) {
      acc[t][0] *= alpha[0];
      acc[t][1] *= alpha[0];
      acc[t][2] *= alpha[1];
      acc[t][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBfBlockN / 16; ++kk) {
#pragma unroll
      for (int t = 0; t < kOut; ++t) {
        const __nv_bfloat16* vb = sv + (kk * 16 + tig * 2) * LD + t * 8 + grp;
        const uint32_t b[2] = {pack_bf16(vb[0], vb[LD]),
                               pack_bf16(vb[8 * LD], vb[9 * LD])};
        mma_16816(acc[t], p[kk], b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
  }
  const float inv0 = 1.f / row_sum[0];
  const float inv1 = 1.f / row_sum[1];
  const int row = m0 + wr + grp;
#pragma unroll
  for (int t = 0; t < kOut; ++t) {
    const int col = t * 8 + tig * 2;
    if (row < n) {
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row * D + col) =
          __floats2bfloat162_rn(acc[t][0] * inv0, acc[t][1] * inv0);
    }
    if (row + 8 < n) {
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)(row + 8) * D + col) =
          __floats2bfloat162_rn(acc[t][2] * inv1, acc[t][3] * inv1);
    }
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int kF32BlockM = 32;  // query rows per block (4 per warp)
constexpr int kF32BlockN = 32;  // keys per tile: one per lane
constexpr int kF32Threads = 256;
constexpr int kF32RowsPerWarp = kF32BlockM / (kF32Threads / 32);

template <int D>
__global__ void __launch_bounds__(kF32Threads)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int n) {
  constexpr int LDK = D + 1;      // lane j reads K row j: stride D+1 keeps
                                  // the 32 lanes on 32 banks
  constexpr int kCols = D / 32;   // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sk = sq + kF32BlockM * D;
  float* sv = sk + kF32BlockN * LDK;

  const size_t base = (size_t)blockIdx.y * n * D;
  const int m0 = blockIdx.x * kF32BlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kF32BlockM * D; i += kF32Threads) {
    const int r = i / D;
    sq[i] = (m0 + r < n) ? q[base + (size_t)(m0 + r) * D + i % D] : 0.f;
  }
  float acc[kF32RowsPerWarp][kCols];
  float row_max[kF32RowsPerWarp];
  float row_sum[kF32RowsPerWarp];
#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    row_max[r] = -INFINITY;
    row_sum[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int n0 = 0; n0 < n; n0 += kF32BlockN) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32BlockN * D; i += kF32Threads) {
      const int r = i / D;
      const int c = i % D;
      const bool live = n0 + r < n;
      sk[r * LDK + c] = live ? k[base + (size_t)(n0 + r) * D + c] : 0.f;
      sv[i] = live ? v[base + (size_t)(n0 + r) * D + c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kF32RowsPerWarp; ++r) {
      const float* qr = sq + (warp * kF32RowsPerWarp + r) * D;
      const float* kr = sk + lane * LDK;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      if (n0 + lane >= n) s = -INFINITY;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      mx = fmaxf(mx, row_max[r]);
      const float alpha = expf(row_max[r] - mx);
      const float p = expf(s - mx);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      }
      row_max[r] = mx;
      row_sum[r] = row_sum[r] * alpha + ps;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      for (int j = 0; j < kF32BlockN; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[r][c] = fmaf(pj, sv[j * D + lane + 32 * c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    const int row = m0 + warp * kF32RowsPerWarp + r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      o[base + (size_t)row * D + lane + 32 * c] = acc[r][c] / row_sum[r];
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int batch, int n, cudaStream_t stream) {
  const size_t smem =
      (size_t)(kBfBlockM + 2 * kBfBlockN) * (D + kBfPad) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBfBlockM - 1) / kBfBlockM, batch);
  attn_fwd_bf16<D><<<grid, kBfThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int batch, int n, cudaStream_t stream) {
  const size_t smem =
      (size_t)(kF32BlockM * D + kF32BlockN * (D + 1) + kF32BlockN * D) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kF32BlockM - 1) / kF32BlockM, batch);
  attn_fwd_f32<D><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t value.
int bsr_nonlocal_attn_fwd(const void* theta, const void* phi, const void* g,
                          void* out, int batch, int n, int d, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && d == 128) return (int)launch_bf16<128>(theta, phi, g, out, batch, n, s);
  if (dtype == 1 && d == 256) return (int)launch_bf16<256>(theta, phi, g, out, batch, n, s);
  if (dtype == 0 && d == 128) return (int)launch_f32<128>(theta, phi, g, out, batch, n, s);
  if (dtype == 0 && d == 256) return (int)launch_f32<256>(theta, phi, g, out, batch, n, s);
  return (int)cudaErrorInvalidValue;
}

const char* bsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
