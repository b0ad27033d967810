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
// the bytes alone take ~40 us at 3.35 TB/s).  Only wgmma reaches that rate,
// and only when its operands arrive without stalling it.
//
// What the design does about it (FlashAttention-3's forward, fitted to this
// op):
//  * The TPU kernel holds the whole N x N score tile (4 MB) in VMEM; a
//    Hopper block gets at most 227 KB of shared memory.  So one block owns
//    one (batch, 128-row query tile) and walks the key/value tiles with an
//    online softmax (running row max and row sum in f32, the accumulator
//    rescaled when the max grows): the scores never reach device memory.
//    Grid (query tiles, B): the tiles of one batch element run side by side
//    and share its keys and values through L2.
//  * bf16, warp-specialised, 3 warpgroups.  Warpgroup 0 is the producer:
//    one thread issues TMA loads of Q and of each K and V tile into a
//    2-stage ring of 128-byte-swizzled shared memory, and the group gives
//    its registers up (setmaxnreg).  Warpgroups 1 and 2 are consumers, 64
//    query rows each, with 240 registers a thread.  Full and empty
//    mbarriers per stage, separate for K and V, hand the ring back and
//    forth, so the loads of tile j+2 overlap the products of tile j.
//  * Both products are wgmma (bf16 in, f32 accumulate).  S = Q K^T takes Q
//    and K from shared memory (K-major); O += P V takes P from registers
//    (the f32 score fragment re-packed as bf16 A fragments, so P never
//    touches shared memory) and V from shared memory (MN-major, transposed
//    by the descriptor).  The P V of tile j and the Q K^T of tile j+1 go
//    out as one group, and the two consumers issue their groups in turns
//    (named barriers, FlashAttention-3's ping-pong): the tensor cores run
//    one consumer's products while the other computes its softmax.
//  * Tiles: D=128 takes 128-key tiles (K, V 32 KB each; ring and Q 160 KB);
//    D=256 takes 64-key tiles (ring 128 KB, Q 64 KB) so that the 64x256 f32
//    accumulator (128 registers a thread) and S fit.
//  * 3-D tensor maps over [B, N, D]: a ragged last tile reads zeros, not
//    the next batch element's rows, and its keys past N score -inf.  The
//    output goes back through shared memory (each consumer's own Q rows)
//    with a 3-D TMA store, which clips at row N.
//  * f32: CUDA cores in full f32 (no TF32), one warp per query row at a time,
//    so strict-f32 parity needs no bypass.  Not on the serving path.
//  * Training: when `lse` is not null, the kernel also writes each row's
//    logsumexp (f32, [B, N]), max + log(sum), which the backward kernel
//    (nonlocal_attn_bwd.cu) takes to recompute the weights without a second
//    softmax pass.  The serving path passes null and writes nothing extra.
//  Measured and left out (one H100, PERF.md): a 3-stage ring at D=128, a
//  persistent grid whose loads of the next query tile overlap this one's
//  epilogue, and FlashAttention-3's overlap of the softmax with P V inside
//  a warpgroup; none was faster at N = 1024, where a block walks only 8
//  key tiles.
//
// Numerics: the TPU kernel casts the NORMALIZED weights to g's dtype before
// the second product.  Here the unnormalized exp(s - running max) values are
// cast to bf16, and the f32 accumulator is divided by the f32 row sum at the
// end; each weight is still rounded once to bf16, so the error stays at the
// bf16 rounding of the weights.
//
// C interface (loaded with ctypes): bsr_nonlocal_attn_fwd returns a
// cudaError_t value, 0 on success; the launch runs on `stream`.  The tensor
// maps are encoded on the host at each call with cuTensorMapEncodeTiled,
// looked up at run time (no link against libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- bf16 path
constexpr int kBlockM = 128;        // query rows per block, 64 per consumer
constexpr int kThreads = 384;       // producer + 2 consumer warpgroups
constexpr int kStages = 2;          // K/V ring depth
// named barriers: 1 + cw for consumer cw's epilogue, kTurn + cw for its
// turn to issue wgmma (ping-pong)
constexpr uint32_t kTurn = 3;
constexpr int kPanelCols = 64;      // bf16 columns of one 128-byte panel
constexpr int kProducerRegs = 24;   // setmaxnreg: 128 * 24 + 256 * 240
constexpr int kConsumerRegs = 240;  // <= 65536; D=256 spills at 232
constexpr float kLog2e = 1.4426950408889634f;

// The mbarriers of the ring, in shared memory after the tiles.
struct Barriers {
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t k_empty[kStages];   // two arrivals: one per consumer
  uint64_t v_empty[kStages];
};

template <int D>
struct Tiles {
  static constexpr int kBlockN = D == 128 ? 128 : 64;   // keys per tile
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kQPanel = kBlockM * 128;          // bytes
  static constexpr int kKVPanel = kBlockN * 128;
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKVBytes = kPanels * kKVPanel;    // one K or V tile
  // the tiles, the barriers, and slack to align the tiles to 1024 bytes
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes +
                               sizeof(Barriers) + 1024;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S[64 x BN] = Q_rows . K^T over D, issued (not waited for)
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Tiles<D>::kBlockN / 2],
                                         uint32_t q, uint32_t k) {
  using T = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // a 16-column step: 32 bytes along the swizzled row, panel by panel
    const uint32_t off = (kk / 4);
    const uint64_t da = bsr::desc_sw128(q + off * T::kQPanel + (kk % 4) * 32,
                                        16, 1024);
    const uint64_t db = bsr::desc_sw128(k + off * T::kKVPanel + (kk % 4) * 32,
                                        16, 1024);
    if constexpr (T::kBlockN == 128) {
      bsr::wgmma_ss_m64n128k16(s, da, db, kk > 0);
    } else {
      bsr::wgmma_ss_m64n64k16(s, da, db, kk > 0);
    }
  }
}

// O[64 x D] += P[64 x BN] . V[BN x D], issued (not waited for)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&p)[Tiles<D>::kBlockN / 16][4],
                                         uint32_t v) {
  using T = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < T::kBlockN / 16; ++kk) {
    // 16 keys = 16 rows of 128 bytes in every panel
#pragma unroll
    for (int h = 0; h < D / 128; ++h) {
      const uint64_t db = bsr::desc_sw128(
          v + kk * 2048 + h * 2 * T::kKVPanel, T::kKVPanel, 1024);
      bsr::wgmma_rs_m64n128k16_tb(*reinterpret_cast<float(*)[64]>(o + 64 * h),
                                  p[kk], db, 1);
    }
  }
}

// One step of a consumer warpgroup on key tile t, whose scores S are in
// `s`: the online softmax, then O += P V_t and, unless t is the last tile,
// S = Q K_{t+1}^T, issued as one group.
template <int D, bool kLast>
__device__ __forceinline__ void consume_tile(
    int t, int n, float (&o)[D / 2], float (&s)[Tiles<D>::kBlockN / 2],
    uint32_t (&p)[Tiles<D>::kBlockN / 16][4], float (&row_max)[2],
    float (&row_sum)[2], Barriers* bars, uint32_t q, uint32_t k0,
    uint32_t v0, int tig, bool signal, int cw) {
  using T = Tiles<D>;
  constexpr int BN = T::kBlockN;
  const int st = t % kStages;
  if (kLast && (t + 1) * BN > n) {   // ragged tail: keys past n score -inf
    const int live = n - t * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j * 8 + tig * 2 + (e & 1) >= live) s[4 * j + e] = -INFINITY;
      }
    }
  }

  // online softmax: new row max over the 4 lanes that share a row
  float mx[2] = {row_max[0], row_max[1]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  // every tile holds at least one live key, so mx is finite and
  // exp(-inf - mx) = 0 on the first tile
  const float alpha[2] = {fast_exp2((row_max[0] - mx[0]) * kLog2e),
                          fast_exp2((row_max[1] - mx[1]) * kLog2e)};
  row_max[0] = mx[0];
  row_max[1] = mx[1];

  // P = exp(S - max) as bf16 A fragments of the second product: score
  // blocks 2kk and 2kk+1 hold keys 16kk..16kk+15 in exactly the A layout
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float e0 = fast_exp2((s[4 * j] - mx[0]) * kLog2e);
    const float e1 = fast_exp2((s[4 * j + 1] - mx[0]) * kLog2e);
    const float e2 = fast_exp2((s[4 * j + 2] - mx[1]) * kLog2e);
    const float e3 = fast_exp2((s[4 * j + 3] - mx[1]) * kLog2e);
    psum[0] += e0 + e1;
    psum[1] += e2 + e3;
    p[j / 2][(j % 2) * 2 + 0] = pack_f32(e0, e1);
    p[j / 2][(j % 2) * 2 + 1] = pack_f32(e2, e3);
  }
  row_sum[0] = row_sum[0] * alpha[0] + psum[0];
  row_sum[1] = row_sum[1] * alpha[1] + psum[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }

  bsr::mbar_wait(&bars->v_full[st], (t / kStages) & 1);
  if (!kLast) {
    bsr::mbar_wait(&bars->k_full[(t + 1) % kStages],
                   ((t + 1) / kStages) & 1);
  }
  bsr::fence_regs(o);
  bsr::fence_regs(s);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) bsr::fence_regs(p[kk]);
  bsr::named_barrier(kTurn + cw, 256);   // wait for this consumer's turn
  bsr::wgmma_fence();
  issue_pv<D>(o, p, v0 + st * T::kKVBytes);
  if (!kLast) issue_qk<D>(s, q, k0 + ((t + 1) % kStages) * T::kKVBytes);
  bsr::wgmma_commit();
  // the other consumer's turn; consumer 1's last group passes the turn to
  // no one, so every arrival meets a wait
  if (!(kLast && cw == 1)) bsr::named_barrier_arrive(kTurn + (cw ^ 1), 256);
  bsr::wgmma_wait_all();
  bsr::fence_regs(o);
  bsr::fence_regs(s);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) bsr::fence_regs(p[kk]);
  if (signal) {   // V_t and K_{t+1} are read: hand their stages back
    bsr::mbar_arrive(&bars->v_empty[st]);
    if (!kLast) bsr::mbar_arrive(&bars->k_empty[(t + 1) % kStages]);
  }
}

// One consumer warpgroup (cw = 0, 1): 64 query rows, every key tile, then
// the logsumexp and the output rows.
template <int D>
__device__ __forceinline__ void consume(unsigned char* sq, unsigned char* sk,
                                        unsigned char* sv, Barriers* bars,
                                        const CUtensorMap* o_map,
                                        float* __restrict__ lse, int n,
                                        int m0, int cw) {
  using T = Tiles<D>;
  constexpr int BN = T::kBlockN;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int tiles = (n + BN - 1) / BN;
  const uint32_t q = bsr::smem_addr(sq) + cw * 64 * 128;
  const uint32_t k0 = bsr::smem_addr(sk);
  const uint32_t v0 = bsr::smem_addr(sv);

  float o[D / 2];
  float s[BN / 2];
  uint32_t p[BN / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  // rows grp and grp+8 of the warp's 16; the sums are this thread's
  // partial over its columns, reduced across the 4 lanes at the end
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};

  bsr::mbar_wait(&bars->q_full, 0);
  bsr::mbar_wait(&bars->k_full[0], 0);
  bsr::fence_regs(s);
  // ping-pong: the consumers issue their wgmma groups in turns, consumer 0
  // first, so that one's softmax runs while the other's products do
  if (cw == 1) bsr::named_barrier_arrive(kTurn, 256);
  bsr::named_barrier(kTurn + cw, 256);
  bsr::wgmma_fence();
  issue_qk<D>(s, q, k0);
  bsr::wgmma_commit();
  bsr::named_barrier_arrive(kTurn + (cw ^ 1), 256);
  bsr::wgmma_wait_all();
  bsr::fence_regs(s);
  if (tid == 0) bsr::mbar_arrive(&bars->k_empty[0]);

  for (int t = 0; t + 1 < tiles; ++t) {
    consume_tile<D, false>(t, n, o, s, p, row_max, row_sum, bars, q, k0, v0,
                           tig, tid == 0, cw);
  }
  consume_tile<D, true>(tiles - 1, n, o, s, p, row_max, row_sum, bars, q, k0,
                        v0, tig, tid == 0, cw);

  // epilogue: row sums over the 4 lanes, the logsumexp, O / sum as bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
  }
  const int r0 = warp * 16 + grp;   // row within this warpgroup's 64
  const int row = m0 + cw * 64 + r0;
  if (lse != nullptr && tig == 0) {
    const size_t base = (size_t)blockIdx.y * n;
    if (row < n) lse[base + row] = row_max[0] + logf(row_sum[0]);
    if (row + 8 < n) lse[base + row + 8] = row_max[1] + logf(row_sum[1]);
  }
  const float inv[2] = {1.f / row_sum[0], 1.f / row_sum[1]};
  // this warpgroup's Q rows are free now: stage O there in the swizzled
  // layout the O tensor map reads, then one thread stores it
  bsr::named_barrier(1 + cw, 128);
  unsigned char* so = sq + cw * 64 * 128;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int panel = j / 8;
    const int chunk = j % 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      unsigned char* dst = so + panel * T::kQPanel + r * 128 +
                           ((chunk ^ (r & 7)) * 16) + tig * 4;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_f32(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
    }
  }
  bsr::fence_proxy_async();
  bsr::named_barrier(1 + cw, 128);
  if (tid == 0) {
#pragma unroll
    for (int pn = 0; pn < T::kPanels; ++pn) {
      bsr::tma_store_3d(o_map, so + pn * T::kQPanel, pn * kPanelCols,
                        m0 + cw * 64, blockIdx.y);
    }
    bsr::bulk_commit();
    bsr::bulk_wait_read<0>();
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_bf16(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const __grid_constant__ CUtensorMap o_map,
              float* __restrict__ lse, int n) {
  using T = Tiles<D>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* smem =
      smem_raw + ((1024 - (bsr::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sq = smem;
  unsigned char* sk = sq + T::kQBytes;               // [stage][panel][BN][128 B]
  unsigned char* sv = sk + kStages * T::kKVBytes;
  Barriers* bars = reinterpret_cast<Barriers*>(sv + kStages * T::kKVBytes);

  if (threadIdx.x == 0) {
    bsr::mbar_init(&bars->q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bsr::mbar_init(&bars->k_full[s], 1);
      bsr::mbar_init(&bars->v_full[s], 1);
      bsr::mbar_init(&bars->k_empty[s], 2);
      bsr::mbar_init(&bars->v_empty[s], 2);
    }
    bsr::mbar_fence_init();
  }
  __syncthreads();

  const int m0 = blockIdx.x * kBlockM;
  const int b = blockIdx.y;
  // the warpgroup index through a shuffle, so that ptxas sees a branch
  // uniform per warp (setmaxnreg is .sync.aligned)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer warpgroup: one thread keeps the ring full
    bsr::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int tiles = (n + T::kBlockN - 1) / T::kBlockN;
      bsr::mbar_expect_tx(&bars->q_full, T::kQBytes);
      for (int pn = 0; pn < T::kPanels; ++pn) {
        bsr::tma_load_3d(sq + pn * T::kQPanel, &q_map, &bars->q_full,
                         pn * kPanelCols, m0, b);
      }
      for (int t = 0; t < tiles; ++t) {
        const int st = t % kStages;
        // the first pass over the ring finds every stage empty
        const uint32_t phase = ((t / kStages) & 1) ^ 1;
        bsr::mbar_wait(&bars->k_empty[st], phase);
        bsr::mbar_expect_tx(&bars->k_full[st], T::kKVBytes);
        for (int pn = 0; pn < T::kPanels; ++pn) {
          bsr::tma_load_3d(sk + st * T::kKVBytes + pn * T::kKVPanel, &k_map,
                           &bars->k_full[st], pn * kPanelCols, t * T::kBlockN, b);
        }
        bsr::mbar_wait(&bars->v_empty[st], phase);
        bsr::mbar_expect_tx(&bars->v_full[st], T::kKVBytes);
        for (int pn = 0; pn < T::kPanels; ++pn) {
          bsr::tma_load_3d(sv + st * T::kKVBytes + pn * T::kKVPanel, &v_map,
                           &bars->v_full[st], pn * kPanelCols, t * T::kBlockN, b);
        }
      }
    }
  } else {
    bsr::setmaxnreg_inc<kConsumerRegs>();
    consume<D>(sq, sk, sv, bars, &o_map, lse, n, m0, wg - 1);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int batch, int n, cudaStream_t stream) {
  using T = Tiles<D>;
  // first, since it binds the device's context to this thread, which the
  // encoder needs: a call can come from a thread that has none (the
  // autograd engine's, recomputing a checkpointed forward)
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  bsr::EncodeTiled encode = bsr::encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap qm, km, vm, om;
  if (!bsr::encode_map(&qm, encode, q, batch, n, D, kBlockM) ||
      !bsr::encode_map(&km, encode, k, batch, n, D, T::kBlockN) ||
      !bsr::encode_map(&vm, encode, v, batch, n, D, T::kBlockN) ||
      !bsr::encode_map(&om, encode, o, batch, n, D, 64)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((n + kBlockM - 1) / kBlockM, batch);
  attn_fwd_bf16<D><<<grid, kThreads, T::kSmem, stream>>>(qm, km, vm, om, lse,
                                                         n);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 path
constexpr int kF32BlockM = 32;  // query rows per block (4 per warp)
constexpr int kF32BlockN = 32;  // keys per tile: one per lane
constexpr int kF32Threads = 256;
constexpr int kF32RowsPerWarp = kF32BlockM / (kF32Threads / 32);

template <int D>
__global__ void __launch_bounds__(kF32Threads)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int n) {
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
    if (lse != nullptr && lane == 0) {
      lse[(size_t)blockIdx.y * n + row] = row_max[r] + logf(row_sum[r]);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      o[base + (size_t)row * D + lane + 32 * c] = acc[r][c] / row_sum[r];
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int batch, int n, cudaStream_t stream) {
  const size_t smem =
      (size_t)(kF32BlockM * D + kF32BlockN * (D + 1) + kF32BlockN * D) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kF32BlockM - 1) / kF32BlockM, batch);
  attn_fwd_f32<D><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  `lse` ([B, N] f32) may be null.
// Returns a cudaError_t value.
int bsr_nonlocal_attn_fwd(const void* theta, const void* phi, const void* g,
                          void* out, void* lse, int batch, int n, int d,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (batch < 1 || batch > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && d == 128) return (int)launch_bf16<128>(theta, phi, g, out, l, batch, n, s);
  if (dtype == 1 && d == 256) return (int)launch_bf16<256>(theta, phi, g, out, l, batch, n, s);
  if (dtype == 0 && d == 128) return (int)launch_f32<128>(theta, phi, g, out, l, batch, n, s);
  if (dtype == 0 && d == 256) return (int)launch_f32<256>(theta, phi, g, out, l, batch, n, s);
  return (int)cudaErrorInvalidValue;
}

const char* bsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
