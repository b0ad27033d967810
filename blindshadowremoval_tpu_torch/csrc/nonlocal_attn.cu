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
//  * f32 (the evaluators' parity path: every f32 forward).  Bound: the
//    4*B*N^2*D FLOP must come out to f32 accuracy (KERNEL_TOLERANCE), which
//    one TF32 pass misses by 50-340x; on the CUDA cores (67 TFLOP/s) they
//    take 0.64 ms at (80, 1024, 128), and the kernel this replaces, one key
//    a lane and two shared-memory loads an FMA, took 4.06 ms there.  So
//    both products run on the tensor cores as 3xTF32 (hopper.cuh): three
//    TF32 passes at 495 TFLOP/s, 0.26 ms at that shape.  On mma.sync the
//    same design ran no faster than SDPA's memory-efficient f32 kernel,
//    which runs 3xTF32 on mma.sync too, however few instructions it spent
//    around the products, so the products are wgmma, the only way to the
//    tensor cores' full rate.  A tf32 wgmma reads both operands
//    K-major and B only from shared memory: each key tile is split once
//    per block into big and small parts and stored K-major with the
//    128-byte swizzle (K as it lies, V transposed, its keys in the order
//    in which P's score fragment holds them); A comes from registers (Q's
//    rows read from shared memory and split, P split as it lies).  The
//    tensor cores align a sum's addends to the largest and truncate, so a
//    sum carried through their accumulator drifts by an ulp of its running
//    value a step, all one way (past KERNEL_TOLERANCE at D=256 with P V
//    carried over every key): each 8-column step of S and each 32-key tile
//    of P V goes into a fresh accumulator, added by f32 adds.  Two
//    warpgroups, 256 threads: at D=128 64 query rows each, at D=256 the
//    same 64 rows, each half the score sum (exchanged through shared
//    memory) and half the output columns, which keeps the 64x128 f32
//    accumulator a warpgroup's.  32-key tiles, loaded into registers
//    while the softmax and P V of the tile before run.  A grid too small
//    to fill the card's SMs in whole waves (B <= 10 at N = 1024) splits
//    the keys into up to 4 shares (key_splits); a second kernel combines
//    the shares' unnormalised O, row max and row sum in share order.  No
//    atomics: the same inputs give the same bits from run to run.
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
// cudaError_t value, 0 on success; the launches run on `stream`; its f32
// scratch holds bsr_nonlocal_attn_fwd_workspace floats.  The tensor
// maps are encoded on the host at each call with cuTensorMapEncodeTiled,
// looked up at run time (no link against libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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
  // first, since its first call on a thread binds the device's context
  // there, which the encoder needs: a call can come from a thread that has
  // none (the autograd engine's, recomputing a checkpointed forward)
  static thread_local uint64_t attr_set = 0;
  cudaError_t err = bsr::smem_limit_once(attr_set, attn_fwd_bf16<D>, T::kSmem);
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
namespace f32 {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kKeys = 32;       // keys per tile: V^T's rows are one 128-byte
                                // panel of them
constexpr int kWidth = 128;     // output columns a warpgroup holds

// D=128: the warpgroups take query rows 0-63 and 64-127 of the block, all
// columns.  D=256: both take the block's 64 rows; warpgroup w sums the
// scores over columns 128w..128w+127 of D, the two halves are exchanged
// through shared memory and added (in the same order on both sides), and
// w holds output columns 128w..128w+127.  Shared memory, 1024-byte
// aligned: K_t's big and small parts, [D/32 panels][kKeys rows][128 B];
// V_t^T's, [D rows][128 B]; both K-major with the 128-byte swizzle of the
// wgmma descriptors; Q as loaded, rows of D + 4 floats, which put the
// A-fragment reads on 32 banks; at D=256 the exchanged score halves.
template <int D>
struct Cfg {
  static constexpr bool kSplitK = D == 256;
  static constexpr int kPvHalves = kSplitK ? 2 : 1;
  static constexpr int kRows = kSplitK ? 64 : 128;
  static constexpr int kLdQ = D + 4;
  static constexpr int kKPart = kKeys * D * 4;      // bytes
  static constexpr int kVPart = D * kKeys * 4;
  static constexpr int kExchange = kSplitK ? 2 * 128 * (kKeys / 2) * 4 : 0;
  static constexpr int kPerThread = kKeys * D / 4 / kThreads;   // float4s
  static constexpr int kSmem = 2 * kKPart + 2 * kVPart + kRows * kLdQ * 4 +
                               kExchange + 1024;
  static_assert(kSmem <= 232448, "more shared memory than a block may have");
};

// byte offset of `byte` of row `row` in a K-major 128-byte-swizzled panel
__device__ __forceinline__ int swizzled(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// the k slot of key r within its 8-key step: P's score fragment holds keys
// 2tig and 2tig + 1 of a step where an A fragment holds k = tig and
// tig + 4 (hopper.cuh), so V^T's rows hold the keys in that order
__device__ __forceinline__ int key_slot(int r) {
  return (r & ~7) + ((r & 1) << 2) + ((r & 7) >> 1);
}

// rows row0 .. row0 + kRows - 1 of one batch element's [n, D] slice into
// shared memory at row stride D + 4, by cp.async; rows past n read zeros
template <int D, int kRows>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int n) {
  constexpr int kChunks = D / 4;   // 16-byte chunks a row
#pragma unroll 4
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
    const bool live = row0 + r < n;
    bsr::cp_async16(dst + r * (D + 4) + col,
                    src + (size_t)(live ? row0 + r : 0) * D + col, live);
  }
}

// This thread's share of a key tile of K (row-major: consecutive threads
// on consecutive 16 bytes of a row) or of V (key-major: consecutive
// threads on consecutive keys of a 16-byte column, so that the transposed
// stores land on 32 banks); keys past n are zeros.
template <int D, bool kV>
__device__ __forceinline__ void load_share(float4 (&r)[Cfg<D>::kPerThread],
                                           const float* src, int key0,
                                           int n) {
#pragma unroll
  for (int i = 0; i < Cfg<D>::kPerThread; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int row = kV ? e % kKeys : e / (D / 4);
    const int col = kV ? (e / kKeys) * 4 : (e % (D / 4)) * 4;
    r[i] = key0 + row < n
        ? *reinterpret_cast<const float4*>(src + (size_t)(key0 + row) * D + col)
        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// the share split into TF32 big and small parts, into the swizzled K or
// V^T layout at `dst` (big) and dst + part (small); then a fence, since
// wgmma reads shared memory through the async proxy
template <int D, bool kV>
__device__ __forceinline__ void store_share(
    const float4 (&r)[Cfg<D>::kPerThread], unsigned char* dst) {
  constexpr int kPart = kV ? Cfg<D>::kVPart : Cfg<D>::kKPart;
#pragma unroll
  for (int i = 0; i < Cfg<D>::kPerThread; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const float x[4] = {r[i].x, r[i].y, r[i].z, r[i].w};
    uint32_t big[4], small[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) bsr::split_tf32(x[c], big[c], small[c]);
    if (kV) {
      const int slot = key_slot(e % kKeys) * 4;
      const int col = (e / kKeys) * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int off = swizzled(col + c, slot);
        *reinterpret_cast<uint32_t*>(dst + off) = big[c];
        *reinterpret_cast<uint32_t*>(dst + kPart + off) = small[c];
      }
    } else {
      const int row = e / (D / 4), col = (e % (D / 4)) * 4;
      const int off =
          (col / 32) * (kKeys * 128) + swizzled(row, (col % 32) * 4);
      *reinterpret_cast<uint4*>(dst + off) =
          make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(dst + kPart + off) =
          make_uint4(small[0], small[1], small[2], small[3]);
    }
  }
  bsr::fence_proxy_async();
}

// Split over keys (blockIdx.z of gridDim.z): a block walks its share of
// the key tiles; with more than one share it writes its unnormalised O,
// row max and row sum into `part` for fwd_combine_f32 (layout there).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, float* __restrict__ part, int n) {
  using C = Cfg<D>;
  constexpr int LD = C::kLdQ;
  constexpr int kSteps = C::kSplitK ? D / 16 : D / 8;   // S's 8-column
                                                         // steps a warpgroup
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kb = smem_raw +
      ((1024 - (bsr::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* vb = kb + 2 * C::kKPart;          // big, then small
  float* sq = reinterpret_cast<float*>(vb + 2 * C::kVPart);
  float* sx = sq + C::kRows * LD;                  // [2][128][kKeys / 2]

  const size_t base = (size_t)blockIdx.y * n * D;
  // through a shuffle, so that the compiler sees it uniform per warp and
  // keeps the descriptors' addresses in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int m0 = blockIdx.x * C::kRows;
  const int row0 = C::kSplitK ? 0 : wg * 64;       // the warpgroup's rows,
  const int col0 = C::kSplitK ? wg * kWidth : 0;   // output columns
  const int step0 = C::kSplitK ? wg * kSteps : 0;  // and S's steps
  const int all_tiles = (n + kKeys - 1) / kKeys;
  const int share = (all_tiles + gridDim.z - 1) / gridDim.z;
  const int t0 = blockIdx.z * share;
  const int tiles = min(all_tiles, t0 + share);   // this block's: t0..

  load_rows<D, C::kRows>(sq, q + base, m0, n);
  bsr::cp_async_commit();
  float4 next_k[C::kPerThread], next_v[C::kPerThread];
  load_share<D, false>(next_k, k + base, t0 * kKeys, n);
  load_share<D, true>(next_v, v + base, t0 * kKeys, n);
  store_share<D, false>(next_k, kb);
  store_share<D, true>(next_v, vb);
  bsr::cp_async_wait<0>();
  __syncthreads();

  // the warpgroup's panels of K (its half of D at D=256)
  const uint32_t k_big = bsr::smem_addr(kb) + (step0 / 4) * (kKeys * 128);
  const uint32_t k_small = k_big + C::kKPart;
  const uint32_t v_big = bsr::smem_addr(vb) + col0 * 128;
  const uint32_t v_small = v_big + C::kVPart;
  const float* qw = sq + (row0 + warp * 16 + grp) * LD + step0 * 8 + tig;

  float acc[kWidth / 2];
#pragma unroll
  for (int i = 0; i < kWidth / 2; ++i) acc[i] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};

  for (int t = t0; t < tiles; ++t) {
    const bool more = t + 1 < tiles;
    // S = Q K_t^T, 8 columns of D a step: each step's three passes into a
    // fresh accumulator, added into s by f32 adds (hopper.cuh:mma_3xtf32
    // says why); two steps in flight
    float s[kKeys / 2], ts[2][kKeys / 2];
    bsr::Tf32Frag<4> qa[2];
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int cur = i & 1;
      const float* qp = qw + i * 8;
      const float af[4] = {qp[0], qp[8 * LD], qp[4], qp[8 * LD + 4]};
      qa[cur] = bsr::split_frag(af);
      const uint32_t off = (i / 4) * (kKeys * 128) + (i % 4) * 32;
      const uint64_t db = bsr::desc_sw128(k_big + off, 16, 1024);
      const uint64_t ds = bsr::desc_sw128(k_small + off, 16, 1024);
      bsr::fence_regs(ts[cur]);
      bsr::fence_regs(qa[cur].big);
      bsr::fence_regs(qa[cur].small);
      bsr::wgmma_fence();
      bsr::wgmma_rs_m64n32k8_tf32(ts[cur], qa[cur].small, db, 0);
      bsr::wgmma_rs_m64n32k8_tf32(ts[cur], qa[cur].big, ds, 1);
      bsr::wgmma_rs_m64n32k8_tf32(ts[cur], qa[cur].big, db, 1);
      bsr::wgmma_commit();
      if (i > 0) {
        bsr::wgmma_wait<1>();
        bsr::fence_regs(ts[cur ^ 1]);
        bsr::fence_regs(qa[cur ^ 1].big);
        bsr::fence_regs(qa[cur ^ 1].small);
#pragma unroll
        for (int e = 0; e < kKeys / 2; ++e) s[e] += ts[cur ^ 1][e];
      }
    }
    bsr::wgmma_wait<0>();
    {
      constexpr int last = (kSteps - 1) & 1;
      bsr::fence_regs(ts[last]);
      bsr::fence_regs(qa[last].big);
      bsr::fence_regs(qa[last].small);
#pragma unroll
      for (int e = 0; e < kKeys / 2; ++e) s[e] += ts[last][e];
    }
    if constexpr (C::kSplitK) {
      // the other half of D's sum, from the other warpgroup: each thread
      // holds the same score positions in both
      float* mine = sx + (wg * 128 + threadIdx.x % 128) * (kKeys / 2);
      float* theirs = sx + ((wg ^ 1) * 128 + threadIdx.x % 128) * (kKeys / 2);
#pragma unroll
      for (int e = 0; e < kKeys / 2; e += 4) {
        *reinterpret_cast<float4*>(mine + e) =
            make_float4(s[e], s[e + 1], s[e + 2], s[e + 3]);
      }
      __syncthreads();               // both halves written; K_t read
#pragma unroll
      for (int e = 0; e < kKeys / 2; e += 4) {
        const float4 x = *reinterpret_cast<const float4*>(theirs + e);
        s[e] += x.x;                 // a + b == b + a: both sides agree
        s[e + 1] += x.y;
        s[e + 2] += x.z;
        s[e + 3] += x.w;
      }
      if (more) {   // K_t is read: K_t+1 in now, V_t+1 in flight
        load_share<D, false>(next_k, k + base, (t + 1) * kKeys, n);
        store_share<D, false>(next_k, kb);
        load_share<D, true>(next_v, v + base, (t + 1) * kKeys, n);
      }
    } else if (more) {
      // the next tile's loads, in flight through the softmax and P V
      load_share<D, false>(next_k, k + base, (t + 1) * kKeys, n);
      load_share<D, true>(next_v, v + base, (t + 1) * kKeys, n);
    }

    if ((t + 1) * kKeys > n) {       // ragged tail: keys past n score -inf
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (t * kKeys + j * 8 + 2 * tig + (e & 1) >= n) {
            s[4 * j + e] = -INFINITY;
          }
        }
      }
    }
    // online softmax: the row max over the 4 lanes that share a row; every
    // tile holds a live key, so it is finite and exp(-inf - max) = 0
    float mx[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float alpha[2] = {expf(row_max[0] - mx[0]),
                            expf(row_max[1] - mx[1])};
    row_max[0] = mx[0];
    row_max[1] = mx[1];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < kKeys / 2; ++e) {
      s[e] = expf(s[e] - mx[(e >> 1) & 1]);
      psum[(e >> 1) & 1] += s[e];
    }
    row_sum[0] = row_sum[0] * alpha[0] + psum[0];
    row_sum[1] = row_sum[1] * alpha[1] + psum[1];
#pragma unroll
    for (int j = 0; j < kWidth / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // O += P V_t: A = P as it lies in the score fragment, B = V_t^T's
    // rows col0.. (k = key, in key_slot order); the tile's twelve products
    // into a fresh accumulator, added into acc by f32 adds
    bsr::Tf32Frag<4> pa[kKeys / 8];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const float pf[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]};
      pa[j] = bsr::split_frag(pf);
      bsr::fence_regs(pa[j].big);
      bsr::fence_regs(pa[j].small);
    }
    // D=256 runs it on the two 64-column halves in turn, which keeps the
    // fresh accumulator at 32 registers beside the next tile's share
#pragma unroll
    for (int h = 0; h < C::kPvHalves; ++h) {
      constexpr int kN = kWidth / C::kPvHalves;
      float to[kN / 2];
      bsr::fence_regs(to);
      bsr::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const uint32_t off = h * kN * 128 + j * 32;
        const uint64_t db = bsr::desc_sw128(v_big + off, 16, 1024);
        const uint64_t ds = bsr::desc_sw128(v_small + off, 16, 1024);
        if constexpr (kN == 128) {
          bsr::wgmma_rs_m64n128k8_tf32(to, pa[j].small, db, j > 0);
          bsr::wgmma_rs_m64n128k8_tf32(to, pa[j].big, ds, 1);
          bsr::wgmma_rs_m64n128k8_tf32(to, pa[j].big, db, 1);
        } else {
          bsr::wgmma_rs_m64n64k8_tf32(to, pa[j].small, db, j > 0);
          bsr::wgmma_rs_m64n64k8_tf32(to, pa[j].big, ds, 1);
          bsr::wgmma_rs_m64n64k8_tf32(to, pa[j].big, db, 1);
        }
      }
      bsr::wgmma_commit();
      bsr::wgmma_wait<0>();
      bsr::fence_regs(to);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        bsr::fence_regs(pa[j].big);
        bsr::fence_regs(pa[j].small);
      }
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[h * kN / 2 + i] += to[i];
    }

    if (more) {
      __syncthreads();               // both warpgroups have read V_t (and
                                     // K_t at D=128)
      if (!C::kSplitK) store_share<D, false>(next_k, kb);
      store_share<D, true>(next_v, vb);
      __syncthreads();               // K_t+1 and V_t+1 are in
    }
  }

  // epilogue: row sums over the 4 lanes, the logsumexp, O / sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
  }
  const size_t rows = (size_t)gridDim.y * n;      // of the whole batch
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + row0 + warp * 16 + grp + 8 * h;
    if (row >= n) continue;
    const size_t r = (size_t)blockIdx.y * n + row;
    if (part != nullptr) {           // this share's O, max and sum
      float* dst = part + (blockIdx.z * rows + r) * D + col0 + 2 * tig;
#pragma unroll
      for (int j = 0; j < kWidth / 8; ++j) {
        *reinterpret_cast<float2*>(dst + j * 8) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
      if (tig == 0 && col0 == 0) {
        *reinterpret_cast<float2*>(
            part + gridDim.z * rows * D + 2 * (blockIdx.z * rows + r)) =
            make_float2(row_max[h], row_sum[h]);
      }
      continue;
    }
    if (lse != nullptr && tig == 0 && col0 == 0) {
      lse[r] = row_max[h] + logf(row_sum[h]);
    }
    float* dst = o + base + (size_t)row * D + col0 + 2 * tig;
#pragma unroll
    for (int j = 0; j < kWidth / 8; ++j) {
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(acc[4 * j + 2 * h] / row_sum[h],
                      acc[4 * j + 2 * h + 1] / row_sum[h]);
    }
  }
}

// O and lse from the shares of a split over keys, added in share order:
// part holds O [splits][B*N][D] unnormalised, then (max, sum) [splits][B*N]
template <int D>
__global__ void fwd_combine_f32(const float* __restrict__ part,
                                float* __restrict__ o,
                                float* __restrict__ lse, size_t rows,
                                int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * (D / 4)) return;
  const size_t r = i / (D / 4);
  const float2* ml = reinterpret_cast<const float2*>(part + splits * rows * D);
  float m = -INFINITY;
  for (int sp = 0; sp < splits; ++sp) m = fmaxf(m, ml[sp * rows + r].x);
  float sum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = 0; sp < splits; ++sp) {
    const float2 x = ml[sp * rows + r];
    const float w = expf(x.x - m);
    const float4 y =
        reinterpret_cast<const float4*>(part)[sp * rows * (D / 4) + i];
    sum = fmaf(x.y, w, sum);
    acc = make_float4(fmaf(y.x, w, acc.x), fmaf(y.y, w, acc.y),
                      fmaf(y.z, w, acc.z), fmaf(y.w, w, acc.w));
  }
  reinterpret_cast<float4*>(o)[i] =
      make_float4(acc.x / sum, acc.y / sum, acc.z / sum, acc.w / sum);
  if (lse != nullptr && i % (D / 4) == 0) lse[r] = m + logf(sum);
}

// Shares of a split over keys, 1-4 of at least 4 key tiles each: the count
// that finishes the grid soonest, in block times: the waves of the card's
// SMs that a grid of `s` shares a query tile takes, each wave 1 / s of a
// block, and 5% more a share beyond the first for the partial sums and
// the combine; the smaller count on a tie.  A grid that fills its last
// wave keeps one.
inline int key_splits(int batch, int n, int rows_per_block) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    sms = 132;
  }
  const long long blocks =
      (long long)((n + rows_per_block - 1) / rows_per_block) * batch;
  const int most = std::min(4, (n + kKeys - 1) / kKeys / 4);
  int best = 1;
  double best_cost = (double)((blocks + sms - 1) / sms);
  for (int sp = 2; sp <= most; ++sp) {
    const double cost = (double)((blocks * sp + sms - 1) / sms) / sp *
                        (1.0 + 0.05 * (sp - 1));
    if (cost < best_cost) {
      best = sp;
      best_cost = cost;
    }
  }
  return best;
}

inline long long workspace(int batch, int n, int d) {
  const int splits = key_splits(batch, n, d == 128 ? Cfg<128>::kRows
                                                   : Cfg<256>::kRows);
  return splits == 1 ? 0 : (long long)splits * batch * n * (d + 2);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, float* work, int batch, int n,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  static thread_local uint64_t attr_set = 0;
  cudaError_t err = bsr::smem_limit_once(attr_set, attn_fwd_f32<D>, C::kSmem);
  if (err != cudaSuccess) return err;
  const int splits = key_splits(batch, n, C::kRows);
  const dim3 grid((n + C::kRows - 1) / C::kRows, batch, splits);
  attn_fwd_f32<D><<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse,
      splits == 1 ? nullptr : work, n);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  const size_t rows = (size_t)batch * n;
  fwd_combine_f32<D><<<(unsigned)((rows * (D / 4) + 255) / 256), 256, 0,
                       stream>>>(work, static_cast<float*>(o), lse, rows,
                                 splits);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

extern "C" {

// Floats of the f32 `workspace` that bsr_nonlocal_attn_fwd takes: at f32,
// the shares of a split over keys when the grid is small (fwd_combine_f32),
// else none; at bf16 none.
long long bsr_nonlocal_attn_fwd_workspace(int batch, int n, int d,
                                          int dtype) {
  if (dtype != 0 || batch < 1 || n < 1 || (d != 128 && d != 256)) return 0;
  return f32::workspace(batch, n, d);
}

// dtype: 0 = float32, 1 = bfloat16.  `lse` ([B, N] f32) may be null;
// `workspace` holds bsr_nonlocal_attn_fwd_workspace floats (null when
// that is 0).  Returns a cudaError_t value.
int bsr_nonlocal_attn_fwd(const void* theta, const void* phi, const void* g,
                          void* out, void* lse, void* workspace, int batch,
                          int n, int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* w = static_cast<float*>(workspace);
  if (batch < 1 || batch > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && d == 128) return (int)launch_bf16<128>(theta, phi, g, out, l, batch, n, s);
  if (dtype == 1 && d == 256) return (int)launch_bf16<256>(theta, phi, g, out, l, batch, n, s);
  if (dtype == 0 && d == 128) return (int)f32::launch<128>(theta, phi, g, out, l, w, batch, n, s);
  if (dtype == 0 && d == 256) return (int)f32::launch<256>(theta, phi, g, out, l, w, batch, n, s);
  return (int)cudaErrorInvalidValue;
}

const char* bsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
