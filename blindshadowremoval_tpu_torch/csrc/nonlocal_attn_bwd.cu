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
// bf16) the gradients need five N x N x D products per batch element (S,
// dP, dV, dK, dQ), 10*B*N^2*D = 85.9 GFLOP: ~87 us at 989 TFLOP/s dense
// bf16.  It reads theta, phi, g, O and dO and writes three gradients,
// 8*B*N*D*2 B = 134 MB, ~40 us at 3.35 TB/s: it is bounded by the tensor
// cores, and only wgmma fed without stalls reaches their rate.
//
// What the design does about it (FlashAttention-3's backward, fitted to
// this op), bf16:
//  * The TPU kernel holds the N x N weights of one batch element in VMEM;
//    a Hopper block gets at most 227 KB of shared memory.  So the forward
//    kernel saves each row's logsumexp and this kernel recomputes
//    P = exp(S - lse) tile by tile: no N x N tensor reaches device memory.
//  * One pass, five products (a dK/dV pass and a dQ pass would compute S
//    and dP twice: seven).  A block owns a tile of keys of one batch
//    element and walks the query tiles, 64 queries a step, accumulating dK
//    and dV in registers.  Each step: S^T = K Q^T and dP^T = V dO^T by wgmma with
//    both operands in shared memory (K-major); P^T and
//    dS^T = P^T o (dP^T - Delta) in registers; dV += P^T dO and
//    dK += dS^T Q by wgmma (dO and Q MN-major, transposed by the
//    descriptor); dS^T to shared memory, and dQ = dS K by wgmma with both
//    operands MN-major.  dQ's partial sums from the key tiles are added
//    into an f32 [B, N, D] workspace.
//  * D = 128: 128 keys a block, 64 for each of two consumer warpgroups,
//    P^T and dS^T go from registers into the dV and dK products; each
//    consumer takes 64 of dQ's 128 columns over the block's 128 keys and
//    stages them in shared memory, and one thread adds them into the
//    workspace with a TMA reduce (cp.reduce.async.bulk.tensor add), which
//    measured faster than per-thread vector atomics.  The consumers issue
//    their wgmma groups in turns (FlashAttention-3's ping-pong): S^T and
//    dP^T of tile t, then dV and dK of tile t with dQ of tile t-1, so the
//    tensor cores run one consumer's products while the other computes
//    its P^T and dS^T; dS^T keeps three buffers, since a consumer may
//    write a tile's while the other's dQ still reads the one before.
//    dQ is issued at every step, which keeps ptxas from serialising the
//    wgmma for want of registers (at the first step on a zeroed buffer,
//    whose zeros are not added into the workspace).
//  * D = 256: dK and dV of 64 keys x 256 columns in f32 do not fit one
//    warpgroup's registers, so a block owns 64 keys and the two consumers
//    split the columns: consumer c computes S^T and dP^T for queries
//    32c..32c+31 of the tile, both write their P^T and dS^T to shared
//    memory, and consumer c accumulates dK, dV and dQ for columns
//    128c..128c+127 from there.  Shared memory has no room left for a
//    dQ buffer, but after the step's products only consumer c reads its
//    column panels of the Q and dO tiles: its dQ is staged there and added
//    by TMA reduce, and the stage goes back to the producer a step later.
//  * Warp specialisation, 3 warpgroups.  Warpgroup 0 is the producer: one
//    thread issues TMA loads of the block's K and V once, then streams the
//    Q and dO tiles (3-D tensor maps, 128-byte swizzle) and the tile's lse
//    and Delta (bulk copies) into a 2-stage ring with full and empty
//    mbarriers; setmaxnreg gives its registers to the consumers (24 / 240).
//  * A first small kernel computes Delta = rowsum(dO o O) from the bf16
//    forward output, copies lse padded to whole query tiles (+inf past N,
//    so the missing queries get P = 0), and zeroes dQ's workspace; a last
//    one rounds dQ to bf16.  Keys past N score -inf (P = 0), and dK and dV
//    go out through shared memory with 3-D TMA stores, which clip at row N.
//  * Determinism (bf16): dQ's partial sums from the key tiles arrive in no
//    fixed order, so dtheta can differ from run to run within the f32
//    rounding of its sums, before its bf16 rounding; dphi and dg are the
//    same from run to run.
//  * f32 (the parity train steps: the card against the CPU, rank against
//    rank).  Bound: the 10*B*N^2*D FLOP to f32 accuracy; the kernels this
//    replaces ran them on the CUDA cores in two passes of three launches
//    (Delta, dK/dV, dQ: seven products), which decided the time at the
//    launched N = 64.  Here the five products run on the tensor cores as
//    3xTF32 on mma.sync (hopper.cuh: each 8-step's three passes in a fresh
//    accumulator, added by f32 adds), in one pass: a block of 8 warps owns
//    64 keys and walks the queries 32 at a time, Delta = rowsum(dO o O) of
//    each step computed in the block (8 lanes a query, a fixed order), so
//    no pre-pass; dK and dV stay in registers; P^T, dS^T and dS go through
//    shared memory (rows padded so that the fragment reads fall on 32
//    banks), where every operand can be read in the layout its product
//    wants (wgmma's tf32 form takes none MN-major, and dO, Q and K are so
//    for dV, dK and dQ).  dQ: with one key block (N <= 64) each step's dQ is
//    dtheta; else each block writes its partial dQ to its own slot of the
//    workspace and a second launch adds the slots in block order.  One or
//    two launches, no atomics: the same inputs give the same bits.
//  No trap anywhere in the file: a trap makes ptxas ignore setmaxnreg.
//
// Numerics: the TPU kernel keeps W, dW and dS in f32.  Here P and dS are
// rounded to bf16 as operands of the second products, and Delta comes from
// the bf16 forward output; ops/nonlocal_attn.py:KERNEL_BWD_TOLERANCE says
// how far that moves the gradients.
//
// C interface (loaded with ctypes): bsr_nonlocal_attn_bwd returns a
// cudaError_t value, 0 on success; the launches run on `stream`.  Its
// `workspace` holds bsr_nonlocal_attn_bwd_workspace floats.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------ bf16: the kernel
namespace hop {

constexpr int kQ = 64;                  // queries per step
constexpr int kStages = 2;              // depth of the Q/dO ring
constexpr int kThreads = 384;           // producer + 2 consumer warpgroups
constexpr int kProducerRegs = 24;       // setmaxnreg: 128 * 24 + 256 * 240
constexpr int kConsumerRegs = 240;      // <= 65536
constexpr int kQPanel = kQ * 128;       // bytes of a 64-column panel of a
                                        // Q or dO tile (or 32 f32 columns)
// named barriers: kTurn + cw for consumer cw's turn to issue wgmma (D =
// 128); both consumers' shared tiles of the step written (D = 256); both
// consumers done with K and V (before the epilogue overwrites them);
// kStore + cw inside consumer cw
constexpr uint32_t kTurn = 1, kReady = 3, kDone = 4, kStore = 5;
constexpr float kLog2e = 1.4426950408889634f;
// D = 128: dS^T of a tile is read by both consumers' dQ products during
// the next tile's turns, so a consumer may write a tile's dS^T while the
// other still reads the one before: three buffers
constexpr int kDSBuffers = 3;

struct Barriers {
  uint64_t kv_full;
  uint64_t full[kStages];    // Q, dO, lse and Delta of one query tile
  uint64_t empty[kStages];   // two arrivals: one per consumer
};

// Tiles by head width.  Shared memory: K, V | Q ring | dO ring | the
// per-width tiles | lse, Delta ring | barriers, and slack to align the
// tiles to 1024 bytes.
template <int D>
struct Cfg {
  static constexpr int kPanels = D / 64;
  static constexpr int kKeys = D == 128 ? 128 : 64;   // keys per block
  static constexpr int kKVPanel = kKeys * 128;
  static constexpr int kKVBytes = kPanels * kKVPanel;
  static constexpr int kQBytes = kPanels * kQPanel;
  // a bf16 P^T or dS^T tile: kKeys x 64 queries
  static constexpr int kTile = kKeys * 128;
  // D = 128: dS^T, kDSBuffers buffers; dQ of both consumers (64 queries x
  // 64 f32 columns each, two panels).  D = 256: P^T and dS^T, two buffers
  // each.
  static constexpr int kExtra =
      D == 128 ? kDSBuffers * kTile + 2 * 2 * kQPanel : 2 * 2 * kTile;
  static constexpr int kSmem = 2 * kKVBytes + 2 * kStages * kQBytes +
                               kExtra + 2 * kStages * kQ * (int)sizeof(float) +
                               (int)sizeof(Barriers) + 1024;
  static_assert(kSmem <= 232448, "more shared memory than a block may have");
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S^T (or dP^T) [64 keys x N queries] = 64 rows of K (V) . N rows of Q (dO)
// ^T over D, both K-major; issued, not waited for
template <int D, int N>
__device__ __forceinline__ void issue_scores(float (&s)[N / 2], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // a 16-column step: 32 bytes along the swizzled row, panel by panel
    const uint64_t da = bsr::desc_sw128(
        a + (kk / 4) * Cfg<D>::kKVPanel + (kk % 4) * 32, 16, 1024);
    const uint64_t db = bsr::desc_sw128(
        b + (kk / 4) * kQPanel + (kk % 4) * 32, 16, 1024);
    if constexpr (N == 64) {
      bsr::wgmma_ss_m64n64k16(s, da, db, kk > 0);
    } else {
      bsr::wgmma_ss_m64n32k16(s, da, db, kk > 0);
    }
  }
}

// acc[64 keys x 128] += A[64 keys x 64 queries] . B[64 queries x 128], B
// MN-major (128 columns of dO or Q as loaded), A from registers (D = 128)
// or K-major from shared memory (D = 256); issued, not waited for
__device__ __forceinline__ void issue_grad(float (&acc)[64],
                                           uint32_t (&a)[kQ / 16][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
    // 16 queries = 16 rows of 128 bytes in both panels
    const uint64_t db = bsr::desc_sw128(b + kk * 2048, kQPanel, 1024);
    bsr::wgmma_rs_m64n128k16_tb(acc, a[kk], db, 1);
  }
}

__device__ __forceinline__ void issue_grad(float (&acc)[64], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
    const uint64_t da = bsr::desc_sw128(a + kk * 32, 16, 1024);
    const uint64_t db = bsr::desc_sw128(b + kk * 2048, kQPanel, 1024);
    bsr::wgmma_ss_m64n128k16<0, 1>(acc, da, db, 1);
  }
}

// dQ[64 queries x D/2 columns] = dS[64 queries x kKeys] . K[kKeys x D/2]:
// A is dS^T as stored (one row of 64 queries per key), B D/128 panels of K
// from `k`; both MN-major.  Issued, not waited for
template <int D>
__device__ __forceinline__ void issue_dq(float (&dq)[D / 4], uint32_t ds,
                                         uint32_t k) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::kKeys / 16; ++kk) {
    const uint64_t da = bsr::desc_sw128(ds + kk * 2048, C::kTile, 1024);
    const uint64_t db = bsr::desc_sw128(k + kk * 2048, C::kKVPanel, 1024);
    if constexpr (D == 128) {
      bsr::wgmma_ss_m64n64k16<1, 1>(dq, da, db, kk > 0);
    } else {
      bsr::wgmma_ss_m64n128k16<1, 1>(dq, da, db, kk > 0);
    }
  }
}

// P^T = exp(S^T - lse) (0 for a key past n) and dS^T = P^T o (dP^T - Delta)
// over one 8-query block of the score accumulators (s and dp point at its
// 4 values: rows r0 and r0 + 8, queries 2tig and 2tig + 1, whose lse and
// Delta are lq and dq), as bf16 pairs {P row r0, P row r0 + 8, dS row r0,
// dS row r0 + 8}
__device__ __forceinline__ uint4 p_and_ds(const float* s, const float* dp,
                                          float2 lq, float2 dq, bool live0,
                                          bool live1) {
  const float m0 = lq.x * kLog2e, m1 = lq.y * kLog2e;
  const float p0 = live0 ? fast_exp2(fmaf(s[0], kLog2e, -m0)) : 0.f;
  const float p1 = live0 ? fast_exp2(fmaf(s[1], kLog2e, -m1)) : 0.f;
  const float p2 = live1 ? fast_exp2(fmaf(s[2], kLog2e, -m0)) : 0.f;
  const float p3 = live1 ? fast_exp2(fmaf(s[3], kLog2e, -m1)) : 0.f;
  return make_uint4(pack_f32(p0, p1), pack_f32(p2, p3),
                    pack_f32(p0 * (dp[0] - dq.x), p1 * (dp[1] - dq.y)),
                    pack_f32(p2 * (dp[2] - dq.x), p3 * (dp[3] - dq.y)));
}

// the 64 x kCols accumulators dK and dV, this thread's rows as bf16 into
// K's and V's tiles, from panel p0 on, rows row0 and row0 + 8, in the
// swizzled layout the store maps read
template <int kCols>
__device__ __forceinline__ void stage_rows(unsigned char* sk,
                                           unsigned char* sv,
                                           const float (&dk)[kCols / 2],
                                           const float (&dv)[kCols / 2],
                                           int kv_panel, int p0, int row0,
                                           int grp, int tig) {
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // (row0 & 7) == grp: chunk c of both rows sits at chunk c ^ grp
      const int off = (p0 + j / 8) * kv_panel + (row0 + 8 * h) * 128 +
                      (((j % 8) ^ grp) * 16) + tig * 4;
      *reinterpret_cast<uint32_t*>(sk + off) =
          pack_f32(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(sv + off) =
          pack_f32(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

// The pointers of one block's shared memory.
struct Smem {
  unsigned char* k;       // [panel][kKeys][128 B]
  unsigned char* v;
  unsigned char* q;       // [stage][panel][64][128 B]
  unsigned char* dout;
  unsigned char* extra;   // Cfg::kExtra
  float* lse;             // [stage][64]
  float* delta;
  Barriers* bars;
};

// D = 128, consumer cw = 0, 1: dK and dV of its 64 of the block's 128 keys
// over every query tile, and 64 columns of dQ's partial sums over the
// block's keys, added into the workspace by TMA.
__device__ __forceinline__ void consume128(const Smem& sm,
                                           const CUtensorMap* dk_map,
                                           const CUtensorMap* dv_map,
                                           const CUtensorMap* dq_map, int n,
                                           int j0, int cw) {
  using C = Cfg<128>;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int tiles = (n + kQ - 1) / kQ;
  // rows r0 and r0 + 8 of this consumer's 64 keys (and of a dQ tile's 64
  // queries); row0 and row0 + 8 of the block's 128 keys
  const int r0 = warp * 16 + grp;
  const int row0 = cw * 64 + r0;
  const bool live0 = j0 + row0 < n;
  const bool live1 = j0 + row0 + 8 < n;
  const uint32_t k_rows = bsr::smem_addr(sm.k) + cw * 64 * 128;
  const uint32_t v_rows = bsr::smem_addr(sm.v) + cw * 64 * 128;
  const uint32_t k_cols = bsr::smem_addr(sm.k) + cw * C::kKVPanel;
  unsigned char* sds = sm.extra;                 // [buffer][128 keys][128 B]
  // this consumer's dQ buffer: [panel][64 queries][128 B]
  unsigned char* dq_tile = sds + kDSBuffers * C::kTile + cw * 2 * kQPanel;

  // this consumer's 64 columns of dQ of query tile `tile` into its
  // buffer, in the swizzled layout of the f32 map, then one thread adds
  // them into the f32 workspace (rows past n are clipped)
  auto stage_dq = [&](const float (&dq)[32], int tile) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // columns 8j + 2tig, +1: panel j / 4, 16-byte chunk 2 (j % 4) + tig / 2
      const int chunk = 2 * (j % 4) + tig / 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(dq_tile + (j / 4) * kQPanel +
                                   (r0 + 8 * h) * 128 +
                                   ((chunk ^ grp) * 16) + (tig & 1) * 8) =
            make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
      }
    }
    bsr::fence_proxy_async();
    bsr::named_barrier(kStore + cw, 128);
    if (tid == 0) {
#pragma unroll
      for (int pn = 0; pn < 2; ++pn) {
        bsr::tma_reduce_add_3d(dq_map, dq_tile + pn * kQPanel,
                               cw * 64 + pn * 32, tile * kQ, blockIdx.y);
      }
      bsr::bulk_commit();
    }
  };

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  // this consumer's rows of the last dS^T buffer zeroed, for the first
  // step's dQ product
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    unsigned char* row = sds + (kDSBuffers - 1) * C::kTile + row0 * 128;
    *reinterpret_cast<uint32_t*>(row + c * 16 + tig * 4) = 0u;
    *reinterpret_cast<uint32_t*>(row + 8 * 128 + c * 16 + tig * 4) = 0u;
  }
  bsr::fence_proxy_async();
  bsr::mbar_wait(&sm.bars->kv_full, 0);
  // The two consumers issue their wgmma groups in turns (named barriers,
  // consumer 0 first), so that the tensor cores run one consumer's
  // products while the other computes P^T and dS^T.  Step t issues group A
  // (S^T and dP^T of tile t) and group B (dV and dK of tile t, and dQ of
  // tile t-1, whose dS^T both consumers wrote before their previous
  // turn); a last group C adds dQ of the last tile.
  if (cw == 1) bsr::named_barrier_arrive(kTurn, 256);
  for (int t = 0; t < tiles; ++t) {
    const int st = t % kStages;
    const uint32_t q = bsr::smem_addr(sm.q) + st * C::kQBytes;
    const uint32_t o = bsr::smem_addr(sm.dout) + st * C::kQBytes;
    unsigned char* ds_tile = sds + (t % kDSBuffers) * C::kTile;
    // per step, so that only dK and dV stay live across steps; the first
    // product of each sum overwrites its accumulator
    float s[32], dp[32], dq[32];
    uint32_t pa[kQ / 16][4], dsa[kQ / 16][4];
    bsr::mbar_wait(&sm.bars->full[st], (t / kStages) & 1);
    bsr::named_barrier(kTurn + cw, 256);
    bsr::wgmma_fence();
    issue_scores<128, 64>(s, k_rows, q);
    issue_scores<128, 64>(dp, v_rows, o);
    bsr::wgmma_commit();
    bsr::named_barrier_arrive(kTurn + (cw ^ 1), 256);
    bsr::wgmma_wait_all();
    bsr::fence_regs(s);
    bsr::fence_regs(dp);

    // P^T and dS^T as bf16 A fragments (score blocks 2kk and 2kk+1 hold
    // queries 16kk..16kk+15 in the A layout), and dS^T into shared memory
    const float* l = sm.lse + st * kQ;
    const float* dl = sm.delta + st * kQ;
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j) {
      const int qc = j * 8 + tig * 2;
      const uint4 r = p_and_ds(s + 4 * j, dp + 4 * j,
                               *reinterpret_cast<const float2*>(l + qc),
                               *reinterpret_cast<const float2*>(dl + qc),
                               live0, live1);
      pa[j / 2][(j % 2) * 2 + 0] = r.x;
      pa[j / 2][(j % 2) * 2 + 1] = r.y;
      dsa[j / 2][(j % 2) * 2 + 0] = r.z;
      dsa[j / 2][(j % 2) * 2 + 1] = r.w;
      // (row0 & 7) == grp: chunk j of both rows sits at chunk j ^ grp
      unsigned char* dst = ds_tile + row0 * 128 + ((j ^ grp) * 16) + tig * 4;
      *reinterpret_cast<uint32_t*>(dst) = r.z;
      *reinterpret_cast<uint32_t*>(dst + 8 * 128) = r.w;
    }
    bsr::fence_proxy_async();   // the dS^T stores, before wgmma reads them
    // the last reduction has read the dQ buffer (the turn below holds the
    // other threads until it has)
    if (tid == 0) bsr::bulk_wait_read<0>();

    // group B: dV += P^T dO, dK += dS^T Q, and dQ of the previous tile
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      bsr::fence_regs(pa[kk]);
      bsr::fence_regs(dsa[kk]);
    }
    bsr::fence_regs(dk);
    bsr::fence_regs(dv);
    bsr::named_barrier(kTurn + cw, 256);
    bsr::wgmma_fence();
    issue_grad(dv, pa, o);
    issue_grad(dk, dsa, q);
    // at t = 0 on the zeroed last buffer, and its zeros are not staged:
    // the product is issued at every step, which keeps ptxas from
    // serialising
    const int prev = (t + kDSBuffers - 1) % kDSBuffers;
    issue_dq<128>(dq, bsr::smem_addr(sds + prev * C::kTile), k_cols);
    bsr::wgmma_commit();
    bsr::named_barrier_arrive(kTurn + (cw ^ 1), 256);
    bsr::wgmma_wait_all();
    bsr::fence_regs(dk);
    bsr::fence_regs(dv);
    bsr::fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      bsr::fence_regs(pa[kk]);
      bsr::fence_regs(dsa[kk]);
    }
    if (tid == 0) bsr::mbar_arrive(&sm.bars->empty[st]);   // Q, dO read
    if (t > 0) stage_dq(dq, t - 1);
  }
  {
    // group C: dQ of the last tile; consumer 1 passes the turn to no one,
    // so that every arrival meets a wait
    float dq[32];
    if (tid == 0) bsr::bulk_wait_read<0>();
    bsr::named_barrier(kTurn + cw, 256);
    bsr::wgmma_fence();
    const int prev = (tiles - 1) % kDSBuffers;
    issue_dq<128>(dq, bsr::smem_addr(sds + prev * C::kTile), k_cols);
    bsr::wgmma_commit();
    if (cw == 0) bsr::named_barrier_arrive(kTurn + 1, 256);
    bsr::wgmma_wait_all();
    bsr::fence_regs(dq);
    stage_dq(dq, tiles - 1);
  }

  // epilogue: K is shared, so wait until the other consumer's dQ products
  // are done with it, then dK and dV into this consumer's rows of the K and
  // V tiles, and one thread stores them
  bsr::named_barrier(kDone, 256);
  stage_rows<128>(sm.k, sm.v, dk, dv, C::kKVPanel, 0, row0, grp, tig);
  bsr::fence_proxy_async();
  bsr::named_barrier(kStore + cw, 128);
  if (tid == 0) {
#pragma unroll
    for (int pn = 0; pn < C::kPanels; ++pn) {
      const int off = pn * C::kKVPanel + cw * 64 * 128;
      bsr::tma_store_3d(dk_map, sm.k + off, pn * 64, j0 + cw * 64, blockIdx.y);
      bsr::tma_store_3d(dv_map, sm.v + off, pn * 64, j0 + cw * 64, blockIdx.y);
    }
    bsr::bulk_commit();
    bsr::bulk_wait_read<0>();
  }
}

// D = 256, consumer cw = 0, 1: S^T and dP^T of the block's 64 keys for
// queries 32cw..32cw+31 of each tile; then, from both consumers' P^T and
// dS^T in shared memory, dK, dV and dQ's partial sums of columns
// 128cw..128cw+127.  After the step's products only this consumer reads
// its panels 2cw, 2cw+1 of the Q and dO tiles, so its dQ is staged there
// and added into the workspace by TMA; the stage goes back to the producer
// once that has been read, a step later.
__device__ __forceinline__ void consume256(const Smem& sm,
                                           const CUtensorMap* dk_map,
                                           const CUtensorMap* dv_map,
                                           const CUtensorMap* dq_map, int n,
                                           int j0, int cw) {
  using C = Cfg<256>;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int tiles = (n + kQ - 1) / kQ;
  // rows r0 and r0 + 8 of the block's 64 keys (and of a dQ tile's queries)
  const int r0 = warp * 16 + grp;
  const bool live0 = j0 + r0 < n;
  const bool live1 = j0 + r0 + 8 < n;
  const uint32_t k0 = bsr::smem_addr(sm.k);
  const uint32_t v0 = bsr::smem_addr(sm.v);
  unsigned char* sp = sm.extra;               // [buffer][64 keys][128 B]
  unsigned char* sds = sp + 2 * C::kTile;

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  bsr::mbar_wait(&sm.bars->kv_full, 0);
  for (int t = 0; t < tiles; ++t) {
    const int st = t % kStages;
    const uint32_t q = bsr::smem_addr(sm.q) + st * C::kQBytes;
    const uint32_t o = bsr::smem_addr(sm.dout) + st * C::kQBytes;
    unsigned char* p_tile = sp + (t % 2) * C::kTile;
    unsigned char* ds_tile = sds + (t % 2) * C::kTile;
    bsr::mbar_wait(&sm.bars->full[st], (t / kStages) & 1);
    float s[16], dp[16], dq[64];
    bsr::wgmma_fence();
    issue_scores<256, 32>(s, k0, q + cw * 32 * 128);
    issue_scores<256, 32>(dp, v0, o + cw * 32 * 128);
    bsr::wgmma_commit();
    if (tid == 0 && t > 0) {   // last step's dQ is read: hand its stage back
      bsr::bulk_wait_read<0>();
      bsr::mbar_arrive(&sm.bars->empty[(t - 1) % kStages]);
    }
    bsr::wgmma_wait_all();
    bsr::fence_regs(s);
    bsr::fence_regs(dp);

    // this consumer's 32 queries of P^T and dS^T into shared memory:
    // 16-byte chunks 4cw..4cw+3 of rows r0 and r0 + 8
    const float* l = sm.lse + st * kQ + cw * 32;
    const float* dl = sm.delta + st * kQ + cw * 32;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qc = j * 8 + tig * 2;
      const uint4 r = p_and_ds(s + 4 * j, dp + 4 * j,
                               *reinterpret_cast<const float2*>(l + qc),
                               *reinterpret_cast<const float2*>(dl + qc),
                               live0, live1);
      const int off = r0 * 128 + (((4 * cw + j) ^ grp) * 16) + tig * 4;
      *reinterpret_cast<uint32_t*>(p_tile + off) = r.x;
      *reinterpret_cast<uint32_t*>(p_tile + off + 8 * 128) = r.y;
      *reinterpret_cast<uint32_t*>(ds_tile + off) = r.z;
      *reinterpret_cast<uint32_t*>(ds_tile + off + 8 * 128) = r.w;
    }
    bsr::fence_proxy_async();
    bsr::named_barrier(kReady, 256);

    // dV += P^T dO, dK += dS^T Q, dQ = dS K on this consumer's columns
    bsr::fence_regs(dk);
    bsr::fence_regs(dv);
    bsr::wgmma_fence();
    issue_grad(dv, bsr::smem_addr(p_tile), o + 2 * cw * kQPanel);
    issue_grad(dk, bsr::smem_addr(ds_tile), q + 2 * cw * kQPanel);
    issue_dq<256>(dq, bsr::smem_addr(ds_tile), k0 + 2 * cw * C::kKVPanel);
    bsr::wgmma_commit();
    bsr::wgmma_wait_all();
    bsr::fence_regs(dk);
    bsr::fence_regs(dv);
    bsr::fence_regs(dq);

    // dQ's 128 columns as four panels of 32 f32 columns, in the swizzled
    // layout of the f32 map: Q's panels 2cw, 2cw+1, then dO's
    unsigned char* panels[4] = {
        sm.q + st * C::kQBytes + 2 * cw * kQPanel,
        sm.q + st * C::kQBytes + (2 * cw + 1) * kQPanel,
        sm.dout + st * C::kQBytes + 2 * cw * kQPanel,
        sm.dout + st * C::kQBytes + (2 * cw + 1) * kQPanel};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int chunk = 2 * (j % 4) + tig / 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(panels[j / 4] + (r0 + 8 * h) * 128 +
                                   ((chunk ^ grp) * 16) + (tig & 1) * 8) =
            make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
      }
    }
    bsr::fence_proxy_async();
    bsr::named_barrier(kStore + cw, 128);
    if (tid == 0) {
#pragma unroll
      for (int pn = 0; pn < 4; ++pn) {
        bsr::tma_reduce_add_3d(dq_map, panels[pn], cw * 128 + pn * 32, t * kQ,
                               blockIdx.y);
      }
      bsr::bulk_commit();
    }
  }

  // epilogue: V is read by both consumers' dP^T, so wait until both are
  // done, then this consumer's columns of dK and dV into its panels of the
  // K and V tiles, and one thread stores them
  bsr::named_barrier(kDone, 256);
  stage_rows<128>(sm.k, sm.v, dk, dv, C::kKVPanel, 2 * cw, r0, grp, tig);
  bsr::fence_proxy_async();
  bsr::named_barrier(kStore + cw, 128);
  if (tid == 0) {
#pragma unroll
    for (int pn = 2 * cw; pn < 2 * cw + 2; ++pn) {
      bsr::tma_store_3d(dk_map, sm.k + pn * C::kKVPanel, pn * 64, j0,
                        blockIdx.y);
      bsr::tma_store_3d(dv_map, sm.v + pn * C::kKVPanel, pn * 64, j0,
                        blockIdx.y);
    }
    bsr::bulk_commit();
    bsr::bulk_wait_read<0>();
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_hopper_bf16(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap dk_map,
                const __grid_constant__ CUtensorMap dv_map,
                const __grid_constant__ CUtensorMap dq_map,
                const float* __restrict__ lse_pad,
                const float* __restrict__ delta_pad, int n) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* base =
      smem_raw + ((1024 - (bsr::smem_addr(smem_raw) & 1023)) & 1023);
  Smem sm;
  sm.k = base;
  sm.v = sm.k + C::kKVBytes;
  sm.q = sm.v + C::kKVBytes;
  sm.dout = sm.q + kStages * C::kQBytes;
  sm.extra = sm.dout + kStages * C::kQBytes;
  sm.lse = reinterpret_cast<float*>(sm.extra + C::kExtra);
  sm.delta = sm.lse + kStages * kQ;
  sm.bars = reinterpret_cast<Barriers*>(sm.delta + kStages * kQ);
  Barriers* bars = sm.bars;

  if (threadIdx.x == 0) {
    bsr::mbar_init(&bars->kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bsr::mbar_init(&bars->full[s], 1);
      bsr::mbar_init(&bars->empty[s], 2);
    }
    bsr::mbar_fence_init();
  }
  __syncthreads();

  const int j0 = blockIdx.x * C::kKeys;
  const int b = blockIdx.y;
  // the warpgroup index through a shuffle, so that ptxas sees a branch
  // uniform per warp (setmaxnreg is .sync.aligned)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer warpgroup: one thread keeps the ring full
    bsr::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int tiles = (n + kQ - 1) / kQ;
      bsr::mbar_expect_tx(&bars->kv_full, 2 * C::kKVBytes);
      for (int pn = 0; pn < C::kPanels; ++pn) {
        bsr::tma_load_3d(sm.k + pn * C::kKVPanel, &k_map, &bars->kv_full,
                         pn * 64, j0, b);
        bsr::tma_load_3d(sm.v + pn * C::kKVPanel, &v_map, &bars->kv_full,
                         pn * 64, j0, b);
      }
      for (int t = 0; t < tiles; ++t) {
        const int st = t % kStages;
        // the first pass over the ring finds every stage empty
        bsr::mbar_wait(&bars->empty[st], ((t / kStages) & 1) ^ 1);
        bsr::mbar_expect_tx(&bars->full[st],
                            2 * C::kQBytes + 2 * kQ * (int)sizeof(float));
        for (int pn = 0; pn < C::kPanels; ++pn) {
          bsr::tma_load_3d(sm.q + st * C::kQBytes + pn * kQPanel, &q_map,
                           &bars->full[st], pn * 64, t * kQ, b);
          bsr::tma_load_3d(sm.dout + st * C::kQBytes + pn * kQPanel, &do_map,
                           &bars->full[st], pn * 64, t * kQ, b);
        }
        const size_t r = ((size_t)b * tiles + t) * kQ;   // padded rows
        bsr::bulk_load(sm.lse + st * kQ, lse_pad + r, kQ * sizeof(float),
                       &bars->full[st]);
        bsr::bulk_load(sm.delta + st * kQ, delta_pad + r, kQ * sizeof(float),
                       &bars->full[st]);
      }
    }
  } else {
    bsr::setmaxnreg_inc<kConsumerRegs>();
    if constexpr (D == 128) {
      consume128(sm, &dk_map, &dv_map, &dq_map, n, j0, wg - 1);
    } else {
      consume256(sm, &dk_map, &dv_map, &dq_map, n, j0, wg - 1);
    }
  }
}

constexpr int kPrepThreads = 256;   // one warp per row

// Delta = rowsum(dO o O) and a copy of lse, both padded to whole query
// tiles (Delta 0 and lse +inf past n), and dQ's f32 workspace zeroed
template <int D>
__global__ void __launch_bounds__(kPrepThreads)
bwd_prep_bf16(const bf16* __restrict__ dout, const bf16* __restrict__ out,
              const float* __restrict__ lse, float* __restrict__ lse_pad,
              float* __restrict__ delta_pad, float* __restrict__ dq_acc,
              int n, int npad, int rows) {
  constexpr int kPer = D / 32;   // columns a lane
  const int row = blockIdx.x * (kPrepThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int b = row / npad;
  const int i = row % npad;
  if (i >= n) {
    if (lane == 0) {
      lse_pad[row] = INFINITY;
      delta_pad[row] = 0.f;
    }
    return;
  }
  const size_t src = ((size_t)b * n + i) * D + lane * kPer;
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; e += 2) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dout + src + e));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(out + src + e));
    acc = fmaf(a.x, c.x, acc);
    acc = fmaf(a.y, c.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
#pragma unroll
  for (int e = 0; e < kPer; e += 4) {
    *reinterpret_cast<float4*>(dq_acc + src + e) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (lane == 0) {
    delta_pad[row] = acc;
    lse_pad[row] = lse[(size_t)b * n + i];
  }
}

// dtheta = dQ's f32 workspace rounded to bf16, 8 values a thread
__global__ void bwd_dq_cast(const float* __restrict__ acc,
                            bf16* __restrict__ dq, size_t count8) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count8) return;
  const float4 a = reinterpret_cast<const float4*>(acc)[2 * i];
  const float4 c = reinterpret_cast<const float4*>(acc)[2 * i + 1];
  reinterpret_cast<uint4*>(dq)[i] =
      make_uint4(pack_f32(a.x, a.y), pack_f32(a.z, a.w), pack_f32(c.x, c.y),
                 pack_f32(c.z, c.w));
}

// padded query rows of the workspace: whole query tiles
inline int padded(int n) { return (n + kQ - 1) / kQ * kQ; }

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* work, void* dq, void* dk, void* dv, int batch,
                   int n, cudaStream_t stream) {
  using C = Cfg<D>;
  const int npad = padded(n);
  if ((size_t)batch * npad > (size_t)INT_MAX) return cudaErrorInvalidValue;
  const int rows = batch * npad;
  float* dq_acc = work;                              // [B, N, D]
  float* lse_pad = work + (size_t)batch * n * D;     // [B, npad]
  float* delta_pad = lse_pad + rows;                 // [B, npad]
  // first, since its first call on a thread binds the device's context
  // there, which the encoder needs: a call can come from a thread that has
  // none (the autograd engine's)
  static thread_local uint64_t attr_set = 0;
  cudaError_t err =
      bsr::smem_limit_once(attr_set, bwd_hopper_bf16<D>, C::kSmem);
  if (err != cudaSuccess) return err;
  bsr::EncodeTiled encode = bsr::encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap qm, km, vm, om, dkm, dvm, dqm;
  if (!bsr::encode_map(&qm, encode, q, batch, n, D, kQ) ||
      !bsr::encode_map(&km, encode, k, batch, n, D, C::kKeys) ||
      !bsr::encode_map(&vm, encode, v, batch, n, D, C::kKeys) ||
      !bsr::encode_map(&om, encode, dout, batch, n, D, kQ) ||
      !bsr::encode_map(&dkm, encode, dk, batch, n, D, 64) ||
      !bsr::encode_map(&dvm, encode, dv, batch, n, D, 64) ||
      !bsr::encode_map(&dqm, encode, dq_acc, batch, n, D, kQ, true)) {
    return cudaErrorInvalidValue;
  }
  const int per_block = kPrepThreads / 32;
  bwd_prep_bf16<D><<<(rows + per_block - 1) / per_block, kPrepThreads, 0,
                     stream>>>(static_cast<const bf16*>(dout),
                               static_cast<const bf16*>(out), lse, lse_pad,
                               delta_pad, dq_acc, n, npad, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid((n + C::kKeys - 1) / C::kKeys, batch);
  bwd_hopper_bf16<D><<<grid, kThreads, C::kSmem, stream>>>(
      qm, km, vm, om, dkm, dvm, dqm, lse_pad, delta_pad, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t count8 = (size_t)batch * n * D / 8;
  bwd_dq_cast<<<(unsigned)((count8 + 255) / 256), 256, 0, stream>>>(
      dq_acc, static_cast<bf16*>(dq), count8);
  return cudaGetLastError();
}

}  // namespace hop

// ----------------------------------------------------------------- f32 path
namespace f32 {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;            // keys per block
constexpr int kQ = 32;               // queries per step
constexpr int kLdP = kQ + 8;         // P^T, dS^T: [kKeys][kLdP]
constexpr int kLdT = kKeys + 8;      // dS: [kQ][kLdT]

// Shared memory: K, V [kKeys][D + 4]; Q, dO [kQ][D + 4]; P^T, dS^T; dS;
// lse and Delta of the step's queries.  Rows of D + 4 floats put the
// fragment reads of K, V, Q and dO on 32 banks, rows of 8 floats more the
// paired reads of P^T, dS^T and dS.
template <int D>
struct Cfg {
  static constexpr int kLd = D + 4;
  static constexpr int kSmem =
      ((2 * kKeys + 2 * kQ) * kLd + 2 * kKeys * kLdP + kQ * kLdT + 2 * kQ) *
      (int)sizeof(float);
  static_assert(kSmem <= 232448, "more shared memory than a block may have");
};

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

// an A fragment whose reduction index runs along the rows' columns in
// pairs: rows r and r + 8 at columns 2tig, 2tig + 1 of an 8-column step
__device__ __forceinline__ bsr::Tf32Frag<4> paired_a(const float* p,
                                                     int ld) {
  const float2 lo = *reinterpret_cast<const float2*>(p);
  const float2 hi = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float af[4] = {lo.x, hi.x, lo.y, hi.y};
  return bsr::split_frag(af);
}

// The block owns kKeys keys of one batch element and walks the queries kQ
// at a time: dK and dV stay in registers, and each step's dQ over the
// block's keys goes to `dq_out` (dtheta itself when one block holds every
// key, else this block's slot of the partial sums).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ out,
        const float* __restrict__ dout, const float* __restrict__ lse,
        float* __restrict__ dq, float* __restrict__ dk,
        float* __restrict__ dv, float* __restrict__ dq_part, int n) {
  using C = Cfg<D>;
  constexpr int LD = C::kLd;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;                     // [kKeys][LD]
  float* sv = sk + kKeys * LD;
  float* sq = sv + kKeys * LD;          // [kQ][LD]
  float* sdo = sq + kQ * LD;
  float* sp = sdo + kQ * LD;            // P^T [kKeys][kLdP]
  float* sds = sp + kKeys * kLdP;       // dS^T [kKeys][kLdP]
  float* sdst = sds + kKeys * kLdP;     // dS [kQ][kLdT]
  float* slse = sdst + kQ * kLdT;       // [kQ]
  float* sdelta = slse + kQ;

  const int b = blockIdx.y;
  const int j0 = blockIdx.x * kKeys;
  const size_t base = (size_t)b * n * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  // the warp's tiles: S^T and dP^T rows kr0.. (16 keys) x columns qc0..
  // (16 queries); dK and dV rows kr0.. x columns dc0.. (D/2); dQ rows
  // qr0.. (16 queries) x columns qd0.. (D/4)
  const int kr0 = (warp % 4) * 16;
  const int qc0 = (warp / 4) * 16;
  const int dc0 = (warp / 4) * (D / 2);
  const int qr0 = (warp % 2) * 16;
  const int qd0 = (warp / 2) * (D / 4);
  float* dq_out = gridDim.x == 1
      ? dq + base
      : dq_part + ((size_t)blockIdx.x * gridDim.y + b) * n * D;

  load_rows<D, kKeys>(sk, k + base, j0, n);
  load_rows<D, kKeys>(sv, v + base, j0, n);
  bsr::cp_async_commit();

  float dk_acc[D / 16][4], dv_acc[D / 16][4];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  const int steps = (n + kQ - 1) / kQ;
  for (int i = 0; i < steps; ++i) {
    const int q0 = i * kQ;
    load_rows<D, kQ>(sq, q + base, q0, n);
    load_rows<D, kQ>(sdo, dout + base, q0, n);
    bsr::cp_async_commit();
    {
      // Delta = rowsum(dO o O) of the step's queries, 8 lanes a query in
      // a fixed order, and their lse (+inf past n, so that P = 0 there)
      const int qi = threadIdx.x / 8;
      const int part = threadIdx.x % 8;
      const int row = q0 + qi;
      float acc = 0.f;
      if (row < n) {
        const float4* a =
            reinterpret_cast<const float4*>(dout + base + (size_t)row * D);
        const float4* c =
            reinterpret_cast<const float4*>(out + base + (size_t)row * D);
#pragma unroll
        for (int j = 0; j < D / 32; ++j) {
          const float4 x = a[part + 8 * j];
          const float4 y = c[part + 8 * j];
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
          acc = fmaf(x.z, y.z, acc);
          acc = fmaf(x.w, y.w, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      if (part == 0) {
        sdelta[qi] = acc;
        slse[qi] = row < n ? lse[(size_t)b * n + row] : INFINITY;
      }
    }
    bsr::cp_async_wait<0>();
    __syncthreads();                    // K, V, Q, dO, lse, Delta are in

    // S^T = K Q^T and dP^T = V dO^T (k = d in both operands)
    float s[2][4], dpt[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dpt[j][e] = 0.f;
    }
#pragma unroll 8
    for (int kk = 0; kk < D / 8; ++kk) {
      const float* ka = sk + (kr0 + grp) * LD + kk * 8 + tig;
      const float* va = sv + (kr0 + grp) * LD + kk * 8 + tig;
      const float kf[4] = {ka[0], ka[8 * LD], ka[4], ka[8 * LD + 4]};
      const float vf[4] = {va[0], va[8 * LD], va[4], va[8 * LD + 4]};
      const bsr::Tf32Frag<4> ak = bsr::split_frag(kf);
      const bsr::Tf32Frag<4> av = bsr::split_frag(vf);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* qb = sq + (qc0 + j * 8 + grp) * LD + kk * 8 + tig;
        const float* ob = sdo + (qc0 + j * 8 + grp) * LD + kk * 8 + tig;
        const float qf[2] = {qb[0], qb[4]};
        const float of[2] = {ob[0], ob[4]};
        bsr::mma_3xtf32(s[j], ak, bsr::split_frag(qf));
        bsr::mma_3xtf32(dpt[j], av, bsr::split_frag(of));
      }
    }
    // P^T = exp(S^T - lse) (0 for a key past n), dS^T = P^T o (dP^T -
    // Delta): into P^T and dS^T by key, and dS by query
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = kr0 + grp + 8 * h;
        const int qc = qc0 + j * 8 + 2 * tig;
        const bool live = j0 + key < n;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = live ? expf(s[j][2 * h + e] - slse[qc + e]) : 0.f;
          ds[e] = p[e] * (dpt[j][2 * h + e] - sdelta[qc + e]);
          sdst[(qc + e) * kLdT + key] = ds[e];
        }
        *reinterpret_cast<float2*>(sp + key * kLdP + qc) =
            make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(sds + key * kLdP + qc) =
            make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();                    // P^T, dS^T and dS are in

    // dV += P^T dO and dK += dS^T Q (k = query: rows 2tig, 2tig + 1)
#pragma unroll 1
    for (int kk = 0; kk < kQ / 8; ++kk) {
      const bsr::Tf32Frag<4> ap =
          paired_a(sp + (kr0 + grp) * kLdP + kk * 8 + 2 * tig, kLdP);
      const bsr::Tf32Frag<4> ads =
          paired_a(sds + (kr0 + grp) * kLdP + kk * 8 + 2 * tig, kLdP);
      const float* ob = sdo + (kk * 8 + 2 * tig) * LD + dc0 + grp;
      const float* qb = sq + (kk * 8 + 2 * tig) * LD + dc0 + grp;
#pragma unroll
      for (int nb = 0; nb < D / 16; ++nb) {
        const float of[2] = {ob[nb * 8], ob[LD + nb * 8]};
        const float qf[2] = {qb[nb * 8], qb[LD + nb * 8]};
        bsr::mma_3xtf32(dv_acc[nb], ap, bsr::split_frag(of));
        bsr::mma_3xtf32(dk_acc[nb], ads, bsr::split_frag(qf));
      }
    }
    // dQ of the step's queries over the block's keys = dS K (k = key)
    float dq_acc[D / 32][4];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;
    }
#pragma unroll 2
    for (int kk = 0; kk < kKeys / 8; ++kk) {
      const bsr::Tf32Frag<4> a =
          paired_a(sdst + (qr0 + grp) * kLdT + kk * 8 + 2 * tig, kLdT);
      const float* kb = sk + (kk * 8 + 2 * tig) * LD + qd0 + grp;
#pragma unroll
      for (int nb = 0; nb < D / 32; ++nb) {
        const float kf[2] = {kb[nb * 8], kb[LD + nb * 8]};
        bsr::mma_3xtf32(dq_acc[nb], a, bsr::split_frag(kf));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + qr0 + grp + 8 * h;
      if (row >= n) continue;
      float* dst = dq_out + (size_t)row * D + qd0 + 2 * tig;
#pragma unroll
      for (int nb = 0; nb < D / 32; ++nb) {
        *reinterpret_cast<float2*>(dst + nb * 8) =
            make_float2(dq_acc[nb][2 * h], dq_acc[nb][2 * h + 1]);
      }
    }
    __syncthreads();                    // the step's tiles are read
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = j0 + kr0 + grp + 8 * h;
    if (row >= n) continue;
    const size_t off = base + (size_t)row * D + dc0 + 2 * tig;
#pragma unroll
    for (int nb = 0; nb < D / 16; ++nb) {
      *reinterpret_cast<float2*>(dk + off + nb * 8) =
          make_float2(dk_acc[nb][2 * h], dk_acc[nb][2 * h + 1]);
      *reinterpret_cast<float2*>(dv + off + nb * 8) =
          make_float2(dv_acc[nb][2 * h], dv_acc[nb][2 * h + 1]);
    }
  }
}

// dtheta = the key blocks' partial sums, added in block order, 4 values a
// thread
__global__ void bwd_dq_sum_f32(const float4* __restrict__ part,
                               float4* __restrict__ dq, int blocks,
                               size_t count4) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count4) return;
  float4 acc = part[i];
  for (int t = 1; t < blocks; ++t) {
    const float4 x = part[(size_t)t * count4 + i];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  dq[i] = acc;
}

inline int key_blocks(int n) { return (n + kKeys - 1) / kKeys; }

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* work, void* dq, void* dk, void* dv, int batch,
                   int n, cudaStream_t stream) {
  static thread_local uint64_t attr_set = 0;
  cudaError_t err = bsr::smem_limit_once(attr_set, bwd_f32<D>, Cfg<D>::kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = key_blocks(n);
  bwd_f32<D><<<dim3(blocks, batch), kThreads, Cfg<D>::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(out),
      static_cast<const float*>(dout), lse, static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), work, n);
  if ((err = cudaGetLastError()) != cudaSuccess || blocks == 1) return err;
  const size_t count4 = (size_t)batch * n * D / 4;
  bwd_dq_sum_f32<<<(unsigned)((count4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(work), static_cast<float4*>(dq),
      blocks, count4);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

extern "C" {

// Floats of the f32 `workspace` that bsr_nonlocal_attn_bwd takes:
// at bf16, dQ's f32 sums [B, N, D] and the padded lse and Delta
// (2 x [B, N rounded up to 64]); at f32, dQ's partial sums of each block
// of 64 keys ([ceil(N / 64), B, N, D]), none when one block holds N.
long long bsr_nonlocal_attn_bwd_workspace(int batch, int n, int d,
                                          int dtype) {
  if (dtype == 1) {
    return (long long)batch * n * d + 2LL * batch * hop::padded(n);
  }
  const int blocks = f32::key_blocks(n);
  return blocks == 1 ? 0 : (long long)blocks * batch * n * d;
}

// dtype: 0 = float32, 1 = bfloat16.  `lse` is the forward kernel's row
// logsumexp ([B, N] f32); `workspace` is the f32 scratch above.  Writes
// dtheta, dphi and dg.  Returns a cudaError_t value.
int bsr_nonlocal_attn_bwd(const void* theta, const void* phi, const void* g,
                          const void* out, const void* dout, const void* lse,
                          void* workspace, void* dtheta, void* dphi, void* dg,
                          int batch, int n, int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ws = static_cast<float*>(workspace);
  if (batch < 1 || batch > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && d == 128)
    return (int)hop::launch<128>(theta, phi, g, out, dout, l, ws, dtheta, dphi, dg, batch, n, s);
  if (dtype == 1 && d == 256)
    return (int)hop::launch<256>(theta, phi, g, out, dout, l, ws, dtheta, dphi, dg, batch, n, s);
  if (dtype == 0 && d == 128)
    return (int)f32::launch<128>(theta, phi, g, out, dout, l, ws, dtheta, dphi, dg, batch, n, s);
  if (dtype == 0 && d == 256)
    return (int)f32::launch<256>(theta, phi, g, out, dout, l, ws, dtheta, dphi, dg, batch, n, s);
  return (int)cudaErrorInvalidValue;
}

const char* bsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
