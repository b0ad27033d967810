// Hopper (sm_90a) building blocks in inline PTX: shared-memory barriers
// (mbarrier), the Tensor Memory Accelerator (TMA) and warpgroup matrix
// multiply (wgmma) with 128-byte-swizzled shared-memory operands for the
// bf16 kernels; cp.async and 3xTF32 products on mma.sync for the f32 ones.
//
// Layout shared by the TMA maps and the wgmma descriptors: a bf16 tile is
// cut into panels of 64 columns (128 bytes a row; an f32 tile into panels
// of 32); a panel's rows lie 128 bytes apart, and inside each 1024-byte
// group of 8 rows the 16-byte chunk c of row r sits at chunk c ^ (r % 8)
// (CU_TENSOR_MAP_SWIZZLE_128B).  Every panel starts on a 1024-byte
// boundary.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bsr {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` of TMA traffic in the current phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// returns once the phase of parity `parity` has completed; a barrier that
// was just initialised counts its (nonexistent) phase of parity 1 complete.
// No time-out: a kernel that can trap loses, in ptxas, the register budget
// that setmaxnreg gives each warpgroup role (seen with CUDA 12.9).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// ------------------------------------------------------------------- TMA
// box at coordinates (c0, c1, c2), innermost first, into shared memory;
// completion counts its bytes on `bar`.  Elements outside the tensor read
// as zero.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// box from shared memory to coordinates (c0, c1, c2); elements outside the
// tensor are not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory; completion counts them on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// adds a box of f32 from shared memory into the tensor at coordinates
// (c0, c1, c2), element by element, in L2; elements outside the tensor are
// not touched.  Completion as a bulk group of the issuing thread.
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// returns once at most `kPending` of this thread's committed bulk groups
// still read shared memory
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(kPending)
               : "memory");
}

// orders this thread's shared-memory writes before later async-proxy
// (TMA) reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier over `count` threads (a multiple of 32) under id `id` (1-15;
// 0 is __syncthreads)
__device__ __forceinline__ void named_barrier(uint32_t id, uint32_t count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// arrives on barrier `id` without waiting; `count` as in named_barrier
__device__ __forceinline__ void named_barrier_arrive(uint32_t id,
                                                     uint32_t count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// --------------------------------------------------- register rebalancing
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

// ----------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor with 128-byte swizzle.  K-major operands
// (rows of 128 bytes along the reduction): `sbo` is the stride between
// 8-row groups (1024), `lbo` is unused.  MN-major operands (rows of 128
// bytes along M or N, one row per reduction index): `lbo` is the stride
// between 64-column panels, `sbo` between groups of 8 reduction rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// returns once at most `kPending` of the warpgroup's committed wgmma
// groups are still in flight
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// Pins registers in place around an asynchronous wgmma: the compiler may
// neither move their reads and writes across this point nor reuse them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define BSR_ACC8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// Fragment of the f32 accumulator D of m64nNk16 (N/2 values a thread):
// warp w of the warpgroup holds rows 16w..16w+15; lane = 4*grp + tig holds,
// for each 8-column block j, d[4j+0..1] = D[16w+grp][8j+2tig..+1] and
// d[4j+2..3] = D[16w+grp+8][8j+2tig..+1].

// The ss forms below take A[64x16] and B[16xN] from shared memory.  An
// operand is K-major by default (rows of 128 bytes along the reduction);
// kTransA / kTransB = 1 makes it MN-major instead (rows of 128 bytes along
// M or N, one row per reduction index), transposed by the descriptor.

// d[64x32] (+)= A[64x16] . B[16x32], both K-major
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16], uint64_t a,
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : BSR_ACC8(0), BSR_ACC8(8)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64x64] (+)= A[64x16] . B[16x64]
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t a,
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : BSR_ACC8(0), BSR_ACC8(8), BSR_ACC8(16), BSR_ACC8(24)
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d[64x128] (+)= A[64x16] . B[16x128]
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t a,
                                                    uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : BSR_ACC8(0), BSR_ACC8(8), BSR_ACC8(16), BSR_ACC8(24), BSR_ACC8(32),
        BSR_ACC8(40), BSR_ACC8(48), BSR_ACC8(56)
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d[64x128] (+)= A[64x16] . B[16x128]: A from registers (bf16 pairs, the
// m16n8k16 A layout per warp), B from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_m64n128k16_tb(float (&d)[64],
                                                       const uint32_t (&a)[4],
                                                       uint64_t b,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, "
      "p, 1, 1, 1;\n"
      "}\n"
      : BSR_ACC8(0), BSR_ACC8(8), BSR_ACC8(16), BSR_ACC8(24), BSR_ACC8(32),
        BSR_ACC8(40), BSR_ACC8(48), BSR_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// TF32 operands (wgmma k8: 8 f32 = 32 bytes of a 128-byte K-major row).
// Both operands of a tf32 wgmma are K-major: no transpose.  A from
// registers in the m16n8k8 A layout per warp (rows 16w..16w+15 of the
// warpgroup's 64), B from shared memory.

// d[64x32] (+)= A[64x8] . B[8x32]
__device__ __forceinline__ void wgmma_rs_m64n32k8_tf32(float (&d)[16],
                                                       const uint32_t (&a)[4],
                                                       uint64_t b,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : BSR_ACC8(0), BSR_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[64x64] (+)= A[64x8] . B[8x64]
__device__ __forceinline__ void wgmma_rs_m64n64k8_tf32(float (&d)[32],
                                                       const uint32_t (&a)[4],
                                                       uint64_t b,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : BSR_ACC8(0), BSR_ACC8(8), BSR_ACC8(16), BSR_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[64x128] (+)= A[64x8] . B[8x128]
__device__ __forceinline__ void wgmma_rs_m64n128k8_tf32(float (&d)[64],
                                                        const uint32_t (&a)[4],
                                                        uint64_t b,
                                                        int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, "
      "p, 1, 1;\n"
      "}\n"
      : BSR_ACC8(0), BSR_ACC8(8), BSR_ACC8(16), BSR_ACC8(24), BSR_ACC8(32),
        BSR_ACC8(40), BSR_ACC8(48), BSR_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef BSR_ACC8

// -------------------------------------------------------------- cp.async
// 16 bytes from global to shared memory, asynchronously; when `live` is
// false nothing is read and the 16 bytes are zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// returns once at most `kPending` of this thread's committed groups are
// still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// ------------------------------------------------- 3xTF32 on mma.sync
// f32 products on the tensor cores to f32 accuracy: each operand splits
// into big = tf32(x) and small = x - big, and a product sums small.big +
// big.small + big.big in f32 (small.small, ~2^-22 of it, is dropped).
// Fragments of mma.m16n8k8 (lane = 4*grp + tig): A[16x8] a0 = (grp, tig),
// a1 = (grp+8, tig), a2 = (grp, tig+4), a3 = (grp+8, tig+4); B[8x8] b0 =
// (k=tig, n=grp), b1 = (k=tig+4, n=grp); C[16x8] c0, c1 = (grp,
// 2tig..2tig+1), c2, c3 = (grp+8, 2tig..2tig+1).  An operand read with its
// reduction index along the rows may take k = tig as row 2tig and k =
// tig+4 as row 2tig+1 of each 8-row step, as long as both operands do: a
// C fragment then is an A fragment as it lies ({c0, c2, c1, c3}).

// big = x rounded to TF32 (10 stored mantissa bits) to nearest, ties away
// from zero: half a TF32 ulp added, the 13 low bits cleared (two integer
// operations; sm_90 runs cvt.rna.tf32.f32 as a longer sequence).  small =
// x - big, exact in f32; the tensor cores read an operand's top 19 bits,
// so small enters truncated to TF32, within 2^-10 of itself.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// an A (N = 4) or B (N = 2) fragment as its big and small parts
template <int N>
struct Tf32Frag {
  uint32_t big[N], small[N];
};

template <int N>
__device__ __forceinline__ Tf32Frag<N> split_frag(const float (&x)[N]) {
  Tf32Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], f.big[i], f.small[i]);
  return f;
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[16x8] = A[16x8] . B[8x8] on TF32 operands, d's old values ignored
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// d[16x8] += A[16x8] . B[8x8] to f32 accuracy.  The tensor cores align
// the addends of a sum to the largest and truncate, so a long sum carried
// through their accumulator loses about an ulp of its running value at
// every step, all one way (on the card that put K1 past KERNEL_TOLERANCE
// at D=256).  So the three products of each 8-step go into a fresh
// accumulator, small ones first, and are added into d by f32 adds that
// round to nearest.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const Tf32Frag<4>& a,
                                           const Tf32Frag<2>& b) {
  float t[4];
  mma_tf32_fresh(t, a.small, b.big);
  mma_tf32(t, a.big, b.small);
  mma_tf32(t, a.big, b.big);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// ------------------------------------------------------------- launches
// Raises `kernel`'s dynamic shared-memory limit to `bytes` once per
// device and calling thread; `done` (one bit a device) is the caller's
// thread_local flag word for that kernel.  The first call on a thread also
// makes the device's primary context current there, which the tensor-map
// encoder needs: a launch can come from a thread that has none (the
// autograd engine's).
template <typename Kernel>
inline cudaError_t smem_limit_once(uint64_t& done, Kernel kernel,
                                   int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

// ------------------------------------------------------ tensor maps (host)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found at run time (no link against
// libcuda); null when the driver lacks it
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// 3-D map over a [batch, n, d] bf16 tensor (f32 when `f32`), boxes of one
// 128-byte swizzled panel (64 bf16 or 32 f32 columns) x `rows`; rows past n
// read as zero and are not written
inline bool encode_map(CUtensorMap* map, EncodeTiled encode, const void* ptr,
                       int batch, int n, int d, int rows, bool f32 = false) {
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)d * es, (cuuint64_t)n * d * es};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / es), (cuuint32_t)rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map,
                f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace bsr
