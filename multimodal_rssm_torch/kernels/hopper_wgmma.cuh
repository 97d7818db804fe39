// Hopper building blocks shared by the wgmma kernels of this directory:
// 16-byte cp.async with zero fill, mbarriers and TMA tensor loads, the
// 128-byte shared-memory swizzle, wgmma shared-memory descriptors and the
// bf16 m64nNk16 wgmma (the N the kernels use) with f32 accumulators.
// sm_90a only (wgmma does not exist on plain sm_90).
//
// Shared-memory operand layout (both operands, both majors): "atoms" of
// 64 rows x 128 bytes (64 bf16), each atom 1024-byte aligned, with the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8) -- the layout
// wgmma's 128-byte swizzle mode reads and TMA's SWIZZLE_128B writes.
//   K-major operand (K contiguous, e.g. A = im2col rows): a row is one
//     M (or N) index and holds 64 consecutive k; 8-row groups are
//     1024 bytes apart (SBO); a k16 step moves the start address by 32 B.
//   MN-major operand (M or N contiguous): a row is one k and holds 64
//     consecutive M (or N) indices; 8-k groups are 1024 bytes apart (SBO),
//     64-wide MN atoms are LBO bytes apart; a k16 step moves the start
//     address by 16 rows = 2048 B.

#pragma once

#include <stdint.h>

namespace hopper {

constexpr uint32_t kAtomRows = 64;
constexpr uint32_t kAtomBytes = kAtomRows * 128;  // 8 KB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` (0..7) of row `row` in an atom.
__device__ __forceinline__ uint32_t swizzle128(uint32_t row, uint32_t chunk) {
  return row * 128u + ((chunk ^ (row & 7u)) << 4);
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (a source
// size of 0 reads nothing, so `src` only has to be some valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Make this thread's shared-memory writes (generic proxy: cp.async, st.shared)
// visible to wgmma's operand reads (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarrier with `count` arrivals per phase, at shared address `bar`; the
// fence makes the initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on `bar` that also expects `bytes` of copies to complete on it.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `bar` with this parity to complete.  A wait of
// about ten seconds means a copy that never arrives: trap rather than hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// TMA: the box of `tmap` (a CUtensorMap in parameter or global memory) at
// the given coordinates (innermost first; out-of-range elements are zero)
// into shared memory at `dst`, completing `bar`'s expected bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* tmap,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(tmap), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* tmap,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(tmap), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address `addr`:
// leading and stride byte offsets in bytes (multiples of 16).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Tell the compiler the accumulators change here, so that it neither reads
// them before a wgmma_wait nor moves their writes past a wgmma.
template <int kN>
__device__ __forceinline__ void fence_operands(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] += A[64 x 16] . B[16 x N] for N = 32, 64, 96, 128, 160 (K2)
// and 256 (K3b, K3c): bf16 operands in shared memory, f32 accumulators.
// Thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and
// columns 8 j + 2 (t % 4) (+ 1), j < N / 8, in d[4 j + {0, 1}] (and
// d[4 j + {2, 3}] for the row + 8).  kTransA / kTransB: 0 = K-major,
// 1 = MN-major.  One specialisation per N below: the register list of an
// inline-asm statement is literal.
template <int kN, int kTransA, int kTransB>
struct Wgmma;

#define HOPPER_WGMMA_N(N, REGS, DA, DB, SD, TA, TB, ...)                      \
  template <int kTransA, int kTransB>                                         \
  struct Wgmma<N, kTransA, kTransB> {                                         \
    static __device__ __forceinline__ void run(float (&d)[N / 2], uint64_t da, \
                                               uint64_t db) {                 \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SD ", 0;\n"            \
                   "wgmma.mma_async.sync.aligned.m64n" #N                     \
                   "k16.f32.bf16.bf16 {" REGS "}, " DA ", " DB                \
                   ", p, 1, 1, " TA ", " TB ";\n}\n"                          \
                   : __VA_ARGS__                                              \
                   : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));   \
    }                                                                         \
  };

#define HOPPER_WGMMA_R0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_WGMMA_R1 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_WGMMA_R2 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define HOPPER_WGMMA_R3 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HOPPER_WGMMA_R4 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define HOPPER_WGMMA_R5 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define HOPPER_WGMMA_R6 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
#define HOPPER_WGMMA_R7 "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define HOPPER_WGMMA_D0 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define HOPPER_WGMMA_D1 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HOPPER_WGMMA_D2 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
#define HOPPER_WGMMA_D3 "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_WGMMA_D4 "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
#define HOPPER_WGMMA_D5 "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
#define HOPPER_WGMMA_D6 "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
#define HOPPER_WGMMA_D7 "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
HOPPER_WGMMA_N(32, HOPPER_WGMMA_R0, "%16", "%17", "%18", "%19", "%20", HOPPER_WGMMA_D0)
HOPPER_WGMMA_N(64, HOPPER_WGMMA_R0 ", " HOPPER_WGMMA_R1, "%32", "%33", "%34", "%35", "%36", HOPPER_WGMMA_D0, HOPPER_WGMMA_D1)
HOPPER_WGMMA_N(96, HOPPER_WGMMA_R0 ", " HOPPER_WGMMA_R1 ", " HOPPER_WGMMA_R2, "%48", "%49", "%50", "%51", "%52", HOPPER_WGMMA_D0, HOPPER_WGMMA_D1, HOPPER_WGMMA_D2)
HOPPER_WGMMA_N(128, HOPPER_WGMMA_R0 ", " HOPPER_WGMMA_R1 ", " HOPPER_WGMMA_R2 ", " HOPPER_WGMMA_R3, "%64", "%65", "%66", "%67", "%68", HOPPER_WGMMA_D0, HOPPER_WGMMA_D1, HOPPER_WGMMA_D2, HOPPER_WGMMA_D3)
HOPPER_WGMMA_N(160, HOPPER_WGMMA_R0 ", " HOPPER_WGMMA_R1 ", " HOPPER_WGMMA_R2 ", " HOPPER_WGMMA_R3 ", " HOPPER_WGMMA_R4, "%80", "%81", "%82", "%83", "%84", HOPPER_WGMMA_D0, HOPPER_WGMMA_D1, HOPPER_WGMMA_D2, HOPPER_WGMMA_D3, HOPPER_WGMMA_D4)
HOPPER_WGMMA_N(256, HOPPER_WGMMA_R0 ", " HOPPER_WGMMA_R1 ", " HOPPER_WGMMA_R2 ", " HOPPER_WGMMA_R3 ", " HOPPER_WGMMA_R4 ", " HOPPER_WGMMA_R5 ", " HOPPER_WGMMA_R6 ", " HOPPER_WGMMA_R7, "%128", "%129", "%130", "%131", "%132", HOPPER_WGMMA_D0, HOPPER_WGMMA_D1, HOPPER_WGMMA_D2, HOPPER_WGMMA_D3, HOPPER_WGMMA_D4, HOPPER_WGMMA_D5, HOPPER_WGMMA_D6, HOPPER_WGMMA_D7)

template <int kN, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma(float (&d)[kN / 2], uint64_t da,
                                      uint64_t db) {
  Wgmma<kN, kTransA, kTransB>::run(d, da, db);
}

}  // namespace hopper
