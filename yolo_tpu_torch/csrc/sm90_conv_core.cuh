// The Hopper (sm_90a) implicit-GEMM mainloop shared by the int8 conv
// (int8_conv.cu, which also runs the int8 dot of the mosaic_int8_dot
// harness as a 1x1 conv), the bf16 3x3 conv (bf16_conv_stats.cu) and the
// Winograd conv's tap GEMM (int8_wino.cu). Its barriers, copies, swizzle,
// descriptors and wgmma wrappers (with A from registers too) also build the
// fused-bottleneck tile of sm90_bottleneck_tile.cuh.
//
// A conv as a GEMM: M = N*Ho*Wo output pixels, N = Cout, K = KH*KW*Cin in
// HWIO order (tap-major, channel fastest). Both operands are K-major in
// shared memory: A is the im2col tile, gathered on the fly from NHWC
// activations; B is the packed (Cout, Kpad) weight, K contiguous. bf16 k16
// and s8 k32 both take 32 bytes of K per wgmma, so one layout serves both
// element types; only the instruction and the accumulator type differ.
//
//   * Stages hold 128 bytes of K for BM rows of A and BN rows of B, in
//     wgmma's 128-byte-swizzled K-major layout: row r at r * 128 bytes, its
//     16-byte chunk c at chunk c ^ (r % 8); every tile base is 1024-byte
//     aligned. A stage feeds four wgmmas (k advances 32 bytes a time).
//   * 4 stages (3 for one consumer warpgroup, so that two blocks fit an SM;
//     8 for the segmented GEMM) form a ring with a full and an empty
//     mbarrier each.
//   * One producer warpgroup fills the ring with cp.async: 16-byte pieces,
//     4-byte pieces where a row is only 4-byte aligned (Cin % 16 != 0 but
//     Cin % 4 == 0: the space-to-depth stem, 12 channels), or a byte gather
//     (Cin = 3: the direct 7x7 stem). Padding, rows past M, channels past
//     Cout and K past the data are zero-filled (cp.async with source size
//     0). Each thread signals the full barrier with
//     cp.async.mbarrier.arrive.noinc once its copies land. B comes by
//     cp.async too, not TMA: the producer runs anyway for the im2col
//     gather, B's rows are 128 contiguous bytes, and the consumers, not the
//     loads, set the pace.
//   * kWG consumer warpgroups (64 rows of the tile each) wait on the full
//     barrier, fence the generic-proxy writes for the async proxy
//     (fence.proxy.async), issue the stage's wgmmas, keep one group in
//     flight and release the previous stage to the producer.
//   * The grid is persistent: each block walks units (split, m tile, n
//     tile) in a fixed order, the ring running on across units, so one
//     tile's epilogue overlaps the producer's loads of the next.
//   * Split-K: a unit covers k_stages stages of one split of K.
//   * The kernel owns shared memory after the ring: the producer calls its
//     pre() at the start of each unit (the int8 conv fetches the tile's
//     epilogue operands there), the consumers its epi() at the end.
//   * Per-unit index arithmetic divides by FastDivs (multiply-high and
//     shift): the producer is one warp a scheduler, and ~20 dependent
//     instructions a runtime division cost it most of a short-K tile.
//   * Segments (the Winograd conv's 16 taps): a unit may run `segments`
//     GEMMs one after the other, A and B advancing a_seg / b_seg bytes from
//     one to the next; the consumers call epi() after each (Unit::seg) with
//     that segment's accumulator, and the ring runs on across segments, so
//     the next segment's stages load while one finishes. The segments'
//     A operand is a plain row-major (M, Cin) matrix (gather kRows). A
//     conv has one segment, and its gathers compile without the segment
//     loop: taken at run time, it cost the int8 conv 10-35% of its time.
//
// A conv needs no setmaxnreg: at one block of 384 threads an SM every
// thread may hold 168 registers, enough for a 64x256 float32 accumulator
// (128) and the bf16 conv's stats epilogue (ptxas: 168, no spills). A
// kernel that keeps more state across segments (the Winograd conv's four
// float32 running sums) asks for kRegs: the producer gives registers back
// (setmaxnreg.dec to 40) and the consumers take them (setmaxnreg.inc).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace sm90 {

constexpr int kStageBytes = 128;  // K bytes per stage: one 128-byte swizzle row
constexpr int kWgThreads = 128;

// A's gather: an im2col row in 16-byte, 4-byte or 1-byte pieces, or (kRows)
// a plain row of an (M, Cin) matrix, one matrix a segment. Only kRows runs
// more than one segment; the convs' gathers compile without the loop.
enum Gather { kVec16 = 0, kVec4 = 1, kByte = 2, kRows = 3 };

// Stages of the ring: 4 with two consumer warpgroups, 3 with one (so that
// two blocks of the int8 conv's 64-row tiles fit an SM); 8 for the
// segmented GEMM, one block an SM, whose units stream more operand bytes a
// multiply-add (64-wide tiles) and so keep more in flight.
template <int kWG, int kGather>
__host__ __device__ constexpr int stages_of() {
  return kGather == kRows ? 8 : kWG == 2 ? 4 : 3;
}

// Division by a divisor fixed for the launch, as a multiply-high and a
// shift, exact for 0 <= n < 2^31 (the round-up method with p = 31 +
// ceil(log2 d)).
struct FastDiv {
  int d;
  uint32_t mul, shift;
};

inline FastDiv fast_div(int d) {
  if (d <= 1) return {1, 0u, 0u};
  int log2 = 0;
  while ((1LL << log2) < d) ++log2;  // ceil(log2(d))
  const unsigned p = 31u + static_cast<unsigned>(log2);
  return {d, static_cast<uint32_t>(((1ULL << p) + d - 1) / d), p - 32u};
}

__device__ __forceinline__ int operator/(int n, const FastDiv& f) {
  return f.d == 1 ? n : static_cast<int>(__umulhi(static_cast<uint32_t>(n), f.mul) >> f.shift);
}

// One conv call as the mainloop sees it. Sizes in elements unless named bytes.
struct Geom {
  const uint8_t* x;  // (N, H, W, Cin) activations
  const uint8_t* w;  // (Cout, kpad_bytes) packed weights, K contiguous
  int H, W, Cin, Ho, Wo, Cout, KH, KW, stride, pad_t, pad_l;
  int K;           // KH * KW * Cin
  int kpad_bytes;  // bytes of one packed weight row
  long long M;     // N * Ho * Wo
  int m_tiles, n_tiles, splits, k_stages;  // k_stages: stages of one split (of one segment)
  int units;                               // m_tiles * n_tiles * splits
  FastDiv f_ntiles, f_mtiles, f_hw, f_wo, f_ho, f_cin, f_kw;
  int segments = 1;             // GEMMs a unit runs one after the other
  long long a_seg = 0, b_seg = 0;  // bytes from one segment's A (B) to the next's
};

// Fills the FastDivs of g from its sizes (on the host, before a launch).
inline void set_divisors(Geom& g) {
  g.f_ntiles = fast_div(g.n_tiles);
  g.f_mtiles = fast_div(g.m_tiles);
  g.f_hw = fast_div(g.Ho * g.Wo);
  g.f_wo = fast_div(g.Wo);
  g.f_ho = fast_div(g.Ho);
  g.f_cin = fast_div(g.Cin);
  g.f_kw = fast_div(g.KW);
}

// One unit of the persistent walk: an output tile and a split of K.
struct Unit {
  long long m0;
  int n0, split, k0;  // k0: first stage of the split
  int ord;            // the unit's place in its block's walk: 0, 1, 2, ...
  int seg;            // the segment whose accumulator epi() gets
};

// Unit u, the ord-th of its block.
template <int BM, int BN>
__device__ __forceinline__ Unit unit_of(const Geom& g, int u, int ord) {
  const int r = u / g.f_ntiles, nt = u - r * g.n_tiles;
  const int sp = r / g.f_mtiles, mt = r - sp * g.m_tiles;
  return {static_cast<long long>(mt) * BM, nt * BN, sp, sp * g.k_stages, ord, 0};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The barrier's arrival fires once all of this thread's earlier cp.asyncs landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// ------------------------------------------------------------ copies
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// ------------------------------------------------------------ wgmma
// K-major operand in the 128-byte swizzle: start address in 16-byte units,
// leading offset unused (1), stride 1024 bytes between 8-row groups.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across wgmma issue/wait.
template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N) += A (64 x 32 bytes of K) * B (N x 32 bytes of K)^T: s8
// m64nNk32 with int32 accumulators (N = 64, 128: the int8 conv's tiles),
// bf16 m64n256k16 with float32 (the bf16 conv's). Accumulator i of
// thread t (warp w = t / 32 % 4 of the warpgroup, lane l): row 16 w + l / 4
// + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
__device__ __forceinline__ void wgmma(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// bf16 m64n64k16 with float32 accumulators, A and B from shared memory (the
// fused bottleneck's conv1 and downsample, one 64-column half a warpgroup).
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// A (64 x 32 bytes of K) from registers, B from shared memory: s8 m64n64k32
// and bf16 m64n64k16. Warp w of the warpgroup holds rows 16 w .. 16 w + 15 of
// A as mma.sync's m16n8k32 / m16n8k16 A fragment (a[0]: row l / 4, bytes 4 (l
// % 4) .. + 3; a[1]: row + 8; a[2], a[3]: the same 16 bytes on), which
// ldmatrix_x4 loads. The registers must stay unchanged until a wgmma_wait
// covers the wgmma.
__device__ __forceinline__ void wgmma(int (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of a
// row of matrix l / 8. With lane l at row l % 16, byte 16 (l / 16) of a
// 16-row, 32-byte slab, r is that slab as wgmma's register A fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ------------------------------------------------------------ the loop
// Dynamic shared memory a block needs: the ring, kExtraBytes for the
// kernel's epilogue, the barriers, and slack to align the ring to 1024 bytes.
template <int kWG, int BN, int kGather, int kExtraBytes>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + stages_of<kWG, kGather>() * (64 * kWG + BN) * kStageBytes + kExtraBytes +
         2 * stages_of<kWG, kGather>() * 8;
}

// The producer warpgroup. Thread t fills 16-byte chunk t % 8 of rows t / 8
// + 16 i of A and B in every stage. Its rows' pixels are decoded once per
// unit (one division, then steps of 16 rows); the chunk's tap and channel
// advance from stage to stage without dividing (16-byte gathers), so a row
// costs a bounds check, an add and a cp.async per stage. All offsets within
// one segment are 32-bit: the host refuses tensors of 2 GB or more (a
// segment's; the segments' own offsets are 64-bit).
template <int E, int BM, int BN, int kStages, int kGather, typename Pre>
__device__ __forceinline__ void produce(const Geom& g, uint32_t sA, uint32_t sB, uint32_t full,
                                        uint32_t empty, int t, Pre& pre) {
  constexpr int kAP = BM / 16, kBP = BN / 16;  // rows this thread fills per stage
  constexpr int kStageElems = kStageBytes / E, kChunkElems = 16 / E;
  constexpr bool kSeg = kGather == kRows;
  const int c = t % 8, r0 = t / 8;            // chunk c of rows r0 + 16 i
  const uint32_t swz = (c ^ (r0 % 8)) * 16;   // r0 + 16 i == r0 (mod 8)
  const int M = static_cast<int>(g.M), hw = g.Ho * g.Wo;
  const int d_oh = 16 / g.f_wo, d_ow = 16 - d_oh * g.Wo;  // a step of 16 output pixels
  const int segments = kSeg ? g.segments : 1;
  int it = 0, ord = 0;
  for (int u = blockIdx.x; u < g.units; u += gridDim.x, ++ord) {
    const Unit un = unit_of<BM, BN>(g, u, ord);
    pre(un, t);  // the kernel's own loads for this unit's epilogue, if any
    // Row i: the element offset of its receptive field's origin (ih0, iw0,
    // channel 0) in x; rows past M get ih0 far out, failing every bound
    // check. kRows: the row's offset in its segment's matrix, -1 past M.
    int off[kAP], ih0[kAP], iw0[kAP];
    if constexpr (kGather == kRows) {
#pragma unroll
      for (int i = 0; i < kAP; ++i) {
        const int m = static_cast<int>(un.m0) + r0 + 16 * i;
        off[i] = m < M ? m * g.Cin : -1;
      }
    } else {
      int m = static_cast<int>(un.m0) + r0;
      const int n0 = m / g.f_hw, rem = m - n0 * hw, oh0 = rem / g.f_wo;
      int n = n0, oh = oh0, ow = rem - oh0 * g.Wo;
#pragma unroll
      for (int i = 0; i < kAP; ++i) {
        const bool ok = m < M;
        ih0[i] = ok ? oh * g.stride - g.pad_t : -(1 << 28);
        iw0[i] = ow * g.stride - g.pad_l;
        off[i] = ok ? ((n * g.H + ih0[i]) * g.W + iw0[i]) * g.Cin : 0;
        m += 16;
        ow += d_ow;
        oh += d_oh;
        if (ow >= g.Wo) {
          ow -= g.Wo;
          ++oh;
        }
        if (oh >= g.Ho) {
          const int q = oh / g.f_ho;
          n += q;
          oh -= q * g.Ho;
        }
      }
    }
    int woff[kBP];  // B row offsets, -1 past Cout
#pragma unroll
    for (int i = 0; i < kBP; ++i) {
      const int n = un.n0 + r0 + 16 * i;
      woff[i] = n < g.Cout ? n * g.kpad_bytes : -1;
    }
    for (int seg = 0; seg < segments; ++seg) {
      const uint8_t* xs = kSeg ? g.x + seg * g.a_seg : g.x;
      const uint8_t* ws = kSeg ? g.w + seg * g.b_seg : g.w;
      // The chunk's first K element at this unit's first stage, its tap and channel.
      int k = un.k0 * kStageElems + c * kChunkElems;
      const int tap0 = k / g.f_cin;
      int ci = k - tap0 * g.Cin, kh = tap0 / g.f_kw, kw = tap0 - kh * g.KW;
      for (int ks = 0; ks < g.k_stages; ++ks, ++it) {
        const int st = it % kStages;
        mbar_wait(empty + 8 * st, ((it / kStages) & 1) ^ 1);
        const uint32_t a = sA + st * BM * kStageBytes + swz;
        const uint32_t b = sB + st * BN * kStageBytes + swz;
        const int kb = (un.k0 + ks) * kStageBytes + c * 16;  // byte kb of each A (kRows) and B row
        if constexpr (kGather == kRows) {  // 16 bytes of a row; none past Cin
#pragma unroll
          for (int i = 0; i < kAP; ++i) {
            const bool ok = off[i] >= 0 && kb < g.Cin;
            cp_async16(a + (r0 + 16 * i) * kStageBytes, xs + (ok ? off[i] + kb : 0), ok);
          }
        } else if constexpr (kGather == kVec16) {  // 16 bytes of one tap (Cin * E % 16 == 0)
          const bool kin = k < g.K;
          const int delta = (kh * g.W + kw) * g.Cin + ci;
#pragma unroll
          for (int i = 0; i < kAP; ++i) {
            const int ih = ih0[i] + kh, iw = iw0[i] + kw;
            const bool ok = kin && static_cast<unsigned>(ih) < static_cast<unsigned>(g.H) &&
                            static_cast<unsigned>(iw) < static_cast<unsigned>(g.W);
            cp_async16(a + (r0 + 16 * i) * kStageBytes, xs + (ok ? (off[i] + delta) * E : 0), ok);
          }
        } else if constexpr (kGather == kVec4) {
#pragma unroll
          for (int p = 0; p < 4; ++p) {  // 4-byte pieces never straddle a tap (Cin % 4 == 0)
            const int kp = k + p * (4 / E);
            const int tap = kp / g.f_cin, cp = kp - tap * g.Cin;
            const int ph = tap / g.f_kw, pw = tap - ph * g.KW;
            const bool kin = kp < g.K;
            const int delta = (ph * g.W + pw) * g.Cin + cp;
#pragma unroll
            for (int i = 0; i < kAP; ++i) {
              const int ih = ih0[i] + ph, iw = iw0[i] + pw;
              const bool ok = kin && static_cast<unsigned>(ih) < static_cast<unsigned>(g.H) &&
                              static_cast<unsigned>(iw) < static_cast<unsigned>(g.W);
              cp_async4(a + (r0 + 16 * i) * kStageBytes + 4 * p,
                        xs + (ok ? (off[i] + delta) * E : 0), ok);
            }
          }
        } else {  // bytes (E == 1): Cin = 3
#pragma unroll
          for (int i = 0; i < kAP; ++i) {
            uint32_t word[4] = {0u, 0u, 0u, 0u};
            int tap = k / g.f_cin, cj = k - tap * g.Cin;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int jh = tap / g.f_kw, jw = tap - jh * g.KW;
              const int ih = ih0[i] + jh, iw = iw0[i] + jw;
              if (k + j < g.K && static_cast<unsigned>(ih) < static_cast<unsigned>(g.H) &&
                  static_cast<unsigned>(iw) < static_cast<unsigned>(g.W)) {
                const uint8_t v = xs[off[i] + (jh * g.W + jw) * g.Cin + cj];
                word[j / 4] |= static_cast<uint32_t>(v) << (8 * (j % 4));
              }
              if (++cj == g.Cin) {
                cj = 0;
                ++tap;
              }
            }
            asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                             a + (r0 + 16 * i) * kStageBytes),
                         "r"(word[0]), "r"(word[1]), "r"(word[2]), "r"(word[3])
                         : "memory");
          }
        }
#pragma unroll
        for (int i = 0; i < kBP; ++i) {
          const bool ok = woff[i] >= 0 && kb < g.kpad_bytes;
          cp_async16(b + (r0 + 16 * i) * kStageBytes, ws + (ok ? woff[i] + kb : 0), ok);
        }
        if constexpr (kGather == kByte) mbar_arrive(full + 8 * st);  // the st.shared above
        cp_async_arrive(full + 8 * st);
        // The next stage: kStageElems further along K.
        k += kStageElems;
        if constexpr (kGather == kVec16) {
          ci += kStageElems;
          while (ci >= g.Cin) {
            ci -= g.Cin;
            if (++kw == g.KW) {
              kw = 0;
              ++kh;
            }
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int BM, int BN, int kStages, bool kSeg, typename Acc, typename Epi>
__device__ __forceinline__ void consume(const Geom& g, uint32_t sA, uint32_t sB, uint32_t full,
                                        uint32_t empty, int wg, Epi& epi) {
  Acc acc[BN / 2];
  const int segments = kSeg ? g.segments : 1;
  int it = 0, ord = 0;
  for (int u = blockIdx.x; u < g.units; u += gridDim.x, ++ord) {
    Unit un = unit_of<BM, BN>(g, u, ord);
    for (int seg = 0; seg < segments; ++seg) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      fence_operands(acc);
      int prev = 0;
      for (int ks = 0; ks < g.k_stages; ++ks, ++it) {
        const int st = it % kStages;
        mbar_wait(full + 8 * st, (it / kStages) & 1);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // cp.async -> wgmma
        wgmma_fence();
        const uint64_t da = desc_sw128(sA + st * BM * kStageBytes + wg * 64 * kStageBytes);
        const uint64_t db = desc_sw128(sB + st * BN * kStageBytes);
#pragma unroll
        for (int kk = 0; kk < kStageBytes / 32; ++kk) wgmma(acc, da + 2 * kk, db + 2 * kk, 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's wgmmas are done with its tiles
        if (ks > 0) mbar_arrive(empty + 8 * prev);
        prev = st;
      }
      wgmma_wait<0>();
      fence_operands(acc);
      mbar_arrive(empty + 8 * prev);
      un.seg = seg;
      epi(acc, un);
    }
  }
}

// The whole kernel body: barriers, then the producer warpgroup (the last)
// and kWG consumer warpgroups. kExtraBytes of shared memory after the ring
// belong to the kernel: the producer calls pre(unit, t, extra) at the start
// of each unit (t: its thread, 0-127), the consumers epi(acc, unit, wg,
// extra) at the end of each of its segments. kRegs > 0: the consumers'
// registers a thread, taken from the producer's (which keeps 40).
template <int E, int kWG, int BN, int kGather, int kExtraBytes, typename Acc, int kRegs = 0,
          typename Epi, typename Pre>
__device__ __forceinline__ void run(const Geom& g, Epi& epi, Pre& pre) {
  constexpr int BM = 64 * kWG, kStages = stages_of<kWG, kGather>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sA = (raw + 1023) & ~1023u;
  const uint32_t sB = sA + kStages * BM * kStageBytes;
  const uint32_t extra_u32 = sB + kStages * BN * kStageBytes;
  const uint32_t full = extra_u32 + kExtraBytes, empty = full + 8 * kStages;
  uint8_t* extra = smem_raw + (extra_u32 - raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, kWgThreads * (kGather == kByte ? 2 : 1));
      mbar_init(empty + 8 * s, kWgThreads * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / kWgThreads;
  if (wg == kWG) {
    if constexpr (kRegs > 0) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    auto pre_t = [&](const Unit& un, int t) { pre(un, t, extra); };
    produce<E, BM, BN, kStages, kGather>(g, sA, sB, full, empty, threadIdx.x % kWgThreads, pre_t);
  } else {
    if constexpr (kRegs > 0)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs) : "memory");
    auto epi_wg = [&](const Acc (&acc)[BN / 2], const Unit& un) { epi(acc, un, wg, extra); };
    consume<BM, BN, kStages, kGather == kRows, Acc>(g, sA, sB, full, empty, wg, epi_wg);
  }
}

// Host: the grid of a persistent launch, min(units, resident blocks), and
// the attribute for dynamic shared memory over 48 KB; both once per kernel.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, int smem, int units, int* per_sm,
                            int* grid) {
  if (*per_sm < 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    *per_sm = n;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(*per_sm) * sms;
  *grid = static_cast<int>(units < slots ? units : slots);
  return cudaSuccess;
}

}  // namespace sm90
}  // namespace
