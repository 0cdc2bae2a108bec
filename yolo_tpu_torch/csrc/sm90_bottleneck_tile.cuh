// The Hopper (sm_90a) fused-bottleneck tile shared by the int8 bottleneck
// and stage chain (int8_bottleneck.cu: s8 k32, int32 sums) and the bf16 fused
// bottleneck (bf16_bottleneck.cu: bf16 k16, float32 sums), built from the
// barriers, copies, swizzle, descriptors and wgmma wrappers of
// sm90_conv_core.cuh. E is the element's bytes (1: s8, 2: bf16); a wgmma
// takes 32 bytes of K either way, so one routine serves both.
//
// One bottleneck on one output tile of TH x TW pixels of one image:
//   conv1 (1x1, Cin -> P) over the tile's one-pixel halo, (TH+2)(TW+2) rows
//         -> y1 in shared memory, set to 0 off the image (conv2 pads y1, not
//         x, and the epilogue of a zero row is not zero);
//   conv2 (3x3, pad 1, P -> P) over y1 -> y2 in shared memory;
//   conv3 (1x1, P -> C) over y2, plus the residual: x (the identity; a
//         chain's x was written by this launch, so it comes by cp.async.cg,
//         through L2) or the downsample product (1x1, Cin -> C over x's tile
//         rows), run as its own pass over the same tile and column range
//         just before, its results kept in registers;
// each product's epilogue is the kernel's policy (Pol).
//
// Warp roles (kThreads = 384): one producer warpgroup, kWG = 2 consumer
// warpgroups. The producer walks the same sequence of stages as the
// consumers, tile after tile, so the next tile's halo gather overlaps this
// tile's conv3, and fills a ring of 3-8 stages (as many as shared memory
// holds) with full/empty mbarriers:
//   * a stage holds 128 bytes of K (wgmma's 128-byte-swizzled K-major
//     layout, as the conv core's stages) for the A rows of conv1 or the
//     downsample (x's halo or tile pixels, 16-byte cp.async pieces,
//     zero-filled off the image, past the rows and past K) and for 128 rows
//     of packed weights (B: two 64-column halves; rows past Cout and bytes
//     past the packed row zero-filled);
//   * conv2 and conv3 have no A in the ring, so their weight rows fill the
//     whole stage, several steps of K a stage (packed()): the ring keeps as
//     many weight bytes in flight as it holds;
//   * each column range of conv3 first takes a staging stage: the producer
//     puts the identity residual's rows there, the consumers turn each
//     residual pair into its output pair in place and send the rows out
//     whole, 16 bytes a thread, so no epilogue load waits on device memory
//     and no store goes out two bytes at a time;
//   * the halo rows' x offsets are computed once a tile into a table in
//     shared memory that only the thread that wrote an entry reads, so a
//     stage costs the producer a load, a compare and a cp.async a row.
// The consumers split a product into items, (64-row block, 64-column half)
// pairs, item j to warpgroup j % kWG, at most kMaxItems = 2 a warpgroup, one
// 64 x 64 accumulator each (wgmma m64n64: s8 k32 / bf16 k16).
//
// conv2's A is the hard part: tap (kh, kw) reads y1 at row base + kh (TW+2)
// + kw, a shifted window, and a shifted window of a 128-byte-swizzled tile is
// not a valid wgmma descriptor. So conv2 and conv3 take A from registers
// (wgmma's register-A form, which both s8 and bf16 have), loaded with
// ldmatrix from y1 / y2 kept in a padded row layout (P E + 16 bytes a row:
// eight consecutive rows fall on eight different 16-byte bank groups), each
// lane pointing at its own row, so any tile width works. Two register sets
// alternate between steps of K: a step's ldmatrix runs while the previous
// step's wgmmas do. A K-chunk-major y1 with non-swizzled descriptors would
// need a tile width that is a multiple of 8 (no 7 x 7 tiles at layers 3-4);
// restaging each tap's A into a swizzled stage would cost a shared-memory
// copy of A per tap. conv1's and the downsample's A come through the ring
// with descriptors, as in the conv core.
//
// Registers: ptxas allocates the launch's cap for every thread (168 at 384
// threads; setmaxnreg moves registers at run time but not the compiled
// allocation). The accumulators take 64 and the A registers 16; the
// downsample's results wait in the staging stage and the epilogues load
// their per-column operands an item at a time, so that nothing spills (a
// spill of a few hundred bytes cost the int8 chain 20%).
//
// What bounds a tile: the tensor cores where it has many rows per weight
// byte, else the weights' stream from L2 (every tile streams the whole
// block's weights); plan() in serving/cuda_bottleneck.py weighs the two per
// geometry. The epilogues do not overlap the tensor cores (both consumer
// warpgroups run them at once), which PERF.md measures.
#pragma once

#include <type_traits>

#include "sm90_conv_core.cuh"

namespace {
namespace sm90 {
namespace btile {

constexpr int kWG = 2;                          // consumer warpgroups
constexpr int kThreads = kWgThreads * (kWG + 1);
constexpr int kHalf = 64;                       // columns of one item (wgmma N)
constexpr int kBRows = 2 * kHalf;               // weight rows a stage holds
constexpr int kMaxItems = 2;                    // items a consumer warpgroup
constexpr int kMaxBlocks = 4;                   // 64-row blocks of the halo or the tile
constexpr int kMinStages = 3, kMaxStages = 8;
constexpr int kMaxSmem = 232448;                // an H100's shared memory per block
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// The tiling of one launch (host-filled by make_tiling).
struct Tiling {
  int N, H, W, TH, TW;
  int tiles_w, per_image, ntiles;
  int m1, m2;    // halo rows (TH+2)(TW+2) and tile rows TH TW
  int m1b, m2b;  // their 64-row blocks
  int ldy;       // bytes of a y1 / y2 row: P E + 16
  int y1_bytes;  // y1's rows
  int stages;    // depth of the ring
  FastDiv f_per_image, f_tiles_w, f_hw2, f_tw;
};

// One bottleneck's packed weights: rows of K bytes (row strides kp*, zero
// past K), K in the order the consumers walk it ((kh, kw, c) for conv2).
struct Convs {
  const uint8_t *w1, *w2, *w3, *wd;  // wd: the downsample, or nullptr
  int cin, p, c;                     // channels
  int kp1, kp2, kp3, kpd;            // bytes of a packed row
};

// Columns a stage carries for a product of `cols` columns over `blocks`
// 64-row blocks: both halves where that keeps the items at 4 or fewer.
__host__ __device__ constexpr int halves(int cols, int blocks) {
  return cols % kBRows == 0 && blocks <= 2 ? 2 : 1;
}

// Shared memory, from a 1024-byte-aligned base: the ring, y1 (m1 rows), y2
// (m2b 64-row blocks, so that conv3's ldmatrix of a padding row stays
// inside), the producer's offset table (one int a halo row and producer
// thread: each thread keeps its own rows' entries), the barriers.
__host__ __device__ inline int stage_bytes(const Tiling& g) {
  return (g.m1b * 64 + kBRows) * kStageBytes;
}
__host__ __device__ inline int y1_offset(const Tiling& g) { return g.stages * stage_bytes(g); }
__host__ __device__ inline int y2_offset(const Tiling& g) { return y1_offset(g) + g.y1_bytes; }
__host__ __device__ inline int table_offset(const Tiling& g) {
  return y2_offset(g) + g.m2b * 64 * g.ldy;
}
__host__ __device__ inline int bars_offset(const Tiling& g) {
  return table_offset(g) + g.m1b * 64 / 16 * kWgThreads * 4;
}
__host__ __device__ inline int smem_bytes(const Tiling& g) {
  return 1024 + bars_offset(g) + 2 * 8 * g.stages;
}

// Fills g for a launch; false for what the routine does not take (more than
// kMaxBlocks row blocks, fewer than kMinStages stages in shared memory, a
// tensor of 2 GB or more: the producer's offsets are 32-bit).
inline bool make_tiling(Tiling& g, int E, int N, int H, int W, int cin, int c, int P, int TH,
                        int TW) {
  if (N <= 0 || H <= 0 || W <= 0 || TH <= 0 || TW <= 0 || P <= 0 || (P * E) % 32) return false;
  if (static_cast<long long>(N) * H * W * (cin > c ? cin : c) * E > 0x7fffffffLL) return false;
  g.N = N;
  g.H = H;
  g.W = W;
  g.TH = TH;
  g.TW = TW;
  g.tiles_w = (W + TW - 1) / TW;
  g.per_image = (H + TH - 1) / TH * g.tiles_w;
  const long long ntiles = static_cast<long long>(N) * g.per_image;
  if (ntiles > 0x7fffffff) return false;
  g.ntiles = static_cast<int>(ntiles);
  g.m1 = (TH + 2) * (TW + 2);
  g.m2 = TH * TW;
  g.m1b = (g.m1 + 63) / 64;
  g.m2b = (g.m2 + 63) / 64;
  if (g.m1b > kMaxBlocks || g.m2b > kMaxBlocks) return false;
  g.ldy = P * E + 16;
  g.y1_bytes = g.m1 * g.ldy;
  // conv3's staging stage holds the tile's rows of a column range
  if (g.m2b * 64 * (kHalf * halves(c, g.m2b) * E + 16) > stage_bytes(g)) return false;
  g.stages = 0;
  const int fixed = smem_bytes(g);  // everything but the stages' rings and barriers
  int s = (kMaxSmem - fixed) / (stage_bytes(g) + 16);
  g.stages = s < kMaxStages ? s : kMaxStages;
  if (g.stages < kMinStages) return false;
  g.f_per_image = fast_div(g.per_image);
  g.f_tiles_w = fast_div(g.tiles_w);
  g.f_hw2 = fast_div(TW + 2);
  g.f_tw = fast_div(TW);
  return true;
}

// The tile's image and corner.
struct Corner {
  int n, oh0, ow0;
};
__device__ __forceinline__ Corner corner(const Tiling& g, int tile) {
  const int n = tile / g.f_per_image, rem = tile - n * g.per_image;
  const int ty = rem / g.f_tiles_w;
  return {n, ty * g.TH, (rem - ty * g.tiles_w) * g.TW};
}

// The ring's position; producer and consumers each keep one and advance it
// in the same order.
struct Ring {
  uint32_t base, full, empty;
  int bytes, b_off, stages;
  int st = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ uint32_t a() const { return base + st * bytes; }
  __device__ __forceinline__ uint32_t b() const { return a() + b_off; }
  __device__ __forceinline__ void next() {
    if (++st == stages) {
      st = 0;
      phase ^= 1u;
    }
  }
};

__device__ __forceinline__ Ring make_ring(const Tiling& g, uint32_t base) {
  Ring r;
  r.base = base;
  r.bytes = stage_bytes(g);
  r.b_off = g.m1b * 64 * kStageBytes;
  r.stages = g.stages;
  r.full = base + bars_offset(g);
  r.empty = r.full + 8 * g.stages;
  return r;
}

// Steps of K a stage holds for a product whose A is not in the ring (conv2,
// conv3): its B rows (64 nh a step) fill the whole stage, A's rows included,
// so that these products keep as many weight bytes in flight as the ring
// holds.
__host__ __device__ inline int packed(const Tiling& g, int nh) {
  return (g.m1b * 64 + kBRows) / (kHalf * nh);
}

// Bytes of a row of conv3's staging stage: the tile's rows of one column
// range (nh halves), padded as y1's rows so that the accumulator layout's
// accesses spread over the banks.
template <int E>
__host__ __device__ constexpr int staging_row(int nh) {
  return kHalf * nh * E + 16;
}

// ------------------------------------------------------------ producer
// Thread t fills 16-byte chunk t % 8 of rows t / 8 + 16 i of every stage.
__device__ __forceinline__ void load_b(uint32_t dst, const uint8_t* w, int cols, int kp, int n0,
                                       int nh, int ks, int t) {
  const int c = t % 8, r0 = t / 8;
  const uint32_t swz = (c ^ (r0 % 8)) * 16;
  const int kb = ks * kStageBytes + c * 16;
#pragma unroll
  for (int i = 0; i < kBRows / 16; ++i) {
    if (i < 4 * nh) {
      const int row = r0 + 16 * i, n = n0 + row;
      const bool ok = n < cols && kb < kp;
      cp_async16(dst + row * kStageBytes + swz, w + (ok ? n * kp + kb : 0), ok);
    }
  }
}

template <int E>
__device__ __forceinline__ void produce_tile(const Tiling& g, const uint8_t* x, const Convs& cv,
                                             int tile, Ring& ring, int* table, int t) {
  const Corner k = corner(g, tile);
  const int c = t % 8, r0 = t / 8;
  const uint32_t swz = (c ^ (r0 % 8)) * 16;
  const int xrow = cv.cin * E, arows = g.m1b * 64;
  // x offsets of this thread's halo rows (-1: zero row), for conv1's stages.
  for (int i = 0; i < arows / 16; ++i) {
    const int r = r0 + 16 * i, hr = r / g.f_hw2;
    const int ph = k.oh0 - 1 + hr, pw = k.ow0 - 1 + (r - hr * (g.TW + 2));
    const bool in = r < g.m1 && static_cast<unsigned>(ph) < static_cast<unsigned>(g.H) &&
                    static_cast<unsigned>(pw) < static_cast<unsigned>(g.W);
    table[i * kWgThreads + t] = in ? ((k.n * g.H + ph) * g.W + pw) * xrow : -1;
  }
  auto acquire = [&]() { mbar_wait(ring.empty + 8 * ring.st, ring.phase ^ 1u); };
  auto commit = [&]() {
    cp_async_arrive(ring.full + 8 * ring.st);
    ring.next();
  };
  // conv1: halo rows of x and w1.
  const int nh1 = halves(cv.p, g.m1b), nk1 = (xrow + kStageBytes - 1) / kStageBytes;
  for (int n0 = 0; n0 < cv.p; n0 += kHalf * nh1) {
    for (int ks = 0; ks < nk1; ++ks) {
      acquire();
      const int kb = ks * kStageBytes + c * 16;
      for (int i = 0; i < arows / 16; ++i) {
        const int off = table[i * kWgThreads + t];
        const bool ok = off >= 0 && kb < xrow;
        cp_async16(ring.a() + (r0 + 16 * i) * kStageBytes + swz, x + (ok ? off + kb : 0), ok);
      }
      load_b(ring.b(), cv.w1, cv.p, cv.kp1, n0, nh1, ks, t);
      commit();
    }
  }
  // conv2: w2 only (A is y1, in shared memory), packed(nh) steps of K a stage.
  const int nh2 = halves(cv.p, g.m2b), nk2 = (9 * cv.p * E + kStageBytes - 1) / kStageBytes;
  for (int n0 = 0; n0 < cv.p; n0 += kHalf * nh2) {
    for (int ks = 0; ks < nk2;) {
      acquire();
      for (int sub = 0; sub < packed(g, nh2) && ks < nk2; ++sub, ++ks)
        load_b(ring.a() + sub * kHalf * nh2 * kStageBytes, cv.w2, cv.p, cv.kp2, n0, nh2, ks, t);
      commit();
    }
  }
  // conv3 a column range at a time: its staging stage (the identity
  // residual's rows of x, where there is no downsample), the downsample
  // pass (x's tile rows and wd), then w3.
  const int nh3 = halves(cv.c, g.m2b), nk3 = (cv.p * E + kStageBytes - 1) / kStageBytes;
  const int srow = staging_row<E>(nh3), ppr = kHalf * nh3 * E / 16;  // 16-byte pieces a row
  for (int n0 = 0; n0 < cv.c; n0 += kHalf * nh3) {
    acquire();
    if (cv.wd == nullptr) {
      for (int q = t; q < g.m2b * 64 * ppr; q += kWgThreads) {
        const int r = q / ppr, piece = q - r * ppr, tr = r / g.f_tw;
        const int oh = k.oh0 + tr, ow = k.ow0 + (r - tr * g.TW), cb = n0 * E + piece * 16;
        const bool ok = r < g.m2 && oh < g.H && ow < g.W && cb < xrow;
        cp_async16(ring.a() + r * srow + piece * 16,
                   x + (ok ? ((k.n * g.H + oh) * g.W + ow) * xrow + cb : 0), ok);
      }
    }
    commit();
    if (cv.wd != nullptr) {
      for (int ks = 0; ks < nk1; ++ks) {
        acquire();
        const int kb = ks * kStageBytes + c * 16;
        for (int i = 0; i < g.m2b * 4; ++i) {
          const int r = r0 + 16 * i, tr = r / g.f_tw;
          const int oh = k.oh0 + tr, ow = k.ow0 + (r - tr * g.TW);
          const bool ok = r < g.m2 && oh < g.H && ow < g.W && kb < xrow;
          cp_async16(ring.a() + r * kStageBytes + swz,
                     x + (ok ? ((k.n * g.H + oh) * g.W + ow) * xrow + kb : 0), ok);
        }
        load_b(ring.b(), cv.wd, cv.c, cv.kpd, n0, nh3, ks, t);
        commit();
      }
    }
    for (int ks = 0; ks < nk3;) {
      acquire();
      for (int sub = 0; sub < packed(g, nh3) && ks < nk3; ++sub, ++ks)
        load_b(ring.a() + sub * kHalf * nh3 * kStageBytes, cv.w3, cv.c, cv.kp3, n0, nh3, ks, t);
      commit();
    }
  }
}

// ------------------------------------------------------------ consumers
template <int E>
struct AccOf;
template <>
struct AccOf<1> {
  using type = int;
};
template <>
struct AccOf<2> {
  using type = float;
};

// Item slot it of warpgroup wg: its row block and column half (the slot
// holds an item where it < items_of(wg, items)).
struct Item {
  int mb, half;
};
__device__ __forceinline__ Item item_of(int wg, int it, int nh) {
  const int j = wg + kWG * it;
  return {nh == 2 ? j >> 1 : j, nh == 2 ? j & 1 : 0};
}

// Waits for the ring's next stage and makes its cp.async bytes visible to wgmma.
__device__ __forceinline__ void wait_full(const Ring& ring) {
  mbar_wait(ring.full + 8 * ring.st, ring.phase);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One stage's wgmmas for NI items and NK 32-byte steps of K, as one
// straight run between wgmma_fence and the commit: ptxas serializes every
// wgmma of a kernel where one sits on a branch of its own (it then inserts
// the fence itself, on a path it cannot prove uniform), so the item and K
// counts are template arguments, chosen by dispatch() before the fence.
// A from shared memory (descriptors da).
template <int NI, int NK, typename Acc>
__device__ __forceinline__ void issue(Acc (&acc)[kMaxItems][32], const uint64_t (&da)[kMaxItems],
                                      const uint64_t (&db)[kMaxItems]) {
  wgmma_fence();
#pragma unroll
  for (int it = 0; it < NI; ++it)
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) wgmma(acc[it], da[it] + 2 * kk, db[it] + 2 * kk, 1);
  wgmma_commit();
}

template <int V>
using Int = std::integral_constant<int, V>;

// How many of a product's `items` fall to warpgroup wg (its first slots).
__device__ __forceinline__ int items_of(int wg, int items) {
  return (items - wg + kWG - 1) / kWG < kMaxItems ? (items - wg + kWG - 1) / kWG : kMaxItems;
}

template <typename Acc>
__device__ __forceinline__ void zero(Acc (&acc)[kMaxItems][32]) {
#pragma unroll
  for (int it = 0; it < kMaxItems; ++it)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[it][i] = 0;
#pragma unroll
  for (int it = 0; it < kMaxItems; ++it) fence_operands(acc[it]);
}

// body(Int<NI>, Int<NK>) for ni items (0-2) and nk steps of K (1-kMaxK).
template <int kMaxK, typename Body>
__device__ __forceinline__ void dispatch(int ni, int nk, Body&& body) {
  if (ni == 0) {
    body(Int<0>{}, Int<1>{});
    return;
  }
  auto steps = [&](auto n_items) {
    if constexpr (kMaxK >= 4) {
      if (nk >= 4) return body(n_items, Int<4>{});
      if (nk == 3) return body(n_items, Int<3>{});
      if (nk == 2) return body(n_items, Int<2>{});
    }
    body(n_items, Int<1>{});
  };
  if (ni == 1) {
    steps(Int<1>{});
  } else {
    steps(Int<2>{});
  }
}

// A from the ring (conv1, downsample): `nk` stages, K bytes `kbytes`.
template <typename Acc>
__device__ __forceinline__ void mainloop_ss(Acc (&acc)[kMaxItems][32], Ring& ring, int nk,
                                            int kbytes, int items, int nh, int wg) {
  zero(acc);
  const int ni = items_of(wg, items);
  int prev = 0;
  for (int ks = 0; ks < nk; ++ks) {
    wait_full(ring);
    uint64_t da[kMaxItems], db[kMaxItems];
#pragma unroll
    for (int it = 0; it < kMaxItems; ++it) {
      const Item m = item_of(wg, it, nh);
      da[it] = desc_sw128(ring.a() + m.mb * 64 * kStageBytes);
      db[it] = desc_sw128(ring.b() + m.half * kHalf * kStageBytes);
    }
    const int steps = (kbytes - ks * kStageBytes + 31) / 32;
    dispatch<kStageBytes / 32>(ni, steps, [&](auto n_items, auto n_steps) {
      issue<decltype(n_items)::value, decltype(n_steps)::value>(acc, da, db);
    });
    wgmma_wait<1>();  // the previous stage's wgmmas are done with it
    if (ks > 0) mbar_arrive(ring.empty + 8 * prev);
    prev = ring.st;
    ring.next();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int it = 0; it < kMaxItems; ++it) fence_operands(acc[it]);
  mbar_arrive(ring.empty + 8 * prev);
}

// A wgmma reads its register A operand until a wgmma_wait covers it: this
// keeps the registers' values (and so their allocation) alive up to here.
__device__ __forceinline__ void keep_until_here(uint32_t (&f)[kMaxItems][4]) {
#pragma unroll
  for (int it = 0; it < kMaxItems; ++it)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[it][i])::"memory");
}

// The wgmmas of one 32-byte step of K for NI items, A from registers, as
// one straight run between wgmma_fence and the commit (see issue()).
template <int NI, typename Acc>
__device__ __forceinline__ void issue_step(Acc (&acc)[kMaxItems][32],
                                           const uint32_t (&f)[kMaxItems][4],
                                           const uint64_t (&db)[kMaxItems]) {
  wgmma_fence();
#pragma unroll
  for (int it = 0; it < NI; ++it) wgmma(acc[it], f[it], db[it], 1);
  wgmma_commit();
}

// A from registers (conv2 over y1, conv3 over y2): rows[it] is the shared
// address of this lane's A row of item it (row l % 16 of its warp's 16,
// byte 16 (l / 16)); step() returns the byte offset of the next 32 bytes of
// K from a row and advances, once per 32 bytes of K in order. Each 32 bytes
// of K is one wgmma group whose A (4 registers an item) ldmatrix loads while
// the group before runs: two such register sets alternate, 16 registers in
// all, which the launch's register cap leaves room for beside the
// accumulators. A ring stage holds `per_stage` steps of 128 bytes of K of B
// (packed()); it is released once the wgmmas of its last step are done.
template <typename Acc, typename Step>
__device__ __forceinline__ void mainloop_rs(Acc (&acc)[kMaxItems][32], Ring& ring, int nk,
                                            int kbytes, int items, int nh, int wg,
                                            const uint32_t (&rows)[kMaxItems], Step& step,
                                            int per_stage) {
  uint32_t frag[2][kMaxItems][4];
  zero(acc);
  const int ni = items_of(wg, items);
  int pending = -1;  // the stage whose last step the previous wgmma group read
  int sub = 0;       // this 128-byte step's place in its stage
  for (int ks = 0; ks < nk; ++ks) {
    if (sub == 0) wait_full(ring);
    const int steps = (kbytes - ks * kStageBytes + 31) / 32;
    const uint32_t b = ring.a() + sub * kHalf * nh * kStageBytes;
    uint64_t db[kMaxItems];
#pragma unroll
    for (int it = 0; it < kMaxItems; ++it)
      db[it] = desc_sw128(b + item_of(wg, it, nh).half * kHalf * kStageBytes);
    const bool last = ++sub == per_stage || ks + 1 == nk;
#pragma unroll
    for (int kk = 0; kk < kStageBytes / 32; ++kk) {
      if (kk < steps) {
        uint32_t(&f)[kMaxItems][4] = frag[kk & 1];
        const uint32_t off = step();
#pragma unroll
        for (int it = 0; it < kMaxItems; ++it)
          if (it < ni) ldmatrix_x4(f[it], rows[it] + off);
        uint64_t d[kMaxItems];
#pragma unroll
        for (int it = 0; it < kMaxItems; ++it) d[it] = db[it] + 2 * kk;
        dispatch<1>(ni, 1, [&](auto n_items, auto) { issue_step<decltype(n_items)::value>(acc, f, d); });
        wgmma_wait<1>();
        keep_until_here(frag[(kk & 1) ^ 1]);  // the group before read it until the wait
        if (pending >= 0) {
          mbar_arrive(ring.empty + 8 * pending);
          pending = -1;
        }
      }
    }
    if (last) {
      sub = 0;
      pending = ring.st;
      ring.next();
    }
  }
  wgmma_wait<0>();
  keep_until_here(frag[0]);
  keep_until_here(frag[1]);
#pragma unroll
  for (int it = 0; it < kMaxItems; ++it) fence_operands(acc[it]);
  mbar_arrive(ring.empty + 8 * pending);
}

// Barrier of the consumer warpgroups (y1 or y2 complete).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWgThreads * kWG) : "memory");
}

// Shared-memory accesses by 32-bit address, in explicit state spaces (a
// generic store would keep the compiler from hoisting the epilogue's global
// loads above it).
template <int E>
__device__ __forceinline__ void st_pair(uint32_t addr, uint32_t v) {
  if constexpr (E == 1) {
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(static_cast<uint16_t>(v)));
  } else {
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v));
  }
}

template <int E>
__device__ __forceinline__ uint32_t ld_pair(uint32_t addr) {
  if constexpr (E == 1) {
    uint16_t v;
    asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
    return v;
  } else {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
    return v;
  }
}

__device__ __forceinline__ uint4 ld16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// Barrier of one consumer warpgroup (its part of the staging stage).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(3 + wg), "n"(kWgThreads) : "memory");
}

// The epilogue's per-column operands of this thread's 16 columns of an
// item, loaded together before they are used: K selects the product (1:
// conv1, 2: conv2, 3: conv3, 4: the downsample).
template <int K, typename Pol>
__device__ __forceinline__ void load_params(typename Pol::P (&prm)[16], const Pol& pol, int c0,
                                            int cols) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + 8 * j + 2 * (lane % 4) + e;
      prm[2 * j + e] = pol.template param<K>(col < cols ? col : 0);
    }
}

// The consumers' part of one bottleneck on one tile. Accumulator i of an
// item: row 16 w + l / 4 + 8 ((i / 2) % 2) of its block, column 8 (i / 4) +
// 2 (l % 4) + i % 2 of its half (w: the thread's warp in its warpgroup).
// Pol supplies the epilogues on a pair of neighbouring columns, packed as
// 2 E bytes, from their per-column operands (Pol::P, param<K>(col)):
// y(..) for y1 and y2, ds(..) for the downsample's result (int8 only) and
// out(.., res) with res the residual pair's bytes. conv3's column range
// leaves through its staging stage of the ring: the residual is there (the
// producer put x's rows there, or this thread wrote the downsample's
// results there); each thread turns its residual pairs into output pairs
// in place, and the rows go out whole, 16 bytes a thread.
template <int E, typename Pol>
__device__ __forceinline__ void consume_tile(const Tiling& g, uint8_t* out, const Convs& cv,
                                             const Pol& pol, int tile, Ring& ring, uint8_t* y1,
                                             uint8_t* y2, int wg) {
  using Acc = typename AccOf<E>::type;
  using P = typename Pol::P;
  const Corner k = corner(g, tile);
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4, t = threadIdx.x % kWgThreads;
  const int rl = 16 * warp + lane / 4;  // the thread's first accumulator row in a block
  const int xrow = cv.cin * E, orow = cv.c * E;
  const uint32_t y1s = smem_u32(y1), y2s = smem_u32(y2);
  const int lane_row = 16 * warp + lane % 16, lane_byte = 16 * (lane / 16);
  Acc acc[kMaxItems][32];
  P prm[16];

  // ---- conv1 over the halo -> y1 (0 off the image).
  {
    const int nh = halves(cv.p, g.m1b), items = g.m1b * nh, ni = items_of(wg, items);
    const int nk = (xrow + kStageBytes - 1) / kStageBytes;
    for (int n0 = 0; n0 < cv.p; n0 += kHalf * nh) {
      mainloop_ss(acc, ring, nk, xrow, items, nh, wg);
#pragma unroll
      for (int it = 0; it < kMaxItems; ++it) {
        const Item m = item_of(wg, it, nh);
        if (it >= ni) continue;
        load_params<1>(prm, pol, n0 + m.half * kHalf, cv.p);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m.mb * 64 + rl + 8 * h;
          if (r >= g.m1) continue;
          const int hr = r / g.f_hw2;
          const int ph = k.oh0 - 1 + hr, pw = k.ow0 - 1 + (r - hr * (g.TW + 2));
          const bool in = static_cast<unsigned>(ph) < static_cast<unsigned>(g.H) &&
                          static_cast<unsigned>(pw) < static_cast<unsigned>(g.W);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = n0 + m.half * kHalf + 8 * j + 2 * (lane % 4);
            if (col >= cv.p) continue;  // P is even: col + 1 < P too
            const uint32_t v = in ? pol.y(acc[it][4 * j + 2 * h], acc[it][4 * j + 2 * h + 1],
                                          prm[2 * j], prm[2 * j + 1])
                                  : 0u;
            st_pair<E>(y1s + r * g.ldy + col * E, v);
          }
        }
      }
    }
  }
  consumers_sync();  // y1 is complete

  // ---- conv2 (3x3 over y1, A from registers) -> y2.
  {
    const int nh = halves(cv.p, g.m2b), items = g.m2b * nh, ni = items_of(wg, items);
    const int nk = (9 * cv.p * E + kStageBytes - 1) / kStageBytes;
    uint32_t rows[kMaxItems];
#pragma unroll
    for (int it = 0; it < kMaxItems; ++it) {
      int r = item_of(wg, it, nh).mb * 64 + lane_row;
      r = r < g.m2 ? r : 0;  // padding rows read tap (0, 0) of pixel 0
      const int tr = r / g.f_tw;
      rows[it] = y1s + (tr * (g.TW + 2) + (r - tr * g.TW)) * g.ldy + lane_byte;
    }
    const int pe = cv.p * E, kw_step = g.ldy, kh_step = g.TW * g.ldy;
    for (int n0 = 0; n0 < cv.p; n0 += kHalf * nh) {
      // K runs (kh, kw, c): 32 bytes of one tap a step (P E % 32 == 0).
      int ci = 0, kw = 0;
      uint32_t tap = 0;  // the tap's row offset in bytes
      auto step = [&]() {
        const uint32_t off = tap + ci;
        ci += 32;
        if (ci == pe) {
          ci = 0;
          if (++kw == 3) {
            kw = 0;
            tap += kh_step;  // next row of taps: (TW + 2) - 2 rows on
          } else {
            tap += kw_step;
          }
        }
        return off;
      };
      mainloop_rs(acc, ring, nk, 9 * pe, items, nh, wg, rows, step, packed(g, nh));
#pragma unroll
      for (int it = 0; it < kMaxItems; ++it) {
        const Item m = item_of(wg, it, nh);
        if (it >= ni) continue;
        load_params<2>(prm, pol, n0 + m.half * kHalf, cv.p);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m.mb * 64 + rl + 8 * h;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = n0 + m.half * kHalf + 8 * j + 2 * (lane % 4);
            if (col >= cv.p) continue;
            st_pair<E>(y2s + r * g.ldy + col * E,
                       pol.y(acc[it][4 * j + 2 * h], acc[it][4 * j + 2 * h + 1], prm[2 * j],
                             prm[2 * j + 1]));
          }
        }
      }
    }
  }
  consumers_sync();  // y2 is complete

  // ---- conv3 (over y2, A from registers) + residual -> out, by the staging stage.
  {
    const int nh = halves(cv.c, g.m2b), items = g.m2b * nh, ni = items_of(wg, items);
    const int nk = (cv.p * E + kStageBytes - 1) / kStageBytes;
    const int srow = staging_row<E>(nh);
    constexpr int kTpr = kHalf * E / 16;     // threads a row of an item (16 bytes each)
    constexpr int kRpp = kWgThreads / kTpr;  // rows a pass
    uint32_t rows[kMaxItems];
#pragma unroll
    for (int it = 0; it < kMaxItems; ++it)
      rows[it] = y2s + (item_of(wg, it, nh).mb * 64 + lane_row) * g.ldy + lane_byte;
    for (int n0 = 0; n0 < cv.c; n0 += kHalf * nh) {
      wait_full(ring);  // the staging stage (with the identity residual)
      const uint32_t stg = ring.a();
      const int stg_stage = ring.st;
      ring.next();
      if (cv.wd != nullptr) {  // the downsample pass over x's tile rows, its
        // results into the staging stage where the identity residual would be
        mainloop_ss(acc, ring, (xrow + kStageBytes - 1) / kStageBytes, xrow, items, nh, wg);
#pragma unroll
        for (int it = 0; it < kMaxItems; ++it) {
          const Item m = item_of(wg, it, nh);
          if (it >= ni) continue;
          load_params<4>(prm, pol, n0 + m.half * kHalf, cv.c);
          const uint32_t a0 =
              stg + (m.mb * 64 + rl) * srow + (m.half * kHalf + 2 * (lane % 4)) * E;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              st_pair<E>(a0 + 8 * h * srow + 8 * j * E,
                         pol.ds(acc[it][4 * j + 2 * h], acc[it][4 * j + 2 * h + 1], prm[2 * j],
                                prm[2 * j + 1]));
        }
      }
      int kb = 0;
      auto step = [&]() {
        const uint32_t off = kb;
        kb += 32;
        return off;
      };
      mainloop_rs(acc, ring, nk, cv.p * E, items, nh, wg, rows, step, packed(g, nh));
#pragma unroll
      for (int it = 0; it < kMaxItems; ++it) {
        const Item m = item_of(wg, it, nh);
        if (it >= ni) continue;
        load_params<3>(prm, pol, n0 + m.half * kHalf, cv.c);
        // All of the item's residual pairs (x, or the downsample's results,
        // which this thread wrote) are read before any output pair is
        // written (one shared-memory latency, not one a pair).
        const uint32_t a0 = stg + (m.mb * 64 + rl) * srow + (m.half * kHalf + 2 * (lane % 4)) * E;
        uint32_t r[2][8];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            r[h][j] = ld_pair<E>(a0 + 8 * h * srow + 8 * j * E);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            st_pair<E>(a0 + 8 * h * srow + 8 * j * E,
                       pol.out(acc[it][4 * j + 2 * h], acc[it][4 * j + 2 * h + 1], prm[2 * j],
                               prm[2 * j + 1], r[h][j]));
      }
      warpgroup_sync(wg);  // this warpgroup's items are in the staging stage
#pragma unroll
      for (int it = 0; it < kMaxItems; ++it) {
        const Item m = item_of(wg, it, nh);
        if (it >= ni) continue;
        const int col = n0 + m.half * kHalf + (t % kTpr) * 16 / E;
        uint4 v[64 / kRpp];  // the item's rows of this thread, read before any is stored
#pragma unroll
        for (int ps = 0; ps < 64 / kRpp; ++ps)
          v[ps] = ld16(stg + (m.mb * 64 + t / kTpr + kRpp * ps) * srow + (m.half * kHalf) * E +
                       (t % kTpr) * 16);
#pragma unroll
        for (int ps = 0; ps < 64 / kRpp; ++ps) {
          const int r = m.mb * 64 + t / kTpr + kRpp * ps, tr = r / g.f_tw;
          const int oh = k.oh0 + tr, ow = k.ow0 + (r - tr * g.TW);
          if (r < g.m2 && oh < g.H && ow < g.W && col < cv.c)
            *reinterpret_cast<uint4*>(out + ((k.n * g.H + oh) * g.W + ow) *
                                                static_cast<long long>(orow) +
                                      col * E) = v[ps];
        }
      }
      mbar_arrive(ring.empty + 8 * stg_stage);
    }
  }
}

// Barrier init (thread 0) before the role split; the caller syncs the block.
__device__ __forceinline__ void init_ring(const Ring& ring) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.stages; ++s) {
      mbar_init(ring.full + 8 * s, kWgThreads);
      mbar_init(ring.empty + 8 * s, kWgThreads * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Host: the persistent grid of a launch of `kernel` at `smem` bytes,
// min(tiles, resident blocks); `cooperative` launches use the same count
// (every block must be resident at once for the grid barrier).
template <typename Kernel>
cudaError_t grid_of(Kernel kernel, int smem, int tiles, int* grid) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long slots = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<int>(tiles < slots ? tiles : slots);
  return cudaSuccess;
}

}  // namespace btile
}  // namespace sm90
}  // namespace
