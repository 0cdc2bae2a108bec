// int8 fused bottleneck blocks for Hopper (sm_90a): one identity bottleneck
// per launch (yolo_int8_bottleneck) and a stage's whole run of stride-1
// bottlenecks in one launch (yolo_int8_chain).
//
// Replaces the TPU kernels of yolo_tpu/serving/pallas_int8.py:
//   _fused_identity_bottleneck_kernel (entry fused_identity_bottleneck_int8)
//   _chain_kernel (entry fused_identity_chain_int8)
// and computes, per block, what yolo_tpu/serving/engine.py::_block_xla does:
//   y1  = q(relu(conv1x1(x, w1) * m1 + t1))                     C -> P
//   y2  = q(relu(conv3x3(y1, w2, pad 1) * m2 + t2))             P -> P
//   out = q(relu(conv1x1(y2, w3) * m3 + t3 + res * r))          P -> C
// with res = x and r = rx for an identity block, and for a first block that
// carries a stride-1 downsample projection (layer1's block 0)
//   res = q(conv1x1(x, wd) * md + td) (rounded to int8 at its own scale,
//   no ReLU) and r = ds_rescale.
// Every step rounds as int8_common.cuh's requant does, so both kernels equal
// the chained eager twin (engine._block with a float64 conv) bit for bit.
//
// One device routine, bottleneck_tile, computes a block on one output tile
// of TH x TW pixels of one image; yolo_int8_bottleneck runs it once per
// tile, yolo_int8_chain NB times per tile with a grid-wide barrier between
// blocks. Inside a tile, y1 (over the tile's one-pixel halo) and y2 never
// leave shared memory:
//   * conv1 runs over the (TH+2) x (TW+2) halo window: its rows are the x
//     pixels, gathered 64 bytes of K at a time with 16-byte cp.async
//     (zero-filled off the image). y1 is then set to 0 off the image: conv2
//     pads its input y1 with zeros, and q(relu(t1)) != 0 there;
//   * conv2 reads its im2col rows straight from y1 in shared memory (K =
//     9P ordered (kh, kw, ci), the order of the packed weights);
//   * conv3 reads y2 from shared memory; its epilogue adds the residual,
//     read from device memory (L2), or the downsample product, a second
//     accumulator over x computed beside it.
// Each product streams its packed weights (Cout, K) through two cp.async
// stages of 64 output channels x 64 bytes of K, 8 warps of
// mma.sync.m16n8k32 s8 (2 across rows x 4 across 64 columns).
//
// The chain: the TPU kernel kept a whole stage image in VMEM; no stage image
// fits in an SM's 227 KB (PERF.md weighs halo recompute and clusters
// against this). So the chain is one cooperative launch of as many resident
// blocks as the card holds; they walk the tiles of block b, meet at a grid
// barrier, and walk block b+1, ping-ponging the activations between `out`
// and `tmp` in device memory (the 50 MB L2 holds a stage of a small batch).
// Reads of data that this launch wrote go through L2 (cp.async.cg,
// ld.global.cg), never L1.
//
// What bounds it: the int8 tensor cores (1,979 dense TOPS on an H100 SXM)
// for the convs; a block moves its input and output once and its weights
// once per tile, from L2. Simple first: no wgmma, no TMA, a two-stage
// pipeline, conv1 recomputed on the halo (up to 2.6x conv1's work at 7x7
// tiles), and the M padding of 100/81 halo rows to 128 and 49 tile pixels
// to 64.

#include <cuda_runtime.h>

#include <cstdint>

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 256;       // 8 warps
constexpr int kBK = 64;             // K bytes per pipeline stage
constexpr int kRow = kBK + 16;      // staged row stride in bytes (bank spread)
constexpr int kBN = 64;             // output channels per column chunk
constexpr int kWN = 4;              // warps across a chunk's columns (2 across rows)
constexpr int kNI = kBN / kWN / 8;  // 8-column mma tiles per warp
constexpr int kHaloRows = 128;      // conv1 rows: (TH + 2) * (TW + 2) <= 128
constexpr int kTileRows = 64;       // conv2 / conv3 rows: TH * TW <= 64
constexpr int kMaxBlocks = 8;       // bottlenecks in one chain
constexpr int kStageA = kHaloRows * kRow;
constexpr int kStageB = kBN * kRow;
constexpr int kStageBytes = 2 * kStageA + 2 * kStageB;
constexpr int kMaxSmem = 232448;    // an H100's shared memory per block
constexpr int kPtrsPerBlock = 13;   // the C interface's pointers per block

struct BlockParams {
  const int8_t* w1;  // (P, Cin), K contiguous
  const int8_t* w2;  // (P, 9P), K = (kh, kw, ci)
  const int8_t* w3;  // (C, P)
  const int8_t* wd;  // (C, Cin), or nullptr: an identity block
  const float *m1, *t1, *m2, *t2, *m3, *t3, *md, *td;
  const float* r;    // rx, or ds_rescale where wd is set
};

struct Geometry {
  int H, W, Cin, C, P, TH, TW, tiles_w, per_image, ntiles, ldy;
};

struct ChainArgs {
  BlockParams blocks[kMaxBlocks];
  int nb;
  const int8_t* x;
  int8_t* out;
  int8_t* tmp;
  unsigned* barrier;
};

struct Smem {
  int8_t* a;   // two stages of gathered x rows
  int8_t* b;   // two stages of weight rows
  int8_t* y1;  // (TH+2)(TW+2) rows of P channels, stride ldy
  int8_t* y2;  // kTileRows rows of P channels, stride ldy
};

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ Smem carve(int8_t* base, const Geometry& geo) {
  Smem s;
  s.a = base;
  s.b = base + 2 * kStageA;
  s.y1 = base + kStageBytes;
  s.y2 = s.y1 + (geo.TH + 2) * (geo.TW + 2) * geo.ldy;
  return s;
}

// Block-wide product of one 64-column chunk: acc = A (MI*32 rows x nk*64 K)
// times rows n0 .. n0+63 of w (row stride ldw, K contiguous). The weight
// rows stream through two cp.async stages; load_a(kt, stage) stages A's K
// chunk kt beside them (or does nothing where A lies in shared memory).
// a_ptr(kt, stage, i, h, k) is the shared address of A's byte k of K chunk
// kt in row g + 8h of this warp's m-tile i.
template <int MI, class LoadA, class APtr>
__device__ __forceinline__ void gemm(int (&acc)[MI][kNI][4], int nk, const int8_t* w, int ldw,
                                     int n0, const Smem& sm, LoadA load_a, APtr a_ptr) {
  const int tid = threadIdx.x, lane = tid % 32, warp_n = (tid / 32) % kWN;
  const int g = lane / 4, tg = lane % 4;
  const int brow = tid / 4, bcol = (tid % 4) * 16;  // one 16-byte weight copy per stage
  const int8_t* wsrc = w + static_cast<long long>(n0 + brow) * ldw + bcol;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load_a(0, 0);
  cp_async16(sm.b + brow * kRow + bcol, wsrc, true);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    cp_async_wait_all();
    __syncthreads();  // stage kt is in shared memory; everyone is done with stage kt-1
    if (kt + 1 < nk) {
      load_a(kt + 1, st ^ 1);
      cp_async16(sm.b + (st ^ 1) * kStageB + brow * kRow + bcol, wsrc + (kt + 1) * kBK, true);
      cp_async_commit();
    }
    const int8_t* bs = sm.b + st * kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned af[MI][4], bf[kNI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* p0 = a_ptr(kt, st, i, 0, kk + tg * 4);
        const int8_t* p1 = a_ptr(kt, st, i, 1, kk + tg * 4);
        af[i][0] = ld32(p0);
        af[i][1] = ld32(p1);
        af[i][2] = ld32(p0 + 16);
        af[i][3] = ld32(p1 + 16);
      }
#pragma unroll
      for (int j = 0; j < kNI; ++j) {
        const int8_t* p = bs + (warp_n * (kNI * 8) + j * 8 + g) * kRow + kk + tg * 4;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j)
          mma_s8(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], bf[j][0], bf[j][1]);
    }
  }
  __syncthreads();  // both stages are free again for the next product
}

// One bottleneck block on output tile `tile` (image-major, then tile rows,
// then tile columns): x (N, H, W, cin) -> out (N, H, W, C), int8 NHWC.
// Accumulator element e of mma tile (i, j) is row g (+8 for e >= 2) and
// column 2*tg (+1 for odd e) of that tile.
__device__ __forceinline__ void bottleneck_tile(const int8_t* x, int8_t* out,
                                                const BlockParams& bp, const Geometry& geo,
                                                int cin, int tile, const Smem& sm) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int warp_m = warp / kWN, warp_n = warp % kWN;
  const int H = geo.H, W = geo.W, TH = geo.TH, TW = geo.TW, P = geo.P, C = geo.C;
  const int ldy = geo.ldy;
  const int n = tile / geo.per_image, t = tile - n * geo.per_image;
  const int oh0 = t / geo.tiles_w * TH, ow0 = (t % geo.tiles_w) * TW;
  const int HW2 = TW + 2, M1 = (TH + 2) * HW2, M2 = TH * TW;
  const long long img = static_cast<long long>(n) * H * W;
  const int chunk = (tid % 4) * 16;
  auto no_load = [](int, int) {};
  auto col_of = [&](int n0, int j) { return n0 + warp_n * (kNI * 8) + j * 8 + tg * 2; };

  // ---- conv1 (1x1, cin -> P) over the halo window -> y1.
  {
    long long off[2];  // this thread's two gathered rows: x offset, or -1 (zero row)
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int r = tid / 4 + l * 64;
      const int ph = oh0 - 1 + r / HW2, pw = ow0 - 1 + r % HW2;
      const bool in = r < M1 && ph >= 0 && ph < H && pw >= 0 && pw < W;
      off[l] = in ? (img + static_cast<long long>(ph) * W + pw) * cin + chunk : -1;
    }
    auto load_a = [&](int kt, int st) {
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const bool ok = off[l] >= 0;
        cp_async16(sm.a + st * kStageA + (tid / 4 + l * 64) * kRow + chunk,
                   ok ? x + off[l] + kt * kBK : x, ok);
      }
    };
    auto a_ptr = [&](int, int st, int i, int h, int k) {
      return sm.a + st * kStageA + (warp_m * 64 + i * 16 + g + 8 * h) * kRow + k;
    };
    for (int n0 = 0; n0 < P; n0 += kBN) {
      int acc[4][kNI][4];
      gemm<4>(acc, cin / kBK, bp.w1, cin, n0, sm, load_a, a_ptr);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp_m * 64 + i * 16 + g + 8 * h;
          if (r >= M1) continue;
          const int ph = oh0 - 1 + r / HW2, pw = ow0 - 1 + r % HW2;
          const bool in = ph >= 0 && ph < H && pw >= 0 && pw < W;
#pragma unroll
          for (int j = 0; j < kNI; ++j) {
            const int col = col_of(n0, j);
            int8_t q0 = 0, q1 = 0;  // zero padding of conv2's input, off the image
            if (in) {
              q0 = requant(acc[i][j][2 * h], bp.m1[col], bp.t1[col], kRelu, 0.0f, 0.0f);
              q1 = requant(acc[i][j][2 * h + 1], bp.m1[col + 1], bp.t1[col + 1], kRelu, 0.0f,
                           0.0f);
            }
            *reinterpret_cast<uint16_t*>(sm.y1 + r * ldy + col) = pack2(q0, q1);
          }
        }
      }
    }
  }
  __syncthreads();  // y1 is complete

  // ---- conv2 (3x3, pad 1, P -> P) over y1 in shared memory -> y2.
  {
    int base[2][2];  // y1 row of tap (0, 0) for this thread's rows (padding rows: row 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r = warp_m * 32 + i * 16 + g + 8 * h;
        r = r < M2 ? r : 0;
        base[i][h] = r / TW * HW2 + r % TW;
      }
    auto a_ptr = [&](int kt, int, int i, int h, int k) {
      const int k0 = kt * kBK, tap = k0 / P, ci = k0 - tap * P;  // P % 64 == 0
      return sm.y1 + (base[i][h] + tap / 3 * HW2 + tap % 3) * ldy + ci + k;
    };
    for (int n0 = 0; n0 < P; n0 += kBN) {
      int acc[2][kNI][4];
      gemm<2>(acc, 9 * P / kBK, bp.w2, 9 * P, n0, sm, no_load, a_ptr);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp_m * 32 + i * 16 + g + 8 * h;
#pragma unroll
          for (int j = 0; j < kNI; ++j) {
            const int col = col_of(n0, j);
            const int8_t q0 =
                requant(acc[i][j][2 * h], bp.m2[col], bp.t2[col], kRelu, 0.0f, 0.0f);
            const int8_t q1 =
                requant(acc[i][j][2 * h + 1], bp.m2[col + 1], bp.t2[col + 1], kRelu, 0.0f, 0.0f);
            *reinterpret_cast<uint16_t*>(sm.y2 + r * ldy + col) = pack2(q0, q1);
          }
        }
    }
  }
  __syncthreads();  // y2 is complete

  // ---- conv3 (1x1, P -> C) + residual (or the downsample branch) -> out.
  {
    long long off = -1;  // gathered x row of this thread's tile pixel (downsample only)
    {
      const int r = tid / 4;
      const int oh = oh0 + r / TW, ow = ow0 + r % TW;
      if (r < M2 && oh < H && ow < W) off = (img + static_cast<long long>(oh) * W + ow) * cin + chunk;
    }
    auto load_x = [&](int kt, int st) {
      const bool ok = off >= 0;
      cp_async16(sm.a + st * kStageA + (tid / 4) * kRow + chunk, ok ? x + off + kt * kBK : x, ok);
    };
    auto x_ptr = [&](int, int st, int i, int h, int k) {
      return sm.a + st * kStageA + (warp_m * 32 + i * 16 + g + 8 * h) * kRow + k;
    };
    auto y2_ptr = [&](int kt, int, int i, int h, int k) {
      return sm.y2 + (warp_m * 32 + i * 16 + g + 8 * h) * ldy + kt * kBK + k;
    };
    const float rs = *bp.r;
    const bool ds = bp.wd != nullptr;
    for (int n0 = 0; n0 < C; n0 += kBN) {
      int acc[2][kNI][4], dacc[2][kNI][4];
      gemm<2>(acc, P / kBK, bp.w3, P, n0, sm, no_load, y2_ptr);
      if (ds) gemm<2>(dacc, cin / kBK, bp.wd, cin, n0, sm, load_x, x_ptr);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp_m * 32 + i * 16 + g + 8 * h;
          const int oh = oh0 + r / TW, ow = ow0 + r % TW;
          if (r >= M2 || oh >= H || ow >= W) continue;
          const long long pix = img + static_cast<long long>(oh) * W + ow;
#pragma unroll
          for (int j = 0; j < kNI; ++j) {
            const int col = col_of(n0, j);
            float r0, r1;
            if (ds) {  // the branch at its own int8 scale, then rescaled by rs
              r0 = q8(__fadd_rn(__fmul_rn(__int2float_rn(dacc[i][j][2 * h]), bp.md[col]),
                                bp.td[col]));
              r1 = q8(__fadd_rn(__fmul_rn(__int2float_rn(dacc[i][j][2 * h + 1]),
                                          bp.md[col + 1]),
                                bp.td[col + 1]));
            } else {  // identity: cin == C
              const unsigned short v =
                  __ldcg(reinterpret_cast<const unsigned short*>(x + pix * cin + col));
              r0 = static_cast<int8_t>(v & 0xff);
              r1 = static_cast<int8_t>(v >> 8);
            }
            const int8_t q0 =
                requant(acc[i][j][2 * h], bp.m3[col], bp.t3[col], kResidual, r0, rs);
            const int8_t q1 =
                requant(acc[i][j][2 * h + 1], bp.m3[col + 1], bp.t3[col + 1], kResidual, r1, rs);
            *reinterpret_cast<uint16_t*>(out + pix * C + col) = pack2(q0, q1);
          }
        }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    int8_bottleneck_kernel(const int8_t* x, int8_t* out, const __grid_constant__ BlockParams bp,
                           const __grid_constant__ Geometry geo) {
  extern __shared__ __align__(16) int8_t smem[];
  bottleneck_tile(x, out, bp, geo, geo.C, blockIdx.x, carve(smem, geo));
}

// Grid-wide barrier of a cooperative launch: the count rises by one per
// block and barrier, so barrier b is passed when it reaches b * gridDim.x.
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's outputs are visible before it arrives
    atomicAdd(count, 1u);
    unsigned seen;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(count) : "memory");
      if (seen >= target) break;
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    int8_chain_kernel(const __grid_constant__ ChainArgs args,
                      const __grid_constant__ Geometry geo) {
  extern __shared__ __align__(16) int8_t smem[];
  const Smem sm = carve(smem, geo);
  const int8_t* src = args.x;
  for (int b = 0; b < args.nb; ++b) {
    // The last block writes `out`; the blocks before it alternate with tmp.
    int8_t* dst = (args.nb - 1 - b) % 2 == 0 ? args.out : args.tmp;
    const int cin = b == 0 ? geo.Cin : geo.C;
    for (int tile = blockIdx.x; tile < geo.ntiles; tile += gridDim.x)
      bottleneck_tile(src, dst, args.blocks[b], geo, cin, tile, sm);
    if (b + 1 < args.nb) grid_sync(args.barrier, static_cast<unsigned>(b + 1) * gridDim.x);
    src = dst;
  }
}

int smem_bytes(const Geometry& geo) {
  return kStageBytes + ((geo.TH + 2) * (geo.TW + 2) + kTileRows) * geo.ldy;
}

// Fills geo; returns false for a geometry the kernels do not take.
bool make_geometry(Geometry& geo, int N, int H, int W, int Cin, int C, int P, int TH, int TW) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || C <= 0 || P <= 0 || Cin % kBK || C % kBN ||
      P % kBN || TH <= 0 || TW <= 0 || (TH + 2) * (TW + 2) > kHaloRows || TH * TW > kTileRows)
    return false;
  geo.H = H;
  geo.W = W;
  geo.Cin = Cin;
  geo.C = C;
  geo.P = P;
  geo.TH = TH;
  geo.TW = TW;
  geo.tiles_w = (W + TW - 1) / TW;
  geo.per_image = (H + TH - 1) / TH * geo.tiles_w;
  const long long ntiles = static_cast<long long>(N) * geo.per_image;
  if (ntiles > 0x7fffffff) return false;
  geo.ntiles = static_cast<int>(ntiles);
  geo.ldy = P + 16;  // rows of y1 / y2 land on distinct banks
  return smem_bytes(geo) <= kMaxSmem;
}

BlockParams block_params(const void* const* p) {
  BlockParams bp;
  bp.w1 = static_cast<const int8_t*>(p[0]);
  bp.w2 = static_cast<const int8_t*>(p[1]);
  bp.w3 = static_cast<const int8_t*>(p[2]);
  bp.m1 = static_cast<const float*>(p[3]);
  bp.t1 = static_cast<const float*>(p[4]);
  bp.m2 = static_cast<const float*>(p[5]);
  bp.t2 = static_cast<const float*>(p[6]);
  bp.m3 = static_cast<const float*>(p[7]);
  bp.t3 = static_cast<const float*>(p[8]);
  bp.r = static_cast<const float*>(p[9]);
  bp.wd = static_cast<const int8_t*>(p[10]);
  bp.md = static_cast<const float*>(p[11]);
  bp.td = static_cast<const float*>(p[12]);
  return bp;
}

bool complete(const BlockParams& bp) {
  return bp.w1 && bp.w2 && bp.w3 && bp.m1 && bp.t1 && bp.m2 && bp.t2 && bp.m3 && bp.t3 && bp.r &&
         (!bp.wd || (bp.md && bp.td));
}

}  // namespace

extern "C" {

// Per block, `params` holds 13 pointers in this order: w1 (P, Cin), w2 (P, 9P),
// w3 (C, P) int8 packed K-contiguous (serving/cuda_int8.py::pack_weight);
// m1, t1, m2, t2 (P,), m3, t3 (C,) float32; r, one float32 (rx, or
// ds_rescale); wd (C, Cin) int8, md, td (C,) float32, or three nulls for an
// identity block. All on the device. x, out: (N, H, W, C) int8 NHWC,
// contiguous, 16-byte aligned; (TH, TW): the output tile. Returns a
// cudaError_t: cudaErrorInvalidValue for what the kernel does not take
// (C, P not multiples of 64, a tile over 64 pixels or 128 halo pixels, a
// downsample), else the launch's status.
int yolo_int8_bottleneck(const void* x, void* out, const void* const* params, int N, int H,
                         int W, int C, int P, int TH, int TW, void* stream) {
  Geometry geo;
  if (!make_geometry(geo, N, H, W, C, C, P, TH, TW)) return cudaErrorInvalidValue;
  const BlockParams bp = block_params(params);
  if (!complete(bp) || bp.wd != nullptr || x == nullptr || out == nullptr)
    return cudaErrorInvalidValue;
  const int smem = smem_bytes(geo);
  cudaError_t err = cudaFuncSetAttribute(int8_bottleneck_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int8_bottleneck_kernel<<<geo.ntiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), bp, geo);
  return cudaGetLastError();
}

// A chain of nb stride-1 bottleneck blocks (params: nb x 13 pointers, as
// above; only block 0 may carry a downsample, and must where Cin != C):
// x (N, H, W, Cin) -> out (N, H, W, C). tmp: (N, H, W, C) int8 scratch
// (unused for nb == 1); barrier: one uint32 on the device. One cooperative
// launch of min(tiles, blocks the card holds at once) thread blocks;
// *grid_out (host, may be null) receives that count. Returns a cudaError_t
// as above.
int yolo_int8_chain(const void* x, void* out, void* tmp, void* barrier,
                    const void* const* params, int nb, int N, int H, int W, int Cin, int C, int P,
                    int TH, int TW, int* grid_out, void* stream) {
  Geometry geo;
  if (nb < 1 || nb > kMaxBlocks || !make_geometry(geo, N, H, W, Cin, C, P, TH, TW) ||
      x == nullptr || out == nullptr || barrier == nullptr || (nb > 1 && tmp == nullptr))
    return cudaErrorInvalidValue;
  ChainArgs args;
  args.nb = nb;
  args.x = static_cast<const int8_t*>(x);
  args.out = static_cast<int8_t*>(out);
  args.tmp = static_cast<int8_t*>(tmp);
  args.barrier = static_cast<unsigned*>(barrier);
  for (int b = 0; b < nb; ++b) {
    args.blocks[b] = block_params(params + b * kPtrsPerBlock);
    if (!complete(args.blocks[b]) || (b > 0 && args.blocks[b].wd != nullptr))
      return cudaErrorInvalidValue;
  }
  if (args.blocks[0].wd == nullptr && Cin != C) return cudaErrorInvalidValue;

  const int smem = smem_bytes(geo);
  cudaError_t err = cudaFuncSetAttribute(int8_chain_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int8_chain_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = per_sm * sms < geo.ntiles ? per_sm * sms : geo.ntiles;
  if (grid_out != nullptr) *grid_out = grid;

  auto st = static_cast<cudaStream_t>(stream);
  if ((err = cudaMemsetAsync(barrier, 0, sizeof(unsigned), st)) != cudaSuccess) return err;
  void* kargs[] = {&args, &geo};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(int8_chain_kernel),
                                     dim3(grid), dim3(kThreads), kargs,
                                     static_cast<size_t>(smem), st);
}

}  // extern "C"
