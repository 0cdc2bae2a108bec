// int8 fused bottleneck blocks for Hopper (sm_90a): identity bottlenecks,
// one block a launch (yolo_int8_bottleneck), and a stage's whole run of
// stride-1 bottlenecks in one launch (yolo_int8_chain).
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
// Every step rounds as int8_common.cuh's requant does, in its order, so both
// kernels equal the chained eager twin (engine._block with a float64 conv)
// bit for bit: the int32 sums are exact in any order.
//
// A block on one output tile is sm90_bottleneck_tile.cuh's routine (s8
// k32 wgmma, int32 sums; y1 over the tile's halo and y2 never leave shared
// memory; conv2's and conv3's A from registers by ldmatrix, conv1's and the
// downsample's from the producer's ring); this file supplies the requant
// epilogues. Both kernels are persistent: one thread block an SM walks the
// tiles, the ring running on from one tile to the next.
//
// The chain: the TPU kernel kept a whole stage image in VMEM; no stage image
// fits in an SM's 227 KB. So the chain is one cooperative launch of as many
// resident blocks as the card holds; they walk the tiles of block b, meet
// at a grid barrier (producer warpgroup included: the next block's x is
// this block's output), and walk block b+1, ping-ponging the activations
// between `out` and `tmp` in device memory (the 50 MB L2 holds a stage of a
// small batch). Reads of data that this launch wrote go through L2
// (cp.async.cg, ld.global.cg), never L1.
//
// What bounds it: the int8 tensor cores (1,979 dense TOPS on an H100 SXM)
// at layers 1-2; at layers 3-4, where every tile streams the whole block's
// weights (up to 4.4 MB a tile at layer4) through a few tiles' worth of SMs,
// the weights' stream from L2. plan() (serving/cuda_bottleneck.py) picks
// the tile per geometry.

#include <cuda_runtime.h>

#include <cstdint>

#include "sm90_bottleneck_tile.cuh"

namespace {

namespace bt = sm90::btile;

constexpr int kAlign = 64;         // C, P and Cin: multiples of 64
constexpr int kMaxBlocks = 8;      // bottlenecks in one chain
constexpr int kPtrsPerBlock = 13;  // the C interface's pointers per block

struct BlockParams {
  const int8_t* w1;  // (P, Cin), K contiguous
  const int8_t* w2;  // (P, 9P), K = (kh, kw, ci)
  const int8_t* w3;  // (C, P)
  const int8_t* wd;  // (C, Cin), or nullptr: an identity block
  const float *m1, *t1, *m2, *t2, *m3, *t3, *md, *td;
  const float* r;    // rx, or ds_rescale where wd is set
};

struct ChainArgs {
  BlockParams blocks[kMaxBlocks];
  int nb, cin, c, p;
  const int8_t* x;
  int8_t* out;
  int8_t* tmp;
  unsigned* barrier;
};

// q8(v) of int8_common.cuh as its byte, without conversion instructions
// (which run at an eighth of the FP32 rate and set the pace of these
// epilogues): clamping to +-127 commutes with rounding to an integer there,
// and adding 1.5 * 2^23 rounds to an integer in the float's low mantissa
// bits (round to nearest even, as rintf), whose low byte is the int8 value.
__device__ __forceinline__ uint32_t q8_byte(float v) {
  const float c = fminf(fmaxf(v, -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(c, 12582912.0f)) & 0xffu;
}

// The int8 value of byte b as a float, exactly, by the same offset.
__device__ __forceinline__ float int8_float(uint32_t b) {
  const int v = static_cast<int8_t>(b & 0xffu);
  return __fadd_rn(__uint_as_float(0x4B400000u + static_cast<uint32_t>(v)), -12582912.0f);
}

// The requant epilogues on a pair of neighbouring columns (col, col + 1),
// packed as two int8 bytes, low first, from each column's scale and shift:
// requant() of int8_common.cuh step for step (y = acc * m + t, two
// roundings; + res * r; ReLU; q8).
struct Int8Pol {
  const float *m1, *t1, *m2, *t2, *m3, *t3, *md, *td;
  float rs;
  struct P {
    float m, t;
  };
  // K: 1 conv1, 2 conv2, 3 conv3, 4 the downsample.
  template <int K>
  __device__ __forceinline__ P param(int col) const {
    const float* m = K == 1 ? m1 : K == 2 ? m2 : K == 3 ? m3 : md;
    const float* t = K == 1 ? t1 : K == 2 ? t2 : K == 3 ? t3 : td;
    return {__ldg(m + col), __ldg(t + col)};
  }
  static __device__ __forceinline__ float affine(int a, P p) {
    return __fadd_rn(__fmul_rn(__int2float_rn(a), p.m), p.t);
  }
  __device__ __forceinline__ uint32_t y(int a0, int a1, P p0, P p1) const {
    return q8_byte(fmaxf(affine(a0, p0), 0.0f)) | q8_byte(fmaxf(affine(a1, p1), 0.0f)) << 8;
  }
  // The downsample branch at its own int8 scale (no ReLU).
  __device__ __forceinline__ uint32_t ds(int a0, int a1, P p0, P p1) const {
    return q8_byte(affine(a0, p0)) | q8_byte(affine(a1, p1)) << 8;
  }
  // conv3 + the residual pair res (x, or the downsample branch), times rs.
  __device__ __forceinline__ uint32_t out(int a0, int a1, P p0, P p1, uint32_t res) const {
    const float v0 = __fadd_rn(affine(a0, p0), __fmul_rn(int8_float(res), rs));
    const float v1 = __fadd_rn(affine(a1, p1), __fmul_rn(int8_float(res >> 8), rs));
    return q8_byte(fmaxf(v0, 0.0f)) | q8_byte(fmaxf(v1, 0.0f)) << 8;
  }
};

__device__ __forceinline__ bt::Convs convs_of(const ChainArgs& a, int b) {
  const BlockParams& bp = a.blocks[b];
  const int cin = b == 0 ? a.cin : a.c;
  return {reinterpret_cast<const uint8_t*>(bp.w1), reinterpret_cast<const uint8_t*>(bp.w2),
          reinterpret_cast<const uint8_t*>(bp.w3), reinterpret_cast<const uint8_t*>(bp.wd),
          cin, a.p, a.c, cin, 9 * a.p, a.p, cin};
}

// Grid-wide barrier of a cooperative launch, every thread of the block: the
// count rises by one per block and barrier, so barrier b is passed when it
// reaches b * gridDim.x. The next block's x, written with ordinary stores,
// is then read by cp.async into stages that wgmma reads: the proxy fence
// orders those reads after the barrier.
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned target) {
  asm volatile("bar.sync 2, %0;\n" ::"n"(bt::kThreads) : "memory");
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
  asm volatile("bar.sync 2, %0;\n" ::"n"(bt::kThreads) : "memory");
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The blocks of a chain (nb == 1: one block) over every tile.
__device__ __forceinline__ void run(const ChainArgs& a, const bt::Tiling& g) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  bt::Ring ring = bt::make_ring(g, base);
  bt::init_ring(ring);
  __syncthreads();
  const int wg = threadIdx.x / sm90::kWgThreads;
  const int8_t* src = a.x;
  if (wg == bt::kWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(bt::kProducerRegs) : "memory");
    int* table = reinterpret_cast<int*>(sbase + bt::table_offset(g));
    const int t = threadIdx.x % sm90::kWgThreads;
    for (int b = 0; b < a.nb; ++b) {
      int8_t* dst = (a.nb - 1 - b) % 2 == 0 ? a.out : a.tmp;
      const bt::Convs cv = convs_of(a, b);
      for (int tile = blockIdx.x; tile < g.ntiles; tile += gridDim.x)
        bt::produce_tile<1>(g, reinterpret_cast<const uint8_t*>(src), cv, tile, ring, table, t);
      if (b + 1 < a.nb) grid_sync(a.barrier, static_cast<unsigned>(b + 1) * gridDim.x);
      src = dst;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(bt::kConsumerRegs) : "memory");
    uint8_t* y1 = sbase + bt::y1_offset(g);
    uint8_t* y2 = sbase + bt::y2_offset(g);
    for (int b = 0; b < a.nb; ++b) {
      int8_t* dst = (a.nb - 1 - b) % 2 == 0 ? a.out : a.tmp;
      const bt::Convs cv = convs_of(a, b);
      const BlockParams& bp = a.blocks[b];
      const Int8Pol pol{bp.m1, bp.t1, bp.m2, bp.t2, bp.m3, bp.t3, bp.md, bp.td, __ldg(bp.r)};
      for (int tile = blockIdx.x; tile < g.ntiles; tile += gridDim.x)
        bt::consume_tile<1>(g, reinterpret_cast<uint8_t*>(dst), cv, pol, tile, ring, y1, y2, wg);
      if (b + 1 < a.nb) grid_sync(a.barrier, static_cast<unsigned>(b + 1) * gridDim.x);
      src = dst;
    }
  }
}

__global__ void __launch_bounds__(bt::kThreads, 1)
    int8_bottleneck_kernel(const __grid_constant__ ChainArgs a, const __grid_constant__ bt::Tiling g) {
  run(a, g);
}

__global__ void __launch_bounds__(bt::kThreads, 1)
    int8_chain_kernel(const __grid_constant__ ChainArgs a, const __grid_constant__ bt::Tiling g) {
  run(a, g);
}

// Fills g; false for a geometry the kernels do not take.
bool make_geometry(bt::Tiling& g, int N, int H, int W, int Cin, int C, int P, int TH, int TW) {
  if (Cin <= 0 || C <= 0 || P <= 0 || Cin % kAlign || C % kAlign || P % kAlign) return false;
  return bt::make_tiling(g, 1, N, H, W, Cin, C, P, TH, TW);
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
// contiguous, 16-byte aligned; (TH, TW): the output tile
// (serving/cuda_bottleneck.py::plan). One persistent launch of min(tiles,
// blocks the card holds at once) thread blocks; *grid_out (host, may be
// null) receives that count. Returns a cudaError_t: cudaErrorInvalidValue
// for what the kernel does not take (C, P not multiples of 64, a tile whose
// halo or tile rows exceed four 64-row blocks or whose buffers leave fewer
// than three stages of shared memory, a downsample), else the launch's
// status.
int yolo_int8_bottleneck(const void* x, void* out, const void* const* params, int N, int H,
                         int W, int C, int P, int TH, int TW, int* grid_out, void* stream) {
  bt::Tiling g;
  if (!make_geometry(g, N, H, W, C, C, P, TH, TW) || x == nullptr || out == nullptr)
    return cudaErrorInvalidValue;
  ChainArgs args;
  args.blocks[0] = block_params(params);
  if (!complete(args.blocks[0]) || args.blocks[0].wd != nullptr) return cudaErrorInvalidValue;
  args.nb = 1;
  args.cin = args.c = C;
  args.p = P;
  args.x = static_cast<const int8_t*>(x);
  args.out = static_cast<int8_t*>(out);
  args.tmp = nullptr;
  args.barrier = nullptr;
  const int smem = bt::smem_bytes(g);
  int grid = 0;
  cudaError_t err = bt::grid_of(int8_bottleneck_kernel, smem, g.ntiles, &grid);
  if (err != cudaSuccess) return err;
  if (grid_out != nullptr) *grid_out = grid;
  int8_bottleneck_kernel<<<grid, bt::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args, g);
  return cudaGetLastError();
}

// A chain of nb stride-1 bottleneck blocks (params: nb x 13 pointers, as
// above; only block 0 may carry a downsample, and must where Cin != C):
// x (N, H, W, Cin) -> out (N, H, W, C). tmp: (N, H, W, C) int8 scratch
// (unused for nb == 1); barrier: one uint32 on the device. One cooperative
// launch of min(tiles, blocks the card holds at once) thread blocks (one an
// SM: the tile's shared memory and 384 threads); *grid_out (host, may be
// null) receives that count. Returns a cudaError_t as above.
int yolo_int8_chain(const void* x, void* out, void* tmp, void* barrier,
                    const void* const* params, int nb, int N, int H, int W, int Cin, int C, int P,
                    int TH, int TW, int* grid_out, void* stream) {
  bt::Tiling g;
  if (nb < 1 || nb > kMaxBlocks || !make_geometry(g, N, H, W, Cin, C, P, TH, TW) ||
      x == nullptr || out == nullptr || barrier == nullptr || (nb > 1 && tmp == nullptr))
    return cudaErrorInvalidValue;
  ChainArgs args;
  args.nb = nb;
  args.cin = Cin;
  args.c = C;
  args.p = P;
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

  const int smem = bt::smem_bytes(g);
  int grid = 0;
  cudaError_t err = bt::grid_of(int8_chain_kernel, smem, g.ntiles, &grid);
  if (err != cudaSuccess) return err;
  if (grid_out != nullptr) *grid_out = grid;
  auto st = static_cast<cudaStream_t>(stream);
  if ((err = cudaMemsetAsync(barrier, 0, sizeof(unsigned), st)) != cudaSuccess) return err;
  void* kargs[] = {&args, &g};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(int8_chain_kernel),
                                     dim3(grid), dim3(bt::kThreads), kargs,
                                     static_cast<size_t>(smem), st);
}

}  // extern "C"
