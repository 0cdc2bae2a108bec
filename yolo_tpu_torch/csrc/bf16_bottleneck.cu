// bf16 fused identity bottleneck (inference, BN folded) for Hopper (sm_90a).
//
// Replaces the TPU kernel experiments/fused_block_pallas.py::
// fused_bottleneck_kernel (entry fused_bottleneck) and computes what it
// computes, per pixel:
//   y1  = bf16(relu(conv1x1(x, w1) + b1))            CIN -> P   (:50-58)
//   y2  = bf16(relu(conv3x3(y1, w2, pad 1) + b2))    P -> P     (:79-84)
//   out = bf16(relu((conv1x1(y2, w3) + b3) + x))     P -> CIN   (:87-92)
// with float32 accumulators, each bias and the residual added in float32 in
// that order, and y1, y2 rounded to bf16 where the TPU kernel rounds them.
// The twin (yolo_tpu_torch/experiments/fused_block_pallas.py::reference)
// runs the same steps as three float32 convs; the sums are taken in another
// order, so the two agree to a bf16 ulp or two, not to the bit.
//
// The tile design of int8_bottleneck.cu: one thread block per 8 x 8 output
// tile of one image. conv1 runs over the tile's one-pixel halo (10 x 10 = 100
// x pixels, gathered 32 values of K at a time by 16-byte cp.async, zero-
// filled off the image) into y1 in shared memory; y1 is then set to 0 off
// the image, because conv2 pads y1 with zeros, not x (relu(b1) is not 0).
// conv2 reads its im2col rows straight from y1 (K = 9P in (kh, kw, c) order,
// the order of the packed weights), conv3 reads y2 from shared memory and
// adds the residual, read from device memory (L2). Every image size is
// taken: tiles past the image's last row or column compute and do not store
// (the TPU kernel left the rows past a multiple of its row tile unwritten).
// Each product streams its packed weights (Cout, Kpad) through two cp.async
// stages of 64 output channels x 32 K values; 8 warps of mma.sync.m16n8k16
// bf16 (2 across rows x 4 across the 64 columns), fragments by ldmatrix.
//
// What bounds it: device memory at layer1 (x read and out written once:
// 0.82 GB at batch 64, 112x112, 256/64, 0.245 ms at 3.35 TB/s, against 112
// GFLOP, 0.113 ms at 989 TFLOP/s). Simple first: conv1 is recomputed on the
// halo (1.56x its work at 8 x 8 tiles) and padded from 100 to 128 rows, each
// tile re-reads its 139 KB of weights from L2, no wgmma, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_common.cuh"

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kBK = 32;           // K values per pipeline stage (64 bytes)
constexpr int kRowB = kBK * 2 + 16;  // staged row stride in bytes (bank spread)
constexpr int kBN = 64;           // output channels per column chunk
constexpr int kWN = 4;            // warps across a chunk's columns (2 across rows)
constexpr int kNI = kBN / kWN / 8;  // 8-column mma tiles per warp
constexpr int kT = 8;             // output tile: kT x kT pixels
constexpr int kHalo = kT + 2;
constexpr int kHaloRows = 128;    // conv1 rows: kHalo^2 = 100, padded
constexpr int kTileRows = kT * kT;  // conv2 / conv3 rows
constexpr int kStageA = kHaloRows * kRowB;
constexpr int kStageB = kBN * kRowB;
constexpr int kStageBytes = 2 * kStageA + 2 * kStageB;
constexpr int kMaxSmem = 232448;  // an H100's shared memory per block

using bf16 = __nv_bfloat16;

struct Args {
  const bf16* x;
  const bf16* w1;  // (P, K1pad)
  const bf16* w2;  // (P, K2pad), K = (kh, kw, c)
  const bf16* w3;  // (CIN, K3pad)
  const float *b1, *b2, *b3;
  bf16* out;
  int H, W, CIN, P, K1pad, K2pad, K3pad, tiles_w, per_image, ldyb;
};

// Block-wide product of one 64-column chunk: acc = A (MI*32 rows x K) times
// rows n0 .. n0+63 of w (row stride ldw values, zero past K up to Kpad;
// rows at or past ncols count as zero). The weight rows stream through two
// cp.async stages; load_a(kt, stage) stages A's K chunk kt beside them (or
// does nothing where A lies in shared memory). a_ptr(st, i, k) is the
// shared address this lane hands ldmatrix for values k .. k+15 of its row in
// m-tile i (its row: warp row + i*16 + lane % 16). K % 16 == 0: a k16 step
// lies wholly inside K or wholly past it, and steps past K are skipped, so
// no A value past K is read.
template <int MI, class LoadA, class APtr>
__device__ __forceinline__ void gemm(float (&acc)[MI][kNI][4], int K, int Kpad, const bf16* w,
                                     int ldw, int ncols, int n0, char* sm, LoadA load_a,
                                     APtr a_ptr) {
  const int tid = threadIdx.x, lane = tid % 32, warp_n = (tid / 32) % kWN;
  const int brow = tid / 4, bchunk = tid % 4;  // one 16-byte weight copy per stage
  const bool bok = n0 + brow < ncols;
  const bf16* wsrc = bok ? w + static_cast<long long>(n0 + brow) * ldw + bchunk * 8 : w;
  char* sb = sm + 2 * kStageA;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nk = Kpad / kBK;
  load_a(0, 0);
  cp_async16(sb + brow * kRowB + bchunk * 16, wsrc, bok);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    cp_async_wait_all();
    __syncthreads();  // stage kt is in shared memory; everyone is done with stage kt-1
    if (kt + 1 < nk) {
      load_a(kt + 1, st ^ 1);
      cp_async16(sb + (st ^ 1) * kStageB + brow * kRowB + bchunk * 16,
                 bok ? wsrc + (kt + 1) * kBK : w, bok);
      cp_async_commit();
    }
    const char* bs = sb + st * kStageB;
#pragma unroll
    for (int kb = 0; kb < kBK * 2; kb += 32) {  // two k16 steps of 32 bytes
      const int k = kt * kBK + kb / 2;
      if (k >= K) break;
      unsigned af[MI][4], q[4];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldmatrix_x4(af[i], a_ptr(st, i, k));
      ldmatrix_x4(q, bs + (warp_n * (kNI * 8) + b_lane_row(lane)) * kRowB + kb +
                         b_lane_byte(lane));
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        mma_bf16(acc[i][0], af[i], q[0], q[1]);
        mma_bf16(acc[i][1], af[i], q[2], q[3]);
      }
    }
  }
  __syncthreads();  // both stages are free again for the next product
}

__global__ void __launch_bounds__(kThreads) bf16_bottleneck_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) char smem[];
  char* y1 = smem + kStageBytes;                // kHalo^2 rows of P values, ldyb bytes apart
  char* y2 = y1 + kHalo * kHalo * a.ldyb;        // kTileRows rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int warp_m = warp / kWN, warp_n = warp % kWN;
  const int H = a.H, W = a.W, P = a.P, CIN = a.CIN, ldyb = a.ldyb;
  const int n = blockIdx.x / a.per_image, t = blockIdx.x - n * a.per_image;
  const int oh0 = t / a.tiles_w * kT, ow0 = (t % a.tiles_w) * kT;
  const long long img = static_cast<long long>(n) * H * W;
  auto col_of = [&](int n0, int j) { return n0 + warp_n * (kNI * 8) + j * 8 + 2 * tg; };
  auto no_load = [](int, int) {};

  // ---- conv1 (1x1, CIN -> P) over the halo window -> y1.
  {
    const int chunk = tid % 4;
    long long off[2];  // this thread's two gathered rows: x offset, or -1 (zero row)
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int r = tid / 4 + l * 64;
      const int ph = oh0 - 1 + r / kHalo, pw = ow0 - 1 + r % kHalo;
      const bool in = r < kHalo * kHalo && ph >= 0 && ph < H && pw >= 0 && pw < W;
      off[l] = in ? (img + static_cast<long long>(ph) * W + pw) * CIN + chunk * 8 : -1;
    }
    auto load_a = [&](int kt, int st) {
      const int k0 = kt * kBK + chunk * 8;
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const bool ok = off[l] >= 0 && k0 < CIN;  // CIN % 8 == 0
        cp_async16(smem + st * kStageA + (tid / 4 + l * 64) * kRowB + chunk * 16,
                   ok ? a.x + off[l] + kt * kBK : a.x, ok);
      }
    };
    auto a_ptr = [&](int st, int i, int k) {
      return smem + st * kStageA + (warp_m * 64 + i * 16 + lane % 16) * kRowB + (k % kBK) * 2 +
             a_lane_byte(lane);
    };
    for (int n0 = 0; n0 < P; n0 += kBN) {
      float acc[4][kNI][4];
      gemm<4>(acc, CIN, a.K1pad, a.w1, a.K1pad, P, n0, smem, load_a, a_ptr);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp_m * 64 + i * 16 + g + 8 * h;
          if (r >= kHalo * kHalo) continue;
          const int ph = oh0 - 1 + r / kHalo, pw = ow0 - 1 + r % kHalo;
          const bool in = ph >= 0 && ph < H && pw >= 0 && pw < W;
#pragma unroll
          for (int j = 0; j < kNI; ++j) {
            const int col = col_of(n0, j);
            if (col >= P) continue;  // P % 16 == 0, so col + 1 < P too
            unsigned v = 0u;  // zero padding of conv2's input, off the image
            if (in)
              v = pack_bf16x2(fmaxf(__fadd_rn(acc[i][j][2 * h], a.b1[col]), 0.0f),
                              fmaxf(__fadd_rn(acc[i][j][2 * h + 1], a.b1[col + 1]), 0.0f));
            *reinterpret_cast<unsigned*>(y1 + r * ldyb + col * 2) = v;
          }
        }
    }
  }
  __syncthreads();  // y1 is complete

  // ---- conv2 (3x3, pad 1, P -> P) over y1 in shared memory -> y2.
  {
    int base[2];  // y1 row of tap (0, 0) for this lane's row in m-tile i
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp_m * 32 + i * 16 + lane % 16;
      base[i] = r / kT * kHalo + r % kT;
    }
    auto a_ptr = [&](int, int i, int k) {
      const int tap = k / P, ci = k - tap * P;  // P % 16 == 0: a k16 step is one tap
      return y1 + (base[i] + tap / 3 * kHalo + tap % 3) * ldyb + ci * 2 + a_lane_byte(lane);
    };
    for (int n0 = 0; n0 < P; n0 += kBN) {
      float acc[2][kNI][4];
      gemm<2>(acc, 9 * P, a.K2pad, a.w2, a.K2pad, P, n0, smem, no_load, a_ptr);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp_m * 32 + i * 16 + g + 8 * h;
#pragma unroll
          for (int j = 0; j < kNI; ++j) {
            const int col = col_of(n0, j);
            if (col >= P) continue;
            *reinterpret_cast<unsigned*>(y2 + r * ldyb + col * 2) =
                pack_bf16x2(fmaxf(__fadd_rn(acc[i][j][2 * h], a.b2[col]), 0.0f),
                            fmaxf(__fadd_rn(acc[i][j][2 * h + 1], a.b2[col + 1]), 0.0f));
          }
        }
    }
  }
  __syncthreads();  // y2 is complete

  // ---- conv3 (1x1, P -> CIN) + residual + relu -> out.
  {
    auto a_ptr = [&](int, int i, int k) {
      return y2 + (warp_m * 32 + i * 16 + lane % 16) * ldyb + k * 2 + a_lane_byte(lane);
    };
    for (int n0 = 0; n0 < CIN; n0 += kBN) {
      float acc[2][kNI][4];
      gemm<2>(acc, P, a.K3pad, a.w3, a.K3pad, CIN, n0, smem, no_load, a_ptr);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp_m * 32 + i * 16 + g + 8 * h;
          const int oh = oh0 + r / kT, ow = ow0 + r % kT;
          if (oh >= H || ow >= W) continue;
          const long long pix = img + static_cast<long long>(oh) * W + ow;
#pragma unroll
          for (int j = 0; j < kNI; ++j) {
            const int col = col_of(n0, j);
            if (col >= CIN) continue;  // CIN % 16 == 0
            const float2 res =
                unpack_bf16x2(__ldg(reinterpret_cast<const unsigned*>(a.x + pix * CIN + col)));
            const float v0 = __fadd_rn(__fadd_rn(acc[i][j][2 * h], a.b3[col]), res.x);
            const float v1 = __fadd_rn(__fadd_rn(acc[i][j][2 * h + 1], a.b3[col + 1]), res.y);
            *reinterpret_cast<unsigned*>(a.out + pix * CIN + col) =
                pack_bf16x2(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
          }
        }
    }
  }
}

int pad32(int k) { return (k + kBK - 1) / kBK * kBK; }

}  // namespace

extern "C" {

// x, out: (N, H, W, CIN) bf16 NHWC; w1: (P, pad32(CIN)), w2: (P, pad32(9P))
// with K in (kh, kw, c) order, w3: (CIN, pad32(P)), bf16 packed K-contiguous
// and zero past K (pad32: rounded up to a multiple of 32); b1, b2: (P,), b3:
// (CIN,) float32. All on the device, contiguous, 16-byte aligned. Returns a
// cudaError_t: cudaErrorInvalidValue for what the kernel does not take
// (CIN or P not a multiple of 16, P too large for shared memory), else the
// launch's status.
int yolo_bf16_bottleneck(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, const void* w3, const void* b3, void* out, int N, int H,
                         int W, int CIN, int P, void* stream) {
  if (N < 0 || H <= 0 || W <= 0 || CIN <= 0 || CIN % 16 || P <= 0 || P % 16 || !x || !w1 ||
      !b1 || !w2 || !b2 || !w3 || !b3 || !out)
    return cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.w1 = static_cast<const bf16*>(w1);
  a.w2 = static_cast<const bf16*>(w2);
  a.w3 = static_cast<const bf16*>(w3);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.b3 = static_cast<const float*>(b3);
  a.out = static_cast<bf16*>(out);
  a.H = H;
  a.W = W;
  a.CIN = CIN;
  a.P = P;
  a.K1pad = pad32(CIN);
  a.K2pad = pad32(9 * P);
  a.K3pad = pad32(P);
  a.tiles_w = (W + kT - 1) / kT;
  a.per_image = (H + kT - 1) / kT * a.tiles_w;
  a.ldyb = (P + 8) * 2;  // rows of y1 / y2 land on distinct banks
  const long long tiles = static_cast<long long>(N) * a.per_image;
  const long long smem = kStageBytes + static_cast<long long>(kHalo * kHalo + kTileRows) * a.ldyb;
  if (tiles > 0x7fffffff || smem > kMaxSmem) return cudaErrorInvalidValue;
  if (tiles == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(bf16_bottleneck_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bf16_bottleneck_kernel<<<static_cast<unsigned>(tiles), kThreads, static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
