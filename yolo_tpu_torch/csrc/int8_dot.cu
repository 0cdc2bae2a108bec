// int8 GEMM with a requant epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel of experiments/mosaic_int8_dot.py (the closure
// `kernel` :55-61 inside main(), entry `run` :64): per output element
//   out[i, j] = clip(rint(float(sum_k a[i, k] * w[k, j]) * m[j]), -127, 127)
// as int8, the int32 sum exact (|sum| <= 127^2 * K < 2^31 for K < 133,000),
// float(.) = __int2float_rn and the multiply __fmul_rn, rint half to even:
// the op order of the TPU kernel and of the twin
// (yolo_tpu_torch/experiments/mosaic_int8_dot.py::int8_dot_reference), so
// the kernel equals the twin bit for bit.
//
// a: (M, K) int8 row-major. w arrives packed K-major as (N, Kpad) int8, Kpad
// = K rounded up to 64 with zeros (the wrapper packs it once), as
// int8_conv.cu reads its weights. The harness's K = 300 (the stem's phase
// geometry) leaves a's rows 4-byte aligned only, and K = 192 and 300 are not
// multiples of the 64-byte stage: where K % 16 == 0 a row's 64-byte stage
// chunk is fetched as four 16-byte cp.async, else (K % 4 == 0) as sixteen
// 4-byte ones; either way a piece that starts at or past K is zero-filled,
// never read, so no load crosses the end of a row.
//
// What bounds it: at the harness's M = 2^20 every case but full-fill moves
// more bytes than the int8 tensor cores need time for (l2-im2col: 1.34 GB,
// 0.40 ms at 3.35 TB/s, against 309 G ops, 0.16 ms at 1,979 TOPS). Design,
// simple first, as int8_conv.cu: 8 warps of mma.sync.m16n8k32 s8 per BM x BN
// output tile, two cp.async stages of 64 bytes of K, 80-byte shared rows
// (the fragment loads of a warp hit 32 banks), the requant on the
// accumulator registers and two neighbouring outputs stored at once. Not
// done: wgmma, TMA, a deeper pipeline.

#include <cuda_runtime.h>

#include <cstdint>

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;         // K bytes per stage
constexpr int kRow = kBK + 16;  // shared row stride in bytes (bank spread)

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const int bytes = ok ? 4 : 0;  // 0: the 4 shared bytes are zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

struct DotArgs {
  const int8_t* a;
  const int8_t* w;
  const float* m;
  int8_t* out;
  long long M;
  int K, N, Kpad;
};

template <int BM, int BN, int WM, int WN, bool kVec16>
__global__ void __launch_bounds__(kThreads) int8_dot_kernel(const DotArgs d) {
  constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  constexpr int MI = WTM / 16, NI = WTN / 8;   // mma tiles per warp
  constexpr int A_PER = BM * (kBK / 16) / kThreads;
  constexpr int B_PER = BN * (kBK / 16) / kThreads;
  static_assert(WM * WN == kThreads / 32, "8 warps");

  __shared__ __align__(16) int8_t As[2][BM * kRow];
  __shared__ __align__(16) int8_t Bs[2][BN * kRow];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int warp_m = warp / WN, warp_n = warp % WN;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int chunk = tid % (kBK / 16);  // this thread's 16-byte column of every stage

  const int8_t* arow[A_PER];  // this thread's rows of a, or nullptr past M
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const long long m = m0 + (tid + i * kThreads) / (kBK / 16);
    arow[i] = m < d.M ? d.a + m * d.K : nullptr;
  }

  auto load_stage = [&](int kt, int stage) {
    const int k0 = kt * kBK + chunk * 16;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      int8_t* dst = &As[stage][((tid + i * kThreads) / (kBK / 16)) * kRow + chunk * 16];
      if constexpr (kVec16) {
        const bool ok = arow[i] != nullptr && k0 < d.K;
        cp_async16(dst, ok ? arow[i] + k0 : d.a, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = arow[i] != nullptr && k0 + 4 * j < d.K;
          cp_async4(dst + 4 * j, ok ? arow[i] + k0 + 4 * j : d.a, ok);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int r = (tid + i * kThreads) / (kBK / 16);
      const bool ok = n0 + r < d.N;
      const int8_t* src = ok ? d.w + static_cast<long long>(n0 + r) * d.Kpad + k0 : d.w;
      cp_async16(&Bs[stage][r * kRow + chunk * 16], src, ok);
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = d.Kpad / kBK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // stage kt is in shared memory; everyone is done with stage kt-1
    if (kt + 1 < nk) {
      load_stage(kt + 1, (kt + 1) & 1);
      cp_async_commit();
    }
    const int8_t* as = As[kt & 1];
    const int8_t* bs = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* p = as + (warp_m * WTM + i * 16 + g) * kRow + kk + tg * 4;
        af[i][0] = *reinterpret_cast<const unsigned*>(p);
        af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * kRow);
        af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int8_t* p = bs + (warp_n * WTN + j * 8 + g) * kRow + kk + tg * 4;
        bf[j][0] = *reinterpret_cast<const unsigned*>(p);
        bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_s8(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], bf[j][0], bf[j][1]);
    }
  }

  // Epilogue: accumulator element e of tile (i, j) is row g (+8 for e >= 2),
  // column 2*tg (+1 for odd e) of that tile.
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + warp_m * WTM + i * 16 + g + half * 8;
      if (row >= d.M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = n0 + warp_n * WTN + j * 8 + tg * 2;
        if (col >= d.N) continue;  // N is even, so col + 1 < N too
        const int8_t q0 = q8(__fmul_rn(__int2float_rn(acc[i][j][half * 2]), d.m[col]));
        const int8_t q1 = q8(__fmul_rn(__int2float_rn(acc[i][j][half * 2 + 1]), d.m[col + 1]));
        *reinterpret_cast<uint16_t*>(d.out + row * d.N + col) = pack2(q0, q1);
      }
    }
  }
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch(const DotArgs& d, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((d.M + BM - 1) / BM),
                  static_cast<unsigned>((d.N + BN - 1) / BN));
  if (d.K % 16 == 0) {
    int8_dot_kernel<BM, BN, WM, WN, true><<<grid, kThreads, 0, stream>>>(d);
  } else {
    int8_dot_kernel<BM, BN, WM, WN, false><<<grid, kThreads, 0, stream>>>(d);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a: (M, K) int8 row-major, 4-byte aligned (16-byte where K % 16 == 0);
// w: (N, Kpad) int8, row n = column n of the (K, N) weight, zero past K,
// 16-byte aligned; m: (N,) float32; out: (M, N) int8. All on the device,
// contiguous. 128 x 128 output tiles where N % 128 == 0, else 128 x 64.
// Returns a cudaError_t: cudaErrorInvalidValue for what the kernel does not
// take (K % 4 != 0, odd N, Kpad not a multiple of 64 or below K), else the
// launch's status.
int yolo_int8_dot(const void* a, const void* w, const void* m, void* out, long long M, int K,
                  int N, int Kpad, void* stream) {
  if (M < 0 || K <= 0 || K % 4 || N <= 0 || N % 2 || Kpad < K || Kpad % kBK || !a || !w ||
      !m || !out)
    return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  DotArgs d;
  d.a = static_cast<const int8_t*>(a);
  d.w = static_cast<const int8_t*>(w);
  d.m = static_cast<const float*>(m);
  d.out = static_cast<int8_t*>(out);
  d.M = M;
  d.K = K;
  d.N = N;
  d.Kpad = Kpad;
  auto st = static_cast<cudaStream_t>(stream);
  return N % 128 == 0 ? static_cast<int>(launch<128, 128, 2, 4>(d, st))
                      : static_cast<int>(launch<128, 64, 4, 2>(d, st));
}

}  // extern "C"
