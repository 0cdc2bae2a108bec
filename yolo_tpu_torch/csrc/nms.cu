// Per-class greedy NMS by selection, one warp per image, for Hopper (sm_90a).
//
// Replaces the TPU kernel yolo_tpu/ops/pallas_nms.py::_nms_kernel (entry
// pallas_nms). Same rule, same result: repeat until no candidate is active
//   best <- the active candidate with the highest score (ties: lowest index)
//   keep[best] = true
//   deactivate every active candidate of best's class with IoU(best) >= t.
// The keep mask equals yolo_tpu/ops/nms.py::batched_nms bit for bit.
//
// What bounds it: K dependent selection steps per image (K = S*S*B = 98 for
// the 7x7x2 grid), each a 32-lane max-reduction followed by an IoU sweep.
// The data is a few KB per image (6 floats + 1 int + 1 byte per candidate),
// so neither bandwidth nor arithmetic matters: it is latency-bound on the
// chain of steps. Measured on an H100 80GB HBM3 at 700 W: 0.07-0.08 ms per
// launch at K = 98 whether it holds 1 or 256 images, ~0.75 us per step.
//
// What the design does about it: every step stays inside one warp's
// registers. Lane l holds candidates l, l+32, l+64, ... (ceil(K/32) slots,
// 4 for K = 98), so a step is a register scan, a 5-level __shfl_xor_sync
// butterfly over (score, -index) and one shuffle broadcast of the winner's
// box: no shared memory, no __syncthreads, no global traffic inside the
// loop. The loop ends as soon as nothing is active. Images are independent,
// so a block holds a few warps and the grid covers the batch.
//
// Bit-exactness with the JAX kernel:
//   * corners, area and IoU use the same op order as pallas_nms.py:131-135
//     and :90-93, written with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn so
//     that nvcc cannot contract a*b+c into an FMA (it does by default);
//   * the threshold and eps arrive already rounded to float32, as the JAX
//     weak-typed compare uses them;
//   * scores compare with float ==, so -0.0 and 0.0 tie and the lower index
//     wins, as in the stable sort of batched_nms.
// eps == 0 selects the evaluator's IoU: inter / union with union == 0 -> 0
// (yolo_tpu/ops/boxes.py:62-64).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int SLOTS>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
nms_kernel(const float* __restrict__ boxes,     // (n, K, 4) cx, cy, w, h
           const float* __restrict__ scores,    // (n, K)
           const int32_t* __restrict__ cls,     // (n, K)
           const uint8_t* __restrict__ valid,   // (n, K) 0/1
           uint8_t* __restrict__ keep,          // (n, K) 0/1
           int n, int K, float iou_threshold, float eps) {
  const int image = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (image >= n) return;  // warp-uniform: the whole warp leaves together

  const float* b = boxes + static_cast<size_t>(image) * K * 4;
  const float* s = scores + static_cast<size_t>(image) * K;
  const int32_t* c = cls + static_cast<size_t>(image) * K;
  const uint8_t* v = valid + static_cast<size_t>(image) * K;

  float x1[SLOTS], y1[SLOTS], x2[SLOTS], y2[SLOTS], area[SLOTS], sc[SLOTS];
  int32_t cl[SLOTS];
  uint32_t active = 0, kept = 0;  // bit j <-> slot j

#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int k = j * kWarp + lane;
    x1[j] = y1[j] = x2[j] = y2[j] = area[j] = 0.f;
    sc[j] = 0.f;
    cl[j] = 0;
    if (k < K) {
      const float cx = b[4 * k + 0], cy = b[4 * k + 1];
      const float w = b[4 * k + 2], h = b[4 * k + 3];
      const float hw = __fmul_rn(w, 0.5f), hh = __fmul_rn(h, 0.5f);
      x1[j] = __fsub_rn(cx, hw);
      y1[j] = __fsub_rn(cy, hh);
      x2[j] = __fadd_rn(cx, hw);
      y2[j] = __fadd_rn(cy, hh);
      area[j] = __fmul_rn(w, h);  // center-format w*h, unclamped (parity)
      sc[j] = s[k];
      cl[j] = c[k];
      if (v[k]) active |= 1u << j;
    }
  }

  for (int step = 0; step < K; ++step) {
    // This lane's best active candidate; slots ascend in index, so a strict
    // '>' keeps the lowest index among equal scores.
    float best = -INFINITY;
    int best_k = INT_MAX;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int k = j * kWarp + lane;
      if (((active >> j) & 1u) &&
          (sc[j] > best || (sc[j] == best && k < best_k))) {
        best = sc[j];
        best_k = k;
      }
    }
    // Warp argmax over (score, -index); every lane ends with the same pair.
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int ok = __shfl_xor_sync(kFull, best_k, off);
      if (ob > best || (ob == best && ok < best_k)) {
        best = ob;
        best_k = ok;
      }
    }
    // No active candidate with a score above -inf: nothing more is kept
    // (pallas_nms.py:74 `found`).
    if (!(best > -INFINITY)) break;

    const int owner = best_k % kWarp, slot = best_k / kWarp;
    float ox1 = 0.f, oy1 = 0.f, ox2 = 0.f, oy2 = 0.f, oarea = 0.f;
    int32_t ocl = 0;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      if (j == slot) {
        ox1 = x1[j]; oy1 = y1[j]; ox2 = x2[j]; oy2 = y2[j];
        oarea = area[j]; ocl = cl[j];
      }
    }
    const float bx1 = __shfl_sync(kFull, ox1, owner);
    const float by1 = __shfl_sync(kFull, oy1, owner);
    const float bx2 = __shfl_sync(kFull, ox2, owner);
    const float by2 = __shfl_sync(kFull, oy2, owner);
    const float barea = __shfl_sync(kFull, oarea, owner);
    const int32_t bcl = __shfl_sync(kFull, ocl, owner);

#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      if (!((active >> j) & 1u)) continue;
      const int k = j * kWarp + lane;
      if (k == best_k) {
        kept |= 1u << j;
        active &= ~(1u << j);
        continue;
      }
      if (cl[j] != bcl) continue;
      const float iw = fmaxf(0.f, __fsub_rn(fminf(x2[j], bx2), fmaxf(x1[j], bx1)));
      const float ih = fmaxf(0.f, __fsub_rn(fminf(y2[j], by2), fmaxf(y1[j], by1)));
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(area[j], barea), inter);
      float iou;
      if (eps == 0.f) {
        iou = uni == 0.f ? 0.f : __fdiv_rn(inter, uni);
      } else {
        iou = __fdiv_rn(inter, __fadd_rn(uni, eps));
      }
      if (iou >= iou_threshold) active &= ~(1u << j);
    }
  }

  uint8_t* out = keep + static_cast<size_t>(image) * K;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int k = j * kWarp + lane;
    if (k < K) out[k] = static_cast<uint8_t>((kept >> j) & 1u);
  }
}

template <int SLOTS>
cudaError_t launch(const float* boxes, const float* scores, const int32_t* cls,
                   const uint8_t* valid, uint8_t* keep, int n, int K,
                   float iou_threshold, float eps, cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  nms_kernel<SLOTS><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
      boxes, scores, cls, valid, keep, n, K, iou_threshold, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Writes keep (n, K) for center-format boxes (n, K, 4). Returns a
// cudaError_t: cudaErrorInvalidValue for shapes the kernel does not take
// (K > 1024: 32 register slots of 32 lanes), otherwise the launch's status.
int yolo_nms(const void* boxes, const void* scores, const void* cls,
             const void* valid, void* keep, int n, int K,
             float iou_threshold, float eps, void* stream) {
  if (n < 0 || K < 0 || K > 32 * kWarp) return cudaErrorInvalidValue;
  if (n == 0 || K == 0) return cudaSuccess;
  const auto* bx = static_cast<const float*>(boxes);
  const auto* sc = static_cast<const float*>(scores);
  const auto* cl = static_cast<const int32_t*>(cls);
  const auto* va = static_cast<const uint8_t*>(valid);
  auto* kp = static_cast<uint8_t*>(keep);
  auto st = static_cast<cudaStream_t>(stream);
  const int slots = (K + kWarp - 1) / kWarp;
  if (slots <= 1) return launch<1>(bx, sc, cl, va, kp, n, K, iou_threshold, eps, st);
  if (slots <= 2) return launch<2>(bx, sc, cl, va, kp, n, K, iou_threshold, eps, st);
  if (slots <= 4) return launch<4>(bx, sc, cl, va, kp, n, K, iou_threshold, eps, st);
  if (slots <= 8) return launch<8>(bx, sc, cl, va, kp, n, K, iou_threshold, eps, st);
  if (slots <= 16) return launch<16>(bx, sc, cl, va, kp, n, K, iou_threshold, eps, st);
  return launch<32>(bx, sc, cl, va, kp, n, K, iou_threshold, eps, st);
}

const char* yolo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
