// Per-class greedy NMS as a parallel suppression mask and a short bit scan,
// one block per image, for Hopper (sm_90a).
//
// Replaces the TPU kernel yolo_tpu/ops/pallas_nms.py::_nms_kernel (entry
// pallas_nms). The JAX kernel selects: repeat until no candidate is active
//   best <- the active candidate with the highest score (ties: lowest index)
//   keep[best] = true
//   deactivate every active candidate of best's class with IoU(best) >= t.
// Its exact equivalent, used here: take the eligible candidates (valid, score
// > -inf) in descending (score, -index) order; one that no kept candidate has
// suppressed is kept, and suppresses every later candidate of its class with
// IoU >= t. Suppression never crosses classes, so the order may put the class
// first: sorted by (class, score descending, index), each class is a
// contiguous segment and only pairs inside a segment need an IoU. The keep
// mask equals yolo_tpu/ops/nms.py::batched_nms bit for bit.
//
// What bounds it: latency, not bytes or arithmetic. An image is a few KB
// (K = 98 for the 7x7x2 grid) and its work is at most K^2/2 IoUs. The first
// design (one warp an image, K dependent argmax steps of ~0.75 us each) took
// 0.0735 ms at every batch on an H100 80GB HBM3 at 700 W. This one takes the
// K-step chain apart:
//   1. load: each thread reads its candidates, computes corners and area
//      (pallas_nms.py:131-135's op order) and a 64-bit sort key (class,
//      then score descending; -0.0 and 0.0 tie, as float == ties them);
//   2. rank: rank(i) = #{eligible j: key_j < key_i, or key_j == key_i and
//      j < i}, K compares a candidate against keys read from shared memory,
//      split over a group of up to 32 threads (4 at K = 98) and summed by
//      shuffles; each candidate's box lands at its rank;
//   3. mask: a warp a row; row a's word w holds, in bit b - 32w, whether
//      sorted candidate b > a (same class segment) has IoU(a, b) >= t, by
//      __ballot_sync over 32 lanes. Only the words of a's class segment are
//      computed; the rest of the row is zeroed. The IoU is pallas_nms.py:
//      90-93's, with __f*_rn (__d*_rn) so nvcc cannot contract it into an FMA;
//   4. scan: one warp; lane l holds removed-set word l in a register. For
//      each block of 32 sorted positions it takes the block's word, walks the
//      32 bits against the diagonal mask words (a test and an OR each), and
//      ORs into the later words (one lane a word) the rows of the kept
//      candidates whose class segment runs past the block: the others have
//      no bits there. No argmax, no IoU and no global traffic in the serial
//      part;
//   5. keep[i] = eligible(i) and not removed(rank(i)), by original index.
// The mask takes ceil(K/32) words a row: 16 bytes at K = 98, 128 KB at K =
// 1024 (dynamic shared memory above 48 KB, allowed once per device).
// On that card (chip_smoke.py phase 3, CUDA graphs) it takes 0.0072-0.0074
// ms at (1, 98) and 0.0077 at (16, 98), where an empty launch of the same
// grid takes 0.0010-0.0012: what is left is one block's chain of barriers
// and dependent shared-memory steps, the same at 1 and 64 images; 256
// images (two blocks an SM) take 0.0107-0.0108.
//
// Bit-exactness with the JAX kernel:
//   * corners, area and IoU use the JAX kernel's op order, written with
//     the _rn intrinsics (add_rn and its kin below); IoU(a, b) takes the later
//     candidate b where the JAX kernel takes the candidate and the kept a
//     where it takes best, so even the operand order is the same;
//   * the threshold and eps arrive already rounded to the element type, as
//     the JAX weak-typed compare uses them;
//   * eps == 0 selects the evaluator's IoU: inter / union with union == 0 -> 0
//     (yolo_tpu/ops/boxes.py:62-64).
//
// The kernel is a template on the element type. float is the serving path's
// and the fast evaluator's; double is the precise evaluator's, which JAX runs
// in float64 (yolo_tpu/metrics/map.py:149-157): the same steps with
// __d*_rn, a 128-bit sort key (class, then the double's ordered bits), the
// threshold and eps as doubles, and twice the shared memory for the boxes
// (189 KB at K = 1024).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCandidates = 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// The double instantiation's sort key: (class, ordered score bits) as two
// words, compared high word first.
struct Key128 {
  unsigned long long hi, lo;
};
__device__ __forceinline__ bool operator<(const Key128& a, const Key128& b) {
  return a.hi < b.hi || (a.hi == b.hi && a.lo < b.lo);
}
__device__ __forceinline__ bool operator==(const Key128& a, const Key128& b) {
  return a.hi == b.hi && a.lo == b.lo;
}
__device__ __forceinline__ bool operator!=(const Key128& a, const Key128& b) {
  return !(a == b);
}

// Per element type: the key, the key no eligible candidate has, and the
// key itself, class ascending, then score descending. An eligible key is
// never the ineligible one: that would need the all-ones bit pattern (float)
// or a class above 32 bits (double).
template <typename T>
struct Traits;

template <>
struct Traits<float> {
  using Key = unsigned long long;
  static __device__ __forceinline__ Key ineligible() { return ~0ull; }
  static __device__ __forceinline__ Key sort_key(float score, int32_t cls) {
    const uint32_t bits = score == 0.f ? 0u : __float_as_uint(score);  // -0.0 ties 0.0
    const uint32_t ordered = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
    return (static_cast<unsigned long long>(static_cast<uint32_t>(cls) ^ 0x80000000u) << 32) |
           static_cast<uint32_t>(~ordered);
  }
};

template <>
struct Traits<double> {
  using Key = Key128;
  static __device__ __forceinline__ Key ineligible() { return {~0ull, ~0ull}; }
  static __device__ __forceinline__ Key sort_key(double score, int32_t cls) {
    const unsigned long long bits =
        score == 0.0 ? 0ull : static_cast<unsigned long long>(__double_as_longlong(score));
    const unsigned long long sign = 1ull << 63;
    const unsigned long long ordered = (bits & sign) ? ~bits : (bits | sign);
    return {static_cast<uint32_t>(cls) ^ 0x80000000u, ~ordered};
  }
};

// Round-to-nearest arithmetic that nvcc cannot contract into an FMA.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double min_(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ double max_(double a, double b) { return fmax(a, b); }

// Bytes of dynamic shared memory for K candidates: sort keys, the sorted
// boxes (x1, y1, x2, y2, area), their classes, the segment-end words, the
// removed words and the mask (K rows of ceil(K/32) words at most).
template <typename T>
size_t smem_bytes(int K) {
  using Key = typename Traits<T>::Key;
  const size_t k = static_cast<size_t>(K), w = (k + 31) / 32;
  return k * sizeof(Key) + k * sizeof(T) * 5 + k * 4 + w * 4 + 32 * 4 + k * w * 4;
}

template <typename T, int SLOTS>
__global__ void __launch_bounds__(kThreads)
nms_kernel(const T* __restrict__ boxes,         // (n, K, 4) cx, cy, w, h
           const T* __restrict__ scores,        // (n, K)
           const int32_t* __restrict__ cls,     // (n, K)
           const uint8_t* __restrict__ valid,   // (n, K) 0/1
           uint8_t* __restrict__ keep,          // (n, K) 0/1
           int K, T iou_threshold, T eps) {
  using Key = typename Traits<T>::Key;
  const Key kIneligible = Traits<T>::ineligible();
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) >> 5;
  auto* key = reinterpret_cast<Key*>(smem);
  T* sx1 = reinterpret_cast<T*>(key + K);
  T* sy1 = sx1 + K;
  T* sx2 = sy1 + K;
  T* sy2 = sx2 + K;
  T* sarea = sy2 + K;
  auto* scls = reinterpret_cast<int32_t*>(sarea + K);
  auto* ends = reinterpret_cast<uint32_t*>(scls + K);  // bit r: r ends its class
  uint32_t* removed_words = ends + W;                   // the scan's result
  uint32_t* mask = removed_words + 32;                  // rows of Wm words

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * K;
  // A group of 2^gshift threads (at most a warp, K * 2^gshift <= kThreads
  // when K <= kThreads) takes one candidate: its leader (part 0) loads it
  // and places it, and each member counts every 2^gshift-th key for its rank.
  int gshift = 0;
  while (gshift < 5 && (K << (gshift + 1)) <= kThreads) ++gshift;
  const int part = tid & ((1 << gshift) - 1);
  const int per_pass = kThreads >> gshift;

  // 1. Load, corners, area, keys.
  T x1[SLOTS], y1[SLOTS], x2[SLOTS], y2[SLOTS], area[SLOTS];
  int32_t cl[SLOTS];
  Key ky[SLOTS];
  int M = 0;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int i = j * per_pass + (tid >> gshift);
    ky[j] = kIneligible;
    x1[j] = y1[j] = x2[j] = y2[j] = area[j] = T(0);
    cl[j] = 0;
    if (part == 0 && i < K) {
      const T* b = boxes + (base + i) * 4;
      const T cx = b[0], cy = b[1], w = b[2], h = b[3];
      const T hw = mul_rn(w, T(0.5)), hh = mul_rn(h, T(0.5));
      x1[j] = sub_rn(cx, hw);
      y1[j] = sub_rn(cy, hh);
      x2[j] = add_rn(cx, hw);
      y2[j] = add_rn(cy, hh);
      area[j] = mul_rn(w, h);  // center-format w*h, unclamped (parity)
      cl[j] = cls[base + i];
      const T s = scores[base + i];
      // pallas_nms.py:74: a step whose best score is -inf keeps nothing more,
      // so a -inf (or NaN) candidate is never kept and never suppresses.
      if (valid[base + i] && s > -T(INFINITY)) ky[j] = Traits<T>::sort_key(s, cl[j]);
      key[i] = ky[j];
    }
  }
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) M += __syncthreads_count(ky[j] != kIneligible);

  // 2. Rank (each member its share of the keys, summed over the group), then
  // each eligible box to its place in sorted order.
  int rank[SLOTS];
  Key mine[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int i = j * per_pass + (tid >> gshift);
    rank[j] = 0;
    mine[j] = i < K ? key[i] : kIneligible;
  }
#pragma unroll 4
  for (int o = part; o < K; o += 1 << gshift) {
    const Key ko = key[o];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      rank[j] += (ko < mine[j]) | ((ko == mine[j]) & (o < j * per_pass + (tid >> gshift)));
    }
  }
  for (int off = (1 << gshift) >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) rank[j] += __shfl_xor_sync(kFull, rank[j], off);
  }
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    if (ky[j] != kIneligible) {  // only a leader holds a key
      const int r = rank[j];
      sx1[r] = x1[j];
      sy1[r] = y1[j];
      sx2[r] = x2[j];
      sy2[r] = y2[j];
      sarea[r] = area[j];
      scls[r] = cl[j];
    }
  }
  __syncthreads();

  // Class segment ends, one bit a sorted position.
  const int Wm = (M + 31) >> 5;
  for (int r0 = 0; r0 < Wm * 32; r0 += kThreads) {
    const int r = r0 + tid;
    const bool end = r < M && (r == M - 1 || scls[r + 1] != scls[r]);
    const uint32_t word = __ballot_sync(kFull, end);
    if (lane == 0 && (r >> 5) < Wm) ends[r >> 5] = word;
  }
  __syncthreads();

  // 3. The mask, a warp a row.
  for (int a = warp; a < M; a += kWarps) {
    int w = a >> 5;
    uint32_t e = ends[w] & (kFull << (a & 31));
    while (e == 0) e = ends[++w];  // position M - 1 ends a segment
    const int last = (w << 5) + __ffs(e) - 1;
    const T ax1 = sx1[a], ay1 = sy1[a], ax2 = sx2[a], ay2 = sy2[a], aarea = sarea[a];
    uint32_t* row = mask + a * Wm;
    for (int wd = a >> 5; wd <= (last >> 5); ++wd) {
      const int b = (wd << 5) + lane;
      bool hit = false;
      if (b > a && b <= last) {
        const T iw = max_(T(0), sub_rn(min_(sx2[b], ax2), max_(sx1[b], ax1)));
        const T ih = max_(T(0), sub_rn(min_(sy2[b], ay2), max_(sy1[b], ay1)));
        const T inter = mul_rn(iw, ih);
        const T uni = sub_rn(add_rn(sarea[b], aarea), inter);
        T iou;
        if (eps == T(0)) {
          iou = uni == T(0) ? T(0) : div_rn(inter, uni);
        } else {
          iou = div_rn(inter, add_rn(uni, eps));
        }
        hit = iou >= iou_threshold;
      }
      const uint32_t word = __ballot_sync(kFull, hit);
      if (lane == 0) row[wd] = word;
    }
    if (lane > (last >> 5) && lane < Wm) row[lane] = 0u;
  }
  __syncthreads();

  // 4. The scan, one warp.
  if (warp == 0) {
    uint32_t removed = 0u;  // lane l: sorted positions 32l .. 32l + 31
    for (int wb = 0; wb < Wm; ++wb) {
      uint32_t cur = __shfl_sync(kFull, removed, wb);
      const int r0 = wb << 5;
      const int count = min(32, M - r0);
      uint32_t d[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) d[j] = j < count ? mask[(r0 + j) * Wm + wb] : 0u;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (!((cur >> j) & 1u)) cur |= d[j];
      }
      // Only a kept row whose class segment runs past this block (the bits
      // above the block's last segment end) has bits in later words.
      const uint32_t kept = ~cur & (count == 32 ? kFull : ((1u << count) - 1u));
      const uint32_t e = ends[wb];
      const int high = e ? 31 - __clz(e) : -1;
      const uint32_t spread = kept & (high == 31 ? 0u : kFull << (high + 1));
      if (lane == wb) {
        removed = cur;
      } else if (lane > wb && lane < Wm && spread) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          if ((spread >> j) & 1u) removed |= mask[(r0 + j) * Wm + lane];
        }
      }
    }
    if (lane < Wm) removed_words[lane] = removed;
  }
  __syncthreads();

  // 5. keep by original index.
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int i = j * per_pass + (tid >> gshift);
    if (part == 0 && i < K) {
      const int r = rank[j];
      const bool kept = ky[j] != kIneligible && !((removed_words[r >> 5] >> (r & 31)) & 1u);
      keep[base + i] = static_cast<uint8_t>(kept);
    }
  }
}

// One empty block of `threads` threads a block: the least a launch of this
// grid costs, for reading the NMS kernel's time against (chip_smoke.py).
__global__ void empty_kernel() {}

template <typename T, int SLOTS>
cudaError_t launch(const T* boxes, const T* scores, const int32_t* cls,
                   const uint8_t* valid, uint8_t* keep, int n, int K,
                   T iou_threshold, T eps, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(K);
  if (smem > 48 * 1024) {
    // Allowed once per device, for the largest K this instantiation takes.
    static bool allowed[kMaxDevices] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= kMaxDevices || !allowed[device]) {
      err = cudaFuncSetAttribute(nms_kernel<T, SLOTS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem_bytes<T>(SLOTS * kThreads)));
      if (err != cudaSuccess) return err;
      if (device < kMaxDevices) allowed[device] = true;
    }
  }
  nms_kernel<T, SLOTS><<<n, kThreads, smem, stream>>>(boxes, scores, cls, valid, keep, K,
                                                      iou_threshold, eps);
  return cudaGetLastError();
}

template <typename T>
int nms_entry(const void* boxes, const void* scores, const void* cls, const void* valid,
              void* keep, int n, int K, T iou_threshold, T eps, void* stream) {
  if (n < 0 || K < 0 || K > kMaxCandidates) return cudaErrorInvalidValue;
  if (n == 0 || K == 0) return cudaSuccess;
  const auto* bx = static_cast<const T*>(boxes);
  const auto* sc = static_cast<const T*>(scores);
  const auto* cl = static_cast<const int32_t*>(cls);
  const auto* va = static_cast<const uint8_t*>(valid);
  auto* kp = static_cast<uint8_t*>(keep);
  auto st = static_cast<cudaStream_t>(stream);
  if (K <= kThreads) return launch<T, 1>(bx, sc, cl, va, kp, n, K, iou_threshold, eps, st);
  return launch<T, 2>(bx, sc, cl, va, kp, n, K, iou_threshold, eps, st);
}

}  // namespace

extern "C" {

// Writes keep (n, K) for center-format boxes (n, K, 4). Returns a
// cudaError_t: cudaErrorInvalidValue for shapes the kernel does not take
// (K > 1024: two candidates a thread of 512), otherwise the launch's status.
int yolo_nms(const void* boxes, const void* scores, const void* cls,
             const void* valid, void* keep, int n, int K,
             float iou_threshold, float eps, void* stream) {
  return nms_entry<float>(boxes, scores, cls, valid, keep, n, K, iou_threshold, eps, stream);
}

// yolo_nms for float64 boxes and scores (the precise evaluator's), with the
// threshold and eps as doubles.
int yolo_nms_f64(const void* boxes, const void* scores, const void* cls,
                 const void* valid, void* keep, int n, int K,
                 double iou_threshold, double eps, void* stream) {
  return nms_entry<double>(boxes, scores, cls, valid, keep, n, K, iou_threshold, eps, stream);
}

// Launches `blocks` empty blocks of `threads` threads on `stream`.
int yolo_empty(int blocks, int threads, void* stream) {
  if (blocks <= 0) return cudaSuccess;
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* yolo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
