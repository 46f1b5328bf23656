// Batched exact greedy NMS keep mask for Hopper (sm_90a).
//
// Replaces single_shot_detection_tpu/ops/nms_pallas.py::_nms_block_kernel
// (launched by nms_keep_batched).  Semantics are that kernel's: N independent
// problems, each K candidates sorted by score descending; a box is suppressed
// when its IoU with a kept earlier box is strictly greater than the
// threshold; a NaN IoU never suppresses; keep = not suppressed and
// score > -inf.  Plain PyTorch version: ops/nms.py::nms_keep_sorted.
//
// Design.  One block per problem.  The block stages the K boxes and their
// areas in shared memory, builds the suppression matrix as 64-bit words (row
// i holds bit j for every later box j that box i would suppress), then one
// warp runs the K-step greedy sweep over a `removed` bitmask, and the block
// writes the keep mask.  The matrix is K * ceil(K/64) words: 1.6 KB at the
// flagship's K=100.  When all of it does not fit in a block's shared memory
// (K above about 1280), the boxes are read from device memory, areas are
// recomputed per pair, and the matrix lives in a scratch buffer the wrapper
// allocates.
//
// Bound.  At the flagship shape (N = 32 images x 20 classes, K = 100) the
// kernel reads 1.28 MB and writes 64 KB, well under a microsecond of HBM
// time; the pairwise IoU work is K(K-1)/2 pairs per problem.  The sweep is a
// K-step chain per problem, so the kernel relies on many problems (one block
// each) being in flight at once to fill the card.
//
// Exactness.  The IoU is computed in the reference's order with
// round-to-nearest intrinsics and no fused multiply-add (the file is also
// built with --fmad=false): area = max(x1-x0,0)*max(y1-y0,0), the
// intersection likewise, union = (a_i + a_j) - inter, iou = inter / union,
// and the test is `iou > thr`, NaN never passing it.  So a decision at the
// threshold is the same as the plain version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// Shared memory a block may use on sm_90 (227 KB).
constexpr size_t kMaxSharedBytes = 232448;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// NaN if any coordinate is NaN (max_nan propagates it, like jnp.maximum).
__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.0f),
                   max_nan(__fsub_rn(b.w, b.y), 0.0f));
}

// iou(a, b) > thr.  fmaxf/fminf drop a NaN operand where jnp.maximum/minimum
// would return it, but a NaN coordinate makes that box's area NaN, so the
// union and the IoU are NaN and the test is false either way.
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float area_b, float thr) {
  const float ix0 = fmaxf(a.x, b.x);
  const float iy0 = fmaxf(a.y, b.y);
  const float ix1 = fminf(a.z, b.z);
  const float iy1 = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(ix1, ix0), 0.0f),
                                fmaxf(__fsub_rn(iy1, iy0), 0.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, uni) > thr;  // NaN compares false
}

__host__ __device__ inline size_t words_for(int k) {
  return (static_cast<size_t>(k) + 63) / 64;
}

__host__ __device__ inline size_t removed_bytes(int k) {
  // bitmask first, padded so the float4 boxes after it stay 16-byte aligned
  return (words_for(k) * 8 + 15) / 16 * 16;
}

// Shared layout: removed bitmask | boxes (float4) | areas | matrix.
__host__ __device__ inline size_t mask_offset(int k) {
  const size_t areas = (static_cast<size_t>(k) * 4 + 7) / 8 * 8;
  return removed_bytes(k) + static_cast<size_t>(k) * 16 + areas;
}

__host__ __device__ inline size_t all_shared_bytes(int k) {
  return mask_offset(k) + static_cast<size_t>(k) * words_for(k) * 8;
}

// kShared: boxes, their areas and the suppression matrix in shared memory;
// otherwise boxes are read from device memory, areas are recomputed per
// pair, and the matrix lives in `scratch`.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores,
                uint8_t* __restrict__ keep,
                unsigned long long* __restrict__ scratch,
                int k, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 63) >> 6;
  const size_t problem = blockIdx.x;
  const float4* src = boxes + problem * k;

  unsigned long long* removed = reinterpret_cast<unsigned long long*>(smem);
  const float4* bx = src;
  float* area = reinterpret_cast<float*>(smem + removed_bytes(k) + k * 16);
  unsigned long long* mask =
      kShared ? reinterpret_cast<unsigned long long*>(smem + mask_offset(k))
              : scratch + problem * k * words;
  if (kShared) {
    float4* sbox = reinterpret_cast<float4*>(smem + removed_bytes(k));
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      const float4 b = src[i];
      sbox[i] = b;
      area[i] = box_area(b);
    }
    bx = sbox;
  }
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0ull;
  __syncthreads();

  // Suppression matrix: one (row, word) item per thread at a time.
  const int items = k * words;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int i = item / words;
    const int w = item - i * words;
    const int j0 = max(w * 64, i + 1);
    const int j1 = min(w * 64 + 64, k);
    unsigned long long bits = 0ull;
    if (j0 < j1) {
      const float4 bi = bx[i];
      const float ai = kShared ? area[i] : box_area(bi);
      for (int j = j0; j < j1; ++j) {
        const float4 bj = bx[j];
        const float aj = kShared ? area[j] : box_area(bj);
        if (suppresses(bi, ai, bj, aj, thr)) bits |= 1ull << (j - w * 64);
      }
    }
    mask[item] = bits;
  }
  __syncthreads();

  // Greedy sweep: one warp; lane l owns words l, l+32, ...  Row i only sets
  // bits j > i, so reading bit i and OR-ing row i never touch the same bit.
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int i = 0; i < k; ++i) {
      const bool alive = !((removed[i >> 6] >> (i & 63)) & 1ull);
      __syncwarp();
      if (alive) {
        const unsigned long long* row = mask + static_cast<size_t>(i) * words;
        for (int w = (i >> 6) + lane; w < words; w += 32) removed[w] |= row[w];
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const bool kept = !((removed[i >> 6] >> (i & 63)) & 1ull);
    keep[problem * k + i] = (kept && scores[problem * k + i] > -INFINITY) ? 1 : 0;
  }
}

}  // namespace

// Words of device scratch each problem needs: 0 when the whole problem fits
// in shared memory, else K * ceil(K/64) 64-bit words.
extern "C" long long nms_keep_scratch_words(int k) {
  if (all_shared_bytes(k) <= kMaxSharedBytes) return 0;
  return static_cast<long long>(k) * static_cast<long long>(words_for(k));
}

// boxes [n, k, 4] f32, scores [n, k] f32, keep [n, k] bool (1 byte each),
// scratch: n * nms_keep_scratch_words(k) words or null.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int nms_keep_launch(const void* boxes, const void* scores,
                               void* keep, void* scratch, long long n, int k,
                               float thr, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || k <= 0 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool in_shared = all_shared_bytes(k) <= kMaxSharedBytes;
  if (!in_shared && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t smem = in_shared ? all_shared_bytes(k) : removed_bytes(k);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  auto kernel = in_shared ? nms_keep_kernel<true> : nms_keep_kernel<false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned int>(n), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<uint8_t*>(keep),
      static_cast<unsigned long long*>(scratch), k, thr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
