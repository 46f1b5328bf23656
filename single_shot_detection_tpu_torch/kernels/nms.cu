// Batched exact greedy NMS keep mask for Hopper (sm_90a).
//
// Replaces single_shot_detection_tpu/ops/nms_pallas.py::_nms_block_kernel
// (launched by nms_keep_batched).  Semantics are that kernel's: N independent
// problems, each K candidates sorted by score descending; a box is suppressed
// when its IoU with a kept earlier box is strictly greater than the
// threshold; a NaN IoU never suppresses; keep = not suppressed and
// score > -inf.  A -inf candidate still suppresses later boxes until it is
// itself suppressed, as in the reference.  Plain PyTorch version:
// ops/nms.py::nms_keep_sorted.
//
// What bounds it.  At the flagship shape (N = 32 images x 20 classes,
// K = 100) the kernel reads 1.28 MB: well under a microsecond of HBM time.
// The pairwise test is K(K-1)/2 pairs of about 13 float operations, also
// under a microsecond at the card's rate.  640 problems fill the card in a
// single wave (about 5 per SM), so the kernel's time is one problem's
// latency: staging, matrix build and greedy sweep, plus the launch.  The
// design shortens that critical path.  wgmma, TMA and clusters do not pay
// here: 1.6 KB per problem is read once, and a boolean IoU matrix is not a
// matrix product.  What the card offers is shared memory, registers and
// warp votes and shuffles.
//
// Design, one block of kWarps = 4 warps per problem:
// 1. Stage all K boxes and their areas in shared memory in one pass, with
//    a ballot of `score > -inf` per 32 candidates.  n = 1 + the index of
//    the last valid candidate.  Build and sweep cover [0, n) only, and
//    candidates from n on get keep = 0.  This is exact for any order of
//    scores: a candidate after the last valid one can only suppress later
//    candidates, all of them invalid and never kept.
// 2. Suppression matrix as bits (row i holds bit j for every j > i that box
//    i would suppress), in 32-bit chunks of 32 columns.  Lane l of a warp
//    owns row 32r + l of a row chunk r and keeps that box in registers.
//    For each column chunk c > r the lanes step over its columns j together
//    (box j is one broadcast read) and OR bit j into their row's chunk, so
//    every lane does useful work.  The diagonal 32 x 32 tile is resolved in
//    m/2 steps (m valid rows) instead of m: the IoU test is symmetric bit
//    for bit (fmax/fmin and IEEE addition commute), so at step d lane l
//    tests the pair (l, (l + d) mod m) and a ballot hands a wrapped result
//    to the lower row of the pair.  The steps of all row chunks are dealt to
//    the warps in equal contiguous ranges (K=100: 158 steps of 32 pairs for
//    4950 pairs), and a warp ORs each finished chunk into the matrix with
//    one shared-memory atomic.
// 3. Division-free threshold test (see `fast_test`).
// 4. Greedy sweep on one warp with `removed` in registers: lane w holds word
//    w (64 candidates), so K <= 2048.  For word b every lane takes lane b's
//    word and holds the diagonal words of candidates l and l + 32 of the
//    word in registers.  The greedy order inside the word is resolved in
//    rounds: an alive candidate that no alive candidate suppresses is kept
//    (the lowest alive one always is), and what the kept ones suppress
//    dies; each round is two warp OR-reductions.  Then each lane w > b ORs
//    the kept rows' word w into its own register.  No per-candidate
//    barrier, no read-modify-write of shared memory.  A serial __ffsll loop
//    over the kept candidates would pay a dependent shared-memory read per
//    kept box (about two thirds of the candidates are kept at the
//    flagship's inputs), and it was the slower design on the card.
// The matrix takes K * ceil(K/64) words: 1.6 KB at K=100.  When it does not
// fit in a block's shared memory with the boxes (K above about 1280), it
// lives in a scratch buffer the wrapper allocates; boxes stay in shared
// memory (40 KB at K=2048).
//
// Problems per block.  One block of 4 warps per problem.  With one warp per
// problem the build of a problem runs serially on too few lanes while the
// grid (640 problems at b32) leaves most of the card idle; 2 and 8 warps
// were slower than 4 at b32 as well.  Fewer warps pay only once the grid
// fills the card (thousands of problems), and there by little, so the
// count is a constant.
//
// Exactness.  The IoU is the reference's: area = max(x1-x0,0)*max(y1-y0,0),
// the intersection likewise, union = (a_i + a_j) - inter, iou = inter /
// union rounded to nearest, `iou > thr`, NaN never passing.  The file is
// built with --fmad=false and uses _rn intrinsics, so nothing is contracted.
// `fast_test` decides `fl(inter / uni) > thr` without dividing on almost
// every pair; see its comment for the bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the sweep keeps one 64-bit word of `removed` per lane
constexpr int kMaxK = 64 * 32;
// warps per problem (one block each)
constexpr int kWarps = 4;
constexpr unsigned kAll = 0xffffffffu;
// Shared memory a block may use on sm_90 (227 KB).
constexpr size_t kMaxSharedBytes = 232448;

// The threshold and the guard band of the division-free test.
struct Threshold {
  float thr;
  float hi;  // thr + 3 float steps, or +inf: never decide without dividing
  float lo;  // thr - 2 float steps, or -inf
};

__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// NaN if any coordinate is NaN (max_nan propagates it, like jnp.maximum).
__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.0f),
                   max_nan(__fsub_rn(b.w, b.y), 0.0f));
}

// Intersection and union of two boxes in the reference's order.  Symmetric
// in (a, b) bit for bit: fmaxf/fminf and IEEE addition commute.  fmaxf/fminf
// drop a NaN operand where jnp.maximum/minimum would return it, but a NaN
// coordinate makes that box's area NaN, so the union is NaN and the test
// below is false either way.
struct Overlap {
  float inter, uni;
};

__device__ __forceinline__ Overlap overlap(float4 a, float area_a, float4 b,
                                           float area_b) {
  const float ix0 = fmaxf(a.x, b.x);
  const float iy0 = fmaxf(a.y, b.y);
  const float ix1 = fminf(a.z, b.z);
  const float iy1 = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(ix1, ix0), 0.0f),
                                fmaxf(__fsub_rn(iy1, iy0), 0.0f));
  return {inter, __fsub_rn(__fadd_rn(area_a, area_b), inter)};
}

// Area of a box as the division-free test takes it: NaN unless it is 0 or
// in [2^-59, 2^59] (so also for a NaN or infinite area), which sends every
// pair with that box to the IEEE division.
__device__ __forceinline__ float fast_area(float area) {
  return (area == 0.0f || (area >= 0x1p-59f && area <= 0x1p59f))
             ? area : __int_as_float(0x7fc00000);
}

// iou > thr without a division, where that is certain; `unsure` otherwise.
// `o` is the overlap with both areas from `fast_area`.
//
// With both areas in {0} U [2^-59, 2^59] the union is 0 (both areas 0:
// unsure below) or in [2^-60, 2^60], since inter <= min(areas).  With thr in
// [2^-60, 2^60] every product below is then a normal float, so fl(uni * h)
// lies within a factor (1 +- 2^-24) of uni * h.
//  * inter > fl(uni * hi) gives r = inter / uni > hi (1 - 2^-24) > t+, the
//    next float above thr, since hi >= t+ + 2 ulp(t+) > t+ (1 + 2^-23).
//    Rounding is monotone, so fl(r) >= t+ > thr.
//  * inter < fl(uni * lo) gives r < lo (1 + 2^-24) < thr, since
//    thr >= lo + 2 ulp(lo) > lo (1 + 2^-23); so fl(r) <= thr.
// Neither holds when r is within a few ulps of thr, when the union is 0 or
// NaN (an area outside the range), or when thr is outside its range (then
// hi = +inf and lo = -inf): the pair is unsure, and `exact_test` decides.
__device__ __forceinline__ bool fast_test(Overlap o, Threshold t, bool* unsure) {
  const bool above = o.inter > __fmul_rn(o.uni, t.hi);
  const bool below = o.inter < __fmul_rn(o.uni, t.lo);
  *unsure = !(above || below);
  return above;
}

// iou > thr with the IEEE division, as the reference: NaN compares false.
__device__ __forceinline__ bool exact_test(Overlap o, Threshold t) {
  return __fdiv_rn(o.inter, o.uni) > t.thr;
}

// OR of `x` over the warp.
__device__ __forceinline__ unsigned long long or_all(unsigned long long x) {
  return static_cast<unsigned long long>(
             __reduce_or_sync(kAll, static_cast<unsigned>(x))) |
         static_cast<unsigned long long>(
             __reduce_or_sync(kAll, static_cast<unsigned>(x >> 32))) << 32;
}

// The OR of row words r0 and r1 of candidates c0 and c1 whose bits are set
// in `set`.
__device__ __forceinline__ unsigned long long pick(unsigned long long set,
                                                   int c0, int c1,
                                                   unsigned long long r0,
                                                   unsigned long long r1) {
  return (((set >> c0) & 1ull) ? r0 : 0ull) | (((set >> c1) & 1ull) ? r1 : 0ull);
}

__host__ __device__ inline int words_for(int k) { return (k + 63) / 64; }

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Shared layout: boxes (float4) | areas | fast_area of each | validity
// ballots | kept words | per-warp last valid index | matrix (when in shared
// memory).
struct Layout {
  size_t areas, fast, valid, kept, last, mask, total;
};

__host__ __device__ inline Layout layout(int k, bool mask_in_shared) {
  Layout l;
  l.areas = static_cast<size_t>(k) * 16;
  l.fast = l.areas + static_cast<size_t>(k) * 4;
  l.valid = l.fast + static_cast<size_t>(k) * 4;
  l.kept = align16(l.valid + static_cast<size_t>((k + 31) / 32) * 4);
  l.last = l.kept + 32 * 8;
  l.mask = align16(l.last + kWarps * 4);
  l.total = l.mask + (mask_in_shared ? static_cast<size_t>(k) * words_for(k) * 8
                                     : 0);
  return l;
}

// Bits of columns [j0, j1) (within one 32-column chunk) that box (bi, ai,
// fi = fast_area(ai)) suppresses.  A whole chunk is one unrolled run of
// fast tests; if any pair in it is unsure, the chunk is redone with the
// IEEE division.
__device__ __forceinline__ unsigned column_bits(
    float4 bi, float ai, float fi, const float4* sbox, const float* sarea,
    const float* sfast, int j0, int j1, Threshold t) {
  unsigned bits = 0u;
  bool unsure = false;
  if (j1 - j0 == 32) {
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      bool u;
      if (fast_test(overlap(bi, fi, sbox[j0 + q], sfast[j0 + q]), t, &u))
        bits |= 1u << q;
      unsure |= u;
    }
  } else {
    for (int j = j0; j < j1; ++j) {
      bool u;
      if (fast_test(overlap(bi, fi, sbox[j], sfast[j]), t, &u))
        bits |= 1u << (j & 31);
      unsure |= u;
    }
  }
  if (unsure) {
    bits = 0u;
    for (int j = j0; j < j1; ++j)
      if (exact_test(overlap(bi, ai, sbox[j], sarea[j]), t)) bits |= 1u << (j & 31);
  }
  return bits;
}

// Build steps of row chunk r over the prefix [0, n): m/2 diagonal steps
// (m valid rows in the chunk) and one step per column after the chunk.
__device__ __forceinline__ int chunk_steps(int r, int n) {
  const int m = min(32, n - 32 * r);
  return (m >> 1) + max(0, n - 32 * r - 32);
}

// kShared: the suppression matrix in shared memory; otherwise in `scratch`.
template <bool kShared>
__global__ void __launch_bounds__(32 * kWarps)
nms_keep_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores,
                uint8_t* __restrict__ keep,
                unsigned long long* __restrict__ scratch,
                int k, Threshold t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(k, kShared);
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(smem + lay.areas);
  float* sfast = reinterpret_cast<float*>(smem + lay.fast);
  unsigned* svalid = reinterpret_cast<unsigned*>(smem + lay.valid);
  unsigned long long* skept = reinterpret_cast<unsigned long long*>(smem + lay.kept);
  int* slast = reinterpret_cast<int*>(smem + lay.last);
  const int words = words_for(k);
  const size_t problem = blockIdx.x;
  unsigned long long* mask =
      kShared ? reinterpret_cast<unsigned long long*>(smem + lay.mask)
              : scratch + problem * k * words;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // 1. Stage boxes and areas, ballot the valid candidates, find the prefix.
  const float4* src = boxes + problem * k;
  const float* score = scores + problem * k;
  int last = -1;  // uniform in the warp
  for (int base = warp * 32; base < k; base += blockDim.x) {
    const int i = base + lane;
    bool valid = false;
    if (i < k) {
      const float4 b = src[i];
      sbox[i] = b;
      sarea[i] = box_area(b);
      sfast[i] = fast_area(sarea[i]);
      valid = score[i] > -INFINITY;
    }
    const unsigned ballot = __ballot_sync(kAll, valid);
    if (lane == 0) svalid[base >> 5] = ballot;
    if (ballot) last = base + 31 - __clz(ballot);
  }
  if (lane == 0) slast[warp] = last;
  if (kShared) {
    for (int w = threadIdx.x; w < k * words; w += blockDim.x) mask[w] = 0ull;
  }
  __syncthreads();
  int n = -1;
  for (int w = 0; w < kWarps; ++w) n = max(n, slast[w]);
  n += 1;
  uint8_t* out = keep + problem * k;
  if (n == 0) {
    for (int i = threadIdx.x; i < k; i += blockDim.x) out[i] = 0;
    return;
  }
  if (!kShared) {
    for (size_t w = threadIdx.x; w < static_cast<size_t>(n) * words; w += blockDim.x)
      mask[w] = 0ull;
    __syncthreads();
  }

  // 2. Suppression matrix: this warp's equal share of the build steps.
  unsigned* mask32 = reinterpret_cast<unsigned*>(mask);
  const int chunks = (n + 31) >> 5;
  int total = 0;
  for (int r = 0; r < chunks; ++r) total += chunk_steps(r, n);
  const int t0 = total * warp / kWarps;
  const int t1 = total * (warp + 1) / kWarps;
  int r = 0, first = 0;  // first: global index of chunk r's first step
  while (r < chunks && first + chunk_steps(r, n) <= t0) first += chunk_steps(r++, n);
  for (int step = t0; step < t1; ++r) {
    const int m = min(32, n - 32 * r);
    const int diag = m >> 1;
    const int steps = chunk_steps(r, n);
    const int s0 = step - first;
    const int s1 = min(t1 - first, steps);
    const bool live = lane < m;
    const int row = 32 * r + lane;
    const float4 bi = sbox[live ? row : 0];
    const float ai = sarea[live ? row : 0];
    const float fi = sfast[live ? row : 0];
    unsigned* row_bits = mask32 + static_cast<size_t>(row) * words * 2;
    if (s0 < diag) {
      // diagonal tile: lane l tests (l, (l + d) mod m)
      unsigned bits = 0u;
      for (int d = s0 + 1; d <= min(s1, diag); ++d) {
        int j = lane + d;
        const bool wrapped = j >= m;
        if (wrapped) j -= m;
        bool hit = false, unsure = false;
        if (live) {
          const float4 bj = sbox[32 * r + j];
          hit = fast_test(overlap(bi, fi, bj, sfast[32 * r + j]), t, &unsure);
          if (unsure) hit = exact_test(overlap(bi, ai, bj, sarea[32 * r + j]), t);
        }
        if (hit && !wrapped) bits |= 1u << j;
        // lane l < d is the lower row of the pair lane l - d + m wrapped to
        const unsigned votes = __ballot_sync(kAll, hit);
        const int from = lane - d + m;
        if (lane < d && ((votes >> from) & 1u)) bits |= 1u << from;
      }
      if (live && bits) atomicOr(row_bits + r, bits);
    }
    // columns after the chunk, one 32-column chunk at a time
    int j = 32 * (r + 1) + max(s0 - diag, 0);
    const int j1 = 32 * (r + 1) + (s1 - diag);
    while (j < j1) {
      const int end = min(j1, (j & ~31) + 32);
      if (live) {
        const unsigned bits = column_bits(bi, ai, fi, sbox, sarea, sfast, j, end, t);
        if (bits) atomicOr(row_bits + (j >> 5), bits);
      }
      j = end;
    }
    step = first + s1;
    first += steps;
  }
  __syncthreads();

  // 3. Greedy sweep, one warp, lane w holding word w of `removed`.
  if (warp == 0) {
    const int nw = (n + 63) >> 6;
    unsigned long long removed = 0ull;
    for (int b = 0; b < nw; ++b) {
      const unsigned long long cur = __shfl_sync(kAll, removed, b);
      const int left = n - 64 * b;
      unsigned long long alive = (left >= 64 ? ~0ull : (1ull << left) - 1) & ~cur;
      unsigned long long kept = 0ull;
      const unsigned long long* rows = mask + static_cast<size_t>(64 * b) * words;
      // lane l holds the diagonal words of candidates l and l + 32
      const int c0 = lane, c1 = lane + 32;
      const unsigned long long d0 = c0 < left ? rows[c0 * words + b] : 0ull;
      const unsigned long long d1 = c1 < left ? rows[c1 * words + b] : 0ull;
      while (alive) {
        // an alive candidate that no alive one suppresses is kept; the
        // lowest alive one always is
        const unsigned long long now = alive & ~or_all(pick(alive, c0, c1, d0, d1));
        kept |= now;
        alive &= ~(now | or_all(pick(now, c0, c1, d0, d1)));
      }
      for (int w = b + 1; w < nw; ++w) {
        const unsigned long long later = or_all(pick(
            kept, c0, c1, c0 < left ? rows[c0 * words + w] : 0ull,
            c1 < left ? rows[c1 * words + w] : 0ull));
        if (lane == w) removed |= later;
      }
      if (lane == 0) skept[b] = kept;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    out[i] = (i < n && ((skept[i >> 6] >> (i & 63)) & 1ull) &&
              ((svalid[i >> 5] >> (i & 31)) & 1u)) ? 1 : 0;
  }
}

// The launch floor: the same grid, block and shared memory, no work.
__global__ void nms_floor_kernel() {}

bool mask_in_shared(int k) { return layout(k, true).total <= kMaxSharedBytes; }

Threshold make_threshold(float thr) {
  Threshold t{thr, INFINITY, -INFINITY};
  if (thr >= 0x1p-60f && thr <= 0x1p60f) {  // false for NaN
    t.hi = nextafterf(nextafterf(nextafterf(thr, INFINITY), INFINITY), INFINITY);
    t.lo = nextafterf(nextafterf(thr, -INFINITY), -INFINITY);
  }
  return t;
}

// Checks the arguments and sets the shared-memory limit; returns the
// dynamic shared bytes through `smem`.
template <typename Kernel>
int prepare(Kernel kernel, long long n, int k, int device, bool in_shared,
            size_t* smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || n > 0x7fffffffLL || k <= 0 || k > kMaxK)
    return cudaErrorInvalidValue;
  *smem = layout(k, in_shared).total;
  if (*smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (*smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(*smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Words of device scratch each problem needs: 0 when the whole problem fits
// in shared memory, else K * ceil(K/64) 64-bit words.
extern "C" long long nms_keep_scratch_words(int k) {
  if (mask_in_shared(k)) return 0;
  return static_cast<long long>(k) * static_cast<long long>(words_for(k));
}

// boxes [n, k, 4] f32, scores [n, k] f32, keep [n, k] bool (1 byte each),
// scratch: n * nms_keep_scratch_words(k) words or null; k <= 2048.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int nms_keep_launch(const void* boxes, const void* scores,
                               void* keep, void* scratch, long long n, int k,
                               float thr, int device, void* stream) {
  const bool in_shared = mask_in_shared(k);
  if (!in_shared && scratch == nullptr) return cudaErrorInvalidValue;
  auto kernel = in_shared ? nms_keep_kernel<true> : nms_keep_kernel<false>;
  size_t smem = 0;
  const int err = prepare(kernel, n, k, device, in_shared, &smem);
  if (err) return err;
  kernel<<<static_cast<unsigned int>(n), 32 * kWarps, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<uint8_t*>(keep),
      static_cast<unsigned long long*>(scratch), k, make_threshold(thr));
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the grid, block and shared memory of nms_keep_launch.
extern "C" int nms_floor_launch(long long n, int k, int device, void* stream) {
  size_t smem = 0;
  const int err = prepare(nms_floor_kernel, n, k, device, mask_in_shared(k),
                          &smem);
  if (err) return err;
  nms_floor_kernel<<<static_cast<unsigned int>(n), 32 * kWarps, smem,
                     static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
