// Train-mode BatchNorm for Hopper (sm_90a): four kernels, K1-K4, on NCHW
// activations as they come out of the port's convolutions.
//
// Replaces the four Pallas kernels of
// single_shot_detection_tpu/ops/bn_pallas.py:
//   K1 bn_stats      <- _stats_kernel      (per-channel sum x, sum x^2)
//   K2 bn_apply      <- _apply_kernel      (z = (x - mean) * rstd * scale + bias)
//   K3 bn_grad_sums  <- _grad_sums_kernel  (d_beta = sum dz, d_gamma = sum dz * xhat)
//   K4 bn_dx         <- _dx_kernel         (dx = r*g * (dz - d_beta/N - xhat * d_gamma/N))
// Plain PyTorch versions: ops/bn_kernel.py (bn_stats_plain, ...).
//
// Layout.  x is [B, C, H, W] contiguous; channel c reduces over B*H*W
// elements that lie in B runs ("planes") of S = H*W contiguous elements,
// C*S apart.  The kernels read that layout as it is: converting to
// channels-last or [N*H*W, C] around every BN would cost a full read and
// write of the activation each way, which is what made the Pallas version a
// loss on the TPU.
//
// Bound.  All four are bound by bytes: K1 reads x (4E bytes in f32 for E
// elements), K2 reads x and writes z (8E), K3 reads dz and x (8E), K4 reads
// dz and x and writes dx (12E).  Each does a few flops per element, far
// below the card's rate, so the design goal is to keep enough loads in
// flight and to spend few instructions per element on addressing.
//
// Reductions (K1, K3): one launch per call.  Blocks run in no order on
// Hopper, so the Pallas kernels' sequential-grid accumulator becomes a sum
// in a fixed order, taken by one of four paths chosen from the shape
// (make_plan):
//   vector  S % 4 == 0 and aligned: 4 elements per load;
//   split   S % 4 != 0 (or a pointer off 16 bytes): per plane, 4-element
//           loads on the aligned body, the few elements at its two edges
//           as scalars;
//   scalar  one element per load (the inputs of K3 aligned differently);
//   narrow  S < 32: a block takes a tile of channels, neighbouring threads
//           take neighbouring [c, s] addresses and loop over b, so a warp
//           reads whole runs of C*S instead of runs of S; one warp per
//           channel then sums its partials.
// On the first three each thread keeps 4 (8 for scalars) loads in flight in
// independent accumulators, summed in a fixed tree, and warp shuffles and
// shared memory in a fixed order give each block's partial.  A channel's G
// blocks (size_wide) then combine: G == 1 needs no step; up to 16 blocks
// form a thread-block cluster (cudaLaunchKernelEx with a cluster
// dimension), whose rank 0 reads the partials through distributed shared
// memory after cluster.sync(); a longer channel (the largest layers, which
// need many short blocks for the card to balance them) takes blocks of
// 8192 elements whose last to finish, by an atomic ticket, sums the
// partials from a scratch buffer the library keeps per stream.  Atomics
// count tickets only and never sum, so a result does not change from run
// to run.

// Elementwise passes (K2, K4).  They read the contiguous tensors as one
// flat run of 16-byte vectors (V = 4 elements at f32, 8 at bf16, by x's
// type; a bf16 x into an f32 z stores two 16-byte vectors), not as planes,
// so every plane size moves 16 bytes a load.  A vector starting at flat
// element e lies in channel (e / S) % C; where S >= V at most one plane
// boundary falls inside it, so its lanes take one channel's coefficients or
// two (vector path); planes shorter than a vector give each lane its own
// channel (lanes path).  The elements before the first 16-byte boundary and
// a tail short of a vector go one at a time; inputs and output at different
// phases take the one-element path (scalar).  Each block takes a contiguous
// chunk of one or two batches; a thread issues every load of its batch (K2
// two vectors, K4 one vector of each input) before its first store.  The
// grid is sized from the card: small layers spread over its resident
// blocks, large ones take many short blocks, which the card balances (on
// the largest layers one wave of long chunks was slower).  The
// block's first loads are in flight while its threads fill a shared table
// with the per-channel coefficients of each plane its chunk covers, so a
// vector finds its plane by one 32-bit multiply-shift division and reads
// its coefficients from shared memory, with no 64-bit division on the way.

// Numerics.  Statistics, sums and coefficients are f32; x, dz, z and dx may
// be f32 or bf16 (z in the output type, dx in x's type).  The file is built
// with --fmad=false and never --use_fast_math, so each product and sum is
// rounded as the plain PyTorch version rounds it; only the order of the
// reductions differs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <mutex>
#include <type_traits>
#include <utility>
#include <vector>

namespace {

namespace cg = cooperative_groups;

// dtype codes shared with ops/bn_kernel.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements moved by one load or store (16 bytes for 4 x f32).
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, long long i,
                                     float (&out)[V]) {
  const Vec<T, V> a = reinterpret_cast<const Vec<T, V>*>(p)[i];
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = to_float(a.v[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, long long i,
                                      const float (&in)[V]) {
  Vec<T, V> a;
#pragma unroll
  for (int k = 0; k < V; ++k) a.v[k] = from_float<T>(in[k]);
  reinterpret_cast<Vec<T, V>*>(p)[i] = a;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ------------------------------------------------------------- K1, K3

// Paths of the reductions (codes shared with ops/bn_kernel.py).
constexpr int kPathAuto = -1;
constexpr int kPathVector = 0;
constexpr int kPathSplit = 1;
constexpr int kPathScalar = 2;
constexpr int kPathNarrow = 3;

constexpr int kMaxThreads = 1024;       // narrow blocks
constexpr int kMaxWideThreads = 512;    // wide blocks (at 1024 the compiler
                                        // gives K1 a quarter more registers)
constexpr int kMaxCluster = 16;         // 8 is portable; 16 needs the opt-in
constexpr int kNarrowPlane = 32;        // S below this takes the narrow path
constexpr int kNarrowThreads = 256;     // a narrow block's target size
constexpr int kNarrowRowsPerThread = 4;

// One load's values: N inputs of V elements each.
template <int N, int V>
struct Item {
  float v[N][V];
};

// Sums v in a fixed tree, ((v0 + v1) + (v2 + v3)) + ...
template <int N>
__device__ __forceinline__ float tree_sum(float (&v)[N]) {
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) v[i] += v[i + w];
  return v[0];
}

// Sum of (a, b) over the block (blockDim.x a multiple of 32), in a fixed
// order; the result is valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[32], sb[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    a = lane < warps ? sa[lane] : 0.0f;
    b = lane < warps ? sb[lane] : 0.0f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

// Walks one channel's units j = start, start + step, ... in [B, C, S],
// plane b holding units k = 0 .. K-1: `e` is the element offset of plane b's
// start and `k` the unit within it (no division per unit).
struct PlaneCursor {
  long long e, k, per_plane, r, jump, plane;
  __device__ PlaneCursor(long long j, long long c, long long C, long long S,
                         long long K, long long step) {
    const long long b = j / K;
    per_plane = K;
    k = j - b * K;
    plane = C * S;
    e = (b * C + c) * S;
    const long long q = step / K;
    r = step - q * K;
    jump = q * plane;
  }
  __device__ __forceinline__ void advance() {
    k += r;
    e += jump;
    if (k >= per_plane) {
      k -= per_plane;
      e += plane;
    }
  }
};

// Elements from plane start e to the first 4-element boundary, for inputs
// whose element 0 lies `phase` elements past a boundary.
__device__ __forceinline__ long long head(long long e, int phase) {
  return (-(e + phase)) & 3;
}

// K1's work: the sums of x and x * x; mean, var and rstd from them.
template <typename T>
struct StatsOp {
  static constexpr int kInputs = 1;
  const T* x;
  float* mean;
  float* var;
  float* rstd;
  float n, eps;

  struct Channel {
    const T* __restrict__ x;
    template <int V>
    __device__ __forceinline__ void read(long long e, Item<1, V>& it) const {
      load<T, V>(x + e, 0, it.v[0]);
    }
    template <int V>
    __device__ __forceinline__ void add(const Item<1, V>& it, float& a,
                                        float& b) const {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a += it.v[0][k];
        b += it.v[0][k] * it.v[0][k];
      }
    }
  };
  __device__ __forceinline__ Channel channel(long long) const { return {x}; }
  __device__ __forceinline__ void finish(long long c, float sum,
                                         float sq) const {
    const float m = sum / n;
    const float v = fmaxf(0.0f, sq / n - m * m);
    mean[c] = m;
    var[c] = v;
    rstd[c] = 1.0f / sqrtf(v + eps);
  }
};

// K3's work: the sums of dz and dz * xhat; d_gamma, d_beta and K4's coef
// rows (0 = rstd * scale, 1 = d_beta / n, 2 = d_gamma / n) from them.
template <typename TG, typename TX>
struct GradSumsOp {
  static constexpr int kInputs = 2;
  const TG* dz;
  const TX* x;
  const float* mean;
  const float* rstd;
  const float* scale;
  float* d_gamma;
  float* d_beta;
  float* coef;
  long long C;
  float n;

  struct Channel {
    const TG* __restrict__ dz;
    const TX* __restrict__ x;
    float m, r;
    template <int V>
    __device__ __forceinline__ void read(long long e, Item<2, V>& it) const {
      load<TG, V>(dz + e, 0, it.v[0]);
      load<TX, V>(x + e, 0, it.v[1]);
    }
    template <int V>
    __device__ __forceinline__ void add(const Item<2, V>& it, float& a,
                                        float& b) const {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a += it.v[0][k];
        b += it.v[0][k] * ((it.v[1][k] - m) * r);
      }
    }
  };
  __device__ __forceinline__ Channel channel(long long c) const {
    return {dz, x, mean[c], rstd[c]};
  }
  __device__ __forceinline__ void finish(long long c, float sum_g,
                                         float sum_gx) const {
    d_beta[c] = sum_g;
    d_gamma[c] = sum_gx;
    coef[c] = rstd[c] * scale[c];
    coef[C + c] = sum_g / n;
    coef[2 * C + c] = sum_gx / n;
  }
};

// The ticket combine's scratch (done == nullptr: no ticket): per channel
// the count of its blocks done, 0 between launches, and each block's
// partial.
struct Tickets {
  unsigned int* done;
  float2* partials;
};

// The vector, split and scalar paths: the G consecutive blocks from
// blockIdx.x / G * G reduce channel blockIdx.x / G; thread t of rank g
// takes the channel's units g * blockDim.x + t, += G * blockDim.x, U at a
// time.  The G partials are combined by one block (G == 1), in the
// cluster of the G blocks (after cluster.sync() rank 0 reads them through
// distributed shared memory and sums them in rank order) or, with Ticket,
// by the block that finishes last (it sums the G partials in a fixed
// order: lane l the partials l, l + 32, ..., then the warp's tree; and
// clears the count).  The ticket is a separate kernel, so that the others
// keep its registers free.
template <int Mode, bool Ticket, class Op>
__device__ __forceinline__ void reduce_wide(const Op& op, long long B,
                                            long long C, long long S, int G,
                                            int phase, Tickets tickets) {
  constexpr int V = Mode == kPathScalar ? 1 : 4;
  constexpr int U = Mode == kPathScalar ? 8 : 4;
  const long long c = blockIdx.x / G;
  const int rank = static_cast<int>(blockIdx.x - c * G);
  const auto ch = op.channel(c);
  // units per plane; the split path's body leaves S - 4K edge elements
  const long long K = Mode == kPathVector ? S / 4
                      : Mode == kPathSplit ? S / 4 - 1
                                           : S;
  const long long units = B * K;
  const long long step = static_cast<long long>(G) * blockDim.x;
  const long long first = static_cast<long long>(rank) * blockDim.x + threadIdx.x;
  float a[U], b[U];
#pragma unroll
  for (int u = 0; u < U; ++u) a[u] = b[u] = 0.0f;
  PlaneCursor cur(first, c, C, S, K, step);
  for (long long j = first; j < units; j += U * step) {
    Item<Op::kInputs, V> it[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j + u * step < units) {
        const long long e = cur.e + V * cur.k;
        ch.template read<V>(Mode == kPathSplit ? e + head(cur.e, phase) : e,
                            it[u]);
        cur.advance();
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j + u * step < units) ch.add(it[u], a[u], b[u]);
  }
  if constexpr (Mode == kPathSplit) {
    // the edges: element i of a plane's L is i before the body, else after it
    const long long L = S - 4 * K;
    for (long long l = first; l < B * L; l += step) {
      const long long plane = l / L, i = l - plane * L;
      const long long e = (plane * C + c) * S;
      Item<Op::kInputs, 1> it;
      ch.template read<1>(e + (i < head(e, phase) ? i : i + 4 * K), it);
      ch.add(it, a[0], b[0]);
    }
  }
  float sa = tree_sum(a), sb = tree_sum(b);
  block_sum2(sa, sb);
  if constexpr (Ticket) {
    __shared__ bool last;
    float2* partials = tickets.partials + c * G;
    if (threadIdx.x == 0) {
      partials[rank] = make_float2(sa, sb);
      __threadfence();
      last = atomicAdd(tickets.done + c, 1u) == static_cast<unsigned int>(G - 1);
    }
    __syncthreads();
    if (!last || threadIdx.x >= 32) return;
    __threadfence();
    float s0 = 0.0f, s1 = 0.0f;
    for (int g = threadIdx.x; g < G; g += 32) {
      const float2 p = __ldcg(partials + g);
      s0 += p.x;
      s1 += p.y;
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (threadIdx.x == 0) {
      op.finish(c, s0, s1);
      tickets.done[c] = 0;
    }
  } else {
    if (G == 1) {
      if (threadIdx.x == 0) op.finish(c, sa, sb);
      return;
    }
    __shared__ float2 part;
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) part = make_float2(sa, sb);
    cluster.sync();
    if (rank == 0 && threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float2 p = lane < G ? *cluster.map_shared_rank(&part, lane)
                                : make_float2(0.0f, 0.0f);
      float s0 = 0.0f, s1 = 0.0f;
      for (int g = 0; g < G; ++g) {
        s0 += __shfl_sync(0xffffffffu, p.x, g);
        s1 += __shfl_sync(0xffffffffu, p.y, g);
      }
      if (lane == 0) op.finish(c, s0, s1);
    }
    cluster.sync();  // the other ranks' shared memory stays until it is read
  }
}

// The narrow path: block i takes channels [i * tile, (i + 1) * tile);
// thread (row, p) of its R x (tile * S) threads takes element p of the
// tile's run in planes b = row, row + R, ...; then warp w sums the R * S
// partials of channels w, w + warps, ... in a fixed order.
template <class Op>
__device__ __forceinline__ void reduce_narrow(const Op& op, long long B,
                                              long long C, int S, int tile,
                                              int R) {
  constexpr int U = 4;
  __shared__ float sa[kMaxThreads], sb[kMaxThreads];
  const long long c0 = static_cast<long long>(blockIdx.x) * tile;
  const int channels = static_cast<int>(min(static_cast<long long>(tile), C - c0));
  const int P = tile * S;
  const int t = threadIdx.x, row = t / P, p = t - row * P;
  float a[U], b[U];
#pragma unroll
  for (int u = 0; u < U; ++u) a[u] = b[u] = 0.0f;
  if (row < R && p < channels * S) {
    const auto ch = op.channel(c0 + p / S);
    const long long step = static_cast<long long>(R) * C * S;
    long long e = (row * C + c0) * S + p;
    for (long long plane = row; plane < B; plane += U * R, e += U * step) {
      Item<Op::kInputs, 1> it[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (plane + u * R < B) ch.template read<1>(e + u * step, it[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (plane + u * R < B) ch.add(it[u], a[u], b[u]);
    }
  }
  sa[t] = tree_sum(a);
  sb[t] = tree_sum(b);
  __syncthreads();
  const int warp = t >> 5, lane = t & 31, warps = blockDim.x >> 5;
  for (int cl = warp; cl < channels; cl += warps) {
    float x = 0.0f, y = 0.0f;
    for (int i = lane; i < R * S; i += 32) {
      const int r = i / S, at = r * P + cl * S + (i - r * S);
      x += sa[at];
      y += sb[at];
    }
    x = warp_sum(x);
    y = warp_sum(y);
    if (lane == 0) op.finish(c0 + cl, x, y);
  }
}

template <typename T, int Mode, bool Ticket>
__global__ void __launch_bounds__(kMaxWideThreads)
bn_stats_kernel(StatsOp<T> op, long long B, long long C, long long S, int G,
                int phase, Tickets tickets) {
  reduce_wide<Mode, Ticket>(op, B, C, S, G, phase, tickets);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
bn_stats_narrow_kernel(StatsOp<T> op, long long B, long long C, int S,
                       int tile, int R) {
  reduce_narrow(op, B, C, S, tile, R);
}

template <typename TG, typename TX, int Mode, bool Ticket>
__global__ void __launch_bounds__(kMaxWideThreads)
bn_grad_sums_kernel(GradSumsOp<TG, TX> op, long long B, long long C,
                    long long S, int G, int phase, Tickets tickets) {
  reduce_wide<Mode, Ticket>(op, B, C, S, G, phase, tickets);
}

template <typename TG, typename TX>
__global__ void __launch_bounds__(kMaxThreads)
bn_grad_sums_narrow_kernel(GradSumsOp<TG, TX> op, long long B, long long C,
                           int S, int tile, int R) {
  reduce_narrow(op, B, C, S, tile, R);
}

// The launch floor of K1 (Kernel 0), K3 (1) and K2 (2): the same grid,
// block and cluster, no work.
template <int Kernel>
__global__ void bn_floor_kernel(int) {}

// ------------------------------------------------------------ K2, K4

// The elementwise passes' paths (codes shared with ops/bn_kernel.py).
constexpr int kVector = 0;  // 16-byte vectors, S >= V
constexpr int kLanes = 1;   // 16-byte vectors, a channel per lane
constexpr int kScalar = 2;  // one element per load

constexpr int kElementwiseThreads = 256;
constexpr int kElementwiseTable = 256;  // planes a block's chunk covers at most
constexpr long long kMaxElementwisePlane = 1LL << 30;  // larger are refused

// Division of n < 2^31 by a fixed d in [1, 2^31) as a multiply and a shift
// (Granlund and Montgomery): n / d = (umulhi(n, magic) + n) >> shift.
struct Divider {
  unsigned int d, magic;
  int shift;
  __device__ __forceinline__ unsigned int div(unsigned int n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

// The flat run an elementwise pass walks: `head` elements before the
// inputs' first 16-byte boundary, then `nvec` vectors of V elements,
// `chunk` a block, then the tail up to `total`.
struct Run {
  long long C, S, head, nvec, total, chunk;
  Divider plane, channel;  // division by S and by C

  // plane p's channel, p % C
  __device__ __forceinline__ long long channel_of(long long p) const {
    return p < 0x7fffffffLL
               ? p - static_cast<long long>(channel.div(static_cast<unsigned int>(p))) * C
               : p % C;
  }
  // element e's plane, e / S
  __device__ __forceinline__ long long plane_of(long long e) const {
    return e < 0x7fffffffLL ? plane.div(static_cast<unsigned int>(e)) : e / S;
  }
};

// K2's work: z = (x - mean) * rstd * scale + bias.
template <typename TX, typename TZ>
struct ApplyOp {
  static constexpr int kInputs = 1;
  static constexpr int kUnroll = 2;  // vectors a thread loads per batch
  using Coef = float4;  // mean, rstd, scale, bias
  const TX* __restrict__ x;
  TZ* __restrict__ z;
  const float* mean;
  const float* rstd;
  const float* scale;
  const float* bias;
  __device__ __forceinline__ Coef coef(long long c) const {
    return make_float4(mean[c], rstd[c], scale[c], bias[c]);
  }
  template <int V>
  __device__ __forceinline__ void read(long long e, float (&v)[1][V]) const {
    load<TX, V>(x + e, 0, v[0]);
  }
  template <int V>
  __device__ __forceinline__ float apply(const Coef& k, const float (&v)[1][V],
                                         int i) const {
    return (v[0][i] - k.x) * k.y * k.z + k.w;
  }
  template <int V>
  __device__ __forceinline__ void write(long long e, const float (&v)[V]) const {
    store<TZ, V>(z + e, 0, v);
  }
};

// K4's work: dx = coef0 * ((dz - coef1) - xhat * coef2), xhat = (x - mean)
// * rstd.
template <typename TG, typename TX>
struct DxOp {
  static constexpr int kInputs = 2;
  static constexpr int kUnroll = 1;  // vectors a thread loads per batch
  struct alignas(16) Coef {
    float4 a;  // mean, rstd, coef0, coef1
    float b;   // coef2
  };
  const TG* __restrict__ dz;
  const TX* __restrict__ x;
  TX* __restrict__ dx;
  const float* mean;
  const float* rstd;
  const float* k;  // [3, C]
  long long C;
  __device__ __forceinline__ Coef coef(long long c) const {
    return {make_float4(mean[c], rstd[c], k[c], k[C + c]), k[2 * C + c]};
  }
  template <int V>
  __device__ __forceinline__ void read(long long e, float (&v)[2][V]) const {
    load<TG, V>(dz + e, 0, v[0]);
    load<TX, V>(x + e, 0, v[1]);
  }
  template <int V>
  __device__ __forceinline__ float apply(const Coef& c, const float (&v)[2][V],
                                         int i) const {
    const float xhat = (v[1][i] - c.a.x) * c.a.y;
    return c.a.z * ((v[0][i] - c.a.w) - xhat * c.b);
  }
  template <int V>
  __device__ __forceinline__ void write(long long e, const float (&v)[V]) const {
    store<TX, V>(dx + e, 0, v);
  }
};

// Element e alone (the head and the tail).
template <class Op>
__device__ __forceinline__ void elementwise_one(const Op& op, const Run& a,
                                                long long e) {
  float v[Op::kInputs][1];
  op.template read<1>(e, v);
  const float out[1] = {
      op.template apply<1>(op.coef(a.channel_of(a.plane_of(e))), v, 0)};
  op.template write<1>(e, out);
}

// Block i takes vectors [i * chunk, (i + 1) * chunk) of the run; its thread
// t takes vectors j = t, t + T, ... Op::kUnroll at a time, all loads of a
// batch issued before its first store.  The block's first batch is in
// flight while its threads fill a shared table with the coefficients of
// each plane its chunk covers (one plane a thread); a vector finds its
// plane lp by one multiply-shift division and reads table[lp] and, where a
// plane boundary falls inside it, table[lp + 1] (the lanes path walks its
// lanes' planes one by one).  Block 0 also takes the head and the tail, one
// element a thread.
template <int V, bool Lanes, class Op>
__device__ __forceinline__ void elementwise(const Op& op, const Run& a) {
  constexpr int U = Op::kUnroll;
  using Coef = typename Op::Coef;
  __shared__ Coef table[kElementwiseTable];
  const long long v0 = static_cast<long long>(blockIdx.x) * a.chunk;
  const int n = static_cast<int>(min(a.chunk, a.nvec - v0));
  const long long e0 = a.head + v0 * V;
  // the plane of e0 and e0's place in it
  const long long p0 = a.plane_of(e0);
  const unsigned int o0 = static_cast<unsigned int>(e0 - p0 * a.S);
  const int t = threadIdx.x, T = blockDim.x;
  float v[U][Op::kInputs][V];
  const auto read_batch = [&](int base) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * T + t < n)
        op.template read<V>(e0 + static_cast<long long>(base + u * T + t) * V,
                            v[u]);
  };
  read_batch(0);
  if (n > 0 && t <= static_cast<int>(a.plane.div(
                       o0 + static_cast<unsigned int>(n - 1) * V + (V - 1))))
    table[t] = op.coef(a.channel_of(p0 + t));
  if (blockIdx.x == 0) {
    const long long tail = a.head + a.nvec * V;
    if (t < a.head)
      elementwise_one(op, a, t);
    else if (tail + (t - a.head) < a.total)
      elementwise_one(op, a, tail + (t - a.head));
  }
  __syncthreads();
  for (int base = 0; base < n; base += U * T) {
    if (base > 0) read_batch(base);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * T + t;
      if (j >= n) continue;
      const unsigned int pos = o0 + static_cast<unsigned int>(j) * V;
      const unsigned int lp = a.plane.div(pos);
      const unsigned int rem = pos - lp * a.plane.d;
      float out[V];
      if constexpr (Lanes) {
        unsigned int p = lp, r = rem;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          out[i] = op.template apply<V>(table[p], v[u], i);
          if (++r == a.plane.d) {
            r = 0;
            ++p;
          }
        }
      } else {
        // lanes [0, split) lie in plane lp, the rest in plane lp + 1
        const unsigned int split = a.plane.d - rem;
        const Coef c0 = table[lp];
        if (split >= static_cast<unsigned int>(V)) {
#pragma unroll
          for (int i = 0; i < V; ++i) out[i] = op.template apply<V>(c0, v[u], i);
        } else {
          const Coef c1 = table[lp + 1];
#pragma unroll
          for (int i = 0; i < V; ++i)
            out[i] = op.template apply<V>(
                static_cast<unsigned int>(i) < split ? c0 : c1, v[u], i);
        }
      }
      op.template write<V>(e0 + static_cast<long long>(j) * V, out);
    }
  }
}

template <typename TX, typename TZ, int V, bool Lanes>
__global__ void __launch_bounds__(kElementwiseThreads)
bn_apply_kernel(ApplyOp<TX, TZ> op, Run run) {
  elementwise<V, Lanes>(op, run);
}

template <typename TG, typename TX, int V, bool Lanes>
__global__ void __launch_bounds__(kElementwiseThreads)
bn_dx_kernel(DxOp<TG, TX> op, Run run) {
  elementwise<V, Lanes>(op, run);
}

// ------------------------------------------------------------------ host

struct Shape {
  long long b, c, s;
  bool ok() const { return b > 0 && c > 0 && s > 0; }
  long long elements_per_channel() const { return b * s; }
};

size_t itemsize(int dtype) { return dtype == kBFloat16 ? 2 : 4; }

bool valid_dtype(int dtype) { return dtype == kFloat32 || dtype == kBFloat16; }

int start(int device, const Shape& shape) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return shape.ok() ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Calls f(T{}) with T the C++ type of dtype code `dtype`.
template <typename F>
void with_type(int dtype, F&& f) {
  if (dtype == kBFloat16)
    f(__nv_bfloat16{});
  else
    f(float{});
}

// How a wide path combines a channel's blocks (codes shared with
// ops/bn_kernel.py).
enum Combine { kOneBlock = 0, kCluster = 1, kTicket = 2 };

// The grid a reduction launches: its path, block size, blocks per channel
// and how they combine (wide paths) or channels per block and rows (narrow
// path).
struct Plan {
  int path, threads, per_channel, combine, tile, rows, phase;
  unsigned int blocks;
};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

long long clamp(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Elements from the last n-element boundary to p's element 0.
int element_phase(const void* p, size_t item, int n = 4) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) / item) % n);
}

// The path for `path` (kPathAuto: the shape's own) over inputs whose
// element 0 lies `phase` elements past a 4-element boundary (`same_phase`:
// every input alike), and for the narrow path its grid; a wide path's grid
// is sized at launch (size_wide).  cudaErrorInvalidValue for a path the
// inputs do not take.
int make_plan(int path, const Shape& sh, int phase, bool same_phase,
              Plan& plan) {
  const long long B = sh.b, C = sh.c, S = sh.s;
  // split before scalar wherever the inputs are aligned alike: chip_smoke.py
  // phase 14 times the two side by side at S = 361 and 5625
  if (path == kPathAuto)
    path = S < kNarrowPlane              ? kPathNarrow
           : !same_phase                 ? kPathScalar
           : S % 4 == 0 && phase == 0    ? kPathVector
                                         : kPathSplit;
  const bool ok = path == kPathScalar
                  || (path == kPathVector && S % 4 == 0 && phase == 0 && same_phase)
                  || (path == kPathSplit && S >= 8 && same_phase)
                  || (path == kPathNarrow && S <= kMaxThreads);
  if (!ok) return cudaErrorInvalidValue;
  plan = Plan{path, 0, 1, kOneBlock, 1, 1, phase, 0};
  if (path != kPathNarrow) return 0;
  // rows: about kNarrowRowsPerThread planes a thread, and at least 32
  // partials a channel where B allows, so that each warp of the final sum
  // takes one channel; tile: channels enough for about kNarrowThreads
  const long long rows = clamp(
      std::max(ceil_div(B, kNarrowRowsPerThread), ceil_div(32, S)), 1,
      std::min(B, kMaxThreads / S));
  const long long tile = clamp(kNarrowThreads / (rows * S), 1, C);
  plan.rows = static_cast<int>(rows);
  plan.tile = static_cast<int>(tile);
  plan.threads = static_cast<int>(ceil_div(rows * tile * S, 32) * 32);
  const long long blocks = ceil_div(C, tile);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  plan.blocks = static_cast<unsigned int>(blocks);
  return 0;
}

// Blocks of `threads` threads of `kernel` that the device holds at once
// (its SMs times the blocks one SM holds), cached per kernel, block size
// and device; 0 if the runtime cannot say.
long long resident_blocks(const void* kernel, int threads, int device) {
  struct Entry {
    const void* kernel;
    int threads, device;
    long long blocks;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  const std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.kernel == kernel && e.threads == threads && e.device == device)
      return e.blocks;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)
          != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       threads, 0)
             != cudaSuccess)
    return 0;
  const long long blocks = static_cast<long long>(sms) * per_sm;
  cache.push_back({kernel, threads, device, blocks});
  return blocks;
}

// A wide path's grid for `kernel`, each thread taking batches of U loads:
//  - one block a channel, of 256 or 512 threads, the first that takes the
//    channel in two batches a thread, where the card holds the C blocks at
//    once (no step across blocks);
//  - else a cluster of G <= 16 blocks of 256 a channel: G for two batches
//    a thread where the card holds the C * G blocks at once with a quarter
//    to spare (clusters must each fit in one GPC; the layer is bound by the
//    latency of a few loads), else for four (it is bound by bytes, and
//    larger blocks cost less of their own);
//  - else, for a channel longer than 16 blocks take so, blocks of 256 of
//    two batches each, as many as the channel needs (like chunks of 8192
//    elements), combined by ticket: clusters cap a channel at 16 blocks,
//    too few for the card to balance the largest layers.
int size_wide(Plan& plan, const Shape& sh, const void* kernel, int device) {
  const long long B = sh.b, C = sh.c, S = sh.s;
  const long long units = plan.path == kPathVector ? B * (S / 4)
                          : plan.path == kPathSplit ? B * (S / 4 - 1)
                                                    : B * S;
  const long long unroll = plan.path == kPathScalar ? 8 : 4;
  const long long need = ceil_div(units, unroll);  // threads of one batch
  const long long slots = resident_blocks(kernel, 256, device);
  if (slots == 0) return cudaErrorInvalidConfiguration;
  long long T = 256, G = 0;
  if (need <= 2 * T) {
    G = C <= slots ? 1 : 0;
  } else if (need <= 2 * kMaxWideThreads) {
    const long long wide_slots = resident_blocks(kernel, kMaxWideThreads, device);
    if (wide_slots == 0) return cudaErrorInvalidConfiguration;
    if (C <= wide_slots) {
      T = kMaxWideThreads;
      G = 1;
    }
  }
  plan.combine = kOneBlock;
  if (G == 0) {
    G = ceil_div(need, 2 * T);
    if (4 * C * G > 3 * slots) G = ceil_div(need, 4 * T);
    if (G > kMaxCluster) {
      G = ceil_div(need, 2 * T);
      plan.combine = kTicket;
    } else if (G > 1) {
      plan.combine = kCluster;
    }
  }
  if (G * C > 0x7fffffffLL || G > 0x7fffffffLL / 2) return cudaErrorInvalidValue;
  plan.threads = static_cast<int>(T);
  plan.per_channel = static_cast<int>(G);
  plan.blocks = static_cast<unsigned int>(G * C);
  return 0;
}

// The ticket combine's scratch for launches on `stream` of device: the
// counts (zeroed when allocated; the last block of a channel clears its
// count) and the partials.  Allocated in stream order, grown as needed and
// kept for the library's lifetime, one per stream, so launches on other
// streams never share counts.
int ticket_scratch(cudaStream_t stream, int device, long long channels,
                   long long partials, Tickets& tickets) {
  struct Entry {
    cudaStream_t stream;
    int device;
    char* base;
    long long channels, partials;
  };
  static std::mutex mu;
  static std::vector<Entry> pool;
  const std::lock_guard<std::mutex> lock(mu);
  Entry* entry = nullptr;
  for (Entry& e : pool)
    if (e.stream == stream && e.device == device) entry = &e;
  if (entry == nullptr) {
    pool.push_back({stream, device, nullptr, 0, 0});
    entry = &pool.back();
  }
  if (channels > entry->channels || partials > entry->partials) {
    const long long c = std::max(channels, entry->channels);
    const long long p = std::max(partials, entry->partials);
    const size_t counts = ceil_div(c * sizeof(unsigned int), 16) * 16;
    cudaError_t err = cudaSuccess;
    if (entry->base != nullptr) err = cudaFreeAsync(entry->base, stream);
    entry->base = nullptr;
    entry->channels = entry->partials = 0;
    void* base = nullptr;
    if (err == cudaSuccess)
      err = cudaMallocAsync(&base, counts + p * sizeof(float2), stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(base, 0, counts, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    *entry = {stream, device, static_cast<char*>(base), c, p};
  }
  const size_t counts = ceil_div(entry->channels * sizeof(unsigned int), 16) * 16;
  tickets.done = reinterpret_cast<unsigned int*>(entry->base);
  tickets.partials = reinterpret_cast<float2*>(entry->base + counts);
  return 0;
}

// Launches kernel on plan's grid, block and cluster, with no fallback: a
// refused launch returns its error.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), const Plan& plan, cudaStream_t stream,
           Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.blocks);
  cfg.blockDim = dim3(static_cast<unsigned int>(plan.threads));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (plan.combine == kCluster) {
    if (plan.per_channel > 8) {
      const cudaError_t err = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(kernel),
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned int>(plan.per_channel);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// What reduce() does with its plan.
enum Action { kRun, kFloor, kPlanOnly };

// Sizes plan and, by `action`, launches the reduction of op (a StatsOp or
// GradSumsOp) through Kernels' wide<Mode> or narrow kernel, or the launch
// floor of K1 (which 0) or K3 (1) on the same grid, or nothing.
template <class Kernels, class Op>
int launch_reduce(Plan& plan, const Op& op, const Shape& sh, int device,
                  cudaStream_t stream, Action action, int which) {
  const auto kernel = [&plan](auto ticket) {
    constexpr bool T = decltype(ticket)::value;
    return plan.path == kPathVector ? Kernels::template wide<kPathVector, T>()
           : plan.path == kPathSplit ? Kernels::template wide<kPathSplit, T>()
                                     : Kernels::template wide<kPathScalar, T>();
  };
  if (plan.path != kPathNarrow) {
    const int err = size_wide(
        plan, sh, reinterpret_cast<const void*>(kernel(std::false_type{})), device);
    if (err) return err;
  }
  if (action == kPlanOnly) return 0;
  if (action == kFloor)
    return which == 0 ? launch(bn_floor_kernel<0>, plan, stream, 0)
                      : launch(bn_floor_kernel<1>, plan, stream, 0);
  if (plan.path == kPathNarrow)
    return launch(Kernels::narrow(), plan, stream, op, sh.b, sh.c,
                  static_cast<int>(sh.s), plan.tile, plan.rows);
  Tickets tickets{nullptr, nullptr};
  if (plan.combine != kTicket)
    return launch(kernel(std::false_type{}), plan, stream, op, sh.b, sh.c,
                  sh.s, plan.per_channel, plan.phase, tickets);
  const int err = ticket_scratch(stream, device, sh.c,
                                 sh.c * plan.per_channel, tickets);
  if (err) return err;
  return launch(kernel(std::true_type{}), plan, stream, op, sh.b, sh.c, sh.s,
                plan.per_channel, plan.phase, tickets);
}

template <typename T>
struct StatsKernels {
  template <int Mode, bool Ticket>
  static auto wide() { return bn_stats_kernel<T, Mode, Ticket>; }
  static auto narrow() { return bn_stats_narrow_kernel<T>; }
};

template <typename TG, typename TX>
struct GradSumsKernels {
  template <int Mode, bool Ticket>
  static auto wide() { return bn_grad_sums_kernel<TG, TX, Mode, Ticket>; }
  static auto narrow() { return bn_grad_sums_narrow_kernel<TG, TX>; }
};

// K1 (kernel 0) or K3 (1) on these inputs with `path`, by `action`: run
// it, launch the empty kernel on its grid, or only fill `plan`.  dz is
// unused by K1; outputs: mean, var, rstd (K1) or d_gamma, d_beta, coef
// (K3).
int reduce(int kernel, int path, Action action, const void* dz, int dz_dtype,
           const void* x, int x_dtype, const float* mean, const float* rstd,
           const float* scale, float* out0, float* out1, float* out2,
           const Shape& sh, float eps, int device, cudaStream_t stream,
           Plan& plan) {
  if ((kernel != 0 && kernel != 1) || !valid_dtype(x_dtype)
      || (kernel == 1 && !valid_dtype(dz_dtype)))
    return cudaErrorInvalidValue;
  const int phase = element_phase(x, itemsize(x_dtype));
  const bool same = kernel == 0 || element_phase(dz, itemsize(dz_dtype)) == phase;
  int result = make_plan(path, sh, phase, same, plan);
  if (result) return result;
  const float n = static_cast<float>(sh.b * sh.s);
  if (kernel == 0) {
    with_type(x_dtype, [&](auto t) {
      using T = decltype(t);
      const StatsOp<T> op{static_cast<const T*>(x), out0, out1, out2, n, eps};
      result = launch_reduce<StatsKernels<T>>(plan, op, sh, device, stream,
                                              action, kernel);
    });
  } else {
    with_type(dz_dtype, [&](auto tg) {
      with_type(x_dtype, [&](auto tx) {
        using TG = decltype(tg);
        using TX = decltype(tx);
        const GradSumsOp<TG, TX> op{static_cast<const TG*>(dz),
                                    static_cast<const TX*>(x), mean, rstd,
                                    scale, out0, out1, out2, sh.c, n};
        result = launch_reduce<GradSumsKernels<TG, TX>>(
            plan, op, sh, device, stream, action, kernel);
      });
    });
  }
  return result;
}

Divider make_divider(unsigned int d) {
  int shift = 0;
  while ((1ULL << shift) < d) ++shift;
  const unsigned long long magic =
      ((1ULL << 32) * ((1ULL << shift) - d)) / d + 1;
  return {d, static_cast<unsigned int>(magic), shift};
}

// An elementwise pass's launch: its path, elements per vector, grid and run.
struct ElementwisePlan {
  int path, vec, unroll, batches;
  unsigned int blocks;
  Run run;
};

// The path for `path` (kPathAuto: the inputs' own) over a tensor whose
// first input is of `item` bytes and whose pointers `ptrs` (pointer, item
// bytes; a null pointer is a fresh allocation, aligned) lie at element
// phases mod V alike or not, and the run it walks; cudaErrorInvalidValue
// for a path the inputs do not take.
int plan_run(int path, const Shape& sh, size_t item,
             std::initializer_list<std::pair<const void*, size_t>> ptrs,
             ElementwisePlan& plan) {
  if (sh.s >= kMaxElementwisePlane) return cudaErrorInvalidValue;
  const int V = 16 / static_cast<int>(item);
  int phase = -1;
  bool same = true;
  for (const auto& p : ptrs) {
    const int q = p.first == nullptr ? 0 : element_phase(p.first, p.second, V);
    if (phase >= 0 && q != phase) same = false;
    if (phase < 0) phase = q;
  }
  if (path == kPathAuto) path = !same ? kScalar : sh.s >= V ? kVector : kLanes;
  const bool ok = path == kScalar || (same && path == kLanes)
                  || (same && path == kVector && sh.s >= V);
  if (!ok) return cudaErrorInvalidValue;
  const int vec = path == kScalar ? 1 : V;
  const long long total = sh.b * sh.c * sh.s;
  const long long head = std::min<long long>(total, (vec - phase % vec) % vec);
  const long long nvec = (total - head) / vec;
  if (sh.c >= 0x7fffffffLL) return cudaErrorInvalidValue;
  // a block takes one batch of loads at f32, two at bf16 (tuned on the H100)
  plan = ElementwisePlan{path, vec, 1, item == 4 ? 1 : 2, 1,
                         Run{sh.c, sh.s, head, nvec, total, 1,
                             make_divider(static_cast<unsigned int>(sh.s)),
                             make_divider(static_cast<unsigned int>(sh.c))}};
  return 0;
}

// plan's grid for `kernel`: the run spread over as many blocks as the card
// holds at once where that leaves each thread a vector or more (so small
// layers reach every SM), a block's chunk a multiple of its threads, at
// most plan.batches batches (the largest layers take many short blocks,
// which the card balances) and at most the planes the shared table holds.
int size_elementwise(ElementwisePlan& plan, const void* kernel, int unroll,
                     int device) {
  const long long slots = resident_blocks(kernel, kElementwiseThreads, device);
  if (slots == 0) return cudaErrorInvalidConfiguration;
  plan.unroll = unroll;
  Run& r = plan.run;
  const long long spread =
      clamp(std::min(slots, ceil_div(r.nvec, kElementwiseThreads)), 1, slots);
  const long long most = std::min(
      {static_cast<long long>(plan.batches) * kElementwiseThreads * unroll,
       (kElementwiseTable - 1) * r.S / plan.vec, (1LL << 30) / plan.vec});
  const long long chunk =
      ceil_div(ceil_div(r.nvec, spread), kElementwiseThreads) * kElementwiseThreads;
  r.chunk = std::max(1LL, std::min(chunk, most));
  const long long blocks = std::max(1LL, ceil_div(r.nvec, r.chunk));
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  plan.blocks = static_cast<unsigned int>(blocks);
  return 0;
}

// The kernel of each path (the scalar path moves one element at a time).
template <typename TX, typename TZ, int V>
auto apply_kernel(int path) {
  return path == kVector  ? bn_apply_kernel<TX, TZ, V, false>
         : path == kLanes ? bn_apply_kernel<TX, TZ, V, true>
                          : bn_apply_kernel<TX, TZ, 1, false>;
}

template <typename TG, typename TX, int V>
auto dx_kernel(int path) {
  return path == kVector  ? bn_dx_kernel<TG, TX, V, false>
         : path == kLanes ? bn_dx_kernel<TG, TX, V, true>
                          : bn_dx_kernel<TG, TX, 1, false>;
}

// Sizes plan for `kernel` and, by `action`, launches it on op, or the
// launch floor of K2 (which 2) or K4 (3) on the same grid, or nothing.
template <class Op>
int launch_elementwise(ElementwisePlan& plan, void (*kernel)(Op, Run),
                       const Op& op, int device, cudaStream_t stream,
                       Action action, int which) {
  int err = size_elementwise(plan, reinterpret_cast<const void*>(kernel),
                             Op::kUnroll, device);
  if (err || action == kPlanOnly) return err;
  if (action == kFloor) {
    if (which == 2)
      bn_floor_kernel<2><<<plan.blocks, kElementwiseThreads, 0, stream>>>(0);
    else
      bn_floor_kernel<3><<<plan.blocks, kElementwiseThreads, 0, stream>>>(0);
  } else {
    kernel<<<plan.blocks, kElementwiseThreads, 0, stream>>>(op, plan.run);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2 (kernel 0: z from x, p0 = scale, p1 = bias; dz unused) or K4 (1: dx
// from dz and x, p0 = coef, p1 unused; out in x's dtype) on `path` by
// `action`: run it, launch the empty kernel on its grid, or only fill
// `plan` (out may be null there: a fresh allocation).
int elementwise(int kernel, int path, Action action, const void* dz,
                int dz_dtype, const void* x, int x_dtype, const float* mean,
                const float* rstd, const float* p0, const float* p1, void* out,
                int out_dtype, const Shape& sh, int device, cudaStream_t stream,
                ElementwisePlan& plan) {
  if ((kernel != 0 && kernel != 1) || !valid_dtype(x_dtype)
      || !valid_dtype(kernel == 0 ? out_dtype : dz_dtype)
      || (kernel == 1 && out_dtype != x_dtype))
    return cudaErrorInvalidValue;
  int result = kernel == 0
      ? plan_run(path, sh, itemsize(x_dtype),
                 {{x, itemsize(x_dtype)}, {out, itemsize(out_dtype)}}, plan)
      : plan_run(path, sh, itemsize(x_dtype),
                 {{dz, itemsize(dz_dtype)}, {x, itemsize(x_dtype)},
                  {out, itemsize(x_dtype)}}, plan);
  if (result) return result;
  with_type(x_dtype, [&](auto tx) {
    with_type(kernel == 0 ? out_dtype : dz_dtype, [&](auto t2) {
      using TX = decltype(tx);
      using T2 = decltype(t2);
      constexpr int V = 16 / sizeof(TX);
      if (kernel == 0) {
        const ApplyOp<TX, T2> op{static_cast<const TX*>(x), static_cast<T2*>(out),
                                 mean, rstd, p0, p1};
        result = launch_elementwise(plan, apply_kernel<TX, T2, V>(plan.path),
                                    op, device, stream, action, 2);
      } else {
        const DxOp<T2, TX> op{static_cast<const T2*>(dz), static_cast<const TX*>(x),
                              static_cast<TX*>(out), mean, rstd, p0, sh.c};
        result = launch_elementwise(plan, dx_kernel<T2, TX, V>(plan.path),
                                    op, device, stream, action, 3);
      }
    });
  });
  return result;
}

}  // namespace

// K1.  x [b, c, s] (dtype code x_dtype) -> mean, var, rstd [c] f32.
extern "C" int bn_stats_launch(const void* x, int x_dtype, void* mean,
                               void* var, void* rstd, long long b,
                               long long c, long long s, float eps, int device,
                               void* stream_ptr) {
  const Shape sh{b, c, s};
  const int err = start(device, sh);
  if (err) return err;
  Plan plan;
  return reduce(0, kPathAuto, kRun, nullptr, 0, x, x_dtype, nullptr, nullptr,
                nullptr, static_cast<float*>(mean), static_cast<float*>(var),
                static_cast<float*>(rstd), sh, eps, device,
                static_cast<cudaStream_t>(stream_ptr), plan);
}

// K3.  dz (dz_dtype) and x (x_dtype) [b, c, s] -> d_gamma, d_beta [c] and
// coef [3, c] f32.
extern "C" int bn_grad_sums_launch(const void* dz, int dz_dtype, const void* x,
                                   int x_dtype, const void* mean,
                                   const void* rstd, const void* scale,
                                   void* d_gamma, void* d_beta, void* coef,
                                   long long b, long long c, long long s,
                                   int device, void* stream_ptr) {
  const Shape sh{b, c, s};
  const int err = start(device, sh);
  if (err) return err;
  Plan plan;
  return reduce(1, kPathAuto, kRun, dz, dz_dtype, x, x_dtype,
                static_cast<const float*>(mean),
                static_cast<const float*>(rstd),
                static_cast<const float*>(scale), static_cast<float*>(d_gamma),
                static_cast<float*>(d_beta), static_cast<float*>(coef), sh,
                0.0f, device, static_cast<cudaStream_t>(stream_ptr), plan);
}

// K1 (kernel 0; dz unused) or K3 (1) as above, on a given path (0 vector,
// 1 split, 2 scalar, 3 narrow, -1 the shape's own), or with `floor` the
// empty kernel on the same grid, block and cluster (the launch floor).
// out0-2: mean, var, rstd (K1) or d_gamma, d_beta, coef (K3).
extern "C" int bn_reduce_launch(int kernel, int path, int floor,
                                const void* dz, int dz_dtype, const void* x,
                                int x_dtype, const void* mean,
                                const void* rstd, const void* scale,
                                void* out0, void* out1, void* out2,
                                long long b, long long c, long long s,
                                float eps, int device, void* stream_ptr) {
  const Shape sh{b, c, s};
  const int err = start(device, sh);
  if (err) return err;
  Plan plan;
  return reduce(kernel, path, floor ? kFloor : kRun, dz, dz_dtype, x, x_dtype,
                static_cast<const float*>(mean),
                static_cast<const float*>(rstd),
                static_cast<const float*>(scale), static_cast<float*>(out0),
                static_cast<float*>(out1), static_cast<float*>(out2), sh, eps,
                device, static_cast<cudaStream_t>(stream_ptr), plan);
}

// The grid that bn_reduce_launch(kernel, path, ...) takes on these inputs
// on device: out[0..5] = path, threads per block, blocks per channel,
// blocks, channels per block, combine (0 one block, 1 cluster, 2 ticket).
extern "C" int bn_reduce_plan(int kernel, int path, const void* dz,
                              int dz_dtype, const void* x, int x_dtype,
                              long long b, long long c, long long s,
                              int device, int* out) {
  const Shape sh{b, c, s};
  const int err = start(device, sh);
  if (err) return err;
  Plan plan;
  const int result = reduce(kernel, path, kPlanOnly, dz, dz_dtype, x, x_dtype,
                            nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, sh, 0.0f, device, nullptr, plan);
  if (result) return result;
  out[0] = plan.path;
  out[1] = plan.threads;
  out[2] = plan.per_channel;
  out[3] = static_cast<int>(plan.blocks);
  out[4] = plan.tile;
  out[5] = plan.combine;
  return 0;
}

// K2 (kernel 0) or K4 (1) on a given path (0 vector, 1 lanes, 2 scalar,
// -1 the inputs' own), or with `floor` the empty kernel on the same grid.
// K2: out = (x - mean) * rstd * p0 + p1 (p0 scale, p1 bias; dz unused), in
// out_dtype.  K4: out = p0[0] * ((dz - p0[1]) - xhat * p0[2]) with p0 the
// coef [3, c] (p1 unused), in x's dtype.
extern "C" int bn_elementwise_launch(int kernel, int path, int floor,
                                     const void* dz, int dz_dtype,
                                     const void* x, int x_dtype,
                                     const void* mean, const void* rstd,
                                     const void* p0, const void* p1, void* out,
                                     int out_dtype, long long b, long long c,
                                     long long s, int device,
                                     void* stream_ptr) {
  const Shape sh{b, c, s};
  const int err = start(device, sh);
  if (err) return err;
  ElementwisePlan plan;
  return elementwise(kernel, path, floor ? kFloor : kRun, dz, dz_dtype, x,
                     x_dtype, static_cast<const float*>(mean),
                     static_cast<const float*>(rstd),
                     static_cast<const float*>(p0), static_cast<const float*>(p1),
                     out, out_dtype, sh, device,
                     static_cast<cudaStream_t>(stream_ptr), plan);
}

// The launch bn_elementwise_launch(kernel, path, ...) makes on these inputs
// on device (out null: a fresh allocation): result[0..7] = path, elements
// per vector, loads in flight per thread, threads per block, blocks,
// vectors per block, head and tail elements (one at a time).
extern "C" int bn_elementwise_plan(int kernel, int path, const void* dz,
                                   int dz_dtype, const void* x, int x_dtype,
                                   const void* out, int out_dtype, long long b,
                                   long long c, long long s, int device,
                                   int* result) {
  const Shape sh{b, c, s};
  const int err = start(device, sh);
  if (err) return err;
  ElementwisePlan plan;
  const int r = elementwise(kernel, path, kPlanOnly, dz, dz_dtype, x, x_dtype,
                            nullptr, nullptr, nullptr, nullptr,
                            const_cast<void*>(out), out_dtype, sh, device,
                            nullptr, plan);
  if (r) return r;
  const Run& run = plan.run;
  result[0] = plan.path;
  result[1] = plan.vec;
  result[2] = plan.unroll;
  result[3] = kElementwiseThreads;
  result[4] = static_cast<int>(plan.blocks);
  result[5] = static_cast<int>(run.chunk);
  result[6] = static_cast<int>(run.head);
  result[7] = static_cast<int>(run.total - run.head - run.nvec * plan.vec);
  return 0;
}

// K2 on the inputs' own path.  z = (x - mean) * rstd * scale + bias, z in
// dtype code z_dtype.
extern "C" int bn_apply_launch(const void* x, int x_dtype, const void* mean,
                               const void* rstd, const void* scale,
                               const void* bias, void* z, int z_dtype,
                               long long b, long long c, long long s,
                               int device, void* stream_ptr) {
  return bn_elementwise_launch(0, kPathAuto, 0, nullptr, 0, x, x_dtype, mean,
                               rstd, scale, bias, z, z_dtype, b, c, s, device,
                               stream_ptr);
}

// K4 on the inputs' own path.  dx = coef0 * (dz - coef1 - xhat * coef2),
// dx in x's dtype.
extern "C" int bn_dx_launch(const void* dz, int dz_dtype, const void* x,
                            int x_dtype, const void* mean, const void* rstd,
                            const void* coef, void* dx_out, long long b,
                            long long c, long long s, int device,
                            void* stream_ptr) {
  return bn_elementwise_launch(1, kPathAuto, 0, dz, dz_dtype, x, x_dtype,
                               mean, rstd, coef, nullptr, dx_out, x_dtype, b,
                               c, s, device, stream_ptr);
}

extern "C" const char* bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
