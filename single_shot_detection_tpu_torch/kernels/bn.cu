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
// loss on the TPU.  Where S % 4 == 0 and every pointer is aligned, a thread
// moves 4 elements per load (16 bytes in f32); otherwise one.
//
// Bound.  All four are bound by bytes: K1 reads x (4E bytes in f32 for E
// elements), K2 reads x and writes z (8E), K3 reads dz and x (8E), K4 reads
// dz and x and writes dx (12E).  Each does a few flops per element, far
// below the card's rate, so the design goal is to keep enough 16-byte loads
// in flight and to spend few instructions per element on addressing.
//
// Reductions (K1, K3).  Blocks run in no order on Hopper, so the Pallas
// kernels' sequential-grid accumulator becomes a deterministic two-stage
// sum: block (c, g) reduces chunk g of channel c's B*S elements into one
// partial (thread registers, then warp shuffles, then shared memory in a
// fixed order) and writes it to a scratch buffer the wrapper allocates; a
// combine kernel then sums channel c's G partials with one warp in a fixed
// order and derives the per-channel values (mean, var, rstd for K1; d_beta,
// d_gamma and K4's coefficients for K3).  No atomics, so a result does not
// change from run to run.  G grows with B*S (one chunk per 8192 elements, at
// most 1024), so both a channel of 720,000 elements ([32, 96, 150, 150]) and
// one of 32 ([32, 128, 1, 1]) fill the card with blocks of useful size.
// Within a chunk a thread walks the channel's elements with a cursor that
// advances by whole planes and offsets (no division per element).
//
// Elementwise passes (K2, K4).  A grid-stride loop over the flat tensor;
// each thread carries the channel index of its position forward by adding
// the stride's plane and channel steps, so no division per element either.
//
// Numerics.  Statistics, sums and coefficients are f32; x, dz, z and dx may
// be f32 or bf16 (z in the output type, dx in x's type).  The file is built
// with --fmad=false and never --use_fast_math, so each product and sum is
// rounded as the plain PyTorch version rounds it; only the order of the
// reductions differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kChunkElements = 8192;
constexpr long long kMaxChunks = 1024;
constexpr long long kMaxElementwiseBlocks = 4096;

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

// Sum of (a, b) over the block, in a fixed order; the result is valid in
// thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps], sb[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? sa[lane] : 0.0f;
    b = lane < kWarps ? sb[lane] : 0.0f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

// Walks channel c's vectors j = start, start + blockDim.x, ... in the
// [B, C, Sv] vector view: `addr` is the vector index of (b, c, s).
struct ChannelCursor {
  long long s, addr, r, jump, wrap, sv;
  __device__ ChannelCursor(long long j, long long c, long long C,
                           long long Sv) {
    const long long b = j / Sv;
    sv = Sv;
    s = j - b * Sv;
    addr = (b * C + c) * Sv + s;
    const long long q = blockDim.x / Sv;
    r = blockDim.x - q * Sv;
    jump = q * C * Sv + r;
    wrap = (C - 1) * Sv;  // from the end of plane b to the start of plane b+1
  }
  __device__ __forceinline__ void advance() {
    s += r;
    addr += jump;
    if (s >= sv) {
      s -= sv;
      addr += wrap;
    }
  }
};

// Walks the flat vector index i = global thread id, += grid stride, carrying
// the channel of i in the [B, C, Sv] view.
struct FlatCursor {
  long long i, s, c, r, qc, stride, sv, nc;
  __device__ FlatCursor(long long C, long long Sv) {
    i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    stride = static_cast<long long>(gridDim.x) * blockDim.x;
    const long long plane = i / Sv;
    s = i - plane * Sv;
    c = plane % C;
    const long long q = stride / Sv;
    r = stride - q * Sv;
    qc = q % C;
    sv = Sv;
    nc = C;
  }
  __device__ __forceinline__ void advance() {
    i += stride;
    s += r;
    const long long carry = s >= sv;
    s -= carry * sv;
    c += qc + carry;
    if (c >= nc) c -= nc;
  }
};

// ------------------------------------------------------------------ K1

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial_kernel(const T* __restrict__ x, float* __restrict__ partial,
                        long long C, long long Sv, long long nv, long long Lv,
                        int G) {
  const long long c = blockIdx.x;
  const int g = blockIdx.y;
  long long j = g * Lv + threadIdx.x;
  const long long end = min((g + 1) * Lv, nv);
  ChannelCursor cur(j, c, C, Sv);
  float sum = 0.0f, sq = 0.0f;
  for (; j < end; j += blockDim.x) {
    float v[V];
    load<T, V>(x, cur.addr, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sum += v[k];
      sq += v[k] * v[k];
    }
    cur.advance();
  }
  block_sum2(sum, sq);
  if (threadIdx.x == 0) {
    partial[c * G + g] = sum;
    partial[(C + c) * G + g] = sq;
  }
}

// One warp per channel: sums the G partials of channel c in a fixed order.
__device__ __forceinline__ bool combine(const float* __restrict__ partial,
                                        long long C, int G, long long& c,
                                        float& a, float& b) {
  const int lane = threadIdx.x & 31;
  c = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (c >= C) return false;
  a = 0.0f;
  b = 0.0f;
  for (int g = lane; g < G; g += 32) {
    a += partial[c * G + g];
    b += partial[(C + c) * G + g];
  }
  a = warp_sum(a);
  b = warp_sum(b);
  return lane == 0;
}

__global__ void __launch_bounds__(kThreads)
bn_stats_combine_kernel(const float* __restrict__ partial,
                        float* __restrict__ mean, float* __restrict__ var,
                        float* __restrict__ rstd, long long C, int G, float n,
                        float eps) {
  long long c;
  float sum, sq;
  if (!combine(partial, C, G, c, sum, sq)) return;
  const float m = sum / n;
  const float v = fmaxf(0.0f, sq / n - m * m);
  mean[c] = m;
  var[c] = v;
  rstd[c] = 1.0f / sqrtf(v + eps);
}

// ------------------------------------------------------------------ K2

template <typename TX, typename TZ, int V>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const TX* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ rstd, const float* __restrict__ scale,
                const float* __restrict__ bias, TZ* __restrict__ z, long long C,
                long long Sv, long long nv) {
  for (FlatCursor cur(C, Sv); cur.i < nv; cur.advance()) {
    const float m = mean[cur.c], r = rstd[cur.c], a = scale[cur.c],
                b = bias[cur.c];
    float v[V];
    load<TX, V>(x, cur.i, v);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = (v[k] - m) * r * a + b;
    store<TZ, V>(z, cur.i, v);
  }
}

// ------------------------------------------------------------------ K3

template <typename TG, typename TX, int V>
__global__ void __launch_bounds__(kThreads)
bn_grad_sums_partial_kernel(const TG* __restrict__ dz,
                            const TX* __restrict__ x,
                            const float* __restrict__ mean,
                            const float* __restrict__ rstd,
                            float* __restrict__ partial, long long C,
                            long long Sv, long long nv, long long Lv, int G) {
  const long long c = blockIdx.x;
  const int g = blockIdx.y;
  const float m = mean[c], r = rstd[c];
  long long j = g * Lv + threadIdx.x;
  const long long end = min((g + 1) * Lv, nv);
  ChannelCursor cur(j, c, C, Sv);
  float sum_g = 0.0f, sum_gx = 0.0f;
  for (; j < end; j += blockDim.x) {
    float gv[V], xv[V];
    load<TG, V>(dz, cur.addr, gv);
    load<TX, V>(x, cur.addr, xv);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sum_g += gv[k];
      sum_gx += gv[k] * ((xv[k] - m) * r);
    }
    cur.advance();
  }
  block_sum2(sum_g, sum_gx);
  if (threadIdx.x == 0) {
    partial[c * G + g] = sum_g;
    partial[(C + c) * G + g] = sum_gx;
  }
}

// coef rows, as the Pallas K4 takes them: 0 = rstd * scale,
// 1 = d_beta / n, 2 = d_gamma / n.
__global__ void __launch_bounds__(kThreads)
bn_grad_sums_combine_kernel(const float* __restrict__ partial,
                            const float* __restrict__ rstd,
                            const float* __restrict__ scale,
                            float* __restrict__ d_gamma,
                            float* __restrict__ d_beta,
                            float* __restrict__ coef, long long C, int G,
                            float n) {
  long long c;
  float sum_g, sum_gx;
  if (!combine(partial, C, G, c, sum_g, sum_gx)) return;
  d_beta[c] = sum_g;
  d_gamma[c] = sum_gx;
  coef[c] = rstd[c] * scale[c];
  coef[C + c] = sum_g / n;
  coef[2 * C + c] = sum_gx / n;
}

// ------------------------------------------------------------------ K4

template <typename TG, typename TX, int V>
__global__ void __launch_bounds__(kThreads)
bn_dx_kernel(const TG* __restrict__ dz, const TX* __restrict__ x,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             const float* __restrict__ coef, TX* __restrict__ dx, long long C,
             long long Sv, long long nv) {
  for (FlatCursor cur(C, Sv); cur.i < nv; cur.advance()) {
    const float m = mean[cur.c], r = rstd[cur.c], k0 = coef[cur.c],
                k1 = coef[C + cur.c], k2 = coef[2 * C + cur.c];
    float gv[V], xv[V];
    load<TG, V>(dz, cur.i, gv);
    load<TX, V>(x, cur.i, xv);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xhat = (xv[k] - m) * r;
      gv[k] = k0 * ((gv[k] - k1) - xhat * k2);
    }
    store<TX, V>(dx, cur.i, gv);
  }
}

// ------------------------------------------------------------------ host

struct Shape {
  long long b, c, s;
  bool ok() const { return b > 0 && c > 0 && s > 0; }
  long long elements_per_channel() const { return b * s; }
};

long long chunks(long long per_channel) {
  const long long g = (per_channel + kChunkElements - 1) / kChunkElements;
  return g < 1 ? 1 : (g > kMaxChunks ? kMaxChunks : g);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// 4 when every tensor can be moved 4 elements at a time without a vector
// crossing a plane, else 1.
int vector_width(long long s, std::initializer_list<std::pair<const void*, size_t>> ptrs) {
  if (s % 4) return 1;
  for (const auto& p : ptrs)
    if (!aligned(p.first, 4 * p.second)) return 1;
  return 4;
}

size_t itemsize(int dtype) { return dtype == kBFloat16 ? 2 : 4; }

bool valid_dtype(int dtype) { return dtype == kFloat32 || dtype == kBFloat16; }

unsigned int elementwise_blocks(long long nv) {
  const long long blocks = (nv + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(
      blocks > kMaxElementwiseBlocks ? kMaxElementwiseBlocks : blocks);
}

unsigned int combine_blocks(long long c) {
  return static_cast<unsigned int>((c + kWarps - 1) / kWarps);
}

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

template <typename T, int V>
void stats_partial(const void* x, float* partial, const Shape& sh, int G,
                   cudaStream_t stream) {
  const long long sv = sh.s / V, nv = sh.b * sv;
  const long long lv = (nv + G - 1) / G;
  bn_stats_partial_kernel<T, V>
      <<<dim3(static_cast<unsigned int>(sh.c), G), kThreads, 0, stream>>>(
          static_cast<const T*>(x), partial, sh.c, sv, nv, lv, G);
}

template <typename TX, typename TZ, int V>
void apply(const void* x, const float* mean, const float* rstd,
           const float* scale, const float* bias, void* z, const Shape& sh,
           cudaStream_t stream) {
  const long long sv = sh.s / V, nv = sh.b * sh.c * sv;
  bn_apply_kernel<TX, TZ, V><<<elementwise_blocks(nv), kThreads, 0, stream>>>(
      static_cast<const TX*>(x), mean, rstd, scale, bias, static_cast<TZ*>(z),
      sh.c, sv, nv);
}

template <typename TG, typename TX, int V>
void grad_partial(const void* dz, const void* x, const float* mean,
                  const float* rstd, float* partial, const Shape& sh, int G,
                  cudaStream_t stream) {
  const long long sv = sh.s / V, nv = sh.b * sv;
  const long long lv = (nv + G - 1) / G;
  bn_grad_sums_partial_kernel<TG, TX, V>
      <<<dim3(static_cast<unsigned int>(sh.c), G), kThreads, 0, stream>>>(
          static_cast<const TG*>(dz), static_cast<const TX*>(x), mean, rstd,
          partial, sh.c, sv, nv, lv, G);
}

template <typename TG, typename TX, int V>
void dx(const void* dz, const void* x, const float* mean, const float* rstd,
        const float* coef, void* out, const Shape& sh, cudaStream_t stream) {
  const long long sv = sh.s / V, nv = sh.b * sh.c * sv;
  bn_dx_kernel<TG, TX, V><<<elementwise_blocks(nv), kThreads, 0, stream>>>(
      static_cast<const TG*>(dz), static_cast<const TX*>(x), mean, rstd, coef,
      static_cast<TX*>(out), sh.c, sv, nv);
}

}  // namespace

// Floats of scratch the reductions (K1, K3) need: 2 * C * chunks.
extern "C" long long bn_partial_floats(long long b, long long c, long long s) {
  return 2 * c * chunks(b * s);
}

// K1.  x [b, c, s] (dtype code x_dtype) -> mean, var, rstd [c] f32.
// partial: bn_partial_floats(b, c, s) floats.
extern "C" int bn_stats_launch(const void* x, int x_dtype, void* partial,
                               void* mean, void* var, void* rstd, long long b,
                               long long c, long long s, float eps, int device,
                               void* stream_ptr) {
  const Shape sh{b, c, s};
  int err = start(device, sh);
  if (err) return err;
  if (!valid_dtype(x_dtype)) return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int G = static_cast<int>(chunks(sh.elements_per_channel()));
  const int vec = vector_width(s, {{x, itemsize(x_dtype)}});
  with_type(x_dtype, [&](auto t) {
    using T = decltype(t);
    if (vec == 4)
      stats_partial<T, 4>(x, static_cast<float*>(partial), sh, G, stream);
    else
      stats_partial<T, 1>(x, static_cast<float*>(partial), sh, G, stream);
  });
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  bn_stats_combine_kernel<<<combine_blocks(c), kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(mean),
      static_cast<float*>(var), static_cast<float*>(rstd), c, G,
      static_cast<float>(b * s), eps);
  return static_cast<int>(cudaGetLastError());
}

// K2.  z = (x - mean) * rstd * scale + bias, z in dtype code z_dtype.
extern "C" int bn_apply_launch(const void* x, int x_dtype, const void* mean,
                               const void* rstd, const void* scale,
                               const void* bias, void* z, int z_dtype,
                               long long b, long long c, long long s,
                               int device, void* stream_ptr) {
  const Shape sh{b, c, s};
  int err = start(device, sh);
  if (err) return err;
  if (!valid_dtype(x_dtype) || !valid_dtype(z_dtype)) return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int vec = vector_width(s, {{x, itemsize(x_dtype)}, {z, itemsize(z_dtype)}});
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  const float* a = static_cast<const float*>(scale);
  const float* bb = static_cast<const float*>(bias);
  with_type(x_dtype, [&](auto tx) {
    with_type(z_dtype, [&](auto tz) {
      using TX = decltype(tx);
      using TZ = decltype(tz);
      if (vec == 4)
        apply<TX, TZ, 4>(x, m, r, a, bb, z, sh, stream);
      else
        apply<TX, TZ, 1>(x, m, r, a, bb, z, sh, stream);
    });
  });
  return static_cast<int>(cudaGetLastError());
}

// K3.  dz (dz_dtype) and x (x_dtype) [b, c, s] -> d_gamma, d_beta [c] and
// coef [3, c] f32.  partial: bn_partial_floats(b, c, s) floats.
extern "C" int bn_grad_sums_launch(const void* dz, int dz_dtype, const void* x,
                                   int x_dtype, const void* mean,
                                   const void* rstd, const void* scale,
                                   void* partial, void* d_gamma, void* d_beta,
                                   void* coef, long long b, long long c,
                                   long long s, int device, void* stream_ptr) {
  const Shape sh{b, c, s};
  int err = start(device, sh);
  if (err) return err;
  if (!valid_dtype(dz_dtype) || !valid_dtype(x_dtype)) return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int G = static_cast<int>(chunks(sh.elements_per_channel()));
  const int vec = vector_width(s, {{dz, itemsize(dz_dtype)}, {x, itemsize(x_dtype)}});
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(partial);
  with_type(dz_dtype, [&](auto tg) {
    with_type(x_dtype, [&](auto tx) {
      using TG = decltype(tg);
      using TX = decltype(tx);
      if (vec == 4)
        grad_partial<TG, TX, 4>(dz, x, m, r, p, sh, G, stream);
      else
        grad_partial<TG, TX, 1>(dz, x, m, r, p, sh, G, stream);
    });
  });
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  bn_grad_sums_combine_kernel<<<combine_blocks(c), kThreads, 0, stream>>>(
      p, r, static_cast<const float*>(scale), static_cast<float*>(d_gamma),
      static_cast<float*>(d_beta), static_cast<float*>(coef), c, G,
      static_cast<float>(b * s));
  return static_cast<int>(cudaGetLastError());
}

// K4.  dx = coef0 * (dz - coef1 - xhat * coef2), dx in x's dtype.
extern "C" int bn_dx_launch(const void* dz, int dz_dtype, const void* x,
                            int x_dtype, const void* mean, const void* rstd,
                            const void* coef, void* dx_out, long long b,
                            long long c, long long s, int device,
                            void* stream_ptr) {
  const Shape sh{b, c, s};
  int err = start(device, sh);
  if (err) return err;
  if (!valid_dtype(dz_dtype) || !valid_dtype(x_dtype)) return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int vec = vector_width(s, {{dz, itemsize(dz_dtype)},
                                   {x, itemsize(x_dtype)},
                                   {dx_out, itemsize(x_dtype)}});
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  const float* k = static_cast<const float*>(coef);
  with_type(dz_dtype, [&](auto tg) {
    with_type(x_dtype, [&](auto tx) {
      using TG = decltype(tg);
      using TX = decltype(tx);
      if (vec == 4)
        dx<TG, TX, 4>(dz, x, m, r, k, dx_out, sh, stream);
      else
        dx<TG, TX, 1>(dz, x, m, r, k, dx_out, sh, stream);
    });
  });
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
