// Fused AdamW step and the global-norm clip it reads, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_adam_sync/kernel.py:
// fused_adamw (body _kernel).  One streaming pass over a flattened leaf:
//
//   g' = g s                                   (s the clip's scale, or 1)
//   m' = b1 m + (1 - b1) g'
//   v' = b2 v + (1 - b2) g' g'
//   p' = p (1 - lr wd) - lr (m' / (1 - b1^t)) / (sqrt(v' / (1 - b2^t)) + eps)
//
// with p in the parameter type (float32 or bfloat16), g in its own type
// (float32 or bfloat16: bfloat16 gradients are read as they are, with no
// float32 copy) and m, v in float32.  The six hyperparameters (lr, b1,
// b2, eps, wd, t) are read from a [6] float32 device tensor, as the TPU
// kernel reads its [6] operand, so a changing learning rate or step needs
// no host value and no rebuild; t arrives as step + 1.  The clip's scale
// s is a float32 device scalar too (null: no clip), written by the norm
// kernels below.  g' = fl(float(g) s) is one rounding, as the plain
// version's g.float() * s; without a scale s is 1, which leaves g exact.
//
// What bounds it on this card: bytes.  Each element reads p, g, m, v and
// writes p, m, v -- 22 bytes with bfloat16 p and g, 24 with bfloat16 p
// and float32 g, 28 with float32 p and g -- for ~16 float operations, far
// below the ~20 operations per byte the H100's float32 CUDA cores need to
// be the limit.
//
// What the design does about it: every byte is moved once.  A
// grid-stride loop walks the leaf four elements per thread per iteration
// (16-byte loads and stores of m and v; 8 or 16 bytes of p and of g) when
// every pointer is aligned to its four elements, one element at a time
// otherwise, and p, m and v are written in place.  The grid is one wave:
// as many blocks as the SMs hold at once (8 blocks an SM left a partial
// second wave, 2.3% slower on the largest leaf).  Each thread reads the
// hyperparameters and the scale once.  Every product, sum, quotient and
// square root is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), so nvcc contracts nothing into fused
// multiply-adds and the arithmetic is the plain version's, operation for
// operation; only powf may differ from the host's pow in the last place.
//
// The clip's scale (grad_sumsq_kernel, then clip_scale_kernel).  The
// reference clips by ONE norm over the whole gradient tree, every
// worker's leaves together.  Each leaf is read once in its own type
// (16-byte loads where aligned) and its squares summed in float32 by a
// grid whose size depends on the leaf's length alone; each block writes
// one partial into a scratch array the caller owns, at the leaf's fixed
// offset.  One block then sums every partial in a fixed order (in
// double) and writes s = min(max_norm / (sqrt(total) + 1e-9), 1), taken
// as the plain version takes it.  No atomics: a graph replay and the
// per-step path give the same bits.  Bytes bound the read: 2 or 4 an
// element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScaleThreads = 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

struct Hyper {
  float lr, b1, b2, eps, one_m_b1, one_m_b2, bc1, bc2, decay;
};

__device__ __forceinline__ Hyper load_hyper(const float* h) {
  Hyper o;
  o.lr = h[0];
  o.b1 = h[1];
  o.b2 = h[2];
  o.eps = h[3];
  const float wd = h[4], t = h[5];
  o.one_m_b1 = __fsub_rn(1.0f, o.b1);
  o.one_m_b2 = __fsub_rn(1.0f, o.b2);
  o.bc1 = __fsub_rn(1.0f, powf(o.b1, t));
  o.bc2 = __fsub_rn(1.0f, powf(o.b2, t));
  o.decay = __fsub_rn(1.0f, __fmul_rn(o.lr, wd));
  return o;
}

// One element: updates m and v in place and returns p' in float32.
__device__ __forceinline__ float adamw(const Hyper& h, float p, float g,
                                       float& m, float& v) {
  const float m2 = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_m_b1, g));
  const float v2 =
      __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.one_m_b2, g), g));
  const float upd = __fdiv_rn(
      __fdiv_rn(m2, h.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, h.bc2)), h.eps));
  m = m2;
  v = v2;
  return __fsub_rn(__fmul_rn(p, h.decay), __fmul_rn(h.lr, upd));
}

template <typename P>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  struct alignas(8) type {
    __nv_bfloat16 x, y, z, w;
  };
};

template <typename P, typename G, bool kVec>
__global__ void __launch_bounds__(kThreads)
    fused_adamw_kernel(P* __restrict__ p, const G* __restrict__ g,
                       float* __restrict__ m, float* __restrict__ v,
                       const float* __restrict__ hyper,
                       const float* __restrict__ scale, long long n) {
  const Hyper h = load_hyper(hyper);
  const float s = scale ? *scale : 1.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    using PV = typename Vec4<P>::type;
    using GV = typename Vec4<G>::type;
    const long long n4 = n / 4;
    for (long long j = i; j < n4; j += stride) {
      PV pv = reinterpret_cast<const PV*>(p)[j];
      const GV gv = reinterpret_cast<const GV*>(g)[j];
      float4 mv = reinterpret_cast<const float4*>(m)[j];
      float4 vv = reinterpret_cast<const float4*>(v)[j];
      pv.x = from_float<P>(adamw(h, to_float(pv.x),
                                 __fmul_rn(to_float(gv.x), s), mv.x, vv.x));
      pv.y = from_float<P>(adamw(h, to_float(pv.y),
                                 __fmul_rn(to_float(gv.y), s), mv.y, vv.y));
      pv.z = from_float<P>(adamw(h, to_float(pv.z),
                                 __fmul_rn(to_float(gv.z), s), mv.z, vv.z));
      pv.w = from_float<P>(adamw(h, to_float(pv.w),
                                 __fmul_rn(to_float(gv.w), s), mv.w, vv.w));
      reinterpret_cast<PV*>(p)[j] = pv;
      reinterpret_cast<float4*>(m)[j] = mv;
      reinterpret_cast<float4*>(v)[j] = vv;
    }
    i += n4 * 4;  // the ragged tail, one element per thread
  }
  for (; i < n; i += stride) {
    float mi = m[i], vi = v[i];
    p[i] = from_float<P>(
        adamw(h, to_float(p[i]), __fmul_rn(to_float(g[i]), s), mi, vi));
    m[i] = mi;
    v[i] = vi;
  }
}

template <typename P, typename G>
int launch(void* p, const void* g, void* m, void* v, const void* hyper,
           const void* scale, long long n, int vec, void* stream) {
  if (n <= 0) return 0;
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // grid-stride beyond one wave: as many blocks as the SMs hold at once,
  // so no second, partial wave of blocks trails the first
  static int resident[2] = {0, 0};
  int& per_sm = resident[vec ? 1 : 0];
  if (per_sm == 0) {
    const auto kernel = vec ? fused_adamw_kernel<P, G, true>
                            : fused_adamw_kernel<P, G, false>;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
            cudaSuccess ||
        per_sm <= 0)
      per_sm = 4;
  }
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * per_sm;
  if (blocks > cap) blocks = cap;
  cudaStream_t st = (cudaStream_t)stream;
  P* pt = static_cast<P*>(p);
  const G* gt = static_cast<const G*>(g);
  float* mt = static_cast<float*>(m);
  float* vt = static_cast<float*>(v);
  const float* ht = static_cast<const float*>(hyper);
  const float* sc = static_cast<const float*>(scale);
  if (vec)
    fused_adamw_kernel<P, G, true><<<(unsigned)blocks, kThreads, 0, st>>>(
        pt, gt, mt, vt, ht, sc, n);
  else
    fused_adamw_kernel<P, G, false><<<(unsigned)blocks, kThreads, 0, st>>>(
        pt, gt, mt, vt, ht, sc, n);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ the clip

// The sum of a block's per-thread values, in a fixed order: a warp's by
// shuffles, then the warps' in the first warp.  Thread 0 holds it.
template <typename T, int kBlock>
__device__ __forceinline__ T block_sum(T x) {
  __shared__ T warp_sums[kBlock / 32];
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = threadIdx.x < kBlock / 32 ? warp_sums[threadIdx.x] : T(0);
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// Squares of one leaf summed in float32 into partials[blockIdx.x].  With
// kVec the leaf is read in 16-byte vectors (8 bfloat16 or 4 float32), one
// float32 accumulator per vector slot, then the ragged tail one element
// per thread.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    grad_sumsq_kernel(const T* __restrict__ x, long long n,
                      float* __restrict__ partials) {
  constexpr int kPer = 16 / sizeof(T);
  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    const long long nv = n / kPer;
    for (long long j = i; j < nv; j += stride) {
      const uint4 raw = reinterpret_cast<const uint4*>(x)[j];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float f = to_float(e[k]);
        acc[k] = fmaf(f, f, acc[k]);
      }
    }
    i += nv * kPer;
  }
  for (; i < n; i += stride) {
    const float f = to_float(x[i]);
    acc[0] = fmaf(f, f, acc[0]);
  }
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) sum += acc[k];
  sum = block_sum<float, kThreads>(sum);
  if (threadIdx.x == 0) partials[blockIdx.x] = sum;
}

// out[0] = min(max_norm / (sqrt(total) + 1e-9), 1) and out[1] = total,
// with total the sum of partials[0 .. count), taken in double in a fixed
// order and rounded once to float32.  max_norm / x is taken as PyTorch
// takes a number over a tensor: x's reciprocal times the number.  A NaN
// total gives a NaN scale, as torch.clamp passes it on.
__global__ void __launch_bounds__(kScaleThreads)
    clip_scale_kernel(const float* __restrict__ partials, int count,
                      float max_norm, float* __restrict__ out) {
  double sum = 0.0;
  for (int i = threadIdx.x; i < count; i += kScaleThreads)
    sum += (double)partials[i];
  sum = block_sum<double, kScaleThreads>(sum);
  if (threadIdx.x == 0) {
    const float total = (float)sum;
    const float norm = __fsqrt_rn(total);
    const float q = __fmul_rn(__frcp_rn(__fadd_rn(norm, 1e-9f)), max_norm);
    out[0] = q > 1.0f ? 1.0f : q;
    out[1] = total;
  }
}

template <typename T>
int launch_sumsq(const void* x, long long n, int vec, int blocks,
                 void* partials, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const T* xt = static_cast<const T*>(x);
  float* out = static_cast<float*>(partials);
  if (vec)
    grad_sumsq_kernel<T, true><<<blocks, kThreads, 0, st>>>(xt, n, out);
  else
    grad_sumsq_kernel<T, false><<<blocks, kThreads, 0, st>>>(xt, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// p [n] (float32 or bfloat16), g [n] (float32 or bfloat16), m/v [n]
// float32, hyper [6] float32 (lr, b1, b2, eps, wd, step + 1), scale a
// float32 scalar or null, all on the device.  p, m and v are updated in
// place.  vec != 0 promises m and v 16-byte aligned and p and g aligned
// to four of their elements.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError() after the launch.
#define FUSED_ADAMW(NAME, P, G)                                             \
  extern "C" int NAME(void* p, const void* g, void* m, void* v,             \
                      const void* hyper, const void* scale, long long n,    \
                      int vec, void* stream) {                              \
    return launch<P, G>(p, g, m, v, hyper, scale, n, vec, stream);          \
  }
FUSED_ADAMW(fused_adamw_f32_f32, float, float)
FUSED_ADAMW(fused_adamw_f32_bf16, float, __nv_bfloat16)
FUSED_ADAMW(fused_adamw_bf16_f32, __nv_bfloat16, float)
FUSED_ADAMW(fused_adamw_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
#undef FUSED_ADAMW

// The squares of x [n] (float32 or bfloat16) summed by `blocks` blocks
// into partials[0 .. blocks).  vec != 0 promises 16-byte alignment of x.
extern "C" int grad_sumsq_f32(const void* x, long long n, int vec,
                              int blocks, void* partials, void* stream) {
  if (n <= 0 || blocks <= 0) return 0;
  return launch_sumsq<float>(x, n, vec, blocks, partials, stream);
}

extern "C" int grad_sumsq_bf16(const void* x, long long n, int vec,
                               int blocks, void* partials, void* stream) {
  if (n <= 0 || blocks <= 0) return 0;
  return launch_sumsq<__nv_bfloat16>(x, n, vec, blocks, partials, stream);
}

// out[0] the clip's scale and out[1] the sum of squares, from
// partials[0 .. count) (float32, on the device): one block.
extern "C" int clip_scale_finalize(const void* partials, int count,
                                   float max_norm, void* out, void* stream) {
  clip_scale_kernel<<<1, kScaleThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(partials), count, max_norm,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
