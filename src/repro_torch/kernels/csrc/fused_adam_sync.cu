// Fused AdamW step for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_adam_sync/kernel.py:
// fused_adamw (body _kernel).  One streaming pass over a flattened leaf:
//
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + (1 - b2) g g
//   p' = p (1 - lr wd) - lr (m' / (1 - b1^t)) / (sqrt(v' / (1 - b2^t)) + eps)
//
// with p in the parameter type (float32 or bfloat16) and g, m, v in
// float32.  The six hyperparameters (lr, b1, b2, eps, wd, t) are read
// from a [6] float32 device tensor, as the TPU kernel reads its [6]
// operand, so a changing learning rate or step needs no host value and no
// rebuild; t arrives as step + 1.
//
// What bounds it on this card: bytes.  Each element reads p, g, m, v and
// writes p, m, v -- 24 bytes with bfloat16 p, 28 with float32 -- for ~15
// float operations, far below the ~20 operations per byte the H100's
// float32 CUDA cores need to be the limit.
//
// What this first design does about it: every byte is moved once.  A
// grid-stride loop walks the leaf four elements per thread per iteration
// (16-byte loads and stores of g, m, v; 8 or 16 bytes of p) when every
// pointer is 16-byte aligned, one element at a time otherwise, and p, m
// and v are written in place.  Each thread reads the hyperparameters
// once.  Every product, sum, quotient and square root is an explicitly
// rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), so
// nvcc contracts nothing into fused multiply-adds and the arithmetic is
// the plain version's, operation for operation; only powf may differ
// from the host's pow in the last place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

template <typename P, bool kVec>
__global__ void __launch_bounds__(kThreads)
    fused_adamw_kernel(P* __restrict__ p, const float* __restrict__ g,
                       float* __restrict__ m, float* __restrict__ v,
                       const float* __restrict__ hyper, long long n) {
  const Hyper h = load_hyper(hyper);
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    using PV = typename Vec4<P>::type;
    const long long n4 = n / 4;
    for (long long j = i; j < n4; j += stride) {
      PV pv = reinterpret_cast<const PV*>(p)[j];
      const float4 gv = reinterpret_cast<const float4*>(g)[j];
      float4 mv = reinterpret_cast<const float4*>(m)[j];
      float4 vv = reinterpret_cast<const float4*>(v)[j];
      pv.x = from_float<P>(adamw(h, to_float(pv.x), gv.x, mv.x, vv.x));
      pv.y = from_float<P>(adamw(h, to_float(pv.y), gv.y, mv.y, vv.y));
      pv.z = from_float<P>(adamw(h, to_float(pv.z), gv.z, mv.z, vv.z));
      pv.w = from_float<P>(adamw(h, to_float(pv.w), gv.w, mv.w, vv.w));
      reinterpret_cast<PV*>(p)[j] = pv;
      reinterpret_cast<float4*>(m)[j] = mv;
      reinterpret_cast<float4*>(v)[j] = vv;
    }
    i += n4 * 4;  // the ragged tail, one element per thread
  }
  for (; i < n; i += stride) {
    float mi = m[i], vi = v[i];
    p[i] = from_float<P>(adamw(h, to_float(p[i]), g[i], mi, vi));
    m[i] = mi;
    v[i] = vi;
  }
}

template <typename P>
int launch(void* p, const void* g, void* m, void* v, const void* hyper,
           long long n, int vec, void* stream) {
  if (n <= 0) return 0;
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8;  // grid-stride beyond this
  if (blocks > cap) blocks = cap;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    fused_adamw_kernel<P, true><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<P*>(p), static_cast<const float*>(g),
        static_cast<float*>(m), static_cast<float*>(v),
        static_cast<const float*>(hyper), n);
  else
    fused_adamw_kernel<P, false><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<P*>(p), static_cast<const float*>(g),
        static_cast<float*>(m), static_cast<float*>(v),
        static_cast<const float*>(hyper), n);
  return (int)cudaGetLastError();
}

}  // namespace

// p [n] (float32 or bfloat16), g/m/v [n] float32, hyper [6] float32
// (lr, b1, b2, eps, wd, step + 1), all on the device.  p, m and v are
// updated in place.  vec != 0 promises 16-byte alignment of g, m, v and
// of p (8 bytes for bfloat16).  Launches on `stream`, allocates nothing,
// returns cudaGetLastError() after the launch.
extern "C" int fused_adamw_f32(void* p, const void* g, void* m, void* v,
                               const void* hyper, long long n, int vec,
                               void* stream) {
  return launch<float>(p, g, m, v, hyper, n, vec, stream);
}

extern "C" int fused_adamw_bf16(void* p, const void* g, void* m, void* v,
                                const void* hyper, long long n, int vec,
                                void* stream) {
  return launch<__nv_bfloat16>(p, g, m, v, hyper, n, vec, stream);
}
