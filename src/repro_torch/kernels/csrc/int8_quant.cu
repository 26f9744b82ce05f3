// Per-row symmetric int8 quantize / dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/int8_quant/kernel.py:
// quantize_rows (body _quant_kernel) and dequantize_rows (body
// _dequant_kernel).  For x [R, C] in float32:
//
//   scale[r] = max_c |x[r, c]| / 127 + 1e-12
//   q[r, c]  = clip(round_half_even(x[r, c] / scale[r]), -127, 127)
//   x'[r, c] = q[r, c] * scale[r]
//
// These are the wire format of the dreamddp-int8 partial sync, and the
// codes must equal the plain version's exactly: the scale is a division
// by 127 (not a product with its reciprocal), each code a correctly
// rounded division by the scale, rounded half to even with rintf (as
// jnp.round and torch.round do, not roundf).  A row of zeros gives
// scale 1e-12 and codes 0.
//
// What bounds them on this card: bytes.  Quantize reads 4 bytes and
// writes 1 per element (plus 4 per row); dequantize reads 1 and writes 4.
// Neither does more than a few operations per byte.
//
// What this first design does about it: one warp per row.  The warp
// reads its row once for the max-abs reduction (lane-strided, 16-byte
// loads when C is a multiple of 4, a shuffle reduction), then reads it
// again for the codes -- that second read mostly hits L1/L2, since a row
// is at most a few tens of KB -- and writes the codes four at a time.
// Dequantize is a grid-stride elementwise pass, four codes per thread.
// A row-per-warp grid has R/8 blocks of 8 warps, plenty at the sync's
// shapes (R in the thousands or more).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ signed char code(float x, float scale) {
  float y = rintf(__fdiv_rn(x, scale));
  y = fminf(fmaxf(y, -127.0f), 127.0f);
  return (signed char)(int)y;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    quantize_rows_kernel(const float* __restrict__ x,
                         signed char* __restrict__ q,
                         float* __restrict__ scale, long long rows, int cols) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + row * cols;
  signed char* qr = q + row * cols;
  float amax = 0.0f;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int c = lane; c < cols / 4; c += 32) {
      const float4 t = x4[c];
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(t.x), fabsf(t.y)),
                               fmaxf(fabsf(t.z), fabsf(t.w))));
    }
  } else {
    for (int c = lane; c < cols; c += 32) amax = fmaxf(amax, fabsf(xr[c]));
  }
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fadd_rn(__fdiv_rn(amax, 127.0f), 1e-12f);
  if (lane == 0) scale[row] = s;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    char4* q4 = reinterpret_cast<char4*>(qr);
    for (int c = lane; c < cols / 4; c += 32) {
      const float4 t = x4[c];
      q4[c] = make_char4(code(t.x, s), code(t.y, s), code(t.z, s),
                         code(t.w, s));
    }
  } else {
    for (int c = lane; c < cols; c += 32) qr[c] = code(xr[c], s);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    dequantize_rows_kernel(const signed char* __restrict__ q,
                           const float* __restrict__ scale,
                           float* __restrict__ out, long long rows,
                           int cols) {
  const long long n = rows * cols;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {  // cols % 4 == 0: a group of four never straddles rows
    const char4* q4 = reinterpret_cast<const char4*>(q);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long j = i0; j < n / 4; j += stride) {
      const char4 t = q4[j];
      const float s = scale[(j * 4) / cols];
      o4[j] = make_float4(__fmul_rn((float)t.x, s), __fmul_rn((float)t.y, s),
                          __fmul_rn((float)t.z, s), __fmul_rn((float)t.w, s));
    }
  } else {
    for (long long j = i0; j < n; j += stride)
      out[j] = __fmul_rn((float)q[j], scale[j / cols]);
  }
}

int grid_for(long long work) {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8;
  return (int)(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

}  // namespace

// x [rows, cols] float32 (contiguous) -> q [rows, cols] int8, scale [rows]
// float32.  vec != 0 promises cols % 4 == 0 and 16-byte aligned x, q
// rows 4-byte aligned.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError() after the launch.
extern "C" int quantize_rows_f32(const void* x, void* q, void* scale,
                                 long long rows, int cols, int vec,
                                 void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    quantize_rows_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<signed char*>(q),
        static_cast<float*>(scale), rows, cols);
  else
    quantize_rows_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<signed char*>(q),
        static_cast<float*>(scale), rows, cols);
  return (int)cudaGetLastError();
}

// q [rows, cols] int8, scale [rows] float32 -> out [rows, cols] float32.
// vec != 0 promises cols % 4 == 0 and aligned q (4 bytes) and out (16).
extern "C" int dequantize_rows_f32(const void* q, const void* scale,
                                   void* out, long long rows, int cols,
                                   int vec, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const long long n = rows * cols;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    dequantize_rows_kernel<true><<<grid_for(n / 4), kThreads, 0, s>>>(
        static_cast<const signed char*>(q), static_cast<const float*>(scale),
        static_cast<float*>(out), rows, cols);
  else
    dequantize_rows_kernel<false><<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const signed char*>(q), static_cast<const float*>(scale),
        static_cast<float*>(out), rows, cols);
  return (int)cudaGetLastError();
}
