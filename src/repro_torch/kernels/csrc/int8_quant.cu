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
// Why the first quantize design reached half of that bound: it gave each
// row one warp, which read the row once for max|x| and again for the
// codes.  At full occupancy 64 warps an SM stream 64 rows, so between the
// two reads of an element the card reads ~64 x 132 other rows (270 MB at
// 8192 columns, 68 MB at 2048), more than the 50 MB L2: the second read
// came from HBM again, 9 bytes an element instead of 5.
//
// What this design does about it: every element of x is read from HBM
// once.  A row is cut over T threads (a warp up to 512 threads) that each
// load V float4 (or 4V scalars) into registers, all loads issued before
// the max reduction (warp shuffles, then a float per warp in shared
// memory across the row's warps); the codes are computed from those
// registers.  T and V come from the wrapper's table (ops.py,
// quantize_geometry), four rows: up to 512 columns one warp of 4 float4
// a lane, 2048 four warps of 4, 8192 256 threads of 8, 16384 512 threads
// of 8.  Loads are coalesced (slot
// i*T + t), stores are char4 per lane, so a warp's store is one 128-byte
// line.  A block holds 256 threads (256 / T rows) up to T = 256, so
// thousands of blocks keep 4-8 rows of loads in flight on every SM.
// Rows wider than the register table (16384 floats) are staged in
// dynamic shared memory, up to 57344 floats (224 KB), by one 1024-thread
// block a row, and still read once; wider rows read x twice (the second
// read mostly from L2: 132 rows of >224 KB in flight).  The division stays
// __fdiv_rn.  Its reciprocal is not hoisted (a MUFU.RCP, ~5 FFMA and an
// FCHK an element; at most 29 SASS instructions an element in all at
// 256 x 8), which asks the SMs for at most two thirds of their issue rate
// at the byte bound: it does not cap the kernel, which runs at ~91% of
// that bound on an H100 SXM (700 W) at the sync's 2048- and 8192-wide rows.
// Dequantize is a grid-stride elementwise pass, four codes per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // a block of the register kernel
constexpr int kLoopThreads = 1024;       // a block of the staged kernel
constexpr int kMaxStaged = 57344;        // floats of a row in shared memory

__device__ __forceinline__ signed char code(float x, float scale) {
  float y = rintf(__fdiv_rn(x, scale));
  y = fminf(fmaxf(y, -127.0f), 127.0f);
  return (signed char)(int)y;
}

__device__ __forceinline__ float scale_of(float amax) {
  return __fadd_rn(__fdiv_rn(amax, 127.0f), 1e-12f);
}

__device__ __forceinline__ float amax4(float4 t) {
  return fmaxf(fmaxf(fabsf(t.x), fabsf(t.y)), fmaxf(fabsf(t.z), fabsf(t.w)));
}

// max over the T threads of a row: shuffles in each warp, then one float
// per warp through `red` (T > 32).  Every thread of the block calls it.
template <int T>
__device__ __forceinline__ float row_max(float m, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (T > 32) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
    const float* r = red + (threadIdx.x / T) * (T / 32);
    m = r[0];
#pragma unroll
    for (int w = 1; w < T / 32; ++w) m = fmaxf(m, r[w]);
  }
  return m;
}

// One row per T threads, 4V elements of it in each thread's registers:
// element 4s..4s+3 of slot s = i*T + t (vec), or element i*T + t.
template <int T, int V, bool kVec>
__global__ void __launch_bounds__(T < kThreads ? kThreads : T)
    quantize_rows_reg(const float* __restrict__ x,
                      signed char* __restrict__ q,
                      float* __restrict__ scale, long long rows, int cols) {
  constexpr int kRows = T < kThreads ? kThreads / T : 1;
  __shared__ float red[T > 32 ? kRows * T / 32 : 1];
  const int t = threadIdx.x % T;
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x / T;
  const bool live = row < rows;
  const long long base = (live ? row : 0) * (long long)cols;
  float v[4 * V];
  float m = 0.0f;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    const int n4 = cols >> 2;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int s = i * T + t;
      const float4 a = (live && s < n4) ? x4[s] : make_float4(0, 0, 0, 0);
      v[4 * i] = a.x;
      v[4 * i + 1] = a.y;
      v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * V; ++i) {
      const int c = i * T + t;
      v[i] = (live && c < cols) ? x[base + c] : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < 4 * V; ++i) m = fmaxf(m, fabsf(v[i]));
  const float s = scale_of(row_max<T>(m, red));
  if (!live) return;                     // after the block's one barrier
  if (t == 0) scale[row] = s;
  if (kVec) {
    char4* q4 = reinterpret_cast<char4*>(q + base);
    const int n4 = cols >> 2;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = i * T + t;
      if (j < n4)
        q4[j] = make_char4(code(v[4 * i], s), code(v[4 * i + 1], s),
                           code(v[4 * i + 2], s), code(v[4 * i + 3], s));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * V; ++i) {
      const int c = i * T + t;
      if (c < cols) q[base + c] = code(v[i], s);
    }
  }
}

// One block a row for rows wider than the register table: the first pass
// keeps the row in dynamic shared memory (kStaged, cols <= kMaxStaged) or
// the second pass reads x again.  Each thread reads back only what it
// wrote, so the staged row needs no barrier of its own.
template <bool kVec, bool kStaged>
__global__ void __launch_bounds__(kLoopThreads)
    quantize_rows_loop(const float* __restrict__ x,
                       signed char* __restrict__ q,
                       float* __restrict__ scale, int cols) {
  extern __shared__ float4 stage[];
  __shared__ float red[kLoopThreads / 32];
  const long long base = (long long)blockIdx.x * cols;
  float m = 0.0f;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    const int n4 = cols >> 2;
#pragma unroll 4
    for (int c = threadIdx.x; c < n4; c += kLoopThreads) {
      const float4 a = x4[c];
      if (kStaged) stage[c] = a;
      m = fmaxf(m, amax4(a));
    }
  } else {
    float* st = reinterpret_cast<float*>(stage);
#pragma unroll 4
    for (int c = threadIdx.x; c < cols; c += kLoopThreads) {
      const float a = x[base + c];
      if (kStaged) st[c] = a;
      m = fmaxf(m, fabsf(a));
    }
  }
  const float s = scale_of(row_max<kLoopThreads>(m, red));
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
  if (kVec) {
    const float4* src = kStaged ? stage
                                : reinterpret_cast<const float4*>(x + base);
    char4* q4 = reinterpret_cast<char4*>(q + base);
    for (int c = threadIdx.x; c < cols >> 2; c += kLoopThreads) {
      const float4 a = src[c];
      q4[c] = make_char4(code(a.x, s), code(a.y, s), code(a.z, s),
                         code(a.w, s));
    }
  } else {
    const float* src = kStaged ? reinterpret_cast<const float*>(stage)
                               : x + base;
    for (int c = threadIdx.x; c < cols; c += kLoopThreads)
      q[base + c] = code(src[c], s);
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

struct Args {
  const float* x;
  signed char* q;
  float* scale;
  long long rows;
  int cols;
  cudaStream_t stream;
};

template <int T, int V>
int launch_reg(const Args& a, bool vec) {
  constexpr int kRows = T < kThreads ? kThreads / T : 1;
  const long long blocks = (a.rows + kRows - 1) / kRows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int threads = T * kRows;
  if (vec)
    quantize_rows_reg<T, V, true><<<(unsigned)blocks, threads, 0, a.stream>>>(
        a.x, a.q, a.scale, a.rows, a.cols);
  else
    quantize_rows_reg<T, V, false><<<(unsigned)blocks, threads, 0, a.stream>>>(
        a.x, a.q, a.scale, a.rows, a.cols);
  return (int)cudaGetLastError();
}

template <bool kVec, bool kStaged>
int launch_loop_as(const Args& a) {
  const size_t smem = kStaged ? (size_t)a.cols * sizeof(float) : 0;
  if (kStaged) {  // above 48 KB only after this opt-in, on each launch's
                  // device (the wrapper makes x's device current)
    const cudaError_t e = cudaFuncSetAttribute(
        quantize_rows_loop<kVec, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxStaged * (int)sizeof(float));
    if (e != cudaSuccess) return (int)e;
  }
  quantize_rows_loop<kVec, kStaged>
      <<<(unsigned)a.rows, kLoopThreads, smem, a.stream>>>(a.x, a.q, a.scale,
                                                          a.cols);
  return (int)cudaGetLastError();
}

int launch_loop(const Args& a, bool vec, bool staged) {
  if (a.rows > 0x7fffffffLL || (staged && a.cols > kMaxStaged))
    return (int)cudaErrorInvalidConfiguration;
  if (vec)
    return staged ? launch_loop_as<true, true>(a)
                  : launch_loop_as<true, false>(a);
  return staged ? launch_loop_as<false, true>(a)
                : launch_loop_as<false, false>(a);
}

// The register kernel's instantiations, in the order of ops.py's
// REGISTER_GEOMETRY (which reads them back through
// quantize_rows_geometry and refuses a library that differs).
struct Geometry {
  int threads, vecs;
  int (*launch)(const Args&, bool);
};
const Geometry kGeometry[] = {{32, 4, launch_reg<32, 4>},
                              {128, 4, launch_reg<128, 4>},
                              {256, 8, launch_reg<256, 8>},
                              {512, 8, launch_reg<512, 8>}};
constexpr int kGeometries = sizeof(kGeometry) / sizeof(kGeometry[0]);

}  // namespace

// The compiled register geometries: writes up to n (threads, vecs) pairs
// and returns how many there are.
extern "C" int quantize_rows_geometry(int* threads, int* vecs, int n) {
  for (int i = 0; i < kGeometries && i < n; ++i) {
    threads[i] = kGeometry[i].threads;
    vecs[i] = kGeometry[i].vecs;
  }
  return kGeometries;
}

// x [rows, cols] float32 (contiguous) -> q [rows, cols] int8, scale [rows]
// float32.  vec != 0 promises cols % 4 == 0 and 16-byte aligned x, q
// rows 4-byte aligned.  (threads, vecs) is a row's geometry from
// ops.py's quantize_geometry: threads per row and float4 groups per
// thread of the register kernel (threads * 4 * vecs >= cols), or vecs 0
// for one 1024-thread block a row, the row staged in shared memory when
// staged != 0.  A geometry not compiled here is refused
// (cudaErrorInvalidValue).  Launches on `stream`, allocates nothing,
// returns cudaGetLastError() after the launch.
extern "C" int quantize_rows_f32(const void* x, void* q, void* scale,
                                 long long rows, int cols, int vec,
                                 int threads, int vecs, int staged,
                                 void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const Args a{static_cast<const float*>(x), static_cast<signed char*>(q),
               static_cast<float*>(scale), rows, cols,
               (cudaStream_t)stream};
  if (vecs == 0)
    return threads == kLoopThreads ? launch_loop(a, vec, staged)
                                   : (int)cudaErrorInvalidValue;
  if ((long long)threads * 4 * vecs < cols) return (int)cudaErrorInvalidValue;
  for (const Geometry& g : kGeometry)
    if (g.threads == threads && g.vecs == vecs) return g.launch(a, vec);
  return (int)cudaErrorInvalidValue;
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
