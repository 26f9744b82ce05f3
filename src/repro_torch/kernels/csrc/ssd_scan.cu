// Mamba-2 SSD chunk-local core for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:
// ssd_chunk_fwd (body _kernel).  Per (batch, chunk, head) cell, in
// float32:
//
//   cum      = cumsum(da)                                  [cs]
//   y[i]     = sum_{j <= i} exp(cum_i - cum_j) (c_i . b_j) x_j   [cs, p]
//   state    = X^T (B * exp(cum_last - cum))               [p, n]
//
// x [cells, cs, p] float32, b and c [cells, cs, n] (both float32 or
// both bfloat16), da [cells, cs] float32; b and c are cast to float32 on
// load, y and the states are written in float32, as the TPU kernel does
// for a float32 x.  The Mamba-2 prefill hands it x = x * dt, which is
// float32 since dt is, with b and c in bfloat16 at full width, all
// float32 in the smoke config.
//
// Above the diagonal cum_i - cum_j is positive and its exp may overflow
// to inf; the kernel selects 0 there and never multiplies a mask into
// it (inf * 0 would be NaN).  The cumulative sum is taken sequentially,
// in the order of the plain version's cumsum on the CPU.
//
// What bounds it on this card: bytes and operations nearly tie.  At the
// serve geometry (2 x 4 x 48 cells of cs 128, p 64, n 128) it moves ~63
// MB (0.0188 ms at 3.35 TB/s).  Counted over the lower triangle it does
// ~0.81 GFLOP of c . b, exact on bfloat16 tensor cores when b and c are
// bfloat16 (0.0008 ms at 989 TFLOP/s), and ~1.22 GFLOP of float32 work
// (0.0183 ms at 67 TFLOP/s outside the tensor cores): 0.0191 ms.
//
// What this first design does about it: one block of 512 threads per
// cell, everything of the cell in shared memory as float32 (dynamic, up
// to 227 KB): cum, B (rows padded by one float, so a warp reading 32
// rows at one column hits 32 banks) and X.  Query rows go in tiles of
// 32: the tile's C rows are staged, its scores (C B^T masked by the
// decay) are computed for the columns it can see (j < end of the tile),
// then y for the tile's rows.  Last, B is scaled by the state decay in
// place and the states are contracted over the cs rows.  Each thread
// keeps a few independent float32 accumulators; products run on CUDA
// cores with fmaf.  Tensor cores (the three products are small
// matmuls) and a layout that avoids the head-repeated B and C are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;                // query rows per tile
constexpr int kRowSets = kRows / kWarps;  // tile rows per thread
constexpr int kMaxCs = 256, kMaxP = 128, kMaxN = 256;
constexpr int kMaxU = kMaxP / 32;        // y columns per thread
constexpr int kMaxV = kMaxN / 32;        // state columns per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

size_t smem_bytes(int cs, int p, int n) {
  const size_t rows = cs < kRows ? cs : kRows;
  return sizeof(float) * ((size_t)cs + (size_t)cs * (n + 1) +
                          (size_t)cs * p + rows * (n + 1) + rows * cs);
}

template <typename TB>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_chunk_kernel(const float* __restrict__ x, const TB* __restrict__ b,
                     const TB* __restrict__ c, const float* __restrict__ da,
                     float* __restrict__ y, float* __restrict__ states,
                     int cs, int p, int n) {
  extern __shared__ float smem[];
  const int rows = cs < kRows ? cs : kRows;
  const int ldb = n + 1;
  float* cum = smem;                // [cs]
  float* bs = cum + cs;             // [cs][n + 1]
  float* xs = bs + cs * ldb;        // [cs][p]
  float* ct = xs + cs * p;          // [rows][n + 1]
  float* st = ct + rows * ldb;      // [rows][cs]

  const long long cell = blockIdx.x;
  const float* xc = x + cell * cs * p;
  const TB* bc = b + cell * cs * n;
  const TB* cc = c + cell * cs * n;
  float* yc = y + cell * cs * p;
  float* sc = states + cell * p * n;
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;          // warp-uniform

  for (int e = tid; e < cs * n; e += kThreads) {
    const int j = e / n;
    bs[j * ldb + (e - j * n)] = to_f32(bc[e]);
  }
  for (int e = tid; e < cs * p; e += kThreads) xs[e] = xc[e];
  for (int e = tid; e < cs; e += kThreads) cum[e] = da[cell * cs + e];
  __syncthreads();
  if (tid == 0) {
    float acc = 0.0f;
    for (int t = 0; t < cs; ++t) {
      acc += cum[t];
      cum[t] = acc;
    }
  }
  __syncthreads();

  const int nu = (p + 31) / 32;
  for (int i0 = 0; i0 < cs; i0 += kRows) {
    const int tr = cs - i0 < kRows ? cs - i0 : kRows;  // rows in the tile
    const int jl = i0 + tr;          // columns the tile's rows can see
    for (int e = tid; e < tr * n; e += kThreads) {
      const int r = e / n;
      const int k = e - r * n;
      ct[r * ldb + k] = to_f32(cc[(long long)(i0 + r) * n + k]);
    }
    __syncthreads();

    // scores of the tile: st[r][j] = j <= i ? exp(cum_i - cum_j) c_i.b_j : 0
    bool live[kRowSets];
    const float* crow[kRowSets];
#pragma unroll
    for (int s = 0; s < kRowSets; ++s) {
      const int r = ty + kWarps * s;
      live[s] = r < tr;
      crow[s] = ct + (live[s] ? r : 0) * ldb;  // a dead row reads row 0
    }
    if (live[0]) {
      for (int j = tx; j < jl; j += 32) {
        float acc[kRowSets];
#pragma unroll
        for (int s = 0; s < kRowSets; ++s) acc[s] = 0.0f;
        const float* bj = bs + j * ldb;
        for (int k = 0; k < n; ++k) {
          const float bv = bj[k];
#pragma unroll
          for (int s = 0; s < kRowSets; ++s)
            acc[s] = fmaf(crow[s][k], bv, acc[s]);
        }
#pragma unroll
        for (int s = 0; s < kRowSets; ++s) {
          if (!live[s]) continue;
          const int r = ty + kWarps * s;
          const int i = i0 + r;
          st[r * cs + j] = j <= i ? acc[s] * expf(cum[i] - cum[j]) : 0.0f;
        }
      }
    }
    __syncthreads();

    // y of the tile's rows: y[i][q] = sum_{j < jl} st[r][j] x[j][q]
    if (live[0]) {
      const float* srow[kRowSets];
#pragma unroll
      for (int s = 0; s < kRowSets; ++s)
        srow[s] = st + (live[s] ? ty + kWarps * s : 0) * cs;
      float acc[kRowSets][kMaxU];
      int col[kMaxU];
#pragma unroll
      for (int u = 0; u < kMaxU; ++u) {
        const int q = tx + 32 * u;
        col[u] = q < p ? q : 0;      // a dead column reads column 0
#pragma unroll
        for (int s = 0; s < kRowSets; ++s) acc[s][u] = 0.0f;
      }
      for (int j = 0; j < jl; ++j) {
        const float* xj = xs + j * p;
        float xv[kMaxU];
#pragma unroll
        for (int u = 0; u < kMaxU; ++u) xv[u] = u < nu ? xj[col[u]] : 0.0f;
#pragma unroll
        for (int s = 0; s < kRowSets; ++s) {
          const float sv = srow[s][j];
#pragma unroll
          for (int u = 0; u < kMaxU; ++u)
            if (u < nu) acc[s][u] = fmaf(sv, xv[u], acc[s][u]);
        }
      }
#pragma unroll
      for (int s = 0; s < kRowSets; ++s) {
        if (!live[s]) continue;
        float* yrow = yc + (long long)(i0 + ty + kWarps * s) * p;
#pragma unroll
        for (int u = 0; u < kMaxU; ++u) {
          const int q = tx + 32 * u;
          if (u < nu && q < p) yrow[q] = acc[s][u];
        }
      }
    }
    __syncthreads();                 // ct and st are rewritten next tile
  }

  // B * exp(cum_last - cum), in place
  const float last = cum[cs - 1];
  for (int e = tid; e < cs * n; e += kThreads) {
    const int j = e / n;
    bs[j * ldb + (e - j * n)] *= expf(last - cum[j]);
  }
  __syncthreads();

  // states[q][k] = sum_j x[j][q] bd[j][k]
  const int nv = (n + 31) / 32;
  int kcol[kMaxV];
#pragma unroll
  for (int v = 0; v < kMaxV; ++v) {
    const int k = tx + 32 * v;
    kcol[v] = k < n ? k : 0;
  }
  for (int q0 = 0; q0 < p; q0 += kWarps * kRowSets) {
    int qrow[kRowSets];
    bool qlive[kRowSets];
#pragma unroll
    for (int s = 0; s < kRowSets; ++s) {
      const int q = q0 + ty + kWarps * s;
      qlive[s] = q < p;
      qrow[s] = qlive[s] ? q : 0;
    }
    if (!qlive[0]) continue;
    float acc[kRowSets][kMaxV];
#pragma unroll
    for (int s = 0; s < kRowSets; ++s)
#pragma unroll
      for (int v = 0; v < kMaxV; ++v) acc[s][v] = 0.0f;
    for (int j = 0; j < cs; ++j) {
      const float* bj = bs + j * ldb;
      float bv[kMaxV];
#pragma unroll
      for (int v = 0; v < kMaxV; ++v) bv[v] = v < nv ? bj[kcol[v]] : 0.0f;
#pragma unroll
      for (int s = 0; s < kRowSets; ++s) {
        const float xv = xs[j * p + qrow[s]];
#pragma unroll
        for (int v = 0; v < kMaxV; ++v)
          if (v < nv) acc[s][v] = fmaf(xv, bv[v], acc[s][v]);
      }
    }
#pragma unroll
    for (int s = 0; s < kRowSets; ++s) {
      if (!qlive[s]) continue;
      float* srow = sc + (long long)qrow[s] * n;
#pragma unroll
      for (int v = 0; v < kMaxV; ++v) {
        const int k = tx + 32 * v;
        if (v < nv && k < n) srow[k] = acc[s][v];
      }
    }
  }
}

template <typename TB>
int launch(const void* x, const void* b, const void* c, const void* da,
           void* y, void* states, int cells, int cs, int p, int n,
           void* stream) {
  if (cells <= 0) return 0;
  if (cs < 1 || cs > kMaxCs || p < 1 || p > kMaxP || n < 1 || n > kMaxN)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(cs, p, n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_kernel<TB><<<cells, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const TB*>(b),
      static_cast<const TB*>(c), static_cast<const float*>(da),
      static_cast<float*>(y), static_cast<float*>(states), cs, p, n);
  return (int)cudaGetLastError();
}

}  // namespace

// x [cells, cs, p] and da [cells, cs] float32, b and c [cells, cs, n]
// in float32 (_bcf32) or bfloat16 (_bcbf16), all contiguous -> y [cells,
// cs, p] and states [cells, p, n] float32.  cs <= 256, p <= 128, n <=
// 256 and the shared memory of smem_bytes() within the card's limit.
// Launches on `stream`, allocates nothing, returns cudaGetLastError()
// after the launch (or the error that refused it).
#define SSD_ENTRY(SB, TB)                                                   \
  extern "C" int ssd_chunk_fwd_xf32_bc##SB(                                 \
      const void* x, const void* b, const void* c, const void* da, void* y, \
      void* states, int cells, int cs, int p, int n, void* stream) {        \
    return launch<TB>(x, b, c, da, y, states, cells, cs, p, n, stream);     \
  }

SSD_ENTRY(f32, float)
SSD_ENTRY(bf16, __nv_bfloat16)
