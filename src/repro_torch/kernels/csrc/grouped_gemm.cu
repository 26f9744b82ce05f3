// Grouped matrix products over expert groups for Hopper (sm_90a): the
// dropless expert layer's three products, groups given by offsets that
// live on the device.
//
// Replaces no TPU kernel: the JAX package's expert layer
// (src/repro/models/moe.py) computes every expert on a fixed capacity of
// slots with one-hot einsums, so XLA sees plain batched products.  The
// port's dropless layer (models/moe.py, experts_held) sorts the (token,
// choice) pairs it holds by expert into a static buffer of T*k rows, and
// the number of rows each expert took is known only on the device.  No
// PyTorch call computes products over variable-size groups whose offsets
// stay on the device, forward and backward, inside a CUDA graph capture.
//
// Three layouts, bf16 operands, float32 accumulation, bf16 results.  With
// offs [G + 1] int32 (offs[0] = 0, offs[G] <= M) and W [G, K, N]:
//
//   fwd    Y [M, N]    Y[r]  = X[r]  W[g]     for r in [offs[g], offs[g+1])
//   dgrad  dX [M, K]   dX[r] = dY[r] W[g]^T
//   wgrad  dW [G, K, N] dW[g] = sum over r of group g of X[r]^T dY[r]
//
// fwd and dgrad write zeros into the rows [offs[G], M) past the last group,
// so every row of their output is defined (the layer's non-held pairs read
// zeros); wgrad writes zeros for an empty group.
//
// What bounds it on this card: operations.  At the layer's shapes (K 2048,
// N 2816 or 1408, ~770 rows a group) a tile of 128 x 128 outputs reads
// 128 x 32 of each operand for 2 x 128 x 128 x 32 operations, ~64 a byte,
// and the weights are read once a row tile: the products sit above the
// bf16 ridge only with the reuse a tile gives, so the design is a tiled
// tensor-core product.
//
// Design: one block of 8 warps (2 x 4) computes a 128 x 128 tile, each
// warp 64 x 32 with mma.sync m16n8k16 (bf16 in, float32 accumulate).  K
// is walked in steps of 32 through a ring of 3 shared-memory stages filled
// by cp.async (16-byte chunks; rows and columns past an edge are
// zero-filled).  Each operand is staged in the layout it has in device
// memory and read into fragments with ldmatrix, transposed where the
// operand's contiguous axis is not the one the fragment wants: X and dY
// rows are the A operand as they are; W is B read transposed in fwd and
// as it is in dgrad; in wgrad X is A read transposed and dY is B read
// transposed.  A tile's group is found from the offsets by the block
// itself: block row t walks the groups' tile counts (ceil(rows / 128)),
// so tiles never straddle two groups and a grid of ceil(M / 128) + G + 1
// rows covers every group's tiles and the zero rows; blocks past the last
// tile exit at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kPad = 8;                 // bf16 of padding a staged row

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Staged tile sizes in bf16: A is [BM][BK+pad] as it is, [BK][BM+pad]
// transposed; B is [BK][BN+pad] read transposed, [BN][BK+pad] as it is.
template <bool AT>
struct ATile {
  static constexpr int rows = AT ? kBK : kBM;
  static constexpr int ld = AT ? kBM + kPad : kBK + kPad;
  static constexpr int elems = rows * ld;
};
template <bool BT>
struct BTile {
  static constexpr int rows = BT ? kBN : kBK;
  static constexpr int ld = BT ? kBK + kPad : kBN + kPad;
  static constexpr int elems = rows * ld;
};

// One operand tile into shared memory.  `rows` x `cols` bf16 of a matrix
// whose rows are `ld` apart, starting at `src`; rows at or past
// `rows_valid` and columns at or past `cols_valid` read as zeros.
// cols is a multiple of 8 and cols_valid too (16-byte chunks).
template <int ROWS, int COLS, int LDS>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, long long ld,
                                      int rows_valid, int cols_valid) {
  constexpr int chunks_per_row = COLS / 8;
  constexpr int chunks = ROWS * chunks_per_row;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int r = c / chunks_per_row;
    const int col = (c % chunks_per_row) * 8;
    const bool ok = r < rows_valid && col < cols_valid;
    const __nv_bfloat16* g = ok ? src + (long long)r * ld + col : src;
    cp_async16(smem_u32(dst + r * LDS + col), g, ok);
  }
}

// The tile C[128, 128] = A[128, R] B[R, 128] of one block.  A(m, r) is
// a[m * lda + r] (AT false) or a[r * lda + m] (AT true); B(r, n) is
// b[r * ldb + n] (BT false) or b[n * ldb + r] (BT true).  m_valid /
// n_valid bound the tile's rows and columns, R the reduction.
template <bool AT, bool BT>
__device__ __forceinline__ void tile_product(
    const __nv_bfloat16* a, long long lda, const __nv_bfloat16* b,
    long long ldb, int m_valid, int n_valid, int R, float (&acc)[4][4][4],
    __nv_bfloat16* smem) {
  using TA = ATile<AT>;
  using TB = BTile<BT>;
  __nv_bfloat16* as = smem;
  __nv_bfloat16* bs = smem + kStages * TA::elems;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;              // 0..1: 64 rows each
  const int wn = warp & 3;               // 0..3: 32 columns each

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (R + kBK - 1) / kBK;
  auto load = [&](int s, int kt) {
    const int r0 = kt * kBK;
    const int r_valid = R - r0;
    if (AT)
      stage<kBK, kBM, TA::ld>(as + s * TA::elems, a + (long long)r0 * lda,
                              lda, r_valid, m_valid);
    else
      stage<kBM, kBK, TA::ld>(as + s * TA::elems, a + r0, lda, m_valid,
                              r_valid);
    if (BT)
      stage<kBN, kBK, TB::ld>(bs + s * TB::elems, b + r0, ldb, n_valid,
                              r_valid);
    else
      stage<kBK, kBN, TB::ld>(bs + s * TB::elems, b + (long long)r0 * ldb,
                              ldb, r_valid, n_valid);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < nk) load(next % kStages, next);
    cp_async_commit();
    const __nv_bfloat16* at = as + (kt % kStages) * TA::elems;
    const __nv_bfloat16* bt = bs + (kt % kStages) * TB::elems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m0 = wm * 64 + i * 16;
        if (AT) {
          const int r = kk + (lane & 7) + ((lane >> 4) << 3);
          const int m = m0 + ((lane >> 3) & 1) * 8;
          ldsm_x4_t(af[i], smem_u32(at + r * TA::ld + m));
        } else {
          const int m = m0 + (lane & 15);
          const int r = kk + (lane >> 4) * 8;
          ldsm_x4(af[i], smem_u32(at + m * TA::ld + r));
        }
      }
      uint32_t bf[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n0 = wn * 32 + j * 16;
        if (BT) {
          const int n = n0 + (lane & 7) + ((lane >> 4) << 3);
          const int r = kk + ((lane >> 3) & 1) * 8;
          ldsm_x4(bf[j], smem_u32(bt + n * TB::ld + r));
        } else {
          const int r = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int n = n0 + (lane >> 4) * 8;
          ldsm_x4_t(bf[j], smem_u32(bt + r * TB::ld + n));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2],
                   bf[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
}

// acc -> c[m * ldc + n] in bf16 for m < m_valid, n < n_valid (n_valid
// even: a thread's pair of columns is in or out together).
__device__ __forceinline__ void store_tile(__nv_bfloat16* c, long long ldc,
                                           int m_valid, int n_valid,
                                           const float (&acc)[4][4][4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = wn * 32 + j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm * 64 + i * 16 + (lane >> 2) + h * 8;
        if (m < m_valid && n < n_valid)
          *reinterpret_cast<__nv_bfloat162*>(c + (long long)m * ldc + n) =
              __floats2bfloat162_rn(acc[i][j][h * 2], acc[i][j][h * 2 + 1]);
      }
    }
}

// zeros over rows [0, m_valid) x columns [0, n_valid) of a tile
__device__ __forceinline__ void zero_tile(__nv_bfloat16* c, long long ldc,
                                          int m_valid, int n_valid) {
  const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
  const int pairs = kBN / 2;
  for (int e = threadIdx.x; e < kBM * pairs; e += kThreads) {
    const int m = e / pairs, n = (e % pairs) * 2;
    if (m < m_valid && n < n_valid)
      *reinterpret_cast<__nv_bfloat162*>(c + (long long)m * ldc + n) = z;
  }
}

// fwd (BT false) and dgrad (BT true): rows of A [M, R] against W[g].
// Output width `ncols` (N in fwd, K in dgrad); W[g] is [K, N].
template <bool BT>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_rows_kernel(const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ c, const int* __restrict__ offs,
                int G, long long M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int R = BT ? N : K;              // reduction
  const int ncols = BT ? K : N;          // output width
  const int n0 = blockIdx.x * kBN;
  int t = blockIdx.y;
  int g = 0;
  long long start = 0, end = 0;
  for (; g < G; ++g) {
    start = offs[g];
    end = offs[g + 1];
    const long long tiles = (end - start + kBM - 1) / kBM;
    if (t < tiles) break;
    t -= (int)tiles;
  }
  const int n_valid = min(kBN, ncols - n0);
  if (g == G) {                          // the rows past the last group
    const long long row0 = (long long)offs[G] + (long long)t * kBM;
    if (row0 >= M) return;
    zero_tile(c + row0 * ncols + n0, ncols, (int)min((long long)kBM, M - row0),
              n_valid);
    return;
  }
  const long long row0 = start + (long long)t * kBM;
  const int m_valid = (int)min((long long)kBM, end - row0);
  const __nv_bfloat16* wg = w + (long long)g * K * N;
  float acc[4][4][4];
  if (BT)   // B(r, n) = W[g][n, r]: rows of W are N apart
    tile_product<false, true>(a + row0 * R, R, wg + (long long)n0 * N, N,
                              m_valid, n_valid, R, acc, smem);
  else      // B(r, n) = W[g][r, n]
    tile_product<false, false>(a + row0 * R, R, wg + n0, N, m_valid, n_valid,
                               R, acc, smem);
  store_tile(c + row0 * ncols + n0, ncols, m_valid, n_valid, acc);
}

// wgrad: dW[g] [K, N] = X[rows of g]^T dY[rows of g]
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_wgrad_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ dy,
                 __nv_bfloat16* __restrict__ dw, const int* __restrict__ offs,
                 int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int n_tiles = (N + kBN - 1) / kBN;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int g = blockIdx.y;
  const long long start = offs[g];
  const int rows = (int)(offs[g + 1] - start);
  const int m_valid = min(kBM, K - m0);
  const int n_valid = min(kBN, N - n0);
  float acc[4][4][4];
  // A(m, r) = X[start + r, m0 + m]; B(r, n) = dY[start + r, n0 + n]
  tile_product<true, false>(x + start * K + m0, K, dy + start * N + n0, N,
                            m_valid, n_valid, rows, acc, smem);
  store_tile(dw + (long long)g * K * N + (long long)m0 * N + n0, N, m_valid,
             n_valid, acc);
}

template <bool AT, bool BT>
constexpr int smem_bytes() {
  return kStages * (ATile<AT>::elems + BTile<BT>::elems) * 2;
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// The row tiles a fwd or dgrad grid holds for M rows in G groups.
extern "C" int grouped_gemm_row_tiles(long long M, int G) {
  return (int)((M + kBM - 1) / kBM) + G + 1;
}

// layout 0 fwd (a = X [M, K], b = W [G, K, N], c = Y [M, N]); 1 dgrad
// (a = dY [M, N], b = W, c = dX [M, K]); 2 wgrad (a = X [M, K], b = dY
// [M, N], c = dW [G, K, N]).  offs: G + 1 int32 on the device.  K and N
// are multiples of 8 and every pointer is 16-byte aligned.  Returns the
// CUDA error of the launch (0 when none).
extern "C" int grouped_gemm_bf16(int layout, const void* a, const void* b,
                                 void* c, const void* offs, int G,
                                 long long M, int K, int N, void* stream) {
  // the kernels' dynamic shared memory (over 48 KB) allowed once
  static int ready = -1;
  if (ready < 0) {
    ready = allow_smem(grouped_gemm_rows_kernel<false>,
                       smem_bytes<false, false>());
    if (!ready)
      ready = allow_smem(grouped_gemm_rows_kernel<true>,
                         smem_bytes<false, true>());
    if (!ready)
      ready = allow_smem(grouped_gemm_wgrad_kernel, smem_bytes<true, false>());
  }
  if (ready) return ready;
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* pa = static_cast<const __nv_bfloat16*>(a);
  const __nv_bfloat16* pb = static_cast<const __nv_bfloat16*>(b);
  __nv_bfloat16* pc = static_cast<__nv_bfloat16*>(c);
  const int* po = static_cast<const int*>(offs);
  if (layout == 0 || layout == 1) {
    if (M <= 0) return 0;
    const int ncols = layout == 0 ? N : K;
    dim3 grid((ncols + kBN - 1) / kBN, grouped_gemm_row_tiles(M, G));
    if (layout == 0)
      grouped_gemm_rows_kernel<false>
          <<<grid, kThreads, smem_bytes<false, false>(), s>>>(pa, pb, pc, po,
                                                              G, M, K, N);
    else
      grouped_gemm_rows_kernel<true>
          <<<grid, kThreads, smem_bytes<false, true>(), s>>>(pa, pb, pc, po,
                                                             G, M, K, N);
  } else if (layout == 2) {
    if (G <= 0) return 0;
    dim3 grid(((N + kBN - 1) / kBN) * ((K + kBM - 1) / kBM), G);
    grouped_gemm_wgrad_kernel<<<grid, kThreads, smem_bytes<true, false>(),
                                s>>>(pa, pb, pc, po, K, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
