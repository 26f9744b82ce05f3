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
// Operands are read by stride, so the model's own layout goes in as it
// is: x [B, Lp, H, p] float32 (Lp = NC * cs, the length the model has
// padded), b and c [B, Lp, G, n] (both float32 or both bfloat16), da
// [B, Lp, H] float32; y is written into [B, Lp, H, p] and the states
// into [B, NC, H, p, n] float32.  Head h reads group h / (H / G).  The
// TPU kernel's layout [B, NC, H, cs, .] is the same kernel with G = H
// and other strides.  Every stride is (batch, chunk, row, head or group)
// in elements; the last dimension is contiguous.
//
// Above the diagonal cum_i - cum_j may be positive and its exp overflow
// to inf; the kernel selects 0 there and never multiplies a mask into
// it (inf * 0 would be NaN).  The cumulative sum is a warp scan: each
// lane sums a run of rows in order, the lanes' totals are scanned across
// the warp.  It sums in another order than torch.cumsum, which the
// tolerance of chip_smoke.py's SSD_TOL covers.
//
// What bounds it on this card (the Mamba-2 serve group: B 2, Lp 512, H
// 48, G 1, p 64, n 128, x float32, b and c bfloat16): each input read
// once and each output written once is 38.5 MB (x 12.58, b + c 0.52, da
// 0.20, y 12.58, states 12.58), 0.0115 ms at 3.35 TB/s.  C B^T once per
// group is 16.9 MFLOP of bfloat16, and the masked product, the y product
// over the lower triangle, the decay and the state product 1.224 GFLOP
// of float32, 0.0183 ms at the 67 TFLOP/s of float32 outside the tensor
// cores.  Bound: 0.0183 ms, by operations.
//
// The design (one block per cell; 16 query rows per warp, cs / 16 warps):
//   * All three products on the tensor cores.  C B^T with bfloat16 b and
//     c is mma.sync m16n8k16 bf16, exact products with a float32
//     accumulate.  The float32 products run as 3xTF32: m16n8k8 tf32
//     with a = a_hi + a_lo (cvt.rna.tf32.f32 of a, then of a - a_hi) and
//     a_lo b_hi + a_hi b_lo + a_hi b_hi, about 2^-21 relative per product
//     (one TF32 pass, 2^-11, would break the tolerance).  A bfloat16 b is
//     exact in tf32, so the state product takes two passes there, not
//     three: the decay is folded into X, not into B.  With float32 b and
//     c, C B^T is 3xTF32 as well.
//   * The scores never touch shared memory.  A warp's C B^T
//     accumulators for 16 keys get the decay mask in registers and are
//     the A fragments of the y product at once: the k index of that
//     product is permuted (logical t, t + 4 -> keys 2t, 2t + 1), so the
//     accumulator layout (columns 2t, 2t + 1) is the tf32 A layout, and
//     X's rows are read in the same order.
//   * B, C and X arrive through cp.async in one group while warp 0 scans
//     da (every load of a lane issued before its sum).  Overlapping the
//     loads of later rows with the work on earlier ones, in groups of 32
//     rows, measured the same: the other block on the SM overlaps them.
//     Shared memory rows are padded (X by 4 floats, B and C by 16 bytes)
//     so that every fragment load is free of bank conflicts; columns and
//     rows past p, n and cs are zero.  At the serve geometry a block of
//     8 warps takes 105,472 B: two blocks an SM.
//   * The 48 heads of a (batch, chunk) are consecutive blocks, so B and
//     C come from L2 after the first.
//   * The state product runs after the y rows, in jobs of 32 rows of p
//     by 32 columns of n (one a warp at the serve geometry).  Warp w's
//     y rows see w + 1 key steps of 16, so the warps' loads differ; the
//     SM's other block fills the gaps.  Two ways of balancing them were
//     slower (PERF.md, PR 15): smaller jobs handed to the least-loaded
//     warp, by 6% (each job splits X's fragments again), and pairing row
//     tiles w and T - 1 - w on half the warps with the jobs on the other
//     half, by 3-4% at 48 to 1536 blocks (faster only at 384).
//   * C B^T keeps even and odd k steps in separate accumulators, two
//     dependent mma chains of half the length.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "warp_mma.cuh"

namespace {

constexpr int kMaxCs = 256, kMaxP = 128, kMaxN = 256;

struct Strides {  // elements: batch, chunk, row, head (group for b and c)
  long long x[4], b[4], c[4], da[4], y[4];
};

// what the launch derives from the shapes (host and device agree)
struct Geo {
  int batch, nc, h, g, cs, p, n;
  int rp;   // rows, cs rounded up to 16 (one m16 tile a warp)
  int pw;   // X columns staged, p rounded up to 32
  int nw;   // B and C columns staged, n rounded up to 32
  int ldx;  // X row: pw + 4 floats
  int ldb;  // B and C row: nw + 16 bytes
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

template <typename TB>
Geo make_geo(int batch, int nc, int h, int g, int cs, int p, int n) {
  Geo o{batch, nc, h, g, cs, p, n, round_up(cs, 16), round_up(p, 32),
        round_up(n, 32), 0, 0};
  o.ldx = o.pw + 4;
  o.ldb = o.nw + 16 / (int)sizeof(TB);
  return o;
}

template <typename TB>
size_t smem_bytes(const Geo& o) {
  return sizeof(float) * (2 * (size_t)o.rp + (size_t)o.rp * o.ldx) +
         2 * sizeof(TB) * (size_t)o.rp * o.ldb;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// `rows` rows of an operand into shared rows of `ld` elements, in 16-byte
// chunks: chunks past `valid_chunks` and rows past `valid_rows` are 0
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           long long row_stride, int rows,
                                           int valid_rows, int chunks,
                                           int valid_chunks) {
  constexpr int E = 16 / sizeof(T);
  // thread i copies piece i, i + blockDim.x, ...: (row, chunk) advance by
  // (blockDim.x / chunks, blockDim.x % chunks) with one carry
  const int step_r = blockDim.x / chunks, step_c = blockDim.x % chunks;
  int r = threadIdx.x / chunks, ch = threadIdx.x % chunks;
  while (r < rows) {
    const bool ok = r < valid_rows && ch < valid_chunks;
    const T* s = ok ? src + r * row_stride + ch * E : src;
    cp_async16(smem_u32(dst + r * ld + ch * E), s, ok);
    r += step_r;
    ch += step_c;
    if (ch >= chunks) {
      ch -= chunks;
      ++r;
    }
  }
}

// PT: n8 tiles of p a warp's y accumulators hold (p <= 8 PT)
template <typename TB, int PT>
__global__ void __launch_bounds__(32 * kMaxCs / 16, 1)
    ssd_chunk_kernel(const float* __restrict__ x, const TB* __restrict__ b,
                     const TB* __restrict__ c, const float* __restrict__ da,
                     float* __restrict__ y, float* __restrict__ states,
                     Geo G, Strides S) {
  constexpr bool kBf16 = sizeof(TB) == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);   // [rp]
  float* dec = cum + G.rp;                           // [rp]
  float* xs = dec + G.rp;                            // [rp][ldx]
  TB* bs = reinterpret_cast<TB*>(xs + G.rp * G.ldx);  // [rp][ldb]
  TB* csm = bs + G.rp * G.ldb;                         // [rp][ldb]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;                // rp / 16
  const int g8 = lane >> 2, t4 = lane & 3;

  // cell = ((batch * NC) + chunk) * H + head: the heads of one chunk
  // are neighbours and share B and C in L2
  const int hh = blockIdx.x % G.h;
  const int zb = blockIdx.x / G.h;
  const int zz = zb % G.nc, bb = zb / G.nc;
  const int gg = hh / (G.h / G.g);
  const float* xc = x + bb * S.x[0] + zz * S.x[1] + hh * S.x[3];
  const TB* bc = b + bb * S.b[0] + zz * S.b[1] + gg * S.b[3];
  const TB* cc = c + bb * S.c[0] + zz * S.c[1] + gg * S.c[3];
  const float* dac = da + bb * S.da[0] + zz * S.da[1] + hh * S.da[3];
  float* yc = y + bb * S.y[0] + zz * S.y[1] + hh * S.y[3];
  float* sc = states + (long long)blockIdx.x * G.p * G.n;

  // every row of B, C and X in one cp.async group
  constexpr int EB = 16 / sizeof(TB);
  stage_rows(csm, G.ldb, cc, S.c[2], G.rp, G.cs, G.nw / EB, G.n / EB);
  stage_rows(bs, G.ldb, bc, S.b[2], G.rp, G.cs, G.nw / EB, G.n / EB);
  stage_rows(xs, G.ldx, xc, S.x[2], G.rp, G.cs, G.pw / 4, G.p / 4);
  cp_async_commit();

  // while the rows load: cum as a warp scan (all of a lane's da loads
  // issued before its sum), dec = exp(cum_last - cum), 0 on padded rows
  if (warp == 0) {
    const int per = (G.cs + 31) / 32;                // <= 8 rows a lane
    const int j0 = lane * per;
    float v[kMaxCs / 32];
#pragma unroll
    for (int e = 0; e < kMaxCs / 32; ++e) {
      const int j = j0 + e;
      v[e] = e < per && j < G.cs ? dac[j * S.da[2]] : 0.f;
    }
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxCs / 32; ++e) {
      run += v[e];
      v[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxCs / 32; ++e) {
      const int j = j0 + e;
      if (e < per && j < G.rp) cum[j] = excl + v[e];
    }
    __syncwarp();
    const float last = cum[G.cs - 1];
    for (int j = lane; j < G.rp; j += 32)
      dec[j] = j < G.cs ? expf(last - cum[j]) : 0.f;
  }

  cp_async_wait<0>();
  __syncthreads();                   // rows, cum and dec landed

  // this warp's query rows ia, ib of the m16 tile at row i0
  const int i0 = 16 * warp;
  const int ia = i0 + g8, ib = ia + 8;
  const float cum_a = cum[ia], cum_b = cum[ib];
  const int pt = (G.p + 7) / 8;                      // y n8 tiles in use
  float yacc[PT][4];
#pragma unroll
  for (int q = 0; q < PT; ++q)
    yacc[q][0] = yacc[q][1] = yacc[q][2] = yacc[q][3] = 0.f;

  // y for keys [j0, j0 + 16) <= the tile's rows: S = C B^T on the tensor
  // cores (even and odd k steps in separate accumulators), the decay mask
  // in registers, then S X with S as the A fragments
  for (int j0 = 0; j0 <= i0; j0 += 16) {
    float sv[2][4], sw[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sv[nt][e] = sw[nt][e] = 0.f;
    // one k step of C B^T into d (k16 bf16, or k8 in 3xTF32)
    auto cb_step = [&](int kk, float (&d)[2][4]) {
      if constexpr (kBf16) {
        uint32_t a[4], kb[4];
        ldsm_x4(a, smem_u32(csm + (i0 + (lane & 15)) * G.ldb + kk * 16 +
                            (lane >> 4) * 8));
        ldsm_x4(kb, smem_u32(bs + (j0 + (lane & 7) + (lane >> 4) * 8) * G.ldb +
                             kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(d[0], a, kb[0], kb[1]);
        mma_bf16(d[1], a, kb[2], kb[3]);
      } else {
        const TB* ca = csm + ia * G.ldb + kk * 8 + t4;
        uint32_t ah[4], al[4];
        split_tf32(to_f32(ca[0]), ah[0], al[0]);
        split_tf32(to_f32(ca[8 * G.ldb]), ah[1], al[1]);
        split_tf32(to_f32(ca[4]), ah[2], al[2]);
        split_tf32(to_f32(ca[8 * G.ldb + 4]), ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const TB* bp = bs + (j0 + 8 * nt + g8) * G.ldb + kk * 8 + t4;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(to_f32(bp[0]), bh0, bl0);
          split_tf32(to_f32(bp[4]), bh1, bl1);
          mma3(d[nt], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    };
    const int ksteps = kBf16 ? (G.n + 15) / 16 : (G.n + 7) / 8;
    for (int kk = 0; kk < ksteps; kk += 2) {
      cb_step(kk, sv);
      if (kk + 1 < ksteps) cb_step(kk + 1, sw);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      // keys j and j + 1 of this n8 tile; select, never multiply
      const int j = j0 + 8 * nt + 2 * t4;
      const float c0 = cum[j], c1 = cum[j + 1];
      const float s00 =
          j <= ia ? (sv[nt][0] + sw[nt][0]) * __expf(cum_a - c0) : 0.f;
      const float s01 =
          j + 1 <= ia ? (sv[nt][1] + sw[nt][1]) * __expf(cum_a - c1) : 0.f;
      const float s10 =
          j <= ib ? (sv[nt][2] + sw[nt][2]) * __expf(cum_b - c0) : 0.f;
      const float s11 =
          j + 1 <= ib ? (sv[nt][3] + sw[nt][3]) * __expf(cum_b - c1) : 0.f;
      // tf32 A: (row g, k t) (row g+8, k t) (row g, k t+4) (row g+8, k
      // t+4), with k t -> key j and k t+4 -> key j + 1
      uint32_t ah[4], al[4];
      split_tf32(s00, ah[0], al[0]);
      split_tf32(s10, ah[1], al[1]);
      split_tf32(s01, ah[2], al[2]);
      split_tf32(s11, ah[3], al[3]);
      const float* xr = xs + j * G.ldx + g8;
#pragma unroll
      for (int q = 0; q < PT; ++q) {
        if (q < pt) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(xr[8 * q], bh0, bl0);
          split_tf32(xr[G.ldx + 8 * q], bh1, bl1);
          mma3(yacc[q], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
  }

  // y rows ia, ib: columns 8q + 2t, 8q + 2t + 1 (p is a multiple of 4)
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = hf ? ib : ia;
    if (i >= G.cs) continue;
    float* yr = yc + i * S.y[2] + 2 * t4;
#pragma unroll
    for (int q = 0; q < PT; ++q)
      if (8 * q + 2 * t4 < G.p)
        *reinterpret_cast<float2*>(yr + 8 * q) =
            make_float2(yacc[q][2 * hf], yacc[q][2 * hf + 1]);
  }

  // state jobs: states[q0 + 32, k0 + 32) = (X * dec)^T B over every
  // key, 2 m16 tiles of p by 4 n8 tiles of n, jobs warp, warp + nwarps,
  // ...; the k index is permuted as in the y product (k t, t + 4 -> keys
  // 2t, 2t + 1)
  const int jobs_k = (G.n + 31) / 32;
  const int jobs = (G.p + 31) / 32 * jobs_k;
  for (int job = warp; job < jobs; job += nwarps) {
    const int q0 = 32 * (job / jobs_k), k0 = 32 * (job % jobs_k);
    float acc[2][4][4];
#pragma unroll
    for (int mq = 0; mq < 2; ++mq)
#pragma unroll
      for (int nk = 0; nk < 4; ++nk)
        acc[mq][nk][0] = acc[mq][nk][1] = acc[mq][nk][2] = acc[mq][nk][3] = 0.f;
    for (int j0 = 0; j0 < G.rp; j0 += 8) {
      const int ja = j0 + 2 * t4;
      const float d0 = dec[ja], d1 = dec[ja + 1];
      const float* x0 = xs + ja * G.ldx + q0 + g8;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mq = 0; mq < 2; ++mq) {
        split_tf32(x0[16 * mq] * d0, ah[mq][0], al[mq][0]);
        split_tf32(x0[16 * mq + 8] * d0, ah[mq][1], al[mq][1]);
        split_tf32(x0[G.ldx + 16 * mq] * d1, ah[mq][2], al[mq][2]);
        split_tf32(x0[G.ldx + 16 * mq + 8] * d1, ah[mq][3], al[mq][3]);
      }
      const TB* b0p = bs + ja * G.ldb + k0 + g8;
#pragma unroll
      for (int nk = 0; nk < 4; ++nk) {
        const float bv0 = to_f32(b0p[8 * nk]);
        const float bv1 = to_f32(b0p[G.ldb + 8 * nk]);
#pragma unroll
        for (int mq = 0; mq < 2; ++mq) {
          if constexpr (kBf16) {     // b is exact in tf32: two passes
            const uint32_t e0 = __float_as_uint(bv0);
            const uint32_t e1 = __float_as_uint(bv1);
            mma_tf32(acc[mq][nk], al[mq], e0, e1);
            mma_tf32(acc[mq][nk], ah[mq], e0, e1);
          } else {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(bv0, bh0, bl0);
            split_tf32(bv1, bh1, bl1);
            mma3(acc[mq][nk], ah[mq], al[mq], bh0, bh1, bl0, bl1);
          }
        }
      }
    }
#pragma unroll
    for (int mq = 0; mq < 2; ++mq) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int q = q0 + 16 * mq + g8 + 8 * hf;
        if (q >= G.p) continue;
#pragma unroll
        for (int nk = 0; nk < 4; ++nk) {
          const int k = k0 + 8 * nk + 2 * t4;   // n is even: k + 1 < n too
          if (k < G.n)
            *reinterpret_cast<float2*>(sc + q * G.n + k) =
                make_float2(acc[mq][nk][2 * hf], acc[mq][nk][2 * hf + 1]);
        }
      }
    }
  }
}

template <typename TB, int PT>
int launch_pt(const void* x, const void* b, const void* c, const void* da,
              void* y, void* states, const Geo& G, const Strides& S,
              cudaStream_t stream) {
  const size_t smem = smem_bytes<TB>(G);
  const cudaError_t attr = cudaFuncSetAttribute(
      ssd_chunk_kernel<TB, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const long long cells = (long long)G.batch * G.nc * G.h;
  ssd_chunk_kernel<TB, PT><<<(unsigned)cells, 32 * (G.rp / 16), smem,
                             stream>>>(
      static_cast<const float*>(x), static_cast<const TB*>(b),
      static_cast<const TB*>(c), static_cast<const float*>(da),
      static_cast<float*>(y), static_cast<float*>(states), G, S);
  return (int)cudaGetLastError();
}

template <typename TB>
int launch(const void* x, const void* b, const void* c, const void* da,
           void* y, void* states, int batch, int nc, int h, int g, int cs,
           int p, int n, const long long* strides, void* stream) {
  if (batch < 0 || nc < 0 || h < 1 || g < 1 || h % g != 0 || cs < 1 ||
      cs > kMaxCs || p < 4 || p > kMaxP || p % 4 != 0 || n < 1 ||
      n > kMaxN || n % (16 / (int)sizeof(TB)) != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)batch * nc == 0) return 0;
  Strides S;
  memcpy(&S, strides, sizeof(S));
  const Geo G = make_geo<TB>(batch, nc, h, g, cs, p, n);
  const cudaStream_t s = (cudaStream_t)stream;
  if (p <= 64) return launch_pt<TB, 8>(x, b, c, da, y, states, G, S, s);
  return launch_pt<TB, 16>(x, b, c, da, y, states, G, S, s);
}

}  // namespace

// x float32, b and c float32 (_bcf32) or bfloat16 (_bcbf16), da float32,
// y float32 and states [batch, nc, h, p, n] float32 contiguous.
// `strides` points to 20 int64 on the host: for x, b, c, da and y in
// turn, the (batch, chunk, row, head or group) strides in elements; the
// last dimension of x, b, c and y is contiguous, rows and bases 16-byte
// aligned.  cs <= 256, p <= 128 and a multiple of 4, n <= 256 and a
// multiple of 8 (bfloat16) or 4 (float32), h a multiple of g.  Launches
// on `stream`, allocates nothing, returns cudaGetLastError() after the
// launch (or the error that refused it).
#define SSD_ENTRY(SB, TB)                                                   \
  extern "C" int ssd_chunk_fwd_xf32_bc##SB(                                 \
      const void* x, const void* b, const void* c, const void* da, void* y, \
      void* states, int batch, int nc, int h, int g, int cs, int p, int n,  \
      const long long* strides, void* stream) {                             \
    return launch<TB>(x, b, c, da, y, states, batch, nc, h, g, cs, p, n,    \
                      strides, stream);                                     \
  }

SSD_ENTRY(f32, float)
SSD_ENTRY(bf16, __nv_bfloat16)
