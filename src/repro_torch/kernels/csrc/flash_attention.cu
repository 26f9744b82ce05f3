// Blockwise GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_fwd (body _kernel).  q [b, sq, n_q, hd] attends
// k/v [b, sk, n_kv, hd], query head h reading KV head h / (n_q / n_kv),
// queries and keys both starting at position 0.  Mask: k_pos < sk, plus
// k_pos <= q_pos when causal, plus k_pos > q_pos - window when a local
// window is set (as in the plain gqa_attention and the paged kernel; the
// TPU kernel has no window).  Masked scores are -1e30, the running max
// starts at -1e30, the online softmax runs in float32, and the output is
// acc / max(l, 1e-30), as in the TPU kernel.  It computes the serving
// prefill's attention.
//
// What bounds it on this card: bytes, for bfloat16 prefill at serving
// shapes.  At b 2, s 256, 32/8 heads, head_dim 64 the call moves 5.24 MB
// (q and the output 2.10 MB each, K and V 0.52 MB each): 1.57 us at
// 3.35 TB/s, against 0.54 GFLOP of QK^T and PV over the causal triangle,
// 0.55 us at the 989 TFLOP/s bf16 tensor-core peak.  At these sizes the
// time is set by latency and occupancy (a few hundred blocks, each
// walking at most a few 64-key tiles), not by either peak.
//
// bfloat16: a tensor-core design.
//   * Products on the tensor cores: mma.sync.m16n8k16 bf16 -> f32.
//     S = Q K^T is exact per product on bf16 inputs.  Head widths below
//     16 (hd 8) pad the contraction with zero columns in shared memory,
//     so one design serves every width the wrapper takes (8 .. 128).
//   * GQA packing in the M dimension: one block of 4 warps takes one
//     (batch, KV head) and 64 or 128 consecutive rows of the flattened
//     (position, query head of the group) space, position-major: for
//     g = 4, 16 or 32 positions x 4 heads.  Any g works, and a block may
//     start or end inside a position.  Each K/V tile enters shared memory
//     once for the g heads, and all warps share one causal frontier.
//     A warp holds 16 rows (MT 1) or, on grids of more than two 64-row
//     blocks an SM, 32 rows (MT 2), where every K and V fragment it loads
//     serves two m16 tiles and K/V tiles are read half as often.
//   * K/V tiles of 64 keys travel in bf16 through cp.async (16 B a
//     thread) into a ring of 2 stages, so the next tile loads while one
//     is computed; Q rides in the first group.  Rows are padded by 16 B
//     in shared memory, which makes every ldmatrix (and ldmatrix.trans
//     for V) free of bank conflicts at every width.  The query tiles that
//     see the most keys start first.
//   * The online softmax runs on the mma fragments: each row's max and
//     sum reduce across its 4-thread quad with __shfl_xor_sync, scores in
//     the log2 domain (scale * log2 e folded in, one ex2.approx each),
//     which is the same function.  Only tiles that the diagonal, the
//     window or sk cut apply a mask (two compares a score against the
//     row's key range); tiles wholly above the diagonal are not visited.
//     The loop starts at the first row's window and stops at the block's
//     causal limit; a row whose leading tiles are all masked is reset by
//     alpha = exp(-1e30 - m) = 0 once it sees a key, as in the TPU kernel.
//   * P V keeps the TPU kernel's float32 p: p = p_hi + p_lo, p_hi its top
//     16 bits and p_lo the rest rounded to bf16, two mma per fragment
//     (p's error ~2^-16 relative).  Rounding p to one bf16 instead broke
//     the 2e-3 + 1.6e-2 |ref| tolerance at the serve geometry.
//   What holds it back at these shapes (PERF.md): a block walks its K/V
//   tiles one after another, each behind a barrier, the load of the next
//   and a chain of dependent mma, reductions and exponentials, and the
//   first tile also waits for Q; with a few hundred blocks the time is
//   that latency, not either peak.  wgmma fed by TMA and a producer warp
//   is for prompts long enough to be bound by operations.
//
// float32: the first design, kept (TF32 would break the float32
// tolerance).  One thread block per (b * n_q + h, 64-row query tile);
// each of its 64 threads owns one query row and keeps that row's q, its
// float32 accumulator, running max and sum in registers, and the block
// loops over K/V tiles staged in shared memory as float32, from the first
// key inside its first row's window up to its causal limit, on the CUDA
// cores (67 TFLOP/s: bound by operations).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------------------------ float32 path

constexpr int kBQ = 64;      // query rows per block, one per thread
constexpr int kChunk = 16;   // keys per online-softmax update

template <int HD>
__host__ __device__ constexpr int tile_keys() {
  return HD >= 64 ? 4096 / HD : 64;  // K + V tiles: 32 KB of float32
}

template <int HD>
__global__ void __launch_bounds__(kBQ)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int sq, int sk, int n_q, int n_kv, int causal,
                     int window, float scale) {
  constexpr int BK = tile_keys<HD>();
  constexpr int HD4 = HD / 4;
  static_assert(HD % 4 == 0 && BK % kChunk == 0, "tile shape");
  __shared__ float4 k_s[BK * HD4];
  __shared__ float4 v_s[BK * HD4];

  const int bh = blockIdx.x;
  const int b = bh / n_q;
  const int h = bh - b * n_q;
  const int kvh = h / (n_q / n_kv);
  const int q0 = blockIdx.y * kBQ;
  const int row = q0 + threadIdx.x;
  const bool valid = row < sq;

  float qr[HD];
  float acc[HD];
  const size_t q_off = (((size_t)b * sq + row) * n_q + h) * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = valid ? q[q_off + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  // keys this query tile can see: all of them, or up to its last row,
  // and with a window none before its first row's window.  Skipping the
  // leading fully-masked keys changes nothing for a row that sees a key:
  // the first real score resets l and acc through alpha = 0.
  const int k_end = causal ? min(sk, min(sq, q0 + kBQ)) : sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  float* ks = reinterpret_cast<float*>(k_s);
  float* vs = reinterpret_cast<float*>(v_s);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * HD; i += kBQ) {
      const int t = i / HD, d = i % HD;
      const int kp = k0 + t;
      float kx = 0.f, vx = 0.f;
      if (kp < sk) {
        const size_t off = (((size_t)b * sk + kp) * n_kv + kvh) * HD + d;
        kx = k[off];
        vx = v[off];
      }
      ks[i] = kx;
      vs[i] = vx;
    }
    __syncthreads();

    for (int c = 0; c < BK && k0 + c < k_end; c += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float4* kt = k_s + (c + j) * HD4;
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < HD4; ++d4) {
          const float4 kk = kt[d4];
          dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
        }
        const int kp = k0 + c + j;
        const bool ok = kp < sk && (!causal || kp <= row) &&
                        (window <= 0 || kp > row - window);
        s[j] = ok ? dot * scale : kNegInf;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
        const float4* vt = v_s + (c + j) * HD4;
#pragma unroll
        for (int d4 = 0; d4 < HD4; ++d4) {
          const float4 vv = vt[d4];
          acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (valid) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD; ++d) out[q_off + d] = acc[d] / denom;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int b,
               int sq, int sk, int n_q, int n_kv, int causal, int window,
               float scale, cudaStream_t stream) {
  const dim3 grid(b * n_q, (sq + kBQ - 1) / kBQ);
  flash_f32_kernel<HD><<<grid, kBQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, sk, n_q,
      n_kv, causal, window, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- bfloat16 path

constexpr int kWarps = 4;
constexpr int kKeys = 64;           // keys per K/V tile
constexpr int kNT = kKeys / 8;      // n8 score tiles per m16 tile and K/V tile
constexpr float kLog2e = 1.4426950408889634f;

// MT m16 tiles per warp
template <int HD, int MT>
struct Geo {
  static constexpr int HDP = HD < 16 ? 16 : HD;  // contraction, 0-padded
  static constexpr int LD = HDP + 8;             // smem row: +16 B
  static constexpr int CHUNKS = HD / 8;          // 16 B pieces of a row
  static constexpr int KSTEPS = HDP / 16;        // k16 steps of Q K^T
  static constexpr int DT = HD / 8;              // n8 tiles of the output
  static constexpr int ROWS = 16 * MT * kWarps;  // (position, head) rows
  static constexpr int STAGES = 2;
  static constexpr int TILE = kKeys * LD;        // one K or V tile
  static constexpr int SMEM = (ROWS * LD + 2 * STAGES * TILE) * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 B global -> shared; with pred false nothing is read and 16 zero
// bytes are written
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU op (2^-22 relative; -1e30 gives 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p = hi + lo, both bf16 pairs (p0 in the low half): hi is p with its
// low 16 bits cleared, exact; lo = p - hi, exact in float32, then
// rounded to bf16, so hi + lo is p within 2^-16 relative
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(p0), b1 = __float_as_uint(p1);
  hi = __byte_perm(b0, b1, 0x7632);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(p0 - __uint_as_float(b0 & 0xffff0000u),
                            p1 - __uint_as_float(b1 & 0xffff0000u));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int HD, int MT>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, int sq, int sk,
                      int n_q, int n_kv, int causal, int window,
                      float scale) {
  using G = Geo<HD, MT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = q_s + G::ROWS * G::LD;  // stage i: K, then V

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = n_q / n_kv;
  const int b = blockIdx.x / n_kv;
  const int kvh = blockIdx.x - b * n_kv;
  // first flattened (pos, head) row; the last query tiles, which see the
  // most keys, go first, so that the short ones fill the tail
  const int r0 = (gridDim.y - 1 - blockIdx.y) * G::ROWS;
  const int rows = sq * g;
  const int pos_first = r0 / g;
  const int pos_last = min(r0 + G::ROWS - 1, rows - 1) / g;

  // keys the block visits: up to its causal limit, and with a window
  // from its first row's first key
  const int k_end = causal ? min(sk, pos_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, pos_first - window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys
                                      : 0;

  if constexpr (HD < 16) {  // the zero columns that pad the contraction
    for (int r = tid; r < G::ROWS + 2 * G::STAGES * kKeys; r += kWarps * 32)
      *reinterpret_cast<uint4*>(q_s + r * G::LD + 8) = make_uint4(0, 0, 0, 0);
  }

  // Q rows: row r of the block is flattened row r0 + r = pos * g + j
  for (int i = tid; i < G::ROWS * G::CHUNKS; i += kWarps * 32) {
    const int r = i / G::CHUNKS, c = i - r * G::CHUNKS;
    const int fr = r0 + r;
    const int pos = fr / g;
    const bool ok = fr < rows;
    const __nv_bfloat16* src =
        ok ? q + (((size_t)b * sq + pos) * n_q + (size_t)kvh * g +
                  (fr - pos * g)) * HD + c * 8
           : q;
    cp_async16(smem_u32(q_s + r * G::LD + c * 8), src, ok);
  }

  auto load_tile = [&](int tile, int stage) {
    __nv_bfloat16* ks = kv_s + stage * 2 * G::TILE;
    __nv_bfloat16* vs = ks + G::TILE;
    const int k0 = k_begin + tile * kKeys;
    for (int i = tid; i < kKeys * G::CHUNKS; i += kWarps * 32) {
      const int t = i / G::CHUNKS, c = i - t * G::CHUNKS;
      const int kp = k0 + t;
      const bool ok = kp < sk;
      const size_t off =
          ok ? (((size_t)b * sk + kp) * n_kv + kvh) * HD + c * 8 : 0;
      cp_async16(smem_u32(ks + t * G::LD + c * 8), k + off, ok);
      cp_async16(smem_u32(vs + t * G::LD + c * 8), v + off, ok);
    }
  };

#pragma unroll
  for (int t = 0; t < G::STAGES - 1; ++t) {
    if (t < n_tiles) load_tile(t, t);
    cp_async_commit();  // Q rides in the first group
  }

  // warp w owns block rows [w * 16 MT, (w + 1) * 16 MT); in its m16 tile
  // i this thread holds rows lane/4 and lane/4 + 8 (h = 0, 1)
  int pos[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int ra = r0 + (warp * MT + i) * 16 + (lane >> 2);
    pos[i][0] = ra / g;
    pos[i][1] = (ra + 8) / g;
  }
  const float sl2 = scale * kLog2e;

  uint32_t qa[MT][G::KSTEPS][4];
  float acc[MT][G::DT][4];
  float m_r[MT][2], l_r[MT][2];  // running max (log2 domain), sum share
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int d = 0; d < G::DT; ++d)
      acc[i][d][0] = acc[i][d][1] = acc[i][d][2] = acc[i][d][3] = 0.f;
    m_r[i][0] = m_r[i][1] = kNegInf;
    l_r[i][0] = l_r[i][1] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();  // tile it landed; tile it-1's stage is free
    {
      const int nxt = it + G::STAGES - 1;
      if (nxt < n_tiles) load_tile(nxt, nxt % G::STAGES);
      cp_async_commit();
    }
    if (it == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int ks = 0; ks < G::KSTEPS; ++ks)
          ldsm_x4(qa[i][ks],
                  smem_u32(q_s + ((warp * MT + i) * 16 + (lane & 15)) * G::LD +
                           ks * 16 + (lane >> 4) * 8));
    }
    const __nv_bfloat16* ks_t = kv_s + (it % G::STAGES) * 2 * G::TILE;
    const __nv_bfloat16* vs_t = ks_t + G::TILE;
    const int k0 = k_begin + it * kKeys;

    // S = Q K^T for this warp's rows and the tile's 64 keys; each K
    // fragment serves the warp's MT m16 tiles
    float s[MT][kNT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int t = 0; t < kNT; ++t)
        s[i][t][0] = s[i][t][1] = s[i][t][2] = s[i][t][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < G::KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, smem_u32(ks_t +
                             (np * 16 + (lane & 7) + (lane >> 4) * 8) * G::LD +
                             ks * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(s[i][2 * np], qa[i][ks], kb[0], kb[1]);
          mma_bf16(s[i][2 * np + 1], qa[i][ks], kb[2], kb[3]);
        }
      }
    }

    // scale, and mask only where the diagonal, the window or sk cut: key
    // k0 + c0 + 8t + e is kept for a row iff it lies in the row's
    // [first, last] key range
    const bool need_mask = k0 + kKeys > sk ||
                           (causal && k0 + kKeys - 1 > pos_first) ||
                           (window > 0 && k0 <= pos_last - window);
    const int c0 = k0 + (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lo = window > 0 ? pos[i][h] - window + 1 - c0 : -c0;
        const int hi = (causal ? min(pos[i][h], sk - 1) : sk - 1) - c0;
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[i][t][2 * h + e] * sl2;
            if (need_mask) {
              const int c = t * 8 + e;
              x = c >= lo && c <= hi ? x : kNegInf;
            }
            s[i][t][2 * h + e] = x;
          }
        }
      }
    }

    // online softmax on the fragments
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int t = 0; t < kNT; ++t)
          mx = fmaxf(mx, fmaxf(s[i][t][2 * h], s[i][t][2 * h + 1]));
        const float mn = fmaxf(m_r[i][h], quad_max(mx));
        const float al = exp2_fast(m_r[i][h] - mn);
        m_r[i][h] = mn;
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
          s[i][t][2 * h] = exp2_fast(s[i][t][2 * h] - mn);
          s[i][t][2 * h + 1] = exp2_fast(s[i][t][2 * h + 1] - mn);
          sum += s[i][t][2 * h] + s[i][t][2 * h + 1];
        }
        l_r[i][h] = l_r[i][h] * al + sum;
#pragma unroll
        for (int d = 0; d < G::DT; ++d) {
          acc[i][d][2 * h] *= al;
          acc[i][d][2 * h + 1] *= al;
        }
      }
    }

    // acc += P V, P = P_hi + P_lo in bf16; each V fragment serves the
    // warp's MT m16 tiles
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        split_bf16(s[i][2 * j][0], s[i][2 * j][1], ph[i][0], pl[i][0]);
        split_bf16(s[i][2 * j][2], s[i][2 * j][3], ph[i][1], pl[i][1]);
        split_bf16(s[i][2 * j + 1][0], s[i][2 * j + 1][1], ph[i][2],
                   pl[i][2]);
        split_bf16(s[i][2 * j + 1][2], s[i][2 * j + 1][3], ph[i][3],
                   pl[i][3]);
      }
      if constexpr (G::DT == 1) {
        uint32_t vb[2];
        ldsm_x2_t(vb, smem_u32(vs_t + (j * 16 + (lane & 15)) * G::LD));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][0], ph[i], vb[0], vb[1]);
          mma_bf16(acc[i][0], pl[i], vb[0], vb[1]);
        }
      } else {
#pragma unroll
        for (int dp = 0; dp < G::DT / 2; ++dp) {
          uint32_t vb[4];
          ldsm_x4_t(vb, smem_u32(vs_t +
                                 (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                     G::LD +
                                 dp * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(acc[i][2 * dp], ph[i], vb[0], vb[1]);
            mma_bf16(acc[i][2 * dp], pl[i], vb[0], vb[1]);
            mma_bf16(acc[i][2 * dp + 1], ph[i], vb[2], vb[3]);
            mma_bf16(acc[i][2 * dp + 1], pl[i], vb[2], vb[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const int col = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = 1.f / fmaxf(quad_sum(l_r[i][h]), 1e-30f);
      const int row = r0 + (warp * MT + i) * 16 + (lane >> 2) + 8 * h;
      if (row < rows) {
        __nv_bfloat16* o = out + (((size_t)b * sq + pos[i][h]) * n_q +
                                  (size_t)kvh * g + (row - pos[i][h] * g)) *
                                     HD + col;
#pragma unroll
        for (int d = 0; d < G::DT; ++d)
          *reinterpret_cast<__nv_bfloat162*>(o + d * 8) =
              __floats2bfloat162_rn(acc[i][d][2 * h] * inv,
                                    acc[i][d][2 * h + 1] * inv);
      }
    }
  }
}

template <int HD, int MT>
int launch_geo(const void* q, const void* k, const void* v, void* out, int b,
               int sq, int sk, int n_q, int n_kv, int causal, int window,
               float scale, cudaStream_t stream) {
  using G = Geo<HD, MT>;
  if (G::SMEM > 48 * 1024) {  // per launch: the attribute is per device
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_bf16_kernel<HD, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (attr != cudaSuccess) return (int)attr;
  }
  const long long rows = (long long)sq * (n_q / n_kv);
  const dim3 grid(b * n_kv, (unsigned)((rows + G::ROWS - 1) / G::ROWS));
  flash_bf16_kernel<HD, MT><<<grid, kWarps * 32, G::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), sq, sk, n_q, n_kv, causal, window,
      scale);
  return (int)cudaGetLastError();
}

// Grids of more than two blocks of 64 rows an SM take 32 rows a warp
// (MT 2: each K and V fragment serves two m16 tiles, so K/V tiles are read
// for 128 rows, not 64); smaller ones keep 16 rows a warp and twice the
// blocks.  hd 128 keeps MT 1 (registers).
template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int b,
                int sq, int sk, int n_q, int n_kv, int causal, int window,
                int sms, float scale, cudaStream_t stream) {
  const long long rows = (long long)sq * (n_q / n_kv);
  const long long blocks64 = (long long)b * n_kv * ((rows + 63) / 64);
  if constexpr (HD < 128) {
    if (blocks64 > 2LL * sms)
      return launch_geo<HD, 2>(q, k, v, out, b, sq, sk, n_q, n_kv, causal,
                               window, scale, stream);
  }
  return launch_geo<HD, 1>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window,
                           scale, stream);
}

// a window needs causal self-attention with sk >= sq, so that every row
// sees at least its own key
bool bad_args(int b, int sq, int sk, int n_q, int n_kv, int causal,
              int window) {
  return b <= 0 || sq <= 0 || sk <= 0 || n_kv <= 0 || n_q % n_kv != 0 ||
         (window > 0 && (!causal || sk < sq));
}

}  // namespace

// q [b, sq, n_q, hd]; k/v [b, sk, n_kv, hd]; out [b, sq, n_q, hd], all
// contiguous (bfloat16: 16-byte aligned).  window <= 0 means no window.
// sms is the current device's multiprocessor count (bfloat16 picks its
// rows a warp from it; float32 ignores it).  Launches on `stream`, which
// belongs to the current device, allocates nothing, returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* out, int b,
                                       int sq, int sk, int n_q, int n_kv,
                                       int hd, int causal, int window,
                                       int sms, float scale, void* stream) {
  if (bad_args(b, sq, sk, n_q, n_kv, causal, window))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 8: return launch_f32<8>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, scale, s);
    case 16: return launch_f32<16>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, scale, s);
    case 32: return launch_f32<32>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, scale, s);
    case 64: return launch_f32<64>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, scale, s);
    case 128: return launch_f32<128>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* out, int b,
                                        int sq, int sk, int n_q, int n_kv,
                                        int hd, int causal, int window,
                                        int sms, float scale, void* stream) {
  if (bad_args(b, sq, sk, n_q, n_kv, causal, window))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 8: return launch_bf16<8>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, sms, scale, s);
    case 16: return launch_bf16<16>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, sms, scale, s);
    case 32: return launch_bf16<32>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, sms, scale, s);
    case 64: return launch_bf16<64>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, sms, scale, s);
    case 128: return launch_bf16<128>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, sms, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
