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
//     so one design serves every width the wrapper takes (8 .. 256).
//   * GQA packing in the M dimension: one block of 4 warps takes one
//     (batch, KV head) and 64 or 128 consecutive rows of the flattened
//     (position, query head of the group) space, position-major: for
//     g = 4, 16 or 32 positions x 4 heads.  Any g works, and a block may
//     start or end inside a position.  Each K/V tile enters shared memory
//     once for the g heads, and all warps share one causal frontier.
//     A warp holds 16 rows (MT 1) or, on grids of more than two 64-row
//     blocks an SM, 32 rows (MT 2), where every K and V fragment it loads
//     serves two m16 tiles and K/V tiles are read half as often.
//   * K/V tiles of 64 keys (32 at width 256) travel in bf16 through
//     cp.async (16 B a thread) into a ring of 2 stages, so the next tile
//     loads while one is computed; Q rides in the first group.  Rows are
//     padded by 16 B in shared memory, which makes every ldmatrix (and
//     ldmatrix.trans for V) free of bank conflicts at every width.  The
//     query tiles that see the most keys start first.
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
//   * Width 256 (Griffin's local MQA: 16 query heads over one KV head).
//     A warp's output accumulator is then 128 float32 registers a thread;
//     keeping Q's 64 fragment registers as well, as the narrower widths
//     do, would pass the 255 a thread allows.  So at 256 Q stays in shared
//     memory and each k16 step reloads its fragment (one ldmatrix.x4 a
//     step).  With Q reloaded, 64-key tiles (32 score registers) still
//     spilled 400 B a thread at 255 registers; 32-key tiles halve the
//     scores, and Q plus the 2-stage K/V ring take 101,376 B of shared
//     memory, two blocks an SM (PERF.md).
//
// float32: a redesign of the first float32 kernel (one thread per query
// row on the CUDA cores, every K/V tile loaded once per query head, each
// FMA reading shared memory), which ran at 1.23-1.41x SDPA's time.
// Bound: operations, QK^T and PV over the causal triangle at the 67
// TFLOP/s of float32 outside the tensor cores (b 1, s 512, 32/8 heads,
// hd 64: 0.0161 ms).
//   * The bfloat16 design's structure: (position, query head) rows of one
//     KV head, 64 of them in a block of 4 warps (16 a warp), so each K/V
//     tile is loaded once for the g heads; a 2-stage cp.async ring of
//     32-key float32 tiles (hd 128 takes 99 KB, two blocks an SM; hd 256
//     195 KB, one); the online softmax on the fragments in the log2
//     domain; masks only on cut tiles; the heaviest tiles first.
//   * P V on the tensor cores in 3xTF32: m16n8k8 tf32 mma with a = a_hi +
//     a_lo (cvt.rna.tf32.f32 of a, then of a - a_hi) and a_lo b_hi + a_hi
//     b_lo + a_hi b_hi.  The contraction over keys is permuted (logical
//     t, t + 4 -> keys 2t, 2t + 1), so the score accumulators (columns
//     2t, 2t + 1) are the A fragments as they stand, and V's rows are
//     read in the same order.
//   * Q K^T on the CUDA cores in exact float32 FMA, each thread a register
//     tile of 2 rows by 8 keys laid out as the mma accumulators (16-byte
//     loads of Q and K).  3xTF32 there missed the float32 tolerance of
//     2e-5 on steep scores (q x 30: 5.1e-5 at hd 64, 9.3e-5 at hd 128):
//     the tensor cores lose low bits of a score relative to its largest
//     product, and the exponent turns that into a relative error of p.
//     Accumulating each k step apart or the small terms apart did not
//     help; exact FMA gives 6e-6 (PERF.md, PR 15).
//   * Rows are HD + 4 floats, so the quarter-warp 16-byte loads of Q K^T
//     and the 4-byte V loads of P V hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ----------------------------------------------------------- bfloat16 path

constexpr int kWarps = 4;
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
  // Q's fragments stay in registers up to width 128; at 256 each k16 step
  // reloads its fragment from shared memory, for want of registers
  static constexpr bool QREG = HD <= 128;
  static constexpr int QKS = QREG ? KSTEPS : 1;  // k steps held in registers
  // keys per K/V tile: 64, or 32 at width 256, where the 32 score
  // registers of a 64-key tile beside the 128 of the accumulator spill
  static constexpr int KEYS = HD > 128 ? 32 : 64;
  static constexpr int NT = KEYS / 8;  // n8 score tiles per m16 and K/V tile
  static constexpr int TILE = KEYS * LD;         // one K or V tile
  static constexpr int SMEM = (ROWS * LD + 2 * STAGES * TILE) * 2;
};

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
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + G::KEYS - 1) / G::KEYS : 0;

  if constexpr (HD < 16) {  // the zero columns that pad the contraction
    for (int r = tid; r < G::ROWS + 2 * G::STAGES * G::KEYS; r += kWarps * 32)
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
    const int k0 = k_begin + tile * G::KEYS;
    for (int i = tid; i < G::KEYS * G::CHUNKS; i += kWarps * 32) {
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

  uint32_t qa[MT][G::QKS][4];
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
    auto load_q = [&](uint32_t(&r)[4], int i, int ks) {
      ldsm_x4(r, smem_u32(q_s + ((warp * MT + i) * 16 + (lane & 15)) * G::LD +
                          ks * 16 + (lane >> 4) * 8));
    };
    if constexpr (G::QREG) {
      if (it == 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int ks = 0; ks < G::KSTEPS; ++ks) load_q(qa[i][ks], i, ks);
      }
    }
    const __nv_bfloat16* ks_t = kv_s + (it % G::STAGES) * 2 * G::TILE;
    const __nv_bfloat16* vs_t = ks_t + G::TILE;
    const int k0 = k_begin + it * G::KEYS;

    // S = Q K^T for this warp's rows and the tile's keys; each K
    // fragment serves the warp's MT m16 tiles
    float s[MT][G::NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int t = 0; t < G::NT; ++t)
        s[i][t][0] = s[i][t][1] = s[i][t][2] = s[i][t][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < G::KSTEPS; ++ks) {
      if constexpr (!G::QREG) {
#pragma unroll
        for (int i = 0; i < MT; ++i) load_q(qa[i][0], i, ks);
      }
      const int kq = G::QREG ? ks : 0;
#pragma unroll
      for (int np = 0; np < G::NT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, smem_u32(ks_t +
                             (np * 16 + (lane & 7) + (lane >> 4) * 8) * G::LD +
                             ks * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(s[i][2 * np], qa[i][kq], kb[0], kb[1]);
          mma_bf16(s[i][2 * np + 1], qa[i][kq], kb[2], kb[3]);
        }
      }
    }

    // scale, and mask only where the diagonal, the window or sk cut: key
    // k0 + c0 + 8t + e is kept for a row iff it lies in the row's
    // [first, last] key range
    const bool need_mask = k0 + G::KEYS > sk ||
                           (causal && k0 + G::KEYS - 1 > pos_first) ||
                           (window > 0 && k0 <= pos_last - window);
    const int c0 = k0 + (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lo = window > 0 ? pos[i][h] - window + 1 - c0 : -c0;
        const int hi = (causal ? min(pos[i][h], sk - 1) : sk - 1) - c0;
#pragma unroll
        for (int t = 0; t < G::NT; ++t) {
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
        for (int t = 0; t < G::NT; ++t)
          mx = fmaxf(mx, fmaxf(s[i][t][2 * h], s[i][t][2 * h + 1]));
        const float mn = fmaxf(m_r[i][h], quad_max(mx));
        const float al = exp2_fast(m_r[i][h] - mn);
        m_r[i][h] = mn;
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < G::NT; ++t) {
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
    for (int j = 0; j < G::NT / 2; ++j) {
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
// blocks.  hd 128 and 256 keep MT 1 (registers).
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

// ------------------------------------------------------------ float32 path

constexpr int kKeysF = 32;          // keys per float32 K/V tile
constexpr int kNTF = kKeysF / 8;    // n8 score tiles per K/V tile

template <int HD>
struct GeoF {
  // rows of HD + 4 floats: the 16-byte loads of QK^T (keys 2t, t = 0..3,
  // in a quarter warp) and the 4-byte V loads of PV (rows 2t) each hit
  // distinct banks
  static constexpr int LD = HD + 4;
  static constexpr int CHUNKS = HD / 4;          // 16 B pieces of a row
  static constexpr int DT = HD / 8;              // n8 tiles of the output
  static constexpr int ROWS = 16 * kWarps;       // (position, head) rows
  static constexpr int TILE = kKeysF * LD;       // one K or V tile
  static constexpr int SMEM = (ROWS * LD + 4 * TILE) * 4;  // Q, 2 stages
};

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int sq, int sk, int n_q, int n_kv, int causal, int window,
                     float scale) {
  using G = GeoF<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* kv_s = q_s + G::ROWS * G::LD;  // stage i: K, then V

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int g = n_q / n_kv;
  const int b = blockIdx.x / n_kv;
  const int kvh = blockIdx.x - b * n_kv;
  // the last query tiles, which see the most keys, go first
  const int r0 = (gridDim.y - 1 - blockIdx.y) * G::ROWS;
  const int rows = sq * g;
  const int pos_first = r0 / g;
  const int pos_last = min(r0 + G::ROWS - 1, rows - 1) / g;
  const int k_end = causal ? min(sk, pos_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, pos_first - window + 1) : 0;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kKeysF - 1) / kKeysF : 0;

  // Q rows: row r of the block is flattened row r0 + r = pos * g + j
  for (int i = tid; i < G::ROWS * G::CHUNKS; i += kWarps * 32) {
    const int r = i / G::CHUNKS, c = i - r * G::CHUNKS;
    const int fr = r0 + r;
    const int pos = fr / g;
    const bool ok = fr < rows;
    const float* src =
        ok ? q + (((size_t)b * sq + pos) * n_q + (size_t)kvh * g +
                  (fr - pos * g)) * HD + c * 4
           : q;
    cp_async16(smem_u32(q_s + r * G::LD + c * 4), src, ok);
  }

  auto load_tile = [&](int tile, int stage) {
    float* ks = kv_s + stage * 2 * G::TILE;
    float* vs = ks + G::TILE;
    const int k0 = k_begin + tile * kKeysF;
    for (int i = tid; i < kKeysF * G::CHUNKS; i += kWarps * 32) {
      const int t = i / G::CHUNKS, c = i - t * G::CHUNKS;
      const int kp = k0 + t;
      const bool ok = kp < sk;
      const size_t off =
          ok ? (((size_t)b * sk + kp) * n_kv + kvh) * HD + c * 4 : 0;
      cp_async16(smem_u32(ks + t * G::LD + c * 4), k + off, ok);
      cp_async16(smem_u32(vs + t * G::LD + c * 4), v + off, ok);
    }
  };

  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();  // Q rides in the first group

  // this thread holds rows lane/4 and lane/4 + 8 of the warp's 16 (h)
  const int ra = r0 + warp * 16 + g8;
  const int pos[2] = {ra / g, (ra + 8) / g};
  const float sl2 = scale * kLog2e;
  const float* q_w = q_s + (warp * 16 + g8) * G::LD;

  float acc[G::DT][4];
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < G::DT; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; tile it-1's stage is free
    if (it + 1 < n_tiles) load_tile(it + 1, (it + 1) & 1);
    cp_async_commit();
    const float* ks_t = kv_s + (it & 1) * 2 * G::TILE;
    const float* vs_t = ks_t + G::TILE;
    const int k0 = k_begin + it * kKeysF;

    // S = Q K^T on the CUDA cores, in the mma accumulator layout: this
    // thread's rows g and g + 8 against keys 8 nt + 2t and 8 nt + 2t + 1
    float s[kNTF][4];
#pragma unroll
    for (int t = 0; t < kNTF; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    const float* k_t = ks_t + 2 * t4 * G::LD;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(q_w + d);
      const float4 qb = *reinterpret_cast<const float4*>(q_w + 8 * G::LD + d);
#pragma unroll
      for (int nt = 0; nt < kNTF; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 kv =
              *reinterpret_cast<const float4*>(k_t + (8 * nt + e) * G::LD + d);
          float x = s[nt][e], y = s[nt][2 + e];
          x = fmaf(qa.x, kv.x, x);
          x = fmaf(qa.y, kv.y, x);
          x = fmaf(qa.z, kv.z, x);
          x = fmaf(qa.w, kv.w, x);
          y = fmaf(qb.x, kv.x, y);
          y = fmaf(qb.y, kv.y, y);
          y = fmaf(qb.z, kv.z, y);
          y = fmaf(qb.w, kv.w, y);
          s[nt][e] = x;
          s[nt][2 + e] = y;
        }
      }
    }

    // scale, and mask only where the diagonal, the window or sk cut
    const bool need_mask = k0 + kKeysF > sk ||
                           (causal && k0 + kKeysF - 1 > pos_first) ||
                           (window > 0 && k0 <= pos_last - window);
    const int c0 = k0 + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lo = window > 0 ? pos[h] - window + 1 - c0 : -c0;
      const int hi = (causal ? min(pos[h], sk - 1) : sk - 1) - c0;
#pragma unroll
      for (int t = 0; t < kNTF; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[t][2 * h + e] * sl2;
          if (need_mask) {
            const int c = t * 8 + e;
            x = c >= lo && c <= hi ? x : kNegInf;
          }
          s[t][2 * h + e] = x;
        }
      }
    }

    // online softmax on the fragments
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kNTF; ++t)
        mx = fmaxf(mx, fmaxf(s[t][2 * h], s[t][2 * h + 1]));
      const float mn = fmaxf(m_r[h], quad_max(mx));
      const float al = exp2_fast(m_r[h] - mn);
      m_r[h] = mn;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kNTF; ++t) {
        s[t][2 * h] = exp2_fast(s[t][2 * h] - mn);
        s[t][2 * h + 1] = exp2_fast(s[t][2 * h + 1] - mn);
        sum += s[t][2 * h] + s[t][2 * h + 1];
      }
      l_r[h] = l_r[h] * al + sum;
#pragma unroll
      for (int d = 0; d < G::DT; ++d) {
        acc[d][2 * h] *= al;
        acc[d][2 * h + 1] *= al;
      }
    }

    // acc += P V: the score accumulators of n8 tile j are the tf32 A
    // fragments of keys 8j.. with logical k t, t + 4 -> keys 2t, 2t + 1
#pragma unroll
    for (int j = 0; j < kNTF; ++j) {
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
      const float* vr = vs_t + (j * 8 + 2 * t4) * G::LD + g8;
#pragma unroll
      for (int d = 0; d < G::DT; ++d) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(vr[d * 8], bh0, bl0);
        split_tf32(vr[G::LD + d * 8], bh1, bl1);
        mma3(acc[d], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = 1.f / fmaxf(quad_sum(l_r[h]), 1e-30f);
    const int row = ra + 8 * h;
    if (row < rows) {
      float* o = out + (((size_t)b * sq + pos[h]) * n_q + (size_t)kvh * g +
                        (row - pos[h] * g)) * HD + 2 * t4;
#pragma unroll
      for (int d = 0; d < G::DT; ++d)
        *reinterpret_cast<float2*>(o + d * 8) =
            make_float2(acc[d][2 * h] * inv, acc[d][2 * h + 1] * inv);
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int b,
               int sq, int sk, int n_q, int n_kv, int causal, int window,
               float scale, cudaStream_t stream) {
  using G = GeoF<HD>;
  if (G::SMEM > 48 * 1024) {  // per launch: the attribute is per device
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::SMEM);
    if (attr != cudaSuccess) return (int)attr;
  }
  const long long rows = (long long)sq * (n_q / n_kv);
  const dim3 grid(b * n_kv, (unsigned)((rows + G::ROWS - 1) / G::ROWS));
  flash_f32_kernel<HD><<<grid, kWarps * 32, G::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, sk, n_q,
      n_kv, causal, window, scale);
  return (int)cudaGetLastError();
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
    case 256: return launch_f32<256>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, scale, s);
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
    case 256: return launch_bf16<256>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, sms, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
