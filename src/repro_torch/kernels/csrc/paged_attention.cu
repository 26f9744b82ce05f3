// Paged-KV single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:
// paged_attention_fwd (body _kernel).  One query token per slot attends
// the slot's KV stream, stored in fixed-size pages of a global pool:
// logical positions [i*ps, (i+1)*ps) of slot b live in pool page
// block_tables[b, i].  Mask: k_pos < kv_len[b], and with a window also
// k_pos > kv_len[b] - 1 - window.  Masked scores are -1e30, the running
// max starts at -1e30, the online softmax runs in float32, and the output
// is acc / max(l, 1e-30), as in the TPU kernel.
//
// What bounds it on this card: bytes.  At the serve geometry (8 slots,
// 32 query heads over 8 KV heads, head_dim 64, pages of 16, up to 34
// pages a slot) a call reads the K and V its slots need, 3.27 MB in bf16
// at kv_len <= 544: 0.98 us at 3.35 TB/s, against 4 flops per byte (each
// K/V element serves g = 4 query rows), far below the ~295 at which the
// tensor cores would be the limit.  What sets the time is latency: the
// chain kv_len -> block table -> page, and how many pages each SM has in
// flight.
//
// The design, split-K over pages:
//   * Grid (slots, kv_heads, splits).  Block z takes pages [z*pps,
//     (z+1)*pps) of its slot for all g query heads of its KV head, so
//     each page is read once for g rows.  The wrapper picks splits and
//     pps (pages per split) on the host from the shapes alone, so that
//     the grid fills the SMs four times over (12 splits of 3 pages at the
//     serve geometry); it never reads kv_len.
//   * The splits that visit a page are those from the window's first
//     page to ceil(kv_len / ps) (the TPU kernel's page skip); any other
//     block returns at once.  Leading pages wholly outside a window
//     (window >= 1) are skipped: a row that sees a key resets whatever
//     they would have added through alpha = exp(-1e30 - m) = 0, so the
//     skip is exact.  A slot with kv_len = 0 gets zeros from block 0.
//   * The block's keys go in chunks of 64 (32 for rows of 512 B or more)
//     through cp.async, 16 B a thread, into a ring of 2 stages: up to 128
//     keys, 8 pages of 16, in flight a block.  At width 256 (Griffin's
//     MQA, g = 16) the bf16 ring takes 67.6 KB and the float32 one 133
//     KB, beside ~40 KB of float32 scratch for the 16 rows.  The block
//     table's entries for the range load with q, before kv_len is known.
//     Keys past the range are zero-filled and take no part (score -inf,
//     p = 0); keys inside it past kv_len or outside the window score
//     -1e30, as in the TPU kernel.
//     No page id means anything to the kernel: the paged pool's trash
//     page 0 is never read because no table maps a live position to it,
//     and the Griffin decode, whose tables view each slot's ring of
//     window keys as pages, reads page 0 as slot 0's first ring page.
//   * Scores: a thread per (row, key), float32 from the stored type; the
//     softmax a warp per row; P V a thread per (row, pair of dims).
//   * Merge: when one split visits every page it writes the output.
//     Otherwise each visiting block writes its partial (m, l, acc[g,
//     hd]) to scratch and bumps an int32 arrival counter for its (slot,
//     kv head); the last to arrive loads every partial at once and
//     merges them, m = max m_i, out = sum e^(m_i - m) acc_i /
//     max(sum e^(m_i - m) l_i, 1e-30), the sum over i in order, then
//     resets the counter to 0.  No float atomics: the output is bitwise
//     the same from run to run.  The wrapper owns the scratch and the
//     counters; the kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kStages = 2;
constexpr int kRB = 4;  // query rows per thread and pass of the score phase

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
  return __float2bfloat16(x);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 16 B of shared memory as float32
__device__ __forceinline__ void unpack16(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p,
                                         float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <typename T, int HD>
struct Geo {
  static constexpr int VEC = 16 / sizeof(T);        // elements per 16 B
  static constexpr int CHUNKS = HD / VEC;           // 16 B pieces of a row
  static constexpr int LD = HD + VEC;               // smem row: +16 B
  static constexpr int CH = HD * sizeof(T) >= 512 ? 32 : 64;  // keys
  static constexpr int TILE = CH * LD;
};

// Float32 scratch of the block, then the K/V ring in T: q [g, hd],
// acc [g, hd], p [g, CH], m, l, alpha [g], merge weights [g, splits],
// page ids [pps].
__host__ __device__ inline size_t head_bytes(int g, int hd, int ch,
                                             int splits, int pps) {
  const size_t b = sizeof(float) * ((size_t)2 * g * hd + (size_t)g * ch +
                                    3 * (size_t)g + (size_t)g * splits) +
                   sizeof(int) * (size_t)pps;
  return (b + 15) / 16 * 16;
}

template <typename T, int HD>
size_t smem_bytes(int g, int splits, int pps) {
  using G = Geo<T, HD>;
  return head_bytes(g, HD, G::CH, splits, pps) +
         sizeof(T) * 2 * kStages * G::TILE;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages,
                           const int* __restrict__ block_tables,
                           const int* __restrict__ kv_len,
                           T* __restrict__ out, float* __restrict__ part_acc,
                           float* __restrict__ part_ml,
                           int* __restrict__ counters, int n_q, int n_kv,
                           int ps, int max_blocks, int pps, int window,
                           float scale) {
  using G = Geo<T, HD>;
  constexpr int CH = G::CH;
  constexpr int NRG = kThreads / CH;  // row groups of the score phase
  const int slot = blockIdx.x;
  const int h = blockIdx.y;  // kv head; query heads h*g .. h*g+g-1
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int g = n_q / n_kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* acc_s = q_s + g * HD;
  float* p_s = acc_s + g * HD;
  float* m_s = p_s + g * CH;
  float* l_s = m_s + g;
  float* a_s = l_s + g;
  float* w_s = a_s + g;
  int* pid_s = reinterpret_cast<int*>(w_s + g * splits);
  T* kv_s =
      reinterpret_cast<T*>(smem_raw + head_bytes(g, HD, CH, splits, pps));

  // independent loads first: the range's block-table entries, q, kv_len
  const int p0 = split * pps;
  for (int i = tid; i < pps; i += kThreads)
    pid_s[i] = p0 + i < max_blocks
                   ? block_tables[(size_t)slot * max_blocks + p0 + i]
                   : 0;
  const size_t q_base = ((size_t)slot * n_q + (size_t)h * g) * HD;
  for (int i = tid; i < g * HD; i += kThreads) {
    q_s[i] = to_float(q[q_base + i]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < g; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  // the pages this split visits, [lo, hi), and the splits that visit
  // any, z_lo .. z_lo + n_active - 1
  const int len = kv_len[slot];
  const int n_pages = len > 0 ? min((len + ps - 1) / ps, max_blocks) : 0;
  const int first = window >= 1 ? max(0, len - window) / ps : 0;
  const int lo = max(p0, first);
  const int hi = min(p0 + pps, n_pages);
  const int z_lo = first / pps;
  const int n_active = first < n_pages ? (n_pages + pps - 1) / pps - z_lo : 0;
  if (hi <= lo) {  // nothing to visit; with no split active, split 0
    if (n_active == 0 && split == 0)  // writes the empty slot's zeros
      for (int i = tid; i < g * HD; i += kThreads)
        out[((size_t)slot * n_q + (size_t)h * g) * HD + i] = from_float<T>(0.f);
    return;
  }
  __syncthreads();

  const int k_lo = lo * ps;
  const int k_hi = hi * ps;
  const int n_chunks = hi > lo ? (k_hi - k_lo + CH - 1) / CH : 0;
  const size_t token_stride = (size_t)n_kv * HD;

  auto load_chunk = [&](int c) {
    T* ks = kv_s + (c % kStages) * 2 * G::TILE;
    T* vs = ks + G::TILE;
    for (int i = tid; i < CH * G::CHUNKS; i += kThreads) {
      const int t = i / G::CHUNKS, part = i - t * G::CHUNKS;
      const int key = k_lo + c * CH + t;
      const bool ok = key < k_hi;
      size_t off = 0;
      if (ok) {
        const int page = pid_s[key / ps - p0];
        off = ((size_t)page * ps + key % ps) * token_stride +
              (size_t)h * HD + part * G::VEC;
      }
      const uint32_t dk = static_cast<uint32_t>(
          __cvta_generic_to_shared(ks + t * G::LD + part * G::VEC));
      const uint32_t dv = static_cast<uint32_t>(
          __cvta_generic_to_shared(vs + t * G::LD + part * G::VEC));
      cp_async16(dk, k_pages + off, ok);
      cp_async16(dv, v_pages + off, ok);
    }
  };

  if (n_chunks > 0) load_chunk(0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load_chunk(c + 1);
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();  // chunk c landed
    const T* ks = kv_s + (c % kStages) * 2 * G::TILE;
    const T* vs = ks + G::TILE;

    // scores: a thread per (row, key), the key's row read once (16 B
    // loads at a 16 B-padded stride: no bank conflicts) for up to kRB
    // rows; q from shared memory as a broadcast
    {
      const int t = tid % CH;
      const int key = k_lo + c * CH + t;
      const bool visited = key < k_hi;
      const bool ok = key < len && (window < 0 || key > len - 1 - window);
      const T* kt = ks + t * G::LD;
      for (int rb = tid / CH; rb < g; rb += NRG * kRB) {
        float dot[kRB];
#pragma unroll
        for (int j = 0; j < kRB; ++j) dot[j] = 0.f;
#pragma unroll
        for (int part = 0; part < G::CHUNKS; ++part) {
          float kf[G::VEC];
          unpack16(kt + part * G::VEC, kf);
#pragma unroll
          for (int j = 0; j < kRB; ++j) {
            if (rb + j * NRG < g) {
              const float* qr = q_s + (rb + j * NRG) * HD + part * G::VEC;
#pragma unroll
              for (int e = 0; e < G::VEC; ++e)
                dot[j] = fmaf(qr[e], kf[e], dot[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kRB; ++j)
          if (rb + j * NRG < g)
            p_s[(rb + j * NRG) * CH + t] =
                !visited ? -INFINITY : ok ? dot[j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, a warp per row
    for (int r = warp; r < g; r += kThreads / 32) {
      float* pr = p_s + r * CH;
      const float m_prev = m_s[r];
      float mx = m_prev;
      for (int t = lane; t < CH; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < CH; t += 32) {
        const float p = expf(pr[t] - mx);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - mx);
        a_s[r] = a;
        l_s[r] = l_s[r] * a + sum;
        m_s[r] = mx;
      }
    }
    __syncthreads();

    // acc[r, d:d+2] = acc * alpha[r] + sum_t p[r, t] v[t, d:d+2]
    for (int i = tid; i < g * HD / 2; i += kThreads) {
      const int r = (2 * i) / HD, d = 2 * i - r * HD;
      const float* pr = p_s + r * CH;
      float x = 0.f, y = 0.f;
#pragma unroll 8
      for (int t = 0; t < CH; ++t) {
        const float2 vv = load2(vs + t * G::LD + d);
        x = fmaf(pr[t], vv.x, x);
        y = fmaf(pr[t], vv.y, y);
      }
      const float a = a_s[r];
      acc_s[2 * i] = acc_s[2 * i] * a + x;
      acc_s[2 * i + 1] = acc_s[2 * i + 1] * a + y;
    }
    __syncthreads();  // chunk c's stage and p are consumed
  }

  const size_t row0 = (size_t)slot * n_q + (size_t)h * g;
  if (n_active == 1) {  // the only split that saw a key: no merge
    for (int i = tid; i < g * HD; i += kThreads)
      out[row0 * HD + i] =
          from_float<T>(acc_s[i] / fmaxf(l_s[i / HD], 1e-30f));
    return;
  }

  // this split's partial, then the arrival; the last to arrive merges
  const size_t part0 = ((size_t)slot * n_kv + h) * splits;
  {
    float* pa = part_acc + (part0 + split) * g * HD;
    for (int i = tid; i < g * HD; i += kThreads) pa[i] = acc_s[i];
    for (int r = tid; r < g; r += kThreads) {
      part_ml[((part0 + split) * g + r) * 2] = m_s[r];
      part_ml[((part0 + split) * g + r) * 2 + 1] = l_s[r];
    }
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  int* counter = counters + (size_t)slot * n_kv + h;
  if (tid == 0) last = atomicAdd(counter, 1) == n_active - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // per row, a warp: m = max m_z, the weights e^(m_z - m) into w_s, and
  // l = sum_z e^(m_z - m) l_z, every (m_z, l_z) loaded at once
  for (int r = warp; r < g; r += kThreads / 32) {
    float mx = kNegInf;
    for (int z = lane; z < n_active; z += 32)
      mx = fmaxf(mx, __ldcg(part_ml + ((part0 + z_lo + z) * g + r) * 2));
    mx = warp_max(mx);
    float den = 0.f;
    for (int z = lane; z < n_active; z += 32) {
      const float* ml = part_ml + ((part0 + z_lo + z) * g + r) * 2;
      const float w = expf(__ldcg(ml) - mx);
      w_s[r * splits + z] = w;
      den += w * __ldcg(ml + 1);
    }
    den = warp_sum(den);
    if (lane == 0) l_s[r] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  // out = sum_z w_z acc_z / l, z in order
  for (int i = tid; i < g * HD; i += kThreads) {
    const int r = i / HD;
    const float* w = w_s + r * splits;
    const float* pa = part_acc + (part0 + z_lo) * g * HD + i;
    float num = 0.f;
#pragma unroll 4
    for (int z = 0; z < n_active; ++z)
      num = fmaf(w[z], __ldcg(pa + (size_t)z * g * HD), num);
    out[row0 * HD + i] = from_float<T>(num / l_s[r]);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k_pages, const void* v_pages,
              const void* block_tables, const void* kv_len, void* out,
              void* part_acc, void* part_ml, void* counters, int slots,
              int n_q, int n_kv, int ps, int max_blocks, int splits, int pps,
              int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(n_q / n_kv, splits, pps);
  if (smem > 48 * 1024) {  // per launch: the attribute is per device
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(slots, n_kv, splits);
  paged_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(kv_len), static_cast<T*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(counters), n_q, n_kv, ps, max_blocks, pps, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* kv_len, void* out,
           void* part_acc, void* part_ml, void* counters, int slots, int n_q,
           int n_kv, int hd, int ps, int max_blocks, int splits, int pps,
           int window, float scale, void* stream) {
  if (slots <= 0 || n_kv <= 0 || n_q % n_kv != 0 || ps <= 0 ||
      max_blocks <= 0 || splits <= 0 || pps <= 0 ||
      (long long)splits * pps < max_blocks ||
      (long long)(splits - 1) * pps >= max_blocks ||
      (splits > 1 && (!part_acc || !part_ml || !counters)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define PAGED_HD(HD)                                                       \
  case HD:                                                                 \
    return launch_hd<T, HD>(q, k_pages, v_pages, block_tables, kv_len, out, \
                            part_acc, part_ml, counters, slots, n_q, n_kv,  \
                            ps, max_blocks, splits, pps, window, scale, s);
  switch (hd) {
    PAGED_HD(8)
    PAGED_HD(16)
    PAGED_HD(32)
    PAGED_HD(64)
    PAGED_HD(128)
    PAGED_HD(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PAGED_HD
}

}  // namespace

// q [slots, n_q, hd]; k/v pages [n_pages, ps, n_kv, hd]; block_tables
// [slots, max_blocks] int32; kv_len [slots] int32; out [slots, n_q, hd],
// all contiguous and 16-byte aligned.  splits x pps covers max_blocks
// with no split wholly past it.  With splits > 1: part_acc float32
// [slots, n_kv, splits, g, hd], part_ml float32 [slots, n_kv, splits, g,
// 2], counters int32 [slots, n_kv], zero before the first launch (each
// launch leaves them zero).  window < 0 means no window.  Launches on
// `stream`, which belongs to the current device, allocates nothing,
// returns cudaGetLastError() after the launch.
extern "C" int paged_attention_fwd_f32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* kv_len, void* out, void* part_acc,
    void* part_ml, void* counters, int slots, int n_q, int n_kv, int hd,
    int ps, int max_blocks, int splits, int pps, int window, float scale,
    void* stream) {
  return launch<float>(q, k_pages, v_pages, block_tables, kv_len, out,
                       part_acc, part_ml, counters, slots, n_q, n_kv, hd, ps,
                       max_blocks, splits, pps, window, scale, stream);
}

extern "C" int paged_attention_fwd_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* kv_len, void* out, void* part_acc,
    void* part_ml, void* counters, int slots, int n_q, int n_kv, int hd,
    int ps, int max_blocks, int splits, int pps, int window, float scale,
    void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, kv_len,
                               out, part_acc, part_ml, counters, slots, n_q,
                               n_kv, hd, ps, max_blocks, splits, pps, window,
                               scale, stream);
}
