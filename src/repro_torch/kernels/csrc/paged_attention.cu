// Paged-KV single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:
// paged_attention_fwd (body _kernel).  One query token per slot attends
// the slot's KV stream, stored in fixed-size pages of a global pool:
// logical positions [i*ps, (i+1)*ps) of slot b live in pool page
// block_tables[b, i].  Mask: k_pos < kv_len[b], and with a window also
// k_pos > kv_len[b] - 1 - window.  Masked scores are -1e30, the running
// max starts at -1e30, the online softmax runs in float32, and the output
// is acc / max(l, 1e-30), exactly as in the TPU kernel.
//
// What bounds it on this card: bytes.  At decode shapes (8 slots, 32
// query heads over 8 KV heads, head_dim 64, up to 1024 positions) every
// K/V element is read once and used for g = n_q / n_kv query rows, a few
// operations per byte against the ~295 the H100 needs to be compute
// bound.  So the work is to read each needed K/V byte once and nothing
// more.
//
// What this first design does about it: one thread block per
// (slot, kv_head) handles the head's g query rows together, so each K/V
// page is read from device memory once for all g rows.  The block walks
// the slot's pages 0 .. ceil(kv_len/ps)-1 only (the TPU kernel's page
// skip), loading page block_tables[b, i]'s [ps, hd] K and V tiles into
// shared memory; the loop inside the block takes the place of the TPU's
// sequential page grid axis.  Scores, the running max/sum and the
// [g, hd] accumulator stay in float32 in shared memory.  Loads are scalar
// and one page is in flight at a time; wider loads, several pages in
// flight and split-K over pages for few slots are for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory, all float32: q [g, hd], acc [g, hd], K tile [ps, hd + 1]
// (padded row: the score loop reads K rows at a stride without bank
// conflicts), V tile [ps, hd], p [g, ps], and m, l, alpha [g] each.
__host__ __device__ inline size_t smem_floats(int g, int hd, int ps) {
  return (size_t)g * hd * 2 + (size_t)ps * (hd + 1) + (size_t)ps * hd +
         (size_t)g * ps + 3 * (size_t)g;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages,
                           const int* __restrict__ block_tables,
                           const int* __restrict__ kv_len,
                           T* __restrict__ out, int n_q, int n_kv, int hd,
                           int ps, int max_blocks, int window, float scale) {
  const int slot = blockIdx.x;
  const int h = blockIdx.y;  // kv head; query heads h*g .. h*g+g-1
  const int g = n_q / n_kv;
  const int kstride = hd + 1;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc_s = q_s + g * hd;
  float* k_s = acc_s + g * hd;
  float* v_s = k_s + ps * kstride;
  float* p_s = v_s + ps * hd;
  float* m_s = p_s + g * ps;
  float* l_s = m_s + g;
  float* alpha_s = l_s + g;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  const size_t q_base = ((size_t)slot * n_q + (size_t)h * g) * hd;
  for (int i = tid; i < g * hd; i += blockDim.x) {
    q_s[i] = to_float(q[q_base + i]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < g; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int len = kv_len[slot];
  const int n_blocks =
      len > 0 ? min((len + ps - 1) / ps, max_blocks) : 0;
  const size_t token_stride = (size_t)n_kv * hd;

  for (int ib = 0; ib < n_blocks; ++ib) {
    const int page = block_tables[(size_t)slot * max_blocks + ib];
    const size_t base = (size_t)page * ps * token_stride + (size_t)h * hd;
    __syncthreads();  // the previous page's tiles and p are consumed
    for (int i = tid; i < ps * hd; i += blockDim.x) {
      const int t = i / hd, d = i - t * hd;
      const size_t off = base + (size_t)t * token_stride + d;
      k_s[t * kstride + d] = to_float(k_pages[off]);
      v_s[i] = to_float(v_pages[off]);
    }
    __syncthreads();

    // scores s[r, t] = (q_r . k_t) * scale, masked to -1e30
    for (int i = tid; i < g * ps; i += blockDim.x) {
      const int r = i / ps, t = i - r * ps;
      const float* qr = q_s + r * hd;
      const float* kt = k_s + t * kstride;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kt[d], s);
      s *= scale;
      const int pos = ib * ps + t;
      bool ok = pos < len;
      if (window >= 0) ok = ok && pos > len - 1 - window;
      p_s[i] = ok ? s : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int r = warp; r < g; r += nwarps) {
      float* pr = p_s + r * ps;
      const float m_prev = m_s[r];
      float mx = m_prev;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float p = expf(pr[t] - mx);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - mx);
        alpha_s[r] = a;
        l_s[r] = l_s[r] * a + sum;
        m_s[r] = mx;
      }
    }
    __syncthreads();

    // acc[r, d] = acc[r, d] * alpha[r] + sum_t p[r, t] * v[t, d]
    for (int i = tid; i < g * hd; i += blockDim.x) {
      const int r = i / hd, d = i - r * hd;
      const float* pr = p_s + r * ps;
      float pv = 0.f;
      for (int t = 0; t < ps; ++t) pv = fmaf(pr[t], v_s[t * hd + d], pv);
      acc_s[i] = acc_s[i] * alpha_s[r] + pv;
    }
  }
  __syncthreads();

  for (int i = tid; i < g * hd; i += blockDim.x) {
    const int r = i / hd;
    out[q_base + i] = from_float<T>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* kv_len, void* out,
           int slots, int n_q, int n_kv, int hd, int ps, int max_blocks,
           int window, float scale, void* stream) {
  if (slots <= 0 || n_kv <= 0 || n_q % n_kv != 0 || hd <= 0 || ps <= 0 ||
      max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(n_q / n_kv, hd, ps);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(slots, n_kv);
  paged_attention_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(kv_len), static_cast<T*>(out), n_q, n_kv, hd,
      ps, max_blocks, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [slots, n_q, hd]; k/v pages [n_pages, ps, n_kv, hd]; block_tables
// [slots, max_blocks] int32; kv_len [slots] int32; out [slots, n_q, hd].
// window < 0 means no window.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError() after the launch.
extern "C" int paged_attention_fwd_f32(const void* q, const void* k_pages,
                                       const void* v_pages,
                                       const void* block_tables,
                                       const void* kv_len, void* out,
                                       int slots, int n_q, int n_kv, int hd,
                                       int ps, int max_blocks, int window,
                                       float scale, void* stream) {
  return launch<float>(q, k_pages, v_pages, block_tables, kv_len, out, slots,
                       n_q, n_kv, hd, ps, max_blocks, window, scale, stream);
}

extern "C" int paged_attention_fwd_bf16(const void* q, const void* k_pages,
                                        const void* v_pages,
                                        const void* block_tables,
                                        const void* kv_len, void* out,
                                        int slots, int n_q, int n_kv, int hd,
                                        int ps, int max_blocks, int window,
                                        float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, kv_len,
                               out, slots, n_q, n_kv, hd, ps, max_blocks,
                               window, scale, stream);
}
