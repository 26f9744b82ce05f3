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
// shapes (head_dim 64, a few hundred positions).  q, k, v and the output
// are each read or written once in the bound, and the work per byte
// grows only with the sequence length; at head_dim 64 and 512 positions
// it stays below the ~295 operations per byte at which the H100's tensor
// cores become the limit.  Float32 inputs run outside the tensor cores
// (67 TFLOP/s), where the same work is bound by operations.
//
// What this first design does about it: one thread block per
// (b * n_q + h, 64-row query tile); each of its 64 threads owns one
// query row and keeps that row's q, its float32 accumulator, running max
// and sum in registers.  The block loops over 64-key K/V tiles (fewer
// keys per tile for head_dim 128) from the first key inside the window
// of its first row (key 0 without a window) up to the causal limit of its
// query tile, staging each tile in shared memory as float32, so every K/V
// tile is read from device memory once per query tile rather than once
// per query row.  All threads read the same K/V element at the same time
// (a shared-memory broadcast), so the row-per-thread layout needs no
// cross-thread reduction.  The loop inside the block takes the place of
// the TPU's sequential key grid axis.  The products run on the CUDA
// cores in float32; mma/wgmma tensor-core products, TMA loads and a
// pipeline of tiles in flight are for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;      // query rows per block, one per thread
constexpr int kChunk = 16;   // keys per online-softmax update

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

template <int HD>
__host__ __device__ constexpr int tile_keys() {
  return HD >= 64 ? 4096 / HD : 64;  // K + V tiles: 32 KB of float32
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBQ)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
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
    qr[d] = valid ? to_float(q[q_off + d]) : 0.f;
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
        kx = to_float(k[off]);
        vx = to_float(v[off]);
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
    for (int d = 0; d < HD; ++d) out[q_off + d] = from_float<T>(acc[d] / denom);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int b,
              int sq, int sk, int n_q, int n_kv, int causal, int window,
              float scale, cudaStream_t stream) {
  const dim3 grid(b * n_q, (sq + kBQ - 1) / kBQ);
  flash_attention_kernel<T, HD><<<grid, kBQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, n_q, n_kv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int n_q, int n_kv, int hd, int causal, int window,
           float scale, void* stream) {
  // a window needs causal self-attention with sk >= sq, so that every row
  // sees at least its own key
  if (b <= 0 || sq <= 0 || sk <= 0 || n_kv <= 0 || n_q % n_kv != 0 ||
      (window > 0 && (!causal || sk < sq)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 8: return launch_hd<T, 8>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, scale, s);
    case 16: return launch_hd<T, 16>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, scale, s);
    case 32: return launch_hd<T, 32>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, scale, s);
    case 64: return launch_hd<T, 64>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, scale, s);
    case 128: return launch_hd<T, 128>(q, k, v, out, b, sq, sk, n_q, n_kv, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [b, sq, n_q, hd]; k/v [b, sk, n_kv, hd]; out [b, sq, n_q, hd], all
// contiguous.  window <= 0 means no window.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* out, int b,
                                       int sq, int sk, int n_q, int n_kv,
                                       int hd, int causal, int window,
                                       float scale, void* stream) {
  return launch<float>(q, k, v, out, b, sq, sk, n_q, n_kv, hd, causal, window,
                       scale, stream);
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* out, int b,
                                        int sq, int sk, int n_q, int n_kv,
                                        int hd, int causal, int window,
                                        float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, b, sq, sk, n_q, n_kv, hd, causal,
                               window, scale, stream);
}
