// Hand-written Hopper (sm_90a) flash decode: one query token per sequence
// against its KV cache.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py:flash_decode (_decode_kernel).
// For sequence b and q head h it computes
//   out[b, h] = softmax_j(d^-1/2 * q[b, h] . k[b, j, h / g]) v[b, j, h / g]
// over the keys j < kv_len[b], in f32, with the output in q's dtype. A
// sequence with kv_len = 0 gives zeros (no block runs, and the denominator
// is clamped at 1e-30), as the TPU kernel does.
//
// Design. As in kernel.py:3-8, all g = h / kvh q heads of one KV group are
// processed together, so each cache tile is read from device memory once:
// one CTA of 256 threads owns one (sequence, KV head), keeps the group's g
// query rows, running max, denominator and [g, d] accumulator in shared
// memory, and walks the cache in tiles of BK rows up to kv_len. Tiles at
// or beyond kv_len are never loaded; rows of the last tile at or beyond
// kv_len are masked with the finite sentinel -1e30 and their V rows zeroed.
// BK is 128, or 64 / 32 / 16 where g and d need the shared memory.
//
// What bounds it on this card: bytes. The cache rows it must read are
// b * kv_len * kvh * d * 2 * itemsize (K and V), against 4*b*h*kv_len*d
// FLOPs: one FLOP per byte in f32, far below the card's ratio. One CTA per
// (sequence, KV head) puts b * kvh CTAs on the 132 SMs (16 for 8 lanes of
// qwen2.5-3b), so a decode step reads the cache from a few SMs only: a
// split over the cache axis (flash-decoding) is the next step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// (repro_torch/kernels/_build.py, ATTENTION_FLAGS). The entry point is
// extern "C", launches on the caller's stream, allocates nothing and
// returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;    // kernel.py:17's finite sentinel
constexpr int kThreads = 256;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Shared memory in floats: Qs [g][d] (scaled), Ks [bk][d + 1], Vs [bk][d],
// Ss [g][bk], acc [g][d], and the per-row max, denominator and rescale.
size_t smem_bytes(int g, int bk, int d) {
  return sizeof(float) * (static_cast<size_t>(g) * d +
                          static_cast<size_t>(bk) * (d + 1) +
                          static_cast<size_t>(bk) * d +
                          static_cast<size_t>(g) * bk +
                          static_cast<size_t>(g) * d + 3 * g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ kv_len, T* __restrict__ o,
                        int t, int h, int kvh, int d, int bk, float scale) {
  extern __shared__ float smem[];
  const int g = h / kvh;
  const int dk = d + 1;
  float* Qs = smem;
  float* Ks = Qs + g * d;
  float* Vs = Ks + bk * dk;
  float* Ss = Vs + bk * d;
  float* acc = Ss + g * bk;
  float* row_m = acc + g * d;
  float* row_l = row_m + g;
  float* row_a = row_l + g;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kvhi = blockIdx.x;
  const int bi = blockIdx.y;
  const int len = min(max(kv_len[bi], 0), t);

  // q[bi, kvhi*g + gi, :] for gi < g: one contiguous run of g*d values.
  const T* qb = q + (static_cast<size_t>(bi) * h + kvhi * g) * d;
  T* ob = o + (static_cast<size_t>(bi) * h + kvhi * g) * d;
  const size_t kv_stride = static_cast<size_t>(kvh) * d;
  const T* kb = kc + (static_cast<size_t>(bi) * t * kvh + kvhi) * d;
  const T* vb = vc + (static_cast<size_t>(bi) * t * kvh + kvhi) * d;

  for (int idx = tid; idx < g * d; idx += kThreads) {
    Qs[idx] = to_f32(qb[idx]) * scale;
    acc[idx] = 0.0f;
  }
  for (int r = tid; r < g; r += kThreads) {
    row_m[r] = kNegInf;
    row_l[r] = 0.0f;
  }

  for (int k0 = 0; k0 < len; k0 += bk) {
    __syncthreads();   // the previous tile's Ks, Vs, Ss and acc are done
    for (int idx = tid; idx < bk * d; idx += kThreads) {
      const int r = idx / d;
      const int c = idx - r * d;
      const int key = k0 + r;
      const bool ok = key < len;
      Ks[r * dk + c] = ok ? to_f32(kb[key * kv_stride + c]) : 0.0f;
      Vs[idx] = ok ? to_f32(vb[key * kv_stride + c]) : 0.0f;
    }
    __syncthreads();

    for (int idx = tid; idx < g * bk; idx += kThreads) {
      const int gi = idx / bk;
      const int j = idx - gi * bk;
      const float* qr = Qs + gi * d;
      const float* kr = Ks + j * dk;
      float dot = 0.0f;
      for (int c = 0; c < d; ++c) dot += qr[c] * kr[c];
      Ss[idx] = k0 + j < len ? dot : kNegInf;
    }
    __syncthreads();

    // Online softmax, one warp per q head of the group.
    for (int r = warp; r < g; r += kThreads / 32) {
      float mx = kNegInf;
      for (int c = lane; c < bk; c += 32) mx = fmaxf(mx, Ss[r * bk + c]);
      mx = warp_max(mx);
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = lane; c < bk; c += 32) {
        const float p = expf(Ss[r * bk + c] - m_new);
        Ss[r * bk + c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V; each thread owns the same acc entries
    // on every tile.
    for (int idx = tid; idx < g * d; idx += kThreads) {
      const int gi = idx / d;
      const int c = idx - gi * d;
      const float* pr = Ss + gi * bk;
      float pv = 0.0f;
      for (int j = 0; j < bk; ++j) pv += pr[j] * Vs[j * d + c];
      acc[idx] = acc[idx] * row_a[gi] + pv;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < g * d; idx += kThreads) {
    const float l = fmaxf(row_l[idx / d], 1e-30f);
    ob[idx] = from_f32<T>(acc[idx] / l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* kv_len, void* o, int b, int t, int h, int kvh,
                   int d, float scale, cudaStream_t stream) {
  const int g = h / kvh;
  int bk = 128;
  while (bk > 16 && smem_bytes(g, bk, d) > kMaxSmem) bk >>= 1;
  const size_t smem = smem_bytes(g, bk, d);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = flash_decode_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<dim3(kvh, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), kv_len, static_cast<T*>(o), t, h, kvh, d,
      bk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q: [b, h, d]; k_cache, v_cache: [b, t, kvh, d]; kv_len: int32 [b];
// o: [b, h, d]; all contiguous, q and the caches of one dtype
// (0 = f32, 1 = bf16); scale is d^-1/2 as the wrapper rounds it.
int flash_decode_fwd(const void* q, const void* kc, const void* vc,
                     const int* kv_len, void* o, int dtype, int b, int t,
                     int h, int kvh, int d, float scale,
                     cudaStream_t stream) {
  if (d < 16 || d > 256 || d % 16 != 0 || kvh <= 0 || h % kvh != 0)
    return cudaErrorInvalidValue;
  if (b == 0 || h == 0) return cudaSuccess;
  if (dtype == kDtypeF32)
    return launch<float>(q, kc, vc, kv_len, o, b, t, h, kvh, d, scale,
                         stream);
  if (dtype == kDtypeBF16)
    return launch<__nv_bfloat16>(q, kc, vc, kv_len, o, b, t, h, kvh, d,
                                 scale, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
