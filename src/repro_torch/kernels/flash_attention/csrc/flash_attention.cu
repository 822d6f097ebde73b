// Hand-written Hopper (sm_90a) flash attention forward (training / prefill).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention (_attn_kernel).
// It computes causal (or full) grouped-query attention
//   out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / g]) v[b, j, h / g]
// with query row i at position i + q_offset, keys j >= t masked (the padded
// tail), keys j > i + q_offset masked when causal, scores in f32, and the
// output in q's dtype. Inputs are f32 or bf16, all three of one dtype;
// everything inside is f32.
//
// Design. The TPU kernel walks the KV blocks as the sequential innermost
// grid axis and carries the running max, denominator and accumulator in
// VMEM scratch. Here one CTA of 256 threads owns one (batch, q head, tile
// of BQ query rows) and walks the KV tiles in a loop: the carried state
// stays in registers (accumulator) and shared memory (max, denominator).
// Per KV tile of BK keys the CTA stages K and V in shared memory as f32,
// computes the BQ x BK score tile with CUDA-core FMAs, runs the online
// softmax one warp per row, and adds P V to the accumulator. Thread
// (ty, tx) owns query rows ty*RM .. ty*RM+RM-1 and columns tx + 16*j.
// Masked scores take the finite sentinel -1e30 of kernel.py:22, not
// -inf, so a row whose first tile is fully masked computes
// exp(-1e30 - -1e30) = 1 instead of inf - inf; padded V rows are zero.
// Tiles wholly above the causal diagonal are skipped (kernel.py:43-45).
// The final row is acc / max(l, 1e-30).
//
// Two tilings: BQ = BK = 64 for head dims up to 128 (115 KB of shared
// memory at d = 128, one CTA per SM), BQ = BK = 32 for head dims up to 256.
// Head dims are multiples of 16 from 16 to 256; anything else is refused.
//
// What bounds it on this card: operations. The work is 2*b*h*s*t*d*2
// FLOPs, half of that when causal, against 2*b*(s*h + 2*t*kvh)*d*itemsize
// bytes. This first version runs on the CUDA cores in f32 (67 TFLOP/s),
// not on the tensor cores (wgmma, 989 TFLOP/s in bf16): its bound is the
// f32 FMA rate, and wgmma with TMA-fed K/V tiles is the next step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// (repro_torch/kernels/_build.py, ATTENTION_FLAGS). Each entry point is
// extern "C", launches on the caller's stream, allocates nothing and
// returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;    // kernel.py:22's finite sentinel
constexpr int kThreads = 256;        // 16 x 16 thread grid over a tile
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

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

// Shared memory in floats: Qs [BQ][d] (scaled), Ks [BK][d + 1] (padded so
// the 16 threads of a row read 16 banks), Vs [BK][d], Ss [BQ][BK], and the
// per-row running max, denominator and rescale factor.
size_t smem_bytes(int bq, int bk, int d) {
  return sizeof(float) * (static_cast<size_t>(bq) * d +
                          static_cast<size_t>(bk) * (d + 1) +
                          static_cast<size_t>(bk) * d +
                          static_cast<size_t>(bq) * bk + 3 * bq);
}

template <typename T, int BQ, int BK, int MAXC>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int s,
                           int t, int h, int kvh, int d, float scale,
                           int causal, int q_offset) {
  constexpr int RM = BQ / 16;   // query rows per thread
  constexpr int CN = BK / 16;   // score columns per thread
  extern __shared__ float smem[];
  const int dk = d + 1;
  float* Qs = smem;
  float* Ks = Qs + BQ * d;
  float* Vs = Ks + BK * dk;
  float* Ss = Vs + BK * d;
  float* row_m = Ss + BQ * BK;
  float* row_l = row_m + BQ;
  float* row_a = row_l + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvhi = hi / (h / kvh);
  const int nc = d >> 4;        // output columns per thread

  const size_t q_stride = static_cast<size_t>(h) * d;     // one q row
  const size_t kv_stride = static_cast<size_t>(kvh) * d;  // one k/v row
  const T* qb = q + (static_cast<size_t>(bi) * s * h + hi) * d;
  T* ob = o + (static_cast<size_t>(bi) * s * h + hi) * d;
  const T* kb = k + (static_cast<size_t>(bi) * t * kvh + kvhi) * d;
  const T* vb = v + (static_cast<size_t>(bi) * t * kvh + kvhi) * d;

  for (int idx = tid; idx < BQ * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    const int row = q0 + r;
    Qs[idx] = row < s ? to_f32(qb[row * q_stride + c]) * scale : 0.0f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    row_m[r] = kNegInf;
    row_l[r] = 0.0f;
  }

  float acc[RM][MAXC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < MAXC; ++j) acc[i][j] = 0.0f;

  int n_tiles = (t + BK - 1) / BK;
  if (causal) {
    // The last query position of this tile sees keys up to it; later
    // tiles are fully masked for every row of the tile.
    const int last = q0 + BQ - 1 + q_offset;
    n_tiles = min(n_tiles, last < 0 ? 0 : last / BK + 1);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's Ks, Vs and Ss are consumed
    for (int idx = tid; idx < BK * d; idx += kThreads) {
      const int r = idx / d;
      const int c = idx - r * d;
      const int key = k0 + r;
      const bool ok = key < t;
      Ks[r * dk + c] = ok ? to_f32(kb[key * kv_stride + c]) : 0.0f;
      Vs[idx] = ok ? to_f32(vb[key * kv_stride + c]) : 0.0f;
    }
    __syncthreads();

    float sc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.0f;
    for (int kk = 0; kk < d; ++kk) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = Qs[(ty * RM + i) * d + kk];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = Ks[(tx + 16 * j) * dk + kk];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) sc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
      const int q_pos = q0 + r + q_offset;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + 16 * j;
        const int key = k0 + c;
        const bool masked = key >= t || (causal && q_pos < key);
        Ss[r * BK + c] = masked ? kNegInf : sc[i][j];
      }
    }
    __syncthreads();

    // Online softmax, one warp per row.
    for (int r = warp; r < BQ; r += kThreads / 32) {
      float mx = kNegInf;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, Ss[r * BK + c]);
      mx = warp_max(mx);
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(Ss[r * BK + c] - m_new);
        Ss[r * BK + c] = p;
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

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float alpha = row_a[ty * RM + i];
#pragma unroll
      for (int jj = 0; jj < MAXC; ++jj) acc[i][jj] *= alpha;
    }
    for (int j = 0; j < BK; ++j) {
      float vv[MAXC];
#pragma unroll
      for (int jj = 0; jj < MAXC; ++jj)
        vv[jj] = jj < nc ? Vs[j * d + tx + 16 * jj] : 0.0f;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = Ss[(ty * RM + i) * BK + j];
#pragma unroll
        for (int jj = 0; jj < MAXC; ++jj) acc[i][jj] += p * vv[jj];
      }
    }
  }
  __syncthreads();   // row_l is final

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    const int row = q0 + r;
    if (row >= s) continue;
    const float l = fmaxf(row_l[r], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < MAXC; ++jj)
      if (jj < nc) ob[row * q_stride + tx + 16 * jj] = from_f32<T>(acc[i][jj] / l);
  }
}

template <typename T, int BQ, int BK, int MAXC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int s, int t, int h, int kvh, int d, float scale,
                   int causal, int q_offset, cudaStream_t stream) {
  const size_t smem = smem_bytes(BQ, BK, d);
  auto kern = flash_attention_kernel<T, BQ, BK, MAXC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, t, h, kvh, d, scale,
      causal, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int b, int s, int t, int h, int kvh, int d, float scale,
                     int causal, int q_offset, cudaStream_t stream) {
  if (d <= 128)
    return launch<T, 64, 64, 8>(q, k, v, o, b, s, t, h, kvh, d, scale,
                                causal, q_offset, stream);
  return launch<T, 32, 32, 16>(q, k, v, o, b, s, t, h, kvh, d, scale,
                               causal, q_offset, stream);
}

}  // namespace

extern "C" {

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q: [b, s, h, d]; k, v: [b, t, kvh, d]; o: [b, s, h, d]; all contiguous,
// of one dtype (0 = f32, 1 = bf16).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int b, int s, int t, int h, int kvh, int d,
                        float scale, int causal, int q_offset,
                        cudaStream_t stream) {
  if (d < 16 || d > 256 || d % 16 != 0 || kvh <= 0 || h % kvh != 0)
    return cudaErrorInvalidValue;
  if (b == 0 || s == 0 || h == 0) return cudaSuccess;
  if (dtype == kDtypeF32)
    return dispatch<float>(q, k, v, o, b, s, t, h, kvh, d, scale, causal,
                           q_offset, stream);
  if (dtype == kDtypeBF16)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, s, t, h, kvh, d, scale,
                                   causal, q_offset, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
