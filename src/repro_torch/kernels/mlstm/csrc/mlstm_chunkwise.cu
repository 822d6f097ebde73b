// Hand-written Hopper (sm_90a) chunkwise mLSTM forward (prefill).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/mlstm/kernel.py:mlstm_chunkwise (_mlstm_kernel_impl).
// Per (batch, head) it computes the xLSTM matrix-memory cell in its
// parallel form
//   D[t, s] = F_t - F_s + logi_s  (s <= t),   m_t = max_s D[t, s]
//   S[t, s] = (scale * q_t . k_s) * exp(D[t, s] - m_t)
//   h_t = sum_s S[t, s] v_s / max(|sum_s S[t, s]|, exp(-m_t))
// with F = cumsum(logsigmoid(f)) and logi = i precomputed in f32 by the
// wrapper, as kernel.py:90 does outside its kernel. q, k, v are f32 or
// bf16, one dtype for all three; everything inside is f32 and the output
// is written in q's dtype.
//
// Design. The TPU kernel walks the KV blocks as the sequential innermost
// grid axis and carries the running max m, the signed denominator and a
// [block_q, d] accumulator in VMEM; at xLSTM-1.3B's head dim d = 1024 one
// such accumulator and the q/k/v tiles are 512 KB each, more than a CTA's
// 227 KB of shared memory. Here one CTA of 256 threads owns one (batch,
// head, tile of BQ = 64 query rows, slice of DV value columns) and walks
// the KV tiles of BK = 64 keys in a loop, carrying m and the denominator in
// shared memory and the [BQ, DV] accumulator in registers (thread (ty, tx)
// owns rows ty*4 .. ty*4+3 and columns tx + 16*j of the slice). Per KV
// tile the BQ x BK scores are accumulated over d in chunks of DC = 32
// columns staged through shared memory (the next chunk is loaded into
// registers while the current one is multiplied), so every value slice
// recomputes the scores: at d = 1024 there are four slices of 256
// columns. Then one warp per row forms the decay, the running max
// m_new = max(m, max_s D), alpha = exp(m - m_new), the decayed scores and
// den = den * alpha + sum S, and the accumulator takes acc * alpha + S V.
// Numerics are those of kernel.py:23-75: masked decays take the finite
// sentinel -1e30 (the first tile's alpha = exp(-1e30 - m_new) is 0, not
// nan), tiles above the causal diagonal are skipped, rows and keys beyond
// s are masked and padded V rows are zero, and only |den| is clamped at
// exp(-m), after the last tile.
//
// What bounds it on this card: operations. The function needs
// 4*b*h*d*s(s+1)/2 FLOPs (q.k and S.v over the causal triangle) against
// (3*d + 2) * b*s*h elements read and d * b*s*h written. This first
// version runs on the CUDA cores in f32 (67 TFLOP/s), and recomputes the
// scores once per value slice (4x at d = 1024, which makes it 2.5x the
// function's operations); wgmma with TMA-fed tiles, and scores kept for
// all slices, are the next steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// (repro_torch/kernels/_build.py, ATTENTION_FLAGS: held to a tolerance,
// FMA contraction allowed). The entry point is extern "C", launches on the
// caller's stream, allocates nothing and returns the cudaError_t of the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;    // kernel.py:20's finite sentinel
constexpr int kThreads = 256;        // 16 x 16 thread grid over a tile
constexpr int BQ = 64;               // query rows per CTA
constexpr int BK = 64;               // keys per KV tile
constexpr int DC = 32;               // score columns per staged chunk
constexpr int RM = BQ / 16;          // query rows per thread
constexpr int CN = BK / 16;          // score columns per thread
constexpr int PER = BQ * DC / kThreads;  // chunk elements per thread
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

static_assert(BQ == BK, "the causal tile count assumes square tiles");
static_assert(BK * DC / kThreads == PER, "q and k chunks split alike");

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

// Shared memory in floats: Qs [BQ][QS] (scaled), Ks [BK][QS], Vs [BK][DV],
// Ss [BQ][SS], the per-row max, denominator, rescale factor and F_t, and
// the per-key F_s and logi_s. The row strides QS = DC + 1 and SS = BK + 1
// put the rows that one warp reads in distinct banks.
constexpr int QS = DC + 1;
constexpr int SS = BK + 1;

size_t smem_bytes(int dv) {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * QS + static_cast<size_t>(BK) * QS +
          static_cast<size_t>(BK) * dv + static_cast<size_t>(BQ) * SS +
          4 * BQ + 2 * BK);
}

// Chunk element p of this thread: row idx / DC, column idx % DC, so a warp
// reads 32 consecutive columns of one row.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ base,
                                           size_t row_stride, int row0,
                                           int col0, int s, int d, int tid,
                                           float scale, float (&out)[PER]) {
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int idx = tid + p * kThreads;
    const int r = idx / DC;
    const int c = idx - r * DC;
    const int row = row0 + r;
    const int col = col0 + c;
    out[p] = (row < s && col < d)
                 ? to_f32(base[row * row_stride + col]) * scale
                 : 0.0f;
  }
}

template <typename T, int MAXC>
__global__ void __launch_bounds__(kThreads)
    mlstm_chunkwise_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ cum_f,
                           const float* __restrict__ logi,
                           T* __restrict__ o, int s, int h, int d,
                           float scale) {
  constexpr int DV = 16 * MAXC;   // value columns per CTA
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ss = Vs + BK * DV;
  float* row_m = Ss + BQ * SS;
  float* row_den = row_m + BQ;
  float* row_a = row_den + BQ;
  float* Ft = row_a + BQ;
  float* Fs = Ft + BQ;
  float* Li = Fs + BK;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int v0 = blockIdx.x * DV;
  const int qi = gridDim.y - 1 - blockIdx.y;   // longest rows first
  const int q0 = qi * BQ;
  const int bi = blockIdx.z / h;
  const int hi = blockIdx.z - bi * h;
  const int nc = min(DV, d - v0) >> 4;         // output columns per thread

  const size_t row_stride = static_cast<size_t>(h) * d;   // one token
  const size_t head = (static_cast<size_t>(bi) * s * h + hi) * d;
  const T* qb = q + head;
  const T* kb = k + head;
  const T* vb = v + head;
  T* ob = o + head;
  const float* fb = cum_f + static_cast<size_t>(bi) * s * h + hi;
  const float* lb = logi + static_cast<size_t>(bi) * s * h + hi;

  for (int r = tid; r < BQ; r += kThreads) {
    row_m[r] = kNegInf;
    row_den[r] = 0.0f;
    Ft[r] = q0 + r < s ? fb[static_cast<size_t>(q0 + r) * h] : 0.0f;
  }

  float acc[RM][MAXC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < MAXC; ++j) acc[i][j] = 0.0f;

  const int n_chunks = (d + DC - 1) / DC;
  // Causal: KV tiles 0..qi hold every key a row of this tile sees.
  for (int kt = 0; kt <= qi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's Vs, Ss, Fs and Li are consumed
    for (int idx = tid; idx < BK * DV; idx += kThreads) {
      const int r = idx / DV;
      const int c = idx - r * DV;
      const int key = k0 + r;
      const int col = v0 + c;
      Vs[idx] = (key < s && col < d) ? to_f32(vb[key * row_stride + col])
                                     : 0.0f;
    }
    for (int r = tid; r < BK; r += kThreads) {
      const int key = k0 + r;
      Fs[r] = key < s ? fb[static_cast<size_t>(key) * h] : 0.0f;
      Li[r] = key < s ? lb[static_cast<size_t>(key) * h] : 0.0f;
    }

    // Scores (scale * q) . k over d, chunk by chunk.
    float sc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.0f;
    float qr[PER], kr[PER];
    load_chunk(qb, row_stride, q0, 0, s, d, tid, scale, qr);
    load_chunk(kb, row_stride, k0, 0, s, d, tid, 1.0f, kr);
    for (int ch = 0; ch < n_chunks; ++ch) {
      __syncthreads();   // the previous chunk is consumed
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int idx = tid + p * kThreads;
        const int r = idx / DC;
        const int c = idx - r * DC;
        Qs[r * QS + c] = qr[p];
        Ks[r * QS + c] = kr[p];
      }
      __syncthreads();
      if (ch + 1 < n_chunks) {
        load_chunk(qb, row_stride, q0, (ch + 1) * DC, s, d, tid, scale, qr);
        load_chunk(kb, row_stride, k0, (ch + 1) * DC, s, d, tid, 1.0f, kr);
      }
#pragma unroll 8
      for (int kk = 0; kk < DC; ++kk) {
        float qv[RM], kv[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) qv[i] = Qs[(ty * RM + i) * QS + kk];
#pragma unroll
        for (int j = 0; j < CN; ++j) kv[j] = Ks[(tx + 16 * j) * QS + kk];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) sc[i][j] += qv[i] * kv[j];
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        Ss[(ty * RM + i) * SS + tx + 16 * j] = sc[i][j];
    __syncthreads();

    // Decay, running max and signed denominator, one warp per row.
    for (int r = warp; r < BQ; r += kThreads / 32) {
      const int q_pos = q0 + r;
      const float ft = Ft[r];
      float dt[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int c = lane + 32 * u;
        const int key = k0 + c;
        dt[u] = (key <= q_pos && key < s) ? ft - Fs[c] + Li[c] : kNegInf;
        mx = fmaxf(mx, dt[u]);
      }
      mx = warp_max(mx);
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int c = lane + 32 * u;
        const float p = Ss[r * SS + c] * expf(dt[u] - m_new);
        Ss[r * SS + c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        row_a[r] = alpha;
        row_den[r] = row_den[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + S V
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
        vv[jj] = jj < nc ? Vs[j * DV + tx + 16 * jj] : 0.0f;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = Ss[(ty * RM + i) * SS + j];
#pragma unroll
        for (int jj = 0; jj < MAXC; ++jj) acc[i][jj] += p * vv[jj];
      }
    }
  }
  __syncthreads();   // row_m and row_den are final

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    const int row = q0 + r;
    if (row >= s) continue;
    const float den = fmaxf(fabsf(row_den[r]), expf(-row_m[r]));
#pragma unroll
    for (int jj = 0; jj < MAXC; ++jj)
      if (jj < nc)
        ob[row * row_stride + v0 + tx + 16 * jj] =
            from_f32<T>(acc[i][jj] / den);
  }
}

template <typename T, int MAXC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* cum_f, const float* logi, void* o, int b,
                   int s, int h, int d, float scale, cudaStream_t stream) {
  constexpr int DV = 16 * MAXC;
  const size_t smem = smem_bytes(DV);
  auto kern = mlstm_chunkwise_kernel<T, MAXC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((d + DV - 1) / DV, (s + BQ - 1) / BQ, b * h);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cum_f, logi, static_cast<T*>(o), s, h, d,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* cum_f, const float* logi, void* o, int b,
                     int s, int h, int d, float scale, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 2>(q, k, v, cum_f, logi, o, b, s, h, d, scale, stream);
  if (d <= 64)
    return launch<T, 4>(q, k, v, cum_f, logi, o, b, s, h, d, scale, stream);
  if (d <= 128)
    return launch<T, 8>(q, k, v, cum_f, logi, o, b, s, h, d, scale, stream);
  return launch<T, 16>(q, k, v, cum_f, logi, o, b, s, h, d, scale, stream);
}

}  // namespace

extern "C" {

const char* mlstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, o: [b, s, h, d] of one dtype (0 = f32, 1 = bf16); cum_f, logi:
// [b, s, h] f32; all contiguous.
int mlstm_chunkwise_fwd(const void* q, const void* k, const void* v,
                        const float* cum_f, const float* logi, void* o,
                        int dtype, int b, int s, int h, int d, float scale,
                        cudaStream_t stream) {
  if (d < 16 || d > 4096 || d % 16 != 0 || b < 0 || s < 0 || h < 0 ||
      b * h > 65535)
    return cudaErrorInvalidValue;
  if (b == 0 || s == 0 || h == 0) return cudaSuccess;
  if (dtype == kDtypeF32)
    return dispatch<float>(q, k, v, cum_f, logi, o, b, s, h, d, scale,
                           stream);
  if (dtype == kDtypeBF16)
    return dispatch<__nv_bfloat16>(q, k, v, cum_f, logi, o, b, s, h, d,
                                   scale, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
