// Hand-written Hopper (sm_90a) selective scan (Mamba's S6 recurrence),
// the prefill of every Mamba layer.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/selective_scan/kernel.py:selective_scan (_scan_kernel).
// Per (batch, inner channel i) it runs, over the tokens t in order,
//   h_t[n] = exp(dt_t * A[i, n]) * h_{t-1}[n] + (dt_t * x_t) * B_t[n]
//   y_t    = sum_n h_t[n] * C_t[n] + D[i] * x_t
// from h_0 = h0 (zeros when none is given), and returns y [b, s, inner] in
// x's dtype and the last state h_last [b, inner, n] in f32. x and dt are
// f32 or bf16 (one dtype for both); A, B, C, D and h0 are f32 (the wrapper
// casts B and C, which is exact); everything inside is f32.
//
// Design. The TPU kernel tiles inner over its grid and walks the sequence
// chunks as the innermost, sequential grid axis, carrying the state
// [block_i, n] in VMEM. Here the state never leaves registers: one thread
// owns one (batch, channel) and holds its h[n] and A[i, n] (n <= 16) in
// registers, and a CTA of 128 threads (128 neighbouring channels of one
// batch row) walks the whole sequence in a loop, which takes the place of
// the TPU's sequential grid axis. The tokens come in chunks of kChunk: a
// thread keeps its own channel's x and dt for the chunk in registers
// (a warp's loads of one token are 32 neighbouring elements, coalesced),
// and B_t and C_t, shared by the CTA's channels, are staged in shared
// memory. The next chunk's loads are issued before the current chunk is
// computed (registers for x and dt, a second shared buffer for B and C),
// so their latency hides behind the chunk's arithmetic.
//
// Numerics. Built with -fmad=false and IEEE expf (no fast math), so each
// product and sum is rounded as the plain version (ref.selective_scan_ref)
// rounds it, in its order: the state update is the plain version's
// bitwise, and y differs only in the order of the sum over n.
//
// What bounds it on this card: bytes. The function reads x and dt and
// writes y (3 * b * s * inner elements; B, C, A, D and the states are
// small), about 7 operations per (t, i, n) against 12 bytes per (t, i) in
// f32: 16 * 7 / 12 = 9.3 operations per byte, below the f32 CUDA cores'
// 67e12 / 3.35e12 = 20. At b = 1 and jamba's inner = 16384 the grid is
// 128 CTAs of 128 threads on 132 SMs: one thin wave of one warp per
// scheduler, whose 16 independent state chains are all the latency hiding
// there is. Splitting the n states over lanes (more threads per channel,
// a shuffle sum for y), or several CTAs per channel block over sequence
// chunks with a second pass that carries the states, are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared (repro_torch/kernels/_build.py, NVCC_FLAGS). The
// entry point is extern "C", launches on the caller's stream, allocates
// nothing and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;   // channels per CTA, one thread each
constexpr int kChunk = 16;      // tokens per staged chunk
constexpr int kMaxN = 16;       // the most states a thread holds
constexpr int kPer = kChunk * kMaxN / kThreads;  // B (and C) loads a thread
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

static_assert(kChunk * kMaxN % kThreads == 0, "B/C chunk splits evenly");

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

// This thread's x and dt for tokens t0 .. t0 + kChunk - 1 (kept in x's
// dtype, converted where they are used, so no load is waited on here), and
// its kPer elements of B and C for them (element e = tid + k * kThreads is
// token e / kMaxN, state e % kMaxN).
template <typename T>
__device__ __forceinline__ void load_chunk(
    const T* __restrict__ xb, const T* __restrict__ dtb,
    const float* __restrict__ Bb, const float* __restrict__ Cb, int t0, int s,
    int n, size_t row, bool active, int tid, T (&xr)[kChunk],
    T (&dr)[kChunk], float (&bp)[kPer], float (&cp)[kPer]) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int t = t0 + j;
    const bool in = active && t < s;
    xr[j] = in ? xb[static_cast<size_t>(t) * row] : from_f32<T>(0.f);
    dr[j] = in ? dtb[static_cast<size_t>(t) * row] : from_f32<T>(0.f);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    const int t = t0 + e / kMaxN;
    const int q = e % kMaxN;
    const bool in = t < s && q < n;
    const size_t off = static_cast<size_t>(t) * n + q;
    bp[k] = in ? Bb[off] : 0.f;
    cp[k] = in ? Cb[off] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ C, const float* __restrict__ D,
    const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ h_last, int s, int inner, int n) {
  __shared__ float Bs[2][kChunk][kMaxN];
  __shared__ float Cs[2][kChunk][kMaxN];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const int bb = blockIdx.y;
  const bool active = i < inner;
  const size_t row = static_cast<size_t>(inner);
  const size_t base = static_cast<size_t>(bb) * s * row + (active ? i : 0);
  const T* xb = x + base;
  const T* dtb = dt + base;
  T* yb = y + base;
  const float* Bb = B + static_cast<size_t>(bb) * s * n;
  const float* Cb = C + static_cast<size_t>(bb) * s * n;
  const size_t state = (static_cast<size_t>(bb) * inner + i) * n;

  float a[kMaxN], h[kMaxN];
#pragma unroll
  for (int q = 0; q < kMaxN; ++q) {
    const bool in = active && q < n;
    a[q] = in ? A[static_cast<size_t>(i) * n + q] : 0.f;
    h[q] = (in && h0 != nullptr) ? h0[state + q] : 0.f;
  }
  const float d = active ? D[i] : 0.f;

  T xc[kChunk], dc[kChunk], xn[kChunk], dn[kChunk];
  float bp[kPer], cp[kPer];
  load_chunk(xb, dtb, Bb, Cb, 0, s, n, row, active, tid, xc, dc, bp, cp);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    Bs[0][e / kMaxN][e % kMaxN] = bp[k];
    Cs[0][e / kMaxN][e % kMaxN] = cp[k];
  }
  __syncthreads();

  int buf = 0;
  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int t1 = t0 + kChunk;
    const bool more = t1 < s;
    if (more)   // in flight while this chunk is computed
      load_chunk(xb, dtb, Bb, Cb, t1, s, n, row, active, tid, xn, dn, bp,
                 cp);
    const int steps = min(kChunk, s - t0);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < steps) {
        const float xt = to_f32(xc[j]);
        const float dtt = to_f32(dc[j]);
        const float dtx = dtt * xt;
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < kMaxN; ++q) {
          if (q < n) {
            const float da = expf(dtt * a[q]);
            h[q] = da * h[q] + dtx * Bs[buf][j][q];
            acc = acc + h[q] * Cs[buf][j][q];
          }
        }
        if (active)
          yb[static_cast<size_t>(t0 + j) * row] = from_f32<T>(acc + d * xt);
      }
    }
    if (more) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = tid + k * kThreads;
        Bs[buf ^ 1][e / kMaxN][e % kMaxN] = bp[k];
        Cs[buf ^ 1][e / kMaxN][e % kMaxN] = cp[k];
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        xc[j] = xn[j];
        dc[j] = dn[j];
      }
    }
    __syncthreads();   // buf is read no more; buf ^ 1 is written
    buf ^= 1;
  }

  if (active) {
#pragma unroll
    for (int q = 0; q < kMaxN; ++q)
      if (q < n) h_last[state + q] = h[q];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const float* B, const float* C, const float* D,
                   const float* h0, void* y, float* h_last, int b, int s,
                   int inner, int n, cudaStream_t stream) {
  const dim3 grid((inner + kThreads - 1) / kThreads, b);
  selective_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A, B, C, D, h0,
      static_cast<T*>(y), h_last, s, inner, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, dt, y: [b, s, inner] of one dtype (0 = f32, 1 = bf16); A: [inner, n];
// B, C: [b, s, n]; D: [inner]; h0 (may be null), h_last: [b, inner, n]; all
// f32 but x, dt and y, all contiguous.
int selective_scan_fwd(const void* x, const void* dt, const float* A,
                       const float* B, const float* C, const float* D,
                       const float* h0, void* y, float* h_last, int dtype,
                       int b, int s, int inner, int n, cudaStream_t stream) {
  if (b < 0 || b > 65535 || s < 0 || inner < 0 || n < 1 || n > kMaxN)
    return cudaErrorInvalidValue;
  if (b == 0 || inner == 0) return cudaSuccess;
  if (dtype == kDtypeF32)
    return launch<float>(x, dt, A, B, C, D, h0, y, h_last, b, s, inner, n,
                         stream);
  if (dtype == kDtypeBF16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, D, h0, y, h_last, b, s,
                                 inner, n, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
