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
// What bounds it on this card. By the bytes bound, bytes: it reads x and
// dt and writes y (3 * b * s * inner elements; B, C, A, D and the states
// are small). That bound counts exp as one operation; the real floor is the
// issue rate of s * inner * n IEEE expf (each a MUFU.EX2 at 16 per clock
// per SM and a few FP32 operations) plus ~6 more operations per state and
// token: at jamba's widths (s = 2048, inner = 16384, n = 16) ~0.25-0.35 ms
// on 132 SMs, against 0.12 ms for the bytes.
//
// Design. What holds such a scan back is latency: each state is a chain
// of dependent operations over the tokens. The n states of a channel are
// split over LANES neighbouring lanes, lane l holding the states from
// l * ceil(16 / LANES) on (16 is the most a channel has; fewer states
// leave the last lanes short or empty) and their A in registers; a CTA of
// 128 threads owns 128 / LANES channels of one batch row and walks the
// whole sequence in a loop (which takes the place of the TPU's sequential
// grid axis), so at b = 1 and inner = 16384 the grid is 128 * LANES CTAs.
// The tokens come in chunks of CHUNK: x and dt [CHUNK x channels] and B
// and C [CHUNK x n] are staged in shared memory by 16-byte cp.async,
// coalesced and double-buffered (the next chunk is in flight while this
// one is computed); y goes out through a shared tile, coalesced. Whole
// chunks are unrolled so that the exponentials of later tokens overlap
// the state chains of earlier ones. The sequence is not split over CTAs:
// a carry pass would change h_last's rounding.
//
// Numerics. Built with -fmad=false and IEEE expf (no fast math), so each
// state's update is rounded as the plain version (ref.selective_scan_ref)
// rounds it, in its order: h_last is the plain version's bitwise. y is one
// fixed-order sum: each lane adds its own states in order, the LANES lane
// sums are combined by an __shfl_xor_sync butterfly (offsets 1, 2, ...;
// every lane of the group ends with the same bits, since the two operands
// of each add commute), then D * x is added. ref.selective_scan_lanes_ref
// is that order; y differs from selective_scan_ref only in it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared (repro_torch/kernels/_build.py, NVCC_FLAGS). The
// entry point is extern "C", launches on the caller's stream, allocates
// nothing and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Lanes per channel and tokens per staged chunk, chosen by
// scripts/sweep_kernels.py (LANES in {2, 4, 8, 16} x CHUNK in {16, 32} at
// jamba's widths, f32): on an H100 80GB HBM3 at 700 W, LANES = 2 and
// CHUNK = 32 were fastest at s = 2048, LANES = 4 within 8% (PERF.md).
constexpr int LANES = 2;
constexpr int CHUNK = 32;
constexpr int kThreads = 128;
constexpr int kMaxN = 16;                 // the most states a channel has
constexpr int kChannels = kThreads / LANES;   // channels per CTA
constexpr int kPerLane = (kMaxN + LANES - 1) / LANES;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

static_assert(32 % LANES == 0, "a channel's lanes lie in one warp");

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A lane's kPerLane consecutive values of a staged B or C row (its start
// is a multiple of kPerLane floats), in the widest loads that fit.
__device__ __forceinline__ void load_states(const float* p,
                                            float (&out)[kPerLane]) {
  if constexpr (kPerLane % 4 == 0) {
#pragma unroll
    for (int e = 0; e < kPerLane; e += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + e);
      out[e] = v.x;
      out[e + 1] = v.y;
      out[e + 2] = v.z;
      out[e + 3] = v.w;
    }
  } else if constexpr (kPerLane % 2 == 0) {
#pragma unroll
    for (int e = 0; e < kPerLane; e += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + e);
      out[e] = v.x;
      out[e + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) out[e] = p[e];
  }
}

template <typename T>
struct Stage {
  T x[CHUNK][kChannels];
  T dt[CHUNK][kChannels];
  float B[CHUNK][kMaxN];
  float C[CHUNK][kMaxN];
};

// Stage tokens t0 .. t0 + CHUNK - 1: x and dt for channels i0 .. i0 +
// kChannels - 1 and B, C; rows beyond s and channels beyond inner are
// zero-filled. vec: 16-byte copies (every row and pointer aligned for
// them); otherwise element loads, complete when the barrier passes.
template <typename T>
__device__ __forceinline__ void stage_chunk(
    Stage<T>& st, const T* __restrict__ xb, const T* __restrict__ dtb,
    const float* __restrict__ Bb, const float* __restrict__ Cb, int t0,
    int s, int inner, int n, int i0, bool vec, int tid) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    constexpr int UPR = kChannels / E;        // 16-byte units per row
    static_assert(kChannels % E == 0, "channel rows split into units");
    for (int u = tid; u < 2 * CHUNK * UPR; u += kThreads) {
      const int which = u / (CHUNK * UPR);
      const int rem = u - which * CHUNK * UPR;
      const int r = rem / UPR;
      const int c = (rem - r * UPR) * E;
      const bool ok = t0 + r < s && i0 + c < inner;
      const T* src = (which ? dtb : xb) +
                     (ok ? static_cast<size_t>(t0 + r) * inner + i0 + c : 0);
      cp_async16(which ? &st.dt[r][c] : &st.x[r][c], src, ok ? 16 : 0);
    }
    // B and C rows are n floats: whole chunks of them are contiguous.
    const int units = (CHUNK * n + 3) / 4;
    if (n % 4 == 0) {
      for (int u = tid; u < 2 * units; u += kThreads) {
        const int which = u / units;
        const int e = (u - which * units) * 4;   // element in the chunk
        const int r = e / n;
        const int q = e - r * n;
        const bool ok = t0 + r < s;
        const float* src = (which ? Cb : Bb) +
                           (ok ? static_cast<size_t>(t0 + r) * n + q : 0);
        cp_async16(which ? &st.C[r][q] : &st.B[r][q], src, ok ? 16 : 0);
      }
      return;
    }
  } else {
    for (int u = tid; u < CHUNK * kChannels; u += kThreads) {
      const int r = u / kChannels;
      const int c = u - r * kChannels;
      const bool ok = t0 + r < s && i0 + c < inner;
      const size_t off = static_cast<size_t>(t0 + r) * inner + i0 + c;
      st.x[r][c] = ok ? xb[off] : from_f32<T>(0.f);
      st.dt[r][c] = ok ? dtb[off] : from_f32<T>(0.f);
    }
  }
  for (int u = tid; u < CHUNK * n; u += kThreads) {
    const int r = u / n;
    const int q = u - r * n;
    const bool ok = t0 + r < s;
    const size_t off = static_cast<size_t>(t0 + r) * n + q;
    st.B[r][q] = ok ? Bb[off] : 0.f;
    st.C[r][q] = ok ? Cb[off] : 0.f;
  }
}

// FULL: n == kMaxN, every lane holds kPerLane states (no bound checks).
template <typename T, bool FULL>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ C, const float* __restrict__ D,
    const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ h_last, int s, int inner, int n, int vec) {
  __shared__ __align__(16) Stage<T> stage[2];
  __shared__ __align__(16) T ys[CHUNK][kChannels];
  const int tid = threadIdx.x;
  const int lane = tid % LANES;            // which states of the channel
  const int ch = tid / LANES;              // channel within the CTA
  const int i0 = blockIdx.x * kChannels;
  const int i = i0 + ch;
  const int bb = blockIdx.y;
  const bool active = i < inner;
  const size_t base = static_cast<size_t>(bb) * s * inner;
  const T* xb = x + base;
  const T* dtb = dt + base;
  T* yb = y + base;
  const float* Bb = B + static_cast<size_t>(bb) * s * n;
  const float* Cb = C + static_cast<size_t>(bb) * s * n;
  const int q0 = lane * kPerLane;          // this lane's first state
  const size_t state = (static_cast<size_t>(bb) * inner + i) * n;

  float a[kPerLane], h[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const bool in = active && q0 + j < n;
    a[j] = in ? A[static_cast<size_t>(i) * n + q0 + j] : 0.f;
    h[j] = (in && h0 != nullptr) ? h0[state + q0 + j] : 0.f;
  }
  const float d = active ? D[i] : 0.f;

  const int n_chunks = (s + CHUNK - 1) / CHUNK;
  stage_chunk(stage[0], xb, dtb, Bb, Cb, 0, s, inner, n, i0, vec, tid);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * CHUNK;
    // The next chunk lands in the other buffer while this one is used.
    if (c + 1 < n_chunks)
      stage_chunk(stage[(c + 1) & 1], xb, dtb, Bb, Cb, t0 + CHUNK, s, inner,
                  n, i0, vec, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Stage<T>& st = stage[c & 1];
    const int steps = min(CHUNK, s - t0);
    // One token of this thread's states, and y through the lanes.
    auto token = [&](int j) {
      const float xt = to_f32(st.x[j][ch]);
      const float dtt = to_f32(st.dt[j][ch]);
      const float dtx = dtt * xt;
      float bq[kPerLane], cq[kPerLane];
      load_states(&st.B[j][q0], bq);
      load_states(&st.C[j][q0], cq);
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        if (FULL || q0 + e < n) {
          const float da = expf(dtt * a[e]);
          h[e] = da * h[e] + dtx * bq[e];
          acc = acc + h[e] * cq[e];
        }
      }
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1)
        acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) ys[j][ch] = from_f32<T>(acc + d * xt);
    };
    // Whole chunks unrolled, so the exponentials of later tokens overlap
    // the state chain of earlier ones.
    if (steps == CHUNK) {
#pragma unroll 8
      for (int j = 0; j < CHUNK; ++j) token(j);
    } else {
      for (int j = 0; j < steps; ++j) token(j);
    }
    __syncthreads();   // ys is complete; stage[c & 1] is read no more
    // y out of the shared tile: neighbouring threads, neighbouring channels.
    for (int u = tid; u < steps * kChannels; u += kThreads) {
      const int r = u / kChannels;
      const int cc = u - r * kChannels;
      if (i0 + cc < inner)
        yb[static_cast<size_t>(t0 + r) * inner + i0 + cc] = ys[r][cc];
    }
  }
  cp_async_wait<0>();

  if (active) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (q0 + j < n) h_last[state + q0 + j] = h[j];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const float* B, const float* C, const float* D,
                   const float* h0, void* y, float* h_last, int b, int s,
                   int inner, int n, cudaStream_t stream) {
  // 16-byte copies need every x / dt row, the channel blocks and the
  // pointers aligned to 16 bytes (B and C rows too, or they go by element).
  const bool vec =
      (static_cast<size_t>(inner) * sizeof(T)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dt) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(C) % 16 == 0;
  const dim3 grid((inner + kChannels - 1) / kChannels, b);
  auto kern = n == kMaxN ? selective_scan_kernel<T, true>
                         : selective_scan_kernel<T, false>;
  kern<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A, B, C, D, h0,
      static_cast<T*>(y), h_last, s, inner, n, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The lanes a channel's states are split over, and the tokens per chunk.
void selective_scan_plan(int* out) {
  out[0] = LANES;
  out[1] = CHUNK;
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
