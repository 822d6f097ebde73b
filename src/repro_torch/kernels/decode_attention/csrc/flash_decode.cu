// Hand-written Hopper (sm_90a) flash decode: one query token per sequence
// against its KV cache, split over the cache axis (flash-decoding).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py:flash_decode (_decode_kernel).
// For sequence b and q head h it computes
//   out[b, h] = softmax_j(d^-1/2 * q[b, h] . k[b, j, h / g]) v[b, j, h / g]
// over the keys j < kv_len[b], in f32, with the output in q's dtype. A
// sequence with kv_len = 0 gives zeros, as the TPU kernel does.
//
// What bounds it on this card: bytes. The cache rows it must read are
// b * kv_len * kvh * d * 2 * itemsize (K and V) against 4 * b * h * kv_len
// * d FLOPs: with g = h / kvh = 8 q heads per KV row, about 4 FLOPs per f32
// byte, far below the card's ratio. So the only way to go faster is to
// read the cache rows from many SMs at once.
//
// Design. Two launches.
//  1. Split pass, grid (kvh, b, n_split). Split i of a (sequence, KV head)
//     owns cache rows [i * chunk, (i + 1) * chunk); the host picks n_split
//     and chunk from t, b, kvh and the SM count alone (kernel.py
//     split_plan), never from kv_len, so the launch shape is fixed for a
//     given cache. A split that starts at or beyond kv_len writes the empty
//     partial (m = -1e30, l = 0) and returns without reading the cache.
//     Otherwise 256 threads keep the group's g query rows (scaled, f32) in
//     shared memory, so each KV row is read once for all g heads, and walk
//     the split in tiles of TILE = 32 rows through a double-buffered ring
//     fed by 16-byte cp.async copies: the next tile is in flight while the
//     current one is used. Rows at or beyond the split's end are zero-filled
//     by the copy and their scores masked with the finite sentinel -1e30.
//     Scores: each warp takes 4 keys, 8 lanes per key splitting d, and a
//     3-step shuffle reduction per q row. Online softmax: one warp per q
//     row, one lane per key. P.V: each thread owns one pair of output
//     columns for up to MAXR q rows, with the accumulator in registers;
//     a group larger than the rows the threads hold runs in passes over
//     the split. Each split writes its partial (acc[d], m, l) in f32 to the
//     wrapper's workspace [b, h, n_split, d + 2].
//  2. Combine pass, grid (h, b): m* = max m_i, l = sum l_i e^{m_i - m*},
//     out = sum acc_i e^{m_i - m*} / max(l, 1e-30), in q's dtype. Empty
//     partials (l_i = 0) carry no weight, so kv_len = 0 gives zeros.
// The split changes the order of the sums against the plain version
// (ref.decode_ref), so the result is within the bars (2e-5 in f32, 5e-2 in
// bf16), not bitwise.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// (repro_torch/kernels/_build.py, ATTENTION_FLAGS). The entry points are
// extern "C", launch on the caller's stream, allocate nothing and return
// the cudaError_t of their launches: flash_decode_fwd runs both passes;
// flash_decode_split and flash_decode_combine run one each, for a cache
// whose rows are split over ranks (models/attention.py): each rank runs
// the split pass over its rows, the ranks exchange their partials, and
// the combine pass merges every rank's splits. The one-call entry and the
// two entries run the same kernels, so the two launches of one cache
// give bitwise the one-call result.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;    // kernel.py:17's finite sentinel
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TILE = 32;             // cache rows per stage
constexpr int kStages = 2;
constexpr int MAXR = 8;              // q rows per thread in P.V
constexpr int SLD = TILE + 4;        // row stride of the scores
constexpr int kCombineThreads = 128;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr size_t kMaxSmem = 227 * 1024;

static_assert(TILE == 32, "the softmax gives one lane to each key");
static_assert(kWarps * 4 == TILE, "each warp scores 4 keys of a tile");

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

// Two neighbouring elements as f32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0
// writes zeros and reads nothing.
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

// q rows held per pass: the P.V threads cover d / 2 column pairs, each
// thread MAXR rows.
int rows_per_pass(int g, int d) {
  const int groups = kThreads / (d / 2);
  return g < groups * MAXR ? g : groups * MAXR;
}

size_t smem_bytes(int gmax, int d, int ldk, int itemsize) {
  return static_cast<size_t>(2 * kStages * TILE) * ldk * itemsize +
         sizeof(float) * (static_cast<size_t>(gmax) * d +
                          static_cast<size_t>(gmax) * SLD + 3 * gmax);
}

template <typename T>
__device__ __forceinline__ void load_tile(T* Ks, T* Vs, const T* kb,
                                          const T* vb, size_t kv_stride,
                                          int key0, int key_end, int d,
                                          int ldk, int tid) {
  constexpr int E = 16 / sizeof(T);        // elements per 16 bytes
  const int upr = d / E;                   // 16-byte units per row
  for (int u = tid; u < TILE * upr; u += kThreads) {
    const int r = u / upr;
    const int c = (u - r * upr) * E;
    const int key = key0 + r;
    const bool ok = key < key_end;
    const size_t off = ok ? static_cast<size_t>(key) * kv_stride + c : 0;
    cp_async16(Ks + r * ldk + c, kb + off, ok ? 16 : 0);
    cp_async16(Vs + r * ldk + c, vb + off, ok ? 16 : 0);
  }
}

// MAXP: column pairs a lane holds in q.k, d / 16 at most (8 up to d =
// 128, which with the unpadded tiles fits three CTAs on an SM).
template <typename T, int MAXP>
__global__ void __launch_bounds__(kThreads, 3)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ kv_len,
                        float* __restrict__ ws, int t, int h, int kvh, int d,
                        int n_split, int chunk, int ldk, int gmax,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kStages * TILE * ldk;
  float* Qs = reinterpret_cast<float*>(Vs + kStages * TILE * ldk);
  float* Ss = Qs + gmax * d;
  float* row_m = Ss + gmax * SLD;
  float* row_l = row_m + gmax;
  float* row_a = row_l + gmax;

  const int g = h / kvh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kvhi = blockIdx.x;
  const int bi = blockIdx.y;
  const int split = blockIdx.z;
  const int len = min(max(kv_len[bi], 0), t);
  const int k_begin = split * chunk;
  const int k_end = min(len, k_begin + chunk);

  // Partial of q head kvhi*g + gi: ws[bi, kvhi*g + gi, split, :].
  const size_t ws_row = static_cast<size_t>(n_split) * (d + 2);
  float* wb = ws + (static_cast<size_t>(bi) * h + kvhi * g) * ws_row +
              static_cast<size_t>(split) * (d + 2);
  if (k_begin >= k_end) {      // the split starts at or beyond kv_len
    for (int gi = tid; gi < g; gi += kThreads) {
      wb[gi * ws_row + d] = kNegInf;
      wb[gi * ws_row + d + 1] = 0.0f;
    }
    return;
  }

  const T* qb = q + (static_cast<size_t>(bi) * h + kvhi * g) * d;
  const size_t kv_stride = static_cast<size_t>(kvh) * d;
  const T* kb = kc + (static_cast<size_t>(bi) * t * kvh + kvhi) * d;
  const T* vb = vc + (static_cast<size_t>(bi) * t * kvh + kvhi) * d;
  const int n_tiles = (k_end - k_begin + TILE - 1) / TILE;

  // q.k: warp w scores keys 4w .. 4w+3, lane sl of a key the column pairs
  // 2*sl + 16*i.
  const int key_local = warp * 4 + (lane >> 3);
  const int sl = lane & 7;
  const int np = d / 16;
  // P.V: thread (pair, group) owns columns 2*pair, 2*pair + 1 of q rows
  // group + groups * r.
  const int ncp = d / 2;
  const int groups = kThreads / ncp;
  const int pair = tid % ncp;
  const int grp = tid / ncp;
  const bool pv = grp < groups;

  for (int g0 = 0; g0 < g; g0 += gmax) {
    const int gr = min(gmax, g - g0);
    __syncthreads();           // the previous pass is done with the ring
    for (int idx = tid; idx < gr * d; idx += kThreads)
      Qs[idx] = to_f32(qb[g0 * d + idx]) * scale;
    for (int r = tid; r < gr; r += kThreads) {
      row_m[r] = kNegInf;
      row_l[r] = 0.0f;
    }
    float acc[MAXR][2];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[r][0] = acc[r][1] = 0.0f;

    load_tile(Ks, Vs, kb, vb, kv_stride, k_begin, k_end, d, ldk, tid);
    cp_async_commit();
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it & 1;
      if (it + 1 < n_tiles)
        load_tile(Ks + (st ^ 1) * TILE * ldk, Vs + (st ^ 1) * TILE * ldk,
                  kb, vb, kv_stride, k_begin + (it + 1) * TILE, k_end, d,
                  ldk, tid);
      cp_async_commit();
      cp_async_wait<1>();      // tile it has landed
      __syncthreads();
      const T* Kt = Ks + st * TILE * ldk;
      const T* Vt = Vs + st * TILE * ldk;
      const int key0 = k_begin + it * TILE;

      {
        float2 kv[MAXP];
        const T* kr = Kt + key_local * ldk + 2 * sl;
#pragma unroll
        for (int i = 0; i < MAXP; ++i)
          kv[i] = i < np ? load2(kr + 16 * i) : make_float2(0.0f, 0.0f);
        const bool valid = key0 + key_local < k_end;
        for (int gi = 0; gi < gr; ++gi) {
          const float* qr = Qs + gi * d + 2 * sl;
          float dot = 0.0f;
#pragma unroll
          for (int i = 0; i < MAXP; ++i) {
            if (i < np) {
              const float2 qq = load2(qr + 16 * i);
              dot += qq.x * kv[i].x + qq.y * kv[i].y;
            }
          }
          dot += __shfl_xor_sync(0xffffffffu, dot, 1);
          dot += __shfl_xor_sync(0xffffffffu, dot, 2);
          dot += __shfl_xor_sync(0xffffffffu, dot, 4);
          if (sl == 0) Ss[gi * SLD + key_local] = valid ? dot : kNegInf;
        }
      }
      __syncthreads();

      // Online softmax, one warp per q row, one lane per key.
      for (int gi = warp; gi < gr; gi += kWarps) {
        const float sv = Ss[gi * SLD + lane];
        const float m_prev = row_m[gi];
        const float m_new = fmaxf(m_prev, warp_max(sv));
        const float p = expf(sv - m_new);
        Ss[gi * SLD + lane] = p;
        const float sum = warp_sum(p);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          row_a[gi] = alpha;
          row_l[gi] = row_l[gi] * alpha + sum;
          row_m[gi] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + P V
      if (pv) {
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          const int gi = grp + groups * r;
          if (gi < gr) {
            const float a = row_a[gi];
            acc[r][0] *= a;
            acc[r][1] *= a;
          }
        }
        const T* vcol = Vt + 2 * pair;
#pragma unroll 2
        for (int j = 0; j < TILE; j += 4) {
          const float2 v0 = load2(vcol + (j + 0) * ldk);
          const float2 v1 = load2(vcol + (j + 1) * ldk);
          const float2 v2 = load2(vcol + (j + 2) * ldk);
          const float2 v3 = load2(vcol + (j + 3) * ldk);
#pragma unroll
          for (int r = 0; r < MAXR; ++r) {
            const int gi = grp + groups * r;
            if (gi < gr) {
              const float4 p =
                  *reinterpret_cast<const float4*>(Ss + gi * SLD + j);
              acc[r][0] += p.x * v0.x + p.y * v1.x + p.z * v2.x + p.w * v3.x;
              acc[r][1] += p.x * v0.y + p.y * v1.y + p.z * v2.y + p.w * v3.y;
            }
          }
        }
      }
      __syncthreads();         // the stage and the scores are free again
    }

    if (pv) {
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        const int gi = grp + groups * r;
        if (gi < gr)
          *reinterpret_cast<float2*>(wb + (g0 + gi) * ws_row + 2 * pair) =
              make_float2(acc[r][0], acc[r][1]);
      }
    }
    for (int gi = tid; gi < gr; gi += kThreads) {
      wb[(g0 + gi) * ws_row + d] = row_m[gi];
      wb[(g0 + gi) * ws_row + d + 1] = row_l[gi];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    flash_decode_combine_kernel(const float* __restrict__ ws,
                                T* __restrict__ o, int h, int d,
                                int n_split) {
  extern __shared__ float cs[];            // m [n_split], l, weight
  float* sm = cs;
  float* sl = sm + n_split;
  float* wgt = sl + n_split;
  const int head = blockIdx.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int stride = d + 2;
  const float* w = ws + (static_cast<size_t>(bi) * h + head) * n_split *
                            static_cast<size_t>(stride);
  for (int i = tid; i < n_split; i += kCombineThreads) {
    sm[i] = w[i * stride + d];
    sl[i] = w[i * stride + d + 1];
  }
  __syncthreads();
  float m_star = kNegInf;
  for (int i = 0; i < n_split; ++i)
    if (sl[i] > 0.0f) m_star = fmaxf(m_star, sm[i]);
  // An empty partial (l = 0) carries no weight and its acc is never read.
  for (int i = tid; i < n_split; i += kCombineThreads)
    wgt[i] = sl[i] > 0.0f ? expf(sm[i] - m_star) : 0.0f;
  __syncthreads();
  float l = 0.0f;
  for (int i = 0; i < n_split; ++i) l += sl[i] * wgt[i];
  const float inv_den = 1.0f / fmaxf(l, 1e-30f);
  T* ob = o + (static_cast<size_t>(bi) * h + head) * d;
  for (int c = tid; c < d; c += kCombineThreads) {
    float sum = 0.0f;
#pragma unroll 8
    for (int i = 0; i < n_split; ++i)
      if (wgt[i] != 0.0f) sum += w[i * stride + c] * wgt[i];
    ob[c] = from_f32<T>(sum * inv_den);
  }
}

template <typename T>
cudaError_t launch_split(const void* q, const void* kc, const void* vc,
                         const int* kv_len, float* ws, int b, int t, int h,
                         int kvh, int d, int n_split, int chunk, float scale,
                         cudaStream_t stream) {
  const int g = h / kvh;
  const int gmax = rows_per_pass(g, d);
  const int ldk = d;     // unpadded: K is read once per tile into registers
                         // and the V reads of a warp are contiguous
  const size_t smem = smem_bytes(gmax, d, ldk, sizeof(T));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = d <= 128 ? flash_decode_kernel<T, 8>
                       : flash_decode_kernel<T, 16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<dim3(kvh, b, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), kv_len, ws, t, h, kvh, d, n_split, chunk,
      ldk, gmax, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_combine(const float* ws, void* o, int b, int h, int d,
                           int n_split, cudaStream_t stream) {
  const size_t csmem = 3 * sizeof(float) * static_cast<size_t>(n_split);
  auto comb = flash_decode_combine_kernel<T>;
  if (csmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        comb, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(csmem));
    if (err != cudaSuccess) return err;
  }
  comb<<<dim3(h, b), kCombineThreads, csmem, stream>>>(
      ws, static_cast<T*>(o), h, d, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* kv_len, void* o, float* ws, int b, int t,
                   int h, int kvh, int d, int n_split, int chunk,
                   float scale, cudaStream_t stream) {
  const cudaError_t err = launch_split<T>(q, kc, vc, kv_len, ws, b, t, h,
                                         kvh, d, n_split, chunk, scale,
                                         stream);
  if (err != cudaSuccess) return err;
  return launch_combine<T>(ws, o, b, h, d, n_split, stream);
}

// The checks of a split pass's arguments (see flash_decode_fwd).
bool split_args_ok(const void* kc, const void* vc, int t, int h, int kvh,
                   int d, int n_split, int chunk) {
  return !(d < 16 || d > 256 || d % 16 != 0 || kvh <= 0 || h % kvh != 0 ||
           t < 0 || n_split < 1 || n_split > 65535 || chunk < TILE ||
           chunk % TILE != 0 ||
           static_cast<long long>(n_split) * chunk < (t > 1 ? t : 1) ||
           static_cast<long long>(n_split - 1) * chunk >= (t > 1 ? t : 1) ||
           reinterpret_cast<uintptr_t>(kc) % 16 != 0 ||
           reinterpret_cast<uintptr_t>(vc) % 16 != 0);
}

}  // namespace

extern "C" {

const char* decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q: [b, h, d]; k_cache, v_cache: [b, t, kvh, d]; kv_len: int32 [b];
// o: [b, h, d]; ws: f32 [b, h, n_split, d + 2], written before it is read;
// all contiguous, the caches 16-byte aligned, q and the caches of one
// dtype (0 = f32, 1 = bf16); scale is d^-1/2 as the wrapper rounds it.
// n_split and chunk (a multiple of 32) cover the cache: (n_split - 1) *
// chunk < max(t, 1) <= n_split * chunk.
int flash_decode_fwd(const void* q, const void* kc, const void* vc,
                     const int* kv_len, void* o, float* ws, int dtype, int b,
                     int t, int h, int kvh, int d, int n_split, int chunk,
                     float scale, cudaStream_t stream) {
  if (!split_args_ok(kc, vc, t, h, kvh, d, n_split, chunk))
    return cudaErrorInvalidValue;
  if (b == 0 || h == 0) return cudaSuccess;
  if (dtype == kDtypeF32)
    return launch<float>(q, kc, vc, kv_len, o, ws, b, t, h, kvh, d, n_split,
                         chunk, scale, stream);
  if (dtype == kDtypeBF16)
    return launch<__nv_bfloat16>(q, kc, vc, kv_len, o, ws, b, t, h, kvh, d,
                                 n_split, chunk, scale, stream);
  return cudaErrorInvalidValue;
}

// The split pass alone: the partials of a block of cache rows, as a rank
// of a sequence-sharded cache holds them (its rows and its kv_len, which
// may be <= 0: every split is then empty, l = 0). Arguments as
// flash_decode_fwd's, without o; ws [b, h, n_split, d + 2] is written
// (acc[d], m, l; acc is left unwritten where l = 0).
int flash_decode_split(const void* q, const void* kc, const void* vc,
                       const int* kv_len, float* ws, int dtype, int b, int t,
                       int h, int kvh, int d, int n_split, int chunk,
                       float scale, cudaStream_t stream) {
  if (!split_args_ok(kc, vc, t, h, kvh, d, n_split, chunk))
    return cudaErrorInvalidValue;
  if (b == 0 || h == 0) return cudaSuccess;
  if (dtype == kDtypeF32)
    return launch_split<float>(q, kc, vc, kv_len, ws, b, t, h, kvh, d,
                               n_split, chunk, scale, stream);
  if (dtype == kDtypeBF16)
    return launch_split<__nv_bfloat16>(q, kc, vc, kv_len, ws, b, t, h, kvh,
                                       d, n_split, chunk, scale, stream);
  return cudaErrorInvalidValue;
}

// The combine pass alone: ws f32 [b, h, n_split, d + 2] (the partials of
// any number of splits, such as several ranks' split passes put side by
// side in row order) -> o [b, h, d] in dtype (0 = f32, 1 = bf16). A row
// with no live split (every l = 0) gives zeros.
int flash_decode_combine(const float* ws, void* o, int dtype, int b, int h,
                         int d, int n_split, cudaStream_t stream) {
  if (d < 1 || n_split < 1 ||
      3 * sizeof(float) * static_cast<size_t>(n_split) > kMaxSmem)
    return cudaErrorInvalidValue;
  if (b == 0 || h == 0) return cudaSuccess;
  if (dtype == kDtypeF32)
    return launch_combine<float>(ws, o, b, h, d, n_split, stream);
  if (dtype == kDtypeBF16)
    return launch_combine<__nv_bfloat16>(ws, o, b, h, d, n_split, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
