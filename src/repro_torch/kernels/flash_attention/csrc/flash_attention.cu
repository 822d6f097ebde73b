// Hand-written Hopper (sm_90a) flash attention forward (training / prefill),
// FlashAttention-2's schedule on the tensor cores through mma.sync.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention (_attn_kernel).
// It computes causal (or full) grouped-query attention
//   out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / g]) v[b, j, h / g]
// with query row i at position i + q_offset, keys j >= t masked (the padded
// tail), keys j > i + q_offset masked when causal, scores in f32, and the
// output in q's dtype. Inputs are f32 or bf16, all three of one dtype.
//
// What bounds it on this card: operations. The work is 2*b*h*s*t*d*2
// FLOPs, half of that when causal, against 2*b*(s*h + 2*t*kvh)*d*itemsize
// bytes. The served models are f32, and the f32 bar (2e-5) forbids plain
// TF32 (10 mantissa bits), so both products run as 3xTF32 on the tensor
// cores: each f32 operand x is split into TF32 parts hi + lo, and
// hi*hi + hi*lo + lo*hi is summed in f32 (its error against an f64 sum is
// that of an f32 product). Its bound is 3x the operations at 495 TFLOP/s;
// the f32 CUDA cores' (67 TFLOP/s) is 2.5x longer. mma.sync does not reach
// the rated TF32 rate (wgmma does), and products issued back to back into
// one accumulator wait out each other's latency: on an H100 80GB HBM3 at
// 700 W, issuing P.V's products for four n-tiles in turn made the kernel
// 1.4x faster, and the two cross-term products take about 40% of its time
// (scripts/sweep_kernels.py).
//
// Design. One CTA of WARPS warps owns BQ = 16 * WARPS query rows of one
// (batch, q head), each warp 16 rows, and walks the KV tiles of BK keys:
//  - Q . K^T on mma.sync.m16n8k8 tf32 (bf16: m16n8k16). Q stays in shared
//    memory in its input dtype and is split into hi and lo as each fragment
//    is loaded (held in registers at d = 128 it would need 128 of them).
//    The hi*hi products and the cross terms go to accumulators of their
//    own, added on the CUDA cores (mlstm_chunkwise.cu found that a long
//    tensor-core accumulation of all three moves the sums away from f32).
//    The reduction axis is permuted inside each k-step (k = t -> column
//    2t, k = t + 4 -> 2t + 1; bf16: 4t .. 4t + 3) so that a thread's A and
//    B fragments are one 8-byte load each; the product is unchanged.
//  - The online softmax stays in registers: each thread holds two rows'
//    scores of the C fragment, row maxima are taken across the 4 lanes of
//    a quad with __shfl_xor_sync, and the row sums stay per-thread until
//    the end (the rescale factor is uniform over the quad). No score tile
//    goes to shared memory and the softmax needs no barrier. IEEE expf,
//    the finite sentinel -1e30 of kernel.py:22 for masked scores (a row
//    whose first tile is fully masked computes exp(0) = 1, not inf - inf),
//    and acc / max(l, 1e-30) at the end, as the TPU kernel.
//  - P . V takes P from the score registers without a shuffle: the m16n8 C
//    fragment holds keys 2t and 2t + 1, the tf32 A fragment wants k = t and
//    t + 4, so the keys of each k-step are permuted (k = t -> key 2t, k =
//    t + 4 -> key 2t + 1) and V's B fragment is loaded with the same
//    permutation. f32: P and V split into hi + lo (3xTF32), the products of
//    one KV tile summed in a tile-local accumulator that is added to the
//    running one on the CUDA cores (d <= 128; above, straight into it).
//    Each of the products is issued for kPvGroup n-tiles in turn.
//    bf16: P split into bf16 hi + lo parts (one bf16 P is 2^-9 off, which
//    the tight bar at qwen2.5-3b's widths does not leave room for).
//  - K and V tiles (chunks) stream through a ring of NS shared-memory slots
//    by 16-byte cp.async, in the input dtype, AHEAD chunks in flight while
//    one is used: one barrier per chunk (two when NS = AHEAD + 1). Rows are
//    padded (K and Q: 32 bytes beyond a multiple of 128, V: 16) so every
//    fragment load of a warp hits distinct banks; rows beyond s or t are
//    zero-filled by the copy, so padded V rows are zero.
//  - Causal: query tiles are the slowest grid axis, longest first over all
//    heads (mlstm_chunkwise.cu does the same), tiles wholly above the
//    diagonal are skipped (kernel.py:43-45), a warp skips a tile above its
//    own 16 rows (and all tiles when its rows lie beyond s), and only tiles
//    that cross the diagonal or the end of the keys are masked.
// Two tilings (Tiling below): d <= 128 and d from 144 to 256. Head dims are
// multiples of 16 from 16 to 256; anything else is refused. Operands must
// be 16-byte aligned.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// (repro_torch/kernels/_build.py, ATTENTION_FLAGS: held to a tolerance,
// FMA contraction allowed). Each entry point is extern "C", launches on the
// caller's stream, allocates nothing and returns the cudaError_t of the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;    // kernel.py:22's finite sentinel
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

// P.V issues each of its three products for kPvGroup output n-tiles in
// turn: the products into one accumulator are dependent, and with nothing
// between them each waits out the previous one's latency. Chosen by
// scripts/sweep_kernels.py (Q.K^T, whose n-tiles already alternate two
// accumulators, gained nothing from it).
constexpr int kPvGroup = 4;

// WARPS warps of 16 query rows (BQ = 16 * WARPS), BK keys per KV tile, a
// ring of NS chunk slots with AHEAD chunks in flight (a chunk is one K or
// one V tile). Chosen by scripts/sweep_kernels.py on the H100 (PERF.md).
template <int DMAX>
struct Tiling;
template <>
struct Tiling<128> {
  static constexpr int WARPS = 8, BK = 64, NS = 4, AHEAD = 2;
};
template <>
struct Tiling<256> {
  static constexpr int WARPS = 4, BK = 16, NS = 2, AHEAD = 1;
};

// Row strides in bytes: the row padded to 128 bytes, plus 32 (Q and K:
// 8-byte fragment loads) or 16 (V: 4-byte loads two keys apart).
__host__ __device__ constexpr int row_pad(int d, int size) {
  return (d * size + 127) / 128 * 128;
}
__host__ __device__ constexpr int k_stride(int d, int size) {
  return row_pad(d, size) + 32;
}
__host__ __device__ constexpr int v_stride(int d, int size) {
  return row_pad(d, size) + 16;
}

template <int DMAX, typename T>
size_t smem_bytes(int d) {
  using TL = Tiling<DMAX>;
  const int ks = k_stride(d, sizeof(T));
  return static_cast<size_t>(16 * TL::WARPS) * ks +
         static_cast<size_t>(TL::NS) * TL::BK * ks;
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

// x = hi + lo for 3xTF32: hi is x rounded to nearest TF32 (10 mantissa
// bits, ties away from zero) by integer arithmetic, not cvt.rna.tf32.f32,
// whose conversion pipe runs at a quarter of the FP32 rate; lo = x - hi is
// exact, |lo| <= 2^-11 |x|, and the tensor core reads lo's top 10 mantissa
// bits. ref.split_tf32 is the same rounding.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 p;
  p.x = lo;      // the lower k index in the lower 16 bits
  p.y = hi;
  return *reinterpret_cast<uint32_t*>(&p);
}

// Two f32 values as bf16 hi and lo parts, packed (the lower k index low).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 hh = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(hh);
  const __nv_bfloat162 ll = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&hh);
  lo = *reinterpret_cast<const uint32_t*>(&ll);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Raw scores of a warp's 16 rows against the NT * 8 keys of a K tile:
// s[nt][e] is row g + 8 * (e >> 1), key 8 * nt + 2t + (e & 1). Qw is the
// warp's first row, Kt the tile; ks the row stride in elements.
template <int NT>
__device__ __forceinline__ void qk_tile(const float* Qw, const float* Kt,
                                        int ks, int d, int g, int t,
                                        float (&s)[NT][4]) {
  float sm[NT][4], sx[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sm[nt][e] = sx[nt][e] = 0.0f;
#pragma unroll 2
  for (int kk = 0; kk < d; kk += 8) {
    const float2 qa = *reinterpret_cast<const float2*>(Qw + g * ks + kk + 2 * t);
    const float2 qb =
        *reinterpret_cast<const float2*>(Qw + (g + 8) * ks + kk + 2 * t);
    uint32_t ah[4], al[4];
    split_tf32(qa.x, ah[0], al[0]);
    split_tf32(qb.x, ah[1], al[1]);
    split_tf32(qa.y, ah[2], al[2]);
    split_tf32(qb.y, ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 kv =
          *reinterpret_cast<const float2*>(Kt + (nt * 8 + g) * ks + kk + 2 * t);
      uint32_t bh[2], bl[2];
      split_tf32(kv.x, bh[0], bl[0]);
      split_tf32(kv.y, bh[1], bl[1]);
      mma_tf32(sx[nt], al, bh);
      mma_tf32(sx[nt], ah, bl);
      mma_tf32(sm[nt], ah, bh);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = sm[nt][e] + sx[nt][e];
}

template <int NT>
__device__ __forceinline__ void qk_tile(const __nv_bfloat16* Qw,
                                        const __nv_bfloat16* Kt, int ks,
                                        int d, int g, int t,
                                        float (&s)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll 2
  for (int kk = 0; kk < d; kk += 16) {
    const uint2 qa = *reinterpret_cast<const uint2*>(Qw + g * ks + kk + 4 * t);
    const uint2 qb =
        *reinterpret_cast<const uint2*>(Qw + (g + 8) * ks + kk + 4 * t);
    const uint32_t a[4] = {qa.x, qb.x, qa.y, qb.y};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 kv =
          *reinterpret_cast<const uint2*>(Kt + (nt * 8 + g) * ks + kk + 4 * t);
      const uint32_t b[2] = {kv.x, kv.y};
      mma_bf16(s[nt], a, b);
    }
  }
}

// o += P . V over one tile: P in the score registers (NT n-tiles of 8
// keys), V the tile with row stride vs (elements); ND = DMAX / 8 output
// n-tiles, of which the first d / 8 are live. A group of kPvGroup n-tiles
// that starts below d may run past it into the row's padding (rows are
// padded to 128 bytes, which holds 4 n-tiles in f32 and 8 in bf16): those
// accumulators are never stored.
template <int NT, int ND>
__device__ __forceinline__ void pv_tile(const float (&p)[NT][4],
                                        const float* Vt, int vs, int nd,
                                        int g, int t, float (&o)[ND][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(p[j][0], ah[0], al[0]);     // k = t:     key 2t, row g
    split_tf32(p[j][2], ah[1], al[1]);     //            key 2t, row g + 8
    split_tf32(p[j][1], ah[2], al[2]);     // k = t + 4: key 2t + 1, row g
    split_tf32(p[j][3], ah[3], al[3]);     //            key 2t + 1, row g + 8
    const float* v0 = Vt + (j * 8 + 2 * t) * vs + g;
#pragma unroll
    for (int nt = 0; nt < ND; nt += kPvGroup) {
      if (nt < nd) {
        uint32_t bh[kPvGroup][2], bl[kPvGroup][2];
#pragma unroll
        for (int u = 0; u < kPvGroup; ++u) {
          split_tf32(v0[(nt + u) * 8], bh[u][0], bl[u][0]);
          split_tf32(v0[vs + (nt + u) * 8], bh[u][1], bl[u][1]);
        }
#pragma unroll
        for (int u = 0; u < kPvGroup; ++u) mma_tf32(o[nt + u], al, bh[u]);
#pragma unroll
        for (int u = 0; u < kPvGroup; ++u) mma_tf32(o[nt + u], ah, bl[u]);
#pragma unroll
        for (int u = 0; u < kPvGroup; ++u) mma_tf32(o[nt + u], ah, bh[u]);
      }
    }
  }
}

template <int NT, int ND>
__device__ __forceinline__ void pv_tile(const float (&p)[NT][4],
                                        const __nv_bfloat16* Vt, int vs,
                                        int nd, int g, int t,
                                        float (&o)[ND][4]) {
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t ah[4], al[4];
    split_bf16(p[j][0], p[j][1], ah[0], al[0]);          // row g, keys 2t..
    split_bf16(p[j][2], p[j][3], ah[1], al[1]);          // row g + 8
    split_bf16(p[j + 1][0], p[j + 1][1], ah[2], al[2]);  // keys 8 + 2t..
    split_bf16(p[j + 1][2], p[j + 1][3], ah[3], al[3]);
    const __nv_bfloat16* v0 = Vt + (j * 8 + 2 * t) * vs + g;
#pragma unroll
    for (int nt = 0; nt < ND; nt += kPvGroup) {
      if (nt < nd) {
        uint32_t b[kPvGroup][2];
#pragma unroll
        for (int u = 0; u < kPvGroup; ++u) {
          const __nv_bfloat16* vb = v0 + (nt + u) * 8;
          b[u][0] = pack_bf16(vb[0], vb[vs]);
          b[u][1] = pack_bf16(vb[8 * vs], vb[9 * vs]);
        }
#pragma unroll
        for (int u = 0; u < kPvGroup; ++u) mma_bf16(o[nt + u], al, b[u]);
#pragma unroll
        for (int u = 0; u < kPvGroup; ++u) mma_bf16(o[nt + u], ah, b[u]);
      }
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(Tiling<DMAX>::WARPS * 32,
                                  8 / Tiling<DMAX>::WARPS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int s,
                           int t, int h, int kvh, int d, float scale,
                           int causal, int q_offset) {
  using TL = Tiling<DMAX>;
  constexpr int BQ = 16 * TL::WARPS;
  constexpr int BK = TL::BK;
  constexpr int NS = TL::NS;
  constexpr int AHEAD = TL::AHEAD;
  constexpr int NT = BK / 8;            // score n-tiles per warp
  constexpr int ND = DMAX / 8;          // output n-tiles per warp, at most
  constexpr int E = 16 / static_cast<int>(sizeof(T));   // per 16 bytes
  constexpr int kThreads = TL::WARPS * 32;
  // d <= 128: a tile-local P.V accumulator, added on the CUDA cores.
  constexpr bool kLocal = DMAX <= 128;
  static_assert(NS == AHEAD + 2 || NS == AHEAD + 1, "ring slots");
  static_assert(sizeof(T) == 4 || NT % 2 == 0, "bf16 P.V takes 16 keys");
  static_assert(ND % kPvGroup == 0 && kPvGroup * 8 * sizeof(T) <= 128,
                "n-tile groups");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ksb = k_stride(d, sizeof(T));      // bytes
  const int ks = ksb / static_cast<int>(sizeof(T));
  const int vs = v_stride(d, sizeof(T)) / static_cast<int>(sizeof(T));
  const int slot_bytes = BK * ksb;
  T* Qs = reinterpret_cast<T*>(smem_raw);
  unsigned char* ring = smem_raw + BQ * ksb;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;      // mma groupID
  const int tq = lane & 3;      // mma threadID_in_group
  const int bi = blockIdx.x / h;
  const int hi = blockIdx.x - bi * h;
  // Query tiles are the slowest grid axis, longest rows first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int r0 = warp * 16;     // this warp's first row in the tile
  const int kvhi = hi / (h / kvh);
  const int nd = d / 8;

  const size_t q_stride = static_cast<size_t>(h) * d;     // one q row
  const size_t kv_stride = static_cast<size_t>(kvh) * d;  // one k/v row
  const T* qb = q + (static_cast<size_t>(bi) * s * h + hi) * d;
  T* ob = o + (static_cast<size_t>(bi) * s * h + hi) * d;
  const T* kb = k + (static_cast<size_t>(bi) * t * kvh + kvhi) * d;
  const T* vb = v + (static_cast<size_t>(bi) * t * kvh + kvhi) * d;
  const int upr = d / E;        // 16-byte units per row

  int n_tiles = (t + BK - 1) / BK;
  if (causal) {
    // The last query position of this tile sees keys up to it; later
    // tiles are fully masked for every row of the tile.
    const int last = q0 + BQ - 1 + q_offset;
    n_tiles = min(n_tiles, last < 0 ? 0 : last / BK + 1);
  }
  const int total = 2 * n_tiles;              // K and V chunks

  // The Q tile, in its own copy group ahead of the ring.
  for (int u = tid; u < BQ * upr; u += kThreads) {
    const int r = u / upr;
    const int c = (u - r * upr) * E;
    const bool ok = q0 + r < s;
    cp_async16(reinterpret_cast<unsigned char*>(Qs) + r * ksb + c * sizeof(T),
               qb + (ok ? static_cast<size_t>(q0 + r) * q_stride + c : 0),
               ok ? 16 : 0);
  }
  cp_async_commit();

  // Chunk c: the K (even) or V (odd) tile of KV tile c / 2.
  auto issue = [&](int c) {
    if (c < total) {
      const int k0 = (c >> 1) * BK;
      const T* src = (c & 1) ? vb : kb;
      const int rs = (c & 1) ? vs * static_cast<int>(sizeof(T)) : ksb;
      unsigned char* slot = ring + (c % NS) * slot_bytes;
      for (int u = tid; u < BK * upr; u += kThreads) {
        const int r = u / upr;
        const int col = (u - r * upr) * E;
        const bool ok = k0 + r < t;
        cp_async16(slot + r * rs + col * sizeof(T),
                   src + (ok ? static_cast<size_t>(k0 + r) * kv_stride + col
                             : 0),
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  float sc[NT][4];
  float m0 = kNegInf, m1 = kNegInf;     // running max of rows g, g + 8
  float l0 = 0.0f, l1 = 0.0f;           // this thread's part of the sums
  float a0 = 1.0f, a1 = 1.0f;           // this tile's rescale factors
  const int pos0 = q0 + r0 + g + q_offset;    // position of row g
  const T* Qw = Qs + r0 * ks;

  for (int p = 0; p < AHEAD; ++p) issue(p);
  for (int c = 0; c < total; ++c) {
    issue(c + AHEAD);
    cp_async_wait<AHEAD>();
    __syncthreads();
    const int k0 = (c >> 1) * BK;
    // A warp whose rows all precede the tile's first key skips it (its
    // rows that saw a key are unchanged by a fully masked tile), and so
    // does a warp whose rows all lie beyond s.
    const bool live =
        q0 + r0 < s && (!causal || k0 <= q0 + r0 + 15 + q_offset);
    const T* slot = reinterpret_cast<const T*>(ring + (c % NS) * slot_bytes);
    if (live && !(c & 1)) {
      qk_tile<NT>(Qw, slot, ks, d, g, tq, sc);
      const bool edge = k0 + BK > t || (causal && k0 + BK - 1 > pos0 - g);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[nt][e] * scale;
          if (edge) {
            const int key = k0 + nt * 8 + 2 * tq + (e & 1);
            const int pos = pos0 + 8 * (e >> 1);
            if (key >= t || (causal && key > pos)) x = kNegInf;
          }
          sc[nt][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      a0 = expf(m0 - n0);
      a1 = expf(m1 - n1);
      m0 = n0;
      m1 = n1;
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        sc[nt][0] = expf(sc[nt][0] - n0);
        sc[nt][1] = expf(sc[nt][1] - n0);
        sc[nt][2] = expf(sc[nt][2] - n1);
        sc[nt][3] = expf(sc[nt][3] - n1);
        s0 += sc[nt][0] + sc[nt][1];
        s1 += sc[nt][2] + sc[nt][3];
      }
      l0 = l0 * a0 + s0;
      l1 = l1 * a1 + s1;
      if (!kLocal) {
#pragma unroll
        for (int nt = 0; nt < ND; ++nt) {
          acc[nt][0] *= a0;
          acc[nt][1] *= a0;
          acc[nt][2] *= a1;
          acc[nt][3] *= a1;
        }
      }
    } else if (live) {
      if (kLocal) {
        float pv[ND][4];
#pragma unroll
        for (int nt = 0; nt < ND; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[nt][e] = 0.0f;
        pv_tile<NT, ND>(sc, slot, vs, nd, g, tq, pv);
#pragma unroll
        for (int nt = 0; nt < ND; ++nt) {
          acc[nt][0] = acc[nt][0] * a0 + pv[nt][0];
          acc[nt][1] = acc[nt][1] * a0 + pv[nt][1];
          acc[nt][2] = acc[nt][2] * a1 + pv[nt][2];
          acc[nt][3] = acc[nt][3] * a1 + pv[nt][3];
        }
      } else {
        pv_tile<NT, ND>(sc, slot, vs, nd, g, tq, acc);
      }
    }
    if (NS == AHEAD + 1) __syncthreads();   // the slot is refilled next
  }

  cp_async_wait<0>();     // no copy outlives the CTA (n_tiles may be 0)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const int row0 = q0 + r0 + g;
#pragma unroll
  for (int nt = 0; nt < ND; ++nt) {
    if (nt < nd) {
      const int col = nt * 8 + 2 * tq;
      if (row0 < s)
        store2(ob + row0 * q_stride + col, acc[nt][0] / l0,
               acc[nt][1] / l0);
      if (row0 + 8 < s)
        store2(ob + (row0 + 8) * q_stride + col, acc[nt][2] / l1,
               acc[nt][3] / l1);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int s, int t, int h, int kvh, int d, float scale,
                   int causal, int q_offset, cudaStream_t stream) {
  using TL = Tiling<DMAX>;
  const size_t smem = smem_bytes<DMAX, T>(d);
  auto kern = flash_attention_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (s + 16 * TL::WARPS - 1) / (16 * TL::WARPS));
  kern<<<grid, TL::WARPS * 32, smem, stream>>>(
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
    return launch<T, 128>(q, k, v, o, b, s, t, h, kvh, d, scale, causal,
                          q_offset, stream);
  return launch<T, 256>(q, k, v, o, b, s, t, h, kvh, d, scale, causal,
                        q_offset, stream);
}

template <int DMAX>
void report(int* out) {
  using TL = Tiling<DMAX>;
  out[0] = 16 * TL::WARPS;
  out[1] = TL::BK;
  out[2] = TL::WARPS;
  out[3] = TL::NS;
  out[4] = TL::AHEAD;
}

}  // namespace

extern "C" {

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The tiling launched for head dim d: BQ, BK, warps, ring slots, chunks in
// flight (out[0..4]).
void flash_attention_tiling(int d, int* out) {
  if (d <= 128)
    report<128>(out);
  else
    report<256>(out);
}

// q: [b, s, h, d]; k, v: [b, t, kvh, d]; o: [b, s, h, d]; all contiguous,
// 16-byte aligned, of one dtype (0 = f32, 1 = bf16).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int b, int s, int t, int h, int kvh, int d,
                        float scale, int causal, int q_offset,
                        cudaStream_t stream) {
  if (d < 16 || d > 256 || d % 16 != 0 || kvh <= 0 || h % kvh != 0 ||
      b < 0 || s < 0 || t < 0 || (s + 63) / 64 > 65535 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(o) % 16 != 0)
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
