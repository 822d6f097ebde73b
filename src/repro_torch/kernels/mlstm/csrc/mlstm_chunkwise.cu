// Hand-written Hopper (sm_90a) chunkwise mLSTM forward (prefill), with the
// scores shared through a thread-block cluster and both products on the
// tensor cores.
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
// bf16, one dtype for all three; the sums are f32 and the output is
// written in q's dtype.
//
// What bounds it on this card: operations. The function needs
// 4*b*h*d*s(s+1)/2 FLOPs (q.k and S.v over the causal triangle) against
// (3*d + 2) * b*s*h elements read and d * b*s*h written.
//
// Design. One CTA of 512 threads owns one (batch, head, tile of BQ = 64
// query rows, slice of DV value columns) and walks the KV tiles of BK = 64
// keys up to the causal diagonal, carrying the running max m and the
// signed denominator per row and the [BQ, DV] accumulator in registers.
// The R = ceil(d / DV) slices of one (batch, head, query tile) are one
// thread-block cluster (kernel.py cluster_plan: DV = 256 at d = 1024, R =
// 4; R = 1 at d <= 256; at most the portable 8, so DV = d / 8 above d =
// 2048). Per KV tile, CTA r computes the partial score tile over its own d
// columns, Q[:, slice_r] . K[:, slice_r]^T, publishes it in its shared
// memory, and after a cluster barrier every CTA reads the R partials
// through distributed shared memory (all ranks' reads in flight together)
// and adds them in rank order 0, 1, ..., R - 1. The order is the same in
// every CTA, so all CTAs of a cluster hold bitwise the same scores,
// running maxes and denominators, and their slices of one output row share
// one denominator; no CTA recomputes another's scores. The partials are
// double-buffered, so one cluster barrier per KV tile suffices. (Pushing
// each row's partials to one owner CTA, which would form the row once and
// push the decayed scores back, needs many more remote transactions than
// these float4 reads.)
// Both products run on the tensor cores with mma.sync and f32
// accumulators: Q.K^T (64 x 64 x DV) and S.V (64 x DV x 64). The f32 path
// uses 3xTF32 (each operand split into TF32 hi + lo parts, summing lo*hi +
// hi*lo + hi*hi), since plain TF32 keeps 10 mantissa bits and the xLSTM
// one-period logits bar is 1e-3; its error against an f64 sum is that of
// an f32 one; the bf16 path takes q.k in bf16 directly
// and S.V with S split into bf16 hi + lo parts. The decayed scores are
// split once, when they are formed (eight threads per row, 8 keys each),
// not by every warp that reads them. Q/K chunks (64
// rows x 64 columns) and V chunks (32 keys, or 16 at 512 columns, x DV
// columns) stream through a ring of 4 shared-memory slots fed by 16-byte
// cp.async copies, two chunks in flight while one is used and one barrier
// per chunk; rows beyond s and columns beyond the slice are zero-filled by
// the copy.
// Numerics are those of kernel.py:23-75: masked decays take the finite
// sentinel -1e30 (the first tile's alpha = exp(-1e30 - m_new) is 0, not
// nan), tiles above the causal diagonal are skipped, rows and keys beyond
// s are masked and padded V rows are zero, and only |den| is clamped at
// exp(-m), after the last tile.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// (repro_torch/kernels/_build.py, ATTENTION_FLAGS: held to a tolerance,
// FMA contraction allowed). The entry point is extern "C", launches on the
// caller's stream with cudaLaunchKernelEx and a cluster dimension,
// allocates nothing and returns the cudaError_t of the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;    // kernel.py:20's finite sentinel
constexpr int kThreads = 512;        // 16 warps
constexpr int BQ = 64;               // query rows per CTA
constexpr int BK = 64;               // keys per KV tile
constexpr int KC = 64;               // q/k columns per chunk
constexpr int NS = 4;                // ring slots
constexpr int AHEAD = 2;             // chunks in flight while one is used
constexpr int PLD = BK + 4;          // row stride of the partial scores
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_DV = 512;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

static_assert(BQ == BK, "the causal tile count assumes square tiles");
static_assert(BQ * 8 == kThreads, "the softmax phase gives 8 threads a row");
// With NS = AHEAD + 2 the chunk issued at step c lands in the slot read at
// step c - 2, which every thread has left once it passed the barrier of
// step c - 1: one barrier per chunk.
static_assert(NS == AHEAD + 2, "ring slots and issue distance");

// Element type of the operands (T) and of the decayed scores as the S.V
// product reads them: TF32 bit patterns (hi and lo parts) for f32, bf16
// (hi and lo parts) for bf16. QLD / SLD are row strides in elements, padded
// so that the fragment loads of a warp fall in distinct banks.
template <typename T>
struct Types;
template <>
struct Types<float> {
  using S = uint32_t;
  static constexpr int QLD = KC + 4;
  static constexpr int SLD = BK + 4;
};
template <>
struct Types<__nv_bfloat16> {
  using S = __nv_bfloat16;
  static constexpr int QLD = KC + 8;
  static constexpr int SLD = BK + 8;
};

// Keys per V chunk: 32, or 16 where the slice is 512 columns wide.
template <int NTW>
__host__ __device__ constexpr int v_keys() {
  return NTW >= 8 ? 16 : 32;
}

template <typename T, int NTW>
__host__ __device__ constexpr int slot_bytes() {
  constexpr int qk = 2 * BQ * Types<T>::QLD * static_cast<int>(sizeof(T));
  constexpr int vv =
      v_keys<NTW>() * (64 * NTW + 8) * static_cast<int>(sizeof(T));
  return ((qk > vv ? qk : vv) + 15) / 16 * 16;
}

// Pbuf [2][BQ][PLD] f32, S hi and lo [BQ][SLD], row_m, row_den, row_a, F_s
// and logi_s [64] f32, then the ring.
template <typename T>
__host__ __device__ constexpr int head_bytes() {
  using ST = typename Types<T>::S;
  return static_cast<int>(sizeof(float)) * (2 * BQ * PLD + 5 * BQ) +
         2 * BQ * Types<T>::SLD * static_cast<int>(sizeof(ST));
}

template <typename T, int NTW>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(head_bytes<T>()) +
         static_cast<size_t>(NS) * slot_bytes<T, NTW>();
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
// bits) by integer arithmetic, not cvt.rna.tf32.f32, whose conversion pipe
// runs at a quarter of the FP32 rate; lo = x - hi is exact, |lo| <= 2^-11
// |x|, and the tensor core reads lo's top 10 mantissa bits.
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

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 8 decayed scores of one row as the S.V product's A operand: hi and lo
// parts, 16-byte stores.
__device__ __forceinline__ void store_split(uint32_t* hi, uint32_t* lo,
                                            const float (&x)[8]) {
  uint32_t h[8], l[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) split_tf32(x[j], h[j], l[j]);
#pragma unroll
  for (int j = 0; j < 8; j += 4) {
    *reinterpret_cast<uint4*>(hi + j) = make_uint4(h[j], h[j + 1], h[j + 2],
                                                   h[j + 3]);
    *reinterpret_cast<uint4*>(lo + j) = make_uint4(l[j], l[j + 1], l[j + 2],
                                                   l[j + 3]);
  }
}
__device__ __forceinline__ void store_split(__nv_bfloat16* hi,
                                            __nv_bfloat16* lo,
                                            const float (&x)[8]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    const __nv_bfloat162 hh = __floats2bfloat162_rn(x[j], x[j + 1]);
    const float2 hf = __bfloat1622float2(hh);
    const __nv_bfloat162 ll =
        __floats2bfloat162_rn(x[j] - hf.x, x[j + 1] - hf.y);
    h[j / 2] = *reinterpret_cast<const uint32_t*>(&hh);
    l[j / 2] = *reinterpret_cast<const uint32_t*>(&ll);
  }
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// Partial scores of one Q/K chunk: warp (wm, wn) owns rows 16*wm .. +16
// and keys 16*wn .. +16 (two n-tiles of 8). In f32 the chunk's hi*hi
// products and its cross terms go to accumulators of their own, added to
// sc on the CUDA cores: a long tensor-core accumulation moves the scores
// away from a sequential f32 sum, and the 48 layers of xlstm-1.3b amplify
// that difference.
__device__ __forceinline__ void qk_chunk(const float* Qc, const float* Kc,
                                         int wm, int wn, int g, int t,
                                         float (&sc)[2][4]) {
  constexpr int LD = Types<float>::QLD;
  float cm[2][4] = {}, cx[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < KC; kk += 8) {
    uint32_t ah[4], al[4];
    const float* qa = Qc + (wm * 16 + g) * LD + kk + t;
    split_tf32(qa[0], ah[0], al[0]);
    split_tf32(qa[8 * LD], ah[1], al[1]);
    split_tf32(qa[4], ah[2], al[2]);
    split_tf32(qa[8 * LD + 4], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float* kb = Kc + (wn * 16 + nt * 8 + g) * LD + kk + t;
      uint32_t bh[2], bl[2];
      split_tf32(kb[0], bh[0], bl[0]);
      split_tf32(kb[4], bh[1], bl[1]);
      mma_tf32(cx[nt], al, bh);
      mma_tf32(cx[nt], ah, bl);
      mma_tf32(cm[nt], ah, bh);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] += cm[nt][e] + cx[nt][e];
}

__device__ __forceinline__ void qk_chunk(const __nv_bfloat16* Qc,
                                         const __nv_bfloat16* Kc, int wm,
                                         int wn, int g, int t,
                                         float (&sc)[2][4]) {
  constexpr int LD = Types<__nv_bfloat16>::QLD;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    uint32_t a[4];
    const __nv_bfloat16* qa = Qc + (wm * 16 + g) * LD + kk + 2 * t;
    a[0] = ld32(qa);
    a[1] = ld32(qa + 8 * LD);
    a[2] = ld32(qa + 8);
    a[3] = ld32(qa + 8 * LD + 8);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const __nv_bfloat16* kb = Kc + (wn * 16 + nt * 8 + g) * LD + kk + 2 * t;
      const uint32_t b[2] = {ld32(kb), ld32(kb + 8)};
      mma_bf16(sc[nt], a, b);
    }
  }
}

// acc += S[:, kc0 .. kc0 + VK] . V chunk: warp (pm, pn), pn < 8, owns rows
// 32*pm .. +32 (two m-tiles) and columns 8*NTW*pn .. (NTW n-tiles).
template <int NTW>
__device__ __forceinline__ void pv_chunk(const uint32_t* Shi,
                                         const uint32_t* Slo, const float* Vc,
                                         int kc0, int pm, int pn, int g,
                                         int t, float (&acc)[2][NTW][4]) {
  constexpr int VLD = 64 * NTW + 8;
  constexpr int SLD = Types<float>::SLD;
#pragma unroll
  for (int kk = 0; kk < v_keys<NTW>(); kk += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int o = (pm * 32 + mi * 16 + g) * SLD + kc0 + kk + t;
      ah[mi][0] = Shi[o];
      ah[mi][1] = Shi[o + 8 * SLD];
      ah[mi][2] = Shi[o + 4];
      ah[mi][3] = Shi[o + 8 * SLD + 4];
      al[mi][0] = Slo[o];
      al[mi][1] = Slo[o + 8 * SLD];
      al[mi][2] = Slo[o + 4];
      al[mi][3] = Slo[o + 8 * SLD + 4];
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const float* vb = Vc + (kk + t) * VLD + pn * 8 * NTW + nt * 8 + g;
      uint32_t bh[2], bl[2];
      split_tf32(vb[0], bh[0], bl[0]);
      split_tf32(vb[4 * VLD], bh[1], bl[1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_tf32(acc[mi][nt], al[mi], bh);
        mma_tf32(acc[mi][nt], ah[mi], bl);
        mma_tf32(acc[mi][nt], ah[mi], bh);
      }
    }
  }
}

template <int NTW>
__device__ __forceinline__ void pv_chunk(const __nv_bfloat16* Shi,
                                         const __nv_bfloat16* Slo,
                                         const __nv_bfloat16* Vc, int kc0,
                                         int pm, int pn, int g, int t,
                                         float (&acc)[2][NTW][4]) {
  constexpr int VLD = 64 * NTW + 8;
  constexpr int SLD = Types<__nv_bfloat16>::SLD;
#pragma unroll
  for (int kk = 0; kk < v_keys<NTW>(); kk += 16) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int o = (pm * 32 + mi * 16 + g) * SLD + kc0 + kk + 2 * t;
      ah[mi][0] = ld32(Shi + o);
      ah[mi][1] = ld32(Shi + o + 8 * SLD);
      ah[mi][2] = ld32(Shi + o + 8);
      ah[mi][3] = ld32(Shi + o + 8 * SLD + 8);
      al[mi][0] = ld32(Slo + o);
      al[mi][1] = ld32(Slo + o + 8 * SLD);
      al[mi][2] = ld32(Slo + o + 8);
      al[mi][3] = ld32(Slo + o + 8 * SLD + 8);
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const __nv_bfloat16* vb =
          Vc + (kk + 2 * t) * VLD + pn * 8 * NTW + nt * 8 + g;
      const uint32_t b[2] = {pack_bf16(vb[0], vb[VLD]),
                             pack_bf16(vb[8 * VLD], vb[9 * VLD])};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][nt], al[mi], b);
        mma_bf16(acc[mi][nt], ah[mi], b);
      }
    }
  }
}

template <typename T, int NTW>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_chunkwise_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ cum_f,
                           const float* __restrict__ logi,
                           T* __restrict__ o, int s, int h, int d, int dv,
                           float scale) {
  using ST = typename Types<T>::S;
  constexpr int DVP = 64 * NTW;            // value columns held, padded
  constexpr int VLD = DVP + 8;
  constexpr int VK = v_keys<NTW>();
  constexpr int NVC = BK / VK;             // V chunks per KV tile
  constexpr int QLD = Types<T>::QLD;
  constexpr int SLD = Types<T>::SLD;
  constexpr int E = 16 / static_cast<int>(sizeof(T));   // per 16 bytes
  constexpr int SLOT = slot_bytes<T, NTW>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Pbuf = reinterpret_cast<float*>(smem_raw);    // [2][BQ][PLD]
  float* row_m = Pbuf + 2 * BQ * PLD;
  float* row_den = row_m + BQ;
  float* row_a = row_den + BQ;
  float* Fs = row_a + BQ;
  float* Li = Fs + BK;
  ST* Shi = reinterpret_cast<ST*>(Li + BK);              // [BQ][SLD]
  ST* Slo = Shi + BQ * SLD;
  unsigned char* ring = smem_raw + head_bytes<T>();

  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.dim_blocks().x);
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;      // mma groupID
  const int t = lane & 3;       // mma threadID_in_group
  const int wm = warp & 3, wn = warp >> 2;     // q.k warp tile (4 x 4)
  const int pm = warp & 1, pn = warp >> 1;     // S.v warp tile (2 x 8)
  const int v0 = rank * dv;                    // this CTA's d columns
  const int vend = min(v0 + dv, d);
  // Query tiles are the slowest grid axis, longest rows first over all
  // heads, so the longest clusters start first.
  const int qi = gridDim.z - 1 - blockIdx.z;
  const int q0 = qi * BQ;
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y - bi * h;

  const size_t row_stride = static_cast<size_t>(h) * d;   // one token
  const size_t head = (static_cast<size_t>(bi) * s * h + hi) * d;
  const T* qb = q + head;
  const T* kb = k + head;
  const T* vb = v + head;
  T* ob = o + head;
  const float* fb = cum_f + static_cast<size_t>(bi) * s * h + hi;
  const float* lb = logi + static_cast<size_t>(bi) * s * h + hi;

  const int nqk = (dv + KC - 1) / KC;          // Q/K chunks per KV tile
  const int per_tile = nqk + NVC;
  const int total = (qi + 1) * per_tile;

  // Chunk c of the flat sequence: the Q/K column chunks of a KV tile, then
  // its V key chunks.
  auto issue = [&](int c) {
    if (c < total) {
      const int kt = c / per_tile;
      const int part = c - kt * per_tile;
      T* slot = reinterpret_cast<T*>(ring + (c % NS) * SLOT);
      if (part < nqk) {
        const int col0 = v0 + part * KC;
        constexpr int UPR = KC / E;            // 16-byte units per row
#pragma unroll
        for (int u = tid; u < 2 * BQ * UPR; u += kThreads) {
          const int which = u / (BQ * UPR);    // 0: q rows, 1: k rows
          const int rem = u - which * BQ * UPR;
          const int r = rem / UPR;
          const int c8 = (rem - r * UPR) * E;
          const int row = (which ? kt * BK : q0) + r;
          const int col = col0 + c8;
          const bool ok = row < s && col < vend;
          const T* src = (which ? kb : qb) +
                         (ok ? static_cast<size_t>(row) * row_stride + col
                             : 0);
          cp_async16(slot + which * BQ * QLD + r * QLD + c8, src,
                     ok ? 16 : 0);
        }
      } else {
        const int key0 = kt * BK + (part - nqk) * VK;
        constexpr int UPR = DVP / E;
#pragma unroll
        for (int u = tid; u < VK * UPR; u += kThreads) {
          const int r = u / UPR;
          const int c8 = (u - r * UPR) * E;
          const int row = key0 + r;
          const int col = v0 + c8;
          const bool ok = row < s && col < vend;
          const T* src =
              vb + (ok ? static_cast<size_t>(row) * row_stride + col : 0);
          cp_async16(slot + r * VLD + c8, src, ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };

  // The softmax phase gives row r = tid / 8 to eight threads, 8 keys each;
  // its F_t, running max and denominator stay in their registers.
  const int srow = tid >> 3;
  const int skey = (tid & 7) * 8;
  const int q_pos = q0 + srow;
  const float ft = q_pos < s ? fb[static_cast<size_t>(q_pos) * h] : 0.0f;
  float m_run = kNegInf, den = 0.0f;

  float acc[2][NTW][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.0f;

  int c = 0;                   // next chunk to consume
  for (int p = 0; p < AHEAD; ++p) issue(p);
  for (int kt = 0; kt <= qi; ++kt) {
    // This tile's F_s and logi_s, in flight behind the q.k chunks.
    const int fkey = kt * BK + (tid & (BK - 1));
    const float fl = tid < 2 * BK && fkey < s
                         ? (tid < BK ? fb : lb)[static_cast<size_t>(fkey) * h]
                         : 0.0f;
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
    for (int part = 0; part < nqk; ++part, ++c) {
      issue(c + AHEAD);
      cp_async_wait<AHEAD>();
      __syncthreads();
      const T* slot = reinterpret_cast<const T*>(ring + (c % NS) * SLOT);
      qk_chunk(slot, slot + BQ * QLD, wm, wn, g, t, sc);
    }

    // Publish this rank's partial scores, stage the tile's F_s and logi_s;
    // read every rank's partials after the cluster barrier (double-
    // buffered: the next tile writes the other buffer).
    float* part_out = Pbuf + (kt & 1) * BQ * PLD;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float* pp = part_out + (wm * 16 + g) * PLD + wn * 16 + nt * 8 + 2 * t;
      store2(pp, sc[nt][0], sc[nt][1]);
      store2(pp + 8 * PLD, sc[nt][2], sc[nt][3]);
    }
    if (tid < 2 * BK) (tid < BK ? Fs : Li)[tid & (BK - 1)] = fl;
    cluster.sync();

    // Scores summed in rank order 0 .. R-1, decay, running max and signed
    // denominator. The remote reads of a round are all in flight at once.
    float raw[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) raw[j] = 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float4 x[MAX_CLUSTER];
#pragma unroll
      for (int rr = 0; rr < MAX_CLUSTER; ++rr)
        if (rr < n_ranks)
          x[rr] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part_out, rr) + srow * PLD + skey +
              4 * half);
#pragma unroll
      for (int rr = 0; rr < MAX_CLUSTER; ++rr) {
        if (rr < n_ranks) {
          float* rw = raw + 4 * half;
          rw[0] += x[rr].x;
          rw[1] += x[rr].y;
          rw[2] += x[rr].z;
          rw[3] += x[rr].w;
        }
      }
    }
    float dec[8];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = kt * BK + skey + j;
      dec[j] = (key <= q_pos && key < s) ? ft - Fs[skey + j] + Li[skey + j]
                                         : kNegInf;
      mx = fmaxf(mx, dec[j]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      raw[j] = raw[j] * scale * expf(dec[j] - m_new);
      sum += raw[j];
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float alpha = expf(m_run - m_new);
    den = den * alpha + sum;
    m_run = m_new;
    store_split(Shi + srow * SLD + skey, Slo + srow * SLD + skey, raw);
    if ((tid & 7) == 0) row_a[srow] = alpha;
    __syncthreads();

    // acc = acc * alpha + S V
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float a_lo = row_a[pm * 32 + mi * 16 + g];
      const float a_hi = row_a[pm * 32 + mi * 16 + g + 8];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        acc[mi][nt][0] *= a_lo;
        acc[mi][nt][1] *= a_lo;
        acc[mi][nt][2] *= a_hi;
        acc[mi][nt][3] *= a_hi;
      }
    }
    for (int part = 0; part < NVC; ++part, ++c) {
      issue(c + AHEAD);
      cp_async_wait<AHEAD>();
      __syncthreads();
      pv_chunk<NTW>(Shi, Slo,
                    reinterpret_cast<const T*>(ring + (c % NS) * SLOT),
                    part * VK, pm, pn, g, t, acc);
    }
  }
  if ((tid & 7) == 0) {
    row_m[srow] = m_run;
    row_den[srow] = den;
  }
  // No CTA leaves while another may still read its partials; this barrier
  // also makes row_m and row_den visible to the block.
  cluster.sync();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = pm * 32 + mi * 16 + g + 8 * half;
      const int row = q0 + r;
      if (row >= s) continue;
      const float dn = fmaxf(fabsf(row_den[r]), expf(-row_m[r]));
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int col = v0 + pn * 8 * NTW + nt * 8 + 2 * t;
        if (col < vend)
          store2(ob + static_cast<size_t>(row) * row_stride + col,
                 acc[mi][nt][2 * half] / dn, acc[mi][nt][2 * half + 1] / dn);
      }
    }
  }
}

template <typename T, int NTW>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* cum_f, const float* logi, void* o, int b,
                   int s, int h, int d, int n_ranks, int dv, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, NTW>();
  auto kern = mlstm_chunkwise_kernel<T, NTW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ranks, b * h, (s + BQ - 1) / BQ);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q),
                           static_cast<const T*>(k),
                           static_cast<const T*>(v), cum_f, logi,
                           static_cast<T*>(o), s, h, d, dv, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* cum_f, const float* logi, void* o, int b,
                     int s, int h, int d, int n_ranks, int dv, float scale,
                     cudaStream_t stream) {
  if (dv <= 64)
    return launch<T, 1>(q, k, v, cum_f, logi, o, b, s, h, d, n_ranks, dv,
                        scale, stream);
  if (dv <= 128)
    return launch<T, 2>(q, k, v, cum_f, logi, o, b, s, h, d, n_ranks, dv,
                        scale, stream);
  if (dv <= 256)
    return launch<T, 4>(q, k, v, cum_f, logi, o, b, s, h, d, n_ranks, dv,
                        scale, stream);
  return launch<T, 8>(q, k, v, cum_f, logi, o, b, s, h, d, n_ranks, dv,
                      scale, stream);
}

}  // namespace

extern "C" {

const char* mlstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, o: [b, s, h, d] of one dtype (0 = f32, 1 = bf16); cum_f, logi:
// [b, s, h] f32; all contiguous and 16-byte aligned. n_ranks is the
// cluster size R (1 to 8) and dv the columns of each rank, a multiple of
// 16 with R * dv >= d and dv <= 512 (kernel.py cluster_plan).
int mlstm_chunkwise_fwd(const void* q, const void* k, const void* v,
                        const float* cum_f, const float* logi, void* o,
                        int dtype, int b, int s, int h, int d, int n_ranks,
                        int dv, float scale, cudaStream_t stream) {
  if (d < 16 || d > 4096 || d % 16 != 0 || b < 0 || s < 0 || h < 0 ||
      b * h > 65535 || (s + BQ - 1) / BQ > 65535 || n_ranks < 1 ||
      n_ranks > MAX_CLUSTER || dv < 16 || dv > MAX_DV || dv % 16 != 0 ||
      n_ranks * dv < d ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return cudaErrorInvalidValue;
  if (b == 0 || s == 0 || h == 0) return cudaSuccess;
  if (dtype == kDtypeF32)
    return dispatch<float>(q, k, v, cum_f, logi, o, b, s, h, d, n_ranks, dv,
                           scale, stream);
  if (dtype == kDtypeBF16)
    return dispatch<__nv_bfloat16>(q, k, v, cum_f, logi, o, b, s, h, d,
                                   n_ranks, dv, scale, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
