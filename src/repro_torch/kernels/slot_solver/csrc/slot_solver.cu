// Hand-written Hopper (sm_90a) kernels of the Algorithm-1 slot solver.
//
// Five kernels, each replacing one Pallas TPU kernel of
// src/repro/kernels/slot_solver/kernel.py:
//
//   config_argmin_kernel    <- kernel.py:config_argmin (_config_kernel)
//   waterfill_kernel        <- kernel.py:waterfill (_waterfill_kernel)
//   waterfill_pair_kernel   <- kernel.py:waterfill_pair (_pair_kernel)
//   waterfill_tiled_kernel  <- kernel.py:waterfill_tiled
//                              (_tiled_waterfill_kernel)
//   baseline_argmax_kernel  <- kernel.py:baseline_argmax (_baseline_kernel)
//
// The three water-fill kernels run one shared device routine,
// illinois_waterfill, the counterpart of kernel.py:_illinois_waterfill.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (repro_torch/kernels/_build.py).
// -fmad=false keeps every a*b+c as two rounded operations, as the plain
// PyTorch version (one operation per launch) computes it; division and
// sqrt stay IEEE (no fast math), so config_argmin's indices equal the plain
// version's bitwise. Every power is written as explicit products in the
// association of repro_torch/core/aopi.py.
//
// Each entry point is extern "C", launches on the caller's stream,
// allocates nothing, and returns the cudaError_t of the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-12f;
constexpr float kLogNuLo = -34.0f;
constexpr float kLogNuHi = 34.0f;
constexpr int kLCFSP = 1;
constexpr int kModeBandwidth = 0;
constexpr int kModeCompute = 1;
constexpr int kConfigThreads = 128;   // threads per config_argmin CTA
constexpr int kFillThreads = 256;     // most threads per water-fill CTA
constexpr int kSlots = 4;             // cameras a thread keeps in registers
constexpr int kMaxGroup = 128;        // most CTAs per server
constexpr int kMaxCluster = 16;       // most CTAs per cluster (> 8: non-portable)
constexpr int kSyncNone = 0;          // G = 1: a plain launch
constexpr int kSyncCluster = 1;       // partials through distributed smem
constexpr int kSyncGrid = 2;          // partials through global memory
constexpr int kBaselineThreads = 128;  // threads per baseline_argmax CTA
// Lanes per camera of the two scans (scan_lanes): the fewest, a power of
// two from kScanMinLanes to kScanMaxLanes, whose n * L lanes cover
// kScanLanesPerSm lanes of every SM.
constexpr int kScanMinLanes = 2;
constexpr int kScanMaxLanes = 32;
constexpr int kScanLanesPerSm = 512;
constexpr int kNoIndex = 0x7fffffff;   // the fold's identity: no entry
constexpr int kModeDos = 0;
constexpr int kModeJcab = 1;

// --------------------------------------------------------------------------
// AoPI closed forms and derivatives (repro_torch/core/aopi.py).
// --------------------------------------------------------------------------

__device__ __forceinline__ float sq(float x) { return x * x; }
__device__ __forceinline__ float cube(float x) { return x * (x * x); }
__device__ __forceinline__ float quad(float x) {
  const float x2 = x * x;
  return x2 * x2;
}

__device__ __forceinline__ float aopi_fcfs(float lam, float mu, float p) {
  const bool stable = lam < mu;
  const float lam_s = stable ? lam : 0.5f * mu;
  const float queue =
      (2.0f * cube(lam_s) + lam_s * sq(mu) - mu * sq(lam_s)) /
      (quad(mu) - sq(mu) * sq(lam_s));
  const float a = (1.0f + 1.0f / p) / lam_s + 1.0f / mu + queue;
  return stable ? a : INFINITY;
}

__device__ __forceinline__ float aopi_lcfsp(float lam, float mu, float p) {
  return (1.0f + 1.0f / p) / lam + 1.0f / (p * mu);
}

__device__ __forceinline__ float d_lcfsp_dlam(float lam, float p) {
  return -(1.0f + 1.0f / p) / sq(lam);
}

__device__ __forceinline__ float d_lcfsp_dmu(float mu, float p) {
  return -1.0f / (p * sq(mu));
}

__device__ __forceinline__ float d_fcfs_dlam(float lam, float mu, float p) {
  const float num = 2.0f * cube(lam) + lam * sq(mu) - mu * sq(lam);
  const float den = quad(mu) - sq(mu) * sq(lam);
  const float dnum = 6.0f * sq(lam) + sq(mu) - 2.0f * mu * lam;
  const float dden = -2.0f * sq(mu) * lam;
  const float dq = (dnum * den - num * dden) / sq(den);
  return -(1.0f + 1.0f / p) / sq(lam) + dq;
}

__device__ __forceinline__ float d_fcfs_dmu(float lam, float mu, float p) {
  const float num = 2.0f * cube(lam) + lam * sq(mu) - mu * sq(lam);
  const float den = quad(mu) - sq(mu) * sq(lam);
  const float dnum = 2.0f * lam * mu - sq(lam);
  const float dden = 4.0f * cube(mu) - 2.0f * mu * sq(lam);
  const float dq = (dnum * den - num * dden) / sq(den);
  return -1.0f / sq(mu) + dq;
}

// Interior minimizer lam* of A_F(lam) on (0, mu): 26 bisection steps on the
// derivative (aopi.argmin_lam_fcfs).
__device__ __forceinline__ float argmin_lam_fcfs(float mu, float p) {
  float lo = 1e-9f;
  float hi = 0.999999f * mu;
  for (int i = 0; i < 26; ++i) {
    const float mid = 0.5f * (lo + hi);
    const bool neg = d_fcfs_dlam(mid, mu, p) < 0.0f;
    lo = neg ? mid : lo;
    hi = neg ? hi : mid;
  }
  return 0.5f * (lo + hi);
}

// --------------------------------------------------------------------------
// Folds of (value, flat index) pairs, shared by kernels 1 and 5.
//
// The two scans pick, per camera, the first flat index of the least (or
// greatest) score, as torch.argmin / argmax of the flat row do. Both
// kernels order the pairs by value, then by index: (v, f) comes before
// (w, g) iff v < w, or v == w and f < g (v > w for a maximum). On NaN-free
// values this is a strict total order: values compare as floats, so +0
// and -0 are equal and equal infinities are equal, and the index decides
// them. Its least element is the smallest index among the entries of
// least value, i.e. the flat first-index argmin, and the least element of
// a set does not depend on how the set is grouped or ordered. So each
// lane may fold its own entries, and the lanes' results may then be
// folded in any order (a butterfly of shuffles, ref.*_lanes_ref models
// its steps), and the result is the flat argmin of the whole row. A
// lane meets its entries in increasing index, so within a lane the order
// needs only the strict value compare, started from (+-inf, the lane's
// first index): a later entry of equal value never precedes, and a first
// entry of value +-inf is what the start already holds. A row whose
// values are all +inf (all -inf for a maximum) gives flat 0, as the
// sequential scan's (best = +-inf, flat = 0) start does: every entry ties
// and index 0 is the least. A lane with no entry holds the identity
// (+-inf, kNoIndex), which every real entry precedes. NaN scores are
// outside this contract: a NaN compares false both ways, so here it
// never wins, while torch.argmin / argmax pick it (ROADMAP.md section 3).
// --------------------------------------------------------------------------

__device__ __forceinline__ bool precedes_min(float v, int f, float w, int g) {
  return v < w || (v == w && f < g);
}

__device__ __forceinline__ bool precedes_max(float v, int f, float w, int g) {
  return v > w || (v == w && f < g);
}

// Fold the (value, index) pairs of a team of kLanes consecutive lanes of
// a warp: step k takes the partner lane ^ 2^k (1, 2, 4, ...). Every lane
// of the warp must call it; each ends with its team's least pair.
template <int kLanes, bool kMax>
__device__ __forceinline__ void team_fold(float& val, int& flat) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, val, off);
    const int f = __shfl_xor_sync(0xffffffffu, flat, off);
    if (kMax ? precedes_max(v, f, val, flat) : precedes_min(v, f, val, flat)) {
      val = v;
      flat = f;
    }
  }
}

// x mod d for the lane numbers of a prologue every thread runs (x <= 32):
// a few subtractions, not an integer division.
__device__ __forceinline__ int small_mod(int x, int d) {
  while (x >= d) x -= d;
  return x;
}

// One scan's CTA: xi [M*R] and size [R] staged in shared memory once,
// beside each camera's per-resolution values [R] (lam, or
// 1/max(lam, 1e-9)). A team of kLanes lanes takes a camera, a CTA a
// block of cameras.
template <int kLanes>
struct ScanCta {
  int lane;            // lane within the camera's team
  int local;           // the team's camera within the CTA's block
  int cams;            // cameras per block
  int r0;              // resolution of the lane's first entry, lane mod R
  int step_r;          // kLanes mod R: resolution step between entries
  const float* xi_s;   // [M*R]
  const float* size_s;  // [R]
  float* per_r;        // this team's [R]

  __device__ __forceinline__ ScanCta(const float* __restrict__ xi,
                                     const float* __restrict__ size,
                                     int n_mr, int n_r, float* smem) {
    float* xs = smem;
    float* ss = xs + n_mr;
    for (int k = threadIdx.x; k < n_mr; k += blockDim.x) xs[k] = xi[k];
    for (int k = threadIdx.x; k < n_r; k += blockDim.x) ss[k] = size[k];
    lane = threadIdx.x % kLanes;
    local = threadIdx.x / kLanes;
    cams = blockDim.x / kLanes;
    r0 = small_mod(lane, n_r);
    step_r = small_mod(kLanes, n_r);
    xi_s = xs;
    size_s = ss;
    per_r = ss + n_r + local * n_r;
    __syncthreads();
  }
};

// Floats of dynamic shared memory of a CTA of `cams` cameras.
int scan_smem_floats(int cams, int n_mr, int n_r) {
  return n_mr + n_r + cams * n_r;
}

// --------------------------------------------------------------------------
// 1. config_argmin (Algorithm 1 line 3).
//
// Replaces kernel.py:config_argmin. Bound on this card: instruction
// issue. The [N, M, R] accuracy table (the only large operand) is read
// once, but each (camera, model, resolution) entry costs nine IEEE
// divisions (mu, the FCFS queue term, 1/p, /lam_s, 1/mu, the LCFSP /lam
// and 1/(p*mu), two /n_total), each a MUFU.RCP and its refinement: about
// 145 instructions an entry. Design: a team of L = scan_lanes(N) lanes
// per camera (more lanes for fewer cameras, so a small fleet still has
// warps to hide the divisions' latency, fewer for a large one, so fewer
// instructions go to the lanes' folds and to padding), lane l taking the
// entries j = l, l + L, ... in flat (m, r) order; a warp holds 32 / L
// consecutive cameras, whose rows are one contiguous span, so its loads
// cover it without gaps. xi and size sit in shared memory once per CTA;
// lam = b*eff/size[r] is computed once per (camera, r), the same float as
// before. Each entry's two scores are the same IEEE expressions in the
// same association as the plain version, and the pair is decided as
// before: LCFSP only if strictly lower (the pair's own first-index rule).
// Each lane folds its entries into (best value, best flat index) by the
// strict compare (the total order above, within a lane), then log2(L)
// butterfly shuffles fold the team, so the [N, M, R, 2] score tensor is
// never written and the result is the flat first-index argmin.
// --------------------------------------------------------------------------

template <int kLanes>
__global__ void __launch_bounds__(kConfigThreads) config_argmin_kernel(
    const float* __restrict__ b, const float* __restrict__ c,
    const float* __restrict__ eff, const float* __restrict__ acc,
    const float* __restrict__ xi, const float* __restrict__ size,
    const float* __restrict__ q_ptr, float v, float n_total, int n, int n_m,
    int n_r, int* __restrict__ r_out, int* __restrict__ m_out,
    int* __restrict__ pol_out) {
  extern __shared__ float smem[];
  const int n_mr = n_m * n_r;
  const ScanCta<kLanes> t(xi, size, n_mr, n_r, smem);
  const float q = *q_ptr;
  const int cam = blockIdx.x * t.cams + t.local;
  const bool live = cam < n;
  const float be = live ? b[cam] * eff[cam] : 0.0f;
  const float ci = live ? c[cam] : 0.0f;
  for (int r = t.lane; r < n_r; r += kLanes) t.per_r[r] = be / t.size_s[r];
  __syncwarp();
  float best_val = INFINITY;
  int best_flat = t.lane < n_mr ? 2 * t.lane : kNoIndex;
  if (live) {
    const float* row = acc + static_cast<long long>(cam) * n_mr;
    int r = t.r0;
#pragma unroll 1
    for (int j = t.lane; j < n_mr; j += kLanes) {
      const float lam = t.per_r[r];
      const float mu = ci / t.xi_s[j];
      const float a = row[j];
      const float p = fmaxf(a, 1e-3f);
      const float s_f = (v * aopi_fcfs(lam, mu, p) - q * a) / n_total;
      const float s_l = (v * aopi_lcfsp(lam, mu, p) - q * a) / n_total;
      const bool l_wins = s_l < s_f;
      const float val = l_wins ? s_l : s_f;
      if (val < best_val) {
        best_val = val;
        best_flat = 2 * j + (l_wins ? 1 : 0);
      }
      r += t.step_r;
      if (r >= n_r) r -= n_r;
    }
  }
  team_fold<kLanes, false>(best_val, best_flat);
  if (live && t.lane == 0) {
    m_out[cam] = best_flat / (n_r * 2);
    r_out[cam] = (best_flat / 2) % n_r;
    pol_out[cam] = best_flat % 2;
  }
}

// --------------------------------------------------------------------------
// Water-filling (Algorithm 1 lines 4/5), shared by kernels 2, 3 and 4.
//
// The cameras of server s are the contiguous segment order[start[s] :
// start[s] + count[s]] of the stably sorted camera order
// (ops.ServerLayout). G CTAs of T threads work on one server (a Team;
// G and T powers of two, picked on the host from N, S and the card's SM
// count, never from the per-server counts on the device): thread t of
// CTA g owns the residue class c = g + G * t, i.e. the segment positions
// c + Q * i with Q = G * T. (A grid launch holds only as many teams as
// the card co-schedules; each walks servers s = team (mod teams).)
//
// Bound on this card: neither bytes nor operations. Each dual evaluation
// depends on the previous one's fill sum, and each FCFS camera runs a
// bisection of dependent h evaluations (three IEEE divisions each), so
// the time is a serial chain of outer + 3 evaluations of up to inner + 4
// dependent steps each, plus one fill sum per evaluation. Design:
//   * one server's search spreads over G CTAs, a camera a thread up to
//     one wave of the card (G = 128 for MIN's virtual server of 100,000
//     cameras, 64 for LBCD's of 10,000);
//   * each thread gathers its cameras' parameters once per fill and keeps
//     them and the brackets xa, xb in registers for up to kSlots cameras,
//     whose bisection chains it interleaves so that their divisions
//     overlap. Cameras beyond kSlots per thread (a segment far above the
//     host's estimate: the host sees only the mean) keep their state in
//     the [5, N] global scratch;
//   * a fill sum is the pairwise halving tree of the segment zero-padded
//     to P = 2^k >= count, the order allocate.tree_segment_sum follows.
//     With Q a power of two, its first log2(P/Q) levels fold each residue
//     class alone (class_sum, in registers), the next log2(T) levels fold
//     the T classes of one CTA (one shared-memory stage for the pairs
//     t, t + h with h >= 32, warp shuffles below), and the last log2(G)
//     levels fold the G CTA partials, exchanged once: through distributed
//     shared memory after a cluster barrier (G <= kMaxCluster), or through
//     global memory, where the last CTA to arrive on a counter folds them
//     and publishes the total tagged with the sum's number, on which the
//     others wait (a cooperative launch guarantees that the server's CTAs
//     are co-resident). Kernels and plain versions thus add in the same
//     order and agree bitwise, at every G and T.
// Every CTA of a server runs the same fixed number of sums (2 + outer per
// fill, plus the compute floors), empty CTAs and empty servers included,
// so all reach every barrier.
// --------------------------------------------------------------------------

struct Cam {
  float scale;   // lam (or mu) at the full server budget
  float p;
  float other;   // the fixed rate of the other resource
  float lo;
  float hi;
  bool is_l;
};

// A finite stand-in for a register slot that holds no camera.
__device__ __forceinline__ Cam idle_cam() {
  return Cam{1.0f, 0.5f, 1.0f, 1e-9f, 1.0f, true};
}

// Scratch rows of one segment, each [N] in sorted position; only
// positions past a thread's kSlots cameras are used.
struct Rows {
  float* xa;
  float* xb;
  float* xt;
  float* bound;   // bandwidth: per-camera cap hi; compute: floor lo
  float* buf;     // class_sum's tree of spilled positions
};

__device__ __forceinline__ Rows rows_of(float* scratch, int n, int start) {
  return Rows{scratch + start, scratch + n + start, scratch + 2 * n + start,
              scratch + 3 * n + start, scratch + 4 * n + start};
}

// Relaxed (gpu scope) accesses of the grid exchange, and its arrival RMW.
__device__ __forceinline__ void st_relaxed(float* p, float v) {
  asm volatile("st.relaxed.gpu.global.f32 [%0], %1;" ::"l"(p), "f"(v)
               : "memory");
}

__device__ __forceinline__ float ld_relaxed(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];"
               : "=f"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long arrive(unsigned long long* p) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;"
               : "=l"(old)
               : "l"(p)
               : "memory");
  return old;
}

// A server's total: the sum's number (from 1) in the high word, the value
// in the low word, stored and read as one 64-bit word, so a reader that
// sees the number sees the value.
__device__ __forceinline__ void publish(unsigned long long* p, unsigned epoch,
                                        float v) {
  const unsigned long long w =
      (static_cast<unsigned long long>(epoch) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ float await(const unsigned long long* p,
                                       unsigned epoch) {
  unsigned long long w;
  do {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(w)
                 : "l"(p)
                 : "memory");
  } while (static_cast<unsigned>(w >> 32) != epoch);
  return __uint_as_float(static_cast<unsigned>(w));
}

// The G CTAs of one server and the sums they take together. Every thread
// of every CTA of the server calls sum() in the same order and gets the
// same total. The partials alternate between two slots, so the next sum
// can start before the slowest reader is done with this one.
// Grid: per server 2 + G 64-bit words, zeroed: the arrivals (counted on,
// never reset: sum e is complete at e * G), the total, and G words of two
// partials each (one per parity).
struct Team {
  int G;            // CTAs per server
  int g;            // rank of this CTA among them
  int Q;            // G * blockDim.x
  int cls;          // this thread's residue class
  int count;        // cameras of the server
  int cnt;          // positions of the segment in this thread's class
  int kact;         // max over the warp of min(cnt, kSlots)
  int sync;         // kSyncNone / kSyncCluster / kSyncGrid
  float* red;       // __shared__ float[2][kFillThreads]: the class sums
  float* xslot;     // __shared__ float[2]: the CTA's partial (cluster) or
                    // the server's total (grid)
  unsigned long long* gslot;   // global [2 + G]: the server's words (grid)
  int parity;       // which half of red and xslot this sum uses
  unsigned epoch;   // this sum's number on the server (grid), from 1

  __device__ int pos(int i) const { return cls + Q * i; }

  // The width-G tree over the CTA partials as one warp folds it: lane l
  // reads CTA l + 32 k, the levels h >= 32 fold over k, shuffles the rest;
  // lane 0 holds the total.
  template <class Read>
  __device__ float fold_partials(const Read& read) const {
    const int lane = threadIdx.x & 31;
    const int ng = G > 32 ? G / 32 : 1;
    float u[kMaxGroup / 32];
#pragma unroll
    for (int k = 0; k < kMaxGroup / 32; ++k) {
      const int r = lane + 32 * k;
      u[k] = k < ng && r < G ? read(r) : 0.0f;
    }
#pragma unroll
    for (int h = kMaxGroup / 64; h >= 1; h >>= 1) {
      if (h < ng) {
#pragma unroll
        for (int i = 0; i < h; ++i) u[i] = u[i] + u[i + h];
      }
    }
    float s = u[0];
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1)
      if (h < G) s = s + __shfl_down_sync(0xffffffffu, s, h);
    return s;
  }

  __device__ float sum(const float (&v)[kSlots], const float* src,
                       float* tmp);
};

__device__ Team make_team(int s, int group, int sync, int count, float* red,
                          float* xslot, unsigned long long* gslots,
                          int parity) {
  Team t;
  t.G = group;
  t.g = blockIdx.x % group;
  t.Q = group * blockDim.x;
  t.cls = t.g + group * threadIdx.x;
  t.count = count;
  t.cnt = count > t.cls ? (count - t.cls + t.Q - 1) / t.Q : 0;
  t.kact = static_cast<int>(__reduce_max_sync(
      0xffffffffu, static_cast<unsigned>(min(t.cnt, kSlots))));
  t.sync = sync;
  t.red = red;
  t.xslot = xslot;
  t.gslot = sync == kSyncGrid ? gslots + (2 + group) * s : nullptr;
  t.parity = parity;
  t.epoch = 1;
  return t;
}

// The halving tree of this thread's residue class: its positions, zero-
// padded to w = P / Q, folded as x[i] += x[i + h] for h = w/2, ..., 1 (the
// first log2(w) levels of the segment's tree). Positions i < kSlots are
// v[i]; the rare ones past them are src[pos(i)], folded through tmp (the
// first level's targets are all real positions: cnt >= w/2).
__device__ float class_sum(const Team& t, const float (&v)[kSlots],
                           const float* src, float* tmp) {
  int p = 1;
  while (p < t.count) p <<= 1;
  const int w = p > t.Q ? p / t.Q : 1;
  float x[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r) x[r] = r < t.cnt ? v[r] : 0.0f;
  for (int h = w / 2; h >= kSlots; h >>= 1) {
    const float* s = h == w / 2 ? src : tmp;
    for (int i = kSlots; i < h; ++i)
      tmp[t.pos(i)] =
          s[t.pos(i)] + (i + h < t.cnt ? s[t.pos(i + h)] : 0.0f);
#pragma unroll
    for (int r = 0; r < kSlots; ++r)
      x[r] = x[r] + (r + h < t.cnt ? s[t.pos(r + h)] : 0.0f);
  }
#pragma unroll
  for (int h = kSlots / 2; h >= 1; h >>= 1) {
    if (h < w) {
#pragma unroll
      for (int r = 0; r < h; ++r) x[r] = x[r] + x[r + h];
    }
  }
  return x[0];
}

__device__ float Team::sum(const float (&v)[kSlots], const float* src,
                           float* tmp) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float s = class_sum(*this, v, src, tmp);
  // Levels h >= 32 of the tree over the CTA's T classes pair lanes of one
  // index: every warp folds them alike from one shared stage.
  if (blockDim.x > 32) {
    float* buf = red + parity * kFillThreads;
    buf[threadIdx.x] = s;
    __syncthreads();
    const int nk = blockDim.x / 32;
    float u[kFillThreads / 32];
#pragma unroll
    for (int k = 0; k < kFillThreads / 32; ++k)
      u[k] = k < nk ? buf[lane + 32 * k] : 0.0f;
#pragma unroll
    for (int h = kFillThreads / 64; h >= 1; h >>= 1) {
      if (h < nk) {
#pragma unroll
        for (int i = 0; i < h; ++i) u[i] = u[i] + u[i + h];
      }
    }
    s = u[0];
  }
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) s = s + __shfl_down_sync(full, s, h);
  // The width-G tree over the CTA partials (lane 0 of each warp holds this
  // CTA's). Cluster: every warp reads the G partials through distributed
  // shared memory after one cluster barrier. Grid: each CTA stores its
  // partial and arrives; the last to arrive folds the G partials and
  // publishes the total, on which the others wait; warp 0 does this and
  // hands the total to the CTA through shared memory.
  if (sync == kSyncCluster) {
    if (threadIdx.x == 0) xslot[parity] = s;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    float* mine = xslot + parity;
    s = fold_partials(
        [&](int r) { return *cluster.map_shared_rank(mine, r); });
  } else if (sync == kSyncGrid) {
    if (threadIdx.x < 32) {
      float* part = reinterpret_cast<float*>(gslot + 2) + (epoch & 1u);
      int last = 0;
      if (lane == 0) {
        st_relaxed(part + 2 * g, s);
        last = arrive(gslot) + 1 == static_cast<unsigned long long>(epoch) * G;
      }
      last = __shfl_sync(full, last, 0);
      __syncwarp();                    // lane 0's acquire orders the reads
      if (last) {
        s = fold_partials([&](int r) { return ld_relaxed(part + 2 * r); });
        if (lane == 0) publish(gslot + 1, epoch, s);
      } else if (lane == 0) {
        s = await(gslot + 1, epoch);
      }
      if (lane == 0) xslot[parity] = s;
    }
    __syncthreads();
    s = xslot[parity];
    ++epoch;
  }
  s = __shfl_sync(full, s, 0);
  parity ^= 1;
  return s;
}

// -dA/dx of an FCFS camera at normalized allocation x (allocate._h_*'s
// FCFS branch). Only FCFS cameras bisect: an LCFSP camera takes its
// closed form, so its bisection, run beside the others', is discarded.
template <int MODE>
__device__ __forceinline__ float h_fcfs(float x, const Cam& c) {
  float d;
  if (MODE == kModeBandwidth) {
    const float lam = fmaxf(c.scale * x, kEps);
    d = d_fcfs_dlam(fminf(lam, 0.999f * c.other), c.other, c.p);
  } else {
    const float mu = fmaxf(c.scale * x, kEps);
    d = d_fcfs_dmu(fminf(c.other, 0.999f * mu), mu, c.p);
  }
  return fmaxf(-d * c.scale, 0.0f);
}

// x(nu) clipped to [lo, hi] from the bisection bracket [a, b] after its
// steps: the LCFSP closed form, or for FCFS the bracket's midpoint
// (allocate._waterfill.alloc_at).
template <int MODE>
__device__ __forceinline__ float settle(float nu, float a, float b,
                                        const Cam& c) {
  float x;
  if (c.is_l) {
    x = MODE == kModeBandwidth
            ? sqrtf((1.0f + 1.0f / c.p) / fmaxf(c.scale * nu, kEps))
            : sqrtf(1.0f / fmaxf(c.p * c.scale * nu, kEps));
  } else {
    x = 0.5f * (a + b);
  }
  return fminf(fmaxf(x, c.lo), c.hi);
}

// One camera: the largest x in [blo, bhi] with h(x) >= nu by bisection.
template <int MODE>
__device__ __forceinline__ float alloc_at(float nu, float blo, float bhi,
                                          int iters, const Cam& c) {
  float a = blo, b = bhi;
  if (!c.is_l) {
    for (int k = 0; k < iters; ++k) {
      const float mid = 0.5f * (a + b);
      const bool up = h_fcfs<MODE>(mid, c) >= nu;
      a = up ? mid : a;
      b = up ? b : mid;
    }
  }
  return settle<MODE>(nu, a, b, c);
}

// KA cameras side by side: their bisection chains are independent, so
// step k of every camera is issued before step k + 1 of any, and their
// divisions overlap. Each chain keeps its own order of operations.
template <int MODE, int KA>
__device__ __forceinline__ void alloc_n(float nu, const float (&blo)[kSlots],
                                        const float (&bhi)[kSlots],
                                        int iters, const Cam (&c)[kSlots],
                                        float (&x)[kSlots]) {
  float a[KA], b[KA];
#pragma unroll
  for (int r = 0; r < KA; ++r) {
    a[r] = blo[r];
    b[r] = bhi[r];
  }
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int r = 0; r < KA; ++r) {
      const float mid = 0.5f * (a[r] + b[r]);
      const bool up = h_fcfs<MODE>(mid, c[r]) >= nu;
      a[r] = up ? mid : a[r];
      b[r] = up ? b[r] : mid;
    }
  }
#pragma unroll
  for (int r = 0; r < KA; ++r) x[r] = settle<MODE>(nu, a[r], b[r], c[r]);
}

// The register slots of a warp that holds at most kact cameras a thread.
template <int MODE>
__device__ __forceinline__ void alloc_slots(int kact, float nu,
                                            const float (&blo)[kSlots],
                                            const float (&bhi)[kSlots],
                                            int iters,
                                            const Cam (&c)[kSlots],
                                            float (&x)[kSlots]) {
  static_assert(kSlots == 4, "alloc_slots dispatches 1..4 slots");
  switch (kact) {
    case 1: alloc_n<MODE, 1>(nu, blo, bhi, iters, c, x); break;
    case 2: alloc_n<MODE, 2>(nu, blo, bhi, iters, c, x); break;
    case 3: alloc_n<MODE, 3>(nu, blo, bhi, iters, c, x); break;
    case 4: alloc_n<MODE, 4>(nu, blo, bhi, iters, c, x); break;
    default: break;
  }
}

// Interior minimizer lam* of A_F on (0, mu) of KA cameras side by side
// (argmin_lam_fcfs, each chain in its own order).
template <int KA>
__device__ __forceinline__ void argmin_n(const Cam (&c)[kSlots],
                                         float (&out)[kSlots]) {
  float lo[KA], hi[KA];
#pragma unroll
  for (int r = 0; r < KA; ++r) {
    lo[r] = 1e-9f;
    hi[r] = 0.999999f * c[r].other;
  }
  for (int i = 0; i < 26; ++i) {
#pragma unroll
    for (int r = 0; r < KA; ++r) {
      const float mid = 0.5f * (lo[r] + hi[r]);
      const bool neg = d_fcfs_dlam(mid, c[r].other, c[r].p) < 0.0f;
      lo[r] = neg ? mid : lo[r];
      hi[r] = neg ? hi[r] : mid;
    }
  }
#pragma unroll
  for (int r = 0; r < KA; ++r) out[r] = 0.5f * (lo[r] + hi[r]);
}

__device__ __forceinline__ void argmin_slots(int kact, const Cam (&c)[kSlots],
                                             float (&out)[kSlots]) {
  switch (kact) {
    case 1: argmin_n<1>(c, out); break;
    case 2: argmin_n<2>(c, out); break;
    case 3: argmin_n<3>(c, out); break;
    case 4: argmin_n<4>(c, out); break;
    default: break;
  }
}

__device__ __forceinline__ void bracket(float xa, float xb, const Cam& c,
                                        float* blo, float* bhi) {
  const float pad = 0.25f * fmaxf(xa - xb, 0.0f) + 1e-7f;
  *blo = fmaxf(c.lo, xb - pad);
  *bhi = fminf(c.hi, xa + pad);
}

// The Illinois dual search of one server (kernel.py:_illinois_waterfill,
// allocate._waterfill): outer + 3 evaluations in one loop -- the two
// endpoint fills (e = 0, 1; inner + 4 steps on the cameras' [lo, hi]),
// outer Illinois steps (inner steps on the bracket [xb, xa]), and the
// final allocation (final_inner steps), left in x (and, past kSlots, in
// w.xt). c holds the thread's register cameras; spill(j) gives the
// parameters of a camera past them.
template <int MODE, class Spill>
__device__ void illinois_waterfill(Team& team, const Cam (&c)[kSlots],
                                   const Spill& spill, Rows w, int outer,
                                   int inner, int final_inner,
                                   float (&x)[kSlots]) {
  float xa[kSlots], xb[kSlots], blo[kSlots], bhi[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r) {
    xa[r] = c[r].hi;
    xb[r] = c[r].lo;
    x[r] = 0.0f;
  }
  float a = kLogNuLo, b = kLogNuHi, fa = 0.0f, fb = 0.0f;
  const int last = outer + 2;
  for (int e = 0; e <= last; ++e) {
    const bool ends = e < 2;
    float mid = 0.0f, nu;
    if (ends) {
      nu = expf(e == 0 ? kLogNuLo : kLogNuHi);
    } else if (e < last) {
      const float denom = fa - fb;
      float t = fabsf(denom) > 1e-12f ? fa / denom : 0.5f;
      t = fminf(fmaxf(t, 0.05f), 0.95f);
      mid = a + t * (b - a);
      nu = expf(mid);
    } else {
      nu = expf(0.5f * (a + b));
    }
    const int iters = ends ? inner + 4 : (e < last ? inner : final_inner);
#pragma unroll
    for (int r = 0; r < kSlots; ++r)
      bracket(ends ? c[r].hi : xa[r], ends ? c[r].lo : xb[r], c[r], &blo[r],
              &bhi[r]);
    alloc_slots<MODE>(team.kact, nu, blo, bhi, iters, c, x);
    for (int i = kSlots; i < team.cnt; ++i) {
      const int j = team.pos(i);
      const Cam cj = spill(j);
      float lo_j, hi_j;
      if (ends) bracket(cj.hi, cj.lo, cj, &lo_j, &hi_j);
      else bracket(w.xa[j], w.xb[j], cj, &lo_j, &hi_j);
      w.xt[j] = alloc_at<MODE>(nu, lo_j, hi_j, iters, cj);
    }
    if (e == last) break;
    const float f = team.sum(x, w.xt, w.buf) - 1.0f;
    const bool over = e == 0 || (e > 1 && f > 0.0f);  // xa takes x
#pragma unroll
    for (int r = 0; r < kSlots; ++r) {
      xa[r] = over ? x[r] : xa[r];
      xb[r] = over ? xb[r] : x[r];
    }
    for (int i = kSlots; i < team.cnt; ++i) {
      const int j = team.pos(i);
      if (over) w.xa[j] = w.xt[j];
      else w.xb[j] = w.xt[j];
    }
    if (e == 0) {
      fa = f;
    } else if (e == 1) {
      fb = f;
    } else {
      const bool up = f > 0.0f;              // over budget -> raise the price
      a = up ? mid : a;
      b = up ? b : mid;
      const float fa_next = up ? f : 0.5f * fa;   // Illinois halving of
      const float fb_next = up ? 0.5f * fb : f;   // the retained endpoint
      fa = fa_next;
      fb = fb_next;
    }
  }
}

// This thread's cameras in register slots: original index, or 0 where
// the slot holds none.
__device__ __forceinline__ void gather(const Team& team, const int* seg,
                                       int (&idx)[kSlots]) {
#pragma unroll
  for (int r = 0; r < kSlots; ++r)
    idx[r] = r < team.cnt ? seg[team.pos(r)] : 0;
}

// Line 4: normalized bandwidth of one server, left in x (and w.xt past
// kSlots) and written as Hz to out[cam].
__device__ void bandwidth_fill(Team& team, const float* k, const float* p,
                               const int* pol, const float* mu, float B,
                               const int* seg, const int (&idx)[kSlots],
                               Rows w, int outer, int inner, int final_inner,
                               float* out, float (&x)[kSlots]) {
  Cam c[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r) {
    const int i = idx[r];
    c[r] = r < team.cnt ? Cam{k[i] * B, p[i], mu[i], 1e-9f, 1.0f,
                              pol[i] == kLCFSP}
                        : idle_cam();
  }
  float lam_star[kSlots];
  argmin_slots(team.kact, c, lam_star);
#pragma unroll
  for (int r = 0; r < kSlots; ++r)
    if (!c[r].is_l) c[r].hi = fminf(lam_star[r] / fmaxf(c[r].scale, kEps),
                                    1.0f);
  for (int i = kSlots; i < team.cnt; ++i) {
    const int j = team.pos(i);
    const int cam = seg[j];
    w.bound[j] = pol[cam] == kLCFSP
                     ? 1.0f
                     : fminf(argmin_lam_fcfs(mu[cam], p[cam]) /
                                 fmaxf(k[cam] * B, kEps),
                             1.0f);
  }
  auto spill = [&](int j) {
    const int i = seg[j];
    return Cam{k[i] * B, p[i], mu[i], 1e-9f, w.bound[j], pol[i] == kLCFSP};
  };
  illinois_waterfill<kModeBandwidth>(team, c, spill, w, outer, inner,
                                     final_inner, x);
#pragma unroll
  for (int r = 0; r < kSlots; ++r)
    if (r < team.cnt) out[idx[r]] = x[r] * B;
  for (int i = kSlots; i < team.cnt; ++i) {
    const int j = team.pos(i);
    out[seg[j]] = w.xt[j] * B;
  }
}

// Line 5: normalized compute of one server with the FCFS stability floors
// (mu >= margin * lam, scaled down where they alone exceed the budget),
// written as FLOPS to out[cam]. lam holds the register cameras' arrival
// rates, lam_of(j) those past them.
template <class Lam>
__device__ void compute_fill(Team& team, const float* inv_xi, const float* p,
                             const int* pol, const float (&lam)[kSlots],
                             const Lam& lam_of, float C, float margin,
                             const int* seg, const int (&idx)[kSlots],
                             Rows w, int outer, int inner, int final_inner,
                             float* out) {
  Cam c[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r) {
    const int i = idx[r];
    c[r] = idle_cam();
    if (r < team.cnt) {
      const bool is_l = pol[i] == kLCFSP;
      c[r] = Cam{inv_xi[i] * C, p[i], lam[r],
                 is_l ? 1e-9f : margin * lam[r] / fmaxf(inv_xi[i] * C, kEps),
                 1.0f, is_l};
    }
  }
  for (int i = kSlots; i < team.cnt; ++i) {
    const int j = team.pos(i);
    const int cam = seg[j];
    w.bound[j] = pol[cam] == kLCFSP
                     ? 1e-9f
                     : margin * lam_of(j) / fmaxf(inv_xi[cam] * C, kEps);
  }
  float floors[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r) floors[r] = c[r].lo;
  const float floor_tot = team.sum(floors, w.bound, w.buf);
  const float fac = fminf(1.0f / fmaxf(floor_tot, kEps), 1.0f);
#pragma unroll
  for (int r = 0; r < kSlots; ++r)
    c[r].lo = fminf(fmaxf(c[r].lo * fac, 1e-9f), 1.0f);
  for (int i = kSlots; i < team.cnt; ++i) {
    const int j = team.pos(i);
    w.bound[j] = fminf(fmaxf(w.bound[j] * fac, 1e-9f), 1.0f);
  }
  auto spill = [&](int j) {
    const int i = seg[j];
    return Cam{inv_xi[i] * C, p[i], lam_of(j), w.bound[j], 1.0f,
               pol[i] == kLCFSP};
  };
  float x[kSlots];
  illinois_waterfill<kModeCompute>(team, c, spill, w, outer, inner,
                                   final_inner, x);
#pragma unroll
  for (int r = 0; r < kSlots; ++r)
    if (r < team.cnt) out[idx[r]] = x[r] * C;
  for (int i = kSlots; i < team.cnt; ++i) {
    const int j = team.pos(i);
    out[seg[j]] = w.xt[j] * C;
  }
}

// One water-fill of every server in `mode` (kernels 2 and 4). coef is
// k = eff/size (bandwidth) or 1/xi (compute); other is mu (bandwidth) or
// lam (compute).
__device__ void fill_servers(int mode, const float* coef, const float* p,
                             const int* pol, const float* other,
                             const float* budgets, float margin,
                             const int* order, const int* starts,
                             const int* counts, int n, int n_servers,
                             int group, int sync, int outer, int inner,
                             int final_inner, float* scratch,
                             unsigned long long* gslots, float* out) {
  __shared__ float red[2 * kFillThreads];
  __shared__ float xslot[2];
  int parity = 0;
  for (int s = blockIdx.x / group; s < n_servers; s += gridDim.x / group) {
    const int start = starts[s];
    Team team = make_team(s, group, sync, counts[s], red, xslot, gslots,
                          parity);
    const Rows w = rows_of(scratch, n, start);
    const int* seg = order + start;
    int idx[kSlots];
    gather(team, seg, idx);
    if (mode == kModeBandwidth) {
      float x[kSlots];
      bandwidth_fill(team, coef, p, pol, other, budgets[s], seg, idx, w,
                     outer, inner, final_inner, out, x);
    } else {
      float lam[kSlots];
#pragma unroll
      for (int r = 0; r < kSlots; ++r)
        lam[r] = r < team.cnt ? other[idx[r]] : 1.0f;
      auto lam_of = [&](int j) { return other[seg[j]]; };
      compute_fill(team, coef, p, pol, lam, lam_of, budgets[s], margin, seg,
                   idx, w, outer, inner, final_inner, out);
    }
    parity = team.parity;
  }
  if (sync == kSyncCluster) cg::this_cluster().sync();
}

// --------------------------------------------------------------------------
// 2. waterfill: one water-fill, bandwidth (mode 0) or compute (mode 1).
//
// Replaces kernel.py:waterfill. G CTAs per server (G = 1, a plain launch,
// in the paper setting).
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(kFillThreads) waterfill_kernel(
    int mode, const float* __restrict__ coef, const float* __restrict__ p,
    const int* __restrict__ pol, const float* __restrict__ other,
    const float* __restrict__ budgets, float margin,
    const int* __restrict__ order, const int* __restrict__ starts,
    const int* __restrict__ counts, int n, int n_servers, int group,
    int sync, int outer, int inner, int final_inner,
    float* __restrict__ scratch, unsigned long long* gslots,
    float* __restrict__ out) {
  fill_servers(mode, coef, p, pol, other, budgets, margin, order, starts,
               counts, n, n_servers, group, sync, outer, inner, final_inner,
               scratch, gslots, out);
}

// --------------------------------------------------------------------------
// 3. waterfill_pair: lines 4 and 5 in one launch.
//
// Replaces kernel.py:waterfill_pair. The bandwidth water-fill writes b;
// then, in the same team, the arrival rate lam = b * k (each thread from
// its own registers, or for a spilled camera from the b it wrote itself),
// the FCFS floors and their per-server rescale, and the compute fill.
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(kFillThreads) waterfill_pair_kernel(
    const float* __restrict__ k, const float* __restrict__ p,
    const int* __restrict__ pol, const float* __restrict__ mu,
    const float* __restrict__ inv_xi, const float* __restrict__ budgets_b,
    const float* __restrict__ budgets_c, float margin,
    const int* __restrict__ order, const int* __restrict__ starts,
    const int* __restrict__ counts, int n, int n_servers, int group,
    int sync, int outer, int inner, int final_inner,
    float* __restrict__ scratch, unsigned long long* gslots,
    float* __restrict__ out_b, float* __restrict__ out_c) {
  __shared__ float red[2 * kFillThreads];
  __shared__ float xslot[2];
  int parity = 0;
  for (int s = blockIdx.x / group; s < n_servers; s += gridDim.x / group) {
    const int start = starts[s];
    Team team = make_team(s, group, sync, counts[s], red, xslot, gslots,
                          parity);
    const Rows w = rows_of(scratch, n, start);
    const int* seg = order + start;
    int idx[kSlots];
    gather(team, seg, idx);
    const float B = budgets_b[s];
    float b[kSlots];
    bandwidth_fill(team, k, p, pol, mu, B, seg, idx, w, outer, inner,
                   final_inner, out_b, b);
    float lam[kSlots];
#pragma unroll
    for (int r = 0; r < kSlots; ++r)
      lam[r] = r < team.cnt ? (b[r] * B) * k[idx[r]] : 1.0f;
    auto lam_of = [&](int j) {
      const int i = seg[j];
      return out_b[i] * k[i];
    };
    compute_fill(team, inv_xi, p, pol, lam, lam_of, budgets_c[s], margin,
                 seg, idx, w, outer, inner, final_inner, out_c);
    parity = team.parity;
  }
  if (sync == kSyncCluster) cg::this_cluster().sync();
}

// --------------------------------------------------------------------------
// 4. waterfill_tiled: one water-fill of a fleet the reference tiles.
//
// Replaces kernel.py:waterfill_tiled. On the TPU the tiled kernel streams
// a fleet too large for VMEM through one core tile by tile, with the
// per-camera brackets in HBM between sweeps. On this card nothing has to
// be streamed (registers hold a thread's cameras); what a large segment
// lacks is parallelism, which the team gives it: MIN's virtual server of
// 100,000 cameras runs on 128 CTAs. The same routine as kernel 2: the
// reference's switch between its two kernels (ops.tiled_group) picks the
// launch counter and the profiler name, not the schedule.
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(kFillThreads) waterfill_tiled_kernel(
    int mode, const float* __restrict__ coef, const float* __restrict__ p,
    const int* __restrict__ pol, const float* __restrict__ other,
    const float* __restrict__ budgets, float margin,
    const int* __restrict__ order, const int* __restrict__ starts,
    const int* __restrict__ counts, int n, int n_servers, int group,
    int sync, int outer, int inner, int final_inner,
    float* __restrict__ scratch, unsigned long long* gslots,
    float* __restrict__ out) {
  fill_servers(mode, coef, p, pol, other, budgets, margin, order, starts,
               counts, n, n_servers, group, sync, outer, inner, final_inner,
               scratch, gslots, out);
}

// --------------------------------------------------------------------------
// 5. baseline_argmax: the DOS and JCAB configuration scans.
//
// Replaces kernel.py:baseline_argmax. Per camera, over the M x R grid,
// latency = 1/max(lam, 1e-9) + 1/max(mu, 1e-9) with lam = b*eff/size[r],
// mu = c/xi[m, r]; DOS (mode 0) takes the argmax of acc - w * latency,
// JCAB (mode 1) the argmax of acc among configs with latency <= cap, or,
// where none qualifies, the argmin of latency. Bound on this card:
// instruction issue, then bytes (the [N, M, R] accuracy table is read
// once; two IEEE divisions and the folds, about 45 instructions an entry,
// take longer to issue than the table takes to read). Design:
// config_argmin's: a team of scan_lanes(N) lanes per camera over the flat
// (m, r) entries, xi and size in shared memory, 1/max(lam, 1e-9) once per
// (camera, r), the same float as before. Each lane folds its entries
// into (best value, best flat index) by the total order (the larger
// value, then the smaller index; within a lane the strict compare), JCAB
// also into (latency, index) by the smaller latency; the butterfly folds
// the team. JCAB falls back to the least-latency index where the best
// value is -inf: no entry met the cap (all -inf tie at flat 0, as in the
// flat argmax, and the fallback replaces it).
// --------------------------------------------------------------------------

template <int kMode, int kLanes>
__device__ __forceinline__ int baseline_scan(
    const ScanCta<kLanes>& t, const float* __restrict__ row,
    bool live, float ci, float thresh, int n_mr, int n_r) {
  const int first = t.lane < n_mr ? t.lane : kNoIndex;
  float best_val = -INFINITY;
  int best_flat = first;
  float lat_best = INFINITY;
  int lat_flat = first;
  if (live) {
    int r = t.r0;
#pragma unroll 1
    for (int j = t.lane; j < n_mr; j += kLanes) {
      const float mu = ci / t.xi_s[j];
      const float lat = t.per_r[r] + 1.0f / fmaxf(mu, 1e-9f);
      const float a = row[j];
      const float val = kMode == kModeDos ? a - thresh * lat
                                          : (lat <= thresh ? a : -INFINITY);
      if (val > best_val) {
        best_val = val;
        best_flat = j;
      }
      if (kMode == kModeJcab && lat < lat_best) {
        lat_best = lat;
        lat_flat = j;
      }
      r += t.step_r;
      if (r >= n_r) r -= n_r;
    }
  }
  team_fold<kLanes, true>(best_val, best_flat);
  if (kMode == kModeJcab) {
    team_fold<kLanes, false>(lat_best, lat_flat);
    if (best_val == -INFINITY) best_flat = lat_flat;
  }
  return best_flat;
}

template <int kLanes>
__global__ void __launch_bounds__(kBaselineThreads) baseline_argmax_kernel(
    const float* __restrict__ b, const float* __restrict__ c,
    const float* __restrict__ eff, const float* __restrict__ acc,
    const float* __restrict__ xi, const float* __restrict__ size,
    float thresh, int mode, int n, int n_m, int n_r, int* __restrict__ m_out,
    int* __restrict__ r_out) {
  extern __shared__ float smem[];
  const int n_mr = n_m * n_r;
  const ScanCta<kLanes> t(xi, size, n_mr, n_r, smem);
  const int cam = blockIdx.x * t.cams + t.local;
  const bool live = cam < n;
  const float be = live ? b[cam] * eff[cam] : 0.0f;
  const float ci = live ? c[cam] : 0.0f;
  for (int r = t.lane; r < n_r; r += kLanes)
    t.per_r[r] = 1.0f / fmaxf(be / t.size_s[r], 1e-9f);
  __syncwarp();
  const float* row = acc + static_cast<long long>(cam) * n_mr;
  const int best =
      mode == kModeDos
          ? baseline_scan<kModeDos>(t, row, live, ci, thresh, n_mr, n_r)
          : baseline_scan<kModeJcab>(t, row, live, ci, thresh, n_mr, n_r);
  if (live && t.lane == 0) {
    m_out[cam] = best / n_r;
    r_out[cam] = best % n_r;
  }
}

// Lanes per camera of a scan of n cameras on this device (kScanMinLanes
// to kScanMaxLanes); 0 where the device query fails.
int scan_lanes(int n) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  int lanes = kScanMinLanes;
  while (lanes < kScanMaxLanes &&
         static_cast<long long>(n) * lanes <
             static_cast<long long>(kScanLanesPerSm) * sms)
    lanes *= 2;
  return lanes;
}

// Launch one scan instantiation: a team of kLanes lanes per camera, a CTA
// of kThreads threads per block of kThreads / kLanes cameras.
template <int kThreads, int kLanes, typename Kernel, typename... Args>
cudaError_t launch_scan(Kernel kernel, int n, int n_m, int n_r,
                        cudaStream_t stream, Args... args) {
  static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
                "a team is a power-of-two share of a warp");
  static_assert(kThreads % 32 == 0, "whole warps");
  constexpr int kCams = kThreads / kLanes;
  const size_t bytes = sizeof(float) * scan_smem_floats(kCams, n_m * n_r, n_r);
  if (n_m < 1 || n_r < 1 || bytes > 48 * 1024) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kCams - 1) / kCams);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Launch kernel_at(integral_constant<int, L>) at L = scan_lanes(n), in
// CTAs of kThreads threads.
template <int kThreads, typename KernelAt, typename... Args>
cudaError_t launch_scan_at(KernelAt kernel_at, int n, int n_m, int n_r,
                           cudaStream_t stream, Args... args) {
  using std::integral_constant;
  switch (scan_lanes(n)) {
    case 2:
      return launch_scan<kThreads, 2>(kernel_at(integral_constant<int, 2>()),
                                      n, n_m, n_r, stream, args...);
    case 4:
      return launch_scan<kThreads, 4>(kernel_at(integral_constant<int, 4>()),
                                      n, n_m, n_r, stream, args...);
    case 8:
      return launch_scan<kThreads, 8>(kernel_at(integral_constant<int, 8>()),
                                      n, n_m, n_r, stream, args...);
    case 16:
      return launch_scan<kThreads, 16>(
          kernel_at(integral_constant<int, 16>()), n, n_m, n_r, stream,
          args...);
    case 32:
      return launch_scan<kThreads, 32>(
          kernel_at(integral_constant<int, 32>()), n, n_m, n_r, stream,
          args...);
    default:
      return cudaErrorInvalidValue;
  }
}

// Launch a water-fill kernel, `group` CTAs of `threads` per server: a
// plain launch (group 1) or clusters of `group` CTAs, one per server; or
// a cooperative launch (every CTA co-resident, as the grid barrier needs)
// of as many teams as fit, each walking the servers s = team (mod teams).
template <typename Kernel, typename... Args>
cudaError_t launch_fill(Kernel kernel, int n_servers, int group,
                        int threads, int sync, cudaStream_t stream,
                        Args... args) {
  const bool pow2 = (group & (group - 1)) == 0 &&
                    (threads & (threads - 1)) == 0;
  if (group < 1 || group > kMaxGroup || threads < 32 ||
      threads > kFillThreads || !pow2 || (group == 1) != (sync == kSyncNone) ||
      sync < kSyncNone || sync > kSyncGrid ||
      (sync == kSyncCluster && group > kMaxCluster))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_servers * group);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (sync == kSyncCluster) {
    if (group > 8) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = group;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  } else if (sync == kSyncGrid) {
    // Every CTA co-resident: as many teams as fit, each walking servers.
    int per_sm = 0, sms = 0, dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, 0);
    if (err != cudaSuccess) return err;
    const int fit = per_sm * sms / group;
    const int teams = fit < n_servers ? fit : n_servers;
    if (teams < 1) return cudaErrorCooperativeLaunchTooLarge;
    cfg.gridDim = dim3(teams * group);
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

const char* slot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int slot_config_argmin(const float* b, const float* c, const float* eff,
                       const float* acc, const float* xi, const float* size,
                       const float* q, float v, float n_total, int n, int n_m,
                       int n_r, int* r_out, int* m_out, int* pol_out,
                       cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  return launch_scan_at<kConfigThreads>(
      [](auto lanes) { return config_argmin_kernel<decltype(lanes)::value>; },
      n, n_m, n_r, stream, b, c, eff, acc, xi, size, q, v, n_total, n, n_m,
      n_r, r_out, m_out, pol_out);
}

int slot_waterfill(int mode, const float* coef, const float* p,
                   const int* pol, const float* other, const float* budgets,
                   float margin, const int* order, const int* starts,
                   const int* counts, int n, int n_servers, int group,
                   int threads, int sync, int outer, int inner,
                   int final_inner, float* scratch,
                   unsigned long long* gslots, float* out,
                   cudaStream_t stream) {
  if (n == 0 || n_servers == 0) return cudaSuccess;
  return launch_fill(waterfill_kernel, n_servers, group, threads, sync,
                     stream, mode, coef, p, pol, other, budgets, margin,
                     order, starts, counts, n, n_servers, group, sync, outer,
                     inner, final_inner, scratch, gslots, out);
}

int slot_waterfill_pair(const float* k, const float* p, const int* pol,
                        const float* mu, const float* inv_xi,
                        const float* budgets_b, const float* budgets_c,
                        float margin, const int* order, const int* starts,
                        const int* counts, int n, int n_servers, int group,
                        int threads, int sync, int outer, int inner,
                        int final_inner, float* scratch,
                        unsigned long long* gslots, float* out_b, float* out_c,
                        cudaStream_t stream) {
  if (n == 0 || n_servers == 0) return cudaSuccess;
  return launch_fill(waterfill_pair_kernel, n_servers, group, threads, sync,
                     stream, k, p, pol, mu, inv_xi, budgets_b, budgets_c,
                     margin, order, starts, counts, n, n_servers, group, sync,
                     outer, inner, final_inner, scratch, gslots, out_b,
                     out_c);
}

int slot_waterfill_tiled(int mode, const float* coef, const float* p,
                         const int* pol, const float* other,
                         const float* budgets, float margin, const int* order,
                         const int* starts, const int* counts, int n,
                         int n_servers, int group, int threads, int sync,
                         int outer, int inner, int final_inner,
                         float* scratch, unsigned long long* gslots,
                         float* out, cudaStream_t stream) {
  if (n == 0 || n_servers == 0) return cudaSuccess;
  return launch_fill(waterfill_tiled_kernel, n_servers, group, threads, sync,
                     stream, mode, coef, p, pol, other, budgets, margin,
                     order, starts, counts, n, n_servers, group, sync, outer,
                     inner, final_inner, scratch, gslots, out);
}

int slot_scan_lanes(int n) { return scan_lanes(n); }

int slot_baseline_argmax(const float* b, const float* c, const float* eff,
                         const float* acc, const float* xi, const float* size,
                         float thresh, int mode, int n, int n_m, int n_r,
                         int* m_out, int* r_out, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  return launch_scan_at<kBaselineThreads>(
      [](auto lanes) { return baseline_argmax_kernel<decltype(lanes)::value>; },
      n, n_m, n_r, stream, b, c, eff, acc, xi, size, thresh, mode, n, n_m,
      n_r, m_out, r_out);
}

}  // extern "C"
