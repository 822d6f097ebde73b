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

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-12f;
constexpr float kLogNuLo = -34.0f;
constexpr float kLogNuHi = 34.0f;
constexpr int kLCFSP = 1;
constexpr int kModeBandwidth = 0;
constexpr int kModeCompute = 1;
constexpr int kConfigThreads = 128;
constexpr int kFillThreads = 256;
constexpr int kTiledThreads = 512;
constexpr int kMaxGroup = 8;          // CTAs per server: a portable cluster
constexpr int kBaselineThreads = 128;
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
// 1. config_argmin (Algorithm 1 line 3).
//
// Replaces kernel.py:config_argmin. Bound on this card: bytes (the
// [N, M, R] accuracy table is the only large operand and is read once;
// about 45 floating-point operations per (camera, model, resolution) stay
// far below the FP32 rate). Design: one thread per camera over a 1-D grid
// with a masked ragged edge; the M x R x 2 scores are folded in registers
// into (best value, best flat index), so the [N, M, R, 2] score tensor is
// never written. The fold breaks ties exactly as the flat argmin does:
// FCFS unless LCFSP is strictly lower, the first resolution of a model's
// minimum, strict < across models.
// --------------------------------------------------------------------------

__global__ void config_argmin_kernel(
    const float* __restrict__ b, const float* __restrict__ c,
    const float* __restrict__ eff, const float* __restrict__ acc,
    const float* __restrict__ xi, const float* __restrict__ size,
    const float* __restrict__ q_ptr, float v, float n_total, int n, int n_m,
    int n_r, int* __restrict__ r_out, int* __restrict__ m_out,
    int* __restrict__ pol_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float q = *q_ptr;
  const float be = b[i] * eff[i];
  const float ci = c[i];
  const float* acc_i = acc + static_cast<long long>(i) * n_m * n_r;
  float best_val = INFINITY;
  int best_flat = 0;
  for (int m = 0; m < n_m; ++m) {
    float loc_val = 0.0f;
    int loc_flat = 0;
    for (int r = 0; r < n_r; ++r) {
      const float lam = be / size[r];
      const float mu = ci / xi[m * n_r + r];
      const float a = acc_i[m * n_r + r];
      const float p = fmaxf(a, 1e-3f);
      const float s_f = (v * aopi_fcfs(lam, mu, p) - q * a) / n_total;
      const float s_l = (v * aopi_lcfsp(lam, mu, p) - q * a) / n_total;
      const bool l_wins = s_l < s_f;
      const float val = l_wins ? s_l : s_f;
      if (r == 0 || val < loc_val) {
        loc_val = val;
        loc_flat = m * (n_r * 2) + r * 2 + (l_wins ? 1 : 0);
      }
    }
    if (loc_val < best_val) {
      best_val = loc_val;
      best_flat = loc_flat;
    }
  }
  m_out[i] = best_flat / (n_r * 2);
  r_out[i] = (best_flat / 2) % n_r;
  pol_out[i] = best_flat % 2;
}

// --------------------------------------------------------------------------
// Water-filling (Algorithm 1 lines 4/5), shared by kernels 2 and 3.
//
// One CTA owns one server: the cameras of server s are the contiguous
// segment order[start[s] : start[s] + count[s]] of the stably sorted
// camera order (ops.ServerLayout). Per-server fill sums are block
// reductions over that segment (segment_sum below), which replace the
// Pallas kernels' [S, Np] membership products. The per-server Illinois
// state (duals a/b, residuals fa/fb) is held identically by every thread
// of the CTA, updated from the reduction result that all threads read.
// The per-camera brackets (xa, xb), the current evaluation x, the
// per-camera bound and the reduction buffer live in a [5, N] global
// scratch indexed by sorted position, so a segment of any length works
// with one CTA.
//
// The reduction is a pairwise halving tree over the segment zero-padded to
// a power of two, the order allocate.tree_segment_sum follows, so the
// kernels and their plain versions add in the same order and agree
// bitwise; the plain version needs no atomics either.
//
// Bound on this card: neither bytes nor operations. Each dual evaluation
// depends on the previous one's reduction, and each FCFS camera runs a
// bisection of dependent h evaluations, so the time is a serial chain of
// outer_iters + 3 evaluations of up to inner_iters + 4 dependent steps
// each, plus a log2(segment) reduction per evaluation. Design: the chain
// runs entirely inside one launch with no trip to the host, and the
// cameras of a server spread over the CTA's threads. At a few servers
// only a few SMs work (3 of 132 at S = 3); kernel 4 spreads a server over
// a cluster of CTAs.
// --------------------------------------------------------------------------

struct Cam {
  float scale;   // lam (or mu) at the full server budget
  float p;
  float other;   // the fixed rate of the other resource
  float lo;
  float hi;
  bool is_l;
};

// Sum of src[0:count) by a pairwise halving tree: pad to P = 2^k >= count
// with zeros, then x[j] += x[j + h] for h = P/2, P/4, ..., 1. Every thread
// of the CTA calls it and gets the sum; buf holds max(1, P/2) floats.
__device__ float segment_sum(const float* src, int count, float* buf) {
  __syncthreads();                 // src complete; buf free from last call
  if (count <= 1) return count == 1 ? src[0] : 0.0f;
  int h = 1;
  while (2 * h < count) h <<= 1;   // h = P / 2
  for (int j = threadIdx.x; j < h; j += blockDim.x)
    buf[j] = src[j] + (j + h < count ? src[j + h] : 0.0f);
  __syncthreads();
  for (h >>= 1; h >= 1; h >>= 1) {
    for (int j = threadIdx.x; j < h; j += blockDim.x)
      buf[j] = buf[j] + buf[j + h];
    __syncthreads();
  }
  return buf[0];
}

// The cameras of one server split over the G CTAs of a thread-block
// cluster by residue class: CTA g owns segment positions j = g (mod G).
// class_sum folds class g by the halving tree of width P/G (P = 2^k >=
// count), the same pairs the full tree of segment_sum adds in its first
// log2(P/G) levels; folding the G class sums by the halving tree of width
// G then reproduces segment_sum's result bit for bit. Class g's tree uses
// buf[g * P/(2G) : (g+1) * P/(2G)), inside the segment's own row.
__device__ float class_sum(const float* src, int count, int g, int G,
                           float* buf) {
  __syncthreads();                 // src complete; buf free from last call
  if (count <= 1) return (g == 0 && count == 1) ? src[0] : 0.0f;
  int p = 1;
  while (p < count) p <<= 1;
  if (p <= G) return g < count ? src[g] : 0.0f;   // one element at most
  int h = p / G / 2;               // half the class's width, >= 1
  const int cnt = (count - g + G - 1) / G;        // elements of class g
  float* b = buf + g * h;
  for (int i = threadIdx.x; i < h; i += blockDim.x)
    b[i] = src[g + G * i] + (i + h < cnt ? src[g + G * (i + h)] : 0.0f);
  __syncthreads();
  for (h >>= 1; h >= 1; h >>= 1) {
    for (int i = threadIdx.x; i < h; i += blockDim.x) b[i] = b[i] + b[i + h];
    __syncthreads();
  }
  return b[0];
}

// Who works on one server's segment, and how its fill sums are taken.
// BlockTeam: one CTA (waterfill, waterfill_pair). ClusterTeam: the G CTAs
// of a cluster (waterfill_tiled); each CTA publishes its class sum in its
// shared memory, one cluster barrier later every thread of every CTA reads
// the G partials through distributed shared memory and folds them in the
// same order, so all hold the same total. The partials alternate between
// two slots, so the next sum can start before the slowest reader is done
// with this one, and one barrier per sum suffices.
struct BlockTeam {
  __device__ int first() const { return threadIdx.x; }
  __device__ int stride() const { return blockDim.x; }
  __device__ float sum(const float* src, int count, float* buf) {
    return segment_sum(src, count, buf);
  }
  __device__ void finish() {}
};

struct ClusterTeam {
  int g;          // rank of this CTA in the cluster
  int G;          // CTAs per server, a power of two <= kMaxGroup
  float* slots;   // __shared__ float[2]
  int parity;

  __device__ int first() const { return g + G * threadIdx.x; }
  __device__ int stride() const { return G * blockDim.x; }
  __device__ float sum(const float* src, int count, float* buf) {
    cg::cluster_group cluster = cg::this_cluster();
    const float part = class_sum(src, count, g, G, buf);
    if (threadIdx.x == 0) slots[parity] = part;
    cluster.sync();
    float v[kMaxGroup];
    for (int r = 0; r < G; ++r)
      v[r] = *cluster.map_shared_rank(slots + parity, r);
    for (int h = G / 2; h >= 1; h >>= 1)
      for (int j = 0; j < h; ++j) v[j] = v[j] + v[j + h];
    parity ^= 1;
    return v[0];
  }
  // No CTA may exit while another can still read its partials.
  __device__ void finish() { cg::this_cluster().sync(); }
};

template <int MODE>
__device__ __forceinline__ float h_fn(float x, const Cam& c) {
  float d;
  if (MODE == kModeBandwidth) {
    const float lam = fmaxf(c.scale * x, kEps);
    d = c.is_l ? d_lcfsp_dlam(lam, c.p)
               : d_fcfs_dlam(fminf(lam, 0.999f * c.other), c.other, c.p);
  } else {
    const float mu = fmaxf(c.scale * x, kEps);
    d = c.is_l ? d_lcfsp_dmu(mu, c.p)
               : d_fcfs_dmu(fminf(c.other, 0.999f * mu), mu, c.p);
  }
  return fmaxf(-d * c.scale, 0.0f);
}

// x(nu) clipped to [lo, hi]: the LCFSP closed form, or for FCFS the
// largest x in [blo, bhi] with h(x) >= nu by bisection
// (allocate._waterfill.alloc_at).
template <int MODE>
__device__ __forceinline__ float alloc_at(float nu, float blo, float bhi,
                                          int iters, const Cam& c) {
  float x;
  if (c.is_l) {
    x = MODE == kModeBandwidth
            ? sqrtf((1.0f + 1.0f / c.p) / fmaxf(c.scale * nu, kEps))
            : sqrtf(1.0f / fmaxf(c.p * c.scale * nu, kEps));
  } else {
    float a = blo, b = bhi;
    for (int k = 0; k < iters; ++k) {
      const float mid = 0.5f * (a + b);
      const bool up = h_fn<MODE>(mid, c) >= nu;
      a = up ? mid : a;
      b = up ? b : mid;
    }
    x = 0.5f * (a + b);
  }
  return fminf(fmaxf(x, c.lo), c.hi);
}

__device__ __forceinline__ void bracket(float xa, float xb, const Cam& c,
                                        float* blo, float* bhi) {
  const float pad = 0.25f * fmaxf(xa - xb, 0.0f) + 1e-7f;
  *blo = fmaxf(c.lo, xb - pad);
  *bhi = fminf(c.hi, xa + pad);
}

// Scratch rows of one segment, each [N] in sorted position.
struct Rows {
  float* xa;
  float* xb;
  float* xt;
  float* bound;   // bandwidth: per-camera cap hi; compute: floor lo
  float* buf;     // segment_sum's tree
};

__device__ __forceinline__ Rows rows_of(float* scratch, int n, int start) {
  return Rows{scratch + start, scratch + n + start, scratch + 2 * n + start,
              scratch + 3 * n + start, scratch + 4 * n + start};
}

// The Illinois dual search of one server (kernel.py:_illinois_waterfill,
// allocate._waterfill): the same iteration budgets, inner_iters + 4 for the
// two endpoint fills, inner_iters per Illinois step, final_inner_iters for
// the final allocation, which is left in w.xt[0:count]. `load(j)` returns
// the parameters of the j-th camera of the segment; `team` says which
// positions this thread owns and takes the fill sums.
template <int MODE, class Team, class Load>
__device__ void illinois_waterfill(Team& team, const Load& load, int count,
                                   Rows w, int outer_iters, int inner_iters,
                                   int final_inner_iters) {
  const float nu_lo = expf(kLogNuLo);
  const float nu_hi = expf(kLogNuHi);
  for (int j = team.first(); j < count; j += team.stride()) {
    const Cam c = load(j);
    float blo, bhi;
    bracket(c.hi, c.lo, c, &blo, &bhi);
    w.xa[j] = alloc_at<MODE>(nu_lo, blo, bhi, inner_iters + 4, c);
    w.xb[j] = alloc_at<MODE>(nu_hi, blo, bhi, inner_iters + 4, c);
  }
  float a = kLogNuLo, b = kLogNuHi;
  float fa = team.sum(w.xa, count, w.buf) - 1.0f;
  float fb = team.sum(w.xb, count, w.buf) - 1.0f;
  for (int it = 0; it < outer_iters; ++it) {
    const float denom = fa - fb;
    float t = fabsf(denom) > 1e-12f ? fa / denom : 0.5f;
    t = fminf(fmaxf(t, 0.05f), 0.95f);
    const float mid = a + t * (b - a);
    const float nu = expf(mid);
    for (int j = team.first(); j < count; j += team.stride()) {
      const Cam c = load(j);
      float blo, bhi;
      bracket(w.xa[j], w.xb[j], c, &blo, &bhi);
      w.xt[j] = alloc_at<MODE>(nu, blo, bhi, inner_iters, c);
    }
    const float f = team.sum(w.xt, count, w.buf) - 1.0f;
    const bool over = f > 0.0f;        // over budget -> raise the price
    for (int j = team.first(); j < count; j += team.stride()) {
      if (over) w.xa[j] = w.xt[j];
      else w.xb[j] = w.xt[j];
    }
    a = over ? mid : a;
    b = over ? b : mid;
    const float fa_next = over ? f : 0.5f * fa;   // Illinois halving of
    const float fb_next = over ? 0.5f * fb : f;   // the retained endpoint
    fa = fa_next;
    fb = fb_next;
  }
  const float nu = expf(0.5f * (a + b));
  for (int j = team.first(); j < count; j += team.stride()) {
    const Cam c = load(j);
    float blo, bhi;
    bracket(w.xa[j], w.xb[j], c, &blo, &bhi);
    w.xt[j] = alloc_at<MODE>(nu, blo, bhi, final_inner_iters, c);
  }
}

// Line 4: normalized bandwidth of one server, written as Hz to out[cam].
template <class Team>
__device__ void bandwidth_segment(Team& team, const float* k, const float* p,
                                  const int* pol, const float* mu, float B,
                                  const int* seg, int count, Rows w,
                                  int outer, int inner, int final_inner,
                                  float* out) {
  for (int j = team.first(); j < count; j += team.stride()) {
    const int i = seg[j];
    w.bound[j] = pol[i] == kLCFSP
                     ? 1.0f
                     : fminf(argmin_lam_fcfs(mu[i], p[i]) /
                                 fmaxf(k[i] * B, kEps),
                             1.0f);
  }
  auto load = [&](int j) {
    const int i = seg[j];
    return Cam{k[i] * B, p[i], mu[i], 1e-9f, w.bound[j], pol[i] == kLCFSP};
  };
  illinois_waterfill<kModeBandwidth>(team, load, count, w, outer, inner,
                                     final_inner);
  for (int j = team.first(); j < count; j += team.stride())
    out[seg[j]] = w.xt[j] * B;
}

// Line 5: normalized compute of one server with the FCFS stability floors
// (mu >= margin * lam, scaled down where they alone exceed the budget),
// written as FLOPS to out[cam]. `lam_of(j)` gives the camera's arrival rate.
template <class Team, class Lam>
__device__ void compute_segment(Team& team, const float* inv_xi,
                                const float* p, const int* pol,
                                const Lam& lam_of, float C, float margin,
                                const int* seg, int count, Rows w, int outer,
                                int inner, int final_inner, float* out) {
  for (int j = team.first(); j < count; j += team.stride()) {
    const int i = seg[j];
    w.bound[j] = pol[i] == kLCFSP
                     ? 1e-9f
                     : margin * lam_of(j) / fmaxf(inv_xi[i] * C, kEps);
  }
  const float floor_tot = team.sum(w.bound, count, w.buf);
  const float fac = fminf(1.0f / fmaxf(floor_tot, kEps), 1.0f);
  for (int j = team.first(); j < count; j += team.stride())
    w.bound[j] = fminf(fmaxf(w.bound[j] * fac, 1e-9f), 1.0f);
  auto load = [&](int j) {
    const int i = seg[j];
    return Cam{inv_xi[i] * C, p[i], lam_of(j), w.bound[j], 1.0f,
               pol[i] == kLCFSP};
  };
  illinois_waterfill<kModeCompute>(team, load, count, w, outer, inner,
                                   final_inner);
  for (int j = team.first(); j < count; j += team.stride())
    out[seg[j]] = w.xt[j] * C;
}

// One water-fill of server s in `mode` by `team` (waterfill and
// waterfill_tiled). coef is k = eff/size (bandwidth) or 1/xi (compute);
// other is mu (bandwidth) or lam (compute).
template <class Team>
__device__ void fill_server(Team& team, int s, int mode, const float* coef,
                            const float* p, const int* pol,
                            const float* other, const float* budgets,
                            float margin, const int* order,
                            const int* starts, const int* counts, int n,
                            int outer, int inner, int final_inner,
                            float* scratch, float* out) {
  const int start = starts[s];
  const int count = counts[s];
  const Rows w = rows_of(scratch, n, start);
  const int* seg = order + start;
  if (mode == kModeBandwidth) {
    bandwidth_segment(team, coef, p, pol, other, budgets[s], seg, count, w,
                      outer, inner, final_inner, out);
  } else {
    auto lam_of = [&](int j) { return other[seg[j]]; };
    compute_segment(team, coef, p, pol, lam_of, budgets[s], margin, seg,
                    count, w, outer, inner, final_inner, out);
  }
}

// --------------------------------------------------------------------------
// 2. waterfill: one water-fill, bandwidth (mode 0) or compute (mode 1).
//
// Replaces kernel.py:waterfill. One CTA per server.
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(kFillThreads) waterfill_kernel(
    int mode, const float* __restrict__ coef, const float* __restrict__ p,
    const int* __restrict__ pol, const float* __restrict__ other,
    const float* __restrict__ budgets, float margin,
    const int* __restrict__ order, const int* __restrict__ starts,
    const int* __restrict__ counts, int n, int outer, int inner,
    int final_inner, float* __restrict__ scratch, float* __restrict__ out) {
  BlockTeam team;
  fill_server(team, blockIdx.x, mode, coef, p, pol, other, budgets, margin,
              order, starts, counts, n, outer, inner, final_inner, scratch,
              out);
}

// --------------------------------------------------------------------------
// 3. waterfill_pair: lines 4 and 5 in one launch.
//
// Replaces kernel.py:waterfill_pair. The bandwidth water-fill writes b;
// then, in the same CTA, the arrival rate lam = b * k, the FCFS floors and
// their per-server rescale, and the compute water-fill. b is read back
// by the thread that wrote it (the j -> thread map is the same in both
// phases), after a barrier.
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(kFillThreads) waterfill_pair_kernel(
    const float* __restrict__ k, const float* __restrict__ p,
    const int* __restrict__ pol, const float* __restrict__ mu,
    const float* __restrict__ inv_xi, const float* __restrict__ budgets_b,
    const float* __restrict__ budgets_c, float margin,
    const int* __restrict__ order, const int* __restrict__ starts,
    const int* __restrict__ counts, int n, int outer, int inner,
    int final_inner, float* __restrict__ scratch, float* __restrict__ out_b,
    float* __restrict__ out_c) {
  const int s = blockIdx.x;
  const int start = starts[s];
  const int count = counts[s];
  const Rows w = rows_of(scratch, n, start);
  const int* seg = order + start;
  BlockTeam team;
  bandwidth_segment(team, k, p, pol, mu, budgets_b[s], seg, count, w, outer,
                    inner, final_inner, out_b);
  __syncthreads();
  auto lam_of = [&](int j) {
    const int i = seg[j];
    return out_b[i] * k[i];
  };
  compute_segment(team, inv_xi, p, pol, lam_of, budgets_c[s], margin, seg,
                  count, w, outer, inner, final_inner, out_c);
}

// --------------------------------------------------------------------------
// 4. waterfill_tiled: one water-fill with each server's segment split over
//    a cluster of G CTAs.
//
// Replaces kernel.py:waterfill_tiled. On the TPU the tiled kernel streams
// a fleet too large for VMEM through one core tile by tile, with the
// per-camera brackets in HBM between sweeps. On this card nothing has to
// be streamed (the brackets already live in the [5, N] global scratch);
// what a large segment lacks is parallelism: one CTA per server puts the
// whole virtual server (S = 1) on one SM of 132. So here a server's
// segment is split over the G CTAs of a thread-block cluster, G a power
// of two <= 8 chosen on the host from N, S and the tile (about `tile`
// cameras per CTA), never from the per-server counts on the device. CTA g
// owns positions j = g (mod G) (ClusterTeam); each dual evaluation's fill
// sum is one class sum per CTA plus one cluster barrier, and the residue
// split keeps the sum bitwise equal to segment_sum and to the plain
// version. Bound as kernel 2: the serial chain of dual evaluations; G CTAs
// shorten each evaluation's per-camera work G-fold and add a cluster
// barrier to it.
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(kTiledThreads) waterfill_tiled_kernel(
    int mode, const float* __restrict__ coef, const float* __restrict__ p,
    const int* __restrict__ pol, const float* __restrict__ other,
    const float* __restrict__ budgets, float margin,
    const int* __restrict__ order, const int* __restrict__ starts,
    const int* __restrict__ counts, int n, int group, int outer, int inner,
    int final_inner, float* __restrict__ scratch, float* __restrict__ out) {
  __shared__ float slots[2];
  ClusterTeam team{static_cast<int>(cg::this_cluster().block_rank()), group,
                   slots, 0};
  fill_server(team, blockIdx.x / group, mode, coef, p, pol, other, budgets,
              margin, order, starts, counts, n, outer, inner, final_inner,
              scratch, out);
  team.finish();
}

// --------------------------------------------------------------------------
// 5. baseline_argmax: the DOS and JCAB configuration scans.
//
// Replaces kernel.py:baseline_argmax. Per camera, over the M x R grid,
// latency = 1/max(lam, 1e-9) + 1/max(mu, 1e-9) with lam = b*eff/size[r],
// mu = c/xi[m, r]; DOS (mode 0) takes the argmax of acc - w * latency,
// JCAB (mode 1) the argmax of acc among configs with latency <= cap, or,
// where none qualifies, the argmin of latency. Bound on this card: bytes
// (the [N, M, R] accuracy table is read once; about 10 operations per
// entry). Design: one thread per camera, as config_argmin; the scores are
// folded in registers into (best value, best flat index), first r within
// a model and strict > across models, the order of a flat m-major argmax,
// and JCAB's fallback in a second fold with strict <.
// --------------------------------------------------------------------------

__global__ void baseline_argmax_kernel(
    const float* __restrict__ b, const float* __restrict__ c,
    const float* __restrict__ eff, const float* __restrict__ acc,
    const float* __restrict__ xi, const float* __restrict__ size,
    float thresh, int mode, int n, int n_m, int n_r, int* __restrict__ m_out,
    int* __restrict__ r_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float be = b[i] * eff[i];
  const float ci = c[i];
  const float* acc_i = acc + static_cast<long long>(i) * n_m * n_r;
  float best_val = -INFINITY;
  int best_flat = 0;
  float lat_best = INFINITY;
  int lat_flat = 0;
  for (int m = 0; m < n_m; ++m) {
    float row_val = 0.0f, row_lat = 0.0f;
    int row_r = 0, lat_r = 0;
    for (int r = 0; r < n_r; ++r) {
      const float lam = be / size[r];
      const float mu = ci / xi[m * n_r + r];
      const float lat = 1.0f / fmaxf(lam, 1e-9f) + 1.0f / fmaxf(mu, 1e-9f);
      const float a = acc_i[m * n_r + r];
      const float val = mode == kModeDos ? a - thresh * lat
                                         : (lat <= thresh ? a : -INFINITY);
      if (r == 0 || val > row_val) {
        row_val = val;
        row_r = r;
      }
      if (r == 0 || lat < row_lat) {
        row_lat = lat;
        lat_r = r;
      }
    }
    if (row_val > best_val) {
      best_val = row_val;
      best_flat = m * n_r + row_r;
    }
    if (row_lat < lat_best) {
      lat_best = row_lat;
      lat_flat = m * n_r + lat_r;
    }
  }
  if (mode == kModeJcab && best_val == -INFINITY) best_flat = lat_flat;
  m_out[i] = best_flat / n_r;
  r_out[i] = best_flat % n_r;
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
  const int blocks = (n + kConfigThreads - 1) / kConfigThreads;
  config_argmin_kernel<<<blocks, kConfigThreads, 0, stream>>>(
      b, c, eff, acc, xi, size, q, v, n_total, n, n_m, n_r, r_out, m_out,
      pol_out);
  return cudaGetLastError();
}

int slot_waterfill(int mode, const float* coef, const float* p,
                   const int* pol, const float* other, const float* budgets,
                   float margin, const int* order, const int* starts,
                   const int* counts, int n, int n_servers, int outer,
                   int inner, int final_inner, float* scratch, float* out,
                   cudaStream_t stream) {
  if (n == 0 || n_servers == 0) return cudaSuccess;
  waterfill_kernel<<<n_servers, kFillThreads, 0, stream>>>(
      mode, coef, p, pol, other, budgets, margin, order, starts, counts, n,
      outer, inner, final_inner, scratch, out);
  return cudaGetLastError();
}

int slot_waterfill_pair(const float* k, const float* p, const int* pol,
                        const float* mu, const float* inv_xi,
                        const float* budgets_b, const float* budgets_c,
                        float margin, const int* order, const int* starts,
                        const int* counts, int n, int n_servers, int outer,
                        int inner, int final_inner, float* scratch,
                        float* out_b, float* out_c, cudaStream_t stream) {
  if (n == 0 || n_servers == 0) return cudaSuccess;
  waterfill_pair_kernel<<<n_servers, kFillThreads, 0, stream>>>(
      k, p, pol, mu, inv_xi, budgets_b, budgets_c, margin, order, starts,
      counts, n, outer, inner, final_inner, scratch, out_b, out_c);
  return cudaGetLastError();
}

int slot_waterfill_tiled(int mode, const float* coef, const float* p,
                         const int* pol, const float* other,
                         const float* budgets, float margin, const int* order,
                         const int* starts, const int* counts, int n,
                         int n_servers, int group, int outer, int inner,
                         int final_inner, float* scratch, float* out,
                         cudaStream_t stream) {
  if (n == 0 || n_servers == 0) return cudaSuccess;
  if (group < 1 || group > kMaxGroup || (group & (group - 1)) != 0)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_servers * group);
  cfg.blockDim = dim3(kTiledThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = group;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, waterfill_tiled_kernel, mode, coef, p, pol, other, budgets,
      margin, order, starts, counts, n, group, outer, inner, final_inner,
      scratch, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

int slot_baseline_argmax(const float* b, const float* c, const float* eff,
                         const float* acc, const float* xi, const float* size,
                         float thresh, int mode, int n, int n_m, int n_r,
                         int* m_out, int* r_out, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const int blocks = (n + kBaselineThreads - 1) / kBaselineThreads;
  baseline_argmax_kernel<<<blocks, kBaselineThreads, 0, stream>>>(
      b, c, eff, acc, xi, size, thresh, mode, n, n_m, n_r, m_out, r_out);
  return cudaGetLastError();
}

}  // extern "C"
