// Hand-written Hopper (sm_90a) kernels of the serving data plane.
//
// Neither replaces a Pallas TPU kernel: in the JAX package both loops are
// jitted lax.scans with no kernel of their own.
//
//   gi_g1_window_kernel <- src/repro/core/queues.py:_window_sim (330-420)
//   tick_scan_kernel    <- src/repro/serving/tick_plane.py:_tick_scan_impl
//                          (94-162)
//
// In PyTorch each step of either loop is ~20 elementwise launches over a
// few hundred lanes, and a window runs tens of thousands of steps (49,152
// frames for a 300 s epoch of the paper's setting): a million launches a
// window. Here each loop is one launch, its carry in registers.
//
// What bounds them: both are serial recurrences per lane (each frame's
// arrival, service start and age segment depend on the previous frame's),
// so a window takes at least F times the latency of one step of the
// chain; there are only E*N lanes (240 at the paper size, 256 in the
// scenario sweep), far too few to fill the card, so neither is near the
// card's byte or operation rate.
//
// gi_g1_window: one warp per (epoch, stream) lane. The warp folds the
// stream index into its epoch's key (fold_in: threefry-2x32 of [0, i]);
// then its 32 threads draw 32 frames' uniforms (threefry-2x32, the JAX
// package's partitionable bits: element (row j, frame f) at counter
// j*F + f under the lane's key) and
// turn them into delays in parallel into shared memory; thread 0 then
// walks the recurrence over those 32 frames in order. No [E*N, k, F]
// uniform tensor is ever stored. The effective horizon min(horizon, sum T)
// is needed inside the walk, so a first pass regenerates T and thread 0
// sums it serially (the arrival recurrence's own sum).
//
// tick_scan: one thread per lane over the host's draws T, O, coin
// [S, F] (float64); a first pass sums T serially (np.cumsum's last
// element), the second replays the DES's per-lane bookkeeping and adds
// each tick's age-area terms as area + (t1 + t2), the host's order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (repro_torch/kernels/_build.py).
// -fmad=false keeps every a*b+c as two rounded operations, as the plain
// PyTorch versions (one operation per launch) compute them; no fast math,
// so division is IEEE and log1p, exp, log and pow are libdevice's, the
// functions PyTorch's own CUDA operators call. So both kernels equal
// their plain versions bitwise, apart from lognormal's inverse normal CDF
// (ndtri below: PyTorch's Cephes polynomial, its contractions written as
// explicit fma; held to a tolerance all the same).
//
// Each entry point is extern "C", launches on the caller's stream,
// allocates nothing, and returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWindowWarps = 4;      // lanes per gi_g1_window CTA
constexpr int kTickThreads = 128;    // lanes per tick_scan CTA

// Delay families, in the order of queues.DELAY_MODELS.
constexpr int kMM1 = 0;
constexpr int kUniform = 1;
constexpr int kGamma = 2;
constexpr int kLognormal = 3;
constexpr int kWeibull = 4;

// The families' constants, all from queues at run time
// (kernel.family_constants): the uniform's low end and width per unit
// mean, the gamma shape (an Erlang count: that many uniforms a delay),
// lognormal's sigma^2 / 2 and sigma, weibull's 1 / Gamma(1 + 1/k) and 1/k.
struct Family {
  double uniform_lo, uniform_width, gamma_shape, lognormal_half_var,
      lognormal_sigma, weibull_inv_gamma, weibull_power;
};

// Uniform rows per delay (queues._n_uniforms: a frame draws T's, O's and
// the coin's row).
template <int kModel>
__device__ __forceinline__ int delay_rows(const Family& fam) {
  return kModel == kGamma ? static_cast<int>(fam.gamma_shape) : 1;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ int rotation(int round, int j) {
  return (round & 1) ? (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24)
                     : (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6);
}

// Threefry-2x32, 20 rounds, as core/threefry.py.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rotation(i, j));
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

__device__ __forceinline__ float bits_to_uniform(float, uint32_t y0,
                                                 uint32_t y1) {
  return __uint_as_float(((y0 ^ y1) >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ double bits_to_uniform(double, uint32_t y0,
                                                  uint32_t y1) {
  const unsigned long long bits =
      ((static_cast<unsigned long long>(y0) << 20) | (y1 >> 12)) |
      0x3FF0000000000000ull;
  return __longlong_as_double(static_cast<long long>(bits)) - 1.0;
}

template <typename T>
__device__ __forceinline__ T uniform(uint32_t k0, uint32_t k1,
                                     unsigned long long idx) {
  uint32_t x0 = static_cast<uint32_t>(idx >> 32);
  uint32_t x1 = static_cast<uint32_t>(idx);
  threefry2x32(k0, k1, x0, x1);
  return bits_to_uniform(T(0), x0, x1);
}

// PyTorch's ndtri (ATen/native/Math.h calc_ndtri, Cephes), float64, with
// the multiply-adds its CUDA build contracts written as fma.
__device__ __forceinline__ double polevl(double x, const double* a,
                                         int len) {
  double r = 0.0;
  for (int i = 0; i <= len; ++i) r = fma(r, x, a[i]);
  return r;
}

__device__ double ndtri(double y0) {
  const double s2pi = 2.50662827463100050242E0;
  const double P0[5] = {-5.99633501014107895267E1, 9.80010754185999661536E1,
                        -5.66762857469070293439E1, 1.39312609387279679503E1,
                        -1.23916583867381258016E0};
  const double Q0[9] = {1.00000000000000000000E0, 1.95448858338141759834E0,
                        4.67627912898881538453E0, 8.63602421390890590575E1,
                        -2.25462687854119370527E2, 2.00260212380060660359E2,
                        -8.20372256168333339912E1, 1.59056225126211695515E1,
                        -1.18331621121330003142E0};
  const double P1[9] = {4.05544892305962419923E0, 3.15251094599893866154E1,
                        5.71628192246421288162E1, 4.40805073893200834700E1,
                        1.46849561928858024014E1, 2.18663306850790267539E0,
                        -1.40256079171354495875E-1, -3.50424626827848203418E-2,
                        -8.57456785154685413611E-4};
  const double Q1[9] = {1.00000000000000000000E0, 1.57799883256466749731E1,
                        4.53907635128879210584E1, 4.13172038254672030440E1,
                        1.50425385692907503408E1, 2.50464946208309415979E0,
                        -1.42182922854787788574E-1, -3.80806407691578277194E-2,
                        -9.33259480895457427372E-4};
  const double P2[9] = {3.23774891776946035970E0, 6.91522889068984211695E0,
                        3.93881025292474443415E0, 1.33303460815807542389E0,
                        2.01485389549179081538E-1, 1.23716634817820021358E-2,
                        3.01581553508235416007E-4, 2.65806974686737550832E-6,
                        6.23974539184983293730E-9};
  const double Q2[9] = {1.00000000000000000000E0, 6.02427039364742014255E0,
                        3.67983563856160859403E0, 1.37702099489081330271E0,
                        2.16236993594496635890E-1, 1.34204006088543189037E-2,
                        3.28014464682127739104E-4, 2.89247864745380683936E-6,
                        6.79019408009981274425E-9};
  if (y0 == 0.0) return -INFINITY;
  if (y0 == 1.0) return INFINITY;
  if (y0 < 0.0 || y0 > 1.0) return NAN;
  bool code = true;
  double y = y0;
  if (y > 1.0 - 0.13533528323661269189) {
    y = 1.0 - y;
    code = false;
  }
  if (y > 0.13533528323661269189) {
    y = y - 0.5;
    const double y2 = y * y;
    const double x = fma(y, y2 * polevl(y2, P0, 4) / polevl(y2, Q0, 8), y);
    return x * s2pi;
  }
  double x = sqrt(-2.0 * log(y));
  const double x0 = x - log(x) / x;
  const double z = 1.0 / x;
  const double x1 = x < 8.0 ? z * polevl(z, P1, 8) / polevl(z, Q1, 8)
                            : z * polevl(z, P2, 8) / polevl(z, Q2, 8);
  x = x0 - x1;
  return code ? -x : x;
}

// One delay of mean ``mean`` from the uniforms of rows [row0, row0 + n)
// at frame f, in the operation order of queues._delays_from_uniforms.
template <typename T, int kModel>
__device__ __forceinline__ T delay(const Family& fam, uint32_t k0,
                                   uint32_t k1, int row0, long long n_frames,
                                   long long f, T mean) {
  const T u = uniform<T>(k0, k1, row0 * n_frames + f);
  if constexpr (kModel == kMM1) {
    return -log1p(-u) * mean;
  } else if constexpr (kModel == kUniform) {
    const T lo = mean * static_cast<T>(fam.uniform_lo);
    return lo + u * (mean * static_cast<T>(fam.uniform_width));
  } else if constexpr (kModel == kGamma) {
    // Erlang-k: the k exponentials' logs added in row order.
    T acc = log1p(-u);
    const int erlang = delay_rows<kModel>(fam);
    for (int j = 1; j < erlang; ++j) {
      acc = acc + log1p(-uniform<T>(k0, k1, (row0 + j) * n_frames + f));
    }
    return -acc * (mean / static_cast<T>(fam.gamma_shape));
  } else if constexpr (kModel == kLognormal) {
    const T lo = static_cast<T>(1e-7), hi = static_cast<T>(1.0 - 1e-7);
    const T uc = fmin(fmax(u, lo), hi);
    const T m = log(mean) - static_cast<T>(fam.lognormal_half_var);
    return exp(m + static_cast<T>(fam.lognormal_sigma) *
                       static_cast<T>(ndtri(uc)));
  } else {
    // libdevice pow, as torch.pow on the card for an exponent it does
    // not turn into a product or a root (2, 3, 0.5, -0.5, -1, -2).
    const T scale = mean * static_cast<T>(fam.weibull_inv_gamma);
    return scale * pow(-log1p(-u), static_cast<T>(fam.weibull_power));
  }
}

template <typename T>
__device__ __forceinline__ T max_of(T a, T b) { return a >= b ? a : b; }
template <typename T>
__device__ __forceinline__ T min_of(T a, T b) { return a <= b ? a : b; }

template <typename T, int kModel>
__global__ void __launch_bounds__(kWarp * kWindowWarps)
gi_g1_window_kernel(const long long* __restrict__ keys,
                    const T* __restrict__ lam, const T* __restrict__ mu,
                    const T* __restrict__ p, const int* __restrict__ pol,
                    Family fam, T horizon, int n_lanes, int n_frames,
                    int n_streams, int sample_streams, int sample_frames,
                    T* __restrict__ out, T* __restrict__ samples) {
  const int ku = delay_rows<kModel>(fam);    // T's rows, then O's, coin
  const int ko = ku;
  __shared__ T sh_t[kWindowWarps][kWarp];   // T of frame f + 1 (pass 2)
  __shared__ T sh_o[kWindowWarps][kWarp];
  __shared__ T sh_u[kWindowWarps][kWarp];
  const int w = threadIdx.x / kWarp;
  const int tid = threadIdx.x % kWarp;
  const int lane = blockIdx.x * kWindowWarps + w;
  if (lane >= n_lanes) return;             // the whole warp leaves
  const int epoch = lane / n_streams;
  const int stream = lane % n_streams;
  uint32_t k0 = 0u, k1 = static_cast<uint32_t>(stream);   // fold_in
  threefry2x32(static_cast<uint32_t>(keys[2 * epoch]),
               static_cast<uint32_t>(keys[2 * epoch + 1]), k0, k1);
  const T mean_t = T(1) / lam[lane];
  const T mean_o = T(1) / mu[lane];
  const T pp = p[lane];
  const bool lcfsp = pol[lane] == 1;
  const long long nf = n_frames;
  T* sample_row = (samples != nullptr && stream < sample_streams)
      ? samples + (static_cast<long long>(epoch) * sample_streams +
                   stream) * sample_frames
      : nullptr;

  // Pass 1: sum T serially (thread 0), writing the sampled draws.
  T total = T(0);
  for (int f0 = 0; f0 < n_frames; f0 += kWarp) {
    const int f = f0 + tid;
    T t = T(0);
    if (f < n_frames) {
      t = delay<T, kModel>(fam, k0, k1, 0, nf, f, mean_t);
      if (sample_row != nullptr && f < sample_frames) sample_row[f] = t;
    }
    sh_t[w][tid] = t;
    __syncwarp();
    if (tid == 0) {
      const int cnt = min(kWarp, n_frames - f0);
      for (int j = 0; j < cnt; ++j) total = total + sh_t[w][j];
    }
    __syncwarp();
  }
  const T h_eff = min_of(horizon, total);

  // Pass 2: the recurrence, thread 0 walking 32 frames at a time.
  const T inf = static_cast<T>(INFINITY);
  const T zero = T(0);
  T a = zero, s = zero, m = -inf, last_t = zero, age0 = zero, area = zero;
  T n_arr = zero, n_done = zero, n_acc = zero;
  T t_cur = zero;
  if (tid == 0 && n_frames > 0) {
    t_cur = delay<T, kModel>(fam, k0, k1, 0, nf, 0, mean_t);
  }
  for (int f0 = 0; f0 < n_frames; f0 += kWarp) {
    const int f = f0 + tid;
    if (f < n_frames) {
      sh_t[w][tid] = f + 1 < n_frames
          ? delay<T, kModel>(fam, k0, k1, 0, nf, f + 1, mean_t) : inf;
      sh_o[w][tid] = delay<T, kModel>(fam, k0, k1, ku, nf, f, mean_o);
      sh_u[w][tid] = uniform<T>(k0, k1, (ku + ko) * nf + f);
    }
    __syncwarp();
    if (tid == 0) {
      const int cnt = min(kWarp, n_frames - f0);
      for (int j = 0; j < cnt; ++j) {
        const T t_f = t_cur;
        const T t_nxt = sh_t[w][j];
        const T o_f = sh_o[w][j];
        const T u_f = sh_u[w][j];
        a = a + t_f;
        const T gen = a - t_f;
        s = s + o_f;
        m = max_of(m, a - (s - o_f));
        const T finish = lcfsp ? a + o_f : s + m;
        const bool completed = lcfsp ? o_f < t_nxt : true;
        const bool done = completed && finish <= h_eff;
        const bool valid = done && u_f < pp;
        const T seg = valid ? finish - last_t : zero;
        area = area + age0 * seg;
        area = area + (static_cast<T>(0.5) * seg) * seg;
        last_t = valid ? finish : last_t;
        age0 = valid ? finish - gen : age0;
        n_arr = n_arr + (a <= h_eff ? T(1) : zero);
        n_done = n_done + (done ? T(1) : zero);
        n_acc = n_acc + (valid ? T(1) : zero);
        t_cur = t_nxt;
      }
    }
    __syncwarp();
  }
  if (tid != 0) return;
  const T seg = max_of(h_eff - last_t, zero);
  area = area + age0 * seg;
  area = area + (static_cast<T>(0.5) * seg) * seg;
  out[lane] = area / h_eff;
  out[n_lanes + lane] = h_eff;
  out[2 * n_lanes + lane] = n_arr;
  out[3 * n_lanes + lane] = n_done;
  out[4 * n_lanes + lane] = n_acc;
}

__global__ void __launch_bounds__(kTickThreads)
tick_scan_kernel(const double* __restrict__ T, const double* __restrict__ O,
                 const double* __restrict__ coin,
                 const double* __restrict__ p,
                 const bool* __restrict__ is_lcfsp,
                 const bool* __restrict__ live, double epoch, int n_lanes,
                 int n_frames, double* __restrict__ out,
                 double* __restrict__ fin_out, bool* __restrict__ done_out) {
  const int lane = blockIdx.x * kTickThreads + threadIdx.x;
  if (lane >= n_lanes) return;
  const long long row = static_cast<long long>(lane) * n_frames;
  const double* t_row = T + row;
  const double* o_row = O + row;
  const double* u_row = coin + row;
  double total = 0.0;
  for (int k = 0; k < n_frames; ++k) total = total + t_row[k];
  const bool lv = live[lane];
  const bool lcfsp = is_lcfsp[lane];
  const double pk = p[lane];
  const double h_eff = lv ? min_of(epoch, total) : 0.0;
  const double inf = INFINITY;
  double a = 0.0, fin_prev = 0.0, last_t = 0.0, age0 = 0.0, area = 0.0;
  double n_arr = 0.0, n_done = 0.0, n_acc = 0.0, n_pre = 0.0, busy = 0.0;
  for (int k = 0; k < n_frames; ++k) {
    const double tk = t_row[k];
    const double ok = o_row[k];
    const double uk = u_row[k];
    a = a + tk;
    const double nk = k + 1 < n_frames ? a + t_row[k + 1] : inf;
    const double gen = a - tk;
    const double start = lcfsp ? a : max_of(a, fin_prev);
    const double fin = start + ok;
    const bool arrived = a <= h_eff;
    const bool completed = lcfsp ? fin <= nk : true;
    const bool preempted = lcfsp && fin > nk && arrived;
    const bool done = completed && fin <= h_eff && lv;
    const bool valid = done && uk < pk;
    const double seg = valid ? fin - last_t : 0.0;
    const double t1 = age0 * seg;
    const double t2 = (0.5 * seg) * seg;
    area = area + (t1 + t2);
    const double nxt_gate = arrived ? nk : inf;
    const double end_s = lcfsp ? min_of(fin, nxt_gate) : fin;
    const double busy_seg =
        max_of(min_of(end_s, h_eff) - min_of(start, h_eff), 0.0);
    fin_prev = fin;
    last_t = valid ? fin : last_t;
    age0 = valid ? fin - gen : age0;
    n_arr = n_arr + (arrived ? 1.0 : 0.0);
    n_done = n_done + (done ? 1.0 : 0.0);
    n_acc = n_acc + (valid ? 1.0 : 0.0);
    n_pre = n_pre + (preempted ? 1.0 : 0.0);
    busy = busy + busy_seg;
    if (fin_out != nullptr) {
      const long long at = static_cast<long long>(k) * n_lanes + lane;
      fin_out[at] = fin;
      done_out[at] = done;
    }
  }
  const double carry[9] = {h_eff, last_t, age0, area, n_arr,
                           n_done, n_acc, n_pre, busy};
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i * n_lanes + lane] = carry[i];
}

template <typename T, int kModel>
cudaError_t launch_window(const long long* keys, const void* lam,
                          const void* mu, const void* p, const int* pol,
                          const Family& fam, double horizon, int n_lanes, int n_frames,
                          int n_streams, int sample_streams,
                          int sample_frames, void* out, void* samples,
                          cudaStream_t stream) {
  const int blocks = (n_lanes + kWindowWarps - 1) / kWindowWarps;
  gi_g1_window_kernel<T, kModel><<<blocks, kWarp * kWindowWarps, 0,
                                   stream>>>(
      keys, static_cast<const T*>(lam), static_cast<const T*>(mu),
      static_cast<const T*>(p), pol, fam, static_cast<T>(horizon), n_lanes,
      n_frames, n_streams, sample_streams, sample_frames,
      static_cast<T*>(out), static_cast<T*>(samples));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_window_model(int model, const long long* keys,
                                const void* lam, const void* mu,
                                const void* p, const int* pol,
                                const Family& fam, double horizon,
                                int n_lanes, int n_frames,
                                int n_streams, int sample_streams,
                                int sample_frames, void* out, void* samples,
                                cudaStream_t stream) {
#define DATAPLANE_LAUNCH(M)                                                \
  return launch_window<T, M>(keys, lam, mu, p, pol, fam, horizon, n_lanes, \
                             n_frames, n_streams, sample_streams,          \
                             sample_frames, out, samples, stream)
  switch (model) {
    case kMM1: DATAPLANE_LAUNCH(kMM1);
    case kUniform: DATAPLANE_LAUNCH(kUniform);
    case kGamma: DATAPLANE_LAUNCH(kGamma);
    case kLognormal: DATAPLANE_LAUNCH(kLognormal);
    case kWeibull: DATAPLANE_LAUNCH(kWeibull);
    default: return cudaErrorInvalidValue;
  }
#undef DATAPLANE_LAUNCH
}

}  // namespace

extern "C" {

// keys [E, 2] int64 (the epochs' keys, 32-bit words; lane e*N + i folds
// in i); lam, mu, p [L] float32 (dtype 0) or
// float64 (dtype 1); pol [L] int32; family [7] the Family constants in
// host memory;
// out [5, L] (aopi, horizon, n_frames, n_completed, n_accurate); samples
// [E, sample_streams, sample_frames] or null.
int dataplane_gi_g1_window(int dtype, int model, const long long* keys,
                           const void* lam, const void* mu, const void* p,
                           const int* pol, const double* family,
                           double horizon, int n_lanes,
                           int n_frames, int n_streams, int sample_streams,
                           int sample_frames, void* out, void* samples,
                           cudaStream_t stream) {
  if (n_lanes <= 0 || n_frames <= 0 || n_streams <= 0) {
    return cudaErrorInvalidValue;
  }
  const Family fam{family[0], family[1], family[2], family[3],
                   family[4], family[5], family[6]};
  if (model == kGamma &&
      !(fam.gamma_shape >= 1.0 && fam.gamma_shape <= 64.0 &&
        fam.gamma_shape == static_cast<int>(fam.gamma_shape))) {
    return cudaErrorInvalidValue;   // only an Erlang count has rows
  }
  if (dtype == 0) {
    return launch_window_model<float>(model, keys, lam, mu, p, pol, fam,
                                      horizon, n_lanes, n_frames, n_streams,
                                      sample_streams, sample_frames, out,
                                      samples, stream);
  }
  if (dtype == 1) {
    return launch_window_model<double>(model, keys, lam, mu, p, pol, fam,
                                       horizon, n_lanes, n_frames, n_streams,
                                       sample_streams, sample_frames, out,
                                       samples, stream);
  }
  return cudaErrorInvalidValue;
}

// T, O, coin [S, F] float64; p [S] float64; is_lcfsp, live [S] bool;
// out [9, S] (h_eff, last_t, age0, area, n_frames, n_completed,
// n_accurate, preempts, busy); fin [F, S] float64 and done [F, S] bool, or
// both null.
int dataplane_tick_scan(const double* T, const double* O, const double* coin,
                        const double* p, const bool* is_lcfsp,
                        const bool* live, double epoch, int n_lanes,
                        int n_frames, double* out, double* fin, bool* done,
                        cudaStream_t stream) {
  if (n_lanes <= 0 || n_frames <= 0) return cudaErrorInvalidValue;
  const int blocks = (n_lanes + kTickThreads - 1) / kTickThreads;
  tick_scan_kernel<<<blocks, kTickThreads, 0, stream>>>(
      T, O, coin, p, is_lcfsp, live, epoch, n_lanes, n_frames, out, fin,
      done);
  return cudaGetLastError();
}

const char* dataplane_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
