// The tracker's ICP update, hand-written for Hopper (sm_90a): the 6x6
// truncated-SVD solve with its condition gate, and around it the rest of
// one ICP iteration's tail, in one kernel a solve.
//
// It has no TPU kernel to replace: the JAX tracker runs this tail as XLA
// inside its jitted loop (voxelhashing_tpu/tracking.py:560-590; the solve,
// _solve6, at :328-347, is jnp.linalg.svd). Its plain PyTorch version,
// ops/icp_update.icp_update_plain, is that tail op for op around
// ops/solve6.solve6_plain (torch.linalg.svd, which reads the device on the
// host twice a call on CUDA): some 110 one-element launches a solve, 18
// solves a tracked frame, each feeding the next linearization.
//
// The solve core (solve6_core) computes, from the f32 system a [6,6], b [6]:
//
//   s        the singular values of a (s0 the largest, s5 the smallest);
//   cond     = s0 / max(s5, 1e-20);
//   degen    = s0 <= 0 | cond > cond_thres | any(!isfinite(a));
//   x        = sum over s_j > max(s0 / cond_thres, 1e-10) of
//              v_j (u_j . b) / s_j, and 0 where degen.
//
// Method: two-sided Jacobi in f64 on the Gram matrix G = a^T a (its
// eigenvalues are s_j^2, its eigenvectors v_j), in one thread's registers
// (21 + 36 doubles): the same rotations as one-sided Jacobi on the columns
// of a, with no cross-lane sums. Then (u_j . b) / s_j = (v_j . a^T b) / s_j^2.
// G squares the condition number, but the tracker's gate sits at cond ~2e4,
// where f64 leaves s5 some 1e-8 relative off, far inside the f32 SVD's own
// eps32 * cond that solve6.disagreements allows. An eigenvalue that rounds
// below 0 is a zero singular value (a NaN there would poison the rank-3
// systems). Order: the circle method's 5 rounds of 3 disjoint pairs a
// sweep; the three rotations of a round commute, so their angles are taken
// together and their chains overlap in the pipeline: a sweep is 5 rotation
// latencies, not 15. That overlap needs straight-line code: the library's
// f64 division and square root branch to slow paths (with them a round
// took about three rotations' latency, and the solve twice as long), so
// the angle takes 1/x and 1/sqrt(x) from the
// hardware's approximation and two Newton steps, the gate selects the
// identity rotation instead of branching, and the updates use explicit
// fmas (the solve has no plain version to match bit for bit; its bound
// is solve6.disagreements). A pair rotates when |g_pq| > 1e-15 sqrt(g_pp g_qq)
// (taken squared, without the root) and |g_pq| > 2^-52 trace(G) (below
// that an entry is the rounding of forming G; without this floor the
// rank-3 systems rotate noise until the cap). The sweeps stop when a whole
// sweep rotates nothing, or after kMaxSweeps (5-7 on the seeded bank,
// the last rotating nothing). Non-finite input makes G NaN: no rotation
// fires and the degenerate flag (any non-finite entry) zeroes x.
//
// The update kernel (icp_update_kernel, one thread) reads the reduced
// system, folds the RGB-D color system in with its weights, solves, and
// runs the step gate, the de-whitened pose update and the carry's masked
// update in f32, in the plain version's operation order (euler_zyx once,
// shared by the gate and the pose), then writes the carry in place: one
// node of the captured front graph a solve. It allocates nothing, reads
// nothing on the host and launches on the caller's stream.
//
// What bounds it on this card: neither bytes (~450 B a solve) nor
// operations (~4-7K f64 operations): one thread dispatching ~200 f64
// instructions a round (one warp instruction each, on its sub-partition's
// 16 f64 lanes) and the round's dependent chain (the approximations and
// their Newton steps), 4-6 sweeps of 5 rounds; and the launch itself (an
// empty kernel's node, timed beside it by chip_smoke.py). Spreading the
// rows of G and V over six lanes would about halve the instructions each
// lane runs, for shuffles a round.
//
// vh_solve6 runs the same core batched, one thread a system (the checks
// and the system bank); no path of the port calls it.
//
// Built with -fmad=false like the other kernels (ops/_build.py).

#include "common.cuh"

namespace {

constexpr int kN = 6;
constexpr int kTri = kN * (kN + 1) / 2;
constexpr int kRounds = kN - 1;
constexpr int kMaxSweeps = 10;
constexpr double kRotateTol = 1e-15;
constexpr double kNoise = 2.220446049250313e-16;  // 2^-52
constexpr int kBeginLevel = 1;
constexpr int kBeginOuter = 2;
constexpr int kBatchThreads = 32;

// Index of (i, j) in the packed upper triangle of a symmetric 6x6, rows
// in order (i <= j or not).
__device__ __forceinline__ constexpr int tri(int i, int j) {
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  return lo * kN - lo * (lo - 1) / 2 + (hi - lo);
}

// The circle method: in round r, 0 meets e_0, e_1 meets e_4 and e_2 meets
// e_3, where e_i = 1 + (i + r) % 5; the 5 rounds hold the 15 pairs once.
__device__ __forceinline__ constexpr int circle(int r, int i) {
  return 1 + (i + r) % kRounds;
}
__device__ __forceinline__ constexpr int pair_a(int r, int k) {
  return k == 0 ? 0 : circle(r, k);
}
__device__ __forceinline__ constexpr int pair_b(int r, int k) {
  return circle(r, k == 0 ? 0 : kRounds - k);
}
__device__ __forceinline__ constexpr int pair_p(int r, int k) {
  return pair_a(r, k) < pair_b(r, k) ? pair_a(r, k) : pair_b(r, k);
}
__device__ __forceinline__ constexpr int pair_q(int r, int k) {
  return pair_a(r, k) < pair_b(r, k) ? pair_b(r, k) : pair_a(r, k);
}

// 1/x and 1/sqrt(x) in f64 without a branch: the hardware's approximation
// and two Newton steps (each doubles the correct bits; a result within an
// ulp or two). The library's division and square root branch to a slow
// path, which keeps the three rotations of a round from overlapping.
__device__ __forceinline__ double rcp64(double x) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
#pragma unroll
  for (int i = 0; i < 2; ++i) y = __fma_rn(y, __fma_rn(-x, y, 1.0), y);
  return y;
}

__device__ __forceinline__ double rsqrt64(double x) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    y = __fma_rn(0.5 * y, __fma_rn(-x, y * y, 1.0), y);
  }
  return y;
}

// Whether the pair (p, q) rotates: false for NaN (non-finite input
// rotates nothing).
__device__ __forceinline__ bool gate(const double (&g)[kTri], int p, int q,
                                     double floor) {
  const double gpq = g[tri(p, q)];
  return gpq * gpq > (kRotateTol * kRotateTol) * (g[tri(p, p)] * g[tri(q, q)])
         && fabs(gpq) > floor;
}

struct Rotation {
  double c, s, t;
  bool on;
};

// The rotation that zeroes g_pq (the Jacobi convention: t = tan(theta) =
// sign(d) e / (|d| + sqrt(d^2 + e^2)), d = g_qq - g_pp, e = 2 g_pq; c =
// 1/sqrt(1 + t^2), s = t c), or the identity where ``on`` is false; no
// branch, so that a round's three overlap.
__device__ __forceinline__ Rotation rotation(const double (&g)[kTri], int p,
                                             int q, bool on) {
  const double d = g[tri(q, q)] - g[tri(p, p)];
  const double e = 2.0 * g[tri(p, q)];
  const double x = d * d + e * e;
  const double t = copysign(1.0, d) * e * rcp64(fabs(d) + x * rsqrt64(x));
  const double c = rsqrt64(1.0 + t * t);
  return on ? Rotation{c, t * c, t, true} : Rotation{1.0, 0.0, 0.0, false};
}

// G <- J^T G J and V <- V J for the rotation J of the pair (p, q); the
// identity rotation leaves every finite entry as it was.
__device__ __forceinline__ void rotate(double (&g)[kTri], double (&v)[kN][kN],
                                       int p, int q, const Rotation& r) {
  const double gpq = g[tri(p, q)];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (k == p || k == q) continue;
    const double gkp = g[tri(k, p)], gkq = g[tri(k, q)];
    g[tri(k, p)] = __fma_rn(r.c, gkp, -r.s * gkq);
    g[tri(k, q)] = __fma_rn(r.s, gkp, r.c * gkq);
  }
  g[tri(p, p)] = __fma_rn(-r.t, gpq, g[tri(p, p)]);
  g[tri(q, q)] = __fma_rn(r.t, gpq, g[tri(q, q)]);
  g[tri(p, q)] = r.on ? 0.0 : gpq;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const double vp = v[i][p], vq = v[i][q];
    v[i][p] = __fma_rn(r.c, vp, -r.s * vq);
    v[i][q] = __fma_rn(r.s, vp, r.c * vq);
  }
}

// The truncated-SVD solve of a x = b (the function at the top), in the
// calling thread. Returns the sweeps it ran.
__device__ __forceinline__ int solve6_core(const float (&a)[kN][kN],
                                           const float (&b)[kN],
                                           float cond_thres, float (&x)[kN],
                                           float& cond, bool& degenerate) {
  bool finite = true;
#pragma unroll
  for (int r = 0; r < kN; ++r) {
#pragma unroll
    for (int j = 0; j < kN; ++j) finite = finite && isfinite(a[r][j]);
  }
  double g[kTri], c[kN], v[kN][kN];
  double trace = 0.0;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
#pragma unroll
    for (int j = i; j < kN; ++j) {
      // each f32 product is exact in f64: the fma rounds the sum only
      double sum = 0.0;
#pragma unroll
      for (int r = 0; r < kN; ++r) {
        sum = __fma_rn((double)a[r][i], (double)a[r][j], sum);
      }
      g[tri(i, j)] = sum;
    }
    double sb = 0.0;
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      sb = __fma_rn((double)a[r][i], (double)b[r], sb);
    }
    c[i] = sb;
    trace += g[tri(i, i)];
#pragma unroll
    for (int j = 0; j < kN; ++j) v[i][j] = i == j ? 1.0 : 0.0;
  }
  const double floor = kNoise * trace;

  int sweeps = 0;
  while (sweeps < kMaxSweeps) {
    ++sweeps;
    bool rotated = false;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const bool o0 = gate(g, pair_p(r, 0), pair_q(r, 0), floor);
      const bool o1 = gate(g, pair_p(r, 1), pair_q(r, 1), floor);
      const bool o2 = gate(g, pair_p(r, 2), pair_q(r, 2), floor);
      if (o0 || o1 || o2) {
        const Rotation r0 = rotation(g, pair_p(r, 0), pair_q(r, 0), o0);
        const Rotation r1 = rotation(g, pair_p(r, 1), pair_q(r, 1), o1);
        const Rotation r2 = rotation(g, pair_p(r, 2), pair_q(r, 2), o2);
        rotate(g, v, pair_p(r, 0), pair_q(r, 0), r0);
        rotate(g, v, pair_p(r, 1), pair_q(r, 1), r1);
        rotate(g, v, pair_p(r, 2), pair_q(r, 2), r2);
        rotated = true;
      }
    }
    if (!rotated) break;
  }

  double sv[kN];
  double s_max = 0.0, s_min = INFINITY;
  bool nan_s = false;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const double lam = g[tri(j, j)];
    nan_s = nan_s || isnan(lam);
    sv[j] = lam > 0.0 ? lam * rsqrt64(lam) : 0.0;
    s_max = fmax(s_max, sv[j]);
    s_min = fmin(s_min, sv[j]);
  }
  if (nan_s) s_max = s_min = NAN;
  const float s0 = (float)s_max;
  const float s5 = (float)s_min;
  cond = s0 / fmaxf(s5, 1e-20f);
  degenerate = (s0 <= 0.0f) || (cond > cond_thres) || !finite;
  const double s_cut = fmax(s_max / (double)cond_thres, 1e-10);

  double xr[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) xr[i] = 0.0;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    double vc = 0.0;
#pragma unroll
    for (int i = 0; i < kN; ++i) vc = __fma_rn(v[i][j], c[i], vc);
    // truncated: a value at or below the cut adds nothing
    const double w = sv[j] > s_cut ? vc * rcp64(g[tri(j, j)]) : 0.0;
#pragma unroll
    for (int i = 0; i < kN; ++i) xr[i] = __fma_rn(v[i][j], w, xr[i]);
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) x[i] = degenerate ? 0.0f : (float)xr[i];
  return sweeps;
}

__global__ void __launch_bounds__(kBatchThreads)
    solve6_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  long long a_batch_stride, int a_row_stride,
                  long long b_batch_stride, float cond_thres,
                  float* __restrict__ x, float* __restrict__ cond,
                  uint8_t* __restrict__ degenerate, int* __restrict__ sweeps,
                  int n_sys) {
  const int sys = blockIdx.x * kBatchThreads + threadIdx.x;
  if (sys >= n_sys) return;
  const float* as = a + sys * a_batch_stride;
  float am[kN][kN], bv[kN], xs[kN];
#pragma unroll
  for (int r = 0; r < kN; ++r) {
#pragma unroll
    for (int j = 0; j < kN; ++j) am[r][j] = as[r * a_row_stride + j];
    bv[r] = b[sys * b_batch_stride + r];
  }
  float cn;
  bool dg;
  const int sw = solve6_core(am, bv, cond_thres, xs, cn, dg);
#pragma unroll
  for (int i = 0; i < kN; ++i) x[sys * kN + i] = xs[i];
  cond[sys] = cn;
  degenerate[sys] = dg ? 1 : 0;
  if (sweeps != nullptr) sweeps[sys] = sw;
}

// torch.clamp(v, min=lo) and torch.clamp(v, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// out = p q for 3x3 matrices, each entry summed left to right
__device__ __forceinline__ void mat3(const float (&p)[3][3],
                                     const float (&q)[3][3],
                                     float (&out)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[i][j] = p[i][0] * q[0][j] + p[i][1] * q[1][j] + p[i][2] * q[2][j];
    }
  }
}

// geometry.euler_zyx_to_matrix: R = Rz(a0) Ry(a1) Rx(a2)
__device__ __forceinline__ void euler_zyx(float a0, float a1, float a2,
                                          float (&r)[3][3]) {
  const float cz = cosf(a0), sz = sinf(a0);
  const float cy = cosf(a1), sy = sinf(a1);
  const float cx = cosf(a2), sx = sinf(a2);
  const float rz[3][3] = {{cz, -sz, 0.0f}, {sz, cz, 0.0f}, {0.0f, 0.0f, 1.0f}};
  const float ry[3][3] = {{cy, 0.0f, sy}, {0.0f, 1.0f, 0.0f}, {-sy, 0.0f, cy}};
  const float rx[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, cx, -sx}, {0.0f, sx, cx}};
  float zy[3][3];
  mat3(rz, ry, zy);
  mat3(zy, rx, r);
}

struct UpdateArgs {
  // the reduced system: a (row r at a + r * a_row, its entries contiguous),
  // b [6], the residual and weight sums, the correspondence count
  const float* a;
  const float* b;
  const float* sum_res;
  const float* sum_w;
  const int* count;
  // the RGB-D color system (a_c null without it) and the weights
  const float* a_c;
  const float* b_c;
  const float* res_c;
  const float* w_c;
  // the whitening (mean [3], inverse scale) and the planarity flag (may be
  // null: off)
  const float* mean;
  const float* inv_std;
  const uint8_t* planar;
  // the carry, updated in place: delta [4,4]; vals [6] (residual,
  // condition, lvl_res, lvl_cond, lvl_w, last_res); counts [2] (corr,
  // lvl_corr); flags [3] (lost, done, skip)
  float* delta;
  float* vals;
  int* counts;
  uint8_t* flags;
  // the level's stats row [4], the curve's slot, the solve's x [6], cond
  // and degenerate
  float* stats;
  float* curve;
  float* x;
  float* cond;
  uint8_t* degenerate;
  int a_row, a_c_row, min_count, begin;
  float weight_depth, weight_color, early_out, angle_thres, dist_thres,
      cond_thres;
};

__global__ void __launch_bounds__(1) icp_update_kernel(const UpdateArgs p) {
  float residual = p.vals[0], condition = p.vals[1], lvl_res = p.vals[2],
        lvl_cond = p.vals[3], lvl_w = p.vals[4], last_res = p.vals[5];
  int corr = p.counts[0], lvl_corr = p.counts[1];
  bool lost = p.flags[0] != 0, done = p.flags[1] != 0, skip = p.flags[2] != 0;
  if (p.begin & kBeginLevel) {
    lvl_res = lvl_cond = lvl_w = 0.0f;
    lvl_corr = 0;
    done = false;
    last_res = INFINITY;
  }
  if (p.begin & kBeginOuter) skip = done;
  float cval = NAN;

  // a level already done keeps its carry (the JAX tracker's lax.cond skip)
  if (!skip) {
    float a[kN][kN], b[kN];
    float sum_res = *p.sum_res, sum_w = *p.sum_w;
    const int count = *p.count;
#pragma unroll
    for (int r = 0; r < kN; ++r) {
#pragma unroll
      for (int j = 0; j < kN; ++j) a[r][j] = p.a[r * p.a_row + j];
      b[r] = p.b[r];
    }
    if (p.a_c != nullptr) {
      const float wd = p.weight_depth, wc = p.weight_color;
#pragma unroll
      for (int r = 0; r < kN; ++r) {
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          a[r][j] = wd * a[r][j] + wc * p.a_c[r * p.a_c_row + j];
        }
        b[r] = wd * b[r] + wc * p.b_c[r];
      }
      sum_res = wd * sum_res + wc * *p.res_c;
      sum_w = wd * sum_w + wc * *p.w_c;
    }
    const float mean_res = sum_res / clamp_min(sum_w, 1e-12f);
    done = done || (fabsf(last_res - mean_res) < p.early_out);
    last_res = mean_res;
    cval = done ? NAN : mean_res;

    float x[kN], cond;
    bool degen;
    solve6_core(a, b, p.cond_thres, x, cond, degen);
#pragma unroll
    for (int i = 0; i < kN; ++i) p.x[i] = x[i];
    *p.cond = cond;
    *p.degenerate = degen ? 1 : 0;

    // the step gate in physical units, on R = euler_zyx(x[:3]) (computed
    // once: the pose below uses the same R) and t = x[3:6] / inv_std
    const float inv_std = *p.inv_std;
    const float t0 = x[3] / inv_std, t1 = x[4] / inv_std, t2 = x[5] / inv_std;
    float r[3][3];
    euler_zyx(x[0], x[1], x[2], r);
    const float trace = r[0][0] + r[1][1] + r[2][2];
    const float ang = acosf(clamp((trace - 1.0f) * 0.5f, -1.0f, 1.0f));
    const float t_norm = sqrtf(t0 * t0 + t1 * t1 + t2 * t2);
    const bool step_ok = (ang <= p.angle_thres) && (t_norm <= p.dist_thres);
    const bool planar = p.planar != nullptr && *p.planar != 0;
    const bool bad = degen || !step_ok || (count < p.min_count) || planar;
    lost = lost || (bad && !done);
    const bool use = !done && !bad;
    if (use) {
      // delta <- P delta, P = [R | t / inv_std + mean - R mean]
      const float m[3] = {p.mean[0], p.mean[1], p.mean[2]};
      const float t[3] = {t0, t1, t2};
      float pm[3][4];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pm[i][0] = r[i][0];
        pm[i][1] = r[i][1];
        pm[i][2] = r[i][2];
        pm[i][3] = (t[i] + m[i]) - (r[i][0] * m[0] + r[i][1] * m[1] +
                                    r[i][2] * m[2]);
      }
      float d[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int j = 0; j < 4; ++j) d[k][j] = p.delta[k * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p.delta[i * 4 + j] = pm[i][0] * d[0][j] + pm[i][1] * d[1][j] +
                               pm[i][2] * d[2][j] + pm[i][3] * d[3][j];
        }
      }
    }
    const bool keep = use || done;
    if (keep) {
      residual = lvl_res = mean_res;
      corr = lvl_corr = count;
      lvl_w = sum_w;
    }
    if (use) condition = lvl_cond = cond;
    done = done || bad;
  }

  p.vals[0] = residual;
  p.vals[1] = condition;
  p.vals[2] = lvl_res;
  p.vals[3] = lvl_cond;
  p.vals[4] = lvl_w;
  p.vals[5] = last_res;
  p.counts[0] = corr;
  p.counts[1] = lvl_corr;
  p.flags[0] = lost ? 1 : 0;
  p.flags[1] = done ? 1 : 0;
  p.flags[2] = skip ? 1 : 0;
  p.stats[0] = lvl_res;
  p.stats[1] = lvl_cond;
  p.stats[2] = (float)lvl_corr;
  p.stats[3] = lvl_w;
  *p.curve = cval;
}

__global__ void empty_kernel() {}

}  // namespace

// x (f32 [n_sys, 6]), cond (f32 [n_sys]) and degenerate (bool [n_sys]) of
// the systems a (f32, system i's row r at a + i * a_batch_stride +
// r * a_row_stride, its entries contiguous) and b (f32, system i at
// b + i * b_batch_stride, contiguous); sweeps (int32 [n_sys], may be null)
// takes the Jacobi sweeps each system ran (the last one rotates nothing,
// unless the cap ended them).
extern "C" int vh_solve6(const void* a, const void* b,
                         long long a_batch_stride, int a_row_stride,
                         long long b_batch_stride, float cond_thres, void* x,
                         void* cond, void* degenerate, void* sweeps,
                         int n_sys, void* stream) {
  if (n_sys > 0) {
    const int grid = (n_sys + kBatchThreads - 1) / kBatchThreads;
    solve6_kernel<<<grid, kBatchThreads, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, a_batch_stride, a_row_stride,
        b_batch_stride, cond_thres, (float*)x, (float*)cond,
        (uint8_t*)degenerate, (int*)sweeps, n_sys);
  }
  return (int)cudaGetLastError();
}

// One ICP update (ops/icp_update.py has the layout of every buffer): the
// pointers in the order of UpdateArgs (a_c, b_c, res_c and w_c null
// without a color system, planar null when the gate is off), then a's and
// a_c's row strides, the count limit, the begin bits (1: the level's first
// solve, 2: an outer iteration's first), the weights and the level's
// thresholds.
extern "C" int vh_icp_update(
    const void* a, const void* b, const void* sum_res, const void* sum_w,
    const void* count, const void* a_c, const void* b_c, const void* res_c,
    const void* w_c, const void* mean, const void* inv_std,
    const void* planar, void* delta, void* vals, void* counts, void* flags,
    void* stats, void* curve, void* x, void* cond, void* degenerate,
    int a_row, int a_c_row, int min_count, int begin, float weight_depth,
    float weight_color, float early_out, float angle_thres, float dist_thres,
    float cond_thres, void* stream) {
  const UpdateArgs p{(const float*)a,       (const float*)b,
                     (const float*)sum_res, (const float*)sum_w,
                     (const int*)count,     (const float*)a_c,
                     (const float*)b_c,     (const float*)res_c,
                     (const float*)w_c,     (const float*)mean,
                     (const float*)inv_std, (const uint8_t*)planar,
                     (float*)delta,         (float*)vals,
                     (int*)counts,          (uint8_t*)flags,
                     (float*)stats,         (float*)curve,
                     (float*)x,             (float*)cond,
                     (uint8_t*)degenerate,  a_row,
                     a_c_row,               min_count,
                     begin,                 weight_depth,
                     weight_color,          early_out,
                     angle_thres,           dist_thres,
                     cond_thres};
  icp_update_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// An empty kernel: the launch floor a graph node costs (measurement only).
extern "C" int vh_empty(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
