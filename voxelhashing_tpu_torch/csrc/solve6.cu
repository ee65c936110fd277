// solve6: the tracker's 6x6 truncated-SVD solve with its condition gate,
// hand-written for Hopper (sm_90a).
//
// It has no TPU kernel to replace: the JAX package solves the system with
// jnp.linalg.svd inside the XLA program (voxelhashing_tpu/tracking.py:339,
// _solve6). Its plain PyTorch version, ops/solve6.solve6_plain, calls
// torch.linalg.svd, which reads the device on the host twice a call on
// CUDA (its convergence check), so a frame of 18 solves could not be
// captured as a CUDA graph. This kernel computes the same function with no
// host read, from the f32 system a [6,6] and b [6]:
//
//   s        the singular values of a (s0 the largest, s5 the smallest);
//   cond     = s0 / max(s5, 1e-20);
//   degen    = s0 <= 0 | cond > cond_thres | any(!isfinite(a));
//   x        = sum over s_j > max(s0 / cond_thres, 1e-10) of
//              v_j (u_j . b) / s_j, and 0 where degen.
//
// Method: one-sided (Hestenes) Jacobi in f64 on the columns of a. Each
// rotation of the column pair (p, q) zeroes their inner product; V collects
// the rotations, so that at convergence a V = U S with orthogonal columns,
// s_j is the norm of column j of a V and (u_j . b) / s_j = (column j . b) /
// s_j^2. One-sided Jacobi needs no symmetry: a is symmetric only up to
// rounding, and the RGB-D system is a weighted sum of two such systems. The
// sweeps stop when a whole sweep rotates nothing (|gamma| <= 1e-15
// sqrt(alpha beta) for every pair) or after kMaxSweeps (a 6x6 converges in
// 5-6). Non-finite input makes the norms NaN: no rotation fires, the sweeps
// end, and the degenerate flag (any non-finite entry) zeroes x. The plain
// version sorts the values; here only s0 and s5 enter the gate, the
// truncation is per value and the sum of the six terms is taken in f64, so
// the order is not needed.
//
// Launch: one CTA of 8 threads per system (a batch [B,6,6] is B CTAs);
// thread r holds row r of a and of V (rows 6 and 7 are zero), and each inner
// product is a butterfly sum over the 8 lanes, which leaves the same bits
// on every lane, so every lane takes the same rotation. What bounds it on
// this card: neither bytes (a system moves ~200 B) nor operations (~10K f64
// operations): the latency of the dependent chain of 15 rotations a sweep
// (three 8-lane sums, a division and two square roots each), and for the
// tracker's B = 1 the launch.
//
// Built with -fmad=false like the other kernels (ops/_build.py).

#include "common.cuh"

namespace {

constexpr int kN = 6;
constexpr int kLanes = 8;
constexpr unsigned kLaneMask = 0xFFu;
constexpr int kMaxSweeps = 10;
constexpr double kRotateTol = 1e-15;

// Sum over the 8 lanes of a system; the same bits on every lane (each
// butterfly step adds the same two values on both partners).
__device__ __forceinline__ double lane_sum(double v) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    v += __shfl_xor_sync(kLaneMask, v, o, kLanes);
  }
  return v;
}

__global__ void __launch_bounds__(kLanes)
    solve6_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  long long a_batch_stride, int a_row_stride,
                  long long b_batch_stride, float cond_thres,
                  float* __restrict__ x, float* __restrict__ cond,
                  uint8_t* __restrict__ degenerate, int* __restrict__ sweeps) {
  const int sys = blockIdx.x;
  const int r = threadIdx.x;
  const bool row = r < kN;
  const float* as = a + sys * a_batch_stride + (row ? r * a_row_stride : 0);

  double ar[kN], vr[kN];
  bool finite = true;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float v = row ? as[j] : 0.0f;
    finite = finite && isfinite(v);
    ar[j] = (double)v;
    vr[j] = (row && j == r) ? 1.0 : 0.0;
  }
  const double br = row ? (double)b[sys * b_batch_stride + r] : 0.0;
  const bool all_finite = __all_sync(kLaneMask, finite);

  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int p = 0; p < kN - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < kN; ++q) {
        const double alpha = lane_sum(ar[p] * ar[p]);
        const double beta = lane_sum(ar[q] * ar[q]);
        const double gamma = lane_sum(ar[p] * ar[q]);
        // false for NaN: non-finite input rotates nothing
        if (fabs(gamma) > kRotateTol * sqrt(alpha * beta)) {
          const double zeta = (beta - alpha) / (2.0 * gamma);
          const double t =
              copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
          const double c = 1.0 / sqrt(1.0 + t * t);
          const double s = c * t;
          const double ap = ar[p], aq = ar[q];
          ar[p] = c * ap - s * aq;
          ar[q] = s * ap + c * aq;
          const double vp = vr[p], vq = vr[q];
          vr[p] = c * vp - s * vq;
          vr[q] = s * vp + c * vq;
          rotated = true;
        }
      }
    }
    if (!rotated) break;
  }

  double s2[kN], sb[kN];
  double s_max = 0.0, s_min = INFINITY;
  bool nan_s = false;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    s2[j] = lane_sum(ar[j] * ar[j]);
    sb[j] = lane_sum(ar[j] * br);
    const double sv = sqrt(s2[j]);
    nan_s = nan_s || isnan(sv);
    s_max = fmax(s_max, sv);
    s_min = fmin(s_min, sv);
  }
  if (nan_s) s_max = s_min = NAN;
  const float s0 = (float)s_max;
  const float s5 = (float)s_min;
  const float c_num = s0 / fmaxf(s5, 1e-20f);
  const bool degen = (s0 <= 0.0f) || (c_num > cond_thres) || !all_finite;
  const double s_cut = fmax(s_max / (double)cond_thres, 1e-10);

  double xr = 0.0;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (sqrt(s2[j]) > s_cut) xr += (sb[j] / s2[j]) * vr[j];
  }
  if (row) x[sys * kN + r] = degen ? 0.0f : (float)xr;
  if (r == 0) {
    cond[sys] = c_num;
    degenerate[sys] = degen ? 1 : 0;
    if (sweeps != nullptr) sweeps[sys] = sweep;
  }
}

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
    solve6_kernel<<<n_sys, kLanes, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, a_batch_stride, a_row_stride,
        b_batch_stride, cond_thres, (float*)x, (float*)cond,
        (uint8_t*)degenerate, (int*)sweeps);
  }
  return (int)cudaGetLastError();
}
