// The frame's depth preprocess, hand-written for Hopper (sm_90a): the range
// gate, the 9x9 bilateral depth filter (at the default sigma_d = 2), the
// camera-space points, the screen-space normals and, when the frame has
// color, its intensity (preprocess_kernel). One launch a frame in place of
// ~1,850 small torch launches (81 shifted views of the filter, each six
// elementwise ops, and the points' and normals' pads, stacks and products).
//
// No TPU kernel: the JAX package runs these steps as XLA
// (voxelhashing_tpu/ops/image.py:217-245 preprocess, with
// bilateral_filter_depth :36 and color_to_intensity :82;
// voxelhashing_tpu/geometry.py:203 depth_to_points, :269
// normals_from_points). Their plain PyTorch versions
// (ops/preprocess.preprocess_plain) are those functions op for op.
//
// Bit-equal to the plain version on the card. Every float expression is
// written in the plain version's operation order and the library is built
// with -fmad=false, so each result rounds as the plain version's separate
// torch ops do: the filter sums its taps in the plain loop's (dy, dx)
// order, each weight the f32 spatial weight (math.exp on the host, cast to
// f32 as torch casts a Python float) times expf of (-(diff * diff)) over
// c = 2 sigma_r^2, the quotient rounded to nearest as the plain version's
// IEEE division (geometry.div_const); expf is libdevice's, as torch's exp
// on the card; the point is depth times ((u - cx) / fx); the normal is
// minus the cross product of the vertical and the horizontal central
// differences, each component one fma as torch.linalg.cross compiles on
// the card (a1 b2 - a2 b1 as fma(a1, b2, -(a2 b1))), its squared length
// summed as torch.sum of three on the card, (a + c) + b, then sqrtf and
// IEEE division. A pixel the plain version makes NaN gets torch.nan's bits
// (0x7FC00000).
//
// The division. The IEEE division x / c is a reciprocal, three fma's, a
// range check (FCHK) and a branch to a slow path: ~9 instructions and a
// MUFU operation a tap, and the branch ends the basic block, so the
// compiler cannot interleave one tap's chain with the next. With y =
// RN(1/c) from the host (f32 division, correctly rounded), div_rn_recip
// computes q0 = RN(x y), q1 = RN(q0 + RN(x - c q0) y), q = RN(q1 + (x - c
// q1) y): five f32 operations, no MUFU and no branch. It returns RN(x / c)
// for x in [2^-96, 2^126] with x / c in [2^-100, 2^120] (c in [2^-100,
// 2^100], so that y is normal):
// - q0 is within 2 ulps of x / c (RN(x y) adds half an ulp to the half
//   ulp of 1/c that y carries, scaled by x);
// - so q1 is within 1/2 ulp + 2^-21 ulp of x / c, a faithful rounding: its
//   correction x - c q0 is exact up to one rounding (relative 2^-24), and
//   y's error multiplies the 2-ulp residual by 2^-24;
// - Markstein's theorem (P. Markstein, "Computation of elementary functions
//   on the IBM RISC System/6000 processor", IBM J. Res. Dev. 34(1), 1990;
//   J.-M. Muller et al., Handbook of Floating-Point Arithmetic, the
//   Newton-Raphson division with an fma): if y is within half an ulp of
//   1/c and q1 within one ulp of x / c, then r = x - c q1 is exact and
//   RN(q1 + r y) = RN(x / c), given no underflow or overflow in r, q1 c and
//   x y. The range keeps every intermediate normal: r is a multiple of
//   ulp(c) ulp(q1) >= 2^-146, and x y, q1 c stay below 2^127.
// Outside the range the sequence can differ (x / c past the largest float,
// where r and q become NaN; x below ~2^-106, where r underflows), so the
// tap clamps x = diff^2 into [lo, hi] = [max(2^-96, 2^-100 c), min(2^126,
// 2^120 c)] first (range_weight), which the wrapper computes for c in
// [2^-70, 2^100] (ops/preprocess.division_clamp; it refuses any other
// sigma_r). The weight expf(-q) is then the plain version's for every x:
// - x in [lo, hi]: q is RN(x / c), by the theorem;
// - x < lo (x = 0 among them): both quotients lie in [0, RN(lo / c)] and
//   RN(lo / c) <= max(2^-96 / 2^-70, 2^-100) = 2^-26, where expf(-q) is
//   1.0f (e^-q > 1 - 2^-25, the midpoint below 1);
// - x > hi, +inf among them: both quotients are at least RN(hi / c) >=
//   min(2^120, 2^126 / 2^100) = 2^26, or +inf, where expf(-q) is +0
//   (e^-128 is below half the least subnormal);
// - x NaN (a NaN centre): the clamp gives lo, but the pixel's result is
//   NaN either way (valid_c).
// chip_smoke.py checks on the card, over every f32 x in [0, +inf]
// (vh_preprocess_check_division), that expf(-q) is 1.0f for every q <=
// 2^-26 and +0 for every q >= 128 (libdevice's expf, as built here), that
// div_rn_recip is RN(x / c) on its range, and that the clamped weight is
// the IEEE one's for every x, at the default c and the edge bank's.
//
// Layout: the grid tiles the frame evenly (ops/preprocess.tile_grid):
// gx x gy CTAs, a multiple of the card's SMs where the frame is large
// enough, each owning the output pixels [x0, x1) x [y0, y1) with x0 =
// floor(bx w / gx) (tiles differ by at most a pixel; 320x240 on 132 SMs:
// 12 x 11 CTAs of 26-27 x 21-22 pixels, one a SM). A CTA of kThreads
// threads stages the gated raw depth of its tile with a radius + 1 halo
// (NaN off the frame), its loads all issued before the first gate;
// filters the tile and a one-pixel halo into shared memory (about one
// pixel a thread at 320x240: 29 x 24 = 696 of 704 threads); and then forms
// each output pixel's point and normal from the filtered depth of the pixel
// and its four neighbours, the pixel directions ((u - cx) / fx, (v - cy) /
// fy) computed once a column and a row. The default 9x9 window is compiled
// with its taps unrolled (kR = 4), any other radius up to 8 loops (kR = 0).
// The bound is ~0.0011 ms (3.7 MB; ~58 M f32 operations) at 320x240. What
// holds it is the filter's issue: ~26 instructions a tap (libdevice's
// expf alone ~8), 81 taps a pixel, 22 warps an SM; kernel_probes splits a
// CTA's cycles into staging, filter and epilogue and times each design
// move against its undoing (16x16 tiles on 300 CTAs, which put three CTAs
// on some SMs and two on the rest and filter 27% more halo; the IEEE
// division; the division unclamped; two pixels a thread).

#include "common.cuh"

namespace {

constexpr int kThreads = 704;                // 22 warps
constexpr int kMaxTileX = 64;                // output pixels a CTA, at most
constexpr int kMaxTileY = 48;
constexpr int kMaxRadius = 8;                // filter window up to 17x17
constexpr int kDefaultRadius = 4;            // sigma_d = 2: 9x9, unrolled
constexpr int kMaxTaps = (2 * kMaxRadius + 1) * (2 * kMaxRadius + 1);
constexpr int kMaxFilt = (kMaxTileX + 2) * (kMaxTileY + 2);
constexpr int kMaxRaw =
    (kMaxTileX + 2 + 2 * kMaxRadius) * (kMaxTileY + 2 + 2 * kMaxRadius);
constexpr int kRawIters = (kMaxRaw + kThreads - 1) / kThreads;
constexpr unsigned kNanBits = 0x7FC00000u;   // torch.nan

struct PreArgs {
  const float* depth;
  long long d_s0, d_s1;
  const float* color;                        // null: no intensity
  long long c_s0, c_s1, c_s2;
  int h, w;
  float depth_min, depth_max;
  int filter, radius;
  float two_sr2;                             // c = 2 sigma_r^2, f32
  float inv_two_sr2;                         // RN(1 / c), f32
  float x_lo, x_hi;                          // the division's clamp
  float fx, fy, cx, cy;
  float wr, wg, wb;                          // BT.601 weights, f32
  float* out_depth;                          // [h, w]
  float* out_points;                         // [h, w, 3]
  float* out_normals;                        // [h, w, 3]
  float* out_int;                            // [h, w], null without color
  float spatial[kMaxTaps];                   // (dy, dx) row-major, f32
};

__device__ __forceinline__ float nan_bits() {
  return __uint_as_float(kNanBits);
}

// RN(x / c) for x in [2^-96, 2^126] with x / c in [2^-100, 2^120], y =
// RN(1 / c): two Newton-Raphson corrections with fma's, the second by
// Markstein's theorem (the header says why).
__device__ __forceinline__ float div_rn_recip(float x, float c, float y) {
  const float q0 = x * y;
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, c, x), y, q0);
  return __fmaf_rn(__fmaf_rn(-q1, c, x), y, q1);
}

// A tap's range weight expf(-(x / c)) for x = diff^2, bit for bit: x
// clamped into div_rn_recip's range [lo, hi] first (the header says why
// the weight stays the same).
__device__ __forceinline__ float range_weight(float x, float c, float y,
                                              float lo, float hi) {
  return expf(-div_rn_recip(fminf(fmaxf(x, lo), hi), c, y));
}

// The range gate: the raw depth where finite and within
// [depth_min, depth_max], NaN elsewhere (and off the frame, the plain
// filter's NaN padding).
__device__ __forceinline__ float gated(const PreArgs& a, float v) {
  return (isfinite(v) && v >= a.depth_min && v <= a.depth_max) ? v
                                                                : nan_bits();
}

// The camera-space point of a pixel of filtered depth d with direction
// (xn, yn) (NaN where d is not finite or not positive, and off the frame).
__device__ __forceinline__ float3 point_of(float d, bool on, float xn,
                                           float yn) {
  if (!on || !(isfinite(d) && d > 0.0f))
    return make_float3(nan_bits(), nan_bits(), nan_bits());
  return make_float3(d * xn, d * yn, d);
}

// The bilateral filter of the pixel at `c` (staged raw tile rows of
// `side` floats), radius kR (0: the runtime radius r; the default 4 is
// compiled with its 81 taps unrolled). A tap whose neighbour is invalid
// adds +0 to both sums, as the plain version's where(ok, ., 0.0) does.
template <int kR>
__device__ __forceinline__ float bilateral(const PreArgs& a, const float* c,
                                           int side, int r) {
  const int rr = kR > 0 ? kR : r;
  const float d = c[0];
  const bool valid_c = isfinite(d);
  float acc = 0.0f, wsum = 0.0f;
  int t = 0;
#pragma unroll
  for (int dy = -rr; dy <= rr; ++dy) {
#pragma unroll
    for (int dx = -rr; dx <= rr; ++dx, ++t) {
      // the plain version's shifted view: nb(y, x) = depth(y - dy, x - dx)
      const float nb = c[-dy * side - dx];
      const bool ok = isfinite(nb);
      float wt = 0.0f;
      if (ok) {
        const float diff = nb - d;
        wt = a.spatial[t] * range_weight(diff * diff, a.two_sr2,
                                         a.inv_two_sr2, a.x_lo, a.x_hi);
      }
      acc = acc + wt * (ok ? nb : 0.0f);
      wsum = wsum + wt;
    }
  }
  // torch.clamp(wsum, min=1e-20): NaN stays NaN
  const float den = isnan(wsum) ? wsum : fmaxf(wsum, 1e-20f);
  return (wsum > 0.0f && valid_c) ? acc / den : nan_bits();
}

template <int kR>
__global__ void __launch_bounds__(kThreads)
    preprocess_kernel(const PreArgs a) {
  __shared__ float raw[kMaxRaw];
  __shared__ float filt[kMaxFilt];
  __shared__ float s_xn[kMaxTileX + 2], s_yn[kMaxTileY + 2];
  const int tid = threadIdx.x;
  // this CTA's output pixels [x0, x1) x [y0, y1): an even split
  const int x0 = (int)((long long)blockIdx.x * a.w / gridDim.x);
  const int x1 = (int)((long long)(blockIdx.x + 1) * a.w / gridDim.x);
  const int y0 = (int)((long long)blockIdx.y * a.h / gridDim.y);
  const int y1 = (int)((long long)(blockIdx.y + 1) * a.h / gridDim.y);
  const int tw = x1 - x0, th = y1 - y0;
  const int fw = tw + 2, fh = th + 2;        // filtered, with its halo
  const int r = kR > 0 ? kR : (a.filter ? a.radius : 0);
  const int side = fw + 2 * r;               // staged raw tile row
  const int n_raw = side * (fh + 2 * r);

  // raw(i, j) holds the gated depth of pixel (y0 - 1 - r + i, x0 - 1 - r + j):
  // every load issued (to a clamped pixel off the frame) before the first
  // gate, so that the round trips overlap
  {
    float v[kRawIters];
    bool on[kRawIters];
#pragma unroll
    for (int it = 0; it < kRawIters; ++it) {
      if (it * kThreads >= n_raw) break;
      const int k = tid + it * kThreads;
      const int y = y0 - 1 - r + k / side, x = x0 - 1 - r + k % side;
      on[it] = y >= 0 && y < a.h && x >= 0 && x < a.w;
      const int yc = min(max(y, 0), a.h - 1), xc = min(max(x, 0), a.w - 1);
      v[it] = k < n_raw ? a.depth[yc * a.d_s0 + xc * a.d_s1] : 0.0f;
    }
#pragma unroll
    for (int it = 0; it < kRawIters; ++it) {
      if (it * kThreads >= n_raw) break;
      const int k = tid + it * kThreads;
      if (k < n_raw) raw[k] = on[it] ? gated(a, v[it]) : nan_bits();
    }
  }
  // the directions of the filtered tile's columns and rows
  for (int k = tid; k < fw + fh; k += kThreads) {
    if (k < fw)
      s_xn[k] = ((float)(x0 - 1 + k) - a.cx) / a.fx;
    else
      s_yn[k - fw] = ((float)(y0 - 1 + k - fw) - a.cy) / a.fy;
  }
  __syncthreads();

  // filt(i, j): the filtered depth of pixel (y0 - 1 + i, x0 - 1 + j)
  for (int k = tid; k < fw * fh; k += kThreads) {
    const int i = k / fw, j = k % fw;
    const float* c = raw + (i + r) * side + (j + r);
    filt[k] = a.filter ? bilateral<kR>(a, c, side, r) : c[0];
  }
  __syncthreads();

  // the output pixels
  for (int k = tid; k < tw * th; k += kThreads) {
    const int i = k / tw + 1, j = k % tw + 1;  // in the filtered tile
    const int y = y0 + i - 1, x = x0 + j - 1;
    const float d = filt[i * fw + j];
    const long long pix = (long long)y * a.w + x;
    a.out_depth[pix] = d;
    const float3 p = point_of(d, true, s_xn[j], s_yn[i]);
    a.out_points[3 * pix + 0] = p.x;
    a.out_points[3 * pix + 1] = p.y;
    a.out_points[3 * pix + 2] = p.z;

    const float3 pd =
        point_of(filt[(i + 1) * fw + j], y + 1 < a.h, s_xn[j], s_yn[i + 1]);
    const float3 pu =
        point_of(filt[(i - 1) * fw + j], y > 0, s_xn[j], s_yn[i - 1]);
    const float3 pr =
        point_of(filt[i * fw + j + 1], x + 1 < a.w, s_xn[j + 1], s_yn[i]);
    const float3 pl =
        point_of(filt[i * fw + j - 1], x > 0, s_xn[j - 1], s_yn[i]);
    const float ay = pd.x - pu.x, by = pd.y - pu.y, cy = pd.z - pu.z;   // ddy
    const float ax = pr.x - pl.x, bx = pr.y - pl.y, cx = pr.z - pl.z;   // ddx
    // n = -cross(ddy, ddx), each component as torch's cross on the card
    const float n0 = -__fmaf_rn(by, cx, -(cy * bx));
    const float n1 = -__fmaf_rn(cy, ax, -(ay * cx));
    const float n2 = -__fmaf_rn(ay, bx, -(by * ax));
    const float norm = sqrtf((n0 * n0 + n2 * n2) + n1 * n1);
    const bool nv = isfinite(norm) && norm > 0.0f;
    a.out_normals[3 * pix + 0] = nv ? n0 / norm : nan_bits();
    a.out_normals[3 * pix + 1] = nv ? n1 / norm : nan_bits();
    a.out_normals[3 * pix + 2] = nv ? n2 / norm : nan_bits();

    if (a.color != nullptr) {
      const float* c = a.color + y * a.c_s0 + x * a.c_s1;
      a.out_int[pix] =
          (a.wr * c[0] + a.wg * c[a.c_s2]) + a.wb * c[2 * a.c_s2];
    }
  }
}

// Whether x >= 0 lies in div_rn_recip's range at c.
__device__ __forceinline__ bool in_recip_range(float x, float c) {
  const float q = x / c;
  return x >= 0x1p-96f && x <= 0x1p126f && q >= 0x1p-100f && q <= 0x1p120f;
}

// The division check over every f32 x in [0, +inf] (bit patterns up to
// 0x7F800000), each a count of the x where a claim fails: out[0] the
// tap's weight range_weight(x) against expf(-(x / c)) (the IEEE
// division); out[1] div_rn_recip against x / c on its range; out[2]
// expf(-x) not 1.0f for x <= 2^-26; out[3] expf(-x) not +0 for x >= 128.
__global__ void division_check_kernel(float c, float y, float lo, float hi,
                                      unsigned long long* out) {
  const unsigned stride = gridDim.x * blockDim.x;
  unsigned long long n[4] = {0, 0, 0, 0};
  for (unsigned b = blockIdx.x * blockDim.x + threadIdx.x; b <= 0x7F800000u;
       b += stride) {
    const float x = __uint_as_float(b);
    const float q = x / c;
    n[0] += __float_as_uint(range_weight(x, c, y, lo, hi)) !=
            __float_as_uint(expf(-q));
    n[1] += in_recip_range(x, c) &&
            __float_as_uint(div_rn_recip(x, c, y)) != __float_as_uint(q);
    n[2] += x <= 0x1p-26f && expf(-x) != 1.0f;
    n[3] += x >= 128.0f && __float_as_uint(expf(-x)) != 0u;
  }
  for (int k = 0; k < 4; ++k)
    if (n[k]) atomicAdd(out + k, n[k]);
}

template <int kR>
void launch(const PreArgs& a, int gx, int gy, cudaStream_t stream) {
  preprocess_kernel<kR><<<dim3(gx, gy), kThreads, 0, stream>>>(a);
}

}  // namespace

// The CTAs an SM of each instantiation (<4>, <0>, as two decimal digits):
// the occupancy query loads the module, so that no first use falls inside
// a CUDA graph capture. -1 on an error.
extern "C" int vh_preprocess_grid() {
  int n[2] = {0, 0};
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n[0], preprocess_kernel<kDefaultRadius>, kThreads, 0) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n[1], preprocess_kernel<0>, kThreads, 0) != cudaSuccess)
    return -1;
  return n[0] * 10 + n[1];
}

// One frame on a gx x gy grid (ops/preprocess.tile_grid: every tile at most
// kMaxTileX x kMaxTileY) with the instantiation the wrapper chose
// (`kernel`: 0 preprocess_kernel<4>, for the 9x9 window only; 1
// preprocess_kernel<0>, any radius or no filter). Strides in elements;
// `spatial` is a host array of (2 radius + 1)^2 f32 spatial weights,
// copied into the launch's arguments; [x_lo, x_hi] is the division's
// clamp (ops/preprocess.division_clamp); ops/preprocess.py checks every
// shape.
extern "C" int vh_preprocess(
    const void* depth, long long d_s0, long long d_s1, int h, int w,
    const void* color, long long c_s0, long long c_s1, long long c_s2,
    float depth_min, float depth_max, int filter, int radius, float two_sr2,
    float inv_two_sr2, float x_lo, float x_hi, int kernel,
    const void* spatial, float fx, float fy, float cx, float cy, float wr,
    float wg, float wb, void* out_depth, void* out_points,
    void* out_normals, void* out_int, int gx, int gy, void* stream) {
  if (radius < 0 || radius > kMaxRadius || h < 1 || w < 1 || gx < 1 ||
      gy < 1 || gx > w || gy > h || (w + gx - 1) / gx > kMaxTileX ||
      (h + gy - 1) / gy > kMaxTileY || kernel < 0 || kernel > 1 ||
      (kernel == 0 && !(filter && radius == kDefaultRadius)))
    return (int)cudaErrorInvalidValue;
  PreArgs a;
  a.depth = (const float*)depth;
  a.d_s0 = d_s0;
  a.d_s1 = d_s1;
  a.color = (const float*)color;
  a.c_s0 = c_s0;
  a.c_s1 = c_s1;
  a.c_s2 = c_s2;
  a.h = h;
  a.w = w;
  a.depth_min = depth_min;
  a.depth_max = depth_max;
  a.filter = filter;
  a.radius = radius;
  a.two_sr2 = two_sr2;
  a.inv_two_sr2 = inv_two_sr2;
  a.x_lo = x_lo;
  a.x_hi = x_hi;
  a.fx = fx;
  a.fy = fy;
  a.cx = cx;
  a.cy = cy;
  a.wr = wr;
  a.wg = wg;
  a.wb = wb;
  a.out_depth = (float*)out_depth;
  a.out_points = (float*)out_points;
  a.out_normals = (float*)out_normals;
  a.out_int = (float*)out_int;
  const int taps = (2 * radius + 1) * (2 * radius + 1);
  for (int t = 0; t < kMaxTaps; ++t)
    a.spatial[t] = (filter && t < taps) ? ((const float*)spatial)[t] : 0.0f;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kernel) {
    case 0: launch<kDefaultRadius>(a, gx, gy, s); break;
    default: launch<0>(a, gx, gy, s); break;
  }
  return (int)cudaGetLastError();
}

// The division's claims over every f32 x in [0, +inf] at (c, y = RN(1/c))
// with the clamp [lo, hi]: `out` (device, four u64, division_check_kernel's
// counts) is reset and filled on the stream; the caller synchronizes.
extern "C" int vh_preprocess_check_division(float c, float y, float lo,
                                            float hi, void* out,
                                            void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* o = (unsigned long long*)out;
  cudaMemsetAsync(o, 0, 4 * sizeof(*o), s);
  division_check_kernel<<<132 * 16, 256, 0, s>>>(c, y, lo, hi, o);
  return (int)cudaGetLastError();
}
