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
// 2 sigma_r^2 by IEEE division (geometry.div_const); expf is libdevice's,
// as torch's exp on the card; the point is depth times ((u - cx) / fx);
// the normal is minus the cross product of the vertical and the horizontal
// central differences, each component one fma as torch.linalg.cross
// compiles on the card (a1 b2 - a2 b1 as fma(a1, b2, -(a2 b1))), its
// squared length summed as torch.sum of three on the card, (a + c) + b,
// then sqrtf and IEEE division. A pixel the plain version makes NaN gets
// torch.nan's bits (0x7FC00000).
//
// Layout: a CTA of 18x18 threads owns a 16x16 tile of output pixels. It
// stages the gated raw depth of the tile and a halo of radius + 1 pixels in
// shared memory (NaN off the frame), filters the tile and a one-pixel halo
// into shared memory, one pixel a thread (the halo is filtered again by
// each CTA that borders it: 324 filtered pixels for 256 outputs), and then
// its inner 16x16 threads form each output pixel's point and normal from
// the filtered depth of the pixel and its four neighbours. One launch, not
// two (filter, then points and normals): the halo's recompute costs ~27%
// more filter work but saves the second launch and the filtered depth's
// round trip through memory. The default 9x9 window (sigma_d = 2) is
// compiled with its taps unrolled (preprocess_kernel<4>), any other radius
// up to 8 loops (preprocess_kernel<0>). On an H100, a 320x240 frame: a
// first version (256 threads filtering the 324 pixels, two in some
// threads) took 0.0403 ms, one pixel a thread 0.0309, unrolled 0.0245;
// the bound is ~0.0011 ms (3.7 MB; ~58 M f32 operations).

#include "common.cuh"

namespace {

constexpr int kTile = 16;                    // output pixels a CTA side
constexpr int kFilt = kTile + 2;             // filtered tile with its halo
constexpr int kThreads = kFilt * kFilt;      // one a filtered pixel
constexpr int kMaxRadius = 8;                // filter window up to 17x17
constexpr int kDefaultRadius = 4;            // sigma_d = 2: 9x9, unrolled
constexpr int kMaxTaps = (2 * kMaxRadius + 1) * (2 * kMaxRadius + 1);
constexpr int kRawMax = kFilt + 2 * kMaxRadius;
constexpr unsigned kNanBits = 0x7FC00000u;   // torch.nan

struct PreArgs {
  const float* depth;
  long long d_s0, d_s1;
  const float* color;                        // null: no intensity
  long long c_s0, c_s1, c_s2;
  int h, w;
  float depth_min, depth_max;
  int filter, radius;
  float two_sr2;                             // 2 sigma_r^2, f32
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

// The range gate: the raw depth where finite and within
// [depth_min, depth_max], NaN elsewhere and off the frame (the plain
// filter's NaN padding).
__device__ __forceinline__ float gated(const PreArgs& a, int y, int x) {
  if (y < 0 || y >= a.h || x < 0 || x >= a.w) return nan_bits();
  const float v = a.depth[y * a.d_s0 + x * a.d_s1];
  return (isfinite(v) && v >= a.depth_min && v <= a.depth_max) ? v
                                                                : nan_bits();
}

// The camera-space point of a pixel of filtered depth d (NaN where d is
// not finite or not positive, and off the frame).
__device__ __forceinline__ float3 point_of(const PreArgs& a, float d, int y,
                                           int x) {
  if (y < 0 || y >= a.h || x < 0 || x >= a.w || !(isfinite(d) && d > 0.0f))
    return make_float3(nan_bits(), nan_bits(), nan_bits());
  const float xn = ((float)x - a.cx) / a.fx;
  const float yn = ((float)y - a.cy) / a.fy;
  return make_float3(d * xn, d * yn, d);
}

// The bilateral filter of the pixel at `c` (staged raw tiles of side
// `side`), radius kR (0: the runtime radius r; the default 4 is compiled
// with its 81 taps unrolled). A tap whose neighbour is invalid adds +0 to
// both sums, as the plain version's where(ok, ., 0.0) does.
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
        wt = a.spatial[t] * expf(-(diff * diff) / a.two_sr2);
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
  __shared__ float raw[kRawMax * kRawMax];
  __shared__ float filt[kFilt * kFilt];
  const int tid = threadIdx.y * kFilt + threadIdx.x;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int r = kR > 0 ? kR : (a.filter ? a.radius : 0);
  const int side = kFilt + 2 * r;            // staged raw tile side
  // raw(i, j) holds the gated depth of pixel (y0 - 1 - r + i, x0 - 1 - r + j)
  for (int k = tid; k < side * side; k += kThreads) {
    const int i = k / side, j = k % side;
    raw[k] = gated(a, y0 - 1 - r + i, x0 - 1 - r + j);
  }
  __syncthreads();

  // filt(i, j): the filtered depth of pixel (y0 - 1 + i, x0 - 1 + j), by
  // thread (i, j)
  {
    const float* c = raw + (threadIdx.y + r) * side + (threadIdx.x + r);
    filt[tid] = a.filter ? bilateral<kR>(a, c, side, r) : c[0];
  }
  __syncthreads();

  // the output pixels: threads (1..16, 1..16)
  const int fi = threadIdx.y, fj = threadIdx.x;
  if (fi < 1 || fi > kTile || fj < 1 || fj > kTile) return;
  const int y = y0 + fi - 1, x = x0 + fj - 1;
  if (y >= a.h || x >= a.w) return;
  const float d = filt[fi * kFilt + fj];
  const long long pix = (long long)y * a.w + x;
  a.out_depth[pix] = d;
  const float3 p = point_of(a, d, y, x);
  a.out_points[3 * pix + 0] = p.x;
  a.out_points[3 * pix + 1] = p.y;
  a.out_points[3 * pix + 2] = p.z;

  const float3 pd = point_of(a, filt[(fi + 1) * kFilt + fj], y + 1, x);
  const float3 pu = point_of(a, filt[(fi - 1) * kFilt + fj], y - 1, x);
  const float3 pr = point_of(a, filt[fi * kFilt + fj + 1], y, x + 1);
  const float3 pl = point_of(a, filt[fi * kFilt + fj - 1], y, x - 1);
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

}  // namespace

// The CTAs an SM of the kernel: the occupancy query loads the module, so
// that no first use falls inside a CUDA graph capture. -1 on an error.
extern "C" int vh_preprocess_grid() {
  int fixed = 0, any = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fixed, preprocess_kernel<kDefaultRadius>, kThreads, 0) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &any, preprocess_kernel<0>, kThreads, 0) != cudaSuccess)
    return -1;
  return fixed * 100 + any;
}

// One frame. Strides in elements; `spatial` is a host array of
// (2 radius + 1)^2 f32 spatial weights, copied into the launch's
// arguments; ops/preprocess.py checks every shape.
extern "C" int vh_preprocess(
    const void* depth, long long d_s0, long long d_s1, int h, int w,
    const void* color, long long c_s0, long long c_s1, long long c_s2,
    float depth_min, float depth_max, int filter, int radius, float two_sr2,
    const void* spatial, float fx, float fy, float cx, float cy, float wr,
    float wg, float wb, void* out_depth, void* out_points, void* out_normals,
    void* out_int, void* stream) {
  if (radius < 0 || radius > kMaxRadius || h < 1 || w < 1)
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
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  if (filter && radius == kDefaultRadius)
    preprocess_kernel<kDefaultRadius>
        <<<grid, dim3(kFilt, kFilt), 0, (cudaStream_t)stream>>>(a);
  else
    preprocess_kernel<0>
        <<<grid, dim3(kFilt, kFilt), 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
