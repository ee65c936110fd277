// The tracker's per-iteration passes, hand-written for Hopper (sm_90a):
// projective association with the whitening moments and the planarity
// scatter (icp_associate_kernel), and the whitened point-to-plane normal
// equations with, under RGB-D, the photometric rows
// (icp_linearize_kernel<kColor>); each finishes its own sums in its last
// block. One ICP iteration is these two launches and the update
// (csrc/solve6.cu): three nodes of the captured front graph in place of
// ~220 small torch launches (~330 under RGB-D).
//
// No TPU kernel: the JAX tracker runs these passes as XLA
// (voxelhashing_tpu/tracking.py:125 _associate, :183 _whitening, :210
// _planarity, :242 _linearize, :358 _build_system_color); the reference
// runs them as projectiveCorrespondencesKernel and the scanScanElementsCS
// reduction. Their plain PyTorch versions (ops/icp_linearize.py) are those
// functions op for op.
//
// Bit-equal association. Every float expression is written in the plain
// version's operation order and the library is built with -fmad=false, so
// q, n_q, the weight and the accept flag round exactly as the plain
// version's separate torch ops do on the card: the transform ((r0 x + r1 y)
// + r2 z) + t, the projection (px fx) / z + cx, IEEE division (divisions by
// constants too, as geometry.div_const gives them), floorf and the
// saturating float -> int32 conversion that torch's cast compiles to.
//
// Deterministic sums. A thread's terms are formed in f32 as the plain
// version forms them (w j_i, the weighted row) and multiplied out in f64
// (exact); a block sums its threads by a fixed shuffle tree and its warps
// in order, writes one f64 row of partial sums, and the block that
// arrives last (an atomic counter, reset by that block) sums the rows in a
// fixed pattern (thread t the blocks t, t + 128, ... in order, then the
// same tree) and rounds once to f32. No float atomics: the sums are the
// same from run to run, so the graphed and the eager step and the sharded
// ranks take the same decisions. They are not the plain version's bits (a
// cuBLAS f32 product in its own order): ops/icp_linearize.disagreements
// holds them to a stated bound.
//
// The scalar epilogues run here as the plain version computes them: every
// thread of the linearize kernel forms the mean and rsqrt(var) from the
// (reduced) moments (torch.sum of three on the card adds (a + c) + b), and
// its last block the planarity flag from the (reduced) scatter (the sum of
// nine in torch's reduction tree) and writes mean, inv_std and the flag for
// the update. Between the two kernels the multi-device step reduces the
// moments and the scatter across ranks, as the plain path does.
//
// What bounds it: not bytes (a pass moves 0.2-6 MB, 0.06-1.8 us at
// 3.35 TB/s) nor operations, but latency: the launch (an empty kernel's
// node, ~1 us, timed beside it by chip_smoke.py), the block's sums and
// the grid's sums in the last block, one after the other. Those sums are
// short loops over shared memory: the last block runs them once, in a
// few warps, and a fully unrolled body (the first version's f64 shuffle
// trees over 30 sums) cost more in instruction fetches than in arithmetic
// (0.0296 against 0.0115 ms a linearization). One thread a pixel,
// 128 a CTA (600 CTAs at 320x240, 38 at the coarsest level), no tiling.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
// association sums: sum q (3), sum |q|^2, count, then the scatter's upper
// triangle (s00 s01 s02 s11 s12 s22)
constexpr int kMoments = 5;
constexpr int kAssocSums = kMoments + 6;
// one system's sums: A's upper triangle (21), the residual row m[6, :6]
// (6), sum w e^2, sum w, count
constexpr int kSysSums = 21 + 6 + 3;
// the output layouts of ops/icp_linearize.py: association f32 [14] (sum_q,
// sum_qq, cnt, s [3,3]); linearization f32 [92] (the depth system a [6,6],
// b [6], sum_res, sum_w; the color system the same at 44; mean at 88,
// inv_std at 91) and int32 [2] (the two counts)
constexpr int kSysOut = 44;
constexpr int kMeanOut = 88;

// An f32 [h, w, c] map: element (r, x, k) at p[r * s0 + x * s1 + k].
struct Map {
  const float* p;
  long long s0, s1;
  int h, w;
};

struct Cam {
  int width, height;
  float fx, fy, cx, cy;
};

__device__ __forceinline__ const float* at(const Map& m, int r, int x) {
  return m.p + r * m.s0 + x * m.s1;
}

__device__ __forceinline__ bool finite3(float a, float b, float c) {
  return isfinite(a) && isfinite(b) && isfinite(c);
}

// torch.clamp on the card: NaN stays NaN
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.clamp of an int: min(max(v, lo), hi), so hi where lo > hi
__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// A torch index: a negative one counts from the end.
__device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : i; }

// The rigid transform of the plain version's elementwise ops:
// ((r0 x + r1 y) + r2 z) + t, each op rounded.
struct Rigid {
  float r[9], t[3];
};

__device__ __forceinline__ Rigid load_rigid(const float* delta) {
  Rigid m;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) m.r[3 * i + j] = delta[4 * i + j];
    m.t[i] = delta[4 * i + 3];
  }
  return m;
}

__device__ __forceinline__ float3 apply(const Rigid& m, float x, float y,
                                        float z) {
  return make_float3(m.r[0] * x + m.r[1] * y + m.r[2] * z + m.t[0],
                     m.r[3] * x + m.r[4] * y + m.r[5] * z + m.t[1],
                     m.r[6] * x + m.r[7] * y + m.r[8] * z + m.t[2]);
}

__device__ __forceinline__ float3 rotate(const Rigid& m, float x, float y,
                                         float z) {
  return make_float3(m.r[0] * x + m.r[1] * y + m.r[2] * z,
                     m.r[3] * x + m.r[4] * y + m.r[5] * z,
                     m.r[6] * x + m.r[7] * y + m.r[8] * z);
}

// Sum v over the block in a fixed order, in shared memory: the threads'
// values go to red (thread-major rows of kN | 1 doubles, an odd stride
// against bank conflicts); thread (e, g) adds entry e of the threads g,
// g + G, g + 2G, ... in order (G = 128 / kN groups), and thread e the G
// group sums in order. Short loops and no shuffle trees: the last block
// runs this code once, in a few warps, where a long unrolled body costs
// more in instruction fetches than in arithmetic. The sums are in
// out[0, kN) when it returns; every thread of the block must call it.
template <int kN>
__device__ __forceinline__ void block_sum(const double (&v)[kN], double* red,
                                          double* grp, double* out) {
  constexpr int kP = kN | 1, kG = kThreads / kN;
  const int t = threadIdx.x;
#pragma unroll
  for (int e = 0; e < kN; ++e) red[t * kP + e] = v[e];
  __syncthreads();
  const int e = t % kN, g = t / kN;
  if (g < kG) {
    double s = red[g * kP + e];
#pragma unroll 4
    for (int k = g + kG; k < kThreads; k += kG) s += red[k * kP + e];
    grp[g * kN + e] = s;
  }
  __syncthreads();
  if (t < kN) {
    double s = grp[t];
#pragma unroll 1
    for (int k = 1; k < kG; ++k) s += grp[k * kN + t];
    out[t] = s;
  }
  __syncthreads();
}

// Write this block's sums (out[0, kN)) as row blockIdx.x of `partials`
// (rows of `stride` doubles, at column `col`).
template <int kN>
__device__ __forceinline__ void store_partial(const double* out,
                                              double* partials, int stride,
                                              int col) {
  for (int e = threadIdx.x; e < kN; e += kThreads) {
    partials[(long long)blockIdx.x * stride + col + e] = out[e];
    __threadfence();
  }
}

// After every block stored its partials: true in the block that arrived
// last (which then resets the counter), false in the others.
__device__ __forceinline__ bool arrived_last(unsigned* counter) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned prev = atomicAdd(counter, 1u);
    last = prev == gridDim.x - 1;
    if (last) *counter = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// In the last block: the grid's sums of columns [col, col + kN) of the
// partial rows into out[0, kN), in the same fixed pattern: thread (e, g)
// adds entry e of the rows g, g + G, ... in order, thread e the G group
// sums in order.
template <int kN>
__device__ __forceinline__ void grid_sum(const double* partials, int stride,
                                         int col, double* grp, double* out) {
  constexpr int kG = kThreads / kN;
  const int t = threadIdx.x, e = t % kN, g = t / kN;
  if (g < kG) {
    double s = 0.0;
#pragma unroll 4
    for (int b = g; b < (int)gridDim.x; b += kG)
      s += __ldcg(partials + (long long)b * stride + col + e);
    grp[g * kN + e] = s;
  }
  __syncthreads();
  if (t < kN) {
    double s = grp[t];
#pragma unroll 1
    for (int k = 1; k < kG; ++k) s += grp[k * kN + t];
    out[t] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K1: association, the whitening moments, the planarity scatter
// ---------------------------------------------------------------------------

struct AssocArgs {
  const float* delta;  // f32 [4,4]: the current estimate
  Map in_pts, in_nrm;  // the level's input maps [h, w, 3]
  Map md_pts, md_nrm;  // the level's model maps; pixel v * cam.width + u
  Cam cam;
  float dist_thres, dist2_thres, normal_thres, depth_min, depth_range;
  int scatter;     // 1: the planarity scatter too
  float* corr;     // f32 [7, n]: q (3), n_q (3), the weight
  uint8_t* ok;     // bool [n]
  double* partials;  // f64 [grid, kAssocSums]
  unsigned* counter;
  float* sums;     // f32 [14]
  int n;           // the level's input pixels
};

__global__ void __launch_bounds__(kThreads)
    icp_associate_kernel(const AssocArgs p) {
  __shared__ double red[kThreads * (kAssocSums | 1)];
  __shared__ double grp[kThreads];
  __shared__ double out[kAssocSums];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  double v[kAssocSums];
#pragma unroll
  for (int e = 0; e < kAssocSums; ++e) v[e] = 0.0;
  if (i < p.n) {
    const int row = i / p.in_pts.w, col = i - row * p.in_pts.w;
    const float* ip = at(p.in_pts, row, col);
    const float* in = at(p.in_nrm, row, col);
    const float ipx = ip[0], ipy = ip[1], ipz = ip[2];
    const float inx = in[0], iny = in[1], inz = in[2];
    const Rigid m = load_rigid(p.delta);
    const float3 pc = apply(m, ipx, ipy, ipz);
    const float3 nc = rotate(m, inx, iny, inz);

    const float safe_z = (pc.z == 0.0f) ? 1e-12f : pc.z;
    const float uf = pc.x * p.cam.fx / safe_z + p.cam.cx;
    const float vf = pc.y * p.cam.fy / safe_z + p.cam.cy;
    const int ui = (int)floorf(uf + 0.5f);
    const int vi = (int)floorf(vf + 0.5f);
    const bool on = ui >= 0 && ui < p.cam.width && vi >= 0 &&
                    vi < p.cam.height && pc.z > 0.0f;
    // the plain version's table index, a row-major pixel of the model map
    const int lin = on ? vi * p.cam.width + ui : 0;
    const int mr = lin / p.md_pts.w, mc = lin - mr * p.md_pts.w;
    const float* mq = at(p.md_pts, mr, mc);
    const float* mn = at(p.md_nrm, mr, mc);
    const float qx = mq[0], qy = mq[1], qz = mq[2];
    const float nqx = mn[0], nqy = mn[1], nqz = mn[2];

    const float dx = pc.x - qx, dy = pc.y - qy, dz = pc.z - qz;
    const float dist2 = dx * dx + dy * dy + dz * dz;
    const float ndot = nc.x * nqx + nc.y * nqy + nc.z * nqz;
    const bool fin = finite3(pc.x, pc.y, pc.z) && finite3(nc.x, nc.y, nc.z) &&
                     finite3(qx, qy, qz) && finite3(nqx, nqy, nqz);
    const bool ok = on && fin && dist2 <= p.dist2_thres &&
                    ndot >= p.normal_thres;

    const float dist = sqrtf(dist2);
    const float depth01 =
        clamp_nan((pc.z - p.depth_min) / p.depth_range, 0.0f, 1.0f);
    const float w = 0.5f * ((1.0f - dist / p.dist_thres) + (1.0f - depth01));
    const float wgt = ok ? fmaxf(w, 0.0f) : 0.0f;
    const float oq[6] = {ok ? qx : 0.0f,  ok ? qy : 0.0f,  ok ? qz : 0.0f,
                         ok ? nqx : 0.0f, ok ? nqy : 0.0f, ok ? nqz : 0.0f};
#pragma unroll
    for (int k = 0; k < 6; ++k) p.corr[(long long)k * p.n + i] = oq[k];
    p.corr[6LL * p.n + i] = wgt;
    p.ok[i] = ok ? 1 : 0;

    // the moments of _whitening (q is 0 where rejected)
    v[0] = oq[0];
    v[1] = oq[1];
    v[2] = oq[2];
    v[3] = (oq[0] * oq[0] + oq[1] * oq[1] + oq[2] * oq[2]) *
           (ok ? 1.0f : 0.0f);
    v[4] = ok ? 1.0 : 0.0;
    if (p.scatter && wgt > 0.0f) {
      // _planarity: the raw input normals, weighted once in f32
      const float nr[3] = {inx, iny, inz};
      int e = kMoments;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const double nw = (double)(nr[a] * wgt);
#pragma unroll
        for (int b = a; b < 3; ++b) v[e++] = nw * (double)nr[b];
      }
    }
  }
  block_sum<kAssocSums>(v, red, grp, out);
  store_partial<kAssocSums>(out, p.partials, kAssocSums, 0);
  if (!arrived_last(p.counter)) return;
  grid_sum<kAssocSums>(p.partials, kAssocSums, 0, grp, out);
  if (threadIdx.x == 0) {
    for (int e = 0; e < kMoments; ++e) p.sums[e] = (float)out[e];
    if (p.scatter) {
      const int tri[9] = {0, 1, 2, 1, 3, 4, 2, 4, 5};
      for (int e = 0; e < 9; ++e)
        p.sums[kMoments + e] = (float)out[kMoments + tri[e]];
    }
  }
}

// ---------------------------------------------------------------------------
// K2: the normal equations (and the photometric rows under kColor)
// ---------------------------------------------------------------------------

struct LinArgs {
  const float* delta;        // f32 [4,4]
  Map in_pts;                // the level's input points [h, w, 3]
  const float* corr;         // K1's f32 [7, n]
  const uint8_t* ok;         // K1's bool [n]
  const float* sum_q;        // f32 [3], the (reduced) moments
  const float* sum_qq;       // f32 []
  const float* cnt;          // f32 []
  const float* s;            // f32 [3,3], the (reduced) scatter, or null
  float planar_thres;
  Map in_int, md_int;        // kColor: intensities [h, w, 1]
  Cam cam;
  float color_sigma;
  double* partials;          // f64 [grid, 2 * kSysSums]
  unsigned* counter;
  float* out;                // f32 [92]
  int* counts;               // int32 [2]
  uint8_t* planar;           // bool [], written where s is given
  int n;
};

// The weighted row's sums of one pixel into v: A's upper triangle from
// w j_i (rounded in f32, as (j * w) @ j.T forms it) times j_k in f64, the
// residual row from w e, sum w e^2, sum w, count.
__device__ __forceinline__ void add_row(const float (&j)[6], float e, float w,
                                        double (&v)[kSysSums]) {
  int t = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const double jw = (double)(j[a] * w);
#pragma unroll
    for (int b = a; b < 6; ++b) v[t++] = jw * (double)j[b];
  }
  const double ew = (double)(e * w);
#pragma unroll
  for (int b = 0; b < 6; ++b) v[t++] = ew * (double)j[b];
  v[t++] = ew * (double)e;
  v[t++] = (double)w;
  v[t] = 1.0;
}

// Round a system's grid sums (in) to the plain layout: a [6,6] (the upper
// triangle mirrored), b = -m[6, :6], sum_res, sum_w; the count.
__device__ __forceinline__ void write_system(const double* in, float* o,
                                             int* count) {
  int t = 0;
#pragma unroll 1
  for (int a = 0; a < 6; ++a)
#pragma unroll 1
    for (int b = a; b < 6; ++b) {
      const float x = (float)in[t++];
      o[6 * a + b] = x;
      o[6 * b + a] = x;
    }
#pragma unroll 1
  for (int b = 0; b < 6; ++b) o[36 + b] = -(float)in[t++];
  o[42] = (float)in[t++];
  o[43] = (float)in[t++];
  *count = (int)in[t];
}

template <bool kColor>
__global__ void __launch_bounds__(kThreads)
    icp_linearize_kernel(const LinArgs p) {
  __shared__ double red[kThreads * (kSysSums | 1)];
  __shared__ double grp[kThreads];
  __shared__ double out[kSysSums];
  constexpr int kStride = (kColor ? 2 : 1) * kSysSums;
  const int i = blockIdx.x * kThreads + threadIdx.x;

  // _whitening's epilogue, as the plain version's torch ops round it
  const float n_w = clamp_nan(*p.cnt, 1.0f, INFINITY);
  const float mean[3] = {p.sum_q[0] / n_w, p.sum_q[1] / n_w,
                         p.sum_q[2] / n_w};
  const float mm =
      (mean[0] * mean[0] + mean[2] * mean[2]) + mean[1] * mean[1];
  const float inv_std =
      rsqrtf(clamp_nan(*p.sum_qq / n_w - mm, 1e-8f, INFINITY));

  const Rigid m = load_rigid(p.delta);
  float ipx = 0.0f, ipy = 0.0f, ipz = 0.0f;
  if (i < p.n) {
    const int row = i / p.in_pts.w, col = i - row * p.in_pts.w;
    const float* ip = at(p.in_pts, row, col);
    ipx = ip[0];
    ipy = ip[1];
    ipz = ip[2];
  }

  double v[kSysSums];
#pragma unroll
  for (int e = 0; e < kSysSums; ++e) v[e] = 0.0;
  if (i < p.n && p.ok[i]) {
    // _linearize: rejected rows contribute nothing (their rows are zeroed
    // with where() in the plain version), accepted ones:
    const float3 pc = apply(m, ipx, ipy, ipz);
    const float q[3] = {p.corr[i], p.corr[(long long)p.n + i],
                        p.corr[2LL * p.n + i]};
    const float nq[3] = {p.corr[3LL * p.n + i], p.corr[4LL * p.n + i],
                         p.corr[5LL * p.n + i]};
    const float w = p.corr[6LL * p.n + i];
    const float pcx = (pc.x - mean[0]) * inv_std;
    const float pcy = (pc.y - mean[1]) * inv_std;
    const float pcz = (pc.z - mean[2]) * inv_std;
    const float qcx = (q[0] - mean[0]) * inv_std;
    const float qcy = (q[1] - mean[1]) * inv_std;
    const float qcz = (q[2] - mean[2]) * inv_std;
    const float e = nq[0] * (pcx - qcx) + nq[1] * (pcy - qcy) +
                    nq[2] * (pcz - qcz);
    const float crx = pcy * nq[2] - pcz * nq[1];
    const float cry = pcz * nq[0] - pcx * nq[2];
    const float crz = pcx * nq[1] - pcy * nq[0];
    const float j[6] = {crz, cry, crx, nq[0], nq[1], nq[2]};
    add_row(j, e, w, v);
  }
  block_sum<kSysSums>(v, red, grp, out);
  store_partial<kSysSums>(out, p.partials, kStride, 0);

  if (kColor) {
#pragma unroll
    for (int e = 0; e < kSysSums; ++e) v[e] = 0.0;
    if (i < p.n) {
      // _build_system_color. p = in_pts @ r.T + t: cuBLAS's dot of three
      // (two fused multiply-adds on the first product), then the add
      float3 pt;
      pt.x = fmaf(ipz, m.r[2], fmaf(ipy, m.r[1], ipx * m.r[0])) + m.t[0];
      pt.y = fmaf(ipz, m.r[5], fmaf(ipy, m.r[4], ipx * m.r[3])) + m.t[1];
      pt.z = fmaf(ipz, m.r[8], fmaf(ipy, m.r[7], ipx * m.r[6])) + m.t[2];
      const Cam& c = p.cam;
      const float safe_z = (pt.z == 0.0f) ? 1e-12f : pt.z;
      const float uf = pt.x * c.fx / safe_z + c.cx;
      const float vf = pt.y * c.fy / safe_z + c.cy;
      const float wmax = (float)(c.width - 1), hmax = (float)(c.height - 1);
      const bool on = uf >= 0.0f && uf <= wmax && vf >= 0.0f && vf <= hmax &&
                      pt.z > 0.0f;
      const float uf_c = clamp_nan(uf, 0.0f, wmax);
      const float vf_c = clamp_nan(vf, 0.0f, hmax);
      const int u0 = clamp_int((int)floorf(uf_c), 0, c.width - 2);
      const int v0 = clamp_int((int)floorf(vf_c), 0, c.height - 2);
      const float fu = uf_c - (float)u0;
      const float fv = vf_c - (float)v0;
      const Map& mi = p.md_int;
      const int ua = wrap(u0, mi.w), ub = wrap(u0 + 1, mi.w);
      const int va = wrap(v0, mi.h), vb = wrap(v0 + 1, mi.h);
      const float i00 = *at(mi, va, ua), i01 = *at(mi, va, ub);
      const float i10 = *at(mi, vb, ua), i11 = *at(mi, vb, ub);
      const float i_t = (1.0f - fv) * ((1.0f - fu) * i00 + fu * i01) +
                        fv * ((1.0f - fu) * i10 + fu * i11);
      const int ui =
          clamp_int((int)floorf(uf_c + 0.5f), 0, c.width - 1);
      const int vi =
          clamp_int((int)floorf(vf_c + 0.5f), 0, c.height - 1);
      // intensity_gradients at the nearest pixel: central differences,
      // zero on the border columns (gx) and rows (gy)
      const float gx = (ui >= 1 && ui <= mi.w - 2)
                           ? 0.5f * (*at(mi, vi, ui + 1) - *at(mi, vi, ui - 1))
                           : 0.0f;
      const float gy = (vi >= 1 && vi <= mi.h - 2)
                           ? 0.5f * (*at(mi, vi + 1, ui) - *at(mi, vi - 1, ui))
                           : 0.0f;
      const float in_i = *at(p.in_int, i / p.in_int.w,
                              i - (i / p.in_int.w) * p.in_int.w);
      const float e = i_t - in_i;
      const bool fin_t =
          isfinite(i00) && isfinite(i01) && isfinite(i10) && isfinite(i11);
      const float ax = gx * c.fx / safe_z;
      const float ay = gy * c.fy / safe_z;
      const float az = -(gx * c.fx * pt.x + gy * c.fy * pt.y) /
                       (safe_z * safe_z);
      const bool ok = on && finite3(pt.x, pt.y, pt.z) && isfinite(in_i) &&
                      fin_t && isfinite(gx) && isfinite(gy) &&
                      fabsf(e) < p.color_sigma;
      if (ok) {
        const float w = 1.0f - fabsf(e) / p.color_sigma;
        const float d[3] = {pt.x - mean[0], pt.y - mean[1], pt.z - mean[2]};
        const float a[3] = {ax, ay, az};
        // torch.linalg.cross(p - mean, a), reversed
        const float j[6] = {d[0] * a[1] - d[1] * a[0],
                            d[2] * a[0] - d[0] * a[2],
                            d[1] * a[2] - d[2] * a[1], a[0] / inv_std,
                            a[1] / inv_std, a[2] / inv_std};
        add_row(j, e, w, v);
      }
    }
    block_sum<kSysSums>(v, red, grp, out);
    store_partial<kSysSums>(out, p.partials, kStride, kSysSums);
  }

  if (!arrived_last(p.counter)) return;
  grid_sum<kSysSums>(p.partials, kStride, 0, grp, out);
  if (threadIdx.x == 0) {
    write_system(out, p.out, p.counts);
    p.out[kMeanOut] = mean[0];
    p.out[kMeanOut + 1] = mean[1];
    p.out[kMeanOut + 2] = mean[2];
    p.out[kMeanOut + 3] = inv_std;
    if (p.s != nullptr) {
      // _planarity's epilogue: I2 of the unit-trace scatter; torch.sum of
      // the nine products in its reduction tree
      const float* s = p.s;
      const float tr = s[0] + s[4] + s[8];
      const float den = clamp_nan(tr, 1e-12f, INFINITY);
      float sh[9], e[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) sh[k] = s[k] / den;
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k) e[3 * r + k] = sh[3 * r + k] * sh[3 * k + r];
      const float sum9 = (((e[0] + e[8]) + e[1]) + (e[2] + e[3])) +
                         ((e[4] + e[5]) + (e[6] + e[7]));
      const float i2 = 0.5f * (1.0f - sum9);
      *p.planar = (i2 < p.planar_thres && tr > 0.0f) ? 1 : 0;
    }
  }
  if (kColor) {
    grid_sum<kSysSums>(p.partials, kStride, kSysSums, grp, out);
    if (threadIdx.x == 0) write_system(out, p.out + kSysOut, p.counts + 1);
  }
}

template <typename Kernel>
int occupancy(Kernel kernel) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0) != cudaSuccess)
    return -1;
  return per_sm;
}

Map make_map(const void* p, long long s0, long long s1, int h, int w) {
  return Map{(const float*)p, s0, s1, h, w};
}

int grid_of(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// The CTAs an SM of each kernel (associate, linearize, linearize with
// color, packed in decimal as a * 10000 + b * 100 + c): the occupancy query
// loads the module, so that no first use falls inside a CUDA graph
// capture. -1 on an error.
extern "C" int vh_icp_linearize_grid() {
  const int a = occupancy(icp_associate_kernel);
  const int b = occupancy(icp_linearize_kernel<false>);
  const int c = occupancy(icp_linearize_kernel<true>);
  if (a < 0 || b < 0 || c < 0) return -1;
  return a * 10000 + b * 100 + c;
}

// K1 on one level. Maps are given by pointer, strides (elements; the last
// dimension contiguous), height and width; ops/icp_linearize.py checks
// every shape and holds the layouts of corr, ok and sums.
extern "C" int vh_icp_associate(
    const void* delta, const void* in_pts, const void* in_nrm,
    long long in_s0, long long in_s1, int in_h, int in_w, const void* md_pts,
    const void* md_nrm, long long md_s0, long long md_s1, int md_h, int md_w,
    int cam_w, int cam_h, float fx, float fy, float cx, float cy,
    float dist_thres, float dist2_thres, float normal_thres, float depth_min,
    float depth_range, int scatter, void* corr, void* ok, void* partials,
    void* counter, void* sums, void* stream) {
  AssocArgs a;
  a.delta = (const float*)delta;
  a.in_pts = make_map(in_pts, in_s0, in_s1, in_h, in_w);
  a.in_nrm = make_map(in_nrm, in_s0, in_s1, in_h, in_w);
  a.md_pts = make_map(md_pts, md_s0, md_s1, md_h, md_w);
  a.md_nrm = make_map(md_nrm, md_s0, md_s1, md_h, md_w);
  a.cam = Cam{cam_w, cam_h, fx, fy, cx, cy};
  a.dist_thres = dist_thres;
  a.dist2_thres = dist2_thres;
  a.normal_thres = normal_thres;
  a.depth_min = depth_min;
  a.depth_range = depth_range;
  a.scatter = scatter;
  a.corr = (float*)corr;
  a.ok = (uint8_t*)ok;
  a.partials = (double*)partials;
  a.counter = (unsigned*)counter;
  a.sums = (float*)sums;
  a.n = in_h * in_w;
  icp_associate_kernel<<<grid_of(a.n), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K2 on one level: with_color selects icp_linearize_kernel<true> (in_int
// and md_int given), s may be null (the planarity gate off).
extern "C" int vh_icp_linearize(
    const void* delta, const void* in_pts, long long in_s0, long long in_s1,
    int in_h, int in_w, const void* corr, const void* ok, const void* sum_q,
    const void* sum_qq, const void* cnt, const void* s, float planar_thres,
    int with_color, const void* in_int, long long ii_s0, long long ii_s1,
    const void* md_int, long long mi_s0, long long mi_s1, int mi_h, int mi_w,
    int cam_w, int cam_h, float fx, float fy, float cx, float cy,
    float color_sigma, void* partials, void* counter, void* out,
    void* counts, void* planar, void* stream) {
  LinArgs a;
  a.delta = (const float*)delta;
  a.in_pts = make_map(in_pts, in_s0, in_s1, in_h, in_w);
  a.corr = (const float*)corr;
  a.ok = (const uint8_t*)ok;
  a.sum_q = (const float*)sum_q;
  a.sum_qq = (const float*)sum_qq;
  a.cnt = (const float*)cnt;
  a.s = (const float*)s;
  a.planar_thres = planar_thres;
  a.in_int = make_map(in_int, ii_s0, ii_s1, in_h, in_w);
  a.md_int = make_map(md_int, mi_s0, mi_s1, mi_h, mi_w);
  a.cam = Cam{cam_w, cam_h, fx, fy, cx, cy};
  a.color_sigma = color_sigma;
  a.partials = (double*)partials;
  a.counter = (unsigned*)counter;
  a.out = (float*)out;
  a.counts = (int*)counts;
  a.planar = (uint8_t*)planar;
  a.n = in_h * in_w;
  if (with_color)
    icp_linearize_kernel<true>
        <<<grid_of(a.n), kThreads, 0, (cudaStream_t)stream>>>(a);
  else
    icp_linearize_kernel<false>
        <<<grid_of(a.n), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
