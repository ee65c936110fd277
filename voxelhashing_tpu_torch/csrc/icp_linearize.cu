// The tracker's per-iteration passes, hand-written for Hopper (sm_90a):
// projective association with the whitening moments and the planarity
// scatter, and the whitened point-to-plane normal equations with, under
// RGB-D, the photometric rows. One kernel template,
// icp_pass_kernel<kAssoc, kLin, kColor>, in three forms: the association
// alone, the linearization alone (the multi-device step reduces the
// moments and the scatter across ranks between the two, and an inner
// iteration after the first linearizes again on the same
// correspondences), and both in one launch (kAssoc && kLin), the
// single-device step's form: one launch and the update (csrc/solve6.cu)
// an ICP iteration.
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
// What bounds it: not bytes (a pass moves 0.2-6 MB, 0.06-1.8 us at
// 3.35 TB/s) nor operations, but latency, a chain of dependent steps in
// every launch: the launch itself (an empty kernel's node, ~1-1.7 us,
// timed beside it by chip_smoke.py), the loads, the block's sums, the
// arrival, the last CTA's sums of the grid's rows. The first design (one
// thread a pixel, 128 a CTA, two launches an iteration) paid that chain
// twice an iteration, summed a block through 31.7 KB of shared memory in
// chains of 32 adds, and finished the grid in one CTA whose threads each
// added up to 150 partial rows in one chain of dependent L2 loads (~38
// round trips at 320x240). This design shortens each link:
//
// - A persistent grid, the same for every form at a level: G = min(ceil(n
//   / 256), SMs x the CTAs an SM holds of the most demanding form), so all
//   CTAs of a launch are resident at once. Thread t of CTA b takes pixels
//   b * 256 + t, then + 256 G, ... in order, summing its terms in f64
//   registers: 264 partial rows at 76,800 pixels, not 600.
// - A warp-level block sum by transpose-reduce: at each of five shuffle
//   rounds (lane masks 16, 8, 4, 2, 1) a lane keeps half of its live sums
//   and adds its partner's copy of them, so 30 sums take 16 + 8 + 4 + 2 +
//   1 f64 shuffles (11 sums 8 + 4 + 2 + 1 + 1), not 30 x 5, and leave
//   sum k in lane k. The eight warps' rows are then added in warp order
//   from 2 KB of shared memory.
// - A parallel grid sum. The CTA that arrives last (an acquire-release
//   atomic counter that it resets; no separate fences) adds the rows with
//   all its threads: thread (c, g) adds column c of the rows g, g + R, g +
//   2R, ... (R = 256 / columns), sixteen rows at a time issued together
//   and added as a pairwise tree, chunk after chunk; then thread c adds
//   the R group sums in order. Two or three L2 round trips replace ~38.
//   Thread-block clusters (a first sum over up to 8 CTAs in distributed
//   shared memory) were not taken: with one to three rows a thread the
//   grid sum is already a few round trips, and a cluster launch would not
//   shorten the barrier below.
// - One launch for both passes on a single device. The linearization
//   needs only the association's global sums; so after the association
//   every CTA stores its row and meets the others at a grid barrier, then
//   sums the moments' columns of all rows itself, in the split form's
//   order (block 0 the scatter's too, and it writes the association's
//   sums), rounds them to f32 as the split form's outputs hold them, and
//   linearizes its threads' first pixels from the association they hold
//   in registers (further pixels from the correspondences the thread
//   wrote, which it still writes: later inner iterations and the checks
//   read them). A barrier and one L2 round trip replace the last CTA's
//   serial sum, a published result and a second launch. Nothing meets
//   after that sum: a CTA that has summed writes its linearization row
//   while slower CTAs still read the association's rows, so the two row
//   sets must not alias (AssocArgs.partials and LinArgs.partials are
//   disjoint regions of the level's buffer; vh_icp_pass refuses a fused
//   launch whose regions overlap). The barrier is one
//   word that no one resets (block 0 adds 2^31 - (G - 1), the others 1:
//   its top bit flips when the last CTA arrives), waited on with acquire
//   loads that trap after 5 s, so a fault cannot hang the card. It needs
//   every CTA resident: the fused form is launched with
//   cudaLaunchAttributeCooperative, inside CUDA graph captures too, and a
//   refused launch returns its error to the wrapper, which raises. The
//   barrier word and the counters are zero-filled once a level
//   (ops/icp_linearize.Level.work) and never reset by the host, so graph
//   replays find them as the last launch left them.
// - The last CTA's outputs one thread each, the scatter's loads (for the
//   planarity flag) issued beside the grid sum's.
//
// What is left (chip_smoke.py phase 10 (b) times each form at each
// level; clock64 stamps in a scratch build showed where): about ten
// dependent L2 round trips (the inputs, the model's gather, the barrier's
// release, atomic and poll, the rows' loads, the second arrival, the last
// CTA's loads) and the IEEE divisions between them. At 320x240 the
// threads of 36 CTAs hold two pixels (67,584 resident threads at 128
// registers), whose chains run one after the other. Staging two pixels'
// loads together spilled registers and was slower, and fences before
// plain atomics were slower than the acquire-release atomics; neither was
// kept. The cooperative launch is accepted inside a CUDA graph capture
// (CUDA 12.8).
//
// Deterministic sums. A thread's terms are formed in f32 as the plain
// version forms them (w j_i, the weighted row) and multiplied out in f64
// (exact), and every sum above runs in an order fixed by n and the card
// alone, rounded once to f32 at the end. No float atomics: the sums are
// the same from run to run; the fused launch gives the split pair's
// outputs bit for bit (same grid, rows and order); the graphed and the
// eager step and the sharded ranks take the same decisions. They are not
// the plain version's bits (a cuBLAS f32 product in its own order):
// ops/icp_linearize.disagreements holds them to a stated bound, and
// tests/icp_sum_order.py models this order in numpy.
//
// The scalar epilogues run here as the plain version computes them: every
// thread of the linearization forms the mean and rsqrt(var) from the
// (reduced) moments (torch.sum of three on the card adds (a + c) + b), and
// its last CTA the planarity flag from the (reduced) scatter (the sum of
// nine in torch's reduction tree) and writes mean, inv_std and the flag
// for the update.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the CTAs an SM must hold of every form (128 registers a thread at most)
constexpr int kMinCtas = 2;
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
// partial rows a thread of the last CTA loads at once (grid_sum's tree is
// written for 16)
constexpr int kChunk = 16;
// the fused form's wait at its grid barrier, before it traps
constexpr unsigned long long kWaitNs = 5000000000ull;

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

// ---------------------------------------------------------------------------
// The launch's arguments (ops/icp_linearize.py mirrors both structs with
// ctypes; vh_icp_pass checks their sizes)
// ---------------------------------------------------------------------------

struct AssocArgs {
  const float* delta;  // f32 [4,4]: the current estimate
  Map in_pts, in_nrm;  // the level's input maps [h, w, 3]
  Map md_pts, md_nrm;  // the level's model maps; pixel v * cam.width + u
  Cam cam;
  float dist_thres, dist2_thres, normal_thres, depth_min, depth_range;
  int scatter;         // 1: the planarity scatter too
  float* corr;         // f32 [7, n]: q (3), n_q (3), the weight
  uint8_t* ok;         // bool [n]
  double* partials;    // f64 [grid, kAssocSums], apart from LinArgs'
  unsigned* counter;   // the arrival counter, 0 between launches
  unsigned* barrier;   // the fused form's grid barrier word
  float* sums;         // f32 [14]
  int n;               // the level's input pixels
};

struct LinArgs {
  const float* delta;  // f32 [4,4]
  Map in_pts;          // the level's input points [h, w, 3]
  const float* corr;   // the association's f32 [7, n]
  const uint8_t* ok;   // the association's bool [n]
  const float* sum_q;  // f32 [3], the (reduced) moments
  const float* sum_qq;  // f32 []
  const float* cnt;    // f32 []
  const float* s;      // f32 [3,3], the (reduced) scatter, or null
  float planar_thres;
  int color;           // 1: the photometric rows (in_int, md_int)
  Map in_int, md_int;  // intensities [h, w, 1]
  Cam cam;
  float color_sigma;
  double* partials;    // f64 [grid, (color ? 2 : 1) * kSysSums]
  unsigned* counter;
  float* out;          // f32 [92]
  int* counts;         // int32 [2]
  uint8_t* planar;     // bool [], written where s is given
  int n;
};

// ---------------------------------------------------------------------------
// Memory order and the block's and the grid's sums
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Sum v over the warp by transpose-reduce, v padded to kP (a power of 2,
// at most 32) with zeros: at round r (lane mask 16 >> r) a lane whose mask
// bit is set keeps the upper half of its live sums, the other lane the
// lower half, and each adds its partner's copy of the half it keeps; once
// one sum is live, the rounds left add the partner's copy of it. Sum k
// ends in the lanes whose kept halves index k (lane k for kP = 32). Each
// sum is the butterfly tree over the lanes (pairs at lane distance 16,
// then 8, 4, 2, 1): f64 addition commutes, so either lane of a pair gets
// the same bits.
template <int kLive, int kMask, int kP>
__device__ __forceinline__ void transpose_round(double (&v)[kP], int lane) {
  if constexpr (kLive > 1) {
    constexpr int h = kLive / 2;
    const bool upper = (lane & kMask) != 0;
#pragma unroll
    for (int k = 0; k < h; ++k) {
      const double send = upper ? v[k] : v[k + h];
      const double keep = upper ? v[k + h] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, kMask);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], kMask);
  }
}

template <int kP>
__device__ __forceinline__ void transpose_reduce(double (&v)[kP], int lane) {
  static_assert(kP >= 1 && kP <= 32 && (kP & (kP - 1)) == 0, "kP");
  transpose_round<kP, 16>(v, lane);
  transpose_round<(kP >> 1), 8>(v, lane);
  transpose_round<(kP >> 2), 4>(v, lane);
  transpose_round<(kP >> 3), 2>(v, lane);
  transpose_round<(kP >> 4), 1>(v, lane);
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// The block's sums of v (kN per thread) as row blockIdx.x of `partials`
// (rows of `stride` doubles, at column `col`): each warp's transpose-reduce,
// then thread k adds sum k of the warps in warp order. Every thread of the
// block must call it.
template <int kN>
__device__ __forceinline__ void block_row(const double (&v)[kN], double* red,
                                          double* partials, int stride,
                                          int col) {
  constexpr int kP = pow2_at_least(kN);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  double w[kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) w[k] = k < kN ? v[k] : 0.0;
  transpose_reduce<kP>(w, lane);
  // the sum this lane holds, and whether it is the lane that stores it
  int idx = 0;
  bool owner = true;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const int mask = 16 >> r, live = kP >> r;
    if (live > 1)
      idx += (lane & mask) ? live / 2 : 0;
    else
      owner = owner && !(lane & mask);
  }
  if (owner && idx < kN) red[warp * 32 + idx] = w[0];
  __syncthreads();
  if (t < kN) {
    double s = red[t];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) s += red[k * 32 + t];
    partials[(long long)blockIdx.x * stride + col + t] = s;
  }
  __syncthreads();
}

// After every thread stored its part of the block's row: true in the block
// that arrived last (which resets the counter), false in the others. One
// acquire-release atomic a block: its release covers the row the block's
// threads stored before the barrier, its acquire (in the last block) the
// other blocks' rows.
__device__ __forceinline__ bool arrive(unsigned* counter) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(prev)
                 : "l"(counter)
                 : "memory");
    last = prev == gridDim.x - 1;
    if (last) *counter = 0u;
  }
  __syncthreads();
  return last;
}

// A grid barrier on one word that no one resets: block 0 adds 2^31 - (G -
// 1), every other block 1, so the word's top bit flips when the last block
// arrives and its low bits return to what they were (0 from the zero fill
// on). Each block waits for the flip with acquire loads, bounded: after
// kWaitNs it traps, so a fault cannot hang the card. Every CTA of the grid
// must be resident (the cooperative launch).
__device__ __forceinline__ void grid_barrier(unsigned* word) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned old;
    asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;"
                 : "=r"(old)
                 : "l"(word), "r"(add)
                 : "memory");
    const unsigned long long t0 = now_ns();
    while (((old ^ load_acquire(word)) & 0x80000000u) == 0)
      if (now_ns() - t0 > kWaitNs) __trap();
  }
  __syncthreads();
}

// The grid's sums of the first `cols` of the kN columns of the partial rows
// (rows of kN doubles) into out[0, cols). Thread (c, g) adds column c of
// the rows g, g + kG, g + 2 kG, ...: kChunk of them loaded together (zeros
// past the last row) and added as a pairwise tree, the chunks' sums in
// order; then thread c adds the kG group sums in order. A column's order
// depends on kN alone, whatever `cols` is.
template <int kN>
__device__ __forceinline__ void grid_sum(const double* partials, double* grp,
                                         double* out, int cols = kN) {
  constexpr int kG = kThreads / kN;
  const int t = threadIdx.x, c = t % kN, g = t / kN;
  const int rows = gridDim.x;
  if (g < kG && c < cols) {
    double acc = 0.0;
    for (int b0 = g; b0 < rows; b0 += kG * kChunk) {
      double x[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int b = b0 + j * kG;
        x[j] = b < rows ? __ldcg(partials + (long long)b * kN + c) : 0.0;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] += x[j + 8];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] += x[j + 4];
      x[0] += x[2];
      x[1] += x[3];
      acc += x[0] + x[1];
    }
    grp[g * kN + c] = acc;
  }
  __syncthreads();
  if (t < cols) {
    double s = grp[t];
#pragma unroll 1
    for (int k = 1; k < kG; ++k) s += grp[k * kN + t];
    out[t] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The per-pixel work
// ---------------------------------------------------------------------------

// One pixel's association, as the linearization needs it: the transformed
// point, q, n_q, the weight and the flag.
struct Corr {
  float px, py, pz, q[3], nq[3], w;
  bool ok;
};

// _associate at pixel i: writes the correspondence and the flag and adds
// the pixel's terms of the moments (and of the scatter) to v.
__device__ __forceinline__ void associate_pixel(const AssocArgs& p,
                                                const Rigid& m, int i,
                                                Corr& c,
                                                double (&v)[kAssocSums]) {
  const int row = i / p.in_pts.w, col = i - row * p.in_pts.w;
  const float* ip = at(p.in_pts, row, col);
  const float* in = at(p.in_nrm, row, col);
  const float ipx = ip[0], ipy = ip[1], ipz = ip[2];
  const float inx = in[0], iny = in[1], inz = in[2];
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
  c.px = pc.x;
  c.py = pc.y;
  c.pz = pc.z;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c.q[k] = oq[k];
    c.nq[k] = oq[3 + k];
  }
  c.w = wgt;
  c.ok = ok;

  // the moments of _whitening (q is 0 where rejected)
  v[0] += oq[0];
  v[1] += oq[1];
  v[2] += oq[2];
  v[3] += (oq[0] * oq[0] + oq[1] * oq[1] + oq[2] * oq[2]) *
          (ok ? 1.0f : 0.0f);
  v[4] += ok ? 1.0 : 0.0;
  if (p.scatter && wgt > 0.0f) {
    // _planarity: the raw input normals, weighted once in f32
    const float nr[3] = {inx, iny, inz};
    int e = kMoments;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const double nw = (double)(nr[a] * wgt);
#pragma unroll
      for (int b = a; b < 3; ++b) v[e++] += nw * (double)nr[b];
    }
  }
}

// Pixel i's association as the split linearization reads it back.
__device__ __forceinline__ Corr load_corr(const LinArgs& p, const Rigid& m,
                                          int i) {
  Corr c;
  c.ok = p.ok[i] != 0;
  if (c.ok) {
    const int row = i / p.in_pts.w, col = i - row * p.in_pts.w;
    const float* ip = at(p.in_pts, row, col);
    const float3 pc = apply(m, ip[0], ip[1], ip[2]);
    c.px = pc.x;
    c.py = pc.y;
    c.pz = pc.z;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c.q[k] = p.corr[(long long)k * p.n + i];
      c.nq[k] = p.corr[(long long)(3 + k) * p.n + i];
    }
    c.w = p.corr[6LL * p.n + i];
  }
  return c;
}

// The weighted row's terms of one pixel added to v: A's upper triangle
// from w j_i (rounded in f32, as (j * w) @ j.T forms it) times j_k in f64
// (exact), the residual row from w e, w e^2, w, the count.
__device__ __forceinline__ void add_row(const float (&j)[6], float e, float w,
                                        double (&v)[kSysSums]) {
  int t = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const double jw = (double)(j[a] * w);
#pragma unroll
    for (int b = a; b < 6; ++b) v[t++] += jw * (double)j[b];
  }
  const double ew = (double)(e * w);
#pragma unroll
  for (int b = 0; b < 6; ++b) v[t++] += ew * (double)j[b];
  v[t++] += ew * (double)e;
  v[t++] += (double)w;
  v[t] += 1.0;
}

// _linearize at one pixel: rejected pixels add nothing (their rows are
// zeroed with where() in the plain version), accepted ones their row.
__device__ __forceinline__ void depth_row(const Corr& c, const float (&mean)[3],
                                          float inv_std,
                                          double (&v)[kSysSums]) {
  if (!c.ok) return;
  const float pcx = (c.px - mean[0]) * inv_std;
  const float pcy = (c.py - mean[1]) * inv_std;
  const float pcz = (c.pz - mean[2]) * inv_std;
  const float qcx = (c.q[0] - mean[0]) * inv_std;
  const float qcy = (c.q[1] - mean[1]) * inv_std;
  const float qcz = (c.q[2] - mean[2]) * inv_std;
  const float* nq = c.nq;
  const float e = nq[0] * (pcx - qcx) + nq[1] * (pcy - qcy) +
                  nq[2] * (pcz - qcz);
  const float crx = pcy * nq[2] - pcz * nq[1];
  const float cry = pcz * nq[0] - pcx * nq[2];
  const float crz = pcx * nq[1] - pcy * nq[0];
  const float j[6] = {crz, cry, crx, nq[0], nq[1], nq[2]};
  add_row(j, e, c.w, v);
}

// _build_system_color at pixel i: the photometric row of an accepted
// pixel added to v.
__device__ __forceinline__ void color_row(const LinArgs& p, const Rigid& m,
                                          int i, const float (&mean)[3],
                                          float inv_std,
                                          double (&v)[kSysSums]) {
  const int row = i / p.in_pts.w, col = i - row * p.in_pts.w;
  const float* ip = at(p.in_pts, row, col);
  const float ipx = ip[0], ipy = ip[1], ipz = ip[2];
  // p = in_pts @ r.T + t: cuBLAS's dot of three (two fused multiply-adds
  // on the first product), then the add
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
  const int ui = clamp_int((int)floorf(uf_c + 0.5f), 0, c.width - 1);
  const int vi = clamp_int((int)floorf(vf_c + 0.5f), 0, c.height - 1);
  // intensity_gradients at the nearest pixel: central differences, zero
  // on the border columns (gx) and rows (gy)
  const float gx = (ui >= 1 && ui <= mi.w - 2)
                       ? 0.5f * (*at(mi, vi, ui + 1) - *at(mi, vi, ui - 1))
                       : 0.0f;
  const float gy = (vi >= 1 && vi <= mi.h - 2)
                       ? 0.5f * (*at(mi, vi + 1, ui) - *at(mi, vi - 1, ui))
                       : 0.0f;
  const float in_i =
      *at(p.in_int, i / p.in_int.w, i - (i / p.in_int.w) * p.in_int.w);
  const float e = i_t - in_i;
  const bool fin_t =
      isfinite(i00) && isfinite(i01) && isfinite(i10) && isfinite(i11);
  const float ax = gx * c.fx / safe_z;
  const float ay = gy * c.fy / safe_z;
  const float az =
      -(gx * c.fx * pt.x + gy * c.fy * pt.y) / (safe_z * safe_z);
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

// Sum e of a system's grid sums (x) in the plain layout, one thread a sum:
// a [6,6] (the upper triangle's entry mirrored), b = -m[6, :6], sum_res,
// sum_w; the count.
__device__ __forceinline__ void write_sum(int e, double x, float* o,
                                          int* count) {
  if (e < 21) {
    int a = 0, r = e;
    while (r >= 6 - a) r -= 6 - a++;
    const int b = a + r;
    o[6 * a + b] = (float)x;
    o[6 * b + a] = (float)x;
  } else if (e < 27) {
    o[36 + e - 21] = -(float)x;
  } else if (e < 29) {
    o[42 + e - 27] = (float)x;
  } else {
    *count = (int)x;
  }
}

// _planarity's epilogue: I2 of the unit-trace scatter s; torch.sum of the
// nine products in its reduction tree.
__device__ __forceinline__ bool planar_flag(const float (&s)[9],
                                            float thres) {
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
  return i2 < thres && tr > 0.0f;
}

// ---------------------------------------------------------------------------
// The kernel: the association (kAssoc), the linearization (kLin, with the
// photometric rows under kColor), or both in one launch
// ---------------------------------------------------------------------------

template <bool kAssoc, bool kLin, bool kColor>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    icp_pass_kernel(const AssocArgs a, const LinArgs l) {
  constexpr int kStride = (kColor ? 2 : 1) * kSysSums;
  __shared__ double red[kWarps * 32];
  __shared__ double grp[kThreads];
  __shared__ double out[kStride];
  const int t = threadIdx.x;
  const int first = blockIdx.x * kThreads + t;
  const int stride = gridDim.x * kThreads;
  Corr held;  // the fused form: this thread's first pixel
  held.ok = false;

  float mom[kMoments];  // the (reduced) moments, f32 as the outputs hold them
  if (kAssoc) {
    const Rigid m = load_rigid(a.delta);
    double v[kAssocSums];
#pragma unroll
    for (int e = 0; e < kAssocSums; ++e) v[e] = 0.0;
    if (first < a.n) associate_pixel(a, m, first, held, v);
    for (int i = first + stride; i < a.n; i += stride) {
      Corr c;
      associate_pixel(a, m, i, c, v);
    }
    block_row<kAssocSums>(v, red, a.partials, kAssocSums, 0);
    const int cols = a.scatter ? kAssocSums : kMoments;
    if (kLin) {
      // the fused form: every block sums the moments' columns of the rows
      // itself, in the split form's order; block 0 the scatter's too, and
      // writes the association's sums. No barrier follows: the
      // linearization's rows below go to their own region, never over
      // the rows a slower block is still reading here.
      grid_barrier(a.barrier);
      grid_sum<kAssocSums>(a.partials, grp, out,
                           blockIdx.x == 0 ? cols : kMoments);
    } else {
      if (!arrive(a.counter)) return;
      grid_sum<kAssocSums>(a.partials, grp, out, cols);
    }
    if (blockIdx.x == 0 || !kLin) {
      if (t < kMoments) a.sums[t] = (float)out[t];
      if (a.scatter && t >= kMoments && t < kMoments + 9) {
        // s [3,3] from the upper triangle: entry (r, c) is sum
        // i (5 - i) / 2 + j, i = min(r, c), j = max(r, c)
        const int r = (t - kMoments) / 3, c = (t - kMoments) % 3;
        const int i = min(r, c), j = max(r, c);
        a.sums[t] = (float)out[kMoments + i * (5 - i) / 2 + j];
      }
    }
    if (!kLin) return;
#pragma unroll
    for (int e = 0; e < kMoments; ++e) mom[e] = (float)out[e];
  } else {
    // L2 loads: the association or the reduction wrote them
#pragma unroll
    for (int e = 0; e < 3; ++e) mom[e] = __ldcg(l.sum_q + e);
    mom[3] = __ldcg(l.sum_qq);
    mom[4] = __ldcg(l.cnt);
  }

  // _whitening's epilogue from the (reduced) moments, as the plain
  // version's torch ops round it
  const float n_w = clamp_nan(mom[4], 1.0f, INFINITY);
  const float mean[3] = {mom[0] / n_w, mom[1] / n_w, mom[2] / n_w};
  const float mm =
      (mean[0] * mean[0] + mean[2] * mean[2]) + mean[1] * mean[1];
  const float inv_std =
      rsqrtf(clamp_nan(mom[3] / n_w - mm, 1e-8f, INFINITY));
  const Rigid m = load_rigid(l.delta);

  {
    double v[kSysSums];
#pragma unroll
    for (int e = 0; e < kSysSums; ++e) v[e] = 0.0;
    int i = first;
    if (kAssoc) {
      if (i < l.n) depth_row(held, mean, inv_std, v);
      i += stride;
    }
    for (; i < l.n; i += stride)
      depth_row(load_corr(l, m, i), mean, inv_std, v);
    block_row<kSysSums>(v, red, l.partials, kStride, 0);
  }
  if (kColor) {
    double v[kSysSums];
#pragma unroll
    for (int e = 0; e < kSysSums; ++e) v[e] = 0.0;
    for (int i = first; i < l.n; i += stride)
      color_row(l, m, i, mean, inv_std, v);
    block_row<kSysSums>(v, red, l.partials, kStride, kSysSums);
  }

  if (!arrive(l.counter)) return;
  // the last block: the scatter's loads beside the grid sum's (a thread
  // that the grid sum leaves idle), then every output by its own thread
  constexpr int kPlanarThread = kThreads - 1;
  static_assert((kThreads / kStride) * kStride <= kPlanarThread, "idle");
  float s9[9];
  if (t == kPlanarThread && l.s != nullptr) {
#pragma unroll
    for (int k = 0; k < 9; ++k) s9[k] = __ldcg(l.s + k);
  }
  grid_sum<kStride>(l.partials, grp, out);
  if (t < kStride)
    write_sum(t % kSysSums, out[t], l.out + (t / kSysSums) * kSysOut,
              l.counts + t / kSysSums);
  if (t == kStride) {
#pragma unroll
    for (int k = 0; k < 3; ++k) l.out[kMeanOut + k] = mean[k];
    l.out[kMeanOut + 3] = inv_std;
  }
  if (t == kPlanarThread && l.s != nullptr)
    *l.planar = planar_flag(s9, l.planar_thres) ? 1 : 0;
}

template <bool kAssoc, bool kLin, bool kColor>
int occupancy() {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, icp_pass_kernel<kAssoc, kLin, kColor>, kThreads, 0) !=
      cudaSuccess)
    return -1;
  return per_sm;
}

// The fused form cooperatively (every CTA resident, or the launch fails),
// the split forms as plain launches; both on the grid the wrapper sized.
template <bool kAssoc, bool kLin, bool kColor>
cudaError_t launch(const AssocArgs& a, const LinArgs& l, int grid,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = (kAssoc && kLin) ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, icp_pass_kernel<kAssoc, kLin, kColor>, a,
                            l);
}

}  // namespace

// The most CTAs of 256 threads a launch may have: the SM count times the
// CTAs an SM holds of the most demanding form, so that any form's grid is
// resident at once (ops/icp_linearize.pass_grid sizes a level's grid from
// it). Its occupancy queries load the module, so that no first use falls
// inside a CUDA graph capture. 0 or less on an error.
extern "C" int vh_icp_linearize_grid() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  const int occ[5] = {occupancy<true, false, false>(),
                      occupancy<false, true, false>(),
                      occupancy<false, true, true>(),
                      occupancy<true, true, false>(),
                      occupancy<true, true, true>()};
  int per_sm = occ[0];
  for (int k = 1; k < 5; ++k) per_sm = occ[k] < per_sm ? occ[k] : per_sm;
  if (per_sm < 1) return -1;
  return sms * per_sm;
}

// One pass on one level: the association alone (l null), the
// linearization alone (a null; l->color selects the photometric rows) or
// both in one launch. The structs are ops/icp_linearize.py's ctypes
// mirrors, checked by size; the wrapper checks every shape and layout.
// A fused launch whose two partial-row regions overlap is refused.
extern "C" int vh_icp_pass(const void* a, int a_size, const void* l,
                           int l_size, int grid, void* stream) {
  if ((a == nullptr && l == nullptr) ||
      (a != nullptr && a_size != (int)sizeof(AssocArgs)) ||
      (l != nullptr && l_size != (int)sizeof(LinArgs)) || grid < 1)
    return (int)cudaErrorInvalidValue;
  const AssocArgs aa = a != nullptr ? *(const AssocArgs*)a : AssocArgs{};
  const LinArgs ll = l != nullptr ? *(const LinArgs*)l : LinArgs{};
  if (a != nullptr && l != nullptr) {
    // the fused form's two row sets must not overlap (see the note above)
    const double* a0 = aa.partials;
    const double* a1 = a0 + (long long)grid * kAssocSums;
    const double* l0 = ll.partials;
    const double* l1 = l0 + (long long)grid * (ll.color ? 2 : 1) * kSysSums;
    if (a0 < l1 && l0 < a1) return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (a != nullptr && l != nullptr)
    err = ll.color ? launch<true, true, true>(aa, ll, grid, s)
                   : launch<true, true, false>(aa, ll, grid, s);
  else if (a != nullptr)
    err = launch<true, false, false>(aa, ll, grid, s);
  else
    err = ll.color ? launch<false, true, true>(aa, ll, grid, s)
                   : launch<false, true, false>(aa, ll, grid, s);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
