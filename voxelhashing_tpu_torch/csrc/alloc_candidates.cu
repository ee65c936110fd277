// The allocator's candidate keys, hand-written for Hopper (sm_90a): the
// 3D-DDA through block space over each ray's truncation band, the
// neighbour-shift dedup and the per-column rank fold
// (alloc_candidates_kernel). One launch a frame in place of ~1,500 small
// torch launches (a Python loop of alloc_steps DDA steps, run twice in tile
// mode, and the dedup's and fold's shifted views).
//
// No TPU kernel: the JAX package runs this step as XLA
// (voxelhashing_tpu/integrate.py:39 _dda_band_keys, :137 _dedup_and_fold,
// :177 alloc_candidates). Its plain PyTorch version
// (ops/alloc_candidates.alloc_candidates_plain) is those functions op for
// op.
//
// Two modes over a [slots, rows, cols] key grid, a column of it a tile or a
// pixel:
// - tile mode (tile > 1 dividing the frame; online): a column is a tile of
//   tile x tile pixels. Its two band rays (the min- and the max-depth band,
//   from the tile's centre) start from the tile's min and max depth over
//   the pooling grid rotated by the phase (the frame counter, a host int or
//   a device int32 read here; pixels that wrap sit out), after the novelty
//   mask against the model depth; the second ray's keys that repeat the
//   first's at the same step or one step off are dropped; alloc_fold_tile
//   slots;
// - pixel mode (offline, or a frame no tile divides): one ray a pixel over
//   [d - t, d + t]; alloc_fold slots.
// A CTA owns kRows x kCols columns and also computes a one-column halo to
// the west and the north, whose keys the west/north dedup reads (tile
// mode: 4 x 8 columns, 45 with the halo, 150 CTAs at 320x240 with tile 4;
// pixel mode: 4 x 16, 85 with the halo). The wrapper decides the launch
// (ops/alloc_candidates.py: the instantiation, the grid, whether tile mode
// stages its footprint); vh_alloc_candidates checks that the choice fits
// this source and launches it. Its phases:
// (1) tile mode, staged (tiles up to 30 on an H100, whose CTA may opt in
//     to 227 KB of shared memory): all threads stage the CTA's footprint,
//     the pixels that any phase pools for its columns ((kRows + 1) tile +
//     tile - 1 rows by (kCols + 1) tile + tile - 1 columns), into dynamic
//     shared memory in one round trip, its loads (depth and model depth,
//     with the pose and the phase) issued together: each pixel's depth
//     where it passes the gate and the novelty mask, NaN where not or off
//     the frame;
// (2) one thread a ray: its band depth (tile mode: the min or the max over
//     its tile's pixels at the phase, from shared memory, or, for a tile
//     whose footprint is not staged, from global memory; fminf and fmaxf
//     skip the NaNs, and over the finite positive depths the gate admits
//     they give the same bits in any order, as amin and amax do), its
//     direction and its DDA (skipped for a ray that no pixel makes valid:
//     its keys are all INVALID_KEY), its S keys into shared memory laid out
//     [ray][step][column], so that consecutive columns fall in consecutive
//     banks;
// (3) tile mode: one thread a column drops the second ray's keys that
//     repeat the first's at the same step or one step off;
// (4) one thread an output column drops the keys equal to its west or
//     north neighbour's at the same step index and rank-folds the rest.
// The fold writes the j-th surviving key of a column at out[j * columns +
// column], INVALID_KEY past the last, position for position as the plain
// version (blockmap.allocate assigns pool slots by prefix rank, so the
// order is part of the map). The default 8 steps a ray are a template
// (kSteps = 8), any other count 1-16 loops to 16 with a guard (kSteps =
// 0). The bound is ~0.0002 ms (its bytes) in tile mode at 320x240, where
// few rays are valid: what holds it is latency, the footprint's round
// trip and the fold's chain of stores after three barriers.
// kernel_probes splits a CTA's cycles by phase and times each design move
// against its undoing (4 x 16 columns on 75 CTAs; a [column][ray][step]
// key layout, whose 32-int rows put consecutive columns in one bank; the
// footprint's loads one at a time; the footprint not staged; a loop of 16
// steps for 8).
//
// Bit-equal to the plain version on the card: every float expression in
// the plain version's operation order, built with -fmad=false; IEEE
// divisions (geometry.div_const's too); sqrtf; the symmetric round
// int(q + sign(q) 0.5) by the saturating float -> int32 conversion torch's
// cast compiles to (truncation toward zero), then a floor division by 8
// (an arithmetic shift); the DDA's tie order x, z, y with comparisons of
// t-values that may hold inf, as the plain version's.

#include "common.cuh"

namespace {

constexpr int kMaxSteps = 16;                // alloc_steps up to 16
constexpr int kDefaultSteps = 8;             // MapConfig.alloc_steps
constexpr int kInvalidKey = 0x7FFFFFFF;
constexpr int kStageUnroll = 8;              // footprint loads in flight

struct AllocArgs {
  const float* depth;                        // [h, w], strides in elements
  long long d_s0, d_s1;
  const float* model_depth;                  // null: no novelty mask
  long long m_s0, m_s1;
  const float* pose;                         // [4, 4] row-major, device
  const int* phase_ptr;                      // device int32 phase, or null
  int h, w;
  int tile;                                  // 1: pixel mode
  int stage;                                 // 1: the footprint staged
  int rows, cols;                            // the key grid's columns
  int steps;                                 // S, the DDA steps a ray
  int fold;                                  // output slots a column
  int compact;                               // 1: rank-fold, 0: no fold
  int px, py;                                // host phase offsets
  float fx, fy, cx, cy;
  float max_d, trunc, trunc_scale;
  float block_world, half_voxel, voxel;
  int world_blocks;
  int* out;                                  // [fold * rows * cols]
};

// A CTA's columns in each mode (kRays 2: tile mode, 1: pixel mode).
template <int kRays>
struct Geo {
  static constexpr int kRows = 4;
  static constexpr int kCols = kRays == 2 ? 8 : 16;
  static constexpr int kHaloCols = kCols + 1;
  static constexpr int kHalo = (kRows + 1) * kHaloCols;
  static constexpr int kThreads =
      kRays == 2 ? 128 : ((kRays * kHalo + 31) / 32) * 32;
  static_assert(kThreads >= kRays * kHalo, "one thread a ray");
};

// Where a column's key of a ray's step lies in shared memory: [ray][step]
// [column], so that consecutive columns fall in consecutive banks.
__host__ __device__ constexpr int key_at(int ray, int step, int column,
                                         int rays, int steps, int halo) {
  return (ray * steps + step) * halo + column;
}

// The footprint's floats (tile mode) for a tile: every pixel a phase pools.
__host__ __device__ constexpr int footprint(int rows, int cols, int tile) {
  return ((rows + 1) * tile + tile - 1) * ((cols + 1) * tile + tile - 1);
}

struct Pose {
  float r[9], t[3];
};

__device__ __forceinline__ Pose load_pose(const float* p) {
  Pose m;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) m.r[3 * i + j] = p[4 * i + j];
    m.t[i] = p[4 * i + 3];
  }
  return m;
}

// torch.clamp on the card: NaN stays NaN
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.sign of an f32 (NaN gives NaN, which every use below turns into
// the same result as 0)
__device__ __forceinline__ float sign_f(float q) {
  return q > 0.0f ? 1.0f : (q < 0.0f ? -1.0f : (q == 0.0f ? 0.0f : q));
}

// world coordinate -> block coordinate: the symmetric voxel round, then a
// floor division by 8
__device__ __forceinline__ int block_of(float p, float voxel) {
  const float q = p / voxel;
  return ((int)(q + sign_f(q) * 0.5f)) >> 3;
}

struct Axis {
  int c, step, bound;
  float t_max, t_delta;
};

__device__ __forceinline__ Axis axis_setup(int c, int e, float o, float dirc,
                                           const AllocArgs& a) {
  Axis ax;
  ax.c = c;
  ax.step = (int)sign_f(dirc);
  const float boundary =
      (float)(c + min(max(ax.step, 0), 1)) * a.block_world - a.half_voxel;
  const float safe = (dirc == 0.0f) ? 1e-12f : dirc;
  const float t_max = (boundary - o) / safe;
  const float t_delta = ((float)ax.step * a.block_world) / safe;
  const bool degen = (dirc == 0.0f) || (boundary - o == 0.0f);
  ax.t_max = degen ? INFINITY : t_max;
  ax.t_delta = degen ? INFINITY : t_delta;
  ax.bound = e + ax.step;
  return ax;
}

// The keys of the blocks that the band [d - t, d + t] along the ray
// (xn, yn, 1) crosses, step s at keys[s * stride] for s < S (INVALID_KEY
// past its end): _dda_band_keys of one column. kSteps > 0: S = kSteps.
template <int kSteps>
__device__ __forceinline__ void dda_keys(float d, bool valid, float xn,
                                         float yn, const Pose& m,
                                         const AllocArgs& a, int* keys,
                                         int stride) {
  constexpr int kLoop = kSteps > 0 ? kSteps : kMaxSteps;
  const int steps = kSteps > 0 ? kSteps : a.steps;
  valid = valid && isfinite(d) && d > 0.0f && d < a.max_d;
  d = valid ? d : 1.0f;
  const float t = a.trunc_scale * d + a.trunc;
  const float min_d = clamp_max(d - t, a.max_d);
  const float max_d = clamp_max(d + t, a.max_d);
  valid = valid && (min_d < max_d);

  float o[3], e[3];
  {
    const float cx = xn * min_d, cy = yn * min_d, cz = min_d;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      o[i] = ((m.r[3 * i] * cx + m.r[3 * i + 1] * cy) + m.r[3 * i + 2] * cz)
             + m.t[i];
  }
  {
    const float cx = xn * max_d, cy = yn * max_d, cz = max_d;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      e[i] = ((m.r[3 * i] * cx + m.r[3 * i + 1] * cy) + m.r[3 * i + 2] * cz)
             + m.t[i];
  }
  float dir[3] = {e[0] - o[0], e[1] - o[1], e[2] - o[2]};
  const float rl = clamp_min(
      sqrtf((dir[0] * dir[0] + dir[1] * dir[1]) + dir[2] * dir[2]), 1e-12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) dir[i] = dir[i] / rl;

  Axis ax = axis_setup(block_of(o[0], a.voxel), block_of(e[0], a.voxel),
                       o[0], dir[0], a);
  Axis ay = axis_setup(block_of(o[1], a.voxel), block_of(e[1], a.voxel),
                       o[1], dir[1], a);
  Axis az = axis_setup(block_of(o[2], a.voxel), block_of(e[2], a.voxel),
                       o[2], dir[2], a);

  const int half = a.world_blocks / 2, wb = a.world_blocks;
  bool alive = valid;
#pragma unroll
  for (int s = 0; s < kLoop; ++s) {
    if (kSteps == 0 && s >= steps) break;
    const int gx = ax.c + half, gy = ay.c + half, gz = az.c + half;
    const bool ok = alive && gx >= 0 && gx < wb && gy >= 0 && gy < wb &&
                    gz >= 0 && gz < wb;
    keys[s * stride] = ok ? (gz * wb + gy) * wb + gx : kInvalidKey;
    const bool takex = (ax.t_max < ay.t_max) && (ax.t_max < az.t_max);
    const bool takez = !takex && (az.t_max < ay.t_max);
    const bool takey = !takex && !takez;
    ax.c += takex ? ax.step : 0;
    ay.c += takey ? ay.step : 0;
    az.c += takez ? az.step : 0;
    const bool hit = (takex && ax.c == ax.bound) ||
                     (takey && ay.c == ay.bound) ||
                     (takez && az.c == az.bound);
    if (takex) ax.t_max = ax.t_max + ax.t_delta;
    if (takey) ay.t_max = ay.t_max + ay.t_delta;
    if (takez) az.t_max = az.t_max + az.t_delta;
    alive = alive && !hit;
  }
}

// The phase offsets (py, px) of the rotated pooling grid.
__device__ __forceinline__ void phase_offsets(const AllocArgs& a, int& py,
                                              int& px) {
  if (a.phase_ptr == nullptr) {
    py = a.py;
    px = a.px;
    return;
  }
  const int p = *a.phase_ptr, t = a.tile;
  const int q = (p % t != 0 && p < 0) ? p / t - 1 : p / t;  // floor
  py = ((p % t) + t) % t;
  px = ((q % t) + t) % t;
}

// A pixel's depth d where it counts for its tile's band (finite, in
// (0, max_d), and, with a model depth md, not agreeing with it within half
// a truncation), NaN where not.
__device__ __forceinline__ float pooled_depth(const AllocArgs& a, float d,
                                              float md) {
  bool pv = isfinite(d) && d > 0.0f && d < a.max_d;
  if (a.model_depth != nullptr) {
    const float t = a.trunc_scale * d + a.trunc;
    const bool agree = isfinite(md) && (fabsf(d - md) < 0.5f * t);
    pv = pv && !agree;
  }
  return pv ? d : NAN;
}

// pooled_depth of pixel (y, x), y and x >= 0, from global memory (NaN off
// the frame): a tile whose footprint is not staged.
__device__ __forceinline__ float pixel_depth(const AllocArgs& a, int y,
                                             int x) {
  if (y >= a.h || x >= a.w) return NAN;
  const float md = a.model_depth != nullptr
                       ? a.model_depth[y * a.m_s0 + x * a.m_s1]
                       : 0.0f;
  return pooled_depth(a, a.depth[y * a.d_s0 + x * a.d_s1], md);
}

template <int kRays, int kSteps>
__global__ void __launch_bounds__(Geo<kRays>::kThreads)
    alloc_candidates_kernel(const AllocArgs a) {
  using G = Geo<kRays>;
  constexpr int kS = kSteps > 0 ? kSteps : kMaxSteps;
  extern __shared__ float s_fp[];              // tile mode: the footprint
  __shared__ int s_keys[kRays * kS * G::kHalo];
  // the key of column c, ray r, step s
  auto key = [&](int r, int s, int c) -> int& {
    return s_keys[key_at(r, s, c, kRays, kS, G::kHalo)];
  };
  __shared__ float s_pose[12];
  const int tid = threadIdx.x;
  const int s_n = kSteps > 0 ? kSteps : a.steps;
  const int r0 = blockIdx.y * G::kRows - 1, c0 = blockIdx.x * G::kCols - 1;
  const int t = a.tile;
  const int fw = (G::kCols + 1) * t + t - 1;
  int py = 0, px = 0;

  // 1. tile mode: the phase, the pose and the footprint, in one round trip
  if (kRays == 2) {
    phase_offsets(a, py, px);
    if (tid < 12) s_pose[tid] = a.pose[4 * (tid / 4) + tid % 4];
    const int n = a.stage ? footprint(G::kRows, G::kCols, t) : 0;
    const int y0 = r0 * t, x0 = c0 * t;
    const float* mdp = a.model_depth != nullptr ? a.model_depth : a.depth;
    for (int base = 0; base < n; base += kStageUnroll * G::kThreads) {
      // every load issued (to a clamped pixel off the frame) before the
      // first test, so that the round trips overlap
      float d[kStageUnroll], md[kStageUnroll];
      bool on[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int k = base + u * G::kThreads + tid;
        const int y = y0 + k / fw, x = x0 + k % fw;
        on[u] = k < n && y >= 0 && y < a.h && x >= 0 && x < a.w;
        const int yc = min(max(y, 0), a.h - 1), xc = min(max(x, 0), a.w - 1);
        d[u] = k < n ? a.depth[yc * a.d_s0 + xc * a.d_s1] : 0.0f;
        md[u] = k < n ? mdp[yc * a.m_s0 + xc * a.m_s1] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int k = base + u * G::kThreads + tid;
        if (k < n) s_fp[k] = on[u] ? pooled_depth(a, d[u], md[u]) : NAN;
      }
    }
    __syncthreads();
  }

  // 2. one ray a thread: its S keys (INVALID_KEY off the grid)
  if (tid < kRays * G::kHalo) {
    const int c = tid % G::kHalo, ray = tid / G::kHalo;
    const int hr = c / G::kHaloCols, hc = c % G::kHaloCols;
    const int row = r0 + hr, col = c0 + hc;
    int* keys = &key(ray, 0, c);
    constexpr int stride = key_at(0, 1, 0, kRays, kS, G::kHalo) -
                           key_at(0, 0, 0, kRays, kS, G::kHalo);
    bool valid = false;
    float d = 1.0f, xn = 0.0f, yn = 0.0f;
    if (row >= 0 && col >= 0 && row < a.rows && col < a.cols) {
      if (kRays == 1) {
        d = a.depth[row * a.d_s0 + col * a.d_s1];
        xn = ((float)col - a.cx) / a.fx;
        yn = ((float)row - a.cy) / a.fy;
        valid = true;
      } else {
        // the band depth over the tile's pixels at the phase
        float v = ray == 0 ? INFINITY : -INFINITY;
        if (a.stage) {
          const float* p = s_fp + (hr * t + py) * fw + hc * t + px;
          for (int i = 0; i < t; ++i, p += fw)
            for (int j = 0; j < t; ++j)
              v = ray == 0 ? fminf(v, p[j]) : fmaxf(v, p[j]);
        } else {
          for (int i = 0; i < t; ++i)
            for (int j = 0; j < t; ++j) {
              const float pd =
                  pixel_depth(a, row * t + py + i, col * t + px + j);
              v = ray == 0 ? fminf(v, pd) : fmaxf(v, pd);
            }
        }
        valid = isfinite(v);
        d = valid ? v : 1.0f;
        const float uc = (((float)col + 0.5f) * (float)t - 0.5f) + (float)px;
        const float vc = (((float)row + 0.5f) * (float)t - 0.5f) + (float)py;
        xn = (uc - a.cx) / a.fx;
        yn = (vc - a.cy) / a.fy;
      }
    }
    if (valid && isfinite(d) && d > 0.0f && d < a.max_d) {
      Pose m;
      if (kRays == 2) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j) m.r[3 * i + j] = s_pose[4 * i + j];
          m.t[i] = s_pose[4 * i + 3];
        }
      } else {
        m = load_pose(a.pose);
      }
      dda_keys<kSteps>(d, true, xn, yn, m, a, keys, stride);
    } else {
      for (int s = 0; s < s_n; ++s) keys[s * stride] = kInvalidKey;
    }
  }
  __syncthreads();

  // 3. tile mode: drop the max-band ray's keys that repeat the min-band
  // ray's at the same step or one step off
  if (kRays == 2 && tid < G::kHalo) {
    for (int s = 0; s < s_n; ++s) {
      const int k = key(kRays - 1, s, tid);
      const int kn = key(0, s + 1 < s_n ? s + 1 : 0, tid);
      const int kp = key(0, s > 0 ? s - 1 : s_n - 1, tid);
      if ((k == key(0, s, tid) || k == kn || k == kp) && k != kInvalidKey)
        key(kRays - 1, s, tid) = kInvalidKey;
    }
  }
  if (kRays == 2) __syncthreads();

  // 4. one output column a thread: the west/north dedup against the
  // neighbours' keys at the same step index, then the rank fold
  if (tid >= G::kRows * G::kCols) return;
  const int hr = 1 + tid / G::kCols, hc = 1 + tid % G::kCols;
  const int row = r0 + hr, col = c0 + hc;
  if (row >= a.rows || col >= a.cols) return;
  const int c = hr * G::kHaloCols + hc;
  const int n = a.rows * a.cols, col_id = row * a.cols + col;
  // the column's keys after the dedup, all read before the first store
  int keys[kRays][kS];
#pragma unroll
  for (int ray = 0; ray < kRays; ++ray) {
#pragma unroll
    for (int ss = 0; ss < kS; ++ss) {
      const int k = key(ray, ss, c);
      const bool dup =
          k == key(ray, ss, c - 1) || k == key(ray, ss, c - G::kHaloCols);
      keys[ray][ss] = (kSteps == 0 && ss >= s_n) || dup ? kInvalidKey : k;
    }
  }
  int* out = a.out + col_id;
  int j = 0;
#pragma unroll
  for (int ray = 0; ray < kRays; ++ray) {
#pragma unroll
    for (int ss = 0; ss < kS; ++ss) {
      if (kSteps == 0 && ss >= s_n) break;
      const int k = keys[ray][ss];
      if (!a.compact) {
        out[(long long)(ray * s_n + ss) * n] = k;
      } else if (k != kInvalidKey) {
        if (j < a.fold) out[(long long)j * n] = k;
        ++j;
      }
    }
  }
  if (a.compact)
    for (; j < a.fold; ++j) out[(long long)j * n] = kInvalidKey;
}

// Set by the grid query: the dynamic shared memory tile mode's
// instantiations (<2, 8>, <2, 0>) may take, the card's opt-in maximum a
// CTA less their static shared memory.
bool g_ready = false;
int g_max_dyn[2] = {0, 0};

template <int kSteps>
int allow_footprint(int device, int* max_dyn) {
  auto* fn = alloc_candidates_kernel<2, kSteps>;
  int optin = 0, n = 0;
  cudaFuncAttributes attr;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, fn) != cudaSuccess)
    return -1;
  *max_dyn = optin - (int)attr.sharedSizeBytes;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *max_dyn) != cudaSuccess)
    return -1;
  // the CTAs an SM at the default tile (4)'s footprint
  const size_t smem = footprint(Geo<2>::kRows, Geo<2>::kCols, 4) *
                      sizeof(float);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fn, Geo<2>::kThreads, smem) != cudaSuccess)
    return -1;
  return n;
}

template <int kSteps>
int occupancy_pixel() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, alloc_candidates_kernel<1, kSteps>, Geo<1>::kThreads, 0) !=
      cudaSuccess)
    return -1;
  return n;
}

template <int kRays, int kSteps>
void launch(const AllocArgs& a, int gx, int gy, cudaStream_t stream) {
  using G = Geo<kRays>;
  const size_t smem = kRays == 2 && a.stage
      ? footprint(G::kRows, G::kCols, a.tile) * sizeof(float)
      : 0;
  alloc_candidates_kernel<kRays, kSteps>
      <<<dim3(gx, gy), G::kThreads, smem, stream>>>(a);
}

}  // namespace

// The CTAs an SM of each instantiation (<2, 8>, <2, 0>, <1, 8>, <1, 0>,
// as two decimal digits each, tile mode at tile 4's footprint): the
// queries load the module and allow tile mode's instantiations the most
// dynamic shared memory the card gives a CTA, so that no first use falls
// inside a CUDA graph capture. -1 on an error.
extern "C" int vh_alloc_candidates_grid() {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  const int n[4] = {allow_footprint<kDefaultSteps>(device, &g_max_dyn[0]),
                    allow_footprint<0>(device, &g_max_dyn[1]),
                    occupancy_pixel<kDefaultSteps>(), occupancy_pixel<0>()};
  int out = 0;
  for (int k = 0; k < 4; ++k) {
    if (n[k] < 0) return -1;
    out = out * 100 + (n[k] > 99 ? 99 : n[k]);
  }
  g_ready = true;
  return out;
}

// One frame, as the wrapper chose it: `kernel` the instantiation (0 <2, 8>,
// 1 <2, 0>: tile mode, tile > 1; 2 <1, 8>, 3 <1, 0>: pixel mode; <., 8>
// for 8 steps only), a gx x gy grid of CTAs that covers the key grid's
// columns with none to spare, `stage` 1 to stage tile mode's footprint (it
// must fit the CTA's shared memory). Strides in elements; model_depth and
// phase_ptr may be null (then px, py are the host phase's offsets);
// ops/alloc_candidates.py checks every shape and makes `out` [fold * rows
// * cols].
extern "C" int vh_alloc_candidates(
    const void* depth, long long d_s0, long long d_s1, int h, int w,
    const void* model_depth, long long m_s0, long long m_s1,
    const void* pose, const void* phase_ptr, int tile, int rows, int cols,
    int steps, int fold, int compact, int px, int py, float fx, float fy,
    float cx, float cy, float max_d, float trunc, float trunc_scale,
    float block_world, float half_voxel, float voxel, int world_blocks,
    int kernel, int gx, int gy, int stage, void* out, void* stream) {
  const bool tiled = kernel == 0 || kernel == 1;
  const int cta_cols = tiled ? Geo<2>::kCols : Geo<1>::kCols;
  const int cta_rows = tiled ? Geo<2>::kRows : Geo<1>::kRows;
  if (steps < 1 || steps > kMaxSteps || rows < 1 || cols < 1 || tile < 1 ||
      kernel < 0 || kernel > 3 || tiled != (tile > 1) ||
      (kernel % 2 == 0 && steps != kDefaultSteps) || (stage && !tiled) ||
      gx != (cols + cta_cols - 1) / cta_cols ||
      gy != (rows + cta_rows - 1) / cta_rows)
    return (int)cudaErrorInvalidValue;
  if (!g_ready && vh_alloc_candidates_grid() < 0)
    return (int)cudaErrorInvalidValue;
  if (stage && (long long)footprint(Geo<2>::kRows, Geo<2>::kCols, tile) *
                       (long long)sizeof(float) > g_max_dyn[kernel])
    return (int)cudaErrorInvalidValue;
  AllocArgs a;
  a.depth = (const float*)depth;
  a.d_s0 = d_s0;
  a.d_s1 = d_s1;
  a.model_depth = (const float*)model_depth;
  a.m_s0 = m_s0;
  a.m_s1 = m_s1;
  a.pose = (const float*)pose;
  a.phase_ptr = (const int*)phase_ptr;
  a.h = h;
  a.w = w;
  a.tile = tile;
  a.stage = stage;
  a.rows = rows;
  a.cols = cols;
  a.steps = steps;
  a.fold = fold;
  a.compact = compact;
  a.px = px;
  a.py = py;
  a.fx = fx;
  a.fy = fy;
  a.cx = cx;
  a.cy = cy;
  a.max_d = max_d;
  a.trunc = trunc;
  a.trunc_scale = trunc_scale;
  a.block_world = block_world;
  a.half_voxel = half_voxel;
  a.voxel = voxel;
  a.world_blocks = world_blocks;
  a.out = (int*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kernel) {
    case 0: launch<2, kDefaultSteps>(a, gx, gy, s); break;
    case 1: launch<2, 0>(a, gx, gy, s); break;
    case 2: launch<1, kDefaultSteps>(a, gx, gy, s); break;
    default: launch<1, 0>(a, gx, gy, s); break;
  }
  return (int)cudaGetLastError();
}
