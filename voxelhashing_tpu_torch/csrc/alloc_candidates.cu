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
// A CTA owns 4 x 16 columns and also computes a one-column halo to the
// west and the north, whose keys the west/north dedup reads (85 columns
// for 64 outputs): (1) one thread a column pools its tile, (2) one thread
// a ray walks its DDA into shared memory, (3) one thread a column drops the
// second ray's repeats, (4) one thread an output column drops the keys
// equal to its west or north neighbour's at the same step index and
// rank-folds the rest. The fold writes the j-th surviving key of a column
// at out[j * columns + column], INVALID_KEY past the last, position for
// position as the plain version (blockmap.allocate assigns pool slots by
// prefix rank, so the order is part of the map). A first version ran one
// thread a column that also walked its west and north neighbours' rays
// (six DDAs a tile) and took 0.0314 ms a 320x240 frame in tile mode on an
// H100, 0.0155 in pixel mode.
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
constexpr int kInvalidKey = 0x7FFFFFFF;

struct AllocArgs {
  const float* depth;                        // [h, w], strides in elements
  long long d_s0, d_s1;
  const float* model_depth;                  // null: no novelty mask
  long long m_s0, m_s1;
  const float* pose;                         // [4, 4] row-major, device
  const int* phase_ptr;                      // device int32 phase, or null
  int h, w;
  int tile;                                  // 1: pixel mode
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

// The keys [S] of the blocks that the band [d - t, d + t] along the ray
// (xn, yn, 1) crosses (INVALID_KEY past its end): _dda_band_keys of one
// column.
__device__ __forceinline__ void dda_keys(float d, bool valid, float xn,
                                         float yn, const Pose& m,
                                         const AllocArgs& a,
                                         int (&keys)[kMaxSteps]) {
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
  for (int s = 0; s < kMaxSteps; ++s) {
    if (s >= a.steps) {
      keys[s] = kInvalidKey;
      continue;
    }
    const int gx = ax.c + half, gy = ay.c + half, gz = az.c + half;
    const bool ok = alive && gx >= 0 && gx < wb && gy >= 0 && gy < wb &&
                    gz >= 0 && gz < wb;
    keys[s] = ok ? (gz * wb + gy) * wb + gx : kInvalidKey;
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
  const long long p = (long long)(*a.phase_ptr), t = a.tile;
  const long long q = (p % t != 0 && p < 0) ? p / t - 1 : p / t;  // floor
  py = (int)(((p % t) + t) % t);
  px = (int)(((q % t) + t) % t);
}

// A pixel kept for its tile's band: finite, in (0, max_d), and not
// agreeing with the model within half a truncation.
__device__ __forceinline__ bool pixel_valid(const AllocArgs& a, int y, int x,
                                            float& d) {
  d = a.depth[y * a.d_s0 + x * a.d_s1];
  bool pv = isfinite(d) && d > 0.0f && d < a.max_d;
  if (a.model_depth != nullptr) {
    const float md = a.model_depth[y * a.m_s0 + x * a.m_s1];
    const float t = a.trunc_scale * d + a.trunc;
    const bool agree = isfinite(md) && (fabsf(d - md) < 0.5f * t);
    pv = pv && !agree;
  }
  return pv;
}

// A CTA owns kBlockRows x kBlockCols columns of the key grid and computes
// the keys of those and of a one-column halo to the west and the north
// (whose keys the west/north dedup reads), one ray a thread; kRays rays a
// column (2 in tile mode, 1 in pixel mode).
constexpr int kBlockRows = 4, kBlockCols = 16;
constexpr int kHaloCols = kBlockCols + 1;
constexpr int kHalo = (kBlockRows + 1) * kHaloCols;

template <int kRays>
__global__ void __launch_bounds__(((kRays * kHalo + 31) / 32) * 32)
    alloc_candidates_kernel(const AllocArgs a) {
  __shared__ float s_d[kRays][kHalo];          // each ray's depth
  __shared__ float s_xn[kHalo], s_yn[kHalo];   // the column's direction
  __shared__ unsigned char s_state[kHalo];     // 0 off the grid, 1 invalid,
                                               // 2 valid
  __shared__ int s_keys[kHalo][kRays][kMaxSteps];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kBlockRows - 1, c0 = blockIdx.x * kBlockCols - 1;

  // 1. each halo column's rays: the tile's band depths over the rotated
  // pooling grid (tile mode) or the pixel's depth, and the direction
  if (tid < kHalo) {
    const int row = r0 + tid / kHaloCols, col = c0 + tid % kHaloCols;
    unsigned char st = 0;
    if (row >= 0 && col >= 0 && row < a.rows && col < a.cols) {
      if (kRays == 1) {
        s_d[0][tid] = a.depth[row * a.d_s0 + col * a.d_s1];
        s_xn[tid] = ((float)col - a.cx) / a.fx;
        s_yn[tid] = ((float)row - a.cy) / a.fy;
        st = 2;
      } else {
        int py = 0, px = 0;
        phase_offsets(a, py, px);
        float lo = INFINITY, hi = -INFINITY;
        for (int i = 0; i < a.tile; ++i) {
          const int y = row * a.tile + i + py;
          if (y >= a.h) break;             // wrapped: sits out
          for (int j = 0; j < a.tile; ++j) {
            const int x = col * a.tile + j + px;
            if (x >= a.w) break;
            float d;
            if (pixel_valid(a, y, x, d)) {
              lo = fminf(lo, d);
              hi = fmaxf(hi, d);
            }
          }
        }
        const bool any_v = isfinite(lo);
        s_d[0][tid] = any_v ? lo : 1.0f;
        s_d[kRays - 1][tid] = any_v ? hi : 1.0f;
        const float uc =
            (((float)col + 0.5f) * (float)a.tile - 0.5f) + (float)px;
        const float vc =
            (((float)row + 0.5f) * (float)a.tile - 0.5f) + (float)py;
        s_xn[tid] = (uc - a.cx) / a.fx;
        s_yn[tid] = (vc - a.cy) / a.fy;
        st = any_v ? 2 : 1;
      }
    }
    s_state[tid] = st;
  }
  __syncthreads();

  // 2. one ray a thread: its S keys (INVALID_KEY off the grid)
  if (tid < kRays * kHalo) {
    const int c = tid % kHalo, ray = tid / kHalo;
    int keys[kMaxSteps];
    if (s_state[c] == 0) {
#pragma unroll
      for (int s = 0; s < kMaxSteps; ++s) keys[s] = kInvalidKey;
    } else {
      dda_keys(s_d[ray][c], s_state[c] == 2, s_xn[c], s_yn[c],
               load_pose(a.pose), a, keys);
    }
#pragma unroll
    for (int s = 0; s < kMaxSteps; ++s) s_keys[c][ray][s] = keys[s];
  }
  __syncthreads();

  const int s_n = a.steps;
  // 3. tile mode: drop the max-band ray's keys that repeat the min-band
  // ray's at the same step or one step off
  if (kRays == 2 && tid < kHalo) {
    const int* ka = s_keys[tid][0];
    int* kb = s_keys[tid][kRays - 1];
    for (int s = 0; s < s_n; ++s) {
      const int k = kb[s];
      const int kn = ka[s + 1 < s_n ? s + 1 : 0];
      const int kp = ka[s > 0 ? s - 1 : s_n - 1];
      if ((k == ka[s] || k == kn || k == kp) && k != kInvalidKey)
        kb[s] = kInvalidKey;
    }
  }
  __syncthreads();

  // 4. one output column a thread: the west/north dedup against the
  // neighbours' keys at the same step index, then the rank fold
  if (tid >= kBlockRows * kBlockCols) return;
  const int hr = 1 + tid / kBlockCols, hc = 1 + tid % kBlockCols;
  const int row = r0 + hr, col = c0 + hc;
  if (row >= a.rows || col >= a.cols) return;
  const int c = hr * kHaloCols + hc;
  const int n = a.rows * a.cols, col_id = row * a.cols + col;
  const int total = kRays * s_n;
  int j = 0;
  for (int s = 0; s < total; ++s) {
    const int ray = s / s_n, ss = s % s_n;
    int k = s_keys[c][ray][ss];
    if (k != kInvalidKey && (k == s_keys[c - 1][ray][ss] ||
                             k == s_keys[c - kHaloCols][ray][ss]))
      k = kInvalidKey;
    if (!a.compact) {
      a.out[(long long)s * n + col_id] = k;
    } else if (k != kInvalidKey) {
      if (j < a.fold) a.out[(long long)j * n + col_id] = k;
      ++j;
    }
  }
  if (a.compact)
    for (; j < a.fold; ++j) a.out[(long long)j * n + col_id] = kInvalidKey;
}

template <int kRays>
constexpr int threads_of() {
  return ((kRays * kHalo + 31) / 32) * 32;
}

}  // namespace

// The CTAs an SM of the kernel: the occupancy query loads the module, so
// that no first use falls inside a CUDA graph capture. -1 on an error.
extern "C" int vh_alloc_candidates_grid() {
  int tile = 0, pixel = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &tile, alloc_candidates_kernel<2>, threads_of<2>(), 0) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &pixel, alloc_candidates_kernel<1>, threads_of<1>(), 0) !=
          cudaSuccess)
    return -1;
  return tile * 100 + pixel;
}

// One frame. Strides in elements; model_depth and phase_ptr may be null
// (then px, py are the host phase's offsets); ops/alloc_candidates.py
// checks every shape and makes `out` [fold * rows * cols].
extern "C" int vh_alloc_candidates(
    const void* depth, long long d_s0, long long d_s1, int h, int w,
    const void* model_depth, long long m_s0, long long m_s1,
    const void* pose, const void* phase_ptr, int tile, int rows, int cols,
    int steps, int fold, int compact, int px, int py, float fx, float fy,
    float cx, float cy, float max_d, float trunc, float trunc_scale,
    float block_world, float half_voxel, float voxel, int world_blocks,
    void* out, void* stream) {
  if (steps < 1 || steps > kMaxSteps || rows < 1 || cols < 1 || tile < 1)
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
  const dim3 grid((cols + kBlockCols - 1) / kBlockCols,
                  (rows + kBlockRows - 1) / kBlockRows);
  if (tile > 1)
    alloc_candidates_kernel<2>
        <<<grid, threads_of<2>(), 0, (cudaStream_t)stream>>>(a);
  else
    alloc_candidates_kernel<1>
        <<<grid, threads_of<1>(), 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
