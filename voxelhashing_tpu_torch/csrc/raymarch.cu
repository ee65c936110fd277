// The march renderer, hand-written for Hopper (sm_90a): the per-tile ray
// bounds (ray_bounds_kernel, one launch a render) and the march itself
// (raymarch_kernel<kGradients, kLanes>, one launch a render), in place of the
// ~150 small torch launches of the bounds and the [48, P] sample pass of
// the plain march (~29.5M hash lookups a 320x240 frame at 48 samples).
//
// No TPU kernel: the JAX package runs the march as XLA
// (voxelhashing_tpu/raycast.py:148 ray_interval_splat, :455 render_march,
// :509 march_core, :83 trilinear_sample_soa, :119 sdf_gradient;
// voxelhashing_tpu/blockmap.py:156 lookup, :520 gather_voxels_soa). Its
// plain PyTorch versions (ops/raymarch.ray_bounds_plain, march_plain) are
// those functions op for op; the TPU batched every sample of every ray into
// one pass because a sequential per-ray loop is a dispatch-latency
// disaster there. On the card a per-ray loop is the natural form.
//
// ray_bounds_kernel: one thread an active row (its mask and index loaded
// together, then its key) projects its block's 8 corners (the view's
// rotation as cuBLAS's f32 product of three terms, two fmas on the first
// product, then the translation), reduces the z range and the screen box,
// and scatters the z min and max into the (ty, tx) tile grid over a span
// of at most 4 x 4 tiles (or, when the block spans more or crosses the
// near plane, into the global bounds that widen every tile). A min or max
// is exact, so atomics on order-preserving integer images of the floats
// (negative floats included: a block behind the camera has a negative z
// max) give the plain scatter_reduce_ bit for bit; a max is kept as the
// min of the image's complement, so one value, 0x7F800000, is every
// accumulator's identity. Each CTA reduces into shared memory first (a
// frame has ~300 tiles and ~26K active rows), one atomic a row and tile,
// then flushes only the box of tiles its rows touched (reduced over each
// warp and kept in shared memory) into the global accumulators. Those
// persist per device and tile
// count (ops/raymarch.reserve) and hold the identity between launches, so
// a render is one launch with no fill: the CTA that arrives last turns the
// images into floats, widens every tile by the global bounds where a block
// overflowed, and restores every accumulator and the counter. Bound:
// latency, 0.0055 ms bare at phase 6's frame-11 render on an H100 at 700 W
// (1.8% of its operations bound): ~6K cycles a CTA (the load chain, the 16
// IEEE divisions of the projection, the atomics, the flush), then the last
// CTA's ~4K-cycle tail. Lanes reduced before the shared atomics (by
// __match_any_sync, or by shuffles over runs of equal tiles) and two rows
// a thread ran slower (python -m voxelhashing_tpu_torch.kernel_probes
// --bounds-gc-only; PERF.md).
//
// raymarch_kernel<kGradients, kLanes>: kLanes = kMarchLanes = 4 lanes
// walk one ray (a CTA of 256 threads a tile 8 rays wide; 8 lanes measured
// slower on the main path, see PERF.md). A ray forms its interval from its tile's bounds (less and
// plus the truncation, clamped to the camera's range) as render_march
// does, and its step as march_core does, then takes its samples in
// windows of kLanes, lane l sample base + l: the first crossing is the
// lowest lane whose pair (its own sample and lane l - 1's, or for lane 0
// the last window's last) passes the crossing test (the plain argmax over
// int8 also picks the first), and the ray stops at the window that
// crosses or that holds a sample past the band (ts only grows, and a
// sample past it is never valid). Samples past the crossing inside that
// window are taken and change no output. Then the three secant steps,
// each sample's 8 corners shared by the ray's lanes, and the hit's
// samples across the lanes at once: the hit with color and, under
// kGradients, the six central-difference samples of sdf_gradient (the
// first kLanes at once, the rest for a kept hit; unnormalized: the
// epilogue that normalizes them, and transforms the points, is the plain
// version's, raycast.march_epilogue, shared by both). Rays with no kept
// hit write NaN points and 0 colors, as the plain version after its masks.
// Every lane of a warp takes part in every step (a ray that is done
// idles), so each warp-wide shuffle and __syncwarp is met by all 32 lanes.
//
// Each trilinear sample follows trilinear_sample_soa's operation order: an
// IEEE division by the voxel size, the floor and the saturating int cast
// torch's CUDA cast compiles to, the fractions, the 8 corner weights
// multiplied left to right and summed from 0 in _CORNER_LIST order, the
// color unpacked, weighted, summed and divided by 255; valid where all 8
// weights are > 0. A sample's 8 corners lie in at most 2 blocks an axis
// (block b >> 3 against (b + 1) >> 3); its first block is looked up by its
// own lane, the others through the warp's list in shared memory, one lane
// a block (lookup's probe: at most max_probes rounds, a stop at
// INVALID_KEY, past tombstones; a key out of the world's range is
// INVALID_KEY; a round's key and value loaded together), then the 8
// corners' voxels are loaded together. A lookup is a pure function of
// the table, so the order of the lookups changes no result. bf16 sdf and
// weight widen to f32 exactly, as torch's .to(f32).
//
// Bound: latency under load, not bytes or operations: 0.080 ms bare at
// phase 6's frame-11 render on an H100 at 700 W, 6.9% of its operations
// bound. A window is a chain of dependent steps (the block lookups, then
// the voxels, then the crossing test across the lanes) that takes ~5.7K
// cycles a warp there, with 32 warps an SM in flight; the windows are
// ~77% of the time. Halving the voxel reads moved it 2%, a cap of 4 CTAs
// an SM not at all, 8 lanes a ray, 6 CTAs an SM and a 512-thread CTA made
// it slower (python -m voxelhashing_tpu_torch.kernel_probes; PERF.md).
//
// Built with -fmad=false (ops/_build.py): every float expression rounds as
// the plain version's separate torch ops; the thresholds arrive as the f32
// values torch compares with.

#include "common.cuh"
#include "hash.cuh"

namespace {

using vh::kInvalidKey;

constexpr int kBoundsThreads = 256;
constexpr int kBoundsRows = 1;         // active rows a bounds thread
constexpr int kTail = 4;               // tiles a thread of the last CTA loads
constexpr int kMaxSharedTiles = 6144;  // two int arrays in 48 KB
constexpr int kSpan = 4;               // raycast._SPAN
constexpr int kIdentity = 0x7F800000;  // image(+inf) == ~image(-inf)
constexpr int kNoTile = 0x7FFFFFFF;    // an empty tile box's bound
constexpr int kMarchThreads = 256;     // the march's CTA
constexpr int kMarchLanes = 4;         // lanes a ray (ops/raymarch.py)
constexpr int kMarchTileX = 8;         // its rays: 8 wide, 256 / kLanes / 8 tall
constexpr int kWarpBlocks = 32 * 8;    // a warp's block lookups a sample
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving int image of a float (an involution).
__device__ __forceinline__ int image(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float from_image(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7FFFFFFF);
}

// torch's amin / amax / minimum / maximum: NaN wins.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}
// torch.clamp(x, min=lo) / (x, max=hi): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}

// Python's floor division and remainder of int32 by a positive int.
__device__ __forceinline__ int floor_div(int x, int d) {
  const int q = x / d;
  return (x % d != 0 && x < 0) ? q - 1 : q;
}
__device__ __forceinline__ int py_mod(int x, int d) {
  const int r = x % d;
  return r < 0 ? r + d : r;
}

struct BoundsArgs {
  const int* block_key;     // [N]
  const int* active_idx;    // [M]
  const bool* active_mask;  // [M]
  int m;
  const float* view;        // [4, 4] row-major, device
  int width, height, tile, tiles_y, tiles_x, world_blocks;
  float fx, fy, cx, cy, depth_min, voxel_size, block_size, near_z;
  int* acc;                 // [2n + 4] int32, kIdentity between launches
  float* t_min;             // [n]
  float* t_max;             // [n]
};

// One active row's bounds: its z range as accumulator images and its tile
// box, and whether it scatters into the box or widens every tile.
struct RowBounds {
  int lo, hi;               // image(z_min), ~image(z_max)
  int t0x, t1x, t0y, t1y;
  bool scatter, overflow;
  float z_min_clamped;      // clamp(z_min, depth_min), for the widening
};

__device__ __forceinline__ RowBounds row_bounds(const BoundsArgs& a,
                                                int key) {
  const int wb = a.world_blocks, half = wb / 2;
  // geometry.unpack_block_key, block_to_world
  const int bk[3] = {py_mod(key, wb) - half,
                     py_mod(floor_div(key, wb), wb) - half,
                     floor_div(key, wb * wb) - half};
  float c0[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) c0[k] = (float)(bk[k] * 8) * a.voxel_size;
  float r[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) r[k] = a.view[k];
  float z_min = 0.f, z_max = 0.f, u_lo = 0.f, u_hi = 0.f, v_lo = 0.f,
        v_hi = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float x = c0[0] + ((c & 1) ? a.block_size : 0.0f);
    const float y = c0[1] + (((c >> 1) & 1) ? a.block_size : 0.0f);
    const float z = c0[2] + (((c >> 2) & 1) ? a.block_size : 0.0f);
    // transform_points: cuBLAS's dot of three, then + t
    const float pz = fmaf(z, r[10], fmaf(y, r[9], x * r[8])) + r[11];
    const float px = fmaf(z, r[2], fmaf(y, r[1], x * r[0])) + r[3];
    const float py = fmaf(z, r[6], fmaf(y, r[5], x * r[4])) + r[7];
    // camera_to_screen
    const float u = px * a.fx / pz + a.cx;
    const float v = py * a.fy / pz + a.cy;
    if (c == 0) {
      z_min = z_max = pz;
      u_lo = u_hi = u;
      v_lo = v_hi = v;
    } else {
      z_min = min_nan(z_min, pz);
      z_max = max_nan(z_max, pz);
      u_lo = min_nan(u_lo, u);
      u_hi = max_nan(u_hi, u);
      v_lo = min_nan(v_lo, v);
      v_hi = max_nan(v_hi, v);
    }
  }
  RowBounds o;
  const bool near_ok = z_min > a.near_z;
  const int u_min = (int)floorf(u_lo), u_max = (int)floorf(u_hi);
  const int v_min = (int)floorf(v_lo), v_max = (int)floorf(v_hi);
  o.t0x = min(max(floor_div(u_min, a.tile), 0), a.tiles_x - 1);
  o.t1x = min(max(floor_div(u_max, a.tile), 0), a.tiles_x - 1);
  o.t0y = min(max(floor_div(v_min, a.tile), 0), a.tiles_y - 1);
  o.t1y = min(max(floor_div(v_max, a.tile), 0), a.tiles_y - 1);
  const bool on_screen = u_max >= 0 && u_min < a.width && v_max >= 0 &&
                         v_min < a.height;
  const bool fits = (o.t1x - o.t0x < kSpan) && (o.t1y - o.t0y < kSpan);
  o.scatter = on_screen && near_ok && fits;
  o.overflow = on_screen && !(near_ok && fits);
  o.lo = image(z_min);
  o.hi = ~image(z_max);
  o.z_min_clamped = clamp_min(z_min, a.depth_min);
  return o;
}

__global__ void __launch_bounds__(kBoundsThreads)
    ray_bounds_kernel(BoundsArgs a) {
  extern __shared__ int s_acc[];       // [2n] when n <= kMaxSharedTiles
  __shared__ int s_box[4];             // min y, min x, -max y, -max x
  __shared__ bool s_last;
  const int n = a.tiles_y * a.tiles_x;
  const bool shared = n <= kMaxSharedTiles;
  const int lane = threadIdx.x & 31;
  int* tmin = shared ? s_acc : a.acc;
  int* tmax = shared ? s_acc + n : a.acc + n;
  if (shared)
    for (int j = threadIdx.x; j < 2 * n; j += blockDim.x) s_acc[j] = kIdentity;
  if (threadIdx.x < 4) s_box[threadIdx.x] = kNoTile;
  __syncthreads();
#pragma unroll 1
  for (int r = 0; r < kBoundsRows; ++r) {
    const int i = (blockIdx.x * kBoundsRows + r) * blockDim.x + threadIdx.x;
    // the mask and the index loaded together, then the key
    bool on = false;
    int p = 0;
    if (i < a.m) {
      on = a.active_mask[i];
      p = a.active_idx[i];
    }
    RowBounds o = {};
    if (on) o = row_bounds(a, a.block_key[p]);
    // one shared atomic a row and tile (lanes reduced first by
    // __match_any_sync, or by runs of equal tiles through shuffles, ran
    // slower: PERF.md)
    if (o.scatter)
      for (int iy = o.t0y; iy <= o.t1y; ++iy)
        for (int ix = o.t0x; ix <= o.t1x; ++ix) {
          atomicMin(tmin + iy * a.tiles_x + ix, o.lo);
          atomicMin(tmax + iy * a.tiles_x + ix, o.hi);
        }
    if (__any_sync(kFull, o.scatter)) {
      const int y0 = __reduce_min_sync(kFull, o.scatter ? o.t0y : kNoTile);
      const int x0 = __reduce_min_sync(kFull, o.scatter ? o.t0x : kNoTile);
      const int y1 = __reduce_min_sync(kFull, o.scatter ? -o.t1y : kNoTile);
      const int x1 = __reduce_min_sync(kFull, o.scatter ? -o.t1x : kNoTile);
      if (lane == 0) {
        atomicMin(s_box, y0);
        atomicMin(s_box + 1, x0);
        atomicMin(s_box + 2, y1);
        atomicMin(s_box + 3, x1);
      }
    }
    if (__any_sync(kFull, o.overflow)) {
      const int g_lo = __reduce_min_sync(
          kFull, o.overflow ? image(o.z_min_clamped) : kIdentity);
      const int g_hi = __reduce_min_sync(kFull, o.overflow ? o.hi : kIdentity);
      if (lane == 0) {
        atomicMin(a.acc + 2 * n, g_lo);
        atomicMin(a.acc + 2 * n + 1, g_hi);
        atomicMin(a.acc + 2 * n + 2, 0);
      }
    }
  }
  if (shared) {
    // flush the tiles this CTA's rows touched
    __syncthreads();
    const int y0 = s_box[0], x0 = s_box[1];
    if (y0 != kNoTile) {
      const int bw = -s_box[3] - x0 + 1;
      const int cells = (-s_box[2] - y0 + 1) * bw;
      for (int j = threadIdx.x; j < cells; j += blockDim.x) {
        const int t = (y0 + j / bw) * a.tiles_x + x0 + j % bw;
        if (s_acc[t] != kIdentity) atomicMin(a.acc + t, s_acc[t]);
        if (s_acc[n + t] != kIdentity) atomicMin(a.acc + n + t, s_acc[n + t]);
      }
    }
  }
  // the CTA that arrives last finishes the grid and restores the
  // accumulators and the counter for the next launch
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(a.acc + 2 * n + 3, 1) ==
             kIdentity + (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int g_ov = __ldcg(a.acc + 2 * n + 2);
  const int g_lo = __ldcg(a.acc + 2 * n), g_hi = __ldcg(a.acc + 2 * n + 1);
  // kTail tiles a thread loaded before any is written: one round trip
  for (int j0 = 0; j0 < n; j0 += kTail * kBoundsThreads) {
    int lo[kTail], hi[kTail];
#pragma unroll
    for (int u = 0; u < kTail; ++u) {
      const int j = j0 + u * kBoundsThreads + threadIdx.x;
      lo[u] = j < n ? __ldcg(a.acc + j) : kIdentity;
      hi[u] = j < n ? __ldcg(a.acc + n + j) : kIdentity;
    }
#pragma unroll
    for (int u = 0; u < kTail; ++u) {
      const int j = j0 + u * kBoundsThreads + threadIdx.x;
      if (j >= n) continue;
      a.acc[j] = kIdentity;
      a.acc[n + j] = kIdentity;
      float t0 = from_image(lo[u]), t1 = from_image(~hi[u]);
      if (g_ov != kIdentity) {
        t0 = min_nan(t0, from_image(g_lo));
        t1 = max_nan(t1, from_image(~g_hi));
      }
      a.t_min[j] = t0;
      a.t_max[j] = t1;
    }
  }
  __syncthreads();
  if (threadIdx.x < 4) a.acc[2 * n + threadIdx.x] = kIdentity;
}

struct MarchArgs {
  const int* table_key;     // [H]
  const int* table_val;     // [H]
  const uint16_t* sdf;      // [N * 512] bf16 bits
  const uint16_t* weight;   // [N * 512] bf16 bits
  const int* color;         // [N * 512] packed 0x00RRGGBB
  uint32_t table_mask;
  int max_probes, world_blocks;
  float voxel_size;
  const float* pose;        // [4, 4] row-major camera-to-world, device
  const float* tile_min;    // [tiles_y * tiles_x] or null: camera range
  const float* tile_max;
  int width, height, tile, tiles_x, num_samples;
  float fx, fy, cx, cy, depth_min, depth_max, truncation, steps, ray_inc,
      thres_sample_dist, thres_dist, tiny;
  float* t_hit;             // [P]
  bool* found;              // [P]
  float* p_hit;             // [P, 3]
  float* color_out;         // [P, 3]
  float* grad;              // [P, 3] (kGradients)
  bool* grad_ok;            // [P]
};

// vh::slot_of(vh::hashes_of(key), r, mask), the second hash only past
// round 0 (where most lookups end).
__device__ __forceinline__ int probe_slot(int key, int r, uint32_t mask) {
  uint32_t h = vh::mix32((uint32_t)key);
  if (r > 0) h += (uint32_t)r * (vh::mix32((uint32_t)key ^ vh::kGolden) | 1u);
  return (int)(h & mask);
}

// The pool row of one block (-1 where the table does not hold the key, or
// the key is INVALID_KEY): lookup's probe, from round r0 on.
__device__ __forceinline__ int resolve_one(const MarchArgs& a, int key,
                                           int r0 = 0) {
  if (key == kInvalidKey) return -1;
  for (int r = r0; r < a.max_probes; ++r) {
    const int slot = probe_slot(key, r, a.table_mask);
    const int tk = __ldg(a.table_key + slot);
    const int tv = __ldg(a.table_val + slot);
    if (tk == key) return tv;
    if (tk == kInvalidKey) return -1;
  }
  return -1;
}

// The key of the block at (offset) block coordinates (gx, gy, gz), or
// INVALID_KEY out of the world's range.
__device__ __forceinline__ int block_key(int gx, int gy, int gz, int wb) {
  const bool in_range = gx >= 0 && gx < wb && gy >= 0 && gy < wb &&
                        gz >= 0 && gz < wb;
  return in_range ? (gz * wb + gy) * wb + gx : kInvalidKey;
}

// The exclusive prefix of v over the warp's lanes; `total` gets the sum.
__device__ __forceinline__ int warp_prefix(int v, int lane, int& total) {
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += u;
  }
  total = __shfl_sync(kFull, inc, 31);
  return inc - v;
}

// trilinear_sample_soa at one point a lane: sdf, valid and (with_color)
// the color in [0, 1]; every lane of the warp calls it (`active` false:
// no sample, valid false). A point's 8 corners lie in at most 2 blocks an
// axis (block b >> 3 against (b + 1) >> 3). The warp lists the blocks its
// points need in s_blk (kWarpBlocks ints), one lane looks each up
// (lookup's probe), then every lane reads its 8 corners' voxels, all the
// loads issued together, and sums them in _CORNER_LIST order. A lookup is
// a pure function of the table, so looking a block up once for all its
// corners changes no result.
__device__ __forceinline__ float trilinear_warp(const MarchArgs& a,
                                                int* s_blk, bool active,
                                                float px, float py, float pz,
                                                bool with_color, bool& valid,
                                                float (&col)[3]) {
  const int lane = threadIdx.x & 31;
  const float qx = px / a.voxel_size, qy = py / a.voxel_size,
              qz = pz / a.voxel_size;
  const int bx = (int)floorf(qx), by = (int)floorf(qy), bz = (int)floorf(qz);
  const float fx = qx - (float)bx, fy = qy - (float)by, fz = qz - (float)bz;
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  const int wb = a.world_blocks, half = wb / 2;
  // int32 corner coordinates wrap as torch's do
  const int vx1 = (int)((unsigned)bx + 1u), vy1 = (int)((unsigned)by + 1u),
            vz1 = (int)((unsigned)bz + 1u);
  const int kx0 = (bx >> 3) + half, kx1 = (vx1 >> 3) + half;
  const int ky0 = (by >> 3) + half, ky1 = (vy1 >> 3) + half;
  const int kz0 = (bz >> 3) + half, kz1 = (vz1 >> 3) + half;
  // corner c's block is d = c & split (x bit 0 of d, y bit 1, z bit 2); a
  // block is wanted where it lies in the world's range
  const uint32_t split = (kx1 != kx0 ? 1u : 0u) | (ky1 != ky0 ? 2u : 0u) |
                         (kz1 != kz0 ? 4u : 0u);
  const uint32_t mx = (kx0 >= 0 && kx0 < wb ? 0x55u : 0u) |
                      ((split & 1u) && kx1 >= 0 && kx1 < wb ? 0xAAu : 0u);
  const uint32_t my = (ky0 >= 0 && ky0 < wb ? 0x33u : 0u) |
                      ((split & 2u) && ky1 >= 0 && ky1 < wb ? 0xCCu : 0u);
  const uint32_t mz = (kz0 >= 0 && kz0 < wb ? 0x0Fu : 0u) |
                      ((split & 4u) && kz1 >= 0 && kz1 < wb ? 0xF0u : 0u);
  const uint32_t want = active ? (mx & my & mz) : 0u;
  // block 0 (every corner's where no axis splits): this lane's own lookup,
  // its first probe issued before the warp's list is made
  const int key0 = (want & 1u) ? block_key(kx0, ky0, kz0, wb) : kInvalidKey;
  int tk0 = kInvalidKey, tv0 = 0;
  if (key0 != kInvalidKey) {
    const int slot = probe_slot(key0, 0, a.table_mask);
    tk0 = __ldg(a.table_key + slot);
    tv0 = __ldg(a.table_val + slot);
  }
  // the other blocks: the warp's list, this lane's at base.., in the order
  // of d, each looked up by one lane
  const uint32_t extra = want & ~1u;
  int total;
  const int base = warp_prefix(__popc(extra), lane, total);
  {
    uint32_t m = extra;
    int i = base;
    while (m != 0u) {
      const int d = __ffs(m) - 1;
      m &= m - 1u;
      s_blk[i++] = block_key((d & 1) ? kx1 : kx0, (d & 2) ? ky1 : ky0,
                             (d & 4) ? kz1 : kz0, wb);
    }
  }
  __syncwarp();
  for (int t = lane; t < total; t += 32) s_blk[t] = resolve_one(a, s_blk[t]);
  int row0 = -1;
  if (key0 != kInvalidKey && tk0 != kInvalidKey)
    row0 = tk0 == key0 ? tv0 : resolve_one(a, key0, 1);
  __syncwarp();
  const int lx[2] = {bx & 7, vx1 & 7}, ly[2] = {by & 7, vy1 & 7},
            lz[2] = {bz & 7, vz1 & 7};
  uint32_t sd_bits[8], w_bits[8];
  int packed[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
    const uint32_t d = (uint32_t)c & split;
    const int r = d == 0u ? row0
                  : ((extra >> d) & 1u)
                      ? s_blk[base + __popc(extra & ((1u << d) - 1u))]
                      : -1;
    sd_bits[c] = w_bits[c] = 0u;
    packed[c] = 0;
    if (r >= 0) {
      const long long lin = (long long)r * 512 +
                            ((lz[oz] * 8 + ly[oy]) * 8 + lx[ox]);
      sd_bits[c] = __ldg(a.sdf + lin);
      w_bits[c] = __ldg(a.weight + lin);
      if (with_color) packed[c] = __ldg(a.color + lin);
    }
  }
  __syncwarp();           // s_blk is free for the warp's next sample
  float s = 0.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  valid = active;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
    const float sd = vh::bf16_bits_to_float(sd_bits[c]);
    const float w = vh::bf16_bits_to_float(w_bits[c]);
    valid = valid && w > 0.0f;
    const float tw = ((ox ? fx : gx) * (oy ? fy : gy)) * (oz ? fz : gz);
    s = s + tw * sd;
    if (with_color) {
      cr = cr + tw * (float)((packed[c] >> 16) & 0xFF);
      cg = cg + tw * (float)((packed[c] >> 8) & 0xFF);
      cb = cb + tw * (float)(packed[c] & 0xFF);
    }
  }
  if (with_color) {
    col[0] = cr / 255.0f;
    col[1] = cg / 255.0f;
    col[2] = cb / 255.0f;
  }
  return s;
}

// trilinear_sample_soa's sdf and validity at one point a ray, the
// point's 8 corners shared among the ray's kLanes lanes (corner c on lane
// c % kLanes): each lane looks up and reads its corners' voxels, then
// every lane sums the 8 weighted terms in _CORNER_LIST order. Every lane
// of the warp calls it, a ray's lanes with the same point (`active` false:
// no sample, valid false).
template <int kLanes>
__device__ __forceinline__ float trilinear_lanes(const MarchArgs& a,
                                                 bool active, float px,
                                                 float py, float pz,
                                                 int lane, bool& valid) {
  constexpr int kPer = 8 / kLanes;      // corners a lane
  const float qx = px / a.voxel_size, qy = py / a.voxel_size,
              qz = pz / a.voxel_size;
  const int bx = (int)floorf(qx), by = (int)floorf(qy), bz = (int)floorf(qz);
  const float fx = qx - (float)bx, fy = qy - (float)by, fz = qz - (float)bz;
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  const int wb = a.world_blocks, half = wb / 2;
  // this lane's corners: their keys, their first probes issued together
  int key[kPer], tk[kPer], tv[kPer], lin[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = k * kLanes + lane;
    const int vx = (int)((unsigned)bx + (unsigned)(c & 1));
    const int vy = (int)((unsigned)by + (unsigned)((c >> 1) & 1));
    const int vz = (int)((unsigned)bz + (unsigned)((c >> 2) & 1));
    key[k] = active ? block_key((vx >> 3) + half, (vy >> 3) + half,
                                (vz >> 3) + half, wb)
                    : kInvalidKey;
    lin[k] = ((vz & 7) * 8 + (vy & 7)) * 8 + (vx & 7);
    tk[k] = kInvalidKey;
    tv[k] = 0;
    if (key[k] != kInvalidKey) {
      const int slot = probe_slot(key[k], 0, a.table_mask);
      tk[k] = __ldg(a.table_key + slot);
      tv[k] = __ldg(a.table_val + slot);
    }
  }
  float term[kPer];
  bool ok = true;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = k * kLanes + lane;
    const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
    int r = -1;
    if (key[k] != kInvalidKey && tk[k] != kInvalidKey)
      r = tk[k] == key[k] ? tv[k] : resolve_one(a, key[k], 1);
    float sd = 0.0f, w = 0.0f;
    if (r >= 0) {
      sd = vh::bf16_bits_to_float(__ldg(a.sdf + (long long)r * 512 + lin[k]));
      w = vh::bf16_bits_to_float(
          __ldg(a.weight + (long long)r * 512 + lin[k]));
    }
    ok = ok && w > 0.0f;
    const float tw = ((ox ? fx : gx) * (oy ? fy : gy)) * (oz ? fz : gz);
    term[k] = tw * sd;
  }
  const int first = (threadIdx.x & 31) & ~(kLanes - 1);
  const unsigned bad = (__ballot_sync(kFull, !ok) >> first) &
                       ((1u << kLanes) - 1u);
  valid = active && bad == 0u;
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    s = s + __shfl_sync(kFull, term[c / kLanes], c % kLanes, kLanes);
  return s;
}

// kLanes lanes walk one ray (a CTA kMarchThreads / kLanes rays, a tile
// kMarchTileX wide); see the header.
template <bool kGradients, int kLanes>
__global__ void __launch_bounds__(kMarchThreads)
    raymarch_kernel(MarchArgs a) {
  constexpr int kTileY = kMarchThreads / kLanes / kMarchTileX;
  constexpr unsigned kRayMask = (1u << kLanes) - 1u;
  __shared__ int s_blocks[kMarchThreads / 32][kWarpBlocks];
  int* s_blk = s_blocks[threadIdx.x >> 5];
  const int lane = threadIdx.x % kLanes;
  const int ray = threadIdx.x / kLanes;
  const int first = (threadIdx.x & 31) & ~(kLanes - 1);
  // a ray off the image (a partial tile) stays with its warp, idle
  const bool on = blockIdx.x * kMarchTileX + ray % kMarchTileX < a.width &&
                  blockIdx.y * kTileY + ray / kMarchTileX < a.height;
  const int col_px = on ? blockIdx.x * kMarchTileX + ray % kMarchTileX : 0;
  const int row_px = on ? blockIdx.y * kTileY + ray / kMarchTileX : 0;
  const int p = row_px * a.width + col_px;
  float pose[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) pose[k] = a.pose[k];

  // the ray's interval (render_march) and step (march_core)
  float t_min = a.depth_min, t_max = a.depth_max;
  if (a.tile_min != nullptr) {
    const int t = (row_px / a.tile) * a.tiles_x + col_px / a.tile;
    t_min = clamp_min(a.tile_min[t] - a.truncation, a.depth_min);
    t_max = clamp_max(a.tile_max[t] + a.truncation, a.depth_max);
  }
  const float dt = clamp_min(clamp_min(t_max - t_min, 0.0f) / a.steps,
                             a.ray_inc);
  const float limit = t_max + dt;
  // raycast._ray_directions
  const float xn = ((float)col_px - a.cx) / a.fx;
  const float yn = ((float)row_px - a.cy) / a.fy;
  const float dx = pose[0] * xn + pose[1] * yn + pose[2];
  const float dy = pose[4] * xn + pose[5] * yn + pose[6];
  const float dz = pose[8] * xn + pose[9] * yn + pose[10];
  const float ox = pose[3], oy = pose[7], oz = pose[11];

  // windows of kLanes consecutive samples, lane l taking sample base + l,
  // until the ray's window that crosses or leaves the band (every lane of
  // the warp goes on while one of its rays does); the pair (k - 1, k) is
  // lane l - 1's and lane l's, or for lane 0 the last window's last
  float unused[3];
  bool done = !on, crossed = false;
  float b_t0 = 0.0f, b_s0 = 0.0f, b_s1 = 0.0f;
  float prev_t = 0.0f, prev_s = 0.0f;
  int prev_ok = 0;
  for (int base = 0; __any_sync(kFull, !done); base += kLanes) {
    const int s = base + lane;
    const float ts = t_min + (float)s * dt;
    // past the band (ts only grows, and a sample past it is never valid)
    const bool in = !done && s < a.num_samples && ts <= limit;
    bool ok;
    const float sd = trilinear_warp(a, s_blk, in, ox + dx * ts, oy + dy * ts,
                                    oz + dz * ts, false, ok, unused);
    float pt = __shfl_up_sync(kFull, ts, 1, kLanes);
    float ps = __shfl_up_sync(kFull, sd, 1, kLanes);
    int pok = __shfl_up_sync(kFull, (int)ok, 1, kLanes);
    if (lane == 0) {
      pt = prev_t;
      ps = prev_s;
      pok = prev_ok;
    }
    const bool cross = pok && ok && ps > 0.0f && sd < 0.0f &&
                       ps - sd < a.thres_sample_dist;
    const unsigned cm = (__ballot_sync(kFull, cross) >> first) & kRayMask;
    const unsigned out = (__ballot_sync(kFull, !in) >> first) & kRayMask;
    // the first crossing (the plain argmax's pick), and the window's last
    const int f = cm != 0u ? __ffs(cm) - 1 : 0;
    const float c_t0 = __shfl_sync(kFull, pt, f, kLanes);
    const float c_s0 = __shfl_sync(kFull, ps, f, kLanes);
    const float c_s1 = __shfl_sync(kFull, sd, f, kLanes);
    const float l_t = __shfl_sync(kFull, ts, kLanes - 1, kLanes);
    const float l_s = __shfl_sync(kFull, sd, kLanes - 1, kLanes);
    const int l_ok = __shfl_sync(kFull, (int)ok, kLanes - 1, kLanes);
    if (!done) {
      if (cm != 0u) {
        b_t0 = c_t0;
        b_s0 = c_s0;
        b_s1 = c_s1;
        crossed = done = true;
      } else if (out != 0u) {
        done = true;
      } else {
        prev_t = l_t;
        prev_s = l_s;
        prev_ok = l_ok;
      }
    }
  }

  // the three secant steps, each sample's corners across the ray's lanes
  // (every lane of the warp takes part, a ray without a crossing idle:
  // each warp-wide shuffle is met by all 32 lanes at the same point)
  const float nan = __int_as_float(0x7FC00000);
  float b_t1 = b_t0 + dt;
  for (int k = 0; k < 3; ++k) {
    const float denom = b_s0 - b_s1;
    const float alpha = fabsf(denom) > a.tiny ? b_s0 / denom : 0.5f;
    const float tm = b_t0 + alpha * (b_t1 - b_t0);
    bool ok;
    const float sm = trilinear_lanes<kLanes>(
        a, crossed, ox + dx * tm, oy + dy * tm, oz + dz * tm, lane, ok);
    if (ok && sm < 0.0f) {
      b_t1 = tm;
      b_s1 = sm;
    }
    if (ok && sm >= 0.0f) {
      b_t0 = tm;
      b_s0 = sm;
    }
  }
  const float denom = b_s0 - b_s1;
  const float alpha = fabsf(denom) > a.tiny ? b_s0 / denom : 0.5f;
  const float t_hit = b_t0 + alpha * (b_t1 - b_t0);
  const float hx = ox + dx * t_hit, hy = oy + dy * t_hit,
              hz = oz + dz * t_hit;

  // the hit's samples across the lanes (every lane of the warp takes
  // part): j = 0 the hit with its color and (kGradients) 1-6
  // sdf_gradient's at p + e and p - e, e = voxel_size on one axis; the
  // first kLanes at once, the rest only for a kept hit
  constexpr int kHit = kGradients ? 7 : 1;
  constexpr int kSteps = (kHit + kLanes - 1) / kLanes;
  const float h[3] = {hx, hy, hz};
  float col[3] = {0.0f, 0.0f, 0.0f};
  float gs[6];
  bool found = false, gok = true;
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    if (st > 0) {
      if (!__any_sync(kFull, found)) break;
    }
    const int j = st * kLanes + lane;
    const int ax = (j - 1) >> 1;
    const bool plus = ((j - 1) & 1) == 0;
    float q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float e = (j >= 1 && k == ax) ? a.voxel_size : 0.0f;
      q[k] = j == 0 ? h[k] : (plus ? h[k] + e : h[k] - e);
    }
    const bool take = (st == 0 ? crossed : found) && j < kHit;
    bool ok;
    const float v = trilinear_warp(a, s_blk, take, q[0], q[1], q[2], j == 0,
                                   ok, col);
    if (st == 0) {
      const float s_hit = __shfl_sync(kFull, v, 0, kLanes);
      const int ok_hit = __shfl_sync(kFull, (int)ok, 0, kLanes);
      found = crossed && ok_hit && fabsf(s_hit) < a.thres_dist;
    }
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int jj = st * kLanes + k;
      if (jj >= 1 && jj < kHit) {
        gs[jj - 1] = __shfl_sync(kFull, v, k, kLanes);
        const int ok_k = __shfl_sync(kFull, (int)ok, k, kLanes);
        gok = gok && ok_k;
      }
    }
  }

  if (!on || lane != 0) return;
  a.found[p] = found;
  a.t_hit[p] = found ? t_hit : nan;
  a.p_hit[3 * p] = found ? hx : nan;
  a.p_hit[3 * p + 1] = found ? hy : nan;
  a.p_hit[3 * p + 2] = found ? hz : nan;
#pragma unroll
  for (int k = 0; k < 3; ++k) a.color_out[3 * p + k] = found ? col[k] : 0.0f;
  if (kGradients) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      a.grad[3 * p + k] = found ? (gs[2 * k] - gs[2 * k + 1]) * 0.5f : nan;
    a.grad_ok[p] = found && gok;
  }
}

template <int kLanes>
cudaError_t launch_march(const MarchArgs& a, bool gradients,
                         cudaStream_t stream) {
  constexpr int kTileY = kMarchThreads / kLanes / kMarchTileX;
  const dim3 grid((a.width + kMarchTileX - 1) / kMarchTileX,
                  (a.height + kTileY - 1) / kTileY);
  if (gradients)
    raymarch_kernel<true, kLanes><<<grid, kMarchThreads, 0, stream>>>(a);
  else
    raymarch_kernel<false, kLanes><<<grid, kMarchThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Loads both kernels' modules (run before a CUDA graph capture); returns
// the registers a thread of the march with gradients, or -1.
extern "C" int vh_raymarch_grid() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, ray_bounds_kernel) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, raymarch_kernel<false, kMarchLanes>) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, raymarch_kernel<true, kMarchLanes>) !=
          cudaSuccess)
    return -1;
  return attr.numRegs;
}

extern "C" int vh_ray_bounds(
    const void* block_key, const void* active_idx, const void* active_mask,
    int m, const void* view, int width, int height, int tile, int tiles_y,
    int tiles_x, int world_blocks, float fx, float fy, float cx, float cy,
    float depth_min, float voxel_size, float block_size, float near_z,
    void* acc, void* t_min, void* t_max, void* stream) {
  if (m < 0 || tile < 1 || tiles_y < 1 || tiles_x < 1 || world_blocks < 1)
    return (int)cudaErrorInvalidValue;
  BoundsArgs a;
  a.block_key = (const int*)block_key;
  a.active_idx = (const int*)active_idx;
  a.active_mask = (const bool*)active_mask;
  a.m = m;
  a.view = (const float*)view;
  a.width = width;
  a.height = height;
  a.tile = tile;
  a.tiles_y = tiles_y;
  a.tiles_x = tiles_x;
  a.world_blocks = world_blocks;
  a.fx = fx;
  a.fy = fy;
  a.cx = cx;
  a.cy = cy;
  a.depth_min = depth_min;
  a.voxel_size = voxel_size;
  a.block_size = block_size;
  a.near_z = near_z;
  a.acc = (int*)acc;
  a.t_min = (float*)t_min;
  a.t_max = (float*)t_max;
  const int n = tiles_y * tiles_x;
  const size_t smem = n <= kMaxSharedTiles ? 2 * n * sizeof(int) : 0;
  const int rows = kBoundsThreads * kBoundsRows;
  const int grid = m > 0 ? (m + rows - 1) / rows : 1;
  ray_bounds_kernel<<<grid, kBoundsThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// One march render (ops/raymarch.py checks the map's arrays, the pose and
// the bounds, and makes the outputs; grad and grad_ok only with
// gradients).
extern "C" int vh_raymarch(
    const void* table_key, const void* table_val, const void* sdf,
    const void* weight, const void* color, int table_size, int max_probes,
    int world_blocks, float voxel_size, const void* pose,
    const void* tile_min, const void* tile_max, int width, int height,
    int tile, int tiles_x, int num_samples, float fx, float fy, float cx,
    float cy, float depth_min, float depth_max, float truncation,
    float steps, float ray_inc, float thres_sample_dist, float thres_dist,
    float tiny, void* t_hit, void* found, void* p_hit, void* color_out,
    void* grad, void* grad_ok, void* stream) {
  if (table_size < 1 || (table_size & (table_size - 1)) != 0 ||
      width < 1 || height < 1 || tile < 1 || num_samples < 2 ||
      world_blocks < 1)
    return (int)cudaErrorInvalidValue;
  MarchArgs a;
  a.table_key = (const int*)table_key;
  a.table_val = (const int*)table_val;
  a.sdf = (const uint16_t*)sdf;
  a.weight = (const uint16_t*)weight;
  a.color = (const int*)color;
  a.table_mask = (uint32_t)(table_size - 1);
  a.max_probes = max_probes;
  a.world_blocks = world_blocks;
  a.voxel_size = voxel_size;
  a.pose = (const float*)pose;
  a.tile_min = (const float*)tile_min;
  a.tile_max = (const float*)tile_max;
  a.width = width;
  a.height = height;
  a.tile = tile;
  a.tiles_x = tiles_x;
  a.num_samples = num_samples;
  a.fx = fx;
  a.fy = fy;
  a.cx = cx;
  a.cy = cy;
  a.depth_min = depth_min;
  a.depth_max = depth_max;
  a.truncation = truncation;
  a.steps = steps;
  a.ray_inc = ray_inc;
  a.thres_sample_dist = thres_sample_dist;
  a.thres_dist = thres_dist;
  a.tiny = tiny;
  a.t_hit = (float*)t_hit;
  a.found = (bool*)found;
  a.p_hit = (float*)p_hit;
  a.color_out = (float*)color_out;
  a.grad = (float*)grad;
  a.grad_ok = (bool*)grad_ok;
  return (int)launch_march<kMarchLanes>(a, grad != nullptr,
                                        (cudaStream_t)stream);
}
