// The march renderer, hand-written for Hopper (sm_90a): the per-tile ray
// bounds (ray_bounds_kernel, one launch after a fill) and the march itself
// (raymarch_kernel<kGradients>, one launch a render), in place of the
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
// ray_bounds_kernel: one thread an active row projects its block's 8
// corners (the view's rotation as cuBLAS's f32 product of three terms, two
// fmas on the first product, then the translation), reduces the z range
// and the screen box, and scatters the z min and max into the (ty, tx)
// tile grid over a span of at most 4 x 4 tiles (or, when the block spans
// more or crosses the near plane, into the global bounds that widen every
// tile). A min or max is exact, so atomics on order-preserving integer
// images of the floats (negative floats included: a block behind the
// camera has a negative z max) give the plain scatter_reduce_ bit for bit;
// a max is kept as the min of the image's complement, so one fill of
// 0x7F800000 sets every accumulator. Each CTA reduces into shared memory
// first (a frame has ~300 tiles and ~26K active rows); the CTA that arrives
// last turns the images into floats and widens every tile by the global
// bounds where a block overflowed.
//
// raymarch_kernel: one thread a ray (a CTA a 16 x 16 pixel tile) forms its
// interval from its tile's bounds (less and plus the truncation, clamped to
// the camera's range) as render_march does, and its step as march_core
// does, then walks the samples in order: it stops at the first sample past
// the band (ts only grows, and a sample past it is never valid) and at the
// first pair that passes the crossing test (the plain argmax over int8 also
// picks the first), so the samples between the surface and the band's end
// are never taken. Then the three secant steps, the sample with color at
// the hit and, under kGradients, the six central-difference samples of
// sdf_gradient (unnormalized; the epilogue that normalizes them, and
// transforms the points, is the plain version's, raycast.march_epilogue,
// shared by both). Rays with no kept hit write NaN points and 0 colors,
// as the plain version after its masks.
//
// Each trilinear sample follows trilinear_sample_soa's operation order: an
// IEEE division by the voxel size, the floor and the saturating int cast
// torch's CUDA cast compiles to, the fractions, the 8 corner weights
// multiplied left to right and summed from 0 in _CORNER_LIST order, the
// color unpacked, weighted, summed and divided by 255; valid where all 8
// weights are > 0. A corner's block is found with lookup's probe (at most
// max_probes rounds, a stop at INVALID_KEY, past tombstones; a key out of
// the world's range is INVALID_KEY). The last block's (key, row) stays in
// registers: at 4 mm voxels most of a sample's 8 corners share one block,
// and a lookup is a pure function of the table, so the cache changes no
// result. bf16 sdf and weight widen to f32 exactly, as torch's .to(f32).
//
// Bound: latency, not bytes or operations: each sample is a chain of
// dependent loads (the probe, then the voxels, then the next sample's
// position depends on neither, but the crossing test on both), and a warp
// runs until its longest ray ends.
//
// Built with -fmad=false (ops/_build.py): every float expression rounds as
// the plain version's separate torch ops; the thresholds arrive as the f32
// values torch compares with.

#include "common.cuh"
#include "hash.cuh"

namespace {

using vh::kInvalidKey;

constexpr int kBoundsThreads = 256;
constexpr int kMaxSharedTiles = 6144;  // two int arrays in 48 KB
constexpr int kSpan = 4;               // raycast._SPAN
constexpr int kIdentity = 0x7F800000;  // image(+inf) == ~image(-inf)
constexpr int kTile = 16;              // the march's CTA: 16 x 16 rays

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
  int* acc;                 // [2n + 4] int32, filled with kIdentity
  float* t_min;             // [n]
  float* t_max;             // [n]
};

__global__ void __launch_bounds__(kBoundsThreads)
    ray_bounds_kernel(BoundsArgs a) {
  extern __shared__ int s_acc[];       // [2n] when n <= kMaxSharedTiles
  __shared__ bool s_last;
  const int n = a.tiles_y * a.tiles_x;
  const bool shared = n <= kMaxSharedTiles;
  int* tmin = shared ? s_acc : a.acc;
  int* tmax = shared ? s_acc + n : a.acc + n;
  if (shared) {
    for (int j = threadIdx.x; j < 2 * n; j += blockDim.x) s_acc[j] = kIdentity;
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.m && a.active_mask[i]) {
    const int key = a.block_key[a.active_idx[i]];
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
    const bool near_ok = z_min > a.near_z;
    const int u_min = (int)floorf(u_lo), u_max = (int)floorf(u_hi);
    const int v_min = (int)floorf(v_lo), v_max = (int)floorf(v_hi);
    const int t0x = min(max(floor_div(u_min, a.tile), 0), a.tiles_x - 1);
    const int t1x = min(max(floor_div(u_max, a.tile), 0), a.tiles_x - 1);
    const int t0y = min(max(floor_div(v_min, a.tile), 0), a.tiles_y - 1);
    const int t1y = min(max(floor_div(v_max, a.tile), 0), a.tiles_y - 1);
    const bool on_screen = u_max >= 0 && u_min < a.width && v_max >= 0 &&
                           v_min < a.height;
    const bool fits = (t1x - t0x < kSpan) && (t1y - t0y < kSpan);
    if (on_screen && near_ok && fits) {
      const int lo = image(z_min), hi = ~image(z_max);
      for (int iy = t0y; iy <= t1y; ++iy)
        for (int ix = t0x; ix <= t1x; ++ix) {
          atomicMin(tmin + iy * a.tiles_x + ix, lo);
          atomicMin(tmax + iy * a.tiles_x + ix, hi);
        }
    } else if (on_screen) {
      atomicMin(a.acc + 2 * n, image(clamp_min(z_min, a.depth_min)));
      atomicMin(a.acc + 2 * n + 1, ~image(z_max));
      atomicMin(a.acc + 2 * n + 2, 0);
    }
  }
  if (shared) {
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * n; j += blockDim.x)
      if (s_acc[j] != kIdentity) atomicMin(a.acc + j, s_acc[j]);
  }
  // the CTA that arrives last finishes the grid
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(a.acc + 2 * n + 3, 1) ==
             kIdentity + (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const bool overflow = __ldcg(a.acc + 2 * n + 2) != kIdentity;
  const float g_min = from_image(__ldcg(a.acc + 2 * n));
  const float g_max = from_image(~__ldcg(a.acc + 2 * n + 1));
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float lo = from_image(__ldcg(a.acc + j));
    float hi = from_image(~__ldcg(a.acc + n + j));
    if (overflow) {
      lo = min_nan(lo, g_min);
      hi = max_nan(hi, g_max);
    }
    a.t_min[j] = lo;
    a.t_max[j] = hi;
  }
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

// The last block looked up: its key (-1: none yet), whether the table
// holds it, and its pool row.
struct BlockCache {
  int key = -1;
  bool found = false;
  int row = 0;
};

__device__ __forceinline__ void lookup(const MarchArgs& a, int key,
                                       BlockCache& cache) {
  if (key == cache.key) return;
  cache.key = key;
  cache.found = false;
  if (key == kInvalidKey) return;
  const vh::Hashes h = vh::hashes_of(key);
  for (int r = 0; r < a.max_probes; ++r) {
    const int slot = vh::slot_of(h, r, a.table_mask);
    const int tk = __ldg(a.table_key + slot);
    if (tk == key) {
      cache.found = true;
      cache.row = __ldg(a.table_val + slot);
      return;
    }
    if (tk == kInvalidKey) return;
  }
}

// trilinear_sample_soa at one point: sdf, valid and (kColor) the color in
// [0, 1].
template <bool kColor>
__device__ __forceinline__ float trilinear(const MarchArgs& a, float px,
                                           float py, float pz,
                                           BlockCache& cache, bool& valid,
                                           float (&col)[3]) {
  const float qx = px / a.voxel_size, qy = py / a.voxel_size,
              qz = pz / a.voxel_size;
  const int bx = (int)floorf(qx), by = (int)floorf(qy), bz = (int)floorf(qz);
  const float fx = qx - (float)bx, fy = qy - (float)by, fz = qz - (float)bz;
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  const int wb = a.world_blocks, half = wb / 2;
  float s = 0.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  valid = true;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
    // int32 corner coordinates wrap as torch's do
    const int vx = (int)((unsigned)bx + (unsigned)ox);
    const int vy = (int)((unsigned)by + (unsigned)oy);
    const int vz = (int)((unsigned)bz + (unsigned)oz);
    const int gxk = (vx >> 3) + half, gyk = (vy >> 3) + half,
              gzk = (vz >> 3) + half;
    const bool in_range = gxk >= 0 && gxk < wb && gyk >= 0 && gyk < wb &&
                          gzk >= 0 && gzk < wb;
    lookup(a, in_range ? (gzk * wb + gyk) * wb + gxk : kInvalidKey, cache);
    float sd = 0.0f, w = 0.0f;
    int packed = 0;
    if (cache.found) {
      const long long lin = (long long)cache.row * 512 +
                            (((vz & 7) * 8 + (vy & 7)) * 8 + (vx & 7));
      sd = vh::bf16_bits_to_float(__ldg(a.sdf + lin));
      w = vh::bf16_bits_to_float(__ldg(a.weight + lin));
      if (kColor) packed = __ldg(a.color + lin);
    }
    valid = valid && w > 0.0f;
    const float tw = ((ox ? fx : gx) * (oy ? fy : gy)) * (oz ? fz : gz);
    s = s + tw * sd;
    if (kColor) {
      cr = cr + tw * (float)((packed >> 16) & 0xFF);
      cg = cg + tw * (float)((packed >> 8) & 0xFF);
      cb = cb + tw * (float)(packed & 0xFF);
    }
  }
  if (kColor) {
    col[0] = cr / 255.0f;
    col[1] = cg / 255.0f;
    col[2] = cb / 255.0f;
  }
  return s;
}

template <bool kGradients>
__global__ void __launch_bounds__(kTile* kTile)
    raymarch_kernel(MarchArgs a) {
  const int col_px = blockIdx.x * kTile + threadIdx.x;
  const int row_px = blockIdx.y * kTile + threadIdx.y;
  if (col_px >= a.width || row_px >= a.height) return;
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

  BlockCache cache;
  float unused[3];
  bool crossed = false;
  float b_t0 = 0.0f, b_s0 = 0.0f, b_s1 = 0.0f;
  float prev_t = 0.0f, prev_s = 0.0f;
  bool prev_ok = false;
  for (int s = 0; s < a.num_samples; ++s) {
    const float ts = t_min + (float)s * dt;
    if (!(ts <= limit)) break;          // past the band: so is every later
    bool ok;
    const float sd = trilinear<false>(a, ox + dx * ts, oy + dy * ts,
                                      oz + dz * ts, cache, ok, unused);
    if (prev_ok && ok && prev_s > 0.0f && sd < 0.0f &&
        prev_s - sd < a.thres_sample_dist) {
      crossed = true;
      b_t0 = prev_t;
      b_s0 = prev_s;
      b_s1 = sd;
      break;
    }
    prev_t = ts;
    prev_s = sd;
    prev_ok = ok;
  }

  bool found = false;
  float t_hit = 0.0f, hx = 0.0f, hy = 0.0f, hz = 0.0f;
  float col[3] = {0.0f, 0.0f, 0.0f};
  if (crossed) {
    float b_t1 = b_t0 + dt;
    for (int k = 0; k < 3; ++k) {
      const float denom = b_s0 - b_s1;
      const float alpha = fabsf(denom) > a.tiny ? b_s0 / denom : 0.5f;
      const float tm = b_t0 + alpha * (b_t1 - b_t0);
      bool ok;
      const float sm = trilinear<false>(a, ox + dx * tm, oy + dy * tm,
                                        oz + dz * tm, cache, ok, unused);
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
    t_hit = b_t0 + alpha * (b_t1 - b_t0);
    hx = ox + dx * t_hit;
    hy = oy + dy * t_hit;
    hz = oz + dz * t_hit;
    bool ok;
    const float s_hit = trilinear<true>(a, hx, hy, hz, cache, ok, col);
    found = ok && fabsf(s_hit) < a.thres_dist;
  }

  const float nan = __int_as_float(0x7FC00000);
  a.found[p] = found;
  a.t_hit[p] = found ? t_hit : nan;
  a.p_hit[3 * p] = found ? hx : nan;
  a.p_hit[3 * p + 1] = found ? hy : nan;
  a.p_hit[3 * p + 2] = found ? hz : nan;
#pragma unroll
  for (int k = 0; k < 3; ++k) a.color_out[3 * p + k] = found ? col[k] : 0.0f;
  if (kGradients) {
    // sdf_gradient's samples at p + e and p - e, e = voxel_size on one axis
    float g[3] = {nan, nan, nan};
    bool g_ok = false;
    if (found) {
      const float h[3] = {hx, hy, hz};
      g_ok = true;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        float pp[3], pm[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float e = k == ax ? a.voxel_size : 0.0f;
          pp[k] = h[k] + e;
          pm[k] = h[k] - e;
        }
        bool vp, vm;
        const float sp = trilinear<false>(a, pp[0], pp[1], pp[2], cache, vp,
                                          unused);
        const float sm = trilinear<false>(a, pm[0], pm[1], pm[2], cache, vm,
                                          unused);
        g[ax] = (sp - sm) * 0.5f;
        g_ok = g_ok && vp && vm;
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) a.grad[3 * p + k] = g[k];
    a.grad_ok[p] = g_ok;
  }
}

}  // namespace

// Loads both kernels' modules (run before a CUDA graph capture); returns
// the march kernel's registers a thread, or -1.
extern "C" int vh_raymarch_grid() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, ray_bounds_kernel) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, raymarch_kernel<true>) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, raymarch_kernel<false>) != cudaSuccess)
    return -1;
  return attr.numRegs;
}

// The tile bounds of ray_interval_splat (ops/raymarch.py checks the
// shapes, fills acc with 0x7F800000 and makes the outputs).
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
  const int grid = m > 0 ? (m + kBoundsThreads - 1) / kBoundsThreads : 1;
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
  const dim3 block(kTile, kTile);
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  if (grad != nullptr)
    raymarch_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else
    raymarch_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
