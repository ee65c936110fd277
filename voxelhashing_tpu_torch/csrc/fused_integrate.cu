// Kernel A: fused TSDF integrate, hand-written for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel voxelhashing_tpu/ops/pallas_integrate.py
// (_make_kernel/_kernel_body, launched by _run_fused at :321). It computes
// what the plain function integrate.integrate computes, bit for bit, not the
// Pallas kernel's TPU deviations (no two-limb bf16 depth, no 32-row patch
// window, no one-hot matmuls, no padding sentinels).
//
// What bounds it: the bytes it moves. Each active row must be read (bf16
// sdf and weight, 2 KB of 512 voxels) and each updated voxel's color read
// and its sdf, weight and color written (12 B); the frame (300 KB of depth,
// 900 KB of RGB) stays in L2. Its ~46 f32 operations per voxel (74 per
// updated one) take less time at the card's f32 rate (PERF.md §6).
//
// Design:
// - A persistent grid: the SM count times the CTAs that fit on an SM, for
//   any size of the active list. CTA b takes the rows b, b + grid, ...
//   below *n_active, read from device memory (the host never reads it);
//   the tail [n_active, max_rows) gets empty stats (inf, 0) from a strided
//   loop.
// - The pool rows and block corners (unpacked block keys) of up to 128 of a
//   CTA's rows are loaded at once, one per thread, into shared memory, so
//   no row waits on a chain of dependent index loads.
// - A two-stage ring of rows in shared memory: one thread issues 1-D bulk
//   copies (TMA, cp.async.bulk) of a row's sdf (1 KB), weight (1 KB) and
//   color (2 KB) that complete on the stage's mbarrier, two rows ahead of
//   the row being computed. A stage is refilled right after every thread
//   has copied its row into registers.
// - 128 threads per row, four x-consecutive voxels per thread: sdf and
//   weight move as 8-byte vectors, color as 16-byte vectors, and the y/z
//   terms of the projection are shared by a thread's four voxels.
// - A 4-voxel group with any updated voxel is written back whole (8 + 8 +
//   16 bytes, the unchanged voxels with their own bits); a group without
//   one is not written.
// - The color word (packed RGB x255 plus a validity bit) is formed here
//   from the f32 RGB frame, as integrate.frame_color_word forms it, and
//   only for voxels that pass every other update test.
// - Bilinear color (MapConfig.bilinear_color) is the template flag
//   kBilinear: the color word is then the validity-weighted bilinear sample
//   of integrate._bilinear_color at the continuous projection (four color
//   words around the rounded centre, IEEE divides), one per voxel that
//   passes the other tests. Kernel A's counterpart on the TPU is XLA
//   (engine.py routes this configuration away from the Pallas kernel), so
//   the variant follows the XLA function.
// - The bilinear variant reads its corners from a per-frame color-word
//   image (int32 [h*w], 300 KB at 320x240, in L2) that
//   frame_color_words_kernel builds just before it on the same stream,
//   one thread per pixel: each of the ~43M corner reads of a frame is then
//   one 4-byte load and three shifts instead of three f32 loads and the
//   color word's tests. The variant is then bound by the instructions it
//   issues per updated voxel (nine IEEE divisions among them), not by its
//   occupancy: capped at 56 registers (9 CTAs an SM, with spills) it ran
//   no faster than with its 96 (5 CTAs an SM), so it has no cap (PERF.md
//   §6).
// - The per-row GC stats and surface flag are reduced from registers
//   (warp shuffles, then four partials per row in shared memory); a row's
//   partials are combined one row later, after the next ring barrier.

#include <type_traits>

#include "common.cuh"

namespace {

using vh::kRowThreads;
using vh::kStages;
using vh::kVoxelsPerBlock;
using vh::kVoxelsPerThread;

constexpr int kWarps = kRowThreads / 32;
constexpr int kListRows = kRowThreads;  // rows whose indices load at once
constexpr uint32_t kPoolWordBytes = kVoxelsPerBlock * 2;  // one bf16 row
constexpr uint32_t kColorRowBytes = kVoxelsPerBlock * 4;

struct RowStage {
  uint16_t sdf[kVoxelsPerBlock];
  uint16_t weight[kVoxelsPerBlock];
  int color[kVoxelsPerBlock];
};

// integrate.frame_color_word for one pixel: where(isfinite(c), c, -1) * 255,
// clamped to [0, 255], truncated and packed 0x00RRGGBB, with bit 24 set
// when all three channels are finite and >= 0. No frame (depth-only): the
// reference's debug green, always valid.
__device__ __forceinline__ int color_word(const float* __restrict__ rgb,
                                          int pix) {
  if (rgb == nullptr) return 0x0100FF00;
  int packed = 0;
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c = rgb[3 * pix + k];
    const bool fin = isfinite(c);
    ok = ok && fin && c >= 0.0f;
    const float x = fminf(fmaxf((fin ? c : -1.0f) * 255.0f, 0.0f), 255.0f);
    packed = (packed << 8) | (int)x;
  }
  return ok ? (packed | 0x01000000) : packed;
}

// The per-frame color-word image of the bilinear variant: one thread per
// pixel writes color_word (integrate.frame_color_word).
__global__ void __launch_bounds__(256)
frame_color_words_kernel(const float* __restrict__ rgb,
                         int* __restrict__ words, int n_pixels) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix < n_pixels) words[pix] = color_word(rgb, pix);
}

// One corner of the bilinear sample (integrate._bilinear_color's fetch):
// the color word of the clamped pixel, and in `ok` whether the pixel is on
// screen with a valid color.
__device__ __forceinline__ int corner_word(const int* __restrict__ words,
                                           int px, int py, int width,
                                           int height, bool& ok) {
  const bool on = px >= 0 && px < width && py >= 0 && py < height;
  const int idx =
      min(max(py, 0), height - 1) * width + min(max(px, 0), width - 1);
  const int word = __ldg(words + idx);
  ok = on && (word >> 24) == 1;
  return word;
}

// integrate._bilinear_color for one voxel at the continuous projection
// (uf, vf), in its operation order: the rounded centre and its neighbours
// in the direction of the fractional offsets (an offset of exactly 0 goes
// +1), invalid corners weighted 0, the row normalisations, then the
// column one, packed as blockmap.pack_rgb packs (clamp, truncate), with
// bit 24 set when any corner was valid. The corners' channels are shifted
// out of their words one channel at a time. No frame: the debug green,
// valid.
__device__ __forceinline__ int bilinear_word(const int* __restrict__ words,
                                             float uf, float vf, int width,
                                             int height) {
  if (words == nullptr) return 0x0100FF00;
  const int p00x = (int)floorf(uf + 0.5f);
  const int p00y = (int)floorf(vf + 0.5f);
  const float ox = uf - (float)p00x;
  const float oy = vf - (float)p00y;
  const int dirx = ox >= 0.0f ? 1 : -1;
  const int diry = oy >= 0.0f ? 1 : -1;
  const float alpha = ox * (float)dirx;
  const float beta = oy * (float)diry;
  bool ok00, ok10, ok01, ok11;
  const int k00 = corner_word(words, p00x, p00y, width, height, ok00);
  const int k10 = corner_word(words, p00x + dirx, p00y, width, height, ok10);
  const int k01 = corner_word(words, p00x, p00y + diry, width, height, ok01);
  const int k11 =
      corner_word(words, p00x + dirx, p00y + diry, width, height, ok11);
  const float w00 = ok00 ? 1.0f - alpha : 0.0f;
  const float w10 = ok10 ? alpha : 0.0f;
  const float w01 = ok01 ? 1.0f - alpha : 0.0f;
  const float w11 = ok11 ? alpha : 0.0f;
  const float wr0 = w00 + w10;
  const float wr1 = w01 + w11;
  const float wb0 = wr0 > 0.0f ? 1.0f - beta : 0.0f;
  const float wb1 = wr1 > 0.0f ? beta : 0.0f;
  const float ww = wb0 + wb1;
  int packed = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int sh = 16 - 8 * k;
    const float c00 = (float)((k00 >> sh) & 0xFF);
    const float c10 = (float)((k10 >> sh) & 0xFF);
    const float c01 = (float)((k01 >> sh) & 0xFF);
    const float c11 = (float)((k11 >> sh) & 0xFF);
    const float p0 = (c00 * w00 + c10 * w10) / fmaxf(wr0, 1e-12f);
    const float p1 = (c01 * w01 + c11 * w11) / fmaxf(wr1, 1e-12f);
    const float out = (p0 * wb0 + p1 * wb1) / fmaxf(ww, 1e-12f);
    packed = (packed << 8) | (int)fminf(fmaxf(out, 0.0f), 255.0f);
  }
  return ww > 0.0f ? (packed | 0x01000000) : packed;
}

// Thread 0: fill `stage` with pool row `pool` by three bulk copies that
// complete on `bar`.
__device__ __forceinline__ void issue_row(RowStage* stage, uint64_t* bar,
                                          int pool, const uint16_t* sdf,
                                          const uint16_t* weight,
                                          const int* color) {
  const size_t off = (size_t)pool * kVoxelsPerBlock;
  vh::mbar_arrive_expect_tx(bar, sizeof(RowStage));
  vh::bulk_g2s(stage->sdf, sdf + off, kPoolWordBytes, bar);
  vh::bulk_g2s(stage->weight, weight + off, kPoolWordBytes, bar);
  vh::bulk_g2s(stage->color, color + off, kColorRowBytes, bar);
}

// The frame's color as the kernel reads it: the f32 RGB frame (nearest
// color) or the per-frame color-word image (bilinear); nullptr when the
// frame is depth-only.
template <bool kBilinear>
using FrameColor = std::conditional_t<kBilinear, int, float>;

template <bool kBilinear>
__global__ void __launch_bounds__(kRowThreads)
fused_integrate_kernel(const float* __restrict__ view_g,
                       const float* __restrict__ depth,
                       const FrameColor<kBilinear>* __restrict__ frame,
                       const int* __restrict__ block_key,
                       const int* __restrict__ active_idx,
                       const int* __restrict__ n_active,
                       uint16_t* __restrict__ sdf,
                       uint16_t* __restrict__ weight,
                       int* __restrict__ color, uint8_t* __restrict__ surf,
                       float* __restrict__ stats, int max_rows,
                       int width, int height, float fx, float fy, float cx,
                       float cy, float depth_min,
                       float depth_range, float voxel_size, float truncation,
                       float truncation_scale, float max_dist,
                       float weight_sample15, float weight_max,
                       int world_blocks) {
  __shared__ __align__(128) RowStage ring[kStages];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int s_pools[kListRows];
  __shared__ int3 s_corners[kListRows];
  __shared__ float s_mn[2][kWarps];
  __shared__ float s_mx[2][kWarps];
  __shared__ int s_any[2][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grid = gridDim.x;
  const int n = min(max(*n_active, 0), max_rows);

  for (int i = n + blockIdx.x * kRowThreads + tid; i < max_rows;
       i += grid * kRowThreads) {
    stats[2 * i] = INFINITY;
    stats[2 * i + 1] = 0.0f;
  }
  // this CTA's rows: blockIdx.x + k * grid for k < n_mine
  const int n_mine = (int)blockIdx.x < n ? (n - 1 - (int)blockIdx.x) / grid + 1
                                         : 0;
  if (n_mine == 0) return;

  float view[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) view[k] = view_g[k];
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) vh::mbar_init(&full[s], 1);
    vh::mbar_fence_init();
  }

  // Thread 0: the previous row's partials become its stats and surface flag
  // once the next barrier has passed.
  auto finalize = [&](int row, int pool, int p) {
    float mn = s_mn[p][0], mx = s_mx[p][0];
    int any = s_any[p][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      mn = fminf(mn, s_mn[p][w]);
      mx = fmaxf(mx, s_mx[p][w]);
      any |= s_any[p][w];
    }
    stats[2 * row] = mn;
    stats[2 * row + 1] = mx;
    surf[pool] = any ? 1 : 0;
  };

  int it = 0;                         // ring iteration, over all batches
  int prev_row = -1, prev_pool = 0;   // thread 0
  for (int k0 = 0; k0 < n_mine; k0 += kListRows) {
    // the pool rows and block keys of up to kListRows rows, one per thread
    const int kb = min(kListRows, n_mine - k0);
    if (tid < kb) {
      const int pool = active_idx[blockIdx.x + (k0 + tid) * grid];
      s_pools[tid] = pool;
      s_corners[tid] = vh::block_corner(block_key[pool], world_blocks);
    }
    __syncthreads();
    if (tid == 0) {
      for (int k = 0; k < kStages && k < kb; ++k) {
        const int s = (it + k) % kStages;
        issue_row(&ring[s], &full[s], s_pools[k], sdf, weight, color);
      }
    }

    for (int k = 0; k < kb; ++k, ++it) {
      const int s = it % kStages;
      vh::mbar_wait(&full[s], (uint32_t)(it / kStages) & 1u);
      const int pool = s_pools[k];
      const int3 corner = s_corners[k];
      const uint2 sw = reinterpret_cast<const uint2*>(ring[s].sdf)[tid];
      const uint2 ww = reinterpret_cast<const uint2*>(ring[s].weight)[tid];
      const int4 cw = reinterpret_cast<const int4*>(ring[s].color)[tid];
      __syncthreads();  // stage s is read; the previous row's partials landed

      if (tid == 0) {
        if (k + kStages < kb) {
          issue_row(&ring[s], &full[s], s_pools[k + kStages], sdf, weight,
                    color);
        }
        if (prev_row >= 0) finalize(prev_row, prev_pool, (it - 1) & 1);
        prev_row = blockIdx.x + (k0 + k) * grid;
        prev_pool = pool;
      }

      float pxs[4], pys[4], pzs[4];
      vh::camera_x4(view, corner, tid, voxel_size, pxs, pys, pzs);

      // The four voxels go through each step side by side, so that their
      // depth reads, and then their color reads, are in flight together.
      int pix[4];
      bool in_band[4];
      float dep[4], sd[4], trunc[4], ufs[4], vfs[4];
#pragma unroll
      for (int j = 0; j < kVoxelsPerThread; ++j) {
        const float safe_z = (pzs[j] == 0.0f) ? 1e-12f : pzs[j];
        const float uf = pxs[j] * fx / safe_z + cx;
        const float vf = pys[j] * fy / safe_z + cy;
        ufs[j] = uf;
        vfs[j] = vf;
        int ui = (int)floorf(uf + 0.5f);
        int vi = (int)floorf(vf + 0.5f);
        in_band[j] =
            ui >= 0 && ui < width && vi >= 0 && vi < height && pzs[j] > 0.0f;
        ui = min(max(ui, 0), width - 1);
        vi = min(max(vi, 0), height - 1);
        pix[j] = vi * width + ui;
      }
#pragma unroll
      for (int j = 0; j < kVoxelsPerThread; ++j) dep[j] = depth[pix[j]];
#pragma unroll
      for (int j = 0; j < kVoxelsPerThread; ++j) {
        const bool d_valid = isfinite(dep[j]) && dep[j] > 0.0f;
        dep[j] = d_valid ? dep[j] : 0.0f;
        sd[j] = dep[j] - pzs[j];
        trunc[j] = truncation + truncation_scale * dep[j];
        in_band[j] = in_band[j] && d_valid && dep[j] < max_dist &&
                     sd[j] > -trunc[j];
      }
      int pc[4];
#pragma unroll
      for (int j = 0; j < kVoxelsPerThread; ++j) {
        if (!in_band[j]) {
          pc[j] = 0;
        } else if constexpr (kBilinear) {
          pc[j] = bilinear_word(frame, ufs[j], vfs[j], width, height);
        } else {
          pc[j] = color_word(frame, pix[j]);
        }
      }

      const int old_c[4] = {cw.x, cw.y, cw.z, cw.w};
      uint32_t out_s[4], out_w[4];
      int out_c[4];
      bool any_update = false;
      float mn = INFINITY, mx = -INFINITY;
      int is_surf = 0;
#pragma unroll
      for (int j = 0; j < kVoxelsPerThread; ++j) {
        out_s[j] = vh::bf16x4_get(sw, j);
        out_w[j] = vh::bf16x4_get(ww, j);
        out_c[j] = old_c[j];
        if (in_band[j] && (pc[j] >> 24) == 1) {
          const float d = dep[j];
          const float s_t = fminf(fmaxf(sd[j], -trunc[j]), trunc[j]);
          const float depth01 = (d - depth_min) / depth_range;
          const float w_new =
              fmaxf(weight_sample15 * (1.0f - depth01), 1.0f);
          const float old_s = vh::bf16_bits_to_float(out_s[j]);
          const float old_w = vh::bf16_bits_to_float(out_w[j]);
          const float w_sum = old_w + w_new;
          out_s[j] =
              vh::float_to_bf16_bits((old_s * old_w + s_t * w_new) / w_sum);
          out_w[j] = vh::float_to_bf16_bits(fminf(w_sum, weight_max));
          // 50/50 per-channel blend with +0.5 rounding: (o + n + 1) >> 1
          const int c_new = pc[j] & 0x00FFFFFF;
          const int rb = (((old_c[j] & 0x00FF00FF) + (c_new & 0x00FF00FF) +
                           0x00010001) >> 1) & 0x00FF00FF;
          const int g = (((old_c[j] & 0x0000FF00) + (c_new & 0x0000FF00) +
                          0x00000100) >> 1) & 0x0000FF00;
          out_c[j] = rb | g;
          any_update = true;
        }
        // per-block stats over the stored (rounded) values
        const float ws = vh::bf16_bits_to_float(out_w[j]);
        const float as = fabsf(vh::bf16_bits_to_float(out_s[j]));
        is_surf |= (ws > 0.0f && as < voxel_size) ? 1 : 0;
        mn = fminf(mn, ws > 0.0f ? as : INFINITY);
        mx = fmaxf(mx, ws);
      }

      if (any_update) {
        const size_t off = (size_t)pool * kVoxelsPerBlock +
                           (size_t)kVoxelsPerThread * tid;
        reinterpret_cast<uint2*>(sdf + off)[0] = make_uint2(
            out_s[0] | (out_s[1] << 16), out_s[2] | (out_s[3] << 16));
        reinterpret_cast<uint2*>(weight + off)[0] = make_uint2(
            out_w[0] | (out_w[1] << 16), out_w[2] | (out_w[3] << 16));
        reinterpret_cast<int4*>(color + off)[0] =
            make_int4(out_c[0], out_c[1], out_c[2], out_c[3]);
      }

#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const int warp_surf = __any_sync(0xffffffffu, is_surf);
      if (lane == 0) {
        s_mn[it & 1][warp] = mn;
        s_mx[it & 1][warp] = mx;
        s_any[it & 1][warp] = warp_surf;
      }
    }
    // the batch's lists are read and its last partials have landed
    __syncthreads();
  }
  if (tid == 0) finalize(prev_row, prev_pool, (it - 1) & 1);
}

int grid_cache[2] = {0, 0};

template <bool kBilinear>
int grid_of() {
  return vh::persistent_grid(fused_integrate_kernel<kBilinear>, kRowThreads,
                             0, &grid_cache[kBilinear ? 1 : 0]);
}

template <bool kBilinear>
int launch(const void* view, const void* depth, const void* rgb,
           const void* block_key, const void* active_idx,
           const void* n_active, void* sdf, void* weight, void* color,
           void* surf, void* stats, int max_rows, int width, int height,
           float fx, float fy, float cx, float cy, float depth_min,
           float depth_range, float voxel_size, float truncation,
           float truncation_scale, float max_dist, float weight_sample15,
           float weight_max, int world_blocks, void* stream) {
  const int grid = grid_of<kBilinear>();
  if (grid <= 0) {
    const int err = (int)cudaGetLastError();
    return err != 0 ? err : (int)cudaErrorInvalidConfiguration;
  }
  if (max_rows > 0) {
    fused_integrate_kernel<kBilinear>
        <<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(
        (const float*)view, (const float*)depth,
        (const FrameColor<kBilinear>*)rgb, (const int*)block_key,
        (const int*)active_idx, (const int*)n_active, (uint16_t*)sdf,
        (uint16_t*)weight, (int*)color, (uint8_t*)surf, (float*)stats,
        max_rows, width, height, fx, fy, cx, cy, depth_min, depth_range,
        voxel_size, truncation, truncation_scale, max_dist, weight_sample15,
        weight_max, world_blocks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The persistent grids the two variants launch with (0 if they cannot be
// found).
extern "C" int vh_fused_integrate_grid() { return grid_of<false>(); }
extern "C" int vh_fused_integrate_bilinear_grid() { return grid_of<true>(); }

#define VH_FUSED_INTEGRATE_ARGS                                              \
  const void *view, const void *depth, const void *rgb,                      \
      const void *block_key, const void *active_idx, const void *n_active,   \
      void *sdf, void *weight, void *color, void *surf, void *stats,         \
      int max_rows, int width, int height, float fx, float fy, float cx,     \
      float cy, float depth_min, float depth_range, float voxel_size,        \
      float truncation, float truncation_scale, float max_dist,              \
      float weight_sample15, float weight_max, int world_blocks, void *stream
#define VH_FUSED_INTEGRATE_CALL                                              \
  view, depth, rgb, block_key, active_idx, n_active, sdf, weight, color,     \
      surf, stats, max_rows, width, height, fx, fy, cx, cy, depth_min,       \
      depth_range, voxel_size, truncation, truncation_scale, max_dist,       \
      weight_sample15, weight_max, world_blocks, stream

// Nearest-pixel color (the default; rgb is the f32 RGB frame) and
// bilinear color (rgb is the frame's color-word image that
// vh_frame_color_words wrote).
extern "C" int vh_fused_integrate(VH_FUSED_INTEGRATE_ARGS) {
  return launch<false>(VH_FUSED_INTEGRATE_CALL);
}
extern "C" int vh_fused_integrate_bilinear(VH_FUSED_INTEGRATE_ARGS) {
  return launch<true>(VH_FUSED_INTEGRATE_CALL);
}

// The bilinear variant's pre-pass: words (int32 [n_pixels]) takes each
// pixel's color word from rgb (f32 [n_pixels, 3]).
extern "C" int vh_frame_color_words(const void* rgb, void* words,
                                    int n_pixels, void* stream) {
  if (n_pixels > 0) {
    frame_color_words_kernel<<<(n_pixels + 255) / 256, 256, 0,
                               (cudaStream_t)stream>>>(
        (const float*)rgb, (int*)words, n_pixels);
  }
  return (int)cudaGetLastError();
}
