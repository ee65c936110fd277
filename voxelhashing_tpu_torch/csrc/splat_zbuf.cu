// Kernel B: splat z-buffer, and its color pass, hand-written for Hopper
// (sm_90a).
//
// Kernel B replaces the TPU Pallas kernel voxelhashing_tpu/ops/pallas_splat.py
// (_make_kernel/_body, launched by _run_splat at :188). It computes what the
// plain function splat_zbuf.splat_zbuf_plain computes (a scatter-min of each
// surface-band voxel's predicted surface depth), bit for bit, not the Pallas
// kernel's TPU deviations (no in-block averaging on a 32x256 patch, no
// one-hot matmuls, no padding sentinels, so nothing is ever clipped).
// A surviving voxel min-reduces the int bits of its positive float z_surf
// into a z-buffer that starts at the bits of +inf (0x7F800000): positive
// IEEE floats order like their int bits, and a min does not depend on the
// order of the atomics, so the result is exactly the scatter-min.
//
// The color pass (vh_splat_color) runs after kernel B, on the same rows
// through the same kernel body (the template flag kColor). The JAX package
// has no TPU kernel for it: on the TPU the color render stays XLA
// (voxelhashing_tpu/raycast.py:437-441, a zbuf-equality gather and a color
// scatter). Each voxel whose z_surf bits equal the finished z-buffer at its
// pixel is a hit; of the hits at one pixel the one with the largest flat
// index (active-list position * 512 + voxel) wins, so the result does not
// depend on the order of the atomics: one 64-bit atomicMax of
// (flat index << 32 | packed color) per hit. The caller reads the low words.
// Its plain version is splat_zbuf.splat_color_plain (scatter_reduce_ amax
// of the same keys).
//
// What bounds both: the bytes of the surface rows (bf16 sdf and weight, 2 KB
// of 512 voxels each, read straight from the pool through active_idx) and
// the 300 KB z-buffer, which stays in L2; the color pass adds one 4-byte
// color read per hit.
//
// Design:
// - A persistent grid that finds its own rows: CTA b takes the rows b,
//   b + grid, ... of the active list (surface rows cluster, and the stride
//   spreads a cluster over many CTAs); for each 32 of them warp 0 reads the
//   row_mask bytes, __ballot_sync gives the set rows, and its lanes load
//   their pool rows and block corners (unpacked block keys) side by side
//   into a compacted list in shared memory. No CTA is spent on a masked
//   row, and there is no compaction launch and no host read.
// - 128 threads per row, four x-consecutive voxels per thread (8-byte sdf
//   and weight vectors), and the same two-stage ring of rows as kernel A:
//   one thread issues 1-D bulk copies (TMA) of the next surface row's sdf
//   and weight that complete on the stage's mbarrier.
// - A thread projects its four voxels side by side, with no branch, so the
//   four dependent chains (two IEEE divisions each) overlap
//   (vh::splat_targets_x4, shared by both passes).
// - One atomicMin per surviving voxel. Aggregating first (across the warp
//   with __match_any_sync, or over a thread's run of voxels on one pixel)
//   issued fewer atomics and was not faster (PERF.md §6).

#include "common.cuh"

namespace {

using vh::kRowThreads;
using vh::kStages;
using vh::kVoxelsPerBlock;
using vh::kVoxelsPerThread;

constexpr uint32_t kPoolWordBytes = kVoxelsPerBlock * 2;  // one bf16 row
constexpr int kBatchRows = 32;  // rows whose mask bytes one warp reads

struct SurfStage {
  uint16_t sdf[kVoxelsPerBlock];
  uint16_t weight[kVoxelsPerBlock];
};

// Thread 0: fill `stage` with pool row `pool` by two bulk copies that
// complete on `bar`.
__device__ __forceinline__ void issue_row(SurfStage* stage, uint64_t* bar,
                                          int pool, const uint16_t* sdf,
                                          const uint16_t* weight) {
  const size_t off = (size_t)pool * kVoxelsPerBlock;
  vh::mbar_arrive_expect_tx(bar, sizeof(SurfStage));
  vh::bulk_g2s(stage->sdf, sdf + off, kPoolWordBytes, bar);
  vh::bulk_g2s(stage->weight, weight + off, kPoolWordBytes, bar);
}

// kColor false: kernel B, atomicMin of z_surf bits into zbuf. kColor true:
// the color pass, zbuf is read and each hit atomicMax-es its key into win.
template <bool kColor>
__global__ void __launch_bounds__(kRowThreads)
splat_zbuf_kernel(const float* __restrict__ view_g,
                  const int* __restrict__ block_key,
                  const int* __restrict__ active_idx,
                  const uint8_t* __restrict__ row_mask,
                  const uint16_t* __restrict__ sdf,
                  const uint16_t* __restrict__ weight,
                  int* __restrict__ zbuf, const int* __restrict__ color,
                  unsigned long long* __restrict__ win, int n_rows,
                  vh::SplatCamera cam, float voxel_size, int world_blocks) {
  __shared__ __align__(128) SurfStage ring[kStages];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int s_pools[kBatchRows];
  __shared__ int3 s_corners[kBatchRows];
  __shared__ int s_rows[kColor ? kBatchRows : 1];
  __shared__ int s_count;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grid = gridDim.x;

  float view[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) view[k] = view_g[k];
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) vh::mbar_init(&full[s], 1);
    vh::mbar_fence_init();
  }

  // this CTA's rows: blockIdx.x + k * grid for k < n_mine; surface rows
  // cluster in the active list, and the stride spreads each cluster over
  // many CTAs
  const int n_mine = (int)blockIdx.x < n_rows
                         ? (n_rows - 1 - (int)blockIdx.x) / grid + 1
                         : 0;
  int it = 0;  // ring iteration, over all batches
  for (int k0 = 0; k0 < n_mine; k0 += kBatchRows) {
    // warp 0: the set rows of the next 32 of this CTA's rows, their pool
    // rows and block corners, compacted in row order
    if (warp == 0) {
      const int k = k0 + lane;
      const int row = (int)blockIdx.x + k * grid;
      const bool set = k < n_mine && row_mask[row] != 0;
      const unsigned bits = __ballot_sync(0xffffffffu, set);
      if (set) {
        const int pos = __popc(bits & ((1u << lane) - 1u));
        const int pool = active_idx[row];
        s_pools[pos] = pool;
        s_corners[pos] = vh::block_corner(block_key[pool], world_blocks);
        if constexpr (kColor) s_rows[pos] = row;
      }
      if (lane == 0) s_count = __popc(bits);
    }
    __syncthreads();
    const int kb = s_count;
    if (tid == 0) {
      for (int k = 0; k < kStages && k < kb; ++k) {
        const int s = (it + k) % kStages;
        issue_row(&ring[s], &full[s], s_pools[k], sdf, weight);
      }
    }

    for (int k = 0; k < kb; ++k, ++it) {
      const int s = it % kStages;
      vh::mbar_wait(&full[s], (uint32_t)(it / kStages) & 1u);
      const int3 corner = s_corners[k];
      const uint2 sw = reinterpret_cast<const uint2*>(ring[s].sdf)[tid];
      const uint2 ww = reinterpret_cast<const uint2*>(ring[s].weight)[tid];
      __syncthreads();  // stage s is read by every thread
      if (tid == 0 && k + kStages < kb)
        issue_row(&ring[s], &full[s], s_pools[k + kStages], sdf, weight);

      // a warp whose 128 voxels hold no surface-band voxel skips the row
      float sd[4];
      bool band[4];
      bool any_band = false;
#pragma unroll
      for (int j = 0; j < kVoxelsPerThread; ++j) {
        sd[j] = vh::bf16_bits_to_float(vh::bf16x4_get(sw, j));
        const float w = vh::bf16_bits_to_float(vh::bf16x4_get(ww, j));
        band[j] = w > 0.0f && fabsf(sd[j]) < voxel_size;
        any_band |= band[j];
      }
      if (!__any_sync(0xffffffffu, any_band)) continue;
      // the four voxels side by side (independent chains, no branch), then
      // one atomic for each that survives
      int pix[4];
      unsigned z_bits[4];
      vh::splat_targets_x4(view, corner, tid, voxel_size, cam, sd, band, pix,
                           z_bits);
      if constexpr (kColor) {
        const size_t base = (size_t)s_pools[k] * kVoxelsPerBlock;
        const unsigned long long flat0 =
            (unsigned long long)s_rows[k] * kVoxelsPerBlock + 4 * tid;
#pragma unroll
        for (int j = 0; j < kVoxelsPerThread; ++j) {
          if (pix[j] >= 0 && zbuf[pix[j]] == (int)z_bits[j]) {
            const unsigned c = (unsigned)color[base + 4 * tid + j];
            atomicMax(&win[pix[j]], ((flat0 + j) << 32) | c);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVoxelsPerThread; ++j)
          if (pix[j] >= 0) atomicMin(&zbuf[pix[j]], (int)z_bits[j]);
      }
    }
    __syncthreads();  // the batch's lists are read (before the next one)
  }
}

int grid_cache[2] = {0, 0};

template <bool kColor>
int grid() {
  return vh::persistent_grid(splat_zbuf_kernel<kColor>, kRowThreads, 0,
                             &grid_cache[kColor ? 1 : 0]);
}

template <bool kColor>
int launch(const void* view, const void* block_key, const void* active_idx,
           const void* row_mask, const void* sdf, const void* weight,
           void* zbuf, const void* color, void* win, int n_rows, int width,
           int height, float fx, float fy, float cx, float cy,
           float depth_min, float depth_max, float voxel_size,
           int world_blocks, void* stream) {
  const int g = grid<kColor>();
  if (g <= 0) {
    const int err = (int)cudaGetLastError();
    return err != 0 ? err : (int)cudaErrorInvalidConfiguration;
  }
  if (n_rows > 0) {
    const vh::SplatCamera cam{width, height, fx, fy, cx, cy, depth_min,
                              depth_max};
    splat_zbuf_kernel<kColor><<<g, kRowThreads, 0, (cudaStream_t)stream>>>(
        (const float*)view, (const int*)block_key, (const int*)active_idx,
        (const uint8_t*)row_mask, (const uint16_t*)sdf,
        (const uint16_t*)weight, (int*)zbuf, (const int*)color,
        (unsigned long long*)win, n_rows, cam, voxel_size, world_blocks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The persistent grids the two passes launch with (0 if not found).
extern "C" int vh_splat_zbuf_grid() { return grid<false>(); }
extern "C" int vh_splat_color_grid() { return grid<true>(); }

// Kernel B: zbuf (int32 bits, filled with +inf by the caller) takes the
// min z_surf bits of the surface-band voxels of the rows active_idx[k]
// where row_mask[k], k < n_rows.
extern "C" int vh_splat_zbuf(const void* view, const void* block_key,
                             const void* active_idx, const void* row_mask,
                             const void* sdf, const void* weight, void* zbuf,
                             int n_rows, int width, int height,
                             float fx, float fy, float cx, float cy,
                             float depth_min, float depth_max,
                             float voxel_size, int world_blocks,
                             void* stream) {
  return launch<false>(view, block_key, active_idx, row_mask, sdf, weight,
                       zbuf, nullptr, nullptr, n_rows, width, height, fx, fy,
                       cx, cy, depth_min, depth_max, voxel_size,
                       world_blocks, stream);
}

// The color pass over the same rows, after kernel B has finished zbuf:
// win (uint64 per pixel, zeroed by the caller) takes the max of
// (flat index << 32 | color) over the hits at each pixel.
extern "C" int vh_splat_color(const void* view, const void* block_key,
                              const void* active_idx, const void* row_mask,
                              const void* sdf, const void* weight,
                              const void* color, const void* zbuf, void* win,
                              int n_rows, int width, int height,
                              float fx, float fy, float cx, float cy,
                              float depth_min, float depth_max,
                              float voxel_size, int world_blocks,
                              void* stream) {
  return launch<true>(view, block_key, active_idx, row_mask, sdf, weight,
                      const_cast<void*>(zbuf), color, win, n_rows, width,
                      height, fx, fy, cx, cy, depth_min, depth_max,
                      voxel_size, world_blocks, stream);
}
