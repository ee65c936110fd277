// Kernel B: splat z-buffer, and its color walk and resolve, hand-written
// for Hopper (sm_90a).
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
// A color render (vh_splat_zbuf_color) runs B's walk once under the
// template flag kColor instead of B. The JAX package has no TPU kernel for
// it: on the TPU the color render stays XLA
// (voxelhashing_tpu/raycast.py:437-441, a zbuf-equality gather and a color
// scatter). At each pixel the voxels whose z_surf equals the finished
// z-buffer are the hits, and of those the one with the largest flat index
// (active-list position * 512 + voxel) gives the color. Both are one
// unsigned 64-bit min: of the key (z_surf bits << 32) | (0xFFFFFFFF - flat)
// the high word orders by depth (the invariant above) and the low word, at
// equal depth, by the flat index, largest first. So each surviving voxel
// issues one 64-bit atomicMin into a key buffer that starts at
// (+inf << 32 | 0xFFFFFFFF), and splat_resolve_kernel, one thread per
// pixel, writes the z-buffer (the high word) and the winner's color
// (0 where no voxel hit). Its plain versions are
// splat_zbuf.splat_keys_plain and splat_resolve_plain (scatter_reduce_
// amin of the same keys), and together splat_zbuf_plain(with_color=True).
//
// What bounds B and the color walk: the bytes of the surface rows (bf16 sdf
// and weight, 2 KB of 512 voxels each, read straight from the pool through
// active_idx) and the 300 KB z-buffer (600 KB of keys), which stays in L2;
// the resolve adds one 4-byte color read per covered pixel.
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
//   (vh::splat_targets_x4).
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

// The color walk's key buffer before any voxel: +inf, no flat index.
constexpr unsigned long long kNoHit = 0x7F800000FFFFFFFFull;

// kColor false: kernel B, atomicMin of z_surf bits into zbuf. kColor true:
// the color walk, atomicMin of (z_surf bits << 32 | 0xFFFFFFFF - flat)
// into keys.
template <bool kColor>
__global__ void __launch_bounds__(kRowThreads)
splat_zbuf_kernel(const float* __restrict__ view_g,
                  const int* __restrict__ block_key,
                  const int* __restrict__ active_idx,
                  const uint8_t* __restrict__ row_mask,
                  const uint16_t* __restrict__ sdf,
                  const uint16_t* __restrict__ weight,
                  int* __restrict__ zbuf,
                  unsigned long long* __restrict__ keys, int n_rows,
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
        // flat < 2^32 (the wrapper checks max_rows * 512)
        const unsigned flat0 =
            (unsigned)s_rows[k] * kVoxelsPerBlock + 4 * tid;
#pragma unroll
        for (int j = 0; j < kVoxelsPerThread; ++j) {
          if (pix[j] >= 0) {
            atomicMin(&keys[pix[j]],
                      ((unsigned long long)z_bits[j] << 32) |
                          (0xFFFFFFFFu - (flat0 + j)));
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

// One thread per pixel: the z-buffer is the key's high word and the color
// that of the voxel with flat index 0xFFFFFFFF - low word (0 where no voxel
// hit).
__global__ void __launch_bounds__(256)
splat_resolve_kernel(const unsigned long long* __restrict__ keys,
                     const int* __restrict__ active_idx,
                     const int* __restrict__ color, int* __restrict__ zbuf,
                     int* __restrict__ colbuf, int n_pixels) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pixels) return;
  const unsigned long long key = keys[p];
  zbuf[p] = (int)(key >> 32);
  int c = 0;
  if (key != kNoHit) {
    const unsigned flat = 0xFFFFFFFFu - (unsigned)key;
    c = color[(size_t)active_idx[flat / kVoxelsPerBlock] * kVoxelsPerBlock +
              flat % kVoxelsPerBlock];
  }
  colbuf[p] = c;
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
           void* zbuf, void* keys, int n_rows, int width, int height,
           float fx, float fy, float cx, float cy, float depth_min,
           float depth_max, float voxel_size, int world_blocks,
           void* stream) {
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
        (const uint16_t*)weight, (int*)zbuf, (unsigned long long*)keys,
        n_rows, cam, voxel_size, world_blocks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The persistent grids of kernel B and of the color walk (0 if not found).
extern "C" int vh_splat_zbuf_grid() { return grid<false>(); }
extern "C" int vh_splat_zbuf_color_grid() { return grid<true>(); }

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
                       zbuf, nullptr, n_rows, width, height, fx, fy, cx, cy,
                       depth_min, depth_max, voxel_size, world_blocks,
                       stream);
}

// A color render of the same rows: the color walk into keys (uint64 per
// pixel, filled with kNoHit by the caller; n_rows * 512 <= 2^32), then the
// resolve into zbuf (int32 float bits) and colbuf (int32 packed color).
extern "C" int vh_splat_zbuf_color(const void* view, const void* block_key,
                                   const void* active_idx,
                                   const void* row_mask, const void* sdf,
                                   const void* weight, const void* color,
                                   void* keys, void* zbuf, void* colbuf,
                                   int n_rows, int width, int height,
                                   float fx, float fy, float cx, float cy,
                                   float depth_min, float depth_max,
                                   float voxel_size, int world_blocks,
                                   void* stream) {
  const int err = launch<true>(view, block_key, active_idx, row_mask, sdf,
                               weight, nullptr, keys, n_rows, width, height,
                               fx, fy, cx, cy, depth_min, depth_max,
                               voxel_size, world_blocks, stream);
  if (err != 0) return err;
  const int n_pixels = width * height;
  if (n_pixels > 0) {
    splat_resolve_kernel<<<(n_pixels + 255) / 256, 256, 0,
                           (cudaStream_t)stream>>>(
        (const unsigned long long*)keys, (const int*)active_idx,
        (const int*)color, (int*)zbuf, (int*)colbuf, n_pixels);
  }
  return (int)cudaGetLastError();
}
