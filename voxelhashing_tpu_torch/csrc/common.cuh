// Shared device helpers of the port's kernels.
//
// Every float expression here is written in the operation order of the
// plain PyTorch versions (geometry.voxel_camera_positions, which both
// integrate.integrate and splat_zbuf.splat_zbuf_plain use) and the
// libraries are compiled with -fmad=false, so a kernel rounds exactly like
// its plain version and the two can be compared bit for bit on the card.
//
// Each source that includes this header is built into a library of its own
// (ops/_build.py), so the extern "C" function below is defined once per
// library.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vh {

constexpr int kBlockSide = 8;
constexpr int kVoxelsPerBlock = 512;

// Both kernels work on one pool row at a time with 128 threads, four
// x-consecutive voxels per thread (8-byte sdf and weight vectors, 16-byte
// color vectors), and keep a ring of two rows in shared memory.
constexpr int kRowThreads = 128;
constexpr int kVoxelsPerThread = kVoxelsPerBlock / kRowThreads;
constexpr int kStages = 2;

// The voxel-unit corner of the block with key `key`: its block coordinates
// unpacked (x fastest, world_blocks per axis, centred) times 8.
__device__ __forceinline__ int3 block_corner(int key, int world_blocks) {
  const int half = world_blocks / 2;
  return make_int3((key % world_blocks - half) * kBlockSide,
                   ((key / world_blocks) % world_blocks - half) * kBlockSide,
                   (key / (world_blocks * world_blocks) - half) * kBlockSide);
}

// Camera-space positions of the four x-consecutive voxels of thread `tid`
// (voxels 4 * tid + j, x fastest) of the block with voxel-unit corner `c`:
// world = (corner + local offset) * voxel_size, then the row-major 4x4 view
// matrix (its first three rows, in registers) in the operation order of
// geometry.voxel_camera_positions, ((a + b) + c) + t. The y and z products
// are the same for the four voxels and computed once.
__device__ __forceinline__ void camera_x4(const float (&view)[12], int3 c,
                                          int tid, float voxel_size,
                                          float (&px)[4], float (&py)[4],
                                          float (&pz)[4]) {
  const int x0 = (4 * tid) & 7;
  const float wy = (float)(c.y + ((tid >> 1) & 7)) * voxel_size;
  const float wz = (float)(c.z + (tid >> 4)) * voxel_size;
  const float xy = view[1] * wy, xz = view[2] * wz;
  const float yy = view[5] * wy, yz = view[6] * wz;
  const float zy = view[9] * wy, zz = view[10] * wz;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float wx = (float)(c.x + x0 + j) * voxel_size;
    px[j] = view[0] * wx + xy + xz + view[3];
    py[j] = view[4] * wx + yy + yz + view[7];
    pz[j] = view[8] * wx + zy + zz + view[11];
  }
}

// Where the four voxels of thread `tid` land in the z-buffer: each voxel's
// camera position (camera_x4), its predicted surface depth z_surf = pz + sdf
// (as int bits, positive when kept) and its pixel, -1 where the voxel is
// dropped (not in the surface band `band`, behind the camera, off screen
// or outside [depth_min, depth_max]). The operation order of
// splat_zbuf.splat_targets; kernel B and the color walk both call this,
// so a color render's z-buffer is kernel B's.
struct SplatCamera {
  int width, height;
  float fx, fy, cx, cy, depth_min, depth_max;
};

__device__ __forceinline__ void splat_targets_x4(
    const float (&view)[12], int3 corner, int tid, float voxel_size,
    const SplatCamera& cam, const float (&sd)[4], const bool (&band)[4],
    int (&pix)[4], unsigned (&z_bits)[4]) {
  float px[4], py[4], pz[4];
  camera_x4(view, corner, tid, voxel_size, px, py, pz);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float z_surf = pz[j] + sd[j];
    const float safe_z = (pz[j] == 0.0f) ? 1e-12f : pz[j];
    const int ui = (int)floorf(px[j] * cam.fx / safe_z + cam.cx + 0.5f);
    const int vi = (int)floorf(py[j] * cam.fy / safe_z + cam.cy + 0.5f);
    const bool ok = band[j] && pz[j] > 0.0f && ui >= 0 && ui < cam.width &&
                    vi >= 0 && vi < cam.height && z_surf > cam.depth_min &&
                    z_surf < cam.depth_max;
    pix[j] = ok ? vi * cam.width + ui : -1;
    z_bits[j] = (unsigned)__float_as_int(z_surf);
  }
}

// bf16 bits <-> float. Widening is exact; narrowing rounds to nearest even,
// as PyTorch's .to(torch.bfloat16) does.
__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float((bits & 0xFFFFu) << 16);
}
__device__ __forceinline__ uint32_t float_to_bf16_bits(float f) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// Element j (0-3) of four bf16 packed in one 8-byte word, little-endian.
__device__ __forceinline__ uint32_t bf16x4_get(uint2 w, int j) {
  const uint32_t half = (j < 2) ? w.x : w.y;
  return (j & 1) ? (half >> 16) : (half & 0xFFFFu);
}

// ---------------------------------------------------------------------------
// mbarrier and 1-D bulk copies (TMA without a tensor map), sm_90.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (the copy
// engine) before the first copy completes on them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of copies to complete on `bar`.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase with parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Persistent grid: the SM count times the CTAs of `kernel` (at `threads`
// threads and `smem` dynamic shared bytes) that fit on one SM. Computed
// once per process and kernel.
template <typename Kernel>
inline int persistent_grid(Kernel kernel, int threads, size_t smem,
                           int* cache) {
  if (*cache > 0) return *cache;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess) {
    return 0;
  }
  *cache = sms * (per_sm > 0 ? per_sm : 1);
  return *cache;
}

}  // namespace vh

extern "C" const char* vh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
