// Streaming's device half, hand-written for Hopper (sm_90a): the sweep of
// one pool part and the copy of the rows it picks (two launches of the
// streaming manager's captured stream-out, streaming.AsyncStreamingManager
// on the card), and a stream-in's bitmask sets and clears (one launch).
// They stand in for ~25 torch launches of streaming.select_stream_out,
// extract_blocks and bitmask_delta a frame: the cast of the whole transfer
// cap to f32, a sort, and two 16.9 MB bitmask temporaries.
//
// No TPU kernel: the JAX package runs them as XLA
// (voxelhashing_tpu/streaming.py:76 select_stream_out, :118
// extract_blocks). Their plain versions are streaming.select_stream_out,
// extract_blocks and bitmask_delta, which the CPU path runs.
//
// stream_sweep_kernel: one CTA of 1,024 threads. Part `part` holds the
// rows part, part + parts, ... (10,000 at an 800,000-block pool and 80
// parts). A row is picked where it is allocated and its block's centre is
// at least `radius` from the camera, in the float operations of
// select_stream_out (centre = f32(block * 8) * voxel + half_block, then
// diff, squares, ((x + y) + z), sqrt; -fmad=false). The picked rows are
// ranked in row order by a block scan over up to 32 chunks of 1,024 rows
// at a time (hash.cuh's scan_chunks, as the list delete pushes), and those
// of rank below `cap` listed: idx[rank] = row, keys[rank] = its key, their
// chunks' bitmask bits set by atomicOr (an OR of bits needs no dedup).
// Past the count the list holds row 0 and INVALID_KEY, and mask[i] is
// i < count, as select_stream_out leaves them; the count goes to the card
// and to host memory. The camera is read from mapped host memory (written
// by the host before the graph's replay), and the part from a counter on
// the card that the kernel advances, so a replay takes no argument from
// the host.
//
// stream_extract_kernel: a persistent grid; a CTA of 256 threads copies
// one listed row at a time (sdf and weight bf16, color int32: 4 KB, one
// 16-byte word a thread) into the ring slot, in the pool's dtypes; the
// rows past the count are left as they were. The slot's keys and rows
// lie in mapped host memory: the streaming worker reads them there once
// the replay's event has passed, with no copy of its own.
//
// stream_bits_kernel: one thread an id; the first n_set ids set their
// bits, the next n_clear clear theirs (the host passes disjoint lists).
//
// Bound: the sweep reads the part's keys, one 32-byte sector each at a
// stride of `parts` ints (320 KB a sweep here): latency, one CTA's loads
// and its scans. The extract moves 8 KB a listed row (4 KB of it to the
// host over PCIe).
#include <algorithm>

#include "common.cuh"
#include "hash.cuh"

namespace {

using vh::kInvalidKey;

constexpr int kSweepThreads = 1024;
constexpr int kChunks = 32;            // rows a thread a scan, at most
constexpr int kSdfWords = 64;          // 16-byte words of a bf16 row
constexpr int kColorWords = 128;       // of an int32 row
constexpr int kRowWords = 2 * kSdfWords + kColorWords;

struct SweepArgs {
  const int* block_key;                // [n_pool]
  int n_pool;
  const float* cam;                    // [3], mapped host memory
  int* part;                           // the part counter
  int parts;
  int world_blocks, bpc, grid_dim;
  float voxel, half_block, radius;
  int cap;
  int* idx;                            // [cap]
  int* keys;                           // [cap]
  bool* mask;                          // [cap]
  int* count;                          // []
  int* count_host;                     // [], mapped host memory
  unsigned* bitmask;                   // [n_words]
};

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// The bitmask grid index of a block key's chunk (key_to_chunk_linear).
__device__ __forceinline__ int chunk_lin(const SweepArgs& a, int key) {
  const int w = a.world_blocks, half = w / 2, g = a.grid_dim;
  const int b[3] = {key % w - half, (key / w) % w - half,
                    key / (w * w) - half};
  int c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    c[i] = min(max(floor_div(b[i], a.bpc) + g / 2, 0), g - 1);
  return (c[2] * g + c[1]) * g + c[0];
}

// Is pool row `row` picked: allocated, and its centre at least `radius`
// from the camera `cam`.
__device__ __forceinline__ bool picked(const SweepArgs& a, int row,
                                       const float* cam) {
  const int key = a.block_key[row];
  if (key == kInvalidKey) return false;
  const int w = a.world_blocks, half = w / 2;
  const int b[3] = {key % w - half, (key / w) % w - half,
                    key / (w * w) - half};
  float sq[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float centre = (float)(b[i] * vh::kBlockSide) * a.voxel +
                         a.half_block;
    const float d = centre - cam[i];
    sq[i] = d * d;
  }
  return sqrtf(sq[0] + sq[1] + sq[2]) >= a.radius;
}

__global__ void __launch_bounds__(kSweepThreads)
    stream_sweep_kernel(SweepArgs a) {
  __shared__ int s_off[kChunks * (kSweepThreads / 32)];
  __shared__ int s_total;
  __shared__ int s_part;
  __shared__ float s_cam[3];
  const int tid = threadIdx.x;
  if (tid == 0) s_part = *a.part;
  if (tid < 3) s_cam[tid] = ((const volatile float*)a.cam)[tid];
  __syncthreads();
  const int part = s_part;
  if (tid == 0) *a.part = (part + 1) % a.parts;
  const int n_rows =
      part < a.n_pool ? (a.n_pool - part + a.parts - 1) / a.parts : 0;
  int base = 0;
  for (int e0 = 0; e0 < n_rows; e0 += kChunks * kSweepThreads) {
    const int n_chunks =
        min(kChunks, (n_rows - e0 + kSweepThreads - 1) / kSweepThreads);
    uint32_t bits = 0;
    for (int j = 0; j < n_chunks; ++j) {
      const int e = e0 + j * kSweepThreads + tid;
      if (e < n_rows && picked(a, part + e * a.parts, s_cam))
        bits |= 1u << j;
    }
    const int total = vh::scan_chunks<kSweepThreads>(bits, n_chunks, s_off,
                                                     &s_total);
    for (int j = 0; j < n_chunks; ++j) {
      const int rank = base + vh::chunk_rank<kSweepThreads>(bits, j, s_off);
      if (!((bits >> j) & 1u) || rank >= a.cap) continue;
      const int row = part + (e0 + j * kSweepThreads + tid) * a.parts;
      const int key = a.block_key[row];
      a.idx[rank] = row;
      a.keys[rank] = key;
      const int lin = chunk_lin(a, key);
      atomicOr(a.bitmask + (lin >> 5), 1u << (lin & 31));
    }
    base += total;
    __syncthreads();       // s_off and s_total are read above
  }
  const int count = min(base, a.cap);
  for (int i = tid; i < a.cap; i += kSweepThreads) {
    a.mask[i] = i < count;
    if (i >= count) {
      a.idx[i] = 0;
      a.keys[i] = kInvalidKey;
    }
  }
  if (tid == 0) {
    *a.count = count;
    *(volatile int*)a.count_host = count;
  }
}

struct ExtractArgs {
  const int* count;
  const int* idx;
  const uint4* sdf;                    // [n_pool, 512] bf16
  const uint4* weight;
  const uint4* color;                  // [n_pool, 512] int32
  uint4* out_sdf;                      // [cap, 512], the ring slot's
  uint4* out_weight;
  uint4* out_color;
};

__global__ void __launch_bounds__(kRowWords)
    stream_extract_kernel(ExtractArgs a) {
  const int count = *a.count;
  const int w = threadIdx.x;
  for (int r = blockIdx.x; r < count; r += gridDim.x) {
    const long long p = a.idx[r];
    if (w < kSdfWords)
      a.out_sdf[(long long)r * kSdfWords + w] = a.sdf[p * kSdfWords + w];
    else if (w < 2 * kSdfWords)
      a.out_weight[(long long)r * kSdfWords + w - kSdfWords] =
          a.weight[p * kSdfWords + w - kSdfWords];
    else
      a.out_color[(long long)r * kColorWords + w - 2 * kSdfWords] =
          a.color[p * kColorWords + w - 2 * kSdfWords];
  }
}

__global__ void stream_bits_kernel(unsigned* bitmask, const int* ids,
                                   int n_set, int n_clear) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_set + n_clear) return;
  const int id = ids[i];
  const unsigned bit = 1u << (id & 31);
  if (i < n_set)
    atomicOr(bitmask + (id >> 5), bit);
  else
    atomicAnd(bitmask + (id >> 5), ~bit);
}

int g_extract_grid = 0;

}  // namespace

// Occupancy query of the kernels: loads the module outside any capture.
extern "C" int vh_stream_sweep_grid() {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, stream_sweep_kernel, kSweepThreads, 0) != cudaSuccess)
    return -1;
  return vh::persistent_grid(stream_extract_kernel, kRowWords, 0,
                             &g_extract_grid);
}

// One sweep of the part the counter holds (the wrapper in
// ops/stream.py checks shapes and dtypes).
extern "C" int vh_stream_sweep(
    const void* block_key, int n_pool, const void* cam, void* part,
    int parts, int world_blocks, int bpc, int grid_dim, float voxel,
    float half_block, float radius, int cap, void* idx, void* keys,
    void* mask, void* count, void* count_host, void* bitmask, int n_words,
    void* stream) {
  const long long g = grid_dim;
  if (n_pool < 1 || parts < 1 || cap < 1 || bpc < 1 || grid_dim < 1 ||
      world_blocks < 2 || g * g * g > 32ll * n_words)
    return (int)cudaErrorInvalidValue;
  SweepArgs a{(const int*)block_key, n_pool, (const float*)cam, (int*)part,
              parts, world_blocks, bpc, grid_dim, voxel, half_block, radius,
              cap, (int*)idx, (int*)keys, (bool*)mask, (int*)count,
              (int*)count_host, (unsigned*)bitmask};
  stream_sweep_kernel<<<1, kSweepThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The rows the sweep listed into a ring slot (`count` of the `cap` listed).
extern "C" int vh_stream_extract(const void* count, const void* idx, int cap,
                                 const void* sdf, const void* weight,
                                 const void* color, void* out_sdf,
                                 void* out_weight, void* out_color,
                                 void* stream) {
  if (cap < 1) return (int)cudaErrorInvalidValue;
  const int grid = std::min(cap, vh::persistent_grid(stream_extract_kernel,
                                                     kRowWords, 0,
                                                     &g_extract_grid));
  ExtractArgs a{(const int*)count,    (const int*)idx,
                (const uint4*)sdf,    (const uint4*)weight,
                (const uint4*)color,  (uint4*)out_sdf,
                (uint4*)out_weight,   (uint4*)out_color};
  stream_extract_kernel<<<std::max(grid, 1), kRowWords, 0,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Set the bits of ids[0, n_set) and clear those of ids[n_set, n_set +
// n_clear) (disjoint; every id below the bitmask's 32 n_words).
extern "C" int vh_stream_bits(void* bitmask, const void* ids, int n_set,
                              int n_clear, void* stream) {
  const int n = n_set + n_clear;
  if (n_set < 0 || n_clear < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  stream_bits_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (unsigned*)bitmask, (const int*)ids, n_set, n_clear);
  return (int)cudaGetLastError();
}

// Page-locked host memory mapped into the card's address space: `out`
// receives the host pointer and the device pointer of `bytes` bytes.
extern "C" int vh_stream_host_alloc(long long bytes, void* out) {
  void* host = nullptr;
  void* dev = nullptr;
  cudaError_t e = cudaHostAlloc(&host, (size_t)bytes,
                                cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return (int)e;
  e = cudaHostGetDevicePointer(&dev, host, 0);
  if (e != cudaSuccess) {
    cudaFreeHost(host);
    return (int)e;
  }
  ((void**)out)[0] = host;
  ((void**)out)[1] = dev;
  return 0;
}

extern "C" int vh_stream_host_free(void* host) {
  return (int)cudaFreeHost(host);
}
