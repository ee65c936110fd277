// The map's hash on the card, bit for bit with blockmap._mix, _hashes,
// _slot and _probe_slot (voxelhashing_tpu/blockmap.py:137-153): a 32-bit
// murmur3-style finaliser, double hashing with an odd second hash, and a
// power-of-two table. Also the block scans the hash kernels order their
// work by (hash_alloc.cu, hash_delete.cu).
#pragma once

#include <cstdint>

namespace vh {

constexpr int kInvalidKey = 0x7FFFFFFF;   // geometry.INVALID_KEY
constexpr int kTombstone = 0x7FFFFFFE;    // blockmap.TOMBSTONE
constexpr uint32_t kMixA = 0x7FEB352Du;
constexpr uint32_t kMixB = 0x846CA68Bu;
constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kMixA;
  x ^= x >> 15;
  x *= kMixB;
  x ^= x >> 16;
  return x;
}

struct Hashes {
  uint32_t h1, h2;
};

__device__ __forceinline__ Hashes hashes_of(int key) {
  const uint32_t k = (uint32_t)key;
  return {mix32(k), mix32(k ^ kGolden) | 1u};
}

// The slot of probe round r; `mask` is the table size less one.
__device__ __forceinline__ int slot_of(Hashes h, int r, uint32_t mask) {
  return (int)((h.h1 + (uint32_t)r * h.h2) & mask);
}

__device__ __forceinline__ int warp_inclusive(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Exclusive prefix of one int a thread over the CTA, in thread order;
// `s_warp` holds 32 ints, *s_total gets the sum. Every thread calls it.
template <int kThreads>
__device__ int block_exclusive(int v, int* s_warp, int* s_total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inc = warp_inclusive(v);
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s_warp[lane] : 0;
    const int wi = warp_inclusive(w);
    if (lane < kWarps) s_warp[lane] = wi - w;
    if (lane == 31) *s_total = wi;
  }
  __syncthreads();
  const int out = s_warp[warp] + inc - v;
  __syncthreads();
  return out;
}

// A list of up to 32 chunks of kThreads entries, entry j * kThreads + t
// held by thread t, flagged where bit j of the thread's `bits` is set.
// Fills s_off[j * kWarps + warp] with the flagged entries before that
// warp's 32 entries of chunk j (list order) and returns the flagged total.
// Every thread calls it; s_off may be reused after a __syncthreads.
template <int kThreads>
__device__ int scan_chunks(uint32_t bits, int n_chunks, int* s_off,
                           int* s_total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < n_chunks; ++j) {
    const uint32_t b = __ballot_sync(0xffffffffu, (bits >> j) & 1u);
    if (lane == 0) s_off[j * kWarps + warp] = __popc(b);
  }
  __syncthreads();
  if (warp == 0) {
    const int n = n_chunks * kWarps;
    const int per = (n + 31) / 32;
    const int lo = min(n, lane * per), hi = min(n, lo + per);
    int s = 0;
    for (int k = lo; k < hi; ++k) s += s_off[k];
    int run = warp_inclusive(s) - s;
    if (lane == 31) *s_total = run + s;
    for (int k = lo; k < hi; ++k) {
      const int v = s_off[k];
      s_off[k] = run;
      run += v;
    }
  }
  __syncthreads();
  return *s_total;
}

// The flagged entries before entry j * kThreads + threadIdx.x (after
// scan_chunks); every lane of the warp calls it with the same j.
template <int kThreads>
__device__ __forceinline__ int chunk_rank(uint32_t bits, int j,
                                          const int* s_off) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t b = __ballot_sync(0xffffffffu, (bits >> j) & 1u);
  return s_off[j * (kThreads / 32) + warp] +
         __popc(b & ((1u << lane) - 1u));
}

// After every thread of the CTA made its global writes: true in the CTA
// that arrived last (which then resets the counter), false in the others.
__device__ __forceinline__ bool arrived_last(unsigned* counter) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned prev = atomicAdd(counter, 1u);
    last = prev == gridDim.x - 1;
    if (last) *counter = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

}  // namespace vh
