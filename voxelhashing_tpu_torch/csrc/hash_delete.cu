// The map's hash delete, hand-written for Hopper (sm_90a): one launch of
// hash_delete_kernel a call of blockmap.delete_blocks (GC every frame,
// streaming's stream-out), in place of ~65 small torch launches a probe
// round and the pushes, clears and counts after them.
//
// No TPU kernel: the JAX package runs this step as XLA
// (voxelhashing_tpu/blockmap.py:564 delete_blocks). Its plain PyTorch
// version (blockmap.delete_blocks_plain) is that function op for op.
//
// A CTA of 256 threads owns 8 entries of the list: for each entry that
// frees a row (its mask set and its row allocated) one thread tombstones
// the key's table slot (probe rounds until the key; the probes read the
// table as the call found it, since a slot that holds one entry's key is
// never another's), clears the row's pool key and surface flag, and then
// the CTA zeroes the entries' sdf, weight and color rows in place (4 KB a
// row, one 16-byte store a thread a row). The CTA that arrives last on a
// counter pushes the freed rows onto the free stack at n_free + rank, in
// list order (a block scan over ballots), and writes n_free and
// n_tombstones. The table, pool keys, surface flags and free stack are the
// wrapper's clones of the state's (ops/hash_table.py), so every read of
// the state sees it as the call found it.
//
// Bound: bytes, 4 KB of zeroed rows a freed block, and, when few blocks
// are freed, the launch and the last CTA's scan.

#include "common.cuh"
#include "hash.cuh"

namespace {

using vh::kInvalidKey;
using vh::kTombstone;

constexpr int kThreads = 256;
constexpr int kEntries = 8;            // list entries a CTA
constexpr int kChunks = 32;            // the last CTA's scan: 8,192 at a time
constexpr int kSdfWords = 64;          // 16-byte words of a bf16 row
constexpr int kColorWords = 128;       // of an int32 row

struct DeleteArgs {
  const int* idx;                      // [n] pool rows
  const bool* mask;                    // [n]
  int n;
  const int* block_key_in;             // the state's, read only
  const int* table_key_in;
  int* table_key;                      // the clones, written
  int* block_key;
  bool* surf;
  int* free_stack;
  uint4* sdf;                          // [n_pool, 512] bf16, in place
  uint4* weight;
  uint4* color;                        // [n_pool, 512] int32, in place
  const int* n_free_in;
  const int* n_tomb_in;
  int* n_free_out;
  int* n_tomb_out;
  int n_pool;
  uint32_t table_mask;
  int max_probes;
  unsigned* counter;                   // 0 between launches
};

// The pool row entry e frees, or -1 (past the list, masked out, out of the
// pool, or already free).
__device__ __forceinline__ int freed_row(const DeleteArgs& a, int e) {
  if (e >= a.n || !a.mask[e]) return -1;
  const int p = a.idx[e];
  if (p < 0 || p >= a.n_pool) return -1;
  return a.block_key_in[p] != kInvalidKey ? p : -1;
}

__global__ void __launch_bounds__(kThreads) hash_delete_kernel(DeleteArgs a) {
  __shared__ int s_row[kEntries];
  __shared__ int s_off[kChunks * (kThreads / 32)];
  __shared__ int s_total;
  const int tid = threadIdx.x;

  if (tid < kEntries) {
    const int p = freed_row(a, blockIdx.x * kEntries + tid);
    s_row[tid] = p;
    if (p >= 0) {
      const int key = a.block_key_in[p];
      const vh::Hashes h = vh::hashes_of(key);
      for (int r = 0; r < a.max_probes; ++r) {
        const int s = vh::slot_of(h, r, a.table_mask);
        if (a.table_key_in[s] == key) {
          a.table_key[s] = kTombstone;
          break;
        }
      }
      a.block_key[p] = kInvalidKey;
      a.surf[p] = false;
    }
  }
  __syncthreads();
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int k = 0; k < kEntries; ++k) {
    const long long p = s_row[k];
    if (p < 0) continue;
    if (tid < kSdfWords)
      a.sdf[p * kSdfWords + tid] = zero;
    else if (tid < 2 * kSdfWords)
      a.weight[p * kSdfWords + tid - kSdfWords] = zero;
    else
      a.color[p * kColorWords + tid - 2 * kSdfWords] = zero;
  }
  if (!vh::arrived_last(a.counter)) return;

  // the last CTA: the free-stack pushes in list order, then the counters
  const int n_free = *a.n_free_in;
  int base = 0;
  for (int e0 = 0; e0 < a.n; e0 += kChunks * kThreads) {
    const int n_chunks = min(kChunks, (a.n - e0 + kThreads - 1) / kThreads);
    uint32_t bits = 0;
    for (int j = 0; j < n_chunks; ++j)
      if (freed_row(a, e0 + j * kThreads + tid) >= 0) bits |= 1u << j;
    const int total = vh::scan_chunks<kThreads>(bits, n_chunks, s_off,
                                                &s_total);
    for (int j = 0; j < n_chunks; ++j) {
      const int rank = vh::chunk_rank<kThreads>(bits, j, s_off);
      if (!((bits >> j) & 1u)) continue;
      const int pos = n_free + base + rank;
      if (pos >= 0 && pos < a.n_pool)
        a.free_stack[pos] = a.idx[e0 + j * kThreads + tid];
    }
    base += total;
    __syncthreads();       // s_off and s_total are read above
  }
  if (tid == 0) {
    *a.n_free_out = n_free + base;
    *a.n_tomb_out = *a.n_tomb_in + base;
  }
}

}  // namespace

// The CTAs an SM of the kernel (the occupancy query loads the module, so
// that no first use falls inside a CUDA graph capture). -1 on an error.
extern "C" int vh_hash_delete_grid() {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, hash_delete_kernel, kThreads, 0) != cudaSuccess)
    return -1;
  return per_sm;
}

// One delete on the arrays the wrapper cloned (ops/hash_table.py checks
// every shape and the pools' 16-byte alignment, makes the outputs and
// keeps the counter between launches).
extern "C" int vh_hash_delete(
    const void* idx, const void* mask, int n, const void* block_key_in,
    const void* table_key_in, void* table_key, void* block_key, void* surf,
    void* free_stack, void* sdf, void* weight, void* color,
    const void* n_free_in, const void* n_tomb_in, void* n_free_out,
    void* n_tomb_out, int n_pool, int table_size, int max_probes,
    void* counter, void* stream) {
  if (n < 1 || n_pool < 1 || table_size < 1 ||
      (table_size & (table_size - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  DeleteArgs a;
  a.idx = (const int*)idx;
  a.mask = (const bool*)mask;
  a.n = n;
  a.block_key_in = (const int*)block_key_in;
  a.table_key_in = (const int*)table_key_in;
  a.table_key = (int*)table_key;
  a.block_key = (int*)block_key;
  a.surf = (bool*)surf;
  a.free_stack = (int*)free_stack;
  a.sdf = (uint4*)sdf;
  a.weight = (uint4*)weight;
  a.color = (uint4*)color;
  a.n_free_in = (const int*)n_free_in;
  a.n_tomb_in = (const int*)n_tomb_in;
  a.n_free_out = (int*)n_free_out;
  a.n_tomb_out = (int*)n_tomb_out;
  a.n_pool = n_pool;
  a.table_mask = (uint32_t)(table_size - 1);
  a.max_probes = max_probes;
  a.counter = (unsigned*)counter;
  hash_delete_kernel<<<(n + kEntries - 1) / kEntries, kThreads, 0,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
