// The map's hash delete, hand-written for Hopper (sm_90a), in two entries
// of one kernel template:
//
// * hash_delete_kernel<true>, GC's whole free pass (integrate.
//   garbage_collect on the card): the cull flags from the GC stats, their
//   prefix rank and the gc_delete_cap cut, then the delete of the kept
//   rows, all in one launch an integrated frame, in place of the ~17 plain
//   launches that built the capped short list and the delete after them;
// * hash_delete_kernel<false>, one launch of blockmap.delete_blocks on a
//   list (streaming's stream-outs), in place of ~65 small torch launches a
//   probe round and the pushes, clears and counts after them.
//
// No TPU kernel: the JAX package runs both as XLA
// (voxelhashing_tpu/integrate.py:532 garbage_collect,
// voxelhashing_tpu/blockmap.py:564 delete_blocks). Their plain PyTorch
// versions (integrate.garbage_collect_plain, blockmap.delete_blocks_plain)
// are those functions op for op.
//
// A row is freed where it is kept and allocated: <false> keeps the list
// entries whose mask is set, <true> the active rows whose cull flag is set
// (mask & (min |sdf| >= t | max weight == 0), t the f32 value torch
// compares with) and whose cull rank is below dcap. For each freed row one
// thread tombstones the key's table slot (probe rounds until the key; the
// probes read the table as the call found it, since a slot that holds one
// entry's key is never another's), clears the row's pool key and surface
// flag, and the CTA zeroes the freed rows' sdf, weight and color in place
// (4 KB a row, one 16-byte store a thread a row). The freed rows go onto
// the free stack at n_free + their rank among the freed rows, in list
// order. The table, pool keys, surface flags and free stack are the
// wrapper's clones of the state's (ops/hash_table.py), so every read of
// the state sees it as the call found it.
//
// <false>: a CTA of 256 threads owns 8 list entries; the CTA that arrives
// last on a counter pushes the freed rows (a block scan over ballots) and
// writes n_free and n_tombstones.
//
// <true>: a CTA of 1,024 threads owns 1,024 active rows, one a thread (32
// CTAs at a 32,768-row list; 256- and 512-row CTAs ran slower, PERF.md),
// and takes its place in the list from a ticket counter, so that every
// CTA before it has been dispatched. It flags its rows with coalesced
// loads (the mask, the two stats and the index: 13 B a row, the pool key
// only for a culled row; the stats read in place, kernel A's [n, 2] pair
// by its stride), counts its culled and freed rows in one block scan, and
// finds the counts before it by a decoupled look-back over per-CTA status
// words (its count published first, its prefix once known; warp 0 reads
// 32 predecessors at a time). No grid barrier and no cooperative launch:
// two processes may share the card. A CTA whose culled count before it
// is below dcap keeps its culled rows of rank < dcap; every culled row
// before it is then kept, so the freed count before it is its free-stack
// offset: it pushes, tombstones and clears its own rows and lists them at
// that offset in a persistent dcap-entry list. The CTA that holds the cut
// (or the last, when fewer than dcap rows are culled) writes the
// counters. Culled rows are spatial neighbours and sit together in the
// pool-ordered list, so one CTA may own most of a frame's freed rows:
// their zeroing (4 KB a row) is spread over the owner and the kSpread - 1
// CTAs after it, each of which reads the owners' listed rows once their
// done words say so (a CTA waits only on CTAs before it). The CTA that
// arrives last on the ticket counter's upper half resets the ticket, the
// status and done words for the next launch (they persist per device and
// map, ops/hash_table.reserve).
//
// Bound: bytes when many rows are freed (4 KB of zeroed rows each); at
// GC's usual tens of culled rows, latency: the ticket, the flags' and
// keys' loads, the look-back's round trips, the probe chains and the
// listed rows' reads (PERF.md: 0.008 ms at phase 1's 68 freed rows, 0.006
// with no row zeroed).

#include "common.cuh"
#include "hash.cuh"

namespace {

using vh::kInvalidKey;
using vh::kTombstone;

constexpr int kThreads = 256;          // <false>: a CTA
constexpr int kGcThreads = 1024;       // <true>: a CTA, one active row each
constexpr int kEntries = 8;            // <false>: list entries a CTA
constexpr int kChunks = 32;            // its last CTA's scan: 8,192 at a time
constexpr int kSdfWords = 64;          // 16-byte words of a bf16 row
constexpr int kColorWords = 128;       // of an int32 row
constexpr int kRowWords = 2 * kSdfWords + kColorWords;
static_assert(kThreads == kRowWords, "<false>: a thread a 16-byte word");
constexpr int kSpread = 4;             // <true>: CTAs zeroing a CTA's rows
// <true>: a status word, (flag << 62) | (culled << 31) | freed
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kCount = (1ull << 31) - 1;

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
  unsigned* counter;                   // <false>: 0 between launches
  // <true> only
  const float* min_sdf;                // [n], sdf_stride apart
  const float* max_w;                  // [n], w_stride apart
  int sdf_stride, w_stride;            // kernel A's stats: columns of [n, 2]
  float threshold;
  int dcap;
  unsigned long long* ticket;          // 0 between launches
  unsigned long long* status;          // [grid], 0 between launches
  unsigned long long* done;            // [grid], 0 between launches
  int* rows;                           // [dcap], the kept freed rows
};

// The pool row of entry e's index if it is allocated, else -1 (out of the
// pool, or already free).
__device__ __forceinline__ int allocated_row(const DeleteArgs& a, int p) {
  if (p < 0 || p >= a.n_pool) return -1;
  return a.block_key_in[p] != kInvalidKey ? p : -1;
}

// The pool row entry e frees in a list delete, or -1 (past the list,
// masked out, out of the pool, or already free).
__device__ __forceinline__ int freed_row(const DeleteArgs& a, int e) {
  if (e >= a.n || !a.mask[e]) return -1;
  return allocated_row(a, a.idx[e]);
}

// The table slot holding pool row p's key (probe rounds until the key), or
// -1 past max_probes.
__device__ __forceinline__ int key_slot(const DeleteArgs& a, int p) {
  const int key = a.block_key_in[p];
  const vh::Hashes h = vh::hashes_of(key);
  for (int r = 0; r < a.max_probes; ++r) {
    const int s = vh::slot_of(h, r, a.table_mask);
    if (a.table_key_in[s] == key) return s;
  }
  return -1;
}

// Tombstone pool row p's slot (found by key_slot) and clear its key and
// surface flag.
__device__ __forceinline__ void free_row(const DeleteArgs& a, int p,
                                         int slot) {
  if (slot >= 0) a.table_key[slot] = kTombstone;
  a.block_key[p] = kInvalidKey;
  a.surf[p] = false;
}

// Zero 16-byte word w (of kRowWords) of pool row p's sdf, weight and
// color.
__device__ __forceinline__ void zero_word(const DeleteArgs& a, long long p,
                                          int w) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (w < kSdfWords)
    a.sdf[p * kSdfWords + w] = zero;
  else if (w < 2 * kSdfWords)
    a.weight[p * kSdfWords + w - kSdfWords] = zero;
  else
    a.color[p * kColorWords + w - 2 * kSdfWords] = zero;
}


__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}
__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long w) {
  *(volatile unsigned long long*)p = w;
}

// The list entry: 8 entries a CTA, the last CTA's ordered pushes.
__device__ void delete_list(const DeleteArgs& a) {
  __shared__ int s_row[kEntries];
  __shared__ int s_off[kChunks * (kThreads / 32)];
  __shared__ int s_total;
  const int tid = threadIdx.x;

  if (tid < kEntries) {
    const int p = freed_row(a, blockIdx.x * kEntries + tid);
    s_row[tid] = p;
    if (p >= 0) free_row(a, p, key_slot(a, p));
  }
  __syncthreads();
  // the CTA's kThreads = kRowWords threads zero each freed row
#pragma unroll
  for (int k = 0; k < kEntries; ++k)
    if (s_row[k] >= 0) zero_word(a, s_row[k], tid);
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

// GC's free pass: kGcThreads active rows a CTA in ticket order, the
// decoupled look-back, each CTA's own pushes and rows.
__device__ void delete_gc(const DeleteArgs& a) {
  __shared__ int s_b;
  __shared__ int s_warp[32];
  __shared__ int s_total;
  __shared__ unsigned long long s_before;  // (culled << 31) | freed
  __shared__ int s_row[kGcThreads];
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) s_b = (int)(atomicAdd(a.ticket, 1ull) & 0xffffffffull);
  __syncthreads();
  const int b = s_b;
  const int i = b * kGcThreads + tid;
  bool cull = false;
  int p = -1;
  if (i < a.n) {
    const bool m = a.mask[i];
    const float ms = a.min_sdf[(long long)i * a.sdf_stride];
    const float mw = a.max_w[(long long)i * a.w_stride];
    const int pi = a.idx[i];
    cull = m && (ms >= a.threshold || mw == 0.0f);
    if (cull) p = allocated_row(a, pi);
  }
  const bool freed = p >= 0;
  // culled in the low half, freed in the high half (at most kGcThreads
  // each)
  const int packed = (int)cull | ((int)freed << 16);
  const int before = vh::block_exclusive<kGcThreads>(packed, s_warp,
                                                     &s_total);
  const int total = s_total;
  const unsigned long long mine =
      ((unsigned long long)(total & 0xffff) << 31) |
      (unsigned long long)(total >> 16);

  if (b == 0) {
    if (tid == 0) {
      store_status(a.status, kPrefix | mine);
      s_before = 0;
    }
  } else if (warp == 0) {
    if (lane == 0) store_status(a.status + b, kAggregate | mine);
    // look back 32 CTAs at a time until a published prefix
    unsigned long long sum = 0;
    for (int j = b - 1;; j -= 32) {
      const int k = j - lane;
      unsigned long long w;
      do {
        w = k >= 0 ? load_status(a.status + k) : kPrefix;
      } while (__any_sync(0xffffffffu, (w >> 62) == 0));
      const unsigned pre = __ballot_sync(0xffffffffu, (w >> 62) == 2);
      const int stop = pre ? __ffs(pre) - 1 : 31;
      const unsigned long long v = lane <= stop ? (w & ~(3ull << 62)) : 0;
      // the two 31-bit counts add without carrying into each other
      unsigned long long s = v;
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, d);
      sum += s;
      if (pre) break;
    }
    if (lane == 0) {
      store_status(a.status + b, kPrefix | (sum + mine));
      s_before = sum;
    }
  }
  // every freed row's slot, while warp 0 looks back
  const int slot = freed ? key_slot(a, p) : -1;
  s_row[tid] = -1;
  __syncthreads();
  const int c_before = (int)((s_before >> 31) & kCount);
  const int f_before = (int)(s_before & kCount);
  const int c_total = total & 0xffff;
  const int G = (int)gridDim.x;
  const bool below = c_before < a.dcap;
  int n_kept = 0;
  if (below) {
    // culled rows of rank < dcap are kept: a freed one goes to the stack
    // at n_free + the freed rows before it (all kept), and to the list of
    // kept rows at the same place
    const int rank = c_before + (before & 0xffff);
    const bool kept = freed && rank < a.dcap;
    const int f_rank = before >> 16;
    if (kept) {
      free_row(a, p, slot);
      s_row[f_rank] = p;
      a.rows[f_before + f_rank] = p;
      const int pos = *a.n_free_in + f_before + f_rank;
      if (pos >= 0 && pos < a.n_pool) a.free_stack[pos] = p;
      __threadfence();     // the listed row before the CTA's done word
    }
    // the kept freed rows are a prefix of the CTA's freed rows
    n_kept = total >> 16;
    if (c_before + c_total > a.dcap)
      n_kept = __syncthreads_count(kept);
  }
  __syncthreads();
  // the CTA that holds the cut (or the last) writes the counters; every
  // CTA publishes that its kept rows are listed, with their count and
  // place in the list
  if (tid == 0) {
    if (below && (c_before + c_total >= a.dcap || b == G - 1)) {
      *a.n_free_out = *a.n_free_in + f_before + n_kept;
      *a.n_tomb_out = *a.n_tomb_in + f_before + n_kept;
    }
    __threadfence();
    store_status(a.done + b, 1ull | ((unsigned long long)n_kept << 1) |
                                 ((unsigned long long)f_before << 17));
  }
  // the zeroing, spread: CTA j's kept row t is zeroed by CTA j + t % S_j,
  // S_j = min(kSpread, G - j), the owner and the CTAs after it, each of
  // which waits only on the CTAs before it. This CTA zeroes its own rows
  // t % S == 0, and the rows of the kSpread - 1 CTAs before it that fall
  // to it, once they have listed them.
  __shared__ int s_first[kSpread], s_step[kSpread], s_count[kSpread];
  if (warp == 0 && lane < kSpread) {
    const int j = b - lane;
    int first = 0, step = 1, count = 0;
    if (j >= 0) {
      step = min(kSpread, G - j);
      if (lane == 0) {
        count = n_kept;
        first = -1;                        // from s_row
      } else if (lane < step) {
        unsigned long long w;
        do {
          w = load_status(a.done + j);
        } while (w == 0);
        count = (int)((w >> 1) & 0xffff);
        first = (int)(w >> 17);
      }
    }
    s_first[lane] = first;
    s_step[lane] = step;
    s_count[lane] = j >= 0 && lane < step ? count : 0;
  }
  __threadfence();
  __syncthreads();
  for (int h = 0; h < kSpread; ++h) {
    const int step = s_step[h];
    for (int t = h + step * (tid / kRowWords); t < s_count[h];
         t += step * (kGcThreads / kRowWords))
      zero_word(a, h == 0 ? s_row[t] : __ldcg(a.rows + s_first[h] + t),
                tid % kRowWords);
  }
  // the last CTA to arrive resets the ticket and the status words
  __syncthreads();
  if (tid == 0)
    s_last = (atomicAdd(a.ticket, 1ull << 32) >> 32) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  for (int k = tid; k < G; k += kGcThreads) a.status[k] = a.done[k] = 0ull;
  if (tid == 0) *a.ticket = 0ull;
}

template <bool kGc>
__global__ void __launch_bounds__(kGc ? kGcThreads : kThreads)
    hash_delete_kernel(DeleteArgs a) {
  if constexpr (kGc)
    delete_gc(a);
  else
    delete_list(a);
}

DeleteArgs make_args(const void* idx, const void* mask, int n,
                     const void* block_key_in, const void* table_key_in,
                     void* table_key, void* block_key, void* surf,
                     void* free_stack, void* sdf, void* weight, void* color,
                     const void* n_free_in, const void* n_tomb_in,
                     void* n_free_out, void* n_tomb_out, int n_pool,
                     int table_size, int max_probes) {
  DeleteArgs a = {};
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
  return a;
}

bool bad_sizes(int n, int n_pool, int table_size) {
  return n < 1 || n_pool < 1 || table_size < 1 ||
         (table_size & (table_size - 1)) != 0;
}

}  // namespace

// The CTAs an SM of the list entry (the occupancy queries load both
// entries' modules, so that no first use falls inside a CUDA graph
// capture). -1 on an error.
extern "C" int vh_hash_delete_grid() {
  int per_sm = 0, gc = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, hash_delete_kernel<false>, kThreads, 0) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &gc, hash_delete_kernel<true>, kGcThreads, 0) != cudaSuccess)
    return -1;
  return per_sm;
}

// One list delete on the arrays the wrapper cloned (ops/hash_table.py
// checks every shape and the pools' 16-byte alignment, makes the outputs
// and keeps the counter between launches).
extern "C" int vh_hash_delete(
    const void* idx, const void* mask, int n, const void* block_key_in,
    const void* table_key_in, void* table_key, void* block_key, void* surf,
    void* free_stack, void* sdf, void* weight, void* color,
    const void* n_free_in, const void* n_tomb_in, void* n_free_out,
    void* n_tomb_out, int n_pool, int table_size, int max_probes,
    void* counter, void* stream) {
  if (bad_sizes(n, n_pool, table_size)) return (int)cudaErrorInvalidValue;
  DeleteArgs a = make_args(idx, mask, n, block_key_in, table_key_in,
                           table_key, block_key, surf, free_stack, sdf,
                           weight, color, n_free_in, n_tomb_in, n_free_out,
                           n_tomb_out, n_pool, table_size, max_probes);
  a.counter = (unsigned*)counter;
  hash_delete_kernel<false><<<(n + kEntries - 1) / kEntries, kThreads, 0,
                              (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// GC's free pass over the active list (n rows) on the arrays the wrapper
// cloned; `status` holds 2 max_ctas words and `rows` dcap ints (the
// wrapper's reservation).
extern "C" int vh_hash_gc(
    const void* idx, const void* mask, const void* min_sdf,
    const void* max_w, int sdf_stride, int w_stride, int n, float threshold,
    int dcap,
    const void* block_key_in, const void* table_key_in, void* table_key,
    void* block_key, void* surf, void* free_stack, void* sdf, void* weight,
    void* color, const void* n_free_in, const void* n_tomb_in,
    void* n_free_out, void* n_tomb_out, int n_pool, int table_size,
    int max_probes, void* ticket, void* status, int max_ctas, void* rows,
    void* stream) {
  const int grid = (n + kGcThreads - 1) / kGcThreads;
  if (bad_sizes(n, n_pool, table_size) || dcap < 1 || grid > max_ctas ||
      sdf_stride < 1 || w_stride < 1)
    return (int)cudaErrorInvalidValue;
  DeleteArgs a = make_args(idx, mask, n, block_key_in, table_key_in,
                           table_key, block_key, surf, free_stack, sdf,
                           weight, color, n_free_in, n_tomb_in, n_free_out,
                           n_tomb_out, n_pool, table_size, max_probes);
  a.min_sdf = (const float*)min_sdf;
  a.max_w = (const float*)max_w;
  a.sdf_stride = sdf_stride;
  a.w_stride = w_stride;
  a.threshold = threshold;
  a.dcap = dcap;
  a.ticket = (unsigned long long*)ticket;
  a.status = (unsigned long long*)status;
  a.done = a.status + max_ctas;
  a.rows = (int*)rows;
  hash_delete_kernel<true><<<grid, kGcThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
