// The allocator's hash insert, hand-written for Hopper (sm_90a): one
// round of blockmap.allocate a launch (hash_alloc_kernel), in place of
// ~1,050 small torch launches a round (the probe gathers, the cumsum
// compactions, the scatter-mins over fresh table-sized buffers).
//
// No TPU kernel: the JAX package runs this step as XLA
// (voxelhashing_tpu/blockmap.py:187 allocate, :264 _allocate_unique, :343
// _insert_new). Its plain PyTorch version (blockmap.allocate_plain) is
// those functions op for op.
//
// A round, in the plain version's order:
// 1. every CTA of the grid (1,024 candidates a CTA) drops the keys found
//    within two probes of the table, compacts the live ones in order into
//    its segment of `seg`, writes its count, and arrives on a counter;
// 2. the CTA that arrives last runs the rest alone, on a stage list of at
//    most 16,384 entries in shared memory (16 a thread, entry j * 1024 + t
//    in thread t): the first scap live keys in stream order (a prefix over
//    the CTAs' counts, then a binary search a key); the staging dedup
//    (atomicMin of the stage index at the key's round-`round` slot; the
//    lowest index represents its key); the resident check (probes 0-1 for
//    every key, probes 2.. for the first 2,048 unresolved by rank, the
//    rest counted resident); the insert list (the first icap new keys by
//    rank); `insert_probes` contended rounds (an empty or tombstoned slot
//    goes to the lowest stage index by atomicMin; winners pop the free
//    stack by prefix rank from alloc_base while the rank is below n_free);
//    then n_free, the row watermark and the count.
// Ranks are block scans over ballots, in list order, so every pool slot
// and table slot equals the plain version's (the order is part of the
// map). Claims go to a persistent int32 claim array of the table's size,
// INT32_MAX between launches: each claimed slot is reset after it is read
// (the plain version fills a fresh table-sized buffer for every
// scatter-min). atomicMin commutes, so the winners do not depend on
// timing. Reads of what this launch writes (the table, the claims, the
// other CTAs' segments) go through L2 (__ldcg) after a barrier.
//
// Bound: latency, not bytes. A round moves ~0.3 MB at the bench point
// (its bound is ~0.1 us); the last CTA's chain of dependent global round
// trips (segments, staging claims, probes, each insert round's claims and
// pops) sets its time.

#include "common.cuh"
#include "hash.cuh"

namespace {

using vh::kInvalidKey;
using vh::kTombstone;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 16;          // stage entries a thread: scap <= 16,384
constexpr int kIntMax = 0x7FFFFFFF;

struct AllocArgs {
  const int* keys;                      // [n_keys] raw candidates
  int n_keys, n_ctas;
  int scap, rcap, icap;                 // stage, deep-probe and insert caps
  int round;                            // the staging slot's probe round
  int pre_probes;                       // min(2, max_probes)
  int max_probes, insert_probes;        // insert_probes <= max_probes
  uint32_t table_mask;                  // table_size - 1
  int n_pool;
  int* table_key;                       // [table_size], read and written
  int* table_val;                       // [table_size]
  int* block_key;                       // [n_pool]
  const int* free_stack;                // [n_pool], read only
  const int* n_free_in;                 // the state's counters (first round)
  const int* dense_upto_in;
  int* n_free_out;                      // the call's counters
  int* dense_upto_out;
  int* total_out;
  int first;                            // 1: the call's first round
  int* claim;                           // [table_size], INT32_MAX between
  int* seg;                             // [n_ctas * kThreads]
  int* seg_count;                       // [n_ctas]
  unsigned* counter;                    // 0 between launches
};

__device__ __forceinline__ int slot_at(int key, int r, uint32_t mask) {
  return vh::slot_of(vh::hashes_of(key), r, mask);
}

__global__ void __launch_bounds__(kThreads, 1)
    hash_alloc_kernel(AllocArgs a) {
  extern __shared__ int smem[];
  __shared__ int s_warp[32];
  __shared__ int s_off[kMaxChunks * kWarps];
  __shared__ int s_total;
  __shared__ int s_free, s_upto, s_count, s_max;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // -- 1. resident pre-drop over this CTA's keys (both probes issued
  // together), then an ordered compaction of the live ones
  {
    const long long i = (long long)blockIdx.x * kThreads + tid;
    const int key = i < a.n_keys ? a.keys[i] : kInvalidKey;
    bool live = false;
    if (key != kInvalidKey) {
      const vh::Hashes h = vh::hashes_of(key);
      int tk[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        tk[r] = r < a.pre_probes ? a.table_key[vh::slot_of(h, r, a.table_mask)]
                                 : kInvalidKey;
      bool term = false, found = false;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r >= a.pre_probes) break;
        const bool hit = tk[r] == key && !term;
        found |= hit;
        term |= hit || tk[r] == kInvalidKey;
      }
      live = !found;
    }
    const uint32_t b = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_warp[warp] = __popc(b);
    __syncthreads();
    if (warp == 0) {
      const int w = s_warp[lane];
      const int wi = vh::warp_inclusive(w);
      s_warp[lane] = wi - w;
      if (lane == 31) s_total = wi;
    }
    __syncthreads();
    if (live)
      a.seg[(long long)blockIdx.x * kThreads + s_warp[warp] +
            __popc(b & ((1u << lane) - 1u))] = key;
    if (tid == 0) a.seg_count[blockIdx.x] = s_total;
  }
  if (!vh::arrived_last(a.counter)) return;

  // -- 2. the stage list: the first scap live keys in stream order
  const int n_chunks = (a.scap + kThreads - 1) / kThreads;
  int* s_keys = smem;                            // [n_chunks * kThreads]
  int* s_base = smem + n_chunks * kThreads;      // [n_ctas + 1]
  {
    const int per = (a.n_ctas + kThreads - 1) / kThreads;
    const int lo = min(a.n_ctas, tid * per), hi = min(a.n_ctas, lo + per);
    int s = 0;
    for (int c = lo; c < hi; ++c) s += __ldcg(a.seg_count + c);
    int run = vh::block_exclusive<kThreads>(s, s_warp, &s_total);
    for (int c = lo; c < hi; ++c) {
      const int v = __ldcg(a.seg_count + c);
      s_base[c] = run;
      run += v;
    }
    if (tid == 0) s_base[a.n_ctas] = s_total;
  }
  __syncthreads();
  const int n_stage = min(s_base[a.n_ctas], a.scap);
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    if (j >= n_chunks) break;
    const int e = j * kThreads + tid;
    int k = kInvalidKey;
    if (e < n_stage) {
      int lo = 0, hi = a.n_ctas - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_base[mid] <= e) lo = mid;
        else hi = mid - 1;
      }
      k = __ldcg(a.seg + (long long)lo * kThreads + (e - s_base[lo]));
    }
    s_keys[e] = k;
  }

  // -- 3. staging dedup: the lowest stage index at each key's staging slot
  // represents it this round
  uint32_t valid = 0;
  for (int j = 0; j < n_chunks; ++j) {
    const int e = j * kThreads + tid;
    const int k = s_keys[e];
    if (k != kInvalidKey) {
      valid |= 1u << j;
      atomicMin(a.claim + slot_at(k, a.round, a.table_mask), e);
    }
  }
  __syncthreads();
  uint32_t rep = 0;
  for (int j = 0; j < n_chunks; ++j) {
    if (!((valid >> j) & 1u)) continue;
    const int e = j * kThreads + tid;
    if (__ldcg(a.claim + slot_at(s_keys[e], a.round, a.table_mask)) == e)
      rep |= 1u << j;
  }
  __syncthreads();
  for (int j = 0; j < n_chunks; ++j) {
    if (!((valid >> j) & 1u)) continue;
    const int e = j * kThreads + tid;
    atomicExch(a.claim + slot_at(s_keys[e], a.round, a.table_mask),
               kIntMax);
  }

  // -- 4. the resident check: probes 0-1 for every key; the first rcap
  // unresolved keys by rank probe on, the rest count as resident
  uint32_t found = 0, open = 0;
  for (int j = 0; j < n_chunks; ++j) {
    if (!((rep >> j) & 1u)) continue;
    const int k = s_keys[j * kThreads + tid];
    const vh::Hashes h = vh::hashes_of(k);
    int tk[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      tk[r] = r < a.pre_probes
                  ? __ldcg(a.table_key + vh::slot_of(h, r, a.table_mask))
                  : kInvalidKey;
    bool dead = false, f = false;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r >= a.pre_probes) break;
      const bool hit = tk[r] == k && !dead;
      f |= hit;
      dead |= hit || tk[r] == kInvalidKey;
    }
    if (f) found |= 1u << j;
    if (!dead) open |= 1u << j;
  }
  __syncthreads();       // s_total and s_off free again
  vh::scan_chunks<kThreads>(open, n_chunks, s_off, &s_total);
  uint32_t fresh = rep & ~found;
  for (int j = 0; j < n_chunks; ++j) {
    const int lr = vh::chunk_rank<kThreads>(open, j, s_off);
    if (!((open >> j) & 1u)) continue;
    if (lr >= a.rcap) {                          // overflow: resident
      fresh &= ~(1u << j);
      continue;
    }
    const int k = s_keys[j * kThreads + tid];
    const vh::Hashes h = vh::hashes_of(k);
    for (int r = 2; r < a.max_probes; ++r) {
      const int tk = __ldcg(a.table_key + vh::slot_of(h, r, a.table_mask));
      if (tk == k) {
        fresh &= ~(1u << j);
        break;
      }
      if (tk == kInvalidKey) break;
    }
  }
  __syncthreads();

  // -- 5. the insert list: the first icap new keys by rank
  vh::scan_chunks<kThreads>(fresh, n_chunks, s_off, &s_total);
  uint32_t pending = 0;
  for (int j = 0; j < n_chunks; ++j) {
    const int nr = vh::chunk_rank<kThreads>(fresh, j, s_off);
    if (((fresh >> j) & 1u) && nr < a.icap) pending |= 1u << j;
  }
  if (tid == 0) {
    s_free = a.first ? *a.n_free_in : *a.n_free_out;
    s_upto = a.first ? *a.dense_upto_in : *a.dense_upto_out;
    s_count = a.first ? 0 : *a.total_out;
    s_max = -1;
  }
  __syncthreads();

  // -- 6. the contended insert rounds
  const int n_free = s_free;
  int alloc_base = 0, my_max = -1;
  for (int r = 0; r < a.insert_probes; ++r) {
    if (!__syncthreads_or(pending != 0u)) break;
    uint32_t contend = 0;
    for (int j = 0; j < n_chunks; ++j) {
      if (!((pending >> j) & 1u)) continue;
      const int e = j * kThreads + tid;
      const int k = s_keys[e];
      const int s = slot_at(k, r, a.table_mask);
      const int tk = __ldcg(a.table_key + s);
      if (tk == k) {
        pending &= ~(1u << j);
      } else if (tk == kInvalidKey || tk == kTombstone) {
        contend |= 1u << j;
        atomicMin(a.claim + s, e);
      }
    }
    __syncthreads();
    uint32_t win = 0;
    for (int j = 0; j < n_chunks; ++j) {
      if (!((contend >> j) & 1u)) continue;
      const int e = j * kThreads + tid;
      if (__ldcg(a.claim + slot_at(s_keys[e], r, a.table_mask)) == e)
        win |= 1u << j;
    }
    const int n_win = vh::scan_chunks<kThreads>(win, n_chunks, s_off,
                                                &s_total);
    for (int j = 0; j < n_chunks; ++j) {
      const int rank = vh::chunk_rank<kThreads>(win, j, s_off) + alloc_base;
      const int e = j * kThreads + tid;
      if (((win >> j) & 1u) && rank < n_free) {
        const int k = s_keys[e];
        const int s = slot_at(k, r, a.table_mask);
        const int src = min(max(n_free - 1 - rank, 0), a.n_pool - 1);
        const int pslot = __ldg(a.free_stack + src);
        a.table_key[s] = k;
        a.table_val[s] = pslot;
        a.block_key[pslot] = k;
        my_max = max(my_max, pslot);
      }
      if ((contend >> j) & 1u)
        atomicExch(a.claim + slot_at(s_keys[e], r, a.table_mask), kIntMax);
    }
    alloc_base += max(0, min(n_win, n_free - alloc_base));
    pending &= ~win;
    __syncthreads();       // s_off and s_total are read above
  }

  // -- 7. the counters
  atomicMax(&s_max, my_max);
  __syncthreads();
  if (tid == 0) {
    *a.n_free_out = n_free - alloc_base;
    *a.dense_upto_out = max(s_upto, s_max + 1);
    *a.total_out = s_count + alloc_base;
  }
}

size_t smem_bytes(int scap, int n_ctas) {
  const int n_chunks = (scap + kThreads - 1) / kThreads;
  return sizeof(int) * ((size_t)n_chunks * kThreads + n_ctas + 1);
}

// Lift the kernel's dynamic shared memory limit to the card's opt-in
// maximum (once). Returns that maximum, or -1 on an error.
int smem_limit() {
  static int limit = 0;
  if (limit > 0) return limit;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  // the kernel's static shared memory comes out of the same budget
  const int dyn = optin - 4096;
  if (cudaFuncSetAttribute(hash_alloc_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dyn) != cudaSuccess)
    return -1;
  limit = dyn;
  return limit;
}

}  // namespace

// The CTAs an SM of the kernel (the occupancy query loads the module, so
// that no first use falls inside a CUDA graph capture), after lifting its
// shared memory limit. -1 on an error.
extern "C" int vh_hash_alloc_grid() {
  if (smem_limit() < 0) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, hash_alloc_kernel, kThreads,
          smem_bytes(kMaxChunks * kThreads, 1)) != cudaSuccess)
    return -1;
  return per_sm;
}

// One round of allocate on the arrays the wrapper cloned
// (ops/hash_table.py checks every shape, makes the outputs and scratch,
// and keeps the claim array and the counter between launches).
extern "C" int vh_hash_alloc(
    const void* keys, int n_keys, int scap, int rcap, int icap, int round,
    int pre_probes, int max_probes, int insert_probes, int table_size,
    int n_pool, void* table_key, void* table_val, void* block_key,
    const void* free_stack, const void* n_free_in, const void* dense_upto_in,
    void* n_free_out, void* dense_upto_out, void* total_out, int first,
    void* claim, void* seg, void* seg_count, void* counter, void* stream) {
  if (n_keys < 1 || scap < 1 || scap > kMaxChunks * kThreads ||
      table_size < 1 || (table_size & (table_size - 1)) != 0 || n_pool < 1)
    return (int)cudaErrorInvalidValue;
  const int n_ctas = (n_keys + kThreads - 1) / kThreads;
  const int limit = smem_limit();
  if (limit < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(scap, n_ctas);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  AllocArgs a;
  a.keys = (const int*)keys;
  a.n_keys = n_keys;
  a.n_ctas = n_ctas;
  a.scap = scap;
  a.rcap = rcap;
  a.icap = icap;
  a.round = round;
  a.pre_probes = pre_probes;
  a.max_probes = max_probes;
  a.insert_probes = insert_probes;
  a.table_mask = (uint32_t)(table_size - 1);
  a.n_pool = n_pool;
  a.table_key = (int*)table_key;
  a.table_val = (int*)table_val;
  a.block_key = (int*)block_key;
  a.free_stack = (const int*)free_stack;
  a.n_free_in = (const int*)n_free_in;
  a.dense_upto_in = (const int*)dense_upto_in;
  a.n_free_out = (int*)n_free_out;
  a.dense_upto_out = (int*)dense_upto_out;
  a.total_out = (int*)total_out;
  a.first = first;
  a.claim = (int*)claim;
  a.seg = (int*)seg;
  a.seg_count = (int*)seg_count;
  a.counter = (unsigned*)counter;
  hash_alloc_kernel<<<n_ctas, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
