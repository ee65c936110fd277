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
// 1. every CTA of the grid (1,024 candidates a CTA) probes its keys on the
//    table as the call found it (nothing of this launch is written yet):
//    probes 0-1 for every key, loaded together, drop the keys found; a
//    live key still open after them (no INVALID_KEY there) loads its deep
//    probes 2..max_probes-1, eight rounds at once; each live key gets its
//    flags (open, found by the deep probes, probe-0 slot empty or
//    tombstoned). The CTA compacts its live keys and their flags in order
//    into its segment of `seg` / `seg_flag`, writes its count and arrives
//    on a counter;
// 2. the CTA that arrives last runs the rest alone, on a stage list of at
//    most 16,384 entries in shared memory (16 a thread, entry j * 1024 + t
//    in thread t), its loops walking only the live chunks
//    (ceil(staged / 1024); one at the bench point): the first scap live
//    keys in stream order (a prefix over the CTAs' counts, then a binary
//    search a key, every chunk's loads issued together), the counters and
//    the free stack's top 1,024 read beside them; the staging dedup
//    (atomicMin of the stage index at the key's round-`round` slot; the
//    lowest index represents its key); the resident check from the flags
//    (the first 2,048 open keys by rank resident where the deep probes
//    found them, the rest counted resident); the insert list (the first
//    icap new keys by rank); `insert_probes` contended rounds (an empty or
//    tombstoned slot goes to the lowest stage index by atomicMin; round 0
//    reads the probe-0 flag, later rounds the table; winners pop the free
//    stack by prefix rank from alloc_base while the rank is below n_free);
//    then n_free, the row watermark and the count.
// Ranks are block scans over ballots, in list order, so every pool slot
// and table slot equals the plain version's (the order is part of the
// map). Claims go to a persistent int32 claim array of the table's size,
// INT32_MAX between launches: each claimed slot is reset after it is read
// (the plain version fills a fresh table-sized buffer for every
// scatter-min). atomicMin commutes, so the winners do not depend on
// timing. Reads of what this launch writes (the table, the claims, the
// other CTAs' segments) go through L2 (__ldcg) after a barrier. (Claims in
// a shared-memory table, and a warp's claims on one slot left to its
// lowest lane, both measured slower on an H100: see PERF.md.)
//
// Bound: latency, not bytes. A round moves ~0.17 MB at the bench point
// (its bound is ~0.05 us; 0.0156 ms bare on an H100 at 700 W, 0.3% of
// it): the grid's probe steps and arrival, then the last CTA's chain of
// barriers and dependent global round trips (counts, segments, claims,
// the later insert rounds' table reads) set its time.

#include "common.cuh"
#include "hash.cuh"

namespace {

using vh::kInvalidKey;
using vh::kTombstone;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 16;          // stage entries a thread: scap <= 16,384
constexpr int kIntMax = 0x7FFFFFFF;
constexpr int kProbeBatch = 8;          // deep probe rounds loaded at once

// A live candidate's probes, read by the grid before this launch writes
// the table (seg_flag)
constexpr uint8_t kOpen = 1;            // no INVALID_KEY within probes 0-1
constexpr uint8_t kDeep = 2;            // found by probes 2..max_probes-1
constexpr uint8_t kFree0 = 4;           // its probe-0 slot empty or tombstoned

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
  uint8_t* seg_flag;                    // [n_ctas * kThreads]
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
  __shared__ int s_pop[kThreads];               // the free stack's top
  __shared__ int s_total;
  __shared__ int s_free, s_upto, s_count, s_max;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // -- 1. this CTA's keys probed on the table as the call found it: the
  // pre-drop of the keys found within two probes, the flags of the
  // resident check (its deep probes too) and of the first insert round,
  // then an ordered compaction of the live keys
  {
    const long long i = (long long)blockIdx.x * kThreads + tid;
    const int key = i < a.n_keys ? a.keys[i] : kInvalidKey;
    bool live = false;
    uint32_t flags = 0;
    if (key != kInvalidKey) {
      const vh::Hashes h = vh::hashes_of(key);
      // probes 0-1, loaded together: the pre-drop's and the resident
      // check's
      int tk[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        tk[r] = r < a.pre_probes
                    ? __ldcg(a.table_key + vh::slot_of(h, r, a.table_mask))
                    : kInvalidKey;
      bool term = false, found = false;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r >= a.pre_probes) break;
        const bool hit = tk[r] == key && !term;
        found |= hit;
        term |= hit || tk[r] == kInvalidKey;
      }
      if (tk[0] == kInvalidKey || tk[0] == kTombstone) flags |= kFree0;
      live = !found;
      // a live key still open after them: its deep probes, kProbeBatch
      // rounds loaded together
      if (live && !term) {
        flags |= kOpen;
        bool ddead = false, dfound = false;
        for (int r0 = 2; r0 < a.max_probes && !ddead; r0 += kProbeBatch) {
          int dk[kProbeBatch];
#pragma unroll
          for (int q = 0; q < kProbeBatch; ++q)
            dk[q] = r0 + q < a.max_probes
                        ? __ldcg(a.table_key +
                                 vh::slot_of(h, r0 + q, a.table_mask))
                        : kInvalidKey;
#pragma unroll
          for (int q = 0; q < kProbeBatch; ++q) {
            if (r0 + q >= a.max_probes) break;
            const bool hit = dk[q] == key && !ddead;
            dfound |= hit;
            ddead |= hit || dk[q] == kInvalidKey;
          }
        }
        if (dfound) flags |= kDeep;
      }
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
    if (live) {
      const long long pos = (long long)blockIdx.x * kThreads + s_warp[warp] +
                            __popc(b & ((1u << lane) - 1u));
      a.seg[pos] = key;
      a.seg_flag[pos] = (uint8_t)flags;
    }
    if (tid == 0) a.seg_count[blockIdx.x] = s_total;
  }
  if (!vh::arrived_last(a.counter)) return;

  // -- 2. the stage list: the first scap live keys in stream order; the
  // counters and the free stack's top are read beside it
  const int n_chunks = (a.scap + kThreads - 1) / kThreads;
  int* s_keys = smem;                                     // [n_chunks * T]
  int* s_base = s_keys + n_chunks * kThreads;             // [n_ctas + 1]
  uint8_t* s_flag = (uint8_t*)(s_base + a.n_ctas + 1);    // [n_chunks * T]
  if (tid == 0) {
    s_free = a.first ? *a.n_free_in : *a.n_free_out;
    s_upto = a.first ? *a.dense_upto_in : *a.dense_upto_out;
    s_count = a.first ? 0 : *a.total_out;
    s_max = -1;
  }
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
  const int n_live = (n_stage + kThreads - 1) / kThreads;   // live chunks
  const int n_free = s_free;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    const int e = j * kThreads + tid;
    if (e < n_stage) {
      int lo = 0, hi = a.n_ctas - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_base[mid] <= e) lo = mid;
        else hi = mid - 1;
      }
      const long long src = (long long)lo * kThreads + (e - s_base[lo]);
      s_keys[e] = __ldcg(a.seg + src);
      s_flag[e] = __ldcg(a.seg_flag + src);
    }
  }
  if (tid < min(n_stage, n_free))
    s_pop[tid] = __ldg(a.free_stack + (n_free - 1 - tid));
  __syncthreads();

  // -- 3. staging dedup: the lowest stage index at each key's staging slot
  // represents it this round
  uint32_t valid = 0;
  for (int j = 0; j < n_live; ++j) {
    const int e = j * kThreads + tid;
    if (e < n_stage) {
      valid |= 1u << j;
      atomicMin(a.claim + slot_at(s_keys[e], a.round, a.table_mask), e);
    }
  }
  __syncthreads();
  uint32_t rep = 0;
  for (int j = 0; j < n_live; ++j) {
    if (!((valid >> j) & 1u)) continue;
    const int e = j * kThreads + tid;
    if (__ldcg(a.claim + slot_at(s_keys[e], a.round, a.table_mask)) == e)
      rep |= 1u << j;
  }
  __syncthreads();
  for (int j = 0; j < n_live; ++j)
    if ((valid >> j) & 1u)
      atomicExch(a.claim + slot_at(s_keys[j * kThreads + tid], a.round,
                                   a.table_mask),
                 kIntMax);

  // -- 4. the resident check, from the grid's probes: a representative
  // was not found within probes 0-1 (it is live); the first rcap open
  // ones by rank are resident where the deep probes found them, the rest
  // count as resident
  uint32_t open = 0, deep = 0;
  for (int j = 0; j < n_live; ++j) {
    if (!((rep >> j) & 1u)) continue;
    const uint8_t f = s_flag[j * kThreads + tid];
    if (f & kOpen) open |= 1u << j;
    if (f & kDeep) deep |= 1u << j;
  }
  vh::scan_chunks<kThreads>(open, n_live, s_off, &s_total);
  uint32_t fresh = rep;
  for (int j = 0; j < n_live; ++j) {
    const int lr = vh::chunk_rank<kThreads>(open, j, s_off);
    if (((open >> j) & 1u) && (lr >= a.rcap || ((deep >> j) & 1u)))
      fresh &= ~(1u << j);
  }
  __syncthreads();

  // -- 5. the insert list: the first icap new keys by rank
  vh::scan_chunks<kThreads>(fresh, n_live, s_off, &s_total);
  uint32_t pending = 0;
  for (int j = 0; j < n_live; ++j) {
    const int nr = vh::chunk_rank<kThreads>(fresh, j, s_off);
    if (((fresh >> j) & 1u) && nr < a.icap) pending |= 1u << j;
  }

  // -- 6. the contended insert rounds; round 0 reads the probe-0 slot as
  // the grid read it (nothing is written before it)
  int alloc_base = 0, my_max = -1;
  for (int r = 0; r < a.insert_probes; ++r) {
    if (!__syncthreads_or(pending != 0u)) break;
    uint32_t contend = 0;
    for (int j = 0; j < n_live; ++j) {
      if (!((pending >> j) & 1u)) continue;
      const int e = j * kThreads + tid;
      const int k = s_keys[e];
      const int s = slot_at(k, r, a.table_mask);
      bool empty;
      if (r == 0) {
        empty = (s_flag[e] & kFree0) != 0;
      } else {
        const int tk = __ldcg(a.table_key + s);
        if (tk == k) {
          pending &= ~(1u << j);
          continue;
        }
        empty = tk == kInvalidKey || tk == kTombstone;
      }
      if (empty) {
        contend |= 1u << j;
        atomicMin(a.claim + s, e);
      }
    }
    __syncthreads();
    uint32_t win = 0;
    for (int j = 0; j < n_live; ++j) {
      if (!((contend >> j) & 1u)) continue;
      const int e = j * kThreads + tid;
      if (__ldcg(a.claim + slot_at(s_keys[e], r, a.table_mask)) == e)
        win |= 1u << j;
    }
    const int n_win = vh::scan_chunks<kThreads>(win, n_live, s_off,
                                                &s_total);
    for (int j = 0; j < n_live; ++j) {
      const int rank = vh::chunk_rank<kThreads>(win, j, s_off) + alloc_base;
      const int e = j * kThreads + tid;
      if (((win >> j) & 1u) && rank < n_free) {
        const int k = s_keys[e];
        const int s = slot_at(k, r, a.table_mask);
        const int src = min(max(n_free - 1 - rank, 0), a.n_pool - 1);
        const int pslot = rank < kThreads ? s_pop[rank]
                                          : __ldg(a.free_stack + src);
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

// The dynamic shared memory of a launch: the stage keys, the CTAs' bases
// and the stage flags.
size_t smem_bytes(int scap, int n_ctas) {
  const int n_chunks = (scap + kThreads - 1) / kThreads;
  return sizeof(int) * ((size_t)n_chunks * kThreads + n_ctas + 1) +
         (size_t)n_chunks * kThreads;
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
  const int dyn = optin - 8192;
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
    void* claim, void* seg, void* seg_flag, void* seg_count, void* counter,
    void* stream) {
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
  a.seg_flag = (uint8_t*)seg_flag;
  a.seg_count = (int*)seg_count;
  a.counter = (unsigned*)counter;
  hash_alloc_kernel<<<n_ctas, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
