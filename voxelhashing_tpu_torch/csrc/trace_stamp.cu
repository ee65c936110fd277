// The step tracer's device stamp (diagnostics.StepTracer): one thread
// writes the global nanosecond timer, and a segment's counters, into the
// frame's row of a ring kept on the device, so that a traced graph keeps
// every frame's stamps with no host read until the ring is copied out.
//
// The ring is int64 [rows, width]; `slot` holds the row of the current
// frame. A stamp that opens a frame (a view or fused segment's first)
// moves the slot to the next row and zeroes it first; before the first
// such stamp nothing is written. A stamp may carry up to three counters:
// device scalars (int32, or int64 where bit k of `wide` is set) copied into
// their columns of the same row.
#include "common.cuh"

namespace {

__global__ void trace_stamp_kernel(long long* ring, long long* slot, int rows,
                                   int width, int col, int open, int n,
                                   const void* c0, const void* c1,
                                   const void* c2, int col0, int col1,
                                   int col2, int wide) {
  long long s = *slot;
  if (open) {
    s = (s + 1) % rows;
    *slot = s;
    for (int i = 0; i < width; ++i) ring[s * width + i] = 0;
  }
  if (s < 0) return;  // no frame opened yet
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  ring[s * width + col] = (long long)t;
  const void* src[3] = {c0, c1, c2};
  const int dst[3] = {col0, col1, col2};
  for (int k = 0; k < n; ++k)
    ring[s * width + dst[k]] = (wide >> k) & 1
                                   ? *(const long long*)src[k]
                                   : (long long)*(const int*)src[k];
}

}  // namespace

// Occupancy query of the kernel: loads its module outside any capture.
extern "C" int vh_trace_stamp_grid() {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, trace_stamp_kernel, 1, 0) != cudaSuccess)
    return -1;
  return per_sm;
}

// One stamp on `stream` (the wrapper in diagnostics.py checks the ring,
// the slot and the counters' dtypes).
extern "C" int vh_trace_stamp(void* ring, void* slot, int rows, int width,
                              int col, int open, int n, const void* c0,
                              const void* c1, const void* c2, int col0,
                              int col1, int col2, int wide, void* stream) {
  trace_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (long long*)ring, (long long*)slot, rows, width, col, open, n, c0, c1,
      c2, col0, col1, col2, wide);
  return (int)cudaGetLastError();
}
