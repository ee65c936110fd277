"""The march's, the hash insert's, the two front kernels', the tile
bounds' and GC's variants and clock stamps, on one card.

    python -m voxelhashing_tpu_torch.kernel_probes [--parent DIR]
    python -m voxelhashing_tpu_torch.kernel_probes --bounds-gc-only \
        [--parent DIR]

With ``--bounds-gc-only``: ``csrc/raymarch.cu``'s tile bounds as they are,
with one design move undone each (:data:`BOUNDS_EDITS`: the fill before
each launch, no warp aggregation, every tile flushed, the index loaded
after the mask, two rows a thread) and with clock64 stamps by phase, at
phase 6's frame-11 render; ``csrc/hash_delete.cu``'s GC entry as it is,
with one move undone each (:data:`GC_EDITS`: blockIdx for the ticket, the
slot probes after the look-back) and with stamps, and its list entry on
the plain GC's short list, at phase 1's frame-11 GC (on a scratch pool);
with ``--parent DIR`` that checkout's bounds and list delete too (its
bounds with the fill its wrapper made). Each build is held bit for bit
against the plain version and timed as the best of three replays of a
CUDA graph of 100 launches.

Builds ``csrc/raymarch.cu`` as it is and with one edit each
(:data:`MARCH_EDITS`: the windows alone, no weight reads, 8 lanes a ray,
register caps, a 512-thread CTA, clock64 stamps by phase),
``csrc/hash_alloc.cu`` as it is and with clock64 stamps at the last CTA's
phases, ``csrc/preprocess.cu`` and ``csrc/alloc_candidates.cu`` as they
are, with one design move undone each (:data:`PREPROCESS_EDITS`,
:data:`CANDIDATE_EDITS`) and with clock64 stamps by phase; with ``--parent
DIR`` (another checkout of this repository) that checkout's four sources
too. At ``chip_smoke.py``'s phase-6 map (frame 10) and frame 11's render,
each march build is held against the plain version where its edit keeps
the result, and timed: 100 back-to-back launches between CUDA events, the
best of three, with and without gradients. At phase 1's insert calls of
frames 0 and 11, each insert build is held bit for bit against the call's
outputs and timed the same way (the table clones restored before each
launch; the restores alone timed and taken off). At phase 1's frame 11,
each preprocess build and each candidates build (tile mode as the step
calls it, and pixel mode) is held bit for bit against the plain version
where its edit keeps the result, and timed as the best of three replays
of one CUDA graph of 100 launches (shorter than a ctypes launch on the
host, these kernels would time the host otherwise). The stamped
builds print a warp's cycles by phase (the march; lane 0 of each warp,
averaged), the last CTA's cycles by phase (the insert), with the grid
phase in ns, and a CTA's cycles by phase (the front kernels; thread 0 of
each CTA, the mean and the slowest CTA's total). A launch that does not
end within 20 s stops the run. Needs one CUDA card and nvcc; the builds go
to ``build/voxelhashing_tpu_torch/kernel_probes/``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import torch

from . import ab_step
from .ops import _build

# the march's edits: (name, [(old, new), ...], whether the result holds)
_SECANT = "  for (int k = 0; k < 3; ++k) {\n    const float denom"
_TAKE = "const bool take = (st == 0 ? crossed : found) && j < kHit;"
MARCH_EDITS = (
    ("as is", (), True),
    ("windows alone (no secant, no hit)",
     ((_SECANT, _SECANT.replace("k < 3", "k < 0")),
      (_TAKE, "const bool take = false;")), False),
    ("no weight reads (every weight 1)",
     (("w_bits[c] = __ldg(a.weight + lin);", "w_bits[c] = 0x3F80u;"),),
     False),
    ("8 lanes a ray", (("constexpr int kMarchLanes = 4;",
                        "constexpr int kMarchLanes = 8;"),), True),
    ("4 CTAs an SM", (("__launch_bounds__(kMarchThreads)",
                       "__launch_bounds__(kMarchThreads, 4)"),), True),
    ("6 CTAs an SM", (("__launch_bounds__(kMarchThreads)",
                       "__launch_bounds__(kMarchThreads, 6)"),), True),
    ("512-thread CTA", (("constexpr int kMarchThreads = 256;",
                         "constexpr int kMarchThreads = 512;"),), True),
)
# the front kernels' moves, each undone by an edit: (name, [(old, new),
# ...], whether the result holds, the preprocess grid ("tiles": the
# wrapper's tile_grid, or (gx, gy)))
_WEIGHT = ("range_weight(diff * diff, a.two_sr2,\n"
           "                                         a.inv_two_sr2, a.x_lo, "
           "a.x_hi)")
_CLAMPED = "expf(-div_rn_recip(fminf(fmaxf(x, lo), hi), c, y))"
PREPROCESS_EDITS = (
    ("as is", (), True, "tiles"),
    ("IEEE division", ((_WEIGHT, "expf(-(diff * diff) / a.two_sr2)"),), True,
     "tiles"),
    ("the division unclamped",
     ((_CLAMPED, "expf(-div_rn_recip(x, c, y))"),), True, "tiles"),
    ("16x16 tiles, 324 threads (300 CTAs)",
     (("constexpr int kThreads = 704;", "constexpr int kThreads = 324;"),),
     True, (20, 15)),
    ("no taps for the centres the gate drops",
     (("    filt[k] = a.filter ? bilateral<kR>(a, c, side, r) : c[0];",
       "    filt[k] = !a.filter ? c[0] : isfinite(c[0])\n"
       "        ? bilateral<kR>(a, c, side, r) : nan_bits();"),),
     True, "tiles"),
    ("two pixels a thread (352 threads)",
     (("constexpr int kThreads = 704;", "constexpr int kThreads = 352;"),),
     True, "tiles"),
)
# (name, [(old, new), ...], whether the result holds, what the launch
# changes: "block" a tile-mode CTA's (rows, cols), "stage" 0 to pool from
# global memory)
CANDIDATE_EDITS = (
    ("as is", (), True, {}),
    ("the general step loop for 8 steps",
     (("case 0: launch<2, kDefaultSteps>", "case 0: launch<2, 0>"),
      ("case 2: launch<1, kDefaultSteps>", "case 2: launch<1, 0>")), True,
     {}),
    ("4 x 16 columns a CTA (75 CTAs in tile mode)",
     (("static constexpr int kCols = kRays == 2 ? 8 : 16;",
       "static constexpr int kCols = 16;"),
      ("kRays == 2 ? 128 :", "kRays == 2 ? 192 :")), True,
     {"block": (4, 16)}),
    ("footprint loads one at a time",
     (("constexpr int kStageUnroll = 8;", "constexpr int kStageUnroll = 1;"),),
     True, {}),
    ("the footprint not staged (tiles from global memory)", (), True,
     {"stage": 0}),
    ("keys laid out [column][ray][step] (bank conflicts)",
     (("  return (ray * steps + step) * halo + column;",
       "  return (column * rays + ray) * steps + step;"),), True, {}),
    ("256 threads a CTA in tile mode",
     (("kRays == 2 ? 128 :", "kRays == 2 ? 256 :"),), True, {}),
)
# the bounds' moves, each undone: (name, [(old, new), ...], whether the
# result holds, what the launch changes: "fill" the accumulators filled
# before each launch, as the parent's wrapper did)
_ATOMICS = ("    if (o.scatter)\n"
            "      for (int iy = o.t0y; iy <= o.t1y; ++iy)\n"
            "        for (int ix = o.t0x; ix <= o.t1x; ++ix) {\n"
            "          atomicMin(tmin + iy * a.tiles_x + ix, o.lo);\n"
            "          atomicMin(tmax + iy * a.tiles_x + ix, o.hi);\n"
            "        }\n")
# the warp walks its rows' boxes in step (row-major), a step's lanes on one
# tile reduced before one atomic: by __match_any_sync, or by runs of equal
# tiles through shuffles (pool-ordered neighbours share their tiles)
_STEPS = ("    const int w = o.t1x - o.t0x + 1;\n"
          "    const int cnt = o.scatter ? w * (o.t1y - o.t0y + 1) : 0;\n"
          "    for (int k = 0; __any_sync(kFull, k < cnt); ++k) {\n"
          "      const int t = k < cnt ? (o.t0y + k / w) * a.tiles_x + o.t0x"
          " + k % w : -1;\n")
_MATCHED = _STEPS + (
    "      const unsigned peers = __match_any_sync(kFull, t);\n"
    "      if (t >= 0) {\n"
    "        const int lo = __reduce_min_sync(peers, o.lo);\n"
    "        const int hi = __reduce_min_sync(peers, o.hi);\n"
    "        if (lane == __ffs(peers) - 1) {\n"
    "          atomicMin(tmin + t, lo);\n"
    "          atomicMin(tmax + t, hi);\n"
    "        }\n      }\n    }\n")
_RUNS = _STEPS + (
    "      const int up = __shfl_up_sync(kFull, t, 1);\n"
    "      const unsigned heads =\n"
    "          __ballot_sync(kFull, lane == 0 || up != t);\n"
    "      const unsigned above = heads & ~((2u << lane) - 1u);\n"
    "      const int next = above ? __ffs(above) - 1 : 32;\n"
    "      int lo = o.lo, hi = o.hi;\n"
    "      for (int d = 1; d < 32; d <<= 1) {\n"
    "        const int l2 = __shfl_down_sync(kFull, lo, d);\n"
    "        const int h2 = __shfl_down_sync(kFull, hi, d);\n"
    "        if (lane + d < next) {\n"
    "          lo = min(lo, l2);\n"
    "          hi = min(hi, h2);\n"
    "        }\n      }\n"
    "      if (t >= 0 && ((heads >> lane) & 1u)) {\n"
    "        atomicMin(tmin + t, lo);\n"
    "        atomicMin(tmax + t, hi);\n"
    "      }\n    }\n")
BOUNDS_EDITS = (
    ("as is", (), True, {}),
    ("the fill before each launch (two nodes a render)", (), True,
     {"fill": True}),
    ("a step's lanes on one tile matched first (__match_any_sync)",
     ((_ATOMICS, _MATCHED),), True, {}),
    ("runs of equal tiles reduced by shuffles first",
     ((_ATOMICS, _RUNS),), True, {}),
    ("every tile flushed from every CTA",
     (("  if (threadIdx.x < 4) s_box[threadIdx.x] = kNoTile;\n",
       "  if (threadIdx.x < 4)\n    s_box[threadIdx.x] = threadIdx.x < 2 ? 0"
       "\n        : threadIdx.x == 2 ? 1 - a.tiles_y : 1 - a.tiles_x;\n"),),
     True, {}),
    ("the index loaded after the mask",
     (("      on = a.active_mask[i];\n      p = a.active_idx[i];\n",
       "      on = a.active_mask[i];\n      if (on) p = a.active_idx[i];\n"),),
     True, {}),
    ("the last CTA's tiles loaded one at a time",
     (("constexpr int kTail = 4;", "constexpr int kTail = 1;"),), True, {}),
    ("two rows a thread (half the CTAs)",
     (("constexpr int kBoundsRows = 1;", "constexpr int kBoundsRows = 2;"),),
     True, {}),
)
# GC's moves, each undone: (name, [(old, new), ...], whether the result
# holds)
_ZERO = ("      zero_word(a, h == 0 ? s_row[t] : __ldcg(a.rows + s_first[h] "
         "+ t),\n                tid % kRowWords);\n")
GC_EDITS = (
    ("as is", (), True),
    ("blockIdx for the ticket (no ticket atomic)",
     (("  if (tid == 0) s_b = (int)(atomicAdd(a.ticket, 1ull) & "
       "0xffffffffull);\n", "  if (tid == 0) s_b = blockIdx.x;\n"),), True),
    ("the slot probes after the look-back",
     (("  const int slot = freed ? key_slot(a, p) : -1;\n"
       "  s_row[tid] = -1;\n  __syncthreads();\n",
       "  s_row[tid] = -1;\n  __syncthreads();\n"
       "  const int slot = freed ? key_slot(a, p) : -1;\n"),), True),
    ("each CTA zeroes its own rows (no spread)",
     (("constexpr int kSpread = 4;", "constexpr int kSpread = 1;"),),
     True),
    ("rows spread over 16 CTAs",
     (("constexpr int kSpread = 4;", "constexpr int kSpread = 16;"),),
     True),
    ("no row zeroing (the rest of the cost)",
     ((_ZERO, "      ;\n"),), False),
    ("256 rows a CTA", (("constexpr int kGcThreads = 1024;",
                         "constexpr int kGcThreads = 256;"),), True),
    ("512 rows a CTA", (("constexpr int kGcThreads = 1024;",
                         "constexpr int kGcThreads = 512;"),), True),
)
_CLOCK_FNS = (
    '__device__ unsigned long long g_cyc[8];\n'
    '}  // namespace\n'
    'extern "C" int vh_cyc(void* out) {\n'
    '  return (int)cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc));\n}\n'
    'extern "C" int vh_cyc_zero() {\n'
    '  unsigned long long z[8] = {0};\n'
    '  return (int)cudaMemcpyToSymbol(g_cyc, z, sizeof(z));\n}\n'
    'namespace {\n')


def _edit(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"kernel_probes: the source moved: {old!r}")
        src = src.replace(old, new)
    return src


def march_clocked(src):
    """The march with each warp's cycles (lane 0) in the windows, the
    secant and the hit summed into g_cyc[0..2], the warps into g_cyc[3]."""
    return _edit(src, (
        ("using vh::kInvalidKey;\n", "using vh::kInvalidKey;\n" + _CLOCK_FNS),
        ("  for (int base = 0; __any_sync(kFull, !done); base += kLanes) {",
         "  const long long c0 = clock64();\n"
         "  for (int base = 0; __any_sync(kFull, !done); base += kLanes) {"),
        ("  // the three secant steps, each sample's corners across the ray's",
         "  const long long c1 = clock64();\n"
         "  // the three secant steps, each sample's corners across the ray's"),
        ("  // the hit's samples across the lanes (every lane of the warp takes",
         "  const long long c2 = clock64();\n"
         "  // the hit's samples across the lanes (every lane of the warp takes"),
        ("  if (!on || lane != 0) return;",
         "  const long long c3 = clock64();\n"
         "  if ((threadIdx.x & 31) == 0) {\n"
         "    atomicAdd(g_cyc, (unsigned long long)(c1 - c0));\n"
         "    atomicAdd(g_cyc + 1, (unsigned long long)(c2 - c1));\n"
         "    atomicAdd(g_cyc + 2, (unsigned long long)(c3 - c2));\n"
         "    atomicAdd(g_cyc + 3, 1ull);\n  }\n"
         "  if (!on || lane != 0) return;")))


def insert_clocked(src):
    """The insert with the last CTA's clock at its phases in g_cyc[0..6]
    (the stage list, the dedup, the resident check, the insert list, then
    after rounds 0 and 1 and at the end) and the grid phase's ns in
    g_cyc[7] (the first CTA's start to the last CTA's arrival)."""
    stamp = "  if (threadIdx.x == 0) g_cyc[{}] = clock64();\n"
    gt = ("  if (threadIdx.x == 0) {{ unsigned long long t; asm volatile("
          "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); {} }}\n")
    return _edit(src, (
        ("using vh::kTombstone;\n",
         "using vh::kTombstone;\n" + _CLOCK_FNS
         + "__device__ unsigned long long g_t0 = ~0ull;\n"),
        ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
         "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
         + gt.format("atomicMin(&g_t0, t);")),
        ("  if (!vh::arrived_last(a.counter)) return;\n",
         "  if (!vh::arrived_last(a.counter)) return;\n"
         + gt.format("g_cyc[7] = t - g_t0; g_t0 = ~0ull;") + stamp.format(0)),
        ("  // -- 3. staging dedup", stamp.format(1) + "  // -- 3. staging dedup"),
        ("  // -- 4. the resident", stamp.format(2) + "  // -- 4. the resident"),
        ("  // -- 5. the insert list",
         stamp.format(3) + "  // -- 5. the insert list"),
        ("    pending &= ~win;\n    __syncthreads();",
         "    pending &= ~win;\n    __syncthreads();\n"
         "    if (threadIdx.x == 0 && r < 2) g_cyc[4 + r] = clock64();"),
        ("  // -- 7. the counters", stamp.format(6) + "  // -- 7. the counters"),
    ))


def _sink(value):
    """A stamp's wait for ``value``: thread 0 stores it to volatile shared
    memory first (the store waits for its load)."""
    return (f"  if (threadIdx.x == 0) {{ g_sink = {value}; }}\n")


def bounds_clocked(src):
    """The bounds kernel with thread 0's clock at its phases summed over
    the CTAs into g_cyc[0..3] (the load chain to the key, the projection,
    the shared atomics, the flush), the CTAs in g_cyc[4], the slowest
    CTA's total in g_cyc[5] and the last CTA's tail (the floats, the
    widening and the restore) in g_cyc[6]."""
    stamp = "  if (threadIdx.x == 0) t_{0} = clock64();\n"
    return _edit(src, (
        ("constexpr int kNoTile = 0x7FFFFFFF;    // an empty tile box's bound\n",
         "constexpr int kNoTile = 0x7FFFFFFF;    // an empty tile box's bound\n"
         + _CLOCK_FNS + "__shared__ volatile int g_sink;\n"),
        ("  const int lane = threadIdx.x & 31;\n  int* tmin",
         "  const int lane = threadIdx.x & 31;\n"
         "  long long t_0 = clock64(), t_1 = 0, t_2 = 0, t_3 = 0, t_4 = 0;\n"
         "  int* tmin"),
        ("    RowBounds o = {};\n    if (on) o = row_bounds(a, a.block_key[p]);\n",
         "    const int key_ = on ? a.block_key[p] : 0;\n" + _sink("key_")
         + stamp.format(1) + "    RowBounds o = {};\n"
         "    if (on) o = row_bounds(a, key_);\n" + _sink("o.lo")
         + stamp.format(2)),
        ("  if (shared) {\n    // flush the tiles",
         stamp.format(3) + "  if (shared) {\n    // flush the tiles"),
        ("  // the CTA that arrives last finishes the grid and restores the\n",
         "  __syncthreads();\n" + stamp.format(4)
         + "  if (threadIdx.x == 0) {\n"
         "    atomicAdd(g_cyc, (unsigned long long)(t_1 - t_0));\n"
         "    atomicAdd(g_cyc + 1, (unsigned long long)(t_2 - t_1));\n"
         "    atomicAdd(g_cyc + 2, (unsigned long long)(t_3 - t_2));\n"
         "    atomicAdd(g_cyc + 3, (unsigned long long)(t_4 - t_3));\n"
         "    atomicAdd(g_cyc + 4, 1ull);\n"
         "    atomicMax(g_cyc + 5, (unsigned long long)(t_4 - t_0));\n  }\n"
         "  // the CTA that arrives last finishes the grid and restores the\n"),
        ("  if (threadIdx.x < 4) a.acc[2 * n + threadIdx.x] = kIdentity;\n}",
         "  if (threadIdx.x < 4) a.acc[2 * n + threadIdx.x] = kIdentity;\n"
         "  if (threadIdx.x == 0) g_cyc[6] = clock64() - t_4;\n}"),
    ))


def gc_clocked(src):
    """GC's free pass with thread 0's clock at its phases summed over the
    CTAs into g_cyc[0..3] (the ticket, flags, keys and block scan; the
    look-back; the row work: pushes, tombstones, rows zeroed; the arrival,
    and in the last CTA the reset), the CTAs in g_cyc[4], the slowest
    CTA's total in g_cyc[5], the longest look-back in g_cyc[6] and the
    longest row work in g_cyc[7]."""
    stamp = "  if (tid == 0) t_{0} = clock64();\n"
    return _edit(src, (
        ("constexpr unsigned long long kCount = (1ull << 31) - 1;\n",
         "constexpr unsigned long long kCount = (1ull << 31) - 1;\n"
         + _CLOCK_FNS),
        ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n\n"
         "  if (tid == 0) s_b",
         "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
         "  long long t_0 = clock64(), t_1 = 0, t_2 = 0, t_3 = 0, t_4 = 0;\n"
         "  if (tid == 0) s_b"),
        ("  if (b == 0) {\n    if (tid == 0) {",
         stamp.format(1) + "  if (b == 0) {\n    if (tid == 0) {"),
        ("  const int c_before = (int)((s_before >> 31) & kCount);\n",
         stamp.format(2)
         + "  const int c_before = (int)((s_before >> 31) & kCount);\n"),
        ("  // the last CTA to arrive resets the ticket and the status words\n"
         "  __syncthreads();\n",
         "  // the last CTA to arrive resets the ticket and the status words\n"
         "  __syncthreads();\n" + stamp.format(3)),
        ("  if (tid == 0) *a.ticket = 0ull;\n}",
         "  if (tid == 0) *a.ticket = 0ull;\n  __syncthreads();\n"
         + stamp.format(4) + "  if (tid == 0) {\n"
         "    atomicAdd(g_cyc + 3, (unsigned long long)(t_4 - t_3));\n"
         "    atomicMax(g_cyc + 5, (unsigned long long)(t_4 - t_0));\n  }\n}"),
        ("  __syncthreads();\n  if (!s_last) return;\n  for (int k = tid;",
         "  __syncthreads();\n  if (tid == 0) {\n"
         "    atomicAdd(g_cyc, (unsigned long long)(t_1 - t_0));\n"
         "    atomicAdd(g_cyc + 1, (unsigned long long)(t_2 - t_1));\n"
         "    atomicAdd(g_cyc + 2, (unsigned long long)(t_3 - t_2));\n"
         "    atomicAdd(g_cyc + 4, 1ull);\n"
         "    atomicMax(g_cyc + 6, (unsigned long long)(t_2 - t_1));\n"
         "    atomicMax(g_cyc + 7, (unsigned long long)(t_3 - t_2));\n"
         "    if (!s_last) {\n"
         "      atomicAdd(g_cyc + 3, (unsigned long long)(clock64() - t_3));\n"
         "      atomicMax(g_cyc + 5, (unsigned long long)(clock64() - t_0));\n"
         "    }\n  }\n"
         "  if (!s_last) return;\n  for (int k = tid;"),
    ))


def front_clocked(src, kind):
    """A front kernel with thread 0's clock at its phases summed over the
    CTAs into g_cyc[0..3] (the preprocess: staging, filter, epilogue; the
    candidates: footprint, pool and DDA, kb dedup, west/north dedup and
    fold), the CTAs in g_cyc[4] and the slowest CTA's total in g_cyc[5]."""
    stamp = "  if (threadIdx.x == 0) t_{0} = clock64();\n"
    acc = ("  if (threadIdx.x == 0) {{\n"
           "    atomicAdd(g_cyc, (unsigned long long)(t_1 - t_0));\n"
           "    atomicAdd(g_cyc + 1, (unsigned long long)(t_2 - t_1));\n"
           "    atomicAdd(g_cyc + 2, (unsigned long long)(t_3 - t_2));\n"
           "    atomicAdd(g_cyc + 3, (unsigned long long)(t_4 - t_3));\n"
           "    atomicAdd(g_cyc + 4, 1ull);\n"
           "    atomicMax(g_cyc + 5, (unsigned long long)(t_4 - t_0));\n"
           "  }}\n")
    decl = "  long long t_0 = clock64(), t_1 = 0, t_2 = 0, t_3 = 0, t_4 = 0;\n"
    if kind == "preprocess":
        return _edit(src, (
            ("constexpr unsigned kNanBits = 0x7FC00000u;   // torch.nan\n",
             "constexpr unsigned kNanBits = 0x7FC00000u;   // torch.nan\n"
             + _CLOCK_FNS),
            ("  const int tid = threadIdx.x;\n  // this CTA's",
             decl + "  const int tid = threadIdx.x;\n  // this CTA's"),
            ("  // filt(i, j): the filtered depth",
             stamp.format(1) + "  // filt(i, j): the filtered depth"),
            ("  // the output pixels\n",
             stamp.format(2) + "  // the output pixels\n"),
            ("a.wb * c[2 * a.c_s2];\n    }\n  }\n}",
             "a.wb * c[2 * a.c_s2];\n    }\n  }\n  __syncthreads();\n"
             + stamp.format(3) + stamp.format(4) + acc + "}"),
        ))
    return _edit(src, (
        ("constexpr int kInvalidKey = 0x7FFFFFFF;\n",
         "constexpr int kInvalidKey = 0x7FFFFFFF;\n" + _CLOCK_FNS),
        ("  const int tid = threadIdx.x;\n  const int s_n",
         decl + "  const int tid = threadIdx.x;\n  const int s_n"),
        ("  // 2. one ray a thread", stamp.format(1) + "  // 2. one ray a thread"),
        ("  // 3. tile mode: drop", stamp.format(2) + "  // 3. tile mode: drop"),
        ("  // 4. one output column a thread",
         stamp.format(3) + "  // 4. one output column a thread"),
        ("    for (; j < a.fold; ++j) out[(long long)j * n] = kInvalidKey;\n}",
         "    for (; j < a.fold; ++j) out[(long long)j * n] = kInvalidKey;\n"
         + stamp.format(4) + acc + "}"),
    ))


# each kind's library, entry point and the argument positions a parent
# checkout's older entry point lacks
_ENTRY = {"march": ("raymarch", "vh_raymarch"),
          "bounds": ("raymarch", "vh_ray_bounds"),
          "gc": ("hash_delete", "vh_hash_gc"),
          "delete": ("hash_delete", "vh_hash_delete"),
          "insert": ("hash_alloc", "vh_hash_alloc"),
          "preprocess": ("preprocess", "vh_preprocess"),
          "candidates": ("alloc_candidates", "vh_alloc_candidates")}
# inv_two_sr2, x_lo, x_hi, kernel, gx, gy
_PARENT_PREPROCESS_DROPS = (14, 15, 16, 17, 30, 31)
_PARENT_CANDIDATE_DROPS = (29, 30, 31, 32)    # kernel, gx, gy, stage


def _build_all(sources):
    """{name: (kind, source text)} → {name: (kind, library, its entry
    point, whether it takes the insert's seg_flag)}, all compiled side by
    side."""
    out = _build.BUILD_DIR / "kernel_probes"
    out.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.iterdir():
        shutil.copy(f, out / f.name)
    procs = {}
    for i, (name, (kind, text)) in enumerate(sources.items()):
        src = out / f"{kind}_{i}.cu"
        src.write_text(text)
        procs[name] = (kind, src.with_suffix(".so"), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(src.with_suffix(".so")), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (kind, path, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({name}):\n{report}")
        regs = sorted(set(re.findall(r"Used (\d+) registers", report)))
        print(f"{kind}, {name}: registers {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(path))
        lib_name, fn_name = _ENTRY[kind]
        fn = getattr(lib, fn_name)
        sig = list(_build._SIGNATURES[lib_name][fn_name])
        flags = kind != "insert" or "seg_flag" in sources[name][1]
        if not flags:
            sig = sig[:23] + sig[24:]       # a checkout without seg_flag
        if kind == "preprocess" and "inv_two_sr2" not in sources[name][1]:
            sig = [t for i, t in enumerate(sig)
                   if i not in _PARENT_PREPROCESS_DROPS]
            flags = False                   # the parent's entry point
        if kind == "candidates" and "int kernel, int gx" not in \
                sources[name][1]:
            sig = [t for i, t in enumerate(sig)
                   if i not in _PARENT_CANDIDATE_DROPS]
            flags = False                   # the parent's entry point
        fn.argtypes, fn.restype = sig, ctypes.c_int
        libs[name] = (kind, lib, fn, flags)
    return libs


class _Watchdog:
    """Ends the process unless stopped within ``seconds``."""

    def __init__(self, what, seconds=20.0):
        self._t = threading.Timer(seconds, self._fire, (what,))
        self._t.start()

    @staticmethod
    def _fire(what):
        print(f"kernel_probes: {what} did not end; stopping", flush=True)
        os._exit(5)

    def stop(self):
        self._t.cancel()


def _best_ms(fn, n=100, reps=3):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    best = None
    for _ in range(reps):
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / n
        best = ms if best is None else min(best, ms)
    return best


def _graph_ms(fn, n=100, reps=3):
    """The best of ``reps`` replays of one CUDA graph of ``n`` calls of
    ``fn`` (which launches on the current stream) between CUDA events, over
    ``n``: the device's time, where a kernel is shorter than the host's
    ctypes launch."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        for _ in range(n):
            fn()
    graph.replay()
    best = None
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b) / n
        best = ms if best is None else min(best, ms)
    return best


def _march_inputs(smoke, device):
    """(the frame-10 map, frame 11's recorded render) of phase 6's march
    + RGB-D run."""
    from . import engine
    cfg = smoke._rgbd_config("march")
    _, depth, color = smoke._frames(cfg.camera, device)
    state = engine.create(cfg, device=device)
    with smoke._recorded_marches() as calls:
        for i in range(12):
            state, _ = engine.step(state, depth[i], color[i], cfg)
            if i == 10:
                snap = smoke._clone_engine(state)
    torch.cuda.synchronize()
    return snap.map, calls[11]


def _probe_march(smoke, libs, gpu):
    from . import geometry as geom
    from .ops import raymarch as rm
    device = torch.device("cuda", 0)
    map_state, call = _march_inputs(smoke, device)
    stream = _build.stream_ptr(device)
    holds = {name for name, _, keeps in MARCH_EDITS if keeps} | {
        "clock64 stamps", "parent"}
    for grads in (False, True):
        rc = dataclasses.replace(call["rc"], use_gradients=grads)
        bounds = rm.ray_bounds(map_state.block_key, call["active_idx"],
                               call["active_mask"],
                               geom.invert_rigid(call["pose"]), call["cam"],
                               call["cfg"], rc)
        ref = rm.march_plain(map_state, call["pose"], call["cam"],
                             call["cfg"], rc, bounds)
        for name, (kind, lib, fn, _) in libs.items():
            if kind != "march":
                continue
            args, hits = rm.prepare_march(map_state, call["pose"],
                                          call["cam"], call["cfg"], rc,
                                          bounds)
            dog = _Watchdog(f"the march, {name}")
            if name == "clock64 stamps":
                lib.vh_cyc_zero()
            _build.check(fn(*args[1], stream), "raymarch")
            torch.cuda.synchronize()
            line = ""
            if name == "clock64 stamps":
                buf = (ctypes.c_ulonglong * 8)()
                lib.vh_cyc(ctypes.byref(buf))
                w = max(int(buf[3]), 1)
                line = (f"; cycles a warp: windows {buf[0] / w:.0f}, "
                        f"secant {buf[1] / w:.0f}, hit {buf[2] / w:.0f} "
                        f"({w} warps)")
            ms = _best_ms(lambda: fn(*args[1], stream))
            dog.stop()
            held = ("bit-equal " + str(not smoke._hits_differ(hits, ref))
                    if name in holds else "result not held (edited)")
            print(f"march, gradients {grads}, {name}: {ms:.4f} ms, {held}"
                  f"{line}; on {gpu}", flush=True)
    del map_state


def _probe_insert(smoke, libs, gpu):
    from . import engine
    from .ops import hash_table as ht
    device = torch.device("cuda", 0)
    cfg = smoke._config()
    _, depth, color = smoke._frames(cfg.camera, device)
    state = engine.create(cfg, device=device)
    calls = []
    with smoke._recorded_hash_calls(calls):
        for i in range(12):
            state, _ = engine.step(state, depth[i], color[i], cfg)
    torch.cuda.synchronize()
    del state
    inserts = [c for c in calls if c["kind"] == "insert"]
    stream = _build.stream_ptr(device)
    for frame in (0, 11):
        a = inserts[frame]["args"]
        live, staged, chunks = ht.stage_counts(a[0], a[6], a[7])
        args, outs = ht.prepare_allocate(*a)
        kernel_args = list(args[0][:-2])

        def restore():
            for dst, src in zip(outs[:3], a[:3]):
                dst.copy_(src)

        for name, (kind, lib, fn, flags) in libs.items():
            if kind != "insert":
                continue
            ka = kernel_args if flags else kernel_args[:23] + kernel_args[24:]
            dog = _Watchdog(f"the insert, {name}")
            restore()
            if name.startswith("clock64"):
                lib.vh_cyc_zero()
            _build.check(fn(*ka, stream), "hash_alloc")
            torch.cuda.synchronize()
            same = all(torch.equal(x, y)
                       for x, y in zip(outs, inserts[frame]["out"]))
            line = ""
            if name.startswith("clock64"):
                buf = (ctypes.c_ulonglong * 8)()
                lib.vh_cyc(ctypes.byref(buf))
                c = [int(x) for x in buf]
                line = (f"; last CTA cycles: stage list {c[1] - c[0]}, "
                        f"dedup {c[2] - c[1]}, resident {c[3] - c[2]}, "
                        f"insert list and round 0 {c[4] - c[3]}, round 1 "
                        f"{c[5] - c[4] if c[5] else 0}, to the end "
                        f"{c[6] - c[0]}; grid {c[7]} ns")
            both = _best_ms(lambda: (restore(), fn(*ka, stream)))
            copies = _best_ms(restore)
            dog.stop()
            print(f"insert, frame {frame} ({live} live keys, {staged} "
                  f"staged, {chunks} chunks), {name}: {both - copies:.4f} ms "
                  f"(less the restore's {copies:.4f}), bit-equal {same}"
                  f"{line}; on {gpu}", flush=True)


def _clock_line(lib, what):
    buf = (ctypes.c_ulonglong * 8)()
    lib.vh_cyc(ctypes.byref(buf))
    c = [int(x) for x in buf]
    n = max(c[4], 1)
    return (f"; cycles a CTA (thread 0, mean of {c[4]}): "
            + ", ".join(f"{w} {c[k] / n:.0f}" for k, w in enumerate(what))
            + f"; the slowest CTA {c[5]}")


def _probe_front(smoke, libs, gpu):
    from . import engine
    from .ops import alloc_candidates as ac, preprocess as pp
    device = torch.device("cuda", 0)
    cfg = smoke._config()
    _, depth, color = smoke._frames(cfg.camera, device)
    state = engine.create(cfg, device=device)
    with smoke._recorded_candidates() as calls:
        for i in range(12):
            state, _ = engine.step(state, depth[i], color[i], cfg)
    torch.cuda.synchronize()
    del state
    stream = _build.stream_ptr(device)
    cam, flt = cfg.camera, cfg.filter
    ref = pp.preprocess_plain(depth[11], color[11], cam, flt)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grids = {f"preprocess {n}": grid for n, _, _, grid in PREPROCESS_EDITS}
    holds = {f"preprocess {n}" for n, _, keeps, _ in PREPROCESS_EDITS
             if keeps} | {"parent preprocess", "clock64 preprocess"}
    for name, (kind, lib, fn, new_entry) in libs.items():
        if kind != "preprocess":
            continue
        args, out = pp.prepare(depth[11], color[11], cam, flt)
        ka = list(args[:-2])
        grid = grids.get(name, "tiles")
        g = pp.ARG_GRID
        if new_entry and grid != "tiles":
            ka[g:g + 2] = grid
        elif not new_entry:
            ka = [a for i, a in enumerate(ka)
                  if i not in _PARENT_PREPROCESS_DROPS]
        dog = _Watchdog(f"the preprocess, {name}")
        clocked = name.startswith("clock64")
        if clocked:
            lib.vh_cyc_zero()
        _build.check(fn(*ka, stream), "preprocess")
        torch.cuda.synchronize()
        line = _clock_line(lib, ("staging", "filter", "epilogue")) \
            if clocked else ""
        ms = _graph_ms(lambda: fn(*ka, _build.stream_ptr(device)))
        dog.stop()
        same = all(smoke._bits_equal(getattr(out, f), getattr(ref, f))
                   for f in ("depth", "points", "normals", "intensity"))
        held = ("bit-equal " + str(same) if name in holds
                else f"result not held (edited; bit-equal {same})")
        shape = (f"grid {tuple(ka[g:g + 2])}" if new_entry
                 else "grid 20 x 15 (16x16 tiles)")
        print(f"preprocess, frame 11, {name}: {ms:.4f} ms, {shape} on {sms} "
              f"SMs, {held}{line}; on {gpu}", flush=True)
    call = calls[11]
    for tile in (call["tile"], 1):
        kw = {"tile": tile, "phase": call["phase"],
              "model_depth": call["model_depth"]}
        a = (call["depth"], call["pose"], call["cam"], call["cfg"])
        cref = ac.alloc_candidates_plain(*a, **kw)
        launch = {f"candidates {n}": o for n, _, _, o in CANDIDATE_EDITS}
        for name, (kind, lib, fn, new_entry) in libs.items():
            if kind != "candidates":
                continue
            args, keys = ac.prepare(*a, **kw)
            ka = list(args[:-2])
            o = launch.get(name, {})
            if not new_entry:
                ka = [x for i, x in enumerate(ka)
                      if i not in _PARENT_CANDIDATE_DROPS]
            elif tile > 1:
                if "block" in o:
                    rows, cols = ka[11:13]
                    r_, c_ = o["block"]
                    ka[ac.ARG_GRID:ac.ARG_GRID + 2] = (-(-cols // c_),
                                                       -(-rows // r_))
                ka[ac.ARG_STAGE] = o.get("stage", ka[ac.ARG_STAGE])
            dog = _Watchdog(f"the candidates, {name}")
            clocked = name.startswith("clock64")
            if clocked:
                lib.vh_cyc_zero()
            _build.check(fn(*ka, stream), "alloc_candidates")
            torch.cuda.synchronize()
            line = _clock_line(lib, ("footprint", "pool and DDA",
                                     "kb dedup", "west/north and fold")) \
                if clocked else ""
            ms = _graph_ms(lambda: fn(*ka, _build.stream_ptr(device)))
            dog.stop()
            print(f"candidates, frame 11, {'tile' if tile > 1 else 'pixel'}"
                  f" mode, {name}: {ms:.4f} ms, position for position "
                  f"{torch.equal(keys, cref)}{line}; on {gpu}", flush=True)


def _probe_bounds(smoke, libs, gpu):
    from . import geometry as geom
    from .ops import raymarch as rm
    device = torch.device("cuda", 0)
    map_state, call = _march_inputs(smoke, device)
    cam, cfg, rc = call["cam"], call["cfg"], call["rc"]
    view = geom.invert_rigid(call["pose"])
    bk, aidx, mask = map_state.block_key, call["active_idx"], \
        call["active_mask"]
    ref = rm.ray_bounds_plain(bk, aidx, mask, view, cam, cfg, rc)
    ty, tx = rm.tiles(cam, rc)
    acc = rm.reserve(device, ty * tx)
    fills = {f"bounds {n}": o.get("fill", False)
             for n, _, _, o in BOUNDS_EDITS}
    for name, (kind, lib, fn, _) in libs.items():
        if kind != "bounds":
            continue
        args, out = rm.prepare_bounds(bk, aidx, mask, view, cam, cfg, rc)
        ka = args[1]
        # the parent's kernel leaves its accumulators as it found them
        # only after a fill
        fill = fills.get(name, name.startswith("parent"))

        def once():
            if fill:
                acc.fill_(rm.IDENTITY)
            fn(*ka, _build.stream_ptr(device))

        dog = _Watchdog(f"the bounds, {name}")
        clocked = name.startswith("clock64")
        if clocked:
            lib.vh_cyc_zero()
        acc.fill_(rm.IDENTITY)
        _build.check(fn(*ka, _build.stream_ptr(device)), "raymarch")
        torch.cuda.synchronize()
        same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(out, ref))
        line = ""
        if clocked:
            buf = (ctypes.c_ulonglong * 8)()
            lib.vh_cyc(ctypes.byref(buf))
            line = _clock_line(lib, ("load chain", "projection",
                                     "shared atomics", "flush"))
            line += f"; the last CTA's tail {int(buf[6])}"
        ms = _graph_ms(once)
        dog.stop()
        acc.fill_(rm.IDENTITY)
        print(f"bounds, phase 6 frame 11 ({int(mask.sum())} active rows, "
              f"{ty * tx} tiles), {name}: {ms:.4f} ms"
              f"{' with the fill' if fill else ''}, bit-equal {same}{line}; "
              f"on {gpu}", flush=True)
    del map_state


def _probe_gc(smoke, libs, gpu):
    from . import engine
    from .ops import hash_table as ht
    device = torch.device("cuda", 0)
    cfg = smoke._config()
    _, depth, color = smoke._frames(cfg.camera, device)
    state = engine.create(cfg, device=device)
    calls = []
    with smoke._recorded_hash_calls(calls):
        for i in range(12):
            state, _ = engine.step(state, depth[i], color[i], cfg)
    torch.cuda.synchronize()
    del state
    call = [c for c in calls if c["kind"] == "gc"][11]
    a = call["args"]
    tk, bk, surf, fs, nf, nt, idx, mask, ms, mw, mcfg = a
    pools = smoke._scratch_pool(mcfg, device)
    ref = smoke._plain_gc(a, pools)
    work = ht.gc_work_counts(bk, idx, mask, ms, mw, mcfg)
    short = smoke._gc_short_list(call)["args"]
    stream = _build.stream_ptr(device)
    edited = {f"gc {n}" for n, _, keeps in GC_EDITS if not keeps}
    for name, (kind, lib, fn, _) in libs.items():
        if kind == "gc":
            args, out = ht.prepare_gc(tk, bk, surf, fs, nf, nt, *pools, idx,
                                      mask, ms, mw, mcfg)
        elif kind == "delete":
            args, out = ht.prepare_delete(*short[:6], *pools, *short[6:])
        else:
            continue
        ka = list(args[:-2])
        dog = _Watchdog(f"GC, {name}")
        clocked = name.startswith("clock64")
        if clocked:
            lib.vh_cyc_zero()
        _build.check(fn(*ka, stream), "hash_delete")
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(out, ref))
        line = ""
        if clocked:
            buf = (ctypes.c_ulonglong * 8)()
            lib.vh_cyc(ctypes.byref(buf))
            line = (_clock_line(lib, ("ticket, flags and scan", "look-back",
                                      "row work", "arrival and reset"))
                    + f"; the longest look-back {int(buf[6])}, the longest "
                      f"row work {int(buf[7])}")
        t = _graph_ms(lambda: fn(*ka, _build.stream_ptr(device)))
        dog.stop()
        what = ("the GC entry" if kind == "gc"
                else "the list entry on the plain GC's short list")
        if name in edited:
            what += "; edited, the result not held"
        print(f"GC, phase 1 frame 11 ({idx.numel()} active rows, "
              f"{work.n_culled} culled, {work.n_freed} freed), {name} "
              f"({what}): {t:.4f} ms, outputs bit-equal to the plain GC "
              f"{same}{line}; on {gpu}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose kernels run beside")
    ap.add_argument("--front-only", action="store_true",
                    help="only the preprocess and the candidates")
    ap.add_argument("--bounds-gc-only", action="store_true",
                    help="only the march's tile bounds and GC's free pass")
    args = ap.parse_args(argv)
    if args.bounds_gc_only:
        return _bounds_gc(args.parent)
    march = (_build.CSRC / "raymarch.cu").read_text()
    insert = (_build.CSRC / "hash_alloc.cu").read_text()
    sources = {}
    if not args.front_only:
        sources = {name: ("march", _edit(march, edits))
                   for name, edits, _ in MARCH_EDITS}
        sources["clock64 stamps"] = ("march", march_clocked(march))
        sources["insert as is"] = ("insert", insert)
        sources["clock64 insert"] = ("insert", insert_clocked(insert))
    pre = (_build.CSRC / "preprocess.cu").read_text()
    cand = (_build.CSRC / "alloc_candidates.cu").read_text()
    for name, edits, _, _ in PREPROCESS_EDITS:
        sources[f"preprocess {name}"] = ("preprocess", _edit(pre, edits))
    sources["clock64 preprocess"] = ("preprocess",
                                     front_clocked(pre, "preprocess"))
    for name, edits, _, _ in CANDIDATE_EDITS:
        sources[f"candidates {name}"] = ("candidates", _edit(cand, edits))
    sources["clock64 candidates"] = ("candidates",
                                     front_clocked(cand, "candidates"))
    if args.parent is not None:
        csrc = args.parent / "voxelhashing_tpu_torch" / "csrc"
        if not args.front_only:
            sources["parent"] = ("march", (csrc / "raymarch.cu").read_text())
            parent = (csrc / "hash_alloc.cu").read_text()
            sources["parent insert"] = ("insert", parent)
            sources["clock64 parent insert"] = ("insert",
                                                insert_clocked(parent))
        sources["parent preprocess"] = ("preprocess",
                                        (csrc / "preprocess.cu").read_text())
        sources["parent candidates"] = (
            "candidates", (csrc / "alloc_candidates.cu").read_text())
    _build.build()
    libs = _build_all(sources)
    smoke = ab_step._smoke()
    gpu = smoke._smi()
    if not args.front_only:
        _probe_march(smoke, libs, gpu)
        _probe_insert(smoke, libs, gpu)
    _probe_front(smoke, libs, gpu)
    return 0


def _bounds_gc(parent) -> int:
    """The tile bounds' and GC's builds (:data:`BOUNDS_EDITS`,
    :data:`GC_EDITS`, clock64 stamps), the parent checkout's beside them."""
    march = (_build.CSRC / "raymarch.cu").read_text()
    delete = (_build.CSRC / "hash_delete.cu").read_text()
    sources = {f"bounds {name}": ("bounds", _edit(march, edits))
               for name, edits, _, _ in BOUNDS_EDITS}
    sources["clock64 bounds"] = ("bounds", bounds_clocked(march))
    sources.update({f"gc {name}": ("gc", _edit(delete, edits))
                    for name, edits, _ in GC_EDITS})
    sources["clock64 gc"] = ("gc", gc_clocked(delete))
    sources["list delete"] = ("delete", delete)
    if parent is not None:
        csrc = parent / "voxelhashing_tpu_torch" / "csrc"
        sources["parent bounds"] = ("bounds",
                                    (csrc / "raymarch.cu").read_text())
        sources["parent delete"] = ("delete",
                                    (csrc / "hash_delete.cu").read_text())
    _build.build()
    libs = _build_all(sources)
    smoke = ab_step._smoke()
    gpu = smoke._smi()
    _probe_bounds(smoke, libs, gpu)
    _probe_gc(smoke, libs, gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
