"""The march's and the hash insert's variants and clock stamps, on one card.

    python -m voxelhashing_tpu_torch.kernel_probes [--parent DIR]

Builds ``csrc/raymarch.cu`` as it is and with one edit each
(:data:`MARCH_EDITS`: the windows alone, no weight reads, 8 lanes a ray,
register caps, a 512-thread CTA, clock64 stamps by phase) and
``csrc/hash_alloc.cu`` as it is and with clock64 stamps at the last CTA's
phases; with ``--parent DIR`` (another checkout of this repository) that
checkout's two sources too. At ``chip_smoke.py``'s phase-6 map (frame 10)
and frame 11's render, each march build is held against the plain
version where its edit keeps the result, and timed: 100 back-to-back
launches between CUDA events, the best of three, with and without
gradients. At phase 1's insert calls of frames 0 and 11, each insert
build is held bit for bit against the call's outputs and timed the same
way (the table clones restored before each launch; the restores alone
timed and taken off). The stamped builds print a warp's cycles by phase
(the march; lane 0 of each warp, averaged) and the last CTA's cycles by
phase (the insert), with the grid phase in ns. A launch that does not end
within 20 s stops the run. Needs one CUDA card and nvcc; the builds go to
``build/voxelhashing_tpu_torch/kernel_probes/``.
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
        fn = lib.vh_raymarch if kind == "march" else lib.vh_hash_alloc
        sig = list(_build._SIGNATURES["raymarch" if kind == "march"
                                      else "hash_alloc"][
            "vh_raymarch" if kind == "march" else "vh_hash_alloc"])
        flags = kind == "march" or "seg_flag" in sources[name][1]
        if not flags:
            sig = sig[:23] + sig[24:]       # a checkout without seg_flag
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
            _build.check(fn(*args[2], stream), "raymarch")
            torch.cuda.synchronize()
            line = ""
            if name == "clock64 stamps":
                buf = (ctypes.c_ulonglong * 8)()
                lib.vh_cyc(ctypes.byref(buf))
                w = max(int(buf[3]), 1)
                line = (f"; cycles a warp: windows {buf[0] / w:.0f}, "
                        f"secant {buf[1] / w:.0f}, hit {buf[2] / w:.0f} "
                        f"({w} warps)")
            ms = _best_ms(lambda: fn(*args[2], stream))
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose two kernels run beside")
    args = ap.parse_args(argv)
    march = (_build.CSRC / "raymarch.cu").read_text()
    insert = (_build.CSRC / "hash_alloc.cu").read_text()
    sources = {name: ("march", _edit(march, edits))
               for name, edits, _ in MARCH_EDITS}
    sources["clock64 stamps"] = ("march", march_clocked(march))
    sources["insert as is"] = ("insert", insert)
    sources["clock64 insert"] = ("insert", insert_clocked(insert))
    if args.parent is not None:
        csrc = args.parent / "voxelhashing_tpu_torch" / "csrc"
        sources["parent"] = ("march", (csrc / "raymarch.cu").read_text())
        parent = (csrc / "hash_alloc.cu").read_text()
        sources["parent insert"] = ("insert", parent)
        sources["clock64 parent insert"] = ("insert", insert_clocked(parent))
    _build.build()
    libs = _build_all(sources)
    smoke = ab_step._smoke()
    gpu = smoke._smi()
    _probe_march(smoke, libs, gpu)
    _probe_insert(smoke, libs, gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
