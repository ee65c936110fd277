#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's per-frame SLAM step on one NVIDIA GPU.

    python3 chip_smoke.py

Imports only the port (``voxelhashing_tpu_torch``), never JAX or the JAX
package. Builds the port's CUDA kernels from ``voxelhashing_tpu_torch/csrc``
and then:

1. runs ``engine.create`` and 20 calls of ``engine.step`` on the bench scene
   (five spheres, ``make_trajectory(20)``, 2 mm depth noise, seed = frame
   index) at the reference's default map capacity (zParametersDefault.txt:
   1,000,000 voxel blocks, a 2^21-slot hash table, a 32,768-block active
   cap) and the bench's real-time point (320x240, 4 mm voxels, truncation
   2 cm + 1 cm/m, online allocation, splat renderer, depth-only ICP with 3
   levels, GC on); requires ATE < 10 mm, a clean map, and that the step
   went through both kernels and the front kernels (one preprocess launch
   a frame, one candidates launch an integrated frame); reports fused
   frames/s over frames 2-19 (CUDA events) and the host syncs of one
   frame; then (``phase_front``) holds the front kernels, the depth
   preprocess (``ops/preprocess``) and the allocator's candidates
   (``ops/alloc_candidates``), against their plain versions on every frame
   (the candidates on each call as the step made it, with the phase as a
   device int32 scalar, and in pixel mode): bit for bit, the keys position
   for position; on their edge banks, which reach every instantiation
   (it raises on one the wrappers did not launch); checks the
   preprocess's clamped reciprocal division against the IEEE division on
   every float (``phase_division_check``); and times them at frame 11
   (bare, an empty kernel's node, wrapper, plain, bytes, operations,
   bound, CTAs, the preprocess's MUFU floor);
   then (``phase_hash``) holds the map's hash kernels, the insert
   (``blockmap.allocate``), GC's free pass (``integrate.garbage_collect``,
   ``hash_delete_kernel<true>``) and the list delete
   (``blockmap.delete_blocks``, ``hash_delete_kernel<false>``;
   ``ops/hash_table``), against their plain versions, bit for bit in every
   output, on every call phase 1 made (an insert and a GC a frame,
   recorded with a checksum of every active row before and after a GC,
   the rows a delete names gathered before and after it; the plain
   versions run on a zeroed scratch pool), on ``hash_table.edge_bank``
   and ``gc_bank`` and on the whole map after frame 10 (a 1,024-row
   delete: every field and the pools equal, a per-row checksum unchanged
   off the freed rows; GC past its cap, 1,500 rows culled: every field and
   the whole pools equal), and times them at frame 11 (the list delete on
   that GC call's short list);
2. holds kernel A (fused integrate) against its plain PyTorch version on
   clones of the state after frame 10 and frame 11's inputs: rows, surface
   flags and GC stats must be bit-equal (the kernels are built with
   -fmad=false); times it bare (``_bare_ms``: the wrapper's ``launch``
   replayed from a CUDA graph, with torch.profiler's device time beside
   it), through its wrapper and as the plain version, and prints the bytes
   it must move and the f32 operations it must do
   (``fused_integrate.bytes_moved`` and ``operations``, with the voxels
   whose bits it changed as the updated ones) and the bound they give at
   3.35 TB/s and 67 TFLOP/s;
3. does the same for kernel B (splat z-buffer) on the same state: the
   z-buffers must be bit-identical; and for a color render
   (``check_color``: the color walk, one 64-bit atomicMin of (z_surf bits
   << 32 | 0xFFFFFFFF - flat index) per voxel, and the per-pixel
   resolve), whose z-buffer and colors must be bit-identical to
   ``splat_zbuf_plain(with_color=True)`` and whose key buffer to
   ``splat_keys_plain`` there and on a forced tie (``_with_tie``: a
   surface row copied into a free slot with another color, listed after
   it, must win every pixel the row hits); then holds kernels A and B and
   the color render, bit for bit, on the edge cases
   (``phase_edge_cases``: n_active 0, 1 and M, a frame of edge values, a
   depth-only frame);
4. times each stage of ``engine.step`` (CUDA events at ``engine.STAGES``
   marks) over frames 3-19 of a second run, and the device's busy share
   over three frames (``torch.profiler`` kernel time against the same
   frames' unprofiled wall time); in that profile each stage runs in a
   ``record_function`` range closed after a synchronize, which splits the
   device time and the device ops by stage (the front stages' ops are the
   view and front graphs' nodes by stage), with the gc stage's device ms and ops
   on a line of their own; holds the hash kernels on every call of the
   second run (every GC among them) as phase 1's are held; phase 6 splits
   the march + RGB-D step's device time the same way;
5. runs the large scan (``scripts/bench_large_scan.py``'s scan point at
   the reference scan's 800,000-block pool, 1 cm voxels) four times, with
   ``streaming.AsyncStreamingManager`` (S) and with streaming off (U), in
   the order S U U S so that each mode runs once first and once second of
   a pair: 96 frames out along a 12 m corridor and 48 back (see
   ``_large_scan_poses``); requires stream-out, stream-in and host blocks,
   clean maps, both kernels launched on every frame of every run, and the
   first streamed run's composed whole-scene mesh
   (``meshing.extract_mesh_streamed``) and checkpoint
   (``streaming.save_map(manager=)``) equal to the first unstreamed run's;
   holds kernels A and B against their plain versions, bit for bit, on the
   state just after the first stream-in, and times them there as in 2-3;
   holds the front kernels on every frame of the first streamed run (in
   pixel mode on every 12th) and times them at frame 48; holds the hash
   kernels on every call of that run (the step's inserts and GCs, the
   stream-out deletes and the stream-in inserts) and times them at frame
   48 and at the first stream-in and stream-out;
   reports each run's frames/s on the outward leg (eviction) and on the
   return leg (stream-in), and the host syncs of one frame;
6. runs 20 frames of phase 1's scene and configuration with RGB-D
   tracking (weights 1.0 / 0.1, sigma 0.1, free tracking) twice
   (``phase_rgbd``): with the march renderer (the JAX defaults: 48 samples
   per ray, 16-pixel tiles) and with the splat renderer; each run requires
   ATE < 10 mm, every frame valid, a clean map, kernel A on every frame,
   the color render (walk and resolve) on every frame with splat and
   never with the march, kernel B never (its renders are all with color),
   and no plain kernel version called on a CUDA tensor, and
   reports fused frames/s over frames 2-19 (CUDA events), the per-stage
   table of those frames and the host syncs of one frame. The march run
   also requires one launch of each march kernel a frame (the tile
   bounds, ``ray_bounds_kernel``, and the march, ``raymarch_kernel``;
   ``ops/raymarch``) and no call of their plain versions on the card;
   splits its device time by stage as phase 4 does (frames 11-13 replayed
   from frame 10); and (``phase_march``) holds both kernels against their
   plain versions on the frame-10 map with each of the 20 renders' poses
   and active lists as the step made them (recorded around
   ``raycast.render_march``), and on ``raymarch.edge_bank``, with and
   without gradients: the tile bounds, every field of the hits and the
   rendered frame bit for bit, and the bounds on a grid of 1-pixel tiles
   (76,800, past the kernel's shared-memory path); and times them at
   frame 11's render (bare, an empty kernel's node, wrapper, plain, bytes,
   operations, bound; samples and block lookups a ray; a bounds call is
   one device op, its kernel, with no fill);
7. runs the SLAM layer at phase 1's width (``phase_slam``): an out-and-back
   trajectory (``_loop_poses``: 30 frames out along ``make_trajectory``'s
   motion and 30 back over the same poses) on the bench scene with 2 mm
   noise is written with ``io.sensfile.write_sens`` (zlib depth, shift
   1000, raw color) into a temporary directory, with one OCCI file (shift
   256) whose native and numpy decodes must be equal; then replayed through
   ``run_slam.frame_source`` and ``run_slam.SlamRun`` with ``--posegraph
   --reintegrate --histogram --timings``: at least one loop edge, ATE below
   10 mm before and after the correction (after no worse than before by
   more than 1 mm), clean invariants and a consistent ``hash_histogram`` on
   the live and the re-integrated map, kernels A and B on every live frame
   and once per re-integrated frame, no plain version on a CUDA tensor;
   kernel A bit-equal to its plain version on the re-integrated map;
   ``PoseGraph.relocalize`` from a stale pose within 1 cm and 0.01 rad;
   and 20 frames of phase 1 with ``MapConfig(bilinear_color=True)``
   (ATE below 10 mm, kernel A's bilinear variant and its color-word image
   on every frame; the image held bit for bit against
   ``integrate.frame_color_word``, the variant with its image against its
   plain version on the state after frame 10 and on the edge-value and
   depth-only frames, and timed there as in phase 2). Reports
   keyframes, edges and loops, ms per ``register`` and ``optimize``, the
   re-integration's fused frames/s, the ``TimingLog`` report and the host
   syncs of two live frames.

8. runs the multi-device path (``phase_sharded``, in ranks started with
   ``parallel.distributed.spawn``): two ranks over gloo, both on the one
   card, each with half of phase 1's capacity (500,000 blocks, a 2^20-slot
   table, a 16,384-block active cap): (a) 20 frames of phase 1's frames
   through ``sharded.make_sharded_step``, with every frame's keys owned by
   their rank and the pose and ``valid`` flag bit-equal across ranks, ATE
   < 10 mm, kernels A and B on every frame of every rank; the host syncs
   of frame 11 replayed on the state after frame 10; kernels A and B held
   bit for bit against their plain versions on rank 0's shard after frame
   10; every rank's hash calls of the run (an insert and a GC a frame)
   held against the plain versions as phase 1's are; ``gather_map`` with
   clean invariants holding every rank's blocks;
   (b) ``make_sharded_render`` at the last pose against the single-device
   march of the merged map (coverage XOR < 0.5%, depth < 1e-4 m, color <
   2/255); (d) ``ShardedStreamingManager``: ``stream_out_all`` then
   ``stream_in_all`` restores each shard's sorted rows bit for bit, and a
   partial sweep keeps every block; (c) 10 frames with splat + RGB-D (the
   color render on every rank) and 3 with the march + RGB-D (the tile
   bounds kernel on every rank, the march the distributed plain one); (e)
   ``optimize_distributed`` on phase 7's pose graph within 1e-4 of
   ``optimize``; then (f) 20 frames on one rank over NCCL (ATE < 10 mm, a
   clean map). Reports rank 0's fused frames/s, the all-reduces of a frame
   and their host time, the host syncs of one frame, and the phase's wall
   time. Two ranks on one card measure the collectives' cost, not
   scaling.
9. runs the dense voxel-grid baseline (``phase_dense``) at
   ``scripts/bench_densegrid.py``'s point (a 256^3 grid of 1 cm voxels,
   truncation 5 cm, 320x240, the wall, floor and three spheres along
   ``make_trajectory(20)`` with 2 mm noise): (a) integrate-only along the
   ground truth, ms a frame against the bound of 24 B a voxel; (b) 20
   frames of ``denseengine.make_step`` with free tracking (ATE < 50 mm,
   every frame valid, no kernel but the tracker's ICP update and no plain
   kernel version launched),
   its stage times, peak memory, and the host syncs of a tracked frame
   and of a replayed one (which must be 0); (c) ``extract_mesh`` on that
   grid (triangles > 0); (d) at the CPU tests' size, the card's grid
   bit-equal to the CPU's, and the render's difference; (e) kernel A's
   fusion of a bare wall within 1.5e-3 of the dense grid's (the dense
   oracle; its launch shows as ``dense_oracle``).
10. runs ``engine.make_step`` (``phase_graph``), the step as replays of
   captured CUDA graphs: (a) phase 1's 20 frames through
   ``make_step(donate=True)`` and twice through the eager step, in
   lockstep from one start: the eager runs must agree with each other
   and the graphs with them on every frame (poses, valid flags, every map
   field and diagnostic bit for bit; the second eager run's hash calls,
   every GC among them, held against the plain versions as phase 1's
   are), two host syncs in tracked frame 11,
   the pool's tensors kept from frame 1 on with no pool bytes copied in,
   and kernels A and B, 18 associations, 18 linearizations and 18 ICP
   updates (``icp_update``, no ``solve6``) on every tracked frame; reports frames/s of both, each graph's nodes (the
   view and front graphs' among them) and capture time, then 20 frames of
   ``make_step`` alone: frames/s, the device's busy share (torch.profiler)
   and peak memory; (b) the ICP update kernel (``ops/icp_update``, one
   launch a solve) against its plain version on frame 11's 18 updates
   (recorded from the eager step, each from the carry before it) and on
   a seeded bank of updates with every flag path
   (``icp_update.disagreements``: flags, counts and residuals equal, x
   and cond within ``solve6.disagreements``, delta within 4e-6 plus the
   solve's difference carried through the pose, nothing held within 1e-6
   of a threshold); its bare time (100 launches in one CUDA graph) beside
   an empty kernel's node timed the same way, its bound, the wrapper's
   and the plain tail's times; and its core batched (``ops/solve6``)
   against the plain SVD on frame 11's 18 systems, on a seeded bank
   (well- and ill-conditioned, rank 3) and on a non-finite system
   (``solve6.disagreements``; cond within 1e-4 of an f64 SVD), with its
   bare time, bound and ``torch.linalg.svd``'s time; and the tracker's
   pass kernels (``ops/icp_linearize``: the fused launch of a single
   device, and the split association and linearization, with and
   without the photometric rows) on frame 11's 18 iterations (recorded
   from the eager step), on frame 11 of phase 6's splat + RGB-D run and
   on ``icp_linearize.edge_bank``, three ways: the fused launch against
   the split pair (every output bit for bit) and the split pair against
   the plain versions (q, n_q, weights and flags, mean and inv_std bit
   for bit; every sum within ``icp_linearize.disagreements``, (1.01 n +
   3) 2^-24 of the sum of its terms' absolute values; counts equal), with
   each form's bare time at each level beside an empty node's, the
   bound, the wrapper's and the plain passes' times and the plain
   version's [8, P] x [P, 8] product alone, and the pass launches a
   tracked frame by path (18 fused on a single device, 18 + 18 split on
   the sharded path); (c) phase 6's two RGB-D configurations through
   ``make_step`` (ATE < 10 mm, every frame valid, two host syncs in a
   tracked frame); (d) the large scan's outward leg through
   ``make_step(with_hint=True, with_stream_mask=True)`` with
   ``AsyncStreamingManager`` (a clean map, blocks streamed out, one host
   sync a frame in the step, no pool bytes copied in); (e) maintenance
   forced by tombstones at a 65,536-block map: ``compact_pool`` runs
   between replays, the step takes the compacted pool in, and every
   frame equals the eager step's.

Any failure raises and the exit code is non-zero. There is no CPU path:
without a CUDA device the script exits 1 before it prints any result. The
line before the last holds the kernels' numbers as one JSON object; the
last line of standard output is one JSON object with the device.
``kernel_times_here`` times the kernels of whichever checkout's port
imports from the working directory (``voxelhashing_tpu_torch.ab_step``
runs it in two checkouts).
"""

import collections
import contextlib
import inspect
import json
import os
import subprocess
import sys
import threading
import time
import traceback
import warnings

N_FRAMES = 20
REPEATS = 10
ATE_LIMIT_M = 0.010
BARE_LAUNCHES = 100          # launches in one graph per bare kernel time
# H100 SXM (NVIDIA's data sheet, at 700 W): memory rate and f32 rate outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def _smi() -> str:
    """The card's name and power limit; raises when nvidia-smi cannot say."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    line = res.stdout.strip().splitlines()[0] if res.stdout.strip() else ""
    if len(line.split(",")) != 2:
        raise RuntimeError(f"nvidia-smi gave no name and power limit: "
                           f"{res.stdout!r}")
    return line


def _sm_clock_mhz() -> int:
    """The card's top SM clock (MHz); raises when nvidia-smi cannot say."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return int(res.stdout.strip().splitlines()[0])


def _config():
    from voxelhashing_tpu_torch.config import (CameraConfig, EngineConfig,
                                               MapConfig)
    mp = MapConfig(voxel_size=0.004, truncation=0.02, truncation_scale=0.01,
                   num_blocks=1_000_000, table_size=1 << 21,
                   max_active_blocks=1 << 15, gc_enabled=True)
    return EngineConfig(camera=CameraConfig(), map=mp, offline=False)


def _bench_scene():
    """The bench scene: the wall, the floor and five spheres."""
    from voxelhashing_tpu_torch.io.synthetic import Scene, Sphere
    return Scene(spheres=(
        Sphere(center=(0.0, 0.2, 1.8), radius=0.3),
        Sphere(center=(-0.5, -0.2, 2.0), radius=0.25, color=(0.2, 0.5, 0.8)),
        Sphere(center=(0.6, 0.1, 1.5), radius=0.2, color=(0.3, 0.7, 0.3)),
        Sphere(center=(0.3, -0.4, 2.2), radius=0.28, color=(0.7, 0.7, 0.2)),
        Sphere(center=(-0.3, 0.45, 1.4), radius=0.18, color=(0.6, 0.3, 0.7)),
    ))


def _frames(cam, device, poses=None, scene=None):
    """``scene`` (default the bench scene) from ``poses`` (default
    ``make_trajectory(20)``) with 2 mm depth noise, seed = frame index:
    (poses, depth with NaN as 0, color)."""
    import torch
    from voxelhashing_tpu_torch.io.synthetic import (make_trajectory,
                                                     render_depth)
    scene = _bench_scene() if scene is None else scene
    poses = make_trajectory(N_FRAMES) if poses is None else poses
    depths, colors = [], []
    for i, pose in enumerate(poses):
        d, c = render_depth(pose, cam, scene, noise_sigma=0.002, seed=i,
                            device=device)
        depths.append(torch.nan_to_num(d, nan=0.0))
        colors.append(c)
    return poses, torch.stack(depths), torch.stack(colors)


def _clone(tup):
    return type(tup)(*(t.clone() if hasattr(t, "clone") else t
                       for t in tup))


def _clone_engine(es):
    return es._replace(map=_clone(es.map), pose=es.pose.clone(),
                       frame=es.frame.clone(),
                       tracking_lost=es.tracking_lost.clone(),
                       n_integrated=es.n_integrated.clone())


def _median_ms(fn, repeats=REPEATS):
    import torch
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _bare_ms(fn, n=BARE_LAUNCHES):
    """Mean device time of one call of ``fn``, which issues its work on the
    current stream: a warm-up call, then ``n`` calls captured into one CUDA
    graph, and one CUDA event pair around a replay of it, over ``n``. The
    replay issues the launches with no host work between them, so the
    events time the device even where a kernel takes less time than the
    host needs to launch it."""
    import torch
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
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _profiled_ms(fn, kernels, n=20):
    """torch.profiler's device time per call of ``fn``, which launches each
    kernel whose name holds one of ``kernels`` (a string or a tuple of
    them) once: the sum over those kernels of each one's mean time per
    launch over ``n`` calls (None when it records none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    kernels = (kernels,) if isinstance(kernels, str) else kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA \
                and any(k in e.name for k in kernels):
            us[e.name].append(e.self_device_time_total)
    total = sum(sum(t) / len(t) for t in us.values())
    return total / 1000.0 if total > 0 else None


def _fmt(x):
    return "not measured" if x is None else f"{x:.4f}"


def _bits_equal(a, b):
    import torch
    if a.dtype in (torch.bfloat16, torch.float16):
        a, b = a.view(torch.int16), b.view(torch.int16)
    elif a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def _max_abs(a, b):
    import torch
    if a.dtype == torch.int32:                     # packed colors
        return max(float(((a >> s) & 0xFF).sub((b >> s) & 0xFF).abs().max())
                   for s in (16, 8, 0)) if a.numel() else 0.0
    a, b = a.float(), b.float()
    both = torch.isfinite(a) & torch.isfinite(b)
    diff = torch.where(both, (a - b).abs(), 0.0)
    mism = (torch.isfinite(a) != torch.isfinite(b)).any()
    return float("inf") if bool(mism) else float(diff.max())


def phase_step(cfg, device, gpu_line, hash_calls=None):
    """Phase 1: 20 frames of engine.step through both kernels (the hash
    kernels' calls recorded into ``hash_calls``, a list, when given)."""
    import torch
    from voxelhashing_tpu_torch import blockmap, engine, evaluation

    poses, depth, color = _frames(cfg.camera, device)
    state = engine.create(cfg, device=device)
    torch.cuda.synchronize()
    _zero_counts()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(N_FRAMES)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(N_FRAMES)]
    diags, est, snap = [], [], None
    t0 = time.perf_counter()
    hashed = (_recorded_hash_calls(hash_calls) if hash_calls is not None
              else contextlib.nullcontext())
    with _recorded_candidates() as calls, hashed:
        for i in range(N_FRAMES):
            starts[i].record()
            state, diag = engine.step(state, depth[i], color[i], cfg)
            ends[i].record()
            diags.append(diag)
            est.append(state.pose.clone())
            if i == 10:
                snap = _clone_engine(state)  # outside the timed events
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()

    valid = []
    for i, d in enumerate(diags):
        valid.append(bool(d.tracking_valid))
        print(f"frame {i:2d}: valid={valid[-1]} "
              f"alloc={int(d.n_allocated_blocks)} "
              f"active={int(d.n_active_blocks)} "
              f"overflow={int(d.active_overflow)} "
              f"splat_overflow={int(d.splat_overflow)} "
              f"icp_res={float(d.icp_residual):.3e} "
              f"corr={int(d.icp_corr_count)} "
              f"cond={float(d.icp_condition):.1f} "
              f"planarity={float(d.icp_planarity):.3e} "
              f"ms={starts[i].elapsed_time(ends[i]):.3f}")
    est_np = [p.cpu().numpy() for p in est]
    # (an older checkout's ate_rmse never aligns and takes no ``align``)
    unaligned = ({"align": False} if "align" in inspect.signature(
        evaluation.ate_rmse).parameters else {})
    ate = evaluation.ate_rmse(est_np, poses, **unaligned)
    viol = blockmap.check_invariants(state.map, cfg.map)
    dev_ms = sum(starts[i].elapsed_time(ends[i]) for i in range(2, N_FRAMES))
    fps = (N_FRAMES - 2) / (dev_ms / 1000.0)
    print(f"ATE RMSE: {ate * 1000:.3f} mm (limit {ATE_LIMIT_M * 1000} mm)")
    print(f"invariants: {viol}")
    print(f"launches: {launches}, valid frames: {sum(valid)}")
    print(f"fused frames/s (frames 2-{N_FRAMES - 1}, CUDA events): "
          f"{fps:.3f} on {gpu_line}; whole 20-frame loop {wall:.3f} s "
          f"host clock")
    if ate >= ATE_LIMIT_M:
        raise RuntimeError(f"ATE {ate} m >= {ATE_LIMIT_M} m")
    if any(v != 0 for v in viol.values()):
        raise RuntimeError(f"map invariants violated: {viol}")
    if launches["splat_zbuf"] != N_FRAMES:
        raise RuntimeError(f"splat_zbuf launched {launches['splat_zbuf']} "
                           f"times, expected {N_FRAMES}")
    if launches["fused_integrate"] != sum(valid):
        raise RuntimeError(
            f"fused_integrate launched {launches['fused_integrate']} times, "
            f"expected {sum(valid)} (one per valid frame)")
    off = _launches_off(launches, {**_track_launches(cfg, N_FRAMES - 1),
                                   "solve6": 0,
                                   **_front_launches(N_FRAMES, sum(valid)),
                                   **_hash_launches(sum(valid)),
                                   **_march_launches(0, 0)})
    if off:
        raise RuntimeError(f"the tracker's, the front or the hash kernels "
                           f"launched (count, expected) {off}")
    if (launches["splat_zbuf_color"] != 0
            or launches["fused_integrate_bilinear"]
            or launches["frame_color_words"]
            or any(v for k, v in launches.items() if k.startswith("plain"))):
        raise RuntimeError(f"depth-only step ran a color render, the "
                           f"bilinear variant, its color-word image or a "
                           f"plain version on the card: {launches}")
    return snap, est, depth, color, launches, fps, calls


@contextlib.contextmanager
def _sync_sites():
    """Count the host syncs made on the main thread inside the block, by
    the port's line that made each (a Counter of "file:line")."""
    import torch
    import voxelhashing_tpu_torch
    pkg = os.path.dirname(voxelhashing_tpu_torch.__file__) + os.sep
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        # one warning per synchronizing call; the mode's own notice that it
        # is a prototype is not a sync, nor is a wait of the streaming
        # worker thread
        if ("called a synchronizing CUDA operation" not in str(message)
                or threading.current_thread() is not threading.main_thread()):
            return
        ours = [f for f in traceback.extract_stack()
                if f.filename.startswith(pkg)]
        sites[f"{os.path.basename(ours[-1].filename)}:{ours[-1].lineno}"
              if ours else "?"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode("default")


def _sites_line(sites):
    return ", ".join(f"{k} x{v}" for k, v in sites.most_common())


def count_syncs(cfg, snap, depth, color):
    """Host syncs of one steady-state frame (frame 11 replayed on a clone
    of the state after frame 10), and the port's line that made each."""
    from voxelhashing_tpu_torch import engine

    s = _clone_engine(snap)
    with _sync_sites() as sites:
        engine.step(s, depth[11], color[11], cfg)
    syncs = sum(sites.values())
    print(f"host syncs in one frame: {syncs}; by site: {_sites_line(sites)}")
    return syncs


def _a_inputs(cfg, base_map, depth, color, pose, frame_idx, bitmask=None,
              key_filter=None):
    """Kernel A's inputs at a state: a clone of ``base_map`` after this
    frame's allocation (candidates masked by ``key_filter``, a rank's
    partition, and the streaming ``bitmask`` as the engine masks them),
    the preprocessed frame, and the active list at ``pose``. Returns
    (state, depth, color, active_idx, n_active)."""
    from voxelhashing_tpu_torch import blockmap, geometry as geom
    from voxelhashing_tpu_torch import integrate as integ, streaming
    from voxelhashing_tpu_torch.ops.image import preprocess

    cam, mp = cfg.camera, cfg.map
    frame = preprocess(depth, color, cam, cfg.filter)
    base = _clone(base_map)
    keys = integ.alloc_candidates(frame.depth, pose, cam, mp,
                                  tile=mp.alloc_tile, phase=frame_idx)
    if key_filter is not None:
        keys = key_filter(keys)
    if bitmask is not None:
        keys = streaming.mask_keys(keys, bitmask, mp, cfg.streaming)
    base, _ = blockmap.allocate(base, keys, mp, rounds=1)
    aidx, n_act, _ = blockmap.compactify(base, geom.invert_rigid(pose), cam,
                                         mp)
    return base, frame.depth, frame.color, aidx, n_act


def _plain_a(cfg, state, depth, color, pose, aidx, n_act):
    import torch
    from voxelhashing_tpu_torch import integrate as integ
    mask = torch.arange(aidx.shape[0], device=aidx.device) < n_act
    return integ.integrate(state, depth, color, pose, cfg.camera, cfg.map,
                           active_idx=aidx, active_mask=mask)


def hold_a(cfg, base, depth, color, pose, aidx, n_act, label,
           require_change=True):
    """Kernel A against its plain version, bit for bit, on clones of
    ``base``: rows, surface flags and both GC stats. Returns (max abs
    error, the kernel's state)."""
    import torch
    from voxelhashing_tpu_torch.ops.fused_integrate import fused_integrate

    cam, mp = cfg.camera, cfg.map
    sk, sp = _clone(base), _clone(base)
    sk, (mn_k, mx_k) = fused_integrate(sk, depth, color, pose, cam, mp,
                                       aidx, n_act)
    sp, (mn_p, mx_p) = _plain_a(cfg, sp, depth, color, pose, aidx, n_act)
    torch.cuda.synchronize()
    pairs = {"sdf": (sk.sdf, sp.sdf), "weight": (sk.weight, sp.weight),
             "color": (sk.color, sp.color), "surf": (sk.surf, sp.surf),
             "min_abs_sdf": (mn_k, mn_p), "max_weight": (mx_k, mx_p)}
    equal = {k: _bits_equal(*v) for k, v in pairs.items()}
    err = max(_max_abs(*v) for k, v in pairs.items() if k != "surf")
    changed = int((sk.weight != base.weight).any(dim=1).sum())
    print(f"{label}: active rows {int(n_act)} of {aidx.shape[0]}, rows "
          f"changed {changed}, bit-equal {equal}, max_abs_err {err}")
    if not all(equal.values()) or (require_change and changed == 0):
        raise RuntimeError(f"{label} disagrees with its plain version: "
                           f"{equal} (max abs err {err}, {changed} rows)")
    del sp
    return err, sk


def _changed_voxels(before, after, rows):
    """Voxels of ``rows`` whose stored sdf, weight or color bits differ."""
    import torch
    idx = rows.long()
    diff = torch.zeros(idx.shape[0], 512, dtype=torch.bool,
                       device=idx.device)
    for f in ("sdf", "weight", "color"):
        a, b = getattr(before, f)[idx], getattr(after, f)[idx]
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        diff |= a != b
    return int(diff.sum())


def _bound(nbytes, nops):
    """The least time (ms) for a kernel that moves ``nbytes`` and does
    ``nops`` f32 operations, and which of the two bounds it."""
    by_bytes = 1000.0 * nbytes / HBM_BYTES_PER_S
    by_ops = 1000.0 * nops / F32_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _work_a(cfg, n_rows, n_updated, max_rows, with_color):
    """The bytes kernel A (its bilinear variant and the color-word image
    with ``cfg.map.bilinear_color``) must move and the f32 operations it
    must do (``fused_integrate.bytes_moved`` and ``operations`` of this
    tree)."""
    from voxelhashing_tpu_torch.ops import fused_integrate as fa
    cam = cfg.camera
    return (fa.bytes_moved(n_rows, n_updated, max_rows, cam, with_color),
            fa.operations(n_rows, n_updated, cfg.map.bilinear_color,
                          cam.height * cam.width if with_color else 0))


def _band_voxels(cfg, map_state, aidx, has_surf):
    """The voxels of the rows ``aidx[has_surf]`` in the surface band
    (w > 0, |sdf| < voxel), the only ones kernel B projects."""
    sel = aidx.long()[has_surf]
    return int(((map_state.weight[sel].float() > 0.0)
                & (map_state.sdf[sel].float().abs() < cfg.map.voxel_size))
               .sum())


def _work_b(cfg, n_surface_rows, n_band, max_rows):
    """The bytes kernel B must move and the f32 operations it must do
    (``splat_zbuf.bytes_moved`` and ``operations`` of this tree)."""
    from voxelhashing_tpu_torch.ops import splat_zbuf as sb
    return (sb.bytes_moved(n_surface_rows, max_rows, cfg.camera),
            sb.operations(n_surface_rows, n_band))


def _work_color(cfg, n_surface_rows, n_band, n_covered, max_rows):
    """The bytes a color render (walk and resolve) must move and the f32
    operations it must do (``splat_zbuf.color_bytes_moved`` and
    ``operations`` of this tree)."""
    from voxelhashing_tpu_torch.ops import splat_zbuf as sb
    return (sb.color_bytes_moved(n_surface_rows, n_covered, max_rows,
                                 cfg.camera),
            sb.operations(n_surface_rows, n_band))


def time_a(cfg, base, depth, color, pose, aidx, n_act, label, gpu_line):
    """Kernel A's times at this state: the bare kernel (``launch`` on
    prepared arguments, ``_bare_ms``), with torch.profiler's device time as
    a cross-check, the wrapper and the plain version (``_median_ms``); the
    bytes it must move and the f32 operations it must do (``_work_a``, with
    the voxels whose stored bits one launch changed as the updated ones)
    and the bound they give. Repeated launches update the same rows in place:
    the weights grow, but which voxels update and what is read and written
    stay the same. The bilinear variant's times take in its color-word
    image, which is also timed alone ("pre_pass_ms")."""
    from voxelhashing_tpu_torch import geometry as geom
    from voxelhashing_tpu_torch.ops import fused_integrate as fa

    cam, mp = cfg.camera, cfg.map
    n = int(n_act)
    st = _clone(base)
    args, _ = fa.prepare(st, depth, color, geom.invert_rigid(pose), cam, mp,
                         aidx, n_act)
    fa.launch(args)
    n_upd = _changed_voxels(base, st, aidx[:n])
    nbytes, nops = _work_a(cfg, n, n_upd, aidx.shape[0], color is not None)
    ms = _bare_ms(lambda: fa.launch(args))
    prof_ms = _profiled_ms(lambda: fa.launch(args),
                           ("fused_integrate", "frame_color_words"))
    pre_pass = args[-2]
    pre_ms = None if pre_pass is None else _bare_ms(
        lambda: fa.launch_color_words(*pre_pass))
    wrapper_ms = _median_ms(lambda: fa.fused_integrate(
        st, depth, color, pose, cam, mp, aidx, n_act))
    del st
    sp = _clone(base)
    plain_ms = _median_ms(lambda: _plain_a(cfg, sp, depth, color, pose, aidx,
                                           n_act))
    del sp
    bound, by = _bound(nbytes, nops)
    pre = ("" if pre_ms is None else
           f", of which the color-word image alone {pre_ms:.4f} ms")
    print(f"{label}: bare {ms:.4f} ms ({BARE_LAUNCHES} launches in one CUDA "
          f"graph{pre}; torch.profiler {_fmt(prof_ms)} ms), wrapper "
          f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms; {n} rows, {n_upd} "
          f"updated voxels; {nbytes} B at {HBM_BYTES_PER_S / 1e12} TB/s, "
          f"{nops} f32 operations at {F32_OPS_PER_S / 1e12:.0f} TFLOP/s: "
          f"bound {bound:.4f} ms by {by}, {100 * bound / ms:.1f}% of it; on "
          f"{gpu_line}")
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
            "profiler_ms": prof_ms, "pre_pass_ms": pre_ms, "rows": n,
            "updated_voxels": n_upd, "bytes": nbytes, "operations": nops}


def check_kernel_a(cfg, base_map, depth, color, pose, frame_idx, label,
                   gpu_line, bitmask=None):
    """Kernel A held against its plain version and timed at this state.
    Returns (result dict, active rows int32[n])."""
    base, d, c, aidx, n_act = _a_inputs(cfg, base_map, depth, color, pose,
                                        frame_idx, bitmask)
    err, sk = hold_a(cfg, base, d, c, pose, aidx, n_act, label)
    del sk
    res = time_a(cfg, base, d, c, pose, aidx, n_act, label, gpu_line)
    res["max_abs_err"] = err
    return res, aidx[:int(n_act)]


def _b_inputs(cfg, map_state, pose):
    """Kernel B's inputs at ``pose``: (view, active_idx, surface row
    mask)."""
    import torch
    from voxelhashing_tpu_torch import blockmap, geometry as geom
    view = geom.invert_rigid(pose)
    aidx, n_act, _ = blockmap.compactify(map_state, view, cfg.camera,
                                         cfg.map)
    mask = torch.arange(aidx.shape[0], device=aidx.device) < n_act
    return view, aidx, map_state.surf[aidx.long()] & mask


def hold_b(cfg, map_state, view, aidx, has_surf, label, require_cover=True):
    """Kernel B against its plain version: the z-buffers must be
    bit-identical. Returns the max abs error."""
    import torch
    from voxelhashing_tpu_torch.ops.splat_zbuf import (splat_zbuf,
                                                       splat_zbuf_plain)
    cam, mp = cfg.camera, cfg.map
    zk = splat_zbuf(map_state, aidx, has_surf, view, cam, mp)
    zp, _ = splat_zbuf_plain(map_state, aidx, has_surf, view, cam, mp)
    torch.cuda.synchronize()
    equal = _bits_equal(zk, zp)
    err = _max_abs(zk, zp)
    covered = int(torch.isfinite(zk).sum())
    print(f"{label}: surface rows {int(has_surf.sum())} of {aidx.shape[0]}, "
          f"covered pixels {covered}/{zk.numel()}, bit-identical {equal}, "
          f"max_abs_err {err}")
    if not equal or (require_cover and covered == 0):
        raise RuntimeError(f"{label} disagrees with its plain version")
    return err


def time_b(cfg, map_state, view, aidx, has_surf, label, gpu_line):
    """Kernel B's times at this state, as ``time_a``; the voxels that pass
    every test, each of which issues one atomic; and, as a partial
    yardstick only, PyTorch's
    ``scatter_reduce_(amin)`` over the plain version's targets (it does B's
    final scatter, not the projection and band test before it)."""
    import torch
    from voxelhashing_tpu_torch.ops import splat_zbuf as sb

    cam, mp = cfg.camera, cfg.map
    args, _ = sb.prepare(map_state, aidx, has_surf, view, cam, mp)
    ms = _bare_ms(lambda: sb.launch(args))
    prof_ms = _profiled_ms(lambda: sb.launch(args), "splat_zbuf")
    wrapper_ms = _median_ms(lambda: sb.splat_zbuf(map_state, aidx, has_surf,
                                                  view, cam, mp))
    plain_ms = _median_ms(lambda: sb.splat_zbuf_plain(map_state, aidx,
                                                      has_surf, view, cam,
                                                      mp))
    _, pix, z_surf, ok = sb.splat_targets(map_state, aidx, has_surf, view,
                                          cam, mp)
    survivors = int(ok.sum())
    buf = torch.full((cam.height * cam.width + 1,), torch.inf,
                     device=aidx.device)
    pix, z_surf = pix.reshape(-1), z_surf.reshape(-1)
    scatter_ms = _bare_ms(lambda: buf.scatter_reduce_(0, pix, z_surf, "amin",
                                                      include_self=True))
    n_surf = int(has_surf.sum())
    band = _band_voxels(cfg, map_state, aidx, has_surf)
    nbytes, nops = _work_b(cfg, n_surf, band, aidx.shape[0])
    bound, by = _bound(nbytes, nops)
    print(f"{label}: bare {ms:.4f} ms ({BARE_LAUNCHES} launches in one CUDA "
          f"graph; torch.profiler {_fmt(prof_ms)} ms), wrapper "
          f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms; {n_surf} surface "
          f"rows, {band} voxels in the band, {survivors} pass every test "
          f"and issue {survivors} atomics; {nbytes} B at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s, {nops} f32 operations at "
          f"{F32_OPS_PER_S / 1e12:.0f} TFLOP/s: bound {bound:.4f} ms by "
          f"{by}, {100 * bound / ms:.1f}% of it; partial yardstick "
          f"scatter_reduce_(amin) alone {scatter_ms:.4f} ms; on {gpu_line}")
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
            "profiler_ms": prof_ms, "rows": n_surf, "band_voxels": band,
            "survivors": survivors, "bytes": nbytes,
            "operations": nops, "scatter_reduce_ms": scatter_ms}


def check_kernel_b(cfg, map_state, pose, label, gpu_line):
    """Kernel B held against its plain version and timed over the surface
    rows that ``pose`` sees. Returns the result dict."""
    view, aidx, has_surf = _b_inputs(cfg, map_state, pose)
    err = hold_b(cfg, map_state, view, aidx, has_surf, label)
    res = time_b(cfg, map_state, view, aidx, has_surf, label, gpu_line)
    res["max_abs_err"] = err
    return res


def _edge_frame(depth, color, cfg):
    """A frame with the values the in-kernel color word and depth tests
    can get wrong, in stripes over ``depth``/``color``: one channel NaN,
    +inf, -inf, -0.25, -0.0, 1.5, exactly 1.0 or 254.5/255, or all three
    exactly 1.0; depth NaN, 0, exactly ``max_integration_distance`` and
    beyond it on every 16th row of four."""
    import math
    d, c = depth.clone(), color.clone()
    vals = (math.nan, math.inf, -math.inf, -0.25, -0.0, 1.5, 1.0,
            254.5 / 255.0)
    groups = len(vals) + 1
    for g, v in enumerate(vals):
        c[:, 4 * g::4 * groups, g % 3] = v
    c[:, 4 * len(vals)::4 * groups, :] = 1.0
    far = cfg.map.max_integration_distance
    for k, v in enumerate((math.nan, 0.0, far, far + 0.25)):
        d[k::16, :] = v
    return d, c


def phase_edge_cases(cfg, base_map, depth, color, pose, frame_idx):
    """Kernels A and B and the color render held bit for bit on the cases
    the persistent row walk and the in-kernel color word can get wrong:
    n_active 0, 1 and M (a full active list: every allocated row of the
    map), the edge-value frame, and a depth-only frame (no color)."""
    import torch
    from voxelhashing_tpu_torch import blockmap, geometry as geom

    mp = cfg.map
    base, d, c, aidx, n_act = _a_inputs(cfg, base_map, depth, color, pose,
                                        frame_idx)
    dev = aidx.device
    view = geom.invert_rigid(pose)
    all_idx, n_all = blockmap.compactify_all(base, mp)
    full = all_idx[:int(n_all)].contiguous()
    ed, ec = _edge_frame(d, c, cfg)
    cases = (
        ("n_active=0", d, c, aidx, torch.zeros((), dtype=torch.int32,
                                               device=dev)),
        ("n_active=1", d, c, aidx, torch.ones((), dtype=torch.int32,
                                              device=dev)),
        (f"n_active=M={full.shape[0]}", d, c, full, n_all.to(torch.int32)),
        ("edge-value frame", ed, ec, aidx, n_act),
        ("depth-only frame", d, None, aidx, n_act),
    )
    for name, dd, cc, ai, na in cases:
        _, sk = hold_a(cfg, base, dd, cc, pose, ai, na, f"edge A, {name}",
                       require_change=int(na) > 1)
        mask = torch.arange(ai.shape[0], device=dev) < na
        hold_b(cfg, sk, view, ai, sk.surf[ai.long()] & mask,
               f"edge B, {name}", require_cover=False)
        if name.startswith("n_active"):
            hold_color(cfg, sk, view, ai, sk.surf[ai.long()] & mask,
                       f"edge color render, {name}", require_cover=False)
        del sk


# ---------------------------------------------------------------------------
# The front kernels: the depth preprocess and the allocator's candidates
# ---------------------------------------------------------------------------

def _front_launches(n_preprocessed, n_integrated):
    """The front kernels' launches: one preprocess a preprocessed frame,
    one candidates launch an integrated frame."""
    return {"preprocess": n_preprocessed, "alloc_candidates": n_integrated}


@contextlib.contextmanager
def _recorded_candidates():
    """The inputs of every ``integrate.alloc_candidates`` call made inside
    the block, as dicts (by reference: the eager step writes none of them
    again); the calls run and count as they do. A checkout before the
    candidates kernel records nothing."""
    from voxelhashing_tpu_torch import integrate as integ
    calls = []
    real = getattr(integ, "_candidates", None)
    if real is None:
        yield calls
        return

    class _Recorder:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def alloc_candidates(depth, pose, cam, cfg, tile=1, phase=None,
                             model_depth=None):
            calls.append({"depth": depth, "pose": pose, "cam": cam,
                          "cfg": cfg, "tile": tile, "phase": phase,
                          "model_depth": model_depth})
            return real.alloc_candidates(depth, pose, cam, cfg, tile=tile,
                                         phase=phase,
                                         model_depth=model_depth)

    integ._candidates = _Recorder()
    try:
        yield calls
    finally:
        integ._candidates = real


def hold_preprocess(depth, color, cam, flt, label):
    """The preprocess kernel against its plain version: the filtered
    depth, points, normals and intensity bit for bit. Returns the max abs
    error over the finite values (0 when bit-equal)."""
    import torch
    from voxelhashing_tpu_torch.ops import preprocess as pp
    got = pp.preprocess_depth(depth, color, cam, flt)
    ref = pp.preprocess_plain(depth, color, cam, flt)
    torch.cuda.synchronize()
    fields = ["depth", "points", "normals"]
    if ref.intensity is not None or got.intensity is not None:
        fields.append("intensity")
    bad = [f for f in fields
           if getattr(got, f) is None or getattr(ref, f) is None
           or not _bits_equal(getattr(got, f), getattr(ref, f))]
    if bad:
        raise RuntimeError(f"{label}: the preprocess kernel differs from "
                           f"its plain version in {bad}")
    return max(_max_abs(getattr(got, f), getattr(ref, f)) for f in fields)


def hold_candidates(call, label, tile=None, device_phase=False):
    """The candidates kernel against its plain version on a recorded call
    (``_recorded_candidates``; ``tile`` overrides its tile, 1 for pixel
    mode; ``device_phase`` gives its phase as a device int32 scalar): the
    flat keys equal position for position. Returns the valid keys."""
    import torch
    from voxelhashing_tpu_torch.geometry import INVALID_KEY
    from voxelhashing_tpu_torch.ops import alloc_candidates as ac
    phase = call["phase"]
    if device_phase and phase is not None \
            and not isinstance(phase, torch.Tensor):
        phase = torch.tensor(phase, dtype=torch.int32,
                             device=call["depth"].device)
    args = (call["depth"], call["pose"], call["cam"], call["cfg"])
    kw = {"tile": call["tile"] if tile is None else tile, "phase": phase,
          "model_depth": call["model_depth"]}
    got = ac.alloc_candidates(*args, **kw)
    ref = ac.alloc_candidates_plain(*args, **kw)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.equal(got, ref):
        n = int((got != ref).sum()) if got.shape == ref.shape else -1
        raise RuntimeError(f"{label}: the candidates kernel differs from "
                           f"its plain version at {n} of {ref.numel()} "
                           f"positions (tile {kw['tile']}, phase {phase})")
    return int((ref != INVALID_KEY).sum())


def _hold_front_frames(cfg, depth, color, calls, label, pixel_every=1):
    """Both front kernels held bit for bit on every frame: the preprocess
    on each frame's inputs, the candidates on each recorded call as the
    step made it, with its phase as a device int32 scalar, and (every
    ``pixel_every``-th call) in pixel mode. Returns (max abs error, keys
    held)."""
    err, keys = 0.0, 0
    for i in range(depth.shape[0]):
        err = max(err, hold_preprocess(depth[i], color[i], cfg.camera,
                                       cfg.filter, f"{label}, frame {i}"))
    for i, call in enumerate(calls):
        keys += hold_candidates(call, f"{label}, call {i}")
        if call["tile"] > 1 and call["phase"] is not None:
            hold_candidates(call, f"{label}, call {i}, device phase",
                            device_phase=True)
        if i % pixel_every == 0:
            keys += hold_candidates(call, f"{label}, call {i}, pixel mode",
                                    tile=1)
    print(f"{label}: preprocess kernel bit-equal on {depth.shape[0]} "
          f"frames, candidates kernel position for position on "
          f"{len(calls)} calls (as the step made them, with the phase on "
          f"the device, and in pixel mode on every {pixel_every}-th): "
          f"{keys} valid keys held")
    return err, keys


def phase_front_edge_banks(device):
    """Both front kernels held bit for bit on their edge banks
    (``preprocess.edge_bank``, ``alloc_candidates.edge_bank``): the
    candidates in tile and pixel mode, at each phase as a host int and as
    a device int32 scalar, with novelty on and off."""
    import torch
    from voxelhashing_tpu_torch.ops import alloc_candidates as ac
    from voxelhashing_tpu_torch.ops import preprocess as pp
    for e in pp.edge_bank():
        d, c = pp.edge_frame(e, device)
        err = hold_preprocess(d, c, e["cam"], e["flt"],
                              f"edge preprocess, {e['case']}")
        kernel = pp.KERNELS[pp.kernel_index(e["flt"])]
        print(f"edge preprocess, {e['case']} ({e['cam'].width}x"
              f"{e['cam'].height}, {kernel}): bit-equal, max_abs_err {err}")
    for e in ac.edge_bank():
        base = {"depth": torch.from_numpy(e["depth"]).to(device),
                "pose": torch.from_numpy(e["pose"]).to(device),
                "cam": e["cam"], "cfg": e["cfg"]}
        md = torch.from_numpy(e["model_depth"]).to(device)
        n, keys = 0, 0
        for tile in (1, e["tile"]):
            for phase in e["phases"]:
                for model in (None, md):
                    call = dict(base, tile=tile, phase=phase,
                                model_depth=model)
                    lbl = f"edge candidates, {e['case']}"
                    keys += hold_candidates(call, lbl)
                    n += 1
                    if phase is not None:
                        hold_candidates(call, lbl, device_phase=True)
                        n += 1
        staged = ("staged" if e["tile"] <= ac.STAGE_TILE
                  else "from global memory")
        print(f"edge candidates, {e['case']} ({e['cam'].width}x"
              f"{e['cam'].height}, tile {e['tile']} {staged}, "
              f"{e['cfg'].alloc_steps} steps, folds "
              f"{e['cfg'].alloc_fold_tile}/{e['cfg'].alloc_fold}): {n} calls "
              f"position for position, {keys} valid keys")


def phase_division_check(cfg, device):
    """The preprocess kernel's division of each tap's x = diff^2 by c = 2
    sigma_r^2 (``range_weight`` in ``csrc/preprocess.cu``: x clamped into
    ``preprocess.division_clamp``, then ``div_rn_recip``) against the IEEE
    division on the card over every f32 x in [0, +inf] (2,139,095,041
    values), at each c that the config and the edge bank take: raises on
    any x where the tap's weight differs from expf(-(x / c)), where
    div_rn_recip differs from x / c on its range, or where expf(-x) is not
    1 for x <= 2^-26 or not 0 for x >= 128 (the clamp's two claims)."""
    import numpy as np
    import torch
    from voxelhashing_tpu_torch.ops import _build
    from voxelhashing_tpu_torch.ops import preprocess as pp
    flts = [cfg.filter] + [e["flt"] for e in pp.edge_bank()]
    cs = sorted({float(np.float32(pp.two_sr2(f))) for f in flts
                 if f.depth_filter})
    lib = _build.library("preprocess")
    what = ("weights differ", "quotients differ in its range",
            "expf(-x) not 1 at x <= 2^-26", "expf(-x) not 0 at x >= 128")
    for c in cs:
        out = torch.zeros(4, dtype=torch.int64, device=device)
        y = float(np.float32(1.0) / np.float32(c))
        flt = next(f for f in flts if f.depth_filter
                   and float(np.float32(pp.two_sr2(f))) == c)
        lo, hi = pp.division_clamp(flt)
        t0 = time.perf_counter()
        _build.check(lib.vh_preprocess_check_division(
            c, y, lo, hi, _build.ptr(out), _build.stream_ptr(device)),
            "preprocess")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = [int(v) for v in out.cpu().numpy()]
        print(f"division at c = {c!r} (y = {y!r}, clamp [{lo!r}, {hi!r}]): "
              f"every f32 x in [0, +inf] on the card in {secs:.3f} s: "
              + ", ".join(f"{k} {w}" for k, w in zip(n, what)))
        if any(n):
            raise RuntimeError(f"the preprocess's division fails on the "
                               f"card at c = {c}: {dict(zip(what, n))}")
    return cs


def time_front(cfg, depth, color, call, label, gpu_line):
    """Each front kernel's times at one frame: bare (``launch`` on prepared
    arguments, ``_bare_ms``), an empty kernel's node timed alike, the
    wrapper and the plain version (``_median_ms``); the bytes it must move,
    the operations it must do (``preprocess.work_counts``,
    ``alloc_candidates.work_counts``: this frame's valid taps, points and
    normals; its valid rays and live DDA steps) and the bound they give.
    The candidates are also timed in pixel mode on the same frame.
    Returns {"preprocess", "alloc_candidates", "alloc_candidates_pixel"}."""
    import torch
    from voxelhashing_tpu_torch.ops import alloc_candidates as ac
    from voxelhashing_tpu_torch.ops import icp_update as iu
    from voxelhashing_tpu_torch.ops import preprocess as pp

    cam, flt = cfg.camera, cfg.filter
    saved = _counts()
    out = {}
    args, frame = pp.prepare(depth, color, cam, flt)
    launched = {"preprocess": args}
    pp.launch(args)
    torch.cuda.synchronize()
    with_int = frame.intensity is not None
    work = pp.work_counts(depth, cam, flt, frame)
    out["preprocess"] = {
        "ms": _bare_ms(lambda: pp.launch(args)),
        "wrapper_ms": _median_ms(lambda: pp.preprocess_depth(depth, color,
                                                             cam, flt)),
        "plain_ms": _median_ms(lambda: pp.preprocess_plain(depth, color,
                                                           cam, flt)),
        "bytes": pp.bytes_moved(depth.numel(), with_int),
        "operations": pp.operations(*work), "work": work}
    for key, tile in (("alloc_candidates", call["tile"]),
                      ("alloc_candidates_pixel", 1)):
        kw = {"tile": tile, "phase": call["phase"],
              "model_depth": call["model_depth"]}
        a = (call["depth"], call["pose"], call["cam"], call["cfg"])
        c_args, keys = ac.prepare(*a, **kw)
        launched[key] = c_args
        ac.launch(c_args)
        torch.cuda.synchronize()
        work = ac.work_counts(*a, **kw)
        novelty = work[-1]
        out[key] = {
            "ms": _bare_ms(lambda: ac.launch(c_args)),
            "wrapper_ms": _median_ms(lambda: ac.alloc_candidates(*a, **kw)),
            "plain_ms": _median_ms(
                lambda: ac.alloc_candidates_plain(*a, **kw)),
            "bytes": ac.bytes_moved(depth.numel(), keys.numel(), novelty),
            "operations": ac.operations(*work), "work": work[:4]}
    empty = _bare_ms(lambda: iu.launch_empty(depth.device))
    torch.cuda.synchronize()
    _set_counts(saved)
    sms = torch.cuda.get_device_properties(depth.device).multi_processor_count
    # the CTAs and the instantiation as the timed launches passed them
    for key, mod in (("preprocess", pp), ("alloc_candidates", ac),
                     ("alloc_candidates_pixel", ac)):
        a_ = launched[key]
        gx, gy = a_[mod.ARG_GRID:mod.ARG_GRID + 2]
        out[key]["ctas"] = gx * gy
        out[key]["kernels"] = [mod.KERNELS[a_[mod.ARG_KERNEL]]]
        print(f"{key} ({label}): {gx} x {gy} = {gx * gy} CTAs on {sms} SMs, "
              f"{out[key]['kernels'][0]}")
    # the preprocess's MUFU floor: libdevice expf's ex2, one a valid tap
    # (the division has none), 16 an SM a clock at the card's top SM clock
    mhz = _sm_clock_mhz()
    taps = out["preprocess"]["work"][0]
    print(f"preprocess MUFU floor ({label}): {taps} valid taps, one ex2 "
          f"each, 16 an SM a clock on {sms} SMs at {mhz} MHz: "
          f"{1000.0 * taps / (16 * sms * mhz * 1e6):.6f} ms")
    for key, r in out.items():
        r["bound_ms"], r["bound_by"] = _bound(r["bytes"], r["operations"])
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["empty_ms"] = empty
        print(f"{key} timing ({label}): bare {r['ms']:.4f} ms "
              f"({BARE_LAUNCHES} launches in one CUDA graph), an empty "
              f"kernel's node {empty:.4f} ms; wrapper {r['wrapper_ms']:.4f} "
              f"ms; plain {r['plain_ms']:.4f} ms; {r['bytes']} B at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s, {r['operations']} operations "
              f"at {F32_OPS_PER_S / 1e12:.0f} TFLOP/s (work {r['work']}): "
              f"bound {r['bound_ms']:.6f} ms by {r['bound_by']}, "
              f"{100 * r['bound_share']:.1f}% of it; on {gpu_line}")
    return out


def phase_front(cfg, depth, color, calls, gpu_line):
    """The front kernels on phase 1's frames: held on every frame and on
    the edge banks, and timed at frame 11. Returns the timings with the
    max abs error."""
    from voxelhashing_tpu_torch.ops import alloc_candidates as ac
    from voxelhashing_tpu_torch.ops import preprocess as pp
    # the instantiations the wrappers launch while the kernels are held
    tallies = (pp.preprocess_depth.by_kernel, ac.alloc_candidates.by_kernel)
    for t in tallies:
        t.clear()
    err, _ = _hold_front_frames(cfg, depth, color, calls,
                                "front kernels (phase 1)")
    phase_front_edge_banks(depth.device)
    reached = {k for t in tallies for k, n in t.items() if n}
    every = set(pp.KERNELS) | set(ac.KERNELS)
    print(f"front kernel instantiations launched and held on the card: "
          f"{dict(sorted((k, n) for t in tallies for k, n in t.items()))}")
    if reached != every:
        raise RuntimeError(f"front instantiations not held: "
                           f"{sorted(every - reached)}")
    phase_division_check(cfg, depth.device)
    times = time_front(cfg, depth[11], color[11], calls[11],
                       "phase 1, frame 11", gpu_line)
    for r in times.values():
        r["max_abs_err"] = err
    return times


# ---------------------------------------------------------------------------
# The map's hash writes: the insert and the delete kernels
# ---------------------------------------------------------------------------

def _hash_launches(n_integrated, rounds=1, gc=True, stream_outs=0):
    """The hash kernels' launches in ``n_integrated`` integrated frames:
    one insert launch a round of allocation, one GC launch
    (``hash_delete_kernel<true>``) a frame, one list delete
    (``hash_delete_kernel<false>``) a stream-out."""
    return {"hash_insert": n_integrated * rounds,
            "hash_gc": n_integrated if gc else 0,
            "hash_delete": stream_outs}


def _row_sums(pools, rows, chunk=4096):
    """A checksum of each pool row in ``rows`` (int64 [len(rows)]): the
    sdf, weight and color words times fixed odd multipliers, summed; 0 for
    a zeroed row. On the device, no host read; ``chunk`` rows at a time,
    so that the temporaries stay small."""
    import torch
    mult = torch.arange(1, 2 * 512, 2, dtype=torch.int64,
                        device=rows.device)
    out = torch.zeros(rows.shape, dtype=torch.int64, device=rows.device)
    for j in range(0, rows.numel(), chunk):
        for k, p in enumerate(pools):
            r = p[rows[j:j + chunk]]
            r = r.view(torch.int16) if r.dtype == torch.bfloat16 else r
            out[j:j + chunk] += (r.to(torch.int64) * (mult + 1024 * k)).sum(1)
    return out


@contextlib.contextmanager
def _recorded_hash_calls(calls):
    """Record every hash insert, GC and delete made through ``blockmap``
    inside the block into ``calls`` (dicts), with the call's outputs.
    Inputs and outputs by reference: nothing writes them again, but
    ``surf`` (which kernel A updates in place) is cloned, and so are GC's
    active list and stats; the pool rows a delete names are gathered just
    before and just after it, and a checksum of every active row is taken
    just before and just after a GC (both zero rows in place; no host
    read). A checkout before the hash kernels records nothing; one before
    the GC entry records its GC calls as deletes."""
    from voxelhashing_tpu_torch import blockmap
    real = getattr(blockmap, "_hash", None)
    if real is None:
        yield calls
        return

    class _Recorder:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def allocate(tk, tv, bk, fs, nf, du, keys, cfg, rounds=2):
            out = real.allocate(tk, tv, bk, fs, nf, du, keys, cfg, rounds)
            calls.append({"kind": "insert", "args": (tk, tv, bk, fs, nf, du,
                                                     keys, cfg, rounds),
                          "out": out})
            return out

        @staticmethod
        def garbage_collect(tk, bk, surf, fs, nf, nt, sdf, weight, color,
                            idx, mask, min_sdf, max_w, cfg):
            rows = idx.long()
            before = _row_sums((sdf, weight, color), rows)
            args = (tk, bk, surf.clone(), fs, nf, nt, idx.clone(),
                    mask.clone(), min_sdf.clone(), max_w.clone(), cfg)
            out = real.garbage_collect(tk, bk, surf, fs, nf, nt, sdf,
                                       weight, color, idx, mask, min_sdf,
                                       max_w, cfg)
            calls.append({"kind": "gc", "args": args, "before": before,
                          "after": _row_sums((sdf, weight, color), rows),
                          "out": out[:2] + (out[2].clone(),) + out[3:]})
            return out

        @staticmethod
        def delete_blocks(tk, bk, surf, fs, nf, nt, sdf, weight, color, idx,
                          mask, cfg):
            rows = idx.long()
            before = (sdf[rows], weight[rows], color[rows])
            surf_in = surf.clone()
            out = real.delete_blocks(tk, bk, surf, fs, nf, nt, sdf, weight,
                                     color, idx, mask, cfg)
            calls.append({"kind": "delete",
                          "args": (tk, bk, surf_in, fs, nf, nt, idx, mask,
                                   cfg),
                          "before": before,
                          "after": (sdf[rows], weight[rows], color[rows]),
                          "out": out[:2] + (out[2].clone(),) + out[3:]})
            return out

    blockmap._hash = _Recorder()
    try:
        yield calls
    finally:
        blockmap._hash = real


def _scratch_pool(cfg, device):
    """Zeroed sdf, weight and color pools of ``cfg``'s size, for the plain
    delete (which zeroes rows in place) away from the live map."""
    import torch
    n = cfg.num_blocks
    return (torch.zeros((n, 512), dtype=torch.bfloat16, device=device),
            torch.zeros((n, 512), dtype=torch.bfloat16, device=device),
            torch.zeros((n, 512), dtype=torch.int32, device=device))


def _plain_insert(args):
    from voxelhashing_tpu_torch import blockmap
    tk, tv, bk, fs, nf, du, keys, cfg, rounds = args
    st, n = blockmap.allocate_plain(blockmap.MapState(
        tk, tv, bk, None, None, None, None, fs, nf, None, du), keys, cfg,
        rounds)
    return (st.table_key, st.table_val, st.block_key, st.n_free,
            st.dense_upto, n)


def _plain_delete(args, pools):
    from voxelhashing_tpu_torch import blockmap
    tk, bk, surf, fs, nf, nt, idx, mask, cfg = args
    st = blockmap.delete_blocks_plain(blockmap.MapState(
        tk, None, bk, *pools, surf, fs, nf, nt, None), idx, mask, cfg)
    return (st.table_key, st.block_key, st.surf, st.free_stack, st.n_free,
            st.n_tombstones)


def _plain_gc(args, pools):
    from voxelhashing_tpu_torch import blockmap, integrate
    tk, bk, surf, fs, nf, nt, idx, mask, min_sdf, max_w, cfg = args
    st = integrate.garbage_collect_plain(blockmap.MapState(
        tk, None, bk, *pools, surf, fs, nf, nt, None), idx, mask, cfg,
        cached_stats=(min_sdf, max_w))
    return (st.table_key, st.block_key, st.surf, st.free_stack, st.n_free,
            st.n_tombstones)


INSERT_FIELDS = ("table_key", "table_val", "block_key", "n_free",
                 "dense_upto", "count")
DELETE_FIELDS = ("table_key", "block_key", "surf", "free_stack", "n_free",
                 "n_tombstones")


def hold_hash_calls(calls, label):
    """The hash kernels against their plain versions on recorded calls
    (``_recorded_hash_calls``): every output bit for bit; for a delete, the
    plain version runs on a zeroed scratch pool holding the named rows as
    they were before the call, and the named rows after it must equal the
    kernel's; for a GC (``garbage_collect_plain`` on the recorded stats,
    on a zeroed scratch pool), every active row's checksum after the call
    is 0 where the plain version freed the row and as before elsewhere
    (the kernel writes only rows its active list names, so these are the
    only rows of the pools it can change). Returns the counts held."""
    import torch
    saved = _counts()
    pools, held = None, collections.Counter()
    for i, c in enumerate(calls):
        if c["kind"] == "insert":
            ref, names = _plain_insert(c["args"]), INSERT_FIELDS
            held["insert"] += 1
            held["keys"] += int((c["args"][6] != 0x7FFFFFFF).sum())
            held["inserted"] += int(c["out"][5])
        elif c["kind"] == "gc":
            if pools is None:
                pools = _scratch_pool(c["args"][-1], c["args"][0].device)
            ref, names = _plain_gc(c["args"], pools), DELETE_FIELDS
            rows = c["args"][6].long()
            freed = (c["args"][1][rows] != 0x7FFFFFFF) \
                & (ref[1][rows] == 0x7FFFFFFF)
            want = torch.where(freed, 0, c["before"])
            if not torch.equal(want, c["after"]):
                raise RuntimeError(
                    f"{label}, call {i}: the GC kernel's pool rows differ "
                    f"from its plain version's in "
                    f"{int((want != c['after']).sum())} active rows")
            held["gc"] += 1
            held["gc_freed"] += int(ref[4] - c["args"][4])
        else:
            if pools is None:
                pools = _scratch_pool(c["args"][-1], c["args"][0].device)
            rows = c["args"][6].long()
            for p, b in zip(pools, c["before"]):
                p[rows] = b
            ref, names = _plain_delete(c["args"], pools), DELETE_FIELDS
            bad_rows = [n for n, p, a in zip(("sdf", "weight", "color"),
                                             pools, c["after"])
                        if not _bits_equal(p[rows], a)]
            for p in pools:
                p[rows] = 0
            if bad_rows:
                raise RuntimeError(f"{label}, call {i}: the delete kernel's "
                                   f"rows {bad_rows} differ from its plain "
                                   f"version's")
            held["delete"] += 1
            held["freed"] += int(ref[4] - c["args"][4])
        bad = [n for n, a, b in zip(names, c["out"], ref)
               if not torch.equal(a, b)]
        if bad:
            raise RuntimeError(f"{label}, call {i} ({c['kind']}): the "
                               f"kernel differs from its plain version in "
                               f"{bad}")
    torch.cuda.synchronize()
    if pools is not None and any(int(torch.count_nonzero(p)) for p in pools):
        raise RuntimeError(f"{label}: the plain delete wrote rows it was not "
                           f"given")
    _set_counts(saved)
    print(f"{label}: hash kernels bit-equal to their plain versions on "
          f"{held['insert']} insert calls ({held['keys']} valid keys, "
          f"{held['inserted']} blocks allocated), {held['gc']} GC calls "
          f"({held['gc_freed']} rows freed, every active row's pool rows "
          f"held) and {held['delete']} delete calls ({held['freed']} rows "
          f"freed)")
    return dict(held)


def phase_hash_edge_bank(device):
    """Both hash kernels against their plain versions on every
    ``hash_table.edge_bank`` call, from one state on the card: every map
    field, the pool rows included, and the count bit for bit; an insert
    launch a round, a delete launch a call; the empty list raises."""
    import torch
    from voxelhashing_tpu_torch import blockmap
    from voxelhashing_tpu_torch.ops import hash_table as ht
    saved = _counts()
    for e in ht.edge_bank():
        kind, cfg, a, b = e["op"]
        st = ht.edge_state(e, device)
        idx = torch.from_numpy(a).to(device)
        if a.size == 0:
            try:
                blockmap.allocate(st, idx, cfg, rounds=b)
            except (ValueError, RuntimeError) as err:
                print(f"edge hash, {e['case']}: the empty list raises, as "
                      f"in the plain version ({err})")
                continue
            raise RuntimeError("edge hash: an empty key list did not raise")
        n0 = (ht.allocate.launches, ht.delete_blocks.launches)
        if kind == "allocate":
            got, n = blockmap.allocate(_clone(st), idx, cfg, rounds=b)
            ref, n_ref = blockmap.allocate_plain(_clone(st), idx, cfg,
                                                 rounds=b)
            launched, what = ht.allocate.launches - n0[0], int(n_ref)
            ok = int(n) == what and launched == b
        else:
            mask = torch.from_numpy(b).to(device)
            got = blockmap.delete_blocks(_clone(st), idx, mask, cfg)
            ref = blockmap.delete_blocks_plain(_clone(st), idx, mask, cfg)
            launched = ht.delete_blocks.launches - n0[1]
            what = int(ref.n_free - st.n_free)
            ok = launched == 1
        torch.cuda.synchronize()
        bad = [f for f in blockmap.MapState._fields
               if not _bits_equal(getattr(got, f), getattr(ref, f))]
        print(f"edge hash, {e['case']} ({kind}, {a.size} entries, table "
              f"{cfg.table_size}): {launched} launches, "
              f"{'allocated' if kind == 'allocate' else 'freed'} {what}, "
              f"fields that differ {bad}")
        if bad or not ok:
            raise RuntimeError(f"edge hash, {e['case']}: {bad}, launches "
                               f"{launched}")
    _set_counts(saved)


def check_hash_snapshot(cfg, map_state, gpu_line):
    """The delete kernel on a whole map (phase 1's state after frame 10):
    a GC-sized list of 1,024 allocated rows with the first 700 kept, on
    two clones, kernel and plain version: every field bit for bit, the
    whole pools equal, and a per-row checksum of the kernel's pool
    unchanged on every row but the freed ones, which are zero."""
    import torch
    from voxelhashing_tpu_torch import blockmap
    from voxelhashing_tpu_torch.geometry import INVALID_KEY
    mp, dev = cfg.map, map_state.block_key.device
    rows = torch.nonzero(map_state.block_key != INVALID_KEY).flatten()
    idx = rows[::max(1, rows.numel() // 1024)][:1024].to(torch.int32)
    mask = torch.arange(idx.numel(), device=dev) < 700
    g = torch.Generator(device="cpu").manual_seed(0)
    mult = torch.randint(1, 1 << 20, (3, 512), generator=g,
                         dtype=torch.int64).to(dev)

    def checksums(st):
        return sum((p.view(torch.int16) if p.dtype == torch.bfloat16
                    else p).to(torch.int64).mul(m).sum(1)
                   for p, m in zip((st.sdf, st.weight, st.color), mult))

    saved = _counts()
    sk, sp = _clone(map_state), _clone(map_state)
    before = checksums(sk)
    sk = blockmap.delete_blocks(sk, idx, mask, mp)
    sp = blockmap.delete_blocks_plain(sp, idx, mask, mp)
    after = checksums(sk)
    torch.cuda.synchronize()
    _set_counts(saved)
    freed = torch.zeros_like(before, dtype=torch.bool)
    freed[idx[mask].long()] = True
    bad = [f for f in blockmap.MapState._fields
           if not _bits_equal(getattr(sk, f), getattr(sp, f))]
    moved = int(((before != after) & ~freed).sum())
    nonzero = int((after[freed] != 0).sum())
    print(f"hash delete (phase 1 map, {int(mask.sum())} of {idx.numel()} "
          f"rows freed): fields that differ from the plain version {bad}, "
          f"rows changed outside the list {moved}, freed rows not zero "
          f"{nonzero}; on {gpu_line}")
    if bad or moved or nonzero:
        raise RuntimeError("hash delete on the phase-1 map disagrees")


def time_hash(insert, delete, label, gpu_line, gc=None):
    """Each hash kernel's times on a recorded call: bare (``_bare_ms``; the
    insert reads and writes its table, so each of its launches is preceded
    by a copy that restores it, timed alone and taken off), an empty
    kernel's node, the wrapper (clones included) and the plain version
    (``_median_ms``); the bytes and operations of the call
    (``hash_table.work_counts`` on the insert's first round,
    ``delete_work_counts``, ``gc_work_counts``) and the bound they give.
    The delete and GC run on a scratch pool. Returns {"hash_insert",
    "hash_delete", "hash_gc"} (each None without its call)."""
    import torch
    from voxelhashing_tpu_torch.ops import hash_table as ht
    from voxelhashing_tpu_torch.ops import icp_update as iu
    saved = _counts()
    out = {"hash_insert": None, "hash_delete": None, "hash_gc": None}
    dev = None
    if insert is not None:
        a = insert["args"]
        dev = a[0].device
        args, outs = ht.prepare_allocate(*a)

        def restore():
            for dst, src in zip(outs[:3], a[:3]):
                dst.copy_(src)

        restore()
        ht.launch_allocate(args[0])
        torch.cuda.synchronize()
        work = ht.work_counts(a[6], outs[5])
        live, staged, chunks = ht.stage_counts(a[0], a[6], a[7])
        both = _bare_ms(lambda: (restore(), ht.launch_allocate(args[0])))
        copies = _bare_ms(restore)
        out["hash_insert"] = {
            "ms": both - copies, "copy_ms": copies,
            "wrapper_ms": _median_ms(lambda: ht.allocate(*a)),
            "plain_ms": _median_ms(lambda: _plain_insert(a)),
            "bytes": ht.bytes_moved(work), "operations": ht.operations(work),
            "work": tuple(work), "rounds": a[8],
            "stage": {"live": live, "staged": staged, "chunks": chunks}}
    if delete is not None:
        a = delete["args"]
        dev = a[0].device
        pools = _scratch_pool(a[-1], dev)
        tk, bk, surf, fs, nf, nt, idx, mask, cfg = a
        args, _ = ht.prepare_delete(tk, bk, surf, fs, nf, nt, *pools, idx,
                                    mask, cfg)
        work = ht.delete_work_counts(bk, idx, mask)
        out["hash_delete"] = {
            "ms": _bare_ms(lambda: ht.launch_delete(args)),
            "wrapper_ms": _median_ms(lambda: ht.delete_blocks(
                tk, bk, surf, fs, nf, nt, *pools, idx, mask, cfg)),
            "plain_ms": _median_ms(lambda: _plain_delete(a, pools)),
            "bytes": ht.bytes_moved(work), "operations": ht.operations(work),
            "work": tuple(work)}
        del pools
    if gc is not None:
        a = gc["args"]
        dev = a[0].device
        pools = _scratch_pool(a[-1], dev)
        tk, bk, surf, fs, nf, nt, idx, mask, ms, mw, cfg = a
        args, _ = ht.prepare_gc(tk, bk, surf, fs, nf, nt, *pools, idx, mask,
                                ms, mw, cfg)
        work = ht.gc_work_counts(bk, idx, mask, ms, mw, cfg)
        nodes = _graph_node_count(lambda: ht.garbage_collect(
            tk, bk, surf, fs, nf, nt, *pools, idx, mask, ms, mw, cfg))
        if nodes != 5:
            raise RuntimeError(f"a GC call captured {nodes} graph nodes, "
                               f"expected its four clones and one kernel")
        out["hash_gc"] = {
            "graph_nodes": nodes,
            "ms": _bare_ms(lambda: ht.launch_gc(args)),
            "wrapper_ms": _median_ms(lambda: ht.garbage_collect(
                tk, bk, surf, fs, nf, nt, *pools, idx, mask, ms, mw, cfg)),
            "plain_ms": _median_ms(lambda: _plain_gc(a, pools)),
            "bytes": ht.bytes_moved(work), "operations": ht.operations(work),
            "work": tuple(work)}
        del pools
    empty = (_bare_ms(lambda: iu.launch_empty(dev)) if dev is not None
             else None)
    torch.cuda.synchronize()
    _set_counts(saved)
    for key, r in out.items():
        if r is None:
            continue
        r["bound_ms"], r["bound_by"] = _bound(r["bytes"], r["operations"])
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["empty_ms"] = empty
        extra = ""
        if key == "hash_gc":
            extra = (f" (a whole call captured into a CUDA graph: "
                     f"{r['graph_nodes']} nodes, the four clones and the "
                     f"kernel)")
        if key == "hash_insert":
            st = r["stage"]
            extra = (f" (a round of {r['rounds']}, less its table restore "
                     f"{r['copy_ms']:.4f} ms; {st['live']} live keys, "
                     f"{st['staged']} staged: {st['chunks']} live "
                     f"chunk(s) of {ht.ALLOC_THREADS} a round)")
        print(f"{key} timing ({label}): bare {r['ms']:.4f} ms{extra} "
              f"({BARE_LAUNCHES} launches in one CUDA graph), an empty "
              f"kernel's node {empty:.4f} ms; wrapper {r['wrapper_ms']:.4f} "
              f"ms; plain {r['plain_ms']:.4f} ms; {r['bytes']} B at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s, {r['operations']} operations "
              f"at {F32_OPS_PER_S / 1e12:.0f} TFLOP/s (work {r['work']}): "
              f"bound {r['bound_ms']:.6f} ms by {r['bound_by']}, "
              f"{100 * r['bound_share']:.2f}% of it; on {gpu_line}")
    return out


def phase_gc_bank(device):
    """The GC entry against ``garbage_collect_plain`` on every
    ``hash_table.gc_bank`` call, from one state on the card: every map
    field and the whole pools bit for bit, one launch a call, its ticket
    and status words back at 0."""
    import torch
    from voxelhashing_tpu_torch import integrate
    from voxelhashing_tpu_torch.ops import hash_table as ht
    saved = _counts()
    for e in ht.gc_bank():
        st, idx, mask, ms, mw = ht.gc_inputs(e, device)
        n0 = ht.garbage_collect.launches
        got = integrate.garbage_collect(_clone(st), idx, mask, e["cfg"],
                                        cached_stats=(ms, mw))
        ref = integrate.garbage_collect_plain(_clone(st), idx, mask,
                                              e["cfg"], cached_stats=(ms, mw))
        torch.cuda.synchronize()
        launched = ht.garbage_collect.launches - n0
        res = ht.reserve(device, e["cfg"])
        bad = [f for f in type(st)._fields
               if not _bits_equal(getattr(got, f), getattr(ref, f))]
        print(f"edge GC, {e['case']} ({idx.numel()} active rows, "
              f"{-(-idx.numel() // ht.GC_ROWS)} CTAs): {launched} launch, "
              f"freed {int(ref.n_free - st.n_free)}, fields that differ "
              f"{bad}")
        if bad or launched != 1 or bool(res.status.any()) \
                or bool(res.ticket.any()):
            raise RuntimeError(f"edge GC, {e['case']}: {bad}, launches "
                               f"{launched}, status words or ticket left")
    _set_counts(saved)


def check_gc_cap(cfg, map_state, gpu_line):
    """GC past its cap on the phase-1 map (after frame 10): an active list
    of every allocated row (up to the active cap), stats made to cull 1,500
    of them (the rest kept), on two clones, the GC entry and
    ``garbage_collect_plain``: every field bit for bit, the whole pools
    equal, and ``gc_delete_cap`` rows freed."""
    import torch
    from voxelhashing_tpu_torch import integrate
    from voxelhashing_tpu_torch.geometry import INVALID_KEY
    mp, dev = cfg.map, map_state.block_key.device
    rows = torch.nonzero(map_state.block_key != INVALID_KEY).flatten()
    idx = rows[:mp.max_active_blocks].to(torch.int32)
    m = idx.numel()
    mask = torch.ones(m, dtype=torch.bool, device=dev)
    g = torch.Generator(device="cpu").manual_seed(1)
    cull = torch.randperm(m, generator=g)[:1500].to(dev)
    ms = torch.zeros(m, dtype=torch.float32, device=dev)
    mw = torch.ones(m, dtype=torch.float32, device=dev)
    ms[cull[:750]] = 1.0
    mw[cull[750:]] = 0.0
    saved = _counts()
    sk, sp = _clone(map_state), _clone(map_state)
    sk = integrate.garbage_collect(sk, idx, mask, mp, cached_stats=(ms, mw))
    sp = integrate.garbage_collect_plain(sp, idx, mask, mp,
                                         cached_stats=(ms, mw))
    torch.cuda.synchronize()
    _set_counts(saved)
    bad = [f for f in type(sk)._fields
           if not _bits_equal(getattr(sk, f), getattr(sp, f))]
    freed = int(sp.n_free - map_state.n_free)
    print(f"hash GC past its cap (phase 1 map, {m} active rows, 1500 "
          f"culled, cap {mp.gc_delete_cap}): fields that differ from the "
          f"plain version (the whole pools included) {bad}, rows freed "
          f"{freed}; on {gpu_line}")
    if bad or freed != min(mp.gc_delete_cap, m):
        raise RuntimeError("hash GC past its cap disagrees")


def phase_hash(cfg, map_state, calls, gpu_line):
    """The hash kernels on phase 1: held on every recorded call (an insert
    and a GC a frame), on the edge bank, the GC bank, on the whole phase-1
    map after frame 10 and past GC's cap there, and timed on frame 11's
    calls (the list delete on the GC call's short list, as the plain GC
    builds it). Returns the timings with the calls held."""
    inserts = [c for c in calls if c["kind"] == "insert"]
    gcs = [c for c in calls if c["kind"] == "gc"]
    deletes = [c for c in calls if c["kind"] == "delete"]
    if len(inserts) != N_FRAMES or len(gcs) != N_FRAMES or deletes:
        raise RuntimeError(f"phase 1 recorded {len(inserts)} inserts, "
                           f"{len(gcs)} GC calls and {len(deletes)} list "
                           f"deletes, expected {N_FRAMES}, {N_FRAMES} and 0")
    held = hold_hash_calls(calls, "hash kernels (phase 1)")
    device = map_state.block_key.device
    phase_hash_edge_bank(device)
    phase_gc_bank(device)
    check_hash_snapshot(cfg, map_state, gpu_line)
    check_gc_cap(cfg, map_state, gpu_line)
    times = time_hash(inserts[11], _gc_short_list(gcs[11]),
                      "phase 1, frame 11", gpu_line, gc=gcs[11])
    for r in times.values():
        r["max_abs_err"] = 0.0
        r["held"] = held
    return times


def _gc_short_list(call):
    """A recorded GC call as the list delete the plain GC makes of it: its
    ``gc_delete_cap`` short list and mask, for timing the list entry on
    GC's work."""
    import torch
    from voxelhashing_tpu_torch import blockmap
    from voxelhashing_tpu_torch.ops import hash_table as ht
    tk, bk, surf, fs, nf, nt, idx, mask, ms, mw, cfg = call["args"]
    t = ht.gc_threshold(cfg)
    cull = mask & ((ms >= t) | (mw == 0.0))
    dcap = min(cfg.gc_delete_cap, idx.numel())
    rank = blockmap._rank(cull)
    keep = cull & (rank < dcap)
    short = blockmap.put(torch.zeros((dcap,), dtype=torch.int32,
                                     device=idx.device), rank, idx, keep)
    n = torch.clamp(blockmap._isum(cull), max=dcap)
    return {"args": (tk, bk, surf, fs, nf, nt, short,
                     torch.arange(dcap, device=idx.device) < n, cfg)}


def phase_stages(cfg, depth, color, device, gpu_line):
    """Phase 4: per-stage time of ``engine.step`` and the device's busy
    share; the hash kernels held on every call of its 20 frames (the
    recording's own work lands in the gc and alloc stages of the
    per-stage table, not in the device split, which replays frames
    17-19 unrecorded). Returns {stage: ms/frame}, with the device's
    kernel ms and ops per frame under "device_ms" and "device_ops"."""
    import torch
    from voxelhashing_tpu_torch import engine

    frames = range(N_FRAMES - 3, N_FRAMES)
    state = engine.create(cfg, device=device)
    per_stage = collections.defaultdict(float)
    n_timed, before = 0, None
    hash_calls = []
    for i in range(N_FRAMES):
        events = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        mark("start")
        with _recorded_hash_calls(hash_calls):
            state, _ = engine.step(state, depth[i], color[i], cfg, mark=mark)
        torch.cuda.synchronize()
        if i >= 3:
            n_timed += 1
            for (_, a), (stage, b) in zip(events, events[1:]):
                per_stage[stage] += a.elapsed_time(b)
        if i == frames[0] - 1:
            before = _clone_engine(state)
    total = sum(per_stage.values())
    print(f"stages, ms/frame over frames 3-{N_FRAMES - 1} (CUDA events "
          f"between engine.step marks) on {gpu_line}:")
    for stage in engine.STAGES:
        ms = per_stage[stage] / n_timed
        share = 100 * per_stage[stage] / total
        print(f"  {stage:10s} {ms:9.3f} ms {share:6.1f}%")
    print(f"  {'total':10s} {total / n_timed:9.3f} ms")

    held = hold_hash_calls(hash_calls, "hash kernels (phase 4)")
    if held.get("gc", 0) != N_FRAMES:
        raise RuntimeError(f"phase 4: {held.get('gc', 0)} GC calls held, "
                           f"expected {N_FRAMES}")
    del hash_calls
    dev = _device_stages(cfg, before, depth, color, frames,
                         "depth only", gpu_line)
    gc_ms, gc_ops = dev["split"]["gc"]
    print(f"gc stage (phase 4, depth only): {gc_ms:.4f} device ms and "
          f"{gc_ops:.1f} device ops a frame (torch.profiler, frames "
          f"{frames[0]}-{frames[-1]}), apart from integrate "
          f"({dev['split']['integrate'][0]:.4f} ms, "
          f"{dev['split']['integrate'][1]:.1f} ops) and maintain "
          f"({dev['split']['maintain'][0]:.4f} ms, "
          f"{dev['split']['maintain'][1]:.1f} ops); on {gpu_line}")
    return {**{stage: per_stage[stage] / n_timed for stage in engine.STAGES},
            "device_ms": dev["device_ms"], "device_ops": dev["device_ops"],
            "device_split": dev["split"]}


def _device_stages(cfg, before, depth, color, frames, label, gpu_line):
    """The device's busy share and its time and ops by stage over
    ``frames`` of ``engine.step`` replayed from ``before`` (the state
    before the first of them): the frames' unprofiled wall time, then a
    torch.profiler run with each stage in a ``record_function`` range
    closed after a synchronize. Returns {"device_ms", "device_ops",
    "busy", "split"} a frame."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from voxelhashing_tpu_torch import engine

    s = _clone_engine(before)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in frames:
        s, _ = engine.step(s, depth[i], color[i], cfg)
    torch.cuda.synchronize()
    wall_ms = 1000 * (time.perf_counter() - t0)
    s = _clone_engine(before)
    torch.cuda.synchronize()
    ranges = _StageRanges(engine.STAGES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in frames:
            ranges.start()
            s, _ = engine.step(s, depth[i], color[i], cfg, mark=ranges.mark)
            ranges.end()
        torch.cuda.synchronize()
    # (a record_function range may also show as a device-side annotation)
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.name.startswith("stage:")]
    dev_ms = sum(e.self_device_time_total for e in ops) / 1000
    n = len(frames)
    print(f"device: {dev_ms / n:.3f} ms of kernels and {len(ops) / n:.0f} "
          f"device ops per frame (torch.profiler), {wall_ms / n:.3f} ms "
          f"wall per frame unprofiled: busy {100 * dev_ms / wall_ms:.1f}% "
          f"(frames {frames[0]}-{frames[-1]}, replayed; {label}) on "
          f"{gpu_line}")
    split = _device_split(prof, ops, engine.STAGES, n)
    front = ("preprocess", "compactify", "render", "track")
    print(f"device time by stage ({label}), ms/frame (torch.profiler, "
          f"frames "
          f"{frames[0]}-{frames[-1]}, each stage in a record_function range "
          f"that ends in a synchronize) on {gpu_line}:")
    for stage in engine.STAGES + ("other",):
        ms, k = split[stage]
        print(f"  {stage:10s} {ms:9.3f} ms {100 * ms / max(dev_ms / n, 1e-9):6.1f}%"
              f" {k:8.1f} device ops")
    front_ops = sum(split[st][1] for st in front)
    print(f"  front stages ({', '.join(front)}): "
          f"{sum(split[st][0] for st in front):.3f} ms, {front_ops:.0f} "
          f"device ops a frame, the view and front graphs' nodes by stage "
          f"({', '.join(f'{st} {split[st][1]:.0f}' for st in front)})")
    return {"device_ms": dev_ms / n, "device_ops": len(ops) / n,
            "busy": dev_ms / wall_ms, "split": split}


class _StageRanges:
    """``engine.step``'s ``mark`` for the profiler: each stage's work in a
    ``record_function`` range ``stage:<name>``, closed after a synchronize
    so that the stage's kernels run inside it; what follows the last mark
    goes into ``stage:other``."""

    def __init__(self, stages):
        self.stages = tuple(stages)
        self._rf = None

    def _open(self, name):
        from torch.profiler import record_function
        self._rf = record_function(f"stage:{name}")
        self._rf.__enter__()

    def _close(self):
        import torch
        torch.cuda.synchronize()
        self._rf.__exit__(None, None, None)
        self._rf = None

    def start(self):
        self._open(self.stages[0])

    def mark(self, stage):
        self._close()
        k = self.stages.index(stage) + 1
        self._open(self.stages[k] if k < len(self.stages) else "other")

    def end(self):
        self._close()


def _device_split(prof, ops, stages, n_frames):
    """{stage: (device ms a frame, device ops a frame)} of ``ops`` (the
    profile's device events) by the ``stage:`` range whose time holds each
    op's start, and "other" for the ops after a step's last mark or in no
    range."""
    import bisect
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end,
                    e.name[len("stage:"):]) for e in prof.events()
                   if e.name.startswith("stage:")
                   and e.device_type == DeviceType.CPU)
    starts = [sp[0] for sp in spans]
    out = {st: [0.0, 0] for st in tuple(stages) + ("other",)}
    for e in ops:
        k = bisect.bisect_right(starts, e.time_range.start) - 1
        st = "other"
        if k >= 0 and e.time_range.start < spans[k][1]:
            st = spans[k][2]
        out[st][0] += e.self_device_time_total / 1000
        out[st][1] += 1
    return {st: (ms / n_frames, k / n_frames) for st, (ms, k) in out.items()}


# phase 5: the large scan, streamed
LS_OUT = 96             # frames out along the corridor, 12 cm/frame
LS_BACK = 48            # frames back, 24 cm/frame, facing up and back
LS_SYNC_FRAME = 48      # the frame whose host syncs are counted


def _large_scan_config():
    """``scripts/bench_large_scan.py``'s scan point (320x240, 1 cm voxels,
    truncation 3 cm + 1 cm/m, online allocation, GT-trajectory replay,
    streaming with 1 m chunks, radius 3.4 m, 8 out parts, a 257^3 grid) at
    the reference scan's 800,000-block pool with a 2^21-slot table."""
    from voxelhashing_tpu_torch.config import (CameraConfig, EngineConfig,
                                               MapConfig, MeshConfig,
                                               StreamingConfig)
    mp = MapConfig(voxel_size=0.01, truncation=0.03, truncation_scale=0.01,
                   num_blocks=800_000, table_size=1 << 21,
                   max_active_blocks=1 << 14)
    return EngineConfig(camera=CameraConfig(), map=mp,
                        streaming=StreamingConfig(enabled=True, radius=3.4,
                                                  chunk_size=1.0,
                                                  out_parts=8),
                        # room for the whole scan's mesh (~3M triangles at
                        # 1 cm), so that neither mesh is cut
                        mesh=MeshConfig(max_triangles=1 << 24),
                        offline=False, use_trajectory=True)


def _corridor():
    """The 12 m corridor: the wall at z = 2.2 and 20 spheres 0.6 m apart."""
    from voxelhashing_tpu_torch.io.synthetic import Scene, Sphere
    return Scene(wall_z=2.2, spheres=tuple(
        Sphere(center=(0.6 * k, 0.15 * ((k % 3) - 1), 1.5 + 0.2 * (k % 2)),
               radius=0.22, color=(0.2 + 0.05 * (k % 7), 0.5, 0.8))
        for k in range(20)))


def _large_scan_poses():
    """Frames 0-95 face the wall and move 12 cm/frame along +x (0 to
    11.4 m). Frames 96-143 walk back at 24 cm/frame (11.16 m to -0.12 m)
    with the camera turned 135 degrees about x, facing up and back: it sees
    only empty space, so nothing is fused (the streamed map must equal the
    unstreamed one, and a fused frame would need chunks that are still on
    the host), while the sphere chunks near the path come back to the
    device (the whole-chunk test of ``pop_in_sphere``)."""
    import numpy as np
    a = 0.75 * np.pi
    back = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                     [0, np.sin(a), np.cos(a)]], np.float32)
    poses = []
    for i in range(LS_OUT + LS_BACK):
        p = np.eye(4, dtype=np.float32)
        if i < LS_OUT:
            p[0, 3] = 0.12 * i
        else:
            p[:3, :3] = back
            p[0, 3] = 0.12 * (LS_OUT - 1) - 0.24 * (i - LS_OUT + 1)
        poses.append(p)
    return poses


def _scan_run(cfg, poses, depth, color, device, mgr, gpu_line, label,
              record=False):
    """One pass of the scan through ``engine.step`` (and ``mgr.step`` when
    streaming). Returns a dict: the final state, the kernel launches of the
    run, frames/s over outward frames 2-95 but the sync-counted one (fused
    frames, stream-out) and over the return frames 96-143 (nothing fused,
    stream-in), the host syncs of that frame, the host store's size after
    the outward leg, (streamed) a snapshot taken just after the first
    stream-in and (``record``) the candidates' and the hash kernels'
    recorded calls, and the hash kernels' launches."""
    import torch
    from voxelhashing_tpu_torch import engine
    from voxelhashing_tpu_torch.geometry import INVALID_KEY
    from voxelhashing_tpu_torch.ops.fused_integrate import fused_integrate
    from voxelhashing_tpu_torch.ops.splat_zbuf import splat_zbuf

    n = len(poses)
    state = engine.create(cfg, initial_pose=poses[0], device=device)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    mids = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    sites, host_after_out, snap = None, None, None
    host_ms = [0.0] * n
    torch.cuda.synchronize()
    front = [(name, fn, attr) for name, fn, attr in _counters()
             if name in ("preprocess", "alloc_candidates")
             and hasattr(fn, attr)]
    hashk = [(name, fn, attr) for name, fn, attr in _counters()
             if name in ("hash_insert", "hash_delete", "hash_gc")
             and hasattr(fn, attr)]
    for _, fn, attr in front + hashk:
        setattr(fn, attr, 0)
    fused_integrate.launches = 0
    splat_zbuf.launches = 0
    recording = (_recorded_candidates() if record
                 else contextlib.nullcontext([]))
    hash_calls = []
    hash_rec = (_recorded_hash_calls(hash_calls) if record
                else contextlib.nullcontext())
    t0 = time.perf_counter()
    with recording as calls, hash_rec:
        for i, pose in enumerate(poses):
            ctx = (_sync_sites() if i == LS_SYNC_FRAME
                   else contextlib.nullcontext())
            with ctx as counted:
                starts[i].record()
                state, _ = engine.step(
                    state, depth[i], color[i], cfg, pose_hint=pose,
                    stream_bitmask=None if mgr is None else mgr.bitmask)
                mids[i].record()
                keys_before = blocks_in = None
                if mgr is not None:
                    if i >= LS_OUT and snap is None:
                        keys_before = state.map.block_key.clone()
                        blocks_in = mgr.blocks_in
                    h0 = time.perf_counter()
                    state = state._replace(map=mgr.step(state.map,
                                                        pose[:3, 3]))
                    host_ms[i] = 1000 * (time.perf_counter() - h0)
                ends[i].record()
            if counted is not None:
                sites = counted
            if i == LS_OUT - 1 and mgr is not None:
                mgr.flush()
                host_after_out = mgr.host_block_count()
            if blocks_in is not None and mgr.blocks_in > blocks_in:
                new_rows = torch.nonzero(
                    (state.map.block_key != INVALID_KEY)
                    & (keys_before == INVALID_KEY))
                snap = (i, _clone(state.map), mgr.bitmask.clone(),
                        new_rows.reshape(-1).to(torch.int32))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_integrate": fused_integrate.launches,
                "splat_zbuf": splat_zbuf.launches,
                **{name: getattr(fn, attr) for name, fn, attr in front}}
    syncs = sum(sites.values())
    fps = {}
    for leg, timed in (("out", [i for i in range(2, LS_OUT)
                                if i != LS_SYNC_FRAME]),
                       ("back", list(range(LS_OUT, n)))):
        k = len(timed)
        fps[leg] = k / (sum(starts[i].elapsed_time(ends[i])
                            for i in timed) / 1000.0)
        step_ms = sum(starts[i].elapsed_time(mids[i]) for i in timed) / k
        stream_ms = sum(mids[i].elapsed_time(ends[i]) for i in timed) / k
        but = f" but {LS_SYNC_FRAME}" if leg == "out" else ""
        print(f"large scan {label}, {leg} (frames {timed[0]}-{timed[-1]}"
              f"{but}, CUDA events): {fps[leg]:.3f} frames/s on {gpu_line}: "
              f"engine.step {step_ms:.3f} ms/frame, streaming step "
              f"{stream_ms:.3f} ms/frame "
              f"({sum(host_ms[i] for i in timed) / k:.3f} ms/frame on the "
              f"host clock)")
    print(f"large scan {label}: {n} frames in {wall:.3f} s host clock; "
          f"launches {launches}; host syncs of frame {LS_SYNC_FRAME} on the "
          f"main thread: {syncs} ({_sites_line(sites)})")
    return {"state": state, "launches": launches, "fps": fps,
            "syncs": syncs, "host_after_out": host_after_out, "snap": snap,
            "calls": calls, "hash_calls": hash_calls,
            "hash": {name: getattr(fn, attr) for name, fn, attr in hashk}}


def _sorted_rows(keys, *rows):
    import numpy as np
    o = np.argsort(keys, kind="stable")
    return [keys[o]] + [r[o] for r in rows]


def _sorted_tris(tris):
    import numpy as np
    flat = tris.reshape(len(tris), -1)
    return flat[np.lexsort(flat.T[::-1])]


def _hold_scan_hash(calls, gpu_line):
    """The hash kernels on the first streamed scan run's recorded calls:
    held on every call, then timed at frame 48's insert and GC and at the
    first stream-in insert and the first stream-out delete that frees
    rows. Returns (the counts held, the timings)."""
    import torch
    held = hold_hash_calls(calls, "hash kernels (large scan, streamed)")
    step_ins = [c for c in calls if c["kind"] == "insert"
                and c["args"][8] == 1]
    stream_ins = [c for c in calls if c["kind"] == "insert"
                  and c["args"][8] > 1]
    gc = [c for c in calls if c["kind"] == "gc"]
    out_del = [c for c in calls if c["kind"] == "delete"
               and c["args"][6].numel() == 4096
               and bool(torch.any(c["args"][7]))]
    if len(step_ins) != LS_OUT + LS_BACK or len(gc) != LS_OUT + LS_BACK \
            or not stream_ins or not out_del:
        raise RuntimeError(f"large scan: {len(step_ins)} step inserts, "
                           f"{len(gc)} GC calls, {len(stream_ins)} stream-in "
                           f"inserts, {len(out_del)} stream-out deletes that "
                           f"free rows")
    times = time_hash(step_ins[LS_SYNC_FRAME], None,
                      f"large scan, frame {LS_SYNC_FRAME}", gpu_line,
                      gc=gc[LS_SYNC_FRAME])
    stream = time_hash(stream_ins[0], out_del[0],
                       "large scan, the first stream-in and stream-out",
                       gpu_line)
    del calls[:]
    torch.cuda.empty_cache()
    return held, {"step": times, "stream": stream}


def phase_large_scan(device, gpu_line):
    """Phase 5: the scan with ``AsyncStreamingManager`` (S) and with
    streaming off (U), run S U U S; both kernels launched every frame of
    every run, stream-out, stream-in and host blocks > 0, clean maps, the
    first S run's composed mesh and checkpoint equal to the first U run's,
    and kernels A and B held against their plain versions on the state
    just after a stream-in."""
    import tempfile
    import numpy as np
    import torch
    from voxelhashing_tpu_torch import blockmap, meshing, streaming
    from voxelhashing_tpu_torch.io.synthetic import render_depth

    cfg = _large_scan_config()
    mp = cfg.map
    scene = _corridor()
    poses = _large_scan_poses()
    frames = [render_depth(p, cfg.camera, scene, noise_sigma=0.002, seed=i,
                           device=device) for i, p in enumerate(poses)]
    depth = torch.stack([torch.nan_to_num(d, nan=0.0) for d, _ in frames])
    color = torch.stack([c for _, c in frames])
    del frames
    n_frames = len(poses)
    print(f"large scan: {n_frames} frames ({LS_OUT} out, {LS_BACK} back), "
          f"{mp.num_blocks} blocks, {mp.voxel_size * 1000:.0f} mm voxels")

    # S U U S: each mode once first and once second of a pair; the checks
    # below use the first pair
    runs, mgrs = [], []
    try:
        for k, streamed in enumerate((True, False, False, True)):
            mgr = None
            if streamed:
                mgr = streaming.AsyncStreamingManager(mp, cfg.streaming,
                                                      device=device)
                mgrs.append(mgr)
            label = (f"{'streamed' if streamed else 'unstreamed'} "
                     f"(run {k + 1} of 4)")
            r = _scan_run(cfg, poses, depth, color, device, mgr, gpu_line,
                          label, record=k == 0)
            if mgr is not None:
                mgr.flush()
            if any(v != n_frames for v in r["launches"].values()):
                raise RuntimeError(f"large scan {label}: launches "
                                   f"{r['launches']}, expected {n_frames} "
                                   f"of each kernel")
            # an insert and a GC a frame; streamed, a stream-out delete a
            # frame and the stream-in inserts
            h = r["hash"]
            print(f"large scan {label}: hash kernel launches {h}")
            if h and (h["hash_delete"] != (n_frames if streamed else 0)
                      or h.get("hash_gc", n_frames) != n_frames
                      or h["hash_insert"] < n_frames
                      or (not streamed and h["hash_insert"] != n_frames)):
                raise RuntimeError(f"large scan {label}: hash launches {h}")
            if k == 0:
                hash_held, hash_times = _hold_scan_hash(
                    r.pop("hash_calls"), gpu_line)
            if k >= 2:      # the second pair is timed only
                del r["state"], r["snap"]
            runs.append(r)
        mgr = mgrs[0]
        st_s, st_u = runs[0]["state"], runs[1]["state"]
        host_out, snap = runs[0]["host_after_out"], runs[0]["snap"]
        print(f"large scan streaming: blocks out {mgr.blocks_out}, blocks "
              f"in {mgr.blocks_in}, host blocks after the outward leg "
              f"{host_out}, at the end {mgr.host_block_count()}")
        if not (mgr.blocks_out > 0 and mgr.blocks_in > 0 and host_out > 0):
            raise RuntimeError("large scan: no stream-out, stream-in or "
                               "host blocks")
        for name, st in (("streamed", st_s), ("unstreamed", st_u)):
            viol = blockmap.check_invariants(st.map, mp)
            print(f"large scan {name}: invariants {viol}")
            if any(v != 0 for v in viol.values()):
                raise RuntimeError(f"large scan {name}: invariants {viol}")

        t0 = time.perf_counter()
        tris_u, _ = meshing.extract_mesh(st_u.map, mp, cfg.mesh)
        t1 = time.perf_counter()
        tris_s, cols_s = meshing.extract_mesh_streamed(st_s.map, mp,
                                                       cfg.mesh, mgr)
        t2 = time.perf_counter()
        same_mesh = (tris_u.shape == tris_s.shape and np.array_equal(
            _sorted_tris(tris_u), _sorted_tris(tris_s)))
        print(f"large scan mesh: unstreamed {len(tris_u)} triangles "
              f"({t1 - t0:.2f} s), streamed composed {len(tris_s)} "
              f"({t2 - t1:.2f} s), equal as sorted triangles {same_mesh}")
        if not same_mesh or len(tris_u) == 0 \
                or len(tris_u) >= cfg.mesh.max_triangles:
            raise RuntimeError("large scan: the streamed mesh differs from "
                               "the unstreamed one (or is empty or cut)")
        with tempfile.TemporaryDirectory() as tmp:
            nf = meshing.save_ply(os.path.join(tmp, "scan.ply"), tris_s,
                                  cols_s)
            pu = os.path.join(tmp, "unstreamed.npz")
            ps = os.path.join(tmp, "streamed.npz")
            nu = streaming.save_map(pu, st_u.map, mp)
            ns = streaming.save_map(ps, st_s.map, mp, manager=mgr)
            zu, zs = np.load(pu), np.load(ps)
            fields = ("keys", "sdf", "weight", "color")
            ru = _sorted_rows(*(zu[f] for f in fields))
            rs = _sorted_rows(*(zs[f] for f in fields))
        same_ckpt = nu == ns and all(np.array_equal(a, b)
                                     for a, b in zip(ru, rs))
        print(f"large scan checkpoint: unstreamed {nu} blocks, streamed "
              f"composed {ns}, sorted rows equal {same_ckpt}; PLY "
              f"{nf} welded faces")
        if not same_ckpt or nu == 0:
            raise RuntimeError("large scan: the streamed checkpoint differs "
                               "from the unstreamed one")
        del st_s, st_u, tris_u, tris_s, cols_s, ru, rs
        for r in runs[:2]:
            del r["state"], r["snap"]
    finally:
        for m in mgrs:
            m.close()

    calls = runs[0].pop("calls")
    front_err, _ = _hold_front_frames(cfg, depth, color, calls,
                                      "front kernels (large scan)",
                                      pixel_every=12)
    front = time_front(cfg, depth[LS_SYNC_FRAME], color[LS_SYNC_FRAME],
                       calls[LS_SYNC_FRAME],
                       f"large scan, frame {LS_SYNC_FRAME}", gpu_line)
    for r in front.values():
        r["max_abs_err"] = front_err
    del calls
    if snap is None:
        raise RuntimeError("large scan: no stream-in on the return leg")
    snap_map, bitmask, new_rows, pose, d, c = _stream_in_inputs(
        cfg, scene, snap, device)
    res_a, aidx = check_kernel_a(cfg, snap_map, d, c, pose, n_frames,
                                 "kernel A (large scan)", gpu_line,
                                 bitmask=bitmask)
    back = int(torch.isin(aidx, new_rows).sum())
    print(f"kernel A (large scan): {back} of the active rows came back by "
          f"stream-in")
    if back == 0:
        raise RuntimeError("large scan: no streamed-in row in kernel A's "
                           "active set")
    res_b = check_kernel_b(cfg, snap_map, pose, "kernel B (large scan)",
                           gpu_line)
    for leg in ("out", "back"):
        f = [r["fps"][leg] for r in runs]
        print(f"large scan summary, {leg}: frames/s S {f[0]:.3f} U "
              f"{f[1]:.3f} (S first, ratio {f[0] / f[1]:.3f}), U {f[2]:.3f} "
              f"S {f[3]:.3f} (U first, ratio {f[3] / f[2]:.3f}); host syncs "
              f"of one frame S {runs[0]['syncs']} U {runs[1]['syncs']}; on "
              f"{gpu_line}")
    return {"launches": {"streamed": {**runs[0]["launches"],
                                      **runs[0]["hash"]},
                         "unstreamed": {**runs[1]["launches"],
                                        **runs[1]["hash"]}},
            "fps": (runs[0]["fps"]["out"], runs[1]["fps"]["out"]),
            "a": res_a, "b": res_b, "front": front,
            "hash": {"held": hash_held, **hash_times}}


def _stream_in_inputs(cfg, scene, snap, device):
    """The kernels' inputs on the state just after the first stream-in
    (``snap`` from a streamed ``_scan_run``): a forward-looking camera in
    front of the blocks that came back and its rendered frame. Returns
    (map, bitmask, rows back int32[k], pose f32[4,4], depth, color)."""
    import numpy as np
    import torch
    from voxelhashing_tpu_torch import geometry as geom
    from voxelhashing_tpu_torch.io.synthetic import render_depth

    mp = cfg.map
    i_in, snap_map, bitmask, new_rows = snap
    blocks = geom.unpack_block_key(snap_map.block_key[
        new_rows.long()], mp.world_blocks)
    x = float((blocks[:, 0].double().mean() + 0.5) * mp.block_size_world)
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = x
    d, c = render_depth(pose, cfg.camera, scene, noise_sigma=0.002,
                        seed=LS_OUT + LS_BACK, device=device)
    print(f"large scan: state after the stream-in of frame {i_in} "
          f"({len(new_rows)} rows back on the device), checked from "
          f"x = {x:.3f} m")
    return (snap_map, bitmask, new_rows, torch.from_numpy(pose).to(device),
            torch.nan_to_num(d, nan=0.0), c)


TIE_COLOR = 0x123456     # the forced tie's copy's packed color


def _with_tie(cfg, map_state, aidx, has_surf):
    """A forced color tie: a clone of ``map_state`` in which the surface
    row with the most voxels in the band is copied into a free pool slot
    with another color, and an active list with that slot after the last
    surface row. Every pixel the row hits then has two voxels of bit-equal
    z_surf, and the copy (the larger flat index) must give the color."""
    import torch
    from voxelhashing_tpu_torch.geometry import INVALID_KEY
    st = _clone(map_state)
    sel = aidx.long()[has_surf]
    band = ((st.weight[sel].float() > 0.0)
            & (st.sdf[sel].float().abs() < cfg.map.voxel_size)).sum(dim=1)
    src = int(sel[torch.argmax(band)])
    free = int(torch.nonzero(st.block_key == INVALID_KEY)[0])
    for f in ("block_key", "sdf", "weight", "surf"):
        getattr(st, f)[free] = getattr(st, f)[src]
    st.color[free] = TIE_COLOR
    at = int(torch.nonzero(has_surf)[-1]) + 1
    aidx = aidx.clone()
    aidx[at] = free
    mask = has_surf.clone()
    mask[at] = True
    return st, aidx, mask



def hold_color(cfg, map_state, view, aidx, has_surf, label, tie=False,
               require_cover=True):
    """A color render (``splat_zbuf_color``: the color walk, then the
    resolve) against its plain version
    (``splat_zbuf_plain(with_color=True)``): z-buffers and colors
    bit-identical, and the walk's key buffer bit-identical to
    ``splat_keys_plain``; with a forced tie the copy's color must show.
    Returns the max abs error of the depths and the color channels."""
    import torch
    from voxelhashing_tpu_torch.ops import splat_zbuf as sb
    cam, mp = cfg.camera, cfg.map
    zk, ck = sb.splat_zbuf_color(map_state, aidx, has_surf, view, cam, mp)
    args, keys, _, _ = sb.prepare_color(map_state, aidx, has_surf, view,
                                        cam, mp)
    sb.launch_color(args)
    zp, cp = sb.splat_zbuf_plain(map_state, aidx, has_surf, view, cam, mp,
                                 with_color=True)
    kp = sb.splat_keys_plain(map_state, aidx, has_surf, view, cam, mp)
    torch.cuda.synchronize()
    equal = {"zbuf": _bits_equal(zk, zp), "color": bool(torch.equal(ck, cp)),
             "keys": bool(torch.equal(keys, kp))}
    err = max(_max_abs(zk, zp), _max_abs(ck, cp))
    colored = int((ck != 0).sum())
    tied = int((ck == TIE_COLOR).sum())
    print(f"{label}: surface rows {int(has_surf.sum())}, colored pixels "
          f"{colored}/{ck.numel()}, pixels won by the tie's copy {tied}, "
          f"bit-identical {equal}, max_abs_err {err}")
    if not all(equal.values()) or (require_cover and colored == 0) \
            or (tie and tied == 0):
        raise RuntimeError(f"{label} disagrees with its plain version")
    return err


def time_color(cfg, map_state, view, aidx, has_surf, label, gpu_line):
    """A color render's times at this state, as ``time_b``: the color walk
    and the resolve launched together (``launch_color``) in the bare
    graph, the wrapper and the plain version; the voxels that pass every
    test (each issues one 64-bit atomicMin) and the pixels they cover
    (each reads one pool color); the bytes, operations and bound
    (``_work_color``)."""
    import torch
    from voxelhashing_tpu_torch.ops import splat_zbuf as sb

    cam, mp = cfg.camera, cfg.map
    args, _, zbuf, _ = sb.prepare_color(map_state, aidx, has_surf, view, cam,
                                        mp)
    ms = _bare_ms(lambda: sb.launch_color(args))
    prof_ms = _profiled_ms(lambda: sb.launch_color(args),
                           ("splat_zbuf_kernel<true>", "splat_resolve"))
    wrapper_ms = _median_ms(lambda: sb.splat_zbuf_color(
        map_state, aidx, has_surf, view, cam, mp))
    plain_ms = _median_ms(lambda: sb.splat_zbuf_plain(
        map_state, aidx, has_surf, view, cam, mp, with_color=True))
    _, _, _, ok = sb.splat_targets(map_state, aidx, has_surf, view, cam, mp)
    survivors = int(ok.sum())
    covered = int(torch.isfinite(zbuf.view(torch.float32)).sum())
    n_surf = int(has_surf.sum())
    band = _band_voxels(cfg, map_state, aidx, has_surf)
    nbytes, nops = _work_color(cfg, n_surf, band, covered, aidx.shape[0])
    bound, by = _bound(nbytes, nops)
    print(f"{label}: bare {ms:.4f} ms (walk and resolve, {BARE_LAUNCHES} "
          f"launches of each in one CUDA graph; torch.profiler "
          f"{_fmt(prof_ms)} ms), wrapper {wrapper_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; {n_surf} surface rows, {band} voxels in the "
          f"band, {survivors} pass every test and issue {survivors} 64-bit "
          f"atomics, {covered} pixels covered; {nbytes} B at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s, {nops} f32 operations at "
          f"{F32_OPS_PER_S / 1e12:.0f} TFLOP/s: bound {bound:.4f} ms by "
          f"{by}, {100 * bound / ms:.1f}% of it; library: none (no single "
          f"PyTorch call); on {gpu_line}")
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
            "profiler_ms": prof_ms, "rows": n_surf, "band_voxels": band,
            "survivors": survivors, "covered": covered, "bytes": nbytes,
            "operations": nops}


def check_color(cfg, map_state, pose, label, gpu_line):
    """A color render held bit for bit against its plain version at this
    state and with a forced tie, then timed. Returns the result dict."""
    view, aidx, has_surf = _b_inputs(cfg, map_state, pose)
    err = hold_color(cfg, map_state, view, aidx, has_surf, label)
    tie_map, tie_aidx, tie_mask = _with_tie(cfg, map_state, aidx, has_surf)
    err = max(err, hold_color(cfg, tie_map, view, tie_aidx, tie_mask,
                              f"{label}, forced tie", tie=True))
    del tie_map
    res = time_color(cfg, map_state, view, aidx, has_surf, label, gpu_line)
    res["max_abs_err"] = err
    return res


# phase 6: the march renderer and RGB-D tracking
def _rgbd_config(mode):
    """The bench point of ``_config`` with RGB-D tracking (weights 1.0 /
    0.1, sigma 0.1) and the ``mode`` renderer, every other raycast and
    tracker field at the JAX package's default (march: 48 samples, 16-pixel
    tiles, ray factors 0.8 / 50.5 / 50.0, no gradient normals)."""
    import dataclasses
    from voxelhashing_tpu_torch.config import RaycastConfig, TrackerConfig
    return dataclasses.replace(_config(), raycast=RaycastConfig(mode=mode),
                               tracker=TrackerConfig(use_rgbd=True))


def _counters():
    """(name, function, attribute) of each kernel launch count and each
    plain version's count of calls on CUDA tensors. (``ab_step`` also
    drives older checkouts with this; a counter such a checkout lacks
    reads 0.)"""
    from voxelhashing_tpu_torch import integrate as integ
    from voxelhashing_tpu_torch.ops.fused_integrate import fused_integrate
    from voxelhashing_tpu_torch.ops import splat_zbuf as sb
    try:
        from voxelhashing_tpu_torch.ops import solve6 as s6
    except ImportError:                     # a checkout before the kernel
        s6 = None
    try:
        from voxelhashing_tpu_torch.ops import icp_update as iu
    except ImportError:                     # a checkout before the kernel
        iu = None
    try:
        from voxelhashing_tpu_torch.ops import icp_linearize as il
    except ImportError:                     # a checkout before the kernels
        il = None
    try:
        from voxelhashing_tpu_torch.ops import alloc_candidates as ac
        from voxelhashing_tpu_torch.ops import preprocess as pp
    except ImportError:                     # a checkout before the kernels
        ac = pp = None
    try:
        from voxelhashing_tpu_torch.ops import hash_table as ht
    except ImportError:                     # a checkout before the kernels
        ht = None
    try:
        from voxelhashing_tpu_torch.ops import raymarch as rm
    except ImportError:                     # a checkout before the kernels
        rm = None
    from voxelhashing_tpu_torch import blockmap as bm
    return (("preprocess", getattr(pp, "preprocess_depth", None),
             "launches"),
            ("hash_insert", getattr(ht, "allocate", None), "launches"),
            ("hash_delete", getattr(ht, "delete_blocks", None), "launches"),
            ("hash_gc", getattr(ht, "garbage_collect", None), "launches"),
            ("plain garbage_collect on CUDA",
             getattr(integ, "garbage_collect_plain", None), "cuda_calls"),
            ("plain allocate on CUDA", getattr(bm, "allocate_plain", None),
             "cuda_calls"),
            ("plain delete_blocks on CUDA",
             getattr(bm, "delete_blocks_plain", None), "cuda_calls"),
            ("alloc_candidates", getattr(ac, "alloc_candidates", None),
             "launches"),
            ("plain preprocess on CUDA", getattr(pp, "preprocess_plain",
                                                 None), "cuda_calls"),
            ("plain alloc_candidates on CUDA",
             getattr(ac, "alloc_candidates_plain", None), "cuda_calls"),
            ("fused_integrate", fused_integrate, "launches"),
            ("fused_integrate_bilinear", fused_integrate,
             "bilinear_launches"),
            ("frame_color_words", fused_integrate, "color_word_launches"),
            ("splat_zbuf", sb.splat_zbuf, "launches"),
            ("splat_zbuf_color", getattr(sb, "splat_zbuf_color", None),
             "launches"),
            ("plain integrate on CUDA", integ.integrate, "cuda_calls"),
            ("plain splat_zbuf on CUDA", sb.splat_zbuf_plain, "cuda_calls"),
            ("plain splat_color on CUDA", sb.splat_color_plain,
             "cuda_calls"),
            ("icp_update", getattr(iu, "icp_update", None), "launches"),
            ("plain icp_update on CUDA",
             getattr(iu, "icp_update_plain", None), "cuda_calls"),
            ("solve6", getattr(s6, "solve6", None), "launches"),
            ("plain solve6 on CUDA", getattr(s6, "solve6_plain", None),
             "cuda_calls"),
            ("icp_associate", getattr(il, "associate", None), "launches"),
            ("icp_linearize", getattr(il, "linearize", None), "launches"),
            ("icp_linearize_color", getattr(il, "linearize", None),
             "color_launches"),
            ("icp_associate_linearize",
             getattr(il, "associate_linearize", None), "launches"),
            ("icp_associate_linearize_color",
             getattr(il, "associate_linearize", None), "color_launches"),
            ("plain associate on CUDA", getattr(il, "associate_plain", None),
             "cuda_calls"),
            ("plain linearize on CUDA", getattr(il, "linearize_plain", None),
             "cuda_calls"),
            ("plain color system on CUDA",
             getattr(il, "color_system_plain", None), "cuda_calls"),
            ("ray_bounds", getattr(rm, "ray_bounds", None), "launches"),
            ("raymarch", getattr(rm, "march", None), "launches"),
            ("plain ray_bounds on CUDA", getattr(rm, "ray_bounds_plain",
                                                 None), "cuda_calls"),
            ("plain march on CUDA", getattr(rm, "march_plain", None),
             "cuda_calls"))


def _solves(cfg):
    """The ICP updates (``icp_update`` launches, one 6x6 solve each) of one
    tracked frame of ``cfg`` (an engine's or a tracker's config): one per
    inner iteration of every outer iteration of every level."""
    t = getattr(cfg, "tracker", cfg)
    return sum(o * i for o, i in zip(t.max_outer_iter, t.max_inner_iter))


def _track_launches(cfg, frames=1, rgbd=False, sharded=False):
    """The tracker's launches in ``frames`` tracked frames of ``cfg`` (an
    engine's or a tracker's config): one ICP update an inner iteration;
    on a single device one fused pass launch (association and
    linearization, with the photometric rows under RGB-D) an outer
    iteration and a split linearization each later inner iteration; on
    the sharded path (``sharded``) one association an outer iteration and
    one linearization an inner one."""
    t = getattr(cfg, "tracker", cfg)
    solves = _solves(t) * frames
    outer = sum(t.max_outer_iter) * frames
    fused = 0 if sharded else outer
    return {"icp_update": solves,
            "icp_associate": outer - fused,
            "icp_linearize": 0 if rgbd else solves - fused,
            "icp_linearize_color": solves - fused if rgbd else 0,
            "icp_associate_linearize": 0 if rgbd else fused,
            "icp_associate_linearize_color": fused if rgbd else 0}


def _launches_off(counts, want):
    """The kernels whose count in ``counts`` is not ``want``'s, as
    {name: (count, wanted)} (only those the checkout counts)."""
    have = {name for name, fn, attr in _counters() if hasattr(fn, attr)}
    return {k: (counts[k], v) for k, v in want.items()
            if k in have and counts[k] != v}


def _counts():
    """The kernels' launch counts and the plain versions' calls on CUDA
    tensors, by name."""
    return {name: getattr(fn, attr, 0) for name, fn, attr in _counters()}


def _zero_counts():
    """Set every count to 0 (only those the checkout has: a counter made
    here would read as a kernel it does not have)."""
    _set_counts({name: 0 for name, _, _ in _counters()})


def _set_counts(counts):
    """Set every count the checkout has to its value in ``counts`` (as
    ``_counts`` returns them)."""
    for name, fn, attr in _counters():
        if hasattr(fn, attr):
            setattr(fn, attr, counts[name])


def phase_rgbd(mode, device, gpu_line):
    """Phase 6, one configuration: 20 frames of ``engine.step`` with RGB-D
    tracking and the ``mode`` renderer on the bench scene (free tracking).
    Requires ATE < 10 mm, every frame valid, a clean map, kernel A on
    every frame, the color render (walk and resolve) on every frame in
    splat mode and never in march mode, kernel B never (every render is
    with color), and no plain version called on a CUDA tensor.
    Reports fused frames/s over frames 2-19 (CUDA events), the per-stage
    table of the same frames (CUDA events at the ``engine.STAGES`` marks)
    and the host syncs of one frame. Returns a dict of the numbers."""
    import torch
    from voxelhashing_tpu_torch import blockmap, engine, evaluation

    cfg = _rgbd_config(mode)
    label = f"{mode} + RGB-D"
    poses, depth, color = _frames(cfg.camera, device)
    state = engine.create(cfg, device=device)
    events, diags, est, snap = [], [], [], None
    torch.cuda.synchronize()
    record = (_recorded_marches() if mode == "march"
              else contextlib.nullcontext([]))
    with record as calls:
        _zero_counts()
        t0 = time.perf_counter()
        for i in range(N_FRAMES):
            marks = []

            def mark(stage, marks=marks):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((stage, ev))

            mark("start")
            state, diag = engine.step(state, depth[i], color[i], cfg,
                                      mark=mark)
            mark("end")
            events.append(marks)
            diags.append(diag)
            est.append(state.pose.clone())
            if i == 10:
                snap = _clone_engine(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()

    valid = [bool(d.tracking_valid) for d in diags]
    for i, d in enumerate(diags):
        print(f"{label} frame {i:2d}: valid={valid[i]} "
              f"alloc={int(d.n_allocated_blocks)} "
              f"active={int(d.n_active_blocks)} "
              f"icp_res={float(d.icp_residual):.3e} "
              f"corr={int(d.icp_corr_count)} "
              f"cond={float(d.icp_condition):.1f} "
              f"planarity={float(d.icp_planarity):.1f} "
              f"ms={events[i][0][1].elapsed_time(events[i][-1][1]):.3f}")
    ate = evaluation.ate_rmse([p.cpu().numpy() for p in est], poses,
                              align=False)
    viol = blockmap.check_invariants(state.map, cfg.map)
    timed = range(2, N_FRAMES)
    dev_ms = sum(events[i][0][1].elapsed_time(events[i][-1][1])
                 for i in timed)
    fps = len(timed) / (dev_ms / 1000.0)
    stages = collections.defaultdict(float)
    for i in timed:
        for (_, a), (stage, b) in zip(events[i], events[i][1:-1]):
            stages[stage] += a.elapsed_time(b) / len(timed)
    syncs = count_syncs(cfg, snap, depth, color)
    print(f"{label}: ATE RMSE {ate * 1000:.3f} mm (limit "
          f"{ATE_LIMIT_M * 1000} mm), valid frames {sum(valid)}, "
          f"invariants {viol}, counts {counts}")
    print(f"{label}: fused frames/s (frames 2-{N_FRAMES - 1}, CUDA events) "
          f"{fps:.3f} on {gpu_line}; whole {N_FRAMES}-frame loop "
          f"{wall:.3f} s host clock; host syncs of one frame {syncs}")
    total = sum(stages.values())
    print(f"{label}: stages, ms/frame over frames 2-{N_FRAMES - 1} (CUDA "
          f"events between engine.step marks; the render stage is the "
          f"{mode}) on {gpu_line}:")
    for stage in engine.STAGES:
        print(f"  {stage:10s} {stages[stage]:9.3f} ms "
              f"{100 * stages[stage] / total:6.1f}%")
    print(f"  {'total':10s} {total:9.3f} ms")

    want = {name: 0 for name in counts}
    want["fused_integrate"] = N_FRAMES
    want["splat_zbuf_color"] = N_FRAMES if mode == "splat" else 0
    if mode == "march":
        want.update(_march_launches(N_FRAMES, N_FRAMES))
    want.update(_track_launches(cfg, N_FRAMES - 1, rgbd=True))
    want.update(_front_launches(N_FRAMES, N_FRAMES))
    want.update(_hash_launches(N_FRAMES))
    if ate >= ATE_LIMIT_M:
        raise RuntimeError(f"{label}: ATE {ate} m >= {ATE_LIMIT_M} m")
    if not all(valid):
        raise RuntimeError(f"{label}: frames lost: {valid}")
    if any(v != 0 for v in viol.values()):
        raise RuntimeError(f"{label}: map invariants violated: {viol}")
    if counts != want:
        raise RuntimeError(f"{label}: counts {counts}, expected {want}")
    out = {"fps": fps, "ate_mm": ate * 1000, "syncs": syncs,
           "stages": dict(stages), "counts": counts}
    if mode == "march":
        out["device"] = _device_stages(cfg, snap, depth, color,
                                       range(11, 14), label, gpu_line)
        out["march"] = phase_march(snap.map, calls, gpu_line)
    return out


# ---------------------------------------------------------------------------
# The march kernels: the tile bounds and the per-ray march
# ---------------------------------------------------------------------------

def _march_launches(n_bounds, n_march):
    """The march renderer's launches: one bounds launch a render with an
    active list, one march launch a single-device render."""
    return {"ray_bounds": n_bounds, "raymarch": n_march}


@contextlib.contextmanager
def _recorded_marches():
    """The inputs of every ``raycast.render_march`` call made inside the
    block, as dicts (pose, active list and mask cloned); the calls run and
    count as they do."""
    from voxelhashing_tpu_torch import raycast
    calls = []
    real = raycast.render_march

    def recorder(state, pose, cam, cfg, rc, active_idx=None,
                 active_mask=None, group=None):
        calls.append({"pose": pose.clone(), "cam": cam, "cfg": cfg,
                      "rc": rc,
                      "active_idx": None if active_idx is None
                      else active_idx.clone(),
                      "active_mask": None if active_mask is None
                      else active_mask.clone()})
        return real(state, pose, cam, cfg, rc, active_idx=active_idx,
                    active_mask=active_mask, group=group)

    raycast.render_march = recorder
    try:
        yield calls
    finally:
        raycast.render_march = real


def _hits_differ(a, b):
    """The fields of two ``MarchHits`` (or ``RaycastResult``s) whose bits
    differ."""
    return [f for f in a._fields if getattr(a, f) is not None
            and not _bits_equal(getattr(a, f), getattr(b, f))]


def hold_march(map_state, call, label, use_gradients):
    """Both march kernels against their plain versions on one call (a
    recorded render or an edge case): the tile bounds, every field of the
    hits and the rendered frame (through the shared epilogue) bit for bit.
    Returns (the rays with a hit, the max abs error over the finite
    values: 0 when bit-equal)."""
    import dataclasses
    import torch
    from voxelhashing_tpu_torch import geometry as geom, raycast
    from voxelhashing_tpu_torch.ops import raymarch as rm
    cam, cfg, pose = call["cam"], call["cfg"], call["pose"]
    rc = dataclasses.replace(call["rc"], use_gradients=use_gradients)
    aidx, mask = call["active_idx"], call["active_mask"]
    out = []
    for bounds_fn, march_fn in ((rm.ray_bounds, rm.march),
                                (rm.ray_bounds_plain, rm.march_plain)):
        bounds = None
        if rc.splat_enabled and aidx is not None:
            bounds = bounds_fn(map_state.block_key, aidx, mask,
                               geom.invert_rigid(pose), cam, cfg, rc)
        hits = march_fn(map_state, pose, cam, cfg, rc, bounds)
        out.append((bounds, hits, raycast.march_epilogue(hits, pose, cam)))
    torch.cuda.synchronize()
    (bk, hk, rk), (bp, hp, rp) = out
    bad = []
    if bk is not None and not all(_bits_equal(x, y)
                                  for x, y in zip(bk, bp)):
        bad.append("tile bounds")
    bad += _hits_differ(hk, hp)
    bad += [f"frame {f}" for f in _hits_differ(rk, rp)
            if f != "splat_overflow"]
    if bad:
        raise RuntimeError(f"{label} (gradients {use_gradients}): the "
                           f"march kernels differ from their plain "
                           f"versions in {bad}")
    pairs = [(x, y) for x, y in zip(hk, hp) if x is not None
             and x.dtype == torch.float32]
    if bk is not None:
        pairs += list(zip(bk, bp))
    return int(hk.found.sum()), max(_max_abs(x, y) for x, y in pairs)


def hold_wide_bounds(map_state, call):
    """The bounds kernel on a grid past its shared-memory path (1-pixel
    tiles: 76,800 tiles at 320x240, over ``kMaxSharedTiles``) at one
    recorded render, against ``ray_bounds_plain`` bit for bit, its
    accumulators back at their identity. Returns the max abs error."""
    import dataclasses
    import torch
    from voxelhashing_tpu_torch import geometry as geom
    from voxelhashing_tpu_torch.ops import raymarch as rm
    cam, cfg = call["cam"], call["cfg"]
    rc = dataclasses.replace(call["rc"], splat_tile=1)
    ty, tx = rm.tiles(cam, rc)
    view = geom.invert_rigid(call["pose"])
    args = (map_state.block_key, call["active_idx"], call["active_mask"],
            view, cam, cfg, rc)
    saved = _counts()
    got, ref = rm.ray_bounds(*args), rm.ray_bounds_plain(*args)
    torch.cuda.synchronize()
    _set_counts(saved)
    same = all(_bits_equal(x, y) for x, y in zip(got, ref))
    restored = bool((rm.reserve(map_state.block_key.device, ty * tx)
                     == rm.IDENTITY).all())
    print(f"ray bounds, {ty} x {tx} = {ty * tx} tiles (past the shared "
          f"path's 6144): bit-equal {same}, accumulators restored "
          f"{restored}")
    if not (same and restored and ty * tx > 6144):
        raise RuntimeError("the bounds kernel on a wide grid disagrees")
    return max(_max_abs(x, y) for x, y in zip(got, ref))


def phase_march_edge_bank(device):
    """Both march kernels held bit for bit on ``raymarch.edge_bank``, with
    gradients and without. Returns the max abs error (0 when bit-equal)."""
    from voxelhashing_tpu_torch.ops import raymarch as rm
    err = 0.0
    for e in rm.edge_bank():
        st, pose, aidx, mask = rm.edge_inputs(e, device)
        call = {"pose": pose, "cam": e["cam"], "cfg": e["cfg"],
                "rc": e["rc"], "active_idx": aidx, "active_mask": mask}
        held = [hold_march(st, call, f"edge march, {e['case']}", g)
                for g in (False, True)]
        err = max(err, *(h[1] for h in held))
        print(f"edge march, {e['case']} ({e['cam'].width}x"
              f"{e['cam'].height}, {e['rc'].num_samples} samples, "
              f"{'no bounds' if aidx is None else 'tile bounds'}): "
              f"bit-equal with and without gradients, {held[0][0]} hits")
    return err


def time_march(map_state, call, label, gpu_line):
    """Both march kernels' times on one recorded render: bare (``launch``
    on prepared arguments, ``_bare_ms``), an empty kernel's node timed
    alike, the wrapper and the plain version (``_median_ms``); the bytes
    they must move and the operations they must do on this call's data
    (``raymarch.work_counts``, ``bounds_work``) and the bound they give;
    the nodes of one bounds call through its wrapper captured into a CUDA
    graph (the kernel alone, no fill). Returns {"raymarch",
    "ray_bounds"}."""
    import torch
    from voxelhashing_tpu_torch import geometry as geom
    from voxelhashing_tpu_torch.ops import icp_update as iu
    from voxelhashing_tpu_torch.ops import raymarch as rm
    cam, cfg, rc, pose = call["cam"], call["cfg"], call["rc"], call["pose"]
    aidx, mask = call["active_idx"], call["active_mask"]
    view = geom.invert_rigid(pose)
    bk = map_state.block_key
    saved = _counts()
    out = {}
    b_args, bounds = rm.prepare_bounds(bk, aidx, mask, view, cam, cfg, rc)
    rm.launch(b_args)
    m_args, _ = rm.prepare_march(map_state, pose, cam, cfg, rc, bounds)
    rm.launch(m_args)
    torch.cuda.synchronize()
    n_active, writes = rm.bounds_work(bk, aidx, mask, view, cam, cfg, rc)
    n_ops = _graph_node_count(lambda: rm.ray_bounds(bk, aidx, mask, view,
                                                    cam, cfg, rc))
    if n_ops != 1:
        raise RuntimeError(f"a bounds call captured {n_ops} graph nodes, "
                           f"expected its one kernel and no fill")
    out["ray_bounds"] = {"graph_nodes": n_ops,
        "ms": _bare_ms(lambda: rm.launch(b_args)),
        "wrapper_ms": _median_ms(lambda: rm.ray_bounds(bk, aidx, mask, view,
                                                       cam, cfg, rc)),
        "plain_ms": _median_ms(lambda: rm.ray_bounds_plain(
            bk, aidx, mask, view, cam, cfg, rc)),
        "bytes": rm.bounds_bytes(aidx.shape[0], n_active,
                                 bounds[0].numel()),
        "operations": rm.bounds_operations(n_active, writes),
        "work": {"active_rows": n_active, "tile_writes": writes,
                 "tiles": bounds[0].numel()}}
    work = rm.work_counts(map_state, pose, cam, cfg, rc, bounds)
    # one thread a ray (the march's first design) on the same map, for
    # its chain
    thread = rm.work_counts(map_state, pose, cam, cfg, rc, bounds, lanes=1)
    rays = work.rays
    out["raymarch"] = {
        "ms": _bare_ms(lambda: rm.launch(m_args)),
        "wrapper_ms": _median_ms(lambda: rm.march(map_state, pose, cam, cfg,
                                                  rc, bounds)),
        "plain_ms": _median_ms(lambda: rm.march_plain(
            map_state, pose, cam, cfg, rc, bounds), repeats=5),
        "bytes": rm.bytes_moved(work), "operations": rm.operations(work),
        "work": work._asdict(),
        "samples_per_ray": (work.samples + 4 * work.crossed) / rays,
        "lookups_per_ray": work.lookups / rays,
        "plain_lookups_per_ray": 8 * (rc.num_samples + 4),
        "lanes": rm.MARCH_LANES, "issued_per_ray": work.issued / rays,
        "chain": work.chain,
        "thread_issued_per_ray": thread.issued / rays,
        "thread_chain": thread.chain}
    empty = _bare_ms(lambda: iu.launch_empty(pose.device))
    torch.cuda.synchronize()
    _set_counts(saved)
    for key, r in out.items():
        r["bound_ms"], r["bound_by"] = _bound(r["bytes"], r["operations"])
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["empty_ms"] = empty
        extra = ""
        if key == "raymarch":
            extra = (f"; {r['samples_per_ray']:.3f} samples and "
                     f"{r['lookups_per_ray']:.3f} block lookups a ray "
                     f"(the plain version: {rc.num_samples + 4} samples "
                     f"and {r['plain_lookups_per_ray']} corner lookups); "
                     f"{r['lanes']} lanes a ray: {r['issued_per_ray']:.3f} "
                     f"samples issued a ray, chain {r['chain']} dependent "
                     f"sample steps in the longest warp (one thread a ray "
                     f"on this map: {r['thread_issued_per_ray']:.3f} and "
                     f"{r['thread_chain']})")
        else:
            extra = (f"; a call captured into a CUDA graph is "
                     f"{r['graph_nodes']} node, no fill")
        print(f"{key} timing ({label}): bare {r['ms']:.4f} ms "
              f"({BARE_LAUNCHES} launches in one CUDA graph), an empty "
              f"kernel's node {empty:.4f} ms; wrapper {r['wrapper_ms']:.4f} "
              f"ms; plain {r['plain_ms']:.4f} ms; {r['bytes']} B at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s, {r['operations']} operations "
              f"at {F32_OPS_PER_S / 1e12:.0f} TFLOP/s (work {r['work']}): "
              f"bound {r['bound_ms']:.6f} ms by {r['bound_by']}, "
              f"{100 * r['bound_share']:.2f}% of it{extra}; one launch a "
              f"rendered frame; on {gpu_line}")
    return out


def phase_march(map_state, calls, gpu_line):
    """The march kernels on phase 6's march run: held on its frame-10 map
    with each of the 20 recorded renders' poses and active lists, with
    and without gradients, and on the edge bank; timed at frame 11's
    render. Returns the timings, each with the max abs error of the
    holds (0 when bit-equal)."""
    held = [hold_march(map_state, c, f"march (phase 6), call {i}", g)
            for i, c in enumerate(calls) for g in (False, True)]
    hits = [h[0] for h in held]
    print(f"march kernels (phase 6): bounds, hits and frames bit-equal to "
          f"the plain versions on {len(calls)} recorded renders at the "
          f"frame-10 map, with and without gradients ({min(hits)}-"
          f"{max(hits)} hits a render)")
    err = max(phase_march_edge_bank(map_state.sdf.device),
              *(h[1] for h in held), hold_wide_bounds(map_state, calls[11]))
    out = time_march(map_state, calls[11], "phase 6, frame 11's render",
                     gpu_line)
    for r in out.values():
        r["max_abs_err"] = err
    return out


# phase 7: the SLAM layer
PG_OUT = 30             # frames out along make_trajectory's motion
PG_BACK = 30            # frames back over the same poses
PG_SYNC_FRAMES = (39, 40)   # host syncs counted: a plain frame, a keyframe
RELOC_LIMITS = (0.01, 0.01)  # relocalization error: metres, radians


def _loop_poses():
    """Frames 0-30 along ``make_trajectory(31)`` (24 cm, 0.12 rad), then
    30 frames back over the same poses to the start, so that the late
    keyframes fall inside the loop gates (0.6 m, 0.8 rad) of the early
    ones."""
    from voxelhashing_tpu_torch.io.synthetic import make_trajectory
    out = make_trajectory(PG_OUT + 1)
    return out + out[-2::-1][:PG_BACK]


def _rotation_error(d):
    import numpy as np
    return float(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))


def _write_recordings(tmp, cfg, poses, depth, color):
    """The .sens recording of the loop (zlib depth, shift 1000, raw color)
    and a two-frame OCCI file (shift 256) read back with the native and
    the numpy decoder, which must agree. Returns the recording's path."""
    import numpy as np
    from voxelhashing_tpu_torch.io import sensfile
    cam = cfg.camera
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2] = (cam.fx, cam.fy,
                                                      cam.cx, cam.cy)
    d_np = depth.cpu().numpy()          # 0 where invalid, stored as 0
    c_np = color.cpu().numpy()
    path = os.path.join(tmp, "loop.sens")
    t0 = time.perf_counter()
    sensfile.write_sens(path, d_np, c_np, poses, intr)
    t1 = time.perf_counter()
    occi = os.path.join(tmp, "occi.sens")
    sensfile.write_sens(occi, d_np[:2], c_np[:2], poses[:2], intr,
                        depth_shift=256.0, depth_codec=sensfile.DEPTH_OCCI)
    native, plain = (sensfile.SensReader(occi, native=True),
                     sensfile.SensReader(occi, native=False))
    try:
        same = all(np.array_equal(native.read_frame(i)[0],
                                  plain.read_frame(i)[0], equal_nan=True)
                   for i in range(2))
        valid = int(np.isfinite(native.read_frame(1)[0]).sum())
    finally:
        native.close()
        plain.close()
    print(f"slam: wrote {len(poses)} frames ({os.path.getsize(path)} B, zlib "
          f"depth, raw color) in {t1 - t0:.2f} s host clock; OCCI file "
          f"({os.path.getsize(occi)} B, shift 256): native and numpy "
          f"decodes equal {same}, {valid} valid pixels")
    if not same or valid == 0:
        raise RuntimeError("OCCI: the native decoder disagrees with numpy")
    return path


def _check_map(label, map_state, cfg):
    """Invariants 0 and a consistent hash histogram whose allocated count
    is the map's. Returns the histogram."""
    from voxelhashing_tpu_torch import blockmap, diagnostics
    viol = blockmap.check_invariants(map_state, cfg.map)
    hist = diagnostics.hash_histogram(map_state, cfg.map)
    allocated = cfg.map.num_blocks - int(map_state.n_free)
    print(f"slam, {label}: invariants {viol}; hash histogram "
          f"{hist['probe_histogram'].tolist()}, table used "
          f"{hist['table_used']}, allocated {hist['allocated_blocks']} "
          f"(map: {allocated}), consistent {hist['consistent']}")
    if any(v != 0 for v in viol.values()):
        raise RuntimeError(f"slam, {label}: invariants {viol}")
    if not hist["consistent"] or hist["allocated_blocks"] != allocated:
        raise RuntimeError(f"slam, {label}: hash histogram {hist}")
    return hist


def _timed_register(pg, times):
    """Time every ``pg.register`` call (host clock; a registration reads
    its result, so its device work is inside)."""
    register = pg.register

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = register(*a, **kw)
        times.append(1000 * (time.perf_counter() - t0))
        return out

    pg.register = timed


def phase_slam(device, gpu_line):
    """Phase 7: the SLAM layer at phase 1's width (see the module
    docstring). Returns its numbers and launch counts by path."""
    import copy
    import io
    import tempfile
    import numpy as np
    import torch
    from voxelhashing_tpu_torch import evaluation, run_slam

    cfg = _config()
    poses, depth, color = _frames(cfg.camera, device, _loop_poses())
    n = len(poses)
    with tempfile.TemporaryDirectory() as tmp:
        path = _write_recordings(tmp, cfg, poses, depth, color)
        args = run_slam.parse_args([
            "--input", f"sens:{path}", "--frames", str(n), "--posegraph",
            "--reintegrate", "--histogram", "--timings"])
        run = run_slam.SlamRun(args, cfg, device)
        reg_ms, sites, log = [], {}, io.StringIO()
        _timed_register(run.pg, reg_ms)
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            for i, (d, c, gt) in enumerate(run_slam.frame_source(args, cfg,
                                                                 device)):
                ctx = (_sync_sites() if i in PG_SYNC_FRAMES
                       else contextlib.nullcontext())
                with ctx as counted:
                    run.frame(i, d, c, gt)
                if counted is not None:
                    sites[i] = counted
        torch.cuda.synchronize()
        live_s = time.perf_counter() - t0
        live = _counts()
        # every live frame but the first tracks, and so does every
        # keyframe registration
        want_track = {k: v + _track_launches(run.pg.tracker,
                                             len(reg_ms))[k]
                      for k, v in _track_launches(cfg, n - 1).items()}
    events = [ln for ln in log.getvalue().splitlines()
              if "loop closure" in ln or "relocalized" in ln or "LOST" in ln]
    for ln in events:
        print(f"slam, live: {ln.strip()}")
    pg = run.pg
    n_loops = sum(e.is_loop for e in pg.edges)
    ate_before = evaluation.ate_rmse(run.est, run.gts, align=False)
    print(f"slam, live: {n} frames in {live_s:.3f} s host clock "
          f"({n / live_s:.3f} frames/s with the sync per frame of "
          f"--timings); keyframes {[k.index for k in pg.keyframes]}, "
          f"edges {len(pg.edges)}, loops {n_loops} "
          f"{[(e.i, e.j) for e in pg.edges if e.is_loop]}; register "
          f"{len(reg_ms)} calls, {np.mean(reg_ms):.3f} ms mean "
          f"({min(reg_ms):.3f}-{max(reg_ms):.3f}); counts {live}; on "
          f"{gpu_line}")
    for i, st in sites.items():
        print(f"slam, live: host syncs of frame {i} with --posegraph"
              f"{' (a keyframe)' if i in [k.index for k in pg.keyframes] else ''}"
              f": {sum(st.values())} ({_sites_line(st)})")
    _check_map("live map", run.state.map, cfg)

    warm = copy.deepcopy(pg)            # a second, warm optimize below
    # the graph as optimize finds it, for phase 8's optimize_distributed
    graph = {"poses": np.stack([k.pose for k in pg.keyframes]),
             "ij": np.array([(e.i, e.j) for e in pg.edges], np.int64),
             "z": np.stack([e.z_ij for e in pg.edges]),
             "weight": np.array([e.weight for e in pg.edges]),
             "is_loop": np.array([e.is_loop for e in pg.edges])}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        run.optimize()
    opt_first = 1000 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    graph["optimized"] = warm.optimize()
    opt_warm = 1000 * (time.perf_counter() - t0)
    ate_after = evaluation.ate_rmse(run.est, run.gts, align=False)
    print(f"slam: optimize {len(pg.keyframes)} poses, {len(pg.edges)} edges, "
          f"{pg.cfg.gn_iters} Gauss-Newton steps: {opt_first:.3f} ms first "
          f"call (torch.func set-up included), {opt_warm:.3f} ms warm; ATE "
          f"RMSE before {ate_before * 1000:.3f} mm, after "
          f"{ate_after * 1000:.3f} mm (limit {ATE_LIMIT_M * 1000} mm); on "
          f"{gpu_line}")

    torch.cuda.synchronize()
    _zero_counts()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    with contextlib.redirect_stdout(io.StringIO()):
        run.reintegrate()
    b.record()
    torch.cuda.synchronize()
    ri_s = time.perf_counter() - t0
    ri = _counts()
    ri_fps = n / (a.elapsed_time(b) / 1000.0)
    print(f"slam, re-integration: {n} frames, {ri_fps:.3f} fused frames/s "
          f"(CUDA events; {ri_s:.3f} s host clock); counts {ri}; on "
          f"{gpu_line}")
    _check_map("re-integrated map", run.state.map, cfg)
    print(f"slam: TimingLog of the live run on {gpu_line}:\n"
          f"{run.timing.report()}")

    # kernel A on the re-integrated map: the last frame at its pose
    pose_last = torch.as_tensor(np.asarray(run.est[-1], np.float32),
                                device=device)
    base, d, c, aidx, n_act = _a_inputs(cfg, run.state.map, depth[-1],
                                        color[-1], pose_last, n)
    hold_a(cfg, base, d, c, pose_last, aidx, n_act,
           "kernel A (re-integrated map)")
    del base, run

    want_live = {"fused_integrate": n, "splat_zbuf": n}
    bad = [k for k, v in live.items() if k.startswith("plain") and v] + \
        [k for k, v in ri.items() if k.startswith("plain") and v]
    if n_loops < 1:
        raise RuntimeError("slam: no loop edge")
    if not (ate_before < ATE_LIMIT_M and ate_after < ATE_LIMIT_M
            and ate_after <= ate_before + 0.001):
        raise RuntimeError(f"slam: ATE before {ate_before} m, after "
                           f"{ate_after} m")
    no_track = {k: 0 for k in want_track}
    # live: every frame and every keyframe's maps are preprocessed
    front_live = _front_launches(n + len(pg.keyframes), n)
    if any(live[k] != v for k, v in want_live.items()) \
            or any(ri[k] != v for k, v in want_live.items()) or bad \
            or _launches_off(live, want_track) \
            or _launches_off(ri, no_track) \
            or _launches_off(live, front_live) \
            or _launches_off(ri, _front_launches(n, n)) \
            or _launches_off(live, _hash_launches(n)) \
            or _launches_off(ri, _hash_launches(n)) \
            or _launches_off(live, _march_launches(0, 0)) \
            or _launches_off(ri, _march_launches(0, 0)) \
            or live["solve6"] or ri["solve6"]:
        raise RuntimeError(f"slam: counts live {live}, re-integration {ri}, "
                           f"expected {want_live} in both, the tracker's "
                           f"{want_track} live and none re-integrating, "
                           f"the front kernels' {front_live} live and "
                           f"{n} of each re-integrating, the hash kernels' "
                           f"{_hash_launches(n)} in both, solve6 0")
    reloc = phase_relocalize(cfg, poses, depth, device, gpu_line)
    return {"live": live, "reintegrate": ri, "loops": n_loops,
            "ate_mm": (ate_before * 1000, ate_after * 1000),
            "register_ms": float(np.mean(reg_ms)), "optimize_ms": opt_warm,
            "reintegrate_fps": ri_fps, "reloc": reloc, "graph": graph}


def phase_relocalize(cfg, poses, depth, device, gpu_line):
    """``PoseGraph.relocalize`` at full width: keyframes at frames 0, 10,
    20 and 30 of the loop, the frame of pose 25 (between two of them) and
    the stale last pose of frame 0. Returns (metres, radians) of error."""
    import numpy as np
    from voxelhashing_tpu_torch import posegraph
    from voxelhashing_tpu_torch.ops.image import preprocess

    cam = cfg.camera
    pg = posegraph.PoseGraph(cam, posegraph.PoseGraphConfig(
        loop_min_separation=100, loop_residual_max=1e-3), device=device)

    def maps(i):
        fr = preprocess(depth[i], None, cam, cfg.filter)
        return fr.points, fr.normals

    for i in (0, 10, 20, 30):
        pg.add_keyframe(i, np.asarray(poses[i], np.float64), *maps(i))
    true = np.asarray(poses[25], np.float64)
    t0 = time.perf_counter()
    rp, ok = pg.relocalize(*maps(25), last_pose=np.asarray(poses[0]))
    ms = 1000 * (time.perf_counter() - t0)
    d = np.linalg.inv(rp) @ true
    err = (float(np.linalg.norm(d[:3, 3])), _rotation_error(d))
    print(f"slam, relocalize: from the stale pose of frame 0 to the frame of "
          f"pose 25 against keyframes 0/10/20/30: ok {ok}, error "
          f"{err[0] * 1000:.3f} mm, {err[1]:.5f} rad (limits "
          f"{RELOC_LIMITS[0] * 1000} mm, {RELOC_LIMITS[1]} rad), "
          f"{ms:.3f} ms host clock; on {gpu_line}")
    if not ok or err[0] >= RELOC_LIMITS[0] or err[1] >= RELOC_LIMITS[1]:
        raise RuntimeError(f"slam: relocalization failed: ok {ok}, {err}")
    return err


def hold_color_words(cfg, color, label):
    """The bilinear variant's color-word image (``launch_color_words``)
    against ``integrate.frame_color_word``, bit for bit. Returns the max
    abs error of the packed channels."""
    import torch
    from voxelhashing_tpu_torch import integrate as integ
    from voxelhashing_tpu_torch.ops import fused_integrate as fa
    cam = cfg.camera
    n = cam.height * cam.width
    words = torch.empty((n,), dtype=torch.int32, device=color.device)
    color = color.contiguous()
    fa.launch_color_words(color, words)
    plain = integ.frame_color_word(color, cam, color.device)
    torch.cuda.synchronize()
    equal = bool(torch.equal(words, plain))
    err = _max_abs(words, plain)
    valid = int(((words >> 24) == 1).sum())
    print(f"{label}: {valid}/{n} valid pixels, bit-identical {equal}, "
          f"max_abs_err {err}")
    if not equal:
        raise RuntimeError(f"{label} disagrees with its plain version")
    return err


def phase_bilinear(device, gpu_line):
    """Phase 7, bilinear color: 20 frames of phase 1 with
    ``MapConfig(bilinear_color=True)`` through ``engine.step``; kernel A's
    bilinear variant and its color-word image on every frame (the
    nearest-color kernel never), ATE below 10 mm; then the image held bit
    for bit against ``integrate.frame_color_word``, and the variant with
    its image against its plain version on the state after frame 10 (and
    timed there) and on the edge-value and depth-only frames. Returns
    (result dict, counts)."""
    import dataclasses
    import torch
    from voxelhashing_tpu_torch import engine, evaluation

    base = _config()
    cfg = dataclasses.replace(base, map=dataclasses.replace(
        base.map, bilinear_color=True))
    poses, depth, color = _frames(cfg.camera, device)
    state = engine.create(cfg, device=device)
    est, snap = [], None
    torch.cuda.synchronize()
    _zero_counts()
    for i in range(N_FRAMES):
        state, _ = engine.step(state, depth[i], color[i], cfg)
        est.append(state.pose.clone())
        if i == 10:
            snap = _clone_engine(state)
    torch.cuda.synchronize()
    counts = _counts()
    ate = evaluation.ate_rmse([p.cpu().numpy() for p in est], poses,
                              align=False)
    print(f"bilinear color: {N_FRAMES} frames, ATE RMSE {ate * 1000:.3f} mm "
          f"(limit {ATE_LIMIT_M * 1000} mm), counts {counts}")
    want = {"fused_integrate": 0, "fused_integrate_bilinear": N_FRAMES,
            "frame_color_words": N_FRAMES, "splat_zbuf": N_FRAMES,
            "splat_zbuf_color": 0, "solve6": 0,
            **_track_launches(cfg, N_FRAMES - 1),
            **_front_launches(N_FRAMES, N_FRAMES),
            **_hash_launches(N_FRAMES), **_march_launches(0, 0)}
    if ate >= ATE_LIMIT_M or any(counts[k] != v for k, v in want.items()) \
            or any(v for k, v in counts.items() if k.startswith("plain")):
        raise RuntimeError(f"bilinear color: ATE {ate} m, counts {counts}, "
                           f"expected {want}")
    del state
    base_map, d, c, aidx, n_act = _a_inputs(cfg, snap.map, depth[11],
                                            color[11], est[11], 11)
    ed, ec = _edge_frame(d, c, cfg)
    err = max(hold_color_words(cfg, c, "color-word image"),
              hold_color_words(cfg, ec, "color-word image, edge-value "
                                        "frame"))
    for name, dd, cc in (("edge-value frame", ed, ec),
                         ("depth-only frame", d, None)):
        e, sk = hold_a(cfg, base_map, dd, cc, est[11], aidx, n_act,
                       f"kernel A, bilinear variant, {name}")
        err = max(err, e)
        del sk
    del base_map
    res, _ = check_kernel_a(cfg, snap.map, depth[11], color[11], est[11],
                            11, "kernel A, bilinear variant", gpu_line)
    res["max_abs_err"] = max(res["max_abs_err"], err)
    return res, counts


# phase 8: the multi-device path
SHARD_RANKS = 2             # the ranks of (a)-(e), sharing the one card
SHARD_SNAP = 10             # A and B held, and syncs counted, after it
SHARD_RGBD_FRAMES = 10      # (c) with splat + RGB-D
SHARD_MARCH_FRAMES = 3      # (c) with the march: an all-reduce per fetch
# tests/test_sharded.py:123-133: coverage XOR share, depth (m), color
MARCH_BOUNDS = (5e-3, 1e-4, 2 / 255.0)
POSE_GRAPH_TOL = 1e-4       # tests/test_posegraph.py:184-200


def _clone_sharded(st):
    return st._replace(map=_clone(st.map), pose=st.pose.clone(),
                       frame=st.frame.clone())


def _shard_rows(map_state):
    """This shard's allocated rows sorted by key, as numpy (keys, sdf and
    weight bits as int16, color)."""
    import torch
    from voxelhashing_tpu_torch.geometry import INVALID_KEY
    rows = torch.nonzero(map_state.block_key != INVALID_KEY).flatten()
    return _sorted_rows(
        map_state.block_key[rows].cpu().numpy(),
        map_state.sdf[rows].view(torch.int16).cpu().numpy(),
        map_state.weight[rows].view(torch.int16).cpu().numpy(),
        map_state.color[rows].cpu().numpy())


def _sharded_run(cfg, device, n_frames, label, gpu_line, hold=False):
    """``n_frames`` of ``sharded.make_sharded_step`` on phase 1's frames on
    this rank, every rank in step. Every frame is checked: each key of the
    shard is the rank's (``mix(k) % D``), and the pose and the ``valid``
    flag are bit-equal on every rank. Reports (rank 0) fused frames/s over
    frames 2 on (CUDA events), the all-reduces of a frame and their host
    time, and ATE; with ``hold``, the host syncs of frame 11 replayed on
    the state after frame 10 on every rank, and kernels A and B held bit
    for bit against their plain versions on rank 0's shard after frame
    10. Returns (numbers, state, lcfg, poses, est)."""
    import dataclasses
    import numpy as np
    import torch
    from voxelhashing_tpu_torch import evaluation
    from voxelhashing_tpu_torch.geometry import INVALID_KEY
    from voxelhashing_tpu_torch.parallel import (collectives, distributed,
                                                 sharded)

    me, n_dev = collectives.world()
    poses, depth, color = _frames(cfg.camera, device)
    poses, depth, color = poses[:n_frames], depth[:n_frames], \
        color[:n_frames]
    state, lcfg = distributed.create_sharded_global(cfg,
                                                    initial_pose=poses[0])
    step = sharded.make_sharded_step(cfg)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n_frames)]
    est, valid, reduces, snap = [], [], [], None
    torch.cuda.synchronize()
    _zero_counts()
    counted = collectives.all_reduce
    counted.calls = 0
    hash_calls = []
    for i in range(n_frames):
        c0 = counted.calls
        ev[i][0].record()
        with (_recorded_hash_calls(hash_calls) if hold
              else contextlib.nullcontext()):
            state, pose = step(state, depth[i], color[i])
        ev[i][1].record()
        reduces.append(counted.calls - c0)
        est.append(pose.clone())
        valid.append(state.valid_host)
        if hold and i == SHARD_SNAP:
            snap = _clone_sharded(state)
        # the checks, outside the frame's events
        keys = state.map.block_key
        foreign = torch.sum((sharded.owner(keys, n_dev) != me)
                            & (keys != INVALID_KEY))
        got = collectives.gather_rows([pose.reshape(1, 16), torch.stack(
            [foreign.float(), torch.tensor(float(state.valid_host),
                                           device=device)]).reshape(1, 2)])
        if me == 0:
            same = all(_bits_equal(g[0], got[0][0]) and
                       bool(torch.equal(g[1][0, 1], got[0][1][0, 1]))
                       for g in got)
            n_foreign = int(sum(float(g[1][0, 0]) for g in got))
            if not same or n_foreign:
                raise RuntimeError(
                    f"{label} frame {i}: poses or valid flags differ across "
                    f"ranks ({not same}) or keys on a rank that does not "
                    f"own them ({n_foreign})")
    torch.cuda.synchronize()
    counts = _counts()
    if hold:
        # every rank's hash calls against the plain versions (GC on the
        # rank's shard, every frame)
        held = hold_hash_calls(hash_calls, f"hash kernels ({label}, rank "
                                           f"{me})")
        if held.get("gc", 0) != n_frames:
            raise RuntimeError(f"{label}, rank {me}: {held.get('gc', 0)} "
                               f"GC calls held, expected {n_frames}")
        _set_counts(counts)
    del hash_calls
    ate = evaluation.ate_rmse([p.cpu().numpy() for p in est], poses,
                              align=False)
    timed = range(2, n_frames)
    dev_ms = sum(ev[i][0].elapsed_time(ev[i][1]) for i in timed)
    out = {"fps": len(timed) / (dev_ms / 1000.0), "ate_mm": ate * 1000,
           "valid": valid, "counts": counts,
           "allocated": int(torch.sum(state.map.block_key != INVALID_KEY)),
           "reduces_per_frame": float(np.mean([reduces[i] for i in timed])),
           "frame_ms": [ev[i][0].elapsed_time(ev[i][1])
                        for i in range(n_frames)]}
    if me == 0:
        print(f"{label}: {n_frames} frames on {n_dev} ranks, valid "
              f"{sum(valid)}, ATE RMSE {out['ate_mm']:.3f} mm, rank 0 "
              f"fused frames/s (frames 2-{n_frames - 1}, CUDA events) "
              f"{out['fps']:.3f}, {out['reduces_per_frame']:.1f} "
              f"all-reduces a frame, rank 0 blocks "
              f"{out['allocated']}, counts {counts}; on {gpu_line}",
              flush=True)
    if hold:
        s = _clone_sharded(snap)
        ctx = _sync_sites() if me == 0 else contextlib.nullcontext()
        c0 = counted.calls
        with ctx as sites:
            s, p11 = step(s, depth[SHARD_SNAP + 1], color[SHARD_SNAP + 1])
        del s
        out["reduces_replayed"] = counted.calls - c0
        if me == 0:
            out["syncs"] = sum(sites.values())
            print(f"{label}: host syncs of frame {SHARD_SNAP + 1} replayed "
                  f"on rank 0: {out['syncs']} ({_sites_line(sites)}); "
                  f"{out['reduces_replayed']} all-reduces; replayed pose "
                  f"bit-equal {_bits_equal(p11, est[SHARD_SNAP + 1])}",
                  flush=True)
            scfg = dataclasses.replace(cfg, map=lcfg)
            p = est[SHARD_SNAP + 1]
            base, d, c, aidx, n_act = _a_inputs(
                scfg, snap.map, depth[SHARD_SNAP + 1],
                color[SHARD_SNAP + 1], p, SHARD_SNAP + 1,
                key_filter=lambda k: sharded._owned(k, me, n_dev))
            out["a_err"], sk = hold_a(scfg, base, d, c, p, aidx, n_act,
                                      "kernel A (sharded, rank 0's shard)")
            del base, sk
            out["b_err"] = hold_b(scfg, snap.map,
                                  *_b_inputs(scfg, snap.map, snap.pose),
                                  "kernel B (sharded, rank 0's shard)")
        del snap
    return out, state, lcfg, poses, est


def _sharded_render(cfg, state, pose, merged, gpu_line):
    """(b): ``make_sharded_render`` at ``pose`` on every rank; on rank 0
    against the single-device ``render_march`` of the merged map."""
    import torch
    from voxelhashing_tpu_torch import blockmap, geometry as geom, raycast
    from voxelhashing_tpu_torch.parallel import collectives, sharded

    me, _ = collectives.world()
    t0 = time.perf_counter()
    res = sharded.make_sharded_render(cfg)(state, pose)
    torch.cuda.synchronize()
    ms = 1000 * (time.perf_counter() - t0)
    if me != 0:
        return None
    aidx, n_act, _ = blockmap.compactify(merged, geom.invert_rigid(pose),
                                         cfg.camera, cfg.map)
    mask = torch.arange(aidx.shape[0], device=aidx.device) < n_act
    ref = raycast.render_march(merged, pose, cfg.camera, cfg.map,
                               cfg.raycast, active_idx=aidx,
                               active_mask=mask)
    cov, cov1 = torch.isfinite(res.depth), torch.isfinite(ref.depth)
    both = cov & cov1
    xor = float((cov ^ cov1).float().mean())
    dz = float((res.depth - ref.depth)[both].abs().max())
    dc = float((res.color - ref.color)[both].abs().max())
    print(f"sharded render (march) at the last pose: {ms:.3f} ms host "
          f"clock, covered {int(cov.sum())} pixels, against the merged "
          f"map's render: coverage XOR {xor:.5f}, depth {dz:.3e} m, color "
          f"{dc:.3e} (bounds {MARCH_BOUNDS}); on {gpu_line}", flush=True)
    if int(cov.sum()) == 0 or xor >= MARCH_BOUNDS[0] \
            or dz >= MARCH_BOUNDS[1] or dc >= MARCH_BOUNDS[2]:
        raise RuntimeError("sharded render: out of bounds")
    return {"ms": ms, "xor": xor, "depth": dz, "color": dc}


def _sharded_streaming(cfg, state, lcfg, device, gpu_line):
    """(d): ``ShardedStreamingManager`` on this rank's shard:
    ``stream_out_all`` empties every shard and ``stream_in_all`` restores
    its sorted rows bit for bit; a partial sweep around (0, 0, 1.6) at
    1.2 m keeps every block, on the card or in the store."""
    import dataclasses
    import torch
    from voxelhashing_tpu_torch import blockmap
    from voxelhashing_tpu_torch.config import StreamingConfig
    from voxelhashing_tpu_torch.geometry import INVALID_KEY
    from voxelhashing_tpu_torch.parallel import collectives
    from voxelhashing_tpu_torch.parallel.streaming import (
        ShardedStreamingManager)
    import numpy as np

    me, _ = collectives.world()
    scfg = StreamingConfig(enabled=True)
    before = _shard_rows(state.map)
    total = sum(collectives.all_gather_counts(len(before[0])))
    t0 = time.perf_counter()
    mgr = ShardedStreamingManager(cfg.map, scfg, device=device)
    smap = mgr.stream_out_all(state.map)
    left = int(torch.sum(smap.block_key != INVALID_KEY))
    hosted = mgr.host_block_count()
    t_out = time.perf_counter() - t0
    smap = mgr.stream_in_all(smap)
    t_in = time.perf_counter() - t0 - t_out
    after = _shard_rows(smap)
    same = len(before[0]) == len(after[0]) and all(
        np.array_equal(a, b) for a, b in zip(before, after))
    viol = blockmap.check_invariants(smap, lcfg)
    sweep = ShardedStreamingManager(
        cfg.map, dataclasses.replace(scfg, radius=1.2, out_parts=8),
        device=device)
    for _ in range(8):
        smap, _ = sweep.stream_out(smap, [0.0, 0.0, 1.6])
    on_dev = sum(collectives.all_gather_counts(
        int(torch.sum(smap.block_key != INVALID_KEY))))
    in_store = sweep.host_block_count()
    if me == 0:
        print(f"sharded streaming: {total} blocks on 2 ranks; "
              f"stream_out_all left {left} on rank 0 and {hosted} in the "
              f"store ({t_out:.3f} s), stream_in_all ({t_in:.3f} s): rank "
              f"0's sorted rows bit-equal {same}, invariants {viol}; partial "
              f"sweep: {on_dev} on the card + {in_store} in the store; on "
              f"{gpu_line}", flush=True)
    ok = (same and left == 0 and hosted == total
          and all(v == 0 for v in viol.values())
          and on_dev + in_store == total and on_dev > 0 and in_store > 0)
    if not ok:
        raise RuntimeError(f"sharded streaming failed on rank {me}")
    return {"total": total, "out_s": t_out, "in_s": t_in,
            "sweep": [on_dev, in_store]}


def _sharded_pose_graph(path, device, gpu_line):
    """(e): ``optimize_distributed`` on phase 7's pose graph against its
    single-process ``optimize``."""
    import numpy as np
    from voxelhashing_tpu_torch import posegraph
    from voxelhashing_tpu_torch.config import CameraConfig
    from voxelhashing_tpu_torch.parallel import collectives

    g = np.load(path)
    pg = posegraph.PoseGraph(CameraConfig(), device=device)
    pg.keyframes = [posegraph.Keyframe(index=k, pose=p, points=None,
                                       normals=None)
                    for k, p in enumerate(g["poses"])]
    pg.edges = [posegraph.Edge(i=int(i), j=int(j), z_ij=z, weight=float(w),
                               is_loop=bool(lp))
                for (i, j), z, w, lp in zip(g["ij"], g["z"], g["weight"],
                                            g["is_loop"])]
    start = [kf.pose.copy() for kf in pg.keyframes]
    ms = []
    for _ in range(2):                  # the first call sets torch.func up
        for kf, p in zip(pg.keyframes, start):
            kf.pose = p.copy()
        t0 = time.perf_counter()
        out = pg.optimize_distributed()
        ms.append(1000 * (time.perf_counter() - t0))
    err = float(np.abs(out - g["optimized"]).max())
    me, n_dev = collectives.world()
    if me == 0:
        print(f"optimize_distributed: {len(pg.keyframes)} poses, "
              f"{len(pg.edges)} edges on {n_dev} ranks, {ms[0]:.3f} ms "
              f"first call, {ms[1]:.3f} ms warm; max difference from "
              f"optimize {err:.3e} (limit {POSE_GRAPH_TOL}); on {gpu_line}",
              flush=True)
    if not err < POSE_GRAPH_TOL:
        raise RuntimeError(f"optimize_distributed differs by {err}")
    return {"ms": ms[1], "first_ms": ms[0], "err": err}


# the all-reduces of a step: (name, shape, op, repeats)
REDUCE_SHAPES = (("ICP sums (6x6 system, 45 f32)", (45,), "sum", 50),
                 ("whitening moments (5 f32)", (5,), "sum", 50),
                 ("z-buffer min (240x320 f32)", (240, 320), "min", 20),
                 ("RGB-D colors (240x320x4 f32)", (240, 320, 4), "sum", 20),
                 ("march fetch (2x8x48x76800 f32)", (2, 8, 48, 76800),
                  "sum", 3))


def _reduce_times(device, gpu_line):
    """Host time of one ``collectives.all_reduce`` (gloo, staged through
    pinned memory) of each shape the step reduces, with the card idle:
    the mean over the repeats after one warm-up, every rank in step.
    Returns {name: ms}."""
    import torch
    from voxelhashing_tpu_torch.parallel import collectives

    me, _ = collectives.world()
    out = {}
    for name, shape, op, n in REDUCE_SHAPES:
        t = torch.zeros(shape, dtype=torch.float32, device=device)
        collectives.all_reduce(t, op)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(n):
            r = collectives.all_reduce(t, op)
        torch.cuda.synchronize()
        out[name] = 1000 * (time.perf_counter() - t0) / n
        del t, r
    if me == 0:
        print("all-reduce, one call with the card idle (gloo, staged): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in out.items())
              + f"; on {gpu_line}", flush=True)
    return out


def _sharded_rank(rank, tmp, gpu_line):
    """One rank of phase 8 (a)-(e) over gloo, both ranks on the card."""
    import torch
    from voxelhashing_tpu_torch import blockmap
    from voxelhashing_tpu_torch.parallel import (collectives, distributed,
                                                 sharded)

    sys.stdout.reconfigure(line_buffering=True)
    distributed.initialize(f"file://{tmp}/store", SHARD_RANKS, rank,
                           backend="gloo")
    device = distributed.rank_device(rank)
    torch.cuda.set_device(device)
    cfg = _config()
    out = {}
    out["a"], state, lcfg, _, est = _sharded_run(
        cfg, device, N_FRAMES, "sharded (a)", gpu_line, hold=True)
    counts = collectives.all_gather_counts(out["a"]["allocated"])
    merged = sharded.gather_map(state, lcfg, cfg.map)
    if rank == 0:
        viol = blockmap.check_invariants(merged, cfg.map)
        n = int(blockmap.stats(merged, cfg.map)["n_allocated"])
        print(f"gather_map: {n} blocks (ranks {counts}), invariants "
              f"{viol}", flush=True)
        if n != sum(counts) or any(v != 0 for v in viol.values()):
            raise RuntimeError("gather_map: invariants or count")
    out["b"] = _sharded_render(cfg, state, est[-1], merged, gpu_line)
    del merged
    out["reduce_ms"] = _reduce_times(device, gpu_line)
    out["d"] = _sharded_streaming(cfg, state, lcfg, device, gpu_line)
    del state
    torch.cuda.empty_cache()
    for mode, n in (("splat", SHARD_RGBD_FRAMES),
                    ("march", SHARD_MARCH_FRAMES)):
        out[f"c_{mode}"], st, _, _, _ = _sharded_run(
            _rgbd_config(mode), device, n, f"sharded (c) {mode} + RGB-D",
            gpu_line)
        del st
        torch.cuda.empty_cache()
    out["e"] = _sharded_pose_graph(os.path.join(tmp, "graph.npz"), device,
                                   gpu_line)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def _nccl_rank(rank, tmp, gpu_line):
    """Phase 8 (f): one rank over NCCL, the whole map on it."""
    import torch
    from voxelhashing_tpu_torch import blockmap
    from voxelhashing_tpu_torch.parallel import distributed, sharded

    sys.stdout.reconfigure(line_buffering=True)
    distributed.initialize(f"file://{tmp}/store_nccl", 1, rank,
                           backend="nccl")
    device = distributed.rank_device(rank)
    cfg = _config()
    out, state, lcfg, _, _ = _sharded_run(cfg, device, N_FRAMES,
                                          "sharded (f) D = 1 over NCCL",
                                          gpu_line)
    merged = sharded.gather_map(state, lcfg, cfg.map)
    out["invariants"] = blockmap.check_invariants(merged, cfg.map)
    out["merged"] = int(blockmap.stats(merged, cfg.map)["n_allocated"])
    print(f"sharded (f): gather_map {out['merged']} blocks, invariants "
          f"{out['invariants']}", flush=True)
    with open(os.path.join(tmp, "nccl.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def phase_sharded(device, gpu_line, graph):
    """Phase 8: the multi-device path (``voxelhashing_tpu_torch.parallel``)
    at phase 1's point, in spawned ranks. (a)-(e) on two ranks over gloo,
    both on the one card (a shared card measures the collectives' cost,
    not scaling): (a) 20 frames, (b) the sharded march render, (d) the
    sharded streaming manager, (c) 10 frames of splat + RGB-D and 3 of
    march + RGB-D, (e) ``optimize_distributed`` on phase 7's graph; then
    (f) 20 frames on one rank over NCCL. Requires ATE < 10 mm, every frame
    valid, kernel A on every frame of every rank and kernel B on every
    frame (the color render under splat + RGB-D, neither under the march),
    no plain version on a CUDA tensor. Returns its numbers and counts."""
    import tempfile
    import numpy as np
    import torch
    from voxelhashing_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "graph.npz"), **graph)
        distributed.spawn(_sharded_rank, SHARD_RANKS, (tmp, gpu_line),
                          timeout=900)
        ranks = []
        for r in range(SHARD_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        t_nccl = time.perf_counter()
        distributed.spawn(_nccl_rank, 1, (tmp, gpu_line), timeout=600)
        with open(os.path.join(tmp, "nccl.json")) as f:
            nccl = json.load(f)
    t1 = time.perf_counter()

    want = {"a": (N_FRAMES, "splat_zbuf"),
            "c_splat": (SHARD_RGBD_FRAMES, "splat_zbuf_color"),
            "c_march": (SHARD_MARCH_FRAMES, None)}
    for part, (n, render) in want.items():
        for r, res in enumerate(ranks):
            exp = {name: 0 for name in res[part]["counts"]}
            exp["fused_integrate"] = n
            exp.update(_track_launches(_config(), n - 1, rgbd=part != "a",
                                       sharded=True))
            exp.update(_front_launches(n, n))
            exp.update(_hash_launches(n))
            if render:
                exp[render] = n
            if part == "c_march":
                # the bounds per rank, all-reduced; the march is the
                # distributed plain one (every fetch an all-reduce)
                exp.update(_march_launches(n, 0))
            if res[part]["counts"] != exp or not all(res[part]["valid"]) \
                    or res[part]["ate_mm"] >= ATE_LIMIT_M * 1000:
                raise RuntimeError(
                    f"phase 8 ({part}), rank {r}: counts "
                    f"{res[part]['counts']} (expected {exp}), valid "
                    f"{res[part]['valid']}, ATE {res[part]['ate_mm']} mm")
    exp = {name: 0 for name in nccl["counts"]}
    exp["fused_integrate"] = exp["splat_zbuf"] = N_FRAMES
    exp.update(_track_launches(_config(), N_FRAMES - 1, sharded=True))
    exp.update(_front_launches(N_FRAMES, N_FRAMES))
    exp.update(_hash_launches(N_FRAMES))
    if nccl["counts"] != exp or not all(nccl["valid"]) \
            or nccl["ate_mm"] >= ATE_LIMIT_M * 1000 \
            or any(v != 0 for v in nccl["invariants"].values()) \
            or nccl["merged"] != nccl["allocated"]:
        raise RuntimeError(f"phase 8 (f): {nccl}")
    a = ranks[0]["a"]
    print(f"phase 8: sharded (a) rank 0 {a['fps']:.3f} fused frames/s, "
          f"ATE {a['ate_mm']:.3f} mm, {a['reduces_per_frame']:.1f} "
          f"all-reduces a frame (one ICP-sum all-reduce with the card idle "
          f"{ranks[0]['reduce_ms'][REDUCE_SHAPES[0][0]]:.3f} ms), "
          f"{a['syncs']} host syncs of one frame; splat + RGB-D "
          f"{ranks[0]['c_splat']['fps']:.3f} and march + RGB-D "
          f"{ranks[0]['c_march']['fps']:.3f} frames/s; D = 1 over NCCL "
          f"{nccl['fps']:.3f} frames/s, ATE {nccl['ate_mm']:.3f} mm; wall "
          f"{t1 - t0:.1f} s ((a)-(e) {t_nccl - t0:.1f} s, (f) "
          f"{t1 - t_nccl:.1f} s); two ranks share one card, so this is "
          f"the collectives' cost, not scaling; on {gpu_line}")
    counts = {"sharded": [r["a"]["counts"] for r in ranks],
              "sharded_splat_rgbd": [r["c_splat"]["counts"] for r in ranks],
              "sharded_march_rgbd": [r["c_march"]["counts"] for r in ranks],
              "sharded_nccl": [nccl["counts"]]}
    return {"ranks": ranks, "nccl": nccl, "wall_s": t1 - t0,
            "counts": {path: {name: sum(c[name] for c in cs)
                              for name in cs[0]}
                       for path, cs in counts.items()}}


# phase 9: the dense voxel-grid baseline
DENSE_DIMS = 256            # scripts/bench_densegrid.py:24-41: a 2.56 m cube
DENSE_BYTES_PER_VOXEL = 24  # read and write f32 sdf, f32 weight, int32 color
DENSE_ATE_LIMIT_M = 0.05    # scripts/run_dense.py:88
DENSE_SYNC_FRAME = 11       # host syncs counted: frame 11 after frame 10
DENSE_ORACLE_TOL = 1.5e-3   # tests/test_densegrid.py:134-135 (bf16 pool)
JAX_CUBE_CAP = 1 << 17      # voxelhashing_tpu/densegrid.py:298


def _dense_config():
    """``scripts/bench_densegrid.py:34-54``'s point: a 256^3 grid of 1 cm
    voxels at (-1.28, -1.28, 0.5), truncation max(5 voxels, 5 cm), the
    default 320x240 camera, online mode."""
    from voxelhashing_tpu_torch.config import CameraConfig, EngineConfig
    from voxelhashing_tpu_torch.densegrid import DenseGridConfig
    n = DENSE_DIMS
    vs = 2.56 / n
    grid = DenseGridConfig(dims=(n, n, n), origin=(-1.28, -1.28, 0.5),
                           voxel_size=vs, truncation=max(5.0 * vs, 0.05))
    return EngineConfig(camera=CameraConfig(), offline=False), grid


def _dense_scene():
    """``scripts/bench_densegrid.py:44-48``'s scene: the wall at 2.2 m, the
    floor and three spheres."""
    from voxelhashing_tpu_torch.io.synthetic import Scene, Sphere
    return Scene(wall_z=2.2, spheres=(
        Sphere(center=(0.0, 0.2, 1.8), radius=0.3),
        Sphere(center=(-0.5, -0.2, 2.0), radius=0.25, color=(0.2, 0.5, 0.8)),
        Sphere(center=(0.6, 0.1, 1.5), radius=0.2, color=(0.3, 0.7, 0.3)),
    ))


def _clone_dense(st):
    return st._replace(grid=_clone(st.grid), pose=st.pose.clone(),
                       frame=st.frame.clone(),
                       tracking_lost=st.tracking_lost.clone())


def _graph_node_count(fn):
    """The nodes of a CUDA graph that captures one call of ``fn`` (which
    launches on the current stream and allocates only from the graph's
    pool); its launch counts are restored."""
    import torch
    from voxelhashing_tpu_torch import engine
    saved = _counts()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    _set_counts(saved)
    return engine._graph_nodes(graph)


def _device_ops(fn):
    """(device ops, their device time in ms) of one call of ``fn``
    (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(ev), sum(e.self_device_time_total for e in ev) / 1000.0


def _dense_integrate(cfg, gcfg, poses, depth, color, device, gpu_line):
    """(a) Integrate-only fusion along the ground truth (in place, as the
    step fuses): ms a frame over frames 1-19 (CUDA events), voxel updates a
    second, the share of the bytes bound (each voxel's sdf, weight and
    color read and written once) and torch.profiler's device ops of one
    integrate."""
    import torch
    from voxelhashing_tpu_torch import densegrid

    cam = cfg.camera
    grid = densegrid.create(gcfg, device=device)
    pose_t = [torch.as_tensor(p, device=device) for p in poses]
    densegrid.integrate(grid, gcfg, depth[0], color[0], pose_t[0], cam,
                        in_place=True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * N_FRAMES)]
    torch.cuda.synchronize()
    for i in range(1, N_FRAMES):
        ev[2 * i].record()
        densegrid.integrate(grid, gcfg, depth[i], color[i], pose_t[i], cam,
                            in_place=True)
        ev[2 * i + 1].record()
    torch.cuda.synchronize()
    ms = sum(ev[2 * i].elapsed_time(ev[2 * i + 1])
             for i in range(1, N_FRAMES)) / (N_FRAMES - 1)
    n_vox = gcfg.dims[0] * gcfg.dims[1] * gcfg.dims[2]
    nbytes = DENSE_BYTES_PER_VOXEL * n_vox
    bound = 1000.0 * nbytes / HBM_BYTES_PER_S
    n_ops, dev_ms = _device_ops(lambda: densegrid.integrate(
        grid, gcfg, depth[5], color[5], pose_t[5], cam, in_place=True))
    fused = int((grid.weight > 0).sum())
    print(f"dense (a) integrate-only, {gcfg.dims[0]}^3 ({n_vox} voxels, "
          f"{gcfg.voxel_size * 1000:.0f} mm): {ms:.4f} ms a frame over "
          f"frames 1-{N_FRAMES - 1} (CUDA events), "
          f"{n_vox / ms / 1e6:.3f} G voxel-updates/s; bound {bound:.4f} ms "
          f"({nbytes} B at {HBM_BYTES_PER_S / 1e12} TB/s), "
          f"{100 * bound / ms:.2f}% of it; torch.profiler: {n_ops} device "
          f"ops, {dev_ms:.4f} ms of device time in one integrate; "
          f"{fused} voxels with weight; on {gpu_line}")
    return {"ms": ms, "bound_ms": bound, "bound_share": bound / ms,
            "device_ops": n_ops, "device_ms": dev_ms,
            "gvox_per_s": n_vox / ms / 1e6}


def _dense_step(cfg, gcfg, poses, depth, color, device, gpu_line):
    """(b) 20 frames of the free-tracking dense step (``make_step``, grid
    updated in place): fused frames/s over frames 2-19 and the stage
    times (CUDA events at the ``denseengine.STAGES`` marks), ATE (limit 50
    mm), the launch counts (the dense path reaches no kernel), the host
    syncs of a tracked and of a replayed frame, and the peak memory."""
    import dataclasses
    import torch
    from voxelhashing_tpu_torch import denseengine, evaluation

    step = denseengine.make_step(cfg, gcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = denseengine.create(gcfg, device=device)
    events, valid, est, snap = [], [], [], None
    _zero_counts()
    for i in range(N_FRAMES):
        marks = []

        def mark(stage, marks=marks):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))

        mark("start")
        state, tr = step(state, depth[i], color[i], mark=mark)
        mark("end")
        events.append(marks)
        valid.append(tr.valid)
        est.append(state.pose.clone())
        if i == DENSE_SYNC_FRAME - 1:
            snap = _clone_dense(state)
    torch.cuda.synchronize()
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    valid = [bool(v) for v in valid]
    ate = evaluation.ate_rmse([p.cpu().numpy() for p in est], poses,
                              align=False)
    timed = range(2, N_FRAMES)
    dev_ms = sum(events[i][0][1].elapsed_time(events[i][-1][1])
                 for i in timed)
    fps = len(timed) / (dev_ms / 1000.0)
    stages = collections.defaultdict(float)
    for i in timed:
        for (_, a), (stage, b) in zip(events[i], events[i][1:-1]):
            stages[stage] += a.elapsed_time(b) / len(timed)

    i = DENSE_SYNC_FRAME
    with _sync_sites() as tracked:
        step(_clone_dense(snap), depth[i], color[i])
    replay = denseengine.make_step(
        dataclasses.replace(cfg, use_trajectory=True), gcfg, with_hint=True)
    hint = torch.as_tensor(poses[i], device=device)
    s = _clone_dense(snap)
    with _sync_sites() as replayed:
        replay(s, depth[i], color[i], hint)
    del s, snap

    print(f"dense (b) free-tracking step: valid frames {sum(valid)} of "
          f"{N_FRAMES}, ATE RMSE {ate * 1000:.3f} mm (limit "
          f"{DENSE_ATE_LIMIT_M * 1000:.0f} mm; PERF.md's 10 mm), "
          f"{fps:.3f} fused frames/s over frames 2-{N_FRAMES - 1} (CUDA "
          f"events), counts {counts}, peak memory {peak} B; on {gpu_line}")
    total = sum(stages.values())
    print(f"dense (b): stages, ms/frame over frames 2-{N_FRAMES - 1} (CUDA "
          f"events between the step's marks) on {gpu_line}:")
    for stage in denseengine.STAGES:
        print(f"  {stage:10s} {stages[stage]:9.3f} ms "
              f"{100 * stages[stage] / total:6.1f}%")
    print(f"  {'total':10s} {total:9.3f} ms")
    print(f"dense (b): host syncs of frame {i} tracked "
          f"{sum(tracked.values())} ({_sites_line(tracked)}), replayed "
          f"with its pose on the card {sum(replayed.values())} "
          f"({_sites_line(replayed)})")
    if ate >= DENSE_ATE_LIMIT_M or not all(valid):
        raise RuntimeError(f"dense step: ATE {ate} m, valid {valid}")
    want = {name: 0 for name in counts}
    want.update(_track_launches(cfg, N_FRAMES - 1))
    want.update(_front_launches(N_FRAMES, 0))
    if counts != want:
        raise RuntimeError(f"the dense step launched a kernel other than "
                           f"the tracker's, or a plain version "
                           f"on the card: {counts}, expected {want}")
    if sum(replayed.values()) != 0:
        raise RuntimeError(f"a replayed dense frame synced: {replayed}")
    return state, {"fps": fps, "ate_mm": ate * 1000,
                   "stages": dict(stages), "counts": counts,
                   "peak_bytes": peak,
                   "syncs": sum(tracked.values()),
                   "replay_syncs": sum(replayed.values())}


def _dense_mesh(gcfg, grid, gpu_line):
    """(c) ``extract_mesh`` on (b)'s grid: triangles (> 0), seconds, and
    the surface cubes that JAX's 2^17 cap would drop."""
    import torch
    from voxelhashing_tpu_torch import densegrid

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk = densegrid.extract_mesh(grid, gcfg)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    near = ((grid.weight > 0.0)
            & (torch.abs(grid.sdf) < 2.0 * gcfg.voxel_size))[:-1, :-1, :-1]
    cubes = int(near.sum())
    finite = bool(torch.isfinite(chunk.vertices).all())
    print(f"dense (c) extract_mesh: {chunk.n_triangles} triangles from "
          f"{cubes} surface cubes ({max(cubes - JAX_CUBE_CAP, 0)} beyond "
          f"JAX's 2^17 cap) in {sec:.3f} s host clock, vertices finite "
          f"{finite}; on {gpu_line}")
    if chunk.n_triangles <= 0 or not finite:
        raise RuntimeError(f"dense mesh: {chunk.n_triangles} triangles, "
                           f"finite {finite}")
    return {"triangles": chunk.n_triangles, "s": sec, "cubes": cubes}


def _dense_card_vs_cpu(device, gpu_line):
    """(d) At the CPU tests' size (96^3 at 2 cm, an 80x60 camera, three
    ground-truth frames of ``Scene()``, rendered once on the CPU): the
    card's grid bit-equal to the CPU's; the render from the last pose on
    both, as max abs error where both find a surface."""
    import torch
    from voxelhashing_tpu_torch import densegrid
    from voxelhashing_tpu_torch.config import CameraConfig
    from voxelhashing_tpu_torch.io.synthetic import (Scene, make_trajectory,
                                                     render_depth)

    cam = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5,
                       cy=29.5, depth_min=0.2, depth_max=4.0)
    gcfg = densegrid.DenseGridConfig(dims=(96, 96, 96),
                                     origin=(-0.96, -0.96, 0.8),
                                     voxel_size=0.02, truncation=0.1)
    cpu = torch.device("cpu")
    grids = {cpu: densegrid.create(gcfg, device=cpu),
             device: densegrid.create(gcfg, device=device)}
    poses = make_trajectory(3)
    for i, pose in enumerate(poses):
        d, c = render_depth(pose, cam, Scene(), noise_sigma=0.002, seed=i,
                            device=cpu)
        d = torch.nan_to_num(d, nan=0.0)
        p = torch.as_tensor(pose)
        for dev in grids:
            grids[dev] = densegrid.integrate(grids[dev], gcfg, d.to(dev),
                                             c.to(dev), p.to(dev), cam)
    equal = {f: _bits_equal(getattr(grids[cpu], f),
                            getattr(grids[device], f).cpu())
             for f in ("sdf", "weight", "color")}
    p = torch.as_tensor(poses[-1])
    ren = {dev: densegrid.render(grids[dev], gcfg, p.to(dev), cam)
           for dev in grids}
    dc, dg = ren[cpu].depth, ren[device].depth.cpu()
    both = torch.isfinite(dc) & torch.isfinite(dg)
    err_d = float((dc - dg).abs()[both].max()) if both.any() else 0.0
    err_p = (float((ren[cpu].points - ren[device].points.cpu()).abs()[both]
                   .max()) if both.any() else 0.0)
    xor = float((torch.isfinite(dc) != torch.isfinite(dg)).float().mean())
    share = float(both.float().mean())
    fused = int((grids[cpu].weight > 0).sum())
    print(f"dense (d) card against the CPU, 96^3, 80x60, 3 frames: grids "
          f"bit-equal {equal} ({fused} voxels with weight); render from "
          f"the last pose: depth max abs err {err_d:.3e} m, points "
          f"{err_p:.3e} m where both find a surface ({share:.4f} of the "
          f"pixels; coverage XOR {xor:.4f}); on {gpu_line}")
    if not all(equal.values()):
        raise RuntimeError(f"dense grid: the card differs from the CPU: "
                           f"{equal}")
    return {"equal": equal, "depth_err": err_d, "points_err": err_p,
            "both_share": share, "xor": xor}


def _dense_oracle(device, gpu_line):
    """(e) One frame of a bare wall 1.5 m away at the phase-1 camera fused
    into the sparse map by kernel A (``truncation_scale=0``, the dense
    grid's fixed truncation) and into the 96^3 dense grid; 200 seeded
    probe points just in front of the wall must agree within one bf16 step
    of the truncation (``tests/test_densegrid.py:97-135``). Returns the
    error and kernel A's launches."""
    import numpy as np
    import torch
    from voxelhashing_tpu_torch import blockmap, densegrid, geometry as geom
    from voxelhashing_tpu_torch import integrate as integ, raycast
    from voxelhashing_tpu_torch.config import CameraConfig, MapConfig
    from voxelhashing_tpu_torch.io.synthetic import Scene, render_depth
    from voxelhashing_tpu_torch.ops.fused_integrate import fused_integrate

    cam = CameraConfig()
    gcfg = densegrid.DenseGridConfig(dims=(96, 96, 96),
                                     origin=(-0.96, -0.96, 0.8),
                                     voxel_size=0.02, truncation=0.1)
    mp = MapConfig(voxel_size=gcfg.voxel_size, truncation=gcfg.truncation,
                   truncation_scale=0.0, num_blocks=4096, table_size=16384,
                   max_active_blocks=4096, world_blocks=1024,
                   integration_weight_sample=1)
    pose = torch.eye(4, device=device)
    d, c = render_depth(np.eye(4, dtype=np.float32), cam,
                        Scene(wall_z=1.5, floor_y=None, spheres=()),
                        device=device)
    d = torch.nan_to_num(d, nan=0.0)
    state = blockmap.create(mp, device=device)
    _zero_counts()
    state, _ = integ.allocate_from_depth(state, d, pose, cam, mp)
    aidx, n_act, _ = blockmap.compactify(state, geom.invert_rigid(pose), cam,
                                         mp)
    state, _ = fused_integrate(state, d, c, pose, cam, mp, aidx, n_act)
    grid = densegrid.integrate(densegrid.create(gcfg, device=device), gcfg,
                               d, c, pose, cam)
    torch.cuda.synchronize()
    counts = _counts()
    rng = np.random.RandomState(0)
    pts = [torch.as_tensor(rng.uniform(lo, hi, 200).astype(np.float32),
                           device=device)
           for lo, hi in ((-0.3, 0.3), (-0.3, 0.3), (1.42, 1.49))]
    s_d, ok_d = densegrid.trilinear_sample_soa(grid, gcfg, *pts)
    s_s, ok_s = raycast.trilinear_sample_soa(state, *pts, mp)
    both = ok_d & ok_s
    err = float((s_d - s_s).abs()[both].max()) if both.any() else float(
        "inf")
    print(f"dense (e) oracle for kernel A: {int(n_act)} active rows, "
          f"{int(both.sum())} of 200 probes valid in both, max |dsdf| "
          f"{err:.3e} (limit {DENSE_ORACLE_TOL}), counts {counts}; on "
          f"{gpu_line}")
    if int(both.sum()) <= 50 or err >= DENSE_ORACLE_TOL:
        raise RuntimeError(f"kernel A against the dense oracle: {err} on "
                           f"{int(both.sum())} probes")
    want = {name: 0 for name in counts}
    want["fused_integrate"] = 1
    want.update(_front_launches(0, 1))     # the oracle's blocks allocated
    # (two rounds of integrate.allocate_from_depth, no GC)
    want.update(_hash_launches(1, rounds=2, gc=False))
    if counts != want:
        raise RuntimeError(f"dense oracle: counts {counts}, expected {want}")
    return {"err": err, "probes": int(both.sum()), "counts": counts}


def phase_dense(device, gpu_line):
    """Phase 9: the dense voxel-grid baseline (see the module docstring).
    Returns its numbers and kernel A's launch counts on the oracle path."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg, gcfg = _dense_config()
    poses, depth, color = _frames(cfg.camera, device, scene=_dense_scene())
    out = {"integrate": _dense_integrate(cfg, gcfg, poses, depth, color,
                                         device, gpu_line)}
    state, out["step"] = _dense_step(cfg, gcfg, poses, depth, color, device,
                                     gpu_line)
    del depth, color
    out["mesh"] = _dense_mesh(gcfg, state.grid, gpu_line)
    del state
    torch.cuda.empty_cache()
    out["cpu"] = _dense_card_vs_cpu(device, gpu_line)
    out["oracle"] = _dense_oracle(device, gpu_line)
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 9: dense integrate {out['integrate']['ms']:.4f} ms a frame "
          f"({100 * out['integrate']['bound_share']:.2f}% of its "
          f"{out['integrate']['bound_ms']:.4f} ms bound), step "
          f"{out['step']['fps']:.3f} fused frames/s, ATE "
          f"{out['step']['ate_mm']:.3f} mm, {out['mesh']['triangles']} "
          f"triangles; wall {out['wall_s']:.1f} s; on {gpu_line}")
    return out


# phase 10: the graphed step (engine.make_step)
GRAPH_SYNC_FRAME = 11       # host syncs counted; the ICP updates recorded
GRAPH_BUSY_FRAMES = 3       # frames profiled for the device's busy share
F64_OPS_PER_S = 34e12       # H100 SXM f64 outside the tensor cores (data
#                             sheet, at 700 W)
SOLVE6_BANK = 48            # systems of each kind in solve6's bank
UPDATE_BANK = 6             # updates of each case in icp_update's bank


def _maps_equal(a, b):
    """Every field of two maps bit-equal."""
    return all(_bits_equal(x, y) for x, y in zip(a, b))


def _pool_ptrs(m):
    return (m.sdf.data_ptr(), m.weight.data_ptr(), m.color.data_ptr())


def _timed_call(fn):
    """``fn()`` between two CUDA events; returns (result, (start, end))."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    return out, (a, b)


def _fps(events, frames):
    return len(frames) / (sum(events[i][0].elapsed_time(events[i][1])
                              for i in frames) / 1000.0)


def _keep_strides(t):
    """A copy of ``t`` with its strides (the tracker's a is a [6,6] view of
    an [8,8] system)."""
    out = t.new_zeros((t.shape[0], max(t.stride(0), t.shape[1])))
    out = out[:, :t.shape[1]]
    out.copy_(t)
    return out


@contextlib.contextmanager
def _recorded_updates(out):
    """Append the arguments of every ``tracking`` ICP update inside the
    block (copies, the carry as it was before the update)."""
    from voxelhashing_tpu_torch import tracking
    from voxelhashing_tpu_torch.ops import icp_update as iu
    update = tracking.icp_update

    def opt(t):
        return None if t is None else t.clone()

    def record(state, system, mean, inv_std, planar, gate, level, slot,
               begin=0, color=None, weights=(1.0, 0.1)):
        out.append((iu.clone_state(state),
                    (_keep_strides(system[0]),) + tuple(
                        t.clone() for t in system[1:]),
                    mean.clone(), inv_std.clone(), opt(planar), gate, level,
                    slot, begin,
                    None if color is None else tuple(t.clone()
                                                     for t in color),
                    weights))
        return update(state, system, mean, inv_std, planar, gate, level,
                      slot, begin, color, weights)

    tracking.icp_update = record
    try:
        yield out
    finally:
        tracking.icp_update = update


def _graph_vs_eager(device, gpu_line):
    """(a), the check: phase 1's 20 frames through ``make_step`` and twice
    through the eager step, in lockstep from the same start; every frame's
    pose, valid flag and map compared. Returns the numbers, frame 11's
    ICP updates (``_recorded_updates``) and its passes
    (``_recorded_passes``)."""
    import torch
    from voxelhashing_tpu_torch import engine

    cfg = _config()
    _, depth, color = _frames(cfg.camera, device)
    e1, e2, g = (engine.create(cfg, device=device) for _ in range(3))
    step = engine.make_step(cfg, donate=True)
    ev_e, ev_g, per_frame, updates, passes = [], [], [], [], []
    hash_calls = []
    ptrs, det_diff, graph_diff, sites = None, [], [], None
    torch.cuda.synchronize()
    _zero_counts()
    for i in range(N_FRAMES):
        (e1, d1), t = _timed_call(
            lambda: engine.step(e1, depth[i], color[i], cfg))
        ev_e.append(t)
        ctx = (_recorded_updates(updates) if i == GRAPH_SYNC_FRAME
               else contextlib.nullcontext())
        ctx2 = (_recorded_passes(passes) if i == GRAPH_SYNC_FRAME
                else contextlib.nullcontext())
        with ctx, ctx2, _recorded_hash_calls(hash_calls):
            e2, d2 = engine.step(e2, depth[i], color[i], cfg)
        c0 = _counts()
        ctx = (_sync_sites() if i == GRAPH_SYNC_FRAME
               else contextlib.nullcontext())
        with ctx as counted:
            (g, dg), t = _timed_call(lambda: step(g, depth[i], color[i]))
        ev_g.append(t)
        if counted is not None:
            sites = counted
        c1 = _counts()
        per_frame.append({k: c1[k] - c0[k] for k in c1})
        if i == 1:
            ptrs = _pool_ptrs(g.map)
        if not (_maps_equal(e1.map, e2.map) and _bits_equal(e1.pose, e2.pose)
                and bool(d1.tracking_valid) == bool(d2.tracking_valid)):
            det_diff.append(i)
        if not (_maps_equal(e1.map, g.map) and _bits_equal(e1.pose, g.pose)
                and bool(d1.tracking_valid) == bool(dg.tracking_valid)
                and all(_bits_equal(torch.nan_to_num(x), torch.nan_to_num(y))
                        for x, y in zip(d1, dg))):
            graph_diff.append(i)
    torch.cuda.synchronize()
    # the eager step's GC (and insert) calls against the plain versions:
    # the graphs equal that step frame for frame
    held = hold_hash_calls(hash_calls, "hash kernels (phase 10 (a), the "
                                       "second eager run)")
    if held.get("gc", 0) != N_FRAMES:
        raise RuntimeError(f"phase 10 (a): {held.get('gc', 0)} GC calls "
                           f"held, expected {N_FRAMES}")
    del hash_calls
    timed = range(2, N_FRAMES)
    steady = [i for i in timed if i != cfg.map.gc_starve_interval]
    out = {"fps_eager": _fps(ev_e, timed), "fps_graph": _fps(ev_g, timed),
           "fps_eager_steady": _fps(ev_e, steady),
           "fps_graph_steady": _fps(ev_g, steady),
           "det_diff": det_diff, "graph_diff": graph_diff,
           "syncs": sum(sites.values()), "sites": sites,
           "per_frame": per_frame, "ptrs_kept": _pool_ptrs(g.map) == ptrs,
           "pool_bytes": step.pool_bytes_adopted,
           "small_bytes": step.bytes_adopted,
           "graphs": {k: (v.nodes, v.capture_ms)
                      for k, v in step.graphs.items()}}
    step.close()
    del e1, e2, g, step
    return out, updates, passes


def _graph_alone(device, gpu_line):
    """(a), the measurement: 20 frames of ``make_step`` alone from a fresh
    state: fused frames/s (CUDA events) over the frames that capture
    nothing and run unprofiled (2-16 but 15, the first starve frame), the
    graphs' peak memory, and the device's busy share: torch.profiler's
    kernel time over frames 17-19 against the unprofiled wall time (host
    clock, synchronized) of frames 10-12."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from voxelhashing_tpu_torch import engine

    cfg = _config()
    _, depth, color = _frames(cfg.camera, device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    state = engine.create(cfg, device=device)
    step = engine.make_step(cfg, donate=True)
    n_busy = GRAPH_BUSY_FRAMES
    walled = range(10, 10 + n_busy)
    profiled = range(N_FRAMES - n_busy, N_FRAMES)
    starve = cfg.map.gc_starve_interval
    timed = [i for i in range(2, profiled[0]) if i != starve]
    events, wall_ms, prof = [], 0.0, None
    for i in range(N_FRAMES):
        if i in (walled[0], walled[-1] + 1, profiled[0]):
            torch.cuda.synchronize()
        if i == walled[0]:
            t0 = time.perf_counter()
        if i == walled[-1] + 1:
            wall_ms = 1000 * (time.perf_counter() - t0)
        if i == profiled[0]:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        (state, _), t = _timed_call(lambda: step(state, depth[i], color[i]))
        events.append(t)
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in ops) / 1000 / n_busy
    peak = torch.cuda.max_memory_allocated() - base_alloc
    reserved = torch.cuda.memory_reserved()
    map_bytes = sum(t.numel() * t.element_size() for t in state.map)
    out = {"fps": _fps(events, timed), "timed": timed,
           "busy": dev_ms / (wall_ms / n_busy), "dev_ms": dev_ms,
           "wall_ms": wall_ms / n_busy, "device_ops": len(ops) / n_busy,
           "peak": peak, "reserved": reserved, "map_bytes": map_bytes}
    step.close()
    del state, step
    torch.cuda.empty_cache()
    return out


def _solve6_check(systems, gpu_line):
    """(b): the batched solve (``vh_solve6``, the update kernel's core)
    against its plain version on frame 11's systems, on the seeded bank and
    on a non-finite system; its bare time (one system a launch, and the 18
    in one), its sweeps, its bound and ``torch.linalg.svd``'s time."""
    import numpy as np
    import torch
    from voxelhashing_tpu_torch.ops import solve6 as s6

    thres = _config().tracker.cond_thres
    dev = systems[0][0].device
    fa = torch.stack([a for a, _ in systems])
    fb = torch.stack([b for _, b in systems])
    ba, bb, _ = s6.system_bank(seed=7, n_per_kind=SOLVE6_BANK,
                               cond_thres=thres)
    bad, x_errs = [], {}
    for label, a, b in (("frame 11", fa, fb),
                        ("bank", torch.from_numpy(ba).to(dev),
                         torch.from_numpy(bb).to(dev))):
        got = tuple(t.cpu().numpy() for t in s6.solve6(a, b, thres))
        ref = tuple(t.cpu().numpy() for t in s6.solve6_plain(a, b, thres))
        a64 = a.cpu().double().numpy()
        s64 = np.linalg.svd(a64, compute_uv=False)
        c64 = s64[:, 0] / np.maximum(s64[:, -1], 1e-20)
        dis = s6.disagreements(ref, got, c64, thres)
        ok = ~got[2]
        c_err = float(np.max(np.abs(got[1][ok] - c64[ok]) / c64[ok])) \
            if ok.any() else 0.0
        x_err = x_errs[label] = float(np.max(np.abs(got[0] - ref[0])))
        print(f"solve6 ({label}): {len(c64)} systems, {int(got[2].sum())} "
              f"degenerate (plain {int(ref[2].sum())}), outside the bounds "
              f"{len(dis)}, max |dx| {x_err:.3e}, cond within "
              f"{c_err:.3e} of an f64 SVD's (limit 1e-4); cond "
              f"{float(c64.min()):.3e}-{float(c64.max()):.3e}")
        if dis or c_err > 1e-4:
            bad.append((label, dis[:5], c_err))
    nan_a = fa[0].clone()
    nan_a[1, 2] = float("nan")
    x, _, degen = s6.solve6(nan_a, fb[0], thres)
    xp, _, dp = s6.solve6_plain(nan_a, fb[0], thres)
    nan_ok = bool(degen) and bool(dp) and not bool(torch.any(x != 0)) \
        and bool(torch.equal(x, xp))
    print(f"solve6 (non-finite system): degenerate {bool(degen)} (plain "
          f"{bool(dp)}), x all zero {not bool(torch.any(x != 0))}")
    if bad or not nan_ok:
        raise RuntimeError(f"solve6 against its plain version: {bad}, "
                           f"non-finite {nan_ok}")

    a1, b1 = systems[0]
    # the outputs stay alive until the replays end
    args, out1 = s6.prepare(a1, b1, thres)
    bare = _bare_ms(lambda: s6.launch(args))
    args18, out18 = s6.prepare(fa, fb, thres)
    bare18 = _bare_ms(lambda: s6.launch(args18))
    sweeps = torch.zeros(len(systems), dtype=torch.int32, device=dev)
    args_s, _ = s6.prepare(fa, fb, thres, sweeps=sweeps)
    s6.launch(args_s)
    sw = sweeps.cpu().tolist()
    plain = _median_ms(lambda: s6.solve6_plain(a1, b1, thres))
    wrapper = _median_ms(lambda: s6.solve6(a1, b1, thres))
    svd = _median_ms(lambda: torch.linalg.svd(a1, full_matrices=False))
    nbytes = s6.bytes_moved(1)
    nops = s6.operations([float(np.mean(sw))])
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F64_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    print(f"solve6 timing: bare {bare:.4f} ms a launch of one system "
          f"({BARE_LAUNCHES} launches in one CUDA graph), {bare18:.4f} ms "
          f"for frame 11's {len(systems)} systems in one launch; plain "
          f"{plain:.4f} ms a system (torch.linalg.svd, its host reads "
          f"included); Jacobi sweeps on frame 11 {sw}; {nbytes} B and "
          f"{nops} f64 operations a system: bound {bound:.2e} ms by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'} ({t_bytes:.2e} "
          f"ms at 3.35 TB/s, {t_ops:.2e} ms at 34 TFLOP/s): launch-bound; "
          f"torch.linalg.svd alone {svd:.4f} ms; on {gpu_line}")
    return {"ms": bare, "batch_ms": bare18, "plain_ms": plain,
            "wrapper_ms": wrapper, "svd_ms": svd,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "sweeps": sw, "bytes": nbytes, "operations": nops,
            "max_abs_err": x_errs["frame 11"], "bank_max_abs_err":
            x_errs["bank"], "per_frame": len(systems)}


def _hold_update(iu, args):
    """One update through the kernel and through the plain version, each
    on its own copy of the carry: (``icp_update.disagreements``, max
    |d delta|, max |dx|)."""
    import torch
    state, system, mean, inv_std, planar, gate, level, slot, begin, color, \
        weights = args
    got, ref = iu.clone_state(state), iu.clone_state(state)
    iu.icp_update(got, system, mean, inv_std, planar, gate, level, slot,
                  begin, color, weights)
    iu.icp_update_plain(ref, system, mean, inv_std, planar, gate, level,
                        slot, begin, color, weights)
    torch.cuda.synchronize()
    bad = iu.disagreements(state, ref, got, mean, inv_std, gate, level,
                           slot)
    return (bad, float((got.delta - ref.delta).abs().max()),
            float((got.x - ref.x).abs().max()))


class _Recording:
    """``tracking``'s view of ``ops/icp_linearize`` with associate and
    linearize replaced; every other name is the module's."""

    def __init__(self, mod, **fns):
        self._mod = mod
        self.__dict__.update(fns)

    def __getattr__(self, name):
        return getattr(self._mod, name)


@contextlib.contextmanager
def _recorded_passes(out):
    """Append the inputs of every ``tracking`` association inside the block
    as a dict: delta (a copy), the level (``icp_linearize.Level``), the
    association's arguments, the linearization's planarity threshold and
    color sigma, and whether the two ran as one fused launch."""
    from voxelhashing_tpu_torch import tracking
    icp = tracking.icp

    def associate(delta, lv, *args):
        out.append({"delta": delta.clone(), "lv": lv, "args": args,
                    "fused": False})
        return icp.associate(delta, lv, *args)

    def linearize(delta, lv, assoc, moments, s, planar_thres,
                  color_sigma=None):
        out[-1].update(planar_thres=planar_thres, color_sigma=color_sigma)
        return icp.linearize(delta, lv, assoc, moments, s, planar_thres,
                             color_sigma)

    def associate_linearize(delta, lv, *args):
        *assoc_args, planar_thres, color_sigma = args
        out.append({"delta": delta.clone(), "lv": lv,
                    "args": tuple(assoc_args), "fused": True,
                    "planar_thres": planar_thres, "color_sigma": color_sigma})
        return icp.associate_linearize(delta, lv, *args)

    tracking.icp = _Recording(icp, associate=associate, linearize=linearize,
                              associate_linearize=associate_linearize)
    try:
        yield out
    finally:
        tracking.icp = icp


def _saved_pass_counts():
    from voxelhashing_tpu_torch.ops import icp_linearize as il
    return (il.associate.launches, il.linearize.launches,
            il.linearize.color_launches, il.associate_linearize.launches,
            il.associate_linearize.color_launches)


def _restore_pass_counts(saved):
    from voxelhashing_tpu_torch.ops import icp_linearize as il
    (il.associate.launches, il.linearize.launches,
     il.linearize.color_launches, il.associate_linearize.launches,
     il.associate_linearize.color_launches) = saved


def _hold_passes(records, label):
    """Each recorded iteration three ways (``icp_linearize.check_pass``):
    the split pair against the plain versions (the association, mean and
    inv_std bit for bit, the sums within ``disagreements``, counts equal)
    and the fused launch against the split pair, every output bit for bit;
    raises on any failure. Returns {"n", "fused", "assoc"/"depth"/"color":
    (max |d|, max excess)}."""
    from voxelhashing_tpu_torch.ops import icp_linearize as il
    saved = _saved_pass_counts()
    fails, worst = [], {}
    for k, r in enumerate(records):
        bad, out = il.check_pass(r["delta"], r["lv"], r["args"],
                                 r["planar_thres"], r["color_sigma"])
        if bad:
            fails.append((k, r["lv"].n, bad))
        for key in ("assoc", "depth", "color"):
            if key in out:
                e, x = out[key]
                pe, px = worst.get(key, (0.0, 0.0))
                worst[key] = (max(pe, e), max(px, x))
    _restore_pass_counts(saved)
    sizes = sorted({r["lv"].n for r in records}, reverse=True)
    fused = sum(r.get("fused", False) for r in records)
    print(f"icp passes ({label}): {len(records)} iterations at "
          f"{sizes} pixels ({fused} recorded as fused launches): the fused "
          f"launch equal to the split pair bit for bit, the association "
          f"bit-equal and every sum within the bound in "
          f"{len(records) - len(fails)} of {len(records)}; "
          + "; ".join(f"{key} max |d| {e:.3e}, excess {x:.2f} of 2^-24 "
                      f"sum|t| (bound {il.bound_factor(sizes[0]):.0f})"
                      for key, (e, x) in worst.items()))
    if fails:
        raise RuntimeError(f"icp passes ({label}) against their plain "
                           f"versions: {fails[:4]}")
    return {"n": len(records), "fused": fused, **worst}


def _edge_records(device):
    """``icp_linearize.edge_bank`` as records: each level depth-only with
    the scatter, and with the photometric rows."""
    import torch
    from voxelhashing_tpu_torch.ops import icp_linearize as il
    th = il.EDGE_THRES
    out = []
    for e in il.edge_bank():
        delta = torch.from_numpy(e["delta"]).to(device)
        for scatter, sigma in ((True, None), (False, th["color_sigma"])):
            out.append({"delta": delta, "lv": il.edge_level(e, device),
                        "args": (th["dist_thres"], th["normal_thres"],
                                 th["depth_min"], th["depth_max"], scatter),
                        "planar_thres": th["planar_thres"],
                        "color_sigma": sigma, "case": e["case"]})
    return out


def _rgbd_records(device):
    """Frame 11's passes of phase 6's splat + RGB-D run (the same 12 frames
    through the eager step)."""
    from voxelhashing_tpu_torch import engine
    cfg = _rgbd_config("splat")
    _, depth, color = _frames(cfg.camera, device)
    state = engine.create(cfg, device=device)
    records = []
    saved = _counts()
    for i in range(GRAPH_SYNC_FRAME + 1):
        ctx = (_recorded_passes(records) if i == GRAPH_SYNC_FRAME
               else contextlib.nullcontext())
        with ctx:
            state, _ = engine.step(state, depth[i], color[i], cfg)
    for name, fn, attr in _counters():
        if hasattr(fn, attr):
            setattr(fn, attr, saved[name])
    return records


def _pass_times(records, gpu_line, label):
    """Bare, wrapper and plain times at each level of ``records`` (one
    frame's iterations) of the fused pass launch and of the split pair,
    with an empty kernel's node, the bytes and operations of each launch
    and the bound they give, and the plain version's [8, P] x [P, 8] f32
    product (cuBLAS, ``torch.mm``) as a partial yardstick: it is not the
    same function (the rows, the whitening and the association are not in
    it); and the means over the frame's launches. Returns {kind: the
    per-launch means and the per-level numbers} for "pass" (or
    "pass_color"), "associate" and "linearize" (or "linearize_color")."""
    import numpy as np
    import torch
    from voxelhashing_tpu_torch.ops import icp_linearize as il
    from voxelhashing_tpu_torch.ops import icp_update as iu

    saved = _saved_pass_counts()
    dev = records[0]["delta"].device
    color = records[0]["color_sigma"] is not None
    lin_kind = "linearize_color" if color else "linearize"
    pass_kind = "pass_color" if color else "pass"
    levels = {}
    for r in records:
        levels.setdefault(id(r["lv"]), r)
    per = {pass_kind: [], "associate": [], lin_kind: []}
    for r in levels.values():
        delta, lv, args = r["delta"], r["lv"], r["args"]
        scatter, sigma, pt = args[-1], r["color_sigma"], r["planar_thres"]
        f_args, _ = il.prepare_associate_linearize(delta, lv, *args, pt,
                                                   sigma)
        a_args, a = il.prepare_associate(delta, lv, *args)
        il.launch(a_args)
        l_args, lin = il.prepare_linearize(delta, lv, a, a.moments, a.s, pt,
                                           sigma)
        il.launch(l_args)
        torch.cuda.synchronize()
        n_ok = int(a.ok.sum())
        n_use = int((a.wgt > 0).sum()) if scatter else 0
        n_ok_c = int(lin.color[4]) if color else 0
        n_md = lv.md_pts.shape[0] * lv.md_pts.shape[1]
        rows = il.linearize_rows_plain(delta, lv.plain()[0], a.q, a.nq,
                                       a.wgt, a.ok, lin.mean, lin.inv_std)
        jw = rows * a.wgt[None, :]
        prod = torch.empty((8, 8), dtype=torch.float32, device=dev)
        gemm = _bare_ms(lambda: torch.mm(jw, rows.T, out=prod))
        del rows, jw

        def plain_pass():
            ar = il.associate_reference(delta, lv, *args)
            return il.linearize_reference(delta, lv, ar, ar.moments, ar.s,
                                          pt, sigma)

        for kind, launch_args, call, plain in (
                (pass_kind, f_args,
                 lambda: il.associate_linearize(delta, lv, *args, pt, sigma),
                 plain_pass),
                ("associate", a_args,
                 lambda: il.associate(delta, lv, *args),
                 lambda: il.associate_reference(delta, lv, *args)),
                (lin_kind, l_args,
                 lambda: il.linearize(delta, lv, a, a.moments, a.s, pt,
                                      sigma),
                 lambda: il.linearize_reference(delta, lv, a, a.moments,
                                                a.s, pt, sigma))):
            # every launch here writes the level's correspondences with
            # the same values, so the split linearization's inputs hold
            bare = _bare_ms(lambda: il.launch(launch_args))
            nbytes = il.bytes_moved(kind, lv.n, n_md, scatter,
                                    scatter and kind != "associate")
            f32, f64 = il.operations(kind, lv.n, n_ok, n_use, n_ok_c)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = (f32 / F32_OPS_PER_S + f64 / F64_OPS_PER_S) * 1e3
            per[kind].append({
                "pixels": lv.n, "grid": lv.grid, "ms": bare,
                "wrapper_ms": _median_ms(call),
                "plain_ms": _median_ms(plain),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "operations": f32 + f64, "accepted": n_ok,
                "gemm_ms": gemm})
    empty = _bare_ms(lambda: iu.launch_empty(dev))
    torch.cuda.synchronize()
    _restore_pass_counts(saved)
    by_n = {kind: {p["pixels"]: p for p in v} for kind, v in per.items()}
    out = {}
    for kind, rows in per.items():
        launches = [by_n[kind][r["lv"].n] for r in records]
        mean = {k: float(np.mean([p[k] for p in launches]))
                for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms",
                          "gemm_ms")}
        for p in rows:
            print(f"icp {kind} timing ({label}, {p['pixels']} pixels on "
                  f"{p['grid']} CTAs, {p['accepted']} accepted): bare "
                  f"{p['ms']:.4f} ms ({BARE_LAUNCHES} launches in one CUDA "
                  f"graph), an empty kernel's node {empty:.4f} ms; wrapper "
                  f"{p['wrapper_ms']:.4f} ms; plain {p['plain_ms']:.4f} ms "
                  f"(its [8, P] x [P, 8] f32 product alone "
                  f"{p['gemm_ms']:.4f} ms, a partial yardstick); "
                  f"{p['bytes']} B and {p['operations']} operations: bound "
                  f"{p['bound_ms']:.2e} ms by {p['bound_by']}, "
                  f"{100 * p['bound_ms'] / p['ms']:.1f}% of it; on "
                  f"{gpu_line}")
        print(f"icp {kind} timing ({label}): {len(launches)} launches a "
              f"frame, bare {mean['ms']:.4f} ms a launch on average "
              f"({sum(p['ms'] for p in launches):.4f} ms a frame), plain "
              f"{mean['plain_ms']:.4f} ms")
        out[kind] = {**mean, "bound_by": rows[0]["bound_by"],
                     "bound_share": mean["bound_ms"] / mean["ms"],
                     "empty_ms": empty, "frame_ms":
                     sum(p["ms"] for p in launches), "levels": rows,
                     "per_frame": len(launches)}
    split = out["associate"]["frame_ms"] + out[lin_kind]["frame_ms"]
    print(f"icp passes ({label}): {out[pass_kind]['frame_ms']:.4f} ms a "
          f"tracked frame in {len(records)} fused launches on a single "
          f"device, {split:.4f} ms in {len(records)} + {len(records)} split "
          f"launches (the sharded path's form); on {gpu_line}")
    return out


def _icp_update_check(updates, sweeps, gpu_line):
    """(b): the ICP update kernel against its plain version on frame 11's
    updates (each from the carry the step left before it) and on the
    seeded bank of updates (every flag path), within
    ``icp_update.disagreements``; its bare time (``_bare_ms``: 100 launches
    in one CUDA graph, on each of frame 11's updates with the level's
    carry reset, so that every launch solves) beside an empty kernel's
    node timed the same way, the wrapper's and the plain tail's time, and
    its bound from frame 11's sweeps."""
    import numpy as np
    import torch
    from voxelhashing_tpu_torch.ops import icp_update as iu

    dev = updates[0][0].delta.device
    bank = []
    for e in iu.update_bank(seed=11, n_per_case=UPDATE_BANK):
        state, system, mean, inv_std, planar, color = iu.bank_inputs(e, dev)
        bank.append((state, system, mean, inv_std, planar, iu.BANK_GATE, 1,
                     2, e["begin"], color, (1.0, 0.1)))
    bad, errs = [], {}
    for label, inputs in (("frame 11", updates), ("bank", bank)):
        held = [_hold_update(iu, u) for u in inputs]
        dis = [(i, h[0]) for i, h in enumerate(held) if h[0]]
        errs[label] = (max(h[1] for h in held), max(h[2] for h in held))
        print(f"icp_update ({label}): {len(inputs)} updates, outside the "
              f"bounds {len(dis)}, max |d delta| {errs[label][0]:.3e} "
              f"(bound {iu.POSE_TOL:.0e} + {iu.POSE_DX_GAIN:.0f} |dx| (1 + "
              f"1/inv_std + |mean|)), max |dx| {errs[label][1]:.3e}")
        if dis:
            bad.append((label, dis[:5]))
    if bad:
        raise RuntimeError(f"icp_update against its plain version: {bad}")

    def timed(u):
        state, system, mean, inv_std, planar, gate, level, slot, begin, \
            color, weights = u
        st = iu.clone_state(state)          # alive until the replay ends
        args = iu.prepare(st, system, mean, inv_std, planar, gate, level,
                          slot, iu.BEGIN_LEVEL | iu.BEGIN_OUTER, color,
                          weights)
        return _bare_ms(lambda: iu.launch(args))

    launches = iu.icp_update.launches
    per_update = [timed(u) for u in updates]
    bare = float(np.mean(per_update))
    empty = _bare_ms(lambda: iu.launch_empty(dev))
    u0 = updates[0]                          # a level's first: never skips
    st_p, st_k = iu.clone_state(u0[0]), iu.clone_state(u0[0])
    plain = _median_ms(lambda: iu.icp_update_plain(st_p, *u0[1:]))
    wrapper = _median_ms(lambda: iu.icp_update(st_k, *u0[1:]))
    iu.icp_update.launches = launches      # timing launches do not count
    rgbd = u0[9] is not None
    nbytes = iu.bytes_moved(rgbd, u0[4] is not None)
    f64 = float(np.mean([iu.operations(s, rgbd)[0] for s in sweeps]))
    f32 = iu.operations(1, rgbd)[1]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (f64 / F64_OPS_PER_S + f32 / F32_OPS_PER_S) * 1e3
    bound = max(t_bytes, t_ops)
    print(f"icp_update timing: bare {bare:.4f} ms a launch (mean over frame "
          f"11's {len(updates)} updates, {min(per_update):.4f}-"
          f"{max(per_update):.4f}; {BARE_LAUNCHES} launches in one CUDA "
          f"graph), an empty kernel's node {empty:.4f} ms the same way; "
          f"wrapper {wrapper:.4f} ms; plain tail {plain:.4f} ms "
          f"(torch.linalg.svd and ~110 small ops, its host reads "
          f"included); {nbytes} B, {f64} f64 and {f32} f32 operations: "
          f"bound {bound:.2e} ms by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'} ({t_bytes:.2e} "
          f"ms at 3.35 TB/s, {t_ops:.2e} ms at 34 and 67 TFLOP/s); on "
          f"{gpu_line}")
    return {"ms": bare, "per_update_ms": per_update, "empty_ms": empty,
            "plain_ms": plain, "wrapper_ms": wrapper, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": f64 + f32,
            "max_abs_err": errs["frame 11"][0],
            "bank_max_abs_err": errs["bank"][0],
            "max_dx": errs["frame 11"][1], "per_frame": len(updates)}


def _graph_rgbd(mode, device, gpu_line):
    """(c): 20 frames of phase 6's configuration through ``make_step``:
    ATE, valid frames, the host syncs of frame 11, fused frames/s."""
    import torch
    from voxelhashing_tpu_torch import engine, evaluation

    cfg = _rgbd_config(mode)
    poses, depth, color = _frames(cfg.camera, device)
    state = engine.create(cfg, device=device)
    step = engine.make_step(cfg)
    events, est, valid, sites = [], [], [], None
    torch.cuda.synchronize()
    _zero_counts()
    for i in range(N_FRAMES):
        ctx = (_sync_sites() if i == GRAPH_SYNC_FRAME
               else contextlib.nullcontext())
        with ctx as counted:
            (state, diag), t = _timed_call(
                lambda: step(state, depth[i], color[i]))
        if counted is not None:
            sites = counted
        events.append(t)
        est.append(state.pose.clone())
        valid.append(diag.tracking_valid)
    torch.cuda.synchronize()
    counts = _counts()
    valid = [bool(v) for v in valid]
    ate = evaluation.ate_rmse([p.cpu().numpy() for p in est], poses,
                              align=False)
    out = {"fps": _fps(events, range(2, N_FRAMES)), "ate_mm": ate * 1000,
           "valid": sum(valid), "syncs": sum(sites.values()),
           "sites": sites, "counts": counts}
    step.close()
    return out


def _graph_scan(device, gpu_line):
    """(d): the large scan's outward leg (96 frames, GT replay) through
    ``make_step(with_hint=True, with_stream_mask=True)`` with
    ``AsyncStreamingManager``: frames/s (step and streaming step, CUDA
    events, frames 2-95 but the counted one), the step's host syncs of
    frame 48 apart from the manager's, the bytes adopted a frame."""
    import torch
    from voxelhashing_tpu_torch import blockmap, engine, streaming
    from voxelhashing_tpu_torch.io.synthetic import render_depth

    cfg = _large_scan_config()
    scene = _corridor()
    poses = _large_scan_poses()[:LS_OUT]
    frames = [render_depth(p, cfg.camera, scene, noise_sigma=0.002, seed=i,
                           device=device) for i, p in enumerate(poses)]
    depth = torch.stack([torch.nan_to_num(f[0], nan=0.0) for f in frames])
    color = torch.stack([f[1] for f in frames])
    del frames
    mgr = streaming.AsyncStreamingManager(cfg.map, cfg.streaming,
                                          device=device)
    state = engine.create(cfg, initial_pose=poses[0], device=device)
    step = engine.make_step(cfg, with_hint=True, with_stream_mask=True)
    events, step_sites, mgr_sites = [], None, None
    torch.cuda.synchronize()
    _zero_counts()
    try:
        for i, pose in enumerate(poses):
            ctx = (_sync_sites() if i == LS_SYNC_FRAME
                   else contextlib.nullcontext())
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            with ctx as counted:
                state, _ = step(state, depth[i], color[i], pose, mgr.bitmask)
            if counted is not None:
                step_sites = counted
            ctx = (_sync_sites() if i == LS_SYNC_FRAME
                   else contextlib.nullcontext())
            with ctx as counted:
                state = state._replace(map=mgr.step(state.map, pose[:3, 3]))
            if counted is not None:
                mgr_sites = counted
            b.record()
            events.append((a, b))
        mgr.flush()
        torch.cuda.synchronize()
        counts = _counts()
        host = mgr.host_block_count()
        viol = blockmap.check_invariants(state.map, cfg.map)
    finally:
        mgr.close()
    timed = [i for i in range(2, LS_OUT) if i != LS_SYNC_FRAME]
    out = {"fps": _fps(events, timed), "syncs": sum(step_sites.values()),
           "sites": step_sites, "mgr_syncs": sum(mgr_sites.values()),
           "mgr_sites": mgr_sites, "host_blocks": host, "invariants": viol,
           "bytes_per_frame": step.bytes_adopted / (LS_OUT - 1),
           "pool_bytes": step.pool_bytes_adopted, "counts": counts}
    step.close()
    return out


def _graph_maintain(device, gpu_line):
    """(e): phase 1's frames at a 65,536-block pool and table with empty
    blocks put behind the wall after frame 1 (9,000 keys, z 2.69-2.98 m):
    GC culls them and their tombstones pass 1/8 of the table, so
    ``compact_pool`` runs between two replays and the step takes the
    compacted map into its buffers. Every frame's map and pose equal the
    eager step's."""
    import dataclasses
    import torch
    from voxelhashing_tpu_torch import blockmap, engine, geometry as geom

    base = _config()
    cfg = dataclasses.replace(base, map=dataclasses.replace(
        base.map, num_blocks=1 << 16, table_size=1 << 16,
        max_active_blocks=1 << 16))
    mp = cfg.map
    _, depth, color = _frames(cfg.camera, device)
    vox = mp.block_size_world
    z0 = int(2.69 / vox)
    blocks = torch.stack(torch.meshgrid(
        torch.arange(-15, 15), torch.arange(-15, 15),
        torch.arange(z0, z0 + 10), indexing="ij"), dim=-1).reshape(-1, 3)
    keys = geom.pack_block_key(blocks.to(torch.int32).to(device),
                               mp.world_blocks)
    e = engine.create(cfg, device=device)
    g = engine.create(cfg, device=device)
    step = engine.make_step(cfg)
    compactions, diff, n_garbage = [], [], 0
    for i in range(N_FRAMES):
        if i == 2:
            me, n = blockmap.allocate(e.map, keys, mp, rounds=16)
            mg, _ = blockmap.allocate(g.map, keys, mp, rounds=16)
            e, g, n_garbage = e._replace(map=me), g._replace(map=mg), int(n)
        before = int(e.map.n_tombstones)
        e, _ = engine.step(e, depth[i], color[i], cfg)
        g, _ = step(g, depth[i], color[i])
        if int(e.map.n_tombstones) < before:
            compactions.append(i)
        if not (_maps_equal(e.map, g.map) and _bits_equal(e.pose, g.pose)):
            diff.append(i)
    out = {"garbage": n_garbage, "compactions": compactions, "diff": diff,
           "pool_bytes": step.pool_bytes_adopted}
    step.close()
    return out


def phase_graph(device, gpu_line, phase1_fps, rgbd_fps, scan_fps):
    """Phase 10: ``engine.make_step`` (see the module docstring). Returns
    its numbers and each path's launch counts."""
    t0 = time.perf_counter()
    cfg = _config()
    a, updates, passes = _graph_vs_eager(device, gpu_line)
    names = ("preprocess", "alloc_candidates", "fused_integrate",
             "splat_zbuf", "icp_update", "icp_associate_linearize",
             "icp_associate", "icp_linearize", "solve6", "hash_insert",
             "hash_gc", "hash_delete")
    counts = {k: sum(f[k] for f in a["per_frame"]) for k in a["per_frame"][0]}
    every = {k: [f[k] for f in a["per_frame"]] for k in names}
    print(f"graph (a): {N_FRAMES} frames of make_step(donate=True) against "
          f"the eager step in lockstep: frames where eager differs from "
          f"eager {a['det_diff']}, where the graphs differ from eager "
          f"{a['graph_diff']}; host syncs of tracked frame "
          f"{GRAPH_SYNC_FRAME} {a['syncs']} ({_sites_line(a['sites'])}); "
          f"pool kept from frame 1 on {a['ptrs_kept']}, pool bytes copied "
          f"in {a['pool_bytes']}, other state bytes copied in "
          f"{a['small_bytes']} (the first adoption); launches a frame "
          f"{every}")
    print(f"graph (a): fused frames/s (frames 2-{N_FRAMES - 1}, CUDA events "
          f"around each call, in lockstep) graphs {a['fps_graph']:.3f}, "
          f"eager {a['fps_eager']:.3f} (phase 1 {phase1_fps:.3f}); but "
          f"frame {cfg.map.gc_starve_interval} (the starve graph's "
          f"capture) graphs {a['fps_graph_steady']:.3f}, eager "
          f"{a['fps_eager_steady']:.3f}; on {gpu_line}")
    for key, (nodes, ms) in sorted(a["graphs"].items()):
        print(f"graph (a): graph {key!r}: {nodes} nodes, captured in "
              f"{ms:.1f} ms (its front warm-up included)")
    alone = _graph_alone(device, gpu_line)
    print(f"graph (a), alone: {alone['fps']:.3f} fused frames/s (frames "
          f"{alone['timed'][0]}-{alone['timed'][-1]} but "
          f"{cfg.map.gc_starve_interval}, CUDA events); device "
          f"{alone['dev_ms']:.3f} ms of kernels and "
          f"{alone['device_ops']:.0f} device ops a frame (torch.profiler, "
          f"frames {N_FRAMES - GRAPH_BUSY_FRAMES}-{N_FRAMES - 1}), "
          f"{alone['wall_ms']:.3f} ms wall a frame unprofiled (frames "
          f"10-{9 + GRAPH_BUSY_FRAMES}): busy "
          f"{100 * alone['busy']:.1f}%; peak memory {alone['peak']} B "
          f"allocated (the map {alone['map_bytes']} B), "
          f"{alone['reserved']} B reserved with the graphs' pool; on "
          f"{gpu_line}")
    s6 = _solve6_check([(u[1][0], u[1][1]) for u in updates], gpu_line)
    upd = _icp_update_check(updates, s6["sweeps"], gpu_line)
    rgbd_passes = _rgbd_records(device)
    held = {"frame11": _hold_passes(passes, "frame 11, depth only"),
            "rgbd": _hold_passes(rgbd_passes, "frame 11, splat + RGB-D"),
            "edge": _hold_passes(_edge_records(device), "edge bank")}
    pass_times = _pass_times(passes, gpu_line, "frame 11, depth only")
    rgbd_times = _pass_times(rgbd_passes, gpu_line,
                             "frame 11, splat + RGB-D")
    pass_times.update(linearize_color=rgbd_times["linearize_color"],
                      pass_color=rgbd_times["pass_color"],
                      associate_rgbd=rgbd_times["associate"])
    del rgbd_passes
    rgbd = {}
    for mode in ("splat", "march"):
        r = _graph_rgbd(mode, device, gpu_line)
        rgbd[mode] = r
        print(f"graph (c) {mode} + RGB-D: ATE {r['ate_mm']:.3f} mm, valid "
              f"{r['valid']} of {N_FRAMES}, host syncs of frame "
              f"{GRAPH_SYNC_FRAME} {r['syncs']} ({_sites_line(r['sites'])})"
              f", {r['fps']:.3f} fused frames/s (phase 6 eager "
              f"{rgbd_fps[mode]:.3f}), counts {r['counts']}; on {gpu_line}")
    scan = _graph_scan(device, gpu_line)
    print(f"graph (d) large scan, outward leg, GT replay, streamed: "
          f"{scan['fps']:.3f} frames/s (phase 5 streamed, eager "
          f"{scan_fps:.3f}); host syncs of frame {LS_SYNC_FRAME} in "
          f"make_step {scan['syncs']} ({_sites_line(scan['sites'])}), in "
          f"the manager {scan['mgr_syncs']} "
          f"({_sites_line(scan['mgr_sites'])}); host blocks "
          f"{scan['host_blocks']}; state bytes copied in a frame "
          f"{scan['bytes_per_frame']:.0f} (pool {scan['pool_bytes']}); "
          f"invariants {scan['invariants']}; counts {scan['counts']}; on "
          f"{gpu_line}")
    mnt = _graph_maintain(device, gpu_line)
    print(f"graph (e) forced maintain: {mnt['garbage']} empty blocks put "
          f"behind the wall after frame 1, compact_pool at frames "
          f"{mnt['compactions']}, pool bytes copied in after it "
          f"{mnt['pool_bytes']}, frames differing from eager {mnt['diff']}")
    wall = time.perf_counter() - t0
    print(f"phase 10: wall {wall:.1f} s")

    fails = []
    if a["graph_diff"] and a["graph_diff"] != a["det_diff"]:
        fails.append(f"graphs differ from eager at {a['graph_diff']}")
    if a["syncs"] != 2:
        fails.append(f"{a['syncs']} host syncs in a tracked frame")
    if not a["ptrs_kept"] or a["pool_bytes"]:
        fails.append("the pool moved or was copied in")
    track = _track_launches(cfg)
    want = {"fused_integrate": 1, "splat_zbuf": 1, "solve6": 0, **track,
            **_front_launches(1, 1), **_hash_launches(1),
            **_march_launches(0, 0)}
    if any(f[k] != (0 if (i == 0 and k in track) else v)
           for i, f in enumerate(a["per_frame"]) for k, v in want.items()):
        fails.append(f"launches a frame {every}")
    if any(v for k, v in counts.items() if k.startswith("plain")):
        fails.append(f"a plain version ran on the card: {counts}")
    for mode, r in rgbd.items():
        c = r["counts"]
        if r["ate_mm"] >= ATE_LIMIT_M * 1000 or r["valid"] != N_FRAMES \
                or r["syncs"] != 2 or c["fused_integrate"] != N_FRAMES \
                or _launches_off(c, _track_launches(cfg, N_FRAMES - 1,
                                                    rgbd=True)) \
                or _launches_off(c, _front_launches(N_FRAMES, N_FRAMES)) \
                or _launches_off(c, _hash_launches(N_FRAMES)) \
                or _launches_off(c, _march_launches(
                    *(2 * (N_FRAMES if mode == "march" else 0,)))) \
                or c.get("plain ray_bounds on CUDA") \
                or c.get("plain march on CUDA") \
                or c["solve6"] \
                or c["splat_zbuf_color"] != (N_FRAMES if mode == "splat"
                                             else 0):
            fails.append(f"{mode} + RGB-D: {r}")
    if scan["syncs"] != 1 or scan["host_blocks"] <= 0 or scan["pool_bytes"] \
            or any(v != 0 for v in scan["invariants"].values()) \
            or scan["counts"]["fused_integrate"] != LS_OUT \
            or scan["counts"]["splat_zbuf"] != LS_OUT \
            or _launches_off(scan["counts"], _front_launches(LS_OUT,
                                                             LS_OUT)) \
            or _launches_off(scan["counts"], {k: 0 for k in track}) \
            or _launches_off(scan["counts"], _march_launches(0, 0)) \
            or scan["counts"]["hash_insert"] < LS_OUT \
            or scan["counts"]["hash_delete"] < LS_OUT \
            or scan["counts"]["hash_gc"] != LS_OUT \
            or scan["counts"]["solve6"]:
        fails.append(f"large scan: {scan}")
    if not mnt["compactions"] or mnt["diff"] or not mnt["pool_bytes"]:
        fails.append(f"forced maintain: {mnt}")
    if fails:
        raise RuntimeError("phase 10: " + "; ".join(fails))
    return {"a": a, "alone": alone, "solve6": s6, "icp_update": upd,
            "held": held, "pass_times": pass_times, "rgbd": rgbd,
            "scan": scan, "maintain": mnt, "wall_s": wall, "counts": counts}


def _kernel_entry(res, launches):
    """One kernel's numbers in the kernels JSON line."""
    return {"launches": launches, "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "wrapper_ms": res["wrapper_ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "bound_share": res["bound_share"],
            "library_ms": None, "profiler_ms": res["profiler_ms"],
            "rows": res["rows"], "bytes": res["bytes"],
            "operations": res["operations"]}


def _device_time_a(cfg, base, depth, color, pose, aidx, n_act):
    """Kernel A's device time per call through its public wrapper
    (torch.profiler, so that any checkout's kernel is timed alike, whatever
    its launch interface; with ``cfg.map.bilinear_color`` the variant and
    its color-word image, where the checkout has one), the wrapper's own
    time, and the counts its bound needs (``_work_a``)."""
    from voxelhashing_tpu_torch.ops import fused_integrate as fa

    cam, mp = cfg.camera, cfg.map
    n = int(n_act)
    st = _clone(base)
    call = lambda: fa.fused_integrate(                         # noqa: E731
        st, depth, color, pose, cam, mp, aidx, n_act)
    call()
    n_upd = _changed_voxels(base, st, aidx[:n])
    return {"device_ms": _profiled_ms(call, ("fused_integrate",
                                             "frame_color_words")),
            "wrapper_ms": _median_ms(call), "rows": n,
            "updated_voxels": n_upd, "max_rows": aidx.shape[0],
            "with_color": color is not None}


def _device_time_b(cfg, map_state, view, aidx, has_surf):
    """Kernel B's times and counts, as ``_device_time_a``."""
    from voxelhashing_tpu_torch.ops import splat_zbuf as sb

    cam, mp = cfg.camera, cfg.map
    call = lambda: sb.splat_zbuf(map_state, aidx, has_surf,    # noqa: E731
                                 view, cam, mp)
    return {"device_ms": _profiled_ms(call, "splat_zbuf"),
            "wrapper_ms": _median_ms(call), "rows": int(has_surf.sum()),
            "band_voxels": _band_voxels(cfg, map_state, aidx, has_surf),
            "max_rows": aidx.shape[0]}


def _device_time_color(cfg, map_state, view, aidx, has_surf):
    """A color render's times and counts, as ``_device_time_a``: the color
    walk and the resolve (``splat_zbuf_color``), or in a checkout before
    them kernel B and its second walk (``splat_zbuf``, then
    ``splat_color``)."""
    import torch
    from voxelhashing_tpu_torch.ops import splat_zbuf as sb

    cam, mp = cfg.camera, cfg.map
    if hasattr(sb, "splat_zbuf_color"):
        call = lambda: sb.splat_zbuf_color(                    # noqa: E731
            map_state, aidx, has_surf, view, cam, mp)
    else:
        call = lambda: sb.splat_color(                         # noqa: E731
            map_state, aidx, has_surf, view, cam, mp,
            sb.splat_zbuf(map_state, aidx, has_surf, view, cam, mp))
    zbuf, _ = sb.splat_zbuf_plain(map_state, aidx, has_surf, view, cam, mp)
    return {"device_ms": _profiled_ms(call, ("splat_zbuf_kernel",
                                             "splat_resolve")),
            "wrapper_ms": _median_ms(call), "rows": int(has_surf.sum()),
            "band_voxels": _band_voxels(cfg, map_state, aidx, has_surf),
            "covered": int(torch.isfinite(zbuf).sum()),
            "max_rows": aidx.shape[0]}


def kernel_times_here():
    """Kernels A's and B's device and wrapper times (``_device_time_a``,
    ``_device_time_b``) at the phase-2/3 state and at the state just after
    the large scan's first stream-in, a color render's
    (``_device_time_color``) and the bilinear variant's (None where the
    checkout has none) at the phase-2/3 state, and phase 4's per-stage
    times, with the kernels of the ``voxelhashing_tpu_torch`` that imports
    from the working directory (``python -m voxelhashing_tpu_torch.ab_step``
    runs this in each checkout), and the streamed large-scan run's
    frames/s. Returns plain numbers."""
    import dataclasses
    import torch
    from voxelhashing_tpu_torch import streaming
    from voxelhashing_tpu_torch.io.synthetic import render_depth
    from voxelhashing_tpu_torch.ops.fused_integrate import fused_integrate

    device = torch.device("cuda", 0)
    gpu_line = _smi()
    cfg = _config()
    snap, est, depth, color, _, _, _ = phase_step(cfg, device, gpu_line)
    out = {"card": gpu_line}
    base, d, c, aidx, n_act = _a_inputs(cfg, snap.map, depth[11], color[11],
                                        est[11], 11)
    out["a"] = _device_time_a(cfg, base, d, c, est[11], aidx, n_act)
    out["bl"] = None
    if hasattr(fused_integrate, "bilinear_launches"):
        bcfg = dataclasses.replace(cfg, map=dataclasses.replace(
            cfg.map, bilinear_color=True))
        out["bl"] = _device_time_a(bcfg, base, d, c, est[11], aidx, n_act)
    del base
    b_inputs = _b_inputs(cfg, snap.map, snap.pose)
    out["b"] = _device_time_b(cfg, snap.map, *b_inputs)
    out["c"] = _device_time_color(cfg, snap.map, *b_inputs)
    del snap, est, b_inputs
    out["stages"] = phase_stages(cfg, depth, color, device, gpu_line)
    del depth, color

    lcfg = _large_scan_config()
    scene = _corridor()
    poses = _large_scan_poses()
    frames = [render_depth(p, lcfg.camera, scene, noise_sigma=0.002, seed=i,
                           device=device) for i, p in enumerate(poses)]
    depth = torch.stack([torch.nan_to_num(f[0], nan=0.0) for f in frames])
    color = torch.stack([f[1] for f in frames])
    del frames
    mgr = streaming.AsyncStreamingManager(lcfg.map, lcfg.streaming,
                                          device=device)
    try:
        run = _scan_run(lcfg, poses, depth, color, device, mgr, gpu_line,
                        "streamed")
    finally:
        mgr.close()
    del depth, color
    out["scan_fps"] = run["fps"]
    snap_map, bitmask, _, pose, d, c = _stream_in_inputs(
        lcfg, scene, run["snap"], device)
    del run
    base, d, c, aidx, n_act = _a_inputs(lcfg, snap_map, d, c, pose,
                                        len(poses), bitmask)
    out["a5"] = _device_time_a(lcfg, base, d, c, pose, aidx, n_act)
    del base
    out["b5"] = _device_time_b(lcfg, snap_map, *_b_inputs(lcfg, snap_map,
                                                         pose))
    return out


def main() -> int:
    import torch
    gpu_line = _smi()
    print(gpu_line)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path here",
              file=sys.stderr)
        return 1
    count = torch.cuda.device_count()
    if count != 1:
        print(f"chip_smoke: runs on one card, {count} are visible (set "
              "CUDA_VISIBLE_DEVICES)", file=sys.stderr)
        return 1
    import concurrent.futures
    from voxelhashing_tpu_torch import native
    from voxelhashing_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    # one nvcc per kernel source and g++ for the host chunk store, side by
    # side
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        built = pool.submit(_build.build)
        host_lib = pool.submit(native.build)
        paths = built.result()
        host_path = host_lib.result()
    for name in paths:
        _build.library(name)
    native.library()
    print(f"kernels and host runtime built in {time.perf_counter() - t0:.1f}"
          f" s: {', '.join(str(p) for p in paths.values())}, {host_path}")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        if log.exists():
            print(f"ptxas, {name}:\n{log.read_text().strip()}")
    lib_a = _build.library("fused_integrate")
    print(f"persistent grids: fused_integrate "
          f"{lib_a.vh_fused_integrate_grid()} CTAs, its bilinear variant "
          f"{lib_a.vh_fused_integrate_bilinear_grid()} CTAs, splat_zbuf "
          f"{_build.library('splat_zbuf').vh_splat_zbuf_grid()} CTAs, "
          f"its color walk "
          f"{_build.library('splat_zbuf').vh_splat_zbuf_color_grid()} CTAs, "
          f"of 128 threads, on {torch.cuda.get_device_name(0)} "
          f"({torch.cuda.get_device_properties(0).multi_processor_count} "
          f"SMs)")

    cfg = _config()
    hash_calls = []
    snap, est, depth, color, launches, fps, calls = phase_step(
        cfg, device, gpu_line, hash_calls=hash_calls)
    syncs = count_syncs(cfg, snap, depth, color)
    # phases 2 and 3: the state after frame 10, frame 11's inputs
    res_a, _ = check_kernel_a(cfg, snap.map, depth[11], color[11], est[11],
                              11, "kernel A", gpu_line)
    res_b = check_kernel_b(cfg, snap.map, snap.pose, "kernel B", gpu_line)
    res_c = check_color(cfg, snap.map, snap.pose, "color render", gpu_line)
    phase_edge_cases(cfg, snap.map, depth[11], color[11], est[11], 11)
    front = phase_front(cfg, depth, color, calls, gpu_line)
    del calls
    hashed = phase_hash(cfg, snap.map, hash_calls, gpu_line)
    del hash_calls
    stages = phase_stages(cfg, depth, color, device, gpu_line)
    del snap, est, depth, color
    scan = phase_large_scan(device, gpu_line)
    rgbd = {mode: phase_rgbd(mode, device, gpu_line)
            for mode in ("march", "splat")}
    slam = phase_slam(device, gpu_line)
    res_bl, bl_counts = phase_bilinear(device, gpu_line)
    shard = phase_sharded(device, gpu_line, slam["graph"])
    dense = phase_dense(device, gpu_line)
    fps_s, fps_u = scan["fps"]
    graph = phase_graph(device, gpu_line, fps,
                        {m: r["fps"] for m, r in rgbd.items()}, fps_s)

    names = ("fused_integrate", "splat_zbuf", "splat_zbuf_color",
             "fused_integrate_bilinear", "frame_color_words", "icp_update",
             "solve6", "icp_associate", "icp_linearize",
             "icp_linearize_color", "icp_associate_linearize",
             "icp_associate_linearize_color", "preprocess",
             "alloc_candidates",
             "hash_insert", "hash_gc", "hash_delete", "ray_bounds",
             "raymarch")
    by_path = {name: {"step": launches.get(name, 0),
                      **{f"{mode}_rgbd": r["counts"][name]
                         for mode, r in rgbd.items()},
                      "slam_live": slam["live"][name],
                      "slam_reintegrate": slam["reintegrate"][name],
                      "bilinear": bl_counts[name],
                      **{path: c[name]
                         for path, c in shard["counts"].items()},
                      "dense_step": dense["step"]["counts"][name],
                      "dense_oracle": dense["oracle"]["counts"][name],
                      "graph_step": graph["counts"][name],
                      **{f"graph_{mode}_rgbd": r["counts"][name]
                         for mode, r in graph["rgbd"].items()},
                      "graph_large_scan": graph["scan"]["counts"][name]}
               for name in names}
    kernels = []
    for name, key, res, source, replaces, path, globals_ in (
            ("fused_integrate", "a", res_a,
             "voxelhashing_tpu_torch/csrc/fused_integrate.cu",
             "voxelhashing_tpu/ops/pallas_integrate.py:321", "step",
             ["fused_integrate_kernel<false>"]),
            ("splat_zbuf", "b", res_b,
             "voxelhashing_tpu_torch/csrc/splat_zbuf.cu",
             "voxelhashing_tpu/ops/pallas_splat.py:188", "step",
             ["splat_zbuf_kernel<false>"]),
            # a color render, the color walk and the resolve, launched
            # together; no TPU kernel: the XLA color pass of
            # raycast._splat_zbuf
            ("splat_zbuf_color", None, res_c,
             "voxelhashing_tpu_torch/csrc/splat_zbuf.cu",
             "voxelhashing_tpu/raycast.py:437", "splat_rgbd",
             ["splat_zbuf_kernel<true>", "splat_resolve_kernel"]),
            # kernel A's bilinear variant after the frame's color-word
            # image, launched together: on the TPU this configuration runs
            # the XLA integrate with integrate._bilinear_color, not the
            # Pallas kernel
            ("fused_integrate_bilinear", None, res_bl,
             "voxelhashing_tpu_torch/csrc/fused_integrate.cu",
             "voxelhashing_tpu/integrate.py:450", "bilinear",
             ["frame_color_words_kernel", "fused_integrate_kernel<true>"])):
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 **_kernel_entry(res, by_path[name][path]),
                 "kernels": globals_, "launches_by_path": by_path[name]}
        if name == "fused_integrate_bilinear":
            entry["frame_color_words"] = {
                "launches": by_path["frame_color_words"][path],
                "ms": res["pre_pass_ms"],
                "launches_by_path": by_path["frame_color_words"]}
        if key is not None:
            entry["max_abs_err"] = max(res["max_abs_err"],
                                       scan[key]["max_abs_err"])
            entry["large_scan"] = _kernel_entry(
                scan[key], {k: v[name] for k, v in scan["launches"].items()})
        kernels.append(entry)
    # the tracker's ICP update (one launch a 6x6 solve); no TPU kernel:
    # the XLA tail of voxelhashing_tpu/tracking.py:560-590 and its SVD
    # (:339)
    upd = graph["icp_update"]
    kernels.append({
        "name": "icp_update", "route": "cuda",
        "source": "voxelhashing_tpu_torch/csrc/solve6.cu", "replaces": None,
        **_kernel_entry({**upd, "bound_share": upd["bound_ms"] / upd["ms"],
                         "profiler_ms": None, "rows": 1},
                        by_path["icp_update"]["step"]),
        "kernels": ["icp_update_kernel"], "empty_node_ms": upd["empty_ms"],
        "svd_ms": graph["solve6"]["svd_ms"], "max_dx": upd["max_dx"],
        "bank_max_abs_err": upd["bank_max_abs_err"],
        "launches_by_path": by_path["icp_update"]})
    # its core batched (the checks; no path launches it)
    kernels.append({
        "name": "solve6", "route": "cuda", "on_main_path": False,
        "source": "voxelhashing_tpu_torch/csrc/solve6.cu", "replaces": None,
        **_kernel_entry({**graph["solve6"], "bound_share": graph["solve6"]["bound_ms"]
                         / graph["solve6"]["ms"], "profiler_ms": None,
                         "rows": 1}, by_path["solve6"]["step"]),
        "kernels": ["solve6_kernel"], "batch_ms": graph["solve6"]["batch_ms"],
        "sweeps": graph["solve6"]["sweeps"],
        "svd_ms": graph["solve6"]["svd_ms"],
        "launches_by_path": by_path["solve6"]})
    # the tracker's passes: on a single device one fused launch an outer
    # iteration (the association and the linearization), on the sharded
    # path one association an outer iteration and one linearization an
    # inner one; no TPU kernel: the XLA passes of voxelhashing_tpu/
    # tracking.py (_associate :125, _whitening :183, _planarity :210,
    # _linearize :242, _build_system_color :358)
    held, times = graph["held"], graph["pass_times"]
    for name, kind, path, replaces, globals_, hkeys in (
            ("icp_associate_linearize", "pass", "step",
             "voxelhashing_tpu/tracking.py:125",
             ["icp_pass_kernel<true, true, false>"], ("assoc", "depth")),
            ("icp_associate_linearize_color", "pass_color", "splat_rgbd",
             "voxelhashing_tpu/tracking.py:358",
             ["icp_pass_kernel<true, true, true>"], ("assoc", "color")),
            ("icp_associate", "associate", "sharded",
             "voxelhashing_tpu/tracking.py:125",
             ["icp_pass_kernel<true, false, false>"], ("assoc",)),
            ("icp_linearize", "linearize", "sharded",
             "voxelhashing_tpu/tracking.py:242",
             ["icp_pass_kernel<false, true, false>"], ("depth",)),
            ("icp_linearize_color", "linearize_color", "sharded_splat_rgbd",
             "voxelhashing_tpu/tracking.py:358",
             ["icp_pass_kernel<false, true, true>"], ("color",))):
        t = times[kind]
        errs = [h[k] for h in held.values() for k in hkeys if k in h]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "voxelhashing_tpu_torch/csrc/icp_linearize.cu",
            "replaces": replaces, "launches": by_path[name][path],
            "max_abs_err": max(e[0] for e in errs), "ms": t["ms"],
            "wrapper_ms": t["wrapper_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "bound_share": t["bound_share"], "library_ms": None,
            "empty_node_ms": t["empty_ms"], "frame_ms": t["frame_ms"],
            "per_frame": t["per_frame"], "gemm_ms": t["gemm_ms"],
            "excess": max(e[1] for e in errs),
            "levels": [{k: p[k] for k in ("pixels", "grid", "ms",
                                           "wrapper_ms", "plain_ms",
                                           "bound_ms", "accepted",
                                           "gemm_ms")}
                       for p in t["levels"]],
            "kernels": globals_, "launches_by_path": by_path[name]})
    per_update = {
        path: {k: round(18 * by_path[k][path]
                        / max(by_path["icp_update"][path], 1), 3)
               for k in ("icp_associate_linearize",
                         "icp_associate_linearize_color", "icp_associate",
                         "icp_linearize", "icp_linearize_color")}
        for path in by_path["icp_update"] if by_path["icp_update"][path]}
    print(f"icp pass launches per 18 ICP updates (a tracked frame of the "
          f"default tracker), by path (fused, fused with color, "
          f"association, linearization, linearization with color): "
          f"{per_update}")
    # the front kernels (one preprocess a preprocessed frame, one
    # candidates launch an integrated frame); no TPU kernel: the XLA
    # preprocess of voxelhashing_tpu/ops/image.py:217-245 (with
    # geometry.py:203 and :269) and the XLA candidates of
    # voxelhashing_tpu/integrate.py:177 (_dda_band_keys :39,
    # _dedup_and_fold :137)
    for name, replaces in (
            ("preprocess", "voxelhashing_tpu/ops/image.py:217"),
            ("alloc_candidates", "voxelhashing_tpu/integrate.py:177")):
        t, ls = front[name], scan["front"][name]
        globals_ = t["kernels"]
        entry = {"name": name, "route": "cuda",
                 "source": f"voxelhashing_tpu_torch/csrc/{name}.cu",
                 "replaces": replaces, "launches": by_path[name]["step"],
                 "max_abs_err": max(t["max_abs_err"], ls["max_abs_err"]),
                 **{k: t[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "bound_share")},
                 "library_ms": None, "empty_node_ms": t["empty_ms"],
                 "bytes": t["bytes"], "operations": t["operations"],
                 "per_frame": by_path[name]["step"] / N_FRAMES,
                 "large_scan": {k: ls[k] for k in (
                     "ms", "wrapper_ms", "plain_ms", "bound_ms",
                     "bound_by", "bound_share", "bytes", "operations")},
                 "kernels": globals_, "ctas": t["ctas"],
                 "launches_by_path": by_path[name]}
        if name == "alloc_candidates":
            entry["pixel_mode"] = {
                k: front["alloc_candidates_pixel"][k]
                for k in ("kernels", "ctas", "ms", "wrapper_ms", "plain_ms",
                          "bound_ms", "bound_by")}
        kernels.append(entry)
    # the map's hash writes (one insert launch a round of allocation, one
    # GC launch an integrated frame, one list delete a stream-out); no TPU
    # kernel: the XLA allocate of voxelhashing_tpu/blockmap.py:187
    # (_allocate_unique :264, _insert_new :343), its delete_blocks :564
    # and the GC of voxelhashing_tpu/integrate.py:532 that calls it. The
    # list delete is timed at phase 1's frame 11 on the GC call's short
    # list and at the scan's first stream-out; its launches are the
    # streamed scan run's stream-outs (GC no longer launches it)
    keys = ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
            "bound_share", "bytes", "operations", "work")
    for name, source, replaces, globals_ in (
            ("hash_insert", "hash_alloc", "voxelhashing_tpu/blockmap.py:187",
             ["hash_alloc_kernel"]),
            ("hash_gc", "hash_delete", "voxelhashing_tpu/integrate.py:532",
             ["hash_delete_kernel<true>"]),
            ("hash_delete", "hash_delete", "voxelhashing_tpu/blockmap.py:564",
             ["hash_delete_kernel<false>"])):
        t = hashed[name]
        streamed = scan["launches"]["streamed"]
        entry = {
            "name": name, "route": "cuda",
            "source": f"voxelhashing_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            "launches": (streamed[name] if name == "hash_delete"
                         else by_path[name]["step"]),
            "max_abs_err": 0.0,
            **{k: t[k] for k in keys + (("stage",) if name == "hash_insert"
                                        else ())},
            "library_ms": None, "empty_node_ms": t["empty_ms"],
            "per_frame": by_path[name]["step"] / N_FRAMES,
            "held": {"phase1": t["held"], "large_scan": scan["hash"]["held"]},
            "large_scan_launches": {k: v[name]
                                    for k, v in scan["launches"].items()},
            "kernels": globals_, "launches_by_path": by_path[name]}
        if name != "hash_delete":
            entry["large_scan"] = {k: scan["hash"]["step"][name][k]
                                   for k in keys}
        if name != "hash_gc":
            entry["stream_in" if name == "hash_insert" else "stream_out"] = {
                k: scan["hash"]["stream"][name][k] for k in keys}
        if name == "hash_gc":
            entry["gc_stage"] = {"device_ms": stages["device_split"]["gc"][0],
                                 "device_ops":
                                     stages["device_split"]["gc"][1]}
        kernels.append(entry)
    # the march renderer (one bounds launch and one march launch a
    # rendered frame with the march); no TPU kernel: the XLA march of
    # voxelhashing_tpu/raycast.py (ray_interval_splat :148, render_march
    # :455, march_core :509, trilinear_sample_soa :83, sdf_gradient :119)
    # and blockmap.py (lookup :156, gather_voxels_soa :520)
    marched = rgbd["march"]["march"]
    rm_lanes = marched["raymarch"]["lanes"]
    for name, replaces, globals_ in (
            ("raymarch", "voxelhashing_tpu/raycast.py:509",
             [f"raymarch_kernel<false, {rm_lanes}>"]),
            ("ray_bounds", "voxelhashing_tpu/raycast.py:148",
             ["ray_bounds_kernel"])):
        t = marched[name]
        entry = {"name": name, "route": "cuda",
                 "source": "voxelhashing_tpu_torch/csrc/raymarch.cu",
                 "replaces": replaces,
                 "launches": by_path[name]["march_rgbd"],
                 "max_abs_err": t["max_abs_err"],
                 **{k: t[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "bound_share")},
                 "library_ms": None, "empty_node_ms": t["empty_ms"],
                 "bytes": t["bytes"], "operations": t["operations"],
                 "work": t["work"],
                 "per_frame": by_path[name]["march_rgbd"] / N_FRAMES,
                 **({"graph_nodes": t["graph_nodes"]}
                    if name == "ray_bounds" else {}),
                 "kernels": globals_, "launches_by_path": by_path[name]}
        if name == "raymarch":
            entry.update({k: t[k] for k in (
                "samples_per_ray", "lookups_per_ray",
                "plain_lookups_per_ray", "lanes", "issued_per_ray", "chain",
                "thread_issued_per_ray", "thread_chain")})
        kernels.append(entry)
    split = rgbd["march"]["device"]["split"]
    print(f"summary: fps={fps:.3f} host_syncs_per_frame={syncs} "
          f"large_scan_fps_streamed={fps_s:.3f} "
          f"large_scan_fps_unstreamed={fps_u:.3f} "
          f"march_rgbd_fps={rgbd['march']['fps']:.3f} "
          f"march_rgbd_render_ms={rgbd['march']['stages']['render']:.3f} "
          f"march_rgbd_render_device_ms={split['render'][0]:.4f} "
          f"march_rgbd_render_device_ops={split['render'][1]:.1f} "
          f"raymarch_ms={marched['raymarch']['ms']:.4f} "
          f"ray_bounds_ms={marched['ray_bounds']['ms']:.4f} "
          f"splat_rgbd_fps={rgbd['splat']['fps']:.3f}; kernel A bare "
          f"{res_a['ms']:.4f} ms ({100 * res_a['bound_share']:.1f}% of its "
          f"bound), kernel B bare {res_b['ms']:.4f} ms "
          f"({100 * res_b['bound_share']:.1f}%), color render (walk + "
          f"resolve) bare {res_c['ms']:.4f} ms "
          f"({100 * res_c['bound_share']:.1f}%), "
          f"bilinear A (with its color-word image) bare "
          f"{res_bl['ms']:.4f} ms "
          f"({100 * res_bl['bound_share']:.1f}%); slam loops={slam['loops']} "
          f"ate_mm={slam['ate_mm'][0]:.3f}->{slam['ate_mm'][1]:.3f} "
          f"register_ms={slam['register_ms']:.3f} "
          f"optimize_ms={slam['optimize_ms']:.3f} "
          f"reintegrate_fps={slam['reintegrate_fps']:.3f} "
          f"reloc_mm={slam['reloc'][0] * 1000:.3f} "
          f"sharded_fps={shard['ranks'][0]['a']['fps']:.3f} "
          f"sharded_reduces_per_frame="
          f"{shard['ranks'][0]['a']['reduces_per_frame']:.1f} "
          f"sharded_wall_s={shard['wall_s']:.1f} "
          f"dense_integrate_ms={dense['integrate']['ms']:.4f} "
          f"dense_fps={dense['step']['fps']:.3f} "
          f"dense_ate_mm={dense['step']['ate_mm']:.3f} "
          f"dense_triangles={dense['mesh']['triangles']} "
          f"graph_fps={graph['alone']['fps']:.3f} "
          f"graph_lockstep_fps={graph['a']['fps_graph']:.3f} "
          f"eager_lockstep_fps={graph['a']['fps_eager']:.3f} "
          f"graph_busy={100 * graph['alone']['busy']:.1f}% "
          f"graph_syncs={graph['a']['syncs']} "
          f"graph_splat_rgbd_fps={graph['rgbd']['splat']['fps']:.3f} "
          f"graph_march_rgbd_fps={graph['rgbd']['march']['fps']:.3f} "
          f"graph_scan_fps={graph['scan']['fps']:.3f} "
          f"view_nodes={graph['a']['graphs']['view'][0]} "
          f"front_nodes={graph['a']['graphs']['front'][0]} "
          f"icp_update_ms={graph['icp_update']['ms']:.4f} "
          f"icp_pass_ms={times['pass']['ms']:.4f} "
          f"icp_pass_frame_ms={times['pass']['frame_ms']:.4f} "
          f"icp_pass_color_ms={times['pass_color']['ms']:.4f} "
          f"icp_associate_ms={times['associate']['ms']:.4f} "
          f"icp_linearize_ms={times['linearize']['ms']:.4f} "
          f"icp_linearize_color_ms={times['linearize_color']['ms']:.4f} "
          f"empty_node_ms={graph['icp_update']['empty_ms']:.4f} "
          f"solve6_ms={graph['solve6']['ms']:.4f} "
          f"preprocess_ms={front['preprocess']['ms']:.4f} "
          f"alloc_candidates_ms={front['alloc_candidates']['ms']:.4f} "
          f"hash_insert_ms={hashed['hash_insert']['ms']:.4f} "
          f"hash_delete_ms={hashed['hash_delete']['ms']:.4f} "
          f"hash_gc_ms={hashed['hash_gc']['ms']:.4f} "
          f"gc_stage_device_ms={stages['device_split']['gc'][0]:.4f} "
          f"gc_stage_device_ops={stages['device_split']['gc'][1]:.1f} "
          f"graph_wall_s={graph['wall_s']:.1f}; on {gpu_line}")
    print(f"card: {gpu_line}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
