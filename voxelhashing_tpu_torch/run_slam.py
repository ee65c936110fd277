"""Offline SLAM entry point of the PyTorch port: a sequence (synthetic, a TUM
directory, an mLib ``.sensor`` dump, or one or more ``.sens`` files)
through ``engine.make_step``, with optional RGB-D tracking, streaming, the
keyframe pose graph with loop closure, relocalization and re-integration
under the corrected trajectory, per-frame renders, diagnostics, whole-scene
mesh, point cloud, checkpoints and recording.

    python -m voxelhashing_tpu_torch.run_slam --frames 20 --preset tiny
    python -m voxelhashing_tpu_torch.run_slam --frames 30 --streaming \\
        --mesh out.ply --save-map map.npz
    python -m voxelhashing_tpu_torch.run_slam --input sens:a.sens,b.sens \\
        --posegraph --reintegrate --histogram --timings
    python -m voxelhashing_tpu_torch.run_slam --input tum:DIR --trace tr

The counterpart of ``scripts/run_slam.py``: the same flags, with
``--device`` (default ``cuda``, failing without a card; ``--device cpu``
runs on the CPU) in place of ``--cpu``, and ``--trace DIR`` writing a
``torch.profiler`` Chrome trace. Synthetic frames are rendered on the
device; recorded ones are decoded on the host (``.sens`` through a
read-ahead thread) and uploaded. Ends with the ATE against the ground
truth the source gives (limit 50 mm, not checked with ``--gt``), the map
invariants, and ``RESULT: OK`` or ``RESULT: FAIL`` (exit code 1).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .config import (CameraConfig, EngineConfig, FilterConfig, MapConfig,
                     StreamingConfig, TrackerConfig)

ATE_LIMIT_M = 0.05


def build_config(preset: str, streaming: bool) -> EngineConfig:
    """The presets of ``scripts/run_slam.py``."""
    if preset == "tiny":
        cfg = EngineConfig(
            camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                                cx=79.5, cy=59.5),
            map=MapConfig(voxel_size=0.02, truncation=0.06,
                          truncation_scale=0.01, num_blocks=16384,
                          table_size=65536, max_active_blocks=16384),
            tracker=TrackerConfig(levels=2, max_outer_iter=(6, 4),
                                  max_inner_iter=(1, 1),
                                  dist_thres=(0.15, 0.15),
                                  normal_thres=(0.9, 0.9),
                                  angle_trans_thres=(1.0, 1.0),
                                  dist_trans_thres=(1.0, 1.0),
                                  residual_early_out=(1e-9, 1e-9)),
            filter=FilterConfig(depth_filter=False),
        )
    else:
        cfg = EngineConfig(
            camera=CameraConfig(),
            map=MapConfig(voxel_size=0.004, truncation=0.02,
                          truncation_scale=0.01, num_blocks=1 << 16,
                          table_size=1 << 18, max_active_blocks=1 << 15),
        )
    if streaming:
        cfg = dataclasses.replace(cfg, streaming=StreamingConfig(
            enabled=True, chunk_size=0.64, grid_dim=129, radius=3.0,
            out_parts=8, in_chunks_per_frame=2))
    return cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "default"])
    ap.add_argument("--input", default=None,
                    help="synthetic | tum:DIR | dump:FILE | "
                         "sens:FILE[,FILE...]")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="depth noise sigma (m) of synthetic frames")
    ap.add_argument("--gt", action="store_true",
                    help="use the ground-truth poses outright (no tracking)")
    ap.add_argument("--gt-init", action="store_true",
                    help="seed ICP from the ground-truth pose each frame")
    ap.add_argument("--streaming", action="store_true")
    ap.add_argument("--sync-streaming", action="store_true",
                    help="in-line streaming manager instead of the worker "
                         "thread")
    ap.add_argument("--mesh", default=None, help="write a PLY mesh at end")
    ap.add_argument("--cloud", default=None,
                    help="write the final render as a PLY point cloud")
    ap.add_argument("--save-map", default=None)
    ap.add_argument("--load-map", default=None)
    ap.add_argument("--render-dir", default=None,
                    help="write phong and depth renders of every frame")
    ap.add_argument("--histogram", action="store_true",
                    help="print the hash table's probe histogram at end")
    ap.add_argument("--timings", action="store_true",
                    help="per-frame per-level ICP confidence and the stage "
                         "timing report")
    ap.add_argument("--convergence", default=None,
                    help="save per-level residual-vs-iteration curves to "
                         "this file")
    ap.add_argument("--posegraph", action="store_true",
                    help="keyframe pose graph, loop closure, relocalization "
                         "and end-of-run optimization")
    ap.add_argument("--record", default=None,
                    help="record the replayed sequence to a .sens file")
    ap.add_argument("--reintegrate", action="store_true",
                    help="with --posegraph: rebuild the map from the kept "
                         "frames under the corrected trajectory")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the frame "
                         "loop to DIR/trace.json")
    ap.add_argument("--rgbd", action="store_true",
                    help="joint photometric and geometric tracking")
    ap.add_argument("--log", default=None,
                    help="write standard output to this file")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    return ap.parse_args(argv)


def run_config(args) -> EngineConfig:
    """The engine configuration the flags ask for."""
    cfg = build_config(args.preset, args.streaming)
    if args.rgbd:
        cfg = dataclasses.replace(
            cfg, tracker=dataclasses.replace(cfg.tracker, use_rgbd=True))
    if args.gt:
        cfg = dataclasses.replace(cfg, use_trajectory=True)
    elif args.gt_init:
        cfg = dataclasses.replace(cfg, use_trajectory_only_init=True)
    return cfg


def frame_source(args, cfg: EngineConfig, device):
    """Yields (depth [h,w] NaN-invalid, color [h,w,3] | None, gt_pose 4x4 |
    None) at the working resolution: synthetic frames as tensors on
    ``device``, recorded ones as host arrays (resampled by the nearest
    pixel when their size differs)."""
    cam = cfg.camera
    if args.input is None or args.input.startswith("synthetic"):
        from .io.synthetic import Scene, make_trajectory, render_depth
        scene = Scene()
        for i, p in enumerate(make_trajectory(args.frames)):
            d, c = render_depth(p, cam, scene, noise_sigma=args.noise,
                                seed=i, device=device)
            yield d, c, p
        return

    kind, _, path = args.input.partition(":")
    if kind == "tum":
        from .io.tum import load_tum
        seq = load_tum(path, max_frames=args.frames or None)
        for i in range(len(seq)):
            d, c, p = seq.read_frame(i)
            d, c = _resample(d, c, seq.camera, cam)
            yield d, c, p
    elif kind == "dump":
        from .io.binarydump import BinaryDumpReader
        r = BinaryDumpReader(path)
        n = min(len(r), args.frames) if args.frames else len(r)
        try:
            for i in range(n):
                d, c, p = r.read_frame(i)
                d, c = _resample(d, c, r.camera, cam)
                yield d, c, p
        finally:
            r.close()
    elif kind == "sens":
        # comma-separated files chain into one sequence; a read-ahead
        # thread decodes while the device steps
        from .io.sensfile import PrefetchReader, SensChainReader, SensReader
        paths = path.split(",")
        r = PrefetchReader(SensChainReader(paths) if len(paths) > 1
                           else SensReader(paths[0]))
        try:
            hd = r.header
            src_cam, need_cal = _sens_source_cam(hd, cam)
            n = min(len(r), args.frames) if args.frames else len(r)
            for i, (d, c, p) in enumerate(r.frames()):
                if i >= n:
                    break
                if need_cal:
                    # run in the color camera: remap depth into its grid
                    from .ops.image import remap_depth_to_color
                    d = remap_depth_to_color(
                        d, hd.calibration_depth.intrinsic,
                        hd.calibration_color.intrinsic,
                        hd.color_width, hd.color_height,
                        hd.calibration_depth.extrinsic,
                        hd.calibration_color.extrinsic)
                d, c = _resample(d, c, src_cam, cam)
                yield d, c, p
        finally:
            r.close()     # stops the decode thread, early exit included
    else:
        raise SystemExit(f"unknown input kind {kind!r} (use synthetic / "
                         f"tum:DIR / dump:FILE / sens:FILE[,FILE...])")


def _sens_source_cam(hd, base_cam: CameraConfig):
    """Source camera of a .sens file: the depth camera, or, when the color
    and depth calibrations differ, the color camera, into whose grid the
    depth is remapped. Returns (camera, remap needed)."""
    di = hd.calibration_depth.intrinsic
    ci = hd.calibration_color.intrinsic
    de = hd.calibration_depth.extrinsic
    ce = hd.calibration_color.extrinsic
    same_size = (hd.color_width, hd.color_height) == (hd.depth_width,
                                                      hd.depth_height)
    need_cal = not (same_size and np.allclose(di, ci, atol=1e-4)
                    and np.allclose(de, ce, atol=1e-6))
    if need_cal:
        intr, w, h = ci, hd.color_width, hd.color_height
    else:
        intr, w, h = di, hd.depth_width, hd.depth_height
    cam = dataclasses.replace(
        base_cam, width=int(w), height=int(h),
        fx=float(intr[0, 0]), fy=float(intr[1, 1]),
        cx=float(intr[0, 2]), cy=float(intr[1, 2]))
    return cam, need_cal


def _resample(depth, color, src_cam: CameraConfig, dst_cam: CameraConfig):
    """Nearest-pixel resample of host frames to the working resolution."""
    if (src_cam.width, src_cam.height) == (dst_cam.width, dst_cam.height):
        return depth, color
    ys = np.arange(dst_cam.height) * src_cam.height // dst_cam.height
    xs = np.arange(dst_cam.width) * src_cam.width // dst_cam.width
    d = depth[np.ix_(ys, xs)]
    c = color[np.ix_(ys, xs)] if color is not None else None
    return d, c


class HostFrame(NamedTuple):
    """One frame's ``FrameDiagnostics`` and pose, read in one transfer."""

    diag: tuple            # the FrameDiagnostics fields, float64 arrays
    pose: np.ndarray       # f32[4,4]


def _to_host(diag, pose) -> HostFrame:
    """Every diagnostic and the pose in one device-to-host copy, through
    float64 (which holds every int32, bool and f32 value exactly)."""
    parts = list(diag) + [pose]
    flat = torch.cat([t.reshape(-1).to(torch.float64)
                      for t in parts]).cpu().numpy()
    out, at = [], 0
    for t in parts:
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return HostFrame(diag=type(diag)(*out[:-1]),
                     pose=out[-1].astype(np.float32))


class SlamRun:
    """The state of one run and its per-frame loop body (what
    ``scripts/run_slam.py``'s main loop does for each frame), so that a
    caller can drive the loop frame by frame."""

    def __init__(self, args, cfg: EngineConfig, device):
        from . import diagnostics, engine, posegraph, render, streaming
        self.args, self.cfg, self.device = args, cfg, device
        self.use_hint = args.gt or args.gt_init
        self.timing = diagnostics.TimingLog()
        self.icp_log = diagnostics.ICPErrorLog()
        self.conv = (diagnostics.ConvergenceAnalysis() if args.convergence
                     else None)
        self.mgr = None
        if args.streaming:
            cls = (streaming.StreamingManager if args.sync_streaming
                   else streaming.AsyncStreamingManager)
            self.mgr = cls(cfg.map, cfg.streaming, device=device)
        self.pg = (posegraph.PoseGraph(cfg.camera, device=device)
                   if args.posegraph else None)
        self.rec_frames = [] if (args.record or args.reintegrate) else None
        self.rtf = (render.RenderToFile(args.render_dir) if args.render_dir
                    else None)
        self.state = None
        # the step of every live frame (CUDA graphs on the card; it owns
        # the state's tensors, which it updates in place)
        self.step = engine.make_step(
            cfg, with_hint=self.use_hint, with_stream_mask=args.streaming)
        self.est, self.gts = [], []
        self.lost_streak = 0

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def frame(self, i: int, depth, color, gt_pose) -> HostFrame:
        """Track and fuse frame ``i`` (host arrays or tensors), then the
        pose graph's relocalization and keyframe steps; prints the frame's
        line. Returns its diagnostics on the host."""
        from . import engine, streaming
        from .ops.image import preprocess
        cfg, cam, dev = self.cfg, self.cfg.camera, self.device
        if self.state is None:
            init = gt_pose if gt_pose is not None else np.eye(4)
            self.state = engine.create(cfg, initial_pose=init, device=dev)
            if self.args.load_map:
                # with streaming the checkpoint goes to the host store and
                # the sphere streams it in
                m, _ = streaming.load_map(self.args.load_map, cfg.map,
                                          manager=self.mgr, device=dev)
                self.state = self.state._replace(map=m)
        d = self._tensor(depth)
        c = (self._tensor(color) if color is not None else torch.zeros(
            (cam.height, cam.width, 3), dtype=torch.float32, device=dev))
        d0 = torch.nan_to_num(d, nan=0.0)
        self.timing.frame_start()
        self.timing.start("step")
        hint = None
        if self.use_hint:
            hint = gt_pose if gt_pose is not None else self.state.pose
        extra = (() if hint is None else (hint,)) + (
            () if self.mgr is None else (self.mgr.bitmask,))
        self.state, diag = self.step(self.state, d0, c, *extra)
        self.timing.stop("step", sync=self.state.pose)
        host = _to_host(diag, self.state.pose)
        dh = host.diag
        if self.mgr is not None:
            self.timing.start("streaming")
            self.state = self.state._replace(
                map=self.mgr.step(self.state.map, host.pose[:3, 3]))
            self.timing.stop("streaming")
        self.timing.frame_stop()
        self.est.append(host.pose)
        if gt_pose is not None:
            self.gts.append(np.asarray(gt_pose))
        if self.rec_frames is not None:
            self.rec_frames.append((d, c if color is not None else None))
        valid = bool(dh.tracking_valid)
        pg = self.pg
        if pg is not None and not valid:
            self.lost_streak += 1
            if self.lost_streak >= 2:
                # relocalize against the stored keyframes
                fr = preprocess(d0, None, cam, cfg.filter)
                rp, ok = pg.relocalize(fr.points, fr.normals,
                                       last_pose=host.pose)
                if ok:
                    self.state = self.state._replace(
                        pose=self._tensor(np.asarray(rp, np.float32)),
                        tracking_lost=torch.zeros((), dtype=torch.bool,
                                                  device=dev))
                    self.est[-1] = np.asarray(rp)
                    self.lost_streak = 0
                    print(f"  relocalized at frame {i}")
        else:
            self.lost_streak = 0
        if pg is not None and valid and pg.should_add_keyframe(i,
                                                               self.est[-1]):
            fr = preprocess(d0, None, cam, cfg.filter)
            n_loops = pg.add_keyframe(i, self.est[-1], fr.points, fr.normals)
            if n_loops:
                print(f"  loop closure: {n_loops} new edge(s), "
                      f"{len(pg.keyframes)} keyframes")
        if self.rtf is not None:
            self.rtf(engine.render_view(self.state, cfg), cam=cam)
        self.icp_log.record_frame_levels(dh.icp_level_stats)
        if self.conv is not None:
            self.conv.record_frame(dh.icp_iter_residuals)
        mgr = self.mgr
        print(f"frame {i:4d}: blocks={int(dh.n_allocated_blocks):6d} "
              f"active={int(dh.n_active_blocks):6d} "
              f"res={float(dh.icp_residual):.2e} "
              f"corr={int(dh.icp_corr_count):6d} "
              f"valid={valid}"
              + (f" missed={int(dh.alloc_missed)}" if cfg.offline else "")
              + (f" hostblocks={mgr.host_block_count()}" if mgr else ""))
        if not valid and i > 0:
            print(f"  tracking LOST: cond={float(dh.icp_condition):.2e} "
                  f"planarity_I2={float(dh.icp_planarity):.2e} "
                  f"corr={int(dh.icp_corr_count)}")
        n_free_pool = cfg.map.num_blocks - int(dh.n_allocated_blocks)
        if n_free_pool < min(5000, cfg.map.num_blocks // 8):
            # the reference warns below 5,000 free blocks
            print(f"  WARNING: block pool low: {n_free_pool} free of "
                  f"{cfg.map.num_blocks}"
                  + (" (streaming will keep evicting)" if mgr else
                     " -- consider --streaming or a larger pool"))
        if self.args.timings:
            print(self.icp_log.report_last())
        return host

    def optimize(self) -> bool:
        """Optimize the pose graph and move every frame's pose by its
        keyframe's correction (needs two keyframes). Returns whether it
        ran."""
        pg = self.pg
        if pg is None or len(pg.keyframes) < 2:
            return False
        pg.snapshot_originals()
        pg.optimize()
        self.est = pg.corrected_trajectory(self.est)
        n_loops = sum(1 for e in pg.edges if e.is_loop)
        print(f"pose graph: {len(pg.keyframes)} keyframes, "
              f"{len(pg.edges)} edges ({n_loops} loops), optimized")
        return True

    def reintegrate(self) -> None:
        """Rebuild the map from the kept frames under the corrected
        trajectory: a fresh engine and one trajectory-replay frame of
        ``engine.make_step(with_hint=True)`` per frame (kernels A and B on
        each). Ends the live step: the re-integrated map replaces its
        state."""
        from . import engine, posegraph
        ri_cfg = dataclasses.replace(self.cfg, use_trajectory=True)
        self.step.close()
        self.state = None               # frees the live map first
        ri_step = engine.make_step(ri_cfg, with_hint=True)

        def make_state():
            return engine.create(ri_cfg, initial_pose=self.est[0],
                                 device=self.device)

        def integrate_fn(s, d, c, p):
            if c is None:
                c = torch.zeros(d.shape + (3,), dtype=torch.float32,
                                device=d.device)
            s2, _ = ri_step(s, d, c, np.asarray(p, np.float32))
            return s2

        self.state = posegraph.reintegrate(self.rec_frames, self.est,
                                           ri_cfg, make_state, integrate_fn)
        ri_step.close()
        print(f"re-integrated {len(self.rec_frames)} frames under the "
              f"corrected trajectory")

    def record(self, path: str) -> None:
        """Write the kept frames and the final trajectory as a .sens file."""
        from .io.sensfile import write_sens
        cam = self.cfg.camera
        intr = np.eye(4, dtype=np.float32)
        intr[0, 0], intr[1, 1] = cam.fx, cam.fy
        intr[0, 2], intr[1, 2] = cam.cx, cam.cy
        depths = np.stack([d.cpu().numpy() for d, _ in self.rec_frames])
        colors = None
        if self.rec_frames[0][1] is not None:
            colors = np.stack([c.cpu().numpy() for _, c in self.rec_frames])
        write_sens(path, depths, colors, self.est, intr)
        print(f"recorded {len(self.rec_frames)} frames -> {path}")

    def close(self) -> None:
        self.step.close()
        if self.mgr is not None and hasattr(self.mgr, "close"):
            self.mgr.close()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.log:
        with open(args.log, "w") as f, contextlib.redirect_stdout(f):
            return _main(args)
    return _main(args)


def _main(args) -> int:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("run_slam: no CUDA device (pass --device cpu to run on the "
              "CPU)", file=sys.stderr)
        return 2
    from . import blockmap, diagnostics, engine, evaluation, meshing, render
    from . import streaming

    cfg = run_config(args)
    run = SlamRun(args, cfg, device)
    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    try:
        t0 = time.time()
        for i, (d, c, gt) in enumerate(frame_source(args, cfg, device)):
            run.frame(i, d, c, gt)
        dt = time.time() - t0
        if prof is not None:
            prof.stop()
            os.makedirs(args.trace, exist_ok=True)
            path = os.path.join(args.trace, "trace.json")
            prof.export_chrome_trace(path)
            print(f"profiler trace -> {path}")
        state, mgr = run.state, run.mgr
        if mgr is not None and hasattr(mgr, "flush"):
            mgr.flush()
        if run.optimize() and args.reintegrate \
                and run.rec_frames is not None:
            run.reintegrate()
            state = run.state
        if args.record:
            run.record(args.record)
        if args.histogram:
            print("hash histogram:", diagnostics.hash_histogram(state.map,
                                                                cfg.map))
        if args.timings:
            print(run.timing.report())
        if run.conv is not None:
            run.conv.save(args.convergence)
            print(f"convergence curves -> {args.convergence}")
        if args.save_map:
            n = streaming.save_map(args.save_map, state.map, cfg.map,
                                   poses=np.stack(run.est), manager=mgr)
            print(f"saved {n} blocks -> {args.save_map}"
                  + (" (incl. host-tiered)" if mgr else ""))
        if args.mesh:
            if mgr is not None:
                tris, cols = meshing.extract_mesh_streamed(state.map,
                                                           cfg.map, cfg.mesh,
                                                           mgr)
            else:
                tris, cols = meshing.extract_mesh(state.map, cfg.map,
                                                  cfg.mesh)
            nf = meshing.save_ply(args.mesh, tris, cols)
            print(f"mesh: {len(tris)} tris -> {nf} welded faces -> "
                  f"{args.mesh}")
        if args.cloud:
            model = engine.render_view(state, cfg)
            n = render.save_point_cloud(args.cloud, model.points,
                                        colors=model.color,
                                        normals=model.normals)
            print(f"point cloud: {n} points -> {args.cloud}")
    finally:
        run.close()

    n_frames = len(run.est)
    print(f"\n{n_frames} frames in {dt:.1f}s on {device} "
          f"({n_frames / max(dt, 1e-9):.2f} frames/s incl. host loop)")
    ok = True
    if run.gts and not args.gt:
        ate = evaluation.ate_rmse(run.est, run.gts, align=False)
        print(f"ATE RMSE: {ate * 1000:.2f} mm")
        ok &= ate < ATE_LIMIT_M
    viol = blockmap.check_invariants(state.map, cfg.map)
    print(f"invariants: {viol}")
    ok &= all(v == 0 for v in viol.values())
    print("RESULT:", "OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
