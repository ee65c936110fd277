"""Offline SLAM driver of the PyTorch port: synthetic frames through
``engine.step``, with optional RGB-D tracking, streaming, per-frame
renders, whole-scene mesh, point cloud and checkpoints.

    python -m voxelhashing_tpu_torch.run_slam --frames 20 --preset tiny
    python -m voxelhashing_tpu_torch.run_slam --frames 30 --streaming \\
        --mesh out.ply --save-map map.npz
    python -m voxelhashing_tpu_torch.run_slam --rgbd --render-dir renders \\
        --cloud cloud.ply

The counterpart of ``scripts/run_slam.py`` for the flags whose modules are
ported. Frames are rendered on the device from the synthetic scene and
trajectory. ``--device`` defaults to ``cuda`` and fails without a card;
the CPU runs only when asked (``--device cpu``). Ends with the ATE against
the synthetic ground truth (limit 50 mm, not checked with ``--gt``), the
map invariants, and ``RESULT: OK`` or ``RESULT: FAIL`` (exit code 1).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

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
    ap.add_argument("--noise", type=float, default=0.0,
                    help="depth noise sigma (m)")
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
    ap.add_argument("--rgbd", action="store_true",
                    help="joint photometric and geometric tracking")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("run_slam: no CUDA device (pass --device cpu to run on the "
              "CPU)", file=sys.stderr)
        return 2
    from . import blockmap, engine, evaluation, meshing, render, streaming
    from .io.synthetic import Scene, make_trajectory, render_depth

    cfg = build_config(args.preset, args.streaming)
    if args.rgbd:
        cfg = dataclasses.replace(
            cfg, tracker=dataclasses.replace(cfg.tracker, use_rgbd=True))
    if args.gt:
        cfg = dataclasses.replace(cfg, use_trajectory=True)
    elif args.gt_init:
        cfg = dataclasses.replace(cfg, use_trajectory_only_init=True)
    use_hint = args.gt or args.gt_init
    mgr = None
    if args.streaming:
        cls = (streaming.StreamingManager if args.sync_streaming
               else streaming.AsyncStreamingManager)
        mgr = cls(cfg.map, cfg.streaming, device=device)
    rtf = render.RenderToFile(args.render_dir) if args.render_dir else None

    scene = Scene()
    gts = make_trajectory(args.frames)
    state = engine.create(cfg, initial_pose=gts[0], device=device)
    if args.load_map:
        # with streaming the checkpoint goes to the host store and the
        # sphere streams it in
        m, _ = streaming.load_map(args.load_map, cfg.map, manager=mgr,
                                  device=device)
        state = state._replace(map=m)
    est = []
    t0 = time.time()
    for i, gt in enumerate(gts):
        d, c = render_depth(gt, cfg.camera, scene, noise_sigma=args.noise,
                            seed=i, device=device)
        state, diag = engine.step(
            state, torch.nan_to_num(d, nan=0.0), c, cfg,
            pose_hint=gt if use_hint else None,
            stream_bitmask=None if mgr is None else mgr.bitmask)
        pose = state.pose.cpu().numpy()
        if mgr is not None:
            state = state._replace(map=mgr.step(state.map, pose[:3, 3]))
        est.append(pose)
        if rtf is not None:
            rtf(engine.render_view(state, cfg), cam=cfg.camera)
        print(f"frame {i:4d}: blocks={int(diag.n_allocated_blocks):6d} "
              f"active={int(diag.n_active_blocks):6d} "
              f"res={float(diag.icp_residual):.2e} "
              f"corr={int(diag.icp_corr_count):6d} "
              f"valid={bool(diag.tracking_valid)}"
              + (f" missed={int(diag.alloc_missed)}" if cfg.offline else "")
              + (f" hostblocks={mgr.host_block_count()}" if mgr else ""))
        if not bool(diag.tracking_valid) and i > 0:
            print(f"  tracking LOST: cond={float(diag.icp_condition):.2e} "
                  f"planarity_I2={float(diag.icp_planarity):.2e} "
                  f"corr={int(diag.icp_corr_count)}")
        n_free_pool = cfg.map.num_blocks - int(diag.n_allocated_blocks)
        if n_free_pool < min(5000, cfg.map.num_blocks // 8):
            # the reference warns below 5,000 free blocks
            print(f"  WARNING: block pool low: {n_free_pool} free of "
                  f"{cfg.map.num_blocks}"
                  + (" (streaming will keep evicting)" if mgr else
                     " -- consider --streaming or a larger pool"))
    dt = time.time() - t0
    if mgr is not None and hasattr(mgr, "flush"):
        mgr.flush()

    if args.save_map:
        n = streaming.save_map(args.save_map, state.map, cfg.map,
                               poses=np.stack(est), manager=mgr)
        print(f"saved {n} blocks -> {args.save_map}"
              + (" (incl. host-tiered)" if mgr else ""))
    if args.mesh:
        if mgr is not None:
            tris, cols = meshing.extract_mesh_streamed(state.map, cfg.map,
                                                       cfg.mesh, mgr)
        else:
            tris, cols = meshing.extract_mesh(state.map, cfg.map, cfg.mesh)
        nf = meshing.save_ply(args.mesh, tris, cols)
        print(f"mesh: {len(tris)} tris -> {nf} welded faces -> {args.mesh}")
    if args.cloud:
        model = engine.render_view(state, cfg)
        n = render.save_point_cloud(args.cloud, model.points,
                                    colors=model.color,
                                    normals=model.normals)
        print(f"point cloud: {n} points -> {args.cloud}")
    if mgr is not None and hasattr(mgr, "close"):
        mgr.close()

    print(f"\n{len(est)} frames in {dt:.1f}s on {device} "
          f"({len(est) / max(dt, 1e-9):.2f} frames/s incl. host loop)")
    ok = True
    if not args.gt:
        ate = evaluation.ate_rmse(est, gts)
        print(f"ATE RMSE: {ate * 1000:.2f} mm")
        ok &= ate < ATE_LIMIT_M
    viol = blockmap.check_invariants(state.map, cfg.map)
    print(f"invariants: {viol}")
    ok &= all(v == 0 for v in viol.values())
    print("RESULT:", "OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
