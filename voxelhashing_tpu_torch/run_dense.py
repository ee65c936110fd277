"""Offline entry point of the dense voxel-grid baseline (the PyTorch port's
counterpart of ``scripts/run_dense.py``).

    python -m voxelhashing_tpu_torch.run_dense --frames 10 \\
        [--mesh dense.ply] [--gt] [--input sens:FILE|tum:DIR] [--dims 96] \\
        [--voxel 0.02] [--origin X Y Z] [--device cuda|cpu]

Replays a frame source (``run_slam.frame_source``) through the dense step
(``denseengine.make_step``: preprocess -> dense render -> ICP -> dense
integrate), reports the ATE and optionally writes the extracted mesh. The
same flags as the JAX script, with ``--device`` (default ``cuda``, failing
without a card) in place of ``--cpu``. Ends with ``RESULT: OK`` when the
ATE is below 50 mm (not checked with ``--gt``) and a mesh, when asked for,
has triangles; otherwise ``RESULT: FAIL`` (exit code 1).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from .run_slam import ATE_LIMIT_M, build_config, frame_source


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "default"])
    ap.add_argument("--input", default=None)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--gt", action="store_true",
                    help="fuse along the ground-truth trajectory")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--dims", type=int, default=96,
                    help="grid voxels per axis")
    ap.add_argument("--voxel", type=float, default=0.02)
    ap.add_argument("--origin", type=float, nargs=3, default=None,
                    help="grid origin (default: centred)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("run_dense: no CUDA device (pass --device cpu to run on the "
              "CPU)", file=sys.stderr)
        return 2
    from . import denseengine, densegrid, evaluation, meshing

    cfg = dataclasses.replace(build_config(args.preset, streaming=False),
                              offline=False, use_trajectory=args.gt)
    n = args.dims
    half = 0.5 * n * args.voxel
    origin = tuple(args.origin) if args.origin else (-half, -half, 0.5)
    grid_cfg = densegrid.DenseGridConfig(
        dims=(n, n, n), origin=origin, voxel_size=args.voxel,
        truncation=max(5.0 * args.voxel, 0.06))

    step = denseengine.make_step(cfg, grid_cfg, with_hint=args.gt,
                                 donate=False)
    state = denseengine.create(grid_cfg, device=device)
    est, gts = [], []
    t0 = time.time()
    for i, (d, c, gt_pose) in enumerate(frame_source(args, cfg, device)):
        d = torch.nan_to_num(torch.as_tensor(d, device=device), nan=0.0)
        c = (torch.as_tensor(c, device=device) if c is not None else
             torch.zeros((cfg.camera.height, cfg.camera.width, 3),
                         dtype=torch.float32, device=device))
        if args.gt:
            hint = state.pose if gt_pose is None else torch.as_tensor(
                np.asarray(gt_pose, np.float32), device=device)
            state, tr = step(state, d, c, hint)
        else:
            state, tr = step(state, d, c)
        est.append(state.pose.cpu().numpy())
        if gt_pose is not None:
            gts.append(np.asarray(gt_pose))
        occupied = int((state.grid.weight > 0).sum())
        print(f"frame {i:4d}: occupied={occupied:8d} "
              f"res={float(tr.residual):.2e} valid={bool(tr.valid)}")
    dt = time.time() - t0
    print(f"\n{len(est)} frames in {dt:.1f}s on {device} "
          f"({len(est) / max(dt, 1e-9):.2f} fps incl. host loop)")

    ok = True
    if gts and not args.gt:
        ate = evaluation.ate_rmse(est, gts)
        print(f"ATE RMSE: {ate * 1e3:.2f} mm")
        ok &= ate < ATE_LIMIT_M
    if args.mesh:
        chunk = densegrid.extract_mesh(state.grid, grid_cfg)
        nt = chunk.n_triangles
        meshing.save_ply(args.mesh, chunk.vertices.cpu().numpy(),
                         chunk.colors.cpu().numpy())
        print(f"mesh: {nt} triangles -> {args.mesh}")
        ok &= nt > 0
    print("RESULT:", "OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
