"""SLAM layer: keyframes, loop closure, relocalization, pose-graph
optimization and re-integration (port of ``voxelhashing_tpu.posegraph``).

Keyframes keep their camera-space position and normal maps as the tensors
they were given (on the run's device); loop candidates are gated by pose
and verified by ICP (``tracking.track`` with a two-level tracker config).
``optimize`` is Gauss-Newton over all keyframe poses, pose 0 fixed, 1e-6
damping, ``gn_iters`` steps in f32 on ``device``: the residuals of all
edges are one batched expression (one [E,4,4] ``torch.linalg.solve`` per
side), and their Jacobian comes from ``torch.func.jacfwd``.
``optimize_distributed`` splits the edges over the ranks of a process
group and sums the normal equations in one all-reduce per step.

Host reads: a registration reads its pose, ``valid`` flag and residual in
one transfer; registrations run only at keyframes and relocalizations.
``optimize`` reads the poses once at the end.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import CameraConfig, TrackerConfig, resolve_device
from . import geometry as geom, tracking
from .parallel import collectives


# ---------------------------------------------------------------------------
# SE(3) helpers
# ---------------------------------------------------------------------------


def se3_exp(xi):
    """se(3) 6-vectors (rx,ry,rz,tx,ty,tz) [...,6] -> 4x4 transforms
    [...,4,4] (Rodrigues rotation, translation as given).

    sin(t)/t and (1-cos t)/t^2 switch to their Taylor expansions below
    t^2 = 1e-10, and the exact branch is evaluated at t^2 = 1 there, so both
    branches of each ``where`` stay finite and the Jacobian at xi = 0 (where
    Gauss-Newton linearizes) is finite: ``torch.where`` passes a NaN of the
    branch it does not take into the gradient, as ``jnp.where`` does."""
    w = xi[..., :3]
    t2 = torch.sum(w * w, dim=-1)
    small = t2 < 1e-10
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - geom.div_const(t2, 6.0), torch.sin(th) / th)
    b = torch.where(small, 0.5 - geom.div_const(t2, 24.0),
                    (1.0 - torch.cos(th)) / t2s)
    z = torch.zeros_like(t2)
    wx = torch.stack([z, -w[..., 2], w[..., 1],
                      w[..., 2], z, -w[..., 0],
                      -w[..., 1], w[..., 0], z], dim=-1)
    wx = wx.reshape(wx.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    r = eye + a[..., None, None] * wx + b[..., None, None] * (wx @ wx)
    top = torch.cat([r, xi[..., 3:, None]], dim=-1)               # [...,3,4]
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=xi.dtype,
                         device=xi.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_log_residual(t):
    """Residual 6-vector [...,6] of near-identity transforms [...,4,4]
    (small-angle log)."""
    r = t[..., :3, :3]
    w = 0.5 * torch.stack([r[..., 2, 1] - r[..., 1, 2],
                           r[..., 0, 2] - r[..., 2, 0],
                           r[..., 1, 0] - r[..., 0, 1]], dim=-1)
    return torch.cat([w, t[..., :3, 3]], dim=-1)


def _angle(d: np.ndarray) -> float:
    return float(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))


# ---------------------------------------------------------------------------
# Keyframes and constraints
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Keyframe:
    index: int                 # frame index in the sequence
    pose: np.ndarray           # camera-to-world at creation [4,4] float64
    points: torch.Tensor       # camera-space position map [h,w,3]
    normals: torch.Tensor      # camera-space normal map [h,w,3]


@dataclasses.dataclass
class Edge:
    i: int                     # keyframe ids (graph indices)
    j: int
    z_ij: np.ndarray           # measured relative pose: T_i^-1 T_j
    weight: float = 1.0
    is_loop: bool = False


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    keyframe_every: int = 10          # min frames between keyframes
    keyframe_angle: float = 0.15      # or when motion exceeds these
    keyframe_dist: float = 0.15
    loop_max_dist: float = 0.6        # candidate gating
    loop_max_angle: float = 0.8
    loop_min_separation: int = 3      # keyframes apart
    loop_residual_max: float = 2e-4   # ICP residual acceptance
    gn_iters: int = 10
    loop_weight: float = 1.0
    odom_weight: float = 1.0


class PoseGraph:
    """Keyframe pose graph: host orchestration, ICP and the solve on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cam: CameraConfig, cfg: PoseGraphConfig = None,
                 tracker: Optional[TrackerConfig] = None, device="cuda"):
        self.cam = cam
        self.cfg = cfg or PoseGraphConfig()
        self.device = resolve_device(device)
        self.tracker = tracker or TrackerConfig(
            levels=2, max_outer_iter=(8, 6), max_inner_iter=(1, 1),
            dist_thres=(0.3, 0.3), normal_thres=(0.8, 0.8),
            angle_trans_thres=(1.5, 1.5), dist_trans_thres=(1.5, 1.5),
            residual_early_out=(1e-9, 1e-9))
        self.keyframes: List[Keyframe] = []
        self.edges: List[Edge] = []
        self._last_kf_pose: Optional[np.ndarray] = None
        self._last_kf_index = -10**9
        self._orig_poses: List[np.ndarray] = []

    # -- keyframe policy --------------------------------------------------

    def should_add_keyframe(self, frame_index: int, pose: np.ndarray) -> bool:
        """The first frame; then every ``keyframe_every`` frames, or sooner
        when the motion since the last keyframe exceeds the distance or
        angle threshold."""
        if not self.keyframes:
            return True
        if frame_index - self._last_kf_index < self.cfg.keyframe_every:
            d = np.linalg.inv(self._last_kf_pose) @ pose
            return (np.linalg.norm(d[:3, 3]) > self.cfg.keyframe_dist
                    or _angle(d) > self.cfg.keyframe_angle)
        return True

    def add_keyframe(self, frame_index: int, pose: np.ndarray,
                     points, normals) -> int:
        """Add a keyframe (and its odometry edge) and search for loop
        closures. Returns the number of loop edges added."""
        pose = np.asarray(pose, np.float64)
        kf = Keyframe(index=frame_index, pose=pose.copy(), points=points,
                      normals=normals)
        k = len(self.keyframes)
        self.keyframes.append(kf)
        self._last_kf_pose = pose.copy()
        self._last_kf_index = frame_index
        if k > 0:
            z = np.linalg.inv(self.keyframes[k - 1].pose) @ pose
            self.edges.append(Edge(i=k - 1, j=k, z_ij=z,
                                   weight=self.cfg.odom_weight))
        return self._detect_loops(k)

    # -- loop closure -----------------------------------------------------

    def _detect_loops(self, k: int) -> int:
        """Gate old keyframes by pose proximity, verify by ICP (register
        k's maps against the candidate's)."""
        cfg = self.cfg
        kf = self.keyframes[k]
        added = 0
        for c in range(k - cfg.loop_min_separation):
            cand = self.keyframes[c]
            d = np.linalg.inv(cand.pose) @ kf.pose
            if np.linalg.norm(d[:3, 3]) > cfg.loop_max_dist \
                    or _angle(d) > cfg.loop_max_angle:
                continue
            z, ok = self.register(kf, cand, init=d)
            if ok:
                # z maps k-frame coords into c-frame coords: z = T_c^-1 T_k,
                # the (i=c, j=k) constraint
                self.edges.append(Edge(i=c, j=k, z_ij=z,
                                       weight=cfg.loop_weight, is_loop=True))
                added += 1
        return added

    def register(self, kf_src: Keyframe, kf_dst: Keyframe, init=None
                 ) -> Tuple[np.ndarray, bool]:
        """ICP-register src's maps against dst's (camera frames); returns
        (delta mapping src camera space into dst camera space, ok)."""
        # track() starts from identity, so a warm start pre-transforms the
        # source maps into the predicted dst frame
        pts, nrm = kf_src.points, kf_src.normals
        dev = pts.device
        if init is not None:
            r = torch.as_tensor(np.asarray(init, np.float32), device=dev)
            pts = pts @ r[:3, :3].T + r[:3, 3]
            nrm = nrm @ r[:3, :3].T
        res = tracking.track(
            pts, nrm, kf_dst.points, kf_dst.normals,
            torch.eye(4, dtype=torch.float32, device=dev), self.cam,
            self.tracker)
        host = torch.cat([res.pose.reshape(-1),
                          res.valid.reshape(1).to(torch.float32),
                          res.residual.reshape(1)]).cpu().numpy()
        delta = host[:16].reshape(4, 4).astype(np.float64)
        if init is not None:
            delta = delta @ np.asarray(init)
        ok = bool(host[16]) and float(host[17]) < self.cfg.loop_residual_max
        return delta, ok

    # -- relocalization ---------------------------------------------------

    def relocalize(self, points, normals, last_pose=None,
                   max_candidates: int = 8) -> Tuple[np.ndarray, bool]:
        """Recover the camera pose after tracking loss by ICP-registering
        the current frame's maps against the stored keyframes, nearest to
        the last known pose first: warm-started from that pose, then, when
        that fails, cold from identity. Returns (camera_to_world, ok); the
        first verified registration wins."""
        if not self.keyframes:
            return (np.eye(4) if last_pose is None
                    else np.asarray(last_pose)), False
        cands = list(range(len(self.keyframes)))
        if last_pose is not None:
            lp = np.asarray(last_pose, np.float64)
            cands.sort(key=lambda k: float(np.linalg.norm(
                self.keyframes[k].pose[:3, 3] - lp[:3, 3])))
        cands = cands[:max_candidates]
        frame = Keyframe(index=-1, pose=np.eye(4), points=points,
                         normals=normals)
        for k in cands:
            kf = self.keyframes[k]
            init = None
            if last_pose is not None:
                # predicted frame -> keyframe delta from the stale pose
                init = np.linalg.inv(kf.pose) @ np.asarray(last_pose,
                                                           np.float64)
            z, ok = self.register(frame, kf, init=init)
            if not ok:
                z, ok = self.register(frame, kf, init=None)
            if ok:
                return kf.pose @ z, True          # T_w_kf @ T_kf_frame
        return (np.eye(4) if last_pose is None
                else np.asarray(last_pose)), False

    # -- optimization -----------------------------------------------------

    def optimize(self) -> np.ndarray:
        """Gauss-Newton over all keyframe poses (pose 0 fixed). Updates the
        keyframe poses in place; returns them stacked [K,4,4] float64."""
        if len(self.keyframes) < 2 or not self.edges:
            return self._stacked_poses()
        return self._solve(self.edges, lambda sums: sums)

    def optimize_distributed(self, group=None) -> np.ndarray:
        """Edge-sharded Gauss-Newton over the ranks of ``group``: the edges
        are padded with zero-weight edges to a multiple of the world size
        and split in equal runs; each rank linearizes its run, one SUM
        all-reduce gives every rank H, b and the loss, and every rank
        solves the same system (the graph is pose-pose only, so there is
        no Schur complement). With no process group this process is the
        only rank. Matches :meth:`optimize` (same residuals and steps).
        Every rank calls it with the same graph."""
        if len(self.keyframes) < 2 or not self.edges:
            return self._stacked_poses()
        me, n_dev = collectives.world(group)
        per = -(-len(self.edges) // n_dev)
        pad = self.edges + [Edge(i=0, j=0, z_ij=np.eye(4), weight=0.0)] \
            * (per * n_dev - len(self.edges))
        mine = pad[me * per:(me + 1) * per]
        if group is None and not torch.distributed.is_initialized():
            return self._solve(mine, lambda sums: sums)
        return self._solve(mine, lambda sums: collectives.sum_tuple(sums,
                                                                    group))

    def _stacked_poses(self) -> np.ndarray:
        return np.stack([kf.pose for kf in self.keyframes]) \
            if self.keyframes else np.zeros((0, 4, 4))

    def _solve(self, edges, reduce_sys) -> np.ndarray:
        """``gn_iters`` Gauss-Newton steps whose normal equations (H, b,
        loss) are built over ``edges`` and then passed through
        ``reduce_sys``; the keyframe poses are updated in place."""
        k = len(self.keyframes)
        dev, f32 = self.device, torch.float32
        poses = torch.as_tensor(np.stack([kf.pose for kf in self.keyframes]),
                                dtype=f32, device=dev)
        ei = torch.tensor([e.i for e in edges], device=dev)
        ej = torch.tensor([e.j for e in edges], device=dev)
        zs = torch.as_tensor(np.stack([e.z_ij for e in edges]),
                             dtype=f32, device=dev)
        sw = torch.sqrt(torch.tensor([e.weight for e in edges],
                                     dtype=f32, device=dev))

        def gauge_fixed(xi):
            # pose 0 held: a new tensor, not an in-place write (torch.func)
            return torch.cat([torch.zeros_like(xi[:1]), xi[1:]])

        def residuals(xi_flat, poses):
            t = poses @ se3_exp(gauge_fixed(xi_flat.reshape(k, 6)))
            err = torch.linalg.solve(zs, torch.linalg.solve(t[ei], t[ej]))
            return (sw[:, None] * se3_log_residual(err)).reshape(-1)

        jac = torch.func.jacfwd(residuals)
        xi0 = torch.zeros((k * 6,), dtype=f32, device=dev)
        damp = 1e-6 * torch.eye(k * 6, dtype=f32, device=dev)
        for _ in range(self.cfg.gn_iters):
            r = residuals(xi0, poses)
            j = jac(xi0, poses)                            # [E*6, K*6]
            h, b, _ = reduce_sys((j.T @ j, -j.T @ r, torch.sum(r * r)))
            dx = torch.linalg.solve(h + damp, b)
            poses = poses @ se3_exp(gauge_fixed(dx.reshape(k, 6)))
        out = poses.cpu().numpy().astype(np.float64)
        for m, kf in enumerate(self.keyframes):
            kf.pose = out[m]
        return out

    def snapshot_originals(self):
        """Record the poses before ``optimize`` so that
        ``corrected_trajectory`` can compute each keyframe's correction."""
        self._orig_poses = [kf.pose.copy() for kf in self.keyframes]

    def corrected_trajectory(self, frame_poses: List[np.ndarray]
                             ) -> List[np.ndarray]:
        """Propagate the optimized keyframe corrections to all frames: each
        frame takes the correction (optimized x original^-1) of its most
        recent keyframe."""
        if not self.keyframes:
            return list(frame_poses)
        out = []
        kf_iter = 0
        corr = np.eye(4)
        for fi, p in enumerate(frame_poses):
            while (kf_iter < len(self.keyframes)
                   and self.keyframes[kf_iter].index <= fi):
                corr = self.keyframes[kf_iter].pose @ np.linalg.inv(
                    self._orig_poses[kf_iter])
                kf_iter += 1
            out.append(corr @ np.asarray(p, np.float64))
        return out


def reintegrate(frames, poses, cfg, make_state, integrate_fn):
    """Rebuild a map from stored frames under corrected poses.
    ``frames``: iterable of (depth, color); ``make_state()``: a fresh map;
    ``integrate_fn(state, depth, color, pose)`` returns the next state."""
    state = make_state()
    for (depth, color), pose in zip(frames, poses):
        state = integrate_fn(state, depth, color, pose)
    return state
