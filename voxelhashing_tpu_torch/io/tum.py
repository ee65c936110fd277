"""TUM RGB-D benchmark sequence loader (port of
``voxelhashing_tpu.io.tum``; numpy, PIL imported only to read the PNGs).

TUM format: ``depth.txt`` / ``rgb.txt`` listing ``timestamp path`` pairs,
16-bit PNG depth at 1/5000 m, ``groundtruth.txt`` with
``t tx ty tz qx qy qz qw``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from ..config import CameraConfig

# Default TUM Freiburg-1 intrinsics (525 fx at 640x480).
TUM_FR1_CAMERA = CameraConfig(width=640, height=480, fx=517.3, fy=516.5,
                              cx=318.6, cy=255.3)
TUM_DEFAULT_CAMERA = CameraConfig(width=640, height=480, fx=525.0, fy=525.0,
                                  cx=319.5, cy=239.5)
DEPTH_SCALE = 5000.0


def _read_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def quat_to_matrix(qx, qy, qz, qw) -> np.ndarray:
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)]], np.float32)


def read_trajectory(path: str) -> List[Tuple[float, np.ndarray]]:
    """groundtruth.txt -> [(timestamp, camera_to_world 4x4)]."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = quat_to_matrix(v[4], v[5], v[6], v[7])
            pose[:3, 3] = v[1:4]
            out.append((v[0], pose))
    return out


def associate(a: List[Tuple[float, object]], b: List[Tuple[float, object]],
              max_dt: float = 0.02) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (the TUM associate.py rule)."""
    pairs = []
    j = 0
    for i, (ta, _) in enumerate(a):
        while j + 1 < len(b) and abs(b[j + 1][0] - ta) <= abs(b[j][0] - ta):
            j += 1
        if abs(b[j][0] - ta) <= max_dt:
            pairs.append((i, j))
    return pairs


@dataclasses.dataclass
class TumSequence:
    root: str
    depth_files: List[str]
    rgb_files: List[Optional[str]]
    poses: List[Optional[np.ndarray]]
    timestamps: List[float]
    camera: CameraConfig

    def __len__(self):
        return len(self.depth_files)

    def read_frame(self, i: int):
        """(depth [h,w] f32 metres NaN-invalid, color [h,w,3] f32 | None,
        pose 4x4 | None)."""
        from PIL import Image
        d = np.asarray(Image.open(os.path.join(self.root,
                                               self.depth_files[i])))
        depth = d.astype(np.float32) / DEPTH_SCALE
        depth = np.where(d == 0, np.nan, depth)
        color = None
        if self.rgb_files[i] is not None:
            c = np.asarray(Image.open(os.path.join(
                self.root, self.rgb_files[i])).convert("RGB"))
            color = c.astype(np.float32) / 255.0
        return depth, color, self.poses[i]


def load_tum(root: str, camera: Optional[CameraConfig] = None,
             max_frames: Optional[int] = None) -> TumSequence:
    """Load a TUM sequence directory (depth.txt required; rgb.txt and
    groundtruth.txt optional)."""
    camera = camera or (
        TUM_FR1_CAMERA if "freiburg1" in root else TUM_DEFAULT_CAMERA)
    depth_list = _read_list(os.path.join(root, "depth.txt"))
    rgb_list = []
    if os.path.exists(os.path.join(root, "rgb.txt")):
        rgb_list = _read_list(os.path.join(root, "rgb.txt"))
    traj = []
    if os.path.exists(os.path.join(root, "groundtruth.txt")):
        traj = read_trajectory(os.path.join(root, "groundtruth.txt"))

    rgb_pairs = dict(associate(depth_list, rgb_list)) if rgb_list else {}
    pose_pairs = dict(associate(depth_list, traj)) if traj else {}

    depth_files, rgb_files, poses, stamps = [], [], [], []
    for i, (t, df) in enumerate(depth_list):
        if max_frames is not None and len(depth_files) >= max_frames:
            break
        depth_files.append(df)
        stamps.append(t)
        rgb_files.append(rgb_list[rgb_pairs[i]][1] if i in rgb_pairs
                         else None)
        poses.append(traj[pose_pairs[i]][1] if i in pose_pairs else None)
    return TumSequence(root=root, depth_files=depth_files,
                       rgb_files=rgb_files, poses=poses,
                       timestamps=stamps, camera=camera)
