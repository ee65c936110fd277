"""Synthetic RGB-D frames rendered on the device (PyTorch port of the
wall + floor + spheres scene and the handheld trajectory of
``voxelhashing_tpu.io.synthetic``).

Exact ray/plane and ray/sphere intersections for every pixel, in the same
operation order as the numpy renderer. Depth noise is drawn on the host
with numpy's generator from the frame's seed, so both packages add the same
noise.

Camera convention: x right, y down, z forward; pose = camera-to-world.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import CameraConfig, resolve_device


@dataclasses.dataclass(frozen=True)
class Sphere:
    center: Tuple[float, float, float]
    radius: float
    color: Tuple[float, float, float] = (0.8, 0.3, 0.2)


@dataclasses.dataclass(frozen=True)
class Scene:
    """A wall plane z = wall_z (world), an optional floor plane y = floor_y
    (y points down) and spheres in front of them."""

    wall_z: float = 2.5
    wall_color: Tuple[float, float, float] = (0.6, 0.6, 0.65)
    floor_y: Optional[float] = 1.0
    floor_color: Tuple[float, float, float] = (0.45, 0.4, 0.35)
    spheres: Tuple[Sphere, ...] = (
        Sphere(center=(0.0, 0.2, 1.8), radius=0.3),
        Sphere(center=(-0.5, -0.2, 2.0), radius=0.25,
               color=(0.2, 0.5, 0.8)),
    )


def render_depth(pose, cam: CameraConfig, scene: Scene,
                 noise_sigma: float = 0.0, seed: int = 0, device="cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth and color of ``scene`` seen from ``pose`` on ``device`` (the
    card unless the caller asks for the CPU).

    Returns (depth f32[h,w] metres, NaN where invalid; color f32[h,w,3] in
    [0,1]).
    """
    device = resolve_device(device)
    h, w = cam.height, cam.width
    f32 = torch.float32
    v, u = torch.meshgrid(torch.arange(h, dtype=f32, device=device),
                          torch.arange(w, dtype=f32, device=device),
                          indexing="ij")
    dirs_cam = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                            torch.ones_like(u)], dim=-1)
    pose = torch.as_tensor(np.asarray(pose, np.float32), device=device)
    origin = pose[:3, 3]
    dirs = dirs_cam @ pose[:3, :3].T     # world-space, z-depth parameterised

    best_t = torch.full((h, w), torch.inf, dtype=f32, device=device)
    color = torch.zeros((h, w, 3), dtype=f32, device=device)

    def consider(t_hit, mask, col):
        nonlocal best_t, color
        better = mask & (t_hit < best_t) & (t_hit > 0.05)
        best_t = torch.where(better, t_hit, best_t)
        color = torch.where(better[..., None],
                            torch.tensor(col, dtype=f32, device=device),
                            color)

    def plane(axis, level, col):
        d = dirs[..., axis]
        t_hit = torch.where(torch.abs(d) > 1e-9, (level - origin[axis]) / d,
                            torch.inf)
        consider(t_hit, torch.isfinite(t_hit), col)

    plane(2, scene.wall_z, scene.wall_color)
    if scene.floor_y is not None:
        plane(1, scene.floor_y, scene.floor_color)
    a = torch.sum(dirs * dirs, dim=-1)
    for s in scene.spheres:
        oc = origin - torch.tensor(s.center, dtype=f32, device=device)
        b = 2.0 * torch.sum(dirs * oc, dim=-1)
        c = torch.dot(oc, oc) - s.radius ** 2
        disc = b * b - 4 * a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        consider((-b - sq) / (2 * a), disc > 0, s.color)

    # best_t parameterises unit-z rays, so it IS the z-depth.
    depth = torch.where(torch.isfinite(best_t), best_t, torch.nan)
    depth = torch.where((depth >= cam.depth_min) & (depth <= cam.depth_max),
                        depth, torch.nan)
    if noise_sigma > 0.0:
        noise = np.random.default_rng(seed).normal(
            0.0, noise_sigma, (h, w)).astype(np.float32)
        depth = depth + torch.from_numpy(noise).to(device)
    return depth, color


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _rot_x(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def make_trajectory(n_frames: int, translation_step: float = 0.008,
                    rotation_step: float = 0.004) -> List[np.ndarray]:
    """Smooth handheld-like camera-to-world trajectory starting at identity
    (f32 4x4 numpy poses, the ground truth of a synthetic run)."""
    poses = []
    for i in range(n_frames):
        pose = np.eye(4, dtype=np.float32)
        ang = rotation_step * i
        pose[:3, :3] = _rot_y(ang * np.cos(0.15 * i)) @ _rot_x(0.5 * ang)
        pose[0, 3] = translation_step * i
        pose[1, 3] = 0.3 * translation_step * np.sin(0.2 * i) * i
        pose[2, 3] = -0.2 * translation_step * i
        poses.append(pose)
    return poses
