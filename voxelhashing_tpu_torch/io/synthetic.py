"""Synthetic RGB-D frames rendered on the device (PyTorch port of the
wall + floor + spheres + boxes scene, the handheld trajectory, the stress
scenes and the Kinect-style noise model of ``voxelhashing_tpu.io.synthetic``).

Exact ray/plane, ray/sphere and ray/box (slab) intersections for every
pixel, in the same operation order as the numpy renderer. Depth noise is
drawn on the host with numpy's generator from the frame's seed, so both
packages add the same noise; ``kinect_noise`` is the same numpy model.

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
class Box:
    """Axis-aligned box (clutter and occluder primitive of stress scenes)."""

    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]
    color: Tuple[float, float, float] = (0.7, 0.5, 0.2)


@dataclasses.dataclass(frozen=True)
class Scene:
    """A wall plane z = wall_z (world), an optional floor plane y = floor_y
    (y points down) and spheres and boxes in front of them."""

    wall_z: float = 2.5
    wall_color: Tuple[float, float, float] = (0.6, 0.6, 0.65)
    floor_y: Optional[float] = 1.0
    floor_color: Tuple[float, float, float] = (0.45, 0.4, 0.35)
    spheres: Tuple[Sphere, ...] = (
        Sphere(center=(0.0, 0.2, 1.8), radius=0.3),
        Sphere(center=(-0.5, -0.2, 2.0), radius=0.25,
               color=(0.2, 0.5, 0.8)),
    )
    boxes: Tuple[Box, ...] = ()


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
    for bx in scene.boxes:
        # slab-method ray/box intersection over all pixels
        lo = torch.tensor(bx.lo, dtype=f32, device=device)
        hi = torch.tensor(bx.hi, dtype=f32, device=device)
        safe = torch.where(torch.abs(dirs) > 1e-12, dirs, 1e-12)
        t0 = (lo - origin) / safe
        t1 = (hi - origin) / safe
        t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
        t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
        consider(torch.where(t_near > 0.0, t_near, torch.inf),
                 (t_near <= t_far) & (t_far > 0.0), bx.color)

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


def kinect_noise(depth: np.ndarray, cam: CameraConfig, seed: int = 0,
                 baseline: float = 0.075, dropout_grad: float = 0.04,
                 salt_dropout: float = 0.002,
                 fx_raw: float = 580.0) -> np.ndarray:
    """Structured-light depth corruption on a host (numpy) depth map:
    disparity d = f*b/z with Gaussian noise of 1/12 and quantisation to 1/8
    of a disparity step at the raw sensor's focal length, edge dropout
    (depth steps above ``dropout_grad``, dilated one pixel) and salt
    dropout. Invalid pixels are NaN."""
    rng = np.random.default_rng(seed)
    fb = fx_raw * baseline
    valid = np.isfinite(depth) & (depth > 0)
    z = np.where(valid, depth, 1.0)
    disp = fb / z
    disp = disp + rng.normal(0.0, 1.0 / 12.0, disp.shape)
    disp = np.round(disp * 8.0) / 8.0
    z_q = fb / np.maximum(disp, 1e-6)
    gy = np.abs(np.diff(z, axis=0, prepend=z[:1]))
    gx = np.abs(np.diff(z, axis=1, prepend=z[:, :1]))
    edge = (np.maximum(gx, gy) > dropout_grad)
    edge = (edge
            | np.roll(edge, 1, 0) | np.roll(edge, -1, 0)
            | np.roll(edge, 1, 1) | np.roll(edge, -1, 1))
    drop = edge | (rng.random(z.shape) < salt_dropout)
    return np.where(valid & ~drop, z_q, np.nan).astype(np.float32)


def clutter_scene() -> Scene:
    """Occlusion-heavy stress scene: boxes in front of spheres in front of
    the wall and floor."""
    return Scene(
        wall_z=2.6,
        floor_y=0.9,
        spheres=(
            Sphere(center=(0.0, 0.25, 2.0), radius=0.3),
            Sphere(center=(-0.55, -0.15, 2.2), radius=0.25,
                   color=(0.2, 0.5, 0.8)),
            Sphere(center=(0.65, 0.0, 1.9), radius=0.2,
                   color=(0.3, 0.7, 0.3)),
        ),
        boxes=(
            Box(lo=(-0.15, -0.05, 1.15), hi=(0.2, 0.45, 1.45)),
            Box(lo=(-0.75, 0.3, 1.5), hi=(-0.35, 0.75, 1.85),
                color=(0.4, 0.3, 0.6)),
            Box(lo=(0.35, -0.5, 1.6), hi=(0.75, -0.15, 2.0),
                color=(0.25, 0.55, 0.55)),
            Box(lo=(-0.3, 0.6, 2.0), hi=(0.5, 0.9, 2.5),
                color=(0.6, 0.55, 0.3)),
        ),
    )


def wall_only_scene(z: float = 2.0) -> Scene:
    """Textureless-wall degeneracy scene: one fronto-parallel plane, which
    point-to-plane ICP constrains in z, pitch and yaw only."""
    return Scene(wall_z=z, floor_y=None, spheres=(), boxes=())


def make_sequence(n_frames: int, cam: CameraConfig,
                  scene: Optional[Scene] = None, noise_sigma: float = 0.0,
                  device="cuda"):
    """Render ``make_trajectory(n_frames)`` on ``device`` (the card unless
    the caller asks for the CPU), frame i with noise seed i.

    Returns (depths f32[n,h,w], colors f32[n,h,w,3], poses list of 4x4).
    """
    scene = scene or Scene()
    poses = make_trajectory(n_frames)
    frames = [render_depth(p, cam, scene, noise_sigma=noise_sigma, seed=i,
                           device=device) for i, p in enumerate(poses)]
    return (torch.stack([d for d, _ in frames]),
            torch.stack([c for _, c in frames]), poses)
