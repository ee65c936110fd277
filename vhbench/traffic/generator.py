"""The one generator of the benchmark's traffic: a lap of RGB-D frames of
a synthetic scene along a camera path, both described by a mix's data
file (``traffic/<name>.json``), with Kinect-like depth noise from the
run's seed.

The scene renderer is a copy of ``voxelhashing_tpu_torch.io.synthetic``'s
(exact ray/plane, ray/sphere and ray/box intersections for every pixel),
written here so that the benchmark's inputs do not come from the program.
The camera convention is the program's: x right, y down, z forward, a
pose is camera-to-world.

A mix's file holds:

- ``scene``: ``wall_z`` (or null), ``floor_y`` (or null) and their colors,
  and lists of ``spheres`` (``center``, ``radius``, ``color``) and
  ``boxes`` (``lo``, ``hi``, ``color``);
- ``path``: ``kind`` (a name in :data:`PATHS`) with that kind's
  parameters; the lap is ``frames`` long and, unless the mix runs
  sessions, closed: the step from its last pose to its first is like any
  other step;
- ``sessions`` (optional, false by default): each lap is a session of its
  own, started on a fresh empty map handed to the same step;
- ``noise_sigma``: the depth noise (m), drawn per frame from the seed and
  the frame's index in the lap.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


class Lap(NamedTuple):
    """A lap of frames in host memory, as a sensor delivers them."""

    poses: np.ndarray        # f32 [N,4,4] camera-to-world, pose 0 first
    depth: np.ndarray        # f32 [N,h,w] metres, 0 where invalid
    color: np.ndarray        # f32 [N,h,w,3] in [0, 1]


def load_mix(name: str, root: Path = HERE) -> dict:
    """The data file of the mix ``name``."""
    with open(root / f"{name}.json") as f:
        return json.load(f)


def _look_at(eye, target, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """Camera-to-world pose at ``eye`` looking at ``target`` (z forward,
    y down: ``up`` is world up, -y)."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    z = target - eye
    z /= np.linalg.norm(z)
    x = np.cross(-np.asarray(up), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, eye
    return m


def _rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_x(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def sway(frames: int, shift, turn, **_) -> np.ndarray:
    """A closed handheld sway about the start, one lap of ``frames``:
    position ``shift`` = (ax, ay, az) metres as (ax sin p, ay sin 2p,
    az (1 - cos p)) and the view turned ``turn`` = (yaw, pitch) radians as
    (yaw sin p, pitch sin 2p), with p = 2 pi i / frames."""
    ax, ay, az = shift
    yaw, pitch = turn
    out = []
    for i in range(frames):
        p = 2.0 * math.pi * i / frames
        m = np.eye(4)
        m[:3, :3] = _rot_y(yaw * math.sin(p)) @ _rot_x(pitch
                                                        * math.sin(2 * p))
        m[:3, 3] = (ax * math.sin(p), ay * math.sin(2 * p),
                    az * (1.0 - math.cos(p)))
        out.append(m)
    return np.stack(out)


def arc(frames: int, center, radius: float, height: float,
        sweep: float, **_) -> np.ndarray:
    """An object scan: the camera on a horizontal circle of ``radius``
    about ``center``, ``height`` metres above it (world up is -y), at the
    angle ``sweep`` cos p (radians; p = 2 pi i / frames), looking at
    ``center``."""
    c = np.asarray(center, np.float64)
    out = []
    for i in range(frames):
        a = sweep * math.cos(2.0 * math.pi * i / frames)
        eye = c + np.array([radius * math.sin(a), -height,
                            -radius * math.cos(a)])
        out.append(_look_at(eye, c))
    return np.stack(out)


def walk(frames: int, start, step, **_) -> np.ndarray:
    """A walk: the camera facing +z, from ``start`` by ``step`` (metres, a
    3-vector) a frame. Not a closed lap: a mix that walks runs each lap as
    a session of its own (``"sessions": true``)."""
    out = []
    for i in range(frames):
        m = np.eye(4)
        m[:3, 3] = np.asarray(start, np.float64) + i * np.asarray(step)
        out.append(m)
    return np.stack(out)


def out_back(frames: int, start, step, **_) -> np.ndarray:
    """A walk out and back along one line: the camera facing +z, at
    ``start`` plus ``step`` (metres, a 3-vector) times min(i, frames - i)
    at frame i, so half a lap out and half back, and a closed lap: the
    step from the last frame to the first is a step like any other."""
    out = []
    for i in range(frames):
        m = np.eye(4)
        m[:3, 3] = np.asarray(start, np.float64) \
            + min(i, frames - i) * np.asarray(step, np.float64)
        out.append(m)
    return np.stack(out)


PATHS = {"sway": sway, "arc": arc, "walk": walk, "out_back": out_back}


def lap_poses(mix: dict) -> np.ndarray:
    """The lap's world poses (f32 [N,4,4]) expressed in the first camera's
    frame, so that pose 0 is the identity, where the program starts."""
    path = mix["path"]
    world = PATHS[path["kind"]](**path)
    first = np.linalg.inv(world[0])
    return np.stack([first @ m for m in world]).astype(np.float32), world


def render(world_pose, cam, scene: dict, device):
    """Depth (f32 [h,w], NaN where invalid) and color (f32 [h,w,3]) of
    ``scene`` from the world pose ``world_pose`` on ``device``."""
    h, w = cam.height, cam.width
    f32 = torch.float32
    v, u = torch.meshgrid(torch.arange(h, dtype=f32, device=device),
                          torch.arange(w, dtype=f32, device=device),
                          indexing="ij")
    dirs_cam = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                            torch.ones_like(u)], dim=-1)
    pose = torch.as_tensor(np.asarray(world_pose, np.float32), device=device)
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

    if scene.get("wall_z") is not None:
        plane(2, scene["wall_z"], scene.get("wall_color", (0.6, 0.6, 0.65)))
    if scene.get("floor_y") is not None:
        plane(1, scene["floor_y"], scene.get("floor_color",
                                             (0.45, 0.4, 0.35)))
    a = torch.sum(dirs * dirs, dim=-1)
    for s in scene.get("spheres", ()):
        oc = origin - torch.tensor(s["center"], dtype=f32, device=device)
        b = 2.0 * torch.sum(dirs * oc, dim=-1)
        c = torch.dot(oc, oc) - s["radius"] ** 2
        disc = b * b - 4 * a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        consider((-b - sq) / (2 * a), disc > 0, s.get("color",
                                                      (0.8, 0.3, 0.2)))
    for bx in scene.get("boxes", ()):
        lo = torch.tensor(bx["lo"], dtype=f32, device=device)
        hi = torch.tensor(bx["hi"], dtype=f32, device=device)
        safe = torch.where(torch.abs(dirs) > 1e-12, dirs, 1e-12)
        t0 = (lo - origin) / safe
        t1 = (hi - origin) / safe
        t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
        t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
        consider(torch.where(t_near > 0.0, t_near, torch.inf),
                 (t_near <= t_far) & (t_far > 0.0),
                 bx.get("color", (0.7, 0.5, 0.2)))
    depth = torch.where(torch.isfinite(best_t), best_t, torch.nan)
    depth = torch.where((depth >= cam.depth_min) & (depth <= cam.depth_max),
                        depth, torch.nan)
    return depth, color


def make_lap(mix: dict, cam, seed: int, device) -> Lap:
    """The lap of ``mix`` for ``cam``: each frame rendered on ``device``,
    its depth noise drawn on the host from (seed, frame index), then kept
    in host memory (depth NaN as 0)."""
    poses, world = lap_poses(mix)
    sigma = float(mix.get("noise_sigma", 0.0))
    n, h, w = len(poses), cam.height, cam.width
    depth = np.empty((n, h, w), np.float32)
    color = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        d, c = render(world[i], cam, mix["scene"], device)
        d = d.cpu().numpy()
        if sigma > 0.0:
            rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), i])
            d = d + rng.normal(0.0, sigma, d.shape).astype(np.float32)
        depth[i] = np.nan_to_num(d, nan=0.0)
        color[i] = c.cpu().numpy()
    return Lap(poses, depth, color)
