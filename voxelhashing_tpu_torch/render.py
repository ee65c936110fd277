"""Visualization: shading, render modes, image and point-cloud export
(PyTorch port of ``voxelhashing_tpu.render``).

Pure image math on the device of its inputs; the files are written on the
host (PNG through Pillow, PLY with numpy).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .config import CameraConfig
from . import blockmap, geometry as geom, raycast
from .ops.image import depth_to_hsv
from .raycast import RaycastResult

RENDER_MODES = ("phong", "depth", "color", "normal", "input_depth",
                "input_color", "input_normal")


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def phong_shade(points, normals, albedo=None,
                light_dir=(0.3, -0.5, -0.8), ambient=0.2, diffuse=0.7,
                specular=0.3, shininess=16.0):
    """Per-pixel Phong shading of a camera-space position and normal map
    [h,w,3] (normals turned to face the camera); invalid pixels black."""
    dev = points.device
    ld = torch.tensor(light_dir, dtype=torch.float32)
    ld = (ld / torch.linalg.vector_norm(ld)).to(dev)
    valid = (torch.all(torch.isfinite(normals), dim=-1)
             & torch.all(torch.isfinite(points), dim=-1))
    n = torch.where(valid[..., None], normals, 0.0)
    flip = torch.sum(n * points, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)

    ndotl = torch.clamp(torch.sum(n * (-ld), dim=-1), 0.0, 1.0)
    view = -points / torch.clamp(_norm(points), min=1e-9)
    h = view - ld
    h = h / torch.clamp(_norm(h), min=1e-9)
    spec = torch.clamp(torch.sum(n * h, dim=-1), 0.0, 1.0) ** shininess

    base = albedo if albedo is not None else torch.full(
        points.shape[:-1] + (3,), 0.7, dtype=torch.float32, device=dev)
    shade = ((ambient + diffuse * ndotl)[..., None] * base
             + (specular * spec)[..., None])
    out = torch.clamp(shade, 0.0, 1.0)
    return torch.where(valid[..., None], out, 0.0)


def normals_to_rgb(normals):
    """Normal map -> RGB ([-1,1] -> [0,1]); invalid pixels black."""
    ok = torch.all(torch.isfinite(normals), dim=-1, keepdim=True)
    return torch.where(ok, 0.5 * (normals + 1.0), 0.0)


def render_frame(mode: str, model: Optional[RaycastResult],
                 input_frame=None, cam: Optional[CameraConfig] = None):
    """One of the render modes (:data:`RENDER_MODES`) as an RGB [h,w,3]
    tensor in [0,1]; the ``input_*`` modes show ``input_frame``
    (``ops.image.FrameInputs``)."""
    cam = cam or CameraConfig()
    if mode == "phong":
        return phong_shade(model.points, model.normals, model.color)
    if mode == "depth":
        return depth_to_hsv(model.depth, cam.depth_min, cam.depth_max)
    if mode == "color":
        return model.color
    if mode == "normal":
        return normals_to_rgb(model.normals)
    if mode == "input_depth":
        return depth_to_hsv(input_frame.depth, cam.depth_min, cam.depth_max)
    if mode == "input_color":
        return input_frame.color
    if mode == "input_normal":
        return normals_to_rgb(input_frame.normals)
    raise ValueError(f"unknown render mode {mode!r}")


def march_cost_map(state, pose, cam: CameraConfig, map_cfg, rc,
                   active_idx=None, active_mask=None):
    """Per-pixel march sample count over ``rc.num_samples`` as a gray RGB
    [h,w,3] image in [0,1]: how tight the per-tile ray bounds are (white:
    the whole budget, as when the tile bounds fall back to the camera's
    depth range)."""
    view = geom.invert_rigid(pose)
    dev = pose.device
    if active_idx is None:
        active_idx, n_active, _ = blockmap.compactify(state, view, cam,
                                                      map_cfg)
        active_mask = torch.arange(active_idx.shape[0],
                                   device=dev) < n_active
    h, w = cam.height, cam.width
    d = rc.derived(map_cfg)
    if rc.splat_enabled:
        tmin_t, tmax_t = raycast.ray_interval_splat(
            state, active_idx, active_mask, view, cam, map_cfg, rc)
        tile = rc.splat_tile
        iy = torch.div(torch.arange(h, device=dev), tile,
                       rounding_mode="floor")
        ix = torch.div(torch.arange(w, device=dev), tile,
                       rounding_mode="floor")
        t_min = torch.clamp(tmin_t[iy[:, None], ix[None, :]]
                            - map_cfg.truncation, min=cam.depth_min)
        t_max = torch.clamp(tmax_t[iy[:, None], ix[None, :]]
                            + map_cfg.truncation, max=cam.depth_max)
    else:
        t_min = torch.full((h, w), cam.depth_min, dtype=torch.float32,
                           device=dev)
        t_max = torch.full((h, w), cam.depth_max, dtype=torch.float32,
                           device=dev)
    band = torch.clamp(t_max - t_min, min=0.0)
    dt = torch.clamp(geom.div_const(band, rc.num_samples - 1),
                     min=d["ray_increment"])
    steps = torch.clamp(band / dt + 1.0, 0.0, float(rc.num_samples))
    g = geom.div_const(steps, float(rc.num_samples))[..., None]
    return g.expand(h, w, 3)


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_image(path: str, rgb) -> None:
    """Write an RGB [h,w,3] image in [0,1] as PNG."""
    from PIL import Image
    arr = np.clip(_numpy(rgb) * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


class RenderToFile:
    """Per-frame image dumper: each call writes one numbered PNG per mode
    (``<mode>_<frame:06d>.png``) into ``out_dir``."""

    def __init__(self, out_dir: str, modes=("phong", "depth")):
        self.out_dir = out_dir
        self.modes = modes
        self.frame = 0
        os.makedirs(out_dir, exist_ok=True)

    def __call__(self, model: RaycastResult, input_frame=None,
                 cam: Optional[CameraConfig] = None):
        for mode in self.modes:
            img = render_frame(mode, model, input_frame, cam)
            save_image(os.path.join(
                self.out_dir, f"{mode}_{self.frame:06d}.png"), img)
        self.frame += 1


def save_point_cloud(path: str, points, colors=None, normals=None) -> int:
    """Write a position map (or [N,3] points) as a binary PLY point cloud,
    with normals and colors (in [0,1]) when given; non-finite points are
    left out. Returns the point count."""
    pts = _numpy(points).astype(np.float32).reshape(-1, 3)
    ok = np.isfinite(pts).all(axis=1)
    pts = pts[ok]
    cols = None
    if colors is not None:
        cols = np.clip(_numpy(colors).astype(np.float32).reshape(-1, 3)[ok]
                       * 255.0, 0, 255).astype(np.uint8)
    nrm = None
    if normals is not None:
        nrm = np.nan_to_num(
            _numpy(normals).astype(np.float32).reshape(-1, 3)[ok])
    hdr = ["ply", "format binary_little_endian 1.0",
           f"element vertex {len(pts)}",
           "property float x", "property float y", "property float z"]
    fields = [("p", np.float32, 3)]
    if nrm is not None:
        hdr += ["property float nx", "property float ny",
                "property float nz"]
        fields.append(("n", np.float32, 3))
    if cols is not None:
        hdr += ["property uchar red", "property uchar green",
                "property uchar blue"]
        fields.append(("c", np.uint8, 3))
    hdr += ["end_header"]
    rec = np.zeros(len(pts), dtype=fields)
    rec["p"] = pts
    if nrm is not None:
        rec["n"] = nrm
    if cols is not None:
        rec["c"] = cols
    with open(path, "wb") as f:
        f.write(("\n".join(hdr) + "\n").encode())
        f.write(rec.tobytes())
    return len(pts)
