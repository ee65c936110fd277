"""Image preprocessing of the reference: a frozen copy of the plain
versions of voxelhashing_tpu_torch/ops/image.py and
ops/preprocess.py (the range gate, the bilateral depth filter, the
intensity, points and normals).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import CameraConfig, FilterConfig
from .. import geometry as geom


def _shifted(img, dy: int, dx: int):
    """``img`` shifted by (dy, dx) with NaN padding; shape-preserving.
    ``img`` is [h, w] or [h, w, c]."""
    h, w = img.shape[:2]
    pad = (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0))
    if img.ndim == 3:
        pad = (0, 0) + pad
    p = F.pad(img, pad, value=float("nan"))
    y0, x0 = max(-dy, 0), max(-dx, 0)
    return p[y0:y0 + h, x0:x0 + w]


def bilateral_filter_depth(depth, sigma_d: float, sigma_r: float):
    """Edge-preserving depth smoothing (window radius ceil(2*sigma_d),
    spatial x range Gaussian weights, invalid neighbours skipped, centre
    must be valid)."""
    radius = int(math.ceil(2.0 * sigma_d))
    valid_c = torch.isfinite(depth)
    acc = torch.zeros_like(depth)
    wsum = torch.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = _shifted(depth, dy, dx)
            ok = torch.isfinite(nb)
            diff = torch.where(ok, nb - depth, 0.0)
            w = math.exp(-(dx * dx + dy * dy) / (2.0 * sigma_d * sigma_d)) \
                * torch.exp(geom.div_const(-(diff * diff),
                                           2.0 * sigma_r * sigma_r))
            w = torch.where(ok, w, 0.0)
            acc += w * torch.where(ok, nb, 0.0)
            wsum += w
    return torch.where((wsum > 0.0) & valid_c,
                       acc / torch.clamp(wsum, min=1e-20), torch.nan)


def gauss_filter_depth(depth, sigma_d: float, sigma_r: float):
    """Gaussian smoothing with range gate |d - d_centre| < sigma_r."""
    radius = int(math.ceil(2.0 * sigma_d))
    valid_c = torch.isfinite(depth)
    acc = torch.zeros_like(depth)
    wsum = torch.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = _shifted(depth, dy, dx)
            ok = torch.isfinite(nb) & (torch.abs(nb - depth) < sigma_r)
            w = torch.where(
                ok, math.exp(-(dx * dx + dy * dy)
                             / (2.0 * sigma_d * sigma_d)), 0.0)
            acc += w * torch.where(ok, nb, 0.0)
            wsum += w
    return torch.where((wsum > 0.0) & valid_c,
                       acc / torch.clamp(wsum, min=1e-20), torch.nan)


def color_to_intensity(color):
    """RGB [h,w,3] (0..1) -> luma [h,w] (BT.601 weights)."""
    return (0.299 * color[..., 0] + 0.587 * color[..., 1]
            + 0.114 * color[..., 2])


def resample_half(img):
    """2x downsample by even-pixel decimation (pyramid levels)."""
    return img[::2, ::2]


class FrameInputs:
    """Preprocessed per-frame inputs: filtered depth, camera-space points,
    normals, color and intensity."""

    __slots__ = ("depth", "points", "normals", "color", "intensity")

    def __init__(self, depth, points, normals, color, intensity):
        self.depth = depth
        self.points = points
        self.normals = normals
        self.color = color
        self.intensity = intensity


def preprocess(depth_raw, color_raw, cam: CameraConfig, flt: FilterConfig
               ) -> FrameInputs:
    """Depth range gate, optional bilateral depth filter, optional color
    filter, intensity, position map and input normal map.

    depth_raw: [h,w] float32 metres, NaN/<=0 invalid.
    color_raw: [h,w,3] float32 in [0,1], or None.
    """
    depth = torch.where(
        torch.isfinite(depth_raw)
        & (depth_raw >= cam.depth_min) & (depth_raw <= cam.depth_max),
        depth_raw, torch.nan)
    if flt.depth_filter:
        depth = bilateral_filter_depth(depth, flt.depth_sigma_d,
                                       flt.depth_sigma_r)
    color, intensity = None, None
    if color_raw is not None:
        color = color_raw
        if flt.color_filter:
            color = torch.stack(
                [gauss_filter_depth(color_raw[..., i], flt.color_sigma_d,
                                    flt.color_sigma_r) for i in range(3)],
                dim=-1)
        intensity = color_to_intensity(color)
    points = geom.depth_to_points(depth, cam)
    normals = geom.normals_from_points(points)
    return FrameInputs(depth=depth, points=points, normals=normals,
                       color=color, intensity=intensity)
