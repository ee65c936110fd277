"""Image-space preprocessing (PyTorch port of ``voxelhashing_tpu.ops.image``).

Bilateral / range-gated Gaussian depth filtering as stacked shifted views,
intensity conversion, camera-space position and normal maps, the 2x
decimation used by the tracking pyramid, depth erosion, pull-push hole
filling, and the host-side (numpy) depth-to-color remap of the
calibration path. Invalid pixels are NaN.
"""

from __future__ import annotations

import math

import numpy as np
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


def erode_depth(depth, radius: int = 2, thresh: float = 0.1,
                frac_req: float = 0.5):
    """Invalidate depth pixels whose neighbourhood disagrees: a pixel dies
    when at least ``frac_req`` of its (2r+1)^2 window is invalid or differs
    by more than ``thresh``."""
    count_bad = torch.zeros_like(depth)
    count_all = 0.0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = _shifted(depth, dy, dx)
            bad = ~torch.isfinite(nb) | (torch.abs(nb - depth) > thresh)
            count_bad += bad.to(depth.dtype)
            count_all += 1.0
    keep = count_bad < frac_req * count_all
    return torch.where(keep & torch.isfinite(depth), depth, torch.nan)


def fill_holes_pullpush(depth, levels: int = 5, smooth_iters: int = 2):
    """Pull-push pyramid depth inpainting, then Jacobi-Laplace smoothing of
    the filled-in pixels only. Pull: average the valid pixels of each 2x2
    cell into the coarser level; push: fill invalid fine pixels from the
    coarser level."""
    orig_valid = torch.isfinite(depth)
    m = 1 << levels
    h, w = depth.shape
    d = F.pad(depth, (0, (-w) % m, 0, (-h) % m), value=float("nan"))
    pyr = [d]
    for _ in range(levels):
        cur = pyr[-1]
        v = torch.isfinite(cur)
        vals = torch.where(v, cur, 0.0)
        s = (vals[0::2, 0::2] + vals[0::2, 1::2]
             + vals[1::2, 0::2] + vals[1::2, 1::2])
        f32 = torch.float32
        c = (v[0::2, 0::2].to(f32) + v[0::2, 1::2].to(f32)
             + v[1::2, 0::2].to(f32) + v[1::2, 1::2].to(f32))
        pyr.append(torch.where(c > 0, s / torch.clamp(c, min=1.0),
                               torch.nan))
    filled = pyr[-1]
    for lvl in range(levels - 1, -1, -1):
        up = filled.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        filled = torch.where(torch.isfinite(pyr[lvl]), pyr[lvl], up)
    filled = filled[:h, :w]
    synth = ~orig_valid & torch.isfinite(filled)
    out = torch.where(orig_valid, depth, filled)
    for _ in range(smooth_iters):
        p = F.pad(out[None], (1, 1, 1, 1), mode="replicate")[0]
        lap = 0.25 * (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2]
                      + p[1:-1, 2:])
        out = torch.where(synth & torch.isfinite(lap), lap, out)
    return out


def remap_depth_to_color(depth, depth_intr, color_intr, color_width: int,
                         color_height: int, depth_extr=None, color_extr=None,
                         disc_offset: float = 0.03, disc_lin: float = 0.02):
    """Depth map -> the color camera's pixel grid (host-side numpy, the
    input path of a sensor whose depth and color calibrations differ).

    Drops depth pixels whose 3x3 spread exceeds ``disc_offset + disc_lin *
    z`` (depth discontinuities), unprojects with the depth intrinsics,
    moves by ``inv(color_extr) @ depth_extr``, projects with the color
    intrinsics, and z-buffers each point into a 3x3 footprint of the color
    grid. Returns f32[color_height, color_width] metres, NaN where nothing
    lands.
    """
    d = np.asarray(depth, np.float32)
    h, w = d.shape
    valid = np.isfinite(d) & (d > 0.0)

    dpad = np.pad(np.where(valid, d, np.nan), 1, constant_values=np.nan)
    win = np.lib.stride_tricks.sliding_window_view(dpad, (3, 3))
    with np.errstate(invalid="ignore"):
        spread = np.nanmax(win, axis=(2, 3)) - np.nanmin(win, axis=(2, 3))
    keep = valid & (spread <= disc_offset + disc_lin * np.where(valid, d, 0))

    fx_d, fy_d = depth_intr[0, 0], depth_intr[1, 1]
    cx_d, cy_d = depth_intr[0, 2], depth_intr[1, 2]
    u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    z = np.where(keep, d, np.nan)
    x = (u - cx_d) / fx_d * z
    y = (v - cy_d) / fy_d * z

    t = np.eye(4, dtype=np.float64)
    if depth_extr is not None:
        t = t @ np.asarray(depth_extr, np.float64)
    if color_extr is not None:
        t = np.linalg.inv(np.asarray(color_extr, np.float64)) @ t
    pts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=0)
    q = t[:3, :3] @ pts + t[:3, 3:4]
    qz = q[2]
    ok = np.isfinite(qz) & (qz > 1e-6)
    qz_s = np.where(ok, qz, 1.0)
    uc = np.floor(color_intr[0, 0] * q[0] / qz_s + color_intr[0, 2]
                  + 0.5).astype(np.int64)
    vc = np.floor(color_intr[1, 1] * q[1] / qz_s + color_intr[1, 2]
                  + 0.5).astype(np.int64)

    out = np.full((color_height + 2, color_width + 2), np.inf, np.float32)
    for dv in (-1, 0, 1):
        for du in (-1, 0, 1):
            ui = uc + 1 + du
            vi = vc + 1 + dv
            m = ok & (ui >= 0) & (ui < color_width + 2) \
                & (vi >= 0) & (vi < color_height + 2)
            np.minimum.at(out, (vi[m], ui[m]), qz[m].astype(np.float32))
    res = out[1:-1, 1:-1]
    return np.where(np.isfinite(res), res, np.nan)


def depth_to_hsv(depth, d_min: float, d_max: float):
    """Depth [h,w] in [d_min, d_max] -> RGB [h,w,3] along the HSV hue ramp
    (near red, far blue); invalid depth is black."""
    t = torch.clamp(geom.div_const(depth - d_min, d_max - d_min), 0.0, 1.0)
    h = geom.div_const((1.0 - t) * 240.0, 60.0)
    i = torch.floor(h)
    f = h - i
    one, p, q = torch.ones_like(f), torch.zeros_like(f), 1.0 - f
    vals = torch.stack([
        torch.stack([one, f, p], -1),
        torch.stack([q, one, p], -1),
        torch.stack([p, one, f], -1),
        torch.stack([p, q, one], -1),
        torch.stack([f, p, one], -1),
    ])
    idx = torch.clamp(i.to(torch.int64), 0, 4)
    rgb = torch.gather(vals, 0, idx[None, ..., None].expand(
        (1,) + tuple(idx.shape) + (3,)))[0]
    return torch.where(torch.isfinite(depth)[..., None], rgb, 0.0)


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
    filter, intensity, position map and input normal map: on a CUDA tensor
    one launch of ``preprocess_kernel`` (``ops/preprocess.py``), on a CPU
    tensor its plain version ``preprocess.preprocess_plain``.

    depth_raw: [h,w] float32 metres, NaN/<=0 invalid.
    color_raw: [h,w,3] float32 in [0,1], or None.
    """
    from .preprocess import preprocess_depth
    return preprocess_depth(depth_raw, color_raw, cam, flt)
