"""The frame's depth preprocess: range gate, bilateral filter, points,
normals and intensity (``csrc/preprocess.cu``).

No TPU kernel: the JAX package runs these steps as XLA
(``voxelhashing_tpu/ops/image.py:217-245`` ``preprocess``, with
``bilateral_filter_depth`` :36 and ``color_to_intensity`` :82;
``voxelhashing_tpu/geometry.py:203`` ``depth_to_points``, :269
``normals_from_points``). :func:`preprocess_plain` is that function op for
op (the CPU path, and the reference on the card); ``image.preprocess``
keeps its name and reaches :func:`preprocess_depth`.

On a CUDA tensor :func:`preprocess_depth` is one launch of
``preprocess_kernel`` a frame (in place of ~1,850 small torch launches),
bit-equal to the plain version: the filtered depth, the points, the
normals and, when the frame has color, its intensity. The wrapper decides
the launch: its grid tiles the frame evenly over the card's SMs
(:func:`tile_grid`), its instantiation (:data:`KERNELS`,
:func:`kernel_index`) comes from the filter's radius, and the filter
divides by 2 sigma_r^2 through its reciprocal, each tap's diff^2 clamped
into the range where that is exact (:func:`division_clamp`). The color
filter (``FilterConfig.color_filter``, off by default) is not in the
kernel: with it on, the filtered color and its intensity are computed
after the launch by the plain torch code. On a CPU tensor the wrapper runs the plain
version; any other device raises. There is no fallback.

:func:`prepare` checks the inputs and makes the outputs, :func:`launch`
issues the kernel on the current stream (the only place that does; it
adds one to ``preprocess_depth.launches``, and to
``preprocess_depth.by_kernel`` under the instantiation it passed). The
plain version counts its
calls on CUDA tensors (``preprocess_plain.cuda_calls``). The least time of
a launch is the larger of :func:`bytes_moved` over the memory rate and
:func:`operations` over the f32 rate.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from . import _build
from .. import geometry as geom
from ..config import CameraConfig, FilterConfig
from . import image

MAX_RADIUS = 8                      # csrc: a filter window up to 17x17
FILTER_THREADS = 704                # csrc kThreads: a CTA's threads
MAX_TILE = (64, 48)                 # csrc kMaxTileX, kMaxTileY
INTENSITY_WEIGHTS = (0.299, 0.587, 0.114)
# vh_preprocess's instantiations, by the index the wrapper passes
KERNELS = ("preprocess_kernel<4>", "preprocess_kernel<0>")
# c = 2 sigma_r^2 for which the clamped reciprocal division is exact
DIVISOR_RANGE = (2.0 ** -70, 2.0 ** 100)
ARG_KERNEL, ARG_GRID = 17, 30       # their positions in the launch args


# ---------------------------------------------------------------------------
# The plain version (the CPU path; the reference on the card)
# ---------------------------------------------------------------------------

def preprocess_plain(depth_raw, color_raw, cam: CameraConfig,
                     flt: FilterConfig) -> image.FrameInputs:
    """Depth range gate, optional bilateral depth filter, optional color
    filter, intensity, position map and input normal map.

    depth_raw: [h,w] float32 metres, NaN/<=0 invalid.
    color_raw: [h,w,3] float32 in [0,1], or None.
    """
    if depth_raw.device.type == "cuda":
        preprocess_plain.cuda_calls += 1
    depth = torch.where(
        torch.isfinite(depth_raw)
        & (depth_raw >= cam.depth_min) & (depth_raw <= cam.depth_max),
        depth_raw, torch.nan)
    if flt.depth_filter:
        depth = image.bilateral_filter_depth(depth, flt.depth_sigma_d,
                                             flt.depth_sigma_r)
    color, intensity = _color_plain(color_raw, flt)
    points = geom.depth_to_points(depth, cam)
    normals = geom.normals_from_points(points)
    return image.FrameInputs(depth=depth, points=points, normals=normals,
                             color=color, intensity=intensity)


preprocess_plain.cuda_calls = 0


def _color_plain(color_raw, flt: FilterConfig):
    """(color, intensity): the optional color filter and the intensity,
    (None, None) without color."""
    if color_raw is None:
        return None, None
    color = color_raw
    if flt.color_filter:
        color = torch.stack(
            [image.gauss_filter_depth(color_raw[..., i], flt.color_sigma_d,
                                      flt.color_sigma_r) for i in range(3)],
            dim=-1)
    return color, image.color_to_intensity(color)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def filter_radius(flt: FilterConfig) -> int:
    """The bilateral window's radius, ceil(2 sigma_d), as the plain filter
    takes it."""
    return int(math.ceil(2.0 * flt.depth_sigma_d))


def spatial_weights(flt: FilterConfig) -> np.ndarray:
    """The filter's spatial weights in the plain loop's (dy, dx) order,
    each ``math.exp`` cast to f32 as torch casts a Python float."""
    r = filter_radius(flt)
    sd = flt.depth_sigma_d
    return np.array([math.exp(-(dx * dx + dy * dy) / (2.0 * sd * sd))
                     for dy in range(-r, r + 1) for dx in range(-r, r + 1)],
                    dtype=np.float32)


def two_sr2(flt: FilterConfig) -> float:
    """The range weight's divisor 2 sigma_r^2 as the plain filter takes
    it (a Python float; the kernel gets its f32)."""
    return 2.0 * flt.depth_sigma_r * flt.depth_sigma_r


def division_clamp(flt: FilterConfig):
    """(x_lo, x_hi): the kernel clamps each tap's x = diff^2 into
    [max(2^-96, 2^-100 c), min(2^126, 2^120 c)] for c = f32(2 sigma_r^2)
    before it divides through y = RN(1/c) (``div_rn_recip`` in
    ``csrc/preprocess.cu``, RN(x / c) there); below it the weight is 1,
    above it 0, as the IEEE division's. Both bounds are exact f32 for c in
    :data:`DIVISOR_RANGE`; any other sigma_r raises. (0, 0) without the
    filter."""
    if not flt.depth_filter:
        return 0.0, 0.0
    c = float(np.float32(two_sr2(flt)))
    if not DIVISOR_RANGE[0] <= c <= DIVISOR_RANGE[1]:
        raise ValueError(f"preprocess: the kernel divides by 2 sigma_r^2 in "
                         f"[2^-70, 2^100], got {c} (sigma_r "
                         f"{flt.depth_sigma_r})")
    return max(2.0 ** -96, 2.0 ** -100 * c), min(2.0 ** 126, 2.0 ** 120 * c)


@functools.lru_cache(maxsize=None)
def tile_grid(h: int, w: int, sms: int, threads: int = FILTER_THREADS):
    """(gx, gy): the launch's CTAs across and down. CTA (bx, by) owns the
    output pixels [bx w // gx, (bx + 1) w // gx) x [by h // gy, (by + 1) h
    // gy). The grid is k x ``sms`` CTAs at most, for the least k whose
    tiles fit (a filtered tile, the tile and its one-pixel halo, of at most
    ``threads`` pixels, a tile at most :data:`MAX_TILE`), with the
    smallest filtered tile over the splits of those CTAs (ties: more
    CTAs). 320x240 on 132 SMs: 12 x 11 tiles of 26-27 x 21-22 pixels."""
    k = 1
    while True:
        n = k * sms
        best = None
        for gx in range(1, min(w, n) + 1):
            gy = min(h, n // gx)
            tw, th = -(-w // gx), -(-h // gy)
            if tw > MAX_TILE[0] or th > MAX_TILE[1]:
                continue
            key = ((tw + 2) * (th + 2), -gx * gy)
            if best is None or key < best[0]:
                best = (key, gx, gy)
        if best is not None and best[0][0] <= threads:
            return best[1], best[2]
        k += 1


def kernel_index(flt: FilterConfig) -> int:
    """The instantiation a frame of this filter launches (its index in
    :data:`KERNELS`): ``preprocess_kernel<4>``, its 81 taps unrolled, for
    the default 9x9 window, ``<0>`` for any other radius or no filter."""
    return 0 if flt.depth_filter and filter_radius(flt) == 4 else 1


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _device(t):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"preprocess: no kernel for {dev}")
    return dev


def prepare(depth_raw, color_raw, cam: CameraConfig, flt: FilterConfig):
    """Check the inputs and make the outputs; returns (launch arguments,
    :class:`image.FrameInputs`). The intensity is the kernel's unless the
    color filter is on (then None here: :func:`preprocess_depth` computes
    it after the launch)."""
    dev = depth_raw.device
    h, w = cam.height, cam.width
    if depth_raw.dtype != torch.float32 or tuple(depth_raw.shape) != (h, w):
        raise ValueError(f"preprocess: depth must be f32 {(h, w)}, got "
                         f"{depth_raw.dtype} {tuple(depth_raw.shape)}")
    with_int = color_raw is not None and not flt.color_filter
    if color_raw is not None and (
            color_raw.dtype != torch.float32
            or tuple(color_raw.shape) != (h, w, 3)
            or color_raw.device != dev):
        raise ValueError(f"preprocess: color must be f32 {(h, w, 3)} on "
                         f"the depth's device, got {color_raw.dtype} "
                         f"{tuple(color_raw.shape)} on {color_raw.device}")
    radius = filter_radius(flt) if flt.depth_filter else 0
    if radius > MAX_RADIUS:
        raise ValueError(f"preprocess: the kernel's filter window is at "
                         f"most {2 * MAX_RADIUS + 1} pixels wide (sigma_d "
                         f"<= {MAX_RADIUS / 2}), got radius {radius}")
    spatial = spatial_weights(flt) if flt.depth_filter else np.zeros(
        1, np.float32)
    host_w = (ctypes.c_float * spatial.size)(*spatial.tolist())
    out = image.FrameInputs(
        depth=torch.empty((h, w), dtype=torch.float32, device=dev),
        points=torch.empty((h, w, 3), dtype=torch.float32, device=dev),
        normals=torch.empty((h, w, 3), dtype=torch.float32, device=dev),
        color=color_raw,
        intensity=(torch.empty((h, w), dtype=torch.float32, device=dev)
                   if with_int else None))
    p, pn = _build.ptr, _build.ptr_or_null
    c = color_raw if with_int else None
    cs = color_raw.stride() if with_int else (0, 0, 0)
    c32 = np.float32(two_sr2(flt))
    grid = tile_grid(h, w, _sms(dev.index)) if dev.type == "cuda" else (1, 1)
    args = (p(depth_raw), *depth_raw.stride(), h, w, pn(c), *cs,
            float(cam.depth_min), float(cam.depth_max),
            int(bool(flt.depth_filter)), radius, float(c32),
            float(np.float32(1.0) / c32), *division_clamp(flt),
            kernel_index(flt), ctypes.cast(host_w, ctypes.c_void_p),
            float(cam.fx),
            float(cam.fy), float(cam.cx), float(cam.cy),
            *(float(x) for x in INTENSITY_WEIGHTS), p(out.depth),
            p(out.points), p(out.normals), pn(out.intensity), *grid, host_w,
            dev)
    return args, out


def launch(args) -> None:
    """Launch the kernel on prepared arguments, on the current stream (the
    only place that does; counts the launch)."""
    *kernel_args, _host_w, device = args
    _build.check(_build.library("preprocess").vh_preprocess(
        *kernel_args, _build.stream_ptr(device)), "preprocess")
    preprocess_depth.launches += 1
    preprocess_depth.by_kernel[KERNELS[kernel_args[ARG_KERNEL]]] += 1


def preprocess_depth(depth_raw, color_raw, cam: CameraConfig,
                     flt: FilterConfig) -> image.FrameInputs:
    """The frame's preprocess (see :func:`preprocess_plain`): the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if _device(depth_raw).type == "cpu":
        return preprocess_plain(depth_raw, color_raw, cam, flt)
    args, out = prepare(depth_raw, color_raw, cam, flt)
    launch(args)
    if color_raw is not None and flt.color_filter:
        out.color, out.intensity = _color_plain(color_raw, flt)
    return out


preprocess_depth.launches = 0
preprocess_depth.by_kernel = collections.Counter()


# ---------------------------------------------------------------------------
# The bound
# ---------------------------------------------------------------------------

# f32 operations, hand-counted from the plain version's ops: a filter tap
# whose centre and neighbour are valid (difference, square, negation,
# division, exp, spatial weight, weighted depth, two sums), a valid
# centre's epilogue (clamp, division), a valid point (two subtractions, two
# divisions, two products), a valid normal (six differences, six products
# and three fma's of the cross product, three squares, two sums, sqrt,
# three divisions), a pixel's intensity (three products, two sums).
TAP_OPS, CENTRE_OPS, POINT_OPS, NORMAL_OPS, INT_OPS = 9, 2, 6, 24, 5


def bytes_moved(n_pixels: int, with_color: bool) -> int:
    """The least bytes one launch must move: the raw depth read (4 B a
    pixel) and the filtered depth, points and normals written (28 B); with
    color, the color read (12 B) and the intensity written (4 B)."""
    return n_pixels * (32 + (16 if with_color else 0))


def operations(n_pairs: int, n_valid: int, n_points: int, n_normals: int,
               n_int: int) -> int:
    """f32 operations of one launch: ``n_pairs`` filter taps with both
    pixels valid, ``n_valid`` valid centres, ``n_points`` valid points,
    ``n_normals`` valid normals and ``n_int`` intensities."""
    return (TAP_OPS * n_pairs + CENTRE_OPS * n_valid + POINT_OPS * n_points
            + NORMAL_OPS * n_normals + INT_OPS * n_int)


def work_counts(depth_raw, cam: CameraConfig, flt: FilterConfig,
                out: image.FrameInputs):
    """(n_pairs, n_valid, n_points, n_normals, n_int) of this frame for
    :func:`operations`, counted with torch on ``depth_raw``'s device from
    the gated depth and the outputs ``out``."""
    gate = (torch.isfinite(depth_raw) & (depth_raw >= cam.depth_min)
            & (depth_raw <= cam.depth_max))
    n_valid = int(gate.sum())
    n_pairs = 0
    if flt.depth_filter:
        r = filter_radius(flt)
        ones = torch.where(gate, 1.0, torch.nan)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                nb = image._shifted(ones, dy, dx)
                n_pairs += int((torch.isfinite(nb) & gate).sum())
    n_points = int(torch.isfinite(out.points[..., 2]).sum())
    n_normals = int(torch.isfinite(out.normals[..., 0]).sum())
    n_int = 0 if out.intensity is None else out.intensity.numel()
    return n_pairs, n_valid, n_points, n_normals, n_int


# ---------------------------------------------------------------------------
# An edge bank: the frames where the kernel goes wrong first
# ---------------------------------------------------------------------------

EDGE_CASES = ("edge_values", "all_invalid", "odd", "no_filter",
              "depth_only", "wide_window", "uneven", "radius_3", "radius_5",
              "wide_gate", "wide_gate_radius_3")


def edge_bank(seed: int = 5):
    """Seeded frames with the cases the kernel gets wrong first, each a
    dict of numpy arrays (depth [h,w], color [h,w,3] or None), its ``cam``
    and ``flt`` and its ``case``: a 40x33 frame of a tilted, noisy plane
    with NaN, +-inf, 0, negative, below ``depth_min``, exactly
    ``depth_min`` and ``depth_max``, above ``depth_max`` and isolated valid
    pixels ("edge_values"); every pixel invalid ("all_invalid"); an odd
    17x13 frame, smaller than one tile ("odd"); the edge-value frame with
    the filter off ("no_filter") and with no color ("depth_only"); a 17x17
    window (sigma_d 4, the kernel's widest) with sigma_r 0.05
    ("wide_window"); a 53x47 frame, whose tiles no grid of the card splits
    evenly in either direction ("uneven"); the windows on either side of
    the unrolled 9x9 (radius 3 and 5: "radius_3", "radius_5"); and a gate
    from 0 to 1e30 with depths of 0, 1e-30, 1e-20 and 1e20 (taps whose
    diff^2 underflows, is subnormal or overflows: the division's clamp at
    both ends, at radius 4 and 3, with sigma_r 1 so that no weight is
    subnormal, which XLA on the CPU would flush: "wide_gate",
    "wide_gate_radius_3")."""
    rng = np.random.default_rng(seed)
    out = []
    for case in EDGE_CASES:
        w, h = {"odd": (17, 13), "uneven": (53, 47)}.get(case, (40, 33))
        cam = CameraConfig(width=w, height=h, fx=w * 0.9, fy=w * 0.9,
                           cx=(w - 1) / 2.0, cy=(h - 1) / 2.0)
        v, u = np.meshgrid(np.arange(h, dtype=np.float64),
                           np.arange(w, dtype=np.float64), indexing="ij")
        depth = (1.5 + 0.4 * u / w + 0.2 * v / h
                 + rng.normal(0.0, 0.01, (h, w)))
        depth[rng.random((h, w)) < 0.15] += 0.3          # depth edges
        depth = depth.astype(np.float32)
        color = rng.random((h, w, 3)).astype(np.float32)
        if case != "odd":
            flat = depth.reshape(-1)
            pick = rng.permutation(flat.size)
            vals = [np.nan, np.inf, -np.inf, 0.0, -0.0, -1.0, 0.3,
                    cam.depth_min, cam.depth_max, cam.depth_max + 0.5,
                    np.float32(cam.depth_min) - np.float32(1e-6)]
            if case.startswith("wide_gate"):
                vals += [1e-30, 1e-20, 1e20, 0.0]
            for k, val in enumerate(vals):
                flat[pick[8 * k:8 * k + 8]] = val
            depth[5:12, 20:30] = np.nan                  # a hole
            depth[6, 25] = 2.0                           # an island in it
            color[0, :, 1] = np.nan                      # a NaN channel
        if case.startswith("wide_gate"):
            depth[20:23, 2:6] = np.float32([1e-30, 2e-30, 1e-20, 3e-20])
            cam = dataclasses.replace(cam, depth_min=0.0, depth_max=1e30)
        if case == "all_invalid":
            depth[:] = np.nan
            depth[::3, ::2] = 0.0
        flt = FilterConfig()
        if case == "no_filter":
            flt = FilterConfig(depth_filter=False)
        elif case == "wide_window":
            flt = FilterConfig(depth_sigma_d=4.0, depth_sigma_r=0.05)
        elif case == "radius_3":
            flt = FilterConfig(depth_sigma_d=1.5)
        elif case == "wide_gate":
            flt = FilterConfig(depth_sigma_r=1.0)
        elif case == "wide_gate_radius_3":
            flt = FilterConfig(depth_sigma_d=1.5, depth_sigma_r=1.0)
        elif case == "radius_5":
            flt = FilterConfig(depth_sigma_d=2.5)
        out.append({"case": case, "cam": cam, "flt": flt, "depth": depth,
                    "color": None if case == "depth_only" else color})
    return out


def edge_frame(entry, device):
    """One :func:`edge_bank` entry as (depth, color or None) on
    ``device``."""
    c = entry["color"]
    return (torch.from_numpy(entry["depth"]).to(device),
            None if c is None else torch.from_numpy(c).to(device))
