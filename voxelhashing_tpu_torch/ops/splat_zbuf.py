"""Kernel B: the splat z-buffer, and the color render's walk and resolve
(``csrc/splat_zbuf.cu``).

Kernel B replaces the TPU Pallas kernel
``voxelhashing_tpu/ops/pallas_splat.py`` (``pl.pallas_call`` at :188,
reached through ``splat_zbuf_pallas``). A color render has no TPU kernel
(the JAX package renders color with XLA, ``raycast._splat_zbuf``); on the
card it is one walk of the surface rows, B's body with one 64-bit
``atomicMin`` per voxel of (z_surf bits << 32 | 0xFFFFFFFF - flat index),
then a per-pixel resolve into the z-buffer and the colors, with no host
sync.

:func:`splat_zbuf` and :func:`splat_zbuf_color` launch the CUDA kernels
for CUDA tensors and run the plain PyTorch version (:func:`splat_zbuf_plain`,
the XLA ``raycast._splat_zbuf`` of the JAX package, with ``with_color``
for a color render) for CPU tensors; any other device raises. There is no
fallback from a kernel to its plain version. Each plain version counts
its calls on CUDA tensors (``cuda_calls``), so a run can show that its
main path never took one. :func:`splat_keys_plain` and
:func:`splat_resolve_plain` are the plain versions of the color walk and
the resolve alone.

Color ties: of the voxels whose z_surf equals the z-buffer at one pixel,
the one with the largest flat index (active-list position * 512 + voxel)
gives the color, in every version, so the kernels and the plain versions
agree bit for bit.

On a CUDA tensor each wrapper checks what its kernels assume and makes
the outputs (:func:`prepare`, :func:`prepare_color`); :func:`launch` and
:func:`launch_color` issue the kernels alone. The least time of each on
the card is the larger of its bytes (:func:`bytes_moved`,
:func:`color_bytes_moved`) over the memory rate and its f32 operations
(:func:`operations`, the same for both) over the f32 rate; see the source.
"""

from __future__ import annotations

import torch

from ..config import CameraConfig, MapConfig, VOXELS_PER_BLOCK
from .. import geometry as geom
from ..blockmap import MapState, POOL_DTYPE
from . import _build

_INF_BITS = 0x7F800000
_POOL_ALIGN = 16      # bulk copies (TMA) need 16-byte aligned rows
# the color walk's key at a pixel no voxel hit: +inf, no flat index
NO_HIT_KEY = (_INF_BITS << 32) | 0xFFFFFFFF


def bytes_moved(n_surface_rows: int, max_rows: int,
                cam: CameraConfig) -> int:
    """The least bytes kernel B must move, each input read once and each
    output written once: bf16 sdf and weight of every voxel of the
    ``n_surface_rows`` rows (4 B); per surface row its ``active_idx``
    entry and block key; the row mask of all ``max_rows`` rows (1 B each);
    the z-buffer written (f32 per pixel); the view matrix."""
    row_reads = 2 * 2 * VOXELS_PER_BLOCK * n_surface_rows
    return (row_reads + (4 + 4) * n_surface_rows + max_rows
            + 4 * cam.height * cam.width + 64)


# f32 operations, counted on the plain version (splat_targets) with adds,
# multiplies, divisions, floor, abs and compares one each: every voxel of a
# surface row takes the band test (3); a voxel in the band is placed (3),
# moved into the camera (18), projected (12: z_surf and two pixel
# coordinates) and tested against the screen and the depth range (3)
_OPS_PER_VOXEL = 3
_OPS_PER_BAND_VOXEL = 3 + 18 + 12 + 3


def operations(n_surface_rows: int, n_band: int) -> int:
    """The f32 operations kernel B must do for ``n_surface_rows`` rows
    holding ``n_band`` voxels in the surface band (w > 0, |sdf| < voxel);
    the kernel projects only those."""
    return (_OPS_PER_VOXEL * VOXELS_PER_BLOCK * n_surface_rows
            + _OPS_PER_BAND_VOXEL * n_band)


def color_bytes_moved(n_surface_rows: int, n_covered: int, max_rows: int,
                      cam: CameraConfig) -> int:
    """The least bytes a color render (the color walk and the resolve)
    must move: kernel B's (:func:`bytes_moved`), the packed color per
    pixel written (4 B), and the pool color of each of the ``n_covered``
    pixels' winning voxel read (4 B). The 64-bit key buffer between the
    two kernels is neither an input nor an output and is not counted."""
    return (bytes_moved(n_surface_rows, max_rows, cam)
            + 4 * cam.height * cam.width + 4 * n_covered)


def splat_zbuf_plain(state: MapState, active_idx, row_mask, view,
                     cam: CameraConfig, cfg: MapConfig,
                     with_color: bool = False):
    """Project the surface-band voxels of the rows ``active_idx[row_mask]``
    and scatter-min their predicted surface depths into a flat z-buffer:
    the plain PyTorch version of kernel B, and with ``with_color`` of a
    color render (the color walk and the resolve of
    :func:`splat_zbuf_color`; its colors are :func:`splat_color_plain`'s).
    The mask is resolved on the host, one sync on CUDA.

    Returns (zbuf f32[h*w] (+inf = empty), colbuf int32[h*w]) (colbuf all
    zero unless ``with_color``).
    """
    if active_idx.device.type == "cuda":
        splat_zbuf_plain.cuda_calls += 1
    p = cam.height * cam.width
    dev = active_idx.device
    targets = splat_targets(state, active_idx, row_mask, view, cam, cfg)
    _, pix, z_surf, _ = targets
    zbuf = torch.full((p + 1,), torch.inf, dtype=torch.float32, device=dev)
    zbuf.scatter_reduce_(0, pix.reshape(-1), z_surf.reshape(-1), "amin",
                         include_self=True)
    zbuf = zbuf[:p]
    if not with_color:
        return zbuf, torch.zeros((p,), dtype=torch.int32, device=dev)
    return zbuf, _winner_colors(state, active_idx, targets, zbuf)


splat_zbuf_plain.cuda_calls = 0


def splat_color_plain(state: MapState, active_idx, row_mask, view,
                      cam: CameraConfig, cfg: MapConfig, zbuf):
    """The colors of a color render given its z-buffer: for each pixel,
    the packed color (int32[h*w], 0 where none) of the surface-band voxel
    of the rows ``active_idx[row_mask]`` whose z_surf equals ``zbuf``
    there; of several, the one with the largest flat index."""
    if active_idx.device.type == "cuda":
        splat_color_plain.cuda_calls += 1
    targets = splat_targets(state, active_idx, row_mask, view, cam, cfg)
    return _winner_colors(state, active_idx, targets, zbuf)


splat_color_plain.cuda_calls = 0


def _winner_colors(state: MapState, active_idx, targets, zbuf):
    """The color of each pixel's winning hit: the max of (flat index << 32
    | packed color) over the hits (a scatter_reduce_ amax), low word."""
    pos, pix, z_surf, ok = targets
    p = zbuf.shape[0]
    zhit = ok & (zbuf[torch.clamp(pix, 0, p - 1)] == z_surf)
    color = state.color[active_idx.long()[pos]].to(torch.int64) & 0xFFFFFFFF
    win = torch.zeros((p + 1,), dtype=torch.int64, device=pos.device)
    win.scatter_reduce_(0, torch.where(zhit, pix, p).reshape(-1),
                        ((_flat_index(pos) << 32) | color).reshape(-1),
                        "amax", include_self=True)
    return (win[:p] & 0xFFFFFFFF).to(torch.int32)


def _flat_index(pos):
    """Flat index (active-list position * 512 + voxel) int64[R,512] of the
    voxels of the rows at active-list positions ``pos``."""
    return pos[:, None] * VOXELS_PER_BLOCK + torch.arange(
        VOXELS_PER_BLOCK, device=pos.device)[None, :]


def pack_splat_keys(z_surf, flat):
    """The color walk's key of each voxel, int64: (z_surf bits << 32) |
    (0xFFFFFFFF - flat). For a positive z_surf (< 2^31 as bits) and a flat
    index below 2^32 it is positive, and its min over the voxels of a
    pixel is the least z_surf and, among bit-equal ones, the largest flat
    index."""
    z_bits = z_surf.contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    return (z_bits << 32) | (0xFFFFFFFF - flat)


def splat_keys_plain(state: MapState, active_idx, row_mask, view,
                     cam: CameraConfig, cfg: MapConfig):
    """The plain version of the color walk: per pixel the min of
    :func:`pack_splat_keys` over the surviving surface-band voxels of the
    rows ``active_idx[row_mask]`` (a scatter_reduce_ amin), int64[h*w],
    ``NO_HIT_KEY`` where none."""
    p = cam.height * cam.width
    pos, pix, z_surf, _ = splat_targets(state, active_idx, row_mask, view,
                                        cam, cfg)
    keys = torch.full((p + 1,), NO_HIT_KEY, dtype=torch.int64,
                      device=active_idx.device)
    keys.scatter_reduce_(0, pix.reshape(-1),
                         pack_splat_keys(z_surf, _flat_index(pos))
                         .reshape(-1), "amin", include_self=True)
    return keys[:p]


def splat_resolve_plain(state: MapState, active_idx, keys):
    """The plain version of the resolve: (zbuf f32[h*w], the keys' high
    words; colbuf int32[h*w], the pool color of the voxel with flat index
    0xFFFFFFFF - low word, 0 where ``keys`` is ``NO_HIT_KEY``)."""
    zbuf = (keys >> 32).to(torch.int32).view(torch.float32)
    hit = keys != NO_HIT_KEY
    flat = torch.where(hit, 0xFFFFFFFF - (keys & 0xFFFFFFFF), 0)
    rows = active_idx.long()[flat // VOXELS_PER_BLOCK]
    color = state.color[rows, flat % VOXELS_PER_BLOCK]
    return zbuf, torch.where(hit, color, 0)


def splat_targets(state: MapState, active_idx, row_mask, view,
                  cam: CameraConfig, cfg: MapConfig):
    """Where each voxel of the rows ``active_idx[row_mask]`` lands:
    (active-list positions int64[R], pixel int64[R,512] (h*w where the
    voxel is dropped), z_surf f32[R,512], kept bool[R,512])."""
    h, w = cam.height, cam.width
    p = h * w
    vs = cfg.voxel_size
    pos = torch.nonzero(row_mask).reshape(-1)
    sel = active_idx.long()[pos]
    sdf = state.sdf[sel].to(torch.float32)
    wgt = state.weight[sel].to(torch.float32)
    px, py, pz = geom.voxel_camera_positions(
        state.block_key[sel], view, cfg.world_blocks, vs)

    surface = (wgt > 0.0) & (torch.abs(sdf) < vs)
    z_surf = pz + sdf
    safe_z = torch.where(pz == 0.0, 1e-12, pz)
    ui = torch.floor(px * cam.fx / safe_z + cam.cx + 0.5).to(torch.int32)
    vi = torch.floor(py * cam.fy / safe_z + cam.cy + 0.5).to(torch.int32)
    ok = (surface & (pz > 0.0)
          & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
          & (z_surf > cam.depth_min) & (z_surf < cam.depth_max))
    pix = torch.where(ok, vi * w + ui, p).long()        # p = dropped
    return pos, pix, z_surf, ok


def _check_inputs(state: MapState, active_idx, row_mask, view):
    dev = active_idx.device
    checks = [
        (state.sdf.dtype == POOL_DTYPE and state.weight.dtype == POOL_DTYPE,
         "pool sdf/weight must be bf16"),
        (state.block_key.dtype == torch.int32, "block_key must be int32"),
        (tuple(state.sdf.shape) == tuple(state.weight.shape)
         == (state.block_key.shape[0], VOXELS_PER_BLOCK),
         "pool shapes must agree"),
        (active_idx.dtype == torch.int32 and active_idx.ndim == 1,
         "active_idx must be int32[M]"),
        (row_mask.dtype == torch.bool
         and tuple(row_mask.shape) == tuple(active_idx.shape),
         "row_mask must be bool[M]"),
        (view.dtype == torch.float32 and tuple(view.shape) == (4, 4),
         "view must be f32[4,4]"),
        (all(t.data_ptr() % _POOL_ALIGN == 0
             for t in (state.sdf, state.weight)),
         "pool sdf/weight must be 16-byte aligned"),
    ]
    for t in (state.sdf, state.weight, state.block_key, active_idx, row_mask,
              view):
        checks.append((t.device == dev, "all tensors on one device"))
        checks.append((t.is_contiguous(), "tensors must be contiguous"))
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"splat_zbuf: {msg}")


def prepare(state: MapState, active_idx, row_mask, view, cam: CameraConfig,
            cfg: MapConfig):
    """Check the inputs and fill the z-buffer with +inf; returns (launch
    arguments, zbuf int32[h*w] holding float bits). The arguments end with
    the device whose current stream :func:`launch` launches on."""
    _check_inputs(state, active_idx, row_mask, view)
    zbuf = torch.full((cam.height * cam.width,), _INF_BITS,
                      dtype=torch.int32, device=active_idx.device)
    p = _build.ptr
    args = (p(view), p(state.block_key), p(active_idx), p(row_mask),
            p(state.sdf), p(state.weight), p(zbuf), active_idx.shape[0],
            cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy,
            cam.depth_min, cam.depth_max, cfg.voxel_size, cfg.world_blocks,
            active_idx.device)
    return args, zbuf


def launch(args) -> None:
    """Launch the kernel on prepared arguments, on the current stream (the
    only place that does; counts the launch)."""
    *kernel_args, device = args
    _build.check(_build.library("splat_zbuf").vh_splat_zbuf(
        *kernel_args, _build.stream_ptr(device)), "splat_zbuf")
    splat_zbuf.launches += 1


def splat_zbuf(state: MapState, active_idx, row_mask, view,
               cam: CameraConfig, cfg: MapConfig):
    """Z-buffer f32[h*w] (+inf = empty) of the surface-band voxels
    (w > 0, |sdf| < voxel) of the rows ``active_idx[row_mask]``, seen from
    ``view`` (world-to-camera)."""
    if active_idx.device.type == "cpu":
        return splat_zbuf_plain(state, active_idx, row_mask, view, cam,
                                cfg)[0]
    if active_idx.device.type != "cuda":
        raise ValueError(f"splat_zbuf: no kernel for {active_idx.device}")
    args, zbuf = prepare(state, active_idx, row_mask, view, cam, cfg)
    launch(args)
    return zbuf.view(torch.float32)


splat_zbuf.launches = 0


def prepare_color(state: MapState, active_idx, row_mask, view,
                  cam: CameraConfig, cfg: MapConfig):
    """Check the inputs of a color render and make its buffers; returns
    (launch arguments, keys int64[h*w] filled with ``NO_HIT_KEY``, zbuf
    int32[h*w] holding float bits, colbuf int32[h*w])."""
    _check_inputs(state, active_idx, row_mask, view)
    p = cam.height * cam.width
    checks = [
        (state.color.dtype == torch.int32
         and tuple(state.color.shape) == tuple(state.sdf.shape),
         "pool color must be int32 [N,512]"),
        (state.color.device == active_idx.device,
         "all tensors on one device"),
        (state.color.is_contiguous(), "tensors must be contiguous"),
        # flat indices (active-list position * 512 + voxel) are 32-bit
        (active_idx.shape[0] * VOXELS_PER_BLOCK <= 1 << 32,
         "max_rows * 512 must fit in 32 bits"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"splat_zbuf_color: {msg}")
    dev = active_idx.device
    keys = torch.full((p,), NO_HIT_KEY, dtype=torch.int64, device=dev)
    zbuf = torch.empty((p,), dtype=torch.int32, device=dev)
    colbuf = torch.empty((p,), dtype=torch.int32, device=dev)
    ptr = _build.ptr
    args = (ptr(view), ptr(state.block_key), ptr(active_idx),
            ptr(row_mask), ptr(state.sdf), ptr(state.weight),
            ptr(state.color), ptr(keys), ptr(zbuf), ptr(colbuf),
            active_idx.shape[0], cam.width, cam.height, cam.fx, cam.fy,
            cam.cx, cam.cy, cam.depth_min, cam.depth_max, cfg.voxel_size,
            cfg.world_blocks, dev)
    return args, keys, zbuf, colbuf


def launch_color(args) -> None:
    """Launch the color walk and the resolve on prepared arguments, on the
    current stream (the only place that does; counts the launch)."""
    *kernel_args, device = args
    _build.check(_build.library("splat_zbuf").vh_splat_zbuf_color(
        *kernel_args, _build.stream_ptr(device)), "splat_zbuf")
    splat_zbuf_color.launches += 1


def splat_zbuf_color(state: MapState, active_idx, row_mask, view,
                     cam: CameraConfig, cfg: MapConfig):
    """A color render of the surface-band voxels of the rows
    ``active_idx[row_mask]`` seen from ``view``: (zbuf f32[h*w], +inf =
    empty, as :func:`splat_zbuf` gives; colbuf int32[h*w], the packed
    color of the voxel that gave each pixel its depth, 0 where none; ties
    go to the largest flat index)."""
    if active_idx.device.type == "cpu":
        return splat_zbuf_plain(state, active_idx, row_mask, view, cam, cfg,
                                with_color=True)
    if active_idx.device.type != "cuda":
        raise ValueError(
            f"splat_zbuf_color: no kernel for {active_idx.device}")
    args, _, zbuf, colbuf = prepare_color(state, active_idx, row_mask, view,
                                          cam, cfg)
    launch_color(args)
    return zbuf.view(torch.float32), colbuf


splat_zbuf_color.launches = 0
