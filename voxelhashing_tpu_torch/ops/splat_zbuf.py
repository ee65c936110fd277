"""Kernel B: the splat z-buffer, and its color pass (``csrc/splat_zbuf.cu``).

Kernel B replaces the TPU Pallas kernel
``voxelhashing_tpu/ops/pallas_splat.py`` (``pl.pallas_call`` at :188,
reached through ``splat_zbuf_pallas``). The color pass has no TPU kernel
(the JAX package renders color with XLA, ``raycast._splat_zbuf``); it runs
on the card after kernel B so that the color render adds no host sync.

:func:`splat_zbuf` and :func:`splat_color` launch the CUDA kernels for
CUDA tensors and run the plain PyTorch versions (:func:`splat_zbuf_plain`,
the XLA ``raycast._splat_zbuf`` of the JAX package, and
:func:`splat_color_plain`) for CPU tensors; any other device raises. There
is no fallback from a kernel to its plain version. Each plain version
counts its calls on CUDA tensors (``cuda_calls``), so a run can show that
its main path never took one.

Color ties: of the voxels whose z_surf equals the z-buffer at one pixel,
the one with the largest flat index (active-list position * 512 + voxel)
gives the color, in both versions, so the kernel and the plain version
agree bit for bit.

On a CUDA tensor each wrapper checks what its kernel assumes and makes
the outputs (:func:`prepare`, :func:`prepare_color`); :func:`launch` and
:func:`launch_color` issue a kernel alone. The least time of each on the
card is the larger of its bytes (:func:`bytes_moved`,
:func:`color_bytes_moved`) over the memory rate and its f32 operations
(:func:`operations`, :func:`color_operations`) over the f32 rate; see the
source.
"""

from __future__ import annotations

import torch

from ..config import CameraConfig, MapConfig, VOXELS_PER_BLOCK
from .. import geometry as geom
from ..blockmap import MapState, POOL_DTYPE
from . import _build

_INF_BITS = 0x7F800000
_POOL_ALIGN = 16      # bulk copies (TMA) need 16-byte aligned rows


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


def color_bytes_moved(n_surface_rows: int, n_hits: int, max_rows: int,
                      cam: CameraConfig) -> int:
    """The least bytes the color pass must move: kernel B's reads
    (:func:`bytes_moved` without its z-buffer write), the z-buffer read
    (f32 per pixel), the packed color of each of the ``n_hits`` voxels
    whose z_surf equals the z-buffer at its pixel (4 B), and the packed
    color per pixel written (4 B)."""
    return (bytes_moved(n_surface_rows, max_rows, cam)
            + 4 * n_hits + 4 * cam.height * cam.width)


def color_operations(n_surface_rows: int, n_band: int) -> int:
    """Kernel B's f32 operations (:func:`operations`) and one compare with
    the z-buffer per band voxel."""
    return operations(n_surface_rows, n_band) + n_band


def splat_zbuf_plain(state: MapState, active_idx, row_mask, view,
                     cam: CameraConfig, cfg: MapConfig,
                     with_color: bool = False):
    """Project the surface-band voxels of the rows ``active_idx[row_mask]``
    and scatter-min their predicted surface depths into a flat z-buffer:
    the plain PyTorch version of kernel B, and with ``with_color`` of the
    color pass too (:func:`splat_color_plain`). The mask is resolved on the
    host, one sync on CUDA.

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
    """The plain PyTorch version of the color pass: for each pixel, the
    packed color (int32[h*w], 0 where none) of the surface-band voxel of
    the rows ``active_idx[row_mask]`` whose z_surf equals ``zbuf`` there;
    of several, the one with the largest flat index."""
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
    flat = pos[:, None] * VOXELS_PER_BLOCK + torch.arange(
        VOXELS_PER_BLOCK, device=pos.device)[None, :]
    color = state.color[active_idx.long()[pos]].to(torch.int64) & 0xFFFFFFFF
    win = torch.zeros((p + 1,), dtype=torch.int64, device=pos.device)
    win.scatter_reduce_(0, torch.where(zhit, pix, p).reshape(-1),
                        ((flat << 32) | color).reshape(-1), "amax",
                        include_self=True)
    return (win[:p] & 0xFFFFFFFF).to(torch.int32)


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
                  cam: CameraConfig, cfg: MapConfig, zbuf):
    """Check the inputs of the color pass and zero its output; returns
    (launch arguments, win int64[h*w], whose low words are the colors).
    ``zbuf`` is kernel B's finished z-buffer for the same rows."""
    _check_inputs(state, active_idx, row_mask, view)
    p = cam.height * cam.width
    checks = [
        (state.color.dtype == torch.int32
         and tuple(state.color.shape) == tuple(state.sdf.shape),
         "pool color must be int32 [N,512]"),
        (zbuf.dtype == torch.float32 and tuple(zbuf.shape) == (p,),
         "zbuf must be f32[h*w]"),
    ]
    for t in (state.color, zbuf):
        checks.append((t.device == active_idx.device,
                       "all tensors on one device"))
        checks.append((t.is_contiguous(), "tensors must be contiguous"))
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"splat_color: {msg}")
    win = torch.zeros((p,), dtype=torch.int64, device=active_idx.device)
    ptr = _build.ptr
    args = (ptr(view), ptr(state.block_key), ptr(active_idx),
            ptr(row_mask), ptr(state.sdf), ptr(state.weight),
            ptr(state.color), ptr(zbuf), ptr(win), active_idx.shape[0],
            cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy,
            cam.depth_min, cam.depth_max, cfg.voxel_size, cfg.world_blocks,
            active_idx.device)
    return args, win


def launch_color(args) -> None:
    """Launch the color pass on prepared arguments, on the current stream
    (the only place that does; counts the launch)."""
    *kernel_args, device = args
    _build.check(_build.library("splat_zbuf").vh_splat_color(
        *kernel_args, _build.stream_ptr(device)), "splat_zbuf")
    splat_color.launches += 1


def splat_color(state: MapState, active_idx, row_mask, view,
                cam: CameraConfig, cfg: MapConfig, zbuf):
    """Packed color int32[h*w] (0 where none) of the surface-band voxel of
    the rows ``active_idx[row_mask]`` that gave ``zbuf`` (kernel B's
    z-buffer of the same rows, seen from ``view``) its depth at each
    pixel; ties go to the largest flat index."""
    if active_idx.device.type == "cpu":
        return splat_color_plain(state, active_idx, row_mask, view, cam,
                                 cfg, zbuf)
    if active_idx.device.type != "cuda":
        raise ValueError(f"splat_color: no kernel for {active_idx.device}")
    args, win = prepare_color(state, active_idx, row_mask, view, cam, cfg,
                              zbuf)
    launch_color(args)
    return win.view(torch.int32)[0::2]


splat_color.launches = 0
