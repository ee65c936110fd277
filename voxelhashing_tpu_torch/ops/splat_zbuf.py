"""Kernel B: the splat z-buffer (``csrc/splat_zbuf.cu``).

Replaces the TPU Pallas kernel ``voxelhashing_tpu/ops/pallas_splat.py``
(``pl.pallas_call`` at :188, reached through ``splat_zbuf_pallas``).

:func:`splat_zbuf` launches the CUDA kernel for CUDA tensors and runs the
plain PyTorch version (:func:`splat_zbuf_plain`, the XLA
``raycast._splat_zbuf`` of the JAX package) for CPU tensors; any other
device raises. There is no fallback from the kernel to the plain version.

On a CUDA tensor the wrapper fills the z-buffer with +inf and checks what
the kernel assumes (:func:`prepare`); :func:`launch` issues the kernel
alone. Its least time on the card is the larger of :func:`bytes_moved`
over the memory rate and :func:`operations` over the f32 rate; see the
source.
"""

from __future__ import annotations

import torch

from ..config import CameraConfig, MapConfig, VOXELS_PER_BLOCK
from .. import blockmap, geometry as geom
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


def splat_zbuf_plain(state: MapState, active_idx, row_mask, view,
                     cam: CameraConfig, cfg: MapConfig,
                     with_color: bool = False):
    """Project the surface-band voxels of the rows ``active_idx[row_mask]``
    and scatter-min their predicted surface depths into a flat z-buffer:
    the plain PyTorch version of the kernel, and the color renderer (the
    mask is resolved on the host, one sync on CUDA).

    Returns (zbuf f32[h*w] (+inf = empty), colbuf int32[h*w]) (colbuf all
    zero unless ``with_color``).
    """
    p = cam.height * cam.width
    dev = active_idx.device
    sel, pix, z_surf, ok = splat_targets(state, active_idx, row_mask, view,
                                         cam, cfg)
    zbuf = torch.full((p + 1,), torch.inf, dtype=torch.float32, device=dev)
    zbuf.scatter_reduce_(0, pix.reshape(-1), z_surf.reshape(-1), "amin",
                         include_self=True)
    zbuf = zbuf[:p]
    colbuf = torch.zeros((p,), dtype=torch.int32, device=dev)
    if with_color:
        zhit = ok & (zbuf[torch.clamp(pix, 0, p - 1)] == z_surf)
        colbuf = blockmap.put(colbuf, pix, state.color[sel], zhit)
    return zbuf, colbuf


def splat_targets(state: MapState, active_idx, row_mask, view,
                  cam: CameraConfig, cfg: MapConfig):
    """Where each voxel of the rows ``active_idx[row_mask]`` lands: (pool
    rows int64[R], pixel int64[R,512] (h*w where the voxel is dropped),
    z_surf f32[R,512], kept bool[R,512])."""
    h, w = cam.height, cam.width
    p = h * w
    vs = cfg.voxel_size
    sel = active_idx.long()[row_mask]
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
    return sel, pix, z_surf, ok


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
