"""The splat renderer's z-buffer of the reference: a frozen copy of the
plain version of voxelhashing_tpu_torch/ops/splat_zbuf.py (every
surface-band voxel of the surface rows projected along its pixel ray, its
predicted depth scatter-min'ed, and for a color render the winning
voxel's color).
"""

from __future__ import annotations

import torch

from ..config import CameraConfig, MapConfig, VOXELS_PER_BLOCK
from .. import geometry as geom
from ..blockmap import MapState

# the color walk's key at a pixel no voxel hit: +inf, no flat index


# f32 operations, counted on the plain version (splat_targets) with adds,
# multiplies, divisions, floor, abs and compares one each: every voxel of a
# surface row takes the band test (3); a voxel in the band is placed (3),
# moved into the camera (18), projected (12: z_surf and two pixel
# coordinates) and tested against the screen and the depth range (3)


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
