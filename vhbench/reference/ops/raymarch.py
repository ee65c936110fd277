"""The march renderer's tile bounds and batched march of the reference: a
frozen copy of the plain versions of
voxelhashing_tpu_torch/ops/raymarch.py (ray_bounds_plain,
march_plain).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import geometry as geom
from ..config import CameraConfig, MapConfig, RaycastConfig

SPAN = 4                  # tiles a block may span per axis, else it widens all
NEAR_Z = 1e-3             # a block's z min must pass it to be scattered


class MarchHits(NamedTuple):
    """What a march finds along each ray (flat [P], row-major pixels),
    before ``raycast.march_epilogue``. Rays with no kept hit hold NaN
    ``t_hit``, ``p_hit`` and ``grad``, 0 ``color`` and False ``grad_ok``."""

    t_hit: torch.Tensor              # f32[P]   z-depth of the hit
    found: torch.Tensor              # bool[P]
    p_hit: torch.Tensor              # f32[P,3] world position of the hit
    color: torch.Tensor              # f32[P,3] in [0, 1]
    grad: Optional[torch.Tensor]     # f32[P,3] (s(p+e) - s(p-e)) * 0.5
    grad_ok: Optional[torch.Tensor]  # bool[P]


def tiles(cam: CameraConfig, rc: RaycastConfig):
    """(tiles_y, tiles_x) of the bounds grid."""
    tile = rc.splat_tile
    return -(-cam.height // tile), -(-cam.width // tile)


class RowBounds(NamedTuple):
    """Each active row's part in the tile bounds ([M] each)."""

    z_min: torch.Tensor      # f32, the block's corners' z range
    z_max: torch.Tensor
    t0x: torch.Tensor        # int32, its tile box (clamped to the grid)
    t1x: torch.Tensor
    t0y: torch.Tensor
    t1y: torch.Tensor
    scatter: torch.Tensor    # bool, scattered into its box
    overflow: torch.Tensor   # bool, widens every tile instead


def row_bounds(block_key, active_idx, active_mask, view_matrix,
               cam: CameraConfig, cfg: MapConfig, rc: RaycastConfig):
    """The per-row half of :func:`ray_bounds_plain`: each active block's 8
    corners projected, its z range and screen box, the tiles it spans and
    whether it scatters into them or overflows."""
    tile = rc.splat_tile
    ty, tx = tiles(cam, rc)
    dev = active_idx.device

    blocks = geom.unpack_block_key(block_key[active_idx.long()],
                                   cfg.world_blocks)                 # [M,3]
    corner0 = geom.block_to_world(blocks, cfg.voxel_size)
    # the 8 corner offsets in _CORNER_LIST order, made on the device (a
    # host list copied up would wait for the stream)
    k = torch.arange(8, device=dev)
    offs = torch.stack([k & 1, (k >> 1) & 1, (k >> 2) & 1], dim=-1)
    corners = corner0[:, None, :] + cfg.block_size_world * offs.to(
        torch.float32)
    p_cam = geom.transform_points(view_matrix, corners)              # [M,8,3]

    z = p_cam[..., 2]
    z_min = torch.amin(z, dim=-1)
    z_max = torch.amax(z, dim=-1)
    near_ok = z_min > NEAR_Z

    uv = geom.camera_to_screen(p_cam, cam)                           # [M,8,2]
    u_min = torch.floor(torch.amin(uv[..., 0], dim=-1)).to(torch.int32)
    u_max = torch.floor(torch.amax(uv[..., 0], dim=-1)).to(torch.int32)
    v_min = torch.floor(torch.amin(uv[..., 1], dim=-1)).to(torch.int32)
    v_max = torch.floor(torch.amax(uv[..., 1], dim=-1)).to(torch.int32)

    def tile_of(x, n):
        return torch.clamp(torch.div(x, tile, rounding_mode="floor"), 0,
                           n - 1)

    t0x, t1x = tile_of(u_min, tx), tile_of(u_max, tx)
    t0y, t1y = tile_of(v_min, ty), tile_of(v_max, ty)
    on_screen = ((u_max >= 0) & (u_min < cam.width)
                 & (v_max >= 0) & (v_min < cam.height))

    fits = (t1x - t0x < SPAN) & (t1y - t0y < SPAN)
    return RowBounds(z_min, z_max, t0x, t1x, t0y, t1y,
                     active_mask & near_ok & on_screen & fits,
                     active_mask & on_screen & ~(near_ok & fits))


def ray_bounds_plain(block_key, active_idx, active_mask, view_matrix,
                     cam: CameraConfig, cfg: MapConfig, rc: RaycastConfig):
    """Per-screen-tile [min,max] z-depth bounds of the active blocks
    : each block's 8
    corners projected, its screen box and depth range scatter-min/maxed
    into a (tiles_y, tiles_x) grid over a span of at most 4x4 tiles;
    blocks that span more (or cross the near plane) widen every tile.
    Tiles no block touches get t_min=+inf > t_max=-inf."""
    ty, tx = tiles(cam, rc)
    dev = active_idx.device
    r = row_bounds(block_key, active_idx, active_mask, view_matrix, cam,
                   cfg, rc)
    any_overflow = torch.any(r.overflow)
    g_min = torch.amin(torch.where(
        r.overflow, torch.clamp(r.z_min, min=cam.depth_min), torch.inf))
    g_max = torch.amax(torch.where(r.overflow, r.z_max, -torch.inf))

    n = ty * tx
    t_min = torch.full((n + 1,), torch.inf, dtype=torch.float32, device=dev)
    t_max = torch.full((n + 1,), -torch.inf, dtype=torch.float32, device=dev)
    for dy in range(SPAN):
        for dx in range(SPAN):
            iy = r.t0y + dy
            ix = r.t0x + dx
            ok = r.scatter & (iy <= r.t1y) & (ix <= r.t1x)
            lin = torch.where(ok, iy * tx + ix, n).long()   # n = dropped
            t_min.scatter_reduce_(0, lin, r.z_min, "amin", include_self=True)
            t_max.scatter_reduce_(0, lin, r.z_max, "amax", include_self=True)
    t_min = t_min[:n].reshape(ty, tx)
    t_max = t_max[:n].reshape(ty, tx)
    t_min = torch.where(any_overflow, torch.minimum(t_min, g_min), t_min)
    t_max = torch.where(any_overflow, torch.maximum(t_max, g_max), t_max)
    return t_min, t_max


def ray_interval(bounds, device, cam: CameraConfig, cfg: MapConfig,
                 rc: RaycastConfig):
    """Each ray's [t_min, t_max] (flat [P]): its tile's bounds less and
    plus the truncation, clamped to the camera's depth range, or (no
    ``bounds``) the camera's range."""
    h, w = cam.height, cam.width
    if bounds is None:
        return (torch.full((h * w,), cam.depth_min, dtype=torch.float32,
                           device=device),
                torch.full((h * w,), cam.depth_max, dtype=torch.float32,
                           device=device))
    tmin_t, tmax_t = bounds
    tile = rc.splat_tile
    iy = torch.div(torch.arange(h, device=device), tile,
                   rounding_mode="floor")
    ix = torch.div(torch.arange(w, device=device), tile,
                   rounding_mode="floor")
    t_min = torch.clamp(tmin_t[iy[:, None], ix[None, :]]
                        - cfg.truncation, min=cam.depth_min).reshape(-1)
    t_max = torch.clamp(tmax_t[iy[:, None], ix[None, :]]
                        + cfg.truncation, max=cam.depth_max).reshape(-1)
    return t_min, t_max


def march_plain(state, pose, cam: CameraConfig, cfg: MapConfig,
                rc: RaycastConfig, bounds=None) -> MarchHits:
    """The march: the batched ``raycast.march_hits`` (all
    ``rc.num_samples`` samples of every ray in one pass) with the map's
    hash sampler, each ray in its interval (:func:`ray_interval` of
    ``bounds``, the tile grids of :func:`ray_bounds_plain`, or the camera's
    range); with ``rc.use_gradients`` the raw gradient samples at the
    hits."""
    from .. import raycast
    t_min, t_max = ray_interval(bounds, pose.device, cam, cfg, rc)

    def sample_soa(px, py, pz, with_color=False):
        return raycast.trilinear_sample_soa(state, px, py, pz, cfg,
                                            with_color=with_color)

    gradient_fn = None
    if rc.use_gradients:
        def gradient_fn(p_world):
            return raycast.sdf_gradient_samples(state, p_world, cfg)

    d = rc.derived(cfg)
    return raycast.march_hits(sample_soa, pose, cam, t_min, t_max,
                              num_samples=rc.num_samples,
                              ray_inc=d["ray_increment"],
                              thres_sample_dist=d["thres_sample_dist"],
                              thres_dist=d["thres_dist"],
                              gradient_fn=gradient_fn)
