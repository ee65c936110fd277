"""The allocator's candidate keys of the reference: a frozen copy of the
plain version of voxelhashing_tpu_torch/ops/alloc_candidates.py (a
3D-DDA through block space over each ray's truncation band, the
neighbour-shift dedup and the per-column rank fold).
"""

from __future__ import annotations

import torch

from .. import geometry as geom
from ..config import CameraConfig, MapConfig, SDF_BLOCK_SIZE
from ..geometry import INVALID_KEY


def _dda_band_keys(d, valid, xn, yn, pose, cfg: MapConfig):
    """Keys [alloc_steps, P] of the blocks the band [d-t, d+t] along each
    ray (xn, yn, 1) crosses; reference tie order x, z, y. Invalid entries
    are INVALID_KEY."""
    maxd = cfg.max_integration_distance
    valid = valid & torch.isfinite(d) & (d > 0.0) & (d < maxd)
    d = torch.where(valid, d, 1.0)

    t = cfg.truncation_at(d)
    min_d = torch.clamp(d - t, max=maxd)
    max_d = torch.clamp(d + t, max=maxd)
    valid = valid & (min_d < max_d)

    r, tr = pose[:3, :3], pose[:3, 3]

    def to_world(depth_along):
        cx_, cy_, cz_ = xn * depth_along, yn * depth_along, depth_along
        return (r[0, 0] * cx_ + r[0, 1] * cy_ + r[0, 2] * cz_ + tr[0],
                r[1, 0] * cx_ + r[1, 1] * cy_ + r[1, 2] * cz_ + tr[1],
                r[2, 0] * cx_ + r[2, 1] * cy_ + r[2, 2] * cz_ + tr[2])

    ox, oy, oz = to_world(min_d)
    ex, ey, ez = to_world(max_d)
    dx, dy, dz = ex - ox, ey - oy, ez - oz
    rl = torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-12)
    dx, dy, dz = dx / rl, dy / rl, dz / rl

    block_world = cfg.block_size_world
    vs = cfg.voxel_size

    def block_of(p):
        q = geom.div_const(p, vs)
        return torch.div((q + torch.sign(q) * 0.5).to(torch.int32),
                         SDF_BLOCK_SIZE, rounding_mode="floor")

    def axis_setup(c, e, o, dirc):
        step = torch.sign(dirc).to(torch.int32)
        boundary = (c + torch.clamp(step, 0, 1)).to(torch.float32) \
            * block_world - 0.5 * vs
        safe = torch.where(dirc == 0.0, 1e-12, dirc)
        t_max = (boundary - o) / safe
        t_delta = (step.to(torch.float32) * block_world) / safe
        degen = (dirc == 0.0) | (boundary - o == 0.0)
        return (step, torch.where(degen, torch.inf, t_max),
                torch.where(degen, torch.inf, t_delta), e + step)

    cx_, cy_, cz_ = block_of(ox), block_of(oy), block_of(oz)
    sx, tmx, tdx, bx = axis_setup(cx_, block_of(ex), ox, dx)
    sy, tmy, tdy, by = axis_setup(cy_, block_of(ey), oy, dy)
    sz, tmz, tdz, bz = axis_setup(cz_, block_of(ez), oz, dz)

    half = cfg.world_blocks // 2
    wb = cfg.world_blocks
    alive = valid
    keys = []
    for _ in range(cfg.alloc_steps):
        gx, gy, gz = cx_ + half, cy_ + half, cz_ + half
        ok = alive & (gx >= 0) & (gx < wb) & (gy >= 0) & (gy < wb) \
            & (gz >= 0) & (gz < wb)
        keys.append(torch.where(ok, (gz * wb + gy) * wb + gx, INVALID_KEY))
        takex = (tmx < tmy) & (tmx < tmz)
        takez = ~takex & (tmz < tmy)
        takey = ~takex & ~takez
        cx_ = cx_ + torch.where(takex, sx, 0)
        cy_ = cy_ + torch.where(takey, sy, 0)
        cz_ = cz_ + torch.where(takez, sz, 0)
        hit_bound = (takex & (cx_ == bx)) | (takey & (cy_ == by)) \
            | (takez & (cz_ == bz))
        tmx = torch.where(takex, tmx + tdx, tmx)
        tmy = torch.where(takey, tmy + tdy, tmy)
        tmz = torch.where(takez, tmz + tdz, tmz)
        alive = alive & ~hit_bound
    return torch.stack(keys).to(torch.int32)


def _dedup_and_fold(k3, fold: int):
    """West/north neighbour-shift dedup over the [S, h, w] key grid, then
    per-column rank-fold into the first ``fold`` step slots. Returns flat
    int32[fold * h * w] (or [S * h * w] when no fold applies)."""
    s, h, w = k3.shape
    west = torch.cat([torch.full((s, h, 1), INVALID_KEY, dtype=k3.dtype,
                                 device=k3.device), k3[:, :, :-1]], dim=2)
    north = torch.cat([torch.full((s, 1, w), INVALID_KEY, dtype=k3.dtype,
                                  device=k3.device), k3[:, :-1, :]], dim=1)
    dup = ((k3 == west) | (k3 == north)) & (k3 != INVALID_KEY)
    k3 = torch.where(dup, INVALID_KEY, k3)
    if fold < s:
        k2 = k3.reshape(s, h * w)
        vmask = k2 != INVALID_KEY
        rank = torch.cumsum(vmask, 0, dtype=torch.int32) - 1
        out = [torch.amin(torch.where(vmask & (rank == j), k2, INVALID_KEY),
                          dim=0) for j in range(fold)]
        return torch.stack(out).reshape(-1)
    return k3.reshape(-1)


def _tile_rays(depth, cam: CameraConfig, cfg: MapConfig, tile: int,
               phase=None, model_depth=None):
    """Tile mode's two rays a tile: (dmin, dmax, any_v, xn, yn) [ht * wt],
    the band depths over the rotated pooling grid (``phase``) after the
    novelty mask (``model_depth``) and the tile centres' directions."""
    h, w = depth.shape
    dev = depth.device
    ht, wt = h // tile, w // tile
    pv = torch.isfinite(depth) & (depth > 0.0) \
        & (depth < cfg.max_integration_distance)
    if model_depth is not None:
        agree = (torch.isfinite(model_depth)
                 & (torch.abs(depth - model_depth)
                    < 0.5 * cfg.truncation_at(depth)))
        pv = pv & ~agree
    lo = torch.where(pv, depth, torch.inf)
    hi = torch.where(pv, depth, -torch.inf)
    py = px = 0
    if isinstance(phase, torch.Tensor):
        p = phase.to(torch.int64)
        py = torch.remainder(p, tile)
        px = torch.remainder(torch.div(p, tile, rounding_mode="floor"),
                             tile)
        rows = torch.arange(h, device=dev)
        cols = torch.arange(w, device=dev)
        # torch.roll by (-py, -px) as a gather
        ridx = torch.remainder(rows + py, h)
        cidx = torch.remainder(cols + px, w)
        lo = lo[ridx][:, cidx]
        hi = hi[ridx][:, cidx]
        wrap = (rows[:, None] >= h - py) | (cols[None, :] >= w - px)
        lo = torch.where(wrap, torch.inf, lo)
        hi = torch.where(wrap, -torch.inf, hi)
        px, py = px.to(torch.float32), py.to(torch.float32)
    elif phase is not None:
        py = int(phase) % tile
        px = (int(phase) // tile) % tile
        lo = torch.roll(lo, shifts=(-py, -px), dims=(0, 1))
        hi = torch.roll(hi, shifts=(-py, -px), dims=(0, 1))
        rows = torch.arange(h, device=dev)[:, None]
        cols = torch.arange(w, device=dev)[None, :]
        wrap = (rows >= h - py) | (cols >= w - px)
        lo = torch.where(wrap, torch.inf, lo)
        hi = torch.where(wrap, -torch.inf, hi)
        px, py = float(px), float(py)
    for sl in (lambda a, o: a[:, o::tile], lambda a, o: a[o::tile, :]):
        lo = torch.amin(torch.stack([sl(lo, o) for o in range(tile)]), 0)
        hi = torch.amax(torch.stack([sl(hi, o) for o in range(tile)]), 0)
    dmin = lo.reshape(-1)
    dmax = hi.reshape(-1)
    any_v = torch.isfinite(dmin)
    dmin = torch.where(any_v, dmin, 1.0)
    dmax = torch.where(any_v, dmax, 1.0)
    uc = (torch.arange(wt, dtype=torch.float32, device=dev) + 0.5) \
        * tile - 0.5 + px
    vc = (torch.arange(ht, dtype=torch.float32, device=dev) + 0.5) \
        * tile - 0.5 + py
    u = uc[None, :].expand(ht, wt).reshape(-1)
    v = vc[:, None].expand(ht, wt).reshape(-1)
    xn = geom.div_const(u - cam.cx, cam.fx)
    yn = geom.div_const(v - cam.cy, cam.fy)
    return dmin, dmax, any_v, xn, yn


def alloc_candidates_plain(depth, pose, cam: CameraConfig, cfg: MapConfig,
                           tile: int = 1, phase=None, model_depth=None):
    """Block keys touched by the truncation bands of a depth frame.

    ``tile=1``: one DDA ray per pixel (exact, offline replay). ``tile>1``:
    two rays (min- and max-depth band) per ``tile x tile`` tile, the grid
    origin rotated by ``phase`` (the frame counter: a host int, or a device
    int32 scalar, which gives the same keys with no host read: the roll is
    then a gather and the offset an f32 add of the same small integer).
    ``model_depth``: drop pixels whose depth agrees with the model within
    half a truncation (novelty-driven online allocation).
    Returns flat int32 keys; invalid entries are INVALID_KEY.
    """
    h, w = depth.shape
    dev = depth.device
    if tile > 1 and h % tile == 0 and w % tile == 0:
        ht, wt = h // tile, w // tile
        dmin, dmax, any_v, xn, yn = _tile_rays(depth, cam, cfg, tile,
                                               phase, model_depth)
        s = cfg.alloc_steps
        ka3 = _dda_band_keys(dmin, any_v, xn, yn, pose,
                             cfg).reshape(s, ht, wt)
        kb3 = _dda_band_keys(dmax, any_v, xn, yn, pose,
                             cfg).reshape(s, ht, wt)
        dup = kb3 == ka3
        dup |= kb3 == torch.cat([ka3[1:], ka3[:1]], dim=0)
        dup |= kb3 == torch.cat([ka3[-1:], ka3[:-1]], dim=0)
        kb3 = torch.where(dup & (kb3 != INVALID_KEY), INVALID_KEY, kb3)
        k3 = torch.cat([ka3, kb3], dim=0)
        return _dedup_and_fold(k3, min(cfg.alloc_fold_tile, 2 * s))

    d = depth.reshape(-1)
    valid = torch.ones(d.shape, dtype=torch.bool, device=dev)
    u, v = geom.pixel_grid(w, h, dev)
    xn = geom.div_const(u.reshape(-1) - cam.cx, cam.fx)
    yn = geom.div_const(v.reshape(-1) - cam.cy, cam.fy)
    keys = _dda_band_keys(d, valid, xn, yn, pose, cfg)
    k3 = keys.reshape(cfg.alloc_steps, h, w)
    return _dedup_and_fold(k3, min(cfg.alloc_fold, cfg.alloc_steps))
