"""Surface prediction of the reference: a frozen copy of the plain
versions of ``voxelhashing_tpu_torch.raycast`` and ``ops/splat_zbuf.py``:
the splat renderer (every surface-band voxel of the active blocks
scatter-mins its predicted depth along its pixel ray, then the hole fill
and the point, normal and color maps) and the march (per-tile depth
bounds, the batched trilinear march, three secant steps), with no kernel
and no multi-device path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .config import CameraConfig, MapConfig, RaycastConfig
from . import blockmap
from . import geometry as geom
from .blockmap import MapState
from .ops import raymarch as _march
from .ops.raymarch import MarchHits
from .ops.splat_zbuf import splat_zbuf_plain


class RaycastResult(NamedTuple):
    """The predicted model frame."""

    depth: torch.Tensor    # f32[h,w]    z-depth, NaN where no surface
    points: torch.Tensor   # f32[h,w,3]  camera-space positions, NaN invalid
    normals: torch.Tensor  # f32[h,w,3]  camera-space normals, NaN invalid
    color: torch.Tensor    # f32[h,w,3]  surface color in [0,1]
    splat_overflow: torch.Tensor  # int32[] surface blocks past the cull cap


# ---------------------------------------------------------------------------
# Trilinear TSDF sampling
# ---------------------------------------------------------------------------

_CORNER_LIST = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]


def trilinear_sample(state: MapState, p_world, cfg: MapConfig,
                     with_color: bool = False):
    """Trilinearly interpolated (sdf, valid[, color]) at world points
    [...,3]; invalid where any of the 8 corner voxels has zero weight."""
    shape = p_world.shape[:-1]
    pw = p_world.reshape(-1, 3)
    out = trilinear_sample_soa(state, pw[:, 0], pw[:, 1], pw[:, 2], cfg,
                               with_color=with_color)
    if with_color:
        s, valid, col = out
        return (s.reshape(shape), valid.reshape(shape),
                col.reshape(shape + (3,)))
    s, valid = out
    return s.reshape(shape), valid.reshape(shape)


def trilinear_sample_soa(state: MapState, px, py, pz, cfg: MapConfig,
                         with_color: bool = False):
    """SoA core of :func:`trilinear_sample`: coordinate tensors of one
    shape; the 8 corners are fetched at once on a leading axis ([8,...])
    and weighted in the JAX order."""
    vs = cfg.voxel_size
    qx, qy, qz = (geom.div_const(px, vs), geom.div_const(py, vs),
                  geom.div_const(pz, vs))
    bx = torch.floor(qx).to(torch.int32)
    by = torch.floor(qy).to(torch.int32)
    bz = torch.floor(qz).to(torch.int32)
    fx, fy, fz = qx - bx, qy - by, qz - bz

    cx = torch.stack([bx + o[0] for o in _CORNER_LIST], dim=0)
    cy = torch.stack([by + o[1] for o in _CORNER_LIST], dim=0)
    cz = torch.stack([bz + o[2] for o in _CORNER_LIST], dim=0)
    sdf, w, c = blockmap.gather_voxels_soa(state, cx, cy, cz, cfg,
                                           with_color=with_color)
    valid = torch.all(w > 0.0, dim=0)

    s = torch.zeros(fx.shape, dtype=torch.float32, device=fx.device)
    col = (torch.zeros(fx.shape + (3,), dtype=torch.float32,
                       device=fx.device) if with_color else None)
    for i, (ox, oy, oz) in enumerate(_CORNER_LIST):
        tw = ((fx if ox else 1.0 - fx) * (fy if oy else 1.0 - fy)
              * (fz if oz else 1.0 - fz))
        s = s + tw * sdf[i]
        if with_color:
            col = col + tw[..., None] * blockmap.unpack_rgb(c[i])
    if with_color:
        return s, valid, geom.div_const(col, 255.0)
    return s, valid


def sdf_gradient_samples(state: MapState, p_world, cfg: MapConfig):
    """The six central-difference samples of :func:`sdf_gradient` at world
    points [...,3]: (g [...,3] = (s(p + e) - s(p - e)) * 0.5 with e one
    voxel along each axis, unnormalized; valid where all six are)."""
    offs = cfg.voxel_size
    grads = []
    ok = None
    for ax in range(3):
        e = torch.zeros((3,), dtype=torch.float32, device=p_world.device)
        e[ax] = offs
        sp, vp = trilinear_sample(state, p_world + e, cfg)
        sm, vm = trilinear_sample(state, p_world - e, cfg)
        grads.append((sp - sm) * 0.5)
        v = vp & vm
        ok = v if ok is None else (ok & v)
    return torch.stack(grads, dim=-1), ok


def gradient_epilogue(g, ok):
    """Unit gradients from :func:`sdf_gradient_samples`: (g / |g|, NaN
    where invalid or zero; valid)."""
    n = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    good = ok & (n[..., 0] > 0.0)
    g = torch.where(good[..., None], g / torch.where(n > 0, n, 1.0),
                    torch.nan)
    return g, good


# ---------------------------------------------------------------------------
# Ray-interval tile bounds
# ---------------------------------------------------------------------------

def ray_interval_splat(state: MapState, active_idx, active_mask,
                       view_matrix, cam: CameraConfig, cfg: MapConfig,
                       rc: RaycastConfig):
    """Per-screen-tile [min,max] z-depth bounds of the active blocks:
    each block's 8 corners projected, its screen box and depth range
    scatter-min/maxed into a (tiles_y, tiles_x) grid over a span of at
    most 4x4 tiles; blocks that span more (or cross the near plane) widen
    every tile. Tiles no block touches get t_min=+inf > t_max=-inf."""
    return _march.ray_bounds_plain(state.block_key, active_idx, active_mask,
                                   view_matrix, cam, cfg, rc)


# ---------------------------------------------------------------------------
# Renderers
# ---------------------------------------------------------------------------


def render(state: MapState, pose, cam: CameraConfig, cfg: MapConfig,
           rc: RaycastConfig, active_idx=None, active_mask=None,
           with_color: bool = True) -> RaycastResult:
    """Surface prediction from ``pose``: :func:`render_splat` when
    ``rc.mode == "splat"``, else :func:`render_march` (which always
    renders color)."""
    if rc.mode == "splat":
        return render_splat(state, pose, cam, cfg, rc,
                            active_idx=active_idx, active_mask=active_mask,
                            with_color=with_color)
    return render_march(state, pose, cam, cfg, rc, active_idx=active_idx,
                        active_mask=active_mask)


def _ray_directions(pose, cam: CameraConfig):
    """Per-pixel world ray directions (z-depth 1), flat [P] each."""
    u, v = geom.pixel_grid(cam.width, cam.height, pose.device)
    xn = geom.div_const(u - cam.cx, cam.fx).reshape(-1)
    yn = geom.div_const(v - cam.cy, cam.fy).reshape(-1)
    rot = pose[:3, :3]
    return (rot[0, 0] * xn + rot[0, 1] * yn + rot[0, 2],
            rot[1, 0] * xn + rot[1, 1] * yn + rot[1, 2],
            rot[2, 0] * xn + rot[2, 1] * yn + rot[2, 2])


def render_splat(state: MapState, pose, cam: CameraConfig, cfg: MapConfig,
                 rc: RaycastConfig, active_idx=None, active_mask=None,
                 with_color: bool = True) -> RaycastResult:
    """Projective voxel splatting of the active blocks that hold surface
    voxels, hole fill, optional trilinear refinement, and the derived
    point/normal/color maps."""
    h, w = cam.height, cam.width
    view = geom.invert_rigid(pose)
    if active_idx is None:
        active_idx, n_active, _ = blockmap.compactify(state, view, cam, cfg)
        active_mask = torch.arange(active_idx.shape[0],
                                   device=active_idx.device) < n_active
    dev = active_idx.device

    # Persistent surface flags cull the rows; the JAX cull cap (half the
    # active list) only sets splat_overflow here.
    has_surf = state.surf[active_idx.long()] & active_mask
    n_surf_total = blockmap._isum(has_surf)
    overflow = n_surf_total - torch.clamp(n_surf_total,
                                          max=active_idx.shape[0] // 2)
    if with_color:
        zbuf, colbuf = splat_zbuf_plain(state, active_idx, has_surf, view,
                                        cam, cfg, with_color=True)
        color = geom.div_const(blockmap.unpack_rgb(colbuf),
                               255.0).reshape(h, w, 3)
    else:
        zbuf, _ = splat_zbuf_plain(state, active_idx, has_surf, view, cam,
                                   cfg)
        color = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    depth = torch.where(torch.isfinite(zbuf), zbuf, torch.nan).reshape(h, w)

    # --- Close-range hole fill: valid-min dilation on interior holes. ----
    for _ in range(rc.hole_fill_rounds):
        dpad = F.pad(depth, (1, 1, 1, 1), value=float("nan"))
        neigh = torch.stack([dpad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                             for dy in (-1, 0, 1) for dx in (-1, 0, 1)], 0)
        valid_n = torch.isfinite(neigh)
        masked = torch.where(valid_n, neigh, torch.inf)
        filled = torch.amin(masked, dim=0)
        n_valid = torch.sum(valid_n, dim=0, dtype=torch.int32)
        need = ~torch.isfinite(depth) & (filled < torch.inf) & (n_valid >= 6)
        depth = torch.where(need, filled, depth)
        if with_color:
            cpad = F.pad(color, (0, 0, 1, 1, 1, 1))
            nc = torch.stack([cpad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                              for dy in (-1, 0, 1) for dx in (-1, 0, 1)], 0)
            pick = torch.argmin(masked, dim=0)
            picked = torch.gather(
                nc, 0, pick[None, :, :, None].expand(1, h, w, 3))[0]
            color = torch.where(need[..., None], picked, color)

    # --- Optional trilinear refinement (one gather pass per pixel). ------
    if rc.refine_trilinear:
        dwx, dwy, dwz = _ray_directions(pose, cam)
        dflat = depth.reshape(-1)
        t0 = torch.nan_to_num(dflat, nan=0.0)
        hx = pose[0, 3] + dwx * t0
        hy = pose[1, 3] + dwy * t0
        hz = pose[2, 3] + dwz * t0
        s_res, s_ok = trilinear_sample_soa(state, hx, hy, hz, cfg)
        corr = torch.where(s_ok & torch.isfinite(dflat), s_res, 0.0)
        depth = (dflat + corr).reshape(h, w)

    # --- Derived maps. ---------------------------------------------------
    u, v = geom.pixel_grid(w, h, dev)
    finite = torch.isfinite(depth)
    pts = geom.screen_to_camera(u, v, depth, cam)
    pts = torch.where(finite[..., None], pts, torch.nan)
    normals = geom.normals_from_points(pts)
    color = torch.where(finite[..., None], color, 0.0)
    return RaycastResult(depth=depth, points=pts, normals=normals,
                         color=color, splat_overflow=overflow)


def render_march(state: MapState, pose, cam: CameraConfig, cfg: MapConfig,
                 rc: RaycastConfig, active_idx=None, active_mask=None
                 ) -> RaycastResult:
    """Reference-style raycast: each ray bounded by its tile's depth range
    (:func:`ray_interval_splat`, widened by the truncation) when
    ``rc.splat_enabled`` and an active list is given, else by the camera's
    depth range, then the batched march (``ops/raymarch.march_plain``) and
    :func:`march_epilogue`."""
    bounds = None
    if rc.splat_enabled and active_idx is not None:
        view = geom.invert_rigid(pose)
        bounds = ray_interval_splat(state, active_idx, active_mask, view,
                                    cam, cfg, rc)
    return march_epilogue(_march.march_plain(state, pose, cam, cfg, rc,
                                             bounds), pose, cam)


def march_hits(sample_soa, pose, cam: CameraConfig, t_min, t_max,
               num_samples: int, ray_inc, thres_sample_dist, thres_dist,
               gradient_fn=None) -> MarchHits:
    """Batched ray march: every ray evaluates ``num_samples`` samples at
    once ([S,P], P minor) between ``t_min`` and ``t_max`` (z-depth, [P]),
    takes its first + to - crossing, refines it with three secant steps
    and keeps it where the interpolated |sdf| is below ``thres_dist``.
    Rays with no kept hit hold NaN t_hit, points and gradients and 0
    colors."""
    dwx, dwy, dwz = _ray_directions(pose, cam)
    ox_, oy_, oz_ = pose[0, 3], pose[1, 3], pose[2, 3]

    s_n = num_samples
    band = torch.clamp(t_max - t_min, min=0.0)
    dt = torch.clamp(geom.div_const(band, s_n - 1), min=ray_inc)   # [P]
    si = torch.arange(s_n, dtype=torch.float32, device=pose.device)[:, None]
    ts = t_min[None, :] + si * dt[None, :]                         # [S,P]
    in_band = ts <= (t_max[None, :] + dt[None, :])                 # one past

    sdf_s, ok_s = sample_soa(ox_ + dwx[None, :] * ts,
                             oy_ + dwy[None, :] * ts,
                             oz_ + dwz[None, :] * ts)              # [S,P]
    ok_s = ok_s & in_band

    cross = (ok_s[:-1] & ok_s[1:]
             & (sdf_s[:-1] > 0.0) & (sdf_s[1:] < 0.0)
             & (sdf_s[:-1] - sdf_s[1:] < thres_sample_dist))       # [S-1,P]
    found = torch.any(cross, dim=0)
    # argmax over int8 returns the first maximum: the first crossing
    first = torch.argmax(cross.to(torch.int8), dim=0)[None, :]
    b_t0 = torch.gather(ts, 0, first)[0]
    b_t1 = b_t0 + dt
    b_s0 = torch.gather(sdf_s, 0, first)[0]
    b_s1 = torch.gather(sdf_s, 0, first + 1)[0]

    # secant/bisection refinement, three steps
    for _ in range(3):
        denom = b_s0 - b_s1
        alpha = torch.where(torch.abs(denom) > 1e-12, b_s0 / denom, 0.5)
        tm = b_t0 + alpha * (b_t1 - b_t0)
        sm, ok = sample_soa(ox_ + dwx * tm, oy_ + dwy * tm, oz_ + dwz * tm)
        neg = ok & (sm < 0.0)
        pos = ok & (sm >= 0.0)
        b_t1 = torch.where(neg, tm, b_t1)
        b_s1 = torch.where(neg, sm, b_s1)
        b_t0 = torch.where(pos, tm, b_t0)
        b_s0 = torch.where(pos, sm, b_s0)
    denom = b_s0 - b_s1
    alpha = torch.where(torch.abs(denom) > 1e-12, b_s0 / denom, 0.5)
    t_hit = b_t0 + alpha * (b_t1 - b_t0)

    hx, hy, hz = ox_ + dwx * t_hit, oy_ + dwy * t_hit, oz_ + dwz * t_hit
    s_hit, ok_hit, col = sample_soa(hx, hy, hz, with_color=True)
    found = found & ok_hit & (torch.abs(s_hit) < thres_dist)

    t_hit = torch.where(found, t_hit, torch.nan)
    p_hit = torch.where(found[:, None], torch.stack([hx, hy, hz], dim=-1),
                        torch.nan)
    col = torch.where(found[:, None], col, 0.0)
    g = g_ok = None
    if gradient_fn is not None:
        g, g_ok = gradient_fn(p_hit)
        g = torch.where(found[:, None], g, torch.nan)
        g_ok = g_ok & found
    return MarchHits(t_hit=t_hit, found=found, p_hit=p_hit, color=col,
                     grad=g, grad_ok=g_ok)


def march_epilogue(hits: MarchHits, pose, cam: CameraConfig
                   ) -> RaycastResult:
    """The march's hits ([P] per ray) as the predicted frame: the depth map, camera-space points,
    colors and normals (from the points, or from the gradients when the
    hits carry them)."""
    h, w = cam.height, cam.width
    view = geom.invert_rigid(pose)
    found = hits.found
    depth = torch.where(found, hits.t_hit, torch.nan).reshape(h, w)
    finite = torch.isfinite(depth)
    p_cam = geom.transform_points(view, hits.p_hit).reshape(h, w, 3)
    p_cam = torch.where(finite[..., None], p_cam, torch.nan)
    color = torch.where(found[:, None], hits.color, 0.0).reshape(h, w, 3)

    if hits.grad is not None:
        g, gok = gradient_epilogue(hits.grad, hits.grad_ok)
        n_world = torch.where((found & gok)[:, None], g, torch.nan)
        normals = (n_world @ view[:3, :3].T).reshape(h, w, 3)
    else:
        normals = geom.normals_from_points(p_cam)
    return RaycastResult(depth=depth, points=p_cam, normals=normals,
                         color=color,
                         splat_overflow=torch.zeros((), dtype=torch.int32,
                                                    device=pose.device))
