"""Dense TSDF voxel grid (PyTorch port of ``voxelhashing_tpu.densegrid``):
the pre-hashing scene representation of the reference's DX11 app
(SURVEY.md §2.9).

A ``[Z, Y, X]`` volume, X minor, sampled at grid corners: voxel (ix, iy,
iz) sits at ``origin + (ix, iy, iz) * voxel_size``. Integration is
elementwise math and one depth/color image gather (no hash, no scatter),
so it serves small working volumes and, in the tests and on the card, as
an oracle for the sparse map's fusion (kernel A) that shares no code with
kernel A's plain version.

Every expression follows the JAX function in the same order, so that the
CPU gives the same bits as JAX. Two things differ:

* the trilinear sampler gathers its 8 corners straight from the flat
  arrays; JAX first builds ``[N,4]`` quad tables because a TPU gather
  costs per index, which at 256^3 is 805 MB rebuilt every render;
* :func:`extract_mesh` sizes its lists to the exact count of surface cubes
  and triangles (one host read each); JAX keeps at most 2^17 cubes and
  drops the rest.

The camera transform of :func:`integrate` is computed without a matmul
(:func:`_view`), so the card and the CPU give the same grid.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .config import CameraConfig, MeshConfig, resolve_device
from . import blockmap, geometry as geom
from .meshing import MeshChunk, _CUBE_CORNERS, _compact, emit_tet_triangles
from .raycast import RaycastResult, march_core


@dataclasses.dataclass(frozen=True)
class DenseGridConfig:
    """Grid geometry and fusion parameters (the JAX ``DenseGridConfig``)."""

    dims: Tuple[int, int, int] = (128, 128, 128)   # voxels per axis (x,y,z)
    origin: Tuple[float, float, float] = (-1.28, -1.28, 0.5)
    voxel_size: float = 0.02
    # a fixed truncation band, not the sparse map's distance-scaled one
    truncation: float = 0.1
    weight_max: float = 255.0
    # the observed color's weight in the blend (the dense app's 10x)
    color_obs_weight: float = 10.0


class DenseGrid(NamedTuple):
    """Volume state: f32 sdf, f32 weight and packed int32 color per voxel."""

    sdf: torch.Tensor     # f32[Z,Y,X]
    weight: torch.Tensor  # f32[Z,Y,X]
    color: torch.Tensor   # int32[Z,Y,X] packed 0x00RRGGBB (blockmap.pack_rgb)


def create(cfg: DenseGridConfig, device="cuda") -> DenseGrid:
    """Zeroed volume (sdf 0, weight 0) on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    nx, ny, nz = cfg.dims
    shape = (nz, ny, nx)
    return DenseGrid(
        sdf=torch.zeros(shape, dtype=torch.float32, device=device),
        weight=torch.zeros(shape, dtype=torch.float32, device=device),
        color=torch.zeros(shape, dtype=torch.int32, device=device))


def _grid_world_coords(cfg: DenseGridConfig, device):
    """World coordinates of every voxel's corner sample, broadcastable to
    [Z,Y,X]: (gx [1,1,X], gy [1,Y,1], gz [Z,1,1])."""
    nx, ny, nz = cfg.dims
    ox, oy, oz = cfg.origin
    vs = cfg.voxel_size
    f32 = torch.float32
    gx = ox + vs * torch.arange(nx, dtype=f32, device=device)[None, None, :]
    gy = oy + vs * torch.arange(ny, dtype=f32, device=device)[None, :, None]
    gz = oz + vs * torch.arange(nz, dtype=f32, device=device)[:, None, None]
    return gx, gy, gz


def set_ellipsoid(grid: DenseGrid, cfg: DenseGridConfig, center, radii,
                  color=(128, 128, 128)) -> DenseGrid:
    """Analytic truncated SDF ``|(p - center) / radii| - 1``, weight 1 and
    one packed color everywhere."""
    gx, gy, gz = _grid_world_coords(cfg, grid.sdf.device)
    cx, cy, cz = (float(np.float32(c)) for c in center)
    a, b, c = (float(np.float32(r)) for r in radii)
    px = geom.div_const(gx - cx, a)
    py = geom.div_const(gy - cy, b)
    pz = geom.div_const(gz - cz, c)
    # the f32 square root correctly rounded (through f64) on every device:
    # torch's vectorised one on the CPU is off by an ulp at some inputs
    sdf = torch.sqrt((px * px + py * py + pz * pz).double()).float() - 1.0
    sdf = torch.clamp(sdf, -cfg.truncation, cfg.truncation)
    sdf = torch.broadcast_to(sdf, grid.sdf.shape).contiguous()
    packed = (int(color[0]) << 16) | (int(color[1]) << 8) | int(color[2])
    return DenseGrid(sdf=sdf, weight=torch.ones_like(grid.weight),
                     color=torch.full_like(grid.color, packed))


def _view(pose):
    """``geometry.invert_rigid(pose)`` with the translation's dot products
    written out: ``acc = r0 t0``, then ``acc = fma(rk, tk, acc)`` for k = 1,
    2 (each fused multiply-add exact in f64, then rounded to f32). This is
    the order in which the CPU's matvec rounds (and XLA's on the CPU), and
    it rounds alike on every device; a matvec on the card may round
    otherwise."""
    r_t = pose[:3, :3].T
    t = pose[:3, 3]
    acc = r_t[:, 0] * t[0]
    for k in (1, 2):
        acc = (r_t[:, k].double() * t[k].double() + acc.double()).float()
    view = torch.eye(4, dtype=pose.dtype, device=pose.device)
    view[:3, :3] = r_t
    view[:3, 3] = -acc
    return view


def integrate(grid: DenseGrid, cfg: DenseGridConfig, depth, color, pose,
              cam: CameraConfig, in_place: bool = False) -> DenseGrid:
    """Fuse one frame into the whole volume: every voxel moves into the
    camera, projects to its nearest pixel and fuses ``sdf_obs = depth -
    z_cam`` where ``sdf_obs > -truncation`` (the free space in front of the
    surface fuses too). ``color`` [h,w,3] in [0,1] blends with 10x weight
    on the observation, or is None (colors kept).

    ``in_place``: write the result into ``grid``'s tensors and return it
    (``denseengine.make_step(donate=True)``); otherwise ``grid`` is left
    as it was.
    """
    h, w = cam.height, cam.width
    gx, gy, gz = _grid_world_coords(cfg, grid.sdf.device)
    view = _view(pose)
    r, t = view[:3, :3], view[:3, 3]
    pcx = r[0, 0] * gx + r[0, 1] * gy + r[0, 2] * gz + t[0]
    pcy = r[1, 0] * gx + r[1, 1] * gy + r[1, 2] * gz + t[1]
    pcz = r[2, 0] * gx + r[2, 1] * gy + r[2, 2] * gz + t[2]

    safe_z = torch.where(pcz == 0.0, 1e-12, pcz)
    # an out-of-range cast lands outside [0, w) on every device
    ui = torch.floor(pcx * cam.fx / safe_z + cam.cx + 0.5).to(torch.int32)
    vi = torch.floor(pcy * cam.fy / safe_z + cam.cy + 0.5).to(torch.int32)
    on = (pcz > 0.0) & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    pix = torch.where(on, vi * w + ui, 0).long()

    d_obs = depth.reshape(-1)[pix]
    valid = on & torch.isfinite(d_obs) & (d_obs > 0.0)

    sdf_obs = d_obs - pcz
    fuse = valid & (sdf_obs > -cfg.truncation)
    sdf_obs = torch.clamp(sdf_obs, -cfg.truncation, cfg.truncation)

    w_old = grid.weight
    denom = torch.clamp(w_old + 1.0, min=1.0)
    sdf_f = (grid.sdf * w_old + sdf_obs) / denom

    if color is not None:
        c_obs = torch.clamp(color.reshape(-1, 3)[pix] * 255.0, 0.0, 255.0)
        old_rgb = blockmap.unpack_rgb(grid.color)             # [Z,Y,X,3]
        k = cfg.color_obs_weight
        c_new = ((k * c_obs + w_old[..., None] * old_rgb)
                 / (k + torch.clamp(w_old, min=0.0))[..., None])
        packed = blockmap.pack_rgb(torch.where(fuse[..., None], c_new,
                                               old_rgb))
    else:
        packed = grid.color
    w_new = torch.clamp(w_old + 1.0, max=cfg.weight_max)
    if in_place:
        # the weight last: every other field reads the old one
        torch.where(fuse, sdf_f, grid.sdf, out=grid.sdf)
        if color is not None:
            grid.color.copy_(packed)
        torch.where(fuse, w_new, w_old, out=grid.weight)
        return grid
    return DenseGrid(sdf=torch.where(fuse, sdf_f, grid.sdf),
                     weight=torch.where(fuse, w_new, w_old), color=packed)


def trilinear_sample_soa(grid: DenseGrid, cfg: DenseGridConfig, px, py, pz,
                         with_color: bool = False):
    """(sdf, valid[, color in [0,1]]) at world-coordinate tensors of one
    shape; invalid where a corner lies outside the grid or has weight 0.

    The 8 corners come straight from the flat arrays, at offsets (0, 1,
    nx, nx + 1) of the cell's z = 0 and z = 1 planes, summed in the JAX
    quad order (x0y0, x1y0, x0y1, x1y1) from left to right, then blended
    by ``1 - fz`` and ``fz``."""
    nx, ny, nz = cfg.dims
    ox, oy, oz = cfg.origin
    inv = 1.0 / cfg.voxel_size
    qx = (px - ox) * inv
    qy = (py - oy) * inv
    qz = (pz - oz) * inv
    bx = torch.floor(qx).to(torch.int32)
    by = torch.floor(qy).to(torch.int32)
    bz = torch.floor(qz).to(torch.int32)
    fx, fy, fz = qx - bx, qy - by, qz - bz
    inb = ((bx >= 0) & (bx < nx - 1) & (by >= 0) & (by < ny - 1)
           & (bz >= 0) & (bz < nz - 1))
    bx = torch.clamp(bx, 0, nx - 2).long()
    by = torch.clamp(by, 0, ny - 2).long()
    bz = torch.clamp(bz, 0, nz - 2).long()
    lin0 = (bz * ny + by) * nx + bx
    lin1 = lin0 + nx * ny
    offsets = (0, 1, nx, nx + 1)

    wx0, wy0 = 1.0 - fx, 1.0 - fy
    wq = (wx0 * wy0, fx * wy0, wx0 * fy, fx * fy)

    def quad_sum(flat, lin, unpack=False):
        acc = None
        for wk, off in zip(wq, offsets):
            v = flat[lin + off]
            term = (wk[..., None] * blockmap.unpack_rgb(v) if unpack
                    else wk * v)
            acc = term if acc is None else acc + term
        return acc

    w_flat = grid.weight.reshape(-1)
    valid = inb
    for lin in (lin0, lin1):
        for off in offsets:
            valid = valid & (w_flat[lin + off] > 0.0)
    s_flat = grid.sdf.reshape(-1)
    s = quad_sum(s_flat, lin0) * (1.0 - fz) + quad_sum(s_flat, lin1) * fz
    if not with_color:
        return s, valid
    c_flat = grid.color.reshape(-1)
    col = (quad_sum(c_flat, lin0, True) * (1.0 - fz)[..., None]
           + quad_sum(c_flat, lin1, True) * fz[..., None])
    return s, valid, geom.div_const(col, 255.0)


def _ray_box_band(pose, cam: CameraConfig, cfg: DenseGridConfig):
    """Per-pixel [t_near, t_far] z-depth band in which each ray is inside
    the grid's box (a slab test), within the camera's depth range."""
    h, w = cam.height, cam.width
    u, v = geom.pixel_grid(w, h, pose.device)
    xn = geom.div_const(u - cam.cx, cam.fx).reshape(-1)
    yn = geom.div_const(v - cam.cy, cam.fy).reshape(-1)
    rot = pose[:3, :3]
    o = pose[:3, 3]
    # the box's corners in f32, as JAX computes them (host floats: a tensor
    # made from a Python list would be copied up and wait for the stream)
    lo = [np.float32(x) for x in cfg.origin]
    hi = [np.float32(lo[ax] + np.float32(np.float32(cfg.voxel_size)
                                          * np.float32(n - 1)))
          for ax, n in enumerate(cfg.dims)]
    t_near = torch.full(xn.shape, cam.depth_min, dtype=torch.float32,
                        device=pose.device)
    t_far = torch.full(xn.shape, cam.depth_max, dtype=torch.float32,
                       device=pose.device)
    for ax in range(3):
        d = rot[ax, 0] * xn + rot[ax, 1] * yn + rot[ax, 2]
        safe = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
        t1 = (float(lo[ax]) - o[ax]) / safe
        t2 = (float(hi[ax]) - o[ax]) / safe
        t_near = torch.maximum(t_near, torch.minimum(t1, t2))
        t_far = torch.minimum(t_far, torch.maximum(t1, t2))
    return t_near, torch.maximum(t_far, t_near)


def render(grid: DenseGrid, cfg: DenseGridConfig, pose, cam: CameraConfig,
           num_samples: int = 64, thres_dist: float = None
           ) -> RaycastResult:
    """Surface prediction over the dense grid: the ray-box band, then the
    port's batched march (:func:`raycast.march_core`) with a step of 0.8
    truncation, a crossing jump below 2 truncations, and hits kept within
    ``thres_dist`` (default 5 voxels) of the surface."""
    t_min, t_max = _ray_box_band(pose, cam, cfg)
    td = cfg.voxel_size * 5.0 if thres_dist is None else thres_dist

    def sample_soa(px, py, pz, with_color=False):
        return trilinear_sample_soa(grid, cfg, px, py, pz,
                                    with_color=with_color)

    return march_core(sample_soa, pose, cam, t_min, t_max,
                      num_samples=num_samples,
                      ray_inc=0.8 * cfg.truncation,
                      thres_sample_dist=2.0 * cfg.truncation,
                      thres_dist=td)


def extract_mesh(grid: DenseGrid, cfg: DenseGridConfig,
                 mesh_cfg: MeshConfig = None) -> MeshChunk:
    """Marching-tetrahedra isosurface of the whole grid. The surface cubes
    (weight > 0 and |sdf| < 2 voxels at the cube's first corner, all 8
    corners inside the grid) are compacted to their exact count, then
    emitted by :func:`meshing.emit_tet_triangles` where all 8 corners have
    weight and their sdf spans less than ``thresh_factor`` voxels."""
    nx, ny, nz = cfg.dims
    vs = cfg.voxel_size
    thresh = (mesh_cfg.thresh_factor if mesh_cfg else 10.0) * vs

    near = (grid.weight > 0.0) & (torch.abs(grid.sdf) < 2.0 * vs)
    # a cube needs all 8 corners in the grid: drop the last layer of each
    # axis
    near[-1, :, :] = False
    near[:, -1, :] = False
    near[:, :, -1] = False
    flat = near.reshape(-1)
    rank, n = _compact(flat)
    src = torch.arange(flat.shape[0], dtype=torch.int32, device=flat.device)
    slots = blockmap.put(torch.zeros((n,), dtype=torch.int32,
                                     device=flat.device), rank, src, flat)
    iz = torch.div(slots, ny * nx, rounding_mode="floor")
    iy = torch.div(slots, nx, rounding_mode="floor") % ny
    ix = slots % nx

    sdf_flat = grid.sdf.reshape(-1)
    w_flat = grid.weight.reshape(-1)
    c_flat = grid.color.reshape(-1)
    ox, oy, oz = cfg.origin
    cube_valid = torch.ones((n,), dtype=torch.bool, device=flat.device)
    sdf8, pos8, col8 = [], [], []
    for (dx, dy, dz) in _CUBE_CORNERS:
        cx, cy, cz = ix + dx, iy + dy, iz + dz
        lin = ((cz * ny + cy) * nx + cx).long()
        sdf8.append(sdf_flat[lin])
        cube_valid &= w_flat[lin] > 0.0
        pos8.append(torch.stack([ox + vs * cx.to(torch.float32),
                                 oy + vs * cy.to(torch.float32),
                                 oz + vs * cz.to(torch.float32)], dim=-1))
        col8.append(geom.div_const(blockmap.unpack_rgb(c_flat[lin]), 255.0))
    sdf8 = torch.stack(sdf8, 0)                                # [8,C]
    cube_valid &= (torch.amax(sdf8, dim=0) - torch.amin(sdf8, dim=0)) < thresh
    return emit_tet_triangles(sdf8, pos8, col8, cube_valid)

