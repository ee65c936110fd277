"""Coordinate transforms, camera model, and SE(3) utilities of the
reference: a frozen copy of ``voxelhashing_tpu_torch.geometry``; the same conventions (camera x right,
y down, z forward; ``pose`` is camera-to-world; voxel coordinates round
symmetrically around 0; block coordinates floor-divide by 8, also for
negative coordinates).

Every function takes and returns tensors on the caller's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import SDF_BLOCK_SIZE, VOXELS_PER_BLOCK, CameraConfig

INVALID_KEY = 0x7FFFFFFF


def div_const(x, c: float):
    """``x / c`` as a true f32 division on every device.

    CUDA turns division by a Python scalar into a multiply by its
    reciprocal (one ulp off); dividing by a 0-dim tensor on the same device
    keeps the IEEE division that the CPU and XLA perform.
    """
    return x / x.new_full((), c)


# ---------------------------------------------------------------------------
# Voxel / block coordinate transforms
# ---------------------------------------------------------------------------


def block_to_voxel(block):
    return block * SDF_BLOCK_SIZE


def voxel_to_world(voxel, voxel_size):
    return voxel.to(torch.float32) * voxel_size


def block_to_world(block, voxel_size):
    return voxel_to_world(block_to_voxel(block), voxel_size)


def delinearize_voxel_index(idx):
    """Linear index in [0,512) -> local (x,y,z) in [0,8)^3, x fastest."""
    x = idx % SDF_BLOCK_SIZE
    y = torch.div(idx, SDF_BLOCK_SIZE, rounding_mode="floor") % SDF_BLOCK_SIZE
    z = torch.div(idx, SDF_BLOCK_SIZE * SDF_BLOCK_SIZE, rounding_mode="floor")
    return torch.stack([x, y, z], dim=-1)


def voxel_camera_positions(keys, view, world_blocks: int, voxel_size):
    """Camera-space positions (px, py, pz), each f32[M,512], of the voxels
    (x fastest) of the blocks with keys ``keys`` [M] under the world-to-
    camera ``view``. The kernels compute the same in the same operation
    order (``csrc/common.cuh``), so the two round alike."""
    base = block_to_voxel(unpack_block_key(keys, world_blocks))     # [M,3]
    off = delinearize_voxel_index(torch.arange(
        VOXELS_PER_BLOCK, dtype=torch.int32, device=keys.device))   # [512,3]
    wx = (base[:, 0:1] + off[None, :, 0]).to(torch.float32) * voxel_size
    wy = (base[:, 1:2] + off[None, :, 1]).to(torch.float32) * voxel_size
    wz = (base[:, 2:3] + off[None, :, 2]).to(torch.float32) * voxel_size
    r, t = view[:3, :3], view[:3, 3]
    return (r[0, 0] * wx + r[0, 1] * wy + r[0, 2] * wz + t[0],
            r[1, 0] * wx + r[1, 1] * wy + r[1, 2] * wz + t[1],
            r[2, 0] * wx + r[2, 1] * wy + r[2, 2] * wz + t[2])


# ---------------------------------------------------------------------------
# Block keys: pack block coords into one int32
# ---------------------------------------------------------------------------


def pack_block_key(block, world_blocks: int):
    """Block coords [...,3] int32 -> key [...] int32; out of extent ->
    INVALID_KEY."""
    half = world_blocks // 2
    shifted = block + half
    in_range = torch.all((shifted >= 0) & (shifted < world_blocks), dim=-1)
    key = (shifted[..., 2] * world_blocks + shifted[..., 1]) * world_blocks \
        + shifted[..., 0]
    return torch.where(in_range, key, INVALID_KEY).to(torch.int32)


def unpack_block_key(key, world_blocks: int):
    """Inverse of :func:`pack_block_key` (valid keys only)."""
    half = world_blocks // 2
    x = torch.remainder(key, world_blocks)
    y = torch.remainder(torch.div(key, world_blocks, rounding_mode="floor"),
                        world_blocks)
    z = torch.div(key, world_blocks * world_blocks, rounding_mode="floor")
    return torch.stack([x, y, z], dim=-1) - half


# ---------------------------------------------------------------------------
# Pinhole camera
# ---------------------------------------------------------------------------


def camera_to_screen(pos, cam: CameraConfig):
    z = pos[..., 2]
    u = pos[..., 0] * cam.fx / z + cam.cx
    v = pos[..., 1] * cam.fy / z + cam.cy
    return torch.stack([u, v], dim=-1)


def screen_to_camera(u, v, depth, cam: CameraConfig):
    x = div_const(u - cam.cx, cam.fx)
    y = div_const(v - cam.cy, cam.fy)
    return torch.stack([depth * x, depth * y, depth], dim=-1)


def depth_to_zero_one(z, cam: CameraConfig):
    return div_const(z - cam.depth_min, cam.depth_max - cam.depth_min)


def camera_to_ndc(pos, cam: CameraConfig):
    uv = camera_to_screen(pos, cam)
    x = div_const(2.0 * uv[..., 0] - (cam.width - 1.0), cam.width - 1.0)
    y = div_const((cam.height - 1.0) - 2.0 * uv[..., 1], cam.height - 1.0)
    z = depth_to_zero_one(pos[..., 2], cam)
    return torch.stack([x, y, z], dim=-1)


def in_frustum_approx(world_pos, view_matrix, cam: CameraConfig,
                      shrink: float = 0.95):
    p_cam = transform_points(view_matrix, world_pos)
    ndc = camera_to_ndc(p_cam, cam) * shrink
    return ((ndc[..., 0] >= -1.0) & (ndc[..., 0] <= 1.0)
            & (ndc[..., 1] >= -1.0) & (ndc[..., 1] <= 1.0)
            & (ndc[..., 2] >= 0.0) & (ndc[..., 2] <= 1.0))


def block_in_frustum(block, view_matrix, cam: CameraConfig, voxel_size):
    """Frustum test at the block centre: corner + 0.5*voxel*(8-1)."""
    centre = block_to_world(block, voxel_size) \
        + 0.5 * voxel_size * (SDF_BLOCK_SIZE - 1.0)
    return in_frustum_approx(centre, view_matrix, cam)


def pixel_grid(width: int, height: int, device):
    """Integer pixel coordinate grids (u[h,w], v[h,w]) as float32."""
    v, u = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return u, v


def depth_to_points(depth, cam: CameraConfig):
    """Depth [h,w] -> camera-space points [h,w,3]; invalid depth -> NaN."""
    u, v = pixel_grid(cam.width, cam.height, depth.device)
    pts = screen_to_camera(u, v, depth, cam)
    valid = torch.isfinite(depth) & (depth > 0.0)
    return torch.where(valid[..., None], pts, torch.nan)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def transform_points(mat4, pts):
    return pts @ mat4[:3, :3].T + mat4[:3, 3]


def invert_rigid(mat4):
    """Inverse of a rigid 4x4 transform (R^T, -R^T t)."""
    r_t = mat4[:3, :3].T
    out = torch.eye(4, dtype=mat4.dtype, device=mat4.device)
    out[:3, :3] = r_t
    out[:3, 3] = -r_t @ mat4[:3, 3]
    return out


def euler_zyx_to_matrix(angles):
    """R = Rz(a0) @ Ry(a1) @ Rx(a2)."""
    cz, sz = torch.cos(angles[0]), torch.sin(angles[0])
    cy, sy = torch.cos(angles[1]), torch.sin(angles[1])
    cx, sx = torch.cos(angles[2]), torch.sin(angles[2])
    zero, one = torch.zeros_like(cz), torch.ones_like(cz)
    rz = torch.stack([torch.stack([cz, -sz, zero]),
                      torch.stack([sz, cz, zero]),
                      torch.stack([zero, zero, one])])
    ry = torch.stack([torch.stack([cy, zero, sy]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-sy, zero, cy])])
    rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, cx, -sx]),
                      torch.stack([zero, sx, cx])])
    return rz @ ry @ rx


def rotation_angle(r):
    """Rotation angle of a 3x3 rotation matrix."""
    trace = torch.clamp((torch.trace(r) - 1.0) * 0.5, -1.0, 1.0)
    return torch.arccos(trace)


def normals_from_points(points):
    """Screen-space normals n = -cross(p[y+1]-p[y-1], p[x+1]-p[x-1]) / |.|;
    edge and invalid pixels are NaN."""
    py = F.pad(points, (0, 0, 0, 0, 1, 1), value=float("nan"))
    px = F.pad(points, (0, 0, 1, 1), value=float("nan"))
    ddy = py[2:, :, :] - py[:-2, :, :]
    ddx = px[:, 2:, :] - px[:, :-2, :]
    n = -torch.linalg.cross(ddy, ddx, dim=-1)
    norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    valid = torch.isfinite(norm) & (norm > 0.0)
    return torch.where(valid, n / torch.where(valid, norm, 1.0), torch.nan)
