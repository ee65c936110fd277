"""Parity of the PyTorch port's geometry and hash with the JAX package.

Inputs are made with numpy from a seed and go through both packages. The
tolerance is exact equality, except for the two results that come out of a
reduction or a 3x3 product (normals, Euler rotation), where the two
libraries may sum in another order or fuse a multiply-add: there the bound
is one f32 ulp at magnitude 1 (atol 1.2e-7).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import blockmap as jbm, geometry as jgeom
from voxelhashing_tpu.config import CameraConfig
from voxelhashing_tpu_torch import blockmap as tbm, geometry as tgeom
from voxelhashing_tpu_torch.convert import config_from

CAM = CameraConfig(width=64, height=48, fx=52.0, fy=52.0, cx=31.5, cy=23.5)
TCAM = config_from(CAM)
VS = 0.004
WB = 1024


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_world_voxel_block_negative(rng):
    """Symmetric voxel rounding (truncation toward 0) and floor division
    of negative coordinates, including exact zeros and x < 0."""
    pos = rng.uniform(-3.0, 3.0, (2000, 3)).astype(np.float32)
    pos[:10] = 0.0
    pos[10:20, 0] = -0.5 * VS            # halfway points round away from 0
    v_t = tgeom.world_to_voxel(_t(pos), VS)
    _eq(v_t, jgeom.world_to_voxel(jnp.asarray(pos), VS))
    _eq(tgeom.voxel_to_block(v_t), jgeom.voxel_to_block(jnp.asarray(v_t)))
    _eq(tgeom.world_to_block(_t(pos), VS),
        jgeom.world_to_block(jnp.asarray(pos), VS))
    _eq(tgeom.block_to_world(v_t, VS),
        jgeom.block_to_world(jnp.asarray(v_t.numpy()), VS))
    assert (tgeom.voxel_to_block(v_t) < 0).any()


def test_block_keys_roundtrip(rng):
    blocks = rng.integers(-600, 600, (3000, 3)).astype(np.int32)
    k_t = tgeom.pack_block_key(_t(blocks), WB)
    k_j = jgeom.pack_block_key(jnp.asarray(blocks), WB)
    _eq(k_t, k_j)
    assert (k_t.numpy() == tgeom.INVALID_KEY).any()
    valid = k_t != tgeom.INVALID_KEY
    _eq(tgeom.unpack_block_key(k_t[valid], WB),
        jgeom.unpack_block_key(jnp.asarray(k_t[valid].numpy()), WB))
    np.testing.assert_array_equal(
        tgeom.unpack_block_key(k_t[valid], WB).numpy(), blocks[valid.numpy()])


def test_mix_and_probe_bit_exact(rng):
    keys = rng.integers(0, 2 ** 31 - 1, 5000, dtype=np.int64).astype(np.int32)
    keys[:6] = [tgeom.INVALID_KEY, tbm.TOMBSTONE, 0, 1, (1 << 30) - 1,
                1 << 30]
    keys[6:50] = (1 << 30) + rng.integers(-20, 20, 44)
    _eq(tbm._mix(_t(keys)).to(torch.int64),
        np.asarray(jbm._mix(jnp.asarray(keys))).astype(np.int64))
    for r in range(8):
        for size in (1 << 10, 1 << 21):
            _eq(tbm._probe_slot(_t(keys), r, size),
                np.asarray(jbm._probe_slot(jnp.asarray(keys), r, size)))


def test_frustum_and_camera(rng):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.asarray(jgeom.euler_zyx_to_matrix(
        jnp.asarray([0.1, -0.2, 0.05], jnp.float32)))
    pose[:3, 3] = [-0.3, 0.1, -0.2]
    view_j = jgeom.invert_rigid(jnp.asarray(pose))
    view_t = tgeom.invert_rigid(_t(pose))
    _eq(view_t, view_j)
    blocks = rng.integers(-40, 40, (4000, 3)).astype(np.int32)
    inside_t = tgeom.block_in_frustum(_t(blocks), _t(np.asarray(view_j)),
                                      TCAM, 0.02)
    inside_j = jgeom.block_in_frustum(jnp.asarray(blocks), view_j, CAM, 0.02)
    _eq(inside_t, inside_j)
    assert inside_t.any() and not inside_t.all()
    u, v = tgeom.pixel_grid(TCAM.width, TCAM.height, device="cpu")
    uj, vj = jgeom.pixel_grid(CAM.width, CAM.height)
    _eq(u, uj)
    _eq(v, vj)


def test_points_normals_and_se3(rng):
    depth = rng.uniform(0.5, 3.0, (CAM.height, CAM.width)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.1] = np.nan
    depth[0, :5] = 0.0
    pts_t = tgeom.depth_to_points(_t(depth), TCAM)
    pts_j = jgeom.depth_to_points(jnp.asarray(depth), CAM)
    _eq(pts_t, pts_j)
    n_t = tgeom.normals_from_points(pts_t)
    n_j = np.asarray(jgeom.normals_from_points(pts_j))
    np.testing.assert_array_equal(np.isnan(n_t.numpy()), np.isnan(n_j))
    np.testing.assert_allclose(n_t.numpy(), n_j, rtol=0, atol=1.2e-7)

    x = rng.normal(0, 0.1, 6).astype(np.float32)
    p_t = tgeom.pose_from_x(_t(x))
    p_j = np.asarray(jgeom.pose_from_x(jnp.asarray(x)))
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=0, atol=1.2e-7)
    np.testing.assert_allclose(
        float(tgeom.rotation_angle(p_t[:3, :3])),
        float(jgeom.rotation_angle(jnp.asarray(p_j[:3, :3]))), atol=1e-6)


def test_voxel_and_camera_helpers(rng):
    """``world_to_voxel_f``, ``voxel_local_index`` (negative coords too),
    ``camera_to_screen_int`` and ``rotate_vectors`` against JAX: exact,
    except the 3x3 rotation (one f32 ulp, atol 1.2e-7 at magnitude 1)."""
    pos = rng.uniform(-3.0, 3.0, (2000, 3)).astype(np.float32)
    _eq(tgeom.world_to_voxel_f(_t(pos), VS),
        jgeom.world_to_voxel_f(jnp.asarray(pos), VS))
    vox = rng.integers(-700, 700, (3000, 3)).astype(np.int32)
    idx = tgeom.voxel_local_index(_t(vox))
    _eq(idx, jgeom.voxel_local_index(jnp.asarray(vox)))
    assert int(idx.min()) >= 0 and int(idx.max()) < 512
    p_cam = rng.uniform(-1.0, 1.0, (3000, 3)).astype(np.float32)
    p_cam[:, 2] = rng.uniform(0.3, 4.0, 3000)
    uv = tgeom.camera_to_screen_int(_t(p_cam), TCAM)
    _eq(uv, jgeom.camera_to_screen_int(jnp.asarray(p_cam), CAM))
    assert uv.dtype == torch.int32 and (uv < 0).any()
    pose = np.asarray(jgeom.pose_from_x(jnp.asarray(
        rng.normal(0, 0.3, 6).astype(np.float32))))
    vecs = rng.normal(0, 1, (500, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgeom.rotate_vectors(_t(pose), _t(vecs)).numpy(),
        np.asarray(jgeom.rotate_vectors(jnp.asarray(pose),
                                        jnp.asarray(vecs))),
        rtol=0, atol=1.2e-7 * 4)
