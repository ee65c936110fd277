"""Parity of the PyTorch port's ``render`` module (render modes, Phong
shading, depth colouring, the march cost map, PNG and point-cloud export)
with ``voxelhashing_tpu.render``, on ``tests/test_render.py``'s 80x60
scene. Both packages shade the same model and input maps (the JAX
renderer's output, handed over as numpy).

Tolerances: every render mode within 1e-6 (elementwise f32 math; the norms
may round apart by an ulp); the march cost map within 1e-6; the PNG files
decoded within one 8-bit level of each other (a value within 1e-6 of a
rounding edge may round the other way); the PLY point clouds
byte-identical.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import blockmap as jbm, geometry as jgeom
from voxelhashing_tpu import integrate as jint, raycast as jray
from voxelhashing_tpu import render as jren
from voxelhashing_tpu.config import (CameraConfig, FilterConfig, MapConfig,
                                     RaycastConfig)
from voxelhashing_tpu.io.synthetic import Scene, render_depth
from voxelhashing_tpu.ops import image as jimg
from voxelhashing_tpu_torch import convert, render as tren
from voxelhashing_tpu_torch.ops import image as timg
from voxelhashing_tpu_torch.raycast import RaycastResult

CAM = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5)
CFG = MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                num_blocks=8192, table_size=32768, max_active_blocks=8192)
FLT = FilterConfig(depth_filter=False)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def scene():
    """(JAX map, JAX model, JAX input frame, the port's model and input
    frame holding the same values)."""
    depth, color = render_depth(np.eye(4, dtype=np.float32), CAM, Scene())
    d, c = jnp.asarray(depth), jnp.asarray(color)
    pose = jnp.eye(4)
    state = jbm.create(CFG)
    state, _ = jint.allocate_from_depth(state, d, pose, CAM, CFG)
    state = jint.integrate(state, d, c, pose, CAM, CFG)
    ai, na, _ = jbm.compactify(state, jgeom.invert_rigid(pose), CAM, CFG)
    model = jray.render(state, pose, CAM, CFG, RaycastConfig(),
                        active_idx=ai, active_mask=jnp.arange(ai.shape[0])
                        < na)
    frame = jimg.preprocess(d, c, CAM, FLT)
    tmodel = RaycastResult(*(_t(a) for a in model))
    tframe = timg.preprocess(_t(depth), _t(color), convert.config_from(CAM),
                             convert.config_from(FLT))
    return state, model, frame, tmodel, tframe


@pytest.mark.parametrize("mode", jren.RENDER_MODES)
def test_render_modes_match_jax(scene, mode):
    _, model, frame, tmodel, tframe = scene
    ref = np.asarray(jren.render_frame(mode, model, frame, CAM))
    got = tren.render_frame(mode, tmodel, tframe,
                            convert.config_from(CAM)).numpy()
    assert got.shape == (CAM.height, CAM.width, 3)
    assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert got.max() > 0


def test_unknown_mode_raises(scene):
    with pytest.raises(ValueError, match="unknown render mode"):
        tren.render_frame("x-ray", scene[3])


def test_depth_to_hsv_matches_jax():
    d = np.linspace(0.3, 5.5, 48 * 5, dtype=np.float32).reshape(48, 5)
    d[3, 2] = np.nan
    np.testing.assert_allclose(
        timg.depth_to_hsv(_t(d), 0.5, 5.0).numpy(),
        np.asarray(jimg.depth_to_hsv(jnp.asarray(d), 0.5, 5.0)), atol=1e-6,
        rtol=0)


def test_march_cost_map_matches_jax():
    cam = CameraConfig(width=64, height=48, fx=52.0, fy=52.0, cx=31.5,
                       cy=23.5, depth_min=0.3, depth_max=4.0)
    mp = MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                   num_blocks=2048, table_size=8192, max_active_blocks=2048)
    d = np.full((cam.height, cam.width), 1.5, np.float32)
    state = jbm.create(mp)
    pose = jnp.eye(4)
    state, _ = jint.allocate_from_depth(state, jnp.asarray(d), pose, cam, mp)
    state = jint.integrate(state, jnp.asarray(d), None, pose, cam, mp)
    ts = convert.map_state_from_numpy(state, device="cpu")
    for rc in (RaycastConfig(num_samples=32),
               RaycastConfig(num_samples=32, splat_enabled=False)):
        ref = np.asarray(jren.march_cost_map(state, pose, cam, mp, rc))
        got = tren.march_cost_map(ts, torch.eye(4), convert.config_from(cam),
                                  convert.config_from(mp),
                                  convert.config_from(rc)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert np.median(got) == 1.0      # no tile bounds: the whole budget


def test_files_match_jax(scene, tmp_path):
    """RenderToFile's PNGs decode to JAX's pixels; the point clouds are
    byte-identical files."""
    from PIL import Image
    _, model, frame, tmodel, tframe = scene
    for pkg, m, f in (("jax", model, frame), ("torch", tmodel, tframe)):
        out = tmp_path / pkg
        rtf = (jren if pkg == "jax" else tren).RenderToFile(str(out))
        rtf(m, f, CAM if pkg == "jax" else convert.config_from(CAM))
        rtf(m, f, CAM if pkg == "jax" else convert.config_from(CAM))
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert "phong_000000.png" in names and "depth_000001.png" in names
    for n in names:
        a = np.asarray(Image.open(tmp_path / "torch" / n))
        b = np.asarray(Image.open(tmp_path / "jax" / n))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, n

    pj, pt = tmp_path / "j.ply", tmp_path / "t.ply"
    nj = jren.save_point_cloud(str(pj), model.points, colors=model.color,
                               normals=model.normals)
    nt = tren.save_point_cloud(str(pt), tmodel.points, colors=tmodel.color,
                               normals=tmodel.normals)
    assert nt == nj > 1000
    assert pt.read_bytes() == pj.read_bytes()
    assert tren.save_point_cloud(str(pt), tmodel.points) == nj
    assert b"property uchar" not in pt.read_bytes()[:300]
