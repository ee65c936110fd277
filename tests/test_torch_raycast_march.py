"""Parity of the PyTorch port's march renderer (``raycast.render_march``,
``march_core``, ``ray_interval_splat``, the trilinear sampler and SDF
gradient) and of the splat renderer's trilinear refinement with the JAX
package, on an 80x60 camera over a map fused from three frames.

Tolerances: the trilinear sample's validity is identical and its sdf and
color agree within 1e-6 (the same operations in the same order; the two
libraries may still round a product apart); gradients within 1e-5. The
tile bounds of ``ray_interval_splat`` are identical (bit for bit), with
and without blocks that overflow their tile span. A rendered depth map's
coverage is identical apart from at most 1e-3 of the pixels (a sample on
a crossing's edge may flip) and its depth within 1e-5 m elsewhere, on all
but 1e-3 of the pixels; points within 1e-5 m and colors within 1e-5 where
the depths agree; normals within 1e-3 on 99.5% of the pixels both have.
``march_core`` on an analytic field with several crossings per ray picks
the same (first) crossing as JAX: depth within 1e-6.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import blockmap as jbm, geometry as jgeom
from voxelhashing_tpu import integrate as jint, raycast as jray
from voxelhashing_tpu.config import CameraConfig, MapConfig, RaycastConfig
from voxelhashing_tpu.io.synthetic import Scene, make_trajectory, render_depth
from voxelhashing_tpu_torch import convert, raycast as tray

CAM = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5)
CFG = MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                num_blocks=4096, table_size=16384, max_active_blocks=4096,
                world_blocks=1024)
TCAM, TCFG = convert.config_from(CAM), convert.config_from(CFG)
POSES = make_trajectory(6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def states():
    """(JAX map, the port's copy) after three fused frames."""
    js = jbm.create(CFG)
    for i in (0, 2, 4):
        d, c = render_depth(POSES[i], CAM, Scene(), noise_sigma=0.002, seed=i)
        js, _ = jint.allocate_from_depth(js, jnp.asarray(d),
                                         jnp.asarray(POSES[i]), CAM, CFG)
        js = jint.integrate(js, jnp.asarray(d), jnp.asarray(c),
                            jnp.asarray(POSES[i]), CAM, CFG)
    return js, convert.map_state_from_numpy(js, device="cpu")


def _surface_points(n, seed):
    """World points within a few cm of the scene surface seen from pose 5."""
    d, _ = render_depth(POSES[5], CAM, Scene())
    v, u = np.nonzero(np.isfinite(d))
    rng = np.random.default_rng(seed)
    k = rng.integers(0, len(u), n)
    z = d[v[k], u[k]] + rng.uniform(-0.05, 0.05, n).astype(np.float32)
    cam_pts = np.stack([(u[k] - CAM.cx) / CAM.fx * z,
                        (v[k] - CAM.cy) / CAM.fy * z, z], -1)
    pose = POSES[5]
    return (cam_pts @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)


def _active(js, pose):
    view = jgeom.invert_rigid(jnp.asarray(pose))
    aidx, n_act, _ = jbm.compactify(js, view, CAM, CFG)
    return aidx, jnp.arange(aidx.shape[0]) < n_act


@pytest.mark.parametrize("with_color", [False, True])
def test_trilinear_sample_matches_jax(states, with_color):
    js, ts = states
    pts = _surface_points(3000, 1)
    out_j = jray.trilinear_sample(js, jnp.asarray(pts), CFG,
                                  with_color=with_color)
    out_t = tray.trilinear_sample(ts, _t(pts), TCFG, with_color=with_color)
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    ok = out_t[1].numpy()
    assert 0.3 < ok.mean() < 1.0
    np.testing.assert_allclose(out_t[0].numpy()[ok], np.asarray(out_j[0])[ok],
                               atol=1e-6, rtol=0)
    if with_color:
        col = out_t[2].numpy()
        assert col.shape == (3000, 3) and col[ok].max() > 0
        np.testing.assert_allclose(col, np.asarray(out_j[2]), atol=1e-6,
                                   rtol=0)
    # the SoA entry point on [S,P] coordinate grids, as the march calls it
    grid = pts[:2400].reshape(40, 60, 3)
    sj, vj = jray.trilinear_sample_soa(js, *(jnp.asarray(grid[..., a])
                                             for a in range(3)), CFG)
    st, vt = tray.trilinear_sample_soa(ts, *(_t(grid[..., a])
                                             for a in range(3)), TCFG)
    assert st.shape == (40, 60)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(st.numpy()[vt.numpy()],
                               np.asarray(sj)[np.asarray(vj)], atol=1e-6,
                               rtol=0)


def test_sdf_gradient_matches_jax(states):
    js, ts = states
    pts = _surface_points(2000, 2)
    gj, okj = jray.sdf_gradient(js, jnp.asarray(pts), CFG)
    gt, okt = tray.sdf_gradient(ts, _t(pts), TCFG)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = okt.numpy()
    assert ok.mean() > 0.3
    np.testing.assert_allclose(gt.numpy()[ok], np.asarray(gj)[ok],
                               atol=1e-5, rtol=0)
    assert np.isnan(gt.numpy()[~ok]).all()


@pytest.mark.parametrize("tile", [16, 2])
def test_ray_interval_splat_matches_jax(states, tile):
    """Tile bounds bit for bit; with 2-pixel tiles the near blocks span
    more than 4 tiles and widen every tile (the overflow band)."""
    js, ts = states
    pose = POSES[5]
    aidx, mask = _active(js, pose)
    rc = RaycastConfig(splat_tile=tile)
    view = jgeom.invert_rigid(jnp.asarray(pose))
    tj = jray.ray_interval_splat(js, aidx, mask, view, CAM, CFG, rc)
    tt = tray.ray_interval_splat(ts, _t(aidx), _t(mask),
                                 _t(np.asarray(view)), TCAM, TCFG,
                                 convert.config_from(rc))
    tiles = (-(-CAM.height // tile), -(-CAM.width // tile))
    for a, b in zip(tt, tj):
        assert tuple(a.shape) == tiles
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.isfinite(tt[0].numpy()).any()
    # whether some active block spans more than 4 tiles on an axis (the
    # overflow band): a 16 cm block at ~1.5 m covers ~7 px
    n = int(np.asarray(mask).sum())
    blocks = np.asarray(jgeom.unpack_block_key(
        js.block_key[aidx[:n]], CFG.world_blocks))
    corners = (blocks[:, None, :] * 8 + 8 * np.array(
        [[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)])) \
        * CFG.voxel_size
    p = corners @ np.asarray(view)[:3, :3].T + np.asarray(view)[:3, 3]
    u = np.floor(p[..., 0] * CAM.fx / p[..., 2] + CAM.cx) // tile
    v = np.floor(p[..., 1] * CAM.fy / p[..., 2] + CAM.cy) // tile
    spans = np.maximum(u.max(1) - u.min(1), v.max(1) - v.min(1))
    assert (spans >= 4).any() == (tile == 2)


@pytest.mark.parametrize("use_gradients", [False, True])
def test_render_march_matches_jax(states, use_gradients):
    js, ts = states
    pose = POSES[5]
    aidx, mask = _active(js, pose)
    rc = RaycastConfig(mode="march", use_gradients=use_gradients)
    out_j = jray.render_march(js, jnp.asarray(pose), CAM, CFG, rc,
                              active_idx=aidx, active_mask=mask)
    out_t = tray.render_march(ts, _t(pose), TCAM, TCFG,
                              convert.config_from(rc), active_idx=_t(aidx),
                              active_mask=_t(mask))
    _compare(out_t, out_j)
    assert int(out_t.splat_overflow) == int(out_j.splat_overflow) == 0


def test_render_dispatches_march(states):
    """``render(mode="march")`` is the march (with color, whatever
    ``with_color`` says, as in JAX), here without tile bounds (no active
    list: the camera's whole depth range)."""
    js, ts = states
    pose = POSES[4]
    rc = RaycastConfig(mode="march", splat_enabled=True)
    out_j = jray.render(js, jnp.asarray(pose), CAM, CFG, rc,
                        with_color=False)
    out_t = tray.render(ts, _t(pose), TCAM, TCFG, convert.config_from(rc),
                        with_color=False)
    _compare(out_t, out_j)
    assert (out_t.color.numpy() > 0).any()


def test_render_splat_refine_trilinear_matches_jax(states):
    js, ts = states
    pose = POSES[5]
    aidx, mask = _active(js, pose)
    rc = RaycastConfig(mode="splat", refine_trilinear=True)
    out_j = jray.render_splat(js, jnp.asarray(pose), CAM, CFG, rc,
                              active_idx=aidx, active_mask=mask,
                              with_color=False)
    out_t = tray.render_splat(ts, _t(pose), TCAM, TCFG,
                              convert.config_from(rc), active_idx=_t(aidx),
                              active_mask=_t(mask), with_color=False)
    _compare(out_t, out_j)
    plain = tray.render_splat(ts, _t(pose), TCAM, TCFG,
                              convert.config_from(dataclasses.replace(
                                  rc, refine_trilinear=False)),
                              active_idx=_t(aidx), active_mask=_t(mask),
                              with_color=False)
    both = np.isfinite(plain.depth.numpy())
    assert (plain.depth.numpy()[both] != out_t.depth.numpy()[both]).any()


def _compare(out_t, out_j):
    dt, dj = out_t.depth.numpy(), np.asarray(out_j.depth)
    cover_t, cover_j = np.isfinite(dt), np.isfinite(dj)
    assert (cover_t != cover_j).mean() <= 1e-3
    both = cover_t & cover_j
    assert both.mean() > 0.3
    close = np.abs(dt - dj) <= 1e-5
    assert (~close[both]).mean() <= 1e-3
    agree = both & close
    np.testing.assert_allclose(out_t.points.numpy()[agree],
                               np.asarray(out_j.points)[agree], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(out_t.color.numpy()[agree],
                               np.asarray(out_j.color)[agree], atol=1e-5,
                               rtol=0)
    n_t, n_j = out_t.normals.numpy(), np.asarray(out_j.normals)
    nboth = np.isfinite(n_t[..., 0]) & np.isfinite(n_j[..., 0])
    assert nboth.mean() > 0.2
    assert (np.abs(n_t[nboth] - n_j[nboth]).max(axis=-1) < 1e-3).mean() \
        > 0.995


def test_march_core_takes_the_first_crossing():
    """An analytic field with a + to - crossing every 10 cm along each ray
    (sdf = cos(2 pi t / 0.1), t the z-depth): both packages refine the
    first crossing past each ray's own t_min."""
    cam = CameraConfig(width=16, height=12, fx=13.0, fy=13.0, cx=7.5,
                       cy=5.5)
    rng = np.random.default_rng(3)
    t_min = rng.uniform(0.5, 0.9, 16 * 12).astype(np.float32)
    t_max = (t_min + 0.6).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)

    def field(lib):
        def sample_soa(px, py, pz, with_color=False):
            s = lib.cos(2.0 * np.pi * pz / 0.1) * 0.02
            ok = lib.isfinite(s)
            if with_color:
                return s, ok, lib.stack([lib.zeros_like(s)] * 3, -1)
            return s, ok
        return sample_soa

    kw = dict(num_samples=48, ray_inc=0.008, thres_sample_dist=0.5,
              thres_dist=0.5)
    out_j = jray.march_core(field(jnp), jnp.asarray(pose), cam,
                            jnp.asarray(t_min), jnp.asarray(t_max), **kw)
    out_t = tray.march_core(field(torch), _t(pose),
                            convert.config_from(cam), _t(t_min), _t(t_max),
                            **kw)
    dt, dj = out_t.depth.numpy(), np.asarray(out_j.depth)
    assert np.isfinite(dt).all() and np.isfinite(dj).all()
    np.testing.assert_allclose(dt, dj, atol=1e-6, rtol=0)
    # the first zero of cos(20 pi t) past t_min: t = 0.025 + 0.05 k
    # (+ to - at k even)
    first = 0.025 + 0.1 * np.ceil((t_min.reshape(12, 16) - 0.025) / 0.1)
    assert np.abs(dt - first).max() < 2e-3
