"""Parity of the PyTorch port's dense voxel grid (``densegrid``) with the
JAX package's, on the CPU at 96^3 with an 80x60 camera, and the
counterparts of ``tests/test_densegrid.py``.

Tolerances: ``create``, ``set_ellipsoid``, ``integrate`` (sdf, weight and
packed color) and ``trilinear_sample_soa`` (sdf, validity, color) are
bit-equal to JAX: the same operations in the same order. ``_ray_box_band``
within 1e-6 m. A render's found masks agree on >= 99% of the pixels, and
depth, points and color agree within 1e-5 where both find a surface (the
bounds of ``tests/test_torch_raycast_march.py``). ``extract_mesh`` gives
JAX's triangle count and, sorted, its triangles and colors within 1e-6
where JAX drops no cube. The dense grid as an oracle for the sparse port's
plain integrate: 1.5e-3, one bf16 step of the truncation (the JAX test's
bound).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import densegrid as jdg
from voxelhashing_tpu.config import CameraConfig, MapConfig
from voxelhashing_tpu.io.synthetic import Scene, make_trajectory, render_depth
from voxelhashing_tpu_torch import blockmap as tbm, convert
from voxelhashing_tpu_torch import densegrid as tdg, denseengine as tde
from voxelhashing_tpu_torch import integrate as tint, raycast as tray

CAM = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5,
                   depth_min=0.2, depth_max=4.0)
GRID = jdg.DenseGridConfig(dims=(96, 96, 96), origin=(-0.96, -0.96, 0.8),
                           voxel_size=0.02, truncation=0.1)
TCAM, TGRID = convert.config_from(CAM), convert.dense_config_from(GRID)
POSES = make_trajectory(4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _assert_bits(port: dict, ref):
    """Every field of ``port`` (``convert.dense_grid_to_numpy``) has the
    bits of ``ref``'s."""
    for f, v in port.items():
        r = np.asarray(getattr(ref, f))
        assert v.dtype == r.dtype and v.shape == r.shape, f
        assert np.array_equal(v.view(np.uint8), r.view(np.uint8)), f


def _frames():
    """Four noisy frames of ``Scene()`` along ``make_trajectory(4)``."""
    out = []
    for i, pose in enumerate(POSES):
        d, c = render_depth(pose, CAM, Scene(), noise_sigma=0.002, seed=i)
        out.append((np.nan_to_num(d, nan=0.0), c, pose))
    return out


@pytest.fixture(scope="module")
def fused():
    """(JAX grid, the port's grid) after the four frames, each fused by
    its own package."""
    jg, tg = jdg.create(GRID), tdg.create(TGRID, device="cpu")
    for d, c, pose in _frames():
        jg = jdg.integrate(jg, GRID, jnp.asarray(d), jnp.asarray(c),
                           jnp.asarray(pose), CAM)
        tg = tdg.integrate(tg, TGRID, _t(d), _t(c), _t(pose), TCAM)
    return jg, tg


def test_create_and_set_ellipsoid_bit_equal():
    jg, tg = jdg.create(GRID), tdg.create(TGRID, device="cpu")
    _assert_bits(convert.dense_grid_to_numpy(tg), jg)
    args = ((0.1, -0.05, 1.6), (0.4, 0.3, 0.5), (10, 200, 30))
    je = jdg.set_ellipsoid(jg, GRID, *args)
    te = tdg.set_ellipsoid(tg, TGRID, *args)
    _assert_bits(convert.dense_grid_to_numpy(te), je)
    inside = np.asarray(je.sdf) < 0.0
    assert 1000 < inside.sum() < inside.size


def test_integrate_matches_jax_bit_for_bit(fused):
    jg, tg = fused
    _assert_bits(convert.dense_grid_to_numpy(tg), jg)
    w = tg.weight.numpy()
    assert (w == 4.0).sum() > 10_000 and (w == 0.0).sum() > 10_000
    assert (tg.color != 0).sum() > 10_000


def test_integrate_without_color_and_in_place(fused):
    """``color=None`` keeps the colors, bit-equal to JAX; ``in_place``
    writes the same bits into the grid's own tensors."""
    jg, tg = fused
    d, _, _ = _frames()[1]
    pose = POSES[2]
    ref = jdg.integrate(jg, GRID, jnp.asarray(d), None, jnp.asarray(pose),
                        CAM)
    out = tdg.integrate(tg, TGRID, _t(d), None, _t(pose), TCAM)
    _assert_bits(convert.dense_grid_to_numpy(out), ref)
    assert out.color is tg.color
    d, c, _ = _frames()[3]
    fresh = tdg.integrate(tg, TGRID, _t(d), _t(c), _t(pose), TCAM)
    copy = tdg.DenseGrid(*(t.clone() for t in tg))
    same = tdg.integrate(copy, TGRID, _t(d), _t(c), _t(pose), TCAM,
                         in_place=True)
    assert all(a is b for a, b in zip(same, copy))
    for a, b in zip(same, fresh):
        assert torch.equal(a, b)
    assert not torch.equal(copy.weight, tg.weight)


def _probe_points(n, seed):
    rng = np.random.default_rng(seed)
    lo = np.asarray(GRID.origin, np.float32) - 0.05
    hi = lo + 0.1 + GRID.voxel_size * (np.asarray(GRID.dims) - 1)
    return [rng.uniform(lo[k], hi[k], n).astype(np.float32)
            for k in range(3)]


@pytest.mark.parametrize("with_color", [False, True])
def test_trilinear_sample_matches_jax(fused, with_color):
    jg, tg = fused
    pts = _probe_points(20_000, 3)
    ref = jdg.trilinear_sample_soa(jg, GRID, *map(jnp.asarray, pts),
                                   with_color=with_color)
    got = tdg.trilinear_sample_soa(tg, TGRID, *map(_t, pts),
                                   with_color=with_color)
    assert len(got) == len(ref) == (3 if with_color else 2)
    for r, g in zip(ref, got):
        r, g = np.asarray(r), g.numpy()
        assert r.dtype == g.dtype and r.shape == g.shape
        assert np.array_equal(r.view(np.uint8), g.view(np.uint8))
    assert 2000 < np.asarray(ref[1]).sum() < 20_000


def test_ray_box_band_matches_jax():
    for pose in POSES[::3]:
        p = np.asarray(pose, np.float32)
        jn, jf = jdg._ray_box_band(jnp.asarray(p), CAM, GRID)
        tn, tf = tdg._ray_box_band(_t(p), TCAM, TGRID)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6,
                                   rtol=0)
        assert (tf > tn).float().mean() > 0.9


def test_render_matches_jax(fused):
    jg, tg = fused
    pose = np.asarray(POSES[3], np.float32)
    ref = jdg.render(jg, GRID, jnp.asarray(pose), CAM)
    got = tdg.render(tg, TGRID, _t(pose), TCAM)
    jd, td = np.asarray(ref.depth), got.depth.numpy()
    jf, tf = np.isfinite(jd), np.isfinite(td)
    assert (jf == tf).mean() >= 0.99 and jf.mean() > 0.4
    both = jf & tf
    np.testing.assert_allclose(td[both], jd[both], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.points.numpy()[both],
                               np.asarray(ref.points)[both], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.color.numpy()[both],
                               np.asarray(ref.color)[both], atol=1e-5,
                               rtol=0)


def _sorted_rows(vertices, colors):
    flat = np.concatenate([np.asarray(vertices).reshape(len(vertices), -1),
                           np.asarray(colors).reshape(len(colors), -1)], 1)
    return flat[np.lexsort(flat.T[::-1])]


def test_extract_mesh_matches_jax(fused):
    jg, tg = fused
    ref = jdg.extract_mesh(jg, GRID)
    got = tdg.extract_mesh(tg, TGRID)
    n = int(ref.n_triangles)
    assert int(ref.overflow) == 0 and got.n_triangles == n > 1000
    np.testing.assert_allclose(
        _sorted_rows(got.vertices.numpy(), got.colors.numpy()),
        _sorted_rows(np.asarray(ref.vertices)[:n],
                     np.asarray(ref.colors)[:n]), atol=1e-6, rtol=0)


# --- the counterparts of tests/test_densegrid.py ---------------------------


def _plane_frame(z=1.5, color=(0.8, 0.3, 0.1)):
    """Full-frame fronto-parallel plane at depth z with one color."""
    d = torch.full((CAM.height, CAM.width), z, dtype=torch.float32)
    c = torch.tensor(color, dtype=torch.float32).expand(
        CAM.height, CAM.width, 3).contiguous()
    return d, c


def test_ellipsoid_render_depth():
    """A sphere's analytic SDF renders at the ray-sphere depth with +z
    normals at the centre, and the far corner misses it."""
    g = tdg.create(TGRID, device="cpu")
    g = tdg.set_ellipsoid(g, TGRID, (0.0, 0.0, 1.6), (0.4, 0.4, 0.4))
    res = tdg.render(g, TGRID, torch.eye(4), TCAM)
    d = res.depth.numpy()
    assert np.isfinite(d[30, 40])
    assert abs(d[30, 40] - 1.2) < 2.5 * GRID.voxel_size
    assert not np.isfinite(d[0, 0])
    assert res.normals.numpy()[30, 40][2] > 0.9


def test_integrate_plane_and_mesh():
    g = tdg.create(TGRID, device="cpu")
    depth, color = _plane_frame(z=1.5)
    pose = torch.eye(4)
    for _ in range(3):
        g = tdg.integrate(g, TGRID, depth, color, pose, TCAM)
    s_front, ok_f = tdg.trilinear_sample_soa(
        g, TGRID, torch.tensor([0.0]), torch.tensor([0.0]),
        torch.tensor([1.40]))
    s_back, ok_b = tdg.trilinear_sample_soa(
        g, TGRID, torch.tensor([0.0]), torch.tensor([0.0]),
        torch.tensor([1.58]))
    assert bool(ok_f[0]) and bool(ok_b[0])
    assert float(s_front[0]) > 0.0 > float(s_back[0])

    res = tdg.render(g, TGRID, pose, TCAM)
    centre = res.depth.numpy()[20:40, 20:60]
    assert np.isfinite(centre).mean() > 0.9
    assert abs(np.nanmedian(centre) - 1.5) < GRID.voxel_size
    assert np.allclose(res.color.numpy()[30, 40], [0.8, 0.3, 0.1],
                       atol=0.02)

    chunk = tdg.extract_mesh(g, TGRID)
    assert chunk.n_triangles > 100
    assert chunk.vertices.shape == (chunk.n_triangles, 3, 3)
    v = chunk.vertices.numpy().reshape(-1, 3)
    assert np.abs(v[:, 2] - 1.5).max() < 2.5 * GRID.voxel_size


def test_integrate_weight_accumulates_and_clamps():
    cfg = dataclasses.replace(TGRID, weight_max=4.0)
    g = tdg.create(cfg, device="cpu")
    depth, color = _plane_frame(z=1.5)
    for _ in range(6):
        g = tdg.integrate(g, cfg, depth, color, torch.eye(4), TCAM)
    assert float(g.weight.max()) == 4.0


def test_differential_vs_sparse_map():
    """One frame of a bare wall fused into the dense grid and into the
    sparse port's map by its plain integrate gives the same TSDF near the
    surface (same observation, weight-1 average; the sparse pool is bf16,
    so the bound is one bf16 step of the truncation)."""
    from voxelhashing_tpu_torch.io.synthetic import Scene as TScene
    from voxelhashing_tpu_torch.io.synthetic import render_depth as trender

    pose = torch.eye(4)
    d, c = trender(np.eye(4, dtype=np.float32), TCAM,
                   TScene(wall_z=1.5, floor_y=None, spheres=()),
                   device="cpu")
    d = torch.nan_to_num(d, nan=0.0)
    mp = convert.config_from(MapConfig(
        voxel_size=GRID.voxel_size, truncation=GRID.truncation,
        truncation_scale=0.0, num_blocks=4096, table_size=16384,
        max_active_blocks=4096, world_blocks=1024,
        integration_weight_sample=1))
    state = tbm.create(mp, device="cpu")
    state, _ = tint.allocate_from_depth(state, d, pose, TCAM, mp)
    state, _ = tint.integrate(state, d, c, pose, TCAM, mp)
    g = tdg.integrate(tdg.create(TGRID, device="cpu"), TGRID, d, c, pose,
                      TCAM)

    rng = np.random.RandomState(0)
    px = _t(rng.uniform(-0.3, 0.3, 200).astype(np.float32))
    py = _t(rng.uniform(-0.3, 0.3, 200).astype(np.float32))
    pz = _t(rng.uniform(1.42, 1.49, 200).astype(np.float32))
    s_d, ok_d = tdg.trilinear_sample_soa(g, TGRID, px, py, pz)
    s_s, ok_s = tray.trilinear_sample_soa(state, px, py, pz, mp)
    both = (ok_d & ok_s).numpy()
    assert both.sum() > 50
    assert np.abs((s_d - s_s).numpy())[both].max() < 1.5e-3


def test_empty_grid_renders_nothing():
    g = tdg.create(TGRID, device="cpu")
    res = tdg.render(g, TGRID, torch.eye(4), TCAM)
    assert not torch.isfinite(res.depth).any()
    chunk = tdg.extract_mesh(g, TGRID)
    assert chunk.n_triangles == 0 and chunk.vertices.shape == (0, 3, 3)


# --- converters and devices ------------------------------------------------


def test_convert_round_trip(fused):
    """JAX grid -> port -> numpy keeps every bit (uint32 color through an
    int32 view); the configs convert field by field."""
    jg, _ = fused
    tg = convert.dense_grid_from_numpy(jg, device="cpu")
    assert tg.color.dtype == torch.int32 and tg.sdf.dtype == torch.float32
    _assert_bits(convert.dense_grid_to_numpy(tg), jg)
    assert dataclasses.asdict(TGRID) == dataclasses.asdict(GRID)

    @dataclasses.dataclass(frozen=True)
    class Other:
        dims: tuple = (8, 8, 8)

    with pytest.raises(ValueError):
        convert.dense_config_from(Other())


@pytest.mark.parametrize("name", ["densegrid.create", "denseengine.create",
                                  "dense_grid_from_numpy"])
def test_entry_points_need_a_card_unless_told(name, monkeypatch):
    """Without ``device`` the dense entry points build on the card; with
    no card they raise and name ``device="cpu"``."""
    calls = {
        "densegrid.create": lambda **kw: tdg.create(TGRID, **kw),
        "denseengine.create": lambda **kw: tde.create(TGRID, **kw).grid,
        "dense_grid_from_numpy": lambda **kw: convert.dense_grid_from_numpy(
            jdg.create(GRID), **kw),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[name]()
    out = calls[name](device="cpu")
    assert all(t.device.type == "cpu" for t in out)
