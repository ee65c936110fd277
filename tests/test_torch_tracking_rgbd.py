"""Parity of the PyTorch port's RGB-D (photometric + geometric) tracking
with the JAX package's, on 160x120 synthetic frames.

Tolerances: ``intensity_gradients`` exact. The photometric system of
``_build_system_color``: the same correspondence count, and A, b, the
residual and weight sums within 1e-5 relative to their largest entry (the
two libraries sum the pixels in another order). ``track`` with
intensities: the same ``valid`` flag and a pose within 1e-5, as the
depth-only tracker. The textured bare wall of ``tests/test_tracking.py``:
depth-only tracking is lost, RGB-D tracking recovers the in-plane shift
within 2.5 mm and 2.5 mrad, and its pose is within 1e-5 of JAX's.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import tracking as jtr
from voxelhashing_tpu.config import CameraConfig, FilterConfig, TrackerConfig
from voxelhashing_tpu.io.synthetic import Scene, make_trajectory, render_depth
from voxelhashing_tpu.ops import image as jimg
from voxelhashing_tpu_torch import tracking as ttr
from voxelhashing_tpu_torch.convert import config_from

CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5,
                   cy=59.5)
TRK = TrackerConfig(levels=2, max_outer_iter=(6, 4), max_inner_iter=(1, 1),
                    dist_thres=(0.15, 0.15), normal_thres=(0.9, 0.9),
                    angle_trans_thres=(1.0, 1.0),
                    dist_trans_thres=(1.0, 1.0),
                    residual_early_out=(1e-9, 1e-9))
TCAM = config_from(CAM)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _frame(pose, seed):
    """(points, normals, intensity) of the preprocessed synthetic frame."""
    d, c = render_depth(pose, CAM, Scene(), noise_sigma=0.002, seed=seed)
    f = jimg.preprocess(jnp.asarray(d), jnp.asarray(c), CAM, FilterConfig())
    return (np.asarray(f.points), np.asarray(f.normals),
            np.asarray(f.intensity))


def test_intensity_gradients_exact():
    img = np.random.default_rng(0).uniform(0, 1, (30, 41)).astype(np.float32)
    img[3, 7] = np.nan
    gj = jtr.intensity_gradients(jnp.asarray(img))
    gt = ttr.intensity_gradients(_t(img))
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (gt[0].numpy()[:, [0, -1]] == 0).all()
    assert (gt[1].numpy()[[0, -1], :] == 0).all()


def test_build_system_color_matches_jax():
    poses = make_trajectory(3, translation_step=0.01)
    in_p, _, in_i = _frame(poses[2], 2)
    _, _, md_i = _frame(poses[0], 0)
    md_i = np.where(np.isfinite(md_i), md_i, np.nan).astype(np.float32)
    delta = (np.linalg.inv(poses[0]) @ poses[2]).astype(np.float32)
    mean = np.array([0.05, -0.1, 1.9], np.float32)
    inv_std = np.float32(2.5)
    gx, gy = jtr.intensity_gradients(jnp.asarray(md_i))
    out_j = jtr._build_system_color(
        jnp.asarray(delta), jnp.asarray(in_p), jnp.asarray(in_i),
        jnp.asarray(md_i), gx, gy, CAM, 0.1, mean=jnp.asarray(mean),
        inv_std=jnp.asarray(inv_std))
    tgx, tgy = ttr.intensity_gradients(_t(md_i))
    out_t = ttr._build_system_color(
        _t(delta), _t(in_p), _t(in_i), _t(md_i), tgx, tgy, TCAM, 0.1,
        mean=_t(mean), inv_std=torch.tensor(inv_std))
    assert int(out_t[4]) == int(out_j[4]) > 1000
    for a, b in zip(out_t[:4], out_j[:4]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
    assert np.abs(np.asarray(out_j[0])).max() > 0


@pytest.mark.parametrize("step,early_out", [(2, 1e-9), (4, 0.01)])
def test_track_rgbd_pair_matches(step, early_out):
    cfg = dataclasses.replace(TRK, residual_early_out=(early_out,) * 2)
    poses = make_trajectory(step + 1, translation_step=0.01)
    mp, mn, mi = _frame(poses[0], 0)      # model: what the last pose saw
    ip, inn, ii = _frame(poses[step], step)
    last = np.eye(4, dtype=np.float32)
    kw = dict(weight_depth=1.0, weight_color=0.1, color_sigma=0.1)
    rj = jtr.track(jnp.asarray(ip), jnp.asarray(inn), jnp.asarray(mp),
                   jnp.asarray(mn), jnp.asarray(last), CAM, cfg,
                   input_intensity=jnp.asarray(ii),
                   model_intensity=jnp.asarray(mi), **kw)
    rt = ttr.track(_t(ip), _t(inn), _t(mp), _t(mn), _t(last), TCAM,
                   config_from(cfg), input_intensity=_t(ii),
                   model_intensity=_t(mi), **kw)
    assert bool(rt.valid) == bool(rj.valid)
    assert bool(rt.valid)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose),
                               atol=1e-5, rtol=0)
    assert int(rt.corr_count) == int(rj.corr_count)
    assert float(rt.planarity) == float(rj.planarity) == 0.0
    np.testing.assert_allclose(rt.level_stats.numpy(),
                               np.asarray(rj.level_stats), rtol=1e-3)


def _plane_maps(tx):
    """``tests/test_tracking.py``'s textured wall at z = 2 seen from
    (tx, 0, 0): camera-space depth unchanged, only the texture shifts."""
    h, w = CAM.height, CAM.width
    z = 2.0
    u = (np.arange(w, dtype=np.float32) - CAM.cx) / CAM.fx * z
    v = (np.arange(h, dtype=np.float32) - CAM.cy) / CAM.fy * z
    xw = np.broadcast_to(u[None, :], (h, w))
    yw = np.broadcast_to(v[:, None], (h, w))
    pts = np.stack([xw, yw, np.full((h, w), z, np.float32)], -1)
    nrm = np.broadcast_to(np.array([0.0, 0.0, -1.0], np.float32), (h, w, 3))
    inten = 0.5 + 0.25 * np.sin(4.0 * (xw + tx)) + 0.25 * np.cos(5.0 * yw)
    return (pts.astype(np.float32), np.ascontiguousarray(nrm),
            inten.astype(np.float32))


def test_textured_wall_tracked_only_with_rgbd():
    trk = dataclasses.replace(TRK, max_outer_iter=(8, 6),
                              residual_early_out=(1e-8, 1e-8))
    tcfg = config_from(trk)
    m_pts, m_nrm, m_int = _plane_maps(0.0)
    tx = 0.01
    i_pts, i_nrm, i_int = _plane_maps(tx)
    eye = np.eye(4, dtype=np.float32)
    res_d = ttr.track(_t(i_pts), _t(i_nrm), _t(m_pts), _t(m_nrm), _t(eye),
                      TCAM, tcfg)
    assert not bool(res_d.valid)

    kw = dict(weight_depth=1.0, weight_color=1.0, color_sigma=0.5)
    res = ttr.track(_t(i_pts), _t(i_nrm), _t(m_pts), _t(m_nrm), _t(eye),
                    TCAM, tcfg, input_intensity=_t(i_int),
                    model_intensity=_t(m_int), **kw)
    assert bool(res.valid)
    d = np.linalg.inv(res.pose.numpy()) @ np.array(
        [[1, 0, 0, tx], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        np.float32)
    assert np.linalg.norm(d[:3, 3]) < 2.5e-3
    assert np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)) < 2.5e-3
    rj = jtr.track(jnp.asarray(i_pts), jnp.asarray(i_nrm),
                   jnp.asarray(m_pts), jnp.asarray(m_nrm), jnp.asarray(eye),
                   CAM, trk, input_intensity=jnp.asarray(i_int),
                   model_intensity=jnp.asarray(m_int), **kw)
    assert bool(rj.valid)
    np.testing.assert_allclose(res.pose.numpy(), np.asarray(rj.pose),
                               atol=1e-5, rtol=0)
