"""Parity of the PyTorch port's depth-only ICP tracker with the JAX one.

Tolerance: on synthetic frame pairs the same ``valid`` flag and a pose
within 1e-5 (the 6x6 systems are summed in another order by the two
libraries). The bare-wall scenario of ``tests/test_stress.py`` must be
declared lost in splat mode by the port's engine.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import tracking as jtr
from voxelhashing_tpu.config import (CameraConfig, EngineConfig, FilterConfig,
                                     MapConfig, RaycastConfig, TrackerConfig)
from voxelhashing_tpu.io.synthetic import (Box, Scene, Sphere,
                                           make_trajectory, render_depth)
from voxelhashing_tpu.ops import image as jimg
from voxelhashing_tpu_torch import blockmap as tbm, engine as teng
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
    """One intra-op thread: the suite runs one worker per core, and idle
    OpenMP threads spinning beside the other workers cost far more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _maps(pose, seed):
    d, _ = render_depth(pose, CAM, Scene(), noise_sigma=0.002, seed=seed)
    f = jimg.preprocess(jnp.asarray(d), None, CAM, FilterConfig())
    return np.asarray(f.points), np.asarray(f.normals)


@pytest.mark.parametrize("step,early_out", [(2, 1e-9), (4, 0.01)])
def test_track_pair_matches(step, early_out):
    cfg = dataclasses.replace(TRK, residual_early_out=(early_out,) * 2)
    poses = make_trajectory(step + 1, translation_step=0.01)
    mp, mn = _maps(poses[0], 0)            # model: what the last pose saw
    ip, inn = _maps(poses[step], step)     # input: the current frame
    last = np.eye(4, dtype=np.float32)
    rj = jtr.track(jnp.asarray(ip), jnp.asarray(inn), jnp.asarray(mp),
                   jnp.asarray(mn), jnp.asarray(last), CAM, cfg)
    rt = ttr.track(_t(ip), _t(inn), _t(mp), _t(mn), _t(last), TCAM,
                   config_from(cfg))
    assert bool(rt.valid) == bool(rj.valid)
    assert bool(rt.valid)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose),
                               atol=1e-5, rtol=0)
    assert int(rt.corr_count) == int(rj.corr_count)
    np.testing.assert_allclose(rt.level_stats.numpy(),
                               np.asarray(rj.level_stats), rtol=1e-3)
    np.testing.assert_array_equal(np.isnan(rt.iter_residuals.numpy()),
                                  np.isnan(np.asarray(rj.iter_residuals)))
    # the recovered motion is the true one (model frame = world here)
    rel = np.linalg.inv(poses[0]) @ poses[step]
    np.testing.assert_allclose(rt.pose.numpy()[:3, 3], rel[:3, 3],
                               atol=3e-3)


def test_bare_wall_lost_in_splat_mode():
    """``tests/test_stress.py`` wall scenario, port engine, splat mode:
    every bare-wall frame is declared lost and skipped, the clutter frames
    track, and the map stays healthy."""
    scene = Scene(
        wall_z=2.6, floor_y=None,
        spheres=(Sphere(center=(-0.5, 0.2, 2.0), radius=0.3),
                 Sphere(center=(-0.9, -0.2, 2.2), radius=0.25,
                        color=(0.2, 0.5, 0.8))),
        boxes=(Box(lo=(-0.7, -0.1, 1.3), hi=(-0.4, 0.4, 1.6)),
               Box(lo=(-1.1, 0.3, 1.7), hi=(-0.7, 0.7, 2.0),
                   color=(0.4, 0.3, 0.6))))

    def roty(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)

    poses = []
    for i in range(12):
        p = np.eye(4, dtype=np.float32)
        p[:3, :3] = roty(0.55) if 4 <= i < 8 else roty(-0.15 + 0.004 * i)
        p[0, 3] = 0.005 * i
        poses.append(p)
    cfg = EngineConfig(
        camera=CAM,
        map=MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                      num_blocks=16384, table_size=65536,
                      max_active_blocks=16384, world_blocks=1024),
        tracker=TRK, filter=FilterConfig(depth_filter=True),
        raycast=RaycastConfig(mode="splat"), use_trajectory_only_init=True)
    tcfg = config_from(cfg)
    state = teng.create(tcfg, initial_pose=poses[0], device="cpu")
    diags = []
    for p in poses:
        d, c = render_depth(p, CAM, scene)
        state, diag = teng.step(state, _t(np.nan_to_num(d, nan=0.0)), _t(c),
                                tcfg, pose_hint=_t(p))
        diags.append(diag)
    lost = [not bool(d.tracking_valid) for d in diags]
    assert all(lost[4:8]), lost
    assert not any(lost[:4]) and not any(lost[8:]), lost
    i2 = [float(d.icp_planarity) for d in diags]
    assert all(v < 4e-3 for v in i2[4:8]), i2
    assert int(state.n_integrated) == len(poses) - sum(lost)
    viol = tbm.check_invariants(state.map, tcfg.map)
    assert all(v == 0 for v in viol.values()), viol
