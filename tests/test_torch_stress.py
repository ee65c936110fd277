"""The tracking stress scenes of ``tests/test_stress.py`` through the
port's ``engine.make_step`` on the CPU: clutter occlusion, fast motion and
the easy scene, each exact and with Kinect-style noise, and the bare-wall
pan in both render modes (the march crosses several surfaces there, and
the allocator meets the most new blocks a frame).

The frames (the JAX package's ``io.synthetic`` renders and
``kinect_noise``, numpy), the configurations (through
``convert.config_from``) and the bounds are those of
``tests/test_stress.py``, unchanged: every frame tracked and an ATE below
the scene's bound; on the bare wall, frames 4-7 declared lost and skipped,
the planarity observable below 4e-3 there and above it elsewhere, and the
map's invariants all zero.
"""

import dataclasses

import numpy as np
import pytest
import torch

from voxelhashing_tpu.config import (CameraConfig, EngineConfig, FilterConfig,
                                     MapConfig, RaycastConfig, TrackerConfig)
from voxelhashing_tpu.io.synthetic import (Box, Scene, Sphere, clutter_scene,
                                           kinect_noise, make_trajectory,
                                           render_depth)
from voxelhashing_tpu_torch import blockmap as tbm, engine as teng
from voxelhashing_tpu_torch import evaluation as tev
from voxelhashing_tpu_torch.convert import config_from

CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                   cx=79.5, cy=59.5)
CFG = EngineConfig(
    camera=CAM,
    map=MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                  num_blocks=16384, table_size=65536,
                  max_active_blocks=16384, world_blocks=1024),
    tracker=TrackerConfig(levels=2, max_outer_iter=(6, 4),
                          max_inner_iter=(1, 1),
                          dist_thres=(0.15, 0.15), normal_thres=(0.9, 0.9),
                          angle_trans_thres=(1.0, 1.0),
                          dist_trans_thres=(1.0, 1.0),
                          residual_early_out=(1e-9, 1e-9)),
    filter=FilterConfig(depth_filter=True),   # bilateral on: noisy input
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def run_frames(frames, cfg=CFG, init_pose=None, hints=None):
    """The port's make_step over depth/color frames on the CPU; returns
    (estimated poses, diagnostics, final state)."""
    tcfg = config_from(cfg)
    step = teng.make_step(tcfg, with_hint=hints is not None, donate=False)
    state = teng.create(tcfg, initial_pose=init_pose, device="cpu")
    est, diags = [], []
    for i, (d, c) in enumerate(frames):
        extra = () if hints is None else (_t(hints[i]),)
        state, diag = step(state, _t(np.nan_to_num(d, nan=0.0)), _t(c),
                           *extra)
        est.append(state.pose.numpy().copy())
        diags.append(diag)
    step.close()
    return est, diags, state


def render_seq(scene, poses, noisy=False):
    frames = []
    for i, p in enumerate(poses):
        d, c = render_depth(p, CAM, scene)
        if noisy:
            d = kinect_noise(d, CAM, seed=i)
        frames.append((d, c))
    return frames


def _check_tracked(frames, poses, bound_m):
    est, diags, state = run_frames(frames, init_pose=poses[0])
    assert all(bool(d.tracking_valid) for d in diags)
    ate = tev.ate_rmse(est, poses, align=False)
    assert ate < bound_m, f"ATE {ate*1000:.1f} mm (bound {bound_m*1e3})"
    viol = tbm.check_invariants(state.map, config_from(CFG).map)
    assert all(v == 0 for v in viol.values()), viol


# the bounds of tests/test_stress.py (1.5x the JAX engine's measured
# round-4/round-5 maxima per scene)
@pytest.mark.parametrize("noisy,bound_m", [(True, 0.0036), (False, 0.0056)])
def test_clutter_occlusion(noisy, bound_m):
    """Occlusion-heavy scene, exact and Kinect-noise variants."""
    poses = make_trajectory(10)
    _check_tracked(render_seq(clutter_scene(), poses, noisy=noisy), poses,
                   bound_m)


@pytest.mark.parametrize("noisy,bound_m", [(False, 0.0068), (True, 0.0081)])
def test_fast_motion(noisy, bound_m):
    """5x faster handheld motion (~4 cm + ~1.1 deg per frame)."""
    poses = make_trajectory(8, translation_step=0.04, rotation_step=0.02)
    _check_tracked(render_seq(clutter_scene(), poses, noisy=noisy), poses,
                   bound_m)


@pytest.mark.parametrize("noisy,bound_m", [(False, 0.0098), (True, 0.0185)])
def test_easy(noisy, bound_m):
    """The default plane+spheres scene, exact and noisy."""
    poses = make_trajectory(10)
    _check_tracked(render_seq(Scene(), poses, noisy=noisy), poses, bound_m)


@pytest.mark.parametrize("mode", ["march", "splat"])
def test_wall_lost_then_recover(mode):
    """Panning onto a mapped but bare wall leaves 3 DoF unconstrained: the
    lost gates declare tracking lost, the frames are skipped without
    integration, and tracking recovers once structure re-enters the view,
    in both render modes (GT-init, as the reference validates degenerate
    stretches)."""
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
    cfg = dataclasses.replace(CFG, use_trajectory_only_init=True,
                              raycast=RaycastConfig(mode=mode))
    frames = [render_depth(p, CAM, scene) for p in poses]
    _, diags, state = run_frames(frames, cfg=cfg, init_pose=poses[0],
                                 hints=poses)
    lost = [not bool(d.tracking_valid) for d in diags]
    assert all(lost[4:8]), lost
    assert not any(lost[:4]) and not any(lost[8:]), lost
    i2 = [float(d.icp_planarity) for d in diags]
    assert all(v < 4e-3 for v in i2[4:8]), i2
    assert all(v > 4e-3 for v in i2[1:4] + i2[8:]), i2
    assert int(state.n_integrated) == len(poses) - sum(lost)
    viol = tbm.check_invariants(state.map, config_from(CFG).map)
    assert all(v == 0 for v in viol.values()), viol
