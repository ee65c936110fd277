"""End-to-end parity of the PyTorch port's ``engine.step`` with the JAX
engine, on ``tests/test_engine.py``'s 160x120 configuration.

Tolerances: 6 frames through both steps give the same valid flags and
poses within 1e-4; the port's ATE stays below 10 mm; its allocated-block
count is within 0.5% of JAX's (allocation order follows the poses, which
agree only to float tolerance); the map invariants are all zero. The
same bounds hold for the march renderer and RGB-D tracking at 80x60. Offline
with a streaming eviction bitmask, 6 frames give poses within 1e-5 and
equal maps: the hash table, pool keys, free stack, weights and colors bit
for bit, sdf within 1 mm on under 0.05% of the voxels. The
converters round-trip a JAX state bit for bit, and importing the port
leaves ``jax`` out of ``sys.modules``.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import engine as jeng, evaluation
from voxelhashing_tpu.config import (CameraConfig, EngineConfig, FilterConfig,
                                     MapConfig, RaycastConfig, StreamingConfig,
                                     TrackerConfig)
from voxelhashing_tpu.io.synthetic import Scene, make_trajectory, render_depth
from voxelhashing_tpu_torch import blockmap as tbm, convert, engine as teng
from voxelhashing_tpu_torch import evaluation as tev, streaming as tstr

CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                   cx=79.5, cy=59.5)
CFG = EngineConfig(
    camera=CAM,
    map=MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                  num_blocks=16384, table_size=65536,
                  max_active_blocks=16384, world_blocks=1024,
                  gc_starve_interval=4),
    tracker=TrackerConfig(levels=2, max_outer_iter=(6, 4),
                          max_inner_iter=(1, 1),
                          dist_thres=(0.15, 0.15), normal_thres=(0.9, 0.9),
                          angle_trans_thres=(1.0, 1.0),
                          dist_trans_thres=(1.0, 1.0),
                          residual_early_out=(1e-9, 1e-9)),
    raycast=RaycastConfig(),
    filter=FilterConfig(depth_filter=False),
    offline=False,
)
TCFG = convert.config_from(CFG)
N_FRAMES = 6
CAM_SMALL = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5,
                         cy=29.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core, and idle
    OpenMP threads spinning beside the other workers cost far more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_both(cfg):
    poses = make_trajectory(N_FRAMES)
    tcfg = convert.config_from(cfg)
    jstep = jeng.make_step(cfg, donate=False)
    js = jeng.create(cfg, initial_pose=poses[0])
    ts = teng.create(tcfg, initial_pose=poses[0], device="cpu")
    out = {"jpose": [], "tpose": [], "jdiag": [], "tdiag": []}
    for i, pose in enumerate(poses):
        depth, color = render_depth(pose, cfg.camera, Scene(),
                                    noise_sigma=0.002, seed=i)
        js, jd = jstep(js, jnp.asarray(depth), jnp.asarray(color))
        ts, td = teng.step(ts, torch.from_numpy(depth),
                           torch.from_numpy(color), tcfg)
        out["jpose"].append(np.asarray(js.pose))
        out["tpose"].append(ts.pose.numpy())
        out["jdiag"].append(jd)
        out["tdiag"].append(td)
    return poses, js, ts, out


@pytest.mark.parametrize("offline", [False, True])
def test_step_matches_jax(offline):
    cfg = dataclasses.replace(CFG, offline=offline)
    poses, js, ts, out = _run_both(cfg)
    for jd, td in zip(out["jdiag"], out["tdiag"]):
        assert bool(td.tracking_valid) == bool(jd.tracking_valid)
    assert all(bool(td.tracking_valid) for td in out["tdiag"])
    for jp, tp in zip(out["jpose"], out["tpose"]):
        np.testing.assert_allclose(tp, jp, atol=1e-4, rtol=0)
    ate = tev.ate_rmse(out["tpose"], poses, align=False)
    assert ate == evaluation.ate_rmse(out["tpose"], poses, align=False)
    assert ate < 0.01, ate
    n_j = int(out["jdiag"][-1].n_allocated_blocks)
    n_t = int(out["tdiag"][-1].n_allocated_blocks)
    assert abs(n_t - n_j) <= 0.005 * n_j, (n_t, n_j)
    assert int(ts.n_integrated) == N_FRAMES == ts.frame_host
    viol = tbm.check_invariants(ts.map, convert.config_from(cfg.map))
    assert all(v == 0 for v in viol.values()), viol
    if offline:
        assert all(int(td.alloc_missed) == 0 for td in out["tdiag"])


@pytest.mark.parametrize("mode,rgbd", [("march", False), ("splat", True),
                                       ("march", True)])
def test_step_render_and_tracking_modes_match_jax(mode, rgbd):
    """The march renderer and RGB-D tracking (JAX defaults: 48 samples,
    16-pixel tiles, weights 1.0 / 0.1, sigma 0.1) through 6 online frames
    at 80x60 (the march samples every ray 48 times): the same bounds as
    :func:`test_step_matches_jax`, and the planarity probe is 0 on every
    RGB-D frame."""
    cfg = dataclasses.replace(
        CFG, camera=CAM_SMALL, raycast=RaycastConfig(mode=mode),
        tracker=dataclasses.replace(CFG.tracker, use_rgbd=rgbd))
    poses, js, ts, out = _run_both(cfg)
    for jd, td in zip(out["jdiag"], out["tdiag"]):
        assert bool(td.tracking_valid) == bool(jd.tracking_valid)
        assert (float(td.icp_planarity) == 0.0) == rgbd
    assert all(bool(td.tracking_valid) for td in out["tdiag"])
    for jp, tp in zip(out["jpose"], out["tpose"]):
        np.testing.assert_allclose(tp, jp, atol=1e-4, rtol=0)
    assert tev.ate_rmse(out["tpose"], poses, align=False) < 0.01
    n_j = int(out["jdiag"][-1].n_allocated_blocks)
    n_t = int(out["tdiag"][-1].n_allocated_blocks)
    assert abs(n_t - n_j) <= 0.005 * n_j, (n_t, n_j)
    assert int(out["tdiag"][-1].splat_overflow) == int(
        out["jdiag"][-1].splat_overflow)
    viol = tbm.check_invariants(ts.map, convert.config_from(cfg.map))
    assert all(v == 0 for v in viol.values()), viol


def test_trajectory_replay_and_render_view_match_jax():
    """``use_trajectory`` replay: the hint is the pose on both sides and the
    allocated-block counts agree as above; ``render_view`` (with color) of
    the two maps differs in coverage or by more than 1 mm on at most 1e-3
    of the pixels (projection-boundary flips of the fused rows)."""
    cfg = dataclasses.replace(CFG, use_trajectory=True)
    tcfg = convert.config_from(cfg)
    poses = make_trajectory(4)
    jstep = jeng.make_step(cfg, with_hint=True, donate=False)
    js = jeng.create(cfg, initial_pose=poses[0])
    ts = teng.create(tcfg, initial_pose=poses[0], device="cpu")
    for i, pose in enumerate(poses):
        depth, color = render_depth(pose, CAM, Scene(), noise_sigma=0.002,
                                    seed=i)
        js, jd = jstep(js, jnp.asarray(depth), jnp.asarray(color),
                       jnp.asarray(pose))
        ts, td = teng.step(ts, torch.from_numpy(depth),
                           torch.from_numpy(color), tcfg, pose_hint=pose)
        assert bool(td.tracking_valid) and bool(jd.tracking_valid)
        np.testing.assert_array_equal(ts.pose.numpy(),
                                      pose.astype(np.float32))
    n_j, n_t = int(jd.n_allocated_blocks), int(td.n_allocated_blocks)
    assert abs(n_t - n_j) <= 0.005 * n_j, (n_t, n_j)
    viol = tbm.check_invariants(ts.map, tcfg.map)
    assert all(v == 0 for v in viol.values()), viol

    dj = np.asarray(jeng.render_view(js, cfg).depth)
    rt = teng.render_view(ts, tcfg)
    dt = rt.depth.numpy()
    assert (np.isfinite(dj) != np.isfinite(dt)).mean() <= 1e-3
    both = np.isfinite(dj) & np.isfinite(dt)
    assert both.mean() > 0.3
    assert (np.abs(dj[both] - dt[both]) > 1e-3).mean() <= 1e-3
    assert (rt.color.numpy()[both] > 0).any()


def _masked_chunks_bitmask(scfg):
    """uint32 eviction words with the chunks x in [0, 3], y in [-3, 3],
    z in [0, 6] set (the right half of the test scene), and their ids."""
    g = scfg.grid_dim
    cc = np.array([(x, y, z) for x in range(4) for y in range(-3, 4)
                   for z in range(7)], np.int64)
    ids = ((cc[:, 2] + g // 2) * g + cc[:, 1] + g // 2) * g + cc[:, 0] + g // 2
    words = np.zeros(((g ** 3 + 31) // 32,), np.uint32)
    np.bitwise_or.at(words, ids // 32,
                     np.uint32(1) << (ids % 32).astype(np.uint32))
    return words, ids


@pytest.mark.parametrize("use_trajectory", [True, False])
def test_step_with_stream_bitmask_matches_jax(use_trajectory):
    """``engine.step(..., stream_bitmask=)`` against the JAX step with the
    same eviction words, offline, trajectory replay and free tracking: 6
    frames give poses within 1e-5 and equal maps (every field bit-equal
    but sdf, which is within 1 mm), and no block of a masked
    chunk is allocated (frame 0 unmasked allocates some)."""
    scfg = StreamingConfig(enabled=True, chunk_size=0.64, grid_dim=65)
    cfg = dataclasses.replace(CFG, offline=True, streaming=scfg,
                              use_trajectory=use_trajectory)
    tcfg = convert.config_from(cfg)
    words, ids = _masked_chunks_bitmask(scfg)
    jmask = jnp.asarray(words)
    tmask = convert.bitmask_from_numpy(words, device="cpu")
    poses = make_trajectory(N_FRAMES)
    jstep = jeng.make_step(cfg, with_hint=use_trajectory, donate=False,
                           with_stream_mask=True)
    js = jeng.create(cfg, initial_pose=poses[0])
    ts = teng.create(tcfg, initial_pose=poses[0], device="cpu")
    for i, pose in enumerate(poses):
        depth, color = render_depth(pose, CAM, Scene(), noise_sigma=0.002,
                                    seed=i)
        hint = (jnp.asarray(pose),) if use_trajectory else ()
        js, jd = jstep(js, jnp.asarray(depth), jnp.asarray(color), *hint,
                       jmask)
        if i == 0:
            unmasked, _ = teng.step(teng.create(tcfg, initial_pose=pose,
                                                device="cpu"),
                                    torch.from_numpy(depth),
                                    torch.from_numpy(color), tcfg,
                                    pose_hint=pose if use_trajectory
                                    else None)
        ts, td = teng.step(ts, torch.from_numpy(depth),
                           torch.from_numpy(color), tcfg,
                           pose_hint=pose if use_trajectory else None,
                           stream_bitmask=tmask)
        assert bool(td.tracking_valid) == bool(jd.tracking_valid)
        np.testing.assert_allclose(ts.pose.numpy(), np.asarray(js.pose),
                                   atol=1e-5, rtol=0)
    got = convert.map_state_to_numpy(ts.map)
    for f, v in got.items():
        ref = np.asarray(getattr(js.map, f))
        assert v.dtype == ref.dtype and v.shape == ref.shape, f
        if f == "sdf":
            continue
        np.testing.assert_array_equal(np.atleast_1d(v).view(np.uint8),
                                      np.atleast_1d(ref).view(np.uint8),
                                      err_msg=f)
    # XLA and torch round the projective distance apart on a few voxels,
    # and the running average carries it: within 1 mm (a few bf16 ulps at
    # the 6 cm truncation) on under 0.05% of them
    a = got["sdf"].astype(np.float32)
    b = np.asarray(js.map.sdf).astype(np.float32)
    np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
    assert (a != b).mean() < 5e-4

    def in_masked(keys):
        keys = keys[keys != tbm.INVALID_KEY]
        lin = tstr.key_to_chunk_linear(keys, tcfg.map, tcfg.streaming)
        return int(np.isin(lin.numpy(), ids).sum())

    assert in_masked(unmasked.map.block_key) > 0
    assert in_masked(ts.map.block_key) == 0
    assert int(td.n_allocated_blocks) > 0


def test_converters_roundtrip_bit_exact():
    """A JAX engine state after two frames converts to the port and back
    without changing a bit; the port steps on from it."""
    poses = make_trajectory(3)
    jstep = jeng.make_step(CFG, donate=False)
    js = jeng.create(CFG, initial_pose=poses[0])
    for i in range(2):
        depth, color = render_depth(poses[i], CAM, Scene(), seed=i)
        js, _ = jstep(js, jnp.asarray(depth), jnp.asarray(color))
    ts = convert.engine_state_from_numpy(js, device="cpu")
    back = convert.engine_state_to_numpy(ts)
    for f in ("pose", "frame", "tracking_lost", "n_integrated"):
        a, b = back[f], np.asarray(getattr(js, f))
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for f, v in back["map"].items():
        ref = np.asarray(getattr(js.map, f))
        assert v.dtype == ref.dtype and v.shape == ref.shape, f
        np.testing.assert_array_equal(np.atleast_1d(v).view(np.uint8),
                                      np.atleast_1d(ref).view(np.uint8))
    assert ts.frame_host == 2
    depth, color = render_depth(poses[2], CAM, Scene(), seed=2)
    ts, td = teng.step(ts, torch.from_numpy(depth), torch.from_numpy(color),
                       TCFG)
    assert bool(td.tracking_valid) and ts.frame_host == 3


def test_import_leaves_jax_out():
    """Importing every module of the port loads neither ``jax`` nor the
    JAX package."""
    root = Path(__file__).resolve().parents[1]
    code = ("import sys, voxelhashing_tpu_torch.engine, "
            "voxelhashing_tpu_torch.convert, voxelhashing_tpu_torch.ops."
            "fused_integrate, voxelhashing_tpu_torch.ops.splat_zbuf, "
            "voxelhashing_tpu_torch.ops._build, voxelhashing_tpu_torch.ops."
            "solve6, voxelhashing_tpu_torch.ops.icp_update, voxelhashing_tpu_torch."
            "evaluation, voxelhashing_tpu_torch.io.synthetic, "
            "voxelhashing_tpu_torch.render, voxelhashing_tpu_torch.run_slam, "
            "voxelhashing_tpu_torch.posegraph, voxelhashing_tpu_torch."
            "diagnostics, voxelhashing_tpu_torch.io.sensfile, "
            "voxelhashing_tpu_torch.io.tum, voxelhashing_tpu_torch.io."
            "binarydump, voxelhashing_tpu_torch.io.network, "
            "voxelhashing_tpu_torch.densegrid, voxelhashing_tpu_torch."
            "denseengine, voxelhashing_tpu_torch.run_dense; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'jaxlib', 'voxelhashing_tpu'}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert res.stdout.strip() == "[]", res.stdout + res.stderr
