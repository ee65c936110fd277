"""Parity of the PyTorch port's SLAM layer (``posegraph.py``) with the JAX
package's, and one whole-slice run of both.

Tolerances: ``se3_exp`` within 1e-6 and its Jacobian at 0 finite;
keyframe decisions identical; loop edges the same (i, j, is_loop) with
``z_ij`` within 1e-4; optimized poses within 1e-4 (both solve in f32, the
port batched over edges); ``optimize_distributed`` (no process group, a
gloo group of one, and spawned gloo ranks at D = 2 and 3) within 1e-4 of
JAX's ``optimize_distributed`` at the same D and of ``optimize``;
``corrected_trajectory`` within 1e-12 from the
same optimized poses (float64 numpy on both sides); ``relocalize`` the
same ``ok`` and pose within 1e-4 (``reintegrate`` alone is held bit for
bit in ``tests/test_torch_diagnostics.py``, beside the hash histogram of
the same state). The whole-slice run (160x120, 2 levels, 16 frames out and back,
drifted trajectory replay) gives the same keyframes and loop edges, poses
within 1e-4, and re-integrated maps with the same keys whose weights
differ on at most 1e-4 of the voxels and whose sdf agrees within 4 mm
(two bf16 ulps at the 6 cm truncation) where they do not.
"""

import dataclasses
import io
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import engine as jeng, posegraph as jpg
from voxelhashing_tpu import tracking as jtr
from voxelhashing_tpu.config import (CameraConfig, EngineConfig, FilterConfig,
                                     MapConfig, TrackerConfig)
from voxelhashing_tpu.geometry import INVALID_KEY
from voxelhashing_tpu.io.synthetic import Scene, make_trajectory, render_depth
from voxelhashing_tpu.ops.image import preprocess as jpre
from voxelhashing_tpu_torch import blockmap as tbm, convert
from voxelhashing_tpu_torch import posegraph as tpg
from voxelhashing_tpu_torch import run_slam
from voxelhashing_tpu_torch.ops.image import preprocess as tpre

CAM = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5)
TCAM = convert.config_from(CAM)
FLT = FilterConfig(depth_filter=False)
TFLT = convert.config_from(FLT)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core, and idle
    OpenMP threads spinning beside the other workers cost far more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jitted_jax_track():
    """The JAX pose graph calls ``tracking.track`` op by op; compiled once
    per shape, its registrations take milliseconds instead of seconds."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jtr, "track", jax.jit(jtr.track, static_argnums=(5, 6)))
    yield
    mp.undo()


def _rot(axis, a):
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4)
    if axis == "y":
        m[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    else:
        m[:3, :3] = [[1, 0, 0], [0, c, -s], [0, s, c]]
    return m


def _maps(pose):
    """(JAX maps, port maps) of the frame seen from ``pose``."""
    d, _ = render_depth(np.asarray(pose, np.float32), CAM, Scene())
    d = np.nan_to_num(d, nan=0.0)
    fj = jpre(jnp.asarray(d), None, CAM, FLT)
    ft = tpre(torch.from_numpy(d), None, TCAM, TFLT)
    return (fj.points, fj.normals), (ft.points, ft.normals)


def _graphs(**kw):
    return (jpg.PoseGraph(CAM, jpg.PoseGraphConfig(**kw)),
            tpg.PoseGraph(TCAM, tpg.PoseGraphConfig(**kw), device="cpu"))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-6, 0.0])
def test_se3_exp_and_log_match(scale):
    rng = np.random.default_rng(int(scale * 1e6) + 1)
    xi = (rng.normal(size=6) * np.array([0.3] * 3 + [1.0] * 3)
          * scale).astype(np.float32)
    tj = np.asarray(jpg.se3_exp(jnp.asarray(xi)))
    tt = tpg.se3_exp(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(tt, tj, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tpg.se3_log_residual(torch.from_numpy(tj)),
                               np.asarray(jpg.se3_log_residual(tj)),
                               atol=1e-7, rtol=0)
    # batched: the same transforms row by row
    batch = tpg.se3_exp(torch.from_numpy(np.stack([xi, -xi])))
    assert torch.equal(batch[0], torch.from_numpy(tt))


def test_se3_exp_jacobian_finite_at_zero():
    """Gauss-Newton linearizes at xi = 0, where sqrt has no derivative: the
    Taylor branch keeps the Jacobian finite, and it matches JAX's."""
    import jax
    jt = torch.func.jacfwd(tpg.se3_exp)(torch.zeros(6))
    jj = np.asarray(jax.jacfwd(jpg.se3_exp)(jnp.zeros(6)))
    assert torch.isfinite(jt).all()
    np.testing.assert_allclose(jt.numpy(), jj, atol=1e-6, rtol=0)


def test_keyframe_decisions_match():
    jg, tg = _graphs(keyframe_every=5, keyframe_dist=0.1, keyframe_angle=0.1)
    (jp, jn), (tp, tn) = _maps(np.eye(4))
    rng = np.random.default_rng(3)
    pose = np.eye(4)
    for i in range(30):
        step = np.eye(4)
        step[:3, 3] = rng.normal(0, 0.03, 3)
        pose = pose @ step @ _rot("y", rng.normal(0, 0.03))
        dj = jg.should_add_keyframe(i, pose)
        assert tg.should_add_keyframe(i, pose) == dj, i
        if dj:
            # loops are off here (loop_min_separation): the policy alone
            jg.cfg = dataclasses.replace(jg.cfg, loop_min_separation=10 ** 6)
            tg.cfg = dataclasses.replace(tg.cfg, loop_min_separation=10 ** 6)
            jg.add_keyframe(i, pose, jp, jn)
            tg.add_keyframe(i, pose, tp, tn)
    assert [k.index for k in tg.keyframes] == [k.index for k in jg.keyframes]
    assert len(jg.keyframes) > 3
    for a, b in zip(jg.edges, tg.edges):
        assert (a.i, a.j, a.is_loop) == (b.i, b.j, b.is_loop)
        np.testing.assert_allclose(b.z_ij, a.z_ij, atol=1e-12, rtol=0)


def test_loop_edges_match():
    """``tests/test_posegraph.py``'s loop scene: kf2 returns near kf0 with a
    drifted pose estimate; ICP verification gives the same edges."""
    kw = dict(loop_min_separation=1, loop_max_dist=0.6, loop_max_angle=0.8,
              loop_residual_max=1e-3)
    jg, tg = _graphs(**kw)
    poses = [np.eye(4), _rot("y", 0.3), np.eye(4)]
    poses[2][0, 3] = 0.04
    for k, p in enumerate(poses):
        (jp, jn), (tp, tn) = _maps(p)
        est = p.copy()
        if k == 2:
            est[0, 3] += 0.03
        assert tg.add_keyframe(k * 5, est, tp, tn) == jg.add_keyframe(
            k * 5, est, jp, jn)
    assert [(e.i, e.j, e.is_loop) for e in tg.edges] == \
        [(e.i, e.j, e.is_loop) for e in jg.edges]
    assert any(e.is_loop for e in tg.edges)
    for a, b in zip(jg.edges, tg.edges):
        np.testing.assert_allclose(b.z_ij, a.z_ij, atol=1e-4, rtol=0)


def _chain_with_loop(drift=0.05):
    """``tests/test_posegraph.py``'s square loop: odometry edges from the
    true motion, a loop edge last-to-first, estimates drifting along x.
    Returns (JAX graph, port graph, ground truth, estimates)."""
    gt = [np.eye(4)]
    for k in range(1, 8):
        p = np.eye(4)
        p[0, 3] = [0, 1, 2, 2, 2, 1, 0, 0][k]
        p[2, 3] = [0, 0, 0, 1, 2, 2, 2, 1][k]
        gt.append(p)
    jg, tg = _graphs()
    dummy = np.zeros((4, 4, 3), np.float32)
    est = []
    for k, p in enumerate(gt):
        e = p.copy()
        e[0, 3] += drift * k
        est.append(e)
        jg.keyframes.append(jpg.Keyframe(index=2 * k, pose=e.copy(),
                                         points=dummy, normals=dummy))
        tg.keyframes.append(tpg.Keyframe(index=2 * k, pose=e.copy(),
                                         points=None, normals=None))
    pairs = [(k - 1, k, False) for k in range(1, 8)] + [(0, 7, True)]
    for i, j, loop in pairs:
        z = np.linalg.inv(gt[i]) @ gt[j]
        jg.edges.append(jpg.Edge(i=i, j=j, z_ij=z, is_loop=loop))
        tg.edges.append(tpg.Edge(i=i, j=j, z_ij=z.copy(), is_loop=loop))
    return jg, tg, gt, est


def test_optimize_and_corrected_trajectory_match():
    jg, tg, gt, est = _chain_with_loop()
    jg.snapshot_originals()
    tg.snapshot_originals()
    oj, ot = jg.optimize(), tg.optimize()
    assert ot.dtype == np.float64 and ot.shape == oj.shape
    np.testing.assert_allclose(ot, oj, atol=1e-4, rtol=0)
    assert max(np.abs(ot[k] - gt[k]).max() for k in range(8)) < 0.01
    # from the same optimized poses the corrections agree to float64
    for kt, kj in zip(tg.keyframes, jg.keyframes):
        kt.pose = kj.pose.copy()
    frames = [p for e in est for p in (e, e @ _rot("x", 0.01))]
    ct = tg.corrected_trajectory(frames)
    cj = jg.corrected_trajectory(frames)
    np.testing.assert_allclose(np.stack(ct), np.stack(cj), atol=1e-12,
                               rtol=0)


def _jax_distributed(n_dev):
    """JAX's ``optimize_distributed`` on ``_chain_with_loop`` over a mesh of
    ``n_dev`` virtual devices."""
    if len(jax.devices()) < n_dev:
        pytest.skip(f"needs {n_dev} virtual devices")
    jg, _, gt, _ = _chain_with_loop()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n_dev]), ("e",))
    return jg.optimize_distributed(mesh), gt


@pytest.mark.parametrize("group", ["none", "gloo_world_1"])
def test_optimize_distributed_in_process_matches(group, tmp_path):
    """With no process group (this process alone) and in a gloo group of
    one, ``optimize_distributed`` is within 1e-4 of JAX's (two devices)
    and of the port's ``optimize``."""
    import torch.distributed as dist
    from voxelhashing_tpu_torch.parallel import distributed

    oj, gt = _jax_distributed(2)
    _, tg, _, _ = _chain_with_loop()
    _, tg2, _, _ = _chain_with_loop()
    ref = tg2.optimize()
    if group == "none":
        if dist.is_initialized():
            pytest.skip("a process group is already up in this process")
        out = tg.optimize_distributed()
    else:
        if dist.is_initialized():
            pytest.skip("a process group is already up in this process")
        distributed.initialize(f"file://{tmp_path}/store", 1, 0,
                               backend="gloo")
        try:
            out = tg.optimize_distributed()
        finally:
            dist.destroy_process_group()
    assert out.dtype == np.float64 and out.shape == oj.shape
    np.testing.assert_allclose(out, oj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    assert max(np.abs(out[k] - gt[k]).max() for k in range(8)) < 0.01


def _optimize_rank(rank, n_dev, tmp):
    """One spawned rank: ``optimize_distributed`` of ``_chain_with_loop``
    over a gloo group of ``n_dev``; writes ``tmp/rank<r>.npy``."""
    import os
    import torch.distributed as dist
    from voxelhashing_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.initialize(f"file://{tmp}/store", n_dev, rank,
                           backend="gloo")
    _, tg, _, _ = _chain_with_loop()
    np.save(os.path.join(tmp, f"rank{rank}.npy"), tg.optimize_distributed())
    dist.destroy_process_group()


@pytest.mark.parametrize("n_dev", [2, 3])
def test_optimize_distributed_ranks_match(n_dev, tmp_path):
    """Spawned gloo ranks (D = 2, and D = 3, which pads the 8 edges with a
    zero-weight one) agree with each other and within 1e-4 with JAX's
    ``optimize_distributed`` at the same D and with ``optimize``."""
    from voxelhashing_tpu_torch.parallel import distributed

    oj, _ = _jax_distributed(n_dev)
    _, tg, _, _ = _chain_with_loop()
    ref = tg.optimize()
    distributed.spawn(_optimize_rank, n_dev, (n_dev, str(tmp_path)),
                      timeout=180)
    outs = [np.load(tmp_path / f"rank{r}.npy") for r in range(n_dev)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    np.testing.assert_allclose(outs[0], oj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(outs[0], ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", ["blind_motion", "unseen_view"])
def test_relocalize_matches(case):
    """``tests/test_posegraph.py``'s relocalization scenes: recovery after
    blind motion from a stale pose (warm start fails, the cold retry
    succeeds), and a view the keyframes never saw (rejected)."""
    if case == "blind_motion":
        jg, tg = _graphs(loop_min_separation=100, loop_residual_max=1e-3)
        kf_poses = [np.eye(4), _rot("y", 0.2), _rot("y", 0.4)]
        true = _rot("y", 0.22)
        true[0, 3] += 0.03
    else:
        jg, tg = _graphs(loop_residual_max=1e-5)
        kf_poses = [np.eye(4)]
        true = _rot("y", 3.0)
    for k, p in enumerate(kf_poses):
        (jp, jn), (tp, tn) = _maps(p)
        jg.add_keyframe(k * 5, p, jp, jn)
        tg.add_keyframe(k * 5, p, tp, tn)
    (jp, jn), (tp, tn) = _maps(true)
    rj, okj = jg.relocalize(jp, jn, last_pose=np.eye(4))
    rt, okt = tg.relocalize(tp, tn, last_pose=np.eye(4))
    assert okt == okj
    np.testing.assert_allclose(rt, rj, atol=1e-4, rtol=0)
    if case == "blind_motion":
        assert okt
        d = np.linalg.inv(rt) @ true
        assert np.linalg.norm(d[:3, 3]) < 0.01
    else:
        assert not okt


def _rows_by_key(keys, *fields):
    ok = keys != INVALID_KEY
    order = np.argsort(keys[ok])
    return [keys[ok][order]] + [np.asarray(f)[ok][order] for f in fields]


# ---------------------------------------------------------------------------
# The whole slice
# ---------------------------------------------------------------------------

SLICE_CFG = EngineConfig(
    camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5,
                        cy=59.5),
    map=MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                  num_blocks=16384, table_size=65536,
                  max_active_blocks=16384),
    tracker=TrackerConfig(levels=2, max_outer_iter=(6, 4),
                          max_inner_iter=(1, 1), dist_thres=(0.15, 0.15),
                          normal_thres=(0.9, 0.9),
                          angle_trans_thres=(1.0, 1.0),
                          dist_trans_thres=(1.0, 1.0),
                          residual_early_out=(1e-9, 1e-9)),
    filter=FilterConfig(depth_filter=False), use_trajectory=True)
SLICE_PG = dict(keyframe_every=3)


def _out_and_back(n_out=9, n_back=7, step=0.025):
    """Frames out along ``make_trajectory`` and back over the same poses;
    the replayed estimate drifts 2 mm/frame in x and -1.5 mm in z, so the
    pose graph has a drift to remove."""
    out = make_trajectory(n_out, translation_step=step)
    poses = out + out[-2::-1][:n_back]
    drift = []
    for i, p in enumerate(poses):
        q = p.copy()
        q[0, 3] += 0.002 * i
        q[2, 3] -= 0.0015 * i
        drift.append(q)
    return poses, drift


def test_whole_slice_matches_jax():
    """Both engines replay the drifted trajectory (``use_trajectory``) with
    their pose graphs: keyframes, loop edges, optimized and corrected poses,
    and the map re-integrated under the corrected trajectory agree. The
    port runs through ``run_slam.SlamRun`` (the entry point's loop)."""
    cfg = SLICE_CFG
    cam = cfg.camera
    poses, drift = _out_and_back()
    frames = [render_depth(p, cam, Scene(), noise_sigma=0.002, seed=i)
              for i, p in enumerate(poses)]

    jstep = jeng.make_step(cfg, with_hint=True, donate=False)
    js = jeng.create(cfg, initial_pose=drift[0])
    jg = jpg.PoseGraph(cam, jpg.PoseGraphConfig(**SLICE_PG))
    jest = []
    for i, (d, c) in enumerate(frames):
        d0 = jnp.asarray(np.nan_to_num(d, nan=0.0))
        js, jd = jstep(js, d0, jnp.asarray(c), jnp.asarray(drift[i]))
        jest.append(np.asarray(js.pose))
        if bool(jd.tracking_valid) and jg.should_add_keyframe(i, jest[-1]):
            fr = jpre(d0, None, cam, cfg.filter)
            jg.add_keyframe(i, jest[-1], fr.points, fr.normals)
    jg.snapshot_originals()
    jopt = jg.optimize()
    jcorr = jg.corrected_trajectory(jest)
    jr = jeng.create(cfg, initial_pose=jcorr[0])
    for (d, c), p in zip(frames, jcorr):
        jr, _ = jstep(jr, jnp.asarray(d), jnp.asarray(c),
                      jnp.asarray(np.asarray(p, np.float32)))

    tcfg = convert.config_from(cfg)
    args = run_slam.parse_args(["--device", "cpu", "--gt", "--posegraph",
                                "--reintegrate"])
    run = run_slam.SlamRun(args, tcfg, torch.device("cpu"))
    run.pg = tpg.PoseGraph(tcfg.camera, tpg.PoseGraphConfig(**SLICE_PG),
                           device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        for i, ((d, c), p) in enumerate(zip(frames, drift)):
            run.frame(i, d, c, p)
        np.testing.assert_array_equal(np.stack(run.est), np.stack(jest))
        assert run.optimize()
        run.reintegrate()
    tg = run.pg

    assert [k.index for k in tg.keyframes] == [k.index for k in jg.keyframes]
    assert [(e.i, e.j, e.is_loop) for e in tg.edges] == \
        [(e.i, e.j, e.is_loop) for e in jg.edges]
    assert sum(e.is_loop for e in tg.edges) >= 2
    for a, b in zip(jg.edges, tg.edges):
        np.testing.assert_allclose(b.z_ij, a.z_ij, atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.stack([k.pose for k in tg.keyframes]),
                               jopt, atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.stack(run.est), np.stack(jcorr),
                               atol=1e-4, rtol=0)
    # the correction removed most of the drift
    err = [np.linalg.norm(e[:3, 3] - g[:3, 3]) for e, g in zip(run.est,
                                                               poses)]
    err0 = [np.linalg.norm(e[:3, 3] - g[:3, 3]) for e, g in zip(jest, poses)]
    assert max(err) < 0.5 * max(err0), (max(err), max(err0))

    got = convert.map_state_to_numpy(run.state.map)
    a = _rows_by_key(np.asarray(jr.map.block_key), jr.map.sdf, jr.map.weight,
                     jr.map.color)
    b = _rows_by_key(got["block_key"], got["sdf"], got["weight"],
                     got["color"])
    np.testing.assert_array_equal(b[0], a[0])
    w_j, w_t = a[2].astype(np.float32), b[2].astype(np.float32)
    flip = w_j != w_t
    assert flip.mean() <= 1e-4, flip.sum()
    np.testing.assert_allclose(b[1].astype(np.float32)[~flip],
                               a[1].astype(np.float32)[~flip], atol=4e-3,
                               rtol=0)
    viol = tbm.check_invariants(run.state.map, tcfg.map)
    assert all(v == 0 for v in viol.values()), viol
