"""Parity of the PyTorch port's diagnostics, trajectory metrics and
``posegraph.reintegrate`` with the JAX package's.

Tolerances: ``hash_histogram`` dicts equal (on JAX states converted by
``convert.py``, before and after deletes); ICP logs, convergence tables
and memory reports equal; ``umeyama_alignment``, aligned ATE and RPE
within 1e-12 (the same float64 numpy); ``reintegrate`` rows equal bit for
bit by key (the same poses, each package's allocate and plain integrate).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import blockmap as jbm, diagnostics as jdiag
from voxelhashing_tpu import evaluation as jev, integrate as jint
from voxelhashing_tpu import posegraph as jpg
from voxelhashing_tpu.config import CameraConfig, MapConfig
from voxelhashing_tpu.geometry import INVALID_KEY
from voxelhashing_tpu.io.synthetic import Scene, make_trajectory, render_depth
from voxelhashing_tpu_torch import blockmap as tbm, convert
from voxelhashing_tpu_torch import diagnostics as tdiag, evaluation as tev
from voxelhashing_tpu_torch import integrate as tint, posegraph as tpg

CAM = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5)
MCFG = MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                 num_blocks=8192, table_size=32768, max_active_blocks=8192)
TCAM, TMCFG = convert.config_from(CAM), convert.config_from(MCFG)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core, and idle
    OpenMP threads spinning beside the other workers cost far more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reintegrated():
    """Three frames re-integrated by each package's ``reintegrate`` under
    the same drifted poses: (JAX map, port map)."""
    gt = make_trajectory(3)
    poses = [np.asarray(p).copy() for p in gt]
    for i, p in enumerate(poses):
        p[0, 3] += 0.01 * i
    frames = [render_depth(p, CAM, Scene(), noise_sigma=0.002, seed=i)
              for i, p in enumerate(gt)]
    # JAX: allocation compiled (op by op it takes most of a minute), the
    # fusion op by op (the XLA function the port's integrate matches)
    j_alloc = jax.jit(lambda s, d, p: jint.allocate_from_depth(s, d, p, CAM,
                                                               MCFG)[0])

    def j_integrate(state, d, c, pose):
        d = jnp.asarray(np.nan_to_num(d, nan=0.0))
        pose = jnp.asarray(pose, jnp.float32)
        return jint.integrate(j_alloc(state, d, pose), d, jnp.asarray(c),
                              pose, CAM, MCFG)

    def t_integrate(state, d, c, pose):
        d = torch.from_numpy(np.nan_to_num(d, nan=0.0))
        pose = torch.as_tensor(pose, dtype=torch.float32)
        state, _ = tint.allocate_from_depth(state, d, pose, TCAM, TMCFG)
        state, _ = tint.integrate(state, d, torch.from_numpy(c), pose, TCAM,
                                  TMCFG)
        return state

    js = jpg.reintegrate(frames, poses, None, lambda: jbm.create(MCFG),
                         j_integrate)
    ts = tpg.reintegrate(frames, poses, None,
                         lambda: tbm.create(TMCFG, device="cpu"), t_integrate)
    return js, ts


def _rows_by_key(keys, *fields):
    ok = keys != INVALID_KEY
    order = np.argsort(keys[ok])
    return [keys[ok][order]] + [np.asarray(f)[ok][order] for f in fields]


def test_reintegrate_rows_bit_equal(reintegrated):
    js, ts = reintegrated
    got = convert.map_state_to_numpy(ts)
    a = _rows_by_key(np.asarray(js.block_key), js.sdf, js.weight, js.color)
    b = _rows_by_key(got["block_key"], got["sdf"], got["weight"],
                     got["color"])
    assert len(a[0]) > 100
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


def _assert_same_dict(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert type(a[k]) is type(b[k]) and a[k] == b[k], k


@pytest.mark.parametrize("deleted", [0, 40])
def test_hash_histogram_matches(reintegrated, deleted):
    """The histogram of a JAX map and of its conversion, and again after
    ``deleted`` blocks are deleted (tombstones in the table)."""
    js, _ = reintegrated
    if deleted:
        idx = jnp.arange(deleted, dtype=jnp.int32) * 3
        js = jbm.delete_blocks(js, idx, jnp.ones((deleted,), bool), MCFG)
    ts = convert.map_state_from_numpy(js, device="cpu")
    hj = jdiag.hash_histogram(js, MCFG)
    ht = tdiag.hash_histogram(ts, TMCFG)
    _assert_same_dict(hj, ht)
    assert ht["consistent"] and ht["allocated_blocks"] > 100
    assert ht["tombstones"] == deleted
    _assert_same_dict(jdiag.memory_report(js, MCFG),
                      tdiag.memory_report(ts, TMCFG))


def test_hash_histogram_empty_map():
    _assert_same_dict(jdiag.hash_histogram(jbm.create(MCFG), MCFG),
                      tdiag.hash_histogram(tbm.create(TMCFG, device="cpu"),
                                           TMCFG))


def test_icp_logs_and_convergence_match(tmp_path):
    rng = np.random.default_rng(0)
    jlog, tlog = jdiag.ICPErrorLog(), tdiag.ICPErrorLog()
    jconv, tconv = jdiag.ConvergenceAnalysis(), tdiag.ConvergenceAnalysis()
    for f in range(3):
        stats = np.abs(rng.normal(size=(3, 4))).astype(np.float32)
        stats[:, 1] *= 100 * f          # condition: some frames "lost"
        stats[:, 2] = np.round(stats[:, 2] * 1000)
        curve = rng.random((3, 6)).astype(np.float32)
        curve[1, 4:] = np.nan
        jr = jlog.record_frame_levels(jnp.asarray(stats))
        tr = tlog.record_frame_levels(torch.from_numpy(stats))
        assert [dataclasses.asdict(c) for c in jr] == \
            [dataclasses.asdict(c) for c in tr]
        assert [c.is_tracking_lost() for c in jr] == \
            [c.is_tracking_lost() for c in tr]
        assert jlog.report_last() == tlog.report_last()
        jconv.record_frame(jnp.asarray(curve))
        tconv.record_frame(torch.from_numpy(curve))
    assert dataclasses.asdict(jlog.last()) == dataclasses.asdict(tlog.last())
    jconv.save(str(tmp_path / "j.txt"))
    tconv.save(str(tmp_path / "t.txt"))
    assert (tmp_path / "j.txt").read_text() == (tmp_path / "t.txt").read_text()
    conf = tdiag.LinearSystemConfidence(sum_residual=10.0, num_corr=5)
    assert conf.is_tracking_lost() == jdiag.LinearSystemConfidence(
        sum_residual=10.0, num_corr=5).is_tracking_lost() is True


def test_timing_log():
    log = tdiag.TimingLog(window=4)
    for _ in range(6):
        log.frame_start()
        log.start("step")
        log.stop("step", sync=torch.ones(3))
        log.start("other")
        log.stop("other", sync=[torch.ones(1), None])
        log.frame_stop()
    avg = log.averages()
    assert set(avg) == {"step", "other"} and all(v >= 0 for v in avg.values())
    assert log.stage_count["step"] == 6
    b = log.benchmark()
    assert b["frames"] == 4 and b["fps"] > 0
    assert log.report().startswith("stage averages (ms):")
    assert "frame window" in log.report()


def test_umeyama_ate_rpe_match():
    rng = np.random.default_rng(1)
    gt = make_trajectory(15)
    est = []
    tf = np.eye(4)
    tf[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0] * np.array(
        [1, 1, 1])
    if np.linalg.det(tf[:3, :3]) < 0:
        tf[:3, 0] *= -1
    tf[:3, 3] = [0.3, -0.1, 0.2]
    for p in gt:
        e = tf @ p
        e[:3, 3] += rng.normal(0, 0.003, 3)
        est.append(e)
    src = np.stack([e[:3, 3] for e in est])
    dst = np.stack([g[:3, 3] for g in gt])
    for scale in (False, True):
        (mt, st), (mj, sj) = (tev.umeyama_alignment(src, dst, scale),
                              jev.umeyama_alignment(src, dst, scale))
        np.testing.assert_allclose(mt, mj, atol=1e-12, rtol=0)
        assert abs(st - sj) <= 1e-12
    for align in (True, False):
        a = tev.ate_rmse(est, gt, align=align)
        assert abs(a - jev.ate_rmse(est, gt, align=align)) <= 1e-12
    assert tev.ate_rmse(est, gt) < 0.01 < tev.ate_rmse(est, gt, align=False)
    for delta in (1, 3):
        rt, rj = tev.rpe_rmse(est, gt, delta), jev.rpe_rmse(est, gt, delta)
        np.testing.assert_allclose(rt, rj, atol=1e-12, rtol=0)
    tensors = [torch.from_numpy(e) for e in est]
    assert tev.ate_rmse(tensors, gt) == tev.ate_rmse(est, gt)
