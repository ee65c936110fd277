"""Parity of the PyTorch port's dense engine (``denseengine``) with the JAX
package's, on the CPU: ``tests/test_densegrid.py``'s 8-frame free-tracking
run through both ``make_step`` functions; the host reads of the frame-0
and replay paths; and ``python -m voxelhashing_tpu_torch.run_dense``.

Tolerances: ``valid`` equal and poses within 1e-4 on every frame (the
engine tests' bound); from frame 1 on (JAX tracks an empty model on frame
0, the port skips that work) the correspondence count within 0.5%, the
residual, per-level statistics and residual curves within 1e-2 relative
with the same NaN pattern, and the condition numbers within 10% (the
ratio of the 6x6 system's extreme eigenvalues: a correspondence more or
less at the coarse level, from a render that agrees within 1e-5 m, moves it
by several percent); the port's ATE below 12 mm.

The JAX package is imported inside the tests that compare with it, so
that the test marked ``cuda`` also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_denseengine.py
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from voxelhashing_tpu_torch import convert, denseengine as tde
from voxelhashing_tpu_torch import densegrid as tdg, evaluation as tev
from voxelhashing_tpu_torch import run_dense
from voxelhashing_tpu_torch.config import (CameraConfig, EngineConfig,
                                           FilterConfig, TrackerConfig)
from voxelhashing_tpu_torch.io.synthetic import (Scene, Sphere,
                                                 make_trajectory,
                                                 render_depth)

N_FRAMES = 8
CAM = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5,
                   depth_min=0.2, depth_max=4.0)
GRID = tdg.DenseGridConfig(dims=(80, 80, 64), origin=(-0.8, -0.8, 0.9),
                           voxel_size=0.025, truncation=0.1)
CFG = EngineConfig(
    camera=CAM,
    tracker=TrackerConfig(levels=2, max_outer_iter=(6, 4),
                          max_inner_iter=(1, 1), dist_thres=(0.15, 0.15),
                          normal_thres=(0.9, 0.9),
                          angle_trans_thres=(0.8, 0.8),
                          dist_trans_thres=(0.8, 0.8),
                          residual_early_out=(1e-8, 1e-8)),
    filter=FilterConfig(depth_filter=False),
    offline=False,
)
SCENE = Scene(wall_z=1.8, spheres=(
    Sphere(center=(0.0, 0.1, 1.5), radius=0.25),
    Sphere(center=(-0.4, -0.2, 1.6), radius=0.2, color=(0.2, 0.5, 0.8)),
    Sphere(center=(0.4, -0.1, 1.4), radius=0.15, color=(0.3, 0.7, 0.3)),
), floor_y=0.7)
POSES = make_trajectory(N_FRAMES, translation_step=0.006,
                        rotation_step=0.003)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(device="cpu"):
    """The 8 frames (1 mm noise, seed = frame index) on ``device``: depth
    with NaN as 0, color."""
    out = []
    for i, pose in enumerate(POSES):
        d, c = render_depth(pose, CAM, SCENE, noise_sigma=0.001, seed=i,
                            device=device)
        out.append((torch.nan_to_num(d, nan=0.0), c))
    return out


def _jax_configs():
    """The JAX package's configs equal to ``CFG`` and ``GRID``."""
    from voxelhashing_tpu import config as jcfg, densegrid as jdg
    cfg = jcfg.EngineConfig(
        camera=jcfg.CameraConfig(**dataclasses.asdict(CAM)),
        tracker=jcfg.TrackerConfig(**dataclasses.asdict(CFG.tracker)),
        filter=jcfg.FilterConfig(depth_filter=False), offline=False)
    assert convert.config_from(cfg) == CFG
    grid = jdg.DenseGridConfig(**dataclasses.asdict(GRID))
    return cfg, grid


@pytest.fixture(scope="module")
def both_runs():
    """Per frame (JAX TrackingResult, the port's, JAX pose, port pose), the
    inputs made once by the port's renderer and handed to both."""
    import jax.numpy as jnp
    from voxelhashing_tpu import denseengine as jde

    jcfg, jgrid = _jax_configs()
    jstep = jde.make_step(jcfg, jgrid, donate=False)
    tstep = tde.make_step(CFG, GRID, donate=False)
    js, ts = jde.create(jgrid), tde.create(GRID, device="cpu")
    out = []
    for d, c in _frames():
        js, jtr = jstep(js, jnp.asarray(d.numpy()), jnp.asarray(c.numpy()))
        ts, ttr = tstep(ts, d, c)
        out.append((jtr, ttr, np.asarray(js.pose), ts.pose.numpy()))
    return out


def test_free_tracking_matches_jax(both_runs):
    for i, (jtr, ttr, jp, tp) in enumerate(both_runs):
        assert bool(ttr.valid) == bool(jtr.valid), i
        assert bool(ttr.valid), f"tracking lost at frame {i}"
        np.testing.assert_allclose(tp, jp, atol=1e-4, rtol=0)
        if i == 0:
            continue
        nj, nt = int(jtr.corr_count), int(ttr.corr_count)
        assert abs(nt - nj) <= 0.005 * nj and nj > 1000, (i, nt, nj)
        for f in ("residual", "condition", "level_stats", "iter_residuals"):
            a, b = getattr(ttr, f).numpy(), np.asarray(getattr(jtr, f))
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            if f == "level_stats":          # column 1: each level's condition
                np.testing.assert_allclose(a[:, 1], b[:, 1], rtol=0.1)
                a, b = np.delete(a, 1, 1), np.delete(b, 1, 1)
            np.testing.assert_allclose(a, b, rtol=0.1 if f == "condition"
                                       else 1e-2, atol=0, err_msg=f)
        np.testing.assert_allclose(float(ttr.planarity),
                                   float(jtr.planarity), rtol=1e-2)
    ate = tev.ate_rmse([r[3] for r in both_runs], POSES)
    assert ate < 0.012, f"dense-engine ATE {ate * 1e3:.1f} mm"


@pytest.mark.parametrize("donate", [False, True])
def test_donate(donate):
    """``donate=False`` leaves every tensor of the state it is given
    unchanged; ``donate=True`` fuses into that state's grid tensors."""
    step = tde.make_step(CFG, GRID, donate=donate)
    frames = _frames()
    state = tde.create(GRID, device="cpu")
    for d, c in frames[:2]:
        state, _ = step(state, d, c)
    before = [t.clone() for t in (*state.grid, state.pose, state.frame,
                                  state.tracking_lost)]
    new, tr = step(state, *frames[2])
    assert bool(tr.valid) and new.frame_host == 3 == int(new.frame)
    after = (*state.grid, state.pose, state.frame, state.tracking_lost)
    unchanged = [torch.equal(a, b) for a, b in zip(before, after)]
    if donate:
        assert all(a is b for a, b in zip(new.grid, state.grid))
        assert not unchanged[1]                 # the weights grew in place
    else:
        assert all(unchanged)
        assert not torch.equal(new.grid.weight, state.grid.weight)


_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist",
          "numpy", "cpu")


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Every Python-level read of a tensor's value (or copy to the host)
    inside the block raises."""
    def refuse(self, *args, **kwargs):
        raise AssertionError("a tensor was read on the host")

    with monkeypatch.context() as m:
        for name in _READS:
            m.setattr(torch.Tensor, name, refuse)
        yield


def test_first_and_replay_frames_read_nothing(monkeypatch):
    """Frame 0 and a trajectory-replay frame (the hint on the device) make
    no host read; a tracked frame reads ``valid``."""
    frames = _frames()
    replay = tde.make_step(dataclasses.replace(CFG, use_trajectory=True),
                           GRID, with_hint=True, donate=False)
    state = tde.create(GRID, device="cpu")
    hint = torch.from_numpy(POSES[1])
    with _no_host_reads(monkeypatch):
        s1, tr0 = tde.make_step(CFG, GRID)(state, *frames[0])
        s2, tr1 = replay(s1, *frames[1], hint)
    assert bool(tr0.valid) and bool(tr1.valid) and s2.frame_host == 2
    assert torch.equal(s2.pose, hint)
    with pytest.raises(AssertionError, match="read on the host"):
        with _no_host_reads(monkeypatch):
            tde.make_step(CFG, GRID, donate=False)(s2, *frames[2])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_first_and_replay_frames_sync_nothing_on_the_card(cuda):
    """On the card, frame 0 and a replay frame (hint on the device) make no
    synchronizing call; a tracked frame makes some (``valid`` and the
    tracker's SVDs)."""
    frames = _frames(cuda)
    replay = tde.make_step(dataclasses.replace(CFG, use_trajectory=True),
                           GRID, with_hint=True, donate=False)
    state = tde.create(GRID, device=cuda)
    hint = torch.from_numpy(POSES[1]).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s1, _ = tde.make_step(CFG, GRID)(state, *frames[0])
        s2, _ = replay(s1, *frames[1], hint)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            tde.make_step(CFG, GRID, donate=False)(s2, *frames[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("gt", [False, True])
def test_run_dense_cli(gt, tmp_path, capsys):
    """``run_dense`` on the CPU, free tracking and ``--gt``, ends with
    ``RESULT: OK`` and writes a PLY with faces. (The 48^3 grid at 2 cm is
    moved to z = 1.4 m so that it holds ``Scene()``'s spheres.)"""
    mesh = tmp_path / "dense.ply"
    argv = ["--frames", "3", "--dims", "48", "--device", "cpu", "--mesh",
            str(mesh), "--origin", "-0.48", "-0.48", "1.4"]
    rc = run_dense.main(argv + (["--gt"] if gt else []))
    out = capsys.readouterr().out
    assert rc == 0 and "RESULT: OK" in out, out
    assert ("ATE RMSE" in out) != gt
    head = mesh.read_bytes()[:300].split(b"end_header")[0].decode()
    faces = int(head.split("element face ")[1].split()[0])
    assert head.startswith("ply") and faces > 1000
