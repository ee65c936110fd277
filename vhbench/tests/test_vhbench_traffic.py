"""The traffic: the same lap for the same seed, another for another, and
every lap closed."""

import numpy as np
import pytest
import torch

from vhbench.check import _rot_gap
from vhbench.reference.config import CameraConfig
from vhbench.traffic import generator

CAM = CameraConfig(width=64, height=48, fx=52.53, fy=52.53, cx=31.75,
                   cy=23.75)
MIXES = ("room_orbit", "tabletop_orbit", "corridor_sessions",
         "hallway_stream")
LAPS = tuple(m for m in MIXES
             if not generator.load_mix(m).get("sessions", False))


def _lap(mix, seed, frames=6):
    m = generator.load_mix(mix)
    m["path"]["frames"] = frames
    return generator.make_lap(m, CAM, seed, torch.device("cpu"))


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_lap(mix):
    a, b = _lap(mix, 2 ** 33 + 17), _lap(mix, 2 ** 33 + 17)
    assert np.array_equal(a.depth, b.depth)
    assert np.array_equal(a.color, b.color)
    assert np.array_equal(a.poses, b.poses)


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_other_noise(mix):
    a, b = _lap(mix, 5), _lap(mix, 6)
    assert np.array_equal(a.poses, b.poses)
    assert not np.array_equal(a.depth, b.depth)
    valid = (a.depth > 0) & (b.depth > 0)
    assert valid.mean() > 0.3
    # the noise is the mix's sigma, seen where both frames hold depth
    sigma = generator.load_mix(mix)["noise_sigma"]
    d = (a.depth - b.depth)[valid]
    assert abs(d.std() / np.sqrt(2) - sigma) < 0.2 * sigma


@pytest.mark.parametrize("mix", LAPS)
def test_lap_is_closed(mix):
    """The step from the lap's last pose to its first lies between the
    smallest and the largest step inside the lap, and the first pose is
    the identity."""
    poses, _ = generator.lap_poses(generator.load_mix(mix))
    assert np.allclose(poses[0], np.eye(4), atol=1e-6)

    def step(a, b):
        return (np.linalg.norm(a[:3, 3] - b[:3, 3]), _rot_gap(a, b))
    steps = [step(poses[i], poses[i + 1]) for i in range(len(poses) - 1)]
    wrap = step(poses[-1], poses[0])
    for k in (0, 1):
        assert min(s[k] for s in steps) - 1e-6 <= wrap[k] \
            <= max(s[k] for s in steps) + 1e-6


def test_room_steps_are_handheld():
    """At most ~1 cm and ~0.3 degrees a frame: a handheld sway."""
    poses, _ = generator.lap_poses(generator.load_mix("room_orbit"))
    for a, b in zip(poses, np.roll(poses, -1, axis=0)):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 0.01
        assert _rot_gap(a, b) < np.radians(0.32)


def test_sessions_start_at_the_identity_and_walk():
    """A session mix's lap starts where the program starts and moves the
    same step every frame."""
    m = generator.load_mix("corridor_sessions")
    poses, _ = generator.lap_poses(m)
    assert np.allclose(poses[0], np.eye(4), atol=1e-6)
    steps = np.diff(poses[:, :3, 3], axis=0)
    assert np.allclose(steps, steps[0], atol=1e-5)
    assert np.linalg.norm(steps[0]) == pytest.approx(0.03, rel=1e-4)


@pytest.mark.parametrize("sessions", [False, True], ids=["laps", "sessions"])
def test_check_frames_hold_a_starve_a_maintain_and_a_session_start(
        sessions):
    """The check frames after the window hold a starve frame, a frame on
    which the maintenance is decided and, under sessions, the next
    session's first two frames; they are the same for the same seed."""
    from vhbench import check
    lap, first = 240, 5100

    def host_index(k):
        return k % lap if sessions else k
    picks = check.check_frames(2 ** 33 + 1, first, 15, 32, host_index, lap)
    assert picks == check.check_frames(2 ** 33 + 1, first, 15, 32,
                                       host_index, lap)
    span = [k for k in picks if k < first + check.CHECK_SPAN]
    assert len(span) == check.CHECK_FRAMES and min(picks) >= first
    assert any(host_index(k) % 15 == 0 for k in span)
    assert any(host_index(k) % 32 == 0 for k in span)
    starts = [k for k in picks if host_index(k) == 0]
    if sessions:
        assert starts == [5280] and 5281 in picks
    else:
        assert starts == [] and len(picks) == check.CHECK_FRAMES


def test_out_back_walks_out_and_retraces_its_way():
    """``out_back`` walks half the lap out and retraces it: the farthest
    pose at the middle frame, each pose of the way back on the way out,
    every step the same length."""
    mix = generator.load_mix("hallway_stream")
    poses, _ = generator.lap_poses(mix)
    n = len(poses)
    step = np.asarray(mix["path"]["step"])
    assert np.allclose(poses[n // 2][:3, 3], (n // 2) * step, atol=1e-5)
    for i in range(1, n // 2):
        assert np.allclose(poses[n - i], poses[i], atol=1e-6)
    steps = np.linalg.norm(np.diff(np.concatenate(
        [poses[:, :3, 3], poses[:1, :3, 3]]), axis=0), axis=1)
    assert np.allclose(steps, np.linalg.norm(step), atol=1e-5)
