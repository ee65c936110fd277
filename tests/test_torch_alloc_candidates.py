"""The allocator's candidates' plain version (``ops/alloc_candidates.py``),
the CPU path of ``integrate.alloc_candidates`` and the reference the
card's ``alloc_candidates_kernel`` is held to, against the JAX package.

Tolerance: none. The flat int32 keys equal JAX's
(``voxelhashing_tpu.integrate.alloc_candidates``, jitted with the phase
traced) position for position: the layouts agree ([fold, rows, cols]
flattened, the j-th surviving key of a column in slot j), and every float
operation before a key is the same IEEE operation in both. The kernel
against the plain version on the card is position for position too
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import config as jcfg
from voxelhashing_tpu import integrate as jint
from voxelhashing_tpu.io.synthetic import Scene, make_trajectory, render_depth
from voxelhashing_tpu_torch import convert, integrate as tint
from voxelhashing_tpu_torch.geometry import INVALID_KEY
from voxelhashing_tpu_torch.ops import alloc_candidates as ac

CAM = jcfg.CameraConfig(width=128, height=96, fx=104.0, fy=104.0, cx=63.5,
                        cy=47.5)
CFG = jcfg.MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                     num_blocks=4096, table_size=16384,
                     max_active_blocks=4096)
TCAM, TCFG = convert.config_from(CAM), convert.config_from(CFG)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_keys(depth, pose, cam, cfg, tile, phase, model_depth):
    return jint.alloc_candidates(depth, pose, cam, cfg, tile=tile,
                                 phase=phase, model_depth=model_depth)


def _jax(depth, pose, cam, cfg, tile, phase, model):
    """JAX's keys, the phase traced (one compile a configuration)."""
    return np.asarray(_jax_keys(
        jnp.asarray(depth), jnp.asarray(pose),
        jcfg.CameraConfig(**dataclasses.asdict(cam)),
        jcfg.MapConfig(**dataclasses.asdict(cfg)), tile,
        None if phase is None else jnp.int32(phase),
        None if model is None else jnp.asarray(model)))


def _scene_frame():
    poses = make_trajectory(6)
    depth, _ = render_depth(poses[5], CAM, Scene(), noise_sigma=0.002,
                            seed=5)
    depth = depth.astype(np.float32)
    model = depth + np.random.default_rng(0).normal(
        0, 0.03, depth.shape).astype(np.float32)
    return depth, model, poses[5].astype(np.float32)


def _plain(depth, pose, cam, cfg, tile, phase, model, device_phase=False):
    if device_phase and phase is not None:
        phase = torch.tensor(phase, dtype=torch.int32)
    return ac.alloc_candidates_plain(
        torch.from_numpy(depth), torch.from_numpy(pose), cam, cfg, tile,
        phase, None if model is None else torch.from_numpy(model)).numpy()


@pytest.mark.parametrize("tile,phase,novelty",
                         [(1, None, False), (4, None, False), (4, 7, True)])
def test_plain_is_the_call_path(tile, phase, novelty):
    """``integrate.alloc_candidates`` on CPU tensors is the plain version,
    with no launch and no plain call counted on the card."""
    depth, model, pose = _scene_frame()
    m = torch.from_numpy(model) if novelty else None
    args = (torch.from_numpy(depth), torch.from_numpy(pose), TCAM, TCFG)
    before = (ac.alloc_candidates.launches,
              ac.alloc_candidates_plain.cuda_calls)
    via = tint.alloc_candidates(*args, tile=tile, phase=phase,
                                model_depth=m)
    ref = ac.alloc_candidates_plain(*args, tile=tile, phase=phase,
                                    model_depth=m)
    assert torch.equal(via, ref) and via.dtype == torch.int32
    assert (ac.alloc_candidates.launches,
            ac.alloc_candidates_plain.cuda_calls) == before
    _, rows, cols, slots, _ = ac.layout(args[0], TCFG, tile)
    assert via.numel() == slots * rows * cols
    assert int((via != INVALID_KEY).sum()) > 50


@pytest.mark.parametrize("mode", ["pixel", "tile", "tile_novelty"])
def test_plain_matches_jax_position_for_position(mode):
    """Pixel mode, and tile mode at phases 0-15, each as a host int and as
    a 0-dim int32 tensor, with novelty off and on: the keys equal JAX's
    position for position."""
    depth, model, pose = _scene_frame()
    tile = 1 if mode == "pixel" else 4
    m = model if mode == "tile_novelty" else None
    phases = (None,) if mode == "pixel" else tuple(range(16))
    for phase in phases:
        jk = _jax(depth, pose, TCAM, TCFG, tile, phase, m)
        for device_phase in ((False,) if phase is None else (False, True)):
            tk = _plain(depth, pose, TCAM, TCFG, tile, phase, m,
                        device_phase)
            np.testing.assert_array_equal(tk, jk)
        assert (jk != INVALID_KEY).sum() > 50


@pytest.mark.parametrize("case", ac.EDGE_CASES)
def test_edge_bank_plain_matches_jax(case):
    """Each edge-bank frame (rays leaving the world box, depths at and
    beyond ``max_integration_distance``, NaN, +-inf, 0 and negative
    depths, an all-invalid frame, a frame no tile divides, axis-aligned
    rays) in pixel and tile mode at each phase, as a host int and as a
    device-style int32 tensor, with novelty off and on: JAX's keys
    position for position."""
    e = next(x for x in ac.edge_bank() if x["case"] == case)
    cam, cfg = e["cam"], e["cfg"]
    n_valid = 0
    for tile in (1, e["tile"]):
        for phase in e["phases"]:
            for model in (None, e["model_depth"]):
                jk = _jax(e["depth"], e["pose"], cam, cfg, tile, phase,
                          model)
                for dp in ((False,) if phase is None else (False, True)):
                    np.testing.assert_array_equal(
                        _plain(e["depth"], e["pose"], cam, cfg, tile, phase,
                               model, dp), jk)
                n_valid += int((jk != INVALID_KEY).sum())
    assert n_valid == 0 if case == "all_invalid" else n_valid > 0
    if case == "no_tile_divides":
        assert not ac.tile_mode(torch.from_numpy(e["depth"]), e["tile"])
    if case == "axis_aligned":
        # the principal point is a pixel centre: that ray has dx = dy = 0
        assert float(cam.cx) == 13.5 and np.array_equal(e["pose"],
                                                        np.eye(4))


def test_wrapper_refuses_other_devices_and_bad_inputs():
    meta = torch.device("meta")
    depth = torch.zeros(24, 32, device=meta)
    pose = torch.eye(4, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        ac.alloc_candidates(depth, pose, TCAM, TCFG, tile=4, phase=3)
    with pytest.raises(ValueError, match="no kernel"):
        tint.alloc_candidates(depth, pose, TCAM, TCFG)
    # what prepare checks before it touches a card
    d = torch.zeros(24, 32)
    with pytest.raises(ValueError, match="steps"):
        ac.prepare(d, torch.eye(4), TCAM,
                   dataclasses.replace(TCFG, alloc_steps=17))
    with pytest.raises(ValueError, match="pose"):
        ac.prepare(d, torch.eye(4, dtype=torch.float64), TCAM, TCFG)
    with pytest.raises(ValueError, match="phase"):
        ac.prepare(d, torch.eye(4), TCAM, TCFG, tile=4,
                   phase=torch.tensor(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="depth must be f32"):
        ac.prepare(d.double(), torch.eye(4), TCAM, TCFG)


def test_layout_and_bound_counts():
    """The output layout of each mode and the bound's hand counts."""
    d = torch.zeros(24, 32)
    assert ac.layout(d, TCFG, 4) == (True, 6, 8, 8, True)
    assert ac.layout(d, TCFG, 1) == (False, 24, 32, 4, True)
    assert ac.layout(torch.zeros(22, 30), TCFG, 4) == (False, 22, 30, 4,
                                                        True)
    # no fold: every step slot kept
    wide = dataclasses.replace(TCFG, alloc_fold_tile=16, alloc_fold=8)
    assert ac.layout(d, wide, 4) == (True, 6, 8, 16, False)
    assert ac.layout(d, wide, 1) == (False, 24, 32, 8, False)
    assert ac.bytes_moved(100, 10, False) == 400 + 68 + 40
    assert ac.bytes_moved(100, 10, True) == 800 + 68 + 40
    assert ac.operations(100, 3, 20, 16, True, True) == (
        100 * (ac.PIXEL_OPS + ac.NOVELTY_OPS + ac.POOL_OPS)
        + ac.RAY_OPS * 3 + ac.STEP_OPS * 20
        + (ac.DEDUP_OPS + ac.FOLD_OPS) * 16)
    depth, model, pose = _scene_frame()
    args = (torch.from_numpy(depth), torch.from_numpy(pose), TCAM, TCFG)
    n_px, n_rays, n_steps, n_in, tiled, novelty = ac.work_counts(
        *args, 4, 3, torch.from_numpy(model))
    assert tiled and novelty and n_px == depth.size
    assert 0 < n_rays <= n_steps <= TCFG.alloc_steps * n_rays
    assert n_in == 2 * TCFG.alloc_steps * (depth.size // 16)
    px = ac.work_counts(*args, 1)
    assert not px[4] and px[3] == TCFG.alloc_steps * depth.size
    assert px[1] <= int(np.isfinite(depth).sum())
