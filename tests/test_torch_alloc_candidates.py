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


def _footprint_pool(pv, tile, phase, order_rng=None):
    """Tile mode's band depths as the kernel pools them (``csrc``
    ``alloc_candidates_kernel``, phases 1-2): each CTA stages its footprint
    (``pv``, the depth where a pixel counts, NaN where not and off the
    frame), and each ray of a column and of its halo reduces the tile at the
    phase from it with fminf / fmaxf (NaN skipped), the pixels in a random
    order when ``order_rng`` is given. Returns (lo, hi) [rows, cols] and
    the footprint pixels read, one bool array [fh, fw] a CTA."""
    h, w = pv.shape
    rows, cols = h // tile, w // tile
    (r_, c_), (fh, fw) = ac.BLOCK[2], ac.footprint(tile)
    py, px = phase % tile, (phase // tile) % tile
    lo = np.full((rows, cols), np.nan, np.float32)
    hi = np.full((rows, cols), np.nan, np.float32)
    reads = []
    gy, gx = ac.cta_grid(rows, cols, True)
    ii, jj = np.meshgrid(np.arange(fh), np.arange(fw), indexing="ij")
    hr, hc = np.meshgrid(np.arange(r_ + 1), np.arange(c_ + 1), indexing="ij")
    ti, tj = np.meshgrid(np.arange(tile), np.arange(tile), indexing="ij")
    # the footprint's rows and columns each halo column's tile reads
    wi = (hr * tile + py)[:, :, None, None] + ti
    wj = (hc * tile + px)[:, :, None, None] + tj
    assert wi.max() < fh and wj.max() < fw
    for by in range(gy):
        for bx in range(gx):
            r0, c0 = by * r_ - 1, bx * c_ - 1
            y, x = r0 * tile + ii, c0 * tile + jj
            on = (y >= 0) & (y < h) & (x >= 0) & (x < w)
            fp = np.where(on, pv[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)],
                          np.float32(np.nan)).astype(np.float32)
            row, col = r0 + hr, c0 + hc
            grid = (row >= 0) & (row < rows) & (col >= 0) & (col < cols)
            read = np.zeros((fh, fw), bool)
            read[wi[grid], wj[grid]] = True
            win = fp[wi, wj].reshape(r_ + 1, c_ + 1, -1)
            if order_rng is not None:
                perm = np.argsort(order_rng.random(win.shape), axis=-1)
                win = np.take_along_axis(win, perm, axis=-1)
            a = np.fmin.reduce(win, axis=-1, initial=np.float32(np.inf))
            b = np.fmax.reduce(win, axis=-1, initial=np.float32(-np.inf))
            for out, val in ((lo, a), (hi, b)):
                got = out[row[grid], col[grid]]
                # a column's rays, computed again as a neighbour's halo,
                # give the same bits
                assert np.all(np.isnan(got)
                              | (got.view(np.int32)
                                 == val[grid].view(np.int32)))
                out[row[grid], col[grid]] = val[grid]
            reads.append(read)
    return lo, hi, reads


@pytest.mark.parametrize("tile", [*range(2, 17), ac.STAGE_TILE])
def test_footprint_covers_the_pooled_pixels(tile):
    """The staged footprint of tile mode, modelled in numpy: at every phase
    0..tile^2-1, each column's tile at the phase lies inside its CTA's
    footprint and pools exactly the pixels ``_tile_rays`` pools (its min
    and max equal, on depths that differ at every pixel, with the pixels
    that wrap and the invalid ones sitting out); over the phases the reads
    cover the whole footprint of an interior CTA; and the min and max do
    not depend on the order of the pixels. The key grid (9 x 11 columns) is
    not a multiple of a CTA's 4 x 8. Tiles 2-16 and 30, the largest whose
    footprint the kernel stages."""
    h, w = 9 * tile, 11 * tile
    rng = np.random.default_rng(tile)
    depth = (1.0 + rng.permutation(h * w).reshape(h, w) * 1e-4).astype(
        np.float32)
    depth[rng.random((h, w)) < 0.2] = np.nan
    cam = dataclasses.replace(TCAM, width=w, height=h, cx=w / 2.0,
                              cy=h / 2.0)
    pv = np.where(np.isfinite(depth) & (depth > 0)
                  & (depth < TCFG.max_integration_distance), depth,
                  np.float32(np.nan)).astype(np.float32)
    union = None
    for phase in range(tile * tile):
        lo, hi, reads = _footprint_pool(pv, tile, phase)
        union = reads[0] if union is None else union | reads[0]
        dmin, dmax, any_v, _, _ = ac._tile_rays(torch.from_numpy(depth),
                                                cam, TCFG, tile, phase)
        any_v = any_v.numpy().reshape(lo.shape)
        assert np.array_equal(np.isfinite(lo), any_v)
        np.testing.assert_array_equal(
            np.where(any_v, lo, 1.0), dmin.numpy().reshape(lo.shape))
        np.testing.assert_array_equal(
            np.where(any_v, hi, 1.0), dmax.numpy().reshape(lo.shape))
    # CTA (0, 0) reads the whole footprint but its west and north halo
    # rows and columns (off the grid); an interior CTA would read it all
    fh, fw = ac.footprint(tile)
    assert union[tile:, tile:].all() and not union[:tile, :].any()
    assert not union[:, :tile].any() and union.shape == (fh, fw)
    # the pool's bits in another order of the pixels, at two phases
    for phase in (0, tile * tile - 1):
        lo, hi, _ = _footprint_pool(pv, tile, phase)
        lo2, hi2, _ = _footprint_pool(pv, tile, phase,
                                      np.random.default_rng(phase))
        assert np.array_equal(lo.view(np.int32), lo2.view(np.int32))
        assert np.array_equal(hi.view(np.int32), hi2.view(np.int32))
