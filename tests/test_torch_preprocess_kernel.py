"""The depth preprocess's plain version (``ops/preprocess.py``), the CPU
path of ``image.preprocess`` and the reference the card's
``preprocess_kernel`` is held to, against the parent's steps and the JAX
package.

Tolerances: against the steps it was moved from (the range gate,
``image.bilateral_filter_depth``, ``geometry.depth_to_points`` and
``normals_from_points``, ``image.color_to_intensity``), bit for bit.
Against JAX, those of ``tests/test_torch_image.py``: NaN masks identical,
values within rtol 1e-5 (``exp`` may differ by an ulp between the
libraries), normals also atol 1e-5 (their small components carry the
absolute error of the difference quotient). The kernel against the plain
version on the card is bit-equal (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import config as jcfg
from voxelhashing_tpu.io.synthetic import Scene, kinect_noise, render_depth
from voxelhashing_tpu.ops import image as jimg
from voxelhashing_tpu_torch import geometry as geom
from voxelhashing_tpu_torch.config import CameraConfig, FilterConfig
from voxelhashing_tpu_torch.ops import image as timg
from voxelhashing_tpu_torch.ops import preprocess as pp

CAM = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(seed):
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = -0.05 * seed
    jcam = jcfg.CameraConfig(**dataclasses.asdict(CAM))
    depth, color = render_depth(pose, jcam, Scene())
    depth = kinect_noise(depth, jcam, seed=seed)
    return depth.astype(np.float32), color.astype(np.float32)


def _bits(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _parent_steps(depth_raw, color_raw, cam, flt):
    """The steps ``image.preprocess`` ran before the kernel, one by one."""
    depth = torch.where(
        torch.isfinite(depth_raw)
        & (depth_raw >= cam.depth_min) & (depth_raw <= cam.depth_max),
        depth_raw, torch.nan)
    if flt.depth_filter:
        depth = timg.bilateral_filter_depth(depth, flt.depth_sigma_d,
                                            flt.depth_sigma_r)
    color, intensity = color_raw, None
    if color_raw is not None:
        if flt.color_filter:
            color = torch.stack(
                [timg.gauss_filter_depth(color_raw[..., i],
                                         flt.color_sigma_d,
                                         flt.color_sigma_r)
                 for i in range(3)], dim=-1)
        intensity = timg.color_to_intensity(color)
    points = geom.depth_to_points(depth, cam)
    return depth, points, geom.normals_from_points(points), color, intensity


def _close(t, j, atol=0.0):
    t, j = t.numpy(), np.asarray(j)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=atol, equal_nan=True)


def _against_jax(out, depth, color, cam, flt):
    jout = jimg.preprocess(jnp.asarray(depth),
                           None if color is None else jnp.asarray(color),
                           jcfg.CameraConfig(**dataclasses.asdict(cam)),
                           jcfg.FilterConfig(**dataclasses.asdict(flt)))
    for name in ("depth", "points"):
        _close(getattr(out, name), getattr(jout, name))
    _close(out.normals, jout.normals, atol=1e-5)
    if color is None:
        assert out.intensity is None and jout.intensity is None
    else:
        _close(out.intensity, jout.intensity)
        _close(out.color, jout.color)


@pytest.mark.parametrize("flt", [FilterConfig(),
                                 FilterConfig(depth_filter=False),
                                 FilterConfig(color_filter=True)],
                         ids=["bilateral", "no_filter", "color_filter"])
def test_plain_is_the_parent_steps_and_the_call_path(flt):
    """``preprocess_plain`` equals the parent's steps bit for bit, and
    ``image.preprocess`` on CPU tensors is ``preprocess_plain``, with no
    launch and no plain call counted on the card."""
    depth, color = (torch.from_numpy(a) for a in _frame(1))
    before = (pp.preprocess_depth.launches, pp.preprocess_plain.cuda_calls)
    out = pp.preprocess_plain(depth, color, CAM, flt)
    via = timg.preprocess(depth, color, CAM, flt)
    for got, ref in zip((out.depth, out.points, out.normals, out.color,
                         out.intensity),
                        _parent_steps(depth, color, CAM, flt)):
        _bits(got, ref)
    for name in ("depth", "points", "normals", "color", "intensity"):
        _bits(getattr(via, name), getattr(out, name))
    assert (pp.preprocess_depth.launches,
            pp.preprocess_plain.cuda_calls) == before
    assert torch.isfinite(out.depth).sum() > 0.5 * out.depth.numel()


@pytest.mark.parametrize("seed", [2])
def test_plain_matches_jax(seed):
    depth, color = _frame(seed)
    depth[10:14, 20:30] = np.nan
    out = pp.preprocess_plain(torch.from_numpy(depth),
                              torch.from_numpy(color), CAM, FilterConfig())
    _against_jax(out, depth, color, CAM, FilterConfig())


@pytest.mark.parametrize("case", pp.EDGE_CASES)
def test_edge_bank_plain_matches_jax_and_parent(case):
    """Each edge-bank frame (NaN, +-inf, 0, negative, out-of-range and
    boundary depths, an all-invalid frame, an odd frame smaller than a
    tile, the filter off, no color, the widest window) through the plain
    version: the parent's steps bit for bit, JAX within the tolerances."""
    e = next(x for x in pp.edge_bank() if x["case"] == case)
    d, c = pp.edge_frame(e, "cpu")
    out = pp.preprocess_plain(d, c, e["cam"], e["flt"])
    for got, ref in zip((out.depth, out.points, out.normals, out.color,
                         out.intensity),
                        _parent_steps(d, c, e["cam"], e["flt"])):
        _bits(got, ref)
    _against_jax(out, e["depth"], e["color"], e["cam"], e["flt"])
    valid = int(torch.isfinite(out.depth).sum())
    assert valid == 0 if case == "all_invalid" else valid > 0
    if case == "wide_window":
        assert pp.filter_radius(e["flt"]) == pp.MAX_RADIUS


def test_wrapper_refuses_other_devices_and_wide_windows():
    meta = torch.device("meta")
    depth = torch.zeros(CAM.height, CAM.width, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        pp.preprocess_depth(depth, None, CAM, FilterConfig())
    with pytest.raises(ValueError, match="no kernel"):
        timg.preprocess(depth, None, CAM, FilterConfig())
    # what prepare checks before it touches a card
    cpu = torch.zeros(CAM.height, CAM.width)
    with pytest.raises(ValueError, match="window"):
        pp.prepare(cpu, None, CAM, FilterConfig(depth_sigma_d=4.5))
    with pytest.raises(ValueError, match="depth must be f32"):
        pp.prepare(cpu[:, :-1], None, CAM, FilterConfig())
    with pytest.raises(ValueError, match="color must be f32"):
        pp.prepare(cpu, torch.zeros(CAM.height, CAM.width, 4), CAM,
                   FilterConfig())


def test_spatial_weights_are_the_plain_filters():
    """The kernel's spatial weights are the plain loop's, in its (dy, dx)
    order, as f32."""
    import math
    flt = FilterConfig(depth_sigma_d=1.5)
    w = pp.spatial_weights(flt)
    r = pp.filter_radius(flt)
    assert r == 3 and w.dtype == np.float32 and w.size == 49
    k = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            assert w[k] == np.float32(math.exp(-(dx * dx + dy * dy) / 4.5))
            k += 1


def test_bound_counts():
    """The bound's hand counts, and the work counted on a frame: every
    valid centre pairs with itself, each point comes from a valid
    centre."""
    assert pp.bytes_moved(100, False) == 3200
    assert pp.bytes_moved(100, True) == 4800
    assert pp.operations(10, 2, 3, 4, 5) == (
        pp.TAP_OPS * 10 + pp.CENTRE_OPS * 2 + pp.POINT_OPS * 3
        + pp.NORMAL_OPS * 4 + pp.INT_OPS * 5)
    depth, color = (torch.from_numpy(a) for a in _frame(3))
    out = pp.preprocess_plain(depth, color, CAM, FilterConfig())
    n_pairs, n_valid, n_points, n_normals, n_int = pp.work_counts(
        depth, CAM, FilterConfig(), out)
    assert n_valid <= n_pairs <= 81 * n_valid
    assert n_points == int(torch.isfinite(out.depth).sum()) <= n_valid
    assert 0 < n_normals <= n_points and n_int == depth.numel()


@pytest.mark.parametrize("hw,sms", [((240, 320), 132), ((480, 640), 132),
                                    ((33, 40), 132), ((47, 53), 132),
                                    ((13, 17), 132), ((60, 80), 8),
                                    ((1, 1), 132)])
def test_tile_grid_tiles_every_pixel_once(hw, sms):
    """The launch's grid (``tile_grid``): the CTAs' pixel ranges (the
    kernel's floor(b w / g) splits) cover the frame once, no tile is wider
    or taller than the kernel's shared memory holds, a filtered tile (the
    tile and its halo) fits the CTA's threads, and the CTAs are at most a
    multiple of the SMs; 320x240 on 132 SMs is 12 x 11 CTAs, one an SM."""
    h, w = hw
    gx, gy = pp.tile_grid(h, w, sms)
    xs = [bx * w // gx for bx in range(gx + 1)]
    ys = [by * h // gy for by in range(gy + 1)]
    assert xs[0] == 0 and xs[-1] == w and ys[0] == 0 and ys[-1] == h
    tw = max(b - a for a, b in zip(xs, xs[1:]))
    th = max(b - a for a, b in zip(ys, ys[1:]))
    assert min(b - a for a, b in zip(xs, xs[1:])) >= max(1, tw - 1)
    assert tw <= pp.MAX_TILE[0] and th <= pp.MAX_TILE[1]
    assert (tw + 2) * (th + 2) <= pp.FILTER_THREADS
    k = -(-gx * gy // sms)
    assert gx * gy <= k * sms and gx <= w and gy <= h
    if (h, w) == (240, 320):
        assert (gx, gy) == (12, 11) and (tw, th) == (27, 22)


def _rn32(s, e):
    """f32 round to nearest of the exact s + e (s f64, e its error)."""
    r = s.astype(np.float32)
    d = s - r.astype(np.float64)
    nb = np.nextafter(r, np.where(d > 0, np.float32(np.inf),
                                  np.float32(-np.inf))).astype(np.float32)
    half = np.abs(nb.astype(np.float64) - r.astype(np.float64)) * 0.5
    tie = (np.abs(d) == half) & (d != 0) & (e != 0) & (np.sign(e)
                                                       == np.sign(d))
    return np.where(tie, nb, r)


def _fma32(a, b, c):
    """f32 fma: the product exact in f64, the sum with its error (two-sum)
    rounded once."""
    p = a.astype(np.float64) * np.float64(b)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    return _rn32(s, (p - (s - bb)) + (c64 - bb))


def _div_rn_recip(x, c, y):
    """``csrc/preprocess.cu``'s div_rn_recip in exact f32 arithmetic."""
    q0 = (x.astype(np.float64) * np.float64(y)).astype(np.float32)
    q1 = _fma32(_fma32(-q0, c, x), y, q0)
    return _fma32(_fma32(-q1, c, x), y, q1)


@pytest.mark.parametrize("sigma_r", [0.1, 0.05, 0.01, 0.7, 1.0, 3.0])
def test_recip_division_is_the_ieee_quotient_on_its_range(sigma_r):
    """The kernel's division by c = 2 sigma_r^2 through y = RN(1/c), two
    fma corrections (the second by Markstein's theorem), modelled in exact
    f32 arithmetic on numpy: bit-equal to the IEEE quotient x / c on 300K
    x drawn over the clamp ``division_clamp`` gives and at its ends (the
    default sigma_r 0.1 and the edge bank's 0.05 and 1 among them; the
    card checks every x). The clamp's ends are exact floats with x / c at
    most 2^-26 at the low end (where expf(-q) is 1) and at least 2^26 at
    the high end (where it is 0); a sigma_r whose c leaves [2^-70, 2^100]
    raises, and without the filter the clamp is (0, 0)."""
    flt = FilterConfig(depth_sigma_r=sigma_r)
    c = np.float32(pp.two_sr2(flt))
    y = np.float32(1.0) / c
    rng = np.random.default_rng(11)
    lo, hi = pp.division_clamp(flt)
    lo_b, hi_b = np.float32(lo), np.float32(hi)
    assert float(lo_b) == lo and float(hi_b) == hi
    assert lo / float(c) <= 2.0 ** -26 and hi / float(c) >= 2.0 ** 26
    bits = rng.integers(lo_b.view(np.int32), hi_b.view(np.int32),
                        300_000).astype(np.int32)
    ends = np.concatenate([lo_b.view(np.int32) + np.arange(64),
                           hi_b.view(np.int32) - np.arange(64)])
    x = np.concatenate([bits.view(np.float32),
                        ends.astype(np.int32).view(np.float32)]).astype(
                            np.float32)
    got = _div_rn_recip(x, c, y)
    ref = x / c
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    assert pp.division_clamp(dataclasses.replace(
        flt, depth_filter=False)) == (0.0, 0.0)
    for bad in (1e-22, 1e16):
        with pytest.raises(ValueError, match="sigma_r"):
            pp.division_clamp(FilterConfig(depth_sigma_r=bad))
