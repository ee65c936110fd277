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
