"""Parity of the PyTorch port's image preprocessing with the JAX package.

Tolerance: NaN masks identical; values within rtol 1e-5 (``exp`` in the
bilateral filter may differ by an ulp between the libraries). Normals are
unit vectors whose small components carry the absolute error of the
difference quotient, so theirs is 1e-5 relative to their unit length
(atol 1e-5). Depth erosion, pull-push hole filling and the depth-to-color
remap within 1e-6.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu.config import CameraConfig, FilterConfig
from voxelhashing_tpu.io.synthetic import Scene, kinect_noise, render_depth
from voxelhashing_tpu.ops import image as jimg
from voxelhashing_tpu_torch.convert import config_from
from voxelhashing_tpu_torch.ops import image as timg

CAM = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5)
TCAM = config_from(CAM)


def _frame(seed):
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = -0.05 * seed
    depth, color = render_depth(pose, CAM, Scene())
    depth = kinect_noise(depth, CAM, seed=seed)
    return depth.astype(np.float32), color.astype(np.float32)


def _close(t, j, atol=0.0):
    t, j = t.numpy(), np.asarray(j)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=atol, equal_nan=True)


@pytest.mark.parametrize("depth_filter,color_filter",
                         [(True, False), (False, True)])
def test_preprocess_matches(depth_filter, color_filter):
    depth, color = _frame(1)
    flt = FilterConfig(depth_filter=depth_filter, color_filter=color_filter)
    out_t = timg.preprocess(torch.from_numpy(depth), torch.from_numpy(color),
                            TCAM, config_from(flt))
    out_j = jimg.preprocess(jnp.asarray(depth), jnp.asarray(color), CAM, flt)
    for name in ("depth", "points", "color", "intensity"):
        _close(getattr(out_t, name), getattr(out_j, name))
    _close(out_t.normals, out_j.normals, atol=1e-5)
    assert torch.isnan(out_t.depth).any() and torch.isfinite(out_t.depth).any()


def test_bilateral_and_resample():
    depth, _ = _frame(2)
    depth[10:14, 20:30] = np.nan
    d_t = timg.bilateral_filter_depth(torch.from_numpy(depth), 2.0, 0.1)
    d_j = jimg.bilateral_filter_depth(jnp.asarray(depth), 2.0, 0.1)
    _close(d_t, d_j)
    pts = np.random.default_rng(0).normal(size=(60, 80, 3)).astype(np.float32)
    _close(timg.resample_half(torch.from_numpy(pts)),
           jimg.resample_half(jnp.asarray(pts)))
    assert timg.resample_half(torch.from_numpy(pts)).shape == (30, 40, 3)


@pytest.mark.parametrize("radius,thresh", [(2, 0.1), (1, 0.02)])
def test_erode_depth_matches(radius, thresh):
    depth, _ = _frame(3)
    d_t = timg.erode_depth(torch.from_numpy(depth), radius, thresh)
    d_j = jimg.erode_depth(jnp.asarray(depth), radius, thresh)
    np.testing.assert_array_equal(np.isnan(d_t.numpy()),
                                  np.isnan(np.asarray(d_j)))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6,
                               rtol=0, equal_nan=True)
    # it removed pixels, and kept most of them
    n_in, n_out = np.isfinite(depth).sum(), np.isfinite(d_t.numpy()).sum()
    assert 0.5 * n_in < n_out < n_in


@pytest.mark.parametrize("levels", [5])
def test_fill_holes_pullpush_matches(levels):
    depth, _ = _frame(4)
    depth[20:30, 10:25] = np.nan                  # a hole to fill
    d_t = timg.fill_holes_pullpush(torch.from_numpy(depth), levels=levels)
    d_j = jimg.fill_holes_pullpush(jnp.asarray(depth), levels=levels)
    np.testing.assert_array_equal(np.isnan(d_t.numpy()),
                                  np.isnan(np.asarray(d_j)))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6,
                               rtol=0, equal_nan=True)
    assert np.isfinite(d_t.numpy()[20:30, 10:25]).all()


def test_remap_depth_to_color_matches():
    """The calibration path's remap: depth intrinsics and an extrinsic
    offset into a larger color camera."""
    depth, _ = _frame(5)
    k_d = np.array([[65.0, 0, 39.5, 0], [0, 65.0, 29.5, 0], [0, 0, 1, 0],
                    [0, 0, 0, 1]], np.float32)
    k_c = np.array([[90.0, 0, 55.5, 0], [0, 90.0, 41.5, 0], [0, 0, 1, 0],
                    [0, 0, 0, 1]], np.float32)
    ext_d = np.eye(4, dtype=np.float32)
    ext_d[0, 3] = 0.025
    out_t = timg.remap_depth_to_color(depth, k_d, k_c, 112, 84, ext_d,
                                      np.eye(4, dtype=np.float32))
    out_j = jimg.remap_depth_to_color(depth, k_d, k_c, 112, 84, ext_d,
                                      np.eye(4, dtype=np.float32))
    assert out_t.shape == (84, 112) and out_t.dtype == out_j.dtype
    np.testing.assert_allclose(out_t, out_j, atol=1e-6, rtol=0,
                               equal_nan=True)
    np.testing.assert_array_equal(np.isnan(out_t), np.isnan(out_j))
    assert np.isfinite(out_t).mean() > 0.3
