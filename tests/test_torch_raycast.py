"""Parity of the PyTorch port's splat renderer with the JAX package's
``render_splat`` (XLA ``_splat_zbuf`` path on the CPU).

Tolerance: coverage identical apart from at most 1e-4 of the pixels (a
projection exactly on a pixel boundary may round the other way); depth
and points within 1e-5 m elsewhere; normals, central differences of the
points, within 1e-3 on 99.9% of the pixels where both are valid (a pixel
whose depth differs changes its neighbours' differences). Color ties are
decided by one rule, checked exactly: the largest flat index (active-list
position * 512 + voxel) gives the pixel its color.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import blockmap as jbm, geometry as jgeom
from voxelhashing_tpu import integrate as jint, raycast as jray
from voxelhashing_tpu.config import CameraConfig, MapConfig, RaycastConfig
from voxelhashing_tpu.io.synthetic import Scene, make_trajectory, render_depth
from voxelhashing_tpu_torch import blockmap as tbm, convert, raycast as tray
from voxelhashing_tpu_torch import geometry as tgeom
from voxelhashing_tpu_torch.ops import splat_zbuf as sb
from voxelhashing_tpu_torch.ops.splat_zbuf import splat_zbuf

CAM = CameraConfig(width=128, height=96, fx=104.0, fy=104.0, cx=63.5,
                   cy=47.5)
CFG = MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                num_blocks=4096, table_size=16384, max_active_blocks=4096,
                world_blocks=1024)
TCAM, TCFG = convert.config_from(CAM), convert.config_from(CFG)
POSES = make_trajectory(6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core, and idle
    OpenMP threads spinning beside the other workers cost far more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def jstate():
    js = jbm.create(CFG)
    for i in (0, 2, 4):
        d, c = render_depth(POSES[i], CAM, Scene(), noise_sigma=0.002, seed=i)
        js, _ = jint.allocate_from_depth(js, jnp.asarray(d),
                                         jnp.asarray(POSES[i]), CAM, CFG)
        js = jint.integrate(js, jnp.asarray(d), jnp.asarray(c),
                            jnp.asarray(POSES[i]), CAM, CFG)
    return js


def _compare_depth(dt, dj):
    dt, dj = dt.numpy(), np.asarray(dj)
    cover_t, cover_j = np.isfinite(dt), np.isfinite(dj)
    assert (cover_t != cover_j).mean() <= 1e-4
    both = cover_t & cover_j
    assert both.mean() > 0.3
    close = np.abs(dt - dj) <= 1e-5
    assert (~close[both]).mean() <= 1e-4
    return both & close


@pytest.mark.parametrize("with_color", [False, True])
def test_render_splat_matches(jstate, with_color):
    pose = POSES[5]
    rc = RaycastConfig(mode="splat")
    out_j = jray.render_splat(jstate, jnp.asarray(pose), CAM, CFG, rc,
                              with_color=with_color)
    out_t = tray.render_splat(
        convert.map_state_from_numpy(jstate, device="cpu"),
                              _t(pose), TCAM, TCFG, convert.config_from(rc),
                              with_color=with_color)
    agree = _compare_depth(out_t.depth, out_j.depth)
    np.testing.assert_allclose(out_t.points.numpy()[agree],
                               np.asarray(out_j.points)[agree], atol=1e-5)
    n_t, n_j = out_t.normals.numpy(), np.asarray(out_j.normals)
    nboth = np.isfinite(n_t[..., 0]) & np.isfinite(n_j[..., 0])
    assert (np.abs(n_t[nboth] - n_j[nboth]).max(axis=-1) < 1e-3).mean() \
        > 0.999
    assert int(out_t.splat_overflow) == int(out_j.splat_overflow)
    if with_color:
        diff = np.abs(out_t.color.numpy()[agree]
                      - np.asarray(out_j.color)[agree])
        assert (diff > 1.5 / 255).mean() < 1e-3


def test_kernel_wrapper_plain_on_cpu(jstate):
    """On CPU tensors the kernel wrapper runs its plain version: the
    z-buffer of the whole active list with the surface mask equals the
    JAX z-buffer of the culled list."""
    pose = POSES[3]
    view_j = jgeom.invert_rigid(jnp.asarray(pose))
    aidx, n_act, _ = jbm.compactify(jstate, view_j, CAM, CFG)
    mask = jnp.arange(aidx.shape[0]) < n_act
    has_surf = jstate.surf[aidx] & mask
    zj, _ = jray._splat_zbuf(jstate, jstate.sdf[aidx], jstate.weight[aidx],
                             aidx, has_surf, view_j, CAM, CFG, False)
    ts = convert.map_state_from_numpy(jstate, device="cpu")
    before = splat_zbuf.launches
    zt = splat_zbuf(ts, _t(aidx), _t(has_surf), _t(np.asarray(view_j)),
                    TCAM, TCFG)
    assert splat_zbuf.launches == before        # CPU: no kernel launch
    zt, zj = zt.numpy(), np.asarray(zj)
    assert np.isfinite(zj).sum() > 1000
    assert (np.isfinite(zt) != np.isfinite(zj)).mean() <= 1e-4
    both = np.isfinite(zt) & np.isfinite(zj)
    assert (np.abs(zt[both] - zj[both]) > 1e-5).mean() <= 1e-4


def test_color_tie_goes_to_largest_flat_index(jstate):
    """A surface row copied into a free pool slot with another color gives
    bit-equal z_surf ties at every pixel the row hits. Listed after the
    original, the copy's color wins every such pixel and no other; listed
    before it, nothing changes. ``splat_color_plain``, the color render's
    wrapper (CPU: its plain version) and
    ``splat_zbuf_plain(with_color=True)`` agree."""
    ts = convert.map_state_from_numpy(jstate, device="cpu")
    view = tgeom.invert_rigid(_t(POSES[3]))
    aidx, n, _ = tbm.compactify(ts, view, TCAM, TCFG)
    n = int(n)
    surf = ts.surf[aidx.long()] & (torch.arange(aidx.shape[0]) < n)
    zbuf, col0 = sb.splat_zbuf_plain(ts, aidx, surf, view, TCAM, TCFG,
                                     with_color=True)
    # the surface row with the most hits
    pos, pix, z_surf, ok = sb.splat_targets(ts, aidx, surf, view, TCAM,
                                            TCFG)
    hits = ok & (zbuf[torch.clamp(pix, 0, zbuf.shape[0] - 1)] == z_surf)
    r = int(pos[torch.argmax(hits.sum(dim=1))])
    hit_pix = torch.unique(pix[pos == r][hits[pos == r]])
    assert hit_pix.numel() > 5
    src = int(aidx[r])
    free = int(torch.nonzero(ts.block_key == tgeom.INVALID_KEY)[0])
    for f in ("block_key", "sdf", "weight", "surf"):
        getattr(ts, f)[free] = getattr(ts, f)[src]
    ts.color[free] = 0x123456
    for at, changed in ((n, True), (int(torch.nonzero(~surf[:r])[0]), False)):
        a2 = aidx.clone()
        a2[at] = free
        s2 = ts.surf[a2.long()] & (torch.arange(a2.shape[0]) < max(n, at + 1))
        z2, col = sb.splat_zbuf_plain(ts, a2, s2, view, TCAM, TCFG,
                                      with_color=True)
        assert torch.equal(z2.view(torch.int32), zbuf.view(torch.int32))
        assert torch.equal(sb.splat_color_plain(ts, a2, s2, view, TCAM, TCFG,
                                                z2), col)
        zw, cw = sb.splat_zbuf_color(ts, a2, s2, view, TCAM, TCFG)
        assert torch.equal(zw.view(torch.int32), z2.view(torch.int32))
        assert torch.equal(cw, col)
        diff = torch.nonzero(col != col0).reshape(-1)
        if changed:
            assert torch.equal(diff, hit_pix)
            assert (col[hit_pix] == 0x123456).all()
        else:
            assert diff.numel() == 0


@pytest.mark.parametrize("case", ["state", "tie"])
def test_splat_keys_decode_to_plain_render(jstate, case):
    """The color walk's 64-bit key rule in plain torch: the min of
    (z_surf bits << 32 | 0xFFFFFFFF - flat index) per pixel
    (``splat_keys_plain``), decoded (``splat_resolve_plain``), equals
    ``splat_zbuf_plain`` + ``splat_color_plain`` bit for bit, on the test
    state and with a forced tie (a surface row copied into a free slot
    with another color and listed after the last active row, which must
    win every pixel the row hits); its z-buffer equals the JAX
    ``_splat_zbuf`` within this file's parity tolerance."""
    pose = POSES[3]
    view_j = jgeom.invert_rigid(jnp.asarray(pose))
    aidx_j, n_j, _ = jbm.compactify(jstate, view_j, CAM, CFG)
    has_j = jstate.surf[aidx_j] & (jnp.arange(aidx_j.shape[0]) < n_j)
    zj, _ = jray._splat_zbuf(jstate, jstate.sdf[aidx_j],
                             jstate.weight[aidx_j], aidx_j, has_j, view_j,
                             CAM, CFG, False)
    ts = convert.map_state_from_numpy(jstate, device="cpu")
    view = tgeom.invert_rigid(_t(pose))
    aidx, n, _ = tbm.compactify(ts, view, TCAM, TCFG)
    n = int(n)
    surf = ts.surf[aidx.long()] & (torch.arange(aidx.shape[0]) < n)
    if case == "tie":
        sel = aidx.long()[surf]
        band = ((ts.weight[sel].float() > 0)
                & (ts.sdf[sel].float().abs() < TCFG.voxel_size)).sum(dim=1)
        src = int(sel[torch.argmax(band)])
        free = int(torch.nonzero(ts.block_key == tgeom.INVALID_KEY)[0])
        for f in ("block_key", "sdf", "weight", "surf"):
            getattr(ts, f)[free] = getattr(ts, f)[src]
        ts.color[free] = 0x123456
        aidx = aidx.clone()
        aidx[n] = free
        surf = ts.surf[aidx.long()] & (torch.arange(aidx.shape[0]) <= n)
    keys = sb.splat_keys_plain(ts, aidx, surf, view, TCAM, TCFG)
    assert keys.dtype == torch.int64 and (keys > 0).all()
    zk, ck = sb.splat_resolve_plain(ts, aidx, keys)
    zp, cp = sb.splat_zbuf_plain(ts, aidx, surf, view, TCAM, TCFG,
                                 with_color=True)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
    assert torch.equal(ck, cp)
    assert torch.equal(ck, sb.splat_color_plain(ts, aidx, surf, view, TCAM,
                                                TCFG, zp))
    assert int((ck != 0).sum()) > 1000
    assert bool((ck == 0x123456).any()) == (case == "tie")
    assert int((keys == sb.NO_HIT_KEY).sum()) == int(torch.isinf(zk).sum())
    zj = np.asarray(zj).reshape(CAM.height, CAM.width)
    _compare_depth(torch.where(torch.isfinite(zk), zk, torch.nan)
                   .reshape(CAM.height, CAM.width),
                   np.where(np.isfinite(zj), zj, np.nan))
