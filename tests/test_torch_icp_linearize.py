"""The tracker's passes (``ops/icp_linearize``) against the JAX tracker's,
on the CPU, at 80x60 (levels 80x60, 40x30 and 20x15) and on the edge bank.

Inputs: two synthetic frames (the model from pose 0, the input from pose
2, 2 mm noise seeded by the frame index) through the port's preprocess,
decimated as the tracker does, with seeded small motions; and ``icp_linearize.edge_bank`` (NaN pixels, pz ==
0, projections off every border, every pixel rejected, a 1x1 level, a
row shard against the whole model, the pyramid's strided views).

Tolerances, the plain versions against JAX's: the accept flags and the
gathered targets and normals equal, the weights within 1e-6 absolute
(the weight lies in [0, 1]; JAX's passes run jitted here, as in its
tracker, and XLA turns the divisions by constants into reciprocal
multiplies and fuses multiply-adds: up to ~8 ulp); each sum
(the whitening moments, the planarity scatter, the normal equations and
the photometric system) within 1e-5 of the sum of its terms' absolute
values (``icp_linearize.scale_assoc`` / ``scale_linearize``: the two
libraries sum the pixels in other orders, and a sum that cancels, such as
b, is held to its terms and not to its own size), the counts equal. The
fused wrapper (``associate_linearize``) on the CPU is the plain pair bit
for bit, and so is ``tracking.track`` through it; the numpy model of the
kernels' order of summation (``icp_sum_order.summed_in_kernel_order``)
stays within ``icp_linearize.disagreements``' bound. The kernels against
these plain versions on the card: ``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py`` phase 10 (b).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import tracking as jtr
from voxelhashing_tpu.config import CameraConfig, FilterConfig
from voxelhashing_tpu.io.synthetic import Scene, make_trajectory, render_depth
from voxelhashing_tpu_torch import tracking as ttr
from voxelhashing_tpu_torch.convert import config_from
from voxelhashing_tpu_torch.ops import icp_linearize as il
from voxelhashing_tpu_torch.ops import image as timg

import icp_sum_order

CAM = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5)
LEVELS = 3
THRES = dict(dist_thres=0.15, normal_thres=0.9, depth_min=CAM.depth_min,
             depth_max=CAM.depth_max)
PLANAR_THRES = 4.0e-3
SIGMA = 0.1
SUM_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _frame(pose, seed):
    """A preprocessed synthetic frame as numpy arrays (the port's
    preprocess, which ``tests/test_torch_image.py`` holds to JAX's)."""
    d, c = render_depth(pose, CAM, Scene(), noise_sigma=0.002, seed=seed)
    with torch.no_grad():
        f = timg.preprocess(_t(d), _t(c), config_from(CAM),
                            config_from(FilterConfig()))
    return f.points.numpy(), f.normals.numpy(), f.intensity.numpy()


def _motion(rng, scale):
    """A small rigid motion [4,4] f32."""
    ang = rng.normal(0.0, scale, 3)
    c, s = np.cos(ang), np.sin(ang)
    r = (np.array([[c[0], -s[0], 0], [s[0], c[0], 0], [0, 0, 1]])
         @ np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
         @ np.array([[1, 0, 0], [0, c[2], -s[2]], [0, s[2], c[2]]]))
    m = np.eye(4)
    m[:3, :3] = r
    m[:3, 3] = rng.normal(0.0, scale, 3)
    return m.astype(np.float32)


def _levels():
    """(level camera (JAX), numpy maps of the level: in_pts, in_nrm, in_int,
    md_pts, md_nrm, md_int, and a seeded delta) for the three levels."""
    poses = make_trajectory(3, translation_step=0.01)
    mp, mn, mi = _frame(poses[0], 0)
    ip, inn, ii = _frame(poses[2], 2)
    rng = np.random.default_rng(5)
    out = []
    for level in range(LEVELS):
        s = 1 << level
        cam = jtr._level_camera(CAM, level)
        maps = [a[::s, ::s] for a in (ip, inn, ii, mp, mn, mi)]
        delta = (np.linalg.inv(poses[0]) @ poses[2]).astype(np.float32) \
            @ _motion(rng, 0.003)
        out.append((cam, [np.ascontiguousarray(a) for a in maps], delta))
    return out


LEVEL_CASES = _levels()


def _edge_cases():
    """The edge bank as (JAX camera, numpy maps, delta, case)."""
    out = []
    for e in il.edge_bank():
        st = e["stride"]
        maps = [np.ascontiguousarray(e[k][::st, ::st]) for k in
                ("in_pts", "in_nrm", "in_int", "md_pts", "md_nrm",
                 "md_int")]
        cam = CameraConfig(**dataclasses.asdict(e["cam"]))
        out.append((cam, maps, e["delta"], e["case"]))
    return out


EDGE_CASES = _edge_cases()
# the strided case hands JAX the odd case's arrays: it is the kernels'
CASES = ([(f"level{k}",) + c for k, c in enumerate(LEVEL_CASES)]
         + [(c[3], c[0], c[1], c[2]) for c in EDGE_CASES
            if c[3] != "strided"])
IDS = [c[0] for c in CASES]


# JAX's passes, each compiled once a shape (op-by-op dispatch would
# compile every primitive at every level's shape)
@jax.jit
def _j_soa(ip, inn):
    return jtr._soa(ip) + jtr._soa(inn)


_J_ASSOC = jax.jit(jtr._associate, static_argnums=(3, 4, 5, 6, 7))


@jax.jit
def _j_whitening(q, ok):
    """JAX's whitening with the moments it hands to ``reduce_sys``."""
    seen = []
    mean, inv_std = jtr._whitening(q, ok, lambda s: seen.append(s) or s)
    return seen[0], mean, inv_std


@jax.jit
def _j_planarity(in_soa, wgt):
    seen = []
    planar, i2 = jtr._planarity(in_soa, wgt, PLANAR_THRES,
                                lambda s: seen.append(s) or s)
    return seen[0], planar, i2


_J_LINEARIZE = jax.jit(jtr._linearize)
_J_COLOR = jax.jit(jtr._build_system_color,
                   static_argnames=("cam", "dist_sigma"))


def _jax_assoc(cam, maps, delta):
    ip, inn, _, mp, mn, _ = (jnp.asarray(a) for a in maps)
    in_soa = _j_soa(ip, inn)
    return in_soa, _J_ASSOC(
        jnp.asarray(delta), in_soa, jtr._interleave_target(mp, mn), cam,
        THRES["dist_thres"], THRES["normal_thres"], THRES["depth_min"],
        THRES["depth_max"])


def _torch_level(cam, maps):
    ip, inn, ii, mp, mn, mi = (_t(a) for a in maps)
    return il.Level(ip, inn, mp, mn, config_from(cam), ii, mi)


def _close_sums(got, want, scale, what):
    for g, w, sc in zip(got, want, scale):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        assert np.all(np.abs(g - w) <= SUM_RTOL * np.asarray(sc)), \
            (what, g, w, sc)


def _equal_count(got, want):
    assert int(got) == int(want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_association_matches_jax(case):
    """q, n_q, the weight and the flag; the whitening moments and the
    planarity scatter (the kernel's partial sums), with their epilogues."""
    _, cam, maps, delta = case
    in_soa_j, (qj, nqj, wj, okj) = _jax_assoc(cam, maps, delta)
    lv = _torch_level(cam, maps)
    a = il.associate(_t(delta), lv, scatter=True, **THRES)
    np.testing.assert_array_equal(a.ok.numpy(), np.asarray(okj))
    for got, want in zip(a.q + a.nq, qj + nqj):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(a.wgt.numpy(), np.asarray(wj), rtol=0,
                               atol=1e-6)
    # the moments against JAX's, through an identity reduction that
    # records them
    m_scale, s_scale = il.scale_assoc(lv, a, True)
    moments_j, mean_j, inv_std_j = _j_whitening(qj, okj)
    _close_sums(a.moments[:2], moments_j[:2], m_scale, "moments")
    _equal_count(a.moments[2], moments_j[2])
    mean, inv_std = il.whitening_epilogue(a.moments)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(inv_std), float(inv_std_j), rtol=1e-5)
    s_j, planar_j, i2_j = _j_planarity(in_soa_j, wj)
    _close_sums((a.s,), s_j, (s_scale,), "scatter")
    planar, i2 = il.planarity_epilogue(a.s, PLANAR_THRES)
    np.testing.assert_allclose(float(i2), float(i2_j), rtol=0, atol=1e-5)
    if abs(float(i2_j) - PLANAR_THRES) > 1e-4:
        assert bool(planar) == bool(planar_j)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_normal_equations_match_jax(case):
    """The depth system at the association's whitening, and the
    photometric system, against JAX's on the same inputs."""
    _, cam, maps, delta = case
    in_soa_j, (qj, nqj, wj, okj) = _jax_assoc(cam, maps, delta)
    lv = _torch_level(cam, maps)
    a = il.associate(_t(delta), lv, scatter=False, **THRES)
    lin = il.linearize(_t(delta), lv, a, a.moments, None, PLANAR_THRES,
                       SIGMA)
    assert lin.planar is None
    mean = jnp.asarray(lin.mean.numpy())
    inv_std = jnp.float32(float(lin.inv_std))
    sys_j = _J_LINEARIZE(jnp.asarray(delta), in_soa_j, qj, nqj, wj, okj,
                         mean, inv_std)
    sc_d, sc_c = il.scale_linearize(_t(delta), lv, a, lin, SIGMA)
    _close_sums(lin.depth[:4], sys_j[:4], sc_d, "depth system")
    _equal_count(lin.depth[4], sys_j[4])
    ii, mi = jnp.asarray(maps[2]), jnp.asarray(maps[5])
    gx, gy = jtr.intensity_gradients(mi)
    col_j = _J_COLOR(jnp.asarray(delta), jnp.asarray(maps[0]), ii, mi, gx,
                     gy, cam=cam, dist_sigma=SIGMA, mean=mean,
                     inv_std=inv_std)
    _close_sums(lin.color[:4], col_j[:4], sc_c, "photometric system")
    _equal_count(lin.color[4], col_j[4])
    # the names tracking keeps reach the same plain passes
    assert ttr._linearize is il.linearize_plain
    assert ttr._build_system_color is il.color_system_plain


def test_edge_bank_covers_its_cases():
    """The bank's levels do what they are for: rejected pixels of every
    kind beside accepted ones, a count of 0, a 1x1 level whose bilinear
    corners wrap, a row shard against the whole model, strided maps."""
    counts = {}
    for cam, maps, delta, case in EDGE_CASES:
        lv = _torch_level(cam, maps)
        a = il.associate(_t(delta), lv, scatter=True, **THRES)
        lin = il.linearize(_t(delta), lv, a, a.moments, a.s, PLANAR_THRES,
                           SIGMA)
        counts[case] = (int(a.ok.sum()), int(lin.color[4]), lv.n)
    n_odd = counts["odd"][2]
    assert 0 < counts["odd"][0] < n_odd - 30        # ~40 spoiled pixels
    assert 0 < counts["odd"][1] < n_odd
    assert counts["all_rejected"][:2] == (0, 0)
    assert counts["one_pixel"] == (1, 1, 1)
    assert counts["row_shard"][2] == 7 * 20
    assert counts["strided"] == counts["odd"]
    e = il.edge_bank()[4]
    assert e["case"] == "strided" and e["in_pts"].shape == (30, 40, 3)


def _sums_and_scale():
    cam, maps, delta = LEVEL_CASES[0]
    lv = _torch_level(cam, maps)
    a = il.associate(_t(delta), lv, scatter=True, **THRES)
    lin = il.linearize(_t(delta), lv, a, a.moments, a.s, PLANAR_THRES,
                       SIGMA)
    return lv, a, lin, il.scale_linearize(_t(delta), lv, a, lin, SIGMA)


def test_disagreements_pass_the_plain_version_and_flag_a_perturbed_sum():
    lv, a, lin, (sc_d, sc_c) = _sums_and_scale()
    n = lv.n
    assert il.disagreements(lin.depth, lin.depth, sc_d, n) == []
    assert il.disagreements(lin.color, lin.color, sc_c, n) == []
    assert il.excess(lin.depth, lin.depth, sc_d) == 0.0
    m_scale, s_scale = il.scale_assoc(lv, a, True)
    assert il.disagreements(a.moments + (a.s,), a.moments + (a.s,),
                            m_scale + (s_scale,), n) == []
    # just inside and just outside the bound on A[0, 0]
    lim = il.bound_factor(n) * il.U32 * sc_d[0][0, 0]
    for step, flagged in ((0.5, False), (2.0, True)):
        a_mat = lin.depth[0].clone().double()
        a_mat[0, 0] += step * lim
        got = (a_mat.float(),) + lin.depth[1:]
        bad = il.disagreements(got, lin.depth, sc_d, n)
        assert bool(bad) == flagged
        if flagged:
            assert bad[0][0] == 0
    # a count off by one, a NaN sum
    got = lin.depth[:4] + (lin.depth[4] + 1,)
    assert [b[0] for b in il.disagreements(got, lin.depth, sc_d, n)] == [4]
    got = (lin.depth[0],) + (lin.depth[1] * float("nan"),) + lin.depth[2:]
    assert [b[0] for b in il.disagreements(got, lin.depth, sc_d, n)] == [1]
    assert il.excess(got, lin.depth, sc_d) == float("inf")


def test_bound_counts_by_hand():
    """``bytes_moved`` and ``operations`` at the 80x60 level, counted by
    hand from the layouts and the per-pixel counts."""
    n, n_md = 80 * 60, 80 * 60
    # association: points and normals in (24 B), the model maps (24 B a
    # pixel), delta (64 B); out 7 f32 and a flag a pixel, 5 + 9 sums
    assert il.bytes_moved("associate", n, n_md, scatter=True) == \
        24 * 4800 + 24 * 4800 + 64 + 29 * 4800 + 56
    assert il.bytes_moved("associate", n, n_md) == \
        24 * 4800 + 24 * 4800 + 64 + 29 * 4800 + 20
    # linearization: points (12 B) and correspondences (29 B) a pixel,
    # delta, moments (20 B), scatter (36 B); out the system (44 f32),
    # mean and inv_std, a count and the flag
    assert il.bytes_moved("linearize", n, n_md, planar=True) == \
        41 * 4800 + 64 + 20 + 36 + 4 * 48 + 4 + 1
    # with color: the two intensity maps, a second system and count
    assert il.bytes_moved("linearize_color", n, n_md) == \
        41 * 4800 + 64 + 20 + 8 * 4800 + 4 * 92 + 8
    assert il.operations("associate", 4800, 4000, 3000) == (
        92 * 4800 + 6 * 4000 + 3 * 3000, 2 * (5 * 4000 + 6 * 3000))
    assert il.operations("linearize", 4800, 4000) == (
        51 * 4000, 60 * 4000)
    assert il.operations("linearize_color", 4800, 4000, 0, 3500) == (
        51 * 4000 + 81 * 4800 + 25 * 3500, 60 * 4000 + 60 * 3500)


def test_fused_bound_counts_by_hand():
    """The fused launch's ``bytes_moved`` and ``operations`` at the 80x60
    level: each input read once (points and normals 24 B a pixel, the
    model maps 24 B, delta 64 B, under RGB-D the two intensity maps 4 B a
    pixel each), each output written once (the correspondences 29 B a
    pixel, the association's 5 + 9 sums, the systems, mean, inv_std, the
    counts and the flag); the operations are both passes'."""
    n, n_md = 80 * 60, 80 * 60
    assert il.bytes_moved("pass", n, n_md, scatter=True, planar=True) == \
        24 * 4800 + 24 * 4800 + 64 + 29 * 4800 + 4 * 14 \
        + 4 * 48 + 4 + 1
    assert il.bytes_moved("pass", n, n_md) == \
        24 * 4800 + 24 * 4800 + 64 + 29 * 4800 + 4 * 5 + 4 * 48 + 4
    assert il.bytes_moved("pass_color", n, n_md) == \
        24 * 4800 + 24 * 4800 + 64 + 29 * 4800 + 4 * 5 + 8 * 4800 \
        + 4 * 92 + 8
    assert il.operations("pass", 4800, 4000, 3000) == (
        92 * 4800 + 6 * 4000 + 3 * 3000 + 51 * 4000,
        2 * (5 * 4000 + 6 * 3000) + 60 * 4000)
    assert il.operations("pass_color", 4800, 4000, 0, 3500) == (
        92 * 4800 + 6 * 4000 + 51 * 4000 + 81 * 4800 + 25 * 3500,
        2 * 5 * 4000 + 60 * 4000 + 60 * 3500)


def test_wrappers_refuse_other_devices_and_bad_maps():
    cam, maps, delta = LEVEL_CASES[2]
    meta = torch.device("meta")
    lv = il.Level(*(torch.empty(a.shape, device=meta) for a in
                    (maps[0], maps[1], maps[3], maps[4])), config_from(cam))
    with pytest.raises(ValueError, match="no kernel"):
        il.associate(torch.eye(4, device=meta), lv, scatter=False, **THRES)
    lv = _torch_level(cam, maps)
    bad = il.Level(lv.in_pts, lv.in_nrm[:, :-1], lv.md_pts, lv.md_nrm,
                   lv.cam)
    with pytest.raises(ValueError, match="input normals"):
        il.prepare_associate(_t(delta), bad, scatter=False, **THRES)
    small = dataclasses.replace(lv.cam, width=lv.cam.width * 2)
    with pytest.raises(ValueError, match="fewer pixels"):
        il.prepare_associate(_t(delta), il.Level(
            lv.in_pts, lv.in_nrm, lv.md_pts, lv.md_nrm, small),
            scatter=False, **THRES)


def _pass_tensors(assoc, lin):
    out = list(assoc.q + assoc.nq) + [assoc.wgt, assoc.ok] \
        + list(assoc.moments) + [assoc.s, lin.mean, lin.inv_std, lin.planar]
    for sys_ in (lin.depth, lin.color):
        out += list(sys_) if sys_ is not None else [None]
    return out


@pytest.mark.parametrize("scatter,sigma", [(True, None), (False, SIGMA)],
                         ids=["depth", "rgbd"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_wrapper_is_the_plain_pair_on_the_cpu(case, scatter, sigma):
    """``associate_linearize`` on CPU tensors returns
    ``associate_reference`` then ``linearize_reference`` on its own sums,
    bit for bit, depth-only with the scatter and with the photometric
    rows."""
    _, cam, maps, delta = case
    lv = _torch_level(cam, maps)
    got = il.associate_linearize(_t(delta), lv, **THRES, scatter=scatter,
                                 planar_thres=PLANAR_THRES,
                                 color_sigma=sigma)
    a = il.associate_reference(_t(delta), lv, **THRES, scatter=scatter)
    lin = il.linearize_reference(_t(delta), lv, a, a.moments, a.s,
                                 PLANAR_THRES, sigma)
    for g, w in zip(_pass_tensors(*got), _pass_tensors(a, lin)):
        assert il.same_bits(g, w)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_wrapper_matches_jax(case):
    """The fused wrapper's association and systems against JAX's
    ``_associate`` / ``_whitening`` / ``_planarity`` / ``_linearize`` /
    ``_build_system_color`` on the same inputs, at the file's
    tolerances."""
    _, cam, maps, delta = case
    in_soa_j, (qj, nqj, wj, okj) = _jax_assoc(cam, maps, delta)
    lv = _torch_level(cam, maps)
    a, lin = il.associate_linearize(_t(delta), lv, **THRES, scatter=True,
                                    planar_thres=PLANAR_THRES,
                                    color_sigma=SIGMA)
    np.testing.assert_array_equal(a.ok.numpy(), np.asarray(okj))
    for got, want in zip(a.q + a.nq, qj + nqj):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(a.wgt.numpy(), np.asarray(wj), rtol=0,
                               atol=1e-6)
    m_scale, s_scale = il.scale_assoc(lv, a, True)
    moments_j, mean_j, inv_std_j = _j_whitening(qj, okj)
    _close_sums(a.moments[:2], moments_j[:2], m_scale, "moments")
    _equal_count(a.moments[2], moments_j[2])
    np.testing.assert_allclose(lin.mean.numpy(), np.asarray(mean_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(lin.inv_std), float(inv_std_j),
                               rtol=1e-5)
    s_j, planar_j, i2_j = _j_planarity(in_soa_j, wj)
    _close_sums((a.s,), s_j, (s_scale,), "scatter")
    i2 = il.planarity_epilogue(a.s, PLANAR_THRES)[1]
    if abs(float(i2_j) - PLANAR_THRES) > 1e-4:
        assert bool(lin.planar) == bool(planar_j)
    np.testing.assert_allclose(float(i2), float(i2_j), rtol=0, atol=1e-5)
    mean = jnp.asarray(lin.mean.numpy())
    inv_std = jnp.float32(float(lin.inv_std))
    sys_j = _J_LINEARIZE(jnp.asarray(delta), in_soa_j, qj, nqj, wj, okj,
                         mean, inv_std)
    sc_d, sc_c = il.scale_linearize(_t(delta), lv, a, lin, SIGMA)
    _close_sums(lin.depth[:4], sys_j[:4], sc_d, "depth system")
    _equal_count(lin.depth[4], sys_j[4])
    ii, mi = jnp.asarray(maps[2]), jnp.asarray(maps[5])
    gx, gy = jtr.intensity_gradients(mi)
    col_j = _J_COLOR(jnp.asarray(delta), jnp.asarray(maps[0]), ii, mi, gx,
                     gy, cam=cam, dist_sigma=SIGMA, mean=mean,
                     inv_std=inv_std)
    _close_sums(lin.color[:4], col_j[:4], sc_c, "photometric system")
    _equal_count(lin.color[4], col_j[4])


@pytest.mark.parametrize("rgbd", [False, True], ids=["depth", "rgbd"])
def test_track_on_the_cpu_is_the_split_pairs(rgbd):
    """``tracking.track`` on the CPU through the fused wrapper (a single
    device) gives the split pair's result (an identity ``reduce_fn``, the
    parent's path) bit for bit, every field."""
    from voxelhashing_tpu_torch.config import TrackerConfig
    cam, maps, _ = LEVEL_CASES[0]
    ip, inn, ii, mp, mn, mi = (_t(a) for a in maps)
    cfg = TrackerConfig(levels=2, max_outer_iter=(3, 2),
                        max_inner_iter=(2, 1))
    kw = dict(input_intensity=ii, model_intensity=mi) if rgbd else {}
    args = (ip, inn, mp, mn, torch.eye(4), config_from(cam), cfg)
    fused = ttr.track(*args, **kw)
    split = ttr.track(*args, **kw, reduce_fn=lambda sums: sums)
    for x, y in zip(fused, split):
        assert il.same_bits(x, y)


@pytest.mark.parametrize("grid", [1, 2, 264])
def test_partial_rows_do_not_overlap(grid):
    """The fused launch writes its linearization rows while other CTAs may
    still read the association's: ``partial_rows`` gives the two row sets
    disjoint regions of the level's buffer, each as long as its form
    needs (11 doubles a CTA; 60, the photometric rows included)."""
    rows = torch.arange(grid * (il.ASSOC_SUMS + 2 * il.SYS_SUMS),
                        dtype=torch.float64)
    a, lin = il.partial_rows(rows, grid)
    assert a.numel() == grid * il.ASSOC_SUMS
    assert lin.numel() == grid * 2 * il.SYS_SUMS
    assert a.data_ptr() + a.numel() * 8 <= lin.data_ptr()
    assert not set(a.tolist()) & set(lin.tolist())


@pytest.mark.parametrize("max_grid", [1, 2, 264])
@pytest.mark.parametrize("scatter,sigma", [(True, None), (False, SIGMA)],
                         ids=["depth", "rgbd"])
def test_kernel_order_model_stays_within_the_bound(max_grid, scatter,
                                                   sigma):
    """The numpy model of the kernels' order of summation (grid-stride
    rows a thread, the warps' transpose-reduce, the warps in order, the
    last CTA's chunked trees) on the edge bank and the 80x60 level, with
    1, 2 or up to 264 CTAs (threads with several pixels, one CTA, the
    card's grid), within ``disagreements``' bound of the plain sums, the
    counts equal; and exact on sums of small integers."""
    entries = [(cam, maps, delta) for _, cam, maps, delta in CASES]
    for cam, maps, delta in entries:
        lv = _torch_level(cam, maps)
        a = il.associate_reference(_t(delta), lv, **THRES, scatter=scatter)
        lin = il.linearize_reference(_t(delta), lv, a, a.moments, a.s,
                                     PLANAR_THRES, sigma)
        grid = min(-(-lv.n // il.THREADS), max_grid)
        moments, s, depth, color = icp_sum_order.model_sums(
            _t(delta), lv, a, lin.mean, lin.inv_std, scatter, sigma, grid)
        m_scale, s_scale = il.scale_assoc(lv, a, scatter)
        got = moments + ((s,) if scatter else ())
        ref = a.moments + ((a.s,) if scatter else ())
        scale = m_scale + ((s_scale,) if scatter else ())
        assert il.disagreements(got, ref, scale, lv.n) == []
        sc_d, sc_c = il.scale_linearize(_t(delta), lv, a, lin, sigma)
        assert il.disagreements(depth, lin.depth, sc_d, lv.n) == []
        if sigma is not None:
            assert il.disagreements(color, lin.color, sc_c, lv.n) == []
    rng = np.random.default_rng(0)
    terms = rng.integers(-50, 50, (70000, 60)).astype(np.float64)
    for grid in (1, 3, 264):
        np.testing.assert_array_equal(
            icp_sum_order.summed_in_kernel_order(terms, grid),
            terms.sum(axis=0))
