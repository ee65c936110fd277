"""Parity of the PyTorch port's allocation candidates, TSDF fusion (the
plain version of the fused-integrate kernel) and garbage collection with
the JAX package's XLA path (``integrate.integrate``).

Tolerances: candidate-key multisets identical; fused rows differ in at
most 1e-4 of the voxels' weights (a projection that lands exactly on a
``floor(x+0.5)`` pixel boundary may round the other way, the bound of
``tests/test_pallas_integrate.py``); on the voxels that agree, sdf within
5e-4 and color within 1 per channel; the GC's culled set identical.
With ``bilinear_color`` the port's rows, surface flags and GC stats equal
the JAX XLA integrate's bit for bit (its projection and sample repeat the
XLA function's operations).
"""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import blockmap as jbm, geometry as jgeom
from voxelhashing_tpu import integrate as jint
from voxelhashing_tpu.config import CameraConfig, MapConfig
from voxelhashing_tpu.io.synthetic import Scene, make_trajectory, render_depth
from voxelhashing_tpu_torch import blockmap as tbm, convert
from voxelhashing_tpu_torch import integrate as tint
from voxelhashing_tpu_torch.ops import hash_table as ht
from voxelhashing_tpu_torch.ops.fused_integrate import fused_integrate

CAM = CameraConfig(width=128, height=96, fx=104.0, fy=104.0, cx=63.5,
                   cy=47.5)
CFG = MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                num_blocks=4096, table_size=16384, max_active_blocks=4096,
                world_blocks=1024)
TCAM, TCFG = convert.config_from(CAM), convert.config_from(CFG)
POSES = make_trajectory(12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core, and idle
    OpenMP threads spinning beside the other workers cost far more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(i):
    depth, color = render_depth(POSES[i], CAM, Scene(), noise_sigma=0.002,
                                seed=i)
    return depth.astype(np.float32), color.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("mode", ["pixel", "tile_phase_novelty"])
def test_alloc_candidates_multiset(mode):
    depth, _ = _frame(5)
    pose = POSES[5]
    kw = {}
    if mode != "pixel":
        model = depth + np.random.default_rng(0).normal(
            0, 0.03, depth.shape).astype(np.float32)
        kw = dict(tile=4, model_depth=model)
    for phase in ((None,) if mode == "pixel" else (0, 5, 11)):
        if phase is not None:
            kw["phase"] = phase
        jk = np.asarray(jint.alloc_candidates(
            jnp.asarray(depth), jnp.asarray(pose), CAM, CFG,
            **{k: (jnp.asarray(v) if k == "model_depth" else v)
               for k, v in kw.items()}))
        tk = tint.alloc_candidates(
            _t(depth), _t(pose), TCAM, TCFG,
            **{k: (_t(v) if k == "model_depth" else v)
               for k, v in kw.items()})
        np.testing.assert_array_equal(np.sort(tk.numpy()), np.sort(jk))
        assert (jk != jgeom.INVALID_KEY).sum() > 50


def _setup():
    """A state after one JAX allocation + fusion, and the next frame."""
    d0, c0 = _frame(0)
    js = jbm.create(CFG)
    js, _ = jint.allocate_from_depth(js, jnp.asarray(d0),
                                     jnp.asarray(POSES[0]), CAM, CFG)
    js = jint.integrate(js, jnp.asarray(d0), jnp.asarray(c0),
                        jnp.asarray(POSES[0]), CAM, CFG)
    d1, c1 = _frame(3)
    js, _ = jint.allocate_from_depth(js, jnp.asarray(d1),
                                     jnp.asarray(POSES[3]), CAM, CFG)
    view = jgeom.invert_rigid(jnp.asarray(POSES[3]))
    aidx, n_act, _ = jbm.compactify(js, view, CAM, CFG)
    return js, d1, c1, POSES[3], aidx, n_act


def _compare_rows(ts, js_out):
    w_t = ts.weight.to(torch.float32).numpy()
    w_j = np.asarray(js_out.weight).astype(np.float32)
    flip = np.abs(w_t - w_j) > 1e-3
    assert flip.mean() < 1e-4, f"{flip.sum()} weight mismatches"
    agree = (w_j > 0) & ~flip
    assert agree.sum() > 1000
    s_t = ts.sdf.to(torch.float32).numpy()[agree]
    s_j = np.asarray(js_out.sdf).astype(np.float32)[agree]
    np.testing.assert_allclose(s_t, s_j, atol=5e-4, rtol=0)
    c_t = ts.color.numpy()[agree]
    c_j = np.asarray(js_out.color).astype(np.int64)[agree]
    for shift in (16, 8, 0):
        a = (c_t >> shift) & 0xFF
        b = (c_j >> shift) & 0xFF
        assert np.abs(a - b).max() <= 1
    return flip


@pytest.mark.parametrize("with_color", [True, False])
def test_integrate_matches_xla(with_color):
    js, depth, color, pose, aidx, n_act = _setup()
    mask = jnp.arange(aidx.shape[0]) < n_act
    ref = jint.integrate(js, jnp.asarray(depth),
                         jnp.asarray(color) if with_color else None,
                         jnp.asarray(pose), CAM, CFG, active_idx=aidx,
                         active_mask=mask)
    ts = convert.map_state_from_numpy(js, device="cpu")
    ts, (min_sdf, max_w) = fused_integrate(
        ts, _t(depth), _t(color) if with_color else None, _t(pose), TCAM,
        TCFG, _t(aidx), _t(n_act))
    flip = _compare_rows(ts, ref)
    # surf flags and GC stats: from the port's own stored rows, and equal
    # to the JAX rows' flags wherever no weight flipped
    n = int(n_act)
    rows = np.asarray(aidx)[:n]
    clean = ~flip[rows].any(axis=1)
    np.testing.assert_array_equal(ts.surf.numpy()[rows][clean],
                                  np.asarray(ref.surf)[rows][clean])
    w = np.asarray(ref.weight).astype(np.float32)[rows]
    s = np.abs(np.asarray(ref.sdf).astype(np.float32)[rows])
    np.testing.assert_array_equal(max_w.numpy()[:n][clean],
                                  w.max(axis=1)[clean])
    np.testing.assert_array_equal(
        min_sdf.numpy()[:n][clean],
        np.where(w > 0, s, np.inf).min(axis=1)[clean])
    # rows past n_active: empty stats, as the kernel writes them
    assert np.isinf(min_sdf.numpy()[n:]).all() and not max_w.numpy()[n:].any()
    viol = tbm.check_invariants(ts, TCFG)
    assert all(v == 0 for v in viol.values()), viol


def test_garbage_collect_culls_same_set():
    """Starve + GC (row-reading path) and GC with the fused pass's cached
    stats both cull exactly the JAX set."""
    js, depth, color, pose, aidx, n_act = _setup()
    mask = jnp.arange(aidx.shape[0]) < n_act
    js = jint.integrate(js, jnp.asarray(depth), jnp.asarray(color),
                        jnp.asarray(pose), CAM, CFG, active_idx=aidx,
                        active_mask=mask)
    ts = convert.map_state_from_numpy(js, device="cpu")
    ta, tm = _t(aidx), _t(mask)
    # cached stats from a second identical fusion on both sides
    js2 = jint.integrate(js, jnp.asarray(depth), jnp.asarray(color),
                         jnp.asarray(pose), CAM, CFG, active_idx=aidx,
                         active_mask=mask)
    js2 = jint.garbage_collect(js2, aidx, mask, CFG)
    ts2, stats = tint.integrate(ts, _t(depth), _t(color), _t(pose), TCAM,
                                TCFG, active_idx=ta, active_mask=tm)
    ts2 = tint.garbage_collect(ts2, ta, tm, TCFG, cached_stats=stats)
    np.testing.assert_array_equal(ts2.block_key.numpy(),
                                  np.asarray(js2.block_key))
    assert int(js2.n_tombstones) > 0        # something was culled

    js3 = jint.starve(js, aidx, mask)
    js3 = jint.garbage_collect(js3, aidx, mask, CFG)
    ts3 = convert.map_state_from_numpy(js, device="cpu")
    ts3 = tint.starve(ts3, ta, tm)
    ts3 = tint.garbage_collect(ts3, ta, tm, TCFG)
    for f in ("block_key", "table_key", "free_stack", "n_free", "surf"):
        np.testing.assert_array_equal(getattr(ts3, f).numpy(),
                                      np.asarray(getattr(js3, f)))
    np.testing.assert_array_equal(ts3.weight.view(torch.int16).numpy(),
                                  np.asarray(js3.weight).view(np.int16))
    viol = tbm.check_invariants(ts3, TCFG)
    assert all(v == 0 for v in viol.values()), viol


def _edge_color_frame(seed):
    """A seeded [h,w,3] f32 frame in [0,1] with stripes of the values the
    color word must get right: NaN, +inf, -inf, negative, -0.0, > 1,
    exactly 1.0 and 254.5/255 in one channel, and all three exactly 1.0."""
    rng = np.random.default_rng(seed)
    c = rng.random((CAM.height, CAM.width, 3), dtype=np.float32)
    vals = (np.nan, np.inf, -np.inf, -0.25, -0.0, 1.5, 1.0, 254.5 / 255.0)
    period = len(vals) + 1
    for g, v in enumerate(vals):
        c[:, g::period, (g + seed) % 3] = v
    c[:, len(vals)::period, :] = 1.0
    c[rng.random(c.shape[:2]) < 0.01] = np.nan
    return c


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frame_color_word_matches_jax(seed):
    """The port's per-pixel color word (``packed | valid << 24``, the
    contract kernel A's in-kernel color word meets) equals the JAX
    package's packing (``_pack_frame_color`` and the validity bit that
    ``integrate`` folds in), bit for bit as uint32 words; depth-only gives
    the debug green, valid."""
    c = _edge_color_frame(seed)
    packed, ok = jint._pack_frame_color(jnp.asarray(c))
    ref = np.asarray(jnp.where(ok, packed | jnp.uint32(0x01000000),
                               packed)).reshape(-1)
    got = tint.frame_color_word(torch.from_numpy(c), TCAM, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    assert 0 < (ref >> 24).sum() < ref.size        # both valid and not
    green = tint.frame_color_word(None, TCAM, device="cpu")
    assert (green.numpy() == 0x0100FF00).all()
    assert green.shape == (CAM.height * CAM.width,)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bilinear_color_from_words_matches_jax(seed):
    """The plain bilinear sample read from the frame's color-word image
    (``_bilinear_color(frame_color_word(color), ...)``, what kernel A's
    bilinear variant reads) equals the JAX ``integrate._bilinear_color``
    bit for bit, packed color and validity, on the edge-value frames (NaN,
    +-inf, negative, -0.0, > 1 and exact values) at projections that put
    corners off screen on every side, on exact pixel centres (offset 0
    goes +1) and on exact half-pixel boundaries."""
    rng = np.random.default_rng(seed)
    c = _edge_color_frame(seed)
    n = 4000
    uf = rng.uniform(-2.0, CAM.width + 1.0, n).astype(np.float32)
    vf = rng.uniform(-2.0, CAM.height + 1.0, n).astype(np.float32)
    uf[:200] = np.round(uf[:200])                  # offset exactly 0
    vf[200:400] = np.floor(vf[200:400]) + 0.5      # on the rounding edge
    uf[400:450] = -0.5                             # left edge
    vf[450:500] = CAM.height - 0.5                 # bottom edge
    ref_c, ref_ok = jint._bilinear_color(jnp.asarray(c), jnp.asarray(uf),
                                         jnp.asarray(vf), CAM)
    words = tint.frame_color_word(torch.from_numpy(c), TCAM, device="cpu")
    got_c, got_ok = tint._bilinear_color(words, _t(uf), _t(vf), TCAM)
    np.testing.assert_array_equal(got_c.numpy().view(np.uint32),
                                  np.asarray(ref_c))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    assert 0 < int(got_ok.sum()) < n               # both valid and not


@pytest.fixture(scope="module")
def setup_state():
    """``_setup()`` once for the cases below (JAX states are immutable)."""
    return _setup()


@pytest.mark.parametrize("color_case", ["frame", "edge_values", "none"])
def test_bilinear_integrate_bit_equal_to_xla(setup_state, color_case):
    """``MapConfig(bilinear_color=True)``: the validity-weighted bilinear
    color sample, on the test scene's frame, on a frame with the edge
    values of ``_edge_color_frame`` (invalid corners drop out; a voxel with
    none valid is not updated), and depth-only (debug green)."""
    cfg = dataclasses.replace(CFG, bilinear_color=True)
    tcfg = convert.config_from(cfg)
    js, depth, color, pose, aidx, n_act = setup_state
    if color_case == "edge_values":
        color = _edge_color_frame(1)
    elif color_case == "none":
        color = None
    mask = jnp.arange(aidx.shape[0]) < n_act
    ref = jint.integrate(js, jnp.asarray(depth),
                         None if color is None else jnp.asarray(color),
                         jnp.asarray(pose), CAM, cfg, active_idx=aidx,
                         active_mask=mask)
    ts = convert.map_state_from_numpy(js, device="cpu")
    ts, (min_sdf, max_w) = fused_integrate(
        ts, _t(depth), None if color is None else _t(color), _t(pose), TCAM,
        tcfg, _t(aidx), _t(n_act))
    got = convert.map_state_to_numpy(ts)
    for f in ("sdf", "weight", "color", "surf", "block_key"):
        np.testing.assert_array_equal(
            got[f].view(np.uint8), np.asarray(getattr(ref, f)).view(np.uint8),
            err_msg=f)
    n = int(n_act)
    rows = np.asarray(aidx)[:n]
    w = np.asarray(ref.weight).astype(np.float32)[rows]
    s = np.abs(np.asarray(ref.sdf).astype(np.float32)[rows])
    np.testing.assert_array_equal(max_w.numpy()[:n], w.max(axis=1))
    np.testing.assert_array_equal(min_sdf.numpy()[:n],
                                  np.where(w > 0, s, np.inf).min(axis=1))
    changed = (got["weight"] != np.asarray(js.weight)).any(axis=1).sum()
    assert changed > 100
    if color_case == "frame":
        # bilinear differs from the nearest sample on many voxels
        near = jint.integrate(js, jnp.asarray(depth), jnp.asarray(color),
                              jnp.asarray(pose), CAM, CFG, active_idx=aidx,
                              active_mask=mask)
        assert (np.asarray(near.color) != got["color"]).sum() > 1000


@functools.lru_cache(maxsize=None)
def _gc_bank():
    return {e["case"]: e for e in ht.gc_bank()}


def _map_fields_equal(ts, js, what):
    for f in ("table_key", "table_val", "block_key", "free_stack", "n_free",
              "n_tombstones", "dense_upto", "surf"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)),
                                      err_msg=f"{what} {f}")
    for f in ("sdf", "weight"):
        np.testing.assert_array_equal(
            getattr(ts, f).view(torch.int16).numpy(),
            np.asarray(getattr(js, f)).view(np.int16), err_msg=f"{what} {f}")
    np.testing.assert_array_equal(ts.color.numpy().view(np.uint32),
                                  np.asarray(js.color),
                                  err_msg=f"{what} color")


@pytest.mark.parametrize("case", ht.GC_CASES)
def test_garbage_collect_plain_matches_jax_on_the_gc_bank(case):
    """GC with cached stats on ``hash_table.gc_bank``: the plain version and
    the dispatching ``garbage_collect`` (the plain version on CPU tensors,
    no launch) against JAX's jitted ``garbage_collect``, every field and
    the pool rows bit for bit (nothing culled, exactly and over the cap,
    culled free rows, a list shorter than the cap, the f32 threshold and
    one ulp either side, NaN, infinite and -0.0 stats)."""
    import jax
    e = _gc_bank()[case]
    cfg = e["cfg"]
    jc = MapConfig(**dataclasses.asdict(cfg))
    ts, idx, mask, ms, mw = ht.gc_inputs(e, "cpu")
    snap = convert.map_state_to_numpy(ts)
    js = jbm.MapState(**{k: jnp.asarray(v) for k, v in snap.items()})
    ref = jax.jit(lambda s, i, m, a, b: jint.garbage_collect(
        s, i, m, jc, cached_stats=(a, b)))(
            js, jnp.asarray(e["active_idx"]), jnp.asarray(e["active_mask"]),
            jnp.asarray(e["min_sdf"]), jnp.asarray(e["max_w"]))
    n0 = (ht.garbage_collect.launches, ht.delete_blocks.launches,
          tint.garbage_collect_plain.cuda_calls)
    for fn in (tint.garbage_collect_plain, tint.garbage_collect):
        st = convert.map_state_from_numpy(jbm.MapState(**snap), device="cpu")
        got = fn(st, idx, mask, cfg, cached_stats=(ms, mw))
        _map_fields_equal(got, ref, f"{case}, {fn.__name__}")
    assert (ht.garbage_collect.launches, ht.delete_blocks.launches,
            tint.garbage_collect_plain.cuda_calls) == n0
    freed = int(ref.n_free) - int(snap["n_free"])
    assert (freed == 0) == (case == "gc_nothing")


def test_garbage_collect_refuses_other_devices():
    """A map on neither the CPU nor CUDA is refused by the GC entry's
    wrapper, never run by the plain version."""
    e = _gc_bank()["gc_short_list"]
    meta = torch.device("meta")
    st = tbm.create(e["cfg"], meta)
    idx = torch.zeros(8, dtype=torch.int32, device=meta)
    stats = torch.zeros(8, dtype=torch.float32, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        tint.garbage_collect(st, idx, idx > 0, e["cfg"],
                             cached_stats=(stats, stats))
    assert ht.garbage_collect.launches == 0
