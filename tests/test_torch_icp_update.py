"""The port's ICP update (``ops/icp_update``) against the JAX tracker's
tail, and a numpy model of its kernel's 6x6 solve.

The JAX tail is composed here from ``voxelhashing_tpu.tracking``'s
``_solve6``, ``_check_step`` and ``_pose_from_x_whitened`` and the masked
update of its jitted loop (``voxelhashing_tpu/tracking.py:560-590``, the
skip of ``skip_iter``). Inputs: ``icp_update.update_bank``, seeded systems
and carries with cases for every flag path. Tolerance: the flags, the
counts, the degenerate flag and the curve's NaN pattern equal; delta
within 1e-5 absolute and the values, the stats row and the curve within
1e-3 relative (the JAX tracker's parity bounds, ``test_torch_tracking``;
the two libraries' f32 SVDs differ by about eps32 * cond); x within
``solve6.disagreements``.

The model is the kernel's algorithm in numpy f64 (``csrc/solve6.cu``:
Jacobi on the Gram matrix in the circle method's rounds, the gate with its
noise floor, the clamp, the stopping rule); it must meet
``solve6.disagreements`` against the plain f32 SVD on the 144-system bank,
so the algorithm is checked before the card runs it. The kernel against
the plain version on the card: ``tests/test_torch_kernels_cuda.py``.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import tracking as jtr
from voxelhashing_tpu_torch.ops import icp_update as iu, solve6 as s6

COND_THRES = 2.0e4
BANK = iu.update_bank(seed=11, n_per_case=6)
LEVEL, SLOT = 1, 2                  # where bank_inputs puts the update


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tail(e):
    """The JAX tracker's inner-iteration tail on one bank entry; returns
    (delta, vals, counts, flags, curve value, (x, cond, degenerate)), with
    x None under skip."""
    gate = iu.BANK_GATE
    vals, counts = e["vals"].copy(), e["counts"].copy()
    flags = e["flags"].copy()
    if e["begin"] & iu.BEGIN_LEVEL:
        vals[2:5], vals[5], counts[1], flags[1] = 0.0, np.inf, 0, False
    if e["begin"] & iu.BEGIN_OUTER:
        flags[2] = flags[1]
    if flags[2]:                       # skip_iter: the carry unchanged
        return e["delta"], vals, counts, flags, np.float32(np.nan), None
    residual, condition, lvl_res, lvl_cond, lvl_w, last_res = (
        jnp.float32(v) for v in vals)
    corr, lvl_corr = (jnp.int32(c) for c in counts)
    lost, done = jnp.bool_(flags[0]), jnp.bool_(flags[1])
    delta = jnp.asarray(e["delta"])
    a, b = jnp.asarray(e["a"]), jnp.asarray(e["b"])
    sum_res, sum_w = jnp.float32(e["sum_res"]), jnp.float32(e["sum_w"])
    count = jnp.int32(e["count"])
    if e["color"] is not None:
        a_c, b_c, res_c, w_c = (jnp.asarray(v) for v in e["color"])
        a = 1.0 * a + 0.1 * a_c
        b = 1.0 * b + 0.1 * b_c
        sum_res = 1.0 * sum_res + 0.1 * res_c
        sum_w = 1.0 * sum_w + 0.1 * w_c
    mean, inv_std = jnp.asarray(e["mean"]), jnp.float32(e["inv_std"])
    planar = jnp.bool_(bool(e["planar"]))
    mean_res = sum_res / jnp.maximum(sum_w, 1e-12)
    done |= jnp.abs(last_res - mean_res) < gate.early_out
    last_res = mean_res
    cval = jnp.where(done, jnp.nan, mean_res)
    x, cond, degen = jtr._solve6(a, b, gate.cond)
    x_phys = x.at[3:6].set(x[3:6] / inv_std)
    step_ok = jtr._check_step(x_phys, gate.angle, gate.dist)
    bad = degen | ~step_ok | (count < 64) | planar
    lost |= bad & ~done
    use = ~done & ~bad
    delta = jnp.where(use, jtr._pose_from_x_whitened(x, mean, inv_std)
                      @ delta, delta)
    residual = jnp.where(use | done, mean_res, residual)
    corr = jnp.where(use | done, count, corr)
    condition = jnp.where(use, cond, condition)
    lvl_res = jnp.where(use | done, mean_res, lvl_res)
    lvl_cond = jnp.where(use, cond, lvl_cond)
    lvl_corr = jnp.where(use | done, count, lvl_corr)
    lvl_w = jnp.where(use | done, sum_w, lvl_w)
    done |= bad
    f = np.asarray
    return (f(delta), f(jnp.stack([residual, condition, lvl_res, lvl_cond,
                                   lvl_w, last_res])),
            f(jnp.stack([corr, lvl_corr])), np.array([bool(lost),
                                                      bool(done),
                                                      False]),
            f(cval), (f(x), f(cond), f(degen)))


def _plain(e):
    state, system, mean, inv_std, planar, color = iu.bank_inputs(e, "cpu")
    iu.icp_update_plain(state, system, mean, inv_std, planar, iu.BANK_GATE,
                        LEVEL, SLOT, e["begin"], color)
    return state


@pytest.mark.parametrize("case", iu.BANK_CASES)
def test_plain_update_matches_jax_tail(case):
    entries = [e for e in BANK if e["case"] == case]
    seen = []
    for e in entries:
        st = _plain(e)
        delta, vals, counts, flags, cval, solved = _jax_tail(e)
        np.testing.assert_array_equal(st.flags.numpy(), flags)
        np.testing.assert_array_equal(st.counts.numpy(), counts)
        np.testing.assert_allclose(st.delta.numpy(), delta, atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(st.vals.numpy(), vals, rtol=1e-3)
        np.testing.assert_allclose(st.curve[LEVEL, SLOT].numpy(), cval,
                                   rtol=1e-3)
        np.testing.assert_allclose(
            st.level_stats[LEVEL].numpy(),
            [vals[2], vals[3], counts[1], vals[4]], rtol=1e-3)
        if solved is not None:
            x, cond, degen = solved
            got = (st.x.numpy()[None], st.cond.numpy()[None],
                   st.degenerate.numpy()[None])
            c64 = np.linalg.svd(e["a"].astype(np.float64) if e["color"]
                                is None else (e["a"] + np.float32(0.1)
                                              * e["color"][0]).astype(
                                                  np.float64),
                                compute_uv=False)
            assert not s6.disagreements((x[None], cond[None], degen[None]),
                                        got, [c64[0] / c64[-1]], COND_THRES)
        else:
            np.testing.assert_array_equal(st.x.numpy(), 0.0)
        seen.append((bool(flags[0]), bool(flags[1]),
                     not np.array_equal(delta, e["delta"])))
    # the case takes the path its name says (lost, done, delta moved)
    want = {"normal": (False, False, True), "degenerate": (True, True, False),
            "angle": (True, True, False), "distance": (True, True, False),
            "count": (True, True, False), "planar": (True, True, False),
            "early_out": (False, True, False),
            "rgbd": (False, False, True),
            "begin_level": (False, False, True)}
    if case in want:
        assert all(s[1:] == want[case][1:] for s in seen), seen
        assert all(s[0] == want[case][0] for s, e in zip(seen, entries)
                   if not e["flags"][0]), seen
    elif case == "skip":
        assert all(not s[2] for s in seen)
    else:                                   # done: no step, not lost anew
        assert all(s[1] and not s[2] for s in seen)


def test_update_on_the_cpu_is_the_plain_version():
    """``icp_update`` on CPU tensors is ``icp_update_plain``, bit for bit,
    on a strided [6,6] view of an [8,8] system as the tracker passes it,
    and launches nothing."""
    e = BANK[0]
    st_ref = _plain(e)
    state, system, mean, inv_std, planar, color = iu.bank_inputs(e, "cpu")
    m = torch.zeros((8, 8))
    m[:6, :6] = system[0]
    launches = iu.icp_update.launches
    iu.icp_update(state, (m[:6, :6],) + system[1:], mean, inv_std, planar,
                  iu.BANK_GATE, LEVEL, SLOT, e["begin"], color)
    assert iu.icp_update.launches == launches
    assert iu.icp_update_plain.cuda_calls == 0
    for a, b in zip(state, st_ref):
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def test_wrapper_checks_and_arguments():
    """The launch arguments and the refusals, which run on the CPU."""
    e = next(e for e in BANK if e["case"] == "rgbd")
    state, system, mean, inv_std, planar, color = iu.bank_inputs(e, "cpu")
    m = torch.zeros((8, 8))
    m[:6, :6] = system[0]
    args = iu.prepare(state, (m[:6, :6],) + system[1:], mean, inv_std,
                      planar, iu.BANK_GATE, LEVEL, SLOT, 3, color)
    assert len(args) == 32 and args[-1] == state.delta.device
    assert args[21:25] == (8, 6, iu.MIN_CORR, 3)
    assert args[16].value == state.level_stats[LEVEL].data_ptr()
    assert args[17].value == state.curve[LEVEL, SLOT].data_ptr()
    args = iu.prepare(state, system, mean, inv_std, None, iu.BANK_GATE,
                      LEVEL, SLOT)
    assert args[5].value is None and args[11].value is None
    a, b, sum_res, sum_w, count = system
    bad = [
        dict(system=(a.double(), b, sum_res, sum_w, count)),
        dict(system=(torch.zeros((6, 12))[:, ::2], b, sum_res, sum_w,
                     count)),
        dict(system=(a, torch.zeros(7), sum_res, sum_w, count)),
        dict(system=(a, b, sum_res, sum_w, count.long())),
        dict(system=(a, b, sum_res[None], sum_w, count)),
        dict(mean=torch.zeros(4)),
        dict(planar=torch.zeros(())),
        dict(color=(a, b, sum_res, sum_w.double())),
        dict(state=state._replace(flags=state.flags.int())),
        dict(state=state._replace(delta=state.delta.T)),
        dict(level=2), dict(slot=4),
        dict(system=(a.to("meta"), b, sum_res, sum_w, count)),
    ]
    base = dict(state=state, system=system, mean=mean, inv_std=inv_std,
                planar=planar, gate=iu.BANK_GATE, level=LEVEL, slot=SLOT,
                color=color)
    for change in bad:
        with pytest.raises(ValueError):
            iu.prepare(**{**base, **change})
    meta = iu.new_state(2, 4, "meta")
    with pytest.raises(ValueError, match="no kernel"):
        iu.icp_update(meta, tuple(t.to("meta") for t in system),
                      mean.to("meta"), inv_std.to("meta"), None,
                      iu.BANK_GATE, LEVEL, SLOT)


def test_track_runs_one_update_a_solve(monkeypatch):
    """``tracking.track`` calls the update once per inner iteration, with
    the begin bits, levels and slots the carry needs."""
    from voxelhashing_tpu_torch import tracking as ttr
    from voxelhashing_tpu_torch.config import CameraConfig, TrackerConfig
    from voxelhashing_tpu_torch.io.synthetic import Scene, render_depth
    from voxelhashing_tpu_torch.ops import image as timg
    from voxelhashing_tpu_torch.config import FilterConfig
    cam = CameraConfig(width=40, height=30, fx=32.5, fy=32.5, cx=19.5,
                       cy=14.5)
    cfg = TrackerConfig(levels=2, max_outer_iter=(3, 2),
                        max_inner_iter=(2, 1))
    d, c = render_depth(np.eye(4, dtype=np.float32), cam, Scene(),
                        device="cpu")
    f = timg.preprocess(torch.nan_to_num(d), c, cam, FilterConfig())
    calls = []
    real = ttr.icp_update

    def spy(state, system, mean, inv_std, planar, gate, level, slot, begin,
            color, weights):
        calls.append((level, slot, begin, planar is None, color is None))
        return real(state, system, mean, inv_std, planar, gate, level, slot,
                    begin, color, weights)

    monkeypatch.setattr(ttr, "icp_update", spy)
    res = ttr.track(f.points, f.normals, f.points, f.normals,
                    torch.eye(4), cam, cfg)
    L, O = iu.BEGIN_LEVEL, iu.BEGIN_OUTER
    assert [c[:3] for c in calls] == [
        (1, 0, L | O), (1, 1, O), (0, 0, L | O), (0, 1, 0), (0, 2, O),
        (0, 3, 0), (0, 4, O), (0, 5, 0)]
    assert all(not c[3] and c[4] for c in calls)
    assert bool(res.valid)


def test_bytes_and_operations():
    assert iu.bytes_moved(False, True) == (4 * 44 + 4 + 12 + 4 + 1 + 99) \
        + (99 + 16 + 4 + 24 + 4 + 1)
    assert iu.bytes_moved(True, False) - iu.bytes_moved(False, False) == 176
    f64, f32 = iu.operations(5, True)
    assert f64 == s6.operations([5])
    assert f32 == iu.F32_TAIL_OPS + iu.F32_RGBD_OPS


# ---------------------------------------------------------------------------
# The kernel's 6x6 solve, modelled in numpy f64
# ---------------------------------------------------------------------------

MAX_SWEEPS, ROTATE_TOL, NOISE = 10, 1e-15, 2.0 ** -52


def _rounds():
    """The circle method as ``csrc/solve6.cu`` writes it (pair_p, pair_q):
    in round r, 0 meets e_0, e_1 meets e_4, e_2 meets e_3, e_i = 1 + (i +
    r) % 5."""
    def e(r, i):
        return 1 + (i + r) % 5
    return [[tuple(sorted(p)) for p in ((0, e(r, 0)), (e(r, 1), e(r, 4)),
                                        (e(r, 2), e(r, 3)))]
            for r in range(5)]


def _model_solve(a, b, cond_thres):
    """The kernel's solve in f64: Gram matrix, the rounds' three rotations
    each taken from the same G then applied, the gate with its noise
    floor, a whole sweep without a rotation (or the cap) to stop, the
    clamp of eigenvalues below 0, cond and x as the kernel forms them.
    Returns (x f32[6], cond f32, degenerate, sweeps)."""
    finite = bool(np.all(np.isfinite(a)))
    a = a.astype(np.float64)
    g, c, v = a.T @ a, a.T @ b.astype(np.float64), np.eye(6)
    floor = NOISE * np.trace(g)
    sweeps = 0
    while sweeps < MAX_SWEEPS:
        sweeps += 1
        rotated = False
        for rnd in _rounds():
            rots = []
            for p, q in rnd:
                gpq = g[p, q]
                if gpq * gpq > ROTATE_TOL ** 2 * (g[p, p] * g[q, q]) \
                        and abs(gpq) > floor:
                    d, e = g[q, q] - g[p, p], 2.0 * gpq
                    t = math.copysign(1.0, d) * e / (abs(d)
                                                    + math.sqrt(d * d + e * e))
                    cc = 1.0 / math.sqrt(1.0 + t * t)
                    rots.append((p, q, cc, t * cc, t))
            for p, q, cc, s, t in rots:
                gpq = g[p, q]
                for k in range(6):
                    if k not in (p, q):
                        gkp, gkq = g[k, p], g[k, q]
                        g[k, p] = g[p, k] = cc * gkp - s * gkq
                        g[k, q] = g[q, k] = s * gkp + cc * gkq
                g[p, p] -= t * gpq
                g[q, q] += t * gpq
                g[p, q] = g[q, p] = 0.0
                vp, vq = v[:, p].copy(), v[:, q].copy()
                v[:, p], v[:, q] = cc * vp - s * vq, s * vp + cc * vq
            rotated = rotated or bool(rots)
        if not rotated:
            break
    lam = np.diag(g).copy()
    sv = np.sqrt(np.where(lam > 0.0, lam, 0.0))
    s_max, s_min = ((np.nan, np.nan) if np.any(np.isnan(lam))
                    else (sv.max(), sv.min()))
    s0, s5 = np.float32(s_max), np.float32(s_min)
    cond = np.float32(s0 / max(s5, np.float32(1e-20)))
    degen = bool(s0 <= 0) or bool(cond > np.float32(cond_thres)) \
        or not finite
    s_cut = max(s_max / cond_thres, 1e-10)
    x = np.zeros(6)
    for j in range(6):
        if sv[j] > s_cut:
            x += v[:, j] * (v[:, j] @ c) / lam[j]
    return (np.zeros(6, np.float32) if degen else x.astype(np.float32),
            cond, degen, sweeps)


def test_rounds_hold_every_pair_once():
    rounds = _rounds()
    pairs = [p for rnd in rounds for p in rnd]
    assert sorted(pairs) == [(p, q) for p in range(6) for q in range(p + 1, 6)]
    assert all(len({i for p in rnd for i in p}) == 6 for rnd in rounds)


@pytest.mark.parametrize("kind", s6.BANK_KINDS)
def test_model_of_the_kernel_solve_meets_the_bounds(kind):
    """The kernel's algorithm against the plain f32 SVD on
    ``system_bank(7, 48, 2e4)`` (each kind's 48 systems, 144 in all):
    inside ``solve6.disagreements``, cond within 1e-4 of an f64 SVD's where
    not degenerate (the card's gate), and every system stopped by a sweep
    that rotated nothing, before the cap."""
    a, b, kinds = s6.system_bank(seed=7, n_per_kind=48,
                                 cond_thres=COND_THRES)
    sel = np.array([k == kind for k in kinds])
    a, b = a[sel], b[sel]
    outs = [_model_solve(a[i], b[i], COND_THRES) for i in range(len(a))]
    got = (np.stack([o[0] for o in outs]), np.array([o[1] for o in outs]),
           np.array([o[2] for o in outs]))
    ref = tuple(t.numpy() for t in s6.solve6_plain(
        torch.from_numpy(a), torch.from_numpy(b), COND_THRES))
    s64 = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    c64 = s64[:, 0] / np.maximum(s64[:, -1], 1e-20)
    assert not s6.disagreements(ref, got, c64, COND_THRES)
    ok = ~got[2]
    np.testing.assert_allclose(got[1][ok], c64[ok], rtol=1e-4)
    assert max(o[3] for o in outs) < MAX_SWEEPS


def test_model_non_finite_system_is_degenerate():
    a, b, _ = s6.system_bank(seed=7, n_per_kind=1, cond_thres=COND_THRES)
    a = a[0].copy()
    a[1, 2] = np.nan
    x, cond, degen, sweeps = _model_solve(a, b[0], COND_THRES)
    assert degen and np.all(x == 0.0) and np.isnan(cond) and sweeps == 1


def test_disagreements_hold_the_kernel_and_release_near_thresholds():
    """``icp_update.disagreements`` (what the card holds the kernel to):
    empty for the plain version against itself, a finding for each
    perturbed output, and nothing held when a threshold sits at the plain
    version's value."""
    e = next(e for e in BANK if e["case"] == "normal")
    state, system, mean, inv_std, planar, color = iu.bank_inputs(e, "cpu")
    ref = iu.clone_state(state)
    iu.icp_update_plain(ref, system, mean, inv_std, planar, iu.BANK_GATE,
                        LEVEL, SLOT, e["begin"], color)
    assert not iu.disagreements(state, ref, ref, mean, inv_std,
                                iu.BANK_GATE, LEVEL, SLOT)

    def bumped(field, index, value):
        got = iu.clone_state(ref)
        getattr(got, field)[index] = value
        return got

    res = float(ref.vals[0])
    for got, what in ((bumped("delta", (0, 3), float(ref.delta[0, 3]) + 1e-4),
                       "delta"),
                      (bumped("flags", 0, not bool(ref.flags[0])), "flags"),
                      (bumped("counts", 0, int(ref.counts[0]) + 1), "counts"),
                      (bumped("vals", 0, float(np.nextafter(np.float32(res),
                                                           np.float32(1)))),
                       "vals"),
                      (bumped("vals", 1, float(ref.vals[1]) * 1.01), "vals"),
                      (bumped("x", 0, float(ref.x[0]) + 1e-3), "solve")):
        found = iu.disagreements(state, ref, got, mean, inv_std,
                                 iu.BANK_GATE, LEVEL, SLOT)
        assert what in [f[0] for f in found], (what, found)
    x = ref.x.double().numpy()
    r = (np.array([[np.cos(x[0]), -np.sin(x[0]), 0], [np.sin(x[0]),
                                                      np.cos(x[0]), 0],
                   [0, 0, 1]])
         @ np.array([[np.cos(x[1]), 0, np.sin(x[1])], [0, 1, 0],
                     [-np.sin(x[1]), 0, np.cos(x[1])]])
         @ np.array([[1, 0, 0], [0, np.cos(x[2]), -np.sin(x[2])],
                     [0, np.sin(x[2]), np.cos(x[2])]]))
    at_angle = iu.BANK_GATE._replace(
        angle=math.acos((np.trace(r) - 1) / 2))
    assert not iu.disagreements(state, ref, bumped(
        "flags", 0, not bool(ref.flags[0])), mean, inv_std, at_angle, LEVEL,
        SLOT)
