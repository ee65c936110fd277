"""The tracker's ICP update: one kernel a 6x6 solve (``vh_icp_update`` in
``csrc/solve6.cu``).

No TPU kernel: the JAX tracker runs this tail as XLA inside its jitted
loop (``voxelhashing_tpu/tracking.py:560-590``, the solve ``_solve6`` at
:328-347). From the reduced normal equations of one inner iteration it
computes the mean residual and the early-out, the truncated-SVD solve,
the step gate, the de-whitened pose update ``delta <- P(x) delta`` and the
masked update of the tracker's carry, and it writes the carry in place.

The carry lives in the buffers of an :class:`IcpState` (:func:`new_state`)
with its dtypes: f32 ``delta``, f32 values, int32 counts, bool flags. A
level already done keeps its carry (the JAX tracker's ``lax.cond`` skip):
``skip`` is the ``done`` flag taken at an outer iteration's first solve,
and under it nothing of the carry changes and the curve's value is NaN.

:func:`icp_update` launches the kernel for CUDA tensors (one launch a
solve, on the current stream, no host read: it captures in
``engine.make_step``'s graphs) and runs the plain version,
:func:`icp_update_plain`, for CPU tensors; any other device raises. There
is no fallback. The plain version is the tracker's tail op for op around
``solve6_plain`` (``torch.linalg.svd``), and counts its calls on CUDA
tensors (``icp_update_plain.cuda_calls``). Each launch adds one to
``icp_update.launches``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from . import solve6 as s6
from .. import geometry as geom

N = s6.N
# the carry's f32 values, int32 counts and bool flags, in buffer order
VALS = ("residual", "condition", "lvl_res", "lvl_cond", "lvl_w", "last_res")
COUNTS = ("corr", "lvl_corr")
FLAGS = ("lost", "done", "skip")
# begin bits: the level's first solve (its carry reset), an outer
# iteration's first solve (skip taken from done)
BEGIN_LEVEL, BEGIN_OUTER = 1, 2
MIN_CORR = 64               # fewer correspondences: the step is bad


class IcpState(NamedTuple):
    """The tracker's carry and diagnostics, as buffers that the update
    writes in place."""
    delta: torch.Tensor        # f32[4,4] this frame's motion estimate
    vals: torch.Tensor         # f32[6] VALS
    counts: torch.Tensor       # int32[2] COUNTS
    flags: torch.Tensor        # bool[3] FLAGS
    level_stats: torch.Tensor  # f32[levels,4] (res, cond, corr, sum_w)
    curve: torch.Tensor        # f32[levels,max_iters] NaN-padded
    x: torch.Tensor            # f32[6] the last solve's whitened update
    cond: torch.Tensor         # f32[] its condition number
    degenerate: torch.Tensor   # bool[] its degenerate flag


class Gate(NamedTuple):
    """One level's thresholds."""
    early_out: float
    angle: float
    dist: float
    cond: float


def new_state(levels: int, max_iters: int, device) -> IcpState:
    """A frame's first carry: delta the identity, every value, count and
    flag 0 (``last_res`` inf), the curve NaN."""
    vals = torch.zeros((len(VALS),), dtype=torch.float32, device=device)
    # a fill on the device (an indexed store of a Python number copies
    # from the host, which a CUDA graph capture refuses)
    vals.narrow(0, VALS.index("last_res"), 1).fill_(torch.inf)
    return IcpState(
        delta=torch.eye(4, dtype=torch.float32, device=device), vals=vals,
        counts=torch.zeros((len(COUNTS),), dtype=torch.int32, device=device),
        flags=torch.zeros((len(FLAGS),), dtype=torch.bool, device=device),
        level_stats=torch.zeros((levels, 4), dtype=torch.float32,
                                device=device),
        curve=torch.full((levels, max_iters), torch.nan, dtype=torch.float32,
                         device=device),
        x=torch.zeros((N,), dtype=torch.float32, device=device),
        cond=torch.zeros((), dtype=torch.float32, device=device),
        degenerate=torch.zeros((), dtype=torch.bool, device=device))


def pose_from_x_whitened(x, mean, inv_std):
    """De-whiten the solved update: R unchanged,
    t = x_t/inv_std + mean - R.mean."""
    r = geom.euler_zyx_to_matrix(x[:3])
    m = torch.eye(4, dtype=torch.float32, device=x.device)
    m[:3, :3] = r
    m[:3, 3] = x[3:6] / inv_std + mean - r @ mean
    return m


def check_step(x, angle_thres: float, dist_thres: float):
    """Per-step plausibility gate (rotation angle and translation norm)."""
    ang = geom.rotation_angle(geom.euler_zyx_to_matrix(x[:3]))
    return (ang <= angle_thres) & (torch.linalg.vector_norm(x[3:6])
                                   <= dist_thres)


def icp_update_plain(state: IcpState, system, mean, inv_std, planar,
                     gate: Gate, level: int, slot: int, begin: int = 0,
                     color=None, weights=(1.0, 0.1)) -> None:
    """One ICP update in plain torch, written into ``state``: the carry,
    ``level_stats[level]``, ``curve[level, slot]`` and the solve's x,
    cond and degenerate (the last three left as they were under skip).

    ``system``: (a [6,6], b [6], sum_res, sum_w, count) as the reduction
    leaves them; ``color``: the RGB-D color system (a_c, b_c, res_c, w_c),
    folded in as ``weights[0] * depth + weights[1] * color``, or None;
    ``planar``: the planarity flag, or None when the gate is off;
    ``begin``: :data:`BEGIN_LEVEL` and :data:`BEGIN_OUTER` bits."""
    if state.delta.device.type == "cuda":
        icp_update_plain.cuda_calls += 1
    if begin & BEGIN_LEVEL:
        state.vals[2:5] = 0.0
        state.vals[5] = torch.inf
        state.counts[1] = 0
        state.flags[1] = False
    if begin & BEGIN_OUTER:
        state.flags[2] = state.flags[1]
    delta = state.delta
    residual, condition, lvl_res, lvl_cond, lvl_w, last_res = \
        state.vals.unbind()
    corr, lvl_corr = state.counts.unbind()
    lost, done, skip = state.flags.unbind()

    a, b, sum_res, sum_w, count = system
    if color is not None:
        a_c, b_c, res_c, w_c = color
        weight_depth, weight_color = weights
        a = weight_depth * a + weight_color * a_c
        b = weight_depth * b + weight_color * b_c
        sum_res = weight_depth * sum_res + weight_color * res_c
        sum_w = weight_depth * sum_w + weight_color * w_c
    mean_res = sum_res / torch.clamp(sum_w, min=1e-12)
    done = done | (torch.abs(last_res - mean_res) < gate.early_out)
    last_res = mean_res
    cval = torch.where(done, torch.nan, mean_res)

    x, cond, degen = s6.solve6_plain(a, b, gate.cond)
    x_phys = torch.cat([x[:3], x[3:6] / inv_std])
    step_ok = check_step(x_phys, gate.angle, gate.dist)
    bad = degen | ~step_ok | (count < MIN_CORR)
    if planar is not None:
        bad = bad | planar
    lost = lost | (bad & ~done)
    use = ~done & ~bad
    delta = torch.where(use, pose_from_x_whitened(x, mean, inv_std) @ delta,
                        delta)
    keep = use | done
    residual = torch.where(keep, mean_res, residual)
    corr = torch.where(keep, count, corr)
    condition = torch.where(use, cond, condition)
    lvl_res = torch.where(keep, mean_res, lvl_res)
    lvl_cond = torch.where(use, cond, lvl_cond)
    lvl_corr = torch.where(keep, count, lvl_corr)
    lvl_w = torch.where(keep, sum_w, lvl_w)
    done = done | bad

    # a level already done keeps its carry (JAX: lax.cond skip)
    new = ((state.delta, delta),
           (state.vals, torch.stack([residual, condition, lvl_res, lvl_cond,
                                     lvl_w, last_res])),
           (state.counts, torch.stack([corr, lvl_corr])),
           (state.flags, torch.stack([lost, done, skip])),
           (state.x, x), (state.cond, cond), (state.degenerate, degen))
    out = [torch.where(skip, old, nw) for old, nw in new]
    state.curve[level, slot] = torch.where(skip, torch.nan, cval)
    for (old, _), nw in zip(new, out):
        old.copy_(nw)
    state.level_stats[level] = torch.cat([
        state.vals[2:4], state.counts[1:].to(torch.float32),
        state.vals[4:5]])


icp_update_plain.cuda_calls = 0


def _check_inputs(state: IcpState, system, mean, inv_std, planar,
                  level: int, slot: int, color) -> None:
    f32, i32 = torch.float32, torch.int32
    a, b, sum_res, sum_w, count = system
    color = color or (None,) * 4
    a_c, b_c, res_c, w_c = color
    levels, max_iters = state.level_stats.shape[0], state.curve.shape[1]

    def mat(t):
        return t.dtype == f32 and tuple(t.shape) == (N, N) \
            and t.stride(1) == 1

    def vec(t, n, dtype=f32):
        return t.dtype == dtype and tuple(t.shape) == (n,) \
            and t.stride(0) == 1

    def scal(t, dtype=f32):
        return t.dtype == dtype and t.dim() == 0

    tensors = [t for t in (a, b, sum_res, sum_w, count, mean, inv_std,
                           planar, *color, *state) if t is not None]
    checks = [
        (all(t.device == state.delta.device for t in tensors),
         "every tensor on the carry's device"),
        (mat(a) and vec(b, N), "a must be f32 [6,6] with contiguous rows "
         "and b f32 [6], contiguous"),
        (scal(sum_res) and scal(sum_w) and scal(count, i32),
         "sum_res and sum_w must be f32 scalars and count an int32 one"),
        (vec(mean, 3) and scal(inv_std),
         "mean must be f32 [3], contiguous, and inv_std an f32 scalar"),
        (planar is None or scal(planar, torch.bool),
         "planar must be a bool scalar or None"),
        (a_c is None or (mat(a_c) and vec(b_c, N) and scal(res_c)
                         and scal(w_c)),
         "the color system must be shaped like the depth system"),
        (state.delta.dtype == f32 and tuple(state.delta.shape) == (4, 4)
         and state.delta.is_contiguous() and vec(state.vals, len(VALS))
         and vec(state.counts, len(COUNTS), i32)
         and vec(state.flags, len(FLAGS), torch.bool)
         and state.level_stats.dtype == f32
         and state.level_stats.shape[1:] == (4,)
         and state.level_stats.is_contiguous()
         and state.curve.dtype == f32 and state.curve.dim() == 2
         and state.curve.is_contiguous() and vec(state.x, N)
         and scal(state.cond) and scal(state.degenerate, torch.bool),
         "the state must be new_state's buffers"),
        (0 <= level < levels and 0 <= slot < max_iters,
         "level and slot must lie inside level_stats and curve"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"icp_update: {msg}")


def prepare(state: IcpState, system, mean, inv_std, planar, gate: Gate,
            level: int, slot: int, begin: int = 0, color=None,
            weights=(1.0, 0.1)):
    """Check the inputs; returns the launch arguments."""
    _check_inputs(state, system, mean, inv_std, planar, level, slot, color)
    a, b, sum_res, sum_w, count = system
    a_c, b_c, res_c, w_c = color or (None,) * 4
    p, pn = _build.ptr, _build.ptr_or_null
    return (p(a), p(b), p(sum_res), p(sum_w), p(count), pn(a_c), pn(b_c),
            pn(res_c), pn(w_c), p(mean), p(inv_std), pn(planar),
            p(state.delta), p(state.vals), p(state.counts), p(state.flags),
            p(state.level_stats[level]), p(state.curve[level, slot]),
            p(state.x), p(state.cond), p(state.degenerate), a.stride(0),
            a.stride(0) if a_c is None else a_c.stride(0), MIN_CORR,
            int(begin), float(weights[0]), float(weights[1]),
            float(gate.early_out), float(gate.angle), float(gate.dist),
            float(gate.cond), state.delta.device)


def launch(args) -> None:
    """Launch the kernel on prepared arguments, on the current stream (the
    only place that does; counts the launch)."""
    *kernel_args, device = args
    _build.check(_build.library("solve6").vh_icp_update(
        *kernel_args, _build.stream_ptr(device)), "solve6")
    icp_update.launches += 1


def icp_update(state: IcpState, system, mean, inv_std, planar, gate: Gate,
               level: int, slot: int, begin: int = 0, color=None,
               weights=(1.0, 0.1)) -> None:
    """One ICP update written into ``state`` (see
    :func:`icp_update_plain`): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    dev = state.delta.device
    if dev.type == "cpu":
        icp_update_plain(state, system, mean, inv_std, planar, gate, level,
                         slot, begin, color, weights)
        return
    if dev.type != "cuda":
        raise ValueError(f"icp_update: no kernel for {dev}")
    launch(prepare(state, system, mean, inv_std, planar, gate, level, slot,
                   begin, color, weights))


icp_update.launches = 0


def launch_empty(device) -> None:
    """An empty kernel on the current stream: the launch floor a graph
    node costs (measurement only; not counted)."""
    _build.check(_build.library("solve6").vh_empty(
        _build.stream_ptr(device)), "solve6")


# f32 operations of the tail outside the solve (counted on csrc/solve6.cu
# with adds, multiplies, divisions, comparisons and math functions one
# each): the mean residual and early-out (5), the de-whitened t (3), R (6
# sines and cosines, two 3x3 products: 96), the angle and norm (12), the
# gate (6), P's translation (21), P delta (84); and the RGB-D fold (3 per
# entry of a, b and the two sums)
F32_TAIL_OPS = 5 + 3 + 96 + 12 + 6 + 21 + 84
F32_RGBD_OPS = 3 * (N * N + N + 2)


def bytes_moved(rgbd: bool, planar: bool) -> int:
    """The least bytes one update must move: each input read once (the
    system, the whitening, the flag, the carry), each output written once
    (the carry, the stats row, the curve's value, x, cond, degenerate)."""
    system = 4 * (N * N + N + 2) + 4
    color = 4 * (N * N + N + 2) if rgbd else 0
    carry = 4 * 16 + 4 * len(VALS) + 4 * len(COUNTS) + len(FLAGS)
    reads = system + color + 4 * 3 + 4 + (1 if planar else 0) + carry
    writes = carry + 4 * 4 + 4 + 4 * N + 4 + 1
    return reads + writes


def operations(sweeps: int, rgbd: bool):
    """(f64, f32) operations of one update whose solve ran ``sweeps``
    Jacobi sweeps."""
    return (s6.operations([sweeps]),
            F32_TAIL_OPS + (F32_RGBD_OPS if rgbd else 0))


# ---------------------------------------------------------------------------
# A seeded bank of updates, and the bounds that hold the kernel to the
# plain version
# ---------------------------------------------------------------------------

BANK_CASES = ("normal", "degenerate", "angle", "distance", "count",
              "planar", "done", "early_out", "skip", "rgbd", "begin_level")
BANK_GATE = Gate(early_out=0.01, angle=1.0, dist=1.0, cond=2.0e4)
# the kernel's pose against the plain version's: f32 entries up to ~3 (a
# translation through R mean, with |mean| up to 3 m) carry a few ulp
# (2.4e-7 at 2-4) from the kernel's own sums where cuBLAS fuses multiply-
# adds; and the solve's own difference |dx| (held by
# solve6.disagreements) moves R by at most 3 |dx| an entry and t by
# |dx| / inv_std + 9 |dx| |mean|: within 16 |dx| (1 + 1/inv_std + |mean|)
POSE_TOL = 4e-6
POSE_DX_GAIN = 16.0
# where the plain version's values sit this close to a threshold (relative)
# the flags are not held (the cond gate: solve6.disagreements' 0.1%)
NEAR = 1e-6


def _rotation(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return q * np.sign(np.linalg.det(q))


def _system(rng, x, rank3: bool = False):
    """A tracker-sized f32 system ``a x = b`` (cond 1-100, or rank 3)."""
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    s0 = 10 ** rng.uniform(2, 5)
    if rank3:
        s = np.concatenate([s0 * 10 ** rng.uniform(-1.5, 0, 3),
                            s0 * 1e-9 * rng.uniform(0, 1, 3)])
    else:
        cond = 10 ** rng.uniform(0, 2)
        s = s0 * np.exp(np.sort(rng.uniform(-np.log(cond), 0, N))[::-1])
        s[0], s[-1] = s0, s0 / cond
    a = (q * s) @ q.T
    a = a + a * rng.standard_normal((N, N)) * 1e-7
    return a.astype(np.float32), (a @ x).astype(np.float32)


def update_bank(seed: int, n_per_case: int):
    """Seeded inputs of one update each, ``n_per_case`` of each of
    :data:`BANK_CASES` (with :data:`BANK_GATE`): a normal step, a
    degenerate (rank-3) system, a step over the angle limit (~1.3 rad)
    and one over the distance limit (~1.5 m), fewer than 64
    correspondences, the planarity flag set, a level already done (not
    skipped), the residual early-out, a skipped iteration, an RGB-D system
    (weights 1.0 and 0.1), and a level's first solve over a stale carry.
    Each is a dict of numpy arrays and ints: a, b, sum_res, sum_w, count,
    color (a_c, b_c, res_c, w_c, or None), mean, inv_std, planar (None,
    False or True), delta, vals, counts, flags, begin, case."""
    rng = np.random.default_rng(seed)
    out = []
    for case in BANK_CASES:
        for _ in range(n_per_case):
            inv_std = rng.uniform(2.0, 6.0)
            rot = rng.uniform(-0.05, 0.05, 3)
            t_w = rng.uniform(-0.05, 0.05, 3)
            if case == "angle":
                rot = np.array([1.3, 0.0, 0.0]) + rot * 0.1
            if case == "distance":
                u = rng.standard_normal(3)
                t_w = 1.5 * inv_std * u / np.linalg.norm(u)
            x = np.concatenate([rot, t_w])
            a, b = _system(rng, x, rank3=case == "degenerate")
            sum_w = 10 ** rng.uniform(2, 4)
            mean_res = rng.uniform(1e-5, 1e-3)
            color = None
            if case == "rgbd":
                a_c, b_c = _system(rng, x)
                color = (a_c, b_c, np.float32(mean_res * sum_w * 0.5),
                         np.float32(sum_w * 0.3))
            r = _rotation(rng) if case != "normal" else np.eye(3)
            delta = np.eye(4)
            delta[:3, :3] = r if rng.uniform() < 0.5 else np.eye(3)
            delta[:3, 3] = rng.uniform(-0.05, 0.05, 3)
            vals = np.array([rng.uniform(1e-5, 1e-3), rng.uniform(1, 1e3),
                             rng.uniform(1e-5, 1e-3), rng.uniform(1, 1e3),
                             rng.uniform(1, 1e4), mean_res + 0.5])
            if case == "early_out":
                vals[5] = mean_res + 0.3 * BANK_GATE.early_out
            done = case in ("done", "skip", "begin_level")
            skip = case in ("skip", "begin_level")
            out.append({
                "a": a, "b": b, "sum_res": np.float32(mean_res * sum_w),
                "sum_w": np.float32(sum_w),
                "count": np.int32(rng.integers(0, 64) if case == "count"
                                  else rng.integers(200, 5000)),
                "color": color,
                "mean": np.array([rng.uniform(-0.5, 0.5),
                                  rng.uniform(-0.5, 0.5),
                                  rng.uniform(1.5, 3.0)], np.float32),
                "inv_std": np.float32(inv_std),
                "planar": (True if case == "planar" else
                           None if rng.uniform() < 0.5 else False),
                "delta": delta.astype(np.float32),
                "vals": vals.astype(np.float32),
                "counts": rng.integers(0, 5000, 2).astype(np.int32),
                "flags": np.array([rng.uniform() < 0.3, done, skip]),
                "begin": (BEGIN_LEVEL | BEGIN_OUTER if case == "begin_level"
                          else 0 if case in ("done", "skip")
                          else BEGIN_OUTER),
                "case": case})
    return out


def bank_inputs(entry, device, levels: int = 2, max_iters: int = 4):
    """One :func:`update_bank` entry as tensors on ``device``: (state,
    system, mean, inv_std, planar, color); the update's level is 1 and its
    slot 2."""
    def t(v):
        return torch.from_numpy(np.array(v)).to(device)

    state = new_state(levels, max_iters, device)
    for name in ("delta", "vals", "counts", "flags"):
        getattr(state, name).copy_(t(entry[name]))
    system = (t(entry["a"]), t(entry["b"]), t(entry["sum_res"]),
              t(entry["sum_w"]), t(entry["count"]))
    color = (None if entry["color"] is None
             else tuple(t(v) for v in entry["color"]))
    planar = None if entry["planar"] is None else t(bool(entry["planar"]))
    return state, system, t(entry["mean"]), t(entry["inv_std"]), planar, \
        color


def clone_state(state: IcpState) -> IcpState:
    return IcpState(*(t.clone() for t in state))


def disagreements(before: IcpState, ref: IcpState, got: IcpState, mean,
                  inv_std, gate: Gate, level: int, slot: int):
    """Where ``got`` (the kernel's update of ``before``) leaves the bounds
    around ``ref`` (the plain version's), as a list of (what, values).
    Where the plain version's values sit within :data:`NEAR` (relative)
    of a threshold, or cond within 0.1% of ``gate.cond``, nothing is
    held. Elsewhere: the flags, the counts and the curve's value equal;
    the residual values bit-equal; cond and x within
    ``solve6.disagreements``; every delta entry within :data:`POSE_TOL` +
    :data:`POSE_DX_GAIN` |dx| (1 + 1/inv_std + |mean|)."""
    def np_(t):
        return t.detach().cpu().numpy()

    r = {k: np_(v) for k, v in ref._asdict().items()}
    g = {k: np_(v) for k, v in got._asdict().items()}
    b = {k: np_(v) for k, v in before._asdict().items()}
    x = r["x"].astype(np.float64)
    x_t = x[3:6] / float(inv_std)
    ca, sa = np.cos(x[:3]), np.sin(x[:3])
    rz = np.array([[ca[0], -sa[0], 0], [sa[0], ca[0], 0], [0, 0, 1]])
    ry = np.array([[ca[1], 0, sa[1]], [0, 1, 0], [-sa[1], 0, ca[1]]])
    rx = np.array([[1, 0, 0], [0, ca[2], -sa[2]], [0, sa[2], ca[2]]])
    ang = math.acos(min(1.0, max(-1.0, (np.trace(rz @ ry @ rx) - 1) / 2)))
    mean_res = float(r["vals"][VALS.index("last_res")])
    last_in = float(b["vals"][VALS.index("last_res")])
    near = [abs(ang - gate.angle) <= NEAR * gate.angle,
            abs(np.linalg.norm(x_t) - gate.dist) <= NEAR * gate.dist,
            abs(float(r["cond"]) - gate.cond) <= 1e-3 * gate.cond,
            math.isfinite(last_in) and abs(abs(last_in - mean_res)
                                           - gate.early_out)
            <= NEAR * gate.early_out]
    if any(near):
        return []
    def cond_close(rv, gv):
        return np.all((rv == gv) | (np.abs(gv - rv) <= np.maximum(
            1e-4, 1e-6 * np.abs(rv)) * np.abs(rv)))

    bad = []
    for k in ("flags", "counts", "curve"):
        if not np.array_equal(r[k], g[k], equal_nan=True):
            bad.append((k, r[k], g[k]))
    # the residual values bit for bit, the condition numbers within cond's
    # bound (columns 1 of level_stats, 1 and 3 of vals)
    for k, cond_cols in (("vals", [1, 3]), ("level_stats", [1])):
        rv, gv = r[k].reshape(-1, r[k].shape[-1]), g[k].reshape(
            -1, g[k].shape[-1])
        other = [c for c in range(rv.shape[1]) if c not in cond_cols]
        if not (np.array_equal(rv[:, other], gv[:, other], equal_nan=True)
                and cond_close(rv[:, cond_cols], gv[:, cond_cols])):
            bad.append((k, r[k], g[k]))
    if not r["flags"][2]:
        cond64 = np.array([float(r["cond"])])
        bad += [("solve", *d[1:]) for d in s6.disagreements(
            (r["x"][None], r["cond"][None], r["degenerate"][None]),
            (g["x"][None], g["cond"][None], g["degenerate"][None]),
            cond64, gate.cond)]
    dx = float(np.max(np.abs(g["x"].astype(np.float64) - x)))
    tol = POSE_TOL + POSE_DX_GAIN * dx * (
        1.0 + 1.0 / float(inv_std) + float(np.max(np.abs(np_(mean)))))
    err = float(np.max(np.abs(g["delta"].astype(np.float64)
                              - r["delta"])))
    if not err <= tol:
        bad.append(("delta", err, tol))
    return bad
