"""The tracker's ICP update of the reference: a frozen copy of the plain
version of voxelhashing_tpu_torch/ops/icp_update.py (the mean
residual and the early-out, the truncated-SVD solve by
torch.linalg.svd, the step gate, the de-whitened pose update and the
masked update of the tracker's carry).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import geometry as geom

N = 6
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


def solve6(a, b, cond_thres: float):
    """Truncated-SVD solve of the 6x6 system with the condition gate
    (``torch.linalg.svd``). A non-finite ``a`` is degenerate (x = 0, cond
    NaN): ``torch.linalg.svd`` refuses such input, so it sees zeros
    there."""
    finite = torch.all(torch.isfinite(a))
    u, s, vt = torch.linalg.svd(torch.where(finite, a, 0.0),
                                full_matrices=False)
    cond = s[0] / torch.clamp(s[5], min=1e-20)
    degenerate = (s[0] <= 0.0) | (cond > cond_thres) | ~finite
    s_min = torch.clamp(s[0] / cond_thres, min=1e-10)
    s_inv = torch.where(s > s_min, 1.0 / s, 0.0)
    x = vt.T @ (s_inv * (u.T @ b))
    return (torch.where(degenerate, 0.0, x),
            torch.where(finite, cond, torch.nan), degenerate)


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

    x, cond, degen = solve6(a, b, gate.cond)
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
