"""Frame-to-model camera tracking: multi-resolution projective ICP
(PyTorch port of ``voxelhashing_tpu.tracking``).

Projective association, whitened point-to-plane normal equations as one
[8,P] x [P,8] f32 product (TF32 is off in this package), a truncated-SVD
6x6 solve with the condition gate, per-step plausibility and planarity
gates, coarse-to-fine levels with residual early-out. With intensities
(RGB-D tracking) photometric rows join each system, built in the same
whitened parametrization, and the planarity gate and probe are off.

The JAX tracker skips a converged level's outer iterations with
``lax.cond``; here every iteration runs and a level that was already done
keeps its carry unchanged (the masked form), which gives identical results
without reading the device. Each inner iteration's tail (the 6x6 solve,
the step gate, the pose update and the carry) is ``ops/icp_update``: one
kernel on CUDA that writes the carry's buffers in place, the plain torch
tail around ``torch.linalg.svd`` on the CPU; so tracking reads nothing on
the host and can be captured in a CUDA graph.

``reduce_fn`` (the multi-device step, ``parallel/sharded.py``) reduces
each tuple of partial sums across ranks at JAX's points: the whitening
moments, the planarity scatter and the normal equations (with RGB-D, the
depth and photometric systems together, before they are weighted). The
input maps are then the rank's row shard and the model maps are global.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .config import CameraConfig, TrackerConfig
from . import geometry as geom
from .ops.icp_update import (BEGIN_LEVEL, BEGIN_OUTER, Gate, icp_update,
                             new_state)
from .ops.image import resample_half


class TrackingResult(NamedTuple):
    pose: torch.Tensor        # f32[4,4] new camera-to-world estimate
    valid: torch.Tensor       # bool[]   False = tracking lost
    residual: torch.Tensor    # f32[]    mean point-to-plane residual
    corr_count: torch.Tensor  # int32[]  correspondences at the finest level
    condition: torch.Tensor   # f32[]    condition number of the last solve
    level_stats: torch.Tensor     # f32[levels,4] (res, cond, corr, sum_w)
    iter_residuals: torch.Tensor  # f32[levels,max_iters] NaN-padded
    planarity: torch.Tensor       # f32[] I2 of the input normals' scatter


def stats_shapes(cfg: TrackerConfig):
    """Static shapes of TrackingResult.level_stats / .iter_residuals."""
    max_iters = max(o * i for o, i in
                    zip(cfg.max_outer_iter, cfg.max_inner_iter))
    return (cfg.levels, 4), (cfg.levels, max_iters)


def empty_stats(cfg: TrackerConfig, device):
    """Zero/NaN-filled diagnostic arrays (frame 0 / GT-trajectory mode)."""
    s_shape, c_shape = stats_shapes(cfg)
    return (torch.zeros(s_shape, dtype=torch.float32, device=device),
            torch.full(c_shape, torch.nan, dtype=torch.float32,
                       device=device))


def _level_camera(cam: CameraConfig, level: int) -> CameraConfig:
    """Intrinsics of pyramid level ``level`` (even-pixel decimation)."""
    s = 1 << level
    return dataclasses.replace(
        cam, width=cam.width // s, height=cam.height // s,
        fx=cam.fx / s, fy=cam.fy / s, cx=cam.cx / s, cy=cam.cy / s)


def build_pyramid(points, normals, levels: int):
    """Decimation pyramid of (points, normals), level 0 = finest."""
    pyr = [(points, normals)]
    for _ in range(1, levels):
        points = resample_half(points)
        normals = resample_half(normals)
        pyr.append((points, normals))
    return pyr


def _soa(m):
    """[h,w,3] map -> flat per-component ([P],[P],[P])."""
    f = m.reshape(-1)
    return f[0::3], f[1::3], f[2::3]


def _interleave_target(tgt_pts, tgt_nrm):
    """[h,w,3] model maps -> one [P,8] row table (q, n_q, 0, 0)."""
    p = tgt_pts.reshape(-1, 3)
    n = tgt_nrm.reshape(-1, 3)
    return torch.cat([p, n, torch.zeros((p.shape[0], 2), dtype=p.dtype,
                                        device=p.device)], dim=1)


def _associate(delta, in_soa, tgt8, cam: CameraConfig, dist_thres: float,
               normal_thres: float, depth_min: float, depth_max: float):
    """Projective correspondences at the current delta: transform, project,
    1x1 lookup, reject by distance and normal agreement, confidence
    weight. Returns (q, nq, wgt, ok) SoA."""
    ipx, ipy, ipz, inx, iny, inz = in_soa
    r, t = delta[:3, :3], delta[:3, 3]
    px = r[0, 0] * ipx + r[0, 1] * ipy + r[0, 2] * ipz + t[0]
    py = r[1, 0] * ipx + r[1, 1] * ipy + r[1, 2] * ipz + t[1]
    pz = r[2, 0] * ipx + r[2, 1] * ipy + r[2, 2] * ipz + t[2]
    nx = r[0, 0] * inx + r[0, 1] * iny + r[0, 2] * inz
    ny = r[1, 0] * inx + r[1, 1] * iny + r[1, 2] * inz
    nz = r[2, 0] * inx + r[2, 1] * iny + r[2, 2] * inz

    safe_z = torch.where(pz == 0.0, 1e-12, pz)
    uf = px * cam.fx / safe_z + cam.cx
    vf = py * cam.fy / safe_z + cam.cy
    ui = torch.floor(uf + 0.5).to(torch.int32)
    vi = torch.floor(vf + 0.5).to(torch.int32)
    on = ((ui >= 0) & (ui < cam.width) & (vi >= 0) & (vi < cam.height)
          & (pz > 0.0))
    lin = torch.where(on, vi * cam.width + ui, 0).long()

    g8 = tgt8[lin].T                                  # [8,P]
    qx, qy, qz = g8[0], g8[1], g8[2]
    nqx, nqy, nqz = g8[3], g8[4], g8[5]

    dx, dy, dz = px - qx, py - qy, pz - qz
    dist2 = dx * dx + dy * dy + dz * dz
    ndot = nx * nqx + ny * nqy + nz * nqz
    fin = torch.ones_like(on)
    for a in (px, py, pz, nx, ny, nz, qx, qy, qz, nqx, nqy, nqz):
        fin = fin & torch.isfinite(a)
    ok = (on & fin & (dist2 <= dist_thres * dist_thres)
          & (ndot >= normal_thres))

    dist = torch.sqrt(dist2)
    depth01 = torch.clamp(geom.div_const(pz - depth_min,
                                         depth_max - depth_min), 0.0, 1.0)
    wgt = 0.5 * ((1.0 - geom.div_const(dist, dist_thres)) + (1.0 - depth01))
    wgt = torch.where(ok, torch.clamp(wgt, min=0.0), 0.0)
    zero = torch.zeros_like(qx)
    q = (torch.where(ok, qx, zero), torch.where(ok, qy, zero),
         torch.where(ok, qz, zero))
    nq = (torch.where(ok, nqx, zero), torch.where(ok, nqy, zero),
          torch.where(ok, nqz, zero))
    return q, nq, wgt, ok


def _no_reduce(sums):
    return sums


def _whitening(q, ok, reduce_sys=_no_reduce):
    """Centroid and inverse scale of the valid correspondence targets
    (moments reduced by ``reduce_sys``)."""
    qx, qy, qz = q
    okf = ok.to(torch.float32)
    sum_q = torch.stack([torch.sum(qx * okf), torch.sum(qy * okf),
                         torch.sum(qz * okf)])
    sum_qq = torch.sum((qx * qx + qy * qy + qz * qz) * okf)
    sum_q, sum_qq, cnt = reduce_sys((sum_q, sum_qq, torch.sum(okf)))
    n = torch.clamp(cnt, min=1.0)
    mean = sum_q / n
    var = torch.clamp(sum_qq / n - torch.sum(mean * mean), min=1e-8)
    return mean, torch.rsqrt(var)


def _planarity(in_soa, wgt, thres: float, reduce_sys=_no_reduce):
    """Planar-degeneracy probe: second invariant I2 of the unit-trace
    weighted scatter of the accepted input normals (the scatter reduced by
    ``reduce_sys``). Returns (planar, i2)."""
    use = wgt > 0.0
    nr = torch.stack([torch.where(use, in_soa[3], 0.0),
                      torch.where(use, in_soa[4], 0.0),
                      torch.where(use, in_soa[5], 0.0)], dim=0)   # [3,P]
    s = (nr * wgt[None, :]) @ nr.T                               # [3,3]
    (s,) = reduce_sys((s,))
    tr = s[0, 0] + s[1, 1] + s[2, 2]
    sh = s / torch.clamp(tr, min=1e-12)
    i2 = 0.5 * (1.0 - torch.sum(sh * sh.T))
    return (i2 < thres) & (tr > 0.0), i2


def _linearize(delta, in_soa, q, nq, wgt, ok, mean, inv_std):
    """Whitened point-to-plane normal equations about ``delta`` against
    fixed correspondences. Returns (A[6,6], b[6], sum_res, sum_w, count)."""
    ipx, ipy, ipz = in_soa[0], in_soa[1], in_soa[2]
    r, t = delta[:3, :3], delta[:3, 3]
    px = r[0, 0] * ipx + r[0, 1] * ipy + r[0, 2] * ipz + t[0]
    py = r[1, 0] * ipx + r[1, 1] * ipy + r[1, 2] * ipz + t[1]
    pz = r[2, 0] * ipx + r[2, 1] * ipy + r[2, 2] * ipz + t[2]
    # rejected rows carry NaN positions: zero them with where(), not *0
    pcx = torch.where(ok, (px - mean[0]) * inv_std, 0.0)
    pcy = torch.where(ok, (py - mean[1]) * inv_std, 0.0)
    pcz = torch.where(ok, (pz - mean[2]) * inv_std, 0.0)
    qx, qy, qz = q
    okf = ok.to(torch.float32)
    qcx = (qx - mean[0]) * inv_std * okf
    qcy = (qy - mean[1]) * inv_std * okf
    qcz = (qz - mean[2]) * inv_std * okf
    nqx, nqy, nqz = nq
    e = nqx * (pcx - qcx) + nqy * (pcy - qcy) + nqz * (pcz - qcz)
    e = torch.where(ok, e, 0.0)
    crx = pcy * nqz - pcz * nqy
    cry = pcz * nqx - pcx * nqz
    crz = pcx * nqy - pcy * nqx
    jrows = torch.stack([crz, cry, crx, nqx, nqy, nqz, e,
                         torch.ones_like(e)], dim=0)          # [8,P]
    m = (jrows * wgt[None, :]) @ jrows.T                      # [8,8] f32
    return (m[:6, :6], -m[6, :6], m[6, 6], m[7, 7],
            torch.sum(ok, dtype=torch.int32))


def _build_system_color(delta, in_pts, in_int, tgt_int, tgt_gx, tgt_gy,
                        cam: CameraConfig, dist_sigma: float,
                        mean=None, inv_std=None):
    """Photometric rows of the joint RGB-D system: residual
    e = I_model(pi(delta p)) - I_input(p), the model intensity sampled
    bilinearly at the continuous projection and its gradients at the
    nearest pixel; jacobian a = J_pi^T grad(I), row [(p - mean) x a
    reversed | a / inv_std] (the depth block's whitened parametrization).
    Returns (A[6,6], b[6], sum_res, sum_w, count)."""
    dev = in_pts.device
    if mean is None:
        mean = torch.zeros((3,), dtype=torch.float32, device=dev)
    if inv_std is None:
        inv_std = torch.ones((), dtype=torch.float32, device=dev)
    r = delta[:3, :3]
    p = in_pts @ r.T + delta[:3, 3]
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]

    safe_pz = torch.where(pz == 0.0, 1e-12, pz)
    uf = px * cam.fx / safe_pz + cam.cx
    vf = py * cam.fy / safe_pz + cam.cy
    on = ((uf >= 0.0) & (uf <= cam.width - 1.0)
          & (vf >= 0.0) & (vf <= cam.height - 1.0) & (pz > 0.0))
    uf_c = torch.clamp(uf, 0.0, cam.width - 1.0)
    vf_c = torch.clamp(vf, 0.0, cam.height - 1.0)
    u0 = torch.clamp(torch.floor(uf_c).to(torch.int32), 0, cam.width - 2)
    v0 = torch.clamp(torch.floor(vf_c).to(torch.int32), 0, cam.height - 2)
    fu = uf_c - u0.to(torch.float32)
    fv = vf_c - v0.to(torch.float32)
    u0, v0 = u0.long(), v0.long()
    i00 = tgt_int[v0, u0]
    i01 = tgt_int[v0, u0 + 1]
    i10 = tgt_int[v0 + 1, u0]
    i11 = tgt_int[v0 + 1, u0 + 1]
    i_t = ((1 - fv) * ((1 - fu) * i00 + fu * i01)
           + fv * ((1 - fu) * i10 + fu * i11))
    ui = torch.clamp(torch.floor(uf_c + 0.5).to(torch.int32), 0,
                     cam.width - 1).long()
    vi = torch.clamp(torch.floor(vf_c + 0.5).to(torch.int32), 0,
                     cam.height - 1).long()
    gx = tgt_gx[vi, ui]
    gy = tgt_gy[vi, ui]
    e = i_t - in_int
    fin_t = (torch.isfinite(i00) & torch.isfinite(i01)
             & torch.isfinite(i10) & torch.isfinite(i11))

    z = safe_pz
    ax = gx * cam.fx / z
    ay = gy * cam.fy / z
    az = -(gx * cam.fx * px + gy * cam.fy * py) / (z * z)
    a = torch.stack([ax, ay, az], dim=-1)

    ok = (on & torch.all(torch.isfinite(p), dim=-1) & torch.isfinite(in_int)
          & fin_t & torch.isfinite(gx) & torch.isfinite(gy)
          & (torch.abs(e) < dist_sigma))
    wgt = torch.where(ok, 1.0 - geom.div_const(torch.abs(e), dist_sigma),
                      0.0)

    cr = torch.linalg.cross(p - mean, a, dim=-1)
    j = torch.cat([cr.flip(-1), a / inv_std], dim=-1)
    j = torch.where(ok[..., None], j, 0.0).reshape(-1, 6)
    e = torch.where(ok, e, 0.0).reshape(-1)
    jw = j * wgt.reshape(-1, 1)
    a_mat = jw.T @ j
    b = -torch.sum(jw * e[:, None], dim=0)
    return (a_mat, b, torch.sum(wgt.reshape(-1) * e * e), torch.sum(wgt),
            torch.sum(ok, dtype=torch.int32))


def intensity_gradients(intensity):
    """Central-difference image gradients (gx, gy); zero on the border
    columns (gx) and rows (gy)."""
    gx = torch.zeros_like(intensity)
    gy = torch.zeros_like(intensity)
    gx[:, 1:-1] = 0.5 * (intensity[:, 2:] - intensity[:, :-2])
    gy[1:-1, :] = 0.5 * (intensity[2:, :] - intensity[:-2, :])
    return gx, gy


def planarity_probe(input_points, input_normals, cfg: TrackerConfig,
                    reduce_fn=None):
    """Report-only planarity I2 over the valid finest-level input normals
    (0.0 when the gate is disabled; the scatter reduced by ``reduce_fn``
    when given)."""
    if cfg.normal_aniso_thres <= 0.0:
        return torch.zeros((), dtype=torch.float32,
                           device=input_points.device)
    soa0 = _soa(input_points) + _soa(input_normals)
    valid0 = (torch.isfinite(soa0[3]) & torch.isfinite(soa0[4])
              & torch.isfinite(soa0[5]))
    return _planarity(soa0, valid0.to(torch.float32),
                      cfg.normal_aniso_thres, reduce_fn or _no_reduce)[1]


def track(input_points, input_normals, model_points, model_normals,
          last_pose, cam: CameraConfig, cfg: TrackerConfig,
          input_intensity=None, model_intensity=None,
          weight_depth: float = 1.0, weight_color: float = 0.1,
          color_sigma: float = 0.1, reduce_fn=None) -> TrackingResult:
    """Align the current frame to the raycast model; new_pose =
    last_pose @ delta. With both intensities ([h,w], NaN where invalid)
    the photometric rows join each system: A = weight_depth * A_depth +
    weight_color * A_color, and the same for b, the residual sum and the
    weight sum (RGB-D tracking; the planarity gate and probe are off).

    ``reduce_fn``: applied to each tuple of partial sums (see the module
    docstring); it must return the same shapes and dtypes. The input maps
    may then be a row shard of the frame."""
    dev = input_points.device
    reduce_sys = reduce_fn or _no_reduce
    levels = cfg.levels
    in_pyr = build_pyramid(input_points, input_normals, levels)
    md_pyr = build_pyramid(model_points, model_normals, levels)
    use_rgbd = input_intensity is not None and model_intensity is not None
    if use_rgbd:
        ii_pyr, mi_pyr = [input_intensity], [model_intensity]
        for _ in range(1, levels):
            ii_pyr.append(resample_half(ii_pyr[-1]))
            mi_pyr.append(resample_half(mi_pyr[-1]))
    # the photometric rows restore the rank a textured wall loses
    # geometrically, so the planarity gate is for depth-only tracking
    planarity_on = cfg.normal_aniso_thres > 0.0 and not use_rgbd

    def scalar(v, dtype=torch.float32):
        return torch.full((), v, dtype=dtype, device=dev)

    plan_i2 = (planarity_probe(input_points, input_normals, cfg, reduce_fn)
               if planarity_on else scalar(0.0))

    _, (_, max_iters) = stats_shapes(cfg)
    state = new_state(levels, max_iters, dev)
    weights = (weight_depth, weight_color)

    for level in range(levels - 1, -1, -1):        # coarse -> fine
        cam_l = _level_camera(cam, level)
        in_soa = _soa(in_pyr[level][0]) + _soa(in_pyr[level][1])
        md8 = _interleave_target(*md_pyr[level])
        if use_rgbd:
            gx, gy = intensity_gradients(mi_pyr[level])
        n_inner = cfg.max_inner_iter[level]
        gate = Gate(cfg.residual_early_out[level],
                    cfg.angle_trans_thres[level],
                    cfg.dist_trans_thres[level], cfg.cond_thres)
        for outer in range(cfg.max_outer_iter[level]):
            delta = state.delta         # each update writes it in place
            q, nq, wgt, ok = _associate(
                delta, in_soa, md8, cam_l, cfg.dist_thres[level],
                cfg.normal_thres[level], cam.depth_min, cam.depth_max)
            mean, inv_std = _whitening(q, ok, reduce_sys)
            planar = (_planarity(in_soa, wgt, cfg.normal_aniso_thres,
                                 reduce_sys)[0] if planarity_on else None)
            for inner in range(n_inner):
                sys_d = _linearize(delta, in_soa, q, nq, wgt, ok, mean,
                                   inv_std)
                color = None
                if use_rgbd:
                    # the photometric rows join before the reduction: each
                    # rank's color rows belong to its own row shard
                    sys_c = _build_system_color(
                        delta, in_pyr[level][0], ii_pyr[level],
                        mi_pyr[level], gx, gy, cam_l, color_sigma,
                        mean=mean, inv_std=inv_std)
                    reduced = reduce_sys(sys_d + sys_c)
                    sys_d, color = reduced[:5], reduced[5:9]
                else:
                    sys_d = reduce_sys(sys_d)
                begin = ((BEGIN_LEVEL if outer == inner == 0 else 0)
                         | (BEGIN_OUTER if inner == 0 else 0))
                icp_update(state, sys_d, mean, inv_std, planar, gate, level,
                           outer * n_inner + inner, begin, color, weights)

    new_pose = last_pose @ state.delta
    valid = ~state.flags[0] & torch.all(torch.isfinite(new_pose))
    return TrackingResult(pose=torch.where(valid, new_pose, last_pose),
                          valid=valid, residual=state.vals[0],
                          corr_count=state.counts[0],
                          condition=state.vals[1],
                          level_stats=state.level_stats,
                          iter_residuals=state.curve, planarity=plan_i2)
