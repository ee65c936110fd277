"""Frame-to-model camera tracking: multi-resolution projective ICP
(PyTorch port of ``voxelhashing_tpu.tracking``).

Projective association, whitened point-to-plane normal equations, a
truncated-SVD 6x6 solve with the condition gate, per-step plausibility and
planarity gates, coarse-to-fine levels with residual early-out. With
intensities (RGB-D tracking) photometric rows join each system, built in
the same whitened parametrization, and the planarity gate and probe are
off.

Each outer iteration's passes are ``ops/icp_linearize``: on CUDA the
association with the sums of the whitening moments and the planarity
scatter, then the whitening and planarity epilogues with the sums of the
normal equations (and the photometric rows), summed in a fixed order in
f64; on a single device the first inner iteration's pair is one launch
(``associate_linearize``), under ``reduce_fn`` and for later inner
iterations the split kernels. On the CPU the plain torch passes (the
normal equations one [8,P] x [P,8] f32 product; TF32 is off in this
package), which keep their names here (``_associate``, ``_whitening``,
``_planarity``, ``_linearize``, ``_build_system_color``).

The JAX tracker skips a converged level's outer iterations with
``lax.cond``; here every iteration runs and a level that was already done
keeps its carry unchanged (the masked form), which gives identical results
without reading the device. Each inner iteration's tail (the 6x6 solve,
the step gate, the pose update and the carry) is ``ops/icp_update``: one
kernel on CUDA that writes the carry's buffers in place, the plain torch
tail around ``torch.linalg.svd`` on the CPU; so tracking reads nothing on
the host and can be captured in a CUDA graph: two launches an iteration
on a single device, three under ``reduce_fn``.

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
from .ops import icp_linearize as icp
from .ops.icp_linearize import (  # noqa: F401  (the plain passes' names)
    associate_plain as _associate, color_system_plain as _build_system_color,
    intensity_gradients, linearize_plain as _linearize,
    planarity_plain as _planarity, soa as _soa,
    whitening_plain as _whitening, _no_reduce)
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


def planarity_probe(input_points, input_normals, cfg: TrackerConfig,
                    reduce_fn=None):
    """Report-only planarity I2 over the valid finest-level input normals
    (0.0 when the gate is disabled; the scatter reduced by ``reduce_fn``
    when given). Once a frame, by the plain scatter and epilogue on any
    device (its weights are the normals' validity, not an association's)."""
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
        lv = icp.Level(*in_pyr[level], *md_pyr[level],
                       _level_camera(cam, level),
                       *((ii_pyr[level], mi_pyr[level]) if use_rgbd
                         else ()))
        n_inner = cfg.max_inner_iter[level]
        gate = Gate(cfg.residual_early_out[level],
                    cfg.angle_trans_thres[level],
                    cfg.dist_trans_thres[level], cfg.cond_thres)
        sigma = color_sigma if use_rgbd else None
        assoc_args = (cfg.dist_thres[level], cfg.normal_thres[level],
                      cam.depth_min, cam.depth_max, planarity_on)
        for outer in range(cfg.max_outer_iter[level]):
            delta = state.delta         # each update writes it in place
            lin = None
            if reduce_fn is None:
                # one device: both passes in one launch
                assoc, lin = icp.associate_linearize(
                    delta, lv, *assoc_args, cfg.normal_aniso_thres, sigma)
                moments, s = assoc.moments, assoc.s
            else:
                assoc = icp.associate(delta, lv, *assoc_args)
                moments = reduce_sys(assoc.moments)
                s = reduce_sys((assoc.s,))[0] if planarity_on else None
            for inner in range(n_inner):
                if inner > 0 or lin is None:
                    lin = icp.linearize(delta, lv, assoc, moments, s,
                                        cfg.normal_aniso_thres, sigma)
                sys_d, color = lin.depth, None
                if use_rgbd:
                    # the photometric rows join before the reduction: each
                    # rank's color rows belong to its own row shard
                    reduced = reduce_sys(sys_d + lin.color)
                    sys_d, color = reduced[:5], reduced[5:9]
                else:
                    sys_d = reduce_sys(sys_d)
                begin = ((BEGIN_LEVEL if outer == inner == 0 else 0)
                         | (BEGIN_OUTER if inner == 0 else 0))
                icp_update(state, sys_d, lin.mean, lin.inv_std, lin.planar,
                           gate, level, outer * n_inner + inner, begin,
                           color, weights)

    new_pose = last_pose @ state.delta
    valid = ~state.flags[0] & torch.all(torch.isfinite(new_pose))
    return TrackingResult(pose=torch.where(valid, new_pose, last_pose),
                          valid=valid, residual=state.vals[0],
                          corr_count=state.counts[0],
                          condition=state.vals[1],
                          level_stats=state.level_stats,
                          iter_residuals=state.curve, planarity=plan_i2)
