"""Trajectory evaluation: ATE / RPE against ground truth (port of
``voxelhashing_tpu.evaluation``; numpy, the same float64 arithmetic).

Poses are 4x4 numpy arrays or CPU tensors.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False
                      ) -> Tuple[np.ndarray, float]:
    """Least-squares rigid (optionally similarity) alignment src -> dst.

    src, dst: [N,3]. Returns (4x4 transform, scale).
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u @ vt))
    fix = np.diag([1.0, 1.0, d])
    r = u @ fix @ vt
    scale = 1.0
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        scale = float(np.trace(np.diag(s) @ fix) / var_s)
    t = mu_d - scale * r @ mu_s
    out = np.eye(4)
    out[:3, :3] = scale * r
    out[:3, 3] = t
    return out, scale


def ate_rmse(estimated: Sequence, ground_truth: Sequence,
             align: bool = True) -> float:
    """Absolute trajectory error RMSE (metres) over two lists of 4x4 poses.
    ``align``: fit a rigid alignment of the estimated positions onto the
    ground truth first (with at least three poses); a run whose first pose
    is the ground truth's passes ``align=False``."""
    est_t = np.stack([np.asarray(p)[:3, 3] for p in estimated])
    gt_t = np.stack([np.asarray(p)[:3, 3] for p in ground_truth])
    if align and len(est_t) >= 3:
        tf, _ = umeyama_alignment(est_t, gt_t)
        est_t = est_t @ tf[:3, :3].T + tf[:3, 3]
    err = np.linalg.norm(est_t - gt_t, axis=-1)
    return float(np.sqrt(np.mean(err ** 2)))


def rpe_rmse(estimated: Sequence, ground_truth: Sequence,
             delta: int = 1) -> Tuple[float, float]:
    """Relative pose error RMSE over frame pairs (i, i+delta).

    Returns (translational RMSE metres, rotational RMSE radians).
    """
    trans_err, rot_err = [], []
    for i in range(len(estimated) - delta):
        e_rel = np.linalg.inv(np.asarray(estimated[i])) @ np.asarray(
            estimated[i + delta])
        g_rel = np.linalg.inv(np.asarray(ground_truth[i])) @ np.asarray(
            ground_truth[i + delta])
        d = np.linalg.inv(g_rel) @ e_rel
        trans_err.append(np.linalg.norm(d[:3, 3]))
        rot_err.append(np.arccos(
            np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)))
    return (float(np.sqrt(np.mean(np.square(trans_err)))),
            float(np.sqrt(np.mean(np.square(rot_err)))))
