"""The tracker's per-iteration passes of the reference: a frozen copy of
the plain versions of voxelhashing_tpu_torch/ops/icp_linearize.py
(the projective association with the whitening moments and the planarity
scatter, and the normal equations with the photometric rows under
RGB-D), summed by torch's own reductions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import geometry as geom
from ..config import CameraConfig

def _no_reduce(sums):
    return sums


def soa(m):
    """[h,w,3] map -> flat per-component ([P],[P],[P])."""
    f = m.reshape(-1)
    return f[0::3], f[1::3], f[2::3]


def interleave_target(tgt_pts, tgt_nrm):
    """[h,w,3] model maps -> one [P,8] row table (q, n_q, 0, 0)."""
    p = tgt_pts.reshape(-1, 3)
    n = tgt_nrm.reshape(-1, 3)
    return torch.cat([p, n, torch.zeros((p.shape[0], 2), dtype=p.dtype,
                                        device=p.device)], dim=1)


def associate_plain(delta, in_soa, tgt8, cam: CameraConfig,
                    dist_thres: float, normal_thres: float,
                    depth_min: float, depth_max: float):
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


def moments_plain(q, ok):
    """The whitening moments of the valid targets: (sum q [3], sum |q|^2,
    count), the partial sums ``reduce_sys`` takes."""
    qx, qy, qz = q
    okf = ok.to(torch.float32)
    sum_q = torch.stack([torch.sum(qx * okf), torch.sum(qy * okf),
                         torch.sum(qz * okf)])
    sum_qq = torch.sum((qx * qx + qy * qy + qz * qz) * okf)
    return sum_q, sum_qq, torch.sum(okf)


def whitening_epilogue(moments):
    """Centroid and inverse scale from the (reduced) moments."""
    sum_q, sum_qq, cnt = moments
    n = torch.clamp(cnt, min=1.0)
    mean = sum_q / n
    var = torch.clamp(sum_qq / n - torch.sum(mean * mean), min=1e-8)
    return mean, torch.rsqrt(var)


def scatter_plain(in_soa, wgt):
    """The weighted scatter [3,3] of the accepted input normals."""
    use = wgt > 0.0
    nr = torch.stack([torch.where(use, in_soa[3], 0.0),
                      torch.where(use, in_soa[4], 0.0),
                      torch.where(use, in_soa[5], 0.0)], dim=0)   # [3,P]
    return (nr * wgt[None, :]) @ nr.T                            # [3,3]


def planarity_epilogue(s, thres: float):
    """(planar, i2): the second invariant I2 of the unit-trace (reduced)
    scatter and whether it is below ``thres``."""
    tr = s[0, 0] + s[1, 1] + s[2, 2]
    sh = s / torch.clamp(tr, min=1e-12)
    i2 = 0.5 * (1.0 - torch.sum(sh * sh.T))
    return (i2 < thres) & (tr > 0.0), i2


def planarity_plain(in_soa, wgt, thres: float, reduce_sys=_no_reduce):
    """Planar-degeneracy probe: second invariant I2 of the unit-trace
    weighted scatter of the accepted input normals (the scatter reduced by
    ``reduce_sys``). Returns (planar, i2)."""
    (s,) = reduce_sys((scatter_plain(in_soa, wgt),))
    return planarity_epilogue(s, thres)


def linearize_rows_plain(delta, in_soa, q, nq, wgt, ok, mean, inv_std):
    """The rows [8,P] (crz, cry, crx, n_q, e, 1) of the whitened
    point-to-plane system; zero where rejected."""
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
    return torch.stack([crz, cry, crx, nqx, nqy, nqz, e,
                        torch.ones_like(e)], dim=0)           # [8,P]


def linearize_plain(delta, in_soa, q, nq, wgt, ok, mean, inv_std):
    """Whitened point-to-plane normal equations about ``delta`` against
    fixed correspondences. Returns (A[6,6], b[6], sum_res, sum_w, count)."""
    jrows = linearize_rows_plain(delta, in_soa, q, nq, wgt, ok, mean,
                                 inv_std)
    m = (jrows * wgt[None, :]) @ jrows.T                      # [8,8] f32
    return (m[:6, :6], -m[6, :6], m[6, 6], m[7, 7],
            torch.sum(ok, dtype=torch.int32))


def color_rows_plain(delta, in_pts, in_int, tgt_int, tgt_gx, tgt_gy,
                     cam: CameraConfig, dist_sigma: float, mean, inv_std):
    """The photometric rows: (j [P,6], e [P], wgt [h,w], ok [h,w]), j and e
    zero where rejected."""
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
    return j, e, wgt, ok


def color_system_plain(delta, in_pts, in_int, tgt_int, tgt_gx, tgt_gy,
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
    j, e, wgt, ok = color_rows_plain(delta, in_pts, in_int, tgt_int, tgt_gx,
                                     tgt_gy, cam, dist_sigma, mean, inv_std)
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


# ---------------------------------------------------------------------------
# One pyramid level, and the wrappers
# ---------------------------------------------------------------------------

class Association(NamedTuple):
    q: tuple            # f32 [P] x3, 0 where rejected
    nq: tuple           # f32 [P] x3
    wgt: torch.Tensor   # f32 [P]
    ok: torch.Tensor    # bool [P]
    moments: tuple      # (sum_q f32[3], sum_qq f32[], cnt f32[])
    s: Optional[torch.Tensor]   # f32 [3,3] scatter, None when off


class Linearization(NamedTuple):
    depth: tuple        # (a f32[6,6], b f32[6], sum_res, sum_w, count i32)
    color: Optional[tuple]      # the same for the photometric rows, or None
    mean: torch.Tensor  # f32 [3]
    inv_std: torch.Tensor       # f32 []
    planar: Optional[torch.Tensor]  # bool [], None when the gate is off


class Level:
    """One pyramid level: the input maps [h,w,3] (a row shard on a rank of
    the multi-device step), the model maps [H,W,3] (pixel v * cam.width + u,
    as the plain table has it), with intensities ([h,w], [H,W]) under
    RGB-D, and the level's camera."""

    def __init__(self, in_pts, in_nrm, md_pts, md_nrm, cam: CameraConfig,
                 in_int=None, md_int=None):
        self.in_pts, self.in_nrm = in_pts, in_nrm
        self.md_pts, self.md_nrm = md_pts, md_nrm
        self.in_int, self.md_int = in_int, md_int
        self.cam = cam
        self._plain = None

    @property
    def color(self) -> bool:
        return self.in_int is not None and self.md_int is not None

    def plain(self):
        """(input SoA, the [P,8] model table, gx, gy) for the plain
        passes, made once."""
        if self._plain is None:
            grads = (intensity_gradients(self.md_int) if self.color
                     else (None, None))
            self._plain = (soa(self.in_pts) + soa(self.in_nrm),
                           interleave_target(self.md_pts, self.md_nrm),
                           *grads)
        return self._plain


def associate_reference(delta, lv: Level, dist_thres: float,
                        normal_thres: float, depth_min: float,
                        depth_max: float, scatter: bool) -> Association:
    """The correspondences at ``delta`` and their sums: the whitening
    moments and, with ``scatter``, the planarity scatter."""
    in_soa, tgt8, _, _ = lv.plain()
    q, nq, wgt, ok = associate_plain(delta, in_soa, tgt8, lv.cam,
                                     dist_thres, normal_thres, depth_min,
                                     depth_max)
    return Association(q, nq, wgt, ok, moments_plain(q, ok),
                       scatter_plain(in_soa, wgt) if scatter else None)


def linearize_reference(delta, lv: Level, assoc: Association, moments, s,
                        planar_thres: float,
                        color_sigma: Optional[float]) -> Linearization:
    """The whitening (mean, inv_std) from ``moments``, the planarity flag
    from the scatter ``s`` (None: the gate is off), and the normal
    equations about ``delta`` against the correspondences ``assoc``: the
    depth system and, with ``color_sigma``, the photometric one."""
    in_soa, _, gx, gy = lv.plain()
    mean, inv_std = whitening_epilogue(moments)
    planar = None if s is None else planarity_epilogue(s, planar_thres)[0]
    depth = linearize_plain(delta, in_soa, assoc.q, assoc.nq, assoc.wgt,
                            assoc.ok, mean, inv_std)
    color = None
    if color_sigma is not None:
        color = color_system_plain(delta, lv.in_pts, lv.in_int, lv.md_int,
                                   gx, gy, lv.cam, color_sigma, mean=mean,
                                   inv_std=inv_std)
    return Linearization(depth, color, mean, inv_std, planar)
