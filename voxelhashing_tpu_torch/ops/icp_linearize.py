"""The tracker's per-iteration passes: association with the whitening
moments and the planarity scatter, and the normal equations with the
photometric rows (``csrc/icp_linearize.cu``).

No TPU kernel: the JAX tracker runs these passes as XLA
(``voxelhashing_tpu/tracking.py:125`` ``_associate``, ``:183``
``_whitening``, ``:210`` ``_planarity``, ``:242`` ``_linearize``, ``:358``
``_build_system_color``). The plain versions here are those functions op
for op (the CPU path, and the reference on the card); ``tracking`` keeps
their old names. On CUDA tensors the passes are one kernel template,
``icp_pass_kernel<kAssoc, kLin, kColor>``, in three forms:

- :func:`associate_linearize` (both in one launch): the single-device
  step's ICP iteration, one launch; its outputs are the split pair's bit
  for bit;
- :func:`associate` (the association alone): the projective
  correspondences (q, n_q, the weight and the accept flag, bit-equal to
  :func:`associate_plain`) and the sums of the whitening moments and of
  the planarity scatter;
- :func:`linearize` (the linearization alone): the whitening and
  planarity epilogues from the (reduced) sums, as the plain version
  computes them, and the sums of the depth system and, with intensities,
  of the photometric system. The multi-device step runs the split pair
  and reduces the moments and the scatter across ranks (``reduce_fn``)
  between the two, as on the plain path; an inner iteration after the
  first linearizes again on the same correspondences.

Every form sums in f64 in one fixed order on a persistent grid that
depends on the level and the card alone (:func:`pass_grid`;
``tests/icp_sum_order.py`` models it in numpy) and rounds once to
f32: the same bits from run to run, not the plain version's (a cuBLAS f32
product), which :func:`disagreements` holds them to.

The wrappers launch the kernels for CUDA tensors and run the plain
versions for CPU tensors; any other device raises. There is no fallback.
A :class:`Level` holds one pyramid level's maps and, made once a level,
the kernels' buffers (the correspondences, the partial rows, the arrival
counters and the fused form's grid barrier word, whose zero fill is one
launch a level); inside a CUDA graph capture they come from the graph's
pool, and an iteration allocates only its small outputs. Each launch adds
one to ``associate.launches``, ``linearize.launches``,
``linearize.color_launches``, ``associate_linearize.launches`` or
``associate_linearize.color_launches``; the plain versions count their
calls on CUDA tensors (``cuda_calls``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .. import geometry as geom
from ..config import CameraConfig

THREADS = 256               # threads a CTA (csrc)
CHUNK = 16                  # partial rows a last-CTA thread adds at once
ASSOC_SUMS = 11             # sum q (3), sum |q|^2, count, the scatter (6)
SYS_SUMS = 30               # a system's: A (21), m[6,:6] (6), res, w, count
# the kernels' output layouts (csrc/icp_linearize.cu)
ASSOC_OUT = 14              # sum_q (3), sum_qq, cnt, s [3,3]
SYS_OUT = 44                # a [6,6], b [6], sum_res, sum_w
LIN_OUT = 2 * SYS_OUT + 4   # depth, color, mean (3), inv_std


def _no_reduce(sums):
    return sums


# ---------------------------------------------------------------------------
# The plain versions (the CPU path; the reference on the card)
# ---------------------------------------------------------------------------

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
    if delta.device.type == "cuda":
        associate_plain.cuda_calls += 1
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


associate_plain.cuda_calls = 0


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


def whitening_plain(q, ok, reduce_sys=_no_reduce):
    """Centroid and inverse scale of the valid correspondence targets
    (moments reduced by ``reduce_sys``)."""
    return whitening_epilogue(reduce_sys(moments_plain(q, ok)))


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
    if delta.device.type == "cuda":
        linearize_plain.cuda_calls += 1
    jrows = linearize_rows_plain(delta, in_soa, q, nq, wgt, ok, mean,
                                 inv_std)
    m = (jrows * wgt[None, :]) @ jrows.T                      # [8,8] f32
    return (m[:6, :6], -m[6, :6], m[6, 6], m[7, 7],
            torch.sum(ok, dtype=torch.int32))


linearize_plain.cuda_calls = 0


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
    if dev.type == "cuda":
        color_system_plain.cuda_calls += 1
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


color_system_plain.cuda_calls = 0


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
    RGB-D, and the level's camera. Strided views are read as they are."""

    def __init__(self, in_pts, in_nrm, md_pts, md_nrm, cam: CameraConfig,
                 in_int=None, md_int=None):
        self.in_pts, self.in_nrm = in_pts, in_nrm
        self.md_pts, self.md_nrm = md_pts, md_nrm
        self.in_int, self.md_int = in_int, md_int
        self.cam = cam
        self.n = in_pts.shape[0] * in_pts.shape[1]
        self._plain = None
        self._work = None
        self.grid = None

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

    def work(self):
        """The kernels' buffers, made once, and the level's grid
        (:func:`pass_grid`, the same for every form): correspondences f32
        [7,P] (q, n_q, weight), accept flags bool [P], the association's
        and the linearization's f64 partial rows (one a CTA each; views of
        one buffer that do not overlap, since the fused form writes its
        linearization rows while other CTAs may still read the
        association's) and the association's and the linearization's
        arrival counters and the fused form's grid barrier word (int32
        [4], zero filled here and never again by the host)."""
        if self._work is None:
            dev = self.in_pts.device
            self.grid = pass_grid(self.n, dev)
            rows = torch.empty((self.grid * (ASSOC_SUMS + 2 * SYS_SUMS),),
                               dtype=torch.float64, device=dev)
            self._work = (
                torch.empty((7, self.n), dtype=torch.float32, device=dev),
                torch.empty((self.n,), dtype=torch.bool, device=dev),
                *partial_rows(rows, self.grid),
                torch.zeros((4,), dtype=torch.int32, device=dev))
        return self._work


def partial_rows(rows, grid: int):
    """(the association's rows f64 [grid * ASSOC_SUMS], the
    linearization's f64 [grid * 2 * SYS_SUMS]): disjoint views of ``rows``,
    one after the other."""
    split = grid * ASSOC_SUMS
    return rows[:split], rows[split:split + grid * 2 * SYS_SUMS]


@functools.lru_cache(maxsize=None)
def _max_grid(index: int) -> int:
    with torch.cuda.device(index):
        grid = _build.library("icp_linearize").vh_icp_linearize_grid()
    if grid < 1:
        raise RuntimeError(f"icp_linearize: the occupancy query failed "
                           f"({grid})")
    return grid


def pass_grid(n: int, device) -> int:
    """The CTAs of every pass launch at a level of ``n`` pixels on
    ``device``: one a 256 pixels, at most as many as the card holds at once
    of the most demanding form (``vh_icp_linearize_grid``). It depends on n
    and the card alone, so every form sums the same rows in the same
    order."""
    return min(-(-n // THREADS), _max_grid(device.index))


class _Map(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("s0", ctypes.c_longlong),
                ("s1", ctypes.c_longlong), ("h", ctypes.c_int),
                ("w", ctypes.c_int)]


class _Cam(ctypes.Structure):
    _fields_ = [("width", ctypes.c_int), ("height", ctypes.c_int),
                ("fx", ctypes.c_float), ("fy", ctypes.c_float),
                ("cx", ctypes.c_float), ("cy", ctypes.c_float)]


_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int


class AssocArgs(ctypes.Structure):
    """``AssocArgs`` of ``csrc/icp_linearize.cu``, field for field."""
    _fields_ = [("delta", _P), ("in_pts", _Map), ("in_nrm", _Map),
                ("md_pts", _Map), ("md_nrm", _Map), ("cam", _Cam),
                ("dist_thres", _F), ("dist2_thres", _F),
                ("normal_thres", _F), ("depth_min", _F),
                ("depth_range", _F), ("scatter", _I), ("corr", _P),
                ("ok", _P), ("partials", _P), ("counter", _P), ("barrier", _P),
                ("sums", _P), ("n", _I)]


class LinArgs(ctypes.Structure):
    """``LinArgs`` of ``csrc/icp_linearize.cu``, field for field."""
    _fields_ = [("delta", _P), ("in_pts", _Map), ("corr", _P), ("ok", _P),
                ("sum_q", _P), ("sum_qq", _P), ("cnt", _P), ("s", _P),
                ("planar_thres", _F), ("color", _I), ("in_int", _Map),
                ("md_int", _Map), ("cam", _Cam), ("color_sigma", _F),
                ("partials", _P), ("counter", _P), ("out", _P),
                ("counts", _P), ("planar", _P), ("n", _I)]


def _device(t):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"icp_linearize: no kernel for {dev}")
    return dev


def _map_args(m, h, w, what, channels=3):
    """(strides) of an f32 [h, w(, 3)] map whose last dimension is
    contiguous."""
    shape = (h, w, channels) if channels == 3 else (h, w)
    if m.dtype != torch.float32 or tuple(m.shape) != shape \
            or (channels == 3 and m.stride(2) != 1):
        raise ValueError(f"icp_linearize: {what} must be f32 {shape} with "
                         f"a contiguous last dimension, got {m.dtype} "
                         f"{tuple(m.shape)} {m.stride()}")
    return m.stride(0), m.stride(1)


def _map(m, strides):
    return _Map(m.data_ptr(), strides[0], strides[1], m.shape[0],
                m.shape[1])


def _cam(cam: CameraConfig):
    return _Cam(cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy)


def _check_level(lv: Level, delta):
    dev = delta.device
    h, w = lv.in_pts.shape[:2]
    hm, wm = lv.md_pts.shape[:2]
    cam = lv.cam
    tensors = [delta, lv.in_pts, lv.in_nrm, lv.md_pts, lv.md_nrm] + (
        [lv.in_int, lv.md_int] if lv.color else [])
    if any(t.device != dev for t in tensors):
        raise ValueError("icp_linearize: every tensor on delta's device")
    if delta.dtype != torch.float32 or tuple(delta.shape) != (4, 4) \
            or not delta.is_contiguous():
        raise ValueError("icp_linearize: delta must be f32 [4,4], "
                         "contiguous")
    if lv.n < 1 or lv.n >= 2 ** 31 or cam.width < 1 or cam.height < 1:
        raise ValueError("icp_linearize: a level needs 1 to 2^31 - 1 "
                         "input pixels and a camera of at least 1x1")
    in_s = _map_args(lv.in_pts, h, w, "the input points")
    if _map_args(lv.in_nrm, h, w, "the input normals") != in_s:
        raise ValueError("icp_linearize: input points and normals must "
                         "share strides")
    md_s = _map_args(lv.md_pts, hm, wm, "the model points")
    if _map_args(lv.md_nrm, hm, wm, "the model normals") != md_s:
        raise ValueError("icp_linearize: model points and normals must "
                         "share strides")
    if hm * wm < cam.width * cam.height:
        raise ValueError("icp_linearize: the model maps hold fewer pixels "
                         "than the level's camera")
    return in_s, md_s


def _assoc_args(delta, lv: Level, dist_thres: float, normal_thres: float,
                depth_min: float, depth_max: float, scatter: bool):
    """(AssocArgs, :class:`Association`): the inputs checked, the sums
    allocated."""
    in_s, md_s = _check_level(lv, delta)
    corr, ok, partials, _, counters = lv.work()
    sums = torch.empty((ASSOC_OUT,), dtype=torch.float32, device=delta.device)
    cnt = counters.data_ptr()
    a = AssocArgs(
        delta.data_ptr(), _map(lv.in_pts, in_s), _map(lv.in_nrm, in_s),
        _map(lv.md_pts, md_s), _map(lv.md_nrm, md_s), _cam(lv.cam),
        dist_thres, dist_thres * dist_thres, normal_thres, depth_min,
        depth_max - depth_min, int(bool(scatter)), corr.data_ptr(),
        ok.data_ptr(), partials.data_ptr(), cnt, cnt + 8, sums.data_ptr(),
        lv.n)
    out = Association(q=(corr[0], corr[1], corr[2]),
                      nq=(corr[3], corr[4], corr[5]), wgt=corr[6], ok=ok,
                      moments=(sums[0:3], sums[3], sums[4]),
                      s=sums[5:14].view(3, 3) if scatter else None)
    return a, out


def _vec(t, n, what):
    if t.dtype != torch.float32 or t.numel() != n or not t.is_contiguous():
        raise ValueError(f"icp_linearize: {what} must be {n} contiguous f32")


def _lin_args(delta, lv: Level, assoc: Association, moments, s,
              planar_thres: float, color_sigma: Optional[float]):
    """(LinArgs, :class:`Linearization`): the inputs checked, the outputs
    allocated."""
    in_s, _ = _check_level(lv, delta)
    h, w = lv.in_pts.shape[:2]
    corr, ok, _, partials, counters = lv.work()
    if assoc.wgt.data_ptr() != corr[6].data_ptr() \
            or assoc.ok.data_ptr() != ok.data_ptr():
        raise ValueError("icp_linearize: the association must be the "
                         "level's own (associate on this Level)")
    sum_q, sum_qq, cnt = moments
    _vec(sum_q, 3, "sum_q")
    _vec(sum_qq, 1, "sum_qq")
    _vec(cnt, 1, "cnt")
    if s is not None:
        _vec(s, 9, "the scatter")
    color = color_sigma is not None
    if color and not lv.color:
        raise ValueError("icp_linearize: the photometric rows need the "
                         "level's intensities")
    dev = delta.device
    if any(t.device != dev for t in (sum_q, sum_qq, cnt)
           + (() if s is None else (s,))):
        raise ValueError("icp_linearize: every tensor on delta's device")
    cam = lv.cam
    in_int = md_int = _Map()
    if color:
        in_int = _map(lv.in_int, _map_args(lv.in_int, h, w,
                                           "the input intensity", 1))
        hm, wm = lv.md_int.shape
        md_int = _map(lv.md_int, _map_args(lv.md_int, hm, wm,
                                           "the model intensity", 1))
        if hm < cam.height or wm < cam.width:
            raise ValueError("icp_linearize: the model intensity is "
                             "smaller than the level's camera")
    out = torch.empty((LIN_OUT,), dtype=torch.float32, device=dev)
    counts = torch.empty((2,), dtype=torch.int32, device=dev)
    planar = None if s is None else torch.empty((), dtype=torch.bool,
                                                device=dev)
    lin = LinArgs(
        delta.data_ptr(), _map(lv.in_pts, in_s), corr.data_ptr(),
        ok.data_ptr(), sum_q.data_ptr(), sum_qq.data_ptr(), cnt.data_ptr(),
        None if s is None else s.data_ptr(), planar_thres, int(color),
        in_int, md_int, _cam(cam), color_sigma if color else 0.0,
        partials.data_ptr(), counters.data_ptr() + 4, out.data_ptr(),
        counts.data_ptr(), None if planar is None else planar.data_ptr(),
        lv.n)

    def system(o, count):
        return (o[0:36].view(6, 6), o[36:42], o[42], o[43], count)

    res = Linearization(
        depth=system(out[:SYS_OUT], counts[0]),
        color=system(out[SYS_OUT:2 * SYS_OUT], counts[1]) if color else None,
        mean=out[2 * SYS_OUT:2 * SYS_OUT + 3], inv_std=out[2 * SYS_OUT + 3],
        planar=planar)
    return lin, res


def launch(args) -> None:
    """Launch a prepared pass (``prepare_*``'s first value) on the current
    stream: the only place that launches the pass kernels; counts the
    launch in its wrapper's count."""
    a, lin, grid, kind, device = args
    _build.check(_build.library("icp_linearize").vh_icp_pass(
        None if a is None else ctypes.byref(a), ctypes.sizeof(AssocArgs),
        None if lin is None else ctypes.byref(lin), ctypes.sizeof(LinArgs),
        grid, _build.stream_ptr(device)), "icp_linearize")
    owner, attr = {"associate": (associate, "launches"),
                   "linearize": (linearize, "launches"),
                   "linearize_color": (linearize, "color_launches"),
                   "pass": (associate_linearize, "launches"),
                   "pass_color": (associate_linearize, "color_launches"),
                   }[kind]
    setattr(owner, attr, getattr(owner, attr) + 1)


def prepare_associate(delta, lv: Level, dist_thres: float,
                      normal_thres: float, depth_min: float,
                      depth_max: float, scatter: bool):
    """Check the inputs, allocate the sums; returns (launch arguments,
    :class:`Association`)."""
    a, out = _assoc_args(delta, lv, dist_thres, normal_thres, depth_min,
                         depth_max, scatter)
    return (a, None, lv.grid, "associate", delta.device), out


def associate_reference(delta, lv: Level, dist_thres: float,
                        normal_thres: float, depth_min: float,
                        depth_max: float, scatter: bool) -> Association:
    """:func:`associate` by the plain versions, on any device."""
    in_soa, tgt8, _, _ = lv.plain()
    q, nq, wgt, ok = associate_plain(delta, in_soa, tgt8, lv.cam,
                                     dist_thres, normal_thres, depth_min,
                                     depth_max)
    return Association(q, nq, wgt, ok, moments_plain(q, ok),
                       scatter_plain(in_soa, wgt) if scatter else None)


def associate(delta, lv: Level, dist_thres: float, normal_thres: float,
              depth_min: float, depth_max: float,
              scatter: bool) -> Association:
    """The correspondences at ``delta`` and their partial sums: the
    whitening moments and, with ``scatter``, the planarity scatter (both
    for ``reduce_sys``). The association kernel on CUDA tensors, the plain
    versions on CPU tensors."""
    if _device(delta).type == "cpu":
        return associate_reference(delta, lv, dist_thres, normal_thres,
                                   depth_min, depth_max, scatter)
    args, out = prepare_associate(delta, lv, dist_thres, normal_thres,
                                  depth_min, depth_max, scatter)
    launch(args)
    return out


associate.launches = 0


def prepare_linearize(delta, lv: Level, assoc: Association, moments, s,
                      planar_thres: float, color_sigma: Optional[float]):
    """Check the inputs, allocate the outputs; returns (launch arguments,
    :class:`Linearization`)."""
    lin, out = _lin_args(delta, lv, assoc, moments, s, planar_thres,
                         color_sigma)
    kind = "linearize_color" if color_sigma is not None else "linearize"
    return (None, lin, lv.grid, kind, delta.device), out


def linearize_reference(delta, lv: Level, assoc: Association, moments, s,
                        planar_thres: float,
                        color_sigma: Optional[float]) -> Linearization:
    """:func:`linearize` by the plain versions, on any device."""
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


def linearize(delta, lv: Level, assoc: Association, moments, s,
              planar_thres: float,
              color_sigma: Optional[float] = None) -> Linearization:
    """The whitening (mean, inv_std) from the (reduced) ``moments``, the
    planarity flag from the (reduced) scatter ``s`` (None: the gate is
    off), and the normal equations about ``delta`` against the fixed
    correspondences ``assoc``: the depth system and, with ``color_sigma``,
    the photometric one (the level's intensities). The linearization
    kernel on CUDA tensors, the plain versions on CPU tensors."""
    if _device(delta).type == "cpu":
        return linearize_reference(delta, lv, assoc, moments, s,
                                   planar_thres, color_sigma)
    args, out = prepare_linearize(delta, lv, assoc, moments, s, planar_thres,
                                  color_sigma)
    launch(args)
    return out


linearize.launches = 0
linearize.color_launches = 0


def prepare_associate_linearize(delta, lv: Level, dist_thres: float,
                                normal_thres: float, depth_min: float,
                                depth_max: float, scatter: bool,
                                planar_thres: float,
                                color_sigma: Optional[float]):
    """Check the inputs, allocate the outputs of both passes; returns
    (launch arguments, (:class:`Association`, :class:`Linearization`))."""
    a, assoc = _assoc_args(delta, lv, dist_thres, normal_thres, depth_min,
                           depth_max, scatter)
    lin, out = _lin_args(delta, lv, assoc, assoc.moments, assoc.s,
                         planar_thres, color_sigma)
    kind = "pass_color" if color_sigma is not None else "pass"
    return (a, lin, lv.grid, kind, delta.device), (assoc, out)


def associate_linearize(delta, lv: Level, dist_thres: float,
                        normal_thres: float, depth_min: float,
                        depth_max: float, scatter: bool, planar_thres: float,
                        color_sigma: Optional[float] = None):
    """:func:`associate` and then :func:`linearize` on its own
    (unreduced) moments and scatter, the single-device step's iteration:
    (:class:`Association`, :class:`Linearization`). On CUDA tensors one
    launch of the fused kernel, whose outputs are the split pair's bit for
    bit; on CPU tensors the plain versions, one after the other."""
    if _device(delta).type == "cpu":
        assoc = associate_reference(delta, lv, dist_thres, normal_thres,
                                    depth_min, depth_max, scatter)
        return assoc, linearize_reference(delta, lv, assoc, assoc.moments,
                                          assoc.s, planar_thres, color_sigma)
    args, out = prepare_associate_linearize(
        delta, lv, dist_thres, normal_thres, depth_min, depth_max, scatter,
        planar_thres, color_sigma)
    launch(args)
    return out


associate_linearize.launches = 0
associate_linearize.color_launches = 0


# ---------------------------------------------------------------------------
# The bound, and the checks that hold a kernel to its plain version
# ---------------------------------------------------------------------------

# f32 operations a pixel (counted on csrc/icp_linearize.cu with adds,
# multiplies, divisions, comparisons, selects and math functions one
# each). Association: the transform (15) and rotation (15), the
# projection (12), the pixel (8), the distance and normal tests (13),
# the finiteness tests (12), the weight (10), the outputs (7); per accepted
# pixel the moments (6 f32) and, with the scatter, its weights (3).
# Linearization (accepted pixels): the transform (15), the whitening (12),
# e (8), the cross products (9), the weighted row (7). Color (every pixel):
# the transform (15), the projection and its tests (16), the bilinear
# sample (22), the gradients (6), e and the tests (12), the jacobian (10);
# per accepted pixel the weight (3), the cross product (12) and the row
# (10). The f64 sums: per accepted pixel and sum one multiply and one add
# (the sums of a pixel with no terms are not formed); the epilogue's few
# operations a thread are not counted.
ASSOC_OPS, ASSOC_OK_OPS, ASSOC_SCATTER_OPS = 92, 6, 3
LIN_OK_OPS, COLOR_OPS, COLOR_OK_OPS = 51, 81, 25


def bytes_moved(kind: str, n_in: int, n_md: int, scatter: bool = False,
                planar: bool = False) -> int:
    """The least bytes one launch must move: each input read once, each
    output written once. ``kind``: "associate" (the input points and
    normals, the model maps, delta; the correspondences (7 f32 and a flag
    a pixel) and the sums), "linearize" (the input points, the
    correspondences, delta, the moments and the scatter; the systems,
    mean, inv_std and the flag), "linearize_color" (and the two intensity
    maps), or "pass" / "pass_color", the fused launch: the association's
    bytes and the linearization's, less what the launch reads of its own
    making or again (the correspondences, the input points, delta, the
    moments and the scatter)."""
    if kind in ("pass", "pass_color"):
        lin = "linearize_color" if kind == "pass_color" else "linearize"
        return (bytes_moved("associate", n_in, n_md, scatter)
                + bytes_moved(lin, n_in, n_md, scatter, planar)
                - (29 * n_in + 12 * n_in + 64 + 20 + (36 if planar else 0)))
    if kind == "associate":
        return (24 * n_in + 24 * n_md + 64 + 29 * n_in
                + 4 * (5 + (9 if scatter else 0)))
    color = kind == "linearize_color"
    reads = (12 * n_in + 29 * n_in + 64 + 20 + (36 if planar else 0)
             + ((4 * n_in + 4 * n_md) if color else 0))
    writes = 4 * (SYS_OUT * (2 if color else 1) + 4) + 4 * (2 if color else 1) \
        + (1 if planar else 0)
    return reads + writes


def operations(kind: str, n_in: int, n_ok: int, n_use: int = 0,
               n_ok_color: int = 0):
    """(f32, f64) operations of one launch on ``n_in`` pixels with
    ``n_ok`` accepted (``n_use`` of them weighted into the scatter,
    ``n_ok_color`` accepted by the photometric test); "pass" and
    "pass_color" are the association's and the linearization's."""
    if kind in ("pass", "pass_color"):
        lin = "linearize_color" if kind == "pass_color" else "linearize"
        a = operations("associate", n_in, n_ok, n_use)
        b = operations(lin, n_in, n_ok, 0, n_ok_color)
        return a[0] + b[0], a[1] + b[1]
    if kind == "associate":
        return (ASSOC_OPS * n_in + ASSOC_OK_OPS * n_ok
                + ASSOC_SCATTER_OPS * n_use,
                2 * (5 * n_ok + 6 * n_use))
    f32 = LIN_OK_OPS * n_ok
    f64 = 2 * SYS_SUMS * n_ok
    if kind == "linearize_color":
        f32 += COLOR_OPS * n_in + COLOR_OK_OPS * n_ok_color
        f64 += 2 * SYS_SUMS * n_ok_color
    return f32, f64


# The kernel's sums against the plain version's: the plain f32 sum of n
# terms, in whatever order cuBLAS or torch.sum takes, is within
# (n - 1) u sum|t| of the exact sum of its terms (u = 2^-24; any order of
# additions, to first order; the factor 1.01 covers the second order up to
# n u = 0.5%); each term's own rounding is within 2 u |t| in either version
# (a product rounded once or twice in f32; the kernel multiplies out in
# f64), and the kernel rounds its f64 sum once to f32 (u sum|t|; its f64
# error, ~2^-53 n sum|t|, is below that): |d| <= (1.01 n + 3) u sum|t|.
# Counts must be equal.
U32 = 2.0 ** -24


def bound_factor(n_terms: int) -> float:
    return 1.01 * n_terms + 3.0


def _np64(t):
    return t.detach().cpu().to(torch.float64).numpy()


def scale_assoc(lv: Level, assoc: Association, scatter: bool):
    """sum|t| of each association sum's terms (f64 numpy), in the layout of
    (moments, s): (sum |q| [3], sum |q|^2, None (a count)), s or None."""
    q = np.stack([_np64(x) for x in assoc.q])
    okf = _np64(assoc.ok)
    qq = ((assoc.q[0] * assoc.q[0] + assoc.q[1] * assoc.q[1]
           + assoc.q[2] * assoc.q[2])).detach().cpu().double().numpy()
    moments = (np.abs(q * okf).sum(axis=1), np.abs(qq * okf).sum(), None)
    s = None
    if scatter:
        in_soa = soa(lv.in_pts) + soa(lv.in_nrm)
        use = assoc.wgt > 0.0
        nr = torch.stack([torch.where(use, in_soa[k], 0.0)
                          for k in (3, 4, 5)])
        nw = np.abs(_np64(nr * assoc.wgt[None, :]))
        s = nw @ np.abs(_np64(nr)).T
    return moments, s


def _scale_rows(jac, e, w):
    """sum|t| of a system's sums from its rows (jac [P,6], e [P], w [P],
    f32, zero where rejected): (a [6,6], b [6], sum_res, sum_w, None)."""
    jw = np.abs(_np64(jac * w[:, None]))
    aj = np.abs(_np64(jac))
    ew = np.abs(_np64(e * w))
    return (jw.T @ aj, ew @ aj, float(ew @ np.abs(_np64(e))),
            float(np.abs(_np64(w)).sum()), None)


def scale_linearize(delta, lv: Level, assoc: Association, lin: Linearization,
                    color_sigma: Optional[float]):
    """sum|t| of each sum of :func:`linearize`'s systems (f64 numpy, the
    layout of ``Linearization.depth`` and ``.color``), from the plain
    version's rows at the whitening ``lin`` carries."""
    in_soa, _, gx, gy = lv.plain()
    rows = linearize_rows_plain(delta, in_soa, assoc.q, assoc.nq, assoc.wgt,
                                assoc.ok, lin.mean, lin.inv_std)
    depth = _scale_rows(rows[:6].T, rows[6], assoc.wgt)
    color = None
    if color_sigma is not None:
        j, e, wgt, _ = color_rows_plain(delta, lv.in_pts, lv.in_int,
                                        lv.md_int, gx, gy, lv.cam,
                                        color_sigma, lin.mean, lin.inv_std)
        color = _scale_rows(j, e, wgt.reshape(-1))
    return depth, color


def disagreements(got, ref, scale, n_terms: int):
    """Where the kernel's sums ``got`` leave the bound around the plain
    version's ``ref`` (tuples of tensors; ``scale`` the same tuple of
    sum|t| as numpy, None for a count): each entry within
    (1.01 n + 3) 2^-24 sum|t| (see the note above :data:`U32`), counts
    equal. Returns [(index, max |d|, its bound)] of the entries outside."""
    c = bound_factor(n_terms)
    bad = []
    for i, (g, r, s) in enumerate(zip(got, ref, scale)):
        g, r = _np64(g), _np64(r)
        if s is None:
            if not np.array_equal(g, r):
                bad.append((i, g.tolist(), r.tolist()))
            continue
        lim = c * U32 * np.asarray(s, dtype=np.float64)
        err = np.abs(g - r)
        if not np.all(err <= lim):
            bad.append((i, float(np.nanmax(np.where(np.isnan(err), np.inf,
                                                    err))),
                        float(np.max(lim))))
    return bad


def pass_outputs(assoc: Association, lin: Linearization):
    """Every output of one iteration's passes, by name (copies)."""
    named = [("q", x) for x in assoc.q] + [("nq", x) for x in assoc.nq] + [
        ("wgt", assoc.wgt), ("ok", assoc.ok), ("sum_q", assoc.moments[0]),
        ("sum_qq", assoc.moments[1]), ("cnt", assoc.moments[2]),
        ("s", assoc.s), ("mean", lin.mean), ("inv_std", lin.inv_std),
        ("planar", lin.planar)]
    for key, sys_ in (("depth", lin.depth), ("color", lin.color)):
        if sys_ is not None:
            named += [(f"{key}[{k}]", x) for k, x in enumerate(sys_)]
    return [(k, x.clone()) for k, x in named if x is not None]


def same_bits(a, b) -> bool:
    """The same tensors bit for bit (f32 by their bits, so NaN equals the
    same NaN), or both None."""
    if a is None or b is None:
        return a is None and b is None
    if a.dtype == torch.float32:
        return b.dtype == torch.float32 and torch.equal(
            a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def check_pass(delta, lv: Level, args, planar_thres: float,
               color_sigma: Optional[float]):
    """One ICP iteration through the kernels and through the plain
    versions, on the card: the split pair's association (q, n_q, the
    weight and the flag bit for bit; the moments and the scatter within
    :func:`disagreements`), then its linearization on the kernel's
    association and sums (mean and inv_std bit for bit, the planarity
    flag equal unless I2 lies within 1e-6 of its threshold, the systems
    within :func:`disagreements`, counts equal); then the fused launch
    (:func:`associate_linearize`) against the split pair, every output
    bit for bit (so it holds against the plain versions as the pair
    does). ``args``: associate's (dist_thres, normal_thres, depth_min,
    depth_max, scatter). Returns (failures, {"assoc"/"depth"/"color":
    (max |d|, excess)})."""
    def err(a, b):
        return max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(a, b))

    scatter, n = args[-1], lv.n
    got = associate(delta, lv, *args)
    ref = associate_reference(delta, lv, *args)
    torch.cuda.synchronize()
    bad = []
    if not (all(same_bits(x, y)
                for x, y in zip(got.q + got.nq + (got.wgt,),
                                ref.q + ref.nq + (ref.wgt,)))
            and torch.equal(got.ok, ref.ok)):
        bad.append("association not bit-equal")
    m_scale, s_scale = scale_assoc(lv, ref, scatter)
    sums_g = got.moments + ((got.s,) if scatter else ())
    sums_r = ref.moments + ((ref.s,) if scatter else ())
    scale = m_scale + ((s_scale,) if scatter else ())
    d = disagreements(sums_g, sums_r, scale, n)
    if d:
        bad.append(f"association sums {d}")
    out = {"assoc": (err(sums_g, sums_r), excess(sums_g, sums_r, scale))}
    lin = linearize(delta, lv, got, got.moments, got.s, planar_thres,
                    color_sigma)
    lref = linearize_reference(delta, lv, got, got.moments, got.s,
                               planar_thres, color_sigma)
    torch.cuda.synchronize()
    if not (same_bits(lin.mean, lref.mean)
            and same_bits(lin.inv_std, lref.inv_std)):
        bad.append(f"whitening {lin.mean.tolist()} {float(lin.inv_std)} "
                   f"against {lref.mean.tolist()} {float(lref.inv_std)}")
    if scatter:
        i2 = float(planarity_epilogue(got.s, planar_thres)[1])
        if bool(lin.planar) != bool(lref.planar) \
                and abs(i2 - planar_thres) > 1e-6 * planar_thres:
            bad.append(f"planar {bool(lin.planar)} against "
                       f"{bool(lref.planar)}, I2 {i2}")
    sc_d, sc_c = scale_linearize(delta, lv, got, lin, color_sigma)
    for key, g, r, sc in (("depth", lin.depth, lref.depth, sc_d),
                          ("color", lin.color, lref.color, sc_c)):
        if g is None:
            continue
        d = disagreements(g, r, sc, n)
        if d:
            bad.append(f"{key} system {d}")
        out[key] = (err(g[:4], r[:4]), excess(g, r, sc))
    split = pass_outputs(got, lin)
    fused = pass_outputs(*associate_linearize(delta, lv, *args,
                                              planar_thres, color_sigma))
    torch.cuda.synchronize()
    diff = [k for (k, x), (_, y) in zip(split, fused) if not same_bits(x, y)]
    if diff or len(split) != len(fused):
        bad.append(f"the fused launch differs from the split pair in {diff}")
    return bad, out


def excess(got, ref, scale) -> float:
    """max |d| / (2^-24 sum|t|) over the summed entries: the factor the
    data needed, beside the bound's (1.01 n + 3)."""
    worst = 0.0
    for g, r, s in zip(got, ref, scale):
        if s is None:
            continue
        s = np.asarray(s, dtype=np.float64)
        d = np.abs(_np64(g) - _np64(r))
        pos = s > 0
        if np.any(np.isnan(d)) or np.any(d[~pos] != 0):
            return math.inf
        if pos.any():
            worst = max(worst, float(np.max(d[pos] / (U32 * s[pos]))))
    return worst


# ---------------------------------------------------------------------------
# An edge bank: the levels where a kernel goes wrong first
# ---------------------------------------------------------------------------

EDGE_CASES = ("odd", "row_shard", "all_rejected", "one_pixel", "strided")
EDGE_THRES = dict(dist_thres=0.1, normal_thres=0.8, depth_min=0.5,
                  depth_max=5.0, planar_thres=4.0e-3, color_sigma=0.1)


def _edge_maps(rng, h, w, cam):
    """A tilted, noisy plane seen by ``cam`` at ~1.5 m: points, normals
    and an intensity texture [h,w] (f32 numpy)."""
    v, u = np.meshgrid(np.arange(h, dtype=np.float64),
                       np.arange(w, dtype=np.float64), indexing="ij")
    z = 1.5 + 0.2 * (u / max(w - 1, 1)) + 0.1 * (v / max(h - 1, 1)) \
        + rng.normal(0.0, 0.002, (h, w))
    pts = np.stack([(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z,
                    z], axis=-1)
    nrm = np.array([-0.2, -0.1, -1.0]) + rng.normal(0.0, 0.01, (h, w, 3))
    nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    tex = 0.5 + 0.3 * np.sin(u * 0.7) * np.cos(v * 0.5)
    return (pts.astype(np.float32), nrm.astype(np.float32),
            tex.astype(np.float32))


def _spoil(rng, cam, delta, in_pts, in_nrm, in_int, md_pts, md_int):
    """Edge values in place: NaN input points, normals and intensities,
    pz == 0 after ``delta`` (a rotation about z with no z translation maps
    z = 0 to 0 exactly), projections just inside and off every border and
    behind the camera, NaN model points and intensities."""
    h, w = cam.height, cam.width
    n = h * w
    fp, fn = in_pts.reshape(-1, 3), in_nrm.reshape(-1, 3)
    pick = rng.permutation(n)
    fp[pick[:12]] = np.nan
    fn[pick[12:18]] = np.nan
    fp[pick[18:22], 2] = np.nan
    fp[pick[22:26], 2] = 0.0                         # pz == 0
    inv = np.linalg.inv(delta.astype(np.float64))
    targets = [(-3.0, 7.0), (w + 2.0, 7.0), (10.0, -3.0), (10.0, h + 2.0),
               (-0.6, -0.6), (w - 0.4, h - 0.4), (-0.4, 3.0),
               (w - 0.6, 3.0)]
    for k, (uu, vv) in zip(pick[26:34], targets):
        z = 1.6
        cam_pt = np.array([(uu - cam.cx) / cam.fx * z,
                           (vv - cam.cy) / cam.fy * z, z, 1.0])
        fp[k] = (inv @ cam_pt)[:3]
    fp[pick[34], 2] = -1.0                           # behind the camera
    in_int.reshape(-1)[pick[35:40]] = np.nan
    md_int.reshape(-1)[rng.permutation(n)[:6]] = np.nan
    md_pts.reshape(-1, 3)[rng.permutation(n)[:6]] = np.nan


def edge_bank(seed: int = 3):
    """Seeded levels with the cases a kernel gets wrong first, each a dict
    of numpy arrays (in_pts, in_nrm [h,w,3], md_pts, md_nrm [H,W,3], in_int
    [h,w], md_int [H,W], delta [4,4]), the level's ``cam``, ``case`` and
    ``stride``: an odd 20x15 level with the edge values of ``_spoil``
    ("odd"); rows 5-11 of it against the whole model, as a rank's row shard
    ("row_shard"); every pixel rejected by both tests, counts 0
    ("all_rejected"); a 1x1 level, where the bilinear corners' indices
    wrap ("one_pixel"); and the odd level with its maps as [::2, ::2]
    views of arrays twice the size, as the pyramid makes them ("strided",
    ``stride`` 2)."""
    rng = np.random.default_rng(seed)
    out = []
    for case in EDGE_CASES:
        if case == "strided":
            entry = dict(out[0], case=case, stride=2)
            for k in ("in_pts", "in_nrm", "in_int", "md_pts", "md_nrm",
                      "md_int"):
                big = np.repeat(np.repeat(entry[k], 2, axis=0), 2, axis=1)
                big[1::2] += np.float32(0.5)           # never read
                entry[k] = big
            out.append(entry)
            continue
        w, h = (1, 1) if case == "one_pixel" else (20, 15)
        cam = CameraConfig(width=w, height=h, fx=w * 0.9, fy=w * 0.9,
                           cx=(w - 1) / 2.0, cy=(h - 1) / 2.0)
        md_pts, md_nrm, md_int = _edge_maps(rng, h, w, cam)
        in_pts, in_nrm, in_int = _edge_maps(rng, h, w, cam)
        ang = rng.normal(0.0, 0.01, 3)
        c, s = np.cos(ang), np.sin(ang)
        delta = np.eye(4)
        if case in ("odd", "row_shard", "strided"):
            delta[:2, :2] = [[c[0], -s[0]], [s[0], c[0]]]
            delta[:2, 3] = rng.normal(0.0, 0.005, 2)
            _spoil(rng, cam, delta, in_pts, in_nrm, in_int, md_pts, md_int)
        elif case == "all_rejected":
            delta[:3, :3] = (
                np.array([[c[0], -s[0], 0], [s[0], c[0], 0], [0, 0, 1]])
                @ np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]]))
            delta[:3, 3] = rng.normal(0.0, 0.005, 3)
            md_nrm = -md_nrm                     # the normals disagree
            in_int = in_int + np.float32(0.5)    # |e| > sigma everywhere
        entry = {"case": case, "cam": cam, "delta": delta.astype(np.float32),
                 "in_pts": in_pts, "in_nrm": in_nrm, "in_int": in_int,
                 "md_pts": md_pts, "md_nrm": md_nrm, "md_int": md_int,
                 "stride": 1}
        if case == "row_shard":
            # the shard's pixels project into the whole model: its camera
            # is the frame's
            for k in ("in_pts", "in_nrm", "in_int"):
                entry[k] = entry[k][5:12].copy()
        out.append(entry)
    return out


def edge_level(entry, device) -> Level:
    """One :func:`edge_bank` entry as a :class:`Level` on ``device`` (the
    strided case as [::2, ::2] views, as ``build_pyramid`` makes them)."""
    def t(k):
        a = torch.from_numpy(np.ascontiguousarray(entry[k])).to(device)
        st = entry["stride"]
        return a[::st, ::st] if st > 1 else a

    return Level(t("in_pts"), t("in_nrm"), t("md_pts"), t("md_nrm"),
                 entry["cam"], t("in_int"), t("md_int"))
