"""A numpy model of the tracker's pass kernels' order of summation
(``voxelhashing_tpu_torch/csrc/icp_linearize.cu``), shared by
``test_torch_icp_linearize.py`` (the model within
``icp_linearize.disagreements``' bound of the plain sums, on the CPU) and
``test_torch_kernels_cuda.py`` (the kernels' sums are the model's, bit for
bit, on the card)."""

from typing import Optional

import numpy as np
import torch

from voxelhashing_tpu_torch.ops import icp_linearize as il


def _f32(t):
    return t.detach().cpu().to(torch.float32).numpy()


def _row_terms(j, e, w, use):
    """Each pixel's terms of a system's sums as the kernel's ``add_row``
    forms them: f64 [P, SYS_SUMS] from the f32 rows (j [P,6], e, w [P]),
    zero where ``use`` is False."""
    t = np.zeros((j.shape[0], il.SYS_SUMS))
    k = 0
    with np.errstate(invalid="ignore", over="ignore"):
        for a in range(6):
            jw = (j[:, a] * w).astype(np.float64)
            for b in range(a, 6):
                t[:, k] = jw * j[:, b]
                k += 1
        ew = (e * w).astype(np.float64)
        for b in range(6):
            t[:, k + b] = ew * j[:, b]
        t[:, k + 6] = ew * e
    t[:, k + 7] = w
    t[:, k + 8] = 1.0
    t[~use] = 0.0
    return t


def kernel_terms(delta, lv: il.Level, assoc: il.Association, mean, inv_std,
                 scatter: bool, color_sigma: Optional[float]):
    """Each pixel's terms of the pass kernels' sums, as the kernels form
    them from the plain versions' f32 values: the association's (f64
    [P, ASSOC_SUMS]: q, |q|^2, the flag, the scatter's upper triangle) and
    the linearization's at (``mean``, ``inv_std``) (f64 [P, 30], or
    [P, 60] with the photometric rows), pixel-major as the kernels walk
    them."""
    q = [_f32(x) for x in assoc.q]
    ok = assoc.ok.detach().cpu().numpy()
    w = _f32(assoc.wgt)
    ta = np.zeros((lv.n, il.ASSOC_SUMS))
    for k in range(3):
        ta[:, k] = q[k]
    ta[:, 3] = (q[0] * q[0] + q[1] * q[1] + q[2] * q[2]) * ok.astype(
        np.float32)
    ta[:, 4] = ok
    if scatter:
        nr = [_f32(x) for x in il.soa(lv.in_nrm)]
        use = w > 0.0
        k = 5
        with np.errstate(invalid="ignore"):
            for a in range(3):
                nw = (nr[a] * w).astype(np.float64)
                for b in range(a, 3):
                    ta[:, k] = np.where(use, nw * nr[b], 0.0)
                    k += 1
    in_soa, _, gx, gy = lv.plain()
    rows = il.linearize_rows_plain(delta, in_soa, assoc.q, assoc.nq,
                                   assoc.wgt, assoc.ok, mean, inv_std)
    rows = _f32(rows)
    tl = [_row_terms(rows[:6].T, rows[6], w, ok)]
    if color_sigma is not None:
        j, e, wc, okc = il.color_rows_plain(delta, lv.in_pts, lv.in_int,
                                            lv.md_int, gx, gy, lv.cam,
                                            color_sigma, mean, inv_std)
        tl.append(_row_terms(_f32(j), _f32(e), _f32(wc).reshape(-1),
                             okc.detach().cpu().numpy().reshape(-1)))
    return ta, np.concatenate(tl, axis=1)


def summed_in_kernel_order(terms, grid: int):
    """The pass kernels' f64 sums of ``terms`` (f64 [P, N], pixel-major;
    N the columns of a partial row: 11, 30 or 60) on ``grid`` CTAs of T =
    ``icp_linearize.THREADS``, in the kernels' order
    (``csrc/icp_linearize.cu``): thread t of CTA b adds pixels b T + t,
    + G T, ... in order from 0; a warp's 32 sums as the butterfly tree of
    the transpose-reduce (lanes 16 apart, then 8, 4, 2, 1); the eight warps
    in order; then column c's partial rows in T // N groups (rows g, g + R,
    ...), each ``icp_linearize.CHUNK`` rows at a time (zeros past the last
    row) as a pairwise tree, the chunks in order, the groups in order.
    Returns [N] f64, before the kernels' rounding to f32."""
    p, cols = terms.shape
    span = grid * il.THREADS
    k = -(-p // span)
    pad = np.zeros((k * span, cols))
    pad[:p] = terms
    thread = np.zeros((span, cols))
    for kk in range(k):
        thread = thread + pad[kk * span:(kk + 1) * span]
    x = thread.reshape(grid, il.THREADS // 32, 32, cols)
    for half in (16, 8, 4, 2, 1):
        x = x[:, :, :half] + x[:, :, half:2 * half]
    warps = x[:, :, 0]
    rows = warps[:, 0]
    for wi in range(1, il.THREADS // 32):
        rows = rows + warps[:, wi]
    groups = il.THREADS // cols
    total = None
    for g in range(groups):
        r = rows[g::groups]
        m = -(-r.shape[0] // il.CHUNK)
        c = np.zeros((m * il.CHUNK, cols))
        c[:r.shape[0]] = r
        c = c.reshape(m, il.CHUNK, cols)
        h = il.CHUNK // 2
        while h >= 1:
            c = c[:, :h] + c[:, h:2 * h]
            h //= 2
        acc = np.zeros(cols)
        for mm in range(m):
            acc = acc + c[mm, 0]
        total = acc if total is None else total + acc
    return total


def model_sums(delta, lv: il.Level, assoc: il.Association, mean, inv_std,
               scatter: bool, color_sigma: Optional[float], grid: int):
    """The pass kernels' outputs on ``grid`` CTAs as the numpy model sums
    the plain versions' terms (:func:`kernel_terms`,
    :func:`summed_in_kernel_order`), rounded once to f32, in the wrappers'
    layouts (CPU tensors): (moments, s or None, depth, color or None)."""
    ta, tl = kernel_terms(delta, lv, assoc, mean, inv_std, scatter,
                          color_sigma)
    sa = summed_in_kernel_order(ta, grid).astype(np.float32)
    sl = summed_in_kernel_order(tl, grid)

    def t(x):
        return torch.from_numpy(np.array(x))

    moments = (t(sa[0:3]), t(sa[3]), t(sa[4]))
    s = None
    if scatter:
        s = t(sa[[5, 6, 7, 6, 8, 9, 7, 9, 10]].reshape(3, 3))

    def system(v):
        a = np.zeros((6, 6), np.float32)
        a[np.triu_indices(6)] = v[:21].astype(np.float32)
        a = np.triu(a) + np.triu(a, 1).T
        return (t(a), t(-v[21:27].astype(np.float32)),
                t(np.float32(v[27])), t(np.float32(v[28])),
                t(np.int32(v[29])))

    color = system(sl[il.SYS_SUMS:]) if color_sigma is not None else None
    return moments, s, system(sl[:il.SYS_SUMS]), color
