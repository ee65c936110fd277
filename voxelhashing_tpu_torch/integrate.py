"""Depth-map integration: block allocation, TSDF fusion, garbage collection
(PyTorch port of ``voxelhashing_tpu.integrate``).

* ``alloc_candidates``: per-pixel (or per-tile, two rays) 3D-DDA through
  block space over the truncation band, neighbour-shift dedup and
  per-column fold. The DDA's ``lax.scan`` is a Python loop of
  ``alloc_steps``; the tile phase is the frame counter, a host int (the
  eager step) or a device int32 scalar (the graphed step).
* ``integrate``: the plain PyTorch fusion pass, the reference that the
  CUDA kernel of ``ops/fused_integrate.py`` is held against; with
  ``MapConfig.bilinear_color`` the color sample is the validity-weighted
  bilinear one of ``_bilinear_color``.
* ``starve`` / ``garbage_collect``: weight starvation and block culling.

Pool rows are updated in place (see ``blockmap``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .config import CameraConfig, MapConfig, SDF_BLOCK_SIZE
from . import blockmap
from . import geometry as geom
from .blockmap import MapState
from .geometry import INVALID_KEY

# ---------------------------------------------------------------------------
# Allocation candidates: DDA through block space along each pixel ray
# ---------------------------------------------------------------------------


def _dda_band_keys(d, valid, xn, yn, pose, cfg: MapConfig):
    """Keys [alloc_steps, P] of the blocks the band [d-t, d+t] along each
    ray (xn, yn, 1) crosses; reference tie order x, z, y. Invalid entries
    are INVALID_KEY."""
    maxd = cfg.max_integration_distance
    valid = valid & torch.isfinite(d) & (d > 0.0) & (d < maxd)
    d = torch.where(valid, d, 1.0)

    t = cfg.truncation_at(d)
    min_d = torch.clamp(d - t, max=maxd)
    max_d = torch.clamp(d + t, max=maxd)
    valid = valid & (min_d < max_d)

    r, tr = pose[:3, :3], pose[:3, 3]

    def to_world(depth_along):
        cx_, cy_, cz_ = xn * depth_along, yn * depth_along, depth_along
        return (r[0, 0] * cx_ + r[0, 1] * cy_ + r[0, 2] * cz_ + tr[0],
                r[1, 0] * cx_ + r[1, 1] * cy_ + r[1, 2] * cz_ + tr[1],
                r[2, 0] * cx_ + r[2, 1] * cy_ + r[2, 2] * cz_ + tr[2])

    ox, oy, oz = to_world(min_d)
    ex, ey, ez = to_world(max_d)
    dx, dy, dz = ex - ox, ey - oy, ez - oz
    rl = torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-12)
    dx, dy, dz = dx / rl, dy / rl, dz / rl

    block_world = cfg.block_size_world
    vs = cfg.voxel_size

    def block_of(p):
        q = geom.div_const(p, vs)
        return torch.div((q + torch.sign(q) * 0.5).to(torch.int32),
                         SDF_BLOCK_SIZE, rounding_mode="floor")

    def axis_setup(c, e, o, dirc):
        step = torch.sign(dirc).to(torch.int32)
        boundary = (c + torch.clamp(step, 0, 1)).to(torch.float32) \
            * block_world - 0.5 * vs
        safe = torch.where(dirc == 0.0, 1e-12, dirc)
        t_max = (boundary - o) / safe
        t_delta = (step.to(torch.float32) * block_world) / safe
        degen = (dirc == 0.0) | (boundary - o == 0.0)
        return (step, torch.where(degen, torch.inf, t_max),
                torch.where(degen, torch.inf, t_delta), e + step)

    cx_, cy_, cz_ = block_of(ox), block_of(oy), block_of(oz)
    sx, tmx, tdx, bx = axis_setup(cx_, block_of(ex), ox, dx)
    sy, tmy, tdy, by = axis_setup(cy_, block_of(ey), oy, dy)
    sz, tmz, tdz, bz = axis_setup(cz_, block_of(ez), oz, dz)

    half = cfg.world_blocks // 2
    wb = cfg.world_blocks
    alive = valid
    keys = []
    for _ in range(cfg.alloc_steps):
        gx, gy, gz = cx_ + half, cy_ + half, cz_ + half
        ok = alive & (gx >= 0) & (gx < wb) & (gy >= 0) & (gy < wb) \
            & (gz >= 0) & (gz < wb)
        keys.append(torch.where(ok, (gz * wb + gy) * wb + gx, INVALID_KEY))
        takex = (tmx < tmy) & (tmx < tmz)
        takez = ~takex & (tmz < tmy)
        takey = ~takex & ~takez
        cx_ = cx_ + torch.where(takex, sx, 0)
        cy_ = cy_ + torch.where(takey, sy, 0)
        cz_ = cz_ + torch.where(takez, sz, 0)
        hit_bound = (takex & (cx_ == bx)) | (takey & (cy_ == by)) \
            | (takez & (cz_ == bz))
        tmx = torch.where(takex, tmx + tdx, tmx)
        tmy = torch.where(takey, tmy + tdy, tmy)
        tmz = torch.where(takez, tmz + tdz, tmz)
        alive = alive & ~hit_bound
    return torch.stack(keys).to(torch.int32)


def _dedup_and_fold(k3, fold: int):
    """West/north neighbour-shift dedup over the [S, h, w] key grid, then
    per-column rank-fold into the first ``fold`` step slots. Returns flat
    int32[fold * h * w] (or [S * h * w] when no fold applies)."""
    s, h, w = k3.shape
    west = torch.cat([torch.full((s, h, 1), INVALID_KEY, dtype=k3.dtype,
                                 device=k3.device), k3[:, :, :-1]], dim=2)
    north = torch.cat([torch.full((s, 1, w), INVALID_KEY, dtype=k3.dtype,
                                  device=k3.device), k3[:, :-1, :]], dim=1)
    dup = ((k3 == west) | (k3 == north)) & (k3 != INVALID_KEY)
    k3 = torch.where(dup, INVALID_KEY, k3)
    if fold < s:
        k2 = k3.reshape(s, h * w)
        vmask = k2 != INVALID_KEY
        rank = torch.cumsum(vmask, 0, dtype=torch.int32) - 1
        out = [torch.amin(torch.where(vmask & (rank == j), k2, INVALID_KEY),
                          dim=0) for j in range(fold)]
        return torch.stack(out).reshape(-1)
    return k3.reshape(-1)


def alloc_candidates(depth, pose, cam: CameraConfig, cfg: MapConfig,
                     tile: int = 1, phase=None, model_depth=None):
    """Block keys touched by the truncation bands of a depth frame.

    ``tile=1``: one DDA ray per pixel (exact, offline replay). ``tile>1``:
    two rays (min- and max-depth band) per ``tile x tile`` tile, the grid
    origin rotated by ``phase`` (the frame counter: a host int, or a device
    int32 scalar, which gives the same keys with no host read: the roll is
    then a gather and the offset an f32 add of the same small integer).
    ``model_depth``: drop pixels whose depth agrees with the model within
    half a truncation (novelty-driven online allocation).
    Returns flat int32 keys; invalid entries are INVALID_KEY.
    """
    h, w = depth.shape
    dev = depth.device
    if tile > 1 and h % tile == 0 and w % tile == 0:
        ht, wt = h // tile, w // tile
        pv = torch.isfinite(depth) & (depth > 0.0) \
            & (depth < cfg.max_integration_distance)
        if model_depth is not None:
            agree = (torch.isfinite(model_depth)
                     & (torch.abs(depth - model_depth)
                        < 0.5 * cfg.truncation_at(depth)))
            pv = pv & ~agree
        lo = torch.where(pv, depth, torch.inf)
        hi = torch.where(pv, depth, -torch.inf)
        py = px = 0
        if isinstance(phase, torch.Tensor):
            p = phase.to(torch.int64)
            py = torch.remainder(p, tile)
            px = torch.remainder(torch.div(p, tile, rounding_mode="floor"),
                                 tile)
            rows = torch.arange(h, device=dev)
            cols = torch.arange(w, device=dev)
            # torch.roll by (-py, -px) as a gather
            ridx = torch.remainder(rows + py, h)
            cidx = torch.remainder(cols + px, w)
            lo = lo[ridx][:, cidx]
            hi = hi[ridx][:, cidx]
            wrap = (rows[:, None] >= h - py) | (cols[None, :] >= w - px)
            lo = torch.where(wrap, torch.inf, lo)
            hi = torch.where(wrap, -torch.inf, hi)
            px, py = px.to(torch.float32), py.to(torch.float32)
        elif phase is not None:
            py = int(phase) % tile
            px = (int(phase) // tile) % tile
            lo = torch.roll(lo, shifts=(-py, -px), dims=(0, 1))
            hi = torch.roll(hi, shifts=(-py, -px), dims=(0, 1))
            rows = torch.arange(h, device=dev)[:, None]
            cols = torch.arange(w, device=dev)[None, :]
            wrap = (rows >= h - py) | (cols >= w - px)
            lo = torch.where(wrap, torch.inf, lo)
            hi = torch.where(wrap, -torch.inf, hi)
            px, py = float(px), float(py)
        for sl in (lambda a, o: a[:, o::tile], lambda a, o: a[o::tile, :]):
            lo = torch.amin(torch.stack([sl(lo, o) for o in range(tile)]), 0)
            hi = torch.amax(torch.stack([sl(hi, o) for o in range(tile)]), 0)
        dmin = lo.reshape(-1)
        dmax = hi.reshape(-1)
        any_v = torch.isfinite(dmin)
        dmin = torch.where(any_v, dmin, 1.0)
        dmax = torch.where(any_v, dmax, 1.0)
        uc = (torch.arange(wt, dtype=torch.float32, device=dev) + 0.5) \
            * tile - 0.5 + px
        vc = (torch.arange(ht, dtype=torch.float32, device=dev) + 0.5) \
            * tile - 0.5 + py
        u = uc[None, :].expand(ht, wt).reshape(-1)
        v = vc[:, None].expand(ht, wt).reshape(-1)
        xn = geom.div_const(u - cam.cx, cam.fx)
        yn = geom.div_const(v - cam.cy, cam.fy)
        s = cfg.alloc_steps
        ka3 = _dda_band_keys(dmin, any_v, xn, yn, pose, cfg).reshape(s, ht, wt)
        kb3 = _dda_band_keys(dmax, any_v, xn, yn, pose, cfg).reshape(s, ht, wt)
        dup = kb3 == ka3
        dup |= kb3 == torch.cat([ka3[1:], ka3[:1]], dim=0)
        dup |= kb3 == torch.cat([ka3[-1:], ka3[:-1]], dim=0)
        kb3 = torch.where(dup & (kb3 != INVALID_KEY), INVALID_KEY, kb3)
        k3 = torch.cat([ka3, kb3], dim=0)
        return _dedup_and_fold(k3, min(cfg.alloc_fold_tile, 2 * s))

    d = depth.reshape(-1)
    valid = torch.ones(d.shape, dtype=torch.bool, device=dev)
    u, v = geom.pixel_grid(w, h, dev)
    xn = geom.div_const(u.reshape(-1) - cam.cx, cam.fx)
    yn = geom.div_const(v.reshape(-1) - cam.cy, cam.fy)
    keys = _dda_band_keys(d, valid, xn, yn, pose, cfg)
    k3 = keys.reshape(cfg.alloc_steps, h, w)
    return _dedup_and_fold(k3, min(cfg.alloc_fold, cfg.alloc_steps))


def allocate_from_depth(state: MapState, depth, pose, cam: CameraConfig,
                        cfg: MapConfig, rounds: int = 2
                        ) -> Tuple[MapState, torch.Tensor]:
    """Per-pixel DDA candidates, then batch-insert."""
    keys = alloc_candidates(depth, pose, cam, cfg)
    return blockmap.allocate(state, keys, cfg, rounds=rounds)


# ---------------------------------------------------------------------------
# TSDF fusion
# ---------------------------------------------------------------------------


def _pack_frame_color(color):
    """[h,w,3] f32 in [0,1] -> ([h,w] int32 packed 0x00RRGGBB (x255),
    [h,w] bool valid)."""
    c = torch.where(torch.isfinite(color), color, -1.0) * 255.0
    valid = torch.all(color >= 0.0, dim=-1) & torch.all(
        torch.isfinite(color), dim=-1)
    return blockmap.pack_rgb(c), valid


def frame_color_word(color, cam: CameraConfig, device):
    """Per-pixel int32 word ``packed | valid << 24`` [h*w]: one read gives
    a pixel's color and its validity. ``color=None`` (depth-only) gives
    the reference's debug green, always valid."""
    if color is None:
        return torch.full((cam.height * cam.width,), 0x0100FF00,
                          dtype=torch.int32, device=device)
    packed, c_ok = _pack_frame_color(color)
    return torch.where(c_ok, packed | 0x01000000, packed).reshape(-1)


def integrate(state: MapState, depth, color, pose, cam: CameraConfig,
              cfg: MapConfig, active_idx=None, active_mask=None):
    """Fuse one depth (+color) frame into the active blocks: the plain
    PyTorch version of the fused-integrate kernel.

    For each voxel of each active block: project into the frame, nearest-
    sample depth and color (color bilinear with ``cfg.bilinear_color``;
    a voxel with no valid corner is not updated), sdf = depth - z
    truncated to the band, and
    ``combineVoxel`` (weighted sdf mean, weight capped at w_max, 50/50
    color blend) with the sample weight ``max(w_s*1.5*(1-depth01), 1)``.
    Only the rows ``active_idx[active_mask]`` are computed (the mask is
    resolved on the host, one sync on CUDA). Rows and ``surf`` are stored
    IN PLACE in the pool, rows as bf16.

    Returns (state, (min_abs_sdf f32[M], max_weight f32[M])): the per-row
    GC stats over the stored values; rows where ``active_mask`` is False
    get (inf, 0), as from the kernel.
    """
    dev = depth.device
    if dev.type == "cuda":
        integrate.cuda_calls += 1
    view = geom.invert_rigid(pose)
    if active_idx is None:
        active_idx, _, _ = blockmap.compactify(state, view, cam, cfg)
        active_mask = state.block_key[active_idx.long()] != INVALID_KEY
    aidx = active_idx.long()[active_mask]
    px, py, pz = geom.voxel_camera_positions(
        state.block_key[aidx], view, cfg.world_blocks, cfg.voxel_size)

    safe_z = torch.where(pz == 0.0, 1e-12, pz)
    uf = px * cam.fx / safe_z + cam.cx
    vf = py * cam.fy / safe_z + cam.cy
    ui = torch.floor(uf + 0.5).to(torch.int32)
    vi = torch.floor(vf + 0.5).to(torch.int32)
    on_screen = ((ui >= 0) & (ui < cam.width)
                 & (vi >= 0) & (vi < cam.height) & (pz > 0.0))
    ui = torch.clamp(ui, 0, cam.width - 1)
    vi = torch.clamp(vi, 0, cam.height - 1)
    pix = (vi * cam.width + ui).long()

    d = depth.reshape(-1)[pix]
    d_valid = torch.isfinite(d) & (d > 0.0)
    d = torch.where(d_valid, d, 0.0)
    sdf = d - pz
    trunc = cfg.truncation_at(d)
    update = (on_screen & d_valid
              & (d < cfg.max_integration_distance)
              & (sdf > -trunc))
    sdf = torch.clamp(sdf, min=-trunc, max=trunc)

    depth01 = geom.depth_to_zero_one(d, cam)
    w_new = torch.clamp(
        cfg.integration_weight_sample * 1.5 * (1.0 - depth01), min=1.0)

    words = frame_color_word(color, cam, dev)
    if color is not None and cfg.bilinear_color:
        c_new, c_ok = _bilinear_color(words, uf, vf, cam)
        update &= c_ok
    else:
        pc = words[pix]
        c_new = pc & 0x00FFFFFF
        update &= (pc >> 24) == 1

    old_sdf = state.sdf[aidx].to(torch.float32)
    old_w = state.weight[aidx].to(torch.float32)
    old_c = state.color[aidx]

    new_w_sum = old_w + w_new
    fused_sdf = (old_sdf * old_w + sdf * w_new) / new_w_sum
    fused_w = torch.clamp(new_w_sum, max=cfg.integration_weight_max)
    fused_c = _blend_packed(old_c, c_new)

    out_sdf = torch.where(update, fused_sdf, old_sdf).to(blockmap.POOL_DTYPE)
    out_w = torch.where(update, fused_w, old_w).to(blockmap.POOL_DTYPE)
    out_c = torch.where(update, fused_c, old_c)

    w_f = out_w.to(torch.float32)
    abs_s = torch.abs(out_sdf.to(torch.float32))
    m = active_idx.shape[0]
    min_sdf = torch.full((m,), torch.inf, dtype=torch.float32, device=dev)
    max_w = torch.zeros((m,), dtype=torch.float32, device=dev)
    min_sdf[active_mask] = torch.amin(
        torch.where(w_f > 0.0, abs_s, torch.inf), dim=1)
    max_w[active_mask] = torch.amax(w_f, dim=1)

    state.sdf[aidx] = out_sdf
    state.weight[aidx] = out_w
    state.color[aidx] = out_c
    state.surf[aidx] = torch.any((w_f > 0.0) & (abs_s < cfg.voxel_size),
                                 dim=1)
    return state, (min_sdf, max_w)


integrate.cuda_calls = 0     # calls on CUDA tensors (the kernel's job there)


def _bilinear_color(words, uf, vf, cam: CameraConfig):
    """Validity-weighted bilinear color sample at the continuous pixel
    coordinates (uf, vf), read from the frame's color-word image ``words``
    (:func:`frame_color_word`, int32 [h*w]): the rounded centre and its
    neighbours in the direction of the fractional offsets (a zero offset
    goes +1), corners off screen or with an invalid color weighted 0, the
    two row normalisations, then the column one. Returns (packed int32
    0x00RRGGBB, valid bool), invalid where no corner is valid. The
    kernel's bilinear variant repeats this operation for operation on the
    same image."""
    h, w = cam.height, cam.width

    p00x = torch.floor(uf + 0.5).to(torch.int32)
    p00y = torch.floor(vf + 0.5).to(torch.int32)
    dirx = torch.where(uf - p00x >= 0, 1, -1).to(torch.int32)
    diry = torch.where(vf - p00y >= 0, 1, -1).to(torch.int32)
    alpha = (uf - p00x) * dirx
    beta = (vf - p00y) * diry

    def fetch(px, py):
        on = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        idx = (torch.clamp(py, 0, h - 1) * w
               + torch.clamp(px, 0, w - 1)).long()
        word = words[idx]
        return blockmap.unpack_rgb(word), on & ((word >> 24) == 1)

    c00, ok00 = fetch(p00x, p00y)
    c10, ok10 = fetch(p00x + dirx, p00y)
    c01, ok01 = fetch(p00x, p00y + diry)
    c11, ok11 = fetch(p00x + dirx, p00y + diry)

    w00 = torch.where(ok00, 1 - alpha, 0.0)
    w10 = torch.where(ok10, alpha, 0.0)
    s0 = c00 * w00[..., None] + c10 * w10[..., None]
    wr0 = w00 + w10
    w01 = torch.where(ok01, 1 - alpha, 0.0)
    w11 = torch.where(ok11, alpha, 0.0)
    s1 = c01 * w01[..., None] + c11 * w11[..., None]
    wr1 = w01 + w11

    p0 = s0 / torch.clamp(wr0, min=1e-12)[..., None]
    p1 = s1 / torch.clamp(wr1, min=1e-12)[..., None]
    wb0 = torch.where(wr0 > 0, 1 - beta, 0.0)
    wb1 = torch.where(wr1 > 0, beta, 0.0)
    ss = p0 * wb0[..., None] + p1 * wb1[..., None]
    ww = wb0 + wb1
    out = ss / torch.clamp(ww, min=1e-12)[..., None]
    return blockmap.pack_rgb(out), ww > 0


def _blend_packed(old_c, new_c):
    """50/50 per-channel blend of packed 0x00RRGGBB colors with +0.5
    rounding, (o+n+1)>>1 per channel without crossing channels."""
    mask = 0x00FF00FF
    rb = (((old_c & mask) + (new_c & mask) + 0x00010001) >> 1) & mask
    g = (((old_c & 0x0000FF00) + (new_c & 0x0000FF00) + 0x00000100) >> 1) \
        & 0x0000FF00
    return rb | g


# ---------------------------------------------------------------------------
# Garbage collection
# ---------------------------------------------------------------------------


def starve(state: MapState, active_idx, active_mask) -> MapState:
    """Decrement every active voxel weight by 1, clamped at 0 (in place,
    with no host read)."""
    w = torch.clamp(state.weight[active_idx.long()] - 1.0, min=0.0)
    blockmap.set_rows_(state.weight, active_idx, w, active_mask)
    return state


def garbage_collect(state: MapState, active_idx, active_mask,
                    cfg: MapConfig, cached_stats=None) -> MapState:
    """Cull active blocks whose min |sdf| over weighted voxels reaches the
    far truncation or whose max weight is 0.

    ``cached_stats``: (min_abs_sdf, max_weight) over the CURRENT rows (the
    integrate kernel emits them), which skips the row re-read. The free
    pass runs masked over a ``gc_delete_cap`` short list; with nothing to
    cull it changes nothing.
    """
    if cached_stats is not None:
        min_sdf, max_w = cached_stats
    else:
        aidx = active_idx.long()
        sdf = state.sdf[aidx].to(torch.float32)
        w = state.weight[aidx].to(torch.float32)
        min_sdf = torch.amin(torch.where(w > 0.0, torch.abs(sdf),
                                         torch.inf), dim=-1)
        max_w = torch.amax(w, dim=-1)
    t = cfg.truncation_at(cfg.max_integration_distance)
    cull = active_mask & ((min_sdf >= t) | (max_w == 0.0))
    dcap = min(cfg.gc_delete_cap, active_idx.shape[0])
    rank = blockmap._rank(cull)
    keep = cull & (rank < dcap)
    short_idx = blockmap.put(
        torch.zeros((dcap,), dtype=torch.int32, device=cull.device),
        rank, active_idx, keep)
    n_cull = torch.clamp(blockmap._isum(cull), max=dcap)
    short_mask = torch.arange(dcap, device=cull.device) < n_cull
    return blockmap.delete_blocks(state, short_idx, short_mask, cfg)
