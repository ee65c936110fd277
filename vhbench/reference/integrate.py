"""Depth-map integration of the reference: a frozen copy of the plain
versions of ``voxelhashing_tpu_torch.integrate`` (the allocation
candidates' DDA, the TSDF fusion, weight starvation and GC's free pass),
nearest-pixel color only.

``rnd`` (identity by default) is applied to the fusion's float32 values
where they are formed; the control passes a rounding to bfloat16 (see
``reference.engine``).

Pool rows are updated in place (see ``blockmap``).
"""

from __future__ import annotations

import torch

from .config import CameraConfig, MapConfig
from . import blockmap
from . import geometry as geom
from .blockmap import MapState
from .geometry import INVALID_KEY
from .ops import alloc_candidates as _candidates

# ---------------------------------------------------------------------------
# Allocation candidates: DDA through block space along each pixel ray
# ---------------------------------------------------------------------------


def alloc_candidates(depth, pose, cam: CameraConfig, cfg: MapConfig,
                     tile: int = 1, phase=None, model_depth=None):
    """Block keys touched by the truncation bands of a depth frame.

    ``tile=1``: one DDA ray per pixel (exact, offline replay). ``tile>1``:
    two rays (min- and max-depth band) per ``tile x tile`` tile, the grid
    origin rotated by ``phase`` (the frame counter: a host int, or a device
    int32 scalar read by the kernel, with no host read). ``model_depth``:
    drop pixels whose depth agrees with the model within half a truncation
    (novelty-driven online allocation).
    Returns flat int32 keys; invalid entries are INVALID_KEY.
    """
    return _candidates.alloc_candidates_plain(
        depth, pose, cam, cfg, tile=tile, phase=phase,
        model_depth=model_depth)


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


def _same(x):
    return x


def integrate(state: MapState, depth, color, pose, cam: CameraConfig,
              cfg: MapConfig, active_idx=None, active_mask=None, rnd=_same):
    """Fuse one depth (+color) frame into the active blocks: the plain
    PyTorch version of the fused-integrate kernel.

    For each voxel of each active block: project into the frame, nearest-
    sample depth and color, sdf = depth - z
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
    if cfg.bilinear_color:
        raise NotImplementedError("the reference fuses the nearest "
                                  "pixel's color only")
    view = geom.invert_rigid(pose)
    if active_idx is None:
        active_idx, _, _ = blockmap.compactify(state, view, cam, cfg)
        active_mask = state.block_key[active_idx.long()] != INVALID_KEY
    aidx = active_idx.long()[active_mask]
    px, py, pz = (rnd(c) for c in geom.voxel_camera_positions(
        state.block_key[aidx], view, cfg.world_blocks, cfg.voxel_size))

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
    sdf = rnd(d - pz)
    trunc = cfg.truncation_at(d)
    update = (on_screen & d_valid
              & (d < cfg.max_integration_distance)
              & (sdf > -trunc))
    sdf = torch.clamp(sdf, min=-trunc, max=trunc)

    depth01 = geom.depth_to_zero_one(d, cam)
    w_new = torch.clamp(
        cfg.integration_weight_sample * 1.5 * (1.0 - depth01), min=1.0)

    words = frame_color_word(color, cam, dev)
    pc = words[pix]
    c_new = pc & 0x00FFFFFF
    update &= (pc >> 24) == 1

    old_sdf = state.sdf[aidx].to(torch.float32)
    old_w = state.weight[aidx].to(torch.float32)
    old_c = state.color[aidx]

    new_w_sum = old_w + w_new
    fused_sdf = rnd(rnd(rnd(old_sdf * old_w) + rnd(sdf * w_new))
                    / new_w_sum)
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


def gc_stats(state: MapState, active_idx):
    """GC's per-row stats re-read from the rows: (min |sdf| over the
    weighted voxels, inf where none; max weight), f32 [M]."""
    aidx = active_idx.long()
    sdf = state.sdf[aidx].to(torch.float32)
    w = state.weight[aidx].to(torch.float32)
    min_sdf = torch.amin(torch.where(w > 0.0, torch.abs(sdf), torch.inf),
                         dim=-1)
    return min_sdf, torch.amax(w, dim=-1)


def garbage_collect(state: MapState, active_idx, active_mask,
                    cfg: MapConfig, cached_stats=None) -> MapState:
    """Cull active blocks whose min |sdf| over weighted voxels reaches the
    far truncation or whose max weight is 0, and free the first
    ``min(gc_delete_cap, M)`` of them: the cull flags, their prefix rank,
    the short list and ``blockmap.delete_blocks`` over it. ``cached_stats``:
    (min_abs_sdf, max_weight) over the current rows (from
    :func:`integrate`)."""
    min_sdf, max_w = (cached_stats if cached_stats is not None
                      else gc_stats(state, active_idx))
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
