"""The yardstick's arithmetic: the published peaks of the card, and the
least bytes and operations of the kernels whose rooflines the benchmark
reports, each computed from what these inputs need.

Copies of ``chip_smoke.py``'s ``_bound``, ``_work_a``, ``_work_b``,
``_band_voxels`` and of the counts they call
(``ops/fused_integrate.bytes_moved`` / ``operations``,
``ops/splat_zbuf.bytes_moved`` / ``operations``,
``ops/raymarch.work_counts`` / ``bytes_moved`` / ``operations``), written
here so that a later change to the program cannot move its own yardstick.
The march's samples are counted with the reference's plain march
(``reference.raycast``), which needs no kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .reference import blockmap, geometry as geom, raycast
from .reference.geometry import INVALID_KEY
from .reference.ops import raymarch as rm

# NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): HBM3 bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
VOXELS_PER_BLOCK = 512


def bound_ms(nbytes: int, nops: int):
    """The least time (ms) of a kernel that moves ``nbytes`` and does
    ``nops`` f32 operations, and which of the two bounds it."""
    by_bytes = 1000.0 * nbytes / HBM_BYTES_PER_S
    by_ops = 1000.0 * nops / F32_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# --- kernel A: the fused integrate --------------------------------------

# f32 operations per voxel, counted on the plain fusion: every voxel of an
# active row is placed (3) and moved into the camera (18), projected (12),
# tested against its depth sample (8) and enters the row's stats (5); an
# updated voxel also forms its color word (15) and its update (13)
A_OPS_PER_VOXEL = 3 + 18 + 12 + 8 + 5
A_OPS_PER_UPDATE = 15 + 13


def integrate_bytes(n_rows: int, n_updated: int, max_rows: int, cam,
                    with_color: bool = True) -> int:
    """Kernel A's least bytes: bf16 sdf and weight of every voxel of the
    active rows read (4 B); each updated voxel's color read and its sdf,
    weight and color written (12 B); the frame (f32 depth, f32 RGB); per
    active row its list entry and key read and its surface flag written;
    the stats of all ``max_rows`` rows written (8 B); the view and
    ``n_active``."""
    pixels = cam.height * cam.width
    return (2 * 2 * VOXELS_PER_BLOCK * n_rows + 12 * n_updated
            + pixels * 4 * (4 if with_color else 1) + 9 * n_rows
            + 8 * max_rows + 64 + 4)


def integrate_ops(n_rows: int, n_updated: int) -> int:
    return (A_OPS_PER_VOXEL * VOXELS_PER_BLOCK * n_rows
            + A_OPS_PER_UPDATE * n_updated)


def updated_voxels(before, after) -> int:
    """Voxels whose stored sdf, weight or color bits the frame changed,
    in rows that are still allocated after it (the rows GC freed are
    zeroed by GC, not by the fusion)."""
    kept = (after.block_key != INVALID_KEY).nonzero().reshape(-1)
    n = 0
    for lo in range(0, kept.numel(), 1 << 15):
        rows = kept[lo:lo + (1 << 15)]
        diff = torch.zeros((rows.numel(), VOXELS_PER_BLOCK),
                           dtype=torch.bool, device=rows.device)
        for f in ("sdf", "weight", "color"):
            a, b = getattr(before, f)[rows], getattr(after, f)[rows]
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            diff |= a != b
        n += int(diff.sum())
    return n


# --- kernel B: the splat z-buffer ----------------------------------------

# every voxel of a surface row takes the band test (3); a voxel in the band
# is placed (3), moved into the camera (18), projected (12) and tested
# against the screen and the depth range (3)
B_OPS_PER_VOXEL = 3
B_OPS_PER_BAND_VOXEL = 3 + 18 + 12 + 3


def splat_bytes(n_surface_rows: int, max_rows: int, cam) -> int:
    """Kernel B's least bytes: bf16 sdf and weight of every voxel of the
    surface rows (4 B); per surface row its list entry and key; the row
    mask of all rows (1 B); the z-buffer written (4 B a pixel); the
    view."""
    return (2 * 2 * VOXELS_PER_BLOCK * n_surface_rows + 8 * n_surface_rows
            + max_rows + 4 * cam.height * cam.width + 64)


def splat_ops(n_surface_rows: int, n_band: int) -> int:
    return (B_OPS_PER_VOXEL * VOXELS_PER_BLOCK * n_surface_rows
            + B_OPS_PER_BAND_VOXEL * n_band)


def active_rows(map_state, pose, cfg):
    """The front's active list at ``pose``: (rows int64 [n], mask bool
    [M], active_idx int32 [M])."""
    view = geom.invert_rigid(pose)
    aidx, n, _ = blockmap.compactify(map_state, view, cfg.camera, cfg.map)
    mask = torch.arange(aidx.shape[0], device=aidx.device) < n
    return aidx.long()[mask], mask, aidx


def splat_counts(map_state, pose, cfg):
    """(surface rows, band voxels) of the splat render from ``pose``: the
    active rows with the surface flag, and their voxels with w > 0 and
    |sdf| < one voxel, the only ones kernel B projects."""
    rows, _, _ = active_rows(map_state, pose, cfg)
    sel = rows[map_state.surf[rows]]
    band = ((map_state.weight[sel].float() > 0.0)
            & (map_state.sdf[sel].float().abs() < cfg.map.voxel_size))
    return int(sel.numel()), int(band.sum())


# --- the march ---------------------------------------------------------

class MarchWork(NamedTuple):
    """What one march needs on its data."""

    rays: int            # P
    samples: int         # march samples (in band, up to a crossing)
    crossed: int         # rays with a crossing: 3 secant samples and a hit
    lookups: int         # block lookups (a last-block cache missed)
    probe_rounds: int    # table slots read by those lookups
    slots: int           # distinct table slots read
    rows: int            # distinct pool rows touched
    voxels: int          # distinct voxels read (sdf and weight)
    color_voxels: int    # distinct voxels whose color was read
    tiles: int           # tiles of the bounds read


# operations of the plain march: a ray's set-up (23); a sample's position
# (8), its trilinear core (18) and 8 corners (20 each) and the crossing
# test (5); a color sample's 8 x 3 channels (4 each) and 3 divisions; a
# lookup's two hashes (16) and a probe round (5); a secant step (16)
RAY_OPS, SAMPLE_OPS, COLOR_OPS = 23, 8 + 18 + 8 * 20 + 5, 8 * 3 * 4 + 3
LOOKUP_OPS, PROBE_OPS, SECANT_OPS = 16, 5, 16


def march_bytes(w: MarchWork) -> int:
    """The least bytes of one march: each table slot read (4 B; 4 B more
    for the pool row of each key found), each voxel's sdf and weight
    (4 B) and color (4 B) read, the tile bounds (8 B a tile), the pose,
    and the outputs (29 B a ray)."""
    return (4 * w.slots + 4 * w.rows + 4 * w.voxels + 4 * w.color_voxels
            + 8 * w.tiles + 64 + 29 * w.rays)


def march_ops(w: MarchWork) -> int:
    return (RAY_OPS * w.rays + SAMPLE_OPS * (w.samples + 4 * w.crossed)
            + COLOR_OPS * w.crossed + LOOKUP_OPS * w.lookups
            + PROBE_OPS * w.probe_rounds + SECANT_OPS * 3 * w.crossed)


def _corner_keys(px, py, pz, mp):
    """Block keys [8, ...] (INVALID_KEY out of the world) and voxel
    indices within their blocks of each sample's 8 corners."""
    vs = mp.voxel_size
    b = [torch.floor(geom.div_const(q, vs)).to(torch.int32)
         for q in (px, py, pz)]
    half, wb = mp.world_blocks // 2, mp.world_blocks
    keys, local = [], []
    for c in range(8):
        v = [b[0] + (c & 1), b[1] + ((c >> 1) & 1), b[2] + ((c >> 2) & 1)]
        g = [torch.div(x, 8, rounding_mode="floor") + half for x in v]
        ok = ((g[0] >= 0) & (g[0] < wb) & (g[1] >= 0) & (g[1] < wb)
              & (g[2] >= 0) & (g[2] < wb))
        keys.append(torch.where(ok, (g[2] * wb + g[1]) * wb + g[0],
                                INVALID_KEY))
        local.append((torch.remainder(v[2], 8) * 8 + torch.remainder(v[1], 8))
                     * 8 + torch.remainder(v[0], 8))
    return torch.stack(keys), torch.stack(local)


def march_counts(map_state, pose, cfg) -> MarchWork:
    """What the march from ``pose`` needs on ``map_state``: the samples of
    the plain algorithm (each ray in its tile's band, up to its first
    crossing's second sample, then the secant and hit samples), the
    lookups a last-block cache misses on them, their probe rounds, and the
    distinct slots, rows and voxels they read."""
    cam, mp, rc = cfg.camera, cfg.map, cfg.raycast
    rows, mask, aidx = active_rows(map_state, pose, cfg)
    bounds = rm.ray_bounds_plain(map_state.block_key, aidx, mask,
                                 geom.invert_rigid(pose), cam, mp, rc)
    t_min, t_max = rm.ray_interval(bounds, pose.device, cam, mp, rc)
    rec = []

    def sample_soa(px, py, pz, with_color=False):
        out = raycast.trilinear_sample_soa(map_state, px, py, pz, mp,
                                           with_color=with_color)
        rec.append((px, py, pz, out[0], out[1]))
        return out

    d = rc.derived(mp)
    raycast.march_hits(sample_soa, pose, cam, t_min, t_max, rc.num_samples,
                       d["ray_increment"], d["thres_sample_dist"],
                       d["thres_dist"])
    dev = t_min.device
    s_n = rc.num_samples
    band = torch.clamp(t_max - t_min, min=0.0)
    dt = torch.clamp(geom.div_const(band, s_n - 1), min=d["ray_increment"])
    si = torch.arange(s_n, dtype=torch.float32, device=dev)[:, None]
    ts = t_min[None, :] + si * dt[None, :]
    in_band = ts <= (t_max[None, :] + dt[None, :])
    mx, my, mz, sdf_s, ok_s = rec[0]
    ok_s = ok_s & in_band
    cross = (ok_s[:-1] & ok_s[1:] & (sdf_s[:-1] > 0.0) & (sdf_s[1:] < 0.0)
             & (sdf_s[:-1] - sdf_s[1:] < d["thres_sample_dist"]))
    crossed = torch.any(cross, dim=0)
    first = torch.argmax(cross.to(torch.int8), dim=0)
    last = torch.where(crossed, first + 1, s_n - 1)
    taken_main = in_band & (si.to(torch.int64) <= last[None, :])
    # the sample order: march, 3 secants, the hit (its color read)
    pts = [(mx, my, mz)] + [r[:3] for r in rec[1:5]]
    taken = [taken_main] + [crossed[None, :]] * 4
    keys, local, valid, color = [], [], [], []
    for i, (x, y, z) in enumerate(pts):
        k, lc = _corner_keys(x.reshape(-1, x.shape[-1]),
                             y.reshape(-1, y.shape[-1]),
                             z.reshape(-1, z.shape[-1]), mp)   # [8, n, P]
        keys.append(k.transpose(0, 1).reshape(-1, k.shape[-1]))
        local.append(lc.transpose(0, 1).reshape(-1, lc.shape[-1]))
        tk = taken[i].expand(k.shape[1], -1)
        valid.append(tk.repeat_interleave(8, dim=0))
        color.append(torch.full_like(valid[-1], i == 4))
    keys, local = torch.cat(keys), torch.cat(local)
    valid, color = torch.cat(valid), torch.cat(color) & torch.cat(valid)
    n_e = keys.shape[0]
    pos = torch.arange(n_e, device=dev)[:, None].expand(-1, keys.shape[1])
    lastv = torch.cummax(torch.where(valid, pos, -1), dim=0).values
    prev = torch.cat([torch.full_like(lastv[:1], -1), lastv[:-1]])
    prev_key = torch.gather(keys, 0, prev.clamp(min=0))
    miss = valid & ((prev < 0) | (prev_key != keys))
    need = miss & (keys != INVALID_KEY)
    q = keys[need].to(torch.int32)
    hashes = blockmap._hashes(q)
    alive = torch.ones_like(q, dtype=torch.bool)
    rounds = torch.zeros_like(q, dtype=torch.int64)
    slots = []
    for r in range(mp.max_probes):
        slot = blockmap._slot(hashes, r, mp.table_size)
        tk = map_state.table_key[slot]
        rounds += alive.to(torch.int64)
        slots.append(slot[alive])
        alive = alive & (tk != q) & (tk != INVALID_KEY)
    row, hit = blockmap.lookup(map_state, torch.where(valid, keys,
                                                      INVALID_KEY), mp)
    read = valid & hit
    lin = row.to(torch.int64) * VOXELS_PER_BLOCK + local
    return MarchWork(
        rays=int(t_min.numel()), samples=int(taken_main.sum()),
        crossed=int(crossed.sum()),
        lookups=int(need.sum()), probe_rounds=int(rounds.sum()),
        slots=int(torch.unique(torch.cat(slots)).numel()),
        rows=int(torch.unique(row[read]).numel()),
        voxels=int(torch.unique(lin[read]).numel()),
        color_voxels=int(torch.unique(lin[read & color]).numel()),
        tiles=int(bounds[0].numel()))
