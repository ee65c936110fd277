"""Isosurface mesh extraction over the block-sparse TSDF map (PyTorch port
of ``voxelhashing_tpu.meshing``).

Marching tetrahedra over the six-tetrahedron cube decomposition: every
case gives one or two triangles on the crossing edges, oriented along the
sdf gradient. Surface cubes are compacted first (mask -> prefix sum ->
scatter), then each tetrahedron slot emits into one flat triangle list
compacted the same way, so the triangle soup comes out in the JAX order.

The JAX code caps cubes and triangles at static sizes per window and drops
what does not fit; here each list is sized to its exact count (one host
read each), so nothing is dropped. :func:`extract_mesh_streamed` composes
the device map with a streaming manager's host store. :func:`save_ply`
welds with the native writer, or, when asked, with :func:`merge_vertices`.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import MapConfig, MeshConfig, SDF_BLOCK_SIZE, VOXELS_PER_BLOCK
from . import blockmap, geometry as geom, streaming
from .blockmap import MapState
from .geometry import INVALID_KEY

# Cube corners: corner i at offset ((i>>0)&1, (i>>1)&1, (i>>2)&1).
_CUBE_CORNERS = [(i & 1, (i >> 1) & 1, (i >> 2) & 1) for i in range(8)]

# Six tetrahedra around the main diagonal 0-7.
_TETS = [(0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7),
         (0, 6, 4, 7), (0, 4, 5, 7), (0, 5, 1, 7)]

# Tet edges as index pairs into the 4 tet vertices.
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _tet_cases():
    """Per 4-bit inside mask, the triangles as triples of tet-edge ids: one
    vertex inside (or out) -> one triangle on its three edges; two -> the
    quad on the four crossing edges, as two triangles."""
    cases = []
    for mask in range(16):
        inside = [i for i in range(4) if mask & (1 << i)]
        cross = [e for e, (a, b) in enumerate(_TET_EDGES)
                 if (mask >> a & 1) != (mask >> b & 1)]
        if len(inside) in (0, 4):
            cases.append([])
        elif len(inside) in (1, 3):
            cases.append([tuple(cross)])
        else:
            # order the crossing edges into a ring: neighbours share a vertex
            ring = [cross[0]]
            rest = cross[1:]
            while rest:
                a = set(_TET_EDGES[ring[-1]])
                nxt = next(e for e in rest if set(_TET_EDGES[e]) & a)
                ring.append(nxt)
                rest.remove(nxt)
            cases.append([(ring[0], ring[1], ring[2]),
                          (ring[0], ring[2], ring[3])])
    return cases


_TET_CASES = _tet_cases()
_MAX_TRIS_PER_TET = 2


def _slot_tables(slot: int):
    """(edge ids int32[16,3], has bool[16]) of triangle ``slot``."""
    e_ids = np.zeros((16, 3), np.int32)
    has = np.zeros((16,), bool)
    for m_case, tris in enumerate(_TET_CASES):
        if slot < len(tris):
            e_ids[m_case] = tris[slot]
            has[m_case] = True
    return e_ids, has


class MeshChunk(NamedTuple):
    """Extracted triangle soup, exactly ``n_triangles`` long."""

    vertices: torch.Tensor     # f32[T,3,3] corner positions (world)
    colors: torch.Tensor       # f32[T,3,3] corner RGB in [0,1]
    n_triangles: int


def _compact(mask):
    """(rank, n) of a flat mask: exclusive prefix ranks and the count
    (read on the host, it sizes the compacted list)."""
    return blockmap._rank(mask), int(blockmap._isum(mask))


def _compact_surface_cubes(state: MapState, block_idx, block_mask,
                           cfg: MapConfig):
    """Voxels whose cube may straddle the surface: weight > 0 and
    |sdf| < 2 voxels (compared in the pool dtype, as JAX does). Returns
    (cube_block int32[n], cube_local int32[n])."""
    bi = block_idx.long()
    sdf = state.sdf[bi]
    w = state.weight[bi]
    thresh = torch.full((), 2.0 * cfg.voxel_size, dtype=sdf.dtype,
                        device=sdf.device)
    near = (w > 0.0) & (torch.abs(sdf) < thresh) & block_mask[:, None]
    flat = near.reshape(-1)
    rank, n = _compact(flat)
    src = torch.arange(flat.shape[0], dtype=torch.int32, device=flat.device)
    slots = blockmap.put(torch.zeros((n,), dtype=torch.int32,
                                     device=flat.device), rank, src, flat)
    cube_block = block_idx[torch.div(slots, VOXELS_PER_BLOCK,
                                     rounding_mode="floor").long()]
    cube_local = slots % VOXELS_PER_BLOCK
    return cube_block, cube_local


def extract_block_range(state: MapState, block_idx, block_mask,
                        cfg: MapConfig, mesh_cfg: MeshConfig) -> MeshChunk:
    """Triangles of the blocks ``block_idx[block_mask]``, every one of
    them (the JAX code caps a window at 2^17 cubes and 2^18 triangles)."""
    cube_block, cube_local = _compact_surface_cubes(state, block_idx,
                                                    block_mask, cfg)

    blocks = geom.unpack_block_key(state.block_key[cube_block.long()],
                                   cfg.world_blocks)
    bs = SDF_BLOCK_SIZE
    lx = cube_local % bs
    ly = torch.div(cube_local, bs, rounding_mode="floor") % bs
    lz = torch.div(cube_local, bs * bs, rounding_mode="floor")
    vx = blocks[:, 0] * bs + lx
    vy = blocks[:, 1] * bs + ly
    vz = blocks[:, 2] * bs + lz

    cx = torch.stack([vx + o[0] for o in _CUBE_CORNERS], 0)     # [8,C]
    cy = torch.stack([vy + o[1] for o in _CUBE_CORNERS], 0)
    cz = torch.stack([vz + o[2] for o in _CUBE_CORNERS], 0)
    sdf, w, col = blockmap.gather_voxels_soa(state, cx, cy, cz, cfg,
                                             with_color=True)
    all_valid = torch.all(w > 0.0, dim=0)
    thresh = mesh_cfg.thresh_factor * cfg.voxel_size
    all_valid &= (torch.amax(sdf, dim=0) - torch.amin(sdf, dim=0)) < thresh

    vs = cfg.voxel_size
    corner_pos = [torch.stack([cx[i].to(torch.float32) * vs,
                               cy[i].to(torch.float32) * vs,
                               cz[i].to(torch.float32) * vs], dim=-1)
                  for i in range(8)]
    corner_col = [geom.div_const(blockmap.unpack_rgb(col[i]), 255.0)
                  for i in range(8)]
    return emit_tet_triangles(sdf, corner_pos, corner_col, all_valid)


def emit_tet_triangles(sdf, corner_pos, corner_col, all_valid) -> MeshChunk:
    """Marching-tetrahedra emission: ``sdf`` [8,C] corner samples (corner
    order ``_CUBE_CORNERS``), ``corner_pos``/``corner_col`` 8 x [C,3],
    ``all_valid`` [C] the cubes that may emit."""
    c = sdf.shape[1]
    dev = sdf.device
    rows = torch.arange(c, device=dev)
    tables = [tuple(torch.from_numpy(a).to(dev) for a in _slot_tables(s))
              for s in range(_MAX_TRIS_PER_TET)]
    tri_masks, tri_verts, tri_cols = [], [], []
    for tet in _TETS:
        s4 = [sdf[i] for i in tet]
        inside = [s < 0.0 for s in s4]
        case = (inside[0].to(torch.int64) + 2 * inside[1].to(torch.int64)
                + 4 * inside[2].to(torch.int64)
                + 8 * inside[3].to(torch.int64))

        everts, ecols = [], []
        for (a, b) in _TET_EDGES:
            sa, sb = s4[a], s4[b]
            denom = sa - sb
            t = torch.where(torch.abs(denom) > 1e-12, sa / denom, 0.5)
            t = torch.clamp(t, 0.0, 1.0)[:, None]
            pa, pb = corner_pos[tet[a]], corner_pos[tet[b]]
            everts.append(pa + t * (pb - pa))
            ca, cb = corner_col[tet[a]], corner_col[tet[b]]
            ecols.append(ca + t * (cb - ca))
        ev = torch.stack(everts, 0)                            # [6,C,3]
        ec = torch.stack(ecols, 0)

        # orientation: from the inside (-) corners' centroid toward the
        # outside (+) ones'; normals point to positive sdf
        pos_w = torch.stack([(~inside[i]).to(torch.float32)
                             for i in range(4)], 0)            # [4,C]
        neg_w = 1.0 - pos_w
        p4 = torch.stack([corner_pos[i] for i in tet], 0)      # [4,C,3]
        cp = torch.sum(pos_w[..., None] * p4, 0) / torch.clamp(
            torch.sum(pos_w, 0), min=1.0)[..., None]
        cn = torch.sum(neg_w[..., None] * p4, 0) / torch.clamp(
            torch.sum(neg_w, 0), min=1.0)[..., None]
        outward = cp - cn

        for e_ids, has in tables:
            e_sel = e_ids[case].long()                         # [C,3]
            emit = has[case] & all_valid
            v3 = torch.stack([ev[e_sel[:, k], rows] for k in range(3)], 1)
            c3 = torch.stack([ec[e_sel[:, k], rows] for k in range(3)], 1)
            nrm = torch.linalg.cross(v3[:, 1] - v3[:, 0],
                                     v3[:, 2] - v3[:, 0], dim=-1)
            emit_t = emit & (torch.sum(nrm * nrm, dim=-1) > 1e-18)
            flip = (torch.sum(nrm * outward, dim=-1) < 0.0)[:, None, None]
            v3 = torch.where(flip, v3[:, [0, 2, 1]], v3)
            c3 = torch.where(flip, c3[:, [0, 2, 1]], c3)
            tri_masks.append(emit_t)
            tri_verts.append(v3)
            tri_cols.append(c3)

    emit = torch.cat(tri_masks, 0)
    rank, n = _compact(emit)
    zeros = torch.zeros((n, 3, 3), dtype=torch.float32, device=dev)
    out_v = blockmap.put(zeros, rank, torch.cat(tri_verts, 0), emit)
    out_c = blockmap.put(zeros, rank, torch.cat(tri_cols, 0), emit)
    return MeshChunk(vertices=out_v, colors=out_c, n_triangles=n)


class _Budget:
    """Host-side collection under ``max_triangles`` (the reference's
    append-triangle overflow clamp)."""

    def __init__(self, max_triangles: int):
        self.max = max_triangles
        self.verts, self.cols = [], []
        self.total = 0
        self.truncated = False

    def full(self) -> bool:
        return self.total >= self.max

    def add(self, chunk: MeshChunk):
        n = chunk.n_triangles
        take = min(n, self.max - self.total)
        if take < n:
            self.truncated = True
        if take > 0:
            self.verts.append(chunk.vertices[:take].cpu().numpy())
            self.cols.append(chunk.colors[:take].cpu().numpy())
            self.total += take

    def result(self, what: str) -> Tuple[np.ndarray, np.ndarray]:
        if self.truncated:
            warnings.warn(f"{what}: triangle budget max_triangles="
                          f"{self.max} reached; output truncated")
        if not self.verts:
            z = np.zeros((0, 3, 3), np.float32)
            return z, z.copy()
        return np.concatenate(self.verts), np.concatenate(self.cols)


# allocated blocks per extraction window of extract_mesh
_WINDOW_BLOCKS = 8192


def extract_mesh(state: MapState, cfg: MapConfig, mesh_cfg: MeshConfig
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-map extraction over windows of 8,192 allocated blocks.
    Returns host arrays (triangles f32[T,3,3], colors f32[T,3,3]), at most
    ``mesh_cfg.max_triangles`` (a warning says so when cut)."""
    active_idx, n_active = blockmap.compactify_all(state, cfg)
    n_active = int(n_active)
    budget = _Budget(mesh_cfg.max_triangles)
    bpc = min(_WINDOW_BLOCKS, active_idx.shape[0])
    ar = torch.arange(bpc, device=active_idx.device)
    for start in range(0, max(n_active, 1), bpc):
        # fixed-size window, clamped at the tail; the overlap is masked
        s0 = min(start, active_idx.shape[0] - bpc)
        mask = ((ar + s0) < n_active) & ((ar + s0) >= start)
        budget.add(extract_block_range(state, active_idx[s0:s0 + bpc], mask,
                                       cfg, mesh_cfg))
        if budget.full():
            if s0 + bpc < n_active:
                budget.truncated = True
            break
    return budget.result("extract_mesh")


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


def extract_mesh_streamed(state: MapState, cfg: MapConfig,
                          mesh_cfg: MeshConfig, manager
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-scene extraction over the device map and the host store of
    ``manager``, leaving residency as it is: for each occupied chunk, its
    blocks and those of its 26 neighbour chunks (device rows and host
    rows) go into a scratch map, so every boundary cube sees its +1-voxel
    neighbours as in the whole map, and only the chunk's own blocks emit.
    Equals :func:`extract_mesh` of the same map unstreamed, up to triangle
    order."""
    if hasattr(manager, "flush"):
        manager.flush()
    store = manager.store
    dev = state.block_key.device
    bpc = streaming.blocks_per_chunk(cfg, manager.scfg)

    dkeys, dsdf, dweight, dcolor = streaming.resident_rows(state, cfg)
    dev_rows: dict = {}
    for i, cc in enumerate(map(tuple, streaming.chunks_of_keys_np(
            dkeys, cfg.world_blocks, bpc).tolist())):
        dev_rows.setdefault(cc, []).append(i)

    host_cc = {tuple(c) for c in store.chunk_coords().tolist()}
    all_cc = sorted(host_cc | set(dev_rows.keys()))
    budget = _Budget(mesh_cfg.max_triangles)
    if not all_cc:
        return budget.result("extract_mesh_streamed")

    offsets = np.array([(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1)
                        for z in (-1, 0, 1)], np.int32)

    def neigh(cc):
        return np.asarray(cc, np.int32)[None, :] + offsets

    def dev_sel(ncc):
        return sum((dev_rows.get(tuple(c), []) for c in ncc.tolist()), [])

    def neigh_rows(cc):
        ncc = neigh(cc)
        hk, hs, hw, hc = store.peek_chunks(ncc)
        sel = np.asarray(dev_sel(ncc), np.int64)
        return (np.concatenate([hk, dkeys[sel]]),
                np.concatenate([hs, dsdf[sel]]),
                np.concatenate([hw, dweight[sel]]),
                np.concatenate([hc, dcolor[sel]]))

    # one scratch capacity for every chunk: the largest neighbourhood
    max_neigh = max(store.peek_count(neigh(cc)) + len(dev_sel(neigh(cc)))
                    for cc in all_cc)
    cap_n = max(_next_pow2(max_neigh), 256)
    # full probe budget and a roomy table: the same keys retry against the
    # same residents, so a short probe chain would starve deterministically
    smap = dataclasses.replace(cfg, num_blocks=cap_n,
                               table_size=_next_pow2(8 * cap_n),
                               max_active_blocks=cap_n,
                               insert_probes=cfg.max_probes)
    ar = np.arange(cap_n)
    for cc in all_cc:
        if budget.full():
            budget.truncated = True
            break
        rows = neigh_rows(cc)
        keys = rows[0]
        if len(keys) == 0:
            continue
        scratch = blockmap.create(smap, dev)
        left = rows
        for _attempt in range(6):
            padded = streaming._pad_rows(cap_n, *left)
            scratch, _, placed = streaming.insert_blocks(
                scratch, *(streaming._upload(a, dev) for a in padded), smap)
            pl = placed[:len(left[0])].cpu().numpy()
            if pl.all():
                break
            left = tuple(a[~pl] for a in left)
        else:
            raise RuntimeError(
                f"extract_mesh_streamed: scratch insert failed for "
                f"{len(left[0])} of {len(keys)} blocks")
        # only chunk cc's own blocks emit (each block extracted once)
        own = np.all(streaming.chunks_of_keys_np(keys, cfg.world_blocks, bpc)
                     == np.asarray(cc, np.int32)[None, :], axis=1)
        tgt = keys[own]
        if len(tgt) == 0:
            continue
        idx, found = blockmap.lookup(scratch, streaming._upload(np.pad(
            tgt, (0, cap_n - len(tgt)), constant_values=INVALID_KEY), dev),
            smap)
        mask = streaming._upload(ar < len(tgt), dev) & found
        budget.add(extract_block_range(scratch, idx, mask, smap, mesh_cfg))
    return budget.result("extract_mesh_streamed")


def merge_vertices(triangles: np.ndarray, colors: Optional[np.ndarray],
                   weld_eps: float):
    """Weld vertices on their exact quantized position ``round(p/eps)``
    (the plain version of the native weld). Returns (vertices [V,3],
    faces int32[F,3] without degenerate faces, vertex colors [V,3] or
    None)."""
    flat = np.asarray(triangles, np.float32).reshape(-1, 3)
    q = np.round(flat / np.float32(weld_eps)).astype(np.int64)
    _, first, inv = np.unique(q, axis=0, return_index=True,
                              return_inverse=True)
    verts = flat[first]
    faces = inv.reshape(-1, 3).astype(np.int32)
    vcols = None
    if colors is not None:
        vcols = np.asarray(colors, np.float32).reshape(-1, 3)[first]
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts, faces[ok], vcols


def save_ply(path: str, triangles: np.ndarray,
             colors: Optional[np.ndarray] = None,
             weld_eps: float = 1e-5, native: bool = True) -> int:
    """Weld and write a binary little-endian PLY; returns the face count.
    ``native``: the C++ writer (``native.weld_save_ply``; raises if it
    cannot be built), else the numpy writer over :func:`merge_vertices`."""
    if native:
        from .native import weld_save_ply
        return weld_save_ply(path, triangles, colors, weld_eps)
    verts, faces, vcols = merge_vertices(triangles, colors, weld_eps)
    hdr = ["ply", "format binary_little_endian 1.0",
           f"element vertex {len(verts)}",
           "property float x", "property float y", "property float z"]
    if vcols is not None:
        hdr += ["property uchar red", "property uchar green",
                "property uchar blue"]
    hdr += [f"element face {len(faces)}",
            "property list uchar int vertex_indices", "end_header"]
    rec = np.zeros(len(verts), dtype=[("p", "<f4", 3)] + (
        [("c", np.uint8, 3)] if vcols is not None else []))
    rec["p"] = verts
    if vcols is not None:
        rec["c"] = np.clip(vcols * 255.0, 0, 255).astype(np.uint8)
    frec = np.zeros(len(faces), dtype=[("n", np.uint8), ("idx", "<i4", 3)])
    frec["n"] = 3
    frec["idx"] = faces
    with open(path, "wb") as f:
        f.write(("\n".join(hdr) + "\n").encode())
        f.write(rec.tobytes())
        f.write(frec.tobytes())
    return len(faces)
