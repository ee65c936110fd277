"""Out-of-core streaming of the reference: a map split between the device
pool and a plain host chunk store, in plain torch and numpy.

The world is cut into cubic chunks of ``chunk_size`` metres
(``blocks_per_chunk`` blocks an edge, chunk coordinates counted from the
world origin by floor division). Each frame, after the map's own update,
the streaming half:

1. **out**: sweeps the pool rows of one part (``row % out_parts ==
   part``, the part advancing by one a frame) and takes, in row order, up
   to ``cap`` allocated blocks whose centre lies at least ``radius`` from
   the camera; their rows are copied, the blocks deleted from the map, the
   chunks they lie in marked in the bitmask, and the rows filed into the
   store, appended to their chunk's list;
2. **in**: takes up to ``in_chunks_per_frame`` chunks of the store that
   lie wholly inside the sphere (the chunk's centre plus its half diagonal
   short of ``radius``, in float32), each chunk's rows last-filed first
   (a chunk larger than ``cap`` rows gives its last ``cap`` and keeps the
   rest); a chunk taken whole has its bit cleared; the rows are inserted
   into the map (allocated, written, their surface flag set from the
   rows), and a row that finds no place is filed back, its chunk's bit
   set again. Which chunks inside the sphere go first is the store's
   choice (its order may change as it files): the reference takes first
   those it is told the program took (:func:`taken`) where they lie
   inside, then the rest in the store's order. A row filed in step 1
   never lies in a chunk inside the sphere, so whether it is filed before
   or after the pop changes nothing else.

The bitmask has one bit a chunk of a ``grid_dim``^3 grid centred on the
origin (coordinates clamped into it), bit ``i % 32`` of word ``i // 32``
of int32 words; the map's allocation drops candidates whose chunk's bit is
set (:func:`mask_keys`), so space whose blocks are on the host is never
allocated twice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import blockmap, geometry as geom
from .blockmap import MapState, POOL_DTYPE
from .config import MapConfig, StreamingConfig, VOXELS_PER_BLOCK
from .geometry import INVALID_KEY

Chunk = Tuple[int, int, int]


def blocks_per_chunk(mp: MapConfig, scfg: StreamingConfig) -> int:
    return max(1, round(scfg.chunk_size / mp.block_size_world))


def n_words(scfg: StreamingConfig) -> int:
    return (scfg.grid_dim ** 3 + 31) // 32


def chunks_of_keys(keys: np.ndarray, world_blocks: int,
                   bpc: int) -> np.ndarray:
    """Block keys [n] -> chunk coordinates [n,3] (int64)."""
    half = world_blocks // 2
    k = np.asarray(keys).astype(np.int64)
    b = np.stack([k % world_blocks - half,
                  (k // world_blocks) % world_blocks - half,
                  k // (world_blocks * world_blocks) - half], axis=1)
    return b // bpc


def grid_ids(chunks: np.ndarray, grid_dim: int) -> np.ndarray:
    """Chunk coordinates [n,3] -> bit indices [n] (int64), clamped into
    the grid."""
    c = np.clip(np.asarray(chunks, np.int64).reshape(-1, 3) + grid_dim // 2,
                0, grid_dim - 1)
    return (c[:, 2] * grid_dim + c[:, 1]) * grid_dim + c[:, 0]


def mask_keys(keys, bitmask, mp: MapConfig, scfg: StreamingConfig):
    """Allocation candidates with the keys of marked chunks dropped."""
    invalid = keys == INVALID_KEY
    blocks = geom.unpack_block_key(torch.where(invalid, 0, keys),
                                   mp.world_blocks)
    chunk = torch.div(blocks, blocks_per_chunk(mp, scfg),
                      rounding_mode="floor")
    g = scfg.grid_dim
    c = torch.clamp(chunk + g // 2, 0, g - 1)
    lin = (c[..., 2] * g + c[..., 1]) * g + c[..., 0]
    word = bitmask[torch.div(lin, 32, rounding_mode="floor").long()]
    marked = ((word >> (lin % 32)) & 1) == 1
    return torch.where(marked & ~invalid, INVALID_KEY, keys)


@dataclasses.dataclass
class Rows:
    """Block rows on the host: keys int32 [n], sdf and weight float32
    [n,512], color uint32 [n,512]."""

    keys: np.ndarray
    sdf: np.ndarray
    weight: np.ndarray
    color: np.ndarray

    @staticmethod
    def empty() -> "Rows":
        z = np.zeros((0, VOXELS_PER_BLOCK), np.float32)
        return Rows(np.zeros((0,), np.int32), z, z.copy(),
                    np.zeros((0, VOXELS_PER_BLOCK), np.uint32))

    def __len__(self) -> int:
        return len(self.keys)

    def take(self, sel) -> "Rows":
        return Rows(self.keys[sel], self.sdf[sel], self.weight[sel],
                    self.color[sel])

    @staticmethod
    def cat(parts: List["Rows"]) -> "Rows":
        if not parts:
            return Rows.empty()
        return Rows(*(np.concatenate([getattr(p, f) for p in parts])
                      for f in ("keys", "sdf", "weight", "color")))


@dataclasses.dataclass
class Stream:
    """The streaming state: the store (chunk -> its rows in filing order,
    the chunks in the store's order), the bitmask (int32 words on the
    map's device), the next part to sweep and the transfer cap."""

    store: Dict[Chunk, Rows]
    bitmask: torch.Tensor
    part: int
    cap: int

    @staticmethod
    def empty(scfg: StreamingConfig, cap: int, device) -> "Stream":
        return Stream({}, torch.zeros((n_words(scfg),), dtype=torch.int32,
                                      device=device), 0, cap)

    def copy(self) -> "Stream":
        # a chunk's rows are replaced, never written in place
        return Stream(dict(self.store), self.bitmask.clone(), self.part,
                      self.cap)


def _set_bits(bitmask, ids: np.ndarray, value: bool):
    """The bitmask with the bits ``ids`` set (or cleared)."""
    if len(ids) == 0:
        return bitmask
    words = bitmask.cpu().numpy().view(np.uint32).copy()
    ids = np.unique(np.asarray(ids, np.int64))
    bits = np.uint32(1) << (ids % 32).astype(np.uint32)
    if value:
        np.bitwise_or.at(words, ids // 32, bits)
    else:
        np.bitwise_and.at(words, ids // 32, ~bits)
    return torch.from_numpy(words.view(np.int32)).to(bitmask.device)


def _file(st: Stream, rows: Rows, bpc: int, mp: MapConfig) -> None:
    """Append ``rows`` to their chunks' lists (a new chunk goes last)."""
    if len(rows) == 0:
        return
    cc = chunks_of_keys(rows.keys, mp.world_blocks, bpc)
    for c in dict.fromkeys(map(tuple, cc.tolist())):
        sel = np.all(cc == np.asarray(c), axis=1)
        part = rows.take(sel)
        have = st.store.get(c)
        st.store[c] = part if have is None else Rows.cat([have, part])


def select_out(state: MapState, cam, part: int, mp: MapConfig,
               scfg: StreamingConfig, cap: int):
    """(pool rows int32 [cap], keys int32 [cap] (INVALID_KEY past the
    count), count) of the part's allocated blocks, in row order, whose
    centre lies at least ``radius`` from ``cam`` (float32 [3] on the map's
    device)."""
    keys_rows = state.block_key
    dev = keys_rows.device
    idx = torch.arange(keys_rows.shape[0], dtype=torch.int32, device=dev)
    blocks = geom.unpack_block_key(keys_rows, mp.world_blocks)
    centre = geom.block_to_world(blocks, mp.voxel_size) \
        + 0.5 * mp.block_size_world
    diff = centre - cam[None, :]
    sq = diff * diff
    d = torch.sqrt(sq[:, 0] + sq[:, 1] + sq[:, 2])
    pick = ((keys_rows != INVALID_KEY) & (idx % scfg.out_parts == part)
            & (d >= scfg.radius))
    rows = idx[pick][:cap]
    n = int(rows.shape[0])
    out = torch.zeros((cap,), dtype=torch.int32, device=dev)
    out[:n] = rows
    keys = torch.full((cap,), INVALID_KEY, dtype=torch.int32, device=dev)
    keys[:n] = keys_rows[rows.long()]
    return out, keys, n


def inside(c: Chunk, cam, scfg: StreamingConfig) -> bool:
    """Whether chunk ``c`` lies wholly inside the sphere about ``cam``:
    its centre's distance plus its half diagonal short of the radius, in
    float32."""
    cs = np.float32(scfg.chunk_size)
    m = (np.asarray(c, np.float32) + np.float32(0.5)) * cs
    dd = m - np.asarray(cam, np.float32).reshape(3)
    d = np.sqrt(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2])
    return bool(d + np.float32(0.866025404) * cs < np.float32(scfg.radius))


def taken(before: Stream, after: Stream) -> List[Chunk]:
    """The chunks of ``before``'s store that hold fewer rows in
    ``after``'s: those a streaming half took in."""
    return [c for c, rows in before.store.items()
            if len(after.store.get(c, ())) < len(rows)]


def pop_in_sphere(st: Stream, cam: np.ndarray, scfg: StreamingConfig,
                  cap: int, prefer=()) -> Tuple[Rows, List[Chunk]]:
    """Up to ``in_chunks_per_frame`` chunks wholly inside the sphere,
    those of ``prefer`` first, the rest in the store's order, taken out of
    the store (see the module); returns their rows and the chunks taken
    whole."""
    got, whole, n = [], [], 0
    order = [c for c in prefer if c in st.store]
    for c in order + [c for c in st.store if c not in order]:
        if len(got) >= scfg.in_chunks_per_frame:
            break
        if not inside(c, cam, scfg):
            continue
        rows = st.store[c]
        k = min(len(rows), cap - n)
        if k <= 0:
            continue
        got.append(rows.take(np.arange(len(rows) - 1, len(rows) - 1 - k,
                                         -1)))
        if k < len(rows):
            st.store[c] = rows.take(slice(0, len(rows) - k))
        else:
            del st.store[c]
            whole.append(c)
        n += k
    return Rows.cat(got), whole


def insert(state: MapState, rows: Rows, mp: MapConfig, cap: int):
    """Allocate the blocks of ``rows`` (keys padded to ``cap``) and write
    their rows and surface flags. Returns (map, placed bool [n] on the
    host)."""
    dev = state.sdf.device
    n = len(rows)
    pad = cap - n
    keys = torch.from_numpy(np.pad(rows.keys, (0, pad),
                                   constant_values=INVALID_KEY)).to(dev)
    sdf = torch.from_numpy(np.pad(rows.sdf, ((0, pad), (0, 0)))).to(dev)
    weight = torch.from_numpy(np.pad(rows.weight, ((0, pad), (0, 0)))).to(dev)
    color = torch.from_numpy(np.pad(rows.color.view(np.int32),
                                    ((0, pad), (0, 0)))).to(dev)
    rounds = max(2, -(-cap // mp.alloc_insert_cap) + 1)
    state, _ = blockmap.allocate(state, keys, mp, rounds=rounds)
    pool_idx, found = blockmap.lookup(state, keys, mp)
    ok = found & (keys != INVALID_KEY)
    sdf, weight = sdf.to(POOL_DTYPE), weight.to(POOL_DTYPE)
    surf = torch.any((weight.to(torch.float32) > 0.0)
                     & (torch.abs(sdf.to(torch.float32)) < mp.voxel_size),
                     dim=1)
    blockmap.set_rows_(state.sdf, pool_idx, sdf, ok)
    blockmap.set_rows_(state.weight, pool_idx, weight, ok)
    blockmap.set_rows_(state.color, pool_idx, color, ok)
    state = state._replace(surf=blockmap.put(state.surf, pool_idx, surf, ok))
    return state, ok[:n].cpu().numpy()


def half(state: MapState, st: Stream, cam, mp: MapConfig,
         scfg: StreamingConfig, prefer=()) -> Tuple[MapState, int, int]:
    """One frame's streaming half on ``state`` and ``st`` (updated) with
    the camera at ``cam`` (float32 [3] on the host): out, then in, taking
    the chunks of ``prefer`` first where they lie inside the sphere (see
    the module). Returns (map, blocks filed out, blocks brought in)."""
    dev = state.sdf.device
    bpc = blocks_per_chunk(mp, scfg)
    cam = np.asarray(cam, np.float32).reshape(3)
    part = st.part
    st.part = (part + 1) % scfg.out_parts
    out_idx, keys, n_out = select_out(state, torch.from_numpy(cam).to(dev),
                                      part, mp, scfg, st.cap)
    sel = out_idx[:n_out].long()
    filed = Rows(keys[:n_out].cpu().numpy(),
                 state.sdf[sel].to(torch.float32).cpu().numpy(),
                 state.weight[sel].to(torch.float32).cpu().numpy(),
                 state.color[sel].cpu().numpy().view(np.uint32))
    mask = torch.arange(st.cap, device=dev) < n_out
    state = blockmap.delete_blocks(state, out_idx, mask, mp)
    st.bitmask = _set_bits(st.bitmask, grid_ids(chunks_of_keys(
        filed.keys, mp.world_blocks, bpc), scfg.grid_dim), True)

    rows, whole = pop_in_sphere(st, cam, scfg, st.cap, prefer)
    st.bitmask = _set_bits(st.bitmask, grid_ids(np.asarray(
        whole, np.int64).reshape(-1, 3), scfg.grid_dim), False)
    _file(st, filed, bpc, mp)
    n_in = 0
    if len(rows):
        state, placed = insert(state, rows, mp, st.cap)
        lost = rows.take(~placed)
        _file(st, lost, bpc, mp)
        st.bitmask = _set_bits(st.bitmask, grid_ids(chunks_of_keys(
            lost.keys, mp.world_blocks, bpc), scfg.grid_dim), True)
        n_in = len(rows) - len(lost)
    return state, n_out, n_in


def marked_keys(state: MapState, bitmask, mp: MapConfig,
                scfg: StreamingConfig):
    """The keys of the map's blocks that lie in chunks ``bitmask`` marks
    (sorted)."""
    keys = state.block_key
    marked = (mask_keys(keys, bitmask, mp, scfg) == INVALID_KEY) \
        & (keys != INVALID_KEY)
    return torch.sort(keys[marked]).values


def mismatch(prog: Stream, ref: Stream, prog_map: MapState,
             ref_map: MapState, mp: MapConfig,
             scfg: StreamingConfig) -> int:
    """Rows that differ between two streaming states (a key or a voxel's
    bits at a chunk's position, or a row one side lacks), plus bitmask
    words that differ, plus the blocks in chunks ``ref``'s bitmask marks
    that one map holds and the other does not (space whose blocks are on
    the host, allocated on one side only)."""
    a = marked_keys(prog_map, ref.bitmask.to(prog_map.block_key.device),
                    mp, scfg)
    b = marked_keys(ref_map, ref.bitmask, mp, scfg).to(a.device)
    differ = int((~torch.isin(a, b)).sum()) + int((~torch.isin(b, a)).sum())
    for c in set(prog.store) | set(ref.store):
        a = prog.store.get(c, Rows.empty())
        b = ref.store.get(c, Rows.empty())
        n = min(len(a), len(b))
        row = a.keys[:n] != b.keys[:n]
        for f in ("sdf", "weight", "color"):
            x = getattr(a, f)[:n].view(np.uint32)
            y = getattr(b, f)[:n].view(np.uint32)
            row |= np.any(x != y, axis=1)
        differ += int(row.sum()) + abs(len(a) - len(b))
    differ += int((prog.bitmask != ref.bitmask.to(prog.bitmask.device))
                  .sum())
    return differ
