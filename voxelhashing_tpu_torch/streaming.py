"""Out-of-core streaming: device <-> host voxel-block tiering, and
checkpoints (PyTorch port of ``voxelhashing_tpu.streaming``).

* The world is a coarse uniform **chunk grid**; the host chunk store
  (``native.NativeChunkStore``, or its plain version :class:`PyChunkStore`)
  holds the keys and voxel rows of blocks evicted from the device.
* **Active sphere**: blocks outside a sphere around the camera stream out,
  1/``out_parts`` of the pool per frame; chunks wholly inside it stream back
  in, at most ``in_chunks_per_frame`` per frame.
* **Eviction bitmask**: one bit per chunk of a ``grid_dim``^3 grid, held on
  the device as int32 words (torch on the CPU lacks ``>>`` on uint32; the
  bits are those of the JAX uint32 words, see ``convert.bitmask_*``). The
  engine drops allocation candidates of chunks whose bit is set, so evicted
  space is never re-allocated while its blocks are on the host.

The device halves (select, extract, delete, insert, bitmask updates) are
plain tensor functions on the state's device. :class:`StreamingManager`
runs the host halves in line; :class:`AsyncStreamingManager` queues the
device halves (on the card as replays of captured CUDA graphs around the
kernels of ``ops/stream.py``, writing the map in place) and queues the host
halves as jobs that run on the calling thread once their device work has
completed: behind the next graphed step's front graph (``engine``'s
``GraphStep`` given the manager's bitmask runs them while the card is
busy), else at the manager's next call.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import (MapConfig, StreamingConfig, VOXELS_PER_BLOCK,
                     resolve_device)
from . import blockmap, geometry as geom
from .blockmap import MapState, POOL_DTYPE
from .geometry import INVALID_KEY

CHECKPOINT_VERSION = 1


# ---------------------------------------------------------------------------
# Chunk coordinates
# ---------------------------------------------------------------------------


def blocks_per_chunk(cfg: MapConfig, scfg: StreamingConfig) -> int:
    return max(1, round(scfg.chunk_size / cfg.block_size_world))


def block_to_chunk(block, cfg: MapConfig, scfg: StreamingConfig):
    """Block coords [...,3] -> chunk coords [...,3] (floor division)."""
    return torch.div(block, blocks_per_chunk(cfg, scfg),
                     rounding_mode="floor")


def chunk_linear(chunk, scfg: StreamingConfig):
    """Chunk coords -> linear index into the bitmask grid (clamped)."""
    g = scfg.grid_dim
    c = torch.clamp(chunk + g // 2, 0, g - 1)
    return (c[..., 2] * g + c[..., 1]) * g + c[..., 0]


def key_to_chunk_linear(keys, cfg: MapConfig, scfg: StreamingConfig):
    """Block keys -> bitmask grid index; INVALID_KEY -> 0."""
    invalid = keys == INVALID_KEY
    blocks = geom.unpack_block_key(torch.where(invalid, 0, keys),
                                   cfg.world_blocks)
    lin = chunk_linear(block_to_chunk(blocks, cfg, scfg), scfg)
    return torch.where(invalid, 0, lin)


def chunks_of_keys_np(keys: np.ndarray, world_blocks: int,
                      bpc: int) -> np.ndarray:
    """Block keys [n] -> chunk coords [n,3] int32 (host twin of
    :func:`block_to_chunk` over unpacked keys)."""
    half = world_blocks // 2
    k = np.asarray(keys).astype(np.int64)
    b = np.stack([k % world_blocks - half,
                  (k // world_blocks) % world_blocks - half,
                  k // (world_blocks * world_blocks) - half], axis=1)
    return (b // bpc).astype(np.int32)


def lin_of_chunks_np(coords: np.ndarray, grid_dim: int) -> np.ndarray:
    """Chunk coords [n,3] -> bitmask grid index [n] int32 (host twin of
    :func:`chunk_linear`)."""
    c = np.clip(np.asarray(coords).reshape(-1, 3) + grid_dim // 2, 0,
                grid_dim - 1)
    return ((c[:, 2] * grid_dim + c[:, 1]) * grid_dim
            + c[:, 0]).astype(np.int32)


def lin_of_keys_np(keys: np.ndarray, world_blocks: int, bpc: int,
                   grid_dim: int) -> np.ndarray:
    return lin_of_chunks_np(chunks_of_keys_np(keys, world_blocks, bpc),
                            grid_dim)


# ---------------------------------------------------------------------------
# Eviction bitmask (int32 words)
# ---------------------------------------------------------------------------


def bitmask_words(scfg: StreamingConfig) -> int:
    g = scfg.grid_dim
    return (g * g * g + 31) // 32


def _bit_value(pos):
    """int32 word with bit ``pos`` (0..31) set. Built in int64, where
    ``1 << 31`` does not overflow, and moved into int32 range (bit 31 is
    the sign bit) before the cast."""
    v = torch.ones_like(pos, dtype=torch.int64) << pos.to(torch.int64)
    return (v - ((v >> 31) << 32)).to(torch.int32)


def bitmask_test(bitmask, lin):
    """bool: is the bit of grid index ``lin`` set. ``>>`` on a negative
    int32 word is arithmetic, hence the ``& 1``."""
    word = bitmask[torch.div(lin, 32, rounding_mode="floor").long()]
    return ((word >> (lin % 32)) & 1) == 1


def bitmask_delta(lin, ok, n_words: int):
    """int32[n_words] with the bits of ``lin[ok]`` set. The indices where
    ``ok`` holds must be unique: a scatter-add of distinct bits is an OR."""
    word = torch.where(ok, torch.div(lin, 32, rounding_mode="floor"),
                       n_words)
    bits = torch.where(ok, _bit_value(lin % 32), 0)
    out = torch.zeros((n_words + 1,), dtype=torch.int32, device=lin.device)
    return out.scatter_add_(0, word.long(), bits)[:n_words]


def bitmask_from_ids(ids: np.ndarray, n_words: int, device="cuda"):
    """Host rebuild: the bitmask with exactly the grid indices ``ids``, on
    ``device``."""
    device = resolve_device(device)
    words = np.zeros((n_words,), np.uint32)
    ids = np.asarray(ids, np.int64)
    if len(ids):
        np.bitwise_or.at(words, ids // 32,
                         np.uint32(1) << (ids % 32).astype(np.uint32))
    return torch.from_numpy(words.view(np.int32)).to(device)


def mask_keys(keys, bitmask, cfg: MapConfig, scfg: StreamingConfig):
    """Allocation candidates with the keys of evicted chunks dropped."""
    lin = key_to_chunk_linear(keys, cfg, scfg)
    return torch.where(bitmask_test(bitmask, lin), INVALID_KEY, keys)


# ---------------------------------------------------------------------------
# Device halves
# ---------------------------------------------------------------------------


def select_stream_out(state: MapState, cam_pos, part: int, cfg: MapConfig,
                      scfg: StreamingConfig, cap: int):
    """Up to ``cap`` allocated blocks of pool part ``part`` (rows with
    ``row % out_parts == part``) whose centre is at least ``radius`` from
    ``cam_pos`` (f32[3] on the state's device). Returns (pool_idx
    int32[cap], keys int32[cap] (INVALID_KEY past the count), count
    int32[]). The JAX half-width tier is left out: the full scan gives
    the same rows."""
    keys_rows = state.block_key
    dev = keys_rows.device
    idx = torch.arange(keys_rows.shape[0], dtype=torch.int32, device=dev)
    allocated = keys_rows != INVALID_KEY
    in_part = (idx % scfg.out_parts) == part
    blocks = geom.unpack_block_key(keys_rows, cfg.world_blocks)
    centre = geom.block_to_world(blocks, cfg.voxel_size) \
        + 0.5 * cfg.block_size_world
    diff = centre - cam_pos[None, :]
    sq = diff * diff
    d = torch.sqrt(sq[:, 0] + sq[:, 1] + sq[:, 2])   # jnp.linalg.norm order
    pick = allocated & in_part & (d >= scfg.radius)

    rank = blockmap._rank(pick)
    keep = pick & (rank < cap)
    out_idx = blockmap.put(torch.zeros((cap,), dtype=torch.int32,
                                       device=dev), rank, idx, keep)
    total = blockmap._isum(pick)
    count = torch.minimum(total, torch.full_like(total, cap))
    mask = torch.arange(cap, device=dev) < count
    keys = torch.where(mask, keys_rows[out_idx.long()], INVALID_KEY)
    return out_idx, keys, count


def extract_blocks(state: MapState, pool_idx):
    """Copies of the rows ``pool_idx`` (sdf, weight, color)."""
    i = pool_idx.long()
    return state.sdf[i], state.weight[i], state.color[i]


def insert_blocks(state: MapState, keys, sdf, weight, color,
                  cfg: MapConfig) -> Tuple[MapState, torch.Tensor,
                                           torch.Tensor]:
    """Allocate the blocks ``keys`` and write their rows (sdf and weight
    in any float dtype, cast to the pool's bf16; color int32). Rows are
    written IN PLACE, with no host sync.

    Returns (state, n_inserted int32[], placed bool[k]). Allocation can
    fail (probe exhaustion, full pool); the caller must re-file every
    block not ``placed``: a streamed-in payload is never dropped.
    ``surf`` is set from the rows as ``|sdf| < voxel_size`` where
    ``weight > 0``.
    """
    rounds = max(2, -(-int(keys.shape[0]) // cfg.alloc_insert_cap) + 1)
    state, n_ins = blockmap.allocate(state, keys, cfg, rounds=rounds)
    pool_idx, found = blockmap.lookup(state, keys, cfg)
    ok = found & (keys != INVALID_KEY)
    sdf = sdf.to(POOL_DTYPE)
    weight = weight.to(POOL_DTYPE)
    surf = torch.any((weight.to(torch.float32) > 0.0)
                     & (torch.abs(sdf.to(torch.float32)) < cfg.voxel_size),
                     dim=1)
    blockmap.set_rows_(state.sdf, pool_idx, sdf, ok)
    blockmap.set_rows_(state.weight, pool_idx, weight, ok)
    blockmap.set_rows_(state.color, pool_idx, color.to(torch.int32), ok)
    return state._replace(surf=blockmap.put(state.surf, pool_idx, surf,
                                            ok)), n_ins, ok


# ---------------------------------------------------------------------------
# Host chunk store
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HostChunk:
    keys: np.ndarray     # [k] int32
    sdf: np.ndarray      # [k, 512] f32
    weight: np.ndarray   # [k, 512] f32
    color: np.ndarray    # [k, 512] uint32


def _no_rows():
    z = np.zeros((0, VOXELS_PER_BLOCK), np.float32)
    return (np.zeros((0,), np.int32), z, z.copy(),
            np.zeros((0, VOXELS_PER_BLOCK), np.uint32))


class PyChunkStore:
    """The chunk store in numpy: the plain version of
    ``native.NativeChunkStore``, with the same interface."""

    def __init__(self, blocks_per_chunk: int, world_blocks: int):
        self.bpc = blocks_per_chunk
        self.world_blocks = world_blocks
        self.chunks: Dict[Tuple[int, int, int], HostChunk] = {}
        self.version = 0

    def file_blocks(self, keys, sdf, weight, color):
        keys = np.asarray(keys, np.int32)
        if len(keys) == 0:
            return
        self.version += 1
        sdf = np.asarray(sdf, np.float32)
        weight = np.asarray(weight, np.float32)
        color = np.asarray(color, np.uint32)
        cc_all = chunks_of_keys_np(keys, self.world_blocks, self.bpc)
        order = np.lexsort((cc_all[:, 2], cc_all[:, 1], cc_all[:, 0]))
        cs = cc_all[order]
        change = np.any(cs[1:] != cs[:-1], axis=1)
        starts = np.concatenate([[0], np.nonzero(change)[0] + 1,
                                 [len(keys)]])
        for si, ei in zip(starts[:-1], starts[1:]):
            cc = tuple(int(v) for v in cs[si])
            sel = order[si:ei]
            ch = self.chunks.get(cc)
            if ch is None:
                self.chunks[cc] = HostChunk(
                    keys=keys[sel].copy(), sdf=sdf[sel].copy(),
                    weight=weight[sel].copy(), color=color[sel].copy())
            else:
                ch.keys = np.concatenate([ch.keys, keys[sel]])
                ch.sdf = np.concatenate([ch.sdf, sdf[sel]])
                ch.weight = np.concatenate([ch.weight, weight[sel]])
                ch.color = np.concatenate([ch.color, color[sel]])

    def block_count(self) -> int:
        return sum(len(c.keys) for c in self.chunks.values())

    def chunk_count(self) -> int:
        return len(self.chunks)

    def chunk_coords(self, cap: int = 1 << 20) -> np.ndarray:
        if not self.chunks:
            return np.zeros((0, 3), np.int32)
        return np.asarray(list(self.chunks.keys()), np.int32)[:cap]

    def _held(self, coords):
        for cc in np.asarray(coords, np.int32).reshape(-1, 3):
            ch = self.chunks.get((int(cc[0]), int(cc[1]), int(cc[2])))
            if ch is not None:
                yield ch

    def peek_count(self, coords) -> int:
        return sum(len(ch.keys) for ch in self._held(coords))

    def peek_chunks(self, coords):
        held = list(self._held(coords))
        if not held:
            return _no_rows()
        return (np.concatenate([c.keys for c in held]),
                np.vstack([c.sdf for c in held]),
                np.vstack([c.weight for c in held]),
                np.vstack([c.color for c in held]))

    def pop_in_sphere(self, cam_pos, radius, chunk_size_world, max_chunks,
                      cap):
        k, s, w, c, _ = self.pop_in_sphere_tracked(
            cam_pos, radius, chunk_size_world, max_chunks, cap)
        return k, s, w, c

    def pop_in_sphere_tracked(self, cam_pos, radius, chunk_size_world,
                              max_chunks, cap, out=None):
        """Pop up to ``max_chunks`` chunks wholly inside the sphere (at most
        ``cap`` blocks; a chunk that does not fit is split and the rest
        stays filed). Also returns the coords [m,3] of the chunks removed
        entirely (a split chunk keeps its bitmask bit). ``out``: row arrays
        of ``cap`` rows to write the rows into (the returned rows are views
        of them)."""
        rows = self._pop(cam_pos, radius, chunk_size_world, max_chunks, cap)
        if out is None:
            return rows
        n = len(rows[0])
        for dst, src in zip(out, rows[:4]):
            dst[:n] = src
        return tuple(a[:n] for a in out) + (rows[4],)

    def _pop(self, cam_pos, radius, chunk_size_world, max_chunks, cap):
        cam = np.asarray(cam_pos, np.float32)
        half_diag = (np.sqrt(3.0) / 2.0) * chunk_size_world
        taken, cleared = [], []
        popped = total = 0
        for cc in list(self.chunks.keys()):
            if popped >= max_chunks:
                break
            centre = (np.asarray(cc, np.float32) + 0.5) * chunk_size_world
            if np.linalg.norm(centre - cam) + half_diag >= radius:
                continue
            ch = self.chunks[cc]
            take = len(ch.keys)
            if total + take > cap:
                take = cap - total
                if take <= 0:
                    continue
                self.chunks[cc] = HostChunk(
                    keys=ch.keys[take:], sdf=ch.sdf[take:],
                    weight=ch.weight[take:], color=ch.color[take:])
                ch = HostChunk(keys=ch.keys[:take], sdf=ch.sdf[:take],
                               weight=ch.weight[:take], color=ch.color[:take])
            else:
                self.chunks.pop(cc)
                cleared.append(cc)
            taken.append(ch)
            total += take
            popped += 1
        self.version += bool(taken)
        ccs = np.asarray(cleared, np.int32).reshape(-1, 3)
        if not taken:
            return _no_rows() + (ccs,)
        return (np.concatenate([c.keys for c in taken]),
                np.vstack([c.sdf for c in taken]),
                np.vstack([c.weight for c in taken]),
                np.vstack([c.color for c in taken]), ccs)

    def chunk_ids(self, grid_dim: int, cap: int = 1 << 20) -> np.ndarray:
        return lin_of_chunks_np(self.chunk_coords(cap), grid_dim)


def make_chunk_store(blocks_per_chunk: int, world_blocks: int,
                     native: bool = True):
    """The native C++ store (its build raises if it cannot be built), or,
    with ``native=False``, :class:`PyChunkStore`."""
    if native:
        from .native import NativeChunkStore
        return NativeChunkStore(blocks_per_chunk, world_blocks)
    return PyChunkStore(blocks_per_chunk, world_blocks)


# ---------------------------------------------------------------------------
# Host <-> device helpers
# ---------------------------------------------------------------------------


def _upload(a: np.ndarray, device):
    """numpy -> tensor on ``device``. To a card the copy goes through
    pinned memory and does not wait for the device (the caching host
    allocator keeps the pinned block until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device is not None and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)


def _host_rows(keys, sdf, weight, color):
    """Device rows -> the store's numpy rows (f32 sdf/weight, uint32
    color)."""
    return (keys.cpu().numpy(), sdf.to(torch.float32).cpu().numpy(),
            weight.to(torch.float32).cpu().numpy(),
            color.cpu().numpy().view(np.uint32))


def _pad_rows(n_to: int, keys, sdf, weight, color):
    pad = n_to - len(keys)
    return (np.pad(keys, (0, pad), constant_values=INVALID_KEY),
            np.pad(sdf, ((0, pad), (0, 0))),
            np.pad(weight, ((0, pad), (0, 0))),
            np.pad(np.asarray(color, np.uint32).view(np.int32),
                   ((0, pad), (0, 0))))


# ---------------------------------------------------------------------------
# Managers
# ---------------------------------------------------------------------------


class StreamingManager:
    """Streaming with the host halves in line: each call returns when its
    blocks are filed or inserted.

    ``device`` is where the map lives (the card unless the caller asks for
    the CPU); the host store is the native one."""

    def __init__(self, cfg: MapConfig, scfg: StreamingConfig,
                 out_cap: int = 4096, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = scfg
        self.out_cap = out_cap
        self._bpc = blocks_per_chunk(cfg, scfg)
        self.store = make_chunk_store(self._bpc, cfg.world_blocks)
        self._part = 0
        self._n_words = bitmask_words(scfg)
        self.bitmask = torch.zeros((self._n_words,), dtype=torch.int32,
                                   device=self.device)
        # blocks filed into the host store by stream-out, blocks inserted
        # on the device by stream-in (minus those re-filed), and blocks an
        # insert could not place, filed back
        self.blocks_out = 0
        self.blocks_in = 0
        self.blocks_refiled = 0

    def _rebuild_bitmask(self):
        """Bitmask = exactly the chunks held by the host store."""
        self.bitmask = bitmask_from_ids(self.store.chunk_ids(
            self.scfg.grid_dim), self._n_words, self.device)

    def _cam(self, cam_pos):
        return _upload(np.asarray(cam_pos, np.float32).reshape(3),
                       self.device)

    @property
    def next_part(self) -> int:
        """The pool part the next stream-out sweeps (part 0 first, then the
        next part each step): a host count of the steps, which reads
        nothing from the card."""
        return self._part

    def _next_part(self) -> int:
        part = self._part
        self._part = (part + 1) % self.scfg.out_parts
        return part

    # -- per-frame halves -------------------------------------------------

    def stream_out(self, state: MapState, cam_pos) -> Tuple[MapState, int]:
        """Sweep one pool part; move its blocks outside the sphere to the
        host store."""
        out_idx, keys, count = select_stream_out(
            state, self._cam(cam_pos), self._next_part(), self.cfg,
            self.scfg, self.out_cap)
        n = int(count)
        if n == 0:
            return state, 0
        sdf, w, c = extract_blocks(state, out_idx[:n])
        self.store.file_blocks(*_host_rows(keys[:n], sdf, w, c))
        self._rebuild_bitmask()
        self.blocks_out += n
        mask = torch.arange(self.out_cap, device=self.device) < count
        return blockmap.delete_blocks(state, out_idx, mask, self.cfg), n

    def _insert_batch(self, state: MapState, keys, sdf, w, c
                      ) -> Tuple[MapState, int]:
        """Insert popped rows (padded to ``out_cap``); re-file the rows
        allocation failed to place. Returns (state, n_placed)."""
        n = len(keys)
        padded = _pad_rows(max(self.out_cap, n), keys, sdf, w, c)
        state, _, placed = insert_blocks(
            state, *(_upload(a, self.device) for a in padded), self.cfg)
        unplaced = ~placed[:n].cpu().numpy()
        n_lost = int(unplaced.sum())
        if n_lost:
            self.store.file_blocks(keys[unplaced], sdf[unplaced],
                                   w[unplaced], c[unplaced])
        self.blocks_in += n - n_lost
        self.blocks_refiled += n_lost
        return state, n - n_lost

    def stream_in(self, state: MapState, cam_pos) -> Tuple[MapState, int]:
        """Insert up to ``in_chunks_per_frame`` host chunks wholly inside
        the sphere."""
        keys, sdf, w, c = self.store.pop_in_sphere(
            np.asarray(cam_pos, np.float32), self.scfg.radius,
            self.scfg.chunk_size, self.scfg.in_chunks_per_frame,
            cap=self.out_cap)
        if len(keys) == 0:
            return state, 0
        state, n_in = self._insert_batch(state, keys, sdf, w, c)
        self._rebuild_bitmask()
        return state, n_in

    def step(self, state: MapState, cam_pos) -> MapState:
        """One streaming step: out, then in. ``cam_pos``: the camera
        position as host floats [3]."""
        state, _ = self.stream_out(state, cam_pos)
        state, _ = self.stream_in(state, cam_pos)
        return state

    def stream_out_all(self, state: MapState) -> MapState:
        """Evict the whole map (one sweep of every part)."""
        far = np.full((3,), 1e12, np.float32)
        for _ in range(self.scfg.out_parts):
            state, _ = self.stream_out(state, far)
        return state

    def stream_in_all(self, state: MapState) -> MapState:
        """Bring every host block back on the device; the pool must hold
        the whole map (``meshing.extract_mesh_streamed`` and
        ``save_map(manager=...)`` compose the tiers without this)."""
        stall = 0
        while self.store.block_count() > 0:
            before = self.store.block_count()
            keys, sdf, w, c = self.store.pop_in_sphere(
                np.zeros((3,), np.float32), 1e15, self.scfg.chunk_size,
                1 << 30, cap=self.out_cap)
            if len(keys):
                state, _ = self._insert_batch(state, keys, sdf, w, c)
            stall = stall + 1 if self.store.block_count() >= before else 0
            if stall >= 3:
                raise RuntimeError(
                    f"stream_in_all: device pool cannot hold the whole map "
                    f"({self.store.block_count()} blocks still hosted)")
        self._rebuild_bitmask()
        return state

    def host_block_count(self) -> int:
        return self.store.block_count()

    def alloc_mask_keys(self, keys, cfg: Optional[MapConfig] = None):
        """Allocation candidates with the keys of evicted chunks dropped."""
        return mask_keys(keys, self.bitmask, cfg or self.cfg, self.scfg)


class _NoSpans:
    """A manager's span calls when it has no tracer: nothing."""

    def open(self, name: str) -> None:
        pass

    def close(self) -> None:
        pass


_NO_SPANS = _NoSpans()


class _OutSlot:
    """One slot of the stream-out's ring: the sweep's list (pool rows,
    mask and count on the map's device) and the keys and rows it lists,
    in the pool's dtypes (on the card in mapped host memory, which the
    kernels write and the host job reads in place); the camera the sweep
    reads; the captured graph that writes them, the event recorded after
    it, and the host job that reads them (the slot is written again only
    after that job has run). ``job_args``: the count (a 0-d int32 tensor on
    the host), the keys, the sdf and weight (bfloat16 bits as uint16) and
    the color, as numpy arrays."""

    def __init__(self, cap: int, device, cuda: bool):
        i32 = dict(dtype=torch.int32, device=device)
        self.idx = torch.zeros((cap,), **i32)
        self.mask = torch.zeros((cap,), dtype=torch.bool, device=device)
        self.count = torch.zeros((), **i32)
        rows = (cap, VOXELS_PER_BLOCK)
        self.host = []
        if cuda:
            from .ops import stream as stream_ops
            buf = stream_ops.HostBuffer
            self.host = [buf(4), buf(1, np.int32), buf(cap, np.int32),
                         buf(rows, np.uint16), buf(rows, np.uint16),
                         buf(rows, np.int32)]
            self.cam, self.count_host, self.keys, self.sdf, self.weight, \
                self.color = self.host
            self.cam_np = self.cam.array
            self.event = torch.cuda.Event()
            self.job_args = (torch.from_numpy(self.count_host.array)
                             .reshape(()),) + tuple(
                b.array for b in self.host[2:])
        else:
            self.keys = torch.full((cap,), INVALID_KEY, **i32)
            self.sdf = torch.zeros(rows, dtype=POOL_DTYPE, device=device)
            self.weight = torch.zeros(rows, dtype=POOL_DTYPE, device=device)
            self.color = torch.zeros(rows, **i32)
            self.cam_np = np.zeros((4,), np.float32)
            self.event = None
            self.job_args = (self.count, self.keys.numpy(),
                             _bits16(self.sdf), _bits16(self.weight),
                             self.color.numpy())
        self.graph = None
        self.job = None

    def free(self) -> None:
        for b in self.host:
            b.free()
        self.host = []


def _bits16(t) -> np.ndarray:
    """The bits of a bfloat16 CPU tensor as a uint16 numpy view."""
    return t.view(torch.int16).numpy().view(np.uint16)


def _widen(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits (uint16) -> float32 values (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


class _InSlot:
    """A stream-in's staging: the popped rows in host memory (pinned on the
    card; the store writes into them), their device copies at the cap's
    shapes (the host arrays themselves on the CPU), ``placed`` and its
    host copy (pinned on the card), the captured insert and the host job
    that re-files what the insert did not place."""

    def __init__(self, cap: int, device, cuda: bool):
        rows = (cap, VOXELS_PER_BLOCK)
        host = [torch.zeros((cap,), dtype=torch.int32),
                torch.zeros(rows, dtype=torch.float32),
                torch.zeros(rows, dtype=torch.float32),
                torch.zeros(rows, dtype=torch.int32)]
        if cuda:
            host = [t.pin_memory() for t in host]
        self.host = host
        self.rows = [t.numpy() for t in host[:3]] \
            + [host[3].numpy().view(np.uint32)]
        self.dev = [t.to(device) for t in host] if cuda else host
        self.placed = torch.zeros((cap,), dtype=torch.bool, device=device)
        self.placed_host = torch.zeros((cap,), dtype=torch.bool,
                                       pin_memory=cuda) if cuda \
            else self.placed
        self.graph = None
        self.job = None


_MANAGERS = weakref.WeakSet()        # the live AsyncStreamingManagers


def host_work(bitmask):
    """The queued host work of the :class:`AsyncStreamingManager` whose
    bitmask is ``bitmask``, as a callable for a graphed step to run while
    its graphs are queued on the card (``engine.GraphStep``); None for any
    other tensor."""
    for mgr in list(_MANAGERS):
        if mgr.bitmask is bitmask:
            return mgr.run_ready
    return None


class AsyncStreamingManager(StreamingManager):
    """Streaming whose device halves are queued and whose host halves run
    as jobs once their device work has completed.

    * :meth:`step` queues the stream-out and the insert on the current
      stream and returns without reading anything from the device. On the
      card each is a replay of a captured CUDA graph once the map it is
      given holds the same tensors as at the step before (see below): the
      host writes the camera (12 bytes) where the sweep reads it, replays,
      records an event and queues the host job behind it.
      The stream-out (``ops/stream.py``): the sweep of the part a counter
      on the card holds (``select_stream_out``'s rows in its order; the
      counter advances a step), the copy of the first ``count`` rows into a
      ring slot in the pool's dtypes (on the card in mapped host memory,
      with the keys and the count), ``hash_delete_kernel<false>``, the
      evicted chunks' bits set in the bitmask in place. On the CPU the same
      halves run eagerly in plain torch.
    * Handed the same map tensors as at its step before (as a step that
      owns them, ``engine.make_step``, hands its own), the manager writes
      the map in place: the fields the delete and the insert replace are
      copied back into the given map's tensors, the given ``MapState`` is
      returned, and the step adopts nothing. Handed another map, it runs
      eagerly and returns the map with those fields replaced by new
      tensors, as the in-line manager does, leaving the given ones as
      they were.
    * The host jobs run in the order they were queued, on the calling
      thread: a stream-out's reads the slot's count and files that many
      rows from it, widening sdf and weight to f32; a stream-in's re-files
      the rows the insert failed to place (their flags copied to the host
      on a side stream that waits only on the insert). A graphed step given
      the manager's bitmask runs the jobs whose device work has completed
      while its own graphs are queued (:meth:`run_ready`, :func:`host_work`);
      the next :meth:`step` runs the rest before its pop, so that the store
      it pops from holds every block filed before. A ring slot (``RING`` of
      them) is written again only after its job has run.
    * The stream-in pops into persistent staging (pinned on the card),
      uploads only the popped rows, pads the keys on the device and
      inserts at the cap's shapes.
    * The bitmask is one tensor, updated in place: evicted keys set their
      chunk bits in the sweep; popped and re-filed chunks clear and set
      theirs from short id lists (``stream_bits_kernel`` on the card).

    Blocks evicted at frame N can be popped from frame N+1 on; their bits
    are set at frame N, in queue order, so the allocator never re-allocates
    their space.

    ``defer_host``: keep the host jobs until :meth:`flush` or until their
    ring slot is needed (the queued device work alone is then what a frame
    costs). ``trace``: None (off), or a ``diagnostics.StreamTracer`` that
    times the halves' host spans and the jobs and counts their blocks.
    """

    RING = 3                 # stream-out slots
    IN_SLOTS = 2             # stream-in staging sets

    def __init__(self, cfg: MapConfig, scfg: StreamingConfig,
                 out_cap: int = 4096, device="cuda",
                 defer_host: bool = False):
        super().__init__(cfg, scfg, out_cap, device)
        self._defer_host = defer_host
        self._jobs = collections.deque()     # (event, fn, args), in order
        self._set_ids = []           # chunk ids re-filed since the last half
        self._nb32 = self._n_words * 32
        self._cuda = self.device.type == "cuda"
        self.trace = None
        self.replays = 0             # graph replays of the device halves
        self._out = [_OutSlot(out_cap, self.device, self._cuda)
                     for _ in range(self.RING)]
        self._in = [_InSlot(out_cap, self.device, self._cuda)
                    for _ in range(self.IN_SLOTS)]
        self._out_turn = self._in_turn = 0
        self._iota = torch.arange(out_cap, device=self.device)
        self._map_key = None         # the map's tensors at the last step
        # the chunks the store holds, as of its version _held_at, and their
        # centres (None: to be made): the pop is called only when one of
        # them may lie wholly inside the sphere
        self._held, self._held_at = set(), self.store.version
        self._centres = None
        self._no_pop = tuple(a[:0] for a in self._in[0].rows) + (
            np.zeros((0, 3), np.int32),)
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(self.device)
            self._part_dev = torch.zeros((), dtype=torch.int32,
                                         device=self.device)
            self._capture_stream = None
            self._graph_pool = None
        _MANAGERS.add(self)

    def close(self):
        """Run the queued host jobs and free the graphs and the host memory
        the card reads."""
        try:
            self.flush()
        finally:
            _MANAGERS.discard(self)
            self._drop_graphs()
            for slot in self._out:
                slot.free()

    def _rebuild_bitmask(self):
        """Bitmask = exactly the chunks held by the host store, written
        into the manager's one bitmask tensor."""
        self.bitmask.copy_(bitmask_from_ids(self.store.chunk_ids(
            self.scfg.grid_dim), self._n_words, self.device))

    # -- the host jobs ------------------------------------------------------

    def _queue(self, holder, ev, fn, *args) -> None:
        """Queue ``fn(*args)`` to run once ``ev`` has passed; ``holder``'s
        buffers are not written again before it has run."""
        job = (ev, fn, args)
        holder.job = job
        self._jobs.append(job)

    def _run_jobs(self, wait: bool = True, upto=None) -> None:
        """Run the queued jobs in order, each once its event has passed:
        waiting for it (``wait``), else stopping at the first whose device
        work has not completed. ``upto``: stop after that job."""
        jobs = self._jobs
        while jobs:
            job = jobs[0]
            ev = job[0]
            if ev is not None and not ev.query():
                if not wait:
                    return
                ev.synchronize()
            jobs.popleft()
            job[1](*job[2])
            if job is upto:
                return

    def run_ready(self) -> None:
        """Run the queued host jobs whose device work has completed, and
        wait for none (the jobs held under ``defer_host`` stay held)."""
        if not self._defer_host:
            self._run_jobs(wait=False)

    def _release(self, holder) -> None:
        """Run the queued jobs up to the last one that reads ``holder``."""
        job, holder.job = holder.job, None
        if job is not None and any(j is job for j in self._jobs):
            self._run_jobs(upto=job)

    def _worker_file(self, ev, count, keys, sdf, w, c):
        """The host job of a ring slot's stream-out, run once ``ev`` (its
        device work) has passed: file ``count`` rows of ``keys``, ``sdf``
        and ``w`` (bfloat16 bits, widened here) and ``c``
        (``_OutSlot.job_args``)."""
        t0 = time.perf_counter()
        n = int(count)
        if n:
            self._file(keys[:n], _widen(sdf[:n]), _widen(w[:n]),
                       c[:n].view(np.uint32))
            self.blocks_out += n
        tr = self.trace
        if tr is not None:
            tr.job("stream_file", time.perf_counter() - t0, n)

    def _worker_refile(self, n, placed, keys, sdf, w, c):
        """File again the first ``n`` staged rows that ``placed`` (on the
        host) says the insert did not place; their chunks' bits are set at
        the next half."""
        t0 = time.perf_counter()
        un = ~placed[:n].numpy()
        n_un = int(un.sum())
        if n_un:
            self._file(keys[un], sdf[un], w[un], c[un])
            self.blocks_in -= n_un
            self.blocks_refiled += n_un
            self._set_ids.append(np.unique(lin_of_keys_np(
                keys[un], self.cfg.world_blocks, self._bpc,
                self.scfg.grid_dim)))
        tr = self.trace
        if tr is not None:
            tr.job("stream_refile", time.perf_counter() - t0, n_un)

    def _file(self, keys, sdf, w, c) -> None:
        """File rows into the store, noting their chunks."""
        was = self.store.version
        self.store.file_blocks(keys, sdf, w, c)
        if self._held_at == was:
            new = set(map(tuple, chunks_of_keys_np(
                keys, self.cfg.world_blocks, self._bpc).tolist()))
            if not new <= self._held:
                self._held |= new
                self._centres = None
            self._held_at = self.store.version

    def _pop(self, cam: np.ndarray, ins: _InSlot):
        """The store's pop into ``ins``'s staging, called only when a chunk
        it holds may lie wholly inside the sphere: one whose centre is
        within the radius less the half diagonal, with a millimetre to
        spare for the store's rounding (the store decides those)."""
        sc = self.scfg
        if self._held_at != self.store.version:    # changed elsewhere
            self._held = set(map(tuple, self.store.chunk_coords().tolist()))
            self._held_at, self._centres = self.store.version, None
        if self._centres is None:
            self._centres = (np.asarray(sorted(self._held), np.float32)
                             .reshape(-1, 3) + 0.5) * np.float32(
                                 sc.chunk_size)
        d = np.sqrt(np.square(self._centres - cam).sum(axis=1))
        if not (d + np.float32(0.5 * np.sqrt(3.0) * sc.chunk_size)
                < sc.radius + 1e-3).any():
            return self._no_pop
        was = self.store.version
        rows = self.store.pop_in_sphere_tracked(
            cam, sc.radius, sc.chunk_size, sc.in_chunks_per_frame,
            cap=self.out_cap, out=ins.rows)
        if self._held_at == was:
            cleared = set(map(tuple, rows[4].tolist()))
            if cleared:
                self._held -= cleared
                self._centres = None
            self._held_at = self.store.version
        return rows

    def _placed_to_host(self, ins: _InSlot, n: int):
        """Queue the copy of the insert's first ``n`` flags to the host (on
        the card on a side stream that waits only on the insert); returns
        the event after it."""
        if not self._cuda:
            return None
        cur = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_stream(cur)
            ins.placed_host[:n].copy_(ins.placed[:n], non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return done

    def _drain_set_ids(self) -> np.ndarray:
        ids, self._set_ids = self._set_ids, []
        return (np.unique(np.concatenate(ids)) if ids
                else np.zeros((0,), np.int32))

    def _apply_ids(self, set_ids, clear_ids):
        """Set, then clear, the bits of host-deduplicated grid ids, in
        place."""
        if not len(set_ids) and not len(clear_ids):
            return
        set_ids = np.setdiff1d(set_ids, clear_ids).astype(np.int32)
        clear_ids = np.asarray(clear_ids, np.int32)
        if self._cuda:
            from .ops import stream as stream_ops
            stream_ops.bits(self.bitmask, _upload(np.concatenate(
                [set_ids, clear_ids]), self.device), len(set_ids))
            return
        for ids, keep in ((set_ids, True), (clear_ids, False)):
            lin = torch.from_numpy(ids)
            delta = bitmask_delta(lin, torch.ones_like(lin, dtype=torch.bool),
                                  self._n_words)
            if keep:
                self.bitmask.bitwise_or_(delta)
            else:
                self.bitmask.bitwise_and_(~delta)

    # -- the device halves (captured on the card) ---------------------------

    def _stream_out(self, m: MapState, slot: _OutSlot, part: int
                    ) -> MapState:
        """Sweep, extract into ``slot``, set the bits, delete."""
        if self._cuda:
            from .ops import stream as stream_ops
            stream_ops.sweep(m.block_key, slot.cam, self._part_dev, self.cfg,
                             self.scfg, self._bpc, slot.idx, slot.keys,
                             slot.mask, slot.count, slot.count_host,
                             self.bitmask)
            stream_ops.extract(slot.count, slot.idx, m.sdf, m.weight,
                               m.color, slot.sdf, slot.weight, slot.color)
        else:
            idx, keys, count = select_stream_out(
                m, torch.from_numpy(slot.cam_np[:3]), part, self.cfg,
                self.scfg, self.out_cap)
            slot.idx.copy_(idx)
            slot.keys.copy_(keys)
            slot.count.copy_(count)
            slot.mask.copy_(self._iota < count)
            i = idx.long()
            torch.index_select(m.sdf, 0, i, out=slot.sdf)
            torch.index_select(m.weight, 0, i, out=slot.weight)
            torch.index_select(m.color, 0, i, out=slot.color)
            lin = key_to_chunk_linear(keys, self.cfg, self.scfg)
            lin = torch.sort(torch.where(keys == INVALID_KEY, self._nb32,
                                         lin)).values
            first = torch.ones_like(lin, dtype=torch.bool)
            first[1:] = lin[1:] != lin[:-1]
            self.bitmask.bitwise_or_(bitmask_delta(
                lin, first & (lin < self._nb32), self._n_words))
        return blockmap.delete_blocks(m, slot.idx, slot.mask, self.cfg)

    def _stream_in(self, m: MapState, ins: _InSlot) -> MapState:
        """Insert the staged rows (keys padded with INVALID_KEY) at the
        cap's shapes; ``placed`` into the slot."""
        keys, sdf, w, c = ins.dev
        new, _, placed = insert_blocks(m, keys, sdf, w, c, self.cfg)
        ins.placed.copy_(placed)
        return new

    def _run(self, holder, fn, stable: bool, state: MapState) -> MapState:
        """``fn(state)``, a half that returns the map with its replaced
        fields. Handed another map than at the step before, it runs eagerly
        and returns that map. Handed the same, it writes the fields back
        into ``state``'s tensors and returns ``state``: on the card as the
        replay of ``holder``'s graph, captured at the first such call."""
        if not stable:
            return fn(state)
        if not self._cuda:
            _write_back(state, fn(state))
            return state
        if holder.graph is None:
            holder.graph = self._capture(
                lambda: _write_back(state, fn(state)))
        holder.graph.replay()
        self.replays += 1
        return state

    def _capture(self, fn):
        from . import engine
        from .ops import _build, hash_table
        dev = self.device
        hash_table.reserve(dev, self.cfg)
        if self._capture_stream is None:
            _build.prime()
            self._capture_stream = torch.cuda.Stream(dev)
            self._graph_pool = torch.cuda.graph_pool_handle()
        self._capture_stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        g = engine.capture(fn, graph, torch.cuda.graph(
            graph, pool=self._graph_pool, stream=self._capture_stream,
            capture_error_mode="thread_local"))
        torch.cuda.current_stream(dev).wait_stream(self._capture_stream)
        return g

    def _drop_graphs(self) -> None:
        for holder in self._out + self._in:
            if holder.graph is not None:
                holder.graph.graph.reset()
                holder.graph = None

    # -- per-frame step ---------------------------------------------------

    def step(self, state: MapState, cam_pos) -> MapState:
        tr = self.trace
        sp = _NO_SPANS if tr is None else tr
        if tr is not None:
            tr.begin()
        if not self._defer_host:
            self._run_jobs()         # those no graphed step has run
        key = tuple(t.data_ptr() for t in state)
        stable = key == self._map_key
        if not stable:
            self._drop_graphs()
            self._map_key = key

        # stream-out: the camera, a replay, the host job
        sp.open("stream_cam")
        slot = self._out[self._out_turn]
        self._out_turn = (self._out_turn + 1) % self.RING
        self._release(slot)
        part = self._next_part()
        cam = np.asarray(cam_pos, np.float32).reshape(3)
        slot.cam_np[:3] = cam
        sp.close()
        sp.open("stream_out")
        state = self._run(slot, lambda m: self._stream_out(m, slot, part),
                          stable, state)
        sp.close()
        sp.open("stream_submit")
        if slot.event is not None:
            slot.event.record()
        self._queue(slot, slot.event, self._worker_file, slot.event,
                    *slot.job_args)
        sp.close()

        # stream-in: the pop into staging, the bits, the rows up, a replay
        sp.open("stream_pop")
        ins = self._in[self._in_turn]
        self._release(ins)
        k_in, s_in, w_in, c_in, cleared = self._pop(cam, ins)
        self.blocks_in += len(k_in)
        sp.close()
        sp.open("stream_in")
        if len(cleared) or self._set_ids:
            self._apply_ids(self._drain_set_ids(),
                            lin_of_chunks_np(cleared, self.scfg.grid_dim))
        n = len(k_in)
        if n:
            self._in_turn = (self._in_turn + 1) % self.IN_SLOTS
            if self._cuda:
                for dst, src in zip(ins.dev, ins.host):
                    dst[:n].copy_(src[:n], non_blocking=True)
            if n < self.out_cap:
                ins.dev[0][n:].fill_(INVALID_KEY)
            state = self._run(ins, lambda m: self._stream_in(m, ins),
                              stable, state)
            self._queue(ins, self._placed_to_host(ins, n),
                        self._worker_refile, n, ins.placed_host, k_in, s_in,
                        w_in, c_in)
        sp.close()
        if tr is not None:
            tr.end(n, self.store.block_count())
        return state

    def flush(self):
        """Run the queued host jobs, waiting for their device work (end of a
        run, before whole-map operations)."""
        self._run_jobs()
        self._apply_ids(self._drain_set_ids(), np.zeros((0,), np.int32))

    def _sync_part(self) -> None:
        """The card's part counter set to the host's count (after the in-line
        sweeps of the whole-map operations)."""
        if self._cuda:
            self._part_dev.fill_(self._part)

    def stream_out_all(self, state: MapState) -> MapState:
        self.flush()
        state = super().stream_out_all(state)
        self.flush()
        self._sync_part()
        return state

    def stream_in_all(self, state: MapState) -> MapState:
        self.flush()
        return super().stream_in_all(state)


def _write_back(m: MapState, new: MapState) -> None:
    """Copy the fields of ``new`` that are not ``m``'s own into ``m``'s
    tensors."""
    for dst, src in zip(m, new):
        if src is not dst:
            dst.copy_(src)


# ---------------------------------------------------------------------------
# Checkpoints: whole-map save / load
# ---------------------------------------------------------------------------


def resident_rows(state: MapState, cfg: MapConfig):
    """Host copies (keys int32, sdf f32, weight f32, color uint32) of every
    device-resident block, in pool order."""
    active_idx, n = blockmap.compactify_all(state, cfg)
    idx = active_idx[:int(n)].long()
    return _host_rows(state.block_key[idx], state.sdf[idx],
                      state.weight[idx], state.color[idx])


def save_map(path: str, state: MapState, cfg: MapConfig,
             poses: Optional[np.ndarray] = None, manager=None) -> int:
    """Write every allocated block (and the trajectory ``poses``) to the
    ``.npz`` checkpoint ``path``: the JAX package's format (version, voxel
    size, truncation, world extent; f32 sdf and weight, uint32 color), so
    either package loads it. With ``manager`` the device rows are composed
    with the host store's. Returns the block count written."""
    keys, sdf, weight, color = resident_rows(state, cfg)
    if manager is not None:
        if hasattr(manager, "flush"):
            manager.flush()
        hk, hs, hw, hc = manager.store.peek_chunks(
            manager.store.chunk_coords())
        if len(hk):
            dup = np.intersect1d(keys, hk)
            if len(dup):
                raise RuntimeError(
                    f"save_map: {len(dup)} blocks both device-resident and "
                    f"host-stored (streaming invariant violated)")
            keys = np.concatenate([keys, hk])
            sdf = np.concatenate([sdf, hs])
            weight = np.concatenate([weight, hw])
            color = np.concatenate([color, hc])
    np.savez_compressed(
        path, version=CHECKPOINT_VERSION,
        voxel_size=cfg.voxel_size, truncation=cfg.truncation,
        world_blocks=cfg.world_blocks,
        keys=keys, sdf=sdf, weight=weight, color=color,
        poses=poses if poses is not None else np.zeros((0, 4, 4)))
    return len(keys)


def load_map(path: str, cfg: MapConfig, manager=None, device="cuda"
             ) -> Tuple[MapState, np.ndarray]:
    """Rebuild a map on ``device`` (the card unless the caller asks for the
    CPU; the manager's device when one is given) from a checkpoint (version
    and geometry checked). Returns (state, poses).

    With ``manager`` the blocks go into its host store (the map on the
    device starts empty, the bitmask covers every loaded chunk, and the
    sphere streams them in), so a checkpoint larger than the pool loads.
    """
    z = np.load(path)
    if int(z["version"]) != CHECKPOINT_VERSION:
        raise ValueError(f"checkpoint version {z['version']} unsupported")
    if (abs(float(z["voxel_size"]) - cfg.voxel_size) > 1e-9
            or int(z["world_blocks"]) != cfg.world_blocks):
        raise ValueError("checkpoint geometry parameters mismatch")
    device = manager.device if manager is not None else resolve_device(device)
    state = blockmap.create(cfg, device)
    keys = z["keys"]
    n = len(keys)
    if manager is not None:
        if hasattr(manager, "flush"):
            manager.flush()
        if manager.store.block_count():
            raise ValueError("load_map(manager=...): host store not empty")
        if n:
            manager.store.file_blocks(keys, z["sdf"], z["weight"],
                                      z["color"])
        manager._rebuild_bitmask()
        return state, z["poses"]
    if n == 0:
        return state, z["poses"]
    if n > cfg.num_blocks:
        raise ValueError(f"checkpoint has {n} blocks > pool {cfg.num_blocks}")
    state, _, placed = insert_blocks(
        state, _upload(keys.astype(np.int32), device),
        _upload(z["sdf"], device), _upload(z["weight"], device),
        _upload(np.asarray(z["color"], np.uint32).view(np.int32), device),
        cfg)
    n_lost = n - int(placed.sum())
    if n_lost:
        raise ValueError(
            f"checkpoint load failed to place {n_lost} blocks "
            f"(pool/table too small for this checkpoint)")
    return state, z["poses"]


# ---------------------------------------------------------------------------
# The managers side by side (the tests' and chip_smoke.py's check)
# ---------------------------------------------------------------------------


def seeded_map(cfg: MapConfig, n: int, seed: int, device,
               lo=(-2.0, -1.0, 0.0), hi=(6.0, 1.0, 2.4)) -> MapState:
    """A map on ``device`` holding ``n`` distinct blocks drawn in the box
    ``lo``-``hi`` (m), with seeded rows (sdf and weight exact in the
    pool's bfloat16)."""
    rng = np.random.default_rng(seed)
    bs = cfg.block_size_world
    a = np.floor(np.asarray(lo) / bs).astype(np.int64)
    b = np.floor(np.asarray(hi) / bs).astype(np.int64)
    blocks = np.unique(rng.integers(a, b, size=(3 * n, 3)), axis=0)
    blocks = blocks[rng.permutation(len(blocks))[:n]]
    state = blockmap.create(cfg, device)
    return _fill(state, blocks, rng, cfg, device)


def _fill(state: MapState, blocks: np.ndarray, rng, cfg: MapConfig, device
          ) -> MapState:
    n = len(blocks)
    keys = geom.pack_block_key(torch.from_numpy(blocks.astype(np.int32)),
                               cfg.world_blocks).to(torch.int32)
    sdf = torch.from_numpy(rng.uniform(-1, 1, (n, VOXELS_PER_BLOCK))
                           .astype(np.float32)).to(POOL_DTYPE).float()
    w = torch.from_numpy(rng.integers(0, 8, (n, VOXELS_PER_BLOCK))
                         .astype(np.float32))
    c = torch.from_numpy(rng.integers(0, 1 << 24, (n, VOXELS_PER_BLOCK))
                         .astype(np.int32))
    state, _, _ = insert_blocks(state, keys.to(device), sdf.to(device),
                                w.to(device), c.to(device), cfg)
    return state


def _store_rows(store) -> dict:
    """Every chunk of a store and its rows, in the store's filing order."""
    return {tuple(int(v) for v in cc): store.peek_chunks(cc.reshape(1, 3))
            for cc in store.chunk_coords()}


def differences(a: MapState, b: MapState, mgr_a, mgr_b) -> list:
    """The names of what differs between two maps and their managers'
    bitmasks and stores (each chunk's rows in filing order), bit for bit
    (the managers' host work waited for)."""
    for mgr in (mgr_a, mgr_b):
        if hasattr(mgr, "flush"):
            mgr.flush()
    out = [name for name, x, y in zip(MapState._fields, a, b)
           if not torch.equal(x, y)]
    if not torch.equal(mgr_a.bitmask, mgr_b.bitmask):
        out.append("bitmask")
    ra, rb = _store_rows(mgr_a.store), _store_rows(mgr_b.store)
    if ra.keys() != rb.keys() or any(
            not all(np.array_equal(x, y) for x, y in zip(ra[k], rb[k]))
            for k in ra):
        out.append("store")
    return out


def step_owned(mgr, state: MapState, cam) -> MapState:
    """``mgr.step`` on a map whose tensors the caller keeps, as
    ``engine.make_step`` keeps its own: fields the step replaced are
    copied back into them. Returns ``state``."""
    new = mgr.step(state, cam)
    if new is not state:
        _write_back(state, new)
    return state


def held_to_inline(cfg: MapConfig, scfg: StreamingConfig, device,
                   out_cap: int = 4096, n: int = 1500, seed: int = 3,
                   step_m: float = 0.5, far: float = 6.0,
                   filler: int = 0, every: int = 1, trace=None) -> dict:
    """An :class:`AsyncStreamingManager` and the in-line
    :class:`StreamingManager` on copies of one :func:`seeded_map` (the
    async one's map kept, as ``engine.make_step`` keeps its own:
    :func:`step_owned`), stepped with the same cameras: out along x to
    ``far`` m in ``step_m`` steps and back, ``scfg.out_parts`` steps at
    each position. ``filler`` blocks
    (drawn near the far end) are added to both maps there, so that the
    pool is nearly full on the way back and stream-ins re-file what they
    cannot place. Every ``every`` steps the two are compared
    (:func:`differences`). ``trace``: a ``diagnostics.StreamTracer`` for
    the async manager. Returns the steps, the
    blocks moved (out, in, re-filed), the steps that differ with what
    differs, and the managers (the async one closed)."""
    state_a = seeded_map(cfg, n, seed, device)
    state_b = MapState(*(t.clone() for t in state_a))
    mgr_a = AsyncStreamingManager(cfg, scfg, out_cap, device)
    mgr_b = StreamingManager(cfg, scfg, out_cap, device)
    mgr_a.trace = trace
    path = list(np.arange(0.0, far + 1e-6, step_m)) + \
        list(np.arange(far - step_m, -1e-6, -step_m))
    rng = np.random.default_rng(seed + 1)
    differ, steps = [], 0
    try:
        for i, x in enumerate(path):
            cam = np.array([x, 0.0, 0.0], np.float32)
            if filler and i == len(path) // 2:
                bs = cfg.block_size_world
                c = np.floor(cam / bs).astype(np.int64)
                blocks = np.unique(rng.integers(c - 8, c + 8,
                                                size=(3 * filler, 3)),
                                   axis=0)[:filler]
                mgr_a.flush()
                state_a = _fill(state_a, blocks, np.random.default_rng(i),
                                cfg, device)
                state_b = _fill(state_b, blocks, np.random.default_rng(i),
                                cfg, device)
            for _ in range(scfg.out_parts):
                state_a = step_owned(mgr_a, state_a, cam)
                state_b = mgr_b.step(state_b, cam)
                steps += 1
                if steps % every == 0:
                    d = differences(state_a, state_b, mgr_a, mgr_b)
                    if d:
                        differ.append((steps, d))
        d = differences(state_a, state_b, mgr_a, mgr_b)
        if d:
            differ.append((steps, d))
    finally:
        mgr_a.close()
    return {"steps": steps, "out": mgr_a.blocks_out, "in": mgr_a.blocks_in,
            "refiled": mgr_a.blocks_refiled, "differ": differ,
            "managers": (mgr_a, mgr_b)}
