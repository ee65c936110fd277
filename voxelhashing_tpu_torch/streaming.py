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
device halves and runs the host halves on one worker thread.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import queue
import threading
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

    def file_blocks(self, keys, sdf, weight, color):
        keys = np.asarray(keys, np.int32)
        if len(keys) == 0:
            return
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
                              max_chunks, cap):
        """Pop up to ``max_chunks`` chunks wholly inside the sphere (at most
        ``cap`` blocks; a chunk that does not fit is split and the rest
        stays filed). Also returns the coords [m,3] of the chunks removed
        entirely (a split chunk keeps its bitmask bit)."""
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
        # blocks filed into the host store by stream-out, and blocks
        # inserted on the device by stream-in (minus those re-filed)
        self.blocks_out = 0
        self.blocks_in = 0

    def _rebuild_bitmask(self):
        """Bitmask = exactly the chunks held by the host store."""
        self.bitmask = bitmask_from_ids(self.store.chunk_ids(
            self.scfg.grid_dim), self._n_words, self.device)

    def _cam(self, cam_pos):
        return _upload(np.asarray(cam_pos, np.float32).reshape(3),
                       self.device)

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


class AsyncStreamingManager(StreamingManager):
    """Streaming whose device halves are queued and whose host halves run
    on one worker thread.

    * :meth:`step` queues select, extract, delete, the bitmask delta and
      the insert on the current stream and returns without reading
      anything from the device (the camera position and the popped rows
      go up through pinned memory without a wait).
    * The worker copies the evicted rows to the host and files them, and
      re-files rows an insert failed to place. On a card it copies on a
      side stream that waits only on an event recorded after the work it
      needs, so it never waits on work queued later; the jobs hold the
      source tensors until their copy has completed.
    * The bitmask is updated on the device: evicted keys set their chunk
      bits (a scatter-add of sorted unique bits); popped and re-filed
      chunks clear and set theirs from short uploaded id lists.

    One-frame lag: blocks evicted at frame N can be popped from frame N+1
    on, once the worker has filed them; their bits are set at frame N, in
    queue order, so the allocator never re-allocates their space.

    ``defer_host``: keep the host halves until :meth:`flush` (the queued
    device work alone is then what a frame costs).
    """

    _SETQ_PAD = 256          # ids per uploaded set/clear list

    def __init__(self, cfg: MapConfig, scfg: StreamingConfig,
                 out_cap: int = 4096, device="cuda",
                 defer_host: bool = False):
        super().__init__(cfg, scfg, out_cap, device)
        self._defer_host = defer_host
        self._deferred = []
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="streaming")
        self._store_lock = threading.Lock()
        self._setq: "queue.SimpleQueue[np.ndarray]" = queue.SimpleQueue()
        self._pending = []
        self._err: Optional[BaseException] = None
        self._nb32 = self._n_words * 32
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(self.device)

    def close(self):
        """Finish the queued host work and stop the worker thread."""
        try:
            self.flush()
        finally:
            self._pool.shutdown(wait=True)

    # -- device -> host copies on the worker -------------------------------

    def _event(self):
        """Event after the work queued so far on the current stream (None
        off the card, where that work has already run)."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _fetch(self, ev, tensors):
        """Host copies of device ``tensors`` once ``ev`` has passed; waits
        on nothing queued after it."""
        if not self._cuda:
            return [t.numpy() for t in tensors]
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(ev)
            out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                   for t in tensors]
            for o, t in zip(out, tensors):
                o.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        done.synchronize()
        return [o.numpy() for o in out]

    def _worker_file(self, ev, count, keys, sdf, w, c):
        try:
            (n,) = self._fetch(ev, [count.reshape(1)])
            n = int(n[0])
            if n == 0:
                return
            kh, sh, wh, ch = self._fetch(ev, [keys[:n], sdf[:n], w[:n],
                                              c[:n]])
            with self._store_lock:
                self.store.file_blocks(kh, sh, wh, ch.view(np.uint32))
                self.blocks_out += n
        except BaseException as e:          # raised again at step/flush
            self._err = e

    def _worker_refile(self, ev, n, placed, keys, sdf, w, c):
        try:
            (pl,) = self._fetch(ev, [placed[:n]])
            un = ~pl
            if not un.any():
                return
            with self._store_lock:
                self.store.file_blocks(keys[un], sdf[un], w[un], c[un])
                self.blocks_in -= int(un.sum())
            # the re-filed chunks set their eviction bits again
            self._setq.put(np.unique(lin_of_keys_np(
                keys[un], self.cfg.world_blocks, self._bpc,
                self.scfg.grid_dim)))
        except BaseException as e:
            self._err = e

    def _drain_set_queue(self) -> np.ndarray:
        ids = []
        while True:
            try:
                ids.append(self._setq.get_nowait())
            except queue.Empty:
                break
        return (np.unique(np.concatenate(ids)) if ids
                else np.zeros((0,), np.int32))

    def _apply_ids(self, set_ids, clear_ids):
        """Set, then clear, the bits of host-deduplicated grid ids."""
        p = self._SETQ_PAD
        for off in range(0, max(len(set_ids), len(clear_ids)), p):
            lists = []
            for ids in (set_ids[off:off + p], clear_ids[off:off + p]):
                lists.append(_upload(np.pad(ids, (0, p - len(ids)),
                                            constant_values=self._nb32)
                                     .astype(np.int32), self.device))
            (s, cl) = lists
            self.bitmask = ((self.bitmask
                             | bitmask_delta(s, s < self._nb32,
                                             self._n_words))
                            & ~bitmask_delta(cl, cl < self._nb32,
                                             self._n_words))

    def _raise_worker_error(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    # -- per-frame step ---------------------------------------------------

    def step(self, state: MapState, cam_pos) -> MapState:
        self._raise_worker_error()
        self._pending = [f for f in self._pending if not f.done()]
        cam = np.asarray(cam_pos, np.float32).reshape(3)

        # stream-out: all on the device queue, host work to the worker
        out_idx, keys, count = select_stream_out(
            state, self._cam(cam), self._next_part(), self.cfg, self.scfg,
            self.out_cap)
        sdf, w, c = extract_blocks(state, out_idx)     # copies, pre-delete
        sdf, w = sdf.to(torch.float32), w.to(torch.float32)
        ev = self._event()
        mask = torch.arange(self.out_cap, device=self.device) < count
        state = blockmap.delete_blocks(state, out_idx, mask, self.cfg)
        lin = key_to_chunk_linear(keys, self.cfg, self.scfg)
        lin = torch.sort(torch.where(keys == INVALID_KEY, self._nb32,
                                     lin)).values
        first = torch.ones_like(lin, dtype=torch.bool)
        first[1:] = lin[1:] != lin[:-1]
        self.bitmask = self.bitmask | bitmask_delta(
            lin, first & (lin < self._nb32), self._n_words)
        job = (ev, count, keys, sdf, w, c)
        if self._defer_host:
            self._deferred.append(job)
        else:
            self._pending.append(self._pool.submit(self._worker_file, *job))

        # stream-in: host pop (native, cheap) + queued device insert
        with self._store_lock:
            k_in, s_in, w_in, c_in, cleared = \
                self.store.pop_in_sphere_tracked(
                    cam, self.scfg.radius, self.scfg.chunk_size,
                    self.scfg.in_chunks_per_frame, cap=self.out_cap)
            self.blocks_in += len(k_in)
        self._apply_ids(self._drain_set_queue(),
                        lin_of_chunks_np(cleared, self.scfg.grid_dim))
        n = len(k_in)
        if n:
            padded = _pad_rows(self.out_cap, k_in, s_in, w_in, c_in)
            state, _, placed = insert_blocks(
                state, *(_upload(a, self.device) for a in padded), self.cfg)
            self._pending.append(self._pool.submit(
                self._worker_refile, self._event(), n, placed, k_in, s_in,
                w_in, c_in))
        return state

    def flush(self):
        """Run the deferred host halves and wait for the worker (end of a
        run, before whole-map operations)."""
        for job in self._deferred:
            self._worker_file(*job)
        self._deferred = []
        for f in self._pending:
            f.result()
        self._pending = []
        self._raise_worker_error()
        self._apply_ids(self._drain_set_queue(), np.zeros((0,), np.int32))

    def stream_out_all(self, state: MapState) -> MapState:
        self.flush()
        state = super().stream_out_all(state)
        self.flush()
        return state

    def stream_in_all(self, state: MapState) -> MapState:
        self.flush()
        return super().stream_in_all(state)

    def host_block_count(self) -> int:
        with self._store_lock:
            return self.store.block_count()


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
