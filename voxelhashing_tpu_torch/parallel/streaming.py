"""Out-of-core streaming for the sharded engine (port of
``voxelhashing_tpu.parallel.streaming`` on ``torch.distributed``).

Each rank sweeps and evicts only the blocks it owns, as the single-device
``streaming.StreamingManager`` does; rank 0 holds the one global chunk
store (the native store) and files every rank's evictions in rank order.
Stream-in pops on rank 0, routes each block to its owner by the partition
hash (:func:`_owner_np`, the host twin of ``sharded.owner``) and scatters
the rows; whatever a rank's allocator could not place goes back to the
store, so a streamed-in payload is never dropped. The eviction bitmask is
rebuilt on rank 0 and broadcast as the port's int32 words.

Every method is collective: every rank of the group calls it, in the same
order, and every host decision is on a value rank 0 broadcast.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import MapConfig, StreamingConfig, resolve_device
from .. import blockmap, streaming
from ..streaming import (bitmask_from_ids, bitmask_words, blocks_per_chunk,
                         extract_blocks, insert_blocks, make_chunk_store,
                         select_stream_out)
from . import collectives
from .sharded import ShardedState, local_map_config


def _owner_np(keys: np.ndarray, n_dev: int) -> np.ndarray:
    """Host twin of the device partition hash (``blockmap._mix`` % D)."""
    x = keys.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x7FEB352D)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(0x846CA68B)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    return (x % np.uint32(n_dev)).astype(np.int64)


class ShardedStreamingManager:
    """Per-shard stream-out and stream-in over the ranks of ``group``; the
    map lives on ``device`` (the card unless the caller asks for the CPU),
    the store on rank 0."""

    def __init__(self, cfg: MapConfig, scfg: StreamingConfig, group=None,
                 out_cap: int = 1024, device="cuda"):
        self.cfg = cfg
        self.scfg = scfg
        self.group = group
        self.rank, self.n_dev = collectives.world(group)
        self.lcfg = local_map_config(cfg, self.n_dev)
        self.out_cap = out_cap
        self.device = resolve_device(device)
        self._bpc = blocks_per_chunk(cfg, scfg)
        self.store = (make_chunk_store(self._bpc, cfg.world_blocks)
                      if self.rank == 0 else None)
        self._part = 0
        self._n_words = bitmask_words(scfg)
        self.bitmask = torch.zeros((self._n_words,), dtype=torch.int32,
                                   device=self.device)

    def _bcast(self, value=None) -> int:
        return collectives.broadcast_int(value, 0, self.group, self.device)

    def _rebuild_bitmask(self):
        """Bitmask = the chunks the store holds, built on rank 0 and
        broadcast."""
        words = (bitmask_from_ids(self.store.chunk_ids(self.scfg.grid_dim),
                                  self._n_words, self.device)
                 if self.rank == 0 else self.bitmask)
        self.bitmask = collectives.broadcast(words, 0, self.group)

    # -- halves ------------------------------------------------------------

    def stream_out(self, smap, cam_pos) -> Tuple[object, int]:
        """One fractional sweep on every rank (each over its own shard);
        rank 0 files all evictions. Returns (this rank's map, the blocks
        evicted on all ranks)."""
        cam = torch.as_tensor(np.asarray(cam_pos, np.float32).reshape(3),
                              device=self.device)
        out_idx, keys, count = select_stream_out(
            smap, cam, self._part, self.lcfg, self.scfg, self.out_cap)
        self._part = (self._part + 1) % self.scfg.out_parts
        n = int(count)
        sdf, w, c = extract_blocks(smap, out_idx[:n])
        mask = torch.arange(self.out_cap, device=self.device) < count
        smap = blockmap.delete_blocks(smap, out_idx, mask, self.lcfg)
        got = collectives.gather_rows(
            [keys[:n], sdf.to(torch.float32), w.to(torch.float32), c],
            self.group)
        total = 0
        if self.rank == 0:
            for k, s, ww, cc in got:          # rank order
                if k.shape[0]:
                    self.store.file_blocks(*streaming._host_rows(k, s, ww,
                                                                 cc))
                    total += int(k.shape[0])
        total = self._bcast(total)
        if total:
            self._rebuild_bitmask()
        return smap, total

    def stream_in(self, smap, cam_pos, radius=None,
                  max_chunks=None) -> Tuple[object, int]:
        """Rank 0 pops up to ``in_chunks_per_frame`` (``max_chunks``)
        chunks inside the sphere; each block goes to its owner rank, which
        inserts it. Returns (this rank's map, the blocks placed on all
        ranks)."""
        cap = self.out_cap
        keys = None
        if self.rank == 0:
            keys, sdf, w, c = self.store.pop_in_sphere(
                np.asarray(cam_pos, np.float32),
                self.scfg.radius if radius is None else radius,
                self.scfg.chunk_size,
                self.scfg.in_chunks_per_frame if max_chunks is None
                else max_chunks, cap=cap)
        n = self._bcast(None if keys is None else len(keys))
        if n == 0:
            return smap, 0
        parts = None
        if self.rank == 0:
            owner = _owner_np(keys, self.n_dev)
            spill = np.zeros(n, bool)      # per-rank overflow -> re-file
            sels, parts = [], ([], [], [], [])
            for d in range(self.n_dev):
                sel = np.flatnonzero(owner == d)
                if len(sel) > cap:
                    spill[sel[cap:]] = True
                    sel = sel[:cap]
                sels.append(sel)
                for out, a in zip(parts, streaming._pad_rows(
                        cap, keys[sel], sdf[sel], w[sel], c[sel])):
                    out.append(streaming._upload(a, self.device))
        like = (torch.empty((cap,), dtype=torch.int32),
                torch.empty((cap, 512), dtype=torch.float32),
                torch.empty((cap, 512), dtype=torch.float32),
                torch.empty((cap, 512), dtype=torch.int32))
        mine = [collectives.scatter_rows(
                    None if parts is None else parts[i],
                    like[i].to(self.device), self.group)
                for i in range(4)]
        smap, _, placed = insert_blocks(smap, *mine, self.lcfg)
        got = collectives.gather_rows([placed.to(torch.uint8)], self.group)
        n_in = 0
        if self.rank == 0:
            # never drop a streamed-in payload: re-file per-rank overflow
            # and every insert the allocator failed to place
            refile = spill.copy()
            for d, sel in enumerate(sels):
                ok = got[d][0].cpu().numpy().astype(bool)
                refile[sel[~ok[:len(sel)]]] = True
            if refile.any():
                self.store.file_blocks(keys[refile], sdf[refile], w[refile],
                                       c[refile])
            n_in = n - int(refile.sum())
        self._rebuild_bitmask()
        return smap, self._bcast(n_in)

    def step(self, state: ShardedState, cam_pos) -> ShardedState:
        """One streaming epoch (out, then in) on this rank's state."""
        m, _ = self.stream_out(state.map, cam_pos)
        m, _ = self.stream_in(m, cam_pos)
        return state._replace(map=m)

    def stream_out_all(self, smap):
        """Evict every shard fully (one sweep of every part)."""
        far = np.full((3,), 1e12, np.float32)
        for _ in range(self.scfg.out_parts):
            smap, _ = self.stream_out(smap, far)
        return smap

    def stream_in_all(self, smap):
        """Bring every stored block back to its owner rank (the inverse of
        :meth:`stream_out_all`); the shards must hold the whole map."""
        origin = np.zeros((3,), np.float32)
        stall = 0
        while True:
            before = self.host_block_count()
            if before == 0:
                break
            smap, _ = self.stream_in(smap, origin, radius=1e15,
                                     max_chunks=1 << 30)
            stall = stall + 1 if self.host_block_count() >= before else 0
            if stall >= 3:
                raise RuntimeError(
                    f"stream_in_all: the shards cannot hold the map "
                    f"({before} blocks still hosted)")
        self._rebuild_bitmask()
        return smap

    def host_block_count(self) -> int:
        """The blocks in the store (rank 0's count, on every rank)."""
        return self._bcast(self.store.block_count() if self.rank == 0
                           else None)

    def alloc_mask_keys(self, keys):
        """Allocation candidates with the keys of evicted chunks dropped."""
        return streaming.mask_keys(keys, self.bitmask, self.cfg, self.scfg)
