"""Sparse TSDF voxel-block map of the reference: a frozen copy of the
plain versions of ``voxelhashing_tpu_torch.blockmap`` (the open-addressing
hash over a pool of 8^3-voxel blocks, bf16 sdf and weight, packed int32
color), with no kernel and no multi-device path. The pool arrays are
updated IN PLACE, as in the program.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .config import MapConfig, SDF_BLOCK_SIZE, VOXELS_PER_BLOCK
from . import geometry as geom
from .geometry import INVALID_KEY

TOMBSTONE = 0x7FFFFFFE
POOL_DTYPE = torch.bfloat16
_M32 = 0xFFFFFFFF
_INT32_MAX = 0x7FFFFFFF


class MapState(NamedTuple):
    """Device-resident sparse TSDF map; fields as in the JAX ``MapState``."""

    table_key: torch.Tensor   # int32[H] key at slot (INVALID_KEY/TOMBSTONE)
    table_val: torch.Tensor   # int32[H] pool index at slot
    block_key: torch.Tensor   # int32[N] key per pool slot (INVALID_KEY=free)
    sdf: torch.Tensor         # bf16[N,512]
    weight: torch.Tensor      # bf16[N,512] (0 = empty voxel)
    color: torch.Tensor       # int32[N,512] packed 0x00RRGGBB
    surf: torch.Tensor        # bool[N] block holds a surface-band voxel
    free_stack: torch.Tensor  # int32[N] free_stack[0:n_free] = free slots
    n_free: torch.Tensor      # int32[]
    n_tombstones: torch.Tensor  # int32[]
    dense_upto: torch.Tensor  # int32[] every allocated row is < dense_upto


# ---------------------------------------------------------------------------
# Drop-mode scatter helpers
# ---------------------------------------------------------------------------


def put(dst, idx, src, keep):
    """``dst`` with ``dst[idx[k]] = src[k]`` for every ``k`` where ``keep``;
    other entries are dropped (JAX ``.at[].set(mode="drop")``).

    Returns a new tensor: the scatter lands in a buffer one element longer
    whose last slot takes the dropped entries and is sliced off.
    """
    n = dst.shape[0]
    buf = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    # a Python scalar is made on the device: assigned as it is, it would be
    # copied up from the host, which waits for the stream
    src = (src.to(dst.dtype) if isinstance(src, torch.Tensor)
           else torch.full((), src, dtype=dst.dtype, device=dst.device))
    buf[torch.where(keep, idx, n).long()] = src
    return buf[:n]


def scatter_min(size: int, fill: int, idx, src, keep):
    """int32[size] initialised to ``fill`` with ``min`` scattered in at
    ``idx`` where ``keep`` (JAX ``.at[].min(mode="drop")``)."""
    buf = torch.full((size + 1,), fill, dtype=torch.int32, device=src.device)
    buf.scatter_reduce_(0, torch.where(keep, idx, size).long(),
                        src.to(torch.int32), "amin", include_self=True)
    return buf[:size]


def zero_rows_(state: MapState, idx, keep) -> None:
    """Zero the pool rows ``idx[keep]`` of sdf/weight/color IN PLACE
    (one host sync; for pool-wide masks, where :func:`clear_rows_` would
    write one row per entry)."""
    rows = idx[keep].long()
    state.sdf[rows] = 0
    state.weight[rows] = 0
    state.color[rows] = 0


def set_rows_(dst, idx, rows, keep) -> None:
    """``dst[idx[k]] = rows[k]`` IN PLACE for every ``k`` where ``keep``,
    with no host sync. The dropped entries are pointed at a kept entry's
    row with that entry's value (or, when none is kept, at row 0 with its
    own value), so every write to a row carries one value. Kept indices
    must be unique."""
    # a kept entry, or 0; a 1-element index (a 0-d one would be read on
    # the host)
    j = torch.argmax(keep.to(torch.uint8)).reshape(1)
    any_keep = keep[j]
    donor_idx = torch.where(any_keep, idx[j], 0)
    donor_row = torch.where(
        any_keep.reshape((1,) + (1,) * (rows.ndim - 1)), rows[j], dst[:1])
    idx = torch.where(keep, idx, donor_idx)
    rows = torch.where(keep.reshape((-1,) + (1,) * (rows.ndim - 1)),
                       rows, donor_row)
    dst[idx.long()] = rows


def clear_rows_(state: MapState, idx, keep) -> None:
    """Zero the pool rows ``idx[keep]`` of sdf/weight/color IN PLACE, with
    no host sync and no per-entry row temporary: every entry writes one
    broadcast row, zero when any entry is kept (the dropped ones then hit a
    kept row), else row 0's own values back onto row 0. Kept indices must
    be unique."""
    j = torch.argmax(keep.to(torch.uint8)).reshape(1)
    any_keep = keep[j]
    tgt = torch.where(keep, idx, torch.where(any_keep, idx[j], 0)).long()
    for pool in (state.sdf, state.weight, state.color):
        pool[tgt] = torch.where(any_keep[:, None], pool.new_zeros(()),
                                pool[:1])


def _isum(mask):
    return torch.sum(mask, dtype=torch.int32)


def _rank(mask):
    """Exclusive prefix rank of the True entries (int32)."""
    return torch.cumsum(mask, 0, dtype=torch.int32) - 1


def _arange(n: int, device):
    return torch.arange(n, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Colors
# ---------------------------------------------------------------------------


def pack_rgb(rgb):
    """f32 [...,3] in 0..255 -> packed int32 0x00RRGGBB."""
    c = torch.clamp(rgb, 0, 255).to(torch.int32)
    return (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


def unpack_rgb(packed):
    """packed int32 [...] -> f32 [...,3] in 0..255."""
    return torch.stack([((packed >> 16) & 0xFF).to(torch.float32),
                        ((packed >> 8) & 0xFF).to(torch.float32),
                        (packed & 0xFF).to(torch.float32)], dim=-1)


def create(cfg: MapConfig, device="cuda") -> MapState:
    """Fresh empty map on ``device`` (the card unless the caller asks for
    the CPU)."""
    device = torch.device(device)
    h, n = cfg.table_size, cfg.num_blocks

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return MapState(
        table_key=torch.full((h,), INVALID_KEY, dtype=torch.int32,
                             device=device),
        table_val=torch.zeros((h,), dtype=torch.int32, device=device),
        block_key=torch.full((n,), INVALID_KEY, dtype=torch.int32,
                             device=device),
        sdf=torch.zeros((n, VOXELS_PER_BLOCK), dtype=POOL_DTYPE,
                        device=device),
        weight=torch.zeros((n, VOXELS_PER_BLOCK), dtype=POOL_DTYPE,
                           device=device),
        color=torch.zeros((n, VOXELS_PER_BLOCK), dtype=torch.int32,
                          device=device),
        surf=torch.zeros((n,), dtype=torch.bool, device=device),
        # reversed so pops hand out slots 0, 1, 2, ...
        free_stack=torch.arange(n - 1, -1, -1, dtype=torch.int32,
                                device=device),
        n_free=scalar(n),
        n_tombstones=scalar(0),
        dense_upto=scalar(0),
    )


# ---------------------------------------------------------------------------
# Hashing / probing (bit-exact with the JAX uint32 hash, computed in int64)
# ---------------------------------------------------------------------------


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32): the multiplier is split
    into 16-bit halves so no product passes 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix(x):
    """32-bit integer finaliser (murmur3-style avalanche); int64 in/out."""
    x = x.to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _hashes(key):
    """The two hashes (int64) of double hashing."""
    k = key.to(torch.int64) & _M32
    return _mix(k), _mix(k ^ 0x9E3779B9) | 1


def _slot(hashes, r: int, table_size: int):
    h1, h2 = hashes
    return (h1 + _mul32(h2, r)) & (table_size - 1)


def _probe_slot(key, r: int, table_size: int):
    """Slot (int64) for probe round r: double hashing, power-of-two table."""
    return _slot(_hashes(key), r, table_size)


def lookup(state: MapState, keys, cfg: MapConfig):
    """Batch key lookup -> (pool_idx int32, found bool); not found -> 0."""
    shape = keys.shape
    k = keys.to(torch.int32).reshape(-1)
    found = torch.zeros(k.shape, dtype=torch.bool, device=k.device)
    dead = k == INVALID_KEY
    idx = torch.zeros(k.shape, dtype=torch.int32, device=k.device)
    hashes = _hashes(k)      # once for every round
    for r in range(cfg.max_probes):
        slots = _slot(hashes, r, cfg.table_size)
        tk = state.table_key[slots]
        hit = (tk == k) & ~dead
        idx = torch.where(hit, state.table_val[slots], idx)
        found |= hit
        dead |= hit | (tk == INVALID_KEY)
    return idx.reshape(shape), found.reshape(shape)


def gather_voxels_soa(state: MapState, vx, vy, vz, cfg: MapConfig,
                      with_color: bool = True):
    """Integer voxel coordinate components (equal shapes) -> (sdf f32,
    weight f32, packed color int32 | None) of the same shape; voxels of
    unallocated blocks read 0.
"""
    bs = SDF_BLOCK_SIZE
    half = cfg.world_blocks // 2
    wb = cfg.world_blocks
    gx = torch.div(vx, bs, rounding_mode="floor") + half
    gy = torch.div(vy, bs, rounding_mode="floor") + half
    gz = torch.div(vz, bs, rounding_mode="floor") + half
    in_range = ((gx >= 0) & (gx < wb) & (gy >= 0) & (gy < wb)
                & (gz >= 0) & (gz < wb))
    key = torch.where(in_range, (gz * wb + gy) * wb + gx, INVALID_KEY)
    pool_idx, found = lookup(state, key, cfg)
    local = (torch.remainder(vz, bs) * bs + torch.remainder(vy, bs)) * bs \
        + torch.remainder(vx, bs)
    lin = (pool_idx.to(torch.int64) * VOXELS_PER_BLOCK + local)
    sdf = torch.where(found, state.sdf.reshape(-1)[lin].to(torch.float32),
                      0.0)
    w = torch.where(found, state.weight.reshape(-1)[lin].to(torch.float32),
                    0.0)
    c = (torch.where(found, state.color.reshape(-1)[lin], 0) if with_color
         else None)
    return sdf, w, c


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------


def allocate(state: MapState, candidate_keys, cfg: MapConfig,
                   rounds: int = 2) -> Tuple[MapState, torch.Tensor]:
    """Allocate pool blocks for candidate keys not yet in the map.

    Per round: resident pre-drop (two found-only probes), compaction to the
    stage list, staging dedup by scatter-min of instance ids, then the
    contended insert. Returns (new_state, n_allocated int32[]).
    """
    keys0 = candidate_keys.to(torch.int32).reshape(-1)
    dev = keys0.device
    h = cfg.table_size
    scap = min(cfg.alloc_stage_cap, keys0.shape[0])
    inst = _arange(scap, dev)

    total = torch.zeros((), dtype=torch.int32, device=dev)
    for ri in range(rounds):
        found = torch.zeros(keys0.shape, dtype=torch.bool, device=dev)
        term = keys0 == INVALID_KEY
        for r in range(min(2, cfg.max_probes)):
            slots = _probe_slot(keys0, r, h)
            tk = state.table_key[slots]
            hit = (tk == keys0) & ~term
            found |= hit
            term |= hit | (tk == INVALID_KEY)
        live = (keys0 != INVALID_KEY) & ~found

        rank = _rank(live)
        keep = live & (rank < scap)
        lkeys = put(torch.full((scap,), INVALID_KEY, dtype=torch.int32,
                               device=dev), rank, keys0, keep)

        valid = lkeys != INVALID_KEY
        slot0 = _probe_slot(lkeys, ri, h)
        stage = scatter_min(h, _INT32_MAX, slot0, inst, valid)
        rep = valid & (stage[torch.where(valid, slot0, 0)] == inst)
        keys = torch.where(rep, lkeys, INVALID_KEY)

        state, n = _allocate_unique(state, keys, cfg)
        total = total + n
    return state, total




def _allocate_unique(state: MapState, keys, cfg: MapConfig
                     ) -> Tuple[MapState, torch.Tensor]:
    """Insert unique candidate keys and claim pool slots (core of
    :func:`allocate`): drop keys already resident (full tombstone-aware
    chain), then run the probe-insert at the full insert-cap width."""
    dev = keys.device
    h = cfg.table_size
    k = keys.shape[0]
    inst = _arange(k, dev)

    table_key0 = state.table_key
    found = torch.zeros(keys.shape, dtype=torch.bool, device=dev)
    dead = keys == INVALID_KEY
    for r in range(min(2, cfg.max_probes)):
        slots = _probe_slot(keys, r, h)
        tk = table_key0[slots]
        hit = (tk == keys) & ~dead
        found |= hit
        dead |= hit | (tk == INVALID_KEY)
    live = ~dead
    rcap = min(2048, k)
    lrank = _rank(live)
    lkeep = live & (lrank < rcap)
    lkeys = put(torch.full((rcap,), INVALID_KEY, dtype=torch.int32,
                           device=dev), lrank, keys, lkeep)
    lpos = put(torch.full((rcap,), k, dtype=torch.int32, device=dev),
               lrank, inst, lkeep)
    lfound = torch.zeros(lkeys.shape, dtype=torch.bool, device=dev)
    ldead = lkeys == INVALID_KEY
    for r in range(2, cfg.max_probes):
        slots = _probe_slot(lkeys, r, h)
        tk = table_key0[slots]
        hit = (tk == lkeys) & ~ldead
        lfound |= hit
        ldead |= hit | (tk == INVALID_KEY)
    found = put(found, lpos, True, lfound)
    overflow = live & ~lkeep
    resident = found | overflow
    keys = torch.where(resident, INVALID_KEY, keys)
    return _insert_new(state, keys, cfg, min(cfg.alloc_insert_cap, k))


def _insert_new(state: MapState, keys, cfg: MapConfig, icap: int
                ) -> Tuple[MapState, torch.Tensor]:
    """Compact the new keys to an ``icap``-wide list and run the contended
    probe-insert loop; pool slots pop off the free stack by prefix rank."""
    dev = keys.device
    h = cfg.table_size
    n_pool = cfg.num_blocks
    k = keys.shape[0]
    if icap < k:
        is_new = keys != INVALID_KEY
        nrank = _rank(is_new)
        nkeep = is_new & (nrank < icap)
        keys = put(torch.full((icap,), INVALID_KEY, dtype=torch.int32,
                              device=dev), nrank, keys, nkeep)
        k = icap
    inst = _arange(k, dev)

    n_free = state.n_free
    free_stack = state.free_stack
    table_key, table_val = state.table_key, state.table_val
    block_key = state.block_key
    pending = keys != INVALID_KEY
    alloc_base = torch.zeros((), dtype=torch.int32, device=dev)
    max_pslot = torch.full((), -1, dtype=torch.int32, device=dev)

    for r in range(min(cfg.insert_probes, cfg.max_probes)):
        slots = _probe_slot(keys, r, h)
        tk = table_key[slots]
        pending &= ~(pending & (tk == keys))
        empty = (tk == INVALID_KEY) | (tk == TOMBSTONE)
        contend = pending & empty
        claim = scatter_min(h, _INT32_MAX, slots, inst, contend)
        win = contend & (claim[slots] == inst)
        rank = _rank(win) + alloc_base
        can = win & (rank < n_free)
        pslot = free_stack[torch.clamp(n_free - 1 - rank, 0,
                                       n_pool - 1).long()]
        table_key = put(table_key, slots, keys, can)
        table_val = put(table_val, slots, pslot, can)
        block_key = put(block_key, pslot, keys, can)
        alloc_base = alloc_base + _isum(can)
        max_pslot = torch.maximum(
            max_pslot, torch.max(torch.where(can, pslot, -1)))
        pending &= ~win

    return state._replace(table_key=table_key, table_val=table_val,
                          block_key=block_key,
                          n_free=n_free - alloc_base,
                          dense_upto=torch.maximum(state.dense_upto,
                                                   max_pslot + 1)), alloc_base


def _table_insert(table_key, table_val, keys, vals, pending, cfg: MapConfig):
    """Deterministic contended insertion of unique keys (lowest key wins a
    contended slot)."""
    h = cfg.table_size
    inserted = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    for r in range(cfg.max_probes):
        slots = _probe_slot(keys, r, h)
        tk = table_key[slots]
        empty = (tk == INVALID_KEY) | (tk == TOMBSTONE)
        contend = pending & empty
        claim = scatter_min(h, INVALID_KEY, slots, keys, contend)
        win = contend & (claim[slots] == keys)
        table_key = put(table_key, slots, keys, win)
        table_val = put(table_val, slots, vals, win)
        inserted |= win
        pending = pending & ~win
    return table_key, table_val, inserted


# ---------------------------------------------------------------------------
# Compactify (active in-frustum block list)
# ---------------------------------------------------------------------------


def compactify(state: MapState, view_matrix, cam, cfg: MapConfig):
    """Dense list of allocated, in-frustum pool indices at a static cap.

    Returns (active_idx int32[M] (padded with 0), n_active int32[],
    overflow int32[]). Always scans the whole pool (the JAX half-pool tier
    gives the same list).
    """
    m = cfg.max_active_blocks
    keys = state.block_key
    dev = keys.device
    allocated = keys != INVALID_KEY
    blocks = geom.unpack_block_key(keys, cfg.world_blocks)
    in_view = geom.block_in_frustum(blocks, view_matrix, cam, cfg.voxel_size)
    active = allocated & in_view
    rank = _rank(active)
    n_total = _isum(active)
    keep = active & (rank < m)
    active_idx = put(torch.zeros((m,), dtype=torch.int32, device=dev), rank,
                     _arange(keys.shape[0], dev), keep)
    n_active = torch.minimum(n_total, torch.full_like(n_total, m))
    return active_idx, n_active, n_total - n_active


# ---------------------------------------------------------------------------
# Deletion and maintenance
# ---------------------------------------------------------------------------


def delete_blocks(state: MapState, pool_indices, delete_mask,
                        cfg: MapConfig) -> MapState:
    """Free the given pool slots: zero their voxels (in place), clear the
    pool key, tombstone the table slot and push the slot on the free stack.

    Callers pass duplicate-free index lists. An all-false mask is a no-op.
    """
    pool_indices = pool_indices.to(torch.int32)
    keys = state.block_key[pool_indices.long()]
    delete_mask = delete_mask & (keys != INVALID_KEY)
    h = cfg.table_size

    table_key = state.table_key
    done = ~delete_mask
    for r in range(cfg.max_probes):
        slots = _probe_slot(keys, r, h)
        hit = (table_key[slots] == keys) & ~done
        table_key = put(table_key, slots, TOMBSTONE, hit)
        done |= hit
    n_deleted = _isum(delete_mask)

    free_stack = put(state.free_stack, state.n_free + _rank(delete_mask),
                     pool_indices, delete_mask)
    block_key = put(state.block_key, pool_indices, INVALID_KEY, delete_mask)
    clear_rows_(state, pool_indices, delete_mask)
    surf = put(state.surf, pool_indices, False, delete_mask)
    return state._replace(table_key=table_key, block_key=block_key,
                          surf=surf, free_stack=free_stack,
                          n_free=state.n_free + n_deleted,
                          n_tombstones=state.n_tombstones + n_deleted)




def compact_pool(state: MapState, cfg: MapConfig) -> MapState:
    """Permute the allocated rows to the pool prefix [0, n), rebuild the
    table, and reset the free stack (restores ``dense_upto``)."""
    dev = state.block_key.device
    n_pool = cfg.num_blocks
    allocated = state.block_key != INVALID_KEY
    n = _isum(allocated)
    ar = _arange(n_pool, dev)
    src = put(torch.zeros((n_pool,), dtype=torch.int32, device=dev),
              _rank(allocated), ar, allocated).long()
    live = ar < n
    keys = torch.where(live, state.block_key[src], INVALID_KEY)
    zero = torch.zeros((), dtype=POOL_DTYPE, device=dev)
    sdf = torch.where(live[:, None], state.sdf[src], zero)
    weight = torch.where(live[:, None], state.weight[src], zero)
    color = torch.where(live[:, None], state.color[src], 0)
    surf = live & state.surf[src]

    table_key = torch.full((cfg.table_size,), INVALID_KEY, dtype=torch.int32,
                           device=dev)
    table_val = torch.zeros((cfg.table_size,), dtype=torch.int32, device=dev)
    table_key, table_val, inserted = _table_insert(
        table_key, table_val, keys, ar, keys != INVALID_KEY, cfg)
    lost = (keys != INVALID_KEY) & ~inserted
    keys = put(keys, ar, INVALID_KEY, lost)
    out = state._replace(sdf=sdf, weight=weight, color=color)
    zero_rows_(out, ar, lost)
    surf = put(surf, ar, False, lost)
    n_free0 = n_pool - n
    free_stack = put(torch.arange(n_pool - 1, -1, -1, dtype=torch.int32,
                                  device=dev),
                     n_free0 + _rank(lost), ar, lost)
    return out._replace(table_key=table_key, table_val=table_val,
                        block_key=keys, surf=surf, free_stack=free_stack,
                        n_free=n_free0 + _isum(lost),
                        n_tombstones=torch.zeros_like(state.n_tombstones),
                        dense_upto=n)


def maintain_flags(state: MapState, cfg: MapConfig) -> torch.Tensor:
    """bool[2] on the device: [tombstones past 1/8 of the table, the row
    watermark past the allocated count by 1/16 of the pool] (no host
    read)."""
    n_alloc = cfg.num_blocks - state.n_free
    return torch.stack([state.n_tombstones > cfg.table_size // 8,
                        state.dense_upto - n_alloc > cfg.num_blocks // 16])


def need_maintain(flags, cfg: MapConfig, frame_idx: int) -> bool:
    """The host decision on :func:`maintain_flags` (one read of both): the
    tombstone flag on every frame, the watermark flag on the frames that
    are multiples of ``maintain_interval`` (``frame_idx`` is the host frame
    counter)."""
    tombstones, watermark = flags.tolist()
    return bool(tombstones
                or (watermark and frame_idx % cfg.maintain_interval == 0))


# ---------------------------------------------------------------------------
# Introspection (debugHash analog)
# ---------------------------------------------------------------------------


