"""The map's hash writes: the allocator's insert (``hash_alloc_kernel``,
``csrc/hash_alloc.cu``), GC's free pass (``hash_delete_kernel<true>``) and
the delete of a list, streaming's stream-outs (``hash_delete_kernel
<false>``, both in ``csrc/hash_delete.cu``).

No TPU kernel: the JAX package runs them as XLA
(``voxelhashing_tpu/blockmap.py:187`` ``allocate``, :264
``_allocate_unique``, :343 ``_insert_new``, :564 ``delete_blocks``;
``voxelhashing_tpu/integrate.py:532`` ``garbage_collect``). The plain
versions are ``blockmap.allocate_plain``, ``blockmap.delete_blocks_plain``
and ``integrate.garbage_collect_plain``, those functions op for op (the CPU
path, and the reference on the card); ``blockmap.allocate``,
``blockmap.delete_blocks`` and ``blockmap.free_culled`` (which
``integrate.garbage_collect`` calls) reach :func:`allocate`,
:func:`delete_blocks` and :func:`garbage_collect` here, which take the
map's tensors rather than a ``MapState`` (``blockmap`` imports this
module).

On CUDA tensors :func:`allocate` is one launch of ``hash_alloc_kernel`` a
round (in place of ~1,050 small torch launches a round),
:func:`delete_blocks` one launch of ``hash_delete_kernel<false>`` (in place
of ~560) and :func:`garbage_collect` one launch of ``hash_delete_kernel
<true>`` (the cull, its capped rank and the delete, in place of the ~17
launches that built GC's short list and the delete after them), all
bit-equal to their plain versions in every field of the map:
pool slots go by prefix rank, so the order is part of the map. The
functional contract of the plain versions holds: the table, pool keys,
surface flags and free stack the kernels write are clones of the
caller's (~25 MB at a 1M-block map), and the 0-d counters are new
tensors; only the delete's pool rows are zeroed in place, as in the plain
version. On CPU tensors the wrappers run the plain versions; any other
device raises. There is no fallback: a missing ``nvcc`` or a failed build
or launch raises.

The insert's claims go to a persistent int32 claim array a map and device
(INT32_MAX between launches), and each kernel's last-CTA counter, GC's
ticket, its per-CTA status and done words and its list of kept rows are
kept likewise (:func:`reserve`); all are made outside any CUDA graph
capture (``engine.make_step`` reserves them before it captures).

:func:`prepare_allocate`, :func:`prepare_delete` and :func:`prepare_gc`
check the inputs and make the outputs; :func:`launch_allocate`,
:func:`launch_delete` and :func:`launch_gc` issue the kernels on the
current stream (the only places that do; each adds one to
``allocate.launches``, ``delete_blocks.launches`` or
``garbage_collect.launches``). The least time of a call is the larger of
:func:`bytes_moved` over the memory rate and :func:`operations` over the
f32 rate, from :func:`work_counts`, :func:`delete_work_counts` or
:func:`gc_work_counts`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ..config import MapConfig
from ..geometry import INVALID_KEY

TOMBSTONE = 0x7FFFFFFE              # blockmap.TOMBSTONE
INT32_MAX = 0x7FFFFFFF
ALLOC_THREADS = 1024                # csrc/hash_alloc.cu: candidates a CTA
MAX_STAGE = 16 * ALLOC_THREADS      # csrc/hash_alloc.cu: the stage list
RESIDENT_CAP = 2048                 # blockmap._allocate_unique's deep probes
GC_ROWS = 1024                      # csrc/hash_delete.cu: active rows a CTA
GC_SPREAD = 4                       # csrc/hash_delete.cu: CTAs a CTA's rows
                                    # are zeroed on

_PERSISTENT = {}                    # (device, map sizes) -> the buffers


class Reserved(NamedTuple):
    """The hash kernels' persistent buffers on one device for one map."""

    claim: torch.Tensor     # int32 [table_size], INT32_MAX between launches
    counters: torch.Tensor  # int32 [2], the last-CTA counters, 0 between
    ticket: torch.Tensor    # int64 [1], GC's ticket and arrivals, 0 between
    status: torch.Tensor    # int64 [2, gc_ctas(cfg)], GC's status and done
                            # words, 0 between
    rows: torch.Tensor      # int32 [gc_delete_cap], GC's kept rows


def _device(t):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"hash_table: no kernel for {dev}")
    return dev


def gc_ctas(cfg: MapConfig) -> int:
    """The most CTAs of a GC launch: an active list as long as the pool or
    the active cap, ``GC_ROWS`` rows a CTA."""
    return -(-max(cfg.num_blocks, cfg.max_active_blocks) // GC_ROWS)


def reserve(device, cfg: MapConfig) -> Reserved:
    """The hash kernels' persistent buffers (:class:`Reserved`) on
    ``device`` for ``cfg``'s map, made at the first call for its sizes.
    Raises inside a CUDA graph capture when they are not made yet: a
    buffer made there would belong to the graph's pool. Two launches of a
    kernel that share them must not run at once (one stream a process)."""
    device = torch.device(device)
    key = (device, int(cfg.table_size), gc_ctas(cfg), int(cfg.gc_delete_cap))
    got = _PERSISTENT.get(key)
    if got is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "hash_table: reserve(device, cfg) before a CUDA graph "
                "capture; the kernels' buffers are not made yet")
        got = Reserved(
            torch.full((cfg.table_size,), INT32_MAX, dtype=torch.int32,
                       device=device),
            torch.zeros((2,), dtype=torch.int32, device=device),
            torch.zeros((1,), dtype=torch.int64, device=device),
            torch.zeros((2, gc_ctas(cfg)), dtype=torch.int64, device=device),
            torch.empty((max(cfg.gc_delete_cap, 1),), dtype=torch.int32,
                        device=device))
        _PERSISTENT[key] = got
    return got


def stage_counts(table_key, keys, cfg: MapConfig):
    """(live keys, staged keys, live chunks of ``ALLOC_THREADS``) of an
    insert round on ``table_key``: the valid keys not found within two
    probes, the first ``alloc_stage_cap`` of them, and the chunks the last
    CTA's loops walk."""
    from .. import blockmap
    k = keys.to(torch.int32).reshape(-1)
    found = torch.zeros(k.shape, dtype=torch.bool, device=k.device)
    term = k == INVALID_KEY
    for r in range(min(2, cfg.max_probes)):
        tk = table_key[blockmap._probe_slot(k, r, cfg.table_size)]
        hit = (tk == k) & ~term
        found |= hit
        term |= hit | (tk == INVALID_KEY)
    live = int(((k != INVALID_KEY) & ~found).sum())
    scap = min(cfg.alloc_stage_cap, k.numel())
    staged = min(live, scap)
    return live, staged, -(-staged // ALLOC_THREADS)


def _check(t, dtype, shape, what, dev):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev \
            or not t.is_contiguous():
        raise ValueError(f"hash_table: {what} must be a contiguous {dtype} "
                         f"{tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_table(table_key, cfg: MapConfig, dev):
    h = cfg.table_size
    if h < 1 or h & (h - 1):
        raise ValueError(f"hash_table: the table size must be a power of "
                         f"two, got {h}")
    _check(table_key, torch.int32, (h,), "table_key", dev)


# ---------------------------------------------------------------------------
# The insert
# ---------------------------------------------------------------------------

def prepare_allocate(table_key, table_val, block_key, free_stack, n_free,
                     dense_upto, keys, cfg: MapConfig, rounds: int = 2):
    """Check the inputs, clone the arrays the kernel writes and make the
    counters and scratch; returns (one launch's arguments a round, the
    outputs (table_key, table_val, block_key, n_free, dense_upto,
    n_allocated))."""
    dev = table_key.device
    h, n_pool = cfg.table_size, cfg.num_blocks
    _check_table(table_key, cfg, dev)
    _check(table_val, torch.int32, (h,), "table_val", dev)
    _check(block_key, torch.int32, (n_pool,), "block_key", dev)
    _check(free_stack, torch.int32, (n_pool,), "free_stack", dev)
    _check(n_free, torch.int32, (), "n_free", dev)
    _check(dense_upto, torch.int32, (), "dense_upto", dev)
    if keys.device != dev:
        raise ValueError("hash_table: keys on the table's device")
    keys = keys.to(torch.int32).reshape(-1).contiguous()
    k = keys.shape[0]
    if k == 0:
        raise ValueError("hash_table: no candidate keys (the plain version "
                         "raises on an empty list too)")
    scap = min(cfg.alloc_stage_cap, k)
    if scap > MAX_STAGE:
        raise ValueError(f"hash_table: the kernel stages at most "
                         f"{MAX_STAGE} keys a round, alloc_stage_cap is "
                         f"{cfg.alloc_stage_cap}")
    claim, counters = reserve(dev, cfg)[:2]
    n_ctas = -(-k // ALLOC_THREADS)
    seg = torch.empty((n_ctas * ALLOC_THREADS,), dtype=torch.int32,
                      device=dev)
    seg_flag = torch.empty((n_ctas * ALLOC_THREADS,), dtype=torch.uint8,
                           device=dev)
    seg_count = torch.empty((n_ctas,), dtype=torch.int32, device=dev)
    tk, tv, bk = table_key.clone(), table_val.clone(), block_key.clone()
    nf_out = torch.empty((), dtype=torch.int32, device=dev)
    du_out = torch.empty((), dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    p = _build.ptr
    args = []
    for ri in range(rounds):
        args.append((
            p(keys), k, scap, min(RESIDENT_CAP, scap),
            min(cfg.alloc_insert_cap, scap), ri, min(2, cfg.max_probes),
            cfg.max_probes, min(cfg.insert_probes, cfg.max_probes), h,
            n_pool, p(tk), p(tv), p(bk), p(free_stack), p(n_free),
            p(dense_upto), p(nf_out), p(du_out), p(total), int(ri == 0),
            p(claim), p(seg), p(seg_flag), p(seg_count),
            _build.ptr(counters[:1]),
            # kept alive while the arguments are
            (keys, seg, seg_flag, seg_count, claim, counters), dev))
    return args, (tk, tv, bk, nf_out, du_out, total)


def launch_allocate(args) -> None:
    """Launch one round on prepared arguments, on the current stream (the
    only place that does; counts the launch)."""
    *kernel_args, _keep, device = args
    _build.check(_build.library("hash_alloc").vh_hash_alloc(
        *kernel_args, _build.stream_ptr(device)), "hash_alloc")
    allocate.launches += 1


def allocate(table_key, table_val, block_key, free_stack, n_free,
             dense_upto, keys, cfg: MapConfig, rounds: int = 2):
    """``rounds`` rounds of the allocator's insert of ``keys`` (see
    ``blockmap.allocate_plain``): the kernel on CUDA tensors, the plain
    version on CPU tensors. Returns (table_key, table_val, block_key,
    n_free, dense_upto, n_allocated int32[])."""
    if _device(table_key).type == "cpu":
        from .. import blockmap
        st, n = blockmap.allocate_plain(blockmap.MapState(
            table_key, table_val, block_key, None, None, None, None,
            free_stack, n_free, None, dense_upto), keys, cfg, rounds)
        return (st.table_key, st.table_val, st.block_key, st.n_free,
                st.dense_upto, n)
    if rounds < 1:
        return (table_key, table_val, block_key, n_free, dense_upto,
                torch.zeros((), dtype=torch.int32, device=table_key.device))
    args, out = prepare_allocate(table_key, table_val, block_key, free_stack,
                                 n_free, dense_upto, keys, cfg, rounds)
    for a in args:
        launch_allocate(a)
    return out


allocate.launches = 0


# ---------------------------------------------------------------------------
# The delete
# ---------------------------------------------------------------------------

def _check_pool(t, dtype, n_pool, what, dev):
    _check(t, dtype, (n_pool, 512), what, dev)
    if t.data_ptr() % 16:
        raise ValueError(f"hash_table: {what} must be 16-byte aligned")


def prepare_delete(table_key, block_key, surf, free_stack, n_free,
                   n_tombstones, sdf, weight, color, pool_indices,
                   delete_mask, cfg: MapConfig):
    """Check the inputs, clone the arrays the kernel writes (not the pool
    rows, zeroed in place) and make the counters; returns (the launch
    arguments, the outputs (table_key, block_key, surf, free_stack, n_free,
    n_tombstones))."""
    dev = table_key.device
    n_pool = cfg.num_blocks
    _check_table(table_key, cfg, dev)
    _check(block_key, torch.int32, (n_pool,), "block_key", dev)
    _check(surf, torch.bool, (n_pool,), "surf", dev)
    _check(free_stack, torch.int32, (n_pool,), "free_stack", dev)
    _check(n_free, torch.int32, (), "n_free", dev)
    _check(n_tombstones, torch.int32, (), "n_tombstones", dev)
    _check_pool(sdf, torch.bfloat16, n_pool, "sdf", dev)
    _check_pool(weight, torch.bfloat16, n_pool, "weight", dev)
    _check_pool(color, torch.int32, n_pool, "color", dev)
    idx = pool_indices.to(torch.int32).reshape(-1).contiguous()
    mask = delete_mask.to(torch.bool).reshape(-1).contiguous()
    if idx.device != dev or mask.device != dev \
            or idx.shape != mask.shape or idx.numel() == 0:
        raise ValueError("hash_table: pool indices and mask of one length "
                         "(not empty, as in the plain version) on the "
                         "table's device")
    counters = reserve(dev, cfg).counters
    tk, bk = table_key.clone(), block_key.clone()
    sf, fs = surf.clone(), free_stack.clone()
    nf_out = torch.empty((), dtype=torch.int32, device=dev)
    nt_out = torch.empty((), dtype=torch.int32, device=dev)
    p = _build.ptr
    args = (p(idx), p(mask), idx.shape[0], p(block_key), p(table_key),
            p(tk), p(bk), p(sf), p(fs), p(sdf), p(weight), p(color),
            p(n_free), p(n_tombstones), p(nf_out), p(nt_out), n_pool,
            cfg.table_size, cfg.max_probes, p(counters[1:]),
            (idx, mask, counters), dev)
    return args, (tk, bk, sf, fs, nf_out, nt_out)


def launch_delete(args) -> None:
    """Launch the delete on prepared arguments, on the current stream (the
    only place that does; counts the launch)."""
    *kernel_args, _keep, device = args
    _build.check(_build.library("hash_delete").vh_hash_delete(
        *kernel_args, _build.stream_ptr(device)), "hash_delete")
    delete_blocks.launches += 1


def delete_blocks(table_key, block_key, surf, free_stack, n_free,
                  n_tombstones, sdf, weight, color, pool_indices,
                  delete_mask, cfg: MapConfig):
    """Free the pool rows ``pool_indices[delete_mask]`` (see
    ``blockmap.delete_blocks_plain``; their sdf, weight and color rows are
    zeroed in place): the kernel on CUDA tensors, the plain version on CPU
    tensors. Returns (table_key, block_key, surf, free_stack, n_free,
    n_tombstones)."""
    if _device(table_key).type == "cpu":
        from .. import blockmap
        st = blockmap.delete_blocks_plain(blockmap.MapState(
            table_key, None, block_key, sdf, weight, color, surf,
            free_stack, n_free, n_tombstones, None), pool_indices,
            delete_mask, cfg)
        return (st.table_key, st.block_key, st.surf, st.free_stack,
                st.n_free, st.n_tombstones)
    args, out = prepare_delete(table_key, block_key, surf, free_stack,
                               n_free, n_tombstones, sdf, weight, color,
                               pool_indices, delete_mask, cfg)
    launch_delete(args)
    return out


delete_blocks.launches = 0


# ---------------------------------------------------------------------------
# GC's free pass
# ---------------------------------------------------------------------------

def gc_threshold(cfg: MapConfig) -> float:
    """The f32 value GC's ``min_sdf >= t`` compares with: torch compares a
    float32 tensor with a Python float in float32."""
    return float(np.float32(cfg.truncation_at(cfg.max_integration_distance)))


def prepare_gc(table_key, block_key, surf, free_stack, n_free, n_tombstones,
               sdf, weight, color, active_idx, active_mask, min_sdf, max_w,
               cfg: MapConfig):
    """Check the inputs, clone the arrays the kernel writes (not the pool
    rows, zeroed in place) and make the counters; returns (the launch
    arguments, the outputs (table_key, block_key, surf, free_stack, n_free,
    n_tombstones))."""
    dev = table_key.device
    n_pool = cfg.num_blocks
    _check_table(table_key, cfg, dev)
    _check(block_key, torch.int32, (n_pool,), "block_key", dev)
    _check(surf, torch.bool, (n_pool,), "surf", dev)
    _check(free_stack, torch.int32, (n_pool,), "free_stack", dev)
    _check(n_free, torch.int32, (), "n_free", dev)
    _check(n_tombstones, torch.int32, (), "n_tombstones", dev)
    _check_pool(sdf, torch.bfloat16, n_pool, "sdf", dev)
    _check_pool(weight, torch.bfloat16, n_pool, "weight", dev)
    _check_pool(color, torch.int32, n_pool, "color", dev)
    m = active_idx.numel()
    if m == 0:
        raise ValueError("hash_table: an empty active list (the plain "
                         "version raises on an empty short list too)")
    idx = active_idx.to(torch.int32).reshape(-1).contiguous()
    mask = active_mask.to(torch.bool).reshape(-1).contiguous()
    _check(mask, torch.bool, (m,), "active_mask", dev)
    _check(idx, torch.int32, (m,), "active_idx", dev)
    # the stats are read in place, each with its stride (kernel A's are
    # the two columns of one [M, 2] tensor)
    for t, what in ((min_sdf, "min_sdf"), (max_w, "max_w")):
        if t.dtype != torch.float32 or tuple(t.shape) != (m,) \
                or t.device != dev or t.stride(0) < 1:
            raise ValueError(f"hash_table: {what} must be a float32 ({m},) "
                             f"tensor on {dev} with a positive stride, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    dcap = min(cfg.gc_delete_cap, m)
    if dcap < 1:
        raise ValueError("hash_table: gc_delete_cap must be >= 1 (the plain "
                         "version raises on an empty short list)")
    res = reserve(dev, cfg)
    if -(-m // GC_ROWS) > res.status.shape[1]:
        raise ValueError(f"hash_table: an active list of {m} rows is longer "
                         f"than the pool and the active cap")
    tk, bk = table_key.clone(), block_key.clone()
    sf, fs = surf.clone(), free_stack.clone()
    nf_out = torch.empty((), dtype=torch.int32, device=dev)
    nt_out = torch.empty((), dtype=torch.int32, device=dev)
    p = _build.ptr
    args = (p(idx), p(mask), p(min_sdf), p(max_w), min_sdf.stride(0),
            max_w.stride(0), m, gc_threshold(cfg), dcap, p(block_key),
            p(table_key), p(tk), p(bk), p(sf), p(fs), p(sdf), p(weight),
            p(color), p(n_free), p(n_tombstones), p(nf_out), p(nt_out),
            n_pool, cfg.table_size, cfg.max_probes,
            p(res.ticket), p(res.status), res.status.shape[1],
            p(res.rows), (idx, mask, min_sdf, max_w, res), dev)
    return args, (tk, bk, sf, fs, nf_out, nt_out)


def launch_gc(args) -> None:
    """Launch GC's free pass on prepared arguments, on the current stream
    (the only place that does; counts the launch)."""
    *kernel_args, _keep, device = args
    _build.check(_build.library("hash_delete").vh_hash_gc(
        *kernel_args, _build.stream_ptr(device)), "hash_delete")
    garbage_collect.launches += 1


def garbage_collect(table_key, block_key, surf, free_stack, n_free,
                    n_tombstones, sdf, weight, color, active_idx, active_mask,
                    min_sdf, max_w, cfg: MapConfig):
    """GC's free pass over the active list (see
    ``integrate.garbage_collect_plain``): cull the active rows whose stats
    ``(min_sdf, max_w)`` reach the far truncation or are all-starved, keep
    the first ``min(gc_delete_cap, M)`` culled and free them (their sdf,
    weight and color rows zeroed in place): the kernel on CUDA tensors, the
    plain version on CPU tensors. Returns (table_key, block_key, surf,
    free_stack, n_free, n_tombstones)."""
    if _device(table_key).type == "cpu":
        from .. import blockmap, integrate
        st = integrate.garbage_collect_plain(blockmap.MapState(
            table_key, None, block_key, sdf, weight, color, surf,
            free_stack, n_free, n_tombstones, None), active_idx,
            active_mask, cfg, cached_stats=(min_sdf, max_w))
        return (st.table_key, st.block_key, st.surf, st.free_stack,
                st.n_free, st.n_tombstones)
    args, out = prepare_gc(table_key, block_key, surf, free_stack, n_free,
                           n_tombstones, sdf, weight, color, active_idx,
                           active_mask, min_sdf, max_w, cfg)
    launch_gc(args)
    return out


garbage_collect.launches = 0


# ---------------------------------------------------------------------------
# The bound
# ---------------------------------------------------------------------------

# Integer operations, hand-counted on csrc/hash.cuh: a key's two hashes
# (two finalisers of eight operations, the xor and the or: 18), a slot
# (three) and its two compares (two); an inserted key's staging and claim
# slots (six), its rank and pop (four); a freed row's mask test (two) and
# the push's rank (two); GC's cull test of an active row (two compares,
# their or and the mask's and: four) and a culled row's rank (two).
HASH_OPS = 18 + 3 + 2
INSERT_OPS = 6 + 4
ENTRY_OPS = 2
FREE_OPS = HASH_OPS + 2
CULL_OPS = 4
RANK_OPS = 2
ROW_BYTES = 512 * (2 + 2 + 4)       # a pool row's sdf, weight and color


class InsertWork(NamedTuple):
    n_keys: int          # candidates read
    n_valid: int         # valid candidates: one table slot read each
    n_inserted: int      # blocks allocated


class DeleteWork(NamedTuple):
    n_entries: int       # list entries: index, mask and pool key read
    n_freed: int         # rows freed


class GcWork(NamedTuple):
    n_rows: int          # active rows: mask and two stats read
    n_culled: int        # culled rows: index and pool key read, ranked
    n_freed: int         # rows freed (kept under the cap, allocated)


def work_counts(keys, n_allocated) -> InsertWork:
    """The work of one insert call on ``keys`` that allocated
    ``n_allocated`` blocks (an int or a 0-d tensor)."""
    k = keys.reshape(-1)
    return InsertWork(int(k.numel()), int((k != INVALID_KEY).sum()),
                      int(n_allocated))


def delete_work_counts(block_key, pool_indices, delete_mask) -> DeleteWork:
    """The work of one delete of ``pool_indices[delete_mask]`` from a map
    whose pool keys are ``block_key`` (before the delete)."""
    idx = pool_indices.reshape(-1).long()
    ok = (idx >= 0) & (idx < block_key.shape[0])
    keys = block_key[torch.where(ok, idx, 0)]
    freed = delete_mask.reshape(-1) & ok & (keys != INVALID_KEY)
    return DeleteWork(int(idx.numel()), int(freed.sum()))


def gc_work_counts(block_key, active_idx, active_mask, min_sdf, max_w,
                   cfg: MapConfig) -> GcWork:
    """The work of one GC free pass on these inputs (a map whose pool keys
    are ``block_key``, before the pass)."""
    cull = active_mask.reshape(-1) & ((min_sdf.reshape(-1) >= gc_threshold(
        cfg)) | (max_w.reshape(-1) == 0.0))
    dcap = min(cfg.gc_delete_cap, cull.numel())
    kept = cull & (torch.cumsum(cull, 0) <= dcap)
    idx = active_idx.reshape(-1).long()
    ok = (idx >= 0) & (idx < block_key.shape[0])
    keys = block_key[torch.where(ok, idx, 0)]
    freed = kept & ok & (keys != INVALID_KEY)
    return GcWork(int(cull.numel()), int(cull.sum()), int(freed.sum()))


def bytes_moved(work) -> int:
    """The least bytes a call must move. Insert: each key read once (4 B),
    one table slot read a valid key (4 B), a free-stack read and the
    table key, table value and pool key written an allocated block
    (16 B), the counters (20 B). Delete: each entry's index, mask and pool
    key (9 B); a freed row's table slot read and tombstoned, pool key,
    surface flag and free-stack push (17 B) and its rows zeroed
    (``ROW_BYTES``); the counters (16 B). GC: each active row's mask and
    two stats (9 B), a culled row's index and pool key (8 B), a freed
    row's as the delete's, the counters (16 B)."""
    if isinstance(work, InsertWork):
        return 4 * work.n_keys + 4 * work.n_valid + 16 * work.n_inserted + 20
    if isinstance(work, GcWork):
        return (9 * work.n_rows + 8 * work.n_culled
                + (17 + ROW_BYTES) * work.n_freed + 16)
    return 9 * work.n_entries + (17 + ROW_BYTES) * work.n_freed + 16


def operations(work) -> int:
    """Integer operations of a call (``HASH_OPS`` a valid key and
    ``INSERT_OPS`` an allocated block; ``ENTRY_OPS`` an entry and
    ``FREE_OPS`` a freed row; ``CULL_OPS`` an active row and
    ``RANK_OPS`` a culled one)."""
    if isinstance(work, InsertWork):
        return HASH_OPS * work.n_valid + INSERT_OPS * work.n_inserted
    if isinstance(work, GcWork):
        return (CULL_OPS * work.n_rows + RANK_OPS * work.n_culled
                + FREE_OPS * work.n_freed)
    return ENTRY_OPS * work.n_entries + FREE_OPS * work.n_freed


# ---------------------------------------------------------------------------
# An edge bank: the calls where the kernels go wrong first
# ---------------------------------------------------------------------------

def _np_mix(x):
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def probe_slots(keys, r: int, table_size: int):
    """numpy twin of ``blockmap._probe_slot`` (int64 slots)."""
    k = np.asarray(keys).astype(np.int64).astype(np.uint32)
    h1 = _np_mix(k)
    h2 = _np_mix(k ^ np.uint32(0x9E3779B9)) | np.uint32(1)
    return ((h1 + np.uint32(r) * h2) & np.uint32(table_size - 1)).astype(
        np.int64)


def _cfg(**kw):
    base = dict(num_blocks=4096, table_size=1 << 14, max_active_blocks=4096,
                alloc_stage_cap=4096, alloc_insert_cap=1024)
    base.update(kw)
    return MapConfig(**base)


SMALL = _cfg()
# ~73% of the table's slots hold a key after the loaded set-up, placed
# within eight probes, so many keys take three probes or more
LOADED = _cfg(num_blocks=16384, alloc_stage_cap=8192, alloc_insert_cap=4096,
              insert_probes=8)
TINY_POOL = _cfg(num_blocks=256)

EDGE_CASES = ("all_invalid", "empty", "resident", "repeated_8x",
              "contended", "tombstones", "over_caps", "pool_short",
              "probes_3_1", "probes_12_6", "rounds_16", "delete_free_rows",
              "delete_deep", "gc_padded_nothing", "gc_short",
              "stream_out_4096")


def _fresh_keys(rng, n, taken=()):
    """``n`` distinct valid keys (world_blocks 1024) not in ``taken``."""
    out = np.setdiff1d(rng.choice(1 << 30, 2 * n + 64, replace=False),
                       np.asarray(taken, np.int64))
    return rng.permutation(out)[:n].astype(np.int32)


def _shared_slot_keys(rng, n_groups, per, table_size):
    """``n_groups`` groups of ``per`` distinct keys, each group sharing its
    probe-0 slot (found by brute force over random keys)."""
    cand = rng.choice(1 << 30, 1 << 21, replace=False).astype(np.int32)
    slots = probe_slots(cand, 0, table_size)
    order = np.argsort(slots, kind="stable")
    s = slots[order]
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    sizes = np.diff(np.r_[starts, s.size])
    full = starts[sizes >= per][:n_groups]
    groups = np.stack([cand[order[a:a + per]] for a in full])
    return groups.reshape(-1)


def edge_bank(seed: int = 13):
    """Seeded calls with the cases the kernels get wrong first, each a dict:
    ``case``, ``setup`` (the calls that build the map from
    ``blockmap.create(setup_cfg)``: ("allocate", cfg, keys, rounds) or
    ("delete", cfg, pool rows, mask), numpy int32 / bool) and ``op`` (the
    call under test, in the same form). Tables of 2^14 slots. The set-ups:
    "small" (1,024 candidates over three rounds, ~960 allocated, at
    SMALL); "loaded" (16,000 candidates over three rounds, ~12,000
    allocated at LOADED, whose inserts probe eight slots: ~73% of the
    slots hold a key, some at probe 3 or later). The calls: all-INVALID
    and empty lists; every
    key resident; every key 8 times; groups of 8 keys sharing a probe-0
    slot (contended staging and claims, 3 rounds); new keys after deletes
    (inserts reuse tombstones); more live keys than the stage cap, than
    2,048 and than the insert cap; a pool with fewer free rows than the
    round's winners; max_probes 3 / insert_probes 1 and 12 / 6; 16
    rounds; deletes of free rows, of keys deep in their chains (a
    12,288-entry list, past the delete's 8,192-entry scan), a padded GC
    short list with nothing kept, a GC short list and a 4,096-entry
    stream-out list."""
    rng = np.random.default_rng(seed)
    inv = INVALID_KEY
    small_keys = _fresh_keys(rng, 1024)
    small_keys[::17] = inv
    small = (("allocate", SMALL, small_keys, 3),)
    loaded_keys = _fresh_keys(rng, 16000, small_keys)
    loaded = (("allocate", LOADED, loaded_keys, 3),)
    out = []

    def add(case, setup, op):
        out.append({"case": case, "setup": setup, "op": op})

    add("all_invalid", small,
        ("allocate", SMALL, np.full(1024, inv, np.int32), 1))
    add("empty", small, ("allocate", SMALL, np.zeros(0, np.int32), 1))
    add("resident", small, ("allocate", SMALL, rng.permutation(small_keys),
                            1))
    rep = np.repeat(_fresh_keys(rng, 116, small_keys), 8)
    rep = np.concatenate([rep, small_keys[:96]])
    rep[rng.random(rep.size) < 0.05] = inv
    add("repeated_8x", small, ("allocate", SMALL, rng.permutation(rep), 1))
    shared = _shared_slot_keys(rng, 128, 8, SMALL.table_size)
    add("contended", small, ("allocate", SMALL, rng.permutation(shared), 3))
    gone = rng.random(1024) < 0.5
    tomb = small + (("delete", SMALL, np.arange(1024, dtype=np.int32),
                     gone),)
    again = np.concatenate([small_keys[:600],
                            _fresh_keys(rng, 424, small_keys)])
    add("tombstones", tomb, ("allocate", SMALL, rng.permutation(again), 1))
    add("over_caps", loaded,
        ("allocate", LOADED, _fresh_keys(rng, 10000, loaded_keys), 1))
    tiny = np.full(1024, inv, np.int32)
    tiny[:200] = small_keys[:200]
    tiny[:200][small_keys[:200] == inv] = 1
    add("pool_short", (("allocate", TINY_POOL, tiny, 1),),
        ("allocate", TINY_POOL, _fresh_keys(rng, 1024, small_keys), 1))
    for case, mp, ip in (("probes_3_1", 3, 1), ("probes_12_6", 12, 6)):
        cfg = _cfg(num_blocks=16384, alloc_stage_cap=8192,
                   alloc_insert_cap=4096, max_probes=mp, insert_probes=ip)
        add(case, loaded,
            ("allocate", cfg, _fresh_keys(rng, 4096, loaded_keys), 1))
    r16 = np.concatenate([_shared_slot_keys(rng, 32, 8, SMALL.table_size),
                          small_keys[:256], _fresh_keys(rng, 512)])
    add("rounds_16", small, ("allocate", SMALL, rng.permutation(r16), 16))
    add("delete_free_rows", small,
        ("delete", SMALL, rng.permutation(2048).astype(np.int32),
         rng.random(2048) < 0.5))
    add("delete_deep", loaded,
        ("delete", LOADED, rng.permutation(12288).astype(np.int32),
         rng.random(12288) < 0.3))
    add("gc_padded_nothing", small,
        ("delete", SMALL, np.zeros(1024, np.int32), np.zeros(1024, bool)))
    short = np.zeros(1024, np.int32)
    short[:300] = np.sort(rng.choice(900, 300, replace=False))
    add("gc_short", small,
        ("delete", SMALL, short, np.arange(1024) < 300))
    add("stream_out_4096", loaded,
        ("delete", LOADED, (np.arange(4096) * 3 % 12288).astype(np.int32),
         np.arange(4096) < 3000))
    return out


def edge_state(e, device):
    """The map an edge call starts from: its set-up run by the plain
    versions on the CPU, seeded data in the allocated rows (half of them
    with no voxel in the surface band), on ``device``."""
    from .. import blockmap
    st = blockmap.create(e["setup"][0][1], "cpu")
    for kind, cfg, a, b in e["setup"]:
        if kind == "allocate":
            st, _ = blockmap.allocate_plain(st, torch.from_numpy(a), cfg,
                                            rounds=b)
        else:
            st = blockmap.delete_blocks_plain(st, torch.from_numpy(a),
                                              torch.from_numpy(b), cfg)
    rng = np.random.default_rng(len(e["case"]))
    live = (st.block_key != INVALID_KEY).numpy()
    w = rng.integers(1, 4, (live.size, 512)).astype(np.float32) \
        * live[:, None]
    far = rng.random(live.size) < 0.5
    sdf = w * np.where(far, 0.01, 0.001)[:, None].astype(np.float32)
    st = st._replace(
        weight=torch.from_numpy(w).to(torch.bfloat16),
        sdf=torch.from_numpy(sdf).to(torch.bfloat16),
        color=torch.from_numpy((w.astype(np.int32) * 0x010203)),
        surf=torch.from_numpy(live & ~far))
    return blockmap.MapState(*(t.to(device) for t in st))


# ---------------------------------------------------------------------------
# GC's bank: the free passes where the GC entry goes wrong first
# ---------------------------------------------------------------------------

GC_CASES = ("gc_nothing", "gc_exact_cap", "gc_over_cap", "gc_free_rows",
            "gc_short_list", "gc_threshold_ulps", "gc_negative_zero")


def gc_bank(seed: int = 23):
    """Seeded GC calls, each a dict: ``case``, ``setup`` (as
    :func:`edge_bank`'s), ``cfg`` and the call's ``active_idx`` (int32),
    ``active_mask`` (bool), ``min_sdf`` and ``max_w`` (f32), numpy. The
    loaded map (~12,000 rows, 16,384-row pool) with an 11,776-row active
    list (46 CTAs of the GC entry, the last 288 masked off): nothing
    culled; exactly ``gc_delete_cap`` (1,024) culled; 3,000 culled (the
    cut inside a CTA, culled stats in the masked rows too); culled rows
    whose key is already free; the f32 threshold and one ulp either side,
    NaN and infinite stats; a ``max_w`` of -0.0 (culled), +0.0 and the
    least normal float (kept). The small map with a 600-row list, shorter
    than the cap (dcap is the list's length), 450 culled."""
    rng = np.random.default_rng(seed)
    base = edge_bank()
    small = next(e for e in base if e["case"] == "gc_short")["setup"][:1]
    loaded = next(e for e in base
                  if e["case"] == "stream_out_4096")["setup"]
    out = []
    for case in GC_CASES:
        short = case == "gc_short_list"
        setup = small if short else loaded
        cfg = setup[0][1]
        cfg = MapConfig(**{**cfg.__dict__,
                           "max_active_blocks": cfg.num_blocks})
        st = edge_state({"case": case, "setup": setup}, "cpu")
        live = np.flatnonzero((st.block_key != INVALID_KEY).numpy())
        dead = np.flatnonzero((st.block_key == INVALID_KEY).numpy())
        m = 600 if short else 11776
        n_act = m if short else m - 288
        rows = rng.permutation(live)[:m]
        if case in ("gc_free_rows", "gc_short_list"):
            swap = rng.choice(min(m, n_act), 150, replace=False)
            rows[swap] = rng.choice(dead, 150, replace=False)
        idx = rows.astype(np.int32)
        mask = np.arange(m) < n_act
        t = np.float32(cfg.truncation_at(cfg.max_integration_distance))
        # kept rows: min |sdf| below the threshold, some weight
        min_sdf = (rng.random(m) * 0.9 * t).astype(np.float32)
        max_w = rng.integers(1, 40, m).astype(np.float32)
        n_cull = {"gc_nothing": 0, "gc_exact_cap": cfg.gc_delete_cap,
                  "gc_over_cap": 3000, "gc_free_rows": 500,
                  "gc_short_list": 450, "gc_threshold_ulps": 600,
                  "gc_negative_zero": 600}[case]
        cull = rng.choice(n_act, n_cull, replace=False)
        far = rng.random(n_cull) < 0.5
        min_sdf[cull[far]] = t * (1.0 + rng.random(far.sum())).astype(
            np.float32)
        max_w[cull[~far]] = 0.0
        if case == "gc_over_cap":         # culled stats in masked rows
            min_sdf[n_act:] = 2 * t
        if case == "gc_free_rows":        # culled rows with a free key
            free_pos = np.flatnonzero(np.isin(idx, dead) & mask)
            min_sdf[free_pos[:100]] = 2 * t
        if case == "gc_threshold_ulps":
            at = rng.choice(n_act, 700, replace=False)
            below = np.nextafter(t, np.float32(0))
            above = np.nextafter(t, np.float32(np.inf))
            min_sdf[at[:100]] = t
            min_sdf[at[100:200]] = below
            min_sdf[at[200:300]] = above
            min_sdf[at[300:400]] = np.nan
            max_w[at[400:500]] = np.nan
            min_sdf[at[500:600]] = np.inf
            max_w[at[500:600]] = 0.0
            min_sdf[at[600:]] = np.inf
        if case == "gc_negative_zero":
            at = rng.choice(n_act, 300, replace=False)
            max_w[at[:100]] = -0.0
            max_w[at[100:200]] = 0.0
            max_w[at[200:]] = np.finfo(np.float32).tiny
        out.append({"case": case, "setup": setup, "cfg": cfg,
                    "active_idx": idx, "active_mask": mask,
                    "min_sdf": min_sdf, "max_w": max_w})
    return out


def gc_inputs(e, device):
    """(MapState, active_idx, active_mask, min_sdf, max_w) of a GC bank
    call on ``device``: the set-up map of :func:`edge_state`."""
    st = edge_state(e, device)
    return (st,) + tuple(torch.from_numpy(e[k]).to(device) for k in (
        "active_idx", "active_mask", "min_sdf", "max_w"))
