"""The map's hash writes: the allocator's insert (``hash_alloc_kernel``,
``csrc/hash_alloc.cu``) and the delete of GC and streaming
(``hash_delete_kernel``, ``csrc/hash_delete.cu``).

No TPU kernel: the JAX package runs both as XLA
(``voxelhashing_tpu/blockmap.py:187`` ``allocate``, :264
``_allocate_unique``, :343 ``_insert_new``, :564 ``delete_blocks``). The
plain versions are ``blockmap.allocate_plain`` and
``blockmap.delete_blocks_plain``, those functions op for op (the CPU
path, and the reference on the card); ``blockmap.allocate`` and
``blockmap.delete_blocks`` keep their names and reach :func:`allocate` and
:func:`delete_blocks` here, which take the map's tensors rather than a
``MapState`` (``blockmap`` imports this module).

On CUDA tensors :func:`allocate` is one launch of ``hash_alloc_kernel`` a
round (in place of ~1,050 small torch launches a round) and
:func:`delete_blocks` one launch of ``hash_delete_kernel`` (in place of
~560), both bit-equal to their plain versions in every field of the map:
pool slots go by prefix rank, so the order is part of the map. The
functional contract of the plain versions holds: the table, pool keys,
surface flags and free stack the kernels write are clones of the
caller's (~25 MB at a 1M-block map), and the 0-d counters are new
tensors; only the delete's pool rows are zeroed in place, as in the plain
version. On CPU tensors the wrappers run the plain versions; any other
device raises. There is no fallback: a missing ``nvcc`` or a failed build
or launch raises.

The insert's claims go to a persistent int32 claim array a table size and
device (INT32_MAX between launches) and each kernel's last-CTA counter is
kept likewise (:func:`reserve`); both are made outside any CUDA graph
capture (``engine.make_step`` reserves them before it captures).

:func:`prepare_allocate` and :func:`prepare_delete` check the inputs and
make the outputs; :func:`launch_allocate` and :func:`launch_delete` issue
the kernels on the current stream (the only places that do; each adds one
to ``allocate.launches`` or ``delete_blocks.launches``). The least time of
a call is the larger of :func:`bytes_moved` over the memory rate and
:func:`operations` over the f32 rate, from :func:`work_counts` or
:func:`delete_work_counts`.
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

_PERSISTENT = {}                    # (device, table size) -> claim array


def _device(t):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"hash_table: no kernel for {dev}")
    return dev


def reserve(device, table_size: int):
    """The persistent claim array (int32 [table_size], INT32_MAX between
    launches) and the two kernels' last-CTA counters (int32 [2], 0 between
    launches) on ``device``, made at the first call for a table size.
    Raises inside a CUDA graph capture when they are not made yet: a
    buffer made there would belong to the graph's pool."""
    device = torch.device(device)
    key = (device, int(table_size))
    got = _PERSISTENT.get(key)
    if got is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "hash_table: reserve(device, table_size) before a CUDA "
                "graph capture; the claim array is not made yet")
        got = (torch.full((table_size,), INT32_MAX, dtype=torch.int32,
                          device=device),
               torch.zeros((2,), dtype=torch.int32, device=device))
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
    claim, counters = reserve(dev, h)
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
    _, counters = reserve(dev, cfg.table_size)
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
# The bound
# ---------------------------------------------------------------------------

# Integer operations, hand-counted on csrc/hash.cuh: a key's two hashes
# (two finalisers of eight operations, the xor and the or: 18), a slot
# (three) and its two compares (two); an inserted key's staging and claim
# slots (six), its rank and pop (four); a freed row's mask test (two) and
# the push's rank (two).
HASH_OPS = 18 + 3 + 2
INSERT_OPS = 6 + 4
ENTRY_OPS = 2
FREE_OPS = HASH_OPS + 2
ROW_BYTES = 512 * (2 + 2 + 4)       # a pool row's sdf, weight and color


class InsertWork(NamedTuple):
    n_keys: int          # candidates read
    n_valid: int         # valid candidates: one table slot read each
    n_inserted: int      # blocks allocated


class DeleteWork(NamedTuple):
    n_entries: int       # list entries: index, mask and pool key read
    n_freed: int         # rows freed


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


def bytes_moved(work) -> int:
    """The least bytes a call must move. Insert: each key read once (4 B),
    one table slot read a valid key (4 B), a free-stack read and the
    table key, table value and pool key written an allocated block
    (16 B), the counters (20 B). Delete: each entry's index, mask and pool
    key (9 B); a freed row's table slot read and tombstoned, pool key,
    surface flag and free-stack push (17 B) and its rows zeroed
    (``ROW_BYTES``); the counters (16 B)."""
    if isinstance(work, InsertWork):
        return 4 * work.n_keys + 4 * work.n_valid + 16 * work.n_inserted + 20
    return 9 * work.n_entries + (17 + ROW_BYTES) * work.n_freed + 16


def operations(work) -> int:
    """Integer operations of a call (``HASH_OPS`` a valid key and
    ``INSERT_OPS`` an allocated block; ``ENTRY_OPS`` an entry and
    ``FREE_OPS`` a freed row)."""
    if isinstance(work, InsertWork):
        return HASH_OPS * work.n_valid + INSERT_OPS * work.n_inserted
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
