"""The map's hash writes (``ops/hash_table.py``): the plain versions of
the insert and the delete, the CPU path of ``blockmap.allocate`` and
``blockmap.delete_blocks`` and the reference the card's kernels are held
to, against the JAX package on ``hash_table.edge_bank``.

Tolerance: none. Every field of the map (the table, the pool keys, the
free stack, the counters, the surface flags and the pool rows) and the
count equal JAX's (``voxelhashing_tpu.blockmap.allocate`` and
``delete_blocks``, jitted once a configuration) bit for bit, through
``blockmap.allocate_plain`` / ``delete_blocks_plain`` and through the
dispatching ``blockmap.allocate`` / ``delete_blocks``. A numpy model of
the kernels' order (``csrc/hash_alloc.cu``: per-CTA compactions, claims by
stage index, the insert rounds' early end; ``csrc/hash_delete.cu``:
tombstones probed on the table as the call found it) equals the plain
version bit for bit too and shows that each case reaches its edge. The
kernels against the plain versions on the card: bit for bit
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses
import functools
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import blockmap as jbm
from voxelhashing_tpu import config as jcfg
from voxelhashing_tpu_torch import blockmap as tbm, convert
from voxelhashing_tpu_torch.geometry import INVALID_KEY
from voxelhashing_tpu_torch.ops import _build, hash_table as ht

FIELDS = ("table_key", "table_val", "block_key", "free_stack", "n_free",
          "n_tombstones", "dense_upto", "surf")
T = ht.ALLOC_THREADS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _bank():
    return {e["case"]: e for e in ht.edge_bank()}


def _jcfg(cfg):
    return jcfg.MapConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _jax_allocate(cfg, rounds):
    return jax.jit(lambda s, k: jbm.allocate(s, k, _jcfg(cfg),
                                             rounds=rounds))


@functools.lru_cache(maxsize=None)
def _jax_delete(cfg):
    return jax.jit(lambda s, i, m: jbm.delete_blocks(s, i, m, _jcfg(cfg)))


def _jax_op(js, op):
    kind, cfg, a, b = op
    if kind == "allocate":
        return _jax_allocate(cfg, b)(js, jnp.asarray(a))
    return _jax_delete(cfg)(js, jnp.asarray(a), jnp.asarray(b)), None


@functools.lru_cache(maxsize=None)
def _set_up(case):
    """The JAX map after the case's set-up, with data in the allocated
    rows (so that a delete's zeroing shows), as numpy leaves."""
    e = _bank()[case]
    js = jbm.create(_jcfg(e["setup"][0][1]))
    for op in e["setup"]:
        js, _ = _jax_op(js, op)
    rng = np.random.default_rng(len(case))
    n = js.block_key.shape[0]
    live = np.asarray(js.block_key) != INVALID_KEY
    w = rng.integers(1, 4, (n, 512)).astype(np.float32) * live[:, None]
    far = rng.random(n) < 0.5           # rows with no voxel in the band
    sdf = w * np.where(far, 0.01, 0.001)[:, None]
    js = js._replace(weight=jnp.asarray(w, jnp.bfloat16),
                     sdf=jnp.asarray(sdf, jnp.bfloat16),
                     color=jnp.asarray(w.astype(np.uint32) * 0x010203),
                     surf=jnp.asarray(live & ~far))
    return jax.tree_util.tree_map(np.asarray, js)


def _same(ts, js, what=""):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)),
                                      err_msg=f"{what} {f}")
    for f in ("sdf", "weight"):
        np.testing.assert_array_equal(
            getattr(ts, f).view(torch.int16).numpy(),
            np.asarray(getattr(js, f)).view(np.int16), err_msg=f"{what} {f}")
    np.testing.assert_array_equal(ts.color.numpy().view(np.uint32),
                                  np.asarray(js.color), err_msg=f"{what} "
                                  "color")


def _torch_op(fn, ts, op):
    kind, cfg, a, b = op
    if kind == "allocate":
        return fn(ts, torch.from_numpy(a), cfg, rounds=b)
    return fn(ts, torch.from_numpy(a), torch.from_numpy(b), cfg), None


@pytest.mark.parametrize("case", ht.EDGE_CASES)
def test_plain_matches_jax_on_the_edge_bank(case):
    """Each edge call from one state in both packages: the plain version
    and the dispatching wrapper equal JAX in every field and count, and
    the map stays invariant-clean. An empty key list raises in all
    three, as JAX's and the plain version's max over no winners does."""
    e = _bank()[case]
    op = e["op"]
    jstate = jbm.MapState(*(jnp.asarray(x) for x in _set_up(case)))
    if op[2].size == 0:
        with pytest.raises(Exception):
            _jax_op(jstate, op)
        for fn in (tbm.allocate_plain, tbm.allocate):
            with pytest.raises(Exception):
                _torch_op(fn, convert.map_state_from_numpy(
                    jstate, device="cpu"), op)
        return
    js, jn = _jax_op(jstate, op)
    for name, fn in (("plain", tbm.allocate_plain if op[0] == "allocate"
                      else tbm.delete_blocks_plain),
                     ("wrapper", tbm.allocate if op[0] == "allocate"
                      else tbm.delete_blocks)):
        ts = convert.map_state_from_numpy(jstate, device="cpu")
        ts, tn = _torch_op(fn, ts, op)
        _same(ts, js, f"{case} {name}")
        if jn is not None:
            assert int(tn) == int(jn), (case, name)
    viol = tbm.check_invariants(ts, op[1])
    assert all(v == 0 for v in viol.values()), (case, viol)


# ---------------------------------------------------------------------------
# A numpy model of the kernels' order
# ---------------------------------------------------------------------------

def _probes_until(table, keys, r0, r1, h):
    """(found, dead) of ``keys`` over probe rounds [r0, r1): found at a
    slot holding the key, dead once found or at an empty slot."""
    found = np.zeros(keys.shape, bool)
    dead = keys == INVALID_KEY
    for r in range(r0, r1):
        tk = table[ht.probe_slots(keys, r, h)]
        hit = (tk == keys) & ~dead
        found |= hit
        dead |= hit | (tk == INVALID_KEY)
    return found, dead


def _model_allocate(st, keys, cfg, rounds):
    """``csrc/hash_alloc.cu`` in numpy, launch by launch: each CTA probes
    its keys on the table as the launch found it (the pre-drop, and each
    live key's flags: open after probes 0-1, found by the deep probes,
    its probe-0 slot free) and compacts them in order; the last CTA's
    loops walk only the live chunks of the stage list; claims by stage
    index into a claim array kept at INT32_MAX; the resident check from
    the flags, the
    insert list by rank and the insert rounds (round 0 on the probe-0
    flag), which end when nothing is pending. Returns the map's new
    fields, the count and each round's counts of the edges it reached."""
    tk, tv, bk = (st.table_key.copy(), st.table_val.copy(),
                  st.block_key.copy())
    fs, n_free = st.free_stack, int(st.n_free)
    upto, total = int(st.dense_upto), 0
    h, n_pool, k = cfg.table_size, cfg.num_blocks, keys.size
    scap = min(cfg.alloc_stage_cap, k)
    rcap, icap = min(ht.RESIDENT_CAP, scap), min(cfg.alloc_insert_cap, scap)
    pre = min(2, cfg.max_probes)
    ins = min(cfg.insert_probes, cfg.max_probes)
    claim = np.full(h, ht.INT32_MAX, np.int64)
    stats = []
    for ri in range(rounds):
        # the grid: every round of a key at once, on the table as found
        tk0 = tk.copy()
        found, term = _probes_until(tk, keys, 0, pre, h)
        deep, _ = _probes_until(tk, keys, 2, cfg.max_probes, h)
        free0 = np.isin(tk[ht.probe_slots(keys, 0, h)],
                        (INVALID_KEY, ht.TOMBSTONE))
        live = (keys != INVALID_KEY) & ~found
        order = np.concatenate([np.flatnonzero(live[c:c + T]) + c
                                for c in range(0, max(k, 1), T)])[:scap]
        n_stage = order.size
        stage, idx = keys[order], np.arange(n_stage)
        f_open, f_deep, f_free0 = ~term[order], deep[order], free0[order]

        def contest(slots, who):
            np.minimum.at(claim, slots, who)
            won = claim[slots] == who
            claim[slots] = ht.INT32_MAX
            return won

        s0 = ht.probe_slots(stage, ri, h)
        rep = contest(s0, idx)
        open_ = rep & f_open
        lrank = np.cumsum(open_) - 1
        fresh = rep & ~(open_ & ((lrank >= rcap) | f_deep))
        pending = fresh & (np.cumsum(fresh) - 1 < icap)
        base, mx, wins, short = 0, -1, 0, False
        for r in range(ins):
            if not pending.any():
                break
            s = ht.probe_slots(stage, r, h)
            if r == 0:                   # as the grid read it
                empty = f_free0
            else:
                t = tk[s]
                pending &= ~(t == stage)
                empty = (t == INVALID_KEY) | (t == ht.TOMBSTONE)
            contend = pending & empty
            win = np.zeros(n_stage, bool)
            win[contend] = contest(s[contend], idx[contend])
            rank = np.cumsum(win) - 1 + base
            can = win & (rank < n_free)
            ps = fs[np.clip(n_free - 1 - rank, 0, n_pool - 1)]
            tk[s[can]] = stage[can]
            tv[s[can]] = ps[can]
            bk[ps[can]] = stage[can]
            if can.any():
                mx = max(mx, int(ps[can].max()))
            short |= bool((win & ~can).any())
            wins += int(win.sum())
            base += int(can.sum())
            pending &= ~win
        n_free -= base
        upto = max(upto, mx + 1)
        total += base
        # open keys within rcap whose deep probes reach round 3
        _, dead2 = _probes_until(tk0, stage, 2, min(3, cfg.max_probes), h)
        reach3 = open_ & (lrank < rcap) & ~dead2 & (cfg.max_probes > 3)
        stats.append({"live": int(live.sum()), "staged": n_stage,
                      "chunks": -(-n_stage // T),
                      "rep": int(rep.sum()), "open": int(open_.sum()),
                      "deep": int(reach3.sum()),
                      "fresh": int(fresh.sum()), "wins": wins,
                      "short": short})
    assert (claim == ht.INT32_MAX).all()
    return {"table_key": tk, "table_val": tv, "block_key": bk,
            "n_free": n_free, "dense_upto": upto}, total, stats


def _model_delete(st, idx, mask, cfg):
    """``csrc/hash_delete.cu`` in numpy: each freed row's key tombstoned
    where the table as the call found it holds it, then the pushes in list
    order. Returns the new fields and the keys' probe rounds."""
    h, n_pool = cfg.table_size, cfg.num_blocks
    ok = (idx >= 0) & (idx < n_pool)
    keys = st.block_key[np.where(ok, idx, 0)]
    freed = mask & ok & (keys != INVALID_KEY)
    tk, bk = st.table_key.copy(), st.block_key.copy()
    surf, fs = st.surf.copy(), st.free_stack.copy()
    depth = []
    for e in np.flatnonzero(freed):
        for r in range(cfg.max_probes):
            s = ht.probe_slots(keys[e:e + 1], r, h)[0]
            if st.table_key[s] == keys[e]:
                tk[s] = ht.TOMBSTONE
                depth.append(r)
                break
    bk[idx[freed]] = INVALID_KEY
    surf[idx[freed]] = False
    pos = int(st.n_free) + np.cumsum(freed) - 1
    fs[pos[freed]] = idx[freed]
    n = int(freed.sum())
    return {"table_key": tk, "block_key": bk, "surf": surf,
            "free_stack": fs, "n_free": int(st.n_free) + n,
            "n_tombstones": int(st.n_tombstones) + n}, depth


# what each case must reach, on the model's counts
_EDGES = {
    "all_invalid": lambda s: s[0]["live"] == 0,
    "resident": lambda s: s[0]["fresh"] == s[0]["wins"] == 0,
    "repeated_8x": lambda s: s[0]["staged"] > 6 * s[0]["rep"] > 0,
    "contended": lambda s: s[0]["rep"] <= 128 and s[1]["rep"] > 0
    and s[0]["wins"] > 0,
    "tombstones": lambda s: s[0]["fresh"] > 0,
    "over_caps": lambda s: s[0]["live"] > 8192 and s[0]["open"] > 2048
    and s[0]["fresh"] > 4096 and s[0]["deep"] > 0 and s[0]["chunks"] == 8,
    "pool_short": lambda s: s[0]["short"],
    "probes_3_1": lambda s: s[0]["fresh"] > s[0]["wins"] > 0,
    "probes_12_6": lambda s: s[0]["deep"] > 0 and s[0]["wins"] > 0,
    "rounds_16": lambda s: len(s) == 16 and s[1]["wins"] > 0,
}


@pytest.mark.parametrize("case", ht.EDGE_CASES)
def test_kernel_model_matches_plain(case):
    """The kernels' order, modelled in numpy, equals the plain version bit
    for bit on each edge call, and the call reaches its edge (keys past
    each cap, contended claims, a short pool, deep chains, free rows, live
    keys over several chunks)."""
    e = _bank()[case]
    kind, cfg, a, b = e["op"]
    st = jbm.MapState(*_set_up(case))
    if a.size == 0:
        return
    ts = convert.map_state_from_numpy(st, device="cpu")
    if kind == "allocate":
        ref, n_ref = tbm.allocate_plain(ts, torch.from_numpy(a), cfg,
                                        rounds=b)
        got, n, stats = _model_allocate(st, a, cfg, b)
        assert n == int(n_ref)
        assert _EDGES.get(case, lambda s: True)(stats), (case, stats)
    else:
        got, depth = _model_delete(st, a, b, cfg)
        ref = tbm.delete_blocks_plain(ts, torch.from_numpy(a),
                                      torch.from_numpy(b), cfg)
        freed = int(ref.n_free) - int(st.n_free)
        if case == "delete_free_rows":
            assert (b & (st.block_key[a] == INVALID_KEY)).any()
        if case == "delete_deep":
            assert max(depth) >= 3 and freed > 3000
        if case == "gc_padded_nothing":
            assert freed == 0
        if case in ("gc_short", "stream_out_4096"):
            assert freed == int(b.sum())
    for f, v in got.items():
        np.testing.assert_array_equal(np.asarray(v),
                                      getattr(ref, f).numpy(), err_msg=f)


@functools.lru_cache(maxsize=None)
def _gc_bank():
    return {e["case"]: e for e in ht.gc_bank()}


_FLAG_A, _FLAG_P, _COUNT = 1 << 62, 2 << 62, (1 << 31) - 1


def _model_gc(st, idx, mask, min_sdf, max_w, cfg, rng, rows):
    """``csrc/hash_delete.cu``'s GC entry in numpy: CTAs of ``rows`` rows
    (the kernel's ``GC_ROWS``, or fewer: more CTAs) in ticket order, each
    counting its culled and freed rows; each CTA's look-back over 32
    predecessors at a time, whose status words it finds as they may stand
    (each with at least its own counts, a random third with their prefix,
    none for the last CTA, CTA 0 always with its prefix), summed as the
    card sums them (two 31-bit counts in one 64-bit word); a CTA whose
    culled count before it is below dcap keeps its culled rows of rank <
    dcap, pushes the freed ones at n_free + the freed rows before them
    and tombstones their slots; the CTA that holds the cut (or the last)
    writes the counters; each kept row is zeroed once, by its owner or by
    one of the CTAs after it (``GC_SPREAD`` in all). Returns the new
    fields and the model's counts."""
    m = idx.size
    grid = -(-m // rows)
    t = np.float32(ht.gc_threshold(cfg))
    with np.errstate(invalid="ignore"):
        cull = mask & ((min_sdf >= t) | (max_w == 0.0))
    ok = (idx >= 0) & (idx < cfg.num_blocks)
    freed = cull & ok & (st.block_key[np.where(ok, idx, 0)] != INVALID_KEY)
    dcap = min(cfg.gc_delete_cap, m)
    c = [int(cull[b * rows:(b + 1) * rows].sum()) for b in range(grid)]
    f = [int(freed[b * rows:(b + 1) * rows].sum()) for b in range(grid)]
    inc_c, inc_f = np.cumsum(c), np.cumsum(f)
    tk, bk = st.table_key.copy(), st.block_key.copy()
    surf, fs = st.surf.copy(), st.free_stack.copy()
    n_free, writers = int(st.n_free), []
    stats = {"windows": 0, "cut_inside": False, "kept": 0}
    ctas = []                           # (below, f_before, own slots)
    for b in range(grid):
        # the last CTA finds only its predecessors' own counts (as when
        # every CTA published at once): it looks back to CTA 0
        words = [_FLAG_P | (int(inc_c[k]) << 31) | int(inc_f[k])
                 if k == 0 or (b < grid - 1 and rng.random() < 1 / 3)
                 else _FLAG_A | (c[k] << 31) | f[k] for k in range(b)]
        total, j, windows = 0, b - 1, 0
        while b > 0:
            win = [words[j - ln] if j - ln >= 0 else _FLAG_P
                   for ln in range(32)]
            pre = [w >> 62 == 2 for w in win]
            stop = pre.index(True) if any(pre) else 31
            total += sum(w & ~(3 << 62) for w in win[:stop + 1])
            windows += 1
            if any(pre):
                break
            j -= 32
        stats["windows"] = max(stats["windows"], windows)
        c_before, f_before = (total >> 31) & _COUNT, total & _COUNT
        assert (c_before, f_before) == (int(inc_c[b]) - c[b],
                                        int(inc_f[b]) - f[b])
        if c_before >= dcap:
            ctas.append((False, f_before, range(0)))
            continue
        lc = lf = 0
        for e in range(b * rows, min((b + 1) * rows, m)):
            if freed[e] and c_before + lc < dcap:
                key = st.block_key[idx[e]]
                for r in range(cfg.max_probes):
                    slot = ht.probe_slots(np.array([key]), r,
                                          cfg.table_size)[0]
                    if st.table_key[slot] == key:
                        tk[slot] = ht.TOMBSTONE
                        break
                bk[idx[e]], surf[idx[e]] = INVALID_KEY, False
                fs[n_free + f_before + lf] = idx[e]
                lf += 1
            lc += bool(cull[e])
        stats["kept"] += lf
        ctas.append((True, f_before, range(f_before, f_before + lf)))
        if c_before + c[b] >= dcap or b == grid - 1:
            writers.append(f_before + lf)
            stats["cut_inside"] = c_before < dcap < c_before + c[b]
    assert len(writers) == 1
    n = writers[0]
    assert n == stats["kept"]
    # the zeroing: owner j's kept row t by CTA j + t % S_j, S_j =
    # min(GC_SPREAD, G - j); CTA z reads the done words of the CTAs
    # z - GC_SPREAD + 1 .. z - 1 only, so each row's zeroer must lie
    # within that window of its owner
    zeroed = np.zeros(n, np.int64)
    by = np.zeros(grid, np.int64)
    for owner, (_, _, own) in enumerate(ctas):
        spread = min(ht.GC_SPREAD, grid - owner)
        for t, k in enumerate(own):
            z = owner + t % spread
            assert owner <= z < grid and z - owner < ht.GC_SPREAD
            zeroed[k] += 1
            by[z] += 1
    assert (zeroed == 1).all()
    stats["most_zeroed"] = int(by.max(initial=0))
    stats.update(culled=int(cull.sum()), dcap=dcap, grid=grid)
    return {"table_key": tk, "block_key": bk, "surf": surf,
            "free_stack": fs, "n_free": n_free + n,
            "n_tombstones": int(st.n_tombstones) + n}, stats


@pytest.mark.parametrize("rows", [ht.GC_ROWS, 256])
@pytest.mark.parametrize("case", ht.GC_CASES)
def test_gc_kernel_model_matches_plain(case, rows):
    """The GC entry's order (the per-CTA counts, the look-back, the cap,
    each CTA's pushes and the rows' zeroing spread over each owner and the
    CTAs after it, each row once), modelled in numpy with the kernel's
    CTAs and with
    256-row ones (46 CTAs: a look-back over more than one window), equals
    ``integrate.garbage_collect_plain`` bit for bit on each GC bank call,
    and the call reaches its edge."""
    from voxelhashing_tpu_torch import integrate as tint
    e = _gc_bank()[case]
    ts, idx, mask, ms, mw = ht.gc_inputs(e, "cpu")
    st = type(ts)(*(t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                    else t.numpy() for t in ts))
    got, stats = _model_gc(st, e["active_idx"], e["active_mask"],
                           e["min_sdf"], e["max_w"], e["cfg"],
                           np.random.default_rng(len(case)), rows)
    ref = tint.garbage_collect_plain(ts, idx, mask, e["cfg"],
                                     cached_stats=(ms, mw))
    for f, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), getattr(ref, f).numpy(),
                                      err_msg=f)
    freed = int(ref.n_free) - int(ts.n_free)
    if case != "gc_short_list" and rows == 256:
        assert stats["grid"] > 33 and stats["windows"] >= 2
    if case == "gc_nothing":
        assert stats["culled"] == freed == 0
    if case == "gc_exact_cap":
        assert stats["culled"] == stats["dcap"] == freed
    if case == "gc_over_cap":
        assert stats["culled"] > stats["dcap"] == freed
        assert stats["cut_inside"]
    if freed >= 2 * stats["grid"] and stats["grid"] > 1:
        # the kept rows' zeroing is spread: no CTA zeroes them all
        assert stats["most_zeroed"] < freed
    if case == "gc_free_rows":
        assert 0 < freed < stats["culled"] < stats["dcap"]
    if case == "gc_short_list":
        assert stats["dcap"] == idx.numel() < e["cfg"].gc_delete_cap
        assert 0 < freed < stats["culled"]
    t = np.float32(ht.gc_threshold(e["cfg"]))
    hit = e["active_mask"] & (e["min_sdf"] == t) & (e["max_w"] > 0)
    below = e["active_mask"] & (e["min_sdf"] == np.nextafter(t, F0)) \
        & (e["max_w"] > 0)
    if case == "gc_threshold_ulps":
        kept = ref.block_key.numpy()[e["active_idx"]] != INVALID_KEY
        assert hit.sum() > 0 and not kept[hit].any()
        assert below.sum() > 0 and kept[below].all()
    if case == "gc_negative_zero":
        nz = e["active_mask"] & (e["max_w"] == 0) & np.signbit(e["max_w"]) \
            & (e["min_sdf"] < t)
        kept = ref.block_key.numpy()[e["active_idx"]] != INVALID_KEY
        assert nz.sum() > 0 and not kept[nz].any()


F0 = np.float32(0)


# ---------------------------------------------------------------------------
# The wrapper, its bound and its source
# ---------------------------------------------------------------------------

def test_wrappers_refuse_other_devices():
    """A map on neither the CPU nor CUDA is refused, never run by the
    plain version: through the wrappers and through blockmap."""
    meta = torch.device("meta")
    cfg = ht.SMALL
    st = tbm.create(cfg, meta)
    keys = torch.zeros(8, dtype=torch.int32, device=meta)
    mask = torch.zeros(8, dtype=torch.bool, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        ht.allocate(st.table_key, st.table_val, st.block_key, st.free_stack,
                    st.n_free, st.dense_upto, keys, cfg)
    with pytest.raises(ValueError, match="no kernel"):
        ht.delete_blocks(st.table_key, st.block_key, st.surf, st.free_stack,
                         st.n_free, st.n_tombstones, st.sdf, st.weight,
                         st.color, keys, mask, cfg)
    with pytest.raises(ValueError, match="no kernel"):
        tbm.allocate(st, keys, cfg)
    with pytest.raises(ValueError, match="no kernel"):
        tbm.delete_blocks(st, keys, mask, cfg)


def test_gc_wrapper_refuses_what_the_kernel_cannot_take():
    """The GC entry's checks, before anything is launched: stats of
    another type or length, an empty active list, a cap below 1."""
    cfg = ht.SMALL
    st = tbm.create(cfg, "cpu")
    idx = torch.zeros(8, dtype=torch.int32)
    mask = torch.ones(8, dtype=torch.bool)
    stats = torch.zeros(8, dtype=torch.float32)

    def call(idx=idx, mask=mask, ms=stats, mw=stats, cfg=cfg):
        ht.prepare_gc(st.table_key, st.block_key, st.surf, st.free_stack,
                      st.n_free, st.n_tombstones, st.sdf, st.weight,
                      st.color, idx, mask, ms, mw, cfg)

    with pytest.raises(ValueError, match="min_sdf"):
        call(ms=stats.double())
    with pytest.raises(ValueError, match="max_w"):
        call(mw=stats[:4])
    with pytest.raises(ValueError, match="empty active list"):
        call(idx=idx[:0], mask=mask[:0], ms=stats[:0], mw=stats[:0])
    with pytest.raises(ValueError, match="gc_delete_cap"):
        call(cfg=dataclasses.replace(cfg, gc_delete_cap=0))
    assert ht.garbage_collect.launches == 0


def test_cpu_path_launches_nothing():
    """On CPU tensors the wrappers run the plain versions: no launch, and
    no plain call counted on the card."""
    cfg = ht.SMALL
    st = tbm.create(cfg, "cpu")
    before = (ht.allocate.launches, ht.delete_blocks.launches,
              tbm.allocate_plain.cuda_calls,
              tbm.delete_blocks_plain.cuda_calls)
    keys = torch.from_numpy(_bank()["resident"]["op"][2])
    st, n = tbm.allocate(st, keys, cfg, rounds=2)
    assert int(n) > 900
    rows = torch.arange(64, dtype=torch.int32)
    st = tbm.delete_blocks(st, rows, rows % 2 == 0, cfg)
    assert int(st.n_free) == cfg.num_blocks - int(n) + 32
    assert (ht.allocate.launches, ht.delete_blocks.launches,
            tbm.allocate_plain.cuda_calls,
            tbm.delete_blocks_plain.cuda_calls) == before


def test_bytes_moved_hand_count():
    """Insert: 4 B a key, 4 B a valid key's table slot, 16 B an allocated
    block, 20 B of counters; delete: 9 B an entry, 4,113 B a freed row
    (its rows 4,096), 16 B of counters."""
    assert ht.bytes_moved(ht.InsertWork(38400, 1000, 100)) == \
        4 * 38400 + 4 * 1000 + 16 * 100 + 20
    assert ht.bytes_moved(ht.InsertWork(0, 0, 0)) == 20
    assert ht.ROW_BYTES == 4096
    assert ht.bytes_moved(ht.DeleteWork(1024, 10)) == \
        9 * 1024 + 4113 * 10 + 16
    assert ht.bytes_moved(ht.DeleteWork(4096, 0)) == 9 * 4096 + 16


def test_operations_hand_count():
    """23 integer operations a valid key's hash, slot and compares, 10 an
    allocated block; 2 a list entry, 25 a freed row."""
    assert ht.HASH_OPS == 23 and ht.INSERT_OPS == 10
    assert ht.operations(ht.InsertWork(5, 4, 3)) == 23 * 4 + 10 * 3
    assert ht.operations(ht.DeleteWork(8, 2)) == 2 * 8 + 25 * 2


def test_gc_work_and_bound_by_hand():
    """GC: 9 B an active row (mask, two stats), 8 B a culled row (index and
    pool key), 4,113 B a freed row, 16 B of counters; 4 operations an
    active row, 2 a culled one, 25 a freed one. The counts on a list: the
    culled rows past the cap and the culled free rows are not freed."""
    assert ht.bytes_moved(ht.GcWork(32768, 40, 30)) == \
        9 * 32768 + 8 * 40 + 4113 * 30 + 16
    assert ht.operations(ht.GcWork(10, 4, 2)) == 4 * 10 + 2 * 4 + 25 * 2
    cfg = dataclasses.replace(ht.SMALL, gc_delete_cap=3)
    t = np.float32(ht.gc_threshold(cfg))
    bk = torch.tensor([5, INVALID_KEY, 7, 9, 11, 13], dtype=torch.int32)
    idx = torch.tensor([0, 1, 2, 3, 4, 5], dtype=torch.int32)
    mask = torch.tensor([True, True, True, True, True, False])
    ms = torch.tensor([t, 2 * t, 0, t, 0, 2 * t], dtype=torch.float32)
    mw = torch.tensor([1, 1, 0, 1, 1, 0], dtype=torch.float32)
    # culled: rows 0-3 (row 5 is masked); the cap keeps 0-2; row 1 is free
    assert ht.gc_work_counts(bk, idx, mask, ms, mw, cfg) == \
        ht.GcWork(6, 4, 2)


def test_work_counts_on_a_map():
    """The counts a bound reads, from the call's inputs and its result."""
    keys = torch.tensor([1, INVALID_KEY, 3, 3], dtype=torch.int32)
    assert ht.work_counts(keys, torch.tensor(2)) == ht.InsertWork(4, 3, 2)
    bk = torch.tensor([5, INVALID_KEY, 7, 9], dtype=torch.int32)
    idx = torch.tensor([0, 1, 2, 3, 9], dtype=torch.int32)
    mask = torch.tensor([True, True, False, True, True])
    assert ht.delete_work_counts(bk, idx, mask) == ht.DeleteWork(5, 2)


def _cuh_constants():
    src = (_build.CSRC / "hash.cuh").read_text()
    return {name: int(val, 16) for name, val in re.findall(
        r"constexpr \w+ (k\w+) = (0x[0-9A-Fa-f]+)u?;", src)}


def test_cuda_hash_constants_are_blockmaps():
    """The card's hash (``csrc/hash.cuh``) is ``blockmap``'s: a mix with
    its constants, the odd second hash and the power-of-two mask give
    ``blockmap._probe_slot``'s slots, and the sentinels are
    ``INVALID_KEY`` and ``TOMBSTONE``."""
    c = _cuh_constants()
    assert c["kInvalidKey"] == INVALID_KEY == 0x7FFFFFFF
    assert c["kTombstone"] == tbm.TOMBSTONE == ht.TOMBSTONE
    m32 = 0xFFFFFFFF

    def mix(x):
        x ^= x >> 16
        x = (x * c["kMixA"]) & m32
        x ^= x >> 15
        x = (x * c["kMixB"]) & m32
        return x ^ (x >> 16)

    rng = np.random.default_rng(0)
    keys = np.r_[rng.integers(0, 1 << 30, 200), 0, 1, (1 << 30) - 1]
    for size in (1 << 14, 1 << 21):
        for r in (0, 1, 7):
            want = [(mix(k) + r * (mix(k ^ c["kGolden"]) | 1)) & (size - 1)
                    for k in map(int, keys)]
            got = tbm._probe_slot(torch.from_numpy(keys.astype(np.int32)),
                                  r, size)
            assert got.tolist() == want
            assert ht.probe_slots(keys, r, size).tolist() == want
    src = (_build.CSRC / "hash.cuh").read_text()
    assert "mix32(k ^ kGolden) | 1u" in src
    assert "& mask" in src
