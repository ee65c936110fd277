"""Parity of the PyTorch port's block map with the JAX package.

Both packages start from one state (converted bit for bit) and take the
same candidate keys, made with numpy from a seed. Tolerance: the table,
the pool keys, the free stack and the counters must be identical after
every operation, and the port's invariant checker must report all zeros.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import blockmap as jbm, geometry as jgeom
from voxelhashing_tpu.config import MapConfig
from voxelhashing_tpu_torch import blockmap as tbm, convert

CFG = MapConfig(num_blocks=2048, table_size=8192, max_active_blocks=2048,
                alloc_stage_cap=4096, alloc_insert_cap=1024,
                alloc_insert_small=256)
TCFG = convert.config_from(CFG)
FIELDS = ("table_key", "table_val", "block_key", "free_stack", "n_free",
          "n_tombstones", "dense_upto", "surf")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core, and idle
    OpenMP threads spinning beside the other workers cost far more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(ts, js):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in ("sdf", "weight"):
        np.testing.assert_array_equal(
            getattr(ts, f).view(torch.int16).numpy(),
            np.asarray(getattr(js, f)).view(np.int16), err_msg=f)
    np.testing.assert_array_equal(ts.color.numpy().view(np.uint32),
                                  np.asarray(js.color), err_msg="color")


def _clean(ts):
    viol = tbm.check_invariants(ts, TCFG)
    assert all(v == 0 for v in viol.values()), viol


def _keys(rng, n, dup_heavy=False):
    blocks = rng.integers(-30, 30, (n, 3)).astype(np.int32)
    if dup_heavy:                      # every key ~8x, plus invalid entries
        blocks = np.repeat(blocks[: n // 8], 8, axis=0)
        rng.shuffle(blocks)
    keys = np.array(jgeom.pack_block_key(jnp.asarray(blocks),
                                           CFG.world_blocks))
    keys[:: 17] = jgeom.INVALID_KEY
    return keys


def _alloc(ts, js, keys, rounds=2):
    js, nj = jbm.allocate(js, jnp.asarray(keys), CFG, rounds=rounds)
    ts, nt = tbm.allocate(ts, torch.from_numpy(keys), TCFG, rounds=rounds)
    assert int(nt) == int(nj)
    return ts, js


@pytest.mark.parametrize("dup_heavy", [False, True])
def test_allocate_matches(dup_heavy):
    rng = np.random.default_rng(1)
    js = jbm.create(CFG)
    ts = convert.map_state_from_numpy(js, device="cpu")
    first = _keys(rng, 1600, dup_heavy)
    ts, js = _alloc(ts, js, first)
    _same(ts, js)
    assert int(ts.n_free) < CFG.num_blocks
    # a second batch half resident, half new
    ts, js = _alloc(ts, js, _keys(rng, 1200, dup_heavy), rounds=1)
    _same(ts, js)
    _clean(ts)
    probe = np.concatenate([first[:250], _keys(rng, 250)])
    idx, found = tbm.lookup(ts, torch.from_numpy(probe), TCFG)
    jidx, jfound = jbm.lookup(js, jnp.asarray(probe), CFG)
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert found.any() and not found.all()


def test_delete_reinsert_rehash_compact():
    """Delete-then-reinsert through tombstoned chains, then rehash and
    compact_pool; every step identical to JAX and invariant-clean."""
    rng = np.random.default_rng(2)
    js = jbm.create(CFG)
    ts = convert.map_state_from_numpy(js, device="cpu")
    keys = _keys(rng, 1500)
    ts, js = _alloc(ts, js, keys)
    # give the rows data so zeroing on delete is visible
    w = rng.integers(0, 3, (CFG.num_blocks, 512)).astype(np.float32)
    w[np.asarray(js.block_key) == jgeom.INVALID_KEY] = 0.0
    js = js._replace(weight=jnp.asarray(w, jnp.bfloat16),
                     sdf=jnp.asarray(w * 0.001, jnp.bfloat16),
                     surf=jnp.asarray((w > 0).any(axis=1)))
    ts = convert.map_state_from_numpy(js, device="cpu")

    allocated = np.flatnonzero(np.asarray(js.block_key) != jgeom.INVALID_KEY)
    victims = rng.choice(allocated, 300, replace=False).astype(np.int32)
    mask = rng.random(300) < 0.8
    js = jbm.delete_blocks(js, jnp.asarray(victims), jnp.asarray(mask), CFG)
    ts = tbm.delete_blocks(ts, torch.from_numpy(victims),
                           torch.from_numpy(mask), TCFG)
    _same(ts, js)
    _clean(ts)
    assert int(ts.n_tombstones) > 0

    ts, js = _alloc(ts, js, keys)      # re-insert the deleted keys
    _same(ts, js)
    _clean(ts)

    js, ts = jbm.rehash(js, CFG), tbm.rehash(ts, TCFG)
    _same(ts, js)
    assert int(ts.n_tombstones) == 0

    js = jbm.delete_blocks(js, jnp.asarray(victims), jnp.asarray(mask), CFG)
    ts = tbm.delete_blocks(ts, torch.from_numpy(victims),
                           torch.from_numpy(mask), TCFG)
    js, ts = jbm.compact_pool(js, CFG), tbm.compact_pool(ts, TCFG)
    _same(ts, js)
    _clean(ts)
    assert int(ts.dense_upto) == CFG.num_blocks - int(ts.n_free)


@pytest.mark.parametrize("kept", ["none", "with_row0", "without_row0"])
def test_delete_padded_short_list(kept):
    """Delete through a short list padded with row 0, as GC and stream-out
    pass it: the dropped entries leave every row as it was, identical to
    JAX, whether no entry, row 0 or only other rows are kept."""
    rng = np.random.default_rng(3)
    js = jbm.create(CFG)
    ts = convert.map_state_from_numpy(js, device="cpu")
    ts, js = _alloc(ts, js, _keys(rng, 600))
    w = rng.integers(1, 3, (CFG.num_blocks, 512)).astype(np.float32)
    w[np.asarray(js.block_key) == jgeom.INVALID_KEY] = 0.0
    js = js._replace(weight=jnp.asarray(w, jnp.bfloat16),
                     sdf=jnp.asarray(w * 0.001, jnp.bfloat16),
                     color=jnp.asarray(w.astype(np.uint32) * 0x010101),
                     surf=jnp.asarray((w > 0).any(axis=1)))
    ts = convert.map_state_from_numpy(js, device="cpu")
    assert int(ts.block_key[0]) != jgeom.INVALID_KEY
    idx = np.zeros(64, np.int32)                # padding: row 0
    mask = np.zeros(64, bool)
    if kept != "none":
        live = np.flatnonzero(np.asarray(js.block_key) != jgeom.INVALID_KEY)
        rows = rng.choice(live[live > 0], 10, replace=False)
        if kept == "with_row0":
            rows[3] = 0
        idx[:10], mask[:10] = rows, True
    js = jbm.delete_blocks(js, jnp.asarray(idx), jnp.asarray(mask), CFG)
    ts = tbm.delete_blocks(ts, torch.from_numpy(idx), torch.from_numpy(mask),
                           TCFG)
    _same(ts, js)
    _clean(ts)


def test_compactify_and_invariants_agree():
    rng = np.random.default_rng(3)
    js = jbm.create(CFG)
    ts = convert.map_state_from_numpy(js, device="cpu")
    ts, js = _alloc(ts, js, _keys(rng, 1000))
    from voxelhashing_tpu.config import CameraConfig
    cam = CameraConfig(width=64, height=48, fx=52.0, fy=52.0, cx=31.5,
                       cy=23.5)
    view = np.eye(4, dtype=np.float32)
    view[2, 3] = 0.6
    a_j, n_j, o_j = jbm.compactify(js, jnp.asarray(view), cam, CFG)
    a_t, n_t, o_t = tbm.compactify(ts, torch.from_numpy(view),
                                   convert.config_from(cam), TCFG)
    assert int(n_t) == int(n_j) > 0 and int(o_t) == int(o_j)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    all_j, nall_j = jbm.compactify_all(js, CFG)
    all_t, nall_t = tbm.compactify_all(ts, TCFG)
    np.testing.assert_array_equal(all_t.numpy(), np.asarray(all_j))
    # the checker sees a corruption the way the JAX checker does
    bad = ts._replace(block_key=ts.block_key.clone())
    bad.block_key[int(a_t[0])] = tbm.TOMBSTONE - 5
    jbad = js._replace(block_key=jnp.asarray(bad.block_key.numpy()))
    assert tbm.check_invariants(bad, TCFG) == jbm.check_invariants(jbad, CFG)


def _filled(rng, n_keys):
    """A JAX state with ``n_keys`` candidates allocated and data in the
    allocated rows, and the port's copy."""
    js = jbm.create(CFG)
    ts = convert.map_state_from_numpy(js, device="cpu")
    ts, js = _alloc(ts, js, _keys(rng, n_keys))
    w = rng.integers(0, 3, (CFG.num_blocks, 512)).astype(np.float32)
    w[np.asarray(js.block_key) == jgeom.INVALID_KEY] = 0.0
    c = rng.integers(0, 1 << 24, (CFG.num_blocks, 512)).astype(np.uint32)
    sdf = jnp.asarray(rng.normal(0, 0.01, w.shape), jnp.bfloat16)
    surf = ((w > 0) & (np.abs(np.asarray(sdf, np.float32))
                       < CFG.voxel_size)).any(axis=1)
    js = js._replace(weight=jnp.asarray(w, jnp.bfloat16), sdf=sdf,
                     color=jnp.asarray(c), surf=jnp.asarray(surf))
    return convert.map_state_from_numpy(js, device="cpu"), js


@pytest.mark.parametrize("with_color", [False, True])
def test_gather_voxels_and_stats_match(with_color):
    """``gather_voxels`` over voxels of allocated and free blocks (and out
    of the world), and ``stats``, identical to JAX."""
    rng = np.random.default_rng(5)
    ts, js = _filled(rng, 1500)
    vox = rng.integers(-30 * 8, 30 * 8, (4, 700, 3)).astype(np.int32)
    vox[0, :5] = 1 << 20                  # outside the world: reads 0
    got = tbm.gather_voxels(ts, torch.from_numpy(vox), TCFG,
                            with_color=with_color)
    ref = jbm.gather_voxels(js, jnp.asarray(vox), CFG,
                            with_color=with_color)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (got[1].numpy() > 0).any() and (got[1].numpy() == 0).any()
    st_t, st_j = tbm.stats(ts, TCFG), jbm.stats(js, CFG)
    assert {k: int(v) for k, v in st_t.items()} \
        == {k: int(v) for k, v in st_j.items()}


def test_maybe_rehash_matches():
    """``maybe_rehash`` leaves the map alone at few tombstones and rehashes
    past 1/8 of the table, as JAX does."""
    rng = np.random.default_rng(6)
    ts, js = _filled(rng, 1800)
    allocated = np.flatnonzero(np.asarray(js.block_key) != jgeom.INVALID_KEY)
    # compiled once: op by op JAX takes seconds here
    jdelete = jax.jit(jbm.delete_blocks, static_argnums=3)
    jmaybe = jax.jit(jbm.maybe_rehash, static_argnums=1)
    for n_del in (50, 1100):
        victims = np.zeros(1100, np.int32)
        victims[:n_del] = allocated[:n_del]
        mask = np.arange(1100) < n_del
        js2 = jmaybe(jdelete(js, jnp.asarray(victims), jnp.asarray(mask),
                             CFG), CFG)
        ts2 = tbm.delete_blocks(_clone(ts), torch.from_numpy(victims),
                                torch.from_numpy(mask), TCFG)
        ts2 = tbm.maybe_rehash(ts2, TCFG)
        _same(ts2, js2)
        _clean(ts2)
        assert (int(ts2.n_tombstones) == 0) == (n_del > CFG.table_size // 8)


def _clone(ts):
    return type(ts)(*(t.clone() for t in ts))
