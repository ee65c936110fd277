"""Parity of the PyTorch port's streaming (``voxelhashing_tpu_torch.streaming``
and ``native``) with ``voxelhashing_tpu.streaming``, on the JAX tests'
80x60 camera, 2 cm voxels and 8,192-block pool.

Tolerances: everything here is exact. Chunk ids, bitmask words (as uint32),
stream-out picks, the map after an insert or a stream-in (every field, bit
for bit through ``convert.map_state_to_numpy``), the host store's sorted
rows and checkpoints loaded across the packages.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import (blockmap as jbm, engine as jeng, geometry as jgeom,
                              integrate as jinteg, meshing as jmesh,
                              streaming as jstr)
from voxelhashing_tpu.config import (CameraConfig, EngineConfig, FilterConfig,
                                     MapConfig, StreamingConfig,
                                     TrackerConfig)
from voxelhashing_tpu.geometry import INVALID_KEY
from voxelhashing_tpu.io.synthetic import Scene, Sphere, render_depth
from voxelhashing_tpu_torch import (blockmap as tbm, convert, engine as teng,
                                    native, streaming as tstr)

CAM = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5)
CFG = MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                num_blocks=8192, table_size=32768,
                max_active_blocks=8192, world_blocks=1024)
SCFG = StreamingConfig(enabled=True, chunk_size=0.64, grid_dim=65,
                       radius=1.5, out_parts=4, in_chunks_per_frame=4)
TCFG = convert.config_from(CFG)
TSCFG = convert.config_from(SCFG)
SCENE = Scene(wall_z=2.0, floor_y=None, spheres=())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fused():
    """The JAX tests' fused wall (a JAX MapState)."""
    depth, color = render_depth(np.eye(4, dtype=np.float32), CAM, SCENE)
    state = jbm.create(CFG)
    state, _ = jinteg.allocate_from_depth(state, jnp.asarray(depth),
                                          jnp.eye(4), CAM, CFG)
    return jinteg.integrate(state, jnp.asarray(depth), jnp.asarray(color),
                            jnp.eye(4), CAM, CFG)


def assert_map_equal(tstate, jstate):
    got = convert.map_state_to_numpy(tstate)
    for f, v in got.items():
        ref = np.asarray(getattr(jstate, f))
        assert v.dtype == ref.dtype and v.shape == ref.shape, f
        np.testing.assert_array_equal(np.atleast_1d(v).view(np.uint8),
                                      np.atleast_1d(ref).view(np.uint8),
                                      err_msg=f)


def sorted_rows(keys, sdf, weight, color):
    o = np.argsort(keys)
    return keys[o], sdf[o], weight[o], np.asarray(color, np.uint32)[o]


def assert_rows_equal(a, b):
    for x, y in zip(sorted_rows(*a), sorted_rows(*b)):
        assert x.dtype == y.dtype, (x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y)


def store_rows(store):
    return store.peek_chunks(store.chunk_coords())


def pin_stores(kind, jm, tm):
    """Give both managers one kind of host store, so that their pop orders
    agree: "python" pins both to the Python stores; "native" keeps the
    native ones, unless the JAX manager fell back to its Python store (its
    host library did not load), and then the port gets its Python store
    too."""
    if kind == "python" or isinstance(jm.store, jstr.PyChunkStore):
        jm.store = jstr.PyChunkStore(jm._bpc, jm.cfg.world_blocks)
        tm.store = tstr.make_chunk_store(tm._bpc, tm.cfg.world_blocks,
                                         native=False)
    assert isinstance(jm.store, jstr.PyChunkStore) == isinstance(
        tm.store, tstr.PyChunkStore)


def random_keys(rng, n):
    blocks = rng.integers(-200, 200, size=(n, 3)).astype(np.int32)
    keys = np.array(jgeom.pack_block_key(jnp.asarray(blocks), 1024))
    keys[::7] = INVALID_KEY
    return keys


def test_chunk_linearisation_matches_jax():
    """Device functions and host twins give JAX's chunk coords and ids,
    clamping at the grid edge included (chunks up to +-50 on a 65 grid)."""
    rng = np.random.default_rng(0)
    keys = random_keys(rng, 4000)
    got = tstr.key_to_chunk_linear(torch.from_numpy(keys), TCFG, TSCFG)
    ref = jstr.key_to_chunk_linear(jnp.asarray(keys), CFG, SCFG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.max() < SCFG.grid_dim ** 3

    blocks = rng.integers(-300, 300, size=(500, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tstr.block_to_chunk(torch.from_numpy(blocks), TCFG, TSCFG).numpy(),
        np.asarray(jstr.block_to_chunk(jnp.asarray(blocks), CFG, SCFG)))
    np.testing.assert_array_equal(
        tstr.chunk_linear(torch.from_numpy(blocks), TSCFG).numpy(),
        np.asarray(jstr.chunk_linear(jnp.asarray(blocks), SCFG)))

    valid = keys[keys != INVALID_KEY]
    jm = jstr.AsyncStreamingManager(CFG, SCFG, out_cap=64)
    bpc = tstr.blocks_per_chunk(TCFG, TSCFG)
    coords = tstr.chunks_of_keys_np(valid, 1024, bpc)
    np.testing.assert_array_equal(
        coords, jmesh._chunks_of_keys_np(valid, 1024, bpc))
    np.testing.assert_array_equal(
        tstr.lin_of_keys_np(valid, 1024, bpc, SCFG.grid_dim),
        jm._lin_of_keys(valid))
    np.testing.assert_array_equal(
        tstr.lin_of_chunks_np(coords, SCFG.grid_dim),
        jm._lin_of_chunks(coords))


def test_bitmask_words_match_jax():
    """Bits 0 and 31 of a word (the int32 sign bit), a host rebuild, the
    device delta (a scatter-add of unique bits) and the clear all give the
    JAX uint32 words; the candidate mask drops the same keys."""
    n_words = tstr.bitmask_words(TSCFG)
    ids = np.array([0, 31, 32, 63, 95, 1000, 12345, SCFG.grid_dim ** 3 - 1])
    words = np.zeros((n_words,), np.uint32)
    np.bitwise_or.at(words, ids // 32,
                     np.uint32(1) << (ids % 32).astype(np.uint32))
    rebuilt = tstr.bitmask_from_ids(ids, n_words, device="cpu")
    assert rebuilt.dtype == torch.int32 and int(rebuilt[0]) < 0
    np.testing.assert_array_equal(convert.bitmask_to_numpy(rebuilt), words)
    assert torch.equal(convert.bitmask_from_numpy(words, device="cpu"),
                       rebuilt)

    lin = torch.from_numpy(np.concatenate([ids, ids[::-1]]).astype(np.int32))
    s = torch.sort(lin).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    delta = tstr.bitmask_delta(s, first, n_words)
    np.testing.assert_array_equal(convert.bitmask_to_numpy(delta), words)
    cleared = rebuilt & ~tstr.bitmask_delta(
        torch.from_numpy(ids[:3].astype(np.int32)),
        torch.ones((3,), dtype=torch.bool), n_words)
    ref = words.copy()
    ref[0] = 0
    ref[1] &= ~np.uint32(1)
    np.testing.assert_array_equal(convert.bitmask_to_numpy(cleared), ref)

    keys = random_keys(np.random.default_rng(1), 3000)
    lin_k = np.asarray(jstr.key_to_chunk_linear(jnp.asarray(keys), CFG,
                                                SCFG))
    pick = np.unique(lin_k[::3])
    jm = jstr.StreamingManager(CFG, SCFG, out_cap=64)
    w2 = np.zeros((n_words,), np.uint32)
    np.bitwise_or.at(w2, pick // 32,
                     np.uint32(1) << (pick % 32).astype(np.uint32))
    jm.bitmask = jnp.asarray(w2)
    got = tstr.mask_keys(torch.from_numpy(keys),
                         convert.bitmask_from_numpy(w2, device="cpu"), TCFG,
                         TSCFG)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jm.alloc_mask_keys(
                                      jnp.asarray(keys))))
    assert (got.numpy() == INVALID_KEY).sum() > (keys == INVALID_KEY).sum()


@pytest.mark.parametrize("cam,part", [((0.0, 0.0, 0.0), 0),
                                      ((0.3, -0.2, 2.0), 1),
                                      ((0.0, 0.0, 2.0), 3)])
def test_select_stream_out_matches_jax(fused, cam, part):
    ts = convert.map_state_from_numpy(fused, device="cpu")
    for cap in (8192, 37):
        ti, tk, tc = tstr.select_stream_out(
            ts, torch.tensor(cam, dtype=torch.float32), part, TCFG, TSCFG,
            cap)
        ji, jk, jc = jstr.select_stream_out(
            fused, jnp.asarray(cam, jnp.float32), part, CFG, SCFG, cap)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        assert int(tc) == int(jc)
    assert int(tc) > 0 or cam[2] == 2.0


def test_insert_blocks_matches_jax(fused):
    """New keys, keys already resident and INVALID padding, f32 payloads:
    the whole map after the insert is bit-equal, and so are the placed
    mask and the insert count."""
    rng = np.random.default_rng(2)
    resident = np.asarray(fused.block_key)
    resident = resident[resident != INVALID_KEY][:40]
    fresh = np.setdiff1d(np.unique(random_keys(rng, 300)), resident)
    fresh = fresh[fresh != INVALID_KEY][:200]
    keys = np.concatenate([fresh, resident,
                           np.full((56,), INVALID_KEY, np.int32)])
    n = len(keys)
    sdf = rng.normal(0.0, 0.03, size=(n, 512)).astype(np.float32)
    w = np.where(rng.random((n, 512)) < 0.3, 0.0,
                 rng.uniform(1, 60, (n, 512))).astype(np.float32)
    col = rng.integers(0, 1 << 24, size=(n, 512)).astype(np.uint32)
    js, jn, jpl = jstr.insert_blocks(fused, jnp.asarray(keys),
                                     jnp.asarray(sdf), jnp.asarray(w),
                                     jnp.asarray(col), CFG)
    ts, tn, tpl = tstr.insert_blocks(
        convert.map_state_from_numpy(fused, device="cpu"),
        torch.from_numpy(keys),
        torch.from_numpy(sdf), torch.from_numpy(w),
        torch.from_numpy(col.view(np.int32)), TCFG)
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(tpl.numpy(), np.asarray(jpl))
    assert_map_equal(ts, js)
    viol = tbm.check_invariants(ts, TCFG)
    assert all(v == 0 for v in viol.values()), viol


@pytest.mark.parametrize("kind", ["native", "python"])
def test_stream_out_then_in_matches_jax(fused, kind):
    """Sync managers on both sides, on one kind of host store
    (:func:`pin_stores`): evict the wall (four sweep parts), then sweep the
    camera across it until everything is back. After each phase the device
    map, the host store's rows and the bitmask are equal to JAX's."""
    jm = jstr.StreamingManager(CFG, SCFG, out_cap=8192)
    tm = tstr.StreamingManager(TCFG, TSCFG, out_cap=8192, device="cpu")
    pin_stores(kind, jm, tm)
    js, ts = fused, convert.map_state_from_numpy(fused, device="cpu")
    origin = np.zeros(3, np.float32)
    for _ in range(SCFG.out_parts):
        js, jn = jm.stream_out(js, origin)
        ts, tn = tm.stream_out(ts, origin)
        assert tn == jn
    assert tm.host_block_count() == jm.host_block_count() > 0
    assert_map_equal(ts, js)
    assert_rows_equal(store_rows(tm.store), store_rows(jm.store))
    np.testing.assert_array_equal(convert.bitmask_to_numpy(tm.bitmask),
                                  np.asarray(jm.bitmask))

    for cx in (-1.0, 0.0, 1.0):
        for cy in (-1.0, 0.0, 1.0):
            near = np.array([cx, cy, 2.0], np.float32)
            for _ in range(32):
                js, jn = jm.stream_in(js, near)
                ts, tn = tm.stream_in(ts, near)
                assert tn == jn
                if jn == 0:
                    break
    assert tm.host_block_count() == 0
    assert tm.blocks_out == tm.blocks_in > 0
    assert_map_equal(ts, js)
    assert int(tm.bitmask.abs().sum()) == 0
    viol = tbm.check_invariants(ts, TCFG)
    assert all(v == 0 for v in viol.values()), viol


@pytest.mark.parametrize("kind", ["native", "python"])
def test_stream_in_refiles_unplaced_blocks(kind):
    """A 32-block chunk into a 16-block pool: 16 land, 16 go back to the
    host store; nothing is lost, and the map equals JAX's (both on one kind
    of host store, :func:`pin_stores`)."""
    tiny = dataclasses.replace(CFG, num_blocks=16, table_size=64)
    blocks = jnp.asarray([[i % 4, (i // 4) % 4, 48 + i // 16]
                          for i in range(32)], jnp.int32)
    keys = np.asarray(jgeom.pack_block_key(blocks, tiny.world_blocks))
    v = np.random.default_rng(0).normal(size=(32, 512)).astype(np.float32)
    col = np.zeros((32, 512), np.uint32)
    jm = jstr.StreamingManager(tiny, SCFG, out_cap=256)
    tm = tstr.StreamingManager(convert.config_from(tiny), TSCFG, out_cap=256,
                               device="cpu")
    pin_stores(kind, jm, tm)
    for m in (jm, tm):
        m.store.file_blocks(keys, v, np.abs(v) + 1.0, col)
    cam = np.array([0.32, 0.32, 8.0], np.float32)
    js = jbm.create(tiny)
    ts = tbm.create(convert.config_from(tiny), device="cpu")
    moved = 0
    for _ in range(4):
        js, _ = jm.stream_in(js, cam)
        ts, n = tm.stream_in(ts, cam)
        moved += n
    assert moved == tm.blocks_in == 16 and tm.host_block_count() == 16
    assert_map_equal(ts, js)
    assert_rows_equal(store_rows(tm.store), store_rows(jm.store))


CAM_T = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5)
SCFG_T = StreamingConfig(enabled=True, chunk_size=0.64, grid_dim=65,
                         radius=3.0, out_parts=4, in_chunks_per_frame=2)
ECFG_T = EngineConfig(
    camera=CAM_T, map=CFG,
    tracker=TrackerConfig(levels=2, max_outer_iter=(4, 3),
                          max_inner_iter=(1, 1), dist_thres=(0.15, 0.15),
                          normal_thres=(0.9, 0.9),
                          angle_trans_thres=(1.0, 1.0),
                          dist_trans_thres=(1.0, 1.0),
                          residual_early_out=(1e-9, 1e-9)),
    filter=FilterConfig(depth_filter=False), streaming=SCFG_T,
    use_trajectory=True)
SCENE_T = Scene(wall_z=2.0, floor_y=None,
                spheres=(Sphere(center=(0.0, 0.0, 1.5), radius=0.3),))


def trajectory_frames():
    """``tests/test_whole_map_streaming.py``'s TestTrajectoryWholeMap run:
    three static frames, then out_parts + 2 empty frames 40 m away."""
    d, c = render_depth(np.eye(4, dtype=np.float32), CAM_T, SCENE_T)
    far = np.eye(4, dtype=np.float32)
    far[0, 3] = 40.0
    empty = (np.zeros_like(d), np.zeros_like(c), far)
    return ([(np.nan_to_num(d, nan=0.0), c, np.eye(4, dtype=np.float32))] * 3
            + [empty] * (SCFG_T.out_parts + 2))


def run_jax(mgr):
    step = jeng.make_step(ECFG_T, with_hint=True, donate=False,
                          with_stream_mask=True)
    state = jeng.create(ECFG_T, initial_pose=np.eye(4))
    for d, c, hint in trajectory_frames():
        state, _ = step(state, jnp.asarray(d), jnp.asarray(c),
                        jnp.asarray(hint), mgr.bitmask)
        state = state._replace(map=mgr.step(state.map,
                                            np.asarray(state.pose)[:3, 3]))
    return state


def run_port(mgr, with_streaming=True):
    tcfg = convert.config_from(ECFG_T)
    state = teng.create(tcfg, initial_pose=np.eye(4), device="cpu")
    for d, c, hint in trajectory_frames():
        state, _ = teng.step(state, torch.from_numpy(d), torch.from_numpy(c),
                             tcfg, pose_hint=hint,
                             stream_bitmask=mgr.bitmask if with_streaming
                             else None)
        if with_streaming:
            state = state._replace(map=mgr.step(state.map,
                                                state.pose.numpy()[:3, 3]))
    return state


@pytest.mark.parametrize("kind", ["sync", "async", "deferred"])
def test_trajectory_whole_map_matches_jax(kind):
    """The streamed GT-trajectory run of both packages, with the in-line
    manager, the async one, and the async one with its host halves held
    until ``flush`` (``defer_host``): the device map after the run, the
    host store's sorted rows and the bitmask words are equal, and the
    async bitmask (delta-updated) equals a host rebuild."""
    if kind == "sync":
        jm = jstr.StreamingManager(CFG, SCFG_T, out_cap=8192)
        tm = tstr.StreamingManager(TCFG, convert.config_from(SCFG_T),
                                   out_cap=8192, device="cpu")
    else:
        defer = kind == "deferred"
        jm = jstr.AsyncStreamingManager(CFG, SCFG_T, out_cap=8192,
                                        defer_host=defer)
        tm = tstr.AsyncStreamingManager(TCFG, convert.config_from(SCFG_T),
                                        out_cap=8192, defer_host=defer,
                                        device="cpu")
    js = run_jax(jm)
    ts = run_port(tm)
    for m in (jm, tm):
        if hasattr(m, "flush"):
            m.flush()
    assert tm.host_block_count() == jm.host_block_count() > 0
    assert_map_equal(ts.map, js.map)
    assert_rows_equal(store_rows(tm.store), store_rows(jm.store))
    words = convert.bitmask_to_numpy(tm.bitmask)
    np.testing.assert_array_equal(words, np.asarray(jm.bitmask))
    rebuilt = tstr.bitmask_from_ids(tm.store.chunk_ids(SCFG_T.grid_dim),
                                    len(words), device="cpu")
    np.testing.assert_array_equal(words, convert.bitmask_to_numpy(rebuilt))
    if kind != "sync":
        tm.close()


def test_async_bitmask_over_trajectory_matches_rebuild(fused):
    """Async manager walking away (evictions only: the words equal JAX's
    async words) and back (stream-in: the words equal a rebuild from the
    store); residents plus hosted blocks stay the original set."""
    jm = jstr.AsyncStreamingManager(CFG, SCFG, out_cap=8192)
    tm = tstr.AsyncStreamingManager(TCFG, TSCFG, out_cap=8192, device="cpu")
    js, ts = fused, convert.map_state_from_numpy(fused, device="cpu")
    n0 = int(np.sum(np.asarray(fused.block_key) != INVALID_KEY))
    for z in np.linspace(1.0, 40.0, 6):
        pos = np.array([0.0, 0.0, -z], np.float32)
        for _ in range(SCFG.out_parts):
            js = jm.step(js, pos)
            ts = tm.step(ts, pos)
    jm.flush()
    tm.flush()
    assert tm.host_block_count() == n0
    np.testing.assert_array_equal(convert.bitmask_to_numpy(tm.bitmask),
                                  np.asarray(jm.bitmask))
    assert_map_equal(ts, js)
    for z in np.linspace(0.0, 2.0, 4):
        for _ in range(12):
            ts = tm.step(ts, np.array([0.0, 0.0, z], np.float32))
    tm.flush()
    assert 0 < tm.host_block_count() < n0
    assert tm.blocks_out - tm.blocks_in == tm.host_block_count()
    n_dev = int(torch.sum(ts.block_key != INVALID_KEY))
    assert n_dev + tm.host_block_count() == n0
    rebuilt = tstr.bitmask_from_ids(tm.store.chunk_ids(SCFG.grid_dim),
                                    tstr.bitmask_words(TSCFG), device="cpu")
    assert torch.equal(tm.bitmask, rebuilt)
    viol = tbm.check_invariants(ts, TCFG)
    assert all(v == 0 for v in viol.values()), viol
    tm.close()


def test_checkpoints_load_across_packages(fused, tmp_path):
    """A checkpoint written by either package loads in the other to the
    same map, bit for bit; with a manager it loads into the host store."""
    pj = os.path.join(tmp_path, "jax.npz")
    pt = os.path.join(tmp_path, "torch.npz")
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    nj = jstr.save_map(pj, fused, CFG, poses=poses)
    nt = tstr.save_map(pt, convert.map_state_from_numpy(fused, device="cpu"),
                       TCFG,
                       poses=poses)
    assert nj == nt > 0
    za, zb = np.load(pj), np.load(pt)
    for f in ("keys", "sdf", "weight", "color", "poses", "version",
              "voxel_size", "world_blocks"):
        assert za[f].dtype == zb[f].dtype, f
        np.testing.assert_array_equal(za[f], zb[f])

    for path in (pj, pt):
        ts, tposes = tstr.load_map(path, TCFG, device="cpu")
        js, _ = jstr.load_map(path, CFG)
        assert_map_equal(ts, js)
        np.testing.assert_array_equal(tposes, poses)
        tm = tstr.StreamingManager(TCFG, TSCFG, device="cpu")
        empty, _ = tstr.load_map(path, TCFG, manager=tm)
        assert int(empty.n_free) == CFG.num_blocks
        assert tm.host_block_count() == nj
        assert_rows_equal(store_rows(tm.store),
                          jstr.resident_rows(fused, CFG))
    with pytest.raises(ValueError, match="geometry"):
        tstr.load_map(pj, dataclasses.replace(TCFG, voxel_size=0.01),
                      device="cpu")


def test_native_store_matches_py_store():
    """Filing, peeking and popping (with a split chunk) give the same rows
    in the C++ store and in ``PyChunkStore``."""
    rng = np.random.default_rng(3)
    keys = np.unique(random_keys(rng, 3000))
    keys = keys[keys != INVALID_KEY]
    n = len(keys)
    sdf = rng.normal(size=(n, 512)).astype(np.float32)
    w = rng.random((n, 512)).astype(np.float32)
    col = rng.integers(0, 1 << 24, (n, 512)).astype(np.uint32)
    stores = [tstr.make_chunk_store(4, 1024),
              tstr.make_chunk_store(4, 1024, native=False)]
    assert isinstance(stores[0], native.NativeChunkStore)
    for s in stores:
        for lo in range(0, n, 997):
            s.file_blocks(keys[lo:lo + 997], sdf[lo:lo + 997],
                          w[lo:lo + 997], col[lo:lo + 997])
    a, b = stores
    assert a.block_count() == b.block_count() == n
    assert a.chunk_count() == b.chunk_count()
    ca, cb = a.chunk_coords(), b.chunk_coords()
    assert sorted(map(tuple, ca.tolist())) == sorted(map(tuple, cb.tolist()))
    assert sorted(a.chunk_ids(65)) == sorted(b.chunk_ids(65))
    sel = cb[::5]
    assert a.peek_count(sel) == b.peek_count(sel)
    assert_rows_equal(a.peek_chunks(sel), b.peek_chunks(sel))
    # every chunk of the sphere pops in one call; the single-chunk call
    # with a small cap splits it
    cam = np.array([0.0, 0.0, 0.0], np.float32)
    ra = a.pop_in_sphere_tracked(cam, 6.0, 0.64, 1 << 20, 1 << 20)
    rb = b.pop_in_sphere_tracked(cam, 6.0, 0.64, 1 << 20, 1 << 20)
    assert len(ra[0]) > 0
    assert_rows_equal(ra[:4], rb[:4])
    assert sorted(map(tuple, ra[4].tolist())) == \
        sorted(map(tuple, rb[4].tolist()))
    assert_rows_equal(store_rows(a), store_rows(b))
    big = sorted(map(tuple, a.chunk_coords().tolist()),
                 key=lambda cc: -a.peek_count(np.asarray(cc)))[0]
    m = a.peek_count(np.asarray(big))
    centre = (np.asarray(big, np.float32) + 0.5) * 0.64
    for s in stores:
        k, *_rest, cleared = s.pop_in_sphere_tracked(centre, 1.2, 0.64, 1,
                                                     m - 1)
        assert len(k) == m - 1 and len(cleared) == 0
        assert s.peek_count(np.asarray(big)) == 1


def test_native_store_raises_when_unbuildable(monkeypatch, tmp_path):
    """No silent fallback: without a compiler the native store raises."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            tstr.make_chunk_store(4, 1024)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            tstr.StreamingManager(TCFG, TSCFG, device="cpu")
    finally:
        native.library.cache_clear()
