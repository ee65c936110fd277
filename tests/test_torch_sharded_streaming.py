"""Parity of the port's ``ShardedStreamingManager``
(``voxelhashing_tpu_torch.parallel.streaming``) with the JAX package's, at
D = 2, on the CPU.

One JAX sharded state, fused by ``make_sharded_step(with_stream_mask=True)``
on two virtual devices (80x60 frames, 2 cm voxels, a 16,384-block map:
8,192 per rank), is converted rank by rank (``convert.
sharded_state_from_numpy``) into two spawned gloo ranks. Both packages then
run the same sequence: four ``stream_out`` sweeps around (0, 0, 1.6), two
``stream_in`` calls and one ``step`` around (0.6, 0, 2.4), then
``stream_out_all`` (and ``alloc_mask_keys`` after it) and
``stream_in_all``.
After each call everything is compared bit for bit: every field of each
shard, the host store's sorted rows (the evicted keys and payloads), the
counts returned and the eviction bitmask words (``convert.
bitmask_to_numpy``). Both managers use one kind of host store, so that
their pop orders agree.
"""

import hashlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from voxelhashing_tpu import streaming as jstr
from voxelhashing_tpu.blockmap import MapState as JMapState
from voxelhashing_tpu.config import (CameraConfig, EngineConfig, FilterConfig,
                                     MapConfig, StreamingConfig,
                                     TrackerConfig)
from voxelhashing_tpu.geometry import INVALID_KEY
from voxelhashing_tpu.io.synthetic import Scene, make_trajectory, render_depth
from voxelhashing_tpu.parallel import sharded as jsh
from voxelhashing_tpu.parallel.streaming import (ShardedStreamingManager as
                                                 JManager)
from voxelhashing_tpu_torch import convert, streaming as tstr
from voxelhashing_tpu_torch.parallel import distributed
from voxelhashing_tpu_torch.parallel.streaming import ShardedStreamingManager

CAM = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5)
SCFG = StreamingConfig(enabled=True, radius=1.2, chunk_size=0.32,
                       out_parts=4, in_chunks_per_frame=8)
CFG = EngineConfig(
    camera=CAM,
    map=MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                  num_blocks=16384, table_size=65536,
                  max_active_blocks=16384),
    tracker=TrackerConfig(levels=2, max_outer_iter=(6, 4),
                          max_inner_iter=(1, 1),
                          dist_thres=(0.15, 0.15), normal_thres=(0.9, 0.9),
                          angle_trans_thres=(1.0, 1.0),
                          dist_trans_thres=(1.0, 1.0),
                          residual_early_out=(1e-9, 1e-9)),
    filter=FilterConfig(depth_filter=False),
    streaming=SCFG,
)
N_DEV = 2
OUT_CAP = 512
CAM_POS = [0.0, 0.0, 1.6]      # the sweeps evict the far wall
IN_POS = [0.6, 0.0, 2.4]       # the stream-ins take part of it back
# the calls both packages make, in order
SEQUENCE = (("out", 4), ("in", 2), ("step", 1), ("out_all", 1),
            ("in_all", 1))
RANK_TIMEOUT = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _map_digests(fields: dict) -> dict:
    """sha256 of each map field's bytes (bf16 and uint32 as stored)."""
    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in fields.items()}


def _store_rows(store):
    """The store's rows sorted by key (keys, sdf, weight, color)."""
    keys, sdf, w, c = store.peek_chunks(store.chunk_coords())
    o = np.argsort(keys, kind="stable")
    return (np.asarray(keys)[o], np.asarray(sdf)[o], np.asarray(w)[o],
            np.asarray(c, np.uint32)[o])


def _calls():
    for kind, n in SEQUENCE:
        for i in range(n):
            yield f"{kind}{i}", kind


@pytest.fixture(scope="module")
def jax_side():
    """The fused JAX state and the JAX manager's results after each call:
    {"state": leaves, "steps": [(name, count, shard digests, store rows,
    bitmask)], "native": bool}."""
    devs = jax.devices()
    if len(devs) < N_DEV:
        pytest.skip("needs 2 virtual devices")
    mesh = jax.sharding.Mesh(np.array(devs[:N_DEV]), ("d",))
    poses = make_trajectory(2)
    step = jsh.make_sharded_step(CFG, mesh, with_stream_mask=True)
    state, lcfg = jsh.create_sharded(CFG, mesh, initial_pose=poses[0])
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    state = state._replace(pose=jax.device_put(state.pose, rep),
                           frame=jax.device_put(state.frame, rep))
    mgr = JManager(CFG.map, SCFG, mesh, out_cap=OUT_CAP)
    for p in poses:
        d, c = render_depth(p, CAM, Scene())
        state, _ = step(state, jnp.asarray(np.nan_to_num(d, nan=0.0)),
                        jnp.asarray(c), mgr.bitmask)
    leaves = {f: np.asarray(getattr(jax.device_get(state.map), f))
              for f in JMapState._fields}
    fused = {"map": leaves, "pose": np.asarray(state.pose),
             "frame": np.asarray(state.frame)}
    native = not isinstance(mgr.store, jstr.PyChunkStore)
    # allocated keys of both shards and free ones: the mask probe
    keys = leaves["block_key"].reshape(-1)
    probe = np.concatenate([keys[keys != INVALID_KEY][:200],
                            np.arange(5000, 5100, dtype=np.int32)])
    smap, steps = state.map, []
    for name, kind in _calls():
        count = 0
        if kind == "out":
            smap, count = mgr.stream_out(smap, CAM_POS)
        elif kind == "in":
            smap, count = mgr.stream_in(smap, IN_POS)
        elif kind == "step":
            smap = mgr.step(state._replace(map=smap), IN_POS).map
        elif kind == "out_all":
            smap = mgr.stream_out_all(smap)
            masked = np.asarray(mgr.alloc_mask_keys(jnp.asarray(probe)))
        else:
            smap = mgr.stream_in_all(smap)
        st = jax.device_get(smap)
        shards = [_map_digests({f: np.asarray(getattr(st, f))[d]
                                for f in JMapState._fields})
                  for d in range(N_DEV)]
        steps.append((name, int(count), shards, _store_rows(mgr.store),
                      np.asarray(mgr.bitmask, np.uint32)))
    return {"state": fused, "steps": steps, "native": native,
            "probe": probe, "masked": masked}


def _port_rank(rank, tmp, native):
    """One rank: the JAX state of ``tmp/state.npz`` converted, then the
    calls of :data:`SEQUENCE`; writes ``tmp/rank<r>.npz``."""
    torch.set_num_threads(1)
    distributed.initialize(f"file://{tmp}/store", N_DEV, rank,
                           backend="gloo")
    z = np.load(os.path.join(tmp, "state.npz"))
    ss = jsh.ShardedState(
        map=JMapState(*(z[f] for f in JMapState._fields)),
        pose=z["pose"], frame=z["frame"])
    state = convert.sharded_state_from_numpy(ss, rank, device="cpu")
    back = convert.sharded_state_to_numpy([state])
    out = {"round_trip": np.array([_map_digests({k: v[0] for k, v in
                                                 back["map"].items()})
                                   == _map_digests(
                                       {f: z[f][rank] for f in
                                        JMapState._fields})]),
           "frame_host": np.array(state.frame_host)}
    tcfg = convert.config_from(CFG)
    mgr = ShardedStreamingManager(tcfg.map, tcfg.streaming, out_cap=OUT_CAP,
                                  device="cpu")
    if rank == 0:
        mgr.store = tstr.make_chunk_store(mgr._bpc, tcfg.map.world_blocks,
                                          native=native)
    smap = state.map
    for name, kind in _calls():
        count = 0
        if kind == "out":
            smap, count = mgr.stream_out(smap, CAM_POS)
        elif kind == "in":
            smap, count = mgr.stream_in(smap, IN_POS)
        elif kind == "step":
            smap = mgr.step(state._replace(map=smap), IN_POS).map
        elif kind == "out_all":
            smap = mgr.stream_out_all(smap)
            out["masked"] = mgr.alloc_mask_keys(
                torch.from_numpy(z["probe"])).numpy()
        else:
            smap = mgr.stream_in_all(smap)
        fields = convert.map_state_to_numpy(smap)
        digests = _map_digests(fields)
        out[f"{name}_count"] = np.array(count)
        out[f"{name}_shard"] = np.array([digests[f]
                                         for f in JMapState._fields])
        out[f"{name}_bitmask"] = convert.bitmask_to_numpy(mgr.bitmask)
        if rank == 0:
            for i, a in enumerate(_store_rows(mgr.store)):
                out[f"{name}_store{i}"] = a
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_streaming")
    st = jax_side["state"]
    # bf16 pool rows travel as their int16 bits
    leaves = {f: (v.view(np.int16) if str(v.dtype) == "bfloat16" else v)
              for f, v in st["map"].items()}
    np.savez(tmp / "state.npz", pose=st["pose"], frame=st["frame"],
             probe=jax_side["probe"], **leaves)
    distributed.spawn(_port_rank, N_DEV, (str(tmp), jax_side["native"]),
                      timeout=RANK_TIMEOUT)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N_DEV)]


def test_convert_round_trip(port_side, jax_side):
    """Each rank's converted shard converts back to JAX's leaves bit for
    bit, and carries the frame counter."""
    for r in port_side:
        assert bool(r["round_trip"][0])
        assert int(r["frame_host"]) == int(jax_side["state"]["frame"]) == 2


@pytest.mark.parametrize("name", [n for n, _ in _calls()])
def test_manager_matches_jax(name, port_side, jax_side):
    """After each call: the same count on every rank and in JAX, every
    shard field bit for bit, the store's sorted rows (the evicted keys and
    payloads) and the bitmask words."""
    i = [s[0] for s in jax_side["steps"]].index(name)
    _, count, shards, store, bitmask = jax_side["steps"][i]
    for d, r in enumerate(port_side):
        assert int(r[f"{name}_count"]) == count
        np.testing.assert_array_equal(
            r[f"{name}_shard"],
            np.array([shards[d][f] for f in JMapState._fields]),
            err_msg=f"rank {d} fields {JMapState._fields}")
        np.testing.assert_array_equal(r[f"{name}_bitmask"], bitmask)
    for k, a in enumerate(store):
        got = port_side[0][f"{name}_store{k}"]
        assert got.dtype == a.dtype, (got.dtype, a.dtype)
        np.testing.assert_array_equal(got, a)
    if name == "out_all0":
        assert len(store[0]) > 300 and not any(
            int(r[f"{name}_count"]) for r in port_side)
    if name == "in_all0":
        assert len(store[0]) == 0


def test_alloc_mask_keys_matches_jax(port_side, jax_side):
    """After ``stream_out_all`` the bitmask drops every evicted key from
    allocation and keeps the others, as JAX's does."""
    ref = jax_side["masked"]
    for r in port_side:
        np.testing.assert_array_equal(r["masked"], ref)
    assert (ref[:200] == INVALID_KEY).all() and (ref != INVALID_KEY).any()


def test_sequence_moves_blocks(jax_side):
    """The sweeps evict blocks and the stream-ins bring some back, so the
    comparisons above cover both directions."""
    counts = {name: count for name, count, *_ in jax_side["steps"]}
    assert sum(counts[f"out{i}"] for i in range(4)) > 0
    assert sum(counts[f"in{i}"] for i in range(2)) > 0
