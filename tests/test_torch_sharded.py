"""Parity of the port's multi-device path (``voxelhashing_tpu_torch.parallel``)
with ``voxelhashing_tpu.parallel`` at D = 2, on the CPU.

The port runs two ranks, spawned processes over gloo (a ``FileStore`` under
``tmp_path``, one torch thread each); JAX runs ``make_sharded_step`` on two
of the virtual CPU devices. Both get the same frames (JAX's synthetic
renderer, numpy) at 80x60 with ``tests/test_sharded.py``'s map and tracker
settings. Tolerances: poses within 1e-4 and the same ``valid`` flags (JAX's
read off its poses: an invalid frame keeps the pose); key ownership exact
and no key on two ranks; each rank's allocated blocks within 0.5% of JAX's
shard; ``gather_map`` with clean invariants holding every rank's blocks;
the sharded march render within ``test_sharded.py``'s bounds (coverage XOR
< 0.5%, depth < 1e-4 m, color < 2/255) of JAX's and of the port's own
single-device render of the merged map. At world size 1 (a gloo group in
this process) the hooks with a group give the same bits as without.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from voxelhashing_tpu import blockmap as jbm
from voxelhashing_tpu.config import (CameraConfig, EngineConfig, FilterConfig,
                                     MapConfig, TrackerConfig)
from voxelhashing_tpu.geometry import INVALID_KEY
from voxelhashing_tpu.io.synthetic import Scene, make_trajectory, render_depth
from voxelhashing_tpu.parallel import sharded as jsh
from voxelhashing_tpu.parallel.streaming import _owner_np as j_owner_np
from voxelhashing_tpu_torch import blockmap as tbm, convert
from voxelhashing_tpu_torch import engine as teng, geometry as tgeom
from voxelhashing_tpu_torch import raycast as trc, tracking as ttr
from voxelhashing_tpu_torch.ops.image import preprocess as tpre
from voxelhashing_tpu_torch.parallel import collectives, distributed
from voxelhashing_tpu_torch.parallel import sharded as tsh
from voxelhashing_tpu_torch.parallel.streaming import _owner_np

CAM = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5)
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
)
RGBD = dataclasses.replace(CFG, tracker=dataclasses.replace(
    CFG.tracker, use_rgbd=True))
N_FRAMES = 4
N_DEV = 2
RANK_TIMEOUT = 240          # seconds for the spawned ranks of one test
POSE_TOL = 1e-4
COUNT_TOL = 0.005
MARCH_BOUNDS = (5e-3, 1e-4, 2 / 255.0)   # tests/test_sharded.py:123-133


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n=N_FRAMES):
    """(poses, depth with NaN as 0, color) as numpy."""
    poses = make_trajectory(n)
    depth, color = [], []
    for p in poses:
        d, c = render_depth(p, CAM, Scene())
        depth.append(np.nan_to_num(d, nan=0.0))
        color.append(c)
    return (np.stack([np.asarray(p, np.float32) for p in poses]),
            np.stack(depth).astype(np.float32),
            np.stack(color).astype(np.float32))


# ---------------------------------------------------------------------------
# JAX: make_sharded_step on two virtual devices
# ---------------------------------------------------------------------------


def _jax_run(cfg, frames, render=False):
    devs = jax.devices()
    if len(devs) < N_DEV:
        pytest.skip("needs 2 virtual devices")
    mesh = jax.sharding.Mesh(np.array(devs[:N_DEV]), ("d",))
    poses, depth, color = frames
    step = jsh.make_sharded_step(cfg, mesh)
    state, lcfg = jsh.create_sharded(cfg, mesh, initial_pose=poses[0])
    # the step's own output placement from the first call on: one compile
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    state = state._replace(pose=jax.device_put(state.pose, rep),
                           frame=jax.device_put(state.frame, rep))
    est = []
    for d, c in zip(depth, color):
        state, pose = step(state, jnp.asarray(d), jnp.asarray(c))
        est.append(np.asarray(pose))
    est = np.stack(est)
    stacked = jax.device_get(state.map)
    out = {"poses": est,
           "valid": [True] + [not np.array_equal(est[i], est[i - 1])
                              for i in range(1, len(est))],
           "keys": [k[k != INVALID_KEY] for k in stacked.block_key]}
    if render:
        res = jsh.make_sharded_render(cfg, mesh)(state, est[-1])
        out["depth"] = np.asarray(res.depth)
        out["color"] = np.asarray(res.color)
    return out


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def jax_depth(frames):
    return _jax_run(CFG, frames, render=True)


@pytest.fixture(scope="module")
def jax_rgbd(frames):
    return _jax_run(RGBD, frames)


# ---------------------------------------------------------------------------
# The port: two spawned ranks
# ---------------------------------------------------------------------------


def _port_rank(rank, tmp, cfgs):
    """One rank: each config in ``cfgs`` ((name, EngineConfig, render)) runs
    the sharded step over the frames in ``tmp/frames.npz``; the first also
    gathers the map and renders. Writes ``tmp/<name>_<rank>.npz``."""
    torch.set_num_threads(1)
    distributed.initialize(f"file://{tmp}/store", N_DEV, rank,
                           backend="gloo")
    f = np.load(os.path.join(tmp, "frames.npz"))
    for name, cfg, render in cfgs:
        state, lcfg = distributed.create_sharded_global(
            cfg, initial_pose=f["poses"][0], device="cpu")
        step = tsh.make_sharded_step(cfg)
        est, valid = [], []
        for d, c in zip(f["depth"], f["color"]):
            state, pose = step(state, distributed.replicate(d, "cpu"),
                               distributed.replicate(c, "cpu"))
            est.append(distributed.fetch_replicated(pose))
            valid.append(state.valid_host)
        keys = state.map.block_key.numpy()
        out = {"poses": np.stack(est), "valid": np.array(valid),
               "keys": keys[keys != INVALID_KEY]}
        if render:
            merged = tsh.gather_map(state, lcfg, cfg.map)
            res = tsh.make_sharded_render(cfg)(state, est[-1])
            out["depth"] = res.depth.numpy()
            out["color"] = res.color.numpy()
            if rank == 0:
                viol = tbm.check_invariants(merged, cfg.map)
                out["violations"] = np.array(list(viol.values()))
                out["merged"] = int(tbm.stats(merged, cfg.map)
                                    ["n_allocated"])
                pose = torch.from_numpy(est[-1])
                aidx, n_act, _ = tbm.compactify(
                    merged, tgeom.invert_rigid(pose), cfg.camera, cfg.map)
                ref = trc.render_march(
                    merged, pose, cfg.camera, cfg.map, cfg.raycast,
                    active_idx=aidx,
                    active_mask=torch.arange(aidx.shape[0]) < n_act)
                out["merged_depth"] = ref.depth.numpy()
                out["merged_color"] = ref.color.numpy()
        np.savez(os.path.join(tmp, f"{name}_{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port(frames, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    poses, depth, color = frames
    np.savez(tmp / "frames.npz", poses=poses, depth=depth, color=color)
    cfgs = (("depth", convert.config_from(CFG), True),
            ("rgbd", convert.config_from(RGBD), False))
    distributed.spawn(_port_rank, N_DEV, (str(tmp), cfgs),
                      timeout=RANK_TIMEOUT)
    return {name: [dict(np.load(tmp / f"{name}_{r}.npz"))
                   for r in range(N_DEV)] for name, _, _ in cfgs}


def _march_close(depth, color, ref_depth, ref_color):
    cov, cov_ref = np.isfinite(depth), np.isfinite(ref_depth)
    both = cov & cov_ref
    assert cov.sum() > 500
    assert (cov ^ cov_ref).mean() < MARCH_BOUNDS[0]
    assert np.abs(depth[both] - ref_depth[both]).max() < MARCH_BOUNDS[1]
    assert np.abs(color[both] - ref_color[both]).max() < MARCH_BOUNDS[2]


@pytest.mark.parametrize("name", ["depth", "rgbd"])
def test_step_matches_jax(name, port, jax_depth, jax_rgbd):
    """Every rank returns the same poses and valid flags, within 1e-4 of
    JAX's sharded step (splat render; depth-only, then RGB-D with the
    color render on every rank and the summed winning colors)."""
    ref = {"depth": jax_depth, "rgbd": jax_rgbd}[name]
    ranks = port[name]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["poses"], ranks[0]["poses"])
        np.testing.assert_array_equal(r["valid"], ranks[0]["valid"])
    assert list(ranks[0]["valid"]) == ref["valid"]
    assert all(ref["valid"])
    np.testing.assert_allclose(ranks[0]["poses"], ref["poses"],
                               atol=POSE_TOL, rtol=0)


@pytest.mark.parametrize("name", ["depth", "rgbd"])
def test_ownership_and_counts_match_jax(name, port, jax_depth, jax_rgbd):
    """Each rank holds only keys it owns (JAX's mix(k) % D), no key is on
    two ranks, and each rank's block count is within 0.5% of JAX's shard
    of the same index."""
    ref = {"depth": jax_depth, "rgbd": jax_rgbd}[name]
    allk = []
    for d, r in enumerate(port[name]):
        keys = r["keys"]
        owner = np.asarray(jbm._mix(jnp.asarray(keys, jnp.uint32))) % N_DEV
        assert (owner == d).all()
        n_ref = len(ref["keys"][d])
        assert abs(len(keys) - n_ref) <= COUNT_TOL * n_ref, (d, len(keys),
                                                              n_ref)
        allk.append(keys)
    flat = np.concatenate(allk)
    assert len(flat) == len(np.unique(flat)) > 200


def test_gather_map_is_clean(port):
    """``gather_map`` merges the shards into a map with clean invariants
    that holds every rank's blocks."""
    r0 = port["depth"][0]
    assert not r0["violations"].any(), r0["violations"]
    assert int(r0["merged"]) == sum(len(r["keys"]) for r in port["depth"])


def test_sharded_render_matches_jax(port, jax_depth):
    """``make_sharded_render`` (summed fetches, min/max tile bounds) is the
    same on both ranks and within test_sharded.py's bounds of JAX's."""
    r0, r1 = port["depth"]
    np.testing.assert_array_equal(r0["depth"], r1["depth"])
    np.testing.assert_array_equal(r0["color"], r1["color"])
    _march_close(r0["depth"], r0["color"], jax_depth["depth"],
                 jax_depth["color"])


def test_sharded_render_matches_merged_map(port):
    """The sharded march equals the single-device march of the merged map
    within the same bounds (the halo-free global sampling)."""
    r0 = port["depth"][0]
    _march_close(r0["depth"], r0["color"], r0["merged_depth"],
                 r0["merged_color"])


def test_partition_helpers_match_jax():
    """The partition hash, its host twin, the per-rank capacity and the
    row split agree with JAX's (its row slice where D divides the
    height; every row goes to a rank otherwise)."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 30, size=5000).astype(np.int32)
    keys[::9] = INVALID_KEY
    for n_dev in (2, 3, 8):
        ref = np.asarray(jbm._mix(jnp.asarray(keys, jnp.uint32))) % n_dev
        got = tsh.owner(torch.from_numpy(keys), n_dev).numpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(_owner_np(keys, n_dev),
                                      j_owner_np(keys, n_dev))
        for r in range(n_dev):
            owned = tsh._owned(torch.from_numpy(keys), r, n_dev).numpy()
            np.testing.assert_array_equal(
                owned, np.where((ref == r) & (keys != INVALID_KEY), keys,
                                INVALID_KEY))
        assert convert.config_from(jsh.local_map_config(CFG.map, n_dev)) \
            == tsh.local_map_config(convert.config_from(CFG.map), n_dev)
    rows = [tsh.row_range(60, r, 2) for r in range(2)]
    assert rows == [(0, 30), (30, 60)]
    parts = torch.tensor_split(torch.arange(61), 3)
    assert [tsh.row_range(61, r, 3) for r in range(3)] == [
        (int(p[0]), int(p[-1]) + 1) for p in parts]


# ---------------------------------------------------------------------------
# Hooks at world size 1: a gloo group in this process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    store = tmp_path_factory.mktemp("one_rank") / "store"
    distributed.initialize(f"file://{store}", 1, 0, backend="gloo")
    yield collectives.resolve(None)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def small_map(frames):
    """A port map fused from frames 0-1 by the single-device step."""
    tcfg = convert.config_from(CFG)
    poses, depth, color = frames
    es = teng.create(tcfg, initial_pose=poses[0], device="cpu")
    for d, c in zip(depth[:2], color[:2]):
        es, _ = teng.step(es, torch.from_numpy(d), torch.from_numpy(c),
                          tcfg)
    return tcfg, es


def _assert_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.reshape(-1).numpy().view(np.uint8),
                                  b.reshape(-1).numpy().view(np.uint8))


@pytest.mark.parametrize("rgbd", [False, True])
def test_track_reduce_fn_world_size_1(rgbd, one_rank, frames):
    """``track(reduce_fn=sum over the group)`` at world size 1 gives the
    bits of ``track()`` (depth-only with the planarity gate, and RGB-D
    with both systems in one reduction)."""
    tcfg = convert.config_from(RGBD if rgbd else CFG)
    poses, depth, color = frames
    f0 = tpre(torch.from_numpy(depth[0]), torch.from_numpy(color[0]), CAM,
              tcfg.filter)
    f1 = tpre(torch.from_numpy(depth[1]), torch.from_numpy(color[1]), CAM,
              tcfg.filter)
    kw = {}
    if rgbd:
        kw = dict(input_intensity=f1.intensity,
                  model_intensity=f0.intensity,
                  weight_color=tcfg.tracker.weight_color)
    calls = collectives.all_reduce.calls
    plain = ttr.track(f1.points, f1.normals, f0.points, f0.normals,
                      torch.from_numpy(poses[0]), tcfg.camera,
                      tcfg.tracker, **kw)
    grouped = ttr.track(f1.points, f1.normals, f0.points, f0.normals,
                        torch.from_numpy(poses[0]), tcfg.camera,
                        tcfg.tracker,
                        reduce_fn=lambda s: collectives.sum_tuple(
                            s, one_rank), **kw)
    assert collectives.all_reduce.calls > calls
    assert bool(plain.valid)
    for a, b in zip(plain, grouped):
        _assert_bits(a, b)


def test_gather_voxels_and_march_group_world_size_1(one_rank, small_map):
    """``gather_voxels_soa(group=)`` and ``render_march(group=)`` at world
    size 1 give the bits of the calls without a group."""
    tcfg, es = small_map
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.integers(-80, 80, size=(3, 4000))
                         .astype(np.int32))
    for color in (False, True):
        a = tbm.gather_voxels_soa(es.map, *v, tcfg.map, with_color=color)
        b = tbm.gather_voxels_soa(es.map, *v, tcfg.map, with_color=color,
                                  group=one_rank)
        for x, y in zip(a, b):
            if x is None:
                assert y is None
            else:
                _assert_bits(x, y)
    view = tgeom.invert_rigid(es.pose)
    aidx, n_act, _ = tbm.compactify(es.map, view, CAM, tcfg.map)
    mask = torch.arange(aidx.shape[0]) < n_act
    rc = dataclasses.replace(tcfg.raycast, use_gradients=True)
    a = trc.render_march(es.map, es.pose, CAM, tcfg.map, rc,
                         active_idx=aidx, active_mask=mask)
    b = trc.render_march(es.map, es.pose, CAM, tcfg.map, rc,
                         active_idx=aidx, active_mask=mask, group=one_rank)
    assert int(torch.isfinite(a.depth).sum()) > 500
    for x, y in zip(a, b):
        _assert_bits(x, y)


def test_parallel_imports_no_jax():
    """The multi-device path imports neither jax nor the JAX package."""
    code = ("import sys\n"
            "import voxelhashing_tpu_torch.parallel.sharded\n"
            "import voxelhashing_tpu_torch.parallel.distributed\n"
            "import voxelhashing_tpu_torch.parallel.streaming\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'voxelhashing_tpu' or "
            "m.startswith('voxelhashing_tpu.')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)
