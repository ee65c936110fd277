"""Parity of the PyTorch port's meshing (``voxelhashing_tpu_torch.meshing``)
and its ``run_slam`` entry point with ``voxelhashing_tpu.meshing``, on the
JAX tests' 80x60 camera, 2 cm voxels and 8,192-block pool.

Tolerances: ``extract_mesh`` of one map gives the same triangle count and
the triangles (and corner colors) in the JAX order within 1e-6 m; the
streamed whole-scene mesh and checkpoint of a GT-trajectory run equal the
same run unstreamed exactly (sorted triangles, sorted rows); PLY face
counts are equal across the native writer, the numpy writer and the JAX
package's writer.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import (blockmap as jbm, integrate as jinteg,
                              meshing as jmesh)
from voxelhashing_tpu.config import (CameraConfig, EngineConfig, FilterConfig,
                                     MapConfig, MeshConfig, StreamingConfig,
                                     TrackerConfig)
from voxelhashing_tpu.io.synthetic import Scene, Sphere, render_depth
from voxelhashing_tpu_torch import (convert, engine as teng,
                                    meshing as tmesh, native, run_slam,
                                    streaming as tstr)

CAM = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5)
CFG = MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                num_blocks=8192, table_size=32768,
                max_active_blocks=8192, world_blocks=1024)
MESH = MeshConfig()
TCFG = convert.config_from(CFG)
TMESH = convert.config_from(MESH)
SCENES = {
    "wall": Scene(wall_z=2.0, floor_y=None, spheres=()),
    "sphere": Scene(wall_z=3.5, floor_y=None,
                    spheres=(Sphere(center=(0.0, 0.0, 1.5), radius=0.4),)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fused(scene):
    """``tests/test_meshing.py``'s map: three integrations of one frame."""
    depth, color = render_depth(np.eye(4, dtype=np.float32), CAM, scene)
    depth, color = jnp.asarray(depth), jnp.asarray(color)
    state = jbm.create(CFG)
    state, _ = jinteg.allocate_from_depth(state, depth, jnp.eye(4), CAM, CFG)
    for _ in range(3):
        state = jinteg.integrate(state, depth, color, jnp.eye(4), CAM, CFG)
    return state


@pytest.fixture(scope="module")
def sphere_map():
    return fused(SCENES["sphere"])


def tris_sorted(tris):
    flat = np.asarray(tris).reshape(len(tris), -1)
    return flat[np.lexsort(flat.T[::-1])]


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_extract_mesh_matches_jax(scene, sphere_map):
    """Same count; triangles and colors in the JAX order within 1e-6."""
    js = sphere_map if scene == "sphere" else fused(SCENES[scene])
    jt, jc = jmesh.extract_mesh(js, CFG, MESH)
    tt, tc = tmesh.extract_mesh(
        convert.map_state_from_numpy(js, device="cpu"), TCFG,
                                TMESH)
    assert len(jt) > 100 and tt.shape == jt.shape and tt.dtype == np.float32
    np.testing.assert_allclose(tt, jt, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tc, jc, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tris_sorted(tt), tris_sorted(jt), atol=1e-6,
                               rtol=0)


def test_extract_block_range_window_matches_jax(sphere_map):
    """A window of every other allocated block (under the JAX caps) gives
    the JAX triangles and colors, in the JAX order, within 1e-6."""
    ts = convert.map_state_from_numpy(sphere_map, device="cpu")
    idx = torch.arange(CFG.num_blocks, dtype=torch.int32)
    mask = (ts.block_key != jbm.INVALID_KEY) & (idx % 2 == 0)
    got = tmesh.extract_block_range(ts, idx, mask, TCFG, TMESH)
    ref = jmesh.extract_block_range(sphere_map, jnp.asarray(idx.numpy()),
                                    jnp.asarray(mask.numpy()), CFG, MESH)
    n = int(ref.n_triangles)
    assert int(ref.overflow) == 0 and got.n_triangles == n > 100
    np.testing.assert_allclose(got.vertices.numpy(),
                               np.asarray(ref.vertices)[:n], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got.colors.numpy(),
                               np.asarray(ref.colors)[:n], atol=1e-6, rtol=0)


def test_save_ply_face_counts_match(sphere_map, tmp_path):
    """The native writer, the numpy writer and the JAX writer weld the same
    faces; the two port writers' headers agree."""
    tris, cols = jmesh.extract_mesh(sphere_map, CFG, MESH)
    paths = [os.path.join(tmp_path, f"{n}.ply") for n in ("c", "np", "j")]
    n_native = tmesh.save_ply(paths[0], tris, cols)
    n_numpy = tmesh.save_ply(paths[1], tris, cols, native=False)
    n_jax = jmesh.save_ply(paths[2], tris, cols)
    assert n_native == n_numpy == n_jax > 100

    def header(path):
        with open(path, "rb") as f:
            return f.read(400).split(b"end_header")[0]

    assert header(paths[0]) == header(paths[1])
    assert f"element face {n_native}".encode() in header(paths[0])


def test_save_ply_raises_when_unbuildable(monkeypatch, tmp_path):
    """No silent fallback: without a compiler the native writer raises."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    native.library.cache_clear()
    tris = np.zeros((1, 3, 3), np.float32)
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            tmesh.save_ply(os.path.join(tmp_path, "x.ply"), tris)
    finally:
        native.library.cache_clear()


SCFG_T = StreamingConfig(enabled=True, chunk_size=0.64, grid_dim=65,
                         radius=3.0, out_parts=4, in_chunks_per_frame=2)
ECFG_T = convert.config_from(EngineConfig(
    camera=CAM, map=CFG,
    tracker=TrackerConfig(levels=2, max_outer_iter=(4, 3),
                          max_inner_iter=(1, 1), dist_thres=(0.15, 0.15),
                          normal_thres=(0.9, 0.9),
                          angle_trans_thres=(1.0, 1.0),
                          dist_trans_thres=(1.0, 1.0),
                          residual_early_out=(1e-9, 1e-9)),
    filter=FilterConfig(depth_filter=False), streaming=SCFG_T,
    use_trajectory=True))


def run_trajectory(mgr):
    """``tests/test_whole_map_streaming.py``'s TestTrajectoryWholeMap run
    through the port: three frames at the origin, then out_parts + 2
    empty frames 40 m away; streaming when ``mgr`` is given."""
    d, c = render_depth(np.eye(4, dtype=np.float32), CAM,
                        Scene(wall_z=2.0, floor_y=None, spheres=(
                            Sphere(center=(0.0, 0.0, 1.5), radius=0.3),)))
    far = np.eye(4, dtype=np.float32)
    far[0, 3] = 40.0
    frames = ([(np.nan_to_num(d, nan=0.0), c, np.eye(4, dtype=np.float32))]
              * 3 + [(np.zeros_like(d), np.zeros_like(c), far)]
              * (SCFG_T.out_parts + 2))
    state = teng.create(ECFG_T, initial_pose=np.eye(4), device="cpu")
    for d, c, hint in frames:
        state, _ = teng.step(state, torch.from_numpy(d), torch.from_numpy(c),
                             ECFG_T, pose_hint=hint,
                             stream_bitmask=None if mgr is None
                             else mgr.bitmask)
        if mgr is not None:
            state = state._replace(map=mgr.step(state.map,
                                                state.pose.numpy()[:3, 3]))
    return state


@pytest.fixture(scope="module")
def unstreamed():
    return run_trajectory(None)


@pytest.mark.parametrize("async_mgr", [False, True])
def test_streamed_mesh_and_checkpoint_match_unstreamed(unstreamed, async_mgr,
                                                       tmp_path):
    """The streamed run's composed mesh (``extract_mesh_streamed``) and
    checkpoint (``save_map(manager=)``) equal the unstreamed run's
    ``extract_mesh`` and ``save_map``."""
    cls = tstr.AsyncStreamingManager if async_mgr else tstr.StreamingManager
    mgr = cls(ECFG_T.map, ECFG_T.streaming, out_cap=8192, device="cpu")
    state = run_trajectory(mgr)
    try:
        if async_mgr:
            mgr.flush()
        assert mgr.host_block_count() > 0
        ta, _ = tmesh.extract_mesh(unstreamed.map, ECFG_T.map, TMESH)
        tb, _ = tmesh.extract_mesh_streamed(state.map, ECFG_T.map, TMESH,
                                            mgr)
        assert len(ta) > 100
        np.testing.assert_array_equal(tris_sorted(ta), tris_sorted(tb))

        pa = os.path.join(tmp_path, "a.npz")
        pb = os.path.join(tmp_path, "b.npz")
        na = tstr.save_map(pa, unstreamed.map, ECFG_T.map)
        nb = tstr.save_map(pb, state.map, ECFG_T.map, manager=mgr)
        assert na == nb > 0
        za, zb = np.load(pa), np.load(pb)
        oa, ob = np.argsort(za["keys"]), np.argsort(zb["keys"])
        for f in ("keys", "sdf", "weight", "color"):
            np.testing.assert_array_equal(za[f][oa], zb[f][ob])
    finally:
        if async_mgr:
            mgr.close()


def test_run_slam_streaming_mesh_checkpoint(tmp_path, capsys):
    """``python -m voxelhashing_tpu_torch.run_slam`` on the CPU, tiny
    preset, with streaming, a mesh and a checkpoint, ends in RESULT: OK;
    the checkpoint loads back into a second run; ``--device cuda`` without
    a card refuses to run."""
    ply = os.path.join(tmp_path, "m.ply")
    npz = os.path.join(tmp_path, "m.npz")
    rc = run_slam.main(["--frames", "6", "--preset", "tiny", "--device",
                        "cpu", "--streaming", "--mesh", ply, "--save-map",
                        npz])
    out = capsys.readouterr().out
    assert rc == 0 and "RESULT: OK" in out, out
    assert os.path.getsize(ply) > 1000 and "welded faces" in out
    rc = run_slam.main(["--frames", "2", "--preset", "tiny", "--device",
                        "cpu", "--gt", "--load-map", npz])
    out = capsys.readouterr().out
    assert rc == 0 and "RESULT: OK" in out, out
    if not torch.cuda.is_available():
        assert run_slam.main(["--frames", "1"]) == 2
