"""The port's own configuration, synthetic frames and ATE against the JAX
package's, and the import rule of ``chip_smoke.py``.

Tolerances: config fields and defaults identical; trajectories and ATE
exact. Rendered depth within rtol 1e-5 and color exact on the pixels both
renderers cover, coverage identical apart from at most 1e-4 of the pixels:
the two libraries sum the ray products in another order, and the sphere
root ``(-b - sqrt(b^2 - 4ac)) / 2a`` cancels, which turns an ulp there into
a few ulps of depth (or flips a ray grazing a rim). The same holds for the
box scenes (slab intersections); the Kinect noise model and the stress
scenes are the same numpy and agree exactly.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelhashing_tpu import config as jcfg, evaluation
from voxelhashing_tpu.io import synthetic as jsyn
from voxelhashing_tpu_torch import config as tcfg, convert, evaluation as tev
from voxelhashing_tpu_torch.io import synthetic as tsyn

CLASSES = ("CameraConfig", "MapConfig", "TrackerConfig", "RaycastConfig",
           "FilterConfig", "StreamingConfig", "MeshConfig", "EngineConfig")


@pytest.mark.parametrize("name", CLASSES)
def test_config_fields_mirror_jax(name):
    """Every field the port keeps has the JAX name, default and type; the
    constants agree."""
    jfields = {f.name: f for f in dataclasses.fields(getattr(jcfg, name))}
    for f in dataclasses.fields(getattr(tcfg, name)):
        jf = jfields[f.name]
        assert f.type == jf.type, f.name
        if f.default is dataclasses.MISSING:
            assert (convert.config_from(jf.default_factory())
                    == f.default_factory()), f.name
        else:
            assert f.default == jf.default, f.name
    assert tcfg.SDF_BLOCK_SIZE == jcfg.SDF_BLOCK_SIZE
    assert tcfg.VOXELS_PER_BLOCK == jcfg.VOXELS_PER_BLOCK


def test_config_from_converts_and_refuses_unported():
    cfg = jcfg.EngineConfig(
        camera=jcfg.CameraConfig(width=160, height=120),
        map=jcfg.MapConfig(num_blocks=4096, alloc_insert_small=64),
        streaming=jcfg.StreamingConfig(enabled=True, chunk_size=2.0,
                                       radius=3.4, out_parts=8),
        mesh=jcfg.MeshConfig(max_triangles=10, thresh_factor=4.0),
        offline=False)
    out = convert.config_from(cfg)
    assert isinstance(out, tcfg.EngineConfig)
    assert isinstance(out.map, tcfg.MapConfig)
    assert isinstance(out.streaming, tcfg.StreamingConfig)
    assert isinstance(out.mesh, tcfg.MeshConfig)
    assert out.camera.width == 160 and out.map.num_blocks == 4096
    assert out.offline is False
    assert out.map.block_size_world == cfg.map.block_size_world
    assert dataclasses.asdict(out.streaming) == dataclasses.asdict(
        cfg.streaming)
    assert dataclasses.asdict(out.mesh) == dataclasses.asdict(cfg.mesh)
    # the march renderer's and RGB-D tracking's fields convert
    rc = jcfg.RaycastConfig(mode="march", num_samples=8, use_gradients=True,
                            refine_trilinear=True, splat_tile=4)
    tk = jcfg.TrackerConfig(use_rgbd=True, weight_color=0.5,
                            color_sigma=0.2)
    out = convert.config_from(dataclasses.replace(cfg, raycast=rc,
                                                  tracker=tk))
    assert dataclasses.asdict(out.raycast) == dataclasses.asdict(rc)
    assert dataclasses.asdict(out.tracker) == dataclasses.asdict(tk)
    assert out.raycast.derived(out.map) == rc.derived(cfg.map)
    # a field the port does not have is refused unless at its default
    future = dataclasses.make_dataclass(
        "MeshConfig", [("max_triangles", int, 10), ("future_knob", int, 0)])
    assert convert.config_from(future()) == tcfg.MeshConfig(max_triangles=10)
    with pytest.raises(ValueError, match="not ported"):
        convert.config_from(future(future_knob=1))


def test_trajectory_and_ate_match():
    tp, jp = tsyn.make_trajectory(12), jsyn.make_trajectory(12)
    for a, b in zip(tp, jp):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    est = [p.copy() for p in jp]
    for i, p in enumerate(est):
        p[:3, 3] += np.float32(0.001 * i)
    assert (tev.ate_rmse(est, jp, align=False)
            == evaluation.ate_rmse(est, jp, align=False) > 0)
    assert tev.ate_rmse([torch.from_numpy(p) for p in est], jp,
                        align=False) == tev.ate_rmse(est, jp, align=False)


PARAMETER_TEXT = """// reference-style parameter file
s_adapterWidth = 160;
s_adapterHeight = 120;
s_sensorDepthMax = 4.5f;
s_SDFVoxelSize = 0.008f; // metres
s_SDFTruncation = 0.03f;
s_SDFIntegrationWeightMax = 128;
s_hashNumSDFBlocks = 12345;
s_hashNumBuckets = 1000;
s_garbageCollectionEnabled = false;
s_SDFRayIncrementFactor = 0.7f;
s_SDFUseGradients = true;
s_depthFilter = false;
s_maxLevels = 2;
s_maxOuterIter[0] = 12;
s_maxOuterIter[1] = 7;
s_distThres[0] = 0.2f;
s_weightsColor[0] = 0.25f;
s_streamingEnabled = true;
s_streamingVoxelExtents = 1.0f 1.0f 1.0f;
s_streamingGridDimensions = 513 513 513;
s_streamingOutParts = 40;
s_marchingCubesMaxNumTriangles = 9000000;
s_offlineProcessing = false;
s_name = "hello world";
"""


def test_parameter_files_match_jax():
    """``parse_parameter_file`` and ``engine_config_from_parameters`` give
    JAX's dict and JAX's config (converted) on an inline parameter file
    (vector indices, f suffixes, vec3 values, strings, booleans,
    comments), on a capacity-only dict and on an empty one."""
    got = tcfg.parse_parameter_file(PARAMETER_TEXT)
    ref = jcfg.parse_parameter_file(PARAMETER_TEXT)
    assert got == ref
    assert got["s_streamingGridDimensions"] == [513, 513, 513]
    assert got["s_maxOuterIter"] == [12, 7] and got["s_name"] == \
        "hello world"
    for params in (got, {"s_hashNumSDFBlocks": 12345,
                         "s_hashNumBuckets": 1000}, {}):
        assert tcfg.engine_config_from_parameters(params) == \
            convert.config_from(jcfg.engine_config_from_parameters(params))
    cfg = tcfg.engine_config_from_parameters(got)
    assert (cfg.camera.width, cfg.map.num_blocks, cfg.tracker.levels,
            cfg.streaming.grid_dim, cfg.offline) == (160, 12345, 2, 513,
                                                     False)
    ts = cfg.map.table_size
    assert ts >= 2 * 12345 and ts & (ts - 1) == 0
    base = tcfg.EngineConfig(camera=tcfg.CameraConfig(width=80, height=60))
    assert tcfg.engine_config_from_parameters({}, base) == \
        convert.config_from(jcfg.engine_config_from_parameters(
            {}, jcfg.EngineConfig(camera=jcfg.CameraConfig(width=80,
                                                           height=60))))


@pytest.mark.parametrize("frame,noise", [(0, 0.0), (7, 0.002)])
def test_render_depth_matches_numpy(frame, noise):
    cam = jcfg.CameraConfig(width=96, height=72, fx=79.0, fy=79.0, cx=47.5,
                            cy=35.5)
    spheres = ((0.0, 0.2, 1.8, 0.3), (-0.5, -0.2, 2.0, 0.25),
               (0.6, 0.1, 1.5, 0.2))
    jscene = jsyn.Scene(spheres=tuple(
        jsyn.Sphere(center=s[:3], radius=s[3]) for s in spheres))
    tscene = tsyn.Scene(spheres=tuple(
        tsyn.Sphere(center=s[:3], radius=s[3]) for s in spheres))
    pose = jsyn.make_trajectory(frame + 1)[frame]
    dj, cj = jsyn.render_depth(pose, cam, jscene, noise_sigma=noise,
                               seed=frame)
    dt, ct = tsyn.render_depth(pose, convert.config_from(cam), tscene,
                               noise_sigma=noise, seed=frame, device="cpu")
    dt, ct = dt.numpy(), ct.numpy()
    assert dt.dtype == np.float32 and dt.shape == dj.shape
    cover_t, cover_j = np.isfinite(dt), np.isfinite(dj)
    assert (cover_t != cover_j).mean() <= 1e-4
    both = cover_t & cover_j
    assert both.mean() > 0.9
    np.testing.assert_allclose(dt[both], dj[both], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(ct[both], cj[both])


@pytest.mark.parametrize("scene", ["clutter", "wall_only"])
def test_stress_scenes_render_and_noise_match(scene):
    """``clutter_scene`` (boxes in front of spheres) and
    ``wall_only_scene`` render as in numpy (the bounds above), and
    ``kinect_noise`` and ``make_sequence`` agree."""
    cam = jcfg.CameraConfig(width=96, height=72, fx=79.0, fy=79.0, cx=47.5,
                            cy=35.5)
    tcam = convert.config_from(cam)
    jscene = getattr(jsyn, f"{scene}_scene")()
    tscene = getattr(tsyn, f"{scene}_scene")()
    assert dataclasses.asdict(tscene) == dataclasses.asdict(jscene)
    pose = jsyn.make_trajectory(4)[3]
    dj, cj = jsyn.render_depth(pose, cam, jscene)
    dt, ct = tsyn.render_depth(pose, tcam, tscene, device="cpu")
    dt, ct = dt.numpy(), ct.numpy()
    cover_t, cover_j = np.isfinite(dt), np.isfinite(dj)
    assert (cover_t != cover_j).mean() <= 1e-4
    both = cover_t & cover_j
    np.testing.assert_allclose(dt[both], dj[both], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(ct[both], cj[both])
    if scene == "clutter":
        box_color = np.asarray(jscene.boxes[0].color, np.float32)
        assert (ct == box_color).all(axis=-1).sum() > 100   # boxes render
    np.testing.assert_array_equal(tsyn.kinect_noise(dj, tcam, seed=5),
                                  jsyn.kinect_noise(dj, cam, seed=5))
    sd, sc, sp = tsyn.make_sequence(3, tcam, tscene, noise_sigma=0.002,
                                    device="cpu")
    jd, jc, jp = jsyn.make_sequence(3, cam, jscene, noise_sigma=0.002)
    assert sd.shape == jd.shape and sc.shape == jc.shape
    for a, b in zip(sp, jp):
        np.testing.assert_array_equal(a, b)
    fin = np.isfinite(sd.numpy()) & np.isfinite(jd)
    np.testing.assert_allclose(sd.numpy()[fin], jd[fin], rtol=1e-5, atol=0)


def test_chip_smoke_imports_only_the_port():
    """``chip_smoke.py`` imports neither JAX nor the JAX package, at the top
    or inside a function."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "voxelhashing_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "voxelhashing_tpu"}, roots


def _entry_points(tmp_path):
    """Each public function of the port that builds tensors from nothing,
    as a call that takes ``**device_kwargs``."""
    from voxelhashing_tpu import blockmap as jbm, engine as jeng
    from voxelhashing_tpu_torch import blockmap as tbm, engine as teng
    from voxelhashing_tpu_torch import posegraph as tpg
    from voxelhashing_tpu_torch import streaming as tstr
    from voxelhashing_tpu_torch.parallel import distributed as tdist
    from voxelhashing_tpu_torch.parallel import sharded as tsh
    from voxelhashing_tpu_torch.parallel import streaming as tpst

    jmap = jcfg.MapConfig(num_blocks=64, table_size=256,
                          max_active_blocks=64)
    mp = convert.config_from(jmap)
    ecfg = tcfg.EngineConfig(map=mp)
    scfg = tcfg.StreamingConfig(enabled=True)
    cam = tcfg.CameraConfig(width=32, height=24, fx=26.0, fy=26.0, cx=15.5,
                            cy=11.5)
    ckpt = str(tmp_path / "map.npz")
    tstr.save_map(ckpt, tbm.create(mp, device="cpu"), mp)

    def managers(cls):
        def make(**kw):
            m = cls(mp, scfg, out_cap=16, **kw)
            if hasattr(m, "close"):
                m.close()
            return m
        return make

    return {
        "engine.create": lambda **kw: teng.create(ecfg, **kw),
        "blockmap.create": lambda **kw: tbm.create(mp, **kw),
        "StreamingManager": managers(tstr.StreamingManager),
        "AsyncStreamingManager": managers(tstr.AsyncStreamingManager),
        "load_map": lambda **kw: tstr.load_map(ckpt, mp, **kw),
        "bitmask_from_ids": lambda **kw: tstr.bitmask_from_ids(
            np.array([3, 70]), 4, **kw),
        "map_state_from_numpy": lambda **kw: convert.map_state_from_numpy(
            jbm.create(jmap), **kw),
        "bitmask_from_numpy": lambda **kw: convert.bitmask_from_numpy(
            np.array([1, 2 ** 31], np.uint32), **kw),
        "engine_state_from_numpy": lambda **kw:
            convert.engine_state_from_numpy(
                jeng.create(jcfg.EngineConfig(map=jmap)), **kw),
        "render_depth": lambda **kw: tsyn.render_depth(
            np.eye(4, dtype=np.float32), cam, tsyn.Scene(), **kw),
        "make_sequence": lambda **kw: tsyn.make_sequence(2, cam, **kw),
        "PoseGraph": lambda **kw: tpg.PoseGraph(cam, **kw).device,
        "create_sharded": lambda **kw: tsh.create_sharded(ecfg, **kw)[0].map,
        "ShardedStreamingManager": lambda **kw: tpst.ShardedStreamingManager(
            mp, scfg, out_cap=16, **kw),
        "sharded_state_from_numpy": lambda **kw:
            convert.sharded_state_from_numpy(_one_device_sharded(jmap), 0,
                                             **kw).map,
        "rank_device": lambda **kw: tdist.rank_device(0, **kw),
    }


def _one_device_sharded(jmap):
    """A JAX ``ShardedState`` on a mesh of one device."""
    import jax
    from voxelhashing_tpu.parallel import sharded as jsh
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("d",))
    return jsh.create_sharded(jcfg.EngineConfig(map=jmap), mesh)[0]


ENTRY_POINTS = ("engine.create", "blockmap.create", "StreamingManager",
                "AsyncStreamingManager", "load_map", "bitmask_from_ids",
                "map_state_from_numpy", "bitmask_from_numpy",
                "engine_state_from_numpy", "render_depth", "make_sequence",
                "PoseGraph", "create_sharded", "ShardedStreamingManager",
                "sharded_state_from_numpy", "rank_device")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(name, tmp_path, monkeypatch):
    """Without a device an entry point builds on the card; without a card
    it raises and names ``device="cpu"``, and never carries on on the CPU.
    With ``device="cpu"`` it works."""
    call = _entry_points(tmp_path)[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call(device=None)
    out = call(device="cpu")
    tensors = [t for t in (out if isinstance(out, tuple) else (out,))
               if isinstance(t, torch.Tensor)]
    for t in tensors + [getattr(out, "bitmask", None)]:
        if t is not None:
            assert t.device.type == "cpu"
    if isinstance(out, torch.device):
        assert out.type == "cpu"
    assert tcfg.resolve_device("cpu") == torch.device("cpu")
