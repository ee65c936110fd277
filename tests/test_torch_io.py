"""Parity of the PyTorch port's recorded-sequence input (``io/sensfile``,
``io/tum``, ``io/binarydump``, ``io/network``, the native OCCI codec) and
of ``run_slam``'s sources and flags with the JAX package's.

Tolerance: exact. Both packages write the same bytes (``.sens`` with each
of the three depth codecs, ``.sensor`` dumps, TUM conversions), each reads
the other's files into bit-equal arrays, the native OCCI codec equals the
numpy one, and frames cross the network protocol in both directions
unchanged. ``run_slam.main`` replays a ``.sens`` file it did not write
through the pose graph and re-integration to ``RESULT: OK``.
"""

import ast
import contextlib
import dataclasses
import io
import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelhashing_tpu.config import CameraConfig
from voxelhashing_tpu.io import binarydump as jdump, network as jnet
from voxelhashing_tpu.io import sensfile as jsens, tum as jtum
from voxelhashing_tpu.io.synthetic import Scene, make_trajectory, render_depth
from voxelhashing_tpu_torch import convert, native, run_slam
from voxelhashing_tpu_torch.io import binarydump as tdump, network as tnet
from voxelhashing_tpu_torch.io import sensfile as tsens, tum as ttum

CAM = CameraConfig(width=64, height=48, fx=52.0, fy=52.0, cx=31.5, cy=23.5)
CODECS = {"raw": jsens.DEPTH_RAW, "zlib": jsens.DEPTH_ZLIB,
          "occi": jsens.DEPTH_OCCI}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs one worker per core, and idle
    OpenMP threads spinning beside the other workers cost far more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=3, cam=CAM):
    poses = make_trajectory(n)
    frames = [render_depth(p, cam, Scene(), noise_sigma=0.002, seed=i)
              for i, p in enumerate(poses)]
    return (np.stack([d for d, _ in frames]),
            np.stack([c for _, c in frames]), poses)


def _intr(cam):
    k = np.eye(4, dtype=np.float32)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = cam.fx, cam.fy, cam.cx, cam.cy
    return k


def _same_frame(a, b):
    """Two (depth, color, pose) triples equal bit for bit (NaN included)."""
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_sens_bytes_and_reads_match(tmp_path, codec):
    depths, colors, poses = _data()
    kw = dict(depth_shift=256.0 if codec == "occi" else 1000.0,
              depth_codec=CODECS[codec])
    pj, pt = str(tmp_path / "j.sens"), str(tmp_path / "t.sens")
    jsens.write_sens(pj, depths, colors, poses, _intr(CAM), **kw)
    tsens.write_sens(pt, depths, colors, poses, _intr(CAM), **kw)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    for path in (pj, pt):           # each package reads the other's file
        rj, rt = jsens.SensReader(path), tsens.SensReader(path)
        try:
            assert len(rt) == len(rj) == 3
            assert vars(rt.header).keys() == vars(rj.header).keys()
            assert rt.header.depth_compression == CODECS[codec]
            for i in range(3):
                _same_frame(rt.read_frame(i), rj.read_frame(i))
            for a, b in zip(rt.ground_truth(), rj.ground_truth()):
                np.testing.assert_array_equal(a, b)
        finally:
            rj.close()
            rt.close()
    # the numpy codec reads and writes the same OCCI file
    if codec == "occi":
        pn = str(tmp_path / "n.sens")
        tsens.write_sens(pn, depths, colors, poses, _intr(CAM), native=False,
                         **kw)
        assert open(pn, "rb").read() == open(pj, "rb").read()
        r = tsens.SensReader(pn, native=False)
        _same_frame(r.read_frame(1), jsens.SensReader(pj).read_frame(1))
        r.close()


def test_occi_native_equals_numpy():
    rng = np.random.default_rng(0)
    runs = np.repeat(rng.integers(0, 2048, 40), rng.integers(1, 60, 40))
    walk = np.clip(np.cumsum(rng.integers(-2, 3, 3000)) + 1000, 0, 2047)
    d, _, _ = _data(1)
    sensor = np.where(np.isfinite(d[0]), np.round(d[0] * 256), 0)
    for v in (runs, walk, sensor.reshape(-1), np.zeros(100)):
        v = v.astype(np.uint16)
        enc = native.occi_encode(v)
        assert enc == tsens.occi_encode_plain(v) == jsens.occi_encode(v)
        out = native.occi_decode(enc, v.size)
        assert out.dtype == np.uint16
        np.testing.assert_array_equal(out, v & 0x7FF)
        np.testing.assert_array_equal(tsens.occi_decode_plain(enc, v.size),
                                      out)
        np.testing.assert_array_equal(tsens.occi_decode(enc, v.size), out)
    with pytest.raises(ValueError, match="truncated"):
        native.occi_decode(native.occi_encode(walk.astype(np.uint16))[:10],
                           walk.size)


def test_chain_and_prefetch_readers(tmp_path):
    depths, colors, poses = _data(5)
    paths = []
    for k, sl in enumerate((slice(0, 2), slice(2, 5))):
        p = str(tmp_path / f"part{k}.sens")
        tsens.write_sens(p, depths[sl], colors[sl], poses[sl], _intr(CAM))
        paths.append(p)
    jc = jsens.SensChainReader(paths)
    tc = tsens.SensChainReader(paths)
    assert len(tc) == len(jc) == 5
    for i in range(5):
        _same_frame(tc.read_frame(i), jc.read_frame(i))
    jc.close()
    pre = tsens.PrefetchReader(tsens.SensChainReader(paths), depth=2)
    got = list(pre.frames())
    pre.close()
    assert len(got) == 5 and not pre._thread.is_alive()
    ref = tsens.SensChainReader(paths)
    for i, f in enumerate(got):
        _same_frame(f, ref.read_frame(i))
    assert len(pre.ground_truth()) == 5
    ref.close()
    # an abandoned reader stops its decode thread on close
    pre = tsens.PrefetchReader(tsens.SensReader(paths[1]), depth=1)
    next(pre.frames())
    pre.close()
    assert not pre._thread.is_alive()
    with pytest.raises(ValueError, match="depth size"):
        other = str(tmp_path / "other.sens")
        tsens.write_sens(other, depths[:1, :24], colors[:1, :24], poses[:1],
                         _intr(CAM))
        tsens.SensChainReader([paths[0], other])


def test_binarydump_bytes_and_reads_match(tmp_path):
    depths, colors, poses = _data()
    frames = list(zip(depths, colors))
    pj, pt = str(tmp_path / "j.sensor"), str(tmp_path / "t.sensor")
    assert jdump.write_sensor(pj, CAM, frames, trajectory=poses) == 3
    assert tdump.write_sensor(pt, convert.config_from(CAM), frames,
                              trajectory=poses) == 3
    assert open(pj, "rb").read() == open(pt, "rb").read()
    rj, rt = jdump.BinaryDumpReader(pt), tdump.BinaryDumpReader(pj)
    assert len(rt) == len(rj) == 3
    assert vars(rt.camera) == vars(rj.camera)
    for i in range(3):
        _same_frame(rt.read_frame(i), rj.read_frame(i))
    rj.close()
    rt.close()


def _tum_dir(root, depths, colors, poses):
    from PIL import Image
    os.makedirs(os.path.join(root, "depth"))
    os.makedirs(os.path.join(root, "rgb"))
    with open(os.path.join(root, "depth.txt"), "w") as fd, \
            open(os.path.join(root, "rgb.txt"), "w") as fr, \
            open(os.path.join(root, "groundtruth.txt"), "w") as fg:
        fg.write("# ground truth\n")
        for i in range(len(depths)):
            t = 100.0 + i * 0.033
            du = np.where(np.isfinite(depths[i]), depths[i] * 5000.0,
                          0).astype(np.uint16)
            Image.fromarray(du).save(os.path.join(root, f"depth/{i}.png"))
            Image.fromarray((colors[i] * 255).astype(np.uint8)).save(
                os.path.join(root, f"rgb/{i}.png"))
            fd.write(f"{t} depth/{i}.png\n")
            fr.write(f"{t + 0.001} rgb/{i}.png\n")
            r, p = poses[i][:3, :3], poses[i][:3, 3]
            qw = np.sqrt(max(0.0, 1 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
            qx = (r[2, 1] - r[1, 2]) / (4 * qw)
            qy = (r[0, 2] - r[2, 0]) / (4 * qw)
            qz = (r[1, 0] - r[0, 1]) / (4 * qw)
            fg.write(f"{t} {p[0]} {p[1]} {p[2]} {qx} {qy} {qz} {qw}\n")


def test_tum_reads_and_conversion_match(tmp_path):
    pytest.importorskip("PIL")
    depths, colors, poses = _data()
    root = str(tmp_path / "tum")
    _tum_dir(root, depths, colors, poses)
    sj = jtum.load_tum(root, camera=CAM)
    st = ttum.load_tum(root, camera=convert.config_from(CAM))
    assert len(st) == len(sj) == 3
    assert st.timestamps == sj.timestamps and st.rgb_files == sj.rgb_files
    for i in range(3):
        _same_frame(st.read_frame(i), sj.read_frame(i))
    d, _, p = st.read_frame(1)
    valid = np.isfinite(depths[1])
    np.testing.assert_allclose(d[valid], depths[1][valid], atol=1e-3)
    np.testing.assert_allclose(p, poses[1], atol=1e-5)
    assert ttum.associate([(1.0, "a"), (2.0, "b")],
                          [(1.005, "x"), (3.0, "y")]) == [(0, 0)]
    pj, pt = str(tmp_path / "j.sens"), str(tmp_path / "t.sens")
    assert jsens.tum_to_sens(root, pj) == tsens.tum_to_sens(root, pt) == 3
    assert open(pj, "rb").read() == open(pt, "rb").read()


@pytest.mark.parametrize("direction", ["port_server", "jax_server"])
def test_network_loopback(direction):
    """Frames (with color and pose, and depth only) from one package's
    server arrive through the other package's sensor unchanged."""
    depths, colors, poses = _data(2)
    server_mod, sensor_mod = ((tnet, jnet) if direction == "port_server"
                              else (jnet, tnet))
    server = server_mod.RGBDStreamServer()

    def serve():
        server.accept(timeout=10)
        server.send_frame(depths[0], colors[0], poses[0])
        server.send_frame(depths[1])
        server.close()

    t = threading.Thread(target=serve)
    t.start()
    sensor = sensor_mod.NetworkSensor("127.0.0.1", server.port)
    got = [sensor.read_frame(), sensor.read_frame()]
    sensor.close()
    t.join(timeout=10)
    assert not t.is_alive()
    d, c, p = got[0]
    valid = np.isfinite(depths[0])
    np.testing.assert_allclose(d[valid], depths[0][valid], atol=1e-3)
    assert np.isnan(d[~valid]).all()
    np.testing.assert_allclose(c, colors[0], atol=1 / 255)
    np.testing.assert_array_equal(p, poses[0])
    assert got[1][1] is None and got[1][2] is None
    # the two packages pack the same bytes
    assert tnet._pack_frame(depths[0], colors[0], poses[0], 1000.0) == \
        jnet._pack_frame(depths[0], colors[0], poses[0], 1000.0)


def test_frame_source_resamples_dump_and_sens(tmp_path):
    """``run_slam.frame_source`` on a dump and a .sens file recorded at
    twice the working size: nearest-pixel frames at the working size, the
    recorded poses as ground truth, ``--frames`` respected."""
    big = CameraConfig(width=128, height=96, fx=104.0, fy=104.0, cx=63.5,
                       cy=47.5)
    depths, colors, poses = _data(3, big)
    dump, sens = str(tmp_path / "a.sensor"), str(tmp_path / "a.sens")
    tdump.write_sensor(dump, convert.config_from(big),
                       list(zip(depths, colors)), trajectory=poses)
    tsens.write_sens(sens, depths, colors, poses, _intr(big))
    cfg = dataclasses.replace(run_slam.run_config(run_slam.parse_args([])),
                              camera=convert.config_from(CAM))
    for src in (f"dump:{dump}", f"sens:{sens}"):
        args = run_slam.parse_args(["--input", src, "--frames", "2"])
        got = list(run_slam.frame_source(args, cfg, torch.device("cpu")))
        assert len(got) == 2
        for i, (d, c, p) in enumerate(got):
            assert d.shape == (48, 64) and c.shape == (48, 64, 3)
            ref = depths[i][::2, ::2]
            np.testing.assert_allclose(d, ref, atol=1e-3, equal_nan=True)
            np.testing.assert_allclose(p, poses[i], atol=1e-6)


def test_run_slam_sens_posegraph_to_ok(tmp_path):
    """The port's entry point on the CPU: a 12-frame .sens recording (the
    tiny preset's camera, written by the JAX package) replayed with the
    pose graph (keyframes at frames 0 and 10), re-integration, histogram
    and timings, then recorded again with the log, convergence table and
    profiler trace."""
    cam = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5,
                       cy=59.5)
    depths, colors, poses = _data(12, cam)
    path = str(tmp_path / "rec.sens")
    jsens.write_sens(path, depths, colors, poses, _intr(cam))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_slam.main(["--device", "cpu", "--input", f"sens:{path}",
                            "--posegraph", "--reintegrate", "--histogram",
                            "--timings"])
    text = out.getvalue()
    assert rc == 0 and "RESULT: OK" in text, text[-2000:]
    for want in ("frame   11:", "pose graph: 2 keyframes, 1 edges (0 loops)",
                 "re-integrated 12 frames", "hash histogram:",
                 "'consistent': True", "stage averages (ms):", "icp L0:"):
        assert want in text, want
    log, rec = str(tmp_path / "run.log"), str(tmp_path / "again.sens")
    conv, trace = str(tmp_path / "conv.txt"), str(tmp_path / "trace")
    rc = run_slam.main(["--device", "cpu", "--input", f"sens:{path}",
                        "--frames", "3", "--log", log, "--record", rec,
                        "--convergence", conv, "--trace", trace])
    assert rc == 0
    text = open(log).read()
    assert "RESULT: OK" in text and "recorded 3 frames" in text
    assert os.path.exists(os.path.join(trace, "trace.json"))
    assert open(conv).readline().startswith("# iteration residual")
    r = jsens.SensReader(rec)
    assert len(r) == 3
    d, _, _ = r.read_frame(2)
    np.testing.assert_allclose(d, depths[2], atol=1e-3, equal_nan=True)
    r.close()


def test_run_slam_takes_every_flag_of_the_jax_entry_point(monkeypatch):
    """Every flag of ``scripts/run_slam.py`` but ``--cpu`` (``--device cpu``
    here) is a flag of the port's entry point."""
    src = (Path(__file__).resolve().parents[1] / "scripts" /
           "run_slam.py").read_text()
    jax_flags = {node.args[0].value for node in ast.walk(ast.parse(src))
                 if isinstance(node, ast.Call)
                 and getattr(node.func, "attr", "") == "add_argument"}
    port_flags = set()
    add = run_slam.argparse.ArgumentParser.add_argument

    def spy(self, *names, **kw):
        port_flags.update(names)
        return add(self, *names, **kw)

    monkeypatch.setattr(run_slam.argparse.ArgumentParser, "add_argument",
                        spy)
    run_slam.parse_args([])
    assert len(jax_flags) > 20
    assert jax_flags - port_flags == {"--cpu"}
    assert "--device" in port_flags
